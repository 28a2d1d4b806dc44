"""Padded query rows over valid ones, from the program's own counts
(``serve.rows_padded``, ``serve.rows_valid``) over the part of a traced
run's window in which its tracer was on (``entries/serve_mixed.py``)."""


def read(o):
    valid = o.counters.get("serve.rows_valid", 0)
    if not valid:
        return None
    return 100.0 * (o.counters["serve.rows_padded"] - valid) / valid
