"""Padded query rows over valid ones, over every session open and drag of
the window; the padded size is the program's static input shape at the
call (its captured program's), not a copy of its bucket ladder."""


def read(o):
    valid, padded = o.counters.get("valid", 0), o.counters.get("padded", 0)
    if not valid:
        return None
    return 100.0 * (padded - valid) / valid
