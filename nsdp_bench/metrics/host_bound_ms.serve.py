"""Host-bound time of a request: the mean, over the calls outside the
profiled slices while the program's tracer was on, of the ``serve.deform``
span less its ``serve.wait`` (``program_spans.host_bound_ms``).  With one
client in a closed loop, the time the card has none of the call's work."""


def read(o):
    return o.counters.get("host_bound_ms")
