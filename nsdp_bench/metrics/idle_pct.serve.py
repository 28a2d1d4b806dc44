"""Share of the whole profiled slice in which no kernel or copy ran on the
card."""


def read(o):
    if o.slice is None:
        return None
    return 100.0 * (1.0 - o.slice.busy_s / o.slice.wall_s)
