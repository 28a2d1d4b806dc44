"""Host time of a stage-1 train step: the mean, over the steps outside the
profiled slices while the program's tracer was on, of the program's
``train.step`` span (``entries/train_stage1.py``), from the call to its
return with the next step queued behind the card's work.  A program
without the tracer gives nothing."""


def read(o):
    return o.counters.get("host_step_ms")
