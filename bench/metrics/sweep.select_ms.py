"""ms a generation in the selection segment (``core/evolve.select_segment``:
``core/fitness.py`` and the (1+λ) selection), synchronised spans."""


def read(trace):
    return trace.span_mean_ms("select_segment")
