"""ms a generation in the program's mutation segment
(``core/evolve.mutate_segment``: the key split and ``core/mutate.py``'s λ
offspring), synchronised spans."""


def read(trace):
    return trace.span_mean_ms("mutate_segment")
