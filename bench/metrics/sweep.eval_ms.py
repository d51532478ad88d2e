"""ms a generation in the evaluation segment (``core/evolve.eval_segment``: the
``cgp_sim`` launch through ``kernels/ops.py``, metrics and the power model
of ``core/power.py``), synchronised spans."""


def read(trace):
    return trace.span_mean_ms("eval_segment")
