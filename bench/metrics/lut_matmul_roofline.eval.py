"""``lut_matmul``'s share of its roofline (%): the work model's least time a
call over the traced device time a launch."""


def read(trace):
    return trace.roofline_pct("lut_matmul", "lut_matmul")
