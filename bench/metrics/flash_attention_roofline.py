"""``flash_attention``'s share of its roofline (%): the work model's least time
a call over the traced device time a launch."""


def read(trace):
    return trace.roofline_pct("flash_attention", "flash_attention")
