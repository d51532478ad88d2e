"""``cgp_sim``'s share of its roofline (%): the active-gate work model's least
time a launch over the traced device time a launch."""


def read(trace):
    return trace.roofline_pct("cgp_sim", "cgp_sim")
