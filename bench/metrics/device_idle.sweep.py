"""Share (%) of the traced window in which no operation ran on the device."""


def read(trace):
    return trace.idle_pct()
