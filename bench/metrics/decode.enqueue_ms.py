"""Host ms from the call of ``decode_step`` to its return, before anything
waits for the device: the host side of a step."""


def read(trace):
    return trace.span_mean_ms("decode_step")
