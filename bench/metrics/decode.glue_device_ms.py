"""Device ms a decode step outside ``lut_matmul``: the quantize and zero-point
glue of ``models/quant.py``, attention over the cache, norms and the head."""


def read(trace):
    steps = trace.info.get("steps")
    if not steps or not trace.device:
        return None
    other = sum(e - s for n, s, e in trace.device if "lut_matmul" not in n)
    return other / 1e3 / steps
