"""The model step's share (%) of the card's dense bf16 peak: the window's model
FLOPs (``workmodels/lm_step.py``) over its length."""
from bench.workmodels.peaks import BF16_FLOPS


def read(trace):
    flops = trace.info.get("model_flops")
    if not flops or trace.window_s <= 0:
        return None
    return 100.0 * flops / trace.window_s / BF16_FLOPS
