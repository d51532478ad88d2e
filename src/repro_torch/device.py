"""Device selection for the entry points: the card unless asked otherwise."""
from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``cuda`` by default; raises when CUDA is asked for and there is no
    card, instead of carrying on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but no CUDA device is available; pass "
            "device='cpu' (CLI: --device cpu) to run the plain PyTorch path")
    return dev
