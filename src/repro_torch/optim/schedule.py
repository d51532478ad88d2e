"""Learning-rate schedule (linear warmup + cosine decay), in float32 as the
reference computes it."""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def lr_at(step, cfg) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then cosine decay to
    ``min_lr_ratio · lr``; a float32 scalar tensor.  Every operation is a
    float32 one, with the reference's operand order."""
    step = _f32(step)
    warm = torch.clamp_max((step + 1) / max(1, cfg.warmup_steps), 1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(_f32(math.pi) * t))
    floor = cfg.min_lr_ratio
    return cfg.lr * warm * (floor + (1 - floor) * cos)
