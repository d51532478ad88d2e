"""Gradient compression with error feedback.

The port of ``repro/optim/compress.py``: each gradient leaf is quantized
block-wise to int8 (absmax scale per 256 values) and the quantization
residual is kept in an error buffer added to the next step's gradient
(EF-SGD).  ``compressed_psum`` is the data-parallel mean of the
dequantized gradients over a ``torch.distributed`` process group (the
reference's ``psum`` over a named mesh axis).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree as T

Tree = Any
BLOCK = 256


def quantize_leaf(g: torch.Tensor):
    """(q (n_blocks, BLOCK) int8, scale (n_blocks, 1) float32)."""
    flat = g.to(torch.float32).reshape(-1)
    pad = (-flat.numel()) % BLOCK
    x = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)
    scale = torch.clamp_min(x.abs().amax(dim=1, keepdim=True) / 127.0,
                            1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_leaf(q: torch.Tensor, scale: torch.Tensor, shape
                    ) -> torch.Tensor:
    x = (q.to(torch.float32) * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return x[:n].reshape(shape)


def _feedback(g, e):
    g = g.to(torch.float32) + e
    q, s = quantize_leaf(g)
    return q, s, g - dequantize_leaf(q, s, g.shape), g.shape


def compress_with_feedback(grads: Tree, error: Tree):
    """(grads + error) -> (quantized tree ``{"q", "s"}`` per leaf, new
    error)."""
    res = T.map(_feedback, grads, error)
    return (T.map(lambda r: {"q": r[0], "s": r[1]}, res),
            T.map(lambda r: r[2], res))


def compressed_psum(grads: Tree, error: Tree, group=None
                    ) -> tuple[Tree, Tree]:
    """Error-feedback int8 all-reduce over the process ``group`` (the
    default group when None): (mean float32 gradients, new error buffers).
    Each rank sums the others' dequantized payloads in float32, which
    models the exchange of the int8 tensor and its block scales."""
    import torch.distributed as dist
    n = dist.get_world_size(group)

    def reduce(g, e):
        q, s, err, shape = _feedback(g, e)
        deq = dequantize_leaf(q, s, shape)
        dist.all_reduce(deq, group=group)
        return deq / n, err
    res = T.map(reduce, grads, error)
    return T.map(lambda r: r[0], res), T.map(lambda r: r[1], res)


def init_error(params: Tree) -> Tree:
    return T.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device), params)
