"""uint8 quantization + evolved-approximate-multiplier matmul emulation.

The deployment bridge for the paper's circuits: ``set_multiplier_lut``
installs a 256 × 256 product table (``core.library.multiplier_lut`` of an
evolved 8×8 multiplier) and ``approx_matmul`` then computes a projection as

    y = scale_x · scale_w · (Σ_k LUT[q(x)[m,k], q(w)[k,n]] − zero-point terms)

the arithmetic a chip built from the evolved circuit would perform on
uint8-quantized operands (asymmetric per-tensor quantization, so operands
are non-negative like the unsigned multipliers the paper evolves; the
zero-point cross terms are exact integer row / column sums).  With no LUT
installed it reduces to exact int8 arithmetic.

The contraction goes through ``kernels.ops.lut_matmul``: the CUDA kernel
for tensors on the card, its plain version for tensors on the CPU.  The
float32 operation order follows ``repro/models/quant.py`` so the CPU path
matches the reference: same quantized operands and integer accumulator
bit for bit, outputs within float32 rounding.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops as kops

_LUT: np.ndarray | None = None  # (256, 256) int32, LUT[a, b] ≈ a*b
_TABLES: dict[torch.device, torch.Tensor] = {}  # the table on each device


def set_multiplier_lut(lut: np.ndarray | None) -> None:
    """Install an evolved product table (None: the exact one)."""
    global _LUT
    if lut is not None:
        lut = np.array(lut, np.int32)
        if lut.shape != (256, 256):
            raise ValueError(f"multiplier LUT must be (256, 256), got "
                             f"{lut.shape}")
    _LUT = lut
    _TABLES.clear()


def get_multiplier_lut(device: torch.device | str = "cpu") -> torch.Tensor:
    """The installed (or exact) table as a (256, 256) int32 tensor on
    ``device``; one tensor per device, so the kernel stages it once."""
    dev = torch.device(device)
    if dev not in _TABLES:
        # a normal tensor even when first asked for under inference mode,
        # so the kernel's staged copy is cached against its version
        with torch.inference_mode(False):
            if _LUT is None:
                a = torch.arange(256, dtype=torch.int32)
                lut = a[:, None] * a[None, :]
            else:
                lut = torch.from_numpy(_LUT)
            _TABLES[dev] = lut.to(dev)
    return _TABLES[dev]


def quantize_u8(x: torch.Tensor, axis=None):
    """Asymmetric uint8: (q uint8, scale, zero) with x ≈ scale·(q − zero).
    Rounding is half-to-even, as ``jnp.round``."""
    xf = x.to(torch.float32)
    if axis is None:
        lo, hi = xf.min(), xf.max()
    else:
        lo = xf.amin(dim=axis, keepdim=True)
        hi = xf.amax(dim=axis, keepdim=True)
    scale = torch.clamp_min(hi - lo, 1e-8) / 255.0
    zero = torch.round(-lo / scale)
    q = torch.clamp(torch.round(xf / scale + zero), 0, 255).to(torch.uint8)
    return q, scale, zero


def approx_matmul(x: torch.Tensor, w: torch.Tensor,
                  lut: torch.Tensor | None = None) -> torch.Tensor:
    """x: (..., K) float; w: (K, N) float -> (..., N) in x's dtype, every
    product taken from the multiplier's LUT."""
    lut = get_multiplier_lut(x.device) if lut is None else lut
    lead, K = x.shape[:-1], x.shape[-1]
    qx, sx, zx = quantize_u8(x.reshape(-1, K))
    qw, sw, zw = quantize_u8(w)
    acc = kops.lut_matmul(qx, qw, lut).to(torch.float32)
    # exact zero-point correction: Σ(qx−zx)(qw−zw) = Σqx·qw − zw·Σqx −
    # zx·Σqw + K·zx·zw; only Σqx·qw goes through the (approximate) LUT,
    # the row / column sums would be adders on silicon
    row = qx.sum(-1, keepdim=True, dtype=torch.int32).to(torch.float32)
    col = qw.sum(0, keepdim=True, dtype=torch.int32).to(torch.float32)
    corr = acc - zw * row - zx * col + K * zx * zw
    y = sx * sw * corr
    return y.reshape(*lead, w.shape[1]).to(x.dtype)


def quant_error(x: torch.Tensor, w: torch.Tensor,
                lut: torch.Tensor | None = None) -> float:
    """Relative Frobenius error of the emulated matmul against float32."""
    y_ref = x.to(torch.float32) @ w.to(torch.float32)
    y = approx_matmul(x, w, lut).to(torch.float32)
    return float(torch.linalg.norm(y - y_ref)
                 / torch.clamp_min(torch.linalg.norm(y_ref), 1e-9))
