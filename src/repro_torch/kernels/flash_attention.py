"""Blocked online-softmax attention (forward): the CUDA launch wrapper.

Replaces the TPU kernel ``repro/kernels/flash_attention.py:25-100``
(``flash_attention_kernel``, reached through ``flash_attention`` and
``repro/kernels/ops.py::flash_attention``).  It computes causal or full
softmax attention over ``(B, Hq, Sq, D)`` queries and ``(B, Hkv, Skv, D)``
keys and values, q-head h reading kv-head ``h // (Hq // Hkv)``: q, k and v
upcast to float32, q scaled by ``1/sqrt(D)`` first, masked logits −1e30, a
float32 online softmax (running max and denominator), and the output
``acc / max(l, 1e-30)`` in q's dtype.  The causal mask is ``q_pos >=
k_pos`` with both positions counted from 0.

What bounds it on an H100: operations.  Causal attention needs
``4·B·Hq·D·Sq(Sq+1)/2`` FLOPs (QKᵀ and P·V); ``chip_smoke.py`` quotes the
bound at the card's dense bf16 tensor-core rate, or the q/k/v/o bytes at
the HBM rate where those are larger.  The design is a simple one: float32
on the CUDA cores (67 TFLOP/s, a fifteenth of the tensor-core rate), one
256-thread block per (64-row q tile, batch × head) walking the 64-row kv
tiles its rows can see, with k and v staged in shared memory and each
thread holding a 4 × 4 tile of scores and a 4-row slice of the output in
registers (``csrc/flash_attention.cu``).  GQA is read in place: no repeated
copy of k and v.  Inputs may be strided views (the model passes
transposes): the kernel takes element strides, the last dimension
contiguous.

``flash_attention`` takes CUDA tensors only; its plain version is
``ref.attention_ref``, which ``ops.flash_attention`` takes for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import nvcc

SOURCE = nvcc.CSRC / "flash_attention.cu"
HEAD_DIMS = (8, 16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
REF_BLOCK = 128            # the reference's block rows (bq, bkv)

# Kernel launches made by ``flash_attention`` in this process.
LAUNCHES = 0

_LIB = None


def build() -> nvcc.BuildInfo:
    """Compile ``csrc/flash_attention.cu`` into a shared library (cached)."""
    return nvcc.build(SOURCE)


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build().path))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attention_launch.argtypes = (
            [p, p, p, p] + [i] * 8 + [ctypes.c_float] + [ll] * 12 + [p])
        lib.flash_attention_launch.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise where the reference asserts or cannot reshape: q (B, Hq, Sq,
    D), k and v (B, Hkv, Skv, D) with Hkv dividing Hq, and Sq, Skv each a
    multiple of ``min(128, S)``."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, Hq, S, D) and k, v one (B, Hkv, S, "
                         f"D) shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    Bk, Hkv, Skv, Dk = k.shape
    if Bk != B or Dk != D or Hkv < 1 or Hq % Hkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    for name, n in (("Sq", Sq), ("Skv", Skv)):
        if n < 1 or n % min(REF_BLOCK, n):
            raise ValueError(f"{name}={n} is not a multiple of "
                             f"min({REF_BLOCK}, {name})")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Attention forward on the card.

    Args:
      q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D) — one dtype (float32 or
        bfloat16), D in ``HEAD_DIMS``, on one CUDA device; any strides
        with the last dimension contiguous (4-element aligned).
    Returns (B, Hq, Sq, D) in q's dtype, laid out as q.  Raises for other
    dtypes, shapes and devices.
    """
    check_shapes(q, k, v)
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"no flash_attention kernel for devices {q.device}, "
                         f"{k.device}, {v.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of {list(DTYPES)}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    o = torch.empty_like(q)
    align = 4 * q.element_size()     # the kernel loads 4 elements at once
    for name, x in (("q", q), ("k", k), ("v", v), ("out", o)):
        if x.stride(-1) != 1 or any(s % 4 for s in x.stride()[:3]) \
                or x.data_ptr() % align:
            raise ValueError(f"{name} must have a contiguous, {align}-byte "
                             f"aligned last dimension and strides that are "
                             f"multiples of 4, got {x.stride()}")
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, Hq, Hkv, Sq, Skv, D, int(causal), DTYPES[q.dtype],
            1.0 / D ** 0.5, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *o.stride()[:3], stream)
    if err != 0:
        raise RuntimeError("flash_attention launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    global LAUNCHES
    LAUNCHES += 1
    return o
