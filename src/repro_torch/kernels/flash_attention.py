"""Blocked online-softmax attention (forward): the CUDA launch wrapper.

Replaces the TPU kernel ``repro/kernels/flash_attention.py:25-100``
(``flash_attention_kernel``, reached through ``flash_attention`` and
``repro/kernels/ops.py::flash_attention``).  It computes causal or full
softmax attention over ``(B, Hq, Sq, D)`` queries and ``(B, Hkv, Skv, D)``
keys and values, q-head h reading kv-head ``h // (Hq // Hkv)``: float32
scores ``q·k / sqrt(D)``, masked logits −1e30, a float32 online softmax
(running max and denominator), and the output ``acc / max(l, 1e-30)`` in
q's dtype.  The causal mask is ``q_pos >= k_pos`` with both positions
counted from 0.

What bounds it on an H100: operations.  Causal attention needs
``4·B·Hq·D·Sq(Sq+1)/2`` FLOPs (QKᵀ and P·V); ``chip_smoke.py`` quotes the
bound at the card's dense bf16 tensor-core rate, or the q/k/v/o bytes at
the HBM rate where those are larger.  ``plan`` picks one of two bodies of
``csrc/flash_attention.cu`` and the head dim it is instantiated at
(``Plan.head_dim``, the true D or the next instantiated one above it):

* ``"tensor_core"`` — bf16 with D a multiple of 16 up to 128, the model's
  path, instantiated at ``TC_HEAD_DIMS`` (D = 48 runs at 64; 80, 96 and
  112 at 128: TMA zero-fills the columns past D, which add nothing to QKᵀ
  and give output columns that are never stored).
  Warp-specialised: a producer warpgroup (one thread) feeds q, k and v
  tiles through TMA and mbarriers, two consumer warpgroups run QKᵀ and
  P·V on ``wgmma``.
  P·V takes three bf16 terms of P (exact split), so the body spends twice
  the function's tensor-core work; a single bf16 P misses the bf16
  tolerance ``chip_smoke.py`` holds it to.  TMA reads the tensors in
  place over their own strides (the model's transposed views included),
  which must be multiples of 16 bytes on a 16-byte aligned base.
* ``"cuda_core"`` — float32 at every D (its rtol 1e-5 needs float32
  products), and bf16 at the other D (8, the reduced configurations' 14
  and 20, 160 and any D up to ``MAX_HEAD_DIM``): float32 FMAs on the CUDA
  cores, instantiated at ``CORE_HEAD_DIMS`` with the columns past D masked
  on load and store.  It reads 4-element vectors where D, the strides and
  the bases allow it (``Plan.vector``) and single elements otherwise, so
  it takes any strides.

The scale is ``1/sqrt(D)`` at the true D in both bodies.  A head dim past
``MAX_HEAD_DIM`` reaches no kernel and raises.
GQA is read in place: no repeated copy of k and v.  ``flash_attention``
takes CUDA tensors only; its plain version is ``ref.attention_ref``,
which ``ops.flash_attention`` takes for CPU tensors.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import re

import torch

from repro_torch.kernels import nvcc

SOURCE = nvcc.CSRC / "flash_attention.cu"
TC_HEAD_DIMS = (16, 32, 64, 128)   # instantiations of the tensor-core body
CORE_HEAD_DIMS = (8, 16, 32, 64, 128, 160, 256)   # ... of the CUDA-core body
MAX_HEAD_DIM = CORE_HEAD_DIMS[-1]
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
REF_BLOCK = 128            # the reference's block rows (bq, bkv)
TC_BLOCK_Q, TC_BLOCK_KV = 128, 64   # 2 consumer warpgroups of 64 q rows
CORE_BLOCK = 64            # the CUDA-core body's q and kv tile rows
TMA_ALIGN = 16             # bytes: TMA's stride and base alignment

# Kernel launches made by ``flash_attention`` in this process: all, and
# those of the tensor-core body.
LAUNCHES = 0
TC_LAUNCHES = 0

_LIB = None


@dataclasses.dataclass(frozen=True)
class TmaBox:
    """One tensor's TMA geometry, innermost first: ``dims`` (D, S, H, B)
    in elements, ``strides`` of S, H, B in bytes, ``box`` (columns, rows,
    1, 1) in elements — columns the 32/64/128-byte swizzle span."""
    dims: tuple[int, int, int, int]
    strides: tuple[int, int, int]
    box: tuple[int, int, int, int]


@dataclasses.dataclass(frozen=True)
class Plan:
    """How ``flash_attention`` launches: the body (``"tensor_core"`` or
    ``"cuda_core"``), the head dim it is instantiated at (the true D or the
    next one above it), whether the CUDA-core body reads 4-element vectors,
    its q and kv tile rows, its grid (x, y), the (q tile, kv tile) pairs
    it computes, and the TMA geometry of q, k, v (tensor-core body only)."""
    body: str
    head_dim: int
    vector: bool
    block_q: int
    block_kv: int
    grid: tuple[int, int]
    tiles: int
    tma: tuple[TmaBox, TmaBox, TmaBox] | None


def _causal_tiles(Sq, Skv, bq, bkv, causal):
    """(q tile, kv tile) pairs of one batch·head: every kv tile, or those
    up to each q tile's last valid row."""
    n_all = -(-Skv // bkv)
    if not causal:
        return -(-Sq // bq) * n_all
    return sum(min(n_all, (min(q0 + bq, Sq) - 1) // bkv + 1)
               for q0 in range(0, Sq, bq))


def _tma_box(shape, strides, rows, head_dim):
    """TmaBox of a bf16 (B, H, S, D) tensor read in boxes of ``rows`` by
    the body instantiated at ``head_dim`` >= D (columns past D read as
    zeros)."""
    B, H, S, D = shape
    contiguous = (H * S * D, S * D, D)   # for size-1 dims: never stepped
    sb, sh, ss = (2 * (st if n > 1 else c) for st, n, c in
                  zip(strides[:3], (B, H, S), contiguous))
    return TmaBox((D, S, H, B), (ss, sh, sb), (min(head_dim, 64), rows, 1, 1))


def _next_dim(D, dims):
    """The smallest of ``dims`` >= D."""
    return next(d for d in dims if d >= D)


def plan(q_shape, kv_shape, dtype, q_strides, k_strides, v_strides,
         o_strides=None, ptrs=(0, 0, 0, 0), causal=True) -> Plan:
    """The launch of ``flash_attention`` for q (B, Hq, Sq, D) and k, v
    (B, Hkv, Skv, D) of ``dtype`` with these element strides (o's default
    to q's) and data pointers (q, k, v, o).

    bf16 with D a multiple of 16 up to 128 takes the tensor-core body at
    the next ``TC_HEAD_DIMS`` entry: every stride but the last (1) a
    multiple of 16 bytes and every base 16-byte aligned, as TMA reads
    them.  float32, and bf16 at other D, take the CUDA-core body at the
    next ``CORE_HEAD_DIMS`` entry, with any strides: 4-element vector
    loads where D and every stride are multiples of 4 and every base is
    aligned to 4 elements, single elements otherwise.  Raises
    ``ValueError`` for D outside 1..``MAX_HEAD_DIM`` and where the strides
    or pointers do not fit the tensor-core body (it never copies), and
    ``TypeError`` for other dtypes."""
    o_strides = q_strides if o_strides is None else o_strides
    return _plan(tuple(q_shape), tuple(kv_shape), dtype, tuple(q_strides),
                 tuple(k_strides), tuple(v_strides), tuple(o_strides),
                 tuple(p % TMA_ALIGN for p in ptrs), bool(causal))


def _plan(q_shape, kv_shape, dtype, q_strides, k_strides, v_strides,
          o_strides, offsets, causal) -> Plan:
    """``plan`` of tuples, the pointers as offsets modulo 16 bytes."""
    B, Hq, Sq, D = q_shape
    Hkv, Skv = kv_shape[1], kv_shape[2]
    if dtype not in DTYPES:
        raise TypeError(f"no flash_attention kernel for {dtype}")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} outside 1..{MAX_HEAD_DIM}")
    item = 2 if dtype == torch.bfloat16 else 4
    tc = dtype == torch.bfloat16 and D % 16 == 0 and D <= TC_HEAD_DIMS[-1]
    all_strides = (q_strides, k_strides, v_strides, o_strides)
    for name, st in zip(("q", "k", "v", "out"), all_strides):
        if st[3] != 1:
            raise ValueError(f"{name}: the kernel needs a contiguous last "
                             f"dimension, got strides {st}")
    if not tc:
        vector = (D % 4 == 0 and all(x % 4 == 0 for st in all_strides
                                     for x in st[:3])
                  and all(p % (4 * item) == 0 for p in offsets))
        return Plan("cuda_core", _next_dim(D, CORE_HEAD_DIMS), vector,
                    CORE_BLOCK, CORE_BLOCK, (-(-Sq // CORE_BLOCK), B * Hq),
                    B * Hq * _causal_tiles(Sq, Skv, CORE_BLOCK, CORE_BLOCK,
                                           causal), None)
    mult = TMA_ALIGN // item
    for name, st, ptr in zip(("q", "k", "v", "out"), all_strides, offsets):
        if any(x % mult for x in st[:3]) or ptr % TMA_ALIGN:
            raise ValueError(
                f"{name}: the tensor-core body needs strides that are "
                f"multiples of {mult} elements and a {TMA_ALIGN}-byte "
                f"aligned base, got strides {st}, a base {ptr} bytes off 16")
    dp = _next_dim(D, TC_HEAD_DIMS)
    kv, bq = (B, Hkv, Skv, D), TC_BLOCK_Q
    return Plan("tensor_core", dp, True, bq, TC_BLOCK_KV,
                (B * Hq, -(-Sq // bq)),
                B * Hq * _causal_tiles(Sq, Skv, bq, TC_BLOCK_KV, causal),
                (_tma_box(q_shape, q_strides, bq, dp),
                 _tma_box(kv, k_strides, TC_BLOCK_KV, dp),
                 _tma_box(kv, v_strides, TC_BLOCK_KV, dp)))


def build() -> nvcc.BuildInfo:
    """Compile ``csrc/flash_attention.cu`` into a shared library (cached)."""
    return nvcc.build(SOURCE)


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build().path))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f = ctypes.c_float
        lib.flash_attention_launch.argtypes = (
            [p, p, p, p] + [i] * 10 + [f] + [ll] * 12 + [p])
        lib.flash_attention_launch.restype = i
        lib.flash_attention_tc_launch.argtypes = (
            [p, p, p, p, ctypes.POINTER(ll), p])
        lib.flash_attention_tc_launch.restype = i
        lib.flash_attention_tc_smem.argtypes = [i]
        lib.flash_attention_tc_smem.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def tc_resources(log: str) -> dict[int, dict[str, int]]:
    """Per head dim of the tensor-core body: registers, stack and spill
    bytes from nvcc's ptxas report ``log`` (``nvcc.BuildInfo.log``), and
    the dynamic shared memory it launches with."""
    out, D = {}, None
    for line in log.splitlines():
        hit = re.search(r"Compiling entry function '\S*flash_attention_tc_"
                        r"kernelILi(\d+)E", line)
        if hit:
            D = int(hit.group(1))
            out[D] = {"smem": _library().flash_attention_tc_smem(D)}
        elif D is not None and "spill stores" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            out[D].update(stack=nums[0], spill_stores=nums[1],
                          spill_loads=nums[2])
        elif D is not None and "Used" in line and "registers" in line:
            out[D]["registers"] = int(re.search(r"Used (\d+) registers",
                                                line).group(1))
            D = None
    return out


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
        bfloat16), D in 1..``MAX_HEAD_DIM``, on one CUDA device; any
        strides ``plan`` takes (the last dimension contiguous).
    Returns (B, Hq, Sq, D) in q's dtype, laid out as q.  Raises for other
    dtypes, shapes, strides and devices.
    """
    check_shapes(q, k, v)
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"no flash_attention kernel for devices {q.device}, "
                         f"{k.device}, {v.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of {list(DTYPES)}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    o = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    pl, tail = _prepared(q.shape, k.shape, q.dtype, q.stride(), k.stride(),
                         v.stride(), o.stride(),
                         (ptrs[0] % TMA_ALIGN, ptrs[1] % TMA_ALIGN,
                          ptrs[2] % TMA_ALIGN, ptrs[3] % TMA_ALIGN),
                         bool(causal))
    lib = _library()
    launch = (lib.flash_attention_tc_launch if pl.body == "tensor_core"
              else lib.flash_attention_launch)
    # the raw handle of the current stream, without building a Stream
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if dev.index == torch.cuda.current_device():
        err = launch(*ptrs, *tail, stream)
    else:
        with torch.cuda.device(dev):
            err = launch(*ptrs, *tail, stream)
    if err != 0:
        raise RuntimeError("flash_attention launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    global LAUNCHES, TC_LAUNCHES
    LAUNCHES += 1
    TC_LAUNCHES += pl.body == "tensor_core"
    return o


@functools.lru_cache(maxsize=256)
def _prepared(q_shape, kv_shape, dtype, q_strides, k_strides, v_strides,
              o_strides, offsets, causal):
    """(plan, the launcher's arguments between the pointers and the
    stream), cached: the wrapper runs on every attention call."""
    pl = _plan(q_shape, kv_shape, dtype, q_strides, k_strides, v_strides,
               o_strides, offsets, causal)
    B, Hq, Sq, D = q_shape
    Hkv, Skv = kv_shape[1], kv_shape[2]
    if pl.body == "tensor_core":   # one int64 array: see the C launcher
        params = [x for t in pl.tma for x in (*t.dims, *t.strides, *t.box)]
        params += [Hq, Hkv, Sq, Skv, D, pl.head_dim, int(causal),
                   *o_strides[:3], *pl.grid]
        return pl, ((ctypes.c_longlong * len(params))(*params),)
    return pl, (B, Hq, Hkv, Sq, Skv, D, pl.head_dim, int(pl.vector),
                int(causal), DTYPES[dtype], 1.0 / D ** 0.5,
                *q_strides[:3], *k_strides[:3], *v_strides[:3],
                *o_strides[:3])
