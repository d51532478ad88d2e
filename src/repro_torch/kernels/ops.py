"""Public entry points of the port's kernels.

The device decides the path: CUDA tensors go through the hand-written
kernels (``kernels.cgp_sim``, ``kernels.lut_matmul``,
``kernels.flash_attention``); CPU tensors go through their plain versions
in ``kernels.ref``.  There is no fallback between the two: a CUDA tensor
launches the kernel or raises.

Fake and ``meta`` tensors, of any device, take an abstract route
(``launch/dryrun.py`` traces a step on them): the kernel's results come
back as empty tensors of their shapes and dtypes, nothing is built,
loaded or launched, no data-dependent check runs, and the call is
appended to ``TRACED`` as ``{"kernel", "shape", "dtype"}``, ``shape``
being the arguments of the kernel's work model in ``launch/roofline.py``.
The glue around a kernel (decoding its raw sums, the sharded wrapper's
all-reduce) runs on the abstract results as it runs on the real ones.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.core import metrics as M
from repro_torch.core.genome import CGPSpec, Genome
from repro_torch.kernels import cgp_sim as _cgp
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import lut_matmul as _lut
from repro_torch.kernels import ref
from repro_torch.kernels import tune as _tune

# The last table staged for the lut_matmul kernel: (int32 LUT tensor, its
# version counter, staged uint16 table).  A model's projections all use the
# same installed LUT, so it is checked and converted once, not per call.
_STAGED: tuple | None = None
# the kernel calls made on fake or meta tensors, in order (module docstring)
TRACED: list[dict] = []


def abstract(t: torch.Tensor) -> bool:
    """True for a tensor that holds no data: fake or on ``meta``."""
    return isinstance(t, FakeTensor) or t.device.type == "meta"


def _traced(kernel: str, shape: tuple, dtype: torch.dtype) -> None:
    TRACED.append({"kernel": kernel, "shape": [int(n) for n in shape],
                   "dtype": str(dtype).removeprefix("torch.")})


def _abstract_raw(R: int, n_n: int, n_o: int, total_words: int,
                  device) -> _cgp.RawSums:
    """Empty ``RawSums`` of a launch of R genomes over a cube of
    ``total_words`` (which fixes the magnitude regime)."""
    per_bit = M.exact_sum_per_bit(32 * total_words, n_o)
    e = lambda shape, dt: torch.empty(shape, dtype=dt, device=device)
    return _cgp.RawSums(e((R, 3, n_o if per_bit else 1), torch.int64),
                        e((R, _cgp.N_INTS), torch.int32),
                        e((R,), torch.int32), e((R, n_n), torch.int32),
                        e((R, 3), torch.float64))


def _partials_from_raw(raw: _cgp.RawSums, n_words: int,
                       n_o: int) -> M.MetricPartials:
    """Decode the kernel's ``RawSums`` into ``metrics.error_partials``'s
    MetricPartials: the magnitude sums through the same float32 regime as
    ``metrics._exact_sum`` (one rounding of the exact total, or the ascending
    per-bit recombination), the float rows rounded once from float64."""
    count = 32 * n_words
    if M.exact_sum_per_bit(count, n_o):
        abs_sum, pos, neg = (M.recombine_bit_counts(raw.mag[:, q])
                             for q in (_cgp.ABS, _cgp.POS, _cgp.NEG))
    else:
        abs_sum, pos, neg = (raw.mag[:, q, 0].to(torch.float32)
                             for q in (_cgp.ABS, _cgp.POS, _cgp.NEG))
    fsums = raw.fsums.to(torch.float32)
    return M.MetricPartials(
        abs_sum=abs_sum,
        wce_max=raw.wce,
        err_count=raw.ints[:, 0],
        rel_sum=fsums[:, _cgp.REL_SUM],
        sgn_sum=pos - neg,
        acc0_bad=raw.ints[:, 1],
        hist=raw.ints[:, 2:],
        count=torch.full_like(raw.wce, count),
        sq_sum=fsums[:, _cgp.SQ_SUM],
        rel_sq=fsums[:, _cgp.REL_SQ],
    )


def resolve_variant(layout: str, width: int, R: int, device,
                    block_words: int | None = None,
                    r_tile: int | None = None) -> _tune.KernelVariant:
    """The kernel variant a call runs.  ``"auto"`` adopts the tuning
    table's whole winner for (width, R, the card's backend) — layout, run
    and group size were timed together — or genome-major on a miss; an
    explicit knob overrides that knob only."""
    if layout not in ("auto",) + _cgp.LAYOUTS:
        raise ValueError(f"layout must be 'auto' or one of {_cgp.LAYOUTS}, "
                         f"got {layout!r}")
    if layout == "auto":
        variant = _tune.resolve_variant(width, R, _tune.backend_key(device))
    else:
        variant = _tune.KernelVariant(
            layout, None, _cgp.DEFAULT_R_TILE if layout == "cube_major" else 1)
    if block_words is not None:
        variant = dataclasses.replace(variant, block_words=block_words)
    if r_tile is not None:
        variant = dataclasses.replace(variant, r_tile=r_tile)
    return variant


def cgp_eval_batched(genomes: Genome, spec: CGPSpec, in_planes: torch.Tensor,
                     golden_vals: torch.Tensor, gauss_sigma: float = 256.0,
                     layout: str = "auto", block_words: int | None = None,
                     r_tile: int | None = None, group=None
                     ) -> tuple[M.MetricPartials, torch.Tensor]:
    """Population evaluation in one kernel launch.

    ``genomes`` carries a leading axis R: nodes (R, n_n, 3), outs (R, n_o).
    Returns (MetricPartials with leading R, pops (R, n_n) float32).
    ``layout`` (``"auto"``, ``"genome_major"``, ``"cube_major"``) and the
    knobs pick the kernel variant (``resolve_variant``); the result is the
    same function whichever runs.  CPU tensors take ``ref.cgp_eval_ref``,
    where the layout changes nothing.

    With ``group`` (a ``torch.distributed`` process group) the cube is
    sharded over its ranks: ``in_planes``/``golden_vals`` are this rank's
    equal word slice, and what comes back is the whole cube's, on every
    rank.  CUDA tensors launch ``cgp_sim_metrics_batched_sharded`` (raw sums
    all-reduced before decoding); CPU tensors take
    ``ref.cgp_eval_ref_sharded`` (decoded partials combined, as the
    reference's jnp path does).  The variant resolves by the whole cube's
    (width, R) and runs on the slice.
    """
    n_words = in_planes.shape[1]
    if abstract(in_planes):
        R = genomes.nodes.shape[0]
        _traced("cgp_sim", (R, spec.n_i, spec.n_n, spec.n_o, n_words),
                torch.int32)
        total = n_words * (1 if group is None
                           else dist.get_world_size(group))
        raw = _abstract_raw(R, spec.n_n, spec.n_o, total, in_planes.device)
        if group is not None:
            raw = _cgp.all_reduce_raw(raw, group)
        return (_partials_from_raw(raw, total, spec.n_o),
                raw.pops.to(torch.float32))
    v = resolve_variant(layout, spec.n_i // 2, genomes.nodes.shape[0],
                        in_planes.device, block_words, r_tile)
    if in_planes.device.type == "cpu":
        if group is not None:
            return ref.cgp_eval_ref_sharded(genomes, spec, in_planes,
                                            golden_vals, gauss_sigma, group)
        return ref.cgp_eval_ref(genomes, spec, in_planes, golden_vals,
                                gauss_sigma)
    kw = dict(n_i=spec.n_i, n_n=spec.n_n, n_o=spec.n_o,
              gauss_sigma=gauss_sigma, layout=v.layout,
              block_words=v.block_words, r_tile=v.r_tile)
    nodes, outs = genomes.nodes.contiguous(), genomes.outs.contiguous()
    if group is None:
        raw = _cgp.cgp_sim_metrics_batched(nodes, outs, in_planes,
                                           golden_vals, **kw)
    else:
        raw = _cgp.cgp_sim_metrics_batched_sharded(
            nodes, outs, in_planes, golden_vals, group=group, **kw)
        n_words *= dist.get_world_size(group)
    return (_partials_from_raw(raw, n_words, spec.n_o),
            raw.pops.to(torch.float32))


def cgp_eval(genome: Genome, spec: CGPSpec, in_planes: torch.Tensor,
             golden_vals: torch.Tensor, gauss_sigma: float = 256.0
             ) -> tuple[M.MetricPartials, torch.Tensor]:
    """One genome: ``cgp_eval_batched`` with R = 1, leading axis dropped."""
    partials, pops = cgp_eval_batched(
        Genome(genome.nodes[None], genome.outs[None]), spec, in_planes,
        golden_vals, gauss_sigma)
    return M.MetricPartials(*(x[0] for x in partials)), pops[0]


def _staged_table(lut: torch.Tensor) -> torch.Tensor:
    """The staged table of ``lut``, cached while the same tensor is passed
    unchanged (inference tensors carry no version counter: restaged)."""
    global _STAGED
    if lut.is_inference():
        return _lut.stage_table(lut)
    if _STAGED is None or _STAGED[0] is not lut \
            or _STAGED[1] != lut._version:
        _STAGED = (lut, lut._version, _lut.stage_table(lut))
    return _STAGED[2]


def _as_u8(x: torch.Tensor, name: str) -> torch.Tensor:
    """An operand as contiguous uint8, checking the range of wider ints."""
    if x.dtype != torch.uint8:
        if x.dtype.is_floating_point or not (
                bool((x >= 0).all()) and bool((x <= 255).all())):
            raise ValueError(f"{name} must hold integers in [0, 255]")
        x = x.to(torch.uint8)
    return x.contiguous()


def lut_matmul(a: torch.Tensor, b: torch.Tensor,
               lut: torch.Tensor) -> torch.Tensor:
    """Approximate-multiplier matmul ``C[m, n] = Σ_k LUT[a[m, k], b[k, n]]``.

    Any (M, K) × (K, N) with operand values in [0, 255] (uint8, or a wider
    integer type that is checked); ``lut`` (256, 256) integer.  Returns the
    exact int32 contraction — no padding, so ``LUT[0, 0] != 0`` adds
    nothing for k outside [0, K).  CPU tensors take ``ref.lut_matmul_ref``;
    CUDA tensors launch the kernel, which needs every entry of ``lut`` in
    [0, 65535] and raises otherwise."""
    if abstract(a):
        if a.dtype.is_floating_point or b.dtype.is_floating_point:
            raise ValueError("lut_matmul operands must be integers")
        if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
            raise ValueError(f"contraction mismatch: a {tuple(a.shape)}, "
                             f"b {tuple(b.shape)}")
        _traced("lut_matmul", (a.shape[0], a.shape[1], b.shape[1]),
                torch.uint8)
        return torch.empty((a.shape[0], b.shape[1]), dtype=torch.int32,
                           device=a.device)
    if a.device.type == "cpu":
        return ref.lut_matmul_ref(a, b, lut)
    return _lut.lut_matmul(_as_u8(a, "a"), _as_u8(b, "b"), _staged_table(lut))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Attention forward: q (B, Hq, S, D), k/v (B, Hkv, S, D), GQA folded
    (q-head h uses kv-head ``h // (Hq // Hkv)``); q's dtype out.

    Raises where the reference asserts (each S a multiple of
    ``min(128, S)``).  CPU tensors take ``ref.flash_attention_ref``; CUDA
    tensors launch the kernel, which reads the grouped kv-heads in place."""
    if abstract(q):
        _fa.check_shapes(q, k, v)
        B, Hq, Sq, D = q.shape
        _traced("flash_attention", (B, Hq, k.shape[1], Sq, k.shape[2], D,
                                    q.element_size(), bool(causal)), q.dtype)
        return torch.empty_like(q)
    if q.device.type == "cpu":
        _fa.check_shapes(q, k, v)
        return ref.flash_attention_ref(q, k, v, causal)
    return _fa.flash_attention(q, k, v, causal=causal)   # checks them too
