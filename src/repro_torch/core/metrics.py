"""Error metrics — paper Sec. II, Eq. (1)-(7).

All metrics are computed from integer output values over the input cube and
returned as *partial sums* (``MetricPartials``) before normalization
(``finalize_metrics``).  Relativization follows the paper: magnitudes are
divided by the output range 2^m and reported in percent.  Every function
takes leading batch dims written out (a population of candidates).

Metric vector layout (used by fitness thresholds; see ``fitness.py``):
    0 MAE_rel(%)  1 WCE_rel(%)  2 ER(%)  3 MRE(%)  4 |AVG|_rel(%)
    5 ACC0 (1 = holds)          6 GAUSS (1 = holds)

Exactness contract with the reference package:

  * integer partials (err_count, acc0_bad, hist, count, wce_max) are exact;
  * the magnitude sums use the reference's two float32 regimes
    (``_exact_sum``), so abs_sum/sgn_sum and the MAE/WCE/ER/AVG/ACC0/GAUSS
    values carry the same bits;
  * ``rel_sum``, ``sq_sum`` and ``rel_sq`` compute each element in float32
    as the reference does, then accumulate in float64 and round once — a
    device-independent order; against the reference's float32 reduction
    they agree to rtol 1e-6.
"""
from __future__ import annotations

from math import erf, sqrt
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist

MAE, WCE, ER, MRE, AVG, ACC0, GAUSS = range(7)
METRIC_NAMES = ("mae", "wce", "er", "mre", "avg", "acc0", "gauss")
N_METRICS = 7
N_GAUSS_SIDE = 4
N_BINS = 2 * N_GAUSS_SIDE + 2


class MetricPartials(NamedTuple):
    """Raw sums of one cube slice (leading batch dims allowed)."""
    abs_sum: torch.Tensor    # Σ |g - c|            float32 (exact regimes)
    wce_max: torch.Tensor    # max |g - c|          int32
    err_count: torch.Tensor  # #{x : g != c}        int32
    rel_sum: torch.Tensor    # Σ |g-c| / max(g, 1)  float32
    sgn_sum: torch.Tensor    # Σ (g - c)            float32 (exact regimes)
    acc0_bad: torch.Tensor   # #{x : g = 0 ∧ c != 0} int32
    hist: torch.Tensor       # (..., n_bins) signed-error histogram, int32
    count: torch.Tensor      # #inputs in this slice int32
    sq_sum: torch.Tensor     # Σ (g - c)^2          float32
    rel_sq: torch.Tensor     # Σ (|g-c| / max(g, 1))^2 float32


def gauss_bin_edges(sigma: float, n_side: int = N_GAUSS_SIDE) -> np.ndarray:
    """σ-wide bin edges covering ±n_side·σ, plus two open tail bins."""
    return np.arange(-n_side, n_side + 1, dtype=np.float64) * sigma


def gauss_bin_mass(sigma: float, n_side: int = N_GAUSS_SIDE) -> np.ndarray:
    """Expected probability mass per bin under N(0, σ) (tails included)."""
    edges = gauss_bin_edges(sigma, n_side)
    cdf = np.array([0.5 * (1 + erf(e / (sigma * sqrt(2)))) for e in edges])
    interior = np.diff(cdf)
    return np.concatenate([[cdf[0]], interior, [1.0 - cdf[-1]]])


def exact_sum_per_bit(n: int, n_bits: int) -> bool:
    """Which ``_exact_sum`` regime a slice of ``n`` values < 2^n_bits takes:
    False for the byte split (both block sums provably < 2^24), True for
    the per-bit popcount recombination."""
    hi_max = max((1 << max(n_bits - 8, 0)) - 1, 0)
    return not (n * 255 < (1 << 24) and n * hi_max < (1 << 24))


def _exact_sum(v: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Σv over the last dim for 0 ≤ v < 2^n_bits, float32, in the
    reference's statically chosen regime: the byte split sums two exact
    float32 totals and rounds once; the per-bit regime recombines exact bit
    counts Σ 2^b·cnt_b in ascending float32 order."""
    if not exact_sum_per_bit(v.shape[-1], n_bits):
        hi = (v >> 8).sum(dim=-1).to(torch.float32)
        lo = (v & 0xFF).sum(dim=-1).to(torch.float32)
        return 256.0 * hi + lo
    counts = torch.stack([((v >> b) & 1).sum(dim=-1)
                          for b in range(n_bits)], dim=-1)
    return recombine_bit_counts(counts)


def recombine_bit_counts(counts: torch.Tensor) -> torch.Tensor:
    """Σ_b 2^b·cnt_b (counts in the last dim), added in ascending float32
    order as the reference's per-bit regime does."""
    total = torch.zeros(counts.shape[:-1], dtype=torch.float32,
                        device=counts.device)
    for b in range(counts.shape[-1]):
        total = total + float(1 << b) * counts[..., b].to(torch.float32)
    return total


def sum_f64(x: torch.Tensor) -> torch.Tensor:
    """Last-dim sum of float32 terms accumulated in float64, rounded once."""
    return x.to(torch.float64).sum(dim=-1).to(torch.float32)


def gauss_bins(diff: torch.Tensor, gauss_sigma: float) -> torch.Tensor:
    """Histogram bin of each signed error: the number of float32 bin edges
    ≤ float32(diff) (the reference's ``searchsorted(side="right")``)."""
    edges = torch.as_tensor(gauss_bin_edges(gauss_sigma), dtype=torch.float32,
                            device=diff.device)
    return torch.searchsorted(edges, diff.to(torch.float32), right=True)


def error_partials(golden: torch.Tensor, cand: torch.Tensor,
                   gauss_sigma: float, n_bits: int = 16) -> MetricPartials:
    """Raw sums of one slice from integer output values.

    Args:
      golden: (S,) int32 exact outputs; cand: (..., S) int32 approximate
        outputs (leading batch dims allowed).
      gauss_sigma: σ for the Gauss_σ histogram.
      n_bits: static bound |g - c| < 2^n_bits (= the circuit's n_o); picks
        the exact-sum regime.
    """
    g = golden.to(torch.int32)
    c = cand.to(torch.int32)
    diff = g - c
    ad = diff.abs()
    nz = diff != 0
    bins = gauss_bins(diff, gauss_sigma)
    hist = torch.zeros((*diff.shape[:-1], N_BINS), dtype=torch.int32,
                       device=diff.device)
    hist.scatter_add_(-1, bins, nz.to(torch.int32))
    adf = ad.to(torch.float32)
    relf = adf / torch.clamp(g, min=1).to(torch.float32)
    count = torch.full(diff.shape[:-1], diff.shape[-1], dtype=torch.int32,
                       device=diff.device)
    return MetricPartials(
        abs_sum=_exact_sum(ad, n_bits),
        wce_max=ad.amax(dim=-1),
        err_count=nz.sum(dim=-1, dtype=torch.int32),
        rel_sum=sum_f64(relf),
        sgn_sum=(_exact_sum(torch.clamp(diff, min=0), n_bits)
                 - _exact_sum(torch.clamp(-diff, min=0), n_bits)),
        acc0_bad=((g == 0) & (c != 0)).sum(dim=-1, dtype=torch.int32),
        hist=hist,
        count=count,
        sq_sum=sum_f64(adf * adf),
        rel_sq=sum_f64(relf * relf),
    )


def all_reduce_packed(tensors: Sequence[torch.Tensor], op, group
                      ) -> list[torch.Tensor]:
    """All-reduce tensors of one dtype and device in ONE collective: they
    are flattened into one contiguous buffer, reduced with ``op`` over
    ``group`` and split back into new tensors of their shapes."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise TypeError(f"one dtype per all-reduce, got "
                        f"{sorted(map(str, dtypes))}")
    buf = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(buf, op=op, group=group)
    return [x.reshape(t.shape) for x, t in
            zip(buf.split([t.numel() for t in tensors]), tensors)]


def combine_partials(p: MetricPartials, group) -> MetricPartials:
    """The partials of the whole cube from each rank's slice: every field
    all-reduced with SUM over ``group``, ``wce_max`` with MAX (the
    reference's psum/pmax over an input-space-sharding mesh axis).  The
    float32 fields are summed in float32, as the reference's psum does."""
    f32 = ("abs_sum", "rel_sum", "sgn_sum", "sq_sum", "rel_sq")
    i32 = ("err_count", "acc0_bad", "hist", "count")
    out = dict(zip(f32, all_reduce_packed(
        [getattr(p, k) for k in f32], dist.ReduceOp.SUM, group)))
    out.update(zip(i32, all_reduce_packed(
        [getattr(p, k) for k in i32], dist.ReduceOp.SUM, group)))
    out["wce_max"], = all_reduce_packed([p.wce_max], dist.ReduceOp.MAX,
                                        group)
    return MetricPartials(**out)


def finalize_metrics(p: MetricPartials, n_o: int, gauss_sigma: float,
                     gauss_slack: float = 1.0) -> torch.Tensor:
    """(..., N_METRICS) float32 metric vector per the layout above.

    MAE/WCE/|AVG| are relativized to 2^n_o and expressed in PERCENT, as in
    the paper's figures; ER and MRE are percentages by definition.  An
    empty slice finalizes to zeros (n = max(count, 1)), never NaN.
    """
    out_range = float(1 << n_o)
    n = torch.clamp(p.count.to(torch.float32), min=1.0)
    mae = p.abs_sum / n
    wce = p.wce_max.to(torch.float32)
    er = p.err_count.to(torch.float32) / n
    mre = p.rel_sum / n
    avg = p.sgn_sum / n
    acc0 = (p.acc0_bad == 0).to(torch.float32)

    mass = torch.as_tensor(gauss_bin_mass(gauss_sigma), dtype=torch.float32,
                           device=n.device)
    allowed = mass * n[..., None] * gauss_slack
    gauss_ok = (p.hist.to(torch.float32) <= allowed).all(dim=-1)

    return torch.stack([
        100.0 * mae / out_range,
        100.0 * wce / out_range,
        100.0 * er,
        100.0 * mre,
        100.0 * avg.abs() / out_range,
        acc0,
        gauss_ok.to(torch.float32),
    ], dim=-1)


def metric_stderr(p: MetricPartials, n_o: int) -> torch.Tensor:
    """(..., N_METRICS) float32 standard errors in ``finalize_metrics``'s
    units, from the sample second moments in the partials (CLT):

      * MAE / |AVG|: sqrt(Var[|d|] / n), sqrt(Var[d] / n), both from Σd²,
        scaled by 100/2^n_o like the point estimates;
      * ER: Bernoulli sqrt(p̂(1-p̂)/n), in percent;
      * MRE: sqrt(Var[rel] / n), in percent;
      * WCE / ACC0 / GAUSS: 0 — extreme-value and indicator metrics have no
        CLT interval; on a sample they are observed values (lower bounds),
        which only the exact tier (``core.certify``) can certify.

    Under exhaustive evaluation the census has no sampling error: callers
    report zeros there and compute this for sampled evaluation only.  The
    arithmetic is the reference's, in float32; ``sq_sum``/``rel_sq`` are
    sums in another order than the reference's, so the results agree to
    rtol 1e-5.
    """
    out_range = float(1 << n_o)
    n = torch.clamp(p.count.to(torch.float32), min=1.0)
    mean_abs = p.abs_sum.to(torch.float32) / n
    mean_sgn = p.sgn_sum.to(torch.float32) / n
    mean_sq = p.sq_sum / n
    var_abs = torch.clamp(mean_sq - mean_abs ** 2, min=0.0)
    var_sgn = torch.clamp(mean_sq - mean_sgn ** 2, min=0.0)
    er_hat = p.err_count.to(torch.float32) / n
    var_er = torch.clamp(er_hat * (1.0 - er_hat), min=0.0)
    mre_hat = p.rel_sum / n
    var_rel = torch.clamp(p.rel_sq / n - mre_hat ** 2, min=0.0)
    rt_n = torch.sqrt(n)
    zero = torch.zeros_like(n)
    return torch.stack([
        100.0 * torch.sqrt(var_abs) / rt_n / out_range,
        zero,
        100.0 * torch.sqrt(var_er) / rt_n,
        100.0 * torch.sqrt(var_rel) / rt_n,
        100.0 * torch.sqrt(var_sgn) / rt_n / out_range,
        zero,
        zero,
    ], dim=-1)


def error_moments(golden: torch.Tensor, cand: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, std) of the signed error over the last dim (population std),
    for Fig. 13-style analysis: float64 accumulation, rounded to float32."""
    diff = (golden.to(torch.int32) - cand.to(torch.int32)).to(torch.float64)
    return (diff.mean(dim=-1).to(torch.float32),
            diff.std(dim=-1, correction=0).to(torch.float32))


# ------------------------- NumPy oracle (tests) -------------------------

def metrics_np(golden: np.ndarray, cand: np.ndarray, n_o: int,
               gauss_sigma: float = 256.0, n_gauss_side: int = N_GAUSS_SIDE,
               gauss_slack: float = 1.0) -> np.ndarray:
    """float64 NumPy oracle of ``finalize_metrics(error_partials(...))``;
    also the exact tier's finalization (``core.certify``)."""
    g = golden.astype(np.int64)
    c = cand.astype(np.int64)
    diff = g - c
    ad = np.abs(diff)
    n = diff.size
    out_range = float(1 << n_o)
    mae = ad.mean()
    wce = ad.max()
    er = (diff != 0).mean()
    mre = (ad / np.maximum(g, 1)).mean()
    avg = diff.mean()
    acc0 = float(((g == 0) & (c != 0)).sum() == 0)
    edges = gauss_bin_edges(gauss_sigma, n_gauss_side)
    idx = np.searchsorted(edges, diff.astype(np.float64), side="right")
    hist = np.bincount(idx[diff != 0], minlength=len(edges) + 1)
    mass = gauss_bin_mass(gauss_sigma, n_gauss_side)
    gauss_ok = float(np.all(hist <= mass * n * gauss_slack))
    return np.array([100 * mae / out_range, 100 * wce / out_range, 100 * er,
                     100 * mre, 100 * abs(avg) / out_range, acc0, gauss_ok],
                    dtype=np.float32)
