"""The exact certification tier (a copy of the reference's
``repro/core/certify.py``).

Sampled evaluation (``core.sampling``) cannot certify WCE, ACC0 or GAUSS: a
sample max is only a lower bound on the worst case, and the indicator
metrics have no CLT interval (``metrics.metric_stderr`` gives them 0).  So
a sampled sweep screens its population on the sample, and escalates the
elites that satisfy the combined constraint on the sample to an EXACT
re-measurement over the whole 2^(2w) cube, capped per chunk by an adaptive
budget (``CertifyPolicy``).

Two exact regimes, chosen from the cube size (``certified_metrics``):

  * **whole cube in one dispatch** — when the cube fits ``dispatch_rows``,
    the genomes are simulated over the exhaustive bit-plane cube and the
    values finalized by ``metrics.metrics_np``, as the reference does;
  * **chunked pass** — otherwise the cube is streamed in
    ``dispatch_rows``-row slices of packed operand planes (the same
    ``(n_i, W)`` contract the cgp_sim kernel consumes), and each slice's
    partials are accumulated in int64/float64.  MAE, WCE, ER, AVG, ACC0
    and GAUSS are integer-exact at any width; MRE is a float64 sum over
    the slices, as in the reference.

The simulation is the plain ``simulate`` path on the genomes' device (the
reference's exact pass is jnp, not its kernel).  The integer partials are
summed there in int64, which is exact in any order; the relative errors
are formed there in float64 and summed on the host by numpy in the
reference's order, so the certified vector equals the reference's bit for
bit.  The elites of one call are simulated together, one
``(R, n_wires, W)`` pass per slice.

The escalation driver is in ``core.sweep.run_sweep_batched`` (gated by
``EvolveConfig.certify``); certified rows land in the results' schema v3
``certified_mask`` column and ``CircuitRecord.certified``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import metrics as M
from repro_torch.core import simulate
from repro_torch.core.fitness import _IS_LOWER_BOUND
from repro_torch.core.genome import CGPSpec, Genome
from repro_torch.device import resolve_device

#: default rows per exact dispatch: 2^20 rows keeps the live (n_wires, W)
#: simulation state of a paper-scale genome around 100 MB; widths ≤ 10
#: certify in ONE dispatch.
DISPATCH_ROWS = 1 << 20

#: metric indices a sampled estimate can never certify: the sample max is a
#: lower bound (WCE) and the indicators are verdicts about the whole cube
#: (ACC0, GAUSS) — the positions ``metrics.metric_stderr`` zeroes.
UNCERTIFIABLE = (M.WCE, M.ACC0, M.GAUSS)


def requires_certification(thresholds) -> bool:
    """True iff the combined constraint binds a metric a sample cannot
    certify (WCE/ACC0/GAUSS).  A sampled run under such a constraint may
    satisfy it on the sample, but is not certified feasible until the exact
    tier re-measured it."""
    t = np.asarray(thresholds)
    hard = np.zeros(M.N_METRICS, dtype=bool)
    hard[list(UNCERTIFIABLE)] = True
    # a finite threshold binds in both encodings: upper bounds are +inf
    # when unconstrained, required booleans -inf
    return bool((np.isfinite(t) & hard).any())


def feasible_np(metric_vec, thresholds) -> bool:
    """Host-side Eq. (9) predicate — ``fitness.feasible`` on numpy (the same
    lower-bound encoding for the boolean metrics)."""
    m = np.asarray(metric_vec, dtype=np.float32)
    t = np.asarray(thresholds, dtype=np.float32)
    return bool(np.where(_IS_LOWER_BOUND, m >= t, m <= t).all())


@dataclasses.dataclass(frozen=True)
class CertifyPolicy:
    """Adaptive escalation budget: chunk ``i`` of ``n`` may escalate up to
    ``ceil(budget * (1 + ramp * i/(n-1)))`` elites (``ramp=1`` doubles the
    cap by the last chunk, ``ramp=0`` is flat).  A pure function of the
    chunk plan, so resumed sweeps budget identically."""
    budget: int = 8                    # base escalations per chunk
    ramp: float = 1.0                  # late-sweep budget growth factor
    dispatch_rows: int = DISPATCH_ROWS  # rows per exact dispatch

    def __post_init__(self):
        if self.budget < 1:
            raise ValueError(f"budget must be >= 1, got {self.budget}")
        if self.ramp < 0:
            raise ValueError(f"ramp must be >= 0, got {self.ramp}")
        if self.dispatch_rows < 32 or self.dispatch_rows % 32:
            raise ValueError(f"dispatch_rows must be a positive multiple of "
                             f"32, got {self.dispatch_rows}")

    def chunk_budget(self, chunk_idx: int, n_chunks: int) -> int:
        """Escalation cap of plan chunk ``chunk_idx`` of ``n_chunks``."""
        frac = chunk_idx / max(n_chunks - 1, 1)
        return int(np.ceil(self.budget * (1.0 + self.ramp * frac)))


def select_escalations(feasible_mask, power_rel, certified_mask,
                       budget: int) -> np.ndarray:
    """Rows to escalate: sampled-feasible, not yet certified, lowest
    relative power first (stable), at most ``budget``."""
    feas = np.asarray(feasible_mask, dtype=bool)
    done = np.asarray(certified_mask, dtype=bool)
    elig = np.flatnonzero(feas & ~done)
    order = elig[np.argsort(np.asarray(power_rel)[elig], kind="stable")]
    return order[:max(int(budget), 0)]


# --------------------------------------------------------------------------
# Exact measurement
# --------------------------------------------------------------------------

def cube_slice_planes(n_i: int, start: int, n_rows: int) -> np.ndarray:
    """(n_i, n_rows/32) int32 packed bit-planes of cube rows
    [start, start + n_rows) — ``simulate.input_planes_np`` restricted to an
    index slice, with the same lane packing."""
    if n_rows % 32 or n_rows < 32:
        raise ValueError(f"n_rows must be a positive multiple of 32, "
                         f"got {n_rows}")
    xs = np.arange(start, start + n_rows, dtype=np.uint64)
    planes = []
    for i in range(n_i):
        bits = ((xs >> np.uint64(i)) & np.uint64(1)).astype(np.uint32)
        words = bits.reshape(-1, 32)
        packed = (words << np.arange(32, dtype=np.uint32)[None, :]).sum(
            axis=1, dtype=np.uint32)
        planes.append(packed)
    return np.stack(planes).astype(np.int32)  # two's complement reinterpret


#: bit l of these words is bit i of l, for i < 5: the lane pattern that
#: every word of the first five input planes holds
_LANE_WORDS = (0xAAAAAAAA, 0xCCCCCCCC, 0xF0F0F0F0, 0xFF00FF00, 0xFFFF0000)


def _slice_planes(n_i: int, start: int, n_rows: int,
                  device: torch.device) -> torch.Tensor:
    """``cube_slice_planes`` built on ``device`` for a ``start`` that is a
    multiple of 32: planes 0-4 are the lane pattern in every word, and
    plane i ≥ 5 is word w's bit i - 5 of ``start/32 + w`` spread over the
    whole word."""
    if start % 32 or n_rows % 32 or n_rows < 32:
        raise ValueError(f"slice [{start}, {start + n_rows}) is not whole "
                         f"words")
    words = start // 32 + torch.arange(n_rows // 32, dtype=torch.int64,
                                       device=device)
    rows = [torch.full_like(words, _LANE_WORDS[i]) if i < 5
            else -((words >> (i - 5)) & 1) for i in range(n_i)]
    # the low 32 bits of each row, two's complement, as the packing gives
    return ((torch.stack(rows) + (1 << 31)) % (1 << 32) - (1 << 31)).to(
        torch.int32)


def _golden_of(xs, width: int, kind: str):
    """Exact golden outputs of cube indices ``xs`` (a numpy array or a
    tensor of int64)."""
    a = xs & ((1 << width) - 1)
    b = xs >> width
    if kind == "mul":
        return a * b
    if kind == "add":
        return a + b
    raise ValueError(kind)


def _golden_slice(width: int, kind: str, start: int, n_rows: int
                  ) -> np.ndarray:
    """int64 exact golden outputs on cube rows [start, start + n_rows)."""
    return _golden_of(np.arange(start, start + n_rows, dtype=np.int64),
                      width, kind)


def _simulate(genomes: Genome, spec: CGPSpec, planes) -> torch.Tensor:
    """(R, 32·W) int32 values of the genomes on packed planes, simulated on
    the genomes' device."""
    in_planes = torch.as_tensor(planes, device=genomes.nodes.device)
    return simulate.simulate_values(genomes, spec, in_planes)


def certified_metrics_batched(nodes, outs, spec: CGPSpec, kind: str,
                              width: int, gauss_sigma: float,
                              dispatch_rows: int = DISPATCH_ROWS,
                              n_gauss_side: int = M.N_GAUSS_SIDE,
                              gauss_slack: float = 1.0,
                              device: torch.device | str | None = None
                              ) -> np.ndarray:
    """EXACT (R, N_METRICS) float32 metric vectors of R genomes (nodes
    (R, n_n, 3), outs (R, n_o)) over the whole 2^(2w) cube: each row is
    ``certified_metrics`` of that genome.  The genomes are simulated
    together on ``device`` (default: the card; the genomes' own device when
    they are tensors).

    In the chunked pass the integer partials of each slice (Σ|d|, max |d|,
    #d≠0, Σd, the ACC0 count, the histogram) are summed on the device in
    int64, exactly; the relative errors |d|/max(g, 1) are formed there in
    float64 (the same IEEE division numpy does) and summed on the host by
    numpy, per genome and slice, as the reference sums them."""
    if kind not in ("mul", "add"):
        raise ValueError(kind)
    if isinstance(nodes, torch.Tensor) and device is None:
        device = nodes.device
    dev = resolve_device(device)
    as_i32 = lambda x: (x.to(dev, torch.int32) if isinstance(x, torch.Tensor)
                        else torch.tensor(np.asarray(x), dtype=torch.int32,
                                          device=dev))
    g = Genome(as_i32(nodes).reshape(-1, spec.n_n, 3),
               as_i32(outs).reshape(-1, spec.n_o))
    R = g.nodes.shape[0]
    n = 1 << spec.n_i
    if n <= dispatch_rows:
        # sub-word cubes are tiled to 32 lanes; the first n values are the
        # cube itself
        cvals = _simulate(g, spec, simulate.input_planes_np(spec.n_i))
        cvals = cvals.cpu().numpy()[:, :n]
        gvals = _golden_slice(width, kind, 0, n)
        return np.stack([M.metrics_np(gvals, cvals[r], spec.n_o, gauss_sigma,
                                      n_gauss_side, gauss_slack)
                         for r in range(R)])

    # chunked pass: int64/float64 partials per genome, combined as shards
    # combine (sum every accumulator, max wce_max)
    chunk = 1 << (int(dispatch_rows).bit_length() - 1)  # pow2 divides pow2 n
    chunk = max(32, min(chunk, n))
    edges = M.gauss_bin_edges(gauss_sigma, n_gauss_side)
    edges_t = torch.as_tensor(edges, dtype=torch.float64, device=dev)
    zeros = lambda: torch.zeros(R, dtype=torch.int64, device=dev)
    abs_sum, sgn_sum, err_count, acc0_bad, wce = (zeros() for _ in range(5))
    hist = torch.zeros((R, len(edges) + 1), dtype=torch.int64, device=dev)
    rel_sum = [0.0] * R
    for start in range(0, n, chunk):
        c = _simulate(g, spec, _slice_planes(spec.n_i, start, chunk, dev)
                      ).to(torch.int64)
        gs = _golden_of(torch.arange(start, start + chunk,
                                     dtype=torch.int64, device=dev),
                        width, kind)
        diff = gs - c                                     # (R, chunk)
        ad = diff.abs()
        nz = diff != 0
        abs_sum += ad.sum(dim=1)
        wce = torch.maximum(wce, ad.amax(dim=1))
        err_count += nz.sum(dim=1)
        sgn_sum += diff.sum(dim=1)
        acc0_bad += ((gs == 0) & (c != 0)).sum(dim=1)
        idx = torch.searchsorted(edges_t, diff.to(torch.float64), right=True)
        hist.scatter_add_(1, idx, nz.to(torch.int64))
        rel = (ad.to(torch.float64)
               / torch.clamp(gs, min=1).to(torch.float64)).cpu().numpy()
        for r in range(R):
            rel_sum[r] += float(rel[r].sum())

    out_range = float(1 << spec.n_o)
    mass = M.gauss_bin_mass(gauss_sigma, n_gauss_side)
    abs_sum, sgn_sum, err_count, acc0_bad, wce, hist = (
        x.cpu().numpy() for x in (abs_sum, sgn_sum, err_count, acc0_bad, wce,
                                  hist))
    return np.stack([np.array([
        100.0 * (int(abs_sum[r]) / n) / out_range,
        100.0 * int(wce[r]) / out_range,
        100.0 * (int(err_count[r]) / n),
        100.0 * (rel_sum[r] / n),
        100.0 * abs(int(sgn_sum[r]) / n) / out_range,
        float(acc0_bad[r] == 0),
        float(np.all(hist[r] <= mass * n * gauss_slack)),
    ], dtype=np.float32) for r in range(R)])


def certified_metrics(nodes, outs, spec: CGPSpec, kind: str, width: int,
                      gauss_sigma: float, dispatch_rows: int = DISPATCH_ROWS,
                      n_gauss_side: int = M.N_GAUSS_SIDE,
                      gauss_slack: float = 1.0,
                      device: torch.device | str | None = None
                      ) -> np.ndarray:
    """EXACT (N_METRICS,) float32 metric vector of one genome over the whole
    2^(2w) cube, equal to the reference's bit for bit: the whole cube in one
    dispatch when it fits ``dispatch_rows``, else the chunked pass (module
    docstring).  ``gauss_sigma``/``n_gauss_side``/``gauss_slack`` must be
    the screening tier's, so the verdict answers the same constraint."""
    return certified_metrics_batched(
        nodes[None], outs[None], spec, kind, width, gauss_sigma,
        dispatch_rows, n_gauss_side, gauss_slack, device)[0]
