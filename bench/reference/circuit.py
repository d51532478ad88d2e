"""Plain reference of one generation of the (1+λ) CGP sweep.

Written from the method's definition (the paper's Sec. III, Eq. (1)-(9))
and from the configuration file's constants, not from the program: it
imports nothing of the program.  It re-derives, from the state before a
generation and the same inputs (golden genome, thresholds, keys), what the
state after it must say:

  * each run's PRNG stream: JAX's default generator (threefry-2x32 with
    partitionable counters), which the sweep defines its runs by, in NumPy
    uint32 arithmetic;
  * the λ offspring by per-gene point mutation;
  * every candidate's outputs over the whole 2^(2w) input cube, by
    bit-sliced simulation of its gates;
  * the error metrics in float64 and the activity-based power of the
    active gates;
  * Eq. (8)/(9) fitness and (1+λ) selection with neutral drift.

Simulation and metrics run in plain PyTorch on whatever device the genomes
are given on, in blocks of genomes so that the wire planes fit.
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = np.uint64(0xFFFFFFFF)
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


# ------------------------------ PRNG ----------------------------------------

def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on broadcast uint32 arrays."""
    with np.errstate(over="ignore"):
        k0, k1 = np.asarray(k0, np.uint32), np.asarray(k1, np.uint32)
        ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
        x0 = np.asarray(x0, np.uint32) + ks[0]
        x1 = np.asarray(x1, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _bits_pair(key: np.ndarray, shape: tuple) -> tuple:
    """The two threefry words of counters 0..prod(shape)-1 under ``key``
    (..., 2): the high counter word first, as JAX's partitionable mode."""
    n = math.prod(shape)
    counts = np.arange(n, dtype=np.uint64)
    hi = (counts >> np.uint64(32)).astype(np.uint32).reshape(shape)
    lo = (counts & MASK32).astype(np.uint32).reshape(shape)
    pad = (Ellipsis,) + (None,) * len(shape)
    return threefry2x32(key[..., 0][pad], key[..., 1][pad], hi, lo)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """(..., 2) uint32 keys -> (..., num, 2)."""
    a, b = _bits_pair(key, (num,))
    return np.stack([a, b], axis=-1)


def random_bits(key: np.ndarray, shape: tuple) -> np.ndarray:
    a, b = _bits_pair(key, shape)
    return a ^ b


def randint(key: np.ndarray, shape: tuple, maxval) -> np.ndarray:
    """Integers in [0, maxval) by JAX's two-word modulus draw; ``maxval``
    broadcasts against ``shape``."""
    keys = split(key, 2)
    higher = random_bits(keys[..., 0, :], shape).astype(np.uint64)
    lower = random_bits(keys[..., 1, :], shape).astype(np.uint64)
    span = np.maximum(np.asarray(maxval, np.uint64), np.uint64(1))
    mult = ((np.uint64(1 << 16) % span) ** np.uint64(2) & MASK32) % span
    off = ((higher % span) * mult & MASK32) + lower % span
    return ((off & MASK32) % span).astype(np.int64)


def bernoulli(key: np.ndarray, p: float, shape: tuple) -> np.ndarray:
    """uniform < float32(p), the uniform being the top 23 bits times
    2^-23."""
    mant = random_bits(key, shape) >> np.uint32(9)
    return mant.astype(np.float64) * 2.0 ** -23 < float(np.float32(p))


# ---------------------------- mutation --------------------------------------

def mutate(key: np.ndarray, nodes: np.ndarray, outs: np.ndarray, n_i: int,
           n_funcs: int, rate: float) -> tuple[np.ndarray, np.ndarray]:
    """One offspring per key: every gene resampled with probability
    ``rate`` from its legal range (fan-ins from the earlier wires, the
    function from the gate set, outputs from every wire)."""
    n_n, n_o = nodes.shape[-2], outs.shape[-1]
    ks = split(key, 6)
    hi = n_i + np.arange(n_n)
    bounds = np.stack([hi, hi, np.full(n_n, n_funcs)])          # (3, n_n)
    fresh = randint(ks[..., 2:5, :], (n_n,), bounds)        # (..., 3, n_n)
    pick = bernoulli(ks[..., 0, :], rate, (n_n, 3))
    new_nodes = np.where(pick, np.swapaxes(fresh, -1, -2), nodes)
    fresh_o = randint(ks[..., 5, :], (n_o,), n_i + n_n)
    pick_o = bernoulli(ks[..., 1, :], rate, (n_o,))
    return new_nodes.astype(np.int64), np.where(pick_o, fresh_o,
                                                outs).astype(np.int64)


def offspring(key: np.ndarray, nodes: np.ndarray, outs: np.ndarray, n_i: int,
              n_funcs: int, lam: int, rate: float):
    """(next key, λ offspring) of runs with keys (C, 2) and parents (C,
    n_n, 3) / (C, n_o): the key splits in two, the second half draws the
    offspring from its λ-way split."""
    keys = split(key)                                            # (C, 2, 2)
    kids = split(keys[:, 1], lam)                                # (C, λ, 2)
    on, oo = mutate(kids, nodes[:, None], outs[:, None], n_i, n_funcs, rate)
    return keys[:, 0], on, oo


# --------------------------- golden circuit ---------------------------------

def array_multiplier(width: int, n_n: int, gate: dict) -> tuple:
    """The textbook w × w array multiplier as a genome (AND partial
    products, carry-save rows of half and full adders, the last row's bits
    as the top outputs), padded with inert BUF(0) nodes.  ``gate`` maps
    gate names to codes.  Inputs: a at 0..w-1, b at w..2w-1, LSB first."""
    nodes: list[tuple[int, int, int]] = []
    n_i = 2 * width

    def g(func, a, b=None):
        nodes.append((a, a if b is None else b, gate[func]))
        return n_i + len(nodes) - 1

    def half(a, b):
        return g("xor", a, b), g("and", a, b)

    def full(a, b, c):
        s1 = g("xor", a, b)
        s = g("xor", s1, c)
        c1 = g("and", a, b)
        return s, g("or", c1, g("and", s1, c))

    pp = [[g("and", j, width + i) for j in range(width)]
          for i in range(width)]
    outs, row = [pp[0][0]], pp[0][1:]
    for i in range(1, width):
        new, carry = [], None
        for j in range(width):
            acc = row[j] if j < len(row) else None
            if acc is None and carry is None:
                s, carry = pp[i][j], None
            elif acc is None:
                s, carry = half(pp[i][j], carry)
            elif carry is None:
                s, carry = half(pp[i][j], acc)
            else:
                s, carry = full(pp[i][j], acc, carry)
            new.append(s)
        outs.append(new[0])
        row = new[1:] + ([carry] if carry is not None else [])
    outs += row
    while len(outs) < 2 * width:
        outs.append(g("xor", 0, 0))
    if len(nodes) > n_n:
        raise ValueError(f"{len(nodes)} gates do not fit in {n_n} nodes")
    nodes += [(0, 0, gate["buf"])] * (n_n - len(nodes))
    return np.array(nodes, np.int64), np.array(outs, np.int64)


# ---------------------------- simulation ------------------------------------

def _input_planes(n_i: int, device) -> torch.Tensor:
    """(n_i, 2^n_i / 32) int32: bit l of word w of plane i is bit i of the
    input index 32·w + l."""
    x = torch.arange(1 << n_i, device=device, dtype=torch.int64)
    bits = (x[None] >> torch.arange(n_i, device=device)[:, None]) & 1
    words = (bits.reshape(n_i, -1, 32)
             << torch.arange(32, device=device)).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word, summed over the last dim (int64)."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).sum(-1)


def simulate(nodes: torch.Tensor, outs: torch.Tensor, n_i: int,
             truth: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(output values (G, 2^n_i) int64, set bits of every gate's output
    over the cube (G, n_n) int64) of genomes (G, n_n, 3) / (G, n_o).
    Gate ``f`` outputs bit ``a + 2·b`` of ``truth[f]``."""
    G, n_n, _ = nodes.shape
    dev = nodes.device
    planes = _input_planes(n_i, dev)
    W = planes.shape[1]
    wires = torch.empty((G, n_i + n_n, W), dtype=torch.int32, device=dev)
    wires[:, :n_i] = planes
    rows = torch.arange(G, device=dev)
    tt = truth[nodes[..., 2]]
    pops = torch.empty((G, n_n), dtype=torch.int64, device=dev)
    for k in range(n_n):
        a = wires[rows, nodes[:, k, 0]]
        b = wires[rows, nodes[:, k, 1]]
        t = tt[:, k, None]
        m = [-((t >> j) & 1).to(torch.int32) for j in range(4)]
        out = ((m[0] & ~a & ~b) | (m[1] & a & ~b) | (m[2] & ~a & b)
               | (m[3] & a & b))
        wires[:, n_i + k] = out
        pops[:, k] = _popcount(out)
    values = torch.zeros((G, W * 32), dtype=torch.int64, device=dev)
    lanes = torch.arange(32, device=dev)
    for j in range(outs.shape[1]):
        plane = wires[rows, outs[:, j]].to(torch.int64)          # (G, W)
        bit = (plane[..., None] >> lanes) & 1                    # (G, W, 32)
        values += bit.reshape(G, -1) << j
    return values, pops


def active_gates(nodes: torch.Tensor, outs: torch.Tensor, n_i: int,
                 one_input: torch.Tensor) -> torch.Tensor:
    """(G, n_n) bool: gates an output depends on, by one sweep from the
    last gate back (fan-ins only point backwards)."""
    G, n_n, _ = nodes.shape
    act = torch.zeros((G, n_i + n_n), dtype=torch.bool, device=nodes.device)
    act.scatter_(1, outs, True)
    uses_b = ~one_input[nodes[..., 2]].bool()
    for k in range(n_n - 1, -1, -1):
        on = act[:, n_i + k]
        for src, used in ((nodes[:, k, 0], on), (nodes[:, k, 1],
                                                 on & uses_b[:, k])):
            cur = act.gather(1, src[:, None])[:, 0]
            act.scatter_(1, src[:, None], (cur | used)[:, None])
    return act[:, n_i:]


# ----------------------------- metrics --------------------------------------

def gauss_bounds(sigma: float, n: int, sides: int = 4) -> np.ndarray:
    """Allowed errors per Gauss_σ bin (σ-wide bins over ±sides·σ and two
    tails): the N(0, σ) mass of the bin times n."""
    edges = np.arange(-sides, sides + 1, dtype=np.float64) * sigma
    cdf = np.array([0.5 * (1 + math.erf(e / (sigma * math.sqrt(2))))
                    for e in edges])
    mass = np.concatenate([[cdf[0]], np.diff(cdf), [1 - cdf[-1]]])
    return mass * n, edges


def metrics(values: torch.Tensor, golden: torch.Tensor, n_o: int,
            sigma: float) -> torch.Tensor:
    """(G, 7) float64: MAE, WCE, |AVG| in % of 2^n_o; ER, MRE in %; ACC0
    and GAUSS as 1 where they hold (paper Eq. (1)-(7))."""
    d = golden[None] - values
    ad = d.abs().to(torch.float64)
    n = d.shape[1]
    rng = float(1 << n_o)
    bounds, edges = gauss_bounds(sigma, n)
    e = torch.as_tensor(edges, device=d.device)
    bins = torch.searchsorted(e, d.to(torch.float64).contiguous(),
                              right=True)
    hist = torch.zeros((d.shape[0], len(bounds)), dtype=torch.float64,
                       device=d.device)
    hist.scatter_add_(1, bins, (d != 0).to(torch.float64))
    gauss = (hist <= torch.as_tensor(bounds, device=d.device)).all(1)
    acc0 = ((golden[None] == 0) & (values != 0)).sum(1) == 0
    g1 = golden.clamp(min=1).to(torch.float64)
    return torch.stack([
        100 * ad.mean(1) / rng, 100 * ad.amax(1) / rng,
        100 * (d != 0).to(torch.float64).mean(1), 100 * (ad / g1).mean(1),
        100 * d.to(torch.float64).mean(1).abs() / rng,
        acc0.to(torch.float64), gauss.to(torch.float64)], 1)


def power(pops: torch.Tensor, act: torch.Tensor, funcs: torch.Tensor,
          n: int, energy: torch.Tensor, leak: torch.Tensor) -> torch.Tensor:
    """(G,) float64: Σ over active gates of 2p(1-p)·E_sw + I_leak·1e-3,
    p the gate's probability of a 1 over the cube."""
    p = pops.to(torch.float64) / n
    a = act.to(torch.float64)
    return ((a * 2 * p * (1 - p) * energy[funcs]).sum(1)
            + (a * leak[funcs]).sum(1) * 1e-3)


class Problem:
    """A configuration's circuit problem on a device: its gate constants,
    golden outputs and error metric parameters."""

    def __init__(self, config: dict, device):
        c = config["circuit"]
        self.width = c["width"]
        self.n_i = self.n_o = 2 * self.width
        self.n_n = c["nodes"]
        self.sigma = c["gauss_sigma"]
        g = config["gates"]
        self.codes = {name: i for i, name in enumerate(g["names"])}
        self.n_funcs = len(g["names"])
        dev = torch.device(device)
        self.device = dev
        self.truth = torch.tensor(g["truth_tables"], device=dev)
        self.one_input = torch.tensor(g["one_input"], device=dev)
        self.energy = torch.tensor(g["switch_energy_fj"], dtype=torch.float64,
                                   device=dev)
        self.leak = torch.tensor(g["leakage_nw"], dtype=torch.float64,
                                 device=dev)
        x = torch.arange(1 << self.n_i, device=dev)
        mask = (1 << self.width) - 1
        self.golden = (x & mask) * (x >> self.width)

    def golden_genome(self) -> tuple[np.ndarray, np.ndarray]:
        return array_multiplier(self.width, self.n_n, self.codes)

    def evaluate(self, nodes, outs, block: int = 1024):
        """(metrics (G, 7), power (G,)) float64 of host genomes, in blocks
        of ``block`` genomes."""
        mets, pows = [], []
        for s in range(0, len(nodes), block):
            n = torch.as_tensor(nodes[s:s + block], device=self.device)
            o = torch.as_tensor(outs[s:s + block], device=self.device)
            vals, pops = simulate(n, o, self.n_i, self.truth)
            act = active_gates(n, o, self.n_i, self.one_input)
            mets.append(metrics(vals, self.golden, self.n_o, self.sigma))
            pows.append(power(pops, act, n[..., 2], vals.shape[1],
                              self.energy, self.leak))
        return torch.cat(mets).cpu().numpy(), torch.cat(pows).cpu().numpy()

    def table(self, nodes, outs) -> np.ndarray:
        """(2^w, 2^w) product table [a, b] of one multiplier genome."""
        n = torch.as_tensor(nodes[None], device=self.device)
        o = torch.as_tensor(outs[None], device=self.device)
        vals = simulate(n, o, self.n_i, self.truth)[0][0].cpu().numpy()
        side = 1 << self.width
        return vals.reshape(side, side).T.copy()


# ------------------------- fitness and selection ----------------------------

LOWER_BOUND = np.array([0, 0, 0, 0, 0, 1, 1], bool)   # ACC0, GAUSS: ≥ level


def scale(mets: np.ndarray) -> np.ndarray:
    """Each metric's magnitude: its value, but for |AVG| the MAE, since the
    signed sum it comes from is a difference of sums as large as the
    absolute one."""
    out = np.abs(mets).copy()
    out[..., 4] = np.maximum(out[..., 4], out[..., 0])
    return out


def fitness(mets: np.ndarray, pows: np.ndarray, thr: np.ndarray,
            slack: float = 0.0) -> np.ndarray:
    """Eq. (8)/(9): power where every constraint holds, else +inf.  Each
    magnitude threshold moves by ``slack`` times the larger of itself and
    the metric's ``scale``: a negative slack tightens, a positive one
    loosens."""
    room = slack * np.maximum(np.abs(np.where(np.isfinite(thr), thr, 0)),
                              scale(mets))
    ok = np.where(LOWER_BOUND, mets >= thr, mets <= thr + room).all(-1)
    return np.where(ok, pows, np.inf)
