"""The design of ``csrc/cgp_sim.cu``, emulated in numpy on the CPU.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it against
its plain version there).  These tests emulate each point of its design
with the kernel's own arithmetic and hold the result against the port's
plain path and the JAX package:

* staging: the gates' topological levels computed 32 at a time as the
  staging warp does (a fixed point over lanes), the counting sort by level
  in any order within a level, and the batch sizes of the entries;
* the walk: per batch every load (ghost gates past the batch's end
  included) before any store; it gives the index-order walk's (the JAX
  package's simulation) wire plane and per-gate popcounts for golden,
  mutated and random legal genomes;
* the lane masks staged per gate equal the gate set's truth tables;
* the unpack by a 32 x 32 register bit transpose equals the plain path's
  per-bit unpack;
* the metrics per thread over its own word, the histogram's d = 0 counted
  apart, the float rows summed per (genome, tile) in the kernel's order:
  the decoded partials equal the JAX reference's (integers exactly, float
  rows within rtol 1e-6);
* the sizing rule: every run covers the cube and fits 227 KB of shared
  memory, and the rule's grid costs no more than any other run's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gates as JGATES
from repro.core import golden as JG
from repro.core import metrics as JM
from repro.core import simulate as JS
from repro.core.genome import Genome as JGenome
from repro_torch.core import gates
from repro_torch.core import metrics as M
from repro_torch.core import simulate
from repro_torch.kernels import cgp_sim, ops

torch.set_num_threads(1)

TILE, BATCH = cgp_sim.TILE, cgp_sim.BATCH
RTOL = 1e-6


# --------------------------------------------------------------------------
# The kernel's steps in numpy
# --------------------------------------------------------------------------

def _clamped(nodes, n_i):
    n_n = len(nodes)
    hi = n_i + np.arange(n_n) - 1
    return (np.clip(nodes[:, 0], 0, hi), np.clip(nodes[:, 1], 0, hi),
            nodes[:, 2] & 7)


def stage_levels(nodes, n_i):
    """Every row's level as the staging warp computes it: 32 gates at a
    time, levels before the chunk read from memory, the chunk's own
    iterated to a fixed point over "shuffles"; BUF and INV ignore b."""
    a, b, f = _clamped(nodes, n_i)
    n_n = len(nodes)
    lvl = np.zeros(n_i + n_n, np.int64)
    lane = np.arange(32)
    for k0 in range(0, n_n, 32):
        k = k0 + lane
        ok = k < n_n
        kk = np.minimum(k, n_n - 1)
        aa, bb, two = a[kk], b[kk], f[kk] > 1
        row0 = n_i + k0
        la = np.where(aa < row0, lvl[np.minimum(aa, row0 - 1)], 0)
        ia = np.where(aa < row0, -1, aa - row0)
        lb = np.where(two & (bb < row0), lvl[np.minimum(bb, row0 - 1)], 0)
        ib = np.where(two & (bb >= row0), bb - row0, -1)
        my = np.where(ok, np.maximum(la, lb) + 1, 0)
        while True:
            xa, xb = my[ia & 31], my[ib & 31]
            nm = np.where(ok, np.maximum(np.maximum(la, np.where(ia >= 0, xa, 0)),
                                         np.maximum(lb, np.where(ib >= 0, xb, 0))) + 1, 0)
            if np.array_equal(nm, my):
                break
            my = nm
        lvl[row0 + lane[ok]] = my[ok]
    return lvl


def true_levels(nodes, n_i):
    a, b, f = _clamped(nodes, n_i)
    lvl = np.zeros(n_i + len(nodes), np.int64)
    for k in range(len(nodes)):
        lvl[n_i + k] = 1 + max(lvl[a[k]], lvl[b[k]] if f[k] > 1 else 0)
    return lvl


def stage_entries(nodes, n_i, rng):
    """The entries in level order (within a level in the order ``rng``
    picks, as the kernel's atomics may): dict of arrays padded with BATCH
    entries reading row 0, and ``n`` the batch size at each batch's first
    entry (0 elsewhere)."""
    a, b, f = _clamped(nodes, n_i)
    n_n = len(nodes)
    L = stage_levels(nodes, n_i)[n_i:]
    cnt = np.bincount(L, minlength=n_n + 2)
    start = np.concatenate([[0], np.cumsum(cnt)])
    order = np.lexsort((rng.permutation(n_n), L))   # by level, any order
    pos = np.empty(n_n, np.int64)
    pos[order] = np.arange(n_n)
    s, e = start[L], start[L + 1]
    n = np.where((pos - s) % BATCH == 0, np.minimum(BATCH, e - pos), 0)
    pad = lambda x, fill=0: np.concatenate([x[order], np.full(
        (BATCH,) + x.shape[1:], fill, x.dtype)])
    return dict(a=pad(a), b=pad(b), gate=pad(np.arange(n_n)),
                n=pad(n[np.arange(n_n)]), masks=pad(mask_word(f, n)),
                level=pad(L))


def mask_word(f, n=0):
    """The staged word of gate function f: bit 7 of byte k is bit k of its
    truth table (from the packed tables the kernel is given), byte 0's low
    bits the batch size n."""
    tt = (gates.TT_PACKED >> (4 * np.asarray(f, np.int64))) & 0xF
    return sum(((tt >> k) & 1) << (8 * k + 7) for k in range(4)) | n


def sign_bytes(x, sel):
    """PTX ``prmt.b32 x, 0, sel`` for selectors 8-11 (bytes 0-3 of x, sign
    replicated): each result byte 0xFF where the selected byte's top bit
    is set."""
    x = np.asarray(x, np.int64) & 0xFFFFFFFF
    out = sum(((x >> (8 * ((sel >> (4 * i)) & 3) + 7)) & 1) * (0xFF << (8 * i))
              for i in range(4))
    return np.asarray(out, np.int64).astype(np.uint32).view(np.int32)


def gate_out(a, b, word):
    """``gate_out`` of the CUDA source: tt[a + 2b] per lane, the four lane
    masks replicated from the word's byte sign bits."""
    m0, m1, m2, m3 = (sign_bytes(word, 0x8888 + k * 0x1111)[..., None]
                      for k in range(4))
    x1 = (b & m3) | (~b & m1)
    x0 = (b & m2) | (~b & m0)
    return (a & x1) | (~a & x0)


def popcount(x):
    x = x.astype(np.uint32)
    return np.array([bin(v).count("1") for v in x.ravel()],
                    np.int64).reshape(x.shape)


def walk_level_order(ent, planes, n_n, valid):
    """The batched walk over every word of the cube at once: (wire plane
    (n_wires, W) int32, per-gate popcounts)."""
    W = planes.shape[1]
    n_i = planes.shape[0]
    wires = np.zeros((n_i + n_n, W), np.int32)
    wires[:n_i] = planes
    pops = np.zeros(n_n, np.int64)
    i = 0
    while i < n_n:
        n = int(ent["masks"][i] & 0x7F)     # the batch size, from the word
        assert 1 <= n <= BATCH and n == ent["n"][i]
        idx = np.arange(i, i + BATCH)
        # every load of the batch (ghost gates past n included) first
        av, bv = wires[ent["a"][idx]], wires[ent["b"][idx]]
        assert (ent["level"][idx[:n]] == ent["level"][i]).all()
        outs = gate_out(av, bv, ent["masks"][idx])
        for j in range(n):
            k = ent["gate"][i + j]
            wires[n_i + k] = outs[j]
            pops[k] += popcount(outs[j] & valid).sum()
        i += n
    return wires, pops


def transpose32(x):
    """The register transpose of the CUDA source over (32, ...) uint32
    rows: afterwards x[i] bit k = x[k] bit i before."""
    x = x.astype(np.uint32).copy()
    j, m = 16, np.uint32(0x0000FFFF)
    while j:
        for k in range(32):
            if k & j == 0:
                t = ((x[k] >> np.uint32(j)) ^ x[k + j]) & m
                x[k] ^= t << np.uint32(j)
                x[k + j] ^= t
        j >>= 1
        m ^= m << np.uint32(j)
    return x


def warp_tree(v):
    """__shfl_down_sync's sum over 32 lanes (lane 0's result), in order."""
    v = list(v)
    for off in (16, 8, 4, 2, 1):
        v = [v[t] + v[t + off] if t + off < 32 else v[t]
             for t in range(32)]
    return v[0]


def kernel_raw(nodes, outs, planes, gvals, sigma, n_o, seed=0):
    """``RawSums`` of one genome as the kernel computes them: the staged
    walk, the transpose unpack, per-thread metrics over whole 32-word
    tiles (a word past the cube's end reads outputs 0 against golden
    values 0, so d = 0) with d = 0 counted apart, float rows per (tile,
    thread) in input order, a warp tree per tile, tiles summed in order."""
    n_i, W = planes.shape
    n_n = len(nodes)
    rng = np.random.default_rng(seed)
    ent = stage_entries(nodes, n_i, rng)
    valid = np.full(W, -1, np.int32)
    wires, pops = walk_level_order(ent, planes, n_n, valid)
    Wp = -(-W // TILE) * TILE                            # whole tiles
    souts = np.clip(outs, 0, n_i + n_n - 1)
    o = np.zeros((32, Wp), np.uint32)
    o[:n_o, :W] = wires[souts].astype(np.uint32)
    vals = transpose32(o).astype(np.int64)              # (32 lanes, Wp)
    g = np.zeros((32, Wp), np.int64)
    g[:, :W] = gvals.reshape(W, 32).T
    d = g - vals
    ad = np.abs(d)
    per_bit = M.exact_sum_per_bit(32 * W, n_o)
    if per_bit:
        mags = (ad, np.maximum(d, 0), np.maximum(-d, 0))
        mag = np.stack([[((x >> b) & 1).sum() for b in range(n_o)]
                        for x in mags])
    else:
        s_abs, s_pos = ad.sum(), np.maximum(d, 0).sum()
        mag = np.array([[s_abs], [s_pos], [s_abs - s_pos]])
    err = int((d != 0).sum())
    edges = (np.arange(-4, 5, dtype=np.float64) * sigma).astype(np.float32)
    df = d.astype(np.float32)
    raw_ge = np.array([(e <= df).sum() for e in edges])
    zeros = 32 * Wp - err                      # padded words included
    ge = raw_ge - np.where(edges <= 0, zeros, 0)         # d = 0 apart
    hist = np.concatenate([[err - ge[0]], ge[:-1] - ge[1:], [ge[-1]]])
    ints = np.concatenate([[err, int(((g == 0) & (vals != 0)).sum())], hist])
    adf = ad.astype(np.float32)
    relf = (adf / np.maximum(g, 1).astype(np.float32)).astype(np.float32)
    elems = (relf, adf * adf, relf * relf)
    fs = np.zeros(3)
    for tile in range(Wp // TILE):
        for q, el in enumerate(elems):
            per_thread = []
            for t in range(TILE):
                acc = 0.0
                for i in range(32):
                    acc += float(el[i, tile * TILE + t])
                per_thread.append(acc)
            fs[q] += warp_tree(per_thread)
    return cgp_sim.RawSums(
        torch.as_tensor(mag[None]), torch.as_tensor(ints[None], dtype=torch.int32),
        torch.as_tensor([int(ad.max())], dtype=torch.int32),
        torch.as_tensor(pops[None], dtype=torch.int32),
        torch.as_tensor(fs[None]))


# --------------------------------------------------------------------------
# Genomes
# --------------------------------------------------------------------------

def _genome(width, kind, which, seed=0):
    build = JG.array_multiplier if kind == "mul" else JG.ripple_carry_adder
    jg, jspec = build(width)
    nodes = np.asarray(jg.nodes).astype(np.int64)
    outs = np.asarray(jg.outs).astype(np.int64)
    rng = np.random.default_rng([seed, width])
    hi = jspec.n_i + np.arange(jspec.n_n)
    rand = np.stack([rng.integers(0, hi), rng.integers(0, hi),
                     rng.integers(0, 8, jspec.n_n)], -1)
    if which == "mutated":
        nodes = np.where(rng.random(nodes.shape) < 0.03, rand, nodes)
    elif which == "random":
        nodes = rand
        outs = rng.integers(0, jspec.n_wires, jspec.n_o)
    planes = JS.input_planes_np(jspec.n_i)
    return jspec, nodes, outs, planes, JG.golden_values(width, kind)


GENOMES = [(w, k, which) for w in range(2, 9) for k in ("mul", "add")
           for which in ("golden", "mutated", "random")
           if (k == "mul" or w in (2, 5, 8))]


@pytest.mark.parametrize("width,kind,which", GENOMES)
def test_level_ordered_walk_equals_index_order(width, kind, which):
    jspec, nodes, outs, planes, _ = _genome(width, kind, which)
    assert np.array_equal(stage_levels(nodes, jspec.n_i),
                          true_levels(nodes, jspec.n_i))
    W = planes.shape[1]
    want = np.asarray(JS.simulate_planes(   # the index-order walk
        JGenome(jnp.asarray(nodes, jnp.int32), jnp.asarray(outs, jnp.int32)),
        jspec, jnp.asarray(planes)))
    for seed in (0, 1):      # two orders within the levels
        ent = stage_entries(nodes, jspec.n_i, np.random.default_rng(seed))
        got, pops = walk_level_order(ent, planes, jspec.n_n,
                                     np.full(W, -1, np.int32))
        assert np.array_equal(got, want)
        assert np.array_equal(pops, popcount(want[jspec.n_i:]).sum(-1))


def test_batches_fill_the_levels():
    """Batches stay inside one level and are full but for each level's
    last; the golden 8x8 multiplier walks its 400 gates in few batches."""
    jspec, nodes, _, _, _ = _genome(8, "mul", "golden")
    ent = stage_entries(nodes, jspec.n_i, np.random.default_rng(0))
    n = ent["n"][:jspec.n_n]
    starts = np.flatnonzero(n)
    assert n.sum() == jspec.n_n and starts[0] == 0
    assert np.array_equal(starts[1:], np.cumsum(n[starts])[:-1])
    levels = ent["level"][:jspec.n_n]
    n_levels = len(np.unique(levels))
    assert len(starts) <= jspec.n_n // BATCH + n_levels
    assert len(starts) < jspec.n_n / 2      # batching pays at width 8


@pytest.mark.parametrize("func", range(gates.N_FUNCS))
def test_staged_lane_masks_are_the_truth_tables(func):
    tt = (gates.TT_PACKED >> (4 * func)) & 0xF
    assert tt == int(gates.TRUTH_TABLES[func]) == int(JGATES.TRUTH_TABLES[func])
    for n in (0, 1, BATCH):   # the batch size leaves the masks alone
        word = mask_word([func], n)
        for k in range(4):   # each byte permute gives the 0 / ~0 lane mask
            assert int(sign_bytes(word, 0x8888 + k * 0x1111)[0]) == \
                -((tt >> k) & 1)
    a = np.array([0b0101 * 0x11111111 & 0x7FFFFFFF], np.int32)
    b = np.array([0b0011 * 0x11111111 & 0x7FFFFFFF], np.int32)
    out = gate_out(a[None], b[None], word)[0, 0]
    for lane in range(31):
        k = ((int(a[0]) >> lane) & 1) + 2 * ((int(b[0]) >> lane) & 1)
        assert (int(out) >> lane) & 1 == (tt >> k) & 1


@pytest.mark.parametrize("n_o", range(1, 31))
def test_transpose_unpack_equals_per_bit_unpack(n_o):
    rng = np.random.default_rng(n_o)
    W = 8
    words = rng.integers(0, 1 << 32, (n_o, W), dtype=np.uint64).astype(np.uint32)
    x = np.zeros((32, W), np.uint32)
    x[:n_o] = words
    got = transpose32(x)
    # the plain path's per-bit unpack: input 32w + i is lane i of word w
    want = simulate.unpack_values(torch.as_tensor(words.view(np.int32)))
    assert np.array_equal(got.T.reshape(-1), want.numpy().astype(np.uint32))


@pytest.mark.parametrize("width,kind,which,sigma", [
    (2, "mul", "random", 256.0), (3, "mul", "mutated", 3.7),
    (4, "add", "mutated", 256.0), (5, "mul", "random", 3.7),
    (6, "mul", "golden", 256.0), (6, "mul", "mutated", 2.0),
    (9, "add", "mutated", 256.0)])
def test_kernel_emulation_matches_jax(width, kind, which, sigma):
    jspec, nodes, outs, planes, gvals = _genome(width, kind, which)
    raw = kernel_raw(nodes, outs, planes, gvals, sigma, jspec.n_o)
    got = ops._partials_from_raw(raw, planes.shape[1], jspec.n_o)
    g = JGenome(jnp.asarray(nodes, jnp.int32), jnp.asarray(outs, jnp.int32))
    wires = JS.simulate_planes(g, jspec, jnp.asarray(planes))
    vals = JS.unpack_values(wires[g.outs])
    want = JM.error_partials(jnp.asarray(gvals), vals, sigma,
                             n_bits=jspec.n_o)
    for name in M.MetricPartials._fields:
        a = getattr(got, name).numpy()[0]
        b = np.asarray(getattr(want, name))
        if name in ("rel_sum", "sq_sum", "rel_sq"):
            np.testing.assert_allclose(a, b, rtol=RTOL, err_msg=name)
        else:
            assert np.array_equal(a, b), (name, a, b)
    pops = jax.lax.population_count(
        wires[jspec.n_i:].view(jnp.uint32)).sum(-1)
    assert np.array_equal(raw.pops.numpy()[0], np.asarray(pops))


# --------------------------------------------------------------------------
# The sizing rule
# --------------------------------------------------------------------------

SHAPES = [(256, 2048, 16, 400, 16), (1, 2048, 16, 400, 16),
          (7, 2048, 16, 400, 16), (256, 1024, 16, 400, 16),
          (256, 512, 16, 400, 16), (7, 32768, 20, 600, 20),
          (256, 32768, 20, 600, 20), (8, 2, 6, 60, 6), (7, 8, 8, 120, 8),
          (7, 1, 4, 400, 4)]


@pytest.mark.parametrize("R,W,n_i,n_n,n_o", SHAPES)
@pytest.mark.parametrize("sms", [132, 114])
def test_runs_cover_the_cube_and_fit(R, W, n_i, n_n, n_o, sms):
    n_tiles = -(-W // TILE)
    for layout in cgp_sim.LAYOUTS:
        tiles = cgp_sim.run_tiles(layout, None, R, W, n_i, n_n, n_o, sms)
        assert 1 <= tiles <= n_tiles
        assert -(-n_tiles // tiles) * tiles >= n_tiles
        run = tiles if layout == "cube_major" else None
        assert cgp_sim.smem_bytes(n_i, n_n, n_o, run) <= \
            cgp_sim.MAX_SMEM_BYTES
        assert 1 <= cgp_sim.block_warps(n_i, n_n, n_o, run) <= \
            cgp_sim.MAX_WARPS
    tiles, r_tile = cgp_sim.cube_defaults(R, W, n_i, n_n, n_o, sms)
    assert 1 <= r_tile <= R


@pytest.mark.parametrize("R,W,n_i,n_n,n_o", SHAPES[:5])
def test_the_rule_costs_least_in_whole_waves(R, W, n_i, n_n, n_o):
    n_tiles = -(-W // TILE)
    warps = cgp_sim.block_warps(n_i, n_n, n_o)
    per_sm = cgp_sim.blocks_by_smem(cgp_sim.smem_bytes(n_i, n_n, n_o))
    slots = per_sm * 132
    tiles = cgp_sim.run_tiles("genome_major", None, R, W, n_i, n_n, n_o, 132)
    cost = cgp_sim.wave_cost(R, n_tiles, tiles, warps, slots)[0]
    for t in range(1, n_tiles + 1):
        assert cost <= cgp_sim.wave_cost(R, n_tiles, t, warps, slots)[0]
    # the main path: 4 warps of 4 planes, one 64-tile run a genome, 256
    # blocks in 2 whole waves of 132
    if (R, W, n_n) == (256, 2048, 400):
        assert (warps, tiles, per_sm) == (4, 64, 1)
        assert cgp_sim.smem_bytes(n_i, n_n, n_o) == \
            16 * (n_n + BATCH) + 4 * (n_n + n_o) + 4 * 4 * TILE * (n_i + n_n)


def test_smem_layout_is_the_sum_of_its_parts():
    n_i, n_n, n_o = 16, 400, 16
    genome = 16 * (n_n + BATCH) + 4 * 400 + 4 * 16
    plane = 4 * TILE * (n_i + n_n)
    assert cgp_sim.smem_bytes(n_i, n_n, n_o) == genome + 4 * plane
    run = 4 * (n_i + 32) * 8 * TILE
    assert cgp_sim.block_warps(n_i, n_n, n_o, 8) == 3
    assert cgp_sim.smem_bytes(n_i, n_n, n_o, 8) == genome + 3 * plane + run
    # a plane that does not fit leaves no warp, and the sum says so
    assert cgp_sim.block_warps(40, 2000, 40) == 0
    assert cgp_sim.smem_bytes(40, 2000, 40) > cgp_sim.MAX_SMEM_BYTES
