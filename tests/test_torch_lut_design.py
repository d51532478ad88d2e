"""The design of ``csrc/lut_matmul.cu``, emulated in numpy on the CPU.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it against
its plain version there).  These tests emulate each point of its design
with the kernel's own arithmetic and hold the result against the port's
plain path and the JAX package:

* the plan: every (row, column, k) of a product belongs to exactly one
  block's K slice, every output is stored once (or added once per cluster
  group into a zeroed C), and every instantiation fits 227 KB of shared
  memory with the partial tile inside the slabs and ring;
* the slab: the transposing build (lane l's table-row reads, the byte
  permutes, the padded rows) puts LUT[a_m, b] where the reader's offset
  finds it, and the stores hit distinct banks;
* the packed sums: a word's running sum S and high-half sum H give both
  rows' sums exactly, mod 2^32, however long K is;
* the whole launch: chunks, slabs, K slices added in the cluster's order
  and clusters added atomically, equal ``repro.kernels.ops.lut_matmul``
  (the Pallas kernel in interpret mode) bit for bit;
* the bank model (``chip_smoke.py``'s, which prints it on the card): the
  shipped slab reads take at most 2.9 passes per 32 products on uniform
  bytes, against ~2.8 for one table row a warp and ~4.2 for two table rows
  of 16 shared columns a warp.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro_torch.kernels import lut_matmul as K
from repro_torch.kernels import ops

torch.set_num_threads(1)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()

BK = K.BK
SERVE = [(128, 2048, 2048), (128, 2048, 512), (128, 2048, 8192),
         (128, 8192, 2048), (4, 2048, 2048), (4, 2048, 512), (4, 2048, 8192),
         (4, 8192, 2048)]
RAGGED = [(1, 7, 3), (5, 130, 257), (33, 300, 129), (130, 129, 7),
          (4, 64, 256), (3, 1, 1), (9, 4099, 33), (4, 70, 2049),
          (130, 17, 1100)]
EXACT = (np.arange(256)[:, None] * np.arange(256)[None, :]).astype(np.int64)


def _table():
    rng = np.random.default_rng(3)
    lut = np.clip(EXACT + rng.integers(-300, 301, EXACT.shape), 0, 65535)
    lut[0, 0] = 9
    lut[255, 255] = 65535
    return lut.astype(np.int64)


def prmt(x, y, sel):
    """``__byte_perm(x, y, sel)``: byte i of the result is byte
    ``(sel >> 4i) & 7`` of the 8-byte value y:x."""
    both = (np.asarray(y, np.uint64) << np.uint64(32)) | np.asarray(
        x, np.uint64)
    out = np.zeros(np.shape(both), np.uint64)
    for i in range(4):
        src = np.uint64(8 * ((sel >> (4 * i)) & 7))
        out |= ((both >> src) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def build_slab(table_words, a_col, bm):
    """One k's slab as warp k builds it: lane l reads entries 8l..8l+7 of
    each row a_m (four words), transposes them with byte permutes, and
    stores slab row 8l + j at row 9l + j.  Returns (288, bm // 2) words."""
    lane = np.arange(32)
    v = table_words.reshape(256, 32, 4)[np.asarray(a_col)]   # (bm, lane, 4)
    slab = np.zeros((288, bm // 2), np.uint32)
    for j in range(8):
        sel = 0x7632 if j & 1 else 0x5410
        for q in range(bm // 2):
            slab[9 * lane + j, q] = prmt(v[2 * q, :, j >> 1],
                                         v[2 * q + 1, :, j >> 1], sel)
    return slab


def table_words(lut):
    return np.ascontiguousarray(lut.astype(np.uint16).reshape(-1)).view(
        np.uint32)


def emulate(a, b, lut, p):
    """The kernel's launch under plan ``p`` in numpy: C (uint32 bits) and
    how many times each output was stored or added."""
    M, K_ = a.shape
    N = b.shape[1]
    words = table_words(lut)
    C = np.zeros((M, N), np.uint32)
    touched = np.zeros((M, N), np.int64)
    items = p.n_tiles * p.groups
    for cid in range(p.clusters):
        for item in range(cid, items, p.clusters):
            tile, group = item % p.n_tiles, item // p.n_tiles
            m0, n0 = (tile // p.tiles_n) * p.bm, (tile % p.tiles_n) * p.bn
            parts = []
            for rank in range(p.cs):
                lo, hi = p.slice(group * p.cs + rank)
                kb, kend = lo * BK, min(K_, hi * BK)
                S = np.zeros((p.bn, p.bm // 2), np.uint32)
                H = np.zeros_like(S)
                for k0 in range(kb, kend, BK):
                    sa = np.zeros((p.bm, BK), np.int64)   # zero-filled tiles
                    sb = np.zeros((BK, p.bn), np.int64)
                    rows = a[m0:m0 + p.bm, k0:kend][:, :BK]
                    sa[:rows.shape[0], :rows.shape[1]] = rows
                    cols = b[k0:kend, n0:n0 + p.bn][:BK]
                    sb[:cols.shape[0], :cols.shape[1]] = cols
                    for kk in range(BK):
                        slab = (build_slab(words, sa[:, kk], p.bm)
                                if k0 + kk < kend else
                                np.zeros((288, p.bm // 2), np.uint32))
                        t = sb[kk]
                        x = slab[K.slab_offset(t, p.bm) // (2 * p.bm)]
                        S += x
                        H += x >> np.uint32(16)
                part = np.zeros((p.bm, p.bn), np.uint32)
                part[0::2] = (S - (H << np.uint32(16))).T
                part[1::2] = H.T
                parts.append(part)
            quads = p.bm * p.bn // 4
            for rank in range(p.cs):       # rank r adds slice r in turn
                lo = rank * (quads // p.cs) * 4
                hi = lo + (quads // p.cs) * 4
                s = parts[rank].reshape(-1)[lo:hi].copy()
                for q in range(1, p.cs):
                    s += parts[(rank + q) % p.cs].reshape(-1)[lo:hi]
                e = np.arange(lo, hi)
                m, n = m0 + e // p.bn, n0 + e % p.bn
                ok = (m < M) & (n < N)
                if p.groups > 1:
                    np.add.at(C, (m[ok], n[ok]), s[ok])
                else:
                    C[m[ok], n[ok]] = s[ok]
                np.add.at(touched, (m[ok], n[ok]), 1)
    return C, touched


# --------------------------------------------------------------------------
# The plan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("M,K_,N", SERVE + RAGGED)
@pytest.mark.parametrize("sms,slots", [(132, None), (114, None),
                                       (132, ((1, 132), (2, 66), (4, 32),
                                              (8, 14)))])
def test_plan_covers_every_product_once_and_fits(M, K_, N, sms, slots):
    p = K.plan(M, N, K_, sms, slots)
    fit = dict(slots) if slots else {cs: sms // cs for cs in K.CLUSTERS}
    assert p.cs in K.CLUSTERS and 1 <= p.clusters <= fit[p.cs]
    assert p.grid <= sms and p.bm == (4 if M <= 4 else 8)
    assert p.zero_fill == (p.groups > 1)
    g = K.geometry(p.bm, p.tn)
    assert g.smem <= K.SMEM_LIMIT and g.bn == p.bn
    assert p.bm * p.bn * 4 <= g.smem - K.TABLE_BYTES - 16
    # every (tile, k) owned by exactly one (cluster, item, rank), and no
    # slice is empty
    assert p.chunks == -(-K_ // BK) and p.splits <= p.chunks
    owners = np.zeros((p.n_tiles, K_), np.int64)
    items = p.n_tiles * p.groups
    for cid in range(p.clusters):
        for item in range(cid, items, p.clusters):
            tile, group = item % p.n_tiles, item // p.n_tiles
            for rank in range(p.cs):
                lo, hi = p.slice(group * p.cs + rank)
                assert lo < hi
                owners[tile, lo * BK:min(K_, hi * BK)] += 1
    assert (owners == 1).all()
    assert p.tiles_n * p.bn >= N and -(-M // p.bm) * p.tiles_n == p.n_tiles


@pytest.mark.parametrize("bm", [4, 8])
@pytest.mark.parametrize("tn", K.TNS)
def test_smem_layout_is_the_sum_of_its_parts(bm, tn):
    g = K.geometry(bm, tn)
    assert g.slab_k == 2 * bm * 288 and g.stage % 16 == 0
    assert g.smem == (K.TABLE_BYTES + BK * g.slab_k + g.stages * g.stage
                      + 16)
    assert g.stages in (3, 4)
    assert (g.smem + g.stage > K.SMEM_LIMIT) == (g.stages == 3)


def test_plan_takes_the_least_modelled_time_and_fills_the_card():
    """The plan is the candidate of fewest modelled clocks, every serve
    shape's plan keeps at least two thirds of the SMs busy, and with
    one-block clusters only every K slice adds into C atomically."""
    slots = ((1, 132), (2, 66), (4, 30), (8, 15))
    for M, K_, N in SERVE:
        p = K.plan(M, N, K_, 132, slots)
        best = min(c for c, _ in K.candidates(M, N, K_, 132, slots))
        assert dict((q, c) for c, q in K.candidates(M, N, K_, 132,
                                                     slots))[p] == best
        assert p.grid >= 88, (M, K_, N, p)
    p = K.plan(128, 2048, 2048, 132, ((1, 132),))
    assert p.cs == 1 and p.zero_fill


# --------------------------------------------------------------------------
# The slab and the packed sums
# --------------------------------------------------------------------------

@pytest.mark.parametrize("bm", [4, 8])
def test_slab_rows_hold_the_table_entries(bm):
    lut = _table()
    rng = np.random.default_rng(bm)
    a_col = rng.integers(0, 256, bm)
    a_col[0] = 255
    slab = build_slab(table_words(lut), a_col, bm)
    b = np.arange(256)
    rows = slab[K.slab_offset(b, bm) // (2 * bm)]          # (256, bm / 2)
    got = np.stack([rows & 0xFFFF, rows >> 16], -1).reshape(256, bm)
    assert np.array_equal(got.T, lut[a_col][:, b])
    # the reader skips the padding rows: 256 distinct rows in [0, 288)
    offs = K.slab_offset(b, bm) // (2 * bm)
    assert len(set(offs)) == 256 and offs.max() < 288


def test_preshifted_offsets_read_the_same_entries():
    """The per-lookup variant's offsets: a · 512 + 2 · b bytes into the
    uint16 table is LUT[a, b]."""
    lut = _table()
    flat = np.ascontiguousarray(lut.astype(np.uint16).reshape(-1)).view(
        np.uint8)
    a, b = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    off = a * 512 + 2 * b
    got = flat[off].astype(np.int64) | flat[off + 1].astype(np.int64) << 8
    assert np.array_equal(got, lut)


@pytest.mark.parametrize("bm", [4, 8])
def test_slab_stores_and_reads_are_conflict_free_where_designed(bm):
    lane = np.arange(32)
    stores = np.stack([K.slab_offset(8 * lane + j, bm) for j in range(8)])
    # 2 · bm bytes a lane: the fewest passes 32 lanes can take
    assert (CS.smem_passes(stores, 2 * bm) == bm // 2).all()
    # without the padding row the stores would collide
    bare = np.stack([2 * bm * (8 * lane + j) for j in range(8)])
    assert (CS.smem_passes(bare, 2 * bm) > bm // 2).all()
    # table rows: 32 lanes read 512 contiguous bytes in 4 passes
    assert (CS.smem_passes(np.arange(32)[None] * 16 + 512 * 7, 16) == 4).all()


def test_packed_sums_are_exact_mod_2_32():
    """S = Σ words and H = Σ high halves recover both halves' sums mod
    2^32, also past 2^32 (K up to 2^17 of the largest entries)."""
    rng = np.random.default_rng(0)
    for K_ in (1, 2, 70000, 131072):
        lo = rng.integers(0, 65536, K_, dtype=np.uint64)
        hi = rng.integers(0, 65536, K_, dtype=np.uint64)
        lo[: K_ // 2] = 65535
        w = (lo | hi << np.uint64(16)).astype(np.uint32)
        S = np.add.reduce(w, dtype=np.uint32, keepdims=True)
        H = np.add.reduce(w >> np.uint32(16), dtype=np.uint32, keepdims=True)
        mask = (1 << 32) - 1
        assert int((S - (H << np.uint32(16)))[0]) == int(lo.sum()) & mask
        assert int(H[0]) == int(hi.sum()) & mask


# --------------------------------------------------------------------------
# The whole launch against the JAX package
# --------------------------------------------------------------------------

@pytest.mark.parametrize("M,K_,N,sms", [
    (1, 7, 3, 132), (5, 130, 257, 132), (33, 300, 129, 132),
    (130, 129, 7, 132), (4, 70, 600, 132), (9, 200, 40, 16),
    (6, 64, 1100, 8)])
def test_emulated_launch_equals_the_jax_kernel(M, K_, N, sms):
    lut = _table()
    rng = np.random.default_rng(M + K_ + N)
    a = rng.integers(0, 256, (M, K_), dtype=np.uint8)
    b = rng.integers(0, 256, (K_, N), dtype=np.uint8)
    b[:, 0] = 0                 # some zeros in every chunk
    p = K.plan(M, N, K_, sms)
    got, touched = emulate(a.astype(np.int64), b.astype(np.int64), lut, p)
    assert (touched == p.groups).all()
    want = np.asarray(j_ops.lut_matmul(jnp.asarray(a), jnp.asarray(b),
                                       jnp.asarray(lut.astype(np.int32))))
    assert np.array_equal(got.view(np.int32), want)
    plain = ops.lut_matmul(torch.as_tensor(a), torch.as_tensor(b),
                           torch.as_tensor(lut.astype(np.int32)))
    assert np.array_equal(got.view(np.int32), plain.numpy())


def test_emulated_cluster_split_equals_the_jax_kernel():
    """Clusters of 2, 4 and 8 K slices, one group and several."""
    lut = _table()
    rng = np.random.default_rng(11)
    a = rng.integers(0, 256, (6, 520), dtype=np.uint8)
    b = rng.integers(0, 256, (520, 300), dtype=np.uint8)
    want = np.asarray(j_ops.lut_matmul(jnp.asarray(a), jnp.asarray(b),
                                       jnp.asarray(lut.astype(np.int32))))
    for slots in (((1, 0), (2, 4), (4, 0), (8, 0)),
                  ((1, 0), (2, 0), (4, 2), (8, 0)),
                  ((1, 0), (2, 0), (4, 0), (8, 8))):
        p = K.plan(6, 300, 520, 132, slots)
        assert p.cs == max(cs for cs, n in slots if n)
        got, touched = emulate(a.astype(np.int64), b.astype(np.int64), lut,
                               p)
        assert (touched == p.groups).all()
        assert np.array_equal(got.view(np.int32), want), p


# --------------------------------------------------------------------------
# The bank model
# --------------------------------------------------------------------------

def test_bank_model_counts_passes():
    lane = np.arange(32)
    assert CS.smem_passes(lane * 4, 4) == 1            # one word a bank
    assert CS.smem_passes(np.zeros(32, int), 4) == 1    # broadcast
    assert CS.smem_passes(lane * 128, 4) == 32          # all in bank 0
    assert CS.smem_passes(lane // 2 * 4, 2) == 1        # two entries a word
    assert CS.smem_passes(lane * 16, 16) == 4           # 512 bytes
    assert CS.smem_passes(lane % 2 * 128, 8) == 2       # 2 words, 2 banks


def test_shipped_mapping_takes_fewest_passes_on_uniform_bytes():
    rng = np.random.default_rng(2024)
    n = 2000
    b = rng.integers(0, 256, (n, 32))
    one = CS.gather_passes(np.repeat(rng.integers(0, 256, (n, 1)), 32, 1), b)
    two_rows = np.concatenate([np.repeat(rng.integers(0, 256, (n, 1)), 16, 1),
                               np.repeat(rng.integers(0, 256, (n, 1)), 16,
                                         1)], 1)
    two = CS.gather_passes(two_rows, np.concatenate([b[:, :16], b[:, :16]], 1))
    assert abs(one - 2.79) < 0.05 and abs(two - 4.17) < 0.15
    for M, K_, N in SERVE:
        p = K.plan(M, N, K_, 132)
        rows = rng.integers(0, 256, (64, 32 * p.tn))
        slab = CS.slab_read_passes(rows, p.bm, p.tn)
        assert slab <= 2.9 and slab < one / 2, (M, K_, N, slab)
