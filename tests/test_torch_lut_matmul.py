"""The LUT contraction of the port on the CPU against the JAX package.

``ops.lut_matmul`` on CPU tensors takes the plain version
``ref.lut_matmul_ref``; it must equal JAX's ``ref.lut_matmul_ref`` and JAX's
``ops.lut_matmul`` (the Pallas kernel in interpret mode) bit for bit at
ragged shapes, under the exact table (where it is an int64 matmul), a
random table with ``LUT[0, 0] != 0`` and the table of an evolved genome.
The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds it
against the plain version there); here its wrapper's refusals and its
launch plan are checked.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch.core.evolve import EvolveConfig
from repro_torch.core.fitness import ConstraintSpec
from repro_torch.core.library import multiplier_lut
from repro_torch.core.search import SearchConfig, run_search
from repro_torch.kernels import lut_matmul as K
from repro_torch.kernels import ops, ref

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

SHAPES = [(1, 7, 3), (5, 130, 257), (33, 300, 129), (4, 64, 256)]  # (M, K, N)
EXACT = (np.arange(256)[:, None] * np.arange(256)[None, :]).astype(np.int32)


def _random_table():
    rng = np.random.default_rng(7)
    lut = np.clip(EXACT + rng.integers(-300, 301, EXACT.shape), 0, 65535)
    lut[0, 0] = 9                 # a padded k would add 9 to every output
    return lut.astype(np.int32)


def _evolved_table():
    """The table of an 8×8 multiplier evolved for a few generations under
    an error-rate constraint (the port's sweep path, on the CPU)."""
    cfg = SearchConfig(width=8, kind="mul", n_n=400,
                       evolve=EvolveConfig(generations=12, lam=2,
                                           mutation_rate=0.02))
    rec, _ = run_search(cfg, ConstraintSpec(er=99.0), seed=3, device="cpu")
    from repro_torch.core.genome import CGPSpec, Genome
    lut = multiplier_lut(Genome(torch.as_tensor(rec.genome_nodes),
                                torch.as_tensor(rec.genome_outs)),
                         CGPSpec(16, 16, 400))
    assert not np.array_equal(lut, EXACT)
    return lut


@pytest.fixture(scope="module")
def tables():
    return {"exact": EXACT, "random": _random_table(),
            "evolved": _evolved_table()}


def _operands(M, K, N, seed=0):
    rng = np.random.default_rng(seed + M * 7 + K)
    return (rng.integers(0, 256, (M, K), dtype=np.uint8),
            rng.integers(0, 256, (K, N), dtype=np.uint8))


@pytest.mark.parametrize("name", ["exact", "random", "evolved"])
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_plain_matches_jax_ref_and_kernel(tables, name, M, K, N):
    lut = tables[name]
    a, b = _operands(M, K, N)
    got = ops.lut_matmul(torch.as_tensor(a), torch.as_tensor(b),
                         torch.as_tensor(lut))
    assert got.dtype == torch.int32 and got.shape == (M, N)
    got = got.numpy()
    want_ref = np.asarray(j_ref.lut_matmul_ref(jnp.asarray(a), jnp.asarray(b),
                                               jnp.asarray(lut)))
    want_kernel = np.asarray(j_ops.lut_matmul(jnp.asarray(a), jnp.asarray(b),
                                              jnp.asarray(lut)))
    assert np.array_equal(got, want_ref)
    assert np.array_equal(got, want_kernel)
    oracle = lut.astype(np.int64)[a.astype(np.int64)[:, :, None],
                                  b.astype(np.int64)[None]].sum(axis=1)
    assert np.array_equal(got, oracle)
    if name == "exact":
        assert np.array_equal(got, a.astype(np.int64) @ b.astype(np.int64))


def test_chunked_rows_and_wide_operands(monkeypatch, tables):
    """Chunking over M does not change the sum; int32 operands in range are
    the same as uint8 ones."""
    a, b = _operands(9, 40, 30)
    lut = torch.as_tensor(tables["random"])
    whole = ref.lut_matmul_ref(torch.as_tensor(a), torch.as_tensor(b), lut)
    monkeypatch.setattr(ref, "REF_CHUNK_ELEMS", 40 * 30 * 2)  # 2-row chunks
    chunked = ref.lut_matmul_ref(torch.as_tensor(a), torch.as_tensor(b), lut)
    wide = ops.lut_matmul(torch.as_tensor(a, dtype=torch.int32),
                          torch.as_tensor(b, dtype=torch.int32), lut)
    assert torch.equal(whole, chunked) and torch.equal(whole, wide)


def test_kernel_wrapper_refusals(tables):
    a, b = (torch.as_tensor(x) for x in _operands(4, 16, 8))
    table = K.stage_table(torch.as_tensor(tables["random"]))
    assert table.dtype == torch.int16 and table.shape == (65536,)
    assert int(table[1 * 256 + 255]) & 0xFFFF == int(tables["random"][1, 255])
    with pytest.raises(ValueError, match="no lut_matmul kernel"):
        K.lut_matmul(a, b, table)                       # CPU tensors
    with pytest.raises(TypeError, match="must be torch.uint8"):
        K.lut_matmul(a.to(torch.int32), b, table)
    with pytest.raises(TypeError, match="must be torch.int16"):
        K.lut_matmul(a, b, table.to(torch.int32))
    with pytest.raises(ValueError, match="contraction mismatch"):
        K.lut_matmul(a, b[:5], table)
    for bad in (-1, 65536):
        lut = torch.as_tensor(tables["exact"]).clone()
        lut[3, 4] = bad
        with pytest.raises(ValueError, match="uint16 range"):
            K.stage_table(lut)
    with pytest.raises(TypeError, match="integer table"):
        K.stage_table(torch.zeros((256, 256)))
    for bad in (torch.full((2, 2), 256), torch.full((2, 2), -1),
                torch.zeros((2, 2))):
        with pytest.raises(ValueError, match=r"\[0, 255\]"):
            ops._as_u8(bad, "a")


@pytest.mark.parametrize("M,K_,N", SHAPES + [
    (128, 2048, 2048), (128, 2048, 512), (128, 2048, 8192),
    (128, 8192, 2048), (4, 2048, 2048), (4, 2048, 512), (4, 2048, 8192),
    (4, 8192, 2048)])
def test_launch_plan_covers_the_product(M, K_, N):
    """Every (row tile, column tile, k) is owned by exactly one item, and
    the grid never exceeds the SM count."""
    p = K.plan(M, N, K_, 132)
    bm, bn = p.bm, p.bn
    assert p.tiles_n * bn >= N and p.n_tiles * bm * bn >= M * N
    assert 1 <= p.grid <= 132 and p.grid <= p.n_tiles * p.splits
    spans = [p.slice(s) for s in range(p.splits)]
    assert spans[0][0] == 0 and (spans[-1][1] - 1) * K.BK < K_
    assert K_ <= spans[-1][1] * K.BK
    assert all(lo < hi for lo, hi in spans)
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert p.bm == (4 if M <= 4 else 8)
