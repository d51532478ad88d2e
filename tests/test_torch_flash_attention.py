"""``repro_torch.kernels.ops.flash_attention`` on the CPU against the JAX
package's flash-attention kernel (interpret mode) and its naive oracle.

Inputs are drawn with numpy and handed to both packages.  Float32 outputs
agree within RTOL / ATOL (float32 reductions in another order); bfloat16
outputs within one bfloat16 ulp beyond that float32 tolerance (two float32
values that close, rounded on either side of a rounding boundary; near
zero the float32 ATOL is larger than a bfloat16 ulp).  The CUDA kernel
itself runs only on the card, where ``chip_smoke.py`` holds it against the
same plain version.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch.kernels import ops, ref

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
B, HQ, D = 1, 4, 16


def _inputs(group, S, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, HQ, S, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, HQ // group, S, D)).astype(np.float32)
            for _ in range(2))
    return q, k, v


def _bf16_ulp(x):
    """One bfloat16 ulp at |x| (8 significant bits), exactly."""
    mag = np.maximum(np.abs(x).astype(np.float32),
                     np.finfo(np.float32).tiny)
    return (mag.view(np.int32) & 0x7F800000).view(np.float32) * 2.0 ** -7


def _assert_close(got, want, dtype, what, atol=ATOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol,
                                   err_msg=what)
    else:
        tol = atol + RTOL * np.abs(want) + _bf16_ulp(
            np.maximum(np.abs(got), np.abs(want)))
        assert (np.abs(got - want) <= tol).all(), what


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [8, 32, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 4])
def test_flash_attention_matches_jax(group, causal, S, dtype):
    q, k, v = _inputs(group, S)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    if dtype == "bfloat16":   # both packages get the same rounded inputs
        q, k, v = (x.astype(ml_dtypes.bfloat16).astype(np.float32)
                   for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    want = j_ops.flash_attention(jq, jk, jv, causal=causal, interpret=True)
    got = ops.flash_attention(*(torch.as_tensor(x).to(tdt)
                                for x in (q, k, v)), causal)
    assert got.dtype == tdt and got.shape == (B, HQ, S, D)
    got = got.to(torch.float32).numpy()
    _assert_close(got, want, dtype, "vs the JAX kernel")
    # and against the JAX oracle on the folded heads
    fold = lambda x: jnp.repeat(x, group, axis=1).reshape(B * HQ, S, D)
    oracle = j_ref.attention_ref(jq.reshape(B * HQ, S, D), fold(jk),
                                 fold(jv), causal=causal)
    _assert_close(got, np.asarray(oracle, np.float32).reshape(got.shape),
                  dtype, "vs the JAX oracle")


@pytest.mark.parametrize("rows", [1, 5, 64])
def test_chunked_plain_version_is_the_naive_function(rows, monkeypatch):
    q, k, v = (torch.as_tensor(x).reshape(B * HQ, 64, D)
               for x in _inputs(1, 64, 1))
    for causal in (True, False):
        whole = ref.attention_ref(q, k, v, causal)
        # passes of `rows` query rows
        monkeypatch.setattr(ref, "ATTN_CHUNK_ELEMS", rows * B * HQ * 64)
        part = ref.attention_ref(q, k, v, causal)
        monkeypatch.undo()
        np.testing.assert_allclose(part.numpy(), whole.numpy(), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("S", [130, 200, 384 + 64])
def test_raises_where_the_reference_asserts(S):
    q, k, v = _inputs(2, S)
    with pytest.raises(AssertionError):
        j_ops.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                              interpret=True)
    with pytest.raises(ValueError, match="multiple of"):
        ops.flash_attention(*(torch.as_tensor(x) for x in (q, k, v)))


def test_bad_shapes_raise():
    q, k, v = (torch.as_tensor(x) for x in _inputs(1, 32))
    with pytest.raises(ValueError):
        ops.flash_attention(q, k[:, :3], v[:, :3])      # 3 kv-heads for 4
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v[..., :8])           # k, v differ
    with pytest.raises(ValueError):
        ops.flash_attention(q[0], k[0], v[0])           # not 4-D



# --------------------------------------------------------------------------
# The tensor-core body's arithmetic, emulated on the CPU, and its plan
# --------------------------------------------------------------------------

from repro.kernels import flash_attention as j_fa  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402

# chip_smoke.py phase 9's bf16 shapes with the body's head dims (D = 8
# takes the CUDA-core body), S cut to <= 512; (B, Hq, Hkv, S, D), causal
TC_SHAPES = [((4, 32, 8, 32, 64), True), ((1, 32, 8, 512, 64), True),
             ((2, 8, 2, 256, 64), False), ((2, 8, 2, 256, 64), True),
             ((1, 4, 4, 96, 16), True), ((1, 4, 1, 128, 32), False),
             ((1, 4, 2, 512, 128), True)]
HI16 = -65536                # 0xffff0000 as an int32 mask


def _top16(x):
    """float32 -> the bf16 of its top 16 bits (rounded toward zero)."""
    return (x.view(torch.int32) & HI16).view(torch.float32)


def _split3(p):
    """p = hi + mid + lo, each the top 8 significant bits of what is left."""
    hi = _top16(p)
    r = p - hi
    mid = _top16(r)
    return hi, mid, _top16(r - mid)


def _tc_body_emulation(q, k, v, causal, terms=3, scale_dim=None):
    """The tensor-core body's numerics in plain PyTorch: raw scores QKᵀ of
    the bf16 inputs accumulated exactly and rounded to float32; per 64-row
    kv tile a float32 online softmax in base 2, p = 2^fma(s, c, −m·c) with
    c = log2(e)/sqrt(D) in float32 and m the running max of the raw
    scores; P·V with ``terms`` bf16 terms of P (3: the body's exact split;
    1 or 2: rounded to nearest, for comparison), each product exact and
    the tile's sum rounded to float32 into a fresh accumulator, folded in
    as acc·alpha + pv with one FMA; the output acc / max(l, 1e-30) in
    float32, then bf16.  ``scale_dim``: the head dim of the scale (default
    D; the true D where the columns past it are zero padding)."""
    B, Hq, S, D = q.shape
    g = Hq // k.shape[1]
    k = k.repeat_interleave(g, dim=1).to(torch.float64)
    v = v.repeat_interleave(g, dim=1).to(torch.float64)
    q = q.to(torch.float64)
    Skv = k.shape[2]
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    c = f32(1.0 / (scale_dim or D) ** 0.5) * f32(1.4426950408889634)
    fma = lambda a, b, d: (a.double() * b.double() + d.double()).float()
    m = torch.full((B, Hq, S, 1), -1e30, dtype=torch.float32)
    l = torch.zeros((B, Hq, S, 1), dtype=torch.float32)
    acc = torch.zeros((B, Hq, S, D), dtype=torch.float32)
    qp = torch.arange(S)[:, None]
    for k0 in range(0, Skv, FA.TC_BLOCK_KV):
        kt, vt = k[:, :, k0:k0 + 64], v[:, :, k0:k0 + 64]
        s = (q @ kt.transpose(-1, -2)).to(torch.float32)
        if causal:
            s = torch.where(qp >= torch.arange(k0, k0 + kt.shape[2]), s,
                            f32(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * c)
        p = torch.exp2(fma(s, c, -(m_new * c)))
        l = l * alpha + p.sum(-1, keepdim=True)
        m = m_new
        if terms == 3:
            parts = _split3(p)
        else:
            hi = p.to(torch.bfloat16).to(torch.float32)
            parts = (hi, (p - hi).to(torch.bfloat16).to(torch.float32))
            parts = parts[:terms]
        pv = sum(t.to(torch.float64) @ vt for t in parts).to(torch.float32)
        acc = fma(acc, alpha, pv)
    return (acc / torch.clamp(l, min=1e-30)).to(torch.bfloat16)


def _tc_inputs(shape, seed):
    B, Hq, Hkv, S, D = shape
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, h, S, D)).astype(ml_dtypes.bfloat16)
                 .astype(np.float32) for h in (Hq, Hkv, Hkv))


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
@pytest.mark.parametrize("shape,causal", TC_SHAPES)
def test_tensor_core_arithmetic_within_the_bf16_tolerance(shape, causal,
                                                          seed):
    q, k, v = _tc_inputs(shape, seed)
    tq, tk, tv = (torch.as_tensor(x).to(torch.bfloat16) for x in (q, k, v))
    got = _tc_body_emulation(tq, tk, tv, causal).to(torch.float32).numpy()
    want = ref.flash_attention_ref(tq, tk, tv, causal)
    _assert_close(got, want.to(torch.float32).numpy(), "bfloat16",
                  "vs the plain version")
    B, Hq, Hkv, S, D = shape
    fold = lambda x: jnp.asarray(np.repeat(x, Hq // x.shape[1], axis=1)
                                 .reshape(B * Hq, S, D), jnp.bfloat16)
    jax_out = j_fa.flash_attention(fold(q), fold(k), fold(v), causal=causal,
                                   interpret=True)
    _assert_close(got, np.asarray(jax_out, np.float32).reshape(got.shape),
                  "bfloat16", "vs the JAX kernel")


def test_three_terms_are_exact_and_one_bf16_p_is_not_enough():
    p = torch.rand(4096, generator=torch.Generator().manual_seed(0)) ** 4
    hi, mid, lo = _split3(p)
    for t in (hi, mid, lo):   # each term is a bf16 value
        assert torch.equal(t, t.to(torch.bfloat16).to(torch.float32))
    assert torch.equal((hi.double() + mid.double() + lo.double()),
                       p.double())
    # P rounded to bf16 once misses the tolerance at the serve shape
    q, k, v = (torch.as_tensor(x).to(torch.bfloat16)
               for x in _tc_inputs((4, 32, 8, 32, 64), 1))
    one = _tc_body_emulation(q, k, v, True, terms=1).to(torch.float32)
    with pytest.raises(AssertionError):
        _assert_close(one.numpy(), ref.flash_attention_ref(
            q, k, v, True).to(torch.float32).numpy(), "bfloat16", "one term")


@pytest.mark.parametrize("dtype,D,body", [
    (torch.bfloat16, 16, "tensor_core"), (torch.bfloat16, 32, "tensor_core"),
    (torch.bfloat16, 64, "tensor_core"), (torch.bfloat16, 128, "tensor_core"),
    (torch.bfloat16, 8, "cuda_core"), (torch.float32, 8, "cuda_core"),
    (torch.float32, 64, "cuda_core"), (torch.float32, 128, "cuda_core")])
def test_plan_picks_the_body_by_dtype_and_head_dim(dtype, D, body):
    q = torch.empty((2, 8, 256, D), dtype=dtype)
    k = torch.empty((2, 2, 256, D), dtype=dtype)
    pl = FA.plan(q.shape, k.shape, dtype, q.stride(), k.stride(), k.stride())
    assert pl.body == body
    assert (pl.tma is not None) == (body == "tensor_core")


@pytest.mark.parametrize("D,S,causal,grid,tiles", [
    # 256 q tiles of 128 rows; q tile i sees kv tiles 0 .. 2i + 1
    (64, 32768, True, (32, 256), 32 * (2 * (255 * 256 // 2) + 2 * 256)),
    (64, 32768, False, (32, 256), 32 * 256 * 512),
    (128, 32768, True, (32, 256), 32 * (2 * (255 * 256 // 2) + 2 * 256)),
    (64, 32, True, (32, 1), 32), (64, 96, True, (32, 1), 32 * 2),
    (16, 256, True, (32, 2), 32 * (2 + 4))])
def test_plan_grid_and_causal_tiles(D, S, causal, grid, tiles):
    B, Hq, Hkv = 1, 32, 8
    q, k = (torch.empty((B, h, 1, D), dtype=torch.bfloat16)
            .expand(B, h, S, D) for h in (Hq, Hkv))
    st = lambda h: (h * S * D, S * D, D, 1)
    pl = FA.plan((B, Hq, S, D), (B, Hkv, S, D), torch.bfloat16, st(Hq),
                 st(Hkv), st(Hkv), causal=causal)
    assert (pl.block_q, pl.block_kv) == (128, 64)
    assert pl.grid == grid and pl.tiles == tiles


@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_plan_tma_reads_the_models_transposed_views(D):
    B, S, Hq, Hkv = 4, 256, 32, 8
    # the model's (B, S, H, D) projections, passed as (B, H, S, D) views
    q = torch.empty((B, S, Hq, D), dtype=torch.bfloat16).transpose(1, 2)
    k = torch.empty((B, S, Hkv, D), dtype=torch.bfloat16).transpose(1, 2)
    v = torch.empty((B, S, Hkv, D), dtype=torch.bfloat16).transpose(1, 2)
    pl = FA.plan(q.shape, k.shape, torch.bfloat16, q.stride(), k.stride(),
                 v.stride(), ptrs=(0, 4096, 8192, 12288))
    tq, tk, tv = pl.tma
    ch = min(D, 64)               # the box's row: the swizzle span
    assert tq == FA.TmaBox((D, S, Hq, B), (2 * Hq * D, 2 * D, 2 * S * Hq * D),
                           (ch, 128, 1, 1))
    # GQA: k and v keep their Hkv heads; the kernel maps q-head h to h / 4
    for t in (tk, tv):
        assert t == FA.TmaBox((D, S, Hkv, B),
                              (2 * Hkv * D, 2 * D, 2 * S * Hkv * D),
                              (ch, 64, 1, 1))
    assert pl.grid == (B * Hq, 2)


def test_plan_raises_where_tma_cannot_read():
    B, H, S, D = 1, 4, 128, 64
    ok = (H * S * D, S * D, D, 1)
    shape, bf = (B, H, S, D), torch.bfloat16
    FA.plan(shape, shape, bf, ok, ok, ok, ptrs=(0, 16, 32, 48))
    padded = (H * S * (D + 4), S * (D + 4), D + 4, 1)   # rows 136 bytes apart
    with pytest.raises(ValueError, match="multiples of 8 elements"):
        FA.plan(shape, shape, bf, ok, padded, ok)
    with pytest.raises(ValueError, match="16-byte aligned"):
        FA.plan(shape, shape, bf, ok, ok, ok, ptrs=(0, 0, 8, 0))
    with pytest.raises(ValueError, match="contiguous last dimension"):
        FA.plan(shape, shape, bf, (H * S * D, S * D, 1, S), ok, ok)
    # the CUDA-core body takes any strides: 4-element vector loads where
    # the strides are multiples of 4 elements, single elements otherwise
    assert FA.plan(shape, shape, torch.float32, padded, padded, padded
                   ).vector
    odd = FA.plan(shape, shape, torch.float32, ok,
                  (H * S * 66, S * 66, 66, 1), ok)
    assert odd.body == "cuda_core" and not odd.vector
    with pytest.raises(ValueError, match="contiguous last dimension"):
        FA.plan(shape, shape, torch.float32, (H * S * D, S * D, 1, S), ok, ok)
    with pytest.raises(TypeError):
        FA.plan(shape, shape, torch.float16, ok, ok, ok)


# --------------------------------------------------------------------------
# Head dims of the configurations beside llama3.2-1b's (kimi-k2: 112,
# reduced 14; stablelm-12b: 160, reduced 20): the bodies run them at the
# next instantiated head dim, the columns past D zeros
# --------------------------------------------------------------------------

OTHER_DIMS = (14, 20, 112, 160)
D_REF = D                    # the head dim ATOL was set for


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", OTHER_DIMS)
def test_any_head_dim_matches_jax(D, causal, dtype):
    rng = np.random.default_rng(D)
    S, group = 64, 4
    q = rng.standard_normal((B, HQ, S, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, HQ // group, S, D)).astype(np.float32)
            for _ in range(2))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    if dtype == "bfloat16":
        q, k, v = (x.astype(ml_dtypes.bfloat16).astype(np.float32)
                   for x in (q, k, v))
    got = ops.flash_attention(*(torch.as_tensor(x).to(getattr(torch, dtype))
                                for x in (q, k, v)), causal)
    assert got.shape == (B, HQ, S, D)
    got = got.to(torch.float32).numpy()
    fold = lambda x: jnp.asarray(np.repeat(x, HQ // x.shape[1], axis=1)
                                 .reshape(B * HQ, S, D), jdt)
    # the absolute float32 tolerance of the D = 16 tests, grown with D: a
    # score is a float32 sum of D products, taken in another order by each
    # package (near-zero outputs meet it first)
    atol = ATOL * max(1.0, D / D_REF)
    jax_out = j_fa.flash_attention(fold(q), fold(k), fold(v), causal=causal,
                                   interpret=True)
    _assert_close(got, np.asarray(jax_out, np.float32).reshape(got.shape),
                  dtype, "vs the JAX kernel", atol)
    oracle = j_ref.attention_ref(fold(q), fold(k), fold(v), causal=causal)
    _assert_close(got, np.asarray(oracle, np.float32).reshape(got.shape),
                  dtype, "vs the JAX oracle", atol)


@pytest.mark.parametrize("dtype,D,body,head_dim,vector", [
    (torch.bfloat16, 14, "cuda_core", 16, False),
    (torch.bfloat16, 20, "cuda_core", 32, True),
    (torch.bfloat16, 112, "tensor_core", 128, True),
    (torch.bfloat16, 160, "cuda_core", 160, True),
    (torch.float32, 14, "cuda_core", 16, False),
    (torch.float32, 20, "cuda_core", 32, True),
    (torch.float32, 112, "cuda_core", 128, True),
    (torch.float32, 160, "cuda_core", 160, True),
    (torch.bfloat16, 48, "tensor_core", 64, True),
    (torch.bfloat16, 24, "cuda_core", 32, True),
    (torch.bfloat16, 200, "cuda_core", 256, True),
    (torch.float32, 1, "cuda_core", 8, False)])
def test_plan_pads_the_head_dim(dtype, D, body, head_dim, vector):
    q = torch.empty((2, 8, 256, D), dtype=dtype)
    k = torch.empty((2, 2, 256, D), dtype=dtype)
    pl = FA.plan(q.shape, k.shape, dtype, q.stride(), k.stride(), k.stride())
    assert (pl.body, pl.head_dim, pl.vector) == (body, head_dim, vector)
    if body == "tensor_core":
        # the maps keep the true D; the boxes are the padded geometry's
        for t in pl.tma:
            assert t.dims[0] == D and t.box[0] == min(head_dim, 64)
            assert t.strides[0] == 2 * D
    else:
        assert pl.tma is None


def test_plan_raises_outside_the_head_dims():
    for D in (0, FA.MAX_HEAD_DIM + 1):
        shape = (1, 4, 128, D)
        st = (4 * 128 * D, 128 * D, D, 1)
        for dtype in (torch.float32, torch.bfloat16):
            with pytest.raises(ValueError, match="head dim"):
                FA.plan(shape, shape, dtype, st, st, st)
    # bf16 at a tensor-core head dim still raises where TMA cannot read
    shape, st = (1, 4, 128, 112), (4 * 128 * 116, 128 * 116, 116, 1)
    with pytest.raises(ValueError, match="multiples of 8 elements"):
        FA.plan(shape, shape, torch.bfloat16, st, st, st)


@pytest.mark.parametrize("causal", [True, False])
def test_zero_padded_columns_keep_the_tensor_core_arithmetic(causal):
    """D = 112 on the body instantiated at 128: TMA's zero columns and the
    scale of the true D give the plain version's result within the bf16
    tolerance; the padded output columns are zero."""
    shape = (1, 8, 2, 256, 112)
    q, k, v = (torch.as_tensor(x).to(torch.bfloat16)
               for x in _tc_inputs(shape, 5))
    pad = lambda x: torch.nn.functional.pad(x, (0, 16))
    got = _tc_body_emulation(pad(q), pad(k), pad(v), causal, scale_dim=112)
    assert not bool(got[..., 112:].to(torch.float32).any())
    want = ref.flash_attention_ref(q, k, v, causal)
    _assert_close(got[..., :112].to(torch.float32).numpy(),
                  want.to(torch.float32).numpy(), "bfloat16",
                  "padded vs the plain version")
