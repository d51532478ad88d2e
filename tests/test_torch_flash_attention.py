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


def _assert_close(got, want, dtype, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=what)
    else:
        tol = ATOL + RTOL * np.abs(want) + _bf16_ulp(
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

