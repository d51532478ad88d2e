"""Plain reference of the dense decoder LM on an approximate multiplier.

The model the configuration states (pre-norm RMSNorm blocks of grouped-
query self-attention with rotary embeddings and a SwiGLU MLP, a tied
output head) in float32 on plain PyTorch, every projection's products
taken from the multiplier's 256 × 256 table as the configuration states
the approximate path: both operands quantized to uint8 asymmetrically
with one scale over the whole tensor (round half to even), the table's
products summed exactly, the zero-point terms taken in float32 as the
configuration states, the result scaled back.  It imports nothing of the
program and reads only what the benchmark made: the weight buffers, the
table's genome, the tokens and the seeded part of a cache.

``rnd`` is applied wherever the configuration stores a tensor in its
activation dtype: a round trip through that dtype (``bf16`` for a
bfloat16 configuration; every operation itself computes in float32), and
through the precision below it for the control (``fp8``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def fp8(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 (saturating at its largest finite value) and
    back to float32."""
    return x.clamp(-448, 448).to(torch.float8_e4m3fn).to(torch.float32)


def bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 and back to float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def quantize(x: torch.Tensor):
    """(q int64 in [0, 255], scale, zero) with x ≈ scale · (q - zero), one
    scale over the whole tensor."""
    lo, hi = x.min(), x.max()
    scale = torch.clamp_min(hi - lo, 1e-8) / 255.0
    zero = torch.round(-lo / scale)
    q = torch.clamp(torch.round(x / scale + zero), 0, 255).to(torch.int64)
    return q, scale, zero


def lut_products(a: torch.Tensor, b: torch.Tensor,
                 table: torch.Tensor, group: int = 16) -> torch.Tensor:
    """Exact Σ_k table[a[m, k], b[k, n]] (int64) for uint8-valued a (M, K),
    b (K, N) and a table of entries in [0, 65535].

    The sum is taken as Σ_v onehot_v(b) over each weight value v: the
    activation side carries the table's column v gathered by a, split in
    a low and a high byte, each offset by -128 into int8, so every partial
    product sum is an exact int32 matmul (``torch._int_mm`` on the card,
    float64 matmuls of exact integers elsewhere)."""
    M, K = a.shape
    N = b.shape[1]
    dev = a.device
    tab = table.to(dev).to(torch.int64)
    wide = torch.int8 if dev.type == "cuda" else torch.float64
    parts = [((tab & 255) - 128).to(wide), ((tab >> 8) - 128).to(wide)]
    acc = [torch.zeros((M, N), dtype=torch.int64, device=dev)
           for _ in parts]
    cuda = dev.type == "cuda"
    pad = max(0, 17 - M) if cuda else 0
    for v0 in range(0, 256, group):
        vs = torch.arange(v0, v0 + group, device=dev)
        onehot = (b[None] == vs[:, None, None])                  # (G, K, N)
        onehot = onehot.reshape(group * K, N)
        onehot = onehot.to(wide)
        for i, part in enumerate(parts):
            lhs = part[:, v0:v0 + group][a]                      # (M, K, G)
            lhs = lhs.permute(0, 2, 1).reshape(M, group * K)
            if cuda:
                lhs = F.pad(lhs, (0, 0, 0, pad))
                acc[i] += torch._int_mm(lhs, onehot)[:M]
            else:
                acc[i] += (lhs @ onehot).to(torch.int64)
    lo, hi = (x + 128 * K for x in acc)
    return hi * 256 + lo


def approx_linear(x: torch.Tensor, w: torch.Tensor, table: torch.Tensor,
                  rows: torch.Tensor | None = None) -> torch.Tensor:
    """x (..., K) @ w (K, N) through the table: float32 out.  ``rows``:
    only these rows of x flattened to (M, K) (the scale is still the whole
    tensor's)."""
    lead, K = x.shape[:-1], x.shape[-1]
    qx, sx, zx = quantize(x.reshape(-1, K).to(torch.float32))
    if rows is not None:
        qx, lead = qx[rows], (len(rows),)
    qw, sw, zw = quantize(w.to(torch.float32))
    # the configuration's float32 zero-point correction and scaling, in
    # its order (the int64 sums are exact and below 2^31)
    acc = lut_products(qx, qw, table).to(torch.float32)
    rsum = qx.sum(1, keepdim=True).to(torch.float32)
    csum = qw.sum(0, keepdim=True).to(torch.float32)
    y = sx * sw * (acc - zw * rsum - zx * csum + K * zx * zw)
    return y.to(torch.float32).reshape(*lead, w.shape[1])


def rms_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D) rotated at positions pos (B, S): dims i and i + D/2
    form a pair."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, device=x.device,
                                   dtype=torch.float64) / half)
    ang = (pos.to(torch.float64)[..., None] * freq).to(torch.float32)
    s, c = torch.sin(ang)[:, :, None], torch.cos(ang)[:, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], -1)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_pos: torch.Tensor) -> torch.Tensor:
    """q (B, Sq, Hq, D) at absolute positions q_pos (Sq,); k, v (B, Skv,
    Hkv, D) at positions 0..Skv-1; each query sees the keys at or before
    its position.  Float32, heads in groups of Hq / Hkv per kv head."""
    B, Sq, Hq, D = q.shape
    rep = Hq // k.shape[2]
    k = k.repeat_interleave(rep, 2)
    v = v.repeat_interleave(rep, 2)
    out = torch.empty_like(q)
    keys = torch.arange(k.shape[1], device=q.device)
    mask = keys[None] <= q_pos[:, None]
    for h in range(Hq):
        s = torch.einsum("bqd,bkd->bqk", q[:, :, h], k[:, :, h]) * D ** -0.5
        s = s.masked_fill(~mask[None], float("-inf"))
        out[:, :, h] = torch.einsum("bqk,bkd->bqd", s.softmax(-1), v[:, :, h])
    return out


class Model:
    """The configuration's sizes and a weight accessor: ``weight(i, name)``
    gives layer i's ``wq``, ``wk``, ``wv``, ``wo``, ``w_gate``, ``w_up`` or
    ``w_down`` as (d_in, d_out), ``embed()`` the (vocab, d_model) table,
    both in float32 after ``rnd``."""

    def __init__(self, sizes: dict, weight, embed, table: torch.Tensor,
                 rnd=exact):
        self.s = sizes
        self.weight = lambda i, n: rnd(weight(i, n).to(torch.float32))
        self.embed = lambda: rnd(embed().to(torch.float32))
        self.table = table
        self.rnd = rnd

    def lin(self, x, i, name):
        return self.rnd(approx_linear(x, self.weight(i, name), self.table))

    def block(self, x, i, pos, kv):
        """One layer at positions pos (B, S): (x out, (k, v) of the new
        positions).  ``kv(i)`` gives the layer's cached k, v of the
        positions before (B, P, Hkv, D) or None."""
        s, rnd = self.s, self.rnd
        B, S, _ = x.shape
        hd, eps = s["head_dim"], s["rms_norm_eps"]
        h = rnd(rms_norm(x, eps))
        q = self.lin(h, i, "wq").reshape(B, S, s["num_attention_heads"], hd)
        k = self.lin(h, i, "wk").reshape(B, S, s["num_key_value_heads"], hd)
        v = self.lin(h, i, "wv").reshape(B, S, s["num_key_value_heads"], hd)
        q = rnd(rope(q, pos, s["rope_theta"]))
        k = rnd(rope(k, pos, s["rope_theta"]))
        past = kv(i)
        kk = k if past is None else torch.cat([past[0], k], 1)
        vv = v if past is None else torch.cat([past[1], v], 1)
        a = rnd(attend(q, kk, vv, pos[0]))
        x = rnd(x + self.lin(a.reshape(B, S, -1), i, "wo"))
        h = rnd(rms_norm(x, eps))
        gate = self.lin(h, i, "w_gate")
        inner = rnd(rnd(F.silu(gate)) * self.lin(h, i, "w_up"))
        return rnd(x + self.lin(inner, i, "w_down")), (k, v)

    def run(self, tokens, pos, kv=lambda i: None):
        """tokens (B, S) at positions pos (B, S) -> (final normed hidden
        (B, S, d_model), [(k, v) of each layer])."""
        x = self.rnd(self.embed()[tokens])
        new = []
        for i in range(self.s["num_hidden_layers"]):
            x, kv_i = self.block(x, i, pos, kv)
            new.append(kv_i)
        return self.rnd(rms_norm(x, self.s["rms_norm_eps"])), new

    def logits(self, h):
        return self.rnd(h @ self.embed().T)

    def loss(self, tokens, targets, chunk: int = 512):
        """Mean next-token cross-entropy (float64) of one sequence batch."""
        B, S = tokens.shape
        pos = torch.arange(S, device=tokens.device).expand(B, S)
        h, _ = self.run(tokens, pos)
        total = torch.zeros((), dtype=torch.float64, device=tokens.device)
        table = self.embed()
        for c in range(0, S, chunk):
            lg = self.rnd(h[:, c:c + chunk] @ table.T).to(torch.float64)
            t = targets[:, c:c + chunk]
            total += (lg.logsumexp(-1)
                      - lg.gather(-1, t[..., None])[..., 0]).sum()
        return total / targets.numel()
