"""Building blocks of the dense LM: initializers, RMSNorm, projections,
rotary embeddings, the token embedding (one table, or one per codebook for
the audio front end) and the SwiGLU or GELU MLP.

Parameters live in ``nn.Module``s allocated with an explicit device and
dtype and filled from an explicit ``torch.Generator``; they keep the
reference's layouts (projections stored (d_in, d_out), applied as
``x @ w``), so ``convert.model_params`` copies JAX weights across as they
are.  The apply functions mirror ``repro/models/layers.py``.  Parameters
are created with ``requires_grad=False``, so serving builds no autograd
graph; the trainer turns gradients on for its own parameters
(``launch/steps.trainable``).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import ctx
from repro_torch.parallel.collectives import materialize


def param(shape, dtype: torch.dtype, device) -> nn.Parameter:
    """An uninitialized, gradient-free parameter."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def dense_init(gen: torch.Generator, w: torch.Tensor,
               scale: float | None = None) -> None:
    """Fill ``w`` (d_in, d_out) with N(0, 1)·scale drawn in float32,
    scale 1/√d_in by default."""
    scale = scale if scale is not None else 1.0 / math.sqrt(w.shape[0])
    w.copy_(torch.randn(w.shape, generator=gen, device=w.device,
                        dtype=torch.float32) * scale)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.to(torch.float32)).to(dt)


@contextlib.contextmanager
def ieee_fp32():
    """float32 matmuls in full float32 on the card within the block (no
    TF32), whatever the process has set; no effect on the CPU."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def matmul(x: torch.Tensor, w: torch.Tensor, cfg: ModelConfig,
           tp: tuple = (), row: bool = False) -> torch.Tensor:
    """Projection matmul; through the evolved multiplier's LUT when
    ``cfg.approx_matmul`` (``models/quant.py``).  ``tp``: the live "tp"
    axes ``w`` is split over, its columns (column-parallel: this rank's
    output columns; *f* stands before it, at the caller) or with ``row``
    its rows (row-parallel: ``x`` holds this rank's K columns, and the
    result is the whole sum, *g* on the float path)."""
    if cfg.approx_matmul:
        from repro_torch.models import quant
        return quant.approx_matmul(x, w, tp=tp, row=row)
    y = x @ w
    return coll.tp_out(y, tp) if row else y


# ----------------------------- rotary embeddings ---------------------------

def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) of shape positions.shape + (head_dim / 2,)."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
               ) -> torch.Tensor:
    """x: (..., S, H, D); sin/cos: (..., S, D/2) broadcast over heads."""
    dt = x.dtype
    x = x.to(torch.float32)
    x1, x2 = x.chunk(2, dim=-1)
    s, c = sin[..., None, :], cos[..., None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(dt)


# ----------------------------- embeddings ----------------------------------

class Embed(nn.Module):
    """The token table: (vocab, d_model), or (n_codebooks, vocab, d_model)
    for the audio front end."""
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        shape = (cfg.vocab, cfg.d_model)
        if cfg.frontend == "audio":
            shape = (cfg.n_codebooks,) + shape
        self.tokens = param(shape, cfg.pdtype(), device)


def embed_specs(cfg: ModelConfig) -> dict:
    """The table's logical spec (``repro/models/layers.py::embed_specs``):
    the vocab over "tp" when it divides, else the vocab over "fsdp" (when
    that divides) and d_model over "tp"."""
    tp = max(1, ctx.axis_size("tp"))
    dp = max(1, ctx.axis_size("dp"))
    v_tp = "tp" if cfg.vocab % tp == 0 else None
    v_fs = "fsdp" if cfg.vocab % dp == 0 else None
    if cfg.frontend == "audio":
        return {"tokens": (None, "tp", None) if v_tp
                else (None, v_fs, "tp")}
    return {"tokens": ("tp", None) if v_tp else (v_fs, "tp")}


@contextlib.contextmanager
def _deterministic():
    """PyTorch's deterministic algorithms within the block."""
    on = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(on, warn_only=warn)


class _Take(torch.autograd.Function):
    """``table[ids]``, the rows of a token table.  Its backward is the
    ``index_put`` autograd gives ``table[ids]``, run under deterministic
    algorithms: the multithreaded CPU kernel otherwise adds a repeated
    id's gradient rows in whatever order its threads reach them, so two
    runs of the same training step parted in the last bits (and a card
    against CPU comparison by more than its noise)."""

    @staticmethod
    def forward(ctx_, table, ids):
        ctx_.save_for_backward(ids)
        ctx_.shape = table.shape
        return table[ids]

    @staticmethod
    def backward(ctx_, g):
        (ids,) = ctx_.saved_tensors
        with _deterministic():
            return torch.index_put(g.new_zeros(ctx_.shape), (ids,), g,
                                   accumulate=True), None


def init_embed(gen: torch.Generator, cfg: ModelConfig, device) -> Embed:
    e = Embed(cfg, device)
    dense_init(gen, e.tokens, scale=0.02)
    return e


def embed_tokens(params: Embed, tokens: torch.Tensor, cfg: ModelConfig,
                 tp: tuple = (), cols: tuple = ()) -> torch.Tensor:
    """tokens (B, S) -> (B, S, d_model) in the activation dtype.  Audio
    tokens (B, S, C): the C codebooks' embeddings summed in order c = 0 ..
    C-1 in the table's dtype, then cast, as the reference sums them.

    ``tp``: the live "tp" axes the vocabulary is split over (the table
    holds this rank's rows): each rank looks up the ids in its rows, zero
    elsewhere, and the lookups are summed over ``tp`` (exact: one term of
    each sum is not zero), each codebook's apart.  ``cols`` (not audio):
    the live "tp" axes the table's d_model columns are split over: each
    rank looks up its columns and they are gathered over ``cols`` (the
    backward keeps this rank's block of a gradient every rank holds
    whole)."""
    tok = materialize(params.tokens, ("model",) if tp or cols else ())
    ids = tokens
    if tp:
        rows = tok.shape[-2]
        ids = tokens - ctx.get_mesh().index(tp) * rows
        own = ((ids >= 0) & (ids < rows))[..., None]
        ids = ids.clamp(0, rows - 1)
    if cfg.frontend == "audio":
        parts = [_Take.apply(tok[c], ids[..., c])
                 for c in range(cfg.n_codebooks)]
        if tp:
            parts = coll.tp_out(torch.stack([
                torch.where(own[..., c, :], e, 0) for c, e in
                enumerate(parts)]), tp).unbind(0)
        out = parts[0]
        for c in range(1, cfg.n_codebooks):
            out = out + parts[c]
        return out.to(cfg.adtype())
    out = _Take.apply(tok, ids)
    if tp:
        out = coll.tp_out(torch.where(own, out, 0), tp)
    if cols:
        out = coll.tp_gather(out, cols, -1)
    return out.to(cfg.adtype())


# ----------------------------- MLP (dense FFN) -----------------------------

class MLP(nn.Module):
    """SwiGLU (``w_gate``, ``w_up``, ``w_down``) or, for ``act="gelu"``,
    GELU (no ``w_gate``)."""
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, f, dt = cfg.d_model, cfg.d_ff, cfg.pdtype()
        if cfg.act == "swiglu":
            self.w_gate = param((d, f), dt, device)
        elif cfg.act != "gelu":
            raise ValueError(f"unknown act {cfg.act!r}")
        self.w_up = param((d, f), dt, device)
        self.w_down = param((f, d), dt, device)
        self.norm = param((d,), dt, device)


def mlp_specs(cfg: ModelConfig) -> dict:
    p = {"w_up": ("fsdp", "tp"), "w_down": ("tp", "fsdp"), "norm": (None,)}
    if cfg.act == "swiglu":
        p["w_gate"] = ("fsdp", "tp")
    return p


def init_mlp(gen: torch.Generator, cfg: ModelConfig, device) -> MLP:
    p = MLP(cfg, device)
    if cfg.act == "swiglu":
        dense_init(gen, p.w_gate)
    dense_init(gen, p.w_up)
    dense_init(gen, p.w_down)
    p.norm.fill_(1.0)
    return p


def mlp_tp(cfg: ModelConfig) -> tuple:
    """The live "tp" axes the dense MLP's ``d_ff`` columns split over on
    the active mesh (none where they do not divide: the MLP computes
    whole)."""
    return ctx.tp_divides(cfg.d_ff)


def mlp(params: MLP, x: torch.Tensor, cfg: ModelConfig, tp: tuple = ()
        ) -> torch.Tensor:
    """Pre-norm residual SwiGLU or GELU feed-forward.  GELU is the tanh
    approximation in float32, ``jax.nn.gelu``'s default (PyTorch's default
    is the erf form).  ``tp`` (``mlp_tp``): ``params`` hold this rank's
    ``d_ff`` columns of ``w_gate`` / ``w_up`` and rows of ``w_down``."""
    h = coll.tp_in(rms_norm(x, params.norm, cfg.norm_eps), tp)
    up = matmul(h, params.w_up.to(h.dtype), cfg, tp)
    if cfg.act == "swiglu":
        gate = matmul(h, params.w_gate.to(h.dtype), cfg, tp)
        inner = F.silu(gate.to(torch.float32)).to(h.dtype) * up
    else:
        inner = F.gelu(up.to(torch.float32), approximate="tanh").to(h.dtype)
    return x + matmul(inner, params.w_down.to(h.dtype), cfg, tp, row=True)
