"""Mamba-2 (SSD, state-space duality) mixer in its chunked-scan form: the
port of ``repro/models/ssm.py``.

Within a chunk the recurrence is computed in its quadratic dual form
(Q×Q products); across chunks a sequential loop carries the (H, P, N)
state, so the working memory is one chunk's.  Decode is one state update
a token (the conv tails and the SSM state, ``SSMState``), and equals the
forward.  Parameters are an ``nn.Module`` in the reference's layout; the
five projections go through ``layers.matmul`` (the approximate multiplier
under ``cfg.approx_matmul``), the rest is float32 tensor code that runs in
full float32 on the card (``layers.ieee_fp32``).  The causal depthwise
conv is a sum of shifted products, as the reference's is: a cuDNN
convolution would run in TF32 on the card by default.

On a mesh whose "tp" axes divide the heads (``ssm_tp``) a "model" rank
holds and computes its ``H / tp`` heads, as the reference's GSPMD splits
the mixer by ``ssm_specs``: ``w_z``, ``w_x`` and ``w_dt`` column-parallel
behind *f*, the rank's slices of ``conv_x_w``, ``dt_bias``, ``a_log``,
``d_skip`` and ``gate_norm``, ``w_out`` row-parallel with *g* after it
(``parallel.collectives``).  ``w_bc`` and ``conv_bc_w`` stay whole: B and
C are computed whole on every rank from the norm's output before *f*, and
*f* stands after their conv instead, so the gradients of the bc branch's
weights are whole and equal on every rank; the rank's head ``h`` reads
group ``h // (H / G)``.  The gate norm spans the split ``d_inner``: its
sum of squares is summed over "tp" (and so is that sum's gradient) before
the rsqrt.  The decode state stays as it lies at rest: ``conv_x``'s
channels and ``ssm``'s heads the rank's, ``conv_bc`` whole.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (dense_init, ieee_fp32, matmul, param,
                                       rms_norm)
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import ctx


class SSMState(NamedTuple):
    conv_x: torch.Tensor    # (B, convw-1, d_inner)
    conv_bc: torch.Tensor   # (B, convw-1, 2*G*N)
    ssm: torch.Tensor       # (B, H, P, N) float32


def dims(cfg: ModelConfig):
    """(d_inner, heads H, head dim P, groups G, state N)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.headdim
    return d_inner, H, s.headdim, s.n_groups, s.d_state


class SSM(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, dt, cw = cfg.d_model, cfg.pdtype(), cfg.ssm.conv_width
        d_inner, H, _, G, N = dims(cfg)
        self.norm = param((d,), dt, device)
        self.w_z = param((d, d_inner), dt, device)
        self.w_x = param((d, d_inner), dt, device)
        self.w_bc = param((d, 2 * G * N), dt, device)
        self.w_dt = param((d, H), dt, device)
        self.dt_bias = param((H,), dt, device)
        self.a_log = param((H,), dt, device)
        self.d_skip = param((H,), dt, device)
        self.conv_x_w = param((cw, d_inner), dt, device)
        self.conv_bc_w = param((cw, 2 * G * N), dt, device)
        self.gate_norm = param((d_inner,), dt, device)
        self.w_out = param((d_inner, d), dt, device)


def init_ssm(gen: torch.Generator, cfg: ModelConfig, device) -> SSM:
    """The reference's distributions: projections N(0, 1/d_in), conv
    weights N(0, 0.1²), ``dt_bias`` the inverse softplus of a dt drawn
    log-uniform in [dt_min, dt_max], ``a_log`` = log(1..H), ``d_skip`` and
    the norms one."""
    s = cfg.ssm
    p = SSM(cfg, device)
    H = dims(cfg)[1]
    for w in (p.w_z, p.w_x, p.w_bc, p.w_dt, p.w_out):
        dense_init(gen, w)
    dense_init(gen, p.conv_x_w, scale=0.1)
    dense_init(gen, p.conv_bc_w, scale=0.1)
    u = torch.rand((H,), generator=gen, device=device, dtype=torch.float32)
    dt0 = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min))
                    + math.log(s.dt_min))
    p.dt_bias.copy_(dt0 + torch.log(-torch.expm1(-dt0)))
    p.a_log.copy_(torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                         device=device)))
    for w in (p.norm, p.d_skip, p.gate_norm):
        w.fill_(1.0)
    return p


def ssm_specs(cfg: ModelConfig) -> dict:
    """Heads and d_inner columns over "tp"; the B/C group projection and
    its conv replicated (the reference's ``ssm_specs``)."""
    return {
        "norm": (None,), "w_z": ("fsdp", "tp"), "w_x": ("fsdp", "tp"),
        "w_bc": ("fsdp", None), "w_dt": ("fsdp", "tp"), "dt_bias": ("tp",),
        "a_log": ("tp",), "d_skip": ("tp",),
        "conv_x_w": (None, "tp"), "conv_bc_w": (None, None),
        "gate_norm": ("tp",), "w_out": ("tp", "fsdp"),
    }


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                           tail: torch.Tensor | None = None) -> torch.Tensor:
    """x: (B, S, C); w: (convw, C); optional tail: (B, convw-1, C), the
    inputs before x."""
    convw = w.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], convw - 1, x.shape[2]),
                           dtype=x.dtype, device=x.device)
    xp = torch.cat([tail.to(x.dtype), x], dim=1)
    S = x.shape[1]
    return sum(xp[:, i:i + S] * w[i][None, None, :] for i in range(convw))


def _ssd_chunked(xh, dt, A, Bm, Cm, chunk: int, init_state=None):
    """Chunked SSD scan.

    xh: (B, S, H, P), dt: (B, S, H) (after softplus), A: (H,) < 0,
    Bm/Cm: (B, S, G, N).  Returns (y (B, S, H, P), final state (B, H, P,
    N)), float32."""
    f32 = torch.float32
    Bsz, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    nc = xh.shape[1] // Q
    rep = H // G                                   # heads per group

    xh = xh.reshape(Bsz, nc, Q, H, P).to(f32)
    dt = dt.reshape(Bsz, nc, Q, H).to(f32)
    Bh = Bm.reshape(Bsz, nc, Q, G, N).to(f32).repeat_interleave(rep, dim=3)
    Ch = Cm.reshape(Bsz, nc, Q, G, N).to(f32).repeat_interleave(rep, dim=3)

    dA = dt * A[None, None, None, :]                       # (B,nc,Q,H) <= 0
    cum = torch.cumsum(dA, dim=2)                          # inclusive
    state = (torch.zeros((Bsz, H, P, N), dtype=f32, device=xh.device)
             if init_state is None else init_state.to(f32))
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))
    ys = []
    for c in range(nc):
        x_c, dt_c, B_c, C_c, cum_c = (xh[:, c], dt[:, c], Bh[:, c],
                                      Ch[:, c], cum[:, c])
        # off-diagonal: the incoming state's contribution
        decay_in = torch.exp(cum_c)                        # (B,Q,H)
        y_off = torch.einsum("bqhn,bhpn,bqh->bqhp", C_c, state, decay_in)
        # diagonal: the chunk's own dual (quadratic) form
        seg = cum_c[:, :, None, :] - cum_c[:, None, :, :]  # (B,Q,Q,H)
        # the exp of the causal triangle alone: above it seg > 0 overflows
        # at long chunks, and the reference's where(tri, exp(seg), 0)
        # takes inf · 0 = NaN into the backward pass (the same forward)
        L = torch.exp(torch.where(tri[None, :, :, None], seg, -torch.inf))
        cb = torch.einsum("bqhn,bshn->bqsh", C_c, B_c)     # (B,Q,Q,H)
        y_diag = torch.einsum("bqsh,bsh,bshp->bqhp", cb * L, dt_c, x_c)
        # the state passed to the next chunk
        decay_out = torch.exp(cum_c[:, -1:, :] - cum_c)    # (B,Q,H)
        state_new = torch.einsum("bqhn,bqh,bqhp->bhpn", B_c,
                                 decay_out * dt_c, x_c)
        chunk_decay = torch.exp(cum_c[:, -1, :])           # (B,H)
        state = state * chunk_decay[:, :, None, None] + state_new
        ys.append(y_off + y_diag)
    y = torch.stack(ys, dim=1).reshape(Bsz, nc * Q, H, P)
    return y[:, :S], state


def ssm_tp(cfg: ModelConfig) -> tuple:
    """The live "tp" axes the SSM mixer splits its heads (and ``d_inner``)
    over on the active mesh: none where they do not divide (every rank
    computes the whole mixer)."""
    d_inner, H = dims(cfg)[:2]
    return ctx.tp_divides(H, d_inner)


def _head_groups(Bm: torch.Tensor, H: int, tp: tuple) -> torch.Tensor:
    """Bm (..., G, N) of every group -> (..., H / tp, N), the group of each
    of this rank's heads (head ``h`` reads group ``h // (H / G)``); Bm
    itself without ``tp``."""
    if not tp:
        return Bm
    mesh = ctx.get_mesh()
    local = H // mesh.size(tp)
    heads = mesh.index(tp) * local + torch.arange(local, device=Bm.device)
    return Bm.index_select(-2, heads // (H // Bm.shape[-2]))


def _projections(params: SSM, x: torch.Tensor, cfg: ModelConfig,
                 tp: tuple):
    """(h, z, x's, bc's, dt's pre-conv projections) of the normed x: z, x
    and dt this rank's columns (column-parallel behind *f*), bc whole from
    the norm's output ``h`` itself (``_bc_heads`` puts *f* after its
    conv)."""
    h = rms_norm(x, params.norm, cfg.norm_eps)
    hp = coll.tp_in(h, tp)
    z = matmul(hp, params.w_z.to(h.dtype), cfg, tp)
    xin = matmul(hp, params.w_x.to(h.dtype), cfg, tp)
    bc = matmul(h, params.w_bc.to(h.dtype), cfg)
    dt_raw = matmul(hp, params.w_dt.to(h.dtype), cfg, tp)
    return h, z, xin, bc, dt_raw


def _bc_heads(bc: torch.Tensor, cfg: ModelConfig, tp: tuple):
    """(B, C) of this rank's heads from the whole bc branch after its conv
    (..., 2·G·N): *f* first, so the gradient of the replicated branch is
    the sum of every rank's heads' parts."""
    _, H, _, G, N = dims(cfg)
    bc = coll.tp_in(bc, tp)
    Bm, Cm = bc.reshape(bc.shape[:-1] + (2 * G, N)).split(G, dim=-2)
    return _head_groups(Bm, H, tp), _head_groups(Cm, H, tp)


def _gate_norm(v: torch.Tensor, scale: torch.Tensor, eps: float,
               tp: tuple) -> torch.Tensor:
    """``rms_norm`` over ``d_inner`` split over ``tp``: each rank's sum of
    squares summed over "tp" (*g*, then *f*: every rank uses the whole
    sum, so its gradient is summed too), over the whole width."""
    if not tp:
        return rms_norm(v, scale, eps)
    dt = v.dtype
    v = v.to(torch.float32)
    ss = coll.tp_in(coll.tp_out((v * v).sum(-1, keepdim=True), tp), tp)
    width = v.shape[-1] * ctx.get_mesh().size(tp)
    v = v * torch.rsqrt(ss / width + eps)
    return (v * scale.to(torch.float32)).to(dt)


def _gated_out(params: SSM, x, y, z, cfg: ModelConfig, tp: tuple = ()):
    """x + w_out · rms_norm(y · silu(z)) (the mixer's residual output);
    ``tp``: y and z this rank's columns, ``w_out`` row-parallel."""
    y = _gate_norm(y * F.silu(z.to(torch.float32)), params.gate_norm,
                   cfg.norm_eps, tp).to(x.dtype)
    return x + matmul(y, params.w_out.to(x.dtype), cfg, tp, row=True)


def ssm_forward(params: SSM, x: torch.Tensor, cfg: ModelConfig,
                state: SSMState | None = None, return_state: bool = False,
                tp: tuple = ()):
    """The full-sequence mamba2 mixer (train / prefill): (x + out, the
    state after the last token when ``return_state``, else None).  ``tp``
    (``ssm_tp``): ``params`` and ``state`` hold this rank's heads."""
    Bsz, S, d = x.shape
    s = cfg.ssm
    P = dims(cfg)[2]
    h, z, xin, bc, dt_raw = _projections(params, x, cfg, tp)
    with ieee_fp32():
        tail_x = state.conv_x if state is not None else None
        tail_bc = state.conv_bc if state is not None else None
        xin = F.silu(_causal_depthwise_conv(
            xin, params.conv_x_w.to(h.dtype), tail_x).to(torch.float32))
        bc = F.silu(_causal_depthwise_conv(
            bc, params.conv_bc_w.to(h.dtype), tail_bc).to(torch.float32))
        Bm, Cm = _bc_heads(bc, cfg, tp)
        dt = F.softplus(dt_raw.to(torch.float32)
                        + params.dt_bias.to(torch.float32))
        A = -torch.exp(params.a_log.to(torch.float32))
        xh = xin.reshape(Bsz, S, -1, P)
        init = state.ssm if state is not None else None
        y, final_state = _ssd_chunked(xh, dt, A, Bm, Cm, s.chunk, init)
        y = y + params.d_skip.to(torch.float32)[None, None, :, None] * xh
    out = _gated_out(params, x, y.reshape(Bsz, S, -1), z, cfg, tp)
    if not return_state:
        return out, None
    cw = s.conv_width
    # conv tails: the last convw-1 conv inputs, before the activation
    h_x = matmul(h, params.w_x.to(h.dtype), cfg, tp)
    h_bc = matmul(h, params.w_bc.to(h.dtype), cfg)
    return out, SSMState(conv_x=h_x[:, -(cw - 1):, :],
                         conv_bc=h_bc[:, -(cw - 1):, :], ssm=final_state)


def ssm_decode_step(params: SSM, x: torch.Tensor, state: SSMState,
                    cfg: ModelConfig, tp: tuple = ()):
    """One token: x (B, 1, D) -> (x + out, the new state).  ``tp``
    (``ssm_tp``): ``params`` and ``state`` hold this rank's heads."""
    Bsz = x.shape[0]
    P = dims(cfg)[2]
    h, z, xin_pre, bc_pre, dt_raw = _projections(params, x, cfg, tp)
    z, dt_raw = z[:, 0], dt_raw[:, 0]
    with ieee_fp32():
        # the conv over the stored tails and the new input
        cx = torch.cat([state.conv_x.to(h.dtype), xin_pre], dim=1)
        cbc = torch.cat([state.conv_bc.to(h.dtype), bc_pre], dim=1)
        xin = F.silu(torch.einsum("bwc,wc->bc", cx, params.conv_x_w.to(
            h.dtype)).to(torch.float32))
        bc = F.silu(torch.einsum("bwc,wc->bc", cbc, params.conv_bc_w.to(
            h.dtype)).to(torch.float32))
        Bm, Cm = _bc_heads(bc, cfg, tp)
        xh = xin.reshape(Bsz, -1, P)
        rep = xh.shape[1] // Bm.shape[1]
        Bh = Bm.repeat_interleave(rep, dim=1)                   # (B,H,N)
        Ch = Cm.repeat_interleave(rep, dim=1)
        dt = F.softplus(dt_raw.to(torch.float32)
                        + params.dt_bias.to(torch.float32))     # (B,H)
        A = -torch.exp(params.a_log.to(torch.float32))
        dA = torch.exp(dt * A[None, :])
        ssm = state.ssm * dA[:, :, None, None] + torch.einsum(
            "bh,bhp,bhn->bhpn", dt, xh, Bh)
        y = torch.einsum("bhn,bhpn->bhp", Ch, ssm)
        y = y + params.d_skip.to(torch.float32)[None, :, None] * xh
    out = _gated_out(params, x, y.reshape(Bsz, 1, -1), z[:, None], cfg, tp)
    return out, SSMState(conv_x=cx[:, 1:].to(state.conv_x.dtype),
                         conv_bc=cbc[:, 1:].to(state.conv_bc.dtype),
                         ssm=ssm)


def init_ssm_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                   device=None) -> SSMState:
    """A zeroed decode state: conv tails in ``dtype``, the SSM state in
    float32."""
    s = cfg.ssm
    d_inner, H, P, G, N = dims(cfg)
    zeros = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    return SSMState(conv_x=zeros((batch, s.conv_width - 1, d_inner), dtype),
                    conv_bc=zeros((batch, s.conv_width - 1, 2 * G * N),
                                  dtype),
                    ssm=zeros((batch, H, P, N), torch.float32))
