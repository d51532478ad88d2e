"""Token-choice top-k mixture of experts: the port of ``repro/models/moe.py``
(the single-device path, ``moe_ffn``).

Dispatch is the reference's sort-based capacity scheme: the (token, k)
assignments are sorted by expert (a stable sort), each takes its position
within its expert's segment, those at or past the capacity are dropped,
the kept ones fill an (E, C, D) buffer, the experts run as one batched
SwiGLU, and each token gets back the router-weighted sum of its kept
experts' outputs.  No write here depends on the order in which the card
makes it (every scatter writes distinct rows or adds equal values), so a
card run repeats bit for bit:

* the top k are the first k of a stable descending sort of the router's
  probabilities, so a tie goes to the lower expert id, as
  ``jax.lax.top_k``'s does;
* the buffer is filled by gathering each slot's assignment (segment start
  + position); the reference scatters into it, with the dropped
  assignments on a discarded sentinel row;
* the combine adds each token's K contributions one by one in ascending
  expert id, rounding in the activation dtype after each add: the order
  in which the reference's ``zeros.at[tok].add`` applies its updates
  sorted by expert.  ``index_add_`` on the card adds atomically, in no
  fixed order.

The router and every float32 product here run in full float32 on the card
(``layers.ieee_fp32``): TF32 would flip expert choices against the CPU.
The expert products are plain ``torch.bmm``s, as the reference's are
``jnp.einsum``s (not the approximate multiplier).  The load-balancing aux
loss ``E · Σ_e f_e · p̄_e`` is returned for the train step.

Expert parallelism (``moe_ffn_ep``, the reference's ``shard_map`` over the
"model" axis): every "model" rank routes the same token block, computes
only its ``E / n`` experts (the window ``[e_lo, e_lo + e_per)`` of
``_moe_math``, whose combine adds only their contributions), and the
ranks' partial outputs are summed in float32 and rounded once to the
activation dtype; the aux loss is their mean.  The token block is this
rank's dp rows when the batch is split, and the capacity then counts
those rows alone, as in the reference: a dp-split EP is not the function
of the whole batch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, ieee_fp32, param, rms_norm
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import ctx


class MoE(nn.Module):
    """The experts' weights (E, d, f) / (E, f, d) in ``param_dtype``, the
    router (d, E) in float32 whatever ``param_dtype`` is."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        m = cfg.moe
        d, f, E, dt = cfg.d_model, m.d_ff_expert, m.n_experts, cfg.pdtype()
        self.norm = param((d,), dt, device)
        self.router = param((d, E), torch.float32, device)
        self.w_gate = param((E, d, f), dt, device)
        self.w_up = param((E, d, f), dt, device)
        self.w_down = param((E, f, d), dt, device)


def init_moe(gen: torch.Generator, cfg: ModelConfig, device) -> MoE:
    """The reference's distributions: router N(0, 1/d), gate and up
    N(0, 1/d), down N(0, 1/f), norm one.  The experts are drawn one at a
    time, so no float32 copy of a whole (E, d, f) weight is made."""
    p = MoE(cfg, device)
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    p.norm.fill_(1.0)
    dense_init(gen, p.router)
    for w, scale in ((p.w_gate, d ** -0.5), (p.w_up, d ** -0.5),
                     (p.w_down, f ** -0.5)):
        for e in range(w.shape[0]):
            dense_init(gen, w[e], scale=scale)
    return p


def moe_specs(cfg: ModelConfig) -> dict:
    """Experts over "tp" (expert parallelism), d_model over "fsdp"."""
    return {"norm": (None,), "router": ("fsdp", None),
            "w_gate": ("tp", "fsdp", None), "w_up": ("tp", "fsdp", None),
            "w_down": ("tp", None, "fsdp")}


def _route(h2: torch.Tensor, router: torch.Tensor, top_k: int):
    """h2: (T, D) -> (weights (T, K) float32, expert ids (T, K), aux)."""
    with ieee_fp32():
        logits = h2.to(torch.float32) @ router.to(torch.float32)   # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = top[:, :top_k], idx[:, :top_k]
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    E = router.shape[1]
    # load-balance aux: E * sum_e fraction_e * prob_e (every term added is
    # the same 1/(T K), so the atomic adds of the card give one answer)
    flat = ids.reshape(-1)
    frac = torch.zeros((E,), dtype=torch.float32, device=h2.device
                       ).index_add_(0, flat, torch.full(
                           flat.shape, 1.0 / flat.numel(),
                           dtype=torch.float32, device=h2.device))
    aux = E * torch.sum(frac * probs.mean(0))
    return w, ids, aux


def _dispatch_indices(ids: torch.Tensor, E: int, capacity: int):
    """Sort-based positions.  ids: (T, K) -> (order: the assignments sorted
    by expert, stably; buf_idx: each sorted assignment's buffer row;
    keep: its position within its expert is below ``capacity``)."""
    flat_e = ids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order].contiguous()
    seg_start = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos = torch.arange(flat_e.numel(), device=ids.device) - seg_start
    keep = pos < capacity
    buf_idx = sorted_e * capacity + torch.clamp_max(pos, capacity - 1)
    return order, buf_idx, keep


def _expert_ffn(buf: torch.Tensor, params: MoE) -> torch.Tensor:
    """buf: (E, C, D) -> (E, C, D), every expert's SwiGLU."""
    w_g = params.w_gate.to(buf.dtype)
    w_u = params.w_up.to(buf.dtype)
    w_d = params.w_down.to(buf.dtype)
    gate = torch.bmm(buf, w_g)
    up = torch.bmm(buf, w_u)
    inner = F.silu(gate.to(torch.float32)).to(buf.dtype) * up
    return torch.bmm(inner, w_d)


def _capacity(T: int, cfg: ModelConfig, full: bool) -> int:
    m = cfg.moe
    if full:
        return T  # decode: an expert can receive every token, no drops
    return int(max(1, T * m.top_k * m.capacity_factor / m.n_experts))


def _moe_math(h2: torch.Tensor, params: MoE, cfg: ModelConfig,
              capacity: int, e_lo: int = 0, e_per: int | None = None,
              router: torch.Tensor | None = None):
    """Route -> dispatch -> experts -> combine for the experts ``[e_lo,
    e_lo + e_per)`` (all E by default), whose weights ``params`` holds
    (the reference's ``_moe_math_dyn``): the assignments to other experts
    add nothing.  ``router`` replaces ``params.router``."""
    m = cfg.moe
    E, K = m.n_experts, m.top_k
    e_per = E if e_per is None else e_per
    T, D = h2.shape
    dev = h2.device
    w, ids, aux = _route(h2, params.router if router is None else router, K)
    order, buf_idx, keep = _dispatch_indices(ids, E, capacity)
    tok_idx = order // K
    # slot (e, c) holds expert e's c-th assignment in sorted order, if any
    sorted_e = ids.reshape(-1)[order].contiguous()
    keep = keep & (sorted_e >= e_lo) & (sorted_e < e_lo + e_per)
    buf_idx = buf_idx - e_lo * capacity
    experts = torch.arange(e_lo, e_lo + e_per, device=dev)
    start = torch.searchsorted(sorted_e, experts, side="left")
    count = torch.searchsorted(sorted_e, experts, side="right") - start
    c = torch.arange(capacity, device=dev)
    src = (start[:, None] + c[None, :]).reshape(-1)
    filled = (c[None, :] < count[:, None]).reshape(-1)
    src = torch.where(filled, src, 0)
    buf = h2[tok_idx[src]] * filled[:, None].to(h2.dtype)
    out_buf = _expert_ffn(buf.reshape(e_per, capacity, D), params)
    out_buf = torch.cat([out_buf.reshape(e_per * capacity, D),
                         torch.zeros((1, D), dtype=h2.dtype, device=dev)])
    back = out_buf[torch.where(keep, buf_idx, e_per * capacity)]
    wk = w.reshape(-1)[order] * keep.to(torch.float32)
    contrib = back * wk[:, None].to(h2.dtype)          # sorted assignments
    # each token's K assignments, in sorted (= ascending expert) order
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=dev)
    mine = contrib[inv.reshape(T, K).sort(dim=-1).values]      # (T, K, D)
    out = mine[:, 0]
    for k in range(1, K):
        out = out + mine[:, k]
    return out, aux


def moe_ffn(params: MoE, x: torch.Tensor, cfg: ModelConfig,
            full_capacity: bool = False):
    """Pre-norm residual MoE FFN.  x: (B, S, D) -> (x + out, aux)."""
    B, S, d = x.shape
    h = rms_norm(x, params.norm, cfg.norm_eps)
    with ieee_fp32():
        out, aux = _moe_math(h.reshape(B * S, d), params, cfg,
                             _capacity(B * S, cfg, full_capacity))
    return x + out.reshape(B, S, d), aux



def moe_ffn_ep(params, x: torch.Tensor, cfg: ModelConfig,
               full_capacity: bool = False):
    """The expert-parallel MoE FFN on the active mesh: ``params`` holds
    this rank's ``E / n`` experts (the "model" axis split of
    ``moe_specs``, ``n`` its size), the norm and the router whole; ``x``
    is the token block (this rank's dp rows when the batch is split).
    Returns (x + out, aux), the same on every "model" rank."""
    mesh = ctx.get_mesh()
    tp = coll.live(mesh, ("model",))
    n = mesh.size(tp)
    E = cfg.moe.n_experts
    if E % n:
        raise ValueError(f"{E} experts do not split over {n} model ranks")
    e_per = E // n
    B, S, d = x.shape
    h = rms_norm(x, params.norm, cfg.norm_eps)
    # each rank computes its own experts' part from the shared tokens and
    # router: their gradients sum over the model ranks
    h2 = coll.replicated(h.reshape(B * S, d), mesh, tp)
    router = coll.replicated(params.router, mesh, tp)
    with ieee_fp32():
        out, aux = _moe_math(h2, params, cfg,
                             _capacity(B * S, cfg, full_capacity),
                             e_lo=mesh.index(tp) * e_per, e_per=e_per,
                             router=router)
    out = coll.all_reduce(out.to(torch.float32), mesh, tp).to(x.dtype)
    aux = coll.all_reduce(aux, mesh, tp) / n
    return x + out.reshape(B, S, d), aux
