"""Optimizers: AdamW, block-wise 8-bit AdamW, Adafactor.

The port of ``repro/optim/optimizer.py``: pure functions on nested-dict
trees of tensors (``repro_torch.tree``), not ``torch.optim``, so a state's
tree is the reference's leaf for leaf and checkpoints cross between the
packages.  Parameters arrive in the reference's layout, layers stacked on a
leading axis (``convert.reference_tree``): Adafactor factors and clips a
stacked leaf as a whole, as the reference does.  Float32 throughout, with
the reference's operand order; the step enters as a float32 tensor, so the
bias corrections are float32 powers as in the reference.

On a mesh, ``apply_gradients`` takes ``shardings`` (a ``parallel.ctx.
Sharding`` per parameter leaf, ``launch.steps.resolve_tree`` of
``models.model.param_specs``) and updates this rank's slices, its state
laid out by ``opt_state_specs``.  What reduces across a leaf's slices
reduces across the ranks that hold them, and only those: the global norm
sums each leaf's local squares over the axes that split it (a replicated
leaf counts once); the 8-bit row absmax over a split last axis is a MAX
(exact in any order); Adafactor's row and column means and its RMS clip
sum over the axes that split the reduced dims.  Given the same whole
gradients the sharded update is the unsharded one: AdamW and 8-bit AdamW
bit for bit but for the clip scale (a float32 sum of the squares in
another order, when the norm exceeds ``clip_norm``), Adafactor within
float32 rounding where a reduced dim is split (a sum over ranks, then a
division, for ``mean``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import tree as T
from repro_torch.optim.schedule import lr_at
from repro_torch.parallel import collectives as coll

Tree = Any
F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"          # adamw | adamw8bit | adafactor
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _split(sh, dims=None) -> tuple:
    """The live axes splitting ``dims`` of a leaf laid out by ``sh`` (all
    its dims by default; none without a sharding)."""
    if sh is None:
        return ()
    dims = range(len(sh.dims)) if dims is None else dims
    return coll.live(sh.mesh, tuple(a for d in dims for a in sh.axes(d)))


def _sum_over(x: torch.Tensor, sh, axes: tuple) -> torch.Tensor:
    return coll.all_reduce_raw(x, sh.mesh, axes) if axes else x


def global_norm(tree: Tree, shardings: Tree | None = None) -> torch.Tensor:
    """√(Σ over leaves of Σ x²), in float32; with ``shardings``, each
    leaf's local sum is summed over the axes that split it."""
    if shardings is None:
        sq = [torch.sum(torch.square(x.to(F32))) for x in T.leaves(tree)]
    else:
        sq = [_sum_over(torch.sum(torch.square(x.to(F32))), sh, _split(sh))
              for x, sh in zip(T.leaves(tree), T.leaves(shardings))]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(grads: Tree, max_norm: float,
                        shardings: Tree | None = None):
    """(float32 gradients scaled to a global norm of at most
    ``max_norm``, the norm before scaling)."""
    norm = global_norm(grads, shardings)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return T.map(lambda g: g.to(F32) * scale, grads), norm


# ----------------------------- 8-bit moments --------------------------------
# Per-row dynamic int8: sign(x)·√(|x| / rowmax) · 127, rounded half to even,
# with the row's max |x| (at least 1e-12) as a float32 scale.  q keeps the
# parameter's shape; the scale drops its last axis.

def _q8(x: torch.Tensor, sh=None):
    """``sh``: the leaf's sharding (its last axis split: the row max is
    the max over the ranks along it)."""
    if x.ndim == 0:
        q, s = _q8(x.reshape(1))
        return q.reshape(()), s.reshape(())
    amax = x.abs().amax(dim=-1, keepdim=True)
    axes = _split(sh, (x.ndim - 1,))
    if axes:
        amax = coll.all_reduce_raw(amax, sh.mesh, axes, "max")
    scale = torch.clamp_min(amax, 1e-12)
    norm = x / scale
    q = torch.clamp(torch.round(127.0 * torch.sign(norm)
                                * torch.sqrt(norm.abs())), -127, 127)
    return q.to(torch.int8), scale[..., 0].to(F32)


def _dq8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    qf = q.to(F32) / 127.0
    if q.ndim == 0:
        return torch.sign(qf) * qf * qf * scale
    return torch.sign(qf) * qf * qf * scale[..., None]


# ----------------------------- state init -----------------------------------

def init_opt_state(params: Tree, cfg: OptConfig) -> Tree:
    """Zero state of ``cfg.name`` for ``params`` (the reference's tree)."""
    f32 = lambda p: torch.zeros(p.shape, dtype=F32, device=p.device)
    if cfg.name == "adamw":
        return {"m": T.map(f32, params), "v": T.map(f32, params)}
    if cfg.name == "adamw8bit":
        def q0(p):
            q, s = _q8(f32(p))
            return {"q": q, "s": s}
        return {"m": T.map(q0, params), "v": T.map(q0, params)}
    if cfg.name == "adafactor":
        def fac(p):
            if p.ndim >= 2:
                return {"row": torch.zeros(p.shape[:-1], dtype=F32,
                                           device=p.device),
                        "col": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                           dtype=F32, device=p.device)}
            return {"v": f32(p)}
        return {"fac": T.map(fac, params)}
    raise ValueError(cfg.name)


# ----------------------------- updates --------------------------------------

def _adam_update(g, m, v, step, cfg: OptConfig):
    m = cfg.beta1 * m + (1 - cfg.beta1) * g
    v = cfg.beta2 * v + (1 - cfg.beta2) * g * g
    t = step + 1
    mh = m / (1 - torch.pow(torch.tensor(cfg.beta1, dtype=F32), t))
    vh = v / (1 - torch.pow(torch.tensor(cfg.beta2, dtype=F32), t))
    return mh / (torch.sqrt(vh) + cfg.eps), m, v


def _decayed(p, u, lr, cfg: OptConfig):
    p32 = p.to(F32)
    return (p32 - lr * (u + cfg.weight_decay * p32)).to(p.dtype)


def _mean(x: torch.Tensor, dim, sh, over: tuple, keepdim=False):
    """``x.mean(dim)`` of the whole leaf: a sum over the ranks along the
    live axes ``over`` (splitting the reduced dims), then a division."""
    if not over:
        return x.mean(dim, keepdim=keepdim) if dim is not None else x.mean()
    s = x.sum(dim, keepdim=keepdim) if dim is not None else x.sum()
    n = (x.shape[dim] if dim is not None else x.numel()) * sh.mesh.size(over)
    return coll.all_reduce_raw(s, sh.mesh, over) / n


def _adafactor(p, g, fac, lr, cfg: OptConfig, sh=None):
    g2 = g * g + 1e-30
    nd = p.ndim
    if p.ndim >= 2:
        row = cfg.beta2 * fac["row"] + (1 - cfg.beta2) * _mean(
            g2, -1, sh, _split(sh, (nd - 1,)))
        col = cfg.beta2 * fac["col"] + (1 - cfg.beta2) * _mean(
            g2, -2, sh, _split(sh, (nd - 2,)))
        vhat = (row[..., None] * col[..., None, :]
                / torch.clamp_min(_mean(row, -1, sh, _split(sh, (nd - 2,)),
                                        keepdim=True)[..., None], 1e-30))
        new_fac = {"row": row, "col": col}
    else:
        v = cfg.beta2 * fac["v"] + (1 - cfg.beta2) * g2
        vhat, new_fac = v, {"v": v}
    u = g / torch.clamp_min(torch.sqrt(vhat), cfg.eps)
    # update clipping (Adafactor's RMS rule), over the whole leaf
    rms = torch.sqrt(_mean(u * u, None, sh, _split(sh)) + 1e-30)
    u = u / torch.clamp_min(rms, 1.0)
    return _decayed(p, u, lr, cfg), new_fac


def apply_gradients(params: Tree, grads: Tree, state: Tree, step,
                    cfg: OptConfig, shardings: Tree | None = None
                    ) -> tuple[Tree, Tree]:
    """One optimizer step: (new params, new state).  ``step`` is the
    0-based step number (an int or a tensor).  The state's trees follow
    ``params``' (a parameter's leaf may be a dict of state arrays).
    ``shardings``: each parameter leaf's ``Sharding`` on a mesh (the
    leaves are this rank's slices)."""
    grads, _ = clip_by_global_norm(grads, cfg.clip_norm, shardings)
    shs = T.map(lambda _: None, params) if shardings is None else shardings
    dev = T.leaves(params)[0].device
    step = torch.as_tensor(step, dtype=F32).to(dev)
    lr = lr_at(step, cfg).to(dev)
    pick = lambda res, i: T.map(lambda r: r[i], res)

    if cfg.name == "adamw":
        def upd(p, g, m, v):
            u, m2, v2 = _adam_update(g, m, v, step, cfg)
            return _decayed(p, u, lr, cfg), m2, v2
        res = T.map(upd, params, grads, state["m"], state["v"])
        return pick(res, 0), {"m": pick(res, 1), "v": pick(res, 2)}

    if cfg.name == "adamw8bit":
        def upd(p, g, mq, vq, sh):
            m = _dq8(mq["q"], mq["s"])
            v = _dq8(vq["q"], vq["s"])
            u, m2, v2 = _adam_update(g, m, v, step, cfg)
            (qm, sm), (qv, sv) = _q8(m2, sh), _q8(v2, sh)
            return (_decayed(p, u, lr, cfg), {"q": qm, "s": sm},
                    {"q": qv, "s": sv})
        res = T.map(upd, params, grads, state["m"], state["v"], shs)
        return pick(res, 0), {"m": pick(res, 1), "v": pick(res, 2)}

    if cfg.name == "adafactor":
        res = T.map(lambda p, g, f, sh: _adafactor(p, g, f, lr, cfg, sh),
                    params, grads, state["fac"], shs)
        return pick(res, 0), {"fac": pick(res, 1)}

    raise ValueError(cfg.name)


def opt_state_specs(param_specs: Tree, cfg: OptConfig) -> Tree:
    """Logical specs of the optimizer state mirroring the parameters'
    (``repro.optim.opt_state_specs``): AdamW's moments take the
    parameter's spec; 8-bit ``q`` too and its row scale drops the last
    axis; Adafactor's ``row`` is ``s[:-1]``, ``col`` ``s[:-2] + s[-1:]``,
    and a vector's ``v`` is ``s``."""
    from repro_torch.parallel import ctx
    if cfg.name == "adamw":
        return {"m": param_specs, "v": param_specs}
    if cfg.name == "adamw8bit":
        q = ctx.map_specs(lambda s: {"q": tuple(s),
                                     "s": tuple(s)[:-1] if len(s) else ()},
                          param_specs)
        return {"m": q, "v": q}
    if cfg.name == "adafactor":
        def fac(s):
            s = tuple(s)
            if len(s) >= 2:
                return {"row": s[:-1], "col": s[:-2] + s[-1:]}
            return {"v": s}
        return {"fac": ctx.map_specs(fac, param_specs)}
    raise ValueError(cfg.name)
