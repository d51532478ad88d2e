"""Carry state across between the reference package and the port.

The system's "weights" are its genomes and evolution state, and the LM's
parameters and optimizer state.  These helpers take arrays from the JAX
package (anything ``numpy.asarray`` reads: genome arrays, a stacked
``EvolveState`` with its PRNG keys, threshold matrices, a model parameter
tree, a decode cache, an optimizer state) and return the port's tensors on
a given device, so both packages can be started from the same state;
``reference_params``, ``reference_cache`` and ``reference_opt_state`` go
the other way, into the reference's trees of numpy arrays.  bfloat16
travels as numpy's 2-byte void records (the bytes of the bfloat16 value,
what the reference's checkpoints hold), or as any array ``numpy.asarray``
widens exactly to float32.  Nothing here imports JAX.

On a mesh (``parallel.ctx``) the port's parameters are this rank's slices
of the reference's: ``param_shardings`` maps the reference's spec tree
(``models.model.param_specs``) onto the port's parameter names,
``shard_params`` cuts a whole model to this rank's slices, and
``model_params`` / ``cache`` place the reference's whole arrays as local
slices while ``reference_params`` / ``reference_cache`` gather them back.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.checkpoint.store import BF16_RECORD, to_host
from repro_torch.configs.base import ModelConfig
from repro_torch.core.evolve import EvolveState
from repro_torch.core.genome import Genome
from torch import nn

from repro_torch.models.model import (Transformer, layer_cache_shardings,
                                      param_specs, skeleton)
from repro_torch.models.ssm import SSMState
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import ctx


def tensor(x, dtype: torch.dtype, device: torch.device | str = "cpu"
           ) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def genome(g, device: torch.device | str = "cpu") -> Genome:
    """A genome (``.nodes``, ``.outs``; any leading dims) as int32 tensors."""
    return Genome(tensor(g.nodes, torch.int32, device),
                  tensor(g.outs, torch.int32, device))


def keys(k, device: torch.device | str = "cpu") -> torch.Tensor:
    """uint32 PRNG key words (..., 2) as the port's int64 key tensor."""
    return torch.as_tensor(np.array(k, dtype=np.uint32).astype(np.int64),
                           device=device)


def thresholds(t, device: torch.device | str = "cpu") -> torch.Tensor:
    return tensor(t, torch.float32, device)


def evolve_state(s, device: torch.device | str = "cpu") -> EvolveState:
    """An evolution state with the reference's ``EvolveState`` fields."""
    f32 = lambda x: tensor(x, torch.float32, device)
    return EvolveState(parent=genome(s.parent, device),
                       parent_fit=f32(s.parent_fit),
                       parent_metrics=f32(s.parent_metrics),
                       parent_power=f32(s.parent_power),
                       best=genome(s.best, device),
                       best_fit=f32(s.best_fit),
                       key=keys(s.key, device))


def to_tensor(x, dtype: torch.dtype, device: torch.device | str = "cpu"
              ) -> torch.Tensor:
    """A leaf (tensor, numpy array, 2-byte void records of bfloat16, or
    anything ``numpy.asarray`` reads) as a ``dtype`` tensor on
    ``device``."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=device, dtype=dtype)
    a = np.asarray(x)
    if a.dtype == BF16_RECORD:
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return t.to(device=device, dtype=dtype)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)          # ml_dtypes' bfloat16, exactly
    return torch.as_tensor(np.array(a), device=device).to(dtype)


# each block's leaves in the reference's trees (``init_attention``, with
# ``cross=True`` for "cross", ``init_ssm``, ``init_mlp`` (with
# ``act="gelu"`` for "gelu": no w_gate), ``init_moe``)
_LEAVES = {
    "attn": ("norm", "wk", "wo", "wq", "wv"),
    "cross": ("gate", "norm", "wk", "wo", "wq", "wv"),
    "ssm": ("a_log", "conv_bc_w", "conv_x_w", "d_skip", "dt_bias",
            "gate_norm", "norm", "w_bc", "w_dt", "w_out", "w_x", "w_z"),
    "mlp": ("norm", "w_down", "w_gate", "w_up"),
    "gelu": ("norm", "w_down", "w_up"),
    "moe": ("norm", "router", "w_down", "w_gate", "w_up"),
}


def _layer_names(cfg: ModelConfig):
    """(port name, reference (period slot, stack index), part, leaf) of
    every per-layer parameter: layer ``i`` of the port is period ``i //
    len(period)``, slot ``i % len(period)``; its mixer is an attention,
    cross-attention or SSM block, its FFN (if it has one) a dense MLP or an
    MoE.  A cross layer's scalar ``gate`` is stacked to (n_periods,) in the
    reference's tree, like every other leaf."""
    period = len(cfg.period)
    for i in range(cfg.n_layers):
        spec = cfg.period[i % period]
        mixer = ("ssm" if spec.kind == "ssm" else
                 "cross" if spec.cross_attn else "attn")
        parts = [("mixer", mixer)]
        if spec.has_ffn:
            parts.append(("ffn", "moe" if spec.moe else
                          "mlp" if cfg.act == "swiglu" else "gelu"))
        for part, block in parts:
            for name in _LEAVES[block]:
                yield (f"layers.{i}.{part}.{name}", f"layer{i % period}",
                       i // period, part, name)


def param_shardings(cfg: ModelConfig) -> dict:
    """Each of the port's parameter names -> its ``Sharding`` on the active
    mesh (a layer's: the reference's stacked spec without its leading
    period dim)."""
    specs = param_specs(cfg)
    out = {"embed.tokens": specs["embed"]["tokens"],
           "final_norm": specs["final_norm"]}
    if "lm_head" in specs:
        out["lm_head"] = specs["lm_head"]
    for name, slot, _, part, key in _layer_names(cfg):
        out[name] = specs["layers"][slot][part][key][1:]
    return {k: ctx.named_sharding(v) for k, v in out.items()}


def shard_params(params: Transformer, cfg: ModelConfig) -> Transformer:
    """Cut the whole ``params`` to this rank's slices on the active mesh, in
    place (each parameter's ``sharding`` attribute says how; its gathers
    are ``parallel.collectives.materialize``).  Returns ``params``."""
    shardings = param_shardings(cfg)
    with torch.no_grad():
        for name, p in params.named_parameters():
            sh = shardings[name]
            p.data = coll.place(p.data, sh)
            p.sharding = sh
    return params


def reference_tree(params: Transformer, cfg: ModelConfig,
                   leaf=lambda p: p) -> dict:
    """``leaf`` of every parameter (the parameter itself by default, or
    its gradient) in the reference's tree: ``embed.tokens``,
    ``final_norm``, ``lm_head`` when untied (or audio), and
    ``layers.layer{j}`` with
    each leaf stacked over ``n_periods`` (a new tensor on the parameters'
    device)."""
    own = dict(params.named_parameters())
    slots: dict = {}
    for name, slot, _, part, key in _layer_names(cfg):
        slots.setdefault(slot, {}).setdefault(part, {}).setdefault(
            key, []).append(leaf(own[name]))
    tree = {"embed": {"tokens": leaf(own["embed.tokens"])},
            "final_norm": leaf(own["final_norm"]),
            "layers": T.map(torch.stack, slots)}
    if "lm_head" in own:
        tree["lm_head"] = leaf(own["lm_head"])
    return tree


def load_reference_tree(params: Transformer, tree, cfg: ModelConfig
                        ) -> Transformer:
    """Copy a parameter tree in the reference's layout (leaves: tensors,
    numpy arrays, bfloat16 records, JAX arrays) into ``params``, each leaf
    cast to its parameter's dtype and device; returns ``params``.  A
    sharded parameter takes its slice of a leaf of the whole shape, or a
    leaf of its own shape as it is."""
    own = dict(params.named_parameters())
    state = {"embed.tokens": tree["embed"]["tokens"],
             "final_norm": tree["final_norm"]}
    if "lm_head" in tree:
        state["lm_head"] = tree["lm_head"]
    for name, slot, idx, part, key in _layer_names(cfg):
        state[name] = tree["layers"][slot][part][key][idx]
    if set(state) != set(own):
        raise ValueError(f"parameter names differ: reference-only "
                         f"{sorted(set(state) - set(own))}, port-only "
                         f"{sorted(set(own) - set(state))}")
    with torch.no_grad():
        for name, p in own.items():
            src = state[name]
            sh = getattr(p, "sharding", None)
            if sh is not None and tuple(src.shape) != tuple(p.shape):
                src = src[sh.index(src.shape)]
            if not isinstance(src, torch.Tensor):
                src = to_tensor(src, p.dtype, p.device)
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)}, "
                                 f"expected {tuple(p.shape)}")
            p.copy_(src)
    return params


def model_params(tree, cfg: ModelConfig, device: torch.device | str = "cpu"
                 ) -> Transformer:
    """The reference's parameter tree as the port's ``Transformer``.

    ``tree`` is ``repro.models.model.init_params``'s output (or
    ``reference_params``'): ``embed.tokens`` ((C, V, D) for audio),
    ``final_norm``, ``lm_head`` when the head is untied ((C, D, V) for
    audio), and ``layers.layer{j}`` with every leaf
    stacked over ``n_periods``.  Values arrive unchanged (bfloat16 through
    float32 or as its bits).  On a mesh, this rank's slices."""
    if ctx.get_mesh() is None:
        return load_reference_tree(skeleton(cfg, device), tree, cfg)
    params = skeleton(cfg, "meta")
    shardings = param_shardings(cfg)
    for name, p in list(params.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        local = nn.Parameter(torch.empty(
            shardings[name].shard_shape(p.shape), dtype=p.dtype,
            device=device), requires_grad=False)
        local.sharding = shardings[name]
        setattr(params.get_submodule(owner), leaf, local)
    return load_reference_tree(params, tree, cfg)


def reference_params(params: Transformer, cfg: ModelConfig) -> dict:
    """``params`` as the reference's parameter tree of numpy arrays (the
    inverse of ``model_params``; bfloat16 leaves as 2-byte records): whole
    leaves, gathered on a mesh."""
    return T.map(to_host, reference_tree(
        params, cfg, leaf=lambda p: coll.gather(p.detach(),
                                                getattr(p, "sharding", None))))


def _leaf_tensor(x, device) -> torch.Tensor:
    """A leaf as a tensor of its own dtype (bfloat16 from records or
    ml_dtypes' bfloat16)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device)
    a = np.asarray(x)
    if a.dtype == BF16_RECORD or a.dtype.name == "bfloat16":
        return to_tensor(a, torch.bfloat16, device)
    return torch.as_tensor(np.array(a), device=device)


def cache(tree, cfg: ModelConfig, device: torch.device | str = "cpu"
          ) -> list:
    """The reference's decode cache (``init_cache`` / ``prefill`` /
    ``decode_step`` output: ``layer{j}`` of each period slot, every leaf
    stacked over ``n_periods``; an ``SSMState`` for SSM slots, a ``{"k",
    "v"}`` dict otherwise, (B, n_img_tokens, Hkv, hd) for cross slots) as
    the port's per-layer list, each leaf in its own dtype on
    ``device``: on a mesh, this rank's slices (``models.model.
    cache_specs``)."""
    period = len(cfg.period)
    out = []
    for i in range(cfg.n_layers):
        lc, idx = tree[f"layer{i % period}"], i // period
        if cfg.period[i % period].kind == "ssm":
            lc = SSMState(*(_leaf_tensor(getattr(lc, f)[idx], device)
                            for f in SSMState._fields))
        else:
            lc = {k: _leaf_tensor(lc[k][idx], device) for k in ("k", "v")}
        out.append(_cache_layout(lc, cfg, i, None, coll.place))
    return out


def _cache_layout(lc, cfg: ModelConfig, i: int, batch: int | None, move):
    """``move(leaf, sharding)`` over layer ``i``'s cache on the active mesh
    (``lc`` itself with no mesh); ``batch`` defaults to the leaves'."""
    if ctx.get_mesh() is None:
        return lc
    first = lc[0] if isinstance(lc, SSMState) else lc["k"]
    sh = layer_cache_shardings(cfg, batch or first.shape[0], i)
    if isinstance(lc, SSMState):
        return SSMState(*(move(t, s) for t, s in zip(lc, sh)))
    return {k: move(lc[k], sh[k]) for k in lc}


def reference_cache(cache: list, cfg: ModelConfig,
                    batch: int | None = None, leaf=to_host) -> dict:
    """The port's per-layer cache as the reference's tree of numpy arrays
    (the inverse of ``cache``; ``SSMState``s as the port's named tuple,
    which has the reference's fields).  On a mesh the slices are gathered:
    ``batch`` is then the whole batch.  ``leaf`` maps each stacked tensor
    (to numpy by default)."""
    period = len(cfg.period)
    slots: dict = {}
    for i, lc in enumerate(cache):
        lc = _cache_layout(lc, cfg, i, batch, coll.gather)
        slots.setdefault(f"layer{i % period}", []).append(lc)
    stack = lambda xs: leaf(torch.stack([x.detach() for x in xs]))
    tree = {}
    for slot, lcs in slots.items():
        if isinstance(lcs[0], SSMState):
            tree[slot] = SSMState(*(stack([getattr(c, f) for c in lcs])
                                    for f in SSMState._fields))
        else:
            tree[slot] = {k: stack([c[k] for c in lcs]) for k in ("k", "v")}
    return tree


def opt_state(tree, device: torch.device | str = "cpu") -> dict:
    """An optimizer state of the reference (``repro.optim.init_opt_state``
    / ``apply_gradients`` output, any of its three optimizers, or a loaded
    checkpoint's) as the port's: the same tree, float32 and int8 tensors
    on ``device``."""
    def leaf(x):
        a = np.asarray(x) if not isinstance(x, torch.Tensor) else x
        dtype = torch.int8 if a.dtype in (np.int8, torch.int8) \
            else torch.float32
        return to_tensor(x, dtype, device)
    return T.map(leaf, tree)


def reference_opt_state(state) -> dict:
    """The port's optimizer state as the reference's tree of numpy
    arrays."""
    return T.map(to_host, state)
