"""Step builders of the port: train / prefill / decode, shared by
``launch/train.py``, the examples and ``chip_smoke.py``.

The train step differentiates ``lm_loss`` with autograd (the reference has
no hand-written backward either; ``torch.autograd.grad``, whose gradients
are never copied) on the ``"blocked"`` or ``"naive"``
attention path, and updates the parameters with ``optim.apply_gradients``
on the reference's tree (``convert.reference_tree``: layers stacked), so
its optimizer state is the reference's leaf for leaf.  The parameters stay
a ``Transformer`` updated in place.

On a mesh (``parallel.ctx``) the parameters are this rank's slices
(``convert.shard_params``), the optimizer state this rank's slices by
``optim.opt_state_specs``, and the train step takes the whole batch:
``models.model.lm_loss`` runs on this rank's dp rows and returns the mean
over the whole batch (vocab-parallel where "tp" divides the vocabulary),
the gradients come out summed over the dp ranks only (a tensor-parallel
block's "tp"-split gradients are this rank's own, its norms' the same on
every "model" rank), and the update reduces across slices where it must
(the clip's norm counts each leaf once: ``optim.global_norm``).  The sharding
assembly is the reference's: ``resolve_tree``, ``batch_specs``,
``stacked_cache_specs`` and the ``abstract_*`` shapes (on the ``meta``
device, PyTorch's ``eval_shape``).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import convert as C
from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import model as M
from repro_torch.optim import OptConfig, apply_gradients, init_opt_state
from repro_torch.parallel import ctx

Tree = Any


def trainable(params: M.Transformer) -> M.Transformer:
    """Turn gradients on for every parameter of ``params`` (in place;
    ``init_params`` makes them without, for serving)."""
    for p in params.parameters():
        p.requires_grad_(True)
    return params


def _take_grads(params: M.Transformer, cfg: ModelConfig) -> Tree:
    """The parameters' gradients in the reference's tree; the per-layer
    ``.grad`` buffers are released."""
    grads = C.reference_tree(params, cfg, leaf=lambda p: p.grad)
    for p in params.parameters():
        p.grad = None
    return grads


def _backward(loss: torch.Tensor, params: M.Transformer) -> None:
    """The gradients of ``loss`` into the trainable parameters' ``.grad``
    (left None for those it does not reach), as ``loss.backward()`` but
    through ``torch.autograd.grad``: ``backward``'s gradient accumulator
    keeps an incoming gradient's buffer as ``.grad`` only when nothing
    else refers to it at that moment, else copies it, and what else
    refers to it (a dispatch mode's objects awaiting the garbage
    collector) depends on when a collection last ran; so two runs of the
    same step counted other copies (``launch/dryrun.py``'s bytes).  The
    gradients returned here are the same tensors, never copied."""
    ps = [p for p in params.parameters() if p.requires_grad]
    for p, g in zip(ps, torch.autograd.grad(loss, ps, allow_unused=True)):
        p.grad = g


def loss_and_grads(params: M.Transformer, cfg: ModelConfig,
                   tokens: torch.Tensor, targets: torch.Tensor,
                   microbatches: int = 1,
                   image_embeds: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, Tree]:
    """(mean loss, gradients in the reference's tree).  ``microbatches`` >
    1 splits the batch into that many consecutive row slices and
    accumulates float32 gradients and the loss over them, then divides, as
    the reference's ``lax.scan`` does.  ``image_embeds`` (vision) go whole
    to every slice, as in the reference: there a slice of ``mb`` rows
    reshapes the whole batch's K/V to ``mb`` rows, each attending to
    ``microbatches`` images (``attention.cross_attention``)."""
    trainable(params)
    if microbatches == 1:
        loss = M.lm_loss(params, tokens, targets, cfg, image_embeds)
        _backward(loss, params)
        return loss.detach(), _take_grads(params, cfg)
    mb = tokens.shape[0] // microbatches
    loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
    grads = None
    for k in range(microbatches):
        rows = slice(k * mb, (k + 1) * mb)
        part = M.lm_loss(params, tokens[rows], targets[rows], cfg,
                         image_embeds)
        _backward(part, params)
        g = _take_grads(params, cfg)
        if grads is None:
            grads = T.map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                                device=x.device), g)
        grads = T.map(torch.add, grads, g)
        loss = loss + part.detach()
    return (loss / microbatches,
            T.map(lambda g: g / microbatches, grads))


def update_params(params: M.Transformer, grads: Tree, opt_state: Tree,
                  step, cfg: ModelConfig, opt_cfg: OptConfig) -> Tree:
    """The step's optimizer half: ``optim.apply_gradients`` on the
    reference's tree of ``params``, written back into ``params`` in place;
    returns the new optimizer state."""
    shardings = (resolve_tree(M.param_specs(cfg))
                 if ctx.get_mesh() is not None else None)
    with torch.no_grad():
        new, opt_state = apply_gradients(
            C.reference_tree(params, cfg, leaf=lambda p: p.detach()),
            grads, opt_state, step, opt_cfg, shardings)
        del grads
        C.load_reference_tree(params, new, cfg)
    return opt_state


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig,
                    microbatches: int = 1):
    """(params, opt_state, batch, step) -> (params, opt_state, {"loss"}).

    ``params`` is a ``Transformer`` (updated in place and returned),
    ``opt_state`` the reference's tree of ``optim.init_opt_state``,
    ``batch`` ``{"tokens", "targets"}`` (B, S) integer tensors ((B, S, C)
    for audio; vision adds ``"image_embeds"``), ``step``
    the 0-based step number.  Under ``attn_impl="pallas"`` the step
    raises (``attention.run_attention``: the flash kernel has no backward
    pass)."""

    def train_step(params, opt_state, batch, step):
        loss, grads = loss_and_grads(params, cfg, batch["tokens"],
                                     batch["targets"], microbatches,
                                     batch.get("image_embeds"))
        opt_state = update_params(params, grads, opt_state, step, cfg,
                                  opt_cfg)
        return params, opt_state, {"loss": loss}

    return train_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        return M.prefill(params, batch["tokens"], cfg,
                         image_embeds=batch.get("image_embeds"))
    return prefill_step


def make_decode_step(cfg: ModelConfig, seq_shard: bool = False):
    def decode_step(params, cache, batch):
        return M.decode_step(params, cache, batch["tokens"], batch["pos"],
                             cfg, seq_shard=seq_shard)
    return decode_step


# --------------------------- sharding assembly ------------------------------

def resolve_tree(spec_tree: Tree):
    """Logical spec tree -> ``Sharding`` tree on the active mesh (None
    leaves with no mesh)."""
    return ctx.map_specs(lambda s: ctx.named_sharding(tuple(s)), spec_tree)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Logical specs of the input batch of a shape cell (the reference's
    ``batch_specs``): tokens over "dp"; a decode batch smaller than dp
    whole."""
    dp = ctx.axis_size("dp")
    tok = ("dp", None, None) if cfg.frontend == "audio" else ("dp", None)
    if shape.mode == "train":
        s = {"tokens": tok, "targets": tok}
    elif shape.mode == "prefill":
        s = {"tokens": tok}
    else:
        btok = tok if shape.global_batch >= dp else (
            (None, None, None) if cfg.frontend == "audio" else (None, None))
        s = {"tokens": btok, "pos": (btok[0],)}
    if cfg.frontend == "vision":
        s["image_embeds"] = ("dp", None, None)
    return s


def abstract_params(cfg: ModelConfig) -> Tree:
    """The reference's parameter tree as ``meta`` tensors: the shapes and
    dtypes of ``jax.eval_shape(init_params)``, nothing allocated."""
    with ctx.use_mesh(None):
        return C.reference_tree(M.skeleton(cfg, "meta"), cfg)


def abstract_opt_state(cfg: ModelConfig, opt_cfg: OptConfig) -> Tree:
    return init_opt_state(abstract_params(cfg), opt_cfg)


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The reference's decode cache tree (``init_cache``: every leaf
    stacked over periods) as ``meta`` tensors."""
    with ctx.use_mesh(None):
        return C.reference_cache(
            M.init_cache(cfg, batch, max_len, device="meta"), cfg,
            leaf=lambda t: t)


def stacked_cache_specs(cfg: ModelConfig, batch: int) -> dict:
    """Cache logical specs with the leading period-stack dim prepended."""
    return ctx.map_specs(lambda s: (None,) + tuple(s),
                         M.cache_specs(cfg, batch))
