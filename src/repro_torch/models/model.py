"""Decoder-only LM: parameters, forward, loss, prefill and decode.

The port of ``repro/models/model.py`` for stacks of self-attention,
gated cross-attention and SSM mixers with a dense SwiGLU or GELU MLP, an
MoE FFN or no FFN after each, and a tied or untied output head (per
codebook for the audio front end).  Layer ``i`` is ``cfg.period[i %
len(period)]``, so a hybrid period (jamba: attention at slot 3 of 8, MoE
on the odd slots) is walked as the reference's ``_apply_period`` walks
it.  ``Transformer`` holds the parameters as ``nn.Module``s on an
explicit device and dtype; the apply functions mirror the reference's
names.  Layers are walked with a Python loop (the reference scans over
periods stacked on a leading axis; ``convert.model_params`` unstacks
them).  ``backbone``, ``forward_train`` and ``lm_loss`` carry the MoE
load-balancing aux loss summed over the layers (``ce + 0.01 · aux``, as
the reference).  Cross-attention layers attend to ``image_embeds`` (B,
n_img_tokens, d_model), which ``backbone``, ``forward_train``, ``lm_loss``
and ``prefill`` take as the reference's do.  The audio front end takes
(B, S, n_codebooks) tokens; its logits are (B, S, n_codebooks, vocab) and
its loss the mean CE over every codebook (never chunked).  With
``cfg.remat`` and gradients enabled each layer is
checkpointed (``torch.utils.checkpoint``) as the reference's
``jax.checkpoint`` policies do.  Caches are a list with one entry per
layer: a ``{"k", "v"}`` dict, each (B, max_len, Hkv, hd), for attention,
the same of (B, n_img_tokens, Hkv, hd) for cross-attention (filled by the
prefill from the embeddings, read and left unchanged by decode), an
``ssm.SSMState`` for SSM layers; ``decode_step`` updates the list in
place.  ``prefill`` and ``decode_step`` build no autograd graph.

On a mesh (``parallel.ctx``; its docstring says how the compute is laid
out) the parameters are this rank's slices (``convert.shard_params``,
by ``param_specs``), the caches this rank's slices by ``cache_specs``,
and every entry point takes the whole batch on every rank and returns
whole logits: it runs on this rank's dp rows when the batch divides over
dp.  Where the "tp" axes divide them, self- and cross-attention, the SSM
mixer, the dense MLP, the embedding and the head compute this rank's
heads, columns and vocabulary (``parallel.ctx``'s docstring): ``_vocab_tp``
for the embedding and head, ``_mixer_tp`` (``attention.attention_tp``,
``ssm.ssm_tp``), ``layers.mlp_tp``; the loss is then a vocab-parallel
cross-entropy.  Self-attention whose query heads do not divide runs as
head groups × head_dim slices (``_heads``; a prefill moves its caches to
their layout at rest in one all-to-all, ``_grouped_to_rest``), and a
vocabulary that does not divide leaves the token table's d_model split
(``_embed_cols``: the embedding gathers the rank's columns, the tied head
all-reduces its partial logits).  MoE layers run expert-parallel
(``moe.moe_ffn_ep``) where the "model" axis divides the experts
(``_use_ep``), else as the function of the whole batch.  ``decode_step(seq_shard=True)`` attends to a cache
whose sequence is split over the dp axes ("sp").  A self-attention cache
whose kv heads do not divide over "tp" splits head_dim at rest, and
``decode_step`` computes on that split with no gather of it
(``_decode_hd``, ``attention.decode_self_attention(hd_axes=)``).
"""
from __future__ import annotations

import contextlib
import types

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.layers import (MLP, Embed, dense_init, embed_specs,
                                       embed_tokens, init_embed, init_mlp,
                                       mlp, mlp_specs, mlp_tp, param,
                                       rms_norm)
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import ctx


class Layer(nn.Module):
    def __init__(self, mixer: nn.Module, ffn: nn.Module | None):
        super().__init__()
        self.mixer = mixer
        self.ffn = ffn


class Transformer(nn.Module):
    def __init__(self, cfg: ModelConfig, embed: Embed, layers: list[Layer],
                 device):
        super().__init__()
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.final_norm = param((cfg.d_model,), cfg.pdtype(), device)
        if cfg.frontend == "audio":
            self.lm_head = param((cfg.n_codebooks, cfg.d_model, cfg.vocab),
                                 cfg.pdtype(), device)
        elif not cfg.tie_embeddings:
            self.lm_head = param((cfg.d_model, cfg.vocab), cfg.pdtype(),
                                 device)


def layer_spec(cfg: ModelConfig, i: int) -> LayerSpec:
    """The spec of layer ``i``: its slot in the repeating period."""
    return cfg.period[i % len(cfg.period)]


def _new_layer(cfg: ModelConfig, spec: LayerSpec, device,
               gen: torch.Generator | None) -> Layer:
    """One layer of ``spec``: drawn from ``gen`` (mixer first), or left
    uninitialized when ``gen`` is None."""
    if spec.kind == "ssm":
        mixer = (SSM.init_ssm(gen, cfg, device) if gen is not None
                 else SSM.SSM(cfg, device))
    else:
        cross = spec.cross_attn
        mixer = (A.init_attention(gen, cfg, device, cross) if gen is not None
                 else A.Attention(cfg, device, cross))
    ffn = None
    if spec.has_ffn and spec.moe:
        ffn = (MOE.init_moe(gen, cfg, device) if gen is not None
               else MOE.MoE(cfg, device))
    elif spec.has_ffn:
        ffn = (init_mlp(gen, cfg, device) if gen is not None
               else MLP(cfg, device))
    return Layer(mixer, ffn)


def skeleton(cfg: ModelConfig, device) -> Transformer:
    """An uninitialized ``Transformer`` of ``cfg`` on ``device`` (``meta``
    allocates nothing)."""
    layers = [_new_layer(cfg, layer_spec(cfg, i), device, None)
              for i in range(cfg.n_layers)]
    return Transformer(cfg, Embed(cfg, device), layers, device)


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Transformer:
    """Random parameters from ``gen``, on the generator's device, with the
    reference's distributions: projections N(0, 1/d_in), the embedding and
    an untied (or audio) ``lm_head`` N(0, 0.02²), norms one, cross
    layers' gates zero; the MoE and SSM blocks' as ``moe.init_moe`` and
    ``ssm.init_ssm`` say."""
    device = gen.device
    embed = init_embed(gen, cfg, device)
    layers = [_new_layer(cfg, layer_spec(cfg, i), device, gen)
              for i in range(cfg.n_layers)]
    params = Transformer(cfg, embed, layers, device)
    params.final_norm.fill_(1.0)
    if hasattr(params, "lm_head"):
        dense_init(gen, params.lm_head, scale=0.02)
    return params


# ------------------------------ sharding -------------------------------------

def _period_specs(cfg: ModelConfig) -> dict:
    p = {}
    for i, spec in enumerate(cfg.period):
        if spec.kind == "ssm":
            mix = SSM.ssm_specs(cfg)
        else:
            mix = A.attention_specs(cfg, cross=spec.cross_attn)
        lp = {"mixer": mix}
        if spec.has_ffn:
            lp["ffn"] = MOE.moe_specs(cfg) if spec.moe else mlp_specs(cfg)
        p[f"layer{i}"] = lp
    return p


def param_specs(cfg: ModelConfig) -> dict:
    """The logical specs of the reference's parameter tree
    (``repro.models.model.param_specs``: ``layers.layer{j}`` stacked over
    periods, so each leaf's spec starts with None); ``convert`` maps them
    onto the port's parameters."""
    layer = ctx.map_specs(lambda s: (None,) + tuple(s), _period_specs(cfg))
    specs = {"embed": embed_specs(cfg), "layers": layer,
             "final_norm": (None,)}
    if cfg.frontend == "audio":
        specs["lm_head"] = (None, None, "tp")
    elif not cfg.tie_embeddings:
        specs["lm_head"] = (None, "tp")
    return specs


def cache_specs(cfg: ModelConfig, batch: int) -> dict:
    """Logical specs of one period's caches (``repro.models.model.
    cache_specs``): the batch over "dp"; kv heads over "tp" when that
    divides, else head_dim, else nothing; when the batch is smaller than
    dp, a self-attention cache's sequence over "sp" (heads whole)."""
    seq_shard = batch < ctx.axis_size("dp")
    tp = ctx.axis_size("tp")
    if cfg.n_kv_heads % max(tp, 1) == 0:
        kv_spec = ("dp", None, "tp", None)
    elif cfg.hd % max(tp, 1) == 0:
        kv_spec = ("dp", None, None, "tp")
    else:
        kv_spec = ("dp", None, None, None)
    c = {}
    for i, spec in enumerate(cfg.period):
        if spec.kind == "ssm":
            c[f"layer{i}"] = SSM.SSMState(conv_x=(None, None, "tp"),
                                          conv_bc=(None, None, None),
                                          ssm=(None, "tp", None, None))
        elif spec.cross_attn or not seq_shard:
            c[f"layer{i}"] = {"k": kv_spec, "v": kv_spec}
        else:
            c[f"layer{i}"] = {"k": (None, "sp", None, None),
                              "v": (None, "sp", None, None)}
    return c


def _use_ep(cfg: ModelConfig) -> bool:
    """Expert parallelism: the active mesh's "model" axis is larger than 1
    and divides the experts."""
    mesh = ctx.get_mesh()
    return (mesh is not None and "model" in mesh.axis_names
            and mesh.shape["model"] > 1
            and cfg.moe.n_experts % mesh.shape["model"] == 0)


def _dp_split(batch: int) -> bool:
    """Whether a batch of ``batch`` rows runs split over the active mesh's
    dp axes: when it has at least one row a dp rank (it must divide)."""
    dp = ctx.axis_size("dp")
    if dp <= 1 or batch < dp:
        return False
    if batch % dp:
        raise ValueError(f"a batch of {batch} does not split over {dp} "
                         f"dp ranks")
    return True


def _rows(t: torch.Tensor | None, split: bool):
    """This rank's dp rows of a whole-batch tensor (the batch split at
    entry, where the reference constrains activations to "dp")."""
    if t is None or not split:
        return t
    return ctx.shard(t, "dp")


def _dp(mesh) -> tuple:
    return coll.live(mesh, ctx.axes_of("dp"))


def _all_rows(t: torch.Tensor, split: bool) -> torch.Tensor:
    """Every dp rank's rows of ``t``, in order (differentiable)."""
    if not split:
        return t
    mesh = ctx.get_mesh()
    return coll.all_gather(t, mesh, _dp(mesh), 0)


def _vocab_tp(cfg: ModelConfig) -> tuple:
    """The live "tp" axes the embedding's rows and the head's columns
    split over in the compute: those the vocabulary divides over (it is
    then their spec at rest, ``embed_specs``)."""
    return ctx.tp_divides(cfg.vocab)


def _embed_cols(cfg: ModelConfig) -> tuple:
    """The live "tp" axes a token table's d_model columns split over in
    the compute: where the vocabulary does not divide over them, its spec
    at rest splits d_model there (``embed_specs``, mamba2's 50280 at tp =
    16), and the embedding and the tied head compute on the rank's
    columns; none for the audio front end (it computes whole)."""
    if cfg.frontend == "audio" or _vocab_tp(cfg):
        return ()
    return ctx.tp_axes()


def _embed(table, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return embed_tokens(table, tokens, cfg, _vocab_tp(cfg), _embed_cols(cfg))


def _entry(params, cfg: ModelConfig):
    """The parameters an entry point reads whole (embedding, final norm,
    head), gathered once, the "tp" split kept where they compute on the
    rank's vocabulary or d_model columns; the layers are gathered as they
    run."""
    if ctx.get_mesh() is None:
        return params
    keep = ("model",) if _vocab_tp(cfg) or _embed_cols(cfg) else ()
    ns = types.SimpleNamespace(embed=coll.whole(params.embed, keep),
                               layers=params.layers,
                               final_norm=coll.materialize(params.final_norm))
    if hasattr(params, "lm_head"):
        ns.lm_head = coll.materialize(params.lm_head, keep)
    return ns


def layer_cache_shardings(cfg: ModelConfig, batch: int, i: int):
    """Layer ``i``'s cache layout at rest on the active mesh, for a batch of
    ``batch`` rows: a ``{"k", "v"}`` dict or an ``SSMState`` of
    ``Sharding``s."""
    tree = cache_specs(cfg, batch)[f"layer{i % len(cfg.period)}"]
    return ctx.map_specs(ctx.named_sharding, tree)


def _cache_map(fn, lc, shardings=None):
    """``fn(leaf, its sharding or None)`` over one layer's cache."""
    if isinstance(lc, SSM.SSMState):
        return SSM.SSMState(*(fn(t, None if shardings is None else s)
                              for t, s in zip(lc, shardings or lc)))
    return {k: fn(lc[k], None if shardings is None else shardings[k])
            for k in lc}


def _compute_layout(lc, cfg: ModelConfig, split: bool, tp: tuple):
    """One layer's cache layout in the compute, of a layer of "tp" axes
    ``tp`` (``_mixer_tp``): the batch over dp when ``split``; a KV dict's
    kv heads over ``tp`` where they divide (``_kv_heads_tp``), every other
    dim whole (a decode on a head_dim-split cache, ``_decode_hd``, takes
    it as it lies); an ``SSMState`` as the SSM mixer of ``tp`` computes
    it, ``conv_x``'s channels and ``ssm``'s heads over ``tp``, ``conv_bc``
    whole."""
    mesh = ctx.get_mesh()
    dp = ctx.resolve_axis("dp") if split else None
    if isinstance(lc, SSM.SSMState):
        return SSM.SSMState(conv_x=ctx.Sharding(mesh, (dp, None, tp or None)),
                            conv_bc=ctx.Sharding(mesh, (dp,)),
                            ssm=ctx.Sharding(mesh, (dp, tp or None)))
    heads = _kv_heads_tp(cfg, tp)
    return {k: ctx.Sharding(mesh, (dp, None, heads or None)) for k in lc}


def _cache_moved(lc, cfg: ModelConfig, batch: int, i: int, split: bool,
                 to_rest: bool, tp: tuple = ()):
    """Layer ``i``'s cache between its layout at rest and the compute's
    (``_compute_layout``, per leaf)."""
    if ctx.get_mesh() is None:
        return lc
    compute = _compute_layout(lc, cfg, split, tp)
    rest = layer_cache_shardings(cfg, batch, i)
    src, dst = (compute, rest) if to_rest else (rest, compute)
    if isinstance(lc, SSM.SSMState):
        return SSM.SSMState(*(coll.reshard(t, a, b)
                              for t, a, b in zip(lc, src, dst)))
    return {k: coll.reshard(lc[k], src[k], dst[k]) for k in lc}


def _grouped_to_rest(t: torch.Tensor, cfg: ModelConfig, batch: int, i: int,
                     split: bool, heads: ctx.HeadSplit, pad: int):
    """A prefill's k or v of a layer of head groups (``_heads``: (B, S, the
    group's kv heads, this rank's head_dim slice)) padded by ``pad``
    positions and laid out at rest: one all-to-all gives head_dim split
    over "tp" in blocks, every kv head, as the reference's compiled prefill
    writes its cache; then to the layer's ``cache_specs`` layout (the
    same, but where the batch is smaller than dp)."""
    if pad > 0:
        t = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
    t = coll.groups_to_rest(t, heads, cfg.n_kv_heads)
    dp = ctx.resolve_axis("dp") if split else None
    src = ctx.Sharding(ctx.get_mesh(), (dp, None, None, heads.axes))
    return coll.reshard(t, src, layer_cache_shardings(cfg, batch, i)["k"])


@contextlib.contextmanager
def _batch(batch: int):
    split = ctx.get_mesh() is not None and _dp_split(batch)
    with ctx.split_batch(split):
        yield split


# ------------------------------- blocks -------------------------------------

def _mixer_tp(spec: LayerSpec, cfg: ModelConfig) -> tuple:
    """A layer's mixer's "tp" axes: ``ssm.ssm_tp`` for an SSM layer,
    ``attention.attention_tp`` for self- and cross-attention; none where
    its dims do not divide (it computes whole)."""
    if spec.kind == "ssm":
        return SSM.ssm_tp(cfg)
    return A.attention_tp(cfg)


def _decode_hd(spec: LayerSpec, cfg: ModelConfig) -> tuple:
    """The live "tp" axes a self-attention layer's decode splits head_dim
    over (``ctx.hd_split``: its cache splits head_dim at rest); none for
    SSM and cross-attention layers (a cross cache split so is gathered,
    as the reference's GSPMD gathers it)."""
    if spec.kind == "ssm" or spec.cross_attn:
        return ()
    return ctx.hd_split(cfg.n_kv_heads, cfg.hd)


def _kv_heads_tp(cfg: ModelConfig, tp: tuple) -> tuple:
    """The axes an attention layer of "tp" axes ``tp`` splits its kv heads
    (and so its cache in the compute) over: ``tp`` where the kv heads
    divide over it."""
    if tp and cfg.n_kv_heads % ctx.get_mesh().size(tp) == 0:
        return tp
    return ()


def _local(module, tp: tuple):
    """``module``'s parameters for its block: gathered whole, or with
    their "tp" dims kept local for a tensor-parallel block."""
    return coll.whole(module, keep=("model",) if tp else ())


def _heads(spec: LayerSpec, cfg: ModelConfig) -> ctx.HeadSplit | None:
    """A self-attention layer's head groups × head_dim slices over "tp"
    (``attention.attention_heads``: its query heads do not divide); None
    for every other layer."""
    if spec.kind == "ssm" or spec.cross_attn:
        return None
    return A.attention_heads(cfg)


def _mixer_block(spec: LayerSpec, lp: Layer, x: torch.Tensor,
                 cfg: ModelConfig, image_embeds=None) -> torch.Tensor:
    heads = _heads(spec, cfg)
    if heads is not None:
        return A.self_attention(_local(lp.mixer, heads.axes), x, cfg,
                                heads=heads)[0]
    tp = _mixer_tp(spec, cfg)
    mixer = _local(lp.mixer, tp)
    if spec.kind == "ssm":
        return SSM.ssm_forward(mixer, x, cfg, tp=tp)[0]
    if spec.cross_attn:
        return A.cross_attention(mixer, x, image_embeds, cfg, tp=tp)[0]
    return A.self_attention(mixer, x, cfg, tp=tp)[0]


def _ffn_block(spec: LayerSpec, lp: Layer, x: torch.Tensor,
               cfg: ModelConfig, full_capacity: bool = False):
    """(x after the layer's FFN, its MoE aux loss or 0.0)."""
    if not spec.has_ffn:
        return x, 0.0
    if spec.moe:
        if _use_ep(cfg):
            return MOE.moe_ffn_ep(coll.whole(lp.ffn, keep=("model",)), x,
                                  cfg, full_capacity=full_capacity)
        ffn = coll.whole(lp.ffn)
        if ctx.batch_split():
            # the function of the whole batch (its capacity counts every
            # token), as the reference's moe_ffn under GSPMD
            mesh = ctx.get_mesh()
            dp = _dp(mesh)
            y, aux = MOE.moe_ffn(ffn, coll.all_gather(x, mesh, dp, 0), cfg,
                                 full_capacity=full_capacity)
            return y.chunk(mesh.size(dp), 0)[mesh.index(dp)], aux
        return MOE.moe_ffn(ffn, x, cfg, full_capacity=full_capacity)
    tp = mlp_tp(cfg)
    return mlp(_local(lp.ffn, tp), x, cfg, tp), 0.0


def _layer(spec: LayerSpec, lp: Layer, x: torch.Tensor, cfg: ModelConfig,
           image_embeds=None):
    return _ffn_block(spec, lp, _mixer_block(spec, lp, x, cfg, image_embeds),
                      cfg)


def _remat(fn, *args):
    # the model draws no random numbers, so no RNG state is kept
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def backbone(params: Transformer, x: torch.Tensor, cfg: ModelConfig,
             image_embeds=None) -> tuple[torch.Tensor, torch.Tensor | float]:
    """Embedded inputs (and the cross layers' ``image_embeds``) -> (final
    normed hidden states, the MoE aux loss summed over the layers; 0.0
    without MoE layers).

    With ``cfg.remat`` (and gradients enabled) the backward pass recomputes
    each layer from its input: ``remat_policy="all"`` keeps only the
    layer's input, ``"block_outputs"`` also the mixer block's output, so
    the recompute stays within one block (the reference's
    ``save_only_these_names("mixer_out", "ffn_out")``)."""
    remat = cfg.remat and torch.is_grad_enabled()
    if remat and cfg.remat_policy not in ("all", "block_outputs"):
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    aux = 0.0
    for i, lp in enumerate(params.layers):
        spec = layer_spec(cfg, i)
        if not remat:
            x, a = _layer(spec, lp, x, cfg, image_embeds)
        elif cfg.remat_policy == "all":
            x, a = _remat(_layer, spec, lp, x, cfg, image_embeds)
        else:
            x = _remat(_mixer_block, spec, lp, x, cfg, image_embeds)
            x, a = _remat(_ffn_block, spec, lp, x, cfg)
        aux = aux + a
    return rms_norm(x, coll.materialize(params.final_norm), cfg.norm_eps), aux


def logits_from_hidden(params: Transformer, x: torch.Tensor,
                       cfg: ModelConfig, gather: bool = True
                       ) -> torch.Tensor:
    """The output head: the token embedding transposed when tied, else
    ``lm_head``; audio: (B, S, C, vocab) from the (C, D, vocab) head (a
    plain product under ``approx_matmul`` too, as the reference's
    einsum).  Vocab-parallel where ``_vocab_tp``: this rank's vocabulary
    columns (x behind *f*), gathered whole unless not ``gather``.  A tied
    head on d_model columns (``_embed_cols``) contracts this rank's
    columns of x (behind *f*) with its columns of the table, and the
    partial logits are summed over "tp" (*g*): whole on every rank."""
    cols = _embed_cols(cfg)
    if cols and cfg.tie_embeddings:
        w = coll.materialize(params.embed.tokens, ("model",))
        j, d = ctx.get_mesh().index(cols), w.shape[-1]
        x = coll.tp_in(x, cols)[..., j * d:(j + 1) * d]
        return coll.tp_out(x @ w.to(x.dtype).T, cols)
    tp = _vocab_tp(cfg)
    keep = ("model",) if tp else ()
    x = coll.tp_in(x, tp)
    if cfg.frontend == "audio":
        y = torch.einsum("bsd,cdv->bscv", x,
                         coll.materialize(params.lm_head, keep).to(x.dtype))
    elif cfg.tie_embeddings:
        y = x @ coll.materialize(params.embed.tokens, keep).to(x.dtype).T
    else:
        y = x @ coll.materialize(params.lm_head, keep).to(x.dtype)
    return coll.tp_gather(y, tp, -1) if gather else y


def forward_train(params: Transformer, tokens: torch.Tensor,
                  cfg: ModelConfig, image_embeds=None):
    """tokens (B, S) -> (full-sequence logits (B, S, vocab), MoE aux
    loss); audio tokens (B, S, C) -> logits (B, S, C, vocab).  On a mesh
    with the batch split, the aux loss is the dp ranks' mean: the function
    the reference's gradient is taken of, though it reports its first dp
    row's aux (ROADMAP, facts about the reference)."""
    with _batch(tokens.shape[0]) as split:
        p = _entry(params, cfg)
        x, aux = backbone(p, _embed(p.embed, _rows(tokens, split), cfg),
                          cfg,
                          _rows(image_embeds, split))
        logits = _all_rows(logits_from_hidden(p, x, cfg), split)
        if split and isinstance(aux, torch.Tensor):
            mesh = ctx.get_mesh()
            aux = coll.all_reduce(aux, mesh, _dp(mesh)) / mesh.size(_dp(mesh))
    return logits, aux


def _ce_sum(params: Transformer, x: torch.Tensor, targets: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """Σ of the cross-entropy over ``targets``' positions.  Vocab-parallel
    where ``_vocab_tp``: each rank's logits are its vocabulary columns,
    and the max, the sum of exponentials and the target's logit are
    reduced over "tp"."""
    tp = _vocab_tp(cfg)
    logits = logits_from_hidden(params, x, cfg, gather=False).to(
        torch.float32)
    if not tp:
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
        return (lse - tgt).sum()
    mesh = ctx.get_mesh()
    m = coll.all_reduce(logits.detach().amax(-1), mesh, tp, "max")
    lse = torch.log(coll.tp_out(torch.exp(logits - m[..., None]).sum(-1),
                                tp)) + m
    cols = logits.shape[-1]
    local = targets - mesh.index(tp) * cols
    own = (local >= 0) & (local < cols)
    tgt = torch.gather(logits, -1, local.clamp(0, cols - 1)[..., None])
    tgt = coll.tp_out(torch.where(own, tgt[..., 0], 0.0), tp)
    return (lse - tgt).sum()


def lm_loss(params: Transformer, tokens: torch.Tensor,
            targets: torch.Tensor, cfg: ModelConfig,
            image_embeds=None) -> torch.Tensor:
    """Mean next-token cross-entropy (float32; audio: over every position
    and codebook, never chunked) + 0.01 · the MoE aux loss.

    On a mesh with the batch split, each dp rank adds its rows' share
    (their CE sum over the whole batch's count, and 0.01 · aux / dp) and
    the shares are summed over the dp ranks; the gradient of a rank's
    share flows back through its own rows only (the parameters' gathers
    sum it over dp)."""
    with _batch(tokens.shape[0]) as split:
        p = _entry(params, cfg)
        tok, tgt = _rows(tokens, split), _rows(targets, split)
        x, aux = backbone(p, _embed(p.embed, tok, cfg), cfg,
                          _rows(image_embeds, split))
        if not split:
            if cfg.loss_vocab_chunk and cfg.frontend != "audio":
                ce = _chunked_ce(p, x, tgt, cfg)
            else:
                ce = _ce_sum(p, x, tgt, cfg) / tgt.numel()
            return ce + 0.01 * aux
        mesh = ctx.get_mesh()
        n = mesh.size(_dp(mesh))
        if cfg.loss_vocab_chunk and cfg.frontend != "audio":
            ce = _chunked_ce(p, x, tgt, cfg) / n
        else:
            ce = _ce_sum(p, x, tgt, cfg) / targets.numel()
        return coll.all_reduce(ce + 0.01 * aux / n, mesh, _dp(mesh))


def _chunked_ce(params: Transformer, x: torch.Tensor, targets: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Cross-entropy over sequence chunks of ``loss_vocab_chunk`` positions,
    so (B, S, vocab) logits never exist at once: under autograd each
    chunk's logits are recomputed in the backward pass rather than kept.
    As the reference, the positions past the last whole chunk are left
    out; a sequence shorter than one chunk is one chunk (the reference's
    reshape fails there)."""
    B, S, _ = x.shape
    C = min(cfg.loss_vocab_chunk, S)
    n = S // C
    ce = (_ce_sum if not torch.is_grad_enabled()
          else lambda *a: _remat(_ce_sum, *a))
    total = sum(ce(params, x[:, i * C:(i + 1) * C],
                   targets[:, i * C:(i + 1) * C], cfg)
                for i in range(n))
    return total / (B * n * C)


# ------------------------------- caches -------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype | None = None, device=None) -> list:
    """Zeroed per-layer caches: a ``{"k", "v"}`` dict of (batch, max_len,
    Hkv, hd) for attention layers and of (batch, n_img_tokens, Hkv, hd)
    for cross-attention layers, a zeroed ``SSMState`` (conv tails in
    ``dtype``, the state in float32) for SSM layers.  On a mesh, this
    rank's slices of them (``cache_specs``)."""
    dtype = dtype or cfg.adtype()

    def kv(length):
        shape = (batch, length, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.empty(shape, dtype=dtype, device="meta"),
                "v": torch.empty(shape, dtype=dtype, device="meta")}

    caches = []
    for i in range(cfg.n_layers):
        spec = layer_spec(cfg, i)
        if spec.kind == "ssm":
            lc = SSM.init_ssm_state(cfg, batch, dtype, "meta")
        else:
            lc = kv(cfg.n_img_tokens if spec.cross_attn else max_len)
        shardings = (layer_cache_shardings(cfg, batch, i)
                     if ctx.get_mesh() is not None else None)
        caches.append(_cache_map(
            lambda t, s: torch.zeros(s.shard_shape(t.shape) if s else
                                     t.shape, dtype=t.dtype, device=device),
            lc, shardings))
    return caches


@torch.no_grad()
def prefill(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int | None = None, image_embeds=None):
    """Process a prompt: (last-position logits (B, 1, vocab), caches: KV
    padded to ``max_len``, cross layers' K/V of ``image_embeds``, SSM
    states after the prompt).  The MoE layers run at ``capacity_factor``,
    as the reference's prefill."""
    B, S = tokens.shape[:2]
    pad = (max_len or S) - S
    with _batch(B) as split:
        p = _entry(params, cfg)
        x = _embed(p.embed, _rows(tokens, split), cfg)
        img = _rows(image_embeds, split)
        cache = []
        for i, lp in enumerate(params.layers):
            spec = layer_spec(cfg, i)
            heads = _heads(spec, cfg)
            if heads is not None:
                x, (k, v) = A.self_attention(_local(lp.mixer, heads.axes), x,
                                             cfg, heads=heads)
                cache.append({n: _grouped_to_rest(t, cfg, B, i, split, heads,
                                                  pad)
                              for n, t in (("k", k), ("v", v))})
                x, _ = _ffn_block(spec, lp, x, cfg)
                continue
            tp = _mixer_tp(spec, cfg)
            mixer = _local(lp.mixer, tp)
            if spec.kind == "ssm":
                x, lc = SSM.ssm_forward(mixer, x, cfg, return_state=True,
                                        tp=tp)
            elif spec.cross_attn:
                x, (k, v) = A.cross_attention(mixer, x, img, cfg, tp=tp,
                                              all_kv=True)
                lc = {"k": k, "v": v}
            else:
                x, (k, v) = A.self_attention(mixer, x, cfg, tp=tp,
                                             all_kv=True)
                if pad > 0:
                    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
                    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
                lc = {"k": k, "v": v}
            cache.append(_cache_moved(lc, cfg, B, i, split, to_rest=True,
                                      tp=tp))
            x, _ = _ffn_block(spec, lp, x, cfg)
        x = rms_norm(x, p.final_norm, cfg.norm_eps)
        logits = _all_rows(logits_from_hidden(p, x[:, -1:], cfg), split)
    return logits, cache


@torch.no_grad()
def decode_step(params: Transformer, cache: list, tokens: torch.Tensor,
                pos: torch.Tensor, cfg: ModelConfig,
                seq_shard: bool = False):
    """One decode step: tokens (B, 1) (audio (B, 1, C)), pos (B,) ->
    (logits (B, 1, vocab) (audio (B, 1, C, vocab)), cache updated in
    place; the cross layers' caches are read, not written).  The MoE
    layers run at full capacity (no drops), as the reference's decode.

    ``seq_shard`` (the reference's long-context path): on a mesh, the
    self-attention caches' sequence is split over "sp" (``cache_specs``
    of a batch smaller than dp) and every rank runs the whole batch; with
    no mesh it is the ordinary decode."""
    B = tokens.shape[0]
    mesh = ctx.get_mesh()
    seq = None
    if seq_shard and mesh is not None:
        if B >= ctx.axis_size("dp"):
            raise ValueError(f"the sequence-split decode takes a batch "
                             f"smaller than dp ({ctx.axis_size('dp')}), "
                             f"got {B}")
        seq = coll.live(mesh, ctx.axes_of("sp"))
    with _batch(B) as split:
        p = _entry(params, cfg)
        x = _embed(p.embed, _rows(tokens, split), cfg)
        pos = _rows(pos, split)
        for i, lp in enumerate(params.layers):
            spec = layer_spec(cfg, i)
            seq_attn = (spec.kind != "ssm" and not spec.cross_attn
                        and seq is not None)
            # the sequence-split decode computes every head; the decode on
            # a head_dim-split cache splits every projection over "tp"
            hd = () if seq_attn else _decode_hd(spec, cfg)
            tp = () if seq_attn or hd else _mixer_tp(spec, cfg)
            mixer = _local(lp.mixer, tp or hd)
            if seq_attn:
                lc = cache[i]
                x, lc["k"], lc["v"] = A.decode_self_attention(
                    mixer, x, lc["k"], lc["v"], pos, cfg, seq_axes=seq)
            else:
                # a head_dim-split cache is attended to as it lies at rest
                lc = cache[i] if hd else _cache_moved(
                    cache[i], cfg, B, i, split, to_rest=False, tp=tp)
                if spec.kind == "ssm":
                    x, lc = SSM.ssm_decode_step(mixer, x, lc, cfg, tp=tp)
                elif spec.cross_attn:
                    x, _ = A.cross_attention(mixer, x, None, cfg,
                                             kv_cache=(lc["k"], lc["v"]),
                                             tp=tp)
                else:
                    x, lc["k"], lc["v"] = A.decode_self_attention(
                        mixer, x, lc["k"], lc["v"], pos, cfg, tp=tp,
                        hd_axes=hd)
                if not (spec.cross_attn or hd):
                    cache[i] = _cache_moved(lc, cfg, B, i, split,
                                            to_rest=True, tp=tp)
            x, _ = _ffn_block(spec, lp, x, cfg, full_capacity=True)
        x = rms_norm(x, p.final_norm, cfg.norm_eps)
        logits = _all_rows(logits_from_hidden(p, x, cfg), split)
    return logits, cache
