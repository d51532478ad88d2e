"""Collectives over a tuple of mesh axes, and the moves between a tensor's
whole value and this rank's slice of it.

The reference's sharded LM runs under GSPMD, which inserts its gathers and
reductions itself, and under ``shard_map`` with explicit ``psum`` /
``pmax``.  Here each is a ``torch.distributed`` call on this rank's group
along the axes (``ctx.Mesh.group``); the ones a gradient flows through
are ``torch.autograd.Function``s:

* ``all_gather`` (backward: a reduce-scatter), ``all_reduce`` (SUM, MAX,
  MIN; a SUM's backward passes the gradient through, as after a partial
  sum whose result every rank uses), ``replicated`` (identity forward; the
  backward sums the gradient over the axes, where every rank computes its
  own part from a tensor they share);
* the tensor-parallel operators over the active mesh's "tp" axes
  (Megatron-LM's *f* and *g*, ``tp_in`` / ``tp_out``), ``tp_gather`` (a
  column-parallel result made whole for every rank), ``gather_columns``
  (several column-parallel results made whole in one call, without
  autograd: a decode's q, k and v) and ``sum_int32`` (the LUT path's
  integer partial sums);
* self-attention's head groups × head_dim slices (``ctx.head_split``):
  ``group_heads`` (the q / k / v columns laid out as the group's heads ×
  this rank's slice, one all-gather over the group, a reduce-scatter
  back), ``group_sum`` (the scores' partial sums, an all-reduce over the
  group both ways), ``group_output`` (the output gathered to whole
  head_dim) and ``groups_to_rest`` (a prefill's cache to its layout at
  rest, one all-to-all over "tp");
* ``materialize``: a parameter's whole value from its slice, per layer
  (``ctx``'s docstring says how the LM uses it);
* ``place`` (this rank's slice of a whole tensor), ``gather`` (the whole
  from the slices) and ``reshard`` (from one layout to another).

Every call is the backend's own, in the list forms that both the card's
torch 2.11 and 2.13 have undeprecated: nccl, and gloo on CPU and CUDA
tensors (ranks that share a card run gloo, since NCCL refuses two ranks
on one device).  PyTorch's backend table lists only broadcast and
all-reduce for gloo on CUDA tensors, but torch 2.11's gloo gathers and
reduce-scatters them (``tools/collective_probe.py``).  Float SUMs of a
dtype narrower than float32 reduce in float32 and round once.

``STATS`` holds, while ``timed`` is on, the backend calls' host seconds,
each call between two synchronizations of its device (so it excludes the
compute queued before it), and their number: what a step spends in
collectives.
"""
from __future__ import annotations

import contextlib
import time
import types
from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.parallel import ctx

OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
       "min": dist.ReduceOp.MIN}
STATS = {"seconds": 0.0, "calls": 0, "timed": False}


@contextlib.contextmanager
def timed():
    """Within the block ``STATS["seconds"]`` accumulates each collective's
    host time, the device synchronized before and after it, and
    ``STATS["calls"]`` counts them."""
    old, STATS["timed"] = STATS["timed"], True
    try:
        yield STATS
    finally:
        STATS["timed"] = old


def _call(fn, t: torch.Tensor, *args, **kw) -> None:
    if not STATS["timed"]:
        fn(*args, **kw)
        return
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    fn(*args, **kw)
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    STATS["seconds"] += time.perf_counter() - t0
    STATS["calls"] += 1


def _axes(mesh, axes) -> tuple:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(a for a in mesh.axis_names if a in axes)


def live(mesh, axes) -> tuple:
    """``axes`` without those of size 1 (in mesh order): the ones a layout
    helper communicates over.  The raw collectives call the backend for
    any group, a one-rank one too."""
    return tuple(a for a in _axes(mesh, axes) if mesh.axis_size(a) > 1)


def all_gather_raw(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The blocks of ``x`` from every rank along ``axes``, concatenated on
    ``dim`` in row-major order of the axes (no autograd)."""
    axes = _axes(mesh, axes)
    return _gather(x, mesh.group(axes), mesh.size(axes), dim)


def _gather(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    x = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _call(dist.all_gather, x, list(out.chunk(n)), x, group=group)
    return out.movedim(0, dim)


def all_reduce_raw(x: torch.Tensor, mesh, axes, op: str = "sum"
                   ) -> torch.Tensor:
    """The element-wise SUM, MAX or MIN of ``x`` over the ranks along
    ``axes``, as a new tensor (no autograd)."""
    return _reduce(x, mesh.group(_axes(mesh, axes)), op)


def _reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    wide = (op == "sum" and x.is_floating_point()
            and x.dtype != torch.float64 and x.dtype != torch.float32)
    out = x.to(torch.float32) if wide else x.clone()
    out = out.contiguous()
    _call(dist.all_reduce, out, out, op=OPS[op], group=group)
    return out.to(x.dtype) if wide else out


def reduce_scatter_raw(x: torch.Tensor, mesh, axes, dim: int
                       ) -> torch.Tensor:
    """This rank's block on ``dim`` of the SUM of ``x`` over the ranks
    along ``axes`` (no autograd)."""
    axes = _axes(mesh, axes)
    return _scatter(x, mesh.group(axes), mesh.size(axes), dim)


def _scatter(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    wide = x.is_floating_point() and x.dtype not in (torch.float32,
                                                     torch.float64)
    parts = [p.contiguous() for p in
             (x.to(torch.float32) if wide else x).chunk(n, dim)]
    out = torch.empty_like(parts[0])
    _call(dist.reduce_scatter, out, out, parts, group=group)
    return out.to(x.dtype) if wide else out


def _all_to_all(x: torch.Tensor, out_sizes: list, in_sizes: list,
                group) -> torch.Tensor:
    """Each rank's ``in_sizes`` blocks of the flat ``x`` sent to the ranks
    of ``group`` in order; what they sent this rank, concatenated."""
    out = torch.empty(sum(out_sizes), dtype=x.dtype, device=x.device)
    _call(dist.all_to_all_single, x, out, x, out_sizes, in_sizes,
          group=group)
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx_, x, mesh, axes, dim):
        ctx_.args = (mesh, axes, dim)
        return all_gather_raw(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx_, g):
        return reduce_scatter_raw(g, *ctx_.args), None, None, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx_, x, mesh, axes):
        return all_reduce_raw(x, mesh, axes)

    @staticmethod
    def backward(ctx_, g):
        return g, None, None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx_, x, mesh, axes):
        ctx_.args = (mesh, axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx_, g):
        return all_reduce_raw(g, *ctx_.args), None, None


def all_gather(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """``all_gather_raw`` whose backward is a reduce-scatter."""
    return _Gather.apply(x, mesh, _axes(mesh, axes), dim)


def all_reduce(x: torch.Tensor, mesh, axes, op: str = "sum"
               ) -> torch.Tensor:
    """``all_reduce_raw``; a SUM passes its gradient through unchanged,
    MAX and MIN carry none."""
    if op == "sum":
        return _Sum.apply(x, mesh, _axes(mesh, axes))
    return all_reduce_raw(x.detach(), mesh, axes, op)


def replicated(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``x`` unchanged; its gradient is summed over the ranks along
    ``axes`` (each of which computed a part from the same ``x``)."""
    axes = live(mesh, axes)
    if not axes:
        return x
    return _Replicated.apply(x, mesh, axes)


# --------------------------- tensor parallelism -----------------------------

def tp_in(x: torch.Tensor, tp: tuple) -> torch.Tensor:
    """*f*, before a column-parallel projection: ``x`` (the same on every
    rank along ``tp``, the live "tp" axes) unchanged; the backward pass
    sums its gradient over ``tp``, where each rank's columns took their
    part of it."""
    return replicated(x, ctx.get_mesh(), tp) if tp else x


def tp_out(x: torch.Tensor, tp: tuple) -> torch.Tensor:
    """*g*, after a row-parallel projection: the sum of every rank's partial
    output over ``tp`` (a float narrower than float32 summed in float32,
    rounded once); the backward pass hands the gradient of the whole sum
    to every rank's part unchanged."""
    return all_reduce(x, ctx.get_mesh(), tp) if tp else x


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx_, x, mesh, axes, dim):
        ctx_.args = (mesh, axes, dim)
        return all_gather_raw(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx_, g):
        mesh, axes, dim = ctx_.args
        return (g.chunk(mesh.size(axes), dim)[mesh.index(axes)].contiguous(),
                None, None, None)


def tp_gather(x: torch.Tensor, tp: tuple, dim: int) -> torch.Tensor:
    """The blocks of a column-parallel result from every rank along ``tp``,
    concatenated on ``dim`` (the whole logits every rank returns); the
    backward pass keeps this rank's block of the gradient, which every
    rank holds whole."""
    return _GatherReplicated.apply(x, ctx.get_mesh(), tp, dim) if tp else x


def sum_int32(parts: Sequence[torch.Tensor], tp: tuple) -> list:
    """Each int32 tensor of ``parts`` summed over the ranks along ``tp``, in
    one all-reduce of their concatenation (integer sums: exact in any
    order, and wrap as one rank's would)."""
    if any(p.dtype != torch.int32 for p in parts):
        raise TypeError("sum_int32 takes int32 tensors")
    if not tp:
        return list(parts)
    flat = all_reduce_raw(torch.cat([p.reshape(-1) for p in parts]),
                          ctx.get_mesh(), tp)
    return [t.view(p.shape) for t, p in
            zip(flat.split([p.numel() for p in parts]), parts)]


def gather_columns(parts: Sequence[torch.Tensor], tp: tuple) -> list:
    """Each of ``parts`` (this rank's block of a column-parallel result on
    the last dim; one dtype, one leading shape) whole on every rank along
    ``tp``, in one all-gather of their concatenation (no autograd)."""
    mesh = ctx.get_mesh()
    widths = [p.shape[-1] for p in parts]
    flat = all_gather_raw(torch.cat(list(parts), -1), mesh, tp, -1)
    lead = flat.shape[:-1]
    blocks = flat.reshape(*lead, mesh.size(tp), sum(widths)).split(widths, -1)
    return [b.reshape(*lead, -1) for b in blocks]


# ------------------- head groups × head_dim slices --------------------------

class _GroupGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx_, x, split, dim):
        ctx_.args = (split, dim)
        return _gather(x, split.pg, split.slices, dim)

    @staticmethod
    def backward(ctx_, g):
        split, dim = ctx_.args
        return _scatter(g, split.pg, split.slices, dim), None, None


class _GroupSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx_, x, split):
        ctx_.split = split
        return _reduce(x, split.pg)

    @staticmethod
    def backward(ctx_, g):
        return _reduce(g, ctx_.split.pg), None


def group_heads(parts: Sequence[torch.Tensor], split: ctx.HeadSplit,
                head_dim: int) -> list:
    """This rank's column-parallel projections (``parts``: q, k, v, each
    (..., its columns), the columns of its group's heads on the group's
    ranks in order) laid out as its group's heads × its head_dim slice:
    each (..., heads of the group, the slice's ``split.dims``).  One
    all-gather over the group's ranks makes the group's columns whole; its
    backward reduce-scatters the gradient, each rank having used its
    slice."""
    widths = [p.shape[-1] for p in parts]
    flat = _GroupGather.apply(torch.cat(list(parts), -1), split, -1)
    lead = flat.shape[:-1]
    blocks = flat.reshape(*lead, split.slices, sum(widths)).split(widths, -1)
    dims = torch.tensor(split.dims(head_dim), device=flat.device)
    return [b.reshape(*lead, -1, head_dim).index_select(-1, dims)
            for b in blocks]


def group_sum(x: torch.Tensor, split: ctx.HeadSplit) -> torch.Tensor:
    """The scores' partial sums (this rank's head_dim slice) summed over
    its group's ranks, in float32; the backward pass sums the gradient
    over them too, since each rank's p·v, on its own slice, gives only its
    part of the gradient of the shared scores."""
    return _GroupSum.apply(x, split)


def group_output(out: torch.Tensor, split: ctx.HeadSplit) -> torch.Tensor:
    """The attention output on this rank's head_dim slice (..., heads,
    slice) gathered over its group's ranks to (..., heads, head_dim) in
    head_dim order (backward: a reduce-scatter)."""
    whole = _GroupGather.apply(out, split, -1)
    hd = whole.shape[-1]
    order = [i for j in range(split.slices) for i in split.dims(hd, j)]
    inverse = torch.empty(hd, dtype=torch.long)
    inverse[torch.tensor(order)] = torch.arange(hd)
    return whole.index_select(-1, inverse.to(whole.device))


def groups_to_rest(x: torch.Tensor, split: ctx.HeadSplit,
                   n_kv_heads: int) -> torch.Tensor:
    """A cache leaf from the compute (B, S, this group's kv heads, this
    rank's slice ``split.dims``) to its layout at rest, head_dim split
    over the "tp" axes in contiguous blocks of head_dim / n, every kv head
    (B, S, n_kv_heads, head_dim / n): one all-to-all over them, each rank
    sending each block to the rank that holds it at rest (no autograd)."""
    mesh = ctx.get_mesh()
    n = mesh.size(split.axes)
    hd = x.shape[-1] * split.slices
    rest = hd // n
    per = n_kv_heads // split.groups
    B, S = x.shape[:2]

    def pieces(r):
        """For each rank q, the (position in rank r's slice, position in
        q's block) of every head_dim index rank r sends q."""
        dims = split.dims(hd, r % split.slices)
        return [[(a, d - q * rest) for a, d in enumerate(dims)
                 if q * rest <= d < (q + 1) * rest] for q in range(n)]

    me = mesh.index(split.axes)
    send = pieces(me)
    sends = [x[..., [a for a, _ in pos]].reshape(-1) for pos in send]
    # a move of bytes: sent as uint8, whatever the cache's dtype
    item = x.element_size()
    in_sizes = [t.numel() * item for t in sends]
    recv = [pieces(r)[me] for r in range(n)]
    out_sizes = [B * S * per * len(pos) * item for pos in recv]
    buf = _all_to_all(torch.cat(sends).view(torch.uint8), out_sizes,
                      in_sizes, mesh.group(split.axes))
    out = torch.empty((B, S, n_kv_heads, rest), dtype=x.dtype,
                      device=x.device)
    for r, (pos, block) in enumerate(zip(recv, buf.split(out_sizes))):
        if pos:
            g = r // split.slices
            out[:, :, g * per:(g + 1) * per, [b for _, b in pos]] = \
                block.view(x.dtype).reshape(B, S, per, len(pos))
    return out


# ------------------------------ layouts -------------------------------------

def place(whole: torch.Tensor, sharding: ctx.Sharding | None
          ) -> torch.Tensor:
    """This rank's slice of ``whole`` under ``sharding`` (a new tensor, so
    the whole may be freed); ``whole`` with no sharding."""
    if sharding is None:
        return whole
    return whole[sharding.index(whole.shape)].clone()


def gather(local: torch.Tensor, sharding: ctx.Sharding | None
           ) -> torch.Tensor:
    """The whole tensor from every rank's ``local`` slice (no autograd)."""
    if sharding is None:
        return local
    for d in range(len(sharding.dims)):
        axes = live(sharding.mesh, sharding.axes(d))
        if axes:
            local = all_gather_raw(local, sharding.mesh, axes, d)
    return local


def reshard(x: torch.Tensor, src: ctx.Sharding | None,
            dst: ctx.Sharding | None) -> torch.Tensor:
    """``x`` laid out by ``src`` (None: whole) as laid out by ``dst``: the
    dims the two split differently are gathered, then sliced (no
    autograd)."""
    mesh = (src or dst).mesh if (src or dst) is not None else None
    if mesh is None:
        return x
    n = max(len(src.dims) if src else 0, len(dst.dims) if dst else 0)
    for d in range(n):
        a = live(mesh, src.axes(d)) if src else ()
        b = live(mesh, dst.axes(d)) if dst else ()
        if a == b:
            continue
        if a:
            x = all_gather_raw(x, mesh, a, d)
        if b:
            k = mesh.size(b)
            x = x.chunk(k, d)[mesh.index(b)]
    return x.contiguous()


class _Materialize(torch.autograd.Function):
    @staticmethod
    def forward(ctx_, local, sharding, gathered, dp, rs_dim):
        ctx_.args = (sharding, gathered, dp, rs_dim)
        x = local.view_as(local)
        for d in gathered:
            x = all_gather_raw(x, sharding.mesh,
                               live(sharding.mesh, sharding.axes(d)), d)
        return x

    @staticmethod
    def backward(ctx_, g):
        sharding, gathered, dp, rs_dim = ctx_.args
        mesh = sharding.mesh
        if dp and rs_dim is not None:
            g = reduce_scatter_raw(g.contiguous(), mesh, dp, rs_dim)
        elif dp:
            g = all_reduce_raw(g.contiguous(), mesh, dp)
        for d in gathered:
            if d != rs_dim or not dp:
                axes = live(mesh, sharding.axes(d))
                g = g.chunk(mesh.size(axes), d)[mesh.index(axes)]
        return g.contiguous(), None, None, None, None


def materialize(p: torch.Tensor, keep: Sequence[str] = ()) -> torch.Tensor:
    """The whole value of parameter ``p`` (its slice at rest, with the
    ``sharding`` attribute ``convert.shard_params`` gives it) for this
    step's compute: each dim its spec splits over an axis outside ``keep``
    is all-gathered.  The backward pass sums the whole gradient over the dp
    axes while the batch is split (``ctx.batch_split``; a reduce-scatter
    on a dim split over exactly those axes) and keeps this rank's slice.
    ``p`` itself with no sharding."""
    sharding = getattr(p, "sharding", None)
    if sharding is None:
        return p
    mesh = sharding.mesh
    gathered = tuple(d for d in range(len(sharding.dims))
                     if live(mesh, sharding.axes(d))
                     and not set(sharding.axes(d)) & set(keep))
    dp = live(mesh, ctx.axes_of("dp")) if ctx.batch_split() else ()
    rs_dim = next((d for d in gathered
                   if dp and live(mesh, sharding.axes(d)) == dp), None)
    if not gathered and not dp:
        return p
    return _Materialize.apply(p, sharding, gathered, dp, rs_dim)


def whole(module, keep: Sequence[str] = ()):
    """``module``'s own parameters ``materialize``d, as attributes of a
    namespace (``module`` itself when none is sharded): what a block's
    apply function reads on a mesh."""
    own = dict(module.named_parameters(recurse=False))
    if not any(hasattr(p, "sharding") for p in own.values()):
        return module
    return types.SimpleNamespace(**{n: materialize(p, keep)
                                    for n, p in own.items()})
