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
    n = mesh.size(axes)
    x = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _call(dist.all_gather, x, list(out.chunk(n)), x, group=mesh.group(axes))
    return out.movedim(0, dim)


def all_reduce_raw(x: torch.Tensor, mesh, axes, op: str = "sum"
                   ) -> torch.Tensor:
    """The element-wise SUM, MAX or MIN of ``x`` over the ranks along
    ``axes``, as a new tensor (no autograd)."""
    axes = _axes(mesh, axes)
    wide = (op == "sum" and x.is_floating_point()
            and x.dtype != torch.float64 and x.dtype != torch.float32)
    out = x.to(torch.float32) if wide else x.clone()
    out = out.contiguous()
    _call(dist.all_reduce, out, out, op=OPS[op], group=mesh.group(axes))
    return out.to(x.dtype) if wide else out


def reduce_scatter_raw(x: torch.Tensor, mesh, axes, dim: int
                       ) -> torch.Tensor:
    """This rank's block on ``dim`` of the SUM of ``x`` over the ranks
    along ``axes`` (no autograd)."""
    axes = _axes(mesh, axes)
    n = mesh.size(axes)
    wide = x.is_floating_point() and x.dtype not in (torch.float32,
                                                     torch.float64)
    parts = [p.contiguous() for p in
             (x.to(torch.float32) if wide else x).chunk(n, dim)]
    out = torch.empty_like(parts[0])
    _call(dist.reduce_scatter, out, out, parts, group=mesh.group(axes))
    return out.to(x.dtype) if wide else out


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
