"""Parallel context: the active mesh of ranks and the logical axes.

The reference (``repro/parallel/ctx.py``) lays a ``jax.sharding.Mesh`` of
devices over the production axes (pod, data, model) and runs the
distributed paths under GSPMD and ``shard_map``.  Here every rank is a
process of an initialized ``torch.distributed`` world, and a ``Mesh`` lays
those ranks out over named axes, row-major, as ``jax.make_mesh`` lays out
devices.  Each collective of the reference over a mesh axis, or a tuple of
them, becomes a ``torch.distributed`` call on this rank's group along those
axes (``Mesh.group``; ``parallel/collectives.py``).  An ``AbstractMesh``
has the shape and axis names alone, no process group: the spec functions
and ``launch.steps.abstract_*`` run on it for the production shapes in one
process.

The caller initializes the process group and so picks the backend:
``nccl`` with one card per rank, ``gloo`` when ranks share a card or run
on the CPU.  Nothing here switches backend.

Axis semantics follow the reference (``launch.mesh``):
  * ``pod``   — the constraint-grid partition (CGP) / data parallelism (LM);
  * ``data``  — evolution islands (CGP) / batch parallelism (LM);
  * ``model`` — input-cube sharding (CGP: metric partials all-reduced
    across it) / tensor parallelism (LM).

Model code names logical axes (``LOGICAL``): "dp", "fsdp" and "sp"
resolve to (pod, data), "tp" to model, "sweep" to pod, as in the
reference.  A logical spec is a plain tuple of such names (or None) per
tensor dim; ``resolve_spec`` gives the physical spec (per dim None, an
axis or a tuple of axes, as the reference's ``PartitionSpec``) and
``named_sharding`` a ``Sharding`` on the active mesh.

How the LM computes on a mesh (``models/``, ``launch/steps.py``):

  * **At rest** every rank holds exactly the slice of each parameter,
    optimizer-state leaf, cache and batch that the reference's resolved
    spec gives its device (``Sharding.index``).
  * **"tp" splits the compute** of every block whose dims divide, as the
    reference's GSPMD partitions them by their specs (Megatron-LM's
    layout).  Each "model" rank runs its ``n_heads / tp`` query heads of
    self- and cross-attention (``wq`` column-parallel, ``wo`` row-
    parallel; a cross layer's gate after the sum), its ``H / tp`` heads
    of the SSM mixer (``w_z``, ``w_x``, ``w_dt`` column-parallel, its
    slices of the conv, ``dt_bias``, ``a_log``, ``d_skip`` and
    ``gate_norm``, ``w_out`` row-parallel), its ``d_ff / tp`` MLP columns
    (``w_gate`` / ``w_up`` column-parallel, ``w_down`` row-parallel) and
    its ``vocab / tp`` rows of the embedding and columns of the head.  The
    residual stream and the norms are the same on every rank.  Before a
    column-parallel projection stands *f* (``collectives.tp_in``: identity,
    its backward an all-reduce), after a row-parallel one *g*
    (``tp_out``: one all-reduce, float32 for narrower floats); the
    embedding masks the ids outside its rows and sums over "tp"; serving
    gathers the logits whole, the loss is a vocab-parallel cross-entropy
    (the max and the sum of exponentials all-reduced).  The SSM mixer's
    B / C branch (``w_bc``, ``conv_bc_w``, replicated) runs whole on every
    rank with *f* after its conv, and its gate norm sums its squares over
    "tp" (``ssm.py``).  kv heads: where ``n_kv_heads`` divides over "tp",
    ``wk`` / ``wv`` are column-parallel and the cache (self or cross) is
    heads-split at rest, as the rank computes it; where "tp" is a multiple
    of ``n_kv_heads``, a rank's query heads share one kv head, whose
    columns it takes from the gathered ``wk`` / ``wv`` (the prefill
    computes every kv head for the cache).  A self-attention cache whose
    kv heads do not divide over "tp" splits head_dim at rest (``hd_split``
    says where), and its decode computes on that split, as the
    reference's ``decode_self_attention(kv_spec=...)``: whether or not the
    query heads divide, each rank projects its columns of q, k and v
    (``wq`` / ``wk`` / ``wv`` column-parallel), gathers the new token's q,
    k and v whole (B·(H + 2·Hkv)·hd elements) to rotate them, writes its
    head_dim slice of k and v, and sums its partial scores over "tp" (a
    B·H·S float32 all-reduce); p·v runs on the slice, its output is
    gathered (B·H·hd) and ``wo`` is row-parallel: no cache and no weight
    is gathered.  A cross-attention cache split so is gathered whole, as
    the reference's GSPMD gathers it.  An SSM layer's state stays split
    as at rest: ``conv_x``'s channels and the state's heads.  The
    approximate multiplier (``models/quant.py``) stays one rank's bit for
    bit at each projection: ranges are the whole tensor's and a
    row-parallel projection's int32 sums are all-reduced before the float
    conversion (the SSM's gate norm, summed over "tp" in another order,
    rounds otherwise).  ``tp_divides`` says which blocks split by heads,
    columns and vocabulary.  Where the query heads do not divide over n
    "tp" ranks (phi4-mini's 24 at 16), self-attention splits as the
    reference's GSPMD splits it (``head_split``): g = gcd(n_heads, n)
    head groups, each on s = n / g consecutive ranks that hold a slice of
    head_dim (rank r: group r // s, slice r % s; the slice takes the same
    block of both halves of head_dim, so RoPE's rotate-half pairs are
    its own).  ``wq`` / ``wk`` / ``wv`` are column-parallel as they lie
    (a group's heads' columns lie on its s ranks), one all-gather over
    the group (``Mesh.subgroup``) lays them out as the group's heads ×
    the slice, the scores are the slice's partial sums, all-reduced in
    float32 over the group (both ways: each rank's p·v, on its slice,
    gives only its part of the scores' gradient), softmax runs on every
    rank of the group, p·v on the slice, the output is gathered over the
    group and ``wo`` is row-parallel; a prefill moves each cache from
    that layout to its head_dim split at rest in one all-to-all over
    "tp".  Where the vocabulary does not divide over "tp", the token
    table splits d_model there at rest (mamba2's 50280 at 16): the
    embedding looks up the rank's columns and gathers them over "tp",
    and a tied head contracts the rank's columns, its partial logits
    all-reduced.  A block that fits neither (``head_split`` is None;
    ``attn_impl="pallas"``, whose kernel finishes each head's softmax in
    one launch) gathers what "tp" splits and computes whole, the same on
    every "model" rank, but for the decode on a head_dim-split cache.
  * **Parameters are gathered per layer**: a block gathers every dim its
    parameters' specs split over the dp axes ("fsdp"), and over "tp" too
    where it computes whole, when it runs, inside the remat region, so the
    backward pass gathers them again rather than keeping them
    (``collectives.materialize``; ``keep=("model",)`` leaves a
    tensor-parallel block's "tp" dims local).  The gather's backward sums
    the gradient over the dp axes (a reduce-scatter where a dim is split
    over them) and keeps this rank's slice: a "tp"-split gradient is the
    rank's own, and the replicas of a whole block's compute are never
    summed twice.
  * **"dp" splits the batch**: an entry point takes the whole batch and
    runs on this rank's rows when the batch divides over dp
    (``batch_split``); the uint8 quantization of the approximate
    multiplier then takes its scale from the min and max over every rank's
    rows (``models/quant.py``), so it is the unsharded scale.  Caches are
    gathered where a spec splits what the compute keeps whole
    (``reshard``), but for the sequence-split decode and the decode on a
    head_dim-split cache.
  * **Expert parallelism** (``moe.moe_ffn_ep``) and the **sequence-split
    decode** (``attention.decode_self_attention(seq_axes=...)``) run with
    explicit collectives, as the reference's ``shard_map``s do: each
    "model" rank computes only its experts and the outputs are summed; each
    dp rank attends to its rows of the cache and the partial softmaxes
    merge by log-sum-exp.
"""
from __future__ import annotations

import contextlib
import itertools
import math
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist

# logical -> physical axes (the reference's ``LOGICAL``): "pod" is folded
# into data parallelism for the LM and is the grid partition alone for the
# CGP sweep
LOGICAL = {
    "dp": ("pod", "data"),
    "fsdp": ("pod", "data"),
    "sp": ("pod", "data"),   # sequence sharding reuses the data axes
    "tp": ("model",),
    "sweep": ("pod",),
}

_ACTIVE_MESH: "Mesh | None" = None


def rank_grid(shape: Sequence[int]) -> np.ndarray:
    """The ranks of a mesh of ``shape``, row-major: ``jax.make_mesh``'s
    device order for host devices of the same count."""
    return np.arange(math.prod(shape)).reshape(tuple(shape))


def default_device(rank: int) -> torch.device:
    """This rank's card: one card per rank, wrapping round the cards
    present (ranks that share a card need ``gloo``)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch path")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _as_axes(entry) -> tuple:
    """A physical spec entry (None, an axis, a tuple of axes) as a tuple."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


class AbstractMesh:
    """Named axes over ``prod(shape)`` ranks, row-major, without a process
    group: what the spec functions and shape checks need (the reference's
    ``jax.sharding.AbstractMesh``).  ``shape`` maps each axis name to its
    size."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != \
                len(axis_names):
            raise ValueError(f"mesh shape {shape} and axis names "
                             f"{axis_names} do not match")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.devices = rank_grid(shape)

    def _check(self, name: str) -> None:
        if name not in self.shape:
            raise ValueError(f"mesh has no axis {name!r} (have: "
                             f"{self.axis_names})")

    def axis_size(self, name: str) -> int:
        self._check(name)
        return self.shape[name]

    def size(self, axes: Sequence[str]) -> int:
        """The number of ranks along ``axes`` (1 for none)."""
        for a in axes:
            self._check(a)
        return math.prod(self.shape[a] for a in axes)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.shape})"


class Mesh(AbstractMesh):
    """The ranks of the initialized ``torch.distributed`` world over named
    axes.

    ``devices`` is the rank grid.  Construction is collective: every rank
    creates one process group per line along each non-empty set of axes
    (a single axis, or a tuple such as dp's (pod, data)), all of them in
    the same order, and keeps the ones it belongs to; a group's ranks
    follow the row-major coordinate over its axes.  ``device`` is this
    rank's device (default: its card, ``default_device``); ``backend`` the
    groups' (default: the world's).
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device: torch.device | str | None = None,
                 backend: str | None = None):
        super().__init__(shape, axis_names)
        if not dist.is_initialized():
            raise RuntimeError("Mesh needs an initialized torch.distributed "
                               "process group")
        world = dist.get_world_size()
        shape = tuple(self.shape.values())
        if math.prod(shape) != world:
            raise ValueError(f"mesh shape {shape} needs {math.prod(shape)} "
                             f"ranks, the world has {world}")
        self.rank = dist.get_rank()
        self.coords = dict(zip(self.axis_names, (
            int(c) for c in np.unravel_index(self.rank, shape))))
        self.device = (default_device(self.rank) if device is None
                       else torch.device(device))
        self._groups = {}
        self._backend = backend
        n = len(self.axis_names)
        for k in range(1, n + 1):
            for dims in itertools.combinations(range(n), k):
                axes = tuple(self.axis_names[i] for i in dims)
                rest = [i for i in range(n) if i not in dims]
                lines = np.transpose(self.devices, rest + list(dims)
                                     ).reshape(-1, self.size(axes))
                for line in lines:
                    group = dist.new_group(line.tolist(), backend=backend)
                    if self.rank in line:
                        self._groups[axes] = group

    def group(self, axes: Sequence[str]):
        """This rank's process group along ``axes`` (in mesh order); its
        group ranks follow the row-major coordinate over them."""
        axes = tuple(a for a in self.axis_names if a in tuple(axes))
        if not axes:
            raise ValueError("a group needs at least one axis")
        return self._groups[axes]

    def subgroup(self, axes: Sequence[str], size: int):
        """This rank's process group of ``size`` consecutive ranks along
        ``axes`` (by row-major coordinate over them: the reference's
        replica groups ``[n / size, size]<=[n]``).  Made on first use, by
        every rank in the same order (every line's blocks, in the order
        the constructor makes its groups), so it is collective as
        construction is."""
        axes = tuple(a for a in self.axis_names if a in tuple(axes))
        n = self.size(axes)
        if size < 1 or n % size:
            raise ValueError(f"{n} ranks along {axes} do not split into "
                             f"blocks of {size}")
        if size == n:
            return self.group(axes)
        key = (axes, size)
        if key not in self._groups:
            dims = [self.axis_names.index(a) for a in axes]
            rest = [i for i in range(len(self.axis_names)) if i not in dims]
            lines = np.transpose(self.devices, rest + dims).reshape(-1, n)
            for block in lines.reshape(-1, size):
                group = dist.new_group(block.tolist(),
                                       backend=self._backend)
                if self.rank in block:
                    self._groups[key] = group
        return self._groups[key]

    def axis_group(self, name: str):
        """This rank's process group along axis ``name``; its group ranks
        follow the axis coordinate."""
        self._check(name)
        return self._groups[(name,)]

    def axis_index(self, name: str) -> int:
        """This rank's coordinate along axis ``name``."""
        self._check(name)
        return self.coords[name]

    def index(self, axes: Sequence[str]) -> int:
        """This rank's row-major coordinate over ``axes`` (0 for none)."""
        i = 0
        for a in axes:
            i = i * self.axis_size(a) + self.coords[a]
        return i

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank} at {self.coords}, "
                f"{self.device})")


class Sharding:
    """A tensor's layout on a mesh: per dim, None (whole), one axis or a
    tuple of axes splitting it (the reference's ``NamedSharding``; dims
    past ``dims`` are whole).  A split dim is cut into equal blocks in
    row-major order of its axes."""

    def __init__(self, mesh: AbstractMesh, dims: Sequence):
        self.mesh = mesh
        self.dims = tuple(dims)

    def axes(self, d: int) -> tuple:
        """The axes splitting dim ``d``."""
        return _as_axes(self.dims[d]) if d < len(self.dims) else ()

    def _check(self, shape: Sequence[int]) -> None:
        if len(self.dims) > len(shape):
            raise ValueError(f"spec {self.dims} has more dims than shape "
                             f"{tuple(shape)}")
        for d, n in enumerate(shape):
            k = self.mesh.size(self.axes(d))
            if n % k:
                raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                                 f"over {self.axes(d)} ({k} ranks)")

    def shard_shape(self, shape: Sequence[int]) -> tuple:
        """The local shape of a tensor of global ``shape`` (the reference's
        ``NamedSharding.shard_shape``)."""
        self._check(shape)
        return tuple(n // self.mesh.size(self.axes(d))
                     for d, n in enumerate(shape))

    def index(self, shape: Sequence[int]) -> tuple:
        """This rank's block of a tensor of global ``shape``: one slice per
        dim."""
        local = self.shard_shape(shape)
        return tuple(slice(self.mesh.index(self.axes(d)) * m,
                           (self.mesh.index(self.axes(d)) + 1) * m)
                     for d, m in enumerate(local))

    def __repr__(self) -> str:
        return f"Sharding({self.dims})"


def set_mesh(mesh: AbstractMesh | None) -> None:
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def get_mesh() -> AbstractMesh | None:
    return _ACTIVE_MESH


@contextlib.contextmanager
def use_mesh(mesh: AbstractMesh):
    old = get_mesh()
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(old)


_BATCH_SPLIT = False


def batch_split() -> bool:
    """True while an entry point runs on this rank's rows of a batch split
    over the dp axes (``split_batch``)."""
    return _BATCH_SPLIT and get_mesh() is not None


@contextlib.contextmanager
def split_batch(split: bool):
    """Within the block, activations are this rank's dp rows (``split``)
    or the whole batch on every rank."""
    global _BATCH_SPLIT
    old, _BATCH_SPLIT = _BATCH_SPLIT, bool(split)
    try:
        yield
    finally:
        _BATCH_SPLIT = old


def resolve_axis(logical: str | None) -> Any:
    """Logical axis -> the physical axes of the active mesh it names: None,
    one axis, or a tuple of axes (the reference's ``resolve_axis``)."""
    mesh = get_mesh()
    if logical is None or mesh is None:
        return None
    phys = tuple(a for a in LOGICAL.get(logical, (logical,))
                 if a in mesh.axis_names)
    if not phys:
        return None
    return phys if len(phys) > 1 else phys[0]


def axes_of(logical: str) -> tuple:
    """``resolve_axis`` as a tuple (empty with no mesh or no such axis)."""
    return _as_axes(resolve_axis(logical))


def is_logical_spec(s) -> bool:
    """True for a plain tuple of axis names / None (a named tuple such as
    ``SSMState`` is a container, not a spec)."""
    return (type(s) is tuple
            and all(e is None or isinstance(e, str) for e in s))


def map_specs(fn, spec_tree):
    """``fn`` over a logical-spec tree: spec tuples are the leaves; dicts,
    lists and named tuples are containers."""
    if is_logical_spec(spec_tree):
        return fn(spec_tree)
    if isinstance(spec_tree, dict):
        return {k: map_specs(fn, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, tuple) and hasattr(spec_tree, "_fields"):
        return type(spec_tree)(*(map_specs(fn, v) for v in spec_tree))
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(map_specs(fn, v) for v in spec_tree)
    return fn(spec_tree)


def resolve_spec(logical_spec: tuple) -> tuple:
    """The physical spec of a logical one (the reference's
    ``PartitionSpec`` entries, as a tuple)."""
    return tuple(resolve_axis(a) for a in logical_spec)


def named_sharding(logical_spec: tuple) -> Sharding | None:
    """The ``Sharding`` of a logical spec on the active mesh (None with no
    mesh)."""
    mesh = get_mesh()
    if mesh is None:
        return None
    return Sharding(mesh, resolve_spec(tuple(logical_spec)))


def shard(x: torch.Tensor, *logical_spec) -> torch.Tensor:
    """This rank's slice of the whole tensor ``x`` under the spec; ``x``
    itself with no mesh (the reference's sharding constraint)."""
    sh = named_sharding(tuple(logical_spec))
    if sh is None:
        return x
    return x[sh.index(x.shape)].clone()


def axis_size(logical: str) -> int:
    """The rank count along a logical axis (1 with no active mesh, or when
    none of its physical axes is present)."""
    mesh = get_mesh()
    if mesh is None:
        return 1
    return math.prod(mesh.shape[a] for a in LOGICAL.get(logical, (logical,))
                     if a in mesh.axis_names)


def tp_axes() -> tuple:
    """The active mesh's "tp" axes of more than one rank (none with no
    mesh): what a tensor-parallel block splits its compute over."""
    mesh = get_mesh()
    if mesh is None:
        return ()
    return tuple(a for a in axes_of("tp") if mesh.axis_size(a) > 1)


def tp_divides(*dims: int) -> tuple:
    """``tp_axes()`` when every one of ``dims`` (a block's query heads, kv
    heads, ``d_ff``, vocabulary) divides over them, so each "model" rank
    computes its slice of the block; else () (the block computes whole,
    the same on every "model" rank)."""
    tp = tp_axes()
    n = math.prod(get_mesh().axis_size(a) for a in tp) if tp else 1
    return tp if tp and all(d % n == 0 for d in dims) else ()


def hd_split(n_kv_heads: int, head_dim: int) -> tuple:
    """``tp_axes()`` where an attention layer's cache splits head_dim over
    them (the reference's ``cache_specs``: the kv heads do not divide over
    "tp", head_dim does), so a self-attention decode computes on each
    rank's head_dim slice; else ()."""
    tp = tp_axes()
    n = math.prod(get_mesh().axis_size(a) for a in tp) if tp else 1
    return tp if tp and n_kv_heads % n and head_dim % n == 0 else ()


class HeadSplit(NamedTuple):
    """Self-attention over "tp" as head groups × head_dim slices
    (``head_split``): ``groups`` groups of ``n_heads / groups`` query heads
    and ``n_kv_heads / groups`` kv heads, each group's head_dim split in
    ``slices`` slices over ``slices`` consecutive ranks.  This rank is in
    ``group`` and holds ``slice``; ``pg`` is its group's process group."""
    axes: tuple
    groups: int
    slices: int
    group: int
    slice: int
    pg: Any

    def dims(self, head_dim: int, j: int | None = None) -> list:
        """The head_dim indices of slice ``j`` (this rank's by default):
        the j-th of ``slices`` blocks of each half of head_dim, so every
        rotate-half pair (i, i + head_dim / 2) of RoPE lies in one
        slice."""
        j = self.slice if j is None else j
        w, half = head_dim // (2 * self.slices), head_dim // 2
        lo = list(range(j * w, (j + 1) * w))
        return lo + [half + i for i in lo]


def head_split(n_heads: int, n_kv_heads: int, head_dim: int
               ) -> HeadSplit | None:
    """How self-attention splits over the live "tp" axes (n ranks) where
    the query heads do not divide over them (the reference's GSPMD: n / g
    ranks share each of g = gcd(n_heads, n) head groups, each holding a
    slice of head_dim, the scores' partial sums all-reduced over them):
    None where they do divide (``tp_divides``), where there is no "tp",
    or where the split does not fit (each group must hold whole kv
    heads, n_kv_heads % g == 0, each slice whole rotate-half pairs,
    head_dim % (2 · n / g) == 0, and the cache at rest head_dim's blocks,
    head_dim % n == 0): the block then computes whole.  Rank r (row-major
    over the axes) is in group r // s and holds slice r % s, s = n / g."""
    tp = tp_axes()
    if not tp:
        return None
    mesh = get_mesh()
    n = mesh.size(tp)
    g = math.gcd(n_heads, n)
    s = n // g
    if n_heads % n == 0 or n_kv_heads % g or head_dim % (2 * s) or \
            head_dim % n:
        return None
    r = mesh.index(tp)
    return HeadSplit(tp, g, s, r // s, r % s, mesh.subgroup(tp, s))


def pod_count() -> int:
    """Size of the active mesh's ``pod`` axis (1 with no mesh or no pod
    axis)."""
    mesh = get_mesh()
    return mesh.shape["pod"] if mesh is not None and "pod" in mesh.shape \
        else 1


def pod_rank() -> int:
    """This rank's coordinate along the active mesh's ``pod`` axis (0 with
    no mesh or no pod axis)."""
    mesh = get_mesh()
    return mesh.coords["pod"] if mesh is not None and "pod" in mesh.shape \
        else 0


def default_pod_index(n_pods: int) -> int:
    """The pod slice this rank runs: its mesh pod coordinate when the active
    mesh has a pod axis (whose size must be ``n_pods``), else its world rank
    (0 outside a process group), wrapped into range."""
    mesh = get_mesh()
    if mesh is not None and "pod" in mesh.shape:
        if mesh.shape["pod"] != n_pods:
            raise ValueError(
                f"active mesh has a {mesh.shape['pod']}-pod axis but the "
                f"sweep was configured with n_pods={n_pods}; align them or "
                f"pass pod_index explicitly")
        return pod_rank()
    return (dist.get_rank() if dist.is_initialized() else 0) % n_pods
