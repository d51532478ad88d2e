"""The multi-device LM's sharding assembly against the JAX package's, in one
process: every ``*_specs`` tree of the ten configurations
(``param_specs``, ``cache_specs`` and ``stacked_cache_specs`` per shape
cell, ``batch_specs``, ``opt_state_specs`` of the three optimizers)
resolved on the debug meshes and the 256- and 512-rank production meshes,
as abstract meshes (a shape and axis names; no process group, no
devices); each parameter's local shape there, against
``NamedSharding.shard_shape``; and the ``abstract_*`` shapes and dtypes
at full size, against the reference's ``jax.eval_shape``.  Nothing here
is a tolerance: specs, shapes and dtypes are equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec

from repro.configs import base as JB
from repro.launch import steps as JST
from repro.models import model as JM
from repro.optim import OptConfig as JOptConfig
from repro.optim import opt_state_specs as j_opt_specs
from repro.parallel import ctx as jctx
from repro_torch import tree as T
from repro_torch.configs import base as TB
from repro_torch.launch import steps as ST
from repro_torch.models import model as TM
from repro_torch.optim import OptConfig, opt_state_specs
from repro_torch.parallel import ctx

ARCHS = TB.ARCH_IDS
MESHES = {(2, 2, 2): ("pod", "data", "model"), (1, 2): ("data", "model"),
          (2, 4): ("data", "model"), (16, 16): ("data", "model"),
          (2, 16, 16): ("pod", "data", "model")}
OPTS = ("adamw", "adamw8bit", "adafactor")
CACHE_LEN = 128


def _plain(tree):
    """A spec tree as nested dicts of tuples (named tuples by their fields,
    ``PartitionSpec``s as tuples) so both packages' trees compare."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, PartitionSpec):
        return tuple(tree)
    if hasattr(tree, "_fields"):
        return {f: _plain(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, ctx.Sharding):
        return tuple(tree.dims)
    return tuple(tree) if isinstance(tree, (tuple, list)) else tree


class _on:
    """Both packages' active mesh set to the abstract mesh of ``shape``."""

    def __init__(self, shape):
        names = MESHES[shape]
        self.j = AbstractMesh(shape, names)
        self.t = ctx.AbstractMesh(shape, names)

    def __enter__(self):
        self.old = jctx.get_mesh(), ctx.get_mesh()
        jctx.set_mesh(self.j)
        ctx.set_mesh(self.t)
        return self

    def __exit__(self, *exc):
        jctx.set_mesh(self.old[0])
        ctx.set_mesh(self.old[1])
        return False


def _resolved(spec_tree, package):
    res = package.resolve_spec
    return _plain(package.map_specs(lambda s: res(tuple(s)), spec_tree))


@pytest.mark.parametrize("shape", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_are_the_references(arch, shape):
    """Every spec tree, logical and resolved, equals the reference's on the
    mesh: parameters, each shape cell's batch and caches (per period and
    stacked), the three optimizers' state; and ``named_sharding`` gives
    the resolved spec."""
    jcfg, tcfg = JB.get_arch(arch).CONFIG, TB.get_arch(arch).CONFIG
    with _on(shape):
        assert _plain(TM.param_specs(tcfg)) == _plain(JM.param_specs(jcfg))
        assert _resolved(TM.param_specs(tcfg), ctx) == \
            _resolved(JM.param_specs(jcfg), jctx)
        for name in OPTS:
            got = opt_state_specs(TM.param_specs(tcfg), OptConfig(name=name))
            want = j_opt_specs(JM.param_specs(jcfg), JOptConfig(name=name))
            assert _resolved(got, ctx) == _resolved(want, jctx), name
        for cell_t, cell_j in zip(TB.shapes_for(arch), JB.shapes_for(arch)):
            assert _resolved(ST.batch_specs(tcfg, cell_t), ctx) == \
                _resolved(JST.batch_specs(jcfg, cell_j), jctx), cell_t.name
            B = cell_t.global_batch
            assert _resolved(TM.cache_specs(tcfg, B), ctx) == \
                _resolved(JM.cache_specs(jcfg, B), jctx), cell_t.name
            assert _resolved(ST.stacked_cache_specs(tcfg, B), ctx) == \
                _resolved(JST.stacked_cache_specs(jcfg, B), jctx)
        for spec in T.leaves(TM.param_specs(tcfg)):
            sh = ctx.named_sharding(spec)
            assert sh.dims == ctx.resolve_spec(spec)


@pytest.mark.parametrize("shape", [(2, 2, 2), (16, 16), (2, 16, 16)])
@pytest.mark.parametrize("arch", ARCHS)
def test_local_shapes_are_named_shardings(arch, shape):
    """Each full-size parameter's local shape on the mesh is
    ``NamedSharding(mesh, spec).shard_shape``, where its dims divide (the
    reference leaves an uneven split to GSPMD's padding; the port
    raises)."""
    jcfg, tcfg = JB.get_arch(arch).CONFIG, TB.get_arch(arch).CONFIG
    params = _abstract(arch)[0]
    with _on(shape) as m:
        specs = T.leaves(TM.param_specs(tcfg))
        for leaf, spec in zip(T.leaves(params), specs):
            sh = ctx.named_sharding(spec)
            want = NamedSharding(m.j, jctx.resolve_spec(spec))
            if any(n % m.t.size(sh.axes(d)) for d, n in
                   enumerate(leaf.shape)):
                with pytest.raises(ValueError, match="does not split"):
                    sh.shard_shape(leaf.shape)
                continue
            assert sh.shard_shape(leaf.shape) == \
                want.shard_shape(leaf.shape), spec


_CACHE = {}


def _abstract(arch):
    """(the port's abstract params, opt states, cache; the reference's
    eval_shapes of the same), memoized per architecture."""
    if arch not in _CACHE:
        tcfg, jcfg = TB.get_arch(arch).CONFIG, JB.get_arch(arch).CONFIG
        batch = 2
        ours = (ST.abstract_params(tcfg),
                {n: ST.abstract_opt_state(tcfg, OptConfig(name=n))
                 for n in OPTS},
                ST.abstract_cache(tcfg, batch, CACHE_LEN))
        theirs = (JST.abstract_params(jcfg),
                  {n: JST.abstract_opt_state(jcfg, JOptConfig(name=n))
                   for n in OPTS},
                  JST.abstract_cache(jcfg, batch, CACHE_LEN))
        _CACHE[arch] = ours + theirs
    return _CACHE[arch]


def _shape_dtype(x):
    if isinstance(x, torch.Tensor):
        assert x.device.type == "meta"
        return tuple(x.shape), str(x.dtype).split(".")[-1]
    return tuple(x.shape), str(x.dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_shapes_are_eval_shapes(arch):
    """``abstract_params``, ``abstract_opt_state`` (three optimizers) and
    ``abstract_cache`` at full size: every leaf's shape and dtype the
    reference's ``jax.eval_shape``, in the reference's leaf order, on the
    ``meta`` device."""
    p, opts, cache, jp, jopts, jcache = _abstract(arch)
    assert [_shape_dtype(x) for x in T.leaves(p)] == \
        [_shape_dtype(x) for x in jax.tree.leaves(jp)]
    for n in OPTS:
        assert [_shape_dtype(x) for x in T.leaves(opts[n])] == \
            [_shape_dtype(x) for x in jax.tree.leaves(jopts[n])], n
    flat = lambda c: [x for k in sorted(c) for x in (
        c[k] if hasattr(c[k], "_fields") else [c[k][f] for f in
                                               sorted(c[k])])]
    assert [_shape_dtype(x) for x in flat(cache)] == \
        [_shape_dtype(x) for x in jax.tree.leaves(jcache)]
