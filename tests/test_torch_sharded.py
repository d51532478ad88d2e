"""Cube sharding and island evolution over ``torch.distributed``: the port
on the CPU, in spawned gloo ranks, against the JAX package on forced host
devices.

The ranks are processes of ``repro_torch.parallel.spawn.run_ranks`` (a
``file://`` store under ``tmp_path``, a deadline after which the parent
kills them), so a hung collective fails one test.  The reference runs in a
subprocess (``conftest.run_subprocess``) with ``backend="jnp"``: the Pallas
``cgp_sim`` does not trace under the installed JAX.

Exactness follows the port's other differential tests: genomes, keys and
the integer metrics (MAE/WCE/ER/AVG/ACC0/GAUSS) equal the reference's;
power, fitness and MRE are float32 sums taken in another order (rtol
1e-6).  Against the port's own unsharded run the genomes, the final
metrics and ``hist_fit`` are equal bit for bit.
"""
import os
import time

import numpy as np
import pytest
import torch

from conftest import run_subprocess

torch.set_num_threads(1)

RTOL = 1e-6
EXACT_METRICS = [0, 1, 2, 4, 5, 6]     # all but MRE
ISLAND_GENS, ISLAND_MIGRATE = 40, 8


def _assert_metrics(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert np.array_equal(a[..., EXACT_METRICS], b[..., EXACT_METRICS]), what
    np.testing.assert_allclose(a[..., 3], b[..., 3], rtol=RTOL, err_msg=what)


def _assert_close_fit(a, b, what):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert np.array_equal(np.isinf(a), np.isinf(b)), what
    f = np.isfinite(a)
    np.testing.assert_allclose(a[f], b[f], rtol=RTOL, err_msg=what)


def _ranks(fn, world, tmp_path, *args, timeout_s=240.0):
    from repro_torch.parallel.spawn import run_ranks
    return run_ranks(fn, world, *args, timeout_s=timeout_s,
                     workdir=str(tmp_path))


# ---------------------------------------------------------------------------
# PRNG and mesh layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, -3, 2 ** 31 - 1])
@pytest.mark.parametrize("data", [0, 1, 5, 2 ** 31 - 1, 2 ** 32 - 1])
def test_fold_in_matches_jax(seed, data):
    import jax
    from repro_torch import random as R
    want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed),
                                         np.uint32(data)), np.int64)
    assert np.array_equal(R.fold_in(R.PRNGKey(seed), data).numpy(), want)


@pytest.mark.parametrize("seed,n", [(0, 2), (3, 8), (11, 1)])
def test_island_keys_match_jax(seed, n):
    from repro.core.evolve import make_island_keys as j_keys
    from repro_torch.core.evolve import make_island_keys
    assert np.array_equal(make_island_keys(seed, n).numpy(),
                          np.asarray(j_keys(seed, n), np.int64))


MESH_SHAPES = [(2, 2, 2), (2, 4), (8,), (1, 1, 2), (4, 1, 2), (2, 1, 4)]


@pytest.fixture(scope="module")
def jax_mesh_orders():
    out = run_subprocess(f"""
import jax
for shape in {MESH_SHAPES!r}:
    n = 1
    for s in shape:
        n *= s
    names = ('pod', 'data', 'model')[-len(shape):]
    mesh = jax.make_mesh(shape, names, devices=jax.devices()[:n])
    print(shape, [d.id for d in mesh.devices.flat])
""", devices=8)
    return out


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_rank_layout_matches_jax_make_mesh(shape, jax_mesh_orders):
    from repro_torch.parallel.ctx import rank_grid
    line = f"{shape} {rank_grid(shape).flatten().tolist()}"
    assert line in jax_mesh_orders.splitlines(), jax_mesh_orders


def _mesh_rank(rank, world):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.parallel import ctx
    mesh = make_debug_mesh(n_data=2, n_model=2, pods=2, device="cpu")
    out = {"coords": mesh.coords, "size": {a: mesh.axis_size(a)
                                           for a in mesh.axis_names}}
    for a in mesh.axis_names:
        g = mesh.axis_group(a)
        x = torch.tensor([rank])
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(g))]
        dist.all_gather(parts, x, group=g)
        out[a] = [int(p) for p in parts]
    with ctx.use_mesh(mesh):
        out["pods"] = (ctx.pod_count(), ctx.pod_rank(),
                       ctx.default_pod_index(2))
    out["after"] = ctx.get_mesh()
    return out


def test_mesh_axes_groups_and_pods(tmp_path):
    from repro_torch.parallel.ctx import rank_grid
    grid = rank_grid((2, 2, 2))
    outs = _ranks(_mesh_rank, 8, tmp_path)
    for rank, out in enumerate(outs):
        p, d, m = (int(c) for c in np.argwhere(grid == rank)[0])
        assert out["coords"] == {"pod": p, "data": d, "model": m}
        assert out["size"] == {"pod": 2, "data": 2, "model": 2}
        # group ranks follow the axis coordinate
        assert out["pod"] == grid[:, d, m].tolist()
        assert out["data"] == grid[p, :, m].tolist()
        assert out["model"] == grid[p, d, :].tolist()
        assert out["pods"] == (2, p, p)
        assert out["after"] is None


def _error_rank(rank, world):
    from repro_torch.core.evolve import EvolveConfig
    from repro_torch.core.fitness import ConstraintSpec
    from repro_torch.core.search import SearchConfig
    from repro_torch.core.sweep import SweepConfig, run_sweep_batched
    from repro_torch.launch import mesh as meshes
    from repro_torch.parallel import ctx
    from repro_torch.parallel.ctx import Mesh
    msgs = {}
    for name, call in (
            ("shape", lambda: Mesh((2, 2), ("data", "model"), "cpu")),
            ("pods", lambda: meshes.make_sweep_mesh(3, device="cpu")),
            ("debug", lambda: meshes.make_debug_mesh(2, 2, device="cpu")),
            ("prod", lambda: meshes.make_production_mesh(device="cpu"))):
        try:
            call()
        except ValueError as e:
            msgs[name] = str(e)
    mesh = meshes.make_host_mesh(device="cpu")
    cfg = SearchConfig(width=2, kind="add", n_n=10,
                       evolve=EvolveConfig(generations=1, lam=2))
    with ctx.use_mesh(mesh):
        try:
            run_sweep_batched(cfg, [ConstraintSpec(mae=1.0)], (0,),
                              SweepConfig(model_axis="pod"), device="cpu")
        except ValueError as e:
            msgs["axis"] = str(e)
        try:   # width 2: a 1-word cube cannot split over 2 ranks
            run_sweep_batched(cfg, [ConstraintSpec(mae=1.0)], (0,),
                              SweepConfig(model_axis="model"), device="cpu")
        except ValueError as e:
            msgs["split"] = str(e)
        msgs["pod_index"] = ctx.default_pod_index(2)   # no pod axis
    mesh = meshes.make_sweep_mesh(2, device="cpu")
    with ctx.use_mesh(mesh):
        try:
            ctx.default_pod_index(4)
        except ValueError as e:
            msgs["n_pods"] = str(e)
    return msgs


def test_mesh_errors(tmp_path):
    """A world that does not fit the mesh raises, as ``jax.make_mesh``
    does for a device count that does not; so does a ``model_axis`` the
    active mesh lacks, and a cube that does not split over the axis."""
    for rank, msgs in enumerate(_ranks(_error_rank, 2, tmp_path)):
        assert "needs 4 ranks, the world has 2" in msgs["shape"]
        assert msgs["pods"] == "2 devices not divisible into 3 pods"
        assert "needs 4 ranks" in msgs["debug"]
        assert "needs 256 ranks" in msgs["prod"]
        assert "model_axis 'pod' needs an active parallel.ctx mesh" \
            in msgs["axis"]
        assert "do not split over the 2 ranks" in msgs["split"]
        assert msgs["pod_index"] == rank
        assert "2-pod axis but the sweep was configured with n_pods=4" \
            in msgs["n_pods"]


def test_model_axis_without_a_mesh_raises():
    from repro_torch.core.fitness import ConstraintSpec
    from repro_torch.core.search import SearchConfig
    from repro_torch.core.sweep import SweepConfig, run_sweep_batched
    from repro_torch.parallel.ctx import Mesh
    with pytest.raises(ValueError, match=r"model_axis 'model' needs an "
                       r"active parallel.ctx mesh carrying that axis "
                       r"\(have: None\)"):
        run_sweep_batched(SearchConfig(width=2, kind="add", n_n=10),
                          [ConstraintSpec(mae=1.0)], (0,),
                          SweepConfig(model_axis="model"), device="cpu")
    with pytest.raises(RuntimeError, match="initialized"):
        Mesh((1,), ("model",), "cpu")


def _fails_rank(rank, world, how):
    if rank == 1:
        if how == "raise":
            raise RuntimeError("rank one fails")
        time.sleep(60)
    return rank


@pytest.mark.parametrize("how", ["raise", "hang"])
def test_run_ranks_fails_for_a_bad_rank(how, tmp_path):
    from repro_torch.parallel.spawn import run_ranks
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1"):
        run_ranks(_fails_rank, 2, how, timeout_s=20.0,
                  workdir=str(tmp_path))
    assert time.monotonic() - t0 < 50
    assert os.listdir(tmp_path) == []


# ---------------------------------------------------------------------------
# The sharded evaluation on word slices
# ---------------------------------------------------------------------------

def _genomes(spec, gold, R, seed):
    from repro_torch.core.genome import Genome
    rng = np.random.default_rng(seed)
    hi = spec.n_i + np.arange(spec.n_n)
    nodes = np.stack([rng.integers(0, hi, (R, spec.n_n)),
                      rng.integers(0, hi, (R, spec.n_n)),
                      rng.integers(0, 8, (R, spec.n_n))], axis=-1)
    outs = rng.integers(0, spec.n_wires, (R, spec.n_o))
    near = np.arange(R) % 2 == 0       # mostly right: small errors too
    mut = rng.random((R, spec.n_n, 3)) < 0.05
    nodes[near] = np.where(mut[near], nodes[near], gold.nodes.numpy())
    outs[near] = gold.outs.numpy()
    return Genome(torch.as_tensor(nodes, dtype=torch.int32),
                  torch.as_tensor(outs, dtype=torch.int32))


NODES = {3: 60, 4: 120, 5: 200}      # room for each golden circuit


def _slice_rank(rank, world, widths):
    from repro_torch.core import metrics as M
    from repro_torch.core.search import SearchConfig, problem_arrays
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(device="cpu")
    group = mesh.axis_group("model")
    out = []
    for width in widths:
        for kind in ("mul", "add"):
            gold, spec, planes, gvals, _ = problem_arrays(
                SearchConfig(width=width, kind=kind, n_n=NODES[width]), "cpu")
            g = _genomes(spec, gold, 6, width)
            W = planes.shape[1] // world
            lo, hi = rank * W, (rank + 1) * W
            for sigma in (256.0, 1.5):
                whole, wpops = ref.cgp_eval_ref(g, spec, planes, gvals, sigma)
                p, pops = ops.cgp_eval_batched(
                    g, spec, planes[:, lo:hi].contiguous(),
                    gvals[32 * lo:32 * hi].contiguous(), sigma, group=group)
                local, _ = ref.cgp_eval_ref(g, spec, planes[:, lo:hi],
                                            gvals[32 * lo:32 * hi], sigma)
                comb = M.combine_partials(local, group)
                out.append((width, kind, sigma,
                            {k: v.numpy() for k, v in p._asdict().items()},
                            {k: v.numpy() for k, v in comb._asdict().items()},
                            {k: v.numpy() for k, v in whole._asdict().items()},
                            pops.numpy(), wpops.numpy()))
    return out


@pytest.mark.parametrize("S,widths", [(2, (3, 4, 5)), (4, (4, 5))])
def test_plain_sharded_equals_whole_cube(S, widths, tmp_path):
    """``ops.cgp_eval_batched`` with a group on CPU tensors (the plain
    sharded version: ``cgp_eval_ref`` on each rank's slice, then
    ``combine_partials`` and a SUM of the popcounts) gives the whole cube's
    partials: integer fields and magnitude sums equal, the float rows
    within rtol 1e-6.  Width 3's two-word cube has no 4-way split."""
    outs = _ranks(_slice_rank, S, tmp_path, widths)
    for rows in outs:
        assert len(rows) == 4 * len(widths)
        for width, kind, sigma, got, comb, whole, pops, wpops in rows:
            what = f"S={S} w{width} {kind} σ={sigma}"
            assert np.array_equal(pops, wpops), what
            for k, want in whole.items():
                for have in (got, comb):
                    if k in ("rel_sum", "sq_sum", "rel_sq"):
                        np.testing.assert_allclose(have[k], want, rtol=RTOL,
                                                   err_msg=f"{what} {k}")
                    else:
                        assert np.array_equal(have[k], want), f"{what} {k}"
                        assert have[k].dtype == want.dtype, f"{what} {k}"
    for rows in outs[1:]:         # every rank holds the same result
        for a, b in zip(rows, outs[0]):
            for x, y in zip(a[3:], b[3:]):
                if isinstance(x, dict):
                    assert all(np.array_equal(x[k], y[k]) for k in x)
                else:
                    assert np.array_equal(x, y)


@pytest.mark.parametrize("W", [1, 2, 4, 16, 32, 48, 1024])
@pytest.mark.parametrize("layout,block_words", [
    ("genome_major", None), ("cube_major", None), ("genome_major", 512),
    ("cube_major", 64), ("cube_major", 512)])
def test_runs_fit_a_slice(W, layout, block_words):
    """The kernel's partition of a word slice: at least one tile a run, no
    run past the slice, and the run a block stages fits shared memory —
    for slices shorter than a tile, off the tile grid, and knobs whose run
    is longer than the slice (width 8, 400 nodes, R = 256)."""
    from repro_torch.kernels import cgp_sim
    tiles = cgp_sim.run_tiles(layout, block_words, 256, W, 16, 400, 16, 132)
    n_tiles = -(-W // cgp_sim.TILE)
    assert 1 <= tiles <= n_tiles
    if layout == "cube_major":
        assert cgp_sim.smem_bytes(16, 400, 16, tiles) <= \
            cgp_sim.MAX_SMEM_BYTES


# ---------------------------------------------------------------------------
# (i) the model-axis sweep
# ---------------------------------------------------------------------------

SWEEP = dict(width=3, kind="mul", n_n=60, gens=30, lam=3, chunk=3,
             cons=[dict(mae=2.0), dict(er=50.0)], seeds=(0, 1))


# the evaluation inputs of the sharded sweep: the cube, or a 128-row sample
# (4 words, 2 a rank)
EVAL_MODES = {"exhaustive": {},
              "sampled": dict(eval_mode="sampled", sample_size=128,
                              input_dist="gaussian")}


def _port_sweep_cfg(mode="exhaustive"):
    from repro_torch.core.evolve import EvolveConfig
    from repro_torch.core.fitness import ConstraintSpec
    from repro_torch.core.search import SearchConfig
    cfg = SearchConfig(width=SWEEP["width"], kind=SWEEP["kind"],
                       n_n=SWEEP["n_n"], evolve=EvolveConfig(
                           generations=SWEEP["gens"], lam=SWEEP["lam"],
                           **EVAL_MODES[mode]))
    return cfg, [ConstraintSpec(**c) for c in SWEEP["cons"]]


def _sweep_rank(rank, world, results_dir, mode):
    from repro_torch.core.sweep import SweepConfig, run_sweep_batched
    from repro_torch.launch.mesh import make_sweep_mesh
    from repro_torch.parallel import ctx
    cfg, cons = _port_sweep_cfg(mode)
    mesh = make_sweep_mesh(pods=1, device="cpu")
    with ctx.use_mesh(mesh):
        res = run_sweep_batched(cfg, cons, SWEEP["seeds"], SweepConfig(
            chunk_size=SWEEP["chunk"], model_axis="model",
            results_dir=results_dir))
    return ([(r.genome_nodes, r.genome_outs, r.metrics) for r in res.records],
            res.hist_fit, res.reader().manifest["grid_fingerprint"])


def _shard_bytes(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d)) if f.startswith("shard_")}


@pytest.mark.parametrize("mode", list(EVAL_MODES))
def test_model_axis_sweep_matches_jax_and_unsharded(mode, tmp_path):
    """The sweep with its cube (or its sample's words) sharded over 2 gloo
    ranks against the reference's ``model_axis`` sweep on 2 forced host
    devices and the port's unsharded run."""
    from repro_torch.core.sweep import SweepConfig, run_sweep_batched
    out = tmp_path / "jax.npz"
    run_subprocess(f"""
import sys
import numpy as np
from repro.core.evolve import EvolveConfig
from repro.core.fitness import ConstraintSpec
from repro.core.search import SearchConfig
from repro.core.sweep import SweepConfig, run_sweep_batched
from repro.launch.mesh import make_sweep_mesh
from repro.parallel import ctx
S = {SWEEP!r}
cfg = SearchConfig(width=S['width'], kind=S['kind'], n_n=S['n_n'],
                   evolve=EvolveConfig(generations=S['gens'], lam=S['lam'],
                                       backend='jnp',
                                       **{EVAL_MODES[mode]!r}))
cons = [ConstraintSpec(**c) for c in S['cons']]
with ctx.use_mesh(make_sweep_mesh(pods=1)):
    res = run_sweep_batched(cfg, cons, S['seeds'], SweepConfig(
        chunk_size=S['chunk'], model_axis='model'))
np.savez({str(out)!r},
         nodes=np.stack([r.genome_nodes for r in res.records]),
         outs=np.stack([r.genome_outs for r in res.records]),
         metrics=np.stack([r.metrics for r in res.records]),
         stderr=np.stack([r.metrics_stderr for r in res.records]),
         hist_fit=res.hist_fit)
""", devices=2)
    ref = np.load(out)
    cfg, cons = _port_sweep_cfg(mode)
    plain = run_sweep_batched(cfg, cons, SWEEP["seeds"], SweepConfig(
        chunk_size=SWEEP["chunk"], results_dir=str(tmp_path / "plain")),
        device="cpu")
    if mode == "sampled":
        assert plain.metrics_stderr.any()
        np.testing.assert_allclose(plain.metrics_stderr, ref["stderr"],
                                   rtol=1e-5, atol=0)
    outs = _ranks(_sweep_rank, 2, tmp_path, str(tmp_path / "sharded"), mode)
    n = len(SWEEP["cons"]) * len(SWEEP["seeds"])
    for records, hist_fit, fingerprint in outs:
        assert len(records) == plain.completed == n
        assert fingerprint == plain.reader().manifest["grid_fingerprint"]
        assert np.array_equal(hist_fit, plain.hist_fit)
        for i, ((nodes, o, met), r) in enumerate(zip(records, plain.records)):
            assert np.array_equal(nodes, r.genome_nodes), i
            assert np.array_equal(o, r.genome_outs), i
            assert np.array_equal(met, r.metrics), i
            assert np.array_equal(nodes, ref["nodes"][i]), i
            assert np.array_equal(o, ref["outs"][i]), i
            _assert_metrics(met, ref["metrics"][i], f"run {i}")
        _assert_close_fit(hist_fit, ref["hist_fit"], "hist_fit")
    # one writer: the shard files of the unsharded sweep, the histories'
    # MRE column aside (summed per slice in float32, as the reference does)
    a, b = _shard_bytes(tmp_path / "plain"), _shard_bytes(tmp_path / "sharded")
    assert a.keys() == b.keys()
    for f in a:
        za, zb = np.load(tmp_path / "plain" / f), \
            np.load(tmp_path / "sharded" / f)
        assert za.files == zb.files
        for k in za.files:
            if k == "hist_metrics":
                _assert_metrics(zb[k], za[k], f"{f} {k}")
            else:
                assert np.array_equal(za[k], zb[k]), f"{f} {k}"


def test_fingerprint_hashes_migrate_every():
    import dataclasses
    from repro.core.evolve import EvolveConfig as JEvolveConfig
    from repro.core.fitness import ConstraintSpec as JConstraint
    from repro.core.search import SearchConfig as JSearchConfig
    from repro.core.sweep import grid_fingerprint as j_fingerprint
    from repro.core.sweep import sweep_grid as j_grid
    from repro_torch.core.sweep import grid_fingerprint, sweep_grid
    cfg, cons = _port_sweep_cfg()
    fps = set()
    for every in (64, 16):
        tcfg = dataclasses.replace(cfg, evolve=dataclasses.replace(
            cfg.evolve, migrate_every=every))
        jcfg = JSearchConfig(width=3, kind="mul", n_n=60, evolve=JEvolveConfig(
            generations=SWEEP["gens"], lam=SWEEP["lam"], migrate_every=every))
        want = j_fingerprint(jcfg, j_grid([JConstraint(**c) for c in
                                           SWEEP["cons"]], (0, 1)), "summary")
        got = grid_fingerprint(tcfg, sweep_grid(cons, (0, 1)), "summary")
        assert got == want
        fps.add(got)
    assert len(fps) == 2


# ---------------------------------------------------------------------------
# (ii) evolve_sharded: islands, migration, pods
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_islands(tmp_path_factory):
    out = tmp_path_factory.mktemp("islands") / "jax.npz"
    run_subprocess(f"""
import jax, jax.numpy as jnp, numpy as np
from repro.core import golden as G, simulate as S
from repro.core.evolve import EvolveConfig, evolve_sharded, make_island_keys
from repro.core.fitness import ConstraintSpec
from repro.core.power import circuit_cost_from_probs
from repro.parallel import ctx
mesh = jax.make_mesh((2, 2, 2), ('pod', 'data', 'model'))
gold, spec = G.array_multiplier(4, n_n=120)
planes = S.input_planes(spec.n_i)
gvals = jnp.asarray(G.golden_values(4, 'mul'))
wires = S.simulate_planes(gold, spec, planes)
probs = S.signal_probabilities(wires[spec.n_i:], spec.n_inputs_total)
gpower = circuit_cost_from_probs(gold, spec, probs).power
cfg = EvolveConfig(generations={ISLAND_GENS}, lam=4,
                   migrate_every={ISLAND_MIGRATE})
thr = jnp.stack([jnp.asarray(ConstraintSpec(mae=2.0).thresholds()),
                 jnp.asarray(ConstraintSpec(mae=0.5, er=60.0).thresholds())])
with ctx.use_mesh(mesh):
    fn = evolve_sharded(mesh, spec, cfg, gold, thr, gpower, pod_axis='pod')
    out = jax.jit(fn)(thr, make_island_keys(0, 2), planes, gvals)
np.savez({str(out)!r}, *[np.asarray(x) for x in jax.tree.leaves(out)])
""", devices=8)
    z = np.load(out)
    return [z[f"arr_{i}"] for i in range(len(z.files))]


def _island_rank(rank, world, shape):
    from repro_torch.core.evolve import (EvolveConfig, evolve_sharded,
                                         make_island_keys)
    from repro_torch.core.fitness import ConstraintSpec
    from repro_torch.core.search import SearchConfig, problem_arrays
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.parallel import ctx
    pods, data, model = shape
    mesh = make_debug_mesh(n_data=data, n_model=model, pods=pods,
                           device="cpu")
    gold, spec, planes, gvals, gpower = problem_arrays(
        SearchConfig(width=4, kind="mul", n_n=120), "cpu")
    cfg = EvolveConfig(generations=ISLAND_GENS, lam=4,
                       migrate_every=ISLAND_MIGRATE)
    thr = torch.stack([torch.as_tensor(c.thresholds()) for c in (
        ConstraintSpec(mae=2.0), ConstraintSpec(mae=0.5, er=60.0))])
    with ctx.use_mesh(mesh):
        fn = evolve_sharded(mesh, spec, cfg, gold, thr, gpower,
                            pod_axis="pod")
        parent, best, best_fit, hp, hm, hf = fn(
            thr, make_island_keys(0, data), planes, gvals)
    return [x.numpy() for x in (parent.nodes, parent.outs, best.nodes,
                                best.outs, best_fit, hp, hm, hf)]


@pytest.mark.parametrize("shape", [(2, 2, 2), (2, 2, 1)])
def test_evolve_sharded_matches_jax(shape, jax_islands, tmp_path):
    """Two pods (two constraint vectors) × two islands × a cube sharded
    over ``model``, migrating every 8 of 40 generations: every rank returns
    the reference's per-island (pod 0's) parents, best genomes, best
    fitness and histories, whatever the model axis."""
    outs = _ranks(_island_rank, int(np.prod(shape)), tmp_path, shape)
    pn, po, bn, bo, bf, hp, hm, hf = jax_islands
    assert hp.shape == (2, ISLAND_GENS)
    for rank, (tpn, tpo, tbn, tbo, tbf, thp, thm, thf) in enumerate(outs):
        what = f"{shape} rank {rank}"
        for a, b in ((tpn, pn), (tpo, po), (tbn, bn), (tbo, bo)):
            assert a.shape == b.shape and np.array_equal(a, b), what
        _assert_close_fit(tbf, bf, f"{what} best_fit")
        _assert_close_fit(thf, hf, f"{what} hist_fit")
        np.testing.assert_allclose(thp, hp, rtol=RTOL, err_msg=what)
        _assert_metrics(thm, hm, f"{what} hist_metrics")
        for a, b in zip(outs[rank], outs[0]):
            assert np.array_equal(a, b), what
    # migration happened: after the last exchange both islands hold the
    # better parent, though their streams differ
    assert np.array_equal(hf[0, ISLAND_MIGRATE - 1],
                          hf[1, ISLAND_MIGRATE - 1])
