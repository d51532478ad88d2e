"""The port's kernel-layout tuning (``repro_torch.kernels.tune``) and the
``layout`` knob's resolution, on the CPU.

The table logic is held against ``repro.kernels.tune.resolve_variant`` on
the same JSON content (exact entry, nearest R, miss); ``random_genome``,
from which ``autotune`` draws its population, is bit-identical to the JAX
package's.  Timing needs the card: here ``autotune`` runs with a stub
timer that never launches the kernel.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.core.genome import CGPSpec as JSpec
from repro.core.genome import random_genome as j_random_genome
from repro.kernels import tune as j_tune
from repro_torch import random as R
from repro_torch.core.genome import CGPSpec, random_genome
from repro_torch.kernels import cgp_sim, ops, tune

ENTRIES = {
    "w8_r256_cuda_sm90": {"layout": "cube_major", "block_words": 64,
                          "r_tile": 2},
    "w8_r32_cuda_sm90": {"layout": "genome_major", "block_words": 512,
                         "r_tile": 1},
    "w8_r256_cpu": {"layout": "genome_major", "block_words": 128,
                    "r_tile": 1},
    "w8_r256_cuda_sm80": {"layout": "genome_major", "block_words": 256,
                          "r_tile": 1},
    "w4_r8_cuda_sm90": {"layout": "cube_major", "block_words": 8,
                        "r_tile": 8},
}


@pytest.fixture
def table(tmp_path):
    path = tmp_path / "kernel_layout.json"
    path.write_text(json.dumps({"version": 1, "entries": ENTRIES}))
    return str(path)


@pytest.mark.parametrize("width,R,backend", [
    (8, 256, "cuda_sm90"),     # exact
    (8, 200, "cuda_sm90"),     # nearest R: 256
    (8, 40, "cuda_sm90"),      # nearest R: 32
    (8, 1000, "cpu"),          # nearest R in its own backend only
    (8, 256, "cuda_sm80"),
    (4, 1, "cuda_sm90"),
])
def test_resolution_matches_jax(table, width, R, backend):
    got = tune.resolve_variant(width, R, backend, table)
    want = j_tune.resolve_variant(width, R, backend, table)
    assert (got.layout, got.block_words, got.r_tile) == (
        want.layout, want.block_words, want.r_tile)
    assert tune.resolve_layout(width, R, backend, table) == \
        j_tune.resolve_layout(width, R, backend, table)


@pytest.mark.parametrize("width,R,backend", [
    (2, 8, "cuda_sm90"), (8, 256, "cuda_sm100"), (8, 256, "sm90"),
    (8, 256, "interpret")])
def test_a_miss_resolves_to_genome_major(table, width, R, backend):
    assert j_tune.resolve_variant(width, R, backend, table).layout == \
        "genome_major"
    assert tune.resolve_variant(width, R, backend, table) == \
        tune.KernelVariant("genome_major", None, 1)


def test_backend_keys_never_shadow_each_other(table):
    assert tune.backend_key("cpu") == "cpu"
    assert tune.backend_key(torch.device("cpu")) == "cpu"
    seen = {b: tune.resolve_variant(8, 256, b, table)
            for b in ("cuda_sm90", "cuda_sm80", "cpu")}
    assert seen["cuda_sm90"].block_words == 64
    assert seen["cuda_sm80"].block_words == 256
    assert seen["cpu"].block_words == 128
    # a CPU autotune writes its own key and leaves the card's entry alone
    tune.save_entry(8, 256, "cpu", {"layout": "cube_major",
                                    "block_words": 512, "r_tile": 8}, table)
    assert tune.resolve_variant(8, 256, "cuda_sm90", table).block_words == 64
    assert tune.resolve_variant(8, 256, "cpu", table).block_words == 512


@pytest.mark.parametrize("content", ["{not json", "[]", '{"entries": 3}',
                                     ""])
def test_corrupt_table_is_empty(tmp_path, content):
    path = tmp_path / "t.json"
    path.write_text(content)
    assert tune.load_table(str(path)) == {}
    assert tune.resolve_variant(8, 256, "cuda_sm90", str(path)) == \
        tune.KernelVariant()
    # a rewrite is seen: the cache is keyed on the file's stat token
    path.write_text(json.dumps({"version": 1, "entries": ENTRIES}))
    assert tune.resolve_variant(8, 256, "cuda_sm90",
                                str(path)).layout == "cube_major"


def test_missing_table_and_default_path(tmp_path):
    assert tune.load_table(str(tmp_path / "absent.json")) == {}
    assert tune.DEFAULT_TABLE.parent.name == "kernels"
    assert "experiments" not in str(tune.DEFAULT_TABLE)


@pytest.mark.parametrize("n_words,blocks", [
    (2048, [None, 64, 128, 256, 512]), (256, [None, 64, 128, 256]),
    (8, [None, 8]), (1, [None, 1])])
def test_default_variants(n_words, blocks):
    vs = tune.default_variants(n_words)
    genome = [v for v in vs if v.layout == "genome_major"]
    cube = [v for v in vs if v.layout == "cube_major"]
    assert vs[0] == tune.KernelVariant("genome_major", None, 1)
    assert [v.block_words for v in genome] == blocks
    assert {v.r_tile for v in genome} == {1}
    assert [v.block_words for v in cube[::len(tune.R_TILE_CANDIDATES)]] \
        == blocks
    assert {v.r_tile for v in cube} == set(tune.R_TILE_CANDIDATES)
    assert len(vs) == len(blocks) * (1 + len(tune.R_TILE_CANDIDATES))
    assert len({v.key() for v in vs}) == len(vs)


@pytest.mark.parametrize("width,n_n", [(8, 400), (10, 600), (2, 400)])
def test_every_candidate_run_fits_shared_memory(width, n_n):
    n_i = n_o = 2 * width
    W = max(1, (1 << n_i) // 32)
    for v in tune.default_variants(W):
        tiles = cgp_sim.run_tiles(v.layout, v.block_words, 256, W, n_i, n_n,
                                  n_o, 132)
        if v.layout == "cube_major":
            assert cgp_sim.smem_bytes(n_i, n_n, n_o, tiles) <= \
                cgp_sim.MAX_SMEM_BYTES


def test_run_tiles():
    # the defaults follow the sizing rule: genome-major takes
    # tiles_per_block's run at its block's occupancy, cube-major
    # cube_defaults' run (every variant gives the same bits)
    per_sm = cgp_sim.blocks_by_smem(cgp_sim.smem_bytes(16, 400, 16))
    warps = cgp_sim.block_warps(16, 400, 16)
    for R_ in (1, 7, 256):
        assert cgp_sim.run_tiles("genome_major", None, R_, 2048, 16, 400, 16,
                                 132) == cgp_sim.tiles_per_block(
                                     R_, 2048, 132, per_sm, warps)
        assert cgp_sim.run_tiles("cube_major", None, R_, 2048, 16, 400, 16,
                                 132) == cgp_sim.cube_defaults(
                                     R_, 2048, 16, 400, 16, 132)[0]
    assert cgp_sim.run_tiles("cube_major", 512, 256, 2048, 16, 400, 16,
                             132) == 16
    assert cgp_sim.run_tiles("cube_major", 64, 256, 1, 4, 400, 4, 132) == 1
    # width 10: the default cube-major run fits beside a wire plane, and
    # is never raised
    for R_ in (7, 256):
        run = cgp_sim.run_tiles("cube_major", None, R_, 32768, 20, 600, 20,
                                132)
        assert cgp_sim.smem_bytes(20, 600, 20, run) <= \
            cgp_sim.MAX_SMEM_BYTES
        assert cgp_sim.block_warps(20, 600, 20, run) >= 1
    for bad in (0, 48, -32):
        with pytest.raises(ValueError, match="block_words"):
            cgp_sim.run_tiles("cube_major", bad, 8, 2048, 16, 400, 16, 132)
    with pytest.raises(ValueError, match="shared memory"):
        cgp_sim.run_tiles("cube_major", 2048, 8, 2048, 16, 400, 16, 132)
    with pytest.raises(ValueError, match="layout"):
        cgp_sim.run_tiles("auto", None, 8, 2048, 16, 400, 16, 132)


def test_ops_resolves_the_variant(table, monkeypatch):
    monkeypatch.setattr(tune, "DEFAULT_TABLE", table)
    # "auto" adopts the whole winner of this device's backend (cpu here)
    assert ops.resolve_variant("auto", 8, 256, "cpu") == \
        tune.KernelVariant("genome_major", 128, 1)
    # an explicit knob overrides that knob only
    assert ops.resolve_variant("auto", 8, 256, "cpu", r_tile=4) == \
        tune.KernelVariant("genome_major", 128, 4)
    assert ops.resolve_variant("auto", 8, 256, "cpu", block_words=64) == \
        tune.KernelVariant("genome_major", 64, 1)
    # a miss: genome-major; an explicit layout: its defaults
    assert ops.resolve_variant("auto", 2, 8, "cpu") == tune.KernelVariant()
    assert ops.resolve_variant("cube_major", 8, 256, "cpu") == \
        tune.KernelVariant("cube_major", None, cgp_sim.DEFAULT_R_TILE)
    assert ops.resolve_variant("genome_major", 8, 256, "cpu") == \
        tune.KernelVariant()
    with pytest.raises(ValueError, match="layout"):
        ops.resolve_variant("transposed", 8, 256, "cpu")


@pytest.mark.parametrize("seed,spec", [
    (0, (16, 16, 400)), (3, (4, 4, 30)), (7, (20, 20, 600)),
    (2 ** 31 - 1, (6, 6, 50))])
def test_random_genome_matches_jax(seed, spec):
    n_i, n_o, n_n = spec
    want = j_random_genome(jax.random.PRNGKey(seed), JSpec(n_i, n_o, n_n))
    got = random_genome(R.PRNGKey(seed), CGPSpec(n_i, n_o, n_n))
    assert got.nodes.dtype == torch.int32 and got.outs.dtype == torch.int32
    assert np.array_equal(got.nodes.numpy(), np.asarray(want.nodes))
    assert np.array_equal(got.outs.numpy(), np.asarray(want.outs))
    # batched keys: the reference's vmap over a split
    keys = jax.random.split(jax.random.PRNGKey(seed), 5)
    want = jax.vmap(lambda k: j_random_genome(k, JSpec(n_i, n_o, n_n)))(keys)
    got = random_genome(R.split(R.PRNGKey(seed), 5), CGPSpec(n_i, n_o, n_n))
    assert np.array_equal(got.nodes.numpy(), np.asarray(want.nodes))
    assert np.array_equal(got.outs.numpy(), np.asarray(want.outs))


def test_autotune_writes_and_resolves_its_winner(tmp_path):
    path = str(tmp_path / "t.json")
    variants = tune.default_variants(8)
    times = {v.key(): 1.0 + i for i, v in enumerate(variants)}
    best = variants[5]
    times[best.key()] = 0.5
    calls = []

    def stub(fn, reps):      # times by key; never launches the kernel
        key = next(k for k in times if k not in calls)
        calls.append(key)
        return times[key]

    entry = tune.autotune(4, 24, n_n=30, reps=2, device="cpu", path=path,
                          time_fn=stub)
    assert calls == [v.key() for v in variants]
    assert (entry["layout"], entry["block_words"], entry["r_tile"]) == (
        best.layout, best.block_words, best.r_tile)
    assert entry["backend"] == "cpu" and entry["device_name"] == "cpu"
    assert entry["seconds"] == times
    assert tune.resolve_variant(4, 24, "cpu", path) == best
    assert tune.resolve_variant(4, 30, "cpu", path) == best   # nearest R
    saved = json.loads(open(path).read())
    assert set(saved["entries"]) == {"w4_r24_cpu"}
