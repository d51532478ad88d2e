"""Candidate evaluation: the port on the CPU against the JAX package.

Same genomes (numpy-seeded random ones, golden ones with a few mutated
genes, and the golden circuit) go through both packages: wire planes, unpacked output
values, every MetricPartials field and the per-gate popcounts, then the
finalized metric vector and power.

Tolerances: integer fields, abs_sum/sgn_sum (the exact-sum regimes) and the
MAE/WCE/ER/AVG/ACC0/GAUSS values are bit-identical; the float rows
(rel_sum, sq_sum, rel_sq), MRE and power are float32 sums taken in another
order (float64, rounded once, against XLA's float32 reduction): rtol 1e-6.

The JAX Pallas kernel does not trace under the installed JAX, so the
reference is its jnp path: the steps of ``repro.core.evolve._eval_jnp``
(which ``repro.kernels.ref.cgp_eval_ref`` shares), from one simulation.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import golden as JG
from repro.core import metrics as JM
from repro.core import simulate as JS
from repro.core.genome import Genome as JGenome
from repro.core.power import circuit_cost_from_probs
from repro_torch import convert
from repro_torch.core import metrics as M
from repro_torch.core import simulate
from repro_torch.core.evolve import eval_population
from repro_torch.core.genome import CGPSpec, Genome
from repro_torch.kernels import cgp_sim, ops

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

FLOAT_FIELDS = ("rel_sum", "sq_sum", "rel_sq")
RTOL = 1e-6
EXACT_METRICS = [M.MAE, M.WCE, M.ER, M.AVG, M.ACC0, M.GAUSS]

# (width, kind, σ): widths 1-8 of both kinds at σ=256, a non-integer σ at
# three of them, widths ≤ 2 (cube tiled to 32 lanes) included, and width 9
# (per-bit exact-sum regime)
CASES = ([(w, k, 256.0) for w in range(1, 9) for k in ("mul", "add")]
         + [(2, "add", 3.7), (4, "mul", 3.7), (8, "mul", 3.7),
            (9, "add", 256.0)])


def _problem(width, kind, n_genomes=6, seed=0):
    """Golden circuit, then alternately numpy-seeded random legal genomes
    and golden ones with a few mutated genes (small errors, so every
    histogram bin occurs)."""
    build = JG.array_multiplier if kind == "mul" else JG.ripple_carry_adder
    jg, jspec = build(width)
    rng = np.random.default_rng([seed, width])
    hi = jspec.n_i + np.arange(jspec.n_n)
    shape = (n_genomes, jspec.n_n)
    nodes = np.stack([rng.integers(0, hi, shape), rng.integers(0, hi, shape),
                      rng.integers(0, 8, shape)], axis=-1).astype(np.int32)
    outs = rng.integers(0, jspec.n_wires, (n_genomes, jspec.n_o),
                        dtype=np.int32)
    g_nodes, g_outs = np.asarray(jg.nodes), np.asarray(jg.outs)
    near = np.arange(n_genomes) % 2 == 1
    mut = rng.random(nodes.shape) < 0.03
    nodes[near] = np.where(mut[near], nodes[near], g_nodes)
    outs[near] = g_outs
    nodes[0], outs[0] = g_nodes, g_outs
    planes = JS.input_planes_np(jspec.n_i)
    gvals = JG.golden_values(width, kind)
    return jspec, nodes, outs, planes, gvals


def _jax_reference(jspec, nodes, outs, planes, gvals, sigma):
    """The JAX jnp path (``_eval_jnp``'s steps, which ``cgp_eval_ref``
    shares) for each genome, from one simulation: wires, values, partials,
    popcounts, metric vector and power."""
    def one(n, o):
        g = JGenome(n, o)
        wires = JS.simulate_planes(g, jspec, jnp.asarray(planes))
        vals = JS.unpack_values(wires[g.outs])
        partials = JM.error_partials(jnp.asarray(gvals), vals, sigma,
                                     n_bits=jspec.n_o)
        pops = jax.lax.population_count(
            wires[jspec.n_i:].view(jnp.uint32)).astype(jnp.float32).sum(-1)
        met = JM.finalize_metrics(partials, jspec.n_o, sigma)
        power = circuit_cost_from_probs(
            g, jspec, pops / partials.count.astype(jnp.float32),
            with_delay=False).power
        return wires, vals, partials, pops, met, power

    out = jax.jit(jax.vmap(one))(jnp.asarray(nodes), jnp.asarray(outs))
    return jax.tree.map(np.asarray, out)


def _assert_partials(got: M.MetricPartials, want, tag=""):
    for name in M.MetricPartials._fields:
        a = getattr(got, name).numpy()
        b = np.asarray(getattr(want, name))
        assert a.shape == b.shape, (tag, name)
        if name in FLOAT_FIELDS:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=0,
                                       err_msg=f"{tag} {name}")
        else:
            assert a.dtype == b.dtype, (tag, name, a.dtype, b.dtype)
            assert np.array_equal(a, b), (tag, name, a, b)


def _raw_sums(gvals, vals, pops, sigma, n_o) -> cgp_sim.RawSums:
    """The kernel's raw outputs for output values ``vals`` (R, S), computed
    in numpy as ``csrc/cgp_sim.cu`` defines them: exact magnitude totals or
    per-bit counts, integer counts, float32 elements summed in float64."""
    d = gvals.astype(np.int64) - vals
    mags = np.stack([np.abs(d), np.maximum(d, 0), np.maximum(-d, 0)], axis=1)
    if M.exact_sum_per_bit(gvals.size, n_o):
        mag = np.stack([((mags >> b) & 1).sum(-1) for b in range(n_o)], -1)
    else:
        mag = mags.sum(-1, keepdims=True)
    nz = d != 0
    edges = M.gauss_bin_edges(sigma).astype(np.float32)
    bins = np.searchsorted(edges, d.astype(np.float32).ravel(), side="right")
    hist = np.stack([np.bincount(b[z], minlength=M.N_BINS) for b, z in
                     zip(bins.reshape(d.shape), nz)])
    ints = np.concatenate([nz.sum(-1)[:, None],
                           ((gvals == 0) & (vals != 0)).sum(-1)[:, None],
                           hist], axis=1)
    adf = np.abs(d).astype(np.float32)
    relf = adf / np.maximum(gvals, 1).astype(np.float32)
    fsums = np.stack([relf, adf * adf, relf * relf], 1).astype(np.float64)
    return cgp_sim.RawSums(
        torch.from_numpy(mag), torch.from_numpy(ints.astype(np.int32)),
        torch.from_numpy(np.abs(d).max(-1).astype(np.int32)),
        torch.from_numpy(pops.astype(np.int32)),
        torch.from_numpy(fsums.sum(-1)))


@pytest.mark.parametrize("width,kind,sigma", CASES)
def test_eval_matches_jax(width, kind, sigma):
    jspec, nodes, outs, planes, gvals = _problem(width, kind)
    j_wires, j_vals, j_part, j_pops, j_met, j_pow = _jax_reference(
        jspec, nodes, outs, planes, gvals, sigma)
    spec = CGPSpec(n_i=jspec.n_i, n_o=jspec.n_o, n_n=jspec.n_n)
    g = convert.genome(JGenome(nodes, outs))
    tplanes, tgvals = torch.from_numpy(planes), torch.from_numpy(gvals)

    wires = simulate.simulate_planes(g, spec, tplanes)
    assert wires.dtype == torch.int32
    assert np.array_equal(wires.numpy(), j_wires)
    vals = simulate.unpack_values(simulate.output_planes(g, wires))
    assert np.array_equal(vals.numpy(), j_vals)

    # the CPU path (plain version) and the decode of the kernel's raw sums
    part, pops = ops.cgp_eval_batched(g, spec, tplanes, tgvals, sigma)
    _assert_partials(part, j_part, "ops")
    assert np.array_equal(pops.numpy(), j_pops)
    raw = _raw_sums(gvals, j_vals, j_pops, sigma, spec.n_o)
    _assert_partials(ops._partials_from_raw(raw, planes.shape[1], spec.n_o),
                     j_part, "decode")

    res = eval_population(g, spec, tplanes, tgvals, sigma)
    met = res.metric_vec.numpy()
    assert np.array_equal(met[:, EXACT_METRICS], j_met[:, EXACT_METRICS])
    np.testing.assert_allclose(met[:, M.MRE], j_met[:, M.MRE], rtol=RTOL)
    np.testing.assert_allclose(res.cost.power.numpy(), j_pow, rtol=RTOL)
    # the golden circuit is exact
    assert int(part.err_count[0]) == 0 and int(part.wce_max[0]) == 0


def test_width9_takes_per_bit_regime():
    assert M.exact_sum_per_bit(1 << 18, 10)   # 9-bit adder, n_o = 10
    assert not M.exact_sum_per_bit(1 << 16, 16)  # 8x8 multiplier


def test_popcount32_counts_every_bit():
    """The plain popcount wraps in int32: words with the sign bit set, the
    extremes and seeded random words against numpy's bit count."""
    edge = [0, 1, -1, -2**31, 2**31 - 1, 0x55555555, -0x55555556,
            0x0F0F0F0F, -0x0F0F0F10]
    words = np.concatenate([np.array(edge, np.int32), np.random.default_rng(
        0).integers(-2**31, 2**31, 4096, dtype=np.int64).astype(np.int32)])
    want = np.unpackbits(words.view(np.uint8)).reshape(-1, 32).sum(1)
    got = simulate.popcount32(torch.from_numpy(words))
    np.testing.assert_array_equal(got.numpy(), want)


def test_single_genome_eval_drops_axis():
    jspec, nodes, outs, planes, gvals = _problem(3, "mul", n_genomes=2)
    spec = CGPSpec(n_i=jspec.n_i, n_o=jspec.n_o, n_n=jspec.n_n)
    g = convert.genome(JGenome(nodes, outs))
    tplanes, tgvals = torch.from_numpy(planes), torch.from_numpy(gvals)
    both, pops = ops.cgp_eval_batched(g, spec, tplanes, tgvals)
    one, pop1 = ops.cgp_eval(Genome(g.nodes[1], g.outs[1]), spec, tplanes,
                             tgvals)
    for name in M.MetricPartials._fields:
        assert torch.equal(getattr(one, name), getattr(both, name)[1]), name
    assert torch.equal(pop1, pops[1])


def test_metrics_np_oracle_agrees():
    jspec, nodes, outs, planes, gvals = _problem(4, "add")
    spec = CGPSpec(n_i=jspec.n_i, n_o=jspec.n_o, n_n=jspec.n_n)
    g = convert.genome(JGenome(nodes, outs))
    tplanes, tgvals = torch.from_numpy(planes), torch.from_numpy(gvals)
    cand = simulate.unpack_values(simulate.output_planes(
        g, simulate.simulate_planes(g, spec, tplanes)))
    met = M.finalize_metrics(M.error_partials(tgvals, cand, 256.0, spec.n_o),
                             spec.n_o, 256.0).numpy()
    for r in range(len(nodes)):
        np.testing.assert_allclose(
            met[r], M.metrics_np(gvals, cand[r].numpy(), spec.n_o),
            rtol=1e-5, atol=1e-6)


def test_wrapper_validates_inputs():
    jspec, nodes, outs, planes, gvals = _problem(2, "mul", n_genomes=2)
    kw = dict(n_i=jspec.n_i, n_n=jspec.n_n, n_o=jspec.n_o)
    n, o = torch.from_numpy(nodes), torch.from_numpy(outs)
    p, gv = torch.from_numpy(planes), torch.from_numpy(gvals)
    with pytest.raises(TypeError):
        cgp_sim.cgp_sim_metrics_batched(n.long(), o, p, gv, **kw)
    with pytest.raises(ValueError):
        cgp_sim.cgp_sim_metrics_batched(n[:, :-1], o, p, gv, **kw)
    with pytest.raises(ValueError):
        cgp_sim.cgp_sim_metrics_batched(n, o, p, gv[:-1], **kw)
    with pytest.raises(ValueError):
        cgp_sim.cgp_sim_metrics_batched(n.transpose(0, 1).contiguous()
                                        .transpose(0, 1), o, p, gv, **kw)
    with pytest.raises(ValueError):
        cgp_sim.cgp_sim_metrics_batched(n.to("meta"), o.to("meta"),
                                        p.to("meta"), gv.to("meta"), **kw)
    # the launch wrapper has no CPU path: CPU tensors go through ops to ref
    with pytest.raises(ValueError, match="no cgp_sim kernel"):
        cgp_sim.cgp_sim_metrics_batched(n, o, p, gv, **kw)


@pytest.mark.parametrize("R,W,sms", [(256, 2048, 132), (1, 2048, 132),
                                     (7, 8, 132), (1, 1, 132)])
def test_tiles_per_block_covers_the_cube(R, W, sms):
    tpb = cgp_sim.tiles_per_block(R, W, sms)
    n_tiles = -(-W // cgp_sim.TILE)
    assert 1 <= tpb <= n_tiles
    assert -(-n_tiles // tpb) * tpb >= n_tiles
