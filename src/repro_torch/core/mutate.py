"""CGP point mutation (paper Sec. III).

Standard per-gene point mutation: every gene independently mutates with
probability ``rate``.  Fan-in genes resample uniformly from the node's legal
feed-forward range, function genes from Γ, output genes from all wires — so
every offspring is legal by construction.  The draws are the reference's
``jax.random`` calls, split in the same order, so the same key gives the
same offspring.
"""
from __future__ import annotations

import torch

from repro_torch import random as R
from repro_torch.core.genome import CGPSpec, Genome, max_fanin_index


def mutate(key: torch.Tensor, genome: Genome, spec: CGPSpec,
           rate: float = 0.05) -> Genome:
    """One offspring per key: ``key`` (..., 2) broadcasts against the
    genome's leading dims."""
    ks = R.split(key, 6)
    k_sel_n, k_sel_o, k_out = ks[..., 0, :], ks[..., 1, :], ks[..., 5, :]
    # the in0 / in1 / func draws use keys 2..4: one call draws all three
    hi = torch.as_tensor(max_fanin_index(spec), device=key.device)
    bounds = torch.stack([hi, hi, torch.full_like(hi, spec.n_funcs)])
    new_nodes = R.randint(ks[..., 2:5, :], (spec.n_n,), 0, bounds)
    mut_n = R.bernoulli(k_sel_n, rate, (spec.n_n, 3))
    nodes = torch.where(mut_n, new_nodes.transpose(-1, -2), genome.nodes)

    new_outs = R.randint(k_out, (spec.n_o,), 0, spec.n_wires)
    mut_o = R.bernoulli(k_sel_o, rate, (spec.n_o,))
    outs = torch.where(mut_o, new_outs, genome.outs)
    return Genome(nodes, outs)


def mutate_population(key: torch.Tensor, parent: Genome, spec: CGPSpec,
                      lam: int, rate: float = 0.05) -> Genome:
    """λ offspring of each parent: key (..., 2), parent (..., n_n, 3) ->
    offspring (..., lam, n_n, 3)."""
    keys = R.split(key, lam)
    return mutate(keys, Genome(parent.nodes.unsqueeze(-3),
                               parent.outs.unsqueeze(-2)), spec, rate)
