"""CGP genome representation (paper Sec. III-A).

A candidate circuit with ``n_i`` primary inputs, ``n_o`` primary outputs and
``n_n`` two-input nodes is encoded as in the paper: each node is
``(in0, in1, func)`` where the fan-in indices address either a primary input
(``< n_i``) or an *earlier* node (``n_i + k`` for node ``k``), i.e. full
levels-back, which forbids feedback by construction.  The genome is two
int32 tensors, with any leading batch dims written out:

    nodes : (..., n_n, 3) int32
    outs  : (..., n_o)    int32
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import random as R
from repro_torch.core import gates


class Genome(NamedTuple):
    """A CGP genome; both tensors may carry the same leading batch dims."""
    nodes: torch.Tensor  # (..., n_n, 3) int32 — (in0, in1, func)
    outs: torch.Tensor   # (..., n_o)     int32


@dataclasses.dataclass(frozen=True)
class CGPSpec:
    """Static CGP problem shape."""
    n_i: int          # primary inputs
    n_o: int          # primary outputs
    n_n: int = 400    # nodes (paper: 400)
    n_funcs: int = gates.N_FUNCS

    @property
    def n_wires(self) -> int:
        return self.n_i + self.n_n

    @property
    def n_genes(self) -> int:
        return self.n_n * 3 + self.n_o

    @property
    def n_inputs_total(self) -> int:
        """Number of exhaustive input combinations 2^n_i."""
        return 1 << self.n_i

    @property
    def n_words(self) -> int:
        """Packed 32-bit words needed to cover the input cube."""
        return max(1, self.n_inputs_total // 32)


def max_fanin_index(spec: CGPSpec) -> np.ndarray:
    """Exclusive upper bound of a legal fan-in index for each node position."""
    return spec.n_i + np.arange(spec.n_n, dtype=np.int32)


def random_genome(key: torch.Tensor, spec: CGPSpec) -> Genome:
    """Uniform random legal (feed-forward) genome: JAX's draw for the same
    key, bit for bit.  ``key`` (..., 2) may carry batch dims; the genome
    then carries them too (the reference's ``vmap`` over keys)."""
    keys = R.split(key, 4)
    hi = torch.as_tensor(max_fanin_index(spec), device=key.device)
    in0, in1 = (R.randint(keys[..., i, :], (spec.n_n,), 0, hi)
                for i in (0, 1))
    func = R.randint(keys[..., 2, :], (spec.n_n,), 0, spec.n_funcs)
    outs = R.randint(keys[..., 3, :], (spec.n_o,), 0, spec.n_wires)
    return Genome(torch.stack([in0, in1, func], dim=-1), outs)


def validate_genome(genome: Genome, spec: CGPSpec) -> bool:
    """Host-side legality check of one genome (feed-forward, in range)."""
    nodes = genome.nodes.cpu().numpy()
    outs = genome.outs.cpu().numpy()
    if nodes.shape != (spec.n_n, 3) or outs.shape != (spec.n_o,):
        return False
    hi = max_fanin_index(spec)
    ok = (nodes[:, 0] >= 0).all() and (nodes[:, 1] >= 0).all()
    ok &= (nodes[:, 0] < hi).all() and (nodes[:, 1] < hi).all()
    ok &= (0 <= nodes[:, 2]).all() and (nodes[:, 2] < spec.n_funcs).all()
    ok &= (outs >= 0).all() and (outs < spec.n_wires).all()
    return bool(ok)


def _flat(genome: Genome, spec: CGPSpec):
    batch = genome.nodes.shape[:-2]
    nodes = genome.nodes.reshape(-1, spec.n_n, 3).long()
    outs = genome.outs.reshape(-1, spec.n_o).long()
    return batch, nodes, outs


def active_mask(genome: Genome, spec: CGPSpec) -> torch.Tensor:
    """Boolean (..., n_wires) mask of wires reachable from the outputs.

    Fan-ins always point backwards, so one reverse sweep over the nodes
    suffices.  Each step ORs the node's activity into its fan-ins with one
    ``scatter_reduce`` (max over uint8) for the whole batch.
    """
    batch, nodes, outs = _flat(genome, spec)
    B, dev = nodes.shape[0], nodes.device
    act = torch.zeros((B, spec.n_wires), dtype=torch.uint8, device=dev)
    act.scatter_(1, outs, 1)
    one_input = torch.as_tensor(gates.ONE_INPUT, device=dev)
    uses = torch.stack([torch.ones_like(nodes[..., 2]),
                        1 - one_input[nodes[..., 2]]], dim=-1).to(torch.uint8)
    fanin = nodes[..., :2]
    for k in range(spec.n_n - 1, -1, -1):
        src = act[:, spec.n_i + k, None] * uses[:, k]
        act.scatter_reduce_(1, fanin[:, k], src, reduce="amax")
    return act.bool().reshape(*batch, spec.n_wires)


def critical_path_ps(genome: Genome, spec: CGPSpec) -> torch.Tensor:
    """Longest-path delay (ps) over *active* wires using per-gate delays."""
    batch, nodes, outs = _flat(genome, spec)
    B, dev = nodes.shape[0], nodes.device
    act = active_mask(genome, spec).reshape(B, spec.n_wires)
    delay_tab = torch.as_tensor(gates.DELAY_PS, device=dev)
    one_input = torch.as_tensor(gates.ONE_INPUT, device=dev).bool()
    depth = torch.zeros((B, spec.n_wires), dtype=torch.float32, device=dev)
    for k in range(spec.n_n):
        fanin = nodes[:, k, :2]
        d_in = torch.gather(depth, 1, fanin)
        func = nodes[:, k, 2]
        d_in1 = torch.where(one_input[func], 0.0, d_in[:, 1])
        d = torch.maximum(d_in[:, 0], d_in1) + delay_tab[func]
        depth[:, spec.n_i + k] = torch.where(act[:, spec.n_i + k], d, 0.0)
    return torch.gather(depth, 1, outs).amax(dim=1).reshape(batch)


# --------------------------------------------------------------------------
# Canonical phenotype form (the dedup cache's key, ``core.evalcache``)
# --------------------------------------------------------------------------
#
# CGP genotypes are highly redundant: most genes are inactive, so many
# genotypes encode the same circuit.  The canonical form of the active
# subgraph is the cache key of an evaluation:
#
#   * active nodes are compacted to the front of the node array in their
#     original (topological) order and every fan-in / output gene is
#     renumbered accordingly;
#   * the unused second fan-in of a one-input gate is zeroed;
#   * inactive genes are dropped (the tail of the canonical array is zero
#     and left out of the digest).
#
# Two genotypes share a canonical form iff their active subgraphs are gate
# for gate identical (commutative input swaps are not folded).  The digest
# is a 16-byte BLAKE2b over the canonical genes, byte for byte the JAX
# package's.  Host numpy by design: the dedup loop decides on the host.

PHENOTYPE_DIGEST_SIZE = 16  # bytes of BLAKE2b digest per phenotype


def active_mask_np(nodes: np.ndarray, outs: np.ndarray,
                   spec: CGPSpec) -> np.ndarray:
    """(R, n_wires) bool active mask of a stacked population on the host:
    one reverse sweep, vectorized over the population."""
    nodes = np.asarray(nodes)
    outs = np.asarray(outs)
    R = nodes.shape[0]
    n_i = spec.n_i
    act = np.zeros((R, spec.n_wires), dtype=bool)
    act[np.arange(R)[:, None], outs] = True
    rows = np.arange(R)
    for k in range(spec.n_n - 1, -1, -1):
        is_act = act[:, n_i + k]
        uses_b = is_act & (gates.ONE_INPUT[nodes[:, k, 2]] == 0)
        act[rows, nodes[:, k, 0]] |= is_act
        act[rows, nodes[:, k, 1]] |= uses_b
    return act


def canonicalize_phenotypes_np(nodes: np.ndarray, outs: np.ndarray,
                               spec: CGPSpec
                               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Canonical active-subgraph form of a stacked population.

    Args:
      nodes: (R, n_n, 3) int32; outs: (R, n_o) int32 (host arrays).

    Returns:
      (canon_nodes (R, n_n, 3), canon_outs (R, n_o), n_active (R,)): per
      genome, the first ``n_active[r]`` rows of ``canon_nodes[r]`` hold the
      active subgraph in topological order with renumbered fan-ins and
      zeroed unary second fan-ins; the tail rows are zero.
    """
    nodes = np.asarray(nodes)
    outs = np.asarray(outs)
    R = nodes.shape[0]
    n_i, n_n = spec.n_i, spec.n_n
    node_act = active_mask_np(nodes, outs, spec)[:, n_i:]      # (R, n_n)
    new_idx = np.cumsum(node_act, axis=1, dtype=np.int32) - 1
    n_active = node_act.sum(axis=1).astype(np.int32)

    def remap(w):  # wire index -> canonical wire index, rows aligned
        k = np.clip(w - n_i, 0, n_n - 1)
        return np.where(w >= n_i,
                        n_i + np.take_along_axis(new_idx, k, axis=1), w)

    func = nodes[:, :, 2]
    unary = gates.ONE_INPUT[func] == 1
    m0 = remap(nodes[:, :, 0])
    m1 = remap(np.where(unary, 0, nodes[:, :, 1]))
    canon = np.zeros((R, n_n, 3), np.int32)
    r_idx, k_idx = np.nonzero(node_act)
    pos = new_idx[r_idx, k_idx]
    canon[r_idx, pos, 0] = m0[r_idx, k_idx]
    canon[r_idx, pos, 1] = m1[r_idx, k_idx]
    canon[r_idx, pos, 2] = func[r_idx, k_idx]
    return canon, remap(outs).astype(np.int32), n_active


def phenotype_digests(nodes: np.ndarray, outs: np.ndarray,
                      spec: CGPSpec) -> list[bytes]:
    """Per-genome phenotype digests of a stacked population: equal for
    genotypes with the same active subgraph."""
    canon, canon_outs, n_active = canonicalize_phenotypes_np(nodes, outs,
                                                             spec)
    digests = []
    for r in range(canon.shape[0]):
        na = int(n_active[r])
        h = hashlib.blake2b(digest_size=PHENOTYPE_DIGEST_SIZE)
        h.update(na.to_bytes(4, "little"))
        h.update(canon[r, :na].tobytes())
        h.update(canon_outs[r].tobytes())
        digests.append(h.digest())
    return digests


def phenotype_digest(genome: Genome, spec: CGPSpec) -> bytes:
    """One genome's phenotype digest (its tensors on any device)."""
    return phenotype_digests(torch.as_tensor(genome.nodes).cpu()[None],
                             torch.as_tensor(genome.outs).cpu()[None],
                             spec)[0]
