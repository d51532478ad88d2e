"""Work model of one ``cgp_sim`` launch: R genomes simulated over W words
(32·W inputs) of the input cube, their error sums and gate popcounts.

Only the active gates of a genome feed its outputs and its power, so the
work a launch needs is counted over each launched genome's active gates
(``active_counts``), not over every node: a kernel that skips inactive
nodes then reads at most 100%.  Per (active gate, word): the gate as 3
logic operations over its fan-in words and its truth table's lane masks,
its popcount and the popcount's add; its two fan-in loads and its store
in shared memory.  Per (genome, input): unpacking the output bits by a
32 × 32 transpose (12.5 int32 operations an input), the error, its
magnitude and their sums, the error count, ACC0, WCE, the histogram
counter (10); the histogram's 4-compare search, the relative error and
its fix-ups, two squares, three adds (12 float32); one conversion.
Bytes: the genomes, the input planes and golden values read once, the
per-genome sums and popcounts written once.
"""
from __future__ import annotations

import numpy as np

from bench.workmodels.peaks import HBM_BYTES_PER_S, LDS_PER_S, PIPE_OPS_PER_S

OPS_PER_GATE_WORD = {"int32": 4, "popc/cvt": 1}
OPS_PER_INPUT = {"int32": 12.5 + 10, "float32": 12, "popc/cvt": 1}
LDS_PER_GATE_WORD = 3
N_BINS = 10
OUT_BYTES_PER_GENOME = 3 * 8 + 4 * (2 + N_BINS) + 4 + 3 * 8


def active_counts(nodes: np.ndarray, outs: np.ndarray, n_i: int,
                  one_input: np.ndarray) -> np.ndarray:
    """(R,) active gates of genomes (R, n_n, 3) / (R, n_o): those an
    output reaches, by one sweep from the last gate back."""
    R, n_n, _ = nodes.shape
    act = np.zeros((R, n_i + n_n), bool)
    rows = np.arange(R)
    act[rows[:, None], outs] = True
    uses_b = one_input[nodes[:, :, 2]] == 0
    for k in range(n_n - 1, -1, -1):
        on = act[:, n_i + k]
        act[rows, nodes[:, k, 0]] |= on
        act[rows, nodes[:, k, 1]] |= on & uses_b[:, k]
    return act[:, n_i:].sum(1)


def bound_ms(active: int, R: int, n_i: int, n_n: int, n_o: int,
             W: int) -> float:
    """Least ms of a launch of R genomes with ``active`` active gates in
    all over W words: the largest of each pipe's operations at its rate,
    all operations at the issue rate, the shared-memory accesses, and the
    bytes at the HBM rate."""
    gate_words, inputs = active * W, R * 32 * W
    ops = {p: gate_words * OPS_PER_GATE_WORD.get(p, 0)
           + inputs * OPS_PER_INPUT.get(p, 0) for p in PIPE_OPS_PER_S}
    limits = [n / PIPE_OPS_PER_S[p] for p, n in ops.items()]
    limits.append(sum(ops.values()) / PIPE_OPS_PER_S["float32"])
    limits.append(gate_words * LDS_PER_GATE_WORD / LDS_PER_S)
    nbytes = (4 * (R * (3 * n_n + n_o) + n_i * W + 32 * W)
              + R * OUT_BYTES_PER_GENOME)
    limits.append(nbytes / HBM_BYTES_PER_S)
    return max(limits) * 1e3
