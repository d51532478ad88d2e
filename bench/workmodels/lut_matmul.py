"""Work model of one ``lut_matmul`` contraction C[m, n] = Σ_k T[a[m, k],
b[k, n]] of (M, K) × (K, N) uint8 operands through a 256 × 256 uint16
table: per product one int32 add and one 2-byte table entry read from
shared memory; bytes: both operands and the table read once, the int32
output written once."""
from __future__ import annotations

from bench.workmodels.peaks import HBM_BYTES_PER_S, LDS_PER_S, PIPE_OPS_PER_S


def bound_ms(M: int, K: int, N: int) -> float:
    products = M * K * N
    return max(products / PIPE_OPS_PER_S["int32"],
               products * 2 / (4 * LDS_PER_S),
               (M * K + K * N + 2 * 256 * 256 + 4 * M * N)
               / HBM_BYTES_PER_S) * 1e3
