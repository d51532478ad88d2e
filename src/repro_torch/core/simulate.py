"""Bit-packed exhaustive circuit simulation (paper Sec. IV).

The input cube is packed into int32 words: wire ``w``'s value over the
whole cube is a bit-plane of ``2^n_i`` bits stored as ``(n_words,)`` int32.
Simulation walks the node array once, doing W-wide branch-free truth-table
merges.  This module is the plain PyTorch path; ``kernels/cgp_sim.py`` is the
fused CUDA kernel with the same semantics.

Every function takes the *word slice* to simulate and batch dims written
out: genomes carry leading dims ``(...)`` and the result keeps them.  Planes
stay int32; bit tests shift first and mask after, so the sign bit never
matters (torch has no uint32 shifts on the CPU).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import gates
from repro_torch.core.genome import CGPSpec, Genome


@functools.lru_cache(maxsize=32)
def input_planes_np(n_i: int) -> np.ndarray:
    """(n_i, n_words) int32 bit-planes of the exhaustive input cube.

    Bit ``l`` of word ``w`` in plane ``i`` is bit ``i`` of the input index
    ``x = 32*w + l``.  Cubes smaller than one word are tiled to 32 lanes —
    all normalized metrics and signal probabilities are invariant under
    whole-cube replication, so packing stays exact for tiny test circuits.
    """
    n = 1 << n_i
    xs = np.arange(max(n, 32), dtype=np.uint64) % np.uint64(n)
    planes = []
    for i in range(n_i):
        bits = ((xs >> np.uint64(i)) & np.uint64(1)).astype(np.uint32)
        words = bits.reshape(-1, 32)
        packed = (words << np.arange(32, dtype=np.uint32)[None, :]).sum(
            axis=1, dtype=np.uint32)
        planes.append(packed)
    return np.stack(planes).astype(np.int32)  # two's complement reinterpret


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (SWAR, in int64): int64 tensor."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def gate_eval(func: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """Branch-free packed gate evaluation via 4-term truth-table merge;
    ``func`` broadcasts against the words ``a``/``b``."""
    tt = torch.as_tensor(gates.TRUTH_TABLES, device=a.device)[func]
    na, nb = ~a, ~b
    m0, m1, m2, m3 = na & nb, a & nb, na & b, a & b
    s = lambda k: -((tt >> k) & 1)  # 0 or -1 mask
    return (m0 & s(0)) | (m1 & s(1)) | (m2 & s(2)) | (m3 & s(3))


def simulate_planes(genome: Genome, spec: CGPSpec,
                    in_planes: torch.Tensor) -> torch.Tensor:
    """Simulate all wires over a slice of the input cube.

    Args:
      in_planes: (n_i, W) int32 input bit-planes (W words of the cube slice).
    Returns:
      (..., n_wires, W) int32 — every wire's bit-plane (inputs first).
    """
    batch = genome.nodes.shape[:-2]
    nodes = genome.nodes.reshape(-1, spec.n_n, 3).long()
    B, W = nodes.shape[0], in_planes.shape[-1]
    wires = torch.zeros((B, spec.n_wires, W), dtype=torch.int32,
                        device=in_planes.device)
    wires[:, :spec.n_i] = in_planes
    rows = torch.arange(B, device=in_planes.device)
    for k in range(spec.n_n):
        a = wires[rows, nodes[:, k, 0]]
        b = wires[rows, nodes[:, k, 1]]
        wires[:, spec.n_i + k] = gate_eval(nodes[:, k, 2, None], a, b)
    return wires.reshape(*batch, spec.n_wires, W)


def output_planes(genome: Genome, wires: torch.Tensor) -> torch.Tensor:
    """(..., n_o, W) primary-output planes picked out of ``wires``."""
    idx = genome.outs.long()[..., None].expand(*genome.outs.shape,
                                              wires.shape[-1])
    return torch.gather(wires, -2, idx)


def unpack_values(out_planes: torch.Tensor) -> torch.Tensor:
    """Decode packed output planes to per-input integers.

    Args:
      out_planes: (..., n_o, W) int32.
    Returns:
      (..., W*32) int32 — int(f(x)) for every input x in this cube slice.
    """
    n_o, W = out_planes.shape[-2:]
    dev = out_planes.device
    lanes = torch.arange(32, dtype=torch.int32, device=dev)
    bits = (out_planes[..., None] >> lanes) & 1          # (..., n_o, W, 32)
    shift = torch.arange(n_o, dtype=torch.int32, device=dev)[:, None, None]
    vals = (bits << shift).sum(dim=-3, dtype=torch.int32)  # n_o < 31
    return vals.reshape(*out_planes.shape[:-2], W * 32)


def simulate_values(genome: Genome, spec: CGPSpec,
                    in_planes: torch.Tensor | None = None) -> torch.Tensor:
    """int(f_C(x)) over the input cube slice (default: the full cube, on
    the genome's device): (..., W*32) int32."""
    if in_planes is None:
        in_planes = torch.as_tensor(input_planes_np(spec.n_i),
                                    device=genome.nodes.device)
    wires = simulate_planes(genome, spec, in_planes)
    return unpack_values(output_planes(genome, wires))


def signal_probabilities(wires: torch.Tensor,
                         n_bits: int | None = None) -> torch.Tensor:
    """Exact P(wire = 1) under uniform inputs, from popcounts of bit-planes.

    Args:
      wires: (..., n_wires, W) packed planes.
      n_bits: number of valid bits in the planes.  Defaults to W*32, which is
        correct even for sub-word cubes tiled to 32 lanes (replication
        multiplies popcount and bit count alike).
    """
    pop = popcount32(wires).sum(dim=-1).to(torch.float32)
    if n_bits is None:
        n_bits = wires.shape[-1] * 32
    return pop / float(n_bits)
