"""Activity-based power / area / delay model.

Replaces the paper's yosys + FreePDK45 synthesis step with an analytic model
computable on-device from the same exhaustive simulation the error metrics
use:

    P_dyn(C)  = Σ_{g active}  2·p_g·(1-p_g) · E_sw(type(g)) · f_clk
    P_leak(C) = Σ_{g active}  I_leak(type(g))
    power(C)  = P_dyn + P_leak        (f_clk fixed; constants in gates.py)

``p_g`` is the exact signal probability of gate g's output under uniform
inputs, from popcounts of the simulated bit-plane.  Only the ratio
power(C)/power(G) ("relative power") is reported, as in the paper.

Summation order: each per-gate term is computed in float32 as the reference
computes it, and every Σ over gates accumulates in float64 and rounds to
float32 once.  That makes the sum the same on any device and in any
reduction order (up to the rare float64 tie at a float32 rounding
boundary); the reference's float32 reduction agrees to rtol 1e-6.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import gates
from repro_torch.core.genome import CGPSpec, Genome, active_mask, critical_path_ps
from repro_torch.core.metrics import sum_f64

F_CLK_GHZ = 1.0  # fixed clock for the dynamic term; cancels in relative power


class CircuitCost(NamedTuple):
    power: torch.Tensor      # arbitrary units (fJ·GHz + nW)
    area: torch.Tensor       # um^2
    delay: torch.Tensor      # ps (critical path over active gates)
    n_active: torch.Tensor   # active gate count


def circuit_cost_from_probs(genome: Genome, spec: CGPSpec, p: torch.Tensor,
                            with_delay: bool = True) -> CircuitCost:
    """Cost of candidates from their gate signal probabilities.

    Args:
      p: (..., n_n) float32 signal probabilities of the gates.
      with_delay: the sequential critical-path sweep is only needed by the
        final characterization; the Eq. (8) fitness uses power alone.
    """
    dev = p.device
    func = genome.nodes[..., 2].long()
    act = active_mask(genome, spec)[..., spec.n_i:].to(torch.float32)
    e_sw = torch.as_tensor(gates.SWITCH_ENERGY_FJ, device=dev)[func]
    leak = torch.as_tensor(gates.LEAKAGE_NW, device=dev)[func]
    area = torch.as_tensor(gates.AREA_UM2, device=dev)[func]
    activity = 2.0 * p * (1.0 - p)
    p_dyn = sum_f64(act * activity * e_sw) * F_CLK_GHZ
    p_leak = sum_f64(act * leak) * 1e-3  # leakage below dynamic, as at 45nm
    return CircuitCost(
        power=p_dyn + p_leak,
        area=sum_f64(act * area),
        delay=(critical_path_ps(genome, spec) if with_delay
               else torch.zeros_like(p_dyn)),
        n_active=act.sum(dim=-1).to(torch.int32),
    )
