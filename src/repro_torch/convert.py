"""Carry the reference package's state across to the port.

The system's "weights" are its genomes and evolution state.  These helpers
take arrays from the JAX package (anything ``numpy.asarray`` reads: genome
arrays, a stacked ``EvolveState`` with its PRNG keys, threshold matrices)
and return the port's tensors on a given device, so both packages can be
started from the same state.  Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.evolve import EvolveState
from repro_torch.core.genome import Genome


def tensor(x, dtype: torch.dtype, device: torch.device | str = "cpu"
           ) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def genome(g, device: torch.device | str = "cpu") -> Genome:
    """A genome (``.nodes``, ``.outs``; any leading dims) as int32 tensors."""
    return Genome(tensor(g.nodes, torch.int32, device),
                  tensor(g.outs, torch.int32, device))


def keys(k, device: torch.device | str = "cpu") -> torch.Tensor:
    """uint32 PRNG key words (..., 2) as the port's int64 key tensor."""
    return torch.as_tensor(np.array(k, dtype=np.uint32).astype(np.int64),
                           device=device)


def thresholds(t, device: torch.device | str = "cpu") -> torch.Tensor:
    return tensor(t, torch.float32, device)


def evolve_state(s, device: torch.device | str = "cpu") -> EvolveState:
    """An evolution state with the reference's ``EvolveState`` fields."""
    f32 = lambda x: tensor(x, torch.float32, device)
    return EvolveState(parent=genome(s.parent, device),
                       parent_fit=f32(s.parent_fit),
                       parent_metrics=f32(s.parent_metrics),
                       parent_power=f32(s.parent_power),
                       best=genome(s.best, device),
                       best_fit=f32(s.best_fit),
                       key=keys(s.key, device))
