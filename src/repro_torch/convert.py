"""Carry the reference package's state across to the port.

The system's "weights" are its genomes and evolution state, and the
served LM's parameters.  These helpers take arrays from the JAX package
(anything ``numpy.asarray`` reads: genome arrays, a stacked ``EvolveState``
with its PRNG keys, threshold matrices, a model parameter tree) and return
the port's tensors on a given device, so both packages can be started from
the same state.  Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.evolve import EvolveState
from repro_torch.core.genome import Genome
from repro_torch.models.model import Transformer, skeleton


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


def model_params(tree, cfg: ModelConfig, device: torch.device | str = "cpu"
                 ) -> Transformer:
    """The reference's parameter tree as the port's ``Transformer``.

    ``tree`` is ``repro.models.model.init_params``'s output: ``embed.tokens``,
    ``final_norm`` and ``layers.layer{j}``
    with every leaf stacked over ``n_periods``; layer ``i`` of the port is
    period ``i // len(period)``, slot ``i % len(period)``.  Values go
    through float32, so bfloat16 weights arrive unchanged."""
    params = skeleton(cfg, device)
    state = {"embed.tokens": tree["embed"]["tokens"],
             "final_norm": tree["final_norm"]}
    period = len(cfg.period)
    for i in range(cfg.n_layers):
        lt = tree["layers"][f"layer{i % period}"]
        for part in ("mixer", "ffn"):
            for name, leaf in lt[part].items():
                state[f"layers.{i}.{part}.{name}"] = leaf[i // period]
    own = params.state_dict()
    if set(state) != set(own):
        raise ValueError(f"parameter names differ: reference-only "
                         f"{sorted(set(state) - set(own))}, port-only "
                         f"{sorted(set(own) - set(state))}")
    params.load_state_dict({k: tensor(np.asarray(v, np.float32),
                                      own[k].dtype, device)
                            for k, v in state.items()})
    return params
