"""Production mesh construction over the ranks of a ``torch.distributed``
world (``repro/launch/mesh.py``, the same shapes and axis names).

Every builder is a function and needs an initialized process group; each
raises where the world does not fit its shape, as ``jax.make_mesh`` does
for a device count that does not.  Axis semantics: ``parallel.ctx``.
``device`` is this rank's device (default: its card).
"""
from __future__ import annotations

import torch.distributed as dist

from repro_torch.parallel.ctx import Mesh


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """Single pod ``(16, 16)`` = 256 ranks (data, model); multi-pod
    ``(2, 16, 16)`` = 512 ranks (pod, data, model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, device)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, pods: int = 0,
                    device=None) -> Mesh:
    """Small fixed-shape mesh for tests: ``(n_data, n_model)``, with a
    leading ``pod`` axis of ``pods`` when ``pods >= 1``."""
    if pods:
        return Mesh((pods, n_data, n_model), ("pod", "data", "model"), device)
    return Mesh((n_data, n_model), ("data", "model"), device)


def make_host_mesh(device=None) -> Mesh:
    """Every rank of the world as a ``1 × N`` (data, model) mesh."""
    return Mesh((1, dist.get_world_size()), ("data", "model"), device)


def make_sweep_mesh(pods: int = 1, device=None) -> Mesh:
    """Every rank as a ``(pods, 1, N // pods)`` (pod, data, model) mesh:
    ``pods`` slices of the constraint grid, the rest of the ranks on
    ``model`` for input-cube sharding (``SweepConfig.model_axis="model"``).
    The world size must be divisible by ``pods``."""
    n = dist.get_world_size()
    if pods < 1 or n % pods:
        raise ValueError(f"{n} devices not divisible into {pods} pods")
    return Mesh((pods, 1, n // pods), ("pod", "data", "model"), device)
