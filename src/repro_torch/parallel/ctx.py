"""Parallel context: the active mesh of ranks.

The reference (``repro/parallel/ctx.py``) lays a ``jax.sharding.Mesh`` of
devices over the production axes (pod, data, model) and runs the
distributed paths under ``shard_map``.  Here every rank is a process of an
initialized ``torch.distributed`` world, and a ``Mesh`` lays those ranks
out over named axes, row-major, as ``jax.make_mesh`` lays out devices.
Each collective of the reference over a mesh axis (``psum``/``pmax``/
``all_gather`` inside ``shard_map``) becomes a ``torch.distributed`` call
on this rank's group along that axis (``Mesh.axis_group``).

The caller initializes the process group and so picks the backend:
``nccl`` with one card per rank, ``gloo`` when ranks share a card or run
on the CPU.  Nothing here switches backend.

Axis semantics follow the reference (``launch.mesh``):
  * ``pod``   — the constraint-grid partition (CGP) / data parallelism (LM);
  * ``data``  — evolution islands (CGP) / batch parallelism (LM);
  * ``model`` — input-cube sharding (CGP: metric partials all-reduced
    across it) / tensor parallelism (LM).

Only the CGP half is here; the LM half (``LOGICAL``, ``resolve_spec``,
``named_sharding``, ``shard``) waits for the multi-device model.
"""
from __future__ import annotations

import contextlib
import math
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

_ACTIVE_MESH: "Mesh | None" = None


def rank_grid(shape: Sequence[int]) -> np.ndarray:
    """The ranks of a mesh of ``shape``, row-major: ``jax.make_mesh``'s
    device order for host devices of the same count."""
    return np.arange(math.prod(shape)).reshape(tuple(shape))


def default_device(rank: int) -> torch.device:
    """This rank's card: one card per rank, wrapping round the cards
    present (ranks that share a card need ``gloo``)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch path")
    return torch.device("cuda", rank % torch.cuda.device_count())


class Mesh:
    """The ranks of the initialized ``torch.distributed`` world over named
    axes.

    ``shape`` maps each axis name to its size (as ``jax.sharding.Mesh.
    shape`` does); ``devices`` is the rank grid.  Construction is
    collective: every rank creates one process group per line along each
    axis, all of them in the same order, and keeps the ones it belongs to.
    ``device`` is this rank's device (default: its card, ``default_device``).
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device: torch.device | str | None = None):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != \
                len(axis_names):
            raise ValueError(f"mesh shape {shape} and axis names "
                             f"{axis_names} do not match")
        if not dist.is_initialized():
            raise RuntimeError("Mesh needs an initialized torch.distributed "
                               "process group")
        world = dist.get_world_size()
        if math.prod(shape) != world:
            raise ValueError(f"mesh shape {shape} needs {math.prod(shape)} "
                             f"ranks, the world has {world}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.devices = rank_grid(shape)
        self.rank = dist.get_rank()
        self.coords = dict(zip(axis_names, (
            int(c) for c in np.unravel_index(self.rank, shape))))
        self.device = (default_device(self.rank) if device is None
                       else torch.device(device))
        self._groups = {}
        for i, name in enumerate(axis_names):
            lines = np.moveaxis(self.devices, i, -1).reshape(-1, shape[i])
            for line in lines:
                group = dist.new_group(line.tolist())
                if self.rank in line:
                    self._groups[name] = group

    def _check(self, name: str) -> None:
        if name not in self.shape:
            raise ValueError(f"mesh has no axis {name!r} (have: "
                             f"{self.axis_names})")

    def axis_group(self, name: str):
        """This rank's process group along axis ``name``; its group ranks
        follow the axis coordinate."""
        self._check(name)
        return self._groups[name]

    def axis_size(self, name: str) -> int:
        self._check(name)
        return self.shape[name]

    def axis_index(self, name: str) -> int:
        """This rank's coordinate along axis ``name``."""
        self._check(name)
        return self.coords[name]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank} at {self.coords}, "
                f"{self.device})")


def set_mesh(mesh: Mesh | None) -> None:
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def get_mesh() -> Mesh | None:
    return _ACTIVE_MESH


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    old = get_mesh()
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(old)


def pod_count() -> int:
    """Size of the active mesh's ``pod`` axis (1 with no mesh or no pod
    axis)."""
    mesh = get_mesh()
    return mesh.shape["pod"] if mesh is not None and "pod" in mesh.shape \
        else 1


def pod_rank() -> int:
    """This rank's coordinate along the active mesh's ``pod`` axis (0 with
    no mesh or no pod axis)."""
    mesh = get_mesh()
    return mesh.coords["pod"] if mesh is not None and "pod" in mesh.shape \
        else 0


def default_pod_index(n_pods: int) -> int:
    """The pod slice this rank runs: its mesh pod coordinate when the active
    mesh has a pod axis (whose size must be ``n_pods``), else its world rank
    (0 outside a process group), wrapped into range."""
    mesh = get_mesh()
    if mesh is not None and "pod" in mesh.shape:
        if mesh.shape["pod"] != n_pods:
            raise ValueError(
                f"active mesh has a {mesh.shape['pod']}-pod axis but the "
                f"sweep was configured with n_pods={n_pods}; align them or "
                f"pass pod_index explicitly")
        return pod_rank()
    return (dist.get_rank() if dist.is_initialized() else 0) % n_pods
