"""The in-process mesh: a named grid of *slots*, each bound to a
``torch.device``.

The JAX package is a single controller: one process addresses every
device of its ``jax.sharding.Mesh`` and ``shard_map`` runs a per-shard body
over them. The port keeps that shape in one process. A slot stands where a
JAX mesh device stands; a collective is an explicit copy between the slot
tensors (``.to(device)``, ``torch.cat``, ``chunk``), which autograd
differentiates as it is. No ``torch.distributed`` process group is
involved (multi-host data parallelism, across processes, is
:mod:`analytics_zoo_tpu_torch.ft.distributed`).

Slots are dealt over the context's devices: on the CPU every slot is the
CPU; on the card they go round-robin over ``torch.cuda.device_count()``
cards, so on one card every slot is that card and on four cards each of
four slots has its own. On one card, shards show that the arithmetic and
the kernel launches are right, not memory or speed.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["SlotMesh"]


class SlotMesh:
    """A grid of slots: ``devices`` is an object array of ``torch.device``
    shaped by the axis lengths, ``axis_names`` names its axes."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        self.axis_names: Tuple[str, ...] = tuple(str(n) for n in axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(
                f"slot array of rank {devices.ndim} does not match axis "
                f"names {self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(
                f"axis names must be unique, got {self.axis_names}")
        self.devices = devices

    @classmethod
    def deal(cls, shape, axis_names: Sequence[str],
             device: torch.device) -> "SlotMesh":
        """``prod(shape)`` slots over ``device``'s kind: all ``device`` on
        the CPU, round-robin over the visible cards on CUDA (from
        ``device``'s index). ``shape=None`` is one slot, ``device``
        itself, with every axis of length 1."""
        names = tuple(axis_names)
        if shape is None:
            grid = np.empty((1,) * len(names), dtype=object)
            grid.flat[0] = device
            return cls(grid, names)
        shape = tuple(int(n) for n in shape)
        if len(shape) != len(names):
            raise ValueError(f"mesh_shape {shape} and mesh_axis_names "
                             f"{names} must have equal rank")
        if any(n <= 0 for n in shape):
            raise ValueError(f"mesh lengths must be positive, got {shape}")
        n = int(np.prod(shape))
        if device.type == "cuda":
            count = torch.cuda.device_count()
            base = device.index or 0
            slots = [torch.device("cuda", (base + i) % count)
                     for i in range(n)]
        else:
            slots = [device] * n
        grid = np.empty((n,), dtype=object)
        for i, d in enumerate(slots):
            grid[i] = d
        return cls(grid.reshape(shape), names)

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis name: length}``, in axis order (``jax`` Mesh.shape)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        """The number of slots."""
        return int(self.devices.size)

    def axis_size(self, name: str) -> int:
        """Length of axis ``name`` (1 when the mesh lacks it)."""
        return self.shape.get(name, 1)

    def slots(self) -> List[torch.device]:
        """Every slot's device, in row-major slot order."""
        return list(self.devices.flat)

    def line(self, axis: str) -> List[torch.device]:
        """The slots along ``axis`` with every other coordinate 0: where a
        per-shard body over that axis runs once (the JAX package runs it
        again on every replica of the other axes, to the same values)."""
        index = [0] * len(self.axis_names)
        out = []
        for j in range(self.axis_size(axis)):
            if axis in self.axis_names:
                index[self.axis_names.index(axis)] = j
            out.append(self.devices[tuple(index)])
        return out

    def __repr__(self) -> str:
        kinds = "/".join(sorted({str(d) for d in self.devices.flat}))
        axes = ",".join(f"{n}={l}" for n, l in self.shape.items())
        return f"SlotMesh({axes} on {kinds})"
