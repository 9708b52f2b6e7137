"""MeshConfig, the declarative named device grid (port of
``analytics_zoo_tpu.mesh.config``).

A frozen value object describing the mesh *shape* only; no device is
touched until :meth:`MeshConfig.build` takes its slots from the context's
in-process mesh (:class:`~analytics_zoo_tpu_torch.mesh.slots.SlotMesh`,
``init_nncontext(mesh_shape=...)``). Keeping the declaration device-free
lets a serving config, a trainer, a checkpoint and a script carry the same
object, and keeps the fingerprint stable.

:meth:`MeshConfig.host_local_data` is the data axis of one host process of
a multi-host trainer (:class:`~analytics_zoo_tpu_torch.ft.distributed
.DistContext`): one device, the context's, with the cross-host reduction
above PyTorch in the rendezvous.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["MeshConfig", "DEFAULT_AXIS_NAMES", "STAGE_AXIS"]

#: The canonical axis vocabulary: ``data`` carries the batch, ``fsdp``
#: shards parameters along their leading dim, ``tp`` along the trailing
#: (output) dim.
DEFAULT_AXIS_NAMES: Tuple[str, ...] = ("data", "fsdp", "tp")

#: The pipeline-parallel axis: ``stage`` partitions a model's layer graph
#: into sequential stages. Declared and rendered like any axis.
STAGE_AXIS: str = "stage"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Declarative mesh description: ``axis_lengths`` x ``axis_names``.

    ::

        MeshConfig((8, 1, 1))                  # 8-way data parallel
        MeshConfig((4,), axis_names=("data",)) # data-only mesh
        MeshConfig.from_spec("data=8,tp=1")    # the --mesh CLI syntax

    Validated for internal consistency at construction (rank match,
    positive lengths, unique names) and against the context's slots only
    at :meth:`build`, so a config for a larger mesh can be built,
    serialized and fingerprinted anywhere.
    """

    axis_lengths: Tuple[int, ...]
    axis_names: Tuple[str, ...] = DEFAULT_AXIS_NAMES

    def __post_init__(self) -> None:
        object.__setattr__(self, "axis_lengths",
                           tuple(int(n) for n in self.axis_lengths))
        object.__setattr__(self, "axis_names",
                           tuple(str(n) for n in self.axis_names))
        if len(self.axis_lengths) != len(self.axis_names):
            raise ValueError(
                f"axis_lengths {self.axis_lengths} and axis_names "
                f"{self.axis_names} must have equal rank")
        if not self.axis_lengths:
            raise ValueError("a mesh needs at least one axis")
        if any(n <= 0 for n in self.axis_lengths):
            raise ValueError(
                f"all axis lengths must be positive, got {self.axis_lengths}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(
                f"axis names must be unique, got {self.axis_names}")
        if any(not n for n in self.axis_names):
            raise ValueError(
                f"axis names must be non-empty, got {self.axis_names}")

    @classmethod
    def from_spec(cls, spec: str) -> "MeshConfig":
        """Parse ``"data=8"`` / ``"data=2,tp=4"`` into a config whose axes
        appear in the given order."""
        names, lengths = [], []
        for part in str(spec).split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(
                    f"mesh spec entry {part!r} is not 'axis=length' "
                    f"(full spec: {spec!r})")
            name, _, length = part.partition("=")
            try:
                lengths.append(int(length))
            except ValueError:
                raise ValueError(
                    f"mesh spec axis {name!r} has non-integer length "
                    f"{length!r} (full spec: {spec!r})") from None
            names.append(name.strip())
        if not names:
            raise ValueError(f"empty mesh spec {spec!r}")
        return cls(tuple(lengths), tuple(names))

    @classmethod
    def host_local_data(cls) -> "MeshConfig":
        """The data axis of *this* host process of a multi-host
        data-parallel trainer: one device, the context's (each host is a
        process; the cross-host reduction is the rendezvous of
        :class:`~analytics_zoo_tpu_torch.ft.distributed.DistContext`)."""
        return cls((1,), ("data",))

    @property
    def total_devices(self) -> int:
        """Devices this mesh occupies (product of the axis lengths)."""
        n = 1
        for length in self.axis_lengths:
            n *= length
        return n

    def axis_length(self, name: str) -> int:
        """Length of axis ``name`` (1 when the mesh lacks the axis: a
        missing axis behaves as an unsharded singleton dimension)."""
        try:
            return self.axis_lengths[self.axis_names.index(name)]
        except ValueError:
            return 1

    def build(self):
        """The context mesh's first ``total_devices`` slots (``torch.device``
        entries) as an object array of ``axis_lengths``: a mesh with more
        slots than the context has fails here, naming both counts, instead
        of deep inside a step."""
        from analytics_zoo_tpu_torch.common.nncontext import get_nncontext

        slots = get_nncontext().mesh.slots()
        if self.total_devices > len(slots):
            raise ValueError(
                f"mesh {self.describe()} needs {self.total_devices} "
                f"device slot(s) but the context has {len(slots)} — make "
                "the context with init_nncontext(mesh_shape=...) of at "
                "least as many slots (on the CPU: device='cpu')")
        devices = np.empty((self.total_devices,), dtype=object)
        for i in range(self.total_devices):
            devices[i] = slots[i]
        return devices.reshape(self.axis_lengths)

    def describe(self) -> str:
        """Human-readable shape, e.g. ``"data=8,fsdp=1,tp=1"``."""
        return ",".join(f"{n}={l}" for n, l in
                        zip(self.axis_names, self.axis_lengths))

    def fingerprint(self) -> str:
        """Stable identity string: device count plus every (axis name,
        length) pair, in axis order."""
        return f"devices={self.total_devices};axes={self.describe()}"
