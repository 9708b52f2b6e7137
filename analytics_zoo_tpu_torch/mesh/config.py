"""MeshConfig, the declarative named device grid (port of
``analytics_zoo_tpu.mesh.config``).

A frozen value object describing the mesh *shape* only; no device is
touched until :meth:`MeshConfig.build` checks it against the devices of
this process. Keeping the declaration device-free lets a trainer, a
checkpoint and a script carry the same object, and keeps the fingerprint
stable.

The port runs one device per process (``NNContext.num_devices``): hosts
are processes, and the cross-host reduction happens above PyTorch, in the
rendezvous of :class:`~analytics_zoo_tpu_torch.ft.distributed.DistContext`.
So :meth:`MeshConfig.host_local_data` is a one-device data axis and
:meth:`MeshConfig.build` refuses a larger mesh, naming the device count.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["MeshConfig", "DEFAULT_AXIS_NAMES", "STAGE_AXIS"]

#: The canonical axis vocabulary: ``data`` carries the batch, ``fsdp``
#: shards parameters along their leading dim, ``tp`` along the trailing
#: (output) dim.
DEFAULT_AXIS_NAMES: Tuple[str, ...] = ("data", "fsdp", "tp")

#: The pipeline-parallel axis: ``stage`` partitions a model's layer graph
#: into sequential stages. Declared and rendered like any axis.
STAGE_AXIS: str = "stage"


def _process_device_count() -> int:
    from analytics_zoo_tpu_torch.common.nncontext import get_nncontext

    return int(get_nncontext().num_devices)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Declarative mesh description: ``axis_lengths`` x ``axis_names``.

    ::

        MeshConfig((1, 1, 1))                  # one device
        MeshConfig((4,), axis_names=("data",)) # data-only mesh
        MeshConfig.from_spec("data=8,tp=1")    # the --mesh CLI syntax

    Validated for internal consistency at construction (rank match,
    positive lengths, unique names) and against the process's devices only
    at :meth:`build`, so a config for a larger machine can be built,
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
        """A data-only mesh over every device of *this* process: the
        default mesh of a multi-host data-parallel trainer. On the port
        that is one device (the context's). Touches the context, so unlike
        the other constructors this one is not device-free."""
        return cls((_process_device_count(),), ("data",))

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
        """The process's devices as an object array of ``axis_lengths``
        (``torch.device`` entries), after checking the shape against the
        device count: a mesh bigger than the process fails here, naming
        the count, instead of deep inside a step."""
        import numpy as np

        from analytics_zoo_tpu_torch.common.nncontext import get_nncontext

        ctx = get_nncontext()
        available = int(ctx.num_devices)
        if self.total_devices > available:
            raise ValueError(
                f"mesh {self.describe()} needs {self.total_devices} "
                f"device(s) but this process has {available} (the port "
                "runs one device per process; spread a larger data axis "
                "over host processes with ft.distributed.DistContext)")
        devices = np.empty((self.total_devices,), dtype=object)
        for i in range(self.total_devices):
            devices[i] = ctx.device
        return devices.reshape(self.axis_lengths)

    def describe(self) -> str:
        """Human-readable shape, e.g. ``"data=8,fsdp=1,tp=1"``."""
        return ",".join(f"{n}={l}" for n, l in
                        zip(self.axis_names, self.axis_lengths))

    def fingerprint(self) -> str:
        """Stable identity string: device count plus every (axis name,
        length) pair, in axis order."""
        return f"devices={self.total_devices};axes={self.describe()}"
