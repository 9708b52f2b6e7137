"""Typed runtime configuration (port of ``analytics_zoo_tpu.common.config``).

Keeps the mesh, the dtype policy and the seed of the JAX package's
``ZooConfig`` and adds the device. The multi-process fields (the JAX
package's ``jax.distributed`` coordinator) have no port: hosts are
processes that meet in :class:`~analytics_zoo_tpu_torch.ft.distributed
.DistContext`'s rendezvous.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass
class ZooConfig:
    """Global runtime configuration.

    Attributes:
      device: torch device string. ``None`` means ``"cuda"``: the port runs
        on the card unless the caller asks for the CPU.
      mesh_shape: slots per mesh axis (the in-process mesh,
        :class:`~analytics_zoo_tpu_torch.mesh.slots.SlotMesh`). ``None``
        is one slot, the context's device. On the card the slots are dealt
        round-robin over the visible cards; on the CPU every slot is the
        CPU.
      mesh_axis_names: logical axis names. Convention: ``data`` (batch),
        ``model`` (tensor parallel), ``seq`` (sequence parallel).
      default_dtype: compute dtype name (``"float32"``, ``"bfloat16"``).
      param_dtype: parameter dtype name.
      seed: root seed of the context's ``torch.Generator``.
    """

    device: Optional[str] = None
    mesh_shape: Optional[Sequence[int]] = None
    mesh_axis_names: Sequence[str] = ("data", "model")
    default_dtype: str = "float32"
    param_dtype: str = "float32"
    seed: int = 0

    def replace(self, **kw) -> "ZooConfig":
        """dataclasses.replace-style copy with overrides."""
        return dataclasses.replace(self, **kw)
