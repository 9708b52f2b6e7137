"""Typed runtime configuration (port of ``analytics_zoo_tpu.common.config``).

Keeps the dtype policy and the seed of the JAX package's ``ZooConfig`` and
adds the device. The mesh and multi-process fields come with the
distribution slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class ZooConfig:
    """Global runtime configuration.

    Attributes:
      device: torch device string. ``None`` means ``"cuda"``: the port runs
        on the card unless the caller asks for the CPU.
      default_dtype: compute dtype name (``"float32"``, ``"bfloat16"``).
      param_dtype: parameter dtype name.
      seed: root seed of the context's ``torch.Generator``.
    """

    device: Optional[str] = None
    default_dtype: str = "float32"
    param_dtype: str = "float32"
    seed: int = 0

    def replace(self, **kw) -> "ZooConfig":
        """dataclasses.replace-style copy with overrides."""
        return dataclasses.replace(self, **kw)
