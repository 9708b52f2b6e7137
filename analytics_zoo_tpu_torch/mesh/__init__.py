"""The declarative mesh layer (port of ``analytics_zoo_tpu.mesh``): the
named device grid, :class:`~analytics_zoo_tpu_torch.mesh.config.MeshConfig`.
The placement policy over it (``ShardingPlan``) is not ported yet
(ROADMAP A7)."""

from analytics_zoo_tpu_torch.mesh.config import MeshConfig

__all__ = ["MeshConfig"]
