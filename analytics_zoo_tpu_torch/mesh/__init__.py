"""The declarative mesh layer (port of ``analytics_zoo_tpu.mesh``): the
named device grid, :class:`~analytics_zoo_tpu_torch.mesh.config.MeshConfig`,
and the placement policy over it,
:class:`~analytics_zoo_tpu_torch.mesh.plan.ShardingPlan`, on the context's
in-process slot mesh (:class:`~analytics_zoo_tpu_torch.mesh.slots.SlotMesh`).

Consumers: ``InferenceModel(sharding_plan=...)`` runs one program per
(bucket, data slot); ``ServingEngine.register(..., sharding_plan=...)`` and
``BatchPredictJob(..., sharding_plan=...)`` validate their bucket ladders
against the plan's ``data`` axis before they touch the model.
"""

from analytics_zoo_tpu_torch.mesh.config import MeshConfig
from analytics_zoo_tpu_torch.mesh.plan import BucketShardingError, ShardingPlan
from analytics_zoo_tpu_torch.mesh.slots import SlotMesh

__all__ = ["MeshConfig", "ShardingPlan", "BucketShardingError", "SlotMesh"]
