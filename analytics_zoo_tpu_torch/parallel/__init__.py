"""Parallel layers and layouts (port of ``analytics_zoo_tpu.parallel``) on
the in-process slot mesh: the sharding helpers, ring and Ulysses sequence
parallelism, GPipe stages over a ``pipe`` axis and the top-1
mixture-of-experts FFN."""

from analytics_zoo_tpu_torch.parallel.moe import init_moe_params, moe_ffn
from analytics_zoo_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    stack_stage_params,
)
from analytics_zoo_tpu_torch.parallel.ring_attention import (
    ring_attention,
    ulysses_attention,
)
from analytics_zoo_tpu_torch.parallel.sharding import (
    PartitionSpec,
    ShardedTensor,
    ShardingRules,
    SlotSharding,
    data_sharding,
    named_sharding,
    param_shardings,
    place_params,
    replicated,
    shard_batch,
)

__all__ = [
    "ShardingRules",
    "data_sharding",
    "replicated",
    "shard_batch",
    "named_sharding",
    "param_shardings",
    "place_params",
    "PartitionSpec",
    "SlotSharding",
    "ShardedTensor",
    "ring_attention",
    "ulysses_attention",
    "pipeline_apply",
    "stack_stage_params",
    "init_moe_params",
    "moe_ffn",
]
