"""Parallel layers (port of ``analytics_zoo_tpu.parallel``): the top-1
mixture-of-experts FFN. Sharding plans, ring attention and pipeline
stages are not ported yet (ROADMAP A7)."""

from analytics_zoo_tpu_torch.parallel.moe import init_moe_params, moe_ffn

__all__ = ["init_moe_params", "moe_ffn"]
