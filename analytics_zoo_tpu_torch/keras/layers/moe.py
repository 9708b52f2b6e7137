"""MoE as a layer (port of ``analytics_zoo_tpu.keras.layers.moe``): the
top-1 mixture-of-experts FFN of :mod:`analytics_zoo_tpu_torch.parallel.moe`
with a residual connection, so ``Sequential`` and functional models get
sparse-expert capacity through the same compile/fit path as every layer.
The JAX package shards the expert weights' leading axis over a mesh axis
(``expert_axis``); the port runs one device per process, so the argument
is kept for the same signature and the experts run together there."""

from __future__ import annotations

import math

import torch

from analytics_zoo_tpu_torch.keras.engine.base import (
    KerasLayer,
    Regularizer,
    Shape,
    unique_name,
)


def _expert_init(fan: int):
    """He normal over one expert matrix's own fan-in (the generic fans
    would fold the expert count into the receptive field)."""
    def init(generator, shape, dtype=torch.float32):
        return math.sqrt(2.0 / fan) * torch.empty(
            shape, dtype=dtype).normal_(generator=generator)
    return init


class MoE(KerasLayer):
    """Residual top-1 mixture-of-experts FFN over the last dim.

    Input (..., d) -> output (..., d): ``x + moe_ffn(x)``; dropped
    (over-capacity) tokens pass through on the residual, as in Switch.
    ``router_l2``: plain L2 on the router weights (not the load-balancing
    loss, which needs the routing statistics: ``parallel.moe.moe_ffn(...,
    return_aux=True)``)."""

    def __init__(self, n_experts: int, hidden_dim: int,
                 capacity_factor: float = 1.25, router_l2: float = 0.0,
                 expert_axis: str = "model", input_shape=None, name=None):
        super().__init__(input_shape, name or unique_name("moe"))
        self.n_experts = int(n_experts)
        self.hidden_dim = int(hidden_dim)
        self.capacity_factor = float(capacity_factor)
        self.router_l2 = float(router_l2)
        self.expert_axis = expert_axis

    def build(self, input_shape: Shape):
        d = input_shape[-1]
        self.add_weight(
            "router", (d, self.n_experts), init="normal",
            regularizer=Regularizer(l2=self.router_l2) if self.router_l2
            else None)
        self.add_weight("w_in", (self.n_experts, d, self.hidden_dim),
                        init=_expert_init(d))
        self.add_weight("w_out", (self.n_experts, self.hidden_dim, d),
                        init=_expert_init(self.hidden_dim))

    def call(self, params, x, **kw):
        from analytics_zoo_tpu_torch.parallel.moe import moe_ffn

        shape = x.shape
        y = moe_ffn({"router": params["router"], "w_in": params["w_in"],
                     "w_out": params["w_out"]}, x.reshape(-1, shape[-1]),
                    capacity_factor=self.capacity_factor)
        return x + y.reshape(shape)
