"""The top-1 mixture-of-experts FFN (port of
``analytics_zoo_tpu.parallel.moe``): the dispatch/combine formulation of
Mesh-TF and Switch.

- router: tokens -> softmax over E experts in float32, top-1 assignment
  (ties go to the first expert);
- capacity: each expert takes at most C = ceil(tokens / E * factor)
  tokens; overflow tokens are dropped (combine weight 0, so the residual
  connection around the layer carries them through unchanged);
- dispatch: a one-hot (T, E, C) tensor scatters tokens into per-expert
  buffers by a dense einsum;
- experts: a two-layer ReLU FFN per expert, a batched matmul;
- combine: the transposed einsum weighted by the router gate.

Everything is dense fixed-shape einsums in float32, with no gather or
sort, in the JAX package's order of operations. The JAX package shards the
expert axis over a mesh; the port runs one device per process, so the
experts run together on it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.keras.layers.core import matmul


def init_moe_params(generator: torch.Generator, d_model: int, d_hidden: int,
                    n_experts: int, dtype=torch.float32):
    """Router and stacked expert FFN weights (the E leading axis is the
    one the JAX package shards)."""
    def normal(shape):
        return torch.empty(shape, dtype=dtype).normal_(generator=generator)

    return {
        "router": normal((d_model, n_experts)) * 0.02,
        "w_in": normal((n_experts, d_model, d_hidden))
        * math.sqrt(2.0 / d_model),
        "w_out": normal((n_experts, d_hidden, d_model))
        * math.sqrt(2.0 / d_hidden),
    }


def moe_ffn(params, x: torch.Tensor, capacity_factor: float = 1.25,
            return_aux: bool = False):
    """Top-1 MoE FFN: ``x`` (tokens, d_model) -> (tokens, d_model).
    Dropped (over-capacity) tokens give zero output, so call sites wrap
    the layer in a residual connection. ``return_aux`` adds the Switch
    load-balancing loss and the dropped share."""
    t = x.shape[0]
    e = params["router"].shape[1]
    c = max(1, int(math.ceil(t / e * capacity_factor)))

    logits = matmul(x, params["router"])                   # (T, E)
    gates = torch.softmax(logits.float(), dim=-1)
    expert_idx = torch.argmax(gates, dim=-1)               # first of ties
    gate = torch.amax(gates, dim=-1)                       # (T,)

    # position of each token in its expert's queue (0-based; the -1 must
    # apply only at the assigned entry, so mask AFTER subtracting)
    onehot = F.one_hot(expert_idx, e).float()              # (T, E)
    pos = (torch.cumsum(onehot, dim=0) - 1.0) * onehot
    pos_in_expert = torch.sum(pos, dim=-1)                 # (T,)
    keep = (pos_in_expert < c).float()
    gate = gate * keep

    # the dispatch tensor (T, E, C): one-hot in both expert and slot
    slot = F.one_hot(torch.clamp(pos_in_expert, 0, c - 1).long(),
                     c).float()                            # (T, C)
    dispatch = onehot[:, :, None] * slot[:, None, :] * keep[:, None, None]
    combine = dispatch * gate[:, None, None]               # (T, E, C)

    xe = torch.einsum("tec,td->ecd", dispatch, x.float())
    h = torch.relu(torch.einsum("ecd,edh->ech", xe,
                                params["w_in"].float()))
    ye = torch.einsum("ech,ehd->ecd", h, params["w_out"].float())
    y = torch.einsum("tec,ecd->td", combine, ye).to(x.dtype)

    if return_aux:
        # the Switch load-balancing auxiliary loss
        frac_tokens = torch.mean(onehot, dim=0)
        frac_gates = torch.mean(gates, dim=0)
        aux = e * torch.sum(frac_tokens * frac_gates)
        return y, {"aux_loss": aux, "dropped": torch.sum(1.0 - keep) / t}
    return y
