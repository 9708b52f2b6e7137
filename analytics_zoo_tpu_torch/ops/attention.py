"""Attention op (port of ``analytics_zoo_tpu.ops.attention``): the single
entry point the layer library calls.

Routing, the port's own: with ``use_flash=None`` every call on a CUDA tensor
goes to the flash kernel (there is no measured H100 crossover yet; the JAX
package's byte threshold was measured on a TPU and does not carry over),
and a call on a CPU tensor takes the reference path, as the JAX package does
off a TPU. ``use_flash=True`` on a CPU tensor runs the kernel's plain
version. A shape outside the kernel's envelope falls back to the reference
with a one-time warning; build and launch failures on CUDA propagate.
Attention-probability dropout forces the reference path, as in the JAX
package: the kernels have no prob-dropout.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

from analytics_zoo_tpu_torch.ops.flash_attention import flash_attention

logger = logging.getLogger("analytics_zoo_tpu_torch")
_warned_fallback = False


def _auto_use_flash(q, k) -> bool:
    """Default route: the kernel for CUDA tensors, the reference off the
    card."""
    return q.is_cuda


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout: keep each element with probability ``1 - rate``
    and scale the kept ones by ``1 / (1 - rate)``. The draws come from
    ``generator``, which lives on ``x``'s device."""
    keep = 1.0 - rate
    kept = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(kept, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def _reference_attention(q, k, v, bias: Optional[torch.Tensor],
                         causal: bool, scale: float, dropout_rate: float = 0.0,
                         dropout_generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
    logits = torch.einsum("bnqd,bnkd->bnqk", q, k) * scale
    if bias is not None:
        logits = logits + bias
    if causal:
        s_q, s_k = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((s_q, s_k), dtype=torch.bool,
                          device=logits.device).tril(diagonal=s_k - s_q)
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
    # softmax in f32 for bf16 streams
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    if dropout_rate > 0.0 and dropout_generator is not None:
        probs = dropout(probs, dropout_rate, dropout_generator)
    return torch.einsum("bnqk,bnkd->bnqd", probs, v)


def scaled_dot_product_attention(q, k, v, bias: Optional[torch.Tensor] = None,
                                 causal: bool = False,
                                 scale: Optional[float] = None,
                                 dropout_rate: float = 0.0,
                                 dropout_generator: Optional[
                                     torch.Generator] = None,
                                 use_flash: Optional[bool] = None
                                 ) -> torch.Tensor:
    """q/k/v: (batch, heads, seq, head_dim). bias: additive, broadcastable
    to (batch, heads, q_len, k_len) — large negatives for padding masks.
    ``dropout_rate`` is attention-probability dropout drawn from
    ``dropout_generator``; it forces the reference path."""
    global _warned_fallback
    if scale is None:
        scale = q.shape[-1] ** -0.5
    explicit = use_flash is True
    if use_flash is None:
        use_flash = _auto_use_flash(q, k)
    if use_flash and not (dropout_rate > 0.0
                          and dropout_generator is not None):
        try:
            return flash_attention(q, k, v, bias=bias, causal=causal,
                                   scale=scale)
        except NotImplementedError as e:
            if not _warned_fallback:
                _warned_fallback = True
                logger.warning(
                    "flash attention %s but unsupported (%s); falling back "
                    "to the reference path, which materializes the O(S^2) "
                    "logits", "requested" if explicit else "auto-selected", e)
    return _reference_attention(q, k, v, bias, causal, scale, dropout_rate,
                                dropout_generator)
