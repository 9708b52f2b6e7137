"""Linear-chain CRF (port of ``analytics_zoo_tpu.keras.layers.crf``): the
sequence classifier behind the tfpark text models (NER's CRF head,
SequenceTagger's ``classifier='crf'``).

The JAX package runs the forward algorithm and Viterbi as ``lax.scan``
over time; here they are Python loops with the fixed trip count S - 1 over
plain tensor ops. Nothing in them reads the host (no ``.item()``, no
value-made shape), so a decode can be captured in a CUDA graph. The tie
rules are the JAX package's: a backpointer and the last tag are the first
index of their maximum (``torch.argmax``, as ``jnp.argmax``), and a padded
step points to itself (the identity backpointer), so a masked tail repeats
the last real tag.

Packing contract: the engine's criterion sees only ``(y_true, y_pred)``, so
the layer emits ``cat([emissions (B,S,T), transitions tiled (B,T,T)],
dim=1)``, (B, S+T, T), or (B, S+T, T+1) with the step mask in the extra
column of the emission rows. :func:`crf_nll` unpacks and computes the
exact negative log-likelihood; :func:`crf_decode` unpacks and runs
Viterbi. The transition matrix rides inside the prediction so that its
gradient reaches ``transitions`` through the loss.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from analytics_zoo_tpu_torch.keras.engine.base import KerasLayer, Shape


def _unpack(packed: torch.Tensor, num_tags: int
            ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Invert the CRF packing. Unmasked layout (B, S+T, T) -> (emissions
    (B,S,T), transitions (T,T), None). Masked layout (B, S+T, T+1) carries
    the step mask in the extra trailing column of the emission rows."""
    mask = None
    if packed.shape[-1] == num_tags + 1:
        mask = packed[:, :-num_tags, num_tags]
        packed = packed[:, :, :num_tags]
    emissions = packed[:, :-num_tags, :]
    transitions = packed[0, -num_tags:, :]
    return emissions, transitions, mask


def _step_mask(mask, emissions: torch.Tensor) -> torch.Tensor:
    b, s = emissions.shape[0], emissions.shape[1]
    if mask is None:
        return torch.ones((b, s), dtype=emissions.dtype,
                          device=emissions.device)
    return torch.as_tensor(mask, device=emissions.device).to(emissions.dtype)


def crf_log_likelihood(emissions: torch.Tensor, transitions: torch.Tensor,
                       tags: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sequence log p(tags | emissions): score(tags) - logZ.

    emissions (B, S, T) float, transitions (T, T), tags (B, S) int,
    mask (B, S) float/bool (1 = real step). Returns (B,).
    """
    mask = _step_mask(mask, emissions)
    tags = torch.as_tensor(tags, device=emissions.device).long()

    # path score: emissions at the gold tags + transitions between them
    em_score = torch.gather(emissions, -1, tags[..., None])[..., 0]
    em_score = torch.sum(em_score * mask, dim=1)
    trans_score = transitions[tags[:, :-1], tags[:, 1:]]          # (B, S-1)
    trans_score = torch.sum(trans_score * mask[:, 1:] * mask[:, :-1], dim=1)

    # partition function: the forward algorithm over time
    alpha = emissions[:, 0, :]
    for t in range(1, emissions.shape[1]):
        scores = (alpha[:, :, None] + transitions[None]
                  + emissions[:, t, None, :])
        new = torch.logsumexp(scores, dim=1)
        alpha = torch.where(mask[:, t, None] > 0, new, alpha)
    log_z = torch.logsumexp(alpha, dim=-1)
    return em_score + trans_score - log_z


def crf_nll(num_tags: int):
    """Criterion factory: mean negative log-likelihood over the batch, for a
    model whose output is the CRF packed tensor."""

    def loss(y_true, y_pred):
        emissions, transitions, mask = _unpack(y_pred, num_tags)
        ll = crf_log_likelihood(emissions, transitions, y_true, mask=mask)
        return -torch.mean(ll)

    return loss


def viterbi_decode(emissions: torch.Tensor, transitions: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Most-likely tag sequence, (B, S) int32: a forward max pass with
    backpointers, then a backward pass that traces the path."""
    b, s, t = emissions.shape
    mask = _step_mask(mask, emissions)
    ident = torch.arange(t, device=emissions.device).expand(b, t)
    score = emissions[:, 0, :]
    bps = []
    for i in range(1, s):
        cand = score[:, :, None] + transitions[None]               # (B,T,T)
        best_prev = torch.argmax(cand, dim=1)                      # (B,T)
        new = torch.amax(cand, dim=1) + emissions[:, i, :]
        real = mask[:, i, None] > 0
        score = torch.where(real, new, score)
        # padded steps point to themselves (identity backpointer)
        bps.append(torch.where(real, best_prev, ident))
    tag = torch.argmax(score, dim=-1)                              # (B,)
    path = [tag]
    for bp in reversed(bps):
        tag = torch.gather(bp, 1, tag[:, None])[:, 0]
        path.append(tag)
    return torch.stack(path[::-1], dim=1).to(torch.int32)


def crf_decode(packed, num_tags: int, mask=None) -> torch.Tensor:
    """Viterbi-decode a packed CRF head output (emissions + transition
    matrix as one tensor, the layer's serving form) to the best tag path
    (B, S), on the packed tensor's device (a host array decodes on the
    CPU)."""
    emissions, transitions, packed_mask = _unpack(torch.as_tensor(packed),
                                                  num_tags)
    return viterbi_decode(emissions, transitions,
                          mask if mask is not None else packed_mask)


class CRF(KerasLayer):
    """CRF head layer. Input: emissions (B, S, T), or with
    ``use_mask=True`` (the reference's crf_mode='pad') a pair
    [emissions, step_mask (B, S)]. Output: the packed (B, S+T, T) tensor,
    (B, S+T, T+1) when masked, carrying emissions, the learned transitions
    and the mask (see the module docstring). Pair with
    ``crf_nll(num_tags)`` as the loss and ``crf_decode`` for inference;
    both read either layout."""

    def __init__(self, num_tags: int, use_mask: bool = False,
                 input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.num_tags = int(num_tags)
        self.use_mask = bool(use_mask)

    def build(self, input_shape: Shape):
        em = input_shape[0] if self.use_mask else input_shape
        if em[-1] != self.num_tags:
            raise ValueError(
                f"CRF expects {self.num_tags} emission scores per step, "
                f"got {em[-1]}")
        self.add_weight("transitions", (self.num_tags, self.num_tags),
                        "zeros")

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        em = input_shape[0] if self.use_mask else input_shape
        width = self.num_tags + (1 if self.use_mask else 0)
        return (em[0], em[1] + self.num_tags, width)

    def call(self, params, x, **kw):
        if self.use_mask:
            x, mask = x
        b = x.shape[0]
        tiled = params["transitions"][None].expand(b, self.num_tags,
                                                   self.num_tags)
        packed = torch.cat([x, tiled], dim=1)
        if self.use_mask:
            col = torch.cat(
                [mask.to(x.dtype),
                 torch.zeros((b, self.num_tags), dtype=x.dtype,
                             device=x.device)], dim=1)
            packed = torch.cat([packed, col[..., None]], dim=-1)
        return packed
