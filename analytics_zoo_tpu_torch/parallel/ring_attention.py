"""Sequence parallelism: ring attention and Ulysses all-to-all (port of
``analytics_zoo_tpu.parallel.ring_attention``) over the in-process slot
mesh (:class:`~analytics_zoo_tpu_torch.mesh.slots.SlotMesh`).

- :func:`ring_attention`: the sequence is cut into ``n`` shards along the
  mesh's ``seq`` axis; each slot keeps its Q shard while the K/V shards
  rotate around the ring (slot ``j`` hands its shard to ``j + 1``),
  accumulating online-softmax partials. Two per-shard bodies, as in the
  JAX package: the einsum body (:func:`_ring_attention_local`, which also
  takes a key mask whose shards rotate with K/V) and the flash body
  (:func:`_ring_flash_local`), which runs ``flash_attention_with_lse`` per
  rotation (on the card the hand-written kernels: ``n`` forward launches a
  slot, ``n**2`` a call) and merges the partials by their logsumexp, so the
  merge's lse cotangent reaches the dq kernel's delta.
- :func:`ulysses_attention`: an all-to-all trades sequence shards for head
  groups, each slot attends over the full sequence for ``heads / n`` heads
  (through ``ops.attention.scaled_dot_product_attention``: the flash
  kernel on the card), and a second all-to-all trades them back.

The JAX package runs the per-shard body under ``shard_map`` on every
device; here each slot's body runs in turn in one process, and a
collective is a copy between slot tensors (``.to(device)``, ``torch.cat``,
``chunk``), which autograd differentiates as it is. The bodies run once
per slot of the ``seq`` axis's line (the other axes' replicas would
compute the same values). On one card every slot is that card: a rotation
moves nothing, and shards show that the arithmetic and the launches are
right, not memory or speed.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from analytics_zoo_tpu_torch.mesh.slots import SlotMesh

_NEG_INF = -1e30

__all__ = ["ring_attention", "ulysses_attention"]


def _shards(t: torch.Tensor, devices, dim: int) -> List[torch.Tensor]:
    """``t`` cut into ``len(devices)`` equal shards along ``dim``, shard
    ``j`` contiguous on ``devices[j]``."""
    return [c.to(d).contiguous()
            for c, d in zip(t.chunk(len(devices), dim=dim), devices)]


def _rotate(held: List[torch.Tensor], devices) -> List[torch.Tensor]:
    """One ring step (``lax.ppermute`` over ``j -> j + 1``): slot ``j``
    receives what slot ``j - 1`` held, on its own device."""
    n = len(devices)
    return [held[(j - 1) % n].to(devices[j]).contiguous() for j in range(n)]


def _gather(shards: List[torch.Tensor], device, dim: int) -> torch.Tensor:
    return torch.cat([s.to(device) for s in shards], dim=dim)


def _accumulate(q32, q_pos, i, my_idx, n, s_local, causal, carry, k_cur,
                v_cur, km_cur):
    """The einsum body's online-softmax update of one slot against the
    K/V shard it holds after ``i`` rotations (from slot ``(my_idx - i)
    mod n``); ``km_cur`` its (B, S_local) key-validity shard or None."""
    acc, m_prev, l_prev = carry
    src = (my_idx - i) % n
    s = torch.einsum("bhqd,bhkd->bhqk", q32, k_cur.float())
    valid = None
    if causal:
        k_pos = src * s_local + torch.arange(s_local, device=q32.device)
        valid = (q_pos[:, None] >= k_pos[None, :])[None, None]
    if km_cur is not None:
        kv = (km_cur > 0)[:, None, None, :]  # (B, 1, 1, S_local)
        valid = kv if valid is None else torch.logical_and(valid, kv)
    if valid is not None:
        s = torch.where(valid, s, _NEG_INF)
    m_cur = s.amax(dim=-1, keepdim=True)
    m_new = torch.maximum(m_prev, m_cur)
    # guard fully-masked rows (exp(-inf - -inf))
    m_safe = torch.where(m_new <= _NEG_INF, 0.0, m_new)
    p = torch.exp(s - m_safe)
    if valid is not None:
        p = torch.where(valid, p, 0.0)
    alpha = torch.exp(torch.where(m_prev <= _NEG_INF, _NEG_INF, m_prev)
                      - m_safe)
    alpha = torch.where(m_prev <= _NEG_INF, 0.0, alpha)
    l_new = alpha * l_prev + p.sum(dim=-1, keepdim=True)
    acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, v_cur.float())
    return acc, m_new, l_new


def _ring_attention_local(qs, ks, vs, kms, devices, causal: bool,
                          scale: float):
    """The einsum body over every slot of the ring: ``n - 1`` rotating
    steps, then the last shard consumed without a final rotation (its
    result would be discarded). Returns the slots' output shards."""
    n = len(devices)
    s_local = qs[0].shape[2]
    b, h, _, _ = qs[0].shape
    dv = vs[0].shape[-1]
    q32 = [q.float() * scale for q in qs]
    q_pos = [j * s_local + torch.arange(s_local, device=devices[j])
             for j in range(n)]
    carry = [(torch.zeros((b, h, s_local, dv), device=d),
              torch.full((b, h, s_local, 1), _NEG_INF, device=d),
              torch.zeros((b, h, s_local, 1), device=d)) for d in devices]
    k_held, v_held, km_held = ks, vs, kms
    for i in range(n):
        carry = [_accumulate(q32[j], q_pos[j], i, j, n, s_local, causal,
                             carry[j], k_held[j], v_held[j],
                             None if km_held is None else km_held[j])
                 for j in range(n)]
        if i < n - 1:  # rotate K/V (and their key-mask shards)
            k_held, v_held = _rotate(k_held, devices), _rotate(v_held,
                                                               devices)
            if km_held is not None:
                km_held = _rotate(km_held, devices)
    return [(acc / l.clamp_min(1e-30)).to(q.dtype)
            for (acc, _, l), q in zip(carry, qs)]


def _merge(acc, m_prev, l_prev, o_i, lse_i):
    """Online logsumexp merge of one flash partial ``(o_i, lse_i)``."""
    lse_i = lse_i[..., None]  # (B, H, S, 1)
    m_new = torch.maximum(m_prev, lse_i)
    m_safe = torch.where(m_new <= _NEG_INF, 0.0, m_new)
    alpha = torch.where(m_prev <= _NEG_INF, 0.0, torch.exp(m_prev - m_safe))
    beta = torch.where(lse_i <= _NEG_INF, 0.0, torch.exp(lse_i - m_safe))
    acc = acc * alpha + o_i.float() * beta
    l_new = l_prev * alpha + beta
    return acc, m_new, l_new


def _ring_flash_local(qs, ks, vs, devices, causal: bool, scale: float):
    """The flash body over every slot of the ring: each rotation computes
    ``flash_attention_with_lse(q_shard, kv_shard) -> (out, lse)`` partials,
    O(S_local) memory on both block dims, merged by online logsumexp.

    The diagonal (rotation 0, the slot's own shard) is the only causally
    masked block, so the kernel's ``causal`` flag suffices there; under
    causal masking later rotations are all-or-nothing per slot, and as in
    the JAX package they are computed and then gated by sending the lse of
    a shard from a later slot to -1e30 before the merge (no gradient goes
    through a gated partial). Gradients flow through both outputs of the
    kernel, the lse's into the backward's delta."""
    from analytics_zoo_tpu_torch.ops.flash_attention import (
        flash_attention_with_lse,
    )

    n = len(devices)
    b, h, s_local, _ = qs[0].shape
    dv = vs[0].shape[-1]
    carry = [(torch.zeros((b, h, s_local, dv), device=d),
              torch.full((b, h, s_local, 1), _NEG_INF, device=d),
              torch.zeros((b, h, s_local, 1), device=d)) for d in devices]
    k_held, v_held = ks, vs
    for i in range(n):
        if i:
            k_held, v_held = _rotate(k_held, devices), _rotate(v_held,
                                                               devices)
        nxt = []
        for j in range(n):
            o_i, lse_i = flash_attention_with_lse(
                qs[j], k_held[j], v_held[j], causal=causal and i == 0,
                scale=scale)
            if causal and i:
                # after i rotations slot j holds the shard of slot
                # (j - i) mod n: only strictly earlier shards contribute
                src = (j - i) % n
                lse_i = torch.where(
                    torch.tensor(src < j, device=lse_i.device), lse_i,
                    _NEG_INF)
            nxt.append(_merge(*carry[j], o_i, lse_i))
        carry = nxt
    return [(acc / l.clamp_min(1e-30)).to(q.dtype)
            for (acc, _, l), q in zip(carry, qs)]


def _flash_ring_shapes_ok(q, k, v, mesh: SlotMesh, seq_axis: str) -> bool:
    """Do the shard shapes tile the kernel: ``S / n`` a multiple of its
    64-row block, head dims up to 256."""
    from analytics_zoo_tpu_torch.ops.flash_attention import BLOCK_Q

    n = mesh.axis_size(seq_axis)
    s_local = q.shape[2] // n
    return (q.shape[2] % n == 0 and k.shape[2] == q.shape[2]
            and s_local % BLOCK_Q == 0 and q.shape[-1] <= 256
            and v.shape[-1] <= 256)


def _flash_ring_supported(q, k, v, mesh: SlotMesh, seq_axis: str) -> bool:
    """Auto-select gate: q on the card and shard shapes that tile the
    kernel. Off the card the flash body would run the kernels' plain
    loops, far slower than the einsum body; tests force
    ``use_flash=True``."""
    return q.is_cuda and _flash_ring_shapes_ok(q, k, v, mesh, seq_axis)


def ring_attention(q, k, v, mesh: SlotMesh, seq_axis: str = "seq",
                   causal: bool = False, scale: Optional[float] = None,
                   use_flash: Optional[bool] = None, key_mask=None):
    """q/k/v (B, H, S, D) with S sharded over ``mesh``'s ``seq_axis``;
    returns the attention output (B, H, S, Dv) on q's device.

    ``use_flash=None`` takes the flash body when q is on the card and the
    shard shapes tile the kernel (S/n a multiple of 64, head dims up to
    256), the einsum body otherwise; ``use_flash=True`` forces it (on the
    CPU the kernels' plain versions run). ``key_mask``: optional (B, S)
    key-validity mask (1 = attend) for padded long sequences; its shards
    rotate with their K/V shards (einsum body; the flash body has no key
    mask and raises)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if use_flash is None:
        use_flash = (key_mask is None
                     and _flash_ring_supported(q, k, v, mesh, seq_axis))
    if use_flash and key_mask is not None:
        raise NotImplementedError(
            "ring_attention: the flash block engine has no key_mask path — "
            "leave use_flash unset to use the einsum body")
    devices = mesh.line(seq_axis)
    if q.shape[2] % len(devices):
        raise ValueError(f"sequence length {q.shape[2]} does not split "
                         f"over mesh axis '{seq_axis}' ({len(devices)})")
    qs, ks, vs = (_shards(t, devices, 2) for t in (q, k, v))
    if use_flash:
        outs = _ring_flash_local(qs, ks, vs, devices, causal, scale)
    else:
        kms = None if key_mask is None else _shards(key_mask, devices, 1)
        outs = _ring_attention_local(qs, ks, vs, kms, devices, causal,
                                     scale)
    return _gather(outs, q.device, 2)


def _a2a_seq_to_heads(shards, devices):
    """All-to-all (split heads, concat sequence): (B, H, S/n, D) per slot
    -> (B, H/n, S, D), slot ``j`` holding head group ``j``."""
    n = len(devices)
    return [torch.cat([s.chunk(n, dim=1)[j].to(devices[j]) for s in shards],
                      dim=2) for j in range(n)]


def _a2a_heads_to_seq(shards, devices):
    """The inverse all-to-all: (B, H/n, S, D) per slot -> (B, H, S/n, D),
    slot ``i`` holding sequence shard ``i`` of every head group."""
    n = len(devices)
    return [torch.cat([s.chunk(n, dim=2)[i].to(devices[i]) for s in shards],
                      dim=1) for i in range(n)]


def _ulysses_local(qs, ks, vs, kms, devices, causal: bool, scale: float):
    """Every slot's Ulysses body: all-to-all to head groups, full-sequence
    attention on each group through the standard dispatcher (the flash
    kernel on the card; the key mask as a (B, 1, 1, S) bias of -1e30 on
    the keys it excludes), all-to-all back."""
    from analytics_zoo_tpu_torch.ops.attention import (
        scaled_dot_product_attention,
    )

    qh, kh, vh = (_a2a_seq_to_heads(t, devices) for t in (qs, ks, vs))
    outs = []
    for j, d in enumerate(devices):
        bias = None
        if kms is not None:
            # the key mask is per sequence position: each head group
            # needs the whole (B, S) mask
            km_full = _gather(kms, d, 1)
            bias = ((1.0 - (km_full > 0).float())
                    * _NEG_INF)[:, None, None, :].to(qh[j].dtype)
        outs.append(scaled_dot_product_attention(
            qh[j], kh[j], vh[j], bias=bias, causal=causal, scale=scale))
    return _a2a_heads_to_seq(outs, devices)


def ulysses_attention(q, k, v, mesh: SlotMesh, seq_axis: str = "seq",
                      causal: bool = False, scale: Optional[float] = None,
                      key_mask=None):
    """All-to-all sequence parallelism (DeepSpeed-Ulysses style). Requires
    n_heads % mesh[seq_axis] == 0. ``key_mask``: optional (B, S)
    key-validity mask (1 = attend) for padded long sequences."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    devices = mesh.line(seq_axis)
    n = len(devices)
    if q.shape[1] % n != 0:
        raise ValueError(f"n_heads ({q.shape[1]}) must divide by "
                         f"mesh axis '{seq_axis}' size ({n})")
    if q.shape[2] % n:
        raise ValueError(f"sequence length {q.shape[2]} does not split "
                         f"over mesh axis '{seq_axis}' ({n})")
    qs, ks, vs = (_shards(t, devices, 2) for t in (q, k, v))
    kms = None if key_mask is None else _shards(key_mask, devices, 1)
    outs = _ulysses_local(qs, ks, vs, kms, devices, causal, scale)
    return _gather(outs, q.device, 2)
