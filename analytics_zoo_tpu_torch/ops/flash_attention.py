"""Flash-attention forward (port of ``analytics_zoo_tpu.ops.flash_attention``).

Tiled online-softmax attention with an optional additive key bias (BERT's
padding mask) and a bottom-right causal mask, O(S) memory. On a CUDA tensor
it runs the hand-written kernel ``csrc/flash_attention_fwd.cu``; on a CPU
tensor it runs :func:`_flash_forward_plain`, the same block loop in plain
PyTorch, which the tests hold against the JAX package's Pallas kernel and
``chip_smoke.py`` holds the CUDA kernel against on the card. A CUDA tensor
never falls back to the plain version: the kernel launches or the call
raises.

The support envelope is the port's own (:func:`_validate`): sequence lengths
that are multiples of the 64-row tile, head dims up to 256 (the kernel has
64/128/256 cases; smaller head dims are zero-padded up), float32 or bfloat16,
and a bias in the padding-mask layout, broadcastable to (batch, heads, 1,
s_k). The kernel reads such a bias through its strides in its own dtype, so
BERT's (batch, 1, 1, s_k) mask reaches it without a copy. Outside it the entry points raise
``NotImplementedError`` and the dispatcher in ``ops.attention`` falls back
to the reference path. The backward kernels come with the training slice.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.ops import _kernels

BLOCK_Q = 64   # q rows per CTA of the kernel and per step of the plain loop
BLOCK_K = 64   # keys per step of the plain loop
HEAD_DIMS = (64, 128, 256)  # the kernel's head-dim cases
_DTYPES = (torch.float32, torch.bfloat16)
_NEG_INF = -1e30

# launches of the CUDA kernel (not of the plain version)
launches = _kernels.LaunchCounter()


def _validate(q, k, v, bias, scale):
    """The support envelope shared by both entry points; returns the
    resolved scale."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.dtype not in _DTYPES:
        raise NotImplementedError(f"dtype {q.dtype}")
    if q.shape[2] % BLOCK_Q or k.shape[2] % BLOCK_Q:
        raise NotImplementedError(f"seq lens must be multiples of {BLOCK_Q}")
    if q.shape[-1] > 256 or v.shape[-1] > 256:
        raise NotImplementedError("head_dim > 256")
    if bias is not None:
        if bias.dim() != 4:
            raise NotImplementedError("bias must be rank-4")
        if bias.shape[2] != 1:
            raise NotImplementedError("bias with query dim > 1")
        if bias.shape[3] not in (1, k.shape[2]):
            raise NotImplementedError("bias key dim mismatch")
    return scale


def _flash_forward_plain(q, k, v, bias, scale: float, causal: bool):
    """The kernel's block loop in plain PyTorch. q/k/v ``(b, n, s, d)``,
    bias broadcastable to ``(b, n, 1, s_k)`` or None. Returns ``(out,
    lse)``: out ``(b, n, s_q, dv)`` in the input dtype, lse ``(b, n, s_q)``
    f32.

    bf16 inputs: products of bf16 values are exact in f32, so f32 matmuls
    over the bf16 operands (and over p rounded to bf16) are what a bf16
    tensor-core product with f32 accumulation computes."""
    b, n, s_q, _ = q.shape
    s_k, dv = k.shape[2], v.shape[-1]
    bn, off, pdt = b * n, s_k - s_q, q.dtype
    qf, kf, vf = (t.reshape(bn, t.shape[2], t.shape[3]).float()
                  for t in (q, k, v))
    bias_f = None
    if bias is not None:
        bias_f = bias.float().expand(b, n, 1, s_k).reshape(bn, 1, s_k)
    out = torch.empty((bn, s_q, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((bn, s_q), dtype=torch.float32, device=q.device)
    n_kt = s_k // BLOCK_K
    for q0 in range(0, s_q, BLOCK_Q):
        m = torch.full((bn, BLOCK_Q, 1), _NEG_INF, device=q.device)
        l = torch.zeros((bn, BLOCK_Q, 1), device=q.device)
        acc = torch.zeros((bn, BLOCK_Q, dv), device=q.device)
        live = n_kt
        if causal:  # key tiles past the tile's last query are dead
            live = max(0, min(n_kt, (q0 + BLOCK_Q - 1 + off) // BLOCK_K + 1))
        q_pos = torch.arange(q0, q0 + BLOCK_Q, device=q.device)[:, None] + off
        for k0 in range(0, live * BLOCK_K, BLOCK_K):
            s = qf[:, q0:q0 + BLOCK_Q] @ kf[:, k0:k0 + BLOCK_K].transpose(1, 2)
            s = s * scale
            if bias_f is not None:
                s = s + bias_f[:, :, k0:k0 + BLOCK_K]
            if causal:
                k_pos = torch.arange(k0, k0 + BLOCK_K, device=q.device)
                s = s.masked_fill(q_pos < k_pos[None, :], _NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p.to(pdt).float() @ vf[:, k0:k0 + BLOCK_K]
            m = m_new
        l = torch.clamp_min(l, 1e-30)
        out[:, q0:q0 + BLOCK_Q] = (acc / l).to(q.dtype)
        lse[:, q0:q0 + BLOCK_Q] = (m + torch.log(l))[..., 0]
    return out.reshape(b, n, s_q, dv), lse.reshape(b, n, s_q)


def _kernel_fn():
    fn = _kernels.load("flash_attention_fwd").azoo_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _flash_forward_cuda(q, k, v, bias, scale: float, causal: bool):
    """Launch the CUDA kernel; same contract as the plain version. Raises
    on anything the kernel does not take."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on q's CUDA device, got "
                             f"{t.device}")
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16 like q, "
                            f"got {t.dtype}")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (b, n, s, d) "
                             f"tensor")
    b, n, s_q, d = q.shape
    s_k, dv = k.shape[2], v.shape[-1]
    if k.shape != (b, n, s_k, d) or v.shape[:3] != (b, n, s_k):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if s_q % BLOCK_Q or s_k % BLOCK_Q:
        raise ValueError(f"seq lens must be multiples of {BLOCK_Q}")
    dp = next((h for h in HEAD_DIMS if h >= max(d, dv)), None)
    if dp is None:
        raise ValueError(f"head dims ({d}, {dv}) exceed {HEAD_DIMS[-1]}")
    # zero columns leave q.k unchanged and add zero output columns
    if d != dp:
        q, k = F.pad(q, (0, dp - d)), F.pad(k, (0, dp - d))
    if dv != dp:
        v = F.pad(v, (0, dp - dv))
    bias_ptr, bias_f32, strides = None, 0, (0, 0, 0)
    if bias is not None:
        if (bias.dim() != 4 or bias.shape[0] not in (1, b)
                or bias.shape[1] not in (1, n) or bias.shape[2] != 1
                or bias.shape[3] not in (1, s_k)
                or bias.device != q.device):
            raise ValueError(f"bias must broadcast to ({b}, {n}, 1, {s_k}) "
                             f"on {q.device}, got {tuple(bias.shape)} on "
                             f"{bias.device}")
        if bias.dtype not in (q.dtype, torch.float32):
            bias = bias.float()  # exact for float16 and bfloat16
        bias = bias.expand(b, n, 1, s_k)  # views: stride 0 where broadcast
        bias_ptr, bias_f32 = bias.data_ptr(), int(bias.dtype != q.dtype)
        strides = (bias.stride(0), bias.stride(1), bias.stride(3))
    out = torch.empty((b, n, s_q, dp), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, n, s_q), dtype=torch.float32, device=q.device)
    for t in (q, k, v, out):
        if t.data_ptr() % 16:
            raise ValueError("q, k, v and out must be 16-byte aligned")
    with torch.cuda.device(q.device):
        err = _kernel_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr,
            out.data_ptr(), lse.data_ptr(), b * n, s_q, s_k, dp,
            int(q.dtype == torch.bfloat16), float(scale), int(causal), n,
            bias_f32, *strides,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{err}")
    launches.add()
    return (out if dv == dp else out[..., :dv]), lse


def _flash_forward(q, k, v, bias, scale: float, causal: bool):
    """The kernel wrapper: the plain version for a CPU tensor, the CUDA
    kernel otherwise."""
    if q.device.type == "cpu":
        return _flash_forward_plain(q, k, v, bias, scale, causal)
    return _flash_forward_cuda(q, k, v, bias, scale, causal)


def flash_attention(q, k, v, bias: Optional[torch.Tensor] = None,
                    causal: bool = False, scale: Optional[float] = None):
    """q/k/v: (batch, heads, seq, head_dim); bias additive, broadcastable
    to (batch, heads, 1, s_k) (padding-mask layout). Raises
    NotImplementedError outside the support envelope so the dispatcher in
    ops.attention falls back to the reference path."""
    scale = _validate(q, k, v, bias, scale)
    out, _ = _flash_forward(q.contiguous(), k.contiguous(), v.contiguous(),
                            bias, scale, causal)
    return out


def flash_attention_with_lse(q, k, v, causal: bool = False,
                             scale: Optional[float] = None):
    """Like :func:`flash_attention` without a bias, also returning the
    per-row logsumexp (b, n, s_q) f32 — the mergeable partial of ring
    attention."""
    scale = _validate(q, k, v, None, scale)
    return _flash_forward(q.contiguous(), k.contiguous(), v.contiguous(),
                          None, scale, causal)
