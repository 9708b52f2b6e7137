"""Flash attention, forward and backward (port of
``analytics_zoo_tpu.ops.flash_attention``).

Tiled online-softmax attention with an optional additive key bias (BERT's
padding mask) and a bottom-right causal mask, O(S) memory, differentiable
in q, k, v, the bias and both outputs (``out`` and the per-row logsumexp).
On a CUDA tensor the forward runs the hand-written kernel
``csrc/flash_attention_fwd.cu`` and the backward the two kernels of
``csrc/flash_attention_bwd.cu`` (dq; dk, dv and the bias gradient); on a
CPU tensor each runs its plain version (:func:`_flash_forward_plain`,
:func:`_flash_backward_plain`), the same block loops in plain PyTorch, which
the tests hold against the JAX package's Pallas kernels and
``chip_smoke.py`` holds the CUDA kernels against on the card. A CUDA tensor
never falls back to a plain version: the kernel launches or the call
raises.

The support envelope is the port's own (:func:`_validate`): sequence lengths
that are multiples of the 64-row tile, head dims up to 256 (the kernels have
64/128/256 cases; smaller head dims are zero-padded up), float32 or bfloat16,
and a bias in the padding-mask layout, broadcastable to (batch, heads, 1,
s_k). The kernels read such a bias through its strides in its own dtype, so
BERT's (batch, 1, 1, s_k) mask reaches them without a copy. Outside it the
entry points raise ``NotImplementedError`` and the dispatcher in
``ops.attention`` falls back to the reference path.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.ops import _kernels

BLOCK_Q = 64   # q rows per block of the kernels and per step of the loops
BLOCK_K = 64   # keys per step of the backward kernels and loops
HEAD_DIMS = (64, 128, 256)  # the kernels' head-dim cases
# keys per step of the bf16 forward kernel, by its (padded) head dim, as the
# kernel's library reports them (azoo_flash_attention_fwd_bf16_block_k;
# chip_smoke.py holds the two equal). The plain forward walks the same key
# tiles, since the running max decides where p rounds to bf16; in f32 it
# steps BLOCK_K keys (the tile only orders the f32 sums there).
FWD_BLOCK_K = {64: 128, 128: 128, 256: 64}
_DTYPES = (torch.float32, torch.bfloat16)
_NEG_INF = -1e30

# launches of each CUDA kernel (not of the plain versions)
launches = _kernels.LaunchCounter()
launches_dq = _kernels.LaunchCounter()
launches_dkv = _kernels.LaunchCounter()


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


def _fwd_block_k(dtype, d: int, dv: int) -> int:
    """The forward kernel's key tile for these operands."""
    if dtype != torch.bfloat16:
        return BLOCK_K
    return FWD_BLOCK_K[next((h for h in HEAD_DIMS if h >= max(d, dv)),
                            HEAD_DIMS[-1])]


def _flash_forward_plain(q, k, v, bias, scale: float, causal: bool):
    """The kernel's block loop in plain PyTorch. q/k/v ``(b, n, s, d)``,
    bias broadcastable to ``(b, n, 1, s_k)`` or None. Returns ``(out,
    lse)``: out ``(b, n, s_q, dv)`` in the input dtype, lse ``(b, n, s_q)``
    f32. Each 64-row q block walks the kernel's key tiles
    (:func:`_fwd_block_k`); a last tile past s_k is cut short, as the
    kernel masks it.

    bf16 inputs: products of bf16 values are exact in f32, so f32 matmuls
    over the bf16 operands (and over p rounded to bf16) are what a bf16
    tensor-core product with f32 accumulation computes."""
    b, n, s_q, d = q.shape
    s_k, dv = k.shape[2], v.shape[-1]
    bn, off, pdt = b * n, s_k - s_q, q.dtype
    bk = _fwd_block_k(q.dtype, d, dv)
    qf, kf, vf = (t.reshape(bn, t.shape[2], t.shape[3]).float()
                  for t in (q, k, v))
    bias_f = None
    if bias is not None:
        bias_f = bias.float().expand(b, n, 1, s_k).reshape(bn, 1, s_k)
    out = torch.empty((bn, s_q, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((bn, s_q), dtype=torch.float32, device=q.device)
    n_kt = -(-s_k // bk)
    for q0 in range(0, s_q, BLOCK_Q):
        m = torch.full((bn, BLOCK_Q, 1), _NEG_INF, device=q.device)
        l = torch.zeros((bn, BLOCK_Q, 1), device=q.device)
        acc = torch.zeros((bn, BLOCK_Q, dv), device=q.device)
        live = n_kt
        if causal:  # key tiles past the block's last query are dead
            live = max(0, min(n_kt, (q0 + BLOCK_Q - 1 + off) // bk + 1))
        q_pos = torch.arange(q0, q0 + BLOCK_Q, device=q.device)[:, None] + off
        for k0 in range(0, live * bk, bk):
            ks = slice(k0, min(k0 + bk, s_k))
            s = qf[:, q0:q0 + BLOCK_Q] @ kf[:, ks].transpose(1, 2) * scale
            if bias_f is not None:
                s = s + bias_f[:, :, ks]
            if causal:
                k_pos = torch.arange(ks.start, ks.stop, device=q.device)
                s = s.masked_fill(q_pos < k_pos[None, :], _NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p.to(pdt).float() @ vf[:, ks]
            m = m_new
        l = torch.clamp_min(l, 1e-30)
        out[:, q0:q0 + BLOCK_Q] = (acc / l).to(q.dtype)
        lse[:, q0:q0 + BLOCK_Q] = (m + torch.log(l))[..., 0]
    return out.reshape(b, n, s_q, dv), lse.reshape(b, n, s_q)


def _delta(out, g, g_lse):
    """delta = rowsum(dO * out) - g_lse, f32 (b, n, s_q): the lse cotangent
    folds in here, since ds = p (dp - delta) + g_lse p."""
    delta = (g.float() * out.float()).sum(dim=-1)
    if g_lse is not None:
        delta = delta - g_lse.float()
    return delta


class _PlainBackward:
    """The operands both plain backward loops share, flattened to (bn, s,
    d) f32 views, and p/ds of one (q tile, key tile) as the kernels form
    them."""

    def __init__(self, q, k, v, bias, out, lse, g, scale, causal, g_lse):
        b, n, s_q, _ = q.shape
        s_k = k.shape[2]
        self.shape, self.dtype, self.dev = (b, n, s_q, s_k), q.dtype, q.device
        self.scale, self.causal, self.off = scale, causal, s_k - s_q
        self.qf, self.kf, self.vf, self.gf = (
            t.reshape(b * n, t.shape[2], t.shape[3]).float()
            for t in (q, k, v, g))
        self.delta = _delta(out, g, g_lse).reshape(b * n, s_q, 1)
        self.lse = lse.float().reshape(b * n, s_q, 1)
        self.bias = None
        if bias is not None:
            self.bias = bias.float().expand(b, n, 1, s_k).reshape(b * n, 1,
                                                                  s_k)

    def live(self, q0, k0):  # _causal_block_live
        return not self.causal or q0 + BLOCK_Q - 1 + self.off >= k0

    def tile(self, q0, k0):
        qs, ks = slice(q0, q0 + BLOCK_Q), slice(k0, k0 + BLOCK_K)
        s = self.qf[:, qs] @ self.kf[:, ks].transpose(1, 2) * self.scale
        if self.bias is not None:
            s = s + self.bias[:, :, ks]
        if self.causal:
            q_pos = torch.arange(q0, q0 + BLOCK_Q,
                                 device=self.dev)[:, None] + self.off
            k_pos = torch.arange(k0, k0 + BLOCK_K, device=self.dev)
            s = s.masked_fill(q_pos < k_pos[None, :], _NEG_INF)
        p = torch.exp(s - self.lse[:, qs])
        dp = self.gf[:, qs] @ self.vf[:, ks].transpose(1, 2)
        return p, p * (dp - self.delta[:, qs])

    def rounded(self, t):
        """A tile as the kernels' bf16 products take it."""
        return t.to(self.dtype).float()


def _dq_plain(pb: _PlainBackward):
    """The dq kernel's loop: one q tile walks the key tiles."""
    b, n, s_q, s_k = pb.shape
    d = pb.qf.shape[-1]
    dq = torch.empty((b * n, s_q, d), dtype=pb.dtype, device=pb.dev)
    for q0 in range(0, s_q, BLOCK_Q):
        acc = torch.zeros((b * n, BLOCK_Q, d), device=pb.dev)
        for k0 in range(0, s_k, BLOCK_K):
            if pb.live(q0, k0):
                _, ds = pb.tile(q0, k0)
                acc = acc + pb.rounded(ds) @ pb.kf[:, k0:k0 + BLOCK_K]
        dq[:, q0:q0 + BLOCK_Q] = (acc * pb.scale).to(pb.dtype)
    return dq.reshape(b, n, s_q, d)


def _dkv_plain(pb: _PlainBackward, need_dbias: bool):
    """The dk/dv/dbias kernel's loop: one key tile walks the q tiles."""
    b, n, s_q, s_k = pb.shape
    d, dv = pb.qf.shape[-1], pb.vf.shape[-1]
    dk = torch.empty((b * n, s_k, d), dtype=pb.dtype, device=pb.dev)
    dvv = torch.empty((b * n, s_k, dv), dtype=pb.dtype, device=pb.dev)
    dbias = (torch.empty((b * n, s_k), device=pb.dev)
             if need_dbias and pb.bias is not None else None)
    for k0 in range(0, s_k, BLOCK_K):
        dk_acc = torch.zeros((b * n, BLOCK_K, d), device=pb.dev)
        dv_acc = torch.zeros((b * n, BLOCK_K, dv), device=pb.dev)
        db = torch.zeros((b * n, BLOCK_K), device=pb.dev)
        for q0 in range(0, s_q, BLOCK_Q):
            if pb.live(q0, k0):
                p, ds = pb.tile(q0, k0)
                qs = slice(q0, q0 + BLOCK_Q)
                dv_acc = dv_acc + pb.rounded(p).transpose(1, 2) @ pb.gf[:, qs]
                dk_acc = dk_acc + pb.rounded(ds).transpose(1, 2) @ pb.qf[:, qs]
                db = db + ds.sum(dim=1)
        dk[:, k0:k0 + BLOCK_K] = (dk_acc * pb.scale).to(pb.dtype)
        dvv[:, k0:k0 + BLOCK_K] = dv_acc.to(pb.dtype)
        if dbias is not None:
            dbias[:, k0:k0 + BLOCK_K] = db
    return (dk.reshape(b, n, s_k, d), dvv.reshape(b, n, s_k, dv),
            None if dbias is None else dbias.reshape(b, n, s_k))


def _flash_backward_plain(q, k, v, bias, out, lse, g, scale: float,
                          causal: bool, g_lse=None, need_dbias=False):
    """The two backward kernels' block loops in plain PyTorch
    (:func:`_dq_plain`, :func:`_dkv_plain`). q/k/v/out/g ``(b, n, s, d)``,
    lse and g_lse ``(b, n, s_q)`` f32, bias as the forward takes it.
    Returns ``(dq, dk, dv, dbias)``: dq/dk/dv in the input dtype; dbias
    ``(b, n, s_k)`` f32, the per-key column sum of ds, when ``need_dbias``,
    else None.

    bf16 inputs: p and ds are rounded to bf16 before p^T dO, ds k and
    ds^T q, as the kernels' bf16 products take them."""
    pb = _PlainBackward(q, k, v, bias, out, lse, g, scale, causal, g_lse)
    return (_dq_plain(pb), *_dkv_plain(pb, need_dbias))


# -- the CUDA kernels --------------------------------------------------------


def _c_fn(lib: str, name: str, n_ptr: int):
    """A kernel's C entry point: ``n_ptr`` pointers, then (bn, s_q, s_k, d,
    is_bf16), scale, (causal, n_head, bias_f32), the three bias strides and
    the stream."""
    fn = getattr(_kernels.load(lib), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_cuda(q, k, v) -> int:
    """Raise on q/k/v the kernels do not take; return the padded head dim
    (the kernels' 64/128/256 case)."""
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
    return dp


def _pad(t, dp: int):
    """Zero head-dim columns up to ``dp``: they add nothing to any product
    and give zero output columns, which the wrappers slice off."""
    return t if t.shape[-1] == dp else F.pad(t, (0, dp - t.shape[-1]))


def _bias_args(bias, q, s_k: int):
    """The kernels' view of the bias: (pointer or None, 1 if it is f32 on
    bf16 operands, its (batch, head, key) element strides)."""
    if bias is None:
        return None, 0, (0, 0, 0)
    b, n = q.shape[:2]
    if (bias.dim() != 4 or bias.shape[0] not in (1, b)
            or bias.shape[1] not in (1, n) or bias.shape[2] != 1
            or bias.shape[3] not in (1, s_k) or bias.device != q.device):
        raise ValueError(f"bias must broadcast to ({b}, {n}, 1, {s_k}) on "
                         f"{q.device}, got {tuple(bias.shape)} on "
                         f"{bias.device}")
    if bias.dtype not in (q.dtype, torch.float32):
        bias = bias.float()  # exact for float16 and bfloat16
    bias = bias.expand(b, n, 1, s_k)  # views: stride 0 where broadcast
    return (bias.data_ptr(), int(bias.dtype != q.dtype),
            (bias.stride(0), bias.stride(1), bias.stride(3)))


def _check_aligned(*ts) -> None:
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError("kernel operands must be 16-byte aligned")


def _flash_forward_cuda(q, k, v, bias, scale: float, causal: bool):
    """Launch the CUDA forward kernel; same contract as the plain version.
    Raises on anything the kernel does not take."""
    dp = _check_cuda(q, k, v)
    b, n, s_q, _ = q.shape
    s_k, dv = k.shape[2], v.shape[-1]
    bias_ptr, bias_f32, strides = _bias_args(bias, q, s_k)
    q, k, v = _pad(q, dp), _pad(k, dp), _pad(v, dp)
    out = torch.empty((b, n, s_q, dp), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, n, s_q), dtype=torch.float32, device=q.device)
    _check_aligned(q, k, v, out)
    with torch.cuda.device(q.device):
        err = _c_fn("flash_attention_fwd", "azoo_flash_attention_fwd", 6)(
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


class _BackwardOperands:
    """What both backward kernels read and write, padded to the kernels'
    head dim: built once per backward by :func:`_flash_backward_cuda`."""

    def __init__(self, q, k, v, bias, out, lse, g, scale, causal, g_lse,
                 need_dbias):
        dp = _check_cuda(q, k, v)
        b, n, s_q, self.d = q.shape
        s_k, self.dv = k.shape[2], v.shape[-1]
        if g.shape != out.shape or out.shape != (b, n, s_q, self.dv):
            raise ValueError(f"out {tuple(out.shape)} and its gradient "
                             f"{tuple(g.shape)} must be ({b}, {n}, {s_q}, "
                             f"{self.dv})")
        if lse.shape != (b, n, s_q) or lse.device != q.device:
            raise ValueError(f"lse must be ({b}, {n}, {s_q}) on {q.device}")
        if need_dbias and bias is None:
            raise ValueError("dbias asked for without a bias")
        self.bias_ptr, bias_f32, strides = _bias_args(bias, q, s_k)
        self.delta = _delta(out, g, g_lse).contiguous()
        self.lse = lse.float().contiguous()
        self.q, self.k, self.v = _pad(q, dp), _pad(k, dp), _pad(v, dp)
        self.g = _pad(g.to(q.dtype).contiguous(), dp)
        dev, dt = q.device, q.dtype
        self.dq = torch.empty((b, n, s_q, dp), dtype=dt, device=dev)
        self.dk = torch.empty((b, n, s_k, dp), dtype=dt, device=dev)
        self.dvv = torch.empty((b, n, s_k, dp), dtype=dt, device=dev)
        self.dbias = (torch.empty((b, n, s_k), device=dev) if need_dbias
                      else None)
        _check_aligned(self.q, self.k, self.v, self.g, self.dq, self.dk,
                       self.dvv)
        self.dims = (b * n, s_q, s_k, dp, int(dt == torch.bfloat16),
                     float(scale), int(causal), n, bias_f32, *strides)

    def _launch(self, name, outputs, counter):
        dev = self.q.device
        inputs = (self.q.data_ptr(), self.k.data_ptr(), self.v.data_ptr(),
                  self.g.data_ptr(), self.lse.data_ptr(),
                  self.delta.data_ptr(), self.bias_ptr)
        with torch.cuda.device(dev):
            err = _c_fn("flash_attention_bwd", name,
                        len(inputs) + len(outputs))(
                *inputs, *outputs, *self.dims,
                torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        counter.add()

    def launch_dq(self):
        self._launch("azoo_flash_attention_bwd_dq", (self.dq.data_ptr(),),
                     launches_dq)

    def launch_dkv(self):
        self._launch("azoo_flash_attention_bwd_dkv",
                     (self.dk.data_ptr(), self.dvv.data_ptr(),
                      None if self.dbias is None else self.dbias.data_ptr()),
                     launches_dkv)

    def results(self):
        d, dv = self.d, self.dv
        return (self.dq[..., :d], self.dk[..., :d], self.dvv[..., :dv],
                self.dbias)


def _flash_backward_cuda(q, k, v, bias, out, lse, g, scale: float,
                         causal: bool, g_lse=None, need_dbias=False):
    """Launch the dq and the dk/dv/dbias kernels; same contract as the
    plain version. Raises on anything the kernels do not take."""
    ops = _BackwardOperands(q, k, v, bias, out, lse, g, scale, causal, g_lse,
                            need_dbias)
    ops.launch_dq()
    ops.launch_dkv()
    return ops.results()


def _flash_forward(q, k, v, bias, scale: float, causal: bool):
    """The forward kernel wrapper: the plain version for a CPU tensor, the
    CUDA kernel otherwise."""
    if q.device.type == "cpu":
        return _flash_forward_plain(q, k, v, bias, scale, causal)
    return _flash_forward_cuda(q, k, v, bias, scale, causal)


def _flash_backward(q, k, v, bias, out, lse, g, scale: float, causal: bool,
                    g_lse=None, need_dbias=False):
    """The backward kernels' wrapper: the plain version for a CPU tensor,
    the CUDA kernels otherwise."""
    if q.device.type == "cpu":
        return _flash_backward_plain(q, k, v, bias, out, lse, g, scale,
                                     causal, g_lse, need_dbias)
    return _flash_backward_cuda(q, k, v, bias, out, lse, g, scale, causal,
                                g_lse, need_dbias)


def _sum_to_bias(dbias, bias):
    """(b, n, s_k) f32 -> the bias's own shape (summed over the dims it
    broadcasts) and dtype, as the JAX package's cotangent must match its
    primal."""
    db = dbias.unsqueeze(2)
    dims = [i for i in range(4) if bias.shape[i] == 1 and db.shape[i] != 1]
    if dims:
        db = db.sum(dim=dims, keepdim=True)
    return db.to(bias.dtype)


class _FlashAttention(torch.autograd.Function):
    """The JAX package's ``_flash`` custom VJP: returns ``(out, lse)``, both
    differentiable; the lse cotangent folds into delta (what lets ring
    attention merge per-shard partials with exact gradients)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, causal):
        out, lse = _flash_forward(q, k, v, bias, scale, causal)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.scale, ctx.causal = scale, causal
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, bias, out, lse = ctx.saved_tensors
        if g is None:
            g = torch.zeros_like(out)
        need_dbias = bias is not None and ctx.needs_input_grad[3]
        dq, dk, dv, dbias = _flash_backward(
            q, k, v, bias, out, lse, g.contiguous(), ctx.scale, ctx.causal,
            g_lse=g_lse, need_dbias=need_dbias)
        if need_dbias:
            dbias = _sum_to_bias(dbias, bias)
        return dq, dk, dv, dbias, None, None


def _attend(q, k, v, bias, scale: float, causal: bool):
    # under no_grad/inference_mode, or with no input that requires a
    # gradient, Function.apply saves nothing and records no graph
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), bias, scale, causal)


def flash_attention(q, k, v, bias: Optional[torch.Tensor] = None,
                    causal: bool = False, scale: Optional[float] = None):
    """q/k/v: (batch, heads, seq, head_dim); bias additive, broadcastable
    to (batch, heads, 1, s_k) (padding-mask layout). Differentiable in q, k,
    v and the bias. Raises NotImplementedError outside the support envelope
    so the dispatcher in ops.attention falls back to the reference path."""
    scale = _validate(q, k, v, bias, scale)
    return _attend(q, k, v, bias, scale, causal)[0]


def flash_attention_with_lse(q, k, v, causal: bool = False,
                             scale: Optional[float] = None):
    """Like :func:`flash_attention` without a bias, also returning the
    per-row logsumexp (b, n, s_q) f32 — the mergeable partial of ring
    attention. Both outputs are differentiable."""
    scale = _validate(q, k, v, None, scale)
    return _attend(q, k, v, None, scale, causal)
