"""The PyTorch port's flash-attention forward against the JAX package.

On the CPU the port's kernel wrapper runs its plain PyTorch version (the
same block loop as the CUDA kernel); here it is held against the JAX Pallas
forward kernel, which runs in interpret mode off a TPU, on the same inputs
made with numpy. The CUDA kernel itself is held against the plain version on
the card by ``chip_smoke.py``.

Tolerances: f32 1e-5 absolute (the same f32 arithmetic, other tile widths and
summation orders). bf16 ``out`` 2e-2: both sides round p to bf16 before p.v,
against a running max that depends on the key tile (128 keys in the port's
bf16 forward at head dim 64; the JAX kernel's own at each length), and round
out to bf16 (ulp 2^-8 at 0.5-1), so single elements may differ by a couple of
ulps. bf16 ``lse`` 1e-4: it is
f32 from the same bf16 operands (bf16 products are exact in f32), differing
only in summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops import flash_attention as jfa
from analytics_zoo_tpu.ops.attention import (
    _reference_attention as jax_reference,
)
from analytics_zoo_tpu_torch.ops import attention as tatt
from analytics_zoo_tpu_torch.ops import flash_attention as tfa

B, N, D = 2, 2, 64
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 1e-4)}


def _inputs(seed, s_q, s_k, d=D, bias=False):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, N, s, d)).astype(np.float32)
               for s in (s_q, s_k, s_k))
    b = None
    if bias:  # BERT padding mask: the tail of each row's keys
        lens = rng.integers(s_k // 4, s_k, B)
        m = (np.arange(s_k)[None, :] < lens[:, None]).astype(np.float32)
        b = ((1.0 - m) * -1e9)[:, None, None, :]
    return q, k, v, b


def _jax(a, dtype):
    return None if a is None else jnp.asarray(a, dtype)


def _torch(a, dtype):
    return None if a is None else torch.tensor(a).to(dtype)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if isinstance(
        x, jax.Array) else x.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s_q,s_k,bias,causal", [
    (256, 256, False, False),
    (256, 256, True, False),
    (256, 256, False, True),
    (256, 256, True, True),
    (128, 256, False, True),
    (128, 256, True, True),
])
def test_plain_forward_matches_pallas_kernel(dtype, s_q, s_k, bias, causal):
    """out and lse of the kernel launchers, bias and causal included."""
    q, k, v, b = _inputs(0, s_q, s_k, bias=bias)
    bn, scale = B * N, D ** -0.5
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    b_flat = None if b is None else np.repeat(b[:, :, 0, :], N, axis=1
                                              ).reshape(bn, 1, s_k)
    bq, bk = jfa._resolve_blocks(None, None, s_q, s_k)
    j_out, j_lse = jfa._flash_forward(
        *(_jax(a.reshape(bn, -1, D), jdt) for a in (q, k, v)),
        _jax(b_flat, jdt), scale, causal, bq, bk)
    # the port's wrapper takes (b, n, s, d) and the (b, 1, 1, s_k) mask as is
    t_out, t_lse = tfa._flash_forward(
        *(_torch(a, tdt) for a in (q, k, v)), _torch(b, tdt), scale, causal)
    assert t_out.dtype == tdt and t_lse.dtype == torch.float32
    assert t_out.shape == (B, N, s_q, D) and t_lse.shape == (B, N, s_q)
    out_tol, lse_tol = TOL[dtype]
    np.testing.assert_allclose(_np(t_out).reshape(bn, s_q, D), _np(j_out),
                               rtol=0, atol=out_tol)
    np.testing.assert_allclose(_np(t_lse).reshape(bn, 1, s_q), _np(j_lse),
                               rtol=0, atol=lse_tol)


@pytest.mark.parametrize("layout", ["per_head", "key_dim_1", "batch_1",
                                    "f32_bias_bf16_q"])
def test_bias_layouts_match_pallas_kernel(layout):
    """Every bias layout inside the envelope, which the CUDA kernel reads
    through strides in its own dtype: per-head rows, a key dim of 1, a
    batch dim of 1, and an f32 bias on bf16 operands."""
    rng = np.random.default_rng(6)
    q, k, v, _ = _inputs(6, 128, 128)
    shape = {"per_head": (B, N, 1, 128), "key_dim_1": (B, 1, 1, 1),
             "batch_1": (1, 1, 1, 128), "f32_bias_bf16_q": (B, 1, 1, 128)}
    bias = rng.standard_normal(shape[layout]).astype(np.float32)
    dtype = "bfloat16" if layout == "f32_bias_bf16_q" else "float32"
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    j = jfa.flash_attention(*(_jax(a, jdt) for a in (q, k, v)),
                            _jax(bias, jnp.float32))
    t = tfa.flash_attention(*(_torch(a, tdt) for a in (q, k, v)),
                            _torch(bias, torch.float32))
    assert t.shape == (B, N, 128, D) and t.dtype == tdt
    np.testing.assert_allclose(_np(t), _np(j), rtol=0, atol=TOL[dtype][0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_public_entry_points_match(dtype):
    """flash_attention (padding bias) and flash_attention_with_lse (causal,
    cross lengths) through both packages' public entries."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    out_tol, lse_tol = TOL[dtype]
    q, k, v, b = _inputs(1, 256, 256, bias=True)
    j = jfa.flash_attention(*(_jax(a, jdt) for a in (q, k, v, b)))
    t = tfa.flash_attention(*(_torch(a, tdt) for a in (q, k, v, b)))
    assert t.shape == (B, N, 256, D) and t.dtype == tdt
    np.testing.assert_allclose(_np(t), _np(j), rtol=0, atol=out_tol)

    q, k, v, _ = _inputs(2, 128, 256)
    j_out, j_lse = jfa.flash_attention_with_lse(
        *(_jax(a, jdt) for a in (q, k, v)), causal=True)
    t_out, t_lse = tfa.flash_attention_with_lse(
        *(_torch(a, tdt) for a in (q, k, v)), causal=True)
    assert t_lse.shape == (B, N, 128)
    np.testing.assert_allclose(_np(t_out), _np(j_out), rtol=0, atol=out_tol)
    np.testing.assert_allclose(_np(t_lse), _np(j_lse), rtol=0, atol=lse_tol)


@pytest.mark.parametrize("s_q,s_k,bias,causal", [
    (128, 128, True, False),
    (128, 256, False, True),
    (96, 160, True, True),
])
def test_reference_attention_matches_jax(s_q, s_k, bias, causal):
    q, k, v, b = _inputs(3, s_q, s_k, bias=bias)
    scale = D ** -0.5
    j = jax_reference(*(_jax(a, jnp.float32) for a in (q, k, v, b)),
                      causal, scale)
    t = tatt._reference_attention(
        *(_torch(a, torch.float32) for a in (q, k, v, b)), causal, scale)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-5)


def test_plain_forward_head_dims_other_than_64():
    """The plain version takes any head dim <= 256 (the CUDA wrapper pads
    to its 64/128/256 cases); d=16 is the small test BERT's head dim."""
    q, k, v, b = _inputs(4, 128, 128, d=16, bias=True)
    t = tfa.flash_attention(*(_torch(a, torch.float32) for a in (q, k, v, b)))
    r = tatt._reference_attention(
        *(_torch(a, torch.float32) for a in (q, k, v, b)), False, 0.25)
    np.testing.assert_allclose(t.numpy(), r.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", [
    "seq_not_tiled", "head_dim", "bias_rank", "bias_query_dim",
    "bias_key_dim", "dtype",
])
def test_envelope_raises_not_implemented(case):
    s, d, dtype = 128, D, torch.float32
    bias = None
    if case == "seq_not_tiled":
        s = 100
    elif case == "head_dim":
        d = 320
    elif case == "bias_rank":
        bias = torch.zeros(B, 1, s)
    elif case == "bias_query_dim":
        bias = torch.zeros(B, 1, s, s)
    elif case == "bias_key_dim":
        bias = torch.zeros(B, 1, 1, 7)
    else:
        dtype = torch.float16
    q = torch.zeros(B, N, s, d, dtype=dtype)
    with pytest.raises(NotImplementedError):
        tfa.flash_attention(q, q, q, bias=bias)


def test_dispatcher_routes_on_cpu(monkeypatch, caplog):
    """use_flash=None takes the reference on a CPU tensor, use_flash=True
    the plain kernel version; outside the envelope the explicit request
    falls back to the reference with the reference's one-time warning."""
    q, k, v, b = (_torch(a, torch.float32)
                  for a in _inputs(5, 128, 128, bias=True))
    ref = tatt._reference_attention(q, k, v, b, False, D ** -0.5)
    calls = []
    plain = tfa._flash_forward_plain

    def spy(*a):
        calls.append(1)
        return plain(*a)

    monkeypatch.setattr(tfa, "_flash_forward_plain", spy)
    out = tatt.scaled_dot_product_attention(q, k, v, bias=b)
    assert not calls
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    out = tatt.scaled_dot_product_attention(q, k, v, bias=b, use_flash=True)
    assert calls == [1]
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-5)

    monkeypatch.setattr(tatt, "_warned_fallback", False)
    full = torch.zeros(B, 1, 128, 128)  # query-dim bias: outside envelope
    with caplog.at_level("WARNING", logger="analytics_zoo_tpu_torch"):
        out = tatt.scaled_dot_product_attention(q, k, v, bias=full,
                                                use_flash=True)
    assert calls == [1] and "falling back" in caplog.text
    np.testing.assert_array_equal(
        out.numpy(),
        tatt._reference_attention(q, k, v, full, False, D ** -0.5).numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias,causal", [
    (False, False), (True, False), (False, True), (True, True)])
def test_plain_forward_at_kernel_tiling_ragged(dtype, bias, causal):
    """The bf16 kernel's tiling (128-key tiles at head dim 64) on ragged
    lengths: s_q 192 is an odd number of 64-row tiles, s_k 320 leaves a
    last key tile of 64 keys, which the plain loop cuts short where the
    kernel masks it. Held to the JAX reference attention (the Pallas kernel
    needs multiples of 128) on the same inputs."""
    q, k, v, b = _inputs(7, 192, 320, bias=bias)
    tdt = getattr(torch, dtype)
    assert tfa._fwd_block_k(torch.bfloat16, D, D) == 128
    tq, tk, tv, tb = (_torch(a, tdt) for a in (q, k, v, b))
    t_out, t_lse = tfa._flash_forward_plain(tq, tk, tv, tb, D ** -0.5,
                                            causal)
    # the reference on the same (rounded) operands, in f32
    j = jax_reference(*(_jax(_np(a) if a is not None else None, jnp.float32)
                        for a in (tq, tk, tv, tb)), causal, D ** -0.5)
    assert t_out.dtype == tdt and t_out.shape == (B, N, 192, D)
    np.testing.assert_allclose(_np(t_out), np.asarray(j), rtol=0,
                               atol=TOL[dtype][0])
    # lse: logsumexp of the same masked logits, in f32
    s = (tq.float() @ tk.float().transpose(-1, -2)) * D ** -0.5
    if tb is not None:
        s = s + tb.float()
    if causal:
        keep = (torch.arange(192)[:, None] + 128) >= torch.arange(320)
        s = s.masked_fill(~keep, -1e30)
    np.testing.assert_allclose(t_lse.numpy(), torch.logsumexp(s, -1).numpy(),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_long_keys_match_pallas_kernel(dtype):
    """s_k 2048 with the padding bias, where the kernel's K/V rings wrap
    many times: the plain version at the kernel's tiling against the JAX
    Pallas forward in interpret mode."""
    s_q, s_k = 128, 2048
    q, k, v, b = _inputs(8, s_q, s_k, bias=True)
    bn, scale = B * N, D ** -0.5
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    b_flat = np.repeat(b[:, :, 0, :], N, axis=1).reshape(bn, 1, s_k)
    bq, bk = jfa._resolve_blocks(None, None, s_q, s_k)
    j_out, j_lse = jfa._flash_forward(
        *(_jax(a.reshape(bn, -1, D), jdt) for a in (q, k, v)),
        _jax(b_flat, jdt), scale, False, bq, bk)
    t_out, t_lse = tfa._flash_forward(
        *(_torch(a, tdt) for a in (q, k, v)), _torch(b, tdt), scale, False)
    out_tol, lse_tol = TOL[dtype]
    np.testing.assert_allclose(_np(t_out).reshape(bn, s_q, D), _np(j_out),
                               rtol=0, atol=out_tol)
    np.testing.assert_allclose(_np(t_lse).reshape(bn, 1, s_q), _np(j_lse),
                               rtol=0, atol=lse_tol)
