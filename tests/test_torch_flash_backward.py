"""The PyTorch port's flash-attention backward against the JAX package.

On the CPU the port's autograd Function runs the plain versions of its CUDA
kernels (the dq and dk/dv/dbias block loops); here ``torch.autograd`` through
``flash_attention``/``flash_attention_with_lse`` is held against ``jax.grad``
through the JAX package's entry points, whose Pallas kernels run in
interpret mode off a TPU, on the same numpy inputs and output gradients.
The CUDA kernels themselves are held against the plain versions on the card
by ``chip_smoke.py``. Sequence lengths are multiples of 128, so the JAX
kernels tile them.

Tolerances: f32 1e-5 absolute (the same f32 arithmetic in other tile widths
and summation orders; the gradients here are below 4 in magnitude). bf16
2e-2 x max(1, max |JAX|): dq/dk/dv are rounded to bf16 (2^-8 relative), and
both sides round p and ds to bf16 before their products, after a forward
whose lse and a tiling (64 vs 128 keys) that differ in summation order, so
single roundings may flip by one ulp. One exception: a bias with key dim 1
adds one constant to every key of a row, and softmax is shift-invariant,
so its gradient is exactly zero; in bf16 both sides return the rounding of
delta = rowsum(dO * out) against out in bf16, which is noise, so each side
is held to zero within that rounding, 2^-7 * sum |dO * out| over the rows
the bias element covers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops import flash_attention as jfa
from analytics_zoo_tpu_torch.ops import attention as tatt
from analytics_zoo_tpu_torch.ops import flash_attention as tfa

B, N, D = 2, 2, 64
CASES = {  # name: (s_q, s_k, bias, causal, lse cotangent)
    "no_bias": (256, 256, None, False, False),
    "padding_bias": (256, 256, "pad", False, False),
    "per_head_dbias": (256, 256, "head", False, False),
    "key_dim_1_dbias": (128, 256, "key1", True, False),
    "causal": (256, 256, None, True, False),
    "causal_cross": (128, 384, "pad", True, False),
    "lse_cotangent": (256, 256, None, True, True),
    "lse_cotangent_cross": (128, 256, None, False, True),
}
DBIAS = ("head", "key1")  # bias kinds whose gradient is checked


def _inputs(seed, s_q, s_k, bias, d=D):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, N, s, d)).astype(np.float32)
               for s in (s_q, s_k, s_k))
    g = rng.standard_normal((B, N, s_q, d)).astype(np.float32)
    g_lse = rng.standard_normal((B, N, s_q)).astype(np.float32)
    b = None
    if bias == "pad":  # BERT's padding mask: the tail of each row's keys
        lens = rng.integers(s_k // 4, s_k, B)
        m = (np.arange(s_k)[None, :] < lens[:, None]).astype(np.float32)
        b = ((1.0 - m) * -1e9)[:, None, None, :]
    elif bias is not None:
        shape = {"head": (B, N, 1, s_k), "key1": (B, 1, 1, 1)}[bias]
        b = rng.standard_normal(shape).astype(np.float32)
    return q, k, v, b, g, g_lse


def _bias_dtype(bias, dtype):
    # a bias with a gradient stays f32; the padding mask comes in the
    # compute dtype, as MultiHeadAttention makes it
    return "float32" if bias in DBIAS else dtype


def _jax_grads(q, k, v, b, g, g_lse, dtype, bias, causal, with_lse):
    jdt = getattr(jnp, dtype)
    args = [jnp.asarray(a, jdt) for a in (q, k, v)]
    jb = None if b is None else jnp.asarray(b, getattr(jnp,
                                                       _bias_dtype(bias,
                                                                   dtype)))
    jg, jgl = jnp.asarray(g, jdt), jnp.asarray(g_lse)

    def loss(q_, k_, v_, b_):
        if with_lse:
            out, lse = jfa.flash_attention_with_lse(q_, k_, v_, causal=causal)
            return (jnp.sum(out.astype(jnp.float32) * jg.astype(jnp.float32))
                    + jnp.sum(lse * jgl))
        out = jfa.flash_attention(q_, k_, v_, b_, causal=causal)
        return jnp.sum(out.astype(jnp.float32) * jg.astype(jnp.float32))

    argnums = (0, 1, 2, 3) if bias in DBIAS else (0, 1, 2)
    grads = jax.grad(loss, argnums=argnums)(*args, jb)
    return [np.asarray(jnp.asarray(x, jnp.float32)) for x in grads]


def _torch_grads(q, k, v, b, g, g_lse, dtype, bias, causal, with_lse):
    tdt = getattr(torch, dtype)
    ts = [torch.tensor(a).to(tdt).requires_grad_() for a in (q, k, v)]
    tb = None
    if b is not None:
        tb = torch.tensor(b).to(getattr(torch, _bias_dtype(bias, dtype)))
        tb.requires_grad_(bias in DBIAS)
    if with_lse:
        out, lse = tfa.flash_attention_with_lse(*ts, causal=causal)
        grads = torch.autograd.grad(
            (out, lse), ts, (torch.tensor(g).to(tdt), torch.tensor(g_lse)))
    else:
        out = tfa.flash_attention(*ts, bias=tb, causal=causal)
        wrt = ts + ([tb] if bias in DBIAS else [])
        grads = torch.autograd.grad(out, wrt, torch.tensor(g).to(tdt))
    for x, ref in zip(grads, ts + [tb]):
        assert x.dtype == ref.dtype and x.shape == ref.shape
    return [x.float().numpy() for x in grads]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_pallas_kernels(dtype, case):
    """dq, dk, dv (and dbias) of the autograd Function on CPU tensors
    against jax.grad through the Pallas kernels."""
    s_q, s_k, bias, causal, with_lse = CASES[case]
    inputs = _inputs(list(CASES).index(case), s_q, s_k, bias)
    j = _jax_grads(*inputs, dtype, bias, causal, with_lse)
    t = _torch_grads(*inputs, dtype, bias, causal, with_lse)
    assert len(t) == len(j) == (4 if bias in DBIAS else 3)
    for name, a, r in zip(("dq", "dk", "dv", "dbias"), t, j):
        assert a.shape == r.shape, name
        assert np.isfinite(a).all(), name
        if name == "dbias" and bias == "key1" and dtype == "bfloat16":
            noise = _key1_noise_bound(inputs, causal)
            assert (np.abs(a) <= noise).all() and (np.abs(r) <= noise).all()
            continue
        tol = 1e-5 if dtype == "float32" else 2e-2 * max(1.0,
                                                         np.abs(r).max())
        np.testing.assert_allclose(a, r, rtol=0, atol=tol, err_msg=name)


def _key1_noise_bound(inputs, causal):
    """2^-7 * sum |dO * out| per batch row of a (B, 1, 1, 1) bias: the
    bf16 rounding of out inside delta, with a factor 2 of margin."""
    q, k, v, b, g, _ = inputs
    with torch.no_grad():
        out = tfa.flash_attention(
            *(torch.tensor(a).to(torch.bfloat16) for a in (q, k, v)),
            bias=torch.tensor(b), causal=causal).float().numpy()
    g16 = torch.tensor(g).to(torch.bfloat16).float().numpy()
    return 2.0 ** -7 * np.abs(g16 * out).sum(axis=(1, 2, 3)).reshape(
        B, 1, 1, 1)


@pytest.mark.parametrize("d", [64, 128])
def test_bf16_plain_backward_walks_the_kernel_tiles(d, monkeypatch):
    """At the bf16 kernels' head dims the plain loops walk the tiles of
    BWD_TILES (what the kernels' library reports) and still hold the
    Pallas kernels, causal with the padding bias."""
    inputs = _inputs(11 + d, 256, 256, "pad", d)
    walked = set()
    tile = tfa._PlainBackward.tile

    def spy(self, q0, k0, tq, tk):
        walked.add((tq, tk))
        return tile(self, q0, k0, tq, tk)

    monkeypatch.setattr(tfa._PlainBackward, "tile", spy)
    j = _jax_grads(*inputs, "bfloat16", "pad", True, False)
    t = _torch_grads(*inputs, "bfloat16", "pad", True, False)
    assert walked == set(tfa.BWD_TILES[(True, d)])
    for name, a, r in zip(("dq", "dk", "dv"), t, j):
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, r, rtol=0,
                                   atol=2e-2 * max(1.0, np.abs(r).max()),
                                   err_msg=name)


def _dense_backward_f64(q, k, v, b, g, g_lse, out, lse, scale, tiles):
    """dq, dk, dv, dbias of the backward's formulas in f64 numpy, causal
    with s_q > s_k: in a (q tile, key tile) pair that holds a live (q, k)
    a fully masked row's p is exp(-1e30 - lse) = 1, elsewhere 0; dq takes
    the pairs of tiles[0], dk/dv/dbias those of tiles[1]."""
    q, k, v, b, g, out = (x.astype(np.float64) for x in (q, k, v, b, g, out))
    lse = lse.astype(np.float64)[..., None]
    s_q, s_k = q.shape[2], k.shape[2]
    off = s_k - s_q
    s = q @ k.swapaxes(-1, -2) * scale + b
    qi, kj = np.arange(s_q)[:, None], np.arange(s_k)[None, :]
    masked = qi + off < kj
    delta = (g * out).sum(-1, keepdims=True) - g_lse.astype(np.float64)[
        ..., None]
    dp = g @ v.swapaxes(-1, -2)
    neg = float(np.float32(-1e30))

    def p_of(tq, tk):
        live = qi // tq * tq + tq - 1 + off >= kj // tk * tk
        with np.errstate(over="ignore"):
            p = np.exp(np.where(masked, 0.0, s - lse))
        return np.where(masked, np.where(live, np.exp(neg - lse), 0.0), p)

    p = p_of(*tiles[0])
    dq = (p * (dp - delta)) @ k * scale
    p = p_of(*tiles[1])
    ds = p * (dp - delta)
    return (dq, ds.swapaxes(-1, -2) @ q * scale, p.swapaxes(-1, -2) @ g,
            ds.sum(-2))


@pytest.mark.parametrize("d", [64, 128])
def test_fully_masked_rows_follow_the_kernel_tiles(d):
    """Causal with s_q > s_k: the first s_q - s_k rows see no key (lse is
    -1e30). The plain loops, and the dense f64 evaluation chip_smoke.py
    holds the kernels against, skip the pairs of the tiles of BWD_TILES (f32
    at head dim 128 has different dq and dk/dv tiles) and match an f64
    evaluation with liveness from the same tiles. With sequence lengths that
    are multiples of 64 and tiles that divide 64, a row that sees no key
    lies in no live pair, so its p is 0 on every key and its dq is 0."""
    q, k, v, b, g, g_lse = _inputs(20 + d, 256, 128, "head", d)
    scale = d ** -0.5
    ts = [torch.tensor(x) for x in (q, k, v, b, g, g_lse)]
    out, lse = tfa._flash_forward_plain(*ts[:4], scale, True)
    assert (lse[:, :, :128] == -1e30).all() and (lse[:, :, 128:] > -1e29).all()
    args = (*ts[:4], out, lse, ts[4], scale, True, ts[5], True)
    tiles = tfa.BWD_TILES[(False, d)]
    want = _dense_backward_f64(q, k, v, b, g, g_lse, out.numpy(),
                               lse.numpy(), scale, tiles)
    assert (want[0][:, :, :128] == 0).all()  # no live pair: no dq
    for got in (tfa._flash_backward_plain(*args),
                tfa._flash_backward_dense(*args)):
        # f32 against f64: 1e-5 of the largest element (dbias, a sum over
        # 256 queries, reaches 23; dq/dk/dv stay below 7)
        for name, a, r in zip(("dq", "dk", "dv", "dbias"), got, want):
            np.testing.assert_allclose(a.double().numpy(), r, rtol=0,
                                       atol=1e-5 * max(1.0, np.abs(r).max()),
                                       err_msg=name)


def test_no_autograd_record_without_grad():
    """Serving (no_grad / inference_mode) and inputs that need no gradient
    go through the same autograd Function, which then saves nothing and
    records nothing."""
    q = torch.randn(1, 2, 64, 64, requires_grad=True)
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        with torch.no_grad():
            assert tfa.flash_attention(q, q, q).grad_fn is None
        with torch.inference_mode():
            assert tfa.flash_attention(q, q, q).grad_fn is None
        assert tfa.flash_attention(q.detach(), q.detach(), q.detach()
                                   ).grad_fn is None
        assert saved == []
        out, lse = tfa.flash_attention_with_lse(q, q, q)
    assert out.grad_fn is not None and lse.grad_fn is not None
    assert len(saved) > 0


def test_unused_output_and_bias_grad_only_when_asked(monkeypatch):
    """Only lse used: out's cotangent is zeros; dbias is computed only
    when the bias requires a gradient."""
    q, k, v, b, _, g_lse = _inputs(4, 128, 128, "head")
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    _, lse = tfa.flash_attention_with_lse(qt, kt, vt)
    dq, = torch.autograd.grad(lse, [qt], torch.tensor(g_lse))
    assert torch.isfinite(dq).all()
    seen = []
    plain = tfa._flash_backward_plain

    def spy(*a, **kw):
        seen.append(kw["need_dbias"] if "need_dbias" in kw else a[10])
        return plain(*a, **kw)

    monkeypatch.setattr(tfa, "_flash_backward_plain", spy)
    bt = torch.tensor(b)
    out = tfa.flash_attention(qt, kt, vt, bias=bt)
    torch.autograd.grad(out.sum(), [qt])
    bt.requires_grad_()
    out = tfa.flash_attention(qt, kt, vt, bias=bt)
    db, = torch.autograd.grad(out.sum(), [bt])
    assert seen == [False, True] and db.shape == bt.shape


@pytest.mark.parametrize("case", ["head_dim", "bias_query_dim"])
def test_envelope_still_raises_with_grad(case):
    d = 320 if case == "head_dim" else D
    q = torch.zeros(B, N, 128, d, requires_grad=True)
    bias = torch.zeros(B, 1, 128, 128) if case == "bias_query_dim" else None
    with pytest.raises(NotImplementedError):
        tfa.flash_attention(q, q, q, bias=bias)


def test_prob_dropout_takes_reference_path(monkeypatch):
    """Attention-probability dropout forces the reference path even with
    use_flash=True (the kernels have no prob-dropout), drawing its mask
    from the caller's generator."""
    q, k, v, b, _, _ = (torch.tensor(a) if a is not None else None
                        for a in _inputs(5, 128, 128, "pad"))
    calls = []
    monkeypatch.setattr(tfa, "_flash_forward_plain",
                        lambda *a: calls.append(1))
    out = tatt.scaled_dot_product_attention(
        q, k, v, bias=b, use_flash=True, dropout_rate=0.25,
        dropout_generator=torch.Generator().manual_seed(7))
    assert not calls
    ref = tatt._reference_attention(
        q, k, v, b, False, D ** -0.5, 0.25,
        torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    plain = tatt._reference_attention(q, k, v, b, False, D ** -0.5)
    assert not np.array_equal(out.numpy(), plain.numpy())
