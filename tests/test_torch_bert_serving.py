"""BERT serving through both packages' InferenceModel on carried weights.

A small BERTClassifierNet (vocab 50, hidden 32, 2 blocks, 2 heads, seq 128,
intermediate 64) is served by the JAX package's ``InferenceModel.do_predict``
and by the port's, with the JAX weights carried over by
``interop.load_jax_params`` and padding masks in the requests. Routes: the
default ones (reference attention on both sides, on the CPU), and the JAX
Pallas forward kernel (interpret mode) against the port's plain kernel
version.

Tolerances: f32 1e-5 absolute on class probabilities. bf16 2e-2: the two
frameworks round to bf16 at different places (XLA fuses elementwise chains
and keeps f32 inside a fusion; eager PyTorch rounds after every op), which
moves bf16 hidden states by about one ulp (2^-8 relative) per op, and the
probabilities by up to about a percent after two blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu.ops.attention as jax_attention
from analytics_zoo_tpu.inference.inference_model import (
    InferenceModel as JaxInferenceModel,
)
from analytics_zoo_tpu.keras.layers import TransformerLayer as JaxTransformer
from analytics_zoo_tpu.tfpark.bert import BERTClassifierNet as JaxBERT
import analytics_zoo_tpu_torch as port
import analytics_zoo_tpu_torch.ops.attention as port_attention
from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.interop import load_jax_params
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts
from analytics_zoo_tpu_torch.keras.layers import TransformerLayer
from analytics_zoo_tpu_torch.tfpark.bert import BERTClassifierNet

CFG = dict(vocab=50, hidden_size=32, n_block=2, n_head=2, seq_len=128,
           intermediate_size=64, hidden_drop=0.0, attn_drop=0.0)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True)
def _port_context():
    port.init_nncontext(device="cpu")
    yield
    port.stop_nncontext()
    reset_name_counts()


def _perturb(tree, seed):
    """Numpy copy of a JAX param tree with every leaf moved off its init
    (non-zero biases, LayerNorm gammas away from 1)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0.0, 0.05, a.shape)
                   ).astype(np.float32), tree)


def _requests(seed, batch=4, seq=128, vocab=50):
    rng = np.random.default_rng(seed)
    lens = np.array([seq, 90, 64, 3])[:batch]
    mask = (np.arange(seq)[None, :] < lens[:, None]).astype(np.float32)
    ids = (rng.integers(1, vocab, (batch, seq)) * mask).astype(np.int32)
    types = (np.arange(seq)[None, :] >= lens[:, None] // 2).astype(np.int32)
    return [ids, types, mask]


def _serve_both(dtype, seed=0, num_classes=3):
    jnet = JaxBERT(num_classes=num_classes, **CFG)
    jim = JaxInferenceModel().do_load_keras(jnet)
    params = _perturb(jim.params, seed)
    jim.params = jax.tree_util.tree_map(jnp.asarray, params)
    net = BERTClassifierNet(num_classes=num_classes, **CFG)
    load_jax_params(net, params)
    if dtype == "float32":
        jnet.compute_dtype = net.compute_dtype = None
    im = InferenceModel().do_load_keras(net)
    out = []
    for i in range(2):
        x = _requests(seed + 10 + i)
        out.append((np.asarray(jim.do_predict(x)), im.do_predict(x)))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["default", "kernel"])
def test_bert_classifier_serving_parity(monkeypatch, dtype, route):
    if route == "kernel":
        # JAX: the forward Pallas kernel in interpret mode; port: the plain
        # version of its CUDA kernel
        monkeypatch.setattr(jax_attention, "_auto_use_flash",
                            lambda q, k: True)
        monkeypatch.setattr(port_attention, "_auto_use_flash",
                            lambda q, k: True)
    for j, t in _serve_both(dtype):
        assert t.shape == j.shape == (4, 3) and t.dtype == np.float32
        assert np.isfinite(t).all()
        np.testing.assert_allclose(t.sum(-1), 1.0, rtol=0, atol=1e-5)
        np.testing.assert_allclose(t, j, rtol=0, atol=TOL[dtype])


def test_dispatch_fetch_and_warmup_match_predict():
    net = BERTClassifierNet(num_classes=2, **CFG)
    net.compute_dtype = None
    im = InferenceModel().do_load_keras(net)  # params from the context
    x = _requests(1)
    im.do_optimize(x)
    assert im._shape_key(x) in im._warmed
    np.testing.assert_array_equal(im.do_fetch(im.do_dispatch(x)),
                                  im.do_predict(x))
    # the caller's buffers are copied: overwriting them after dispatch
    # does not change the answer
    pending = im.do_dispatch(x)
    expected = im.do_predict(_requests(1))
    for a in x:
        a[...] = 0
    np.testing.assert_array_equal(im.do_fetch(pending), expected)
    im.release()
    assert not im._warmed
    with pytest.raises(RuntimeError, match="No model loaded"):
        im.do_predict(x)


@pytest.mark.parametrize("route", ["default", "kernel"])
def test_causal_transformer_layer_parity(monkeypatch, route):
    if route == "kernel":
        monkeypatch.setattr(jax_attention, "_auto_use_flash",
                            lambda q, k: True)
        monkeypatch.setattr(port_attention, "_auto_use_flash",
                            lambda q, k: True)
    kw = dict(vocab=50, seq_len=128, n_block=2, hidden_size=32, n_head=2,
              embedding_drop=0.0, hidden_drop=0.0, attn_drop=0.0)
    jl = JaxTransformer(**kw)
    jl.ensure_built((None, 128))
    params = _perturb(jl.init_params(jax.random.PRNGKey(3)), 3)
    tl = TransformerLayer(**kw)
    tl.ensure_built((None, 128))
    tparams = load_jax_params(tl, params)
    ids, _, mask = _requests(4)
    j = jl.call(jax.tree_util.tree_map(jnp.asarray, params),
                [jnp.asarray(ids), jnp.asarray(mask)])
    with torch.inference_mode():
        t = tl.call(tparams, [torch.tensor(ids), torch.tensor(mask)])
    assert t.shape == (4, 128, 32)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ["cross_causal", "keras_mask_mode"])
def test_multi_head_attention_parity(monkeypatch, case):
    """The MHA forms BERT does not use: cross-attention (query 128 over
    256 keys, causal) on the kernel route, and the tf.keras query-and-key
    mask, whose (B,1,S,S) bias is outside the kernel's envelope and falls
    back to the reference on both sides."""
    from analytics_zoo_tpu.keras.layers.attention import (
        MultiHeadAttention as JaxMHA,
    )
    from analytics_zoo_tpu_torch.keras.layers import MultiHeadAttention

    monkeypatch.setattr(jax_attention, "_auto_use_flash", lambda q, k: True)
    monkeypatch.setattr(port_attention, "_auto_use_flash", lambda q, k: True)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 128, 32)).astype(np.float32)
    if case == "cross_causal":
        kv = rng.standard_normal((2, 256, 24)).astype(np.float32)
        shape = [(None, 128, 32), (None, 256, 24)]
        kw = dict(cross=True, causal=True)
        jx, tx, mask = [x, kv], [torch.tensor(x), torch.tensor(kv)], None
    else:
        shape = (None, 128, 32)
        kw = {}
        mask = (np.arange(128)[None, :] < np.array([[100], [40]])
                ).astype(np.float32)
        jx, tx = x, torch.tensor(x)
    jm, tm = JaxMHA(2, **kw), MultiHeadAttention(2, **kw)
    for m in (jm, tm):
        m.ensure_built(shape)
        m._keras_mask_mode = case == "keras_mask_mode"
    params = _perturb(jm.init_params(jax.random.PRNGKey(5)), 5)
    tparams = load_jax_params(tm, params)
    j = jm.call(jax.tree_util.tree_map(jnp.asarray, params), jx,
                mask=None if mask is None else jnp.asarray(mask))
    t = tm.call(tparams, tx,
                mask=None if mask is None else torch.tensor(mask))
    assert t.shape == (2, 128, 32)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-5)


def _small_tree(n_block=2):
    cfg = dict(CFG, n_block=n_block)
    jnet = JaxBERT(num_classes=2, **cfg)
    params = _perturb(jnet.init(jax.random.PRNGKey(0))[0], 7)
    return params, BERTClassifierNet(num_classes=2, **cfg)


def test_load_jax_params_maps_blocks_by_structure():
    """Eleven blocks: jax's tree utilities return keys sorted as strings
    (block10 before block2); the map still pairs block i with block i, and
    the two packages' layer-name counters need not agree."""
    BERTClassifierNet(num_classes=2, **CFG)  # shift the port's counters
    params, net = _small_tree(n_block=11)
    load_jax_params(net, params)
    (jbert,) = [v for k, v in params.items() if k.endswith("_bert")]
    for i, blk in enumerate(net.bert.blocks):
        (jblk,) = [v for k, v in jbert.items()
                   if k.endswith(f"_block{i}")]
        for leaf, val in jblk.items():
            np.testing.assert_array_equal(
                net.params[net.bert.name][blk.name][leaf].numpy(), val)


@pytest.mark.parametrize("fault,match", [
    ("missing", "missing leaf"),
    ("extra", "extra leaf"),
    ("shape", "shape mismatch"),
])
def test_load_jax_params_rejects_mismatches(fault, match):
    params, net = _small_tree()
    (jbert,) = [v for k, v in params.items() if k.endswith("_bert")]
    jblk = next(v for v in jbert.values() if isinstance(v, dict))
    if fault == "missing":
        del jblk["ln1_gamma"]
    elif fault == "extra":
        jblk["ln3_gamma"] = np.ones(32, np.float32)
    else:
        jblk["ffn_in_kernel"] = np.zeros((32, 65), np.float32)
    with pytest.raises(ValueError, match=match):
        load_jax_params(net, params)
    assert net.params is None
