"""``remat`` on the port's ``BERT`` and ``TransformerLayer``: each block's
activations are recomputed in the backward pass (``torch.utils.checkpoint``)
with its dropout draws replayed from the step generator's saved state.

- Against ``remat=False`` in the port: loss, every gradient and the
  generator's state after the backward are bitwise equal, with dropout off
  and on (the masks come from one explicit generator, which
  ``torch.utils.checkpoint`` does not save by itself).
- A 3-step ``Estimator.train`` trajectory of a small BERT classifier: the
  losses, the parameters after each step and the step generator's state are
  bitwise equal with and without remat.
- Against the JAX package's remat (``jax.checkpoint`` per block) on the
  same weights, dropout off: the loss and every gradient within
  ``tests/test_attention.py``'s 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch as port
from analytics_zoo_tpu.keras.engine.base import reset_name_counts as jreset
from analytics_zoo_tpu.keras.layers import attention as jatt
from analytics_zoo_tpu_torch.common.tree import tree_leaves, tree_unflatten
from analytics_zoo_tpu_torch.data.feature_set import ArrayFeatureSet
from analytics_zoo_tpu_torch.engine.estimator import Estimator
from analytics_zoo_tpu_torch.engine.triggers import MaxIteration
from analytics_zoo_tpu_torch.interop import load_jax_params
from analytics_zoo_tpu_torch.keras import objectives
from analytics_zoo_tpu_torch.keras.engine.base import (
    materialize,
    reset_name_counts,
)
from analytics_zoo_tpu_torch.keras.layers import attention as tatt
from analytics_zoo_tpu_torch.keras.optimizers import SGD
from analytics_zoo_tpu_torch.tfpark.bert import BERTClassifierNet

S, B = 8, 2
JAX_TOL = 1e-5  # tests/test_attention.py:115's remat bound


@pytest.fixture(autouse=True)
def _ctx():
    port.init_nncontext(device="cpu")
    yield
    port.stop_nncontext()
    reset_name_counts()


def _bert(mod, remat, drop, attn_drop=0.0):
    return mod.BERT(vocab=50, hidden_size=16, n_block=2, n_head=2,
                    seq_len=S, intermediate_size=32, hidden_drop=drop,
                    attn_drop=attn_drop, remat=remat, name="bert_r")


def _gpt(mod, remat, drop, attn_drop=0.0):
    return mod.TransformerLayer(vocab=40, seq_len=S, n_block=2,
                                hidden_size=16, n_head=2,
                                embedding_drop=drop, hidden_drop=drop,
                                attn_drop=attn_drop, remat=remat,
                                name="gpt_r")


def _inputs(kind):
    ids = np.arange(B * S).reshape(B, S) % 40
    if kind == "gpt":
        return ids
    mask = np.ones((B, S), np.float32)
    mask[1, 6:] = 0
    return [ids, np.zeros((B, S), np.int64), np.tile(np.arange(S), (B, 1)),
            mask]


def _built(kind, mod, remat, drop, attn_drop=0.0):
    if kind == "bert":
        layer = _bert(mod, remat, drop, attn_drop)
        layer.ensure_built([(None, S)] * 4)
    else:
        layer = _gpt(mod, remat, drop, attn_drop)
        layer.ensure_built((None, S))
    return layer


def _weight():
    return np.random.default_rng(7).normal(0, 0.1, (B, S, 16)).astype(
        np.float32)


def _port_loss_and_grads(layer, params, x, seed):
    gen = torch.Generator().manual_seed(seed)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in tree_leaves(params)]
    xs = ([torch.tensor(a) for a in x] if isinstance(x, list)
          else torch.tensor(x))
    out = layer.call(tree_unflatten(params, leaves), xs, training=True,
                     rng=gen)
    loss = (out * torch.tensor(_weight())).sum()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    return loss.detach(), grads, gen.get_state()


@pytest.mark.parametrize("kind", ["bert", "gpt"])
@pytest.mark.parametrize("drop,attn_drop", [(0.0, 0.0), (0.2, 0.0),
                                            (0.2, 0.2)],
                         ids=["no-dropout", "hidden-dropout", "all-dropout"])
def test_remat_is_bitwise_the_saved_activation_path(kind, drop, attn_drop):
    """Loss, gradients and the generator's state after the backward equal
    remat=False's bit for bit, dropout off and on."""
    plain = _built(kind, tatt, False, drop, attn_drop)
    reset_name_counts()
    remat = _built(kind, tatt, True, drop, attn_drop)
    params = materialize(plain.param_specs(),
                         torch.Generator().manual_seed(0))
    x = _inputs(kind)
    l0, g0, s0 = _port_loss_and_grads(plain, params, x, seed=3)
    l1, g1, s1 = _port_loss_and_grads(remat, params, x, seed=3)
    assert torch.equal(l0, l1)
    assert len(g0) == len(g1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
    assert torch.equal(s0, s1)
    if drop:
        # the masks were drawn: another seed gives another loss
        assert not torch.equal(l0, _port_loss_and_grads(remat, params, x,
                                                        seed=4)[0])


def test_remat_generator_after_backward_is_where_the_forward_left_it():
    """The recompute replays the block's draws and puts the generator back:
    the draw after the backward is the one after the forward."""
    layer = _built("bert", tatt, True, 0.3)
    params = materialize(layer.param_specs(),
                         torch.Generator().manual_seed(1))
    leaves = [t.detach().clone().requires_grad_(True)
              for t in tree_leaves(params)]
    gen = torch.Generator().manual_seed(5)
    xs = [torch.tensor(a) for a in _inputs("bert")]
    out = layer.call(tree_unflatten(params, leaves), xs, training=True,
                     rng=gen)
    after_forward = gen.get_state()
    out.sum().backward()
    assert torch.equal(gen.get_state(), after_forward)


CLS = dict(vocab=64, hidden_size=32, n_block=2, n_head=2, seq_len=16,
           intermediate_size=64)


def _trajectory(remat, hidden_drop, attn_drop):
    """Three Estimator.train steps, one call each: per-step losses, the
    parameters and the step generator's state after each step."""
    port.stop_nncontext()
    ctx = port.init_nncontext(device="cpu", seed=11)
    reset_name_counts()
    net = BERTClassifierNet(num_classes=2, hidden_drop=hidden_drop,
                            attn_drop=attn_drop, remat=remat, **CLS)
    net.compute_dtype = None
    net.params, net.model_state = net.init(torch.Generator().manual_seed(2))
    rng = np.random.default_rng(4)
    ids = rng.integers(1, 64, (24, 16)).astype(np.int64)
    mask = np.ones((24, 16), np.float32)
    mask[::3, 12:] = 0
    x = [ids, np.zeros_like(ids), mask]
    y = rng.integers(0, 2, 24).astype(np.int64)
    est = Estimator(net, SGD(lr=0.05, momentum=0.9))
    out = []
    for step in (1, 2, 3):
        est.train(ArrayFeatureSet(x, y),
                  objectives.sparse_categorical_crossentropy,
                  end_trigger=MaxIteration(step), batch_size=8)
        out.append(([t.clone() for t in tree_leaves(est.tstate.params)],
                    ctx.step_generator.get_state()))
    return list(est.train_losses), out


@pytest.mark.parametrize("hidden_drop,attn_drop", [(0.0, 0.0), (0.1, 0.0),
                                                   (0.1, 0.1)])
def test_three_step_trajectory_is_bitwise(hidden_drop, attn_drop):
    l0, t0 = _trajectory(False, hidden_drop, attn_drop)
    l1, t1 = _trajectory(True, hidden_drop, attn_drop)
    assert len(l0) == 3 and l0 == l1
    for (p0, s0), (p1, s1) in zip(t0, t1):
        assert torch.equal(s0, s1)
        for a, b in zip(p0, p1, strict=True):
            assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["bert", "gpt"])
def test_remat_matches_jax_remat(kind):
    """The port's remat against the JAX package's on the same weights
    (dropout off): loss and gradients within 1e-5."""
    jreset()
    jl = _built(kind, jatt, True, 0.0)
    jparams = jl.init_params(jax.random.PRNGKey(0))
    x = _inputs(kind)
    jx = [jnp.asarray(a) for a in x] if isinstance(x, list) \
        else jnp.asarray(x)
    w = jnp.asarray(_weight())

    def loss(p):
        return jnp.sum(jl.call(p, jx, training=True, rng=None) * w)

    jloss, jgrads = jax.value_and_grad(loss)(jparams)
    tl = _built(kind, tatt, True, 0.0)
    params = load_jax_params(tl, jax.tree_util.tree_map(np.asarray, jparams))
    l, grads, _ = _port_loss_and_grads(tl, params, x, seed=0)
    assert abs(float(l) - float(jloss)) <= JAX_TOL * max(1.0, abs(float(l)))
    want = tree_leaves(load_jax_params(
        _built(kind, tatt, True, 0.0),
        jax.tree_util.tree_map(np.asarray, jgrads)))
    assert len(want) == len(grads)
    for a, b in zip(grads, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=JAX_TOL)
