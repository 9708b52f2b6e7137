"""Regularizers in the port against the JAX package: the ``l1``/``l2``/
``l1l2`` factories and ``L1``/``L2``/``L1L2`` on the same array, each
layer's ``regularization_loss`` on the same weights (every layer whose
JAX signature takes a ``W_``/``U_``/``b_regularizer``, the keras2
``kernel_``/``bias_regularizer`` and the wrappers), ``KerasNet.
regularization`` of a whole graph, and a 3-step ``fit`` trajectory of a
graph with ``L1L2`` on ``Embedding``, ``LSTM``, ``Convolution2D`` and
``Dense`` (``chip_smoke.regularized_graph``, which phase 10 runs on the
card; JAX weights carried by ``interop.load_jax_params``). JAX's ``abs``
has the derivative 1 at 0, so an L1 penalty moves zero biases from the
first step: the trajectory holds the port to it.

The penalty is taken over the float32 master weights in both packages
(the JAX loss adds ``model.regularization(params)`` on the uncast
parameters), so a bf16 step's penalty is the float32 one: held here too.

Tolerance: penalties ``rtol 1e-6`` (sums of |w| and w^2 over at most
3,456 float32 weights, in another order); the trajectory 1e-5 on losses
and weights, as the other trajectory tests.
"""

import jax
import numpy as np
import pytest
import torch

import analytics_zoo_tpu.keras.layers as jl
import analytics_zoo_tpu.keras2 as jk2
from analytics_zoo_tpu.keras import regularizers as jreg
from analytics_zoo_tpu.keras.engine import base as jbase
from analytics_zoo_tpu.keras.engine import topology as jtopo
from analytics_zoo_tpu.keras.optimizers import SGD as JSGD
import analytics_zoo_tpu_torch as port
import analytics_zoo_tpu_torch.keras.layers as tl
import analytics_zoo_tpu_torch.keras2 as tk2
import chip_smoke as cs
from analytics_zoo_tpu_torch.common.tree import tree_leaves
from analytics_zoo_tpu_torch.interop import load_jax_params
from analytics_zoo_tpu_torch.keras import regularizers as treg
from analytics_zoo_tpu_torch.keras.engine import topology as ttopo
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts
from analytics_zoo_tpu_torch.keras.optimizers import SGD

PEN_TOL = 1e-6
F32_TOL = 1e-5


@pytest.fixture(autouse=True)
def _port_context():
    port.init_nncontext(device="cpu")
    yield
    port.stop_nncontext()
    reset_name_counts()


@pytest.mark.parametrize("name,args", [
    ("l1", (0.03,)), ("l2", (0.02,)), ("l1l2", (0.01, 0.05)),
    ("L1", (0.2,)), ("L2", (0.3,)), ("L1L2", (0.0, 0.0)),
    ("L1L2", (0.4, 0.0))])
def test_regularizer_factories_match_jax(name, args):
    w = np.random.default_rng(0).standard_normal((7, 5)).astype(np.float32)
    got = getattr(treg, name)(*args)(torch.tensor(w))
    want = getattr(jreg, name)(*args)(w)
    np.testing.assert_allclose(float(got), float(want), rtol=PEN_TOL)
    assert treg.__all__ == jreg.__all__


def _regs(L):
    return dict(W_regularizer=L.L1L2(0.01, 0.02),
                b_regularizer=L.L2(0.3))


LAYERS = {
    "dense": (lambda L: L.Dense(6, **_regs(L)), (5,)),
    "conv1d": (lambda L: L.Convolution1D(4, 3, **_regs(L)), (7, 3)),
    "conv2d": (lambda L: L.Convolution2D(4, 3, 3, **_regs(L)), (2, 6, 6)),
    "conv3d": (lambda L: L.Convolution3D(3, 2, 2, 2, **_regs(L)),
               (2, 4, 4, 4)),
    "atrous-conv2d": (lambda L: L.AtrousConvolution2D(
        3, 3, 3, atrous_rate=(2, 2), W_regularizer=L.L1(0.1)), (2, 8, 8)),
    "embedding": (lambda L: L.Embedding(20, 4, W_regularizer=L.L1L2(
        0.1, 0.2)), (3,)),
    "bidirectional-lstm": (lambda L: L.Bidirectional(L.LSTM(
        3, W_regularizer=L.L2(0.1), U_regularizer=L.L1(0.2),
        b_regularizer=L.L1L2(0.3, 0.4))), (4, 5)),
    "time-distributed-dense": (lambda L: L.TimeDistributed(L.Dense(
        3, W_regularizer=L.L1(0.5))), (4, 5)),
    "gru-reset-after": (lambda L: L.GRU(3, reset_after=True,
                                        b_regularizer=L.L2(0.7),
                                        U_regularizer=L.L2(0.2)), (4, 5)),
}
for _cls in ("SimpleRNN", "LSTM", "GRU"):
    for _kind in ("W", "U", "b"):
        LAYERS[f"{_cls.lower()}-{_kind}"] = (
            lambda L, c=_cls, k=_kind: getattr(L, c)(
                3, **{f"{k}_regularizer": L.L1L2(0.05, 0.1)}), (4, 5))


def _params_for(jlayer, rng):
    """Normal weights in the JAX layer's parameter tree."""
    tree = jax.eval_shape(jlayer.init_params, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(
        lambda s: rng.normal(0, 0.5, s.shape).astype(np.float32), tree)


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_regularization_loss_matches_jax(name):
    make, shape = LAYERS[name]
    jlayer, tlayer = make(jl), make(tl)
    jlayer.ensure_built((None,) + shape)
    tlayer.ensure_built((None,) + shape)
    jp = _params_for(jlayer, np.random.default_rng(1))
    tp = load_jax_params(tlayer, jp)
    want = float(jlayer.regularization_loss(jp))
    got = tlayer.regularization_loss(tp)
    assert want > 0
    np.testing.assert_allclose(float(got), want, rtol=PEN_TOL)


@pytest.mark.parametrize("name", ["Dense", "Conv1D", "Conv2D"])
def test_keras2_kernel_and_bias_regularizers_match_jax(name):
    def make(k2):
        reg = dict(kernel_regularizer=k2.layers.k1.L1L2(0.1, 0.2),
                   bias_regularizer=k2.layers.k1.L1(0.3))
        if name == "Dense":
            return k2.Dense(4, **reg), (5,)
        if name == "Conv1D":
            return k2.Conv1D(4, 3, **reg), (6, 2)
        return k2.Conv2D(4, 3, **reg), (5, 5, 2)

    (jlayer, shape), (tlayer, _) = make(jk2), make(tk2)
    jlayer.ensure_built((None,) + shape)
    tlayer.ensure_built((None,) + shape)
    jp = _params_for(jlayer, np.random.default_rng(2))
    np.testing.assert_allclose(
        float(tlayer.regularization_loss(load_jax_params(tlayer, jp))),
        float(jlayer.regularization_loss(jp)), rtol=PEN_TOL)


def _data(n=24, seed=3):
    rng = np.random.default_rng(seed)
    return ([rng.integers(0, 12, (n, 5)).astype(np.int32),
             rng.standard_normal((n, 2, 6, 6)).astype(np.float32)],
            rng.integers(0, 3, n).astype(np.int32))


def _pair():
    jbase.reset_name_counts()
    reset_name_counts()
    jnet, tnet = cs.regularized_graph(jl, jtopo), cs.regularized_graph(tl, ttopo)
    est = jnet._get_estimator()
    est._ensure_state()
    jp = jax.tree_util.tree_map(np.asarray, est.tstate.params)
    load_jax_params(tnet, jp)
    return jnet, tnet, jp


def test_model_regularization_matches_jax_in_f32_and_under_bf16():
    jbase.reset_name_counts()
    reset_name_counts()
    jnet, tnet = cs.regularized_graph(jl, jtopo), cs.regularized_graph(tl, ttopo)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0))[0]
    rng = np.random.default_rng(5)
    jp = jax.tree_util.tree_map(
        lambda a: rng.normal(0, 0.5, a.shape).astype(np.float32), shapes)
    load_jax_params(tnet, jp)
    want = float(jnet.regularization(jp))
    got = tnet.regularization(tnet.params)
    np.testing.assert_allclose(float(got), want, rtol=PEN_TOL)
    # the train step's penalty is the master weights': float32 under bf16
    tnet.compute_dtype = "bfloat16"
    assert tnet.regularization(tnet.params).dtype == torch.float32


def test_three_step_l1l2_trajectory_matches_jax(tmp_path):
    jnet, tnet, _ = _pair()
    x, y = _data()
    jnet.compile(optimizer=JSGD(lr=0.1), loss="sparse_categorical_crossentropy")
    tnet.compile(optimizer=SGD(lr=0.1), loss="sparse_categorical_crossentropy")
    jnet.set_tensorboard(str(tmp_path), "jax")
    jnet.fit(x, y, batch_size=8, nb_epoch=1)
    tnet.fit(x, y, batch_size=8, nb_epoch=1)
    j_losses = [v for _, v in jnet.get_train_summary("Loss")]
    assert len(j_losses) == 3
    np.testing.assert_allclose(tnet._estimator.train_losses, j_losses,
                               rtol=0, atol=F32_TOL)
    jw = jax.tree_util.tree_map(np.asarray, jnet.get_weights())
    want = load_jax_params(cs.regularized_graph(tl, ttopo), jw)
    for a, b in zip(tree_leaves(tnet.get_weights()), tree_leaves(want),
                    strict=True):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0,
                                   atol=F32_TOL)
    # the penalty moved the weights: without it the same steps differ
    _, plain, _ = _pair()
    for layer in plain.layers():
        for spec in layer.weight_specs:
            spec.regularizer = None
    plain.compile(optimizer=SGD(lr=0.1),
                  loss="sparse_categorical_crossentropy")
    plain.fit(x, y, batch_size=8, nb_epoch=1)
    gap = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
              for a, b in zip(tree_leaves(plain.get_weights()),
                              tree_leaves(tnet.get_weights())))
    assert gap > 1e-3
