"""``ConvLSTM2D`` and ``ConvLSTM3D`` in the port against the JAX package,
and the conv_lstm next-frame model (``chip_smoke.build_conv_lstm``, built
in both packages) shrunk to 2 layers of 8 filters over 5 frames of 12x12
through a 3-step trajectory.

The layers: forward, the input gradient and the gradients of ``W``, ``U``
and ``b`` against ``jax.vjp``, with and without ``return_sequences``,
``go_backwards``, and an even kernel (SAME padding 0 before and 1 after, as
XLA pads). The default inner activation is Keras's ``hard_sigmoid``,
``clip(0.2 x + 0.5, 0, 1)``, not ``F.hardsigmoid`` (``x / 6 + 1 / 2``):
held here. The port hoists the input convolution out of the time loop
(one convolution over batch x time); the values are the per-step ones.

Tolerance: f32, ``1e-5`` on values and gradients (sums of at most 3 * 3 *
3 * 12 products per step through 5 steps, in another order; the
trajectory's losses and weights 1e-5, through batch norm at batch 8).
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import analytics_zoo_tpu.keras.layers as jl
from analytics_zoo_tpu.keras.engine import base as jbase
from analytics_zoo_tpu.keras.engine import topology as jtopo
from analytics_zoo_tpu.keras.layers.core import get_activation as jact
from analytics_zoo_tpu.keras.optimizers import Adadelta as JAdadelta
import analytics_zoo_tpu_torch as port
import analytics_zoo_tpu_torch.keras.layers as tl
import chip_smoke as cs
from analytics_zoo_tpu_torch.interop import load_jax_params
from analytics_zoo_tpu_torch.keras.engine import topology as ttopo
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts
from analytics_zoo_tpu_torch.keras.optimizers import Adadelta

TOL = 1e-5


@pytest.fixture(autouse=True)
def _port_context():
    port.init_nncontext(device="cpu")
    yield
    port.stop_nncontext()
    reset_name_counts()


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                               np.asarray(b, dtype=np.float64), rtol=tol,
                               atol=tol)


CASES = {
    "2d-seq": (lambda L: L.ConvLSTM2D(4, 3, return_sequences=True),
               (5, 2, 6, 7)),
    "2d-backwards": (lambda L: L.ConvLSTM2D(
        3, 3, return_sequences=True, go_backwards=True), (4, 2, 5, 6)),
    "2d-even-kernel": (lambda L: L.ConvLSTM2D(3, 2, return_sequences=True),
                       (3, 2, 5, 5)),
    "2d-last-sigmoid-relu": (lambda L: L.ConvLSTM2D(
        3, 3, activation="relu", inner_activation="sigmoid"), (4, 3, 5, 5)),
    "3d-seq": (lambda L: L.ConvLSTM3D(3, 3, return_sequences=True),
               (3, 2, 4, 4, 4)),
    "3d-last-backwards": (lambda L: L.ConvLSTM3D(2, 3, go_backwards=True),
                          (4, 1, 3, 4, 5)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_conv_lstm_layer_matches_jax(case):
    make, shape = CASES[case]
    jlayer, tlayer = make(jl), make(tl)
    jlayer.ensure_built((None,) + shape)
    tlayer.ensure_built((None,) + shape)
    assert tlayer.output_shape == jlayer.output_shape
    rng = np.random.default_rng(0)
    jp = {s.name: rng.normal(0, 0.3, s.shape).astype(np.float32)
          for s in jlayer.weight_specs}
    tp = {k: v.requires_grad_(True)
          for k, v in load_jax_params(tlayer, jp).items()}
    x = rng.standard_normal((2,) + shape).astype(np.float32)
    out_shape = jax.eval_shape(jlayer.call, jp, x).shape
    cot = rng.standard_normal(out_shape).astype(np.float32)

    @jax.jit
    def fwd_bwd(p, xx):
        out, vjp = jax.vjp(jlayer.call, p, xx)
        return out, vjp(cot)

    jout, (jgp, jgx) = fwd_bwd(jp, x)
    tx = torch.tensor(x, requires_grad=True)
    tout = tlayer.call(tp, tx)
    assert tuple(tout.shape) == jout.shape
    assert tuple(tout.shape[1:]) == tuple(tlayer.output_shape[1:])
    _close(tout.detach(), jout)
    (tout * torch.tensor(cot)).sum().backward()
    _close(tx.grad, jgx)
    for k in jp:
        _close(tp[k].grad, jgp[k])


def test_hard_sigmoid_is_keras_not_torch():
    x = torch.linspace(-4, 4, 41)
    got = tl.get_activation("hard_sigmoid")(x)
    _close(got, jact("hard_sigmoid")(x.numpy()))
    assert (got - F.hardsigmoid(x)).abs().max() > 0.05  # 0.08 at x = 2.5
    assert tl.ConvLSTM2D(2, 3).inner_activation(x).equal(got)


def test_conv_lstm_rejects_what_bigdl_does():
    for kw in ({"border_mode": "valid"}, {"subsample": 2}):
        with pytest.raises(NotImplementedError):
            tl.ConvLSTM2D(2, 3, **kw)
        with pytest.raises(NotImplementedError):
            jl.ConvLSTM2D(2, 3, **kw)


def _model(L, topo):
    return cs.build_conv_lstm(L, topo.Sequential, filters=8, n_layers=2,
                              frames=5, side=12)


def test_next_frame_model_trajectory_matches_jax(tmp_path):
    jbase.reset_name_counts()
    reset_name_counts()
    jnet, tnet = _model(jl, jtopo), _model(tl, ttopo)
    assert [type(l).__name__ for l in tnet.layers()] == [
        type(l).__name__ for l in jnet.layers()]
    assert tnet.get_output_shape() == jnet.get_output_shape() == (
        None, 5, 1, 12, 12)
    est = jnet._get_estimator()
    est._ensure_state()
    load_jax_params(tnet, jax.tree_util.tree_map(np.asarray,
                                                 est.tstate.params))
    rng = np.random.default_rng(1)
    x = (rng.random((24, 5, 1, 12, 12)) < 0.2).astype(np.float32)
    y = np.roll(x, -1, axis=1)
    jnet.compile(optimizer=JAdadelta(), loss="binary_crossentropy")
    tnet.compile(optimizer=Adadelta(), loss="binary_crossentropy")
    jnet.set_tensorboard(str(tmp_path), "jax")
    jnet.fit(x, y, batch_size=8, nb_epoch=1)
    tnet.fit(x, y, batch_size=8, nb_epoch=1)
    want = [v for _, v in jnet.get_train_summary("Loss")]
    assert len(want) == 3
    _close(tnet._estimator.train_losses, want)
    tw, jw = tnet.get_weights(), jnet.get_weights()
    for layer, leaves in jw.items():
        for k, v in leaves.items():
            _close(tw[layer][k], v)
    # the moving statistics of both batch norms moved alike
    jstate = jax.tree_util.tree_map(np.asarray,
                                    jnet._estimator.tstate.model_state)
    tstate = tnet._estimator.tstate.model_state
    for layer, stats in jstate.items():
        for k, v in stats.items():
            _close(tstate[layer][k], v)


def test_movies_follow_the_keras_example():
    """generate_movies: squares of side 4 or 6 moving a pixel a frame; the
    target is the input one frame on."""
    x, y = cs.generate_movies(np.random.default_rng(0), 6, frames=7)
    assert x.shape == y.shape == (6, 7, 1, 40, 40)
    assert x.dtype == np.float32 and x.max() <= 1  # rings may go below 0
    # the squares, without the +-0.1 noise rings
    lit = (x > 0.5).astype(np.float32)
    np.testing.assert_array_equal(lit[:, 1:], y[:, :-1])
    assert set(np.unique(y)) == {0.0, 1.0}
