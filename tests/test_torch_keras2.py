"""The port's ``keras2`` API and initializers against the JAX package.

The cases of ``tests/test_keras2.py``, pointed at the port and held
against the JAX package on the same weights (``load_jax_params``) and
inputs: the Keras-2 argument surface (``units``/``filters``/``padding``/
``data_format``/``kernel_initializer``) over the Keras-1 bodies,
channels-last ``Conv2D`` and pools, the merge layers and their functions,
``LocallyConnected1D`` and ``Reshape``, and a keras2 ``Sequential``
trained end to end (its 3 first steps equal to JAX's, then to the JAX
test's accuracy). Then every initializer name, Keras-1's and Keras-2's:
JAX's ``jax.random`` draws cannot be reproduced, so each is held by
shape, bounds and moments against a JAX draw of the same shape, and by
the exact properties (``orthogonal``, ``identity``, ``constant``,
``truncated_normal``'s 2-sigma cut, ``variance_scaling``'s modes).

Tolerance: forward values ``1e-5`` (f32 sums in another order); the
trajectory ``1e-5`` on losses and weights; moments as stated below.
"""

import jax
import numpy as np
import pytest
import torch

import analytics_zoo_tpu.keras2 as jk2
from analytics_zoo_tpu.keras.engine import base as jbase
from analytics_zoo_tpu.keras.optimizers import Adam as JAdam
import analytics_zoo_tpu_torch as port
import analytics_zoo_tpu_torch.keras2 as tk2
from analytics_zoo_tpu_torch.interop import load_jax_params
from analytics_zoo_tpu_torch.keras.engine import base as tbase
from analytics_zoo_tpu_torch.keras.optimizers import Adam

TOL = 1e-5


@pytest.fixture(autouse=True)
def _port_context():
    port.init_nncontext(device="cpu")
    yield
    port.stop_nncontext()
    tbase.reset_name_counts()


def _both(build):
    """``build(keras2)`` in both packages, the JAX weights carried over."""
    jbase.reset_name_counts()
    tbase.reset_name_counts()
    jnet, tnet = build(jk2), build(tk2)
    est = jnet._get_estimator()
    est._ensure_state()
    load_jax_params(tnet, jax.tree_util.tree_map(np.asarray,
                                                 est.tstate.params))
    return jnet, tnet


def _built(build):
    """``build(keras2)`` in both packages with the same normal weights
    (numpy draws in the JAX parameter tree's shapes), as ``(JAX forward,
    port net)``: no JAX estimator is made."""
    jbase.reset_name_counts()
    tbase.reset_name_counts()
    jnet, tnet = build(jk2), build(tk2)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0))[0]
    rng = np.random.default_rng(0)
    jp = jax.tree_util.tree_map(
        lambda a: rng.normal(0, 0.3, a.shape).astype(np.float32), shapes)
    load_jax_params(tnet, jp)
    return jax.jit(lambda x: jnet.apply(jp, {}, x)[0]), tnet


def _same_predictions(jfwd, tnet, x, batch):
    want = np.asarray(jfwd(x))
    got = tnet.predict(x, batch_size=batch)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    return got


def _dense_net(k2, rate=0.1):
    model = k2.Sequential()
    model.add(k2.Dense(16, activation="relu", input_shape=(8,),
                       kernel_initializer="he_normal"))
    model.add(k2.Dropout(rate))
    model.add(k2.Dense(2))
    model.add(k2.Softmax())
    return model


def test_dense_keras2_args_train(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(256, 8)).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.int32)
    # dropout off: the first 3 steps equal to the JAX package's
    jnet, tnet = _both(lambda k2: _dense_net(k2, rate=0.0))
    for net, opt in ((jnet, JAdam), (tnet, Adam)):
        net.compile(optimizer=opt(lr=0.01),
                    loss="sparse_categorical_crossentropy")
    jnet.set_tensorboard(str(tmp_path), "jax")
    jnet.fit(x[:24], y[:24], batch_size=8, nb_epoch=1)
    tnet.fit(x[:24], y[:24], batch_size=8, nb_epoch=1)
    np.testing.assert_allclose(
        tnet._estimator.train_losses,
        [v for _, v in jnet.get_train_summary("Loss")], rtol=0, atol=TOL)
    tw, jw = tnet.get_weights(), jnet.get_weights()
    assert set(tw) == set(jw)
    for layer, leaves in jw.items():
        assert set(tw[layer]) == set(leaves)
        for k, v in leaves.items():
            np.testing.assert_allclose(tw[layer][k], np.asarray(v), rtol=0,
                                       atol=TOL)
    # the JAX test's run, in the port, with its dropout
    model = _dense_net(tk2)
    model.compile(optimizer=Adam(lr=0.01),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    model.fit(x, y, batch_size=64, nb_epoch=30)
    res = model.evaluate(x, y, batch_size=64)
    assert res["accuracy"] > 0.9, res


def test_conv2d_channels_last_shapes():
    def build(k2):
        model = k2.Sequential()
        model.add(k2.Conv2D(4, (3, 3), padding="same", activation="relu",
                            input_shape=(8, 8, 3)))
        model.add(k2.MaxPooling2D((2, 2)))
        model.add(k2.Conv2D(6, 3, strides=2, padding="valid"))
        model.add(k2.GlobalAveragePooling2D())
        model.add(k2.Dense(5))
        return model

    x = np.random.default_rng(1).normal(size=(4, 8, 8, 3)).astype(np.float32)
    out = _same_predictions(*_built(build), x, 4)
    assert out.shape == (4, 5)


def test_global_pool_channels_last_default():
    def build2(k2):
        model = k2.Sequential()
        model.add(k2.GlobalAveragePooling2D(input_shape=(5, 7, 3)))
        return model

    x = np.arange(4 * 5 * 7 * 3, dtype=np.float32).reshape(4, 5, 7, 3)
    out = _same_predictions(*_built(build2), x, 4)
    np.testing.assert_allclose(out, x.mean(axis=(1, 2)), rtol=1e-5)

    def build3(k2):
        model = k2.Sequential()
        model.add(k2.GlobalMaxPooling3D(input_shape=(2, 3, 4, 5)))
        return model

    y = np.random.default_rng(0).normal(size=(2, 2, 3, 4, 5)).astype(
        np.float32)
    out = _same_predictions(*_built(build3), y, 2)
    np.testing.assert_allclose(out, y.max(axis=(1, 2, 3)), rtol=1e-5)


def test_conv1d_pool_crop():
    def build(k2):
        model = k2.Sequential()
        model.add(k2.Conv1D(8, 3, padding="same", input_shape=(16, 4)))
        model.add(k2.Cropping1D((1, 1)))
        model.add(k2.MaxPooling1D(2))
        model.add(k2.AveragePooling1D(2, padding="same"))
        model.add(k2.GlobalMaxPooling1D())
        return model

    x = np.random.default_rng(2).normal(size=(2, 16, 4)).astype(np.float32)
    assert _same_predictions(*_built(build), x, 2).shape == (2, 8)


def _merge_model(k2, fns):
    a = k2.Input(shape=(4,))
    b = k2.Input(shape=(4,))
    return k2.Model([a, b], k2.concatenate([f(k2)([a, b]) for f in fns]))


def test_merge_layers_functional():
    fns = [lambda k2: k2.maximum, lambda k2: k2.minimum,
           lambda k2: k2.average, lambda k2: k2.add, lambda k2: k2.multiply]
    rng = np.random.default_rng(3)
    xa, xb = (rng.normal(size=(2, 4)).astype(np.float32) for _ in "ab")
    pred = _same_predictions(*_built(lambda k2: _merge_model(k2, fns)),
                             [xa, xb], 2)
    want = [np.maximum(xa, xb), np.minimum(xa, xb), (xa + xb) / 2, xa + xb,
            xa * xb]
    np.testing.assert_allclose(pred, np.concatenate(want, axis=1),
                               rtol=1e-6)


def test_merge_layer_classes():
    def build(k2):
        a, b = k2.Input(shape=(3,)), k2.Input(shape=(3,))
        outs = [cls()([a, b]) for cls in (k2.Maximum, k2.Minimum,
                                          k2.Average, k2.Add, k2.Multiply)]
        return k2.Model([a, b], k2.Concatenate(axis=-1)(outs))

    xa = np.ones((2, 3), np.float32)
    pred = _same_predictions(*_built(build), [xa * 2, xa * 3], 2)
    np.testing.assert_allclose(pred, np.concatenate(
        [xa * 3, xa * 2, xa * 2.5, xa * 5, xa * 6], axis=1))


def test_locally_connected_and_reshape():
    def build(k2):
        model = k2.Sequential()
        model.add(k2.LocallyConnected1D(4, 3, input_shape=(10, 2)))
        model.add(k2.Flatten())
        model.add(k2.Reshape((4, 8)))
        model.add(k2.Activation("tanh"))
        return model

    x = np.random.default_rng(4).normal(size=(2, 10, 2)).astype(np.float32)
    assert _same_predictions(*_built(build), x, 2).shape == (2, 4, 8)
    with pytest.raises(ValueError):
        tk2.LocallyConnected1D(4, 3, padding="same")


def test_keras2_dense_with_new_initializers():
    def build(k2):
        m = k2.Sequential()
        m.add(k2.Dense(8, kernel_initializer="truncated_normal",
                       bias_initializer="constant", input_shape=(6,)))
        m.add(k2.Dense(3, kernel_initializer="variance_scaling",
                       activation="softmax"))
        return m

    x = np.random.default_rng(0).normal(size=(16, 6)).astype(np.float32)
    probs = _same_predictions(*_built(build), x, 16)
    np.testing.assert_allclose(probs.sum(1), 1.0, rtol=1e-5)


def test_keras2_exports_equal_the_jax_package():
    assert tk2.__all__ == jk2.__all__
    assert tk2.layers._INIT_MAP == jk2.layers._INIT_MAP


# -- initializers --------------------------------------------------------------

INIT_NAMES = sorted(jbase._INITS)
KERAS2_NAMES = ["random_uniform", "random_normal"]
# the uniform and truncated-normal draws: bounded supports
BOUNDED = {"glorot_uniform", "xavier", "he_uniform", "lecun_uniform",
           "uniform", "random_uniform", "truncated_normal", "lecun_normal",
           "variance_scaling"}
EXACT = {"zero", "zeros", "one", "ones", "constant", "identity"}
SHAPE = (3, 3, 64, 96)


def _shape(name):
    return (40, 30) if name == "identity" else SHAPE


@pytest.fixture(scope="module")
def jax_draws():
    """Every initializer's JAX draw, in one compiled function."""
    names = INIT_NAMES + KERAS2_NAMES

    @jax.jit
    def draw(key):
        return {n: jbase.get_initializer(jk2.layers._init(n))(
            jax.random.fold_in(key, i), _shape(n))
            for i, n in enumerate(names)}

    return jax.tree_util.tree_map(np.asarray, draw(jax.random.PRNGKey(1)))


@pytest.mark.parametrize("name", INIT_NAMES + KERAS2_NAMES)
def test_initializer_matches_jax_in_distribution(name, jax_draws):
    assert set(INIT_NAMES) == set(tbase._INITS)
    got = tbase.get_initializer(tk2.layers._init(name))(
        torch.Generator().manual_seed(1), _shape(name)).numpy()
    want = jax_draws[name]
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    if name in EXACT:
        np.testing.assert_array_equal(got, want)
        return
    if name in BOUNDED:  # both reach near the same ends of the support
        span = want.max() - want.min()
        assert abs(got.max() - want.max()) < 0.02 * span
        assert abs(got.min() - want.min()) < 0.02 * span
    # moments of 55,296 draws: the means within 6 standard errors of the
    # difference, the standard deviations within 2 %
    sd = want.std()
    assert abs(got.mean() - want.mean()) < 6 * sd / np.sqrt(got.size)
    assert abs(got.std() / sd - 1) < 0.02


def test_initializer_exact_properties():
    g = torch.Generator().manual_seed(0)
    q = tbase.get_initializer("orthogonal")(g, (48, 32)).numpy()
    np.testing.assert_allclose(q.T @ q, np.eye(32), atol=2e-5)
    q = tbase.get_initializer("orthogonal")(g, (3, 3, 8, 16)).numpy()
    m = q.reshape(-1, 16)
    np.testing.assert_allclose(m.T @ m, np.eye(16), atol=2e-5)
    np.testing.assert_array_equal(
        tbase.identity_init(2.5)(g, (4, 6)).numpy(), 2.5 * np.eye(4, 6))
    with pytest.raises(ValueError):
        tbase.identity_init()(g, (2, 2, 2))
    np.testing.assert_array_equal(
        tbase.constant_init(0.7)(g, (3, 2)).numpy(),
        np.full((3, 2), 0.7, np.float32))
    tn = tbase.truncated_normal_init(0.05, 1.0)(g, (256, 256)).numpy()
    assert np.abs(tn - 1.0).max() <= 0.1 + 1e-6  # cut at 2 sigma
    assert abs(tn.std() / (0.05 * 0.87962566103423978) - 1) < 0.02
    for scale, mode, dist in [(2.0, "fan_in", "normal"),
                              (1.0, "fan_out", "uniform"),
                              (0.5, "fan_avg", "untruncated_normal"),
                              (3.0, "fan_avg", "truncated_normal")]:
        fan_in, fan_out = 3 * 3 * 64, 3 * 3 * 96
        n = {"fan_in": fan_in, "fan_out": fan_out,
             "fan_avg": (fan_in + fan_out) / 2}[mode]
        got = tbase.variance_scaling_init(scale, mode, dist)(g, SHAPE)
        assert abs(got.std().item() / np.sqrt(scale / n) - 1) < 0.02
    with pytest.raises(ValueError):
        tbase.variance_scaling_init(1.0, "fan_in", "cauchy")(g, (3, 3))
    with pytest.raises(ValueError):
        tbase.get_initializer("he_cauchy")
