"""tf.keras -> zoo architecture conversion in the port
(``keras_convert``, ``tfpark.KerasModel`` over a foreign model,
``Net.load_keras``'s architecture forms) against the JAX package, on the
CPU.

The cases of ``tests/test_keras_convert.py``, re-pointed at the port. TF
builds each model here (seeded); both packages convert the same model, and
their converted weights and state must be equal leaf by leaf (the
converter keeps layer names 1:1, so they are matched by name). The port's
outputs are held to the JAX package's within ``JAX_TOL`` of the largest
|value| in float32, and to TF's own within the JAX test's tolerance.

Differences the cases pin (the port follows the JAX package where it and
Keras differ): ``gelu`` is the tanh approximation in both packages and the
exact erf form in Keras (the BERT-shaped encoder is held to TF within
``GELU_TOL``, to JAX within ``JAX_TOL``); Keras 3.13 runs the attention
of a second stacked encoder block with no padding mask, where both
converters mask it (the encoder is held to TF on unpadded rows); a masked Keras
``MultiHeadAttention`` (query AND key masks) runs in the port on the
kernel route with the key-padding bias, each padded query taking the mean
of v over the keys it may see (the uniform softmax of its fully masked
row) with that softmax's gradient, where the JAX package takes the
reference path with a (B,1,S,S) bias; with probability dropout both take
the reference path with that bias.
"""

import json

import numpy as np
import pytest
import torch

import analytics_zoo_tpu as zoo
import analytics_zoo_tpu_torch as port
from analytics_zoo_tpu import keras_convert as jkc
from analytics_zoo_tpu.keras import objectives as jobj
from analytics_zoo_tpu.tfpark import model as jtm
from analytics_zoo_tpu_torch import keras_convert as tkc
from analytics_zoo_tpu_torch.keras import objectives as tobj
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts
from analytics_zoo_tpu_torch.tfpark import model as ttm

tf = pytest.importorskip("tensorflow")
tf.config.set_visible_devices([], "GPU")

JAX_TOL = 1e-5    # port against the JAX package, of the largest |value|
GELU_TOL = 5e-3   # the erf gelu (Keras) against the tanh one (both zoos)
STEP_TOL = 1e-4   # the same, after each of three SGD steps at lr 0.5


@pytest.fixture(autouse=True)
def _ctx():
    zoo.init_nncontext()
    port.init_nncontext(device="cpu")
    yield
    port.stop_nncontext()
    reset_name_counts()


def _tree_equal(a, b, where=""):
    if isinstance(b, dict):
        assert set(a) == set(b), where
        for k in b:
            _tree_equal(a[k], b[k], f"{where}.{k}")
        return
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                  err_msg=where)


def _same_weights(tm, jm):
    """Both converted models' weights and state, leaf by leaf, bitwise."""
    _tree_equal(tm.get_weights(), jm.get_weights())
    tstate = tm._estimator_state().tstate.model_state
    jest = jm._get_estimator()
    jest._ensure_state()
    _tree_equal({k: {n: t.numpy() for n, t in v.items()}
                 for k, v in tstate.items()}, jest.tstate.model_state)


def _close_to_jax(got, want, tol=JAX_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _convert_both(kmodel):
    tm = tkc.convert_keras_model(kmodel)
    jm = jkc.convert_keras_model(kmodel)
    _same_weights(tm, jm)
    return tm, jm


def _assert_parity(kmodel, x, atol=1e-4):
    tm, jm = _convert_both(kmodel)
    n = len(x[0]) if isinstance(x, list) else len(x)
    want = np.asarray(kmodel(x))
    got = np.asarray(tm.predict(x, batch_size=n))
    np.testing.assert_allclose(got, want, atol=atol, rtol=1e-4)
    _close_to_jax(got, np.asarray(jm.predict(x, batch_size=n)))
    return tm


def _seq(*layers):
    return tf.keras.Sequential(list(layers))


L = tf.keras.layers


def test_sequential_mlp_parity():
    tf.keras.utils.set_random_seed(0)
    km = _seq(L.Input((12,)), L.Dense(16, activation="relu"),
              L.Dropout(0.5), L.Dense(8), L.LeakyReLU(negative_slope=0.2),
              L.Dense(3, activation="softmax"))
    x = np.random.RandomState(1).randn(5, 12).astype(np.float32)
    _assert_parity(km, x)


def test_sequential_cnn_parity():
    tf.keras.utils.set_random_seed(1)
    km = _seq(L.Input((16, 16, 3)),
              L.Conv2D(8, 3, strides=2, padding="same", activation="relu"),
              L.BatchNormalization(), L.DepthwiseConv2D(3, padding="same"),
              L.MaxPooling2D(2), L.SeparableConv2D(16, 3),
              L.GlobalAveragePooling2D(), L.Dense(4))
    xtrain = np.random.RandomState(2).randn(32, 16, 16, 3).astype(np.float32)
    km.compile("sgd", "mse")
    km.fit(xtrain, np.zeros((32, 4), np.float32), epochs=1, verbose=0)
    x = np.random.RandomState(3).randn(4, 16, 16, 3).astype(np.float32)
    _assert_parity(km, x)


def test_functional_graph_parity():
    tf.keras.utils.set_random_seed(2)
    inp = tf.keras.Input((10,))
    a = L.Dense(6, activation="relu", name="a")(inp)
    b = L.Dense(6, name="b")(inp)
    s = L.Add(name="s")([a, b])
    c = L.Concatenate(axis=-1, name="c")([s, a])
    m = L.Maximum(name="m")([a, b])
    c2 = L.Concatenate(name="c2")([c, m])
    km = tf.keras.Model(inp, L.Dense(2, name="out")(c2))
    x = np.random.RandomState(4).randn(6, 10).astype(np.float32)
    _assert_parity(km, x)


def test_multi_input_functional_parity():
    tf.keras.utils.set_random_seed(3)
    ia = tf.keras.Input((5,), name="ia")
    ib = tf.keras.Input((7,), name="ib")
    out = L.Multiply(name="mul")([L.Dense(4, name="da")(ia),
                                  L.Dense(4, name="db")(ib)])
    km = tf.keras.Model([ia, ib], out)
    xa = np.random.RandomState(5).randn(3, 5).astype(np.float32)
    xb = np.random.RandomState(6).randn(3, 7).astype(np.float32)
    _assert_parity(km, [xa, xb])


def test_text_model_parity():
    tf.keras.utils.set_random_seed(4)
    km = _seq(L.Input((9,)), L.Embedding(50, 8),
              L.Bidirectional(L.LSTM(6, return_sequences=True)), L.LSTM(5),
              L.Dense(2, activation="softmax"))
    ids = np.random.RandomState(7).randint(0, 50, (4, 9)).astype(np.int32)
    _assert_parity(km, ids, atol=2e-4)


@pytest.mark.parametrize("rnn", ["gru_reset_after_false",
                                 "gru_reset_after_true", "bigru"])
def test_gru_layouts_parity(rnn):
    """test_gru_reset_after_false_parity, test_gru_reset_after_true_parity
    (the tf.keras default layout) and test_bigru_reset_after_parity."""
    if rnn == "bigru":
        tf.keras.utils.set_random_seed(15)
        km = _seq(L.Input((7, 5)),
                  L.Bidirectional(L.GRU(4, return_sequences=True)),
                  L.GlobalAveragePooling1D())
        x = np.random.RandomState(16).randn(3, 7, 5).astype(np.float32)
    else:
        tf.keras.utils.set_random_seed(5)
        km = _seq(L.Input((6, 4)),
                  L.GRU(5, reset_after=rnn.endswith("true")), L.Dense(3))
        x = np.random.RandomState(8).randn(3, 6, 4).astype(np.float32)
    _assert_parity(km, x, atol=2e-4)


@pytest.mark.parametrize("case", ["lambda", "threshold", "softmax_axis",
                                  "time_distributed_bn", "dot_rank3",
                                  "conv2d_transpose_same",
                                  "channels_first_pool",
                                  "channels_first_conv"])
def test_unconvertible_layers_raise_as_in_jax(case):
    """test_lambda_raises, the threshold half of
    test_relu6_and_leaky_relu_layers, test_softmax_axis_guard,
    test_time_distributed_bn_raises, test_dot_rank3_raises, the SAME half
    of test_conv2d_transpose_parity and test_channels_first_1d_raises:
    both packages refuse."""
    if case == "lambda":
        km, match = _seq(L.Input((4,)), L.Lambda(lambda t: t * 2)), "Lambda"
    elif case == "threshold":
        km, match = _seq(L.Input((4,)), L.ReLU(threshold=1.0)), "threshold"
    elif case == "softmax_axis":
        km, match = _seq(L.Input((4, 6)), L.Softmax(axis=1)), "axis"
    elif case == "time_distributed_bn":
        km = _seq(L.Input((5, 7)),
                  L.TimeDistributed(L.BatchNormalization()))
        match = "BatchNormalization"
    elif case == "dot_rank3":
        inp = tf.keras.Input((4, 6))
        km = tf.keras.Model(inp, L.Dot(axes=-1)([L.Dense(5)(inp),
                                                 L.Dense(5)(inp)]))
        match = "rank-3"
    elif case == "conv2d_transpose_same":
        km = _seq(L.Input((7, 7, 3)), L.Conv2DTranspose(5, 3,
                                                         padding="same"))
        match = "valid"
    elif case == "channels_first_pool":
        km = _seq(L.Input((6, 10)),
                  L.MaxPooling1D(2, data_format="channels_first"))
        match = "channels_last"
    else:
        km = _seq(L.Input((10, 10)),
                  L.Conv1D(4, 3, data_format="channels_first"))
        match = "channels_last"
    for pkg in (tkc, jkc):
        with pytest.raises(NotImplementedError, match=match):
            pkg.convert_keras_model(km)


def test_keras_model_inherits_compile_and_trains():
    """tfpark.KerasModel over a compiled tf.keras model: the compile state
    is inherited (Adam 0.01, sparse CE, accuracy) and fit trains; the
    trained predictions follow the JAX package's from the same weights."""
    tf.keras.utils.set_random_seed(6)
    km = _seq(L.Input((8,)), L.Dense(16, activation="relu"), L.Dense(3),
              L.Softmax())
    km.compile(optimizer=tf.keras.optimizers.Adam(learning_rate=0.01),
               loss="sparse_categorical_crossentropy", metrics=["accuracy"])
    wrapped = ttm.KerasModel(km)
    jwrapped = jtm.KerasModel(km)
    assert wrapped.source_model is km
    assert wrapped.model.criterion is tobj.sparse_categorical_crossentropy
    assert wrapped.model.optim_method is not None
    assert wrapped.metrics_names == jwrapped.metrics_names
    _same_weights(wrapped.model, jwrapped.model)
    rng = np.random.RandomState(9)
    x = rng.randn(64, 8).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32) + (x[:, 1] > 0).astype(np.int32)
    before = wrapped.evaluate(x, y, batch_size=64)
    _close_to_jax(before["loss"], jwrapped.evaluate(x, y,
                                                    batch_size=64)["loss"])
    for w in (wrapped, jwrapped):  # one batch an epoch: no shuffle order
        w.fit(x, y, batch_size=64, epochs=15)
    after = wrapped.evaluate(x, y, batch_size=64)
    assert after["loss"] < before["loss"]
    _close_to_jax(wrapped.predict(x, batch_size=64),
                  jwrapped.predict(x, batch_size=64), 1e-4)


def test_relu6_and_leaky_relu_layers():
    tf.keras.utils.set_random_seed(7)
    km = _seq(L.Input((6,)), L.Dense(8), L.ReLU(max_value=6.0), L.Dense(8),
              L.ReLU(negative_slope=0.1), L.Dense(2))
    x = (np.random.RandomState(10).randn(5, 6) * 4).astype(np.float32)
    _assert_parity(km, x)


LOSS_CASES = [
    ({"class_name": "KLDivergence", "config": {}},
     "kullback_leibler_divergence"),
    ({"class_name": "BinaryCrossentropy", "config": {"from_logits": True}},
     "binary_crossentropy_from_logits"),
    ("MeanSquaredError", "mean_squared_error"),
    ("kl_divergence", "kullback_leibler_divergence"),
    ("cosine_similarity", "cosine_proximity"),
    ({"class_name": "CategoricalCrossentropy",
      "config": {"from_logits": True}},
     "categorical_crossentropy_from_logits"),
    ({"class_name": "function", "config": "mean_squared_error"},
     "mean_squared_error"),
]


@pytest.mark.parametrize("spec,name", LOSS_CASES)
def test_loss_translation(spec, name):
    """test_loss_object_translation, test_loss_string_aliases and
    test_cce_from_logits_translates: each serialized Keras loss maps onto
    the port's objective of the name the JAX package maps it onto."""
    got, want = ttm._translate_loss(spec), jtm._translate_loss(spec)
    assert got is getattr(tobj, name) and want is getattr(jobj, name)
    t = np.array([[0.0, 1.0, 0.0]], np.float32)
    p = np.array([[2.0, -1.0, 0.5]], np.float32)
    if "binary" in name or "cosine" in name or "kullback" in name:
        p = np.abs(p) / np.abs(p).sum()
    _close_to_jax(float(got(torch.tensor(t), torch.tensor(p))),
                  float(want(t, p)))


def test_loss_translation_per_output_lists_raise():
    for fn in (ttm._translate_loss, jtm._translate_loss):
        with pytest.raises(NotImplementedError, match="per-output"):
            fn(["mse", "mae"])


def test_untranslatable_loss_degrades_to_uncompiled():
    tf.keras.utils.set_random_seed(8)
    km = _seq(L.Input((4,)), L.Dense(2))
    km.compile(optimizer="adam", loss=lambda yt, yp: tf.reduce_mean(yp))
    wrapped = ttm.KerasModel(km)  # warns, does not raise
    assert getattr(wrapped.model, "criterion", None) is None
    x = np.random.RandomState(11).randn(3, 4).astype(np.float32)
    np.testing.assert_allclose(wrapped.predict(x, batch_size=3),
                               np.asarray(km(x)), atol=1e-5)


def test_subclassed_model_clear_error():
    class MyNet(tf.keras.Model):
        def __init__(self):
            super().__init__()
            self.d = L.Dense(2)

        def call(self, x):
            return self.d(x)

    net = MyNet()
    net(np.zeros((1, 3), np.float32))
    assert tkc.is_foreign_keras_model(net)
    with pytest.raises(NotImplementedError, match="subclassed"):
        ttm.KerasModel(net)


def test_time_distributed_weights_copied():
    tf.keras.utils.set_random_seed(9)
    km = _seq(L.Input((5, 7)), L.TimeDistributed(L.Dense(4, name="inner_d")),
              L.Flatten(), L.Dense(2))
    x = np.random.RandomState(12).randn(3, 5, 7).astype(np.float32)
    _assert_parity(km, x)


def _one_update(tx, grads, steps=1):
    """``steps`` updates of a transformation over ``{"w": ones}``."""
    p = {"w": torch.ones(3)}
    state = tx.init(p)
    out = []
    for _ in range(steps):
        u, state = tx.update({"w": grads.clone()}, state, p)
        out.append(u["w"].numpy())
    return out


def _one_update_jax(tx, grads, steps=1):
    import jax.numpy as jnp

    p = {"w": jnp.ones((3,))}
    state = tx.init(p)
    out = []
    for _ in range(steps):
        u, state = tx.update({"w": jnp.asarray(grads.numpy())}, state, p)
        out.append(np.asarray(u["w"]))
    return out


@pytest.mark.parametrize("spec,grads,check", [
    # test_adam_weight_decay_maps_to_adamw: decay-only update non-zero
    ({"class_name": "Adam", "config": {"learning_rate": 0.001,
                                       "weight_decay": 0.01}},
     torch.zeros(3), "decay"),
    # test_rmsprop_momentum_forwarded: momentum grows the second update
    ({"class_name": "RMSprop", "config": {"learning_rate": 0.1,
                                          "momentum": 0.9}},
     torch.ones(3), "momentum"),
    # test_legacy_lr_key_respected: the Keras-2 "lr" key
    ({"class_name": "SGD", "config": {"lr": 0.1}}, torch.ones(3), "lr"),
    ({"class_name": "Adagrad", "config": {"learning_rate": 0.05}},
     torch.ones(3), None),
    ({"class_name": "Adamax", "config": {"learning_rate": 0.05}},
     torch.ones(3), None),
    ({"class_name": "Adadelta", "config": {"learning_rate": 0.5}},
     torch.ones(3), None),
    ("rmsprop", torch.ones(3), None),
])
def test_optimizer_translation(spec, grads, check):
    """A serialized Keras optimizer maps onto the port's transformation
    with the JAX package's hyperparameters: two updates equal the JAX
    package's optax ones to float32 rounding."""
    got = _one_update(ttm._translate_optimizer(spec), grads, 2)
    want = _one_update_jax(jtm._translate_optimizer(spec), grads, 2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
    if check == "decay":
        assert float(np.abs(got[0]).sum()) > 0
    elif check == "momentum":
        assert float(np.abs(got[1]).sum()) > 1.2 * float(
            np.abs(got[0]).sum())
    elif check == "lr":
        np.testing.assert_allclose(got[0], -0.1, rtol=1e-6)


def test_legacy_compile_spec_fallbacks():
    """test_legacy_fallback_list_loss_message and
    test_legacy_function_loss_recovered: an older attribute-layout model
    surface."""
    class Legacy:  # mimics a pre-Keras-3 model surface
        loss = ["mse", "mae"]
        optimizer = None
    with pytest.raises(NotImplementedError, match="per-output"):
        ttm._compile_spec_of(Legacy())

    def mean_squared_error(yt, yp):  # mimics keras.losses.mean_squared_error
        return yp

    class Legacy2:
        loss = mean_squared_error
        optimizer = None
    spec = ttm._compile_spec_of(Legacy2())
    assert spec is not None and spec[1] is tobj.mean_squared_error


def test_function_form_loss_and_metric():
    tf.keras.utils.set_random_seed(10)
    km = _seq(L.Input((4,)), L.Dense(1, activation="sigmoid"))
    keras = pytest.importorskip("keras")
    km.compile("adam", keras.losses.mean_squared_error,
               metrics=[keras.metrics.binary_accuracy])
    w = ttm.KerasModel(km)  # must not crash on function-form serialization
    assert w.model.criterion is tobj.mean_squared_error
    assert len(w.model.validation_metrics) == 1


def test_net_load_keras_json_plus_h5(tmp_path):
    """Reference signature Net.load_keras(json_path, hdf5_path)
    (net_load.py:153-164): architecture from to_json, weights from HDF5;
    the architecture alone converts with seeded weights of the right
    shapes."""
    from analytics_zoo_tpu.net import Net as JNet
    from analytics_zoo_tpu_torch.net import Net

    tf.keras.utils.set_random_seed(11)
    km = _seq(L.Input((8,)), L.Dense(6, activation="relu", name="fc1"),
              L.Dense(3, name="fc2"))
    jp = str(tmp_path / "arch.json")
    wp = str(tmp_path / "w.weights.h5")
    with open(jp, "w") as f:
        f.write(km.to_json())
    km.save_weights(wp)
    zm, jm = Net.load_keras(jp, wp), JNet.load_keras(jp, wp)
    _same_weights(zm, jm)
    x = np.random.RandomState(13).randn(4, 8).astype(np.float32)
    np.testing.assert_allclose(zm.predict(x, batch_size=4), np.asarray(km(x)),
                               atol=1e-5, rtol=1e-5)
    zm2 = Net.load_keras(jp)
    assert zm2.predict(x, batch_size=4).shape == (4, 3)


@pytest.mark.parametrize("form", ["h5_alone", "weights_only_h5_alone",
                                  "keras_zip"])
def test_net_load_keras_single_file_forms(tmp_path, form):
    """test_net_load_keras_h5_alone (a whole-model HDF5 as the first
    argument: architecture from its model_config, weights from the same
    file), test_net_load_keras_weights_only_h5_alone_clear_error and
    test_net_load_keras_zip_archive_clear_error."""
    from analytics_zoo_tpu.net import Net as JNet
    from analytics_zoo_tpu_torch.net import Net

    tf.keras.utils.set_random_seed(22)
    km = _seq(L.Input((8,)), L.Dense(6, activation="relu", name="h1"),
              L.Dense(3, name="h2"))
    if form == "h5_alone":
        hp = str(tmp_path / "model.h5")
        km.save(hp)
        zm, jm = Net.load_keras(hp), JNet.load_keras(hp)
        _same_weights(zm, jm)
        x = np.random.RandomState(23).randn(4, 8).astype(np.float32)
        np.testing.assert_allclose(zm.predict(x, batch_size=4),
                                   np.asarray(km(x)), atol=1e-5, rtol=1e-5)
    elif form == "weights_only_h5_alone":
        wp = str(tmp_path / "w.weights.h5")
        km.save_weights(wp)
        with pytest.raises(ValueError, match="model_config"):
            Net.load_keras(wp)
    else:
        kp = str(tmp_path / "model.keras")
        km.save(kp)
        with pytest.raises(NotImplementedError, match=".keras zip"):
            Net.load_keras(kp)


def test_conv2d_transpose_parity():
    tf.keras.utils.set_random_seed(12)
    km = _seq(L.Input((7, 7, 3)),
              L.Conv2DTranspose(5, 3, strides=2, padding="valid",
                                activation="relu"),
              L.GlobalAveragePooling2D())
    x = np.random.RandomState(14).randn(3, 7, 7, 3).astype(np.float32)
    _assert_parity(km, x)


def test_subtract_and_dot_parity():
    tf.keras.utils.set_random_seed(13)
    inp = tf.keras.Input((9,))
    a = L.Dense(5, name="sa")(inp)
    b = L.Dense(5, name="sb")(inp)
    out = L.Concatenate(name="cc")([
        L.Subtract(name="sub")([a, b]), L.Dot(axes=-1, name="dotp")([a, b]),
        L.Dot(axes=-1, normalize=True, name="cosp")([a, b])])
    km = tf.keras.Model(inp, out)
    x = np.random.RandomState(15).randn(4, 9).astype(np.float32)
    _assert_parity(km, x, atol=2e-4)


def test_1d_shape_pipeline_parity():
    tf.keras.utils.set_random_seed(14)
    km = _seq(L.Input((12, 4)), L.ZeroPadding1D((2, 1)),
              L.Conv1D(6, 3, activation="relu"), L.UpSampling1D(2),
              L.Cropping1D((1, 2)), L.GaussianNoise(0.5),
              L.GaussianDropout(0.3), L.GlobalMaxPooling1D())
    x = np.random.RandomState(16).randn(3, 12, 4).astype(np.float32)
    _assert_parity(km, x)


def test_normalize_io_bad_entry_raises():
    with pytest.raises(ValueError, match="unparseable"):
        tkc._normalize_io(["not_a_ref"])


def test_keras_model_passthrough_zoo():
    from analytics_zoo_tpu_torch.keras.engine.topology import Sequential
    from analytics_zoo_tpu_torch.keras.layers import Dense

    zm = Sequential([Dense(2, input_shape=(3,))])
    wrapped = ttm.KerasModel(zm)
    assert wrapped.model is zm and wrapped.source_model is None


def test_is_foreign_detection():
    from analytics_zoo_tpu_torch.keras.engine.topology import Sequential
    from analytics_zoo_tpu_torch.keras.layers import Dense

    assert tkc.is_foreign_keras_model(_seq(L.Input((2,)), L.Dense(1)))
    assert not tkc.is_foreign_keras_model(
        Sequential([Dense(1, input_shape=(2,))]))


@pytest.mark.slow
@pytest.mark.parametrize("app,shape", [
    ("MobileNetV2", (96, 96, 3)), ("ResNet50", (64, 64, 3)),
    ("VGG16", (64, 64, 3)), ("DenseNet121", (64, 64, 3)),
    ("InceptionV3", (96, 96, 3)), ("EfficientNetB0", (64, 64, 3)),
    ("Xception", (96, 96, 3))])
def test_keras_applications_parity(app, shape):
    """test_keras_applications_mobilenet_v2_parity,
    test_keras_applications_resnet50_parity and
    test_keras_applications_roster_parity (slow there too): published
    architectures convert."""
    tf.keras.utils.set_random_seed(40)
    km = getattr(tf.keras.applications, app)(input_shape=shape,
                                              weights=None, classes=10)
    x = (np.random.RandomState(22).rand(2, *shape) * 255).astype(np.float32)
    _assert_parity(km, x, atol=1e-5)


def test_bn_scale_false_and_normalization_adapted():
    tf.keras.utils.set_random_seed(43)
    norm = L.Normalization(axis=-1)
    data = np.random.RandomState(23).randn(128, 5).astype(np.float32) * 3 + 7
    norm.adapt(data)
    km = _seq(L.Input((5,)), norm, L.Dense(6),
              L.BatchNormalization(scale=False),
              L.Rescaling(scale=0.5, offset=-1.0))
    km.compile("sgd", "mse")
    km.fit(data[:64], np.zeros((64, 6), np.float32), epochs=1, verbose=0)
    _assert_parity(km, data[64:72], atol=1e-5)


def test_normalization_constructor_form_and_unknown_bn_names():
    km = _seq(L.Input((3,)),
              L.Normalization(mean=[1.0, 2.0, 3.0],
                              variance=[4.0, 9.0, 16.0]),
              L.Dense(2))
    x = np.random.RandomState(24).randn(4, 3).astype(np.float32)
    _assert_parity(km, x, atol=1e-5)
    from analytics_zoo_tpu_torch.keras.layers import BatchNormalization
    from analytics_zoo_tpu_torch.keras_import import _convert

    lay = BatchNormalization(dim_ordering="tf", input_shape=(4,))
    lay.ensure_built((None, 4))
    bad = {"scale_mystery": np.ones(4, np.float32),
           "moving_mean": np.zeros(4, np.float32),
           "moving_variance": np.ones(4, np.float32)}
    with pytest.raises(KeyError, match="gamma"):
        _convert(lay, bad)


def test_transformer_encoder_block_parity():
    tf.keras.utils.set_random_seed(44)
    d, n, kd = 32, 4, 8
    inp = tf.keras.Input((10, d))
    att = L.MultiHeadAttention(num_heads=n, key_dim=kd, name="xmha")(inp, inp)
    x1 = L.LayerNormalization(name="xln1")(L.Add(name="xr1")([inp, att]))
    ff = L.Dense(d, name="xff2")(L.Dense(64, activation="relu",
                                         name="xff1")(x1))
    x2 = L.LayerNormalization(name="xln2")(L.Add(name="xr2")([x1, ff]))
    km = tf.keras.Model(inp, L.GlobalAveragePooling1D(name="xgap")(x2))
    x = np.random.RandomState(25).randn(3, 10, d).astype(np.float32)
    _assert_parity(km, x)

    inp2 = tf.keras.Input((8, d))
    att2 = L.MultiHeadAttention(num_heads=n, key_dim=kd, name="xcmha")(
        inp2, inp2, use_causal_mask=True)
    _assert_parity(tf.keras.Model(inp2, att2),
                   np.random.RandomState(26).randn(2, 8, d).astype(
                       np.float32))


@pytest.mark.parametrize("case", ["distinct_key", "attention_mask", "rank4"])
def test_mha_guards(case):
    """test_cross_attention_distinct_key_raises and
    test_mha_mask_and_rank_guards."""
    d = 16
    if case == "distinct_key":
        q, v, k = (tf.keras.Input(s) for s in ((6, d), (9, d), (9, d)))
        km = tf.keras.Model([q, v, k], L.MultiHeadAttention(
            num_heads=2, key_dim=8, name="kvx")(q, v, k))
        match = "key"
    elif case == "attention_mask":
        q, m = tf.keras.Input((6, d)), tf.keras.Input((6, 6))
        km = tf.keras.Model([q, m], L.MultiHeadAttention(
            num_heads=2, key_dim=8, name="masked")(q, q, attention_mask=m))
        match = "attention_mask"
    else:
        img = tf.keras.Input((4, 4, d))
        km = tf.keras.Model(img, L.MultiHeadAttention(
            num_heads=2, key_dim=8, name="r4")(img, img))
        match = "rank-4"
    with pytest.raises(NotImplementedError, match=match):
        tkc.convert_keras_model(km)


@pytest.mark.parametrize("keyword", [False, True])
def test_cross_attention_parity(keyword):
    """test_cross_attention_parity (a kv stream of another width and
    length) and test_cross_attention_keyword_value_parity."""
    tf.keras.utils.set_random_seed(8 if keyword else 7)
    q = tf.keras.Input((5, 16) if keyword else (6, 16))
    kv = tf.keras.Input((7, 16) if keyword else (9, 24))
    mha = L.MultiHeadAttention(num_heads=2, key_dim=8)
    att = mha(q, value=kv) if keyword else mha(q, kv)
    km = tf.keras.Model([q, kv], att)
    rs = np.random.RandomState(1 if keyword else 0)
    _assert_parity(km, [rs.randn(2 if keyword else 3, *q.shape[1:]).astype(
        np.float32), rs.randn(2 if keyword else 3, *kv.shape[1:]).astype(
        np.float32)])


def _padded_ids(n=6, t=12, vocab=20, seed=3):
    rs = np.random.RandomState(seed)
    ids = rs.randint(1, vocab, (n, t)).astype(np.int32)
    ids[:, t - 4:] = 0   # post-padding
    ids[0, 3:] = 0       # heavily padded row
    return ids


def _tail_padded_ids(seed, pads, t=12, vocab=20):
    rs = np.random.RandomState(seed)
    ids = rs.randint(1, vocab, (len(pads), t)).astype(np.int32)
    for i, p in enumerate(pads):
        if p:
            ids[i, -p:] = 0
    return ids


def _masked_model(case):
    """The masked models of tests/test_keras_convert.py, by case."""
    if case == "rnn":
        tf.keras.utils.set_random_seed(41)
        return _seq(L.Input((12,)), L.Embedding(20, 8, mask_zero=True),
                    L.LSTM(4)), _padded_ids()
    if case == "masking_functional":
        tf.keras.utils.set_random_seed(42)
        inp = tf.keras.Input((10, 3))
        out = L.GRU(5)(L.Dropout(0.1)(L.Masking(0.0)(inp)))
        xs = np.random.RandomState(5).randn(4, 10, 3).astype(np.float32)
        xs[:, 7:, :] = 0.0
        return tf.keras.Model(inp, out), xs
    if case == "stopped":
        tf.keras.utils.set_random_seed(21)
        km = _seq(L.Input((10,)), L.Embedding(20, 8, mask_zero=True),
                  L.Flatten(), L.Dense(3))
        return km, np.random.RandomState(3).randint(1, 20, (4, 10)).astype(
            np.int32)
    if case == "gaussian_noise":
        tf.keras.utils.set_random_seed(43)
        return _seq(L.Input((12,)), L.Embedding(20, 8, mask_zero=True),
                    L.GaussianNoise(0.1), L.LSTM(4)), _padded_ids(seed=7)
    if case == "bidirectional_gap":
        tf.keras.utils.set_random_seed(45)
        return _seq(L.Input((12,)), L.Embedding(20, 8, mask_zero=True),
                    L.Bidirectional(L.GRU(5, reset_after=True,
                                          return_sequences=True)),
                    L.GlobalAveragePooling1D(), L.Dense(3)), \
            _padded_ids(seed=9)
    if case == "mha":
        tf.keras.utils.set_random_seed(44)
        inp = tf.keras.Input((12,))
        x = L.Embedding(20, 16, mask_zero=True)(inp)
        return tf.keras.Model(inp, L.MultiHeadAttention(
            num_heads=2, key_dim=8)(x, x)), _padded_ids(seed=11)
    if case == "plus_unmasked":
        tf.keras.utils.set_random_seed(46)
        inp = tf.keras.Input((12,))
        merged = L.Add()([L.Embedding(20, 8, mask_zero=True)(inp),
                          L.Embedding(20, 8)(inp)])
        return tf.keras.Model(inp, L.LSTM(4)(merged)), _padded_ids(seed=13)
    if case in ("concat_feature", "concat_time"):
        tf.keras.utils.set_random_seed(47 if case == "concat_feature" else 48)
        a, b = tf.keras.Input((12,)), tf.keras.Input((12,))
        if case == "concat_feature":
            merged = L.Concatenate()([L.Embedding(20, 8, mask_zero=True)(a),
                                      L.Embedding(20, 8, mask_zero=True)(b)])
            seeds = (17, 18)
        else:
            emb = L.Embedding(20, 8, mask_zero=True)
            merged = L.Concatenate(axis=1)([emb(a), emb(b)])
            seeds = (19, 20)
        return tf.keras.Model([a, b], L.LSTM(4)(merged)), [
            _tail_padded_ids(seeds[0], [4, 2, 6, 0]),
            _tail_padded_ids(seeds[1], [1, 5, 3, 7])]
    if case == "shared_masked_embedding":
        tf.keras.utils.set_random_seed(52)
        emb = L.Embedding(50, 8, mask_zero=True)
        enc = L.LSTM(5)
        a, b = tf.keras.Input((12,)), tf.keras.Input((12,))
        out = L.Concatenate()([enc(emb(a)), enc(emb(b))])
        return tf.keras.Model([a, b], out), [_padded_ids(seed=15),
                                             _padded_ids(seed=16)]
    assert case == "nested_backbone"
    tf.keras.utils.set_random_seed(73)
    si = tf.keras.Input((12, 8), name="mb_in")
    sub = tf.keras.Model(si, L.LSTM(4, name="mb_lstm")(si), name="mb_sub")
    inp = tf.keras.Input((12,))
    return tf.keras.Model(inp, sub(L.Embedding(20, 8, mask_zero=True)(inp))), \
        _padded_ids(seed=21)


@pytest.mark.parametrize("case", [
    "rnn", "masking_functional", "stopped", "gaussian_noise",
    "bidirectional_gap", "mha", "plus_unmasked", "concat_feature",
    "concat_time", "shared_masked_embedding", "nested_backbone"])
def test_masked_model_parity(case):
    """tf.keras timestep-mask semantics: test_masked_rnn_parity,
    test_masking_into_rnn_parity_functional,
    test_mask_stopped_before_rnn_converts,
    test_masked_rnn_behind_gaussian_noise_parity,
    test_masked_bidirectional_and_gap_parity, test_masked_mha_parity,
    test_masked_plus_unmasked_merge_drops_mask,
    test_masked_concatenate_feature_axis_parity,
    test_masked_concatenate_time_axis_parity,
    test_shared_masked_embedding_parity and
    test_masked_operand_into_nested_backbone."""
    km, x = _masked_model(case)
    _assert_parity(km, x)


def test_concat_masks_time_axis_unmasked_branch_refused():
    class _V:
        shape = (None, 12, 8)

    with pytest.raises(NotImplementedError, match="time-axis"):
        tkc._merge_masks([object(), None], "Concatenate",
                         {"name": "c", "axis": 1}, [_V(), _V()], None)


def test_shared_layer_siamese_parity():
    tf.keras.utils.set_random_seed(51)
    emb = L.Embedding(50, 8)
    enc = L.LSTM(6)
    a, b = tf.keras.Input((10,)), tf.keras.Input((10,))
    out = L.Dense(1)(L.Concatenate()([enc(emb(a)), enc(emb(b))]))
    km = tf.keras.Model([a, b], out)
    rs = np.random.RandomState(3)
    zm = _assert_parity(km, [rs.randint(1, 50, (4, 10)).astype(np.int32),
                             rs.randint(1, 50, (4, 10)).astype(np.int32)])
    names = [type(l).__name__ for l in zm.layers()]
    assert names.count("Embedding") == 1 and names.count("LSTM") == 1


def _nested(case):
    if case == "sequential_block_in_functional":
        tf.keras.utils.set_random_seed(61)
        block = _seq(L.Dense(16, activation="relu", name="nb_d1"),
                     L.Dense(8, name="nb_d2"))
        block._name = "nblock"
        inp = tf.keras.Input((12,))
        return tf.keras.Model(inp, L.Dense(3, name="nb_head")(block(inp))), \
            np.random.RandomState(0).randn(5, 12).astype(np.float32)
    if case == "sequential_in_sequential":
        tf.keras.utils.set_random_seed(62)
        inner = tf.keras.Sequential(
            [L.Dense(10, activation="relu", name="ns_d1")], name="ns_inner")
        outer = tf.keras.Sequential([L.Input((7,)), inner,
                                     L.Dense(4, name="ns_out")],
                                    name="ns_outer")
        return outer, np.random.RandomState(1).randn(4, 7).astype(np.float32)
    if case == "functional_backbone":
        tf.keras.utils.set_random_seed(70)
        bi = tf.keras.Input((10,), name="bb_in")
        backbone = tf.keras.Model(
            bi, L.Dense(6, activation="relu", name="bb_d")(bi),
            name="backbone")
        inp = tf.keras.Input((10,))
        return tf.keras.Model(inp, L.Dense(3, name="nf_head")(
            backbone(inp))), np.random.RandomState(0).randn(4, 10).astype(
            np.float32)
    assert case == "functional_in_sequential"
    tf.keras.utils.set_random_seed(72)
    si = tf.keras.Input((8,), name="s_in")
    sub = tf.keras.Model(si, L.Dense(6, name="s_d")(si), name="sub")
    km = tf.keras.Sequential([L.Input((8,)), sub,
                              L.Dense(2, name="s_head")])
    return km, np.random.RandomState(2).randn(4, 8).astype(np.float32)


@pytest.mark.parametrize("case", [
    "sequential_block_in_functional", "sequential_in_sequential",
    "functional_backbone", "functional_in_sequential"])
def test_nested_model_parity(case):
    """test_nested_sequential_block_in_functional,
    test_nested_sequential_in_sequential,
    test_nested_functional_backbone_parity and
    test_nested_functional_in_sequential_parity: sub-models inline."""
    km, x = _nested(case)
    _assert_parity(km, x)


def test_nested_keras_application_backbone_parity():
    """MobileNetV2(include_top=False) as a backbone layer under a new
    classifier head (at 64x64 here, 96x96 in the JAX test: the same
    graph, a quarter of the work for the two packages together)."""
    tf.keras.utils.set_random_seed(71)
    base = tf.keras.applications.MobileNetV2(
        include_top=False, weights=None, input_shape=(64, 64, 3))
    inp = tf.keras.Input((64, 64, 3))
    h = L.GlobalAveragePooling2D()(base(inp))
    km = tf.keras.Model(inp, L.Dense(5, name="tl_head")(h))
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    _assert_parity(km, x, atol=5e-4)


def test_shared_nested_backbone_refuses_actionably():
    tf.keras.utils.set_random_seed(74)
    bi = tf.keras.Input((6,), name="tw_in")
    bb = tf.keras.Model(bi, L.Dense(4, name="tw_d")(bi), name="tw_bb")
    a, b = tf.keras.Input((6,)), tf.keras.Input((6,))
    km = tf.keras.Model([a, b], L.Add()([bb(a), bb(b)]))
    with pytest.raises(NotImplementedError, match="call sites"):
        tkc.convert_keras_model(km)


def test_converted_masked_model_trains():
    """A converted masked model trains through the engine: the loss stays
    finite, the fit learns, predictions repeat."""
    tf.keras.utils.set_random_seed(81)
    km = _seq(L.Input((12,)), L.Embedding(30, 8, mask_zero=True), L.LSTM(6),
              L.Dense(2, activation="softmax"))
    km.compile(optimizer=tf.keras.optimizers.Adam(0.01),
               loss="sparse_categorical_crossentropy")
    rs = np.random.RandomState(4)
    ids = rs.randint(1, 30, (64, 12)).astype(np.int32)
    ids[:, 8:] = 0
    y = (ids[:, 0] > 15).astype(np.int32)
    m = ttm.KerasModel(km)
    m.fit(ids, y, batch_size=16, epochs=6)
    assert np.isfinite(m.model._get_estimator().train_losses[-1])
    probs = m.predict(ids, batch_size=16)
    assert float((probs.argmax(-1) == y).mean()) > 0.8
    np.testing.assert_allclose(probs, m.predict(ids.copy(), batch_size=16),
                               atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_masked_attention_per_token_loss_trains_like_jax(causal):
    """A masked Keras MultiHeadAttention (self-attention, and with
    use_causal_mask) under a per-token head whose loss reads the padded
    positions too (the converters mask no loss): a padded query's softmax
    is uniform over the keys it may see, and its gradient reaches q and k
    as in the JAX package's (B,1,S,S) bias route. Three SGD steps through
    fit, parity with the JAX package at every step."""
    from analytics_zoo_tpu.keras.optimizers import SGD as JSGD
    from analytics_zoo_tpu_torch.keras.optimizers import SGD as TSGD

    tf.keras.utils.set_random_seed(95 + causal)
    inp = tf.keras.Input((12,), dtype="int32")
    x = L.Embedding(20, 16, mask_zero=True)(inp)
    a = L.MultiHeadAttention(num_heads=2, key_dim=8)(
        x, x, use_causal_mask=causal)
    km = tf.keras.Model(inp, L.Dense(3, activation="softmax")(
        L.Add()([x, a])))
    tm, jm = _convert_both(km)
    ids = _tail_padded_ids(97, [0, 3, 6, 9, 11, 2])
    ids[2, :4] = 0  # leading padding as well
    y = np.random.RandomState(98).randint(0, 3, ids.shape).astype(np.int32)
    _close_to_jax(tm.predict(ids, batch_size=6), jm.predict(ids,
                                                            batch_size=6))
    for m, opt in ((tm, TSGD(lr=0.5)), (jm, JSGD(lr=0.5))):
        m.compile(optimizer=opt, loss="sparse_categorical_crossentropy")
    for _ in range(3):  # one batch an epoch: no shuffle order
        tm.fit(ids, y, batch_size=6, nb_epoch=1)
        jm.fit(ids, y, batch_size=6, nb_epoch=1)
        tw, jw = tm.get_weights(), jm.get_weights()
        for lname, leaves in jw.items():
            for k, v in leaves.items():
                _close_to_jax(tw[lname][k], v, STEP_TOL)
        _close_to_jax(tm.predict(ids, batch_size=6),
                      jm.predict(ids, batch_size=6), STEP_TOL)


# -- the BERT-shaped encoder ------------------------------------------------


def _keras_encoder(seq, vocab, width, heads, blocks, ffn):
    """The Keras encoder ``chip_smoke.py`` phase 15a converts at BERT-base
    widths, built with tf.keras: token and position ids, both embeddings
    ``mask_zero`` (Keras drops a mask at an Add with an unmasked operand,
    so the position ids are 1-based and 0 at padding), ``blocks`` x (MHA,
    Add, LayerNormalization, Dense gelu, Dense, Add, LayerNormalization), a
    masked GlobalAveragePooling1D and a 2-class softmax head."""
    ids = tf.keras.Input((seq,), dtype="int32", name="ids")
    pos = tf.keras.Input((seq,), dtype="int32", name="pos")
    x = L.Add(name="emb_add")([
        L.Embedding(vocab, width, mask_zero=True, name="tok_emb")(ids),
        L.Embedding(seq + 1, width, mask_zero=True, name="pos_emb")(pos)])
    for i in range(blocks):
        a = L.MultiHeadAttention(num_heads=heads, key_dim=width // heads,
                                 dropout=0.0, name=f"b{i}_mha")(x, x)
        x = L.LayerNormalization(name=f"b{i}_ln1")(
            L.Add(name=f"b{i}_res1")([x, a]))
        f = L.Dense(width, name=f"b{i}_ff2")(
            L.Dense(ffn, activation="gelu", name=f"b{i}_ff1")(x))
        x = L.LayerNormalization(name=f"b{i}_ln2")(
            L.Add(name=f"b{i}_res2")([x, f]))
    out = L.Dense(2, activation="softmax", name="head")(
        L.GlobalAveragePooling1D(name="gap")(x))
    return tf.keras.Model([ids, pos], out, name="keras_encoder")


def _encoder_batch(rs, n, seq, vocab):
    lens = rs.randint(seq // 4, seq + 1, n)
    ids = rs.randint(1, vocab, (n, seq)).astype(np.int32)
    live = np.arange(seq)[None, :] < lens[:, None]
    ids[~live] = 0
    return ids, np.where(live, np.arange(1, seq + 1)[None, :], 0).astype(
        np.int32)


@pytest.fixture(scope="module")
def encoder():
    tf.keras.utils.set_random_seed(90)
    return _keras_encoder(seq=16, vocab=50, width=64, heads=4, blocks=2,
                          ffn=128)


def test_bert_shaped_encoder_converts_and_trains(encoder):
    """The BERT-shaped Keras encoder (2 blocks, width 64, 4 heads,
    mask_zero): both packages convert it from its to_json() architecture
    with the same weights; the port's forward equals the JAX package's
    and TF's (within GELU_TOL: Keras's gelu is the erf form); then three
    SGD steps through fit, parity with the JAX package at every step."""
    from analytics_zoo_tpu.keras.optimizers import SGD as JSGD
    from analytics_zoo_tpu_torch.keras.optimizers import SGD as TSGD

    tm, jm = _convert_both(encoder)
    rs = np.random.RandomState(91)
    x = list(_encoder_batch(rs, 8, 16, 50))
    got = tm.predict(x, batch_size=8)
    _close_to_jax(got, jm.predict(x, batch_size=8))
    # Keras itself (3.13) runs the second block's attention with no mask
    # (its input tensor lost the mask attribute MultiHeadAttention reads,
    # while the pool still gets the functional mask): the converters mask
    # every block, so TF is held to them on unpadded rows at two blocks
    # and on padded rows at one (the first block's attention is masked in
    # Keras too)
    full = [np.maximum(x[0], 1), np.tile(np.arange(1, 17, dtype=np.int32),
                                         (8, 1))]
    np.testing.assert_allclose(tm.predict(full, batch_size=8),
                               np.asarray(encoder(full)), atol=GELU_TOL)
    tf.keras.utils.set_random_seed(92)
    one = _keras_encoder(seq=16, vocab=50, width=64, heads=4, blocks=1,
                         ffn=128)
    np.testing.assert_allclose(
        tkc.convert_keras_model(one).predict(x, batch_size=8),
        np.asarray(one(x)), atol=GELU_TOL)

    y = rs.randint(0, 2, 8).astype(np.int32)
    for m, opt in ((tm, TSGD(lr=0.5)), (jm, JSGD(lr=0.5))):
        m.compile(optimizer=opt, loss="sparse_categorical_crossentropy")
    for _ in range(3):  # one batch an epoch: no shuffle order
        tm.fit(x, y, batch_size=8, nb_epoch=1)
        jm.fit(x, y, batch_size=8, nb_epoch=1)
        tw, jw = tm.get_weights(), jm.get_weights()
        for lname, leaves in jw.items():
            for k, v in leaves.items():
                _close_to_jax(tw[lname][k], v, STEP_TOL)
        _close_to_jax(tm.predict(x, batch_size=8),
                      jm.predict(x, batch_size=8), STEP_TOL)


def test_encoder_json_both_dialects_convert_alike(encoder, tmp_path):
    """The Keras-3 to_json() of the encoder and the classic-dialect config
    that chip_smoke.py writes for phase 15a at the same widths build the
    same zoo graph (layer names, classes and parameter shapes) in the port
    and in the JAX package, through Net.load_keras(json)."""
    import chip_smoke as cs
    from analytics_zoo_tpu.net import Net as JNet
    from analytics_zoo_tpu_torch.net import Net

    k3 = tmp_path / "k3.json"
    k3.write_text(encoder.to_json())
    classic = tmp_path / "classic.json"
    classic.write_text(json.dumps(cs.keras_encoder_config(
        seq=16, vocab=50, width=64, heads=4, blocks=2, ffn=128)))

    def summary(m):
        return sorted((l.name, type(l).__name__) for l in m.layers()
                      if l.weight_specs), {
            k: {n: np.shape(v) for n, v in d.items()}
            for k, d in m.get_weights().items()}

    got = [summary(Net.load_keras(str(p))) for p in (k3, classic)]
    want = [summary(JNet.load_keras(str(p))) for p in (k3, classic)]
    assert got[0] == got[1] == want[0] == want[1]


@pytest.fixture(scope="module")
def mobilenet_files(tmp_path_factory):
    """A seeded MobileNetV2 (32x32) saved whole and as weights only."""
    d = tmp_path_factory.mktemp("mnv2")
    tf.keras.utils.set_random_seed(33)
    km = tf.keras.applications.MobileNetV2(weights=None,
                                           input_shape=(32, 32, 3))
    km.save(str(d / "full.h5"))
    km.save_weights(str(d / "w.weights.h5"))
    return km, d


@pytest.mark.parametrize("form", ["whole_model", "weights_only"])
def test_image_classifier_from_pretrained_keras_file(mobilenet_files, form):
    """ImageClassifier.from_pretrained with a Keras file: a whole-model
    HDF5 (architecture from its model_config) and a weights-only one (the
    tf.keras.applications architecture built locally, the weights poured
    in, then converted); both packages load the same weights and predict
    alike, and as Keras does."""
    from analytics_zoo_tpu.models.image.imageclassification import (
        ImageClassifier as JIC,
    )
    from analytics_zoo_tpu_torch.models.image.imageclassification import (
        ImageClassifier as TIC,
        imagenet_preprocess,
    )

    km, d = mobilenet_files
    whole = form == "whole_model"
    path = str(d / ("full.h5" if whole else "w.weights.h5"))
    kw = {} if whole else {"input_shape": (32, 32, 3)}
    clf = TIC.from_pretrained("mobilenet-v2", path, **kw)
    jclf = JIC.from_pretrained("mobilenet-v2", path, **kw)
    assert clf.preprocess_mode == jclf.preprocess_mode == "tf"
    _same_weights(clf.model, jclf.model)
    imgs = np.random.RandomState(2).randint(0, 256, (2, 32, 32, 3))
    x = imagenet_preprocess(imgs.astype(np.uint8), clf.preprocess_mode)
    got = clf.model.predict(x, batch_size=2)
    np.testing.assert_allclose(got, np.asarray(km(x)), atol=1e-5)
    _close_to_jax(got, jclf.model.predict(x, batch_size=2))
    if not whole:
        with pytest.raises(ValueError, match="no tf.keras.applications"):
            TIC.from_pretrained("squeezenet", path)
