"""tfpark's training surface in the port against the JAX package, on the
CPU.

The JAX package's ``test_tfdataset_batch_contract``,
``test_tf_optimizer_from_keras_and_from_loss``,
``test_tfestimator_model_fn_protocol``, ``test_tf_predictor_over_dataset``
and ``test_tfpark_keras_model_fit_predict`` (``tests/test_tfpark.py``)
re-pointed at the port. Each model starts from seeded numpy weights that
the JAX model's ``init`` also returns (the port's takes them through
``interop.load_jax_params``), and each trained model's predictions are
held to the JAX package's within ``FIT_TOL``: 1e-4 absolute on
probabilities, after up to 48 Adam steps of two small dense layers in f32
summed in another order (measured below 1e-5). The port has one device
(``NNContext.num_devices``), where the JAX tests run on an 8-device mesh:
the batch contract is checked at both counts.
"""

import numpy as np
import pytest

import analytics_zoo_tpu as zoo
from analytics_zoo_tpu import tfpark as jtp
from analytics_zoo_tpu.engine import triggers as jtrig
from analytics_zoo_tpu.keras import layers as jlayers
from analytics_zoo_tpu.keras import objectives as jobj
from analytics_zoo_tpu.keras import optimizers as jopt
from analytics_zoo_tpu.keras.engine import topology as jtopo
import analytics_zoo_tpu_torch as port
from analytics_zoo_tpu_torch import tfpark as ttp
from analytics_zoo_tpu_torch.engine import triggers as ttrig
from analytics_zoo_tpu_torch.interop import load_jax_params
from analytics_zoo_tpu_torch.keras import layers as tlayers
from analytics_zoo_tpu_torch.keras import objectives as tobj
from analytics_zoo_tpu_torch.keras import optimizers as topt
from analytics_zoo_tpu_torch.keras.engine import topology as ttopo
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts

FIT_TOL = 1e-4


@pytest.fixture(autouse=True)
def _contexts():
    zoo.init_nncontext()
    ctx = port.init_nncontext(device="cpu")
    yield ctx
    port.stop_nncontext()
    reset_name_counts()


def _mlp(layers, topo, n_in, hidden, n_out):
    m = topo.Sequential()
    m.add(layers.Dense(hidden, activation="relu", input_shape=(n_in,)))
    m.add(layers.Dense(n_out, activation="softmax"))
    return m


def _weights(n_in, hidden, n_out, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * 0.3).astype(np.float32) for s in
            ((n_in, hidden), (hidden,), (hidden, n_out), (n_out,))]


def _pair(n_in, hidden, n_out, seed):
    """The same MLP in both packages with the same seeded weights."""
    jm = _mlp(jlayers, jtopo, n_in, hidden, n_out)
    tm = _mlp(tlayers, ttopo, n_in, hidden, n_out)
    k1, b1, k2, b2 = _weights(n_in, hidden, n_out, seed)
    names = [l.name for l in jm.layers()]
    params = {names[0]: {"kernel": k1, "bias": b1},
              names[1]: {"kernel": k2, "bias": b2}}
    jm.init = lambda key: (params, {})
    load_jax_params(tm, params)
    return jm, tm


def _data(seed, n=64, d=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x, (x.sum(1) > 0).astype(np.int32)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=FIT_TOL)


def test_tfdataset_batch_contract(_contexts):
    x = np.zeros((32, 4), np.float32)
    assert _contexts.num_devices == 1
    ds = ttp.TFDataset.from_ndarrays((x, np.zeros(32)), batch_size=12)
    assert ds.batch_size == 12 and ds.has_label
    ds2 = ttp.TFDataset.from_ndarrays((x, np.zeros(32)), batch_per_thread=2)
    assert ds2.batch_size == 2  # 2 x 1 device
    unlabeled = ttp.TFDataset.from_ndarrays([x, x], batch_size=8)
    assert not unlabeled.has_label
    assert len(unlabeled.feature_set.xs) == 2
    with pytest.raises(ValueError, match="batch geometry"):
        ttp.TFDataset.from_ndarrays(x)
    rdd = [(x[i], i % 2) for i in range(32)]
    from_rdd = ttp.TFDataset.from_rdd(rdd, batch_size=8)
    np.testing.assert_array_equal(from_rdd.feature_set.ys[0],
                                  np.arange(32) % 2)
    # the JAX package's contract on its 8-device mesh, at the same count
    _contexts.num_devices = 8
    with pytest.raises(ValueError, match="multiple of the"):
        ttp.TFDataset.from_ndarrays((x, np.zeros(32)), batch_size=12)
    for mod in (ttp, jtp):
        assert mod.TFDataset.from_ndarrays(
            (x, np.zeros(32)), batch_per_thread=2).batch_size == 16


def test_tf_optimizer_from_keras_and_from_loss():
    x, y = _data(3)
    results = {}
    for name, tp, layers, opt, obj, trig in (
            ("port", ttp, tlayers, topt, tobj, ttrig),
            ("jax", jtp, jlayers, jopt, jobj, jtrig)):
        i = 1 if name == "port" else 0
        ms = [_pair(4, 8, 2, seed)[i] for seed in (10, 11, 12)]
        m, m2, m3 = ms
        m.compile(optimizer=opt.Adam(lr=0.02),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
        ds = tp.TFDataset.from_ndarrays((x, y), batch_size=32)
        tp.TFOptimizer.from_keras(m, ds).optimize(
            end_trigger=trig.MaxEpoch(12))
        # from_loss: an uncompiled model whose estimator already holds
        # state (predict first): the optimizer is reset into it
        m2.predict(x[:8], batch_size=8)
        opt2 = tp.TFOptimizer.from_loss(
            obj.sparse_categorical_crossentropy, opt.Adam(lr=0.02),
            model=m2, dataset=ds)
        opt2.set_gradient_clipping_by_l2_norm(5.0)
        opt2.optimize(end_trigger=trig.MaxEpoch(12))
        acc2 = opt2._ensure_estimator().evaluate(
            ds.feature_set, ["accuracy"], batch_size=32)["accuracy"]
        # val_spilt (the reference's spelling): held-out validation runs
        m3.compile(optimizer=opt.Adam(lr=0.02),
                   loss="sparse_categorical_crossentropy",
                   metrics=["accuracy"])
        opt3 = tp.TFOptimizer.from_keras(m3, ds, val_spilt=0.25)
        opt3.optimize(end_trigger=trig.MaxEpoch(10))
        assert opt3._ensure_estimator().run_state.score is not None
        results[name] = (m.evaluate(x, y, batch_size=32)["accuracy"],
                         acc2, [mm.predict(x, batch_size=32) for mm in ms])
    acc, acc2, preds = results["port"]
    assert acc > 0.9 and acc2 > 0.9, (acc, acc2)
    for a, b in zip(preds, results["jax"][2], strict=True):
        _close(a, b)

    assert isinstance(ttp.to_optax_optim_method("rmsprop"),
                      topt.GradientTransformation)
    sgd = topt.SGD(lr=0.1)
    assert ttp.to_optax_optim_method(sgd) is sgd
    assert isinstance(ttp.to_optax_optim_method(topt.Adam(lr=0.1)),
                      topt.GradientTransformation)
    assert ttp.to_optax_optim_method(None) is None
    with pytest.raises(ValueError, match="Unknown optimizer"):
        ttp.to_optax_optim_method("nope")
    with pytest.raises(ValueError, match="compiled model"):
        ttp.TFOptimizer.from_keras(_mlp(tlayers, ttopo, 4, 8, 2),
                                   ttp.TFDataset.from_ndarrays(
                                       (x, y), batch_size=32))


def test_tfestimator_model_fn_protocol(tmp_path):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, 3)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32)
    outs = {}
    for name, tp, opt in (("port", ttp, topt), ("jax", jtp, jopt)):
        model = _pair(3, 8, 2, 20)[0 if name == "jax" else 1]

        def model_fn(mode, params, model=model, tp=tp, opt=opt):
            assert params == {"hidden": 8}
            return tp.EstimatorSpec(mode=mode, model=model,
                                    loss="sparse_categorical_crossentropy",
                                    optimizer=opt.Adam(lr=0.05))

        est = tp.TFEstimator(model_fn, params={"hidden": 8},
                             model_dir=str(tmp_path / name))
        input_fn = lambda tp=tp: tp.TFDataset.from_ndarrays((x, y),
                                                            batch_size=32)
        est.train(input_fn, steps=40)
        res = est.evaluate(input_fn, eval_methods=["loss", "accuracy"])
        preds = est.predict(lambda tp=tp: tp.TFDataset.from_ndarrays(
            x, batch_size=32))
        outs[name] = (res, preds)
    res, preds = outs["port"]
    assert res["accuracy"] > 0.9
    assert preds.shape == (64, 2)
    _close(preds, outs["jax"][1])
    _close(res["loss"], outs["jax"][0]["loss"])
    assert any(p.name.startswith("ckpt_") for p in (tmp_path / "port")
               .iterdir())


def test_tf_predictor_over_dataset():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(70, 6)).astype(np.float32)  # 70: a masked tail
    jm, m = _pair(6, 5, 3, 30)
    m.compile(optimizer=topt.Adam(lr=0.01),
              loss="sparse_categorical_crossentropy")
    ds = ttp.TFDataset.from_ndarrays(x, batch_per_thread=4)
    preds = ttp.TFPredictor.from_keras(m, ds).predict()
    assert preds.shape == (70, 3)
    np.testing.assert_array_equal(preds, m.predict(x, batch_size=4))
    jpreds = jtp.TFPredictor.from_keras(
        jm, jtp.TFDataset.from_ndarrays(x, batch_per_thread=4)).predict()
    _close(preds, jpreds)

    # a bare batch function over the host arrays
    fn = lambda t: np.tanh(t @ np.ones((6, 2), np.float32))
    preds2 = ttp.TFPredictor(fn, ds).predict()
    np.testing.assert_allclose(preds2, np.tanh(x @ np.ones((6, 2))),
                               atol=1e-5)
    with pytest.raises(NotImplementedError, match="A6"):
        ttp.TFPredictor.from_tfnet(fn, ds)


def test_tfpark_keras_model_fit_predict():
    x, y = _data(0)
    outs = {}
    for name, tp, opt in (("port", ttp, topt), ("jax", jtp, jopt)):
        m = _pair(4, 8, 2, 40)[0 if name == "jax" else 1]
        m.compile(optimizer=opt.Adam(lr=0.02),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
        km = tp.KerasModel(m)
        ds = tp.TFDataset.from_ndarrays((x, y), batch_size=32)
        km.fit(ds, epochs=15)
        outs[name] = (km.evaluate(ds),
                      km.predict(tp.TFDataset.from_ndarrays(x,
                                                            batch_size=32)))
        if name == "port":
            assert km.metrics_names == ["loss", "accuracy"]
    res, preds = outs["port"]
    assert res["accuracy"] > 0.9
    assert preds.shape == (64, 2)
    _close(preds, outs["jax"][1])

    class Foreign:  # stands in for a tf.keras model class
        pass

    Foreign.__module__ = "keras.src.models.model"
    with pytest.raises(NotImplementedError, match="A6"):
        ttp.KerasModel(Foreign())
