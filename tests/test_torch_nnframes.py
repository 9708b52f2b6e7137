"""nnframes in the port against the JAX package, on the CPU.

The JAX package's ``test_nn_classifier_fit_transform``,
``test_nn_estimator_regression_and_validation`` and ``test_nn_image_reader``
(``tests/test_inference_nnframes.py``) re-pointed at the port, each also
run through the JAX package from the same seeded numpy weights (the JAX
model's ``init`` returns them; the port's model takes them through
``interop.load_jax_params``) and compared: the prediction column equal,
the probabilities or regression outputs within ``FIT_TOL``. Then a fit
over a column object that is not a pandas frame, with validation,
gradient clipping, checkpoints and TensorBoard summaries, against the same
fit over a pandas frame.

``FIT_TOL`` 1e-4 (absolute, on probabilities and on regression outputs of
magnitude below 5): 45-60 Adam steps of two small dense layers in f32,
summed in another order on each side; measured below 2e-6.
"""

import numpy as np
import pandas as pd
import pytest

import jax

import analytics_zoo_tpu as zoo
from analytics_zoo_tpu.keras.engine import topology as jtopo
from analytics_zoo_tpu.keras import layers as jlayers
from analytics_zoo_tpu.keras import optimizers as jopt
from analytics_zoo_tpu import nnframes as jnn
import analytics_zoo_tpu_torch as port
from analytics_zoo_tpu_torch import nnframes as tnn
from analytics_zoo_tpu_torch.data.feature_set import ArrayFeatureSet
from analytics_zoo_tpu_torch.interop import load_jax_params
from analytics_zoo_tpu_torch.keras import layers as tlayers
from analytics_zoo_tpu_torch.keras import optimizers as topt
from analytics_zoo_tpu_torch.keras.engine import topology as ttopo
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts

FIT_TOL = 1e-4


@pytest.fixture(autouse=True)
def _contexts():
    zoo.init_nncontext()
    port.init_nncontext(device="cpu")
    yield
    port.stop_nncontext()
    reset_name_counts()


def _mlp(layers, topo, sizes, n_in):
    m = topo.Sequential()
    for i, (units, act) in enumerate(sizes):
        kw = dict(input_shape=(n_in,)) if i == 0 else {}
        m.add(layers.Dense(units, activation=act, **kw))
    return m


def _pair(sizes, n_in, seed):
    """The same MLP in both packages with the same seeded weights."""
    jm = _mlp(jlayers, jtopo, sizes, n_in)
    tm = _mlp(tlayers, ttopo, sizes, n_in)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))[0]
    rng = np.random.default_rng(seed)
    params = {k: {n: (rng.standard_normal(a.shape) * 0.3).astype(np.float32)
                  for n, a in v.items()} for k, v in shapes.items()}
    jm.init = lambda key: (params, {})
    load_jax_params(tm, params)
    return jm, tm


def _classification_frame():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(96, 4)).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(int)
    return x, y, pd.DataFrame({"features": list(x), "label": y})


def test_nn_classifier_fit_transform():
    x, y, df = _classification_frame()
    jm, tm = _pair([(16, "relu"), (2, "softmax")], 4, 1)
    outs = {}
    for name, nn, model, opt in (("port", tnn, tm, topt.Adam(lr=0.01)),
                                 ("jax", jnn, jm, jopt.Adam(lr=0.01))):
        clf = (nn.NNClassifier(model).setBatchSize(32).setMaxEpoch(15)
               .setOptimMethod(opt))
        nn_model = clf.fit(df)
        out = nn_model.transform(df)
        assert "prediction" in out.columns
        outs[name] = (out["prediction"].to_numpy(), nn_model)
    pred, nn_model = outs["port"]
    assert isinstance(nn_model, tnn.NNClassifierModel)
    assert (pred == y).mean() > 0.9
    np.testing.assert_array_equal(pred, outs["jax"][0])
    probs = nn_model.estimator.predict(ArrayFeatureSet(x), 32)
    jprobs = np.asarray(outs["jax"][1].estimator.predict(
        jnn.nn_estimator.ArrayFeatureSet(x), 32))
    np.testing.assert_allclose(probs, jprobs, rtol=0, atol=FIT_TOL)


def test_nn_estimator_regression_and_validation():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, 3)).astype(np.float32)
    y = x.sum(axis=1, keepdims=True).astype(np.float32)
    df = pd.DataFrame({"features": list(x), "label": list(y)})
    jm, tm = _pair([(1, None)], 3, 2)
    preds = {}
    for name, nn, model in (("port", tnn, tm), ("jax", jnn, jm)):
        est = (nn.NNEstimator(model, "mse")
               .setBatchSize(32).setMaxEpoch(30).setLearningRate(0.05))
        est.set_validation(None, df, ["mae"], 32)
        out = est.fit(df).transform(df)
        preds[name] = np.asarray(list(out["prediction"])).reshape(-1, 1)
    assert float(np.abs(preds["port"] - y).mean()) < 0.5
    np.testing.assert_allclose(preds["port"], preds["jax"], rtol=0,
                               atol=FIT_TOL)


def test_nn_image_reader(tmp_path):
    import cv2

    for cls in ("a", "b"):
        (tmp_path / cls).mkdir()
        for i in range(2):
            img = np.random.default_rng(i).integers(
                0, 255, (20, 30, 3)).astype(np.uint8)
            cv2.imwrite(str(tmp_path / cls / f"{i}.png"), img)
    df = tnn.NNImageReader.read_images(str(tmp_path), with_label=True,
                                       resize_h=16, resize_w=16)
    jdf = jnn.NNImageReader.readImages(str(tmp_path), with_label=True,
                                       resize_h=16, resize_w=16)
    assert len(df) == 4
    assert set(df.columns) >= {"image", "height", "width", "label", "origin"}
    assert df["height"].tolist() == [16] * 4
    assert list(df.columns) == list(jdf.columns)
    for col in df.columns:
        for a, b in zip(df[col], jdf[col], strict=True):
            np.testing.assert_array_equal(a, b)


class ColumnFrame:
    """A frame without pandas: named columns of per-row values, with the
    four members nnframes reads (``columns``, ``__getitem__``, ``copy``,
    ``__setitem__``)."""

    def __init__(self, cols):
        self.cols = dict(cols)

    @property
    def columns(self):
        return list(self.cols)

    def __getitem__(self, name):
        return self.cols[name]

    def __setitem__(self, name, values):
        self.cols[name] = list(values)

    def copy(self):
        return ColumnFrame(self.cols)


def test_fit_over_a_column_object_without_pandas(tmp_path):
    x, y, df = _classification_frame()
    frame = ColumnFrame({"features": list(x), "label": list(y)})
    _, tm = _pair([(16, "relu"), (2, "softmax")], 4, 3)
    _, tm2 = _pair([(16, "relu"), (2, "softmax")], 4, 3)
    preds, models = [], []
    for model, data, app in ((tm, frame, "columns"), (tm2, df, "pandas")):
        clf = (tnn.NNClassifier(model).setBatchSize(32).setMaxEpoch(4)
               .setOptimMethod(topt.Adam(lr=0.01))
               .setGradientClippingByL2Norm(1.0)
               .setTensorBoard(str(tmp_path), app)
               .setCheckpoint(str(tmp_path / app)))
        clf.setValidation(None, data, ["accuracy"], 32)
        models.append(clf.fit(data))
        out = models[-1].transform(data)
        preds.append(np.asarray(out["prediction"]))
    assert isinstance(out, pd.DataFrame)
    assert isinstance(models[0].transform(frame), ColumnFrame)
    assert "prediction" not in frame.columns  # transform works on a copy
    np.testing.assert_array_equal(preds[0], preds[1])
    assert len(preds[0]) == len(y)
    assert sorted(p.name for p in (tmp_path / "columns").iterdir()
                  if p.name.startswith("ckpt_")) == [
        "ckpt_12", "ckpt_3", "ckpt_6", "ckpt_9"]
    est = models[0].estimator
    assert len(est.train_summary.read_scalar("Loss")) == 12
    assert est.run_state.score is not None  # validation ran
    assert est._clip_l2norm == 1.0
    with pytest.raises(KeyError):
        tnn.NNClassifier(tm).setFeaturesCol("pixels").fit(frame)


def test_estimator_time_steps_records_each_step(monkeypatch):
    """``Estimator.time_steps`` set on the class reaches the estimator that
    ``NNClassifier.fit`` creates: one host batch time per step (a CUDA
    event per step only on the card), and the same training as without."""
    from analytics_zoo_tpu_torch.engine.estimator import Estimator

    x, y, df = _classification_frame()
    fitted = []
    for timed in (False, True):
        monkeypatch.setattr(Estimator, "time_steps", timed)
        _, tm = _pair([(16, "relu"), (2, "softmax")], 4, 3)
        fitted.append(tnn.NNClassifier(tm).setBatchSize(32).setMaxEpoch(2)
                      .setOptimMethod(topt.Adam(lr=0.01)).fit(df))
    plain, timed = (m.estimator for m in fitted)
    assert plain.batch_seconds == [] and plain.step_events == []
    assert len(timed.batch_seconds) == len(timed.train_losses) == 6
    assert all(t >= 0 for t in timed.batch_seconds)
    assert timed.step_events == []  # the CPU has no CUDA events
    assert timed.train_losses == plain.train_losses
