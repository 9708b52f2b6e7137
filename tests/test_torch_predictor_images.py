"""``Predictor`` over an ``ImageSet`` and the ``Predictable`` mixin in the
port, against the JAX package: the same small CNN (weights carried leaf by
leaf) over the same seeded uint8 images through the same transform chain.
``predict`` and ``predict_classes`` materialise the ImageSet;
``predict_image`` attaches each row to its ``ImageFeature`` under
``predict_key``, and ``output_layer`` cuts the graph through
``Model.new_graph``. Float32 outputs agree with JAX's within ``TOL``.
"""

import numpy as np
import pytest

import analytics_zoo_tpu as zoo
import analytics_zoo_tpu_torch as port
from analytics_zoo_tpu import predictor as jpred
from analytics_zoo_tpu.data import image_set as jis
from analytics_zoo_tpu.keras.engine import topology as jtopo
from analytics_zoo_tpu.keras import layers as jlayers
from analytics_zoo_tpu_torch import predictor as tpred
from analytics_zoo_tpu_torch.data import image_set as tis
from analytics_zoo_tpu_torch.interop import load_jax_params
from analytics_zoo_tpu_torch.keras import layers as tlayers
from analytics_zoo_tpu_torch.keras.engine import topology as ttopo
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts

TOL = 1e-5  # float32 probabilities and features, XLA against PyTorch


@pytest.fixture(autouse=True)
def _ctx():
    zoo.init_nncontext()
    port.init_nncontext(device="cpu")
    yield
    port.stop_nncontext()
    reset_name_counts()


def _cnn(topo, L, two_heads=False):
    inp = topo.Input(shape=(12, 12, 3), name="img")
    h = L.Convolution2D(4, 3, 3, activation="relu", dim_ordering="tf",
                        name="conv")(inp)
    pool = L.GlobalAveragePooling2D(dim_ordering="tf", name="pool")(h)
    out = L.Dense(3, activation="softmax", name="fc")(pool)
    return topo.Model(inp, [out, pool] if two_heads else out, name="cnn")


def _pair(two_heads=False):
    jm, tm = _cnn(jtopo, jlayers, two_heads), _cnn(ttopo, tlayers, two_heads)
    jm.predict(np.zeros((8, 12, 12, 3), np.float32), batch_size=8)
    load_jax_params(tm, jm.get_weights())
    return jm, tm


def _images(mod, n=12):
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (n, 12, 12, 3)).astype(np.uint8)
    s = mod.ImageSet.from_arrays(imgs, rng.integers(0, 3, n))
    return s.transform(mod.ImageChannelNormalize(120.0, 110.0, 100.0,
                                                 60.0, 58.0, 57.0))


def test_predict_and_predict_classes_over_an_image_set():
    jm, tm = _pair()
    tp, jp = tpred.Predictor(tm), jpred.Predictor(jm)
    got = tp.predict(_images(tis), batch_size=8)
    want = np.asarray(jp.predict(_images(jis), batch_size=8))
    assert got.shape == (12, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # an ImageSet and its materialised arrays give the same rows
    x = _images(tis).to_feature_set().xs[0]
    np.testing.assert_array_equal(tp.predict(x, batch_size=8), got)
    for zero_based in (True, False):
        cls = tp.predict_classes(_images(tis), batch_size=8,
                                 zero_based_label=zero_based)
        np.testing.assert_array_equal(
            cls, jp.predict_classes(_images(jis), batch_size=8,
                                    zero_based_label=zero_based))
        np.testing.assert_array_equal(cls, got.argmax(-1) + (not zero_based))


@pytest.mark.parametrize("output_layer", [None, "pool"])
def test_predict_image_attaches_rows_to_features(output_layer):
    jm, tm = _pair()
    ts = tpred.Predictor(tm).predict_image(
        _images(tis), output_layer=output_layer, batch_size=8,
        predict_key="out")
    js = jpred.Predictor(jm).predict_image(
        _images(jis), output_layer=output_layer, batch_size=8,
        predict_key="out")
    rows = np.stack([f["out"] for f in ts.features])
    assert rows.shape == ((12, 3) if output_layer is None else (12, 4))
    np.testing.assert_allclose(
        rows, np.stack([f["out"] for f in js.features]), rtol=0, atol=TOL)
    want = (tm if output_layer is None else tm.new_graph(output_layer))
    np.testing.assert_array_equal(
        rows, want.predict(_images(tis).to_feature_set(), batch_size=8))
    assert all("predict" not in f for f in ts.features)


def test_predictable_mixin_and_wrappers():
    _, tm = _pair()

    class Wrapper(tpred.Predictable):  # a ZooModel-like wrapper
        def __init__(self, model):
            self.model = model

    s = Wrapper(tm).predict_image(_images(tis), output_layer="pool",
                                  batch_size=8)
    np.testing.assert_array_equal(
        np.stack([f["predict"] for f in s.features]),
        tm.new_graph("pool").predict(_images(tis).to_feature_set(),
                                     batch_size=8))
    assert tpred.Predictor(Wrapper(tm)).model is tm


def test_predict_image_refuses_what_jax_refuses():
    _, two = _pair(two_heads=True)
    with pytest.raises(ValueError, match="single-output"):
        tpred.Predictor(two).predict_image(_images(tis), batch_size=8)
    seq = ttopo.Sequential()
    seq.add(tlayers.Flatten(input_shape=(12, 12, 3)))
    with pytest.raises(ValueError, match="GraphNet"):
        tpred.Predictor(seq).predict_image(_images(tis), output_layer="x")
