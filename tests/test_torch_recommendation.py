"""The PyTorch port's recommendation slice against the JAX package:
``Embedding``/``WordEmbedding``, ``NeuralCF``, ``WideAndDeep``, the
``Recommender`` utilities and ``ZooModel`` persistence.

The port's models take the JAX models' weights leaf by leaf
(``load_jax_params``), then the same numpy inputs go through both.
Tolerances: a forward 1e-6 absolute on probabilities (the same float32
ops; XLA and PyTorch sum the matmuls in other orders); a 2-epoch training
trajectory ``F32_TOL`` = 1e-5 absolute, as ``tests/test_torch_training.py``
holds its trajectories.
"""

import jax
import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch as port
from analytics_zoo_tpu.keras.engine import base as jbase
from analytics_zoo_tpu.keras.engine import topology as jtopo
from analytics_zoo_tpu.keras.layers import Embedding as JEmbedding
from analytics_zoo_tpu.keras.layers import WordEmbedding as JWordEmbedding
from analytics_zoo_tpu.models import recommendation as jrec
from analytics_zoo_tpu_torch.common.tree import tree_leaves
from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.interop import load_jax_params
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts
from analytics_zoo_tpu_torch.keras.engine.topology import Sequential
from analytics_zoo_tpu_torch.keras.layers import Embedding, WordEmbedding
from analytics_zoo_tpu_torch.models import recommendation as trec
from analytics_zoo_tpu_torch.models.common import ZooModel

FWD_TOL = 1e-6
F32_TOL = 1e-5
USERS, ITEMS, CLASSES = 50, 80, 5
COLUMNS = dict(wide_base_dims=[10, 5], wide_cross_dims=[8],
               indicator_dims=[3, 4], embed_in_dims=[20, 30],
               embed_out_dims=[4, 6], continuous_cols=3)


@pytest.fixture(autouse=True)
def _port_context():
    port.init_nncontext(device="cpu")
    yield
    port.stop_nncontext()
    reset_name_counts()


def _pairs(n, seed=0):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(1, USERS + 1, n),
                  rng.integers(1, ITEMS + 1, n)], axis=1).astype(np.int32)
    return x, rng.integers(0, CLASSES, n).astype(np.int32)


def _wnd_inputs(model_type, n=40, seed=1):
    rng = np.random.default_rng(seed)
    info = trec.ColumnFeatureInfo(**COLUMNS)
    wide = (rng.random((n, info.wide_dim)) < 0.2).astype(np.float32)
    ind = (rng.random((n, info.indicator_dim)) < 0.3).astype(np.float32)
    ids = np.stack([rng.integers(1, d + 1, n)
                    for d in COLUMNS["embed_in_dims"]], 1).astype(np.int32)
    cont = rng.normal(size=(n, 3)).astype(np.float32)
    return {"wide": [wide], "deep": [ind, ids, cont],
            "wide_n_deep": [wide, ind, ids, cont]}[model_type]


def _jax_params(jzoo):
    est = jzoo.model._get_estimator()
    est._ensure_state()
    return jax.tree_util.tree_map(np.asarray, est.tstate.params)


def _pair(make):
    """(JAX zoo model, port zoo model with the JAX weights)."""
    jbase.reset_name_counts()
    reset_name_counts()
    jzoo, tzoo = make(jrec), make(trec)
    load_jax_params(tzoo.model, _jax_params(jzoo))
    return jzoo, tzoo


MODELS = {
    "ncf": lambda m: m.NeuralCF(USERS, ITEMS, CLASSES),
    "ncf_no_mf": lambda m: m.NeuralCF(USERS, ITEMS, CLASSES,
                                      hidden_layers=(16, 8),
                                      include_mf=False),
    "wide": lambda m: m.WideAndDeep("wide", CLASSES,
                                    m.ColumnFeatureInfo(**COLUMNS)),
    "deep": lambda m: m.WideAndDeep("deep", CLASSES,
                                    m.ColumnFeatureInfo(**COLUMNS)),
    "wide_n_deep": lambda m: m.WideAndDeep("wide_n_deep", CLASSES,
                                           m.ColumnFeatureInfo(**COLUMNS),
                                           hidden_layers=(12, 6)),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_matches_jax_on_copied_weights(name):
    jzoo, tzoo = _pair(MODELS[name])
    x = _pairs(40)[0] if name.startswith("ncf") else _wnd_inputs(name)
    feed = x if not isinstance(x, list) or len(x) > 1 else x[0]
    want = np.asarray(jzoo.predict(feed, batch_size=16))
    got = tzoo.predict(feed, batch_size=16)
    assert got.shape == (40, CLASSES) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_TOL)
    # serving the same model agrees with predict bitwise
    served = InferenceModel().do_load_keras(tzoo.model).do_predict(feed)
    np.testing.assert_array_equal(served, tzoo.predict(feed, batch_size=40))


def test_ncf_two_epoch_adam_trajectory_matches_jax(tmp_path):
    x, y = _pairs(256, seed=3)
    jzoo, tzoo = _pair(MODELS["ncf"])
    for zoo in (jzoo, tzoo):
        zoo.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    jzoo.set_tensorboard(str(tmp_path), "jax")
    jzoo.fit(x, y, batch_size=64, nb_epoch=2)
    tzoo.fit(x, y, batch_size=64, nb_epoch=2)
    j_losses = [v for _, v in jzoo.model.get_train_summary("Loss")]
    assert len(j_losses) == 8
    np.testing.assert_allclose(tzoo.model._estimator.train_losses, j_losses,
                               rtol=0, atol=F32_TOL)
    j_final = jzoo.model._get_estimator().tstate.params
    for a, b in zip(tree_leaves(tzoo.model.params),
                    tree_leaves(load_jax_params(
                        trec.NeuralCF(USERS, ITEMS, CLASSES).model,
                        j_final)), strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=F32_TOL)
    np.testing.assert_allclose(tzoo.predict(x), np.asarray(jzoo.predict(x)),
                               rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("ids_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("pad_value", [None, 0])
def test_embedding_matches_jax(ids_dtype, pad_value):
    rng = np.random.default_rng(6)
    table = rng.normal(size=(12, 4)).astype(np.float32)
    ids = rng.integers(0, 12, (5, 7)).astype(ids_dtype)
    ids[0, :3] = 0
    jl = JEmbedding(12, 4, weights=table, pad_value=pad_value,
                    input_length=7)
    jl.ensure_built((None, 7))
    want = np.asarray(jl.call({"embeddings": table}, ids))
    tl = Embedding(12, 4, weights=table, pad_value=pad_value, input_length=7)
    net = Sequential([tl])
    net.ensure_params()
    np.testing.assert_array_equal(net.params[tl.name]["embeddings"].numpy(),
                                  table)
    got = tl.call(net.params[tl.name], torch.tensor(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    if pad_value is not None:
        assert not got[0, :3].any()
    # the keras-1 "uniform" init: U(-0.05, 0.05)
    layer = Embedding(100, 8)
    layer.ensure_built((None, 3))
    w = layer.init_params(torch.Generator().manual_seed(0))["embeddings"]
    assert w.shape == (100, 8) and w.abs().max() <= 0.05
    assert w.std() > 0.02


def test_word_embedding_from_glove_matches_jax(tmp_path):
    glove = tmp_path / "glove.txt"
    glove.write_text("the 0.1 0.2 0.3\ncat -1.0 0.5 2.0\nsat 3.0 -0.25 1.5\n",
                     encoding="utf-8")
    index = WordEmbedding.get_word_index(str(glove))
    assert index == JWordEmbedding.get_word_index(str(glove)) == {
        "the": 1, "cat": 2, "sat": 3}
    word_index = {"cat": 1, "dog": 2, "sat": 4}
    tl = WordEmbedding.from_glove(str(glove), word_index, input_length=3)
    jl = JWordEmbedding.from_glove(str(glove), word_index, input_length=3)
    np.testing.assert_array_equal(tl.pretrained, jl.pretrained)
    assert tl.pretrained.shape == (5, 3) and not tl.pretrained[2].any()
    assert tl.trainable is False
    net = Sequential([tl])
    net.ensure_params()
    out = net.apply(net.params, {}, torch.tensor([[1, 4, 0]]))[0]
    np.testing.assert_array_equal(out[0].numpy(), jl.pretrained[[1, 4, 0]])


def test_recommender_utilities_match_jax():
    jzoo, tzoo = _pair(MODELS["ncf"])
    x, _ = _pairs(30, seed=8)
    jp, tp = jzoo.predict_user_item_pair(x), tzoo.predict_user_item_pair(x)
    assert [(p.user_id, p.item_id, p.prediction) for p in tp] == [
        (p.user_id, p.item_id, p.prediction) for p in jp]
    np.testing.assert_allclose([p["probability"] for p in tp],
                               [p.probability for p in jp], rtol=0,
                               atol=FWD_TOL)
    assert tp[0].keys() == jp[0].keys() and "probability" in tp[0]
    records = [trec.UserItemFeature(int(u), int(i)) for u, i in x[:4]]
    assert [p.item_id for p in tzoo.predict_user_item_pair(records)] == [
        int(i) for i in x[:4, 1]]
    for fn in ("recommend_for_user", "recommend_for_item"):
        want, got = getattr(jzoo, fn)(x, 3), getattr(tzoo, fn)(x, 3)
        assert {k: [(p.user_id, p.item_id) for p in v]
                for k, v in got.items()} == {
            k: [(p.user_id, p.item_id) for p in v] for k, v in want.items()}
    assert tzoo.predict_user_item_pair(np.zeros((0, 2), np.int32)) == []


def test_save_model_load_model_is_bitwise(tmp_path):
    x, y = _pairs(128, seed=4)
    zoo = trec.WideAndDeep("wide_n_deep", CLASSES,
                           trec.ColumnFeatureInfo(**COLUMNS))
    feed = _wnd_inputs("wide_n_deep", n=128)
    zoo.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    zoo.fit(feed, y, batch_size=32, nb_epoch=1)
    before = zoo.predict(feed)
    zoo.save_model(str(tmp_path / "wnd"))
    loaded = ZooModel.load_model(str(tmp_path / "wnd"))
    assert isinstance(loaded, trec.WideAndDeep)
    assert loaded.column_info == zoo.column_info
    np.testing.assert_array_equal(loaded.predict(feed), before)
    ncf = trec.NeuralCF(USERS, ITEMS, CLASSES)
    ncf.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    ncf.fit(x, y, batch_size=32, nb_epoch=1)
    ncf.save_model(str(tmp_path / "ncf"))
    again = ZooModel.load_model(str(tmp_path / "ncf"))
    np.testing.assert_array_equal(again.predict(x), ncf.predict(x))


def test_jax_saved_neural_cf_loads_into_the_port(tmp_path):
    jbase.reset_name_counts()
    jzoo = jrec.NeuralCF(USERS, ITEMS, CLASSES)
    x, y = _pairs(128, seed=5)
    jzoo.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    jzoo.fit(x, y, batch_size=32, nb_epoch=1)
    jzoo.save_model(str(tmp_path))
    loaded = ZooModel.load_model(str(tmp_path))
    assert isinstance(loaded, trec.NeuralCF)
    np.testing.assert_allclose(loaded.predict(x),
                               np.asarray(jzoo.predict(x)), rtol=0,
                               atol=FWD_TOL)


@pytest.mark.parametrize("call", [
    # SessionRecommender and Ranker's MAP/NDCG are ported
    # (tests/test_torch_ranking_zoo.py, tests/test_torch_training_surface.py),
    # the regularizers (tests/test_torch_regularizers.py) and predict_image
    # over an ImageSet (tests/test_torch_predictor_images.py); serving a
    # recommender from a persistent executable cache is not: the port
    # keeps none
    lambda: InferenceModel().do_load_keras(
        trec.NeuralCF(USERS, ITEMS, CLASSES).model).set_aot_cache("aot")])
def test_unported_parts_raise(call):
    with pytest.raises(NotImplementedError):
        call()


def test_jax_topology_has_the_same_layers():
    """The port builds the recommenders layer for layer as the JAX package
    does: the same explicit names and the same parameter shapes."""
    for name, make in MODELS.items():
        jbase.reset_name_counts()
        reset_name_counts()
        jzoo, tzoo = make(jrec), make(trec)
        jshapes = sorted((k, tuple(s.shape)) for l in jzoo.model.layers()
                         for k, s in [(l.name, w) for w in l.weight_specs])
        tshapes = sorted((k, tuple(s.shape)) for l in tzoo.model.layers()
                         for k, s in [(l.name, w) for w in l.weight_specs])
        assert tshapes == jshapes, name
        assert isinstance(jzoo.model, jtopo.Model)
