"""The port's ranking and data zoo against the JAX package, on the CPU:

- ``data/text_set.py``: the text pipeline (CSV and directory readers,
  tokenize, normalize, word2idx, shape_sequence, arrays), ``Relations``
  and ``generate_relation_pairs`` (the same pair order for a seed),
  ``from_relation_pairs`` and ``from_relation_lists``;
- ``PairFeatureSet``: ``batches`` and ``train_batches`` rows and masks
  equal to JAX's (pair-unit shuffling, a tail padded by pairs with both
  members masked, process windows, and the odd-window, odd-batch and
  ``cache_device`` refusals); ``FeatureSet.batches`` and
  ``TransformedFeatureSet``;
- ``KNRM``: the forward (the trainable and the ``WordEmbedding`` routes),
  one shared embedding leaf, a 3-step ``rank_hinge`` trajectory over a
  ``PairFeatureSet`` made by ``TextSet.from_relation_pairs``, MAP and
  NDCG, ``config``/save/load;
- ``AnomalyDetector``: ``unroll``, ``unroll_indexed``,
  ``detect_anomalies``, the forward and a 3-step trajectory;
- ``SessionRecommender``: both graphs' forwards, ``recommend_for_session``
  and a 3-step trajectory with history, save/load;
- tfpark's ``BERTClassifier`` through ``TFEstimator`` at a tiny config:
  3 train steps and ``predict``.

Weights are carried from the JAX models by ``load_jax_params``; inputs
come from a numpy seed; dropout is 0 on both sides. Tolerances, absolute,
f32: forwards 1e-6 (KNRM's exact-match kernel, sigma 0.001, amplifies a
cosine's rounding by up to (m - mu) / sigma^2; measured below 1e-7 here);
3-step trajectories 1e-5 on losses, parameters and predictions, as the
other trajectory tests. Batches, masks, pairs and rankings exactly.
"""

import jax
import numpy as np
import pytest

import analytics_zoo_tpu_torch as port
from analytics_zoo_tpu.data import feature_set as jfs
from analytics_zoo_tpu.data import text_set as jts
from analytics_zoo_tpu.keras.engine import base as jbase
from analytics_zoo_tpu.keras.optimizers import Adam as JAdam
from analytics_zoo_tpu.models import anomalydetection as jad
from analytics_zoo_tpu.models import recommendation as jrec
from analytics_zoo_tpu.models import textmatching as jtm
from analytics_zoo_tpu.tfpark import bert as jbert
from analytics_zoo_tpu.tfpark import tf_dataset as jtfd
from analytics_zoo_tpu_torch import data as tdata
from analytics_zoo_tpu_torch import models as tmodels
from analytics_zoo_tpu_torch.common.tree import tree_leaves
from analytics_zoo_tpu_torch.data import feature_set as tfs
from analytics_zoo_tpu_torch.data import text_set as tts
from analytics_zoo_tpu_torch.interop import load_jax_params
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts
from analytics_zoo_tpu_torch.keras.optimizers import Adam
from analytics_zoo_tpu_torch.models import anomalydetection as tad
from analytics_zoo_tpu_torch.models import recommendation as trec
from analytics_zoo_tpu_torch.models import textmatching as ttm
from analytics_zoo_tpu_torch.models.common import ZooModel
from analytics_zoo_tpu_torch.tfpark import bert as tbert
from analytics_zoo_tpu_torch.tfpark import tf_dataset as ttfd

FWD_TOL = 1e-6
F32_TOL = 1e-5
Q_LEN, D_LEN, EMBED, VOCAB_WORDS = 5, 8, 8, 40


@pytest.fixture(autouse=True)
def _port_context():
    port.init_nncontext(device="cpu")
    yield
    port.stop_nncontext()
    reset_name_counts()


def _jax_params(jnet):
    est = jnet._get_estimator()
    est._ensure_state()
    return jax.tree_util.tree_map(np.asarray, est.tstate.params)


def _pair(make_j, make_t):
    jbase.reset_name_counts()
    reset_name_counts()
    jz, tz = make_j(), make_t()
    load_jax_params(tz.model, _jax_params(jz.model))
    return jz, tz


def _same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, (list, tuple)):
                for u, v in zip(a, b, strict=True):
                    np.testing.assert_array_equal(u, v)
            else:
                np.testing.assert_array_equal(a, b)


def _assert_params_close(net, jparams, make_t):
    jbase.reset_name_counts()
    reset_name_counts()
    final = load_jax_params(make_t().model, jparams)
    for a, b in zip(tree_leaves(net.params), tree_leaves(final),
                    strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=F32_TOL)


def _fit_both(jz, tz, x, y, loss, tmp_path, batch=8):
    """compile(Adam(0.01), loss) and one epoch of fit in both packages;
    returns the JAX per-step losses (the port's are held to them here)."""
    jz.compile(optimizer=JAdam(lr=0.01), loss=loss)
    tz.compile(optimizer=Adam(lr=0.01), loss=loss)
    jz.model.set_tensorboard(str(tmp_path), "jax")
    jz.fit(x, y, batch_size=batch, nb_epoch=1)
    tz.fit(x, y, batch_size=batch, nb_epoch=1)
    j_losses = [v for _, v in jz.model.get_train_summary("Loss")]
    np.testing.assert_allclose(tz.model._estimator.train_losses, j_losses,
                               rtol=0, atol=F32_TOL)
    return j_losses


# ---------------------------------------------------------------------------
# TextSet, relations, PairFeatureSet
# ---------------------------------------------------------------------------


def _corpus(tmp_path, n_q=10, n_d=40, seed=0):
    """A question CSV, an answer CSV and relations: per question 1
    positive and 3 negative answers (ids as the qaranker recipe's)."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(VOCAB_WORDS)]

    def text(n):
        return " ".join(rng.choice(words, n)) + ("." if n % 2 else ",")

    q_csv, d_csv = tmp_path / "q.csv", tmp_path / "a.csv"
    q_csv.write_text("".join(f"Q{i},{text(rng.integers(2, 8))}\n"
                             for i in range(n_q)))
    d_csv.write_text("".join(f"D{i},{text(rng.integers(3, 12))}\n"
                             for i in range(n_d)))
    rel_csv = tmp_path / "rel.csv"
    rows = ["id1,id2,label"]
    for q in range(n_q):
        docs = rng.choice(n_d, 4, replace=False)
        rows += [f"Q{q},D{docs[0]},1"] + [f"Q{q},D{d},0" for d in docs[1:]]
    rel_csv.write_text("\n".join(rows) + "\n")
    return q_csv, d_csv, rel_csv


def _texts(mod, q_csv, d_csv):
    q = mod.TextSet.read_csv(str(q_csv)).tokenize().normalize()
    q = q.word2idx(min_freq=1).shape_sequence(Q_LEN)
    d = mod.TextSet.read_csv(str(d_csv)).tokenize().normalize()
    d = d.word2idx(existing_map=q.get_word_index()).shape_sequence(
        D_LEN, trunc_mode="post")
    return q, d


def test_text_set_pipeline_matches_jax(tmp_path):
    q_csv, d_csv, rel_csv = _corpus(tmp_path)
    (jq, jd), (tq, td) = _texts(jts, q_csv, d_csv), _texts(tts, q_csv, d_csv)
    assert tq.get_word_index() == jq.get_word_index()
    for j, t in ((jq, tq), (jd, td)):
        assert [dict(f) for f in t.features] == [dict(f) for f in j.features]
        np.testing.assert_array_equal(t.to_arrays()[0], j.to_arrays()[0])
    # a labelled corpus from a directory of class folders
    for c, body in (("neg", "Bad, awful! movie"), ("pos", "good film")):
        (tmp_path / "dir" / c).mkdir(parents=True)
        (tmp_path / "dir" / c / "a.txt").write_text(body)
    tset = tts.TextSet.read(str(tmp_path / "dir")).tokenize().normalize()
    jset = jts.TextSet.read(str(tmp_path / "dir")).tokenize().normalize()
    tx, ty = tset.word2idx().shape_sequence(4).to_arrays()
    jx, jy = jset.word2idx().shape_sequence(4).to_arrays()
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)
    fs = tset.to_feature_set()
    assert isinstance(fs, tfs.ArrayFeatureSet) and fs.num_samples == 2
    rels = tts.Relations.read(str(rel_csv))
    assert rels == [tts.Relation(r.id1, r.id2, r.label)
                    for r in jts.Relations.read(str(rel_csv))]
    for seed in range(3):
        tp = tts.Relations.generate_relation_pairs(rels, seed=seed)
        jp = jts.generate_relation_pairs(jts.read_relations(str(rel_csv)),
                                         seed=seed)
        assert [(p.id2, n.id2) for p, n in tp] == [(p.id2, n.id2)
                                                  for p, n in jp]
    tpairs = tts.TextSet.from_relation_pairs(rels, tq, td, seed=1)
    jpairs = jts.TextSet.from_relation_pairs(
        jts.read_relations(str(rel_csv)), jq, jd, seed=1)
    assert isinstance(tpairs, tfs.PairFeatureSet)
    for a, b in zip(tpairs.xs + tpairs.ys, jpairs.xs + jpairs.ys,
                    strict=True):
        np.testing.assert_array_equal(a, b)
    tl = tts.TextSet.from_relation_lists(rels, tq, td)
    jl = jts.TextSet.from_relation_lists(jts.read_relations(str(rel_csv)),
                                         jq, jd)
    assert len(tl) == len(jl) == 10
    for g, w in zip(tl, jl):
        for a, b in zip(g, w, strict=True):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("batch,window", [(4, None), (6, None), (8, None),
                                          (8, (2, 6)), (12, (0, 4))])
def test_pair_feature_set_batches_match_jax(batch, window):
    """22 rows (11 pairs): every batch size leaves a tail; rows, masks and
    windows equal to JAX's for three shuffle seeds and in order."""
    rng = np.random.default_rng(4)
    x = [rng.integers(0, 9, (22, 3)), rng.integers(0, 9, (22, 5))]
    y = rng.standard_normal(22).astype(np.float32)
    jset, tset = jfs.PairFeatureSet(x, y), tfs.PairFeatureSet(x, y)
    for shuffle, seed in ((False, 0), (True, 0), (True, 1), (True, 5)):
        _same_batches(tset.train_batches(batch, shuffle, seed, window),
                      jset.train_batches(batch, shuffle, seed, window))
        _same_batches(tset.batches(batch, shuffle, seed, window=window),
                      jset.batches(batch, shuffle, seed, window=window))
        _same_batches(tset.batches(batch, shuffle, seed, True, window),
                      jset.batches(batch, shuffle, seed, True, window))
    *_, (_, _, tail) = tset.train_batches(8, True, 3)
    assert tail.tolist() == [1, 1, 1, 1, 1, 1, 0, 0]  # whole pairs masked


def test_pair_feature_set_refusals():
    x = np.arange(12).reshape(6, 2)
    tset = tfs.PairFeatureSet(x, np.zeros(6, np.float32))
    with pytest.raises(ValueError, match="even number of rows"):
        tfs.PairFeatureSet(x[:5])
    with pytest.raises(ValueError, match="batch_size must be even"):
        next(tset.train_batches(5))
    with pytest.raises(ValueError, match="batch_size must be even"):
        next(tset.batches(3))
    with pytest.raises(ValueError, match="splits a"):
        next(tset.train_batches(4, window=(1, 3)))
    with pytest.raises(NotImplementedError, match="interleaving"):
        tset.cache_device()
    assert tdata.PairFeatureSet is tfs.PairFeatureSet


def test_feature_set_batches_and_transform_match_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((13, 3)).astype(np.float32)
    y = rng.integers(0, 3, 13).astype(np.int32)
    jset, tset = jfs.ArrayFeatureSet(x, y), tfs.ArrayFeatureSet(x, y)
    for kw in (dict(shuffle=False), dict(seed=2), dict(seed=2, start_step=1),
               dict(seed=1, drop_remainder=True), dict(seed=1,
                                                       window=(1, 3))):
        _same_batches(tset.batches(4, **kw), jset.batches(4, **kw))

    def fn(a, b):
        return a * 2.0, b + 1

    tt, jt = tset >> fn, jset.transform(fn)
    assert isinstance(tt, tfs.TransformedFeatureSet)
    assert tt.num_samples == 13 and tdata.TransformedFeatureSet is type(tt)
    _same_batches(tt.train_batches(4, seed=3), jt.train_batches(4, seed=3))
    _same_batches(tt.eval_batches(4), jt.eval_batches(4))


# ---------------------------------------------------------------------------
# KNRM
# ---------------------------------------------------------------------------


def _knrm(mod, embedding=EMBED):
    return lambda: mod.KNRM(Q_LEN, D_LEN, embedding=embedding,
                            vocab_size=VOCAB_WORDS + 1)


def _ranking_data(tmp_path):
    q_csv, d_csv, rel_csv = _corpus(tmp_path)
    tq, td = _texts(tts, q_csv, d_csv)
    rels = tts.Relations.read(str(rel_csv))
    return (tts.TextSet.from_relation_pairs(rels, tq, td, seed=0),
            tts.TextSet.from_relation_lists(rels, tq, td))


def _ranked(zoo, lists):
    return [(np.asarray(zoo.predict([q, d], batch_size=8)).ravel(), labels)
            for q, d, labels in lists]


def test_knrm_forward_matches_jax(tmp_path):
    jz, tz = _pair(_knrm(jtm), _knrm(ttm))
    assert isinstance(tz, tmodels.KNRM) and isinstance(tz, ttm.TextMatcher)
    # one embedding leaf, used by the query and the document
    assert [l.name for l in tz.model.layers()].count("shared_embed") == 1
    pairs, _ = _ranking_data(tmp_path)
    x = pairs.xs
    x[1][0, :3] = x[0][0, :3]  # exact matches: the sigma 0.001 kernel
    want = np.asarray(jz.predict(x, batch_size=8))
    got = tz.predict(x, batch_size=8)
    assert got.shape == (20, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_TOL)


def test_knrm_word_embedding_route_and_persistence(tmp_path):
    emb = np.random.default_rng(8).standard_normal(
        (VOCAB_WORDS + 1, 6)).astype(np.float32)
    jz, tz = _pair(_knrm(jtm, emb), _knrm(ttm, emb))
    spec = tz.model.param_specs()["shared_embed"]["embeddings"]
    assert spec.trainable is False and spec.shape == emb.shape
    pairs, _ = _ranking_data(tmp_path)
    want = np.asarray(jz.predict(pairs.xs, batch_size=8))
    np.testing.assert_allclose(tz.predict(pairs.xs, batch_size=8), want,
                               rtol=0, atol=FWD_TOL)
    assert tz.config() == jz.config()
    tz.save_model(str(tmp_path / "knrm"))
    back = ZooModel.load_model(str(tmp_path / "knrm"))
    assert back.config() == tz.config()
    np.testing.assert_array_equal(back.predict(pairs.xs, batch_size=8),
                                  tz.predict(pairs.xs, batch_size=8))


def test_knrm_rank_hinge_trajectory_and_ranking_match_jax(tmp_path):
    """RankHinge over the PairFeatureSet from TextSet.from_relation_pairs
    (10 pairs at batch 8: 3 steps, the last with 2 padded pairs masked):
    per-step losses, final parameters (one shared embedding leaf), the
    scores, MAP and NDCG@3 on the relation lists."""
    jz, tz = _pair(_knrm(jtm), _knrm(ttm))
    pairs, lists = _ranking_data(tmp_path)
    jpairs = jfs.PairFeatureSet(pairs.xs, pairs.ys[0])
    before = tz.evaluate_map(_ranked(tz, lists))
    jz.compile(optimizer=JAdam(lr=0.01), loss="rank_hinge")
    tz.compile(optimizer=Adam(lr=0.01), loss="rank_hinge")
    jz.model.set_tensorboard(str(tmp_path), "jax")
    jz.fit(jpairs, batch_size=8, nb_epoch=1)
    tz.fit(pairs, batch_size=8, nb_epoch=1)
    j_losses = [v for _, v in jz.model.get_train_summary("Loss")]
    assert len(j_losses) == 3
    np.testing.assert_allclose(tz.model._estimator.train_losses, j_losses,
                               rtol=0, atol=F32_TOL)
    _assert_params_close(tz.model, _jax_params(jz.model), _knrm(ttm))
    jr, tr = _ranked(jz, lists), _ranked(tz, lists)
    for (a, _), (b, _) in zip(tr, jr):
        np.testing.assert_allclose(a, b, rtol=0, atol=F32_TOL)
    assert tz.evaluate_map(tr) == pytest.approx(jz.evaluate_map(jr),
                                                abs=1e-12)
    assert tz.evaluate_ndcg(tr, k=3) == pytest.approx(
        jz.evaluate_ndcg(jr, k=3), abs=1e-12)
    assert 0.0 <= before <= 1.0


# ---------------------------------------------------------------------------
# AnomalyDetector
# ---------------------------------------------------------------------------


def _detector(mod):
    return lambda: mod.AnomalyDetector((6, 2), hidden_layers=(4, 6, 3),
                                       dropouts=(0.0, 0.0, 0.0))


def _series(n=50, seed=9):
    t = np.arange(n)
    rng = np.random.default_rng(seed)
    s = np.stack([np.sin(t / 4.0), np.cos(t / 7.0)], 1)
    s = (s + 0.05 * rng.standard_normal(s.shape)).astype(np.float32)
    s[[17, 33], 0] += 3.0  # planted anomalies
    return s


def test_anomaly_detector_utilities_match_jax():
    s = _series()
    for step in (1, 3):
        tx, ty = tad.AnomalyDetector.unroll(s, 6, step)
        jx, jy = jad.AnomalyDetector.unroll(s, 6, step)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    tx1, _ = tad.AnomalyDetector.unroll(s[:, 0], 5)
    np.testing.assert_array_equal(tx1, jad.AnomalyDetector.unroll(
        s[:, 0], 5)[0])
    recs = tad.AnomalyDetector.unroll_indexed(s, 6)
    jrecs = jad.AnomalyDetector.unroll_indexed(s, 6)
    assert [(r.label, r.index) for r in recs] == [(r.label, r.index)
                                                  for r in jrecs]
    np.testing.assert_array_equal(recs[3].feature, jrecs[3].feature)
    det = tad.AnomalyDetector((6, 2))
    rng = np.random.default_rng(1)
    yt, yp = rng.standard_normal(40), rng.standard_normal(40)
    yp[7] = yt[7] + 9.0
    got = det.detect_anomalies(yt, yp, 4)
    assert got == jad.AnomalyDetector((6, 2)).detect_anomalies(yt, yp, 4)
    assert got[0] == 7
    assert det.config() == jad.AnomalyDetector((6, 2)).config()


def test_anomaly_detector_forward_and_trajectory_match_jax(tmp_path):
    jz, tz = _pair(_detector(jad), _detector(tad))
    x, y = tad.AnomalyDetector.unroll(_series(), 6)
    x, y = x[:24], y[:24]
    np.testing.assert_allclose(tz.predict(x, batch_size=8),
                               np.asarray(jz.predict(x, batch_size=8)),
                               rtol=0, atol=FWD_TOL)
    _fit_both(jz, tz, x, y, "mse", tmp_path)
    _assert_params_close(tz.model, _jax_params(jz.model), _detector(tad))
    np.testing.assert_allclose(tz.predict(x, batch_size=8),
                               np.asarray(jz.predict(x, batch_size=8)),
                               rtol=0, atol=F32_TOL)


# ---------------------------------------------------------------------------
# SessionRecommender
# ---------------------------------------------------------------------------

ITEMS = 30


def _session_model(mod, history):
    return lambda: mod.SessionRecommender(
        ITEMS, item_embed=8, rnn_hidden_layers=(8, 6), session_length=5,
        include_history=history, mlp_hidden_layers=(8, 6), his_length=4)


def _sessions(n, history, seed=10):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, ITEMS + 1, (n, 5)).astype(np.int32)
    s[:, :2] *= rng.integers(0, 2, (n, 1))  # some left padding
    x = [s, rng.integers(1, ITEMS + 1, (n, 4)).astype(np.int32)] \
        if history else s
    return x, rng.integers(1, ITEMS + 1, n).astype(np.int32)


@pytest.mark.parametrize("history", [False, True])
def test_session_recommender_matches_jax(history):
    jz, tz = _pair(_session_model(jrec, history),
                   _session_model(trec, history))
    names = {l.name for l in tz.model.layers()}
    assert "session_embed" in names
    assert ("history_embed" in names) is history
    x, _ = _sessions(20, history)
    want = np.asarray(jz.predict(x, batch_size=8))
    got = tz.predict(x, batch_size=8)
    assert got.shape == (20, ITEMS + 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_TOL)
    rec = tz.recommend_for_session(x, max_items=4, batch_size=8)
    jrec_ = jz.recommend_for_session(x, max_items=4, batch_size=8)
    assert [[i for i, _ in r] for r in rec] == [[i for i, _ in r]
                                               for r in jrec_]
    for r, w in zip(rec, jrec_):
        assert all(i != 0 for i, _ in r)
        np.testing.assert_allclose([p for _, p in r], [p for _, p in w],
                                   rtol=0, atol=FWD_TOL)


def test_session_recommender_trajectory_and_save_load(tmp_path):
    make_t = _session_model(trec, True)
    jz, tz = _pair(_session_model(jrec, True), make_t)
    x, y = _sessions(24, True, seed=11)
    _fit_both(jz, tz, x, y, "sparse_categorical_crossentropy", tmp_path)
    _assert_params_close(tz.model, _jax_params(jz.model), make_t)
    tz.save_model(str(tmp_path / "sr"))
    back = ZooModel.load_model(str(tmp_path / "sr"))
    assert isinstance(back, trec.SessionRecommender)
    np.testing.assert_array_equal(back.predict(x, batch_size=8),
                                  tz.predict(x, batch_size=8))


# ---------------------------------------------------------------------------
# tfpark BERTClassifier
# ---------------------------------------------------------------------------

BERT_CFG = dict(vocab=64, hidden_size=16, n_block=1, n_head=2, seq_len=16,
                intermediate_size=32, hidden_drop=0.0, attn_drop=0.0)


def _bert_rows(n=24, seed=12):
    rng = np.random.default_rng(seed)
    lens = rng.integers(4, 17, n)
    mask = (np.arange(16)[None] < lens[:, None]).astype(np.float32)
    ids = (rng.integers(1, 64, (n, 16)) * mask).astype(np.int32)
    return [ids, np.zeros_like(ids), mask], rng.integers(0, 3, n).astype(
        np.int32)


def test_bert_classifier_estimator_matches_jax(tmp_path):
    """BERTClassifier -> TFEstimator -> BERTClassifierNet in f32 (the
    default compute dtype switched off on both sides), the JAX weights
    carried in: 3 train steps (Adam 1e-3) and predict."""
    jtfe = jbert.BERTClassifier(3, BERT_CFG, optimizer=JAdam(lr=1e-3))
    ttfe = tbert.BERTClassifier(3, BERT_CFG, optimizer=Adam(lr=1e-3))
    jnet, tnet = jtfe._build("train").model, ttfe._build("train").model
    jnet.compute_dtype = tnet.compute_dtype = None
    jest_ = jtfe._engine()
    jest_._ensure_state()
    load_jax_params(tnet, jax.tree_util.tree_map(np.asarray,
                                                 jest_.tstate.params))
    jest_.set_tensorboard(str(tmp_path), "jax")
    x, y = _bert_rows()
    jtfe.train(lambda: jtfd.TFDataset.from_ndarrays((x, y), batch_size=8),
               steps=3)
    ttfe.train(lambda: ttfd.TFDataset.from_ndarrays((x, y), batch_size=8),
               steps=3)
    j_losses = [v for _, v in jest_.train_summary.read_scalar("Loss")]
    assert len(j_losses) == 3
    np.testing.assert_allclose(ttfe._engine().train_losses, j_losses,
                               rtol=0, atol=F32_TOL)
    want = np.asarray(jtfe.predict(
        lambda: jtfd.TFDataset.from_ndarrays(x, batch_size=8)))
    got = ttfe.predict(lambda: ttfd.TFDataset.from_ndarrays(x,
                                                            batch_size=8))
    assert got.shape == (24, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
