"""The port's text model family against the JAX package: the 1-D
convolution and pooling layers, ``TextClassifier`` (cnn, lstm and gru
encoders, the trainable and the ``WordEmbedding`` routes) and ``Seq2seq``
(teacher forcing, greedy ``infer``, beam search, the sequence-serving
primitives), their training trajectories and their persistence.

Weights are carried from the JAX models by ``load_jax_params``; inputs
come from a numpy seed; small sizes (vocab <= 32, hidden <= 16).
Tolerances, absolute: forwards 1e-6 on probabilities and logits (the same
float32 ops, matmuls summed in other orders; measured at most 2.4e-7); a
3-step training trajectory 1e-5 on losses, parameters and predictions, as
``tests/test_torch_training.py`` holds its trajectories. Dropout is off
(``p = 0`` on both sides) where a trajectory is compared: the two packages
draw their masks from different generators.

Greedy tokens are compared across the packages only where the JAX logits'
top-2 gap exceeds ``TIE_GAP``: at a near-tie the two frameworks' float32
matmuls may pick different argmaxes. Inside the port, tokens are held
exactly (the stepwise decode test, as the JAX package's own).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch as port
from analytics_zoo_tpu.keras import layers as JL
from analytics_zoo_tpu.keras.engine import base as jbase
from analytics_zoo_tpu.keras.optimizers import Adam as JAdam
from analytics_zoo_tpu.models import seq2seq as js2s
from analytics_zoo_tpu.models import textclassification as jtc
from analytics_zoo_tpu_torch.common.tree import tree_leaves
from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.interop import load_jax_params
from analytics_zoo_tpu_torch.keras import layers as TL
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts
from analytics_zoo_tpu_torch.keras.optimizers import Adam
from analytics_zoo_tpu_torch.models import seq2seq as ts2s
from analytics_zoo_tpu_torch.models import textclassification as ttc
from analytics_zoo_tpu_torch.models.common import ZooModel

FWD_TOL = 1e-6
F32_TOL = 1e-5
TIE_GAP = 1e-5  # ten times the logits' tolerance
VOCAB, SEQ, EMBED, ENC, CLASSES = 30, 12, 8, 8, 3


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


def _pair(make):
    """(JAX zoo model, port zoo model with the JAX weights)."""
    jbase.reset_name_counts()
    reset_name_counts()
    jzoo, tzoo = make(jtc, js2s), make(ttc, ts2s)
    load_jax_params(tzoo.model, _jax_params(jzoo.model))
    return jzoo, tzoo


def _no_dropout(*zoos):
    for zoo in zoos:
        for layer in zoo.model.layers():
            if type(layer).__name__ == "Dropout":
                layer.p = 0.0


# -- 1-D convolution and pooling ---------------------------------------------


def _layer_pair(jl, tl, shape, x):
    jl.ensure_built(shape)
    tl.ensure_built(shape)
    jp = jl.init_params(jax.random.PRNGKey(0))
    tp = load_jax_params(tl, jax.tree_util.tree_map(np.asarray, jp))
    xs = x if isinstance(x, list) else [x]
    want = np.asarray(jl.call(jp, [jnp.asarray(a) for a in xs]
                              if isinstance(x, list) else jnp.asarray(x)))
    got = tl.call(tp, [torch.tensor(a) for a in xs]
                  if isinstance(x, list) else torch.tensor(x)).numpy()
    assert tl.compute_output_shape(shape) == jl.compute_output_shape(shape)
    return got, want


CONV1D = [dict(), dict(border_mode="same"), dict(subsample_length=2),
          dict(border_mode="same", subsample_length=2, activation="relu"),
          dict(dim_ordering="th"), dict(bias=False)]


@pytest.mark.parametrize("kw", CONV1D, ids=[str(i) for i in range(6)])
def test_convolution1d_matches_jax(kw):
    x = np.random.default_rng(0).standard_normal((3, 9, 5)).astype(
        np.float32)
    shape = (None, 9, 5)
    if kw.get("dim_ordering") == "th":
        x, shape = x.transpose(0, 2, 1).copy(), (None, 5, 9)
    got, want = _layer_pair(JL.Convolution1D(6, 3, **kw),
                            TL.Convolution1D(6, 3, **kw), shape, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_TOL)


POOL1D = [("MaxPooling1D", dict()), ("MaxPooling1D",
                                      dict(pool_length=3, stride=2,
                                           border_mode="same")),
          ("AveragePooling1D", dict()),
          ("AveragePooling1D", dict(pool_length=3, stride=2,
                                    border_mode="same")),
          ("GlobalMaxPooling1D", dict()), ("GlobalAveragePooling1D", dict())]


@pytest.mark.parametrize("case", POOL1D, ids=[f"{c}-{i}" for i, (c, _) in
                                              enumerate(POOL1D)])
def test_pooling1d_matches_jax(case):
    cls, kw = case
    x = np.random.default_rng(1).standard_normal((3, 9, 5)).astype(
        np.float32)
    got, want = _layer_pair(getattr(JL, cls)(**kw), getattr(TL, cls)(**kw),
                            (None, 9, 5), x)
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_TOL)


def test_global_average_pooling1d_masked_mean_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 9, 5)).astype(np.float32)
    mask = (np.arange(9)[None] < np.array([[9], [4], [0]])).astype(
        np.float32)  # the last row has no valid step: the mean is 0
    got, want = _layer_pair(JL.GlobalAveragePooling1D(),
                            TL.GlobalAveragePooling1D(),
                            [(None, 9, 5), (None, 9)], [x, mask])
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_TOL)
    np.testing.assert_allclose(got[1], x[1, :4].mean(0), rtol=0, atol=1e-6)
    assert not got[2].any()


# -- TextClassifier -----------------------------------------------------------


def _text_classifier(encoder, embedding=EMBED):
    return lambda tc, _: tc.TextClassifier(
        CLASSES, embedding=embedding, sequence_length=SEQ, encoder=encoder,
        encoder_output_dim=ENC, vocab_size=VOCAB)


def _text_data(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, VOCAB, (n, SEQ)).astype(np.int32),
            rng.integers(0, CLASSES, n).astype(np.int32))


@pytest.mark.parametrize("encoder", ["cnn", "lstm", "gru"])
def test_text_classifier_forward_matches_jax(encoder):
    jzoo, tzoo = _pair(_text_classifier(encoder))
    x, _ = _text_data(20)
    want = np.asarray(jzoo.predict(x, batch_size=8))
    got = tzoo.predict(x, batch_size=8)
    assert got.shape == (20, CLASSES)
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_TOL)
    served = InferenceModel().do_load_keras(tzoo.model).do_predict(x)
    np.testing.assert_array_equal(served, tzoo.predict(x, batch_size=20))


@pytest.mark.parametrize("encoder", ["cnn", "lstm", "gru"])
def test_text_classifier_three_step_fit_matches_jax(encoder, tmp_path):
    """``compile``/``fit`` with Adam(0.01) and metrics, 3 steps (24 rows
    at batch 8): per-step losses, final parameters, ``evaluate`` and
    ``predict`` held to the JAX package's."""
    jzoo, tzoo = _pair(_text_classifier(encoder))
    _no_dropout(jzoo, tzoo)
    x, y = _text_data(24, seed=3)
    jzoo.compile(optimizer=JAdam(lr=0.01),
                 loss="sparse_categorical_crossentropy",
                 metrics=["accuracy", "top5accuracy"])
    tzoo.compile(optimizer=Adam(lr=0.01),
                 loss="sparse_categorical_crossentropy",
                 metrics=["accuracy", "top5accuracy"])
    jzoo.set_tensorboard(str(tmp_path), "jax")
    jzoo.fit(x, y, batch_size=8, nb_epoch=1)
    tzoo.fit(x, y, batch_size=8, nb_epoch=1)
    j_losses = [v for _, v in jzoo.model.get_train_summary("Loss")]
    assert len(j_losses) == 3
    np.testing.assert_allclose(tzoo.model._estimator.train_losses, j_losses,
                               rtol=0, atol=F32_TOL)
    j_final = jzoo.model._get_estimator().tstate.params
    for a, b in zip(tree_leaves(tzoo.model.params),
                    tree_leaves(load_jax_params(
                        _text_classifier(encoder)(ttc, ts2s).model,
                        jax.tree_util.tree_map(np.asarray, j_final))),
                    strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=F32_TOL)
    np.testing.assert_allclose(tzoo.predict(x, batch_size=8),
                               np.asarray(jzoo.predict(x, batch_size=8)),
                               rtol=0, atol=F32_TOL)
    jev, tev = jzoo.evaluate(x, y, batch_size=8), tzoo.evaluate(x, y, 8)
    assert set(tev) == set(jev)
    for k in jev:
        assert tev[k] == pytest.approx(jev[k], abs=F32_TOL), k


def test_text_classifier_word_embedding_route_matches_jax():
    """A given embedding matrix: a frozen ``WordEmbedding`` that ``fit``
    does not move."""
    matrix = np.random.default_rng(4).standard_normal(
        (VOCAB, 6)).astype(np.float32)
    jzoo, tzoo = _pair(_text_classifier("cnn", embedding=matrix))
    x, y = _text_data(16, seed=5)
    np.testing.assert_allclose(tzoo.predict(x), np.asarray(jzoo.predict(x)),
                               rtol=0, atol=FWD_TOL)
    emb = tzoo.model.layers()[0]
    assert isinstance(emb, TL.WordEmbedding) and emb.trainable is False
    tzoo.compile(optimizer=Adam(lr=0.05),
                 loss="sparse_categorical_crossentropy")
    tzoo.fit(x, y, batch_size=8, nb_epoch=1)
    np.testing.assert_array_equal(
        tzoo.model.params[emb.name]["embeddings"].numpy(), matrix)
    assert tzoo.token_length == 6


@pytest.mark.parametrize("embedding", ["int", "matrix"])
def test_text_classifier_save_load_round_trips(embedding, tmp_path):
    """The port's ``save_model`` -> ``load_model`` is bitwise, and a
    directory the JAX package saved loads into the port."""
    emb = EMBED if embedding == "int" else np.random.default_rng(6) \
        .standard_normal((VOCAB, 6)).astype(np.float32)
    jzoo, tzoo = _pair(_text_classifier("gru", embedding=emb))
    x, _ = _text_data(8, seed=7)
    tzoo.save_model(str(tmp_path / "port"))
    loaded = ZooModel.load_model(str(tmp_path / "port"))
    assert isinstance(loaded, ttc.TextClassifier)
    assert loaded.config() == tzoo.config() == jzoo.config()
    np.testing.assert_array_equal(loaded.predict(x), tzoo.predict(x))
    jzoo.save_model(str(tmp_path / "jax"))
    from_jax = ZooModel.load_model(str(tmp_path / "jax"))
    np.testing.assert_allclose(from_jax.predict(x),
                               np.asarray(jzoo.predict(x)), rtol=0,
                               atol=FWD_TOL)


def test_text_classifier_rejects_an_unknown_encoder():
    with pytest.raises(ValueError, match="cnn\\|lstm\\|gru"):
        ttc.TextClassifier(2, encoder="transformer")


# -- Seq2seq ------------------------------------------------------------------

S2S_CASES = [("lstm", "pass"), ("gru", "dense"), ("simplernn", "dense"),
             ("lstm", "dense")]
S2S_IDS = ["-".join(c) for c in S2S_CASES]


def _seq2seq(cell, bridge, hidden=(8, 8), vocab=12):
    return lambda _, s2s: s2s.Seq2seq(vocab_size=vocab, embed_dim=8,
                                      hidden_sizes=hidden, cell_type=cell,
                                      bridge=bridge)


def _s2s_data(n, src_len=5, tgt_len=6, vocab=12, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (n, src_len)).astype(np.int32),
            rng.integers(0, vocab, (n, tgt_len)).astype(np.int32))


def _params(zoo):
    est = zoo.model._get_estimator()
    est._ensure_state()
    return est.tstate.params


@pytest.mark.parametrize("case", S2S_CASES, ids=S2S_IDS)
def test_seq2seq_teacher_forcing_and_prefill_match_jax(case):
    jzoo, tzoo = _pair(_seq2seq(*case))
    src, tgt = _s2s_data(4)
    jl, _ = jzoo.model.apply(_params(jzoo), {},
                             (jnp.asarray(src), jnp.asarray(tgt)))
    tl, _ = tzoo.model.apply(_params(tzoo), {},
                             (torch.tensor(src), torch.tensor(tgt)))
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=0,
                               atol=FWD_TOL)
    mask = (np.arange(5)[None] < np.array([[5], [3], [1], [4]])).astype(
        np.float32)
    jc = jzoo.model.seq_prefill(_params(jzoo), jnp.asarray(src),
                                jnp.asarray(mask))
    tc = tzoo.model.seq_prefill(_params(tzoo), torch.tensor(src),
                                torch.tensor(mask))
    for a, b in zip(jax.tree_util.tree_leaves(tc),
                    jax.tree_util.tree_leaves(jc), strict=True):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=0, atol=FWD_TOL)


@pytest.mark.parametrize("case", S2S_CASES, ids=S2S_IDS)
def test_seq2seq_greedy_infer_matches_jax(case):
    """The JAX greedy tokens, fed back by teacher forcing through the
    port, are the port's argmax wherever the JAX logits are not near a
    tie; and the port's own ``infer`` equals the JAX tokens on these
    seeds."""
    jzoo, tzoo = _pair(_seq2seq(*case))
    src, _ = _s2s_data(4, seed=1)
    want = np.asarray(jzoo.infer(src, start_token=1, max_seq_len=7))
    got = tzoo.infer(src, start_token=1, max_seq_len=7)
    assert got.dtype == np.int32 and got.shape == (4, 7)
    tgt_in = np.concatenate([np.ones((4, 1), np.int32), want[:, :-1]], 1)
    jl, _ = jzoo.model.apply(_params(jzoo), {},
                             (jnp.asarray(src), jnp.asarray(tgt_in)))
    tl, _ = tzoo.model.apply(_params(tzoo), {},
                             (torch.tensor(src), torch.tensor(tgt_in)))
    top2 = np.sort(np.asarray(jl), axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > TIE_GAP
    assert clear.mean() >= 0.5
    np.testing.assert_array_equal(tl.argmax(-1).numpy()[clear], want[clear])
    np.testing.assert_array_equal(got, want)
    # stop_sign: everything after the first stop is the stop sign
    stop = int(want[0, 2])
    jstop = np.asarray(jzoo.infer(src, 1, 7, stop_sign=stop))
    np.testing.assert_array_equal(tzoo.infer(src, 1, 7, stop_sign=stop),
                                  jstop)


@pytest.mark.parametrize("case", [("lstm", "pass"), ("gru", "dense")],
                         ids=["lstm-pass", "gru-dense"])
def test_seq2seq_beam_search_matches_jax(case):
    jzoo, tzoo = _pair(_seq2seq(*case))
    src, _ = _s2s_data(3, seed=2)
    for stop in (None, 3):
        jseq, jsc = jzoo.infer_beams(src, 1, beam_size=4, max_seq_len=5,
                                     stop_sign=stop)
        tseq, tsc = tzoo.infer_beams(src, 1, beam_size=4, max_seq_len=5,
                                     stop_sign=stop)
        np.testing.assert_allclose(tsc, np.asarray(jsc), rtol=0,
                                   atol=F32_TOL)
        np.testing.assert_array_equal(tseq, np.asarray(jseq))
        # the beam's scores are the model's scores of its sequences
        scored = tzoo.model.score_sequences(
            _params(tzoo), torch.tensor(src), torch.tensor(tseq), 1, stop)
        np.testing.assert_allclose(scored.detach().numpy(), tsc, rtol=0,
                                   atol=F32_TOL)


@pytest.mark.parametrize("cell_type,bridge", [("lstm", "pass"),
                                              ("gru", "dense")])
def test_seq2seq_stepwise_decode_parity(cell_type, bridge):
    """The sequence-serving parity primitive: greedy decode run step by
    step through ``seq_prefill``/``seq_step`` equals (a) the
    single-request ``infer`` and (b) teacher-forced evaluation fed the
    greedy tokens, on int32 tokens; a prompt right-padded to a longer
    bucket gives the same stream."""
    rng = np.random.default_rng(11)
    vocab, B, n, T = 12, 3, 5, 7
    net = ts2s.Seq2seqNet(vocab, 8, (8, 8), cell_type=cell_type,
                          bridge=bridge)
    est = net._get_estimator()
    est._ensure_state()
    params = est.tstate.params
    src = rng.integers(0, vocab, size=(B, n)).astype(np.int32)

    def stepwise(src_ids, mask):
        carries = net.seq_prefill(params, torch.tensor(src_ids),
                                  torch.tensor(mask, dtype=torch.float32))
        tok = torch.full((src_ids.shape[0],), 1, dtype=torch.int32)
        cols = []
        for _ in range(T):
            carries, tok = net.seq_step(params, carries, tok)
            assert tok.dtype == torch.int32
            cols.append(tok.numpy())
        return np.stack(cols, axis=1)

    with torch.inference_mode():
        got = stepwise(src, np.ones((B, n)))
        ref = net.infer(params, torch.tensor(src), start_token=1,
                        max_seq_len=T).numpy()
        np.testing.assert_array_equal(got, ref)
        tgt_in = np.concatenate([np.ones((B, 1), np.int32), got[:, :-1]],
                                axis=1)
        logits, _ = net.apply(params, {}, (torch.tensor(src),
                                           torch.tensor(tgt_in)))
        np.testing.assert_array_equal(got, logits.argmax(-1).numpy())
        pad = np.zeros((B, 8), np.int32)
        pad[:, :n] = src
        mask = np.zeros((B, 8), np.float32)
        mask[:, :n] = 1.0
        np.testing.assert_array_equal(stepwise(pad, mask), got)


def test_seq2seq_beam_search_exact_and_reduces_to_greedy():
    """beam_size=1 is greedy exactly, and an exhaustive-width beam (K >=
    V^(T-1), nothing pruned) finds the global argmax sequence, checked
    against every sequence scored by the model."""
    vocab, T = 4, 3
    rng = np.random.default_rng(0)
    s2s = ts2s.Seq2seq(vocab_size=vocab, embed_dim=12, hidden_sizes=(16,),
                       cell_type="gru")
    src = rng.integers(0, vocab, (3, 5)).astype(np.int32)
    greedy = s2s.infer(src, start_token=1, max_seq_len=T)
    beam1 = s2s.infer(src, start_token=1, max_seq_len=T, beam_size=1)
    np.testing.assert_array_equal(greedy, beam1)
    K = vocab ** (T - 1)
    seqs, scores = s2s.infer_beams(src, start_token=1, beam_size=K,
                                   max_seq_len=T)
    assert seqs.shape == (3, K, T) and scores.shape == (3, K)
    assert (np.diff(scores, axis=1) <= 1e-5).all()  # best first
    all_seqs = np.asarray(list(itertools.product(range(vocab), repeat=T)),
                          np.int32)
    with torch.inference_mode():
        brute = s2s.model.score_sequences(
            _params(s2s), torch.tensor(src),
            torch.tensor(np.tile(all_seqs[None], (3, 1, 1))),
            start_token=1).numpy()
    np.testing.assert_allclose(scores[:, 0], brute.max(axis=1), atol=1e-4)
    for b in range(3):
        np.testing.assert_array_equal(seqs[b, 0],
                                      all_seqs[int(brute[b].argmax())])
    np.testing.assert_array_equal(
        s2s.infer(src, start_token=1, max_seq_len=T, beam_size=K),
        seqs[:, 0])


def test_seq2seq_three_step_fit_matches_jax(tmp_path):
    """``fit`` on ``[src, tgt_in]`` with the from-logits loss: 3 steps
    held to the JAX package's."""
    jzoo, tzoo = _pair(_seq2seq("lstm", "dense"))
    src, tgt = _s2s_data(24, seed=4)
    tgt_in = np.concatenate([np.ones((24, 1), np.int32), tgt[:, :-1]], 1)
    loss = "sparse_categorical_crossentropy_from_logits"
    jzoo.compile(optimizer=JAdam(lr=0.01), loss=loss)
    tzoo.compile(optimizer=Adam(lr=0.01), loss=loss)
    jzoo.set_tensorboard(str(tmp_path), "jax")
    jzoo.fit([src, tgt_in], tgt, batch_size=8, nb_epoch=1)
    tzoo.fit([src, tgt_in], tgt, batch_size=8, nb_epoch=1)
    j_losses = [v for _, v in jzoo.model.get_train_summary("Loss")]
    np.testing.assert_allclose(tzoo.model._estimator.train_losses, j_losses,
                               rtol=0, atol=F32_TOL)
    ref = _seq2seq("lstm", "dense")(ttc, ts2s).model
    for a, b in zip(tree_leaves(tzoo.model.params), tree_leaves(
            load_jax_params(ref, jax.tree_util.tree_map(
                np.asarray, _params(jzoo)))), strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=F32_TOL)


def test_seq2seq_save_load_round_trips(tmp_path):
    jzoo, tzoo = _pair(_seq2seq("gru", "dense"))
    src, _ = _s2s_data(4, seed=5)
    tzoo.save_model(str(tmp_path / "port"))
    loaded = ZooModel.load_model(str(tmp_path / "port"))
    assert isinstance(loaded, ts2s.Seq2seq)
    for a, b in zip(tree_leaves(_params(loaded)),
                    tree_leaves(_params(tzoo)), strict=True):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(loaded.infer(src, 1, 6),
                                  tzoo.infer(src, 1, 6))
    jzoo.save_model(str(tmp_path / "jax"))
    from_jax = ZooModel.load_model(str(tmp_path / "jax"))
    for a, b in zip(tree_leaves(_params(from_jax)),
                    tree_leaves(_params(tzoo)), strict=True):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_seq2seq_components_and_layer_tree():
    """``from_components`` and ``Bridge``, and the parameter tree: the
    same layer names and leaf shapes as the JAX package's."""
    enc = ts2s.RNNEncoder.initialize("gru", 2, 8)
    s2s = ts2s.Seq2seq.from_components(
        enc, ts2s.RNNDecoder.initialize("gru", 2, 8), vocab_size=12,
        embed_dim=8, bridge=ts2s.Bridge.initialize("dense"))
    assert s2s.config() == dict(vocab_size=12, embed_dim=8,
                                hidden_sizes=[8, 8], cell_type="gru",
                                bridge="dense", target_vocab_size=None)
    with pytest.raises(ValueError, match="must match"):
        ts2s.Seq2seq.from_components(
            enc, ts2s.RNNDecoder.initialize("lstm", 2, 8), 12)
    with pytest.raises(ValueError, match="unsupported"):
        ts2s.Bridge.initialize("dense", bridge_hidden_size=4)
    jzoo, tzoo = _pair(_seq2seq("gru", "dense"))
    jshapes = jax.tree_util.tree_map(lambda a: tuple(np.shape(a)),
                                     _jax_params(jzoo.model))
    tshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                     _params(tzoo))
    assert jshapes == tshapes
