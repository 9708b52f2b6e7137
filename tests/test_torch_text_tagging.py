"""The port's tfpark text models (``tfpark/text.py``: NER in 'reg' and
'pad' CRF modes and IntentEntity here; SequenceTagger with its softmax and
CRF heads, with and without chars, in ``test_torch_sequence_tagger.py``,
which runs these tests over its cases) against the JAX package, on the
CPU.

Weights are carried from the JAX models by ``load_jax_params`` (the
shared char Bi-LSTM, the tagger Bi-LSTMs, the Dense heads and the CRF's
``transitions``, leaf by leaf); inputs come from a numpy seed; small sizes
(vocab 15, sequence 6, word 4, widths 8). Dropout is 0 on both sides.

Tolerances, absolute, f32: forwards 1e-6 (the recurrent layers' float32
ops, measured at most 1e-8 here); a 3-step ``fit`` trajectory 1e-5 on
losses, parameters and predictions, as the other text-model tests. Decoded
tags are compared exactly (JAX's Viterbi paths on the JAX outputs).
"""

import jax
import numpy as np
import pytest

import analytics_zoo_tpu_torch as port
from analytics_zoo_tpu.keras.engine import base as jbase
from analytics_zoo_tpu.keras.layers.crf import crf_decode as jcrf_decode
from analytics_zoo_tpu.keras.optimizers import Adam as JAdam
from analytics_zoo_tpu.tfpark import text as jtext
from analytics_zoo_tpu_torch.common.tree import tree_leaves
from analytics_zoo_tpu_torch.interop import load_jax_params
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts
from analytics_zoo_tpu_torch.keras.layers.crf import crf_decode
from analytics_zoo_tpu_torch.keras.optimizers import Adam
from analytics_zoo_tpu_torch import tfpark as ttfpark
from analytics_zoo_tpu_torch.tfpark import text as ttext

FWD_TOL = 1e-6
F32_TOL = 1e-5
S, W, WORDS, CHARS = 6, 4, 15, 10

ALL_CASES = {
    "ner-reg": lambda m: m.NER(
        num_entities=3, word_vocab_size=WORDS, char_vocab_size=CHARS,
        sequence_length=S, word_length=W, word_emb_dim=8, char_emb_dim=4,
        tagger_lstm_dim=8, dropout=0.0, crf_mode="reg"),
    "ner-pad": lambda m: m.NER(
        num_entities=3, word_vocab_size=WORDS, char_vocab_size=CHARS,
        sequence_length=S, word_length=W, word_emb_dim=8, char_emb_dim=4,
        tagger_lstm_dim=8, dropout=0.0, crf_mode="pad"),
    "tagger-softmax": lambda m: m.SequenceTagger(
        num_pos_labels=4, num_chunk_labels=3, word_vocab_size=WORDS,
        char_vocab_size=CHARS, sequence_length=S, word_length=W,
        feature_size=8, dropout=0.0),
    "tagger-crf": lambda m: m.SequenceTagger(
        num_pos_labels=4, num_chunk_labels=3, word_vocab_size=WORDS,
        char_vocab_size=CHARS, sequence_length=S, word_length=W,
        feature_size=8, dropout=0.0, classifier="crf"),
    "tagger-words": lambda m: m.SequenceTagger(
        num_pos_labels=4, num_chunk_labels=3, word_vocab_size=WORDS,
        sequence_length=S, feature_size=8, dropout=0.0, classifier="crf"),
    "intent-entity": lambda m: m.IntentEntity(
        num_intents=3, num_entities=4, word_vocab_size=WORDS,
        char_vocab_size=CHARS, sequence_length=S, word_length=W,
        word_emb_dim=8, char_emb_dim=4, char_lstm_dim=4, tagger_lstm_dim=8,
        dropout=0.0),
}
CASES = {k: v for k, v in ALL_CASES.items() if not k.startswith("tagger")}


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


def _pair(name):
    jbase.reset_name_counts()
    reset_name_counts()
    jm, tm = ALL_CASES[name](jtext), ALL_CASES[name](ttext)
    load_jax_params(tm.model, _jax_params(jm.model))
    return jm, tm


def _data(name, n, seed):
    """(x, y): words (+ chars, + lengths) and labels; the tags follow a
    learnable rule of the words."""
    rng = np.random.default_rng(seed)
    words = rng.integers(1, WORDS, (n, S)).astype(np.int32)
    chars = rng.integers(1, CHARS, (n, S, W)).astype(np.int32)
    if name.startswith("ner"):
        x = [words, chars]
        if name == "ner-pad":
            x.append(rng.integers(2, S + 1, (n, 1)).astype(np.int32))
        return x, (words % 3).astype(np.int32)
    if name.startswith("tagger"):
        x = words if name == "tagger-words" else [words, chars]
        return x, [(words % 4).astype(np.int32), (words % 3).astype(np.int32)]
    return [words, chars], [(words[:, 0] % 3).astype(np.int32),
                            (words % 4).astype(np.int32)]


def _close(got, want, tol):
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == np.asarray(w).shape
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=tol)


def _decoded(name, model, x):
    if name.startswith("ner"):
        return model.predict_tags(x, batch_size=8)
    if name.startswith("tagger"):
        return model.predict_chunk_tags(x, batch_size=8)
    return np.argmax(model.predict(x, batch_size=8)[1], -1)


def _loss(model, y, pred, lib):
    if isinstance(y, list):
        return float(model.default_loss()([lib(a) for a in y],
                                          [lib(a) for a in pred]))
    return float(model.default_loss()(lib(y), lib(pred)))


@pytest.mark.parametrize("name", list(CASES))
def test_forward_loss_and_decode_match_jax(name):
    """The forward, ``default_loss()`` on it (the CRF NLL for NER and the
    CRF tagger, cross-entropy sums for the softmax tagger and
    IntentEntity) and the decoded tags (``predict_tags``,
    ``predict_chunk_tags``, the entity argmax)."""
    import jax.numpy as jnp
    import torch

    jm, tm = _pair(name)
    x, y = _data(name, 20, seed=1)
    jpred, tpred = jm.predict(x, batch_size=8), tm.predict(x, batch_size=8)
    _close(tpred, jpred, FWD_TOL)
    want = _loss(jm, y, jpred, jnp.asarray)
    got = _loss(tm, y, tpred, lambda a: torch.tensor(np.asarray(a)))
    assert abs(got - want) <= F32_TOL
    np.testing.assert_array_equal(_decoded(name, tm, x),
                                  np.asarray(_decoded(name, jm, x)))


@pytest.mark.parametrize("name", list(CASES))
def test_three_step_fit_matches_jax(name, tmp_path):
    """``compile(Adam(0.01), default_loss())`` then ``fit`` of 3 steps (24
    rows at batch 8): per-step losses, final parameters (the CRF
    transitions among them), the forward and the decoded tags."""
    jm, tm = _pair(name)
    x, y = _data(name, 24, seed=3)
    jm.compile(optimizer=JAdam(lr=0.01), loss=jm.default_loss())
    tm.compile(optimizer=Adam(lr=0.01), loss=tm.default_loss())
    jm.model.set_tensorboard(str(tmp_path), "jax")
    jm.fit(x, y, batch_size=8, nb_epoch=1)
    tm.fit(x, y, batch_size=8, nb_epoch=1)
    j_est = jm.model._get_estimator()
    j_losses = [v for _, v in jm.model.get_train_summary("Loss")]
    assert len(j_losses) == 3
    np.testing.assert_allclose(tm.model._estimator.train_losses, j_losses,
                               rtol=0, atol=F32_TOL)
    jbase.reset_name_counts()
    reset_name_counts()
    final = load_jax_params(ALL_CASES[name](ttext).model,
                            jax.tree_util.tree_map(np.asarray,
                                                   j_est.tstate.params))
    for a, b in zip(tree_leaves(tm.model.params), tree_leaves(final),
                    strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=F32_TOL)
    if "crf" in {l.name for l in tm.model.layers()}:
        assert tm.model.params["crf"]["transitions"].abs().max() > 0
    jpred, tpred = jm.predict(x, batch_size=8), tm.predict(x, batch_size=8)
    _close(tpred, jpred, F32_TOL)
    if name.startswith("ner") or name == "tagger-crf":
        packed = tpred if name.startswith("ner") else tpred[1]
        jpacked = jpred if name.startswith("ner") else jpred[1]
        np.testing.assert_array_equal(crf_decode(packed, 3).numpy(),
                                      np.asarray(jcrf_decode(jpacked, 3)))


@pytest.mark.parametrize("name", ["ner-pad", "intent-entity"])
def test_save_load_round_trips(name, tmp_path):
    """``save_model``/``load_model`` in the port, and a directory the JAX
    package's ``save_model`` wrote, load to the same forward."""
    jm, tm = _pair(name)
    x, _ = _data(name, 8, seed=4)
    want = tm.predict(x, batch_size=8)
    tm.save_model(str(tmp_path / "port"))
    back = ttext.TextKerasModel.load_model(str(tmp_path / "port"))
    assert type(back) is type(tm) and back._config == tm._config
    _close(back.predict(x, batch_size=8), want, 0.0)
    jm.save_model(str(tmp_path / "jax"))
    from_jax = ttext.TextKerasModel.load_model(str(tmp_path / "jax"))
    _close(from_jax.predict(x, batch_size=8), jm.predict(x, batch_size=8),
           FWD_TOL)


def test_exports_and_validation():
    assert ttfpark.POSTagger is ttfpark.SequenceTagger is ttext.SequenceTagger
    for name in ("NER", "IntentEntity", "TextKerasModel", "BERTClassifier"):
        assert hasattr(ttfpark, name), name
    with pytest.raises(ValueError, match="crf_mode"):
        ttext.NER(3, 10, 10, crf_mode="mask")
    with pytest.raises(ValueError, match="softmax or crf"):
        ttext.SequenceTagger(3, 3, 10, classifier="hmm")


def test_ner_pad_mask_comes_from_the_lengths():
    """'pad' mode: steps past each row's length are masked in the packed
    output (the extra column), and decoding repeats the last real tag
    there."""
    _, tm = _pair("ner-pad")
    x, _ = _data("ner-pad", 8, seed=5)
    packed = tm.predict(x, batch_size=8)
    lengths = x[2][:, 0]
    want = (np.arange(S)[None] < lengths[:, None]).astype(np.float32)
    np.testing.assert_array_equal(packed[:, :S, -1], want)
    assert not packed[:, S:, -1].any()
    tags = tm.predict_tags(x, batch_size=8)
    for row, n in zip(tags, lengths):
        assert (row[n:] == row[n - 1]).all()
