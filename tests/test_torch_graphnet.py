"""The GraphNet surface of the port's ``Model`` (``node``, ``nodes``,
``freeze``, ``unfreeze``, ``freeze_up_to``, ``new_graph``) and ``Net.load``,
held to the JAX package on the cases of ``tests/test_net.py``: the same
toy graphs from the same weights (carried leaf by leaf), the same data
and optimizer. Frozen leaves must stay bitwise unchanged in both; the
trained ones agree with JAX's within ``TOL`` (float32, XLA against
PyTorch over a few Adam steps). A freeze made after ``compile`` and a
first ``fit`` takes effect at the next ``fit`` in both.
"""

import numpy as np
import pytest

import analytics_zoo_tpu as zoo
import analytics_zoo_tpu_torch as port
from analytics_zoo_tpu.keras.engine import topology as jtopo
from analytics_zoo_tpu.keras import layers as jlayers
from analytics_zoo_tpu.keras import optimizers as jopt
from analytics_zoo_tpu.net import GraphNet as JGraphNet
from analytics_zoo_tpu_torch.interop import load_jax_params
from analytics_zoo_tpu_torch.keras import layers as tlayers
from analytics_zoo_tpu_torch.keras import optimizers as topt
from analytics_zoo_tpu_torch.keras.engine import topology as ttopo
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts
from analytics_zoo_tpu_torch.net import GraphNet, Net

TOL = 2e-5  # trained float32 weights, JAX against the port (Adam steps)


@pytest.fixture(autouse=True)
def _ctx():
    zoo.init_nncontext()
    port.init_nncontext(device="cpu")
    yield
    port.stop_nncontext()
    reset_name_counts()


def _toy(topo, L):
    inp = topo.Input(shape=(4,), name="x")
    h = L.Dense(8, activation="relu", name="feat")(inp)
    out = L.Dense(2, activation="softmax", name="head")(h)
    return topo.Model(inp, out, name="toy")


def _pair():
    """The toy graph in both packages, the port's weights carried from
    JAX's initial ones."""
    jm, tm = _toy(jtopo, jlayers), _toy(ttopo, tlayers)
    for m, opt in ((jm, jopt), (tm, topt)):
        m.compile(optimizer=opt.Adam(lr=0.05),
                  loss="sparse_categorical_crossentropy")
    x, _ = _data()
    jm.predict(x, batch_size=16)  # materialize JAX's initial weights
    load_jax_params(tm, jm.get_weights())
    return jm, tm


def _data(n=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 4), dtype=np.float32)
    y = (x.sum(axis=1) > 2.0).astype(np.int32)
    return x, y


def _assert_close_to_jax(tw, jw):
    for layer, leaves in jw.items():
        for k, v in leaves.items():
            np.testing.assert_allclose(tw[layer][k], np.asarray(v), rtol=0,
                                       atol=TOL, err_msg=f"{layer}.{k}")


@pytest.mark.parametrize("how", ["freeze", "unfreeze"])
def test_freeze_and_unfreeze_keep_frozen_parameters_fixed(how):
    jm, tm = _pair()
    x, y = _data()
    for m in (jm, tm):
        if how == "freeze":
            m.freeze(["feat"])
        else:
            m.freeze()
            m.unfreeze(["head"])
    before = tm.get_weights()
    for m in (jm, tm):
        m.fit(x, y, batch_size=16, nb_epoch=2)
    after = tm.get_weights()
    np.testing.assert_array_equal(before["feat"]["kernel"],
                                  after["feat"]["kernel"])
    np.testing.assert_array_equal(before["feat"]["bias"],
                                  after["feat"]["bias"])
    assert not np.allclose(before["head"]["kernel"], after["head"]["kernel"])
    _assert_close_to_jax(after, jm.get_weights())


def test_freeze_after_compile_and_fit_takes_effect_at_the_next_fit():
    jm, tm = _pair()
    x, y = _data()
    for m in (jm, tm):
        m.fit(x, y, batch_size=16, nb_epoch=1)
    moved = tm.get_weights()
    for m in (jm, tm):
        m.freeze(["feat"])
        m.fit(x, y, batch_size=16, nb_epoch=1)
    after = tm.get_weights()
    np.testing.assert_array_equal(moved["feat"]["kernel"],
                                  after["feat"]["kernel"])
    assert not np.array_equal(moved["head"]["kernel"],
                              after["head"]["kernel"])
    _assert_close_to_jax(after, jm.get_weights())
    for m in (jm, tm):
        m.unfreeze()
        m.fit(x, y, batch_size=16, nb_epoch=1)
    assert not np.array_equal(after["feat"]["kernel"],
                              tm.get_weights()["feat"]["kernel"])
    _assert_close_to_jax(tm.get_weights(), jm.get_weights())


def test_freeze_up_to_marks_ancestors_as_jax_does():
    flags = {}
    for name, topo, L in (("jax", jtopo, jlayers), ("port", ttopo, tlayers)):
        inp = topo.Input(shape=(4,), name="x")
        a = L.Dense(8, name="a")(inp)
        b = L.Activation("relu", name="act")(a)
        side = L.Dense(8, name="side")(inp)
        c = L.Dense(8, name="c")(L.merge([b, side], mode="sum", name="add"))
        out = L.Dense(2, activation="softmax", name="out")(c)
        m = topo.Model(inp, out)
        m.freeze_up_to("act")
        flags[name] = {l.name: l.trainable for l in m.layers()}
        assert [v.name for v in m.nodes(["a", "c"])] == [
            m.node("a").name, m.node("c").name]
        with pytest.raises(KeyError, match="nope"):
            m.node("nope")
        with pytest.raises(KeyError, match="nope"):
            m.freeze(["nope"])
    assert flags["port"] == flags["jax"]
    assert not flags["port"]["a"] and not flags["port"]["act"]
    assert flags["port"]["side"] and flags["port"]["out"]


@pytest.mark.parametrize("outputs", ["feat", ["feat", "head"]])
def test_new_graph_extracts_the_subnet_with_its_weights(outputs):
    jm, tm = _pair()
    x, _ = _data(8)
    full = tm.predict(x, batch_size=8)
    tsub, jsub = tm.new_graph(outputs), jm.new_graph(outputs)
    got, want = (tsub.predict(x, batch_size=8),
                 jsub.predict(x, batch_size=8))
    if isinstance(outputs, list):
        np.testing.assert_array_equal(got[1], full)
        got, want = got[0], want[0]
    assert got.shape == (8, 8)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)
    w = tm.get_weights()["head"]
    logits = got @ w["kernel"] + w["bias"]
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    np.testing.assert_allclose(probs, full, rtol=1e-5, atol=1e-6)
    assert [l.name for l in tsub.layers()] == [l.name
                                               for l in jsub.layers()]


def test_word_embedding_stays_frozen_through_fit():
    """Weight-level trainable=False (WordEmbedding) survives training."""
    matrix = np.random.default_rng(3).random((11, 6), dtype=np.float32)
    m = ttopo.Sequential()
    m.add(tlayers.WordEmbedding(matrix, input_length=5))
    m.add(tlayers.Flatten())
    m.add(tlayers.Dense(2, activation="softmax"))
    m.compile(optimizer=topt.Adam(lr=0.05),
              loss="sparse_categorical_crossentropy")
    rng = np.random.default_rng(0)
    x = rng.integers(0, 11, size=(16, 5))
    y = rng.integers(0, 2, size=(16,))
    m.fit(x, y, batch_size=8, nb_epoch=2)
    np.testing.assert_array_equal(
        m.get_weights()[m.layers()[0].name]["embeddings"], matrix)


def test_net_load_roundtrip_and_left_out_loaders(tmp_path):
    from analytics_zoo_tpu_torch.models import TextClassifier

    tc = TextClassifier(class_num=2, embedding=8, sequence_length=6,
                        encoder="cnn", encoder_output_dim=8, vocab_size=20)
    tc.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    x = np.random.default_rng(0).integers(0, 20, size=(8, 6))
    p1 = tc.predict(x, batch_size=8)
    tc.save_model(str(tmp_path / "m"))
    loaded = Net.load(str(tmp_path / "m"))
    np.testing.assert_array_equal(loaded.predict(x, batch_size=8), p1)
    assert GraphNet is ttopo.Model and JGraphNet is jtopo.Model
    with pytest.raises(FileNotFoundError):
        Net.load_tf("x")  # nonexistent path, as in the JAX package
    # the TensorFlow importers (tests/test_torch_tfnet.py and
    # tests/test_torch_keras_convert.py drive them): a frozen .pb needs its
    # tensor names, and a missing architecture file is reported as such
    (tmp_path / "g.pb").write_bytes(b"")
    with pytest.raises(ValueError, match="input_names"):
        Net.load_tf(str(tmp_path / "g.pb"))
    for args in ((str(tmp_path / "m.json"),),
                 (str(tmp_path / "m.json"), str(tmp_path / "w.h5"))):
        with pytest.raises(FileNotFoundError):
            Net.load_keras(*args)
    with pytest.raises(ValueError):
        Net.load(str(tmp_path / "nope"))
