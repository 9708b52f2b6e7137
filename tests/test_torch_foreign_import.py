"""Foreign weights poured into the port's zoo models, against the JAX
package on the same files: a torch ``state_dict`` (a file, parameters that
require grad, and a bf16 copy), a hand-encoded ``.caffemodel``, and Keras
HDF5 weight files in the classic and Keras-3 layouts, written here with
``h5py`` (no TensorFlow). The poured weights equal the JAX package's bit
for bit; the outputs match the source framework's (or numpy's) within the
bounds of ``tests/test_foreign_import.py``. Also ``Net.load_onnx`` from a
file, ``load_pretrained_weights(<.h5>)``, and that importing the port
needs neither h5py nor TensorFlow.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch
import torch.nn as tnn

import analytics_zoo_tpu as zoo
import analytics_zoo_tpu_torch as port
import chip_smoke as cs
from analytics_zoo_tpu import caffe_import as jcaffe
from analytics_zoo_tpu import keras_import as jkeras
from analytics_zoo_tpu import torch_import as jtorch
from analytics_zoo_tpu.keras import layers as jlayers
from analytics_zoo_tpu.keras.engine import topology as jtopo
from analytics_zoo_tpu_torch import caffe_import as tcaffe
from analytics_zoo_tpu_torch import keras_import as tkeras
from analytics_zoo_tpu_torch import torch_import as ttorch
from analytics_zoo_tpu_torch.keras import layers as tlayers
from analytics_zoo_tpu_torch.keras.engine import topology as ttopo
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts
from analytics_zoo_tpu_torch.net import Net
from analytics_zoo_tpu_torch.onnx import proto as P

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4  # tests/test_foreign_import.py's bound against the source


@pytest.fixture(autouse=True)
def _ctx():
    zoo.init_nncontext()
    port.init_nncontext(device="cpu")
    yield
    port.stop_nncontext()
    reset_name_counts()


def _same_weights(tm, jm):
    """The port's and the JAX package's installed weights and state, leaf
    by leaf, bit for bit."""
    tw, jw = tm.get_weights(), jm.get_weights()
    assert set(tw) == set(jw)
    for layer in jw:
        for k, v in jw[layer].items():
            np.testing.assert_array_equal(tw[layer][k], np.asarray(v),
                                          err_msg=f"{layer}.{k}")
    tstate = tm._estimator_state().tstate.model_state
    jest = jm._get_estimator()
    jest._ensure_state()
    for layer, st in jest.tstate.model_state.items():
        for k, v in st.items():
            np.testing.assert_array_equal(tstate[layer][k].numpy(),
                                          np.asarray(v))


def _cnn(topo, L, eps=1e-5, last="d1"):
    m = topo.Sequential()
    m.add(L.Convolution2D(4, 3, 3, border_mode="same", activation="relu",
                          dim_ordering="tf", input_shape=(8, 8, 3),
                          name="c1"))
    m.add(L.BatchNormalization(epsilon=eps, dim_ordering="tf", name="bn1"))
    m.add(L.Permute((3, 1, 2), name="to_chw"))  # torch's flatten order
    m.add(L.Flatten(name="fl"))
    m.add(L.Dense(5, name=last))
    return m


# -- torch state_dict ----------------------------------------------------


def _torch_cnn():
    torch.manual_seed(0)
    tm = tnn.Sequential()
    tm.add_module("c1", tnn.Conv2d(3, 4, 3, padding=1))
    tm.add_module("r1", tnn.ReLU())
    tm.add_module("bn1", tnn.BatchNorm2d(4))
    tm.add_module("fl", tnn.Flatten())
    tm.add_module("d1", tnn.Linear(4 * 8 * 8, 5))
    tm.train()
    with torch.no_grad():  # non-trivial BN statistics
        for _ in range(3):
            tm(torch.randn(16, 3, 8, 8) * 2 + 1)
    return tm.eval()


@pytest.mark.parametrize("source", ["file", "parameters", "bf16"])
def test_torch_state_dict_pouring(tmp_path, source):
    tm = _torch_cnn()
    if source == "file":
        sd = str(tmp_path / "w.pt")
        torch.save(tm.state_dict(), sd)
    elif source == "parameters":
        # tensors that require grad: read through .detach()
        sd = {**dict(tm.named_parameters()), **dict(tm.named_buffers())}
    else:
        sd = {k: v.to(torch.bfloat16) for k, v in tm.state_dict().items()}
    dst, jdst = _cnn(ttopo, tlayers), _cnn(jtopo, jlayers)
    imported = Net.load_torch(sd, dst, strict=False)
    assert set(imported) == {"c1", "bn1", "d1"}
    assert jtorch.load_torch_weights(jdst, sd, strict=False) == imported
    _same_weights(dst, jdst)
    x = np.random.default_rng(0).normal(1.0, 2.0, (4, 8, 8, 3)).astype(
        np.float32)
    got = dst.predict(x, batch_size=4)
    if source == "bf16":
        # the poured weights are the bf16 values, made float32
        w = dst.get_weights()["c1"]["kernel"]
        np.testing.assert_array_equal(
            w, tm.c1.weight.detach().to(torch.bfloat16).float().numpy()
            .transpose(2, 3, 1, 0))
        return
    with torch.no_grad():
        want = tm(torch.from_numpy(np.transpose(x, (0, 3, 1, 2)))).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_torch_lstm_pouring():
    torch.manual_seed(1)
    lstm = tnn.LSTM(input_size=4, hidden_size=8, batch_first=True)
    sd = {f"l1.{k}": v for k, v in lstm.state_dict().items()}
    nets = []
    for topo, L, load in ((ttopo, tlayers, ttorch.load_torch_weights),
                          (jtopo, jlayers, jtorch.load_torch_weights)):
        m = topo.Sequential()
        m.add(L.LSTM(8, inner_activation="sigmoid", return_sequences=True,
                     input_shape=(6, 4), name="l1"))
        load(m, sd)
        nets.append(m)
    _same_weights(*nets)
    x = np.random.default_rng(2).normal(size=(3, 6, 4)).astype(np.float32)
    with torch.no_grad():
        want, _ = lstm(torch.from_numpy(x))
    np.testing.assert_allclose(nets[0].predict(x, batch_size=3),
                               want.numpy(), rtol=TOL, atol=1e-5)


def test_torch_unknown_module_and_bias_mismatch_error():
    dst = ttopo.Sequential()
    dst.add(tlayers.Dense(3, input_shape=(4,), name="d1"))
    with pytest.raises(KeyError, match="no zoo layer"):
        ttorch.load_torch_weights(
            dst, {"nope.weight": np.zeros((3, 4), np.float32)})
    nob = ttopo.Sequential()
    nob.add(tlayers.Dense(3, input_shape=(4,), bias=False, name="d1"))
    with pytest.raises(ValueError, match="bias=False"):
        ttorch.load_torch_weights(nob, {"d1.weight": torch.zeros(3, 4),
                                        "d1.bias": torch.zeros(3)})


# -- caffe ---------------------------------------------------------------


_encode_caffemodel = cs.caffemodel_bytes  # the chip phase's encoder


def test_caffemodel_pouring(tmp_path):
    rng = np.random.default_rng(0)
    conv_w = rng.normal(size=(4, 3, 3, 3)).astype(np.float32)   # OIHW
    conv_b = rng.normal(size=(4,)).astype(np.float32)
    bn_mean = rng.normal(size=(4,)).astype(np.float32)
    bn_var = rng.uniform(0.5, 2.0, (4,)).astype(np.float32)
    gamma = rng.uniform(0.8, 1.2, (4,)).astype(np.float32)
    beta = rng.normal(size=(4,)).astype(np.float32)
    ip_w = rng.normal(size=(5, 4 * 8 * 8)).astype(np.float32)   # (out, in)
    ip_b = rng.normal(size=(5,)).astype(np.float32)
    blob = _encode_caffemodel([
        ("c1", "Convolution", [conv_w, conv_b]),
        ("bn1", "BatchNorm", [bn_mean * 2.0, bn_var * 2.0,
                              np.array([2.0], np.float32)]),
        ("scale1", "Scale", [gamma, beta]),
        ("fc1", "InnerProduct", [ip_w, ip_b]),
    ])
    path = tmp_path / "m.caffemodel"
    path.write_bytes(blob)
    assert tcaffe.read_caffemodel(str(path)).keys() == \
        jcaffe.read_caffemodel(blob).keys()
    dst, jdst = (_cnn(ttopo, tlayers, last="fc1"),
                 _cnn(jtopo, jlayers, last="fc1"))
    names = {"scale1": "bn1"}
    imported = Net.load_caffe(str(path), dst, name_map=names)
    assert set(imported) == {"c1", "bn1", "fc1"}
    jcaffe.load_caffe_weights(jdst, blob, name_map=names)
    _same_weights(dst, jdst)
    # numpy golden: caffe convolution is a cross-correlation, like ours
    x = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    conv = np.zeros((2, 8, 8, 4), np.float32)
    for o in range(4):
        k = conv_w[o].transpose(1, 2, 0)
        for i in range(8):
            for j in range(8):
                conv[:, i, j, o] = (xp[:, i:i + 3, j:j + 3, :] * k).sum(
                    (1, 2, 3)) + conv_b[o]
    bn = (np.maximum(conv, 0) - bn_mean) / np.sqrt(bn_var + 1e-5) * gamma \
        + beta
    want = bn.transpose(0, 3, 1, 2).reshape(2, -1) @ ip_w.T + ip_b
    np.testing.assert_allclose(dst.predict(x, batch_size=2), want,
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("packed", [True, False])
def test_caffemodel_gamma_only_scale_and_missing_scale(packed):
    rng = np.random.default_rng(2)
    bn = ("bn1", "BatchNorm", [rng.normal(size=(4,)).astype(np.float32),
                               np.ones(4, np.float32),
                               np.ones(1, np.float32)])
    blob = _encode_caffemodel([bn, ("scale1", "Scale",
                                    [np.full(4, 1.5, np.float32)])],
                              packed_dims=packed)
    nets = []
    for topo, L, load in ((ttopo, tlayers, tcaffe.load_caffe_weights),
                          (jtopo, jlayers, jcaffe.load_caffe_weights)):
        m = topo.Sequential()
        m.add(L.BatchNormalization(epsilon=1e-5, input_shape=(6, 6, 4),
                                   dim_ordering="tf", name="bn1"))
        load(m, blob, name_map={"scale1": "bn1"})
        nets.append(m)
    _same_weights(*nets)
    w = nets[0].get_weights()["bn1"]
    np.testing.assert_array_equal(w["gamma"], 1.5)
    np.testing.assert_array_equal(w["beta"], 0.0)
    lone = ttopo.Sequential()
    lone.add(tlayers.BatchNormalization(input_shape=(6, 6, 4),
                                       dim_ordering="tf", name="bn1"))
    with pytest.raises(KeyError, match="Scale"):
        tcaffe.load_caffe_weights(lone, _encode_caffemodel([bn]))


# -- Keras HDF5, written with h5py ---------------------------------------


def _keras_weights(rng):
    return {
        "c1": {"kernel": rng.normal(0, 0.3, (3, 3, 3, 4)).astype(np.float32),
               "bias": rng.normal(0, 0.1, (4,)).astype(np.float32)},
        "bn1": {"gamma": rng.uniform(0.5, 1.5, 4).astype(np.float32),
                "beta": rng.normal(0, 0.1, 4).astype(np.float32),
                "moving_mean": rng.normal(0, 0.5, 4).astype(np.float32),
                "moving_variance": rng.uniform(0.5, 2, 4).astype(
                    np.float32)},
        "d1": {"kernel": rng.normal(0, 0.1, (256, 5)).astype(np.float32),
               "bias": rng.normal(0, 0.1, 5).astype(np.float32)},
    }


def _write_classic(path, weights, root="model_weights"):
    with h5py.File(path, "w") as f:
        g = f.create_group(root) if root else f
        g.attrs["layer_names"] = [n.encode() for n in weights]
        for lname, ws in weights.items():
            grp = g.create_group(lname)
            names = [f"{lname}/{k}:0".encode() for k in ws]
            grp.attrs["weight_names"] = names
            for n, v in zip(names, ws.values()):
                grp.create_dataset(n.decode(), data=v)


_KERAS3_TYPES = {"c1": "conv2d", "bn1": "batch_normalization",
                 "d1": "dense", "l1": "lstm"}


def _write_keras3(path, weights):
    with h5py.File(path, "w") as f:
        for lname, ws in weights.items():
            vars_ = f.create_group(f"layers/{_KERAS3_TYPES[lname]}/vars")
            vars_.attrs["name"] = lname
            for i, v in enumerate(ws.values()):
                vars_.create_dataset(str(i), data=v)


@pytest.mark.parametrize("layout", ["classic", "classic-root", "keras3"])
def test_keras_hdf5_pouring_matches_jax(tmp_path, layout):
    weights = _keras_weights(np.random.default_rng(3))
    path = str(tmp_path / "w.weights.h5")
    if layout == "keras3":
        _write_keras3(path, weights)
    else:
        _write_classic(path, weights,
                       root="model_weights" if layout == "classic" else None)
    for k, v in tkeras.read_keras_hdf5(path).items():
        for name, arr in v.items():
            np.testing.assert_array_equal(
                arr, jkeras.read_keras_hdf5(path)[k][name])
    dst, jdst = (_cnn(ttopo, tlayers, eps=1e-3),
                 _cnn(jtopo, jlayers, eps=1e-3))
    imported = Net.load_keras(path, dst, strict=False)
    assert set(imported) == {"c1", "bn1", "d1"}
    assert jkeras.load_keras_weights(jdst, path, strict=False) == imported
    _same_weights(dst, jdst)
    np.testing.assert_array_equal(dst.get_weights()["c1"]["kernel"],
                                  weights["c1"]["kernel"])
    x = np.random.default_rng(4).normal(size=(8, 8, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(dst.predict(x, batch_size=8),
                               np.asarray(jdst.predict(x, batch_size=8)),
                               rtol=1e-5, atol=1e-5)
    if layout == "keras3":
        with pytest.raises(ValueError, match="alphabetically"):
            Net.load_keras(path, dst, by_name=False)
    else:
        positional = _cnn(ttopo, tlayers, eps=1e-3)
        Net.load_keras(path, positional, by_name=False)
        np.testing.assert_array_equal(positional.get_weights()["d1"]["bias"],
                                      weights["d1"]["bias"])


def test_keras_hdf5_lstm_and_prefixed_bn_names(tmp_path):
    rng = np.random.default_rng(5)
    path = str(tmp_path / "lstm.h5")
    weights = {"l1": {"kernel": rng.normal(0, .3, (4, 32)).astype(np.float32),
                      "recurrent_kernel": rng.normal(0, .3, (8, 32)).astype(
                          np.float32),
                      "bias": rng.normal(0, .1, 32).astype(np.float32)}}
    _write_keras3(path, weights)
    nets = []
    for topo, L, load in ((ttopo, tlayers, tkeras.load_keras_weights),
                          (jtopo, jlayers, jkeras.load_keras_weights)):
        m = topo.Sequential()
        m.add(L.LSTM(8, inner_activation="sigmoid", input_shape=(6, 4),
                     name="l1"))
        load(m, path)
        nets.append(m)
    _same_weights(*nets)
    x = rng.normal(size=(4, 6, 4)).astype(np.float32)
    np.testing.assert_allclose(nets[0].predict(x, batch_size=4),
                               np.asarray(nets[1].predict(x, batch_size=4)),
                               rtol=1e-5, atol=1e-5)
    bn = tlayers.BatchNormalization(dim_ordering="tf")
    bn.ensure_built((None, 4, 4, 3))
    w = {"batchnormalization_1_gamma": np.full(3, 1.5, np.float32),
         "batchnormalization_1_beta": np.full(3, 0.5, np.float32),
         "batchnormalization_1_running_mean": np.full(3, 2.0, np.float32),
         "batchnormalization_1_running_std": np.full(3, 4.0, np.float32)}
    p, s = tkeras._convert(bn, w)
    np.testing.assert_array_equal(p["gamma"], 1.5)
    np.testing.assert_array_equal(s["moving_var"], 4.0)
    with pytest.raises(KeyError):
        tkeras._convert(bn, {"g": w["batchnormalization_1_gamma"],
                             "b": w["batchnormalization_1_beta"],
                             "stat_a": np.ones(3, np.float32),
                             "stat_b": np.ones(3, np.float32)})


def test_load_pretrained_weights_pours_a_keras_h5(tmp_path):
    from analytics_zoo_tpu_torch.models.image import imageclassification as ic

    weights = _keras_weights(np.random.default_rng(6))
    del weights["d1"]  # a backbone's weights: the head stays as it is
    path = str(tmp_path / "backbone.h5")
    _write_classic(path, weights)
    m = _cnn(ttopo, tlayers, eps=1e-3)
    head = m.get_weights()["d1"]["kernel"]
    assert ic.load_pretrained_weights(m, path) == ["c1", "bn1"]
    np.testing.assert_array_equal(m.get_weights()["c1"]["kernel"],
                                  weights["c1"]["kernel"])
    np.testing.assert_array_equal(m.get_weights()["d1"]["kernel"], head)


def test_net_load_onnx_from_a_file(tmp_path):
    rng = np.random.default_rng(7)
    w = rng.normal(size=(4, 3)).astype(np.float32)
    path = tmp_path / "m.onnx"
    path.write_bytes(P.encode_model([P.encode_node("MatMul", ["x", "w"],
                                                   ["y"])],
                                    {"w": w}, [("x", (None, 4))], ["y"]))
    x = rng.normal(size=(2, 4)).astype(np.float32)
    np.testing.assert_allclose(Net.load_onnx(str(path)).predict(x), x @ w,
                               rtol=1e-6, atol=1e-6)


def test_importing_the_port_needs_neither_h5py_nor_tensorflow(tmp_path):
    code = textwrap.dedent(f"""
        import sys
        sys.modules["h5py"] = None        # an import of either raises
        sys.modules["tensorflow"] = None
        import analytics_zoo_tpu_torch.net
        import analytics_zoo_tpu_torch.keras_import
        import analytics_zoo_tpu_torch.torch_import
        import analytics_zoo_tpu_torch.caffe_import
        import analytics_zoo_tpu_torch.onnx
        import analytics_zoo_tpu_torch.inference
        import analytics_zoo_tpu_torch.models.image.imageclassification
        import analytics_zoo_tpu_torch.keras.datasets
        import analytics_zoo_tpu_torch.data.image3d
        from analytics_zoo_tpu_torch import init_nncontext
        from analytics_zoo_tpu_torch.keras.engine.topology import Sequential
        from analytics_zoo_tpu_torch.keras.layers import Dense
        init_nncontext(device="cpu")
        m = Sequential()
        m.add(Dense(2, input_shape=(3,), name="d"))
        try:
            analytics_zoo_tpu_torch.net.Net.load_keras(
                {str(tmp_path / 'w.h5')!r}, m)
        except ImportError:
            print("h5py-at-call-time")
        assert "jax" not in sys.modules
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "h5py-at-call-time"


# -- TensorFlow graphs through Net.load_tf (tests/test_foreign_import.py's
# TF cases; TensorFlow writes the models here) --------------------------


@pytest.fixture
def tf():
    tf = pytest.importorskip("tensorflow")
    tf.config.set_visible_devices([], "GPU")
    return tf


def _small_tf_cnn(tf, seed=0):
    tf.keras.utils.set_random_seed(seed)
    L = tf.keras.layers
    return tf.keras.Sequential([
        L.Input((16, 16, 3)), L.ZeroPadding2D(1),
        L.Conv2D(8, 3, strides=2, activation="relu"),
        L.BatchNormalization(), L.MaxPooling2D(2),
        L.Conv2D(16, 3, padding="same"), L.ReLU(),
        L.GlobalAveragePooling2D(), L.Dense(10, activation="softmax")])


@pytest.mark.parametrize("form", ["saved_model", "frozen_pb"])
def test_net_load_tf_roundtrip(tf, tmp_path, form):
    """test_saved_model_roundtrip and test_frozen_pb_roundtrip: Net.load_tf
    of a SavedModel directory and of a frozen .pb (parsed without
    TensorFlow) returns a TFNet answering as TF and as the JAX package's."""
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2,
    )

    from analytics_zoo_tpu.net import Net as JNet
    from analytics_zoo_tpu_torch.tfnet import TFNet

    m = _small_tf_cnn(tf, seed=1 if form == "saved_model" else 2)
    x = np.random.default_rng(1).normal(size=(2, 16, 16, 3)).astype(
        np.float32)
    want = m(x, training=False).numpy()
    if form == "saved_model":
        args = (str(tmp_path / "sm"),)
        tf.saved_model.save(m, args[0])
    else:
        frozen = convert_variables_to_constants_v2(
            tf.function(lambda t: m(t)).get_concrete_function(
                tf.TensorSpec((None, 16, 16, 3), tf.float32)))
        tf.io.write_graph(frozen.graph.as_graph_def(), str(tmp_path),
                          "frozen.pb", as_text=False)
        args = (str(tmp_path / "frozen.pb"), [frozen.inputs[0].name],
                [frozen.outputs[0].name])
    net = Net.load_tf(*args)
    assert isinstance(net, TFNet)
    got = net.fn(x).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(JNet.load_tf(*args).fn(x)),
                               rtol=0, atol=1e-6)
    if form == "frozen_pb":
        with pytest.raises(ValueError, match="input_names"):
            Net.load_tf(args[0])


@pytest.mark.slow
def test_resnet50_import_matches_tf(tf):
    from analytics_zoo_tpu_torch.tfnet import freeze_keras_model

    tf.keras.utils.set_random_seed(0)
    m = tf.keras.applications.ResNet50(weights=None, input_shape=(64, 64, 3))
    x = np.random.default_rng(0).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    np.testing.assert_allclose(freeze_keras_model(m)(x).numpy(),
                               m(x, training=False).numpy(), rtol=1e-4,
                               atol=1e-4)


def test_tfnet_backbone_transfer_learning(tf):
    """A frozen imported backbone under a fresh zoo head trains (the
    TFNet-as-first-layer pattern, ref pyzoo examples/tensorflow/tfnet):
    the backbone's features equal the JAX package's TFNet's; from the JAX
    head's initial weights both fits reach the JAX test's bar with the
    same loss; the backbone's constants stay."""
    from analytics_zoo_tpu.tfnet import TFNet as JTFNet
    from analytics_zoo_tpu_torch.interop import load_jax_params
    from analytics_zoo_tpu_torch.tfnet import TFNet

    tf.keras.utils.set_random_seed(7)
    backbone = tf.keras.Sequential([
        tf.keras.layers.Input((8, 8, 1)),
        tf.keras.layers.Conv2D(4, 3, padding="same", activation="relu"),
        tf.keras.layers.GlobalAveragePooling2D()])
    net = TFNet.from_keras(backbone, input_shape=(8, 8, 1))
    rng = np.random.default_rng(0)
    x = rng.normal(0, 0.3, size=(128, 8, 8, 1)).astype(np.float32)
    y = (x.mean(axis=(1, 2, 3)) > 0).astype(np.int32)
    x[y == 1] += 1.0
    np.testing.assert_allclose(
        net.fn(x).numpy(),
        np.asarray(JTFNet.from_keras(backbone, input_shape=(8, 8, 1)).fn(x)),
        rtol=0, atol=1e-6)
    consts = {k: v.copy() for k, v in net.fn._consts.items()}
    models = []
    for topo, L, backbone_net in (
            (jtopo, jlayers, JTFNet.from_keras(backbone,
                                               input_shape=(8, 8, 1))),
            (ttopo, tlayers, net)):
        m = topo.Sequential()
        m.add(backbone_net)
        m.add(L.Dense(2, activation="softmax"))
        m.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
        models.append(m)
    jm, m = models
    assert m.layers()[0].compute_output_shape((None, 8, 8, 1)) == (None, 4)
    jest = jm._get_estimator()
    jest._ensure_state()
    load_jax_params(m, {k: {n: np.asarray(v) for n, v in d.items()}
                        for k, d in jest.tstate.params.items()})
    for each in models:
        each.fit(x, y, batch_size=32, nb_epoch=8)
    res, jres = (each.evaluate(x, y, batch_size=32) for each in models)
    assert res["accuracy"] > 0.85 and jres["accuracy"] > 0.85
    np.testing.assert_allclose(res["loss"], jres["loss"], rtol=0, atol=TOL)
    for k, v in consts.items():
        np.testing.assert_array_equal(net.fn._consts[k], v)


def test_conv2d_transpose_matches_tf(tf):
    """Conv2DBackpropInput honours the recorded output shape and TF's
    gradient-SAME padding offsets (stride-2 SAME, odd output size)."""
    from analytics_zoo_tpu_torch.tfnet import freeze_keras_model

    tf.keras.utils.set_random_seed(5)
    m = tf.keras.Sequential([
        tf.keras.layers.Input((7, 7, 3)),
        tf.keras.layers.Conv2DTranspose(5, 3, strides=2, padding="same")])
    x = np.random.default_rng(5).normal(size=(2, 7, 7, 3)).astype(np.float32)
    want = m(x).numpy()
    assert want.shape == (2, 14, 14, 5)
    np.testing.assert_allclose(freeze_keras_model(m)(x).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_graph_function_input_shapes(tf, tmp_path):
    km = tf.keras.Sequential([
        tf.keras.layers.Input(shape=(12, 12, 3)),
        tf.keras.layers.Conv2D(4, 3),
        tf.keras.layers.GlobalAveragePooling2D()])
    d = str(tmp_path / "sm")
    km.export(d) if hasattr(km, "export") else tf.saved_model.save(km, d)
    shapes = Net.load_tf(d).fn.input_shapes
    assert len(shapes) == 1 and tuple(shapes[0][1:]) == (12, 12, 3)
