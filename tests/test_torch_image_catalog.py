"""The image-classification catalog in the port against the JAX package,
on the CPU.

- ``SeparableConvolution2D`` and ``DepthwiseConvolution2D``: valid and
  same padding, stride 1 and 2 (an even input, so that SAME pads (0, 1)),
  depth multiplier 1 and 2, both orderings: the forward, and the
  gradients of ``sum(y * g)`` with respect to every leaf and the input,
  against ``jax.grad`` of the JAX layer.
- The 3x3 stride-1 SAME average pool (Inception-v3's) divides each window
  by its count of real elements: against the JAX layer and against a
  numpy window mean at every border position.
- Every catalog architecture's eval forward at the JAX tests' small sizes
  (``tests/test_models.py``: 28x28x1 for LeNet, 67x67 for AlexNet and
  SqueezeNet, 139x139 for Inception-v3, 35x35 for the MobileNet-v2,
  Inception-v1 and DenseNet-161 (growth 4) forwards, 32x32 otherwise), in
  f32 (``compute_dtype=None``), from one set of seeded numpy weights and
  moving statistics carried into the port by ``interop.load_jax_params``
  (unnamed and counter-named layers match by order: a wrong order among
  equal shapes would show here as a forward mismatch).
- At full width (1000 classes, each architecture's published input
  size), the port's parameter and state trees against the JAX package's
  (names and shapes, the JAX side by ``jax.eval_shape``).
- A 3-step Inception-v1 trajectory at 64x64, 10 classes, dropout off on
  both sides, against the JAX ``Estimator.train`` at a small learning
  rate: losses, parameters (within 0.1 of the update's norm) and moving
  statistics (within 1e-3 of their change).
- ``build_model`` (``-quantize`` names), ``LabelReader``, ``LabelOutput``,
  ``imagenet_preprocess``, ``load_pretrained_weights`` and
  ``ImageClassifier`` (save/load through ``ZooModel``, ``predict_labels``,
  ``from_pretrained``) against the JAX package's.

Tolerances (f32): ``LAYER_TOL`` 1e-5 relative to the largest magnitude
(absolute below 1) for one layer's forward and gradients (a few dozen f32
products summed in another order); ``NET_TOL`` 1e-4 for whole networks, as
``tests/test_torch_image_models.py`` (up to 160 layers of the same
arithmetic in another order). Measured: layers up to 4.8e-7, the catalog
forwards up to 3.2e-6 (LeNet), the Inception-v1 trajectory's first loss
below 1e-5.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.data import feature_set as jfs
from analytics_zoo_tpu.engine import estimator as jest
from analytics_zoo_tpu.engine import triggers as jtrig
from analytics_zoo_tpu.keras import layers as jlayers
from analytics_zoo_tpu.keras import objectives as jobj
from analytics_zoo_tpu.keras import optimizers as jopt
from analytics_zoo_tpu.models.image import imageclassification as jic
from analytics_zoo_tpu.models.image import labels as jlabels
import analytics_zoo_tpu_torch as port
from analytics_zoo_tpu_torch.data import feature_set as tfs
from analytics_zoo_tpu_torch.engine import estimator as test_
from analytics_zoo_tpu_torch.engine import triggers as ttrig
from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.interop import (
    _counter_named,
    _natural_key,
    load_jax_params,
)
from analytics_zoo_tpu_torch.keras import layers as tlayers
from analytics_zoo_tpu_torch.keras import objectives as tobj
from analytics_zoo_tpu_torch.keras import optimizers as topt
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts
from analytics_zoo_tpu_torch.models.common import ZooModel
from analytics_zoo_tpu_torch.models.image import imageclassification as tic
from analytics_zoo_tpu_torch.models.image import labels as tlabels

LAYER_TOL = 1e-5
NET_TOL = 1e-4

# name -> build kwargs of the small forward (tests/test_models.py sizes)
SMALL = {
    "lenet": dict(input_shape=(28, 28, 1)),
    "alexnet": dict(input_shape=(67, 67, 3)),
    "vgg-16": dict(input_shape=(32, 32, 3)),
    "vgg-19": dict(input_shape=(32, 32, 3)),
    "resnet-50": dict(input_shape=(32, 32, 3)),
    "inception-v1": dict(input_shape=(35, 35, 3)),
    "inception-v3": dict(input_shape=(139, 139, 3)),
    "densenet-161": dict(input_shape=(35, 35, 3), growth_rate=4),
    "squeezenet": dict(input_shape=(67, 67, 3)),
    "mobilenet-v1": dict(input_shape=(32, 32, 3)),
    "mobilenet-v2": dict(input_shape=(35, 35, 3)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's PyTorch work. The suite runs
    several worker processes side by side on the machine's cores, and
    PyTorch's thread pools, each as wide as the machine, then slow one
    another down many times over (this module's CPU-bound training
    tests most of all). The thread count goes back for the modules the
    worker runs next."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _port_context():
    port.init_nncontext(device="cpu")
    yield
    port.stop_nncontext()
    reset_name_counts()


def _close(got, want, tol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _seeded_tree(shapes, seed):
    """Numpy values for a ``{layer: {leaf: shape}}`` tree: kernels scaled
    by 1/sqrt(fan in), BN gamma near 1, biases and betas small, moving
    means small and variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    out = {}
    for layer in sorted(shapes):
        out[layer] = {}
        for leaf in sorted(shapes[layer]):
            shape = tuple(shapes[layer][leaf])
            if len(shape) >= 2:
                fan_in = int(np.prod(shape[:-1]))
                v = rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
            elif leaf == "gamma":
                v = rng.uniform(0.8, 1.2, shape)
            elif leaf == "moving_var":
                v = rng.uniform(0.5, 1.5, shape)
            else:
                v = rng.normal(0.0, 0.1, shape)
            out[layer][leaf] = v.astype(np.float32)
    return out


def _jax_shapes(jnet):
    """(param shapes, state shapes) of a JAX model, traced only."""
    p, s = jax.eval_shape(jnet.init, jax.random.PRNGKey(0))
    return tuple({k: {n: tuple(a.shape) for n, a in v.items()}
                  for k, v in t.items()} for t in (p, s))


def _port_shapes(tnet):
    return tuple({k: {n: spec.shape for n, spec in v.items()}
                  for k, v in t.items()}
                 for t in (tnet.param_specs(), tnet.state_specs()))


def _canonical(trees):
    """The trees with each counter name (``batchnormalization_7``, from a
    per-process counter the packages need not agree on) replaced by its
    kind and its rank among that kind's names in natural order, which is
    how ``load_jax_params`` matches them."""
    out = []
    for tree in trees:
        ranks, seen = {}, {}
        for name in sorted(tree, key=_natural_key):
            if _counter_named(name):
                kind = name.rsplit("_", 1)[0]
                seen[kind] = seen.get(kind, -1) + 1
                ranks[name] = f"{kind}#{seen[kind]}"
        out.append({ranks.get(k, k): v for k, v in tree.items()})
    return tuple(out)


# ---------------------------------------------------------------------------
# Depthwise and separable layers, the SAME average pool
# ---------------------------------------------------------------------------


def _layer_pair(cls_name, args, ordering, **kw):
    jl = getattr(jlayers, cls_name)(*args, dim_ordering=ordering, **kw)
    tl = getattr(tlayers, cls_name)(*args, dim_ordering=ordering, **kw)
    shape = (2, 8, 10, 3) if ordering == "tf" else (2, 3, 8, 10)
    jl.ensure_built(shape)
    tl.ensure_built(shape)
    assert tl.output_shape == jl.output_shape
    return jl, tl, shape


@pytest.mark.parametrize("ordering", ["tf", "th"])
@pytest.mark.parametrize("multiplier", [1, 2])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("border_mode", ["valid", "same"])
@pytest.mark.parametrize("cls_name,args", [
    ("DepthwiseConvolution2D", (3,)),
    ("SeparableConvolution2D", (5, 3, 3)),
])
def test_depthwise_layers_match_jax(cls_name, args, border_mode, stride,
                                    multiplier, ordering):
    jl, tl, shape = _layer_pair(cls_name, args, ordering,
                                subsample=(stride, stride),
                                depth_multiplier=multiplier,
                                border_mode=border_mode)
    rng = np.random.default_rng(stride * 10 + multiplier)
    params = {k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in jl.init_params(jax.random.PRNGKey(0)).items()}
    assert params["depthwise"].shape[2:] == (1, 3 * multiplier)
    tparams = load_jax_params(tl, params)
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(jl.call(params, x).shape).astype(np.float32)

    jy, (jgp, jgx) = jax.value_and_grad(
        lambda p, v: (jl.call(p, v) * g).sum(), argnums=(0, 1))(params, x)
    tp = {k: v.clone().requires_grad_() for k, v in tparams.items()}
    tx = torch.tensor(x, requires_grad=True)
    y = tl.call(tp, tx)
    _close(y, jl.call(params, x), LAYER_TOL)
    (y * torch.tensor(g)).sum().backward()
    _close(tx.grad, jgx, LAYER_TOL)
    for k in params:
        _close(tp[k].grad, jgp[k], LAYER_TOL)


def test_depthwise_multiplier_orders_channels_by_group():
    """Output channel o of a depthwise convolution with multiplier m reads
    input channel o // m (XLA's feature_group_count order, which torch's
    groups=C convolution keeps)."""
    tl = tlayers.DepthwiseConvolution2D(1, depth_multiplier=2,
                                        dim_ordering="tf", bias=False)
    tl.ensure_built((None, 4, 4, 3))
    kernel = torch.ones(1, 1, 1, 6) * torch.arange(1.0, 7.0)
    x = torch.zeros(1, 4, 4, 3)
    x[..., 1] = 1.0  # only input channel 1 is lit
    y = tl.call({"depthwise": kernel}, x)[0, 0, 0]
    assert y.tolist() == [0.0, 0.0, 3.0, 4.0, 0.0, 0.0]


@pytest.mark.parametrize("size", [(5, 5), (6, 7)])
def test_same_average_pool_divides_by_the_valid_count(size):
    jl = jlayers.AveragePooling2D((3, 3), strides=(1, 1), border_mode="same",
                                  dim_ordering="tf")
    tl = tlayers.AveragePooling2D((3, 3), strides=(1, 1), border_mode="same",
                                  dim_ordering="tf")
    x = np.random.default_rng(3).standard_normal((2,) + size + (4,)).astype(
        np.float32)
    y = tl.call({}, torch.tensor(x)).numpy()
    _close(y, jl.call({}, x), LAYER_TOL)
    h, w = size
    for i in range(h):
        for j in range(w):
            window = x[:, max(i - 1, 0):i + 2, max(j - 1, 0):j + 2]
            np.testing.assert_allclose(y[:, i, j], window.mean(axis=(1, 2)),
                                       rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# The catalog
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SMALL))
def test_catalog_forward_matches_jax(name):
    kw = SMALL[name]
    jnet = jic.build_model(name, num_classes=5, **kw)
    tnet = tic.build_model(name, num_classes=5, **kw)
    jshapes = _jax_shapes(jnet)
    assert _canonical(_port_shapes(tnet)) == _canonical(jshapes)
    assert tnet.compute_dtype == jnet.compute_dtype
    jnet.compute_dtype = tnet.compute_dtype = None
    params = _seeded_tree(jshapes[0], 1)
    state = _seeded_tree(jshapes[1], 2)
    load_jax_params(tnet, params, state)
    x = np.random.default_rng(4).standard_normal(
        (2,) + kw["input_shape"]).astype(np.float32)
    jy, _ = jax.jit(lambda p, s, v: jnet.apply(p, s, v))(params, state, x)
    ty, _ = tnet.apply(tnet.params, tnet.model_state, torch.tensor(x))
    jy = np.asarray(jy)
    assert jy.shape == (2, 5)
    # the outputs carry the weights: far from a uniform distribution
    assert np.abs(jy - 0.2).max() > 1e-2
    _close(ty, jy, NET_TOL)


FULL = {  # the architectures' published input sizes
    "lenet": (28, 28, 1), "alexnet": (227, 227, 3), "vgg-16": (224, 224, 3),
    "vgg-19": (224, 224, 3), "resnet-50": (224, 224, 3),
    "inception-v1": (224, 224, 3), "inception-v3": (299, 299, 3),
    "densenet-161": (224, 224, 3), "squeezenet": (227, 227, 3),
    "mobilenet-v1": (224, 224, 3), "mobilenet-v2": (224, 224, 3),
}


@pytest.mark.parametrize("name", sorted(FULL))
def test_catalog_full_width_trees_match_jax(name):
    classes = 10 if name == "lenet" else 1000
    jnet = jic.build_model(name, num_classes=classes)
    tnet = tic.build_model(name, num_classes=classes)
    assert tnet.get_input_shape() == (None,) + FULL[name]
    assert tnet.get_output_shape() == jnet.get_output_shape()
    assert tnet.name == jnet.name
    assert _canonical(_port_shapes(tnet)) == _canonical(_jax_shapes(jnet))


def test_build_model_names_and_quantize_suffix():
    assert set(tic._CATALOG) == set(jic._CATALOG)
    assert tic.QUANTIZED_SUFFIX == jic.QUANTIZED_SUFFIX
    q = tic.build_model("MobileNet-V2-quantize", num_classes=5,
                        input_shape=(32, 32, 3))
    f = tic.build_model("mobilenet-v2", num_classes=5,
                        input_shape=(32, 32, 3))
    assert q.name == "mobilenet_v2"
    assert _port_shapes(q) == _port_shapes(f)
    with pytest.raises(ValueError, match="Unknown model"):
        tic.build_model("resnet-51")
    # served int8 through do_quantize, a no-op without params as in JAX
    im = InferenceModel()
    assert im.do_quantize() is im and im._gen == 0 and not im._quantized


# ---------------------------------------------------------------------------
# A 3-step Inception-v1 trajectory
# ---------------------------------------------------------------------------


def _no_dropout(net):
    for layer in net.layers():
        if hasattr(layer, "p"):
            layer.p = 0.0


def _inception_v1_64(ic):
    net = ic.inception_v1(num_classes=10, input_shape=(64, 64, 3),
                          bn_momentum=0.9)
    net.compute_dtype = None
    _no_dropout(net)
    return net


def _distance(a, b):
    """L2 distance between two ``{layer: {leaf: array}}`` trees."""
    return float(np.sqrt(sum(
        np.sum((np.asarray(a[k][m], np.float64)
                - np.asarray(b[k][m], np.float64)) ** 2)
        for k in b for m in b[k])))


TRAJ_FACTOR = 2.0
TRAJ_LR = 1e-4
PARAM_TOL = 0.1
STATE_TOL = 1e-3


def test_inception_v1_training_matches_jax(tmp_path):
    """Three SGD(TRAJ_LR, momentum 0.9) steps of batch 16.

    At initialization this network of 57 batch norms is chaotic: a
    rounding that flips the ReLU mask of a few elements moves some
    leaves' gradients by a few percent, so two JAX runs whose inputs
    differ by a factor 1 + 2^-22 (a rounding-sized perturbation) already
    end 4% of the update apart. At a small learning rate those flips stay
    a few percent of the update, so the parameters are held to
    PARAM_TOL (0.1) of the update's norm and the moving statistics to
    STATE_TOL of their change: an update never made reads 1.0, a
    momentum-free update 0.57 (parameters) and 1.5e-3 (statistics). The
    first loss is held within NET_TOL, the later ones to TRAJ_FACTOR
    times the two JAX runs' distance. Measured: parameters 0.023 (JAX
    against JAX 0.042), statistics 5.2e-5 (9.9e-5), losses 2.5e-4
    (2.2e-4)."""
    n, batch = 48, 16
    pshapes, sshapes = _jax_shapes(_inception_v1_64(jic))
    params = _seeded_tree(pshapes, 5)
    state = {k: {"moving_mean": np.zeros(v["moving_mean"], np.float32),
                 "moving_var": np.ones(v["moving_var"], np.float32)}
             for k, v in sshapes.items()}
    rng = np.random.default_rng(6)
    x = rng.integers(0, 256, (n, 64, 64, 3)).astype(np.uint8)
    y = rng.integers(0, 10, n).astype(np.int32)

    def jax_run(scale, app):
        net = _inception_v1_64(jic)
        net.init = lambda key: (params, state)
        est = jest.Estimator(net, jopt.SGD(lr=TRAJ_LR, momentum=0.9))
        est.set_tensorboard(str(tmp_path), app)
        fs = jfs.ArrayFeatureSet(x, y)
        fs.device_transform = lambda v: (
            (v.astype(jnp.float32) - 127.5) / 127.5 * scale)
        est.train(fs, jobj.sparse_categorical_crossentropy,
                  end_trigger=jtrig.MaxEpoch(1), batch_size=batch)
        losses = [v for _, v in est.train_summary.read_scalar("Loss")]
        return (losses, jax.tree_util.tree_map(np.asarray, est.tstate.params),
                jax.tree_util.tree_map(np.asarray, est.tstate.model_state))

    ref = jax_run(1.0, "ref")
    moved = jax_run(np.float32(1 + 2 ** -22), "moved")

    tnet = _inception_v1_64(tic)
    load_jax_params(tnet, params, state)
    tset = tfs.ArrayFeatureSet(x, y)
    tset.device_transform = lambda v: (v.float() - 127.5) / 127.5
    est = test_.Estimator(tnet, topt.SGD(lr=TRAJ_LR, momentum=0.9))
    est.train(tset, tobj.sparse_categorical_crossentropy,
              end_trigger=ttrig.MaxEpoch(1), batch_size=batch)
    got = (est.train_losses,
           {k: {m: t.numpy() for m, t in v.items()}
            for k, v in est.tstate.params.items()},
           {k: {m: t.numpy() for m, t in v.items()}
            for k, v in est.tstate.model_state.items()})

    assert len(got[0]) == len(ref[0]) == n // batch
    assert abs(got[0][0] - ref[0][0]) <= NET_TOL * max(1.0, ref[0][0])
    port_dev = np.abs(np.subtract(got[0], ref[0])).max()
    jax_dev = np.abs(np.subtract(moved[0], ref[0])).max()
    assert port_dev <= TRAJ_FACTOR * jax_dev + 1e-6, (port_dev, jax_dev)

    assert set(got[1]) == set(ref[1]) and set(got[2]) == set(ref[2])
    update = _distance(ref[1], params)
    change = _distance(ref[2], state)
    for name, i, start, norm, tol in (
            ("params", 1, params, update, PARAM_TOL),
            ("state", 2, state, change, STATE_TOL)):
        # parity is defined here: two JAX runs agree within the bound,
        # and a tree that never moved fails it
        assert _distance(moved[i], ref[i]) / norm <= tol, name
        assert _distance(start, ref[i]) / norm > tol, name
        dev = _distance(got[i], ref[i]) / norm
        assert dev <= tol, (name, dev)


# ---------------------------------------------------------------------------
# Labels and the ImageClassifier wrapper
# ---------------------------------------------------------------------------


def test_label_reader_output_and_preprocess_match_jax():
    for model_name in (None, "inception-v3"):
        assert tlabels.LabelReader.read_imagenet(model_name) == \
            jlabels.LabelReader.read_imagenet(model_name)
    assert tlabels.LabelReader.read_pascal() == \
        jlabels.LabelReader.read_pascal()
    assert tlabels.LabelReader.read_coco() == jlabels.LabelReader.read_coco()
    assert len(tlabels.LabelReader.read_imagenet()) == 1000
    assert tlabels._RES.endswith("analytics_zoo_tpu_torch/resources")

    probs = np.random.default_rng(7).dirichlet(np.ones(1000), 3)
    names = tlabels.LabelReader.read_imagenet()
    for label_map in (None, names):
        assert tic.LabelOutput(label_map, 5)(probs) == \
            jic.LabelOutput(label_map, 5)(probs)
    images = np.random.default_rng(8).integers(0, 256, (2, 8, 8, 3))
    for mode in (None, "tf", "torch", "caffe"):
        np.testing.assert_array_equal(tic.imagenet_preprocess(images, mode),
                                      jic.imagenet_preprocess(images, mode))
    with pytest.raises(ValueError, match="preprocess mode"):
        tic.imagenet_preprocess(images, "bgr")
    # the catalog's published-weights preprocessing, as the JAX table has it
    assert tic._PREPROCESS == {k: mode for k, (_, mode)
                               in jic._KERAS_APPS.items()
                               if k in jic._CATALOG and mode}


def test_image_classifier_save_load_and_labels(tmp_path):
    kw = dict(num_classes=1000, input_shape=(32, 32, 3))
    clf = tic.ImageClassifier("squeezenet", **kw)
    jclf = jic.ImageClassifier("squeezenet", **kw)
    assert clf.config() == jclf.config()
    jclf.model.compute_dtype = clf.model.compute_dtype = None
    params = _seeded_tree(_jax_shapes(jclf.model)[0], 9)
    jclf.model.set_weights(params)
    load_jax_params(clf.model, params)
    images = np.random.default_rng(10).integers(0, 256, (3, 32, 32, 3))
    top = clf.predict_labels(images, top_k=5, batch_size=3)
    want = jclf.predict_labels(images, top_k=5, batch_size=3)
    assert [[n for n, _ in row] for row in top] == \
        [[n for n, _ in row] for row in want]
    for row, wrow in zip(top, want):
        np.testing.assert_allclose([c for _, c in row], [c for _, c in wrow],
                                   rtol=0, atol=NET_TOL)

    path = str(tmp_path / "clf")
    clf.save_model(path)
    back = ZooModel.load_model(path)
    assert isinstance(back, tic.ImageClassifier)
    assert back.config() == json.loads(json.dumps(clf.config()))
    back.model.compute_dtype = None
    assert back.predict_labels(images, top_k=5, batch_size=3) == top

    # from_pretrained with a framework checkpoint (1000 classes, the
    # architecture's own input size), and the same file through weights=
    full = tic.ImageClassifier("squeezenet")
    full.model.save_weights(str(tmp_path / "w"))
    pre = tic.ImageClassifier.from_pretrained("SqueezeNet",
                                              str(tmp_path / "w"))
    assert pre.model_name == "squeezenet" and pre.preprocess_mode is None
    x = np.random.default_rng(11).standard_normal((1, 227, 227, 3)).astype(
        np.float32)
    want = full.predict(x, batch_size=1)
    np.testing.assert_array_equal(pre.predict(x, batch_size=1), want)
    again = tic.ImageClassifier("squeezenet", weights=str(tmp_path / "w"))
    np.testing.assert_array_equal(again.predict(x, batch_size=1), want)
    assert tic.load_pretrained_weights(again.model, str(tmp_path / "w")) \
        == [l.name for l in again.model.layers() if l.weight_specs]
    with pytest.raises(ValueError, match="unrecognized weights path"):
        tic.load_pretrained_weights(again.model, str(tmp_path / "none"))
    # a Keras .h5 weight file pours by name (tests/test_torch_foreign_
    # import.py); a missing one is reported as such, by load_pretrained_
    # weights and by from_pretrained, which reads a Keras file through the
    # architecture converter (tests/test_torch_keras_convert.py)
    with pytest.raises(OSError):
        tic.load_pretrained_weights(again.model, str(tmp_path / "w.h5"))
    with pytest.raises(OSError):
        tic.ImageClassifier.from_pretrained("resnet-50",
                                            str(tmp_path / "w.h5"))
