"""ResNet and LeNet in the port against the JAX package, on the CPU.

- A narrow ResNet built from each package's own ``_conv_bn`` and
  ``_bottleneck`` (a 7x7/2 stem and a 3x3/2 max pool, both padded
  asymmetrically on their even inputs; bottlenecks of 8 and 16 filters in
  two stages, the second strided; 32x32x3 input; BN momentum 0.9), with
  the JAX weights and state carried over by ``load_jax_params``: the
  training-mode and eval-mode forward, then a 3-step ``Estimator.train``
  (24 uint8 images, batch 8, ``device_transform`` (x - 127.5) / 127.5 on a
  device-cached set, SGD(0.1, momentum 0.9), sparse cross-entropy from
  logits) against the JAX ``Estimator.train`` on the same data: per-step
  losses, the parameters and the moving statistics. Batch and set size are
  multiples of the JAX test mesh's 8 devices, so no wrap-padded row enters
  the batch statistics. The JAX step's statistics are over the whole batch
  (a ``jit`` over the batch-sharded input reduces across shards); the
  trajectory test holds the port's whole-batch statistics to it.
- ``resnet_50(num_classes=10, input_shape=(32, 32, 3))``: the parameter
  and state trees equal in names and shapes; one eval forward at batch 2
  in f32 from carried weights and state.
- LeNet-5 through ``compile``/``fit`` for 2 epochs against the JAX
  package's ``fit`` (counter-named layers, matched by order).
- The three state faults: ``Estimator.train`` writes the trained state
  back, ``InferenceModel`` serves it (equal to ``Estimator.predict``), and
  ``load_jax_params`` carries the JAX state.

Tolerances (f32, ``compute_dtype=None``): ``NET_TOL`` = 1e-4 relative to
the largest magnitude of each compared tensor (absolute where that is
below 1): the same f32 arithmetic in another order through up to 53
convolutions and batch norms. Measured (as a share of that magnitude): the
narrow forward 2.9e-6, its 3-step trajectory 8.5e-7, the ResNet-50 eval
forward 2.4e-7, LeNet's 8-step losses 1.5e-6.
"""

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
from analytics_zoo_tpu.keras.engine import topology as jtopo
from analytics_zoo_tpu.models.image import imageclassification as jic
import analytics_zoo_tpu_torch as port
from analytics_zoo_tpu_torch.common.tree import tree_leaves
from analytics_zoo_tpu_torch.data import feature_set as tfs
from analytics_zoo_tpu_torch.engine import estimator as test_
from analytics_zoo_tpu_torch.engine import triggers as ttrig
from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.interop import load_jax_params
from analytics_zoo_tpu_torch.keras import layers as tlayers
from analytics_zoo_tpu_torch.keras import objectives as tobj
from analytics_zoo_tpu_torch.keras import optimizers as topt
from analytics_zoo_tpu_torch.keras.engine import topology as ttopo
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts
from analytics_zoo_tpu_torch.models.image import imageclassification as tic

NET_TOL = 1e-4
N_IMAGES, BATCH = 24, 8


@pytest.fixture(autouse=True)
def _port_context():
    port.init_nncontext(device="cpu")
    yield
    port.stop_nncontext()
    reset_name_counts()


def _close(got, want, tol=NET_TOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _narrow(ic, layers, topo):
    inp = topo.Input(shape=(32, 32, 3), name="image")
    x = ic._conv_bn(inp, 8, (7, 7), stride=2, name="stem", momentum=0.9)
    x = layers.MaxPooling2D((3, 3), strides=(2, 2), border_mode="same",
                            dim_ordering="tf")(x)
    x = ic._bottleneck(x, 8, 1, True, "res2a", momentum=0.9)
    x = ic._bottleneck(x, 8, 1, False, "res2b", momentum=0.9)
    x = ic._bottleneck(x, 16, 2, True, "res3a", momentum=0.9)
    x = layers.GlobalAveragePooling2D(dim_ordering="tf")(x)
    x = layers.Dense(10, name="fc1000")(x)
    return topo.Model(inp, x, name="narrow")


def _images(seed, n=N_IMAGES):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (n, 32, 32, 3)).astype(np.uint8)
    return x, rng.integers(0, 10, n).astype(np.int32)


def _normalise(x):
    return ((x.astype(np.float32) - 127.5) / 127.5).astype(np.float32)


def _perturbed_state(jstate, seed):
    rng = np.random.default_rng(seed)
    return {layer: {"moving_mean": rng.normal(0, 0.2, s["moving_mean"].shape
                                              ).astype(np.float32),
                    "moving_var": rng.uniform(0.5, 1.5, s["moving_var"].shape
                                              ).astype(np.float32)}
            for layer, s in jstate.items()}


def _assert_trees_close(port_tree, jax_tree, tol=NET_TOL):
    """Leaf by leaf, matched by layer name (every layer of these models is
    named explicitly)."""
    assert set(port_tree) == set(jax_tree)
    for layer, leaves in port_tree.items():
        assert set(leaves) == set(jax_tree[layer])
        for k, v in leaves.items():
            _close(v, jax_tree[layer][k], tol)


def test_narrow_resnet_forward_matches_jax():
    jnet = _narrow(jic, jlayers, jtopo)
    tnet = _narrow(tic, tlayers, ttopo)
    jparams, jstate = jnet.init(jax.random.PRNGKey(0))
    jstate = _perturbed_state(jstate, 1)
    load_jax_params(tnet, jparams, jstate)
    x = _normalise(_images(2, 8)[0])
    for training in (True, False):
        jout, jnew = jax.jit(lambda p, s, v: jnet.apply(
            p, s, v, training=training))(jparams, jstate, x)
        tout, tnew = tnet.apply(tnet.params, tnet.model_state,
                                torch.tensor(x), training=training)
        _close(tout, jout)
        _assert_trees_close(tnew, jnew)
        if not training:  # eval returns the state it was given
            assert all(tnew[k] is tnet.model_state[k] for k in tnew)


def _jax_trajectory(tmp_path):
    jnet = _narrow(jic, jlayers, jtopo)
    est = jest.Estimator(jnet, jopt.SGD(lr=0.1, momentum=0.9))
    est._ensure_state()
    init = jax.tree_util.tree_map(np.asarray, (est.tstate.params,
                                               est.tstate.model_state))
    est.set_tensorboard(str(tmp_path), "jax")
    x, y = _images(0)
    fs = jfs.ArrayFeatureSet(x, y)
    fs.device_transform = lambda v: (v.astype(jnp.float32) - 127.5) / 127.5
    est.train(fs, jobj.sparse_categorical_crossentropy_from_logits,
              end_trigger=jtrig.MaxEpoch(1), batch_size=BATCH)
    losses = [v for _, v in est.train_summary.read_scalar("Loss")]
    final = jax.tree_util.tree_map(np.asarray, (est.tstate.params,
                                                est.tstate.model_state))
    pred = np.asarray(est.predict(jfs.ArrayFeatureSet(_normalise(x)), BATCH))
    return init, losses, final, pred


def _port_trained(init):
    tnet = _narrow(tic, tlayers, ttopo)
    load_jax_params(tnet, *init)
    x, y = _images(0)
    fs = tfs.ArrayFeatureSet(x, y)
    fs.device_transform = lambda v: (v.float() - 127.5) / 127.5
    cached = fs.cache_device()  # the transform rides along
    assert cached.device_transform is fs.device_transform
    est = test_.Estimator(tnet, topt.SGD(lr=0.1, momentum=0.9))
    est.train(cached, tobj.sparse_categorical_crossentropy_from_logits,
              end_trigger=ttrig.MaxEpoch(1), batch_size=BATCH)
    return tnet, est, cached


def test_narrow_resnet_training_matches_jax(tmp_path):
    init, j_losses, (j_params, j_state), j_pred = _jax_trajectory(tmp_path)
    tnet, est, cached = _port_trained(init)
    assert len(est.train_losses) == len(j_losses) == N_IMAGES // BATCH
    np.testing.assert_allclose(est.train_losses, j_losses, rtol=0,
                               atol=NET_TOL)
    _assert_trees_close(est.tstate.params, j_params)
    _assert_trees_close(est.tstate.model_state, j_state)
    # predict applies the set's device_transform, as training did
    _close(est.predict(cached, BATCH), j_pred)


def test_train_writes_back_the_state_and_serving_uses_it(tmp_path):
    """Regression: ``Estimator.train`` wrote back the parameters only, and
    a model trained in the port was served with its initial moving
    statistics (mean 0, variance 1)."""
    jnet = _narrow(jic, jlayers, jtopo)
    init = jax.tree_util.tree_map(np.asarray,
                                  jnet.init(jax.random.PRNGKey(3)))
    tnet, est, cached = _port_trained(init)
    assert tnet.params is est.tstate.params
    assert tnet.model_state is est.tstate.model_state
    for layer, s in tnet.model_state.items():
        for k, v in s.items():
            assert not np.allclose(v.numpy(), init[1][layer][k])
    x = _normalise(_images(0)[0])
    pred = est.predict(cached, BATCH)
    im = InferenceModel().do_load_keras(tnet)
    for layer, s in im.model_state.items():
        for k, v in s.items():
            assert torch.equal(v, tnet.model_state[layer][k])
    np.testing.assert_array_equal(im.do_predict(x), pred)
    # the initial statistics serve something else
    stale = InferenceModel()
    tnet.model_state = {k: {n: torch.tensor(a) for n, a in v.items()}
                        for k, v in init[1].items()}
    assert np.abs(stale.do_load_keras(tnet).do_predict(x) - pred).max() > 0.1


def test_load_jax_params_carries_the_state():
    """Regression: ``load_jax_params`` set ``model_state`` to {}; it now
    fills it from the JAX state tree, or with the model's initial state."""
    jnet = _narrow(jic, jlayers, jtopo)
    jparams, jstate = jnet.init(jax.random.PRNGKey(0))
    jstate = _perturbed_state(jstate, 4)
    tnet = _narrow(tic, tlayers, ttopo)
    load_jax_params(tnet, jparams, jstate)
    _assert_trees_close(tnet.model_state, jstate, tol=0)
    _assert_trees_close(tnet.params, jparams, tol=0)
    load_jax_params(tnet, jparams)
    assert set(tnet.model_state) == set(jstate)
    for s in tnet.model_state.values():
        assert torch.equal(s["moving_mean"], torch.zeros_like(
            s["moving_mean"]))
        assert torch.equal(s["moving_var"], torch.ones_like(s["moving_var"]))
    with pytest.raises(ValueError, match="missing leaf"):
        load_jax_params(tnet, jparams, {k: {"moving_mean": v["moving_mean"]}
                                        for k, v in jstate.items()})


def test_resnet50_trees_and_eval_forward_match_jax():
    jnet = jic.resnet_50(num_classes=10, input_shape=(32, 32, 3))
    tnet = tic.resnet_50(num_classes=10, input_shape=(32, 32, 3))
    assert tnet.compute_dtype == jnet.compute_dtype == "bfloat16"
    jparams, jstate = jnet.init(jax.random.PRNGKey(0))
    tparams, tstate = tnet.init(torch.Generator().manual_seed(0))
    for tt, jt in ((tparams, jparams), (tstate, jstate)):
        assert set(tt) == set(jt)
        for layer in tt:
            assert {k: tuple(v.shape) for k, v in tt[layer].items()} == {
                k: tuple(v.shape) for k, v in jt[layer].items()}
    assert len(tparams) == 107 and len(tstate) == 53
    assert tnet.get_output_shape() == (None, 10)
    jnet.compute_dtype = tnet.compute_dtype = None
    jstate = _perturbed_state(jstate, 5)
    load_jax_params(tnet, jparams, jstate)
    x = np.random.default_rng(6).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    jout, _ = jax.jit(lambda p, s, v: jnet.apply(p, s, v))(jparams, jstate,
                                                           x)
    tout, _ = tnet.apply(tnet.params, tnet.model_state, torch.tensor(x))
    _close(tout, jout)


def test_lenet_fit_matches_jax(tmp_path):
    tic.lenet()  # offsets the port's layer counters: names match by order
    rng = np.random.default_rng(7)
    x = rng.standard_normal((32, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, 32).astype(np.int32)
    jnet = jic.lenet()
    jnet.compile(jopt.Adam(lr=1e-3), "sparse_categorical_crossentropy",
                 ["accuracy"])
    jest_ = jnet._get_estimator()
    jest_._ensure_state()
    init = jax.tree_util.tree_map(np.asarray, jest_.tstate.params)
    jnet.set_tensorboard(str(tmp_path), "lenet")
    jnet.fit(x, y, batch_size=BATCH, nb_epoch=2)
    j_losses = [v for _, v in jnet.get_train_summary("Loss")]
    j_final = jax.tree_util.tree_map(np.asarray, jest_.tstate.params)

    tnet = tic.lenet()
    assert [l.name for l in tnet.layers()][0] == "convolution2d_3"
    load_jax_params(tnet, init)
    tnet.compile(topt.Adam(lr=1e-3), "sparse_categorical_crossentropy",
                 ["accuracy"])
    tnet.fit(x, y, batch_size=BATCH, nb_epoch=2)
    est = tnet._estimator
    assert len(est.train_losses) == len(j_losses) == 8
    np.testing.assert_allclose(est.train_losses, j_losses, rtol=0,
                               atol=NET_TOL)
    for a, b in zip(tree_leaves(tnet.params),
                    tree_leaves(load_jax_params(tic.lenet(), j_final)),
                    strict=True):
        _close(a, b.numpy())
    _close(tnet.predict(x, batch_size=BATCH), jnet.predict(x, BATCH))
