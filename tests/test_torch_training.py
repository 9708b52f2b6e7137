"""The PyTorch port's training slice against the JAX package.

Objectives, metrics, optimizers, triggers and feature sets are held to
their JAX counterparts on the same numpy inputs. Then a small
BERTClassifierNet (2 blocks, hidden 64, 2 heads, seq 128, vocab 128) trains
20 samples for 2 epochs at batch 8 (the tail batch is wrap-padded and
masked) with SGD(0.01, momentum=0.9), through the port's ``Estimator.train``
and through ``compile``/``fit``, from the JAX package's initial weights
carried over by ``load_jax_params``; the per-step losses, the final
parameters, ``evaluate`` and ``predict`` are held to the JAX package's
``Estimator.train`` on the same data. The port runs on the reference
attention route and on the forced plain-kernel route (its autograd Function
on the plain versions of the CUDA kernels); the JAX side runs its default
route on the CPU.

Tolerances: objectives, metrics and optimizer steps f32 1e-6 (the same
float32 arithmetic). Training in f32 (``compute_dtype=None``): losses,
parameters and predictions 1e-5 absolute after 6 steps — every op is f32 in
both frameworks, but XLA on an 8-device CPU mesh and eager PyTorch sum in
other orders (measured: 4e-7 on losses, 1.2e-7 on parameters that moved by
0.04). bf16 compute: see ``BF16_LOSS_TOL``, ``BF16_UPDATE_TOL`` and
``BF16_PRED_TOL``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import analytics_zoo_tpu_torch as port
import analytics_zoo_tpu_torch.ops.attention as port_attention
from analytics_zoo_tpu.data import feature_set as jfs
from analytics_zoo_tpu.engine import estimator as jest
from analytics_zoo_tpu.engine import triggers as jtrig
from analytics_zoo_tpu.keras import metrics as jmetrics
from analytics_zoo_tpu.keras import objectives as jobj
from analytics_zoo_tpu.keras import layers as jlayers
from analytics_zoo_tpu.keras import optimizers as jopt
from analytics_zoo_tpu.keras.engine import base as jbase
from analytics_zoo_tpu.keras.engine import topology as jtopo
from analytics_zoo_tpu.tfpark.bert import BERTClassifierNet as JaxBERT
from analytics_zoo_tpu_torch.common.tree import tree_leaves
from analytics_zoo_tpu_torch.data import feature_set as tfs
from analytics_zoo_tpu_torch.engine import estimator as test_
from analytics_zoo_tpu_torch.engine import triggers as ttrig
from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.interop import load_jax_params
from analytics_zoo_tpu_torch.keras import metrics as tmetrics
from analytics_zoo_tpu_torch.keras import objectives as tobj
from analytics_zoo_tpu_torch.keras import layers
from analytics_zoo_tpu_torch.keras import optimizers as topt
from analytics_zoo_tpu_torch.keras.engine import topology as topo
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts
from analytics_zoo_tpu_torch.keras.engine.topology import Sequential
from analytics_zoo_tpu_torch.keras.layers import Dense
from analytics_zoo_tpu_torch.ops import flash_attention as tfa
from analytics_zoo_tpu_torch.pipeline import StagePlan
from analytics_zoo_tpu_torch.tfpark.bert import BERTClassifierNet

CFG = dict(vocab=128, hidden_size=64, n_block=2, n_head=2, seq_len=128,
           intermediate_size=128, hidden_drop=0.0, attn_drop=0.0)
N_SAMPLES, BATCH, EPOCHS = 20, 8, 2
STEPS = EPOCHS * -(-N_SAMPLES // BATCH)
F32_TOL = 1e-5  # losses, parameters and predictions (module docstring)
# bf16 compute: the frameworks round to bf16 at different places (XLA keeps
# f32 inside its fusions, eager PyTorch rounds after every op), so each op
# of the forward and backward can differ by a bf16 ulp (2^-8 relative), and
# that compounds over 2 blocks and 6 steps.
# - losses near 0.7, 2e-2 absolute: about five bf16 ulps there (2^-8 at
#   0.5-1); measured 8.1e-3 (reference route) and 9.6e-3 (plain kernel).
BF16_LOSS_TOL = 2e-2
# - parameters, per leaf: |port - jax|_2 <= 0.2 * |jax update|_2, where the
#   update is the JAX run's final minus initial value of that leaf. Measured
#   at most 0.035 of the update on every leaf but the token-type table,
#   whose gradient sums 1024 rows per step in bf16 on both sides (0.081);
#   an absolute bound would sit near the whole update of the small leaves.
BF16_UPDATE_TOL = 0.2
# - class probabilities, 2e-2 absolute: a few bf16 ulps of logits that
#   differ as the losses do; measured 9.3e-3.
BF16_PRED_TOL = 2e-2


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


def _t(a):
    return torch.tensor(np.asarray(a))


# -- objectives, metrics, optimizers, triggers, feature sets ---------------


def _objective_inputs(rng):
    logits = rng.standard_normal((6, 4)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    probs[0, 1] = 0.0  # exercises the _EPS clip
    labels = rng.integers(0, 4, 6).astype(np.int32)
    onehot = np.eye(4, dtype=np.float32)[labels]
    return logits, probs, labels, onehot


@pytest.mark.parametrize("name", [
    "sparse_categorical_crossentropy",
    "sparse_categorical_crossentropy_from_logits",
    "categorical_crossentropy", "categorical_crossentropy_from_logits",
    "mean_squared_error"])
def test_objectives_match_jax(name):
    logits, probs, labels, onehot = _objective_inputs(
        np.random.default_rng(0))
    y_true = labels if name.startswith("sparse") else onehot
    y_pred = logits if name.endswith("logits") else probs
    jf, tf = jobj.get(name), tobj.get(name)
    for yt in ([y_true, y_true[:, None]] if name.startswith("sparse")
               else [y_true]):
        np.testing.assert_allclose(
            tf(_t(yt), _t(y_pred)).numpy(),
            np.asarray(jf(jnp.asarray(yt), jnp.asarray(y_pred))),
            rtol=0, atol=1e-6)
        np.testing.assert_allclose(
            tobj.get_per_sample(tf)(_t(yt), _t(y_pred)).numpy(),
            np.asarray(jobj.get_per_sample(jf)(jnp.asarray(yt),
                                               jnp.asarray(y_pred))),
            rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="Unknown loss"):
        tobj.get("no_such_loss")


@pytest.mark.parametrize("metric", ["accuracy", "sparse_categorical_accuracy",
                                    "loss"])
@pytest.mark.parametrize("masked", [False, True])
def test_metrics_match_jax(metric, masked):
    rng = np.random.default_rng(1)
    _, probs, labels, onehot = _objective_inputs(rng)
    mask = np.array([1, 1, 1, 1, 0, 0], np.float32) if masked else None
    if metric == "loss":
        jm = jmetrics.Loss(jobj.sparse_categorical_crossentropy)
        tm = tmetrics.Loss(tobj.sparse_categorical_crossentropy)
    else:
        jm, tm = jmetrics.get(metric), tmetrics.get(metric)
    for y in (labels, onehot) if metric == "accuracy" else (labels,):
        js, jc = jm.batch_stats(jnp.asarray(y), jnp.asarray(probs),
                                None if mask is None else jnp.asarray(mask))
        ts, tc = tm.batch_stats(_t(y), _t(probs),
                                None if mask is None else _t(mask))
        np.testing.assert_allclose(ts.item(), float(js), rtol=0, atol=1e-6)
        assert tc.item() == float(jc)
        assert tm.finalize(ts.item(), tc.item()) == pytest.approx(
            jm.finalize(float(js), float(jc)), abs=1e-6)


@pytest.mark.parametrize("name,kw", [
    ("SGD", dict(lr=0.1)),
    ("SGD", dict(lr=0.1, momentum=0.9)),
    ("SGD", dict(lr=0.1, momentum=0.9, nesterov=True)),
    ("SGD", dict(lr=0.1, momentum=0.9, decay=0.5)),
    ("Adam", dict(lr=0.01)),
    ("Adam", dict(lr=0.01, beta_1=0.8, decay=0.3)),
])
def test_optimizer_steps_match_optax(name, kw):
    """Two updates from the same params and grads: optax (through the JAX
    package's factories) and the port's functional pair."""
    rng = np.random.default_rng(2)
    params = {"dense": {"kernel": rng.standard_normal((3, 4)),
                        "bias": rng.standard_normal(4)}}
    params = jax.tree_util.tree_map(lambda a: a.astype(np.float32), params)
    grads = [jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
        for _ in range(2)]
    jtx, ttx = getattr(jopt, name)(**kw), getattr(topt, name)(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = jax.tree_util.tree_map(_t, params)
    js, ts = jtx.init(jp), ttx.init(tp)
    for g in grads:
        ju, js = jtx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update(jax.tree_util.tree_map(_t, g), ts, tp)
        tp = {k: {n: tp[k][n] + tu[k][n] for n in tp[k]} for k in tp}
        for n in ("kernel", "bias"):
            np.testing.assert_allclose(tp["dense"][n].numpy(),
                                       np.asarray(jp["dense"][n]), rtol=0,
                                       atol=1e-6)
    assert topt.get("sgd").init(tp)["count"] == 0
    assert isinstance(topt.get(topt.Adam), topt.GradientTransformation)


@pytest.mark.parametrize("trigger", [
    ("MaxEpoch", (2,)), ("MaxIteration", (5,)), ("EveryEpoch", ()),
    ("SeveralIteration", (3,)), ("MinLoss", (0.5,)), ("MaxScore", (0.9,))])
def test_triggers_match_jax(trigger):
    name, args = trigger
    states = [dict(epoch=e, iteration=i, epoch_finished=f, loss=l, score=s)
              for e, i, f, l, s in [(0, 0, False, 9.0, -1.0),
                                    (1, 3, True, 0.5, 0.95),
                                    (2, 6, True, 0.2, 0.5),
                                    (1, 5, False, 0.7, 0.9)]]
    j, t = getattr(jtrig, name)(*args), getattr(ttrig, name)(*args)
    both = [getattr(jtrig, "And")(j, jtrig.EveryEpoch()),
            getattr(jtrig, "Or")(j, jtrig.MaxIteration(6))]
    tboth = [ttrig.And(t, ttrig.EveryEpoch()),
             ttrig.Or(t, ttrig.MaxIteration(6))]
    for st in states:
        js, ts = jtrig.RunState(**st), ttrig.RunState(**st)
        assert t(ts) == j(js)
        assert [f(ts) for f in tboth] == [f(js) for f in both]
    assert test_._uses_loss(t) == jest._uses_loss(j)


def _bert_data(seed, n=N_SAMPLES, seq=128, vocab=128):
    rng = np.random.default_rng(seed)
    lens = rng.integers(seq // 8, seq + 1, n)
    pos = np.arange(seq)[None, :]
    mask = (pos < lens[:, None]).astype(np.float32)
    ids = (rng.integers(1, vocab, (n, seq)) * mask).astype(np.int32)
    types = ((pos >= lens[:, None] // 2) * mask).astype(np.int32)
    y = rng.integers(0, 2, n).astype(np.int32)
    return [ids, types, mask], y


def test_feature_set_batches_match_jax():
    x, y = _bert_data(3)
    jset, tset = jfs.ArrayFeatureSet(x, y), tfs.ArrayFeatureSet(x, y)
    for seed in range(3):
        for (ji, jm), (ti, tm) in zip(
                jset.train_index_batches(BATCH, shuffle=True, seed=seed),
                tset.train_index_batches(BATCH, shuffle=True, seed=seed),
                strict=True):
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tm, jm)
    for (ji, jm), (ti, tm) in zip(jset.eval_index_batches(BATCH),
                                  tset.eval_index_batches(BATCH),
                                  strict=True):
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tm, jm)
    assert tset.steps_per_epoch(BATCH) == 3
    cached = tset.cache_device()
    idx = next(tset.train_index_batches(BATCH, seed=1))[0]
    gx, gy = cached.gather(torch.tensor(idx))
    hx, hy = tset.take(idx)
    for a, b in zip(gx + [gy], hx + [hy]):
        np.testing.assert_array_equal(a.numpy(), b)
    x[0][:] = 0  # the cache holds copies, not the caller's arrays
    assert cached.device_xs[0].abs().sum() > 0


# -- the slice: small BERT trained by both packages ------------------------


def _jax_reference(compute_dtype, tmp_path):
    """The JAX package's Estimator.train on the host feature set: initial
    params, per-step losses, final params, evaluate and predict."""
    jnet = JaxBERT(num_classes=2, **CFG)
    jnet.compute_dtype = compute_dtype
    est = jest.Estimator(jnet, jopt.SGD(lr=0.01, momentum=0.9))
    est._ensure_state()
    init = jax.tree_util.tree_map(np.asarray, est.tstate.params)
    est.set_tensorboard(str(tmp_path), "jax")
    x, y = _bert_data(0)
    est.train(jfs.ArrayFeatureSet(x, y), jobj.sparse_categorical_crossentropy,
              end_trigger=jtrig.MaxEpoch(EPOCHS), batch_size=BATCH)
    losses = [v for _, v in est.train_summary.read_scalar("Loss")]
    final = jax.tree_util.tree_map(np.asarray, est.tstate.params)
    ev = est.evaluate(jfs.ArrayFeatureSet(x, y),
                      [jmetrics.Loss(jobj.sparse_categorical_crossentropy),
                       jmetrics.Accuracy()], BATCH)
    pred = np.asarray(est.predict(jfs.ArrayFeatureSet(x), BATCH))
    return init, losses, final, ev, pred


@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    return {dt: _jax_reference(None if dt == "float32" else dt,
                               tmp_path_factory.mktemp(dt))
            for dt in ("float32", "bfloat16")}


def _port_net(init, compute_dtype):
    net = BERTClassifierNet(num_classes=2, **CFG)
    net.compute_dtype = compute_dtype
    load_jax_params(net, init)
    return net


def _carried_leaves(jax_params):
    # map by structure, as the weights were carried over
    return tree_leaves(load_jax_params(
        BERTClassifierNet(num_classes=2, **CFG), jax_params))


def _assert_params_close(net_params, jax_params, tol):
    for a, b in zip(tree_leaves(net_params), _carried_leaves(jax_params),
                    strict=True):
        np.testing.assert_allclose(a.detach().cpu().numpy(), b.numpy(),
                                   rtol=0, atol=tol)


def _assert_updates_close(net_params, jax_init, jax_final, rel):
    """Per leaf, |port - jax|_2 <= rel * |jax final - jax initial|_2."""
    for a, b, b0 in zip(tree_leaves(net_params), _carried_leaves(jax_final),
                        _carried_leaves(jax_init), strict=True):
        gap = torch.linalg.vector_norm(a.detach().cpu() - b).item()
        update = torch.linalg.vector_norm(b - b0).item()
        assert gap <= rel * update, (tuple(b.shape), gap, update)


@pytest.fixture(params=["reference", "plain_kernel"])
def route(request, monkeypatch):
    calls = {"fwd": 0, "bwd": 0}
    if request.param == "plain_kernel":
        monkeypatch.setattr(port_attention, "_auto_use_flash",
                            lambda q, k: True)
        fwd, bwd = tfa._flash_forward_plain, tfa._flash_backward_plain

        def count(name, fn):
            def wrapped(*a, **kw):
                calls[name] += 1
                return fn(*a, **kw)
            return wrapped

        monkeypatch.setattr(tfa, "_flash_forward_plain", count("fwd", fwd))
        monkeypatch.setattr(tfa, "_flash_backward_plain", count("bwd", bwd))
    return request.param, calls


@pytest.mark.parametrize("surface", ["estimator", "fit"])
def test_bert_training_matches_jax(jax_reference, route, surface):
    init, j_losses, j_final, j_eval, j_pred = jax_reference["float32"]
    net = _port_net(init, None)
    x, y = _bert_data(0)
    if surface == "estimator":
        est = test_.Estimator(net, topt.SGD(lr=0.01, momentum=0.9))
        est.train(tfs.ArrayFeatureSet(x, y).cache_device(),
                  tobj.sparse_categorical_crossentropy,
                  end_trigger=ttrig.MaxEpoch(EPOCHS), batch_size=BATCH)
    else:
        net.compile(topt.SGD(lr=0.01, momentum=0.9),
                    "sparse_categorical_crossentropy", ["accuracy"])
        net.fit(x, y, batch_size=BATCH, nb_epoch=1)
        net.fit(x, y, batch_size=BATCH, nb_epoch=1)  # epochs continue
        est = net._estimator
    assert est.run_state.epoch == EPOCHS and est.run_state.iteration == STEPS
    np.testing.assert_allclose(est.train_losses, j_losses, rtol=0,
                               atol=F32_TOL)
    assert net.params is est.tstate.params  # written back by train
    _assert_params_close(net.params, j_final, F32_TOL)

    ev = est.evaluate(tfs.ArrayFeatureSet(x, y),
                      [tmetrics.Loss(tobj.sparse_categorical_crossentropy),
                       tmetrics.Accuracy()], BATCH)
    assert ev["accuracy"] == j_eval["accuracy"]
    assert ev["loss"] == pytest.approx(j_eval["loss"], abs=F32_TOL)
    pred = est.predict(tfs.ArrayFeatureSet(x), BATCH)
    assert pred.shape == (N_SAMPLES, 2) and pred.dtype == np.float32
    np.testing.assert_allclose(pred, j_pred, rtol=0, atol=F32_TOL)
    # the trained parameters serve
    served = InferenceModel().do_load_keras(net).do_predict(x)
    np.testing.assert_array_equal(served, pred)
    name, calls = route
    if name == "plain_kernel":  # one forward and one backward per block
        assert calls["bwd"] == CFG["n_block"] * STEPS
        assert calls["fwd"] >= calls["bwd"]


def test_bert_training_bf16_matches_jax(jax_reference, route):
    init, j_losses, j_final, _, j_pred = jax_reference["bfloat16"]
    net = _port_net(init, "bfloat16")
    x, y = _bert_data(0)
    est = test_.Estimator(net, topt.SGD(lr=0.01, momentum=0.9))
    est.train(tfs.ArrayFeatureSet(x, y), tobj.sparse_categorical_crossentropy,
              end_trigger=ttrig.MaxEpoch(EPOCHS), batch_size=BATCH)
    np.testing.assert_allclose(est.train_losses, j_losses, rtol=0,
                               atol=BF16_LOSS_TOL)
    for p in tree_leaves(est.tstate.params):  # f32 master weights
        assert p.dtype == torch.float32
    _assert_updates_close(net.params, init, j_final, BF16_UPDATE_TOL)
    np.testing.assert_allclose(est.predict(tfs.ArrayFeatureSet(x), BATCH),
                               j_pred, rtol=0, atol=BF16_PRED_TOL)


def test_bf16_embedding_gradient_matches_jax():
    """The gradient of a bf16-cast f32 table through the embedding lookup:
    both frameworks accumulate the rows in bf16, so on the same bf16
    output gradient they agree to float rounding of that sum (one bf16 ulp
    of the largest entry)."""
    rng = np.random.default_rng(4)
    table = rng.standard_normal((2, 64)).astype(np.float32)
    ids = rng.integers(0, 2, (8, 128)).astype(np.int32)
    g = np.asarray(jnp.asarray(rng.standard_normal((8, 128, 64)),
                               jnp.bfloat16).astype(jnp.float32))
    jg = jax.grad(lambda t: jnp.sum(
        jnp.take(t.astype(jnp.bfloat16), ids, axis=0).astype(jnp.float32)
        * g))(jnp.asarray(table))
    t = torch.tensor(table, requires_grad=True)
    out = torch.nn.functional.embedding(_t(ids).long(), t.to(torch.bfloat16))
    tg, = torch.autograd.grad(out, t, _t(g).to(torch.bfloat16))
    assert tg.dtype == torch.float32
    jg = np.asarray(jg)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=0,
                               atol=2.0 ** -8 * np.abs(jg).max())


def test_frozen_weights_and_clipping():
    """A frozen weight keeps its value; L2-norm clipping and constant
    clipping bound the update as optax's transformations do."""
    x, y = _bert_data(1)
    net = BERTClassifierNet(num_classes=2, **CFG)
    net.compute_dtype = None
    net.ensure_params()
    for spec in net.head.weight_specs:
        spec.trainable = False
    head0 = {k: v.clone() for k, v in net.params[net.head.name].items()}
    est = test_.Estimator(net, topt.SGD(lr=0.5)).set_l2_norm_gradient_clipping(
        1e-3)
    before = [p.clone() for p in tree_leaves(net.params)]
    est.train(tfs.ArrayFeatureSet(x, y), tobj.sparse_categorical_crossentropy,
              end_trigger=ttrig.MaxIteration(1), batch_size=BATCH)
    for k, v in head0.items():
        assert torch.equal(net.params[net.head.name][k], v)
    delta = torch.sqrt(sum(((a - b) ** 2).sum() for a, b in zip(
        tree_leaves(net.params), before)))
    # lr * clip norm, plus the rounding of p + u (parameters are < 1)
    assert delta.item() <= 0.5 * 1e-3 + 1e-6
    est.set_constant_gradient_clipping(-1e-4, 1e-4)
    before = [p.clone() for p in tree_leaves(net.params)]
    est.train(tfs.ArrayFeatureSet(x, y), tobj.sparse_categorical_crossentropy,
              end_trigger=ttrig.MaxIteration(2), batch_size=BATCH)
    for a, b in zip(tree_leaves(net.params), before):
        assert (a - b).abs().max().item() <= 0.5 * 1e-4 + 1e-7


# -- state faults: C1 (state built under inference mode), C2 (float64) ----


def _small_nets(kind):
    """(JAX net, port net, x): a Sequential, or a two-input Model."""
    jbase.reset_name_counts()
    reset_name_counts()
    rng = np.random.default_rng(9)
    if kind == "sequential":
        x = rng.normal(size=(20, 5)).astype(np.float32)
        return (jtopo.Sequential([jlayers.Dense(6, activation="tanh",
                                                input_shape=(5,)),
                                  jlayers.Dense(3)]),
                Sequential([Dense(6, activation="tanh", input_shape=(5,)),
                            Dense(3)]), x)
    x = [rng.normal(size=(20, 5)).astype(np.float32),
         rng.normal(size=(20, 4)).astype(np.float32)]
    nets = []
    for mod_topo, mod_layers in ((jtopo, jlayers), (topo, layers)):
        a, b = mod_topo.Input((5,)), mod_topo.Input((4,))
        h = mod_layers.Merge(mode="concat")([
            mod_layers.Dense(6, activation="tanh")(a),
            mod_layers.Dense(6)(b)])
        nets.append(mod_topo.Model([a, b], mod_layers.Dense(3)(h)))
    return nets[0], nets[1], x


LOGITS_LOSS = "sparse_categorical_crossentropy_from_logits"


@pytest.mark.parametrize("kind", ["sequential", "two_input_model"])
@pytest.mark.parametrize("first", ["predict", "evaluate"])
def test_predict_or_evaluate_before_fit_still_trains(kind, first):
    """C1: a predict or evaluate before the first fit built the train
    state as inference tensors, and fit then raised. The trajectory after
    either must equal the fit-only one bitwise, and the JAX package's
    within F32_TOL."""
    jnet, _, x = _small_nets(kind)
    y = np.random.default_rng(2).integers(0, 3, 20).astype(np.int32)
    jnet.compile(jopt.SGD(0.1, momentum=0.9), LOGITS_LOSS)
    j_est = jnet._get_estimator()
    j_est._ensure_state()
    init = jax.tree_util.tree_map(np.asarray, j_est.tstate.params)
    jnet.fit(x, y, batch_size=BATCH, nb_epoch=2)

    def run(before):
        _, net, _ = _small_nets(kind)
        load_jax_params(net, init)
        net.compile(topt.SGD(0.1, momentum=0.9), LOGITS_LOSS, ["accuracy"])
        if before == "predict":
            net.predict(x, batch_size=BATCH)
        elif before == "evaluate":
            net.evaluate(x, y, batch_size=BATCH)
        net.fit(x, y, batch_size=BATCH, nb_epoch=2)
        return net

    ref, got = run(None), run(first)
    assert got._estimator.train_losses == ref._estimator.train_losses
    for a, b in zip(tree_leaves(got.params), tree_leaves(ref.params),
                    strict=True):
        assert torch.equal(a, b)
    carried = tree_leaves(load_jax_params(_small_nets(kind)[1],
                                          j_est.tstate.params))
    for a, b in zip(tree_leaves(got.params), carried, strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=F32_TOL)


@pytest.mark.parametrize("surface", ["fit", "fit_cached", "predict",
                                     "serve"])
def test_float64_inputs_are_made_float32(surface):
    """C2: float64 host inputs reach the device as float32, as the JAX
    package makes them (x64 off): the same results, bitwise, as the inputs
    cast to float32 by the caller, and the JAX package's within
    F32_TOL."""
    x64 = np.random.default_rng(4).random((20, 5))
    y = np.random.default_rng(5).integers(0, 3, 20).astype(np.int32)
    jnet, _, _ = _small_nets("sequential")
    jnet.compile(jopt.SGD(0.1), LOGITS_LOSS)
    j_est = jnet._get_estimator()
    j_est._ensure_state()
    init = jax.tree_util.tree_map(np.asarray, j_est.tstate.params)

    def run(x):
        _, net, _ = _small_nets("sequential")
        load_jax_params(net, init)
        net.compile(topt.SGD(0.1), LOGITS_LOSS)
        if surface == "fit":
            net.fit(x, y, batch_size=BATCH, nb_epoch=2)
            return np.concatenate([p.numpy().ravel()
                                   for p in tree_leaves(net.params)])
        if surface == "fit_cached":
            net.fit(tfs.ArrayFeatureSet(x, y).cache_device(),
                    batch_size=BATCH, nb_epoch=2)
            return np.concatenate([p.numpy().ravel()
                                   for p in tree_leaves(net.params)])
        if surface == "predict":
            return net.predict(x, batch_size=BATCH)
        return InferenceModel().do_load_keras(net).do_predict(x)

    got, want = run(x64), run(x64.astype(np.float32))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if surface.startswith("fit"):
        jnet.fit(x64, y, batch_size=BATCH, nb_epoch=2)
        ref = np.concatenate([
            p.numpy().ravel() for p in tree_leaves(load_jax_params(
                _small_nets("sequential")[1], j_est.tstate.params))])
    else:
        ref = np.asarray(jnet.predict(x64, batch_size=BATCH))
    np.testing.assert_allclose(got, ref, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("call", [
    lambda e: test_.Estimator(e.model, zero1=True).train_distributed(
        None, None),
    lambda e: InferenceModel().set_aot_cache("/nonexistent"),
    lambda e: e.set_l2_norm_gradient_clipping(1.0).train_distributed(
        None, None),
    lambda e: test_.Estimator(e.model, gradient_accumulation=2)
    .train_pipelined(None, None, StagePlan(1, rules=((".", 0),)))])
def test_unported_surfaces_raise(call):
    """The AOT executable cache raises (the port keeps none), and so do
    the surfaces ``train_distributed`` and ``train_pipelined`` refuse as
    the JAX package does: ``zero1`` (superseded by the sharded update),
    L2-norm clipping (the global norm needs every gradient before the
    update is sliced) and gradient accumulation under a microbatch
    schedule. ZeRO-1 itself, ``train_distributed`` and
    ``train_pipelined`` are ported (``tests/test_torch_dist_training.py``,
    ``tests/test_torch_pipeline.py``); profiling and the step watchdog
    are driven by ``tests/test_torch_trace_tools.py``."""
    est = test_.Estimator(BERTClassifierNet(num_classes=2, **CFG))
    with pytest.raises(NotImplementedError):
        call(est)


def test_dropout_statistics_and_determinism():
    """Dropout > 0 is checked by its statistics and by determinism under a
    fixed generator, not by parity (jax.random draws cannot be
    reproduced)."""
    x = torch.ones(200_000)
    out = port_attention.dropout(x, 0.25, torch.Generator().manual_seed(3))
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.005
    assert torch.allclose(out[kept], torch.full_like(out[kept], 1 / 0.75))
    again = port_attention.dropout(x, 0.25, torch.Generator().manual_seed(3))
    assert torch.equal(out, again)

    def train_once(seed):
        port.stop_nncontext()
        port.init_nncontext(device="cpu", seed=seed)
        net = BERTClassifierNet(num_classes=2, **dict(
            CFG, hidden_drop=0.1, attn_drop=0.1))
        net.compute_dtype = None
        xs, ys = _bert_data(2)
        est = test_.Estimator(net, topt.SGD(lr=0.01))
        est.train(tfs.ArrayFeatureSet(xs, ys),
                  tobj.sparse_categorical_crossentropy,
                  end_trigger=ttrig.MaxIteration(2), batch_size=BATCH)
        return est.train_losses

    a, b, c = train_once(0), train_once(0), train_once(1)
    assert a == b and a != c
