"""The rest of the port's training surface against the JAX package:
every optimizer and learning-rate schedule, every objective and its
per-sample form, every metric (AUC, top-k, the ranking metrics) and
``Ranker``.

Optimizers take N = 3 steps from the same parameters and gradients in the
port and in optax (through the JAX package's factories); the port's
multi-tensor form (``torch._foreach_*``) is held bitwise to its per-leaf
form, which runs the same ops in the same order one leaf at a time.

Tolerances, all absolute: optimizer trajectories 1e-6 (the same float32
arithmetic; XLA and PyTorch may round a square root or an rsqrt one ulp
apart, measured at most 1.2e-7 on parameters near 1); objectives and
metrics 1e-6 (float32 reductions summed in another order); the host-side
ranking metrics and AUC's final trapezoid exactly (numpy on both sides,
over counts that agree exactly).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import analytics_zoo_tpu_torch as port
from analytics_zoo_tpu.keras import metrics as jmetrics
from analytics_zoo_tpu.keras import objectives as jobj
from analytics_zoo_tpu.keras import optimizers as jopt
from analytics_zoo_tpu.models import common as jcommon
from analytics_zoo_tpu_torch.common.tree import tree_leaves
from analytics_zoo_tpu_torch.keras import metrics as tmetrics
from analytics_zoo_tpu_torch.keras import objectives as tobj
from analytics_zoo_tpu_torch.keras import optimizers as topt
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts
from analytics_zoo_tpu_torch.keras.engine.topology import Sequential
from analytics_zoo_tpu_torch.keras.layers import Dense
from analytics_zoo_tpu_torch.models.common import Ranker

OPT_TOL = 1e-6
FN_TOL = 1e-6
STEPS = 3


@pytest.fixture(autouse=True)
def _port_context():
    port.init_nncontext(device="cpu")
    yield
    port.stop_nncontext()
    reset_name_counts()


def _t(a):
    return torch.tensor(np.asarray(a))


# -- optimizers and schedules ------------------------------------------------


def _params_and_grads(seed=0, steps=STEPS):
    rng = np.random.default_rng(seed)
    params = {"dense": {"kernel": rng.standard_normal((3, 4)),
                        "bias": rng.standard_normal(4)},
              "embed": {"embeddings": rng.standard_normal((5, 2))}}
    params = jax.tree_util.tree_map(lambda a: a.astype(np.float32), params)
    grads = [jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
        for _ in range(steps)]
    return params, grads


def _run_port(tx, params, grads):
    tp = jax.tree_util.tree_map(_t, params)
    state = tx.init(tp)
    for g in grads:
        upd, state = tx.update(jax.tree_util.tree_map(_t, g), state, tp)
        tp = jax.tree_util.tree_map(lambda p, u: p + u, tp, upd)
    return tp, state


def _run_optax(tx, params, grads):
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                               state, jp)
        jp = optax.apply_updates(jp, upd)
    return jp


OPTIMIZERS = [
    ("SGD", dict(lr=0.1)),
    ("SGD", dict(lr=0.1, momentum=0.9, nesterov=True)),
    ("Adam", dict(lr=0.01, decay=0.3)),
    ("AdamWeightDecay", dict(lr=0.01)),
    ("AdamWeightDecay", dict(lr=0.01, warmup_portion=0.34, total=3)),
    ("AdamWeightDecay", dict(lr=0.01, warmup_portion=0.0, total=5,
                             weight_decay=0.1)),
    ("RMSprop", dict(lr=0.01)),
    ("RMSprop", dict(lr=0.01, rho=0.8, momentum=0.5, decay=0.1)),
    ("RMSprop", dict(lr=0.01, centered=True)),
    ("Adagrad", dict(lr=0.1)),
    ("Adagrad", dict(lr=0.1, decay=0.2, epsilon=1e-6)),
    ("Adadelta", dict()),
    ("Adadelta", dict(lr=0.5, rho=0.9)),
    ("Adamax", dict()),
    ("Adamax", dict(lr=0.01, beta_1=0.8, beta_2=0.99)),
]


def _id(case):
    name, kw = case
    return name + "".join(f"-{k}{v}" for k, v in kw.items())


@pytest.mark.parametrize("case", OPTIMIZERS, ids=[_id(c) for c in OPTIMIZERS])
def test_optimizer_trajectory_matches_optax(case):
    name, kw = case
    params, grads = _params_and_grads()
    got, _ = _run_port(getattr(topt, name)(**kw), params, grads)
    want = _run_optax(getattr(jopt, name)(**kw), params, grads)
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want),
                    strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=OPT_TOL)


@pytest.mark.parametrize("case", OPTIMIZERS, ids=[_id(c) for c in OPTIMIZERS])
def test_multi_tensor_form_is_bitwise_the_per_leaf_form(case):
    name, kw = case
    params, grads = _params_and_grads(seed=1)
    fast, fast_state = _run_port(getattr(topt, name)(**kw), params, grads)
    plain, plain_state = _run_port(getattr(topt, name)(foreach=False, **kw),
                                   params, grads)
    for a, b in zip(tree_leaves(fast) + tree_leaves(fast_state),
                    tree_leaves(plain) + tree_leaves(plain_state),
                    strict=True):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b


def test_multi_tensor_form_launches_one_op_per_step_not_per_leaf(
        monkeypatch):
    """The multi-tensor form calls each op once over the whole leaf list:
    one ``_foreach_mul`` per scaling, whatever the number of leaves."""
    calls = []
    real = torch._foreach_mul
    monkeypatch.setattr(torch, "_foreach_mul",
                        lambda *a: calls.append(len(a[0])) or real(*a))
    params, grads = _params_and_grads()
    _run_port(topt.SGD(lr=0.1, momentum=0.9), params, grads[:1])
    n_leaves = len(jax.tree_util.tree_leaves(params))
    assert calls == [n_leaves, n_leaves]  # momentum * trace, then -lr


SCHEDULES = {
    "poly": lambda m: m.PolyDecay(0.1, 0.5, 10),
    "warmup": lambda m: m.Warmup(0.01),
    "sequential": lambda m: m.SequentialSchedule(
        [m.Warmup(0.02), m.PolyDecay(0.04, 2.0, 5)], [2]),
}


@pytest.mark.parametrize("sched", sorted(SCHEDULES))
def test_schedules_match_jax(sched):
    """The schedules at every step, and SGD driven by them."""
    jf, tf = SCHEDULES[sched](jopt), SCHEDULES[sched](topt)
    for step in range(7):
        np.testing.assert_allclose(
            float(tf(torch.tensor(step, dtype=torch.int32))),
            float(jf(jnp.asarray(step, jnp.int32))), rtol=0, atol=1e-8)
    params, grads = _params_and_grads(seed=2, steps=5)
    got, _ = _run_port(topt.SGD(schedule=tf, momentum=0.5), params, grads)
    want = _run_optax(jopt.SGD(schedule=jf, momentum=0.5), params, grads)
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=OPT_TOL)


def test_optimizer_get_resolves_every_name():
    for name in ("adam", "sgd", "rmsprop", "adagrad", "adadelta", "adamax"):
        assert isinstance(topt.get(name), topt.GradientTransformation)
    with pytest.raises(ValueError, match="Unknown optimizer"):
        topt.get("lamb")
    with pytest.raises(ValueError, match="needs the parameters"):
        tx = topt.AdamWeightDecay()
        p = {"w": torch.ones(2)}
        tx.update(p, tx.init(p))


def test_fit_with_each_new_optimizer_moves_the_weights():
    """Every new optimizer drives ``compile``/``fit`` end to end."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((16, 3)).astype(np.float32)
    y = rng.integers(0, 2, 16).astype(np.int32)
    for opt in (topt.RMSprop(), topt.Adagrad(), topt.Adadelta(),
                topt.Adamax(), topt.AdamWeightDecay(total=4)):
        net = Sequential([Dense(2, activation="softmax", input_shape=(3,))])
        net.compile(opt, "sparse_categorical_crossentropy")
        before = net.get_weights()
        net.fit(x, y, batch_size=8, nb_epoch=1)
        after = net.get_weights()
        moved = [not np.array_equal(a, b) for a, b in zip(
            jax.tree_util.tree_leaves(before),
            jax.tree_util.tree_leaves(after))]
        assert all(moved)


# -- objectives ---------------------------------------------------------------


def _loss_inputs(name, rng):
    """(y_true, y_pred) of the kind each loss takes."""
    logits = rng.standard_normal((6, 4)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    probs[0, 1] = 0.0  # exercises the _EPS clips
    labels = rng.integers(0, 4, 6).astype(np.int32)
    onehot = np.eye(4, dtype=np.float32)[labels]
    pos = rng.random((6, 4)).astype(np.float32) * 3.0
    if name in ("hinge", "squared_hinge"):
        return rng.choice([-1.0, 1.0], (6, 4)).astype(np.float32), logits
    if name in ("binary_crossentropy",):
        return (rng.random((6, 4)) > 0.5).astype(np.float32), \
            1.0 / (1.0 + np.exp(-logits))
    if name == "binary_crossentropy_from_logits":
        return (rng.random((6, 4)) > 0.5).astype(np.float32), logits
    if name in ("mape", "msle", "poisson"):
        return pos, pos[::-1].copy() + 0.1
    if name in ("kld",):
        return onehot * 0.8 + 0.05, probs
    if name.startswith("sparse"):
        return labels, logits if name.endswith("logits") else probs
    if name.startswith("categorical"):
        return onehot, logits if name.endswith("logits") else probs
    if name == "rank_hinge":
        return np.zeros((6, 1), np.float32), logits[:, :1]
    return logits, np.tanh(logits) * 2.0  # mse, mae, cosine


LOSSES = ["mse", "mae", "mape", "msle", "binary_crossentropy",
          "binary_crossentropy_from_logits", "categorical_crossentropy",
          "categorical_crossentropy_from_logits",
          "sparse_categorical_crossentropy",
          "sparse_categorical_crossentropy_from_logits", "hinge",
          "squared_hinge", "rank_hinge", "kld", "poisson",
          "cosine_proximity"]


@pytest.mark.parametrize("name", LOSSES)
def test_objectives_and_per_sample_forms_match_jax(name):
    yt, yp = _loss_inputs(name, np.random.default_rng(4))
    jf, tf = jobj.get(name), tobj.get(name)
    np.testing.assert_allclose(
        tf(_t(yt), _t(yp)).numpy(),
        np.asarray(jf(jnp.asarray(yt), jnp.asarray(yp))), rtol=0,
        atol=FN_TOL * max(1.0, abs(float(jf(jnp.asarray(yt),
                                            jnp.asarray(yp))))))
    jps, tps = jobj.get_per_sample(jf), tobj.get_per_sample(tf)
    assert (jps is None) == (tps is None)
    got = tps(_t(yt), _t(yp)).numpy()
    want = np.asarray(jps(jnp.asarray(yt), jnp.asarray(yp)))
    assert got.shape == want.shape == (6,)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FN_TOL * max(1.0, np.abs(want).max()))


def test_objective_aliases_and_table():
    assert sorted(tobj._LOSSES) == sorted(jobj._LOSSES)
    assert tobj.RankHinge is tobj.rank_hinge
    assert tobj.get("mae") is tobj.mean_absolute_error
    with pytest.raises(ValueError, match="Unknown loss"):
        tobj.get("no_such_loss")


# -- metrics ------------------------------------------------------------------


def _metric_inputs(rng, n=8, classes=6):
    logits = rng.standard_normal((n, classes)).astype(np.float32)
    logits[1, :] = 0.5  # a row of ties for top-k
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    labels = rng.integers(0, classes, n).astype(np.int32)
    return probs, labels


def _stats(jm, tm, yt, yp, mask):
    js, jc = jm.batch_stats(jnp.asarray(yt), jnp.asarray(yp),
                            None if mask is None else jnp.asarray(mask))
    ts, tc = tm.batch_stats(_t(yt), _t(yp),
                            None if mask is None else _t(mask))
    return (np.asarray(js), float(jc)), (ts.numpy(), tc.item())


METRIC_CASES = ["binary_accuracy", "categorical_accuracy", "top5accuracy",
                "top2", "mae", "mse", "auc", "auc_softmax2"]


@pytest.mark.parametrize("metric", METRIC_CASES)
@pytest.mark.parametrize("masked", [False, True])
def test_metrics_match_jax(metric, masked):
    rng = np.random.default_rng(5)
    probs, labels = _metric_inputs(rng)
    mask = (np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32) if masked
            else None)
    if metric == "top2":
        jm, tm = jmetrics.TopKAccuracy(2), tmetrics.TopKAccuracy(2)
    elif metric == "auc_softmax2":
        jm, tm = jmetrics.AUC(50), tmetrics.AUC(50)
    else:
        jm, tm = jmetrics.get(metric), tmetrics.get(metric)
    assert tm.name == jm.name
    if metric in ("binary_accuracy", "auc"):
        yt = (labels % 2).astype(np.float32)[:, None]
        yp = probs[:, :1] * 3.0 % 1.0
    elif metric == "auc_softmax2":
        yt = np.eye(2, dtype=np.float32)[labels % 2]
        yp = np.stack([1 - probs[:, 0], probs[:, 0]], axis=1)
    elif metric == "categorical_accuracy":
        yt, yp = np.eye(6, dtype=np.float32)[labels], probs
    elif metric in ("mae", "mse"):
        yt, yp = probs[::-1].copy(), probs
    else:
        yt, yp = labels, probs
    (js, jc), (ts, tc) = _stats(jm, tm, yt, yp, mask)
    np.testing.assert_allclose(ts, js, rtol=0, atol=FN_TOL)
    assert tc == jc
    assert tm.finalize(ts if ts.size > 1 else float(ts), tc) == \
        pytest.approx(jm.finalize(js if js.size > 1 else float(js), jc),
                      abs=FN_TOL)


def test_top_k_breaks_ties_as_jax():
    """A row of equal scores: the JAX package's stable argsort keeps the
    higher class indices in the top k; so does the port."""
    yp = np.full((3, 6), 0.25, np.float32)
    for k in (1, 2, 5):
        for label in range(6):
            yt = np.full((3,), label, np.int32)
            (js, _), (ts, _) = _stats(jmetrics.TopKAccuracy(k),
                                      tmetrics.TopKAccuracy(k), yt, yp,
                                      None)
            assert float(ts) == float(js), (k, label)


def test_metric_table_matches_jax():
    assert sorted(tmetrics._METRICS) == sorted(jmetrics._METRICS)
    for name in tmetrics._METRICS:
        assert tmetrics.get(name).name == jmetrics.get(name).name


def _grouped(rng, groups=12):
    out = []
    for g in range(groups):
        n = int(rng.integers(2, 9))
        labels = rng.integers(0, 3, n).astype(np.float64)
        if g == 0:
            labels[:] = 0  # no relevant item: AP and NDCG 0
        out.append((rng.standard_normal(n), labels))
    return out


@pytest.mark.parametrize("k", [1, 3, 10])
def test_ranking_metrics_and_ranker_match_jax(k):
    grouped = _grouped(np.random.default_rng(6))
    assert tmetrics.evaluate_ndcg(grouped, k) == \
        jmetrics.evaluate_ndcg(grouped, k)
    assert Ranker().evaluate_ndcg(grouped, k) == \
        jcommon.Ranker().evaluate_ndcg(grouped, k)
    for threshold in (0.0, 1.0):
        assert tmetrics.evaluate_map(grouped, threshold) == \
            jmetrics.evaluate_map(grouped, threshold)
        assert Ranker().evaluate_map(grouped, threshold) == \
            jcommon.Ranker().evaluate_map(grouped, threshold)
    assert Ranker().evaluate_map([]) == 0.0


def test_evaluate_sums_auc_bins_across_batches():
    """``evaluate`` with AUC (a vector of per-threshold counts) and top-5
    over several wrap-padded batches equals the metrics over the whole
    set at once."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((21, 4)).astype(np.float32)
    y = rng.integers(0, 2, 21).astype(np.int32)
    net = Sequential([Dense(2, activation="softmax", input_shape=(4,))])
    net.compile("sgd", "sparse_categorical_crossentropy",
                ["auc", "top5accuracy", "accuracy"])
    got = net.evaluate(x, y, batch_size=8)
    pred = net.predict(x, batch_size=8)
    onehot = np.eye(2, dtype=np.float32)[y]
    for name, jm, yt in (("auc", jmetrics.AUC(), onehot),
                         ("accuracy", jmetrics.Accuracy(), y)):
        s, c = jm.batch_stats(jnp.asarray(yt), jnp.asarray(pred))
        want = jm.finalize(np.asarray(s) if np.asarray(s).size > 1
                           else float(s), float(c))
        assert got[name] == pytest.approx(want, abs=1e-6), name
    assert got["top5accuracy"] == 1.0  # two classes: always in the top 5
