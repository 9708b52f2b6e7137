"""Checkpoint, resume, summaries and gradient accumulation of the PyTorch
port, against its own uninterrupted runs and against the JAX package.

Kill→``auto_resume`` is held bitwise to the uninterrupted run (the bar of
``tests/test_ft.py``) on a model with batch norm and dropout, so the
model state, the in-epoch offset and the dropout stream are all covered;
the kill is in-process: ``chaos.fail`` raises instead of exiting, which
leaves the disk exactly as ``os._exit`` would. Checkpoints, weights and
event files cross between the packages in the directions the port
supports. Tolerance against the JAX package: ``F32_TOL`` of
``tests/test_torch_training.py``'s trajectory test (1e-5 absolute: XLA on
the CPU mesh and eager PyTorch sum in other orders).
"""

import os
import re

import jax
import numpy as np
import optax
import pytest
import torch

import analytics_zoo_tpu_torch as port
from analytics_zoo_tpu.data import feature_set as jfs
from analytics_zoo_tpu.engine import estimator as jest
from analytics_zoo_tpu.engine import summary as jsummary
from analytics_zoo_tpu.engine import triggers as jtrig
from analytics_zoo_tpu.ft import atomic as jatomic
from analytics_zoo_tpu.keras import layers as jlayers
from analytics_zoo_tpu.keras import objectives as jobj
from analytics_zoo_tpu.keras import optimizers as jopt
from analytics_zoo_tpu.keras.engine import base as jbase
from analytics_zoo_tpu.keras.engine import topology as jtopo
from analytics_zoo_tpu_torch.common.tree import tree_leaves
from analytics_zoo_tpu_torch.data.feature_set import ArrayFeatureSet
from analytics_zoo_tpu_torch.engine import checkpoint as ck
from analytics_zoo_tpu_torch.engine import triggers as trig
from analytics_zoo_tpu_torch.engine.estimator import Estimator
from analytics_zoo_tpu_torch.ft import atomic, chaos
from analytics_zoo_tpu_torch.ft.manager import CheckpointManager
from analytics_zoo_tpu_torch.ft.preemption import (
    PreemptedError,
    PreemptionHandler,
)
from analytics_zoo_tpu_torch.interop import (
    load_jax_checkpoint,
    load_jax_params,
)
from analytics_zoo_tpu_torch.keras import objectives as tobj
from analytics_zoo_tpu_torch.keras import optimizers as topt
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts
from analytics_zoo_tpu_torch.keras.engine.topology import Sequential
from analytics_zoo_tpu_torch.keras.layers import (
    BatchNormalization,
    Dense,
    Dropout,
)

F32_TOL = 1e-5
_DIM, _CLASSES, _N, _BATCH = 8, 3, 24, 8


@pytest.fixture(autouse=True)
def _port_context():
    port.init_nncontext(device="cpu")
    yield
    port.stop_nncontext()
    reset_name_counts()
    chaos.reset()


class _Boom(Exception):
    """Stands in for os._exit in the in-process kill tests."""


@pytest.fixture
def chaos_raise(monkeypatch):
    """Arm a failure point: ``chaos.fail`` raises, leaving the disk as a
    kill would."""
    def arm(point, skip=0):
        chaos.reset()
        monkeypatch.setenv("AZOO_FT_CHAOS", point)
        monkeypatch.setenv("AZOO_FT_CHAOS_SKIP", str(skip))
        monkeypatch.setattr(chaos, "fail",
                            lambda p: (_ for _ in ()).throw(_Boom(p)))

    def disarm():
        chaos.reset()
        monkeypatch.delenv("AZOO_FT_CHAOS")
        monkeypatch.delenv("AZOO_FT_CHAOS_SKIP")

    arm.disarm = disarm
    return arm


def _data(n=_N, seed=11):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, _DIM)).astype(np.float32),
            rng.integers(0, _CLASSES, n).astype(np.int32))


def _bn_dropout_estimator(ckpt_dir, **ckpt_kw):
    """A fresh process's estimator: new context, counters reset, a model
    with batch norm and dropout, synchronous checkpoints."""
    port.stop_nncontext()
    port.init_nncontext(device="cpu")
    reset_name_counts()
    model = Sequential([Dense(8, activation="relu", input_shape=(_DIM,)),
                        BatchNormalization(), Dropout(0.4), Dense(_CLASSES)])
    est = Estimator(model, topt.Adam(0.02))
    est.set_checkpoint(str(ckpt_dir), **dict(dict(asynchronous=False,
                                                  keep_last=3), **ckpt_kw))
    return est


def _train(est, epochs=3, auto_resume=False, end_trigger=None):
    x, y = _data()
    est.train(ArrayFeatureSet(x, y),
              tobj.sparse_categorical_crossentropy_from_logits,
              end_trigger=end_trigger or trig.MaxEpoch(epochs),
              checkpoint_trigger=trig.SeveralIteration(4),
              batch_size=_BATCH, auto_resume=auto_resume)
    return est


def _assert_state_equal(a, b):
    la, lb = tree_leaves(a.tstate), tree_leaves(b.tstate)
    assert len(la) == len(lb)
    for p, q in zip(la, lb):
        if isinstance(p, torch.Tensor):
            assert torch.equal(p, q)
        else:
            assert p == q


@pytest.fixture(scope="module")
def ft_reference(tmp_path_factory):
    """One uninterrupted 3-epoch run shared by the kill matrix."""
    port.init_nncontext(device="cpu")
    try:
        return _train(_bn_dropout_estimator(tmp_path_factory.mktemp("ref")))
    finally:
        port.stop_nncontext()
        reset_name_counts()


# -- kill, preemption, corruption, accumulation mismatch ------------------


@pytest.mark.parametrize("point", chaos.FAILURE_POINTS)
def test_kill_then_auto_resume_is_bitwise(tmp_path, chaos_raise, point,
                                          ft_reference):
    """Die at ``point`` of the second checkpoint (iteration 8, the second
    step of epoch 3); a fresh estimator resumes from the iteration-4
    checkpoint (one step into epoch 2) and ends bitwise where the
    uninterrupted run ended: params, BN state, Adam moments and count,
    step."""
    chaos_raise(point, skip=1)
    with pytest.raises(_Boom):
        _train(_bn_dropout_estimator(tmp_path))
    chaos_raise.disarm()
    assert ck.latest_checkpoint(str(tmp_path)) == str(tmp_path / "ckpt_4")
    resumed = _train(_bn_dropout_estimator(tmp_path), auto_resume=True)
    assert resumed.run_state.iteration == ft_reference.run_state.iteration
    _assert_state_equal(resumed, ft_reference)
    assert resumed.model.params is resumed.tstate.params


def test_preemption_saves_then_raises_then_resumes_bitwise(tmp_path,
                                                           ft_reference):
    est = _bn_dropout_estimator(tmp_path)
    handler = PreemptionHandler()  # not installed: flagged below

    class FlagAt5(trig.Trigger):
        reads_loss = False

        def __call__(self, state):
            if state.iteration == 5:
                handler.request()
            return state.epoch >= 3

    est.set_preemption_handler(handler)
    with pytest.raises(PreemptedError) as exc:
        _train(est, end_trigger=FlagAt5())
    # flagged after step 5's check: acted on at the next step boundary, the
    # last step of epoch 2, before the epoch's end
    assert exc.value.checkpoint_path == str(tmp_path / "ckpt_6")
    assert atomic.is_committed(exc.value.checkpoint_path)
    meta = ck.peek_metadata(exc.value.checkpoint_path)
    assert (meta["epoch"], meta["epoch_step"]) == (1, 3)
    resumed = _train(_bn_dropout_estimator(tmp_path), auto_resume=True)
    _assert_state_equal(resumed, ft_reference)


def test_corrupt_newest_falls_back_to_the_previous(tmp_path, ft_reference):
    _train(_bn_dropout_estimator(tmp_path), epochs=2)  # ckpt_4
    _train(_bn_dropout_estimator(tmp_path / "more"))   # ckpt_4, ckpt_8
    newest = tmp_path / "more" / "ckpt_8" / atomic.ARRAYS
    data = bytearray(newest.read_bytes())
    data[len(data) // 2] ^= 0xFF
    newest.write_bytes(bytes(data))
    with pytest.raises(atomic.CheckpointCorruptError):
        atomic.verify_checksums(str(newest.parent))
    est = _bn_dropout_estimator(tmp_path / "more")
    assert est.resume_from_checkpoint() is True
    assert est.run_state.iteration == 4 and est.run_state.epoch_step == 1
    _train(est)  # and it trains on to the uninterrupted end
    _assert_state_equal(est, ft_reference)


def test_resume_needs_an_optimizer_and_a_matching_accumulation(tmp_path):
    _train(_bn_dropout_estimator(tmp_path), epochs=2)
    est = _bn_dropout_estimator(tmp_path)
    est.optim_method = None
    with pytest.raises(RuntimeError, match="optimizer"):
        est.resume_from_checkpoint()
    reset_name_counts()
    model = Sequential([Dense(8, activation="relu", input_shape=(_DIM,)),
                        BatchNormalization(), Dropout(0.4), Dense(_CLASSES)])
    est = Estimator(model, topt.Adam(0.02), model_dir=str(tmp_path),
                    gradient_accumulation=2)
    with pytest.raises(ValueError, match="gradient_accumulation=1"):
        est.resume_from_checkpoint()
    with pytest.raises(ValueError, match="gradient_accumulation"):
        Estimator(model, topt.Adam(0.02), gradient_accumulation=0)


# -- the writer -----------------------------------------------------------


def test_async_snapshot_is_a_copy_and_errors_surface_at_wait(tmp_path,
                                                             monkeypatch):
    t = torch.arange(6, dtype=torch.float32)
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    gate = __import__("threading").Event()
    real = atomic.commit_checkpoint

    def slow(*a, **kw):
        gate.wait(10)
        return real(*a, **kw)

    monkeypatch.setattr(atomic, "commit_checkpoint", slow)
    path = mgr.save(1, {"w": t, "n": 3})
    t.add_(100.0)  # a later step writing in place must not reach the disk
    gate.set()
    mgr.wait()
    restored, _ = mgr.restore(like={"w": t, "n": 0})
    np.testing.assert_array_equal(restored["w"], np.arange(6))
    assert int(restored["n"]) == 3 and path == mgr.latest()
    for step in (2, 3):
        mgr.save(step, {"w": t, "n": step})
    mgr.wait()
    assert [s for s, _ in mgr.all_checkpoints()] == [2, 3]  # keep_last=2

    def broken(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(atomic, "commit_checkpoint", broken)
    mgr.save(4, {"w": t, "n": 4})  # returns at once
    with pytest.raises(atomic.CheckpointError, match="disk full"):
        mgr.wait()
    mgr.close()


def test_legacy_two_file_checkpoint_loads(tmp_path):
    tree = {"a": np.arange(3, dtype=np.float32), "b": np.int32(7)}
    np.savez(tmp_path / "ckpt_3.npz", a0=tree["a"], a1=tree["b"])
    (tmp_path / "ckpt_3.json").write_text(
        '{"keys": ["a", "b"], "metadata": {"epoch": 1}}')
    assert ck.latest_checkpoint(str(tmp_path)) == str(tmp_path / "ckpt_3.npz")
    restored, meta = ck.load_checkpoint(str(tmp_path / "ckpt_3.npz"),
                                        {"a": torch.zeros(3), "b": 0})
    np.testing.assert_array_equal(restored["a"], tree["a"])
    assert int(restored["b"]) == 7 and meta == {"epoch": 1}
    with pytest.raises(ValueError, match="leaf 'a' has shape"):
        ck.load_checkpoint(str(tmp_path / "ckpt_3"),
                           {"a": torch.zeros(4), "b": 0})


# -- gradient accumulation ------------------------------------------------


def _dense_model(jax_init=None):
    reset_name_counts()
    net = Sequential([Dense(6, activation="tanh", input_shape=(_DIM,)),
                      Dense(_CLASSES)])
    if jax_init is not None:
        load_jax_params(net, jax_init)
    return net


def _jax_dense_model():
    jbase.reset_name_counts()
    return jtopo.Sequential([jlayers.Dense(6, activation="tanh",
                                           input_shape=(_DIM,)),
                             jlayers.Dense(_CLASSES)])


def test_accumulation_k2_equals_big_batch_and_the_jax_package():
    """28 samples, 3 epochs: K=2 over batch 8 (windows of 8+8 and 8+4
    valid rows, the tail wrap-padded) against K=1 over batch 16, and
    against the JAX package's K=2 run from the same weights."""
    x, y = _data(n=28, seed=5)
    loss = "sparse_categorical_crossentropy_from_logits"
    jnet = _jax_dense_model()
    jest_ = jest.Estimator(jnet, jopt.SGD(0.1, momentum=0.9),
                           gradient_accumulation=2)
    jest_._ensure_state()
    init = jax.tree_util.tree_map(np.asarray, jest_.tstate.params)
    jest_.train(jfs.ArrayFeatureSet(x, y), getattr(jobj, loss),
                end_trigger=jtrig.MaxEpoch(3), batch_size=8)

    def port_run(k, batch):
        net = _dense_model(init)
        net.compile(topt.SGD(0.1, momentum=0.9), loss,
                    gradient_accumulation=k)
        net.fit(x, y, batch_size=batch, nb_epoch=3)
        return net._estimator

    acc, big = port_run(2, 8), port_run(1, 16)
    assert acc.run_state.iteration == 12 and big.run_state.iteration == 6
    assert acc.tstate.step == 12
    for a, b, j in zip(tree_leaves(acc.tstate.params),
                       tree_leaves(big.tstate.params),
                       tree_leaves(load_jax_params(
                           _dense_model(), jest_.tstate.params))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(a.numpy(), j.numpy(), rtol=0,
                                   atol=F32_TOL)
    # the accumulator state round-trips through a checkpoint
    inner, accum, acc_n, mini = acc.tstate.opt_state
    assert mini == 0 and float(acc_n) == 0.0
    assert set(inner) == {"trace", "count"} and inner["count"] == 6


# -- weights ---------------------------------------------------------------


def test_save_load_weights_roundtrip_and_set_weights_merges(tmp_path):
    x, y = _data()
    net = Sequential([Dense(8, activation="relu", input_shape=(_DIM,)),
                      BatchNormalization(), Dense(_CLASSES)])
    net.compile(topt.Adam(0.02),
                "sparse_categorical_crossentropy_from_logits")
    net.fit(x, y, batch_size=_BATCH, nb_epoch=1)
    before = net.predict(x)
    net.save_weights(str(tmp_path / "w"))
    assert atomic.is_committed(str(tmp_path / "w"))
    other = Sequential([Dense(8, activation="relu", input_shape=(_DIM,)),
                        BatchNormalization(), Dense(_CLASSES)])
    other.load_weights(str(tmp_path / "w"))
    np.testing.assert_array_equal(other.predict(x), before)
    for a, b in zip(tree_leaves(other.params), tree_leaves(net.params)):
        assert torch.equal(a, b)

    weights = other.get_weights()
    first = other.layers()[0].name
    kernel = np.ones_like(weights[first]["kernel"], dtype=np.float64)
    other.set_weights({first: {"kernel": kernel}})  # the bias stays
    assert other.params[first]["kernel"].dtype == torch.float32
    np.testing.assert_array_equal(other.params[first]["kernel"].numpy(), 1.0)
    np.testing.assert_array_equal(other.params[first]["bias"].numpy(),
                                  weights[first]["bias"])
    weights[first]["bias"][:] = 5.0  # get_weights gave copies
    assert not (other.params[first]["bias"] == 5.0).any()
    bn = other.layers()[1].name
    other.set_states({bn: {"moving_mean": np.full(8, 2.0, np.float32)}})
    assert (other.model_state[bn]["moving_mean"] == 2.0).all()
    with pytest.raises(KeyError, match="no such layer"):
        other.set_weights({"nope": {}})
    with pytest.raises(KeyError, match="has no state"):
        other.set_states({bn: {"nope": np.zeros(8)}})
    assert "Total params: " in other.summary()


# -- across the packages ---------------------------------------------------


def _normalised(keys):
    """Keys with per-process counter numbers dropped."""
    return sorted(re.sub(r"_\d+(?=/|$)", "_N", k) for k in keys)


def test_port_checkpoint_reads_through_the_jax_package(tmp_path):
    x, y = _data()
    net = Sequential([Dense(4, input_shape=(_DIM,)), BatchNormalization(),
                      Dense(_CLASSES)])
    est = Estimator(net, topt.Adam(0.01))
    est.set_checkpoint(str(tmp_path / "port"))  # every epoch, async
    est.train(ArrayFeatureSet(x, y),
              tobj.sparse_categorical_crossentropy_from_logits,
              end_trigger=trig.MaxEpoch(1), batch_size=_BATCH)
    path = str(tmp_path / "port" / "ckpt_3")
    flat, meta = jatomic.read_checkpoint(path)  # CRCs verified
    assert jatomic.verify_checksums(path) == len(flat)
    assert meta["iteration"] == 3 and meta["gradient_accumulation"] == 1
    for k, a in flat:
        if k.startswith(".params/"):
            layer, weight = k.split("/")[1:]
            np.testing.assert_array_equal(
                a, est.tstate.params[layer][weight].numpy())

    jnet = jtopo.Sequential([jlayers.Dense(4, input_shape=(_DIM,)),
                             jlayers.BatchNormalization(),
                             jlayers.Dense(_CLASSES)])
    jest_ = jest.Estimator(jnet, jopt.Adam(0.01))
    jest_._ensure_state()
    jest_.set_checkpoint(str(tmp_path / "jax"), asynchronous=False)
    jest_._write_checkpoint()
    jflat, _ = jatomic.read_checkpoint(str(tmp_path / "jax" / "ckpt_0"))

    def shared(f):
        return _normalised(k for k, _ in f if not k.startswith(".opt_"))

    assert shared(flat) == shared(jflat)
    assert dict(flat)[".step"].dtype == dict(jflat)[".step"].dtype
    assert {k for k, _ in flat if k.startswith(".opt_")} >= {
        ".opt_state/count"}


def test_port_event_files_read_through_the_jax_summary(tmp_path):
    est = _bn_dropout_estimator(tmp_path / "ck")
    est.set_tensorboard(str(tmp_path), "app")
    x, y = _data()
    _train(est, epochs=2)
    est.evaluate(ArrayFeatureSet(x, y), ["accuracy"], _BATCH)
    losses = jsummary.TrainSummary(str(tmp_path), "app").read_scalar("Loss")
    assert [s for s, _ in losses] == list(range(1, 7))
    np.testing.assert_array_equal([v for _, v in losses],
                                  np.float32(est.train_losses))
    assert [s for s, _ in est.train_summary.read_scalar("Throughput")] == [
        3, 6]
    net = Sequential([Dense(_CLASSES, input_shape=(_DIM,))])
    net.compile(topt.SGD(0.1), "sparse_categorical_crossentropy_from_logits",
                ["accuracy"])
    net.set_tensorboard(str(tmp_path), "fit")
    net.fit(x, y, batch_size=_BATCH, nb_epoch=2, validation_data=(x, y))
    val = jsummary.ValidationSummary(str(tmp_path), "fit")
    assert [s for s, _ in val.read_scalar("accuracy")] == [3, 6]
    assert net.get_validation_summary("accuracy") == val.read_scalar(
        "accuracy")
    assert len(net.get_train_summary("Loss")) == 6


@pytest.mark.parametrize("opt", ["sgd_momentum_decay", "adam"])
def test_jax_checkpoint_loads_and_trains_on_with_the_jax_package(tmp_path,
                                                                 opt):
    """A JAX Estimator's checkpoint (Dense-BN-Dense, dropout off) after 1
    epoch: loaded into the port it gives the JAX model's outputs, and 2
    more epochs from it track the JAX package's own continued run."""
    x, y = _data()
    make = {"sgd_momentum_decay": (lambda m: m.SGD(0.05, momentum=0.9,
                                                   decay=0.1)),
            "adam": (lambda m: m.Adam(0.02))}[opt]
    jbase.reset_name_counts()
    jnet = jtopo.Sequential([jlayers.Dense(8, activation="relu",
                                           input_shape=(_DIM,)),
                             jlayers.BatchNormalization(),
                             jlayers.Dense(_CLASSES)])
    j = jest.Estimator(jnet, make(jopt))
    j.set_checkpoint(str(tmp_path), asynchronous=False)
    loss = "sparse_categorical_crossentropy_from_logits"
    j.train(jfs.ArrayFeatureSet(x, y), getattr(jobj, loss),
            end_trigger=jtrig.MaxEpoch(1), batch_size=_BATCH)
    j_pred = np.asarray(j.predict(jfs.ArrayFeatureSet(x), _BATCH))
    j.train(jfs.ArrayFeatureSet(x, y), getattr(jobj, loss),
            end_trigger=jtrig.MaxEpoch(3), batch_size=_BATCH)

    net = Sequential([Dense(8, activation="relu", input_shape=(_DIM,)),
                      BatchNormalization(), Dense(_CLASSES)])
    net.compile(make(topt), loss)
    net.predict(x)  # state built under inference mode first (C1)
    est = load_jax_checkpoint(net, str(tmp_path / "ckpt_3"))
    assert (est.run_state.epoch, est.run_state.iteration,
            est.tstate.step, est.tstate.opt_state["count"]) == (1, 3, 3, 3)
    np.testing.assert_allclose(net.predict(x), j_pred, rtol=0, atol=F32_TOL)
    net.fit(x, y, batch_size=_BATCH, nb_epoch=2)
    assert est.run_state.epoch == 3 and est.tstate.opt_state["count"] == 9
    for a, b in zip(tree_leaves(net.params),
                    tree_leaves(load_jax_params(
                        Sequential([Dense(8, input_shape=(_DIM,)),
                                    BatchNormalization(), Dense(_CLASSES)]),
                        j.tstate.params))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=F32_TOL)
    for a, b in zip(tree_leaves(net.model_state),
                    jax.tree_util.tree_leaves(j.tstate.model_state)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=F32_TOL)


def test_jax_checkpoint_with_unmappable_optimizer_state_is_refused(
        tmp_path):
    x, y = _data()
    jnet = _jax_dense_model()
    j = jest.Estimator(jnet, optax.chain(optax.clip_by_global_norm(1.0),
                                         optax.adam(0.01)))
    j.set_checkpoint(str(tmp_path), asynchronous=False)
    j.train(jfs.ArrayFeatureSet(x, y),
            jobj.sparse_categorical_crossentropy_from_logits,
            end_trigger=jtrig.MaxEpoch(1), batch_size=_BATCH)
    net = _dense_model()
    net.compile(topt.Adam(0.01), "sparse_categorical_crossentropy_from_logits")
    with pytest.raises(ValueError, match=r"leaf '\.opt_state/1/0/\.count'"):
        load_jax_checkpoint(net, str(tmp_path / "ckpt_3"))
    net.compile(topt.SGD(0.01, momentum=0.9),
                "sparse_categorical_crossentropy_from_logits")
    j2 = jest.Estimator(_jax_dense_model(), jopt.Adam(0.01))
    j2._ensure_state()
    j2.set_checkpoint(str(tmp_path / "adam"), asynchronous=False)
    j2._write_checkpoint()
    with pytest.raises(ValueError, match="'trace'"):
        load_jax_checkpoint(net, str(tmp_path / "adam" / "ckpt_0"))


@pytest.mark.parametrize("loader", ["load_checkpoint", "load_weights",
                                    "load_jax_checkpoint"])
def test_loaders_after_predict_leave_a_trainable_state(tmp_path, loader):
    """Each loader, called after a predict built the state under
    inference mode, installs state that trains (C1's cause)."""
    x, y = _data()
    jnet = _jax_dense_model()
    j = jest.Estimator(jnet, jopt.SGD(0.1))
    j.set_checkpoint(str(tmp_path / "jax"), asynchronous=False)
    j.train(jfs.ArrayFeatureSet(x, y),
            jobj.sparse_categorical_crossentropy_from_logits,
            end_trigger=jtrig.MaxEpoch(1), batch_size=_BATCH)
    src = _dense_model()
    src.compile(topt.SGD(0.1), "sparse_categorical_crossentropy_from_logits")
    src.set_checkpoint(str(tmp_path / "port"))
    src.fit(x, y, batch_size=_BATCH, nb_epoch=1)
    src.save_weights(str(tmp_path / "w"))

    net = _dense_model()
    net.compile(topt.SGD(0.1), "sparse_categorical_crossentropy_from_logits")
    with torch.inference_mode():
        net.predict(x)
    if loader == "load_checkpoint":
        net._get_estimator().load_checkpoint(str(tmp_path / "port" / "ckpt_3"))
    elif loader == "load_weights":
        net.load_weights(str(tmp_path / "w"))
    else:
        load_jax_checkpoint(net, str(tmp_path / "jax" / "ckpt_3"))
    for t in tree_leaves(net._estimator.tstate):
        assert not (isinstance(t, torch.Tensor) and t.is_inference())
    before = [p.clone() for p in tree_leaves(net.params)]
    net.fit(x, y, batch_size=_BATCH, nb_epoch=1)
    assert any(not torch.equal(a, b)
               for a, b in zip(before, tree_leaves(net.params)))
