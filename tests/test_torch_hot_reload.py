"""Serving hot reload in the port (``ft.hot_reload.CheckpointWatcher``,
``ServingEngine.watch_checkpoints``): the JAX package's cases
(``tests/test_ft.py``, ``test_serving_rollout.py``,
``test_serving_resilience.py``, ``test_result_cache.py``) re-pointed at
the port, on host models and fake clocks, plus the port's own: a torn
checkpoint (the writer killed before its COMMIT marker) is never
registered, ``shutdown`` stops the watchers, ``aot_cache_dir`` raises,
and a trained model reloaded from each committed checkpoint of an
``Estimator`` run serves that checkpoint's eager forward bitwise.
"""

import shutil
import time

import numpy as np
import pytest

import analytics_zoo_tpu_torch as port
from analytics_zoo_tpu_torch.common.observability import hot_reload_metrics
from analytics_zoo_tpu_torch.ft import atomic, chaos
from analytics_zoo_tpu_torch.ft.hot_reload import CheckpointWatcher
from analytics_zoo_tpu_torch.ft.manager import CheckpointManager
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts
from analytics_zoo_tpu_torch.serving import (
    BatcherConfig,
    ResultCacheConfig,
    RolloutConfig,
    ServingEngine,
)

CFG = BatcherConfig(max_batch_size=8, max_wait_ms=1.0)
X = np.ones((1, 3), np.float32)


@pytest.fixture(autouse=True)
def _port_context():
    port.init_nncontext(device="cpu")
    chaos.reset()
    yield
    chaos.reset()
    port.stop_nncontext()
    reset_name_counts()


class _ScaleModel:
    """A servable stub whose output shows which checkpoint it came from."""

    def __init__(self, scale):
        self.scale = np.asarray(scale, np.float32)

    def do_predict(self, x):
        return np.asarray(x, np.float32) * self.scale


def _build_scale(path):
    flat, _meta = atomic.read_checkpoint(path)
    return _ScaleModel(dict(flat)["scale"])


def _save(mgr, step, scale):
    mgr.save(step, {"scale": np.asarray(scale, np.float32)})


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# -- tests/test_ft.py ------------------------------------------------------


def test_serving_hot_reload_new_committed_version(tmp_path):
    """A new committed checkpoint becomes the served version without
    downtime; uncommitted saves are never loaded; old versions retire."""
    mgr = CheckpointManager(str(tmp_path), asynchronous=False)
    _save(mgr, 1, 2.0)
    engine = ServingEngine()
    try:
        watcher = engine.watch_checkpoints(
            "scaler", str(tmp_path), _build_scale,
            example_input=np.zeros((2, 3), np.float32),
            poll_interval_s=30.0,  # driven by poll_once below
            keep_versions=1)
        np.testing.assert_allclose(engine.predict("scaler", X), 2.0 * X)
        # an uncommitted directory is invisible to the watcher
        (tmp_path / "ckpt_9").mkdir()
        assert watcher.poll_once() is None
        _save(mgr, 2, 5.0)
        assert watcher.poll_once() == 2
        np.testing.assert_allclose(engine.predict("scaler", X), 5.0 * X)
        assert list(engine.stats()["scaler"]["versions"]) == ["2"]
    finally:
        engine.shutdown()


def test_watcher_rewind_allows_reminted_step(tmp_path):
    """After a rollback deletes a candidate's checkpoints, the next
    retrain can commit the same step number again: ``rewind`` lowers the
    high-water mark so ``poll_once`` registers it."""
    mgr = CheckpointManager(str(tmp_path), asynchronous=False)
    _save(mgr, 1, 2.0)
    _save(mgr, 2, 5.0)
    engine = ServingEngine()
    try:
        watcher = engine.watch_checkpoints(
            "scaler", str(tmp_path), _build_scale,
            example_input=np.zeros((2, 3), np.float32),
            poll_interval_s=30.0)
        assert watcher.last_step == 2
        engine.unregister("scaler", "2")
        shutil.rmtree(str(tmp_path / "ckpt_2"))
        _save(mgr, 2, 7.0)
        assert watcher.poll_once() is None  # refused: not newer
        watcher.rewind(1)
        assert watcher.poll_once() == 2
        np.testing.assert_allclose(engine.predict("scaler", X), 7.0 * X)
    finally:
        engine.shutdown()


# -- tests/test_serving_rollout.py ------------------------------------------


def test_hot_reload_enters_canary_and_trim_spares_protected(tmp_path):
    mgr = CheckpointManager(str(tmp_path), asynchronous=False)
    _save(mgr, 1, 2.0)
    engine = ServingEngine(rollout=RolloutConfig(
        ladder=(0.5, 1.0), min_requests=2, auto_evaluate=False))
    try:
        watcher = CheckpointWatcher(
            engine, "m", str(tmp_path), _build_scale, example_input=X,
            config=CFG, keep_versions=1)
        assert watcher.poll_once() == 1
        assert engine.describe_model("m")["latest"] == "1"
        _save(mgr, 2, 3.0)
        assert watcher.poll_once() == 2
        ctrl = engine.rollout_controller()
        state = ctrl.active("m")
        # the reloaded version canaries instead of repointing latest, and
        # keep_versions=1 trimming spared the protected pair
        assert state is not None and state.canary == "2"
        assert engine.describe_model("m")["latest"] == "1"
        assert sorted(engine.describe_model("m")["versions"]) == ["1", "2"]
        deadline = time.monotonic() + 30
        while ctrl.active("m") is not None and time.monotonic() < deadline:
            for _ in range(8):
                engine.predict("m", X)
            time.sleep(0.01)
            ctrl.tick()
        assert state.outcome == "promoted"
        assert engine.describe_model("m")["latest"] == "2"
        np.testing.assert_array_equal(engine.predict("m", X), X * 3.0)
    finally:
        engine.shutdown()


# -- tests/test_serving_resilience.py -----------------------------------------


def test_hot_reload_retries_transient_errors(tmp_path):
    """An OSError in ``build_model`` is transient: retried with backoff
    (an injected clock drives its expiry) up to ``max_retries``, then the
    step loads; nothing is skipped."""
    mgr = CheckpointManager(str(tmp_path), asynchronous=False)
    _save(mgr, 1, 3.0)
    calls = {"n": 0}

    def build_model(path):
        calls["n"] += 1
        if calls["n"] <= 2:
            raise OSError("transient storage blip")
        return _build_scale(path)

    hm = hot_reload_metrics()
    retries0, skips0 = hm["retries"].value, hm["skips"].value
    engine = ServingEngine()
    clk = _FakeClock()
    try:
        watcher = CheckpointWatcher(
            engine, "m", str(tmp_path), build_model,
            example_input=np.zeros((1, 3), np.float32),
            max_retries=3, retry_backoff_s=10.0, clock=clk)
        assert watcher.poll_once() is None          # attempt 1: transient
        assert watcher.poll_once() is None          # still backing off
        assert calls["n"] == 1
        clk.advance(10.0)
        assert watcher.poll_once() is None          # attempt 2: transient
        clk.advance(19.0)
        assert watcher.poll_once() is None          # 2nd backoff (20 s)
        assert calls["n"] == 2
        clk.advance(1.0)
        assert watcher.poll_once() == 1             # attempt 3 loads
        assert watcher.reloads == 1
        assert hm["retries"].value - retries0 == 2
        assert hm["skips"].value - skips0 == 0
        np.testing.assert_allclose(engine.predict("m", X), X * 3.0)
    finally:
        engine.shutdown()


def test_hot_reload_skips_structural_failures_immediately(tmp_path):
    """A deterministic failure (not an OSError) skips the step at once
    and for good: retrying would hot-loop the poller."""
    mgr = CheckpointManager(str(tmp_path), asynchronous=False)
    _save(mgr, 1, 2.0)
    calls = {"n": 0}

    def build_model(path):
        calls["n"] += 1
        raise ValueError("structurally bad checkpoint")

    hm = hot_reload_metrics()
    skips0 = hm["skips"].value
    engine = ServingEngine()
    try:
        watcher = CheckpointWatcher(
            engine, "m", str(tmp_path), build_model,
            example_input=np.zeros((1, 3), np.float32),
            max_retries=3, retry_backoff_s=0.01)
        assert watcher.poll_once() is None
        assert watcher.last_step == 1
        assert hm["skips"].value - skips0 == 1
        assert watcher.poll_once() is None
        assert calls["n"] == 1
    finally:
        engine.shutdown()


def test_hot_reload_transient_retries_exhaust_to_skip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), asynchronous=False)
    _save(mgr, 1, 2.0)

    def build_model(path):
        raise OSError("permanently flaky storage")

    hm = hot_reload_metrics()
    retries0, skips0 = hm["retries"].value, hm["skips"].value
    engine = ServingEngine()
    clk = _FakeClock()
    try:
        watcher = CheckpointWatcher(
            engine, "m", str(tmp_path), build_model,
            example_input=np.zeros((1, 3), np.float32),
            max_retries=2, retry_backoff_s=0.01, clock=clk)
        assert watcher.poll_once() is None          # retry 1 scheduled
        clk.advance(0.02)
        assert watcher.poll_once() is None          # retry 2 scheduled
        clk.advance(0.04)
        assert watcher.poll_once() is None          # exhausted: skip
        assert watcher.last_step == 1
        assert hm["retries"].value - retries0 == 2
        assert hm["skips"].value - skips0 == 1
    finally:
        engine.shutdown()


# -- tests/test_result_cache.py ---------------------------------------------


def test_hot_reload_trim_drops_retired_versions_entries(tmp_path):
    """keep_versions trimming retires old checkpoints, and their cached
    results die with them: a re-registered version never serves the old
    version's bytes."""
    mgr = CheckpointManager(str(tmp_path), asynchronous=False)
    _save(mgr, 1, 2.0)
    engine = ServingEngine(result_cache=ResultCacheConfig())
    try:
        watcher = CheckpointWatcher(
            engine, "m", str(tmp_path), _build_scale, example_input=X,
            config=CFG, keep_versions=1)
        assert watcher.poll_once() == 1
        np.testing.assert_array_equal(np.asarray(engine.predict("m", X)),
                                      X * 2.0)
        assert engine.result_cache.stats()["entries"] == 1
        _save(mgr, 2, 3.0)
        assert watcher.poll_once() == 2      # registers "2", trims "1"
        assert engine.result_cache.stats()["invalidations"] >= 1
        out = np.asarray(engine.predict("m", X))
        np.testing.assert_array_equal(out, X * 3.0)
        np.testing.assert_array_equal(
            out, np.asarray(engine.predict("m", X, bypass_cache=True)))
    finally:
        engine.shutdown()


# -- the port's own -----------------------------------------------------------


class _Killed(Exception):
    pass


def test_torn_checkpoint_is_never_registered(tmp_path, monkeypatch):
    """A writer killed before its COMMIT marker (``AZOO_FT_CHAOS=
    before_commit``; here ``chaos.fail`` raises instead of exiting)
    leaves ``ckpt_2/`` without the marker: the watcher never registers
    it, and registers the next committed step."""
    mgr = CheckpointManager(str(tmp_path), asynchronous=False)
    _save(mgr, 1, 2.0)
    engine = ServingEngine()
    try:
        watcher = engine.watch_checkpoints(
            "m", str(tmp_path), _build_scale, example_input=X, config=CFG,
            poll_interval_s=30.0)
        monkeypatch.setenv("AZOO_FT_CHAOS", "before_commit")

        def killed(point):
            raise _Killed(point)

        monkeypatch.setattr(chaos, "fail", killed)
        with pytest.raises(_Killed):
            _save(mgr, 2, 9.0)
        monkeypatch.delenv("AZOO_FT_CHAOS")
        assert (tmp_path / "ckpt_2").is_dir()
        assert not atomic.is_committed(str(tmp_path / "ckpt_2"))
        assert watcher.poll_once() is None
        assert sorted(engine.stats()["m"]["versions"]) == ["1"]
        np.testing.assert_allclose(engine.predict("m", X), 2.0 * X)
        _save(mgr, 3, 4.0)
        assert watcher.poll_once() == 3
        np.testing.assert_allclose(engine.predict("m", X), 4.0 * X)
    finally:
        engine.shutdown()


def test_shutdown_stops_watchers_and_aot_cache_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path), asynchronous=False)
    _save(mgr, 1, 2.0)
    engine = ServingEngine()
    watcher = engine.watch_checkpoints(
        "m", str(tmp_path), _build_scale, example_input=X, config=CFG,
        poll_interval_s=0.05)
    thread = watcher._thread
    assert thread is not None and thread.is_alive()
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        engine.watch_checkpoints("n", str(tmp_path), _build_scale,
                                 example_input=X, aot_cache_dir="/x")
    engine.shutdown()
    thread.join(timeout=10.0)
    assert not thread.is_alive()


def test_trained_checkpoints_reload_into_inference_models(tmp_path):
    """Each committed checkpoint of an ``Estimator`` run, loaded into an
    ``InferenceModel`` by the watcher's ``build_model``, serves exactly
    that checkpoint's weights: the served answer equals the eager
    forward of the version that answered, bitwise; old versions retire."""
    from analytics_zoo_tpu_torch.data.feature_set import ArrayFeatureSet
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.engine.triggers import MaxEpoch
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.interop import fill_from_flat
    from analytics_zoo_tpu_torch.keras import objectives
    from analytics_zoo_tpu_torch.keras.engine.topology import Sequential
    from analytics_zoo_tpu_torch.keras.layers import Dense
    from analytics_zoo_tpu_torch.keras.optimizers import SGD

    def build_net():
        m = Sequential(name="reload")
        m.add(Dense(8, activation="relu", input_shape=(4,)))
        m.add(Dense(3))
        return m

    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    y = rng.integers(0, 3, 64).astype(np.int32)
    net = build_net()
    est = Estimator(net, SGD(0.1))
    est.set_checkpoint(str(tmp_path), asynchronous=False)
    fs = ArrayFeatureSet(x, y)
    loss = objectives.sparse_categorical_crossentropy_from_logits

    def build_model(path):
        reset_name_counts()
        m = build_net()
        flat, _meta = atomic.read_checkpoint(path)
        m.params, m.model_state = fill_from_flat(m, flat, ".params",
                                                 ".model_state")
        return InferenceModel().do_load_keras(m)

    engine = ServingEngine()
    try:
        est.train(fs, loss, end_trigger=MaxEpoch(1), batch_size=16)
        watcher = engine.watch_checkpoints(
            "m", str(tmp_path), build_model, example_input=x[:4],
            config=CFG, poll_interval_s=30.0, keep_versions=1)
        first = watcher.last_step
        est.train(fs, loss, end_trigger=MaxEpoch(2), batch_size=16)
        assert watcher.poll_once() == first + 4
        assert list(engine.stats()["m"]["versions"]) == [str(first + 4)]
        got = engine.predict("m", x[:3])
        im = engine.entry("m").model
        np.testing.assert_array_equal(got, im.do_fetch(im._eager(x[:3])))
        np.testing.assert_array_equal(
            got, net.predict(x[:3], batch_size=3).reshape(got.shape))
    finally:
        engine.shutdown()


def test_reloads_under_concurrent_predicts_stay_exact(tmp_path):
    """Threads (more than cores) predict through the engine while the
    watcher registers three new versions with a short switch interval:
    no request fails, and every answer is exactly one registered
    version's forward of its rows (a torn or mixed version would give
    neither)."""
    import sys
    import threading

    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.interop import fill_from_flat
    from analytics_zoo_tpu_torch.keras.engine.topology import Sequential
    from analytics_zoo_tpu_torch.keras.layers import Dense

    def build_net():
        m = Sequential(name="stress")
        m.add(Dense(4, input_shape=(3,)))
        return m

    nets = {}
    mgr = CheckpointManager(str(tmp_path), asynchronous=False)
    for step in (1, 2, 3, 4):
        reset_name_counts()
        n = build_net()
        n.ensure_params()
        n.params = {k: {w: t * step for w, t in p.items()}
                    for k, p in n.params.items()}
        nets[str(step)] = n
    mgr.save(1, {".params": nets["1"].params})

    def build_model(path):
        reset_name_counts()
        m = build_net()
        flat, _meta = atomic.read_checkpoint(path)
        m.params, m.model_state = fill_from_flat(m, flat, ".params",
                                                 ".model_state")
        return InferenceModel().do_load_keras(m)

    engine = ServingEngine()
    stop = threading.Event()
    answers, errors = [], []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        watcher = engine.watch_checkpoints(
            "m", str(tmp_path), build_model, example_input=X, config=CFG,
            poll_interval_s=0.01, keep_versions=2)

        def client(seed):
            rng = np.random.default_rng(seed)
            while not stop.is_set():
                x = rng.normal(size=(int(rng.integers(1, 5)), 3)).astype(
                    np.float32)
                try:
                    answers.append((x, engine.predict("m", x)))
                except Exception as e:  # noqa: BLE001 - asserted below
                    errors.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for step in (2, 3, 4):
            mgr.save(step, {".params": nets[str(step)].params})
            deadline = time.monotonic() + 30
            while watcher.last_step != step and time.monotonic() < deadline:
                time.sleep(0.01)
            assert watcher.last_step == step
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        stop.set()
        sys.setswitchinterval(old)
        engine.shutdown()
    assert not errors and len(answers) > 50
    for x, y in answers:
        assert any(np.array_equal(y, n.predict(x, batch_size=len(x)))
                   for n in nets.values()), "an answer of no single version"


def test_sweep_stale_counts_removals_by_kind_as_jax_does(tmp_path):
    """The port's ``sweep_stale`` removes the same debris as the JAX
    package's and counts each removal in ``zoo_checkpoint_sweeps_total``
    under the same kind: a staging directory, an uncommitted husk and,
    with ``keep_steps``, a committed checkpoint outside it."""
    from analytics_zoo_tpu.common import observability as jobs
    from analytics_zoo_tpu.ft import atomic as jatomic
    from analytics_zoo_tpu_torch.common import observability as tobs

    deltas = {}
    for name, mod, obs in (("jax", jatomic, jobs), ("port", atomic, tobs)):
        d = tmp_path / name
        (d / "ckpt_1.tmp").mkdir(parents=True)
        (d / "ckpt_2").mkdir()
        for step in (3, 4):
            mod.commit_checkpoint(str(d / f"ckpt_{step}"),
                                  [("w", np.full((2,), step, np.float32))])
        counters = obs.checkpoint_sweep_counters()
        before = {k: c.value for k, c in counters.items()}
        removed = mod.sweep_stale(str(d), keep_steps={4})
        assert sorted(p.rsplit("/", 1)[1] for p in removed) == [
            "ckpt_1.tmp", "ckpt_2", "ckpt_3"]
        assert [s for s, _ in mod.committed_checkpoints(str(d))] == [4]
        deltas[name] = {k: c.value - before[k] for k, c in counters.items()}
    assert deltas["port"] == deltas["jax"] == {
        "staging": 1, "uncommitted": 1, "retention": 1, "orphan_shard": 0,
        "dist_abort": 0}
