"""The port's online-learning flywheel (analytics_zoo_tpu_torch.flywheel)
held to the JAX package's.

The cases of tests/test_flywheel.py run on the port: the shard writers'
time roll and reader hardening, the error-diffusion and keyed samplers,
the capture tap on and off the engine's hot path, replay, quarantine, the
trainer's warm start and high-water mark, the epoch-boundary warm start on
a different stream, the controller's closed loop, no-data cycle and
rollback, and the subprocess mid-retrain kill (its tier-1 cell; the deeper
cells stay marked ``slow`` as in the JAX file) through
tests/_torch_flywheel_worker.py. Beside them, the two packages on the same
inputs: a capture directory written by either replays bitwise in the other
(apart from the trace id and timestamp, which are the same here too: both
taps get the same ones), the JAX inspector reads the port's segments, a
bf16-compute model's capture records the JAX tap's dtype strings, the
samplers fire alike, and a retrained candidate equals the JAX trainer's
from the same incumbent and segments within ``F32_TOL`` (relative and
absolute).
"""

import json
import os
import shutil
import subprocess
import sys
import threading
import time
import zlib
from concurrent.futures import Future

import numpy as np
import pytest

import analytics_zoo_tpu_torch as port
from analytics_zoo_tpu_torch.batch import writers
from analytics_zoo_tpu_torch.flywheel import (
    CaptureConfig,
    CaptureSource,
    CaptureTap,
    FlywheelController,
    FlywheelTrainer,
    RetrainConfig,
)
from analytics_zoo_tpu_torch.flywheel.capture import (
    _Sampler,
    committed_segments,
    is_quarantined,
    quarantine_segment,
    segment_dirs,
)
from analytics_zoo_tpu_torch.ft import atomic, chaos
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_flywheel_worker.py")

#: a retrained candidate against the JAX trainer's, relative and absolute
#: (f32 rounding of a few SGD steps on weights of magnitude ~20)
F32_TOL = 1e-5


class _Boom(Exception):
    """Stands in for os._exit in in-process chaos tests."""


@pytest.fixture(autouse=True)
def _port_context():
    port.init_nncontext(device="cpu")
    reset_name_counts()
    yield
    chaos.reset()
    port.stop_nncontext()
    reset_name_counts()


@pytest.fixture
def chaos_raise(monkeypatch):
    def arm(point, skip=0):
        chaos.reset()
        monkeypatch.setenv("AZOO_FT_CHAOS", point)
        monkeypatch.setenv("AZOO_FT_CHAOS_SKIP", str(skip))
        monkeypatch.setattr(chaos, "fail",
                            lambda p: (_ for _ in ()).throw(_Boom(p)))
    yield arm
    chaos.reset()


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _wait_until(cond, timeout=5.0, interval=0.005):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


def _offer_rows(tap, n, model="m", version="1", start=0, dim=3):
    """Drive the tap offline: pre-built futures, deterministic rows."""
    for i in range(start, start + n):
        fut = Future()
        x = (np.arange(dim, dtype=np.float32) + i)[None, :]
        tap.offer(model, version, x, fut, trace=f"t{i:04d}")
        fut.set_result(np.full((1, 2), float(i), np.float32))


# ---------------------------------------------------------------------------
# the shard writers' time roll and reader hardening
# ---------------------------------------------------------------------------


def test_shard_writer_time_roll_commits_partial_shard(tmp_path):
    clock = _FakeClock()
    committed = []
    w = writers.JsonlShardWriter(str(tmp_path), rows_per_shard=100,
                                 roll_interval_s=5.0, clock=clock,
                                 on_shard=committed.append)
    w.append(np.array([0.0, 1.0]))
    clock.advance(4.9)
    assert w.maybe_roll() is False
    clock.advance(0.2)
    assert w.maybe_roll() is True
    assert len(committed) == 1 and committed[0]["rows"] == 2
    doc = writers.read_manifest(str(tmp_path))
    assert [s["rows"] for s in doc["shards"]] == [2]
    assert w.maybe_roll() is False
    w.append(np.array([2.0]))
    clock.advance(2.0)
    assert w.maybe_roll() is False
    clock.advance(3.5)
    assert w.maybe_roll() is True
    w.finalize()
    assert list(writers.iter_output_rows(str(tmp_path))) == [0.0, 1.0, 2.0]


def test_shard_writer_roll_validation_and_force(tmp_path):
    with pytest.raises(ValueError, match="roll_interval_s"):
        writers.JsonlShardWriter(str(tmp_path / "a"), roll_interval_s=0)
    w = writers.JsonlShardWriter(str(tmp_path / "b"), rows_per_shard=100)
    assert w.roll() is False
    w.append(np.array([1.0]))
    assert w.roll() is True
    assert w.maybe_roll() is False
    w.finalize()
    with pytest.raises(RuntimeError):
        w.roll()


def test_readers_on_live_capture_dir_see_only_committed_shards(tmp_path):
    d = str(tmp_path)
    stop = threading.Event()
    failures = []

    def write():
        w = writers.JsonlShardWriter(d, rows_per_shard=2)
        i = 0
        while not stop.is_set():
            w.append(np.array([float(i)]))
            i += 1
        w.finalize()

    def read():
        while not stop.is_set():
            try:
                doc = writers.read_manifest(d)
                if doc is None:
                    continue
                for rec in doc["shards"]:
                    if not os.path.isfile(os.path.join(d, rec["file"])):
                        failures.append(f"listed shard missing: {rec}")
                    if rec["file"].endswith(".tmp"):
                        failures.append(f"tmp debris listed: {rec}")
            except Exception as e:  # noqa: BLE001 — the regression itself
                failures.append(repr(e))

    writer = threading.Thread(target=write)
    readers = [threading.Thread(target=read) for _ in range(2)]
    writer.start()
    for r in readers:
        r.start()
    time.sleep(0.5)
    stop.set()
    writer.join(timeout=10)
    for r in readers:
        r.join(timeout=10)
    assert not failures, failures[:5]
    rows = list(writers.iter_output_rows(d))
    assert rows == [float(i) for i in range(len(rows))] and rows


def test_iter_output_rows_raises_loud_on_truncated_shard(tmp_path):
    w = writers.JsonlShardWriter(str(tmp_path), rows_per_shard=2)
    w.append(np.array([0.0, 1.0, 2.0, 3.0]))
    w.finalize()
    shard = os.path.join(str(tmp_path), "shard_00000.jsonl")
    with open(shard) as f:
        first_line = f.readline()
    with open(shard, "w") as f:
        f.write(first_line)
    with pytest.raises(writers.ShardCorruptError):
        list(writers.iter_output_rows(str(tmp_path)))


def test_read_manifest_retries_through_transient_unreadability(tmp_path,
                                                               monkeypatch):
    w = writers.JsonlShardWriter(str(tmp_path), rows_per_shard=1)
    w.append(np.array([0.0]))
    w.finalize()
    real_open = open
    calls = [0]

    def flaky_open(path, *a, **kw):
        if str(path).endswith(writers.MANIFEST) and calls[0] == 0:
            calls[0] += 1
            raise OSError("transient EBUSY")
        return real_open(path, *a, **kw)

    monkeypatch.setattr("builtins.open", flaky_open)
    doc = writers.read_manifest(str(tmp_path))
    assert doc is not None and len(doc["shards"]) == 1


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fraction,n", [(0.01, 1000), (0.1, 997),
                                        (0.333, 100), (1.0, 50)])
def test_error_diffusion_sampler_exact_count(fraction, n):
    s = _Sampler(fraction)
    fired = sum(s.fire() for _ in range(n))
    assert abs(fired - int(fraction * n)) <= 1, (fired, fraction, n)


def test_error_diffusion_sampler_concurrency_insensitive():
    s = _Sampler(0.07)
    per_thread, threads = 500, 8
    counts = [0] * threads

    def hammer(slot):
        counts[slot] = sum(bool(s.fire()) for _ in range(per_thread))

    ts = [threading.Thread(target=hammer, args=(i,)) for i in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert abs(sum(counts) - int(0.07 * threads * per_thread)) <= 1, counts


def test_sampler_rejects_bad_fraction():
    for bad in (0.0, -0.1, 1.5):
        with pytest.raises(ValueError):
            _Sampler(bad)


@pytest.mark.parametrize("fraction,per_key", [(0.1, 1000), (0.25, 997),
                                              (1.0, 40)])
def test_keyed_sampler_exact_per_route_key(fraction, per_key):
    s = _Sampler(fraction)
    keys = [f"tenant-{k}" for k in range(5)]
    counts = dict.fromkeys(keys, 0)
    for _ in range(per_key):
        for k in keys:
            counts[k] += s.fire(k)
    for n in counts.values():
        assert abs(n - int(fraction * per_key)) <= 1, counts
    fired = sum(s.fire() for _ in range(per_key))
    assert abs(fired - int(fraction * per_key)) <= 1


def test_keyed_sampler_lru_bound_and_determinism():
    s = _Sampler(0.5)
    pattern = [s.fire("k") for _ in range(8)]
    for i in range(_Sampler.MAX_KEYS + 64):
        s.fire(f"churn-{i}")
    assert len(s._keyed) <= _Sampler.MAX_KEYS
    assert [s.fire("k") for _ in range(8)] == pattern


def test_samplers_fire_like_the_jax_package():
    """Keyless and keyed (interleaved tenants, hash phases) fire patterns
    are the JAX sampler's, decision for decision."""
    from analytics_zoo_tpu.flywheel.capture import _Sampler as JaxSampler

    rng = np.random.default_rng(3)
    for fraction in (0.01, 0.07, 0.333, 1.0):
        ours, theirs = _Sampler(fraction), JaxSampler(fraction)
        keys = [None if k == 0 else f"tenant-{k}"
                for k in rng.integers(0, 6, 600)]
        assert [ours.fire(k) for k in keys] == [theirs.fire(k)
                                                for k in keys]


# ---------------------------------------------------------------------------
# capture tap
# ---------------------------------------------------------------------------


def test_capture_tap_writes_committed_replayable_segment(tmp_path):
    tap = CaptureTap(CaptureConfig(directory=str(tmp_path), fraction=1.0,
                                   rows_per_shard=8, idle_poll_s=0.01),
                     clock=lambda: 1700000000.0)
    tap.enable("m")
    _offer_rows(tap, 20)
    assert tap.flush()
    segment = tap.rotate("m")
    tap.close()
    assert segment is not None and writers.job_complete(segment)
    assert committed_segments(str(tmp_path / "m")) == [segment]
    rows = list(writers.iter_output_rows(segment))
    assert len(rows) == 20
    r = rows[0]
    assert r["v"] == "1" and r["t"] == "t0000" and r["ts"] == 1700000000.0
    assert np.dtype(r["xd"][0]) == np.float32
    assert np.dtype(r["yd"][0]) == np.float32
    np.testing.assert_array_equal(np.asarray(r["x"][0], np.float32),
                                  [0.0, 1.0, 2.0])


def test_capture_tap_drops_failed_predictions_and_counts_them(tmp_path):
    tap = CaptureTap(CaptureConfig(directory=str(tmp_path), fraction=1.0,
                                   idle_poll_s=0.01))
    tap.enable("m")
    before = tap.metrics["dropped"].labels(reason="predict_failed").value
    fut = Future()
    tap.offer("m", "1", [np.ones((1, 3), np.float32)], fut)
    fut.set_exception(RuntimeError("model exploded"))
    ok = Future()
    tap.offer("m", "1", [np.ones((1, 3), np.float32)], ok)
    ok.set_result(np.zeros((1, 2), np.float32))
    tap.flush()
    segment = tap.rotate("m")
    tap.close()
    assert len(list(writers.iter_output_rows(segment))) == 1
    assert tap.metrics["dropped"].labels(
        reason="predict_failed").value == before + 1


def test_capture_tap_disabled_model_not_sampled(tmp_path):
    tap = CaptureTap(CaptureConfig(directory=str(tmp_path), fraction=1.0))
    tap.enable("m")
    tap.disable("m")
    assert tap.offer("m", "1", [np.ones((1, 3), np.float32)],
                     Future()) is False
    tap.close()
    assert segment_dirs(str(tmp_path / "m")) == []


def test_capture_tap_resumes_unfinalized_segment_after_restart(tmp_path):
    cfg = CaptureConfig(directory=str(tmp_path), fraction=1.0,
                        rows_per_shard=4, idle_poll_s=0.01)
    tap = CaptureTap(cfg)
    tap.enable("m")
    _offer_rows(tap, 6)
    tap.flush()
    tap.close(finalize=False)
    assert committed_segments(str(tmp_path / "m")) == []
    tap2 = CaptureTap(cfg)
    tap2.enable("m")
    _offer_rows(tap2, 6, start=6)
    tap2.flush()
    segment = tap2.rotate("m")
    tap2.close()
    assert os.path.basename(segment) == "segment_00000"
    assert len(segment_dirs(str(tmp_path / "m"))) == 1
    rows = list(writers.iter_output_rows(segment))
    assert [r["t"] for r in rows] \
        == [f"t{i:04d}" for i in range(4)] + [f"t{i:04d}" for i in
                                              range(6, 12)]


def test_capture_torn_shard_then_writer_resume(tmp_path, chaos_raise):
    from analytics_zoo_tpu_torch.flywheel.capture import CaptureShardWriter

    d = str(tmp_path / "seg")
    chaos_raise("capture_writer_torn", skip=1)
    w = CaptureShardWriter(d, rows_per_shard=2)
    w.append([{"i": 0}, {"i": 1}])
    with pytest.raises(_Boom):
        w.append([{"i": 2}, {"i": 3}])
    chaos.reset()
    doc = writers.read_manifest(d)
    assert [s["rows"] for s in doc["shards"]] == [2]
    w2 = CaptureShardWriter(d, rows_per_shard=2)
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]
    w2.append([{"i": 2}, {"i": 3}])
    w2.finalize()
    assert [r["i"] for r in writers.iter_output_rows(d)] == [0, 1, 2, 3]


# ---------------------------------------------------------------------------
# the hook sits on the engine's real-submit path only
# ---------------------------------------------------------------------------


class _Doubler:
    def do_predict(self, x):
        return np.asarray(x, np.float32) * 2.0


def _engine_with_tap(tmp_path, **engine_kw):
    from analytics_zoo_tpu_torch.serving import BatcherConfig, ServingEngine

    engine = ServingEngine(**engine_kw)
    engine.register("m", _Doubler(), np.ones((1, 3), np.float32),
                    config=BatcherConfig(max_batch_size=8, max_wait_ms=1.0),
                    version="1")
    tap = CaptureTap(CaptureConfig(directory=str(tmp_path / "cap"),
                                   fraction=1.0, idle_poll_s=0.01))
    tap.enable("m")
    engine.set_capture(tap)
    return engine, tap


def test_capture_counts_each_request_once(tmp_path):
    engine, tap = _engine_with_tap(tmp_path)
    try:
        x = np.ones((1, 3), np.float32)
        for _ in range(10):
            engine.predict("m", x)
        assert tap.metrics["sampled"].value >= 10
        tap.flush()
        segment = tap.rotate("m")
        assert len(list(writers.iter_output_rows(segment))) == 10
    finally:
        tap.close()
        engine.shutdown()


def test_cache_hits_never_reach_the_tap(tmp_path):
    from analytics_zoo_tpu_torch.serving.result_cache import ResultCacheConfig

    engine, tap = _engine_with_tap(tmp_path,
                                   result_cache=ResultCacheConfig())
    try:
        x = np.ones((1, 3), np.float32)
        engine.predict("m", x)
        for _ in range(5):
            engine.predict("m", x)
        tap.flush()
        segment = tap.rotate("m")
        rows = list(writers.iter_output_rows(segment))
        assert len(rows) == 1, [r["t"] for r in rows]
    finally:
        tap.close()
        engine.shutdown()


def test_shadow_mirrors_never_reach_the_tap(tmp_path):
    from analytics_zoo_tpu_torch.serving import BatcherConfig

    class Tripler:
        def do_predict(self, x):
            return np.asarray(x, np.float32) * 3.0

    engine, tap = _engine_with_tap(tmp_path)
    try:
        engine.register("m", Tripler(), np.ones((1, 3), np.float32),
                        config=BatcherConfig(max_batch_size=8,
                                             max_wait_ms=1.0),
                        version="2", shadow=True, shadow_fraction=1.0)
        x = np.ones((1, 3), np.float32)
        for _ in range(8):
            np.testing.assert_array_equal(engine.predict("m", x), x * 2.0)
        _wait_until(lambda: tap.metrics["sampled"].value >= 8)
        tap.flush()
        segment = tap.rotate("m")
        rows = list(writers.iter_output_rows(segment))
        assert len(rows) == 8
        assert {r["v"] for r in rows} == {"1"}
        for r in rows:
            np.testing.assert_array_equal(
                np.asarray(r["y"][0], np.float32), x[0] * 2.0)
    finally:
        tap.close()
        engine.shutdown()


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------


def _make_segments(tmp_path, counts=(10, 6), tap_cls=CaptureTap,
                   config_cls=CaptureConfig):
    tap = tap_cls(config_cls(directory=str(tmp_path), fraction=1.0,
                             rows_per_shard=4, idle_poll_s=0.01),
                  clock=lambda: 1700000000.0)
    tap.enable("m")
    segs, start = [], 0
    for n in counts:
        _offer_rows(tap, n, start=start)
        tap.flush()
        segs.append(tap.rotate("m"))
        start += n
    tap.close()
    return segs


def test_capture_source_replays_all_rows_with_dtypes(tmp_path):
    src = CaptureSource(_make_segments(tmp_path))
    assert len(src) == 16
    x, y = src.fetch(0)
    assert x.dtype == np.float32 and y.dtype == np.float32
    np.testing.assert_array_equal(x, [0.0, 1.0, 2.0])
    np.testing.assert_array_equal(y, np.zeros(2, np.float32))
    xs = [float(src.fetch(i)[0][0]) for i in range(16)]
    assert xs == [float(i) for i in range(16)]


def test_capture_source_model_dir_discovers_committed_only(tmp_path):
    segs = _make_segments(tmp_path, counts=(4, 4, 4))
    quarantine_segment(segs[1], reason="test")
    src = CaptureSource(str(tmp_path / "m"))
    assert len(src) == 8
    xs = sorted(float(src.fetch(i)[0][0]) for i in range(8))
    assert xs == [0.0, 1.0, 2.0, 3.0, 8.0, 9.0, 10.0, 11.0]


def test_capture_source_rejects_quarantined_and_uncommitted_explicit(
        tmp_path):
    segs = _make_segments(tmp_path, counts=(4,))
    quarantine_segment(segs[0], reason="test")
    with pytest.raises(ValueError, match="quarantined"):
        CaptureSource(segs)
    with pytest.raises(ValueError, match="no committed capture segments"):
        CaptureSource(str(tmp_path / "nope"))


def test_capture_source_corrupt_shard_is_loud(tmp_path):
    segs = _make_segments(tmp_path, counts=(8,))
    shard = os.path.join(segs[0], "shard_00001.jsonl")
    data = open(shard, "rb").read()
    with open(shard, "wb") as f:
        f.write(data[:-3] + b"!!!")
    src = CaptureSource(segs)
    src.fetch(0)
    with pytest.raises(writers.ShardCorruptError):
        src.fetch(6)


def test_pipeline_from_capture_deterministic_batches(tmp_path):
    from analytics_zoo_tpu_torch.data.pipeline import Pipeline

    segs = _make_segments(tmp_path)
    a = Pipeline.from_capture(segs, seed=3).batch(4)
    b = Pipeline.from_capture(segs, seed=3).batch(4)
    batches_a = [batch[0] for batch in a.train_batches(seed=0)]
    batches_b = [batch[0] for batch in b.train_batches(seed=0)]
    assert len(batches_a) == 4
    for xa, xb in zip(batches_a, batches_b):
        np.testing.assert_array_equal(xa, xb)


def _replayed(src):
    out = []
    for i in range(len(src)):
        x, y = src.fetch(i)
        for a in (x if isinstance(x, list) else [x]) + \
                (y if isinstance(y, list) else [y]):
            out.append((a.dtype.str, a.shape, a.tobytes()))
    return out


def test_capture_directories_cross_packages_bitwise(tmp_path):
    """The same offers through the JAX tap and the port's: the segments'
    rows are equal, and each package's replay of either directory yields
    the same samples byte for byte (dtypes included), through
    ``Pipeline.from_capture`` too."""
    from analytics_zoo_tpu.data.pipeline import Pipeline as JaxPipeline
    from analytics_zoo_tpu.flywheel import CaptureConfig as JaxConfig
    from analytics_zoo_tpu.flywheel import CaptureSource as JaxSource
    from analytics_zoo_tpu.flywheel import CaptureTap as JaxTap
    from analytics_zoo_tpu_torch.data.pipeline import Pipeline

    ours = _make_segments(tmp_path / "port", counts=(9, 5))
    theirs = _make_segments(tmp_path / "jax", counts=(9, 5),
                            tap_cls=JaxTap, config_cls=JaxConfig)
    for a, b in zip(ours, theirs):
        assert list(writers.iter_output_rows(a)) == \
            list(writers.iter_output_rows(b))
        assert writers.read_manifest(a)["job"] == \
            writers.read_manifest(b)["job"]
    want = _replayed(JaxSource(theirs))
    assert len(want) == 2 * 14
    for segs in (ours, theirs):
        assert _replayed(CaptureSource(segs)) == want
        assert _replayed(JaxSource(segs)) == want
    got = list(Pipeline.from_capture(ours, seed=3).batch(4)
               .train_batches(seed=1))
    ref = list(JaxPipeline.from_capture(theirs, seed=3).batch(4)
               .train_batches(seed=1))
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        for u, v in zip(g, r):
            assert np.asarray(u).dtype == np.asarray(v).dtype
            np.testing.assert_array_equal(u, v)


def test_bf16_compute_capture_records_the_jax_taps_dtypes(tmp_path):
    """A bf16-compute Dense model served by each package's engine with a
    tap: the captured input rows and every dtype string are the JAX
    tap's (the served output is float32 in both), the predictions agree
    within bf16 rounding, and each package replays the other's rows."""
    import jax

    from analytics_zoo_tpu.flywheel import CaptureConfig as JaxConfig
    from analytics_zoo_tpu.flywheel import CaptureSource as JaxSource
    from analytics_zoo_tpu.flywheel import CaptureTap as JaxTap
    from analytics_zoo_tpu.inference import InferenceModel as JaxIM
    from analytics_zoo_tpu.keras import layers as jlayers
    from analytics_zoo_tpu.keras.engine import base as jbase
    from analytics_zoo_tpu.keras.engine import topology as jtopo
    from analytics_zoo_tpu.serving import BatcherConfig as JaxBC
    from analytics_zoo_tpu.serving import ServingEngine as JaxEngine
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.interop import load_jax_params
    from analytics_zoo_tpu_torch.keras.engine.topology import Sequential
    from analytics_zoo_tpu_torch.keras.layers import Dense
    from analytics_zoo_tpu_torch.serving import BatcherConfig, ServingEngine

    jbase.reset_name_counts()
    jnet = jtopo.Sequential([jlayers.Dense(4, activation="tanh",
                                           input_shape=(6,)),
                             jlayers.Dense(3)])
    jnet.compute_dtype = "bfloat16"
    jim = JaxIM().do_load_keras(jnet)
    net = Sequential([Dense(4, activation="tanh", input_shape=(6,)),
                      Dense(3)])
    net.compute_dtype = "bfloat16"
    load_jax_params(net, jax.tree_util.tree_map(np.asarray, jim.params))
    rng = np.random.default_rng(4)
    requests = [rng.normal(size=(1 + i % 3, 6)).astype(np.float32)
                for i in range(8)]

    def capture(engine_cls, bc_cls, tap_cls, cfg_cls, im, root):
        engine = engine_cls()
        engine.register("m", im, requests[0][:1],
                        config=bc_cls(max_batch_size=8, max_wait_ms=1.0),
                        version="1")
        tap = tap_cls(cfg_cls(directory=str(root), fraction=1.0,
                              idle_poll_s=0.01), clock=lambda: 5.0)
        tap.enable("m")
        engine.set_capture(tap)
        try:
            for r in requests:
                engine.predict("m", r)
            tap.flush()
            return tap.rotate("m")
        finally:
            tap.close()
            engine.shutdown()

    ours = capture(ServingEngine, BatcherConfig, CaptureTap, CaptureConfig,
                   InferenceModel().do_load_keras(net), tmp_path / "port")
    theirs = capture(JaxEngine, JaxBC, JaxTap, JaxConfig,
                     jim, tmp_path / "jax")
    a = list(writers.iter_output_rows(ours))
    b = list(writers.iter_output_rows(theirs))
    assert len(a) == len(b) == sum(len(r) for r in requests)
    for ra, rb in zip(a, b):
        assert (ra["xd"], ra["yd"], ra["xm"], ra["ym"], ra["v"]) == \
            (rb["xd"], rb["yd"], rb["xm"], rb["ym"], rb["v"])
        assert ra["xd"] == ["<f4"] and ra["yd"] == ["<f4"]
        assert ra["x"] == rb["x"]
        # bf16 compute: both round the same f32 operands to bf16
        np.testing.assert_allclose(ra["y"], rb["y"], rtol=0, atol=2e-2)
    assert _replayed(JaxSource([ours])) == _replayed(CaptureSource([ours]))
    assert _replayed(CaptureSource([theirs])) == \
        _replayed(JaxSource([theirs]))


# ---------------------------------------------------------------------------
# quarantine, and the JAX inspector over the port's segments
# ---------------------------------------------------------------------------


def test_quarantine_is_idempotent_and_filters_replay(tmp_path):
    (seg,) = _make_segments(tmp_path, counts=(4,))
    assert not is_quarantined(seg)
    quarantine_segment(seg, reason="rollback of candidate 9")
    quarantine_segment(seg, reason="again")
    assert is_quarantined(seg)
    assert committed_segments(str(tmp_path / "m")) == []
    with open(os.path.join(seg, "QUARANTINE")) as f:
        assert "again" in json.load(f)["reason"]


@pytest.fixture()
def inspect_mod():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "ckpt_inspect", os.path.join(REPO, "scripts", "ckpt_inspect.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_jax_inspector_reads_the_ports_capture_segment(tmp_path,
                                                       inspect_mod, capsys):
    (seg,) = _make_segments(tmp_path, counts=(6,))
    inspect_mod.main([seg, "--verify"])
    out = capsys.readouterr().out
    assert "versions" in out and "times" in out
    assert "capture segment for model 'm': COMMITTED" in out
    quarantine_segment(seg, reason="test")
    inspect_mod.main([seg])
    assert "QUARANTINED" in capsys.readouterr().out


def test_jax_inspector_flags_a_corrupt_port_segment(tmp_path, inspect_mod,
                                                    capsys):
    (seg,) = _make_segments(tmp_path, counts=(6,))
    with open(os.path.join(seg, "shard_00000.jsonl"), "ab") as f:
        f.write(b"garbage\n")
    with pytest.raises(SystemExit) as exc:
        inspect_mod.main([seg, "--verify"])
    assert exc.value.code == 1
    assert "CORRUPT" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------


def _build_est(in_dim=3, out_dim=2):
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.keras.engine.topology import Sequential
    from analytics_zoo_tpu_torch.keras.layers import Dense
    from analytics_zoo_tpu_torch.keras.optimizers import SGD

    return Estimator(Sequential([Dense(out_dim, input_shape=(in_dim,))]),
                     SGD(0.05))


def _seed_incumbent(ckpt_dir, in_dim=3, out_dim=2):
    from analytics_zoo_tpu_torch.data.feature_set import ArrayFeatureSet
    from analytics_zoo_tpu_torch.keras import objectives

    def build():
        return _build_est(in_dim, out_dim)

    rng = np.random.default_rng(0)
    est = build()
    est.set_checkpoint(str(ckpt_dir), keep_last=8, asynchronous=False)
    est.train(ArrayFeatureSet(
        rng.normal(size=(16, in_dim)).astype(np.float32),
        rng.normal(size=(16, out_dim)).astype(np.float32)),
        objectives.mean_squared_error, batch_size=8)
    return build, objectives.mean_squared_error


def _trainer(tmp_path, build, criterion, **kw):
    base = dict(capture_dir=str(tmp_path / "m"),
                checkpoint_dir=str(tmp_path / "ckpts"),
                batch_size=8, checkpoint_every=2, keep_last=8, min_rows=4)
    base.update(kw)
    return FlywheelTrainer(build, criterion, RetrainConfig(**base))


def test_trainer_warm_starts_and_checkpoints_high_water_mark(tmp_path):
    build, crit = _seed_incumbent(tmp_path / "ckpts")
    _make_segments(tmp_path, counts=(10,))
    trainer = _trainer(tmp_path, build, crit)
    base = trainer.incumbent_step()
    step = trainer.run_once()
    assert step == base + 2
    assert trainer.consumed_segments() == {"segment_00000"}
    assert trainer.pending_segments() == []
    assert trainer.run_once() is None
    assert trainer.last_consumed == []
    _make_segments(tmp_path, counts=(10,))
    step2 = trainer.run_once()
    assert step2 == step + 2
    assert trainer.consumed_segments() == {"segment_00000",
                                           "segment_00001"}


def test_trainer_skips_below_min_rows(tmp_path):
    build, crit = _seed_incumbent(tmp_path / "ckpts")
    _make_segments(tmp_path, counts=(2,))
    trainer = _trainer(tmp_path, build, crit, min_rows=100)
    assert trainer.run_once() is None
    assert trainer.pending_segments() != []


def test_trainer_discard_candidates_after(tmp_path):
    build, crit = _seed_incumbent(tmp_path / "ckpts")
    _make_segments(tmp_path, counts=(10,))
    trainer = _trainer(tmp_path, build, crit)
    base = trainer.incumbent_step()
    step = trainer.run_once()
    removed = trainer.discard_candidates_after(base)
    assert any(p.endswith(f"ckpt_{step}") for p in removed)
    assert trainer.incumbent_step() == base


def test_trainer_mid_retrain_kill_in_process(tmp_path, chaos_raise):
    build, crit = _seed_incumbent(tmp_path / "ckpts")
    _make_segments(tmp_path, counts=(16,))
    trainer = _trainer(tmp_path, build, crit)
    chaos_raise("flywheel_mid_retrain_kill", skip=1)
    with pytest.raises(_Boom):
        trainer.run_once()
    chaos.reset()
    for var in ("AZOO_FT_CHAOS", "AZOO_FT_CHAOS_SKIP"):
        os.environ.pop(var, None)
    assert trainer.consumed_segments() == set()
    step = _trainer(tmp_path, build, crit).run_once()
    assert step is not None
    assert trainer.consumed_segments() == {"segment_00000"}


def test_trained_candidate_equals_the_jax_trainers(tmp_path):
    """One incumbent (the JAX package's initial weights, trained an epoch
    in each package) and one capture segment: the port's retrain and the
    JAX trainer's commit the same step, consume the same segment, and
    their candidates' parameters agree within F32_TOL (rtol and atol)."""
    import jax

    from analytics_zoo_tpu.data.feature_set import ArrayFeatureSet as JFS
    from analytics_zoo_tpu.engine.estimator import Estimator as JEstimator
    from analytics_zoo_tpu.flywheel import FlywheelTrainer as JTrainer
    from analytics_zoo_tpu.flywheel import RetrainConfig as JConfig
    from analytics_zoo_tpu.keras import layers as jlayers
    from analytics_zoo_tpu.keras import objectives as jobj
    from analytics_zoo_tpu.keras import optimizers as jopt
    from analytics_zoo_tpu.keras.engine import base as jbase
    from analytics_zoo_tpu.keras.engine import topology as jtopo
    from analytics_zoo_tpu_torch.data.feature_set import ArrayFeatureSet
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.interop import load_jax_params
    from analytics_zoo_tpu_torch.keras import objectives
    from analytics_zoo_tpu_torch.keras.engine.topology import Sequential
    from analytics_zoo_tpu_torch.keras.layers import Dense
    from analytics_zoo_tpu_torch.keras.optimizers import SGD

    def jnet():
        jbase.reset_name_counts()
        return jtopo.Sequential([jlayers.Dense(5, activation="tanh",
                                               input_shape=(3,)),
                                 jlayers.Dense(2)])

    def net():
        reset_name_counts()
        return Sequential([Dense(5, activation="tanh", input_shape=(3,)),
                           Dense(2)])

    first = JEstimator(jnet(), jopt.SGD(0.05))
    first._ensure_state()
    init = jax.tree_util.tree_map(np.asarray, first.tstate.params)

    def jbuild():
        est = JEstimator(jnet(), jopt.SGD(0.05))
        est._ensure_state()
        est.tstate = est.tstate._replace(params=est.place_params(
            jax.tree_util.tree_map(jax.numpy.asarray, init)))
        return est

    def build():
        m = net()
        load_jax_params(m, init)
        return Estimator(m, SGD(0.05))

    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 3)).astype(np.float32)
    y = rng.normal(size=(16, 2)).astype(np.float32)
    for root, make, fs, crit in (
            (tmp_path / "jax", jbuild, JFS, jobj.mean_squared_error),
            (tmp_path / "port", build, ArrayFeatureSet,
             objectives.mean_squared_error)):
        est = make()
        est.set_checkpoint(str(root / "ckpts"), keep_last=8,
                           asynchronous=False)
        est.train(fs(x, y), crit, batch_size=8)
        _make_segments(root, counts=(24,))
    cfg = dict(batch_size=8, checkpoint_every=2, keep_last=8, min_rows=4)
    jtr = JTrainer(jbuild, jobj.mean_squared_error, JConfig(
        capture_dir=str(tmp_path / "jax" / "m"),
        checkpoint_dir=str(tmp_path / "jax" / "ckpts"), **cfg))
    tr = _trainer(tmp_path / "port", build, objectives.mean_squared_error)
    jstep, step = jtr.run_once(), tr.run_once()
    assert step == jstep == 2 + 3
    assert tr.consumed_segments() == jtr.consumed_segments()
    jflat, jmeta = atomic.read_checkpoint(
        dict(atomic.committed_checkpoints(str(tmp_path / "jax" / "ckpts")))
        [jstep])
    flat, meta = atomic.read_checkpoint(
        dict(atomic.committed_checkpoints(str(tmp_path / "port" / "ckpts")))
        [step])
    assert (meta["epoch"], meta["iteration"]) == \
        (jmeta["epoch"], jmeta["iteration"])
    # ``.params/<layer>/<weight>`` keys are the same in both packages
    jparams = {k: v for k, v in jflat if k.startswith(".params/")}
    params = {k: v for k, v in flat if k.startswith(".params/")}
    assert sorted(params) == sorted(jparams) and len(params) == 4
    for k, v in params.items():
        np.testing.assert_allclose(v, jparams[k], rtol=F32_TOL,
                                   atol=F32_TOL)


# ---------------------------------------------------------------------------
# the estimator's warm start on a different stream
# ---------------------------------------------------------------------------


def test_epoch_boundary_restore_accepts_different_stream(tmp_path):
    from analytics_zoo_tpu_torch.data.pipeline import Pipeline
    from analytics_zoo_tpu_torch.data.sources import ArraySource
    from analytics_zoo_tpu_torch.keras import objectives

    def pipe(n):
        rng = np.random.default_rng(n)
        return Pipeline(ArraySource(
            rng.normal(size=(n, 3)).astype(np.float32),
            rng.normal(size=(n, 2)).astype(np.float32)))

    est = _build_est()
    est.set_checkpoint(str(tmp_path), keep_last=4, asynchronous=False)
    est.train(pipe(16), objectives.mean_squared_error, batch_size=8)
    est2 = _build_est()
    est2.set_checkpoint(str(tmp_path), keep_last=4, asynchronous=False)
    est2.train(pipe(24), objectives.mean_squared_error, batch_size=8,
               auto_resume=True)
    assert est2.run_state.epoch == 2
    est3 = _build_est()
    est3.set_checkpoint(str(tmp_path), keep_last=4, asynchronous=False)
    est3._restored_data_state = {"version": 1, "position_batches": 2,
                                 "num_samples": 16, "batch_size": 8,
                                 "rng_seed": None, "epoch_seed": 1,
                                 "samples_seen": 16,
                                 "shuffle_buffer": None,
                                 "shuffle_seed": None}
    with pytest.raises(ValueError, match="different stream"):
        est3.train(pipe(24), objectives.mean_squared_error, batch_size=8)


# ---------------------------------------------------------------------------
# controller: the closed loop
# ---------------------------------------------------------------------------


class _Lin:
    def __init__(self, w, b):
        self.w, self.b = w, b

    def do_predict(self, x):
        return np.asarray(x, np.float32) @ self.w + self.b


def _build_lin(path):
    flat, _ = atomic.read_checkpoint(path)
    d = dict(flat)
    w = next(v for v in d.values() if getattr(v, "ndim", 0) == 2)
    b = next(v for v in d.values() if getattr(v, "ndim", 0) == 1)
    return _Lin(np.asarray(w), np.asarray(b))


def _closed_loop(tmp_path, ladder=(0.25, 1.0)):
    from analytics_zoo_tpu_torch.serving import (
        BatcherConfig,
        RolloutConfig,
        ServingEngine,
    )

    build, crit = _seed_incumbent(tmp_path / "ckpts", in_dim=3)
    engine = ServingEngine(rollout=RolloutConfig(
        ladder=ladder, min_requests=4, auto_evaluate=False))
    tap = CaptureTap(CaptureConfig(directory=str(tmp_path / "cap"),
                                   fraction=1.0, rows_per_shard=16,
                                   roll_interval_s=0.1, idle_poll_s=0.02))
    engine.set_capture(tap)
    trainer = FlywheelTrainer(build, crit, RetrainConfig(
        capture_dir=str(tmp_path / "cap" / "m"),
        checkpoint_dir=str(tmp_path / "ckpts"),
        batch_size=8, checkpoint_every=2, min_rows=8))
    ctrl = FlywheelController(
        engine, "m", tap, trainer, _build_lin,
        example_input=np.ones((1, 3), np.float32),
        config=BatcherConfig(max_batch_size=8, max_wait_ms=1.0))
    return engine, tap, trainer, ctrl


def test_controller_closed_loop_promotes_with_zero_client_errors(tmp_path):
    engine, tap, trainer, ctrl = _closed_loop(tmp_path)
    try:
        incumbent = str(trainer.incumbent_step())
        assert engine.stats()["m"]["latest"] == incumbent
        x = np.ones((1, 3), np.float32)
        errors = [0]
        for _ in range(40):
            engine.predict("m", x)

        def traffic():
            for _ in range(8):
                try:
                    engine.predict("m", x)
                except Exception:  # noqa: BLE001 — counted, must be 0
                    errors[0] += 1

        report = ctrl.run_cycle(traffic_fn=traffic, timeout_s=60)
        assert report.outcome == "promoted", report
        assert errors[0] == 0
        assert engine.stats()["m"]["latest"] == str(report.candidate_step)
        assert report.quarantined == []
        assert trainer.pending_segments() == []
        from analytics_zoo_tpu_torch.common.observability import get_registry

        text = get_registry().render()
        assert "zoo_flywheel_cycles_total" in text
        assert "zoo_capture_shards_committed_total" in text
    finally:
        ctrl.close()
        tap.close()
        engine.shutdown()


def test_controller_no_data_cycle(tmp_path):
    engine, tap, trainer, ctrl = _closed_loop(tmp_path)
    try:
        report = ctrl.run_cycle(timeout_s=5)
        assert report.outcome == "no_data"
        assert report.candidate_step is None
    finally:
        ctrl.close()
        tap.close()
        engine.shutdown()


def test_controller_rollback_quarantines_capture_data(tmp_path):
    engine, tap, trainer, ctrl = _closed_loop(tmp_path)
    try:
        incumbent = str(trainer.incumbent_step())
        x = np.ones((1, 3), np.float32)
        for _ in range(40):
            engine.predict("m", x)
        armed = [False]

        def traffic():
            if not armed[0]:
                desc = engine.rollout_controller().describe("m")
                if desc is not None and desc.get("canary"):
                    chaos.arm_serving("canary_errors",
                                      tag=f"m@{desc['canary']}")
                    armed[0] = True
            for _ in range(8):
                try:
                    engine.predict("m", x)
                except Exception:  # noqa: BLE001 — canary-routed request
                    pass

        base = trainer.incumbent_step()
        report = ctrl.run_cycle(traffic_fn=traffic, timeout_s=60)
        assert armed[0], "canary never appeared"
        assert report.outcome == "rolled_back", report
        assert report.rollback_reason in ("breaker_open", "error_rate")
        assert engine.stats()["m"]["latest"] == incumbent
        assert trainer.incumbent_step() == base
        assert report.quarantined and all(
            is_quarantined(s) for s in report.quarantined)
        assert trainer.pending_segments() == []
        chaos.reset()
        assert ctrl.run_cycle(timeout_s=5).outcome == "no_data"
        np.testing.assert_array_equal(engine.predict("m", x).shape, (1, 2))
    finally:
        ctrl.close()
        tap.close()
        engine.shutdown()


# ---------------------------------------------------------------------------
# subprocess mid-retrain kill: a bitwise resumed candidate
# ---------------------------------------------------------------------------


def _worker_env(chaos_point=None, skip=0) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = ""
    env.pop("AZOO_FT_CHAOS", None)
    env.pop("AZOO_FT_CHAOS_SKIP", None)
    if chaos_point is not None:
        env["AZOO_FT_CHAOS"] = chaos_point
        env["AZOO_FT_CHAOS_SKIP"] = str(skip)
    return env


def _run_worker(mode, root, out, env) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, WORKER, mode, str(root), str(out)],
        env=env, capture_output=True, text=True, timeout=240)


@pytest.fixture(scope="module")
def seeded_root(tmp_path_factory):
    d = tmp_path_factory.mktemp("fly_seed")
    proc = _run_worker("seed", d / "root", d / "seed.json", _worker_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    return d / "root"


def _retrain_cell(tmp_path, seeded_root, kill_skip):
    ref_root, chaos_root = tmp_path / "ref", tmp_path / "chaos"
    shutil.copytree(seeded_root, ref_root)
    shutil.copytree(seeded_root, chaos_root)
    ref_out = tmp_path / "ref.json"
    proc = _run_worker("retrain", ref_root, ref_out, _worker_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    chaos_out = tmp_path / "chaos.json"
    proc = _run_worker("retrain", chaos_root, chaos_out,
                       _worker_env("flywheel_mid_retrain_kill",
                                   skip=kill_skip))
    assert proc.returncode == chaos.EXIT_CODE, (
        f"worker should have died (rc={proc.returncode})\n"
        + proc.stderr[-3000:])
    assert not chaos_out.exists(), "killed run must not have finished"
    proc = _run_worker("retrain", chaos_root, chaos_out, _worker_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(ref_out) as f:
        ref = json.load(f)
    with open(chaos_out) as f:
        got = json.load(f)
    assert got["step"] == ref["step"]
    assert got["consumed"] == ref["consumed"]
    assert sorted(got["leaves"]) == sorted(ref["leaves"])
    for key, crc in ref["leaves"].items():
        assert got["leaves"][key] == crc, f"leaf {key} differs"


def test_mid_retrain_kill_resume_bitwise_canary(tmp_path, seeded_root):
    _retrain_cell(tmp_path, seeded_root, kill_skip=0)


@pytest.mark.slow
@pytest.mark.parametrize("kill_skip", [2, 4, 5])
def test_mid_retrain_kill_matrix_bitwise(tmp_path, seeded_root, kill_skip):
    _retrain_cell(tmp_path, seeded_root, kill_skip=kill_skip)


def test_flywheel_chaos_points_are_known():
    assert "capture_writer_torn" in chaos.FLYWHEEL_POINTS
    assert "flywheel_mid_retrain_kill" in chaos.FLYWHEEL_POINTS
    from analytics_zoo_tpu.ft import chaos as jchaos

    assert chaos.FLYWHEEL_POINTS == jchaos.FLYWHEEL_POINTS
    for point in chaos.FLYWHEEL_POINTS:
        os.environ["AZOO_FT_CHAOS"] = point
        try:
            assert chaos.active_point() == point
        finally:
            os.environ.pop("AZOO_FT_CHAOS", None)


def test_flywheel_package_exports_the_jax_surface():
    import analytics_zoo_tpu.flywheel as jfw
    import analytics_zoo_tpu_torch.flywheel as fw

    assert fw.__all__ == jfw.__all__
    for name in fw.__all__:
        assert hasattr(fw, name)
    assert fw.CAPTURE_FORMAT == jfw.CAPTURE_FORMAT
    assert zlib.crc32(b"") == 0
