"""The port's streaming input pipeline (data/pipeline.py, data/sources.py)
held to the JAX package's.

The host-side cases of tests/test_streaming_pipeline.py run on the port:
the stream is ``FeatureSet.train_batches`` when no shuffle stage is added,
map workers change throughput and never bytes, the shuffle and tail
policies, checkpointed iterators that resume bitwise in O(1) sample work,
loud ``state_dict`` mismatches, metrics, the ``data.epoch`` span and
worker-pool teardown. Every stream, ``state_dict`` included, is held
bitwise to the JAX ``Pipeline``'s for the same source, seed, worker count
and ladder, with a case for each source of data/sources.py. The device
paths: ``device_batches`` (prefetch, metrics, teardown) and
``Estimator.train`` over a pipeline, which equals training over the
``FeatureSet`` and the JAX package's trajectory, resumes a mid-epoch kill
bitwise from the stream position in its checkpoint, and rejects a
mismatched pipeline.
"""

import gc
import os
import threading
import time

import numpy as np
import pytest

from analytics_zoo_tpu.data import pipeline as jax_pipeline
from analytics_zoo_tpu.data import sources as jax_sources
from analytics_zoo_tpu_torch.data.feature_set import ArrayFeatureSet
from analytics_zoo_tpu_torch.data.pipeline import Pipeline
from analytics_zoo_tpu_torch.data.sources import (
    ArraySource,
    FeatureSetSource,
    FileSource,
    ImageSetSource,
    NpyRowsSource,
    TextSetSource,
)


def _data(n=23, dim=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    y = np.arange(n).astype(np.int32)
    return x, y


def _assert_streams_equal(a, b):
    assert len(a) == len(b)
    for (ax, ay, am), (bx, by, bm) in zip(a, b):
        for u, v in ((ax, bx), (ay, by), (am, bm)):
            if isinstance(u, (list, tuple)):
                assert len(u) == len(v)
                for uu, vv in zip(u, v):
                    assert np.asarray(uu).dtype == np.asarray(vv).dtype
                    np.testing.assert_array_equal(uu, vv)
            elif u is None:
                assert v is None
            else:
                assert np.asarray(u).dtype == np.asarray(v).dtype
                np.testing.assert_array_equal(u, v)


def _pipeline_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(("zoo-data-worker", "zoo-data-prefetch"))]


def _assert_no_pipeline_threads(timeout=3.0):
    """Worker and prefetch threads must be gone; poll briefly (pool
    shutdown joins, but GC-driven closes finish asynchronously)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not _pipeline_threads():
            return
        time.sleep(0.02)
    raise AssertionError(f"orphaned pipeline threads: {_pipeline_threads()}")


def _aug(rec, rng):
    xx, yy = rec
    return xx + 0.01 * rng.normal(size=xx.shape).astype(np.float32), yy


# ---------------------------------------------------------------------------
# stream semantics
# ---------------------------------------------------------------------------


def test_pipeline_matches_feature_set_stream_bitwise():
    """No shuffle stage -> the pipeline IS FeatureSet.train_batches,
    wrap-padded tail (mask zeros included) and all."""
    x, y = _data()
    fs = ArrayFeatureSet(x, y)
    ref = list(fs.train_batches(5, shuffle=True, seed=3))
    got = list(Pipeline.from_feature_set(fs).batch(5)
               .train_batches(5, shuffle=True, seed=3))
    _assert_streams_equal(ref, got)
    _assert_streams_equal(list(fs.eval_batches(5)),
                          list(Pipeline.from_feature_set(fs)
                               .batch(5).eval_batches(5)))


def test_map_worker_count_invariance():
    """A randomized map gives the SAME bytes for any worker count: each
    sample's RNG is seeded from (pipeline seed, epoch, index), not from
    arrival order."""
    x, y = _data()

    def aug(rec, rng):
        xx, yy = rec
        return xx + rng.normal(size=xx.shape).astype(np.float32), yy

    def run(workers):
        p = Pipeline(ArraySource(x, y), seed=11).map(
            aug, num_workers=workers).batch(5)
        return list(p.train_batches(5, shuffle=True, seed=2))

    base = run(0)
    for workers in (1, 4, 7):
        _assert_streams_equal(base, run(workers))
    other = list(Pipeline(ArraySource(x, y), seed=12).map(aug).batch(5)
                 .train_batches(5, shuffle=True, seed=2))
    assert any(not np.array_equal(a[0], b[0]) for a, b in zip(base, other))


def test_shuffle_stage_every_sample_once_and_deterministic():
    n = 37
    x, y = _data(n)
    p = Pipeline(ArraySource(x, y)).shuffle(8, seed=5).batch(10)
    batches = list(p.train_batches(10, shuffle=True, seed=4))
    labels = np.concatenate([b[1][b[2].astype(bool)] for b in batches])
    assert sorted(labels.tolist()) == list(range(n))
    assert labels.tolist() != list(range(n))
    again = list(p.train_batches(10, shuffle=True, seed=4))
    _assert_streams_equal(batches, again)
    other_epoch = list(p.train_batches(10, shuffle=True, seed=5))
    assert not np.array_equal(batches[0][1], other_epoch[0][1])


def test_batch_tail_policies():
    x, y = _data(18)
    base = Pipeline(ArraySource(x, y))
    full = list(base.batch(8).train_batches(8, shuffle=False))
    assert [b[0].shape[0] for b in full] == [8, 8, 8]
    assert full[-1][2].sum() == 2
    dropped = list(base.batch(8, drop_remainder=True)
                   .train_batches(8, shuffle=False))
    assert [b[0].shape[0] for b in dropped] == [8, 8]
    bucketed = list(base.batch(8, pad_to_bucket=(2, 4, 8))
                    .train_batches(8, shuffle=False))
    assert [b[0].shape[0] for b in bucketed] == [8, 8, 2]
    assert bucketed[-1][2].sum() == 2
    with pytest.raises(ValueError):
        base.batch(8, drop_remainder=True, pad_to_bucket=(8,))
    with pytest.raises(ValueError):
        base.batch(8, pad_to_bucket=(2, 4))


# ---------------------------------------------------------------------------
# bitwise against the JAX package
# ---------------------------------------------------------------------------


def _both(build, consume):
    """``consume(build(P, S))`` for the port and for the JAX package
    (``P`` the Pipeline class, ``S`` the sources module)."""
    from analytics_zoo_tpu_torch.data import sources as port_sources

    return (consume(build(Pipeline, port_sources)),
            consume(build(jax_pipeline.Pipeline, jax_sources)))


_STREAMS = {
    "plain": lambda P, S, x, y: P(S.ArraySource(x, y)).batch(5),
    "map-w0": lambda P, S, x, y: P(S.ArraySource(x, y), seed=11).map(
        _aug).batch(5),
    "map-w3": lambda P, S, x, y: P(S.ArraySource(x, y), seed=11).map(
        _aug, num_workers=3).batch(5),
    "shuffle": lambda P, S, x, y: P(S.ArraySource(x, y), seed=2).map(
        _aug, num_workers=2).shuffle(8, seed=5).batch(6),
    "ladder": lambda P, S, x, y: P(S.ArraySource(x, y)).batch(
        8, pad_to_bucket=(2, 4, 8)),
    "drop": lambda P, S, x, y: P(S.ArraySource(x, y)).batch(
        8, drop_remainder=True),
    "prefetch": lambda P, S, x, y: P(S.ArraySource(x, y), seed=4).map(
        _aug, num_workers=2).shuffle(4, seed=1).batch(4).prefetch(2),
    "multi-input": lambda P, S, x, y: P(S.ArraySource(
        [x, x[:, :2] * 2], [y, y + 1])).batch(5),
}


@pytest.mark.parametrize("name", sorted(_STREAMS))
@pytest.mark.parametrize("shuffle", [False, True])
def test_streams_bitwise_the_jax_pipeline(name, shuffle):
    x, y = _data(23)
    port, ref = _both(
        lambda P, S: _STREAMS[name](P, S, x, y),
        lambda p: list(p.train_batches(shuffle=shuffle, seed=3)))
    _assert_streams_equal(port, ref)
    port, ref = _both(lambda P, S: _STREAMS[name](P, S, x, y),
                      lambda p: list(p.eval_batches()))
    _assert_streams_equal(port, ref)


def test_host_batches_and_state_dict_bitwise_the_jax_pipeline():
    """host_batches from a start step, and a state_dict taken mid-epoch
    and loaded into the other package's pipeline, resume bitwise."""
    x, y = _data(29)

    def build(P, S):
        return (P(S.ArraySource(x, y), seed=9).map(_aug, num_workers=3)
                .shuffle(8, seed=5).batch(6, pad_to_bucket=(2, 6))
                .prefetch(2))

    port, ref = _both(build, lambda p: list(p.host_batches(start_step=2)))
    _assert_streams_equal(port, ref)

    def state_after_two(p):
        it = p.train_batches(shuffle=True, seed=2)
        head = [next(it) for _ in range(2)]
        state = it.state_dict()
        it.close()
        return head, state

    (p_head, p_state), (j_head, j_state) = _both(build, state_after_two)
    _assert_streams_equal(p_head, j_head)
    assert p_state == j_state
    # each package resumes from the other's state
    from analytics_zoo_tpu_torch.data import sources as port_sources

    rest_port = list(build(Pipeline, port_sources).load_state_dict(j_state)
                     .train_batches(shuffle=True, seed=2))
    rest_jax = list(build(jax_pipeline.Pipeline, jax_sources)
                    .load_state_dict(p_state)
                    .train_batches(shuffle=True, seed=2))
    _assert_streams_equal(rest_port, rest_jax)
    full = list(build(Pipeline, port_sources).train_batches(
        shuffle=True, seed=2))
    _assert_streams_equal(p_head + rest_port, full)


# ---------------------------------------------------------------------------
# checkpointable iterators
# ---------------------------------------------------------------------------


class _CountingSource(ArraySource):
    def __init__(self, x, y):
        super().__init__(x, y)
        self.fetches = 0

    def fetch(self, i):
        self.fetches += 1
        return super().fetch(i)


def test_state_roundtrip_resumes_bitwise_in_o1_sample_work():
    x, y = _data(29)

    def aug(rec, rng):
        xx, yy = rec
        return xx * (1 + 0.1 * rng.random()), yy

    def build(src):
        return (Pipeline(src, seed=9).map(aug, num_workers=3)
                .shuffle(8, seed=5).batch(6).prefetch(2))

    full = list(build(ArraySource(x, y)).train_batches(6, shuffle=True,
                                                       seed=2))
    it = build(ArraySource(x, y)).train_batches(6, shuffle=True, seed=2)
    consumed = [next(it) for _ in range(2)]
    state = it.state_dict()
    it.close()
    assert state["position_batches"] == 2
    assert state["version"] == 1

    src2 = _CountingSource(x, y)
    rest = list(build(src2).load_state_dict(state)
                .train_batches(6, shuffle=True, seed=2))
    _assert_streams_equal(consumed + rest, full)
    # only the remaining samples (and the wrap pads) were fetched
    assert src2.fetches <= (29 - 2 * 6) + 6


def test_state_dict_mismatch_rejected():
    x, y = _data(20)
    p = Pipeline(ArraySource(x, y), seed=1).shuffle(4, seed=2).batch(5)
    it = p.train_batches(5, shuffle=True, seed=0)
    next(it)
    state = it.state_dict()
    it.close()

    bad_shuffle = Pipeline(ArraySource(x, y), seed=1).shuffle(
        4, seed=3).batch(5)
    with pytest.raises(ValueError, match="shuffle_seed"):
        bad_shuffle.load_state_dict(state)
    bad_batch = Pipeline(ArraySource(x, y), seed=1).shuffle(
        4, seed=2).batch(4)
    with pytest.raises(ValueError, match="batch_size"):
        bad_batch.load_state_dict(state)
    bad_n = Pipeline(ArraySource(x[:10], y[:10]), seed=1).shuffle(
        4, seed=2).batch(5)
    with pytest.raises(ValueError, match="num_samples"):
        bad_n.load_state_dict(state)
    with pytest.raises(ValueError, match="version"):
        p.load_state_dict({**state, "version": 999})
    # an epoch-seed mismatch warns and starts the epoch from 0
    p2 = Pipeline(ArraySource(x, y), seed=1).shuffle(4, seed=2).batch(5)
    p2.load_state_dict(state)
    fresh = list(p2.train_batches(5, shuffle=True, seed=7))
    assert len(fresh) == 4


# ---------------------------------------------------------------------------
# the device paths
# ---------------------------------------------------------------------------


def test_device_paths_raise_naming_their_roadmap_items(tmp_path):
    """The paths that once raised run: ``device_batches`` yields tensors
    on the context's device (the CPU here) equal to the host stream, and
    ``from_capture`` / ``from_labeled_capture`` stream the flywheel's
    segments."""
    import torch

    import analytics_zoo_tpu_torch as port
    from analytics_zoo_tpu_torch.flywheel import CaptureConfig, CaptureTap
    from analytics_zoo_tpu_torch.flywheel.labels import LabelStore

    port.init_nncontext(device="cpu")
    try:
        x, y = _data(16)
        p = Pipeline(ArraySource(x.astype(np.float64), y)).batch(8) \
            .prefetch(2)
        dev = list(p.device_batches(8, shuffle=True, seed=3))
        host = list(p.train_batches(8, shuffle=True, seed=3))
        assert len(dev) == len(host) == 2
        for (dx, dy, dm), (hx, hy, hm) in zip(dev, host):
            assert isinstance(dx, torch.Tensor) and dx.device.type == "cpu"
            assert dx.dtype == torch.float32  # float64 made float32
            assert dy.dtype == torch.int32 and dm.dtype == torch.float32
            np.testing.assert_array_equal(dx.numpy(), hx.astype(np.float32))
            np.testing.assert_array_equal(dy.numpy(), hy)
            np.testing.assert_array_equal(dm.numpy(), hm)
        tap = CaptureTap(CaptureConfig(directory=str(tmp_path), fraction=1.0,
                                       idle_poll_s=0.01), clock=lambda: 1.0)
        tap.enable("m")
        from concurrent.futures import Future

        for i in range(6):
            fut = Future()
            tap.offer("m", "1", x[i:i + 1], fut, trace=f"t{i}")
            fut.set_result(np.full((1, 2), float(i), np.float32))
        tap.flush()
        tap.rotate("m")
        tap.close()
        store = LabelStore(str(tmp_path), clock=lambda: 2.0)
        store.ingest("m", [{"trace_id": f"t{i}", "label": [float(-i)]}
                           for i in range(0, 6, 2)])
        store.rotate("m")
        store.close()
        cap = list(Pipeline.from_capture(str(tmp_path / "m")).batch(6)
                   .train_batches(shuffle=False))
        np.testing.assert_array_equal(cap[0][0], x[:6])
        np.testing.assert_array_equal(cap[0][1][:, 0], np.arange(6.0))
        lab = list(Pipeline.from_labeled_capture(
            str(tmp_path / "m"), store.labels_dir("m")).batch(3)
            .train_batches(shuffle=False))
        np.testing.assert_array_equal(lab[0][0], x[0:6:2])
        np.testing.assert_array_equal(lab[0][1][:, 0], [0.0, -2.0, -4.0])
    finally:
        port.stop_nncontext()
    _assert_no_pipeline_threads()


_DIM, _CLASSES, _N, _BATCH = 8, 3, 24, 8
F32_TOL = 1e-5  # the port's trajectory against the JAX package's


def _est_data():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(_N, _DIM)).astype(np.float32)
    y = rng.integers(0, _CLASSES, _N).astype(np.int32)
    return x, y


def _make_estimator(ckpt_dir=None, dropout=0.4, init=None):
    """A fresh process's estimator: new context, counters reset."""
    import analytics_zoo_tpu_torch as port
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.interop import load_jax_params
    from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts
    from analytics_zoo_tpu_torch.keras.engine.topology import Sequential
    from analytics_zoo_tpu_torch.keras.layers import Dense, Dropout
    from analytics_zoo_tpu_torch.keras.optimizers import Adam

    port.stop_nncontext()
    reset_name_counts()
    port.init_nncontext(device="cpu")
    layers = [Dense(8, activation="relu", input_shape=(_DIM,))]
    if dropout:
        layers.append(Dropout(dropout))
    model = Sequential(layers + [Dense(_CLASSES)])
    if init is not None:
        load_jax_params(model, init)
    est = Estimator(model, Adam(0.02))
    if ckpt_dir is not None:
        est.set_checkpoint(str(ckpt_dir), asynchronous=False, keep_last=5)
    return est


def _make_pipeline(identity=False, shuffle_seed=5):
    x, y = _est_data()
    p = Pipeline(ArraySource(x, y), seed=7)
    if not identity:
        p = p.map(_aug, num_workers=3).shuffle(16, seed=shuffle_seed)
    return p.batch(_BATCH).prefetch(3)


def _train(est, train_set, epochs=3, auto_resume=False):
    from analytics_zoo_tpu_torch.common.tree import tree_leaves
    from analytics_zoo_tpu_torch.engine.triggers import (
        MaxEpoch,
        SeveralIteration,
    )
    from analytics_zoo_tpu_torch.keras import objectives

    est.train(train_set,
              objectives.sparse_categorical_crossentropy_from_logits,
              end_trigger=MaxEpoch(epochs),
              checkpoint_trigger=SeveralIteration(2),
              batch_size=_BATCH, auto_resume=auto_resume)
    return [t.detach().numpy().copy() for t in tree_leaves(est.tstate.params)]


class _Boom(Exception):
    """Stands in for os._exit in in-process chaos tests."""


@pytest.fixture
def chaos_raise(monkeypatch):
    from analytics_zoo_tpu_torch.ft import chaos

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
    yield arm
    chaos.reset()


@pytest.fixture
def _port_cleanup():
    yield
    import analytics_zoo_tpu_torch as port
    from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts

    port.stop_nncontext()
    reset_name_counts()


def test_estimator_train_over_a_pipeline_raises_naming_a6(_port_cleanup):
    """``Estimator.train`` takes a pipeline: a no-shuffle-stage identity
    pipeline trains bitwise as the ``ArrayFeatureSet`` does (dropout
    included), and without dropout the trajectory is the JAX package's
    ``Estimator.train`` over its own pipeline from the same weights,
    within F32_TOL."""
    import jax

    from analytics_zoo_tpu.engine.estimator import Estimator as JEstimator
    from analytics_zoo_tpu.engine.triggers import MaxEpoch as JMaxEpoch
    from analytics_zoo_tpu.keras import layers as jlayers
    from analytics_zoo_tpu.keras import objectives as jobj
    from analytics_zoo_tpu.keras import optimizers as jopt
    from analytics_zoo_tpu.keras.engine import base as jbase
    from analytics_zoo_tpu.keras.engine import topology as jtopo
    from analytics_zoo_tpu_torch.common.tree import tree_leaves
    from analytics_zoo_tpu_torch.interop import load_jax_params

    x, y = _est_data()
    ref = _train(_make_estimator(), ArrayFeatureSet(x, y))
    got = _train(_make_estimator(), _make_pipeline(identity=True))
    assert len(ref) == len(got) == 4
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    _assert_no_pipeline_threads()

    jbase.reset_name_counts()
    jnet = jtopo.Sequential([jlayers.Dense(8, activation="relu",
                                           input_shape=(_DIM,)),
                             jlayers.Dense(_CLASSES)])
    jest = JEstimator(jnet, jopt.Adam(0.02))
    jest._ensure_state()
    init = jax.tree_util.tree_map(np.asarray, jest.tstate.params)
    jest.train(jax_pipeline.Pipeline(jax_sources.ArraySource(x, y), seed=7)
               .batch(_BATCH).prefetch(3),
               jobj.sparse_categorical_crossentropy_from_logits,
               end_trigger=JMaxEpoch(3), batch_size=_BATCH)
    final = jax.tree_util.tree_map(np.asarray, jest.tstate.params)
    got = _train(_make_estimator(dropout=0, init=init),
                 _make_pipeline(identity=True))
    # the JAX leaves in the port's order
    want = [t.numpy() for t in tree_leaves(load_jax_params(
        _make_estimator(dropout=0).model, final))]
    assert [a.shape for a in got] == [a.shape for a in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=F32_TOL)


def test_mid_epoch_kill_then_resume_reproduces_stream_bitwise(
        tmp_path, chaos_raise, _port_cleanup):
    """A shuffled, multi-worker pipeline killed mid-epoch at a commit
    point resumes (a) to the uninterrupted run's final params bitwise and
    (b) to a remaining batch stream bitwise the uninterrupted epoch's
    tail, from the stream position of the last committed checkpoint."""
    from analytics_zoo_tpu_torch.engine import checkpoint as ck

    ref_params = _train(_make_estimator(tmp_path / "ref"), _make_pipeline())
    kill_dir = tmp_path / "kill"
    chaos_raise("before_rename", skip=1)
    with pytest.raises(_Boom):
        _train(_make_estimator(kill_dir), _make_pipeline())
    chaos_raise.disarm()
    _assert_no_pipeline_threads()

    meta = ck.peek_metadata(ck.latest_checkpoint(str(kill_dir)))
    state = meta["pipeline"]
    assert state["position_batches"] == meta["epoch_step"] == 2  # mid-epoch
    assert state["epoch_seed"] == meta["epoch"]
    assert state["num_workers"] == 3 and state["shuffle_buffer"] == 16
    epoch_seed = state["epoch_seed"]
    full_epoch = list(_make_pipeline().train_batches(
        _BATCH, shuffle=True, seed=epoch_seed))
    resumed_tail = list(_make_pipeline().load_state_dict(state)
                        .train_batches(_BATCH, shuffle=True, seed=epoch_seed))
    _assert_streams_equal(resumed_tail,
                          full_epoch[state["position_batches"]:])

    resumed = _train(_make_estimator(kill_dir), _make_pipeline(),
                     auto_resume=True)
    assert len(resumed) == len(ref_params)
    for got, want in zip(resumed, ref_params):
        np.testing.assert_array_equal(got, want)
    _assert_no_pipeline_threads()


def test_resume_with_mismatched_pipeline_is_rejected(tmp_path, chaos_raise,
                                                     _port_cleanup):
    chaos_raise("before_commit", skip=1)
    with pytest.raises(_Boom):
        _train(_make_estimator(tmp_path), _make_pipeline())
    chaos_raise.disarm()
    with pytest.raises(ValueError, match="shuffle_seed"):
        _train(_make_estimator(tmp_path), _make_pipeline(shuffle_seed=99),
               auto_resume=True)
    _assert_no_pipeline_threads()


def test_device_batches_prefetch_and_metrics(_port_cleanup):
    import torch

    import analytics_zoo_tpu_torch as port
    from analytics_zoo_tpu_torch.common.observability import get_registry

    port.init_nncontext(device="cpu")
    x, y = _data(32)
    p = (Pipeline(ArraySource(x, y), seed=0).map(_aug, num_workers=2)
         .batch(8).prefetch(2))
    seen = 0
    for bx, by, mask in p.device_batches(8, shuffle=True, seed=1):
        assert isinstance(bx, torch.Tensor) and isinstance(mask,
                                                           torch.Tensor)
        assert bx.shape == (8, 4)
        seen += 1
    assert seen == 4
    text = get_registry().render()
    for fam in ("zoo_data_samples_total", "zoo_data_batches_total",
                "zoo_data_wait_seconds", "zoo_data_queue_depth",
                "zoo_data_samples_per_sec", "zoo_data_starvation_ratio"):
        assert fam in text, fam
    assert p.state_dict()["prefetch_high_water"] >= 1
    gen = p.device_batches(8, shuffle=True, seed=1)
    next(gen)
    assert _pipeline_threads()  # the prefetcher is running
    gen.close()
    _assert_no_pipeline_threads()


# ---------------------------------------------------------------------------
# prefetch, metrics, spans, teardown
# ---------------------------------------------------------------------------


def test_host_prefetch_and_metrics():
    from analytics_zoo_tpu_torch.common.observability import get_registry

    x, y = _data(32)
    p = (Pipeline(ArraySource(x, y), seed=0).map(_aug, num_workers=2)
         .batch(8).prefetch(2))
    seen = 0
    for bx, by, mask in p.host_batches(8):
        assert isinstance(bx, np.ndarray) and bx.shape == (8, 4)
        seen += 1
    assert seen == 4
    text = get_registry().render()
    for fam in ("zoo_data_samples_total", "zoo_data_batches_total",
                "zoo_data_wait_seconds", "zoo_data_queue_depth",
                "zoo_data_samples_per_sec", "zoo_data_starvation_ratio"):
        assert fam in text, fam
    assert p.state_dict()["prefetch_high_water"] >= 1
    _assert_no_pipeline_threads()


def test_data_epoch_span_recorded():
    from analytics_zoo_tpu_torch.common import observability as obs

    tracer = obs.get_tracer()
    tracer.enable()
    try:
        x, y = _data(12)
        list(Pipeline(ArraySource(x, y)).map(lambda r: r).batch(4)
             .train_batches(4, shuffle=True, seed=0))
        spans = [s for s in tracer.spans() if s.name == "data.epoch"]
        assert spans, [s.name for s in tracer.spans()]
        attrs = spans[-1].attrs
        assert attrs["batch"] == 4 and attrs["samples"] == 12
    finally:
        tracer.disable()


def test_worker_pool_clean_teardown_all_paths():
    """Worker pools and prefetch threads are torn down on (1) full
    consumption, (2) explicit close mid-epoch, and (3) iterator GC
    without close."""
    x, y = _data(40)

    def build():
        return (Pipeline(ArraySource(x, y), seed=0)
                .map(_aug, num_workers=4).batch(8).prefetch(2))

    list(build().train_batches(8, shuffle=True, seed=0))
    _assert_no_pipeline_threads()

    gen = build().host_batches(8)
    next(gen)
    assert _pipeline_threads()  # the prefetcher is running
    gen.close()
    _assert_no_pipeline_threads()

    it = build().train_batches(8, shuffle=True, seed=0)
    next(it)
    del it
    gc.collect()
    _assert_no_pipeline_threads()


# ---------------------------------------------------------------------------
# sources, each against the JAX package's
# ---------------------------------------------------------------------------


@pytest.fixture
def image_dir(tmp_path):
    import cv2

    for cls in ("cats", "dogs"):
        d = tmp_path / cls
        d.mkdir()
        for i in range(6):
            img = np.random.default_rng(len(cls) * 100 + i).integers(
                0, 255, size=(40, 48, 3)).astype(np.uint8)
            cv2.imwrite(str(d / f"{cls}_{i}.png"), img)
    return str(tmp_path)


def _image_chain(pkg):
    import importlib

    m = importlib.import_module(f"{pkg}.data.image_set")
    return (m.ImageRead() | m.ImageResize(36, 36) | m.ImageRandomCrop(32, 32)
            | m.ImageRandomFlip() | m.ImageBrightness(-16, 16)
            | m.ImageChannelNormalize(128.0, 128.0, 128.0, 64.0, 64.0, 64.0)
            | m.ImageSetToSample())


def test_image_random_transforms_worker_invariant_and_jax_equal(image_dir):
    """ImageRandom* draw from the per-sample RNG the pipeline injects: the
    1-worker and 4-worker streams are bitwise equal, and equal to the JAX
    package's."""

    def run(P, pkg, workers):
        p = (P.from_files(image_dir, with_label=True, seed=3)
             .map(_image_chain(pkg), num_workers=workers).batch(4))
        return list(p.train_batches(4, shuffle=True, seed=1))

    port1 = run(Pipeline, "analytics_zoo_tpu_torch", 1)
    _assert_streams_equal(port1, run(Pipeline, "analytics_zoo_tpu_torch", 4))
    _assert_streams_equal(port1, run(jax_pipeline.Pipeline,
                                     "analytics_zoo_tpu", 4))


def test_file_source_directory_labels(image_dir):
    src = FileSource(image_dir, with_label=True)
    ref = jax_sources.FileSource(image_dir, with_label=True)
    assert len(src) == len(ref) == 12
    assert src.label_map == ref.label_map == {"cats": 0, "dogs": 1}
    for i in range(12):
        assert dict(src.fetch(i)) == dict(ref.fetch(i))
    assert src.fetch(0)["uri"].endswith(".png") and src.fetch(0)["label"] == 0
    with pytest.raises(ValueError):
        FileSource(os.path.join(image_dir, "nothing-here"))


def test_image_set_source_runs_chain_on_workers(image_dir):
    from analytics_zoo_tpu.data import image_set as jis
    from analytics_zoo_tpu_torch.data import image_set as pis

    def iset(m):
        s = m.ImageSet.read(image_dir, with_label=True)
        s.transform(m.ImageResize(16, 16)) \
            .transform(m.ImageChannelNormalize(128.0, 128.0, 128.0)) \
            .transform(m.ImageSetToSample())
        return s

    ps = iset(pis)
    assert isinstance(Pipeline.from_image_set(ps)._source, ImageSetSource)
    batches = list(Pipeline.from_image_set(ps).map(
        lambda r: r, num_workers=3).batch(6).train_batches(6, shuffle=False))
    assert batches[0][0].shape == (6, 16, 16, 3)
    # the materialized FeatureSet path, same dataset order
    ref = list(Pipeline.from_feature_set(ps.to_feature_set()).batch(6)
               .train_batches(6, shuffle=False))
    _assert_streams_equal(ref, batches)
    jax_batches = list(jax_pipeline.Pipeline.from_image_set(iset(jis))
                       .batch(6).train_batches(6, shuffle=False))
    _assert_streams_equal(batches, jax_batches)


def test_text_set_source():
    from analytics_zoo_tpu.data.text_set import TextSet as JaxTextSet
    from analytics_zoo_tpu_torch.data.text_set import TextSet

    def ts(cls):
        t = cls.from_texts(
            ["the cat sat", "dogs chase cats", "tpu chips are fast"],
            labels=[0, 0, 1])
        t.tokenize().normalize().word2idx().shape_sequence(5)
        return t

    p = Pipeline.from_text_set(ts(TextSet)).batch(2)
    assert isinstance(p._source, TextSetSource)
    batches = list(p.train_batches(2, shuffle=False))
    assert batches[0][0].shape == (2, 5)
    labels = np.concatenate([b[1][b[2].astype(bool)] for b in batches])
    assert labels.tolist() == [0, 0, 1]
    ref = list(jax_pipeline.Pipeline.from_text_set(ts(JaxTextSet)).batch(2)
               .train_batches(2, shuffle=False))
    _assert_streams_equal(batches, ref)


def test_feature_set_source_matches_jax():
    from analytics_zoo_tpu.data.feature_set import (
        ArrayFeatureSet as JaxArrayFeatureSet,
    )

    x, y = _data(11)
    src = FeatureSetSource(ArrayFeatureSet(x, y))
    ref = jax_sources.FeatureSetSource(JaxArrayFeatureSet(x, y))
    assert len(src) == len(ref) == 11
    for i in range(11):
        (a, b), (c, d) = src.fetch(i), ref.fetch(i)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_npy_rows_source_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    for i, n in enumerate((5, 0, 7)):
        p = tmp_path / f"rows_{i}.npy"
        np.save(p, rng.normal(size=(n, 3)).astype(np.float32))
        paths.append(str(p))
    src = NpyRowsSource(paths[::-1])  # sorted path order, whatever given
    ref = jax_sources.NpyRowsSource(paths)
    assert len(src) == len(ref) == 12
    for i in range(12):
        a, _ = src.fetch(i)
        b, _ = ref.fetch(i)
        assert a.tobytes() == b.tobytes()
    with pytest.raises(ValueError):
        NpyRowsSource([])
    np.save(tmp_path / "bad.npy", np.zeros((2, 4), np.float32))
    with pytest.raises(ValueError, match="disagree"):
        NpyRowsSource(paths + [str(tmp_path / "bad.npy")])
