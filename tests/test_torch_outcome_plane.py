"""The port's outcome plane (analytics_zoo_tpu_torch.flywheel.labels,
.drift) held to the JAX package's.

The cases of tests/test_outcome_plane.py run on the port: label ingestion
through the atomic shard protocol, the watermark join of delayed,
shuffled and duplicated outcomes onto capture, the outcome-mode retrain
with its durable cycle plan, the drift sketches, the rollout ladder's
drift gate, the HTTP outcome surface, the closed outcome loop both ways,
and the outcome-mode kill and bitwise resume in a subprocess
(tests/_torch_flywheel_worker.py). Beside them, the two packages on the
same inputs: a label directory written by either joins bitwise in the
other, the JAX inspector reads the port's label stores, and the drift
scores (PSI, JS, the sketches' centroids) equal the JAX package's
exactly (the module is the same numpy code).
"""

import json
import os
import shutil
import subprocess
import sys
import time
import urllib.error
import urllib.request
import zlib
from concurrent.futures import Future

import numpy as np
import pytest

import analytics_zoo_tpu_torch as port

from analytics_zoo_tpu_torch.batch import writers
from analytics_zoo_tpu_torch.flywheel import (
    CaptureConfig,
    CaptureTap,
    FlywheelController,
    FlywheelTrainer,
    RetrainConfig,
)
from analytics_zoo_tpu_torch.flywheel.capture import is_quarantined
from analytics_zoo_tpu_torch.flywheel.drift import (
    DriftDetector,
    PredictionTracker,
    StreamingHistogram,
    compare,
)
from analytics_zoo_tpu_torch.flywheel.labels import (
    LabeledSource,
    LabelJoiner,
    LabelShardWriter,
    LabelStore,
)
from analytics_zoo_tpu_torch.ft import atomic, chaos
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_flywheel_worker.py")


class _Boom(Exception):
    """Stands in for os._exit in in-process chaos tests."""


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


@pytest.fixture(autouse=True)
def _port_context():
    port.init_nncontext(device="cpu")
    reset_name_counts()
    yield
    chaos.reset()
    port.stop_nncontext()
    reset_name_counts()


def _capture_segments(tmp_path, counts=(10,), dim=4, clock=1700000000.0):
    """Committed capture segments with deterministic rows and traces
    t0000, t0001, ... (fixed clock — labels control the watermark)."""
    tap = CaptureTap(CaptureConfig(directory=str(tmp_path), fraction=1.0,
                                   rows_per_shard=4, idle_poll_s=0.01),
                     clock=lambda: clock)
    tap.enable("m")
    segs, start = [], 0
    for n in counts:
        for i in range(start, start + n):
            fut = Future()
            x = (np.arange(dim, dtype=np.float32) + i)[None, :]
            tap.offer("m", "1", x, fut, trace=f"t{i:04d}")
            fut.set_result(np.full((1, 2), float(i), np.float32))
        tap.flush()
        segs.append(tap.rotate("m"))
        start += n
    tap.close()
    return segs


def _records(indices, ts0=1700000100.0, shift=0.0):
    return [{"trace_id": f"t{i:04d}",
             "label": [float(i) * 0.5 + shift, float(i) * -0.25 + shift],
             "ts": ts0 + i} for i in indices]


# ---------------------------------------------------------------------------
# label store: ingestion through the atomic shard protocol
# ---------------------------------------------------------------------------


def test_label_store_ingest_commit_and_read_back(tmp_path):
    store = LabelStore(str(tmp_path), rows_per_shard=4)
    got = store.ingest("m", _records(range(10)))
    assert got == {"accepted": 10}
    seg = store.rotate("m")
    store.close()
    assert seg is not None and writers.job_complete(seg)
    doc = writers.read_manifest(seg)
    assert doc["job"]["kind"] == "labels" and doc["job"]["model"] == "m"
    rows = list(writers.iter_output_rows(seg))
    assert len(rows) == 10
    assert rows[0] == {"t": "t0000", "y": [0.0, -0.0], "ts": 1700000100.0}


def test_label_store_rejects_batch_whole_on_any_invalid_record(tmp_path):
    store = LabelStore(str(tmp_path))
    bad_batches = [
        [{"trace_id": "t1", "label": 1.0}, {"trace_id": "", "label": 2.0}],
        [{"trace_id": "t1"}],                       # no label
        [{"trace_id": "t1", "label": object()}],    # unserializable
        [{"trace_id": "t1", "label": 1.0, "ts": "soon"}],
        ["not-a-dict"],
        [],
    ]
    for batch in bad_batches:
        with pytest.raises(ValueError):
            store.ingest("m", batch)
    # nothing was buffered: no writer, no segment, rotate is a no-op
    assert store.rotate("m") is None
    store.close()
    assert not os.path.isdir(os.path.join(str(tmp_path), "m", "labels"))


def test_label_store_ts_defaults_to_clock(tmp_path):
    store = LabelStore(str(tmp_path), clock=lambda: 1234.5)
    store.ingest("m", [{"trace_id": "t1", "label": 1.0}])
    seg = store.rotate("m")
    store.close()
    (row,) = writers.iter_output_rows(seg)
    assert row["ts"] == 1234.5


def test_label_store_resumes_open_tail_segment_after_crash(tmp_path):
    store = LabelStore(str(tmp_path), rows_per_shard=4)
    store.ingest("m", _records(range(6)))
    store.close(finalize=False)  # crash: partial shards durable, no COMMIT
    ldir = os.path.join(str(tmp_path), "m", "labels")
    assert LabelJoiner(os.path.join(str(tmp_path), "m"),
                       ldir).label_segments() == []
    store2 = LabelStore(str(tmp_path), rows_per_shard=4)
    store2.ingest("m", _records(range(6, 10)))
    seg = store2.rotate("m")
    store2.close()
    # same segment_00000 resumed — not a parallel sibling
    assert os.path.basename(seg) == "segment_00000"
    rows = list(writers.iter_output_rows(seg))
    assert [r["t"] for r in rows] == [f"t{i:04d}" for i in range(10)]


def test_label_writer_torn_chaos_point(tmp_path, chaos_raise):
    """label_writer_torn: a shard commit dies mid-write; the debris is
    invisible and a restarted writer resumes at the committed offset."""
    d = str(tmp_path / "seg")
    chaos_raise("label_writer_torn", skip=1)  # second shard commit dies
    w = LabelShardWriter(d, rows_per_shard=2)
    w.append([{"t": "a", "y": 0, "ts": 1.0}, {"t": "b", "y": 1, "ts": 2.0}])
    with pytest.raises(_Boom):
        w.append([{"t": "c", "y": 2, "ts": 3.0},
                  {"t": "d", "y": 3, "ts": 4.0}])
    chaos.reset()
    doc = writers.read_manifest(d)
    assert [s["rows"] for s in doc["shards"]] == [2]
    w2 = LabelShardWriter(d, rows_per_shard=2)
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]
    w2.append([{"t": "c", "y": 2, "ts": 3.0},
               {"t": "d", "y": 3, "ts": 4.0}])
    w2.finalize()
    assert [r["t"] for r in writers.iter_output_rows(d)] \
        == ["a", "b", "c", "d"]


# ---------------------------------------------------------------------------
# joiner: watermark, duplicates, orphans
# ---------------------------------------------------------------------------


def test_joiner_watermark_and_grace_close_the_window(tmp_path):
    _capture_segments(tmp_path, counts=(6,), clock=1700000000.0)
    cap_dir = str(tmp_path / "m")
    store = LabelStore(str(tmp_path))
    joiner = LabelJoiner(cap_dir, store.labels_dir("m"), grace_s=5.0)
    (seg,) = joiner.capture_segments()
    assert joiner.watermark() is None
    assert not joiner.labels_closed(seg)
    # labels behind the capture window: still open
    store.ingest("m", [{"trace_id": "t0000", "label": 0.0,
                        "ts": 1699999999.0}])
    store.rotate("m")
    assert not joiner.labels_closed(seg, joiner.label_segments())
    # watermark within grace of the max capture ts: still open
    store.ingest("m", [{"trace_id": "t0001", "label": 1.0,
                        "ts": 1700000004.0}])
    store.rotate("m")
    assert not joiner.labels_closed(seg, joiner.label_segments())
    # watermark past max ts + grace: closed
    store.ingest("m", [{"trace_id": "t0002", "label": 2.0,
                        "ts": 1700000005.0}])
    store.rotate("m")
    store.close()
    joiner2 = store.joiner("m", grace_s=5.0)
    assert joiner2.labels_closed(seg)
    assert joiner2.watermark() == 1700000005.0


def test_joiner_duplicates_last_write_wins_orphans_counted(tmp_path):
    _capture_segments(tmp_path, counts=(8,))
    store = LabelStore(str(tmp_path), rows_per_shard=3)
    store.ingest("m", _records(range(8), ts0=1700000100.0))
    # duplicate for t0003 with a LATER ts wins; an EARLIER one loses
    store.ingest("m", [
        {"trace_id": "t0003", "label": [9.0, 9.0], "ts": 1700000600.0},
        {"trace_id": "t0004", "label": [8.0, 8.0], "ts": 1699000000.0},
        {"trace_id": "zzzz", "label": [7.0], "ts": 1700000601.0},  # orphan
    ])
    store.rotate("m")
    stats = store.describe("m")
    store.close()
    assert stats["labels_total"] == 11
    assert stats["labels_unique"] == 9
    assert stats["duplicates"] == 2
    assert stats["matched_rows"] == 8 and stats["captured_rows"] == 8
    assert stats["completeness"] == 1.0
    assert stats["unmatched_labels"] == 1  # zzzz
    assert stats["watermark"] == 1700000601.0
    assert stats["open_segments"] == [] and stats["join_lag_s"] == 0.0
    src = LabelJoiner(str(tmp_path / "m"),
                      store.labels_dir("m")).join()
    ys = {i: src.fetch(i)[1] for i in range(len(src))}
    np.testing.assert_array_equal(ys[3], [9.0, 9.0])        # later ts won
    np.testing.assert_array_equal(ys[4], [2.0, -1.0])       # earlier lost


def test_joiner_ts_ties_resolved_by_label_value_not_order(tmp_path):
    """Two labels for one trace with the SAME ts: the winner is the
    larger canonical JSON — a function of the record set, not of which
    arrived first."""
    _capture_segments(tmp_path, counts=(1,))
    for order in ([0, 1], [1, 0]):
        ldir = str(tmp_path / f"labels{order[0]}")
        recs = [{"trace_id": "t0000", "label": [1.0], "ts": 50.0},
                {"trace_id": "t0000", "label": [2.0], "ts": 50.0}]
        w = LabelShardWriter(ldir, rows_per_shard=8)
        w.append([{"t": r["trace_id"], "y": r["label"], "ts": r["ts"]}
                  for r in (recs[i] for i in order)])
        w.finalize()
        src = LabeledSource([str(tmp_path / "m" / "segment_00000")],
                            label_dirs=ldir)
        np.testing.assert_array_equal(src.fetch(0)[1], [2.0])


# ---------------------------------------------------------------------------
# out-of-order property: shuffled ingest is bitwise identical
# ---------------------------------------------------------------------------


def _joined_bytes(src) -> bytes:
    out = []
    for i in range(len(src)):
        x, y = src.fetch(i)
        out.append(x.tobytes())
        out.append(np.asarray(y).tobytes())
    return b"".join(out)


@pytest.mark.parametrize("perm_seed", [3, 11, 42])
def test_shuffled_label_ingest_joins_bitwise_identical(tmp_path, perm_seed):
    """Property: ingesting the SAME outcome records in any order, any
    batch split, across any shard/segment boundaries yields a byte-for-
    byte identical joined training stream — including conflicting
    duplicates, whose winner is order-free."""
    _capture_segments(tmp_path / "cap", counts=(9, 7))
    cap_dir = str(tmp_path / "cap" / "m")
    records = _records(range(16))
    # conflicting duplicates + an orphan, to make ordering matter if
    # anything were order-sensitive
    records += [
        {"trace_id": "t0002", "label": [100.0, 100.0], "ts": 1700000200.0},
        {"trace_id": "t0002", "label": [-5.0, -5.0], "ts": 1700000050.0},
        {"trace_id": "t0007", "label": [1.0], "ts": 1700000107.0},  # tie ts
        {"trace_id": "nope", "label": [0.0], "ts": 1700000300.0},
    ]

    def build(root, recs, batch):
        store = LabelStore(str(root), rows_per_shard=3)
        for i in range(0, len(recs), batch):
            store.ingest("m", recs[i:i + batch])
            if (i // batch) % 2 == 1:
                store.rotate("m")  # segment boundaries mid-stream
        store.rotate("m")
        store.close()
        ldir = os.path.join(str(root), "m", "labels")
        return LabeledSource(
            [os.path.join(cap_dir, "segment_00000"),
             os.path.join(cap_dir, "segment_00001")], label_dirs=ldir)

    in_order = build(tmp_path / "a", records, batch=5)
    shuffled = list(records)
    np.random.default_rng(perm_seed).shuffle(shuffled)
    out_of_order = build(tmp_path / "b", shuffled, batch=7)
    assert len(in_order) == len(out_of_order) == 16
    assert _joined_bytes(in_order) == _joined_bytes(out_of_order)


def test_pipeline_from_labeled_capture_deterministic(tmp_path):
    from analytics_zoo_tpu_torch.data.pipeline import Pipeline

    _capture_segments(tmp_path, counts=(12,))
    store = LabelStore(str(tmp_path), rows_per_shard=4)
    store.ingest("m", _records(range(12)))
    store.rotate("m")
    store.close()
    cap = str(tmp_path / "m")
    ldir = store.labels_dir("m")
    a = Pipeline.from_labeled_capture(cap, ldir, seed=3).batch(4)
    b = Pipeline.from_labeled_capture(cap, ldir, seed=3).batch(4)
    ba = list(a.train_batches(seed=0))
    bb = list(b.train_batches(seed=0))
    assert len(ba) == 3
    for (xa, ya, ma), (xb, yb, mb) in zip(ba, bb):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
        np.testing.assert_array_equal(ma, mb)
    # targets are the OUTCOMES, not the captured predictions
    ys = np.sort(np.concatenate([y[:, 0] for _, y, _ in ba]))
    np.testing.assert_allclose(ys, [i * 0.5 for i in range(12)])


# ---------------------------------------------------------------------------
# trainer: outcome mode, distill fallback, durable cycle plan
# ---------------------------------------------------------------------------


def _seed_incumbent(ckpt_dir, in_dim=4, out_dim=2):
    from analytics_zoo_tpu_torch.data.feature_set import ArrayFeatureSet
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.keras import objectives
    from analytics_zoo_tpu_torch.keras.engine.topology import Sequential
    from analytics_zoo_tpu_torch.keras.layers import Dense
    from analytics_zoo_tpu_torch.keras.optimizers import SGD

    def build():
        return Estimator(
            Sequential([Dense(out_dim, input_shape=(in_dim,))]), SGD(0.05))

    rng = np.random.default_rng(0)
    est = build()
    est.set_checkpoint(str(ckpt_dir), keep_last=8, asynchronous=False)
    est.train(ArrayFeatureSet(
        rng.normal(size=(16, in_dim)).astype(np.float32),
        rng.normal(size=(16, out_dim)).astype(np.float32)),
        objectives.mean_squared_error, batch_size=8)
    return build, objectives.mean_squared_error


def _outcome_trainer(tmp_path, build, crit, **kw):
    base = dict(capture_dir=str(tmp_path / "m"),
                checkpoint_dir=str(tmp_path / "ckpts"),
                batch_size=8, checkpoint_every=2, keep_last=8, min_rows=4,
                labels_dir=str(tmp_path / "m" / "labels"))
    base.update(kw)
    return FlywheelTrainer(build, crit, RetrainConfig(**base))


def test_trainer_outcome_mode_when_labels_closed(tmp_path):
    build, crit = _seed_incumbent(tmp_path / "ckpts")
    _capture_segments(tmp_path, counts=(10,))
    store = LabelStore(str(tmp_path))
    store.ingest("m", _records(range(10)))  # ts > capture ts: closed
    store.rotate("m")
    store.close()
    trainer = _outcome_trainer(tmp_path, build, crit)
    step = trainer.run_once()
    assert step is not None and trainer.last_mode == "outcome"
    # the mode is durable state-checkpoint metadata (kill -> resume and
    # the ops plane read HOW the candidate was trained, not just on what)
    states = atomic.committed_checkpoints(trainer._state_dir,
                                          prefix="state")
    _, meta = atomic.read_checkpoint(states[-1][1])
    assert meta.get("mode") == "outcome"
    assert not os.path.exists(trainer._plan_path())  # plan cleared


def test_trainer_falls_back_to_distill_when_labels_open(tmp_path):
    build, crit = _seed_incumbent(tmp_path / "ckpts")
    _capture_segments(tmp_path, counts=(10,), clock=1700000000.0)
    store = LabelStore(str(tmp_path))
    # labels exist but the watermark is BEHIND the capture window
    store.ingest("m", _records(range(10), ts0=1600000000.0))
    store.rotate("m")
    store.close()
    trainer = _outcome_trainer(tmp_path, build, crit)
    step = trainer.run_once()
    assert step is not None and trainer.last_mode == "distill"


def test_trainer_distill_when_joined_rows_below_min(tmp_path):
    build, crit = _seed_incumbent(tmp_path / "ckpts")
    _capture_segments(tmp_path, counts=(10,))
    store = LabelStore(str(tmp_path))
    # watermark closes the window but only 2 rows have outcomes
    store.ingest("m", _records([0, 1]) + [
        {"trace_id": "way-late", "label": 0.0, "ts": 1800000000.0}])
    store.rotate("m")
    store.close()
    trainer = _outcome_trainer(tmp_path, build, crit, min_rows=4)
    step = trainer.run_once()
    assert step is not None and trainer.last_mode == "distill"


def test_trainer_no_labels_dir_keeps_legacy_shape(tmp_path):
    build, crit = _seed_incumbent(tmp_path / "ckpts")
    _capture_segments(tmp_path, counts=(10,))
    trainer = FlywheelTrainer(build, crit, RetrainConfig(
        capture_dir=str(tmp_path / "m"),
        checkpoint_dir=str(tmp_path / "ckpts"),
        batch_size=8, checkpoint_every=2, min_rows=4))
    step = trainer.run_once()
    assert step is not None and trainer.last_mode is None
    states = atomic.committed_checkpoints(trainer._state_dir,
                                          prefix="state")
    _, meta = atomic.read_checkpoint(states[-1][1])
    assert "mode" not in meta


def test_trainer_cycle_plan_pins_mode_across_kill(tmp_path, chaos_raise):
    """The plan is decided ONCE, durably, before training: a cycle that
    chose distill, died, and resumed after labels closed must still run
    distill — the resumed cycle is the same cycle, bit for bit."""
    build, crit = _seed_incumbent(tmp_path / "ckpts")
    _capture_segments(tmp_path, counts=(16,), clock=1700000000.0)
    store = LabelStore(str(tmp_path))
    store.ingest("m", _records(range(16), ts0=1600000000.0))  # open
    store.rotate("m")
    trainer = _outcome_trainer(tmp_path, build, crit)
    chaos_raise("flywheel_mid_retrain_kill", skip=0)
    with pytest.raises(_Boom):
        trainer.run_once()
    chaos.reset()
    for var in ("AZOO_FT_CHAOS", "AZOO_FT_CHAOS_SKIP"):
        os.environ.pop(var, None)
    plan_path = trainer._plan_path()
    assert os.path.exists(plan_path)
    with open(plan_path) as f:
        assert json.load(f)["mode"] == "distill"
    # labels close between the crash and the resume...
    store.ingest("m", [{"trace_id": "t0000", "label": [0.0, 0.0],
                        "ts": 1800000000.0}])
    store.rotate("m")
    store.close()
    trainer2 = _outcome_trainer(tmp_path, build, crit)
    step = trainer2.run_once()
    # ...but the pinned plan still runs the cycle it started
    assert step is not None and trainer2.last_mode == "distill"
    assert not os.path.exists(plan_path)
    # the NEXT cycle sees closed labels and switches to outcome mode
    # (the fresh window re-uses traces t0000..t0007; its newest labels
    # win the per-trace tiebreak, so the join is shape-consistent)
    _capture_segments(tmp_path, counts=(8,))
    store3 = LabelStore(str(tmp_path))
    store3.ingest("m", _records(range(8), ts0=1800000100.0))
    store3.rotate("m")
    store3.close()
    step2 = trainer2.run_once()
    assert step2 is not None and trainer2.last_mode == "outcome"


# ---------------------------------------------------------------------------
# drift: sketches, PSI, JS
# ---------------------------------------------------------------------------


def test_streaming_histogram_bounded_memory_and_compare():
    rng = np.random.default_rng(5)
    a, b, c = (StreamingHistogram(max_bins=32) for _ in range(3))
    a.extend(rng.normal(0.0, 1.0, size=4000))
    b.extend(rng.normal(0.0, 1.0, size=4000))
    c.extend(rng.normal(3.0, 1.0, size=4000))
    for h in (a, b, c):
        assert h.snapshot()["bins"] <= 32 and h.count == 4000
    same = compare(a, b)
    far = compare(a, c)
    assert same["js"] < 0.05 and same["psi"] < 0.5
    assert far["js"] > 0.5 and far["psi"] > 1.0
    assert compare(a, StreamingHistogram()) is None  # empty side
    with pytest.raises(ValueError):
        StreamingHistogram(max_bins=1)


def test_compare_float_noise_span_reads_identical():
    """Two point masses a float-rounding epsilon apart are the SAME
    distribution: the pooled span collapses to one shared (mid-bin
    centered) bin and reads JS 0, instead of splitting into opposite
    end bins and reading JS ~1. The guard is relative to magnitude, so
    genuinely separated constants still read diverged. Regression: a
    retrained candidate whose loss was already ~0 differs from the
    incumbent only by training-arithmetic noise and must sail through
    the drift gate."""
    a, b = StreamingHistogram(), StreamingHistogram()
    for _ in range(20):
        a.add(0.3147331178188324)   # incumbent: numpy serving forward
        b.add(0.3147331215441227)   # candidate: the training forward
    noise = compare(a, b)
    assert noise["js"] == 0.0 and noise["psi"] == 0.0
    c, d = StreamingHistogram(), StreamingHistogram()
    for _ in range(20):
        c.add(1.0)
        d.add(1.001)                # a real (if small) separation
    assert compare(c, d)["js"] > 0.5


def test_prediction_tracker_js_gate_substrate():
    tr = PredictionTracker()
    rng = np.random.default_rng(9)
    for v in rng.normal(0.0, 1.0, size=100):
        tr.observe("m", "1", np.full((1, 2), v, np.float32))
    for v in rng.normal(0.0, 1.0, size=10):
        tr.observe("m", "2", np.full((1, 2), v, np.float32))
    assert tr.js("m", "1", "2", min_count=30) is None  # canary too thin
    for v in rng.normal(6.0, 1.0, size=90):
        tr.observe("m", "2", np.full((1, 2), v, np.float32))
    js = tr.js("m", "1", "2", min_count=30)
    assert js is not None and js > 0.5
    assert set(tr.counts("m")) == {"1", "2"}
    assert tr.describe("m")["1"]["count"] == 100
    tr.reset("m", "2")
    assert tr.js("m", "1", "2") is None


def test_drift_detector_per_feature_psi():
    det = DriftDetector("m", max_features=4)
    rng = np.random.default_rng(2)
    ref = rng.normal(0.0, 1.0, size=(1500, 4)).astype(np.float32)
    det.set_reference(list(ref))
    assert det.scores() is None  # no live window yet
    for row in rng.normal(0.0, 1.0, size=(1500, 4)):
        det.observe(row.astype(np.float32))
    stable = det.scores(min_count=50)
    assert stable is not None and all(v < 0.6 for v in stable.values())
    det.set_reference(list(ref))  # re-pin resets the live window
    for row in rng.normal(4.0, 1.0, size=(1500, 4)):
        det.observe(row.astype(np.float32))
    drifted = det.scores(min_count=50)
    assert drifted is not None
    assert all(v > 1.0 for v in drifted.values()), drifted
    assert min(drifted.values()) > max(stable.values())


# ---------------------------------------------------------------------------
# rollout drift gate
# ---------------------------------------------------------------------------


def test_drift_gate_config_validation():
    from analytics_zoo_tpu_torch.serving.rollout import DriftGateConfig

    DriftGateConfig(max_prediction_js=0.25, min_count=30)
    for bad in (0.0, -0.1, 1.5):
        with pytest.raises(ValueError):
            DriftGateConfig(max_prediction_js=bad)
    with pytest.raises(ValueError):
        DriftGateConfig(min_count=0)


def _two_version_engine(drift_gates, second_model, tracker=None):
    from analytics_zoo_tpu_torch.serving import (
        BatcherConfig, RolloutConfig, ServingEngine,
    )

    class Doubler:
        def do_predict(self, x):
            return np.asarray(x, np.float32) * 2.0

    engine = ServingEngine(rollout=RolloutConfig(
        ladder=(0.5, 1.0), min_requests=4, auto_evaluate=False,
        drift_gates=drift_gates))
    if tracker is not None:
        engine.set_drift(tracker)
    cfg = BatcherConfig(max_batch_size=8, max_wait_ms=1.0)
    x = np.ones((1, 3), np.float32)
    engine.register("m", Doubler(), x, config=cfg, version="1")
    for _ in range(40):
        engine.predict("m", x)
    engine.register("m", second_model, x, config=cfg, version="2")
    return engine, x


def _drive_rollout(engine, x, max_ticks=300):
    rc = engine.rollout_controller()
    for _ in range(max_ticks):
        for _ in range(8):
            try:
                engine.predict("m", x)
            except Exception:  # noqa: BLE001 — canary-routed request
                pass
        time.sleep(0.01)  # let done-callbacks land in the windows
        rc.tick()
        desc = rc.describe("m")
        if desc is not None and desc.get("done"):
            return desc
    raise AssertionError(f"rollout never resolved: {rc.describe('m')}")


def test_drift_gate_rolls_back_diverged_canary():
    from analytics_zoo_tpu_torch.serving.rollout import DriftGateConfig

    class Shifted:
        def do_predict(self, x):
            return np.asarray(x, np.float32) * 2.0 + 50.0

    engine, x = _two_version_engine(
        DriftGateConfig(max_prediction_js=0.25, min_count=4),
        Shifted(), tracker=PredictionTracker())
    try:
        desc = _drive_rollout(engine, x)
        assert desc["outcome"] == "rolled_back"
        assert desc["reason"] == "drift"
        assert engine.describe_model("m")["latest"] == "1"
        assert engine.metrics.rollbacks("m", "drift").value >= 1
        assert "zoo_drift_prediction_js" in engine.metrics_text()
    finally:
        engine.shutdown()


def test_drift_gate_passes_identical_canary():
    from analytics_zoo_tpu_torch.serving.rollout import DriftGateConfig

    class Same:
        def do_predict(self, x):
            return np.asarray(x, np.float32) * 2.0

    engine, x = _two_version_engine(
        DriftGateConfig(max_prediction_js=0.25, min_count=4),
        Same(), tracker=PredictionTracker())
    try:
        desc = _drive_rollout(engine, x)
        assert desc["outcome"] == "promoted", desc
        assert engine.describe_model("m")["latest"] == "2"
    finally:
        engine.shutdown()


def test_drift_gate_ignores_stale_sketch_of_reminted_version():
    """A rolled-back candidate's version string can recur (its
    checkpoints are deleted and the next retrain can re-reach the same
    step). The dead model's sketch must not judge the new one:
    register() resets the model's sketches when a canary starts, so the
    gate sees only the rollout window."""
    from analytics_zoo_tpu_torch.serving.rollout import DriftGateConfig

    class Same:
        def do_predict(self, x):
            return np.asarray(x, np.float32) * 2.0

    poisoned = PredictionTracker()
    for _ in range(50):
        poisoned.observe("m", "2", np.full((1, 3), 1e3, np.float32))
    engine, x = _two_version_engine(
        DriftGateConfig(max_prediction_js=0.25, min_count=4),
        Same(), tracker=poisoned)
    try:
        desc = _drive_rollout(engine, x)
        assert desc["outcome"] == "promoted", desc
        assert engine.describe_model("m")["latest"] == "2"
    finally:
        engine.shutdown()


def test_drift_gate_inert_without_tracker():
    """drift_gates configured but no tracker attached: scores are None
    and the gate never blocks — the plane is strictly opt-in."""
    from analytics_zoo_tpu_torch.serving.rollout import DriftGateConfig

    class Shifted:
        def do_predict(self, x):
            return np.asarray(x, np.float32) * 2.0 + 50.0

    engine, x = _two_version_engine(
        DriftGateConfig(max_prediction_js=0.25, min_count=4),
        Shifted(), tracker=None)
    try:
        assert engine.drift_scores("m", "2", "1") is None
        desc = _drive_rollout(engine, x)
        assert desc["outcome"] == "promoted"
    finally:
        engine.shutdown()


# ---------------------------------------------------------------------------
# HTTP surface: POST :outcome, status blocks, debug endpoint
# ---------------------------------------------------------------------------


def _post(url, body: bytes, headers=None):
    req = urllib.request.Request(url, data=body, headers=headers or {})
    with urllib.request.urlopen(req, timeout=10) as resp:
        return resp.status, resp.headers, resp.read()


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, json.loads(resp.read())


@pytest.fixture
def outcome_server(tmp_path):
    from analytics_zoo_tpu_torch.serving import BatcherConfig, ServingEngine
    from analytics_zoo_tpu_torch.serving.http import serve

    class Doubler:
        def do_predict(self, x):
            return np.asarray(x, np.float32) * 2.0

    engine = ServingEngine()
    engine.register("dbl", Doubler(), np.zeros((1, 3), np.float32),
                    config=BatcherConfig(max_batch_size=8, max_wait_ms=1.0),
                    version="1")
    store = LabelStore(str(tmp_path / "cap"), rows_per_shard=4)
    engine.set_label_store(store)
    engine.set_drift(PredictionTracker())
    srv, _t = serve(engine, port=0)
    yield f"http://127.0.0.1:{srv.server_port}", engine, store
    srv.shutdown()
    store.close()
    engine.shutdown()


def test_http_outcome_single_and_batch(outcome_server):
    base, engine, store = outcome_server
    code, _, body = _post(
        f"{base}/v1/models/dbl:outcome",
        json.dumps({"trace_id": "tr-1", "label": [1.0, 2.0],
                    "ts": 123.0}).encode(),
        {"Content-Type": "application/json"})
    assert code == 200 and json.loads(body) == {"accepted": 1}
    code, _, body = _post(
        f"{base}/v1/models/dbl:outcome",
        json.dumps({"outcomes": [
            {"trace_id": "tr-2", "label": 0.5, "ts": 124.0},
            {"trace_id": "tr-3", "label": 0.25, "ts": 125.0},
        ]}).encode(),
        {"Content-Type": "application/json"})
    assert code == 200 and json.loads(body) == {"accepted": 2}
    seg = store.rotate("dbl")
    rows = list(writers.iter_output_rows(seg))
    assert [r["t"] for r in rows] == ["tr-1", "tr-2", "tr-3"]


def test_http_outcome_errors(outcome_server):
    base, engine, store = outcome_server
    for payload, expect in [
        (b"not json", 400),
        (json.dumps({"trace_id": "", "label": 1}).encode(), 400),
        (json.dumps({"outcomes": "nope"}).encode(), 400),
        (json.dumps([1, 2]).encode(), 400),
    ]:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base}/v1/models/dbl:outcome", payload)
        assert e.value.code == expect, payload
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{base}/v1/models/ghost:outcome",
              json.dumps({"trace_id": "t", "label": 1}).encode())
    assert e.value.code == 404


def test_http_outcome_404_without_label_store():
    from analytics_zoo_tpu_torch.serving import BatcherConfig, ServingEngine
    from analytics_zoo_tpu_torch.serving.http import serve

    class Doubler:
        def do_predict(self, x):
            return np.asarray(x, np.float32) * 2.0

    engine = ServingEngine()
    engine.register("dbl", Doubler(), np.zeros((1, 3), np.float32),
                    config=BatcherConfig(max_batch_size=8, max_wait_ms=1.0))
    srv, _t = serve(engine, port=0)
    try:
        base = f"http://127.0.0.1:{srv.server_port}"
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base}/v1/models/dbl:outcome",
                  json.dumps({"trace_id": "t", "label": 1}).encode())
        assert e.value.code == 404
        # and GET /v1/debug/outcomes reports the plane as absent-but-known
        code, doc = _get(f"{base}/v1/debug/outcomes")
        assert code == 200 and doc["models"]["dbl"] is None
    finally:
        srv.shutdown()
        engine.shutdown()


def test_http_model_status_exposes_outcome_plane(outcome_server):
    base, engine, store = outcome_server
    _post(f"{base}/v1/models/dbl:outcome",
          json.dumps({"trace_id": "tr-1", "label": 1.0,
                      "ts": 99.0}).encode())
    store.rotate("dbl")  # the watermark reads committed segments only
    _post(f"{base}/v1/models/dbl:outcome",
          json.dumps({"trace_id": "tr-2", "label": 2.0,
                      "ts": 101.0}).encode())
    code, doc = _get(f"{base}/v1/models/dbl")
    assert code == 200
    outcome = doc["outcome"]
    assert outcome["labels"]["received"] == 2
    assert outcome["labels"]["watermark"] == 99.0
    assert outcome["labels"]["open_segment"] == "segment_00001"
    assert "predictions" in outcome["drift"]
    code, doc = _get(f"{base}/v1/debug/outcomes")
    assert code == 200 and "dbl" in doc["models"]


# ---------------------------------------------------------------------------
# e2e: the closed outcome loop, both directions
# ---------------------------------------------------------------------------


def _lin_model_builder():
    class Lin:
        def __init__(self, w, b):
            self.w, self.b = w, b

        def do_predict(self, x):
            return np.asarray(x, np.float32) @ self.w + self.b

    def build_model(path):
        flat, _ = atomic.read_checkpoint(path)
        d = dict(flat)
        w = next(v for v in d.values() if getattr(v, "ndim", 0) == 2)
        b = next(v for v in d.values() if getattr(v, "ndim", 0) == 1)
        return Lin(np.asarray(w), np.asarray(b))

    return build_model


def _outcome_loop(tmp_path, drift_gates=None):
    from analytics_zoo_tpu_torch.serving import (
        BatcherConfig, RolloutConfig, ServingEngine,
    )

    build, crit = _seed_incumbent(tmp_path / "ckpts", in_dim=3)
    engine = ServingEngine(rollout=RolloutConfig(
        ladder=(0.25, 1.0), min_requests=4, auto_evaluate=False,
        drift_gates=drift_gates))
    tap = CaptureTap(CaptureConfig(directory=str(tmp_path / "cap"),
                                   fraction=1.0, rows_per_shard=16,
                                   roll_interval_s=0.1, idle_poll_s=0.02))
    engine.set_capture(tap)
    store = LabelStore(str(tmp_path / "cap"), rows_per_shard=8)
    engine.set_label_store(store)
    engine.set_drift(PredictionTracker())
    trainer = FlywheelTrainer(build, crit, RetrainConfig(
        capture_dir=str(tmp_path / "cap" / "m"),
        checkpoint_dir=str(tmp_path / "ckpts"),
        batch_size=8, checkpoint_every=2, min_rows=8,
        labels_dir=str(tmp_path / "cap" / "m" / "labels")))
    ctrl = FlywheelController(
        engine, "m", tap, trainer, _lin_model_builder(),
        example_input=np.ones((1, 3), np.float32),
        config=BatcherConfig(max_batch_size=8, max_wait_ms=1.0))
    return engine, tap, store, trainer, ctrl


def test_outcome_loop_end_to_end_promotes(tmp_path):
    """The acceptance path: serve over HTTP, clients report delayed
    outcomes (shuffled, batched, by the trace ids their responses
    carried), the watermark closes the window, the trainer retrains ON
    OUTCOMES, and the candidate promotes through the canary ladder with
    zero client-visible errors."""
    from analytics_zoo_tpu_torch.serving.http import serve

    engine, tap, store, trainer, ctrl = _outcome_loop(tmp_path)
    srv, _t = serve(engine, port=0)
    base = f"http://127.0.0.1:{srv.server_port}"
    try:
        payload = json.dumps(
            {"instances": [[1.0, 1.0, 1.0]]}).encode()
        traces = []
        for _ in range(40):
            code, headers, _ = _post(f"{base}/v1/models/m:predict",
                                     payload)
            assert code == 200
            traces.append(headers["X-Zoo-Trace-Id"])
        assert len(set(traces)) == 40
        # outcomes arrive LATE and SHUFFLED, in uneven batches, with a
        # future-dated ts that closes the watermark over the window
        order = list(range(40))
        np.random.default_rng(13).shuffle(order)
        now = time.time()
        for i in range(0, 40, 7):
            recs = [{"trace_id": traces[j],
                     "label": [float(j) * 0.5, float(j) * -0.25],
                     "ts": now + 60.0 + j} for j in order[i:i + 7]]
            code, _, body = _post(
                f"{base}/v1/models/m:outcome",
                json.dumps({"outcomes": recs}).encode())
            assert code == 200
            assert json.loads(body)["accepted"] == len(recs)
        store.rotate("m")  # commit the label segment

        errors = [0]
        x = np.ones((1, 3), np.float32)

        def traffic():
            for _ in range(8):
                try:
                    engine.predict("m", x)
                except Exception:  # noqa: BLE001 — counted, must be 0
                    errors[0] += 1

        report = ctrl.run_cycle(traffic_fn=traffic, timeout_s=120)
        assert report.outcome == "promoted", report
        assert report.mode == "outcome"
        assert errors[0] == 0
        assert engine.describe_model("m")["latest"] \
            == str(report.candidate_step)
        # the joined window was complete: every captured row had a label
        joiner = store.joiner("m")
        stats = joiner.stats(segments=[
            os.path.join(str(tmp_path / "cap" / "m"), b)
            for b in report.consumed_segments])
        assert stats["completeness"] == 1.0, stats
        # the status surface agrees
        code, doc = _get(f"{base}/v1/models/m")
        assert code == 200 and doc["outcome"]["labels"]["received"] == 40
    finally:
        srv.shutdown()
        ctrl.close()
        tap.close()
        store.close()
        engine.shutdown()


def test_outcome_loop_drifted_canary_rolls_back(tmp_path):
    """The adversarial twin: outcomes are systematically shifted, the
    outcome-trained candidate's predictions diverge from the
    incumbent's, the drift gate trips, the rollback reason is 'drift',
    and the cycle's capture segments are quarantined."""
    from analytics_zoo_tpu_torch.serving.rollout import DriftGateConfig

    engine, tap, store, trainer, ctrl = _outcome_loop(
        tmp_path, drift_gates=DriftGateConfig(max_prediction_js=0.25,
                                              min_count=4))
    try:
        x = np.ones((1, 3), np.float32)
        for _ in range(40):
            engine.predict("m", x)
        tap.flush()
        seg = tap.rotate("m")  # commit the window; run_cycle trains it
        traces = [r["t"] for r in writers.iter_output_rows(seg)]
        assert len(traces) == 40
        # the outcome stream is poisoned: systematically shifted labels
        now = time.time()
        engine.ingest_outcomes("m", [
            {"trace_id": t, "label": [100.0 + j, 100.0 - j],
             "ts": now + 60.0 + j} for j, t in enumerate(traces)])
        store.rotate("m")

        def traffic():
            for _ in range(8):
                try:
                    engine.predict("m", x)
                except Exception:  # noqa: BLE001 — canary-routed request
                    pass

        incumbent = engine.describe_model("m")["latest"]
        report = ctrl.run_cycle(traffic_fn=traffic, timeout_s=120)
        assert report.outcome == "rolled_back", report
        assert report.rollback_reason == "drift"
        assert report.mode == "outcome"
        # incumbent keeps serving; the poisoned cycle's data is gone
        assert engine.describe_model("m")["latest"] == incumbent
        assert report.quarantined and all(
            is_quarantined(s) for s in report.quarantined)
        assert seg in report.quarantined
        assert trainer.pending_segments() == []
    finally:
        ctrl.close()
        tap.close()
        store.close()
        engine.shutdown()


def test_outcome_loop_reminted_step_reruns_rollout(tmp_path):
    """Rollback, then redemption: cycle 1's poisoned outcomes roll the
    candidate back (checkpoints deleted); cycle 2's retrain warm-starts
    from the incumbent and re-mints the SAME step number. The watcher
    must re-register it (its high-water mark rewinds at rollback) and
    the rollout must be judged on fresh evidence — not short-circuited
    by cycle 1's terminal record under the same version string."""
    from analytics_zoo_tpu_torch.serving.rollout import DriftGateConfig

    engine, tap, store, trainer, ctrl = _outcome_loop(
        tmp_path, drift_gates=DriftGateConfig(max_prediction_js=0.25,
                                              min_count=4))
    try:
        x = np.ones((1, 3), np.float32)

        def traffic():
            for _ in range(8):
                try:
                    engine.predict("m", x)
                except Exception:  # noqa: BLE001 — canary-routed
                    pass

        def serve_window():
            for _ in range(40):
                engine.predict("m", x)
            tap.flush()
            seg = tap.rotate("m")
            return {r["t"]: r["y"] for r in writers.iter_output_rows(seg)}

        served = serve_window()
        now = time.time()
        engine.ingest_outcomes("m", [
            {"trace_id": t, "label": [100.0, -100.0], "ts": now + 60.0 + j}
            for j, t in enumerate(served)])
        store.rotate("m")
        r1 = ctrl.run_cycle(traffic_fn=traffic, timeout_s=120)
        assert r1.outcome == "rolled_back", r1
        assert r1.rollback_reason == "drift"

        # honest labels: the predictions the clients actually saw —
        # ground truth agrees with the incumbent, loss is ~0, and the
        # candidate re-reaches the rolled-back cycle's step number
        served = serve_window()
        now = time.time()
        engine.ingest_outcomes("m", [
            {"trace_id": t, "label": np.asarray(y).reshape(-1).tolist(),
             "ts": now + 120.0 + j}
            for j, (t, y) in enumerate(served.items())])
        store.rotate("m")
        r2 = ctrl.run_cycle(traffic_fn=traffic, timeout_s=120)
        assert r2.candidate_step == r1.candidate_step  # re-minted
        assert r2.outcome == "promoted", r2
        assert r2.mode == "outcome"
        assert engine.describe_model("m")["latest"] \
            == str(r2.candidate_step)
    finally:
        ctrl.close()
        tap.close()
        store.close()
        engine.shutdown()


def test_cycle_without_registration_reports_register_failed(tmp_path):
    """A candidate that never becomes a live version (the watcher
    refused or failed to register it) must be reported as such — not
    misread from a previous rollout's terminal record, and not
    quarantined (it never served a request)."""
    engine, tap, store, trainer, ctrl = _outcome_loop(tmp_path)
    try:
        x = np.ones((1, 3), np.float32)
        for _ in range(40):
            engine.predict("m", x)
        tap.flush()
        ctrl.watcher.poll_once = lambda: None  # registration black-holed
        report = ctrl.run_cycle(timeout_s=30)
        assert report.outcome == "register_failed", report
        assert report.candidate_step is not None
        assert not report.quarantined
        # the data was consumed and the candidate committed — a later,
        # healthy poll can still register the step
        assert trainer.incumbent_step() == report.candidate_step
        assert trainer.pending_segments() == []
    finally:
        ctrl.close()
        tap.close()
        store.close()
        engine.shutdown()


# ---------------------------------------------------------------------------
# subprocess kill -> resume through the joiner (bitwise)
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
def seeded_outcome_root(tmp_path_factory):
    """One seeded root: incumbent + committed capture segment + a
    committed label segment ingested out of order."""
    d = tmp_path_factory.mktemp("outcome_seed")
    out = d / "seed.json"
    proc = _run_worker("seed_outcome", d / "root", out, _worker_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    return d / "root"


def test_outcome_retrain_kill_resume_bitwise(tmp_path, seeded_outcome_root):
    """Kill the outcome-mode retrain mid-epoch; the resumed cycle reads
    the pinned plan, rejoins the same labels, and commits a candidate
    with BITWISE-identical payload bytes."""
    ref_root = tmp_path / "ref"
    chaos_root = tmp_path / "chaos"
    shutil.copytree(seeded_outcome_root, ref_root)
    shutil.copytree(seeded_outcome_root, chaos_root)
    ref_out = tmp_path / "ref.json"
    proc = _run_worker("retrain_outcome", ref_root, ref_out, _worker_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    chaos_out = tmp_path / "chaos.json"
    proc = _run_worker("retrain_outcome", chaos_root, chaos_out,
                       _worker_env("flywheel_mid_retrain_kill", skip=0))
    assert proc.returncode == chaos.EXIT_CODE, (
        f"worker should have died (rc={proc.returncode})\n"
        + proc.stderr[-3000:])
    assert not chaos_out.exists()
    proc = _run_worker("retrain_outcome", chaos_root, chaos_out,
                       _worker_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(ref_out) as f:
        ref = json.load(f)
    with open(chaos_out) as f:
        got = json.load(f)
    assert ref["mode"] == got["mode"] == "outcome"
    assert got["step"] == ref["step"]
    assert got["consumed"] == ref["consumed"]
    assert sorted(got["leaves"]) == sorted(ref["leaves"])
    for key, crc in ref["leaves"].items():
        assert got["leaves"][key] == crc, f"leaf {key} differs"


# ---------------------------------------------------------------------------
# the JAX inspector over the port's label stores
# ---------------------------------------------------------------------------


@pytest.fixture()
def inspect_mod():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "ckpt_inspect", os.path.join(REPO, "scripts", "ckpt_inspect.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inspectable_store(tmp_path):
    _capture_segments(tmp_path, counts=(6,))
    store = LabelStore(str(tmp_path), rows_per_shard=3)
    store.ingest("m", _records(range(6)))
    store.ingest("m", [
        {"trace_id": "t0001", "label": [5.0], "ts": 1700000500.0},  # dup
        {"trace_id": "ghost", "label": [1.0], "ts": 1700000501.0},  # orphan
    ])
    seg = store.rotate("m")
    store.close()
    return os.path.join(str(tmp_path), "m", "labels"), seg


def test_jax_inspector_reads_the_ports_label_store(tmp_path, inspect_mod, capsys):
    ldir, _seg = _inspectable_store(tmp_path)
    inspect_mod.main([ldir, "--verify"])
    out = capsys.readouterr().out
    assert "label store for model 'm'" in out
    assert "8 labels (7 unique, 1 duplicates, 12.5% dup rate" in out
    assert "completeness 100.0%" in out
    assert "1 orphaned label(s)" in out
    assert "segment_00000: labels closed" in out
    assert "ok" in out  # checksum column


def test_jax_inspector_reads_a_port_label_segment(tmp_path, inspect_mod, capsys):
    _ldir, seg = _inspectable_store(tmp_path)
    inspect_mod.main([seg, "--verify"])
    out = capsys.readouterr().out
    assert "label segment for model 'm': COMMITTED" in out
    assert "traces" in out


def test_jax_inspector_flags_a_corrupt_port_label_store(tmp_path, inspect_mod,
                                                  capsys):
    ldir, seg = _inspectable_store(tmp_path)
    shard = os.path.join(seg, "shard_00000.jsonl")
    with open(shard, "ab") as f:
        f.write(b"garbage\n")
    with pytest.raises(SystemExit) as exc:
        inspect_mod.main([ldir, "--verify"])
    assert exc.value.code == 1
    assert "CORRUPT" in capsys.readouterr().err


def test_label_chaos_point_is_known():
    assert "label_writer_torn" in chaos.FLYWHEEL_POINTS


# ---------------------------------------------------------------------------
# the two packages on the same inputs
# ---------------------------------------------------------------------------


def test_label_directories_cross_packages_bitwise(tmp_path):
    """The same outcome records (shuffled, duplicated, an orphan) through
    the JAX label store and the port's, in the same batches: the label
    segments hold the same rows, and every package's join over either
    label tree yields the same samples byte for byte, with the same
    joiner statistics."""
    from analytics_zoo_tpu.flywheel.labels import LabeledSource as JSource
    from analytics_zoo_tpu.flywheel.labels import LabelJoiner as JJoiner
    from analytics_zoo_tpu.flywheel.labels import LabelStore as JStore

    segs = _capture_segments(tmp_path / "cap", counts=(9, 7))
    records = _records(range(16)) + [
        {"trace_id": "t0002", "label": [100.0, 100.0], "ts": 1700000200.0},
        {"trace_id": "t0007", "label": [1.0], "ts": 1700000107.0},
        {"trace_id": "nope", "label": [0.0], "ts": 1700000300.0}]
    np.random.default_rng(5).shuffle(records)
    ldirs = []
    for store_cls, root in ((LabelStore, tmp_path / "port"),
                            (JStore, tmp_path / "jax")):
        store = store_cls(str(root), rows_per_shard=3,
                          clock=lambda: 1700000400.0)
        for i in range(0, len(records), 5):
            store.ingest("m", records[i:i + 5])
        store.rotate("m")
        store.close()
        ldirs.append(os.path.join(str(root), "m", "labels"))
    ours, theirs = (os.path.join(d, "segment_00000") for d in ldirs)
    assert list(writers.iter_output_rows(ours)) == \
        list(writers.iter_output_rows(theirs))
    assert writers.read_manifest(ours)["job"] == \
        writers.read_manifest(theirs)["job"]
    want = _joined_bytes(JSource(segs, label_dirs=ldirs[1]))
    assert want
    for ldir in ldirs:
        assert _joined_bytes(LabeledSource(segs, label_dirs=ldir)) == want
        assert _joined_bytes(JSource(segs, label_dirs=ldir)) == want
        cap = str(tmp_path / "cap" / "m")
        assert LabelJoiner(cap, ldir).stats() == JJoiner(cap, ldir).stats()


def test_drift_scores_equal_the_jax_packages():
    """Sketches, PSI/JS and the detectors on the same seeded streams:
    every number is the JAX package's, exactly."""
    from analytics_zoo_tpu.flywheel import drift as jdrift

    rng = np.random.default_rng(21)
    streams = [rng.normal(0.0, 1.0, 3000), rng.normal(0.4, 1.3, 3000),
               rng.exponential(2.0, 3000)]
    for a_vals, b_vals in ((streams[0], streams[1]),
                           (streams[1], streams[2])):
        ours = [StreamingHistogram(max_bins=24) for _ in range(2)]
        theirs = [jdrift.StreamingHistogram(max_bins=24) for _ in range(2)]
        for h, vals in zip(ours + theirs, [a_vals, b_vals] * 2):
            h.extend(vals)
        for h, j in zip(ours, theirs):
            assert h._bins == j._bins and h.snapshot() == j.snapshot()
        assert compare(*ours) == jdrift.compare(*theirs)
    p, q = rng.dirichlet(np.ones(16)), rng.dirichlet(np.ones(16))
    from analytics_zoo_tpu_torch.flywheel.drift import js_divergence, psi

    assert psi(p, q) == jdrift.psi(p, q)
    assert js_divergence(p, q) == jdrift.js_divergence(p, q)
    det, jdet = DriftDetector("m", max_features=3), \
        jdrift.DriftDetector("m", max_features=3)
    ref = rng.normal(size=(400, 3)).astype(np.float32)
    live = rng.normal(0.8, 1.0, size=(400, 3)).astype(np.float32)
    for d in (det, jdet):
        d.set_reference(list(ref))
        for row in live:
            d.observe(row)
    assert det.scores(min_count=50) == jdet.scores(min_count=50)
    tr, jtr = PredictionTracker(), jdrift.PredictionTracker()
    for version, vals in (("1", streams[0][:200]), ("2", streams[1][:200])):
        for v in vals:
            y = np.full((1, 2), v, np.float32)
            tr.observe("m", version, y)
            jtr.observe("m", version, y)
    assert tr.js("m", "1", "2") == jtr.js("m", "1", "2")
    assert tr.describe("m") == jtr.describe("m")


def test_flywheel_package_exports_outcome_plane():
    import analytics_zoo_tpu.flywheel as jfw
    import analytics_zoo_tpu_torch.flywheel as fw

    assert fw.LABEL_FORMAT == jfw.LABEL_FORMAT

    for name in ("LabelStore", "LabelJoiner", "LabeledSource",
                 "LABEL_FORMAT", "DriftDetector", "PredictionTracker",
                 "StreamingHistogram"):
        assert name in fw.__all__ and hasattr(fw, name)
    assert zlib.crc32(b"") == 0  # keep the zlib import honest
