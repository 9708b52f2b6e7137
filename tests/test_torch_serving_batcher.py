"""The dynamic batcher's host behaviour, held alike in the JAX package's
``serving.batcher`` and the port's copy: every case runs once per package.

Pure host code: the predict function is numpy (elementwise, so a row's
result cannot depend on its batchmates or the batch size), so the cases
isolate the queueing logic and run in milliseconds. No case sleeps on a
guess: a model that must be busy signals that it entered predict, and the
only sleep waits out a stated deadline."""

import importlib
import threading
import time

import numpy as np
import pytest

JOIN_S = 30  # every thread join and future wait has its own bound


@pytest.fixture(params=["analytics_zoo_tpu", "analytics_zoo_tpu_torch"],
                ids=["jax", "port"])
def bt(request):
    return importlib.import_module(f"{request.param}.serving.batcher")


class RecordingModel:
    """A deterministic per-row function that records the batch sizes it
    was called with; it can hold a flush (``gate``, after setting
    ``entered``) or fail once on demand."""

    def __init__(self):
        rng = np.random.default_rng(7)
        self.scale = rng.normal(size=(3,)).astype(np.float32)
        self.batch_sizes = []
        self.gate = None
        self.entered = threading.Event()
        self.fail_next = False

    def _fn(self, x):
        x = np.asarray(x, np.float32)
        return x[:, :3] * self.scale + np.tanh(x[:, 1:4])

    def predict(self, x):
        self.entered.set()
        gate = self.gate
        if gate is not None:
            assert gate.wait(timeout=JOIN_S)
        if self.fail_next:
            self.fail_next = False
            raise RuntimeError("injected model fault")
        self.batch_sizes.append(len(x))
        return self._fn(x)

    def direct(self, x):
        return self._fn(x)

    def hold(self):
        """Hold the next flush inside predict; returns the release."""
        self.gate = threading.Event()
        self.entered.clear()
        return self.gate


@pytest.fixture
def model():
    return RecordingModel()


def _held(model, b, x):
    """Submit ``x`` and wait until its flush is inside predict."""
    fut = b.submit(x)
    assert model.entered.wait(timeout=JOIN_S)
    return fut


def test_timeout_only_flush_single_straggler(bt, model):
    """One lone request flushes after max_wait_ms, padded only to the
    smallest bucket."""
    b = bt.DynamicBatcher(model.predict, bt.BatcherConfig(
        max_batch_size=8, max_wait_ms=20.0, buckets=(1, 2, 4, 8)))
    try:
        x = np.ones((1, 4), np.float32)
        out = b.submit(x).result(timeout=JOIN_S)
        np.testing.assert_array_equal(out, model.direct(x))
        assert model.batch_sizes == [1]
    finally:
        b.stop()


def test_bucket_padding_and_exactness(bt, model):
    """3 rows pad up to bucket 4; results equal the unbatched function."""
    b = bt.DynamicBatcher(model.predict, bt.BatcherConfig(
        max_batch_size=8, max_wait_ms=5.0, buckets=(1, 2, 4, 8)))
    try:
        x = np.arange(12, dtype=np.float32).reshape(3, 4)
        out = b.submit(x).result(timeout=JOIN_S)
        np.testing.assert_array_equal(out, model.direct(x))
        assert model.batch_sizes == [4]
    finally:
        b.stop()


def test_oversize_request_split_and_reassembled(bt, model):
    """A request larger than max_batch_size splits into chunks and the
    future returns the whole result in order."""
    b = bt.DynamicBatcher(model.predict, bt.BatcherConfig(
        max_batch_size=4, max_wait_ms=2.0))
    try:
        x = np.arange(40, dtype=np.float32).reshape(10, 4)
        out = b.submit(x).result(timeout=JOIN_S)
        assert out.shape == (10, 3)
        np.testing.assert_array_equal(out, model.direct(x))
        assert all(s <= 4 for s in model.batch_sizes)
        assert sum(model.batch_sizes) >= 10
    finally:
        b.stop()


def test_concurrent_producers_identical_to_direct(bt, model):
    """Many threads submitting distinct rows each get exactly their own
    unbatched result back: scatter never crosses requests."""
    b = bt.DynamicBatcher(model.predict, bt.BatcherConfig(
        max_batch_size=16, max_wait_ms=2.0))
    errors = []
    start = threading.Barrier(8)

    def client(seed):
        rng = np.random.default_rng(seed)
        try:
            start.wait(timeout=JOIN_S)
            for _ in range(25):
                x = rng.normal(size=(rng.integers(1, 4), 4)).astype(
                    np.float32)
                out = b.submit(x).result(timeout=JOIN_S)
                np.testing.assert_array_equal(out, model.direct(x))
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    try:
        threads = [threading.Thread(target=client, args=(s,))
                   for s in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=JOIN_S)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        assert sum(model.batch_sizes) >= 8 * 25
    finally:
        b.stop()


def test_deadline_expiry_fails_future_not_loop(bt, model):
    """A request whose deadline passes while the flush thread is busy
    fails with DeadlineExceededError; later requests still serve."""
    gate = model.hold()
    b = bt.DynamicBatcher(model.predict, bt.BatcherConfig(
        max_batch_size=2, max_wait_ms=1.0))
    try:
        x = np.ones((2, 4), np.float32)
        blocked = _held(model, b, x)
        doomed = b.submit(x, timeout_ms=1.0)
        time.sleep(0.02)  # past doomed's 1 ms deadline
        model.gate = None
        gate.set()
        np.testing.assert_array_equal(blocked.result(timeout=JOIN_S),
                                      model.direct(x))
        with pytest.raises(bt.DeadlineExceededError):
            doomed.result(timeout=JOIN_S)
        out = b.submit(x).result(timeout=JOIN_S)
        np.testing.assert_array_equal(out, model.direct(x))
    finally:
        gate.set()
        b.stop()


def test_model_fault_fails_batch_not_loop(bt, model):
    """A predict exception lands on the in-flight futures; the next flush
    works."""
    b = bt.DynamicBatcher(model.predict, bt.BatcherConfig(
        max_batch_size=4, max_wait_ms=1.0))
    try:
        model.fail_next = True
        x = np.ones((2, 4), np.float32)
        with pytest.raises(RuntimeError, match="injected model fault"):
            b.submit(x).result(timeout=JOIN_S)
        out = b.submit(x).result(timeout=JOIN_S)
        np.testing.assert_array_equal(out, model.direct(x))
    finally:
        b.stop()


def test_queue_full_rejects_immediately(bt, model):
    """A full queue raises QueueFullError from submit at once; draining
    the queue restores service."""
    gate = model.hold()
    b = bt.DynamicBatcher(model.predict, bt.BatcherConfig(
        max_batch_size=1, max_wait_ms=1.0, max_queue_size=3,
        pipeline_depth=0))
    try:
        x = np.ones((1, 4), np.float32)
        in_flight = _held(model, b, x)
        queued = [b.submit(x) for _ in range(3)]
        with pytest.raises(bt.QueueFullError):
            b.submit(x)
        model.gate = None
        gate.set()
        for f in [in_flight, *queued]:
            np.testing.assert_array_equal(f.result(timeout=JOIN_S),
                                          model.direct(x))
        np.testing.assert_array_equal(b.submit(x).result(timeout=JOIN_S),
                                      model.direct(x))
    finally:
        gate.set()
        b.stop()


def test_multi_input_requests(bt):
    """List-of-arrays requests batch per input and scatter exactly."""
    b = bt.DynamicBatcher(lambda xs: xs[0] * 2.0 + xs[1], bt.BatcherConfig(
        max_batch_size=8, max_wait_ms=2.0))
    try:
        a = np.arange(6, dtype=np.float32).reshape(3, 2)
        c = np.ones((3, 2), np.float32)
        out = b.submit([a, c]).result(timeout=JOIN_S)
        np.testing.assert_array_equal(out, a * 2.0 + c)
    finally:
        b.stop()


def test_invalid_submissions(bt, model):
    """Scalar, empty and mismatched-leading-axis inputs are rejected at
    submit."""
    b = bt.DynamicBatcher(model.predict, bt.BatcherConfig(max_batch_size=4))
    try:
        with pytest.raises(ValueError):
            b.submit(np.float32(1.0))
        with pytest.raises(ValueError):
            b.submit(np.zeros((0, 4), np.float32))
        with pytest.raises(ValueError):
            b.submit([np.zeros((2, 4)), np.zeros((3, 4))])
    finally:
        b.stop()


def test_mismatched_trailing_dims_fail_batch_not_loop(bt, model):
    """Two signature-less requests with different trailing dims in one
    batch fail on their own futures; the flush thread survives."""
    gate = model.hold()
    b = bt.DynamicBatcher(model.predict, bt.BatcherConfig(
        max_batch_size=8, max_wait_ms=1.0, pipeline_depth=0))
    try:
        x = np.ones((2, 4), np.float32)
        blocked = _held(model, b, x)
        f1 = b.submit(np.ones((2, 4), np.float32))
        f2 = b.submit(np.ones((1, 5), np.float32))
        model.gate = None
        gate.set()
        np.testing.assert_array_equal(blocked.result(timeout=JOIN_S),
                                      model.direct(x))
        for f in (f1, f2):
            with pytest.raises(ValueError):
                f.result(timeout=JOIN_S)
        np.testing.assert_array_equal(b.submit(x).result(timeout=JOIN_S),
                                      model.direct(x))
    finally:
        gate.set()
        b.stop()


def test_mixed_arity_batch_fails_cleanly(bt):
    """A single-input and a two-input request in one batch fail with
    ValueError instead of feeding the model truncated inputs."""
    gate, entered = threading.Event(), threading.Event()

    def predict(x):
        entered.set()
        assert gate.wait(timeout=JOIN_S)
        xs = x if isinstance(x, list) else [x]
        return np.asarray(xs[0]) * 2.0

    b = bt.DynamicBatcher(predict, bt.BatcherConfig(
        max_batch_size=8, max_wait_ms=1.0, pipeline_depth=0))
    try:
        a = np.ones((1, 3), np.float32)
        blocked = b.submit(a)
        assert entered.wait(timeout=JOIN_S)
        f1 = b.submit(a)
        f2 = b.submit([a, a])
        gate.set()
        np.testing.assert_array_equal(blocked.result(timeout=JOIN_S),
                                      a * 2.0)
        for f in (f1, f2):
            with pytest.raises(ValueError, match="input arrays"):
                f.result(timeout=JOIN_S)
        np.testing.assert_array_equal(b.submit(a).result(timeout=JOIN_S),
                                      a * 2.0)
    finally:
        gate.set()
        b.stop()


def test_signature_rejects_at_submit_and_coerces_dtype(bt):
    """With an InputSignature, arity and trailing-shape mismatches raise at
    submit, and numeric dtypes coerce to the model's."""
    seen = []

    def predict(x):
        seen.append(np.asarray(x).dtype)
        return np.asarray(x) * 2.0

    sig = bt.InputSignature.from_example(np.zeros((1, 3), np.float32))
    b = bt.DynamicBatcher(predict, bt.BatcherConfig(
        max_batch_size=4, max_wait_ms=1.0), signature=sig)
    try:
        with pytest.raises(ValueError, match="shape"):
            b.submit(np.ones((2, 4), np.float32))
        with pytest.raises(ValueError, match="input array"):
            b.submit([np.ones((2, 3), np.float32)] * 2)
        with pytest.raises(ValueError, match="dtype"):
            b.submit(np.array([["a", "b", "c"]]))
        out = b.submit(np.ones((2, 3), np.int64)).result(timeout=JOIN_S)
        np.testing.assert_array_equal(out, np.full((2, 3), 2.0, np.float32))
        assert seen == [np.dtype(np.float32)]
    finally:
        b.stop()


def test_staging_buffers_are_reused_and_results_private(bt):
    """A signature batcher assembles into leased staging buffers: results
    are private writable copies, so a caller writing into its result
    changes neither a batchmate's result nor the next flush."""
    sig = bt.InputSignature.from_example(np.zeros((1, 2), np.float32))
    b = bt.DynamicBatcher(lambda x: x + 1.0, bt.BatcherConfig(
        max_batch_size=4, max_wait_ms=1.0, buckets=(4,)), signature=sig)
    try:
        x = np.arange(4, dtype=np.float32).reshape(2, 2)
        out = b.submit(x).result(timeout=JOIN_S)
        out[...] = -7.0
        np.testing.assert_array_equal(b.submit(x).result(timeout=JOIN_S),
                                      x + 1.0)
    finally:
        b.stop()


def test_tree_outputs_slice_and_concat(bt):
    """Dict and tuple outputs scatter leaf by leaf, and the chunks of a
    split request concatenate leaf by leaf (the port swaps JAX's tree
    utilities for its own)."""
    b = bt.DynamicBatcher(
        lambda x: {"y": x * 2.0, "pair": (x[:, :1], x.sum(-1))},
        bt.BatcherConfig(max_batch_size=2, max_wait_ms=1.0))
    try:
        x = np.arange(10, dtype=np.float32).reshape(5, 2)
        out = b.submit(x).result(timeout=JOIN_S)
        np.testing.assert_array_equal(out["y"], x * 2.0)
        np.testing.assert_array_equal(out["pair"][0], x[:, :1])
        np.testing.assert_array_equal(out["pair"][1], x.sum(-1))
    finally:
        b.stop()


def test_ladder_normalization(bt):
    """Bucket ladders clip to max_batch_size and always end there."""
    assert bt.BatcherConfig(max_batch_size=8).ladder() == (1, 2, 4, 8)
    assert bt.BatcherConfig(max_batch_size=8,
                            buckets=(1, 3, 8, 64)).ladder() == (1, 3, 8)
    assert bt.BatcherConfig(max_batch_size=6,
                            buckets=(2, 4)).ladder() == (2, 4, 6)
