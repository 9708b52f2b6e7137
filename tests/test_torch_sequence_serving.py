"""The port's sequence serving: length-bucketed prefill and iteration-level
continuous batching (``serving.sequence``, ``serving.decode_state``),
``InferenceModel.compile_program``, ``ServingEngine.register(sequence=)``
/ ``generate`` and HTTP ``:generate``.

The cases of the JAX package's ``tests/test_sequence_serving.py`` run
here against the port, the int8 one included; its AOT-cache case does
not apply: the port keeps no persistent executable cache (a CUDA graph
cannot be saved; ``tests/test_torch_frontdoor.py``
``test_aot_cache_dir_raises_naming_a4`` holds the refusal). The
load-bearing pin
is **interleaving parity**: whatever admission/eviction schedule the
continuous batcher picks, each request's generated tokens equal its
single-request sequential generate (``Seq2seqNet.infer``), token for
token. On the CPU every program is the eager call, and the same f32 ops
give each row the same bits at every batch width, so parity is exact.
Float carries are never compared across schedules (a masked blend can
flip a zero's sign without changing any argmax).

Also here: a partial admission next to live slots (dead rows land in the
slot carries' sink row and never touch a live slot), zero program builds
after warm-up, deadlines mid-decode, the watchdog restart discipline,
backpressure, chaos step faults, ``zoo_seq_*`` metrics, and the engine
and HTTP surfaces.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch as port
from analytics_zoo_tpu_torch.ft import chaos
from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts
from analytics_zoo_tpu_torch.keras.engine.topology import Sequential
from analytics_zoo_tpu_torch.keras.layers import Dense
from analytics_zoo_tpu_torch.models.seq2seq import Seq2seqNet
from analytics_zoo_tpu_torch.serving import (
    BatcherConfig,
    ServingEngine,
    serve_http,
)
from analytics_zoo_tpu_torch.serving.batcher import (
    DeadlineExceededError,
    InputSignature,
    QueueFullError,
)
from analytics_zoo_tpu_torch.serving.decode_state import (
    DecodeSlots,
    PrefillStaging,
    SlotRecord,
)
from analytics_zoo_tpu_torch.serving.metrics import ServingMetrics
from analytics_zoo_tpu_torch.serving.resilience import (
    FlushThreadRestartedError,
)
from analytics_zoo_tpu_torch.serving.sequence import (
    ContinuousBatcher,
    SequenceConfig,
)

VOCAB = 13
JOIN_S = 120
CFG = dict(max_prompt_len=8, max_prefill_batch=2, slots=4,
           max_new_tokens=6, start_token=1)


@pytest.fixture(autouse=True)
def _disarm_chaos():
    chaos.reset()
    yield
    chaos.reset()


@pytest.fixture(scope="module")
def seqmodel():
    """One tiny seq2seq + InferenceModel for the whole module: programs
    live in the model's LRU, so later tests reuse what the first built."""
    port.init_nncontext(device="cpu")
    net = Seq2seqNet(VOCAB, 8, (8,), cell_type="lstm", name="s2s_seqtest")
    model = InferenceModel(executable_cache_size=None)
    model.do_load_keras(net)
    yield net, model
    port.stop_nncontext()
    reset_name_counts()


def _reference(net, model, prompt, max_new_tokens, eos=None):
    """Single-request sequential generate — the parity oracle."""
    with torch.inference_mode():
        out = net.infer(model.params,
                        torch.tensor(np.asarray(prompt, np.int32)[None, :]),
                        start_token=1, max_seq_len=max_new_tokens)
    out = out[0].numpy()
    if eos is not None:
        hits = np.where(out == eos)[0]
        if hits.size:
            out = out[:hits[0] + 1]
    return out


def _wait(cond, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


# -- wildcard InputSignature --------------------------------------------------


def test_signature_wildcard_accepts_any_length():
    sig = InputSignature([((None,), np.int32)], multi=False)
    assert not sig.fixed
    for n in (1, 4, 17):
        out = sig.validate([np.zeros((2, n), np.int64)])
        assert out[0].dtype == np.int32 and out[0].shape == (2, n)


def test_signature_wildcard_still_validates_fixed_dims_and_arity():
    sig = InputSignature([((None, 3), np.float32)], multi=False)
    assert sig.validate([np.zeros((1, 9, 3))])[0].shape == (1, 9, 3)
    with pytest.raises(ValueError, match=r"\(None = any length\)"):
        sig.validate([np.zeros((1, 9, 4))])
    with pytest.raises(ValueError, match="None = any length"):
        sig.validate([np.zeros((1, 9))])
    with pytest.raises(ValueError, match="model expects 1"):
        sig.validate([np.zeros((1, 9, 3)), np.zeros((1, 2))])
    with pytest.raises(ValueError, match="incompatible"):
        InputSignature([((None,), np.int32)], multi=False).validate(
            [np.array([["a"]], dtype=object)])


def test_signature_fixed_path_regression():
    sig = InputSignature.from_example(np.zeros((2, 3), np.float32))
    assert sig.fixed and sig.specs == (((3,), np.dtype(np.float32)),)
    with pytest.raises(ValueError) as e:
        sig.validate([np.zeros((1, 4), np.float32)])
    assert str(e.value) == "input 0: rows have shape (4,), model expects (3,)"


# -- config / host-side state -------------------------------------------------


def test_sequence_config_validation_and_grid():
    cfg = SequenceConfig(**CFG)
    assert cfg.length_ladder() == (1, 2, 4, 8)
    assert cfg.batch_ladder() == (1, 2)
    assert set(cfg.grid()) == {(b, l) for b in (1, 2) for l in (1, 2, 4, 8)}
    assert SequenceConfig(max_prompt_len=8, prompt_buckets=(8, 3)
                          ).prompt_buckets == (3, 8)
    with pytest.raises(ValueError, match="cover"):
        SequenceConfig(max_prompt_len=8, prompt_buckets=(2, 4))
    for bad in (dict(slots=0), dict(max_new_tokens=0),
                dict(max_prompt_len=0), dict(max_prefill_batch=0)):
        with pytest.raises(ValueError):
            SequenceConfig(**bad)


def test_decode_slots_admit_evict():
    slots = DecodeSlots(3)
    assert slots.free == 3 and slots.live == 0
    req = type("R", (), {"future": None})()
    rec = SlotRecord(req, max_new_tokens=2, eos=None, deadline=None)
    slots.admit(1, rec)
    assert slots.live == 1 and slots.free_indices() == [0, 2]
    with pytest.raises(RuntimeError, match="occupied"):
        slots.admit(1, rec)
    assert slots.evict(1) is rec
    assert slots.evict(1) is None
    slots.admit(0, rec)
    assert [i for i, _ in slots.evict_all()] == [0]
    assert slots.live == 0


def test_slot_record_finish_conditions():
    req = type("R", (), {"future": None})()
    rec = SlotRecord(req, max_new_tokens=3, eos=7, deadline=None)
    assert not rec.append(5) and not rec.append(6)
    assert rec.append(7)
    np.testing.assert_array_equal(rec.result(), np.array([5, 6, 7], np.int32))
    rec2 = SlotRecord(req, max_new_tokens=2, eos=7, deadline=None)
    assert not rec2.append(1) and rec2.append(2)


def test_prefill_staging_reuses_buffers():
    staging = PrefillStaging(cap_per_cell=1)
    lease = staging.checkout(2, 4)
    src, mask = lease
    assert src.shape == (2, 4) and src.dtype == np.int32
    assert mask.shape == (2, 4) and mask.dtype == np.float32
    staging.release(lease)
    again = staging.checkout(2, 4)
    assert again[0] is src
    other = staging.checkout(1, 8)
    assert other[0].shape == (1, 8)
    staging.release(again)
    staging.release(other)


# -- compile_program ----------------------------------------------------------


def test_compile_program_keys_counts_and_generations(seqmodel):
    """A program is keyed by tag and argument signature in the bucket LRU:
    a second request hits, another shape misses, a reload retires it;
    int32 outputs stay int32, float outputs come back float32."""
    net = Seq2seqNet(VOCAB, 8, (8,), cell_type="gru", name="s2s_prog")
    im = InferenceModel().do_load_keras(net)
    inner = lambda p, s, carries, t: net.seq_step(p, carries, t)
    carries = net.seq_init_carries(3)
    tok = torch.zeros((3,), dtype=torch.int32)
    fn, params, state = im.compile_program("step", inner, (carries, tok),
                                           warm=True)
    assert im.cache_stats == {"hits": 0, "misses": 1, "evictions": 0}
    again, _, _ = im.compile_program("step", inner, (carries, tok))
    assert again is fn and im.cache_stats["hits"] == 1
    key = next(k for k in im._compiled if k[0] == "__prog__")
    assert key[1] == "step" and key in im._warmed
    new_carries, nxt = fn(params, state, carries, tok.numpy())
    assert nxt.dtype == torch.int32 and new_carries[0].dtype == torch.float32
    with torch.inference_mode():
        want = net.seq_step(im.params, carries, tok)
    assert torch.equal(nxt, want[1])
    im.compile_program("step", inner, (net.seq_init_carries(2),
                                       tok[:2]))
    assert im.cache_stats["misses"] == 2
    im.do_load_keras(net)
    im.compile_program("step", inner, (carries, tok))
    assert im.cache_stats["misses"] == 3


def test_admission_scatter_drops_dead_rows_next_to_live_slots(seqmodel):
    """The admission program of a partial prefill batch (one real row, one
    dead row aimed at index ``slots``) writes only the free slot: every
    live slot keeps its carry bitwise, and nothing indexes out of
    range."""
    net, model = seqmodel
    S = 4
    b = ContinuousBatcher(model, SequenceConfig(**CFG), name="drop")
    try:
        admit_fn, params, state = b._program_admit(2)
        rng = np.random.default_rng(0)
        slot = [tuple(torch.tensor(rng.standard_normal((S, 8)),
                                   dtype=torch.float32) for _ in range(2))]
        new = [tuple(torch.tensor(rng.standard_normal((2, 8)),
                                  dtype=torch.float32) for _ in range(2))]
        idx = np.array([2, S], np.int32)  # slot 2 free; row 1 is dead
        out = admit_fn(params, state, slot, new, idx)
        for o, s, n in zip(out[0], slot[0], new[0]):
            assert o.shape == (S, 8)
            for live in (0, 1, 3):
                assert torch.equal(o[live], s[live])
            assert torch.equal(o[2], n[0])
    finally:
        b.stop(drain=False)


def test_partial_admission_wave_next_to_live_slots_keeps_parity(seqmodel):
    """A long generation holds a slot while waves of 3 prompts are
    admitted through the batch-4 prefill bucket (one dead row each): every
    stream equals its single-request generate."""
    net, model = seqmodel
    long_n = 6000
    cfg = SequenceConfig(max_prompt_len=8, max_prefill_batch=4, slots=6,
                         max_new_tokens=long_n, start_token=1)
    b = ContinuousBatcher(model, cfg, name="partial")
    try:
        b.warmup()
        rng = np.random.default_rng(3)
        long_prompt = np.array([3, 4, 5], np.int32)
        hog = b.submit(long_prompt)
        assert _wait(lambda: b.queue_depth == 0 and b.pending_requests == 1)
        for wave in range(2):
            cases = [(rng.integers(0, VOCAB, 4).astype(np.int32),
                      int(rng.integers(1, 6))) for _ in range(3)]
            futs = [b.submit(p, max_new_tokens=n) for p, n in cases]
            for f, (p, n) in zip(futs, cases):
                np.testing.assert_array_equal(f.result(timeout=JOIN_S),
                                              _reference(net, model, p, n))
        assert not hog.done()  # the waves ran next to a live slot
        np.testing.assert_array_equal(hog.result(timeout=JOIN_S),
                                      _reference(net, model, long_prompt,
                                                 long_n))
    finally:
        b.stop(drain=False)


# -- the tentpole: interleaving parity ----------------------------------------


def test_continuous_batching_parity(seqmodel):
    """Mixed-length prompts with mixed budgets, submitted together: every
    request's tokens equal its single-request generate."""
    net, model = seqmodel
    rng = np.random.default_rng(16)
    b = ContinuousBatcher(model, SequenceConfig(**CFG), name="parity")
    try:
        cases = []
        for i in range(10):
            n = int(rng.integers(1, 9))
            prompt = rng.integers(0, VOCAB, size=(n,)).astype(np.int32)
            mnt = int(rng.integers(1, 7))
            ref = _reference(net, model, prompt, mnt)
            eos = int(ref[min(1, mnt - 1)]) if i % 3 == 0 else None
            cases.append((prompt, mnt, eos,
                          _reference(net, model, prompt, mnt, eos=eos)))
        futs = [b.submit(p, max_new_tokens=mnt, eos=eos)
                for p, mnt, eos, _ in cases]
        for fut, (_p, _mnt, _eos, ref) in zip(futs, cases):
            got = fut.result(timeout=JOIN_S)
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, ref)
    finally:
        b.stop(drain=False)


def test_quantized_decode_matches_quantized_oracle(seqmodel):
    """Weight-only int8: the continuous batcher's programs run over the
    ``do_quantize``d params (dequantized inside every program) and its
    greedy decode equals the sequential reference on the same dequantized
    weights, bitwise. Parity is per variant: int8 may change argmax ties
    against the float model."""
    from analytics_zoo_tpu_torch.inference.inference_model import (
        _dequantize_params,
        _is_qleaf,
    )

    net = Seq2seqNet(VOCAB, 8, (8,), cell_type="lstm", name="s2s_qparity")
    m = InferenceModel()
    m.do_load_keras(net)
    m.do_quantize()
    assert any(_is_qleaf(v) for p in m.params.values()
               for v in (p.values() if isinstance(p, dict) else ()))
    b = ContinuousBatcher(m, SequenceConfig(**CFG), name="qparity")
    try:
        prompt = np.array([1, 2, 3, 4])
        got = b.submit(prompt, max_new_tokens=4).result(timeout=JOIN_S)
        deq = _dequantize_params(m.params)
        with torch.inference_mode():
            ref = net.infer(deq, torch.tensor(prompt[None, :].astype(
                np.int32)), start_token=1, max_seq_len=4)[0].numpy()
        np.testing.assert_array_equal(got, ref.astype(np.int32))
    finally:
        b.stop(drain=False)


def test_parity_survives_concurrent_submitters(seqmodel):
    net, model = seqmodel
    b = ContinuousBatcher(model, SequenceConfig(**CFG), name="conc")
    results = {}
    lock = threading.Lock()

    def client(seed):
        rng = np.random.default_rng(seed)
        prompt = rng.integers(0, VOCAB, size=(int(rng.integers(1, 9)),))
        got = b.submit(prompt, max_new_tokens=4).result(timeout=JOIN_S)
        with lock:
            results[seed] = (np.asarray(prompt, np.int32), got)

    try:
        threads = [threading.Thread(target=client, args=(s,))
                   for s in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=JOIN_S)
        assert len(results) == 8
        for prompt, got in results.values():
            np.testing.assert_array_equal(
                got, _reference(net, model, prompt, 4))
    finally:
        b.stop(drain=False)


def test_submit_rejects_bad_prompts(seqmodel):
    _net, model = seqmodel
    b = ContinuousBatcher(model, SequenceConfig(**CFG), name="reject")
    try:
        with pytest.raises(ValueError, match="1-D"):
            b.submit(np.zeros((2, 3), np.int32))
        with pytest.raises(ValueError, match="non-empty"):
            b.submit(np.zeros((0,), np.int32))
        with pytest.raises(ValueError, match="integers"):
            b.submit(np.array([0.5, 1.5]))
        with pytest.raises(ValueError, match="max_prompt_len"):
            b.submit(np.zeros((9,), np.int32))
        with pytest.raises(ValueError, match="max_new_tokens"):
            b.submit(np.array([1, 2]), max_new_tokens=0)
    finally:
        b.stop(drain=False)


def test_non_sequence_model_rejected():
    class Plain:
        pass

    m = InferenceModel()
    m.model = Plain()
    with pytest.raises(TypeError, match="seq_init_carries"):
        ContinuousBatcher(m, SequenceConfig(**CFG), name="plain")


# -- zero post-warmup builds --------------------------------------------------


def test_zero_postwarmup_builds(seqmodel):
    """After ``warmup()`` (every grid cell, every admission width, the
    step), serving any mix of lengths and budgets builds no program: the
    cache only hits."""
    net, model = seqmodel
    b = ContinuousBatcher(model, SequenceConfig(**CFG), name="warm")
    try:
        b.warmup()
        before = dict(model.cache_stats)
        rng = np.random.default_rng(7)
        futs = [b.submit(rng.integers(0, VOCAB,
                                      size=(int(rng.integers(1, 9)),)),
                         max_new_tokens=int(rng.integers(1, 7)))
                for _ in range(12)]
        for f in futs:
            f.result(timeout=JOIN_S)
        assert model.cache_stats["misses"] == before["misses"]
        assert model.cache_stats["hits"] > before["hits"]
    finally:
        b.stop(drain=False)


def test_decode_worker_looks_up_each_program_once(seqmodel):
    """The decode worker fetches the step program once and a (batch,
    length) cell's prefill and admission programs at its first wave; later
    waves of the same cell go through no cache lookup."""
    net, model = seqmodel
    b = ContinuousBatcher(model, SequenceConfig(**CFG), name="once")
    try:
        b.warmup()
        before = dict(model.cache_stats)
        for i in range(5):  # five waves, each one request of length 3
            got = b.submit(np.asarray([i + 2, 3, 4]),
                           max_new_tokens=2).result(timeout=JOIN_S)
            np.testing.assert_array_equal(
                got, _reference(net, model, [i + 2, 3, 4], 2))
        assert model.cache_stats["misses"] == before["misses"]
        assert model.cache_stats["hits"] - before["hits"] == 3
    finally:
        b.stop(drain=False)


# -- resilience ---------------------------------------------------------------


def test_deadline_evicts_slot_mid_decode(seqmodel):
    net, model = seqmodel
    cfg = SequenceConfig(max_prompt_len=8, max_prefill_batch=2, slots=2,
                         max_new_tokens=200_000, start_token=1)
    metrics = ServingMetrics().for_model("dl")
    b = ContinuousBatcher(model, cfg, metrics=metrics, name="dl")
    try:
        b.warmup()
        fut = b.submit(np.array([1, 2, 3]), timeout_ms=400)
        with pytest.raises(DeadlineExceededError, match="mid-decode"):
            fut.result(timeout=60)
        assert metrics.seq_evicted("deadline").value >= 1
        got = b.submit(np.array([1, 2, 3]), max_new_tokens=3).result(
            timeout=60)
        np.testing.assert_array_equal(got, _reference(net, model,
                                                      np.array([1, 2, 3]), 3))
    finally:
        b.stop(drain=False)


def test_queued_request_sheds_on_expired_deadline(seqmodel):
    _net, model = seqmodel
    cfg = SequenceConfig(max_prompt_len=8, slots=1,
                         max_new_tokens=200_000, start_token=1)
    b = ContinuousBatcher(model, cfg, name="shed")
    try:
        b.warmup()
        hog = b.submit(np.array([1, 2]))
        assert _wait(lambda: b.queue_depth == 0 and b.pending_requests == 1)
        queued = b.submit(np.array([3, 4]), timeout_ms=150)
        with pytest.raises(DeadlineExceededError, match="admit"):
            queued.result(timeout=60)
        b.restart_worker("cleanup")
        with pytest.raises(FlushThreadRestartedError):
            hog.result(timeout=60)
    finally:
        b.stop(drain=False)


def test_restart_fails_only_inflight_queued_survive(seqmodel):
    net, model = seqmodel
    cfg = SequenceConfig(max_prompt_len=8, slots=1,
                         max_new_tokens=200_000, start_token=1)
    metrics = ServingMetrics().for_model("rs")
    b = ContinuousBatcher(model, cfg, metrics=metrics, name="rs")
    try:
        b.warmup()
        inflight = b.submit(np.array([5, 6, 7]))
        assert _wait(lambda: b.queue_depth == 0 and b.pending_requests == 1)
        queued = b.submit(np.array([2, 4]), max_new_tokens=3)
        b.restart_worker("test")
        with pytest.raises(FlushThreadRestartedError):
            inflight.result(timeout=60)
        np.testing.assert_array_equal(
            queued.result(timeout=JOIN_S),
            _reference(net, model, np.array([2, 4]), 3))
        assert metrics.seq_evicted("restart").value == 1
        assert metrics.watchdog_restarts.value == 1
    finally:
        b.stop(drain=False)


def test_queue_full_backpressure(seqmodel):
    _net, model = seqmodel
    cfg = SequenceConfig(max_prompt_len=8, slots=1, max_queue_size=2,
                         max_new_tokens=200_000, start_token=1)
    metrics = ServingMetrics().for_model("qf")
    b = ContinuousBatcher(model, cfg, metrics=metrics, name="qf")
    try:
        b.warmup()
        hog = b.submit(np.array([1]))
        assert _wait(lambda: b.queue_depth == 0 and b.pending_requests == 1)
        q1 = b.submit(np.array([2]), max_new_tokens=2)
        q2 = b.submit(np.array([3]), max_new_tokens=2)
        with pytest.raises(QueueFullError, match="decode queue"):
            b.submit(np.array([4]), max_new_tokens=2)
        assert metrics.seq_rejected.value == 1
        b.restart_worker("cleanup")
        with pytest.raises(FlushThreadRestartedError):
            hog.result(timeout=60)
        for f in (q1, q2):
            assert f.result(timeout=JOIN_S).shape == (2,)
    finally:
        b.stop(drain=False)


def test_step_fault_fails_live_slots_then_recovers(seqmodel):
    net, model = seqmodel
    b = ContinuousBatcher(model, SequenceConfig(**CFG), name="fault")
    try:
        b.warmup()
        chaos.arm_serving("predict_raises", times=1)
        fut = b.submit(np.array([1, 2, 3]), max_new_tokens=3)
        with pytest.raises(chaos.ChaosPredictError):
            fut.result(timeout=60)
        assert chaos.serving_hits("predict_raises") == 1
        got = b.submit(np.array([1, 2, 3]), max_new_tokens=3).result(
            timeout=60)
        np.testing.assert_array_equal(
            got, _reference(net, model, np.array([1, 2, 3]), 3))
    finally:
        b.stop(drain=False)


def test_flush_thread_death_detected_and_restarted(seqmodel):
    net, model = seqmodel
    b = ContinuousBatcher(model, SequenceConfig(**CFG), name="death")
    try:
        b.warmup()
        chaos.arm_serving("flush_thread_dies", times=1)
        doomed = b.submit(np.array([1, 2]), max_new_tokens=2)
        assert _wait(lambda: not b._worker.is_alive())
        assert chaos.serving_hits("flush_thread_dies") == 1
        assert b.check_flush_thread(stall_s=30.0) == "died"
        with pytest.raises(FlushThreadRestartedError):
            doomed.result(timeout=60)
        got = b.submit(np.array([1, 2]), max_new_tokens=2).result(timeout=60)
        np.testing.assert_array_equal(
            got, _reference(net, model, np.array([1, 2]), 2))
        assert b.check_flush_thread(stall_s=30.0) is None
    finally:
        b.stop(drain=False)


def test_stop_drain_finishes_queue(seqmodel):
    net, model = seqmodel
    b = ContinuousBatcher(model, SequenceConfig(**CFG), name="drain")
    futs = [b.submit(np.array([i + 1, i + 2]), max_new_tokens=2)
            for i in range(5)]
    b.stop(drain=True, timeout=JOIN_S)
    for i, f in enumerate(futs):
        np.testing.assert_array_equal(
            f.result(timeout=1),
            _reference(net, model, np.array([i + 1, i + 2]), 2))
    with pytest.raises(RuntimeError, match="stopped"):
        b.submit(np.array([1]))


def test_stop_no_drain_fails_queued(seqmodel):
    _net, model = seqmodel
    b = ContinuousBatcher(model, SequenceConfig(**CFG), name="nodrain")
    b.warmup()
    futs = [b.submit(np.array([1, 2]), max_new_tokens=2) for _ in range(6)]
    b.stop(drain=False, timeout=JOIN_S)
    for f in futs:
        assert f.done()
        try:
            assert f.result().shape == (2,)
        except RuntimeError as e:
            assert "stopped" in str(e)


# -- metrics ------------------------------------------------------------------


def test_seq_metrics_families_and_snapshot(seqmodel):
    net, model = seqmodel
    sm = ServingMetrics()
    metrics = sm.for_model("mm")
    b = ContinuousBatcher(model, SequenceConfig(**CFG), metrics=metrics,
                          name="mm")
    try:
        ref = _reference(net, model, np.array([1, 2, 3]), 3)
        got = b.submit(np.array([1, 2, 3]), max_new_tokens=3).result(
            timeout=JOIN_S)
        np.testing.assert_array_equal(got, ref)
        snap = metrics.snapshot()
        assert snap["seq_requests"] == 1
        assert snap["seq_tokens"] == 3
        assert snap["seq_prefills"] >= 1
        assert snap["seq_decode_steps"] >= 3
        assert snap["seq_evicted_max_new_tokens"] == 1
        assert snap["seq_latency_p50_s"] >= 0
        assert "seq_ttft_p95_s" in snap
        text = sm.render()
        for family in ("zoo_seq_requests_total", "zoo_seq_tokens_total",
                       "zoo_seq_decode_steps_total", "zoo_seq_queue_depth",
                       "zoo_seq_slots_live", "zoo_seq_evicted_total",
                       "zoo_seq_slot_occupancy_ratio",
                       "zoo_seq_time_to_first_token_seconds",
                       "zoo_seq_latency_seconds"):
            assert family in text, family
        assert 'zoo_seq_requests_total{model="mm"} 1' in text
    finally:
        b.stop(drain=False)


# -- the engine and HTTP ------------------------------------------------------


SEQ_CFG = dict(max_prompt_len=4, max_prefill_batch=1, slots=2,
               max_new_tokens=3, start_token=1)


@pytest.fixture(scope="module")
def seq_server():
    """A seq2seq registered with ``sequence=`` behind HTTP; module-scoped
    because registration warms the whole prefill grid."""
    port.init_nncontext(device="cpu")
    net = Seq2seqNet(12, 8, (8,), cell_type="lstm", name="s2s_http")
    model = InferenceModel()
    model.do_load_keras(net)
    engine = ServingEngine()
    engine.register(
        "s2s", model,
        example_input=[np.zeros((1, 4), np.int32), np.zeros((1, 3), np.int32)],
        config=BatcherConfig(max_batch_size=1, max_wait_ms=1.0),
        sequence=SequenceConfig(**SEQ_CFG))
    engine.register("dbl", _Doubler(), example_input=np.zeros((1, 3)),
                    config=BatcherConfig(max_batch_size=8, max_wait_ms=1.0))
    srv, _t = serve_http(engine, port=0)
    yield f"http://127.0.0.1:{srv.server_port}", engine, net, model
    srv.shutdown()
    srv.server_close()
    engine.shutdown()
    port.stop_nncontext()
    reset_name_counts()


class _Doubler:
    def do_predict(self, x):
        return np.asarray(x, np.float32) * 2.0


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST", headers={
        "Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=JOIN_S) as resp:
        return resp.status, dict(resp.headers), resp.read()


def _get_json(url):
    with urllib.request.urlopen(url, timeout=30) as resp:
        return resp.status, json.loads(resp.read())


def test_register_warms_the_whole_grid_and_generate_matches(seq_server):
    """``register(sequence=)`` built every program (grid, admission
    widths, step) and the predict bucket; ``generate`` and
    ``generate_async`` then build nothing and equal the single-request
    generate."""
    _base, engine, net, model = seq_server
    cfg = SequenceConfig(**SEQ_CFG)
    programs = [k for k in model._compiled if k[0] == "__prog__"]
    assert len(programs) == len(cfg.grid()) + len(cfg.batch_ladder()) + 1
    before = dict(model.cache_stats)
    for p, n in (([1, 2, 3], 3), ([4], 2), ([5, 6, 7, 8], 1)):
        got = engine.generate("s2s", np.asarray(p), max_new_tokens=n)
        np.testing.assert_array_equal(got, _reference(net, model, p, n))
    futs = [engine.generate_async("s2s", np.asarray([i + 1]),
                                  max_new_tokens=3) for i in range(4)]
    for i, f in enumerate(futs):
        np.testing.assert_array_equal(f.result(timeout=JOIN_S),
                                      _reference(net, model, [i + 1], 3))
    assert model.cache_stats["misses"] == before["misses"]
    # the predict path still serves teacher forcing
    logits = engine.predict("s2s", [np.zeros((1, 4), np.int32),
                                    np.ones((1, 3), np.int32)])
    assert logits.shape == (1, 3, 12)
    # the predict batcher's completion stage counts a flight until it has
    # resolved its futures: the count drains to 0 just after the answer
    assert _wait(lambda: engine.pending_requests == 0)


def test_engine_generate_errors(seq_server):
    _base, engine, _net, _model = seq_server
    with pytest.raises(ValueError, match="not registered for sequence"):
        engine.generate("dbl", np.array([1, 2]))
    with pytest.raises(KeyError):
        engine.generate("ghost", np.array([1]))
    with pytest.raises(ValueError, match="max_prompt_len"):
        engine.generate("s2s", np.arange(1, 6))


def test_register_sequence_without_decode_contract_leaves_engine_untouched():
    port.init_nncontext(device="cpu")
    try:
        net = Sequential([Dense(2, input_shape=(3,))])
        im = InferenceModel().do_load_keras(net)
        engine = ServingEngine()
        try:
            with pytest.raises(TypeError, match="seq_init_carries"):
                engine.register("plain", im, np.zeros((1, 3), np.float32),
                                sequence=SequenceConfig(**SEQ_CFG))
            assert engine.model_names() == []
        finally:
            engine.shutdown()
    finally:
        port.stop_nncontext()
        reset_name_counts()


def test_model_info_pins_signature_and_sequence_shape(seq_server):
    base, _engine, _net, _model = seq_server
    code, desc = _get_json(f"{base}/v1/models/s2s")
    assert code == 200
    info = desc["versions"][desc["latest"]]
    assert info["input_signature"] == {
        "inputs": [{"shape": [4], "dtype": "int32"},
                   {"shape": [3], "dtype": "int32"}], "multi": True}
    assert info["sequence"] == {"slots": 2, "max_prompt_len": 4,
                                "max_new_tokens": 3, "start_token": 1,
                                "eos_token": None,
                                "prompt_buckets": [1, 2, 4],
                                "prefill_batch_buckets": [1],
                                "queue_depth": 0}
    code, desc = _get_json(f"{base}/v1/models/dbl")
    assert "sequence" not in desc["versions"][desc["latest"]]


def test_generate_roundtrip_matches_engine_api(seq_server):
    base, engine, _net, _model = seq_server
    prompts = [[1, 2, 3], [4], [5, 6, 7, 8]]
    code, headers, body = _post(
        f"{base}/v1/models/s2s:generate",
        json.dumps({"prompts": prompts, "max_new_tokens": 2}).encode())
    assert code == 200
    assert len(headers["X-Zoo-Trace-Id"]) == 16
    seqs = json.loads(body)["sequences"]
    assert len(seqs) == 3
    for p, got in zip(prompts, seqs):
        expect = engine.generate("s2s", np.asarray(p), max_new_tokens=2)
        assert got == expect.tolist()


def test_generate_validation_400s(seq_server):
    base, _engine, _net, _model = seq_server
    for body in (b"not json",
                 json.dumps({"wrong": 1}).encode(),
                 json.dumps({"prompts": []}).encode(),
                 json.dumps({"prompts": [[]]}).encode(),
                 json.dumps({"prompts": "nope"}).encode(),
                 json.dumps({"prompts": [[0.5, 1.5]]}).encode(),
                 json.dumps({"prompts": [[1, 2, 3, 4, 5]]}).encode()):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base}/v1/models/s2s:generate", body)
        assert e.value.code == 400, body


def test_generate_on_non_sequence_model_is_400(seq_server):
    base, _engine, _net, _model = seq_server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{base}/v1/models/dbl:generate",
              json.dumps({"prompts": [[1, 2]]}).encode())
    assert e.value.code == 400
    assert b"sequence" in e.value.read()


def test_generate_unknown_model_is_404(seq_server):
    base, _engine, _net, _model = seq_server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{base}/v1/models/ghost:generate",
              json.dumps({"prompts": [[1]]}).encode())
    assert e.value.code == 404


def test_failed_sequence_warmup_unregisters_the_version():
    """A sequence warm-up that raises (on the card: a capture that fails)
    stops both batchers and leaves no trace of the version."""
    port.init_nncontext(device="cpu")

    class Broken(Seq2seqNet):
        def seq_init_carries(self, batch, device=None, dtype=torch.float32):
            raise RuntimeError("no carries")

    try:
        im = InferenceModel().do_load_keras(Broken(12, 8, (8,)))
        engine = ServingEngine()
        try:
            with pytest.raises(RuntimeError, match="no carries"):
                engine.register(
                    "broken", im,
                    example_input=[np.zeros((1, 4), np.int32)] * 2,
                    config=BatcherConfig(max_batch_size=1),
                    sequence=SequenceConfig(**SEQ_CFG))
            assert engine.model_names() == []
            assert engine.pending_requests == 0
        finally:
            engine.shutdown()
    finally:
        port.stop_nncontext()
        reset_name_counts()
