"""Profiling and its trace summary in the port: ``Estimator.set_profile``
(``torch.profiler`` over a window of steps, CPU activity here),
``common.trace_tools`` (``summarize_trace``, ``print_trace_summary``,
``top_ops`` over the ``*.pt.trace.json`` it writes, one parser under
both) and the step watchdog (``set_step_watchdog``). The JAX package's
``tests/test_trace_tools.py``, ``test_train_loop.py``'s two watchdog cases
and ``test_predictor_viz.py``'s profile-during-fit case, re-pointed at the
port on CPU traces.
"""

import logging
import os
import time

import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch as port
from analytics_zoo_tpu_torch.common.trace_tools import (
    _categorize,
    print_trace_summary,
    summarize_trace,
    top_ops,
)
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts


@pytest.fixture(autouse=True)
def _port_context():
    port.init_nncontext(device="cpu")
    yield
    port.stop_nncontext()
    reset_name_counts()


def _traced(log_dir, fn, reps=3):
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    fn()
    with profile(activities=[ProfilerActivity.CPU],
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        for _ in range(reps):
            fn()


def _mlp():
    from analytics_zoo_tpu_torch.keras.engine.topology import Sequential
    from analytics_zoo_tpu_torch.keras.layers import Dense

    m = Sequential(name="traced")
    m.add(Dense(32, activation="relu", input_shape=(16,)))
    m.add(Dense(2, activation="softmax"))
    return m


def test_set_profile_trace_summarizes(tmp_path, capsys):
    from analytics_zoo_tpu_torch.keras.optimizers import Adam

    rng = np.random.default_rng(0)
    x = rng.normal(size=(256, 16)).astype(np.float32)
    y = (x.sum(1) > 0).astype(np.int32)
    m = _mlp()
    m.compile(optimizer=Adam(lr=0.01), loss="sparse_categorical_crossentropy")
    est = m._get_estimator()
    log_dir = str(tmp_path / "trace")
    est.set_profile(log_dir, start_iteration=1, num_iterations=2)
    m.fit(x, y, batch_size=64, nb_epoch=2)
    assert est._profile is None  # one-shot

    summary = summarize_trace(log_dir)
    assert summary, "no planes parsed"
    lines = [line for plane in summary.values()
             for line in plane["lines"].values()]
    assert sum(line["total_ms"] for line in lines) > 0.0
    assert sum(line["events"] for line in lines) > 10
    cats = {c for line in lines for c in line["by_category"]}
    assert "gemm" in cats  # the Dense matmuls
    print_trace_summary(log_dir)
    out = capsys.readouterr().out
    assert "plane" in out and "ms" in out


def test_top_ops(tmp_path):
    """``top_ops`` gives per-op (name, total_ms, count) rows, sorted by
    time; an empty directory raises."""
    log_dir = str(tmp_path / "trace")
    a = torch.ones(128, 128)
    _traced(log_dir, lambda: (a @ a).sum())
    rows = top_ops(log_dir, line="thread", n=5, plane_substr="CPU")
    assert rows and len(rows) <= 5
    for name, ms, count in rows:
        assert isinstance(name, str) and name
        assert ms >= 0.0 and count >= 1
    assert [r[1] for r in rows] == sorted((r[1] for r in rows), reverse=True)
    with pytest.raises(FileNotFoundError):
        top_ops(str(tmp_path / "empty"))


def test_summarize_and_top_ops_agree(tmp_path):
    """Both views walk the trace through one parser: on the same trace
    and lines they report the same event count and total time."""
    log_dir = str(tmp_path / "trace")
    a = torch.ones(64, 64)
    _traced(log_dir, lambda: torch.tanh(a @ a).sum())
    summary = summarize_trace(log_dir)
    agg_events, agg_ms = 0, 0.0
    for pname, plane in summary.items():
        if "CPU" not in pname:
            continue
        for lname, line in plane["lines"].items():
            if "thread" in lname:
                agg_events += line["events"]
                agg_ms += line["total_ms"]
    assert agg_events > 0, "no host thread line parsed"
    rows = top_ops(log_dir, line="thread", n=10_000, plane_substr="CPU")
    assert sum(c for _, _, c in rows) == agg_events
    assert sum(ms for _, ms, _ in rows) == pytest.approx(agg_ms, rel=1e-9)


@pytest.mark.parametrize("name,cat", [
    ("flash_fwd_wgmma<64>", "flash"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "gemm"),
    ("sm80_xmma_gemm_i8i8_i32_f32_tn_n_tilesize128x128x64", "int8 gemm"),
    ("cutlass_80_tensorop_s8_i16832gemm_s8_128x128_64x3_tn", "int8 gemm"),
    ("_ZN7cutlass7Kernel2I57cutlass_80_tensorop_i16832gemm_s8_256x128_128x3_"
     "tn_align4EEvNT_6Para", "int8 gemm"),
    ("sm90_xmma_gemm_i8i32_i8i32_i32_tn_n_tilesize256x128x128_warpgroupsize"
     "2x1x1_execute_segment", "int8 gemm"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x256x64", "gemm"),
    ("ampere_sgemm_128x64_tn", "gemm"),
    ("aten::_int_mm", "int8 gemm"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "conv"),
    ("aten::mm", "gemm"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>",
     "elementwise"),
    ("void at::native::reduce_kernel<512, 1, ...>", "reduction"),
    ("Memcpy HtoD (Pageable -> Device)", "memcpy"),
    ("cudaLaunchKernel", "other"),
])
def test_kernel_names_fall_into_their_classes(name, cat):
    assert _categorize(name) == cat


# -- the step watchdog (tests/test_train_loop.py) ---------------------------


def test_step_watchdog_detects_stall_and_rearms(caplog):
    """A loop that stops advancing fires the watchdog once per episode
    (CRITICAL + callback), re-arms on progress, and stays quiet paused;
    polled on a fake clock (the live thread's timing is held by
    ``test_step_watchdog_via_estimator_train``)."""
    from analytics_zoo_tpu_torch.engine.estimator import _StepWatchdog
    from analytics_zoo_tpu_torch.engine.triggers import RunState

    rs = RunState()
    fired = []
    now = [0.0]
    wd = _StepWatchdog(rs, timeout_s=0.6, on_stall=lambda s: fired.append(
        s.iteration), clock=lambda: now[0])

    def poll(t):
        now[0] = t
        return wd.poll_once()

    with caplog.at_level(logging.CRITICAL, logger="analytics_zoo_tpu_torch"):
        for t in (0.2, 0.4, 0.6):
            rs.iteration += 1
            assert not poll(t)
        assert not poll(1.1)  # 0.5 s without a step
        assert poll(1.3) and fired == [rs.iteration]
        assert any("training stalled" in r.message for r in caplog.records)
        assert not poll(5.0)  # once per episode
        rs.iteration += 1
        assert not poll(5.1)
        assert poll(5.8) and len(fired) == 2
        wd.pause()
        rs.iteration += 1
        assert not poll(9.0) and not poll(20.0)
        wd.resume()
        assert not poll(20.5)  # the window re-armed on resume
        assert poll(21.2) and len(fired) == 3
    wd.start()
    assert wd._thread.is_alive()
    wd.stop()
    assert not wd._thread.is_alive()


def _watched_run(timeout_s, stall_s=0.0):
    """Estimator.train over 2 epochs of 4 steps with the watchdog armed;
    ``stall_s`` sleeps the data iterator once, before the first epoch's
    third step."""
    from analytics_zoo_tpu_torch.data.feature_set import ArrayFeatureSet
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.engine.triggers import MaxEpoch
    from analytics_zoo_tpu_torch.keras import objectives
    from analytics_zoo_tpu_torch.keras.optimizers import SGD

    stalls = [stall_s]

    class Slow(ArrayFeatureSet):
        def train_batches(self, *a, **k):
            for i, b in enumerate(super().train_batches(*a, **k)):
                if i == 2 and stalls:
                    time.sleep(stalls.pop())
                yield b

    rng = np.random.default_rng(9)
    x = rng.normal(size=(32, 8)).astype(np.float32)
    y = rng.integers(0, 3, 32).astype(np.int32)
    fired = []
    est = Estimator(_mlp_8(), SGD(0.05))
    est.set_step_watchdog(timeout_s, on_stall=lambda s: fired.append(
        s.iteration))
    est.train(Slow(x, y) if stall_s else ArrayFeatureSet(x, y),
              objectives.sparse_categorical_crossentropy,
              end_trigger=MaxEpoch(2), batch_size=8)
    assert est.run_state.epoch == 2
    return fired


def _mlp_8():
    from analytics_zoo_tpu_torch.keras.engine.topology import Sequential
    from analytics_zoo_tpu_torch.keras.layers import Dense

    m = Sequential(name="wd")
    m.add(Dense(3, activation="softmax", input_shape=(8,)))
    return m


def test_step_watchdog_via_estimator_train():
    """Silent through a healthy run; fires exactly once when the data
    iterator stalls the loop for twice its timeout, then re-arms (the run
    goes on to its end)."""
    assert _watched_run(120.0) == []
    assert _watched_run(1.5, stall_s=2 * 1.5) == [2]


# -- profiling during fit (tests/test_predictor_viz.py) ----------------------


def test_profile_trace_during_fit(tmp_path):
    from analytics_zoo_tpu_torch.keras.optimizers import Adam

    m = _mlp()
    m.compile(optimizer=Adam(lr=0.01), loss="sparse_categorical_crossentropy")
    m.set_profile(str(tmp_path / "trace"), start_iteration=1,
                  num_iterations=2)
    x = np.random.default_rng(0).random((64, 16), dtype=np.float32)
    y = (x.sum(1) > 8).astype(np.int32)
    m.fit(x, y, batch_size=8, nb_epoch=2)
    found = []
    for _root, _dirs, files in os.walk(tmp_path / "trace"):
        found.extend(f for f in files if f.endswith(".pt.trace.json"))
    assert found, "no profiler trace written"
