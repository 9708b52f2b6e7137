"""Serving resilience — admission control, the circuit breaker, the
flush-thread watchdog, the graceful drain, the serving chaos points and the
HTTP hardening — held alike in the JAX package and the port's copies: every
case runs once per package, on host models (numpy).

No case sleeps on a guess: a model that must be busy signals that it
entered predict; the sleeps that remain wait out a stated cooldown or
stall threshold, and every wait has its own bound."""

import importlib
import json
import socket
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

JOIN_S = 30


def _namespace(root):
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        serving=mod("serving"), chaos=mod("ft.chaos"),
        preemption=mod("ft.preemption"), metrics=mod("serving.metrics"),
        http=mod("serving.http"))


@pytest.fixture(params=["analytics_zoo_tpu", "analytics_zoo_tpu_torch"],
                ids=["jax", "port"])
def P(request):
    ns = _namespace(request.param)
    yield ns
    ns.chaos.reset()


class Doubler:
    def do_predict(self, x):
        return np.asarray(x, np.float32) * 2.0


class GateModel:
    """Blocks every predict until ``gate`` is set; ``entered`` tells the
    test that a flush is inside predict."""

    def __init__(self):
        self.gate = threading.Event()
        self.entered = threading.Event()

    def do_predict(self, x):
        self.entered.set()
        assert self.gate.wait(timeout=JOIN_S)
        return np.asarray(x, np.float32) * 2.0


def _wait_until(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.005)
    return cond()


def test_admission_controller_ewma_and_estimate(P):
    adm = P.serving.AdmissionController(alpha=0.5)
    assert adm.estimate_wait_s(3) is None
    adm.observe(0.1)
    assert adm.batch_seconds == pytest.approx(0.1)
    adm.observe(0.3)
    assert adm.batch_seconds == pytest.approx(0.2)
    assert adm.estimate_wait_s(3) == pytest.approx(0.6)
    assert adm.estimate_wait_s(0) == 0.0
    with pytest.raises(ValueError):
        P.serving.AdmissionController(alpha=0.0)


def test_admission_sheds_unmeetable_deadline(P):
    """With a measured service time and a backed-up queue, a request whose
    deadline cannot be met is shed at submit; one without a deadline is
    never shed."""
    S = P.serving
    model = GateModel()
    adm = S.AdmissionController()
    mm = P.metrics.ModelMetrics(model="adm")
    b = S.DynamicBatcher(model.do_predict,
                         S.BatcherConfig(max_batch_size=4, max_wait_ms=1.0),
                         metrics=mm, name="adm", admission=adm)
    try:
        x = np.ones((1, 3), np.float32)
        blocked = b.submit(x)
        adm.observe(10.0)
        with pytest.raises(S.ShedError) as e:
            b.submit(x, timeout_ms=50.0)
        assert e.value.retry_after_s > 0
        assert mm.shed("deadline_unmeetable").value == 1
        accepted = b.submit(x)
        model.gate.set()
        np.testing.assert_array_equal(blocked.result(timeout=JOIN_S), x * 2)
        np.testing.assert_array_equal(accepted.result(timeout=JOIN_S), x * 2)
    finally:
        model.gate.set()
        b.stop()


def test_admission_never_sheds_before_first_observation(P):
    """With no flush measured yet, a tight-deadline request is accepted and
    later fails with DeadlineExceededError, not a shed."""
    S = P.serving
    model = GateModel()
    b = S.DynamicBatcher(model.do_predict,
                         S.BatcherConfig(max_batch_size=1, max_wait_ms=1.0),
                         name="fresh", admission=S.AdmissionController())
    try:
        x = np.ones((1, 2), np.float32)
        blocked = b.submit(x)
        assert model.entered.wait(timeout=JOIN_S)
        doomed = b.submit(x, timeout_ms=1.0)
        time.sleep(0.02)  # past doomed's 1 ms deadline
        model.gate.set()
        np.testing.assert_array_equal(blocked.result(timeout=JOIN_S), x * 2)
        with pytest.raises(S.DeadlineExceededError):
            doomed.result(timeout=JOIN_S)
    finally:
        model.gate.set()
        b.stop()


def test_breaker_unit_cycle(P):
    S = P.serving
    cfg = S.BreakerConfig(min_samples=4, failure_ratio=0.5, cooldown_s=0.1)
    br = S.CircuitBreaker(cfg, name="unit")
    for ok in (True, True, False, False):
        br.record(ok)
    assert br.state == "open"
    with pytest.raises(S.CircuitOpenError) as e:
        br.allow()
    assert 0 < e.value.retry_after_s <= cfg.cooldown_s
    time.sleep(0.15)  # past the 0.1 s cooldown
    br.allow()
    assert br.state == "half_open"
    br.record(False)
    assert br.state == "open"
    time.sleep(0.15)
    br.allow()
    br.record(True)
    assert br.state == "closed"
    br.allow()


def test_breaker_needs_min_samples(P):
    br = P.serving.CircuitBreaker(P.serving.BreakerConfig(min_samples=8),
                                  name="warm")
    for _ in range(7):
        br.record(False)
    assert br.state == "closed"
    br.record(False)
    assert br.state == "open"


def test_breaker_opens_on_chaos_and_recloses_through_engine(P):
    """predict_raises four times opens the breaker (fast-fail 503 path);
    after the cooldown one probe succeeds and closes it."""
    S, chaos = P.serving, P.chaos
    engine = S.ServingEngine(resilience=S.ResilienceConfig(
        breaker=S.BreakerConfig(min_samples=4, failure_ratio=0.5,
                                cooldown_s=0.2),
        watchdog=False))
    try:
        engine.register("flaky", Doubler(), example_input=np.zeros((1, 3)),
                        config=S.BatcherConfig(max_batch_size=4,
                                               max_wait_ms=1.0))
        x = np.ones((1, 3), np.float32)
        chaos.arm_serving("predict_raises", times=4)
        for _ in range(4):
            with pytest.raises(chaos.ChaosPredictError):
                engine.predict("flaky", x)
        entry = engine.entry("flaky")
        assert entry.breaker.state == "open"
        mm = engine.metrics.for_model("flaky")
        assert mm.breaker_state.value == 2.0
        with pytest.raises(S.CircuitOpenError):
            engine.predict("flaky", x)
        assert mm.shed("breaker_open").value >= 1
        time.sleep(0.25)  # past the 0.2 s cooldown
        np.testing.assert_array_equal(engine.predict("flaky", x), x * 2.0)
        assert entry.breaker.state == "closed"
        assert mm.breaker_transition("open").value >= 1
        assert mm.breaker_transition("closed").value >= 1
        text = engine.metrics_text()
        assert 'zoo_serving_breaker_state{model="flaky"} 0' in text
    finally:
        engine.shutdown()


def test_watchdog_restarts_dead_flush_thread(P):
    """flush_thread_dies: the watchdog restores service and only the
    in-flight batch fails; the request queued behind it is served."""
    S, chaos = P.serving, P.chaos
    engine = S.ServingEngine(resilience=S.ResilienceConfig(
        watchdog_interval_s=0.02, breaker=None))
    try:
        chaos.arm_serving("flush_thread_dies", times=1)
        engine.register("m", Doubler(), example_input=np.zeros((1, 2)),
                        config=S.BatcherConfig(max_batch_size=1,
                                               max_wait_ms=1.0))
        x = np.ones((1, 2), np.float32)
        doomed = engine.predict_async("m", x)
        queued = engine.predict_async("m", x)
        with pytest.raises(S.FlushThreadRestartedError):
            doomed.result(timeout=JOIN_S)
        np.testing.assert_array_equal(queued.result(timeout=JOIN_S), x * 2)
        assert chaos.serving_hits("flush_thread_dies") == 1
        assert engine.metrics.for_model("m").watchdog_restarts.value == 1
        np.testing.assert_array_equal(engine.predict("m", x), x * 2.0)
    finally:
        engine.shutdown()


def test_watchdog_restarts_wedged_flush_thread(P):
    """A flush stuck in predict past the stall threshold is declared
    wedged: its batch fails at once and a new thread serves."""
    S, chaos = P.serving, P.chaos
    engine = S.ServingEngine(resilience=S.ResilienceConfig(
        watchdog_interval_s=0.02, watchdog_stall_s=0.15, breaker=None))
    try:
        chaos.arm_serving("predict_slow", times=1, sleep_s=2.0)
        engine.register("w", Doubler(), example_input=np.zeros((1, 2)),
                        config=S.BatcherConfig(max_batch_size=1,
                                               max_wait_ms=1.0))
        x = np.ones((1, 2), np.float32)
        t0 = time.monotonic()
        with pytest.raises(S.FlushThreadRestartedError):
            engine.predict_async("w", x).result(timeout=JOIN_S)
        assert time.monotonic() - t0 < 1.5  # not the 2 s sleep
        np.testing.assert_array_equal(engine.predict("w", x), x * 2.0)
        assert engine.metrics.for_model("w").watchdog_restarts.value == 1
    finally:
        engine.shutdown()


def test_drain_completes_queued_work_and_rejects_new(P):
    """Drain completes every accepted request while new submits fail fast
    with the 503-mapped DrainingError."""
    S = P.serving
    model = GateModel()
    engine = S.ServingEngine()
    try:
        engine.register("g", model, example_input=np.zeros((1, 2)),
                        config=S.BatcherConfig(max_batch_size=2,
                                               max_wait_ms=1.0))
        x = np.ones((1, 2), np.float32)
        futures = [engine.predict_async("g", x) for _ in range(3)]
        assert engine.pending_requests == 3
        report = {}
        t = threading.Thread(
            target=lambda: report.update(engine.drain(deadline_s=JOIN_S)))
        t.start()
        assert _wait_until(lambda: engine.state == "draining")
        with pytest.raises(S.DrainingError) as e:
            engine.predict("g", x)
        assert e.value.retry_after_s > 0
        model.gate.set()
        t.join(timeout=JOIN_S)
        assert not t.is_alive()
        assert report["complete"] and report["pending"] == 0
        assert engine.state == "drained"
        for f in futures:
            np.testing.assert_array_equal(f.result(timeout=JOIN_S), x * 2)
    finally:
        model.gate.set()
        engine.shutdown()


def test_drain_deadline_reports_pending_work(P):
    model = GateModel()
    engine = P.serving.ServingEngine()
    try:
        engine.register("stuck", model, example_input=np.zeros((1, 2)))
        engine.predict_async("stuck", np.ones((1, 2), np.float32))
        report = engine.drain(deadline_s=0.1)
        assert not report["complete"] and report["pending"] >= 1
        assert engine.state == "draining"
    finally:
        model.gate.set()
        engine.shutdown()


def test_preemption_signal_triggers_drain(P):
    """A preemption request (what SIGTERM sets) drains the engine; the port
    wires its own ft.preemption handler."""
    S = P.serving
    engine = S.ServingEngine()
    try:
        engine.register("p", Doubler(), example_input=np.zeros((1, 2)))
        handler = P.preemption.PreemptionHandler()
        _, waiter = S.install_drain_on_preemption(
            engine, handler=handler, deadline_s=5.0, shutdown=False)
        x = np.ones((1, 2), np.float32)
        np.testing.assert_array_equal(engine.predict("p", x), x * 2.0)
        handler.request()
        waiter.join(timeout=JOIN_S)
        assert not waiter.is_alive()
        assert engine.state == "drained"
        with pytest.raises(S.DrainingError):
            engine.predict("p", x)
    finally:
        engine.shutdown()


@pytest.fixture
def server(P):
    engine = P.serving.ServingEngine()
    engine.register("dbl", Doubler(), example_input=np.zeros((1, 3)),
                    config=P.serving.BatcherConfig(max_batch_size=8,
                                                   max_wait_ms=1.0))
    srv, _ = P.http.serve(engine, port=0, max_body_bytes=1 << 20)
    yield f"http://127.0.0.1:{srv.server_port}", srv, engine
    srv.shutdown()
    srv.server_close()
    engine.shutdown()


def _raw_request(port, request: bytes) -> bytes:
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(request)
        chunks = []
        while True:
            part = s.recv(65536)
            if not part:
                break
            chunks.append(part)
    return b"".join(chunks)


def _post(url, body: bytes):
    req = urllib.request.Request(url, data=body)
    with urllib.request.urlopen(req, timeout=10) as resp:
        return resp.status, resp.headers, resp.read()


@pytest.mark.parametrize("headers,code", [
    (b"Content-Type: application/json\r\nContent-Length: 1048577\r\n",
     b"413"),
    (b"", b"411"),
    (b"Content-Length: banana\r\n", b"400"),
], ids=["over_cap_413", "no_length_411", "bad_length_400"])
def test_body_length_contract(P, server, headers, code):
    """An over-cap body is refused from its headers alone, a missing or
    malformed Content-Length too; the server keeps serving."""
    base, srv, _ = server
    resp = _raw_request(srv.server_port,
                        b"POST /v1/models/dbl:predict HTTP/1.1\r\n"
                        b"Host: localhost\r\n" + headers + b"\r\n")
    assert resp.split(b"\r\n", 1)[0].split()[1] == code
    status, _, _ = _post(f"{base}/v1/models/dbl:predict",
                         json.dumps({"instances": [[1.0, 2.0, 3.0]]}).encode())
    assert status == 200


def test_healthz_flips_non200_and_predicts_get_retry_after(P, server):
    base, _, engine = server
    with urllib.request.urlopen(f"{base}/healthz", timeout=10) as resp:
        assert resp.status == 200
    engine.drain(deadline_s=5.0)
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{base}/healthz", timeout=10)
    assert e.value.code == 503
    assert json.loads(e.value.read())["status"] == "drained"
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{base}/v1/models/dbl:predict",
              json.dumps({"instances": [[1.0, 2.0, 3.0]]}).encode())
    assert e.value.code == 503
    assert int(e.value.headers["Retry-After"]) >= 1


def test_serving_chaos_arming_and_hit_accounting(P):
    chaos = P.chaos
    with pytest.raises(ValueError):
        chaos.arm_serving("not_a_point")
    chaos.arm_serving("predict_raises", times=2)
    for _ in range(2):
        with pytest.raises(chaos.ChaosPredictError):
            chaos.serving_chaos("predict_raises")
    chaos.serving_chaos("predict_raises")  # exhausted: no-op
    assert chaos.serving_hits("predict_raises") == 2
    chaos.serving_chaos("predict_slow")  # unarmed: no-op
    chaos.arm_serving("canary_errors", tag="m@2")
    chaos.serving_chaos("canary_errors", tag="m@1")  # other tag: no-op
    with pytest.raises(chaos.ChaosPredictError):
        chaos.serving_chaos("canary_errors", tag="m@2")
    chaos.disarm_serving()
    assert chaos.serving_hits("predict_raises") == 0
    assert not issubclass(chaos.FlushThreadDeath, Exception)
    assert issubclass(chaos.FlushThreadDeath, BaseException)


def test_serving_chaos_env_arming(P, monkeypatch):
    """``AZOO_SERVING_CHAOS`` arms a point for subprocess drills, with a
    hit budget."""
    chaos = P.chaos
    monkeypatch.setenv("AZOO_SERVING_CHAOS", "predict_raises")
    monkeypatch.setenv("AZOO_SERVING_CHAOS_TIMES", "1")
    with pytest.raises(chaos.ChaosPredictError):
        chaos.serving_chaos("predict_raises")
    chaos.serving_chaos("predict_raises")  # budget spent
    chaos.serving_chaos("predict_slow")    # not the armed point
