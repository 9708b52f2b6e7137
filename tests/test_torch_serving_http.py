"""The HTTP frontend (``serving.http``) on loopback: the shared contract
(JSON and ``.npy`` bodies, 400/404/429/503/504, ``Retry-After``, trace-id
and ``traceparent`` adoption and echo, the debug routes) held alike in the
JAX package and the port (every shared case runs once per package, on a
host model), the ``/metrics`` family names of the two engines after the
same traffic, and what only the port's layer does: columnar JSON for
multi-input models, ``:generate`` on a model without sequence serving,
and the cooperative-cache peek through its own tree codec.

Every HTTP call has its own timeout; no case sleeps on a guess."""

import importlib
import io
import json
import re
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

JOIN_S = 30
ROOTS = ["analytics_zoo_tpu", "analytics_zoo_tpu_torch"]


def _ns(root):
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        serving=mod("serving"), http=mod("serving.http"),
        quota=mod("serving.quota"), obs=mod("common.observability"))


class Doubler:
    def do_predict(self, x):
        return np.asarray(x, np.float32) * 2.0


class GateModel:
    def __init__(self):
        self.gate, self.entered = threading.Event(), threading.Event()

    def do_predict(self, x):
        self.entered.set()
        assert self.gate.wait(timeout=JOIN_S)
        return np.asarray(x, np.float32) * 2.0


def _start(P, models, **engine_kw):
    engine = P.serving.ServingEngine(**engine_kw)
    for name, model in models.items():
        engine.register(name, model, example_input=np.zeros((1, 3)),
                        config=P.serving.BatcherConfig(max_batch_size=8,
                                                       max_wait_ms=1.0))
    srv, _ = P.http.serve(engine, port=0)
    return f"http://127.0.0.1:{srv.server_port}", engine, srv


@pytest.fixture(params=ROOTS, ids=["jax", "port"])
def server(request):
    P = _ns(request.param)
    base, engine, srv = _start(P, {"dbl": Doubler()})
    yield base, engine, P
    srv.shutdown()
    srv.server_close()
    engine.shutdown()


def _post(url, body: bytes, headers=None):
    req = urllib.request.Request(url, data=body, headers=headers or {})
    with urllib.request.urlopen(req, timeout=JOIN_S) as resp:
        return resp.status, resp.headers, resp.read()


def _get(url):
    with urllib.request.urlopen(url, timeout=JOIN_S) as resp:
        return resp.status, resp.headers, resp.read()


def _payload(x=((1.0, 2.0, 3.0),)):
    return json.dumps({"instances": [list(r) for r in x]}).encode()


def test_predict_json_and_npy(server):
    base, _, _ = server
    x = [[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]]
    code, headers, body = _post(f"{base}/v1/models/dbl:predict",
                                _payload(x),
                                {"Content-Type": "application/json"})
    assert code == 200 and len(headers["X-Zoo-Trace-Id"]) == 16
    np.testing.assert_array_equal(json.loads(body)["predictions"],
                                  np.asarray(x) * 2.0)
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    buf = io.BytesIO()
    np.save(buf, a)
    code, headers, body = _post(
        f"{base}/v1/models/dbl:predict", buf.getvalue(),
        {"Content-Type": "application/x-npy", "Accept": "application/x-npy"})
    assert headers["Content-Type"] == "application/x-npy"
    np.testing.assert_array_equal(np.load(io.BytesIO(body)), a * 2.0)


def test_routes_404_and_malformed_400(server):
    base, _, _ = server
    assert _post(f"{base}/v1/models/dbl/versions/1:predict",
                 _payload())[0] == 200
    for path in ("/v1/models/ghost:predict",
                 "/v1/models/dbl/versions/9:predict", "/v1/nowhere"):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + path, _payload())
        assert e.value.code == 404, path
    for body in (b"not json", b'{"wrong": 1}',
                 json.dumps({"instances": [[1], [2, 3]]}).encode(),
                 json.dumps({"instances": [[1.0, 2.0]]}).encode()):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base}/v1/models/dbl:predict", body)
        assert e.value.code == 400, body


@pytest.mark.parametrize("root", ROOTS, ids=["jax", "port"])
def test_status_mapping_contract(root):
    P = _ns(root)
    S, sfe = P.serving, P.http.status_for_exception
    assert sfe(S.QueueFullError("full")) == 429
    assert sfe(S.ShedError("shed", retry_after_s=1.0)) == 429
    assert sfe(S.DeadlineExceededError("late")) == 504
    assert sfe(S.ModelNotFoundError("no model")) == 404
    assert sfe(KeyError("inside predict")) == 500
    assert sfe(ValueError("bad")) == 400
    assert sfe(RuntimeError("boom")) == 500
    assert sfe(S.DrainingError("drain", retry_after_s=1.0)) == 503


def test_quota_429_and_drain_503_carry_retry_after(server):
    base, engine, P = server
    engine.quota.configure(P.quota.QuotaConfig(
        tenants={"slowpoke": P.quota.TenantQuota(rate=0.001, burst=1)}))
    _post(f"{base}/v1/models/dbl:predict", _payload(),
          {"X-Zoo-Tenant": "slowpoke"})
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{base}/v1/models/dbl:predict", _payload(),
              {"X-Zoo-Tenant": "slowpoke"})
    assert e.value.code == 429
    assert re.fullmatch(r"\d+", e.value.headers["Retry-After"])
    engine.quota.configure(P.quota.QuotaConfig())
    engine.drain(5.0)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{base}/v1/models/dbl:predict", _payload())
    assert e.value.code == 503
    assert re.fullmatch(r"\d+", e.value.headers["Retry-After"])


@pytest.mark.parametrize("root", ROOTS, ids=["jax", "port"])
def test_deadline_is_504(root):
    """A request whose ``timeout_ms`` passes while the flush thread is held
    by an earlier one answers 504."""
    P = _ns(root)
    model = GateModel()
    base, engine, srv = _start(P, {"slow": model})
    try:
        first = {}
        t = threading.Thread(target=lambda: first.update(
            code=_post(f"{base}/v1/models/slow:predict", _payload())[0]))
        t.start()
        assert model.entered.wait(timeout=JOIN_S)
        late = {}

        def send_late():
            try:
                _post(f"{base}/v1/models/slow:predict", json.dumps(
                    {"instances": [[1.0, 2.0, 3.0]],
                     "timeout_ms": 1.0}).encode())
            except urllib.error.HTTPError as e:
                late["code"] = e.code

        t2 = threading.Thread(target=send_late)
        t2.start()
        assert _wait_until(lambda: engine.pending_requests >= 2)
        time.sleep(0.02)  # past the late request's 1 ms deadline
        model.gate.set()
        for th in (t, t2):
            th.join(timeout=JOIN_S)
            assert not th.is_alive()
        assert first["code"] == 200 and late["code"] == 504
    finally:
        model.gate.set()
        srv.shutdown()
        srv.server_close()
        engine.shutdown()


def _wait_until(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.002)
    return cond()


def test_trace_ids_and_traceparent_adopted_and_echoed(server):
    base, _, _ = server
    _, h, _ = _post(f"{base}/v1/models/dbl:predict", _payload(),
                    {"X-Zoo-Trace-Id": "deadbeefdeadbeef"})
    assert h["X-Zoo-Trace-Id"] == "deadbeefdeadbeef"
    tid = "aabbccdd00112233"
    tp = f"00-{'0' * 16}{tid}-{tid}-01"
    _, h, _ = _post(f"{base}/v1/models/dbl:predict", _payload(),
                    {"traceparent": tp})
    assert h["X-Zoo-Trace-Id"] == tid and h["traceparent"] == tp
    for junk in ("garbage", f"00-{'0' * 32}-{'0' * 16}-01"):
        _, h, _ = _post(f"{base}/v1/models/dbl:predict", _payload(),
                        {"traceparent": junk})
        fresh = h["X-Zoo-Trace-Id"]
        assert re.fullmatch(r"[0-9a-f]{16}", fresh) and fresh != tid
        assert h["traceparent"] == f"00-{'0' * 16}{fresh}-{fresh}-01"
    _, h, _ = _post(f"{base}/v1/models/dbl:predict", _payload(),
                    {"X-Zoo-Trace-Id": "1111111111111111",
                     "traceparent": tp})
    assert h["X-Zoo-Trace-Id"] == "1111111111111111"


def test_healthz_models_and_debug_routes(server):
    base, _, P = server
    tid = "feedfacecafe0123"
    _post(f"{base}/v1/models/dbl:predict", _payload(),
          {"X-Zoo-Trace-Id": tid})
    health = json.loads(_get(f"{base}/healthz")[2])
    assert health["status"] == "ok" and health["models"]["dbl"]["latest"] \
        == "1"
    desc = json.loads(_get(f"{base}/v1/models/dbl")[2])
    info = desc["versions"][desc["latest"]]
    assert info["input_signature"] == {
        "inputs": [{"shape": [3], "dtype": "float64"}], "multi": False}
    assert "dbl" in json.loads(_get(f"{base}/v1/models")[2])["models"]
    ring = json.loads(_get(f"{base}/v1/debug/flightrecorder")[2])
    mine = [r for r in ring["records"] if r["trace_id"] == tid]
    assert mine and mine[0]["outcome"] == "ok"
    slo = json.loads(_get(f"{base}/v1/debug/slo")[2])
    assert "availability:dbl" in {o["name"] for o in slo["objectives"]}
    tracer = P.obs.get_tracer()
    tracer.clear()
    tracer.enable()
    try:
        tid = "0123456789abcdef"
        _post(f"{base}/v1/models/dbl:predict", _payload(),
              {"X-Zoo-Trace-Id": tid})
        doc = json.loads(_get(f"{base}/v1/debug/traces/{tid}")[2])
        assert "serving.request" in [s["name"] for s in doc["spans"]]
    finally:
        tracer.disable()
        tracer.clear()


def _families(text):
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE ")}


# Families the JAX process registry may carry from tiers the port has not
# ported (registered by whatever else ran in the same test process).
# the JAX package's persistent AOT cache: the port keeps none
_UNPORTED = ("zoo_serving_aot_",)


def test_metrics_families_match_the_jax_engine_after_the_same_traffic():
    """The same traffic through a JAX and a port engine: the port's
    ``/metrics`` carries every family the JAX one does (but the AOT
    cache's, which the port does not keep) and nothing else, ``zoo_build_info`` with the port's
    labels and the inference-cache counters among them."""
    texts = {}
    for root in ROOTS:
        P = _ns(root)
        # registered on first use of either package's InferenceModel,
        # Estimator.train, CheckpointManager, sweep_stale,
        # CheckpointWatcher, streaming Pipeline, BatchJobRunner, the
        # flywheel's tap, trainer, label store and drift trackers or
        # train_distributed, which
        # another test in this process may or may not have made
        P.obs.inference_cache_counters()
        P.obs.training_metrics()
        P.obs.checkpoint_metrics()
        P.obs.checkpoint_sweep_counters()
        P.obs.hot_reload_metrics()
        P.obs.data_metrics()
        P.obs.batch_metrics()
        P.obs.capture_metrics()
        P.obs.flywheel_metrics()
        P.obs.label_metrics()
        P.obs.drift_metrics()
        P.obs.distributed_metrics()
        base, engine, srv = _start(P, {"dbl": Doubler()})
        try:
            for _ in range(3):
                _post(f"{base}/v1/models/dbl:predict", _payload())
            with pytest.raises(urllib.error.HTTPError):
                _post(f"{base}/v1/models/ghost:predict", _payload())
            texts[root] = _get(f"{base}/metrics")[2].decode()
        finally:
            srv.shutdown()
            srv.server_close()
            engine.shutdown()
    jax_fams = {f for f in _families(texts["analytics_zoo_tpu"])
                if not f.startswith(_UNPORTED)}
    port_fams = _families(texts["analytics_zoo_tpu_torch"])
    assert port_fams == jax_fams
    port = texts["analytics_zoo_tpu_torch"]
    assert re.search(r'zoo_build_info\{version="[^"]+",torch="[^"]+",'
                     r'cuda="[^"]+",device="cpu"\} 1', port)
    assert 'zoo_serving_executable_cache{model="dbl",event="hits"}' in port
    assert 'zoo_serving_requests_total{model="dbl"} 3' in port


@pytest.fixture
def port_server():
    P = _ns("analytics_zoo_tpu_torch")
    base, engine, srv = _start(
        P, {"dbl": Doubler()},
        result_cache=P.serving.ResultCacheConfig())
    yield base, engine, P
    srv.shutdown()
    srv.server_close()
    engine.shutdown()


def test_port_generate_is_501_and_cache_peek_uses_its_codec(port_server):
    """``:generate`` is ported: on a model registered without
    ``sequence=`` it answers 400 naming sequence serving (no longer 501;
    ``tests/test_torch_sequence_serving.py`` serves it), and the result
    cache never saw it. The cache peek goes through the port's codec."""
    from analytics_zoo_tpu_torch.serving.fabric.coopcache import (
        TREE_CONTENT_TYPE,
        decode_tree,
    )
    from analytics_zoo_tpu_torch.serving.result_cache import ResultCache

    base, engine, _ = port_server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{base}/v1/models/dbl:generate",
              json.dumps({"prompts": [[1, 2]]}).encode())
    assert e.value.code == 400
    assert "register with sequence=" in json.loads(e.value.read())["error"]
    assert engine.result_cache.stats()["misses"] == 0
    _, h, _ = _post(f"{base}/v1/models/dbl:predict", _payload())
    assert h["X-Zoo-Cache"] == "miss"
    key = ResultCache.key("dbl", "1", [np.asarray([[1.0, 2.0, 3.0]])])
    code, h, body = _get(f"{base}/v1/cache/{key}")
    assert code == 200 and h["Content-Type"] == TREE_CONTENT_TYPE
    np.testing.assert_array_equal(decode_tree(body),
                                  np.asarray([[2.0, 4.0, 6.0]], np.float32))
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(f"{base}/v1/cache/{'0' * 64}")
    assert e.value.code == 404


def test_port_multi_input_columnar_json(port_server):
    """A multi-input model takes ``{"inputs": [...]}``, one array per
    input; a wrong arity is a 400."""
    base, engine, P = port_server

    class Adder:
        def do_predict(self, xs):
            return np.asarray(xs[0], np.float32) + np.asarray(xs[1])

    engine.register("add", Adder(),
                    example_input=[np.zeros((1, 2), np.float32),
                                   np.zeros((1, 2), np.int32)],
                    config=P.serving.BatcherConfig(max_batch_size=4,
                                                   max_wait_ms=1.0))
    body = json.dumps({"inputs": [[[1.5, 2.5], [3.0, 4.0]],
                                  [[1, 2], [3, 4]]]}).encode()
    out = json.loads(_post(f"{base}/v1/models/add:predict", body)[2])
    np.testing.assert_array_equal(out["predictions"],
                                  [[2.5, 4.5], [6.0, 8.0]])
    for bad in ({"inputs": [[[1.0, 2.0]]]}, {"inputs": []},
                {"inputs": "x"}):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base}/v1/models/add:predict", json.dumps(bad).encode())
        assert e.value.code == 400, bad
