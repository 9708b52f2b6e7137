"""The port's horizontal serving tier: the preforked front door and its
engine workers (the cases of tests/test_frontdoor.py, on the port), plus
whole-slice parity with the JAX package and the refusal of an AOT cache
directory (the port keeps no persistent executable cache).

Workers are real subprocesses (``python -m
analytics_zoo_tpu_torch.serving.worker``) booted from
tests/_torch_frontdoor_spec.py: a numpy model for the routing, failover,
quota, metrics and drain cases, and a narrow port BERT served by the
port's ``InferenceModel`` on the CPU for the parity case, whose answers
through a 2-worker front door are held to the JAX ``InferenceModel``'s
within 1e-5 (float32). The boots share module-scoped front doors: one
2-worker door with tracing and a flight-dump directory, one 1-worker
door, one 2-worker door with chaos armed, and the BERT door.
"""

import io
import json
import os
import re
import signal
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from analytics_zoo_tpu_torch.common.observability import get_tracer
from analytics_zoo_tpu_torch.serving.frontdoor import (
    FrontDoor,
    FrontDoorConfig,
    merge_expositions,
)
from analytics_zoo_tpu_torch.serving.quota import TenantQuota
from analytics_zoo_tpu_torch.serving.worker import load_spec

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
SPEC_FILE = os.path.join(TESTS_DIR, "_torch_frontdoor_spec.py")
SPEC = SPEC_FILE + ":build_engine"
BERT_SPEC = SPEC_FILE + ":build_bert_engine"

PREDICT = "/v1/models/lin:predict"
BODY = json.dumps({"instances": [[1.0, 2.0, 3.0, 4.0]]}).encode()


def _post(base, path, body=BODY, headers=None, timeout=30):
    req = urllib.request.Request(
        base + path, data=body,
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, dict(resp.headers), resp.read()


def _get(base, path, timeout=60):
    with urllib.request.urlopen(base + path, timeout=timeout) as resp:
        return resp.status, dict(resp.headers), resp.read()


def _wait_live(fd, n, deadline_s=60.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        if fd.health()["live_workers"] >= n:
            return
        time.sleep(0.05)
    raise AssertionError(
        f"front door never reached {n} live workers: {fd.health()}")


@pytest.fixture(scope="module")
def fd2(tmp_path_factory):
    """The 2-worker front door shared by the numpy-spec cases, with
    tracing on (exported into the workers as ``AZOO_TRACE=1``) and a
    flight-dump directory set before construction (the recorder reads
    ``AZOO_FLIGHT_DIR`` when it is built). Destructive cases hand it back
    with both workers live."""
    flight_dir = str(tmp_path_factory.mktemp("flight"))
    tracer = get_tracer()
    tracer.clear()
    tracer.enable()
    old = os.environ.get("AZOO_FLIGHT_DIR")
    os.environ["AZOO_FLIGHT_DIR"] = flight_dir
    fd = FrontDoor(FrontDoorConfig(
        spec=SPEC, workers=2, heartbeat_interval_s=0.1,
        worker_boot_timeout_s=90, drain_deadline_s=10)).start()
    fd.flight_dir = flight_dir
    yield fd
    fd.shutdown()
    tracer.disable()
    tracer.clear()
    if old is None:
        os.environ.pop("AZOO_FLIGHT_DIR", None)
    else:
        os.environ["AZOO_FLIGHT_DIR"] = old


@pytest.fixture(scope="module")
def fd1():
    """A 1-worker front door: the bitwise-parity case, then the
    front-door drain (which leaves it draining)."""
    fd = FrontDoor(FrontDoorConfig(spec=SPEC, workers=1,
                                   worker_boot_timeout_s=90)).start()
    yield fd
    fd.shutdown()


# -- the spec contract ------------------------------------------------------


def test_load_spec_contract(tmp_path):
    """module:callable and /path/file.py:callable both resolve; junk
    specs fail loudly (a worker must die at boot, not serve nothing)."""
    fn = load_spec("json:dumps")
    assert fn is json.dumps
    spec_py = tmp_path / "myspec.py"
    spec_py.write_text("def build():\n    return 'built'\n")
    assert load_spec(f"{spec_py}:build")() == "built"
    for bad in ("no_colon", ":x", "mod:", "json:not_there",
                f"{spec_py}:missing"):
        with pytest.raises(ValueError):
            load_spec(bad)


def _aot_entry_points():
    """Every entry point that takes the JAX package's AOT cache directory,
    and the environment variable that enables it process-wide, as
    ``call(directory)``."""
    import analytics_zoo_tpu_torch as port
    from analytics_zoo_tpu_torch.batch import BatchPredictJob
    from analytics_zoo_tpu_torch.data.sources import ArraySource
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.serving import ServingEngine
    from analytics_zoo_tpu_torch.serving.fabric import FleetConfig

    def in_cpu_context(fn):
        def call(d):
            port.init_nncontext(device="cpu")
            try:
                return fn(d)
            finally:
                port.stop_nncontext()
        return call

    def env(d):
        os.environ["AZOO_AOT_CACHE_DIR"] = d
        try:
            return in_cpu_context(lambda _: InferenceModel())(d)
        finally:
            del os.environ["AZOO_AOT_CACHE_DIR"]

    return {
        "frontdoor-config": lambda d: FrontDoorConfig(spec=SPEC,
                                                      aot_cache_dir=d),
        "fleet-config": lambda d: FleetConfig(
            spec=SPEC, fleet_dir=os.path.dirname(d), host_id="a",
            aot_cache_dir=d),
        "inference-model": in_cpu_context(
            lambda d: InferenceModel(aot_cache_dir=d)),
        "set-aot-cache": in_cpu_context(
            lambda d: InferenceModel().set_aot_cache(d)),
        "watch-checkpoints": in_cpu_context(
            lambda d: ServingEngine().watch_checkpoints(
                "m", os.path.dirname(d), lambda path: None,
                example_input=np.zeros((1, 4), np.float32),
                aot_cache_dir=d)),
        "batch-predict-job": lambda d: BatchPredictJob(
            lambda x: x, ArraySource(np.zeros((4, 2), np.float32)),
            aot_cache_dir=d),
        "env-AZOO_AOT_CACHE_DIR": env,
    }


AOT_ENTRIES = ("batch-predict-job", "env-AZOO_AOT_CACHE_DIR",
               "fleet-config", "frontdoor-config", "inference-model",
               "set-aot-cache", "watch-checkpoints")


@pytest.mark.parametrize("entry", AOT_ENTRIES)
def test_aot_cache_dir_raises_naming_a4(tmp_path, entry):
    """The decision on the JAX package's persistent AOT cache: the port
    keeps none (its executables are CUDA graphs, which PyTorch cannot
    save, and capturing them again costs little beside a boot). Each entry
    point that takes a cache directory, and ``AZOO_AOT_CACHE_DIR`` set in
    the environment, refuses it before any worker boots or model loads,
    naming the reason and the measurements it rests on; the directory is
    never created.

    The JAX package's ``tests/test_inference_aot_cache.py`` cases:
    ``test_warm_restart_performs_zero_compiles`` becomes this refusal (a
    restart captures again); ``test_warmup_overflow_is_detected_and_counted``
    and ``test_no_overflow_when_cache_fits_the_ladder`` are mirrored by
    ``tests/test_torch_serving_engine.py`` (``warmup_overflows`` and the
    ``warmup_overflow`` counter); the corrupted-entry fallback, entries of
    structurally different models, the key's argument structure and the
    missing-key miss are not applicable: no entry is ever written or
    keyed."""
    from analytics_zoo_tpu_torch.inference.inference_model import (
        NO_AOT_CACHE,
    )

    entries = _aot_entry_points()
    assert sorted(entries) == list(AOT_ENTRIES)
    d = str(tmp_path / "aot")
    with pytest.raises(NotImplementedError,
                       match="no persistent executable cache") as exc:
        entries[entry](d)
    assert NO_AOT_CACHE in str(exc.value)
    assert "H100" in str(exc.value) and "0.762 s of capture" in str(
        exc.value)
    assert not os.path.exists(d)
    assert "AZOO_AOT_CACHE_DIR" not in os.environ


# -- predict + routing ------------------------------------------------------


def test_predict_json_and_npy_through_front_door(fd2):
    code, headers, body = _post(fd2.url, PREDICT)
    assert code == 200
    assert headers["X-Zoo-Worker"] in ("0", "1")
    assert len(headers["X-Zoo-Trace-Id"]) == 16
    preds = np.asarray(json.loads(body)["predictions"])
    assert preds.shape == (1, 3)

    x = np.arange(8, dtype=np.float32).reshape(2, 4)
    buf = io.BytesIO()
    np.save(buf, x)
    code, headers, body = _post(
        fd2.url, PREDICT, buf.getvalue(),
        {"Content-Type": "application/x-npy", "Accept": "application/x-npy"})
    assert code == 200
    assert headers["Content-Type"] == "application/x-npy"
    assert np.load(io.BytesIO(body)).shape == (2, 3)


def test_replicas_agree_bitwise(fd2):
    """Deterministic spec weights → both workers return identical bytes
    for the same input (what makes transparent retry sound)."""
    by_worker = {}
    for _ in range(16):
        _c, headers, body = _post(fd2.url, PREDICT)
        by_worker[headers["X-Zoo-Worker"]] = body
        if len(by_worker) == 2:
            break
    assert len(by_worker) == 2, "keyless spread never hit both workers"
    a, b = by_worker.values()
    assert a == b


def test_sticky_route_key_pins_one_worker(fd2):
    for key in ("tenant-a", "tenant-b", "sess-42"):
        seen = {
            _post(fd2.url, PREDICT,
                  headers={"X-Zoo-Route-Key": key})[1]["X-Zoo-Worker"]
            for _ in range(6)}
        assert len(seen) == 1, (key, seen)


def test_keyless_requests_spread_evenly(fd2):
    counts = {"0": 0, "1": 0}
    for _ in range(20):
        counts[_post(fd2.url, PREDICT)[1]["X-Zoo-Worker"]] += 1
    # the golden-ratio sequence gives N/len(ring) ± 1 per window of N
    assert abs(counts["0"] - counts["1"]) <= 2, counts


def test_models_listing_and_healthz(fd2):
    code, headers, body = _get(fd2.url, "/v1/models")
    assert code == 200 and "lin" in json.loads(body)["models"]
    assert headers["X-Zoo-Worker"] in ("0", "1")
    code, _h, body = _get(fd2.url, "/healthz")
    health = json.loads(body)
    assert code == 200 and health["status"] == "ok"
    assert health["live_workers"] == 2
    assert set(health["workers"]) == {"0", "1"}


def test_unknown_paths_404(fd2):
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(fd2.url, "/nope")
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(fd2.url, "/v1/frobnicate", b"{}")
    assert e.value.code == 404


def test_worker_errors_proxied_verbatim(fd2):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(fd2.url, "/v1/models/ghost:predict")
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(fd2.url, PREDICT, b"not json")
    assert e.value.code == 400


def test_trace_id_adopted_across_the_hop(fd2):
    _c, headers, _b = _post(fd2.url, PREDICT,
                            headers={"X-Zoo-Trace-Id": "deadbeefdeadbeef"})
    assert headers["X-Zoo-Trace-Id"] == "deadbeefdeadbeef"


# -- parity -----------------------------------------------------------------


def test_single_worker_front_door_is_bitwise_identical_to_direct(fd1):
    """For the same request, a 1-worker front door returns byte-for-byte
    what a direct ServingEngine+serve() returns (JSON and npy bodies):
    the tier adds fan-out, not semantics."""
    from analytics_zoo_tpu_torch.serving.http import serve

    engine = load_spec(SPEC)()
    srv, _t = serve(engine, port=0)
    direct = f"http://127.0.0.1:{srv.server_port}"
    try:
        for body, headers in [
            (BODY, {"Content-Type": "application/json"}),
            (json.dumps({"instances": [[0.5, -1.5, 2.0, 0.0],
                                       [9.0, 8.0, 7.0, 6.0]]}).encode(),
             {"Content-Type": "application/json"}),
        ]:
            _c1, _h1, direct_body = _post(direct, PREDICT, body, headers)
            _c2, _h2, fd_body = _post(fd1.url, PREDICT, body, headers)
            assert direct_body == fd_body
        x = np.linspace(-1, 1, 12).astype(np.float32).reshape(3, 4)
        buf = io.BytesIO()
        np.save(buf, x)
        npy_headers = {"Content-Type": "application/x-npy",
                       "Accept": "application/x-npy"}
        _c, _h, direct_npy = _post(direct, PREDICT, buf.getvalue(),
                                   npy_headers)
        _c, _h, fd_npy = _post(fd1.url, PREDICT, buf.getvalue(), npy_headers)
        assert direct_npy == fd_npy
    finally:
        srv.shutdown()
        engine.shutdown()


@pytest.fixture(scope="module")
def bert_weights(tmp_path_factory):
    """A narrow JAX BERT's perturbed weights, carried into the port's net
    with ``load_jax_params`` and saved once with ``save_weights``: every
    worker loads this file, none draws its own."""
    import jax

    import analytics_zoo_tpu_torch as port
    from analytics_zoo_tpu.inference.inference_model import (
        InferenceModel as JaxInferenceModel,
    )
    from analytics_zoo_tpu.tfpark.bert import BERTClassifierNet as JaxBERT
    from analytics_zoo_tpu_torch.interop import load_jax_params
    from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts

    sys.path.insert(0, TESTS_DIR)
    import _torch_frontdoor_spec as spec

    jnet = JaxBERT(num_classes=spec.BERT_CLASSES, **spec.BERT_CFG)
    jnet.compute_dtype = None
    jim = JaxInferenceModel().do_load_keras(jnet)
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0.0, 0.05, a.shape)
                   ).astype(np.float32), jim.params)
    jim.params = jax.tree_util.tree_map(jax.numpy.asarray, params)
    port.init_nncontext(device="cpu")
    try:
        net = spec.build_bert_net()
        load_jax_params(net, params)
        path = str(tmp_path_factory.mktemp("bert") / "weights")
        net.save_weights(path)
    finally:
        port.stop_nncontext()
        reset_name_counts()
    return path, jim


def _bert_requests(seed, batch=4, seq=128, vocab=50):
    rng = np.random.default_rng(seed)
    lens = np.array([seq, 90, 64, 3])[:batch]
    mask = (np.arange(seq)[None, :] < lens[:, None]).astype(np.float32)
    ids = (rng.integers(1, vocab, (batch, seq)) * mask).astype(np.int32)
    types = (np.arange(seq)[None, :] >= lens[:, None] // 2).astype(np.int32)
    return [ids, types, mask]


def test_front_door_bert_matches_jax_inference_model(bert_weights):
    """Whole-slice parity: a narrow BERT carried over from the JAX
    package, served by the port's InferenceModel in two front-door
    workers, answers as the JAX InferenceModel.do_predict does on the
    same inputs (float32, atol 1e-5), and the two replicas agree
    bitwise."""
    path, jim = bert_weights
    fd = FrontDoor(FrontDoorConfig(
        spec=BERT_SPEC, workers=2, worker_boot_timeout_s=120,
        worker_env={"AZOO_TEST_BERT_WEIGHTS": path})).start()
    try:
        by_worker = {}
        for seed in (10, 11):
            x = _bert_requests(seed)
            body = json.dumps({"inputs": [a.tolist() for a in x]}).encode()
            expected = np.asarray(jim.do_predict(x))
            for _ in range(8):
                _c, headers, raw = _post(fd.url, "/v1/models/bert:predict",
                                         body, timeout=120)
                got = np.asarray(json.loads(raw)["predictions"], np.float32)
                assert got.shape == expected.shape == (4, 3)
                np.testing.assert_allclose(got, expected, rtol=0, atol=1e-5)
                by_worker.setdefault(seed, {})[headers["X-Zoo-Worker"]] = raw
        for seed, bodies in by_worker.items():
            assert set(bodies) == {"0", "1"}, bodies.keys()
            a, b = bodies.values()
            assert a == b
    finally:
        fd.shutdown()


# -- failover ---------------------------------------------------------------


def test_sigkill_worker_mid_load_zero_client_errors(fd2):
    """SIGKILL one worker while requests flow: every request still gets
    a 2xx (transparent retry), the dead slot's keys remap, the slot is
    respawned with a fresh pid, rejoins the ring, and sticky keys
    migrate back to it."""
    _wait_live(fd2, 2)
    # find a route key that lands on worker 0 (the victim)
    key = next(k for k in (f"key-{i}" for i in range(64))
               if _post(fd2.url, PREDICT,
                        headers={"X-Zoo-Route-Key": k}
                        )[1]["X-Zoo-Worker"] == "0")
    victim_pid = fd2.worker_pids()["0"]

    errors = []
    stop = threading.Event()

    def client():
        while not stop.is_set():
            try:
                code, _h, _b = _post(fd2.url, PREDICT, timeout=30)
                if code != 200:
                    errors.append(code)
            except urllib.error.HTTPError as e:
                errors.append(e.code)
            except OSError as e:  # pragma: no cover — would fail below
                errors.append(str(e))
            time.sleep(0.01)

    threads = [threading.Thread(target=client) for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.3)
    os.kill(victim_pid, signal.SIGKILL)
    # keys remap immediately: the victim's sticky key now serves from 1
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        _c, headers, _b = _post(fd2.url, PREDICT,
                                headers={"X-Zoo-Route-Key": key})
        if headers["X-Zoo-Worker"] == "1":
            break
    assert headers["X-Zoo-Worker"] == "1", "key never remapped off the corpse"
    _wait_live(fd2, 2)
    time.sleep(0.3)
    stop.set()
    for t in threads:
        t.join()
    assert not errors, f"clients saw errors during worker kill: {errors}"
    assert fd2.worker_pids()["0"] != victim_pid, "slot 0 was not respawned"
    # ...and the deterministic ring hands the key back to the new worker
    deadline = time.monotonic() + 10
    back = None
    while time.monotonic() < deadline:
        back = _post(fd2.url, PREDICT,
                     headers={"X-Zoo-Route-Key": key})[1]["X-Zoo-Worker"]
        if back == "0":
            break
        time.sleep(0.05)
    assert back == "0", "sticky key never migrated back after rejoin"


def test_chaos_worker_exit_is_invisible_to_clients():
    """AZOO_FT_CHAOS=frontdoor_worker_exit hard-kills a worker inside
    its predict path (os._exit mid-request). The front door must absorb
    it: retry on the live worker, respawn the corpse."""
    fd = FrontDoor(FrontDoorConfig(
        spec=SPEC, workers=2, heartbeat_interval_s=0.1,
        worker_boot_timeout_s=90,
        worker_env={"AZOO_FT_CHAOS": "frontdoor_worker_exit",
                    "AZOO_FT_CHAOS_SKIP": "5"})).start()
    try:
        pids_before = fd.worker_pids()
        # sticky key: all requests hit one worker until it dies on its
        # 6th predict; the retry and remap land on the other worker
        # (keyless traffic would march both workers to their chaos limit
        # in lockstep and empty the ring)
        codes = []
        for _ in range(10):
            codes.append(_post(
                fd.url, PREDICT,
                headers={"X-Zoo-Route-Key": "chaos-key"})[0])
            time.sleep(0.2)
        assert codes == [200] * 10, codes
        _wait_live(fd, 2)
        # at least one worker died to chaos and was respawned
        assert fd.worker_pids() != pids_before
    finally:
        fd.shutdown()


# -- quota: single authority ------------------------------------------------


def test_quota_enforced_globally_not_per_worker(fd2):
    """burst=5 across a 2-worker tier → exactly 5 admits no matter how
    the requests spread; per-worker enforcement would admit up to 10.
    429s carry integer Retry-After (the HTTP contract)."""
    fd2.quota.set_quota("acme", TenantQuota(rate=0.001, burst=5))
    try:
        ok, rejected = 0, 0
        for _ in range(10):
            try:
                _post(fd2.url, PREDICT, headers={"X-Zoo-Tenant": "acme"})
                ok += 1
            except urllib.error.HTTPError as e:
                assert e.code == 429
                assert re.fullmatch(r"\d+", e.headers["Retry-After"])
                rejected += 1
        assert (ok, rejected) == (5, 5)
        text = fd2.metrics_text()
        assert "zoo_frontdoor_quota_rejections_total" in text
    finally:
        fd2.quota.set_quota("acme", None)


def test_admin_quota_applies_at_front_door_others_broadcast(fd2):
    code, _h, body = _post(
        fd2.url, "/v1/admin/rollout",
        json.dumps({"action": "quota", "tenant": "q-t", "rate": 2.0,
                    "burst": 4}).encode())
    assert code == 200
    assert json.loads(body)["quota"]["tenants"]["q-t"]["burst"] == 4.0
    fd2.quota.set_quota("q-t", None)
    # non-quota admin actions broadcast to every worker replica
    code, _h, body = _post(
        fd2.url, "/v1/admin/rollout",
        json.dumps({"action": "weights", "model": "lin",
                    "weights": {"1": 1.0}}).encode())
    assert code == 200
    replies = json.loads(body)["workers"]
    assert set(replies) == {"0", "1"}
    assert all(r["status"] == 200 for r in replies.values())


# -- merged metrics ---------------------------------------------------------


def test_merged_metrics_families_exactly_once(fd2):
    _post(fd2.url, PREDICT)
    _c, headers, body = _get(fd2.url, "/metrics")
    assert headers["Content-Type"].startswith("text/plain")
    text = body.decode()
    helps = [l.split(" ", 3)[2] for l in text.splitlines()
             if l.startswith("# HELP ")]
    assert len(helps) == len(set(helps)), (
        "duplicated HELP headers: "
        f"{sorted(h for h in helps if helps.count(h) > 1)}")
    # every worker contributed its engine families, worker-labeled
    for slot in ("0", "1"):
        assert f'zoo_serving_requests_total{{worker="{slot}"' in text
        assert f'zoo_process_rss_bytes{{worker="{slot}"}}' in text
        assert f'zoo_process_open_fds{{worker="{slot}"}}' in text
    # the front door's own process gauges ride along
    assert 'zoo_process_rss_bytes{worker="frontdoor"}' in text
    # and its fan-out families are present un-merged
    assert "zoo_frontdoor_workers_alive 2" in text
    assert 'zoo_frontdoor_requests_total{worker=' in text
    # text-format grammar: each family's samples are one contiguous block
    current = None
    seen_done = set()
    for line in text.splitlines():
        if line.startswith("# HELP "):
            name = line.split(" ", 3)[2]
            assert name not in seen_done, f"family {name} split into blocks"
            if current is not None:
                seen_done.add(current)
            current = name


def test_merge_expositions_unit():
    a = ("# HELP m_total things\n# TYPE m_total counter\n"
         "m_total 3\n"
         "# HELP s latency\n# TYPE s summary\n"
         's{quantile="0.5"} 1.0\ns_sum 2.0\ns_count 4\n')
    b = ("# HELP m_total things\n# TYPE m_total counter\n"
         'm_total{k="v"} 5\n')
    out = merge_expositions([("0", a), ("1", b)])
    assert out.count("# HELP m_total") == 1
    assert 'm_total{worker="0"} 3' in out
    assert 'm_total{worker="1",k="v"} 5' in out
    assert 's_sum{worker="0"} 2.0' in out
    # samples of m_total stay contiguous despite coming from two workers
    lines = out.splitlines()
    idx = [i for i, l in enumerate(lines) if l.startswith("m_total{")]
    assert idx == list(range(idx[0], idx[0] + 2))


def test_merge_expositions_matches_the_jax_package():
    """The merge is the JAX package's, byte for byte."""
    from analytics_zoo_tpu.serving.frontdoor import (
        merge_expositions as jax_merge,
    )

    a = ("# HELP m_total things\n# TYPE m_total counter\n"
         "m_total 3\n"
         "# HELP s latency\n# TYPE s summary\n"
         's{quantile="0.5"} 1.0 # {trace_id="aabbccdd00112233"} 1.0\n'
         "s_sum 2.0\ns_count 4\n")
    b = ("# HELP m_total things\n# TYPE m_total counter\n"
         'm_total{k="v"} 5\n')
    parts = [("0", a), ("1", b)]
    assert merge_expositions(parts) == jax_merge(parts)


def test_build_info_exactly_once_per_process_in_merged_scrape(fd2):
    """zoo_build_info appears with ONE HELP/TYPE header and one sample
    per process (frontdoor + each worker), every sample valued 1 with
    the port's version labels."""
    _post(fd2.url, PREDICT)
    text = _get(fd2.url, "/metrics")[2].decode()
    assert text.count("# HELP zoo_build_info") == 1
    assert text.count("# TYPE zoo_build_info") == 1
    samples = [l for l in text.splitlines()
               if l.startswith("zoo_build_info{")]
    by_worker = {re.search(r'worker="([^"]+)"', l).group(1): l
                 for l in samples}
    assert set(by_worker) == {"frontdoor", "0", "1"}
    for line in samples:
        assert line.endswith(" 1")
        for key in ("version=", "torch=", "cuda=", "device="):
            assert key in line, line


def test_build_info_never_creates_a_cuda_context(monkeypatch):
    """A process that has not initialised CUDA (the front door, the fleet
    door) labels its build info ``no-context`` and never asks for the
    card's name, which would create a context."""
    import torch

    from analytics_zoo_tpu_torch.common import observability as obs

    def boom(*a, **k):
        raise AssertionError("asked for the card's name")

    monkeypatch.setattr(obs, "_build_info_labels", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "get_device_name", boom)
    assert obs._build_info_values()["device"] == "no-context"
    monkeypatch.setattr(obs, "_build_info_labels", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert obs._build_info_values()["device"] == "cpu"


def test_build_info_names_the_card_at_the_scrape_after_cuda_starts(
        monkeypatch):
    """While the device label reads ``no-context`` it is resolved again
    at every scrape: a process that initialises CUDA after its engine was
    built names the card from its next scrape on, in one sample."""
    import re

    import torch

    from analytics_zoo_tpu_torch.common import observability as obs

    monkeypatch.setattr(obs, "_build_info_labels", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a, **k: "Card X")
    reg = obs.MetricsRegistry()
    obs.build_info(reg)

    def devices():
        return re.findall(r'^zoo_build_info\{.*device="([^"]*)"\} 1$',
                          reg.render(), re.M)

    assert devices() == ["no-context"]
    obs.refresh_process_metrics(reg)
    assert devices() == ["no-context"]
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    obs.refresh_process_metrics(reg)
    assert devices() == ["Card X"]
    obs.refresh_process_metrics(reg)
    assert devices() == ["Card X"]


def test_merge_expositions_preserves_exemplars():
    """The worker-label injection must not mangle an OpenMetrics
    exemplar suffix: the suffix survives verbatim, after the injected
    label."""
    a = ("# HELP s latency\n# TYPE s summary\n"
         's{quantile="0.5"} 1.0 # {trace_id="aabbccdd00112233"} 1.0\n'
         "s_sum 2.0\ns_count 4\n")
    out = merge_expositions([("0", a)])
    assert ('s{worker="0",quantile="0.5"} 1.0 '
            '# {trace_id="aabbccdd00112233"} 1.0') in out


# -- ops plane: fleet traces, flight dumps ----------------------------------


def test_fleet_merged_trace_is_one_timeline(fd2):
    """One request through the front door yields ONE merged trace:
    proxy spans from the front door process and serving spans from the
    worker subprocess, on one wall-aligned timeline, with the clock
    anchors reported rather than hidden — and the chrome export splits
    processes into pids for Perfetto."""
    _wait_live(fd2, 2)
    tid = "ab12cd34ef567890"
    code, headers, _b = _post(fd2.url, PREDICT,
                              headers={"X-Zoo-Trace-Id": tid})
    assert code == 200 and headers["X-Zoo-Trace-Id"] == tid

    _c, _h, body = _get(fd2.url, "/v1/debug/traces")
    index = json.loads(body)
    assert index["enabled"] is True
    assert tid in index["traces"]
    assert "frontdoor" in index["traces"][tid]["workers"]

    _c, _h, body = _get(fd2.url, f"/v1/debug/traces/{tid}")
    doc = json.loads(body)
    assert doc["trace_id"] == tid
    workers = {s["worker"] for s in doc["spans"]}
    assert "frontdoor" in workers, doc["spans"]
    assert workers & {"0", "1"}, "no spans collected from any worker"
    names = {s["name"] for s in doc["spans"]}
    assert "frontdoor.proxy" in names
    assert "serving.request" in names
    starts = [s["wall_start"] for s in doc["spans"]]
    assert starts == sorted(starts), "merged spans not wall-ordered"
    assert len(doc["anchors"]) >= 2  # frontdoor + >=1 worker process
    assert "skew" in doc["note"]

    _c, _h, body = _get(fd2.url, f"/v1/debug/traces/{tid}?format=chrome")
    chrome = json.loads(body)
    pids = {e["pid"] for e in chrome["traceEvents"]}
    assert "frontdoor" in pids and len(pids) >= 2
    assert all(e["args"]["trace_id"] == tid for e in chrome["traceEvents"])

    # the operator CLI renders the merged body end to end
    sys.path.insert(0, os.path.join(os.path.dirname(TESTS_DIR), "scripts"))
    import trace_dump
    out = trace_dump.dump_merged(doc)
    assert tid in out and "frontdoor" in out and "serving.request" in out


def test_sigkill_worker_dumps_flight_ring_at_front_door(fd2):
    """SIGKILL a worker mid-load: the front door's own recorder — the
    only survivor that saw the requests — writes an atomic dump whose
    records include the in-flight requests, and the dump passes CRC
    verification. Either trigger is a pass: the request that hits the
    dead socket fires ``proxy_error`` mid-record, and the heartbeat that
    ejects the corpse fires ``watchdog_restart``."""
    from analytics_zoo_tpu_torch.common.flight_recorder import (
        list_dumps,
        read_dump,
    )

    fd, flight_dir = fd2, fd2.flight_dir
    _wait_live(fd, 2)

    def frontdoor_dumps():
        out = []
        for p in list_dumps(flight_dir):
            header, records = read_dump(p)  # CRC-verified read
            if header["role"] == "frontdoor":
                out.append((p, header, records))
        return out

    before = len(frontdoor_dumps())
    for _ in range(6):  # fill the ring with healthy proxy records
        assert _post(fd.url, PREDICT)[0] == 200
    # a route key stuck to the victim: posting it right after the kill
    # hits the dead socket before the heartbeat ejects the slot
    key = next(k for k in (f"fr-{i}" for i in range(64))
               if _post(fd.url, PREDICT,
                        headers={"X-Zoo-Route-Key": k}
                        )[1]["X-Zoo-Worker"] == "0")
    stop = threading.Event()

    def client():  # background load so the ring holds live traffic
        while not stop.is_set():
            try:
                _post(fd.url, PREDICT, timeout=30)
            except OSError:
                pass
            time.sleep(0.01)

    threads = [threading.Thread(target=client) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.2)
        os.kill(fd.worker_pids()["0"], signal.SIGKILL)
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            _post(fd.url, PREDICT, headers={"X-Zoo-Route-Key": key})
            if len(frontdoor_dumps()) > before:
                break
    finally:
        stop.set()
        for t in threads:
            t.join()
    dumps = frontdoor_dumps()[before:]
    assert dumps, "worker death produced no front-door dump"
    assert {h["reason"] for _p, h, _r in dumps} <= {
        "proxy_error", "watchdog_restart"}
    records = [r for _p, _h, rs in dumps for r in rs]
    assert records, "dump carries an empty ring"
    assert all(r["kind"] == "proxy" for r in records)
    assert all(r["t_submit"] is not None for r in records)
    assert any(r["outcome"] == "ok" for r in records)
    assert any(r["outcome"] is None for r in records), \
        "no in-flight request captured in the dump"
    # the rename protocol left no torn staging files
    assert not [f for f in os.listdir(flight_dir) if f.endswith(".tmp")]
    _wait_live(fd, 2)  # hand the fixture back healthy


# -- rolling drain, front-door drain ----------------------------------------


def test_rolling_drain_replaces_all_workers_zero_errors(fd2):
    _wait_live(fd2, 2)
    fd = fd2
    pids_before = fd.worker_pids()
    restarts_before = {
        l.rsplit(" ", 1)[0]: float(l.rsplit(" ", 1)[1])
        for l in fd.metrics_text().splitlines()
        if l.startswith("zoo_frontdoor_worker_restarts_total")}
    errors = []
    live_min = [2]
    stop = threading.Event()

    def client():
        while not stop.is_set():
            try:
                _post(fd.url, PREDICT, timeout=30)
            except Exception as e:  # noqa: BLE001 — recorded below
                errors.append(repr(e))
            live_min[0] = min(live_min[0], fd.health()["live_workers"])
            time.sleep(0.01)

    threads = [threading.Thread(target=client) for _ in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.2)
    code, _h, body = _post(
        fd.url, "/v1/admin/frontdoor",
        json.dumps({"action": "rolling_drain"}).encode(), timeout=180)
    report = json.loads(body)
    stop.set()
    for t in threads:
        t.join()
    assert code == 200 and report["complete"] is True
    pids_after = fd.worker_pids()
    assert set(pids_after) == set(pids_before)
    assert all(pids_after[s] != pids_before[s] for s in pids_before)
    assert not errors, f"clients saw errors during rolling drain: {errors}"
    assert live_min[0] >= 1
    restarts = {
        l.rsplit(" ", 1)[0]: float(l.rsplit(" ", 1)[1])
        for l in fd.metrics_text().splitlines()
        if l.startswith("zoo_frontdoor_worker_restarts_total")}
    assert len(restarts) == 2
    assert all(restarts[k] == restarts_before.get(k, 0.0) + 1
               for k in restarts)


def test_front_door_drain_rejects_with_503_retry_after(fd1):
    fd = fd1
    assert _post(fd.url, PREDICT)[0] == 200
    code, _h, body = _post(
        fd.url, "/v1/admin/frontdoor",
        json.dumps({"action": "drain", "deadline_s": 5}).encode(),
        timeout=60)
    assert code == 200 and json.loads(body)["state"] == "draining"
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(fd.url, PREDICT)
    assert e.value.code == 503
    assert re.fullmatch(r"\d+", e.value.headers["Retry-After"])
    # the tier-wide healthz reports draining as 503 too
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(fd.url, "/healthz")
    assert e.value.code == 503
    assert json.loads(e.value.read())["status"] == "draining"
    assert re.fullmatch(r"\d+", e.value.headers["Retry-After"])
