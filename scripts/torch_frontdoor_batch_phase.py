#!/usr/bin/env python3
"""Phase 12 of ``chip_smoke.py``, runnable alone, on the PyTorch/CUDA port:
the preforked front door with card workers, the fleet fabric, then
resumable batch scoring over the streaming pipeline.

BERT at BERT-base's widths cut to 2 blocks (vocab 30522, hidden 768, 12
heads, intermediate 3072; 2 classes, bf16 compute) with random weights
from ``--seed``, written once with ``KerasNet.save_weights``: every worker and
the phase's own model load that file. Each worker serves the ladder 1-32
at 128 tokens from its own CUDA graphs.

- 12a: a 2-worker ``FrontDoor``: JSON and ``.npy`` predicts, replicas
  bitwise equal to each other, sticky and keyless routing, the merged
  ``/metrics`` and trace, quota charged once, requests/s and latency at 4
  clients with 2 and 1 workers beside a direct HTTP engine, ``scale_to``,
  ``frontdoor_worker_exit`` chaos, SIGKILL under load, the rolling drain
  and one ``Autoscaler`` tick, with 0 client errors throughout.
- 12b: two ``FleetDoor`` hosts with 1 worker each: sticky keys fleet-wide,
  a cooperative cache hit from the peer bitwise the bypass answer,
  replicated admin and the stale-epoch 409, ``fleet_forward_drop``
  failover and ``simulate_host_kill`` with 0 client errors.
- 12c: 6,000 rows through ``BatchPredictJob``/``BatchJobRunner`` (batch
  32, ladder 8/16/32, npy shards of 1024 rows): two runs and depths 0, 2
  and 4 bitwise, every row ``do_predict`` of its batch, a child killed at
  each ``BATCH_POINTS`` site and by SIGKILL then resumed bitwise, and
  ``scripts/torch_batch_predict.py`` on a saved NeuralCF killed at
  ``batch_mid_job_kill`` then resumed bitwise.

This process runs the front door and the fleet doors before it touches
the card, and checks that it has not initialised CUDA after all their
traffic; it then compares its own replay of every bucket with the
workers' answers and runs the batch part on the card. What only counts
errors runs beside other work: the fleet doors boot during 12a's SIGKILL
window and 12c's children run during its rolling drain. What is timed
(requests/s, rows/s, the busy share) runs beside no other process of
the phase but the workers it measures. Exits 1 on a failed check. Needs
one CUDA card:

    python3 scripts/torch_frontdoor_batch_phase.py [--seed 12]
"""

from __future__ import annotations

import argparse
import io
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

PHASE_DIR = ROOT / "build" / "frontdoor_batch_phase"
SPEC = f"{Path(__file__).resolve()}:build_worker_engine"
ENV_KEY = "AZOO_PHASE12"

# BERT-base as bench.py's serving record builds it, at 128 tokens, cut to
# 2 blocks (12 until phase 18 of chip_smoke.py needed the time: each worker
# boot loaded and placed the whole model, and 12c scored 6,000 rows about
# ten times; the front door, fleet and batch machinery under test is the
# same at any depth, and phases 3-5 serve the full depth)
BERT = dict(cs.BERT_BASE, seq_len=128, n_block=2)
LADDER = (1, 2, 4, 8, 16, 32)
CLIENTS, LOAD_SECONDS = 4, 1.5
# 12c: the batch job
BATCH_ROWS, BATCH_SIZE, BATCH_LADDER = 6000, 32, (8, 16, 32)
ROWS_PER_SHARD = 1024
KILLS = (("batch_writer_torn", 1), ("batch_before_manifest", 1),
         ("batch_mid_job_kill", 2), ("sigkill", 0))
# the CLI on NeuralCF at phase 3d's configuration
NCF_ROWS, NCF_BATCH, NCF_LADDER, NCF_SHARD = 40000, 8192, (
    1024, 2048, 4096, 8192), 16384


# ---------------------------------------------------------------------------
# the worker spec (loaded in each worker process by load_spec)
# ---------------------------------------------------------------------------


def _config() -> dict:
    return json.loads(os.environ[ENV_KEY])


def build_net(bert):
    from analytics_zoo_tpu_torch.tfpark.bert import BERTClassifierNet

    return BERTClassifierNet(num_classes=2, hidden_drop=0.0, attn_drop=0.0,
                             **bert)


def _process_seconds() -> float:
    """Seconds since this process started (``/proc``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def build_worker_engine():
    """A front-door worker's engine: BERT (2 blocks) from the phase's weights,
    one CUDA graph per ladder bucket, the result cache on for the fleet.
    After ``register`` it writes what it holds (flash nodes per bucket
    graph read through libcuda, wrapper launches, register seconds, card
    memory) to ``<info_dir>/worker-<pid>.json``. A spec that asks for the
    card and finds none raises: the worker's boot fails."""
    from analytics_zoo_tpu_torch import init_nncontext
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.ops import flash_attention as fa
    from analytics_zoo_tpu_torch.serving import (
        BatcherConfig,
        ResultCacheConfig,
        ServingEngine,
    )

    import_s = _process_seconds()  # interpreter start and imports
    t_boot = time.perf_counter()
    cfg = _config()
    init_nncontext(device="cuda", seed=0)
    net = build_net(BERT)
    net.load_weights(cfg["weights"])
    im = InferenceModel().do_load_keras(net)
    seq = BERT["seq_len"]
    engine = ServingEngine(result_cache=(
        ResultCacheConfig(max_entries=1024, ttl_s=None)
        if cfg.get("cache") else None))
    t0 = time.perf_counter()
    engine.register("bert", im, [np.zeros((1, seq), np.int32),
                                 np.zeros((1, seq), np.int32),
                                 np.ones((1, seq), np.float32)],
                    config=BatcherConfig(max_batch_size=max(LADDER),
                                         buckets=LADDER, max_wait_ms=2.0))
    torch.cuda.synchronize()
    info = {"pid": os.getpid(), "register_s": time.perf_counter() - t0,
            "wrapper_launches": fa.launches.count,
            "flash_nodes": {
                str(k[0][0][0]): sum(
                    kind == "kernel" and "flash_fwd_" in name
                    for kind, name in cs.graph_nodes(fn.graph))
                for k, fn in im._compiled.items()},
            "memory_reserved": torch.cuda.memory_reserved(),
            "memory_allocated": torch.cuda.memory_allocated()}
    info["spec_seconds"] = time.perf_counter() - t_boot
    info["import_seconds"] = import_s
    path = Path(cfg["info_dir"]) / f"worker-{os.getpid()}.json"
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(info))
    os.replace(tmp, path)
    return engine


# ---------------------------------------------------------------------------
# HTTP helpers
# ---------------------------------------------------------------------------


def _post(base, path, body, headers=None, timeout=120):
    req = urllib.request.Request(
        base + path, data=body,
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, dict(resp.headers), resp.read()


def _get(base, path, timeout=120):
    with urllib.request.urlopen(base + path, timeout=timeout) as resp:
        return resp.status, dict(resp.headers), resp.read()


def _body(x) -> bytes:
    return json.dumps({"inputs": [a.tolist() for a in x]}).encode()


NPY = {"Accept": "application/x-npy"}
PREDICT = "/v1/models/bert:predict"


def _npy(raw: bytes) -> np.ndarray:
    return np.load(io.BytesIO(raw))


def _wait_live(fd, n, deadline_s=240.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        if fd.health()["live_workers"] >= n:
            return time.monotonic() - t0
        time.sleep(0.05)
    cs.fail(f"phase 12: the front door never reached {n} live workers: "
            f"{fd.health()}")


class Load:
    """``clients`` threads posting ``make()`` requests until stopped:
    latencies, answers and every error, and the least live-worker count
    seen between requests (``live`` reads it)."""

    def __init__(self, base, make, clients=CLIENTS, headers=None,
                 live=None):
        self.base, self.make, self.headers = base, make, headers or {}
        self.live = live
        self.lat, self.errors, self.min_live = [], [], None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._threads = [threading.Thread(target=self._run, args=(i,),
                                          daemon=True)
                         for i in range(clients)]

    def _run(self, i):
        k = 0
        while not self._stop.is_set():
            body = self.make(i, k)
            k += 1
            t0 = time.perf_counter()
            try:
                code, _h, _b = _post(self.base, PREDICT, body, self.headers)
                err = None if code == 200 else f"status {code}"
            except urllib.error.HTTPError as e:
                err = f"HTTP {e.code}: {e.read()[:200]!r}"
            except OSError as e:
                err = repr(e)
            dt = time.perf_counter() - t0
            with self._lock:
                if err is None:
                    self.lat.append(dt)
                else:
                    self.errors.append(err)
                if self.live is not None:
                    n = self.live()
                    self.min_live = (n if self.min_live is None
                                     else min(self.min_live, n))

    def __enter__(self):
        self.t0 = time.perf_counter()
        for t in self._threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=300)
        self.seconds = time.perf_counter() - self.t0

    def report(self, what):
        lat = np.asarray(self.lat) * 1e3
        rps = len(self.lat) / self.seconds
        p50, p90 = (np.percentile(lat, (50, 90)) if len(lat)
                    else (float("nan"),) * 2)
        print(f"frontdoor: {what}: {len(self.lat)} requests in "
              f"{self.seconds:.2f} s at {len(self._threads)} clients = "
              f"{rps:.1f} requests/s, p50 {p50:.2f} ms, p90 {p90:.2f} ms, "
              f"errors {len(self.errors)}", flush=True)
        return {"requests_per_s": rps, "p50_ms": float(p50),
                "p90_ms": float(p90), "errors": len(self.errors)}


def _zero_errors(load, what):
    if load.errors:
        cs.fail(f"phase 12: {what}: clients saw {len(load.errors)} errors, "
                f"first {load.errors[:3]}")


def compute_apps():
    """(pid, used MiB) of the card's compute processes, per nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    rows = []
    for line in out.stdout.strip().splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit():
            rows.append((int(parts[0]), parts[1]))
    return rows


def check_contexts(where, worker_pids, parent_context):
    """The card's compute processes are the live workers (and the parent
    chip_smoke process, which holds its own context), never this
    process: the front door and the fleet doors hold no CUDA context."""
    if torch.cuda.is_initialized():
        cs.fail(f"phase 12 {where}: the front-door process initialised CUDA")
    apps = compute_apps()
    want = set(worker_pids) | ({os.getppid()} if parent_context else set())
    pids = {p for p, _ in apps}
    print(f"frontdoor: {where}: card compute processes (pid, MiB) {apps}; "
          f"live workers {sorted(worker_pids)}; this process {os.getpid()}"
          f" holds no context (torch.cuda.is_initialized() False)",
          flush=True)
    if pids & (want | {os.getpid()}):
        if os.getpid() in pids or pids != want:
            cs.fail(f"phase 12 {where}: compute processes {sorted(pids)} "
                    f"are not exactly {sorted(want)}")
    elif apps:
        # another pid namespace: hold the count
        if len(apps) != len(want):
            cs.fail(f"phase 12 {where}: {len(apps)} compute processes, "
                    f"want {len(want)}")
        print(f"frontdoor: {where}: nvidia-smi reports pids of another "
              f"namespace; held to the count {len(want)}", flush=True)
    else:
        print(f"frontdoor: {where}: nvidia-smi lists no compute processes "
              f"here; the context check rests on torch.cuda.is_initialized",
              flush=True)


def read_infos(info_dir, seen):
    """The worker info files not read yet: {pid: info}."""
    out = {}
    for p in sorted(Path(info_dir).glob("worker-*.json")):
        info = json.loads(p.read_text())
        if info["pid"] not in seen:
            out[info["pid"]] = info
            seen[info["pid"]] = info
    return out


def check_worker_infos(infos, n_block, where):
    for pid, info in sorted(infos.items()):
        nodes = info["flash_nodes"]
        print(f"frontdoor: {where}: worker pid {pid}: process start to "
              f"spec {info['import_seconds']:.2f} s, spec "
              f"{info['spec_seconds']:.2f} s (register "
              f"{info['register_s']:.2f} s), flash wrapper "
              f"launches {info['wrapper_launches']}, flash forward nodes "
              f"per bucket graph {nodes}, card memory reserved "
              f"{info['memory_reserved']} allocated "
              f"{info['memory_allocated']} bytes", flush=True)
        if (sorted(map(int, nodes)) != list(LADDER)
                or any(v != n_block for v in nodes.values())):
            cs.fail(f"phase 12 {where}: worker {pid}'s bucket graphs do not "
                    f"each hold {n_block} flash forward nodes: {nodes}")
        if info["wrapper_launches"] != 2 * n_block * len(LADDER):
            cs.fail(f"phase 12 {where}: worker {pid} register launched the "
                    f"flash wrapper {info['wrapper_launches']} times")


def _requests(rng, sizes):
    return [cs.make_request(rng, b, BERT["seq_len"], BERT["vocab"])
            for b in sizes]


# ---------------------------------------------------------------------------
# 12a: the front door
# ---------------------------------------------------------------------------


def frontdoor_part(env_cfg, rng, parent_context, fleet, children):
    from analytics_zoo_tpu_torch.common.observability import get_tracer
    from analytics_zoo_tpu_torch.serving import FrontDoor, FrontDoorConfig
    from analytics_zoo_tpu_torch.serving.fabric import (
        Autoscaler,
        AutoscalerConfig,
    )
    from analytics_zoo_tpu_torch.serving.quota import TenantQuota

    n_block = BERT["n_block"]
    info_dir, seen = env_cfg["info_dir"], {}
    env = {ENV_KEY: json.dumps(env_cfg)}
    get_tracer().enable()  # exported into the workers as AZOO_TRACE=1
    out = {"spawn_s": [], "wrapper_launches": 0}

    # the direct HTTP engine: one worker process hit on its own port
    direct_ready = PHASE_DIR / "direct.json"
    direct = subprocess.Popen(
        [sys.executable, "-m", "analytics_zoo_tpu_torch.serving.worker",
         "--spec", SPEC, "--ready-file", str(direct_ready)],
        env=dict(os.environ, PYTHONPATH=str(ROOT), **env), cwd=ROOT)
    t0 = time.perf_counter()
    fd = FrontDoor(FrontDoorConfig(
        spec=SPEC, workers=2, heartbeat_interval_s=0.2,
        worker_boot_timeout_s=120, drain_deadline_s=30,
        worker_env=env)).start()
    boot_s = time.perf_counter() - t0
    out["spawn_s"].append(boot_s)
    print(f"frontdoor: 2 workers booted in {boot_s:.2f} s (concurrently), "
          f"pids {fd.worker_pids()}", flush=True)
    try:
        while not direct_ready.exists():
            if direct.poll() is not None:
                cs.fail(f"phase 12: the direct engine exited "
                        f"{direct.returncode} during boot")
            time.sleep(0.05)
        direct_url = (f"http://127.0.0.1:"
                      f"{json.loads(direct_ready.read_text())['port']}")
        infos = read_infos(info_dir, seen)
        check_worker_infos(infos, n_block, "boot")
        check_contexts("12a boot", list(fd.worker_pids().values())
                       + [direct.pid], parent_context)

        # -- JSON and npy predicts; replicas bitwise ----------------------
        probes = _requests(rng, LADDER)
        answers = {}  # bucket -> npy bytes
        for x in probes:
            body = _body(x)
            code, h, raw = _post(fd.url, PREDICT, body)
            preds = np.asarray(json.loads(raw)["predictions"], np.float32)
            if code != 200 or preds.shape != (len(x[0]), 2):
                cs.fail(f"phase 12: JSON predict gave {code} {preds.shape}")
            by_worker = {}
            for _ in range(12):
                _c, h, raw = _post(fd.url, PREDICT, body, NPY)
                if h["Content-Type"] != "application/x-npy":
                    cs.fail("phase 12: the npy reply is not npy")
                by_worker.setdefault(h["X-Zoo-Worker"], raw)
                if len(by_worker) == 2:
                    break
            if len(by_worker) != 2 or len(set(by_worker.values())) != 1:
                cs.fail(f"phase 12: bucket {len(x[0])}: the replicas' npy "
                        f"replies differ (workers {sorted(by_worker)})")
            got = _npy(next(iter(by_worker.values())))
            if not np.array_equal(got, preds):
                cs.fail("phase 12: the JSON and npy replies differ")
            if not (np.isfinite(got).all()
                    and np.allclose(got.sum(-1), 1.0, atol=1e-3)):
                cs.fail("phase 12: the replies are not probabilities")
            answers[len(x[0])] = got
        _c, _h, raw = _post(direct_url, PREDICT, _body(probes[3]), NPY)
        if not np.array_equal(_npy(raw), answers[len(probes[3][0])]):
            cs.fail("phase 12: the direct engine's answer differs from the "
                    "front door's")
        print(f"frontdoor: JSON and npy predicts at buckets {list(LADDER)}: "
              f"both workers' npy replies bitwise equal, equal to the JSON "
              f"reply and to the direct engine's", flush=True)

        # -- sticky and keyless routing ------------------------------------
        one = _body(probes[0])
        for key in ("tenant-a", "tenant-b", "sess-42"):
            seen_w = {_post(fd.url, PREDICT, one,
                            {"X-Zoo-Route-Key": key})[1]["X-Zoo-Worker"]
                      for _ in range(6)}
            if len(seen_w) != 1:
                cs.fail(f"phase 12: sticky key {key} reached {seen_w}")
        counts = {"0": 0, "1": 0}
        for _ in range(20):
            counts[_post(fd.url, PREDICT, one)[1]["X-Zoo-Worker"]] += 1
        print(f"frontdoor: sticky keys each pinned one worker; 20 keyless "
              f"requests spread {counts}", flush=True)
        if abs(counts["0"] - counts["1"]) > 2:
            cs.fail("phase 12: keyless traffic did not spread N/2 +- 1")

        # -- trace adopted across the hop, one merged timeline -------------
        tid = "ab12cd34ef567890"
        _c, h, _b = _post(fd.url, PREDICT, one, {"X-Zoo-Trace-Id": tid})
        doc = json.loads(_get(fd.url, f"/v1/debug/traces/{tid}")[2])
        workers = {s["worker"] for s in doc["spans"]}
        names = {s["name"] for s in doc["spans"]}
        starts = [s["wall_start"] for s in doc["spans"]]
        chrome = json.loads(_get(
            fd.url, f"/v1/debug/traces/{tid}?format=chrome")[2])
        print(f"frontdoor: trace {tid}: echoed {h['X-Zoo-Trace-Id']}, "
              f"{len(doc['spans'])} spans from {sorted(workers)}, "
              f"{len(chrome['traceEvents'])} chrome events", flush=True)
        if (h["X-Zoo-Trace-Id"] != tid or "frontdoor" not in workers
                or not workers & {"0", "1"}
                or "serving.request" not in names
                or starts != sorted(starts)):
            cs.fail("phase 12: the merged trace is not one timeline")

        # -- merged metrics --------------------------------------------------
        text = _get(fd.url, "/metrics")[2].decode()
        helps = [l.split(" ", 3)[2] for l in text.splitlines()
                 if l.startswith("# HELP ")]
        if len(helps) != len(set(helps)):
            cs.fail("phase 12: a metric family appears twice in the merge")
        for slot in ("0", "1"):
            if f'zoo_serving_requests_total{{worker="{slot}"' not in text:
                cs.fail(f"phase 12: worker {slot}'s families are missing")
        info_lines = [l for l in text.splitlines()
                      if l.startswith("zoo_build_info{")]
        print(f"frontdoor: merged /metrics: {len(helps)} families, each "
              f"once; build info {info_lines}", flush=True)
        if not any('worker="frontdoor"' in l and "no-context" in l
                   for l in info_lines):
            cs.fail("phase 12: the front door's build info does not read "
                    "no-context")

        # -- quota charged once, at the front door -------------------------
        fd.quota.set_quota("acme", TenantQuota(rate=0.001, burst=5))
        ok = rejected = 0
        for _ in range(8):
            try:
                _post(fd.url, PREDICT, one, {"X-Zoo-Tenant": "acme"})
                ok += 1
            except urllib.error.HTTPError as e:
                rejected += e.code == 429
        fd.quota.set_quota("acme", None)
        print(f"frontdoor: quota burst 5 over 2 workers: {ok} admitted, "
              f"{rejected} rejected with 429", flush=True)
        if (ok, rejected) != (5, 3):
            cs.fail("phase 12: quota was not charged once at the front door")

        # -- requests/s at 4 clients: 2 workers, the direct engine ---------
        load_req = [_body(x) for x in _requests(rng, [1] * 64)]

        def make(i, k):
            return load_req[(i * 17 + k) % len(load_req)]

        for what, base in (("2 workers", fd.url), ("direct engine",
                                                   direct_url)):
            with Load(base, make):  # warm-up, not counted
                time.sleep(1.0)
            with Load(base, make) as load:
                time.sleep(LOAD_SECONDS)
            out[what] = load.report(what)
            _zero_errors(load, what)
        direct.terminate()
        if direct.wait(timeout=60) != 0:
            cs.fail(f"phase 12: the direct engine exited "
                    f"{direct.returncode} on SIGTERM")

        # -- scale_to(1), 1 worker ------------------------------------------
        t0 = time.perf_counter()
        r = fd.scale_to(1)
        print(f"frontdoor: scale_to(1) {r} in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        with Load(fd.url, make):  # warm-up, not counted
            time.sleep(1.0)
        with Load(fd.url, make) as load:
            time.sleep(LOAD_SECONDS)
        out["1 worker"] = load.report("1 worker")
        _zero_errors(load, "1 worker")

        # -- scale_to(2) with frontdoor_worker_exit armed in the new worker -
        fd.config.worker_env = dict(env, AZOO_FT_CHAOS="frontdoor_worker_exit",
                                    AZOO_FT_CHAOS_SKIP="5")
        t0 = time.perf_counter()
        r = fd.scale_to(2)
        out["spawn_s"].append(time.perf_counter() - t0)
        fd.config.worker_env = env  # its respawn comes back clean
        print(f"frontdoor: scale_to(2) {r} in {out['spawn_s'][-1]:.2f} s "
              f"(the new worker armed with frontdoor_worker_exit after 5 "
              f"predicts)", flush=True)
        read_infos(info_dir, seen)
        armed = max(fd.worker_pids().items(), key=lambda kv: int(kv[0]))
        key = next(k for k in (f"chaos-{i}" for i in range(256))
                   if _post(fd.url, PREDICT, one, {"X-Zoo-Route-Key": k}
                            )[1]["X-Zoo-Worker"] == armed[0])
        proc = fd._slots[armed[0]].proc
        with Load(fd.url, make, headers={"X-Zoo-Route-Key": key}) as load:
            deadline = time.monotonic() + 60
            while proc.poll() is None:
                if time.monotonic() > deadline:
                    cs.fail("phase 12: the armed worker never died")
                time.sleep(0.005)
            t0 = time.perf_counter()
            while fd.worker_pids().get(armed[0]) == armed[1]:
                if time.monotonic() > deadline + 240:
                    cs.fail("phase 12: the armed worker was never respawned")
                time.sleep(0.02)
            _wait_live(fd, 2)
            out["spawn_s"].append(time.perf_counter() - t0)
        load.report("chaos exit under sticky load")
        _zero_errors(load, "frontdoor_worker_exit")
        print(f"frontdoor: worker {armed[0]} (pid {armed[1]}) exited "
              f"{proc.returncode} mid-request, 0 client errors, respawned as "
              f"pid {fd.worker_pids()[armed[0]]}, live "
              f"{out['spawn_s'][-1]:.2f} s after its death", flush=True)
        if proc.returncode != 43:
            cs.fail("phase 12: the armed worker did not die by chaos")

        # -- SIGKILL under 4 clients, the fleet booting beside it ----------
        # (from here on the clients count errors and time nothing)
        victim = fd.worker_pids()[armed[0]]
        read_infos(info_dir, seen)
        fleet.start()
        with Load(fd.url, make) as load:
            time.sleep(0.5)
            t0 = time.perf_counter()
            os.kill(victim, signal.SIGKILL)
            deadline = time.monotonic() + 60
            while fd.worker_pids().get(armed[0]) == victim:
                if time.monotonic() > deadline:
                    cs.fail("phase 12: the killed worker was never ejected")
                time.sleep(0.02)
            _wait_live(fd, 2)
            out["spawn_s"].append(time.perf_counter() - t0)
            time.sleep(0.5)
        load.report("SIGKILL under load")
        _zero_errors(load, "SIGKILL")
        print(f"frontdoor: SIGKILL of pid {victim}: 0 client errors, "
              f"respawned as pid {fd.worker_pids()[armed[0]]}, live again "
              f"{out['spawn_s'][-1]:.2f} s after the kill", flush=True)
        fleet_pids = fleet.join()
        infos = read_infos(info_dir, seen)
        check_worker_infos(infos, n_block, "respawn and fleet boot")
        check_contexts("12a after the respawns and the fleet's boot",
                       list(fd.worker_pids().values()) + fleet_pids,
                       parent_context)
        # the respawned worker answers bitwise as before
        for x in probes:
            got = {}
            for _ in range(12):
                _c, h, raw = _post(fd.url, PREDICT, _body(x), NPY)
                got[h["X-Zoo-Worker"]] = _npy(raw)
                if len(got) == 2:
                    break
            if any(not np.array_equal(v, answers[len(x[0])])
                   for v in got.values()):
                cs.fail("phase 12: a respawned worker answers differently")

        # -- rolling drain under 4 clients, 12c's children beside it -------
        children.start()
        old = {s: w.proc for s, w in fd._slots.items()}
        t0 = time.perf_counter()
        with Load(fd.url, make,
                  live=lambda: fd.health()["live_workers"]) as load:
            code, _h, raw = _post(
                fd.url, "/v1/admin/frontdoor",
                json.dumps({"action": "rolling_drain"}).encode(),
                timeout=600)
        drain_s = time.perf_counter() - t0
        report = json.loads(raw)
        load.report("rolling drain")
        _zero_errors(load, "rolling drain")
        codes = {s: p.returncode for s, p in old.items()}
        print(f"frontdoor: rolling drain in {drain_s:.2f} s: complete "
              f"{report.get('complete')}, least live workers "
              f"{load.min_live}, drained workers' exit codes {codes}",
              flush=True)
        if code != 200 or report.get("complete") is not True:
            cs.fail("phase 12: the rolling drain did not complete")
        if load.min_live is None or load.min_live < 1:
            cs.fail("phase 12: the rolling drain left no live worker")
        if any(c != 0 for c in codes.values()):
            cs.fail("phase 12: a drained worker did not exit 0 on SIGTERM")
        out["rolling_drain_s"] = drain_s
        check_worker_infos(read_infos(info_dir, seen), n_block,
                           "rolling drain")
        children.wait()

        # -- one Autoscaler tick --------------------------------------------
        sc = Autoscaler(fd, AutoscalerConfig(min_workers=1, max_workers=2,
                                             scale_down_ticks=1,
                                             cooldown_ticks=0))
        n = sc.tick()
        print(f"frontdoor: Autoscaler tick over idle queues "
              f"{fd.queue_depths()}: {n} worker(s), events {sc.events}",
              flush=True)
        if n != 1 or sc.events != {"up": 0, "down": 1}:
            cs.fail("phase 12: the autoscaler's idle tick did not scale down")
        check_contexts("12a end", list(fd.worker_pids().values())
                       + fleet_pids, parent_context)
        out["answers"] = answers
        out["probes"] = probes
        out["wrapper_launches"] = sum(i["wrapper_launches"]
                                      for i in seen.values())
        print(f"frontdoor: spawn seconds "
              f"{[round(s, 2) for s in out['spawn_s']]}; "
              f"{len(seen) - len(fleet_pids)} workers booted by the front "
              f"door and the direct engine, {len(fleet_pids)} by the fleet "
              f"doors", flush=True)
        out["workers_booted"] = len(seen)
        return out
    finally:
        fd.shutdown()
        if direct.poll() is None:
            direct.kill()
            direct.wait(timeout=30)
        get_tracer().disable()


# ---------------------------------------------------------------------------
# 12b: the fleet
# ---------------------------------------------------------------------------


class FleetBoot:
    """Two ``FleetDoor`` hosts, a and b, with 1 worker each and the result
    cache on, sharing one ``fleet_dir``, booted in threads of this
    process: ``start`` returns at once, ``join`` waits for both doors and
    returns their workers' pids; ``shutdown`` stops what booted."""

    def __init__(self, env_cfg):
        from analytics_zoo_tpu_torch.serving.fabric import FleetConfig

        env = {ENV_KEY: json.dumps(dict(env_cfg, cache=True))}
        fleet_dir = PHASE_DIR / "fleet"
        shutil.rmtree(fleet_dir, ignore_errors=True)
        self.configs = {h: FleetConfig(
            host_id=h, spec=SPEC, fleet_dir=str(fleet_dir), workers=1,
            heartbeat_interval_s=0.2, worker_boot_timeout_s=120,
            worker_env=env) for h in "ab"}
        self.doors, self.errs, self.threads = {}, [], []

    def _boot(self, h):
        from analytics_zoo_tpu_torch.serving.fabric import FleetDoor

        try:
            self.doors[h] = FleetDoor(self.configs[h]).start()
        except BaseException as e:  # noqa: BLE001 — raised by join
            self.errs.append(e)

    def start(self):
        self.t0 = time.perf_counter()
        self.threads = [threading.Thread(target=self._boot, args=(h,))
                        for h in self.configs]
        for t in self.threads:
            t.start()

    def join(self):
        for t in self.threads:
            t.join()
        if self.errs:
            raise self.errs[0]
        self.seconds = time.perf_counter() - self.t0
        print(f"fleet: hosts a and b (1 worker each) booted in "
              f"{self.seconds:.2f} s, beside 12a's SIGKILL and respawn",
              flush=True)
        return [p for d in self.doors.values()
                for p in d.frontdoor.worker_pids().values()]

    def shutdown(self):
        for t in self.threads:
            t.join()
        for d in self.doors.values():
            d.shutdown()


def fleet_part(fleet, rng, parent_context):
    from analytics_zoo_tpu_torch.ft import chaos
    from analytics_zoo_tpu_torch.serving.fabric import fleet_pick

    a, b = fleet.doors["a"], fleet.doors["b"]
    t0 = time.perf_counter()
    deadline = time.monotonic() + 30
    while not (set(a.membership.poll().live) == {"a", "b"}
               and set(b.membership.poll().live) == {"a", "b"}):
        if time.monotonic() > deadline:
            cs.fail("phase 12: the fleet never converged to {a, b}")
        time.sleep(0.05)
    print(f"fleet: hosts a and b converged (waited "
          f"{time.perf_counter() - t0:.2f} s), epoch {a.membership.epoch}",
          flush=True)
    pids = [p for d in (a, b) for p in d.frontdoor.worker_pids().values()]
    check_contexts("12b boot", pids, parent_context)

    def owned_by(owner, prefix):
        return next(k for k in (f"{prefix}-{i}" for i in range(1000))
                    if fleet_pick(["a", "b"], ["a", "b"], "a", k) == owner)

    # -- sticky keys land on one worker fleet-wide -------------------------
    hosts = set()
    for i in range(8):
        key = f"sticky-{i}"
        seen = set()
        for door in (a, b):
            x = _requests(rng, [1])[0]
            _c, h, _r = _post(door.url, PREDICT, _body(x),
                              {"X-Zoo-Route-Key": key})
            seen.add((h["X-Zoo-Host"], h.get("X-Zoo-Worker")))
        if len(seen) != 1:
            cs.fail(f"phase 12: sticky key {key} reached {seen}")
        hosts |= {s[0] for s in seen}
    print(f"fleet: 8 sticky keys each on one worker fleet-wide, over "
          f"hosts {sorted(hosts)}", flush=True)
    if hosts != {"a", "b"}:
        cs.fail("phase 12: sticky keys did not use both hosts")

    # -- cooperative cache: a peer's hit is bitwise the bypass answer ------
    warm = _body(_requests(rng, [4])[0])
    _c, h, d_warm = _post(a.url, PREDICT, warm,
                          {"X-Zoo-Route-Key": owned_by("a", "coop"),
                           **NPY})
    _c, h_hit, d_hit = _post(b.url, PREDICT, warm,
                             {"X-Zoo-Route-Key": owned_by("b", "coop"),
                              **NPY})
    _c, h_by, d_by = _post(b.url, PREDICT, warm,
                           {"X-Zoo-Route-Key": owned_by("b", "coop"),
                            "Cache-Control": "no-cache", **NPY})
    print(f"fleet: cooperative cache: b's answer {h_hit.get('X-Zoo-Cache')}"
          f" (host {h_hit['X-Zoo-Host']}), bypass "
          f"{h_by.get('X-Zoo-Cache')}; hit == warm "
          f"{d_hit == d_warm}, bypass == hit {d_by == d_hit}", flush=True)
    if (h["X-Zoo-Host"] != "a" or h_hit["X-Zoo-Host"] != "b"
            or h_hit.get("X-Zoo-Cache") != "hit"
            or h_by.get("X-Zoo-Cache") != "bypass"
            or not d_hit == d_warm == d_by):
        cs.fail("phase 12: the cooperative cache hit is not bitwise the "
                "bypass answer")

    # -- admin replicates; a stale epoch gets 409 --------------------------
    code, _h, raw = _post(a.url, "/v1/admin/rollout", json.dumps(
        {"action": "quota", "tenant": "t-rep", "rate": 0.01,
         "burst": 3.0}).encode())
    rep = json.loads(raw)
    stale = urllib.request.Request(
        b.url + "/v1/fleet/admin", data=json.dumps(
            {"action": "quota", "tenant": "t-epoch",
             "rate": 1.0}).encode(),
        headers={"Content-Type": "application/json",
                 "X-Zoo-Fleet-Epoch": "0"})
    try:
        urllib.request.urlopen(stale, timeout=30)
        stale_code = 200
    except urllib.error.HTTPError as e:
        stale_code = e.code
    print(f"fleet: admin quota through a reached hosts "
          f"{sorted(rep.get('hosts', {}))}, b holds burst "
          f"{b.quota.describe()['tenants'].get('t-rep', {}).get('burst')}"
          f"; a stale epoch got {stale_code}", flush=True)
    if (code != 200 or set(rep["hosts"]) != {"a", "b"}
            or b.quota.describe()["tenants"]["t-rep"]["burst"] != 3.0
            or stale_code != 409):
        cs.fail("phase 12: admin did not replicate, or a stale epoch "
                "was not refused")
    _post(a.url, "/v1/admin/rollout",
          json.dumps({"action": "quota", "tenant": "t-rep"}).encode())

    # -- fleet_forward_drop fails over locally -----------------------------
    key_b = owned_by("b", "drop")
    chaos.arm_serving("fleet_forward_drop", times=1, tag="b")
    try:
        _c, h, _r = _post(a.url, PREDICT,
                          _body(_requests(rng, [1])[0]),
                          {"X-Zoo-Route-Key": key_b})
        hits = chaos.serving_hits("fleet_forward_drop")
    finally:
        chaos.disarm_serving()
    print(f"fleet: fleet_forward_drop fired {hits} time(s); the "
          f"request was served by host {h['X-Zoo-Host']}", flush=True)
    if hits != 1 or h["X-Zoo-Host"] != "a":
        cs.fail("phase 12: a dropped forward did not fail over locally")
    deadline = time.monotonic() + 10
    while not a.membership.poll().is_live("b"):
        if time.monotonic() > deadline:
            cs.fail("phase 12: the suspicion of b never cleared")
        time.sleep(0.05)

    # -- simulate_host_kill under load: only b's keys move -----------------
    keys_a = [f"stay-{i}" for i in range(24)
              if fleet_pick(["a", "b"], ["a", "b"], "a",
                            f"stay-{i}") == "a"]
    owners = {k: _post(a.url, PREDICT,
                       _body(_requests(rng, [1])[0]),
                       {"X-Zoo-Route-Key": k})[1]["X-Zoo-Host"]
              for k in keys_a}
    load_req = [_body(x) for x in _requests(rng, [1] * 32)]
    with Load(a.url, lambda i, k: load_req[(i * 7 + k) % 32],
              headers={"X-Zoo-Route-Key": key_b}) as load:
        time.sleep(0.3)
        b.simulate_host_kill()
        deadline = time.monotonic() + 30
        while set(a.membership.poll().live) != {"a"}:
            if time.monotonic() > deadline:
                cs.fail("phase 12: host b's death was never detected")
            time.sleep(0.05)
        time.sleep(0.5)
    load.report("host kill under load")
    _zero_errors(load, "simulate_host_kill")
    moved = {k for k in keys_a if _post(
        a.url, PREDICT, _body(_requests(rng, [1])[0]),
        {"X-Zoo-Route-Key": k})[1]["X-Zoo-Host"] != owners[k]}
    _c, h, _r = _post(a.url, PREDICT,
                      _body(_requests(rng, [1])[0]),
                      {"X-Zoo-Route-Key": key_b})
    print(f"fleet: simulate_host_kill(b): 0 client errors; b's key now "
          f"on host {h['X-Zoo-Host']}; of a's {len(keys_a)} keys "
          f"{len(moved)} moved", flush=True)
    if moved or h["X-Zoo-Host"] != "a":
        cs.fail("phase 12: the host kill moved keys of the live host")
    check_contexts("12b end", list(a.frontdoor.worker_pids().values()),
                   parent_context)


# ---------------------------------------------------------------------------
# 12c: batch scoring
# ---------------------------------------------------------------------------


def batch_rows(seed):
    rng = np.random.default_rng(seed)
    return cs.make_request(rng, BATCH_ROWS, BERT["seq_len"], BERT["vocab"])


def make_job(im, rows, depth):
    from analytics_zoo_tpu_torch.batch import BatchPredictJob
    from analytics_zoo_tpu_torch.data.sources import ArraySource

    return BatchPredictJob(im, ArraySource(list(rows)), batch_size=BATCH_SIZE,
                           pad_to_bucket=BATCH_LADDER, prefetch=2,
                           pipeline_depth=depth)


def run_job(im, rows, out, depth, resume=False):
    from analytics_zoo_tpu_torch.batch import BatchJobRunner, OutputSpec

    return BatchJobRunner(
        make_job(im, rows, depth),
        OutputSpec(str(out), fmt="npy", rows_per_shard=ROWS_PER_SHARD),
        checkpoint_every_shards=2).run(resume=resume)


def output_bytes(out):
    """Every shard's bytes, MANIFEST.json's and COMMIT's."""
    from analytics_zoo_tpu_torch.batch import read_manifest

    files = [r["file"] for r in read_manifest(str(out))["shards"]]
    return {f: (Path(out) / f).read_bytes()
            for f in files + ["MANIFEST.json", "COMMIT"]}


def load_bert(weights):
    """BERT (2 blocks) from the phase's weights, on the card."""
    from analytics_zoo_tpu_torch.inference import InferenceModel

    net = build_net(BERT)
    net.load_weights(weights)
    return InferenceModel().do_load_keras(net)


def batch_child(args) -> int:
    """12c's child: score the job into ``--out`` armed to die (chaos
    points through ``AZOO_FT_CHAOS``, or SIGKILL from the parent)."""
    from analytics_zoo_tpu_torch import init_nncontext

    cfg = json.loads(args.batch_child)
    init_nncontext(device="cuda", seed=0)
    im = load_bert(cfg["weights"])
    rows = batch_rows(cfg["seed"])
    if cfg.get("throttle_s"):
        # the SIGKILL child: slow enough that the parent's kill lands
        # between two committed shards
        fetch = im.do_fetch

        def slow_fetch(out):
            time.sleep(cfg["throttle_s"])
            return fetch(out)

        im.do_fetch = slow_fetch
    run_job(im, rows, cfg["out"], 2)
    return 0


class Children:
    """12c's children: four that score the job into directories of their
    own and die at one of ``BATCH_POINTS`` (through ``AZOO_FT_CHAOS``) or
    by SIGKILL from a watcher thread once their first shard is committed,
    and ``scripts/torch_batch_predict.py`` on the saved NeuralCF armed to
    die at ``batch_mid_job_kill``. 12a starts them beside its rolling
    drain, whose clients count errors and time nothing, and waits for
    their deaths before its last context check; 12c checks and resumes
    what they left."""

    def __init__(self, weights, seed, base):
        self.weights, self.seed, self.base = weights, seed, base
        self.kids, self.watchers, self.rcs = {}, [], {}
        self.ncf = None

    @staticmethod
    def _sigkill_when_committed(kout, proc):
        deadline = time.monotonic() + 300
        while proc.poll() is None and time.monotonic() < deadline:
            m = kout / "MANIFEST.json"
            try:
                n_sh = (len(json.loads(m.read_text())["shards"])
                        if m.exists() else 0)
            except (OSError, ValueError):
                n_sh = 0
            if n_sh >= 1:
                proc.send_signal(signal.SIGKILL)
                return
            time.sleep(0.005)

    def start(self):
        self.t0 = time.perf_counter()
        for point, skip in KILLS:
            kout = self.base / f"kill-{point}"
            env = dict(os.environ, PYTHONPATH=str(ROOT))
            env.pop("AZOO_FT_CHAOS", None)
            if point != "sigkill":
                env.update(AZOO_FT_CHAOS=point, AZOO_FT_CHAOS_SKIP=str(skip))
            child_cfg = dict(weights=self.weights, seed=self.seed,
                             out=str(kout),
                             throttle_s=0.02 if point == "sigkill" else 0)
            self.kids[point] = (kout, subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--batch-child", json.dumps(child_cfg)], env=env, cwd=ROOT))
            if point == "sigkill":
                self.watchers.append(threading.Thread(
                    target=self._sigkill_when_committed,
                    args=self.kids[point], daemon=True))
                self.watchers[-1].start()
        self.ncf = ncf_cli_start()

    def wait(self):
        for t in self.watchers:
            t.join(timeout=300)
        self.rcs = {point: proc.wait(timeout=300)
                    for point, (_k, proc) in self.kids.items()}
        self.ncf["stdout"], self.ncf["stderr"] = \
            self.ncf["proc"].communicate(timeout=300)
        print(f"batch: the {len(self.kids)} kill children and the CLI child "
              f"had all exited {time.perf_counter() - self.t0:.2f} s after "
              f"their start", flush=True)

    def stop(self):
        """Kill what still runs (after a failed check)."""
        procs = [p for _k, p in self.kids.values()]
        procs += [self.ncf["proc"]] if self.ncf else []
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)


def traced_pass(fn):
    """One ``fn()`` under torch.profiler: its wall ms, the ms in which the
    card ran at least one of its device records (kernels, memsets,
    copies: the union of their intervals), those records' summed ms, and
    their names. The records are read from the profiler's raw results,
    without its event tree: on an H100 a scoring pass with its trace took
    18.8 s with the tree and 13.0 s without. Device activity alone: the
    host's ops are not read."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == cuda and e.duration_ns() > 0)
    if not spans:
        cs.fail("phase 12: torch.profiler recorded no device record")
    busy, end = 0, -1
    for start, stop, _name in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    summed = sum(stop - start for start, stop, _name in spans)
    return wall_ms, busy / 1e6, summed / 1e6, [n for _a, _b, n in spans]


def batch_part(im, seed, base, children):
    """12c in this process, on a card and host that no other process of
    the phase uses (``children`` have died): ``do_predict`` of every
    batch, the timed runs and the traced pass, then each child's
    resume."""
    from analytics_zoo_tpu_torch.batch import load_shard_rows, read_manifest
    from analytics_zoo_tpu_torch.batch import verify_output
    from analytics_zoo_tpu_torch.data.pipeline import Pipeline
    from analytics_zoo_tpu_torch.data.sources import ArraySource
    from analytics_zoo_tpu_torch.ft import chaos

    rows = batch_rows(seed)
    n_block = BERT["n_block"]
    out = {"replays": 0}
    n_batches = -(-BATCH_ROWS // BATCH_SIZE)
    tail = BATCH_ROWS - (n_batches - 1) * BATCH_SIZE
    tail_bucket = next(b for b in BATCH_LADDER if b >= tail)

    # -- do_predict of every batch -----------------------------------------
    pipe = Pipeline(ArraySource(list(rows))).batch(
        BATCH_SIZE, pad_to_bucket=BATCH_LADDER)
    wants, shapes = [], set()
    for x, _y, mask in pipe.host_batches():
        shapes.add(len(mask))
        wants.append(im.do_predict(x)[:int(mask.sum())])
    out["replays"] += len(wants)

    runs = {}
    for name, depth in (("run1", 2), ("run2", 2), ("depth0", 0),
                        ("depth4", 4)):
        t0 = time.perf_counter()
        report = run_job(im, rows, base / name, depth)
        dt = time.perf_counter() - t0
        runs[name] = output_bytes(base / name)
        out["replays"] += n_batches
        print(f"batch: {name} (pipeline_depth {depth}): {report['rows']} "
              f"rows in {report['shards']} shards, {dt:.2f} s = "
              f"{report['rows'] / dt:.1f} rows/s (runner's own "
              f"{report['rows_per_sec']:.1f})", flush=True)
        out.setdefault("rows_per_s", {})[name] = report["rows"] / dt
    manifest = read_manifest(str(base / "run1"))
    shards = [(r["start_row"], r["end_row"]) for r in manifest["shards"]]
    print(f"batch: shards {shards}; the tail batch of {tail} rows pads to "
          f"bucket {tail_bucket}", flush=True)
    if any(runs[k] != runs["run1"] for k in runs):
        cs.fail(f"phase 12: batch outputs differ: "
                f"{[k for k in runs if runs[k] != runs['run1']]} against run1")
    if tail_bucket != 16 or max(shapes) != BATCH_SIZE or tail_bucket not in \
            shapes:
        cs.fail(f"phase 12: the batches are {sorted(shapes)}, the tail "
                f"bucket {tail_bucket}: want 32 and 16")
    print("batch: the two uninterrupted runs and depths 0, 2, 4 are bitwise "
          "equal (shards, MANIFEST.json, COMMIT)", flush=True)

    # -- rows/s and the card's busy share, from one traced pass ------------
    t0 = time.perf_counter()
    wall_ms, busy_ms, summed_ms, names = traced_pass(
        lambda: list(make_job(im, rows, 2).scored_blocks()))
    print(f"batch: the traced pass, its trace's collection and reading "
          f"took {time.perf_counter() - t0:.2f} s", flush=True)
    out["replays"] += n_batches
    out["traced"] = sum("flash_fwd" in n for n in names)
    out["traced_of"] = n_batches * n_block
    out["busy_share"] = busy_ms / wall_ms
    print(f"batch: one traced scoring pass at pipeline_depth 2: wall "
          f"{wall_ms:.1f} ms ({BATCH_ROWS / wall_ms * 1e3:.1f} rows/s), the "
          f"card busy {busy_ms:.1f} ms (its records' summed time "
          f"{summed_ms:.1f} ms): busy share {out['busy_share']:.3f}",
          flush=True)
    cs.check_traced("batch: one scoring pass of "
                    f"{n_batches} replays x {n_block} flash nodes",
                    out["traced"], out["traced_of"])

    # -- every row is do_predict of its batch ------------------------------
    scored = np.concatenate([load_shard_rows(str(base / "run1" / r["file"]))
                             for r in manifest["shards"]])
    want = np.concatenate(wants)
    if scored.shape != want.shape or not np.array_equal(scored, want):
        bad = (np.flatnonzero((scored != want).any(-1))[:1]
               if scored.shape == want.shape else "shape")
        cs.fail(f"phase 12: scored rows differ from do_predict of their "
                f"batch (first {bad})")
    print(f"batch: every one of {BATCH_ROWS} rows bitwise do_predict of its "
          f"batch (batch shapes {sorted(shapes)})", flush=True)

    # -- the kills, then resume in this process ----------------------------
    for point, (kout, _proc) in children.kids.items():
        rc = children.rcs[point]
        want_rc = (-signal.SIGKILL if point == "sigkill"
                   else chaos.EXIT_CODE)
        partial = verify_output(str(kout))
        if rc != want_rc or partial["complete"]:
            cs.fail(f"phase 12: the {point} child exited {rc} (want "
                    f"{want_rc}) with output {partial}")
        t0 = time.perf_counter()
        report = run_job(im, rows, kout, 2, resume=True)
        out["replays"] += -(-(BATCH_ROWS - report["resumed_at_row"])
                            // BATCH_SIZE)
        resumed = output_bytes(kout)
        final = verify_output(str(kout))
        print(f"batch: {point}: the child exited {rc} with "
              f"{partial['shards']} shards ({partial['rows']} rows, "
              f"uncommitted {partial['uncommitted']}); resume from row "
              f"{report['resumed_at_row']} in "
              f"{time.perf_counter() - t0:.2f} s; bitwise the uninterrupted "
              f"run {resumed == runs['run1']}; verify_output {final}",
              flush=True)
        if resumed != runs["run1"] or not final["complete"]:
            cs.fail(f"phase 12: the resume after {point} is not bitwise the "
                    f"uninterrupted run")
    return out


def ncf_save():
    """Save a NeuralCF at phase 3d's configuration with ``save_model`` and
    its rows, in the phase's CPU context (before 12a: the front door's
    process must not initialise CUDA)."""
    from analytics_zoo_tpu_torch.models.recommendation import NeuralCF

    base = PHASE_DIR / "ncf"
    base.mkdir(parents=True)
    NeuralCF(cs.NCF_USERS, cs.NCF_ITEMS, cs.NCF_CLASSES).save_model(
        str(base / "model"))
    rng = np.random.default_rng(3)
    pairs = np.stack([rng.integers(1, cs.NCF_USERS + 1, NCF_ROWS),
                      rng.integers(1, cs.NCF_ITEMS + 1, NCF_ROWS)],
                     axis=1).astype(np.int32)
    np.save(base / "rows.npy", pairs)


def ncf_cli_start():
    """``scripts/torch_batch_predict.py`` on the saved NeuralCF, in a
    child armed to die at ``batch_mid_job_kill``."""
    base = PHASE_DIR / "ncf"
    argv = ["--model", str(base / "model"), "--input",
            str(base / "rows.npy"), "--batch", str(NCF_BATCH),
            "--buckets", ",".join(map(str, NCF_LADDER)),
            "--rows-per-shard", str(NCF_SHARD),
            "--checkpoint-every", "1", "--device", "cuda"]
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               AZOO_FT_CHAOS="batch_mid_job_kill", AZOO_FT_CHAOS_SKIP="1")
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "scripts" / "torch_batch_predict.py"),
         *argv, "--output", str(base / "out")], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return {"base": base, "argv": argv, "proc": proc}


def ncf_cli_finish(ncf):
    """The uninterrupted run, then ``--resume`` of the killed child's
    output, both through the CLI's ``main`` in this process: bitwise."""
    from analytics_zoo_tpu_torch.batch import verify_output

    sys.path.insert(0, str(ROOT / "scripts"))
    import torch_batch_predict

    base, argv, killed = ncf["base"], ncf["argv"], ncf["proc"]
    t0 = time.perf_counter()
    ref = torch_batch_predict.main(argv + ["--output", str(base / "ref")])
    print(f"ncf: NeuralCF({cs.NCF_USERS}, {cs.NCF_ITEMS}, "
          f"{cs.NCF_CLASSES}) saved with save_model; the CLI scored "
          f"{ref['rows']} rows in {ref['shards']} shards in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    partial = verify_output(str(base / "out"))
    if killed.returncode != 43 or partial["complete"]:
        cs.fail(f"phase 12: the CLI child exited {killed.returncode} with "
                f"{partial}: {ncf['stderr'][-2000:]}")
    t0 = time.perf_counter()
    resumed = torch_batch_predict.main(
        argv + ["--output", str(base / "out"), "--resume"])
    same = output_bytes(base / "out") == output_bytes(base / "ref")
    print(f"ncf: the CLI killed at batch_mid_job_kill exited "
          f"{killed.returncode} with {partial['shards']} shards; --resume "
          f"from row {resumed['resumed_at_row']} in "
          f"{time.perf_counter() - t0:.2f} s; bitwise the uninterrupted run "
          f"{same}", flush=True)
    if not (same and resumed["complete"]):
        cs.fail("phase 12: the CLI's kill and --resume are not bitwise the "
                "uninterrupted run")


# ---------------------------------------------------------------------------
# the phase
# ---------------------------------------------------------------------------


def frontdoor_batch_phase(seed, parent_context=False):
    """Phase 12. Returns {"launches": [fwd, dq, dkv] by this process's
    wrappers, "replay_launches": flash forward launches in this process's
    graph replays, "replay_traced": those traced in one scoring pass of
    "replay_traced_of", "worker_launches": the workers' wrapper launches
    at register, ...}."""
    from analytics_zoo_tpu_torch import init_nncontext, stop_nncontext
    from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts
    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    n_block = BERT["n_block"]
    t_phase = time.perf_counter()
    shutil.rmtree(PHASE_DIR, ignore_errors=True)
    info_dir = PHASE_DIR / "workers"
    info_dir.mkdir(parents=True)
    rng = np.random.default_rng(seed)

    # the weights, drawn on the CPU from the seed and written once, and
    # the CLI's saved NeuralCF
    t0 = time.perf_counter()
    init_nncontext(device="cpu", seed=seed)
    net = build_net(BERT)
    weights = str(PHASE_DIR / "bert_weights")
    net.save_weights(weights)
    ncf_save()
    stop_nncontext()
    reset_name_counts()
    print(f"frontdoor: BERT {BERT} weights drawn from seed {seed} and saved "
          f"once, NeuralCF saved, in {time.perf_counter() - t0:.2f} s",
          flush=True)
    env_cfg = dict(weights=weights, info_dir=str(info_dir))
    base = PHASE_DIR / "batch"
    base.mkdir(parents=True)

    times = {}
    fleet = FleetBoot(env_cfg)
    children = Children(weights, seed + 1, base)
    try:
        t0 = time.perf_counter()
        fd_out = frontdoor_part(env_cfg, rng, parent_context, fleet,
                                children)
        times["12a (the fleet's boot and 12c's children included)"] = \
            time.perf_counter() - t0
        t0 = time.perf_counter()
        fleet_part(fleet, rng, parent_context)
        times["12b"] = time.perf_counter() - t0
    finally:
        fleet.shutdown()
        children.stop()
    check_contexts("after 12a and 12b", [], parent_context)
    print("frontdoor: the front-door and fleet-door process has not "
          "initialised CUDA after all their traffic", flush=True)

    # -- 12c: this process on the card --------------------------------------
    t0 = time.perf_counter()
    init_nncontext(device="cuda", seed=seed)
    im = load_bert(weights)
    cs.zero_launches(fa)  # this process's main path starts here
    seq = BERT["seq_len"]
    for b in LADDER:
        im.do_optimize([np.zeros((b, seq), np.int32),
                        np.zeros((b, seq), np.int32),
                        np.ones((b, seq), np.float32)])
    cs.check_bucket_graphs(im, n_block, "frontdoor")
    replays = 0
    for x in fd_out["probes"]:
        got = im.do_predict(x)
        replays += 1
        if not np.array_equal(got, fd_out["answers"][len(x[0])]):
            cs.fail(f"phase 12: bucket {len(x[0])}: the workers' answer is "
                    f"not bitwise this process's replay")
    print(f"frontdoor: this process's replay of every bucket "
          f"{list(LADDER)} is bitwise the workers' answers", flush=True)
    batch_out = batch_part(im, seed + 1, base, children)
    replays += batch_out["replays"]
    launches = cs.read_launches(fa)
    times["12c"] = time.perf_counter() - t0
    want = 2 * n_block * len(LADDER)
    print(f"frontdoor: this process's flash wrapper launches {launches} "
          f"(want [{want}, 0, 0]: each bucket's eager warm-up and capture), "
          f"graph replays {replays} x {n_block} flash nodes", flush=True)
    if launches != [want, 0, 0]:
        cs.fail("phase 12: the flash kernels' launches are off")
    t0 = time.perf_counter()
    ncf_cli_finish(children.ncf)
    times["12c ncf"] = time.perf_counter() - t0
    im.release()
    torch.cuda.empty_cache()
    total = time.perf_counter() - t_phase
    print(f"frontdoor: phase 12 took {total:.1f} s: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in times.items()),
          flush=True)
    shutil.rmtree(PHASE_DIR, ignore_errors=True)
    return {"launches": launches, "replay_launches": replays * n_block,
            "replay_traced": batch_out["traced"],
            "replay_traced_of": batch_out["traced_of"],
            "worker_launches": fd_out["wrapper_launches"],
            "workers_booted": fd_out["workers_booted"],
            "seconds": total, "parts": times,
            "requests_per_s": {k: fd_out[k] for k in
                               ("2 workers", "1 worker", "direct engine")},
            "spawn_s": fd_out["spawn_s"],
            "batch_rows_per_s": batch_out["rows_per_s"],
            "batch_busy_share": batch_out["busy_share"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=12)
    ap.add_argument("--result", default=None,
                    help="write the phase's result JSON here")
    ap.add_argument("--parent-holds-context", action="store_true",
                    help="the parent process (chip_smoke.py) holds a CUDA "
                         "context on the card")
    ap.add_argument("--batch-child", default=None,
                    help="12c's armed child (started by 12c)")
    args = ap.parse_args(argv)
    if args.batch_child:
        return batch_child(args)
    if not torch.cuda.is_available():
        print("torch_frontdoor_batch_phase: needs a CUDA card",
              file=sys.stderr)
        return 2
    from analytics_zoo_tpu_torch.ops import _kernels

    print(cs.smi_line(), torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    _kernels.build(_kernels.KERNELS)  # in this process: no context
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    result = frontdoor_batch_phase(args.seed, args.parent_holds_context)
    if args.result:
        Path(args.result).write_text(json.dumps(result))
    print("frontdoor: phase 12 passed", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
