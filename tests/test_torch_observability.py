"""The observability plane — tracer, metrics registry and its Prometheus
text, flight recorder, SLO engine, profiling helpers — held alike in the
JAX package and the port's copies (every shared case runs once per
package), and the parts the port rewrote: ``zoo_build_info``'s labels, the
compile accounting fed by ``ops._kernels``, the launch counters and
``profile_trace`` on ``torch.profiler``."""

import importlib
import json
import os
import re
import threading
import types

import pytest

from analytics_zoo_tpu_torch.ops import _kernels

PKGS = pytest.mark.parametrize("root", ["analytics_zoo_tpu",
                                        "analytics_zoo_tpu_torch"],
                               ids=["jax", "port"])


def _ns(root):
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        obs=mod("common.observability"), fr=mod("common.flight_recorder"),
        slo=mod("common.slo"), prof=mod("common.profiling"),
        metrics=mod("serving.metrics"))


_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*?)\})? ([^ ]+)'
                     r'( # \{[^}]*\} [^ ]+)?$')
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"(?:,|$)')


def parse_exposition(text):
    """A strict reading of the Prometheus text format: HELP and TYPE
    before a family's first sample, well-formed labels, float values.
    Returns {family: {"type", "samples": [(name, labels, value)]}}."""
    fams, seen = {}, set()
    for line in text.splitlines():
        if line.startswith(("# HELP ", "# TYPE ")):
            kind, name, rest = line[2:6], *line[7:].split(" ", 1)
            assert name not in seen, f"{kind} of {name} after its samples"
            fams.setdefault(name, {"type": None, "help": None,
                                   "samples": []})
            fams[name]["help" if kind == "HELP" else "type"] = rest
            continue
        if not line.strip() or line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        assert m, f"unparseable sample {line!r}"
        name = m.group(1)
        base = next((name[:-len(s)] for s in ("_sum", "_count")
                     if name.endswith(s) and name[:-len(s)] in fams), name)
        assert base in fams and fams[base]["type"] and fams[base]["help"], \
            f"{name} sampled before HELP and TYPE"
        seen.add(base)
        raw = m.group(3) or ""
        assert sum(len(x.group(0)) for x in _LABEL.finditer(raw)) == \
            len(raw), f"malformed labels {raw!r}"
        labels = {x.group(1): x.group(2).replace('\\"', '"')
                  .replace("\\n", "\n").replace("\\\\", "\\")
                  for x in _LABEL.finditer(raw)}
        fams[base]["samples"].append((name, labels, float(m.group(4))))
    return fams


@pytest.fixture
def tracer():
    """Each package's global tracer, enabled and empty for the test,
    disabled and drained afterwards."""
    made = []

    def get(root):
        t = _ns(root).obs.get_tracer()
        t.clear()
        t.enable()
        made.append(t)
        return t

    yield get
    for t in made:
        t.disable()
        t.clear()


@PKGS
def test_span_nesting_propagation_and_chrome_export(root, tracer, tmp_path):
    t = tracer(root)
    with t.span("root", model="m") as r:
        with t.span("child") as c:
            assert c.trace_id == r.trace_id and c.parent_id == r.span_id
        assert t.current() is r
    assert t.current() is None
    with t.span("other") as o:
        pass
    assert o.trace_id != r.trace_id
    assert [s.name for s in t.spans()] == ["child", "root", "other"]
    doc = json.loads(t.export_chrome_trace(str(tmp_path / "t.json")))
    events = {e["name"]: e for e in doc["traceEvents"]}
    assert events["child"]["args"]["parent_id"] == \
        events["root"]["args"]["span_id"]
    assert events["root"]["args"]["model"] == "m"


@PKGS
def test_cross_thread_record_and_bounded_ring(root, tracer):
    obs = _ns(root).obs
    t = tracer(root)
    tid = obs.new_trace_id()
    t0 = obs.monotonic_s()
    th = threading.Thread(target=lambda: t.record_span(
        "bg", tid, t0, obs.monotonic_s(), rows=3))
    th.start()
    th.join(timeout=10)
    (s,) = t.spans()
    assert s.trace_id == tid and s.attrs["rows"] == 3
    small = obs.Tracer(max_spans=4)
    small.enable()
    for i in range(10):
        with small.span(f"s{i}"):
            pass
    assert [s.name for s in small.spans()] == ["s6", "s7", "s8", "s9"]


@PKGS
def test_disabled_tracer_records_nothing(root):
    t = _ns(root).obs.get_tracer()
    t.clear()
    assert not t.enabled
    with t.span("invisible") as sp:
        assert sp is None
    assert t.record_span("x", "tid", 0.0, 1.0) is None and t.spans() == []


@PKGS
def test_traceparent_parse_and_format(root):
    obs = _ns(root).obs
    tid = obs.parse_traceparent(
        "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01")
    assert tid == "8448eb211c80319c"
    assert obs.parse_traceparent("garbage") is None
    assert obs.parse_traceparent(
        "00-" + "0" * 32 + "-b7ad6b7169203331-01") is None
    out = obs.format_traceparent(tid)
    assert obs.parse_traceparent(out) == tid


@PKGS
def test_registry_render_grammar_and_schema(root):
    obs = _ns(root).obs
    reg = obs.MetricsRegistry()
    c = reg.counter("t_requests_total", "Requests.", labels=("model",))
    reg.gauge("t_depth", "Depth.").child().set(5)
    s = reg.summary("t_latency_seconds", "Latency.", labels=("model",))
    c.labels(model="a").inc(2)
    for i in range(5):
        s.labels(model="a").observe(0.01 * (i + 1), trace_id=f"{i:016x}")
    fams = parse_exposition(reg.render())
    assert fams["t_requests_total"]["samples"] == [
        ("t_requests_total", {"model": "a"}, 2.0)]
    assert fams["t_depth"]["samples"] == [("t_depth", {}, 5.0)]
    assert {n for n, _, _ in fams["t_latency_seconds"]["samples"]} == {
        "t_latency_seconds", "t_latency_seconds_sum",
        "t_latency_seconds_count"}
    assert ' # {trace_id="' in reg.render()
    assert reg.counter("t_requests_total", "again",
                       labels=("model",)) is c
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("t_requests_total", "not a counter")
    with pytest.raises(ValueError):
        c.labels(model="m").inc(-1)


@PKGS
def test_serving_metrics_escape_and_grammar(root):
    sm = _ns(root).metrics.ServingMetrics()
    weird = 'na"me\\with\nthe lot'
    sm.for_model(weird).requests.inc(7)
    m = sm.for_model("m1")
    m.batch_fill.observe(0.75)
    m.latency.observe(0.01)
    fams = parse_exposition(sm.render())
    assert ("zoo_serving_requests_total", {"model": weird}, 7.0) in \
        fams["zoo_serving_requests_total"]["samples"]
    for fam in ("zoo_serving_batch_fill_ratio", "zoo_serving_latency_seconds",
                "zoo_serving_queue_depth", "zoo_serving_flushes_total"):
        assert fam in fams


def test_port_families_are_the_jax_families():
    """A fresh engine metrics object of each package renders the same
    family names with the same types."""
    j, p = (parse_exposition(_ns(r).metrics.ServingMetrics().render())
            for r in ("analytics_zoo_tpu", "analytics_zoo_tpu_torch"))
    assert {k: v["type"] for k, v in j.items()} == \
        {k: v["type"] for k, v in p.items()}


def test_build_info_names_torch_cuda_and_device():
    obs = _ns("analytics_zoo_tpu_torch").obs
    import torch

    import analytics_zoo_tpu_torch as port

    reg = obs.MetricsRegistry()
    obs.build_info(reg)
    (_, labels, value), = parse_exposition(
        reg.render())["zoo_build_info"]["samples"]
    assert value == 1.0
    assert labels == {"version": port.__version__,
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda or "none",
                      "device": "cpu"}


def test_compile_accounting_counts_port_compiles():
    """``zoo_compile_total`` / ``zoo_compile_seconds_total`` count what
    ``ops._kernels.compiled`` reports: each nvcc build and each CUDA
    graph capture (here reported directly: neither can run on the CPU)."""
    obs = _ns("analytics_zoo_tpu_torch").obs
    reg = obs.get_registry()  # installs the listener
    assert not obs.install_compile_listener()  # once per process
    n = reg.counter("zoo_compile_total", "").labels()
    secs = reg.counter("zoo_compile_seconds_total", "").labels()
    before = (n.value, secs.value)
    _kernels.compiled(0.25)
    _kernels.compiled(0.5)
    assert (n.value, secs.value) == (before[0] + 2, before[1] + 0.75)


def test_launch_counter_counts_every_call_across_threads():
    """Every wrapper call adds one, whichever thread makes it (a launch
    into a CUDA graph being captured included: nothing reroutes it)."""
    c = _kernels.LaunchCounter()
    threads = [threading.Thread(target=lambda: [c.add() for _ in range(50)])
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert c.count == 200
    c.reset()
    assert c.count == 0


_FAKE_NVCC = """#!/bin/sh
out=""; src=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; shift 2; else src="$1"; shift; fi
done
case "$src" in *slow.cu) sleep 1;; esac
echo built > "$out"
"""


def test_build_reports_each_job_its_own_seconds(monkeypatch, tmp_path):
    """The builds run together, and each reports the seconds from its own
    start to its own end: a fast source listed after a slow one does not
    report the slow one's time."""
    src, out = tmp_path / "csrc", tmp_path / "build"
    src.mkdir()
    for name in ("slow", "fast"):
        (src / f"{name}.cu").write_text(f"// {name}\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    seconds = []
    monkeypatch.setattr(_kernels, "SRC_DIR", src)
    monkeypatch.setattr(_kernels, "BUILD_DIR", out)
    monkeypatch.setattr(_kernels, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_kernels, "_compile_listeners", [seconds.append])
    logs = _kernels.build(("slow", "fast"))
    assert sorted(logs) == ["fast", "slow"]
    assert all(_kernels._paths(n)[1].exists() for n in ("slow", "fast"))
    slow, fast = seconds
    assert slow >= 1.0 and fast < 0.5, seconds
    assert _kernels.build(("slow", "fast")) == {} and len(seconds) == 2


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    import torch

    prof = _ns("analytics_zoo_tpu_torch").prof
    with prof.profile_trace(str(tmp_path)) as p:
        torch.ones(64, 64) @ torch.ones(64, 64)
    doc = json.load(open(tmp_path / "trace.json"))
    assert doc["traceEvents"]
    assert any(e.key for e in p.key_averages())


@PKGS
def test_step_timer_and_timing(root):
    prof = _ns(root).prof
    st = prof.StepTimer(items_per_step=8, warmup=0)
    for _ in range(3):
        with st.step():
            pass
    out = st.summary()
    assert out["steps"] == 3 and "items_per_sec" in out
    with prof.timing("block") as t:
        pass
    assert t["elapsed"] >= 0.0


@PKGS
def test_flight_recorder_ring_dump_and_corruption(root, tmp_path):
    ns = _ns(root)
    d = str(tmp_path / "dumps")
    fr = ns.fr.FlightRecorder(capacity=4, dump_dir=d,
                              registry=ns.obs.MetricsRegistry())
    for i in range(6):
        fr.finish(fr.begin("m", trace_id=f"{i:016x}"), "ok")
    inflight = fr.begin("m", trace_id="c" * 16)
    assert fr.snapshot()[-1]["outcome"] is None
    assert [r["trace_id"] for r in fr.snapshot()][:3] == \
        [f"{i:016x}" for i in (3, 4, 5)]
    path = fr.dump("manual")
    header, records = ns.fr.read_dump(path)
    assert header["format"] == "azoo-flight-v1"
    assert header["pid"] == os.getpid()
    assert records[-1]["trace_id"] == "c" * 16
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]
    data = bytearray(open(path, "rb").read())
    data[-2] ^= 0x01
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(ns.fr.FlightDumpCorruptError):
        ns.fr.read_dump(path)
    fr.finish(inflight, "ok")


@PKGS
def test_flight_triggers_rate_limited_and_counted(root, tmp_path):
    ns = _ns(root)
    reg = ns.obs.MetricsRegistry()
    fr = ns.fr.FlightRecorder(capacity=4, dump_dir=str(tmp_path), registry=reg,
                              min_dump_interval_s=3600.0)
    fr.finish(fr.begin("m"), "ok")
    assert fr.trigger("watchdog_restart") is not None
    assert fr.trigger("watchdog_restart") is None
    assert len(ns.fr.list_dumps(str(tmp_path))) == 1
    assert 'zoo_flight_triggers_total{trigger="watchdog_restart"} 2' in \
        reg.render()


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@PKGS
def test_slo_burn_rates_and_edge_triggered_alerts(root):
    ns = _ns(root)
    clock = FakeClock()
    reg = ns.obs.MetricsRegistry()
    eng = ns.slo.SLOEngine(registry=reg, clock=clock)
    eng.add_objective(ns.slo.SLOObjective("availability:m", target=0.999))
    for i in range(1000):
        eng.record("availability:m", good=(i % 100 != 0))
    o = eng.evaluate()["objectives"][0]
    assert o["windows"]["5m"]["burn_rate"] == pytest.approx(10.0)
    assert o["alerting"] == ["30m"]
    clock.advance(400.0)
    o = eng.evaluate()["objectives"][0]
    assert o["windows"]["5m"]["total"] == 0
    assert o["windows"]["6h"]["bad"] == 10
    for i in range(100):
        eng.record("availability:m", good=False, trace_id=f"{i:016x}")
    o = eng.evaluate()["objectives"][0]
    assert set(o["alerting"]) == {"5m", "30m"}
    assert o["last_bad_trace_id"] == f"{99:016x}"
    eng.evaluate()
    fams = parse_exposition(reg.render())
    alerts = {s[1]["window"]: s[2]
              for s in fams["zoo_slo_alerts_total"]["samples"]}
    assert alerts["5m"] == 1.0
    assert [(p.fast_label, p.slow_label, p.threshold)
            for p in ns.slo.DEFAULT_PAIRS] == [("5m", "1h", 14.4),
                                               ("30m", "6h", 6.0)]


@PKGS
def test_inference_cache_counters_shared_children(root):
    obs = _ns(root).obs
    c = obs.inference_cache_counters()
    assert set(c) == {"hits", "misses", "evictions", "warmup_overflow"}
    assert obs.inference_cache_counters()["hits"] is c["hits"]
    before = c["misses"].value
    c["misses"].inc()
    assert 'zoo_inference_cache_events_total{event="misses"} ' \
        f'{before + 1:g}' in obs.get_registry().render()
