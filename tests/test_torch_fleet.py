"""The port's fleet fabric (the cases of tests/test_fleet.py, on the
port): shared membership, cross-host sticky routing, the replicated
control plane, the cooperative result cache and elasticity, plus the
tree codec across the two packages.

The in-process cases drive every protocol with injected clocks
(membership failure detection, quota snapshot/restore, interval-point
routing, autoscaler hysteresis, the tree codec). The rest boot a real
fleet: two in-process fleet doors, each prefork-spawning port workers
from tests/_torch_frontdoor_spec.py. They share one module-scoped 2-host
fleet; the whole-host kill runs last on it.
"""

import json
import os
import shutil
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from analytics_zoo_tpu_torch.common.observability import get_tracer
from analytics_zoo_tpu_torch.ft import chaos
from analytics_zoo_tpu_torch.serving.fabric import (
    Autoscaler,
    AutoscalerConfig,
    FleetConfig,
    FleetDoor,
    Membership,
    decode_tree,
    encode_tree,
    fleet_pick,
)
from analytics_zoo_tpu_torch.serving.frontdoor import merge_expositions
from analytics_zoo_tpu_torch.serving.quota import (
    QuotaConfig,
    QuotaExceededError,
    QuotaManager,
    TenantQuota,
    TokenBucket,
)

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
SPEC = os.path.join(TESTS_DIR, "_torch_frontdoor_spec.py") + \
    ":build_fleet_engine"

LIN = "/v1/models/lin:predict"
PID = "/v1/models/pid:predict"
VER = "/v1/models/ver:predict"
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


def _admin(base, payload):
    return _post(base, "/v1/admin/rollout", json.dumps(payload).encode())


def _key_owned_by(owner, roster=("a", "b"), self_id="a", prefix="k"):
    """A route key whose roster interval belongs to ``owner``."""
    for i in range(1000):
        key = f"{prefix}-{i}"
        if fleet_pick(roster, roster, self_id, key) == owner:
            return key
    raise AssertionError(f"no key maps to {owner}")


def _sample_sum(text, family, **labels):
    """Sum of all samples of ``family`` whose label set includes
    ``labels`` (Prometheus text exposition)."""
    total, found = 0.0, False
    for line in text.splitlines():
        if not line.startswith(family):
            continue
        rest = line[len(family):]
        if not (rest.startswith("{") or rest.startswith(" ")):
            continue
        if any(f'{k}="{v}"' not in line for k, v in labels.items()):
            continue
        total += float(line.rsplit(" ", 1)[1])
        found = True
    assert found, f"no {family} samples with {labels}"
    return total


# ---------------------------------------------------------------------------
# Quota snapshot / restore (the replication primitive)
# ---------------------------------------------------------------------------


def test_quota_snapshot_roundtrip_is_clock_safe():
    t1 = [1000.0]
    qm = QuotaManager(QuotaConfig(
        tenants={"t": TenantQuota(rate=1.0, burst=4.0)},
        default=TenantQuota(rate=2.0, burst=2.0),
        metric_tenants=("watched",)), clock=lambda: t1[0])
    for _ in range(3):
        qm.check("t")               # 1 token left
    qm.check("lazy")                # default bucket created, 1 left
    snap = json.loads(json.dumps(qm.snapshot()))     # JSON-safe
    assert snap["buckets"]["t"] == pytest.approx(1.0)
    assert snap["buckets"]["lazy"] == pytest.approx(1.0)
    assert snap["config"]["metric_tenants"] == ["watched"]

    # restore into a manager on a WILDLY different clock — refill must
    # re-anchor locally, not honor any foreign timestamp
    t2 = [3.0]
    qm2 = QuotaManager(clock=lambda: t2[0])
    qm2.restore(snap)
    qm2.check("t")                  # the surviving token
    with pytest.raises(QuotaExceededError):
        qm2.check("t")
    t2[0] += 1.0                    # rate=1 → exactly one token back
    qm2.check("t")
    # the lazily-created default bucket replicated too: it restored
    # with 1 token and refilled 2 (rate 2/s × 1s, clamped to burst 2)
    qm2.check("lazy")
    qm2.check("lazy")
    with pytest.raises(QuotaExceededError):
        qm2.check("lazy")


def test_bucket_restore_clamps_to_burst():
    t = [0.0]
    b = TokenBucket(TenantQuota(rate=1.0, burst=3.0), clock=lambda: t[0])
    b.restore_tokens(99.0)
    assert b.tokens() == pytest.approx(3.0)
    b.restore_tokens(-5.0)
    assert b.tokens() == pytest.approx(0.0)
    t[0] += 1.5                     # refill re-anchored at the restore
    assert b.tokens() == pytest.approx(1.5)


def test_quota_restore_skips_unlimited_tenants():
    qm = QuotaManager()             # no tenants, no default
    qm.restore({"config": {"default": None, "tenants": {},
                           "metric_tenants": []},
                "buckets": {"ghost": 0.0}})
    qm.check("ghost")               # unlimited here — no bucket adopted


# ---------------------------------------------------------------------------
# Membership (injected clock: no threads, no sleeps)
# ---------------------------------------------------------------------------


def _manual_pair(tmp_path):
    t = [0.0]
    clock = lambda: t[0]            # noqa: E731
    a = Membership(str(tmp_path), "a", "http://x:1",
                   heartbeat_interval_s=0.1, stale_after=3, clock=clock)
    b = Membership(str(tmp_path), "b", "http://x:2",
                   heartbeat_interval_s=0.1, stale_after=3, clock=clock)
    return t, a, b


def test_membership_converges_and_detects_death(tmp_path):
    t, a, b = _manual_pair(tmp_path)
    a.beat_once(); b.beat_once()
    v = a.poll()
    assert set(v.live) == {"a", "b"} and v.self_ok
    e0 = a.epoch
    # b's beat goes flat; a keeps beating. Liveness is beat PROGRESS —
    # within dead_after_s b stays live, past it b is dead
    t[0] += 0.2
    a.beat_once()
    assert set(a.poll().live) == {"a", "b"}
    t[0] += 0.2                     # b flat for 0.4s > 0.3s dead_after
    a.beat_once()
    v = a.poll()
    assert set(v.live) == {"a"}
    assert "b" in v.roster          # dead ≠ gone: roster keeps it
    assert a.epoch > e0             # live-set change bumped the epoch

    # b beats again → rejoins, epoch bumps again
    e1 = a.epoch
    b.beat_once()
    v = a.poll()
    assert set(v.live) == {"a", "b"} and a.epoch > e1


def test_membership_clean_leave_drops_from_roster(tmp_path):
    t, a, b = _manual_pair(tmp_path)
    a.beat_once(); b.beat_once()
    assert set(a.poll().roster) == {"a", "b"}
    b.leave()
    v = a.poll()
    assert "b" not in v.roster and set(v.live) == {"a"}


def test_membership_suspect_is_immediate_and_clears_on_beat(tmp_path):
    t, a, b = _manual_pair(tmp_path)
    a.beat_once(); b.beat_once()
    a.poll()
    a.suspect("b")                  # transport failure: dead NOW
    assert not a.view().is_live("b")
    a.suspect("a")                  # self-suspicion is a no-op
    assert a.view().is_live("a")
    b.beat_once()                   # the suspect proves liveness
    assert a.poll().is_live("b")


def test_membership_self_stale_when_own_beats_stop(tmp_path):
    t, a, b = _manual_pair(tmp_path)
    a.beat_once(); b.beat_once()
    assert a.poll().self_ok
    # a stops heartbeating (wedged writer); even reading fresh state it
    # must consider ITSELF partitioned once its beat is flat
    t[0] += 0.4
    b.beat_once()
    v = a.poll()
    assert not v.self_ok
    assert "a" not in v.live


def test_membership_torn_and_foreign_files_are_skipped(tmp_path):
    t, a, b = _manual_pair(tmp_path)
    a.beat_once()
    hosts = os.path.join(str(tmp_path), "hosts")
    with open(os.path.join(hosts, "torn.json"), "w") as f:
        f.write('{"host_id": "t"')          # unfinished write
    with open(os.path.join(hosts, ".c.tmp"), "w") as f:
        f.write("{}")                        # in-flight temp
    with open(os.path.join(hosts, "notes.txt"), "w") as f:
        f.write("hi")
    v = a.poll()
    assert set(v.roster) == {"a"}


# ---------------------------------------------------------------------------
# fleet_pick: the interval-point math, one level up
# ---------------------------------------------------------------------------


def test_fleet_pick_remaps_exactly_the_dead_interval():
    roster = ["a", "b", "c"]
    keys = [f"key-{i}" for i in range(200)]
    full = {k: fleet_pick(roster, roster, "a", k) for k in keys}
    assert set(full.values()) == {"a", "b", "c"}    # all intervals hit
    down = {k: fleet_pick(roster, ["a", "c"], "a", k) for k in keys}
    for k in keys:
        if full[k] != "b":
            assert down[k] == full[k], f"{k} moved while its host lived"
        else:
            assert down[k] in ("a", "c")
    # the dead host rejoining takes its old interval back, bit-for-bit
    back = {k: fleet_pick(roster, roster, "a", k) for k in keys}
    assert back == full


def test_fleet_pick_keyless_and_degenerate_cases():
    assert fleet_pick(["a", "b"], ["a", "b"], "a", None) == "a"
    assert fleet_pick(["a", "b"], ["a", "b"], "b", None) == "b"
    assert fleet_pick(["a"], ["a"], "a", "k") == "a"
    # every interval owner dead → serve where you stand
    assert fleet_pick(["a", "b"], [], "a", "k") == "a"
    # entry door does not bias the pick: same key, same owner
    k = "stable-key"
    assert (fleet_pick(["a", "b"], ["a", "b"], "a", k)
            == fleet_pick(["a", "b"], ["a", "b"], "b", k))


# ---------------------------------------------------------------------------
# Exposition merging, level two
# ---------------------------------------------------------------------------


def test_merge_expositions_host_label_level():
    per_host = (
        "# HELP zoo_x_total things\n"
        "# TYPE zoo_x_total counter\n"
        'zoo_x_total{worker="0"} 1\n'
        'zoo_x_total{worker="1"} 2 # {trace_id="abc"} 1\n')
    merged = merge_expositions(
        [("a", per_host), ("b", per_host)], label="host")
    assert merged.count("# HELP zoo_x_total") == 1
    assert merged.count("# TYPE zoo_x_total") == 1
    assert 'zoo_x_total{host="a",worker="0"} 1' in merged
    assert 'zoo_x_total{host="b",worker="1"} 2 # {trace_id="abc"} 1' \
        in merged                    # exemplar survives the second merge


# ---------------------------------------------------------------------------
# Autoscaler hysteresis (pure decisions)
# ---------------------------------------------------------------------------


def test_autoscaler_scales_up_fast_down_slow():
    sc = Autoscaler(config=AutoscalerConfig(
        min_workers=1, max_workers=4, high_queue_depth=4.0,
        low_queue_depth=0.5, scale_down_ticks=3, cooldown_ticks=2))
    hot = {"0": 9.0, "1": 3.0}       # mean 6.0 > 4.0
    assert sc.observe(hot, 2) == 3                  # one hot tick: up
    assert sc.observe(hot, 3) == 3                  # cooldown tick 1
    assert sc.observe(hot, 3) == 3                  # cooldown tick 2
    assert sc.observe(hot, 3) == 4                  # hot again: up
    sc2 = Autoscaler(config=AutoscalerConfig(
        min_workers=1, max_workers=4, scale_down_ticks=3,
        cooldown_ticks=0))
    idle = {"0": 0.0, "1": 0.0, "2": 0.0}
    assert sc2.observe(idle, 3) == 3                # low tick 1
    assert sc2.observe(idle, 3) == 3                # low tick 2
    assert sc2.observe(idle, 3) == 2                # low tick 3: down
    # a busy tick resets the down-counter
    assert sc2.observe(idle, 2) == 2
    assert sc2.observe({"0": 2.0}, 2) == 2          # mid-band: reset
    assert sc2.observe(idle, 2) == 2
    assert sc2.observe(idle, 2) == 2
    assert sc2.observe(idle, 2) == 1


def test_autoscaler_respects_bounds_and_validates():
    sc = Autoscaler(config=AutoscalerConfig(min_workers=2,
                                            max_workers=2))
    assert sc.observe({"0": 99.0, "1": 99.0}, 2) == 2
    with pytest.raises(ValueError):
        AutoscalerConfig(low_queue_depth=5.0, high_queue_depth=4.0)
    with pytest.raises(ValueError):
        AutoscalerConfig(min_workers=0)
    with pytest.raises(RuntimeError):
        Autoscaler().tick()          # no front door attached


# ---------------------------------------------------------------------------
# Tree codec (the cooperative cache's wire format)
# ---------------------------------------------------------------------------


def test_tree_codec_roundtrip_is_bitwise():
    tree = {
        "logits": np.arange(12, dtype=np.float32).reshape(3, 4) / 7.0,
        "nested": [np.array([np.nan, np.inf, -0.0]),
                   ("txt", 3, None, True)],
        "meta": {"version": "2"},
    }
    out = decode_tree(encode_tree(tree))
    assert out["logits"].dtype == np.float32
    assert out["logits"].tobytes() == tree["logits"].tobytes()
    assert np.array_equal(out["nested"][0], tree["nested"][0],
                          equal_nan=True)
    assert out["nested"][1] == ("txt", 3, None, True)
    assert isinstance(out["nested"][1], tuple)
    assert out["meta"] == {"version": "2"}


def test_tree_codec_rejects_unshareable_trees():
    with pytest.raises(TypeError):
        encode_tree({"f": lambda: 1})
    with pytest.raises(TypeError):
        encode_tree(np.array([object()]))
    with pytest.raises(TypeError):
        encode_tree({1: np.zeros(2)})        # non-string dict key


def test_tree_codec_decode_never_executes():
    # hostile bytes fail to decode (allow_pickle=False) — they must
    # raise, not run
    with pytest.raises(Exception):
        decode_tree(b"not an npz payload at all")


def test_tree_codec_crosses_packages_bitwise():
    """A tree encoded by either package decodes with the other's codec
    to the same bytes: port and JAX fleets can share cache entries."""
    from analytics_zoo_tpu.serving.fabric import coopcache as jax_codec

    tree = {
        "logits": np.arange(12, dtype=np.float32).reshape(3, 4) / 7.0,
        "ids": np.array([[1, 2], [3, 4]], np.int64),
        "nested": [np.array([np.nan, np.inf, -0.0]),
                   ("txt", 3, None, True)],
        "meta": {"version": "2"},
    }
    for enc, dec in ((encode_tree, jax_codec.decode_tree),
                     (jax_codec.encode_tree, decode_tree)):
        payload = enc(tree)
        out = dec(payload)
        for k in ("logits", "ids"):
            assert out[k].dtype == tree[k].dtype
            assert out[k].tobytes() == tree[k].tobytes()
        assert out["nested"][0].tobytes() == tree["nested"][0].tobytes()
        assert out["nested"][1] == ("txt", 3, None, True)
        assert out["meta"] == {"version": "2"}
    assert encode_tree(tree) == jax_codec.encode_tree(tree)


# ---------------------------------------------------------------------------
# trace_dump: the fleet timeline view
# ---------------------------------------------------------------------------


def test_trace_dump_renders_host_column():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "_trace_dump", os.path.join(os.path.dirname(TESTS_DIR),
                                    "scripts", "trace_dump.py"))
    td = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(td)
    doc = {"trace_id": "abc", "anchors": {"a/frontdoor": 1.0},
           "spans": [
               {"name": "fleet.proxy", "host": "a",
                "worker": "frontdoor", "wall_start": 1.0,
                "duration": 0.002, "attrs": {}},
               {"name": "batcher.flush", "host": "b", "worker": "0",
                "wall_start": 1.001, "duration": 0.001, "attrs": {}}]}
    out = td.dump_merged(doc)
    lines = out.splitlines()
    assert lines[1].split() == ["host", "worker", "span", "t+ms",
                                "dur_ms", "attrs"]
    assert any(l.startswith("b") and "batcher.flush" in l
               for l in lines)
    # single-host docs (no "host" on spans) keep the old shape
    for s in doc["spans"]:
        del s["host"]
    assert td.dump_merged(doc).splitlines()[1].split()[0] == "worker"


# ---------------------------------------------------------------------------
# The real thing: two fleet doors, real worker subprocesses
# ---------------------------------------------------------------------------


def _boot_pair(tmp, workers=2, **kw):
    cfg = dict(spec=SPEC, fleet_dir=tmp, workers=workers,
               heartbeat_interval_s=0.1, worker_boot_timeout_s=90,
               **kw)
    a = FleetDoor(FleetConfig(host_id="a", **cfg)).start()
    b = FleetDoor(FleetConfig(host_id="b", **cfg)).start()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if (set(a.membership.poll().live) == {"a", "b"}
                and set(b.membership.poll().live) == {"a", "b"}):
            return a, b
        time.sleep(0.05)
    raise AssertionError("fleet never converged to {a, b}")


@pytest.fixture(scope="module")
def fleet2(tmp_path_factory):
    """One 2-host × 2-worker fleet shared by the non-destructive tests.
    Tracing is on so the cross-host trace tests have spans to merge."""
    tracer = get_tracer()
    tracer.enable()
    tmp = str(tmp_path_factory.mktemp("fleet"))
    a, b = _boot_pair(tmp)
    yield a, b
    a.shutdown()
    b.shutdown()
    tracer.disable()


def _pid_for(base, key, seed):
    body = json.dumps(
        {"instances": [[float(seed), 1.0, 2.0, 3.0]]}).encode()
    s, h, d = _post(base, PID, body,
                    headers={"X-Zoo-Route-Key": key})
    assert s == 200, (s, d)
    return h["X-Zoo-Host"], h.get("X-Zoo-Worker"), \
        json.loads(d)["predictions"][0][0]


def test_fleet_health_and_membership_endpoint(fleet2):
    a, b = fleet2
    s, _h, d = _get(a.url, "/healthz")
    body = json.loads(d)
    assert s == 200 and body["status"] == "ok"
    assert body["host_id"] == "a" and body["self_ok"]
    assert body["live_hosts"] == ["a", "b"]
    assert body["epoch"] >= 1
    s, _h, d = _get(b.url, "/v1/fleet/membership")
    m = json.loads(d)
    assert set(m["live"]) == {"a", "b"}
    assert m["hosts"]["a"]["url"] == a.url


def test_keyless_predicts_serve_locally(fleet2):
    a, b = fleet2
    for door in (a, b):
        s, h, d = _post(door.url, LIN, BODY)
        assert s == 200
        assert h["X-Zoo-Host"] == door.host_id
        assert "X-Zoo-Worker" in h


def test_sticky_keys_land_on_one_worker_fleet_wide(fleet2):
    a, b = fleet2
    hosts_seen = set()
    for i in range(24):
        key = f"sticky-{i}"
        ha, _wa, pa = _pid_for(a.url, key, i * 2)
        hb, _wb, pb = _pid_for(b.url, key, i * 2 + 1)
        assert ha == hb, f"{key}: {ha} via a, {hb} via b"
        assert pa == pb, f"{key}: different worker pids"
        hosts_seen.add(ha)
    assert hosts_seen == {"a", "b"}      # both intervals actually used


def test_cooperative_cache_hit_on_peer_is_bitwise(fleet2):
    a, b = fleet2
    warm = json.dumps({"instances": [[9.0, 8.0, 7.0, 6.0]]}).encode()
    key_a = _key_owned_by("a", prefix="coop-a")
    key_b = _key_owned_by("b", prefix="coop-b")
    # warm the content on host a only
    s, h, d_warm = _post(a.url, LIN, warm,
                         headers={"X-Zoo-Route-Key": key_a})
    assert h["X-Zoo-Host"] == "a"
    # host b never computed it: its leader miss peer-fetches from a
    s, h, d_hit = _post(b.url, LIN, warm,
                        headers={"X-Zoo-Route-Key": key_b})
    assert h["X-Zoo-Host"] == "b"
    assert h.get("X-Zoo-Cache") == "hit"
    assert d_hit == d_warm                       # bitwise, not approx
    # pinned against ground truth: an explicit bypass recomputes on b
    s, h, d_fresh = _post(b.url, LIN, warm,
                          headers={"X-Zoo-Route-Key": key_b,
                                   "Cache-Control": "no-cache"})
    assert h.get("X-Zoo-Cache") == "bypass"
    assert d_fresh == d_hit
    # the peer fetch is visible in the merged metrics
    _s, _h, m = _get(a.url, "/metrics")
    assert _sample_sum(
        m.decode(), "zoo_serving_result_cache_peer_hits_total",
        host="b") >= 1


def test_admin_quota_replicates_and_entry_door_charges_once(fleet2):
    a, b = fleet2
    # rate is tiny so refill cannot sneak a 4th token in mid-test —
    # the burst of 3 is the binding limit
    s, _h, resp = _admin(a.url, {"action": "quota", "tenant": "t-rep",
                                 "rate": 0.01, "burst": 3.0})
    r = json.loads(resp)
    assert s == 200 and set(r["hosts"]) == {"a", "b"}
    assert r["hosts"]["b"]["status"] == 200
    assert b.quota.describe()["tenants"]["t-rep"]["burst"] == 3.0
    # burn the burst through door a with a key owned by host b: the
    # ENTRY door charges, the forwarded hop must not double-charge —
    # 3 tokens buy exactly 3 requests
    key_b = _key_owned_by("b", prefix="q")
    ok = 0
    for i in range(4):
        body = json.dumps(
            {"instances": [[1000.0 + i, 1.0, 2.0, 3.0]]}).encode()
        try:
            s, h, _d = _post(a.url, PID, body,
                             headers={"X-Zoo-Route-Key": key_b,
                                      "X-Zoo-Tenant": "t-rep"})
            assert h["X-Zoo-Host"] == "b"       # forwarded, one charge
            ok += 1
        except urllib.error.HTTPError as e:
            assert e.code == 429
            assert e.headers.get("Retry-After") is not None
    assert ok == 3
    _admin(a.url, {"action": "quota", "tenant": "t-rep"})  # remove


def test_quota_adoption_on_join(fleet2, tmp_path):
    a, b = fleet2
    _admin(a.url, {"action": "quota", "tenant": "t-adopt",
                   "rate": 7.0, "burst": 2.0})
    c = FleetDoor(FleetConfig(
        spec=SPEC, fleet_dir=a.config.fleet_dir, host_id="c",
        workers=1, heartbeat_interval_s=0.1,
        worker_boot_timeout_s=90)).start()
    try:
        assert c.quota.describe()["tenants"]["t-adopt"]["rate"] == 7.0
    finally:
        c.shutdown()
        _admin(a.url, {"action": "quota", "tenant": "t-adopt"})
    # the clean leave must restore the 2-host roster before the other
    # tests route by it
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        if (set(a.membership.poll().roster) == {"a", "b"}
                and set(b.membership.poll().roster) == {"a", "b"}):
            return
        time.sleep(0.05)
    raise AssertionError("host c never left the roster")


def test_fleet_metrics_merge_host_labels(fleet2):
    a, b = fleet2
    _post(a.url, LIN, BODY)
    _post(b.url, LIN, BODY)
    s, h, m = _get(a.url, "/metrics")
    text = m.decode()
    assert "text/plain" in h["Content-Type"]
    assert 'host="a"' in text and 'host="b"' in text
    # HELP/TYPE exactly once fleet-wide, per family
    for fam in ("zoo_serving_requests_total",
                "zoo_frontdoor_requests_total",
                "zoo_fleet_hosts_alive"):
        assert text.count(f"# TYPE {fam}") == 1, fam
    # the door's own families carry the host label after the merge
    assert _sample_sum(text, "zoo_fleet_hosts_alive", host="a") == 2
    assert _sample_sum(text, "zoo_fleet_epoch", host="b") >= 1
    # per-worker samples kept their worker label next to host=
    assert _sample_sum(text, "zoo_serving_requests_total",
                       host="a") >= 1
    assert 'worker="' in text


def test_fleet_trace_merge_crosses_the_host_hop(fleet2):
    a, b = fleet2
    key_b = _key_owned_by("b", prefix="trace")
    body = json.dumps({"instances": [[4.0, 4.0, 4.0, 4.0]]}).encode()
    s, h, _d = _post(a.url, PID, body,
                     headers={"X-Zoo-Route-Key": key_b,
                              "Cache-Control": "no-cache"})
    assert h["X-Zoo-Host"] == "b"
    tid = h["X-Zoo-Trace-Id"]
    s, _h, d = _get(a.url, f"/v1/debug/traces/{tid}")
    doc = json.loads(d)
    spans = doc["spans"]
    assert spans, "no spans collected for a forwarded request"
    assert all("host" in sp for sp in spans)
    # the request executed on host b's workers — their spans must be
    # in the ENTRY door's merged timeline
    assert any(sp["host"] == "b" and sp.get("worker") not in
               (None, "frontdoor") for sp in spans), spans
    # anchors are namespaced host/process
    assert any(k.startswith("b/") for k in doc["anchors"])
    # the index view lists the trace as spanning host b
    s, _h, d = _get(a.url, "/v1/debug/traces")
    idx = json.loads(d)["traces"]
    assert "b" in idx[tid]["hosts"]
    # chrome export rows are host/worker processes
    s, _h, d = _get(a.url, f"/v1/debug/traces/{tid}?format=chrome")
    events = json.loads(d)["traceEvents"]
    assert events and all("/" in str(e["pid"]) for e in events)


def test_stale_epoch_admin_is_rejected(fleet2):
    a, b = fleet2
    payload = json.dumps({"action": "quota", "tenant": "t-epoch",
                          "rate": 1.0}).encode()
    req = urllib.request.Request(
        b.url + "/v1/fleet/admin", data=payload,
        headers={"Content-Type": "application/json",
                 "X-Zoo-Fleet-Epoch": "0"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=10)
    assert ei.value.code == 409
    assert "stale" in json.loads(ei.value.read())["error"]
    # a current epoch is accepted (and applies locally only)
    req = urllib.request.Request(
        b.url + "/v1/fleet/admin", data=payload,
        headers={"Content-Type": "application/json",
                 "X-Zoo-Fleet-Epoch": str(b.membership.epoch)})
    with urllib.request.urlopen(req, timeout=10) as resp:
        assert resp.status == 200
    assert "t-epoch" in b.quota.describe()["tenants"]
    assert "t-epoch" not in a.quota.describe()["tenants"]
    b.quota.set_quota("t-epoch", None)   # restore fixture state


def test_rollback_invalidation_fans_out_to_peer_caches(fleet2):
    a, b = fleet2
    # route all 'ver' traffic to v2 fleet-wide (routed requests are the
    # cacheable ones — explicit versions bypass by design)
    s, _h, _r = _admin(a.url, {"action": "weights", "model": "ver",
                               "weights": {"2": 1.0}})
    assert s == 200
    vbody = json.dumps({"instances": [[6.0, 6.0, 6.0, 6.0]]}).encode()
    s, h, d_a = _post(a.url, VER, vbody)
    assert h["X-Zoo-Host"] == "a"
    assert json.loads(d_a)["predictions"][0][0] == 2.0
    # host b acquires the entry ONLY by peer fetch — its workers never
    # execute v2 for this payload
    s, h, d_b = _post(b.url, VER, vbody)
    assert h["X-Zoo-Host"] == "b"
    assert h.get("X-Zoo-Cache") == "hit"
    assert d_b == d_a
    # retire v2: start a rollout and roll it back — the unregister
    # funnel must invalidate the peer-fetched entry on b too
    _admin(a.url, {"action": "clear_policy", "model": "ver"})
    s, _h, _r = _admin(a.url, {"action": "start", "model": "ver",
                               "canary": "2", "incumbent": "1"})
    assert s == 200
    s, _h, _r = _admin(a.url, {"action": "rollback", "model": "ver"})
    assert s == 200
    # v2 is gone on every host
    for base in (a.url, b.url):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, "/v1/models/ver/versions/2:predict", vbody)
        assert ei.value.code == 404
    # ... including from host b's cache, which never served it fresh
    _s, _h, m = _get(a.url, "/metrics")
    assert _sample_sum(
        m.decode(), "zoo_serving_result_cache_invalidations_total",
        host="b") >= 1
    # routed traffic falls back to the incumbent
    s, h, d = _post(b.url, VER, vbody)
    assert json.loads(d)["predictions"][0][0] == 1.0


def test_chaos_forward_drop_fails_over_locally(fleet2):
    a, b = fleet2
    key_b = _key_owned_by("b", prefix="chaos")
    chaos.arm_serving("fleet_forward_drop", times=1, tag="b")
    try:
        host, _w, _p = _pid_for(a.url, key_b, 777)
        # the forward was dropped mid-flight: door a absorbed it
        assert host == "a"
        assert chaos.serving_hits("fleet_forward_drop") == 1
    finally:
        chaos.disarm_serving()
    # b was suspected but keeps beating — the suspicion clears and the
    # key returns to its interval owner
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        if a.membership.poll().is_live("b"):
            break
        time.sleep(0.05)
    host, _w, _p = _pid_for(a.url, key_b, 778)
    assert host == "b"
    _s, _h, m = _get(a.url, "/metrics")
    assert _sample_sum(m.decode(), "zoo_fleet_failovers_total",
                       host="a") >= 1


def test_scale_to_and_autoscaler_tick(fleet2):
    a, _b = fleet2
    fd = a.frontdoor
    r = fd.scale_to(3)
    assert r["added"] == ["2"] and r["workers"] == 3
    depths = fd.queue_depths()
    assert set(depths) == {"0", "1", "2"}
    assert all(v == 0.0 for v in depths.values())
    # an idle fleet scales back down through the real tick path
    sc = Autoscaler(fd, AutoscalerConfig(
        min_workers=2, max_workers=3, scale_down_ticks=1,
        cooldown_ticks=0))
    assert sc.tick() == 2
    assert sc.events == {"up": 0, "down": 1}
    assert set(fd.queue_depths()) == {"0", "1"}     # fixture restored


def test_shared_port_multi_accept(tmp_path):
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    shared = s.getsockname()[1]
    s.close()
    door = FleetDoor(FleetConfig(
        spec=SPEC, fleet_dir=str(tmp_path), host_id="a", workers=2,
        heartbeat_interval_s=0.1, worker_boot_timeout_s=90,
        shared_port=shared)).start()
    try:
        base = f"http://127.0.0.1:{shared}"
        pids = set()
        for i in range(16):
            body = json.dumps(
                {"instances": [[float(i), 0.0, 0.0, 0.0]]}).encode()
            status, h, d = _post(base, PID, body)
            assert status == 200
            # no proxy hop: the worker answered directly
            assert "X-Zoo-Worker" not in h and "X-Zoo-Host" not in h
            pids.add(json.loads(d)["predictions"][0][0])
        # the kernel spread accepted connections over the workers
        # (each request is a fresh connection)
        assert len(pids) >= 1
        # the proxied path still works side by side
        status, h, _d = _post(door.url, PID, BODY)
        assert status == 200 and "X-Zoo-Worker" in h
    finally:
        door.shutdown()


# -- destructive: whole-host death, last on the shared fleet ----------------


def test_whole_host_kill_remaps_keys_with_zero_errors(fleet2):
    a, b = fleet2
    # seeds no earlier case sent: the shared fleet's caches hold those
    key_b = _key_owned_by("b", prefix="kill")
    host0, _w, pid_b = _pid_for(a.url, key_b, 90_001)
    assert host0 == "b"
    keys_a = [k for k in (f"stay-{i}" for i in range(16))
              if fleet_pick(["a", "b"], ["a", "b"], "a", k) == "a"]
    assert keys_a
    owners = {}
    for j, k in enumerate(keys_a):
        host, _w, pid = _pid_for(a.url, k, 92_000 + j)
        assert host == "a"
        owners[k] = pid
    b.simulate_host_kill()
    # every request through the survivor must succeed — transport
    # failover first, then the membership remap
    absorbed = None
    deadline = time.monotonic() + 10
    i = 90_002
    while time.monotonic() < deadline:
        host, _w, pid = _pid_for(a.url, key_b, i)   # raises on any
        i += 1                                      # client error
        if host == "a":
            absorbed = pid
            break
        time.sleep(0.02)
    assert absorbed is not None, "survivor never absorbed the key"
    assert absorbed != pid_b                # a DIFFERENT process
    # transport failover can answer before the membership protocol marks
    # b stale (heartbeat x stale_after): wait for the remap, bounded
    deadline = time.monotonic() + 10
    v = a.membership.poll()
    while "b" in v.live and time.monotonic() < deadline:
        time.sleep(0.05)
        v = a.membership.poll()
    assert set(v.live) == {"a"}
    assert "b" in v.roster                  # died, didn't leave
    # sticky: the absorbed key stays on one surviving worker
    pids = {_pid_for(a.url, key_b, 91_000 + j)[2] for j in range(6)}
    assert len(pids) == 1
    # only the dead host's keys moved: a's keys stay on their workers
    for j, k in enumerate(keys_a):
        host, _w, pid = _pid_for(a.url, k, 93_000 + j)
        assert (host, pid) == ("a", owners[k]), k
