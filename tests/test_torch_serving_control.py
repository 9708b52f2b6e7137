"""The deployment control plane and the result cache — router, quota,
rollout, shadows and the content-addressed cache — held alike in the JAX
package and the port's copies: every case runs once per package, on host
models (numpy), with fake clocks where time matters.

No case sleeps on a guess: a request's outcome is read after a done
callback registered behind the engine's own has run."""

import importlib
import io
import threading
import time
import types

import numpy as np
import pytest

JOIN_S = 30


@pytest.fixture(params=["analytics_zoo_tpu", "analytics_zoo_tpu_torch"],
                ids=["jax", "port"])
def P(request):
    mod = lambda name: importlib.import_module(  # noqa: E731
        f"{request.param}.{name}")
    ns = types.SimpleNamespace(
        serving=mod("serving"), chaos=mod("ft.chaos"),
        quota=mod("serving.quota"), router=mod("serving.router"))
    yield ns
    ns.chaos.reset()


class Doubler:
    def do_predict(self, x):
        return np.asarray(x, np.float32) * 2.0


class Tripler:
    def do_predict(self, x):
        return np.asarray(x, np.float32) * 3.0


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


X = np.ones((1, 3), np.float32)


def _cfg(P):
    return P.serving.BatcherConfig(max_batch_size=8, max_wait_ms=1.0)


def _settled(engine, n, **kw):
    """``n`` predicts, each returned only after the engine's own outcome
    callbacks (health windows, metrics) have run."""
    outs = []
    for _ in range(n):
        fut = engine.predict_async("m", X, **kw)
        done = threading.Event()
        fut.add_done_callback(lambda _f: done.set())
        assert done.wait(timeout=JOIN_S)
        outs.append(fut.result())
    return outs


def _wait_until(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.005)
    return cond()


# -- router ------------------------------------------------------------------


def test_policy_pick_is_deterministic_and_proportional(P):
    TP = P.router.TrafficPolicy
    counts = {"1": 0, "2": 0}
    p = TP({"1": 3.0, "2": 1.0})
    for _ in range(1000):
        counts[p.pick()] += 1
    assert abs(counts["2"] - 250) <= 5, counts
    a, b = TP({"1": 3.0, "2": 1.0}), TP({"1": 3.0, "2": 1.0})
    assert [a.pick() for _ in range(50)] == [b.pick() for _ in range(50)]


def test_policy_zero_weight_and_invalid_weights(P):
    TP = P.router.TrafficPolicy
    p = TP({"1": 1.0, "2": 0.0})
    assert all(p.pick() == "1" for _ in range(100))
    assert p.describe() == {"1": 1.0, "2": 0.0}
    for bad in ({"1": 0.0}, {"1": -1.0}, {}):
        with pytest.raises(ValueError):
            TP(bad)


def test_sticky_keys_stable_and_migrate_only_toward_the_canary(P):
    TP = P.router.TrafficPolicy
    p = TP({"1": 0.5, "2": 0.5})
    assert len({p.pick("alice") for _ in range(20)}) == 1
    a, b = TP({"1": 0.5, "2": 0.5}), TP({"1": 0.5, "2": 0.5})
    for _ in range(10):
        b.pick("some-key")
    assert [a.pick() for _ in range(20)] == [b.pick() for _ in range(20)]
    small, big = TP({"1": 0.9, "2": 0.1}), TP({"1": 0.5, "2": 0.5})
    canary = [k for k in (f"tenant-{i}" for i in range(300))
              if small.pick(k) == "2"]
    assert canary and all(big.pick(k) == "2" for k in canary)


def test_router_no_policy_routes_none_and_protected_versions(P):
    r = P.router.Router()
    assert r.route("m") is None
    r.set_policy("m", {"1": 0.5, "2": 0.5})
    assert r.route("m") in ("1", "2")
    r.set_shadow("m", "3", 0.5)
    assert r.protected_versions("m") == ["1", "2", "3"]
    assert r.describe("m")["shadows"] == {"3": 0.5}
    r.clear_policy("m")
    assert r.route("m") is None
    r.clear_model("m")
    assert r.protected_versions("m") == []


# -- quota -------------------------------------------------------------------


def test_token_bucket_refill_with_fake_clock(P):
    clk = _FakeClock()
    b = P.quota.TokenBucket(P.quota.TenantQuota(rate=2.0, burst=2.0),
                            clock=clk)
    assert b.take() is None and b.take() is None
    assert b.take() == pytest.approx(0.5)
    clk.advance(0.5)
    assert b.take() is None
    assert b.take() == pytest.approx(0.5)
    clk.advance(100.0)
    assert b.tokens() == pytest.approx(2.0)


def test_quota_manager_folding_and_default_bucket(P):
    Q = P.quota
    clk = _FakeClock()
    qm = Q.QuotaManager(Q.QuotaConfig(
        tenants={"paid": Q.TenantQuota(rate=1.0, burst=1.0)},
        default=Q.TenantQuota(rate=1.0, burst=2.0),
        metric_tenants=("watched",)), clock=clk)
    assert qm.check(None) == Q.DEFAULT_TENANT
    assert qm.check("paid") == "paid"
    with pytest.raises(Q.QuotaExceededError) as e:
        qm.check("paid")
    assert e.value.tenant == "paid"
    assert e.value.retry_after_s == pytest.approx(1.0)
    assert qm.check("joe") == "joe" and qm.check("joe") == "joe"
    with pytest.raises(Q.QuotaExceededError):
        qm.check("joe")
    assert qm.label_for("joe") == Q.OTHER_TENANT_LABEL
    assert qm.label_for("paid") == "paid"
    assert qm.label_for("watched") == "watched"
    qm.set_quota("paid", None)
    assert qm.check("paid") == "paid" and qm.check("paid") == "paid"
    with pytest.raises(Q.QuotaExceededError):
        qm.check("paid")
    desc = qm.describe()
    assert desc["default"] == {"rate": 1.0, "burst": 2.0}
    assert "paid" not in desc["tenants"]
    unlimited = Q.QuotaManager()
    assert all(unlimited.check("anyone") == "anyone" for _ in range(100))


def test_engine_quota_429_path_and_tenant_metrics(P):
    S, Q = P.serving, P.quota
    clk = _FakeClock()
    engine = S.ServingEngine()
    engine.quota = Q.QuotaManager(Q.QuotaConfig(
        tenants={"paid": Q.TenantQuota(rate=1.0, burst=1.0)}), clock=clk)
    try:
        engine.register("m", Doubler(), example_input=X, config=_cfg(P))
        np.testing.assert_array_equal(
            engine.predict("m", X, tenant="paid"), X * 2.0)
        with pytest.raises(Q.QuotaExceededError) as e:
            engine.predict("m", X, tenant="paid")
        assert e.value.retry_after_s > 0
        engine.predict("m", X, tenant="randomjoe")
        assert engine.metrics.quota_rejections("paid").value == 1
        assert engine.metrics.tenant_requests("paid").value == 1
        text = engine.metrics_text()
        assert 'zoo_serving_quota_rejections_total{tenant="paid"} 1' in text
        assert "randomjoe" not in text
    finally:
        engine.shutdown()


# -- engine routing and shadows ------------------------------------------------


def test_engine_routes_by_policy_and_explicit_version_bypasses(P):
    engine = P.serving.ServingEngine()
    try:
        engine.register("m", Doubler(), example_input=X, config=_cfg(P),
                        version="1")
        engine.register("m", Tripler(), example_input=X, config=_cfg(P),
                        version="2")
        assert engine.describe_model("m")["latest"] == "2"
        engine.admin_action({"action": "weights", "model": "m",
                             "weights": {"1": 1.0, "2": 0.0}})
        for y in _settled(engine, 5):
            np.testing.assert_array_equal(y, X * 2.0)
        for y in _settled(engine, 1, version="2"):
            np.testing.assert_array_equal(y, X * 3.0)
        engine.admin_action({"action": "clear_policy", "model": "m"})
        for y in _settled(engine, 1):
            np.testing.assert_array_equal(y, X * 3.0)
        mm = engine.metrics.for_model("m")
        assert mm.version_requests("1").value == 5
        assert mm.version_requests("2").value == 2
        engine.admin_action({"action": "weights", "model": "m",
                             "weights": {"1": 0.5, "2": 0.5}})
        first = engine.predict("m", X, route_key="alice")
        for _ in range(10):
            np.testing.assert_array_equal(
                engine.predict("m", X, route_key="alice"), first)
    finally:
        engine.shutdown()


def test_shadow_mirrors_exact_fraction_and_client_sees_primary(P):
    engine = P.serving.ServingEngine()
    try:
        engine.register("m", Doubler(), example_input=X, config=_cfg(P),
                        version="1")
        engine.register("m", Tripler(), example_input=X, config=_cfg(P),
                        version="2", shadow=True, shadow_fraction=0.25)
        assert engine.describe_model("m")["latest"] == "1"
        for y in _settled(engine, 16):
            np.testing.assert_array_equal(y, X * 2.0)
        mm = engine.metrics.for_model("m")
        assert _wait_until(lambda: mm.shadow_requests("2").value == 4)
        assert mm.shadow_failures("2").value == 0
        assert engine.describe_model("m")["shadows"] == {"2": 0.25}
    finally:
        engine.shutdown()


def test_shadow_failures_never_surface_to_the_client(P):
    class Exploder:
        def do_predict(self, x):
            raise RuntimeError("shadow-only blast")

    engine = P.serving.ServingEngine()
    try:
        engine.register("m", Doubler(), example_input=X, config=_cfg(P),
                        version="1")
        engine.register("m", Exploder(), example_input=X, config=_cfg(P),
                        version="2", shadow=True, shadow_fraction=1.0)
        for y in _settled(engine, 6):
            np.testing.assert_array_equal(y, X * 2.0)
        mm = engine.metrics.for_model("m")
        assert _wait_until(lambda: mm.shadow_failures("2").value
                           + mm.shadow_dropped("2").value >= 6)
    finally:
        engine.shutdown()


# -- rollouts ------------------------------------------------------------------


def _rollout_engine(P, ladder=(0.25, 1.0), min_requests=4):
    return P.serving.ServingEngine(rollout=P.serving.RolloutConfig(
        ladder=ladder, min_requests=min_requests, auto_evaluate=False))


def test_healthy_canary_auto_promotes_through_full_ladder(P):
    engine = _rollout_engine(P)
    try:
        engine.register("m", Doubler(), example_input=X, config=_cfg(P),
                        version="1")
        engine.register("m", Tripler(), example_input=X, config=_cfg(P),
                        version="2")
        ctrl = engine.rollout_controller()
        state = ctrl.active("m")
        assert state is not None and state.stage == 0
        assert engine.describe_model("m")["latest"] == "1"
        assert engine.describe_model("m")["policy"] == {"1": 0.75,
                                                        "2": 0.25}
        for _ in range(20):
            if ctrl.active("m") is None:
                break
            _settled(engine, 8)
            ctrl.tick()
        assert state.done and state.outcome == "promoted"
        desc = engine.describe_model("m")
        assert desc["latest"] == "2" and list(desc["versions"]) == ["2"]
        assert desc["policy"] is None
        assert engine.metrics.promotions("m").value == 1
        np.testing.assert_array_equal(engine.predict("m", X), X * 3.0)
    finally:
        engine.shutdown()


def test_canary_errors_roll_back_and_incumbent_keeps_serving(P):
    """A canary that chaos makes fail rolls back; the incumbent serves
    everything afterwards."""
    engine = _rollout_engine(P, min_requests=8)
    try:
        engine.register("m", Doubler(), example_input=X, config=_cfg(P),
                        version="1")
        _settled(engine, 8)
        engine.register("m", Tripler(), example_input=X, config=_cfg(P),
                        version="2")
        P.chaos.arm_serving("canary_errors", tag="m@2")
        errors = 0
        for _ in range(40):
            try:
                fut = engine.predict_async("m", X)
            except P.serving.CircuitOpenError:  # the canary's open breaker
                errors += 1
                continue
            done = threading.Event()
            fut.add_done_callback(lambda _f: done.set())
            assert done.wait(timeout=JOIN_S)
            if fut.exception() is not None:
                errors += 1
        assert 0 < errors <= 14, errors
        engine.rollout_controller().tick()
        state = engine.rollout_controller().describe("m")
        assert state["done"] and state["outcome"] == "rolled_back"
        assert state["reason"] in ("breaker_open", "error_rate")
        desc = engine.describe_model("m")
        assert desc["latest"] == "1" and list(desc["versions"]) == ["1"]
        for y in _settled(engine, 8):
            np.testing.assert_array_equal(y, X * 2.0)
    finally:
        engine.shutdown()


def test_error_rate_gate_and_breaker_open_rollback(P):
    engine = _rollout_engine(P, min_requests=5)
    try:
        engine.register("m", Doubler(), example_input=X, config=_cfg(P),
                        version="1")
        engine.register("m", Tripler(), example_input=X, config=_cfg(P),
                        version="2")
        ctrl = engine.rollout_controller()
        for _ in range(10):
            engine.version_health("m", "1").record(True, 0.01)
        h2 = engine.version_health("m", "2")
        for _ in range(3):
            h2.record(True, 0.01)
        ctrl.tick()  # under min_requests: hold
        assert ctrl.active("m") is not None and ctrl.active("m").stage == 0
        h2.record(False, 0.01)
        h2.record(False, 0.01)
        ctrl.tick()
        state = ctrl.describe("m")
        assert state["done"] and state["reason"] == "error_rate"
        assert engine.metrics.rollout_stage("m").value == -1
        engine.register("m", Tripler(), example_input=X, config=_cfg(P),
                        version="3")
        breaker = engine.entry("m", "3").breaker
        for _ in range(8):
            breaker.record(False)
        ctrl.tick()
        state = ctrl.describe("m")
        assert state["done"] and state["reason"] == "breaker_open"
    finally:
        engine.shutdown()


def test_new_register_supersedes_active_rollout(P):
    engine = _rollout_engine(P, min_requests=1000)
    try:
        for v, model in (("1", Doubler()), ("2", Tripler()),
                         ("3", Tripler())):
            engine.register("m", model, example_input=X, config=_cfg(P),
                            version=v)
        state = engine.rollout_controller().active("m")
        assert state.canary == "3" and state.incumbent == "1"
        assert engine.metrics.rollbacks("m", "superseded").value == 1
        desc = engine.describe_model("m")
        assert list(desc["versions"]) == ["1", "3"]
        assert desc["latest"] == "1"
    finally:
        engine.shutdown()


def test_admin_start_promote_rollback_and_reason_folding(P):
    engine = P.serving.ServingEngine()
    try:
        engine.register("m", Doubler(), example_input=X, config=_cfg(P),
                        version="1")
        engine.register("m", Tripler(), example_input=X, config=_cfg(P),
                        version="2")
        with pytest.raises(ValueError):
            engine.admin_action({"action": "start", "model": "m"})
        desc = engine.admin_action({"action": "start", "model": "m",
                                    "canary": "2", "incumbent": "1"})
        assert desc["rollout"]["stage"] == 0
        for _ in range(4):
            desc = engine.admin_action({"action": "promote", "model": "m"})
        assert desc["rollout"]["outcome"] == "promoted"
        assert list(desc["versions"]) == ["2"]
        engine.register("m", Doubler(), example_input=X, config=_cfg(P),
                        version="3")
        engine.admin_action({"action": "start", "model": "m",
                             "canary": "3", "incumbent": "2"})
        desc = engine.admin_action({"action": "rollback", "model": "m",
                                    "reason": "vibes"})
        assert desc["rollout"]["reason"] == "manual"
        with pytest.raises(P.serving.ModelNotFoundError):
            engine.admin_action({"action": "promote", "model": "m"})
        with pytest.raises(ValueError):
            engine.admin_action({"action": "frobnicate", "model": "m"})
    finally:
        engine.shutdown()


# -- result cache ----------------------------------------------------------------


def _put(cache, key, arr, model="m", version="1"):
    leader, _ = cache.begin_flight(key)
    assert leader
    cache.complete_flight(key, model, version, arr)


def test_cache_config_and_key(P):
    S = P.serving
    for bad in (dict(max_entries=0), dict(max_bytes=0), dict(ttl_s=0.0)):
        with pytest.raises(ValueError):
            S.ResultCacheConfig(**bad)
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    k = S.ResultCache.key("m", "1", [a])
    assert k == S.ResultCache.key("m", "1", [a.copy()])
    for other in (("other", "1", [a]), ("m", "2", [a]),
                  ("m", "1", [a.astype(np.float64)]),
                  ("m", "1", [a.reshape(3, 2)]), ("m", "1", [a + 1])):
        assert k != S.ResultCache.key(*other)
    assert S.ResultCache.key("m", "1", [a.T]) == S.ResultCache.key(
        "m", "1", [np.ascontiguousarray(a.T)])


def test_cache_lru_ttl_and_byte_budget(P):
    S = P.serving
    cache = S.ResultCache(S.ResultCacheConfig(max_entries=2, ttl_s=None))
    _put(cache, "k1", np.ones(4, np.float32))
    _put(cache, "k2", np.ones(4, np.float32) * 2)
    assert cache.get("k1") is not None
    _put(cache, "k3", np.ones(4, np.float32) * 3)
    assert cache.get("k2") is None and cache.get("k1") is not None
    clk = _FakeClock()
    cache = S.ResultCache(S.ResultCacheConfig(ttl_s=10.0), clock=clk)
    _put(cache, "k", np.ones(4, np.float32))
    clk.advance(9.9)
    assert cache.get("k") is not None
    clk.advance(0.2)
    assert cache.get("k") is None
    cache = S.ResultCache(S.ResultCacheConfig(max_bytes=64, ttl_s=None))
    _put(cache, "big", np.ones(32, np.float32))
    assert cache.get("big") is None
    _put(cache, "a", np.ones(10, np.float32))
    _put(cache, "b", np.ones(10, np.float32))
    s = cache.stats()
    assert s["entries"] == 1 and s["bytes"] == 40 and s["evictions"] == 1


def test_cache_single_flight_and_errors_never_cached(P):
    S = P.serving
    cache = S.ResultCache(S.ResultCacheConfig())
    assert cache.begin_flight("k") == (True, None)
    lead2, waiter = cache.begin_flight("k")
    assert not lead2
    cache.complete_flight("k", "m", "1", np.ones(4, np.float32) * 7)
    got = waiter.result(timeout=JOIN_S)
    assert isinstance(got, S.CowView)
    assert np.shares_memory(got, cache.get("k"))
    cache.begin_flight("j")
    _, waiter = cache.begin_flight("j")
    cache.fail_flight("j", RuntimeError("device on fire"))
    with pytest.raises(RuntimeError, match="device on fire"):
        waiter.result(timeout=JOIN_S)
    assert cache.get("j") is None and cache.begin_flight("j")[0]
    off = S.ResultCache(S.ResultCacheConfig(coalesce=False))
    assert off.begin_flight("k") == (True, None) == off.begin_flight("k")


def test_cache_invalidation_and_copy_on_write(P):
    S = P.serving
    cache = S.ResultCache(S.ResultCacheConfig(ttl_s=None))
    _put(cache, "k1", np.ones(4, np.float32), version="1")
    _put(cache, "k2", np.ones(4, np.float32), version="2")
    assert cache.invalidate_version("m", "2") == 1
    assert cache.stats()["invalidations"] == 1
    _put(cache, "k", np.arange(4, dtype=np.float32))
    v = cache.get("k")
    with pytest.raises(ValueError, match=r"arr\.copy\(\)"):
        v[0] = 99.0
    v += 1
    assert not np.shares_memory(v, cache.get("k")) and v.flags.writeable
    np.testing.assert_array_equal(cache.get("k"),
                                  np.arange(4, dtype=np.float32))
    view = cache.get("k")
    a, b = io.BytesIO(), io.BytesIO()
    np.save(a, view, allow_pickle=False)
    np.save(b, np.asarray(view).copy(), allow_pickle=False)
    assert a.getvalue() == b.getvalue()
    assert cache.invalidate_model("m") == 2


class _GatedModel:
    def __init__(self):
        self.gate, self.entered = threading.Event(), threading.Event()
        self.armed, self.calls = False, 0

    def do_predict(self, x):
        self.calls += 1
        if self.armed:
            self.entered.set()
            assert self.gate.wait(timeout=JOIN_S)
        return np.asarray(x, np.float32) * 2.0


def test_engine_cache_dispositions_coalescing_and_quota(P):
    S, Q = P.serving, P.quota
    model = _GatedModel()
    engine = S.ServingEngine(result_cache=S.ResultCacheConfig())
    engine.quota = Q.QuotaManager(Q.QuotaConfig(
        tenants={"paid": Q.TenantQuota(rate=1.0, burst=2.0)}),
        clock=_FakeClock())
    try:
        engine.register("m", model, example_input=X, config=_cfg(P))
        warm = model.calls
        f1 = engine.predict_async("m", X)
        r1 = f1.result(timeout=JOIN_S)
        f2 = engine.predict_async("m", X)
        r2 = f2.result(timeout=JOIN_S)
        assert (f1.cache_status, f2.cache_status) == ("miss", "hit")
        assert isinstance(r2, S.CowView) and model.calls == warm + 1
        np.testing.assert_array_equal(np.asarray(r1), np.asarray(r2))
        for kw in (dict(version="1"), dict(bypass_cache=True)):
            f = engine.predict_async("m", X, **kw)
            f.result(timeout=JOIN_S)
            assert f.cache_status == "bypass"
        model.armed = True
        f3 = engine.predict_async("m", X * 5)
        assert model.entered.wait(timeout=JOIN_S)
        f4 = engine.predict_async("m", X * 5)
        assert (f3.cache_status, f4.cache_status) == ("miss", "coalesced")
        model.gate.set()
        for f in (f3, f4):
            np.testing.assert_array_equal(np.asarray(f.result(JOIN_S)),
                                          X * 10.0)
        assert engine.predict_async("m", X, tenant="paid").cache_status \
            == "hit"
        engine.predict("m", X, tenant="paid")
        with pytest.raises(Q.QuotaExceededError):
            engine.predict_async("m", X, tenant="paid")
        engine.unregister("m", "1")
        assert engine.result_cache.stats()["entries"] == 0
    finally:
        model.gate.set()
        engine.shutdown()
