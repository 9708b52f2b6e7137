"""Per-tenant token-bucket quotas — admission isolation for multi-tenant
serving.

Admission control protects the *engine* from aggregate overload;
it is tenant-blind, so one hot client can starve everyone else while the
EWMA still looks healthy. This module adds the per-tenant layer in front
of it: every request carries a tenant id (HTTP header ``X-Zoo-Tenant``;
unkeyed traffic folds into :data:`DEFAULT_TENANT`), and a classic token
bucket per tenant decides *before* admission control whether the request
may even join the queue-wait estimate. Over-quota requests fail with
:class:`QuotaExceededError` — a
:class:`~analytics_zoo_tpu_torch.serving.resilience.RetryableError`, so the
HTTP layer's existing mapping turns it into ``429`` with a
``Retry-After`` computed from the bucket's actual refill deficit.

Ordering matters: quota runs first because a tenant burning its budget
on requests that admission would shed anyway should still be charged
(the bucket debits on *attempt*), and because quota rejections must not
pollute the admission EWMA (a 429'd request never enters the batcher).

Metric cardinality is bounded by construction: only tenants named in the
config (quota'd tenants plus an explicit ``metric_tenants`` allowlist,
plus ``default``) get their own ``{tenant=...}`` label; every other id
folds into the single label ``other``. See docs/known-issues.md
("Serving metric cardinality is allowlist-bounded").

Buckets take an injectable monotonic clock so tests drive refill
deterministically — no sleeps, same pattern as the resilience layer's
fake-clock tests.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from .resilience import RetryableError

__all__ = ["DEFAULT_TENANT", "OTHER_TENANT_LABEL", "TenantQuota",
           "QuotaConfig", "QuotaExceededError", "TokenBucket",
           "QuotaManager"]

#: Tenant id assigned to requests with no ``X-Zoo-Tenant`` header.
DEFAULT_TENANT = "default"

#: Metric label absorbing every tenant outside the allowlist.
OTHER_TENANT_LABEL = "other"


class QuotaExceededError(RetryableError):
    """Tenant is over its token-bucket rate (HTTP 429 + Retry-After).

    ``retry_after_s`` is the time until the bucket refills one token —
    the earliest instant a retry can succeed, not a generic backoff."""

    def __init__(self, tenant: str, retry_after_s: float):
        super().__init__(
            f"tenant {tenant!r} is over quota; "
            f"retry in {retry_after_s:.3f}s",
            retry_after_s=retry_after_s)
        self.tenant = tenant


@dataclass(frozen=True)
class TenantQuota:
    """One tenant's rate limit: ``rate`` sustained requests/second with
    bursts up to ``burst`` (the bucket capacity)."""

    rate: float
    burst: float = 1.0

    def __post_init__(self):
        if self.rate <= 0:
            raise ValueError(f"rate must be > 0, got {self.rate}")
        if self.burst < 1:
            raise ValueError(f"burst must be >= 1, got {self.burst}")


@dataclass(frozen=True)
class QuotaConfig:
    """Engine-level quota policy.

    Args:
      tenants: per-tenant limits; tenants listed here are enforced AND
        get their own metric label.
      default: limit applied to every tenant not in ``tenants``
        (including :data:`DEFAULT_TENANT`). None = unlisted tenants are
        unlimited (quota only constrains the named ones).
      metric_tenants: extra tenant ids granted their own metric label
        without a quota — observability for tenants you track but don't
        throttle. Everything outside ``tenants`` ∪ ``metric_tenants`` ∪
        ``{default}`` shares the ``other`` label.
    """

    tenants: Dict[str, TenantQuota] = field(default_factory=dict)
    default: Optional[TenantQuota] = None
    metric_tenants: tuple = ()


class TokenBucket:
    """The standard token bucket, with an injectable monotonic clock.

    Starts full (``burst`` tokens); each :meth:`take` debits one token
    or reports the seconds until one is available. Refill is computed
    lazily on access — no timer thread."""

    def __init__(self, quota: TenantQuota,
                 clock: Callable[[], float]):
        self.quota = quota
        self._clock = clock
        self._tokens = float(quota.burst)
        self._last = clock()
        self._lock = threading.Lock()

    def take(self) -> Optional[float]:
        """Debit one token. Returns None on success, else the seconds
        until the next token lands (the Retry-After value)."""
        with self._lock:
            now = self._clock()
            elapsed = now - self._last
            if elapsed > 0:
                self._tokens = min(float(self.quota.burst),
                                   self._tokens + elapsed * self.quota.rate)
                self._last = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return None
            return (1.0 - self._tokens) / self.quota.rate

    def tokens(self) -> float:
        """Current token count (post-refill; introspection only)."""
        with self._lock:
            now = self._clock()
            elapsed = now - self._last
            return min(float(self.quota.burst),
                       self._tokens + max(0.0, elapsed) * self.quota.rate)

    def restore_tokens(self, tokens: float) -> None:
        """Overwrite the token count and re-anchor refill at *this*
        bucket's clock, now.

        The serialization counterpart of :meth:`tokens`: snapshots carry
        post-refill token *counts* only, never ``_last`` timestamps —
        monotonic clocks are process-local, so a restored timestamp from
        another process (or an earlier run) would grant a huge spurious
        refill or freeze the bucket. Counts are clamped into
        ``[0, burst]`` so a snapshot taken under a larger burst cannot
        overfill."""
        with self._lock:
            self._tokens = min(float(self.quota.burst),
                               max(0.0, float(tokens)))
            self._last = self._clock()


class QuotaManager:
    """All tenant buckets of one engine, plus the label-folding rule.

    With no config (``QuotaConfig()`` default, no per-tenant entries, no
    default limit) every :meth:`check` admits — the manager exists
    unconditionally so the engine's request path has no None branch."""

    def __init__(self, config: Optional[QuotaConfig] = None,
                 clock: Optional[Callable[[], float]] = None):
        import time
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._buckets: Dict[str, TokenBucket] = {}
        self.configure(config or QuotaConfig())

    def configure(self, config: QuotaConfig) -> None:
        """Swap in a new config; existing buckets of re-listed tenants
        are rebuilt (full), dropped tenants lose their bucket."""
        with self._lock:
            self._config = config
            self._buckets = {
                tenant: TokenBucket(q, self._clock)
                for tenant, q in config.tenants.items()}
            self._labeled = (set(config.tenants)
                             | set(config.metric_tenants)
                             | {DEFAULT_TENANT})

    def set_quota(self, tenant: str,
                  quota: Optional[TenantQuota]) -> None:
        """Admin mutation: install (or with None remove) one tenant's
        limit without touching the others' bucket state."""
        with self._lock:
            tenants = dict(self._config.tenants)
            if quota is None:
                tenants.pop(tenant, None)
                self._buckets.pop(tenant, None)
            else:
                tenants[tenant] = quota
                self._buckets[tenant] = TokenBucket(quota, self._clock)
            self._config = QuotaConfig(
                tenants=tenants, default=self._config.default,
                metric_tenants=self._config.metric_tenants)
            self._labeled = (set(tenants)
                             | set(self._config.metric_tenants)
                             | {DEFAULT_TENANT})

    def check(self, tenant: Optional[str]) -> str:
        """Admit or raise for one request.

        Returns the resolved tenant id (``default`` for None). Raises
        :class:`QuotaExceededError` when the tenant's bucket is empty."""
        tenant = tenant or DEFAULT_TENANT
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                default = self._config.default
                if default is None:
                    return tenant
                bucket = TokenBucket(default, self._clock)
                self._buckets[tenant] = bucket
        wait = bucket.take()
        if wait is not None:
            raise QuotaExceededError(tenant, retry_after_s=wait)
        return tenant

    def label_for(self, tenant: str) -> str:
        """The metric label for ``tenant`` — itself when allowlisted,
        else :data:`OTHER_TENANT_LABEL` (bounded cardinality)."""
        with self._lock:
            return tenant if tenant in self._labeled else OTHER_TENANT_LABEL

    def snapshot(self) -> Dict[str, object]:
        """Serializable view of the whole quota state: config + live
        token counts.

        Returns a JSON-safe dict ``{"config": {...}, "buckets":
        {tenant: tokens}}``. Token counts are read through
        :meth:`TokenBucket.tokens` (post-refill), so the snapshot is
        clock-safe: it never contains monotonic timestamps, only how
        full each bucket was at the instant of the snapshot. Buckets
        lazily created for default-limited tenants are included — a
        restore on another host keeps charging a tenant that had burned
        its default budget here. This is the replication primitive for
        the fleet fabric (every front door enforcing one policy) and
        doubles as front-door restart state."""
        with self._lock:
            cfg = self._config
            buckets = dict(self._buckets)
        return {
            "config": {
                "default": ({"rate": cfg.default.rate,
                             "burst": cfg.default.burst}
                            if cfg.default else None),
                "tenants": {t: {"rate": q.rate, "burst": q.burst}
                            for t, q in cfg.tenants.items()},
                "metric_tenants": sorted(cfg.metric_tenants),
            },
            "buckets": {t: b.tokens() for t, b in buckets.items()},
        }

    def restore(self, snap: Dict[str, object]) -> None:
        """Adopt a :meth:`snapshot` — config and token counts.

        Rebuilds the config (so the restored manager enforces the same
        policy), then overwrites each bucket's token count via
        :meth:`TokenBucket.restore_tokens` — refill re-anchors at *this*
        manager's clock, which makes the restore safe across processes
        and across injected test clocks. Snapshot tenants that are
        neither named in the config nor covered by a default limit are
        skipped (they are unlimited here). Raises ``ValueError`` /
        ``KeyError`` on malformed snapshots."""
        cfg = snap["config"]
        default = cfg.get("default")
        config = QuotaConfig(
            tenants={str(t): TenantQuota(rate=float(q["rate"]),
                                         burst=float(q["burst"]))
                     for t, q in (cfg.get("tenants") or {}).items()},
            default=(TenantQuota(rate=float(default["rate"]),
                                 burst=float(default["burst"]))
                     if default else None),
            metric_tenants=tuple(cfg.get("metric_tenants") or ()))
        self.configure(config)
        for tenant, tokens in (snap.get("buckets") or {}).items():
            tenant = str(tenant)
            with self._lock:
                bucket = self._buckets.get(tenant)
                if bucket is None:
                    if config.default is None:
                        continue
                    bucket = TokenBucket(config.default, self._clock)
                    self._buckets[tenant] = bucket
            bucket.restore_tokens(float(tokens))

    def describe(self) -> Dict[str, object]:
        """JSON view of the quota state (``GET /v1/models``)."""
        with self._lock:
            cfg = self._config
            out = {
                "default": ({"rate": cfg.default.rate,
                             "burst": cfg.default.burst}
                            if cfg.default else None),
                "tenants": {
                    t: {"rate": q.rate, "burst": q.burst}
                    for t, q in cfg.tenants.items()},
                "metric_tenants": sorted(cfg.metric_tenants),
            }
        return out
