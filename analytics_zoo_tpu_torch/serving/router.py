"""Weighted traffic routing — the version-selection half of the control
plane.

The reference's web-service layer (``apps/web-service-sample``) assumes
an operator manually points traffic at a model version; here versions
are minted automatically (hot-reload registers every committed
checkpoint) so the engine needs a programmable answer to "which version
serves this request". A :class:`TrafficPolicy` maps versions of one
model to weights; the :class:`Router` holds at most one policy per model
plus the model's *shadow* registrations, and the engine consults it on
every version-less ``predict``:

- **No policy** → route to ``_latest`` (bitwise the pre-router behavior;
  the no-policy path adds one dict miss per request).
- **Policy** → deterministic weighted pick: the ``n``-th routed request
  maps to the point ``frac(n · φ)`` of the unit interval (the golden-
  ratio low-discrepancy sequence — over any window of N requests each
  version receives ``N·weight ± 1`` picks, no RNG, fully reproducible
  in tests), and the versions partition the interval in ascending
  version order. Because a canary is the numerically newest version it
  owns the *top* of the interval, so as a rollout grows its weight the
  canary region only ever expands downward — a request point that once
  hit the canary keeps hitting it.
- **Sticky routing** — a request carrying a route key (HTTP header
  ``X-Zoo-Route-Key``) hashes the key to a fixed point of the same
  interval instead of consuming the sequence: a given key maps to the
  same version for as long as the weight table stands, and under a
  growing canary a key can only move incumbent → canary, never bounce
  back and forth.
- **Explicit version** → the engine never consults the router
  (``predict(..., version="7")`` pins the version; policies only govern
  version-less traffic).

**Shadow traffic**: a version registered as shadow is excluded from
weighted routing and from ``_latest`` repointing; instead the router's
deterministic sampler (an error-diffusion accumulator — exactly
``fraction`` of requests mirror, no RNG) tells the engine which primary
requests to duplicate into the shadow's own batcher. The client always
gets the primary's response; shadow outcomes land only in metrics, and
a shadow submit that would block or shed is silently dropped (shadows
shed first under load — see ``ServingEngine.predict_async``).

Everything here is pure host-side bookkeeping under one lock; see
docs/rollouts.md for the operational model.
"""

from __future__ import annotations

import threading
import zlib
from typing import Dict, List, Optional, Tuple

__all__ = ["TrafficPolicy", "Router", "GOLDEN_RATIO_CONJUGATE"]

#: frac(φ) — the multiplier of the golden-ratio low-discrepancy sequence
#: behind the deterministic weighted pick.
GOLDEN_RATIO_CONJUGATE = 0.6180339887498949


def _version_key(v: str):
    # mirror of engine._version_key: numeric versions order numerically
    try:
        return (0, int(v), "")
    except ValueError:
        return (1, 0, v)


class TrafficPolicy:
    """An immutable weight table over one model's versions.

    ``weights`` maps version → non-negative weight; weights are
    normalized, zero-weight versions are kept in the table (inspectable)
    but receive no traffic. The policy carries its own pick counter, so
    two policies never interleave their low-discrepancy sequences.
    """

    def __init__(self, weights: Dict[str, float]):
        if not weights:
            raise ValueError("a TrafficPolicy needs at least one version")
        cleaned = {}
        for v, w in weights.items():
            w = float(w)
            if w < 0:
                raise ValueError(
                    f"negative weight {w} for version {v!r}")
            cleaned[str(v)] = w
        total = sum(cleaned.values())
        if total <= 0:
            raise ValueError("all weights are zero — nothing to route to")
        self.weights: Dict[str, float] = dict(cleaned)
        # cumulative partition of [0, 1) in ascending version order: the
        # newest (canary) version owns the top of the interval, so weight
        # growth only expands its region downward (sticky keys migrate
        # monotonically incumbent -> canary)
        self._partition: List[Tuple[float, str]] = []
        acc = 0.0
        ordered = sorted(cleaned, key=_version_key)
        for v in ordered:
            acc += cleaned[v] / total
            self._partition.append((acc, v))
        self._partition[-1] = (1.0, ordered[-1])  # close rounding gaps
        self._n = 0
        self._lock = threading.Lock()

    def pick(self, route_key: Optional[str] = None) -> str:
        """The version serving the next request.

        Without a key: the golden-ratio sequence point of the policy's
        pick counter. With a key: the key's fixed hash point (the
        counter is not consumed, so keyed traffic does not perturb the
        unkeyed distribution)."""
        if route_key is not None:
            point = (zlib.crc32(route_key.encode()) & 0xFFFFFFFF) / 2**32
        else:
            with self._lock:
                self._n += 1
                n = self._n
            point = (n * GOLDEN_RATIO_CONJUGATE) % 1.0
        for ceiling, version in self._partition:
            if point < ceiling:
                return version
        return self._partition[-1][1]

    def describe(self) -> Dict[str, float]:
        """``{version: normalized weight}`` (JSON-friendly)."""
        total = sum(self.weights.values())
        return {v: round(w / total, 6) for v, w in self.weights.items()}


class _Shadow:
    """Deterministic sampler for one shadow registration: an
    error-diffusion accumulator mirrors exactly ``fraction`` of the
    primary stream (no RNG; reproducible in tests)."""

    __slots__ = ("fraction", "_acc", "_lock")

    def __init__(self, fraction: float):
        if not 0.0 < fraction <= 1.0:
            raise ValueError(
                f"shadow fraction must be in (0, 1], got {fraction}")
        self.fraction = float(fraction)
        self._acc = 0.0
        self._lock = threading.Lock()

    def fire(self) -> bool:
        with self._lock:
            self._acc += self.fraction
            if self._acc >= 1.0:
                self._acc -= 1.0
                return True
            return False


class Router:
    """Per-model traffic policies + shadow registrations, under one lock.

    The engine owns exactly one Router; the
    :class:`~analytics_zoo_tpu_torch.serving.rollout.RolloutController` drives
    it during canaries, and the admin endpoint
    (``POST /v1/admin/rollout``) mutates it directly for manual weighted
    routing. All mutation is atomic swap of immutable
    :class:`TrafficPolicy` objects, so ``route`` never sees a half-built
    weight table."""

    def __init__(self):
        self._policies: Dict[str, TrafficPolicy] = {}
        self._shadows: Dict[str, Dict[str, _Shadow]] = {}
        self._lock = threading.Lock()

    # -- policies ---------------------------------------------------------

    def set_policy(self, name: str,
                   weights: Dict[str, float]) -> TrafficPolicy:
        """Install (replace) the model's weight table; returns the new
        policy."""
        policy = TrafficPolicy(weights)
        with self._lock:
            self._policies[name] = policy
        return policy

    def clear_policy(self, name: str) -> None:
        """Drop the model's policy — version-less traffic goes back to
        100% latest (the no-policy default)."""
        with self._lock:
            self._policies.pop(name, None)

    def policy(self, name: str) -> Optional[TrafficPolicy]:
        """The model's current policy, or None."""
        with self._lock:
            return self._policies.get(name)

    def route(self, name: str,
              route_key: Optional[str] = None) -> Optional[str]:
        """The version the next version-less request for ``name`` should
        hit, or None when no policy is installed (→ latest)."""
        with self._lock:
            policy = self._policies.get(name)
        if policy is None:
            return None
        return policy.pick(route_key)

    # -- shadows ----------------------------------------------------------

    def set_shadow(self, name: str, version: str, fraction: float) -> None:
        """Mark ``version`` as a shadow receiving ``fraction`` of the
        model's primary traffic (duplicated, responses discarded)."""
        shadow = _Shadow(fraction)
        with self._lock:
            self._shadows.setdefault(name, {})[str(version)] = shadow

    def clear_shadow(self, name: str, version: Optional[str] = None) -> None:
        """Remove one shadow registration (or all of the model's with
        ``version=None``)."""
        with self._lock:
            if version is None:
                self._shadows.pop(name, None)
            else:
                entries = self._shadows.get(name)
                if entries:
                    entries.pop(str(version), None)
                    if not entries:
                        self._shadows.pop(name, None)

    def shadows(self, name: str) -> Dict[str, float]:
        """``{version: sample fraction}`` of the model's shadows."""
        with self._lock:
            return {v: s.fraction
                    for v, s in self._shadows.get(name, {}).items()}

    def shadow_picks(self, name: str) -> List[str]:
        """The shadow versions that should mirror THIS primary request
        (each shadow's sampler advances exactly once per call)."""
        with self._lock:
            entries = list(self._shadows.get(name, {}).items())
        return [v for v, s in entries if s.fire()]

    def is_shadow(self, name: str, version: str) -> bool:
        """True when ``version`` is a shadow registration of ``name``."""
        with self._lock:
            return str(version) in self._shadows.get(name, {})

    # -- introspection ----------------------------------------------------

    def protected_versions(self, name: str) -> List[str]:
        """Versions routing depends on right now — policy members with
        weight and shadows — which retention (hot-reload trimming) must
        not retire."""
        with self._lock:
            policy = self._policies.get(name)
            out = set(policy.weights) if policy is not None else set()
            out.update(self._shadows.get(name, {}))
        return sorted(out, key=_version_key)

    def describe(self, name: str) -> Dict[str, object]:
        """JSON view of the model's routing state (``GET /v1/models``)."""
        with self._lock:
            policy = self._policies.get(name)
            shadows = {v: s.fraction
                       for v, s in self._shadows.get(name, {}).items()}
        return {
            "policy": policy.describe() if policy is not None else None,
            "shadows": shadows,
        }

    def clear_model(self, name: str) -> None:
        """Forget every policy/shadow of ``name`` (engine unregister)."""
        with self._lock:
            self._policies.pop(name, None)
            self._shadows.pop(name, None)
