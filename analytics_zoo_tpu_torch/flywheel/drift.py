"""Bounded-memory drift detection for the outcome plane.

Two divergence families, both evaluated incrementally over streaming
sketches so a serving worker never holds more than ``max_bins``
centroids per tracked distribution:

* **Per-feature PSI** (population stability index) between a *pinned
  reference window* (the capture segments a model's incumbent was last
  retrained on) and the live capture window — the "is the input
  distribution still the one the model saw?" question.
* **Prediction-histogram Jensen–Shannon divergence** between two model
  versions' live prediction distributions — the canary gate: a
  candidate whose outputs diverge from the incumbent's beyond tolerance
  on the *same* traffic is rolled back by the rollout ladder
  (``RolloutConfig.drift_gates``) before it takes real share.

The sketch is a Ben-Haim/Tom-Tova style streaming histogram: (value,
count) centroids, closest pair merged on overflow. Comparing two
sketches projects both onto shared uniform edges spanning their joint
range — projection, PSI and JS are all pure functions of the two
centroid sets, so two workers summarizing the same stream agree.

Scores surface as the ``zoo_drift_*`` gauge families
(:func:`analytics_zoo_tpu_torch.common.observability.drift_metrics`) and in
``GET /v1/models/<name>`` via the engine's outcome-status block.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from analytics_zoo_tpu_torch.common.observability import drift_metrics

__all__ = [
    "StreamingHistogram",
    "psi",
    "js_divergence",
    "DriftDetector",
    "PredictionTracker",
]

#: Smoothing mass added to every projected bin before PSI/JS — keeps a
#: bin that one side never touched from blowing PSI up to infinity.
_EPS = 1e-6


class StreamingHistogram:
    """A bounded-memory one-pass histogram sketch.

    Maintains at most ``max_bins`` (value, count) centroids; adding a
    value either lands on an existing centroid, inserts a new one, or
    — on overflow — merges the closest centroid pair (the
    Ben-Haim/Tom-Tova streaming-parallel-decision-tree construction).
    Not thread-safe; owners lock around it.
    """

    __slots__ = ("max_bins", "_bins", "count", "_min", "_max")

    def __init__(self, max_bins: int = 64):
        if max_bins < 2:
            raise ValueError(f"max_bins must be >= 2, got {max_bins}")
        self.max_bins = int(max_bins)
        self._bins: List[Tuple[float, float]] = []  # sorted (value, count)
        self.count = 0
        self._min = math.inf
        self._max = -math.inf

    def add(self, value: float, count: float = 1.0) -> None:
        """Fold one observation (or ``count`` identical ones) in."""
        v = float(value)
        if not math.isfinite(v):
            return  # NaN/inf carries no distributional information
        self.count += count
        self._min = v if v < self._min else self._min
        self._max = v if v > self._max else self._max
        bins = self._bins
        i = bisect.bisect_left(bins, (v, -math.inf))
        if i < len(bins) and bins[i][0] == v:
            bins[i] = (v, bins[i][1] + count)
            return
        bins.insert(i, (v, count))
        if len(bins) <= self.max_bins:
            return
        # merge the closest adjacent pair into its weighted centroid
        gaps = [bins[k + 1][0] - bins[k][0] for k in range(len(bins) - 1)]
        k = gaps.index(min(gaps))
        (v1, c1), (v2, c2) = bins[k], bins[k + 1]
        merged = ((v1 * c1 + v2 * c2) / (c1 + c2), c1 + c2)
        bins[k:k + 2] = [merged]

    def extend(self, values: Sequence[float]) -> None:
        for v in np.asarray(values, dtype=np.float64).ravel():
            self.add(float(v))

    @property
    def span(self) -> Tuple[float, float]:
        """(min, max) observed — the joint-range basis for projection."""
        return self._min, self._max

    def project(self, edges: np.ndarray) -> np.ndarray:
        """Centroid mass binned onto ``edges`` (len(edges)-1 bins),
        normalized to a probability vector. Deterministic in the
        centroid set."""
        n = len(edges) - 1
        out = np.zeros(n, dtype=np.float64)
        if not self._bins:
            return out
        for v, c in self._bins:
            k = int(np.searchsorted(edges, v, side="right")) - 1
            k = 0 if k < 0 else (n - 1 if k >= n else k)
            out[k] += c
        total = out.sum()
        return out / total if total > 0 else out

    def snapshot(self) -> Dict[str, Any]:
        return {"count": self.count, "bins": len(self._bins),
                "min": None if self.count == 0 else self._min,
                "max": None if self.count == 0 else self._max}


def _common_edges(a: StreamingHistogram, b: StreamingHistogram,
                  bins: int = 16) -> Optional[np.ndarray]:
    lo = min(a.span[0], b.span[0])
    hi = max(a.span[1], b.span[1])
    if not (math.isfinite(lo) and math.isfinite(hi)):
        return None
    scale = max(1.0, abs(lo), abs(hi))
    if hi - lo <= 1e-6 * scale:
        # the pooled span is within float noise of zero — the streams are
        # numerically identical (e.g. one model served through two
        # arithmetic paths, or a retrained candidate whose loss was
        # already ~0). Widen the range so the whole noise band shares one
        # bin; a naive linspace over the noise span would drop the two
        # point masses into opposite end bins and read maximal divergence
        # out of zero distributional signal.
        mid = 0.5 * (lo + hi)
        # offset by half a bin so mid falls mid-BIN, not on an edge —
        # centering an even grid on mid would put the noise band
        # astride the central edge, recreating the exact split this
        # branch exists to prevent
        half_bin = scale / bins
        lo, hi = mid - scale - half_bin, mid + scale - half_bin
    return np.linspace(lo, hi, bins + 1)


def psi(p: np.ndarray, q: np.ndarray, eps: float = _EPS) -> float:
    """Population stability index between two probability vectors:
    ``sum((p - q) * ln(p / q))`` with ``eps`` smoothing. 0 = identical;
    the classic operating bands are <0.1 stable, 0.1–0.25 drifting,
    >0.25 diverged."""
    p = np.asarray(p, dtype=np.float64) + eps
    q = np.asarray(q, dtype=np.float64) + eps
    p = p / p.sum()
    q = q / q.sum()
    return float(np.sum((p - q) * np.log(p / q)))


def js_divergence(p: np.ndarray, q: np.ndarray, eps: float = _EPS) -> float:
    """Jensen–Shannon divergence (base 2) between two probability
    vectors — symmetric, bounded to [0, 1]."""
    p = np.asarray(p, dtype=np.float64) + eps
    q = np.asarray(q, dtype=np.float64) + eps
    p = p / p.sum()
    q = q / q.sum()
    m = 0.5 * (p + q)
    kl_pm = np.sum(p * np.log2(p / m))
    kl_qm = np.sum(q * np.log2(q / m))
    js = 0.5 * (kl_pm + kl_qm)
    return float(min(1.0, max(0.0, js)))


def compare(a: StreamingHistogram, b: StreamingHistogram,
            bins: int = 16) -> Optional[Dict[str, float]]:
    """PSI + JS between two sketches over their joint range, or None
    when either side is empty."""
    if a.count == 0 or b.count == 0:
        return None
    edges = _common_edges(a, b, bins)
    if edges is None:
        return None
    p, q = a.project(edges), b.project(edges)
    return {"psi": psi(p, q), "js": js_divergence(p, q)}


def _prediction_scalar(y: Any) -> Optional[float]:
    """One comparable scalar per prediction: the mean of the first
    output array — crude but stable, and identical on both sides of
    every comparison, which is all a divergence needs."""
    try:
        if isinstance(y, (list, tuple)):
            y = y[0] if y else None
        if y is None:
            return None
        v = float(np.mean(np.asarray(y, dtype=np.float64)))
    except (TypeError, ValueError):
        return None
    return v if math.isfinite(v) else None


class DriftDetector:
    """Per-feature input drift for one model: a pinned reference window
    of feature sketches versus a live window fed by ongoing capture.

    ``set_reference(rows_of_x)`` pins the distribution the incumbent was
    trained on (call it after each successful retrain, with the consumed
    window); ``observe(x)`` folds live requests in. ``scores()`` emits
    per-feature PSI into the ``zoo_drift_feature_psi`` gauge family.
    Features are the flattened positions of the (first) input array,
    capped at ``max_features``.
    """

    def __init__(self, model: str, max_bins: int = 64,
                 max_features: int = 16):
        self.model = str(model)
        self.max_bins = int(max_bins)
        self.max_features = int(max_features)
        self._lock = threading.Lock()
        self._reference: List[StreamingHistogram] = []
        self._live: List[StreamingHistogram] = []
        self.metrics = drift_metrics()

    @staticmethod
    def _features(x: Any) -> Optional[np.ndarray]:
        if isinstance(x, (list, tuple)):
            x = x[0] if x else None
        if x is None:
            return None
        try:
            return np.asarray(x, dtype=np.float64).ravel()
        except (TypeError, ValueError):
            return None

    def _fold(self, sketches: List[StreamingHistogram],
              feats: np.ndarray) -> None:
        n = min(len(feats), self.max_features)
        while len(sketches) < n:
            sketches.append(StreamingHistogram(self.max_bins))
        for i in range(n):
            sketches[i].add(float(feats[i]))

    def set_reference(self, xs: Sequence[Any]) -> None:
        """Pin the reference window (replacing any previous pin) and
        reset the live window — the post-retrain baseline."""
        ref: List[StreamingHistogram] = []
        for x in xs:
            feats = self._features(x)
            if feats is not None:
                self._fold(ref, feats)
        with self._lock:
            self._reference = ref
            self._live = []

    def observe(self, x: Any) -> None:
        """Fold one live request's features into the live window."""
        feats = self._features(x)
        if feats is None:
            return
        with self._lock:
            self._fold(self._live, feats)

    def scores(self, min_count: int = 1) -> Optional[Dict[str, float]]:
        """Per-feature PSI (``{"f0": psi, ...}``) between reference and
        live, or None before both sides hold ``min_count`` rows. Sets
        the ``zoo_drift_feature_psi`` gauges as a side effect."""
        with self._lock:
            ref = list(self._reference)
            live = list(self._live)
        if not ref or not live:
            return None
        out: Dict[str, float] = {}
        for i in range(min(len(ref), len(live))):
            if ref[i].count < min_count or live[i].count < min_count:
                continue
            cmpd = compare(ref[i], live[i])
            if cmpd is None:
                continue
            out[f"f{i}"] = cmpd["psi"]
            self.metrics["feature_psi"].labels(
                model=self.model, feature=f"f{i}").set(cmpd["psi"])
        if not out:
            return None
        self.metrics["evaluations"].labels(model=self.model).inc()
        return out


class PredictionTracker:
    """Per-(model, version) prediction-distribution sketches — the
    rollout ladder's drift-gate substrate.

    The engine feeds every successful prediction in
    (:meth:`observe`); :meth:`js` compares a canary's distribution
    against the incumbent's over the same traffic window and returns the
    JS divergence, or None until both sides hold ``min_count``
    predictions (a gate must never fire on noise). ``reset(model,
    version)`` drops a retired version's sketch.
    """

    def __init__(self, max_bins: int = 64):
        self.max_bins = int(max_bins)
        self._lock = threading.Lock()
        self._sketches: Dict[Tuple[str, str], StreamingHistogram] = {}
        self.metrics = drift_metrics()

    def observe(self, model: str, version: str, y: Any) -> None:
        """Fold one prediction into ``model@version``'s sketch."""
        v = _prediction_scalar(y)
        if v is None:
            return
        key = (str(model), str(version))
        with self._lock:
            sk = self._sketches.get(key)
            if sk is None:
                sk = self._sketches[key] = StreamingHistogram(self.max_bins)
            sk.add(v)

    def counts(self, model: str) -> Dict[str, float]:
        with self._lock:
            return {v: sk.count for (m, v), sk in self._sketches.items()
                    if m == str(model)}

    def js(self, model: str, version_a: str, version_b: str,
           min_count: int = 30) -> Optional[float]:
        """JS divergence between two versions' prediction distributions,
        or None until both hold ``min_count`` observations. Sets the
        ``zoo_drift_prediction_js`` gauge when it evaluates."""
        with self._lock:
            a = self._sketches.get((str(model), str(version_a)))
            b = self._sketches.get((str(model), str(version_b)))
        if a is None or b is None or a.count < min_count \
                or b.count < min_count:
            return None
        cmpd = compare(a, b)
        if cmpd is None:
            return None
        self.metrics["prediction_js"].labels(model=str(model)).set(
            cmpd["js"])
        self.metrics["evaluations"].labels(model=str(model)).inc()
        return cmpd["js"]

    def reset(self, model: str, version: Optional[str] = None) -> None:
        """Drop sketches for a version (or every version of a model)."""
        with self._lock:
            if version is not None:
                self._sketches.pop((str(model), str(version)), None)
            else:
                for key in [k for k in self._sketches
                            if k[0] == str(model)]:
                    self._sketches.pop(key, None)

    def describe(self, model: str) -> Dict[str, Any]:
        with self._lock:
            return {v: sk.snapshot()
                    for (m, v), sk in self._sketches.items()
                    if m == str(model)}
