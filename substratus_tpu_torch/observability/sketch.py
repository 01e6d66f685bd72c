"""Mergeable fixed-bucket percentile sketches + SLO burn tracking (the
port's own copy of substratus_tpu/observability/sketch.py).

The serving SLOs (TTFT, inter-token latency) need percentiles that
aggregate across a fleet: a replica cannot ship raw samples on every
load report, and you cannot average percentiles. A fixed-bucket sketch
CAN be merged exactly — two sketches over the same bucket bounds add
counts bucket-wise, and the merged quantile is what a single sketch
over the union of samples would have said (bounded by bucket width,
the same error a Prometheus histogram_quantile carries). That is why
the bounds are fixed at declaration and merging across different
bounds is an error, never an approximation.

Layering (docs/observability.md "Fleet telemetry"):

  * each Engine holds an ``SLOTracker`` — one ``Sketch`` per SLO plus a
    burn counter (`substratus_slo_burn_total{slo=...}`) incremented on
    every observation over the threshold;
  * ``Engine.load_snapshot()`` carries ``SLOTracker.snapshot()`` (the
    serialized sketches), so every ``GET /loadz`` poll ships the
    replica's full latency distribution in a few hundred bytes;
  * the gateway's fleet aggregator (gateway/fleet.py) keeps the latest
    sketch per replica and merges them into fleet-wide percentiles —
    exact aggregation, no per-request work on the gateway.

Lock-guarded: observed on the engine scheduler thread,
snapshotted from HTTP handler threads.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from substratus_tpu_torch.observability.metrics import (
    LATENCY_BUCKETS,
    METRICS,
    quantile_from_buckets,
)

METRICS.describe(
    "substratus_slo_burn_total",
    "Observations over their SLO threshold, by slo (ttft|inter_token): "
    "the error-budget burn counter a controller alerts and scales on.",
    type="counter",
)

# Default SLO thresholds (seconds). Deliberately generous: a burn
# counter that ticks on every token is noise, one that ticks when the
# user-visible contract breaks is a signal (EngineConfig overrides).
DEFAULT_SLOS: Tuple[Tuple[str, float], ...] = (
    ("ttft", 2.0),
    ("inter_token", 0.25),
)


class Sketch:
    """Fixed-bucket latency sketch: counts per bucket + sum + count.

    Mergeable by construction — see the module docstring. Bounds
    default to the registry's LATENCY_BUCKETS so sketch percentiles
    and scraped histogram percentiles agree bucket-for-bucket.
    """

    def __init__(self, bounds: Sequence[float] = LATENCY_BUCKETS):
        bs = tuple(sorted(float(b) for b in bounds))
        if not bs:
            raise ValueError("sketch needs at least one bucket bound")
        self.bounds = bs
        self._lock = threading.Lock()
        self._counts = [0] * (len(bs) + 1)  # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        i = len(self.bounds)
        for j, b in enumerate(self.bounds):
            if v <= b:
                i = j
                break
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def merge(self, other: "Sketch") -> None:
        """Add another sketch's counts into this one (exact: the result
        is the sketch of the combined sample set)."""
        if other.bounds != self.bounds:
            raise ValueError(
                "cannot merge sketches with different bucket bounds "
                f"({len(other.bounds)} vs {len(self.bounds)} bounds)"
            )
        with other._lock:
            counts = list(other._counts)
            s, n = other._sum, other._count
        with self._lock:
            for i, c in enumerate(counts):
                self._counts[i] += c
            self._sum += s
            self._count += n

    def quantile(self, q: float) -> Optional[float]:
        """PromQL-convention quantile (linear interpolation inside the
        holding bucket; +Inf clamps to the widest bound). None = empty."""
        import math

        with self._lock:
            counts = list(self._counts)
        cum = 0
        buckets: List[tuple] = []
        for bound, c in zip(self.bounds + (math.inf,), counts):
            cum += c
            buckets.append((bound, cum))
        return quantile_from_buckets(buckets, q)

    def to_dict(self) -> dict:
        """Wire form for load snapshots: bounds + per-bucket counts
        (non-cumulative, last entry = +Inf bucket) + sum + count."""
        with self._lock:
            return {
                "bounds": list(self.bounds),
                "counts": list(self._counts),
                "sum": round(self._sum, 6),
                "count": self._count,
            }

    @classmethod
    def from_dict(cls, d: Mapping) -> "Sketch":
        """Rebuild from ``to_dict()`` output; raises ValueError on a
        malformed payload (a garbled report must not poison a merge)."""
        bounds = d.get("bounds")
        counts = d.get("counts")
        if not isinstance(bounds, (list, tuple)) or not bounds:
            raise ValueError("sketch dict missing bounds")
        sk = cls(bounds)
        if (
            not isinstance(counts, (list, tuple))
            or len(counts) != len(sk.bounds) + 1
            or any((isinstance(c, bool) or not isinstance(c, int) or c < 0)
                   for c in counts)
        ):
            raise ValueError("sketch dict counts malformed")
        sk._counts = [int(c) for c in counts]
        sk._sum = float(d.get("sum", 0.0))
        sk._count = int(d.get("count", sum(counts)))
        return sk


class SLOTracker:
    """Per-engine SLO state: one sketch per SLO + burn counters.

    ``observe`` is called from the engine scheduler thread on every
    emit; ``snapshot`` from HTTP handler threads (the /loadz body).
    """

    def __init__(self, thresholds: Optional[Mapping[str, float]] = None,
                 bounds: Sequence[float] = LATENCY_BUCKETS):
        self.thresholds: Dict[str, float] = dict(
            thresholds if thresholds is not None else DEFAULT_SLOS
        )
        self.sketches: Dict[str, Sketch] = {
            name: Sketch(bounds) for name in self.thresholds
        }
        self._lock = threading.Lock()
        self._burn: Dict[str, int] = {name: 0 for name in self.thresholds}

    def observe(self, slo: str, seconds: float) -> bool:
        """Record one observation; returns True when it breached the
        SLO threshold (the engine's journey layer captures the breaching
        request as a /debug/slowz exemplar on a True return)."""
        sk = self.sketches.get(slo)
        if sk is None:
            return False  # unknown SLO name must not crash the emit path
        sk.observe(seconds)
        if seconds > self.thresholds[slo]:
            with self._lock:
                self._burn[slo] += 1
            METRICS.inc("substratus_slo_burn_total", {"slo": slo})
            return True
        return False

    def burn(self, slo: str) -> int:
        with self._lock:
            return self._burn.get(slo, 0)

    def snapshot(self) -> dict:
        """{slo: {threshold_s, burn, sketch}} — the /loadz payload the
        fleet aggregator merges (gateway/fleet.py)."""
        with self._lock:
            burn = dict(self._burn)
        return {
            name: {
                "threshold_s": self.thresholds[name],
                "burn": burn[name],
                "sketch": self.sketches[name].to_dict(),
            }
            for name in self.thresholds
        }
