"""Per-request lifecycle journeys: the "why was THIS request slow" layer
(the port's own copy of substratus_tpu/observability/journey.py; the
wire form and ``stitch`` carry a decode tier's segment back to the
prefill tier, serve/disagg.py).

The fleet plane answers "how is the fleet doing" and the step timeline
answers "where does the engine lose time"; a ``RequestJourney`` answers
the per-request question — a bounded ring of typed lifecycle events
(submit, admit, prefill, handoff ship/install, drain rounds, spec
rounds, flushes, emits, terminal) stamped with monotonic timestamps on
whichever thread owns the request at that moment. Recording is pure
host work (a deque append + a counter), so the engine's zero-host-sync
dispatch contract is untouched: events for an overlapped dispatch are
stamped at drain, never inside the dispatch half.

Cross-process: the disagg handoff header carries a W3C traceparent
(serve/disagg.py), the decode engine parents its journey under it, and
the decode→prefill ``done`` back-channel frame returns the decode
journey segment (``to_wire``/``from_wire``) so the prefill side stitches
ONE merged journey spanning both processes. Timestamps on the wire are
epoch-anchored wall-clock microseconds (the StepTimeline convention), so
segments from different processes sort on a common axis — subject to
the hosts' clock sync, which is the same caveat every distributed
tracer carries.

Layering (docs/observability.md "Request journeys"):

  * every ``Request`` owns a ``RequestJourney`` (created at submit, or
    at KV-install on a decode-role engine);
  * each Engine holds a ``JourneyLog`` — a bounded ring of COMPLETED
    journeys served by ``/debug/requestz?id=`` — and a ``SlowRing`` of
    SLO-breaching journeys served by ``/debug/slowz``;
  * the gateway keeps its edge-side view (arrival, shed/hedge/retry,
    replica choice) in the same classes, keyed by ``x-trace-id``, and
    ``sub trace <id>`` joins all of it into one waterfall.

Jax-free; every structure is lock-guarded because completed journeys
are read from HTTP handler threads while the scheduler keeps recording.
"""
from __future__ import annotations

import threading
import time
import uuid
from collections import deque
from typing import Dict, List, Mapping, Optional, Union

from substratus_tpu_torch.observability.metrics import METRICS

METRICS.describe(
    "substratus_serve_journey_events_total",
    "Request-journey lifecycle events recorded, by event type "
    "(observability/journey.py).",
    type="counter",
)
METRICS.describe(
    "substratus_serve_slo_exemplars_total",
    "SLO-breach exemplars captured (trace id attached to the breaching "
    "latency histogram bucket and the journey copied to /debug/slowz).",
    type="counter",
)

# The full event-type catalog (docs/observability.md keeps the prose
# row per type; tests assert recorded types stay inside this set so a
# typo'd event name fails a test instead of fragmenting dashboards).
EVENT_TYPES = (
    "submit",        # request entered the engine queue (submitter thread)
    "admit",         # scheduler dequeued + admitted (carries queue wait)
    "adapter_wait",  # admission parked on an adapter load
    "pool_wait",     # admission parked on page-pool capacity
    "prefill",       # prompt prefill ran (tokens, chunks)
    "prefix_hit",    # prefix-cache pages reused at admission
    "ship",          # prefill side exported + shipped KV pages
    "kv_recv",       # decode side received the KV frame (reader thread)
    "install",       # decode scheduler installed the migration
    "dispatch",      # overlapped step dispatched (stamped at drain)
    "drain",         # overlapped step drained (one per emitted token)
    "spec_round",    # speculative round verified {k, accepted}
    "flush",         # pipeline flush hit this request {reason}
    "preempt",       # request was preempted back to the queue
    "requeue",       # disagg flight requeued for re-prefill
    "slo_breach",    # SLOTracker threshold breach {slo, seconds}
    "shed",          # gateway shed the request {reason}
    "replica",       # gateway picked a replica {url, score}
    "hedge",         # gateway launched a hedged attempt
    "retry",         # gateway retried after a replica failure
    "arrive",        # gateway edge arrival
    "emit",          # one token delivered to the client queue
    "swap",          # hot weight-swap landed mid-stream {version}
    "rollout",       # controller-driven rolling swap hit this replica
    "end",           # terminal: EOS / length / cancel / error {reason}
)


def _wall_us() -> int:
    return time.time_ns() // 1_000


class RequestJourney:
    """Bounded ring of (wall_us, type, data) lifecycle events plus a
    first-occurrence mark per event type.

    The ring holds the most recent ``cap`` events (a long stream's emit
    events evict the oldest emits); ``marks`` pins the FIRST occurrence
    of every type outside the ring, so the waterfall milestones —
    submit, admit, ship, install, first emit, end — survive any stream
    length. ``total`` counts everything ever recorded.
    """

    __slots__ = (
        "trace_id", "rid", "origin", "cap", "total", "events", "marks",
        "breaches", "_segments", "_lock", "_epoch_perf", "_epoch_wall_us",
    )

    def __init__(self, trace_id: Optional[str] = None,
                 rid: Optional[str] = None, origin: str = "engine",
                 cap: int = 256):
        self.trace_id = trace_id or uuid.uuid4().hex
        self.rid = rid
        self.origin = origin
        self.cap = max(8, int(cap))
        self.total = 0
        self.events: "deque" = deque(maxlen=self.cap)
        self.marks: Dict[str, list] = {}
        self.breaches: List[dict] = []
        self._segments: List[dict] = []
        self._lock = threading.Lock()
        # Wall/monotonic epoch pair: events are stamped from the
        # monotonic clock (cheap, never steps) and anchored to wall
        # time once, so wire timestamps from two processes sort on a
        # shared axis (the StepTimeline convention).
        self._epoch_perf = time.perf_counter()
        self._epoch_wall_us = _wall_us()

    # -- recording (owning thread) ----------------------------------------

    def _now_us(self) -> int:
        return self._epoch_wall_us + int(
            (time.perf_counter() - self._epoch_perf) * 1e6
        )

    def record(self, type: str, **data) -> None:
        """Append one event. Pure host work: a timestamp, a deque
        append, a counter — safe on the scheduler thread mid-step."""
        ts = self._now_us()
        ev = [ts, type, data or None]
        with self._lock:
            self.events.append(ev)
            self.total += 1
            if type not in self.marks:
                self.marks[type] = ev
        METRICS.inc(
            "substratus_serve_journey_events_total", {"type": type}
        )

    def record_once(self, type: str, **data) -> None:
        """Record only the first occurrence of ``type`` (wait-style
        events that would otherwise repeat every scheduler poll)."""
        with self._lock:
            seen = type in self.marks
        if not seen:
            self.record(type, **data)

    def breach(self, slo: str, seconds: float, threshold_s: float) -> None:
        """Note an SLO breach; the completed journey is then copied to
        the engine's SlowRing at terminal time."""
        with self._lock:
            self.breaches.append({
                "slo": slo,
                "seconds": round(seconds, 6),
                "threshold_s": threshold_s,
            })
        self.record("slo_breach", slo=slo, seconds=round(seconds, 6))

    @property
    def ended(self) -> bool:
        with self._lock:
            return "end" in self.marks

    # -- cross-process stitch ----------------------------------------------

    def to_wire(self, limit: int = 160) -> dict:
        """Compact wire form of this journey segment for the disagg
        ``done`` back-channel frame (key drift between this producer
        and ``from_wire`` is caught by analysis/protodrift.py)."""
        with self._lock:
            ev = list(self.events)[-limit:]
            return {
                "tid": self.trace_id,
                "rid": self.rid,
                "o": self.origin,
                "n": self.total,
                "mk": {k: list(v) for k, v in self.marks.items()},
                "ev": [list(e) for e in ev],
                "br": list(self.breaches),
            }

    @staticmethod
    def from_wire(seg: Mapping) -> Optional[dict]:
        """Wire segment -> snapshot-shaped dict, or None when the
        payload is malformed (a garbled frame must not poison the
        prefill-side journey)."""
        if not isinstance(seg, Mapping):
            return None
        tid = seg.get("tid")
        ev = seg.get("ev")
        if not isinstance(tid, str) or not isinstance(ev, list):
            return None
        marks = seg.get("mk")
        return {
            "trace_id": tid,
            "rid": seg.get("rid"),
            "origin": str(seg.get("o", "remote")),
            "total": int(seg.get("n", len(ev))),
            "events": [list(e) for e in ev if isinstance(e, list)],
            "marks": dict(marks) if isinstance(marks, Mapping) else {},
            "breaches": list(seg.get("br") or []),
            "segments": [],
        }

    def stitch(self, segment: Union[Mapping, dict, None]) -> bool:
        """Merge a remote journey segment (``to_wire`` output or an
        already-parsed snapshot) under this journey. Returns False when
        the segment is unusable."""
        if isinstance(segment, Mapping) and "events" in segment \
                and "trace_id" in segment:
            parsed: Optional[dict] = dict(segment)
        else:
            parsed = self.from_wire(segment) if segment is not None else None
        if parsed is None:
            return False
        with self._lock:
            self.breaches.extend(parsed.get("breaches") or [])
            self._segments.append(parsed)
        return True

    # -- reads (any thread) ------------------------------------------------

    def snapshot(self) -> dict:
        """Full JSON-safe view: own ring + marks + stitched segments."""
        with self._lock:
            return {
                "trace_id": self.trace_id,
                "rid": self.rid,
                "origin": self.origin,
                "total": self.total,
                "dropped": max(0, self.total - len(self.events)),
                "events": [list(e) for e in self.events],
                "marks": {k: list(v) for k, v in self.marks.items()},
                "breaches": list(self.breaches),
                "segments": [dict(s) for s in self._segments],
            }


# -- journey rendering --------------------------------------------------------


def _origins(snapshot: Mapping) -> List[dict]:
    """Flatten a stitched snapshot into per-origin event groups."""
    out = [dict(snapshot)]
    for seg in snapshot.get("segments") or []:
        out.append(dict(seg))
    return out


def waterfall(snapshot: Mapping) -> List[dict]:
    """One row per event across all origins, time-sorted: the
    edge→prefill→transfer→decode→emit view `sub trace` prints."""
    rows: List[dict] = []
    for part in _origins(snapshot):
        origin = part.get("origin", "?")
        for ev in part.get("events") or []:
            if not isinstance(ev, (list, tuple)) or len(ev) < 2:
                continue
            rows.append({
                "ts_us": int(ev[0]),
                "origin": origin,
                "type": str(ev[1]),
                "data": ev[2] if len(ev) > 2 else None,
            })
    rows.sort(key=lambda r: r["ts_us"])
    return rows


# Milestone pairs rendered as Chrome-trace duration slices; everything
# else shows as instant events on the origin's row.
_PHASES = (
    # (slice name, start mark, end marks in preference order)
    ("queue", "submit", ("admit", "end")),
    ("prefill", "admit", ("ship", "emit", "end")),
    ("handoff", "ship", ("install", "end")),
    ("decode", "install", ("end",)),
    ("stream", "emit", ("end",)),
)


def chrome_trace(snapshot: Mapping) -> dict:
    """chrome://tracing / Perfetto JSON for one (stitched) journey:
    instant events per lifecycle event plus derived phase slices from
    the milestone marks. Load via /debug/requestz?id=."""
    parts = _origins(snapshot)
    events: List[dict] = []
    # Merged mark table: first occurrence wins across origins so the
    # handoff slice spans the prefill "ship" and the decode "install".
    marks: Dict[str, list] = {}
    for part in parts:
        for k, v in (part.get("marks") or {}).items():
            if isinstance(v, (list, tuple)) and len(v) >= 2:
                if k not in marks or v[0] < marks[k][0]:
                    marks[k] = list(v)
    for tid, part in enumerate(parts):
        origin = part.get("origin", "?")
        events.append({
            "name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
            "args": {"name": f"{origin} ({part.get('rid') or '-'})"},
        })
        for ev in part.get("events") or []:
            if not isinstance(ev, (list, tuple)) or len(ev) < 2:
                continue
            events.append({
                "name": str(ev[1]), "ph": "i", "s": "t",
                "pid": 0, "tid": tid, "ts": int(ev[0]),
                "args": ev[2] if len(ev) > 2 and ev[2] else {},
            })
    for name, start, ends in _PHASES:
        if start not in marks:
            continue
        t0 = int(marks[start][0])
        t1 = None
        for e in ends:
            m = marks.get(e)
            if m is not None and int(m[0]) >= t0:
                t1 = int(m[0])
                break
        if t1 is None:
            continue
        events.append({
            "name": name, "ph": "X", "pid": 0, "tid": len(parts),
            "ts": t0, "dur": max(1, t1 - t0), "args": {},
        })
    events.append({
        "name": "thread_name", "ph": "M", "pid": 0, "tid": len(parts),
        "args": {"name": "phases"},
    })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "trace_id": snapshot.get("trace_id"),
            "rid": snapshot.get("rid"),
            "breaches": snapshot.get("breaches") or [],
        },
    }


# -- per-engine retention -----------------------------------------------------


class JourneyLog:
    """Bounded ring of journeys, found by trace id or request id.

    Holds completed snapshots (engine terminal path) or live
    ``RequestJourney`` objects (the gateway's edge view, snapshotted at
    read time). Lock-guarded: the scheduler/manager threads add while
    HTTP handler threads search.
    """

    def __init__(self, cap: int = 128):
        self._lock = threading.Lock()
        self._ring: "deque" = deque(maxlen=max(1, int(cap)))

    def add(self, item: Union[RequestJourney, dict]) -> None:
        with self._lock:
            self._ring.append(item)

    def _snap(self, item) -> dict:
        return item.snapshot() if isinstance(item, RequestJourney) else item

    def live(self, trace_id: str) -> Optional[RequestJourney]:
        """The stored journey OBJECT for a trace id (gateway edge
        recording appends events to it as routing decisions happen)."""
        with self._lock:
            for item in reversed(self._ring):
                if isinstance(item, RequestJourney) \
                        and item.trace_id == trace_id:
                    return item
        return None

    def find(self, id: str) -> Optional[dict]:
        """Newest journey whose trace id or request id matches."""
        if not id:
            return None
        with self._lock:
            items = list(self._ring)
        for item in reversed(items):
            snap = self._snap(item)
            if snap.get("trace_id") == id or snap.get("rid") == id:
                return snap
        return None

    def snapshot(self, limit: int = 32) -> List[dict]:
        with self._lock:
            items = list(self._ring)[-limit:]
        return [self._snap(i) for i in items]

    def ids(self) -> List[dict]:
        with self._lock:
            items = list(self._ring)
        return [
            {"trace_id": self._snap(i).get("trace_id"),
             "rid": self._snap(i).get("rid")}
            for i in items
        ]


class SlowRing:
    """Bounded ring of SLO-breaching completed journeys — the
    /debug/slowz exemplar store. A breach marks the journey; the
    engine copies the COMPLETED journey here at terminal time, so every
    entry shows the request's whole lifecycle, not a prefix."""

    def __init__(self, cap: int = 32):
        self._lock = threading.Lock()
        self._ring: "deque" = deque(maxlen=max(1, int(cap)))
        self.total = 0

    def add(self, snapshot: dict) -> None:
        with self._lock:
            self._ring.append({
                "trace_id": snapshot.get("trace_id"),
                "rid": snapshot.get("rid"),
                "breaches": snapshot.get("breaches") or [],
                "journey": snapshot,
            })
            self.total += 1

    def snapshot(self) -> List[dict]:
        with self._lock:
            return [dict(e) for e in self._ring]
