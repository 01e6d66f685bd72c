"""Controller event stream: a Kubernetes-Event-shaped recorder (the port's
own copy of substratus_tpu/observability/events.py; the port runs no
controller, so no serving entry point attaches a kube client: the
recorder serves /debug/eventz and the profile captures' events).

The reference controllers used controller-runtime's EventRecorder to
narrate reconcile transitions (`kubectl get events` is the first thing an
operator reads when a CR sticks). This is the same surface rebuilt small:

  * `EVENTS.emit(reason, kind=..., name=..., ...)` from any plane;
  * identical events COUNT-DEDUPE (one entry, count++, lastTimestamp
    refreshed) exactly like the apiserver's event series compaction —
    a reconciler polling every 10 s must not mint 8640 objects a day;
  * the recorder is a bounded ring (oldest dropped) so a crash-looping
    controller can never OOM itself narrating the crash loop;
  * when a kube client is attached (Manager does this), every emit also
    upserts a real core/v1 Event object — visible to `kubectl get
    events` against a real cluster and to `sub events` against the fake;
  * the active trace id is stamped on each event, joining the event
    stream to the span exports (docs/observability.md).

Emission is best-effort end to end: a full ring or a failed kube write
drops telemetry, never a reconcile.
"""
from __future__ import annotations

import datetime
import logging
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

from substratus_tpu_torch.observability.metrics import METRICS
from substratus_tpu_torch.observability.tracing import tracer

log = logging.getLogger("substratus.events")

METRICS.describe(
    "substratus_events_total",
    "Events emitted through the shared recorder, by type (dedup counts "
    "each occurrence).", type="counter",
)

EVENT_SOURCE = "substratus-tpu"


def _iso(ts: float) -> str:
    return datetime.datetime.fromtimestamp(
        ts, datetime.timezone.utc
    ).strftime("%Y-%m-%dT%H:%M:%SZ")


class EventRecorder:
    """Bounded, count-deduplicating event sink (thread-safe)."""

    def __init__(self, capacity: int = 256):
        self._lock = threading.Lock()
        self._events: "OrderedDict[tuple, Dict[str, Any]]" = OrderedDict()
        self._capacity = capacity
        self._kube = None
        self.dropped = 0  # events evicted by the ring since the last clear

    def attach_kube(self, client) -> None:
        """Write-through every future emit as a core/v1 Event object on
        this client (real cluster or FakeKube)."""
        self._kube = client

    def emit(
        self,
        reason: str,
        *,
        kind: str = "",
        name: str = "",
        namespace: str = "default",
        message: str = "",
        type: str = "Normal",  # noqa: A002 — the k8s field name
    ) -> Dict[str, Any]:
        """Record one event occurrence; returns the (possibly deduped)
        entry. Dedup key is everything but the timestamps/count."""
        now = time.time()
        ctx = tracer.current_context()
        key = (type, reason, kind, namespace, name, message)
        with self._lock:
            ev = self._events.get(key)
            if ev is not None:
                ev["count"] += 1
                ev["lastTimestamp"] = now
                if ctx is not None:
                    ev["trace_id"] = ctx.trace_id
                self._events.move_to_end(key)
            else:
                ev = {
                    "type": type,
                    "reason": reason,
                    "kind": kind,
                    "namespace": namespace,
                    "name": name,
                    "message": message,
                    "count": 1,
                    "firstTimestamp": now,
                    "lastTimestamp": now,
                    "trace_id": ctx.trace_id if ctx is not None else None,
                }
                self._events[key] = ev
                while len(self._events) > self._capacity:
                    self._events.popitem(last=False)
                    self.dropped += 1
            snapshot = dict(ev)
        METRICS.inc("substratus_events_total", {"type": type})
        self._publish(snapshot)
        return snapshot

    def recent(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Events newest-last-seen first (each with count/timestamps)."""
        with self._lock:
            out = [dict(e) for e in reversed(self._events.values())]
        return out[:limit] if limit else out

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    # -- kube write-through -------------------------------------------------

    @staticmethod
    def _object_name(ev: Dict[str, Any]) -> str:
        import hashlib

        h = hashlib.sha256(
            "/".join(
                str(ev[k])
                for k in ("type", "reason", "kind", "namespace", "name",
                          "message")
            ).encode()
        ).hexdigest()[:12]
        base = ev["name"] or "cluster"
        return f"{base}.{h}"

    def to_kube_event(self, ev: Dict[str, Any]) -> Dict[str, Any]:
        """One recorder entry -> a core/v1 Event manifest."""
        return {
            "apiVersion": "v1",
            "kind": "Event",
            "metadata": {
                "name": self._object_name(ev),
                "namespace": ev["namespace"] or "default",
            },
            "involvedObject": {
                "kind": ev["kind"],
                "namespace": ev["namespace"] or "default",
                "name": ev["name"],
            },
            "reason": ev["reason"],
            "message": ev["message"],
            "type": ev["type"],
            "count": ev["count"],
            "firstTimestamp": _iso(ev["firstTimestamp"]),
            "lastTimestamp": _iso(ev["lastTimestamp"]),
            "source": {"component": EVENT_SOURCE},
        }

    def _publish(self, ev: Dict[str, Any]) -> None:
        client = self._kube
        if client is None:
            return
        desired = self.to_kube_event(ev)
        md = desired["metadata"]
        try:
            live = client.get_or_none("Event", md["namespace"], md["name"])
            if live is None:
                client.create(desired)
            else:
                live.update(
                    {
                        k: desired[k]
                        for k in ("count", "lastTimestamp", "message",
                                  "reason", "type")
                    }
                )
                client.update(live)
        except Exception:  # sublint: allow[broad-except]: telemetry must never fail the work it observes
            log.debug("event write-through failed", exc_info=True)


EVENTS = EventRecorder()
