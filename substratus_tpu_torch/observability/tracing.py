"""Dependency-free request/step tracing (the port's own copy of
substratus_tpu/observability/tracing.py).

Spans nest through a contextvar (async- and generator-safe on the event
loop); work that hops threads — the serve engine's scheduler thread picking
up an HTTP request, a reconcile retried on the Manager thread — carries the
parent explicitly: capture `tracer.current_context()` where the work is
submitted and pass it as `parent=` where it runs. Finished spans land in a
bounded ring buffer (oldest evicted first, a crashed exporter can never
OOM the server) and export as JSONL, one span per line:

    {"trace_id": "32-hex", "span_id": "16-hex", "parent_id": "16-hex"|null,
     "name": "serve.completion", "start_us": <epoch micros>,
     "duration_us": <int>, "attributes": {...}, "status": "ok"|"error:Type"}

This is the OTel data model minus the SDK: the JSONL converts to OTLP
losslessly if a collector ever enters the deployment.
"""
from __future__ import annotations

import contextvars
import json
import os
import threading
import time
import uuid
from collections import deque
from typing import Dict, List, NamedTuple, Optional


class SpanContext(NamedTuple):
    trace_id: str
    span_id: str


_current: "contextvars.ContextVar[Optional[SpanContext]]" = (
    contextvars.ContextVar("substratus_span", default=None)
)

# Distinguishes "parent not given" (inherit the contextvar) from an
# EXPLICIT parent — including an explicit None, which means "root span".
# Before this sentinel existed, a worker thread passing parent=None (e.g.
# a Request whose submitter had no active span) silently inherited
# whatever the contextvar held on that thread, mis-parenting the span
# under export-ordering edge cases.
_UNSET = object()


class Span:
    """A single timed operation; use as a context manager. Exceptions
    propagate — the span just records `error:<ExcType>` on the way out."""

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "attributes",
        "status", "_tracer", "_start_wall_us", "_start", "_token",
    )

    def __init__(
        self, tracer: "Tracer", name: str,
        parent, attributes: Dict[str, object],
    ):
        self._tracer = tracer
        self.name = name
        if parent is _UNSET:
            parent = _current.get()
        self.trace_id = (
            parent.trace_id if parent else uuid.uuid4().hex
        )
        self.span_id = uuid.uuid4().hex[:16]
        self.parent_id = parent.span_id if parent else None
        self.attributes = dict(attributes)
        self.status = "ok"
        self._start_wall_us = 0
        self._start = 0.0
        self._token = None

    def set_attribute(self, key: str, value: object) -> "Span":
        self.attributes[key] = value
        return self

    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def __enter__(self) -> "Span":
        self._start_wall_us = time.time_ns() // 1_000
        self._start = time.perf_counter()
        self._token = _current.set(self.context())
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        duration_us = int((time.perf_counter() - self._start) * 1e6)
        if self._token is not None:
            _current.reset(self._token)
        if exc_type is not None:
            self.status = f"error:{exc_type.__name__}"
        self._tracer._record(
            {
                "trace_id": self.trace_id,
                "span_id": self.span_id,
                "parent_id": self.parent_id,
                "name": self.name,
                "start_us": self._start_wall_us,
                "duration_us": duration_us,
                "attributes": self.attributes,
                "status": self.status,
            }
        )
        return False  # never swallow


class _Attached:
    """Context manager that pins `_current` to a given context (tracer
    .attach). No span is recorded; exit restores the previous value."""

    __slots__ = ("_ctx", "_token")

    def __init__(self, ctx: Optional[SpanContext]):
        self._ctx = ctx
        self._token = None

    def __enter__(self) -> Optional[SpanContext]:
        self._token = _current.set(self._ctx)
        return self._ctx

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._token is not None:
            _current.reset(self._token)
        return False


class Tracer:
    """Ring-buffered span collector. `capacity` bounds memory; JSONL export
    drains a snapshot without blocking recorders."""

    def __init__(self, capacity: int = 4096):
        self._lock = threading.Lock()
        self._spans: "deque[dict]" = deque(maxlen=capacity)
        self.dropped = 0  # spans evicted by the ring since the last clear

    def span(self, name: str, parent=_UNSET, **attributes) -> Span:
        """A new span. `parent` semantics: omitted -> inherit the calling
        context's active span (contextvar); an explicit SpanContext ->
        that parent, authoritatively; an explicit None -> a ROOT span.
        Explicit always wins — the contextvar is never consulted once the
        caller said what the parent is."""
        return Span(self, name, parent, attributes)

    def current_context(self) -> Optional[SpanContext]:
        """The active span's context — capture this before handing work to
        another thread, then pass it as `parent=` there."""
        return _current.get()

    def attach(self, ctx: Optional[SpanContext]):
        """Adopt a (remote) context as the calling context's current span
        without recording anything — subsequent spans parent under it.
        Returns a context manager; a None ctx attaches 'no span' (useful
        to isolate background work from an ambient trace)."""
        return _Attached(ctx)

    def _record(self, span: dict) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(span)

    def finished(self) -> List[dict]:
        """Snapshot of buffered finished spans, oldest first."""
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    def to_jsonl(self) -> str:
        return "".join(
            json.dumps(s, separators=(",", ":"), default=str) + "\n"
            for s in self.finished()
        )

    def export_jsonl(self, path: str) -> int:
        """Append buffered spans to `path`; returns the number written.
        The buffer is drained only on success, so a full disk retries the
        same spans next flush instead of dropping them silently."""
        spans = self.finished()
        if not spans:
            return 0
        data = "".join(
            json.dumps(s, separators=(",", ":"), default=str) + "\n"
            for s in spans
        )
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "a") as f:
            f.write(data)
        with self._lock:
            for _ in range(min(len(spans), len(self._spans))):
                self._spans.popleft()
        return len(spans)


tracer = Tracer()


def current_trace_id() -> Optional[str]:
    """Trace id of the calling context's active span, or None. The log
    correlation hook: broad exception handlers that swallow deliberately
    include this in their log line so the swallow is findable from
    /debug/tracez (see the broad-except lint, docs/development.md)."""
    ctx = _current.get()
    return ctx.trace_id if ctx is not None else None
