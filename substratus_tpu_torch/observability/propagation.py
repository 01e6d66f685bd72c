"""W3C Trace Context propagation (traceparent) for cross-process tracing
(the port's own copy of substratus_tpu/observability/propagation.py).

One request crosses many boundaries here — CLI -> serve HTTP -> engine
scheduler thread -> SCI gRPC -> spawned train/load Jobs — and each hop has
a different carrier. This module is the single codec for all of them:

  * HTTP: the ``traceparent`` request header (W3C Trace Context level 1),
    parsed by serve/server.py's middleware and injected by the CLI's
    urllib calls;
  * gRPC: the same value as ``traceparent`` invocation metadata
    (sci/grpc_transport.py, both directions);
  * processes: the ``TRACEPARENT`` environment variable (the convention
    OTel uses for batch jobs), read at train/main.py / load/main.py /
    sci/server_main.py startup;
  * Kubernetes workloads: a DETERMINISTIC traceparent derived from the
    owning CR's identity (controller/workloads.py) — reconcile passes
    mint fresh span ids every time, and stamping those into a pod spec
    would read as drift and recreate the Job on every pass, so the env
    value must be stable for the CR's lifetime.

Format: ``00-{trace_id:32hex}-{span_id:16hex}-{flags:2hex}``. Parsing is
strict per spec: unknown versions other than ff are accepted (forward
compat), all-zero ids are invalid, wrong field widths are invalid. A bad
header yields None — propagation must never fail a request.
"""
from __future__ import annotations

import hashlib
import os
import re
from typing import Dict, Mapping, Optional

from substratus_tpu_torch.observability.tracing import SpanContext, tracer

TRACEPARENT_HEADER = "traceparent"
TRACEPARENT_ENV = "TRACEPARENT"

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)


def format_traceparent(ctx: SpanContext) -> str:
    """SpanContext -> traceparent value (always version 00, sampled)."""
    return f"00-{ctx.trace_id}-{ctx.span_id}-01"


def parse_traceparent(value: Optional[str]) -> Optional[SpanContext]:
    """traceparent value -> SpanContext, or None when absent/malformed.
    Never raises: a hostile or truncated header degrades to 'no remote
    parent', not a 500."""
    if not value or not isinstance(value, str):
        return None
    m = _TRACEPARENT_RE.match(value.strip().lower())
    if m is None:
        return None
    version, trace_id, span_id, _flags = m.groups()
    if version == "ff":  # forbidden by the spec
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return SpanContext(trace_id, span_id)


def current_traceparent() -> Optional[str]:
    """traceparent for the active span, or None outside any span."""
    ctx = tracer.current_context()
    return format_traceparent(ctx) if ctx is not None else None


def inject_headers(headers: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Add the active span's traceparent to an outgoing header dict (the
    dict is returned for chaining; no span active -> unchanged)."""
    headers = dict(headers or {})
    tp = current_traceparent()
    if tp is not None:
        headers[TRACEPARENT_HEADER] = tp
    return headers


def context_from_env(
    environ: Optional[Mapping[str, str]] = None,
) -> Optional[SpanContext]:
    """Parent context from the TRACEPARENT env var (spawned-job carrier)."""
    env = os.environ if environ is None else environ
    return parse_traceparent(env.get(TRACEPARENT_ENV))


def deterministic_traceparent(*parts: str) -> str:
    """A traceparent derived from stable identity strings (e.g. a CR's
    kind/namespace/name/uid). Same inputs -> same value, so stamping it
    into a pod template never reads as spec drift. The span id half names
    a span that no exporter will ever contain — trace_lint treats absent
    parents as remote, by design."""
    h = hashlib.sha256("/".join(parts).encode()).hexdigest()
    trace_id, span_id = h[:32], h[32:48]
    # The spec forbids all-zero ids; a sha256 prefix of zeros is
    # astronomically unlikely but cheap to guard.
    if trace_id == "0" * 32:
        trace_id = "1" + trace_id[1:]
    if span_id == "0" * 16:
        span_id = "1" + span_id[1:]
    return f"00-{trace_id}-{span_id}-01"
