"""The one HTTP-response counter both serving tiers share (the port's own
copy of substratus_tpu/observability/httpstats.py).

`substratus_http_requests_total{endpoint,code}` is stamped on every
response the model server AND the gateway send — the denominator that
makes shed rate (429/503/504 over total) a one-query dashboard across
tiers (docs/observability.md "Gateway"). Lives here, not in either
tier, so the family is described exactly once and the endpoint
normalization can't drift between them.
"""
from __future__ import annotations

from substratus_tpu_torch.observability.metrics import METRICS

METRICS.describe(
    "substratus_http_requests_total",
    "HTTP responses sent, by endpoint and status code.", type="counter",
)

# Endpoints worth per-path cardinality; everything else (scanner 404s,
# typos) folds into "other" so it can't mint unbounded series.
KNOWN_ENDPOINTS = frozenset((
    "/", "/metrics", "/loadz", "/healthz",
    "/v1/completions", "/v1/chat/completions", "/v1/models",
    "/debug/profile", "/debug/tracez", "/debug/requestz",
    "/debug/perfz", "/debug/eventz",
))


def endpoint_label(path: str) -> str:
    return path if path in KNOWN_ENDPOINTS else "other"


def count_http_response(path: str, status: int) -> None:
    METRICS.inc(
        "substratus_http_requests_total",
        {"endpoint": endpoint_label(path), "code": str(status)},
    )
