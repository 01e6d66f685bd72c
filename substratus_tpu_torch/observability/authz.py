"""RBAC authorization for the serving plane's /debug pages and /swapz (the
port's own copy of substratus_tpu/observability/authz.py).

The reference protects metrics with a kube-rbac-proxy sidecar; here the
check is in-process: the bearer token is authenticated with a TokenReview
and the request authorized with a SubjectAccessReview against the
`/metrics` non-resource URL, the same two API calls kube-rbac-proxy makes.

The port keeps no Kubernetes client (the operator is not ported), so the
client is injected: any object with ``create(manifest: dict) -> dict``
that raises ``KubeError`` when the apiserver call fails. serve.main passes
no authorizer, as the JAX entry point passes none, so /debug and /swapz
are open there; ``ServerState(authorizer=...)`` gates them.
"""
from __future__ import annotations

import threading
import time
from typing import Optional, Protocol, Tuple

# Cache decisions briefly (kube-rbac-proxy does the same): Prometheus
# scrapes every few seconds with the same token, and each miss costs two
# apiserver round trips.
CACHE_TTL_S = 60.0
CACHE_MAX_TOKENS = 1024


class KubeError(Exception):
    """An apiserver call failed (the injected client's error)."""


class ReviewClient(Protocol):
    def create(self, manifest: dict) -> dict: ...


class MetricsAuthorizer:
    """allow(header) -> (http_status, reason); 200 means serve the page."""

    def __init__(self, kube: ReviewClient, ttl_s: float = CACHE_TTL_S):
        self.kube = kube
        self.ttl_s = ttl_s
        self._lock = threading.Lock()
        self._cache: dict[str, Tuple[float, int, str]] = {}

    def allow(self, authorization: Optional[str]) -> Tuple[int, str]:
        if not authorization or not authorization.startswith("Bearer "):
            return 401, "missing bearer token"
        token = authorization[len("Bearer "):].strip()
        if not token:
            return 401, "empty bearer token"
        now = time.monotonic()
        with self._lock:
            hit = self._cache.get(token)
            if hit and now - hit[0] < self.ttl_s:
                return hit[1], hit[2]
        status, reason = self._check(token)
        if status < 500:  # never cache apiserver hiccups as verdicts
            with self._lock:
                self._cache[token] = (now, status, reason)
                if len(self._cache) > CACHE_MAX_TOKENS:  # bound memory under token churn
                    self._cache.pop(next(iter(self._cache)))
        return status, reason

    def _check(self, token: str) -> Tuple[int, str]:
        try:
            tr = self.kube.create({
                "apiVersion": "authentication.k8s.io/v1",
                "kind": "TokenReview",
                "spec": {"token": token},
            })
        except KubeError as e:
            return 500, f"tokenreview failed: {e}"
        tstatus = tr.get("status", {})
        if not tstatus.get("authenticated"):
            return 401, "token not authenticated"
        user = tstatus.get("user", {})
        try:
            sar = self.kube.create({
                "apiVersion": "authorization.k8s.io/v1",
                "kind": "SubjectAccessReview",
                "spec": {
                    "user": user.get("username", ""),
                    "groups": user.get("groups", []),
                    "nonResourceAttributes": {"path": "/metrics", "verb": "get"},
                },
            })
        except KubeError as e:
            return 500, f"subjectaccessreview failed: {e}"
        if not sar.get("status", {}).get("allowed"):
            return 403, f"user {user.get('username', '?')} not allowed"
        return 200, "ok"
