"""Request deadlines (the port's own copy of parse_deadline and
deadline_remaining of substratus_tpu/gateway/limiter.py; the token
buckets there are the gateway's, not a replica's).

Deadlines ride the `x-request-deadline` header as ABSOLUTE unix epoch
seconds (float). Absolute beats relative across hops: a relative
timeout would need re-decrementing at every tier and silently resets on
retries, while an absolute deadline shrinks monotonically no matter how
many replicas a hedged request visits. Clients that prefer relative
send `x-request-timeout: <seconds>`, converted once where it is read.
"""
from __future__ import annotations

import time
from typing import Optional

DEADLINE_HEADER = "x-request-deadline"
TIMEOUT_HEADER = "x-request-timeout"


def parse_deadline(headers, default_timeout: float = 0.0) -> Optional[float]:
    """Absolute unix-seconds deadline for a request, or None.

    Precedence: explicit x-request-deadline, then x-request-timeout
    (relative, converted here), then the configured default timeout
    (0 = no deadline)."""
    raw = headers.get(DEADLINE_HEADER)
    if raw:
        try:
            return float(raw)
        except ValueError:
            pass  # malformed header: fall through, don't reject
    raw = headers.get(TIMEOUT_HEADER)
    if raw:
        try:
            return time.time() + max(0.0, float(raw))
        except ValueError:
            pass
    if default_timeout > 0:
        return time.time() + default_timeout
    return None


def deadline_remaining(deadline: Optional[float]) -> Optional[float]:
    """Seconds left (may be <= 0: already expired); None = no deadline."""
    if deadline is None:
        return None
    return deadline - time.time()
