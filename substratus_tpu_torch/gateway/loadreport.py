"""Load-report protocol between engine replicas and the gateway (the port's
own copy of substratus_tpu/gateway/loadreport.py: a port replica's header
reads back through the JAX gateway's parser, and the other way round).

A replica's load is four cheap host-side numbers the engine already
tracks (no device read, no lock): waiting-queue depth, occupied decode
slots, the slot ceiling, and the free fraction of the KV pool. The
server exposes the snapshot two ways:

  * `GET /loadz` — pull: the gateway's poller and k8s-style readiness
    checks (a draining server answers 503, which is how the gateway
    learns a replica is leaving BEFORE its streams finish);
  * `x-substratus-load` response header — push: stamped on every
    completion response, so a gateway routing live traffic learns each
    replica's load passively at the rate it talks to it, with zero
    extra round trips.

The header value is a comma-joined `k=v` list (`q=3 a=2 m=8 kvf=0.75`
shaped), chosen over JSON so it never needs quoting inside an HTTP
header and stays greppable in access logs.

Wire-contract note: every key `to_header` emits must be parsed by
`from_header` and the other way round, here and in the JAX package's
copy alike (tests/test_torch_surface.py reads each package's header
through the other's parser).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Tuple

HEADER = "x-substratus-load"

# Resident-adapter ids on the header are capped: affinity only needs
# "is my adapter here", and an unbounded tenant list would bloat every
# response by the whole roster.
MAX_HEADER_ADAPTERS = 8


@dataclass
class LoadReport:
    """One replica's load snapshot, as routed on."""

    queue_depth: int = 0  # requests waiting for a decode slot
    active_slots: int = 0  # slots currently generating
    max_slots: int = 1  # configured decode slot ceiling (max_batch)
    kv_free_frac: float = 1.0  # free fraction of the KV pool [0, 1]
    # Resident LoRA adapter ids (serve/adapters.py) — the gateway's
    # adapter-affinity scoring prefers replicas that already hold a
    # request's adapter (balancer.py).
    adapters: Tuple[str, ...] = ()
    # Disaggregated serving (serve/disagg.py): which phase this replica
    # runs ("both" = monolithic, "prefill", "decode") and its transfer
    # backlog (handoffs waiting to ship / migrations waiting to board).
    # Admissions route to the prefill pool; decode replicas never take
    # client completions directly (balancer.pick(role=...)).
    role: str = "both"
    transfer_queue: int = 0
    # Ordering (gateway/fleet.py): a per-replica monotonic report
    # sequence number (`sq=`) and the replica's wall clock at snapshot
    # time (`ts=`). A hedged or retried response can deliver an OLD
    # report after a newer one — the fleet aggregator drops those by
    # seq, and grossly stale retransmits by wall clock. -1 / 0.0 =
    # legacy report (always accepted; pre-telemetry replicas keep
    # working byte-identically).
    seq: int = -1
    wall_ts: float = 0.0
    # Hot weight-swap generation (`wv=`, serve/engine.py swap_params):
    # lets the gateway/rollout tooling see which checkpoint generation
    # each replica serves without an extra poll. 0 = boot weights /
    # pre-swap replica.
    weights_version: int = 0
    # Stamped by the RECEIVER (gateway clock): reports age out rather
    # than mislead — a 30 s old "idle" beats routing storms.
    ts: float = field(default_factory=time.monotonic)

    def score(self) -> float:
        """Routing score: lower = less loaded. Queue depth dominates
        (each queued request is a whole forthcoming batch residency),
        slot occupancy breaks ties, KV pressure nudges away from
        replicas about to preempt."""
        occupancy = self.active_slots / max(1, self.max_slots)
        kv_pressure = 1.0 - self.kv_free_frac
        # Transfer backlog counts like queued work at half weight: a
        # handoff waiting to ship blocks a client stream, but drains
        # faster than a whole batch residency.
        return (
            2.0 * self.queue_depth + occupancy + 0.5 * kv_pressure
            + 0.5 * self.transfer_queue
        )

    def to_header(self) -> str:
        out = (
            f"q={self.queue_depth} a={self.active_slots} "
            f"m={self.max_slots} kvf={self.kv_free_frac:.3f}"
        )
        if self.seq >= 0:
            out += f" sq={self.seq}"
        if self.wall_ts > 0.0:
            out += f" ts={self.wall_ts:.3f}"
        if self.role != "both":
            # One char on the wire; absent = "both" (monolithic replicas
            # and pre-disaggregation gateways stay byte-identical).
            out += f" r={self.role[0]}"
        if self.transfer_queue:
            out += f" tq={self.transfer_queue}"
        if self.weights_version:
            # Absent = 0 (boot weights): pre-swap replicas and gateways
            # stay byte-identical.
            out += f" wv={self.weights_version}"
        if self.adapters:
            # `;`-joined: header values stay comma/space-free so the
            # k=v split survives; ids with either separator are dropped
            # rather than corrupting the whole report.
            ids = [
                a for a in self.adapters[:MAX_HEADER_ADAPTERS]
                if a and not set(a) & {" ", ",", ";", "="}
            ]
            if ids:
                out += f" ad={';'.join(ids)}"
        return out

    @classmethod
    def from_header(cls, value: str) -> "LoadReport":
        """Parse a header value; unknown keys ignored, malformed fields
        fall back to the defaults (a half-parsed report still beats no
        report)."""
        kv = {}
        adapters: Tuple[str, ...] = ()
        role = "both"
        for part in value.replace(",", " ").split():
            if "=" not in part:
                continue
            k, _, v = part.partition("=")
            if k == "ad":
                adapters = tuple(a for a in v.split(";") if a)
                continue
            if k == "r":
                role = {"p": "prefill", "d": "decode"}.get(v, "both")
                continue
            try:
                kv[k] = float(v)
            except ValueError:
                continue
        return cls(
            queue_depth=int(kv.get("q", 0)),
            active_slots=int(kv.get("a", 0)),
            max_slots=max(1, int(kv.get("m", 1))),
            kv_free_frac=min(1.0, max(0.0, kv.get("kvf", 1.0))),
            adapters=adapters,
            role=role,
            transfer_queue=max(0, int(kv.get("tq", 0))),
            seq=int(kv.get("sq", -1)),
            wall_ts=max(0.0, kv.get("ts", 0.0)),
            weights_version=max(0, int(kv.get("wv", 0))),
        )

    @classmethod
    def from_snapshot(cls, snap: dict) -> "LoadReport":
        """From the engine's load_snapshot() dict (the /loadz body)."""
        return cls(
            queue_depth=int(snap.get("queue_depth", 0)),
            active_slots=int(snap.get("active_slots", 0)),
            max_slots=max(1, int(snap.get("max_slots", 1))),
            kv_free_frac=min(
                1.0, max(0.0, float(snap.get("kv_free_frac", 1.0)))
            ),
            adapters=tuple(
                str(a) for a in (snap.get("adapters") or ())
            ),
            role=str(snap.get("role", "both") or "both"),
            transfer_queue=max(0, int(snap.get("transfer_queue_depth", 0))),
            seq=int(snap.get("load_seq", -1)),
            wall_ts=max(0.0, float(snap.get("load_ts", 0.0))),
            weights_version=max(0, int(snap.get("weights_version", 0))),
        )
