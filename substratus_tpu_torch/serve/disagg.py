"""Disaggregated prefill/decode serving: the KV-page handoff between two
engines (the port's own copy of substratus_tpu/serve/disagg.py, speaking
its wire protocol byte for byte, so a JAX tier and a port tier interoperate).

A monolithic engine runs prefill and decode in one lockstep batch, so a
burst of long prompts stalls every decoding slot for the length of its
chunked prefill. This module splits a request's lifecycle across two
engines:

  * a **prefill** engine (``EngineConfig.role="prefill"``) runs the prompt's
    chunks into its paged pool, samples the first token, reads the
    request's KV pages to the host once and ships pages + first token +
    sampling state to a decode engine (HandoffManager);
  * a **decode** engine (``role="decode"``) copies the pages into pages of
    its own pool (no recompute) and decodes on; every generated token
    streams back over the same connection, so the prefill side's
    ``Request.out`` behaves as a local engine's and the HTTP server above
    it is unchanged (HandoffServer).

Transport: plain TCP. A frame is ``u32 header_len | header JSON | u32
payload_len | payload``, little-endian; the payload is the pages' raw bytes
in the manifest's order (arrays sorted by name). One connection per
(prefill, decode) pair, multiplexed by request id. A bf16 array travels
under JAX's ml_dtypes name ``"bfloat16"`` as raw 2-byte words.

Negotiation: a connection opens with a ``hello`` exchange of PoolSpecs. The
structure (layers, page size, kv heads, head dim) must match; the KV dtype
may differ and the RECEIVER converts on import (model-dtype pages quantize
into an int8 pool, int8 pages dequantize into a model-dtype pool).

Scheduling: the decode tier pipelines. A migration's pages are copied to
the card on a side stream by the connection's thread (which alone waits
for that copy), and the scheduler thread scatters them into the pool on
its own stream, behind any step in flight. The prefill tier never decodes,
so its overlap resolves off; its export still runs behind a
``_flush("handoff")`` guard.

Failure semantics, as in the JAX module:

  * a truncated or garbled frame kills only its connection: a partly read
    handoff is discarded, nothing is submitted;
  * a dead decode worker never hangs a client: every request in flight on
    the lost connection is requeued on the prefill engine with prompt :=
    prompt + tokens already streamed, so it resumes token for token
    through another worker, or ends with an error when none is left;
  * the transfer queue is bounded: a prefill engine that outruns its
    decode tier blocks at ship() for ship_timeout, then fails the request.

A frame of 2^31 bytes or more is a protocol violation to the receiver
(MAX_FRAME, JAX's limit). The JAX sender ships it anyway and the receiver's
reset fails the request; this sender fails such a request before sending.
"""
from __future__ import annotations

import json
import logging
import math
import queue
import socket
import struct
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from substratus_tpu_torch.observability.journey import RequestJourney
from substratus_tpu_torch.observability.metrics import METRICS
from substratus_tpu_torch.observability.propagation import format_traceparent, parse_traceparent
from substratus_tpu_torch.observability.tracing import SpanContext

log = logging.getLogger("substratus.serve.disagg")

METRICS.histogram(
    "substratus_serve_kv_transfer_seconds",
    "Wall time of one KV-page handoff send (serialize + socket write), "
    "prefill side of disaggregated serving (serve/disagg.py).",
)
METRICS.describe(
    "substratus_serve_kv_transfer_queue_depth",
    "Handoffs waiting in the prefill engine's bounded transfer queue.",
    type="gauge",
)
METRICS.describe(
    "substratus_serve_kv_transfers_total",
    "KV-page handoffs completed, by outcome (sent, requeued, failed).",
    type="counter",
)

DEFAULT_TRANSFER_PORT = 8500

# The wire's dtype names (numpy's, and ml_dtypes' "bfloat16", as the JAX
# package writes them) and the torch dtypes they carry.
_WIRE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16, "int8": torch.int8}
_WIRE_NAMES = {v: k for k, v in _WIRE_DTYPES.items()}


def wire_dtype_name(dtype: torch.dtype) -> str:
    """The wire's name of a torch dtype (ValueError for one it cannot carry)."""
    try:
        return _WIRE_NAMES[dtype]
    except KeyError:
        raise ValueError(f"no wire name for {dtype}") from None


class NegotiationError(ValueError):
    """The two pools cannot exchange pages (structural mismatch)."""


@dataclass(frozen=True)
class PoolSpec:
    """The shape contract of one engine's paged KV pool: everything the
    peer needs to validate (and convert) incoming pages."""

    n_layers: int
    page_size: int
    kv_heads: int
    head_dim: int
    dtype: str  # the wire name of the pool's k/v dtype
    quantized: bool  # int8 pool with per-vector f32 scales

    @classmethod
    def from_engine(cls, engine) -> "PoolSpec":
        if not getattr(engine, "paged", False):
            raise ValueError("disaggregated serving requires the paged layout")
        k = engine.cache["k"]
        L, _, bs, kh, hd = k.shape
        return cls(n_layers=int(L), page_size=int(bs), kv_heads=int(kh), head_dim=int(hd),
                   dtype=wire_dtype_name(k.dtype), quantized="k_scale" in engine.cache)

    @classmethod
    def from_engine_config(cls, cfg, ec) -> "PoolSpec":
        """The spec an Engine(cfg, ec) paged pool will have, before the
        engine exists: the HandoffManager is built first and handed to the
        Engine's constructor."""
        quantized = ec.kv_cache_dtype == "int8"
        return cls(n_layers=int(cfg.n_layers), page_size=int(ec.page_size), kv_heads=int(cfg.n_kv_heads),
                   head_dim=int(cfg.head_size), dtype="int8" if quantized else wire_dtype_name(cfg.dtype),
                   quantized=quantized)

    def to_dict(self) -> Dict[str, Any]:
        return {"n_layers": self.n_layers, "page_size": self.page_size, "kv_heads": self.kv_heads,
                "head_dim": self.head_dim, "dtype": self.dtype, "quantized": self.quantized}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PoolSpec":
        return cls(n_layers=int(d["n_layers"]), page_size=int(d["page_size"]), kv_heads=int(d["kv_heads"]),
                   head_dim=int(d["head_dim"]), dtype=str(d["dtype"]), quantized=bool(d["quantized"]))

    def convert_mode(self, src: "PoolSpec") -> str:
        """How this (receiving) pool installs pages exported from `src`:
        'none' (same quantization; a plain cast covers bf16<->f32),
        'quantize' (model-dtype pages into an int8 pool) or 'dequantize'
        (int8 pages into a model-dtype pool). A structural mismatch is a
        NegotiationError: such pages can never be reinterpreted."""
        for f in ("n_layers", "page_size", "kv_heads", "head_dim"):
            if getattr(self, f) != getattr(src, f):
                raise NegotiationError(f"pool {f} mismatch: sender={getattr(src, f)} receiver={getattr(self, f)}")
        if src.quantized == self.quantized:
            return "none"
        return "quantize" if self.quantized else "dequantize"


# --- framing ----------------------------------------------------------------

_U32 = struct.Struct("<I")

# A frame this large is a protocol violation (or an attack), not a handoff.
# At llama2-7b's pool (32 kv heads, head dim 128) bf16 pages cost 524,288
# bytes a token, so pages covering 4096 tokens reach it (ROADMAP Queue 3).
MAX_FRAME = 1 << 31


def send_frame(sock, header: Dict[str, Any], payload=b"") -> None:
    """One frame on the wire. Callers hold the channel's send lock: two
    writers interleaving would corrupt the stream. A large payload goes out
    from its own buffer, uncopied."""
    hdr = json.dumps(header, separators=(",", ":")).encode()
    head = _U32.pack(len(hdr)) + hdr + _U32.pack(len(payload))
    if len(payload) < 1 << 16:
        sock.sendall(head + bytes(payload))
    else:
        sock.sendall(head)
        sock.sendall(payload)


def recv_exact(sock, n: int) -> bytearray:
    """Exactly n bytes, into one buffer; ConnectionError on EOF."""
    buf = bytearray(n)
    view, got = memoryview(buf), 0
    while got < n:
        k = sock.recv_into(view[got:], min(n - got, 1 << 20))
        if not k:
            raise ConnectionError("peer closed the transfer stream")
        got += k
    return buf


def recv_frame(sock) -> Tuple[Dict[str, Any], bytearray]:
    """One frame off the wire; ConnectionError on EOF or truncation and
    ValueError on garbage (both kill the connection, never the process: a
    truncated handoff is discarded, never half applied)."""
    hlen = _U32.unpack(recv_exact(sock, 4))[0]
    if not 0 < hlen < MAX_FRAME:
        raise ValueError(f"bad header length {hlen}")
    header = json.loads(recv_exact(sock, hlen).decode())
    plen = _U32.unpack(recv_exact(sock, 4))[0]
    if plen >= MAX_FRAME:
        raise ValueError(f"bad payload length {plen}")
    payload = recv_exact(sock, plen) if plen else bytearray()
    return header, payload


def encode_pages(pages: Dict[str, torch.Tensor]) -> Tuple[List[dict], bytes]:
    """{name: host tensor} -> (the header's array manifest, payload bytes),
    arrays in name order, as the JAX module encodes numpy arrays."""
    manifest, parts = [], []
    for name in sorted(pages):
        t = pages[name].contiguous()
        manifest.append({"n": name, "s": list(t.shape), "d": wire_dtype_name(t.dtype)})
        parts.append(memoryview(t.reshape(-1).view(torch.uint8).numpy()))
    return manifest, b"".join(parts)


def decode_pages(manifest: List[dict], payload, pin: bool = False) -> Dict[str, torch.Tensor]:
    """Inverse of encode_pages: each array copied once out of the payload
    into a tensor of its own (pinned with `pin`, for a copy to the card).
    ValueError when the payload's length disagrees with the manifest (a
    truncated or corrupted frame) or a dtype has no wire name."""
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for m in manifest:
        name = str(m["d"])
        if name not in _WIRE_DTYPES:
            raise ValueError(f"unknown page dtype {name!r}")
        shape = tuple(int(x) for x in m["s"])
        if any(d < 0 for d in shape):
            raise ValueError(f"bad page shape {shape}")
        dtype = _WIRE_DTYPES[name]
        nbytes = math.prod(shape) * dtype.itemsize
        if off + nbytes > len(payload):  # checked before anything is allocated
            raise ValueError("page payload shorter than its manifest")
        t = torch.empty(shape, dtype=dtype, pin_memory=pin)
        t.reshape(-1).view(torch.uint8).numpy()[:] = np.frombuffer(payload, np.uint8, count=nbytes, offset=off)
        out[str(m["n"])] = t
        off += nbytes
    if off != len(payload):
        raise ValueError("page payload longer than its manifest")
    return out


# --- prefill side -----------------------------------------------------------


@dataclass
class _Flight:
    """One handed-off request the prefill side is relaying."""

    req: Any  # serve.engine.Request
    chan: "_Channel"  # the connection it went out on
    emitted: List[int] = field(default_factory=list)
    cancel_sent: bool = False
    done: bool = False


class _Channel:
    """One negotiated connection to a decode worker: a send lock for frame
    atomicity, read by one reader thread."""

    def __init__(self, peer: str, sock, remote_spec: PoolSpec):
        self.peer = peer
        self.sock = sock
        self.remote_spec = remote_spec
        self.send_lock = threading.Lock()
        self.dead = False

    def send(self, header: Dict[str, Any], payload=b"") -> None:
        with self.send_lock:
            send_frame(self.sock, header, payload)

    def close(self) -> None:
        self.dead = True
        # shutdown() before close(): a bare close() of a socket another
        # thread is blocked in recv() on neither wakes that thread nor
        # sends FIN, and the peer would never see the loss.
        _shut(self.sock)


def _shut(sock) -> None:
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class HandoffManager:
    """Prefill-side coordinator: the connections to the decode tier, the
    bounded transfer queue, and the token relay back into each request's
    `out` queue. The engine's scheduler thread calls ship(); a sender
    thread serializes and writes; a reader thread a connection delivers
    tokens. `_lock` guards what they share."""

    def __init__(self, peers: List[str], spec: PoolSpec, max_queue: int = 8, connect_timeout: float = 10.0,
                 ship_timeout: float = 30.0, io_timeout: float = 600.0):
        if not peers:
            raise ValueError("disaggregated prefill needs >=1 decode peer")
        self.peers = [p.strip() for p in peers if p.strip()]
        self.spec = spec
        self.connect_timeout = connect_timeout
        self.ship_timeout = ship_timeout
        self.io_timeout = io_timeout
        self._queue: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._lock = threading.Lock()
        self._channels: Dict[str, _Channel] = {}
        self._flights: Dict[str, _Flight] = {}
        self._rr = 0  # round-robin cursor over peers
        # A headless Service name expands to one address a decode pod,
        # resolved again at most every 5 s, so scaling needs no restart.
        self._peer_cache: Tuple[float, List[str]] = (0.0, [])
        self._stop = threading.Event()
        self.engine = None  # bound by bind_engine(): where requeues go
        self._sender = threading.Thread(target=self._send_loop, name="kv-handoff-sender", daemon=True)
        self._sender.start()

    # -- engine-facing surface ------------------------------------------------

    def bind_engine(self, engine) -> None:
        """The engine requeued requests board again (Engine.resubmit)."""
        self.engine = engine

    def depth(self) -> int:
        return self._queue.qsize()

    def ship(self, req, pages: Dict[str, torch.Tensor], true_len: int, first_token: int) -> None:
        """Enqueue one handoff (scheduler thread). Blocks up to
        ship_timeout while the transfer queue is full (backpressure toward
        admission), then fails the request instead of queueing without
        bound."""
        if not req.id:
            # The flights and the wire key on the request id; engine-level
            # callers often leave it empty: mint one rather than collide.
            req.id = uuid.uuid4().hex
        try:
            self._queue.put((req, pages, true_len, first_token), timeout=self.ship_timeout)
        except queue.Full:
            log.warning("transfer queue full for %.0fs; failing request %s", self.ship_timeout, req.id)
            METRICS.inc("substratus_serve_kv_transfers_total", {"outcome": "failed"})
            self._fail(req)
            return
        METRICS.set("substratus_serve_kv_transfer_queue_depth", self._queue.qsize())

    def close(self) -> None:
        self._stop.set()
        with self._lock:
            chans = list(self._channels.values())
            self._channels.clear()
        for ch in chans:
            ch.close()
        self._sender.join(timeout=5)

    # -- sending ----------------------------------------------------------------

    def _send_loop(self) -> None:
        while not self._stop.is_set():
            try:
                item = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            METRICS.set("substratus_serve_kv_transfer_queue_depth", self._queue.qsize())
            t0 = time.perf_counter()
            if self._send_one(*item):
                METRICS.observe("substratus_serve_kv_transfer_seconds", time.perf_counter() - t0)
                METRICS.inc("substratus_serve_kv_transfers_total", {"outcome": "sent"})

    def _send_one(self, req, pages, true_len, first_token) -> bool:
        """Try every peer once; when none takes it the request fails (a
        client must never wait on a handoff nobody will decode)."""
        manifest, payload = encode_pages(pages)
        if len(payload) >= MAX_FRAME:
            log.error("handoff of request %s is %d bytes, past the receiver's frame limit", req.id, len(payload))
            METRICS.inc("substratus_serve_kv_transfers_total", {"outcome": "failed"})
            self._fail(req)
            return False
        # The W3C trace context rides the handoff, so the decode tier
        # parents its spans and journey under the same trace id. "tpar":
        # "tp" already carries top_p.
        tpar = None
        if req.trace_ctx is not None:
            tpar = format_traceparent(req.trace_ctx)
        elif getattr(req, "journey", None) is not None and req.journey.trace_id:
            tpar = format_traceparent(SpanContext(req.journey.trace_id, uuid.uuid4().hex[:16]))
        header = {"t": "kv", "rid": req.id, "p": list(req.prompt_tokens), "tl": true_len, "first": first_token,
                  "m": req.max_tokens, "temp": req.temperature, "tp": req.top_p, "eos": req.eos_token_id,
                  "ad": req.adapter, "tpar": tpar, "arrays": manifest}
        peers = self._resolved_peers()
        n = len(peers)
        for i in range(n):
            peer = peers[(self._rr + i) % n]
            ch = self._channel(peer)
            if ch is None:
                continue
            with self._lock:
                self._flights[req.id] = _Flight(req=req, chan=ch)
            try:
                ch.send(header, payload)
            except (OSError, ValueError) as e:
                log.warning("handoff send to %s failed: %r", peer, e)
                with self._lock:
                    mine = self._flights.pop(req.id, None) is not None
                self._drop_channel(ch, requeue=True)
                if not mine:
                    return False  # the channel's reader saw the loss first and requeued it
                continue
            self._rr = (self._rr + i + 1) % n
            return True
        log.error("no decode worker reachable; failing request %s", req.id)
        METRICS.inc("substratus_serve_kv_transfers_total", {"outcome": "failed"})
        self._fail(req)
        return False

    def _resolved_peers(self) -> List[str]:
        """The configured peers with DNS names expanded to every address
        (sender thread only; cached for 5 s)."""
        ts, cached = self._peer_cache
        now = time.monotonic()
        if cached and now - ts < 5.0:
            return cached
        out: List[str] = []
        for p in self.peers:
            host, _, port = p.rpartition(":")
            try:
                infos = socket.getaddrinfo(host or "127.0.0.1", int(port), type=socket.SOCK_STREAM)
            except OSError:
                continue
            out.extend(f"{a}:{port}" for a in sorted({i[4][0] for i in infos}))
        out = out or list(self.peers)
        self._peer_cache = (now, out)
        return out

    def _channel(self, peer: str) -> Optional[_Channel]:
        with self._lock:
            ch = self._channels.get(peer)
        if ch is not None and not ch.dead:
            return ch
        host, _, port = peer.rpartition(":")
        sock = None
        try:
            sock = socket.create_connection((host or "127.0.0.1", int(port)), timeout=self.connect_timeout)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(self.io_timeout)
            send_frame(sock, {"t": "hello", "spec": self.spec.to_dict()})
            reply, _ = recv_frame(sock)
            if reply.get("t") == "reject":
                raise NegotiationError(str(reply.get("reason")))
            if reply.get("t") != "hello":
                raise ValueError(f"unexpected reply {reply.get('t')!r}")
            remote = PoolSpec.from_dict(reply["spec"])
            # Both sides validate: a structural mismatch fails the
            # CONNECTION, loudly, at negotiation, never a request.
            remote.convert_mode(self.spec)
        except (OSError, ValueError, KeyError) as e:
            log.warning("decode peer %s unavailable: %r", peer, e)
            if sock is not None:
                _shut(sock)
            return None
        ch = _Channel(peer, sock, remote)
        with self._lock:
            old = self._channels.get(peer)
            self._channels[peer] = ch
        if old is not None:
            old.close()
        threading.Thread(target=self._read_loop, args=(ch,), name="kv-handoff-reader", daemon=True).start()
        return ch

    # -- the token back-channel -------------------------------------------------

    def _read_loop(self, ch: _Channel) -> None:
        try:
            while not ch.dead:
                header, _ = recv_frame(ch.sock)
                kind = header.get("t")
                if kind == "tok":
                    self._on_token(ch, str(header["rid"]), int(header["k"]))
                elif kind == "done":
                    self._on_done(str(header["rid"]), str(header.get("fr", "stop")), header.get("j"))
        except (OSError, ValueError, KeyError) as e:
            if not ch.dead and not self._stop.is_set():
                log.warning("decode peer %s lost: %r", ch.peer, e)
        self._drop_channel(ch, requeue=True)

    def _on_token(self, ch: _Channel, rid: str, tok: int) -> None:
        with self._lock:
            flight = self._flights.get(rid)
        if flight is None:
            return
        req = flight.req
        now = time.perf_counter()
        if req.last_emit_ts:
            METRICS.observe("substratus_serve_inter_token_seconds", now - req.last_emit_ts)
        elif req.submit_ts:
            METRICS.observe("substratus_serve_ttft_seconds", now - req.submit_ts)
        req.last_emit_ts = now
        flight.emitted.append(tok)
        req.out.put(tok)
        if req.cancelled and not flight.cancel_sent:
            flight.cancel_sent = True
            try:
                ch.send({"t": "cancel", "rid": rid})
            except OSError:
                pass  # the reader will see the dead channel

    def _on_done(self, rid: str, finish_reason: str, segment: Optional[dict] = None) -> None:
        with self._lock:
            flight = self._flights.pop(rid, None)
        if flight is None:
            return
        flight.done = True
        req = flight.req
        req.finish_reason = finish_reason
        # The decode tier's journey segment (the done frame's "j") is
        # stitched in BEFORE the terminal marker: the merged journey, one
        # trace id over both processes, is what the journey log keeps.
        j = getattr(req, "journey", None)
        if j is not None and segment:
            j.stitch(segment)
        if self.engine is not None:
            self.engine._journey_end(req, finish_reason)
        elif j is not None and not j.ended:
            j.record("end", reason=finish_reason)
        req.out.put(None)

    # -- failure handling ---------------------------------------------------------

    def _drop_channel(self, ch: _Channel, requeue: bool) -> None:
        """Close a lost channel and requeue its unfinished flights (a newer
        channel to the same peer, and its flights, stay)."""
        with self._lock:
            if self._channels.get(ch.peer) is ch:
                del self._channels[ch.peer]
            orphans = [f for f in self._flights.values() if f.chan is ch and not f.done]
            for f in orphans:
                self._flights.pop(f.req.id, None)
        ch.close()
        if requeue:
            for f in orphans:
                self._requeue(f)

    def _requeue(self, flight: _Flight) -> None:
        """A request whose decode worker died resumes by a second prefill:
        its prompt grows by the tokens already streamed (the engine's
        preemption trick), so the client's stream continues through
        whichever worker takes the retry."""
        req = flight.req
        req.prompt_tokens = list(req.prompt_tokens) + flight.emitted
        req.max_tokens -= len(flight.emitted)
        if req.max_tokens <= 0 or req.cancelled:
            req.finish_reason = "stop" if req.cancelled else "length"
            j = getattr(req, "journey", None)
            if self.engine is not None:
                self.engine._journey_end(req, req.finish_reason, cause="requeue")
            elif j is not None and not j.ended:
                j.record("end", reason=req.finish_reason, cause="requeue")
            req.out.put(None)
            return
        if self.engine is None:
            self._fail(req)
            return
        METRICS.inc("substratus_serve_kv_transfers_total", {"outcome": "requeued"})
        # The SAME Request boards again: its trace context and journey ride
        # along, so the second prefill is visibly the same trace
        # (resubmit records the "requeue" journey event).
        log.info("requeueing request %s after decode-worker loss (trace_id=%s)", req.id,
                 getattr(req, "journey", None) and req.journey.trace_id)
        self.engine.resubmit(req)

    def _fail(self, req) -> None:
        """The terminal error marker, under the request's trace id in the
        log line and the journey."""
        req.finish_reason = "error"
        j = getattr(req, "journey", None)
        log.error("handoff failed for request %s (trace_id=%s)", req.id, j.trace_id if j is not None else None)
        if self.engine is not None:
            self.engine._journey_end(req, "error", cause="handoff")
        elif j is not None and not j.ended:
            j.record("end", reason="error", cause="handoff")
        req.out.put(None)


# --- decode side ------------------------------------------------------------


def stage_pages(pages: Dict[str, torch.Tensor], device: torch.device,
                stream: Optional["torch.cuda.Stream"]) -> Dict[str, torch.Tensor]:
    """Pages (pinned, on the card) on the decode engine's device: copied on
    `stream`, the calling thread waiting for that copy alone (the
    scheduler's stream, and the step on it, never wait). On the CPU, the
    pages themselves."""
    if stream is None:
        return pages
    with torch.cuda.stream(stream):
        staged = {k: v.to(device, non_blocking=True) for k, v in pages.items()}
    stream.synchronize()
    return staged


@dataclass
class Migration:
    """One migrated request, ready for the decode engine's admission: its
    KV pages already on the engine's device (staged by the connection's
    thread), no recompute needed."""

    req: Any  # serve.engine.Request (out = _RemoteSink)
    pages: Dict[str, torch.Tensor]  # each [L, n_pages, bs, KH, hd]-shaped (scales [..., 1])
    true_len: int
    first_token: int
    convert: str  # "none" | "quantize" | "dequantize"


class _RemoteSink:
    """The decode side's Request.out: frames every token back to the
    prefill worker. Sends run on the decode engine's scheduler thread; a
    dead peer marks the request cancelled, so its slot frees at the next
    emit instead of wedging the scheduler."""

    def __init__(self, channel: _Channel, rid: str):
        self.channel = channel
        self.rid = rid
        self.req = None  # set right after the Request is built

    def put(self, item) -> None:
        if self.channel.dead:
            if self.req is not None:
                self.req.cancelled = True
            return
        try:
            if item is None:
                fr = self.req.finish_reason if self.req is not None else "stop"
                # The decode side's journey segment rides the terminal
                # frame (the engine's _journey_end ran before this put, so
                # it holds its own "end"); the prefill side stitches it.
                j = getattr(self.req, "journey", None) if self.req is not None else None
                frame = {"t": "done", "rid": self.rid, "fr": fr}
                if j is not None:
                    frame["j"] = j.to_wire()
                self.channel.send(frame)
            else:
                self.channel.send({"t": "tok", "rid": self.rid, "k": int(item)})
        except OSError:
            self.channel.dead = True
            if self.req is not None:
                self.req.cancelled = True


class HandoffServer:
    """Decode-side listener: accepts prefill workers' connections,
    negotiates the pool layout, turns kv frames into engine migrations and
    relays cancellation. One accept thread and one reader thread a
    connection, all daemons; each connection's requests are confined to
    its reader thread (a cancel arrives on the connection that made the
    request). On the card each migration's pages are copied to the device
    on a side stream by its connection's thread, which waits for that copy
    alone."""

    def __init__(self, engine, host: str = "0.0.0.0", port: int = 0):
        from substratus_tpu_torch.serve.engine import Request  # engine.py imports nothing of this module

        self._Request = Request
        self.engine = engine
        self.spec = PoolSpec.from_engine(engine)
        self.device = engine.device
        self._copy_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(64)
        self.port = self._srv.getsockname()[1]
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._conns: List[Any] = []
        self._accept = threading.Thread(target=self._accept_loop, name="kv-handoff-accept", daemon=True)
        self._accept.start()

    def close(self) -> None:
        """Stop accepting AND sever live connections: prefill peers must
        see EOF (and requeue their flights) the moment this worker leaves,
        as a process death would read."""
        self._stop.set()
        _shut(self._srv)
        with self._lock:
            conns = list(self._conns)
            self._conns.clear()
        for c in conns:
            _shut(c)
        self._accept.join(timeout=5)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, addr = self._srv.accept()
            except OSError:
                return  # listener closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self._conns.append(conn)
            threading.Thread(target=self._serve_conn, args=(conn, addr), name="kv-handoff-conn",
                             daemon=True).start()

    def _serve_conn(self, conn, addr) -> None:
        peer = f"{addr[0]}:{addr[1]}"
        reqs: Dict[str, Any] = {}  # rid -> Request (this connection only)
        ch: Optional[_Channel] = None
        try:
            hello, _ = recv_frame(conn)
            if hello.get("t") != "hello":
                raise ValueError(f"expected hello, got {hello.get('t')!r}")
            src = PoolSpec.from_dict(hello["spec"])
            try:
                convert = self.spec.convert_mode(src)
            except NegotiationError as e:
                send_frame(conn, {"t": "reject", "reason": str(e)})
                return
            ch = _Channel(peer, conn, src)
            ch.send({"t": "hello", "spec": self.spec.to_dict()})
            while True:
                header, payload = recv_frame(conn)
                kind = header.get("t")
                if kind == "kv":
                    self._on_kv(ch, header, payload, convert, reqs)
                elif kind == "cancel":
                    req = reqs.get(str(header.get("rid")))
                    if req is not None:
                        req.cancelled = True
        except (OSError, ValueError, KeyError) as e:
            # A truncated stream or protocol garbage: this connection dies,
            # a partly read handoff is discarded unsubmitted.
            if not self._stop.is_set():
                log.warning("transfer connection %s closed: %r", peer, e)
        finally:
            if ch is not None:
                ch.dead = True
            # The scheduler thread may be inside a _RemoteSink send on
            # this socket: shutdown() unblocks it and sends FIN.
            _shut(conn)
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)
            # Requests this connection fed have nowhere to stream: cancel
            # them so the engine frees their slots. The prefill side
            # requeues its flights when it sees the same loss.
            for req in reqs.values():
                req.cancelled = True

    def _on_kv(self, ch: _Channel, header: Dict[str, Any], payload, convert: str, reqs: Dict[str, Any]) -> None:
        t0 = time.perf_counter()
        pages = stage_pages(decode_pages(header["arrays"], payload, pin=self._copy_stream is not None), self.device,
                            self._copy_stream)
        stage_us = int((time.perf_counter() - t0) * 1e6)
        rid = str(header["rid"])
        sink = _RemoteSink(ch, rid)
        # This tier's spans and journey go under the prefill side's trace
        # context ("tpar"): the decode half keeps the SAME trace id, so the
        # prefill side can stitch the returned segment into one journey.
        tctx = parse_traceparent(header.get("tpar") or "")
        journey = RequestJourney(trace_id=tctx.trace_id if tctx is not None else None, rid=rid, origin="decode",
                                 cap=self.engine.ec.journey_events)
        # stage_us: the payload into pinned memory and onto the card.
        journey.record("kv_recv", bytes=len(payload), prompt_tokens=len(header["p"]), stage_us=stage_us)
        req = self._Request(
            prompt_tokens=[int(x) for x in header["p"]],
            max_tokens=int(header["m"]),
            temperature=float(header["temp"]),
            top_p=float(header["tp"]),
            eos_token_id=None if header.get("eos") is None else int(header["eos"]),
            adapter=header.get("ad"),
            id=rid,
            out=sink,
            trace_ctx=tctx,
            journey=journey,
        )
        sink.req = req
        reqs[rid] = req
        self.engine.submit_migration(Migration(req=req, pages=pages, true_len=int(header["tl"]),
                                               first_token=int(header["first"]), convert=convert))
