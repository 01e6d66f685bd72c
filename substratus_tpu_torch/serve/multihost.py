"""Multi-process serving lockstep (port of substratus_tpu/serve/multihost.py).

A gang runs one engine process per rank, each holding its tensor shard of
the model, and every forward issues collectives every rank must join in
the same order. Only rank 0 (the leader) has the HTTP server and so knows
which requests exist. The scheduler is therefore replicated:

  * the leader owns HTTP and the request queue. At the top of every
    scheduler iteration it serializes the iteration's events (new requests
    with every field admission reads, cancellation latches, stop, the swap
    barrier) and broadcasts them to every rank;
  * every rank, the leader included, applies them to an identical local
    scheduler state and runs the same iteration. Every scheduling decision
    is a function of the event stream and of values every rank holds alike
    (the logits are gathered to the full vocab on every rank, and every
    rank samples with an identically seeded generator), so the ranks
    cannot diverge;
  * followers attach a null token sink where the leader has the HTTP
    response queue: they compute everything and deliver nothing.

``StepSync`` broadcasts over the gang's gloo control group
(parallel/distributed.py), apart from the model's collectives: one
fixed-size broadcast of a uint8 CPU tensor an iteration, its length in the
first four bytes, little-endian, and a second, bucket-padded broadcast
only when the payload overflows it. ``TcpSync`` does the same over plain
TCP (the leader fans each length-prefixed message out to every follower),
a drop-in for the JAX package's TcpSync: the two speak the same bytes.
``encode_events`` gives the JAX package's JSON byte for byte. ``agree``
(the port's own, an all-reduce on StepSync's gloo group) gives the
(min, max) of one int over the ranks: the engine's check that every rank
admitted an adapter request alike.

Gangs run the synchronous scheduler, a flush per step (the engine's
``_sync_iterate``): the broadcast encodes decisions every rank applies to
a settled batch, and the leader must emit step N's tokens before a
consumer's cancel can ride step N+1's frame.
"""
from __future__ import annotations

import json
import socket
import struct
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from substratus_tpu_torch.observability.metrics import METRICS
from substratus_tpu_torch.parallel import distributed


class NullSink:
    """Follower-side stand-in for Request.out: accepts and drops tokens.
    Followers mirror the full scheduler, so _emit runs on them too; the
    tokens just have nowhere to go (the leader answers the HTTP call)."""

    def put(self, item) -> None:  # the queue.Queue interface subset _emit uses
        pass


def _bucket_bytes(n: int, lo: int = 256) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def struct_pack_u32(n: int) -> bytes:
    return struct.pack("<I", n)


class _TimedSync:
    """Broadcast timing shared by every transport: the wall time lands in
    `substratus_serve_phase_seconds{phase="broadcast"}` and the last 4096
    `(payload_bytes, seconds)` samples stay on `timings`, the delivered
    length (a follower's samples carry real message sizes too)."""

    timings: "deque[tuple]"
    num_processes: int

    def broadcast(self, payload: Optional[bytes]) -> bytes:
        if self.num_processes == 1:
            return payload or b""
        t0 = time.perf_counter()
        out = self._broadcast(payload)
        dt = time.perf_counter() - t0
        self.timings.append((len(out), dt))
        METRICS.observe("substratus_serve_phase_seconds", dt, {"phase": "broadcast"})
        return out

    def _broadcast(self, payload: Optional[bytes]) -> bytes:
        raise NotImplementedError

    def agree(self, value: int) -> Tuple[int, int]:
        """(min, max) of one int over every rank, each rank calling it at
        the same point (the engine's check that the ranks admitted an
        adapter request alike). One process: (value, value)."""
        if self.num_processes == 1:
            return value, value
        return self._agree(value)

    def _agree(self, value: int) -> Tuple[int, int]:
        raise NotImplementedError(f"{type(self).__name__} has no agree: adapters in a gang are served over StepSync")


class StepSync(_TimedSync):
    """Per-iteration event broadcast of a gang (torch.distributed, gloo).
    `group` defaults to the gang's control group (parallel/distributed.py);
    rank and world are the default group's."""

    # Inline buffer: 4-byte length prefix + payload. Sized so a typical
    # iteration (a few requests, cancels, or the idle heartbeat) is one
    # collective.
    INLINE = 1024

    def __init__(self, group=None) -> None:
        if group is None:
            gang = distributed.current()
            if gang is None:
                raise RuntimeError("StepSync needs a gang: parallel.distributed.maybe_initialize() first")
            group = gang.control
        self.group = group
        self.process_index = dist.get_rank()
        self.num_processes = dist.get_world_size()
        self.leader = self.process_index == 0
        self.timings = deque(maxlen=4096)

    def _bcast(self, buf: np.ndarray) -> np.ndarray:
        t = torch.from_numpy(buf)
        dist.broadcast(t, src=0, group=self.group)
        return t.numpy()

    def _broadcast(self, payload: Optional[bytes]) -> bytes:
        """The leader sends `payload`; every rank returns it. One fixed-size
        broadcast carries the length (first 4 bytes) and up to INLINE - 4
        bytes; a longer payload takes a second, bucket-padded broadcast.
        Every rank derives the same count from the first buffer, so the
        gang stays in lockstep."""
        payload = payload or b""
        n = len(payload)
        cap = self.INLINE - 4
        buf = np.zeros((self.INLINE,), np.uint8)
        if self.leader:
            buf[:4] = np.frombuffer(struct_pack_u32(n), np.uint8)
            buf[4:4 + min(n, cap)] = np.frombuffer(payload[:cap], np.uint8)
        out = self._bcast(buf)
        # Read the header with an explicit little-endian dtype, as it was packed.
        n = int(out[:4].view(np.dtype("<u4"))[0])
        if n <= cap:
            return bytes(out[4:4 + n].tobytes())
        big = np.zeros((_bucket_bytes(n),), np.uint8)
        if self.leader:
            big[:n] = np.frombuffer(payload, np.uint8)
        return bytes(self._bcast(big)[:n].tobytes())

    def _agree(self, value: int) -> Tuple[int, int]:
        t = torch.tensor([value, -value], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.group)
        return int(t[0]), -int(t[1])


class TcpSync(_TimedSync):
    """Lockstep event broadcast over plain TCP: the leader fans each
    length-prefixed message out to every follower; followers block on
    recv. The same bytes as the JAX package's TcpSync, so a leader of one
    package feeds a follower of the other."""

    def __init__(self, process_index: int, num_processes: int, port: int,
                 host: str = "127.0.0.1", timeout: float = 120.0) -> None:
        self.process_index = process_index
        self.num_processes = num_processes
        self.leader = process_index == 0
        self.timings = deque(maxlen=4096)
        self._conns: List[socket.socket] = []
        if self.num_processes == 1:
            return
        if self.leader:
            with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as srv:
                srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                srv.bind((host, port))
                srv.listen(num_processes - 1)
                srv.settimeout(timeout)
                self._conns = [srv.accept()[0] for _ in range(num_processes - 1)]
        else:
            deadline = time.monotonic() + timeout
            while True:
                try:
                    conn = socket.create_connection((host, port), timeout=5)
                    break
                except OSError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.1)
            conn.settimeout(timeout)
            self._conns = [conn]
        for c in self._conns:
            c.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def _broadcast(self, payload: Optional[bytes]) -> bytes:
        payload = payload or b""
        if self.leader:
            msg = struct_pack_u32(len(payload)) + payload
            for c in self._conns:
                c.sendall(msg)
            return payload
        conn = self._conns[0]

        def recv_exact(n: int) -> bytes:
            chunks = []
            while n:
                chunk = conn.recv(n)
                if not chunk:
                    raise ConnectionError("leader closed the sync stream")
                chunks.append(chunk)
                n -= len(chunk)
            return b"".join(chunks)

        n = int(np.frombuffer(recv_exact(4), np.dtype("<u4"))[0])
        return recv_exact(n)

    def close(self) -> None:
        for c in self._conns:
            # shutdown() before close(): a follower blocked in _broadcast's
            # recv on another thread would neither wake nor see FIN from a
            # bare close().
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass


def encode_events(reqs: List[Any], cancels: List[int], stop: bool, swap: Optional[int] = None,
                  source: bool = False) -> bytes:
    """Iteration events -> wire bytes, the JAX package's JSON byte for
    byte. `reqs` carry every field admission reads, so a follower's mirror
    Request behaves identically. `swap` is the weight-swap barrier: the
    leader's target weights_version for this iteration (None = no swap).
    `source`, the port's own key, present only when true: the leader has
    a pull source attached, so every rank's admission fills every free
    slot this iteration (the JAX follower, not told, caps its admission
    while its leader fills, and the ranks' schedules part)."""
    return json.dumps(
        {
            **({"source": True} if source else {}),
            "stop": stop,
            "cancels": cancels,
            "swap": swap,
            "reqs": [
                {
                    "sid": r.sync_id,
                    "p": list(r.prompt_tokens),
                    "m": r.max_tokens,
                    "t": r.temperature,
                    "tp": r.top_p,
                    "e": r.eos_token_id,
                    "id": r.id,
                    "ad": r.adapter,
                }
                for r in reqs
            ],
        }
    ).encode()


def decode_events(payload: bytes) -> Dict[str, Any]:
    return json.loads(payload.decode())
