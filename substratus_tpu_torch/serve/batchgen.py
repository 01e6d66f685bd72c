"""Offline batch generation (port of substratus_tpu/serve/batchgen.py): a
JSONL prompt manifest in, sharded JSONL generations out, on one card, with
no HTTP path.

    python -m substratus_tpu_torch.serve.batchgen --manifest m.jsonl --output out/ [--model PATH | --config NAME]
        [--device cpu] [--params /content/params.json] [--progress-port 8080]

* **manifest in**: a JSONL prompt manifest (load/manifest.py), read-only at
  /content/data by the container contract; each record carries its own
  max_tokens/temperature/top_p and an optional `model` field that selects
  a LoRA adapter slot of the engine's store (serve/adapters.py, built by
  serve.main's build_adapter_store from params.json ``adapters`` or the
  mounted /content/adapters), so mixed-tenant records share one engine; a
  record whose adapter is unknown (or no store is configured) is written
  once with outcome "error", as the JAX package's BatchGenDriver writes it;
* **continuous refill**: the engine takes requests through its pull
  source (Engine.set_source): the scheduler thread pulls the next prompt
  the moment a slot frees, after the resume list and the submit queue,
  and admission fills every free slot while the source is attached. A
  pulled request boards like a submitted one (the decode graph and the
  overlapped scheduler stay as they are);
* **double-buffered sink**: finished records land in a swap buffer on the
  scheduler thread (a list append, never I/O); a sink thread swaps it and
  does the host work (detokenize, JSON encode, shard write and flush);
* **sharded, exactly-once output**: results are JSONL shards whose lines
  carry the record's manifest index. The output is the resume ledger: a
  restarted run scans the shards, skips every durable index, and
  regenerates the rest into a fresh shard (torn tail lines from a kill are
  unparseable, ignored, and regenerated).

One actor engine a process (BatchGenDriver takes several engines of one
process, as JAX's does); outside a gang a second visible card exits
naming its ROADMAP item. ``baseModel`` is a known key with no effect, as
in serve.main.

**A gang** (the operator's environment: JAX_COORDINATOR_ADDRESS,
JAX_NUM_PROCESSES > 1, TPU_WORKER_ID), as the JAX entry point runs one:
every rank joins the rendezvous, builds serve.main's mesh (``tensor`` over
the kv heads, ``data`` the rest; ``max_batch`` rounded up to a multiple of
``data``), loads its shard and its slice of the adapter store, and runs
the engine with the replicated scheduler. The leader alone attaches the
BatchGenDriver's source (its pulls ride the event broadcast), writes the
shards and serves the progress port; a follower mirrors it until the leader's
stop and exits 0, or 1 when its engine failed. A rank's death fails the
others' next collective: the leader exits 1 with every durable record in
its shards, and a rerun of the gang resumes from them. A record the
engine's death ended is never written (JAX's BatchGenDriver writes it as
an "error" record), so the rerun generates it: each record once, with its
tokens.

Metrics (observability/metrics.py, the JAX names): records written by
outcome, the slot occupancy the refill exists to hold at 1.0, and the
manifest's progress.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from substratus_tpu_torch.load.manifest import (
    completed_indices,
    iter_manifest,
    next_shard_index,
    record_prompt_tokens,
    shard_name,
)
from substratus_tpu_torch.observability.metrics import METRICS

log = logging.getLogger(__name__)

METRICS.describe(
    "substratus_batchgen_records_total",
    "Batch-generation records written to output shards, labeled by "
    "outcome: ok (generated to stop/length), error (engine-side "
    "failure: unknown adapter, engine death), invalid (malformed "
    "manifest record — written once, never retried).",
    type="counter",
)
METRICS.describe(
    "substratus_batchgen_slot_occupancy",
    "Active decode slots / total slots across the run's actor engines, "
    "sampled by the sink thread each flush interval. The number the "
    "continuous-refill scheduler exists to keep at 1.0.",
    type="gauge",
)
METRICS.describe(
    "substratus_batchgen_manifest_progress_ratio",
    "Durably written manifest records (this run + resumed prior runs) "
    "/ total manifest records.",
    type="gauge",
)

# The batchGenerate keys of params.json (the JAX entry point's).
BATCHGEN_KEYS = ("manifest", "output", "maxTokens", "temperature", "recordsPerShard", "progressPort")
# Serving knobs the batch run takes no part in, as in the JAX entry point.
_SERVER_ONLY = ("max_queue", "drain_grace", "spec_k", "draft_model", "role", "transfer_port", "decode_peers")
_MULTI_GPU = "Queue 1, multi-GPU (a batch run over several cards)"


class ShardWriter:
    """Sharded JSONL results writer. Owned by the sink thread (not
    thread-safe); rotation is internal, open_shard/close are the
    lifecycle pair. Resume never appends to an existing shard: a tail line
    torn by a kill must stay inert, not have fresh JSON glued onto it."""

    def __init__(self, out_dir: str, records_per_shard: int = 10000):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.records_per_shard = max(1, int(records_per_shard))
        self._f = None
        self._in_shard = 0

    def open_shard(self) -> str:
        """Open the next free shard file; returns its path."""
        if self._f is not None:
            self._f.close()
        path = os.path.join(self.out_dir, shard_name(next_shard_index(self.out_dir)))
        self._f = open(path, "w")
        self._in_shard = 0
        return path

    def write(self, record: Dict[str, Any]) -> None:
        if self._f is None or self._in_shard >= self.records_per_shard:
            path = self.open_shard()
            log.info("batchgen: rotating to %s", path)
        self._f.write(json.dumps(record, sort_keys=True) + "\n")
        self._in_shard += 1

    def flush(self) -> None:
        """Push buffered lines to the OS, so a killed process loses at most
        the swap buffer in flight (whose records resume regenerates: they
        were never durable, so exactly-once holds)."""
        if self._f is not None:
            self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.flush()
            self._f.close()
            self._f = None


class _RecordSink:
    """Per-request stand-in for Request.out (the put() of a queue). put()
    runs on the engine's scheduler thread: tokens append to a plain list
    (one producer), and the terminal None hands the finished record to
    its BatchGenDriver's swap buffer: never I/O, never blocking."""

    __slots__ = ("owner", "index", "rec", "req", "tokens", "n_prompt", "error")

    def __init__(self, owner: "BatchGenDriver", index: int, rec: Dict[str, Any]):
        self.owner = owner
        self.index = index
        self.rec = rec
        self.req = None
        self.tokens: List[int] = []
        self.n_prompt = 0
        self.error: Optional[str] = None  # manifest-invalid records

    def put(self, item) -> None:
        if item is None:
            self.owner._complete(self)
        else:
            self.tokens.append(item)


class _EngineSource:
    """The engine-facing pull source (Engine.set_source): one per actor,
    all draining one BatchGenDriver's manifest cursor."""

    def __init__(self, owner: "BatchGenDriver"):
        self._owner = owner

    def pull(self):
        return self._owner._pull()

    def pending(self) -> bool:
        return self._owner._pending_refill()

    def progress(self) -> Dict[str, Any]:
        return self._owner.progress()


class BatchGenDriver:
    """Drives one or more actor engines through a prompt manifest.

    Threading: the engines' scheduler threads call _pull/_complete (short
    critical sections under one lock: a list pop or append); the sink
    thread (_sink_loop) owns all output I/O, the shard writer and every
    counter; run() blocks the caller until the manifest drains. The
    pending records are read eagerly, so a malformed manifest line fails
    before any device work (a record with bad fields becomes an
    outcome=invalid output line instead, written exactly once)."""

    def __init__(
        self,
        engines: List[Any],
        manifest_path: str,
        out_dir: str,
        *,
        tokenizer=None,
        max_tokens: int = 64,
        temperature: float = 0.0,
        top_p: float = 1.0,
        records_per_shard: int = 10000,
        resume: bool = True,
        flush_interval_s: float = 0.05,
        sample_interval_s: float = 0.01,
        prefetch: Optional[int] = None,
        record_hook=None,
    ):
        if not engines:
            raise ValueError("batch generation needs at least one engine")
        for e in engines:
            if e.ec.role != "both":
                raise ValueError(f"batch generation drives monolithic engines (role={e.ec.role!r} given); split "
                                 "pools belong to the interactive path")
        self.engines = list(engines)
        self.tokenizer = tokenizer
        self.default_max_tokens = int(max_tokens)
        self.default_temperature = float(temperature)
        self.default_top_p = float(top_p)
        self.flush_interval_s = float(flush_interval_s)
        self.sample_interval_s = float(sample_interval_s)
        self.manifest_path = manifest_path
        # Called with each completed ok record after it is written (on the
        # sink thread: implementations must be thread-safe), with the
        # record's prompt ids.
        self.record_hook = record_hook
        self._writer = ShardWriter(out_dir, records_per_shard)
        self._slots_total = sum(e.ec.max_batch for e in self.engines)
        self._prefetch = int(prefetch) if prefetch else max(2, 2 * self._slots_total)

        all_records = list(iter_manifest(manifest_path))
        self.total = len(all_records)
        done = completed_indices(out_dir) if resume else set()
        self._records = deque((i, rec) for i, rec in all_records if i not in done)
        self.resumed = self.total - len(self._records)

        self._lock = threading.Lock()
        self._ready: List[Any] = []  # prefetched Requests awaiting pull
        self._buf: List[_RecordSink] = []  # finished, awaiting write-out
        self._wake = threading.Event()
        self._in_flight = 0
        self._pulled = 0
        self._written = 0
        self._ok = 0
        self._errors = 0
        self._gen_tokens = 0
        self._occ_samples: List[float] = []
        self._abort: Optional[str] = None
        self._finished = threading.Event()

    # -- the scheduler threads' side (through _EngineSource / _RecordSink) --

    def _build_request(self, index: int, rec: Dict[str, Any]):
        from substratus_tpu_torch.serve.engine import Request

        sink = _RecordSink(self, index, rec)
        toks = record_prompt_tokens(rec, self.tokenizer)
        req = Request(
            prompt_tokens=toks,
            max_tokens=int(rec.get("max_tokens", self.default_max_tokens)),
            temperature=float(rec.get("temperature", self.default_temperature)),
            top_p=float(rec.get("top_p", self.default_top_p)),
            adapter=rec.get("model"),
            out=sink,
            id=str(rec.get("id", index)),
        )
        sink.req = req
        sink.n_prompt = len(toks)
        return req

    def _fill_ready_locked(self) -> None:
        """Top the prefetch buffer up from the record cursor (the caller
        holds self._lock). A record whose fields do not validate becomes an
        outcome=invalid completion, buffered like a finished request, so
        every counter write stays on the sink thread."""
        while self._records and self._abort is None and len(self._ready) < self._prefetch:
            index, rec = self._records.popleft()
            try:
                self._ready.append(self._build_request(index, rec))
            except ValueError as e:
                bad = _RecordSink(self, index, rec)
                bad.error = f"invalid: {e}"
                self._buf.append(bad)
                self._wake.set()

    def _pull(self):
        """The next request for a freed slot, on an engine's scheduler
        thread: a prefetched one, else one built inline when the prefetch
        is behind."""
        with self._lock:
            if self._abort is not None:
                return None
            if not self._ready:
                self._fill_ready_locked()
            if not self._ready:
                return None
            req = self._ready.pop(0)
            self._in_flight += 1
            self._pulled += 1
            return req

    def _pending_refill(self) -> bool:
        with self._lock:
            return bool(self._ready) or bool(self._records)

    def _complete(self, sink: _RecordSink) -> None:
        # An "error" the engine's death gave (its error is set before it
        # ends its requests) is not the record's outcome: never durable,
        # so that a rerun generates it.
        died = sink.req is not None and sink.req.finish_reason == "error" and any(
            e.error is not None for e in self.engines)
        with self._lock:
            if not died:
                self._buf.append(sink)
            self._in_flight -= 1
        self._wake.set()

    # -- the sink thread ----------------------------------------------------

    def _write_one(self, sink: _RecordSink) -> None:
        req = sink.req
        if sink.error is not None:
            outcome, finish = "invalid", sink.error
        elif req is not None and req.finish_reason == "error":
            outcome, finish = "error", "error"
        else:
            outcome, finish = "ok", req.finish_reason
        out: Dict[str, Any] = {
            "index": sink.index,
            "id": str(sink.rec.get("id", sink.index)),
            "tokens": list(sink.tokens),
            "finish_reason": finish,
            "prompt_tokens": sink.n_prompt,
            "gen_tokens": len(sink.tokens),
        }
        model = sink.rec.get("model")
        if model is not None:
            out["model"] = model
        if self.tokenizer is not None and sink.tokens:
            out["text"] = self.tokenizer.decode(list(sink.tokens))
        self._writer.write(out)
        self._written += 1
        self._gen_tokens += len(sink.tokens)
        if outcome == "ok":
            self._ok += 1
            if self.record_hook is not None:
                # After the durable write, and for ok records only: a
                # consumer never sees a record that a resume could replay
                # differently.
                self.record_hook(dict(out), list(req.prompt_tokens) if req is not None else [])
        else:
            self._errors += 1
        METRICS.inc("substratus_batchgen_records_total", {"outcome": outcome})

    def _sampler_loop(self) -> None:
        """Occupancy sampled at a steady cadence on its own thread: the
        sink loop wakes on completions, so sampling there would land every
        sample inside the refill window and bias the mean low."""
        while not self._finished.wait(timeout=self.sample_interval_s):
            # A racy read of each engine's host-side active mask: a torn
            # snapshot skews one sample by one slot; the mean absorbs it.
            active = sum(int(e.active.sum()) for e in self.engines)
            occ = active / self._slots_total
            METRICS.set("substratus_batchgen_slot_occupancy", occ)
            with self._lock:
                refill_possible = bool(self._ready) or bool(self._records)
                warm = self._pulled >= self._slots_total
            METRICS.set("substratus_batchgen_manifest_progress_ratio",
                        (self.resumed + self._written) / max(1, self.total))
            if refill_possible and warm:
                # Steady state: the batch has filled once and a refill is
                # still possible (ramp-up and the final drain do not count).
                self._occ_samples.append(occ)

    def _sink_loop(self) -> None:
        while True:
            self._wake.wait(timeout=self.flush_interval_s)
            self._wake.clear()
            with self._lock:
                batch, self._buf = self._buf, []
                # Prefetch here too, so tokenizing and building requests
                # stay off the scheduler threads' path.
                self._fill_ready_locked()
                if self._abort is None:
                    dead = next((e for e in self.engines if e.error is not None), None)
                    if dead is not None:
                        self._abort = f"engine died: {dead.error!r}"
                aborted = self._abort is not None
            for sink in batch:
                self._write_one(sink)
            if batch:
                self._writer.flush()
            if aborted:
                return
            with self._lock:
                if not self._records and not self._ready and self._in_flight == 0 and not self._buf:
                    return

    # -- the public API --------------------------------------------------------

    def progress(self) -> Dict[str, Any]:
        """Manifest progress for load_snapshot() and /loadz (read-only; a
        torn read across counters is fine for a progress report)."""
        with self._lock:
            return {
                "manifest_records": self.total,
                "resumed": self.resumed,
                "written": self._written,
                "errors": self._errors,
                "in_flight": self._in_flight,
                "pending": len(self._records) + len(self._ready),
            }

    def cancel(self, reason: str = "cancelled") -> None:
        with self._lock:
            self._abort = reason
        self._wake.set()

    def run(self) -> Dict[str, Any]:
        """Drive the manifest to completion; returns the run summary.
        Raises RuntimeError when an engine dies mid-run (the shards
        already written stay durable: a rerun resumes from them)."""
        t0 = time.perf_counter()
        if not self._records:
            self._writer.close()
            return self._summary(time.perf_counter() - t0)
        first = self._writer.open_shard()
        log.info("batchgen: %d records (%d resumed) -> %s", len(self._records), self.resumed, first)
        sink_thread = threading.Thread(target=self._sink_loop, name="batchgen-sink", daemon=True)
        sampler = threading.Thread(target=self._sampler_loop, name="batchgen-sampler", daemon=True)
        for e in self.engines:
            e.set_source(_EngineSource(self))
        sink_thread.start()
        sampler.start()
        try:
            sink_thread.join()
        finally:
            self._finished.set()
            sampler.join(timeout=5)
            for e in self.engines:
                e.set_source(None)
            self._writer.close()
        if self._abort is not None:
            raise RuntimeError(f"batch generation aborted: {self._abort}")
        return self._summary(time.perf_counter() - t0)

    def _summary(self, wall: float) -> Dict[str, Any]:
        occ = round(sum(self._occ_samples) / len(self._occ_samples), 4) if self._occ_samples else None
        return {
            "manifest_records": self.total,
            "resumed": self.resumed,
            "written": self._written,
            "ok": self._ok,
            "errors": self._errors,
            "gen_tokens": self._gen_tokens,
            "wall_s": round(wall, 3),
            "gen_tok_s": round(self._gen_tokens / wall, 1) if wall > 0 else 0.0,
            "slot_occupancy": occ,
            "occupancy_samples": len(self._occ_samples),
            "actors": len(self.engines),
        }


class ProgressServer:
    """The optional observation endpoint of an offline run: /loadz (the
    engine's load snapshot, which carries the manifest's progress
    once the source is attached) and /metrics (the shared registry), from
    the standard library's http.server on a daemon thread. Batch jobs have
    no HTTP path; this one exists so that a port-forward can watch."""

    def __init__(self, engine, host: str = "0.0.0.0", port: int = 8080):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (http.server's name)
                if self.path == "/loadz":
                    body = json.dumps(engine.load_snapshot()).encode()
                    ctype = "application/json"
                elif self.path == "/metrics":
                    body = METRICS.render().encode()
                    ctype = "text/plain; version=0.0.4"
                elif self.path == "/":
                    body, ctype = b"ok\n", "text/plain"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a) -> None:
                pass  # progress polls must not fill the job's log

        self._srv = ThreadingHTTPServer((host, port), Handler)
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(target=self._srv.serve_forever, name="batchgen-progress", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m substratus_tpu_torch.serve.batchgen",
                                 description="offline batch generation from a JSONL prompt manifest")
    ap.add_argument("--manifest", default=None, help="JSONL prompt manifest (default: params batchGenerate.manifest, "
                                                     "then /content/data/prompts.jsonl)")
    ap.add_argument("--output", default=None, help="output shard directory (default: params batchGenerate.output, "
                                                   "then /content/artifacts/generations)")
    ap.add_argument("--model", default=None, help="checkpoint: a .gguf file, a port artifact or a local HF directory "
                                                  "(default: params.json model, else /content/model if mounted)")
    ap.add_argument("--config", default=None, help="named config for random-weight smoke runs")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument("--max-seq-len", type=int, default=None)
    ap.add_argument("--quantize", default=None, choices=["int8", "w8a8", "int4", "none"])
    ap.add_argument("--max-tokens", type=int, default=None,
                    help="default generation budget for records without their own max_tokens")
    ap.add_argument("--temperature", type=float, default=None)
    ap.add_argument("--records-per-shard", type=int, default=None)
    ap.add_argument("--no-resume", action="store_true",
                    help="ignore existing output shards (default: skip every record already durably written)")
    ap.add_argument("--progress-port", type=int, default=None,
                    help="serve /loadz + /metrics on this port (0 = ephemeral; default off)")
    ap.add_argument("--step-floor-ms", type=float, default=0.0, help="simulated device-step floor (tests)")
    ap.add_argument("--params", default="/content/params.json", help="params file (container contract)")
    return ap.parse_args(argv)


def batchgen_params(params_json: Dict[str, Any]) -> Dict[str, Any]:
    """params.json's batchGenerate object; exits on anything but an object
    of the JAX entry point's keys (the port exits on unknown keys; JAX
    warns)."""
    bg = params_json.get("batchGenerate") or {}
    if not isinstance(bg, dict):
        raise SystemExit(f"params.json: batchGenerate={bg!r} invalid (an object of {BATCHGEN_KEYS})")
    unknown = sorted(set(bg) - set(BATCHGEN_KEYS))
    if unknown:
        raise SystemExit(f"params.json: unknown batchGenerate key(s) {unknown} (known: {BATCHGEN_KEYS})")
    return bg


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch

    from substratus_tpu_torch.observability.propagation import context_from_env
    from substratus_tpu_torch.observability.tracing import tracer
    from substratus_tpu_torch.parallel import distributed
    from substratus_tpu_torch.serve.engine import Engine, EngineConfig
    from substratus_tpu_torch.serve.main import (
        GangMesh, build_adapter_store, check_params, gang_batch, load_model, load_params_json, mesh_line,
        resolve_kv_layout, resolve_overlap, resolve_quantize, shard_layout)
    from substratus_tpu_torch.utils.device import resolve_device

    params_json = load_params_json(args.params)
    check_params(params_json)
    bg = batchgen_params(params_json)
    gang, mesh_for = None, None
    coord, world, _ = distributed.world_info()
    if world > 1 and coord:
        # Every rank joins; each takes the device the rendezvous gives it.
        distributed.maybe_initialize(device_type="cpu" if args.device == "cpu" else "cuda")
        gang = distributed.current()
        device = gang.device
        mesh_for = GangMesh(gang.world, params_json)
    else:
        device = resolve_device(args.device)
        if device.type == "cuda" and torch.cuda.device_count() > 1:
            raise SystemExit(f"{torch.cuda.device_count()} cards visible: the PyTorch port's batch generation runs "
                             f"on one (name it with CUDA_VISIBLE_DEVICES) outside a gang; ROADMAP {_MULTI_GPU}")
    for key in _SERVER_ONLY:
        if key in params_json:
            print(f"params.json: {key} ignored by batch generation", flush=True)
    manifest = args.manifest or bg.get("manifest") or "/content/data/prompts.jsonl"
    output = args.output or bg.get("output") or "/content/artifacts/generations"
    if not os.path.exists(manifest):
        raise SystemExit(f"prompt manifest not found: {manifest}")

    quantize = resolve_quantize(dict(params_json, **({"quantize": args.quantize} if args.quantize else {})))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    cfg, params, tokenizer, name, family, quantize = load_model(args.model, args.config, params_json, device,
                                                                quantize, mesh_for=mesh_for)
    mesh = mesh_for.mesh if mesh_for is not None else None
    weight_bytes = sum(t.numel() * t.element_size() for t in params.state_dict().values() if torch.is_tensor(t))
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None

    max_batch = gang_batch(args.max_batch or int(params_json.get("max_batch", 8)), mesh)
    max_seq_len = args.max_seq_len or int(params_json.get("max_seq_len", 1024))
    ec = EngineConfig(
        max_batch=max_batch,
        max_seq_len=min(max_seq_len, cfg.max_seq_len),
        max_prefill_len=int(params_json.get("max_prefill_len", EngineConfig.max_prefill_len)),
        eos_token_id=tokenizer.eos_id if tokenizer.eos_id is not None else 2,
        kv_cache_dtype=params_json.get("kv_cache_dtype", "model"),
        kv_layout=resolve_kv_layout(params_json),
        overlap=resolve_overlap(params_json),
        step_floor_s=args.step_floor_ms / 1e3,
    )
    # Per-record `model` fields select LoRA slots of one shared store.
    adapters = build_adapter_store(family, cfg, params_json, None, device, tp=getattr(params, "tp", None))
    sync = None
    if gang is not None:
        from substratus_tpu_torch.serve.multihost import StepSync

        sync = StepSync()
    engine = Engine(cfg, params, ec, device=device, model=family, adapters=adapters, mesh=mesh, sync=sync)
    engine.start()
    on_card = f", peak {peak} bytes while loading and quantizing" if peak is not None else ""
    gang_line = ""
    if gang is not None:
        gang_line = (f"; batchgen gang: rank {gang.rank}/{gang.world} ({'leader' if gang.leader else 'follower'}), "
                     f"mesh {mesh.describe()}, data backend {gang.backend}, weights {shard_layout(params)}, slots "
                     f"{engine.rows[0]}-{engine.rows[1] - 1} on this data replica")
    print(f"batchgen: {name} on {device}, {quantize} weights ({weight_bytes} bytes{on_card}); "
          f"{'paged' if engine.paged else 'dense'} kv, {engine.attention_route()}; max_batch {ec.max_batch}, "
          f"max_seq_len {ec.max_seq_len}; scheduler {'overlapped' if engine.overlap else 'synchronous'}, decode "
          f"step {'one CUDA graph' if engine.decode_graph else 'eager'}{gang_line}", flush=True)
    if mesh is not None:
        print(mesh_line(mesh).replace("serving mesh", "batchgen mesh"), flush=True)
    if gang is not None and not gang.leader:
        # A follower mirrors the leader's scheduler (the pulled records
        # arrive in the broadcast) until the stop, or fails with the gang.
        engine._thread.join()
        if engine.error is not None:
            print(f"batchgen gang rank {gang.rank} engine died: {engine.error!r}", flush=True)
            return 1
        distributed.shutdown()
        return 0

    progress_srv = None
    if args.progress_port is not None or bg.get("progressPort") is not None:
        port = args.progress_port if args.progress_port is not None else int(bg["progressPort"])
        progress_srv = ProgressServer(engine, port=port)
        print(f"batchgen progress on :{progress_srv.port}", flush=True)

    rc = 0
    try:
        batch = BatchGenDriver(
            [engine], manifest, output, tokenizer=tokenizer,
            max_tokens=args.max_tokens if args.max_tokens is not None else int(bg.get("maxTokens", 64)),
            temperature=args.temperature if args.temperature is not None else float(bg.get("temperature", 0.0)),
            records_per_shard=args.records_per_shard or int(bg.get("recordsPerShard", 10000)),
            resume=not args.no_resume,
        )
        # Joins the spawner's trace (the TRACEPARENT variable), as the JAX
        # entry point does.
        with tracer.span("batchgen.run", parent=context_from_env(), manifest=manifest, records=batch.total):
            summary = batch.run()
        print(json.dumps(summary), flush=True)
    except RuntimeError as e:
        print(json.dumps({"error": str(e)}), flush=True)
        rc = 1
    finally:
        if progress_srv is not None:
            progress_srv.close()
        engine.stop()
    if gang is not None:
        if engine.error is not None:
            print(f"batchgen gang rank {gang.rank} engine died: {engine.error!r}", flush=True)
            return 1
        distributed.shutdown()
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
