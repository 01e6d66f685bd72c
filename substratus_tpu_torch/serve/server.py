"""OpenAI-compatible HTTP server over the port's Engine, on the standard
library alone: the serving surface of the container contract
(docs/container-contract.md), after substratus_tpu/serve/server.py, which
is built on aiohttp. Status codes, bodies and headers are the JAX
server's:

  * ``GET /`` readiness: 200 ``ok`` once the engine runs, 503 ``draining``
    from SIGTERM on, 500 with the error once the engine died;
  * ``GET /loadz`` the engine's load_snapshot() with ``model`` and
    ``draining`` (the gateway protocol, gateway/loadreport.py): 503 while
    draining, 500 with the error;
  * ``GET /metrics`` the Prometheus text of observability/metrics.py, the
    engine gauges refreshed at scrape, in the versioned content type;
  * ``GET /v1/models`` the served model and, with an adapter store
    (serve/adapters.py), every servable tenant adapter (``parent`` the base,
    ``loaded`` whether it is resident); a request's ``model`` field names
    the base (or is empty) or an adapter, anything else gets 404
    ``model_not_found``;
  * ``POST /v1/completions`` ``{prompt, max_tokens, temperature, top_p,
    stop, stream}`` and ``POST /v1/chat/completions`` (``messages``,
    rendered by the tokenizer's chat template, else a generic transcript):
    the OpenAI body with ``usage``, or with ``stream: true`` SSE ``data:``
    chunks, one a generated token (its text may be empty: a control id,
    half a codepoint, or text held back because it could begin a stop
    sequence), a last chunk with the finish reason, with
    ``stream_options: {"include_usage": true}`` a usage chunk, then
    ``data: [DONE]``. A ``stop`` match cancels the engine's slot at once
    and cuts the text before the match; a stream never sends a stop
    sequence, even one split across tokens;
  * admission: 503 ``wrong_role`` with ``Retry-After`` on a decode-role
    replica (serve/disagg.py), 503 with ``Retry-After`` while draining, 504 for an expired
    ``x-request-deadline``, 429 with ``Retry-After`` when the engine's
    queue is at ``max_queue``; 200 responses of ``/v1/`` carry the
    ``x-substratus-load`` report header (streams at their start);
  * ``POST /swapz`` ``{checkpoint, version, source}``: a hot weight swap
    through the configured checkpoint loader (Engine.swap_params): 200,
    400 (a bad body, no such checkpoint), 409 (a structure mismatch: the
    old weights stay) or 501 (no loader);
  * ``POST /debug/profile`` ``{"seconds": N}`` (0 < N <= 60) or
    ``{"action": "start"|"stop"}`` (capped at 60 s): a torch.profiler
    capture (the card's kernels with CUDA activity) written as a Chrome
    trace under PROFILE_DIR; 409 while one runs; a ``serve.profile`` span
    and ProfileCapture* events;
  * ``GET /debug/tracez`` (the span ring by trace, latency-bucketed),
    ``/debug/requestz`` (requests in flight; with ``?id=`` a trace or
    request id, the request's journey with its waterfall and Chrome trace,
    404 when none is known), ``/debug/perfz`` (the phase histograms, the
    latency quantiles, the engine's counters), ``/debug/stepz`` (the
    engine's step timeline as a Chrome trace with the bubble totals),
    ``/debug/slowz`` (the SLO-breaching journeys and the latency
    histograms' exemplars) and ``/debug/eventz`` (the event recorder),
    with the JAX server's keys.

Tracing (the JAX server's trace middleware): each request on ``/v1/`` or
``/debug/`` runs in a ``serve.http`` span under its ``traceparent`` header
(a malformed one starts a new trace), its trace id goes back as
``x-trace-id`` on every response (a stream's with its headers, before any
token; errors too) and as one structured JSON line on the
``substratus.serve.access`` logger. The engine takes the request's context
at submit on the handler's thread. `/debug/*` and ``/swapz`` are gated by
the `authorizer` when one is given (observability/authz.py: 401 with
``WWW-Authenticate: Bearer``, 403, or 500 when the review failed); the
serving entry point passes none, as the JAX one does, so they are open.

Every response counts in substratus_http_requests_total.

Each connection runs on its own thread (``ThreadingHTTPServer``) and
blocks on its request's token queue; the engine's one scheduler thread
does all the device work. Server.serve_forever drains on SIGTERM or
SIGINT: readiness fails first, in-flight requests finish (up to the
grace), then the listener closes and the engine stops last.
"""
from __future__ import annotations

import contextlib
import json
import logging
import math
import os
import re
import signal
import tempfile
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from substratus_tpu_torch.gateway.limiter import deadline_remaining, parse_deadline
from substratus_tpu_torch.gateway.loadreport import HEADER as LOAD_HEADER
from substratus_tpu_torch.gateway.loadreport import LoadReport
from substratus_tpu_torch.observability.events import EVENTS
from substratus_tpu_torch.observability.httpstats import count_http_response
from substratus_tpu_torch.observability.journey import chrome_trace, waterfall
from substratus_tpu_torch.observability.metrics import METRICS, quantile_from_buckets
from substratus_tpu_torch.observability.propagation import parse_traceparent
from substratus_tpu_torch.observability.tracing import tracer
from substratus_tpu_torch.serve.adapters import UnknownAdapter
from substratus_tpu_torch.serve.engine import Engine, EngineOverloaded, Request

# Scrape-time engine gauges (the request-latency histograms live in
# serve/engine.py), as the JAX server declares them.
for _name, _help in (
    ("substratus_serve_active_slots", "Decode slots currently generating."),
    ("substratus_serve_max_slots", "Configured decode slot count (max_batch)."),
    ("substratus_serve_queue_depth", "Requests waiting for a decode slot."),
    ("substratus_serve_kv_pages_total", "KV pool size in pages (paged layout)."),
    ("substratus_serve_kv_pages_free", "Unallocated KV pages (paged layout)."),
):
    METRICS.describe(_name, _help, type="gauge")
METRICS.describe("substratus_serve_requests_total", "Completion requests received.", type="counter")
# The port's own: which hand-written kernels the served path launched.
METRICS.describe("substratus_serve_kernel_launches",
                 "Launches of each kernel counter of the port's CUDA kernels (function.counter; a design's own "
                 "counter beside the total) since the process started: the wrapper's count plus the launches inside "
                 "the engine's CUDA graph replays.", type="gauge")

# Structured access log: one JSON line a traced request, with its trace id,
# so log pipelines join lines to span exports.
access_log = logging.getLogger("substratus.serve.access")
# The paths the trace middleware wraps (probes and scrapes stay untraced:
# a 5 s scrape interval would crowd the span ring).
TRACED_PREFIXES = ("/v1/", "/debug/")

# Per-token wait before a stream is declared dead (the engine puts a
# terminal None on every request, error included, so this only guards a
# wedged device).
TOKEN_TIMEOUT_S = 600.0
# The longest /debug/profile capture, and the watchdog of a started one.
PROFILE_CAP_S = 60.0
# The exposition format Prometheus negotiates for.
METRICS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class HTTPError(Exception):
    """An error response: its status, its body (text, or a dict sent as
    JSON) and extra headers."""

    def __init__(self, status: int, body, headers: Optional[dict] = None):
        super().__init__(status, body)
        self.status, self.body, self.headers = status, body, headers or {}


def _json_error(status: int, message: str, kind: str, headers: Optional[dict] = None, **extra) -> HTTPError:
    return HTTPError(status, {"error": {"message": message, "type": kind, **extra}}, headers)


class ServerState:
    def __init__(self, engine: Engine, tokenizer, model_name: str, authorizer=None,
                 checkpoint_loader: Optional[Callable[[str], object]] = None):
        self.engine = engine
        self.tokenizer = tokenizer
        self.model_name = model_name
        # Checkpoint ref -> weights ready to install (the boot path's load
        # and quantize pipeline). POST /swapz needs it; None = this replica
        # cannot hot-swap (501, so a rollout controller skips it honestly).
        self.checkpoint_loader = checkpoint_loader
        self.ready = True
        # SIGTERM sets it: readiness (`GET /`, `/loadz`) and new requests
        # answer 503 while in-flight streams run to the drain deadline.
        self.draining = False
        # The /debug pages' and /swapz's RBAC check (observability/authz.py
        # MetricsAuthorizer); None = open, as the serving entry point runs.
        self.authorizer = authorizer
        # In-flight requests by id, {req, endpoint, trace_id, start} for
        # /debug/requestz; handler threads add and remove under the lock.
        self.inflight: dict = {}
        # Handlers running, from the parsed request line to the written
        # response: drain() waits for none to run, so a response owed
        # before the engine's part (admission, encoding) or after it (the
        # body's write) is never cut by the exit.
        self.handlers = 0
        self._lock = threading.Lock()
        self.swap_lock = threading.Lock()  # one swap at a time
        self.profile = _Profile(engine, model_name)

    def track_request(self, req: Request, endpoint: str) -> None:
        ctx = tracer.current_context()
        with self._lock:
            self.inflight[req.id] = {"req": req, "endpoint": endpoint,
                                     "trace_id": ctx.trace_id if ctx is not None else None, "start": time.time()}

    def untrack_request(self, req: Request) -> None:
        with self._lock:
            self.inflight.pop(req.id, None)

    @contextlib.contextmanager
    def handling(self):
        with self._lock:
            self.handlers += 1
        try:
            yield
        finally:
            with self._lock:
                self.handlers -= 1

    def render_chat(self, messages):
        """Messages -> (prompt, templated), with the MODEL's chat template
        when the tokenizer carries one (an HF tokenizer's, or a GGUF's
        embedded tokenizer.chat_template): chat checkpoints are trained on
        their template and degrade badly off it. `templated` makes encoding
        parse the special tokens the template rendered and skip the
        automatic BOS. Otherwise the generic role-joined transcript, also
        when a template exists but fails (said on stdout)."""
        tmpl = getattr(self.tokenizer, "apply_chat_template", None)
        if tmpl is not None:
            try:
                rendered = tmpl(messages)
            except Exception as e:  # a broken template must not take the endpoint down
                print(f"chat template failed ({type(e).__name__}: {e}); using the generic transcript", flush=True)
                rendered = None
            if rendered is not None:
                return rendered, True
        prompt = "\n".join(f"{m.get('role', 'user')}: {m.get('content', '')}" for m in messages)
        return prompt + "\nassistant:", False

    def encode_prompt(self, prompt: str, templated: bool = False):
        """Prompt -> ids; a template-rendered prompt takes the tokenizer's
        special-token-aware path (no doubled BOS, control tokens as ids)
        when it has one."""
        if templated:
            enc = getattr(self.tokenizer, "encode_templated", None)
            if enc is not None:
                return enc(prompt)
        return self.tokenizer.encode(prompt)


def _find_stop(text: str, stop) -> Optional[int]:
    """Earliest index of any stop sequence in text, or None: the one
    matching rule of the cancellation and of the final cut."""
    cuts = [idx for s in stop or [] if s and (idx := text.find(s)) != -1]
    return min(cuts) if cuts else None


def completion_body(state: ServerState, text: str, n_prompt: int, n_gen: int,
                    finish_reason: str = "stop", model: Optional[str] = None) -> dict:
    return {
        "id": f"cmpl-{uuid.uuid4().hex[:24]}",
        "object": "text_completion",
        "created": int(time.time()),
        "model": model or state.model_name,
        "choices": [
            {"index": 0, "text": text, "finish_reason": finish_reason, "logprobs": None}
        ],
        "usage": {
            "prompt_tokens": n_prompt,
            "completion_tokens": n_gen,
            "total_tokens": n_prompt + n_gen,
        },
    }


def validate_body(body: dict) -> None:
    """Reject malformed knobs before any engine work (the JAX server's
    _validate_body: the same statuses and messages)."""
    stop = body.get("stop")
    if stop is not None and not (isinstance(stop, str)
                                 or (isinstance(stop, list) and all(isinstance(s, str) for s in stop))):
        raise HTTPError(400, "'stop' must be a string or list of strings")
    if "max_tokens" in body:
        try:
            v = int(body["max_tokens"])
        except (TypeError, ValueError):
            raise HTTPError(400, "'max_tokens' must be an integer")
        if v < 1:
            raise HTTPError(400, "'max_tokens' must be >= 1")
    for key in ("temperature", "top_p"):
        if key in body:
            try:
                v = float(body[key])
            except (TypeError, ValueError):
                raise HTTPError(400, f"'{key}' must be a number")
            if not math.isfinite(v):
                # json.loads takes NaN and Infinity, and NaN passes any <.
                raise HTTPError(400, f"'{key}' must be finite")
            if key == "temperature" and v < 0:
                raise HTTPError(400, "'temperature' must be >= 0")
            if key == "top_p" and not (0 < v <= 1):
                raise HTTPError(400, "'top_p' must be in (0, 1]")


def _serving_kernels() -> tuple:
    """The wrappers of the serving kernels, whose counters /metrics shows."""
    from substratus_tpu_torch.ops.decode_attention import decode_attention
    from substratus_tpu_torch.ops.flash_attention import flash_attention, flash_cached_attention
    from substratus_tpu_torch.ops.fused_decode import fused_decode_attention
    from substratus_tpu_torch.ops.quant import w8a8_matmul, w8a8_quantize
    from substratus_tpu_torch.ops.quant4 import q4_matmul

    return (flash_attention, flash_cached_attention, decode_attention, fused_decode_attention, q4_matmul,
            w8a8_quantize, w8a8_matmul)


def kernel_launches(engine: Engine) -> Dict[str, int]:
    """Each serving kernel counter ("function.counter") since the process
    started (or reset_kernel_launches): its wrapper's own launches plus
    those inside the engine's graph replays, which no wrapper sees."""
    out = {}
    for fn in _serving_kernels():
        for attr, value in list(vars(fn).items()):
            if attr.startswith("launches") and isinstance(value, int):
                key = f"{fn.__name__}.{attr}"
                out[key] = value + engine.replayed_launches(key)
    return out


def reset_kernel_launches() -> None:
    """Set every serving kernel counter to 0 (before a run whose launches
    are to be read on their own)."""
    for fn in _serving_kernels():
        for attr, value in list(vars(fn).items()):
            if attr.startswith("launches") and isinstance(value, int):
                setattr(fn, attr, 0)


def _stops(body: dict) -> Optional[list]:
    stop = body.get("stop")
    return [stop] if isinstance(stop, str) else stop


class _Profile:
    """/debug/profile's captures: one at a time, each on a thread of its
    own that starts torch.profiler (CPU, and CUDA activity on the card:
    every kernel of the process, the engine's graph replays included),
    waits for its end (a stop, or its cap: the seconds asked for, or the
    watchdog of a started one) and writes a Chrome trace into a fresh
    directory under PROFILE_DIR (default: the temp dir's
    substratus-profile). A capture its cap ended is over, as in JAX: the
    next start succeeds and a stop finds none running. Each capture ends
    in a ``serve.profile`` span (under the span of the request that began
    it) and a ProfileCaptureStopped event; a started one also emits
    ProfileCaptureStarted, as the JAX server does."""

    def __init__(self, engine: Engine, model_name: str = ""):
        self.engine = engine
        self.model_name = model_name
        self.lock = threading.Lock()
        self.live: Optional[dict] = None  # {"dir", "t0", "stop", "thread", "result", "blocking"} while one runs

    def _dir(self) -> str:
        base = os.environ.get("PROFILE_DIR") or os.path.join(tempfile.gettempdir(), "substratus-profile")
        os.makedirs(base, exist_ok=True)
        return tempfile.mkdtemp(prefix=time.strftime("%Y%m%d-%H%M%S-"), dir=base)

    def start(self, cap_s: float, blocking: bool = False) -> dict:
        """Start a capture that ends after cap_s, or at stop() unless it is
        `blocking`; 409 while one runs, 500 when the profiler cannot
        start."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with self.lock:
            if self.live is not None:
                raise HTTPError(409, "a profile capture is already running")
            activities = [ProfilerActivity.CPU]
            if self.engine.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            live = {"dir": self._dir(), "t0": time.perf_counter(), "stop": threading.Event(), "result": {},
                    "blocking": blocking}
            started = threading.Event()
            parent = tracer.current_context()

            def run():
                try:
                    prof = profile(activities=activities)
                    prof.start()
                except Exception as e:  # profiler backends raise anything: a 500 with the message
                    live["result"]["error"] = f"profiler failed to start: {e}"
                    started.set()
                    return
                started.set()
                capped = not live["stop"].wait(cap_s)
                try:
                    if self.engine.device.type == "cuda":
                        torch.cuda.synchronize(self.engine.device)  # the kernels in flight reach the trace
                    prof.stop()
                    prof.export_chrome_trace(os.path.join(live["dir"], "trace.json"))
                except Exception as e:  # the capture must still be clearable; the error is in the response
                    live["result"]["stop_error"] = str(e)
                live["result"]["seconds"] = round(time.perf_counter() - live["t0"], 3)
                with tracer.span("serve.profile", parent=parent, mode="blocking" if blocking else "capture",
                                 dir=live["dir"]) as span:
                    span.set_attribute("seconds", cap_s if blocking else live["result"]["seconds"])
                EVENTS.emit("ProfileCaptureStopped", kind="Server", name=self.model_name,
                            message=f"device trace in {live['dir']}")
                if capped:  # cleared once the trace is out: the next capture starts a fresh profiler
                    with self.lock:
                        if self.live is live:
                            self.live = None

            live["thread"] = threading.Thread(target=run, name="profile", daemon=True)
            live["thread"].start()
            started.wait()
            if "error" in live["result"]:
                live["thread"].join()
                raise HTTPError(500, live["result"]["error"])
            self.live = live
            if not blocking:
                EVENTS.emit("ProfileCaptureStarted", kind="Server", name=self.model_name,
                            message=f"device trace to {live['dir']}")
            return live

    @staticmethod
    def _summary(live: dict) -> dict:
        """A finished capture's dir, seconds, errors and files."""
        live["thread"].join()
        files = sorted(os.path.join(root, n) for root, _, names in os.walk(live["dir"]) for n in names)
        return {"dir": live["dir"], **live["result"], "files": files[-10:]}

    def capture(self, seconds: float) -> dict:
        """A capture of `seconds`, ended by its cap alone; 409 while one
        runs."""
        return self._summary(self.start(seconds, blocking=True))

    def stop(self) -> dict:
        """End the started capture; its summary. 409 when none runs (a
        blocking capture is not one a stop may end, as in JAX)."""
        with self.lock:
            live = self.live
            if live is None or live["blocking"]:
                raise HTTPError(409, "no profile capture is running")
            self.live = None
        live["stop"].set()
        return self._summary(live)


class Handler(BaseHTTPRequestHandler):
    server_version = "substratus-tpu-torch"
    protocol_version = "HTTP/1.1"
    state: ServerState  # set on the subclass that Server builds

    def log_message(self, format, *args):  # quiet: one line per request is noise here
        pass

    # --- responses ------------------------------------------------------

    def _send(self, status: int, payload, content_type: Optional[str] = None, headers=None) -> None:
        if isinstance(payload, (dict, list)):
            data, content_type = json.dumps(payload).encode(), content_type or "application/json; charset=utf-8"
        else:
            data = payload if isinstance(payload, bytes) else str(payload).encode()
            content_type = content_type or "text/plain; charset=utf-8"
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        if status == 200 and self._path.startswith("/v1/"):
            # Passive load reporting: the gateway learns this replica's
            # load from the responses it already gets.
            self.send_header(LOAD_HEADER, self._load_header())
        if self._span is not None:
            self.send_header("x-trace-id", self._span.trace_id)
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self._status = status
        self.wfile.write(data)
        count_http_response(self._path, status)

    def _load_header(self) -> str:
        return LoadReport.from_snapshot(self.state.engine.load_snapshot()).to_header()

    def _route(self, routes: dict) -> None:
        split = urlsplit(self.path)
        self._path, self._query = split.path, parse_qs(split.query)
        self._committed = False  # a stream's 200 and headers are out
        self._status = 500  # until a response is sent
        self._span = None
        fn = routes.get(self._path)
        with self.state.handling():
            if not self._path.startswith(TRACED_PREFIXES):
                return self._handle(fn)
            # The trace middleware: the handler runs in a serve.http span
            # under the caller's traceparent, on this thread.
            t0 = time.perf_counter()
            self._span = tracer.span("serve.http", parent=parse_traceparent(self.headers.get("traceparent")),
                                     method=self.command, path=self._path)
            try:
                with self._span:
                    self._handle(fn)
                    self._span.set_attribute("http_status", self._status)
            finally:
                access_log.info(json.dumps({
                    "event": "http_request", "method": self.command, "path": self._path, "status": self._status,
                    "duration_ms": round((time.perf_counter() - t0) * 1e3, 3),
                    "trace_id": self._span.trace_id, "span_id": self._span.span_id}, separators=(",", ":")))

    def _handle(self, fn) -> None:
        """Run a route's handler; an error becomes its response (a last
        resort 500 as JSON, with the trace id on a traced path)."""
        try:
            if fn is None:
                raise HTTPError(404, "404: Not Found")
            fn()
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True
        except Exception as e:
            if self._committed:  # the status is sent: only the connection can end
                self.close_connection = True
            elif isinstance(e, HTTPError):
                self._send(e.status, e.body, headers=e.headers)
            else:  # last resort: a JSON 500 beats an opaque one
                body = {"error": f"{type(e).__name__}: {e}"}
                if self._span is not None:
                    body["trace_id"] = self._span.trace_id
                self._send(500, body)

    def do_GET(self):
        self._route({"/": self._root, "/loadz": self._loadz, "/metrics": self._metrics, "/v1/models": self._models,
                     "/debug/tracez": self._tracez, "/debug/requestz": self._requestz, "/debug/perfz": self._perfz,
                     "/debug/stepz": self._stepz, "/debug/slowz": self._slowz, "/debug/eventz": self._eventz})

    def do_POST(self):
        self._route({"/v1/completions": self._completions, "/v1/chat/completions": self._chat,
                     "/swapz": self._swapz, "/debug/profile": self._profile})

    def _authorize(self) -> None:
        """Gate a /debug page or /swapz with the RBAC check (TokenReview and
        SubjectAccessReview through state.authorizer); open without one."""
        authorizer = self.state.authorizer
        if authorizer is None:
            return
        status, reason = authorizer.allow(self.headers.get("Authorization"))
        if status == 200:
            return
        if status == 401:
            raise HTTPError(401, reason, {"WWW-Authenticate": "Bearer"})
        raise HTTPError(403 if status == 403 else 500, reason)

    def _json_body(self, missing_ok: bool = False):
        raw = self.rfile.read(int(self.headers.get("Content-Length") or 0))
        try:
            body = json.loads(raw or b"{}")
        except json.JSONDecodeError:
            if missing_ok:
                return {}
            raise HTTPError(400, "invalid JSON body")
        if not isinstance(body, dict):
            raise HTTPError(400, "body must be a JSON object")
        return body

    # --- GET --------------------------------------------------------------

    def _root(self) -> None:
        state = self.state
        if state.engine.error is not None:
            return self._send(500, str(state.engine.error))
        if state.draining:
            return self._send(503, "draining")
        self._send(200 if state.ready else 503, "ok")

    def _loadz(self) -> None:
        """The load report of the gateway protocol: 503 while draining (the
        gateway stops routing here without ejecting the replica)."""
        state = self.state
        snap = state.engine.load_snapshot()
        snap["model"] = state.model_name
        snap["draining"] = state.draining
        if state.engine.error is not None:
            return self._send(500, {**snap, "error": str(state.engine.error)})
        self._send(200 if state.ready and not state.draining else 503, snap)

    def _metrics(self) -> None:
        """Prometheus text: the engine gauges refreshed at scrape, then the
        whole registry (the latency histograms of serve/engine.py)."""
        eng = self.state.engine
        METRICS.set("substratus_serve_active_slots", int(eng.active.sum()))
        METRICS.set("substratus_serve_max_slots", eng.ec.max_batch)
        METRICS.set("substratus_serve_queue_depth", eng.queue.qsize())
        for k, v in list(eng.stats.items()):
            METRICS.set(f"substratus_serve_{k}", v)
        if eng.paged:
            METRICS.set("substratus_serve_kv_pages_total", eng.n_pages)
            METRICS.set("substratus_serve_kv_pages_free", eng.alloc.free_pages)
        for counter, n in kernel_launches(eng).items():
            METRICS.set("substratus_serve_kernel_launches", n, {"counter": counter})
        self._send(200, METRICS.render().encode(), METRICS_CONTENT_TYPE)

    def _models(self) -> None:
        state = self.state
        data = [{"id": state.model_name, "object": "model", "owned_by": "substratus-tpu"}]
        store = state.engine.adapters
        if store is not None:
            # Every servable tenant adapter is a model clients can name in
            # the `model` field (loaded or hot-loadable).
            loaded = set(store.loaded_ids())
            data.extend({"id": aid, "object": "model", "owned_by": "substratus-tpu", "parent": state.model_name,
                         "loaded": aid in loaded} for aid in store.available_ids())
        self._send(200, {"object": "list", "data": data})

    # --- completions --------------------------------------------------------

    def _check_admission(self) -> None:
        """A decode-role replica takes no completion (503 wrong_role: its
        requests arrive as KV migrations from the prefill tier, and a
        role-aware gateway never routes here); a draining server takes no
        new request (503: the caller retries on a live replica); an expired
        deadline is shed as 504 (decoding for a client that gave up wastes a
        slot)."""
        if self.state.engine.ec.role == "decode":
            raise _json_error(503, "decode-role replica: completions are admitted by the prefill tier", "wrong_role",
                              {"Retry-After": "1"})
        if self.state.draining:
            raise _json_error(503, "server is draining", "draining", {"Retry-After": "1"})
        remaining = deadline_remaining(parse_deadline(self.headers))
        if remaining is not None and remaining <= 0:
            raise _json_error(504, "request deadline already expired", "deadline")

    def _resolve_adapter(self, body: dict) -> Optional[str]:
        """The `model` field -> an engine adapter id: the base model's own
        name (or an absent or empty field) means none; anything else must
        be a servable adapter, or the request is a 404 before any engine
        work."""
        state = self.state
        name = body.get("model")
        if not name or name == state.model_name:
            return None
        store = state.engine.adapters
        if store is not None and store.known(str(name)):
            return str(name)
        raise _json_error(404, f"model {name!r} not found", "invalid_request_error", code="model_not_found")

    def _submit(self, prompt: str, body: dict, templated: bool = False) -> Tuple[Request, int]:
        """The request on the engine's queue, tracked, and its prompt's
        length; 404 for a model this replica does not serve, 429 with
        Retry-After when the queue is full."""
        state = self.state
        req = Request(
            prompt_tokens=state.encode_prompt(prompt, templated),
            max_tokens=int(body.get("max_tokens", 16)),
            temperature=float(body.get("temperature", 1.0)),
            top_p=float(body.get("top_p", 1.0)),
            eos_token_id=state.tokenizer.eos_id,
            adapter=self._resolve_adapter(body),
            id=uuid.uuid4().hex,
        )
        # Counted now: a request preempted on the paged pool resumes with
        # its delivered tokens appended to prompt_tokens.
        n_prompt = len(req.prompt_tokens)
        state.track_request(req, self._path)
        try:
            return state.engine.submit(req), n_prompt
        except UnknownAdapter as e:
            # The artifact vanished between the known() check and submit:
            # the same answer as _resolve_adapter's.
            state.untrack_request(req)
            raise _json_error(404, str(e), "invalid_request_error", code="model_not_found")
        except EngineOverloaded as e:
            state.untrack_request(req)
            # Bounded queue -> explicit shed: 429 + Retry-After beats a
            # queue whose wait exceeds any deadline.
            raise _json_error(429, str(e), "overloaded", {"Retry-After": str(max(1, int(e.retry_after + 0.999)))})

    def _generate(self, prompt: str, body: dict, templated: bool = False):
        """(text, prompt tokens, completion tokens, finish) of a request
        served whole. With `stop`, a bounded tail of the text is checked per
        token; on a match the engine request is cancelled (its slot frees
        at its next emit) and the text is cut before the earliest match."""
        state = self.state
        req, n_prompt = self._submit(prompt, body, templated)
        stop = _stops(body)
        tok = state.tokenizer
        ids = []
        try:
            # A match must end at the newest token; decoding the last
            # 4 * max_stop_len + 8 tokens always covers it (>= 1 byte a
            # token, <= 4 bytes a character).
            window = 4 * max((len(s) for s in stop), default=0) + 8 if stop else 0
            while (t := req.out.get(timeout=TOKEN_TIMEOUT_S)) is not None:
                ids.append(t)
                if stop and _find_stop(tok.decode(ids[-window:]), stop) is not None \
                        and _find_stop(tok.decode(ids), stop) is not None:
                    # The tail is a cheap filter; boundary effects of the
                    # decode (a stripped leading space) can make it differ
                    # from the full text's suffix, so the full text decides.
                    req.cancelled = True
                    while req.out.get(timeout=TOKEN_TIMEOUT_S) is not None:
                        pass
                    break
        finally:
            state.untrack_request(req)
        if state.engine.error is not None:
            raise HTTPError(500, str(state.engine.error))
        text = tok.decode(ids)
        if stop is not None and (cut := _find_stop(text, stop)) is not None:
            return text[:cut], n_prompt, len(ids), "stop"
        return text, n_prompt, len(ids), req.finish_reason

    def _stream(self, prompt: str, body: dict, chat: bool, templated: bool = False) -> None:
        """SSE: one chunk a generated token, then the finish chunk, the
        optional usage chunk and [DONE]. Matching runs on the full decode of
        all generated tokens (concatenated per-token decodes diverge from it
        at boundary effects); with stop sequences the stream holds back the
        last max(len(stop)) - 1 characters until more text (or the end)
        proves they begin no match, and it never sends a match or anything
        after it. A trailing partial UTF-8 codepoint waits too."""
        state = self.state
        req, n_prompt = self._submit(prompt, body, templated)
        if state.engine.error is not None:
            state.untrack_request(req)
            raise HTTPError(500, str(state.engine.error))
        stop = _stops(body)
        try:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            # The load report at the stream's start: by its end it would
            # be stale anyway. The trace id goes out with it, before any
            # token.
            self.send_header(LOAD_HEADER, self._load_header())
            if self._span is not None:
                self.send_header("x-trace-id", self._span.trace_id)
            self.end_headers()
            self._status = 200
            self.close_connection = True
            self._committed = True
            cid = f"cmpl-{uuid.uuid4().hex[:24]}"
            created = int(time.time())
            model = str(body.get("model") or state.model_name)
            tok = state.tokenizer

            def write(piece: str, finish=None, usage=None) -> None:
                if chat:
                    choice = {"index": 0, "delta": {"content": piece} if piece else {}, "finish_reason": finish}
                else:
                    choice = {"index": 0, "text": piece, "finish_reason": finish}
                obj = {"id": cid, "object": "chat.completion.chunk" if chat else "text_completion",
                       "created": created, "model": model, "choices": [] if usage else [choice]}
                if usage:
                    obj["usage"] = usage
                self.wfile.write(f"data: {json.dumps(obj)}\n\n".encode())
                self.wfile.flush()

            holdback = max(0, max((len(s) for s in stop), default=0) - 1) if stop else 0
            ids, sent, finish = [], 0, None
            while (t := req.out.get(timeout=TOKEN_TIMEOUT_S)) is not None:
                ids.append(t)
                full = tok.decode(ids)
                if stop:
                    # A new match ends in the unsent tail (plus the holdback).
                    base = max(0, sent - holdback)
                    cut = _find_stop(full[base:], stop)
                    if cut is not None:
                        cut += base
                        write(full[sent:cut] if cut > sent else "")
                        sent = max(sent, cut)
                        req.cancelled = True
                        while req.out.get(timeout=TOKEN_TIMEOUT_S) is not None:
                            pass
                        finish = "stop"
                        break
                emit_to = len(full) - holdback
                trail = 0
                while trail < 3 and emit_to - 1 - trail >= 0 and full[emit_to - 1 - trail] == "�":
                    trail += 1
                emit_to -= trail if trail < 3 else 0  # a longer run is invalid output, streamed as it is
                write(full[sent:emit_to] if emit_to > sent else "")
                sent = max(sent, emit_to)
            tail = ""
            if finish is None:
                full = tok.decode(ids)
                if stop and (cut := _find_stop(full, stop)) is not None:
                    full, finish = full[:cut], "stop"
                else:
                    # "error" when the engine died mid-stream: the committed
                    # 200 ends honestly.
                    finish = req.finish_reason
                tail = full[sent:]
            write(tail, finish)
            if (body.get("stream_options") or {}).get("include_usage"):
                write("", usage={"prompt_tokens": n_prompt, "completion_tokens": len(ids),
                                 "total_tokens": n_prompt + len(ids)})
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.flush()
            count_http_response(self._path, 200)
        except (BrokenPipeError, ConnectionResetError):
            req.cancelled = True  # the client left: free its slot
            raise
        finally:
            # Untracked after [DONE]: a drain waits for the stream's end.
            state.untrack_request(req)

    def _completions(self) -> None:
        body = self._json_body()
        prompt = body.get("prompt")
        if prompt is None:
            raise HTTPError(400, "missing 'prompt'")
        validate_body(body)
        self._check_admission()
        if isinstance(prompt, list):
            prompt = prompt[0] if prompt else ""
        METRICS.inc("substratus_serve_requests_total")
        if body.get("stream"):
            return self._stream(str(prompt), body, chat=False)
        text, n_prompt, n_gen, finish = self._generate(str(prompt), body)
        self._send(200, completion_body(self.state, text, n_prompt, n_gen, finish, model=body.get("model")))

    def _chat(self) -> None:
        body = self._json_body()
        validate_body(body)
        self._check_admission()
        prompt, templated = self.state.render_chat(body.get("messages") or [])
        METRICS.inc("substratus_serve_requests_total")
        if body.get("stream"):
            return self._stream(prompt, body, chat=True, templated=templated)
        text, n_prompt, n_gen, finish = self._generate(prompt, body, templated)
        resp = completion_body(self.state, text, n_prompt, n_gen, finish, model=body.get("model"))
        resp["object"] = "chat.completion"
        resp["choices"] = [{"index": 0, "message": {"role": "assistant", "content": text}, "finish_reason": finish}]
        self._send(200, resp)

    # --- operations ---------------------------------------------------------

    def _swapz(self) -> None:
        """Hot weight swap: load the named checkpoint and install it on the
        live engine (Engine.swap_params): no drain, no teardown, every
        captured graph kept. Body: {"checkpoint": ref, "version": optional
        int, "source": "swap"|"rollout"}."""
        state = self.state
        self._authorize()
        body = self._json_body()
        ref = body.get("checkpoint")
        if not ref or not isinstance(ref, str):
            raise HTTPError(400, "missing 'checkpoint'")
        source = str(body.get("source", "swap"))
        if source not in ("swap", "rollout"):
            raise HTTPError(400, "'source' must be 'swap' or 'rollout'")
        version = body.get("version")
        if version is not None:
            try:
                version = int(version)
            except (TypeError, ValueError):
                raise HTTPError(400, "'version' must be an integer")
        if state.checkpoint_loader is None:
            raise _json_error(501, "this replica has no checkpoint loader configured; hot swap is unavailable",
                              "swap_unavailable")
        # One swap at a time: concurrent loads would race on the version's
        # order and double the peak memory for nothing.
        with state.swap_lock:
            try:
                params = state.checkpoint_loader(ref)
                applied = state.engine.swap_params(params, version=version, source=source)
            except ValueError as e:
                # A name/shape/dtype mismatch: the engine kept the old
                # weights (409: the request conflicts with the live model).
                raise _json_error(409, str(e), "swap_rejected")
            except FileNotFoundError as e:
                raise _json_error(400, str(e), "checkpoint_not_found")
        self._send(200, {"weights_version": applied, "checkpoint": ref, "source": source})

    def _profile(self) -> None:
        """A device trace while serving: {"seconds": N} blocks N seconds
        (0 < N <= 60); {"action": "start"} / {"action": "stop"} bracket
        the traffic of interest, a watchdog ending a forgotten capture
        after 60 s."""
        self._authorize()
        body = self._json_body(missing_ok=True)
        prof = self.state.profile
        action = body.get("action")
        if action not in (None, "start", "stop"):
            raise HTTPError(400, "'action' must be start or stop")
        if action == "stop":
            return self._send(200, {"stopped": True, **prof.stop()})
        if action == "start":
            live = prof.start(PROFILE_CAP_S)
            return self._send(200, {"started": True, "dir": live["dir"], "cap_seconds": PROFILE_CAP_S})
        try:
            seconds = float(body.get("seconds", 3))
        except (TypeError, ValueError):
            raise HTTPError(400, "'seconds' must be a number")
        if not (0 < seconds <= PROFILE_CAP_S):
            raise HTTPError(400, "'seconds' must be in (0, 60]")
        out = prof.capture(seconds)
        self._send(200, {"dir": out["dir"], "seconds": seconds, "files": out["files"],
                         **{k: v for k, v in out.items() if k.endswith("error")}})

    # --- the /debug pages (the JAX server's keys and codes) -----------------

    def _tracez(self) -> None:
        """The span ring by trace: each trace's root span (no parent, or a
        parent outside the ring: a remote caller or an evicted ancestor),
        newest first, and each root name's latency buckets."""
        self._authorize()
        spans = tracer.finished()
        by_trace: dict = {}
        for s in spans:
            by_trace.setdefault(s["trace_id"], []).append(s)
        buckets = (0.01, 0.1, 1.0)  # seconds; the last bucket is +Inf

        def bucket_label(duration_us: int) -> str:
            return next((f"le_{b}s" for b in buckets if duration_us / 1e6 <= b), "gt_1s")

        traces, by_root = [], {}
        for tid, ss in by_trace.items():
            ids = {s["span_id"] for s in ss}
            root = next((s for s in ss if not s["parent_id"] or s["parent_id"] not in ids), ss[0])
            errors = [s["status"] for s in ss if s["status"] != "ok"]
            traces.append({"trace_id": tid, "root": root["name"], "start_us": root["start_us"],
                           "duration_us": root["duration_us"], "spans": len(ss),
                           "status": errors[0] if errors else "ok"})
            hist = by_root.setdefault(root["name"], {f"le_{b}s": 0 for b in buckets} | {"gt_1s": 0})
            hist[bucket_label(root["duration_us"])] += 1
        traces.sort(key=lambda tr: tr["start_us"], reverse=True)
        self._send(200, {"traces": traces[:100], "latency_buckets": by_root, "buffered_spans": len(spans),
                         "dropped_spans": tracer.dropped})

    def _requestz(self) -> None:
        """The requests in flight (where each is: a decoding slot, the
        queue, or pending), or with ?id= (a trace id or request id) one
        request's journey: a live request first, then the engine's
        finished journeys, then its slow ring; 404 when none matches."""
        self._authorize()
        state, eng = self.state, self.state.engine
        with state._lock:
            infos = list(state.inflight.values())
        wanted = (self._query.get("id") or [""])[0]
        if wanted:
            snap = None
            for info in infos:
                j = info["req"].journey
                if j is not None and wanted in (j.trace_id, info["req"].id):
                    snap = j.snapshot()
                    break
            if snap is None:
                snap = eng.journey_log.find(wanted)
            if snap is None:
                snap = next((e.get("journey") for e in eng.slow.snapshot()
                             if wanted in (e.get("trace_id"), e.get("rid"))), None)
            if snap is None:
                raise HTTPError(404, f"no journey for id {wanted!r}")
            return self._send(200, {"journey": snap, "waterfall": waterfall(snap), "chrome_trace": chrome_trace(snap)})
        now = time.time()
        # Snapshots: the scheduler thread moves these on meanwhile; a debug
        # page may be slightly stale, never wrong by a crash.
        slot_req = list(eng.slot_req)
        queued = list(eng.queue.queue)
        rows = []
        for info in infos:
            req = info["req"]
            slot = next((i for i, r in enumerate(slot_req) if r is req), None)
            if slot is not None:
                where, tokens, queue_position = "decoding", eng.slot_generated[slot], None
            else:
                pos = next((i for i, r in enumerate(queued) if r is req), None)
                where, tokens, queue_position = "queued" if pos is not None else "pending", 0, pos
            rows.append({"request_id": req.id, "endpoint": info["endpoint"], "trace_id": info["trace_id"],
                         "age_s": round(now - info["start"], 3), "state": where, "slot": slot,
                         "queue_position": queue_position, "prompt_tokens": len(req.prompt_tokens),
                         "max_tokens": req.max_tokens, "tokens_emitted": tokens})
        rows.sort(key=lambda r: r["age_s"], reverse=True)
        self._send(200, {"inflight": rows, "queue_depth": eng.queue.qsize(), "journeys": eng.journey_log.ids()})

    def _perfz(self) -> None:
        """The phase histograms (they nest: admission holds prefill holds
        sample), the first decode iteration's seconds, the latency
        quantiles, occupancy, the trainer's phases when it shares the
        process, and the engine's counters."""
        self._authorize()
        phase_re = re.compile(r'^phase="(.*)"$')

        def family(name: str) -> dict:
            out = {}
            for ls, s in METRICS.histogram_series(name).items():
                m = phase_re.match(ls) if ls else None
                quantiles = {}
                for q in (0.5, 0.9, 0.99):
                    v = quantile_from_buckets(s["buckets"], q)
                    quantiles[f"p{int(q * 100)}_s"] = None if v is None else round(v, 6)
                out[m.group(1) if m else (ls or "all")] = {
                    "count": s["count"], "sum_s": round(s["sum"], 6),
                    "mean_s": round(s["sum"] / s["count"], 6) if s["count"] else None, **quantiles}
            return out

        eng = self.state.engine
        self._send(200, {
            "phases": family("substratus_serve_phase_seconds"),
            "first_compile_seconds": METRICS.get("substratus_serve_first_compile_seconds"),
            "latencies": {short: family(f"substratus_serve_{short}_seconds")
                          for short in ("ttft", "inter_token", "queue_wait")},
            "occupancy": family("substratus_serve_batch_occupancy_ratio"),
            "train_phases": family("substratus_train_phase_seconds"),
            "engine": {"active_slots": int(eng.active.sum()), "max_slots": eng.ec.max_batch,
                       "queue_depth": eng.queue.qsize(), "kv_layout": "paged" if eng.paged else "dense",
                       "stats": dict(eng.stats)},
        })

    def _stepz(self) -> None:
        """The engine's step timeline as Chrome-trace JSON (load it in
        chrome://tracing or Perfetto), its otherData with the lifetime
        bubble totals and the floor estimate."""
        self._authorize()
        eng = self.state.engine
        tl = eng.timeline
        body = tl.chrome_trace()
        body["otherData"]["bubble"] = tl.bubble_totals()
        floor = tl.floor_estimate()
        body["otherData"]["floor_estimate_s"] = round(floor, 6) if floor is not None else None
        body["otherData"]["configured_step_floor_s"] = eng.ec.step_floor_s
        self._send(200, body)

    def _slowz(self) -> None:
        """The SLO-breaching journeys and the TTFT and inter-token
        histograms' exemplar trace ids (each a /debug/requestz?id=)."""
        self._authorize()
        eng = self.state.engine
        self._send(200, {"slow": eng.slow.snapshot(), "total_breaching": eng.slow.total, "slo": eng.slo.snapshot(),
                         "exemplars": {short: METRICS.exemplars(f"substratus_serve_{short}_seconds")
                                       for short in ("ttft", "inter_token")}})

    def _eventz(self) -> None:
        """The event recorder's newest 100 (count-deduplicated)."""
        self._authorize()
        self._send(200, {"events": EVENTS.recent(100), "dropped": EVENTS.dropped})


def drain(state: ServerState, grace_s: float = 30.0, poll_s: float = 0.1) -> bool:
    """Graceful shutdown's core: readiness off (new requests 503, /loadz
    fails, so the gateway stops routing here), then wait for the requests
    in flight, SSE streams included, to finish and their handlers to write
    their responses, up to `grace_s`. True when everything drained in
    time."""
    state.draining = True
    deadline = time.monotonic() + grace_s
    while (state.inflight or state.handlers) and time.monotonic() < deadline:
        time.sleep(poll_s)
    return not (state.inflight or state.handlers)


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # Closing never waits for connection threads: an idle keep-alive
    # connection would hold it forever (drain() waits for the handlers).
    block_on_close = False


class Server:
    """The HTTP server and its engine, started and stopped together."""

    def __init__(self, state: ServerState, host: str = "0.0.0.0", port: int = 8080,
                 drain_grace_s: Optional[float] = None):
        handler = type("BoundHandler", (Handler,), {"state": state})
        self.state = state
        self.drain_grace_s = drain_grace_s
        self.httpd = _HTTPServer((host, port), handler)
        self._thread: Optional[threading.Thread] = None
        # What else the replica runs, closed after the engine stops (a
        # disaggregated tier's transfer listener or handoff manager).
        self.closers: List[Callable[[], None]] = []

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> "Server":
        """Serve on a background thread (tests, chip_smoke.py)."""
        self._thread = threading.Thread(target=self.httpd.serve_forever, name="http", daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> bool:
        """Serve until SIGTERM or SIGINT (from the main thread), then drain:
        readiness fails first, in-flight streams finish (up to the grace:
        drain_grace_s, else SUBSTRATUS_DRAIN_GRACE, else 30 s), then the
        listener closes and the engine stops last. True when everything
        drained within the grace."""
        grace = self.drain_grace_s
        if grace is None:
            grace = float(os.environ.get("SUBSTRATUS_DRAIN_GRACE", 30))
        stop = threading.Event()
        previous = {sig: signal.signal(sig, lambda *_: stop.set()) for sig in (signal.SIGTERM, signal.SIGINT)}
        try:
            self.start()
            while not stop.wait(0.5):
                if getattr(self.state.engine, "sync", None) is not None and self.state.engine.error is not None:
                    break  # a gang's leader: the gang failed under it (a collective), nothing to serve
            clean = drain(self.state, grace_s=grace)
            print(f"drained {'cleanly' if clean else 'at the deadline'} ({self.state.handlers} handlers still "
                  "running)", flush=True)
        finally:
            for sig, handler in previous.items():
                signal.signal(sig, handler)
            self.stop()
        return clean

    def stop(self) -> None:
        if self._thread is not None:
            self.httpd.shutdown()
            self._thread.join(timeout=10)
            self._thread = None
        self.httpd.server_close()
        # The engine last: its scheduler must outlive every stream it feeds.
        self.state.engine.stop()
        for close in self.closers:
            close()
