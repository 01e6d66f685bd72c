"""OpenAI-compatible HTTP server over the port's Engine, on the standard
library alone (port of the HTTP contract of substratus_tpu/serve/server.py,
which is built on aiohttp).

Container contract: ``GET /`` is readiness (200 once the engine runs, 500
with the error once it died); ``POST /v1/completions`` takes
``{prompt, max_tokens, temperature, top_p, stream}`` and answers with the
OpenAI ``text_completion`` body, ``usage`` included, or -- with
``stream: true`` -- one SSE ``data:`` chunk per generated token, a last
chunk carrying the finish reason, and ``data: [DONE]``. With
``stream_options: {"include_usage": true}`` a usage chunk precedes
``[DONE]``, as in OpenAI's API.

Each connection runs on its own thread (``ThreadingHTTPServer``) and
blocks on its request's token queue; the engine's one scheduler thread
does all the device work.
"""
from __future__ import annotations

import json
import math
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

from substratus_tpu_torch.serve.engine import Engine, EngineOverloaded, Request
from substratus_tpu_torch.serve.tokenizer import ByteTokenizer

# Per-token wait before a stream is declared dead (the engine puts a
# terminal None on every request, error included, so this only guards a
# wedged device).
TOKEN_TIMEOUT_S = 600.0


class BadRequest(ValueError):
    """A request body the server refuses with 400."""


class ServerState:
    def __init__(self, engine: Engine, tokenizer: ByteTokenizer, model_name: str):
        self.engine = engine
        self.tokenizer = tokenizer
        self.model_name = model_name


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


def parse_body(raw: bytes) -> dict:
    """Decode and validate a /v1/completions body (the JAX server's
    _validate_body rules for the knobs this port serves)."""
    try:
        body = json.loads(raw or b"{}")
    except json.JSONDecodeError:
        raise BadRequest("invalid JSON body")
    if not isinstance(body, dict):
        raise BadRequest("body must be a JSON object")
    if body.get("prompt") is None:
        raise BadRequest("missing 'prompt'")
    if body.get("stop") is not None:
        raise BadRequest("'stop' is not served by this port yet")
    if "max_tokens" in body:
        try:
            v = int(body["max_tokens"])
        except (TypeError, ValueError):
            raise BadRequest("'max_tokens' must be an integer")
        if v < 1:
            raise BadRequest("'max_tokens' must be >= 1")
    for key in ("temperature", "top_p"):
        if key in body:
            try:
                v = float(body[key])
            except (TypeError, ValueError):
                raise BadRequest(f"'{key}' must be a number")
            if not math.isfinite(v):
                raise BadRequest(f"'{key}' must be finite")
            if key == "temperature" and v < 0:
                raise BadRequest("'temperature' must be >= 0")
            if key == "top_p" and not (0 < v <= 1):
                raise BadRequest("'top_p' must be in (0, 1]")
    return body


def _text_so_far(tokenizer: ByteTokenizer, ids) -> str:
    """Decoded text of `ids`, less a trailing partial UTF-8 codepoint
    (at most 3 replacement chars; a longer run is invalid output)."""
    full = tokenizer.decode(ids)
    trail = 0
    while trail < 3 and len(full) > trail and full[-1 - trail] == "�":
        trail += 1
    return full[: len(full) - trail] if trail < 3 else full


class Handler(BaseHTTPRequestHandler):
    server_version = "substratus-tpu-torch"
    protocol_version = "HTTP/1.1"
    state: ServerState  # set on the subclass that Server builds

    def log_message(self, format, *args):  # quiet: one line per request is noise here
        pass

    def _send(self, status: int, payload, content_type="application/json", headers=None):
        data = payload if isinstance(payload, bytes) else (
            json.dumps(payload).encode() if content_type == "application/json" else str(payload).encode()
        )
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _error(self, status: int, message: str, kind: str, headers=None):
        self._send(status, {"error": {"message": message, "type": kind}}, headers=headers)

    def do_GET(self):
        if self.path != "/":
            return self._error(404, f"no route {self.path}", "not_found")
        err = self.state.engine.error
        if err is not None:
            return self._send(500, str(err), "text/plain")
        return self._send(200, "ok", "text/plain")

    def do_POST(self):
        if self.path != "/v1/completions":
            return self._error(404, f"no route {self.path}", "not_found")
        try:
            body = parse_body(self.rfile.read(int(self.headers.get("Content-Length") or 0)))
        except BadRequest as e:
            return self._error(400, str(e), "invalid_request_error")
        prompt = body["prompt"]
        if isinstance(prompt, list):
            prompt = prompt[0] if prompt else ""
        state = self.state
        req = Request(
            prompt_tokens=state.tokenizer.encode(str(prompt)),
            max_tokens=int(body.get("max_tokens", 16)),
            temperature=float(body.get("temperature", 1.0)),
            top_p=float(body.get("top_p", 1.0)),
            eos_token_id=state.tokenizer.eos_id,
        )
        # Counted now: a request preempted on the paged pool resumes with
        # its delivered tokens appended to prompt_tokens.
        n_prompt = len(req.prompt_tokens)
        try:
            state.engine.submit(req)
        except EngineOverloaded as e:
            return self._error(429, str(e), "overloaded",
                               {"Retry-After": str(max(1, math.ceil(e.retry_after)))})
        if body.get("stream"):
            return self._stream(req, body, n_prompt)
        ids, finish = self._collect(req)
        if state.engine.error is not None:
            return self._error(500, str(state.engine.error), "engine_error")
        self._send(200, completion_body(
            state, state.tokenizer.decode(ids), n_prompt, len(ids), finish,
            model=body.get("model"),
        ))

    @staticmethod
    def _collect(req: Request) -> Tuple[list, str]:
        ids = []
        while True:
            tok = req.out.get(timeout=TOKEN_TIMEOUT_S)
            if tok is None:
                return ids, req.finish_reason
            ids.append(tok)

    def _stream(self, req: Request, body: dict, n_prompt: int) -> None:
        """SSE: one chunk per generated token (its text may be empty, e.g.
        a non-byte id or half a codepoint), then the finish chunk, the
        optional usage chunk and [DONE]."""
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        self.close_connection = True
        cid = f"cmpl-{uuid.uuid4().hex[:24]}"
        created = int(time.time())
        model = str(body.get("model") or self.state.model_name)
        tokenizer = self.state.tokenizer

        def chunk(text: str, finish=None, usage=None) -> None:
            obj = {"id": cid, "object": "text_completion", "created": created, "model": model,
                   "choices": [] if usage else [{"index": 0, "text": text, "finish_reason": finish}]}
            if usage:
                obj["usage"] = usage
            self.wfile.write(f"data: {json.dumps(obj)}\n\n".encode())
            self.wfile.flush()

        ids, sent = [], 0
        while True:
            tok = req.out.get(timeout=TOKEN_TIMEOUT_S)
            if tok is None:
                break
            ids.append(tok)
            text = _text_so_far(tokenizer, ids)
            chunk(text[sent:])
            sent = max(sent, len(text))
        full = tokenizer.decode(ids)
        chunk(full[sent:], req.finish_reason)
        if (body.get("stream_options") or {}).get("include_usage"):
            chunk("", usage={"prompt_tokens": n_prompt, "completion_tokens": len(ids),
                             "total_tokens": n_prompt + len(ids)})
        self.wfile.write(b"data: [DONE]\n\n")
        self.wfile.flush()


class Server:
    """The HTTP server and its engine, started and stopped together."""

    def __init__(self, state: ServerState, host: str = "0.0.0.0", port: int = 8080):
        handler = type("BoundHandler", (Handler,), {"state": state})
        self.state = state
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> "Server":
        """Serve on a background thread (tests, chip_smoke.py)."""
        self._thread = threading.Thread(target=self.httpd.serve_forever, name="http", daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        try:
            self.httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    def stop(self) -> None:
        if self._thread is not None:
            self.httpd.shutdown()
            self._thread.join(timeout=10)
            self._thread = None
        self.httpd.server_close()
        self.state.engine.stop()
