"""The port's trace middleware, /debug pages and RBAC gate
(substratus_tpu_torch/serve/server.py) against the JAX server's
(substratus_tpu/serve/server.py), on the CPU.

As tests/test_torch_surface.py does it: tiny float32 weights carried across
by bridge.params_from_jax behind each package's engine, the JAX app through
aiohttp's TestClient and the port's server over real HTTP, the same calls
in the same order. Every response on /v1/ and /debug/ carries x-trace-id,
the caller's traceparent's trace id (whole, streamed and error responses;
a malformed header starts a new trace), and no probe or scrape does; each
/debug page answers with the JAX keys and status codes, open without an
authorizer and, with a stub authorizer, 401 (with WWW-Authenticate), 403
and 500 where JAX answers them, /swapz and /debug/profile too; the access
log carries the trace id. Then serve.main as a child under TRACEPARENT
writes serve.start (and the requests' spans) to SUBSTRATUS_TRACE_EXPORT.
"""
import json
import logging
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import pytest

from substratus_tpu.serve.engine import Engine as JEngine
from substratus_tpu.serve.engine import EngineConfig as JEngineConfig
from substratus_tpu.serve.server import ServerState as JServerState
from substratus_tpu.serve.tokenizer import ByteTokenizer as JByteTokenizer
from substratus_tpu_torch.observability.tracing import tracer
from substratus_tpu_torch.serve.engine import Engine, EngineConfig
from substratus_tpu_torch.serve.server import Server, ServerState
from substratus_tpu_torch.serve.tokenizer import ByteTokenizer
from test_torch_surface import EC, J_CFG, _one_torch_thread, jax_http, port_http, weights  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
TRACE = "ab" * 16
TP = {"traceparent": f"00-{TRACE}-{'cd' * 8}-01"}
DEBUG_PAGES = ("/debug/tracez", "/debug/requestz", "/debug/perfz", "/debug/stepz", "/debug/slowz", "/debug/eventz")


class StubAuthorizer:
    """allow() by bearer token: ok 200, no 403, boom 500 (a failed review),
    anything else 401, as MetricsAuthorizer answers."""

    def allow(self, header):
        verdicts = {"Bearer ok": (200, "ok"), "Bearer no": (403, "user nobody not allowed"),
                    "Bearer boom": (500, "tokenreview failed: down")}
        return verdicts.get(header, (401, "missing bearer token"))


def make_pair(authorizer=None, **ec):
    j_params, t_params = weights(0)
    ec = {**EC, **ec}
    jeng = JEngine(J_CFG, j_params, JEngineConfig(**ec))
    teng = Engine(t_params.cfg, t_params, EngineConfig(**ec), device="cpu")
    jeng.start()
    srv = Server(ServerState(teng, ByteTokenizer(), "tiny", authorizer=authorizer), host="127.0.0.1",
                 port=0).start()
    teng.start()
    return SimpleNamespace(jeng=jeng, teng=teng, srv=srv,
                           jstate=JServerState(jeng, JByteTokenizer(), "tiny", authorizer=authorizer))


@pytest.fixture(scope="module")
def pair():
    p = make_pair()
    yield p
    p.jeng.stop()
    p.srv.stop()


@pytest.fixture(scope="module")
def gated():
    p = make_pair(StubAuthorizer())
    yield p
    p.jeng.stop()
    p.srv.stop()


def both(pair, calls):
    return jax_http(pair.jstate, calls), port_http(pair.srv, calls)


def test_trace_id_on_whole_streamed_and_error_responses(pair):
    """x-trace-id is the traceparent's trace id on a whole completion, a
    stream (sent with its headers), a chat, 400s, a 404 under /v1/ and
    /v1/models; / and /metrics stay untraced."""
    calls = [("POST", "/v1/completions", {"prompt": "trace me", "max_tokens": 4, "temperature": 0}, TP),
             ("POST", "/v1/completions", {"prompt": "trace me", "max_tokens": 4, "stream": True}, TP),
             ("POST", "/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 2}, TP),
             ("POST", "/v1/completions", b"{not json", TP),
             ("POST", "/v1/completions", {"max_tokens": 2}, TP),
             ("POST", "/v1/completions", {"prompt": "x", "top_p": 5}, TP),
             ("POST", "/v1/nothing", {}, TP),
             ("GET", "/v1/models", None, TP),
             ("GET", "/", None, TP),
             ("GET", "/metrics", None, TP)]
    j, t = both(pair, calls)
    assert [s for s, _, _ in t] == [s for s, _, _ in j] == [200, 200, 200, 400, 400, 400, 404, 200, 200, 200]
    for (js, jh, _), (ts, th, _), call in zip(j, t, calls):
        traced = call[1].startswith("/v1/")
        assert (th.get("x-trace-id") == TRACE) == (jh.get("x-trace-id") == TRACE) == traced, call
    assert t[1][2].rstrip().endswith("data: [DONE]")


def test_malformed_traceparent_starts_a_new_trace(pair):
    bad = {"traceparent": "00-zz-" + "cd" * 8 + "-01"}
    j, t = both(pair, [("POST", "/v1/completions", {"prompt": "x", "max_tokens": 2}, bad),
                       ("POST", "/v1/completions", {"prompt": "x", "max_tokens": 2}, None)])
    for (_, jh, _), (_, th, _) in zip(j, t):
        for tid in (jh["x-trace-id"], th["x-trace-id"]):
            assert len(tid) == 32 and int(tid, 16) and tid != TRACE
    assert t[0][1]["x-trace-id"] != t[1][1]["x-trace-id"]


def _keys(obj, depth=2):
    """The nested key structure of a JSON object, `depth` levels down."""
    if not isinstance(obj, dict) or depth == 0:
        return type(obj).__name__
    return {k: _keys(v, depth - 1) for k, v in obj.items()}


def test_debug_pages_answer_with_jax_keys(pair):
    """After traffic, each /debug page's status and keys are the JAX
    server's (two levels down where the page's keys are fixed: the span
    ring's roots are the process's, the engine's stats and the phases'
    labels the port's own); a finished request's journey by its trace id and
    by its request id, and 404 for an unknown id."""
    traffic = [("POST", "/v1/completions", {"prompt": f"journey {i}", "max_tokens": 3, "temperature": 0},
                {"traceparent": f"00-{i:032x}-{'cd' * 8}-01"}) for i in range(1, 4)]
    j, t = both(pair, traffic + [(None, None, 0.3, None)] + [("GET", p, None, None) for p in DEBUG_PAGES]
                + [("GET", f"/debug/requestz?id={1:032x}", None, None),
                   ("GET", "/debug/requestz?id=nope", None, None)])
    j, t = j[4:], t[4:]
    assert [s for s, _, _ in t] == [s for s, _, _ in j] == [200] * 7 + [404]
    pages = dict(zip(DEBUG_PAGES + ("journey",), zip([json.loads(x[2]) for x in j[:7]],
                                                      [json.loads(x[2]) for x in t[:7]])))
    for name, (jb, tb) in pages.items():
        assert set(tb) == set(jb), name
    for name in ("/debug/slowz", "/debug/eventz", "journey"):
        jb, tb = pages[name]
        assert {k: _keys(v, 1) for k, v in tb.items()} == {k: _keys(v, 1) for k, v in jb.items()}, name
    jb, tb = pages["/debug/stepz"]
    assert set(tb["otherData"]) == set(jb["otherData"]) and set(tb["otherData"]["bubble"]) == set(
        jb["otherData"]["bubble"])
    assert tb["otherData"]["bubble"]["iterations"] > 0
    jb, tb = pages["/debug/perfz"]
    assert set(tb["latencies"]) == set(jb["latencies"]) and set(tb["engine"]) == set(jb["engine"])
    assert set(tb["phases"]) >= {"admission", "prefill", "sample", "decode"}
    jb, tb = pages["/debug/tracez"]
    assert set(tb["traces"][0]) == set(jb["traces"][0]) and {tr["trace_id"] for tr in tb["traces"]} >= {
        f"{i:032x}" for i in range(1, 4)}
    jb, tb = pages["journey"]
    assert tb["journey"]["trace_id"] == jb["journey"]["trace_id"] == f"{1:032x}"
    clocked = ("drain", "emit", "slo_breach")  # a first request's TTFT breach follows the machine's load
    assert [e[1] for e in tb["journey"]["events"] if e[1] not in clocked] == [
        e[1] for e in jb["journey"]["events"] if e[1] not in clocked]
    rid = tb["journey"]["rid"]
    (s, _, body), = port_http(pair.srv, [("GET", f"/debug/requestz?id={rid}", None, None)])
    assert s == 200 and json.loads(body)["journey"]["trace_id"] == f"{1:032x}"
    assert t[7][2] == j[7][2] == "no journey for id 'nope'"


def test_requestz_shows_a_request_in_flight():
    """A stream decoding while /debug/requestz is read: its row, with the
    JAX keys, says where it is."""
    p = make_pair(step_floor_s=0.02)
    try:
        body = {"prompt": "slow", "max_tokens": 40, "temperature": 0, "stream": True}
        req = urllib.request.Request(f"http://127.0.0.1:{p.srv.port}/v1/completions", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json", **TP})
        with urllib.request.urlopen(req, timeout=120) as stream:
            stream.readline()
            (status, _, text), = port_http(p.srv, [("GET", "/debug/requestz", None, None)])
            stream.read()
    finally:
        p.jeng.stop()
        p.srv.stop()
    rows = json.loads(text)["inflight"]
    assert status == 200 and len(rows) == 1
    assert set(rows[0]) == {"request_id", "endpoint", "trace_id", "age_s", "state", "slot", "queue_position",
                            "prompt_tokens", "max_tokens", "tokens_emitted"}
    assert rows[0]["state"] == "decoding" and rows[0]["trace_id"] == TRACE and rows[0]["endpoint"] == "/v1/completions"


@pytest.mark.parametrize("token,status", [(None, 401), ("Bearer no", 403), ("Bearer boom", 500), ("Bearer ok", 200)])
def test_debug_pages_gated_as_jax(gated, token, status):
    """With an authorizer every /debug page answers its verdict, a 401 with
    WWW-Authenticate: Bearer, as the JAX server's gate does."""
    headers = {"Authorization": token} if token else None
    j, t = both(gated, [("GET", p, None, headers) for p in DEBUG_PAGES])
    for (js, jh, jt), (ts, th, tt), page in zip(j, t, DEBUG_PAGES):
        assert ts == js == status, page
        if status != 200:
            assert tt == jt, page
        assert th.get("WWW-Authenticate") == jh.get("WWW-Authenticate") == ("Bearer" if status == 401 else None)


def test_swapz_and_profile_gated_as_jax(gated):
    """/swapz and /debug/profile are behind the same gate: refused before
    their bodies are read; let through, /swapz reaches its own checks (400
    for no checkpoint, 501 without a loader)."""
    calls = [("POST", "/swapz", {"checkpoint": "/x"}, None),
             ("POST", "/swapz", {"checkpoint": "/x"}, {"Authorization": "Bearer no"}),
             ("POST", "/swapz", {}, {"Authorization": "Bearer ok"}),
             ("POST", "/swapz", {"checkpoint": "/x"}, {"Authorization": "Bearer ok"}),
             ("POST", "/debug/profile", {"seconds": 1}, None),
             ("POST", "/debug/profile", {"action": "sideways"}, {"Authorization": "Bearer ok"})]
    j, t = both(gated, calls)
    assert [s for s, _, _ in t] == [s for s, _, _ in j] == [401, 403, 400, 501, 401, 400]
    assert [x[2] for x in t[:3]] == [x[2] for x in j[:3]]


def test_profile_capture_records_its_span_and_events(pair):
    """A blocking and a started capture: serve.profile spans (blocking and
    capture) and the ProfileCapture* events on /debug/eventz."""
    calls = [("POST", "/debug/profile", {"seconds": 0.2}, TP),
             ("POST", "/debug/profile", {"action": "start"}, None),
             ("POST", "/debug/profile", {"action": "stop"}, None),
             ("GET", "/debug/eventz", None, None)]
    t = port_http(pair.srv, calls)
    assert [s for s, _, _ in t] == [200] * 4
    reasons = [e["reason"] for e in json.loads(t[3][2])["events"]]
    assert "ProfileCaptureStarted" in reasons and "ProfileCaptureStopped" in reasons
    modes = {s["attributes"]["mode"]: s for s in tracer.finished() if s["name"] == "serve.profile"}
    assert set(modes) == {"blocking", "capture"} and modes["blocking"]["trace_id"] == TRACE


def test_access_log_line_carries_the_trace(pair, caplog):
    with caplog.at_level(logging.INFO, logger="substratus.serve.access"):
        port_http(pair.srv, [("POST", "/v1/completions", {"prompt": "log", "max_tokens": 2}, TP),
                             ("GET", "/loadz", None, TP)])
        time.sleep(0.2)
    # (a line of the test before may land late: a handler logs after its response is out)
    lines = [json.loads(r.getMessage()) for r in caplog.records if r.name == "substratus.serve.access"]
    lines = [ln for ln in lines if ln["path"] in ("/v1/completions", "/loadz")]
    assert len(lines) == 1  # /loadz is untraced
    assert set(lines[0]) == {"event", "method", "path", "status", "duration_ms", "trace_id", "span_id"}
    assert lines[0]["trace_id"] == TRACE and lines[0]["status"] == 200 and lines[0]["path"] == "/v1/completions"


def test_serve_main_exports_its_spans_under_traceparent(tmp_path):
    """serve.main as a child under TRACEPARENT with SUBSTRATUS_TRACE_EXPORT:
    at its exit after SIGTERM the export holds serve.start under that trace,
    and a request's serve.http and engine.prefill spans under its own."""
    export = tmp_path / "spans.jsonl"
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1", "TRACEPARENT": f"00-{'12' * 16}-{'34' * 8}-01",
           "SUBSTRATUS_TRACE_EXPORT": str(export)}
    child = subprocess.Popen([sys.executable, "-m", "substratus_tpu_torch.serve.main", "--config", "tiny", "--device",
                              "cpu", "--params", "", "--host", "127.0.0.1", "--port", "0"],
                             cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = child.stdout.readline()
        assert line.startswith("serving tiny on 127.0.0.1:"), line
        srv = SimpleNamespace(port=int(line.split("127.0.0.1:")[1].split()[0]))
        (status, headers, _), = port_http(srv, [("POST", "/v1/completions", {"prompt": "x", "max_tokens": 3}, TP)])
        assert status == 200 and headers["x-trace-id"] == TRACE
        child.send_signal(signal.SIGTERM)
        threading.Thread(target=child.stdout.read, daemon=True).start()
        assert child.wait(timeout=120) == 0
    finally:
        if child.poll() is None:
            child.kill()
    spans = [json.loads(ln) for ln in export.read_text().splitlines()]
    start = [s for s in spans if s["name"] == "serve.start"]
    assert len(start) == 1 and start[0]["trace_id"] == "12" * 16 and start[0]["parent_id"] == "34" * 8
    http = next(s for s in spans if s["name"] == "serve.http")
    prefill = next(s for s in spans if s["name"] == "engine.prefill")
    assert http["trace_id"] == prefill["trace_id"] == TRACE and prefill["parent_id"] == http["span_id"]
    assert http["attributes"]["http_status"] == 200
