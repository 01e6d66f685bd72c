"""The port's serving surface (substratus_tpu_torch/serve/server.py) against
the JAX server (substratus_tpu/serve/server.py), on the CPU.

Tiny float32 llama weights from a seed, carried across by
bridge.params_from_jax, behind each package's engine on its default (the
paged pool); the JAX app is driven through aiohttp's TestClient, the
port's server over real HTTP, with the same request bodies in the same
order, and what both return is compared with `id` and `created` left
out: completions with `stop` (a string, a list, a sequence split across
tokens), streamed and not, with the port's slot free afterwards; chat
through the generic transcript; /v1/models and an unknown `model`; every
invalid knob of the JAX server's _validate_body; /loadz; 429, 504 and
503 while draining; the x-substratus-load header through both parsers.
Request.cancelled frees its slot and pages on every scheduler (plain,
lookup, draft; overlapped and synchronous). Then serve.main as a child
process drains on SIGTERM during a stream.
"""
import asyncio
import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest
import torch

from substratus_tpu.gateway.loadreport import LoadReport as JLoadReport
from substratus_tpu.models import llama as jllama
from substratus_tpu.serve.engine import Engine as JEngine
from substratus_tpu.serve.engine import EngineConfig as JEngineConfig
from substratus_tpu.serve.engine import Request as JRequest
from substratus_tpu.serve.server import ServerState as JServerState
from substratus_tpu.serve.tokenizer import ByteTokenizer as JByteTokenizer
from substratus_tpu_torch.bridge import params_from_jax
from substratus_tpu_torch.gateway.loadreport import HEADER, LoadReport
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.serve.engine import Engine, EngineConfig, Request
from substratus_tpu_torch.serve.server import Server, ServerState
from substratus_tpu_torch.serve.tokenizer import ByteTokenizer

REPO = Path(__file__).resolve().parents[1]
EOS = 257
J_CFG = jllama.CONFIGS["tiny"].replace(vocab_size=258, dtype=jnp.float32)
T_CFG = llama.CONFIGS["tiny"].replace(vocab_size=258, dtype=torch.float32)
EC = {"max_batch": 4, "max_seq_len": 96, "eos_token_id": EOS, "max_queue": 8}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread keeps torch's worker
    pool from spinning on cores that timing-sensitive tests share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def weights(seed: int = 0, j_cfg=J_CFG, t_cfg=T_CFG):
    """(JAX params, the port's Llama with the same values) from a seed."""
    j_params = jllama.init_params(j_cfg, jax.random.key(seed))
    t_params = llama.Llama(t_cfg, device="cpu")
    t_params.load_state_dict(params_from_jax(jax.device_get(j_params)))
    return j_params, t_params


def jax_http(state, calls):
    """Each (method, path, body, headers) through the JAX app in order:
    [(status, headers, text)]. A dict or list body goes as JSON, bytes as
    they are; a method of None sleeps `body` seconds and answers None."""
    from aiohttp.test_utils import TestClient, TestServer

    from substratus_tpu.serve.server import build_app

    async def go():
        out = []
        async with TestClient(TestServer(build_app(state))) as client:
            for method, path, body, headers in calls:
                if method is None:
                    await asyncio.sleep(body)
                    out.append(None)
                    continue
                data = json.dumps(body).encode() if isinstance(body, (dict, list)) else body
                r = await client.request(method, path, data=data,
                                         headers={"Content-Type": "application/json", **(headers or {})})
                out.append((r.status, dict(r.headers), await r.text()))
        return out

    return asyncio.run(go())


def port_http(srv, calls):
    """The same calls to the port's server over HTTP."""
    out = []
    for method, path, body, headers in calls:
        if method is None:
            time.sleep(body)
            out.append(None)
            continue
        data = json.dumps(body).encode() if isinstance(body, (dict, list)) else body
        req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}", data=data, method=method,
                                     headers={"Content-Type": "application/json", **(headers or {})})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                out.append((r.status, dict(r.headers), r.read().decode()))
        except urllib.error.HTTPError as e:
            out.append((e.code, dict(e.headers), e.read().decode()))
    return out


def both(pair, calls):
    return jax_http(pair.jstate, calls), port_http(pair.srv, calls)


def sse(text: str, chat: bool = False):
    """(the streamed pieces, the finish reason, the usage chunk's usage) of
    an SSE body that ends in [DONE]."""
    lines = [ln for ln in text.split("\n") if ln.startswith("data: ")]
    assert lines[-1] == "data: [DONE]"
    pieces, finish, usage = [], None, None
    for ln in lines[:-1]:
        obj = json.loads(ln[6:])
        usage = obj.get("usage") or usage
        for ch in obj["choices"]:
            pieces.append(ch["delta"].get("content", "") if chat else ch["text"])
            finish = ch["finish_reason"] or finish
    return pieces, finish, usage


def result(status_headers_text, chat: bool = False):
    """(text, finish_reason, usage) of a non-streamed completion."""
    status, _, text = status_headers_text
    assert status == 200, text
    body = json.loads(text)
    choice = body["choices"][0]
    return (choice["message"]["content"] if chat else choice["text"]), choice["finish_reason"], body["usage"]


def wait_idle(*engines) -> None:
    """Until no slot of any engine decodes (a released slot's terminal None
    reaches its consumer just before the release)."""
    deadline = time.time() + 60
    while any(e.active.any() for e in engines) and time.time() < deadline:
        time.sleep(0.01)
    assert not any(e.active.any() for e in engines)


def serve_pair(j_params, t_params, j_cfg=J_CFG, j_tok=None, t_tok=None, **ec):
    """A started JAX engine behind its app's state and a started port engine
    behind its server, on the same weights, knobs and tokenizer (bytes by
    default)."""
    ec = {**EC, **ec}
    jeng = JEngine(j_cfg, j_params, JEngineConfig(**ec))
    teng = Engine(t_params.cfg, t_params, EngineConfig(**ec), device="cpu")
    jeng.start()
    srv = Server(ServerState(teng, t_tok or ByteTokenizer(), "tiny"), host="127.0.0.1", port=0).start()
    teng.start()
    return SimpleNamespace(jeng=jeng, teng=teng, jstate=JServerState(jeng, j_tok or JByteTokenizer(), "tiny"),
                           srv=srv)


def close_pair(pair) -> None:
    pair.jeng.stop()
    pair.srv.stop()


@pytest.fixture(scope="module")
def pair():
    j_params, t_params = weights(0)
    p = serve_pair(j_params, t_params)
    yield p
    close_pair(p)


PROMPT = "The quick brown fox"


def _stop_at(full: str) -> int:
    """The first position from 2 on where three characters of the reply
    are real text (no replacement character)."""
    i = next(i for i in range(2, len(full) - 3) if "�" not in full[i:i + 3])
    return i


@pytest.mark.parametrize("kind", ["string", "list", "split"])
def test_stop_matches_jax(pair, kind):
    """The text cut before the earliest match, finish "stop", the usage of
    the tokens read up to the match; streamed: the same text, no chunk
    ever holding the stop sequence; the port's slot and pages free."""
    base = {"prompt": PROMPT, "max_tokens": 32, "temperature": 0}
    (jfull,), (tfull,) = both(pair, [("POST", "/v1/completions", base, None)])
    full, _, usage_full = result(tfull)
    assert result(jfull) == result(tfull)
    i = _stop_at(full)
    stop = {"string": full[i], "list": ["☃ never", full[i + 1:i + 3]], "split": full[i:i + 3]}[kind]
    stops = [stop] if isinstance(stop, str) else stop
    cut = min(full.find(s) for s in stops if s in full)
    calls = [("POST", "/v1/completions", {**base, "stop": stop}, None),
             ("POST", "/v1/completions", {**base, "stop": stop, "stream": True,
                                          "stream_options": {"include_usage": True}}, None)]
    j, t = both(pair, calls)
    got = result(t[0])
    assert got == result(j[0])
    assert got[0] == full[:cut] and got[1] == "stop" and got[2]["completion_tokens"] < usage_full["completion_tokens"]
    jpieces, jfinish, _ = sse(j[1][2])
    tpieces, tfinish, tusage = sse(t[1][2])
    assert "".join(tpieces) == "".join(jpieces) == full[:cut] and tfinish == jfinish == "stop"
    assert tusage == got[2] and len(tpieces) == tusage["completion_tokens"] + 1  # a chunk a token, then the finish
    for n in range(len(tpieces) + 1):  # no prefix of the stream holds a stop sequence
        assert not any(s in "".join(tpieces[:n]) for s in stops)
    wait_idle(pair.teng, pair.jeng)
    assert all(r is None for r in pair.teng.slot_req) and not any(pair.teng.slot_pages.pages)


def test_chat_generic_transcript_matches_jax(pair):
    """ByteTokenizer has no template: both join the messages into the
    generic transcript; streamed, the deltas join to the same text."""
    messages = [{"role": "system", "content": "Be brief."}, {"role": "user", "content": "Say hi"}]
    body = {"messages": messages, "max_tokens": 10, "temperature": 0}
    j, t = both(pair, [("POST", "/v1/chat/completions", body, None),
                       ("POST", "/v1/chat/completions", {**body, "stream": True}, None)])
    got = result(t[0], chat=True)
    assert got == result(j[0], chat=True)
    assert json.loads(t[0][2])["object"] == json.loads(j[0][2])["object"] == "chat.completion"
    assert got[2]["prompt_tokens"] == len(ByteTokenizer().encode("system: Be brief.\nuser: Say hi\nassistant:"))
    jpieces, jfinish, _ = sse(j[1][2], chat=True)
    tpieces, tfinish, _ = sse(t[1][2], chat=True)
    assert "".join(tpieces) == "".join(jpieces) == got[0] and tfinish == jfinish == got[1]
    chunk = json.loads(t[1][2].split("\n")[0][6:])
    assert chunk["object"] == "chat.completion.chunk"


def test_models_and_unknown_model_match_jax(pair):
    j, t = both(pair, [("GET", "/v1/models", None, None),
                       ("POST", "/v1/completions", {"prompt": "x", "model": "other"}, None),
                       ("POST", "/v1/completions", {"prompt": "x", "max_tokens": 2, "model": "tiny"}, None)])
    assert (t[0][0], json.loads(t[0][2])) == (j[0][0], json.loads(j[0][2])) == (
        200, {"object": "list", "data": [{"id": "tiny", "object": "model", "owned_by": "substratus-tpu"}]})
    assert (t[1][0], json.loads(t[1][2])) == (j[1][0], json.loads(j[1][2]))
    assert t[1][0] == 404 and json.loads(t[1][2])["error"]["code"] == "model_not_found"
    assert t[2][0] == j[2][0] == 200 and json.loads(t[2][2])["model"] == "tiny"


INVALID = [
    {"prompt": "x", "stop": 5}, {"prompt": "x", "stop": ["a", 1]}, {"prompt": "x", "max_tokens": "many"},
    {"prompt": "x", "max_tokens": 0}, {"prompt": "x", "temperature": "hot"}, {"prompt": "x", "temperature": -1},
    {"prompt": "x", "temperature": float("nan")}, {"prompt": "x", "top_p": "x"}, {"prompt": "x", "top_p": 0},
    {"prompt": "x", "top_p": 1.5}, {"prompt": "x", "top_p": float("inf")}, {"max_tokens": 3},
]


def test_invalid_knobs_give_400_as_in_jax(pair):
    """Every rule of the JAX server's _validate_body, on both routes, and
    a missing prompt or a body that is not JSON: 400 with its message."""
    calls = [("POST", "/v1/completions", body, None) for body in INVALID]
    calls += [("POST", "/v1/chat/completions", {k: v for k, v in body.items() if k != "prompt"}, None)
              for body in INVALID[:-1]]
    calls += [("POST", "/v1/completions", b"{not json", None), ("POST", "/v1/chat/completions", b"[", None)]
    j, t = both(pair, calls)
    assert [(s, text) for s, _, text in t] == [(s, text) for s, _, text in j]
    assert {s for s, _, _ in t} == {400}


def test_loadz_keys_and_values_match_jax(pair):
    """After the same requests: the JAX snapshot's keys, and its values
    where they do not depend on the clock (the SLO sketches' counts of
    first tokens, the thresholds)."""
    wait_idle(pair.teng, pair.jeng)
    (j,), (t,) = both(pair, [("GET", "/loadz", None, None)])
    assert t[0] == j[0] == 200
    js, ts = json.loads(j[2]), json.loads(t[2])
    assert set(ts) == set(js)
    clocked = {"load_seq", "load_ts", "slo"}
    assert {k: ts[k] for k in ts if k not in clocked} == {k: js[k] for k in js if k not in clocked}
    assert ts["prefill_tokens"] > 0 and ts["prefix_hit_tokens"] > 0 and ts["role"] == "both"
    for slo in ("ttft", "inter_token"):
        assert set(ts["slo"][slo]) == set(js["slo"][slo])
        assert ts["slo"][slo]["threshold_s"] == js["slo"][slo]["threshold_s"]
    assert ts["slo"]["ttft"]["sketch"]["count"] == js["slo"]["ttft"]["sketch"]["count"] > 0


def test_full_queue_gives_429_with_retry_after_as_in_jax():
    """An engine whose queue is at max_queue (not started: the waiting
    request stays) sheds with 429 and the same Retry-After and body."""
    j_params, t_params = weights(0)
    ec = {**EC, "max_queue": 1}
    jeng = JEngine(J_CFG, j_params, JEngineConfig(**ec))
    teng = Engine(T_CFG, t_params, EngineConfig(**ec), device="cpu")
    jeng.submit(JRequest([256, 1], max_tokens=2))
    teng.submit(Request([256, 1], max_tokens=2))
    srv = Server(ServerState(teng, ByteTokenizer(), "tiny"), host="127.0.0.1", port=0).start()
    try:
        calls = [("POST", "/v1/completions", {"prompt": "x"}, None),
                 ("POST", "/v1/chat/completions", {"messages": [], "stream": True}, None)]
        j = jax_http(JServerState(jeng, JByteTokenizer(), "tiny"), calls)
        t = port_http(srv, calls)
    finally:
        srv.stop()
    for (js, jh, jt), (ts, th, tt) in zip(j, t):
        assert ts == js == 429 and th["Retry-After"] == jh["Retry-After"] == "1"
        assert json.loads(tt) == json.loads(jt) == {"error": {"message": "engine overloaded: 1 requests already "
                                                                         "waiting", "type": "overloaded"}}


def test_expired_deadline_gives_504_as_in_jax(pair):
    expired = {"x-request-deadline": str(time.time() - 5)}
    live = {"x-request-deadline": str(time.time() + 600)}
    j, t = both(pair, [("POST", "/v1/completions", {"prompt": "x"}, expired),
                       ("POST", "/v1/chat/completions", {"messages": []}, expired),
                       ("POST", "/v1/completions", {"prompt": "x", "max_tokens": 2}, live)])
    for (js, _, jt), (ts, _, tt) in zip(j[:2], t[:2]):
        assert ts == js == 504 and json.loads(tt) == json.loads(jt)
    assert t[2][0] == j[2][0] == 200


def test_load_header_reads_back_through_both_parsers(pair):
    """The x-substratus-load header of a completion, streamed and not,
    parses the same through the JAX package's LoadReport and the port's."""
    calls = [("POST", "/v1/completions", {"prompt": "load", "max_tokens": 3}, None),
             ("POST", "/v1/completions", {"prompt": "load", "max_tokens": 3, "stream": True}, None)]
    j, t = both(pair, calls)
    fields = ("queue_depth", "active_slots", "max_slots", "kv_free_frac", "adapters", "role", "transfer_queue",
              "seq", "wall_ts", "weights_version")
    for _, headers, _ in j + t:
        header = headers[HEADER]
        mine, theirs = LoadReport.from_header(header), JLoadReport.from_header(header)
        assert [getattr(mine, f) for f in fields] == [getattr(theirs, f) for f in fields]
        assert mine.max_slots == 4 and mine.seq > 0 and mine.wall_ts > 0 and mine.role == "both"
    snap = pair.teng.load_snapshot()
    mine, theirs = LoadReport.from_snapshot(snap).to_header(), JLoadReport.from_snapshot(snap).to_header()
    assert mine.split()[:4] == theirs.split()[:4]


def test_draining_gives_503_as_in_jax(pair):
    """While draining: readiness and /loadz 503 (draining true), a new
    completion 503 with Retry-After."""
    pair.jstate.draining = pair.srv.state.draining = True
    try:
        j, t = both(pair, [("GET", "/", None, None), ("GET", "/loadz", None, None),
                           ("POST", "/v1/completions", {"prompt": "x"}, None),
                           ("POST", "/v1/chat/completions", {"messages": []}, None)])
    finally:
        pair.jstate.draining = pair.srv.state.draining = False
    assert (t[0][0], t[0][2]) == (j[0][0], j[0][2]) == (503, "draining")
    assert t[1][0] == j[1][0] == 503 and json.loads(t[1][2])["draining"] is json.loads(j[1][2])["draining"] is True
    for (js, jh, jt), (ts, th, tt) in zip(j[2:], t[2:]):
        assert ts == js == 503 and th["Retry-After"] == jh["Retry-After"] == "1"
        assert json.loads(tt) == json.loads(jt)
    (t_ready,) = port_http(pair.srv, [("GET", "/", None, None)])
    assert (t_ready[0], t_ready[2]) == (200, "ok")


def test_debug_profile_rules_match_jax(pair, tmp_path, monkeypatch):
    """/debug/profile's 400 and 409 rules and its watchdog, as in the JAX
    app (the cap cut to 1 s in both): a bad body or `seconds`, a stop with
    nothing running, a second start or a blocking capture beside a started
    one; a start that its cap ended is over, so a stop finds none and a new
    start succeeds; a stop and a blocking capture write a trace."""
    import substratus_tpu.serve.server as jserver
    import substratus_tpu_torch.serve.server as tserver

    cap = 1.0
    monkeypatch.setenv("PROFILE_DIR", str(tmp_path))
    monkeypatch.setattr(tserver, "PROFILE_CAP_S", cap)

    class ShortCap:  # the JAX watchdog's sleep, its only one of the cap's length
        def __getattr__(self, name):
            return getattr(asyncio, name)

        @staticmethod
        async def sleep(seconds, *args):
            await asyncio.sleep(cap if seconds == 60.0 else seconds, *args)

    monkeypatch.setattr(jserver, "asyncio", ShortCap())
    prof = [("POST", "/debug/profile", body, None) for body in (
        {"seconds": 0}, {"seconds": -1}, {"seconds": 61}, {"seconds": "x"}, [1], {"action": "pause"},
        {"action": "stop"}, {"action": "start"}, {"action": "start"}, {"seconds": 0.2})]
    prof += [(None, None, cap + 2.0, None)]
    prof += [("POST", "/debug/profile", body, None) for body in (
        {"action": "stop"}, {"action": "start"}, {"action": "stop"}, {"seconds": 0.2})]
    j, t = both(pair, prof)
    assert [x and x[0] for x in t] == [x and x[0] for x in j] == [400] * 6 + [409, 200, 409, 409, None] + [
        409, 200, 200, 200]
    assert [x[2] for x in t if x and x[0] != 200] == [x[2] for x in j if x and x[0] != 200]
    for x in (7, 12):
        started = json.loads(t[x][2])
        assert started["started"] is True and set(started) == set(json.loads(j[x][2])) == {"started", "dir",
                                                                                          "cap_seconds"}
    stopped, blocking = json.loads(t[13][2]), json.loads(t[14][2])
    assert stopped["stopped"] is True and set(stopped) >= set(json.loads(j[13][2]))
    assert set(blocking) == set(json.loads(j[14][2])) == {"dir", "seconds", "files"}
    for out in (stopped, blocking):
        assert out["dir"].startswith(str(tmp_path)) and any(f.endswith("trace.json") for f in out["files"])
    assert pair.srv.state.profile.live is None


def test_cancel_frees_the_slot_on_every_scheduler():
    """Request.cancelled ends the request at its next emit with "stop",
    and its slot and pages are free once it has ended: overlapped and
    synchronous, plain, prompt lookup and a (self-)draft model, whose pool
    shares the target's pages."""
    _, t_params = weights(0)
    prompt = [256] + list(range(60, 100))  # 41 tokens: two full pages for the registry
    for overlap in (None, False):
        for spec in ({}, {"spec_k": 3}, {"spec_k": 3, "draft": True}):
            draft = (T_CFG, t_params) if spec.pop("draft", False) else None
            eng = Engine(T_CFG, t_params, EngineConfig(**{**EC, "overlap": overlap, **spec}), device="cpu",
                         draft=draft)
            free = eng.alloc.free_pages
            eng.start()
            try:
                req = eng.submit(Request(list(prompt), max_tokens=60))
                head = [req.out.get(timeout=120) for _ in range(3)]
                req.cancelled = True
                rest = []
                while (t := req.out.get(timeout=120)) is not None:
                    rest.append(t)
                assert None not in head and req.finish_reason == "stop" and len(head) + len(rest) < 60
                wait_idle(eng)
                assert eng.slot_req == [None] * EC["max_batch"] and not any(eng.slot_pages.pages)
                assert eng.alloc.free_pages == free - len(eng.prefix) == free - 2, (overlap, spec)
            finally:
                eng.stop()


def test_serve_main_drains_on_sigterm(tmp_path):
    """serve.main as a child process: SIGTERM during a stream and a
    non-streamed completion turns readiness to 503 within a second; the
    stream ends with all its tokens and [DONE], the completion answers 200
    with all of its own, a request whose body was still on its way when
    they ended gets its 503, and the process exits 0 within the grace."""
    params = tmp_path / "params.json"
    params.write_text(json.dumps({"config": "tiny", "max_batch": 2, "max_seq_len": 512, "drain_grace": 60}))
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    child = subprocess.Popen([sys.executable, "-m", "substratus_tpu_torch.serve.main", "--device", "cpu",
                              "--params", str(params), "--host", "127.0.0.1", "--port", "0"],
                             cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = child.stdout.readline()
        assert line.startswith("serving tiny on 127.0.0.1:"), line
        port = int(line.split("127.0.0.1:")[1].split()[0])
        srv = SimpleNamespace(port=port)
        body = {"prompt": "drain me", "max_tokens": 400, "temperature": 0, "stream": True,
                "stream_options": {"include_usage": True}}
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/completions", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        seen = {"ready_503_at": None, "done_at": None}
        whole = threading.Thread(target=lambda: seen.update(whole=port_http(srv, [
            ("POST", "/v1/completions", {k: v for k, v in body.items() if k not in ("stream", "stream_options")},
             None)])[0]))
        late = json.dumps({"prompt": "late"}).encode()
        slow = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        with urllib.request.urlopen(req, timeout=120) as stream:
            first = stream.readline()
            assert first.startswith(b"data: ")
            whole.start()
            deadline = time.monotonic() + 30
            while json.loads(port_http(srv, [("GET", "/loadz", None, None)])[0][2])["active_slots"] < 2:
                assert time.monotonic() < deadline, "the second request never reached a slot"
                time.sleep(0.01)
            slow.putrequest("POST", "/v1/completions")  # its handler runs, its body not sent yet
            slow.putheader("Content-Type", "application/json")
            slow.putheader("Content-Length", str(len(late)))
            slow.endheaders()
            t_term = time.monotonic()
            child.send_signal(signal.SIGTERM)

            def poll():
                while seen["ready_503_at"] is None and time.monotonic() - t_term < 5:
                    (status, _, text), = port_http(srv, [("GET", "/", None, None)])
                    if status == 503:
                        seen["ready_503_at"] = time.monotonic()
                        seen["loadz"] = port_http(srv, [("GET", "/loadz", None, None)])[0]
                        seen["post"] = port_http(srv, [("POST", "/v1/completions", {"prompt": "x"}, None)])[0]
                    time.sleep(0.05)

            poller = threading.Thread(target=poll)
            poller.start()
            rest = stream.read().decode()
            seen["done_at"] = time.monotonic()
            poller.join()
        whole.join()
        time.sleep(0.5)  # past the drain's poll: only the slow handler still holds the exit
        slow.send(late)
        late_resp = slow.getresponse()
        assert late_resp.status == 503 and late_resp.getheader("Retry-After") == "1"
        assert json.loads(late_resp.read())["error"]["type"] == "draining"
        slow.close()
        pieces, finish, usage = sse(first.decode() + rest)
        status, _, text = seen["whole"]
        assert status == 200, text
        # The same prompt, greedy: the same tokens as the stream's.
        assert (result(seen["whole"])[0], json.loads(text)["usage"]) == ("".join(pieces), usage)
        assert seen["ready_503_at"] is not None and seen["ready_503_at"] - t_term < 1.0, seen
        assert seen["ready_503_at"] < seen["done_at"], "the stream ended before the drain began"
        assert seen["loadz"][0] == 503 and json.loads(seen["loadz"][2])["draining"] is True
        assert seen["post"][0] == 503 and seen["post"][1]["Retry-After"] == "1"
        assert len(pieces) == usage["completion_tokens"] + 1 and finish in ("length", "stop")
        assert child.wait(timeout=60) == 0
        assert time.monotonic() - t_term < 60
        assert "drained cleanly" in child.stdout.read()
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
