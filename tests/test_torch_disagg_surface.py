"""Disaggregated serving through the port's entry point and server
(serve/main.py --role, serve/server.py), on the CPU.

serve.main runs as two child processes, a decode tier and a prefill tier
of the seeded tiny model, each told its role, peers and port by a flag, the
environment and params.json at once (flag > env > params, as in the JAX
entry point): completions through the prefill tier's HTTP, streamed and
not, equal an in-process monolithic server's; the decode tier answers
completions 503 with the JAX server's wrong_role body; /loadz and the load
header carry each tier's role and transfer queue; /metrics counts the
transfers by outcome; a traced request's journey on the prefill tier is one
journey under one trace id across both processes, the decode segment's
install, emits and end inside it, every event name one the JAX pair
records. Then the entry points' refusals: a prefill tier without peers, a
role off the paged pool, and the repair: serve.main and train.main exit on
an operator's multi-process environment, citing ROADMAP Queue 1's item.
"""
import asyncio
import json
import os
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

from substratus_tpu.models import llama as jllama
from substratus_tpu.serve import disagg as jdisagg
from substratus_tpu.serve.engine import Engine as JEngine
from substratus_tpu.serve.engine import EngineConfig as JEngineConfig
from substratus_tpu.serve.engine import Request as JRequest
from substratus_tpu.serve.server import ServerState as JServerState
from substratus_tpu.serve.tokenizer import ByteTokenizer as JByteTokenizer
from substratus_tpu_torch.gateway.loadreport import HEADER, LoadReport
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.serve import batchgen, main
from substratus_tpu_torch.serve.engine import Engine, EngineConfig
from substratus_tpu_torch.serve.server import Server, ServerState
from substratus_tpu_torch.serve.tokenizer import ByteTokenizer
from substratus_tpu_torch.train import main as train_main

REPO = Path(__file__).resolve().parents[1]
PARAMS = {"config": "tiny", "max_batch": 2, "max_seq_len": 128}
TRACE = "0af7651916cd43dd8448eb211c80319c"
GANG = {"JAX_NUM_PROCESSES": "2", "JAX_COORDINATOR_ADDRESS": "10.0.0.1:8476"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Child:
    """serve.main in a child process; its output lines read by a thread,
    so that every wait has a timeout."""

    def __init__(self, args, params: dict, env: dict, tmp: Path, name: str):
        path = tmp / f"{name}.json"
        path.write_text(json.dumps(params))
        self.lines = []
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "substratus_tpu_torch.serve.main", "--device", "cpu", "--params", str(path),
             "--host", "127.0.0.1", "--port", "0", *args],
            cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1", **env},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        threading.Thread(target=lambda: self.lines.extend(self.proc.stdout), daemon=True).start()

    def line(self, prefix: str, timeout: float = 120) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            hit = next((ln for ln in list(self.lines) if ln.startswith(prefix)), None)
            if hit is not None:
                return hit
            assert self.proc.poll() is None, "".join(self.lines)
            time.sleep(0.05)
        raise AssertionError(f"no line {prefix!r}: {''.join(self.lines)}")

    @property
    def port(self) -> int:
        return int(self.line("serving ").split("127.0.0.1:")[1].split()[0])

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)


def http(port, method, path, body=None, headers=None):
    """(status, headers, text) of one request to 127.0.0.1:port."""
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, dict(r.headers), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()


@pytest.fixture(scope="module")
def tiers(tmp_path_factory):
    """A decode tier (role from the environment over params.json's, port 0
    from the flag over the environment's), then a prefill tier (role from
    the flag over params.json's, peers from the environment over
    params.json's), and an in-process monolith of the same seeded model."""
    tmp = tmp_path_factory.mktemp("tiers")
    dec = Child(["--transfer-port", "0"], {**PARAMS, "role": "prefill", "transfer_port": 1}, {
        "SUBSTRATUS_SERVE_ROLE": "decode", "SUBSTRATUS_TRANSFER_PORT": "1"}, tmp, "decode")
    pre = None
    try:
        transfer = int(dec.line("decode role: KV transfer on :").rsplit(":", 1)[1])
        pre = Child(["--role", "prefill"], {**PARAMS, "role": "both", "decode_peers": ["127.0.0.1:1"]},
                    {"SUBSTRATUS_DECODE_PEERS": f"127.0.0.1:{transfer}"}, tmp, "prefill")
        cfg, params, tok, name, family, _ = main.load_model(None, None, PARAMS, torch.device("cpu"), "none")
        eng = Engine(cfg, params, EngineConfig(max_batch=2, max_seq_len=128, eos_token_id=tok.eos_id), device="cpu")
        mono = Server(ServerState(eng, tok, name), host="127.0.0.1", port=0).start()
        eng.start()
        try:
            yield SimpleNamespace(dec=dec, pre=pre, transfer=transfer, dec_port=dec.port, pre_port=pre.port,
                                  mono=mono, mono_port=mono.port)
        finally:
            mono.stop()
    finally:
        dec.stop()
        if pre is not None:
            pre.stop()


def _digest(line: str) -> str:
    return line.split("weights digest ")[1].split(";")[0]


def test_flag_env_params_precedence(tiers, monkeypatch):
    """Each child took the flag over the environment over params.json; the
    resolvers give the same order in-process, and both tiers printed the
    monolith's weights digest."""
    assert tiers.transfer not in (1, 8500)
    assert f"prefill role: decode peers ['127.0.0.1:{tiers.transfer}']" in tiers.pre.line("prefill role:")
    assert "role: decode;" in tiers.dec.line("serving ") and "role: prefill;" in tiers.pre.line("serving ")
    digest = main.weights_digest(tiers.mono.state.engine.params)
    assert _digest(tiers.dec.line("serving ")) == _digest(tiers.pre.line("serving ")) == digest
    for var in ("SUBSTRATUS_SERVE_ROLE", "SUBSTRATUS_DECODE_PEERS", "SUBSTRATUS_TRANSFER_PORT"):
        monkeypatch.delenv(var, raising=False)
    params = {"role": "decode", "decode_peers": ["p:1", "q:2"], "transfer_port": 9}
    assert main.resolve_role(None, {}) == "both" and main.resolve_role(None, params) == "decode"
    assert main.resolve_decode_peers(None, params) == ["p:1", "q:2"] and main.resolve_transfer_port(None, {}) == 8500
    monkeypatch.setenv("SUBSTRATUS_SERVE_ROLE", "prefill")
    monkeypatch.setenv("SUBSTRATUS_DECODE_PEERS", "e:1, f:2")
    monkeypatch.setenv("SUBSTRATUS_TRANSFER_PORT", "7")
    assert main.resolve_role(None, params) == "prefill" and main.resolve_role("both", params) == "both"
    assert main.resolve_decode_peers(None, params) == ["e:1", "f:2"] and main.resolve_decode_peers("g:3", params) == [
        "g:3"]
    assert main.resolve_transfer_port(None, params) == 7 and main.resolve_transfer_port(0, params) == 0
    monkeypatch.setenv("SUBSTRATUS_SERVE_ROLE", "sideways")
    with pytest.raises(SystemExit, match="role 'sideways' invalid"):
        main.resolve_role(None, {})
    main.check_params({"role": "decode", "disaggregated": True, "transfer_port": 8500, "decode_peers": ["a:1"]})
    for bad, match in (({"role": "sideways"}, "invalid"), ({"decode_peers": "a:1"}, "invalid"),
                       ({"transfer_port": "x"}, "invalid")):
        with pytest.raises(SystemExit, match=match):
            main.check_params(bad)


@pytest.mark.parametrize("stream", [False, True])
def test_completions_through_the_tiers_equal_the_monolith(tiers, stream):
    """The same greedy completion through the prefill tier's HTTP and the
    monolith's: the same text, usage and finish."""
    body = {"prompt": "The handoff carries the pages of a prompt " * 2, "max_tokens": 12, "temperature": 0,
            "stream": stream, "stream_options": {"include_usage": True}}
    got, want = http(tiers.pre_port, "POST", "/v1/completions", body), http(tiers.mono_port, "POST",
                                                                            "/v1/completions", body)
    assert got[0] == want[0] == 200, got
    if stream:
        assert _chunks(got[2]) == _chunks(want[2]) and len(_chunks(got[2])) == 12 + 2
    else:
        g, w = json.loads(got[2]), json.loads(want[2])
        assert (g["choices"], g["usage"]) == (w["choices"], w["usage"])
        assert g["usage"]["completion_tokens"] == 12


def _chunks(text):
    return [(c["choices"], c.get("usage")) for c in (json.loads(ln[6:]) for ln in text.split("\n")
                                                     if ln.startswith("data: {"))]


def test_decode_tier_sheds_completions_with_the_jax_body(tiers):
    """The decode child answers completions and chat 503 wrong_role with
    Retry-After, the JAX server's body, while GET / and /loadz stay up."""
    j_cfg = jllama.CONFIGS["tiny"].replace(vocab_size=258, dtype=jnp.float32)
    jeng = JEngine(j_cfg, jllama.init_params(j_cfg, jax.random.key(0)),
                   JEngineConfig(max_batch=2, max_seq_len=64, role="decode"))

    async def jax_post():
        from aiohttp.test_utils import TestClient, TestServer

        from substratus_tpu.serve.server import build_app

        async with TestClient(TestServer(build_app(JServerState(jeng, JByteTokenizer(), "tiny")))) as client:
            r = await client.post("/v1/completions", json={"prompt": "hi", "max_tokens": 2})
            return r.status, dict(r.headers), await r.text()

    want = asyncio.run(jax_post())
    for path, body in (("/v1/completions", {"prompt": "hi", "max_tokens": 2}),
                       ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}]})):
        got = http(tiers.dec_port, "POST", path, body)
        assert (got[0], json.loads(got[2])) == (want[0], json.loads(want[2])) == (503, json.loads(want[2]))
        assert got[1]["Retry-After"] == want[1]["Retry-After"] == "1"
    assert json.loads(want[2])["error"]["type"] == "wrong_role"
    assert http(tiers.dec_port, "GET", "/")[0] == 200


def test_loadz_and_the_load_header_carry_the_roles(tiers):
    """Each tier's /loadz names its role and transfer queue (the keys the
    gateway routes by); the prefill tier's load header reads back as a
    prefill replica."""
    for port, role in ((tiers.pre_port, "prefill"), (tiers.dec_port, "decode"), (tiers.mono_port, "both")):
        status, _, text = http(port, "GET", "/loadz")
        snap = json.loads(text)
        assert status == 200 and snap["role"] == role and snap["transfer_queue_depth"] == 0
        assert LoadReport.from_snapshot(snap).role == role
    status, headers, _ = http(tiers.pre_port, "POST", "/v1/completions", {"prompt": "x", "max_tokens": 2})
    assert status == 200 and LoadReport.from_header(headers[HEADER]).role == "prefill"
    assert " r=p" in headers[HEADER]


def test_metrics_count_the_transfers_by_outcome(tiers):
    """The prefill tier's /metrics: one more sent transfer and one more
    send time a request, the queue gauge, the handoffs gauge; the decode
    tier's migrations_in; no failed or requeued transfer."""
    def series(port):
        text = http(port, "GET", "/metrics")[2]
        return {ln.rsplit(" ", 1)[0]: float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
                if ln and not ln.startswith("#")}

    before = series(tiers.pre_port)
    for _ in range(2):
        assert http(tiers.pre_port, "POST", "/v1/completions", {"prompt": "count me", "max_tokens": 3})[0] == 200
    after, dec = series(tiers.pre_port), series(tiers.dec_port)
    sent = 'substratus_serve_kv_transfers_total{outcome="sent"}'
    assert after[sent] - before.get(sent, 0) == 2
    assert after["substratus_serve_kv_transfer_seconds_count"] - before.get(
        "substratus_serve_kv_transfer_seconds_count", 0) == 2
    assert after["substratus_serve_kv_transfer_queue_depth"] == 0
    assert after["substratus_serve_handoffs"] == after[sent] == dec["substratus_serve_migrations_in"]
    assert not any("failed" in k or "requeued" in k for k in after if k.startswith("substratus_serve_kv_transfers"))


def test_a_traced_request_is_one_journey_across_both_processes(tiers):
    """A request under a traceparent: the prefill tier's requestz?id= holds
    its journey under that trace id with the decode tier's segment stitched
    in (the same trace id; kv_recv, install, the emits of every token, end);
    the emitted tokens are the monolith's; every event name per origin is
    one the JAX pair records for the same request."""
    body = {"prompt": "journey", "max_tokens": 6, "temperature": 0}
    tp = {"traceparent": f"00-{TRACE}-b7ad6b7169203331-01"}
    status, headers, _ = http(tiers.pre_port, "POST", "/v1/completions", body, tp)
    assert status == 200 and headers["x-trace-id"] == TRACE
    assert http(tiers.mono_port, "POST", "/v1/completions", body, tp)[0] == 200
    journey = json.loads(http(tiers.pre_port, "GET", f"/debug/requestz?id={TRACE}")[2])["journey"]
    mono = json.loads(http(tiers.mono_port, "GET", f"/debug/requestz?id={TRACE}")[2])["journey"]
    assert journey["trace_id"] == TRACE and journey["origin"] == "prefill"
    (seg,) = journey["segments"]
    assert seg["trace_id"] == TRACE and seg["origin"] == "decode"
    names = {"prefill": [e[1] for e in journey["events"]], "decode": [e[1] for e in seg["events"]]}
    assert names["prefill"][:2] == ["submit", "admit"] and names["prefill"][-2:] == ["ship", "end"]
    assert names["decode"][:3] == ["kv_recv", "install", "emit"] and names["decode"][-1] == "end"
    tokens = [e[2]["t"] for e in seg["events"] if e[1] == "emit"]
    assert tokens == [e[2]["t"] for e in mono["events"] if e[1] == "emit"] and len(tokens) == 6
    assert journey["events"][-1][2]["reason"] == seg["events"][-1][2]["reason"] == "length"
    # The JAX pair's names for the same kind of request.
    j_cfg = jllama.CONFIGS["tiny"].replace(vocab_size=258, dtype=jnp.float32)
    j_params = jllama.init_params(j_cfg, jax.random.key(0))
    kw = {"max_batch": 2, "max_seq_len": 64, "eos_token_id": 257, "kv_layout": "paged"}
    jdec = JEngine(j_cfg, j_params, JEngineConfig(role="decode", **kw))
    jdec.start()
    jsrv = jdisagg.HandoffServer(jdec, host="127.0.0.1")
    pre_ec = JEngineConfig(role="prefill", **kw)
    mgr = jdisagg.HandoffManager([f"127.0.0.1:{jsrv.port}"], jdisagg.PoolSpec.from_engine_config(j_cfg, pre_ec),
                                 connect_timeout=5.0, ship_timeout=10.0, io_timeout=60.0)
    jpre = JEngine(j_cfg, j_params, pre_ec, handoff=mgr)
    jpre.start()
    try:
        req = jpre.submit(JRequest([256, 106, 111], max_tokens=6, temperature=0.0))
        while req.out.get(timeout=120) is not None:
            pass
        jsnap = req.journey.snapshot()
    finally:
        jpre.stop()
        mgr.close()
        jdec.stop()
        jsrv.close()
    jnames = {"prefill": [e[1] for e in jsnap["events"]], "decode": [e[1] for e in jsnap["segments"][0]["events"]]}
    for origin in ("prefill", "decode"):
        assert set(names[origin]) <= set(jnames[origin]), (origin, names[origin], jnames[origin])
        assert names[origin][:3] == jnames[origin][:3] and names[origin][-1] == jnames[origin][-1]


def test_entry_point_refusals(tmp_path):
    """A prefill tier without peers exits; a role off the paged pool is the
    engine's ValueError; batch generation refuses a role engine as JAX's
    BatchGenerator does, and names the multi-card item."""
    params = tmp_path / "p.json"
    params.write_text(json.dumps({"config": "tiny"}))
    base = ["--device", "cpu", "--params", str(params), "--host", "127.0.0.1", "--port", "0"]
    with pytest.raises(SystemExit, match="role=prefill needs --decode-peers"):
        main.build(base + ["--role", "prefill"])
    params.write_text(json.dumps({"config": "tiny", "kv_layout": "dense"}))
    with pytest.raises(ValueError, match="role='decode' requires the paged kv layout"):
        main.build(base + ["--role", "decode"])
    cfg = llama.CONFIGS["tiny"]
    eng = Engine(cfg, llama.init_params(cfg, seed=0, device="cpu"), EngineConfig(role="decode"), device="cpu")
    with pytest.raises(ValueError, match="batch generation drives monolithic engines"):
        batchgen.BatchGenDriver([eng], str(tmp_path / "m.jsonl"), str(tmp_path / "out"), tokenizer=ByteTokenizer())
    assert "multi-GPU" in batchgen._MULTI_GPU


@pytest.mark.parametrize("entry", ["serve", "train"])
def test_a_multi_process_environment_exits(tmp_path, monkeypatch, entry):
    """JAX_NUM_PROCESSES=2 with JAX_COORDINATOR_ADDRESS set (the operator's
    gang) makes train.main exit, citing ROADMAP Queue 1's multi-GPU item,
    before a model is built. serve.main joins such a gang
    (tests/test_torch_gang.py), and exits, citing the same item, on what a
    gang does not serve (a disaggregated role) before its rendezvous;
    batch generation goes to the rendezvous (tests/test_torch_batchgen_gang.py
    runs its gang). Either variable alone names no gang."""
    params = tmp_path / "p.json"
    params.write_text(json.dumps({"config": "tiny", "role": "decode"} if entry == "serve" else
                                 {"config": "tiny", "steps": 1, "batch_size": 1, "seq_len": 16}))
    data = tmp_path / "d.jsonl"
    data.write_text('{"text": "a tiny document"}\n')
    argv = {"serve": ["--device", "cpu", "--params", str(params), "--host", "127.0.0.1", "--port", "0"],
            "train": ["--device", "cpu", "--params", str(params), "--data", str(data), "--out",
                      str(tmp_path / "out")]}[entry]
    run = {"serve": main.build, "train": train_main.run}[entry]
    for var, value in GANG.items():
        monkeypatch.setenv(var, value)
    match = {"serve": r"a disaggregated role in a gang: .* ROADMAP Queue 1, multi-GPU",
             "train": r"JAX_NUM_PROCESSES=2 with JAX_COORDINATOR_ADDRESS set: .* ROADMAP Queue 1, multi-GPU"}[entry]
    with pytest.raises(SystemExit, match=match):
        run(argv)
    if entry == "serve":
        man = tmp_path / "m.jsonl"
        man.write_text('{"prompt": "x"}\n')
        from substratus_tpu_torch.parallel import distributed

        def rendezvous(*a, **kw):
            raise ConnectionRefusedError("the rendezvous")

        monkeypatch.setattr(distributed, "maybe_initialize", rendezvous)
        with pytest.raises(ConnectionRefusedError, match="the rendezvous"):
            batchgen.main(["--config", "tiny", "--params", "", "--manifest", str(man), "--output",
                           str(tmp_path / "o"), "--device", "cpu"])
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS")
    main.check_single_process(entry)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", GANG["JAX_COORDINATOR_ADDRESS"])
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    main.check_single_process(entry)
