"""Multi-tenant adapters at the port's serving surface, against the JAX
server and BatchGenDriver, on the CPU.

Tiny float32 llama weights from a seed, carried across by
bridge.params_from_jax; three adapter artifacts in the contract's format
(written by the JAX package) in one directory, which both packages' stores
search (capacity 2, two preloaded). The port's server over real HTTP and
the JAX app through aiohttp's TestClient get the same bodies in the same
order: /v1/models (the base and every servable tenant, `loaded` true or
false), a `model` field naming a tenant (resident or hot-loaded), the
base, an empty one and an unknown one (404 `model_not_found`); then
/loadz's adapter keys and the x-substratus-load header's resident ids
through both parsers. serve.main takes --adapters-dir, params.json
`adapters` and `baseModel`, and the mounted /content/adapters; the
BatchGenDriver with a store writes each record under its `model`, an unknown one
as an "error" record, as the JAX one does.
"""
import asyncio
import json
import os
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substratus_tpu.gateway.loadreport import LoadReport as JLoadReport
from substratus_tpu.models import llama as jllama
from substratus_tpu.serve import adapters as jadapters
from substratus_tpu.serve import batchgen as jbatchgen
from substratus_tpu.serve.engine import Engine as JEngine
from substratus_tpu.serve.engine import EngineConfig as JEngineConfig
from substratus_tpu.serve.server import ServerState as JServerState
from substratus_tpu.serve.tokenizer import ByteTokenizer as JByteTokenizer
from substratus_tpu_torch.bridge import params_from_jax
from substratus_tpu_torch.gateway.loadreport import HEADER, LoadReport
from substratus_tpu_torch.load import manifest as tmanifest
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.serve import adapters, batchgen
from substratus_tpu_torch.serve import main as serve_main
from substratus_tpu_torch.serve.engine import Engine, EngineConfig
from substratus_tpu_torch.serve.server import Server, ServerState
from substratus_tpu_torch.serve.tokenizer import ByteTokenizer

EOS = 257
J_CFG = jllama.CONFIGS["tiny"].replace(vocab_size=258, dtype=jnp.float32)
T_CFG = llama.CONFIGS["tiny"].replace(vocab_size=258, dtype=torch.float32)
EC = {"max_batch": 4, "max_seq_len": 96, "eos_token_id": EOS}
IDS = ("alpha", "beta", "gamma")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_lora(seed, rank=4, targets=("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")):
    r = np.random.default_rng(seed)
    shapes = adapters._target_shapes(T_CFG, targets)
    return {name: {"a": (r.standard_normal((T_CFG.n_layers, ind, rank)) / rank).astype(np.float32),
                   "b": (r.standard_normal((T_CFG.n_layers, rank) + out) * 0.2).astype(np.float32)}
            for name, (ind, out) in shapes.items()}


@pytest.fixture(scope="module")
def adapter_dir(tmp_path_factory):
    """Three tenants in the contract's format, the third at rank 2 on wq/wv."""
    root = tmp_path_factory.mktemp("adapters")
    for i, aid in enumerate(IDS):
        lora = make_lora(i) if i < 2 else make_lora(i, 2, ("wq", "wv"))
        jadapters.save_adapter_artifact(str(root / aid), lora, alpha=8.0, rank=4 if i < 2 else 2)
    (root / "not-an-adapter").mkdir()
    return str(root)


@pytest.fixture(scope="module")
def weights():
    j_params = jllama.init_params(J_CFG, jax.random.key(0))
    t_params = llama.Llama(T_CFG, device="cpu")
    t_params.load_state_dict(params_from_jax(jax.device_get(j_params)))
    return j_params, t_params


def preloaded(cls, cfg, adapter_dir, **kw):
    store = cls(cfg, capacity=2, rank=4, targets=("w_down", "w_gate", "w_up", "wk", "wo", "wq", "wv"),
                search_dir=adapter_dir, **kw)
    for aid in store.available_ids()[:2]:
        store.load(aid)
    return store


def jax_http(state, calls):
    from aiohttp.test_utils import TestClient, TestServer

    from substratus_tpu.serve.server import build_app

    async def go():
        out = []
        async with TestClient(TestServer(build_app(state))) as client:
            for method, path, body in calls:
                r = await client.request(method, path, data=None if body is None else json.dumps(body),
                                         headers={"Content-Type": "application/json"})
                out.append((r.status, dict(r.headers), await r.text()))
        return out

    return asyncio.run(go())


def port_http(port, calls):
    out = []
    for method, path, body in calls:
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method=method,
                                     data=None if body is None else json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                out.append((r.status, dict(r.headers), r.read().decode()))
        except urllib.error.HTTPError as e:
            out.append((e.code, dict(e.headers), e.read().decode()))
    return out


def _body(text):
    body = json.loads(text)
    return {k: v for k, v in body.items() if k not in ("id", "created")}


@pytest.fixture(scope="module")
def pair(weights, adapter_dir):
    j_params, t_params = weights
    jstore = preloaded(jadapters.AdapterStore, J_CFG, adapter_dir, dtype=jnp.float32)
    tstore = preloaded(adapters.AdapterStore, T_CFG, adapter_dir, device="cpu")
    jeng = JEngine(J_CFG, j_params, JEngineConfig(**EC), adapters=jstore)
    teng = Engine(T_CFG, t_params, EngineConfig(**EC), device="cpu", adapters=tstore)
    jeng.start()
    srv = Server(ServerState(teng, ByteTokenizer(), "tiny"), host="127.0.0.1", port=0).start()
    teng.start()
    yield JServerState(jeng, JByteTokenizer(), "tiny"), srv, jeng, teng
    jeng.stop()
    srv.stop()


CALLS = [
    ("GET", "/v1/models", None),
    ("POST", "/v1/completions", {"prompt": "hello tenant", "max_tokens": 6, "temperature": 0.0, "model": "alpha"}),
    ("POST", "/v1/completions", {"prompt": "hello tenant", "max_tokens": 6, "temperature": 0.0, "model": "tiny"}),
    ("POST", "/v1/completions", {"prompt": "hello tenant", "max_tokens": 6, "temperature": 0.0, "model": ""}),
    ("POST", "/v1/completions", {"prompt": "hello tenant", "max_tokens": 6, "temperature": 0.0, "model": "gamma"}),
    ("POST", "/v1/completions", {"prompt": "x", "model": "stranger"}),
    ("POST", "/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 4,
                                      "temperature": 0.0, "model": "beta"}),
    ("GET", "/v1/models", None),
]


def test_model_field_and_models_match_jax(pair):
    """/v1/models before and after a hot load, tenants resident and not,
    the base by name and by an empty field, a stranger's 404: the JAX
    server's statuses and bodies; a tenant's completion differs from the
    base's."""
    jstate, srv, _, _ = pair
    j, t = jax_http(jstate, CALLS), port_http(srv.port, CALLS)
    assert [s for s, _, _ in t] == [s for s, _, _ in j] == [200, 200, 200, 200, 200, 404, 200, 200]
    assert [_body(x) for _, _, x in t] == [_body(x) for _, _, x in j]
    models = json.loads(t[0][2])["data"]
    assert [(m["id"], m.get("loaded")) for m in models] == [("tiny", None), ("alpha", True), ("beta", True),
                                                            ("gamma", False)]
    assert {m["id"]: m["loaded"] for m in json.loads(t[7][2])["data"][1:]} == {"alpha": False, "beta": True,
                                                                             "gamma": True}
    assert json.loads(t[5][2])["error"]["code"] == "model_not_found"
    texts = [json.loads(x)["choices"][0]["text"] for _, _, x in t[1:5]]
    assert texts[1] == texts[2] and texts[0] != texts[1] and json.loads(t[1][2])["model"] == "alpha"


def test_loadz_and_load_header_carry_the_resident_ids(pair):
    """/loadz's adapter keys and values (resident ids, capacity, hits,
    misses, evictions) the JAX engine's after the same requests; the
    x-substratus-load header's ids read back by both parsers."""
    jstate, srv, jeng, teng = pair
    deadline = time.time() + 60
    while (jeng.active.any() or teng.active.any()) and time.time() < deadline:
        time.sleep(0.01)
    (j,), (t,) = jax_http(jstate, [("GET", "/loadz", None)]), port_http(srv.port, [("GET", "/loadz", None)])
    js, ts = json.loads(j[2]), json.loads(t[2])
    keys = ("adapters", "adapter_capacity", "adapter_hits", "adapter_misses", "adapter_evictions")
    assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
    assert ts["adapters"] == ["beta", "gamma"] and ts["adapter_evictions"] >= 1
    (r,) = port_http(srv.port, [("POST", "/v1/completions", {"prompt": "x", "max_tokens": 1, "model": "beta"})])
    header = r[1][HEADER]
    assert LoadReport.from_header(header).adapters == JLoadReport.from_header(header).adapters == ("beta", "gamma")


def test_serve_main_takes_adapters_dir_params_and_the_mount(adapter_dir, tmp_path, monkeypatch):
    """serve.main --adapters-dir (a tenant answered, the startup line names
    the store), params.json adapters {dir, capacity} with baseModel, and the
    mounted /content/adapters when nothing names a directory."""
    params = tmp_path / "p.json"

    def serve(argv, body):
        srv = serve_main.build(["--config", "tiny", "--device", "cpu", "--port", "0", "--host", "127.0.0.1",
                                *argv]).start()
        try:
            store = srv.state.engine.adapters
            got = port_http(srv.port, [("POST", "/v1/completions", body), ("GET", "/v1/models", None)])
            return store, got
        finally:
            srv.stop()

    store, got = serve(["--params", "", "--adapters-dir", adapter_dir],
                       {"prompt": "hi", "max_tokens": 3, "model": "gamma"})
    assert store.capacity == 8 and store.loaded_ids() == list(IDS) and store.rank == 4
    assert got[0][0] == 200 and [m["id"] for m in json.loads(got[1][2])["data"]] == ["tiny", *IDS]
    params.write_text(json.dumps({"adapters": {"dir": adapter_dir, "capacity": 1}, "baseModel": "llama"}))
    store, got = serve(["--params", str(params)], {"prompt": "hi", "max_tokens": 3, "model": "beta"})
    assert store.capacity == 1 and store.loaded_ids() == ["beta"] and store.stats["evictions"] == 1
    monkeypatch.setattr(serve_main, "CONTENT_ADAPTERS", adapter_dir)
    store, got = serve(["--params", ""], {"prompt": "hi", "max_tokens": 3, "model": "alpha"})
    assert store.search_dir == adapter_dir and got[0][0] == 200
    monkeypatch.setattr(serve_main, "CONTENT_ADAPTERS", str(tmp_path / "absent"))
    store, got = serve(["--params", ""], {"prompt": "hi", "max_tokens": 3, "model": "alpha"})
    assert store is None and got[0][0] == 404


def test_batch_records_select_their_tenant_as_jax(weights, adapter_dir, tmp_path):
    """A manifest whose records name tenants (resident, hot-loaded, unknown)
    and the base: each record's tokens the JAX BatchGenDriver's, the unknown one an
    "error" record carrying its model; then serve.batchgen's entry point
    builds the same store from params.json."""
    j_params, t_params = weights
    r = np.random.default_rng(3)
    recs = [{"id": f"r{i}", "tokens": r.integers(0, 256, 6 + 3 * i).tolist(), "max_tokens": 5}
            for i in range(6)]
    for rec, model in zip(recs, ("alpha", None, "gamma", "nobody", "beta", "alpha")):
        if model is not None:
            rec["model"] = model
    man = str(tmp_path / "m.jsonl")
    tmanifest.write_manifest(man, recs)
    outs = {}
    for name, (cls, eng_cls, cfg_cls, store_cls, cfg, params, kw, tok) in {
        "jax": (jbatchgen, JEngine, JEngineConfig, jadapters.AdapterStore, J_CFG, j_params, {"dtype": jnp.float32},
                JByteTokenizer()),
        "port": (batchgen, Engine, EngineConfig, adapters.AdapterStore, T_CFG, t_params, {"device": "cpu"},
                 ByteTokenizer()),
    }.items():
        store = preloaded(store_cls, cfg, adapter_dir, **kw)
        eng = eng_cls(cfg, params, cfg_cls(overlap=False, **EC), adapters=store,
                      **({"device": "cpu"} if name == "port" else {}))
        eng.start()
        try:
            summary = cls.BatchGenDriver([eng], man, str(tmp_path / name), tokenizer=tok, max_tokens=5).run()
        finally:
            eng.stop()
        got = {}
        for shard in sorted(os.listdir(tmp_path / name)):
            for line in open(tmp_path / name / shard):
                rec = json.loads(line)
                got[rec["index"]] = rec
        outs[name] = (summary["errors"], got)
    assert outs["port"] == outs["jax"]
    errors, got = outs["port"]
    assert errors == 1 and got[3]["finish_reason"] == "error" and got[3]["model"] == "nobody"
    assert got[0]["model"] == "alpha" and "model" not in got[1] and got[2]["model"] == "gamma"
    params = tmp_path / "p.json"
    params.write_text(json.dumps({"adapters": {"dir": adapter_dir, "capacity": 2}, "max_seq_len": 96,
                                  "batchGenerate": {"maxTokens": 5}}))
    assert batchgen.main(["--config", "tiny", "--device", "cpu", "--params", str(params), "--manifest", man,
                          "--output", str(tmp_path / "entry")]) == 0
    lines = [json.loads(x) for f in sorted(os.listdir(tmp_path / "entry")) for x in open(tmp_path / "entry" / f)]
    assert sorted(x["finish_reason"] == "error" for x in lines) == [False] * 5 + [True]
