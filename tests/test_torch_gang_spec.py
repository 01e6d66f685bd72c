"""Speculative decoding in a serving gang of the port against the JAX
package, on the CPU.

Gloo processes of tools/gang_worker.py serve JAX's test configuration
(tiny, vocab 258, f32, eos 257, max_batch 4) as tensor=2 gangs, each rank
holding its shard of JAX's weights, with spec_k 3: prompt lookup on the
dense cache and on the paged pool (f32, and int4 with an int8 cache, the
throughput example's levers), and a draft model, JAX's multi-host test's
(tests/test_multihost_serving.py: a one-layer draft on key 9), sharded by
the same rules on every rank. Four requests run at once (a sampled one
among them), two with repetitive prompts, so lookup proposes. Every greedy
row is exactly the tokens of JAX's single-process Engine with the same
spec_k and draft (JAX's gang outputs fail reference-side, ROADMAP Queue 3,
so gangs are held against its single engine), every rank's tokens equal
the leader's (the sampled row's too), and the gang ran verify passes.
Four ranks of data=2 x tensor=2 do the same with the verify's choices and
samples and the draft's proposals exchanged over the data group. The
entry point itself, two serve.main ranks over the port's f32 artifacts of
the same weights, serves the plan over HTTP with lookup and with the draft
(serve.main's own load of it, sharded by its gang_draft), each greedy
completion's tokens (its journey's) JAX's single Engine's. Each process
has its own timeout.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import urllib.request

import jax
import jax.numpy as jnp
import pytest
import torch

from substratus_tpu.models import llama as jllama
from substratus_tpu.ops import quant4 as jquant4
from substratus_tpu.serve.engine import Engine as JEngine
from substratus_tpu.serve.engine import EngineConfig as JEngineConfig
from substratus_tpu_torch.bridge import params_from_jax
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.train.checkpoints import save_artifact

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EOS = 257
J_CFG = jllama.CONFIGS["tiny"].replace(vocab_size=258, dtype=jnp.float32)
REP_A = [256] + [10, 11, 12, 13] * 5  # repetitive: the lookup scan matches
REP_B = [256] + [40, 41, 42] * 6 + [40]
PLAN = {"concurrent": True, "requests": [
    {"prompt": [256, 5, 6, 7], "max_tokens": 12}, {"prompt": REP_A, "max_tokens": 12},
    {"prompt": [256, 9, 10], "max_tokens": 8, "temperature": 0.7}, {"prompt": REP_B, "max_tokens": 12}]}
GREEDY_ROWS = (0, 1, 3)
BASE = {"max_batch": 4, "max_seq_len": 128, "max_prefill_len": 16, "spec_k": 3}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """JAX's tiny f32 target (key 0) and its one-layer draft (key 9), and
    the port's copies as state-dict files and as artifacts (dirs "tiny"
    and "draft" beside them)."""
    tmp = tmp_path_factory.mktemp("gang_spec")
    target = jllama.init_params(J_CFG, jax.random.key(0))
    draft = jllama.init_params(J_CFG.replace(n_layers=1), jax.random.key(9))
    for name, params, n_layers in (("tiny", target, J_CFG.n_layers), ("draft", draft, 1)):
        state = params_from_jax(jax.device_get(params))
        torch.save(state, tmp / f"{name}.pt")
        cfg = llama.CONFIGS["tiny"].replace(vocab_size=258, dtype=torch.float32, n_layers=n_layers)
        model = llama.Llama(cfg, device="cpu")
        model.load_state_dict(state)
        save_artifact(str(tmp / name), model, cfg)
    return target, draft, str(tmp / "tiny.pt"), str(tmp / "draft.pt")


def _gang(tmp_path, weights_file, legs, world=2, timeout=240):
    """`world` gang_worker ranks serving PLAN in each leg of `legs`; each
    rank's legs (every rank exited 0)."""
    port = _free_port()
    (tmp_path / "plan.json").write_text(json.dumps(PLAN))
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1", "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
           "JAX_NUM_PROCESSES": str(world)}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "substratus_tpu_torch.tools.gang_worker", "--device", "cpu", "--config", "tiny",
         "--weights", weights_file, "--vocab", "258", "--dtype", "float32", "--eos", str(EOS), "--params",
         json.dumps(legs), "--requests", str(tmp_path / "plan.json"), "--out", str(tmp_path / f"r{r}.json"),
         "--draft-shape", "n_layers=1", "--timeout", "60"],
        cwd=REPO, env={**env, "TPU_WORKER_ID": str(r)}, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)
    assert [p.returncode for p in procs] == [0] * world, logs
    return [json.loads((tmp_path / f"r{r}.json").read_text())["legs"] for r in range(world)]


def _jax_tokens(params, layout, draft=None, kv="model"):
    """Greedy rows of JAX's single-process Engine with spec_k 3."""
    eng = JEngine(J_CFG, params, JEngineConfig(max_batch=4, max_seq_len=128, max_prefill_len=16, eos_token_id=EOS,
                                               kv_layout=layout, spec_k=3, kv_cache_dtype=kv),
                  draft=draft)
    eng.start()
    try:
        return [eng.generate(PLAN["requests"][i]["prompt"], max_tokens=12, temperature=0.0) for i in GREEDY_ROWS]
    finally:
        eng.stop()


def _check(ranks, leg, want, label):
    """The leader's greedy rows are `want`; every rank's rows (the sampled
    one too) are the leader's; the gang verified wider than one token."""
    lead = ranks[0][leg]
    rows = [q["tokens"] for q in lead["requests"]]
    assert [rows[i] for i in GREEDY_ROWS] == want, label
    assert EOS not in [t for r in rows for t in r], label  # every stream ran to its budget
    for r in ranks[1:]:
        assert [q["tokens"] for q in r[leg]["requests"]] == rows, label
        assert r[leg]["error"] is None and r[leg]["stopped"], label
    assert len(rows[2]) == 8 and lead["stats"]["verify_passes"] > 0, (label, lead["stats"])
    assert lead["stats"]["spec_proposed"] > 0 and "speculation k=3" in lead["startup"], label
    return lead


def test_lookup_gang_matches_jax_dense_paged_and_int4(weights, tmp_path):
    """Prompt lookup at tensor=2 on the dense cache, the paged pool, and
    int4 weights with an int8 cache on the dense cache: JAX's single
    spec Engine's greedy tokens, the follower the leader's."""
    target, _, path, _ = weights
    legs = [{**BASE, "kv_layout": "dense"}, {**BASE, "kv_layout": "paged"},
            {**BASE, "kv_layout": "dense", "quantize": "int4", "kv_cache_dtype": "int8"}]
    ranks = _gang(tmp_path, path, legs)
    prev = jquant4._FORCE_IMPL
    jquant4.set_q4_impl("xla")
    try:
        q4 = jquant4.quantize4_params(target, jllama.quant_contracting(J_CFG))
        int4 = _jax_tokens(q4, "dense", kv="int8")
    finally:
        jquant4.set_q4_impl(prev)
    for i, (layout, want) in enumerate((("dense", _jax_tokens(target, "dense")),
                                        ("paged", _jax_tokens(target, "paged")), ("int4", int4))):
        lead = _check(ranks, i, want, layout)
        assert "prompt lookup" in lead["startup"] and "heads 2 kv heads 1 per rank" in lead["startup"]
        assert lead["mesh"]["tensor"] == 2 and "decode step eager" in lead["startup"]


def test_draft_gang_matches_jax(weights, tmp_path):
    """A one-layer draft (JAX's multi-host test's, key 9) on the paged
    pool, sharded at tensor=2 like the target: JAX's single Engine's
    greedy tokens with the same draft, the follower the leader's, the
    draft's chunks prefilled on every rank."""
    target, draft, path, draft_path = weights
    ranks = _gang(tmp_path, path, [{**BASE, "kv_layout": "paged", "draft_model": draft_path}])
    want = _jax_tokens(target, "paged", draft=(J_CFG.replace(n_layers=1), draft))
    lead = _check(ranks, 0, want, "draft")
    assert "a draft of 1 layers (2 heads, 1 kv heads a rank)" in lead["startup"]
    assert lead["stats"]["draft_prefill_chunks"] > 0


def test_four_ranks_of_data_and_tensor_match_jax(weights, tmp_path):
    """data=2 x tensor=2 over four ranks: the verify runs each replica's
    rows and exchanges the choices and samples, the draft its proposals;
    lookup on the dense cache and the paged pool and the draft on the
    pool give JAX's single Engine's greedy tokens, all four ranks the
    leader's rows, each replica owning rows."""
    target, draft, path, draft_path = weights
    legs = [{**BASE, "kv_layout": "dense", "tensor": 2}, {**BASE, "kv_layout": "paged", "tensor": 2},
            {**BASE, "kv_layout": "paged", "tensor": 2, "draft_model": draft_path}]
    ranks = _gang(tmp_path, path, legs, world=4, timeout=300)
    wants = (_jax_tokens(target, "dense"), _jax_tokens(target, "paged"),
             _jax_tokens(target, "paged", draft=(J_CFG.replace(n_layers=1), draft)))
    for i, want in enumerate(wants):
        lead = _check(ranks, i, want, f"leg {i}")
        assert lead["mesh"]["data"] == 2 and [r[i]["rows"] for r in ranks] == [[0, 2], [0, 2], [2, 4], [2, 4]]
        assert len(lead["exchange_s"]) >= lead["stats"]["decode_steps"] > 0


def test_a_draft_whose_heads_the_axis_does_not_divide_exits():
    """serve.main's gang_draft: a draft of one kv head at tensor=2 exits
    naming ROADMAP (JAX keeps such heads whole on every device); a draft
    whose heads divide is sharded like the target (its heads halved, its
    forward summing over the tensor group)."""
    from substratus_tpu_torch.models import llama
    from substratus_tpu_torch.parallel.mesh import build_mesh
    from substratus_tpu_torch.serve import main

    mesh = build_mesh(tensor=2, world=2, rank=1)
    mesh.groups["tensor"] = None  # a rank's shard needs the axis's group only in its forward
    cfg = llama.CONFIGS["tiny"].replace(n_layers=1)
    with pytest.raises(SystemExit, match=r"a draft model of 4 heads and 1 kv heads at tensor=2: .* ROADMAP Queue 1"):
        main.gang_draft(llama, cfg.replace(n_kv_heads=1), llama.init_params(cfg.replace(n_kv_heads=1), seed=1,
                                                                             device="cpu"), mesh)
    dcfg, shard = main.gang_draft(llama, cfg, llama.init_params(cfg, seed=1, device="cpu"), mesh)
    assert (dcfg.n_heads, dcfg.n_kv_heads, shard.tp.size, shard.tp.index) == (2, 1, 2, 1)


def _http(port, path, body=None, headers=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.read().decode()


@pytest.mark.parametrize("mode", ["lookup", "draft"])
def test_serve_main_gang_serves_speculation_over_http(weights, tmp_path, mode):
    """Two serve.main ranks at tensor=2 on the paged pool with spec_k 3,
    by prompt lookup or with the draft artifact (serve.main loads it and
    its gang_draft shards it, the startup lines say so): PLAN's requests at
    once over HTTP, each greedy completion's tokens (its journey's emits)
    exactly JAX's single spec Engine's, the gang's verify passes on
    /metrics above 0, both ranks 0 on the leader's SIGTERM."""
    target, draft, path, _ = weights
    folder = os.path.dirname(path)
    params = {**BASE, "model": os.path.join(folder, "tiny"), "kv_layout": "paged", "tensor": 2}
    if mode == "draft":
        params["draft_model"] = os.path.join(folder, "draft")
    (tmp_path / "p.json").write_text(json.dumps(params))
    port, http = _free_port(), _free_port()
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1", "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
           "JAX_NUM_PROCESSES": "2"}
    procs = [subprocess.Popen([sys.executable, "-m", "substratus_tpu_torch.serve.main", "--device", "cpu", "--params",
                               str(tmp_path / "p.json"), "--host", "127.0.0.1", "--port", str(http)],
                              cwd=REPO, env={**env, "TPU_WORKER_ID": str(r)}, stdout=subprocess.PIPE,
                              stderr=open(tmp_path / f"err{r}.txt", "w"), text=True) for r in range(2)]
    try:
        lines = []
        for p, prefix in zip(procs, ("serving tiny", "gang follower")):
            got = []
            t = threading.Thread(target=lambda p=p, prefix=prefix, got=got: got.append(next(
                (ln for ln in iter(p.stdout.readline, "") if ln.startswith(prefix)), "")), daemon=True)
            t.start()
            t.join(timeout=180)
            lines.append(got[0] if got else "")
        want_spec = ("speculation prompt-lookup k=3" if mode == "lookup" else
                     f"speculation draft={params.get('draft_model')} k=3 (2 heads, 1 kv heads a rank)")
        for line in lines:
            assert want_spec in line and "mesh tensor=2" in line, (line, [
                (tmp_path / f"err{r}.txt").read_text()[-2000:] for r in range(2)])
        results = [None] * len(PLAN["requests"])

        def one(i, spec):
            text = bytes(spec["prompt"][1:]).decode()
            body = {"prompt": text, "max_tokens": spec["max_tokens"], "temperature": spec.get("temperature", 0.0)}
            results[i] = _http(http, "/v1/completions", body, {"traceparent": f"00-{i + 1:032x}-{'ab' * 8}-01"})

        threads = [threading.Thread(target=one, args=(i, spec)) for i, spec in enumerate(PLAN["requests"])]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        assert all(json.loads(r)["usage"]["completion_tokens"] for r in results), results
        rows = []
        for i in GREEDY_ROWS:
            journey = json.loads(_http(http, f"/debug/requestz?id={i + 1:032x}"))["journey"]
            rows.append([e[2]["t"] for e in journey["events"] if e[1] == "emit"])
        metrics = _http(http, "/metrics")
        passes = next(float(ln.split()[-1]) for ln in metrics.splitlines()
                      if ln.startswith("substratus_serve_verify_passes "))
        procs[0].send_signal(signal.SIGTERM)
        rcs = [p.wait(timeout=90) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)
    want = _jax_tokens(target, "paged", draft=(J_CFG.replace(n_layers=1), draft) if mode == "draft" else None)
    assert rows == want and passes > 0 and rcs == [0, 0], (rows, want, passes, rcs)
