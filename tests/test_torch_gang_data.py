"""Gangs of the port with a data axis (data=2 x tensor=2, four gloo
processes on the CPU) against the JAX package.

Four ranks of tools/gang_worker.py serve JAX's test configuration (tiny,
vocab 258, f32, eos 257) in one gang, leg after leg: the dense cache and
the paged pool, f32 and int4 (the whole weights quantized by the port's
quantize4, byte for byte JAX's quantize4_params, then sharded). Each leg
submits four requests at once, so both data replicas own rows: the prompts
of tests/test_sharded_serving.py, a sampled row and a longer prompt. Every
greedy row is exactly the tokens of JAX's single-device Engine and of
JAX's in-process data x tensor Engine (int4 with JAX's xla lowering, as
its test pins it); all four ranks deliver the same tokens, the sampled
row's too; max_batch 3 rounds up to 4 as the JAX entry point rounds it. A
dense w8a8 leg (w_down row-parallel: the amax and the s32 partials summed
over the tensor group) gives JAX's single w8a8 Engine's tokens. A
paged leg on a small pool takes a prompt's prefix pages, written by the
other data replica's admission, from the registry and preempts and
resumes a request, and still gives JAX's tokens. A SIGKILLed rank of the
other data replica fails the leader (exit 1) within the collective
timeout, and serve.main under the llama2-70b example's params (int4, int8
cache, tensor 2, max_batch rounded) serves on the leader and ends all four
ranks with 0 on its SIGTERM.
"""
import json
import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import pytest
import torch

from substratus_tpu.models import llama as jllama
from substratus_tpu.ops import quant4 as jquant4
from substratus_tpu.ops.quant import quantize_params as j_quantize_params
from substratus_tpu.parallel.mesh import build_mesh as j_build_mesh
from substratus_tpu.serve.engine import Engine as JEngine
from substratus_tpu.serve.engine import EngineConfig as JEngineConfig
from substratus_tpu_torch.bridge import params_from_jax
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.parallel import mesh as pmesh
from substratus_tpu_torch.serve import main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EOS = 257
J_CFG = jllama.CONFIGS["tiny"].replace(vocab_size=258, dtype=jnp.float32)
PROMPTS = [[256, 5, 6, 7], [256, 70, 71]]  # tests/test_sharded_serving.py's
LONGER = [256] + [(11 + 7 * i) % 250 for i in range(40)]
PLAN = {"concurrent": True, "requests": [
    {"prompt": PROMPTS[0], "max_tokens": 6}, {"prompt": PROMPTS[1], "max_tokens": 6},
    {"prompt": [256, 9, 10], "max_tokens": 6, "temperature": 0.7}, {"prompt": LONGER, "max_tokens": 6}]}
GREEDY_ROWS = (0, 1, 3)
PREFIX = [256] + [(13 + 11 * i) % 250 for i in range(47)]  # 48 tokens: three pages of 16
PREFIX_PLAN = {"concurrent": True, "requests": [  # the two prefix prompts board slots 0 and 2: one a replica
    {"prompt": PREFIX + [40, 41, 42], "max_tokens": 40}, {"prompt": PREFIX + [60, 61], "max_tokens": 40},
    {"prompt": [256, 90, 91, 92], "max_tokens": 40}, {"prompt": LONGER, "max_tokens": 40}]}
BASE = {"max_batch": 3, "max_seq_len": 128, "max_prefill_len": 16, "tensor": 2}
LEGS = [{**BASE, "kv_layout": layout, "quantize": q} for q in ("none", "int4") for layout in ("dense", "paged")]
POOL = {**BASE, "kv_layout": "paged", "kv_pool_tokens": 144}
W8A8 = {**BASE, "kv_layout": "dense", "quantize": "w8a8"}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(rank: int, port: int, world: int = 4) -> dict:
    return {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1", "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
            "JAX_NUM_PROCESSES": str(world), "TPU_WORKER_ID": str(rank)}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """JAX's tiny f32 weights (key 0), and the port's copy as a file."""
    j_params = jllama.init_params(J_CFG, jax.random.key(0))
    path = tmp_path_factory.mktemp("gang_data") / "tiny.pt"
    torch.save(params_from_jax(jax.device_get(j_params)), path)
    return j_params, str(path)


def _workers(tmp_path, weights_file, legs, plans, extra=()):
    port = _free_port()
    (tmp_path / "plans.json").write_text(json.dumps(plans))
    return [subprocess.Popen(
        [sys.executable, "-m", "substratus_tpu_torch.tools.gang_worker", "--device", "cpu", "--config", "tiny",
         "--weights", weights_file, "--vocab", "258", "--dtype", "float32", "--eos", str(EOS), "--params",
         json.dumps(legs), "--requests", str(tmp_path / "plans.json"), "--out", str(tmp_path / f"r{r}.json"),
         "--timeout", "60", *extra],
        cwd=REPO, env=_env(r, port), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(4)]


def _finish(procs, timeout=120):
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        _reap(procs)
    return [p.returncode for p in procs], logs


def _reap(procs):
    for p in procs:
        p.kill()
        p.wait(timeout=30)


def _jax_tokens(params, layout, prompts, mesh=None, max_tokens=6, cfg=J_CFG):
    """Greedy tokens of JAX's Engine (one device, or over `mesh`)."""
    eng = JEngine(cfg, params, JEngineConfig(max_batch=4, max_seq_len=128, max_prefill_len=16, eos_token_id=EOS,
                                               kv_layout=layout), mesh=mesh)
    eng.start()
    try:
        return [eng.generate(p, max_tokens=max_tokens, temperature=0.0) for p in prompts]
    finally:
        eng.stop()


def test_data_tensor_gang_matches_jax_single_and_sharded_engines(weights, tmp_path):
    """Legs dense/paged x f32/int4, then the prefix-and-preemption leg, in
    one gang of four: every greedy row JAX's single Engine's and its data x
    tensor Engine's, all ranks' rows equal (the sampled one too), the mesh
    coordinates rank = d * 2 + t, max_batch 3 served as 4 with slots 0-1 on
    replica 0; the prefix leg hit pages across the replicas and preempted;
    the leader's stop ended every rank with 0."""
    j_params, path = weights
    procs = _workers(tmp_path, path, LEGS + [POOL, W8A8], [PLAN] * len(LEGS) + [PREFIX_PLAN, PLAN])
    try:
        greedy = [PLAN["requests"][i]["prompt"] for i in GREEDY_ROWS]
        q4 = jquant4.quantize4_params(j_params, jllama.quant_contracting(J_CFG))
        jmesh = j_build_mesh(data=2, tensor=2, fsdp=2)
        prev = jquant4._FORCE_IMPL
        jquant4.set_q4_impl("xla")
        try:
            want = {}
            for leg in LEGS:
                params = q4 if leg["quantize"] == "int4" else j_params
                single = _jax_tokens(params, leg["kv_layout"], greedy)
                assert _jax_tokens(params, leg["kv_layout"], greedy, jmesh) == single, leg
                want[(leg["quantize"], leg["kv_layout"])] = single
        finally:
            jquant4.set_q4_impl(prev)
        prefix_want = _jax_tokens(j_params, "paged", [r["prompt"] for r in PREFIX_PLAN["requests"]], max_tokens=40)
        w8a8_want = _jax_tokens(j_quantize_params(j_params, jllama.quant_contracting(J_CFG)), "dense", greedy,
                                cfg=J_CFG.replace(quant_activations=True))
        rcs, logs = _finish(procs)
    finally:
        _reap(procs)
    assert rcs == [0] * 4, logs
    ranks = [json.loads((tmp_path / f"r{r}.json").read_text())["legs"] for r in range(4)]
    for i, leg in enumerate(LEGS):
        lead = ranks[0][i]
        rows = [q["tokens"] for q in lead["requests"]]
        assert [rows[j] for j in GREEDY_ROWS] == want[(leg["quantize"], leg["kv_layout"])], leg
        for r in range(1, 4):
            assert [q["tokens"] for q in ranks[r][i]["requests"]] == rows, (leg, r)
        assert len(rows[2]) == 6 and all(r[i]["error"] is None for r in ranks)
        assert lead["max_batch"] == 4 and lead["mesh"]["data"] == 2 and lead["mesh"]["tensor"] == 2
        assert [r[i]["coords"]["data"] * 2 + r[i]["coords"]["tensor"] for r in ranks] == [0, 1, 2, 3]
        assert [r[i]["rows"] for r in ranks] == [[0, 2], [0, 2], [2, 4], [2, 4]]
        assert len(lead["exchange_s"]) == lead["stats"]["decode_steps"] > 0
        assert "data=2 tensor=2" in lead["startup"] and f"weights {leg['quantize']}" in lead["startup"]
    assert "w_down int4 whole" in ranks[0][2]["startup"] and "wo int4 row-parallel" in ranks[0][2]["startup"]
    pool = [r[len(LEGS)] for r in ranks]
    assert [q["tokens"] for q in pool[0]["requests"]] == prefix_want
    assert all([q["tokens"] for q in r["requests"]] == prefix_want for r in pool[1:])
    assert pool[0]["stats"]["prefix_hit_tokens"] >= 48 and pool[0]["stats"]["preemptions"] > 0, pool[0]["stats"]
    w8a8 = [r[len(LEGS) + 1] for r in ranks]
    rows = [q["tokens"] for q in w8a8[0]["requests"]]
    assert [rows[j] for j in GREEDY_ROWS] == w8a8_want and all([q["tokens"] for q in r["requests"]] == rows
                                                               for r in w8a8[1:])


def test_killed_rank_of_the_other_replica_fails_the_gang(weights, tmp_path):
    """The leader idles after its requests (--hold); a SIGKILL of rank 3
    (data replica 1) fails its next collective: it exits 1 with its
    engine's error, within its 60 s collective timeout."""
    procs = _workers(tmp_path, weights[1], [LEGS[1]], [PLAN], extra=("--hold",))
    try:
        deadline = time.monotonic() + 120
        while not (tmp_path / "r0.json.hold").exists():
            assert time.monotonic() < deadline and procs[0].poll() is None, "the leader never reached its hold"
            time.sleep(0.1)
        t_kill = time.monotonic()
        procs[3].send_signal(signal.SIGKILL)
        rc = procs[0].wait(timeout=90)
        waited = time.monotonic() - t_kill
    finally:
        _reap(procs)
    assert rc == 1 and waited < 60, (rc, waited)
    r0 = json.loads((tmp_path / "r0.json").read_text())["legs"][0]
    assert r0["error"] is not None and r0["held"]


def test_mesh_and_batch_follow_the_jax_entry_point(monkeypatch):
    """gang_mesh's loop and its line: llama2-70b's 8 kv heads lower the
    example's tensor 16 on 16 ranks to data=2 x tensor=8, tensor 2 on four
    ranks is data=2 x tensor=2; max_batch rounds up to a multiple of data
    (JAX's serve/main.py:359-360)."""
    cfg70 = llama.CONFIGS["llama2-70b"]
    built = []
    monkeypatch.setattr(pmesh, "build_mesh", lambda **kw: built.append(kw) or pmesh.Mesh(
        shape={a: kw.get(a, 1) for a in pmesh.MESH_AXES}))
    monkeypatch.setattr(main.distributed, "world_info", lambda: ("h:1", 16, 0))
    m = main.gang_mesh(16, {"tensor": 16}, cfg70)
    assert built[-1] == {"data": 2, "tensor": 8} and main.mesh_line(m) == "serving mesh: data=2 tensor=8"
    assert [main.gang_batch(b, m) for b in (32, 3, 1, 8)] == [32, 4, 2, 8]
    m = main.gang_mesh(4, {"tensor": 2}, cfg70)
    assert built[-1] == {"data": 2, "tensor": 2} and main.mesh_line(m) == "serving mesh: data=2 tensor=2"
    main.gang_mesh(4, {}, llama.CONFIGS["tiny"])
    assert built[-1] == {"data": 2, "tensor": 2}


def _first_line(proc, prefix, timeout=120):
    """The first stdout line of `proc` starting with `prefix`."""
    lines = queue.Queue()

    def read():
        for line in proc.stdout:
            if line.startswith(prefix):
                lines.put(line)
                return
        lines.put("")

    threading.Thread(target=read, daemon=True).start()
    return lines.get(timeout=timeout)


def test_serve_main_gang_of_the_70b_example_params(tmp_path):
    """serve.main x 4 under examples/llama2-70b/server.yaml's params with
    tensor 2 (int4 weights, int8 cache, max_batch rounded, the paged
    default) on tiny: each rank prints the mesh line data=2 tensor=2; the
    leader's startup line names the weights' layout and answers a
    completion; a SIGTERM to it ends all four ranks with 0."""
    params = {"config": "tiny", "quantize": "int4", "kv_cache_dtype": "int8", "max_batch": 3, "tensor": 2,
              "max_seq_len": 128}
    (tmp_path / "p.json").write_text(json.dumps(params))
    port, http = _free_port(), _free_port()
    procs = [subprocess.Popen([sys.executable, "-m", "substratus_tpu_torch.serve.main", "--device", "cpu", "--params",
                               str(tmp_path / "p.json"), "--host", "127.0.0.1", "--port", str(http)],
                              cwd=REPO, env=_env(r, port), stdout=subprocess.PIPE,
                              stderr=open(tmp_path / f"err{r}.txt", "w"), text=True) for r in range(4)]
    try:
        lead = _first_line(procs[0], "serving tiny")
        lines = [_first_line(p, "serving mesh") for p in procs]
        assert all(ln.strip() == "serving mesh: data=2 tensor=2" for ln in lines), lines
        assert "rank 0/4 (leader), mesh data=2 tensor=2" in lead and "weights int4: " in lead, lead
        assert "w_down int4 whole" in lead and "max_batch 4 (slots 0-1" in lead, lead
        body = json.dumps({"prompt": "hi", "max_tokens": 5, "temperature": 0}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{http}/v1/completions", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert json.loads(resp.read())["usage"]["completion_tokens"] >= 1
        procs[0].send_signal(signal.SIGTERM)
        rcs = [p.wait(timeout=90) for p in procs]
    finally:
        _reap(procs)
    assert rcs == [0] * 4, [(tmp_path / f"err{r}.txt").read_text()[-2000:] for r in range(4)]
