"""Multi-tenant adapters in a serving gang of the port against the JAX
package, on the CPU.

The tenants: t0 and t1 are exactly the JAX package's
tools/multihost_serve_worker.py::build_adapter_store's (wq and wv, rank 4,
scale 2), and t2 adapts every projection (wq, wk, wv, wo, w_gate, w_up,
w_down), written as adapter artifacts into one directory. Two gloo
processes of tools/gang_worker.py serve JAX's test configuration (tiny,
vocab 258, f32, eos 257) at tensor=2 with a store of capacity 2 built by
serve.main's build_adapter_store from that directory: base, t0 and t1 run
in one batch, then t2 boards once t0's request has ended, hot-loaded with
an LRU eviction. Each rank's store holds its slice of every tenant (b by
output columns for wq/wk/wv/w_gate/w_up, a by input rows for wo and a
summed w_down); the legs cover the dense cache and the paged pool in f32,
int4 weights whose w_down is kept whole (tiny at tensor 2: its a whole,
the activation gathered), int4 whose w_down is row-parallel (the wider
dims of tests/test_sharded_serving.py) and w8a8, whose row-parallel w_down
sums inside its s8 product, so its delta's partial sum is reduced apart.
Every leader row is exactly the tokens of JAX's single-process Engine with
a JAX store over the same artifacts, every follower row the leader's, the
two tenants' tokens differ. An artifact the follower cannot find fails the
gang: both ranks exit non-zero on the admission check, not hang. Each
process has its own timeout.
"""
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substratus_tpu.models import llama as jllama
from substratus_tpu.ops import quant4 as jquant4
from substratus_tpu.ops.quant import quantize_params as j_quantize_params
from substratus_tpu.serve import adapters as jadapters
from substratus_tpu.serve.engine import Engine as JEngine
from substratus_tpu.serve.engine import EngineConfig as JEngineConfig
from substratus_tpu.train.lora import init_lora
from substratus_tpu_torch.bridge import params_from_jax
from substratus_tpu_torch.serve.adapters import save_adapter_artifact

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EOS = 257
ALL = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
ROW_DIMS = dict(dim=256, n_heads=4, n_kv_heads=4, head_dim=64, hidden_dim=512)  # tests/test_sharded_serving.py:90-93
TENANT_PROMPT = [256, 10, 20, 30]
PLAN = {"concurrent": True, "requests": [
    {"prompt": [256, 5, 6, 7], "max_tokens": 6}, {"prompt": TENANT_PROMPT, "max_tokens": 6, "adapter": "t0"},
    {"prompt": TENANT_PROMPT, "max_tokens": 6, "adapter": "t1"},
    {"prompt": TENANT_PROMPT, "max_tokens": 6, "adapter": "t2", "after": 1}]}
BASE = {"max_batch": 4, "max_seq_len": 64, "max_prefill_len": 16, "adapters": {"capacity": 2}}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jcfg(dims):
    return jllama.CONFIGS["tiny"].replace(vocab_size=258, dtype=jnp.float32, **dims)


def _tenants(jcfg, folder):
    """t0, t1 as the JAX worker's build_adapter_store installs them (its
    install calls captured), t2 over every target (init_lora, b drawn as
    the worker draws it), written as artifacts of rank 4, alpha 8 (the
    worker's scale 2) into `folder`."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from multihost_serve_worker import build_adapter_store

    trees, install = {}, jadapters.AdapterStore.install

    def capture(self, aid, layers, scale=1.0):
        trees[aid] = (layers, scale)
        return install(self, aid, layers, scale)

    jadapters.AdapterStore.install = capture
    try:
        build_adapter_store(jcfg, 2)
    finally:
        jadapters.AdapterStore.install = install
    full = init_lora(jcfg, jax.random.key(70), rank=4, alpha=8.0, targets=ALL, dtype=jnp.float32)
    for j, name in enumerate(sorted(full)):
        full[name]["b"] = jax.random.normal(jax.random.key(700 + j), full[name]["b"].shape, jnp.float32) * 0.1
    trees["t2"] = (jax.tree.map(np.asarray, full), 2.0)
    for aid, (layers, scale) in trees.items():
        assert scale == 2.0
        save_adapter_artifact(os.path.join(folder, aid), layers, alpha=8.0, rank=4)


@pytest.fixture(scope="module")
def setups(tmp_path_factory):
    """Per configuration: JAX's f32 weights (key 0), the port's copy as a
    file, and the tenants' directory."""
    out = {}
    for name, dims in (("tiny", {}), ("row", ROW_DIMS)):
        tmp = tmp_path_factory.mktemp(f"gang_adapters_{name}")
        jcfg = _jcfg(dims)
        params = jllama.init_params(jcfg, jax.random.key(0))
        torch.save(params_from_jax(jax.device_get(params)), tmp / "w.pt")
        os.makedirs(tmp / "adapters")
        _tenants(jcfg, str(tmp / "adapters"))
        out[name] = (jcfg, params, str(tmp / "w.pt"), str(tmp / "adapters"))
    return out


def _launch(tmp_path, setup, legs, dirs, shape=None):
    jcfg, _, weights_file, _ = setup
    port = _free_port()
    (tmp_path / "plan.json").write_text(json.dumps(PLAN))
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1", "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
           "JAX_NUM_PROCESSES": "2"}
    extra = ["--shape", shape] if shape else []
    return [subprocess.Popen(
        [sys.executable, "-m", "substratus_tpu_torch.tools.gang_worker", "--device", "cpu", "--config", "tiny",
         "--weights", weights_file, "--vocab", "258", "--dtype", "float32", "--eos", str(EOS), "--params",
         json.dumps(legs), "--requests", str(tmp_path / "plan.json"), "--out", str(tmp_path / f"r{r}.json"),
         "--adapters-dir", dirs[r], "--timeout", "60", *extra],
        cwd=REPO, env={**env, "TPU_WORKER_ID": str(r)}, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]


def _finish(procs, timeout=240):
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)
    return [p.returncode for p in procs], logs


def _jax_rows(setup, mode, layout):
    """Each plan request's greedy tokens from JAX's single Engine with a
    JAX store of capacity 2 over the same artifacts (t0, t1 preloaded)."""
    jcfg, params, _, folder = setup
    if mode == "int4":
        params = jquant4.quantize4_params(params, jllama.quant_contracting(jcfg))
    elif mode == "w8a8":
        params = j_quantize_params(params, jllama.quant_contracting(jcfg))
        jcfg = jcfg.replace(quant_activations=True)
    store = jadapters.AdapterStore(jcfg, capacity=2, rank=4, targets=ALL, dtype=jnp.float32, search_dir=folder)
    for aid in ("t0", "t1"):
        store.load(aid)
    eng = JEngine(jcfg, params, JEngineConfig(max_batch=4, max_seq_len=64, max_prefill_len=16, eos_token_id=EOS,
                                              kv_layout=layout), adapters=store)
    eng.start()
    try:
        return [eng.generate(q["prompt"], max_tokens=6, temperature=0.0, adapter=q.get("adapter"))
                for q in PLAN["requests"]]
    finally:
        eng.stop()


def _check(ranks, leg, want, label):
    lead = ranks[0][leg]
    rows = [q["tokens"] for q in lead["requests"]]
    assert rows == want, (label, rows, want)
    assert [q["tokens"] for q in ranks[1][leg]["requests"]] == rows, label
    assert rows[1] != rows[2] and rows[3] not in (rows[1], rows[2]), (label, rows)
    assert lead["stats"]["adapter_requests"] == 3 and lead["adapters"]["evictions"] >= 1, (label, lead["adapters"])
    assert ranks[1][leg]["adapters"] == lead["adapters"] and "t2" in lead["adapters"]["loaded"], label
    assert "adapter store capacity 2, rank 4" in lead["startup"], label
    return lead


def _jax_q4(fn):
    prev = jquant4._FORCE_IMPL
    jquant4.set_q4_impl("xla")
    try:
        return fn()
    finally:
        jquant4.set_q4_impl(prev)


def test_tenants_at_tensor_2_match_jax(setups, tmp_path):
    """tiny at tensor=2: dense and paged f32, int4 (w_down kept whole) and
    w8a8 (w_down row-parallel) on the dense cache, in one gang: JAX's
    single Engine's rows, the follower the leader's, a hot load with an
    LRU eviction alike on both ranks."""
    setup = setups["tiny"]
    legs = [{**BASE, "kv_layout": "dense"}, {**BASE, "kv_layout": "paged"},
            {**BASE, "kv_layout": "dense", "quantize": "int4"}, {**BASE, "kv_layout": "dense", "quantize": "w8a8"}]
    rcs, logs = _finish(_launch(tmp_path, setup, legs, [setup[3]] * 2))
    assert rcs == [0, 0], logs
    ranks = [json.loads((tmp_path / f"r{r}.json").read_text())["legs"] for r in range(2)]
    _check(ranks, 0, _jax_rows(setup, "none", "dense"), "dense")
    _check(ranks, 1, _jax_rows(setup, "none", "paged"), "paged")
    lead = _check(ranks, 2, _jax_q4(lambda: _jax_rows(setup, "int4", "dense")), "int4")
    assert "w_down int4 whole" in lead["startup"], lead["startup"]
    lead = _check(ranks, 3, _jax_rows(setup, "w8a8", "dense"), "w8a8")
    assert "w_down int8 row-parallel" in lead["startup"], lead["startup"]


def test_tenants_on_a_row_parallel_int4_w_down_match_jax(setups, tmp_path):
    """int4 at the wider dims (hidden 512: each rank's w_down slice is
    whole scale groups), dense and paged: JAX's single Engine's rows."""
    setup = setups["row"]
    legs = [{**BASE, "kv_layout": layout, "quantize": "int4"} for layout in ("dense", "paged")]
    shape = ",".join(f"{k}={v}" for k, v in ROW_DIMS.items() if k != "head_dim")  # dim // n_heads already
    rcs, logs = _finish(_launch(tmp_path, setup, legs, [setup[3]] * 2, shape=shape))
    assert rcs == [0, 0], logs
    ranks = [json.loads((tmp_path / f"r{r}.json").read_text())["legs"] for r in range(2)]
    for i, layout in enumerate(("dense", "paged")):
        lead = _check(ranks, i, _jax_q4(lambda: _jax_rows(setup, "int4", layout)), layout)
        assert "w_down int4 row-parallel" in lead["startup"], lead["startup"]


def test_an_artifact_missing_on_the_follower_fails_the_gang(setups, tmp_path):
    """The follower's directory lacks t2: at t2's admission the leader
    loads it and the follower cannot; the ranks' admission check differs,
    and both exit non-zero with the disagreement named, within their
    timeouts."""
    setup = setups["tiny"]
    partial = tmp_path / "partial"
    partial.mkdir()
    for aid in ("t0", "t1"):
        os.symlink(os.path.join(setup[3], aid), partial / aid)
    rcs, logs = _finish(_launch(tmp_path, setup, [{**BASE, "kv_layout": "dense"}], [setup[3], str(partial)]),
                        timeout=180)
    assert rcs[0] != 0 and rcs[1] != 0, logs
    for r in range(2):
        leg = json.loads((tmp_path / f"r{r}.json").read_text())["legs"][0]
        assert "gang ranks disagree on adapter 't2'" in leg["error"], leg["error"]
    lead = json.loads((tmp_path / "r0.json").read_text())["legs"][0]
    assert [q["finish_reason"] for q in lead["requests"]][3] == "error"

