"""Lockstep serving gangs of the port against the JAX package, on the CPU.

Two gloo processes of tools/gang_worker.py (the operator's environment:
JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES=2, TPU_WORKER_ID) serve JAX's
test configuration (tiny, vocab 258, f32, eos 257, max_batch 4, the
prompts of tests/test_multihost_serving.py) as a tensor=2 gang, each rank
holding its shard of JAX's weights (bridge.params_from_jax, sliced by
parallel.sharding). The greedy tokens are exactly those of JAX's
single-process Engine and of the port's own single engine, on the dense
cache and on the paged pool; the follower's tokens, the sampled row's
among them, equal the leader's; a cancel mid-stream latches through the
broadcast; a 201-token prompt takes the overflow broadcast; the tensor
parallel forward's logits are within 1e-5 (relative, a row) of JAX's
llama.forward, tiny-moe's too; four ranks of tensor=4, where the vocab
stays whole, give JAX's tokens and logits as well. A SIGKILLed follower fails the leader (exit 1, not a
hang), and serve.main's gang answers HTTP on the leader only and ends
both ranks with 0 on the leader's SIGTERM, with prompt lookup and an
adapter store too. The engine's lockstep logic (the leader's frames, a
follower's mirror, cancel latches, the swap barrier, the refusals) is
held against JAX's messages in process with a scripted sync. Each process
has its own timeout.
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
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substratus_tpu.models import llama as jllama
from substratus_tpu.serve.engine import Engine as JEngine
from substratus_tpu.serve.engine import EngineConfig as JEngineConfig
from substratus_tpu_torch.bridge import params_from_jax
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.serve import main
from substratus_tpu_torch.serve import multihost as mh
from substratus_tpu_torch.serve.engine import Engine, EngineConfig, Request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EOS = 257
J_CFG = jllama.CONFIGS["tiny"].replace(vocab_size=258, dtype=jnp.float32)
T_CFG = llama.CONFIGS["tiny"].replace(vocab_size=258, dtype=torch.float32)
LONG = [256] + [(7 + 13 * i) % 250 for i in range(200)]  # > INLINE bytes on the wire
GREEDY = [[256, 5, 6, 7], [256, 70, 71], LONG]
PLAN = {"concurrent": False, "requests": [
    {"prompt": GREEDY[0], "max_tokens": 6}, {"prompt": GREEDY[1], "max_tokens": 6},
    {"prompt": [256, 9, 10], "max_tokens": 6, "temperature": 0.7}, {"prompt": LONG, "max_tokens": 6},
    {"prompt": [256, 70, 71], "max_tokens": 24, "cancel_after": 3}]}
GREEDY_ROWS = (0, 1, 3)
LOGIT_BATCH = [[256, 5, 6, 7, 8, 9], [256, 70, 71, 72, 0, 1]]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gang_env(rank: int, port: int, world: int = 2) -> dict:
    return {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1", "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
            "JAX_NUM_PROCESSES": str(world), "TPU_WORKER_ID": str(rank)}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """JAX's tiny f32 weights (key 0), the port's copy, and that copy as a
    state-dict file the workers load."""
    j_params = jllama.init_params(J_CFG, jax.random.key(0))
    state = params_from_jax(jax.device_get(j_params))
    t_params = llama.Llama(T_CFG, device="cpu")
    t_params.load_state_dict(state)
    path = tmp_path_factory.mktemp("gang") / "tiny.pt"
    torch.save(state, path)
    return j_params, t_params, str(path)


def _single(engine) -> list:
    engine.start()
    try:
        return [engine.generate(p, max_tokens=6, temperature=0.0) for p in GREEDY]
    finally:
        engine.stop()


def _launch(tmp_path, weights_file, layout, extra=(), world=2, plan=PLAN):
    """`world` gang_worker ranks over the tiny weights in `weights_file`
    (`extra`: more flags, e.g. --shape for the weights' config)."""
    port = _free_port()
    (tmp_path / "plan.json").write_text(json.dumps(plan))
    (tmp_path / "batch.json").write_text(json.dumps(LOGIT_BATCH))
    params = json.dumps({"kv_layout": layout, "max_batch": 4, "max_seq_len": 256, "max_prefill_len": 64})
    return [subprocess.Popen(
        [sys.executable, "-m", "substratus_tpu_torch.tools.gang_worker", "--device", "cpu", "--config", "tiny",
         "--weights", weights_file, "--vocab", "258", "--dtype", "float32", "--eos", str(EOS), "--params", params,
         "--requests", str(tmp_path / "plan.json"), "--out", str(tmp_path / f"r{r}.json"), "--logits",
         str(tmp_path / "batch.json"), "--timeout", "60", *extra],
        cwd=REPO, env=_gang_env(r, port, world), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


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


def _references(weights, layout):
    """The greedy rows of JAX's single engine, asserted equal to the
    port's single engine's."""
    j_params, t_params, _ = weights
    want = _single(JEngine(J_CFG, j_params, JEngineConfig(max_batch=4, max_seq_len=256, max_prefill_len=64,
                                                          eos_token_id=EOS, kv_layout=layout)))
    port = _single(Engine(T_CFG, t_params, EngineConfig(max_batch=4, max_seq_len=256, max_prefill_len=64,
                                                        eos_token_id=EOS, kv_layout=layout), device="cpu"))
    assert port == want
    return want


def test_gang_dense_matches_jax_and_its_follower(weights, tmp_path):
    """Dense cache: the leader's greedy rows equal JAX's single engine and
    the port's; every row of the follower (the sampled row and the
    cancelled one too) equals the leader's; the cancel stops the stream
    early; the long prompt's frame overflowed INLINE; the TP logits are
    JAX's forward's; the leader's stop ended both ranks with 0."""
    rcs, logs = _finish(_launch(tmp_path, weights[2], "dense"))
    assert rcs == [0, 0], logs
    r0, r1 = (json.loads((tmp_path / f"r{r}.json").read_text()) for r in range(2))
    want = _references(weights, "dense")
    assert r0["leader"] and not r1["leader"] and r0["mesh"]["tensor"] == 2 and r0["backend"] == "gloo"
    assert "heads 2 kv heads 1 per rank" in r0["startup"] and "decode step eager" in r0["startup"]
    rows = [q["tokens"] for q in r0["requests"]]
    assert [rows[i] for i in GREEDY_ROWS] == want
    assert [q["tokens"] for q in r1["requests"]] == rows and all(q["done"] for q in r1["requests"])
    assert 3 <= len(rows[4]) < 24 and r0["requests"][4]["finish_reason"] == "stop"
    assert max(n for n, _ in r0["timings"]) > mh.StepSync.INLINE - 4
    assert [n for n, _ in r0["timings"]] == [n for n, _ in r1["timings"]]
    assert r1["stopped"] and r1["error"] is None and r0["error"] is None
    logits = np.load(tmp_path / "r0.json.logits.npy")
    ref = np.asarray(jllama.forward(weights[0], jnp.asarray(LOGIT_BATCH, jnp.int32), J_CFG)[0])
    rel = np.linalg.norm(logits - ref, axis=-1) / np.linalg.norm(ref, axis=-1)
    assert logits.shape == ref.shape and rel.max() <= 1e-5, rel.max()


def test_gang_moe_logits_match_jax(tmp_path):
    """tiny-moe (experts' hidden dims sharded, the router whole): the two
    ranks' tensor-parallel logits are within 1e-5 (relative, a row) of
    JAX's llama.forward on the same weights."""
    jcfg = jllama.CONFIGS["tiny-moe"].replace(vocab_size=258, dtype=jnp.float32)
    j_params = jllama.init_params(jcfg, jax.random.key(1))
    torch.save(params_from_jax(jax.device_get(j_params)), tmp_path / "moe.pt")
    (tmp_path / "plan.json").write_text(json.dumps({"requests": []}))
    (tmp_path / "batch.json").write_text(json.dumps(LOGIT_BATCH))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "substratus_tpu_torch.tools.gang_worker", "--device", "cpu", "--config", "tiny-moe",
         "--weights", str(tmp_path / "moe.pt"), "--vocab", "258", "--dtype", "float32", "--requests",
         str(tmp_path / "plan.json"), "--out", str(tmp_path / f"r{r}.json"), "--logits", str(tmp_path / "batch.json"),
         "--timeout", "60"], cwd=REPO, env=_gang_env(r, port), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    rcs, logs = _finish(procs)
    assert rcs == [0, 0], logs
    logits = np.load(tmp_path / "r0.json.logits.npy")
    ref = np.asarray(jllama.forward(j_params, jnp.asarray(LOGIT_BATCH, jnp.int32), jcfg)[0])
    rel = np.linalg.norm(logits - ref, axis=-1) / np.linalg.norm(ref, axis=-1)
    assert logits.shape == ref.shape and rel.max() <= 1e-5, rel.max()


def test_four_ranks_with_the_vocab_whole_match_jax(tmp_path):
    """tensor=4 over four gloo ranks (tiny with 4 kv heads: one head a
    rank), where the vocab of 258 stays whole on every rank (fit): no
    embedding sum, no logits gather. Greedy tokens are JAX's single
    Engine's, all four ranks' tokens equal (the sampled row's too), and
    the logits within 1e-5 of JAX's forward."""
    jcfg = J_CFG.replace(n_kv_heads=4)
    j_params = jllama.init_params(jcfg, jax.random.key(2))
    torch.save(params_from_jax(jax.device_get(j_params)), tmp_path / "kv4.pt")
    plan = {"concurrent": False, "requests": PLAN["requests"][:3]}
    rcs, logs = _finish(_launch(tmp_path, str(tmp_path / "kv4.pt"), "dense", ("--shape", "n_kv_heads=4"), 4, plan))
    assert rcs == [0] * 4, logs
    ranks = [json.loads((tmp_path / f"r{r}.json").read_text()) for r in range(4)]
    assert ranks[0]["mesh"]["tensor"] == 4 and "heads 1 kv heads 1 per rank" in ranks[0]["startup"]
    rows = [q["tokens"] for q in ranks[0]["requests"]]
    assert all([q["tokens"] for q in r["requests"]] == rows for r in ranks[1:])
    eng = JEngine(jcfg, j_params, JEngineConfig(max_batch=4, max_seq_len=256, max_prefill_len=64, eos_token_id=EOS,
                                               kv_layout="dense"))
    eng.start()
    try:
        want = [eng.generate(p, max_tokens=6, temperature=0.0) for p in GREEDY[:2]]
    finally:
        eng.stop()
    assert rows[:2] == want
    logits = np.load(tmp_path / "r0.json.logits.npy")
    ref = np.asarray(jllama.forward(j_params, jnp.asarray(LOGIT_BATCH, jnp.int32), jcfg)[0])
    rel = np.linalg.norm(logits - ref, axis=-1) / np.linalg.norm(ref, axis=-1)
    assert rel.max() <= 1e-5, rel.max()


def test_gang_paged_matches_jax_and_a_killed_follower_fails_the_leader(weights, tmp_path):
    """Paged pool, the same checks; then the leader idles (--hold) and a
    SIGKILL of the follower fails the leader's next broadcast: it exits 1
    with its engine's error, well within its 60 s collective timeout."""
    procs = _launch(tmp_path, weights[2], "paged", extra=("--hold",))
    try:
        deadline = time.monotonic() + 120
        while not (tmp_path / "r0.json.hold").exists():
            assert time.monotonic() < deadline and procs[0].poll() is None, "the leader never reached its hold"
            time.sleep(0.1)
        t_kill = time.monotonic()
        procs[1].send_signal(signal.SIGKILL)
        rc = procs[0].wait(timeout=90)
        waited = time.monotonic() - t_kill
    finally:
        _reap(procs)
    assert rc == 1 and waited < 60, (rc, waited)
    r0 = json.loads((tmp_path / "r0.json").read_text())
    want = _references(weights, "paged")
    rows = [q["tokens"] for q in r0["requests"]]
    assert [rows[i] for i in GREEDY_ROWS] == want
    assert r0["error"] is not None and r0["stats"]["prefill_chunks"] > 0


def _serve_gang(tmp_path, params):
    """Two serve.main ranks; stdout piped (the startup lines), stderr to a
    file (c10d's warnings)."""
    (tmp_path / "p.json").write_text(json.dumps(params))
    port, http = _free_port(), _free_port()
    return [subprocess.Popen([sys.executable, "-m", "substratus_tpu_torch.serve.main", "--device", "cpu", "--params",
                              str(tmp_path / "p.json"), "--host", "127.0.0.1", "--port", str(http)],
                             cwd=REPO, env=_gang_env(r, port), stdout=subprocess.PIPE,
                             stderr=open(tmp_path / f"err{r}.txt", "w"), text=True) for r in range(2)], http


def _first_line(proc, timeout=120):
    """The process's first stdout line, within `timeout`."""
    lines = queue.Queue()
    threading.Thread(target=lambda: lines.put(proc.stdout.readline()), daemon=True).start()
    return lines.get(timeout=timeout)


def _line_starting(proc, prefix, timeout=120):
    """The process's first stdout line starting with `prefix`, within
    `timeout`."""
    lines = queue.Queue()

    def read():
        lines.put(next((ln for ln in iter(proc.stdout.readline, "") if ln.startswith(prefix)), ""))

    threading.Thread(target=read, daemon=True).start()
    return lines.get(timeout=timeout)


def test_serve_main_gang_leader_answers_and_sigterm_ends_both(tmp_path):
    """serve.main under the gang environment: the leader's startup line
    names rank 0/2, the mesh, gloo and the timeout and it answers
    completions; the follower prints its line and binds no port; a
    SIGTERM to the leader drains, broadcasts stop, and both exit 0."""
    procs, http = _serve_gang(tmp_path, {"config": "tiny", "max_batch": 2, "max_seq_len": 128})
    try:
        lead, follow = _first_line(procs[0]), _first_line(procs[1])
        assert lead.startswith(f"serving tiny on 127.0.0.1:{http}"), lead
        assert "gang: rank 0/2 (leader), mesh tensor=2, data backend gloo" in lead and "graph: off (gang)" in lead
        assert follow.startswith("gang follower of tiny") and "rank 1/2 (follower)" in follow, follow
        body = json.dumps({"prompt": "hi", "max_tokens": 5, "temperature": 0}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{http}/v1/completions", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            answer = json.loads(resp.read())
        assert answer["usage"]["completion_tokens"] >= 1
        procs[0].send_signal(signal.SIGTERM)
        rcs = [p.wait(timeout=90) for p in procs]
    finally:
        _reap(procs)
    assert rcs == [0, 0], [(tmp_path / f"err{r}.txt").read_text()[-2000:] for r in range(2)]


def test_serve_main_gang_killed_follower_fails_the_leader(tmp_path):
    """A SIGKILLed follower makes serve.main's leader exit 1 (its engine
    died at the next broadcast), not hang."""
    procs, _ = _serve_gang(tmp_path, {"config": "tiny", "max_batch": 2, "max_seq_len": 128})
    try:
        _first_line(procs[0]), _first_line(procs[1])
        procs[1].send_signal(signal.SIGKILL)
        rc = procs[0].wait(timeout=90)
        out = procs[0].stdout.read()
    finally:
        _reap(procs)
    assert rc == 1 and "engine died" in out, out


def test_gang_refusals_cite_roadmap(tmp_path, monkeypatch):
    """In a gang, serve.main exits before the rendezvous on a disaggregated
    role, citing ROADMAP Queue 1, and gang_mesh on a tensor above the
    world; speculation, adapters, int4 and w8a8 pass the gang's check, and
    a gang of two serve.main ranks with prompt lookup and an adapter store
    starts, each rank's startup line naming the speculation and the store,
    answers a tenant's completion and ends with 0 on the leader's SIGTERM
    (tests/test_torch_gang_spec.py and tests/test_torch_gang_adapters.py
    hold their tokens against JAX); outside a gang, tensor above 1 exits."""
    params = tmp_path / "p.json"
    base = ["--device", "cpu", "--params", str(params), "--host", "127.0.0.1", "--port", "0"]
    params.write_text(json.dumps({"config": "tiny", "tensor": 2}))
    with pytest.raises(SystemExit, match=r"tensor=2 needs a gang .* ROADMAP Queue 1, multi-GPU"):
        main.build(base)
    for var, value in _gang_env(0, 1).items():
        monkeypatch.setenv(var, value)
    params.write_text(json.dumps({"config": "tiny"}))
    with pytest.raises(SystemExit, match=r"a disaggregated role in a gang: .* ROADMAP Queue 1, multi-GPU"):
        main.build(base + ["--role", "decode"])
    for extra in ({"spec_k": 3}, {"quantize": "int4"}, {"quantize": "w8a8"}, {"adapters": {"dir": str(tmp_path)}},
                  {"spec_k": 2, "draft_model": str(tmp_path)}):
        assert main.check_gang_params(extra, main.parse_args(base)) is None
    from substratus_tpu_torch.parallel import mesh as pmesh

    built = []
    monkeypatch.setattr(pmesh, "build_mesh", lambda **kw: built.append(kw))
    main.gang_mesh(2, {"tensor": 1}, T_CFG)
    assert built == [{"data": 2, "tensor": 1}]
    with pytest.raises(SystemExit, match="tensor=4 is larger than the gang"):
        main.gang_mesh(2, {"tensor": 4}, T_CFG)
    params.write_text(json.dumps({"config": "tiny", "sequence": 2}))
    with pytest.raises(SystemExit, match="sequence=2 is not served .* ROADMAP Queue 1"):
        main.build(base)

    from substratus_tpu_torch.serve.adapters import save_adapter_artifact
    from substratus_tpu_torch.tools.gang_worker import seeded_tenants

    cfg = llama.CONFIGS["tiny"]
    for aid, tree in seeded_tenants(cfg, 2, 4).items():
        save_adapter_artifact(str(tmp_path / "adapters" / aid), tree, 8.0, 4)
    procs, http = _serve_gang(tmp_path, {"config": "tiny", "max_batch": 2, "max_seq_len": 128, "spec_k": 3,
                                         "adapters": {"dir": str(tmp_path / "adapters"), "capacity": 2}})
    try:
        lead, follow = (_line_starting(p, prefix) for p, prefix in zip(procs, ("serving tiny", "gang follower")))
        for line in (lead, follow):
            assert "speculation prompt-lookup k=3, eager rounds" in line, line
            assert "adapter store capacity 2, rank 4, this rank's slice of each tenant" in line, line
        assert "speculative decoding: prompt-lookup k=3" in lead and "['t0', 't1'] resident" in lead, lead
        body = json.dumps({"prompt": "hi hi hi hi", "max_tokens": 5, "temperature": 0, "model": "t1"}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{http}/v1/completions", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            answer = json.loads(resp.read())
        assert answer["model"] == "t1" and answer["usage"]["completion_tokens"] >= 1, answer
        procs[0].send_signal(signal.SIGTERM)
        rcs = [p.wait(timeout=90) for p in procs]
    finally:
        _reap(procs)
    assert rcs == [0, 0], [(tmp_path / f"err{r}.txt").read_text()[-2000:] for r in range(2)]


class ScriptedSync:
    """A sync of a two-process gang whose broadcast records the leader's
    frames, or hands a follower the frames of `script` (then stop)."""

    def __init__(self, leader, script=()):
        self.leader, self.num_processes = leader, 2
        self.sent, self.script = [], list(script)

    def broadcast(self, payload):
        if self.leader:
            self.sent.append(mh.decode_events(payload))
            return payload
        return self.script.pop(0) if self.script else mh.encode_events([], [], True)


def test_lockstep_engine_frames_mirror_latches_and_swap_barrier(weights):
    """The leader numbers requests, broadcasts their fields, the cancel
    latch and its swap's version; a follower mirrors a scripted frame's
    request into its sink, applies the latch and installs its own staged
    weights under the broadcast's version; JAX's refusals and messages."""
    _, t_params, _ = weights
    ec = EngineConfig(max_batch=4, max_seq_len=64, eos_token_id=EOS, kv_layout="dense")
    sync = ScriptedSync(leader=True)
    lead = Engine(T_CFG, t_params, ec, device="cpu", sync=sync)
    assert lead.overlap is False
    lead.start()
    try:
        req = lead.submit(Request([256, 70, 71], max_tokens=24, id="r1"))
        got = [req.out.get(timeout=60) for _ in range(3)]
        req.cancelled = True
        while req.out.get(timeout=60) is not None:
            pass
        assert lead.swap_params(t_params.state_dict()) == 1
    finally:
        lead.stop()
    frames = [f for f in sync.sent if f["reqs"] or f["cancels"] or f["swap"] is not None]
    assert frames[0]["reqs"] == [{"sid": 1, "p": [256, 70, 71], "m": 24, "t": 0.0, "tp": 1.0, "e": None,
                                  "id": "r1", "ad": None}]
    assert [1] in [f["cancels"] for f in frames] and 1 in [f["swap"] for f in frames]
    assert sync.sent[-1]["stop"] is True and req.finish_reason == "stop" and len(got) == 3

    sinks = []

    class Sink(mh.NullSink):
        def __init__(self):
            self.items = []
            sinks.append(self)

        def put(self, item):
            self.items.append(item)

    r = SimpleNamespace(sync_id=1, prompt_tokens=[256, 5, 6, 7], max_tokens=24, temperature=0.0, top_p=1.0,
                        eos_token_id=None, id="m", adapter=None)
    idle = mh.encode_events([], [], False)
    script = [mh.encode_events([r], [], False), idle, idle, mh.encode_events([], [1], False, swap=7)]
    follow = Engine(T_CFG, t_params, ec, device="cpu", sync=ScriptedSync(False, script))
    follow.follower_sink = Sink
    with pytest.raises(RuntimeError, match="follower engine: requests arrive via the leader broadcast"):
        follow.submit(Request([1], max_tokens=2))
    follow.start()
    assert follow.swap_params(t_params.state_dict(), version=3, wait=False) is None
    follow._thread.join(timeout=60)
    assert not follow._thread.is_alive() and follow.error is None
    assert follow.weights_version == 7 and sinks[0].items[-1] is None and 1 <= len(sinks[0].items) - 1 < 24
    with pytest.raises(ValueError, match="disaggregated roles are incompatible with lockstep sync"):
        Engine(T_CFG, t_params, EngineConfig(role="decode"), device="cpu", sync=ScriptedSync(True))
    spec = Engine(T_CFG, t_params, EngineConfig(spec_k=2), device="cpu", sync=ScriptedSync(True))
    assert spec.spec and spec.overlap is False
    spec.set_source(object())  # the leader's pulls ride the broadcast
    with pytest.raises(RuntimeError, match="follower engine: the leader owns the source"):
        Engine(T_CFG, t_params, ec, device="cpu", sync=ScriptedSync(False)).set_source(object())
