"""Batch generation as a gang of the port (serve/batchgen.py under the
operator's gang environment) against the JAX package, on the CPU.

JAX's tiny f32 weights (key 0, vocab 258, eos 257), written as the port's
artifact, serve `python -m substratus_tpu_torch.serve.batchgen` as two
gloo ranks of tensor=2: the leader pulls the manifest's records, which
ride the event broadcast, and writes the shards; the follower mirrors it
and exits 0 on the leader's stop. On tests/test_batchgen.py's records
(its `_records(6, seed=7)`, the lockstep test's) every record's tokens are
exactly those of JAX's single Engine; records whose `model` field names a
tenant of the store (serve.main's build_adapter_store, each rank its
slice) are JAX's Engine's with the same adapters. A SIGKILLed follower
makes the leader exit non-zero; a rerun of the gang resumes from the
leader's shards, and every record is written once, each with JAX's
tokens (none as an engine-death "error"). In process, a leader engine
with a scripted sync numbers and broadcasts the pulled records as JAX's
leader does (the same requests in the same frames), and a follower fed
those frames delivers the same tokens, where JAX's follower, capping its
admission while its leader fills every slot, parts from its leader (the
port's frames say when the leader pulls). Each process has its own
timeout.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substratus_tpu.models import llama as jllama
from substratus_tpu.serve import adapters as jadapters
from substratus_tpu.serve import batchgen as jbatchgen
from substratus_tpu.serve import multihost as jmh
from substratus_tpu.serve.engine import Engine as JEngine
from substratus_tpu.serve.engine import EngineConfig as JEngineConfig
from substratus_tpu.train.lora import init_lora
from substratus_tpu_torch.bridge import params_from_jax
from substratus_tpu_torch.load import manifest as tmanifest
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.serve import batchgen
from substratus_tpu_torch.serve import multihost as mh
from substratus_tpu_torch.serve.adapters import save_adapter_artifact
from substratus_tpu_torch.serve.engine import Engine, EngineConfig
from substratus_tpu_torch.train.checkpoints import save_artifact

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EOS = 257
J_CFG = jllama.CONFIGS["tiny"].replace(vocab_size=258, dtype=jnp.float32)
T_CFG = llama.CONFIGS["tiny"].replace(vocab_size=258, dtype=torch.float32)
TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _records(n, seed=0, prompt_len=8, lo_mt=4, hi_mt=8):
    """tests/test_batchgen.py's _records."""
    rng = np.random.default_rng(seed)
    return [{"id": f"r{i}", "tokens": rng.integers(10, 250, prompt_len).tolist(),
             "max_tokens": int(rng.integers(lo_mt, hi_mt + 1))} for i in range(n)]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX's weights, the port's artifact of them, and two tenants (every
    target, rank 4, alpha 8) as adapter artifacts."""
    tmp = tmp_path_factory.mktemp("batchgen_gang")
    params = jllama.init_params(J_CFG, jax.random.key(0))
    model = llama.Llama(T_CFG, device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(params)))
    save_artifact(str(tmp / "model"), model, T_CFG)
    for i in range(2):
        tree = init_lora(J_CFG, jax.random.key(80 + i), rank=4, alpha=8.0, targets=TARGETS, dtype=jnp.float32)
        for j, name in enumerate(sorted(tree)):
            tree[name]["b"] = jax.random.normal(jax.random.key(800 + 10 * i + j), tree[name]["b"].shape,
                                                jnp.float32) * 0.1
        save_adapter_artifact(str(tmp / "adapters" / f"t{i}"), jax.tree.map(np.asarray, tree), alpha=8.0, rank=4)
    return params, str(tmp / "model"), str(tmp / "adapters")


def _jax_tokens(params, recs, store=None):
    """Each record's greedy tokens from JAX's single Engine (the batch
    gang's engine settings: max_batch 4, max_seq_len 96)."""
    eng = JEngine(J_CFG, params, JEngineConfig(max_batch=4, max_seq_len=96, eos_token_id=EOS), adapters=store)
    eng.start()
    try:
        return {r["id"]: eng.generate(list(r["tokens"]), max_tokens=r["max_tokens"], temperature=0.0,
                                      adapter=r.get("model")) for r in recs}
    finally:
        eng.stop()


def _gang(tmp_path, model, recs, params, floor_ms=0, out="out", tag=""):
    """Two serve.batchgen ranks (stdout piped, each its own log)."""
    man = tmp_path / "m.jsonl"
    if not man.exists():
        tmanifest.write_manifest(str(man), recs)
    (tmp_path / "p.json").write_text(json.dumps({"tensor": 2, **params}))
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1", "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
           "JAX_NUM_PROCESSES": "2"}
    cmd = [sys.executable, "-m", "substratus_tpu_torch.serve.batchgen", "--manifest", str(man), "--output",
           str(tmp_path / out), "--model", model, "--device", "cpu", "--max-batch", "4", "--max-seq-len", "96",
           "--params", str(tmp_path / "p.json"), "--step-floor-ms", str(floor_ms)]
    return [subprocess.Popen(cmd, cwd=REPO, env={**env, "TPU_WORKER_ID": str(r)}, stdout=subprocess.PIPE,
                             stderr=open(tmp_path / f"err{tag}{r}.txt", "w"), text=True) for r in range(2)]


def _finish(procs, timeout=240):
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)
    return [p.returncode for p in procs], outs


def _shards(out_dir):
    got = {}
    for path in tmanifest.list_shards(str(out_dir)):
        for line in open(path):
            if line.strip():
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # a torn tail
                got.setdefault(rec["index"], []).append(rec)
    return got


def test_gang_records_match_jax_single_engine(setup, tmp_path):
    """tests/test_batchgen.py's lockstep records through a batchgen gang of
    two: every record once, its tokens JAX's single Engine's; the leader
    prints its summary, the follower mirrors and exits 0; both print the
    gang and mesh lines."""
    params, model, _ = setup
    recs = _records(6, seed=7)
    rcs, outs = _finish(_gang(tmp_path, model, recs, {}))
    assert rcs == [0, 0], outs
    summary = json.loads(outs[0].strip().splitlines()[-1])
    assert summary["written"] == summary["ok"] == len(recs), summary
    got = _shards(tmp_path / "out")
    assert sorted(got) == list(range(len(recs))) and all(len(v) == 1 for v in got.values())
    want = _jax_tokens(params, recs)
    assert {v[0]["id"]: v[0]["tokens"] for v in got.values()} == want
    for r, text in enumerate(outs):
        assert f"batchgen gang: rank {r}/2 ({'leader' if r == 0 else 'follower'}), mesh tensor=2" in text, text
        assert "batchgen mesh: data=1 tensor=2" in text, text
    assert "{" not in outs[1].strip().splitlines()[-1]  # no summary: the follower writes nothing


def test_records_select_tenants_in_the_gang(setup, tmp_path):
    """Records whose `model` field names t0 or t1 (the store built by
    serve.main's build_adapter_store on each rank, its slice of each
    tenant) beside base records, in one gang run: JAX's single Engine's
    tokens with a JAX store over the same artifacts; the tenants differ."""
    params, model, folder = setup
    recs = _records(6, seed=11)
    for i, rec in enumerate(recs):
        rec["tokens"] = [256, 10, 20, 30] if i % 3 else rec["tokens"]
        if i % 3:
            rec["model"] = f"t{i % 3 - 1}"
    rcs, outs = _finish(_gang(tmp_path, model, recs, {"adapters": {"dir": folder, "capacity": 2}}))
    assert rcs == [0, 0], outs
    got = {v[0]["id"]: v[0] for v in _shards(tmp_path / "out").values()}
    store = jadapters.AdapterStore(J_CFG, capacity=2, rank=4, targets=TARGETS, dtype=jnp.float32, search_dir=folder)
    want = _jax_tokens(params, recs, store)
    assert {i: r["tokens"] for i, r in got.items()} == want
    assert got["r1"]["model"] == "t0" and got["r1"]["tokens"] != got["r2"]["tokens"]
    assert all(r["finish_reason"] == "length" for r in got.values())


def test_follower_sigkill_and_a_rerun_write_every_record_once(setup, tmp_path):
    """A simulated step floor of 20 ms keeps the gang running; once 5
    records are durable the follower is SIGKILLed: the leader exits
    non-zero within its collective timeout. The gang's rerun resumes from
    the leader's shards: every index once over all shards, every record
    JAX's tokens (a record the death ended was never written)."""
    params, model, _ = setup
    r = np.random.default_rng(3)
    recs = [{"id": f"k{i}", "tokens": r.integers(10, 250, 8).tolist(), "max_tokens": int(r.integers(6, 11))}
            for i in range(32)]
    procs = _gang(tmp_path, model, recs, {}, floor_ms=20, tag="a")
    try:
        deadline = time.monotonic() + 180
        while len(tmanifest.completed_indices(str(tmp_path / "out"))) < 5:
            assert time.monotonic() < deadline and procs[0].poll() is None, "the leader never wrote 5 records"
            time.sleep(0.01)
        procs[1].send_signal(signal.SIGKILL)
        t_kill = time.monotonic()
        rc = procs[0].wait(timeout=120)
        waited = time.monotonic() - t_kill
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)
    first = tmanifest.completed_indices(str(tmp_path / "out"))
    assert rc != 0 and waited < 60 and 5 <= len(first) < len(recs), (rc, waited, len(first))
    rcs, outs = _finish(_gang(tmp_path, model, recs, {}, tag="b"))
    assert rcs == [0, 0], outs
    summary = json.loads(outs[0].strip().splitlines()[-1])
    assert summary["resumed"] == len(first) and summary["written"] == len(recs) - len(first), summary
    got = _shards(tmp_path / "out")
    assert sorted(got) == list(range(len(recs))) and all(len(v) == 1 for v in got.values())
    assert {v[0]["id"]: v[0]["tokens"] for v in got.values()} == _jax_tokens(params, recs)


class ScriptedSync:
    """A two-process sync whose leader records its frames (decoded by
    `decode`), or whose follower replays `script` (then stop)."""

    def __init__(self, leader, decode, script=()):
        self.leader, self.num_processes, self.decode = leader, 2, decode
        self.sent, self.script = [], list(script)

    def broadcast(self, payload):
        if self.leader:
            self.sent.append(payload)
            return payload
        return self.script.pop(0) if self.script else mh.encode_events([], [], True)


def test_leader_pull_frames_match_jax_and_a_follower_mirrors(setup, tmp_path):
    """In process, with scripted syncs: the port's leader engine driven by
    its BatchGenDriver broadcasts the pulled records, numbered, in the same
    frames (each request's every field) as JAX's leader engine driven by
    JAX's BatchGenDriver; a port follower fed those frames delivers each
    record's tokens into its sinks (JAX's follower, fed JAX's frames, does
    not); set_source refuses on a follower with JAX's message."""
    params, _, _ = setup
    # Three records end together while a fourth decodes on: the leader
    # then pulls two at once into a busy batch.
    recs = [dict(r, max_tokens=8 if i == 3 else 6) for i, r in enumerate(_records(6, seed=7))]
    man = str(tmp_path / "m.jsonl")
    tmanifest.write_manifest(man, recs)
    model = llama.Llama(T_CFG, device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(params)))
    ec = EngineConfig(max_batch=4, max_seq_len=96, eos_token_id=EOS)

    jsync = ScriptedSync(True, jmh.decode_events)
    jeng = JEngine(J_CFG, params, JEngineConfig(max_batch=4, max_seq_len=96, eos_token_id=EOS), sync=jsync)
    jeng.start()
    try:
        jbatchgen.BatchGenDriver([jeng], man, str(tmp_path / "jout")).run()
    finally:
        jeng.stop()
    tsync = ScriptedSync(True, mh.decode_events)
    teng = Engine(T_CFG, model, ec, device="cpu", sync=tsync)
    teng.start()
    try:
        batchgen.BatchGenDriver([teng], man, str(tmp_path / "tout")).run()
    finally:
        teng.stop()

    def pulls(sync):
        return [f["reqs"] for f in map(sync.decode, sync.sent) if f["reqs"]]

    assert pulls(tsync) == pulls(jsync) and sum(map(len, pulls(tsync))) == len(recs)
    assert [len(f) for f in pulls(tsync)][0] == 4  # the first frame fills every free slot
    leader = {v[0]["id"]: v[0]["tokens"] for v in _shards(tmp_path / "tout").values()}
    assert leader == {v[0]["id"]: v[0]["tokens"] for v in _shards(tmp_path / "jout").values()}

    sinks = []

    class Sink(mh.NullSink):
        def __init__(self):
            self.tokens = []
            sinks.append(self)

        def put(self, item):
            if item is not None:
                self.tokens.append(item)

    follow = Engine(T_CFG, model, ec, device="cpu", sync=ScriptedSync(False, None, tsync.sent))
    follow.follower_sink = Sink
    with pytest.raises(RuntimeError, match="follower engine: the leader owns the source"):
        follow.set_source(object())
    follow.start()
    follow._thread.join(timeout=120)
    assert not follow._thread.is_alive() and follow.error is None
    ids = [r["id"] for f in pulls(tsync) for r in f]
    assert {i: s.tokens for i, s in zip(ids, sinks)} == leader

    assert follow.stats["decode_steps"] == teng.stats["decode_steps"]

    # JAX's follower fed its leader's frames caps its admission while its
    # leader, with the source, fills every free slot: it boards r5 a step
    # after r4 and runs one decode step more than its leader, a collective
    # its leader never joins in a gang (the fault the port's "source" key
    # repairs, ROADMAP Queue 3).
    def counted(eng):
        steps, step = [0], eng._step

        def counting():
            steps[0] += 1
            step()

        eng._step = counting
        return steps

    jlead = JEngine(J_CFG, params, JEngineConfig(max_batch=4, max_seq_len=96, eos_token_id=EOS),
                    sync=(jsync2 := ScriptedSync(True, jmh.decode_events)))
    lead_steps = counted(jlead)
    jlead.start()
    try:
        jbatchgen.BatchGenDriver([jlead], man, str(tmp_path / "jout2")).run()
    finally:
        jlead.stop()
    jfollow = JEngine(J_CFG, params, JEngineConfig(max_batch=4, max_seq_len=96, eos_token_id=EOS),
                      sync=ScriptedSync(False, None, jsync2.sent))
    follow_steps = counted(jfollow)
    jfollow.start()
    jfollow._thread.join(timeout=120)
    assert follow_steps[0] == lead_steps[0] + 1, (lead_steps, follow_steps)

