"""The port's batch generation (substratus_tpu_torch/serve/batchgen.py,
load/manifest.py and the engine's pull source) against the JAX package's,
on the CPU.

One float32 tiny llama (vocabulary 258, EOS 257), the JAX weights carried
across by bridge.params_from_jax, one manifest of greedy records: token
records, text prompts through the byte tokenizer, a record with no prompt
(written once as "invalid") and one naming an adapter (an "error" record:
neither engine has an adapter store). The port's BatchGenDriver, on the
synchronous and the overlapped scheduler, the dense cache and the paged
pool, writes the JAX BatchGenDriver's records exactly: every key of every output
line, and the summary's counts. A shard with a torn tail line resumes as
JAX resumes it, into shard-00001.jsonl; a SIGKILLed child process and its
rerun write every index exactly once; two engines on one BatchGenDriver give one
engine's records; the pull source boards after the submit queue and an
adapter request ends as "error" with the engine alive, as in the JAX
engine; the progress surface and the manifest functions are JAX's.
"""
import json
import os
import shutil
import signal
import subprocess
import sys
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substratus_tpu.load import manifest as jmanifest
from substratus_tpu.models import llama as jllama
from substratus_tpu.observability.metrics import METRICS as JMETRICS
from substratus_tpu.serve import batchgen as jbatchgen
from substratus_tpu.serve.engine import Engine as JEngine
from substratus_tpu.serve.engine import EngineConfig as JEngineConfig
from substratus_tpu.serve.engine import Request as JRequest
from substratus_tpu.serve.tokenizer import ByteTokenizer as JByteTokenizer
from substratus_tpu_torch.bridge import params_from_jax
from substratus_tpu_torch.load import manifest as tmanifest
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.serve import batchgen
from substratus_tpu_torch.serve.engine import Engine, EngineConfig, Request
from substratus_tpu_torch.serve.main import check_params
from substratus_tpu_torch.serve.tokenizer import ByteTokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EOS = 257
EC = dict(max_batch=4, max_seq_len=96, max_prefill_len=32, eos_token_id=EOS)
_WEIGHTS = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def weights():
    """(jax cfg, jax params, port cfg, port params), seed 0."""
    if not _WEIGHTS:
        jcfg = jllama.CONFIGS["tiny"].replace(vocab_size=258, dtype=jnp.float32)
        tcfg = llama.CONFIGS["tiny"].replace(vocab_size=258, dtype=torch.float32)
        j_params = jllama.init_params(jcfg, jax.random.key(0))
        t_params = llama.Llama(tcfg, device="cpu")
        t_params.load_state_dict(params_from_jax(jax.device_get(j_params)))
        _WEIGHTS.update(j=(jcfg, j_params), t=(tcfg, t_params))
    return (*_WEIGHTS["j"], *_WEIGHTS["t"])


def records(n=14, seed=0):
    """Greedy records: tokens of 5-40 ids, text prompts every third, one
    without a prompt, one naming an adapter; budgets of 4-12 tokens, some
    from the run's default."""
    r = np.random.default_rng(seed)
    out = []
    for i in range(n):
        rec = {"id": f"r{i}"}
        if i % 3 == 2:
            rec["prompt"] = "batch record %d: " % i + "xy" * int(r.integers(1, 15))
        else:
            rec["tokens"] = r.integers(0, 256, int(r.integers(5, 41))).tolist()
        if i % 4:
            rec["max_tokens"] = int(r.integers(4, 13))
        out.append(rec)
    out[5] = {"id": "no-prompt"}
    out[9] = dict(out[9], model="t0")
    return out


def write(path, recs):
    tmanifest.write_manifest(str(path), recs)
    return str(path)


def shards(out_dir):
    """{index: [records]} over every shard (torn lines skipped)."""
    got = {}
    for name in sorted(os.listdir(out_dir)):
        if not name.startswith("shard-"):
            continue
        for line in open(os.path.join(out_dir, name)):
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            got.setdefault(rec["index"], []).append(rec)
    return got


def jax_engine(layout="dense"):
    jcfg, j_params, _, _ = weights()
    eng = JEngine(jcfg, j_params, JEngineConfig(kv_layout=layout, overlap=False, **EC))
    eng.start()
    return eng


def port_engine(layout="dense", overlap=None):
    _, _, tcfg, t_params = weights()
    eng = Engine(tcfg, t_params, EngineConfig(kv_layout=layout, overlap=overlap, **EC), device="cpu")
    eng.start()
    return eng


def drive(module, engines, man, out, **kw):
    tok = JByteTokenizer() if module is jbatchgen else ByteTokenizer()
    try:
        return module.BatchGenDriver(engines, man, str(out), tokenizer=tok, max_tokens=6, **kw).run()
    finally:
        for e in engines:
            e.stop()


COUNTS = ("written", "ok", "errors", "resumed", "manifest_records", "gen_tokens")
_JAX_RUNS = {}


def jax_run(tmp_path_factory, layout):
    """The JAX BatchGenDriver's output and summary on the module's manifest."""
    if layout not in _JAX_RUNS:
        d = tmp_path_factory.mktemp(f"jax-{layout}")
        man = write(d / "m.jsonl", records())
        summary = drive(jbatchgen, [jax_engine(layout)], man, d / "out")
        _JAX_RUNS[layout] = (summary, shards(str(d / "out")))
    return _JAX_RUNS[layout]


@pytest.mark.parametrize("layout,overlap", [("dense", False), ("dense", None), ("paged", False), ("paged", None)])
def test_batch_records_match_jax(tmp_path, tmp_path_factory, layout, overlap):
    """Every output line (tokens, finish_reason, prompt_tokens, gen_tokens,
    text, model, the outcome's finish) and the summary's counts equal the
    JAX BatchGenDriver's on the same manifest and weights."""
    want_summary, want = jax_run(tmp_path_factory, layout)
    man = write(tmp_path / "m.jsonl", records())
    summary = drive(batchgen, [port_engine(layout, overlap)], man, tmp_path / "out")
    got = shards(str(tmp_path / "out"))
    assert {k: summary[k] for k in COUNTS} == {k: want_summary[k] for k in COUNTS}
    assert summary["written"] == 14 and summary["errors"] == 2 and summary["resumed"] == 0
    assert got == want
    assert got[5][0]["finish_reason"].startswith("invalid") and got[9][0]["finish_reason"] == "error"
    assert got[9][0]["model"] == "t0" and any("text" in rs[0] for rs in got.values())


def test_torn_tail_resumes_as_jax(tmp_path, tmp_path_factory):
    """Six durable lines and a torn seventh in shard-00000: both BatchGenDrivers
    regenerate the same indices, into shard-00001.jsonl, with the same
    records, and count the six as resumed."""
    _, full = jax_run(tmp_path_factory, "dense")
    seeded = tmp_path / "seed"
    seeded.mkdir()
    kept = [full[i][0] for i in (0, 1, 2, 5, 7, 9)]
    (seeded / "shard-00000.jsonl").write_text(
        "".join(json.dumps(r, sort_keys=True) + "\n" for r in kept) + json.dumps(full[3][0])[:25])
    man = write(tmp_path / "m.jsonl", records())
    results = {}
    for name, module, engine in (("jax", jbatchgen, jax_engine), ("port", batchgen, port_engine)):
        out = tmp_path / name
        shutil.copytree(seeded, out)
        summary = drive(module, [engine()], man, out)
        fresh = [json.loads(line) for line in open(out / "shard-00001.jsonl")]
        results[name] = (summary, sorted(r["index"] for r in fresh), {r["index"]: r for r in fresh})
        assert sorted(os.listdir(out)) == ["shard-00000.jsonl", "shard-00001.jsonl"]
        assert sorted(shards(str(out))) == list(range(14))
    (js, ji, jr), (ts, ti, tr) = results["jax"], results["port"]
    assert ts["resumed"] == js["resumed"] == 6 and ts["written"] == js["written"] == 8
    assert ti == ji == [3, 4, 6, 8, 10, 11, 12, 13] and tr == jr


def test_kill_and_rerun_writes_every_index_once(tmp_path):
    """python -m substratus_tpu_torch.serve.batchgen --device cpu as a
    child, SIGKILLed once 5 records are durable (a simulated step floor of
    20 ms keeps it running), then the same command again: every manifest
    index exactly once over all shards, the rerun's `resumed` the durable
    count, its records in a shard of their own."""
    r = np.random.default_rng(3)
    recs = [{"id": f"k{i}", "tokens": r.integers(10, 250, 8).tolist(), "max_tokens": int(r.integers(6, 11))}
            for i in range(48)]
    man = write(tmp_path / "m.jsonl", recs)
    out = tmp_path / "out"
    cmd = [sys.executable, "-m", "substratus_tpu_torch.serve.batchgen", "--manifest", man, "--output", str(out),
           "--config", "tiny", "--device", "cpu", "--max-batch", "4", "--max-seq-len", "96", "--max-tokens", "8",
           "--step-floor-ms", "20", "--params", ""]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    p = subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline:
            assert p.poll() is None, "the child finished before the kill: raise the step floor"
            if len(tmanifest.completed_indices(str(out))) >= 5:
                break
            time.sleep(0.01)
        else:
            pytest.fail("the child never wrote 5 records")
        p.send_signal(signal.SIGKILL)
    finally:
        p.kill()
        p.communicate()
    first = tmanifest.completed_indices(str(out))
    assert 0 < len(first) < len(recs)
    n_shards = len(tmanifest.list_shards(str(out)))
    proc = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["resumed"] == len(first) and summary["written"] == len(recs) - len(first)
    got = shards(str(out))
    assert sorted(got) == list(range(len(recs))) and all(len(rs) == 1 for rs in got.values())
    assert len(tmanifest.list_shards(str(out))) == n_shards + 1


def test_two_engines_match_one(tmp_path):
    """Two port engines draining one manifest through one BatchGenDriver write the
    records a single port engine writes (the JAX gang is not the
    reference: its multi-host tests fail reference-side)."""
    man = write(tmp_path / "m.jsonl", records(20, seed=5))
    one = drive(batchgen, [port_engine()], man, tmp_path / "one")
    two = drive(batchgen, [port_engine(), port_engine("paged")], man, tmp_path / "two")
    assert two["actors"] == 2 and {k: two[k] for k in COUNTS} == {k: one[k] for k in COUNTS}
    assert shards(str(tmp_path / "two")) == shards(str(tmp_path / "one"))


class _ListSource:
    def __init__(self, reqs):
        self.reqs = list(reqs)

    def pull(self):
        return self.reqs.pop(0) if self.reqs else None

    def pending(self):
        return bool(self.reqs)


class _Out:
    """A request's out sink that records the order of completions."""

    def __init__(self, name, order):
        self.name, self.order, self.tokens = name, order, []

    def put(self, item):
        if item is None:
            self.order.append(self.name)
        else:
            self.tokens.append(item)


def test_source_boards_after_submitted_and_adapter_errors_as_jax():
    """One slot: a submitted request boards before the source's; a
    source request naming an adapter ends as "error" with no token and
    the engine goes on to the next; completions, tokens and finish reasons
    as in the JAX engine."""
    prompts = {"submitted": [256, 5, 6, 7], "a": [256, 9, 9], "adapter": [256, 1], "b": [256, 40, 41, 42, 43]}
    results = {}
    for name, eng_cls, req_cls, cfg in (("jax", JEngine, JRequest, JEngineConfig), ("port", Engine, Request,
                                                                                      EngineConfig)):
        jcfg, j_params, tcfg, t_params = weights()
        ec = cfg(**dict(EC, max_batch=1, kv_layout="dense"))
        eng = eng_cls(jcfg, j_params, ec) if name == "jax" else eng_cls(tcfg, t_params, ec, device="cpu")
        order = []
        reqs = {k: req_cls(list(p), max_tokens=5, out=_Out(k, order), adapter="t0" if k == "adapter" else None)
                for k, p in prompts.items()}
        eng.submit(reqs["submitted"])
        eng.set_source(_ListSource([reqs["a"], reqs["adapter"], reqs["b"]]))
        eng.start()
        try:
            deadline = time.monotonic() + 120
            while len(order) < 4 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert eng.error is None and eng._thread.is_alive()
        finally:
            eng.stop()
        results[name] = (order, {k: (r.out.tokens, r.finish_reason) for k, r in reqs.items()})
    assert results["port"] == results["jax"]
    order, outs = results["port"]
    assert order.index("submitted") < order.index("a") and outs["adapter"] == ([], "error")


def test_progress_surface_matches_jax(tmp_path):
    """/loadz's batchgen keys and values with a source attached, on the
    ProgressServer, and the three metrics' HELP and TYPE lines, are JAX's;
    the key leaves the snapshot when the source detaches."""
    man = write(tmp_path / "m.jsonl", records())
    jcfg, j_params, tcfg, t_params = weights()
    jeng = JEngine(jcfg, j_params, JEngineConfig(**EC))
    teng = Engine(tcfg, t_params, EngineConfig(**EC), device="cpu")
    jdrv = jbatchgen.BatchGenDriver([jeng], man, str(tmp_path / "j"))
    tdrv = batchgen.BatchGenDriver([teng], man, str(tmp_path / "t"))
    jeng.set_source(jbatchgen._EngineSource(jdrv))
    teng.set_source(batchgen._EngineSource(tdrv))
    srv = batchgen.ProgressServer(teng, host="127.0.0.1", port=0)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/loadz", timeout=10) as r:
            loadz = json.loads(r.read())
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics", timeout=10) as r:
            metrics = r.read().decode()
    finally:
        srv.close()
    assert loadz["batchgen"] == jeng.load_snapshot()["batchgen"] == {
        "manifest_records": 14, "resumed": 0, "written": 0, "errors": 0, "in_flight": 0, "pending": 14}
    jtext = JMETRICS.render()
    for name in ("substratus_batchgen_records_total", "substratus_batchgen_slot_occupancy",
                 "substratus_batchgen_manifest_progress_ratio"):
        want = [ln for ln in jtext.splitlines() if ln.startswith(("# HELP " + name, "# TYPE " + name))]
        assert len(want) == 2 and want == [ln for ln in metrics.splitlines() if ln in want]
    teng.set_source(None)
    assert "batchgen" not in teng.load_snapshot()


def test_manifest_functions_match_jax(tmp_path):
    """load/manifest.py's functions on the same files: the same indices
    (line numbers, blanks included), counts, shards, the torn-tail rule,
    the next shard, the bytes written, and the same error messages."""
    man = tmp_path / "m.jsonl"
    man.write_text('{"id": "a", "tokens": [1, 2]}\n\n{"id": "b", "prompt": "hi"}\n   \n{"tokens": [3]}\n')
    assert list(tmanifest.iter_manifest(str(man))) == list(jmanifest.iter_manifest(str(man)))
    assert tmanifest.count_records(str(man)) == jmanifest.count_records(str(man)) == 3
    out = tmp_path / "out"
    out.mkdir()
    (out / "shard-00000.jsonl").write_text('{"index": 0, "tokens": [5]}\n{"index": 2, "tok')
    (out / "shard-00003.jsonl").write_text('{"index": 4}\n{"index": "x"}\n[1]\n\n')
    (out / "not-a-shard.txt").write_text('{"index": 7}\n')
    for fn in ("list_shards", "completed_indices", "next_shard_index"):
        assert getattr(tmanifest, fn)(str(out)) == getattr(jmanifest, fn)(str(out)), fn
    assert tmanifest.completed_indices(str(out)) == {0, 4} and tmanifest.next_shard_index(str(out)) == 4
    assert tmanifest.list_shards(str(tmp_path / "none")) == [] and tmanifest.shard_name(12) == "shard-00012.jsonl"
    recs = records()
    tmanifest.write_manifest(str(tmp_path / "t.jsonl"), recs)
    jmanifest.write_manifest(str(tmp_path / "j.jsonl"), recs)
    assert (tmp_path / "t.jsonl").read_bytes() == (tmp_path / "j.jsonl").read_bytes()
    tok, jtok = ByteTokenizer(), JByteTokenizer()
    for rec in recs[:4]:
        assert tmanifest.record_prompt_tokens(rec, tok) == jmanifest.record_prompt_tokens(rec, jtok)
    for rec, tk in (({"tokens": [1, "x"]}, None), ({"id": 1}, None), ({"prompt": "hi"}, None)):
        with pytest.raises(ValueError) as te:
            tmanifest.record_prompt_tokens(rec, tk)
        with pytest.raises(ValueError) as je:
            jmanifest.record_prompt_tokens(rec, tk)
        assert str(te.value) == str(je.value)
    for text in ('{"id": "a", "tokens": [1,\n', '[1, 2]\n'):
        man.write_text('{"id": "ok"}\n' + text)
        with pytest.raises(ValueError) as te:
            list(tmanifest.iter_manifest(str(man)))
        with pytest.raises(ValueError) as je:
            list(jmanifest.iter_manifest(str(man)))
        assert str(te.value) == str(je.value) and ":2:" in str(te.value)


def test_params_batchgenerate_and_refusals(tmp_path, monkeypatch):
    """serve.main accepts batchGenerate as a known key (as JAX's does);
    serve.batchgen runs on the card unless --device cpu is given (here it
    raises), and exits on a batchGenerate key it does not know, on tensor
    outside a gang and on an adapters value that is not an object, with
    serve.main's messages; under the gang's environment tensor takes it to
    the rendezvous (tests/test_torch_batchgen_gang.py runs the gang);
    baseModel is a known key with no effect (as in serve.main)."""
    assert batchgen.parse_args([]).device is None
    with pytest.raises(RuntimeError, match="CUDA"):
        batchgen.main(["--config", "tiny", "--params", ""])
    bg = {"manifest": "m.jsonl", "output": "out", "maxTokens": 128}
    check_params({"quantize": "int8", "max_batch": 16, "batchGenerate": bg})
    assert batchgen.batchgen_params({"batchGenerate": bg}) == bg
    with pytest.raises(SystemExit, match="unknown batchGenerate key"):
        batchgen.batchgen_params({"batchGenerate": dict(bg, shards=3)})
    man = write(tmp_path / "m.jsonl", records()[:2])
    check_params({"baseModel": "b", "adapters": {"dir": str(tmp_path)}, "batchGenerate": bg})
    for key, value, where in (("adapters", ["a"], r"adapters=\['a'\] invalid"), ("tensor", 2, "multi-GPU")):
        params = tmp_path / "p.json"
        params.write_text(json.dumps({key: value, "batchGenerate": bg}))
        with pytest.raises(SystemExit, match=where):
            batchgen.main(["--params", str(params), "--manifest", man, "--output", str(tmp_path / "o"),
                           "--device", "cpu"])
    from substratus_tpu_torch.parallel import distributed

    def rendezvous(*a, **kw):
        raise ConnectionRefusedError("the rendezvous")

    monkeypatch.setattr(distributed, "maybe_initialize", rendezvous)
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    with pytest.raises(ConnectionRefusedError, match="the rendezvous"):
        batchgen.main(["--params", str(params), "--manifest", man, "--output", str(tmp_path / "o"), "--device", "cpu"])
