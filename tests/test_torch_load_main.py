"""The port's loader entry points (substratus_tpu_torch/load/main.py,
load/dataset.py) against the JAX package's, and train.main's tracing,
telemetry and profile window, on the CPU.

load.main imports one tiny float32 model written by tools/ckpt_writer.py as
an HF safetensors directory and as an F32 GGUF with an SPM vocabulary, and
draws a named configuration from a seed: each artifact's state equals the
port's importer output (load_pretrained, load_gguf, init_params), and its
greedy tokens, served by the port, equal the JAX Engine's on the JAX
package's import of the same file; ``quantize: int8`` stores exactly the
int8 leaves of the JAX package's quantize_params (unjitted: under jit XLA's
scales move by an ulp); a GGUF's vocabulary goes beside the artifact as
tokenizer.gguf and an HF directory's tokenizer files as copies; the run is
a load.run span under TRACEPARENT. load.dataset copies files and fetches
urls (from a local http.server) as the JAX entry point does. train.main
runs in a train.run span, its progress lines carry the trace id, the
registry gains the substratus_train_* series, and profile_steps is clamped
as the JAX entry point clamps it, its window traced.
"""
import functools
import http.server
import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substratus_tpu.load import dataset as jdataset
from substratus_tpu.load import gguf as jgguf
from substratus_tpu.load.hf import load_pretrained as j_load_pretrained
from substratus_tpu.models import llama as jllama
from substratus_tpu.ops.quant import quantize_params as j_quantize_params
from substratus_tpu.serve.engine import Engine as JEngine
from substratus_tpu.serve.engine import EngineConfig as JEngineConfig
from substratus_tpu_torch.bridge import params_from_jax
from substratus_tpu_torch.load import dataset, main as load_main
from substratus_tpu_torch.load.gguf import GGUFTokenizer, load_gguf
from substratus_tpu_torch.load.hf import load_pretrained
from substratus_tpu_torch.models import llama, opt
from substratus_tpu_torch.observability.metrics import METRICS
from substratus_tpu_torch.ops.quant import QTensor
from substratus_tpu_torch.serve import main as serve_main
from substratus_tpu_torch.serve.engine import Engine, EngineConfig
from substratus_tpu_torch.tools import ckpt_writer
from substratus_tpu_torch.train import main as train_main
from substratus_tpu_torch.train.checkpoints import META_FILE, PARAMS_FILE, load_artifact

CFG = llama.CONFIGS["tiny"].replace(vocab_size=300, dtype=torch.float32)
TEXTS = ["hello world", "the quick brown fox, again", "Load me"]
PROMPTS = [[1, 5, 9, 33], [1] + list(range(40, 60)), [1, 200, 3]]
EC = {"max_batch": 2, "max_seq_len": 64, "max_prefill_len": 32, "kv_layout": "dense", "overlap": False,
      "eos_token_id": 10**6}
TP = f"00-{'ab' * 16}-{'cd' * 8}-01"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """An HF directory and an F32 GGUF of one seeded model, and the model."""
    d = tmp_path_factory.mktemp("sources")
    model = llama.init_params(CFG, seed=0, device="cpu")
    ckpt_writer.write_hf(str(d / "hf"), model, shard_bytes=100_000)
    ckpt_writer.write_gguf(str(d / "tiny.gguf"), model, ckpt_writer.spm_vocab(300, 0, TEXTS), lambda name: 0)
    return {"hf": str(d / "hf"), "gguf": str(d / "tiny.gguf")}, model


def load(tmp_path, params=None, argv=(), name="out"):
    """load.main's run (float32 weights) into tmp_path/name."""
    p = tmp_path / f"{name}.json"
    p.write_text(json.dumps(params or {}))
    return load_main.run(["--out", str(tmp_path / name), "--params", str(p), "--device", "cpu", *argv],
                         dtype=torch.float32)


def artifact_state(path):
    return torch.load(path / PARAMS_FILE, map_location="cpu", weights_only=True)


def same_state(a, b):
    assert set(a) == set(b)
    for k, v in a.items():
        assert v.dtype == b[k].dtype and torch.equal(v, b[k]), k


def jax_tokens(j_cfg, j_params):
    engine = JEngine(j_cfg, j_params, JEngineConfig(**EC))
    engine.start()
    try:
        return [engine.generate(p, max_tokens=6, temperature=0.0) for p in PROMPTS]
    finally:
        engine.stop()


def port_tokens(path):
    cfg, model = load_artifact(str(path), device="cpu")
    engine = Engine(cfg, model, EngineConfig(**EC), device="cpu")
    engine.start()
    try:
        return [engine.generate(p, max_tokens=6, temperature=0.0) for p in PROMPTS]
    finally:
        engine.stop()


def test_hf_directory_artifact_serves_the_jax_tokens(tmp_path, sources):
    paths, _ = sources
    res = load(tmp_path, argv=["--name", paths["hf"]])
    _, model = load_pretrained(paths["hf"], dtype=torch.float32, device="cpu")
    same_state(artifact_state(tmp_path / "out"), model.state_dict())
    meta = json.loads((tmp_path / "out" / META_FILE).read_text())
    assert meta["source"] == paths["hf"] and "quantize" not in meta and res["load_seconds"] > 0
    j_cfg, j_params = j_load_pretrained(paths["hf"], dtype=jnp.float32)
    assert port_tokens(tmp_path / "out") == jax_tokens(j_cfg, j_params)


def test_gguf_artifact_with_its_vocabulary_serves_the_jax_tokens(tmp_path, sources, monkeypatch):
    """The GGUF's state, the tokenizer.gguf sidecar, and serve.main --model
    on the artifact: the embedded vocabulary and the JAX engine's tokens."""
    paths, _ = sources
    load(tmp_path, {"name": paths["gguf"]})
    _, model = load_gguf(paths["gguf"], dtype=torch.float32, device="cpu")
    same_state(artifact_state(tmp_path / "out"), model.state_dict())
    assert (tmp_path / "out" / "tokenizer.gguf").is_file()
    j_cfg, j_params = jgguf.load_gguf(paths["gguf"], dtype=jnp.float32)
    want = jax_tokens(j_cfg, j_params)
    params = tmp_path / "serve.json"
    params.write_text(json.dumps({k: v for k, v in EC.items() if k not in ("overlap", "eos_token_id")}))
    server = serve_main.build(["--device", "cpu", "--port", "0", "--host", "127.0.0.1", "--params", str(params),
                               "--model", str(tmp_path / "out")])
    try:
        assert isinstance(server.state.tokenizer, GGUFTokenizer) and server.state.tokenizer.vocab_size == 300
        engine = server.state.engine
        engine.ec.eos_token_id = EC["eos_token_id"]
        assert [engine.generate(p, max_tokens=6, temperature=0.0) for p in PROMPTS] == want
    finally:
        server.stop()


def test_seeded_configuration_artifact(tmp_path):
    """No name: a named configuration of any family, drawn from the seed,
    its vocabulary grown to the byte tokenizer's where smaller."""
    res = load(tmp_path, {"config": "tiny", "seed": 3})
    want = llama.init_params(llama.CONFIGS["tiny"].replace(vocab_size=258), seed=3, device="cpu")
    same_state(artifact_state(tmp_path / "out"), want.state_dict())
    assert json.loads((tmp_path / "out" / META_FILE).read_text())["source"] == "random:tiny"
    assert res["cfg"].vocab_size == 258
    load(tmp_path, argv=["--config", "tiny-opt"], name="opt")
    cfg, model = load_artifact(str(tmp_path / "opt"), device="cpu")
    want = opt.init_params(opt.CONFIGS["tiny-opt"].replace(vocab_size=max(258, opt.CONFIGS["tiny-opt"].vocab_size)),
                           seed=0, device="cpu")
    same_state(model.state_dict(), want.state_dict())


def test_int8_artifact_is_the_jax_int8_leaves(tmp_path, sources, capsys):
    """quantize int8 on the HF directory: every int8 value and scale of the
    JAX package's quantize_params on its own import; the artifact serves
    the JAX engine's tokens on those leaves. Another family says it skips."""
    paths, _ = sources
    load(tmp_path, {"name": paths["hf"], "quantize": "int8"})
    j_cfg, j_params = j_load_pretrained(paths["hf"], dtype=jnp.float32)
    j_params = j_quantize_params(j_params, jllama.quant_contracting(j_cfg))
    want = {k: torch.as_tensor(np.asarray(v)) for k, v in params_from_jax(j_params).items()}
    got = artifact_state(tmp_path / "out")
    same_state(got, want)
    assert got["layers.0.wq.q"].dtype == torch.int8
    assert json.loads((tmp_path / "out" / META_FILE).read_text())["quantize"] == "int8"
    _, model = load_artifact(str(tmp_path / "out"), device="cpu")
    assert isinstance(model.layers[0].wq, QTensor)
    assert port_tokens(tmp_path / "out")[:1] == jax_tokens(j_cfg, j_params)[:1]
    load(tmp_path, {"config": "tiny-opt", "quantize": "int8"}, name="opt")
    assert "int8 quantization not supported for this family; skipping" in capsys.readouterr().out
    assert "quantized" not in json.loads((tmp_path / "opt" / META_FILE).read_text())


def test_tokenizer_files_copied_beside_the_weights(tmp_path, sources):
    paths, model = sources
    src = tmp_path / "hf"
    ckpt_writer.write_hf(str(src), model)
    for name in ("tokenizer.model", "tokenizer_config.json", "special_tokens_map.json"):
        (src / name).write_text(name)
    load(tmp_path, {"name": str(src)})
    for name in ("tokenizer.model", "tokenizer_config.json", "special_tokens_map.json"):
        assert (tmp_path / "out" / name).read_text() == name
    assert not (tmp_path / "out" / "tokenizer.json").exists()


def test_load_run_span_under_traceparent(tmp_path, monkeypatch):
    monkeypatch.setenv("TRACEPARENT", TP)
    res = load(tmp_path, {"config": "tiny"})
    spans = [json.loads(ln) for ln in (tmp_path / "out" / "trace.jsonl").read_text().splitlines()]
    run = [s for s in spans if s["name"] == "load.run"]
    assert len(run) == 1 and run[0]["trace_id"] == "ab" * 16 and run[0]["parent_id"] == "cd" * 8
    assert run[0]["attributes"] == {"source": "random"} and res["trace_path"].endswith("trace.jsonl")
    monkeypatch.setenv("SUBSTRATUS_TRACE_EXPORT", str(tmp_path / "elsewhere.jsonl"))
    load(tmp_path, {"config": "tiny"}, name="again")
    assert not (tmp_path / "again" / "trace.jsonl").exists()
    assert [json.loads(ln)["name"] for ln in (tmp_path / "elsewhere.jsonl").read_text().splitlines()] == ["load.run"]


@pytest.mark.parametrize("params,argv,match", [
    ({"nmae": "x"}, [], "unknown key 'nmae'"),
    ({"quantize": "int4"}, [], "quantize='int4' invalid"),
    ({}, ["--name", "/nonexistent/model.gguf"], "no such file"),
    ({"name": "org/hub-model"}, [], "local checkpoints only"),
])
def test_unknown_keys_and_sources_exit(tmp_path, params, argv, match):
    with pytest.raises(SystemExit, match=match):
        load(tmp_path, params, argv)


def _dataset_runs(tmp_path, capsys, params):
    """load.dataset's files and last lines, the JAX entry point's and the port's."""
    out = {}
    for name, mod in (("jax", jdataset), ("port", dataset)):
        p = tmp_path / f"{name}.json"
        p.write_text(json.dumps(params))
        assert mod.main(["--out", str(tmp_path / name), "--params", str(p)]) == 0
        lines = capsys.readouterr().out.replace(str(tmp_path / name), "OUT").splitlines()
        files = {f.name: f.read_bytes() for f in sorted((tmp_path / name).iterdir())}
        out[name] = (files, lines)
    return out["jax"], out["port"]


def test_load_dataset_files_and_urls_match_jax(tmp_path, capsys):
    """Local files and urls from an http.server on localhost (a query
    string dropped from the name): the same files, bytes and lines."""
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.jsonl").write_text('{"text": "one"}\n')
    (src / "b.txt").write_bytes(bytes(range(256)))
    handler = functools.partial(http.server.SimpleHTTPRequestHandler, directory=str(src))
    handler.log_message = lambda *a: None
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        want, got = _dataset_runs(tmp_path, capsys, {"urls": [f"{base}/b.txt?x=1"], "files": [str(src / "a.jsonl")]})
    finally:
        httpd.shutdown()
    assert got == want
    assert set(got[0]) == {"a.jsonl", "b.txt"} and got[0]["b.txt"] == bytes(range(256))
    assert got[1][-1] == "dataset artifact written: 2 files in OUT"


def test_load_dataset_without_sources_warns_as_jax(tmp_path, capsys):
    want, got = _dataset_runs(tmp_path, capsys, {})
    assert got == want and got[1] == ["warning: no sources given (params.urls / params.files empty)",
                                      "dataset artifact written: 0 files in OUT"]
    p = tmp_path / "bad.json"
    p.write_text(json.dumps({"url": []}))
    with pytest.raises(SystemExit, match="unknown key 'url'"):
        dataset.main(["--out", str(tmp_path / "o"), "--params", str(p)])


def _train(tmp_path, corpus, out="art", **params):
    p = tmp_path / f"{out}.json"
    p.write_text(json.dumps({"config": "tiny", "batch_size": 2, "seq_len": 32, "lora_rank": 2, "save_steps": 1,
                             "attn_impl": "plain", **params}))
    return train_main.run(["--data", str(corpus), "--out", str(tmp_path / out), "--params", str(p), "--device",
                           "cpu"])


@pytest.fixture()
def corpus(tmp_path):
    np.save(tmp_path / "c.npy", np.random.default_rng(0).integers(0, 256, 4000, dtype=np.int32))
    return tmp_path / "c.npy"


def test_train_main_traces_its_run_and_fills_the_registry(tmp_path, corpus, monkeypatch, capsys):
    """train.run under TRACEPARENT in {out}/trace.jsonl; every progress line
    with the trace id and its span's id; the registry's step, throughput
    and phase series, one observation a step; the gauges at the last."""
    monkeypatch.setenv("TRACEPARENT", TP)
    before = {k: METRICS.histogram_series(k).get("", {}).get("count", 0)
              for k in ("substratus_train_step_seconds", "substratus_train_tokens_per_second")}
    phase0 = METRICS.histogram_series("substratus_train_phase_seconds")
    res = _train(tmp_path, corpus, steps=3)
    spans = [json.loads(ln) for ln in (tmp_path / "art" / "trace.jsonl").read_text().splitlines()]
    run = next(s for s in spans if s["name"] == "train.run")
    assert run["trace_id"] == "ab" * 16 and run["parent_id"] == "cd" * 8 and run["attributes"]["steps"] == 3
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith('{"event":"train_step"')]
    assert [ln["step"] for ln in lines] == [0, 2]
    assert all(ln["trace_id"] == "ab" * 16 and ln["span_id"] == run["span_id"] for ln in lines)
    for k, n0 in before.items():
        assert METRICS.histogram_series(k)[""]["count"] - n0 == 3, k
    phases = METRICS.histogram_series("substratus_train_phase_seconds")
    for phase in ("step", "data_load", "checkpoint"):
        key = f'phase="{phase}"'
        assert phases[key]["count"] - phase0.get(key, {}).get("count", 0) == 3
    assert METRICS.get("substratus_train_step") == 2 and METRICS.get("substratus_train_loss") == pytest.approx(
        res["losses"][-1])


def jax_window(prof, start_step, steps):
    """substratus_tpu/train/main.py's clamp of profile_steps (its lines
    kept as they are there)."""
    prof_range = None
    if prof and len(list(prof)) == 2:
        a, b = (int(x) for x in prof)
        a, b = max(a, start_step), min(b, steps - 1)
        if a <= b:
            prof_range = (a, b)
    return prof_range


def test_profile_steps_clamped_as_jax_and_traced(tmp_path, corpus):
    """The window [a, b] clamped to this run's steps as JAX clamps it; a run
    traces its window into {out}/profile/trace.json; a resumed run past the
    window traces nothing."""
    for prof, start, steps in [([1, 2], 0, 4), ([0, 99], 0, 3), ([5, 9], 0, 3), ([0, 1], 2, 4), ([2, 1], 0, 4),
                               ([3, 3], 1, 5), (None, 0, 3), ([], 0, 3)]:
        assert train_main.profile_window(prof, start, steps) == jax_window(prof, start, steps), (prof, start, steps)
    res = _train(tmp_path, corpus, steps=3, profile_steps=[1, 9])
    assert res["profile_window"] == (1, 2) and res["profile_trace"].endswith("profile/trace.json")
    trace = json.loads((tmp_path / "art" / "profile" / "trace.json").read_text())
    assert any(e.get("name", "").startswith("aten::") for e in trace["traceEvents"])
    resumed = _train(tmp_path, corpus, steps=4, profile_steps=[0, 1])
    assert resumed["start_step"] == 3 and resumed["profile_window"] is None and resumed["profile_trace"] is None
