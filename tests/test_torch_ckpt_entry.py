"""The port's entry points on checkpoints (substratus_tpu_torch/serve/main.py
``--model`` / params.json ``model`` / /content/model, and train/main.py
``--model``), on the CPU, from one tiny float32 GQA model written by
tools/ckpt_writer.py as an F32 GGUF with an SPM vocabulary, an HF
safetensors directory, an HF .bin directory and a port artifact.

* serve.main serves each; the greedy completions (text and usage) are the
  JAX Engine's on the same GGUF weights (the files hold the same values:
  the loaded states are compared first), encoded by each checkpoint's own
  tokenizer (the embedded vocab, or bytes), and for the artifact those of
  an in-process Engine on the model that wrote it;
* a model mounted at /content/model (monkeypatched path) is found;
* train.main --model trains 2 steps from each format, and serve.main serves
  the artifact it writes (with the base's tokenizer) as an Engine on the
  merged model;
* QLoRA: on an int8-quantized loaded base with the JAX adapters
  (lora_from_jax), the port Trainer's losses are the JAX Trainer's within
  tests/test_torch_train.py's tolerances; train.main with quantize int8
  trains, and its artifact (int8 base, merged bf16 adapted weights)
  serves;
* quantize without a model, a JAX Orbax artifact and a path that is no
  local checkpoint exit.

Servers load float32 here (load_checkpoint patched to dtype float32); the
entry points' default is bf16.
"""
import functools
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substratus_tpu.load import gguf as jgguf
from substratus_tpu.models import llama as jllama
from substratus_tpu.ops.quant import quantize_params as j_quantize_params
from substratus_tpu.parallel.mesh import build_mesh
from substratus_tpu.serve.engine import Engine as JEngine
from substratus_tpu.serve.engine import EngineConfig as JEngineConfig
from substratus_tpu.train.trainer import TrainConfig as JTrainConfig
from substratus_tpu.train.trainer import Trainer as JTrainer
from substratus_tpu_torch.bridge import lora_from_jax, params_from_jax
from substratus_tpu_torch.load.gguf import GGUFTokenizer, load_gguf
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.ops.quant import QTensor
from substratus_tpu_torch.serve import main as serve_main
from substratus_tpu_torch.serve.engine import Engine, EngineConfig
from substratus_tpu_torch.serve.tokenizer import ByteTokenizer
from substratus_tpu_torch.tools import ckpt_writer
from substratus_tpu_torch.train import main as train_main
from substratus_tpu_torch.train.checkpoints import META_FILE, save_artifact
from substratus_tpu_torch.train.trainer import TrainConfig, Trainer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread keeps torch's worker
    pool from spinning on cores that timing-sensitive tests share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = llama.CONFIGS["tiny"].replace(vocab_size=300, dtype=torch.float32)
TEXTS = ["hello world", "the quick brown fox, again", "Serve me"]
SERVE_PARAMS = {"max_batch": 2, "max_seq_len": 64, "max_prefill_len": 32}
NEVER = 10**6  # an EOS id the JAX engine never samples; each tokenizer's EOS then cuts its tokens


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """{format: path} of one seeded model, and the model."""
    d = tmp_path_factory.mktemp("ckpts")
    model = llama.init_params(CFG, seed=0, device="cpu")
    (d / "gguf").mkdir()
    ckpt_writer.write_gguf(str(d / "gguf" / "tiny.gguf"), model, ckpt_writer.spm_vocab(300, 0, TEXTS),
                           lambda name: 0)  # F32: the file holds the model's values
    ckpt_writer.write_hf(str(d / "hf"), model, shard_bytes=100_000)
    (d / "bin").mkdir()
    (d / "bin" / "config.json").write_text(json.dumps(ckpt_writer.hf_config(CFG)))
    torch.save(dict(ckpt_writer.hf_tensors(model)), d / "bin" / "pytorch_model.bin")
    save_artifact(str(d / "artifact"), model, CFG)
    paths = {"gguf": str(d / "gguf" / "tiny.gguf"), "hf": str(d / "hf"), "bin": str(d / "bin"),
             "artifact": str(d / "artifact")}
    return paths, model


@pytest.fixture(scope="module")
def jax_tokens(ckpts):
    """{prompt ids: greedy tokens} of the JAX Engine on the GGUF file's
    weights, for the prompts of both tokenizers."""
    paths, _ = ckpts
    j_cfg, j_params = jgguf.load_gguf(paths["gguf"], dtype=jnp.float32)
    tok = GGUFTokenizer(jgguf.read_gguf(paths["gguf"], with_tensors=False)[0])
    prompts = [tok.encode(t) for t in TEXTS] + [ByteTokenizer().encode(t) for t in TEXTS]
    engine = JEngine(j_cfg, j_params, JEngineConfig(kv_layout="dense", overlap=False, eos_token_id=NEVER,
                                                    **SERVE_PARAMS))
    engine.start()
    try:
        return {tuple(p): engine.generate(p, max_tokens=8, temperature=0.0) for p in prompts}
    finally:
        engine.stop()


def _serve(path, tmp_path, monkeypatch, argv=("--model",), params=None):
    monkeypatch.setattr(serve_main, "load_checkpoint", functools.partial(serve_main.load_checkpoint,
                                                                         dtype=torch.float32))
    p = tmp_path / "params.json"
    p.write_text(json.dumps(dict(SERVE_PARAMS, kv_layout="dense", **(params or {}))))
    model = [*argv, path] if argv else []
    return serve_main.build(["--device", "cpu", "--host", "127.0.0.1", "--port", "0", "--params", str(p),
                             *model]).start()


def _complete(srv, text):
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/v1/completions", headers={
        "Content-Type": "application/json"}, data=json.dumps({"prompt": text, "max_tokens": 8,
                                                              "temperature": 0}).encode())
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _check_served(srv, want_tokens):
    """Every TEXTS prompt's served completion is `want_tokens(prompt ids)`
    cut at the tokenizer's EOS: its text, usage and finish reason."""
    tok = srv.state.tokenizer
    for text in TEXTS:
        prompt = tok.encode(text)
        want = list(want_tokens(prompt))
        finish = "stop" if tok.eos_id in want else "length"
        want = want[: want.index(tok.eos_id)] if tok.eos_id in want else want
        body = _complete(srv, text)
        assert body["usage"]["prompt_tokens"] == len(prompt) and body["usage"]["completion_tokens"] == len(want)
        assert body["choices"][0]["text"] == tok.decode(want) and body["choices"][0]["finish_reason"] == finish


def _engine_tokens(model, cfg):
    engine = Engine(cfg, model, EngineConfig(eos_token_id=NEVER, kv_layout="dense", **SERVE_PARAMS), device="cpu")
    engine.start()
    return engine, lambda prompt: engine.generate(prompt, max_tokens=8, temperature=0.0)


@pytest.mark.parametrize("fmt", ["gguf", "hf", "bin", "artifact"])
def test_serve_main_serves_checkpoint(ckpts, jax_tokens, tmp_path, monkeypatch, fmt):
    paths, model = ckpts
    srv = _serve(paths[fmt], tmp_path, monkeypatch)
    try:
        assert srv.state.model_name == ("tiny.gguf" if fmt == "gguf" else fmt)
        assert isinstance(srv.state.tokenizer, GGUFTokenizer if fmt == "gguf" else ByteTokenizer)
        loaded = srv.state.engine.params.state_dict()
        assert all(torch.equal(t, loaded[n]) for n, t in model.state_dict().items())  # the same values
        if fmt == "artifact":
            engine, tokens = _engine_tokens(model, CFG)
            try:
                _check_served(srv, tokens)
            finally:
                engine.stop()
        else:
            _check_served(srv, lambda prompt: jax_tokens[tuple(prompt)])
    finally:
        srv.stop()


def test_content_model_and_params_model(ckpts, tmp_path, monkeypatch):
    paths, _ = ckpts
    monkeypatch.setattr(serve_main, "CONTENT_MODEL", paths["hf"])
    srv = _serve(None, tmp_path, monkeypatch, argv=())
    srv.stop()
    assert srv.state.model_name == "hf"
    srv = _serve(None, tmp_path, monkeypatch, argv=(), params={"model": paths["gguf"]})
    srv.stop()
    assert srv.state.model_name == "tiny.gguf"
    monkeypatch.setattr(serve_main, "CONTENT_MODEL", str(tmp_path / "not-mounted"))
    srv = _serve(None, tmp_path, monkeypatch, argv=(), params={"config": "tiny"})
    srv.stop()
    assert srv.state.model_name == "tiny"  # random weights of the named config


def _corpus(tmp_path):
    data = tmp_path / "data.jsonl"
    data.write_text("\n".join(json.dumps({"text": f"{t} number {i}"}) for i, t in enumerate(TEXTS * 6)))
    return data


def _train(tmp_path, model_path, **params):
    p = tmp_path / "train.json"
    p.write_text(json.dumps({"steps": 2, "batch_size": 2, "seq_len": 32, "lora_rank": 4, "learning_rate": 1e-2,
                             "warmup_steps": 1, "save_steps": 2, **params}))
    out = tmp_path / "out"
    res = train_main.run(["--model", model_path, "--data", str(_corpus(tmp_path)), "--out", str(out),
                          "--params", str(p), "--device", "cpu"])
    return res, out


@pytest.mark.parametrize("fmt", ["gguf", "hf", "artifact"])
def test_train_from_checkpoint_then_serve_its_artifact(ckpts, tmp_path, monkeypatch, fmt):
    paths, model = ckpts
    res, out = _train(tmp_path, paths[fmt])
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))
    assert res["cfg"].dim == CFG.dim and res["cfg"].vocab_size == 300
    # The base came from the checkpoint: its untouched weights are the model's (rounded to bf16 when loaded).
    assert torch.equal(res["merged"].layers[1].w_up, model.layers[1].w_up.to(res["cfg"].dtype))
    assert (out / "tokenizer.gguf").exists() == (fmt == "gguf")
    monkeypatch.setattr(serve_main, "load_checkpoint", serve_main.load_checkpoint)
    srv = _serve(str(out), tmp_path, monkeypatch)
    engine = None
    try:
        assert isinstance(srv.state.tokenizer, GGUFTokenizer if fmt == "gguf" else ByteTokenizer)
        engine, tokens = _engine_tokens(res["merged"], res["cfg"])
        _check_served(srv, tokens)
    finally:
        srv.stop()
        if engine is not None:
            engine.stop()


def test_qlora_matches_jax_trainer_and_serves(ckpts, tmp_path, monkeypatch):
    paths, _ = ckpts
    j_cfg, j_params = jgguf.load_gguf(paths["gguf"], dtype=jnp.float32)
    # Not jitted: under jit XLA turns absmax / 127 into a product with 1/127,
    # one ulp off in some scales; the port matches quantize_params itself.
    j_params = j_quantize_params(j_params, jllama.quant_contracting(j_cfg))
    cfg, model = load_gguf(paths["gguf"], dtype=torch.float32, device="cpu")
    llama.quantize_weights(model, "int8")
    want = params_from_jax(jax.device_get(j_params))
    assert all(torch.equal(t, want[n]) for n, t in model.state_dict().items())
    tc = dict(learning_rate=2e-4, warmup_steps=2, total_steps=10, lora_rank=4)
    jt = JTrainer(j_cfg, JTrainConfig(remat=False, **tc), build_mesh(devices=jax.devices()[:1]), params=j_params)
    tt = Trainer(cfg, TrainConfig(remat=True, **tc), params=model)
    tt.lora.load_state_dict(lora_from_jax(jax.device_get(jt.lora)))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 300, (4, 32)).astype(np.int32), "weights": np.ones((4, 32), np.float32)}
    want = [jt.train_step(batch) for _ in range(3)]
    got = [tt.train_step(batch) for _ in range(3)]
    np.testing.assert_allclose(got[:2], want[:2], atol=1e-5)  # step 0 has rate 0: B leaves 0 at step 1
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert isinstance(tt.params.layers[0].wq, QTensor)

    res, out = _train(tmp_path, paths["gguf"], quantize="int8")
    assert all(np.isfinite(res["losses"]))
    meta = json.loads((out / META_FILE).read_text())
    assert meta["quantized"]["layers.0.wk"] == "int8" and "layers.0.wq" not in meta["quantized"]
    assert res["merged"].layers[0].wq.dtype == torch.bfloat16  # merged adapted weights: dense bf16, as JAX's
    srv = _serve(str(out), tmp_path, monkeypatch)
    engine = None
    try:
        loaded = srv.state.engine.params.state_dict()
        assert all(torch.equal(t, loaded[n]) for n, t in res["merged"].state_dict().items() if torch.is_tensor(t))
        engine, tokens = _engine_tokens(res["merged"], res["cfg"])
        _check_served(srv, tokens)
    finally:
        srv.stop()
        if engine is not None:
            engine.stop()


def test_checkpoint_exits(ckpts, tmp_path, monkeypatch):
    paths, _ = ckpts
    p = tmp_path / "p.json"
    for params, match in (({"quantize": "int8", "lora_rank": 4}, "QLoRA, which needs a base model"),
                          ({"quantize": "int8"}, "set lora_rank"), ({"quantize": "int4", "lora_rank": 4}, "invalid")):
        p.write_text(json.dumps(params))
        monkeypatch.setattr(serve_main, "CONTENT_MODEL", str(tmp_path / "not-mounted"))
        with pytest.raises(SystemExit, match=match):
            train_main.run(["--data", str(_corpus(tmp_path)), "--out", str(tmp_path / "o"), "--params", str(p),
                            "--device", "cpu"])
    orbax = tmp_path / "orbax"
    (orbax / "params").mkdir(parents=True)
    (orbax / META_FILE).write_text(json.dumps({"format": "substratus-tpu-v1", "model_config": {}}))
    with pytest.raises(SystemExit, match="'substratus-tpu-v1'.*need JAX and Orbax"):
        serve_main.load_checkpoint(str(orbax), "cpu")
    for path in ("meta-llama/Llama-2-7b-hf", str(tmp_path / "missing")):
        with pytest.raises(SystemExit, match="local checkpoints only"):
            serve_main.load_checkpoint(path, "cpu")
    with pytest.raises(SystemExit, match="no such file"):
        serve_main.load_checkpoint(str(tmp_path / "missing.gguf"), "cpu")
    # A tokenizer with more ids than the model has rows.
    small = tmp_path / "small"
    ckpt_writer.write_hf(str(small), llama.init_params(CFG.replace(vocab_size=200), device="cpu"))
    with pytest.raises(SystemExit, match="258 ids but the model's embedding only 200 rows"):
        _serve(str(small), tmp_path, monkeypatch)
