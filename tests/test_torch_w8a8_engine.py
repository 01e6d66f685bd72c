"""quantize: w8a8 served by the port (Engine, serve.main, batch
generation) against the JAX package on the same weights, on the CPU.

float32 tiny configs (vocabulary 258), JAX's weights quantized by its
quantize_params (unjitted: under jit XLA's scales are an ulp off) and
carried by the bridge, with quant_activations set on both sides (the
port's config by bridge.config_from_jax). The JAX engine is synchronous
(overlap=False), as the port's tests of other slices hold it.

* The Engine's greedy tokens for concurrent prompts, one of 71 tokens in
  chunks of 32, are the JAX Engine's on the dense cache and the paged
  pool, on the port's synchronous and overlapped schedulers (the step
  runs eagerly over the graph's static buffers on the CPU); tiny-moe on
  the dense cache too; prompt-lookup speculation (the verify rounds)
  token for token and proposal for proposal.
* serve.main with quantize: w8a8 on an HF directory of the dense weights
  quantizes them as int8 at load, bit for bit JAX's, sets
  quant_activations, says w8a8 on its startup line, and serves the JAX
  engine's tokens on the dense cache and on the paged default.
* serve.batchgen --quantize w8a8 writes the JAX engine's greedy tokens.
* OPT (no quantized weights in either package) prints JAX's "w8a8
  quantization not supported for this family; skipping" and serves
  dense weights.
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substratus_tpu.models import llama as jllama
from substratus_tpu.models import opt as jopt
from substratus_tpu.ops.quant import quantize_params as j_quantize_params
from substratus_tpu.serve import main as jmain
from substratus_tpu.serve.engine import Engine as JEngine
from substratus_tpu.serve.engine import EngineConfig as JEngineConfig
from substratus_tpu.serve.engine import Request as JRequest
from substratus_tpu_torch.bridge import config_from_jax, params_from_jax
from substratus_tpu_torch.load import manifest as tmanifest
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.ops.quant import QTensor
from substratus_tpu_torch.serve import batchgen
from substratus_tpu_torch.serve import main as serve_main
from substratus_tpu_torch.serve.engine import Engine, EngineConfig, Request
from substratus_tpu_torch.tools import ckpt_writer

EOS = 257
EC = dict(max_batch=4, max_seq_len=128, max_prefill_len=32, eos_token_id=EOS)
_MODELS = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def models(name="tiny"):
    """(JAX cfg, JAX int8 params, port cfg, port int8 Llama, port dense Llama), w8a8 configs."""
    if name not in _MODELS:
        jcfg = jllama.CONFIGS[name].replace(vocab_size=258, dtype=jnp.float32, quant_activations=True)
        dense = jllama.init_params(jcfg, jax.random.key(0))
        j_params = j_quantize_params(dense, jllama.quant_contracting(jcfg))
        tcfg = config_from_jax(jcfg)
        t_params = llama.Llama(tcfg, device="cpu", quantize="int8")
        t_params.load_state_dict(params_from_jax(jax.device_get(j_params)))
        t_dense = llama.Llama(tcfg.replace(quant_activations=False), device="cpu")
        t_dense.load_state_dict(params_from_jax(jax.device_get(dense)))
        _MODELS[name] = (jcfg, j_params, tcfg, t_params, t_dense)
    return _MODELS[name]


def _run(engine, req_cls, prompts, max_tokens=8):
    """Submit every prompt before reading any output, then collect each."""
    engine.start()
    try:
        reqs = [engine.submit(req_cls(list(p), max_tokens=max_tokens, temperature=0.0)) for p in prompts]
        outs = []
        for req in reqs:
            toks = []
            while (tok := req.out.get(timeout=300)) is not None:
                toks.append(tok)
            outs.append(toks)
        return outs
    finally:
        engine.stop()


def _prompts(seed=7):
    r = np.random.default_rng(seed)
    return [[256] + r.integers(0, 255, n - 1).tolist() for n in (71, 5, 20)]


_JAX_RUNS = {}


def jax_tokens(name, layout, prompts):
    key = (name, layout, tuple(map(tuple, prompts)))
    if key not in _JAX_RUNS:
        jcfg, j_params, *_ = models(name)
        _JAX_RUNS[key] = _run(JEngine(jcfg, j_params, JEngineConfig(kv_layout=layout, overlap=False, **EC)),
                              JRequest, prompts)
    return _JAX_RUNS[key]


@pytest.mark.parametrize("layout,overlap", [("dense", False), ("dense", True), ("paged", False), ("paged", True)])
def test_engine_matches_jax_engine(layout, overlap):
    _, _, tcfg, t_params, _ = models()
    prompts = _prompts()
    engine = Engine(tcfg, t_params, EngineConfig(kv_layout=layout, overlap=overlap, **EC), device="cpu")
    got = _run(engine, Request, prompts)
    assert got == jax_tokens("tiny", layout, prompts) and all(len(t) >= 1 for t in got)
    assert engine.cfg.quant_activations and engine.overlap == overlap
    if layout == "dense":
        assert engine.stats["prefill_chunks"] == 3 and engine.stats["prefills"] == 2


def test_moe_engine_matches_jax_engine():
    _, _, tcfg, t_params, _ = models("tiny-moe")
    prompts = _prompts(11)
    engine = Engine(tcfg, t_params, EngineConfig(kv_layout="dense", **EC), device="cpu")
    assert _run(engine, Request, prompts) == jax_tokens("tiny-moe", "dense", prompts)


def test_prompt_lookup_speculation_matches_jax():
    """Speculative decoding (prompt lookup, k = 3, the paged pool, both
    overlapped): the verify rounds run the w8a8 products at every width,
    and the tokens and the accepted proposals are the JAX engine's."""
    jcfg, j_params, tcfg, t_params, _ = models()
    prompts = [([10 + 5 * i + j for j in range(4)] * 4) for i in range(4)]
    ec = dict(EC, spec_k=3, kv_layout="paged", overlap=True)
    outs = []
    for eng, req_cls in ((Engine(tcfg, t_params, EngineConfig(**ec), device="cpu"), Request),
                         (JEngine(jcfg, j_params, JEngineConfig(**ec)), JRequest)):
        reqs = [eng.submit(req_cls(list(p), max_tokens=12, temperature=0.0)) for p in prompts]
        eng.start()  # every request submitted first: the lookup history, so the widths, are the same
        try:
            outs.append([[t for t in iter(r.out.get, None)] for r in reqs])
        finally:
            eng.stop()
        outs[-1].append((eng.stats["spec_proposed"], eng.stats["spec_accepted"]))
    assert outs[0] == outs[1] and outs[0][-1][1] > 0


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """An HF directory of the tiny model's dense f32 weights."""
    d = tmp_path_factory.mktemp("w8a8-hf")
    ckpt_writer.write_hf(str(d), models()[4])
    return str(d)


def _f32_loader(monkeypatch):
    monkeypatch.setattr(serve_main, "load_checkpoint", functools.partial(serve_main.load_checkpoint,
                                                                         dtype=torch.float32))


def test_serve_main_w8a8_matches_jax(hf_dir, tmp_path, monkeypatch, capsys):
    _f32_loader(monkeypatch)
    t_params = models()[3]
    prompts = _prompts(3)
    for layout in ("dense", "auto"):
        p = tmp_path / f"params-{layout}.json"
        p.write_text(json.dumps({"quantize": "w8a8", "kv_layout": layout, "max_batch": 4, "max_seq_len": 128,
                                 "max_prefill_len": 32}))
        srv = serve_main.build(["--device", "cpu", "--host", "127.0.0.1", "--port", "0", "--params", str(p),
                                "--model", hf_dir])
        engine = srv.state.engine
        try:
            assert engine.cfg.quant_activations and engine.paged == (layout == "auto")
            got_sd, want_sd = engine.params.state_dict(), t_params.state_dict()
            assert got_sd.keys() == want_sd.keys() and all(torch.equal(got_sd[k], v) for k, v in want_sd.items())
            assert isinstance(engine.params.layers[1].wo, QTensor)
            got = [engine.generate(pr, max_tokens=8, temperature=0.0) for pr in prompts]
        finally:
            srv.stop()
        assert got == jax_tokens("tiny", "paged" if layout == "auto" else "dense", prompts)
        line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("serving ")][-1]
        assert "w8a8: int8 weights x per-token int8 activations" in line


def test_batchgen_w8a8_matches_jax(hf_dir, tmp_path, monkeypatch, capsys):
    _f32_loader(monkeypatch)
    prompts = _prompts(5)
    man = tmp_path / "m.jsonl"
    tmanifest.write_manifest(str(man), [{"id": f"r{i}", "tokens": p} for i, p in enumerate(prompts)])
    p = tmp_path / "params.json"
    p.write_text(json.dumps({"kv_layout": "dense", "max_prefill_len": 32}))
    rc = batchgen.main(["--model", hf_dir, "--device", "cpu", "--quantize", "w8a8", "--params", str(p),
                        "--manifest", str(man), "--output", str(tmp_path / "out"), "--max-tokens", "8",
                        "--max-batch", "4", "--max-seq-len", "128"])
    assert rc == 0
    out = {}
    for name in os.listdir(tmp_path / "out"):
        for line in open(tmp_path / "out" / name):
            rec = json.loads(line)
            out[rec["index"]] = rec["tokens"]
    assert [out[i] for i in range(len(prompts))] == jax_tokens("tiny", "dense", prompts)
    assert "w8a8 weights" in capsys.readouterr().out


def test_other_family_skips_w8a8_as_jax(tmp_path, capsys):
    jcfg = jopt.CONFIGS["tiny-opt"]
    jmain._maybe_quantize(jopt, jcfg, {}, "w8a8")
    want = capsys.readouterr().out.strip()
    assert want == "w8a8 quantization not supported for this family; skipping"
    p = tmp_path / "params.json"
    p.write_text(json.dumps({"config": "tiny-opt", "quantize": "w8a8", "max_batch": 2, "max_seq_len": 64}))
    srv = serve_main.build(["--device", "cpu", "--host", "127.0.0.1", "--port", "0", "--params", str(p)])
    try:
        engine = srv.state.engine
        assert not getattr(engine.cfg, "quant_activations", False)
        assert not any(isinstance(m, QTensor) for m in engine.params.modules())
        assert len(engine.generate([256, 1, 2], max_tokens=3, temperature=0.0)) == 3
    finally:
        srv.stop()
    assert want in capsys.readouterr().out.splitlines()
