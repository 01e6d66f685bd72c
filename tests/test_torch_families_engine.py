"""The port's Engine and serve.main on the OPT and Falcon families against
the JAX Engine(model=opt|falcon), on the CPU.

float32 tiny configs (vocabulary 258, EOS 257, an id these weights never
sample here), the JAX weights carried across by bridge.params_from_jax.
Five prompts of 3-45 tokens, all queued before the scheduler starts, with
max_prefill_len 16, so three of them run as chunks through the cached
attention: the port's synchronous and overlapped engines give the JAX
engine's greedy tokens exactly, and so does prompt lookup (spec_k 3, the
dense cache) against the JAX spec engine, with its proposal counts. The
llama-only knobs are handled as JAX handles them: kv_cache_dtype int8 and
kv_layout paged raise ValueError, auto resolves to dense; serve.main skips
quantize with JAX's message, says the attention knobs are ignored, and
turns a draft model off on the dense cache.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substratus_tpu.models import falcon as jfalcon
from substratus_tpu.models import opt as jopt
from substratus_tpu.serve.engine import Engine as JEngine
from substratus_tpu.serve.engine import EngineConfig as JEngineConfig
from substratus_tpu.serve.engine import Request as JRequest
from substratus_tpu_torch.bridge import params_from_jax
from substratus_tpu_torch.models import opt, registry
from substratus_tpu_torch.serve import main
from substratus_tpu_torch.serve.engine import Engine, EngineConfig, Request


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


EOS = 257
NAMES = ("tiny-opt", "tiny-falcon", "tiny-falcon-40b-style")
J_MODULES = {"tiny-opt": jopt, "tiny-falcon": jfalcon, "tiny-falcon-40b-style": jfalcon}
_r = np.random.default_rng(0)
PROMPTS = [[256] + _r.integers(0, 256, n - 1).tolist() for n in (3, 9, 17, 30, 45)]
EC = dict(max_batch=4, max_seq_len=64, max_prefill_len=16, eos_token_id=EOS)
_WEIGHTS = {}


def weights(name):
    """(jax module, jax cfg, jax params, port cfg, port params), seed 0."""
    if name not in _WEIGHTS:
        jmod = J_MODULES[name]
        jcfg = jmod.CONFIGS[name].replace(vocab_size=258, dtype=jnp.float32)
        tcfg = registry.find_named_config(name)[1].replace(vocab_size=258, dtype=torch.float32)
        j_params = jmod.init_params(jcfg, jax.random.key(0))
        t_params = registry.MODEL_CLASSES[registry.family_of(tcfg)](tcfg, device="cpu")
        t_params.load_state_dict(params_from_jax(jax.device_get(j_params)))
        _WEIGHTS[name] = (jmod, jcfg, j_params, tcfg, t_params)
    return _WEIGHTS[name]


def _run(engine, req_cls, prompts, max_tokens=12):
    """Submit every prompt before the scheduler starts, then collect each
    stream: [(tokens, finish)] in submission order."""
    reqs = [engine.submit(req_cls(list(p), max_tokens=max_tokens, temperature=0.0)) for p in prompts]
    engine.start()
    try:
        outs = []
        for req in reqs:
            toks = []
            while (tok := req.out.get(timeout=300)) is not None:
                toks.append(tok)
            outs.append((toks, req.finish_reason))
        return outs
    finally:
        engine.stop()


@pytest.mark.parametrize("name", NAMES)
def test_engine_matches_jax_engine(name):
    """The synchronous and the overlapped engine, dense cache, chunked
    prompts included, token for token the JAX engine's."""
    jmod, jcfg, j_params, tcfg, t_params = weights(name)
    want = _run(JEngine(jcfg, j_params, JEngineConfig(kv_layout="dense", overlap=False, **EC), model=jmod),
                JRequest, PROMPTS)
    assert all(EOS not in toks for toks, _ in want) and [len(t) for t, _ in want] == [12] * 5
    for overlap in (False, None):
        engine = Engine(tcfg, t_params, EngineConfig(overlap=overlap, **EC), device="cpu")
        assert engine.model is registry.module_of(tcfg) and not engine.paged  # auto: dense for the family
        got = _run(engine, Request, PROMPTS)
        assert got == want, overlap
        assert engine.stats["prefill_chunks"] == 2 + 2 + 3 and engine.stats["prefills"] == 2


@pytest.mark.parametrize("name", ["tiny-opt", "tiny-falcon"])
def test_llama_only_engine_knobs_raise(name):
    """kv_cache_dtype int8 and kv_layout paged raise ValueError for a
    family without them, as in the JAX engine, whose own refusal is held
    beside."""
    jmod, jcfg, j_params, tcfg, t_params = weights(name)
    for knob, match in (({"kv_cache_dtype": "int8"}, "kv_cache_dtype=int8 unsupported"),
                        ({"kv_layout": "paged"}, "kv_layout=paged unsupported")):
        with pytest.raises(ValueError, match=match):
            JEngine(jcfg, j_params, JEngineConfig(**knob, **EC), model=jmod)
        with pytest.raises(ValueError, match=match):
            Engine(tcfg, t_params, EngineConfig(**knob, **EC), device="cpu")
    assert not Engine(tcfg, t_params, EngineConfig(kv_layout="dense", **EC), device="cpu").paged


def test_prompt_lookup_matches_jax_engine():
    """spec_k 3 with prompt lookup on the dense cache (verify passes of up
    to 4 tokens through the cached attention), tiny-falcon: greedy tokens
    and the proposal counts equal the JAX spec engine's."""
    jmod, jcfg, j_params, tcfg, t_params = weights("tiny-falcon")
    prompts = [([10 + 5 * i + j for j in range(4)] * 5)[:18] for i in range(3)] + PROMPTS[:2]
    ec = dict(EC, spec_k=3, kv_layout="dense")
    j_engine = JEngine(jcfg, j_params, JEngineConfig(overlap=False, **ec), model=jmod)
    want = _run(j_engine, JRequest, prompts, max_tokens=16)
    engine = Engine(tcfg, t_params, EngineConfig(overlap=False, **ec), device="cpu")
    got = _run(engine, Request, prompts, max_tokens=16)
    assert got == want
    stats = ("spec_proposed", "spec_accepted", "verify_passes")
    assert {k: engine.stats[k] for k in stats} == {k: j_engine.stats[k] for k in stats}
    assert engine.stats["spec_proposed"] > 0


def _build(tmp_path, params, argv=()):
    p = tmp_path / "params.json"
    p.write_text(json.dumps(params))
    return main.build(["--device", "cpu", "--host", "127.0.0.1", "--port", "0", "--params", str(p), *argv])


def test_serve_main_skips_llama_knobs(tmp_path, capsys):
    """serve.main --config tiny-opt with quantize int8 and the attention
    knobs: JAX's "quantization not supported for this family; skipping",
    the knobs reported ignored, dense weights and the dense cache; a draft
    model (paged only) turned off with JAX's message; kv_cache_dtype int8
    refused by the engine."""
    srv = _build(tmp_path, {"config": "tiny-opt", "quantize": "int8", "decode_attn_impl": "fused",
                            "attn_impl": "plain", "max_batch": 2, "max_seq_len": 64})
    try:
        out = capsys.readouterr().out
        assert "int8 quantization not supported for this family; skipping" in out
        assert "decode_attn_impl ignored" in out and "attn_impl ignored" in out
        engine = srv.state.engine
        assert isinstance(engine.params, opt.OPT) and not engine.paged
        assert all(p.dtype == torch.bfloat16 for p in engine.params.parameters())
        assert len(engine.generate([1, 2, 3], max_tokens=4, temperature=0.0)) == 4
    finally:
        srv.stop()
    srv = _build(tmp_path, {"config": "tiny-falcon", "spec_k": 2, "max_batch": 2, "max_seq_len": 64},
                 ["--draft-model", str(tmp_path / "unused")])
    srv.stop()
    assert "draft spec_k needs kv_layout=paged; speculation disabled" in capsys.readouterr().out
    assert not srv.state.engine.spec
    with pytest.raises(ValueError, match="kv_cache_dtype=int8 unsupported"):
        _build(tmp_path, {"config": "tiny-falcon", "kv_cache_dtype": "int8", "max_batch": 2, "max_seq_len": 64})
