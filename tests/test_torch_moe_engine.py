"""The port's Engine and serve.main on a mixture of experts (tiny-moe,
Mixtral's layout at a small size) against the JAX Engine, on the CPU.

float32, vocabulary 258 (EOS 257), the JAX weights carried across by
bridge.params_from_jax. Six prompts of 5-40 tokens, all queued before the
scheduler starts, with max_prefill_len 16, so four run as chunks: the
port's synchronous and overlapped engines give the JAX engine's greedy
tokens exactly on the dense and the paged layout (the dropless expert mix
in every prefill, chunk and decode step), on int4 expert weights too, and
with prompt lookup (spec_k 3). Tenants on the attention targets serve over
the MoE base as the JAX store serves them; expert targets are refused with
JAX's message. serve.main --config tiny-moe draws and quantizes the model
layer by layer, the bytes those of drawing dense and quantizing after.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substratus_tpu.models import llama as jllama
from substratus_tpu.ops.quant4 import quantize4_params as jquantize4_params
from substratus_tpu.serve import adapters as jadapters
from substratus_tpu.serve.engine import Engine as JEngine
from substratus_tpu.serve.engine import EngineConfig as JEngineConfig
from substratus_tpu.serve.engine import Request as JRequest
from substratus_tpu_torch.bridge import params_from_jax
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.serve import adapters, main
from substratus_tpu_torch.serve.engine import Engine, EngineConfig, Request


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


EOS = 257
J_CFG = jllama.CONFIGS["tiny-moe"].replace(vocab_size=258, dtype=jnp.float32)
T_CFG = llama.CONFIGS["tiny-moe"].replace(vocab_size=258, dtype=torch.float32)
_r = np.random.default_rng(11)
PROMPTS = [[256] + _r.integers(0, 256, n - 1).tolist() for n in (5, 23, 40, 9, 31, 17)]
ATTN = ("wq", "wk", "wv", "wo")
_WEIGHTS = {}


def weights(quantize="none"):
    """(JAX params, the port's Llama) from seed 0, dense or int4 (JAX's
    quantize4 bytes, loaded into the port's int4 layout)."""
    if quantize not in _WEIGHTS:
        j_params = jllama.init_params(J_CFG, jax.random.key(0))
        if quantize == "int4":
            j_params = jquantize4_params(j_params, jllama.quant_contracting(J_CFG))
        t_params = llama.Llama(T_CFG, device="cpu", quantize=quantize)
        t_params.load_state_dict(params_from_jax(jax.device_get(j_params)))
        _WEIGHTS[quantize] = (j_params, t_params)
    return _WEIGHTS[quantize]


def ec(layout, **kw):
    return dict(max_batch=4, max_seq_len=64, max_prefill_len=16, eos_token_id=EOS, kv_layout=layout, **kw)


def run(engine, req_cls, prompts=PROMPTS, tenants=None, max_tokens=10):
    """Submit every request before start (a fixed schedule), then read each
    request's (tokens, finish reason)."""
    tenants = tenants or [None] * len(prompts)
    kw = [{"adapter": a} if a is not None else {} for a in tenants]
    reqs = [engine.submit(req_cls(list(p), max_tokens=max_tokens, temperature=0.0, **k)) for p, k in zip(prompts, kw)]
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


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_engine_matches_jax_engine(layout):
    """The synchronous and the overlapped engine, chunked prompts
    included, token for token the JAX engine's on the MoE model."""
    j_params, t_params = weights()
    want = run(JEngine(J_CFG, j_params, JEngineConfig(overlap=False, **ec(layout))), JRequest)
    assert sum(len(t) == 10 for t, _ in want) >= 4
    for overlap in (False, None):
        engine = Engine(T_CFG, t_params, EngineConfig(overlap=overlap, **ec(layout)), device="cpu")
        assert engine.paged == (layout == "paged")
        assert run(engine, Request) == want, overlap
        chunks = engine.stats["prefill_chunks"]
        assert chunks == sum(-(-len(p) // 16) for p in PROMPTS if layout == "paged" or len(p) > 16)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_int4_experts_match_jax_engine(layout):
    """int4 expert weights (JAX's quantize4 bytes): the port runs each
    expert's product through the int4 matmul's route (the plain version on
    the CPU), the JAX engine its dequantized einsum: the same greedy
    tokens."""
    j_params, t_params = weights("int4")
    assert llama.quantized_layout(t_params)["layers.0.w_gate"] == "int4"
    want = run(JEngine(J_CFG, j_params, JEngineConfig(overlap=False, **ec(layout))), JRequest)
    got = run(Engine(T_CFG, t_params, EngineConfig(**ec(layout)), device="cpu"), Request)
    assert got == want


def test_prompt_lookup_matches_jax_engine():
    """spec_k 3 with prompt lookup on the dense cache (verify passes of up
    to 4 tokens, each through the expert mix): greedy tokens and the
    proposal counts equal the JAX spec engine's."""
    j_params, t_params = weights()
    prompts = [([10 + 5 * i + j for j in range(4)] * 5)[:18] for i in range(3)] + PROMPTS[:2]
    j_engine = JEngine(J_CFG, j_params, JEngineConfig(overlap=False, spec_k=3, **ec("dense")))
    want = run(j_engine, JRequest, prompts, max_tokens=16)
    engine = Engine(T_CFG, t_params, EngineConfig(overlap=False, spec_k=3, **ec("dense")), device="cpu")
    assert run(engine, Request, prompts, max_tokens=16) == want
    stats = ("spec_proposed", "spec_accepted", "verify_passes")
    assert {k: engine.stats[k] for k in stats} == {k: j_engine.stats[k] for k in stats}
    assert engine.stats["spec_proposed"] > 0


def _lora(seed, rank, targets):
    r = np.random.default_rng(seed)
    shapes = adapters._target_shapes(T_CFG, targets)
    return {name: {"a": (r.standard_normal((T_CFG.n_layers, ind, rank)) / rank).astype(np.float32),
                   "b": (r.standard_normal((T_CFG.n_layers, rank) + out) * 0.2).astype(np.float32)}
            for name, (ind, out) in shapes.items()}


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_attention_tenants_over_moe_base(layout):
    """Two tenants on the attention targets beside base rows, over the MoE
    base: the JAX engine with the JAX store, token for token."""
    j_params, t_params = weights()
    loras = {"t4": (_lora(1, 4, ATTN), 2.0), "t2": (_lora(2, 2, ("wq", "wv")), 1.0)}
    j_store = jadapters.AdapterStore(J_CFG, capacity=2, rank=4, targets=ATTN, dtype=jnp.float32)
    store = adapters.AdapterStore(T_CFG, capacity=2, rank=4, targets=ATTN, device="cpu")
    for aid, (lora, scale) in loras.items():
        j_store.install(aid, lora, scale), store.install(aid, lora, scale)
    tenants = [None, "t4", "t2", "t4", None, "t2"]
    want = run(JEngine(J_CFG, j_params, JEngineConfig(overlap=False, **ec(layout)), adapters=j_store), JRequest,
               tenants=tenants)
    base = run(JEngine(J_CFG, j_params, JEngineConfig(overlap=False, **ec(layout))), JRequest)
    assert [want[i] for i in (1, 2)] != [base[i] for i in (1, 2)]  # the tenants' deltas show
    engine = Engine(T_CFG, t_params, EngineConfig(**ec(layout)), device="cpu", adapters=store)
    assert run(engine, Request, tenants=tenants) == want


def test_expert_targets_refused_as_jax():
    """An adapter on an expert-routed MLP weight is refused by both stores
    with the same message."""
    for name in ("w_gate", "w_up", "w_down"):
        with pytest.raises(ValueError) as j_err:
            jadapters.AdapterStore(J_CFG, capacity=1, rank=2, targets=("wq", name))
        with pytest.raises(ValueError) as t_err:
            adapters.AdapterStore(T_CFG, capacity=1, rank=2, targets=("wq", name), device="cpu")
        assert str(t_err.value) == str(j_err.value) and "expert-routed" in str(t_err.value)


@pytest.mark.parametrize("quantize", ["none", "int8", "int4"])
def test_serve_main_config_tiny_moe(tmp_path, quantize):
    """serve.main --config tiny-moe with quantize: the served weights are
    init_params(seed 0) quantized after the draw, bit for bit (drawn and
    quantized layer by layer), the router and norms dense, and the engine
    serves the tokens of an engine built on those weights."""
    p = tmp_path / "params.json"
    p.write_text(json.dumps({"config": "tiny-moe", "quantize": quantize, "max_batch": 2, "max_seq_len": 64}))
    srv = main.build(["--device", "cpu", "--host", "127.0.0.1", "--port", "0", "--params", str(p)])
    try:
        engine = srv.state.engine
        served = engine.params
        cfg = engine.cfg
        assert cfg.n_experts == 4 and cfg.n_experts_per_token == 2
        want = llama.quantize_weights(llama.init_params(cfg, seed=0, device="cpu"), quantize)
        got_sd, want_sd = served.state_dict(), want.state_dict()
        assert got_sd.keys() == want_sd.keys()
        for name, t in want_sd.items():
            assert (torch.equal(got_sd[name], t) if isinstance(t, torch.Tensor) else got_sd[name] == t), name
        assert served.layers[0].router.dtype == torch.bfloat16
        assert llama.quantized_layout(served) == ({} if quantize == "none" else
                                                  {n: quantize for n in llama.quantized_layout(
                                                      llama.quantize_weights(llama.init_params(
                                                          cfg, seed=1, device="cpu"), quantize))})
        toks = engine.generate([256, 1, 2, 3, 4], max_tokens=6, temperature=0.0)
    finally:
        srv.stop()
    ref = Engine(cfg, want, EngineConfig(max_batch=2, max_seq_len=64), device="cpu")
    ref.start()
    try:
        assert ref.generate([256, 1, 2, 3, 4], max_tokens=6, temperature=0.0) == toks and len(toks) == 6
    finally:
        ref.stop()
