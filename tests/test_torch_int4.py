"""int4 and int8 weights through the port's model and Engine, against the
JAX package on the same quantized weights.

float32 tiny config: JAX quantize4_params (or quantize_params) over
quant_contracting(cfg) goes through bridge.params_from_jax into
Llama(cfg, quantize=...). Logits agree within 1e-5 (another summation
order); a 16-step greedy decode loop is token-exact with the model-dtype
and the int8 cache, through the decode and the fused-decode plain paths;
the port's own quantize_weights of the bridged dense weights gives the
bridged quantized state exactly; and the Engine's greedy tokens for
concurrent prompts, one of them chunked, are those of the JAX
Engine(overlap=False, kv_layout="dense"). On the CPU the int4 projections
run q4_matmul's plain version (the CUDA kernel's twin).
"""
import types
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import greedy_decode

from substratus_tpu.models import llama as jllama
from substratus_tpu.ops.quant import quantize_params as j_quantize_params
from substratus_tpu.ops.quant4 import quantize4_params as j_quantize4_params
from substratus_tpu.serve.engine import Engine as JEngine
from substratus_tpu.serve.engine import EngineConfig as JEngineConfig
from substratus_tpu.serve.engine import Request as JRequest
from substratus_tpu_torch.bridge import params_from_jax
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.ops.decode_attention import pack_fragment
from substratus_tpu_torch.ops.quant import QTensor
from substratus_tpu_torch.ops.quant4 import Q4Tensor
from substratus_tpu_torch.serve.engine import Engine, EngineConfig, Request


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread keeps torch's worker
    pool from spinning on cores that timing-sensitive tests share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


EOS = 257
J_CFG = jllama.CONFIGS["tiny"].replace(vocab_size=258, dtype=jnp.float32)
T_CFG = llama.CONFIGS["tiny"].replace(vocab_size=258, dtype=torch.float32)
J_QUANTIZE = {"int4": j_quantize4_params, "int8": j_quantize_params}


@pytest.fixture(scope="module")
def weights():
    """{"dense" | "int4" | "int8": (JAX tree, port Llama)} on one seed."""
    dense = jllama.init_params(J_CFG, jax.random.key(0))
    out = {}
    for mode in ("dense", "int4", "int8"):
        tree = dense if mode == "dense" else J_QUANTIZE[mode](dense, jllama.quant_contracting(J_CFG))
        model = llama.Llama(T_CFG, device="cpu", quantize="none" if mode == "dense" else mode)
        model.load_state_dict(params_from_jax(jax.device_get(tree)))
        out[mode] = (tree, model)
    return out


@pytest.mark.parametrize("mode", ["int4", "int8"])
def test_forward_logits_match_jax(weights, mode):
    j_params, t_params = weights[mode]
    kind = Q4Tensor if mode == "int4" else QTensor
    assert all(isinstance(getattr(lp, n), kind) for lp in t_params.layers
               for n in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"))
    assert isinstance(t_params.lm_head, kind) and isinstance(t_params.tok_embed, torch.nn.Parameter)
    tokens = np.random.default_rng(0).integers(0, 258, (2, 24)).astype(np.int32)
    want, _ = jllama.forward(j_params, jnp.asarray(tokens), J_CFG)
    got, _ = llama.forward(t_params, torch.from_numpy(tokens), T_CFG)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def _port_greedy(params, cfg, prompt, max_tokens, cache_dtype=None, cache_len=256):
    """The port's prefill + cache seed + decode loop, as greedy_decode runs it."""
    logits, kv = llama.forward(params, torch.tensor([prompt]), cfg)
    cache = llama.init_cache(cfg, 1, cache_len, dtype=cache_dtype, device="cpu")
    for key, value in pack_fragment(cache, kv).items():
        cache[key][:, :, :, : value.shape[3]] = value
    out, pos = [int(logits[0, -1].argmax())], len(prompt)
    while len(out) < max_tokens:
        lg, cache = llama.decode_step(params, cache, torch.tensor([out[-1]]), torch.tensor([pos]), cfg)
        out.append(int(lg[0].argmax()))
        pos += 1
    return out


@pytest.mark.parametrize("mode,kv", [("int4", "model"), ("int4", "int8"), ("int8", "model"), ("int8", "int8")])
def test_greedy_decode_token_exact(weights, mode, kv):
    j_params, t_params = weights[mode]
    prompt = [3, 141, 59, 26, 53, 58, 97, 93, 23]
    module = jllama
    if kv == "int8":
        module = types.SimpleNamespace(forward=jllama.forward, decode_step=jllama.decode_step,
                                       init_cache=partial(jllama.init_cache, dtype=jnp.int8))
    want = greedy_decode(module, j_params, J_CFG, prompt, 16)
    for impl in ("kernel", "fused"):
        got = _port_greedy(t_params, T_CFG.replace(decode_attn_impl=impl), prompt, 16,
                           cache_dtype=torch.int8 if kv == "int8" else None)
        assert got == want, impl


@pytest.mark.parametrize("mode", ["int4", "int8"])
def test_port_quantizes_like_jax(weights, mode):
    """quantize_weights on the bridged dense weights, layer by layer, gives
    the bridged JAX-quantized state exactly (bytes, scales, pack axis and
    group size)."""
    _, dense = weights["dense"]
    model = llama.Llama(T_CFG, device="cpu")
    model.load_state_dict(dense.state_dict())
    assert llama.quantize_weights(model, mode) is model
    want = weights[mode][1].state_dict()
    got = model.state_dict()
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert (got[key] == value) if isinstance(value, dict) else torch.equal(got[key], value), key
    assert llama.quantize_weights(model, mode).state_dict().keys() == want.keys()  # quantized weights pass


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


def test_engine_matches_jax_engine_int4(weights):
    """Three concurrent greedy requests on int4 weights, the 71-token one
    in chunks of 32 (max_prefill_len=32), model-dtype cache."""
    j_params, t_params = weights["int4"]
    r = np.random.default_rng(7)
    prompts = [[256] + r.integers(0, 255, n - 1).tolist() for n in (71, 5, 20)]
    ec = dict(max_batch=4, max_seq_len=128, max_prefill_len=32, eos_token_id=EOS)
    engine = Engine(T_CFG, t_params, EngineConfig(kv_layout="dense", **ec), device="cpu")
    got = _run(engine, Request, prompts)
    want = _run(JEngine(J_CFG, j_params, JEngineConfig(kv_layout="dense", overlap=False, **ec)), JRequest, prompts)
    assert got == want and all(len(t) >= 1 for t in got)
    assert engine.stats["prefill_chunks"] == 3 and engine.stats["prefills"] == 2
