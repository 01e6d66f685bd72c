"""The port's llama model (substratus_tpu_torch/models/llama.py) against the
JAX package's, with the JAX weights carried across by bridge.params_from_jax.

float32 tiny config (GQA 4/2): logits agree within atol/rtol 1e-4 (another
summation order through two layers), and a 16-token greedy decode loop is
token-exact against tests/conftest.py::greedy_decode, with the model-dtype
and the int8 cache.
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
from substratus_tpu.ops.kvcache import insert_prefill
from substratus_tpu_torch.bridge import params_from_jax
from substratus_tpu_torch.models import llama, registry
from substratus_tpu_torch.ops.decode_attention import pack_fragment


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread keeps torch's worker
    pool from spinning on cores that timing-sensitive tests share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


J_CFG = jllama.CONFIGS["tiny"].replace(dtype=jnp.float32)
T_CFG = llama.CONFIGS["tiny"].replace(dtype=torch.float32)


@pytest.fixture(scope="module")
def weights():
    j_params = jllama.init_params(J_CFG, jax.random.key(0))
    t_params = llama.Llama(T_CFG, device="cpu")
    t_params.load_state_dict(params_from_jax(jax.device_get(j_params)))
    return j_params, t_params


def test_bridge_splits_layers_and_converts_bf16():
    cfg = jllama.CONFIGS["tiny"]  # bf16 leaves
    tree = jax.device_get(jllama.init_params(cfg, jax.random.key(1)))
    state = params_from_jax(tree)
    assert state["layers.1.wq"].shape == (64, 4, 16)
    assert state["layers.0.wo"].dtype == torch.float32
    np.testing.assert_array_equal(state["layers.1.w_up"].numpy(),
                                  np.asarray(tree["layers"]["w_up"][1], np.float32))
    model = llama.Llama(llama.CONFIGS["tiny"], device="cpu")
    model.load_state_dict(state)  # every key matched, bf16 values exact
    assert model.layers[1].wq.dtype == torch.bfloat16


def test_forward_logits_match_jax(weights):
    j_params, t_params = weights
    tokens = np.random.default_rng(0).integers(0, 256, (2, 24)).astype(np.int32)
    want, j_kv = jllama.forward(j_params, jnp.asarray(tokens), J_CFG)
    got, t_kv = llama.forward(t_params, torch.from_numpy(tokens), T_CFG)
    assert got.dtype == torch.float32 and got.shape == (2, 24, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    for name in ("k", "v"):  # the prefill fragment [L, B, S, KH, hd]
        np.testing.assert_allclose(t_kv[name].numpy(), np.asarray(j_kv[name]), atol=1e-5)
    plain, _ = llama.forward(t_params, torch.from_numpy(tokens), T_CFG.replace(attn_impl="plain"))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5)


def _port_greedy(params, cfg, prompt, max_tokens, cache_len=256, cache_dtype=None):
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


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_greedy_decode_token_exact(weights, kv):
    j_params, t_params = weights
    prompt = [3, 141, 59, 26, 53, 58, 97, 93, 23]
    module = jllama
    if kv == "int8":
        module = types.SimpleNamespace(
            forward=jllama.forward, decode_step=jllama.decode_step,
            init_cache=partial(jllama.init_cache, dtype=jnp.int8))
    want = greedy_decode(module, j_params, J_CFG, prompt, 16)
    got = _port_greedy(t_params, T_CFG, prompt, 16, cache_dtype=torch.int8 if kv == "int8" else None)
    assert got == want


def test_decode_step_logits_match_jax(weights):
    """One batched decode step over a prefilled cache, rows at different
    positions, against the JAX decode_step."""
    j_params, t_params = weights
    r = np.random.default_rng(1)
    prompt = r.integers(0, 256, (2, 16)).astype(np.int32)
    _, j_kv = jllama.forward(j_params, jnp.asarray(prompt), J_CFG)
    _, t_kv = llama.forward(t_params, torch.from_numpy(prompt), T_CFG)
    j_cache = insert_prefill(jllama.init_cache(J_CFG, 2, 32), j_kv)
    t_cache = llama.init_cache(T_CFG, 2, 32, device="cpu")
    for key, value in pack_fragment(t_cache, t_kv).items():
        t_cache[key][:, :, :, :16] = value
    tok = r.integers(0, 256, (2,)).astype(np.int32)
    pos = np.array([16, 9], np.int32)
    want, j_cache = jllama.decode_step(j_params, j_cache, jnp.asarray(tok), jnp.asarray(pos), J_CFG)
    got, t_cache = llama.decode_step(t_params, t_cache, torch.from_numpy(tok), torch.from_numpy(pos), T_CFG)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(t_cache["k"].numpy(), np.asarray(j_cache["k"]), atol=1e-5)


def test_init_params_is_seeded_and_scaled():
    a = llama.init_params(T_CFG, seed=3, device="cpu")
    b = llama.init_params(T_CFG, seed=3, device="cpu")
    assert torch.equal(a.layers[1].w_down, b.layers[1].w_down)
    w = a.layers[0].w_gate  # fan_in = dim; truncated normal in [-2, 2] has std 0.88
    assert abs(w.std().item() * T_CFG.dim**0.5 - 0.88) < 0.05
    assert w.abs().max().item() <= 2 * T_CFG.dim**-0.5 + 1e-6
    assert torch.all(a.layers[0].attn_norm == 1)


def test_registry_and_unported_configs():
    family, cfg = registry.find_named_config("llama2-7b")
    assert family is llama and registry.module_of(cfg) is llama
    assert (cfg.dim, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.vocab_size) == (4096, 32, 32, 32, 32000)
    for name, jcfg in jllama.CONFIGS.items():  # same shapes as the JAX package
        tcfg = llama.CONFIGS[name]
        assert (tcfg.dim, tcfg.n_layers, tcfg.n_heads, tcfg.n_kv_heads, tcfg.hidden_dim, tcfg.vocab_size,
                tcfg.rope_theta, tcfg.n_experts) == (jcfg.dim, jcfg.n_layers, jcfg.n_heads, jcfg.n_kv_heads,
                                                     jcfg.hidden_dim, jcfg.vocab_size, jcfg.rope_theta,
                                                     jcfg.n_experts)
    with pytest.raises(KeyError):
        registry.find_named_config("no-such-model")
    for name in ("tiny-moe", "mixtral-8x7b"):  # the mixture-of-experts fields too, now the port runs them
        tcfg, jcfg = llama.CONFIGS[name], jllama.CONFIGS[name]
        assert (tcfg.n_experts, tcfg.n_experts_per_token, tcfg.capacity_factor, tcfg.router_aux_weight) == (
            jcfg.n_experts, jcfg.n_experts_per_token, jcfg.capacity_factor, jcfg.router_aux_weight)
    moe = llama.init_params(llama.CONFIGS["tiny-moe"], device="cpu")
    assert tuple(moe.layers[0].w_gate.shape) == (4, 64, 128) and tuple(moe.layers[0].router.shape) == (64, 4)
