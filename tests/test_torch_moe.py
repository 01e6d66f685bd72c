"""The port's mixture of experts (substratus_tpu_torch/models/llama.py's
_moe_ffn and the forward around it) against the JAX package's, on
tiny-moe in float32, the JAX weights carried across by
bridge.params_from_jax and the inputs drawn from a numpy seed.

Held: the routed FFN in both branches (exact dropless top-k; GShard
capacity dispatch, also at a capacity that drops pairs) within atol 1e-5
and its load-balancing aux within 1e-6; forward's logits within 1e-5 and
moe_aux [L]; a prefill then cached decode steps against the full forward;
int8 and int4 expert weights (quantize4's bytes identical, the per-expert
plain route of q4einsum against JAX's dequantized einsum within 1e-4, the
int8 scale commuted past each expert's product); the draw that quantizes
layer by layer against the dense draw quantized after, bit for bit; a
planted tie in the router taking the lower expert first, as lax.top_k.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substratus_tpu.models import llama as jllama
from substratus_tpu.ops import quant as jquant
from substratus_tpu.ops import quant4 as jquant4
from substratus_tpu_torch.bridge import params_from_jax
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.ops import quant4
from substratus_tpu_torch.ops.quant import qeinsum


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


J_CFG = jllama.CONFIGS["tiny-moe"].replace(dtype=jnp.float32)
T_CFG = llama.CONFIGS["tiny-moe"].replace(dtype=torch.float32)
RNG = np.random.default_rng(5)
TOKENS = RNG.integers(0, 256, (2, 16))
H = RNG.standard_normal((2, 16, 64)).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    j_params = jllama.init_params(J_CFG, jax.random.key(0))
    t_params = llama.Llama(T_CFG, device="cpu")
    t_params.load_state_dict(params_from_jax(jax.device_get(j_params)))
    return j_params, t_params


def _jlayer(j_params, i):
    return jax.tree.map(lambda a: a[i], j_params["layers"])


def test_config_fields_match_jax():
    """The MoE fields and their defaults are the JAX package's, on every
    named config; the expert weights' layout follows them."""
    for name, jcfg in jllama.CONFIGS.items():
        tcfg = llama.CONFIGS[name]
        assert (tcfg.n_experts, tcfg.n_experts_per_token, tcfg.capacity_factor, tcfg.router_aux_weight) == (
            jcfg.n_experts, jcfg.n_experts_per_token, jcfg.capacity_factor, jcfg.router_aux_weight), name
    block = llama.LlamaBlock(T_CFG, torch.device("cpu"))
    assert tuple(block.router.shape) == (64, 4) and tuple(block.w_gate.shape) == (4, 64, 128)
    assert tuple(block.w_down.shape) == (4, 128, 64)
    assert llama.quant_contracting(T_CFG)["layers"] == jllama.quant_contracting(J_CFG)["layers"]


@pytest.mark.parametrize("train,capacity_factor", [(False, 1.25), (True, 1.25), (True, 0.3)])
def test_moe_ffn_matches_jax(weights, train, capacity_factor):
    """Both branches of the routed FFN and the aux, per layer; at capacity
    factor 0.3 the dispatch drops pairs (the output departs from the
    dropless mix) and the port drops the same ones."""
    j_params, t_params = weights
    jcfg, tcfg = J_CFG.replace(capacity_factor=capacity_factor), T_CFG.replace(capacity_factor=capacity_factor)
    for i in range(T_CFG.n_layers):
        jy, jaux = jllama._moe_ffn(jnp.asarray(H), _jlayer(j_params, i), jcfg, train)
        ty, taux = llama._moe_ffn(torch.from_numpy(H), t_params.layers[i], tcfg, train)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=0)
        np.testing.assert_allclose(float(taux), float(jaux), atol=1e-6, rtol=0)
        if capacity_factor < 1:
            exact, _ = llama._moe_ffn(torch.from_numpy(H), t_params.layers[i], tcfg, False)
            assert (ty - exact).abs().amax() > 1e-2  # pairs were dropped


@pytest.mark.parametrize("train", [False, True])
def test_forward_logits_and_aux_match_jax(weights, train):
    """forward's logits within 1e-5 and moe_aux [L] within 1e-6 (a training
    forward returns the aux and no cache fragment)."""
    j_params, t_params = weights
    jlog, jkv = jllama.forward(j_params, jnp.asarray(TOKENS), J_CFG, train=train)
    tlog, tkv = llama.forward(t_params, torch.from_numpy(TOKENS), T_CFG, train=train)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5, rtol=0)
    assert tkv["moe_aux"].shape == (T_CFG.n_layers,)
    np.testing.assert_allclose(tkv["moe_aux"].numpy(), np.asarray(jkv["moe_aux"]), atol=1e-6, rtol=0)
    assert sorted(tkv) == (["moe_aux"] if train else ["k", "moe_aux", "v"])
    _, tkv_remat = llama.forward(t_params, torch.from_numpy(TOKENS), T_CFG, train=train, remat=True)
    assert torch.equal(tkv_remat["moe_aux"], tkv["moe_aux"])  # carried through the recompute's checkpoint


def test_prefill_then_cached_decode(weights):
    """A 10-token prefill inserted into the dense cache, then 6 cached
    decode steps: each step's logits those of the JAX full forward at its
    position (the dropless mix makes prefill and decode agree)."""
    from substratus_tpu_torch.ops.decode_attention import pack_fragment

    j_params, t_params = weights
    full, _ = jllama.forward(j_params, jnp.asarray(TOKENS), J_CFG)
    tokens = torch.from_numpy(TOKENS)
    _, kv = llama.forward(t_params, tokens[:, :10], T_CFG)
    cache = llama.init_cache(T_CFG, 2, 32, device="cpu")
    for name, value in pack_fragment(cache, kv).items():
        cache[name][:, :, :, :10].copy_(value)
    for pos in range(10, 16):
        step, cache = llama.decode_step(t_params, cache, tokens[:, pos], torch.full((2,), pos), T_CFG)
        np.testing.assert_allclose(step.numpy(), np.asarray(full[:, pos]), atol=1e-5, rtol=0)


def test_int4_expert_bytes_and_route_match_jax(weights):
    """quantize4 of the expert weights gives JAX's bytes; q4einsum takes
    each expert einsum (both branches' equations) one expert at a time
    through the plain version of the int4 matmul, within 1e-4 of JAX's
    dequantized einsum; the forward on int4 weights within 1e-4 of JAX's."""
    j_params, _ = weights
    jq = jquant4.quantize4_params(j_params, jllama.quant_contracting(J_CFG))
    tq = llama.quantize_weights(llama.init_params(T_CFG, device="cpu"), "int4")
    tq.load_state_dict(params_from_jax(jax.device_get(jq)))
    t4 = llama.quantize_weights(llama.Llama(T_CFG, device="cpu"), "none")
    t4.load_state_dict(params_from_jax(jax.device_get(j_params)))
    llama.quantize_weights(t4, "int4")
    for name in ("w_gate", "w_up", "w_down"):
        w = t4.layers[1].__getattr__(name)
        assert torch.equal(w.packed, torch.from_numpy(np.array(jq["layers"][name].packed[1])))
        assert torch.equal(w.scale, torch.from_numpy(np.array(jq["layers"][name].scale[1])))
    r = np.random.default_rng(9)
    cases = (("bsd,edm->bsem", (2, 5, 64), "w_gate"), ("bsem,emd->bsed", (2, 5, 4, 128), "w_down"),
             ("ebcd,edm->ebcm", (4, 2, 3, 64), "w_up"), ("ebcm,emd->ebcd", (4, 2, 3, 128), "w_down"))
    launches = quant4.q4_matmul.launches
    for eq, shape, name in cases:
        x = r.standard_normal(shape).astype(np.float32)
        want = jquant4.q4einsum(eq, jnp.asarray(x), jax.tree.map(lambda a: a[0], jq["layers"][name]), jnp.float32)
        got = quant4.q4einsum(eq, torch.from_numpy(x), getattr(tq.layers[0], name), torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
        assert quant4._expert_split(eq, 1) is not None and not quant4._contracted_count(eq, 1)
    assert quant4.q4_matmul.launches == launches  # CPU tensors: the plain version, no launch
    jlog, _ = jllama.forward(jq, jnp.asarray(TOKENS), J_CFG)
    tlog, _ = llama.forward(tq, torch.from_numpy(TOKENS), T_CFG)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4, rtol=0)


def test_int8_experts_match_jax(weights):
    """int8 expert weights: the port's quantize gives JAX's values and
    per-output-channel scales [E, 1, M]; qeinsum commutes the scale past
    each expert's product and the forward lands within 1e-4 of JAX's."""
    j_params, _ = weights
    jq = jquant.quantize_params(j_params, jllama.quant_contracting(J_CFG))
    tq = llama.Llama(T_CFG, device="cpu")
    tq.load_state_dict(params_from_jax(jax.device_get(j_params)))
    llama.quantize_weights(tq, "int8")
    w = tq.layers[0].w_gate
    assert tuple(w.scale.shape) == (4, 1, 128)
    assert torch.equal(w.q, torch.from_numpy(np.array(jq["layers"]["w_gate"].q[0])))
    np.testing.assert_array_equal(w.scale.numpy(), np.asarray(jq["layers"]["w_gate"].scale[0]))
    x = torch.from_numpy(H[:, :5])
    want = jquant.qeinsum("bsd,edm->bsem", jnp.asarray(H[:, :5]), jax.tree.map(lambda a: a[0], jq["layers"]["w_gate"]),
                          jnp.float32)
    np.testing.assert_allclose(qeinsum("bsd,edm->bsem", x, w, torch.float32).numpy(), np.asarray(want), atol=1e-5)
    jlog, _ = jllama.forward(jq, jnp.asarray(TOKENS), J_CFG)
    tlog, _ = llama.forward(tq, torch.from_numpy(TOKENS), T_CFG)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4, rtol=0)


@pytest.mark.parametrize("quantize", ["int8", "int4"])
def test_layerwise_draw_equals_dense_then_quantize(quantize):
    """init_params(quantize=...) draws and quantizes layer by layer: every
    tensor bit for bit init_params then quantize_weights, in bf16 (the
    served dtype), with the router and the norms dense."""
    cfg = llama.CONFIGS["tiny-moe"]
    want = llama.quantize_weights(llama.init_params(cfg, seed=4, device="cpu"), quantize).state_dict()
    got_model = llama.init_params(cfg, seed=4, device="cpu", quantize=quantize)
    got = got_model.state_dict()
    assert got.keys() == want.keys()
    for name, t in want.items():
        assert (torch.equal(got[name], t) if isinstance(t, torch.Tensor) else got[name] == t), name
    assert got_model.layers[1].router.dtype == torch.bfloat16
    assert set(llama.quantized_layout(got_model)) == {f"layers.{i}.{n}" for i in range(2) for n in (
        "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")} | {"lm_head"}


def test_planted_router_tie_takes_the_lower_expert():
    """Router columns 1 and 3 equal, 2 a little below: every token's two
    choices are experts 1 and 3, in that order, as lax.top_k orders a tie;
    the renormalised weights, the aux and the mixed output are JAX's."""
    j_params = jllama.init_params(J_CFG, jax.random.key(0))
    router = np.asarray(j_params["layers"]["router"]).copy()
    router[:, :, 3] = router[:, :, 1]
    router[:, :, 2] = router[:, :, 1] - 0.5
    router[:, :, 0] = router[:, :, 1] - 1.0
    j_params["layers"]["router"] = jnp.asarray(router)
    t_layer = llama.Llama(T_CFG, device="cpu")
    t_layer.load_state_dict(params_from_jax(jax.device_get(j_params)))
    h = np.abs(H)  # positive inputs keep the planted order for every token
    _, top_w, top_idx = llama.route(torch.from_numpy(h), t_layer.layers[0].router, 2)
    jprobs = jax.nn.softmax(jnp.asarray(h) @ jnp.asarray(router[0]), axis=-1)
    jw, jidx = jax.lax.top_k(jprobs, 2)
    assert torch.equal(top_idx, torch.from_numpy(np.asarray(jidx)).long())
    assert (top_idx[..., 0] == 1).all() and (top_idx[..., 1] == 3).all()
    np.testing.assert_allclose(top_w.numpy(), np.asarray(jw / jw.sum(-1, keepdims=True)), atol=1e-7)
    for train in (False, True):
        jy, jaux = jllama._moe_ffn(jnp.asarray(h), _jlayer(j_params, 0), J_CFG, train)
        ty, taux = llama._moe_ffn(torch.from_numpy(h), t_layer.layers[0], T_CFG, train)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=0)
        np.testing.assert_allclose(float(taux), float(jaux), atol=1e-6)
