"""The port's OPT and Falcon families (substratus_tpu_torch/models/opt.py,
models/falcon.py) against the JAX package's, with the JAX weights carried
across by bridge.params_from_jax.

float32 tiny configs (tiny-opt: MHA 4/4 with learned positions;
tiny-falcon: MQA 4/1; tiny-falcon-40b-style: GQA 4/2 with separate
LayerNorms): logits within atol/rtol 1e-4 (another summation order
through two layers), prefill fragments and caches within 1e-5, for the
single-shot forward, a batched decode step at rows of different
positions, and a chunk attending a prefilled cache (forward(cache=,
kv_length=)). Also layer_norm and the exact GELU against JAX's (1e-6),
OPT's position rows where JAX's gather clamps, the decode attention's
plain version at query groups of 3, 16 and 71 against the Pallas _kernel
in interpret mode (1e-5, f32 and int8 caches) and the registry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substratus_tpu.models import falcon as jfalcon
from substratus_tpu.models import opt as jopt
from substratus_tpu.ops import basics as jbasics
from substratus_tpu.ops import decode_attention as jdec
from substratus_tpu.ops.kvcache import insert_prefill
from substratus_tpu.ops.quant import quantize_kv as j_quantize_kv
from substratus_tpu_torch.bridge import params_from_jax
from substratus_tpu_torch.models import falcon, opt, registry
from substratus_tpu_torch.ops import basics
from substratus_tpu_torch.ops import decode_attention as tdec
from substratus_tpu_torch.ops.decode_attention import pack_fragment


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread keeps torch's worker
    pool from spinning on cores that timing-sensitive tests share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NAMES = ("tiny-opt", "tiny-falcon", "tiny-falcon-40b-style")
J_MODULES = {"tiny-opt": jopt, "tiny-falcon": jfalcon, "tiny-falcon-40b-style": jfalcon}
_WEIGHTS = {}


def weights(name):
    """(jax module, jax cfg, jax params, port module, port cfg, port params)
    of a tiny config in float32, seed 0 (built once per name)."""
    if name not in _WEIGHTS:
        jmod = J_MODULES[name]
        jcfg = jmod.CONFIGS[name].replace(dtype=jnp.float32)
        tmod, tcfg = registry.find_named_config(name)
        tcfg = tcfg.replace(dtype=torch.float32)
        j_params = jmod.init_params(jcfg, jax.random.key(0))
        t_params = registry.MODEL_CLASSES[registry.family_of(tcfg)](tcfg, device="cpu")
        t_params.load_state_dict(params_from_jax(jax.device_get(j_params)))
        _WEIGHTS[name] = (jmod, jcfg, j_params, tmod, tcfg, t_params)
    return _WEIGHTS[name]


def test_layer_norm_and_gelu_match_jax():
    r = np.random.default_rng(0)
    x = (r.standard_normal((2, 5, 64)) * 3 + 1).astype(np.float32)
    scale, bias = r.standard_normal(64).astype(np.float32), r.standard_normal(64).astype(np.float32)
    want = jbasics.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 1e-5)
    got = basics.layer_norm(*map(torch.from_numpy, (x, scale, bias)), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # bf16 in, f32 accumulation, bf16 out, as JAX rounds it
    xb = jnp.asarray(x, jnp.bfloat16)
    got_b = basics.layer_norm(torch.from_numpy(np.asarray(xb, np.float32)).bfloat16(), *map(torch.from_numpy,
                                                                                           (scale, bias)))
    assert got_b.dtype == torch.bfloat16
    np.testing.assert_allclose(got_b.float().numpy(),
                               np.asarray(jbasics.layer_norm(xb, jnp.asarray(scale), jnp.asarray(bias)), np.float32),
                               atol=2**-6, rtol=2**-7)
    g = (r.standard_normal((4, 100)) * 4).astype(np.float32)
    np.testing.assert_allclose(basics.gelu(torch.from_numpy(g)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(g), approximate=False)), atol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(name):
    jmod, jcfg, j_params, tmod, tcfg, t_params = weights(name)
    tokens = np.random.default_rng(1).integers(0, 256, (2, 24)).astype(np.int32)
    want, j_kv = jmod.forward(j_params, jnp.asarray(tokens), jcfg)
    got, t_kv = tmod.forward(t_params, torch.from_numpy(tokens), tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 24, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    for key in ("k", "v"):  # the prefill fragment [L, B, S, KH, hd]
        assert t_kv[key].shape == (tcfg.n_layers, 2, 24, tcfg.n_kv_heads, tcfg.head_size)
        np.testing.assert_allclose(t_kv[key].numpy(), np.asarray(j_kv[key]), atol=1e-5)


def _prefilled(name, prompt, cache_len):
    """The same prompt prefilled into a JAX and a port dense cache."""
    jmod, jcfg, j_params, tmod, tcfg, t_params = weights(name)
    _, j_kv = jmod.forward(j_params, jnp.asarray(prompt), jcfg)
    _, t_kv = tmod.forward(t_params, torch.from_numpy(prompt), tcfg)
    b, s = prompt.shape
    j_cache = insert_prefill(jmod.init_cache(jcfg, b, cache_len), j_kv)
    t_cache = tmod.init_cache(tcfg, b, cache_len, device="cpu")
    for key, value in pack_fragment(t_cache, t_kv).items():
        t_cache[key][:, :, :, :s] = value
    return j_cache, t_cache


@pytest.mark.parametrize("name", NAMES)
def test_decode_step_matches_jax(name):
    """One batched decode step over a prefilled cache, rows at different
    positions (one past the cache, as an idle engine slot drifts)."""
    jmod, jcfg, j_params, tmod, tcfg, t_params = weights(name)
    r = np.random.default_rng(2)
    j_cache, t_cache = _prefilled(name, r.integers(0, 256, (3, 16)).astype(np.int32), 32)
    tok = r.integers(0, 256, (3,)).astype(np.int32)
    pos = np.array([16, 9, 40], np.int32)
    want, j_cache = jmod.decode_step(j_params, j_cache, jnp.asarray(tok), jnp.asarray(pos), jcfg)
    got, t_cache = tmod.decode_step(t_params, t_cache, torch.from_numpy(tok), torch.from_numpy(pos), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    for key in ("k", "v"):
        np.testing.assert_allclose(t_cache[key].numpy(), np.asarray(j_cache[key]), atol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_chunked_forward_matches_jax(name):
    """A 12-token chunk at positions 16..27 over a cache prefilled with 16
    tokens (the engine's chunked prefill), and the same chunk with a
    kv_length limit on the second row."""
    jmod, jcfg, j_params, tmod, tcfg, t_params = weights(name)
    r = np.random.default_rng(3)
    chunk = r.integers(0, 256, (2, 12)).astype(np.int32)
    positions = np.broadcast_to(np.arange(16, 28, dtype=np.int32), (2, 12))
    for kv_length in (None, np.array([28, 20], np.int32)):
        j_cache, t_cache = _prefilled(name, r.integers(0, 256, (2, 16)).astype(np.int32), 48)
        want, j_cache = jmod.forward(j_params, jnp.asarray(chunk), jcfg, positions=jnp.asarray(positions),
                                     cache=j_cache, kv_length=None if kv_length is None else jnp.asarray(kv_length))
        got, t_cache = tmod.forward(t_params, torch.from_numpy(chunk), tcfg,
                                    positions=torch.from_numpy(np.array(positions)), cache=t_cache,
                                    kv_length=None if kv_length is None else torch.from_numpy(kv_length))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(t_cache["k"].numpy(), np.asarray(j_cache["k"]), atol=1e-5)


def test_opt_positions_read_what_jax_reads():
    """pos_embed rows for positions past the table (an idle slot's drift)
    and before it (wrapping from the end), as JAX's gather reads them; and
    a decode step at such positions equals JAX's."""
    table = np.arange(130 * 3, dtype=np.float32).reshape(130, 3)
    positions = np.array([[0, 5, 127, 128, 500, -1, -2, -3, -200]], np.int32)
    want = np.asarray(jnp.asarray(table)[jnp.asarray(positions) + jopt.POS_OFFSET])
    rows = opt.position_rows(torch.from_numpy(positions), 130)
    np.testing.assert_array_equal(torch.from_numpy(table)[rows].numpy(), want)
    jmod, jcfg, j_params, tmod, tcfg, t_params = weights("tiny-opt")
    j_cache, t_cache = _prefilled("tiny-opt", np.full((2, 8), 7, np.int32), 160)
    tok, pos = np.array([3, 4], np.int32), np.array([150, 700], np.int32)  # past max_seq_len + 2 = 130 rows
    want, _ = jmod.decode_step(j_params, j_cache, jnp.asarray(tok), jnp.asarray(pos), jcfg)
    got, _ = tmod.decode_step(t_params, t_cache, torch.from_numpy(tok), torch.from_numpy(pos), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("h,kh", [(12, 4), (16, 1), (71, 1)], ids=["g3", "g16", "g71"])
def test_decode_plain_any_group_matches_jax(h, kh):
    """The decode kernel's plain twin at groups of 3, 16 (falcon-40b) and
    71 (falcon-7b), f32 and int8 caches, against the Pallas kernel run in
    interpret mode and the XLA path."""
    r = np.random.default_rng(h)
    b, s, d = 2, 32, 16
    q = r.standard_normal((b, 1, h, d)).astype(np.float32)
    k = r.standard_normal((b, kh, s, d)).astype(np.float32)
    v = r.standard_normal((b, kh, s, d)).astype(np.float32)
    pos = np.array([5, s - 1], np.int32)
    kq, ks = (np.asarray(x) for x in j_quantize_kv(jnp.asarray(k)))
    vq, vs = (np.asarray(x) for x in j_quantize_kv(jnp.asarray(v)))
    for args in ((q, k, v, pos), (q, kq, vq, pos, ks[..., 0], vs[..., 0])):
        got = tdec.decode_attention(*(torch.from_numpy(np.array(a)) for a in args)).numpy()
        for impl, extra in (("pallas", {"interpret": True, "block_s": 16}), ("xla", {})):
            want = jdec.decode_attention(*map(jnp.asarray, args), impl=impl, **extra)
            np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, err_msg=f"{impl} {len(args)}")


def test_registry_and_bridge():
    """Every family through the registry, and each tree's state dict loads
    strictly into its module (bf16 leaves exact)."""
    assert sorted(registry.FAMILIES) == ["falcon", "llama", "opt"]
    for name, family in (("opt-125m", "opt"), ("falcon-7b", "falcon"), ("llama2-7b", "llama")):
        module, cfg = registry.find_named_config(name)
        assert registry.family_of(cfg) == family and registry.module_of(cfg) is module
        assert registry.module_for(family) is module and isinstance(cfg, registry.config_class(family))
    assert registry.HF_MODEL_TYPES["falcon"] == "falcon" and registry.HF_MODEL_TYPES["opt"] == "opt"
    falcon7b = falcon.CONFIGS["falcon-7b"]
    assert (falcon7b.n_heads // falcon7b.n_kv_heads, falcon7b.head_size) == (71, 64)
    with pytest.raises(KeyError):
        registry.find_named_config("gpt-2")
    for name, jmod in (("tiny-opt", jopt), ("tiny-falcon-40b-style", jfalcon)):
        tree = jax.device_get(jmod.init_params(jmod.CONFIGS[name], jax.random.key(1)))
        state = params_from_jax(tree)
        module, cfg = registry.find_named_config(name)
        model = registry.MODEL_CLASSES[registry.family_of(cfg)](cfg, device="cpu")
        model.load_state_dict(state)  # strict: every key matched
        assert model.layers[1].wq.dtype == torch.bfloat16
        np.testing.assert_array_equal(model.layers[1].wk.float().numpy(),
                                      np.asarray(tree["layers"]["wk"][1], np.float32))
