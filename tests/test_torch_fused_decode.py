"""The port's fused cache write + decode attention (substratus_tpu_torch/
ops/fused_decode.py) against the JAX package's fused_decode_attention,
run in Pallas interpret mode (block_s=32), as its own tests run it.

On the CPU the wrapper runs its plain version, which follows the Pallas
_kernel: the fresh row is written at pos, the history is masked strictly
below pos, and the current token's term comes from the operands. float32
and int8 caches, MQA (KH=1) and KH=2 of 4 heads; positions 0 (no
history), mid-cache and S-1, plus drifted positions past the cache that
clamp onto S-1 in row and scale alike. Attention within 1e-5 (another
summation order), the written caches bit for bit. Through the model, a
16-step greedy decode_step loop with decode_attn_impl="fused" is
token-exact against JAX's, logits within 1e-5. The CUDA kernel itself is
held against the plain version in tests/test_torch_kernels_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substratus_tpu.models import llama as jllama
from substratus_tpu.ops import decode_attention as jdec
from substratus_tpu.ops.fused_decode import fused_decode_attention as j_fused
from substratus_tpu.ops.kvcache import insert_prefill
from substratus_tpu.ops.quant import quantize_kv as j_quantize_kv
from substratus_tpu_torch.bridge import params_from_jax
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.ops import decode_attention as tdec
from substratus_tpu_torch.ops.decode_attention import pack_fragment
from substratus_tpu_torch.ops.fused_decode import fused_decode_attention


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread keeps torch's worker
    pool from spinning on cores that timing-sensitive tests share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, H, S, D = 3, 4, 64, 16


def _q8(x):
    kq, ks = (np.array(a) for a in j_quantize_kv(jnp.asarray(x)))
    return kq, ks[..., 0]


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _operands(kh, quantized, positions, seed):
    """(q, new_k, new_v, cache_k, cache_v, positions[, new_ks, new_vs,
    cache_ks, cache_vs]) with the fresh scales already scattered at the
    clamped positions, as the caller (update_cache_and_attend) leaves them."""
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, 1, H, D)).astype(np.float32)
    nk, nv = (r.standard_normal((B, kh, 1, D)).astype(np.float32) for _ in range(2))
    ck, cv = (r.standard_normal((B, kh, S, D)).astype(np.float32) for _ in range(2))
    pos = np.array(positions, np.int32)
    if not quantized:
        return (q, nk, nv, ck, cv, pos)
    (nk, nks), (nv, nvs), (ck, cks), (cv, cvs) = map(_q8, (nk, nv, ck, cv))
    clamped = np.minimum(pos, S - 1)
    for b in range(B):
        cks[b, :, clamped[b]] = nks[b, :, 0]
        cvs[b, :, clamped[b]] = nvs[b, :, 0]
    return (q, nk, nv, ck, cv, pos, nks, nvs, cks, cvs)


@pytest.mark.parametrize("positions", [[0, 30, S - 1], [5, S + 17, 10 * S]], ids=["in-range", "drifted"])
@pytest.mark.parametrize("kh", [1, 2])
@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_fused_matches_jax_and_writes_the_row(positions, kh, quantized):
    args = _operands(kh, quantized, positions, seed=kh + len(positions))
    t_args = list(map(_t, args))
    got, ck, cv = fused_decode_attention(*t_args)
    assert ck is t_args[3] and cv is t_args[4]  # written in place
    want, jck, jcv = j_fused(*map(_j, args), block_s=32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(ck.numpy(), np.asarray(jck))
    np.testing.assert_array_equal(cv.numpy(), np.asarray(jcv))
    clamped = np.minimum(positions, S - 1)
    for b in range(B):  # the fresh row, at pos or clamped onto S-1
        np.testing.assert_array_equal(ck[b, :, clamped[b]].numpy(), args[1][b, :, 0])


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_update_cache_and_attend_fused_matches_jax(quantized):
    """impl="fused" through update_cache_and_attend: a drifted position
    lands on S-1 in the row and in its scale, exactly as JAX's does, and
    gives exactly the state of a position clamped to S-1."""
    kh = 2
    r = np.random.default_rng(11)
    q = r.standard_normal((2, 1, H, D)).astype(np.float32)
    kk, vv = (r.standard_normal((2, 1, kh, D)).astype(np.float32) for _ in range(2))
    k = r.standard_normal((2, kh, S, D)).astype(np.float32)
    cache = {"k": k, "v": np.zeros_like(k)}
    if quantized:
        cache["k"], cache["k_scale"] = _q8(k)
        cache["v"] = np.zeros(k.shape, np.int8)
        cache["v_scale"] = np.ones(k.shape[:3], np.float32)
    drifted = np.array([[5], [S + 33]], np.int32)
    outs = []
    for pos in (drifted, np.minimum(drifted, S - 1)):
        t_cache = {n: _t(x.copy()) for n, x in cache.items()}
        got, t_out = tdec.update_cache_and_attend(t_cache, _t(q), _t(kk), _t(vv), _t(pos), impl="fused")
        assert t_out is t_cache
        want, j_out = jdec.update_cache_and_attend(
            {n: _j(x) for n, x in cache.items()}, _j(q), _j(kk), _j(vv), _j(pos), impl="fused")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        for name in cache:
            np.testing.assert_array_equal(t_out[name].numpy(), np.asarray(j_out[name]), err_msg=name)
        outs.append((got, t_out))
    assert torch.equal(outs[0][0], outs[1][0])
    for name in cache:
        assert torch.equal(outs[0][1][name], outs[1][1][name])


J_CFG = jllama.CONFIGS["tiny"].replace(dtype=jnp.float32, decode_attn_impl="fused")
T_CFG = llama.CONFIGS["tiny"].replace(dtype=torch.float32, decode_attn_impl="fused")


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_fused_decode_loop_matches_jax(kv):
    """Prefill, seed the cache, then 16 greedy decode_step calls through
    the fused path in both packages: tokens exact, logits within 1e-5."""
    j_params = jllama.init_params(J_CFG, jax.random.key(0))
    t_params = llama.Llama(T_CFG, device="cpu")
    t_params.load_state_dict(params_from_jax(jax.device_get(j_params)))
    prompt = [3, 141, 59, 26, 53, 58, 97, 93, 23]
    cache_dtype = (jnp.int8, torch.int8) if kv == "int8" else (None, None)
    j_logits, j_kv = jllama.forward(j_params, jnp.asarray([prompt], jnp.int32), J_CFG)
    j_cache = insert_prefill(jllama.init_cache(J_CFG, 1, 32, dtype=cache_dtype[0]), j_kv, len(prompt))
    t_logits, t_kv = llama.forward(t_params, torch.tensor([prompt]), T_CFG)
    t_cache = llama.init_cache(T_CFG, 1, 32, dtype=cache_dtype[1], device="cpu")
    for key, value in pack_fragment(t_cache, t_kv).items():
        t_cache[key][:, :, :, : value.shape[3]] = value
    tok = int(j_logits[0, -1].argmax())
    assert tok == int(t_logits[0, -1].argmax())
    for pos in range(len(prompt), len(prompt) + 16):
        want, j_cache = jllama.decode_step(
            j_params, j_cache, jnp.asarray([tok], jnp.int32), jnp.asarray([pos], jnp.int32), J_CFG)
        got, t_cache = llama.decode_step(t_params, t_cache, torch.tensor([tok]), torch.tensor([pos]), T_CFG)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, err_msg=f"pos {pos}")
        tok = int(np.asarray(want)[0].argmax())
        assert int(got[0].argmax()) == tok, pos
