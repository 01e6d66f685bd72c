"""The port's base ops (substratus_tpu_torch/ops/{basics,attention,quant,
sampling}.py) against the JAX package's, on the same numpy inputs.

float32 throughout: the point is the algorithm, so tolerances only cover
a different summation order (1e-5 / 1e-6); int8 quantization and greedy
sampling are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substratus_tpu.ops import attention as jattn
from substratus_tpu.ops import basics as jbasics
from substratus_tpu.ops import quant as jquant
from substratus_tpu.ops import sampling as jsampling
from substratus_tpu_torch.ops import attention as tattn
from substratus_tpu_torch.ops import basics as tbasics
from substratus_tpu_torch.ops import quant as tquant
from substratus_tpu_torch.ops import sampling as tsampling


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread keeps torch's worker
    pool from spinning on cores that timing-sensitive tests share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(t, j, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=rtol)


def test_rms_norm_rope_swiglu():
    r = _rng(0)
    x = r.standard_normal((2, 5, 4, 16)).astype(np.float32)
    scale = r.standard_normal(16).astype(np.float32)
    pos = r.integers(0, 200, (2, 5)).astype(np.int32)
    g, u = r.standard_normal((2, 2, 3, 8)).astype(np.float32)
    _close(tbasics.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6),
           jbasics.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6))
    _close(tbasics.rope_freqs(16, 500000.0), jbasics.rope_freqs(16, 500000.0), atol=0, rtol=1e-6)
    _close(tbasics.rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0),
           jbasics.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0), atol=1e-5)
    _close(tbasics.swiglu(torch.from_numpy(g), torch.from_numpy(u)),
           jbasics.swiglu(jnp.asarray(g), jnp.asarray(u)), atol=1e-6)


@pytest.mark.parametrize(
    "kh,causal,with_pos,with_len",
    [(4, True, False, False), (2, True, True, False), (2, True, True, True),
     (1, False, False, True), (4, False, False, False)],
    ids=["mha-causal", "gqa-qpos", "gqa-qpos-kvlen", "mqa-kvlen", "mha-full"],
)
def test_dot_product_attention(kh, causal, with_pos, with_len):
    r = _rng(1)
    b, sq, sk, h, d = 2, 6, 11, 4, 16
    q = r.standard_normal((b, sq, h, d)).astype(np.float32)
    k = r.standard_normal((b, sk, kh, d)).astype(np.float32)
    v = r.standard_normal((b, sk, kh, d)).astype(np.float32)
    pos = (np.arange(sq)[None, :] + np.array([[5], [0]])).astype(np.int32) if with_pos else None
    kv_len = np.array([7, 11], np.int32) if with_len else None
    kw_j = dict(causal=causal, q_positions=None if pos is None else jnp.asarray(pos),
                kv_length=None if kv_len is None else jnp.asarray(kv_len))
    kw_t = dict(causal=causal, q_positions=None if pos is None else torch.from_numpy(pos),
                kv_length=None if kv_len is None else torch.from_numpy(kv_len))
    want = jattn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw_j)
    got = tattn.dot_product_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw_t)
    _close(got, want)


def test_quantize_kv_bit_exact():
    r = _rng(2)
    x = (r.standard_normal((3, 2, 7, 32)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0  # all-zero vector -> scale 1
    x[1, 1, 2, :4] = [127 * 0.5, -0.5, 2.5, 1.5]  # round-half-to-even cases
    tq, ts = tquant.quantize_kv(torch.from_numpy(x))
    jq, js = jquant.quantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    _close(tquant.dequantize_kv(tq, ts, torch.float32),
           jquant.dequantize_kv(jq, js, jnp.float32), atol=0, rtol=0)


def test_greedy_sample_exact():
    r = _rng(3)
    logits = r.standard_normal((6, 258)).astype(np.float32)
    temps = np.zeros(6, np.float32)
    gen = torch.Generator().manual_seed(0)
    got = tsampling.sample(torch.from_numpy(logits), gen, torch.from_numpy(temps),
                           top_k=5, top_p=torch.full((6,), 0.9))
    want = jsampling.sample(jnp.asarray(logits), jax.random.key(0), jnp.asarray(temps),
                            top_k=5, top_p=jnp.full((6,), 0.9))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32


def _jax_masked_logits(logits, temps, top_k, top_p):
    """The JAX sample()'s masking, up to its categorical draw (the draw
    itself comes from another generator and cannot match)."""
    safe_t = jnp.maximum(temps, 1e-6)[:, None]
    scaled = logits / safe_t
    if top_k:
        kth = jax.lax.top_k(scaled, top_k)[0][:, -1:]
        scaled = jnp.where(scaled < kth, -jnp.inf, scaled)
    sorted_logits = jnp.sort(scaled, axis=-1)[:, ::-1]
    probs = jax.nn.softmax(sorted_logits, axis=-1)
    cum = jnp.cumsum(probs, axis=-1)
    cutoff = jnp.min(jnp.where((cum - probs) < top_p[:, None], sorted_logits, jnp.inf),
                     axis=-1, keepdims=True)
    return jnp.where(scaled < cutoff, -jnp.inf, scaled)


@pytest.mark.parametrize("top_k,top_p", [(0, 0.7), (8, 1.0), (20, 0.5)])
def test_top_k_top_p_masks(top_k, top_p):
    r = _rng(4)
    logits = (r.standard_normal((4, 64)) * 2).astype(np.float32)
    temps = np.array([0.5, 0.8, 1.0, 1.3], np.float32)
    tp = np.full(4, top_p, np.float32)
    got = tsampling.masked_logits(torch.from_numpy(logits), torch.from_numpy(temps), top_k, torch.from_numpy(tp))
    want = np.asarray(_jax_masked_logits(jnp.asarray(logits), jnp.asarray(temps), top_k, jnp.asarray(tp)))
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    live = ~np.isinf(want)
    np.testing.assert_allclose(got.numpy()[live], want[live], rtol=1e-6)


def test_temperature_draws_stay_in_the_mask():
    """Sampled rows only draw tokens the top-k/top-p mask keeps."""
    r = _rng(5)
    logits = torch.from_numpy((r.standard_normal((4, 64)) * 3).astype(np.float32))
    temps = torch.full((4,), 0.8)
    top_p = torch.full((4,), 0.5)
    keep = ~torch.isinf(tsampling.masked_logits(logits, temps, 4, top_p))
    gen = torch.Generator().manual_seed(1)
    for _ in range(20):
        tok = tsampling.sample(logits, gen, temps, top_k=4, top_p=top_p)
        assert keep[torch.arange(4), tok.long()].all()
