"""Chunked prefill in the port's Engine (substratus_tpu_torch/serve/
engine.py): a prompt longer than max_prefill_len runs as bucket-sized
chunks written into its slot's cache, each through the cached attention
(flash_cached_attention, its plain version on the CPU).

float32 tiny config, the JAX weights carried across by
bridge.params_from_jax. A 71-token prompt at max_prefill_len=32 (chunks
of 32, 32 and 7 padded to 16) must give the greedy tokens of the JAX
Engine(kv_layout="dense", overlap=False) at the same setting, with the
model-dtype and the int8 cache, and of the port's own single-shot
prefill; a short request before and after the long one gives the same
tokens (the chunks write only their own slot).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substratus_tpu.models import llama as jllama
from substratus_tpu.serve.engine import Engine as JEngine
from substratus_tpu.serve.engine import EngineConfig as JEngineConfig
from substratus_tpu_torch.bridge import params_from_jax
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.serve.engine import Engine, EngineConfig


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
PROMPT = [256] + np.random.default_rng(7).integers(0, 255, 70).tolist()  # 71 tokens


@pytest.fixture(scope="module")
def weights():
    j_params = jllama.init_params(J_CFG, jax.random.key(0))
    t_params = llama.Llama(T_CFG, device="cpu")
    t_params.load_state_dict(params_from_jax(jax.device_get(j_params)))
    return j_params, t_params


def _ec(max_prefill, kv="model"):
    return dict(max_batch=2, max_seq_len=128, max_prefill_len=max_prefill, eos_token_id=EOS,
                kv_cache_dtype=kv)


def _generate(engine, prompts, max_tokens=8):
    engine.start()
    try:
        return [engine.generate(list(p), max_tokens=max_tokens, temperature=0.0) for p in prompts]
    finally:
        engine.stop()


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_chunked_matches_jax_engine(weights, kv):
    j_params, t_params = weights
    engine = Engine(T_CFG, t_params, EngineConfig(kv_layout="dense", **_ec(32, kv)), device="cpu")
    got = _generate(engine, [PROMPT])
    want = _generate(JEngine(J_CFG, j_params, JEngineConfig(kv_layout="dense", overlap=False, **_ec(32, kv))),
                     [PROMPT])
    assert got == want and len(got[0]) >= 1
    assert engine.stats["prefill_chunks"] == 3 and engine.stats["prefills"] == 0
    assert engine.stats["prefill_tokens"] == 71


def test_chunked_matches_single_shot(weights):
    _, t_params = weights
    whole = _generate(Engine(T_CFG, t_params, EngineConfig(kv_layout="dense", **_ec(128)), device="cpu"), [PROMPT])
    chunked = _generate(Engine(T_CFG, t_params, EngineConfig(kv_layout="dense", **_ec(32)), device="cpu"), [PROMPT])
    assert chunked == whole


def test_short_requests_around_a_long_one(weights):
    """The chunks write only the long request's slot: a short request
    gives the same tokens before and after it."""
    _, t_params = weights
    engine = Engine(T_CFG, t_params, EngineConfig(kv_layout="dense", **_ec(32)), device="cpu")
    before, long_out, after = _generate(engine, [[256, 1, 2], PROMPT, [256, 1, 2]], max_tokens=6)
    assert before == after and len(long_out) >= 1
    assert engine.stats["prefills"] == 2 and engine.stats["prefill_chunks"] == 3


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_chunk_write_drops_and_duplicates_match_jax(quantized):
    """A chunk's cache write with positions past the cache (dropped) and
    positions repeated (the padded tail clamped onto one row, and a drop
    clamped onto S-1 beside an in-range write there): the port's write,
    which never reads a position back to the host, leaves the cache as
    JAX's scatter does (the last in-range entry of a row wins)."""
    from substratus_tpu.ops import decode_attention as jdec
    from substratus_tpu.ops.quant import quantize_kv as j_quantize_kv
    from substratus_tpu_torch.ops import decode_attention as tdec

    b, kh, h, s, d = 2, 2, 4, 8, 16
    r = np.random.default_rng(11)
    k = r.standard_normal((b, kh, s, d)).astype(np.float32)
    cache = {"k": k, "v": r.standard_normal((b, kh, s, d)).astype(np.float32)}
    if quantized:
        cache = {}
        for name in ("k", "v"):
            q, scale = j_quantize_kv(jnp.asarray(r.standard_normal((b, kh, s, d)).astype(np.float32)))
            cache[name], cache[f"{name}_scale"] = np.asarray(q), np.asarray(scale)[..., 0]
    q = r.standard_normal((b, 5, h, d)).astype(np.float32)
    kv = r.standard_normal((b, 5, kh, d)).astype(np.float32)
    # Row 0: a write at S-1, then two past the cache; row 1: a tail of three
    # entries clamped onto position 4, as the engine pads a chunk.
    positions = np.array([[5, 6, s - 1, s, s + 3], [2, 3, 4, 4, 4]], np.int32)
    assert len(set(positions[1])) < positions.shape[1] and (positions >= s).any()
    t_cache = {name: torch.from_numpy(x.copy()) for name, x in cache.items()}
    got, _ = tdec.update_cache_and_attend(t_cache, *(torch.from_numpy(x) for x in (q, kv, kv, positions)))
    want, j_out = jdec.update_cache_and_attend({name: jnp.asarray(x) for name, x in cache.items()},
                                               *(jnp.asarray(x) for x in (q, kv, kv, positions)))
    for name in cache:
        np.testing.assert_array_equal(t_cache[name].numpy(), np.asarray(j_out[name]), err_msg=name)
    # The rows that real queries attend agree too (row 1's padded tail
    # attends a row the tail rewrote, in both packages alike).
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
