"""The port's continuous-batching Engine (substratus_tpu_torch/serve/
engine.py) against the JAX Engine on the synchronous dense path and
against tests/conftest.py::greedy_decode, on the same (bridged) weights.

Greedy outputs of concurrently submitted prompts of different lengths
(buckets 16/32/64, one at the context window) must be token-exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import greedy_decode

from substratus_tpu.models import llama as jllama
from substratus_tpu.serve.engine import Engine as JEngine
from substratus_tpu.serve.engine import EngineConfig as JEngineConfig
from substratus_tpu.serve.engine import Request as JRequest
from substratus_tpu_torch.bridge import params_from_jax
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.serve.engine import (
    Engine, EngineConfig, EngineOverloaded, Request, _bucket, _pad_to_bucket)


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
_r = np.random.default_rng(0)
PROMPTS = [[256] + _r.integers(0, 256, n - 1).tolist() for n in (3, 9, 17, 30, 60)]
MAX_TOKENS = 12


@pytest.fixture(scope="module")
def weights():
    j_params = jllama.init_params(J_CFG, jax.random.key(0))
    t_params = llama.Llama(T_CFG, device="cpu")
    t_params.load_state_dict(params_from_jax(jax.device_get(j_params)))
    return j_params, t_params


def _run(engine, req_cls, prompts, **kw):
    """Submit every prompt before reading any output (they share decode
    steps), then collect each stream."""
    engine.start()
    try:
        kw = {"temperature": 0.0, **kw}
        reqs = [engine.submit(req_cls(list(p), max_tokens=MAX_TOKENS, **kw)) for p in prompts]
        outs = []
        for req in reqs:
            toks = []
            while (tok := req.out.get(timeout=300)) is not None:
                toks.append(tok)
            outs.append((toks, req.finish_reason))
        return outs
    finally:
        engine.stop()


def test_engine_greedy_matches_jax_engine_and_greedy_decode(weights):
    j_params, t_params = weights
    ec = dict(max_batch=4, max_seq_len=64, eos_token_id=EOS)
    got = _run(Engine(T_CFG, t_params, EngineConfig(kv_layout="dense", **ec), device="cpu"), Request, PROMPTS)
    want = _run(JEngine(J_CFG, j_params, JEngineConfig(kv_layout="dense", overlap=False, **ec)),
                JRequest, PROMPTS)
    assert got == want
    for prompt, (toks, finish) in zip(PROMPTS, got):
        oracle = greedy_decode(jllama, j_params, J_CFG, prompt, MAX_TOKENS)
        if EOS in oracle:
            oracle = oracle[: oracle.index(EOS)]
        # The slot is released at the context window: 64 - len(prompt) tokens.
        oracle = oracle[: 64 - len(prompt)]
        assert toks == oracle, prompt
        assert finish == ("length" if len(toks) in (MAX_TOKENS, 64 - len(prompt)) else "stop")
    assert got[-1][1] == "length" and len(got[-1][0]) == 4  # the window-bound request


def test_engine_sampled_and_queue_bound(weights):
    _, t_params = weights
    eng = Engine(T_CFG, t_params, EngineConfig(max_batch=2, max_seq_len=64, eos_token_id=EOS, max_queue=1,
                                                top_k=8), device="cpu")
    # Not started: the first submit waits, the second is shed.
    eng.submit(Request([256, 1, 2], max_tokens=6, temperature=0.8, top_p=0.9))
    with pytest.raises(EngineOverloaded):
        eng.submit(Request([256, 3], max_tokens=2))
    eng.queue.get_nowait()
    outs = _run(eng, Request, [[256, 1, 2, 3]], temperature=0.8, top_p=0.9)
    assert 1 <= len(outs[0][0]) <= MAX_TOKENS and all(0 <= t < 258 for t in outs[0][0])


def test_prompt_clip_and_prefill_limit(weights):
    _, t_params = weights
    eng = Engine(T_CFG, t_params, EngineConfig(max_batch=2, max_seq_len=32, max_prefill_len=16,
                                                eos_token_id=EOS, kv_layout="dense"), device="cpu")
    assert eng.clipped_prompt(list(range(40))) == list(range(9, 40))  # newest max_seq_len-1
    # Longer than max_prefill_len: served as two chunks (16 + 4), not refused.
    (toks, _), = _run(eng, Request, [list(range(20))])
    assert 1 <= len(toks) <= MAX_TOKENS and all(0 <= t < 258 for t in toks)
    assert eng.stats["prefill_chunks"] == 2 and eng.stats["prefills"] == 0
    assert eng.stats["prefill_tokens"] == 20
    # An empty prompt is admitted (as the reference admits it), not refused.
    req = eng.submit(Request([], max_tokens=2))
    assert eng.queue.get_nowait() is req


def test_empty_prompt_matches_jax_engine(weights):
    """An empty prompt pads to the smallest bucket and samples its first
    token from the last padded row, as JAX's dense admission does; a
    normal prompt decoding beside it is unaffected."""
    j_params, t_params = weights
    ec = dict(max_batch=2, max_seq_len=64, eos_token_id=EOS)
    prompts = [[], PROMPTS[1]]
    got = _run(Engine(T_CFG, t_params, EngineConfig(kv_layout="dense", **ec), device="cpu"), Request, prompts)
    want = _run(JEngine(J_CFG, j_params, JEngineConfig(kv_layout="dense", overlap=False, **ec)),
                JRequest, prompts)
    assert got == want
    assert len(got[0][0]) >= 1


def test_buckets():
    assert [_bucket(n) for n in (1, 16, 17, 100, 400)] == [16, 16, 32, 128, 512]
    padded, n = _pad_to_bucket([5, 6, 7], 512)
    assert n == 3 and padded.shape == (1, 16) and padded[0, :4].tolist() == [5, 6, 7, 0]
    assert _pad_to_bucket(list(range(300)), 384)[0].shape == (1, 384)
