"""The port's Engine on the paged pool (substratus_tpu_torch/serve/engine.py,
kv_layout "paged") against the JAX Engine on its paged pool, on the CPU.

The tiny float32 config with the JAX weights carried across by
bridge.params_from_jax. Greedy tokens are token-exact against JAX, with
the synchronous and the overlapped scheduler, and the pool's counters
(prefix-hit tokens, prefill tokens, preemptions, truncations, the most
slots active) equal: prompts sharing a prefix (pages reused), and a pool
too small for the demand (registry evictions, preempt-and-resume). Then
the port's versions of the JAX engine tests of tests/test_paged_kv.py, int4
weights on an int8 pool, the layout's resolution in the Engine and in
serve.main (against JAX's resolve_kv_layout), and the block table as an
input of the decode step's static buffers. EOS is an id the tiny model
never samples here, and each test that compares tokens asserts it: every
request ends by its budget or the window.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substratus_tpu.models import llama as jllama
from substratus_tpu.ops.quant4 import quantize4_params as j_quantize4_params
from substratus_tpu.serve import main as jmain
from substratus_tpu.serve.engine import Engine as JEngine
from substratus_tpu.serve.engine import EngineConfig as JEngineConfig
from substratus_tpu.serve.engine import Request as JRequest
from substratus_tpu_torch.bridge import params_from_jax
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.serve import main
from substratus_tpu_torch.serve.decode_graph import DecodeGraph
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
POOL_STATS = ("prefill_tokens", "prefix_hit_tokens", "preemptions", "truncated_by_pool", "max_active")


@pytest.fixture(scope="module")
def weights():
    j_params = jllama.init_params(J_CFG, jax.random.key(0))
    t_params = llama.Llama(T_CFG, device="cpu")
    t_params.load_state_dict(params_from_jax(jax.device_get(j_params)))
    return j_params, t_params


def _run(engine, req_cls, prompts, max_tokens=8):
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


def _tokens(outs):
    assert all(finish == "length" for _, finish in outs), outs  # EOS never sampled
    return [toks for toks, _ in outs]


def _shared_prompts(seed, prefix_len, *suffixes):
    r = np.random.default_rng(seed)
    prefix = [256] + r.integers(0, 256, prefix_len - 1).tolist()
    return [prefix + r.integers(0, 256, n).tolist() for n in suffixes]


# name: (engine config, prompts, max_tokens)
SCENARIOS = {
    # A 24-token prefix (3 pages of 8) under four suffixes, one prompt empty
    # and one short: later admissions of the first round already hit.
    "prefix": (dict(max_batch=4, max_seq_len=64, page_size=8, max_prefill_len=16),
               _shared_prompts(1, 24, 3, 11, 20, 0) + [[], [256, 7, 8]], 10),
    # 9 pages for six requests of 40 tokens each: the registry is evicted,
    # the youngest slots preempted and resumed, the prefix shared again.
    "pressure": (dict(max_batch=3, max_seq_len=64, page_size=8, kv_pool_tokens=72, max_prefill_len=16),
                 _shared_prompts(2, 16, 2, 5, 9, 1, 4, 7), 30),
}


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_paged_engine_matches_jax(weights, scenario, overlap):
    j_params, t_params = weights
    ec, prompts, max_tokens = SCENARIOS[scenario]
    ec = dict(ec, eos_token_id=EOS, kv_layout="paged", overlap=overlap)
    port = Engine(T_CFG, t_params, EngineConfig(**ec), device="cpu")
    jeng = JEngine(J_CFG, j_params, JEngineConfig(**ec))
    assert port.paged and jeng.paged and (port.n_pages, port.max_pages) == (jeng.n_pages, jeng.max_pages)
    got = _tokens(_run(port, Request, prompts, max_tokens))
    want = _tokens(_run(jeng, JRequest, prompts, max_tokens))
    assert got == want
    stats = {k: port.stats[k] for k in POOL_STATS}
    assert stats == {k: jeng.stats[k] for k in POOL_STATS}
    if scenario == "prefix":
        # 3 pages for two suffixed prompts; 2 for the bare prefix, whose
        # last token's page is never reused.
        assert stats["prefix_hit_tokens"] == 2 * 24 + 16 and stats["preemptions"] == 0
    else:
        assert stats["preemptions"] >= 1 and stats["truncated_by_pool"] == 0
    # Every page is free or held once by the registry.
    assert port.alloc.free_pages + len(port.prefix) == port.n_pages
    assert not port.block_table.any() and port.stats["prefills"] == 0


def test_paged_fits_more_than_dense_at_fixed_memory(weights):
    """A pool of 2 dense slots' worth of tokens, but 4 short requests board
    together: the batch is bounded by tokens in flight, not reservations."""
    _, t_params = weights
    eng = Engine(T_CFG, t_params, EngineConfig(max_batch=4, max_seq_len=64, eos_token_id=EOS, kv_pool_tokens=128,
                                               page_size=16), device="cpu")
    assert eng.paged and eng.n_pages == 8
    outs = _tokens(_run(eng, Request, [[256, 10 + i, 20, 30] for i in range(4)]))
    assert all(len(o) == 8 for o in outs)
    assert eng.stats["max_active"] >= 3 and eng.stats["preemptions"] == 0
    assert eng.alloc.free_pages + len(eng.prefix) == eng.n_pages


def test_prefix_cache_shares_pages_and_skips_prefill(weights):
    _, t_params = weights
    eng = Engine(T_CFG, t_params, EngineConfig(max_batch=2, max_seq_len=64, eos_token_id=EOS, page_size=8,
                                               max_prefill_len=32), device="cpu")
    prompt = [256] + list(range(1, 40))  # 5 full pages of 8
    eng.start()
    try:
        out1 = eng.generate(prompt, max_tokens=6, temperature=0.0)
        after_first = eng.stats["prefill_tokens"]
        assert eng.stats["prefix_hit_tokens"] == 0 and after_first == len(prompt)
        out2 = eng.generate(prompt, max_tokens=6, temperature=0.0)
    finally:
        eng.stop()
    assert out2 == out1 and len(out1) == 6  # greedy through the shared pages; EOS never sampled
    assert eng.stats["prefix_hit_tokens"] == 32  # 4 pages: never the one holding the last token
    assert eng.stats["prefill_tokens"] - after_first == len(prompt) - 32
    assert eng.prefix.hits == 4


def test_preempt_and_resume_preserves_greedy_output(weights):
    """Two long generations against a pool that cannot hold both: the
    youngest is preempted (its pages freed, the request boards again and
    its prefill rebuilds the context) and both produce exactly the roomy
    run's tokens."""
    _, t_params = weights
    prompts = [[256, 5, 6, 7], [256, 8, 9, 10]]
    ec = dict(max_batch=2, max_seq_len=64, eos_token_id=EOS, page_size=8, prefix_cache=False)
    want = _tokens(_run(Engine(T_CFG, t_params, EngineConfig(**ec), device="cpu"), Request, prompts, 40))
    tight = Engine(T_CFG, t_params, EngineConfig(kv_pool_tokens=72, **ec), device="cpu")  # 9 pages < 2 sequences
    assert _tokens(_run(tight, Request, prompts, 40)) == want
    assert tight.stats["preemptions"] >= 1 and tight.alloc.free_pages == tight.n_pages


def test_pool_pages_all_recovered_after_load(weights):
    _, t_params = weights
    eng = Engine(T_CFG, t_params, EngineConfig(max_batch=4, max_seq_len=64, eos_token_id=EOS, page_size=8,
                                               kv_pool_tokens=96), device="cpu")
    _run(eng, Request, [[256, i, i + 1] + [i] * 14 for i in range(1, 9)], max_tokens=12)
    held = [eng.alloc.refs(eng.prefix._map[h][0]) for h in eng.prefix._map]
    assert len(eng.prefix) > 0 and held == [1] * len(eng.prefix)
    assert eng.alloc.free_pages + len(eng.prefix) == eng.n_pages
    assert all(not pages for pages in eng.slot_pages.pages)


def test_int4_weights_on_int8_pool_match_jax(weights):
    """int4 weights (JAX quantize4_params, bridged) on an int8 pool, one
    prompt in chunks of 16 and two sharing its first page: tokens and
    counters equal the JAX paged engine's."""
    j_dense, _ = weights
    j_params = j_quantize4_params(j_dense, jllama.quant_contracting(J_CFG))
    t_params = llama.Llama(T_CFG, device="cpu", quantize="int4")
    t_params.load_state_dict(params_from_jax(jax.device_get(j_params)))
    prompts = _shared_prompts(3, 16, 30, 2, 5)
    ec = dict(max_batch=4, max_seq_len=128, max_prefill_len=16, eos_token_id=EOS, kv_layout="paged",
              kv_cache_dtype="int8", page_size=16, overlap=True)
    port = Engine(T_CFG, t_params, EngineConfig(**ec), device="cpu")
    assert port.cache["k"].dtype == torch.int8 and port.cache["k_scale"].shape[-1] == 1
    got = _tokens(_run(port, Request, prompts, 12))
    jeng = JEngine(J_CFG, j_params, JEngineConfig(**ec))
    assert got == _tokens(_run(jeng, JRequest, prompts, 12))
    assert {k: port.stats[k] for k in POOL_STATS} == {k: jeng.stats[k] for k in POOL_STATS}
    assert port.stats["prefix_hit_tokens"] == 2 * 16 and port.stats["prefill_chunks"] >= 4


def test_layout_resolution(weights):
    """auto is paged for llama (the JAX engine's default), dense pins the
    slot cache, an unknown layout or a family without pages raises; the
    pool's size follows the JAX engine's rule."""
    j_params, t_params = weights
    assert EngineConfig().kv_layout == JEngineConfig().kv_layout == "auto"
    assert (EngineConfig().page_size, EngineConfig().kv_pool_tokens, EngineConfig().prefix_cache) == (16, None, True)
    for kw in ({}, {"kv_pool_tokens": 40}, {"kv_pool_tokens": 500, "page_size": 8}, {"prefix_cache": False}):
        ec = dict(max_batch=3, max_seq_len=64, **kw)
        port, jeng = Engine(T_CFG, t_params, EngineConfig(**ec), device="cpu"), JEngine(J_CFG, j_params,
                                                                                         JEngineConfig(**ec))
        assert port.paged and jeng.paged
        assert (port.n_pages, port.max_pages, port.page_size) == (jeng.n_pages, jeng.max_pages, jeng.page_size)
        assert port.cache["k"].shape[1] == port.n_pages + 1 and port.alloc.free_pages == port.n_pages
        assert (port.prefix is None) == (jeng.prefix is None)
    dense = Engine(T_CFG, t_params, EngineConfig(max_batch=3, max_seq_len=64, kv_layout="dense"), device="cpu")
    assert not dense.paged and dense.cache["k"].shape == (2, 3, 2, 64, 16)
    for kw, match in (({"kv_layout": "blocks"}, "invalid"), ({"page_size": 0}, "page_size"),
                      ({"kv_pool_tokens": 0}, "kv_pool_tokens")):
        with pytest.raises(ValueError, match=match):
            Engine(T_CFG, t_params, EngineConfig(**kw), device="cpu")
    with pytest.raises(ValueError, match="unsupported"):
        Engine(T_CFG, t_params, EngineConfig(kv_layout="paged"), device="cpu",
               model=type("Family", (), {"__name__": "dense_only", "init_cache": llama.init_cache}))


def test_resolve_kv_layout_matches_jax(tmp_path):
    """serve.main's layout equals the JAX entry point's on every
    combination of kv_layout and decode_attn_impl (or both exit with its
    message), and the served engine takes it: no key is the paged pool."""
    for layout in (None, "auto", "paged", "dense"):
        for impl in (None, "xla", "pallas", "fused"):
            params = {k: v for k, v in (("kv_layout", layout), ("decode_attn_impl", impl)) if v is not None}
            try:
                want = jmain.resolve_kv_layout(params)
            except SystemExit as e:
                with pytest.raises(SystemExit, match="requires kv_layout=dense") as got:
                    main.resolve_kv_layout(params)
                assert str(got.value) == str(e)
                continue
            assert main.resolve_kv_layout(params) == want
            main.check_params(params)
    with pytest.raises(SystemExit, match="kv_layout='blocks' invalid"):
        main.check_params({"kv_layout": "blocks"})
    for params, paged in (({}, True), ({"kv_layout": "paged"}, True), ({"kv_layout": "dense"}, False),
                          ({"decode_attn_impl": "fused"}, False)):
        path = tmp_path / "params.json"
        path.write_text(json.dumps({"config": "tiny", "max_batch": 2, "max_seq_len": 64, **params}))
        srv = main.build(["--device", "cpu", "--host", "127.0.0.1", "--port", "0", "--params", str(path)])
        srv.state.engine.stop()
        srv.httpd.server_close()
        assert srv.state.engine.paged is paged, params
        if paged:
            assert (srv.state.engine.page_size, srv.state.engine.n_pages) == (16, 8)


def test_decode_graph_block_table_input():
    """A paged step's block table is one more static input: staged with the
    others and read by the step at each launch (here eagerly, on the CPU);
    a launch without it, or a dense graph given one, raises."""
    stats = {"graph_replays": 0, "graph_warmups": 0}
    graph = DecodeGraph(lambda tokens, pos, temps, top_ps, table: (tokens + table.sum(1)).to(torch.int32), 2,
                        torch.device("cpu"), torch.Generator(), stats, capture=False, pages=3)
    assert graph.block_table.shape == (2, 3) and graph.block_table.dtype == torch.int64
    temps, top_ps, pos, fresh = np.zeros(2, np.float32), np.ones(2, np.float32), np.zeros(2, np.int64), np.ones(2, bool)
    table = np.array([[1, 2, 0], [3, 0, 0]], np.int64)
    assert graph.launch(np.array([10, 20]), pos, temps, top_ps, fresh, table)().tolist() == [13, 23]
    table[1, 1] = 5  # a page grown since the last launch
    assert graph.launch(np.array([10, 20]), pos, temps, top_ps, fresh, table)().tolist() == [13, 28]
    with pytest.raises(ValueError, match="block table"):
        graph.launch(np.array([1, 2]), pos, temps, top_ps, fresh)
    dense = DecodeGraph(lambda tokens, *rest: tokens.to(torch.int32), 2, torch.device("cpu"), torch.Generator(),
                        stats, capture=False)
    assert dense.block_table is None
    with pytest.raises(ValueError, match="block table"):
        dense.launch(np.array([1, 2]), pos, temps, top_ps, fresh, table)
