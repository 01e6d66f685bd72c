"""The port's speculative decoding pieces (substratus_tpu_torch/serve/
speculative.py, the engine's verify forward, prompt lookup and the
SpecGraph's accept walk) against the JAX package's, on the CPU.

The tiny float32 config of the JAX engine tests (vocabulary 258) with the
JAX weights carried across by bridge.params_from_jax. The standalone
speculative_generate is token-exact against JAX's at k 1, 3 and 4 and on
a self-draft; prompt lookup equals the JAX staticmethod on seeded
contexts; the verify forward at [B, k+1] over a dense cache and over the
paged pool equals JAX's (logits within 1e-4 of each row's largest, the
greedy choices exact); the on-device accept walk equals JAX's
_build_spec_advance on seeded rounds of every width, with fully
accepted, sampling, degraded and freshly admitted rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substratus_tpu.models import llama as jllama
from substratus_tpu.serve.engine import Engine as JEngine
from substratus_tpu.serve.engine import EngineConfig as JEngineConfig
from substratus_tpu.serve.engine import Request as JRequest
from substratus_tpu.serve.speculative import speculative_generate as j_speculative_generate
from substratus_tpu_torch.bridge import params_from_jax
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.serve.decode_graph import SpecGraph
from substratus_tpu_torch.serve.engine import Engine, EngineConfig, Request
from substratus_tpu_torch.serve.speculative import speculative_generate


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


EOS = 257
J_CFG = jllama.CONFIGS["tiny"].replace(vocab_size=258, dtype=jnp.float32)
T_CFG = llama.CONFIGS["tiny"].replace(vocab_size=258, dtype=torch.float32)
ROW_REL = 1e-4  # f32 logits: another summation order


def _port(j_params, cfg):
    model = llama.Llama(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(j_params)))
    return model


@pytest.fixture(scope="module")
def weights():
    """(JAX, port) weights of the target (seed 0) and a one-layer draft
    (seed 9) that disagrees with it."""
    jt = jllama.init_params(J_CFG, jax.random.key(0))
    jd = jllama.init_params(J_CFG.replace(n_layers=1), jax.random.key(9))
    return (jt, _port(jt, T_CFG)), (jd, _port(jd, T_CFG.replace(n_layers=1)))


@pytest.mark.parametrize("k", [1, 3, 4])
def test_speculative_generate_matches_jax(weights, k):
    (jt, tt), (jd, td) = weights
    prompt = [256, 7, 42, 99]
    want, want_stats = j_speculative_generate(jt, J_CFG, jd, J_CFG.replace(n_layers=1), prompt, max_tokens=16, k=k,
                                              cache_len=256)
    got, stats = speculative_generate(tt, T_CFG, td, T_CFG.replace(n_layers=1), prompt, max_tokens=16, k=k,
                                      cache_len=256)
    assert got == want and stats == want_stats and stats["tokens"] == 16


def test_speculative_self_draft_accepts_everything(weights):
    """Draft == target: every proposal accepted, about k tokens a target
    forward, as in JAX."""
    (jt, tt), _ = weights
    want, want_stats = j_speculative_generate(jt, J_CFG, jt, J_CFG, [256, 2, 3], max_tokens=17, k=4, cache_len=256)
    got, stats = speculative_generate(tt, T_CFG, tt, T_CFG, [256, 2, 3], max_tokens=17, k=4, cache_len=256)
    assert (got, stats) == (want, want_stats) and stats["tokens_per_target_pass"] >= 3.0


def test_prompt_lookup_matches_jax():
    """The n-gram matcher on the JAX unit cases and on seeded contexts
    over small alphabets (so that n-grams repeat), every k up to 5."""
    cases = [([7, 8, 9, 1, 7, 8], 2), ([1, 2, 3, 1, 2, 5, 1, 2], 1), ([4, 6, 4, 6, 4, 6], 4), ([1, 2, 3, 4, 5], 3),
             ([5], 2), ([3, 3], 3)]
    rng = np.random.default_rng(0)
    cases += [(rng.integers(0, a, n).tolist(), int(rng.integers(1, 6)))
              for a, n in zip(rng.integers(2, 12, 200), rng.integers(2, 60, 200))]
    hits = 0
    for ctx, k in cases:
        want = JEngine._prompt_lookup(ctx, k)
        got = Engine._prompt_lookup(ctx, k)
        assert (got is None) == (want is None), (ctx, k)
        if want is not None:
            hits += 1
            assert got.tolist() == np.asarray(want).tolist(), (ctx, k)
    assert Engine._prompt_lookup([1, 2, 3, 4, 5], 3) is None and hits > 150


def _filled_engines(weights, layout):
    """A port and a JAX spec engine (prompt lookup, k 3) with the same four
    prompts admitted: equal caches, ready for one round by hand."""
    (jt, tt), _ = weights
    kw = dict(max_batch=4, max_seq_len=64, eos_token_id=EOS, kv_layout=layout, spec_k=3, page_size=8)
    port = Engine(T_CFG, tt, EngineConfig(**kw), device="cpu")
    jeng = JEngine(J_CFG, jt, JEngineConfig(**kw))
    rng = np.random.default_rng(1)
    for n in (5, 17, 30, 62):
        prompt = [256] + rng.integers(0, 256, n - 1).tolist()
        port.queue.put(Request(list(prompt), max_tokens=32))
        jeng.queue.put(JRequest(list(prompt), max_tokens=32))
    assert port._admit() == 4 and jeng._admit() == 4
    return port, jeng


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_verify_forward_matches_jax(weights, layout):
    """One [B, k+1] verify over the admitted slots at their next
    positions, seeded proposals (the last slot's 62-token prompt puts two
    of its writes past the window: dropped on the dense cache, sent to
    the trash page on the pool): logits within 1e-4 of each row's
    largest, greedy choices exact."""
    port, jeng = _filled_engines(weights, layout)
    B, w = 4, 4
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, 258, (B,)).astype(np.int32)
    props = rng.integers(0, 258, (B, w - 1)).astype(np.int32)
    pos0 = port.positions.astype(np.int32).copy()
    assert pos0.tolist() == jeng.host_positions.tolist() == [5, 17, 30, 62]
    if layout == "paged":  # the pages the round writes, as a dispatch grows them
        for slot in range(B):
            port._ensure_capacity(slot, int(pos0[slot]) + w - 1)
            jeng._ensure_capacity(slot, int(pos0[slot]) + w - 1)
        assert port.block_table.tolist() == np.asarray(jeng.block_table).tolist()
    block = np.concatenate([tokens[:, None], props], axis=1)
    positions = pos0[:, None] + np.arange(w, dtype=np.int32)[None, :]
    bt = {"block_table": jnp.asarray(jeng.block_table)} if jeng.paged else {}
    want, _ = jllama.forward(jeng.params, jnp.asarray(block), J_CFG, positions=jnp.asarray(positions),
                             cache=jeng.cache, **bt)
    choices, _, jeng.cache, _ = jeng._verify_fn(jeng.params, jeng.cache, jeng.block_table if jeng.paged else None,
                                                tokens, props, pos0, jeng.temps, jeng.top_ps, jeng.key)
    tb = {"block_table": torch.from_numpy(port.block_table)} if port.paged else {}
    with torch.inference_mode():
        got, _ = llama.forward(port.params, torch.from_numpy(block).long(), T_CFG,
                               positions=torch.from_numpy(positions).long(), cache=port.cache, **tb)
        got_choices, sampled = port._verify_step(T_CFG, torch.from_numpy(block).long(),
                                                 torch.from_numpy(positions).long(), torch.zeros(B),
                                                 torch.ones(B), *tb.values())
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max(axis=-1) / np.abs(want).max(axis=-1)
    assert err.max() <= ROW_REL, err.max()
    assert got_choices.tolist() == np.asarray(choices).tolist()
    assert sampled.tolist() == got_choices[:, 0].tolist()  # temperature 0: the greedy choice


def test_spec_advance_matches_jax(weights):
    """The SpecGraph's accept walk on the device against JAX's
    _build_spec_advance, on seeded rounds of every width 1..k+1: rows
    fully accepted, partly, not at all, sampling rows, degraded rows
    (k_eff 0 in a wide round), fresh rows taking the host's values, a
    position clamped at the window. Columns past a round's width hold
    junk, which the walk must never read."""
    port, jeng = _filled_engines(weights, "dense")
    advance = jeng._build_spec_advance()
    k, B, max_pos = 3, 16, 63
    graph = SpecGraph(None, None, B, k, max_pos, torch.device("cpu"), port.generator, port.stats, capture=False)
    rng = np.random.default_rng(3)
    for width in range(1, k + 2):
        for _ in range(20):
            props = rng.integers(0, 4, (B, width - 1)).astype(np.int32)
            choices = rng.integers(0, 4, (B, width)).astype(np.int32)
            k_eff = rng.integers(0, width, (B,))
            full = rng.random(B) < 0.3
            for row in np.flatnonzero(full & (k_eff > 0)):
                choices[row, : k_eff[row]] = props[row, : k_eff[row]]  # every proposal accepted
            greedy = rng.random(B) < 0.75
            k_eff = np.where(greedy, k_eff, 0)
            sampled = rng.integers(0, 258, (B,)).astype(np.int32)
            pos0 = rng.integers(0, max_pos + 1, (B,)).astype(np.int32)
            pos0[0] = max_pos
            host_tokens = rng.integers(0, 258, (B,)).astype(np.int32)
            host_pos = rng.integers(0, max_pos + 1, (B,)).astype(np.int32)
            fresh = rng.random(B) < 0.25
            want_tok, want_pos = advance(choices, sampled, props, k_eff.astype(np.int32), greedy, pos0, host_tokens,
                                         host_pos, fresh)
            # Junk past the width, then this round's state.
            graph.st_choices.random_(0, 258)
            graph.st_props.random_(0, 258)
            graph.st_choices[:, :width] = torch.from_numpy(choices)
            graph.st_props[:, : width - 1] = torch.from_numpy(props)
            for name, value in (("st_keff", k_eff), ("st_greedy", greedy), ("st_sampled", sampled), ("st_pos0", pos0),
                                ("tokens", host_tokens), ("positions", host_pos), ("fresh", fresh)):
                getattr(graph, name).copy_(torch.from_numpy(np.asarray(value)))
            graph._advance()
            assert graph.tok_in.tolist() == np.asarray(want_tok).tolist()
            assert graph.pos_in.tolist() == np.asarray(want_pos).tolist()


def test_spec_graph_inputs_and_turns(weights):
    """A round's width lies in 1..k+1; lookup proposals are an input of
    exactly the draft-free round and a block table of exactly the paged
    one; a round must be read before the round after next is launched;
    the read gives choices [B, width] and samples [B]."""
    port, _ = _filled_engines(weights, "paged")
    graph = port._decode_graph()
    B, K = 4, 3
    args = (port.tokens, port.positions, port.temps, port.top_ps, np.ones(B, bool), np.zeros(B, np.int64),
            np.ones(B, bool))
    props = np.zeros((B, K), np.int64)
    with pytest.raises(ValueError, match="width"):
        graph.launch(*args, 5, props=props, block_table=port.block_table)
    with pytest.raises(ValueError, match="block table"):
        graph.launch(*args, 1, props=props)
    with pytest.raises(ValueError, match="lookup proposals"):
        graph.launch(*args, 1, block_table=port.block_table)
    first = graph.launch(*args, 1, props=props, block_table=port.block_table)
    graph.launch(*args, 2, props=props, block_table=port.block_table)
    with pytest.raises(RuntimeError, match="read"):
        graph.launch(*args, 1, props=props, block_table=port.block_table)
    choices, sampled, draft_props = first()
    assert choices.shape == (B, 1) and sampled.shape == (B,) and draft_props is None
