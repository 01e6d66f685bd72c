"""The port's Engine with an AdapterStore against the JAX Engine with the
JAX store, token for token, on the CPU in float32.

The same weights (bridge.params_from_jax) and the same numpy adapters
(B random: rank 4 on every llama target, rank 2 on wq/wv, in a store of
rank 4) go into both packages. A mixed-tenant batch (the base and both
tenants, prompts past max_prefill_len so they run as chunks) gives the
JAX engine's greedy tokens exactly, on the dense and the paged layout,
with the synchronous and the overlapped scheduler, and with prompt-lookup
speculation; its base rows equal a run of an engine with no store; a
tenant's tokens equal an engine built on merge_lora(base, adapter);
prefix pages never cross tenants (the registry's chains are salted with
the adapter id); a store of capacity 1 hot-loads and evicts inside the
engine with JAX's hit, miss and eviction counts; a preempted request
drops and takes again its pin; an unknown adapter is refused at submit,
and a vanished artifact ends its request as "error" with the engine
serving on.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substratus_tpu.models import llama as jllama
from substratus_tpu.serve import adapters as jadapters
from substratus_tpu.serve.engine import Engine as JEngine
from substratus_tpu.serve.engine import EngineConfig as JEngineConfig
from substratus_tpu.serve.engine import Request as JRequest
from substratus_tpu_torch.bridge import params_from_jax
from substratus_tpu_torch.models import llama, opt
from substratus_tpu_torch.serve import adapters
from substratus_tpu_torch.serve.engine import Engine, EngineConfig, Request
from substratus_tpu_torch.train.lora import LoraAdapters, merge_lora

J_CFG = jllama.CONFIGS["tiny"].replace(vocab_size=258, dtype=jnp.float32)
T_CFG = llama.CONFIGS["tiny"].replace(vocab_size=258, dtype=torch.float32)
ALL = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
EOS = 257


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_lora(seed, rank, targets=ALL, magnitude=0.2):
    r = np.random.default_rng(seed)
    shapes = adapters._target_shapes(T_CFG, targets)
    return {name: {"a": (r.standard_normal((T_CFG.n_layers, ind, rank)) / rank).astype(np.float32),
                   "b": (r.standard_normal((T_CFG.n_layers, rank) + out) * magnitude).astype(np.float32)}
            for name, (ind, out) in shapes.items()}


LORAS = {"t4": (make_lora(1, 4), 2.0), "t2": (make_lora(2, 2, ("wq", "wv")), 1.0)}


@pytest.fixture(scope="module")
def weights():
    j_params = jllama.init_params(J_CFG, jax.random.key(0))
    t_params = llama.Llama(T_CFG, device="cpu")
    t_params.load_state_dict(params_from_jax(jax.device_get(j_params)))
    return j_params, t_params


def store_pair(capacity=2, **kw):
    """A JAX store and the port's, the same tenants installed (or, with
    search_dir, loadable from it)."""
    j = jadapters.AdapterStore(J_CFG, capacity=capacity, rank=4, targets=ALL, dtype=jnp.float32, **kw)
    t = adapters.AdapterStore(T_CFG, capacity=capacity, rank=4, targets=ALL, device="cpu", **kw)
    if "search_dir" not in kw:
        for aid, (lora, scale) in LORAS.items():
            j.install(aid, lora, scale), t.install(aid, lora, scale)
    return j, t


_r = np.random.default_rng(7)
PROMPTS = [[256] + _r.integers(0, 256, n - 1).tolist() for n in (5, 23, 40, 9, 31, 17)]
TENANTS = [None, "t4", "t2", "t4", None, "t2"]


def run(engine, req_cls, prompts=PROMPTS, tenants=TENANTS, max_tokens=8):
    """Submit every request before start (a fixed schedule), then read each
    request's (tokens, finish reason)."""
    reqs = [engine.submit(req_cls(list(p), max_tokens=max_tokens, temperature=0.0, adapter=a))
            for p, a in zip(prompts, tenants)]
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


def ec(layout, **kw):
    return dict(max_batch=4, max_seq_len=64, max_prefill_len=16, eos_token_id=EOS, kv_layout=layout, **kw)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_mixed_tenant_batch_matches_jax_engine(weights, layout):
    """Base, t4 and t2 rows in one batch, chunked prompts included: the JAX
    engine's greedy tokens, synchronous and overlapped; the base rows an
    engine with no store's; every pin released at the end."""
    j_params, t_params = weights
    j_store, _ = store_pair()
    want = run(JEngine(J_CFG, j_params, JEngineConfig(overlap=False, **ec(layout)), adapters=j_store), JRequest)
    assert sum(len(t) == 8 for t, _ in want) >= 4  # most rows decode their whole budget (EOS ends the rest)
    for overlap in (False, None):
        _, store = store_pair()
        engine = Engine(T_CFG, t_params, EngineConfig(overlap=overlap, **ec(layout)), device="cpu", adapters=store)
        assert run(engine, Request) == want, overlap
        assert engine.stats["adapter_requests"] == 4 and engine.stats["prefill_chunks"] > 0
        assert store._refs == [0, 0, 0] and not engine.adapter_ids.any()
    plain = Engine(T_CFG, t_params, EngineConfig(**ec(layout)), device="cpu")
    base = [i for i, a in enumerate(TENANTS) if a is None]
    assert run(plain, Request, [PROMPTS[i] for i in base], [None] * len(base)) == [want[i] for i in base]


def test_prompt_lookup_spec_matches_jax_engine(weights):
    """Prompt-lookup speculation (spec_k 3) over a mixed-tenant batch on the
    paged pool: the verify rounds carry each row's adapter; the JAX spec
    engine's tokens."""
    j_params, t_params = weights
    prompts = [p + p[1:9] + p[1:5] for p in PROMPTS[:4]]  # repeats for the lookup to find
    tenants = ["t4", None, "t2", "t4"]
    j_store, store = store_pair()
    cfg = ec("paged", spec_k=3, spec_threshold=0.0)  # every greedy row proposes each round
    want = run(JEngine(J_CFG, j_params, JEngineConfig(overlap=False, **cfg), adapters=j_store), JRequest, prompts,
               tenants, max_tokens=12)
    engine = Engine(T_CFG, t_params, EngineConfig(overlap=False, **cfg), device="cpu", adapters=store)
    assert run(engine, Request, prompts, tenants, max_tokens=12) == want
    assert engine.stats["verify_passes"] > 3 and engine.stats["spec_proposed"] > 0


def test_tenant_matches_merged_weights(weights):
    """Each tenant through the store (indexed delta, scale folded into b)
    gives the greedy tokens of an engine on merge_lora(base, adapter)."""
    _, t_params = weights
    for aid, (lora, scale) in LORAS.items():
        mod = LoraAdapters([{n: {k: torch.from_numpy(lora[n][k][i]) for k in "ab"} for n in lora}
                            for i in range(T_CFG.n_layers)])
        merged = merge_lora(t_params, mod, scale)
        want = run(Engine(T_CFG, merged, EngineConfig(**ec("dense")), device="cpu"), Request, PROMPTS[:3],
                   [None] * 3)
        _, store = store_pair()
        got = run(Engine(T_CFG, t_params, EngineConfig(**ec("dense")), device="cpu", adapters=store), Request,
                  PROMPTS[:3], [aid] * 3)
        assert got == want, aid


def test_prefix_pages_never_cross_tenants(weights):
    """One 40-token prompt (two full pages) under the base, t4, t4 and the
    base, in turn: a tenant's first run reuses no page of the base's, its
    second reuses its own; the JAX engine's hit counts and tokens."""
    j_params, t_params = weights
    prompt = PROMPTS[2]
    outs, hits = [], []
    for cls, req_cls, kw in ((JEngine, JRequest, {}), (Engine, Request, {"device": "cpu"})):
        j_store, store = store_pair()
        params, cfg = (j_params, J_CFG) if cls is JEngine else (t_params, T_CFG)
        ecfg = (JEngineConfig if cls is JEngine else EngineConfig)(overlap=False, **ec("paged"))
        engine = cls(cfg, params, ecfg, adapters=j_store if cls is JEngine else store, **kw)
        engine.start()
        try:
            got, seen = [], []
            for aid in (None, "t4", "t4", None):
                req = engine.submit(req_cls(list(prompt), max_tokens=4, temperature=0.0, adapter=aid))
                toks = []
                while (tok := req.out.get(timeout=300)) is not None:
                    toks.append(tok)
                got.append(toks)
                seen.append(engine.stats["prefix_hit_tokens"])
        finally:
            engine.stop()
        outs.append(got)
        hits.append(seen)
    assert outs[0] == outs[1] and hits[0] == hits[1] == [0, 0, 32, 64]
    assert outs[1][0] == outs[1][3] and outs[1][1] == outs[1][2] and outs[1][0] != outs[1][1]


def test_hot_load_and_eviction_inside_the_engine(weights, tmp_path):
    """A store of capacity 1 over three artifacts in its search dir, nothing
    preloaded: requests in turn hot-load and evict (JAX's misses, hits and
    evictions), and four submitted together (two tenants, one slot) wait
    for the pinned slot to free: every token the JAX engine's."""
    j_params, t_params = weights
    for i, aid in enumerate(("a", "b", "c")):
        jadapters.save_adapter_artifact(str(tmp_path / aid), make_lora(10 + i, 4 - i), alpha=4.0, rank=4 - i)
    order = ["a", "b", "a", "a", "c"]
    results = []
    for cls, req_cls, kw in ((JEngine, JRequest, {}), (Engine, Request, {"device": "cpu"})):
        j_store, store = store_pair(capacity=1, search_dir=str(tmp_path))
        st = j_store if cls is JEngine else store
        params, cfg = (j_params, J_CFG) if cls is JEngine else (t_params, T_CFG)
        ecfg = (JEngineConfig if cls is JEngine else EngineConfig)(overlap=False, **ec("dense"))
        engine = cls(cfg, params, ecfg, adapters=st, **kw)
        engine.start()
        try:
            seq = [engine.generate(PROMPTS[0], max_tokens=4, adapter=aid) for aid in order]
            snap = st.snapshot()
        finally:
            engine.stop()
        engine = cls(cfg, params, ecfg, adapters=st, **kw)
        together = run(engine, req_cls, PROMPTS[:4], ["a", "b", "a", "b"], max_tokens=4)
        results.append((seq, snap, together, st.snapshot()))
    assert results[0] == results[1]
    seq, snap, together, after = results[1]
    assert snap == {"loaded": ["c"], "capacity": 1, "hits": 1, "misses": 4, "evictions": 3}
    assert seq[0] == seq[2] == seq[3] and seq[0] != seq[1] and all(f == "length" for _, f in together)


def test_preemption_drops_and_retakes_the_pin(weights):
    """On a 64-token pool, four long-running tenant requests: the youngest
    is preempted (its pin dropped) and resumed (the pin taken again); the
    JAX engine's tokens, no pin left at the end."""
    j_params, t_params = weights
    prompts = [PROMPTS[i][:12] for i in range(4)]
    tenants = ["t4", "t2", "t4", None]
    cfg = ec("paged", kv_pool_tokens=64)
    j_store, store = store_pair()
    want = run(JEngine(J_CFG, j_params, JEngineConfig(overlap=False, **cfg), adapters=j_store), JRequest, prompts,
               tenants, max_tokens=20)
    engine = Engine(T_CFG, t_params, EngineConfig(overlap=False, **cfg), device="cpu", adapters=store)
    assert run(engine, Request, prompts, tenants, max_tokens=20) == want
    assert engine.stats["preemptions"] > 0 and store._refs == [0, 0, 0]
    assert engine.stats["adapter_requests"] > 3  # a resumed tenant request acquires again


def test_unknown_and_vanished_adapters(weights, tmp_path):
    """submit() refuses an adapter the store cannot serve (and any adapter
    without a store) in the caller's thread; an artifact deleted between
    submit and admission ends its request as "error" and the engine serves
    the next; OPT takes no store (JAX's message)."""
    _, t_params = weights
    jadapters.save_adapter_artifact(str(tmp_path / "gone"), make_lora(20, 4), alpha=4.0, rank=4)
    _, store = store_pair(search_dir=str(tmp_path))
    engine = Engine(T_CFG, t_params, EngineConfig(**ec("dense")), device="cpu", adapters=store)
    with pytest.raises(adapters.UnknownAdapter):
        engine.submit(Request([256, 1, 2], adapter="nope"))
    with pytest.raises(adapters.UnknownAdapter):
        Engine(T_CFG, t_params, EngineConfig(**ec("dense")), device="cpu").submit(Request([256, 1], adapter="x"))
    req = engine.submit(Request([256, 1, 2], max_tokens=3, adapter="gone"))
    shutil.rmtree(tmp_path / "gone")
    engine.start()
    try:
        assert req.out.get(timeout=60) is None and req.finish_reason == "error"
        assert len(engine.generate([256, 5, 6], max_tokens=3)) == 3 and engine.error is None
    finally:
        engine.stop()
    ocfg = opt.CONFIGS["tiny-opt"].replace(dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="multi-tenant adapters unsupported for"):
        Engine(ocfg, opt.init_params(ocfg, seed=0, device="cpu"), EngineConfig(max_seq_len=64), device="cpu",
               adapters=adapters.AdapterStore(T_CFG, capacity=1, rank=2, device="cpu"))
