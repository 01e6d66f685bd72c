"""The port's paged KV cache against the JAX package's, on the CPU.

* ops/kvcache.py::paged_update_and_read against substratus_tpu's on the
  same seeded pool, block table, positions and entries, in float32, bf16
  and int8: the pool after the write equal bit for bit (int8 entries and
  their f32 scales too), the gathered context exact, a write past the
  block table's reach landing in the trash page 0 and nowhere else. No
  two writes share a flat index, since duplicates write in an unspecified
  order in both packages;
* serve/paged_kv.py (the port's copy) against the JAX module: one
  sequence of operations gives the same page ids, refcounts, hits, misses
  and evictions;
* models/llama.py's forward with a block table (a prompt chunk, then
  decode steps through the same pages) against JAX's, float32 tiny
  config, logits within the model tests' atol/rtol 1e-4, on a model-dtype
  and an int8 pool.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substratus_tpu.models import llama as jllama
from substratus_tpu.ops import kvcache as jkv
from substratus_tpu.serve import paged_kv as jpk
from substratus_tpu_torch.bridge import params_from_jax
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.ops import kvcache
from substratus_tpu_torch.serve import paged_kv

L, P, BS, KH, HD = 1, 9, 4, 2, 8  # a pool of 9 pages (page 0 the trash page) of 4 tokens
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.float32, torch.float32)}


def _np(x):
    return np.asarray(x.astype(jnp.float32)) if x.dtype == jnp.bfloat16 else np.asarray(x)


def _t(x):
    return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_update_and_read_matches_jax(name):
    """A block table of 3 pages a row. Row 0 writes a chunk at positions
    2..6 and one past its reach (12); row 1 four decode-like writes and two
    past its reach (13, 14); row 2 is idle (its row all zeros) and writes
    position 3 mod 4 six times, into the trash page's offset 3, the one
    flat index written twice, which no comparison reads. Every other pool
    entry keeps its seeded value."""
    jdt, tdt = DTYPES[name]
    quantized = name == "int8"
    r = np.random.default_rng(1)
    pool = jkv.init_paged_cache(L, P, BS, KH, HD, jdt, quantized=quantized)
    # Seeded contents everywhere, so that the gather of stale pages is held too.
    seeded = {key: r.integers(-127, 128, a.shape).astype(np.int8) if a.dtype == jnp.int8
              else r.uniform(0.01 if "scale" in key else -1, 1, a.shape).astype(np.float32)
              for key, a in pool.items()}
    j_layer = {key: jnp.asarray(v[0], pool[key].dtype) for key, v in seeded.items()}
    t_layer = {key: torch.from_numpy(v[0].copy()).to(torch.int8 if v.dtype == np.int8 else
                                             (torch.float32 if "scale" in key else tdt)) for key, v in seeded.items()}
    table = np.array([[3, 5, 1], [2, 7, 4], [0, 0, 0]], np.int64)
    positions = np.array([[2, 3, 4, 5, 6, 12], [9, 10, 11, 8, 13, 14], [3, 3, 7, 7, 11, 11]], np.int64)
    k_new = r.standard_normal((3, 6, KH, HD)).astype(np.float32)
    v_new = r.standard_normal((3, 6, KH, HD)).astype(np.float32)
    j_out, jk, jv = jkv.paged_update_and_read(j_layer, jnp.asarray(table, jnp.int32), jnp.asarray(positions, jnp.int32),
                                              jnp.asarray(k_new, jdt), jnp.asarray(v_new, jdt), jdt)
    t_out, tk, tv = kvcache.paged_update_and_read(t_layer, torch.from_numpy(table), torch.from_numpy(positions),
                                                  torch.from_numpy(k_new).to(tdt), torch.from_numpy(v_new).to(tdt),
                                                  tdt)
    assert t_out is t_layer  # written in place
    writes = [(0 if p // BS >= 3 else int(table[b, p // BS]), int(p % BS)) for b in range(3) for p in positions[b]]
    assert writes.count((0, 3)) == 6 and len(set(writes) - {(0, 3)}) == len(writes) - 6
    assert {(0, 0), (0, 1), (0, 2)} <= set(writes)  # rows 0 and 1 past their reach: the trash page
    untouched = np.array([[(pg, o) not in writes for o in range(BS)] for pg in range(P)])
    held = np.ones((P, BS), bool)
    held[0, 3] = False
    for key in t_layer:
        got, want = _t(t_layer[key]), _np(j_out[key])
        np.testing.assert_array_equal(got[held], want[held], err_msg=key)
        seed = seeded[key][0]
        if tdt == torch.bfloat16 and key in ("k", "v"):
            seed = _t(torch.from_numpy(seed).to(torch.bfloat16))
        np.testing.assert_array_equal(got[untouched], seed[untouched], err_msg=key)
        assert (got[0, :3] != seed[0, :3]).any(), key
    assert tk.shape == (3, 3 * BS, KH, HD) and tk.dtype == tdt
    # Row 2's context is page 0 three times; its offset 3 is the duplicate.
    ctx = np.ones((3, 3 * BS), bool)
    ctx[2, 3::BS] = False
    for got, want in ((tk, jk), (tv, jv)):
        np.testing.assert_array_equal(_t(got)[ctx], _np(want)[ctx])
    if quantized:
        assert t_layer["k"].dtype == torch.int8 and t_layer["k_scale"].shape == (P, BS, KH, 1)


def test_init_paged_cache_matches_jax():
    for quantized in (False, True):
        want = jkv.init_paged_cache(2, P, BS, KH, HD, jnp.bfloat16, quantized=quantized)
        got = kvcache.init_paged_cache(2, P, BS, KH, HD, torch.bfloat16, quantized=quantized, device="cpu")
        assert sorted(got) == sorted(want)
        for key in got:
            assert tuple(got[key].shape) == want[key].shape
            assert str(got[key].dtype).removeprefix("torch.") == str(want[key].dtype)
            np.testing.assert_array_equal(_t(got[key]), _np(want[key]))
    cfg = llama.CONFIGS["tiny"]
    pool = llama.init_paged_cache(cfg, 5, 16, dtype=torch.int8, device="cpu")
    assert pool["k"].shape == (cfg.n_layers, 5, 16, cfg.n_kv_heads, cfg.head_size) and "v_scale" in pool
    assert llama.SUPPORTS_PAGED and jllama.SUPPORTS_PAGED


def _allocator_ops(mod):
    """One sequence of allocator operations; returns everything it observed."""
    a = mod.PageAllocator(5, first_page=1)
    seen = [a.alloc() for _ in range(6)]  # the sixth finds it dry
    a.incref(seen[1])
    a.decref(seen[1])
    a.decref(seen[3])
    a.decref(seen[0])
    seen += [a.free_pages, a.used_pages, a.alloc(), a.alloc(), a.alloc(), a.refs(seen[1]), a.refs(seen[3])]
    return seen


def _registry_ops(mod):
    """Register, match (partial, full, forged, salted), evict under
    max_entries and LRU order; returns ids, hits, misses and free pages
    after each step."""
    a = mod.PageAllocator(12, first_page=1)
    reg = mod.PrefixRegistry(a, max_entries=4)
    seen = []
    toks = list(range(40))
    e = mod.chain_entries(toks, 8)  # 5 full pages
    pids = [a.alloc() for _ in range(5)]
    reg.register(e[:3], pids[:3])
    seen += [reg.match(e), reg.match(e[:2]), reg.match(mod.chain_entries([9] + toks[1:], 8))]
    reg.claim(seen[0])
    reg.register(e, pids)  # the fifth entry evicts the LRU one (max_entries 4)
    seen += [len(reg), a.free_pages, reg.hits, reg.misses]
    seen += [reg.match(mod.chain_entries(toks, 8, salt="tenant-a")), reg.match(e)]
    seen += [reg.evict_lru(), reg.evict_lru(), len(reg), a.free_pages]
    for pid in pids + seen[0]:
        a.decref(pid) if a.refs(pid) else None
    seen += [a.free_pages, reg.evict_lru(), reg.evict_lru(), reg.evict_lru(), a.free_pages]
    slots = mod.SlotPages(2)
    slots.assign(1, [a.alloc()], [a.alloc(), a.alloc()])
    slots.append(1, a.alloc())
    seen += [slots.pages[1], slots.shared[1]]
    slots.release(1, a)
    seen += [slots.pages[1], a.free_pages]
    return seen


@pytest.mark.parametrize("ops", [_allocator_ops, _registry_ops])
def test_bookkeeping_matches_jax(ops):
    assert ops(paged_kv) == ops(jpk)
    toks = [1, 2, 3, 4, 5, 6, 7]
    assert paged_kv.chain_entries(toks, 2) == jpk.chain_entries(toks, 2)
    assert paged_kv.chain_entries(toks, 3, salt=7) == jpk.chain_entries(toks, 3, salt=7)


J_CFG = jllama.CONFIGS["tiny"].replace(vocab_size=258, dtype=jnp.float32)
T_CFG = llama.CONFIGS["tiny"].replace(vocab_size=258, dtype=torch.float32)


@pytest.fixture(scope="module")
def weights():
    j_params = jllama.init_params(J_CFG, jax.random.key(0))
    t_params = llama.Llama(T_CFG, device="cpu")
    t_params.load_state_dict(params_from_jax(jax.device_get(j_params)))
    return j_params, t_params


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_forward_through_block_table_matches_jax(weights, kv):
    """Two rows on one pool of 16 pages of 8: a 20-token chunk (bucket 32,
    the padded tail clamped onto position 20) through rows of 4 pages, then
    6 decode steps; logits of every real token, and the pool's pages that
    real tokens wrote."""
    j_params, t_params = weights
    r = np.random.default_rng(3)
    bs, m = 8, 4
    table = np.array([[4, 9, 2, 11], [7, 1, 15, 6]], np.int64)
    jdt = jnp.int8 if kv == "int8" else None
    j_pool = jllama.init_paged_cache(J_CFG, 16, bs, dtype=jdt)
    t_pool = llama.init_paged_cache(T_CFG, 16, bs, dtype=torch.int8 if kv == "int8" else None, device="cpu")
    tokens = r.integers(0, 258, (2, 32))
    positions = np.minimum(np.arange(32), 20)[None].repeat(2, 0)
    j_logits, j_pool = jllama.forward(j_params, jnp.asarray(tokens, jnp.int32), J_CFG,
                                      positions=jnp.asarray(positions, jnp.int32), cache=j_pool,
                                      block_table=jnp.asarray(table, jnp.int32))
    with torch.inference_mode():
        t_logits, out = llama.forward(t_params, torch.from_numpy(tokens), T_CFG, positions=torch.from_numpy(positions),
                                      cache=t_pool, block_table=torch.from_numpy(table))
    assert out is t_pool
    np.testing.assert_allclose(t_logits[:, :20].numpy(), np.asarray(j_logits[:, :20]), atol=1e-4, rtol=1e-4)
    pos = np.array([20, 20])
    tok = np.argmax(np.asarray(j_logits[:, 19]), -1)
    for _ in range(6):
        jl, j_pool = jllama.forward(j_params, jnp.asarray(tok[:, None], jnp.int32), J_CFG,
                                    positions=jnp.asarray(pos[:, None], jnp.int32), cache=j_pool,
                                    block_table=jnp.asarray(table, jnp.int32))
        with torch.inference_mode():
            tl, _ = llama.decode_step(t_params, t_pool, torch.from_numpy(tok), torch.from_numpy(pos), T_CFG,
                                      block_table=torch.from_numpy(table))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl[:, 0]), atol=1e-4, rtol=1e-4)
        tok, pos = np.argmax(np.asarray(jl[:, 0]), -1), pos + 1
    written = [(int(table[b, p // bs]), p % bs) for b in range(2) for p in range(26)]
    for key in t_pool:
        got, want = t_pool[key].numpy(), np.asarray(j_pool[key])
        for page, off in written:
            np.testing.assert_allclose(got[:, page, off], want[:, page, off], atol=1e-5)
