"""Multi-tenant LoRA adapters (serve/adapters.py, ops/basics.py's indexed
delta, models/llama.py's adapter_ids) against the JAX package on the CPU.

The same numpy adapters (B random, so no delta is zero) go into the JAX
AdapterStore and the port's, in float32:

* the store: host buffers and device tensors of the same shapes, the
  identity slot zero, rank padding and the alpha/rank fold into b bit for
  bit the JAX store's; bad shapes and targets refused with JAX's
  messages; LRU evicting only unpinned slots, with JAX's hit, miss and
  eviction counts; the device tensors written in place by sync;
* artifacts: a JAX-written npz read by the port bit for bit and the
  port's npz read by JAX; the port trainer's adapters.pt served as it is;
  infer_store_shape over both formats;
* the model: lora_delta_indexed against JAX's (1e-6 of the output's
  scale: einsums summed in another order), and a mixed-tenant forward
  against the JAX forward on the same stacked adapters and against each
  row's plain (non-indexed) lora_delta forward;
* the bridge: a JAX store's tenants carried into the port's store.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substratus_tpu.models import llama as jllama
from substratus_tpu.ops import basics as jbasics
from substratus_tpu.serve import adapters as jadapters
from substratus_tpu_torch.bridge import adapter_layers_from_jax, adapter_store_from_jax, params_from_jax
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.observability.metrics import METRICS
from substratus_tpu_torch.ops import basics
from substratus_tpu_torch.serve import adapters
from substratus_tpu_torch.train.checkpoints import save_adapter_artifact as save_torch_adapter
from substratus_tpu_torch.train.lora import LoraAdapters

J_CFG = jllama.CONFIGS["tiny"].replace(vocab_size=258, dtype=jnp.float32)
T_CFG = llama.CONFIGS["tiny"].replace(vocab_size=258, dtype=torch.float32)
ALL = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
TOL = 1e-6


def make_lora(seed, rank, targets=ALL, magnitude=0.05):
    """{name: {"a": [L, in, r], "b": [L, r, *out]}} float32 numpy, B random."""
    r = np.random.default_rng(seed)
    shapes = adapters._target_shapes(T_CFG, targets)
    return {name: {"a": (r.standard_normal((T_CFG.n_layers, ind, rank)) / rank).astype(np.float32),
                   "b": (r.standard_normal((T_CFG.n_layers, rank) + out) * magnitude).astype(np.float32)}
            for name, (ind, out) in shapes.items()}


def stores(capacity=2, rank=4, targets=ALL, **kw):
    j = jadapters.AdapterStore(J_CFG, capacity=capacity, rank=rank, targets=targets, dtype=jnp.float32, **kw)
    t = adapters.AdapterStore(T_CFG, capacity=capacity, rank=rank, targets=targets, device="cpu", **kw)
    return j, t


def _same_host(j, t):
    for name in t._shapes:
        assert np.array_equal(j._a[name], t._a[name]) and np.array_equal(j._b[name], t._b[name]), name


def _device_is_host(t):
    for name in t._shapes:
        assert torch.equal(t._dev_a[name], torch.from_numpy(t._a[name]).to(t.dtype)), name
        assert torch.equal(t._dev_b[name], torch.from_numpy(t._b[name]).to(t.dtype)), name


def test_store_shapes_and_identity_slot():
    j, t = stores(capacity=3, rank=4)
    jt, tt = j.device_tree(), t.device_tree()
    assert tt["scale"] == jt["scale"] == 1.0 and len(tt["layers"]) == T_CFG.n_layers
    for name in ALL:
        for leaf in ("a", "b"):
            want = jt["layers"][name][leaf].shape  # [L, A, ...]
            assert tuple(t._dev_a[name].shape if leaf == "a" else t._dev_b[name].shape) == want
            assert tuple(tt["layers"][0][name][leaf].shape) == want[1:] and tt["layers"][0][name][leaf].dtype == \
                torch.float32
    assert t.n_slots == j.n_slots == 4 and not any(x.any() for x in t._dev_a.values())
    bf = adapters.AdapterStore(llama.CONFIGS["tiny"], capacity=1, rank=2, device="cpu")
    assert bf._dev_b["wq"].dtype == torch.bfloat16  # the model's dtype by default


def test_install_rank_padding_and_scale_fold_match_jax():
    """Two ranks below the store's (4 on every target, 2 on wq/wv), one at
    it: the host buffers the JAX store's bit for bit, the device tensors
    their cast after sync, with their addresses unchanged."""
    j, t = stores(capacity=3, rank=8)
    ptrs = {name: (t._dev_a[name].data_ptr(), t._dev_b[name].data_ptr()) for name in ALL}
    loras = [("t4", make_lora(1, 4), 2.0), ("t2", make_lora(2, 2, ("wq", "wv")), 0.5), ("t8", make_lora(3, 8), 1.0)]
    for aid, lora, scale in loras:
        assert t.install(aid, lora, scale) == j.install(aid, lora, scale)
    _same_host(j, t)
    assert not t._a["wk"][:, 2].any() and not t._a["wq"][:, 1, :, 4:].any()  # absent targets, padded ranks
    np.testing.assert_array_equal(t._b["wq"][:, 1, :4], loras[0][1]["wq"]["b"] * np.float32(2.0))
    assert t.sync() == 3 and t.sync() == 0
    _device_is_host(t)
    assert ptrs == {name: (t._dev_a[name].data_ptr(), t._dev_b[name].data_ptr()) for name in ALL}
    t.install("t4", make_lora(4, 4), 1.0)  # reinstall in place: one dirty slot
    j.install("t4", make_lora(4, 4), 1.0)
    _same_host(j, t)
    assert t._by_id["t4"] == 1 and t.sync() == 1
    _device_is_host(t)


def test_bad_shapes_and_targets_refused_as_jax():
    j, t = stores(capacity=2, rank=4, targets=("wq", "wv"))
    good = make_lora(5, 4, ("wq", "wv"))
    bad = [
        {"wq": good["wq"], "wo": make_lora(6, 4, ("wo",))["wo"]},  # a target outside the store's
        {"wq": {"a": good["wq"]["a"][:, :, :3], "b": good["wq"]["b"]}},  # a/b ranks differ
        {"wq": {"a": np.zeros((T_CFG.n_layers, T_CFG.dim, 6), np.float32),
                "b": np.zeros((T_CFG.n_layers, 6, T_CFG.n_heads, T_CFG.head_size), np.float32)}},  # rank above
        {"wv": {"a": good["wv"]["a"][:1], "b": good["wv"]["b"][:1]}},  # one layer
    ]
    for lora in bad:
        with pytest.raises(ValueError) as te:
            t.install("x", lora)
        with pytest.raises(ValueError) as je:
            j.install("x", lora)
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="non-empty"):
        t.install("", good)
    for cls in (adapters.AdapterStore, jadapters.AdapterStore):
        with pytest.raises(ValueError, match="unknown adapter target"):
            cls(T_CFG if cls is adapters.AdapterStore else J_CFG, targets=("wz",), **(
                {"device": "cpu"} if cls is adapters.AdapterStore else {}))
    moe = llama.CONFIGS["tiny-moe"]
    with pytest.raises(ValueError, match="expert-routed") as te:
        adapters._target_shapes(moe, ("w_up",))
    with pytest.raises(ValueError) as je:
        jadapters._target_shapes(jllama.CONFIGS["tiny-moe"], ("w_up",))
    assert str(te.value) == str(je.value)
    assert adapters._target_shapes(moe, ("wq",)) == jadapters._target_shapes(jllama.CONFIGS["tiny-moe"], ("wq",))


def test_lru_evicts_only_unpinned_slots_as_jax(tmp_path):
    """Capacity 2, three artifacts: hits, misses and evictions counted as
    the JAX store counts them, the LRU unpinned slot taken, and every slot
    pinned refused (AdapterCapacityError) in both."""
    for i in range(3):
        jadapters.save_adapter_artifact(str(tmp_path / f"a{i}"), make_lora(10 + i, 4), alpha=8.0, rank=4)
    j, t = stores(capacity=2, rank=4, search_dir=str(tmp_path))
    assert t.available_ids() == j.available_ids() == ["a0", "a1", "a2"]
    before = {k: (METRICS.get(f"substratus_serve_adapter_{k}_total") or 0)
              for k in ("cache_hits", "cache_misses", "evictions")}
    for store in (j, t):
        s0 = store.acquire("a0")
        s1 = store.acquire("a1")
        store.release(s0)  # a0 unpinned, the older one
        assert store.acquire("a1") == s1  # a hit
        assert store.acquire("a2") == s0  # a0 evicted, not the pinned a1
        with pytest.raises(adapters.AdapterCapacityError if store is t else jadapters.AdapterCapacityError):
            store.acquire("a0")  # both slots pinned
        store.release(s1), store.release(s1)
        assert store.acquire("a0") == s1  # a1 free now: evicted
        assert store.known("a1") and not store.known("nope")
    assert t.snapshot() == j.snapshot() == {"loaded": ["a0", "a2"], "capacity": 2, "hits": 1, "misses": 5,
                                            "evictions": 2}
    _same_host(j, t)
    moved = {k: (METRICS.get(f"substratus_serve_adapter_{k}_total") or 0) - v for k, v in before.items()}
    assert moved == {"cache_hits": 1, "cache_misses": 5, "evictions": 2}
    assert METRICS.get("substratus_serve_adapters_loaded") == 2
    with pytest.raises(adapters.UnknownAdapter) as e:
        t.acquire("nope")
    assert str(e.value) == "unknown adapter 'nope'"


def test_artifacts_round_trip_both_formats(tmp_path):
    """The contract's npz: JAX-written, read by the port bit for bit (and
    the port's read by JAX); the port trainer's adapters.pt loads into the
    store as its LoraAdapters hold it; the store shape inferred over
    both."""
    lora = make_lora(20, 4)
    jadapters.save_adapter_artifact(str(tmp_path / "j"), lora, alpha=16.0, rank=4, extra_meta={"base": "tiny"})
    layers, scale, meta = adapters.load_adapter_artifact(str(tmp_path / "j"))
    assert scale == 4.0 and meta["base"] == "tiny" and sorted(layers) == sorted(ALL)
    assert all(np.array_equal(layers[n][k], lora[n][k]) for n in ALL for k in "ab")
    adapters.save_adapter_artifact(str(tmp_path / "p"), lora, alpha=2.0, rank=4)
    jl, js, _ = jadapters.load_adapter_artifact(str(tmp_path / "p"))
    assert js == 0.5 and all(np.array_equal(jl[n][k], lora[n][k]) for n in ALL for k in "ab")

    small = make_lora(21, 2, ("wq", "wv"))
    mod = LoraAdapters([{n: {k: torch.from_numpy(small[n][k][i]).to(torch.bfloat16) for k in "ab"}
                         for n in small} for i in range(T_CFG.n_layers)])
    save_torch_adapter(str(tmp_path / "torch"), mod, alpha=4.0, rank=2)
    assert adapters.is_adapter_artifact(str(tmp_path / "torch")) and not adapters.is_adapter_artifact(str(tmp_path))
    tl, ts, tmeta = adapters.load_adapter_artifact(str(tmp_path / "torch"))
    assert ts == 2.0 and tmeta["format"] == adapters.TORCH_ADAPTER_FORMAT and sorted(tl) == ["wq", "wv"]
    for n in small:
        for k in "ab":
            want = np.stack([mod.layers[i][n][k].detach().float().numpy() for i in range(T_CFG.n_layers)])
            assert np.array_equal(tl[n][k], want)
    paths = [str(tmp_path / x) for x in ("j", "torch")]
    assert adapters.infer_store_shape(paths) == jadapters.infer_store_shape(paths[:1]) == (4, tuple(sorted(ALL)))
    assert adapters.infer_store_shape([str(tmp_path / "torch")]) == (2, ("wq", "wv"))
    assert adapters.infer_store_shape([]) == jadapters.infer_store_shape([]) == (8, ("wq", "wv"))
    store = adapters.AdapterStore(T_CFG, capacity=2, rank=4, device="cpu", search_dir=str(tmp_path))
    assert store.load("torch") == 1 and store.loaded_ids() == ["torch"]
    np.testing.assert_array_equal(store._b["wv"][:, 1, :2], tl["wv"]["b"] * np.float32(2.0))


@pytest.mark.parametrize("eq,out", [("bsr,rhk->bshk", (4, 16)), ("bsr,rd->bsd", (64,))])
def test_lora_delta_indexed_matches_jax(eq, out):
    r = np.random.default_rng(3)
    h = r.standard_normal((3, 5, 64)).astype(np.float32)
    a = r.standard_normal((4, 64, 8)).astype(np.float32)
    b = r.standard_normal((4, 8) + out).astype(np.float32)
    a[0], b[0] = 0, 0
    ids = np.array([2, 0, 3], np.int32)
    assert basics.batched_lora_einsum(eq) == jbasics.batched_lora_einsum(eq)
    got = basics.lora_delta_indexed(torch.from_numpy(h), {"a": torch.from_numpy(a), "b": torch.from_numpy(b)}, 0.5,
                                    eq, torch.from_numpy(ids))
    want = np.asarray(jbasics.lora_delta_indexed(jnp.asarray(h), {"a": jnp.asarray(a), "b": jnp.asarray(b)}, 0.5, eq,
                                                 jnp.asarray(ids)))
    assert got.shape == want.shape and np.abs(got.numpy() - want).max() <= TOL * max(1.0, np.abs(want).max())
    assert not got[1].any()  # the identity slot adds exactly nothing
    # Per row, the plain delta with that row's pair; bf16 adapters promote to f32.
    for i, slot in enumerate(ids):
        plain = basics.lora_delta(torch.from_numpy(h[i:i + 1]), {"a": torch.from_numpy(a[slot]),
                                                                 "b": torch.from_numpy(b[slot])}, 0.5, eq)
        torch.testing.assert_close(got[i:i + 1], plain, rtol=0, atol=1e-5)
    bf = {"a": torch.from_numpy(a).to(torch.bfloat16), "b": torch.from_numpy(b).to(torch.bfloat16)}
    assert basics.lora_delta_indexed(torch.from_numpy(h), bf, 1.0, eq, torch.from_numpy(ids)).dtype == torch.float32


def test_mixed_tenant_forward_matches_jax_and_plain_rows():
    """llama's forward with a store's tree and per-row ids: the JAX forward
    on the JAX store's tree within 1e-5 of the logit scale, each row the
    single-row forward through the plain lora_delta of its own adapter,
    the identity row the base model's exactly."""
    j_params = jllama.init_params(J_CFG, jax.random.key(0))
    params = llama.Llama(T_CFG, device="cpu")
    params.load_state_dict(params_from_jax(jax.device_get(j_params)))
    j, t = stores(capacity=2, rank=4)
    loras = {"t4": (make_lora(30, 4), 2.0), "t2": (make_lora(31, 2, ("wq", "wv")), 1.0)}
    for aid, (lora, scale) in loras.items():
        j.install(aid, lora, scale), t.install(aid, lora, scale)
    t.sync()
    tokens = np.random.default_rng(4).integers(0, 256, (3, 12)).astype(np.int32)
    ids = np.array([1, 0, 2], np.int32)
    want, _ = jllama.forward(j_params, jnp.asarray(tokens), J_CFG, lora=j.device_tree(), adapter_ids=jnp.asarray(ids))
    with torch.inference_mode():
        got, _ = llama.forward(params, torch.from_numpy(tokens), T_CFG, lora=t.device_tree(),
                               adapter_ids=torch.from_numpy(ids))
        base, _ = llama.forward(params, torch.from_numpy(tokens[1:2]), T_CFG)
        assert torch.equal(got[1:2], base)
        for row, aid in ((0, "t4"), (2, "t2")):
            lora, scale = loras[aid]
            tree = {"layers": [{n: {k: torch.from_numpy(lora[n][k][i]) for k in "ab"} for n in lora}
                               for i in range(T_CFG.n_layers)], "scale": scale}
            plain, _ = llama.forward(params, torch.from_numpy(tokens[row:row + 1]), T_CFG, lora=tree)
            torch.testing.assert_close(got[row:row + 1], plain, rtol=0, atol=1e-4)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert np.abs(got[0].numpy() - got[1].numpy()).max() > 1e-3  # the adapter moves the logits


def test_bridge_carries_jax_trees_and_stores():
    """adapter_layers_from_jax: a JAX bf16 LoRA tree as f32 numpy;
    adapter_store_from_jax: a JAX store's slots and ids into the port's."""
    from substratus_tpu.train import lora as jlora

    tree = jlora.init_lora(J_CFG, jax.random.key(2), rank=4, targets=("wq", "wo"))
    layers = adapter_layers_from_jax(jax.device_get(tree))
    assert layers["wo"]["a"].dtype == np.float32 and layers["wq"]["b"].shape == tuple(tree["wq"]["b"].shape)
    assert np.array_equal(layers["wq"]["a"], np.asarray(tree["wq"]["a"], np.float32))
    j, t = stores(capacity=2, rank=4)
    j.install("x", make_lora(40, 4), 2.0)
    j.install("y", make_lora(41, 3), 1.0)
    adapter_store_from_jax(j, t)
    _same_host(j, t)
    assert t.loaded_ids() == ["x", "y"] and t._by_id["y"] == j._by_id["y"]
    t.sync()
    _device_is_host(t)
    with pytest.raises(ValueError, match="store shapes differ"):
        adapter_store_from_jax(j, adapters.AdapterStore(T_CFG, capacity=3, rank=4, targets=ALL, device="cpu"))
