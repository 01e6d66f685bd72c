"""Multi-tenant adapters on the card (serve/adapters.py): the indexed LoRA
delta inside a CUDA graph replay against the same step run eagerly, and a
store slot written in place between replays (a hot load into an evicted
slot) read by the next replay with no new capture.

Every test here needs an NVIDIA card and skips without one. The file
imports only torch and the port, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda -rP tests/test_torch_adapters_cuda.py

Tolerance: the replay runs the very kernels and ops the eager call runs
on the same inputs, so outputs are compared bit for bit, and greedy tokens
exactly.
"""
import numpy as np
import pytest
import torch

from substratus_tpu_torch.models import llama
from substratus_tpu_torch.ops.basics import lora_delta_indexed
from substratus_tpu_torch.serve.adapters import AdapterStore
from substratus_tpu_torch.serve.decode_graph import DecodeGraph
from substratus_tpu_torch.serve.engine import Engine, EngineConfig, Request

pytestmark = pytest.mark.cuda
CFG = llama.LlamaConfig(vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=512,
                        max_seq_len=256)
ALL = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode graph and the kernels run only there")
    return torch.device("cuda")


def make_lora(seed, rank, targets=ALL, magnitude=0.5):
    from substratus_tpu_torch.serve.adapters import _target_shapes

    r = np.random.default_rng(seed)
    return {name: {"a": (r.standard_normal((CFG.n_layers, ind, rank)) / rank).astype(np.float32),
                   "b": (r.standard_normal((CFG.n_layers, rank) + out) * magnitude).astype(np.float32)}
            for name, (ind, out) in _target_shapes(CFG, targets).items()}


def test_indexed_delta_replay_sees_slot_written_in_place(cuda):
    """A graph of one indexed delta over the store's device tensors: each
    replay equals the eager call bit for bit; a new adapter installed into
    a slot and synced in place between replays is what the next replay
    reads, with the tensors' addresses unchanged and no second capture."""
    store = AdapterStore(CFG, capacity=2, rank=4, targets=("wq",), device=cuda)
    store.install("x", make_lora(1, 4, ("wq",)), 2.0)
    store.sync()
    ptr = store._dev_a["wq"].data_ptr()
    layer = store.device_tree()["layers"][0]["wq"]
    h = torch.randn(3, 1, CFG.dim, device=cuda).to(CFG.dtype)
    stats = {"graph_replays": 0, "graph_warmups": 0}

    def step(tokens, positions, temps, top_ps, adapter_ids):
        delta = lora_delta_indexed(h, layer, 1.0, "bsr,rhk->bshk", adapter_ids)
        return (delta.float().sum(dim=(1, 2, 3)) * 1000).to(torch.int32) + tokens.to(torch.int32)

    graph = DecodeGraph(step, 3, cuda, torch.Generator(device=cuda), stats, capture=True, adapters=True)
    zeros, ones = np.zeros(3, np.int64), np.ones(3, np.float32)
    ids = np.array([1, 0, 2], np.int64)
    read = graph.launch(zeros, zeros, ones, ones, np.ones(3, bool), adapter_ids=ids)
    first = read()
    eager = step(torch.zeros(3, dtype=torch.int64, device=cuda), None, None, None, torch.from_numpy(ids).to(cuda))
    assert first.tolist() == eager.tolist() and first[1] == 0  # the identity row adds nothing
    store.install("y", make_lora(2, 4, ("wq",)), 3.0)  # into slot 2, written in place at sync
    assert store.sync() == 1 and store._dev_a["wq"].data_ptr() == ptr
    second = graph.launch(zeros, zeros, ones, ones, np.ones(3, bool), adapter_ids=ids)()
    eager = step(torch.zeros(3, dtype=torch.int64, device=cuda), None, None, None, torch.from_numpy(ids).to(cuda))
    assert second.tolist() == eager.tolist() and second[2] != first[2] and second[0] == first[0]
    assert stats["graph_warmups"] == 1 and stats["graph_replays"] == 2


def test_engine_graph_equals_eager_step_with_hot_loads(cuda, tmp_path):
    """A bf16 llama on the dense cache (the kernels) with a store of
    capacity 1 over two artifacts: mixed base and tenant batches, each
    tenant hot-loaded into the one slot in turn. The graph engine's greedy
    tokens equal the eager synchronous engine's, request by request, and
    the graph is captured once."""
    from substratus_tpu_torch.serve.adapters import save_adapter_artifact

    for i, aid in enumerate(("p", "q")):
        save_adapter_artifact(str(tmp_path / aid), make_lora(10 + i, 4), alpha=8.0, rank=4)
    params = llama.init_params(CFG, seed=0, device=cuda)
    prompts = [[(5 * i + j) % 500 for j in range(n)] for i, n in enumerate((7, 40, 19, 70))]
    waves = [[None, "p", None, "p"], [None, "q", None, "q"], ["p", "p", None, None]]
    outs = []
    for graph, overlap in ((True, None), (False, False)):
        store = AdapterStore(CFG, capacity=1, rank=4, targets=ALL, device=cuda, search_dir=str(tmp_path))
        engine = Engine(CFG, params, EngineConfig(max_batch=4, max_seq_len=128, max_prefill_len=32,
                                                  eos_token_id=-1, kv_layout="dense", overlap=overlap),
                        decode_graph=graph, adapters=store)
        engine.start()
        try:
            got = []
            for wave in waves:
                reqs = [engine.submit(Request(list(p), max_tokens=8, adapter=a)) for p, a in zip(prompts, wave)]
                got.append([[t for t in iter(r.out.get, None)] for r in reqs])
        finally:
            engine.stop()
        print(f"graph={graph}: stats {engine.stats}, store {store.snapshot()}")
        assert store.snapshot()["misses"] == 3 and store.snapshot()["evictions"] == 2
        outs.append(got)
        if graph:
            assert engine.stats["graph_warmups"] == 1 and engine.stats["graph_replays"] > 0
    assert outs[0] == outs[1]
    # The base row is the same in waves 0 and 1; tenants p and q differ on one prompt.
    assert outs[0][0][0] == outs[0][1][0] and outs[0][0][1] != outs[0][1][1]
