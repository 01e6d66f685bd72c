"""A hot weight swap on the card's graph engine (Engine.swap_params): the
served weights are copied in place, so the captured decode step replays
the new weights with no new capture.

Every test here needs an NVIDIA card (the kernels are CUDA C++ for sm_90a
with no CPU mode) and skips without one. The file imports only torch and
the port, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda -rP tests/test_torch_swap_cuda.py

tinyllama-1.1b's widths at 2 layers, bf16 and int4 weights (the int4
matmul's packed values and scales swapped like any tensor), the paged
pool: after a swap to seed-1 weights the graph engine's greedy tokens are
an eager engine's on seed-1 weights token for token, the capture count
(stats["graph_warmups"], one a capture) and the graph object are
unchanged, and a swap back to seed 0 gives the first tokens again.
"""
import pytest
import torch

from substratus_tpu_torch.models import llama
from substratus_tpu_torch.serve.engine import Engine, EngineConfig

pytestmark = pytest.mark.cuda
CFG = llama.CONFIGS["tinyllama-1.1b"].replace(n_layers=2)
PROMPT = [1, 450, 4996, 17354, 1701, 29916, 432, 17204, 975, 278]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no CPU mode")
    return torch.device("cuda")


def _weights(seed: int, quantize: str):
    return llama.quantize_weights(llama.init_params(CFG, seed=seed, device="cuda"), quantize)


@pytest.mark.parametrize("quantize", ["none", "int4"])
def test_swap_follows_the_weights_with_no_new_capture(cuda, quantize):
    ec = EngineConfig(max_batch=4, max_seq_len=256, eos_token_id=CFG.vocab_size)  # no EOS: 24 tokens each
    engine = Engine(CFG, _weights(0, quantize), ec, device=cuda)
    eager = Engine(CFG, _weights(1, quantize), ec, device=cuda, decode_graph=False)
    engine.start()
    eager.start()
    try:
        first = engine.generate(PROMPT, max_tokens=24)
        graph, warmups = engine._graph, engine.stats["graph_warmups"]
        assert graph is not None and graph.graph is not None and warmups == 1
        assert engine.swap_params(_weights(1, quantize)) == 1
        swapped = engine.generate(PROMPT, max_tokens=24)
        want = eager.generate(PROMPT, max_tokens=24)
        assert engine.stats["graph_warmups"] == warmups and engine._graph is graph
        assert engine.stats["graph_replays"] >= 40
        assert swapped == want != first
        assert engine.swap_params(_weights(0, quantize), version=7) == 7
        assert engine.generate(PROMPT, max_tokens=24) == first
        assert engine.stats["graph_warmups"] == warmups and engine._graph is graph
        print(f"{quantize}: seed 0 {first[:8]}..., seed 1 {swapped[:8]}... (the eager engine's), seed 0 again; "
              f"{engine.stats['graph_replays']} replays of the one graph")
    finally:
        engine.stop()
        eager.stop()
