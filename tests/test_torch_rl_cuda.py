"""The RL loop on the card (substratus_tpu_torch/rl/): one actor engine
(the default: overlapped, the paged pool, the step a CUDA graph) and the
learner on one card, in bf16.

Needs an NVIDIA card and skips without one; imports only torch and the
port:

    python -m pytest --noconftest -m cuda -rP tests/test_torch_rl_cuda.py

The learner's snapshot has the served state dict's names, shapes and
dtypes (bf16), so every swap is accepted; after each round the actor
serves exactly the snapshot's values, no graph is captured again and the
scheduler thread is the one that started. A greedy probe through the actor
is held against a single-shot forward of those weights by the 5% rule
(bf16: the decode step and the single-shot forward round at other places).
"""
import numpy as np
import pytest
import torch

from substratus_tpu_torch.models import llama
from substratus_tpu_torch.rl import RLLearner, RLLoop
from substratus_tpu_torch.serve.engine import Engine, EngineConfig
from substratus_tpu_torch.train.trainer import TrainConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no CPU mode")
    return torch.device("cuda")


def test_three_rounds_on_the_card(cuda, tmp_path):
    cfg = llama.CONFIGS["llama2-7b"].replace(dim=1024, n_layers=2, n_heads=8, n_kv_heads=8, hidden_dim=2816)
    params = llama.init_params(cfg, seed=0, device=cuda)
    engine = Engine(cfg, params, EngineConfig(max_batch=8, max_seq_len=256, eos_token_id=2), device=cuda)
    assert engine.overlap and engine.decode_graph and engine.paged
    engine.start()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, cfg.vocab_size, int(rng.integers(8, 40))).tolist() for _ in range(8)]
    engine.generate(prompts[0], max_tokens=4, temperature=0.0)
    thread, captures = engine._thread, engine.stats["graph_warmups"]
    learner = RLLearner(cfg, TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=6), params=params,
                        device=cuda, batch_size=4, seq_len=64)
    snaps = []
    snapshot = learner.snapshot_params
    learner.snapshot_params = lambda: snaps.append(snapshot()) or snaps[-1]
    loop = RLLoop([engine], learner, prompts, lambda rec, p: float(len(rec["tokens"])), str(tmp_path),
                  max_tokens=16, temperature=0.9)
    try:
        for rnd in range(3):
            rep = loop.run_round()
            assert rep["episodes"] == 8 and rep["gen"]["errors"] == 0 and rep["weights_version"] == rnd + 1
            assert len(rep["losses"]) == 2 and np.isfinite(rep["losses"]).all()
            served = engine.params.state_dict()
            assert all(v.dtype == served[k].dtype and torch.equal(served[k].cpu(), v) for k, v in snaps[-1].items())
            probe = prompts[1]
            toks = engine.generate(probe, max_tokens=12, temperature=0.0)
            with torch.inference_mode():
                logits, _ = llama.forward(engine.params, torch.tensor([probe + toks[:-1]], device=cuda), cfg)
            logits = logits[0, len(probe) - 1:]
            gaps = logits.max(dim=-1).values - logits[torch.arange(len(toks)), torch.tensor(toks)]
            assert gaps.max().item() <= 0.05 * logits.abs().max().item()
        assert engine._thread is thread and thread.is_alive() and engine.error is None
        assert engine.stats["graph_warmups"] == captures
        assert not torch.equal(snaps[0]["layers.0.wq"], snaps[-1]["layers.0.wq"])
    finally:
        engine.stop()
