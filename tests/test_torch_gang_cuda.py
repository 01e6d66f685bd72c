"""A tensor-parallel gang on the card: two ranks of tools/gang_worker.py
on one card (gloo: NCCL refuses two ranks on one device), bf16, the
dense cache, and the kernels at a rank's shapes.

Every test here needs an NVIDIA card and skips without one. The file
imports only torch and the port, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda -rP tests/test_torch_gang_cuda.py

llama2-7b's vocabulary and head dim at a small width (dim 1024, 8 heads
and 8 kv heads of 128, 4 of each a rank, 2 layers), seeded and written as
an HF directory that each rank loads as its shard: the ranks' tokens are
equal, a sampled row's too, and every greedy token is within 5% of the
logit scale of the best logit of a single-process teacher-forced forward
of the whole model (the bf16 sum of two partial products rounds otherwise
than one product over the whole contraction). The flash forward, the
cached flash and the decode kernel at llama2-7b's rank of tensor=2 (16
heads and 16 kv heads of 128) hold against their plain versions. With four
cards, four ranks of tensor=4, one a card, run over NCCL.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from substratus_tpu_torch.models import llama
from substratus_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain
from substratus_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
    flash_cached_attention,
    flash_cached_attention_plain,
)

pytestmark = pytest.mark.cuda
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = llama.CONFIGS["llama2-7b"].replace(dim=1024, n_heads=8, n_kv_heads=8, hidden_dim=2816, n_layers=2)
ATOL = 2e-2  # bf16: the kernel and the plain version sum in another order


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no CPU mode")
    return torch.device("cuda")


def test_kernels_at_a_ranks_heads_match_plain(cuda):
    """H = KH = 16, D = 128: the flash forward over a 512-token bucket, the
    decode kernel at B=8 over 1024- and 2048-row caches, the cached flash
    over the third 512-token chunk of a 2048-row cache; each launches its
    kernel once and is within ATOL of its plain version."""
    gen = torch.Generator(device=cuda).manual_seed(22)
    q, k, v = (torch.randn((1, 512, 16, 128), generator=gen, device=cuda).to(torch.bfloat16) for _ in range(3))
    before = flash_attention.launches
    out = flash_attention(q, k, v, True)
    assert flash_attention.launches == before + 1
    assert (out.float() - flash_attention_plain(q, k, v, True).float()).abs().max().item() <= ATOL
    for s in (1024, 2048):
        qd = torch.randn((8, 1, 16, 128), generator=gen, device=cuda).to(torch.bfloat16)
        kc, vc = (torch.randn((8, 16, s, 128), generator=gen, device=cuda).to(torch.bfloat16) for _ in range(2))
        pos = torch.tensor([0, 1, 17, 255, 511, 700, 1000, s - 1], dtype=torch.int32, device=cuda)
        before = decode_attention.launches
        out = decode_attention(qd, kc, vc, pos)
        assert decode_attention.launches == before + 1
        assert (out.float() - decode_attention_plain(qd, kc, vc, pos).float()).abs().max().item() <= ATOL
    qc = torch.randn((1, 512, 16, 128), generator=gen, device=cuda).to(torch.bfloat16)
    kc, vc = (torch.randn((1, 16, 2048, 128), generator=gen, device=cuda).to(torch.bfloat16) for _ in range(2))
    pos = (1024 + torch.arange(512, device=cuda, dtype=torch.int32))[None]
    before = flash_cached_attention.launches
    out = flash_cached_attention(qc, kc, vc, pos)
    assert flash_cached_attention.launches == before + 1
    ref = flash_cached_attention_plain(qc, kc, vc, pos)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= ATOL


def _gang(tmp_path, world: int, params: dict, prompts, sampled: int):
    """`world` gang_worker ranks over the seeded HF directory in tmp_path,
    the prompts at once (24 tokens each, one sampled row); the whole
    model and each rank's result."""
    from substratus_tpu_torch import kernels
    from substratus_tpu_torch.tools.ckpt_writer import write_hf

    kernels.library()  # built once here, before the ranks load it
    model = llama.init_params(CFG, seed=0, device="cuda")
    write_hf(str(tmp_path / "model"), model)
    plan = {"concurrent": True, "requests": [
        {"prompt": p, "max_tokens": 24, "temperature": 0.8 if i == sampled else 0.0} for i, p in enumerate(prompts)]}
    (tmp_path / "plan.json").write_text(json.dumps(plan))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(world):
        env = {**os.environ, "PYTHONPATH": REPO, "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
               "JAX_NUM_PROCESSES": str(world), "TPU_WORKER_ID": str(rank)}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "substratus_tpu_torch.tools.gang_worker", "--model", str(tmp_path / "model"),
             "--params", json.dumps(params), "--requests", str(tmp_path / "plan.json"), "--out",
             str(tmp_path / f"r{rank}.json"), "--timeout", "120"],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=400)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * world, logs
    return model, [json.loads((tmp_path / f"r{r}.json").read_text()) for r in range(world)]


def _near_ties(model, prompts, rows) -> None:
    """Each greedy row's tokens within 5% of the logit scale of the best
    logit of the whole model's teacher-forced forward."""
    for prompt, toks in zip(prompts, rows):
        with torch.inference_mode():
            logits, _ = llama.forward(model, torch.tensor([prompt + toks[:-1]], device=model.device), CFG)
        logits = logits[0, len(prompt) - 1:]
        scale = logits.abs().max().item()
        gaps = logits.max(dim=-1).values - logits[torch.arange(len(toks)), torch.tensor(toks)]
        agree = sum(int(logits[i].argmax()) == t for i, t in enumerate(toks))
        print(f"{len(prompt)}-token prompt: {agree}/{len(toks)} the argmax, largest gap {gaps.max().item():.4g} at "
              f"logit scale {scale:.4g}")
        assert torch.isfinite(logits).all() and gaps.max().item() <= 0.05 * scale


def test_two_ranks_on_the_card_agree_and_hold_the_near_tie_rule(cuda, tmp_path):
    """Two gang_worker ranks on one card (gloo) over a seeded HF directory,
    four requests at once (one of 700 tokens: two chunks of 512) and one
    sampled row: the ranks' tokens are equal, and each greedy token is
    within 5% of the logit scale of the whole model's teacher-forced
    forward."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, CFG.vocab_size, n).tolist() for n in (16, 100, 700, 40, 60)]
    model, (r0, r1) = _gang(tmp_path, 2, {"tensor": 2, "kv_layout": "dense", "max_batch": 4, "max_seq_len": 1024},
                            prompts, sampled=4)
    got = [q["tokens"] for q in r0["requests"]]
    assert got == [q["tokens"] for q in r1["requests"]] and all(len(t) == 24 for t in got)
    assert r0["launches"]["decode_attention.launches"] > 0 and r0["launches"]["flash_cached_attention.launches"] > 0
    # The rule: gloo where the two ranks share a card, NCCL where each has its own.
    assert f"data backend {'gloo' if torch.cuda.device_count() == 1 else 'nccl'}" in r0["startup"]
    print(r0["startup"])
    _near_ties(model, prompts[:4], got[:4])


def test_four_ranks_on_four_cards_over_nccl(cuda, tmp_path):
    """One rank a card (needs four): the data backend is NCCL by the rule,
    tensor=4 (2 heads and 2 kv heads a rank), every rank's tokens equal, a
    sampled row's too, each greedy token by the near-tie rule."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards: one rank a card, over NCCL")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(3, CFG.vocab_size, n).tolist() for n in (16, 100, 700, 40, 60)]
    model, ranks = _gang(tmp_path, 4, {"tensor": 4, "kv_layout": "dense", "max_batch": 4, "max_seq_len": 1024},
                         prompts, sampled=4)
    got = [q["tokens"] for q in ranks[0]["requests"]]
    assert all([q["tokens"] for q in r["requests"]] == got for r in ranks[1:]) and all(len(t) == 24 for t in got)
    assert all(r["backend"] == "nccl" and r["device"] == f"cuda:{r['rank']}" for r in ranks), \
        [r["startup"] for r in ranks]
    print(ranks[0]["startup"])
    _near_ties(model, prompts[:4], got[:4])
