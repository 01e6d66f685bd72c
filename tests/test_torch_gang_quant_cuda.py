"""Quantized weights and a data axis in a gang on the card: four ranks of
tools/gang_worker.py on one card (gloo), int4, data=2 x tensor=2, and the
kernels at a rank's shapes.

Every test here needs an NVIDIA card and skips without one. The file
imports only torch and the port, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda -rP tests/test_torch_gang_quant_cuda.py

The int4 matmul at llama2-70b's per-rank shapes (tensor 2, and the
example's tensor 8) launches the design q4_design names, at a decode
step's 16 rows (max_batch 32 over data 2) and at a 512-row chunk, within
1e-2 of the largest value of its plain version. csrc/w8a8_quantize.cu's
row-parallel modes (a slice's row amax; the values from a given amax) are
bit for bit their plain versions. Four ranks at llama2-7b's vocabulary
and head dim at a small width (dim 1024, 8 heads and 8 kv heads of 128,
hidden 2816, 2 layers: a rank's wq is 512 columns, its w_gate 1408, its
w_down 1408 rows of whole groups; the decode steps' 4 rows a replica run
the decode design, the chunks the wgmma design) serve five requests at
once, one sampled: every rank's tokens are equal, and every greedy token
is within 5% of the logit scale of the best logit of a single-process
teacher-forced forward of the whole int4 model.
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
from substratus_tpu_torch.ops.quant import (w8a8_quantize, w8a8_quantize_plain, w8a8_quantize_scaled,
                                            w8a8_row_amax, w8a8_scaled_plain)
from substratus_tpu_torch.ops.quant4 import q4_design, q4_matmul, q4_matmul_plain, quantize4

pytestmark = pytest.mark.cuda
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = llama.CONFIGS["llama2-7b"].replace(dim=1024, n_heads=8, n_kv_heads=8, hidden_dim=2816, n_layers=2)
# (C, N) of llama2-70b's projections on a rank: tensor 2, then tensor 8
# (wq, wk/wv, w_gate/w_up, w_down, wo, the lm_head).
RANK_SHAPES = [(8192, 4096), (8192, 512), (8192, 14336), (14336, 8192), (4096, 8192), (8192, 16000),
               (8192, 1024), (8192, 128), (8192, 3584), (3584, 8192), (1024, 8192), (8192, 4000)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("m", [16, 512])
def test_int4_at_a_ranks_70b_shapes_matches_plain(cuda, m):
    """Each per-rank shape launches its design once and is within 1e-2 of
    the largest value of the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(24)
    for c, n in RANK_SHAPES:
        qt = quantize4(torch.randn((c, n), generator=gen, device=cuda) * c**-0.5, (0,))
        x = torch.randn((m, c), generator=gen, device=cuda).to(torch.bfloat16)
        design = q4_design(m, n, c, qt.block)
        before = getattr(q4_matmul, f"launches_{design}")
        out = q4_matmul(x, qt.packed, qt.scale, qt.block)
        assert getattr(q4_matmul, f"launches_{design}") == before + 1 and design == ("decode" if m <= 16 else "wgmma")
        ref = q4_matmul_plain(x, qt.packed, qt.scale, qt.block)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        assert torch.isfinite(out.float()).all() and err <= 1e-2 * ref.float().abs().max().item(), (m, c, n, err)


def test_w8a8_quantize_row_parallel_modes_are_bit_for_bit(cuda):
    """Mode 1 (a slice's row amax) equals the plain amax; mode 2 (the
    values from a given amax: another rank's larger max, a zero row) equals
    w8a8_scaled_plain, and with the row's own amax the one-launch mode."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    for m, c in ((8, 5504), (16, 14336), (512, 3584)):
        x = (torch.randn((m, c), generator=gen, device=cuda) * 3).to(torch.bfloat16)
        x[1] = 0
        counts = (w8a8_quantize.launches_amax, w8a8_quantize.launches_scaled)
        amax = w8a8_row_amax(x)
        assert torch.equal(amax, x.float().abs().amax(dim=-1, keepdim=True))
        wider = amax * 1.75
        wider[1] = 0
        got = w8a8_quantize_scaled(x, wider)
        want = w8a8_scaled_plain(x, wider)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (m, c)
        own = w8a8_quantize_scaled(x, amax)
        one = w8a8_quantize(x)
        plain = w8a8_quantize_plain(x)
        torch.cuda.synchronize()
        assert torch.equal(own[0], one[0]) and torch.equal(own[1], one[1]) and torch.equal(own[0], plain[0])
        assert (w8a8_quantize.launches_amax, w8a8_quantize.launches_scaled) == (counts[0] + 1, counts[1] + 2)


def test_four_ranks_int4_data2_tensor2_agree_and_hold_the_near_tie_rule(cuda, tmp_path):
    """Four gang_worker ranks on one card over a seeded HF directory loaded
    at int4 as each rank's shard: every rank's tokens equal (the sampled
    row's too), each greedy token by the near-tie rule against the whole
    int4 model, launches of both int4 designs on every rank."""
    from substratus_tpu_torch import kernels
    from substratus_tpu_torch.tools.ckpt_writer import write_hf

    kernels.library()  # built once here, before the ranks load it
    model = llama.init_params(CFG, seed=0, device="cuda")
    write_hf(str(tmp_path / "model"), model)
    llama.quantize_weights(model, "int4")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(3, CFG.vocab_size, n).tolist() for n in (16, 100, 700, 40, 60)]
    plan = {"concurrent": True, "requests": [
        {"prompt": p, "max_tokens": 24, "temperature": 0.8 if i == 4 else 0.0} for i, p in enumerate(prompts)]}
    (tmp_path / "plan.json").write_text(json.dumps(plan))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    params = {"kv_layout": "paged", "kv_cache_dtype": "int8", "max_batch": 7, "max_seq_len": 1024}
    procs = []
    for rank in range(4):
        env = {**os.environ, "PYTHONPATH": REPO, "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
               "JAX_NUM_PROCESSES": "4", "TPU_WORKER_ID": str(rank)}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "substratus_tpu_torch.tools.gang_worker", "--model", str(tmp_path / "model"),
             "--params", json.dumps(params), "--quantize", "int4", "--data", "2", "--requests",
             str(tmp_path / "plan.json"), "--out", str(tmp_path / f"r{rank}.json"), "--timeout", "120"],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=400)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * 4, logs
    ranks = [json.loads((tmp_path / f"r{r}.json").read_text()) for r in range(4)]
    print(ranks[0]["startup"])
    got = [q["tokens"] for q in ranks[0]["requests"]]
    assert all([q["tokens"] for q in r["requests"]] == got for r in ranks[1:]) and all(len(t) == 24 for t in got)
    assert ranks[0]["max_batch"] == 8 and [r["rows"] for r in ranks] == [[0, 4], [0, 4], [4, 8], [4, 8]]
    for r in ranks:
        assert r["launches"]["q4_matmul.launches_decode"] > 0 and r["launches"]["q4_matmul.launches_wgmma"] > 0
    for prompt, toks in zip(prompts[:4], got[:4]):
        with torch.inference_mode():
            logits, _ = llama.forward(model, torch.tensor([prompt + toks[:-1]], device=cuda), CFG)
        logits = logits[0, len(prompt) - 1:]
        scale = logits.abs().max().item()
        gaps = logits.max(dim=-1).values - logits[torch.arange(len(toks)), torch.tensor(toks)]
        agree = sum(int(logits[i].argmax()) == t for i, t in enumerate(toks))
        print(f"{len(prompt)}-token prompt: {agree}/{len(toks)} the argmax, largest gap {gaps.max().item():.4g} at "
              f"logit scale {scale:.4g}")
        assert torch.isfinite(logits).all() and gaps.max().item() <= 0.05 * scale
