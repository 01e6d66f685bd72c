"""The port's flash-attention backward kernels (csrc/flash_bwd_wgmma.cu at
head_dim 64 and 128, csrc/flash_bwd.cu at 16 and 32) on the card: dQ and
dK/dV against their plain PyTorch version, autograd through
the kernels against autograd through attn_impl="plain" on a small llama,
and the launch counts of a training step under remat.

Every test here needs an NVIDIA card (the kernels are CUDA C++ for sm_90a
with no CPU mode) and skips without one. The file imports only torch and
the port, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_bwd_cuda.py

Tolerances. dQ and dK/dV against the plain backward, which rounds p, ds
and the outputs to bf16 at the same places and sums in f32 in another
order: every output vector (a query row of dQ, a key's dK or dV, over D)
within BWD_ROW_REL of its own norm (or of 2^-8 of the RMS vector norm,
where that is larger: dQ of the first causal row is 0 up to rounding). Most vectors are bit-equal; a rounding
flip moves one by at most one bf16 ulp of one term (2^-8 to 2^-7 of a key
with a single query), while a dropped tile moves whole vectors (chip_smoke.py
checks that the limit rejects one). FlashAttention's gradients against
torch's autograd of the plain f32 forward, an independent path that keeps
the softmax in f32: every vector within AUTOGRAD_ROW_REL. Gradients of a
whole bf16 model through the kernels against attn_impl="plain": the cosine
over all gradients as one vector, and per tensor the cosine and the
relative (Frobenius) error, at the MODEL_* limits, set from the readings
of the seeds below (PERF.md); the difference in attention rounding passes
through every layer's backward. Each test prints its readings (pytest -rP).
"""
import math

import pytest
import torch

from substratus_tpu_torch.models import llama
from substratus_tpu_torch.ops.flash_attention import (
    bwd_delta, flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_bwd_plain,
    flash_attention_plain, flash_bwd_design)
from substratus_tpu_torch.train.lora import init_lora
from substratus_tpu_torch.train.trainer import TrainConfig, Trainer

pytestmark = pytest.mark.cuda
BWD_ROW_REL = 2**-6
AUTOGRAD_ROW_REL = 2**-4
MODEL_COS_ALL, MODEL_COS, MODEL_REL = 0.999, 0.99, 0.15


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no CPU mode")
    return torch.device("cuda")


def _close(name, out, ref, limit=BWD_ROW_REL):
    """The largest error of one output vector relative to its own norm, or
    to 2^-8 of the RMS vector norm where that is larger (a vector whose
    exact value is 0, as dQ of the first causal row, is rounding residue)."""
    g, r = out.float(), ref.float()
    norms = r.norm(dim=-1)
    den = torch.maximum(norms, norms.square().mean().sqrt() * 2**-8).clamp_min(torch.finfo(torch.float32).tiny)
    err = ((g - r).norm(dim=-1) / den).max().item()
    print(f"{name}: row error {err:.4g} (limit {limit:.4g})")
    assert torch.isfinite(g).all() and err <= limit, (name, err, limit)


@pytest.mark.parametrize("b,s,h,kh,d,causal", [
    (2, 256, 8, 8, 128, True), (2, 256, 8, 2, 128, True), (1, 1000, 4, 4, 128, True),
    (1, 65, 4, 2, 64, True), (1, 384, 4, 4, 128, False), (2, 100, 4, 2, 16, True), (1, 77, 4, 2, 32, False),
    (2, 1024, 32, 32, 128, True),  # one llama2-7b layer
    (2, 512, 32, 4, 64, True),  # tinyllama's heads: GQA 8, head_dim 64
])
def test_bwd_kernels_match_plain(cuda, b, s, h, kh, d, causal):
    """S=1000 and S=65 leave the last tile mostly masked (40 and 1 live
    rows): its p must be 0, never exp of a masked logit. Each call
    launches the design flash_bwd_design names."""
    gen = torch.Generator(device=cuda).manual_seed(s + kh + d)
    q, do = (torch.randn((b, s, h, d), generator=gen, device=cuda).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((b, s, kh, d), generator=gen, device=cuda).to(torch.bfloat16) for _ in range(2))
    out, lse = flash_attention(q, k, v, causal, return_lse=True)
    delta = bwd_delta(out, do)
    counters = [(fn, attr) for fn in (flash_attention_bwd_dq, flash_attention_bwd_dkv)
                for attr in ("launches", f"launches_{flash_bwd_design(d)}")]
    before = [getattr(fn, attr) for fn, attr in counters]
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
    assert [getattr(fn, attr) for fn, attr in counters] == [n + 1 for n in before]
    ref = flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        _close(name, got, want)


def test_autograd_function_matches_plain_autograd(cuda):
    """FlashAttention's gradients against autograd of the plain forward
    (an independent path: torch's own derivative of the f32 softmax)."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((2, 200, 8, 64), generator=gen, device=cuda).to(torch.bfloat16).requires_grad_()
    k, v = (torch.randn((2, 200, 4, 64), generator=gen, device=cuda).to(torch.bfloat16).requires_grad_()
            for _ in range(2))
    do = torch.randn((2, 200, 8, 64), generator=gen, device=cuda).to(torch.bfloat16)
    got = torch.autograd.grad(flash_attention(q, k, v, True), (q, k, v), do)
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(flash_attention_plain(qf, kf, vf, True), (qf, kf, vf), do.float())
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(name, g, w, AUTOGRAD_ROW_REL)


def _cos(a, b):
    a, b = a.float().flatten(), b.float().flatten()
    return (a @ b / (a.norm() * b.norm()).clamp(min=1e-30)).item()


@pytest.mark.parametrize("lora_rank", [4, 0])
def test_model_grads_through_kernels_match_plain(cuda, lora_rank):
    """One step's trainable gradients of a small bf16 llama (GQA 8/2,
    head_dim 64) through the kernels against attn_impl="plain", for three
    seeds of weights, adapters and tokens."""
    cfg = llama.CONFIGS["tiny"].replace(dim=512, n_heads=8, n_kv_heads=2, hidden_dim=1024, max_seq_len=512)
    readings = []
    for seed in (0, 1, 2):
        params = llama.init_params(cfg, seed=seed, device=cuda)
        gen = torch.Generator(device=cuda).manual_seed(seed + 1)
        tokens = torch.randint(0, cfg.vocab_size, (2, 300), generator=gen, device=cuda)
        lora = init_lora(cfg, seed=seed, rank=lora_rank, device=cuda) if lora_rank else None
        if lora is not None:
            with torch.no_grad():
                for layer in lora.layers:  # B = 0 at init would give A no gradient; small, as trained B is
                    for ab in layer.values():
                        ab["b"].copy_(torch.randn(ab["b"].shape, generator=gen, device=cuda) * 1e-2)
        trainable = list(lora.parameters()) if lora is not None else [p.requires_grad_() for p in params.parameters()]
        grads = []
        for impl in ("flash", "plain"):
            c = cfg.replace(attn_impl=impl)
            logits, _ = llama.forward(params, tokens, c, lora={"layers": lora.layers, "scale": 2.0} if lora else None,
                                      remat=True, train=True)
            loss = torch.nn.functional.cross_entropy(logits[:, :-1].flatten(0, 1), tokens[:, 1:].flatten())
            grads.append(torch.autograd.grad(loss, trainable))
        cos_all = _cos(torch.cat([g.flatten() for g in grads[0]]), torch.cat([w.flatten() for w in grads[1]]))
        worst_cos = min(_cos(g, w) for g, w in zip(*grads))
        worst_rel = max(((g.float() - w.float()).norm() / w.float().norm()).item() for g, w in zip(*grads))
        print(f"lora_rank={lora_rank} seed={seed}: cosine over all {cos_all:.6f} (limit {MODEL_COS_ALL}), worst "
              f"tensor cosine {worst_cos:.6f} (limit {MODEL_COS}), worst relative error {worst_rel:.4g} "
              f"(limit {MODEL_REL})")
        readings.append((cos_all, worst_cos, worst_rel))
    assert all(c >= MODEL_COS_ALL and w >= MODEL_COS and r <= MODEL_REL for c, w, r in readings), readings


def test_training_step_launch_counts(cuda):
    """One optimizer step of a LoRA Trainer with remat: the forward kernel
    twice a layer (forward and recompute), dQ and dK/dV once a layer."""
    cfg = llama.CONFIGS["tiny"].replace(dim=256, n_heads=4, n_kv_heads=4, n_layers=3, max_seq_len=256)
    trainer = Trainer(cfg, TrainConfig(lora_rank=4, remat=True, learning_rate=1e-3, total_steps=4), device=cuda)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 128)).numpy(),
             "weights": torch.ones((2, 128)).numpy()}
    trainer.train_step(batch)
    for fn in (flash_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv):
        fn.launches = 0
    loss = trainer.train_step(batch)
    torch.cuda.synchronize()
    L = cfg.n_layers
    assert (flash_attention.launches, flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches) == (
        2 * L, L, L)
    assert math.isfinite(loss)
