"""The port's flash-attention backward (substratus_tpu_torch/ops/
flash_attention.py) against the JAX package's.

On the CPU the backward wrappers run their plain version. It is held
against JAX's _flash_backward in Pallas interpret mode (the same numpy q,
k, v, dO; out and LSE from JAX's _flash_forward), and FlashAttention's
autograd against jax.vjp of flash_attention(q, k, v, causal, None, 64, 64,
True), as tests/test_attention_kernels.py runs it: MHA and GQA, causal and
not, S a multiple of 64 or not. float32 within 1e-5 (another summation
order); bf16 inputs within 2e-2 of the largest gradient (ds and p rounded
to bf16 at the same places; the output rounding and summation order
differ). The CUDA kernels are held against the plain version in
tests/test_torch_kernels_bwd_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substratus_tpu.ops.flash_attention import _flash_backward, _flash_forward
from substratus_tpu.ops.flash_attention import flash_attention as j_flash
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.ops.flash_attention import (
    FlashAttention, flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_bwd_plain,
    flash_bwd_design)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread keeps torch's worker
    pool from spinning on cores that timing-sensitive tests share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(s, h, kh, b=2, d=32, seed=0):
    r = np.random.default_rng(seed)
    return tuple(r.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d), (b, s, h, d)))


def _jax_bwd(q, k, v, do, causal, dtype):
    """(out, lse [B*H, Sq], dq, dk, dv) of the JAX package's Pallas kernels
    in interpret mode."""
    jq, jk, jv, jdo = (jnp.asarray(x, dtype) for x in (q, k, v, do))
    scale = q.shape[-1] ** -0.5
    out, lse = _flash_forward(jq, jk, jv, scale, causal, 64, 64, True)
    grads = _flash_backward(jq, jk, jv, out, lse, jdo, scale, causal, 64, 64, True)
    return (out, lse[:, :, 0], *grads)


def _np(x):
    return np.array(x, np.float32)  # a writable copy for torch.from_numpy


@pytest.mark.parametrize("s,kh,causal", [(128, 4, True), (128, 2, True), (96, 2, True), (96, 4, False),
                                         (128, 2, False)],
                         ids=["mha-causal", "gqa-causal", "gqa-causal-96", "mha-full-96", "gqa-full"])
def test_backward_matches_jax(s, kh, causal):
    q, k, v, do = _inputs(s, 4, kh, seed=s + kh)
    out, lse, *want = _jax_bwd(q, k, v, do, causal, jnp.float32)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    got = flash_attention_bwd_plain(t[0], t[1], t[2], torch.from_numpy(_np(out)), torch.from_numpy(_np(lse)),
                                    t[3], causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-5)

    # Autograd through FlashAttention against jax.vjp of the custom_vjp.
    tq, tk, tv = (x.clone().requires_grad_() for x in t[:3])
    o = flash_attention(tq, tk, tv, causal)
    assert isinstance(o.grad_fn, FlashAttention._backward_cls)
    got = torch.autograd.grad(o, (tq, tk, tv), t[3])
    _, vjp = jax.vjp(lambda a, b, c: j_flash(a, b, c, causal, None, 64, 64, True), *map(jnp.asarray, (q, k, v)))
    for g, w in zip(got, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-5)


def test_bf16_backward_matches_jax():
    """bf16 inputs: ds and p rounded to bf16 before their products, as in
    the TPU kernels; dq/dk/dv in the input dtype."""
    q, k, v, do = _inputs(128, 4, 2, seed=3)
    out, lse, *want = _jax_bwd(q, k, v, do, True, jnp.bfloat16)
    t = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do)]
    got = flash_attention_bwd_plain(t[0], t[1], t[2], torch.from_numpy(_np(out)).to(torch.bfloat16),
                                    torch.from_numpy(_np(lse)), t[3], True)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        w = _np(w)
        np.testing.assert_allclose(g.float().numpy(), w, atol=2e-2 * max(1.0, np.abs(w).max()))


def test_serving_path_runs_the_forward_only():
    """Without autograd recording, flash_attention returns a plain output
    (no graph, no LSE); the backward wrappers count nothing on the CPU."""
    q, k, v, _ = (torch.from_numpy(x).requires_grad_() for x in _inputs(64, 4, 2))
    with torch.inference_mode():
        out = flash_attention(q, k, v)
    assert out.grad_fn is None and not out.requires_grad
    with pytest.raises(ValueError, match="return_lse"):
        flash_attention(q, k, v, return_lse=True)
    before = (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches)
    flash_attention(q, k, v).sum().backward()
    assert (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches) == before
    assert q.grad is not None and k.grad.shape == k.shape


def test_backward_design_by_head_dim():
    """The backward kernels' design by head_dim alone: wgmma
    (csrc/flash_bwd_wgmma.cu) at 64 and 128, which every model but the
    tiny test configs has; mma.sync (csrc/flash_bwd.cu) at 16 and 32."""
    assert [flash_bwd_design(d) for d in (16, 32, 64, 128)] == ["mma", "mma", "wgmma", "wgmma"]
    for name, cfg in llama.CONFIGS.items():
        want = "mma" if name.startswith("tiny") and not name.startswith("tinyllama") else "wgmma"
        assert flash_bwd_design(cfg.dim // cfg.n_heads) == want, name
