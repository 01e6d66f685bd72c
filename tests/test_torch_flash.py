"""The port's flash-attention forward (substratus_tpu_torch/ops/
flash_attention.py) against the JAX package's.

On the CPU the wrapper runs its plain version; it is held against JAX's
flash_attention in Pallas interpret mode (as tests/test_attention_kernels.py
runs it) and against dot_product_attention, float32, atol 1e-5 (another
summation order). The CUDA kernels themselves are held against the plain
version in tests/test_torch_kernels_cuda.py and
tests/test_torch_flash_fwd_cuda.py; here, which design each shape routes to.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substratus_tpu.ops.attention import dot_product_attention as j_dpa
from substratus_tpu.ops.flash_attention import flash_attention as j_flash
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.ops.attention import dot_product_attention
from substratus_tpu_torch.ops.flash_attention import flash_attention, flash_cached_design, flash_fwd_design


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread keeps torch's worker
    pool from spinning on cores that timing-sensitive tests share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(s, h, kh, b=1, d=32, seed=0):
    r = np.random.default_rng(seed)
    return tuple(
        r.standard_normal(shape).astype(np.float32)
        for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d))
    )


@pytest.mark.parametrize("s", [64, 100, 384])
@pytest.mark.parametrize("kh,causal", [(4, True), (2, True), (4, False), (2, False)],
                         ids=["mha-causal", "gqa-causal", "mha-full", "gqa-full"])
def test_flash_matches_jax(s, kh, causal):
    q, k, v = _qkv(s, 4, kh, seed=s)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = flash_attention(tq, tk, tv, causal, return_lse=True)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = j_flash(jq, jk, jv, causal, None, 64, 64, True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5)
    ref = j_dpa(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(
        out.numpy(), dot_product_attention(tq, tk, tv, causal=causal).numpy(), atol=1e-5)
    # LSE [B*H, Sq] against the logsumexp of the masked scores.
    g = 4 // kh
    scores = torch.einsum("bqhd,bshd->bhqs", tq, tk.repeat_interleave(g, dim=2)) * 32**-0.5
    if causal:
        scores = scores.masked_fill(torch.ones(s, s, dtype=torch.bool).triu(1), float("-inf"))
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(scores, -1).reshape(4, s).numpy(), atol=1e-5)


def test_flash_bf16_rounds_p_like_jax():
    """bf16 inputs: p is rounded to bf16 before the PV product, as in the
    TPU kernel; against JAX interpret mode within bf16 output rounding."""
    q, k, v = _qkv(128, 4, 2, seed=7)
    out = flash_attention(*(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)), True)
    want = j_flash(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), True, None, 64, 64, True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32), atol=2e-2)



def test_forward_designs_by_shape():
    """The forward kernels' designs by shape alone: the flash forward on
    wgmma (csrc/flash_fwd_wgmma.cu, 128 query rows a block) at head_dim
    64 and 128, which every model but the tiny test configs has, mma.sync
    (csrc/flash_fwd.cu, 64 rows) at 16 and 32; the cached flash likewise
    (csrc/flash_fwd_wgmma.cu or csrc/flash_cached.cu), whether the cache is
    bf16 or int8 (serve-int4's kv_cache_dtype)."""
    assert [flash_fwd_design(d) for d in (16, 32, 64, 128)] == ["mma", "mma", "wgmma", "wgmma"]
    assert [flash_cached_design(d) for d in (16, 32, 64, 128)] == ["mma", "mma", "wgmma", "wgmma"]
    for name, cfg in llama.CONFIGS.items():
        want = "mma" if name.startswith("tiny") and not name.startswith("tinyllama") else "wgmma"
        d = cfg.dim // cfg.n_heads
        assert flash_fwd_design(d) == want and flash_cached_design(d) == want, name
