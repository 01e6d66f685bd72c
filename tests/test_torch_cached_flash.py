"""The port's cached flash attention (substratus_tpu_torch/ops/
flash_attention.py::flash_cached_attention) against the JAX package's
flash_cached_attention, run in Pallas interpret mode (block_q=8,
block_k=32), as the JAX package's own tests run it on the CPU.

On the CPU the wrapper runs its plain version, which follows the Pallas
_cached_kernel. float32 q, a chunk of queries at the positions the engine
gives a chunk (the padded tail clamped onto one position), against a
64-row cache: f32 and int8 caches, MHA-like (KH=2 of 4 heads) and MQA
(KH=1), with and without kv_length, and a ragged Sq (13, not a multiple
of 8). Tolerance 1e-5 (another summation order). The int8 result also
matches the f32 function on the dequantized cache at 1e-5. The CUDA
kernel itself is held against the plain version in
tests/test_torch_kernels_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substratus_tpu.ops.flash_attention import flash_cached_attention as j_cached
from substratus_tpu.ops.quant import quantize_kv as j_quantize_kv
from substratus_tpu_torch.ops.flash_attention import flash_cached_attention
from substratus_tpu_torch.ops.quant import dequantize_kv


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread keeps torch's worker
    pool from spinning on cores that timing-sensitive tests share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, H, SK, D = 2, 4, 64, 16


def _inputs(kh, sq, quantized, seed):
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, sq, H, D)).astype(np.float32)
    k = r.standard_normal((B, kh, SK, D)).astype(np.float32)
    v = r.standard_normal((B, kh, SK, D)).astype(np.float32)
    # Chunks at offsets 20 and 40; the last 3 rows are padding clamped
    # onto the one position past the real tokens, as the engine does.
    offsets = np.array([20, 40])[:, None]
    pos = np.minimum(offsets + np.arange(sq)[None, :], offsets + sq - 3).astype(np.int32)
    if not quantized:
        return q, k, v, pos, None, None
    kq, ks = (np.asarray(x) for x in j_quantize_kv(jnp.asarray(k)))
    vq, vs = (np.asarray(x) for x in j_quantize_kv(jnp.asarray(v)))
    return q, kq, vq, pos, ks[..., 0], vs[..., 0]


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _both(args, kv_length=None):
    got = flash_cached_attention(*map(_t, args), kv_length=_t(kv_length)).numpy()
    want = j_cached(*map(_j, args), kv_length=_j(kv_length), block_q=8, block_k=32, interpret=True)
    return got, np.asarray(want)


@pytest.mark.parametrize("case", ["chunk", "kv_length", "ragged"])
@pytest.mark.parametrize("kh", [1, 2])
@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_cached_flash_matches_jax(case, kh, quantized):
    sq = 13 if case == "ragged" else 16
    args = _inputs(kh, sq, quantized, seed=sq + kh)
    kv_length = np.array([25, 50], np.int32) if case == "kv_length" else None
    got, want = _both(args, kv_length)
    assert got.shape == (B, sq, H, D) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5)
    if quantized:
        q, kq, vq, pos, ks, vs = map(_t, args)
        k = dequantize_kv(kq, ks[..., None], torch.float32)
        v = dequantize_kv(vq, vs[..., None], torch.float32)
        deq = flash_cached_attention(q, k, v, pos, kv_length=_t(kv_length)).numpy()
        np.testing.assert_allclose(got, deq, atol=1e-5)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_zero_length_row_outputs_exactly_zero(quantized):
    """kv_length 0 gives every row of that batch a negative limit: the
    output is exactly 0, with no NaN, as the TPU kernel's guard gives."""
    args = _inputs(2, 16, quantized, seed=7)
    got, want = _both(args, np.array([30, 0], np.int32))
    assert np.all(got[1] == 0) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5)
