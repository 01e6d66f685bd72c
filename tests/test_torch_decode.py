"""The port's decode attention over the dense slot cache (substratus_tpu_torch/
ops/decode_attention.py) against the JAX package's.

On the CPU the wrapper runs its plain version, which follows the Pallas
_kernel (q scaled in f32, p kept f32): it is held against
decode_attention(impl="pallas", interpret=True) and impl="xla", float32 and
int8 with scales, atol 1e-5 (another summation order). The JAX _xla path
scales q in the model dtype and rounds p to it, so in bf16 it agrees with
the kernel only to bf16 rounding; in f32 the two are the same function.
The CUDA kernel itself is held against the plain version in
tests/test_torch_kernels_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substratus_tpu.ops import decode_attention as jdec
from substratus_tpu.ops.quant import quantize_kv as j_quantize_kv
from substratus_tpu_torch.ops import decode_attention as tdec


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread keeps torch's worker
    pool from spinning on cores that timing-sensitive tests share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LAYOUTS = {"mha": 4, "gqa": 2, "mqa": 1}  # kv heads for 4 query heads


def _inputs(kh, s=48, b=3, h=4, d=32, seed=0, quantized=False):
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, 1, h, d)).astype(np.float32)
    k = r.standard_normal((b, kh, s, d)).astype(np.float32)
    v = r.standard_normal((b, kh, s, d)).astype(np.float32)
    pos = np.array([0, s // 2, s - 1][:b], np.int32)
    if not quantized:
        return q, k, v, pos, None, None
    kq, ks = (np.asarray(x) for x in j_quantize_kv(jnp.asarray(k)))
    vq, vs = (np.asarray(x) for x in j_quantize_kv(jnp.asarray(v)))
    return q, kq, vq, pos, ks[..., 0], vs[..., 0]


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_decode_matches_jax(layout):
    """f32 and int8 caches, against the Pallas kernel and the XLA path."""
    for quantized in (False, True):
        args = _inputs(LAYOUTS[layout], quantized=quantized, seed=len(layout))
        got = tdec.decode_attention(*map(_t, args)).numpy()
        for impl, extra in (("pallas", {"interpret": True, "block_s": 16}), ("xla", {})):
            want = jdec.decode_attention(*map(_j, args), impl=impl, **extra)
            np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, err_msg=f"{impl} int8={quantized}")


def test_decode_empty_and_full_rows():
    """pos < 0 attends nothing (output 0); pos >= S attends every row."""
    q, k, v, _, _, _ = _inputs(2, s=16)
    pos = np.array([-1, 40, 3], np.int32)
    got = tdec.decode_attention(*map(_t, (q, k, v, pos))).numpy()
    assert np.all(got[0] == 0)
    want = jdec.decode_attention(*map(_j, (q, k, v, pos)), impl="pallas", interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


def _layer_cache(kh, s, b, d, quantized, seed):
    r = np.random.default_rng(seed)
    k = r.standard_normal((b, kh, s, d)).astype(np.float32)
    v = r.standard_normal((b, kh, s, d)).astype(np.float32)
    if not quantized:
        return {"k": k, "v": v}
    kq, ks = (np.asarray(x) for x in j_quantize_kv(jnp.asarray(k)))
    vq, vs = (np.asarray(x) for x in j_quantize_kv(jnp.asarray(v)))
    return {"k": kq, "v": vq, "k_scale": ks[..., 0], "v_scale": vs[..., 0]}


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("sn,with_len", [(1, False), (4, False), (4, True)],
                         ids=["decode", "chunk", "chunk-kvlen"])
def test_update_cache_and_attend_matches_jax(sn, with_len, quantized):
    b, kh, h, s, d = 2, 2, 4, 24, 16
    cache = _layer_cache(kh, s, b, d, quantized, seed=sn)
    r = np.random.default_rng(10 + sn)
    q = r.standard_normal((b, sn, h, d)).astype(np.float32)
    kk = r.standard_normal((b, sn, kh, d)).astype(np.float32)
    vv = r.standard_normal((b, sn, kh, d)).astype(np.float32)
    positions = (np.array([[3], [s - sn]]) + np.arange(sn)[None, :]).astype(np.int32)
    kv_len = np.array([3 + sn, s], np.int32) if with_len else None
    want, j_out = jdec.update_cache_and_attend(
        {name: _j(x) for name, x in cache.items()}, _j(q), _j(kk), _j(vv), _j(positions),
        kv_length=_j(kv_len))
    # Chunks: the cached flash kernel's plain version and the dequantize +
    # reference path agree with JAX alike.
    for chunk_impl in ("flash", "plain"):
        t_cache = {name: _t(x.copy()) for name, x in cache.items()}
        got, t_out = tdec.update_cache_and_attend(
            t_cache, _t(q), _t(kk), _t(vv), _t(positions), kv_length=_t(kv_len), chunk_impl=chunk_impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, err_msg=chunk_impl)
        assert t_out is t_cache  # written in place
        for name in cache:
            np.testing.assert_array_equal(t_out[name].numpy(), np.asarray(j_out[name]), err_msg=name)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_out_of_range_write_is_dropped(quantized):
    """A position past the cache is dropped, as JAX's out-of-range scatter
    drops it; no index goes past S-1. The fused impl clamps it onto S-1 in
    row and scale alike, as JAX's does, and a chunk with positions past
    the cache through the cached flash impl agrees with JAX too."""
    b, kh, h, s, d = 2, 2, 4, 8, 16
    cache = _layer_cache(kh, s, b, d, quantized, seed=3)
    r = np.random.default_rng(4)
    q = r.standard_normal((b, 1, h, d)).astype(np.float32)
    kk = r.standard_normal((b, 1, kh, d)).astype(np.float32)
    positions = np.array([[s], [2]], np.int32)
    chunk_q = r.standard_normal((b, 4, h, d)).astype(np.float32)
    chunk_kv = r.standard_normal((b, 4, kh, d)).astype(np.float32)
    chunk_pos = np.array([[s - 2, s - 1, s, s + 1], [2, 3, 4, 5]], np.int32)
    for impl, chunk_impl, args in (("kernel", "flash", (q, kk, kk, positions)),
                                   ("fused", "flash", (q, kk, kk, positions)),
                                   ("kernel", "flash", (chunk_q, chunk_kv, chunk_kv, chunk_pos))):
        t_cache = {name: _t(x.copy()) for name, x in cache.items()}
        got, t_out = tdec.update_cache_and_attend(t_cache, *map(_t, args), impl=impl, chunk_impl=chunk_impl)
        want, j_out = jdec.update_cache_and_attend(
            {name: _j(x) for name, x in cache.items()}, *map(_j, args),
            impl="fused" if impl == "fused" else "xla")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, err_msg=impl)
        for name in cache:
            np.testing.assert_array_equal(t_out[name].numpy(), np.asarray(j_out[name]), err_msg=name)
        if impl == "fused":  # the drifted row lands on S-1
            np.testing.assert_array_equal(t_out["k"][0, :, s - 1].numpy(),
                                          (j_out["k"][0, :, s - 1]))
        else:
            np.testing.assert_array_equal(t_out["k"][0, :, : s - 2].numpy(), cache["k"][0, :, : s - 2])


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_pack_fragment_matches_jax(quantized):
    r = np.random.default_rng(5)
    frag = {"k": r.standard_normal((2, 1, 12, 2, 16)).astype(np.float32),
            "v": r.standard_normal((2, 1, 12, 2, 16)).astype(np.float32)}
    dtype = np.int8 if quantized else np.float32
    cache = {"k": np.zeros((1,), dtype), "v": np.zeros((1,), dtype)}
    if quantized:
        cache["k_scale"] = cache["v_scale"] = np.ones((1,), np.float32)
    got = tdec.pack_fragment({n: _t(x) for n, x in cache.items()}, {n: _t(x) for n, x in frag.items()})
    want = jdec.pack_fragment({n: _j(x) for n, x in cache.items()}, {n: _j(x) for n, x in frag.items()})
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)

