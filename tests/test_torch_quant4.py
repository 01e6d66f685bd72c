"""The port's weight quantization (substratus_tpu_torch/ops/quant4.py and
ops/quant.py) against the JAX package's, on the same numpy inputs.

* quantize4: the packed bytes are identical and the scales equal, for
  groups of 128, 64 and 16 (the tiny config's wo), a stacked [L, D, H, hd]
  leaf and an lm_head [D, V]; Q4Tensor.dequant is exact.
* q4_matmul_plain (the CUDA kernel's plain version, which the wrapper runs
  on CPU tensors) against the Pallas _matmul in interpret mode and the XLA
  formula _q4_xla_2d: f32 within 1e-5 (another summation order); bf16 x
  within one bf16 rounding of the output (1e-2 of the largest value), the
  dequantized weight being bf16 on both sides.
* q4einsum on the model's five equations and one that does not fit (the
  dequant path), int8 quantize/qeinsum (scale after the dot, including
  permuted kept letters), within 1e-5 in f32.
* q4_design, the routing between the three CUDA designs: every llama2-7b
  projection and the lm_head at decode (M <= 16, the decode kernel) and at
  every prefill bucket (the wgmma kernel), N = 1000 and groups of 64 on
  the mma kernel (tests/test_torch_q4_decode.py covers llama3-8b too).
The CUDA kernels themselves are held against the plain version in
tests/test_torch_kernels_cuda.py, tests/test_torch_q4_cuda.py and
tests/test_torch_q4_decode_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substratus_tpu.ops import quant as jquant
from substratus_tpu.ops import quant4 as jq4
from substratus_tpu_torch.ops import quant, quant4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread keeps torch's worker
    pool from spinning on cores that timing-sensitive tests share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randn(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _q4_pair(w, contracting):
    """(JAX Q4Tensor, port Q4Tensor) of one numpy weight."""
    return jq4.quantize4(jnp.asarray(w), contracting), quant4.quantize4(torch.from_numpy(w), contracting)


def test_quantize4_bytes_match_jax():
    zero_group = _randn((256, 384), 0)
    zero_group[128:, 5] = 0.0  # absmax 0: scale 1, nibbles 0
    cases = [
        (zero_group, (0,), 128),
        (_randn((3, 64, 4, 16), 1), (1,), 64),  # stacked wq [L, D, H, hd]
        (_randn((2, 4, 16, 64), 2), (1, 2), 16),  # the tiny config's stacked wo [L, H, hd, D]
        (_randn((256, 300), 3, 0.05), (0,), 128),  # lm_head [D, V]
    ]
    for w, contracting, block in cases:
        jq, tq = _q4_pair(w, contracting)
        assert tq.packed.dtype == torch.uint8 and tq.scale.dtype == torch.float32
        np.testing.assert_array_equal(tq.packed.numpy(), np.asarray(jq.packed))
        np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
        assert (tq.pack_axis, tq.block) == (jq.pack_axis, jq.block) and tq.block == block
        assert tq.shape == jq.shape == w.shape
    assert quant4.quantize4(torch.from_numpy(zero_group), (0,)).scale[1, 5] == 1.0


def test_dequant_is_exact():
    """int4-representable values survive quantize -> dequant bit-exactly,
    and the port's dequant equals JAX's in f32 and bf16."""
    ints = np.random.default_rng(4).integers(-7, 8, (256, 32)).astype(np.float32)
    tq = quant4.quantize4(torch.from_numpy(ints), (0,))
    np.testing.assert_array_equal(tq.dequant(torch.float32).numpy(), ints)
    jq, tq = _q4_pair(_randn((2, 4, 16, 64), 5), (1, 2))
    np.testing.assert_array_equal(tq.dequant(torch.float32).numpy(), np.asarray(jq.dequant(jnp.float32)))
    np.testing.assert_array_equal(tq.dequant(torch.bfloat16).float().numpy(),
                                  np.asarray(jq.dequant(jnp.bfloat16).astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q4_matmul_plain_matches_jax(dtype):
    for m, c, n, block in ((24, 512, 384, 128), (8, 192, 256, 64), (1, 96, 128, 32)):
        x = _randn((m, c), m)
        jq, tq = _q4_pair(_randn((c, n), n, 0.1), (0,))
        assert tq.block == block
        jx = jnp.asarray(x).astype(dtype)
        tx = torch.from_numpy(x).to(getattr(torch, dtype))
        got = quant4.q4_matmul_plain(tx, tq.packed, tq.scale, tq.block)
        assert got.dtype == tx.dtype and got.shape == (m, n)
        want = np.asarray(jq4._matmul(jx, jq.packed, jq.scale, jq.block, interpret=True).astype(jnp.float32))
        xla = np.asarray(jq4._q4_xla_2d(jx, jq.packed, jq.scale, jq.block).astype(jnp.float32))
        tol = 1e-5 if dtype == "float32" else 1e-2 * np.abs(want).max()
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)
        np.testing.assert_allclose(got.float().numpy(), xla, atol=tol, rtol=0)
        # The wrapper takes the plain version for CPU tensors and counts no launch.
        launches = quant4.q4_matmul.launches
        assert torch.equal(quant4.q4_matmul(tx, tq.packed, tq.scale, tq.block), got)
        assert quant4.q4_matmul.launches == launches


def test_q4_design_routes_by_shape():
    """llama2-7b's projections (C, N): wq/wk/wv/wo, w_gate/w_up, w_down
    and the lm_head; decode steps of up to 16 rows take the decode kernel,
    prefill buckets (32..512 rows) and chunks the wgmma kernel; a width
    that is not a multiple of 16 and groups of 64 (tinyllama's wo) stay on
    the mma kernel at every row count."""
    widths = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)]
    for c, n in widths:
        for m in (1, 8, 16):
            assert quant4.q4_design(m, n, c, 128) == "decode", (m, c, n)
        for m in (17, 32, 64, 77, 128, 256, 512):
            assert quant4.q4_design(m, n, c, 128) == "wgmma", (m, c, n)
    for m in (8, 77, 512):
        assert quant4.q4_design(m, 1000, 4096, 128) == "mma"
        assert quant4.q4_design(m, 2048, 2048, 64) == "mma"
        assert quant4.q4_design(m, 4104, 4096, 128) == "mma"  # a multiple of 8, not of 16
    # On CPU tensors the wrapper runs the plain version and no design counts a launch.
    counters = ("launches", "launches_decode", "launches_wgmma", "launches_mma")
    counts = [getattr(quant4.q4_matmul, name) for name in counters]
    tq = quant4.quantize4(torch.from_numpy(_randn((256, 128), 12, 0.1)), (0,))
    for m, design in ((32, "wgmma"), (8, "decode")):
        x = torch.from_numpy(_randn((m, 256), 13)).to(torch.bfloat16)
        assert quant4.q4_design(m, 128, 256, tq.block) == design
        assert torch.equal(quant4.q4_matmul(x, tq.packed, tq.scale, tq.block),
                           quant4.q4_matmul_plain(x, tq.packed, tq.scale, tq.block))
    assert [getattr(quant4.q4_matmul, name) for name in counters] == counts


@pytest.mark.parametrize("eq,xs,ws,contr", [
    ("bsd,dhk->bshk", (2, 3, 256), (256, 4, 8), (0,)),  # wq/wk/wv
    ("bshk,hkd->bsd", (2, 3, 4, 16), (4, 16, 256), (0, 1)),  # wo: C = H * hd, folded along hd
    ("bsd,dm->bsm", (2, 3, 256), (256, 128), (0,)),  # gate/up
    ("bsm,md->bsd", (2, 3, 128), (128, 256), (0,)),  # down
    ("bsd,dv->bsv", (2, 3, 256), (256, 300), (0,)),  # lm_head
    ("bsd,edm->bsem", (2, 3, 256), (4, 256, 128), (1,)),  # MoE: one q4_matmul an expert
])
def test_q4einsum_matches_jax(eq, xs, ws, contr):
    x = _randn(xs, 6)
    jq, tq = _q4_pair(_randn(ws, 7, 0.1), contr)
    want = jq4.q4einsum(eq, jnp.asarray(x), jq, jnp.float32)
    got = quant4.q4einsum(eq, torch.from_numpy(x), tq, torch.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    # qeinsum hands a Q4Tensor to q4einsum
    np.testing.assert_array_equal(quant.qeinsum(eq, torch.from_numpy(x), tq, torch.float32).numpy(), got.numpy())
    if eq == "bsd,edm->bsem":  # an equation that fits no route (the expert axis summed): the dequant
        # path on the CPU, as JAX computes it; off the CPU it raises
        summed = "bsd,edm->bsm"
        np.testing.assert_allclose(quant4.q4einsum(summed, torch.from_numpy(x), tq, torch.float32).numpy(),
                                   np.asarray(jq4.q4einsum(summed, jnp.asarray(x), jq, jnp.float32)), atol=1e-5,
                                   rtol=1e-5)
        with pytest.raises(ValueError, match="does not fit"):
            quant4.q4einsum(summed, torch.from_numpy(x).to("meta"), tq.to("meta"), torch.float32)


def test_int8_quantize_and_qeinsum_match_jax():
    """Bit-exact int8 values and scales; qeinsum's scale after the dot, its
    dequant fallback (scale varying along a contracted dim) and
    _scale_for_out's transpose of permuted kept letters, against JAX."""
    x = _randn((2, 3, 64), 8)
    w = _randn((64, 4, 16), 9, 0.1)
    jw, tw = jquant.quantize(jnp.asarray(w), (0,)), quant.quantize(torch.from_numpy(w), (0,))
    np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q))
    np.testing.assert_array_equal(tw.scale.numpy(), np.asarray(jw.scale))
    assert tw.scale.shape == (1, 4, 16)
    for eq in ("bsd,dhk->bshk", "bsd,dhk->bhsk", "bsd,dhk->bskh"):
        want = jquant.qeinsum(eq, jnp.asarray(x), jw, jnp.float32)
        got = quant.qeinsum(eq, torch.from_numpy(x), tw, torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    # Scale per contracted row: dequant-then-dot.
    jw2, tw2 = jquant.quantize(jnp.asarray(w), (1, 2)), quant.quantize(torch.from_numpy(w), (1, 2))
    want = jquant.qeinsum("bsd,dhk->bshk", jnp.asarray(x), jw2, jnp.float32)
    got = quant.qeinsum("bsd,dhk->bshk", torch.from_numpy(x), tw2, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    # A dense weight: plain einsum in the requested dtype.
    dense = quant.qeinsum("bsd,dhk->bshk", torch.from_numpy(x), torch.from_numpy(w), torch.float32)
    np.testing.assert_allclose(dense.numpy(), np.einsum("bsd,dhk->bshk", x, w), atol=1e-5)


def test_param_trees_and_state():
    """quantize_params / quantize4_params over a dict tree (() keeps a leaf
    dense), is_quantized, materialize, and a Q4Tensor carried by
    state_dict into empty storage."""
    tree = {"norm": torch.ones(64), "layers": {"w": torch.from_numpy(_randn((64, 32), 10))}}
    contracting = {"norm": (), "layers": {"w": (0,)}}
    for fn, kind in ((quant.quantize_params, quant.QTensor), (quant4.quantize4_params, quant4.Q4Tensor)):
        q = fn(tree, contracting)
        assert q["norm"] is tree["norm"] and isinstance(q["layers"]["w"], kind)
        assert quant.is_quantized(q) and not quant.is_quantized(tree)
        dense = quant.materialize(q["layers"]["w"], torch.float32)
        # Round to nearest: within half a step, absmax / 7 / 2 for int4.
        err = (dense - tree["layers"]["w"]).abs().max()
        assert dense.shape == (64, 32) and err <= tree["layers"]["w"].abs().max() / 14 + 1e-6
    assert quant.materialize(tree["norm"], torch.bfloat16).dtype == torch.bfloat16
    src = quant4.quantize4(torch.from_numpy(_randn((2, 4, 16, 64), 11)), (1, 2))
    dst = quant4.Q4Tensor.empty((2, 4, 16, 64), (1, 2))
    dst.load_state_dict(src.state_dict())
    assert (dst.pack_axis, dst.block) == (src.pack_axis, src.block) == (-2, 16)
    assert torch.equal(dst.packed, src.packed) and torch.equal(dst.scale, src.scale)
