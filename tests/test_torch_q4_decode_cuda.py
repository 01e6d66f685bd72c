"""The int4 matmul's decode design (csrc/q4_matmul_decode.cu) on the card:
against its plain PyTorch version at every row count of a decode step (1
to 16) for llama2-7b's and llama3-8b's projection and lm_head widths, the
bits of two calls, planted faults, the cluster occupancy of the plans, and
the C entry point's refusals.

Every test here needs an NVIDIA card (the kernel is CUDA C++ for sm_90a
with no CPU mode) and skips without one. The file imports only torch and
the port, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda -rP tests/test_torch_q4_decode_cuda.py

Tolerance. The kernel and the plain version multiply the same bf16
weights ((int4 * scale) in f32, rounded to bf16) and differ only in the f32
summation order (across the splits too) and the output's bf16 rounding
(2^-8 relative): every output row (over N) within ROW_REL = 2^-6 of its
own norm, or of 2^-8 of the RMS row norm where that is larger.
test_planted_faults_fail checks that the limit rejects the output without
its last scale group and the output without one split's partial.
"""
import pytest
import torch

from substratus_tpu_torch import kernels
from substratus_tpu_torch.ops.fused_decode import sm_count
from substratus_tpu_torch.ops.quant4 import (
    cluster_capacity, q4_decode_plan, q4_decode_smem, q4_design, q4_matmul, q4_matmul_plain, quantize4)

pytestmark = pytest.mark.cuda
ROW_REL = 2**-6
LLAMA2_7B = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)]  # (C, N): wq/wk/wv/wo, gate/up, down, lm_head
LLAMA3_8B = [(4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256)]  # wk/wv, gate/up, down, lm_head


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no CPU mode")
    return torch.device("cuda")


def _row_rel(out, ref) -> float:
    """The largest error of one output row relative to its own norm, or to
    2^-8 of the RMS row norm where that is larger."""
    g, r = out.float(), ref.float()
    norms = r.norm(dim=-1)
    den = torch.maximum(norms, norms.square().mean().sqrt() * 2**-8).clamp_min(torch.finfo(torch.float32).tiny)
    return ((g - r).norm(dim=-1) / den).max().item()


def _weight(gen, c, n):
    """A random [c, n] weight quantized as the model's (groups of 128)."""
    qt = quantize4(torch.randn((c, n), generator=gen, device=gen.device) * c**-0.5, (0,))
    return qt.packed, qt.scale, qt.block


def _launched(fn):
    """fn's result and the (decode, wgmma, mma) launches it made."""
    names = ("launches_decode", "launches_wgmma", "launches_mma")
    before = [getattr(q4_matmul, x) for x in names] + [q4_matmul.launches]
    out = fn()
    torch.cuda.synchronize()
    after = [getattr(q4_matmul, x) for x in names] + [q4_matmul.launches]
    assert after[3] - before[3] == sum(a - b for a, b in zip(after[:3], before[:3]))
    return out, tuple(a - b for a, b in zip(after[:3], before[:3]))


def _every_row_count(cuda, c, n):
    gen = torch.Generator(device=cuda).manual_seed(c + n)
    packed, scale, block = _weight(gen, c, n)
    x = torch.randn((16, c), generator=gen, device=cuda).to(torch.bfloat16)
    ref = q4_matmul_plain(x, packed, scale, block)
    for m in range(1, 17):
        assert q4_design(m, n, c, block) == "decode"
        out, launched = _launched(lambda: q4_matmul(x[:m], packed, scale, block))
        err = _row_rel(out, ref[:m])
        print(f"M={m} C={c} N={n}: row error {err:.4g} (limit {ROW_REL:.4g})")
        assert out.shape == (m, n) and torch.isfinite(out.float()).all()
        assert launched == (1, 0, 0) and err <= ROW_REL, (m, c, n, launched, err)


@pytest.mark.parametrize("c,n", LLAMA2_7B)
def test_llama2_7b_every_row_count(cuda, c, n):
    """Each llama2-7b projection and the lm_head at M = 1..16: one launch
    of the decode design each, within ROW_REL of the plain version."""
    _every_row_count(cuda, c, n)


@pytest.mark.parametrize("c,n", LLAMA3_8B)
def test_llama3_8b_every_row_count(cuda, c, n):
    """llama3-8b's widths the llama2-7b ones do not cover: wk/wv at
    N = 1024 (eight splits), w_gate at N = 14336, w_down at C = 14336 (112
    groups in four splits of 28) and the lm_head at N = 128256 (eight chunks
    a block)."""
    _every_row_count(cuda, c, n)


def test_two_calls_are_bit_identical(cuda):
    """The splits are summed in a fixed order: the same inputs give the
    same bits, at a plan of one split and at plans of three and four."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    for c, n in ((4096, 4096), (4096, 11008), (4096, 32000)):
        packed, scale, block = _weight(gen, c, n)
        x = torch.randn((8, c), generator=gen, device=cuda).to(torch.bfloat16)
        first = q4_matmul(x, packed, scale, block)
        q4_matmul(torch.randn_like(x), packed, scale, block)  # another call between
        second = q4_matmul(x, packed, scale, block)
        assert torch.equal(first, second), (c, n)


def test_planted_faults_fail(cuda):
    """The limit rejects two outputs built from the plain version: without
    the last scale group, and without the partial of one split of the
    plan (the groups of w_down's second split of four); the kernel's own
    output passes."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    c, n, m = 11008, 4096, 8
    packed, scale, block = _weight(gen, c, n)
    x = torch.randn((m, c), generator=gen, device=cuda).to(torch.bfloat16)
    ref = q4_matmul_plain(x, packed, scale, block)
    short = q4_matmul_plain(x[:, : c - block].contiguous(), packed[: (c - block) // 2], scale[:-1], block)
    g = c // block
    _, splits = q4_decode_plan(m, n, c, sm_count(cuda.index or 0), cluster_capacity(cuda.index or 0, 8))
    g0, g1 = g // splits, 2 * g // splits  # split 1's groups
    keep = torch.ones(g, dtype=torch.bool, device=cuda)
    keep[g0:g1] = False
    rows = keep.repeat_interleave(block)
    missing = q4_matmul_plain(x[:, rows].contiguous(), packed[keep.repeat_interleave(block // 2)].contiguous(),
                              scale[keep].contiguous(), block)
    errs = (_row_rel(short, ref), _row_rel(missing, ref))
    print(f"planted faults: row errors {errs[0]:.4g} (last group dropped), {errs[1]:.4g} (split 1 of {splits} left out)")
    assert splits > 1 and min(errs) > ROW_REL
    assert _row_rel(q4_matmul(x, packed, scale, block), ref) <= ROW_REL


def test_plans_fit_one_wave(cuda):
    """Each plan's clusters of llama2-7b's and llama3-8b's decode shapes fit
    on the card at once (cudaOccupancyMaxActiveClusters at the plan's
    shared memory): one wave."""
    lib, sms = kernels.library(), sm_count(cuda.index or 0)
    for c, n in LLAMA2_7B + LLAMA3_8B:
        for m in (1, 8, 16):
            bn, splits = q4_decode_plan(m, n, c, sms, cluster_capacity(cuda.index or 0, 8 if m <= 8 else 16))
            tiles = -(-(-(-n // 128)) // (bn // 128))
            smem = q4_decode_smem(m, bn // 128, -(-(c // 128) // splits), splits)
            held = lib.q4_matmul_decode_clusters(m, splits, smem)
            print(f"M={m} C={c} N={n}: plan bn {bn} splits {splits}, {tiles} clusters of {smem} bytes of shared "
                  f"memory a block, the card holds {held}")
            assert held >= tiles, (m, c, n, bn, splits, held)


def test_entry_point_refuses_other_shapes(cuda):
    """The decode design's C entry point returns -1 for a shape q4_design
    gives to another kernel (M = 17, N = 1000, groups of 64, C not a
    multiple of 128) or a plan outside its limits (bn not a multiple of
    128, nine splits, more splits than groups), and launches nothing."""
    x = torch.zeros((17, 4096), dtype=torch.bfloat16, device=cuda)
    packed = torch.zeros((2048, 1024), dtype=torch.uint8, device=cuda)
    scale = torch.ones((32, 1024), device=cuda)
    out = torch.full((17, 1024), 7.0, dtype=torch.bfloat16, device=cuda)
    lib, stream = kernels.library(), kernels.stream_ptr(cuda)
    args = (x.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr())
    refused = [(17, 1024, 4096, 128, 128, 4), (8, 1000, 4096, 128, 128, 4), (8, 1024, 4096, 64, 128, 4),
               (8, 1024, 4000, 128, 128, 4), (8, 1024, 4096, 128, 192, 4), (8, 1024, 4096, 128, 128, 9),
               (8, 1024, 256, 128, 128, 3)]
    for m, n, c, block, bn, splits in refused:
        assert lib.q4_matmul_decode(*args, m, n, c, block, bn, splits, stream) == -1, (m, n, c, block, bn, splits)
    torch.cuda.synchronize()
    assert torch.all(out == 7.0)
    assert lib.q4_matmul_decode(*args, 8, 1024, 4096, 128, 128, 4, stream) == 0
    torch.cuda.synchronize()
    assert torch.all(out[:8] == 0) and torch.all(out[8:] == 7.0)
