"""The kernels of speculation in a gang on the card, at a tensor=2 rank's
shapes: the cached flash kernel carrying a verify round over the dense
int8 cache at the rank's 16 of llama2-7b's 32 heads, and the int4 matmul's
wgmma design at a width-4 verify of 24 rows over the rank's half of
w_gate (N = 5504).

Every test here needs an NVIDIA card (the kernels are CUDA C++ for sm_90a
with no CPU mode) and skips without one. The file imports only torch and
the port, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda -rP tests/test_torch_gang_spec_cuda.py

Each kernel is held against its plain version on the same inputs (the
cached flash by every output vector within ROW_REL = 2^-6 of its own norm,
or of 2^-8 of the RMS vector norm where that is larger; the int4 matmul
within 1e-2 of the largest value), and a planted fault (the cache's last
live 64-row key tile dropped; w_gate's last scale group zeroed) must fail
the same check. Each test prints its readings (pytest -rP).
"""
import pytest
import torch

from substratus_tpu_torch.ops.flash_attention import flash_cached_attention, flash_cached_attention_plain
from substratus_tpu_torch.ops.quant import quantize_kv
from substratus_tpu_torch.ops.quant4 import q4_design, q4_matmul, q4_matmul_plain, quantize4

pytestmark = pytest.mark.cuda
ROW_REL = 2**-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no CPU mode")
    return torch.device("cuda")


def _row_err(got, ref) -> float:
    g, r = got.float(), ref.float()
    norms = r.norm(dim=-1)
    den = torch.maximum(norms, norms.square().mean().sqrt() * 2**-8).clamp_min(torch.finfo(torch.float32).tiny)
    return ((g - r).norm(dim=-1) / den).max().item()


def test_cached_flash_at_a_ranks_verify_shape(cuda):
    """B=24 rows of 4 queries over a 1024-row int8 cache at H = KH = 16
    (llama2-7b's heads at tensor 2), rows from positions 0..777 and two
    idle at S-1: one launch of the wgmma design, within ROW_REL; without
    the last live key tile the plain version fails the same limit."""
    gen = torch.Generator(device=cuda).manual_seed(25)
    b, sq, s, h, d = 24, 4, 1024, 16, 128
    q = torch.randn((b, sq, h, d), generator=gen, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn((b, h, s, d), generator=gen, device=cuda).to(torch.bfloat16) for _ in range(2))
    starts = torch.tensor([37 * i for i in range(b - 2)] + [s - 1, s - 1], device=cuda)
    positions = (starts[:, None] + torch.arange(sq, device=cuda)[None, :]).to(torch.int32)
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    ks, vs = ks[..., 0].contiguous(), vs[..., 0].contiguous()
    before = flash_cached_attention.launches_wgmma
    got = flash_cached_attention(q, kq, vq, positions, ks, vs)
    assert flash_cached_attention.launches_wgmma == before + 1
    ref = flash_cached_attention_plain(q, kq, vq, positions, ks, vs)
    err = _row_err(got, ref)
    cut = 64 * ((s - 1) // 64)  # the idle rows read the whole cache: its last 64-row tile dropped
    short = [t[:, :, :cut].contiguous() for t in (kq, vq, ks, vs)]
    fault = _row_err(flash_cached_attention_plain(q, short[0], short[1], positions, short[2], short[3]), ref)
    print(f"cached flash B={b} Sq={sq} Sk={s} H=KH={h} int8: row error {err:.3g} (limit {ROW_REL:.3g}); "
          f"the last key tile dropped {fault:.3g}")
    assert torch.isfinite(got.float()).all() and err <= ROW_REL < fault


def test_int4_wgmma_at_a_ranks_verify_shape(cuda):
    """M = 96 (a width-4 verify at B = 24), C = 4096, N = 5504 (a rank's
    w_gate at tensor 2): one launch of the wgmma design, within 1e-2 of the
    largest plain value; w_gate's last scale group zeroed fails it."""
    gen = torch.Generator(device=cuda).manual_seed(26)
    m, c, n = 96, 4096, 5504
    qt = quantize4(torch.randn((c, n), generator=gen, device=cuda) * c**-0.5, (0,))
    x = torch.randn((m, c), generator=gen, device=cuda).to(torch.bfloat16)
    assert q4_design(m, n, c, qt.block) == "wgmma"
    before = q4_matmul.launches_wgmma
    got = q4_matmul(x, qt.packed, qt.scale, qt.block)
    assert q4_matmul.launches_wgmma == before + 1
    ref = q4_matmul_plain(x, qt.packed, qt.scale, qt.block)
    scale = qt.scale.clone()
    scale[-1] = 0  # the last group of 128 contracting rows
    dropped = q4_matmul_plain(x, qt.packed, scale, qt.block)
    top = ref.float().abs().max().item()
    err = (got.float() - ref.float()).abs().max().item()
    fault = (dropped.float() - ref.float()).abs().max().item()
    print(f"int4 wgmma M={m} C={c} N={n}: max|err| {err:.3g} (limit {1e-2 * top:.3g}); last group zeroed {fault:.3g}")
    assert torch.isfinite(got.float()).all() and err <= 1e-2 * top < fault
