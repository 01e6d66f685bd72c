"""The flash forward and the cached flash (bf16 and int8 caches) of
csrc/flash_fwd_wgmma.cu at head_dim 64 and 128 against their plain
PyTorch versions, on the card.

Every test here needs an NVIDIA card (the kernels are CUDA C++ for sm_90a
with no CPU mode) and skips without one. The file imports only torch and
the port, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda -rP tests/test_torch_flash_fwd_cuda.py

Each call must launch the design that flash_fwd_design or
flash_cached_design names (the per-design counters). Tolerances: every
output vector (one query row of one head, over D) within ROW_REL = 2^-6 of
its own norm, or of 2^-8 of the RMS vector norm where that is larger: the
kernel and the plain version round p and the output to bf16 at the same
places and sum in f32 in another order, so a rounding flip moves a vector
by about one bf16 ulp of one term, while a dropped tile or row moves whole
vectors (chip_smoke.py checks that the limit rejects both). The f32 LSE
within 1e-3. A row whose limit is -1 outputs exactly 0. Each test prints
its readings (pytest -rP).
"""
import pytest
import torch

from substratus_tpu_torch import kernels
from substratus_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_plain, flash_cached_attention, flash_cached_attention_plain,
    flash_cached_design, flash_fwd_design)
from substratus_tpu_torch.ops.quant import quantize_kv

pytestmark = pytest.mark.cuda
ROW_REL = 2**-6
LSE_ATOL = 1e-3


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


def _launched(fn, call):
    """Run call() and return the growth of fn's per-design counters."""
    before = {d: getattr(fn, f"launches_{d}") for d in ("wgmma", "mma")}
    out = call()
    return out, {d: getattr(fn, f"launches_{d}") - n for d, n in before.items()}


@pytest.mark.parametrize("b,s,h,kh,d,causal", [
    (1, 512, 32, 32, 128, True),  # the llama2-7b prefill of a 512-token bucket
    (2, 100, 8, 8, 128, True),  # ragged: one block, its second consumer's rows partly past S
    (1, 1000, 8, 8, 128, True),  # ragged: the last tile holds 40 rows and 104 keys
    (2, 384, 8, 8, 128, False),
    (2, 256, 32, 8, 128, True),  # GQA 4 (llama3-8b's heads)
    (2, 200, 32, 4, 64, True),  # tinyllama's heads: GQA 8, head_dim 64
    (1, 1000, 8, 2, 64, False),  # non-causal, ragged, head_dim 64
])
def test_forward_matches_plain(cuda, b, s, h, kh, d, causal):
    gen = torch.Generator(device=cuda).manual_seed(s + kh + d)
    q = torch.randn((b, s, h, d), generator=gen, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn((b, s, kh, d), generator=gen, device=cuda).to(torch.bfloat16) for _ in range(2))
    (out, lse), launched = _launched(flash_attention, lambda: flash_attention(q, k, v, causal, return_lse=True))
    design = flash_fwd_design(d)
    assert launched == {dd: int(dd == design) for dd in launched} and design == "wgmma"
    ref, ref_lse = flash_attention_plain(q, k, v, causal, return_lse=True)
    torch.cuda.synchronize()
    err, lse_err = _row_err(out, ref), (lse - ref_lse).abs().max().item()
    print(f"forward b{b} s{s} h{h}/{kh} d{d} causal={causal}: row error {err:.4g} (limit {ROW_REL}), "
          f"lse {lse_err:.3g} (limit {LSE_ATOL})")
    assert torch.isfinite(out.float()).all() and err <= ROW_REL and lse_err <= LSE_ATOL


@pytest.mark.parametrize("b,sq,sk,h,kh,d,start,int8,kv_length", [
    (1, 512, 4096, 32, 32, 128, 2048, False, False),  # the fifth 512-token chunk of a long llama2-7b prompt
    (2, 100, 1000, 8, 8, 128, 300, False, True),  # ragged chunk; kv_length clips one slot, the other at -1
    (2, 1000, 2048, 32, 4, 64, 700, False, False),  # tinyllama's heads, ragged Sq, GQA 8
    (1, 130, 1024, 32, 8, 128, 0, False, True),  # the first chunk (causal within it), GQA 4
    (2, 100, 1000, 8, 8, 128, 300, True, True),  # int8 cache (serve-int4's), ragged, kv_length
    (2, 1000, 2048, 32, 4, 64, 700, True, False),  # int8 cache, tinyllama's heads, ragged Sq
])
def test_cached_matches_plain(cuda, b, sq, sk, h, kh, d, start, int8, kv_length):
    """A chunk of sq queries at positions start.. of each slot (the second
    slot's at start / 2..); with kv_length the first slot's length clips
    the chunk and the second slot's length is 0, so its every row has
    limit -1 and must be exactly 0, and the first slot's first position
    is -1."""
    gen = torch.Generator(device=cuda).manual_seed(sq + kh + d)
    q = torch.randn((b, sq, h, d), generator=gen, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn((b, kh, sk, d), generator=gen, device=cuda).to(torch.bfloat16) for _ in range(2))
    offs = torch.tensor([start, start // 2][:b], device=cuda)[:, None]
    pos = (offs + torch.arange(sq, device=cuda)).to(torch.int32)
    kv_len = None
    if kv_length:
        pos[0, 0] = -1
        kv_len = torch.tensor([start + sq // 2, 0][:b], dtype=torch.int32, device=cuda)
    ks = vs = None
    if int8:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        ks, vs = ks[..., 0].contiguous(), vs[..., 0].contiguous()
    args = (q, k, v, pos, ks, vs, kv_len)
    out, launched = _launched(flash_cached_attention, lambda: flash_cached_attention(*args))
    design = flash_cached_design(d)
    assert launched == {dd: int(dd == design) for dd in launched} and design == "wgmma"
    ref = flash_cached_attention_plain(*args)
    torch.cuda.synchronize()
    err = _row_err(out, ref)
    print(f"cached b{b} sq{sq} sk{sk} h{h}/{kh} d{d} int8={int8} kv_length={kv_length} ({design}): "
          f"row error {err:.4g} (limit {ROW_REL})")
    assert torch.isfinite(out.float()).all() and err <= ROW_REL
    if kv_length:
        assert torch.all(out[0, 0] == 0)
        if b > 1:
            assert torch.all(out[1] == 0)


def test_entry_points_refuse(cuda):
    """The wgmma design's C entry points refuse what they do not take: a
    head_dim other than 64 and 128 (-2), kv heads that do not divide the
    query heads (-1), an int8 cache without its scales (-1), a cache dtype
    other than bf16 and int8 (-3)."""
    lib = kernels.library()
    x = torch.zeros((1, 64, 2, 128), dtype=torch.bfloat16, device=cuda)
    x32 = torch.zeros((1, 64, 2, 32), dtype=torch.bfloat16, device=cuda)
    stream = kernels.stream_ptr(cuda)

    def fwd(t, kh):
        o = torch.empty_like(t)
        return lib.flash_fwd_wgmma(t.data_ptr(), t.data_ptr(), t.data_ptr(), o.data_ptr(), None, 1, 64, 64, 2, kh,
                                   t.shape[-1], 0, 0.1, 1, stream)

    assert fwd(x32, 2) == -2 and fwd(x, 3) == -1 and fwd(x, 2) == 0
    cache = torch.zeros((1, 2, 64, 128), dtype=torch.int8, device=cuda)
    scales = torch.ones((1, 2, 64), device=cuda)
    pos = torch.arange(64, dtype=torch.int32, device=cuda)[None]
    def cached(k_scale, dtype_code):
        o = torch.empty_like(x)
        return lib.flash_cached_wgmma(x.data_ptr(), cache.data_ptr(), cache.data_ptr(), k_scale, scales.data_ptr(),
                                      pos.data_ptr(), None, o.data_ptr(), 1, 64, 64, 2, 2, 128, dtype_code, 0.1, stream)

    int8 = kernels.DTYPE_CODES[torch.int8]
    assert cached(None, int8) == -1 and cached(scales.data_ptr(), 7) == -3 and cached(scales.data_ptr(), int8) == 0
    torch.cuda.synchronize()
