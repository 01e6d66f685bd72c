"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (the kernels are CUDA C++ for sm_90a
with no CPU mode) and skips without one. The file imports only torch and
the port, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

bf16 tolerance: atol 2e-2, about one bf16 ulp of values of order 1, since
the kernel and the plain version round p (flash) and the output to bf16
after summing in another order; the f32 LSE within 1e-3.
"""
import pytest
import torch

from substratus_tpu_torch.models import llama
from substratus_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain
from substratus_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
from substratus_tpu_torch.ops.quant import quantize_kv
from substratus_tpu_torch.serve.engine import Engine, EngineConfig

pytestmark = pytest.mark.cuda
ATOL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("s,h,kh,d,causal", [
    (512, 32, 32, 128, True), (100, 32, 32, 128, True), (512, 32, 8, 128, True), (384, 32, 32, 128, False),
    (100, 4, 2, 16, True), (77, 4, 2, 32, False), (130, 32, 4, 64, True),
])
def test_flash_kernel_matches_plain(cuda, s, h, kh, d, causal):
    gen = torch.Generator(device=cuda).manual_seed(s + kh)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)
               for shape in ((2, s, h, d), (2, s, kh, d), (2, s, kh, d)))
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v, causal, return_lse=True)
    assert flash_attention.launches == before + 1
    ref, ref_lse = flash_attention_plain(q, k, v, causal, return_lse=True)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= ATOL
    assert (lse - ref_lse).abs().max().item() <= 1e-3


@pytest.mark.parametrize("h,kh,d", [(32, 32, 128), (32, 8, 128), (4, 2, 16), (16, 2, 32), (32, 4, 64)])
def test_decode_kernel_matches_plain(cuda, h, kh, d):
    """bf16 and int8 caches (scales [B, KH, S] f32)."""
    gen = torch.Generator(device=cuda).manual_seed(kh + d)
    q = torch.randn((8, 1, h, d), generator=gen, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn((8, kh, 1024, d), generator=gen, device=cuda).to(torch.bfloat16) for _ in range(2))
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    pos = torch.tensor([-1, 0, 17, 255, 511, 700, 1023, 5000], dtype=torch.int32, device=cuda)
    for args in ((k, v, pos), (kq, vq, pos, ks[..., 0].contiguous(), vs[..., 0].contiguous())):
        before = decode_attention.launches
        out = decode_attention(q, *args)
        assert decode_attention.launches == before + 1
        ref = decode_attention_plain(q, *args)
        torch.cuda.synchronize()
        assert (out.float() - ref.float()).abs().max().item() <= ATOL
        assert torch.all(out[0] == 0)  # pos < 0 attends nothing


@pytest.mark.parametrize("name", ["head_dim-128", "tiny"])
def test_engine_runs_the_kernels(cuda, name):
    """A small bf16 model served by the Engine on the card: every prefill
    launches the flash kernel once per layer and every decode step the
    decode kernel once per layer; the logits of the kernel path stay
    within bf16 noise of the plain path. The kernels refuse head dims
    they were not built for and f32 on the card."""
    cfg = llama.CONFIGS["tiny"] if name == "tiny" else llama.LlamaConfig(
        vocab_size=512, dim=512, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=1024, max_seq_len=256)
    for shape, dtype in (((1, 16, 4, 96), torch.bfloat16), ((1, 16, 4, 128), torch.float32)):
        x = torch.zeros(shape, dtype=dtype, device=cuda)
        with pytest.raises(ValueError):
            flash_attention(x, x, x, True)
    params = llama.init_params(cfg, seed=0)
    tokens = torch.randint(0, cfg.vocab_size, (1, 40), device=cuda)
    kern, _ = llama.forward(params, tokens, cfg)
    plain, _ = llama.forward(params, tokens, cfg.replace(attn_impl="plain"))
    assert (kern - plain).abs().max().item() <= 0.05 * kern.abs().max().item()

    engine = Engine(cfg, params, EngineConfig(max_batch=4, max_seq_len=128, eos_token_id=-1))
    flash0, decode0 = flash_attention.launches, decode_attention.launches
    engine.start()
    try:
        outs = [engine.generate([1, 2, 3, i], max_tokens=6, temperature=0.0) for i in range(3)]
    finally:
        engine.stop()
    assert all(len(o) == 6 for o in outs)
    assert flash_attention.launches - flash0 == 2 * engine.stats["prefills"] == 6
    assert decode_attention.launches - decode0 == 2 * engine.stats["decode_steps"]
