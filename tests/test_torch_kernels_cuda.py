"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (the kernels are CUDA C++ for sm_90a
with no CPU mode) and skips without one. The file imports only torch and
the port, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Each flash case also runs the cached flash kernel at its heads and query
length, and each decode case the fused decode kernel, bf16 and int8. The
int4 matmul runs at decode and prefill row counts over the llama2-7b
projection widths.

bf16 tolerance: atol 2e-2, about one bf16 ulp of values of order 1, since
the kernel and the plain version round p (flash) and the output to bf16
after summing in another order; the f32 LSE within 1e-3. The fused
decode kernel writes the cache row bit for bit as its plain version does.
The int4 matmul within 1e-2 of the largest output: both sides multiply the
same bf16 weights, so only the bf16 rounding of the output (2^-8
relative) and the f32 summation order differ.
"""
import pytest
import torch

from substratus_tpu_torch.models import llama
from substratus_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain
from substratus_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_plain, flash_cached_attention, flash_cached_attention_plain)
from substratus_tpu_torch.ops.fused_decode import fused_decode_attention, fused_decode_attention_plain
from substratus_tpu_torch.ops.quant import quantize_kv
from substratus_tpu_torch.ops.quant4 import q4_matmul, q4_matmul_plain, q4einsum, quantize4
from substratus_tpu_torch.serve.engine import Engine, EngineConfig

pytestmark = pytest.mark.cuda
ATOL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no CPU mode")
    return torch.device("cuda")


def _quantized(x):
    """int8 entries and contiguous f32 scales [B, KH, S]."""
    xq, xs = quantize_kv(x)
    return xq, xs[..., 0].contiguous()


def _check_cached_flash(gen, sq, h, kh, d):
    """A ragged chunk at positions 300.. and 0.. of a 1000-row cache (the
    padded tail clamped onto one position), bf16 and int8, with and without
    kv_length; kv_length 0 gives exactly 0."""
    dev = gen.device
    b, sk = 2, 1000
    q = torch.randn((b, sq, h, d), generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((b, kh, sk, d), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    (kq, ks), (vq, vs) = _quantized(k), _quantized(v)
    off = torch.tensor([[300], [0]], device=dev)
    pos = torch.minimum(off + torch.arange(sq, device=dev), off + sq - 5).to(torch.int32)
    for cache in ((k, v, None, None), (kq, vq, ks, vs)):
        for kv_len in (None, torch.tensor([350, 0], dtype=torch.int32, device=dev)):
            before = flash_cached_attention.launches
            out = flash_cached_attention(q, cache[0], cache[1], pos, *cache[2:], kv_length=kv_len)
            assert flash_cached_attention.launches == before + 1
            ref = flash_cached_attention_plain(q, cache[0], cache[1], pos, *cache[2:], kv_length=kv_len)
            torch.cuda.synchronize()
            assert torch.isfinite(out.float()).all()
            assert (out.float() - ref.float()).abs().max().item() <= ATOL
            if kv_len is not None:
                assert torch.all(out[1] == 0)  # limit -1: attends nothing


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
    _check_cached_flash(gen, s, h, kh, d)


@pytest.mark.parametrize("h,kh,d", [(32, 32, 128), (32, 8, 128), (4, 2, 16), (16, 2, 32), (32, 4, 64)])
def test_decode_kernel_matches_plain(cuda, h, kh, d):
    """bf16 and int8 caches (scales [B, KH, S] f32), through the decode
    kernel and the fused write + decode kernel."""
    gen = torch.Generator(device=cuda).manual_seed(kh + d)
    b, s = 8, 1024
    q = torch.randn((b, 1, h, d), generator=gen, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn((b, kh, s, d), generator=gen, device=cuda).to(torch.bfloat16) for _ in range(2))
    (kq, ks), (vq, vs) = _quantized(k), _quantized(v)
    pos = torch.tensor([-1, 0, 17, 255, 511, 700, 1023, 5000], dtype=torch.int32, device=cuda)
    for args in ((k, v, pos), (kq, vq, pos, ks, vs)):
        before = decode_attention.launches
        out = decode_attention(q, *args)
        assert decode_attention.launches == before + 1
        ref = decode_attention_plain(q, *args)
        torch.cuda.synchronize()
        assert (out.float() - ref.float()).abs().max().item() <= ATOL
        assert torch.all(out[0] == 0)  # pos < 0 attends nothing

    # Fused: positions 0 (no history) to past the cache (clamped onto
    # S-1); the caller has already written the fresh scales.
    nk, nv = (torch.randn((b, kh, 1, d), generator=gen, device=cuda).to(torch.bfloat16) for _ in range(2))
    (nkq, nks), (nvq, nvs) = _quantized(nk), _quantized(nv)
    rows = (torch.arange(b, device=cuda)[:, None], torch.arange(kh, device=cuda)[None, :],
            torch.clamp(pos.long(), 0, s - 1)[:, None])
    ks[rows], vs[rows] = nks[:, :, 0], nvs[:, :, 0]
    for new, cache, scales in (((nk, nv), (k, v), ()), ((nkq, nvq), (kq, vq), (nks, nvs, ks, vs))):
        kc, vc = (c.clone() for c in cache)
        kp, vp = (c.clone() for c in cache)
        before = fused_decode_attention.launches
        out, k_out, v_out = fused_decode_attention(q, *new, kc, vc, pos, *scales)
        assert fused_decode_attention.launches == before + 1 and k_out is kc and v_out is vc
        ref, _, _ = fused_decode_attention_plain(q, *new, kp, vp, pos, *scales)
        torch.cuda.synchronize()
        assert torch.isfinite(out.float()).all()
        assert (out.float() - ref.float()).abs().max().item() <= ATOL
        assert torch.equal(kc, kp) and torch.equal(vc, vp)
        assert torch.equal(kc[rows], new[0][:, :, 0]) and torch.equal(vc[rows], new[1][:, :, 0])


def test_q4_matmul_matches_plain(cuda):
    """M = 1, 8 (decode), 77 and 512 (prefill) rows over N = 1024, 4096
    (with C = 11008, w_down) and 11008, groups of 128 and 64, plus N = 1000
    (8-byte vectors and a ragged column tile); unsupported operands and an
    equation that does not fit the kernel raise."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    cases = [(m, n, block) for block in (128, 64) for n in (1024, 4096, 11008) for m in (1, 8, 77, 512)]
    for m, n, block in cases + [(8, 1000, 128), (77, 1000, 64)]:
        c = 11008 if n == 4096 else 4096
        packed = torch.randint(0, 256, (c // 2, n), generator=gen, device=cuda, dtype=torch.uint8)
        scale = torch.rand((c // block, n), generator=gen, device=cuda) * 0.02
        x = torch.randn((m, c), generator=gen, device=cuda).to(torch.bfloat16)
        before = q4_matmul.launches
        out = q4_matmul(x, packed, scale, block)
        assert q4_matmul.launches == before + 1
        ref = q4_matmul_plain(x, packed, scale, block)
        torch.cuda.synchronize()
        assert out.shape == (m, n) and out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= 1e-2 * ref.float().abs().max().item(), (m, n, block, err)
    packed = torch.zeros((64, 256), dtype=torch.uint8, device=cuda)
    x = torch.zeros((8, 128), dtype=torch.bfloat16, device=cuda)
    for args in ((x, packed, torch.ones((8, 256), device=cuda), 16),  # group size not built
                 (x.float(), packed, torch.ones((1, 256), device=cuda), 128),  # f32 activations
                 (x, packed[:, :250], torch.ones((1, 250), device=cuda), 128)):  # N not a multiple of 8
        with pytest.raises(ValueError):
            q4_matmul(*args)
    # An equation the kernel cannot take raises on the card: no dense fallback.
    w = quantize4(torch.randn((4, 256, 128), generator=gen, device=cuda), (1,))
    with pytest.raises(ValueError, match="does not fit"):
        q4einsum("bsd,edm->bsem", torch.randn((2, 3, 256), device=cuda).to(torch.bfloat16), w)


@pytest.mark.parametrize("name", ["head_dim-128", "tiny"])
def test_engine_runs_the_kernels(cuda, name):
    """A small bf16 model served by the Engine on the card: every prefill
    launches the flash kernel once per layer and every decode step the
    decode kernel once per layer; the logits of the kernel path stay
    within bf16 noise of the plain path. Then prompts longer than
    max_prefill_len run each chunk through the cached flash kernel and,
    with decode_attn_impl="fused", each step through the fused kernel
    (bf16 cache for head_dim 128, int8 for tiny); with the bf16 cache each
    served greedy token is within 5% of the logit scale of the best logit
    of a single-shot forward over prompt + tokens. The kernels refuse a
    head dim above 256, the largest they are built for (a smaller one runs
    padded: tests/test_torch_headdim_cuda.py), and f32 on the card."""
    cfg = llama.CONFIGS["tiny"] if name == "tiny" else llama.LlamaConfig(
        vocab_size=512, dim=512, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=1024, max_seq_len=256)
    for shape, dtype in (((1, 16, 4, 288), torch.bfloat16), ((1, 16, 4, 128), torch.float32)):
        x = torch.zeros(shape, dtype=dtype, device=cuda)
        with pytest.raises(ValueError):
            flash_attention(x, x, x, True)
    params = llama.init_params(cfg, seed=0)
    tokens = torch.randint(0, cfg.vocab_size, (1, 40), device=cuda)
    kern, _ = llama.forward(params, tokens, cfg)
    plain, _ = llama.forward(params, tokens, cfg.replace(attn_impl="plain"))
    assert (kern - plain).abs().max().item() <= 0.05 * kern.abs().max().item()

    engine = Engine(cfg, params, EngineConfig(max_batch=4, max_seq_len=128, eos_token_id=-1, kv_layout="dense"))
    flash0, decode0 = flash_attention.launches, decode_attention.launches
    engine.start()
    try:
        outs = [engine.generate([1, 2, 3, i], max_tokens=6, temperature=0.0) for i in range(3)]
    finally:
        engine.stop()
    assert all(len(o) == 6 for o in outs)
    assert flash_attention.launches - flash0 == 2 * engine.stats["prefills"] == 6
    # Every decode step replays the captured graph; the wrapper counts only
    # the warm-up's launches, the graph holds the rest (serve/decode_graph.py).
    assert engine.stats["graph_replays"] == engine.stats["decode_steps"] > 0
    assert decode_attention.launches - decode0 + engine.replayed_launches("decode_attention.launches") == 2 * (
        engine.stats["decode_steps"] + engine.stats["graph_warmups"])

    kv = "int8" if name == "tiny" else "model"
    cfg = cfg.replace(decode_attn_impl="fused")
    engine = Engine(cfg, params, EngineConfig(max_batch=4, max_seq_len=128, max_prefill_len=32, eos_token_id=-1,
                                              kv_cache_dtype=kv, kv_layout="dense"))
    counters = (flash_attention, flash_cached_attention, fused_decode_attention, decode_attention)
    before = [c.launches for c in counters]
    prompts = [[(7 * i + j) % 250 for j in range(n)] for i, n in enumerate((100, 40, 10))]
    engine.start()
    try:
        outs = [engine.generate(p, max_tokens=6, temperature=0.0) for p in prompts]
    finally:
        engine.stop()
    flash, cached, fused, decode = (c.launches - n for c, n in zip(counters, before))
    assert all(len(o) == 6 for o in outs)
    # 100 tokens: 4 chunks of 32; 40 tokens: 2 chunks; 10 tokens: single-shot.
    assert engine.stats["prefill_chunks"] == 6 and engine.stats["prefills"] == 1
    fused += engine.replayed_launches("fused_decode_attention.launches")
    assert (flash, cached, decode) == (2, 2 * 6, 0) and engine.stats["decode_steps"] > 0
    assert fused == 2 * (engine.stats["decode_steps"] + engine.stats["graph_warmups"])
    if kv == "model":
        for prompt, toks in zip(prompts, outs):
            logits, _ = llama.forward(params, torch.tensor([prompt + toks[:-1]], device=cuda), cfg)
            logits = logits[0, len(prompt) - 1:]
            gaps = logits.max(dim=-1).values - logits[torch.arange(len(toks)), torch.tensor(toks)]
            assert gaps.max().item() <= 0.05 * logits.abs().max().item()
