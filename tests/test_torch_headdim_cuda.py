"""Head dims the kernels are not built for, and the instances at 256, on
the card (ops/headdim.py): every attention kernel family at head_dim 80
(facebook/opt-2.7b's) and 96, run padded to 128, at 192, run padded to
256, and at 256 (gemma's; the mma.sync designs and the rows decode, the
split decode at other groups), against its plain PyTorch version at the
true D; the decode kernels at a group of 3 on an int8 cache of 1022 rows,
laid out for the split design at 1024 rows, at head_dim 128 and 256; and
a small llama at head_dim 80 through the kernels and the Engine, the
padded route counted.

Every test here needs an NVIDIA card (the kernels are CUDA C++ for sm_90a
with no CPU mode) and skips without one. The file imports only torch and
the port, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda -rP tests/test_torch_headdim_cuda.py

Tolerance as in the other card tests: every output vector within ROW_REL =
2^-6 of its own norm (or of 2^-8 of the RMS vector norm where that is
larger); the plain version at the true D rounds p and the outputs to bf16
at the same places as the padded kernel, whose zero columns add nothing;
the LSE within 1e-3; the fused kernel's row write bit for bit.
"""
import pytest
import torch

from substratus_tpu_torch.models import llama
from substratus_tpu_torch.ops import flash_attention as fa
from substratus_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain
from substratus_tpu_torch.ops.fused_decode import (
    cache_layout, decode_design, fused_decode_attention, fused_decode_attention_plain)
from substratus_tpu_torch.ops.headdim import pad_head, padded_head_dim
from substratus_tpu_torch.ops.quant import quantize_kv
from substratus_tpu_torch.serve.engine import Engine, EngineConfig

pytestmark = pytest.mark.cuda
ROW_REL = 2**-6
LSE_ATOL = 1e-3
DIMS = [80, 96, 192, 256]


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


def _check(label, got, ref):
    torch.cuda.synchronize()
    err = _row_err(got, ref)
    print(f"{label}: row error {err:.4g} (limit {ROW_REL})")
    assert got.shape == ref.shape and torch.isfinite(got.float()).all() and err <= ROW_REL, label


def _bf16(gen, *shape, device):
    return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)


def _counts(fn):
    return {k: v for k, v in vars(fn).items() if k.startswith("launches")}


def _moved(fn, before):
    return {k: v - before[k] for k, v in _counts(fn).items() if v != before[k]}


def _want(design: str, padded: bool) -> dict:
    """One launch of `design`, counted padded where the head dim is not built."""
    return {"launches": 1, f"launches_{design}": 1, **({"launches_padded": 1} if padded else {})}


@pytest.mark.parametrize("d", DIMS)
def test_flash_forward_and_backward(cuda, d):
    """The flash forward (with its LSE), dQ and dK/dV at head_dim d, causal
    and GQA, through the wgmma designs at 128 and the mma.sync designs at
    256 (dK/dV in two column halves)."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    b, s, h, kh = 2, 1000, 8, 2
    dp = padded_head_dim(d)
    q, do = _bf16(gen, b, s, h, d, device=cuda), _bf16(gen, b, s, h, d, device=cuda)
    k, v = _bf16(gen, b, s, kh, d, device=cuda), _bf16(gen, b, s, kh, d, device=cuda)
    before = _counts(fa.flash_attention)
    out, lse = fa.flash_attention(q, k, v, True, return_lse=True)
    assert _moved(fa.flash_attention, before) == _want(fa.flash_fwd_design(dp), dp != d)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, True, return_lse=True)
    _check(f"flash forward d{d}", out, ref)
    assert (lse - ref_lse).abs().max().item() <= LSE_ATOL
    delta = fa.bwd_delta(out, do)
    args = (q, k, v, do, lse, delta, True, d**-0.5)
    got = (fa.flash_attention_bwd_dq(*args), *fa.flash_attention_bwd_dkv(*args))
    want = (fa._bwd_dq_plain(*args), *fa._bwd_dkv_plain(*args))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _check(f"flash backward {name} d{d}", g, w)
    for fn in (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv):
        assert fn.launches_padded >= (dp != d) and getattr(fn, f"launches_{fa.flash_bwd_design(dp)}") >= 1


@pytest.mark.parametrize("d", DIMS)
def test_cached_flash_and_decode_kernels(cuda, d):
    """The cached flash (a 512-row chunk), the decode attention and the
    fused decode at head_dim d, bf16 and int8, over caches laid out at 128
    or 256 (zero columns), against the plain versions over the caches at
    d."""
    gen = torch.Generator(device=cuda).manual_seed(d + 1)
    b, s, h, kh = 4, 2048, 8, 2
    dc = cache_layout(d, s, False, h // kh)[1]
    assert dc == padded_head_dim(d) and cache_layout(d, s, True, h // kh) == (s, dc)
    padded = dc != d
    k, v = _bf16(gen, b, kh, s, d, device=cuda), _bf16(gen, b, kh, s, d, device=cuda)
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    ks, vs = ks[..., 0].contiguous(), vs[..., 0].contiguous()
    kqp, vqp = quantize_kv(pad_head(k, dc))[0], quantize_kv(pad_head(v, dc))[0]
    caches = {"bf16": ((pad_head(k, dc), pad_head(v, dc)), (k, v), ()),
              "int8": ((kqp, vqp), (kq, vq), (ks, vs))}
    qc = _bf16(gen, b, 512, h, d, device=cuda)
    pos = (1024 + torch.arange(512, device=cuda)).repeat(b, 1).to(torch.int32)
    q1 = _bf16(gen, b, 1, h, d, device=cuda)
    dpos = torch.tensor([0, 700, 1500, s - 1], dtype=torch.int32, device=cuda)
    for name, (padded_kv, true, scales) in caches.items():
        before = _counts(fa.flash_cached_attention)
        out = fa.flash_cached_attention(qc, *padded_kv, pos, *scales)
        assert _moved(fa.flash_cached_attention, before) == _want(fa.flash_cached_design(dc), padded)
        _check(f"cached flash d{d} {name}", out, fa.flash_cached_attention_plain(qc, *true, pos, *scales))
        design = decode_design(dc, s, name == "int8", h // kh)
        assert design == ("rows" if dc == 256 else "split")
        before = _counts(decode_attention)
        out = decode_attention(q1, *padded_kv, dpos, *scales)
        assert _moved(decode_attention, before) == _want(design, padded)
        _check(f"decode d{d} {name}", out, decode_attention_plain(q1, *true, dpos, *scales))

    nk, nv = _bf16(gen, b, kh, 1, d, device=cuda), _bf16(gen, b, kh, 1, d, device=cuda)
    rows = (torch.arange(b, device=cuda)[:, None], torch.arange(kh, device=cuda)[None, :], dpos.long()[:, None])
    (nkq, nks), (nvq, nvs) = quantize_kv(nk), quantize_kv(nv)
    ks[rows], vs[rows] = nks[:, :, 0, 0], nvs[:, :, 0, 0]
    fused = {"bf16": ((nk, nv), (k, v), ()),
             "int8": ((nkq, nvq), (kq, vq), (nks[..., 0], nvs[..., 0], ks, vs))}
    for name, (new, cache, scales) in fused.items():
        kp, vp = (pad_head(c, dc).contiguous() for c in cache)
        kt, vt = (c.clone() for c in cache)
        before = _counts(fused_decode_attention)
        out, kp, vp = fused_decode_attention(q1, *(pad_head(x, dc) for x in new), kp, vp, dpos, *scales)
        assert _moved(fused_decode_attention, before) == _want(decode_design(dc, s, name == "int8", h // kh), padded)
        ref, kt, vt = fused_decode_attention_plain(q1, *new, kt, vt, dpos, *scales)
        _check(f"fused decode d{d} {name}", out, ref)
        assert torch.equal(kp[..., :d], kt) and torch.equal(vp[..., :d], vt) and not kp[..., d:].any()


@pytest.mark.parametrize("d", [128, 256])
def test_group_of_3_on_an_int8_cache_of_1022_rows(cuda, d):
    """A group of 3 at head_dim d over an int8 cache of 1022 rows: the
    rows design takes no group of 3 and the split design wants the rows a
    multiple of 4, so the cache is laid out at 1024 rows; decode and fused
    decode through the split design (at 256 its instance of 4 warps)
    against the plain versions over the 1022 rows."""
    b, s, h, kh = 8, 1022, 12, 4
    sp, dp = cache_layout(d, s, True, 3)
    assert (sp, dp) == (1024, d) and decode_design(d, s, True, 3) == "split"
    gen = torch.Generator(device=cuda).manual_seed(3)
    k, v = _bf16(gen, b, kh, sp, d, device=cuda), _bf16(gen, b, kh, sp, d, device=cuda)
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    ks, vs = ks[..., 0].contiguous(), vs[..., 0].contiguous()
    q = _bf16(gen, b, 1, h, d, device=cuda)
    pos = torch.tensor([0, 1, 255, 256, 511, 700, 1000, s - 1], dtype=torch.int32, device=cuda)
    before = _counts(decode_attention)
    out = decode_attention(q, kq, vq, pos, ks, vs)
    assert _moved(decode_attention, before) == {"launches": 1, "launches_split": 1}
    true = [t[:, :, :s].contiguous() for t in (kq, vq, ks, vs)]
    _check(f"decode g3 int8 S=1022 d{d}", out, decode_attention_plain(q, *true[:2], pos, *true[2:]))
    nk, nv = _bf16(gen, b, kh, 1, d, device=cuda), _bf16(gen, b, kh, 1, d, device=cuda)
    (nkq, nks), (nvq, nvs) = quantize_kv(nk), quantize_kv(nv)
    rows = (torch.arange(b, device=cuda)[:, None], torch.arange(kh, device=cuda)[None, :], pos.long()[:, None])
    ks[rows], vs[rows] = nks[:, :, 0, 0], nvs[:, :, 0, 0]
    kc, vc = kq.clone(), vq.clone()
    out, kc, vc = fused_decode_attention(q, nkq, nvq, kc, vc, pos, nks[..., 0], nvs[..., 0], ks, vs)
    true = [t[:, :, :s].clone() for t in (kq, vq, ks, vs)]
    ref, kt, vt = fused_decode_attention_plain(q, nkq, nvq, true[0], true[1], pos, nks[..., 0], nvs[..., 0],
                                               true[2], true[3])
    _check(f"fused decode g3 int8 S=1022 d{d}", out, ref)
    assert torch.equal(kc[:, :, :s], kt) and torch.equal(vc[:, :, :s], vt)


def test_llama_at_head_dim_80_through_the_engine(cuda):
    """A small bf16 llama at head_dim 80 (4 heads of 80, 2 kv heads): the
    kernels' logits within bf16 noise of attn_impl plain; the Engine on the
    dense cache, laid out at 128, serves greedy requests (short prompts and
    chunks) with every flash, cached-flash and decode launch through the
    padded route, replays included."""
    cfg = llama.LlamaConfig(vocab_size=512, dim=320, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=640,
                            max_seq_len=256)
    params = llama.init_params(cfg, seed=0, device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (1, 40), device=cuda)
    kern, _ = llama.forward(params, tokens, cfg)
    plain, _ = llama.forward(params, tokens, cfg.replace(attn_impl="plain"))
    assert (kern - plain).abs().max().item() <= 0.05 * kern.abs().max().item()
    engine = Engine(cfg, params, EngineConfig(max_batch=4, max_seq_len=128, max_prefill_len=32, eos_token_id=-1,
                                              kv_layout="dense"))
    assert tuple(engine.cache["k"].shape[3:]) == (128, 128) and "head_dim 80 padded to 128" in engine.attention_route()
    counters = (fa.flash_attention, fa.flash_cached_attention, decode_attention)
    before = [dict(_counts(c)) for c in counters]
    engine.start()
    try:
        outs = [engine.generate([(7 * i + j) % 500 for j in range(n)], max_tokens=6) for i, n in enumerate((5, 70))]
    finally:
        engine.stop()
    assert [len(o) for o in outs] == [6, 6]
    got = {c.__name__: {k: v - b[k] + engine.replayed_launches(f"{c.__name__}.{k}") for k, v in _counts(c).items()}
           for c, b in zip(counters, before)}
    print(f"launches {got}, stats {engine.stats}")
    for name, n in got.items():
        assert n["launches"] > 0 and n["launches_padded"] == n["launches"], name
