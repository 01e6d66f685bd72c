"""The decode kernels of csrc/decode_split.cu at query groups other than 1,
2, 4 and 8, on the card: a group of 3 (one block of 4 rows, one masked),
16 (falcon-40b's heads: two slices of 8) and 71 (falcon-7b's: nine
slices, the last of 7 rows), bf16 and int8 caches, decode and fused,
against their plain PyTorch versions; and the Falcon Engine's decode step,
captured as one CUDA graph, against the eager synchronous step.

Every test here needs an NVIDIA card (the kernels are CUDA C++ for sm_90a
with no CPU mode) and skips without one. The file imports only torch and
the port, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda -rP tests/test_torch_decode_groups_cuda.py

Tolerance as in tests/test_torch_decode_cuda.py: every output vector
within ROW_REL = 2^-6 of its own norm (or of 2^-8 of the RMS vector norm
where that is larger); the fused kernel's row write bit for bit. Positions
cut at and around the splits of the plan, which counts a block per slice.
"""
import pytest
import torch

from substratus_tpu_torch.models import falcon
from substratus_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain
from substratus_tpu_torch.ops.fused_decode import (
    decode_design, decode_split_plan, fused_decode_attention, fused_decode_attention_plain, group_slices, sm_count)
from substratus_tpu_torch.ops.quant import quantize_kv
from substratus_tpu_torch.serve.engine import Engine, EngineConfig, Request

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


def _quantized(x):
    xq, xs = quantize_kv(x)
    return xq, xs[..., 0].contiguous()


@pytest.mark.parametrize("b,s,h,kh,d", [
    (4, 1024, 12, 4, 128),  # a group of 3
    (8, 1024, 128, 8, 64),  # falcon-40b: 16
    (16, 1024, 71, 1, 64),  # falcon-7b: 71
], ids=["g3", "g16", "g71"])
def test_any_group_matches_plain(cuda, b, s, h, kh, d):
    g = h // kh
    rows_a_block, n_slice = group_slices(g)
    n_split, rows = decode_split_plan(s, b * kh * n_slice, sm_count(cuda.index))
    print(f"group {g}: blocks of {rows_a_block} rows, {n_slice} a kv head; plan {n_split} x {rows}")
    gen = torch.Generator(device=cuda).manual_seed(h + kh + d)
    cuts = [-1, 0, rows - 1, rows, rows + 1, s - 1, s + 100, rows // 2]
    positions = (cuts * (-(-b // len(cuts))))[:b]
    q = torch.randn((b, 1, h, d), generator=gen, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn((b, kh, s, d), generator=gen, device=cuda).to(torch.bfloat16) for _ in range(2))
    nk, nv = (torch.randn((b, kh, 1, d), generator=gen, device=cuda).to(torch.bfloat16) for _ in range(2))
    (kq, ks), (vq, vs) = _quantized(k), _quantized(v)
    (nkq, nks), (nvq, nvs) = _quantized(nk), _quantized(nv)
    pos = torch.tensor(positions, dtype=torch.int32, device=cuda)
    for int8 in (False, True):
        assert decode_design(d, s, int8) == "split"
        args = (kq, vq, pos, ks, vs) if int8 else (k, v, pos)
        before = decode_attention.launches_split
        out = decode_attention(q, *args)
        ref = decode_attention_plain(q, *args)
        torch.cuda.synchronize()
        err = _row_err(out, ref)
        print(f"decode g{g} int8={int8}: row error {err:.4g} (limit {ROW_REL})")
        assert decode_attention.launches_split == before + 1
        assert torch.isfinite(out.float()).all() and err <= ROW_REL
        assert torch.all(out[pos < 0] == 0)
    rows_idx = (torch.arange(b, device=cuda)[:, None], torch.arange(kh, device=cuda)[None, :],
                torch.clamp(pos.long(), 0, s - 1)[:, None])
    ks[rows_idx], vs[rows_idx] = nks[:, :, 0], nvs[:, :, 0]
    for int8, new, cache, scales in ((False, (nk, nv), (k, v), ()),
                                     (True, (nkq, nvq), (kq, vq), (nks, nvs, ks, vs))):
        kc, vc = (c.clone() for c in cache)
        kp, vp = (c.clone() for c in cache)
        before = fused_decode_attention.launches_split
        out, _, _ = fused_decode_attention(q, *new, kc, vc, pos, *scales)
        ref, _, _ = fused_decode_attention_plain(q, *new, kp, vp, pos, *scales)
        torch.cuda.synchronize()
        err = _row_err(out, ref)
        print(f"fused g{g} int8={int8}: row error {err:.4g} (limit {ROW_REL})")
        assert fused_decode_attention.launches_split == before + 1
        assert torch.isfinite(out.float()).all() and err <= ROW_REL
        assert torch.equal(kc, kp) and torch.equal(vc, vp)  # the fresh row written once, by one block


def test_rows_design_refuses_other_groups(cuda):
    """Head dims 16 and 32 (csrc/decode_attn.cu, csrc/fused_decode.cu)
    take groups of 1, 2, 4 and 8 only: a group of 3 raises by name."""
    q = torch.zeros((2, 1, 6, 32), dtype=torch.bfloat16, device=cuda)
    k = torch.zeros((2, 2, 64, 32), dtype=torch.bfloat16, device=cuda)
    pos = torch.zeros((2,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="takes groups"):
        decode_attention(q, k, k, pos)
    with pytest.raises(ValueError, match="takes groups"):
        fused_decode_attention(q, k[:, :, :1], k[:, :, :1], k.clone(), k.clone(), pos)


def test_falcon_decode_graph_replays_the_eager_step(cuda):
    """Falcon at falcon-7b's heads (71 on one kv head, head_dim 64), two
    layers: the default Engine (overlapped, the step one CUDA graph) gives
    the greedy tokens of the synchronous eager step, every decode step
    launching the split design once a layer."""
    cfg = falcon.FalconConfig(vocab_size=512, n_layers=2, max_seq_len=512)
    params = falcon.init_params(cfg, seed=0)
    prompts = [[(3 * i + j) % 500 + 1 for j in range(n)] for i, n in enumerate((200, 40, 7, 90, 13))]
    outs, engines = {}, {}
    for name, overlap, graph in (("graph", None, True), ("eager", False, False)):
        engine = engines[name] = Engine(cfg, params, EngineConfig(max_batch=4, max_seq_len=512, eos_token_id=-1,
                                                                  overlap=overlap), decode_graph=graph)
        engine.start()
        try:
            reqs = [engine.submit(Request(p, max_tokens=12, temperature=0.0)) for p in prompts]
            outs[name] = []
            for req in reqs:
                toks = []
                while (tok := req.out.get(timeout=300)) is not None:
                    toks.append(tok)
                outs[name].append(toks)
        finally:
            engine.stop()
    engine = engines["graph"]
    print(f"falcon graph engine: {engine.stats}; one replay holds {engine._graph.captured}")
    assert not engine.paged and outs["graph"] == outs["eager"] and all(len(t) == 12 for t in outs["graph"])
    assert engine.stats["graph_warmups"] == 1 and engine.stats["graph_replays"] == engine.stats["decode_steps"]
    assert engine._graph.captured["decode_attention.launches_split"] == cfg.n_layers
