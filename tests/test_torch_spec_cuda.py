"""Speculative decoding on the card: the cached flash kernel at the verify
shapes, the spec round's CUDA graphs against the eager round, and the
int4 matmul's designs by verify width.

Every test here needs an NVIDIA card (the kernels are CUDA C++ for sm_90a
with no CPU mode) and skips without one. The file imports only torch and
the port, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda -rP tests/test_torch_spec_cuda.py

A verify over the dense cache runs flash_cached_attention on B rows of
2..k+1 queries (until this slice the kernel ran only at B = 1): per-row
positions, rows at the window's last position and past it (an idle slot
drifts to S-1; its verify asks for S-1.. S+k-1), bf16 and int8 caches.
Tolerance as in tests/test_torch_kernels_cuda.py: every output vector
within ROW_REL = 2^-6 of its own norm (or of 2^-8 of the RMS vector norm
where that is larger). Each test prints its readings (pytest -rP).
"""
import pytest
import torch

from substratus_tpu_torch.models import llama
from substratus_tpu_torch.ops.flash_attention import flash_cached_attention, flash_cached_attention_plain
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


@pytest.mark.parametrize("b,sq,int8", [(8, 5, False), (24, 4, True), (8, 2, True)])
def test_cached_flash_at_verify_shapes(cuda, b, sq, int8):
    """B rows of sq queries at per-row positions over a 1024-row cache of
    llama2-7b's heads; two rows idle at the window's end (positions S-1
    and past it, which attend the whole cache)."""
    gen = torch.Generator(device=cuda).manual_seed(b * 10 + sq)
    s, h, d = 1024, 32, 128
    q = torch.randn((b, sq, h, d), generator=gen, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn((b, h, s, d), generator=gen, device=cuda).to(torch.bfloat16) for _ in range(2))
    pos0 = torch.randint(0, s - sq, (b,), generator=gen, device=cuda)
    pos0[-2:] = s - 1  # idle slots, clamped onto S-1
    positions = pos0[:, None] + torch.arange(sq, device=cuda)[None, :]
    if int8:
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        args = (kq, vq, positions, ks[..., 0].contiguous(), vs[..., 0].contiguous())
    else:
        args = (k, v, positions)
    before = flash_cached_attention.launches_wgmma
    got = flash_cached_attention(q, *args)
    assert flash_cached_attention.launches_wgmma == before + 1
    ref = flash_cached_attention_plain(q, *args)
    err = _row_err(got, ref)
    print(f"cached flash B={b} Sq={sq} {'int8' if int8 else 'bf16'}: row error {err:.3g} (limit {ROW_REL:.3g})")
    assert torch.isfinite(got).all() and err <= ROW_REL


CFG = llama.LlamaConfig(vocab_size=512, dim=512, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=1024,
                        max_seq_len=256)
PROMPTS = [[(3 * i + j) % 500 + 1 for j in range(n)] for i, n in enumerate((40, 7, 90, 13))]
PROMPTS += [[37, 38, 39, 40] * 12, [101, 102, 103] * 20]  # repetitive: lookup matches


def _serve(engine, prompts, max_tokens=40):
    """Every request queued before the scheduler starts, so that its first
    iteration admits them all and the schedule repeats from run to run."""
    reqs = [engine.submit(Request(list(p), max_tokens=max_tokens, temperature=0.0)) for p in prompts]
    engine.start()
    try:
        outs = []
        for req in reqs:
            toks = []
            while (tok := req.out.get(timeout=300)) is not None:
                toks.append(tok)
            outs.append(toks)
        return outs
    finally:
        engine.stop()


@pytest.mark.parametrize("mode", ["lookup-paged", "lookup-dense-fused", "draft-self", "draft-other"])
def test_spec_graphs_replay_the_eager_round(cuda, mode):
    """The default spec engine (overlapped, each round's advance, propose
    and verify of its width replayed CUDA graphs in one pool) gives the
    greedy tokens and the spec counters of the eager round with the same
    scheduler (decode_graph=False): the same schedule, so the same widths
    and kernels. (The synchronous engine plans each round from settled
    acceptance and history, the overlapped one a round ahead, as in JAX,
    so their proposals differ.) Every round replays, each graph was
    warmed up once."""
    params = llama.init_params(CFG, seed=0)
    cfg, draft = CFG, None
    if mode == "lookup-dense-fused":
        cfg = CFG.replace(decode_attn_impl="fused")
    elif mode == "draft-self":
        draft = (CFG, params)
    elif mode == "draft-other":
        draft = (CFG.replace(n_layers=1), llama.init_params(CFG.replace(n_layers=1), seed=1))
    layout = "dense" if "dense" in mode else "paged"
    outs, engines = {}, {}
    for name, graph in (("graph", True), ("eager", False)):
        ec = EngineConfig(max_batch=8, max_seq_len=256, eos_token_id=-1, kv_layout=layout, spec_k=3)
        engines[name] = Engine(cfg, params, ec, decode_graph=graph, draft=draft)
        outs[name] = _serve(engines[name], PROMPTS)
    engine = engines["graph"]
    st = engine.stats
    widths = {w: st[f"rounds_w{w}"] for w in range(1, 5)}
    print(f"{mode}: rounds by width {widths}, verify passes {st['verify_passes']}, proposed {st['spec_proposed']}, "
          f"accepted {st['spec_accepted']}; graphs {sorted(engine._graph.graphs)}, one replay of each holds "
          f"{engine._graph.captured}")
    assert outs["graph"] == outs["eager"] and all(len(t) == 40 for t in outs["graph"])
    assert {k: st[k] for k in ("spec_proposed", "spec_accepted", "verify_passes")} == {
        k: engines["eager"].stats[k] for k in ("spec_proposed", "spec_accepted", "verify_passes")}
    assert st["graph_replays"] == st["decode_steps"] and engines["eager"].stats["graph_replays"] == 0
    assert st["graph_warmups"] == len(engine._graph.graphs) and st["verify_passes"] > 0
    if mode != "draft-other":
        assert st["spec_accepted"] > 0
    if layout == "dense":
        wide = sum(st[f"rounds_w{w}"] for w in range(2, 5))
        assert engine.replayed_launches("flash_cached_attention.launches_wgmma") == CFG.n_layers * wide
        assert engine.replayed_launches("fused_decode_attention.launches_split") == CFG.n_layers * st["rounds_w1"]


def test_int4_designs_by_verify_width(cuda):
    """int4 weights, B = 8: a verify of width 1-2 (M = 8-16 rows) runs the
    decode design, of width 3-4 (M = 24-32) the wgmma design, each
    projection and the lm_head once a forward."""
    params = llama.quantize_weights(llama.init_params(CFG, seed=0), "int4")
    engine = Engine(CFG, params, EngineConfig(max_batch=8, max_seq_len=256, eos_token_id=-1, kv_layout="dense",
                                              kv_cache_dtype="int8", spec_k=3))
    _serve(engine, PROMPTS + [[7, 8, 9] * 10, [5, 6] * 20])
    per_forward = 7 * CFG.n_layers + 1
    captured = engine._graph.captured
    print(f"int4 by width: rounds {[engine.stats[f'rounds_w{w}'] for w in range(1, 5)]}; one replay holds "
          f"{ {k: v for k, v in captured.items() if k.startswith('verify')} }")
    for w in range(1, 5):
        key = f"verify{w}"
        if key not in captured:
            continue
        design = "launches_decode" if 8 * w <= 16 else "launches_wgmma"
        other = "launches_wgmma" if design == "launches_decode" else "launches_decode"
        assert captured[key].get(f"q4_matmul.{design}") == per_forward
        assert f"q4_matmul.{other}" not in captured[key]
    assert "verify1" in captured and any(f"verify{w}" in captured for w in (3, 4))
