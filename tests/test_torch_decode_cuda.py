"""The decode attention and the fused cache write + decode attention of
csrc/decode_split.cu (S split over blocks) against their plain PyTorch
versions, on the card.

Every test here needs an NVIDIA card (the kernels are CUDA C++ for sm_90a
with no CPU mode) and skips without one. The file imports only torch and
the port, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda -rP tests/test_torch_decode_cuda.py

Each call must launch the design decode_design names (the per-design
counters). Positions cut at and around the splits of decode_split_plan,
with pos < 0 (decode: exactly 0), pos >= S (decode: every row; fused: a
drifted slot clamped onto row S-1) and pos = 0 (fused: the current token
alone). Tolerance: every output vector (one query row, over D) within
ROW_REL = 2^-6 of its own norm, or of 2^-8 of the RMS vector norm where
that is larger. Both sides compute in f32 and round the output to bf16;
they differ in the order of the f32 sums, so a vector moves by about one
bf16 ulp, while dropping one split's rows moves whole vectors
(chip_smoke.py checks that the limit rejects that). The fused kernel's
row write is held bit for bit. The Engine's decode step, captured as one
CUDA graph (serve/decode_graph.py), is held token for token against the
eager synchronous step. Each test prints its readings (pytest -rP).
"""
import numpy as np
import pytest
import torch

from substratus_tpu_torch import kernels
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain
from substratus_tpu_torch.ops.fused_decode import (
    decode_design, decode_split_plan, fused_decode_attention, fused_decode_attention_plain, sm_count)
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


def _launched(fn, call):
    """Run call() and return the growth of fn's per-design counters."""
    before = {d: getattr(fn, f"launches_{d}") for d in ("split", "rows")}
    out = call()
    return out, {d: getattr(fn, f"launches_{d}") - n for d, n in before.items()}


def _quantized(x):
    xq, xs = quantize_kv(x)
    return xq, xs[..., 0].contiguous()


def _check_decode(gen, b, s, h, kh, d, positions, label):
    """decode_attention (bf16 and int8) and fused_decode_attention (bf16
    and int8) at `positions` against their plain versions."""
    dev = gen.device
    q = torch.randn((b, 1, h, d), generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((b, kh, s, d), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    nk, nv = (torch.randn((b, kh, 1, d), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    (kq, ks), (vq, vs) = _quantized(k), _quantized(v)
    (nkq, nks), (nvq, nvs) = _quantized(nk), _quantized(nv)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    plan = decode_split_plan(s, b * kh, sm_count(dev.index))
    for int8 in (False, True):
        assert decode_design(d, s, int8) == "split"
        args = (kq, vq, pos, ks, vs) if int8 else (k, v, pos)
        out, launched = _launched(decode_attention, lambda: decode_attention(q, *args))
        ref = decode_attention_plain(q, *args)
        torch.cuda.synchronize()
        err = _row_err(out, ref)
        print(f"decode {label} int8={int8} plan {plan}: row error {err:.4g} (limit {ROW_REL})")
        assert launched == {"split": 1, "rows": 0}
        assert torch.isfinite(out.float()).all() and err <= ROW_REL
        assert torch.all(out[pos < 0] == 0)  # no live column: exactly 0

    # Fused: the caller has already written the fresh scales at the
    # clamped positions.
    rows = (torch.arange(b, device=dev)[:, None], torch.arange(kh, device=dev)[None, :],
            torch.clamp(pos.long(), 0, s - 1)[:, None])
    ks[rows], vs[rows] = nks[:, :, 0], nvs[:, :, 0]
    for int8, new, cache, scales in ((False, (nk, nv), (k, v), ()),
                                     (True, (nkq, nvq), (kq, vq), (nks, nvs, ks, vs))):
        kc, vc = (c.clone() for c in cache)
        kp, vp = (c.clone() for c in cache)
        (out, k_out, v_out), launched = _launched(
            fused_decode_attention, lambda: fused_decode_attention(q, *new, kc, vc, pos, *scales))
        ref, _, _ = fused_decode_attention_plain(q, *new, kp, vp, pos, *scales)
        torch.cuda.synchronize()
        err = _row_err(out, ref)
        print(f"fused {label} int8={int8} plan {plan}: row error {err:.4g} (limit {ROW_REL})")
        assert launched == {"split": 1, "rows": 0} and k_out is kc and v_out is vc
        assert torch.isfinite(out.float()).all() and err <= ROW_REL
        # The fresh row at the clamped position, and no other row moved.
        assert torch.equal(kc[rows], new[0][:, :, 0]) and torch.equal(vc[rows], new[1][:, :, 0])
        assert torch.equal(kc, kp) and torch.equal(vc, vp)


@pytest.mark.parametrize("h,kh,d", [
    (32, 32, 128),  # llama2-7b: G = 1
    (32, 8, 128),  # llama3-8b: G = 4
    (32, 4, 64),  # tinyllama: G = 8, head_dim 64
    (64, 8, 128),  # llama2-70b: G = 8
])
def test_split_kernels_match_plain(cuda, h, kh, d):
    """B = 8, S = 2048 (serve-int4's cache): one slot before the cache (pos
    -1), one at 0, three at and around the first split's last row, one in
    a later split, one at S-1 and one past S."""
    b, s = 8, 2048
    n_split, rows = decode_split_plan(s, b * kh, sm_count(cuda.index))
    assert n_split > 1  # the combine runs
    positions = [-1, 0, rows - 1, rows, rows + 1, rows + rows // 2, s - 1, s + 100]
    gen = torch.Generator(device=cuda).manual_seed(h + kh + d)
    _check_decode(gen, b, s, h, kh, d, positions, f"h{h}/{kh} d{d}")


def test_one_long_conversation(cuda):
    """B = 1, S = 4096 at llama2-7b's heads, position 4000: 32 kv heads,
    so the rows design ran 32 blocks; here each head's history splits."""
    n_split, rows = decode_split_plan(4096, 32, sm_count(cuda.index))
    assert n_split * 32 > sm_count(cuda.index)
    gen = torch.Generator(device=cuda).manual_seed(4000)
    _check_decode(gen, 1, 4096, 32, 32, 128, [4000], "b1 s4096 pos 4000")


def test_ragged_caches(cuda):
    """Cache lengths that are not whole tiles: S = 100 in one split, whose
    block writes o itself (its last tile 4 rows), and S = 1000 in four
    splits (the last split's last tile 8 rows)."""
    assert decode_split_plan(100, 2 * 8, sm_count(cuda.index))[0] == 1
    assert decode_split_plan(1000, 8 * 8, sm_count(cuda.index))[0] > 1
    gen = torch.Generator(device=cuda).manual_seed(100)
    _check_decode(gen, 2, 100, 32, 8, 128, [5, 99], "b2 s100")
    _check_decode(gen, 8, 1000, 32, 8, 128, [-1, 0, 31, 255, 256, 700, 999, 1200], "b8 s1000")


def test_entry_points_refuse(cuda):
    """The C entry points refuse what the design does not take: a head_dim
    of 96, a group of more slices of 8 query rows than the grid's z axis
    holds (65535), rows that are not whole tiles or leave a split empty, a
    missing workspace, an int8 cache whose S is not a multiple of 4 (its
    scale rows are copied 16 bytes at a time), a misaligned cache. A group
    of 3 they take (its values: tests/test_torch_decode_groups_cuda.py)."""
    lib = kernels.library()
    b, s, d = 2, 512, 128
    q = torch.zeros((b, 1, 24, d), dtype=torch.bfloat16, device=cuda)  # room for 24 query heads
    k = torch.zeros((b, 8, s, d), dtype=torch.bfloat16, device=cuda)
    k8 = torch.zeros((b, 8, s - 2, d), dtype=torch.int8, device=cuda)
    sc = torch.zeros((b, 8, s), dtype=torch.float32, device=cuda)
    pos = torch.zeros((b,), dtype=torch.int32, device=cuda)
    ws = torch.zeros(1 << 20, dtype=torch.float32, device=cuda)
    stream = kernels.stream_ptr(cuda)

    def call(kk=k, ks=None, h=8, kh=8, dd=d, ss=s, dtype=0, rows=256, n_split=2, w=ws, off=0):
        return lib.decode_split(q.data_ptr(), kk.data_ptr() + off, kk.data_ptr(), ks, ks, pos.data_ptr(),
                                q.data_ptr(), w.data_ptr() if w is not None else None, b, h, kh, ss, dd, dtype,
                                dd**-0.5, rows, n_split, stream)

    assert call() == 0
    torch.cuda.synchronize()
    assert call(dd=96) == -2 and call(h=24, kh=8) == 0 and call(h=8 * 65535 + 1, kh=1) == -1
    torch.cuda.synchronize()
    assert call(rows=200) == -1 and call(rows=128, n_split=2) == -1 and call(rows=256, n_split=3) == -1
    assert call(w=None) == -1 and call(off=2) == -1
    assert call(kk=k8, ks=sc.data_ptr(), dtype=1, ss=s - 2) == -1  # S % 4 != 0
    assert call(dtype=2) == -3
    assert decode_design(d, s - 2, True) == "rows" and decode_design(32, s, False) == "rows"


@pytest.mark.parametrize("impl,kv", [("kernel", "model"), ("fused", "int8")])
def test_engine_decode_steps_launch_the_split_design(cuda, impl, kv):
    """A small model at head_dim 128 (4 heads, 2 kv heads) served greedily
    by the Engine: every decode step launches the split design once per
    layer and never the rows design; each served token is within 5% of the
    logit scale of the best logit of a single-shot forward over prompt +
    tokens (bf16 cache) or at least finite (int8)."""
    cfg = llama.LlamaConfig(vocab_size=512, dim=512, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=1024,
                            max_seq_len=512, decode_attn_impl=impl)
    params = llama.init_params(cfg, seed=0)
    engine = Engine(cfg, params, EngineConfig(max_batch=4, max_seq_len=512, eos_token_id=-1, kv_cache_dtype=kv,
                                              kv_layout="dense"))
    fn = decode_attention if impl == "kernel" else fused_decode_attention
    before = {d: getattr(fn, f"launches_{d}") for d in ("split", "rows")}
    prompts = [[(5 * i + j) % 500 + 1 for j in range(n)] for i, n in enumerate((300, 40, 7))]
    engine.start()
    try:
        outs = [engine.generate(p, max_tokens=8, temperature=0.0) for p in prompts]
    finally:
        engine.stop()
    # The wrapper counts the graph's warm-up; replays hold the rest.
    launched = {d: getattr(fn, f"launches_{d}") - n + engine.replayed_launches(f"{fn.__name__}.launches_{d}")
                for d, n in before.items()}
    steps = engine.stats["decode_steps"] + engine.stats["graph_warmups"]
    print(f"engine {impl} {kv}: {engine.stats['decode_steps']} decode steps ({engine.stats['graph_replays']} "
          f"replays), launches {launched}")
    assert all(len(o) == 8 for o in outs)
    assert launched == {"split": 2 * steps, "rows": 0} and launched["split"] > 0
    for prompt, toks in zip(prompts, outs):
        logits, _ = llama.forward(params, torch.tensor([prompt + toks[:-1]], device=cuda), cfg)
        logits = logits[0, len(prompt) - 1:].float()
        assert torch.isfinite(logits).all()
        if kv == "model":
            gaps = logits.max(dim=-1).values - logits[torch.arange(len(toks)), torch.tensor(toks)]
            assert gaps.max().item() <= 0.05 * logits.abs().max().item()


def test_decode_graph_replays_the_eager_step(cuda):
    """The default Engine (overlapped, the decode step one CUDA graph,
    fused decode at head_dim 128) gives the greedy tokens of the
    synchronous eager step (overlap=False, decode_graph=False); its graph
    is captured once (one warm-up) and replayed at every step; four
    replays on the same inputs at temperature 50 draw four different rows
    and advance the generator; a steady-state dispatch makes no host sync."""
    cfg = llama.LlamaConfig(vocab_size=512, dim=512, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=1024,
                            max_seq_len=512, decode_attn_impl="fused")
    params = llama.init_params(cfg, seed=0)
    prompts = [[(3 * i + j) % 500 + 1 for j in range(n)] for i, n in enumerate((200, 40, 7, 90, 13))]
    engines, outs = {}, {}
    for name, overlap, graph in (("graph", None, True), ("eager", False, False)):
        engine = engines[name] = Engine(cfg, params, EngineConfig(max_batch=4, max_seq_len=512, eos_token_id=-1,
                                                                  overlap=overlap, kv_layout="dense"),
                                        decode_graph=graph)
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
    print(f"graph engine: {engine.stats}; one replay holds {engine._graph.captured}")
    assert outs["graph"] == outs["eager"] and all(len(t) == 12 for t in outs["graph"])
    assert engine.overlap and engines["eager"].stats["graph_replays"] == 0
    assert engine.stats["graph_warmups"] == 1 and engine.stats["graph_replays"] == engine.stats["decode_steps"]
    assert engine._graph.captured["fused_decode_attention.launches_split"] == cfg.n_layers

    b = engine.ec.max_batch
    offset = engine.generator.get_offset()
    hot = (engine.tokens, engine.positions, np.full(b, 50.0, np.float32), np.ones(b, np.float32), np.ones(b, bool))
    draws = {tuple(engine._graph.launch(*hot)().tolist()) for _ in range(4)}
    assert len(draws) == 4 and engine.generator.get_offset() > offset

    for i in range(b):
        engine.queue.put(Request([i + 1] * 30, max_tokens=1000, temperature=0.5 * (i % 2)))
        assert engine._admit() == 1
    engine._step()
    engine._step()
    dispatch = engine._dispatch

    def sync_free():
        torch.cuda.set_sync_debug_mode("error")
        try:
            return dispatch()
        finally:
            torch.cuda.set_sync_debug_mode(0)

    engine._dispatch = sync_free
    for _ in range(4):
        engine._step()
    del engine._dispatch
    engine._flush()
    assert engine.stats["graph_warmups"] == 1


def test_paged_graph_replays_the_eager_step(cuda):
    """On the paged pool (the default layout for llama) the overlapped
    engine's captured step, whose block table is a static input, gives
    the greedy tokens of the synchronous eager paged step, through pages
    grown since the capture and a pool too small for the demand (the same
    preemptions in both); no attention kernel runs on this path and every
    page comes back."""
    cfg = llama.LlamaConfig(vocab_size=512, dim=512, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=1024,
                            max_seq_len=512)
    params = llama.init_params(cfg, seed=0)
    prompts = [[(3 * i + j) % 500 + 1 for j in range(n)] for i, n in enumerate((200, 40, 7, 90, 13))]
    engines, outs = {}, {}
    for name, overlap, graph in (("graph", None, True), ("eager", False, False)):
        # 33 pages of 16: the first four requests need 39 by their last token.
        engine = engines[name] = Engine(cfg, params, EngineConfig(max_batch=4, max_seq_len=512, eos_token_id=-1,
                                                                  overlap=overlap, kv_pool_tokens=528),
                                        decode_graph=graph)
        engine.start()
        try:
            reqs = [engine.submit(Request(p, max_tokens=64, temperature=0.0)) for p in prompts]
            outs[name] = []
            for req in reqs:
                toks = []
                while (tok := req.out.get(timeout=300)) is not None:
                    toks.append(tok)
                outs[name].append(toks)
        finally:
            engine.stop()
    engine, eager = engines["graph"], engines["eager"]
    print(f"paged graph engine: {engine.stats}; one replay holds {engine._graph.captured}")
    assert engine.paged and engine.n_pages == 33 and engine.overlap and eager.stats["graph_replays"] == 0
    assert outs["graph"] == outs["eager"] and all(len(t) == 64 for t in outs["graph"])
    assert engine.stats["preemptions"] == eager.stats["preemptions"] >= 1
    assert engine.stats["truncated_by_pool"] == 0
    assert engine.stats["graph_warmups"] == 1 and engine.stats["graph_replays"] == engine.stats["decode_steps"]
    assert engine._graph.captured == {}  # the gather and the plain attention: no kernel wrapper
    for e in engines.values():
        assert e.alloc.free_pages + len(e.prefix) == e.n_pages and not e.block_table.any()
