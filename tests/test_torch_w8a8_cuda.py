"""The w8a8 kernels on the card: csrc/w8a8_quantize.cu (per-token int8
activations) and csrc/w8a8_matmul.cu (mma.sync s8 x s8 -> s32 with the
two-scale epilogue), against their plain versions, and the w8a8 decode
step as a CUDA graph against the eager step.

Every test here needs an NVIDIA card (the kernels are CUDA C++ for sm_90a
with no CPU mode) and skips without one. The file imports only torch and
the port, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda -rP tests/test_torch_w8a8_cuda.py

Tolerance: none. The quantization's int8 rows and scales are the plain
version's bit for bit (IEEE divisions, round half to even on both sides);
the s32 sums are exact, and the epilogue multiplies in the plain version's
order, so the bf16 outputs are equal too.
"""
import pytest
import torch

from substratus_tpu_torch.models import llama
from substratus_tpu_torch.ops import quant
from substratus_tpu_torch.ops.quant import (w8a8_matmul, w8a8_matmul_plain, w8a8_quantize, w8a8_quantize_plain,
                                            w8a8_scale)
from substratus_tpu_torch.serve.engine import Engine, EngineConfig, Request

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no CPU mode")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return gen


def test_quantize_kernel_bit_for_bit(cuda):
    for m, c, wide in ((1, 4096, False), (8, 4096, False), (77, 11008, False), (512, 14336, False), (8, 4096, True)):
        x = (torch.randn((m, 2 * c if wide else c), generator=cuda, device="cuda") * 4).to(torch.bfloat16)
        x = x[:, :c]  # wide: rows of a wider tensor (a row stride of 2c)
        if m > 1:
            x[0] = 0
        before = w8a8_quantize.launches
        q, s = w8a8_quantize(x)
        rq, rs = w8a8_quantize_plain(x)
        torch.cuda.synchronize()
        assert w8a8_quantize.launches == before + 1
        assert torch.equal(q, rq) and torch.equal(s, rs), (m, c, wide)
        if m > 1:
            assert s[0].item() == 1.0 and not q[0].any()


@pytest.mark.parametrize("m,c,n", [(1, 4096, 4096), (8, 4096, 11008), (8, 11008, 4096), (16, 4096, 32000),
                                   (17, 4096, 4096), (512, 4096, 14336), (77, 144, 48)])
def test_matmul_kernel_exact(cuda, m, c, n):
    xq = torch.randint(-127, 128, (m, c), generator=cuda, device="cuda", dtype=torch.int32).to(torch.int8)
    wq = torch.randint(-127, 128, (c, n), generator=cuda, device="cuda", dtype=torch.int32).to(torch.int8)
    xq[0] = 127
    wq[:, 0] = 127  # one sum of 127^2 C: past f32's exact integers at C = 4096
    a = torch.rand(m, generator=cuda, device="cuda") + 0.01
    w = torch.rand(n, generator=cuda, device="cuda") * 0.01 + 1e-4
    raw = torch.empty((m, n), dtype=torch.int32, device="cuda")
    out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
    w8a8_matmul(xq, a, wq, w, raw, raw=True)
    w8a8_matmul(xq, a, wq, w, out)
    y = w8a8_matmul_plain(xq, wq)
    torch.cuda.synchronize()
    assert torch.equal(raw, y) and raw[0, 0].item() == 127 * 127 * c
    assert torch.equal(out, w8a8_scale(y, a, w, torch.bfloat16))


def test_expert_einsums_on_the_card(cuda):
    """The expert route: one quantize for x, one s8 launch an expert on its
    strided slices, the output written in place: the CPU's result bit for
    bit."""
    E = 4
    for eq, x_shape, w_shape in (("bsd,edm->bsem", (2, 4, 1024), (E, 1024, 512)),
                                 ("bsem,emd->bsed", (2, 4, E, 512), (E, 512, 1024))):
        w = quant.quantize(torch.randn(w_shape, generator=cuda, device="cuda") * 0.03, (1,))
        x = torch.randn(x_shape, generator=cuda, device="cuda").to(torch.bfloat16)
        before = (w8a8_quantize.launches, w8a8_matmul.launches)
        got = quant.qeinsum_w8a8(eq, x, w, torch.bfloat16)
        torch.cuda.synchronize()
        assert (w8a8_quantize.launches, w8a8_matmul.launches) == (before[0] + 1, before[1] + E)
        want = quant.qeinsum_w8a8(eq, x.cpu(), quant.QTensor(w.q.cpu(), w.scale.cpu()), torch.bfloat16)
        assert torch.equal(got.cpu(), want), eq


def test_shapes_the_kernels_cannot_take_raise(cuda):
    before = (w8a8_quantize.launches, w8a8_matmul.launches)
    with pytest.raises(ValueError):
        w8a8_quantize(torch.ones((2, 100), device="cuda", dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        w8a8_quantize(torch.ones((2, 128), device="cuda", dtype=torch.float32))
    xq = torch.ones((2, 128), device="cuda", dtype=torch.int8)
    for n in (40, 8):
        with pytest.raises(ValueError):
            w8a8_matmul(xq, torch.ones(2, device="cuda"), torch.ones((128, n), device="cuda", dtype=torch.int8),
                        torch.ones(n, device="cuda"), torch.empty((2, n), device="cuda", dtype=torch.bfloat16))
    wq = quant.quantize(torch.ones((64, 4, 16), device="cuda"), (0,))
    with pytest.raises(ValueError, match="does not fit the w8a8 kernel"):  # a permuted output: the CPU's einsum
        quant.qeinsum_w8a8("bsd,dhk->bhsk", torch.ones((1, 2, 64), device="cuda", dtype=torch.bfloat16), wq)
    assert w8a8_matmul.launches == before[1]


def test_w8a8_graph_step_matches_the_eager_step(cuda):
    """A small llama in bf16 with w8a8 weights on the dense int8 cache
    (fused decode): the default engine (overlapped, the step one CUDA graph,
    each replay holding 6 x L + 1 launches of each w8a8 kernel) serves the
    tokens of the synchronous eager engine, token for token."""
    cfg = llama.CONFIGS["llama2-7b"].replace(dim=1024, n_layers=2, n_heads=8, n_kv_heads=8, hidden_dim=2816,
                                             quant_activations=True, decode_attn_impl="fused")
    params = llama.init_params(cfg, seed=0, device="cuda", quantize="int8")
    prompts = [[1] + list(range(5 + 3 * i, 30 + 40 * i)) for i in range(4)]
    outs = []
    for graph in (True, False):
        ec = EngineConfig(max_batch=4, max_seq_len=512, kv_layout="dense", kv_cache_dtype="int8",
                          overlap=None if graph else False)
        engine = Engine(cfg, params, ec, device="cuda", decode_graph=graph)
        engine.start()
        try:
            reqs = [engine.submit(Request(list(p), max_tokens=24, temperature=0.0)) for p in prompts]
            toks = []
            for r in reqs:
                t = []
                while (tok := r.out.get(timeout=300)) is not None:
                    t.append(tok)
                toks.append(t)
            outs.append(toks)
            if graph:
                per = 6 * cfg.n_layers + 1
                assert engine._graph.captured["w8a8_quantize.launches"] == per
                assert engine._graph.captured["w8a8_matmul.launches"] == per
        finally:
            engine.stop()
    assert outs[0] == outs[1] and all(len(t) == 24 for t in outs[0])


def test_w8a8_speculative_rounds_graph_against_eager(cuda):
    """Prompt-lookup speculation (k = 3, the paged pool, overlapped) with
    w8a8 weights: every width's SpecGraph replays the w8a8 kernels, and the
    graph engine's tokens are the eager engine's, request for request."""
    cfg = llama.CONFIGS["llama2-7b"].replace(dim=1024, n_layers=2, n_heads=8, n_kv_heads=8, hidden_dim=2816,
                                             quant_activations=True)
    params = llama.init_params(cfg, seed=0, device="cuda", quantize="int8")
    prompts = [([100 + 7 * i + j for j in range(5)] * 6) for i in range(4)]
    outs = []
    for graph in (True, False):
        engine = Engine(cfg, params, EngineConfig(max_batch=4, max_seq_len=256, spec_k=3), device="cuda",
                        decode_graph=graph)
        reqs = [engine.submit(Request(list(p), max_tokens=24, temperature=0.0)) for p in prompts]
        engine.start()
        try:
            outs.append([[t for t in iter(r.out.get, None)] for r in reqs])
            if graph:
                assert engine.stats["spec_accepted"] > 0
                verify = [c for k, c in engine._graph.captured.items() if k.startswith("verify")]
                assert verify and all(c["w8a8_matmul.launches"] == 6 * cfg.n_layers + 1 for c in verify)
        finally:
            engine.stop()
    assert outs[0] == outs[1]
