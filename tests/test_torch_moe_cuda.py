"""A mixture of experts' int4 route on the card, at mixtral-8x7b's expert
shapes: q4einsum's expert einsums launch one int4 matmul an expert (the
decode design at decode rows, the wgmma design over a prefill chunk), each
expert's operands checked once, and an MoE layer (router, dropless mix)
through the kernels against the same layer on the plain path.

Every test here needs an NVIDIA card (the kernels are CUDA C++ for sm_90a
with no CPU mode) and skips without one. The file imports only torch and
the port, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda -rP tests/test_torch_moe_cuda.py

Tolerance: as tests/test_torch_q4_decode_cuda.py, every output row within
ROW_REL = 2^-6 of its own norm (or of 2^-8 of the RMS row norm where that
is larger): the kernels and the plain version multiply the same bf16
weights and differ in the f32 summation order and the output's rounding.
"""
import pytest
import torch

from substratus_tpu_torch.models import llama
from substratus_tpu_torch.ops import quant4
from substratus_tpu_torch.ops.quant4 import Q4Tensor, q4_matmul, q4_matmul_plain

pytestmark = pytest.mark.cuda
ROW_REL = 2**-6
E, D, M = 8, 4096, 14336  # mixtral-8x7b's experts


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no CPU mode")
    return torch.device("cuda")


def _row_rel(out, ref) -> float:
    g, r = out.float().flatten(0, -2), ref.float().flatten(0, -2)
    norms = r.norm(dim=-1)
    den = torch.maximum(norms, norms.square().mean().sqrt() * 2**-8).clamp_min(torch.finfo(torch.float32).tiny)
    return ((g - r).norm(dim=-1) / den).max().item()


def _experts(gen, c, n) -> Q4Tensor:
    """A random stacked expert weight [E, c, n] quantized as the model's
    (groups of 128 along c, one expert at a time)."""
    w = torch.randn((E, c, n), generator=gen, device=gen.device, dtype=torch.bfloat16) * c**-0.5
    return llama.quantize_leaf(w, (1,), "int4", experts=True)


def _counts():
    return (q4_matmul.launches_decode, q4_matmul.launches_wgmma, q4_matmul.launches_mma, q4_matmul.launches)


@pytest.mark.parametrize("eq,rows,c,n,design", [
    ("bsd,edm->bsem", 8, D, M, "decode"),  # w_gate/w_up at a decode step of 8 slots
    ("bsem,emd->bsed", 8, M, D, "decode"),  # w_down
    ("bsd,edm->bsem", 512, D, M, "wgmma"),  # w_gate over a 512-row chunk
    ("bsem,emd->bsed", 512, M, D, "wgmma"),  # w_down over a chunk
])
def test_expert_einsum_launches_an_expert(cuda, eq, rows, c, n, design):
    gen = torch.Generator(device=cuda).manual_seed(rows + c)
    w = _experts(gen, c, n)
    shape = (1, rows, c) if eq.startswith("bsd") else (1, rows, E, c)
    x = torch.randn(shape, generator=gen, device=cuda, dtype=torch.bfloat16)
    checked = quant4.check_weight.calls
    before = _counts()
    got = quant4.q4einsum(eq, x, w)
    torch.cuda.synchronize()
    after = _counts()
    want_counts = {"decode": (E, 0, 0, E), "wgmma": (0, E, 0, E)}[design]
    assert tuple(a - b for a, b in zip(after, before)) == want_counts
    assert quant4.check_weight.calls - checked == E  # each expert's operands checked once
    quant4.q4einsum(eq, x, w)
    assert quant4.check_weight.calls - checked == E  # and reused
    errs = []
    for e in range(E):
        xe = x.reshape(rows, c) if eq.startswith("bsd") else x[0, :, e]
        errs.append(_row_rel(got[0, :, e], q4_matmul_plain(xe, w.packed[e], w.scale[e], w.block)))
    print(f"{eq} rows={rows} C={c} N={n}: {E} launches of the {design} design, worst row error {max(errs):.2e}")
    assert max(errs) < ROW_REL, errs


def test_moe_layer_int4_against_plain(cuda):
    """One mixtral-8x7b MoE FFN (router, top 2 of 8, dropless mix) on int4
    experts through the kernels against the same int4 weights dequantized
    to bf16 through torch's einsum (the plain path): every token's output
    row within ROW_REL, the aux equal; 3 x 8 launches of the decode
    design for 16 tokens."""
    cfg = llama.CONFIGS["mixtral-8x7b"].replace(n_layers=1)
    gen = torch.Generator(device=cuda).manual_seed(0)
    block = llama.LlamaBlock(cfg, cuda)
    with torch.no_grad():
        for name in ("router", "w_gate", "w_up", "w_down"):
            w = getattr(block, name)
            w.copy_(torch.randn(w.shape, generator=gen, device=cuda) * w.shape[-2] ** -0.5)
        llama._quantize_module(block, "int4", llama._layer_contracting(cfg), cfg)
        dense = llama.LlamaBlock(cfg, cuda)
        dense.router.copy_(block.router)
        for name in ("w_gate", "w_up", "w_down"):
            getattr(dense, name).copy_(getattr(block, name).dequant(torch.bfloat16))
        h = torch.randn((2, 8, D), generator=gen, device=cuda, dtype=torch.bfloat16)
        before = _counts()
        got, aux = llama._moe_ffn(h, block, cfg, train=False)
        torch.cuda.synchronize()
        after = _counts()
        assert after[3] - before[3] == 3 * E and after[0] - before[0] == 3 * E
        want, want_aux = llama._moe_ffn(h, dense, cfg, train=False)
        torch.cuda.synchronize()
        assert _counts() == after  # the plain path launches no kernel
    err = _row_rel(got, want)
    print(f"mixtral-8x7b MoE layer, 16 tokens, int4 experts: worst row error {err:.2e} against the plain path; "
          f"aux {aux.item():.4f}")
    assert err < ROW_REL and torch.isfinite(got).all()
    assert torch.equal(aux, want_aux)
