"""The int4 matmul's prefill design (csrc/q4_matmul_wgmma.cu) on the card:
against its plain PyTorch version at llama2-7b's projection and lm_head
widths over the prefill row counts, the routing between the three designs
(ops/quant4.py::q4_design) seen through the per-design launch counters,
and the C entry point's refusals. The decode design
(csrc/q4_matmul_decode.cu) has its own file,
tests/test_torch_q4_decode_cuda.py.

Every test here needs an NVIDIA card (the kernels are CUDA C++ for sm_90a
with no CPU mode) and skips without one. The file imports only torch and
the port, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda -rP tests/test_torch_q4_cuda.py

Tolerance. The kernel and the plain version multiply the same bf16
weights ((int4 * scale) in f32, rounded to bf16) and differ only in the f32
summation order and the output's bf16 rounding (2^-8 relative): every
output row (over N) within ROW_REL = 2^-6 of its own norm, or of 2^-8 of
the RMS row norm where that is larger. A dropped scale group (1/32 of C at
C = 4096) moves rows by about 0.18 of their norm; test_planted_faults_fail
checks that the limit rejects it and a dropped ragged row tile.

The checkpoint loaders' device work is here too: GGUF block
dequantization (load/gguf.py, torch ops on the model's device) and the
safetensors reader's tensors loaded into a model on the card, each equal
bit for bit to the same work on the CPU.
"""
import pytest
import torch

from substratus_tpu_torch import kernels
from substratus_tpu_torch.ops.quant4 import q4_design, q4_matmul, q4_matmul_plain, quantize4

pytestmark = pytest.mark.cuda
ROW_REL = 2**-6
PREFILL_M = (32, 64, 77, 128, 200, 512)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no CPU mode")
    return torch.device("cuda")


def _row_rel(out, ref) -> float:
    """The largest error of one output row relative to its own norm, or to
    2^-8 of the RMS row norm where that is larger."""
    g, r = out.float(), ref.float()
    norms = r.norm(dim=-1)
    den = torch.maximum(norms, norms.square().mean().sqrt() * 2**-8).clamp_min(torch.finfo(torch.float32).tiny)
    return ((g - r).norm(dim=-1) / den).max().item()


def _weight(gen, c, n, block=None):
    """A random [c, n] weight quantized as the model's (groups of 128 along
    c), or random bytes and scales for groups of `block`."""
    if block is None:
        qt = quantize4(torch.randn((c, n), generator=gen, device=gen.device) * c**-0.5, (0,))
        return qt.packed, qt.scale, qt.block
    packed = torch.randint(0, 256, (c // 2, n), generator=gen, device=gen.device, dtype=torch.uint8)
    return packed, torch.rand((c // block, n), generator=gen, device=gen.device) * 0.02, block


def _run(gen, m, c, n, weight):
    """(kernel output, plain output, (decode, wgmma, mma) launches of the
    call)."""
    packed, scale, block = weight
    x = torch.randn((m, c), generator=gen, device=gen.device).to(torch.bfloat16)
    counters = ("launches", "launches_decode", "launches_wgmma", "launches_mma")
    before = [getattr(q4_matmul, name) for name in counters]
    out = q4_matmul(x, packed, scale, block)
    ref = q4_matmul_plain(x, packed, scale, block)
    torch.cuda.synchronize()
    after = [getattr(q4_matmul, name) for name in counters]
    assert after[0] == before[0] + 1
    assert out.shape == (m, n) and out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    return out, ref, tuple(a - b for a, b in zip(after[1:], before[1:]))


@pytest.mark.parametrize("c,n", [(4096, 4096), (11008, 4096), (4096, 11008), (4096, 32000)])
def test_prefill_kernel_matches_plain(cuda, c, n):
    """wq/wk/wv/wo, w_down, w_gate/w_up and the lm_head of llama2-7b at
    every prefill row count: each call launches the wgmma design once."""
    gen = torch.Generator(device=cuda).manual_seed(c + n)
    weight = _weight(gen, c, n)
    for m in PREFILL_M:
        out, ref, launched = _run(gen, m, c, n, weight)
        err = _row_rel(out, ref)
        print(f"M={m} C={c} N={n}: row error {err:.4g} (limit {ROW_REL:.4g})")
        assert launched == (0, 1, 0) and err <= ROW_REL, (m, c, n, launched, err)


def test_ragged_and_small_shapes(cuda):
    """Rows past a tile (17, 33, 65, 129, 300 rows), a last column tile of
    16 or 32 columns, and a single scale group."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    for m, c, n in ((17, 256, 144), (33, 1024, 160), (65, 1024, 272), (129, 128, 4112), (300, 384, 272)):
        out, ref, launched = _run(gen, m, c, n, _weight(gen, c, n))
        err = _row_rel(out, ref)
        print(f"M={m} C={c} N={n}: row error {err:.4g}")
        assert launched == (0, 1, 0) and err <= ROW_REL, (m, c, n, launched, err)


def test_routing_keeps_the_mma_kernel(cuda):
    """Decode steps (M <= 16) at every llama2-7b width and the lm_head go
    to the decode design (csrc/q4_matmul_decode.cu); N not a multiple of
    16 and groups of 64, at prefill rows and at decode rows, stay on
    q4_matmul.cu's kernel."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    cases = [(m, c, n, None, "decode") for m in (1, 8, 16) for c, n in ((4096, 4096), (11008, 4096), (4096, 11008))]
    cases += [(8, 4096, 32000, None, "decode"), (77, 4096, 1000, 128, "mma"), (512, 2048, 2048, 64, "mma"),
              (77, 4096, 4096, 64, "mma"), (8, 4096, 1000, 128, "mma"), (8, 2048, 2048, 64, "mma"),
              (1, 4096, 4104, 128, "mma")]
    for m, c, n, block, design in cases:
        assert q4_design(m, n, c, block or 128) == design
        out, ref, launched = _run(gen, m, c, n, _weight(gen, c, n, block))
        err = _row_rel(out, ref)
        print(f"M={m} C={c} N={n} block {block or 128}: {design} design, row error {err:.4g}")
        want = tuple(int(d == design) for d in ("decode", "wgmma", "mma"))
        assert launched == want and err <= ROW_REL, (m, c, n, block, launched, err)


def test_planted_faults_fail(cuda):
    """The limit rejects the output without its last scale group and the
    output with its last 64-row tile zeroed at a ragged M (200: rows
    192..199), both built from the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    c, n, m = 4096, 4096, 200
    packed, scale, block = _weight(gen, c, n)
    x = torch.randn((m, c), generator=gen, device=cuda).to(torch.bfloat16)
    ref = q4_matmul_plain(x, packed, scale, block)
    short = q4_matmul_plain(x[:, : c - block].contiguous(), packed[: (c - block) // 2], scale[:-1], block)
    tile = ref.clone()
    tile[64 * ((m - 1) // 64):] = 0
    errs = (_row_rel(short, ref), _row_rel(tile, ref))
    print(f"planted faults: row errors {errs[0]:.4g} (last group dropped), {errs[1]:.4g} (last row tile zeroed)")
    assert min(errs) > ROW_REL
    assert _row_rel(q4_matmul(x, packed, scale, block), ref) <= ROW_REL


def test_entry_point_refuses_other_shapes(cuda):
    """The prefill design's C entry point returns -1 for a shape q4_design
    gives to the other kernel (N = 1000, groups of 64, C not a multiple
    of 128), and launches nothing."""
    x = torch.zeros((64, 4096), dtype=torch.bfloat16, device=cuda)
    packed = torch.zeros((2048, 1024), dtype=torch.uint8, device=cuda)
    scale = torch.ones((64, 1024), device=cuda)
    out = torch.empty((64, 1024), dtype=torch.bfloat16, device=cuda)
    lib, stream = kernels.library(), kernels.stream_ptr(cuda)
    args = (x.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr())
    assert lib.q4_matmul_wgmma(*args, 64, 1000, 4096, 128, stream) == -1
    assert lib.q4_matmul_wgmma(*args, 64, 1024, 4096, 64, stream) == -1
    assert lib.q4_matmul_wgmma(*args, 64, 1024, 4000, 128, stream) == -1
    assert lib.q4_matmul_wgmma(*args, 64, 1024, 4096, 128, stream) == 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("ggml_type", [0, 1, 2, 3, 6, 8])
def test_gguf_dequantization_on_the_card_matches_cpu(cuda, ggml_type):
    """Random blocks of every supported GGML type (scales valid f16 values,
    codes random bytes) at a w_gate's size dequantize on the card to the
    CPU's values, bit for bit."""
    from substratus_tpu_torch.load.gguf import _BLOCK, _dequantize

    n = 4096 * 11008
    qk, bsz = _BLOCK[ggml_type]
    gen = torch.Generator().manual_seed(ggml_type)
    raw = torch.randint(0, 256, (n // qk, bsz), dtype=torch.uint8, generator=gen)
    if ggml_type == 0:
        raw = torch.randn(n, generator=gen).view(torch.uint8).view(n // qk, bsz)
    elif ggml_type == 1:
        raw = torch.randn(n, generator=gen).half().view(torch.uint8).view(n // qk, bsz)
    else:  # the f16 scale (and Q4_1's f16 min) first in each block
        heads = 4 if ggml_type == 3 else 2
        raw[:, :heads] = (torch.randn(n // qk, heads // 2, generator=gen) * 0.01).half().view(torch.uint8)
    raw = raw.reshape(-1)
    want = _dequantize(raw.clone(), ggml_type, n)
    got = _dequantize(raw.to(cuda), ggml_type, n)
    assert got.device.type == "cuda" and got.dtype == want.dtype == torch.float32
    assert torch.equal(got.cpu(), want)


def test_checkpoints_load_on_the_card_as_on_the_cpu(cuda, tmp_path):
    """A bf16 model written as safetensors shards and as a Q4_0 GGUF loads
    into a model on the card with the state it loads into on the CPU."""
    from substratus_tpu_torch.load.gguf import load_gguf
    from substratus_tpu_torch.load.hf import load_pretrained, read_safetensors
    from substratus_tpu_torch.models import llama
    from substratus_tpu_torch.tools.ckpt_writer import write_gguf, write_hf

    cfg = llama.CONFIGS["tiny"].replace(dim=256, hidden_dim=512, vocab_size=512)
    model = llama.init_params(cfg, seed=0, device="cpu")
    write_hf(str(tmp_path / "hf"), model, shard_bytes=1 << 20)
    write_gguf(str(tmp_path / "m.gguf"), model)
    for path in sorted((tmp_path / "hf").glob("*.safetensors")):
        for name, t in read_safetensors(str(path)).items():
            assert torch.equal(t.to(cuda).cpu(), t), name
    for load, path in ((load_pretrained, tmp_path / "hf"), (load_gguf, tmp_path / "m.gguf")):
        _, on_card = load(str(path), device=cuda)
        _, on_cpu = load(str(path), device="cpu")
        assert on_card.device.type == "cuda"
        for name, t in on_cpu.state_dict().items():
            assert torch.equal(on_card.state_dict()[name].cpu(), t), name
