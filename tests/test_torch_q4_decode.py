"""The int4 matmul's decode design (csrc/q4_matmul_decode.cu) on the CPU: its
plan, the three-way routing, a plain PyTorch model of its algorithm held
against the JAX package's kernel, and the wrapper's once-per-weight checks.

* q4_decode_plan over llama2-7b's and llama3-8b's decode shapes (M = 1, 8,
  16), on 132 SMs and with an H100's cluster capacity: one wave (no more
  blocks than SMs, no more clusters than the card runs at once, so no
  tail), at most 8 splits, every split at least one scale group and the
  splits within one group of each other, every column in exactly one
  tile, the shared memory within the card's.
* q4_design: decode (M <= 16), wgmma (M > 16), mma (groups of 32 or 64, N
  a multiple of 8 but not of 16).
* The model follows the kernel: each tile of bn columns, each split of the
  plan's groups accumulating (int4 * scale in f32, rounded to bf16)
  products in f32, the splits' partials summed in rank order, the output
  rounded once to bf16. It is held against
  substratus_tpu/ops/quant4.py::_matmul in interpret mode per output row:
  within ROW_REL = 2^-6 of the row's norm (or of 2^-8 of the RMS row norm
  where that is larger). Both multiply the same bf16 weights and differ
  in the f32 summation order and the output's bf16 rounding (2^-8
  relative); a dropped group moves a row by about 1/G of its norm and
  more, so the limit also rejects the model without its last split.
The CUDA kernel itself is held against the plain version in
tests/test_torch_q4_decode_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substratus_tpu.ops import quant4 as jq4
from substratus_tpu_torch.ops import quant4

ROW_REL = 2**-6
SMS = 132  # an H100's SMs
LLAMA2_7B = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)]  # (C, N)
LLAMA3_8B = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _row_rel(got, ref) -> float:
    g, r = got.float(), ref.float()
    norms = r.norm(dim=-1)
    den = torch.maximum(norms, norms.square().mean().sqrt() * 2**-8).clamp_min(torch.finfo(torch.float32).tiny)
    return ((g - r).norm(dim=-1) / den).max().item()


# Clusters of 1..8 blocks an NVIDIA H100 80GB HBM3 runs at once
# (quant4.cluster_capacity; one block an SM).
H100_HELD = (132, 66, 39, 30, 22, 17, 15, 15)


@pytest.mark.parametrize("held", [None, H100_HELD], ids=["sms", "h100"])
def test_plan_one_wave_without_tail(held):
    for c, n in LLAMA2_7B + LLAMA3_8B:
        groups, chunks = c // 128, -(-n // 128)
        for m in (1, 8, 16):
            bn, splits = quant4.q4_decode_plan(m, n, c, SMS, held)
            cpb = bn // 128
            tiles = -(-chunks // cpb)
            assert bn % 128 == 0 and 1 <= splits <= 8 and splits <= groups, (m, c, n, bn, splits)
            assert tiles * splits <= SMS, (m, c, n, bn, splits)  # one block an SM: one wave
            assert (tiles - 1) * cpb < chunks <= tiles * cpb  # every column in one tile, no empty tile
            sizes = [(r + 1) * groups // splits - r * groups // splits for r in range(splits)]
            assert sum(sizes) == groups and min(sizes) >= 1 and max(sizes) - min(sizes) <= 1, sizes
            assert quant4.q4_decode_smem(m, cpb, max(sizes), splits) <= quant4.DECODE_SMEM
            if held is not None:  # the card runs every cluster of the plan at once
                assert tiles <= held[splits - 1]
    # C = 11008 is 86 groups: four unequal splits of 21 and 22.
    assert quant4.q4_decode_plan(8, 4096, 11008, SMS) == (128, 4)
    # A card of few SMs takes more waves rather than fail.
    assert quant4.q4_decode_plan(8, 32000, 4096, 4)[1] >= 1


def test_q4_design_routes_three_ways():
    for c, n in LLAMA2_7B + LLAMA3_8B:
        for m in range(1, 17):
            assert quant4.q4_design(m, n, c, 128) == "decode", (m, c, n)
        for m in (17, 32, 77, 512):
            assert quant4.q4_design(m, n, c, 128) == "wgmma", (m, c, n)
    for m in (1, 8, 16, 77, 512):
        assert quant4.q4_design(m, 1000, 4096, 128) == "mma"  # N not a multiple of 16
        assert quant4.q4_design(m, 4104, 4096, 128) == "mma"  # a multiple of 8, not of 16
        assert quant4.q4_design(m, 2048, 2048, 64) == "mma"  # tinyllama's wo: groups of 64
        assert quant4.q4_design(m, 2048, 2048, 32) == "mma"
    # x's tiles ride in the ring at one chunk a block: any C fits.
    assert quant4.q4_design(16, 4096, 65536, 128) == "decode"
    bn, splits = quant4.q4_decode_plan(16, 4096, 65536, SMS)
    assert quant4.q4_decode_smem(16, bn // 128, -(-512 // splits), splits) <= quant4.DECODE_SMEM


def _q4(c, n, seed):
    w = (np.random.default_rng(seed).standard_normal((c, n)) * c**-0.5).astype(np.float32)
    return jq4.quantize4(jnp.asarray(w), (0,)), quant4.quantize4(torch.from_numpy(w), (0,))


def _decode_model(x, packed, scale, sms, skip_split=None):
    """The decode kernel's algorithm in plain PyTorch at q4_decode_plan's
    plan: per tile and split, f32 partials of the bf16 weights' products,
    summed in rank order, rounded once to bf16."""
    m, c = x.shape
    n = packed.shape[1]
    bn, splits = quant4.q4_decode_plan(m, n, c, sms)
    groups = c // 128
    lo, hi = quant4._nibbles(packed)
    w = torch.cat([lo.reshape(groups, 64, n), hi.reshape(groups, 64, n)], dim=1)
    w = (w.float() * scale.reshape(groups, 1, n)).to(torch.bfloat16).float().reshape(c, n)
    out = torch.empty((m, n), dtype=torch.float32)
    for n0 in range(0, n, bn):
        cols = slice(n0, min(n, n0 + bn))
        total = None
        for rank in range(splits):
            acc = torch.zeros((m, cols.stop - n0))
            for g in range(rank * groups // splits, (rank + 1) * groups // splits):
                k = slice(128 * g, 128 * (g + 1))
                acc += x[:, k].float() @ w[k, cols]
            if rank != skip_split:
                total = acc if total is None else total + acc
        out[:, cols] = total
    return out.to(torch.bfloat16), (bn, splits)


@pytest.mark.parametrize("m,c,n,sms", [(1, 512, 384, 6), (8, 640, 384, 12), (16, 1024, 256, 8), (5, 512, 272, 2)])
def test_split_model_matches_jax(m, c, n, sms):
    """Plans at small widths on cards of a few SMs: two and four splits
    (four unequal ones of 5 groups), and two chunks a block with a ragged
    last chunk at N = 272. The model within ROW_REL of the Pallas kernel in
    interpret mode, the same bits twice; without its last split it is
    rejected."""
    jq, tq = _q4(c, n, c + n)
    x = (np.random.default_rng(m).standard_normal((m, c))).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    want = torch.from_numpy(np.array(jq4._matmul(jx, jq.packed, jq.scale, jq.block, interpret=True)
                                       .astype(jnp.float32)))
    tx = torch.from_numpy(x).to(torch.bfloat16)
    got, (bn, splits) = _decode_model(tx, tq.packed, tq.scale, sms)
    assert splits > 1 or bn < n  # the small card splits the groups or the columns
    err = _row_rel(got, want)
    assert err <= ROW_REL, err
    np.testing.assert_array_equal(got.float().numpy(),
                                  _decode_model(tx, tq.packed, tq.scale, sms)[0].float().numpy())
    if splits > 1:
        assert _row_rel(_decode_model(tx, tq.packed, tq.scale, sms, skip_split=splits - 1)[0], want) > ROW_REL


def test_weight_checked_once_per_buffers():
    """q4einsum's weight views are checked once and reused while the
    buffers are the same tensors; new buffers are checked again; a bad
    operand raises. On the CPU the wrapper runs the plain version."""
    _, tq = _q4(256, 128, 1)
    calls = quant4.check_weight.calls
    p2, s2 = quant4.q4_operands(tq, 1)
    assert quant4.check_weight.calls == calls + 1
    for _ in range(3):
        again = quant4.q4_operands(tq, 1)
        assert again[0] is p2 and again[1] is s2
    assert quant4.check_weight.calls == calls + 1
    assert p2.shape == (128, 128) and s2.shape == (2, 128)
    tq.to("cpu")  # Q4Tensor._apply drops the views, whatever .to() does to the buffers
    assert tq._operands is None
    quant4.q4_operands(tq, 1)
    assert quant4.check_weight.calls == calls + 2
    tq.packed = tq.packed.clone()  # a new buffer
    quant4.q4_operands(tq, 1)
    assert quant4.check_weight.calls == calls + 3
    bad = quant4.Q4Tensor(tq.packed, tq.scale.double(), tq.pack_axis, tq.block)
    with pytest.raises(ValueError, match="f32"):
        quant4.q4_operands(bad, 1)
    with pytest.raises(ValueError, match="device"):
        quant4._launch(torch.zeros((2, 256), dtype=torch.bfloat16), p2, s2, 128)
    x = torch.randn((3, 256)).to(torch.bfloat16)
    launches = quant4.q4_matmul.launches
    assert torch.equal(quant4.q4einsum("bd,dn->bn", x, tq),
                       quant4.q4_matmul_plain(x, tq.packed, tq.scale, tq.block))
    assert quant4.q4_matmul.launches == launches
