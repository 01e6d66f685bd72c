"""The split design of the decode kernels (csrc/decode_split.cu) on the CPU:
its plan, its routing, and a plain PyTorch model of its algorithm held
against the JAX package's decode functions.

The plan (ops/fused_decode.py::decode_split_plan) is checked over the
shapes the engines use: whole tiles, at least one split, every cache row
in exactly one split. The model follows the kernel step by step: each
split of `rows` cache rows, clipped to the slot's limit, is walked by
eight warps over 32-row tiles in turn (one max and one rescale of acc a
tile), the warps' states merge, and the live splits combine (with the
current token's term for the fused kernel). It is held in float32
against decode_attention(impl="pallas", interpret=True) and impl="xla",
and against fused_decode_attention(interpret=True), atol 1e-5: the split
changes only the order of the sums. Splits of 64 rows cut the cache at
and around the positions (decode also in one split, its six tiles over
six warps); pos < 0 (the Pallas kernel outputs 0; the XLA
path, which never sees such a row from the engine, averages every row, so
it is compared on the other rows), pos >= S, drifted fused positions,
int8 caches and groups of 1, 4 and 8. The CUDA kernels themselves are
held against the plain versions in tests/test_torch_decode_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substratus_tpu.ops import decode_attention as jdec
from substratus_tpu.ops.fused_decode import fused_decode_attention as j_fused
from substratus_tpu.ops.quant import quantize_kv as j_quantize_kv
from substratus_tpu_torch.ops import decode_attention as tdec
from substratus_tpu_torch.ops.fused_decode import (
    SPLIT_MAX_ROWS, SPLIT_MIN_ROWS, SPLIT_ROUND, decode_design, decode_split_plan)

NEG_INF = -1e30
TILE, WARPS = 32, 8  # csrc/decode_split.cu: T, NW
B, S, D, ROWS = 8, 192, 16, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _merge(states, cur=None):
    """o [G, D] from states (m [G], l [G], acc [G, D]), and the current
    token (score [G], value [D]) where given; 0 where l = 0."""
    m = torch.stack([s[0] for s in states] + ([cur[0]] if cur else []))  # [n, G]
    mx = m.max(dim=0).values
    c = torch.exp(m - mx)
    lsum = sum(ci * s[1] for ci, s in zip(c, states)) + (c[-1] if cur else 0)
    acc = sum(ci[:, None] * s[2] for ci, s in zip(c, states)) + (c[-1][:, None] * cur[1] if cur else 0)
    return torch.where(lsum[:, None] == 0, 0.0, acc / torch.where(lsum == 0, 1.0, lsum)[:, None])


def _split_state(qf, k, v, ks, vs, r0, r1):
    """(m, l, acc) of cache rows [r0, r1) of one kv head as the kernel's
    block computes it: warp w walks tiles w, w + 8, ..., each tile one max
    and one rescale; the eight warps' states then merge."""
    g, d = qf.shape
    tiles = list(range(r0, r1, TILE))
    states = []
    for w in range(WARPS):
        m, l, acc = torch.full((g,), NEG_INF), torch.zeros(g), torch.zeros(g, d)
        for t0 in tiles[w::WARPS]:
            rows = slice(t0, min(t0 + TILE, r1))
            s = qf @ k[rows].T  # [G, n]
            if ks is not None:
                s = s * ks[rows]
            m_new = torch.maximum(m, s.max(dim=-1).values)
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[:, None])
            l = l * alpha + p.sum(dim=-1)
            if vs is not None:
                p = p * vs[rows]
            acc = acc * alpha[:, None] + p @ v[rows]
            m = m_new
        states.append((m, l, acc))
    mx = torch.stack([s[0] for s in states]).max(dim=0).values
    c = [torch.exp(s[0] - mx) for s in states]
    return mx, sum(ci * s[1] for ci, s in zip(c, states)), sum(ci[:, None] * s[2] for ci, s in zip(c, states))


def split_model(q, k, v, pos, ks=None, vs=None, rows=ROWS, new=None):
    """The split design's output [B, 1, H, D] (and, fused, its caches):
    decode (new None) over rows 0..pos; fused (new = (nk, nv, nks, nvs))
    over the history 0..pos-1 with pos clamped to [0, S-1], the fresh row
    written at pos and the current token combined in."""
    b, _, h, d = q.shape
    kh, s = k.shape[1], k.shape[2]
    g = h // kh
    out = torch.zeros(b, kh, g, d)
    if new is not None:
        k, v = k.clone(), v.clone()
    for bi in range(b):
        p = int(pos[bi])
        limit = min(max(p, 0), s - 1) if new is not None else (0 if p < 0 else min(p + 1, s))
        for hi in range(kh):
            qf = q[bi, 0, hi * g:(hi + 1) * g].float() * d**-0.5
            if new is not None:
                k[bi, hi, limit], v[bi, hi, limit] = new[0][bi, hi, 0], new[1][bi, hi, 0]
            sc = [x[bi, hi] if x is not None else None for x in (ks, vs)]
            states = [_split_state(qf, k[bi, hi].float(), v[bi, hi].float(), *sc, r0, min(r0 + rows, limit))
                      for r0 in range(0, limit, rows)]  # the live splits
            cur = None
            if new is not None:
                score = qf @ new[0][bi, hi, 0].float()
                value = new[1][bi, hi, 0].float()
                if new[2] is not None:
                    score, value = score * new[2][bi, hi, 0], value * new[3][bi, hi, 0]
                cur = (score, value)
            out[bi, hi] = _merge(states, cur) if states or cur else 0.0
    out = out.reshape(b, 1, h, d)
    return out if new is None else (out, k, v)


def _q8(x):
    kq, ks = (np.array(a) for a in j_quantize_kv(jnp.asarray(x)))
    return kq, ks[..., 0]


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def test_split_plan_over_engine_shapes():
    """(S, B * KH) of serve (llama2-7b, max_seq_len 1024), serve-long (4096),
    serve-int4 (2048), one long conversation (B = 1), llama3-8b's and
    tinyllama's heads, and the card tests' small engine, on 132 SMs (an
    H100) and on other counts: whole rounds of tiles, every row in one
    split, and the split design at the head_dims it takes."""
    shapes = [(1024, 8 * 32), (4096, 8 * 32), (2048, 8 * 32), (4096, 32), (4096, 8 * 8), (1024, 8 * 8),
              (2048, 8 * 4), (512, 4 * 2), (128, 16), (100, 3)]
    for sms in (132, 114, 16, 1):
        for s, heads in shapes:
            n_split, rows = decode_split_plan(s, heads, sms)
            assert rows % SPLIT_ROUND == 0 and rows % (TILE * WARPS) == 0
            assert SPLIT_MIN_ROWS <= rows <= SPLIT_MAX_ROWS
            assert n_split >= 1 and (n_split - 1) * rows < s <= n_split * rows, (s, heads, sms)
    # On an H100 (132 SMs): serve's llama2-7b cache in one split (256 heads
    # fill the card: no combine); a long cache in splits of at most 1024
    # rows; one long conversation (B = 1) over 256 blocks, not 32.
    assert decode_split_plan(1024, 8 * 32, 132) == (1, 1024)
    assert decode_split_plan(4096, 8 * 32, 132) == (4, 1024)
    assert decode_split_plan(4096, 32, 132) == (8, 512)
    assert decode_split_plan(4096, 8 * 8, 132) == (4, 1024)  # llama3-8b's heads, B = 8
    assert decode_split_plan(1024, 8 * 4, 132) == (4, 256)  # tinyllama's heads, B = 8


def test_design_routes_by_shape():
    for d in (64, 128):
        assert decode_design(d, 1024, False) == decode_design(d, 1024, True) == "split"
    assert decode_design(16, 1024, False) == decode_design(32, 1024, True) == "rows"
    assert decode_design(128, 1022, True) == "rows" and decode_design(128, 1022, False) == "split"


def _decode_operands(g, quantized, seed):
    kh = 8 // g if g < 8 else 1
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, 1, kh * g, D)).astype(np.float32)
    k, v = (r.standard_normal((B, kh, S, D)).astype(np.float32) for _ in range(2))
    ks = vs = None
    if quantized:
        (k, ks), (v, vs) = _q8(k), _q8(v)
    return q, k, v, ks, vs


# Cuts at and around the 64-row splits, before the cache and past it.
POSITIONS = [-1, 0, ROWS - 1, ROWS, ROWS + 1, 2 * ROWS + 7, S - 1, S + 50]


@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_split_model_matches_jax_decode(g, quantized):
    q, k, v, ks, vs = _decode_operands(g, quantized, seed=g + 10 * quantized)
    pos = np.array(POSITIONS, np.int32)
    pallas = jdec.decode_attention(*map(_j, (q, k, v, pos, ks, vs)), impl="pallas", block_s=32, interpret=True)
    xla = jdec.decode_attention(*map(_j, (q, k, v, pos, ks, vs)), impl="xla")
    plain = tdec.decode_attention_plain(*map(_t, (q, k, v, pos, ks, vs)))  # the port's: the same function
    live = pos >= 0
    for rows in (ROWS, S):
        got = split_model(*map(_t, (q, k, v, pos, ks, vs)), rows=rows)
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=1e-5)
        np.testing.assert_allclose(got.numpy()[live], np.asarray(xla)[live], atol=1e-5)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5)
        assert not got[0].any()  # pos < 0: exactly 0


@pytest.mark.parametrize("g,quantized,drifted", [(1, False, False), (2, False, True), (4, True, True),
                                                 (8, True, False)])
def test_split_model_matches_jax_fused(g, quantized, drifted):
    """The fused kernel's model: the fresh row at the clamped position (the
    caches bit for bit), the history strictly below it, the current token
    from the operands; pos = 0 attends to the current token alone."""
    q, k, v, ks, vs = _decode_operands(g, quantized, seed=20 + g)
    kh = k.shape[1]
    r = np.random.default_rng(30 + g)
    nk, nv = (r.standard_normal((B, kh, 1, D)).astype(np.float32) for _ in range(2))
    nks = nvs = None
    positions = [0, 1, ROWS - 1, ROWS, ROWS + 1, 2 * ROWS + 7, S - 1, (S + 40 if drifted else S - 2)]
    pos = np.array(positions, np.int32)
    clamped = np.minimum(pos, S - 1)
    if quantized:
        (nk, nks), (nv, nvs) = _q8(nk), _q8(nv)
        for b in range(B):  # the caller's scale writes
            ks[b, :, clamped[b]], vs[b, :, clamped[b]] = nks[b, :, 0], nvs[b, :, 0]
    got, gk, gv = split_model(*map(_t, (q, k, v, pos, ks, vs)), new=tuple(map(_t, (nk, nv, nks, nvs))))
    args = (q, nk, nv, k, v, pos) + ((nks, nvs, ks, vs) if quantized else ())
    want, jk, jv = j_fused(*map(_j, args), block_s=32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(jv))
