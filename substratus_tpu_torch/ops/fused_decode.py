"""Fused cache write + decode attention over the dense slot cache: the CUDA
kernels beside their plain PyTorch version (port of
substratus_tpu/ops/fused_decode.py), and the split plan that the decode
kernels of this module and ops/decode_attention.py share.

The kernels replace substratus_tpu/ops/fused_decode.py::_kernel
(fused_decode_attention). One launch per layer per decode step writes the
fresh k/v row into cache row ``pos`` and attends: the history is masked
strictly below ``pos`` and the current token's term comes from the
operands, so the fresh row is never read back. They are bound by the bytes
of the history rows. Two designs compute it, chosen by shape alone
(``decode_design``): csrc/decode_split.cu (S split over blocks, a ring of
cache tiles, one softmax rescale a tile, any query group in slices of at
most 8 rows; head_dim 64 and 128) and csrc/fused_decode.cu (one block per
slot and kv head; head_dim 16, 32 and 256, groups of 1, 2, 4 and 8). A
shape the rows design does not take (at 256: another group) goes to the
split design, built at 64, 128 and 256, on a cache that
``cache_layout`` lays out for it; a head dim not built runs padded to the
next built one (ops/headdim.py). See the source notes.

The fresh row arrives in the cache dtype; for int8 its scales
``new_ks``/``new_vs`` [B, KH, 1] weight the current token's term, and the
caller has already scattered them into the cache scales (the tiny scale
writes stay outside the kernel, as in the JAX package). Positions clamp
to [0, S-1], so a drifted idle slot writes row S-1 and nothing else.

Unlike the JAX package, which aliases the donated cache, the port writes
the caches in place and returns the very tensors it was given.
``fused_decode_attention.launches`` counts kernel launches, its
``launches_split`` and ``launches_rows`` those of each design.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from substratus_tpu_torch import kernels
from substratus_tpu_torch.ops.attention import NEG_INF
from substratus_tpu_torch.ops.headdim import HEAD_DIMS, MAX_HEAD_DIM, pad_head, padded_head_dim

GROUPS = (1, 2, 4, 8)  # the rows design's groups; the split design takes any
SPLIT_HEAD_DIMS = (64, 128)  # where csrc/decode_split.cu is the design of every group
# csrc/decode_split.cu's instances: also 256 (on 4 warps), for the groups
# the rows design does not take there
SPLIT_BUILT = SPLIT_HEAD_DIMS + (256,)
# The split plan: rows a split in whole rounds of the kernel's 8 warps x
# 32-row tiles, from SPLIT_MIN_ROWS to SPLIT_MAX_ROWS, as many as make
# about SPLIT_BLOCKS_PER_SM blocks an SM when every slot is at its last
# row (tools/decode_probe.py measured the plans; PERF.md).
SPLIT_ROUND = 256
SPLIT_MIN_ROWS = 256
SPLIT_MAX_ROWS = 1024
SPLIT_BLOCKS_PER_SM = 2


def decode_split_plan(s: int, heads: int, sms: int) -> Tuple[int, int]:
    """(n_split, rows) of csrc/decode_split.cu for an S-row cache of
    `heads` = B * KH kv heads on a card of `sms` SMs: split i reads rows
    [i * rows, (i + 1) * rows). By shapes alone, never the positions, so
    a step reads nothing back from the card. One split (no combine) once
    the heads alone fill the card at a short cache; at most
    SPLIT_MAX_ROWS rows a block, so one long conversation among short
    ones still spreads over the card."""
    rows = -(-s * heads // (SPLIT_BLOCKS_PER_SM * sms))
    rows = min(SPLIT_MAX_ROWS, max(SPLIT_MIN_ROWS, -(-rows // SPLIT_ROUND) * SPLIT_ROUND))
    return -(-s // rows), rows


def group_slices(group: int) -> Tuple[int, int]:
    """(query rows a block, blocks a kv head) of csrc/decode_split.cu for
    a query group of `group` rows: a group of 1, 2, 4 or 8 rows in one
    block, 3 and 5-7 in one block of 4 or 8 rows (the rest masked), a wider
    one in slices of 8 (falcon-7b's 71: 9 blocks, the last of 7 live rows).
    The C side's block_rows computes the same."""
    rows = 8 if group >= 8 else 1 << (group - 1).bit_length()
    return rows, -(-group // rows)


def decode_design(d: int, s: int, quantized: bool, group: int = 1) -> str:
    """The CUDA design of the decode kernels (decode_attention and
    fused_decode_attention) for a cache of S rows at head_dim d and a
    query group of `group`: "split" (csrc/decode_split.cu) at head_dim 64
    and 128 (an int8 cache also needs S a multiple of 4, its scale rows
    copied 16 bytes at a time); "rows" (csrc/decode_attn.cu,
    csrc/fused_decode.cu) otherwise (head_dim 16, 32 and 256), where it
    takes the group (1, 2, 4 or 8); "split" again for any other group, on
    a cache that cache_layout lays out for it (D at least 64, S a multiple
    of 4 when int8; at 256 the split design's instance of 4 warps). By shape
    alone: a launch that fails raises, it is not retried on the other
    design."""
    if d in SPLIT_HEAD_DIMS and (not quantized or s % 4 == 0):
        return "split"
    return "rows" if d in HEAD_DIMS and group in GROUPS else "split"


def cache_layout(d: int, s: int, quantized: bool, group: int) -> Tuple[int, int]:
    """(rows, head dim) of the dense slot cache that the decode kernels and
    the cached flash read for a model of head_dim d, a window of s rows and
    a query group of `group`: D padded up to the next built head dim
    (ops/headdim.py), and where the design decode_design then names is the
    split design, D at least 64 and, for an int8 cache, the rows rounded up
    to a multiple of 4. Positions past s are never attended (the engine
    keeps a request inside its window), so extra rows and zero columns
    change no output, and no step copies the cache. A head dim above
    MAX_HEAD_DIM raises."""
    dp = padded_head_dim(d)
    if dp is None:
        raise ValueError(f"cache_layout: head_dim {d} above {MAX_HEAD_DIM}, the largest the kernels take")
    if decode_design(dp, s, quantized, group) == "rows":
        return s, dp
    return (-(-s // 4) * 4 if quantized else s), max(dp, SPLIT_HEAD_DIMS[0])


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def split_workspace(q: torch.Tensor, b: int, kh: int, s: int):
    """(rows, n_split, workspace) of the split design for q [B, 1, H, D]:
    the f32 partials [B * KH, n_split, G, D + 2] when n_split > 1. The plan
    counts a block per slice of the group (group_slices), so a wide group
    on few kv heads (falcon-7b: KH = 1) is not split as if it were one
    block a slot."""
    h, d = q.shape[2], q.shape[3]
    n_split, rows = decode_split_plan(s, b * kh * group_slices(h // kh)[1], sm_count(q.device.index))
    ws = (torch.empty(b * kh * n_split * (h // kh) * (d + 2), dtype=torch.float32, device=q.device)
          if n_split > 1 else None)
    return rows, n_split, ws


def fused_decode_attention_plain(
    q: torch.Tensor,  # [B, 1, H, D]
    new_k: torch.Tensor,  # [B, KH, 1, D] fresh row, cache dtype
    new_v: torch.Tensor,
    cache_k: torch.Tensor,  # [B, KH, S, D], written in place
    cache_v: torch.Tensor,
    positions: torch.Tensor,  # [B] slot of the fresh token
    new_ks: Optional[torch.Tensor] = None,  # [B, KH, 1] f32
    new_vs: Optional[torch.Tensor] = None,
    cache_ks: Optional[torch.Tensor] = None,  # [B, KH, S] f32 (fresh scale already scattered)
    cache_vs: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, following the Pallas
    _kernel: write the row, then q scaled by `scale` (D^-0.5 when None) in
    f32 against the history cols < pos (times cache_ks) and the current
    token from the operands (times new_ks); f32 softmax over both; p times
    the v scales kept f32 for the PV product."""
    b, _, h, d = q.shape
    kh, s = cache_k.shape[1], cache_k.shape[2]
    pos = torch.clamp(positions.long(), 0, s - 1)
    bidx = torch.arange(b, device=q.device)[:, None]
    hidx = torch.arange(kh, device=q.device)[None, :]
    cache_k[bidx, hidx, pos[:, None]] = new_k[:, :, 0]
    cache_v[bidx, hidx, pos[:, None]] = new_v[:, :, 0]

    qf = (q.float() * (d**-0.5 if scale is None else scale)).reshape(b, kh, h // kh, d)
    hist = torch.einsum("bkgd,bksd->bkgs", qf, cache_k.float())  # [B, KH, G, S]
    cur = torch.einsum("bkgd,bkd->bkg", qf, new_k[:, :, 0].float())[..., None]  # [B, KH, G, 1]
    if new_ks is not None:
        hist = hist * cache_ks[:, :, None, :]
        cur = cur * new_ks[:, :, None, :]
    live = (torch.arange(s, device=q.device)[None, :] < pos[:, None])[:, None, None, :]
    logits = torch.cat([torch.where(live, hist, NEG_INF), cur], dim=-1)
    p = torch.softmax(logits, dim=-1)
    p_hist = torch.where(live, p[..., :s], 0.0)
    p_cur = p[..., s:]
    if new_vs is not None:
        p_hist = p_hist * cache_vs[:, :, None, :]
        p_cur = p_cur * new_vs[:, :, None, :]
    out = torch.einsum("bkgs,bksd->bkgd", p_hist, cache_v.float())
    out = out + p_cur * new_v.float()  # [B, KH, G, 1] * [B, KH, 1, D]
    return out.reshape(b, 1, h, d).to(q.dtype), cache_k, cache_v


def fused_decode_attention(
    q: torch.Tensor,  # [B, 1, H, D]
    new_k: torch.Tensor,  # [B, KH, 1, D] fresh row, cache dtype
    new_v: torch.Tensor,
    cache_k: torch.Tensor,  # [B, KH, S, D] WITHOUT the fresh row; written in place
    cache_v: torch.Tensor,
    positions: torch.Tensor,  # [B] slot of the fresh token
    new_ks: Optional[torch.Tensor] = None,  # [B, KH, 1] f32
    new_vs: Optional[torch.Tensor] = None,
    cache_ks: Optional[torch.Tensor] = None,  # [B, KH, S] f32
    cache_vs: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Write the fresh kv row into its cache slot AND attend, one kernel.
    Returns (attn [B, 1, H, D] in q's dtype, cache_k, cache_v), the caches
    being the tensors given, written in place. A cache laid out at a
    padded head dim (cache_layout) takes the fresh rows at its D and q at
    the model's: q runs padded at its own D^-0.5 and the output is sliced
    back. CUDA tensors launch the kernel (or raise); CPU tensors run the
    plain version."""
    d = q.shape[-1]
    args = (new_k, new_v, cache_k, cache_v, positions, new_ks, new_vs, cache_ks, cache_vs, d**-0.5)
    if cache_k.shape[-1] > d:
        out, _, _ = _fused_decode(pad_head(q, cache_k.shape[-1]), *args)
        if q.device.type == "cuda":
            fused_decode_attention.launches_padded += 1
        return out[..., :d], cache_k, cache_v
    return _fused_decode(q, *args)


def check_decode_layout(name: str, d: int, s: int, quantized: bool, group: int) -> str:
    """The design decode_design names for a cache of s rows at head_dim d
    and a query group of `group`; raises when the cache is not laid out for
    it (cache_layout's padding left out)."""
    design = decode_design(d, s, quantized, group)
    if design == "split" and not (d in SPLIT_BUILT and (not quantized or s % 4 == 0)):
        raise ValueError(
            f"{name}: a {'int8' if quantized else 'bf16'} cache of {s} rows at head_dim {d} for a group of {group} "
            f"is laid out for no built design: allocate it with ops/fused_decode.py::cache_layout (the rows "
            f"design, csrc/decode_attn.cu and csrc/fused_decode.cu, takes groups {GROUPS} at head_dim {HEAD_DIMS}; "
            f"the split design, csrc/decode_split.cu, any group at head_dim {SPLIT_BUILT}, S a multiple of 4 "
            "when int8)")
    return design


def _fused_decode(q, new_k, new_v, cache_k, cache_v, positions, new_ks, new_vs, cache_ks, cache_vs, scale: float):
    """The fused kernel's launch at the cache's head dim (or, for CPU
    tensors, its plain version)."""
    args = (q, new_k, new_v, cache_k, cache_v, positions, new_ks, new_vs, cache_ks, cache_vs, scale)
    if q.device.type == "cpu":
        return fused_decode_attention_plain(*args)
    if q.device.type != "cuda":
        raise ValueError(f"fused_decode_attention: unsupported device {q.device}")
    b, sq, h, d = q.shape
    _, kh, s, dk = cache_k.shape
    quantized = new_ks is not None
    if (sq != 1 or dk != d or cache_v.shape != cache_k.shape or cache_k.shape[0] != b or h % kh
            or new_k.shape != (b, kh, 1, d) or new_v.shape != new_k.shape or positions.shape != (b,)):
        raise ValueError(
            f"fused_decode_attention: unsupported shapes q{tuple(q.shape)} new_k{tuple(new_k.shape)} "
            f"cache{tuple(cache_k.shape)} positions{tuple(positions.shape)}")
    design = check_decode_layout("fused_decode_attention", d, s, quantized, h // kh)
    if q.dtype != torch.bfloat16:
        raise ValueError(f"fused_decode_attention: the kernel takes bf16 queries, got {q.dtype}")
    want = torch.int8 if quantized else torch.bfloat16
    if any(t.dtype != want for t in (new_k, new_v, cache_k, cache_v)):
        raise ValueError(f"fused_decode_attention: the fresh row and the cache must be {want}")
    scales = (new_ks, new_vs, cache_ks, cache_vs) if quantized else ()
    if quantized and (
        any(t is None or t.dtype != torch.float32 for t in scales)
        or new_ks.shape != (b, kh, 1) or new_vs.shape != (b, kh, 1)
        or cache_ks.shape != (b, kh, s) or cache_vs.shape != (b, kh, s)
        or not (cache_ks.is_contiguous() and cache_vs.is_contiguous())
    ):
        raise ValueError(
            "fused_decode_attention: int8 needs f32 new_ks/new_vs [B, KH, 1] and contiguous "
            "cache scales [B, KH, S]")
    if any(t.device != q.device for t in (new_k, new_v, cache_k, cache_v, positions) + scales):
        raise ValueError("fused_decode_attention: all operands must be on one device")
    # The kernel writes and reads 16-byte rows of the caches in place.
    if not (cache_k.is_contiguous() and cache_v.is_contiguous()) or (
            cache_k.data_ptr() | cache_v.data_ptr()) % 16:
        raise ValueError("fused_decode_attention: caches must be contiguous and 16-byte aligned")
    q, new_k, new_v = q.contiguous(), new_k.contiguous(), new_v.contiguous()
    if (new_k.data_ptr() | new_v.data_ptr()) % 16:
        raise ValueError("fused_decode_attention: the fresh rows must be 16-byte aligned")
    if quantized:
        new_ks, new_vs = new_ks.contiguous(), new_vs.contiguous()
    pos = positions.to(torch.int32).contiguous()  # clamped to [0, S-1] in the kernel
    out = torch.empty_like(q)
    head = (q.data_ptr(), new_k.data_ptr(), new_v.data_ptr(),
            new_ks.data_ptr() if quantized else None, new_vs.data_ptr() if quantized else None,
            cache_k.data_ptr(), cache_v.data_ptr(),
            cache_ks.data_ptr() if quantized else None, cache_vs.data_ptr() if quantized else None,
            pos.data_ptr(), out.data_ptr())
    dims = (b, h, kh, s, d, kernels.DTYPE_CODES[cache_k.dtype], float(scale))
    if design == "split":
        if quantized and (cache_ks.data_ptr() | cache_vs.data_ptr()) % 16:
            raise ValueError("fused_decode_attention: cache scales must be 16-byte aligned")
        rows, n_split, ws = split_workspace(q, b, kh, s)
        rc = kernels.library().fused_decode_split(
            *head, ws.data_ptr() if ws is not None else None, *dims, rows, n_split, kernels.stream_ptr(q.device))
        kernels.check(rc, "fused_decode_split")
        fused_decode_attention.launches_split += 1
    else:
        rc = kernels.library().fused_decode(*head, *dims, kernels.stream_ptr(q.device))
        kernels.check(rc, "fused_decode")
        fused_decode_attention.launches_rows += 1
    fused_decode_attention.launches += 1
    return out, cache_k, cache_v


fused_decode_attention.launches = 0  # every launch
fused_decode_attention.launches_split = 0  # csrc/decode_split.cu (head_dim 64, 128; 256 at other groups)
fused_decode_attention.launches_rows = 0  # csrc/fused_decode.cu (head_dim 16, 32, 256)
fused_decode_attention.launches_padded = 0  # q padded to a cache laid out at a padded head dim
