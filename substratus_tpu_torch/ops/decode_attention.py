"""Decode-step attention over the dense slot cache, bf16 or int8: the CUDA
kernels beside their plain PyTorch version, plus the cache update around
them that picks the attention of each step (port of
substratus_tpu/ops/decode_attention.py): these kernels, the fused write +
attention of ops/fused_decode.py, or, for multi-token chunks, the cached
flash kernel of ops/flash_attention.py.

The kernels replace substratus_tpu/ops/decode_attention.py::_kernel
(decode_attention(impl="pallas")). Single-token decode reads the whole
live cache once per layer per step, so they are bound by bytes. Two
designs, chosen by shape alone (ops/fused_decode.py::decode_design):
csrc/decode_split.cu (S split over blocks by decode_split_plan, a ring of
cache tiles, one softmax rescale a tile, any query group in slices of at
most 8 rows; head_dim 64 and 128) and csrc/decode_attn.cu (one block per
slot and kv head; head_dim 16, 32 and 256, groups of 1, 2, 4 and 8; any
other group goes to the split design, built at 256 too). See the source
notes.

Cache layout is [B, KH, S, D] (each kv head's history contiguous), on the
card at the rows and head dim of ops/fused_decode.py::cache_layout: a
head dim the kernels are not built for padded to the next built one
(ops/headdim.py), and for the split design D at least 64 and int8 rows a
multiple of 4. The new rows are written padded the same way; int8
caches carry f32 scales [B, KH, S]. k_scale multiplies the score after
the QK dot and v_scale folds into p, so no dequantized copy is made.

Unlike the JAX package, which rebinds a donated cache, the port writes
the cache in place; every write and every kernel read runs on the one
scheduler thread, on PyTorch's current stream. A write at a position
past the cache (a drifting inactive slot) is dropped, as JAX's
out-of-range scatter drops it: no index ever goes past S-1.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from substratus_tpu_torch import kernels
from substratus_tpu_torch.ops.attention import NEG_INF, dot_product_attention
from substratus_tpu_torch.ops.flash_attention import flash_cached_attention
from substratus_tpu_torch.ops.fused_decode import check_decode_layout, fused_decode_attention, split_workspace
from substratus_tpu_torch.ops.headdim import pad_head
from substratus_tpu_torch.ops.quant import dequantize_kv, quantize_kv


def decode_attention_plain(
    q: torch.Tensor,  # [B, 1, H, D]
    k: torch.Tensor,  # [B, KH, S, D]
    v: torch.Tensor,
    positions: torch.Tensor,  # [B]
    k_scale: Optional[torch.Tensor] = None,  # [B, KH, S] f32
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, following the JAX Pallas
    _kernel: q scaled by `scale` (D^-0.5 when None) in f32, f32 scores
    (times k_scale), mask
    cols <= pos, f32 softmax, p times v_scale kept f32 for the PV
    product. A row with no live column outputs 0. (The JAX _xla path
    scales q in the model dtype and rounds p to it instead; the two agree
    exactly only in f32.)"""
    b, _, h, d = q.shape
    kh, s = k.shape[1], k.shape[2]
    g = h // kh
    qf = (q.float() * (d**-0.5 if scale is None else scale)).reshape(b, kh, g, d)
    logits = torch.einsum("bkgd,bksd->bkgs", qf, k.float())
    if k_scale is not None:
        logits = logits * k_scale[:, :, None, :]
    live = torch.arange(s, device=q.device)[None, :] <= positions[:, None].long()  # [B, S]
    logits = torch.where(live[:, None, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    p = torch.where(live[:, None, None, :], p, 0.0)
    if v_scale is not None:
        p = p * v_scale[:, :, None, :]
    out = torch.einsum("bkgs,bksd->bkgd", p, v.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # [B, 1, H, D]
    k: torch.Tensor,  # [B, KH, S, D] (int8 when k_scale given)
    v: torch.Tensor,
    positions: torch.Tensor,  # [B] absolute position of the query token
    k_scale: Optional[torch.Tensor] = None,  # [B, KH, S] f32
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single-token attention against the cache, columns <= positions[b].
    Returns [B, 1, H, D] in q's dtype. A cache laid out at a padded head
    dim (ops/fused_decode.py::cache_layout) takes q padded to it, at q's
    own D^-0.5, and the output is sliced back. CUDA tensors launch the
    design decode_design names (or raise); CPU tensors run the plain
    version. ``decode_attention.launches`` counts kernel launches, its
    ``launches_split`` and ``launches_rows`` those of each design,
    ``launches_padded`` those with q padded."""
    d = q.shape[-1]
    if k.shape[-1] > d:
        out = _decode(pad_head(q, k.shape[-1]), k, v, positions, k_scale, v_scale, d**-0.5)
        if q.device.type == "cuda":
            decode_attention.launches_padded += 1
        return out[..., :d]
    return _decode(q, k, v, positions, k_scale, v_scale, d**-0.5)


def _decode(q, k, v, positions, k_scale, v_scale, scale: float) -> torch.Tensor:
    """The decode kernel's launch at the cache's head dim (or, for CPU
    tensors, its plain version)."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, positions, k_scale, v_scale, scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    b, sq, h, d = q.shape
    _, kh, s, dk = k.shape
    quantized = k_scale is not None
    if sq != 1 or dk != d or v.shape != k.shape or k.shape[0] != b or h % kh:
        raise ValueError(f"decode_attention: unsupported shapes q{tuple(q.shape)} k{tuple(k.shape)}")
    design = check_decode_layout("decode_attention", d, s, quantized, h // kh)
    if q.dtype != torch.bfloat16:
        raise ValueError(f"decode_attention: the kernel takes bf16 queries, got {q.dtype}")
    want = torch.int8 if quantized else torch.bfloat16
    if k.dtype != want or v.dtype != want:
        raise ValueError(f"decode_attention: cache must be {want}, got {k.dtype}/{v.dtype}")
    if quantized and (
        v_scale is None or k_scale.shape != (b, kh, s) or v_scale.shape != (b, kh, s)
        or k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32
    ):
        raise ValueError("decode_attention: int8 caches need f32 k_scale and v_scale [B, KH, S]")
    tensors = (q, k, v, positions) + ((k_scale, v_scale) if quantized else ())
    if any(t.device != q.device for t in tensors):
        raise ValueError("decode_attention: all operands must be on one device")
    # The kernel reads 16-byte rows straight from the cache: no copies of it.
    if not (k.is_contiguous() and v.is_contiguous()) or (k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError("decode_attention: k/v must be contiguous and 16-byte aligned")
    if quantized and not (k_scale.is_contiguous() and v_scale.is_contiguous()):
        raise ValueError("decode_attention: scales must be contiguous")
    q = q.contiguous()
    pos = positions.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if quantized else None, v_scale.data_ptr() if quantized else None,
            pos.data_ptr(), out.data_ptr())
    dims = (b, h, kh, s, d, kernels.DTYPE_CODES[k.dtype], float(scale))
    if design == "split":
        if quantized and (k_scale.data_ptr() | v_scale.data_ptr()) % 16:
            raise ValueError("decode_attention: scales must be 16-byte aligned")
        rows, n_split, ws = split_workspace(q, b, kh, s)
        rc = kernels.library().decode_split(
            *head, ws.data_ptr() if ws is not None else None, *dims, rows, n_split, kernels.stream_ptr(q.device))
        kernels.check(rc, "decode_split")
        decode_attention.launches_split += 1
    else:
        rc = kernels.library().decode_attn(*head, *dims, kernels.stream_ptr(q.device))
        kernels.check(rc, "decode_attn")
        decode_attention.launches_rows += 1
    decode_attention.launches += 1
    return out


decode_attention.launches = 0  # every launch
decode_attention.launches_split = 0  # csrc/decode_split.cu (head_dim 64, 128; 256 at other groups)
decode_attention.launches_rows = 0  # csrc/decode_attn.cu (head_dim 16, 32, 256)
decode_attention.launches_padded = 0  # q padded to a cache laid out at a padded head dim


def _write_rows(cache: torch.Tensor, rows: torch.Tensor, positions: torch.Tensor) -> None:
    """cache[b, :, positions[b, i]] = rows[b, :, i] in place, dropping
    positions >= S (as JAX's out-of-range scatter does) without ever
    indexing past S-1. cache [B, KH, S, ...], rows [B, KH, Sn, ...],
    positions [B, Sn]."""
    b, kh, s = cache.shape[:3]
    sn = positions.shape[1]
    bidx = torch.arange(b, device=cache.device)[:, None, None]
    hidx = torch.arange(kh, device=cache.device)[None, :, None]
    if sn == 1:
        # The decode path: one row per (b, head), so a select against the
        # current value drops out-of-range writes with no host sync.
        valid = (positions < s).reshape(b, 1, 1, *([1] * (rows.dim() - 3)))
        idx = torch.clamp(positions, max=s - 1)[:, None, :]
        old = cache[bidx, hidx, idx]
        cache[bidx, hidx, idx] = torch.where(valid, rows.to(cache.dtype), old)
        return
    # Multi-token writes (chunked continuation), with no host sync: several
    # entries may land on one row (a drop clamped onto S-1, the engine's
    # padded tail clamped onto one position). The last in-range entry of a
    # row wins, as XLA's scatter has it, and every write to that row carries
    # the winner's value (or the row's own where none is in range), so
    # colliding writes agree whatever order the device runs them in.
    pos = positions.long()
    tgt = torch.remainder(torch.clamp(pos, -s, s - 1), s)  # [B, Sn]; negatives wrap, as in JAX
    src = torch.where((pos < s) & (pos >= -s), torch.arange(sn, device=cache.device), -1)
    win = torch.full((b, s), -1, dtype=src.dtype, device=cache.device).scatter_reduce_(1, tgt, src, "amax")
    win = win.gather(1, tgt)  # [B, Sn] the entry whose value each write carries
    idx = tgt[:, None, :]
    new = rows[bidx, hidx, win.clamp(min=0)[:, None, :]].to(cache.dtype)
    keep = (win >= 0).reshape(b, 1, sn, *([1] * (rows.dim() - 3)))
    cache[bidx, hidx, idx] = torch.where(keep, new, cache[bidx, hidx, idx])


def update_cache_and_attend(
    layer_cache: Dict[str, torch.Tensor],  # {k, v[, k_scale, v_scale]} [B, KH, S, D]
    q: torch.Tensor,  # [B, S, H, D] new queries (S=1 on the decode path)
    kk: torch.Tensor,  # [B, S, KH, D] new keys (activation layout)
    vv: torch.Tensor,  # [B, S, KH, D]
    positions: torch.Tensor,  # [B, S] absolute positions
    *,
    kv_length: Optional[torch.Tensor] = None,  # [B] valid prefix override
    impl: str = "kernel",
    chunk_impl: str = "flash",
):
    """Write fresh kv entries into a layer's slot cache (in place,
    quantizing when the cache is int8) and attend. Single-token steps go
    through decode_attention (impl="kernel"), its plain version
    (impl="plain"), or the fused write + attention kernel of
    ops/fused_decode.py (impl="fused"). Multi-token continuation (chunked
    prefill) or kv_length-masked resumes run flash_cached_attention on the
    written cache (chunk_impl="flash", no dequantized copy) or dequantize
    and run dot_product_attention (chunk_impl="plain"). A cache laid out
    at a padded head dim (ops/fused_decode.py::cache_layout) gets the rows
    padded with zero columns (an int8 row's scale is unchanged: a zero
    moves no max-abs); the kernels take q padded, the plain versions read
    the cache's first D columns. Returns (attn [B, S, H, D], the layer
    cache dict)."""
    if impl not in ("kernel", "plain", "fused"):
        raise ValueError(f"decode attention impl {impl!r} invalid (kernel|plain|fused)")
    if chunk_impl not in ("flash", "plain"):
        raise ValueError(f"chunk attention impl {chunk_impl!r} invalid (flash|plain)")
    s = kk.shape[1]
    dc = layer_cache["k"].shape[-1]
    kkT = pad_head(kk.transpose(1, 2), dc)  # [B, KH, S, D of the cache]
    vvT = pad_head(vv.transpose(1, 2), dc)
    quantized = "k_scale" in layer_cache

    if s == 1 and kv_length is None and impl == "fused":
        # One clamp shared by the scale writes and the kernel's row write:
        # a drifted position (an idle engine slot) hits row S-1 in both, so
        # an int8 row is never paired with a stale scale.
        positions = torch.clamp(positions, max=layer_cache["k"].shape[2] - 1)
        if quantized:
            kq, kscale = quantize_kv(kkT)  # scale [B, KH, 1, 1]
            vq, vscale = quantize_kv(vvT)
            _write_rows(layer_cache["k_scale"], kscale[..., 0], positions)
            _write_rows(layer_cache["v_scale"], vscale[..., 0], positions)
            attn, _, _ = fused_decode_attention(
                q, kq, vq, layer_cache["k"], layer_cache["v"], positions[:, 0],
                kscale[..., 0], vscale[..., 0], layer_cache["k_scale"], layer_cache["v_scale"],
            )
        else:
            attn, _, _ = fused_decode_attention(
                q, kkT.to(layer_cache["k"].dtype), vvT.to(layer_cache["v"].dtype),
                layer_cache["k"], layer_cache["v"], positions[:, 0],
            )
        return attn, layer_cache

    if quantized:
        kq, kscale = quantize_kv(kkT)  # scale [B, KH, S, 1]
        vq, vscale = quantize_kv(vvT)
        _write_rows(layer_cache["k"], kq, positions)
        _write_rows(layer_cache["v"], vq, positions)
        _write_rows(layer_cache["k_scale"], kscale[..., 0], positions)
        _write_rows(layer_cache["v_scale"], vscale[..., 0], positions)
    else:
        _write_rows(layer_cache["k"], kkT, positions)
        _write_rows(layer_cache["v"], vvT, positions)
    d = q.shape[-1]
    if s == 1 and kv_length is None:
        if impl == "kernel":
            attn = decode_attention(q, layer_cache["k"], layer_cache["v"], positions[:, 0],
                                    layer_cache.get("k_scale"), layer_cache.get("v_scale"))
        else:
            attn = decode_attention_plain(q, layer_cache["k"][..., :d], layer_cache["v"][..., :d], positions[:, 0],
                                          layer_cache.get("k_scale"), layer_cache.get("v_scale"))
        return attn, layer_cache
    if chunk_impl == "flash":
        attn = flash_cached_attention(
            q, layer_cache["k"], layer_cache["v"], positions,
            layer_cache.get("k_scale"), layer_cache.get("v_scale"), kv_length,
        )
        return attn, layer_cache
    if quantized:
        k_cache = dequantize_kv(layer_cache["k"], layer_cache["k_scale"][..., None], q.dtype)
        v_cache = dequantize_kv(layer_cache["v"], layer_cache["v_scale"][..., None], q.dtype)
    else:
        k_cache, v_cache = layer_cache["k"], layer_cache["v"]
    attn = dot_product_attention(
        q, k_cache[..., :d].transpose(1, 2), v_cache[..., :d].transpose(1, 2),
        causal=True, q_positions=positions, kv_length=kv_length,
    )
    return attn, layer_cache


def pack_fragment(cache: Dict[str, torch.Tensor], kv: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Convert an activation-layout prefill fragment {k, v: [..., S, KH, D]}
    into the slot-cache layout {k, v: [..., KH, S, D][, scales [..., KH, S]]},
    quantizing when `cache` is int8, at the cache's head dim (zero columns
    where it is laid out padded)."""
    dc = cache["k"].shape[-1]
    kT = pad_head(kv["k"].transpose(-3, -2), dc)
    vT = pad_head(kv["v"].transpose(-3, -2), dc)
    if "k_scale" in cache:
        kq, ks = quantize_kv(kT)
        vq, vs = quantize_kv(vT)
        return {"k": kq, "k_scale": ks[..., 0], "v": vq, "v_scale": vs[..., 0]}
    return {"k": kT.to(cache["k"].dtype), "v": vT.to(cache["v"].dtype)}
