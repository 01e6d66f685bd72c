"""The paged KV cache's device ops (port of substratus_tpu/ops/kvcache.py).

One page pool per layer,

    k/v        [pages, page_size, kv_heads, head_dim]
    (+ scales  [pages, page_size, kv_heads, 1] when int8)

and a block table [B, max_pages] of page ids per sequence. Shapes are
static: what changes from step to step is the contents of the block
table, so a decode step over the pool can be captured once as a CUDA
graph and replayed (serve/decode_graph.py). serve/paged_kv.py decides
which page holds which tokens.

The read is the reference's: the new entries are written through flat
token indices, then each sequence's context is gathered as a slot-local
[B, max_pages * page_size] view, so the plain masked attention applies
unchanged. Gathered index j is the token's position in its sequence, so
the causal mask (k_pos <= q_pos) hides unwritten and foreign pages. There
is no kernel here: the JAX package has none for this path either (an XLA
scatter and gather); a kernel that reads pages in place through the block
table is later work.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from substratus_tpu_torch.ops.quant import dequantize_kv, quantize_kv


def _flat(a: torch.Tensor) -> torch.Tensor:
    """[P, bs, ...] -> [P * bs, ...], a view of the pool (written in place)."""
    return a.view((a.shape[0] * a.shape[1],) + tuple(a.shape[2:]))


def paged_update_and_read(
    layer_cache: Dict[str, torch.Tensor],
    block_table: torch.Tensor,  # [B, M] page ids
    positions: torch.Tensor,  # [B, S] slot-local positions
    k_new: torch.Tensor,  # [B, S, KH, hd]
    v_new: torch.Tensor,
    dtype: torch.dtype,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """Write the new entries at `positions` into the layer's pool, in
    place, then gather every row's context. Returns (layer_cache,
    k_ctx, v_ctx [B, M * bs, KH, hd] in `dtype`).

    Only ops a CUDA graph can capture: no host read, no boolean-mask
    indexing, no shape that depends on the data. Duplicate positions (the
    bucket padding clamps onto the one slot past the prompt) write in an
    unspecified order; the first decode step writes that slot before it
    reads it."""
    bs = layer_cache["k"].shape[1]
    b, m = block_table.shape
    block_table = block_table.long()
    positions = positions.long()
    # A write past the block table's reach goes to the trash page
    # (physical page 0), never onto the row's last page by clamping.
    page_idx = positions // bs
    pid = torch.gather(block_table, 1, torch.clamp(page_idx, max=m - 1))
    pid = torch.where(page_idx >= m, torch.zeros_like(pid), pid)
    idx = (pid * bs + positions % bs).reshape(-1)  # [B * S] flat token index
    ctx_idx = (block_table[:, :, None] * bs + torch.arange(bs, device=block_table.device)).reshape(-1)

    def write(name: str, vals: torch.Tensor) -> None:
        flat = _flat(layer_cache[name])
        flat.index_copy_(0, idx, vals.reshape((-1,) + tuple(flat.shape[1:])).to(flat.dtype))

    def gather(name: str) -> torch.Tensor:
        flat = _flat(layer_cache[name])
        return flat.index_select(0, ctx_idx).view((b, m * bs) + tuple(flat.shape[1:]))

    if "k_scale" in layer_cache:
        kq, ks = quantize_kv(k_new)
        vq, vs = quantize_kv(v_new)
        for name, vals in (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs)):
            write(name, vals)
        k_ctx = dequantize_kv(gather("k"), gather("k_scale"), dtype)
        v_ctx = dequantize_kv(gather("v"), gather("v_scale"), dtype)
    else:
        write("k", k_new)
        write("v", v_new)
        k_ctx, v_ctx = gather("k"), gather("v")
    return layer_cache, k_ctx, v_ctx


def init_paged_cache(
    n_layers: int,
    pages: int,
    page_size: int,
    kv_heads: int,
    head_dim: int,
    dtype: torch.dtype,
    quantized: bool = False,
    device=None,
) -> Dict[str, torch.Tensor]:
    """Layers-stacked page pool: k/v [L, P, bs, KH, hd] (int8 plus f32
    scales [L, P, bs, KH, 1] when quantized)."""
    shape = (n_layers, pages, page_size, kv_heads, head_dim)
    entry = torch.int8 if quantized else dtype
    cache = {"k": torch.zeros(shape, dtype=entry, device=device),
             "v": torch.zeros(shape, dtype=entry, device=device)}
    if quantized:
        cache["k_scale"] = torch.ones(shape[:-1] + (1,), dtype=torch.float32, device=device)
        cache["v_scale"] = torch.ones(shape[:-1] + (1,), dtype=torch.float32, device=device)
    return cache
