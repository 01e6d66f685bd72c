"""Attention reference with GQA + causal/decode masking (port of
substratus_tpu/ops/attention.py). It is the numerical oracle for both
attention kernels (ops/flash_attention.py, ops/decode_attention.py).
Shapes follow the [batch, seq, heads, head_dim] convention."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def dot_product_attention(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, KH, D]
    v: torch.Tensor,  # [B, Sk, KH, D]
    *,
    causal: bool = True,
    q_positions: Optional[torch.Tensor] = None,  # [B, Sq] absolute positions
    kv_length: Optional[torch.Tensor] = None,  # [B] valid kv prefix length
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Grouped-query attention with float32 softmax accumulation; masked
    logits are -1e30, as in the JAX reference."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    if h % kh:
        raise ValueError(f"query heads {h} not a multiple of kv heads {kh}")
    group = h // kh
    if scale is None:
        scale = d**-0.5

    qf = (q.float() * scale).reshape(b, sq, kh, group, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())  # [B,KH,G,Sq,Sk]
    if causal:
        if q_positions is None:
            q_pos = torch.arange(sq, device=q.device)[None, :]
        else:
            q_pos = q_positions.long()
        k_pos = torch.arange(sk, device=q.device)
        mask = k_pos[None, None, :] <= q_pos[:, :, None]  # [B|1, Sq, Sk]
        logits = torch.where(mask[:, None, None], logits, NEG_INF)
    if kv_length is not None:
        valid = torch.arange(sk, device=q.device)[None, :] < kv_length[:, None]
        logits = torch.where(valid[:, None, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)
