"""int8 KV-cache quantization (the part of substratus_tpu/ops/quant.py the
int8 slot cache needs). torch.round rounds half to even, as jnp.round
does, so the port's int8 entries match the JAX package's bit for bit."""
from __future__ import annotations

from typing import Tuple

import torch


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-vector symmetric int8 over the trailing head_dim; the f32
    scale keeps a size-1 trailing dim."""
    x32 = x.float()
    absmax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax / 127.0)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(
    q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    return (q.float() * scale).to(dtype)
