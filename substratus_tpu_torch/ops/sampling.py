"""Token sampling: greedy / temperature / top-k / top-p (port of
substratus_tpu/ops/sampling.py). Runs on the logits' device; only the
sampled ids cross to the host. The draw uses an explicit
torch.Generator (Gumbel-max over the masked logits), so it cannot give
jax.random's tokens; greedy rows are exact."""
from __future__ import annotations

from typing import Optional

import torch


def masked_logits(
    logits: torch.Tensor,  # [B, V] float32
    temperature: torch.Tensor,  # [B] float32
    top_k: int = 0,
    top_p: Optional[torch.Tensor] = None,  # [B] float32 in (0, 1]
) -> torch.Tensor:
    """Temperature-scaled logits with the top-k / top-p tails set to
    -inf: the distribution `sample` draws from."""
    v = logits.shape[-1]
    safe_t = torch.clamp(temperature, min=1e-6)[:, None]
    scaled = logits / safe_t
    # masked_fill takes its value from the host as a kernel argument, so
    # nothing is copied to the device: the step stays capturable in a CUDA
    # graph (serve/decode_graph.py).
    if top_k and top_k < v:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    if top_p is not None:
        sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # Keep the smallest prefix with cumulative prob >= top_p (always
        # keep the first token).
        keep_sorted = (cum - probs) < top_p[:, None]
        cutoff = sorted_logits.masked_fill(~keep_sorted, float("inf")).amin(dim=-1, keepdim=True)
        scaled = scaled.masked_fill(scaled < cutoff, float("-inf"))
    return scaled


def sample(
    logits: torch.Tensor,  # [B, V] float32
    generator: torch.Generator,
    temperature: torch.Tensor,  # [B] float32; 0 => greedy for that row
    top_k: int = 0,  # static; 0 disables
    top_p: Optional[torch.Tensor] = None,  # [B] float32; None disables
) -> torch.Tensor:
    """Returns sampled token ids [B] int32."""
    greedy = logits.argmax(dim=-1)
    scaled = masked_logits(logits, temperature, top_k, top_p)
    u = torch.rand(
        scaled.shape, generator=generator, device=scaled.device, dtype=torch.float32
    )
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    sampled = (scaled + gumbel).argmax(dim=-1)
    return torch.where(temperature <= 0.0, greedy, sampled).to(torch.int32)
