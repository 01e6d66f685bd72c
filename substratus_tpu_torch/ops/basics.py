"""Elementwise / normalization / positional ops (port of
substratus_tpu/ops/basics.py). Plain PyTorch: these are bandwidth-bound
elementwise passes that the JAX package also leaves outside any kernel."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in float32 accumulation regardless of input dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    normed = x32 * torch.reciprocal(torch.sqrt(var + eps))
    return (normed * scale.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    """Inverse frequencies, shape [head_dim // 2] (float32)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponent)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding, HF-Llama "rotate_half" convention, with
    f32 angles. x: [..., seq, heads, head_dim]; positions broadcastable
    to [..., seq]."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs  # [..., seq, d/2]
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat((x1 * cos - x2 * sin, x2 * cos + x1 * sin), dim=-1)
    return out.to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Classic LayerNorm (mean-centered, affine) in float32 accumulation,
    the OPT and Falcon normalizer (llama uses rms_norm)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    normed = (x32 - mean) * torch.reciprocal(torch.sqrt(var + eps))
    return (normed * scale.float() + bias.float()).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The exact (erf) GELU of Falcon's MLP: jax.nn.gelu(approximate=False)."""
    return F.gelu(x, approximate="none")


def lora_delta(h: torch.Tensor, adapter, scale: float, out_einsum: str) -> torch.Tensor:
    """LoRA low-rank update h @ A @ B * scale (port of the JAX package's
    lora_delta); adapter {"a": [in, r], "b": [r, *out]} from
    train/lora.py. Each product runs in the promoted dtype of its operands,
    as jnp.einsum promotes: bf16 adapters on an f32 model give an f32
    delta."""
    a, b = adapter["a"], adapter["b"]
    dt = torch.promote_types(h.dtype, a.dtype)
    down = torch.einsum("bsd,dr->bsr", h.to(dt), a.to(dt))
    dt = torch.promote_types(dt, b.dtype)
    return torch.einsum(out_einsum, down.to(dt), b.to(dt)) * scale


def batched_lora_einsum(out_einsum: str) -> str:
    """The per-row form of a lora_delta output einsum: the second operand
    (the gathered B matrices) grows a leading batch axis, e.g.
    'bsr,rhk->bshk' -> 'bsr,brhk->bshk'."""
    lhs, _, out = out_einsum.partition("->")
    first, _, second = lhs.partition(",")
    return f"{first},b{second}->{out}"


def lora_delta_indexed(h: torch.Tensor, adapter, scale: float, out_einsum: str,
                       adapter_ids: torch.Tensor) -> torch.Tensor:
    """Per-batch-row LoRA update for multi-tenant serving (port of the JAX
    package's lora_delta_indexed; serve/adapters.py): the adapter leaves
    carry a leading adapter-slot axis (a [A, in, r], b [A, r, *out]) and
    adapter_ids [B] gathers each row's pair (index_select on the slot
    axis), so one pair of einsums applies every tenant's delta in the same
    dispatch. Slot 0 is the all-zero identity adapter: rows without a
    tenant gather zeros and stay exactly the base model. Types promote as
    lora_delta's. Not a kernel: the JAX package leaves it to XLA's gather
    and einsums too."""
    ids = adapter_ids.to(device=h.device, dtype=torch.long)
    a = adapter["a"].index_select(0, ids)  # [B, in, r]
    b = adapter["b"].index_select(0, ids)  # [B, r, *out]
    dt = torch.promote_types(h.dtype, a.dtype)
    down = torch.einsum("bsd,bdr->bsr", h.to(dt), a.to(dt))
    dt = torch.promote_types(dt, b.dtype)
    return torch.einsum(batched_lora_einsum(out_einsum), down.to(dt), b.to(dt)) * scale
