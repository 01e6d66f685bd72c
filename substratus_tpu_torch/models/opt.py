"""OPT model family (port of substratus_tpu/models/opt.py): facebook/opt-125m
.. opt-6.7b, the reference's quickstart model (examples/facebook-opt-125m).

The architecture differs from llama's: learned position embeddings offset
by ``POS_OFFSET`` (OPT reserves the first two rows), LayerNorm with a bias,
biased q/k/v/o projections, a ReLU MLP with biases and a head tied to the
token embedding. Attention is multi-head (KH = H).

The weights keep the JAX package's names and einsum layouts (wq [D, H, hd],
bq [H, hd], fc1 [D, M], ...), one ``OPTBlock`` per layer where the JAX tree
stacks layers (bridge.params_from_jax splits it). Attention goes through
the kernel wrappers as llama's does: ``flash_attention`` for the no-cache
prefill and training, ``update_cache_and_attend`` (the decode kernel, and
the cached flash kernel for a long prompt's chunks) over the dense slot
cache [L, B, H, S, hd]. The family has no paged layout, no int8 cache, no
quantized weights and no attention switches, as in the JAX package: the
engine and the entry points refuse or skip those knobs for it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from substratus_tpu_torch.models import llama
from substratus_tpu_torch.models.llama import project, run_layers
from substratus_tpu_torch.ops.basics import layer_norm, lora_delta
from substratus_tpu_torch.ops.decode_attention import update_cache_and_attend
from substratus_tpu_torch.ops.flash_attention import flash_attention
from substratus_tpu_torch.utils.device import DeviceLike, resolve_device, seeded_generator

Cache = Dict[str, torch.Tensor]

POS_OFFSET = 2  # OPT reserves the first two position-embedding rows.

# train/lora.py adapters attach to the attention projections.
SUPPORTS_LORA = True
LORA_TARGETS = ("wq", "wk", "wv", "wo")


@dataclass(frozen=True)
class OPTConfig:
    vocab_size: int = 50272
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    hidden_dim: int = 3072
    max_seq_len: int = 2048
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_size(self) -> int:
        return self.dim // self.n_heads

    # The engine treats kv heads uniformly; OPT is MHA.
    @property
    def n_kv_heads(self) -> int:
        return self.n_heads

    def replace(self, **kw) -> "OPTConfig":
        return dataclasses.replace(self, **kw)


# Same shapes as the JAX package's CONFIGS.
CONFIGS: Dict[str, OPTConfig] = {
    "tiny-opt": OPTConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4, hidden_dim=128, max_seq_len=128),
    "opt-125m": OPTConfig(),
    "opt-1.3b": OPTConfig(dim=2048, n_layers=24, n_heads=32, hidden_dim=8192),
    "opt-6.7b": OPTConfig(dim=4096, n_layers=32, n_heads=32, hidden_dim=16384),
}


def _param(shape, cfg: OPTConfig, device: torch.device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=cfg.dtype, device=device), requires_grad=False)


class OPTBlock(nn.Module):
    """One decoder layer's weights, in the JAX einsum layouts."""

    def __init__(self, cfg: OPTConfig, device: torch.device):
        super().__init__()
        D, H, hd, M = cfg.dim, cfg.n_heads, cfg.head_size, cfg.hidden_dim
        shapes = {"ln1_scale": (D,), "ln1_bias": (D,), "wq": (D, H, hd), "bq": (H, hd), "wk": (D, H, hd),
                  "bk": (H, hd), "wv": (D, H, hd), "bv": (H, hd), "wo": (H, hd, D), "bo": (D,),
                  "ln2_scale": (D,), "ln2_bias": (D,), "fc1": (D, M), "fc1_b": (M,), "fc2": (M, D), "fc2_b": (D,)}
        for name, shape in shapes.items():
            setattr(self, name, _param(shape, cfg, device))


class OPT(nn.Module):
    """Parameter container (uninitialized; fill with init_params or
    load_state_dict). Call forward() / decode_step() to run it."""

    def __init__(self, cfg: OPTConfig, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.tok_embed = _param((cfg.vocab_size, cfg.dim), cfg, device)
        self.pos_embed = _param((cfg.max_seq_len + POS_OFFSET, cfg.dim), cfg, device)
        self.layers = nn.ModuleList(OPTBlock(cfg, device) for _ in range(cfg.n_layers))
        self.final_ln_scale = _param((cfg.dim,), cfg, device)
        self.final_ln_bias = _param((cfg.dim,), cfg, device)

    @property
    def device(self) -> torch.device:
        return self.tok_embed.device


@torch.no_grad()
def init_params(cfg: OPTConfig, seed: int = 0, device: DeviceLike = None) -> OPT:
    """Random init on `device` from a seeded torch.Generator: truncated
    normal in [-2, 2] scaled by fan_in^-0.5 (the JAX init's distribution,
    not its numbers), LayerNorm scales 1, biases 0."""
    params = OPT(cfg, device)
    gen = seeded_generator(seed, params.device)

    def dense(w: torch.Tensor, fan_in: int) -> None:
        tmp = torch.empty(w.shape, dtype=torch.float32, device=w.device)
        torch.nn.init.trunc_normal_(tmp, a=-2.0, b=2.0, generator=gen)
        w.copy_(tmp.mul_(fan_in**-0.5))

    D, M = cfg.dim, cfg.hidden_dim
    dense(params.tok_embed, D)
    dense(params.pos_embed, D)
    for lp in params.layers:
        for name in ("wq", "wk", "wv", "wo", "fc1"):
            dense(getattr(lp, name), D)
        dense(lp.fc2, M)
        for name in ("ln1_scale", "ln2_scale"):
            getattr(lp, name).fill_(1.0)
        for name in ("ln1_bias", "bq", "bk", "bv", "bo", "ln2_bias", "fc1_b", "fc2_b"):
            getattr(lp, name).zero_()
    params.final_ln_scale.fill_(1.0)
    params.final_ln_bias.zero_()
    return params


# The dense decode cache k/v [L, B, KH, S, hd] (KH = H for OPT, 1 on falcon-7b).
init_cache = llama.init_cache


def position_rows(positions: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Rows of pos_embed for `positions`, as the JAX package's
    ``pos_embed[positions + POS_OFFSET]`` reads them: a negative index
    counts from the end and an index past the table clamps to its last row
    (XLA's gather). The engine passes such positions (an idle slot's drift
    past the window); torch would raise on the CPU and assert on the card."""
    idx = positions.long() + POS_OFFSET
    return torch.where(idx < 0, idx + n_rows, idx).clamp(0, n_rows - 1)


def _block(
    x: torch.Tensor,  # [B, S, D]
    lp: OPTBlock,
    positions: torch.Tensor,  # [B, S]
    cfg: OPTConfig,
    layer_cache: Optional[Cache],
    kv_length: Optional[torch.Tensor] = None,
    lora_layer=None,
    lora_scale: float = 1.0,
) -> Tuple[torch.Tensor, Cache]:
    """One pre-LN decoder layer. Returns (x_out, kv): the fresh {k, v}
    without a cache (prefill), else the updated layer cache."""
    lora = lora_layer if lora_layer is not None else {}
    h = layer_norm(x, lp.ln1_scale, lp.ln1_bias, cfg.norm_eps)

    def proj(name: str, bias: str, eq: str, lora_eq: str) -> torch.Tensor:
        out = project(eq, h, getattr(lp, name), cfg) + getattr(lp, bias)
        if name in lora:
            out = out + lora_delta(h, lora[name], lora_scale, lora_eq)
        return out

    q = proj("wq", "bq", "bsd,dhk->bshk", "bsr,rhk->bshk")
    kk = proj("wk", "bk", "bsd,dhk->bshk", "bsr,rhk->bshk")
    vv = proj("wv", "bv", "bsd,dhk->bshk", "bsr,rhk->bshk")
    if layer_cache is None:
        attn = flash_attention(q, kk, vv, True)
        kv = {"k": kk, "v": vv}
    else:
        attn, kv = update_cache_and_attend(layer_cache, q, kk, vv, positions, kv_length=kv_length)
    o = project("bshk,hkd->bsd", attn, lp.wo, cfg) + lp.bo
    if "wo" in lora:  # the adapter sees the flattened [B, S, H*hd]
        o = o + lora_delta(attn.flatten(2), lora["wo"], lora_scale, "bsr,rd->bsd")
    x = x + o
    h = layer_norm(x, lp.ln2_scale, lp.ln2_bias, cfg.norm_eps)
    h = F.relu(project("bsd,dm->bsm", h, lp.fc1, cfg) + lp.fc1_b)
    return x + project("bsm,md->bsd", h, lp.fc2, cfg) + lp.fc2_b, kv


def forward(
    params: OPT,
    tokens: torch.Tensor,  # [B, S] integer ids
    cfg: OPTConfig,
    *,
    positions: Optional[torch.Tensor] = None,  # [B, S] absolute positions
    cache: Optional[Cache] = None,  # init_cache's (written in place)
    kv_length: Optional[torch.Tensor] = None,  # [B] valid cache prefix
    lora=None,  # {"layers": per-layer adapters (train/lora.py), "scale": alpha / rank}
    remat: bool = False,  # recompute each block in the backward
    train: bool = False,  # a training forward: no cache fragment
) -> Tuple[torch.Tensor, Cache]:
    """Returns (logits [B, S, vocab] float32, kv), as models/llama.py's
    forward: without a cache the fresh entries {k, v: [L, B, S, H, hd]}
    ({} when train), with one the same (updated) cache dict."""
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = (params.tok_embed[tokens.long()] + params.pos_embed[position_rows(positions, params.pos_embed.shape[0])])
    x = x.to(cfg.dtype)
    x, kv = run_layers(_block, params, x, positions, cfg, cache, kv_length, lora, remat, train)
    x = layer_norm(x, params.final_ln_scale, params.final_ln_bias, cfg.norm_eps)
    return project("bsd,dv->bsv", x, params.tok_embed.t(), cfg).float(), kv  # tied head


def decode_step(params: OPT, cache: Cache, tokens: torch.Tensor, positions: torch.Tensor,
                cfg: OPTConfig) -> Tuple[torch.Tensor, Cache]:
    """One decode step: logits [B, vocab]; the cache is updated in place."""
    logits, cache = forward(params, tokens[:, None], cfg, positions=positions[:, None], cache=cache)
    return logits[:, 0, :], cache
