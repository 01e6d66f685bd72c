"""Falcon model family (port of substratus_tpu/models/falcon.py):
falcon-7b[-instruct] and falcon-40b (examples/falcon-7b-instruct,
examples/falcon-40b).

The architecture differs from llama's:

  * the parallel block: x + attn(ln(x)) + mlp(ln(x)), one residual add; on
    7b-style models attention and MLP share one LayerNorm, on 40b-style
    ones (``separate_ln``, HF's new_decoder_architecture) each has its own;
  * multi-query (7b: 71 query heads on 1 kv head) or grouped-query (40b:
    128 on 8) attention with the rotary embedding of ops/basics.py::rope;
  * an exact (erf) GELU MLP, biasless projections, a head tied to the
    token embedding.

The weights keep the JAX package's names and einsum layouts, one
``FalconBlock`` per layer. Attention goes through the kernel wrappers as
llama's does: ``flash_attention`` for the no-cache prefill and training,
``update_cache_and_attend`` (the decode kernel, whose split design takes
any query group, and the cached flash kernel for a long prompt's chunks)
over the dense slot cache [L, B, KH, S, hd]. The family has no paged
layout, no int8 cache, no quantized weights and no attention switches, as
in the JAX package.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from substratus_tpu_torch.models import llama
from substratus_tpu_torch.models.llama import project, run_layers
from substratus_tpu_torch.ops.basics import gelu, layer_norm, lora_delta, rope
from substratus_tpu_torch.ops.decode_attention import update_cache_and_attend
from substratus_tpu_torch.ops.flash_attention import flash_attention
from substratus_tpu_torch.utils.device import DeviceLike, resolve_device, seeded_generator

Cache = Dict[str, torch.Tensor]

# train/lora.py adapters attach to the attention projections.
SUPPORTS_LORA = True
LORA_TARGETS = ("wq", "wk", "wv", "wo")


@dataclass(frozen=True)
class FalconConfig:
    vocab_size: int = 65024
    dim: int = 4544
    n_layers: int = 32
    n_heads: int = 71
    n_kv_heads: int = 1
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 2048
    separate_ln: bool = False  # True = 40b-style ln_attn / ln_mlp
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_size(self) -> int:
        return self.dim // self.n_heads

    @property
    def hidden_dim(self) -> int:
        return 4 * self.dim

    def replace(self, **kw) -> "FalconConfig":
        return dataclasses.replace(self, **kw)


# Same shapes as the JAX package's CONFIGS.
CONFIGS: Dict[str, FalconConfig] = {
    "tiny-falcon": FalconConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=1, max_seq_len=128),
    "tiny-falcon-40b-style": FalconConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                                          max_seq_len=128, separate_ln=True),
    "falcon-7b": FalconConfig(),
    "falcon-40b": FalconConfig(dim=8192, n_layers=60, n_heads=128, n_kv_heads=8, separate_ln=True),
}


def _param(shape, cfg: FalconConfig, device: torch.device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=cfg.dtype, device=device), requires_grad=False)


class FalconBlock(nn.Module):
    """One decoder layer's weights, in the JAX einsum layouts."""

    def __init__(self, cfg: FalconConfig, device: torch.device):
        super().__init__()
        D, H, KH, hd, M = cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_size, cfg.hidden_dim
        shapes = {"ln1_scale": (D,), "ln1_bias": (D,), "wq": (D, H, hd), "wk": (D, KH, hd), "wv": (D, KH, hd),
                  "wo": (H, hd, D), "fc1": (D, M), "fc2": (M, D)}
        if cfg.separate_ln:
            shapes.update({"ln2_scale": (D,), "ln2_bias": (D,)})
        for name, shape in shapes.items():
            setattr(self, name, _param(shape, cfg, device))


class Falcon(nn.Module):
    """Parameter container (uninitialized; fill with init_params or
    load_state_dict). Call forward() / decode_step() to run it."""

    def __init__(self, cfg: FalconConfig, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.tok_embed = _param((cfg.vocab_size, cfg.dim), cfg, device)
        self.layers = nn.ModuleList(FalconBlock(cfg, device) for _ in range(cfg.n_layers))
        self.final_ln_scale = _param((cfg.dim,), cfg, device)
        self.final_ln_bias = _param((cfg.dim,), cfg, device)

    @property
    def device(self) -> torch.device:
        return self.tok_embed.device


@torch.no_grad()
def init_params(cfg: FalconConfig, seed: int = 0, device: DeviceLike = None) -> Falcon:
    """Random init on `device` from a seeded torch.Generator: truncated
    normal in [-2, 2] scaled by fan_in^-0.5 (the JAX init's distribution,
    not its numbers), LayerNorm scales 1, biases 0."""
    params = Falcon(cfg, device)
    gen = seeded_generator(seed, params.device)

    def dense(w: torch.Tensor, fan_in: int) -> None:
        tmp = torch.empty(w.shape, dtype=torch.float32, device=w.device)
        torch.nn.init.trunc_normal_(tmp, a=-2.0, b=2.0, generator=gen)
        w.copy_(tmp.mul_(fan_in**-0.5))

    D, H, hd, M = cfg.dim, cfg.n_heads, cfg.head_size, cfg.hidden_dim
    dense(params.tok_embed, D)
    for lp in params.layers:
        for name in ("wq", "wk", "wv", "fc1"):
            dense(getattr(lp, name), D)
        dense(lp.wo, H * hd)
        dense(lp.fc2, M)
        for norm in ("ln1", "ln2") if cfg.separate_ln else ("ln1",):
            getattr(lp, norm + "_scale").fill_(1.0)
            getattr(lp, norm + "_bias").zero_()
    params.final_ln_scale.fill_(1.0)
    params.final_ln_bias.zero_()
    return params


# The dense decode cache k/v [L, B, KH, S, hd] (KH = H for OPT, 1 on falcon-7b).
init_cache = llama.init_cache


def _block(
    x: torch.Tensor,  # [B, S, D]
    lp: FalconBlock,
    positions: torch.Tensor,  # [B, S]
    cfg: FalconConfig,
    layer_cache: Optional[Cache],
    kv_length: Optional[torch.Tensor] = None,
    lora_layer=None,
    lora_scale: float = 1.0,
) -> Tuple[torch.Tensor, Cache]:
    """One parallel block. Returns (x_out, kv): the fresh {k, v} without a
    cache (prefill), else the updated layer cache."""
    lora = lora_layer if lora_layer is not None else {}
    h_attn = layer_norm(x, lp.ln1_scale, lp.ln1_bias, cfg.norm_eps)
    h_mlp = layer_norm(x, lp.ln2_scale, lp.ln2_bias, cfg.norm_eps) if cfg.separate_ln else h_attn

    def proj(name: str, eq: str, lora_eq: str) -> torch.Tensor:
        out = project(eq, h_attn, getattr(lp, name), cfg)
        if name in lora:
            out = out + lora_delta(h_attn, lora[name], lora_scale, lora_eq)
        return out

    q = rope(proj("wq", "bsd,dhk->bshk", "bsr,rhk->bshk"), positions, cfg.rope_theta)
    kk = rope(proj("wk", "bsd,dhk->bshk", "bsr,rhk->bshk"), positions, cfg.rope_theta)
    vv = proj("wv", "bsd,dhk->bshk", "bsr,rhk->bshk")
    if layer_cache is None:
        attn = flash_attention(q, kk, vv, True)
        kv = {"k": kk, "v": vv}
    else:
        attn, kv = update_cache_and_attend(layer_cache, q, kk, vv, positions, kv_length=kv_length)
    attn_out = project("bshk,hkd->bsd", attn, lp.wo, cfg)
    if "wo" in lora:  # the adapter sees the flattened [B, S, H*hd]
        attn_out = attn_out + lora_delta(attn.flatten(2), lora["wo"], lora_scale, "bsr,rd->bsd")
    mlp_out = project("bsm,md->bsd", gelu(project("bsd,dm->bsm", h_mlp, lp.fc1, cfg)), lp.fc2, cfg)
    # Parallel block: one residual add for both sublayers.
    return x + attn_out + mlp_out, kv


def forward(
    params: Falcon,
    tokens: torch.Tensor,  # [B, S] integer ids
    cfg: FalconConfig,
    *,
    positions: Optional[torch.Tensor] = None,  # [B, S] absolute positions
    cache: Optional[Cache] = None,  # init_cache's (written in place)
    kv_length: Optional[torch.Tensor] = None,  # [B] valid cache prefix
    lora=None,  # {"layers": per-layer adapters (train/lora.py), "scale": alpha / rank}
    remat: bool = False,  # recompute each block in the backward
    train: bool = False,  # a training forward: no cache fragment
) -> Tuple[torch.Tensor, Cache]:
    """Returns (logits [B, S, vocab] float32, kv), as models/llama.py's
    forward: without a cache the fresh entries {k, v: [L, B, S, KH, hd]}
    ({} when train), with one the same (updated) cache dict."""
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = params.tok_embed[tokens.long()].to(cfg.dtype)
    x, kv = run_layers(_block, params, x, positions, cfg, cache, kv_length, lora, remat, train)
    x = layer_norm(x, params.final_ln_scale, params.final_ln_bias, cfg.norm_eps)
    return project("bsd,dv->bsv", x, params.tok_embed.t(), cfg).float(), kv  # tied head


def decode_step(params: Falcon, cache: Cache, tokens: torch.Tensor, positions: torch.Tensor,
                cfg: FalconConfig) -> Tuple[torch.Tensor, Cache]:
    """One decode step: logits [B, vocab]; the cache is updated in place."""
    logits, cache = forward(params, tokens[:, None], cfg, positions=positions[:, None], cache=cache)
    return logits[:, 0, :], cache
