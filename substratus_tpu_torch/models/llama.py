"""Llama model family (port of substratus_tpu/models/llama.py): dense
configurations and the Mixtral-style mixture of experts.

The weights keep the JAX package's einsum layouts (wq [D, H, hd], wo
[H, hd, D], w_gate [D, M], ...; with ``n_experts`` a dense router [D, E]
and experts w_gate/w_up [E, D, M], w_down [E, M, D]), one ``LlamaBlock``
per layer in an
``nn.ModuleList`` where the JAX tree stacks layers on a leading axis
(bridge.params_from_jax splits it). Dense projections and the lm_head are
plain ``torch.matmul``; a quantized one (``quantize_weights``: int8
``QTensor`` or int4 ``Q4Tensor``, chosen by ``quant_contracting``) goes
through ``ops.quant.qeinsum`` with the JAX equations, which runs the int4
kernel of ops/quant4.py, or, with ``quant_activations`` (w8a8), through
``qeinsum_w8a8``, as JAX's project, eproj and lm_head choose it: the
int8 activation and product kernels of ops/quant.py (wo stays
weight-only, as in JAX). Attention goes through the kernel wrappers:
``flash_attention`` for the no-cache prefill, and inside
update_cache_and_attend ``decode_attention`` or ``fused_decode_attention``
for decode steps and ``flash_cached_attention`` for the chunks of a long
prompt, chosen by ``attn_impl`` / ``decode_attn_impl`` /
``chunk_attn_impl``.

``_moe_ffn`` is the JAX package's routed FFN: the router in f32, a
softmax and top-k (ties to the lower expert, as lax.top_k), the Switch
load-balancing aux; serving runs every expert for every token and mixes
them by the renormalised top-k weights (exact, static shapes: the decode
step stays one CUDA graph), training the GShard capacity dispatch, which
drops the pairs past an expert's capacity. An int4 expert weight runs one
launch of the int4 kernel an expert (ops/quant4.py's expert route). The
gating is plain torch ops, as it is XLA ops in JAX: MoE adds no kernel.

``forward`` also trains: with ``lora`` it adds the adapters' low-rank
updates (ops/basics.py::lora_delta), with ``remat`` it recomputes each
block in the backward (torch.utils.checkpoint), and under autograd the
flash kernel's backward runs through ops/flash_attention.py's
FlashAttention. Serving calls it under torch.inference_mode().

The decode cache is the dense slot cache k/v [L, B, KH, S, hd] (+ f32
scales [L, B, KH, S] when int8), or, with a ``block_table``, the paged
pool k/v [L, P, bs, KH, hd] of ops/kvcache.py (+ f32 scales [..., 1]);
either is written in place. The paged read is the JAX package's: the
context gathered through the block table, then the plain attention of
ops/attention.py (no kernel reads pages, as none does in JAX).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from substratus_tpu_torch.ops import kvcache
from substratus_tpu_torch.ops.attention import dot_product_attention
from substratus_tpu_torch.ops.basics import lora_delta, lora_delta_indexed, rms_norm, rope, swiglu
from substratus_tpu_torch.ops.decode_attention import update_cache_and_attend
from substratus_tpu_torch.ops.flash_attention import flash_attention
from substratus_tpu_torch.ops.fused_decode import cache_layout
from substratus_tpu_torch.ops.quant import QTensor, _einsum, qeinsum, qeinsum_w8a8, quantize
from substratus_tpu_torch.ops.quant4 import Q4Tensor, quantize4
from substratus_tpu_torch.utils.device import DeviceLike, resolve_device, seeded_generator

Cache = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    hidden_dim: int = 11008
    head_dim: Optional[int] = None
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 4096
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    # No-cache (prefill) attention: "flash" = ops/flash_attention.py (the
    # CUDA kernel on the card), "plain" = ops/attention.py reference.
    attn_impl: str = "flash"
    # Single-token cached attention: "kernel" = ops/decode_attention.py's
    # CUDA kernel on the card, "plain" = its plain version, "fused" =
    # ops/fused_decode.py (the cache row write and the attention in one
    # kernel; opt-in, as in the JAX package).
    decode_attn_impl: str = "kernel"
    # Multi-token cached attention (chunked prefill): "flash" =
    # ops/flash_attention.py's cached kernel on the card, "plain" =
    # dequantize + ops/attention.py reference.
    chunk_attn_impl: str = "flash"
    # W8A8: quantize activations per token so the quantized projections
    # run as int8 x int8 products (ops/quant.py::qeinsum_w8a8, the two
    # w8a8 kernels on the card). Opt-in (serve.main's quantize: w8a8);
    # weight-only int8 (qeinsum) is the default quantized path.
    quant_activations: bool = False
    # Mixture-of-experts (Mixtral family): n_experts == 0 means the dense
    # MLP; else routed top-k (_moe_ffn), dropless when serving and with
    # GShard capacity dispatch when training. The trainer adds
    # router_aux_weight x the mean load-balancing aux to the loss.
    n_experts: int = 0
    n_experts_per_token: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    @property
    def head_size(self) -> int:
        return self.head_dim if self.head_dim is not None else self.dim // self.n_heads

    def replace(self, **kw) -> "LlamaConfig":
        return dataclasses.replace(self, **kw)


# Same shapes as the JAX package's CONFIGS.
CONFIGS: Dict[str, LlamaConfig] = {
    "tiny": LlamaConfig(
        vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
        hidden_dim=128, max_seq_len=128, norm_eps=1e-6,
    ),
    "debug-1b": LlamaConfig(
        vocab_size=32000, dim=2048, n_layers=16, n_heads=16, n_kv_heads=8,
        hidden_dim=5632, max_seq_len=2048,
    ),
    "llama2-7b": LlamaConfig(),
    "llama2-13b": LlamaConfig(dim=5120, n_layers=40, n_heads=40, n_kv_heads=40, hidden_dim=13824),
    "llama2-70b": LlamaConfig(dim=8192, n_layers=80, n_heads=64, n_kv_heads=8, hidden_dim=28672),
    "llama3-8b": LlamaConfig(
        vocab_size=128256, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        hidden_dim=14336, rope_theta=500000.0, max_seq_len=8192,
    ),
    "tinyllama-1.1b": LlamaConfig(
        vocab_size=32000, dim=2048, n_layers=22, n_heads=32, n_kv_heads=4,
        hidden_dim=5632, max_seq_len=2048,
    ),
    "tiny-moe": LlamaConfig(
        vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
        hidden_dim=128, max_seq_len=128, norm_eps=1e-6, n_experts=4,
    ),
    "mixtral-8x7b": LlamaConfig(
        vocab_size=32000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        hidden_dim=14336, rope_theta=1000000.0, max_seq_len=32768,
        n_experts=8, n_experts_per_token=2,
    ),
}


EXPERT_WEIGHTS = ("w_gate", "w_up", "w_down")  # [E, ...] under n_experts > 0


def quant_contracting(cfg: LlamaConfig) -> Dict:
    """Contracting dims per leaf for ops.quant.quantize_params (and
    quantize4_params); () = dense. Axes are for the JAX package's STACKED
    layer leaves (leading layer dim), e.g. wq [L, d, h, k] contracts d=1;
    the port's per-layer weights contract one axis lower
    (_layer_contracting). The scales come out per output channel; expert
    weights carry a leading expert dim, so they contract one axis later,
    and the router stays dense."""
    moe = cfg.n_experts > 0
    layers = {"attn_norm": (), "wq": (1,), "wk": (1,), "wv": (1,), "wo": (1, 2), "mlp_norm": (),
              **{name: (2,) if moe else (1,) for name in EXPERT_WEIGHTS}}
    if moe:
        layers["router"] = ()
    q = {"tok_embed": (), "layers": layers, "out_norm": ()}
    if not cfg.tie_embeddings:
        q["lm_head"] = (0,)
    return q


def _layer_contracting(cfg: LlamaConfig) -> Dict[str, Tuple[int, ...]]:
    """quant_contracting's layer entries for one LlamaBlock's weights."""
    return {name: tuple(c - 1 for c in axes) for name, axes in quant_contracting(cfg)["layers"].items()}


QUANTIZE_MODES = {"int8": (QTensor, quantize), "int4": (Q4Tensor, quantize4)}  # (storage, leaf quantizer)


def _check_quantize(quantize: str) -> None:
    if quantize != "none" and quantize not in QUANTIZE_MODES:
        raise ValueError(f"quantize={quantize!r} invalid (none|{'|'.join(QUANTIZE_MODES)})")


def _weight(shape, cfg: LlamaConfig, device: torch.device, quantize: str = "none", contracting=()):
    if quantize != "none" and contracting:
        return QUANTIZE_MODES[quantize][0].empty(shape, contracting, device)
    return nn.Parameter(torch.empty(shape, dtype=cfg.dtype, device=device), requires_grad=False)


class LlamaBlock(nn.Module):
    """One transformer block's weights, in the JAX einsum layouts."""

    def __init__(self, cfg: LlamaConfig, device: torch.device, quantize: str = "none"):
        super().__init__()
        D, H, KH, hd, M, E = cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_size, cfg.hidden_dim, cfg.n_experts
        shapes = {"attn_norm": (D,), "wq": (D, H, hd), "wk": (D, KH, hd), "wv": (D, KH, hd),
                  "wo": (H, hd, D), "mlp_norm": (D,)}
        if E > 0:
            shapes.update({"router": (D, E), "w_gate": (E, D, M), "w_up": (E, D, M), "w_down": (E, M, D)})
        else:
            shapes.update({"w_gate": (D, M), "w_up": (D, M), "w_down": (M, D)})
        contracting = _layer_contracting(cfg)
        for name, shape in shapes.items():
            setattr(self, name, _weight(shape, cfg, device, quantize, contracting[name]))


class Llama(nn.Module):
    """Parameter container (uninitialized; fill with init_params or
    load_state_dict). Call forward() / decode_step() to run it.
    quantize="int8"|"int4" lays out quantized storage for the weights
    quant_contracting names (to load a quantized state dict into)."""

    # A rank's tensor shard (shard_model) sets its parallel.sharding.TensorShard:
    # the forward then issues the tensor axis's collectives.
    tp = None

    def __init__(self, cfg: LlamaConfig, device: DeviceLike = None, quantize: str = "none"):
        super().__init__()
        _check_quantize(quantize)
        device = resolve_device(device)
        self.cfg = cfg
        self.tok_embed = _weight((cfg.vocab_size, cfg.dim), cfg, device)
        self.layers = nn.ModuleList(LlamaBlock(cfg, device, quantize) for _ in range(cfg.n_layers))
        self.out_norm = _weight((cfg.dim,), cfg, device)
        if not cfg.tie_embeddings:
            self.lm_head = _weight((cfg.dim, cfg.vocab_size), cfg, device, quantize, (0,))

    @property
    def device(self) -> torch.device:
        return self.tok_embed.device


@torch.no_grad()
def init_params(cfg: LlamaConfig, seed: int = 0, device: DeviceLike = None, quantize: str = "none") -> Llama:
    """Random init on `device` from a seeded torch.Generator: truncated
    normal in [-2, 2] scaled by fan_in^-0.5 (the JAX init's distribution,
    not its numbers), norms at 1. quantize="int8"|"int4" draws and
    quantizes one layer at a time (then the lm_head), so the peak is the
    quantized model plus one dense layer: mixtral-8x7b's 93 GB of bf16
    never stands on the card. The draws are the same in either case, so
    the result is quantize_weights(init_params(cfg, seed), quantize) bit
    for bit."""
    _check_quantize(quantize)
    params = Llama(cfg, device, quantize)
    device = params.device
    gen = seeded_generator(seed, device)

    def dense(w: torch.Tensor, fan_in: int) -> None:
        tmp = torch.empty(w.shape, dtype=torch.float32, device=w.device)
        torch.nn.init.trunc_normal_(tmp, a=-2.0, b=2.0, generator=gen)
        w.copy_(tmp.mul_(fan_in**-0.5))

    D, H, hd, M = cfg.dim, cfg.n_heads, cfg.head_size, cfg.hidden_dim
    dense(params.tok_embed, D)
    for i in range(cfg.n_layers):
        # Quantized storage is replaced by a dense block before the draw.
        lp = params.layers[i] if quantize == "none" else LlamaBlock(cfg, device)
        params.layers[i] = lp
        lp.attn_norm.fill_(1.0)
        lp.mlp_norm.fill_(1.0)
        dense(lp.wq, D)
        dense(lp.wk, D)
        dense(lp.wv, D)
        dense(lp.wo, H * hd)
        if cfg.n_experts > 0:
            dense(lp.router, D)
        dense(lp.w_gate, D)
        dense(lp.w_up, D)
        dense(lp.w_down, M)
        _quantize_module(lp, quantize, _layer_contracting(cfg), cfg)
    params.out_norm.fill_(1.0)
    if not cfg.tie_embeddings:
        if quantize != "none":
            delattr(params, "lm_head")
            params.lm_head = _weight((D, cfg.vocab_size), cfg, device)
        dense(params.lm_head, D)
        _quantize_module(params, quantize, {"lm_head": quant_contracting(cfg)["lm_head"]}, cfg)
    return params


def quantize_leaf(w: torch.Tensor, axes: Tuple[int, ...], quantize: str, experts: bool = False):
    """w quantized along `axes` as QUANTIZE_MODES[quantize]'s quantizer
    does; an expert weight [E, ...] (experts=True) one expert at a time
    into storage allocated once, so the f32 transients are one expert's
    (the bytes are the same: every scale is per expert)."""
    cls, qfn = QUANTIZE_MODES[quantize]
    if not experts:
        return qfn(w, axes)
    out = cls.empty(tuple(w.shape), axes, w.device)
    for e in range(w.shape[0]):
        part = qfn(w[e:e + 1], axes)
        for name, buf in part.named_buffers():
            getattr(out, name)[e:e + 1].copy_(buf)
        if isinstance(part, Q4Tensor):
            out.pack_axis, out.block = part.pack_axis, part.block
    return out


def _quantize_module(module: nn.Module, quantize: str, contracting: Dict[str, Tuple[int, ...]],
                     cfg: LlamaConfig) -> None:
    """Replace `module`'s dense weights named in `contracting` by their
    quantized form ("none" keeps them); the dense copies are freed on
    return."""
    if quantize == "none":
        return
    for name, axes in contracting.items():
        w = getattr(module, name)
        if not axes or isinstance(w, (QTensor, Q4Tensor)):
            continue
        q = quantize_leaf(w, axes, quantize, experts=cfg.n_experts > 0 and name in EXPERT_WEIGHTS)
        delattr(module, name)
        setattr(module, name, q)
        del w


@torch.no_grad()
def quantize_weights(params: Llama, quantize: str) -> Llama:
    """Turn an initialized Llama's weights into int8 QTensors or int4
    Q4Tensors in place ("none" keeps them dense), one layer at a time, so
    each layer's dense copy is freed before the next is quantized: no
    dense transient beside the quantized model. tok_embed, the norms and
    the router stay dense; quantized weights pass as they are."""
    _check_quantize(quantize)
    cfg = params.cfg
    for lp in params.layers:
        _quantize_module(lp, quantize, _layer_contracting(cfg), cfg)
    _quantize_module(params, quantize, {"lm_head": quant_contracting(cfg).get("lm_head", ())}, cfg)
    return params


def quantized_layout(params: Llama) -> Dict[str, str]:
    """{weight name: "int8" | "int4"} of the weights `params` holds
    quantized (a QLoRA model merges its adapted weights back to dense and
    keeps the rest int8)."""
    return {name: "int4" if isinstance(m, Q4Tensor) else "int8" for name, m in params.named_modules()
            if isinstance(m, (QTensor, Q4Tensor))}


def lay_out_quantized(params: Llama, layout: Dict[str, str]) -> Llama:
    """Replace the dense weights `layout` (a quantized_layout) names by
    uninitialized quantized storage, in place, so that a state dict saved
    from a model with that layout loads into `params`."""
    layer = _layer_contracting(params.cfg)
    for name, mode in layout.items():
        _check_quantize(mode)
        if name.startswith("layers."):
            _, i, attr = name.split(".")
            owner, contracting = params.layers[int(i)], layer[attr]
        else:
            owner, attr, contracting = params, name, quant_contracting(params.cfg)[name]
        dense = getattr(owner, attr)
        delattr(owner, attr)
        setattr(owner, attr, _weight(tuple(dense.shape), params.cfg, dense.device, mode, contracting))
    return params


def param_logical_axes(cfg: LlamaConfig) -> Dict:
    """Logical axis names of every weight (parallel/sharding.py), the JAX
    package's tree: layer leaves carry its stacked leading "layers" axis,
    which the port's per-layer tensors do not (sharding.shard_params drops
    it)."""
    layers = {
        "attn_norm": ("layers", "embed"),
        "wq": ("layers", "embed", "heads", "head_dim"),
        "wk": ("layers", "embed", "kv_heads", "head_dim"),
        "wv": ("layers", "embed", "kv_heads", "head_dim"),
        "wo": ("layers", "heads", "head_dim", "embed"),
        "mlp_norm": ("layers", "embed"),
    }
    if cfg.n_experts > 0:
        layers.update({"router": ("layers", "embed", None), "w_gate": ("layers", "expert", "embed", "mlp"),
                       "w_up": ("layers", "expert", "embed", "mlp"), "w_down": ("layers", "expert", "mlp", "embed")})
    else:
        layers.update({"w_gate": ("layers", "embed", "mlp"), "w_up": ("layers", "embed", "mlp"),
                       "w_down": ("layers", "mlp", "embed")})
    axes = {"tok_embed": ("vocab", "embed"), "layers": layers, "out_norm": ("embed",)}
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


def cache_logical_axes(cfg: LlamaConfig, quantized: bool = False) -> Dict:
    """Logical axes of init_cache's dense cache, the JAX package's."""
    ax = ("layers", "cache_batch", "kv_heads", "cache_seq", "head_dim")
    axes = {"k": ax, "v": ax}
    if quantized:
        axes["k_scale"] = ax[:-1]
        axes["v_scale"] = ax[:-1]
    return axes


def paged_cache_logical_axes(cfg: LlamaConfig, quantized: bool = False) -> Dict:
    """Logical axes of init_paged_cache's pool, the JAX package's: pages
    and page slots replicated (the block tables are every rank's), the kv
    heads over "tensor"."""
    ax = ("layers", None, None, "kv_heads", "head_dim")
    axes = {"k": ax, "v": ax}
    if quantized:
        axes["k_scale"] = ax
        axes["v_scale"] = ax
    return axes


def shard_config(cfg: LlamaConfig, tensor: int) -> LlamaConfig:
    """A rank's config under a tensor axis of `tensor`: its heads, kv heads
    and, where the axis divides them, its part of the MLP and the vocab
    (sharding.fit's rule: otherwise they stay whole), with the head dim
    pinned to the model's (n_heads / tensor would change dim // n_heads).
    Raises where the heads or kv heads do not divide: the JAX package
    replicates such a projection, a rank here would attend heads it does
    not hold."""
    if cfg.n_heads % tensor or cfg.n_kv_heads % tensor:
        raise ValueError(f"tensor={tensor} must divide the heads ({cfg.n_heads}) and kv heads ({cfg.n_kv_heads})")
    return cfg.replace(
        n_heads=cfg.n_heads // tensor, n_kv_heads=cfg.n_kv_heads // tensor, head_dim=cfg.head_size,
        hidden_dim=cfg.hidden_dim // tensor if cfg.hidden_dim % tensor == 0 else cfg.hidden_dim,
        vocab_size=cfg.vocab_size // tensor if cfg.vocab_size % tensor == 0 else cfg.vocab_size)


def down_kept_whole(cfg: LlamaConfig, tensor: int, quantize: str) -> bool:
    """Whether a rank of a tensor axis of `tensor` holds an int4 w_down
    whole (sharding.q4_row_parallel refuses its slices: llama2-7b's 11008
    rows at tensor=4 leave 2752 a rank, not whole groups of 128) while
    w_gate and w_up shard over the MLP."""
    M = cfg.hidden_dim
    if quantize != "int4" or tensor == 1 or M % tensor:
        return False
    from substratus_tpu_torch.ops.quant4 import _pack_block_for
    from substratus_tpu_torch.parallel.sharding import q4_row_parallel

    block = _pack_block_for(M)
    return not q4_row_parallel(M, M // block, block, tensor)


def tensor_shard(cfg: LlamaConfig, mesh, down_whole: bool = False):
    """The TensorShard of this rank of `mesh` for the model `cfg`."""
    from substratus_tpu_torch.parallel.sharding import TensorShard

    t = mesh.shape["tensor"]
    return TensorShard(mesh.group("tensor"), t, mesh.coords["tensor"], cfg.vocab_size,
                       vocab_sharded=cfg.vocab_size % t == 0, mlp_sharded=cfg.hidden_dim % t == 0,
                       down_whole=down_whole)


def load_shard(model: Llama, state: Dict, strict: bool = True):
    """load_state_dict of a rank's shard (sharding.shard_params's) into
    `model`, laid out by shard_config's config: an int4 weight the shard
    holds at another shape (whole, where q4_row_parallel refused its
    slices) gets storage of that shape first."""
    for name, value in state.items():
        owner_name, _, attr = name.rpartition(".")
        if attr not in ("packed", "scale") or not torch.is_tensor(value):
            continue
        try:
            owner = model.get_submodule(owner_name)
        except AttributeError:
            continue
        if isinstance(owner, Q4Tensor) and getattr(owner, attr).shape != value.shape:
            setattr(owner, attr, torch.empty(value.shape, dtype=value.dtype, device=getattr(owner, attr).device))
            owner._operands = None
    return model.load_state_dict(state, strict=strict)


@torch.no_grad()
def shard_model(params: Llama, mesh, rules=None) -> Llama:
    """This rank's tensor shard of a whole model (on any device): a Llama
    of shard_config's config on the same device, each weight sliced by
    parallel.sharding.shard_params (int8 and w8a8 weights keep the whole
    weight's scales; int4 weights are sliced in whole scale groups, or
    kept whole), its forward summing over the mesh's tensor group. A mesh
    with tensor == 1, or params already a shard, returns `params`
    itself."""
    from substratus_tpu_torch.parallel.sharding import SERVE_RULES, shard_params

    t = mesh.shape["tensor"]
    if t == 1 or params.tp is not None:
        return params
    cfg = params.cfg
    layout = quantized_layout(params)
    local = lay_out_quantized(Llama(shard_config(cfg, t), device=params.device), layout)
    load_shard(local, shard_params(params.state_dict(), param_logical_axes(cfg), mesh, rules or SERVE_RULES))
    local.tp = tensor_shard(cfg, mesh, down_kept_whole(cfg, t, layout.get("layers.0.w_down", "none")))
    return local


def init_cache(
    cfg: LlamaConfig,
    batch: int,
    max_len: Optional[int] = None,
    dtype: Optional[torch.dtype] = None,
    device: DeviceLike = None,
    padded: Optional[bool] = None,
) -> Cache:
    """Dense decode cache, layers-stacked: k/v [L, B, KH, S, hd]; with
    dtype=torch.int8, per-vector int8 entries plus f32 scales [L, B, KH, S].
    padded (default: on the card) lays it out as the kernels read it,
    ops/fused_decode.py::cache_layout: hd padded to a built head dim with
    zero columns, and S rounded up where the split design needs it; on the
    CPU it keeps the model's S and hd unless asked. Any family's config
    (OPT and Falcon build theirs here)."""
    device = resolve_device(device)
    S = max_len or cfg.max_seq_len
    dtype = dtype or cfg.dtype
    hd = cfg.head_size
    if padded if padded is not None else device.type == "cuda":
        S, hd = cache_layout(hd, S, dtype == torch.int8, cfg.n_heads // cfg.n_kv_heads)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, S, hd)
    cache = {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }
    if dtype == torch.int8:
        cache["k_scale"] = torch.ones(shape[:-1], dtype=torch.float32, device=device)
        cache["v_scale"] = torch.ones(shape[:-1], dtype=torch.float32, device=device)
    return cache


# The engine may serve this family on the paged pool (serve/paged_kv.py
# owns the allocator; ops/kvcache.py the device ops) and with an int8
# cache; the entry points may quantize its weights (quantize_weights,
# quantized_layout, lay_out_quantized); train/lora.py adapts its attention
# and MLP projections. OPT and Falcon have LoRA on attention alone, as in
# the JAX package. The engine and the entry points read these flags and
# nothing else to tell the families apart.
SUPPORTS_PAGED = True
SUPPORTS_INT8_KV = True
SUPPORTS_QUANTIZE = True
SUPPORTS_LORA = True
LORA_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
# forward() takes slot-stacked adapters and a per-row adapter_ids gather:
# multi-tenant adapter serving (serve/adapters.py). OPT and Falcon have no
# such flag, as in the JAX package.
SUPPORTS_INDEXED_LORA = True


def init_paged_cache(
    cfg: LlamaConfig,
    pages: int,
    page_size: int,
    dtype: Optional[torch.dtype] = None,
    device: DeviceLike = None,
) -> Cache:
    """Paged decode cache: a page pool k/v [L, P, bs, KH, hd] addressed
    through a block table per sequence (ops/kvcache.py); with
    dtype=torch.int8, int8 entries plus f32 scales [L, P, bs, KH, 1]."""
    dtype = dtype or cfg.dtype
    return kvcache.init_paged_cache(cfg.n_layers, pages, page_size, cfg.n_kv_heads, cfg.head_size, dtype,
                                    quantized=dtype == torch.int8, device=resolve_device(device))


def _self_attention(q, k, v, positions, cfg: LlamaConfig) -> torch.Tensor:
    """No-cache causal attention, per cfg.attn_impl. The flash kernel
    assumes standard positions (row r attends 0..r), which holds for full
    prefill."""
    if cfg.attn_impl == "flash":
        return flash_attention(q, k, v, True)
    if cfg.attn_impl == "plain":
        return dot_product_attention(q, k, v, causal=True, q_positions=positions)
    raise NotImplementedError(f"attn_impl={cfg.attn_impl!r} is not ported (flash|plain)")


def project(eq: str, x: torch.Tensor, w, cfg, tp=None) -> torch.Tensor:
    """einsum(eq, x, w) in the JAX package's layouts: a quantized weight
    through qeinsum (qeinsum_w8a8 under cfg.quant_activations), a dense one as one torch.matmul over the flattened
    contracted and kept dims, in cfg.dtype (any family's config; the OPT
    and Falcon modules project through it too). With `tp` (a TensorShard;
    w8a8 only) x's contracting dim is this rank's slice and the result is
    summed over the tensor group inside the product."""
    if isinstance(w, (QTensor, Q4Tensor)):
        if getattr(cfg, "quant_activations", False):
            return qeinsum_w8a8(eq, x, w, cfg.dtype, tp=tp)
        return qeinsum(eq, x, w, cfg.dtype)
    ins, out = eq.split("->")
    nc = sum(letter not in out for letter in ins.split(",")[0])
    y = torch.matmul(x.flatten(-nc), w.to(cfg.dtype).flatten(0, nc - 1).flatten(1))
    return y.reshape(*x.shape[:-nc], *w.shape[nc:])


def _block(
    x: torch.Tensor,  # [B, S, D]
    lp: LlamaBlock,
    positions: torch.Tensor,  # [B, S]
    cfg: LlamaConfig,
    layer_cache: Optional[Cache],
    kv_length: Optional[torch.Tensor] = None,
    lora_layer=None,  # this layer's adapters {name: {"a", "b"}}
    lora_scale: float = 1.0,
    block_table: Optional[torch.Tensor] = None,  # [B, M]: layer_cache is a page pool
    adapter_ids: Optional[torch.Tensor] = None,  # [B]: lora_layer is slot-stacked
    train: bool = False,  # MoE: capacity dispatch (train) vs exact dropless (serving)
    tp=None,  # a rank's TensorShard: wo's and w_down's partial outputs are summed over it
) -> Tuple[torch.Tensor, Cache]:
    """One transformer block. Returns (x_out, kv): the fresh {k, v}
    entries without a cache (prefill; with experts also this layer's
    "moe_aux"), else the updated layer cache. With adapter_ids the
    adapters carry a leading slot axis (serve/adapters.py) and every row
    gathers its own pair: one forward serves a mixed-tenant batch."""
    lora = lora_layer if lora_layer is not None else {}

    def delta(name: str, inp: torch.Tensor, lora_eq: str) -> torch.Tensor:
        if adapter_ids is not None:
            return lora_delta_indexed(inp, lora[name], lora_scale, lora_eq, adapter_ids)
        return lora_delta(inp, lora[name], lora_scale, lora_eq)

    def proj(name: str, inp: torch.Tensor, eq: str, lora_eq: str, row_tp=None) -> torch.Tensor:
        out = project(eq, inp, getattr(lp, name), cfg, row_tp)
        if name in lora:
            d = delta(name, inp, lora_eq)
            # A row-parallel product summed its partials inside itself; the
            # delta of this rank's input rows is a partial sum of its own.
            out = out + (row_tp.reduce(d) if row_tp is not None else d)
        return out

    h = rms_norm(x, lp.attn_norm, cfg.norm_eps)
    q = proj("wq", h, "bsd,dhk->bshk", "bsr,rhk->bshk")
    kk = proj("wk", h, "bsd,dhk->bshk", "bsr,rhk->bshk")
    vv = proj("wv", h, "bsd,dhk->bshk", "bsr,rhk->bshk")
    q = rope(q, positions, cfg.rope_theta)
    kk = rope(kk, positions, cfg.rope_theta)

    if layer_cache is None:
        attn = _self_attention(q, kk, vv, positions, cfg)
        kv = {"k": kk, "v": vv}
    elif block_table is not None:
        kv, k_ctx, v_ctx = kvcache.paged_update_and_read(layer_cache, block_table, positions, kk, vv, cfg.dtype)
        attn = dot_product_attention(q, k_ctx, v_ctx, causal=True, q_positions=positions, kv_length=kv_length)
    else:
        attn, kv = update_cache_and_attend(
            layer_cache, q, kk, vv, positions, kv_length=kv_length,
            impl=cfg.decode_attn_impl, chunk_impl=cfg.chunk_attn_impl,
        )
    o = project("bshk,hkd->bsd", attn, lp.wo, cfg)
    if "wo" in lora:  # the adapter sees the flattened [B, S, H*hd]
        o = o + delta("wo", attn.flatten(2), "bsr,rd->bsd")
    if tp is not None:  # this rank's heads: a partial sum over the tensor group
        o = tp.reduce(o)
    x = x + o
    h = rms_norm(x, lp.mlp_norm, cfg.norm_eps)
    # A row-parallel w8a8 w_down sums its s32 partials inside the product
    # (ops/quant.py); any other sharded w_down's output is summed here.
    row_w8a8 = tp is not None and tp.reduce_down and cfg.quant_activations and isinstance(lp.w_down, QTensor)
    row_tp = tp if row_w8a8 else None
    gather = tp.gather_mlp if tp is not None and tp.down_whole else None
    if cfg.n_experts > 0:
        y, aux = _moe_ffn(h, lp, cfg, train, lora, lora_scale, gather, row_tp)
        if tp is not None and tp.reduce_down and not row_w8a8:
            y = tp.reduce(y)
        if layer_cache is None:  # the prefill and training forwards report the aux
            kv = {**kv, "moe_aux": aux}
        return x + y, kv
    gate = proj("w_gate", h, "bsd,dm->bsm", "bsr,rm->bsm")
    up = proj("w_up", h, "bsd,dm->bsm", "bsr,rm->bsm")
    act = swiglu(gate, up)
    if gather is not None:  # an int4 w_down kept whole: the full MLP width in
        act = gather(act)
    y = proj("w_down", act, "bsm,md->bsd", "bsr,rd->bsd", row_tp)
    if tp is not None and tp.reduce_down and not row_w8a8:
        y = tp.reduce(y)
    return x + y, kv


def route(h: torch.Tensor, router: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(probs [B, S, E] f32, top_w [B, S, k] renormalised, top_idx [B, S,
    k]) of the router over post-norm h, in f32 as the JAX package routes.
    The top k by a stable descending sort: equal probabilities take the
    lower expert first, as lax.top_k orders them."""
    probs = torch.softmax(torch.matmul(h.float(), router.float()), dim=-1)
    top_w, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_idx = top_w[..., :k], top_idx[..., :k]
    return probs, top_w / top_w.sum(dim=-1, keepdim=True), top_idx


def _moe_ffn(
    h: torch.Tensor,  # [B, S, D] (post-norm)
    lp: LlamaBlock,
    cfg: LlamaConfig,
    train: bool,
    lora: Optional[Dict] = None,  # this layer's adapters; expert-routed pairs a [E, in, r], b [E, r, out]
    lora_scale: float = 1.0,
    gather=None,  # a rank's gather of the experts' MLP activation to full width (an int4 w_down kept whole)
    row_tp=None,  # a rank's TensorShard: a w8a8 w_down's s32 partials summed inside the product
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed top-k expert FFN (Mixtral), the JAX package's _moe_ffn:
    (output [B, S, D] in cfg.dtype, the Switch load-balancing aux, a f32
    scalar). train=False: exact dropless top-k, every expert over every
    token mixed by the routing weights (static shapes; decode streams
    every expert's weights whatever the routing). train=True: GShard
    capacity dispatch over the flattened (token, choice) pairs in JAX's
    order, the pairs past an expert's capacity dropped."""
    dt = cfg.dtype
    b, s, d = h.shape
    E, k = cfg.n_experts, cfg.n_experts_per_token
    lora = lora or {}
    qe = qeinsum_w8a8 if cfg.quant_activations else qeinsum

    def eproj(name: str, x: torch.Tensor, eq_w: str, eq_a: str, eq_b: str) -> torch.Tensor:
        if name == "w_down" and gather is not None:
            x = gather(x)
        w = getattr(lp, name)
        out = qeinsum_w8a8(eq_w, x, w, dt, tp=row_tp) if name == "w_down" and row_tp is not None else qe(eq_w, x, w, dt)
        if name in lora:
            down = _einsum(eq_a, x, lora[name]["a"].to(dt))
            d = _einsum(eq_b, down, lora[name]["b"].to(dt)) * lora_scale
            out = out + (row_tp.reduce(d) if name == "w_down" and row_tp is not None else d)
        return out

    probs, top_w, top_idx = route(h, lp.router, k)
    # Switch-style aux: the share of tokens whose first choice is each
    # expert times its mean router probability, scaled by E.
    assigned = torch.zeros_like(probs).scatter_(-1, top_idx[..., :1], 1.0)
    aux = (assigned.mean(dim=(0, 1)) * probs.mean(dim=(0, 1))).sum() * E

    if not train:
        w_full = torch.zeros_like(probs).scatter_(-1, top_idx, top_w)  # [B, S, E]
        gate = eproj("w_gate", h, "bsd,edm->bsem", "bsd,edr->bser", "bser,erm->bsem")
        up = eproj("w_up", h, "bsd,edm->bsem", "bsd,edr->bser", "bser,erm->bsem")
        out = eproj("w_down", swiglu(gate, up), "bsem,emd->bsed", "bsem,emr->bser", "bser,erd->bsed")
        return _einsum("bsed,bse->bsd", out, w_full.to(dt)).to(dt), aux

    t = s * k
    capacity = max(1, int(cfg.capacity_factor * s * k / E))
    flat = torch.zeros((b, s, k, E), dtype=torch.float32, device=h.device)
    flat = flat.scatter_(-1, top_idx[..., None], 1.0).reshape(b, t, E)  # (token, choice) pairs
    pos = torch.cumsum(flat, dim=1) - flat  # arrival order per expert
    keep = (pos < capacity).float() * flat  # [B, T, E]
    slots = torch.arange(capacity, device=h.device, dtype=pos.dtype)
    dispatch = keep[..., None] * (pos[..., None] == slots).float()  # [B, T, E, C]
    combine = dispatch * top_w.reshape(b, t)[..., None, None]
    h_rep = h.repeat_interleave(k, dim=1)  # [B, T, D], the pairs' order
    expert_in = _einsum("btec,btd->ebcd", dispatch.to(dt), h_rep)  # [E, B, C, D]
    gate = eproj("w_gate", expert_in, "ebcd,edm->ebcm", "ebcd,edr->ebcr", "ebcr,erm->ebcm")
    up = eproj("w_up", expert_in, "ebcd,edm->ebcm", "ebcd,edr->ebcr", "ebcr,erm->ebcm")
    out = eproj("w_down", swiglu(gate, up), "ebcm,emd->ebcd", "ebcm,emr->ebcr", "ebcr,erd->ebcd")
    y = _einsum("ebcd,btec->btd", out, combine.to(dt))  # [B, T, D]
    return y.reshape(b, s, k, d).sum(dim=2).to(dt), aux


def forward(
    params: Llama,
    tokens: torch.Tensor,  # [B, S] integer ids
    cfg: LlamaConfig,
    *,
    positions: Optional[torch.Tensor] = None,  # [B, S] absolute positions
    cache: Optional[Cache] = None,  # init_cache's, or init_paged_cache's with block_table (written in place)
    block_table: Optional[torch.Tensor] = None,  # [B, M] page ids: `cache` is the paged pool
    kv_length: Optional[torch.Tensor] = None,  # [B] valid cache prefix
    lora=None,  # {"layers": per-layer adapters (train/lora.py), "scale": alpha / rank}
    adapter_ids: Optional[torch.Tensor] = None,  # [B]: `lora` is an AdapterStore's slot-stacked tree
    remat: bool = False,  # recompute each block in the backward (training memory saver)
    train: bool = False,  # a training forward: no cache fragment; MoE's capacity dispatch
) -> Tuple[torch.Tensor, Cache]:
    """Returns (logits [B, S, vocab] float32, kv).

    Without cache (prefill): kv = fresh entries {k, v: [L, B, S, KH, hd]},
    the fragment the engine inserts into a slot cache; a training forward
    (train=True) returns no fragment (kv = {}), which nothing reads there.
    With experts, either also holds "moe_aux" [L], each layer's
    load-balancing aux (the trainer adds router_aux_weight x its mean;
    the engine ignores it), as the JAX forward returns it.
    With cache: tokens are written at `positions` and attention runs over
    the cache (with block_table, over each row's pages gathered through
    it); kv is the same (updated) cache dict. With adapter_ids, `lora`
    is serve/adapters.py's device tree (leaves [A, in, r], [A, r, *out])
    and row b adds the delta of slot adapter_ids[b] (slot 0: none).

    Autograd records the call unless the caller turns it off (serving runs
    it under torch.inference_mode()); gradients reach what requires them:
    the adapters in `lora`, or the weights the trainer unfroze."""
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    tp = params.tp
    if tp is None:
        x = params.tok_embed[tokens.long()].to(cfg.dtype)
    else:
        x = tp.embed(params.tok_embed, tokens.long(), cfg.dtype)
    x, kv = run_layers(_block, params, x, positions, cfg, cache, kv_length, lora, remat, train, block_table,
                       adapter_ids, train, tp)
    x = rms_norm(x, params.out_norm, cfg.norm_eps)
    head = params.tok_embed.t() if cfg.tie_embeddings else params.lm_head
    logits = project("bsd,dv->bsv", x, head, cfg).float()
    return (logits if tp is None else tp.gather_vocab(logits)), kv


def run_layers(block, params, x, positions, cfg, cache, kv_length, lora, remat: bool, train: bool, *extra):
    """The layer loop of every family's forward: block(x, lp, positions,
    cfg, layer_cache, kv_length, lora_layer, lora_scale, *extra) over
    params.layers, each with its slice of the stacked cache and its
    adapters, recomputed in the backward with remat. Returns (x, kv): the
    cache when given, {} when training, else the prefill fragment {k, v:
    [L, B, S, KH, hd]}; without a cache, the blocks' "moe_aux" stacked
    [L] beside (a mixture of experts' load-balancing aux)."""
    lora_layers = lora["layers"] if lora is not None else None
    lora_scale = lora["scale"] if lora is not None else 1.0
    fresh, aux = [], []
    for i, lp in enumerate(params.layers):
        layer_cache = None if cache is None else {name: t[i] for name, t in cache.items()}
        args = (x, lp, positions, cfg, layer_cache, kv_length,
                None if lora_layers is None else lora_layers[i], lora_scale, *extra)
        if remat:
            # The block draws no random numbers: no RNG state to stash.
            x, kv = checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False)
        else:
            x, kv = block(*args)
        if cache is None and "moe_aux" in kv:
            aux.append(kv["moe_aux"])
        if cache is None and not train:
            fresh.append(kv)
    if cache is not None:
        return x, cache
    out = {} if train else {name: torch.stack([kv[name] for kv in fresh]) for name in ("k", "v")}
    if aux:
        out["moe_aux"] = torch.stack(aux)
    return x, out


def decode_step(
    params: Llama,
    cache: Cache,
    tokens: torch.Tensor,  # [B] current token per row
    positions: torch.Tensor,  # [B] position to write/attend at
    cfg: LlamaConfig,
    block_table: Optional[torch.Tensor] = None,  # [B, M]: `cache` is the paged pool
    lora=None,  # an AdapterStore's device tree, with adapter_ids
    adapter_ids: Optional[torch.Tensor] = None,  # [B] each row's adapter slot
) -> Tuple[torch.Tensor, Cache]:
    """One decode step: logits [B, vocab] for the next token; the cache
    is updated in place (and returned, as the JAX function returns it)."""
    logits, cache = forward(params, tokens[:, None], cfg, positions=positions[:, None], cache=cache,
                            block_table=block_table, lora=lora, adapter_ids=adapter_ids)
    return logits[:, 0, :], cache
