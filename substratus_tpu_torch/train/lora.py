"""LoRA adapters (port of substratus_tpu/train/lora.py) for every family:
llama's attention and MLP projections, OPT's and Falcon's attention
projections (wq, wk, wv, wo; Falcon's wk/wv are [D, KH, hd], KH = 1 on
falcon-7b), which are all their forwards adapt.

The JAX package stacks every layer's adapter on a leading L axis
({name: {a: [L, in, r], b: [L, r, *out]}}); the port keeps one entry per
layer, beside the family's per-layer blocks, as the parameters of
``LoraAdapters``: ``adapters.layers[i][name]["a"]`` is [in, r] and
``["b"]`` is [r, *out]. Under a mixture of experts (llama with
``n_experts``) the MLP's adapters are expert-routed, as in the JAX
package: each expert its own pair, a [E, in, r] and b [E, r, out],
applied inside models/llama.py::_moe_ffn. Each family's forward takes
``{"layers": adapters.layers, "scale": alpha / rank}``.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Tuple

import torch
from torch import nn

from substratus_tpu_torch.models import registry
from substratus_tpu_torch.models.llama import EXPERT_WEIGHTS
from substratus_tpu_torch.ops.quant import QTensor
from substratus_tpu_torch.ops.quant4 import Q4Tensor
from substratus_tpu_torch.utils.device import DeviceLike, resolve_device, seeded_generator

# Which projections get adapters (the HF PEFT default for Llama is q, v).
DEFAULT_TARGETS = ("wq", "wv")


def _shapes(cfg) -> Dict[str, Tuple[int, Tuple[int, ...]]]:
    """name -> (in_dim, out_shape) of each projection the config's family
    adapts (its LORA_TARGETS: the MLP's only on llama)."""
    hd = cfg.head_size
    shapes = {
        "wq": (cfg.dim, (cfg.n_heads, hd)),
        "wk": (cfg.dim, (cfg.n_kv_heads, hd)),
        "wv": (cfg.dim, (cfg.n_kv_heads, hd)),
        "wo": (cfg.n_heads * hd, (cfg.dim,)),
        "w_gate": (cfg.dim, (cfg.hidden_dim,)),
        "w_up": (cfg.dim, (cfg.hidden_dim,)),
        "w_down": (cfg.hidden_dim, (cfg.dim,)),
    }
    return {name: shapes[name] for name in registry.module_of(cfg).LORA_TARGETS}


class LoraAdapters(nn.Module):
    """Per-layer adapters as parameters: ``layers[i][name]`` is a
    ParameterDict {"a": [in, r], "b": [r, *out]}; state_dict keys are
    ``layers.{i}.{name}.{a|b}``."""

    def __init__(self, layers: List[Dict[str, Dict[str, torch.Tensor]]]):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.ModuleDict({name: nn.ParameterDict({k: nn.Parameter(t) for k, t in ab.items()})
                           for name, ab in layer.items()})
            for layer in layers
        )

    @property
    def targets(self) -> List[str]:
        return sorted(self.layers[0]) if len(self.layers) else []


def init_lora(
    cfg,
    seed: int = 0,
    rank: int = 8,
    targets: Tuple[str, ...] = DEFAULT_TARGETS,
    dtype: torch.dtype = torch.bfloat16,
    device: DeviceLike = None,
) -> LoraAdapters:
    """A gaussian times 1/rank (drawn in f32 from a seeded torch.Generator,
    then cast), B zero: training starts from the base model. The adapters
    are bf16 by default whatever the model's dtype, as in the JAX package;
    an expert-routed target (the MLP under n_experts) gets a pair an
    expert, a [E, in, r] and b [E, r, out]."""
    device = resolve_device(device)
    gen = seeded_generator(seed, device)
    shapes = _shapes(cfg)
    unknown = [name for name in targets if name not in shapes]
    if unknown:
        raise ValueError(f"unknown LoRA targets {unknown} for the {registry.family_of(cfg)} family (one of "
                         f"{sorted(shapes)})")
    n_experts = getattr(cfg, "n_experts", 0)
    layers: List[Dict[str, Dict[str, torch.Tensor]]] = [{} for _ in range(cfg.n_layers)]
    for name in targets:
        in_dim, out_shape = shapes[name]
        experts = (n_experts,) if n_experts > 0 and name in EXPERT_WEIGHTS else ()
        a = torch.randn((cfg.n_layers, *experts, in_dim, rank), generator=gen, device=device) * (1.0 / rank)
        for i, layer in enumerate(layers):
            layer[name] = {"a": a[i].to(dtype),
                           "b": torch.zeros((*experts, rank) + out_shape, dtype=dtype, device=device)}
    return LoraAdapters(layers)


@torch.no_grad()
def merge_lora(params: nn.Module, adapters: LoraAdapters, scale: float) -> nn.Module:
    """A model to save or serve without adapters: the base weights plus
    scale * A @ B (in f32, then rounded to W's dtype), one layer at a time.
    A quantized base weight (QLoRA) is dequantized in f32 first and the
    merged weight is dense bf16, as in the JAX package; the weights
    without adapters stay quantized. `params` is left as it is, as the JAX
    package's merge returns a new tree: the merged model holds new tensors
    for the adapted weights and shares every other one with `params`."""
    skip = {id(getattr(lp, name)) for lp, layer in zip(params.layers, adapters.layers) for name in layer}
    shared = [t for t in (*params.parameters(), *params.buffers()) if id(t) not in skip]
    merged = copy.deepcopy(params, {id(t): t for t in shared})
    for lp, layer in zip(merged.layers, adapters.layers):
        for name, ab in layer.items():
            w = getattr(lp, name)
            quantized = isinstance(w, (QTensor, Q4Tensor))
            base = w.dequant(torch.float32) if quantized else w.float()
            eq = "edr,er...->ed..." if ab["a"].ndim == 3 else "dr,r...->d..."  # expert-routed: a pair an expert
            delta = torch.einsum(eq, ab["a"].float(), ab["b"].float()) * scale
            # wo's adapter input is the flattened [H*hd]: reshape to [H, hd, D].
            out = (base + delta.reshape(base.shape)).to(torch.bfloat16 if quantized else w.dtype)
            if quantized:
                delattr(lp, name)
                setattr(lp, name, nn.Parameter(out, requires_grad=False))
            else:
                w.copy_(out)
    return merged
