"""Model-family registry (port of substratus_tpu/models/registry.py): the one
dispatch point for the families the port serves and trains.

Every family is a module with the engine's and trainer's protocol
(CONFIGS / init_params / init_cache / forward / decode_step); serving,
loading, checkpoint and training code looks a family up here. What a
family can do beyond that protocol it says by flags: SUPPORTS_LORA and
LORA_TARGETS on every family; SUPPORTS_PAGED, SUPPORTS_INT8_KV and
SUPPORTS_QUANTIZE on llama alone. The engine and the entry points read
them by getattr(..., False), as the JAX package reads its flags.
"""
from __future__ import annotations

from typing import Any, Tuple

from substratus_tpu_torch.models import falcon, llama, opt

FAMILIES = {
    "llama": llama,  # Llama 2/3, Mistral, TinyLlama (dense)
    "opt": opt,  # facebook/opt-*
    "falcon": falcon,  # falcon-7b[-instruct], falcon-40b
}

# transformers `model_type` -> family name (HF checkpoint dispatch).
HF_MODEL_TYPES = {"llama": "llama", "mistral": "llama", "mixtral": "llama", "opt": "opt", "falcon": "falcon"}

_CONFIG_CLASS_TO_FAMILY = {llama.LlamaConfig: "llama", opt.OPTConfig: "opt", falcon.FalconConfig: "falcon"}

# Each family's parameter container (an nn.Module built from its config).
MODEL_CLASSES = {"llama": llama.Llama, "opt": opt.OPT, "falcon": falcon.Falcon}


def family_of(cfg: Any) -> str:
    for cls, name in _CONFIG_CLASS_TO_FAMILY.items():
        if isinstance(cfg, cls):
            return name
    raise TypeError(f"unknown model config type {type(cfg)!r}")


def module_of(cfg: Any):
    return FAMILIES[family_of(cfg)]


def config_class(name: str):
    return {v: k for k, v in _CONFIG_CLASS_TO_FAMILY.items()}[name]


def module_for(name: str):
    if name not in FAMILIES:
        raise KeyError(f"unknown model family {name!r} (known: {sorted(FAMILIES)})")
    return FAMILIES[name]


def find_named_config(name: str) -> Tuple[Any, Any]:
    """Named smoke/test config -> (family_module, config)."""
    for fam in FAMILIES.values():
        if name in fam.CONFIGS:
            return fam, fam.CONFIGS[name]
    known = sorted(cfg for fam in FAMILIES.values() for cfg in fam.CONFIGS)
    raise KeyError(f"unknown model config {name!r} (known: {known})")
