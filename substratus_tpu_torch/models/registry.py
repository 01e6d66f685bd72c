"""Model-family registry (port of substratus_tpu/models/registry.py).
Only the llama family is ported; opt and falcon wait in ROADMAP Queue 1."""
from __future__ import annotations

from typing import Any, Tuple

from substratus_tpu_torch.models import llama

FAMILIES = {"llama": llama}


def family_of(cfg: Any) -> str:
    if isinstance(cfg, llama.LlamaConfig):
        return "llama"
    raise TypeError(f"unknown model config type {type(cfg)!r}")


def module_of(cfg: Any):
    return FAMILIES[family_of(cfg)]


def find_named_config(name: str) -> Tuple[Any, Any]:
    """Named smoke/test config -> (family_module, config)."""
    for fam in FAMILIES.values():
        if name in fam.CONFIGS:
            return fam, fam.CONFIGS[name]
    known = sorted(cfg for fam in FAMILIES.values() for cfg in fam.CONFIGS)
    raise KeyError(f"unknown model config {name!r} (known: {known})")
