"""Carry weights from the JAX package's parameter tree into the port.

``params_from_jax`` is the one function that does so: it takes the llama
params pytree with numpy (or numpy-convertible) leaves -- per-layer
weights stacked on a leading L axis -- and returns the port's
``state_dict`` for ``models.llama.Llama.load_state_dict``. It needs no
JAX: leaves go through ``numpy.asarray``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _tensor(leaf: Any) -> torch.Tensor:
    if hasattr(leaf, "scale") and hasattr(leaf, "q"):
        raise NotImplementedError("quantized (QTensor) weights are not ported yet: ROADMAP Queue 1")
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        # torch.from_numpy rejects ml_dtypes' bfloat16; f32 holds it exactly.
        arr = arr.astype(np.float32)
    # A copy: device_get hands out read-only buffers, which torch must not share.
    return torch.from_numpy(np.array(arr))


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX llama params {tok_embed, layers: {name: [L, ...]}, out_norm[,
    lm_head]} -> {"tok_embed", "layers.{i}.{name}", "out_norm"[, "lm_head"]}."""
    state = {name: _tensor(tree[name]) for name in ("tok_embed", "out_norm", "lm_head") if name in tree}
    for name, stacked in tree["layers"].items():
        per_layer = _tensor(stacked)
        for i in range(per_layer.shape[0]):
            state[f"layers.{i}.{name}"] = per_layer[i]
    return state
