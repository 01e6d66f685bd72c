"""Checkpoints and artifacts of the port's trainer, in a torch-native
format (the JAX package writes Orbax trees; substratus_tpu/train/
checkpoints.py):

* training checkpoints: ``CheckpointManager`` writes ``torch.save`` of
  {step, trainable, opt_state} every ``save_steps`` as
  ``{directory}/step_{step:08d}.pt``, atomically (a temporary file, then
  a rename), keeps the newest ``max_to_keep``, and ``restore_latest``
  resumes from the newest;
* model artifacts: ``save_artifact`` writes the model's state_dict
  (``params.pt``) beside the ``substratus.json`` sidecar (model config,
  family (llama, opt or falcon, models/registry.py), ``"format":
  "substratus-tpu-torch-v1"``, and for llama ``quantized``, the weights
  held int8 or int4, as after QLoRA); ``load_artifact`` rebuilds the
  family's module with that layout (an artifact without a family is
  llama's, as in the JAX package);
* adapter artifacts: ``save_adapter_artifact`` writes a LoRA adapter's
  state_dict (``adapters.pt``) and its sidecar (rank, alpha, targets).

Saves are synchronous: a step that saves waits for the file.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import torch

from torch import nn

from substratus_tpu_torch.models import registry
from substratus_tpu_torch.models.llama import lay_out_quantized, quantized_layout
from substratus_tpu_torch.utils.device import DeviceLike, resolve_device

META_FILE = "substratus.json"
FORMAT = "substratus-tpu-torch-v1"
ADAPTER_FORMAT = "substratus-tpu-torch-adapter-v1"
PARAMS_FILE = "params.pt"
ADAPTER_FILE = "adapters.pt"
_STEP_FILE = re.compile(r"step_(\d{8})\.pt$")


def _atomic_save(obj: Any, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)  # a reader sees the whole file or none


def _cfg_to_dict(cfg) -> Dict[str, Any]:
    d = dataclasses.asdict(cfg)
    d["dtype"] = str(cfg.dtype).removeprefix("torch.")
    # attn_impl and quant_activations (w8a8) are execution choices, not
    # architecture: never persisted.
    d.pop("attn_impl", None)
    d.pop("quant_activations", None)
    return d


def _cfg_from_dict(d: Dict[str, Any], family: str = "llama"):
    d = dict(d)
    d["dtype"] = getattr(torch, d.get("dtype", "bfloat16"))
    return registry.config_class(family)(**d)


def _write_meta(path: str, meta: Dict[str, Any], extra_meta: Optional[Dict[str, Any]]) -> None:
    meta.update(extra_meta or {})
    with open(os.path.join(path, META_FILE), "w") as f:
        json.dump(meta, f, indent=2)


def save_artifact(path: str, params: nn.Module, cfg, extra_meta: Optional[Dict[str, Any]] = None) -> None:
    """Write a model artifact: params.pt (the state_dict) and the
    substratus.json sidecar."""
    os.makedirs(path, exist_ok=True)
    _atomic_save(params.state_dict(), os.path.join(path, PARAMS_FILE))
    meta = {"model_config": _cfg_to_dict(cfg), "family": registry.family_of(cfg), "format": FORMAT}
    layout = quantized_layout(params) if getattr(registry.module_of(cfg), "SUPPORTS_QUANTIZE", False) else {}
    if layout:
        meta["quantized"] = layout
    _write_meta(path, meta, extra_meta)


def load_artifact(path: str, device: DeviceLike = None) -> Tuple[Any, nn.Module]:
    """(cfg, model) of a save_artifact directory, on `device` (cuda unless
    the caller asks for the CPU), built by the family the sidecar names."""
    with open(os.path.join(path, META_FILE)) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path}: format {meta.get('format')!r} is not {FORMAT!r}")
    family = meta.get("family", "llama")
    cfg = _cfg_from_dict(meta["model_config"], family)
    model = registry.MODEL_CLASSES[family](cfg, device=resolve_device(device))
    if meta.get("quantized"):
        model = lay_out_quantized(model, meta["quantized"])
    # Memory-mapped on the host, copied tensor by tensor into the model:
    # no second device copy of the weights.
    state = torch.load(os.path.join(path, PARAMS_FILE), map_location="cpu", mmap=True, weights_only=True)
    model.load_state_dict(state)
    return cfg, model


def save_adapter_artifact(path: str, adapters: torch.nn.Module, alpha: float, rank: int,
                          extra_meta: Optional[Dict[str, Any]] = None) -> None:
    """Write a LoRA adapter artifact: adapters.pt (the LoraAdapters
    state_dict) and a sidecar with its rank, alpha and targets."""
    os.makedirs(path, exist_ok=True)
    _atomic_save(adapters.state_dict(), os.path.join(path, ADAPTER_FILE))
    _write_meta(path, {"format": ADAPTER_FORMAT,
                       "lora": {"rank": int(rank), "alpha": float(alpha), "targets": adapters.targets}}, extra_meta)


class CheckpointManager:
    """Training checkpoints with resume-latest semantics."""

    def __init__(self, directory: str, save_steps: int = 100, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.save_steps = max(1, save_steps)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self):
        """Saved steps, oldest first."""
        found = (_STEP_FILE.match(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.pt")

    def maybe_save(self, step: int, state: Dict[str, Any], force: bool = False) -> bool:
        """Save {"step", **state} when `step` is a multiple of save_steps
        (or `force`); drop the oldest beyond max_to_keep. True if saved."""
        if not (force or step % self.save_steps == 0):
            return False
        _atomic_save({"step": step, **state}, self._path(step))
        for old in self.steps()[: -self.max_to_keep]:
            os.remove(self._path(old))
        return True

    def restore_latest(self, map_location=None) -> Optional[Tuple[int, Dict[str, Any]]]:
        """(step, state) of the newest checkpoint, or None."""
        steps = self.steps()
        if not steps:
            return None
        state = torch.load(self._path(steps[-1]), map_location=map_location, weights_only=True)
        return int(state.pop("step")), state

    def close(self) -> None:
        """Nothing to wait for: every save completed inside maybe_save."""
