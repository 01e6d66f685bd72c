"""HuggingFace checkpoint import (port of substratus_tpu/load/hf.py): a
local Llama-family directory (``config.json`` beside safetensors or torch
``.bin`` files) loaded into a ``Llama`` on its device.

safetensors are read by a parser of the format written here (the card's
machine has no ``safetensors`` package): an 8-byte little-endian header
length, a JSON header of ``dtype`` / ``shape`` / ``data_offsets`` per
tensor (plus ``__metadata__``), then the raw bytes. The data is
memory-mapped: BF16 (as uint16, viewed as torch.bfloat16), F16 and F32
tensors wrap the map without a second host copy. ``.bin`` files go
through ``torch.load(..., mmap=True, weights_only=True)``.

``copy_hf_state`` does convert_llama_state_dict's transforms one tensor
at a time: each HF tensor goes to the model's device, is transposed there
into the port's einsum layout (HF Linear [out, in] -> [in, ...out]) and
copied into the allocated model, rounding to its dtype (as the JAX
converter's asarray does). The JAX loader's hub fallback is not ported:
the port loads local checkpoints only.
"""
from __future__ import annotations

import json
import os
import struct
from types import SimpleNamespace
from typing import Any, Dict, Iterable, Tuple

import numpy as np
import torch

from substratus_tpu_torch.models.llama import Llama, LlamaConfig
from substratus_tpu_torch.utils.device import DeviceLike, resolve_device

# transformers model_type -> family (the JAX registry's HF_MODEL_TYPES);
# the port has the llama family only.
HF_MODEL_TYPES = {"llama": "llama", "mistral": "llama", "mixtral": "llama", "opt": "opt", "falcon": "falcon"}
OTHER_FAMILIES = "ROADMAP Queue 1, other families (MoE, OPT, Falcon)"


def config_from_hf(hf_cfg: Any, dtype: torch.dtype = torch.bfloat16) -> LlamaConfig:
    """Map a transformers Llama/Mistral config (or a namespace of its
    config.json) to LlamaConfig; a mixture-of-experts config exits (the
    port has no MoE)."""
    get = lambda name, default=None: getattr(hf_cfg, name, default)  # noqa: E731
    if get("num_local_experts"):
        raise SystemExit(f"HF config with num_local_experts={get('num_local_experts')} (mixture of experts) is not "
                         f"served by the PyTorch port yet: {OTHER_FAMILIES}")
    return LlamaConfig(
        vocab_size=hf_cfg.vocab_size,
        dim=hf_cfg.hidden_size,
        n_layers=hf_cfg.num_hidden_layers,
        n_heads=hf_cfg.num_attention_heads,
        n_kv_heads=get("num_key_value_heads") or hf_cfg.num_attention_heads,
        hidden_dim=hf_cfg.intermediate_size,
        head_dim=get("head_dim"),
        rope_theta=get("rope_theta", 10000.0),
        norm_eps=get("rms_norm_eps", 1e-5),
        max_seq_len=get("max_position_embeddings", 4096),
        tie_embeddings=bool(get("tie_word_embeddings", False)),
        dtype=dtype,
    )


# HF llama names (without the "model." prefix) -> the port's; True where
# the HF tensor is a Linear weight [out, in], stored transposed.
HF_TOP = {"embed_tokens.weight": ("tok_embed", False), "norm.weight": ("out_norm", False),
          "lm_head.weight": ("lm_head", True)}
HF_LAYER = {
    "input_layernorm.weight": ("attn_norm", False),
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.o_proj.weight": ("wo", True),
    "post_attention_layernorm.weight": ("mlp_norm", False),
    "mlp.gate_proj.weight": ("w_gate", True),
    "mlp.up_proj.weight": ("w_up", True),
    "mlp.down_proj.weight": ("w_down", True),
}


def port_name(hf_name: str) -> Tuple[str, bool] | None:
    """(the port's state_dict name, whether the HF tensor is transposed
    into it) of an HF llama tensor name; None for a tensor the model does
    not hold (rotary tables and the like)."""
    name = hf_name.removeprefix("model.")
    if name in HF_TOP:
        return HF_TOP[name]
    parts = name.split(".", 2)
    if len(parts) == 3 and parts[0] == "layers" and parts[2] in HF_LAYER:
        port, transposed = HF_LAYER[parts[2]]
        return f"layers.{parts[1]}.{port}", transposed
    return None


@torch.no_grad()
def copy_hf_state(model: Llama, items: Iterable[Tuple[str, torch.Tensor]]) -> None:
    """Copy (HF name, tensor) pairs into `model`, each as it comes: moved
    to the model's device, transposed there into the port's layout, and
    rounded to the model's dtype. Raises KeyError naming every weight of
    the model that no item filled."""
    state = model.state_dict(keep_vars=True)
    filled = set()
    for hf_name, w in items:
        found = port_name(hf_name)
        if found is None or found[0] not in state:
            continue
        name, transposed = found
        target = state[name]
        if target.numel() != w.numel():
            raise ValueError(f"{hf_name}: shape {tuple(w.shape)} does not fit {name} {tuple(target.shape)}")
        w = w.to(target.device)
        if transposed:
            target.view(w.shape[1], w.shape[0]).copy_(w.t())
        else:
            target.copy_(w.view(target.shape))
        filled.add(name)
    missing = sorted(set(state) - filled)
    if missing:
        raise KeyError(f"the checkpoint has no tensor for {missing}")


# safetensors dtypes the port reads -> (numpy dtype of the bytes, torch view)
_ST_DTYPES = {"BF16": (np.uint16, torch.bfloat16), "F16": (np.float16, None), "F32": (np.float32, None)}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """{name: tensor} of one .safetensors file, each tensor a view of a
    memory map of the file (copied only when its bytes are not aligned to
    its element size). Refuses any dtype but BF16, F16 and F32 by name."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    mm = np.memmap(path, dtype=np.uint8, mode="c")  # copy-on-write: torch may wrap it, nothing writes it
    out = {}
    for name, info in header.items():
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}; the port reads BF16, F16 and F32 "
                             "safetensors")
        np_dtype, view = _ST_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        offset = 8 + n + start
        count = (end - start) // np.dtype(np_dtype).itemsize
        t = torch.from_numpy(np.frombuffer(mm, dtype=np_dtype, count=count, offset=offset))
        if offset % np.dtype(np_dtype).itemsize:
            t = t.clone()
        out[name] = (t.view(view) if view is not None else t).reshape(info["shape"])
    return out


def _state_items(path: str) -> Iterable[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every tensor of a checkpoint directory: its
    .safetensors files in sorted order, else its .bin files."""
    names = sorted(os.listdir(path))
    st_files = [f for f in names if f.endswith(".safetensors")]
    for fname in st_files:
        yield from read_safetensors(os.path.join(path, fname)).items()
    if not st_files:
        for fname in names:
            if fname.endswith(".bin"):
                yield from torch.load(os.path.join(path, fname), map_location="cpu", weights_only=True,
                                      mmap=True).items()


def is_hf_dir(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(os.path.join(path, "config.json"))


def load_pretrained(path: str, dtype: torch.dtype = torch.bfloat16,
                    device: DeviceLike = None) -> Tuple[LlamaConfig, Llama]:
    """A local HF Llama-family directory -> (LlamaConfig, Llama on
    `device`), cuda unless the caller asks for the CPU. Exits for any other
    path (the port reads no hub), for the families it has not ported and
    for mixture-of-experts configs."""
    if not is_hf_dir(path):
        raise SystemExit(f"{path}: not a local checkpoint; the PyTorch port loads local checkpoints only (a "
                         "directory with config.json, a .gguf file or a port artifact), with no download")
    device = resolve_device(device)
    with open(os.path.join(path, "config.json")) as f:
        raw = json.load(f)
    model_type = raw.get("model_type", "llama")
    family = HF_MODEL_TYPES.get(model_type)
    if family is None:
        raise SystemExit(f"{path}: unsupported HF model_type {model_type!r} (supported: {sorted(HF_MODEL_TYPES)})")
    if family != "llama":
        raise SystemExit(f"{path}: HF model_type {model_type!r} is not served by the PyTorch port yet: "
                         f"{OTHER_FAMILIES}")
    cfg = config_from_hf(SimpleNamespace(**raw), dtype)
    model = Llama(cfg, device=device)
    copy_hf_state(model, _state_items(path))
    return cfg, model
