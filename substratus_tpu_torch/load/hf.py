"""HuggingFace checkpoint import (port of substratus_tpu/load/hf.py): a
local directory (``config.json`` beside safetensors or torch ``.bin``
files) of a Llama-family (llama, mistral), OPT or Falcon model loaded into
the family's module (models/registry.py) on its device.

safetensors are read by a parser of the format written here (the card's
machine has no ``safetensors`` package): an 8-byte little-endian header
length, a JSON header of ``dtype`` / ``shape`` / ``data_offsets`` per
tensor (plus ``__metadata__``), then the raw bytes. The data is
memory-mapped: BF16 (as uint16, viewed as torch.bfloat16), F16 and F32
tensors wrap the map without a second host copy. ``.bin`` files go
through ``torch.load(..., mmap=True, weights_only=True)``.

``copy_hf_state`` does the JAX converters' transforms
(convert_llama_state_dict, convert_opt_state_dict,
convert_falcon_state_dict) one tensor at a time: each HF tensor goes to
the model's device, is transposed there into the port's einsum layout (HF
Linear [out, in] -> [in, ...out]; Falcon's fused query_key_value split per
kv group into [G q | k | v]) and copied into the allocated model, rounding
to its dtype (as the JAX converter's asarray does). The refusals of
config_from_hf_opt and config_from_hf_falcon exit with the JAX messages.
The JAX loader's hub fallback is not ported: the port loads local
checkpoints only.
"""
from __future__ import annotations

import json
import os
import struct
from types import SimpleNamespace
from typing import Any, Dict, Iterable, Tuple

import numpy as np
import torch

from torch import nn

from substratus_tpu_torch.models import registry
from substratus_tpu_torch.models.falcon import FalconConfig
from substratus_tpu_torch.models.llama import LlamaConfig
from substratus_tpu_torch.models.opt import OPTConfig
from substratus_tpu_torch.utils.device import DeviceLike, resolve_device

OTHER_FAMILIES = "ROADMAP Queue 1, other families (MoE)"


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


def config_from_hf_opt(hf_cfg: Any, dtype: torch.dtype = torch.bfloat16) -> OPTConfig:
    """Map a transformers OPT config (or a namespace of its config.json) to
    OPTConfig; exits on the variants models/opt.py does not implement."""
    # Rather than convert to silently wrong logits (opt-350m is post-LN with
    # a projected embedding dim).
    if not getattr(hf_cfg, "do_layer_norm_before", True):
        raise SystemExit("post-LN OPT variants (do_layer_norm_before=false, e.g. opt-350m) are not supported")
    act = getattr(hf_cfg, "activation_function", "relu")
    if act != "relu":
        raise SystemExit(f"OPT activation {act!r} not supported (e.g. Galactica uses gelu); models/opt.py "
                         "implements relu")
    proj = getattr(hf_cfg, "word_embed_proj_dim", hf_cfg.hidden_size)
    if proj != hf_cfg.hidden_size:
        raise SystemExit(f"OPT word_embed_proj_dim={proj} != hidden_size={hf_cfg.hidden_size} (embedding "
                         "projection) is not supported")
    return OPTConfig(vocab_size=hf_cfg.vocab_size, dim=hf_cfg.hidden_size, n_layers=hf_cfg.num_hidden_layers,
                     n_heads=hf_cfg.num_attention_heads, hidden_dim=hf_cfg.ffn_dim,
                     max_seq_len=hf_cfg.max_position_embeddings, dtype=dtype)


def config_from_hf_falcon(hf_cfg: Any, dtype: torch.dtype = torch.bfloat16) -> FalconConfig:
    """Map a transformers Falcon config (or a namespace of its config.json)
    to FalconConfig; exits on the variants models/falcon.py does not
    implement."""
    get = lambda name, default=None: getattr(hf_cfg, name, default)  # noqa: E731
    if not get("parallel_attn", True):
        raise SystemExit("non-parallel Falcon blocks not supported")
    if get("alibi", False):
        raise SystemExit("Falcon alibi positioning not supported")
    if get("bias", False):
        raise SystemExit("biased Falcon projections not supported")
    if not get("tie_word_embeddings", True):
        raise SystemExit("untied Falcon LM heads not supported (forward scores against the tied token embedding)")
    new_arch = bool(get("new_decoder_architecture", False))
    if new_arch:
        kv = get("num_kv_heads") or hf_cfg.num_attention_heads
    elif get("multi_query", True):
        kv = 1
    else:
        kv = hf_cfg.num_attention_heads
    return FalconConfig(vocab_size=hf_cfg.vocab_size, dim=hf_cfg.hidden_size, n_layers=hf_cfg.num_hidden_layers,
                        n_heads=hf_cfg.num_attention_heads, n_kv_heads=kv, rope_theta=get("rope_theta", 10000.0),
                        norm_eps=get("layer_norm_epsilon", 1e-5), max_seq_len=get("max_position_embeddings", 2048),
                        separate_ln=new_arch, dtype=dtype)


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


# HF OPT names (without "model.decoder." or "decoder."): the decoder's
# final_layer_norm is the final norm, a layer's is its pre-MLP norm (ln2).
# The lm_head is tied to embed_tokens.
OPT_TOP = {"embed_tokens.weight": ("tok_embed", False), "embed_positions.weight": ("pos_embed", False),
           "final_layer_norm.weight": ("final_ln_scale", False), "final_layer_norm.bias": ("final_ln_bias", False)}
OPT_LAYER = {
    "self_attn_layer_norm.weight": ("ln1_scale", False), "self_attn_layer_norm.bias": ("ln1_bias", False),
    "self_attn.q_proj.weight": ("wq", True), "self_attn.q_proj.bias": ("bq", False),
    "self_attn.k_proj.weight": ("wk", True), "self_attn.k_proj.bias": ("bk", False),
    "self_attn.v_proj.weight": ("wv", True), "self_attn.v_proj.bias": ("bv", False),
    "self_attn.out_proj.weight": ("wo", True), "self_attn.out_proj.bias": ("bo", False),
    "final_layer_norm.weight": ("ln2_scale", False), "final_layer_norm.bias": ("ln2_bias", False),
    "fc1.weight": ("fc1", True), "fc1.bias": ("fc1_b", False),
    "fc2.weight": ("fc2", True), "fc2.bias": ("fc2_b", False),
}
# HF Falcon names (without "transformer." or "model.transformer."), layers
# under "h."; the fused query_key_value is split by falcon_qkv. The first
# norm is input_layernorm on 7b-style models, ln_attn (beside ln_mlp) on
# 40b-style ones (separate_ln).
FALCON_TOP = {"word_embeddings.weight": ("tok_embed", False), "ln_f.weight": ("final_ln_scale", False),
              "ln_f.bias": ("final_ln_bias", False)}
FALCON_LAYER = {"self_attention.dense.weight": ("wo", True), "mlp.dense_h_to_4h.weight": ("fc1", True),
                "mlp.dense_4h_to_h.weight": ("fc2", True)}
FALCON_QKV = "self_attention.query_key_value.weight"


def falcon_norms(separate_ln: bool) -> Dict[str, Tuple[str, bool]]:
    """A Falcon layer's HF norm names -> the port's."""
    first = "ln_attn" if separate_ln else "input_layernorm"
    norms = {f"{first}.weight": ("ln1_scale", False), f"{first}.bias": ("ln1_bias", False)}
    if separate_ln:
        norms.update({"ln_mlp.weight": ("ln2_scale", False), "ln_mlp.bias": ("ln2_bias", False)})
    return norms


def hf_layout(cfg) -> Tuple[Tuple[str, ...], str, Dict[str, Tuple[str, bool]], Dict[str, Tuple[str, bool]]]:
    """(name prefixes, the first the one transformers writes; the layers'
    name; top-level names; per-layer names) of the config's family in an
    HF checkpoint."""
    family = registry.family_of(cfg)
    if family == "opt":
        return ("model.decoder.", "decoder."), "layers", OPT_TOP, OPT_LAYER
    if family == "falcon":
        return ("transformer.", "model.transformer."), "h", FALCON_TOP, {**FALCON_LAYER,
                                                                         **falcon_norms(cfg.separate_ln)}
    return ("model.",), "layers", HF_TOP, HF_LAYER


def port_name(hf_name: str, cfg) -> Tuple[str, bool] | None:
    """(the port's state_dict name, whether the HF tensor is transposed
    into it) of an HF tensor name of the config's family; None for a
    tensor the model does not hold (rotary tables, a tied lm_head and the
    like) and for Falcon's fused query_key_value (copy_hf_state splits
    it)."""
    prefixes, layers, top, layer = hf_layout(cfg)
    name = hf_name
    for prefix in prefixes:
        if name.startswith(prefix):
            name = name.removeprefix(prefix)
            break
    if name in top:
        return top[name]
    parts = name.split(".", 2)
    if len(parts) == 3 and parts[0] == layers and parts[2] in layer:
        port, transposed = layer[parts[2]]
        return f"layers.{parts[1]}.{port}", transposed
    return None


def falcon_qkv(w: torch.Tensor, cfg: FalconConfig) -> Dict[str, torch.Tensor]:
    """A fused query_key_value [(H + 2 KH) hd, D], per kv group [G q | k |
    v] heads, -> {wq: [D, H hd], wk, wv: [D, KH hd]} (views where the
    layout allows), the port's [D, H, hd] and [D, KH, hd] flattened."""
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_size
    grouped = w.view(KH, H // KH + 2, hd, w.shape[1])
    return {"wq": grouped[:, :-2].reshape(H * hd, -1).t(), "wk": grouped[:, -2].reshape(KH * hd, -1).t(),
            "wv": grouped[:, -1].reshape(KH * hd, -1).t()}


@torch.no_grad()
def copy_hf_state(model: nn.Module, items: Iterable[Tuple[str, torch.Tensor]]) -> None:
    """Copy (HF name, tensor) pairs into `model` (any family's module; the
    names those of model.cfg's family), each as it comes: moved to the
    model's device, transposed there into the port's layout, and rounded to
    the model's dtype. Raises KeyError naming every weight of the model
    that no item filled."""
    state = model.state_dict(keep_vars=True)
    cfg = model.cfg
    filled = set()

    def put(name: str, hf_name: str, w: torch.Tensor) -> None:
        target = state[name]
        if target.numel() != w.numel():
            raise ValueError(f"{hf_name}: shape {tuple(w.shape)} does not fit {name} {tuple(target.shape)}")
        target.view(w.shape).copy_(w)
        filled.add(name)

    for hf_name, w in items:
        if registry.family_of(cfg) == "falcon" and hf_name.endswith(FALCON_QKV):
            layer = hf_name.removesuffix("." + FALCON_QKV).rsplit(".", 1)[1]
            for port, part in falcon_qkv(w.to(state["tok_embed"].device), cfg).items():
                put(f"layers.{layer}.{port}", hf_name, part)
            continue
        found = port_name(hf_name, cfg)
        if found is None or found[0] not in state:
            continue
        name, transposed = found
        w = w.to(state[name].device)
        put(name, hf_name, w.t() if transposed else w)
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


# family -> its config from config.json
_HF_CONFIGS = {"llama": config_from_hf, "opt": config_from_hf_opt, "falcon": config_from_hf_falcon}


def load_pretrained(path: str, dtype: torch.dtype = torch.bfloat16,
                    device: DeviceLike = None) -> Tuple[Any, nn.Module]:
    """A local HF directory of the llama, OPT or Falcon family -> (config,
    the family's module on `device`), cuda unless the caller asks for the
    CPU. Exits for any other path (the port reads no hub), for other
    model types, for mixture-of-experts configs and for the OPT and Falcon
    variants the JAX converters refuse."""
    if not is_hf_dir(path):
        raise SystemExit(f"{path}: not a local checkpoint; the PyTorch port loads local checkpoints only (a "
                         "directory with config.json, a .gguf file or a port artifact), with no download")
    device = resolve_device(device)
    with open(os.path.join(path, "config.json")) as f:
        raw = json.load(f)
    model_type = raw.get("model_type", "llama")
    family = registry.HF_MODEL_TYPES.get(model_type)
    if family is None:
        raise SystemExit(f"{path}: unsupported HF model_type {model_type!r} (supported: "
                         f"{sorted(registry.HF_MODEL_TYPES)})")
    cfg = _HF_CONFIGS[family](SimpleNamespace(**raw), dtype)
    model = registry.MODEL_CLASSES[family](cfg, device=device)
    copy_hf_state(model, _state_items(path))
    return cfg, model
