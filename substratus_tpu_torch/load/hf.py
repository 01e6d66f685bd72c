"""HuggingFace checkpoint import (port of substratus_tpu/load/hf.py): a
local directory (``config.json`` beside safetensors or torch ``.bin``
files) of a Llama-family (llama, mistral, mixtral), OPT or Falcon model
loaded into the family's module (models/registry.py) on its device.

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
to its dtype (as the JAX converter's asarray does); Mixtral's experts go
expert by expert into the stacked [E, ...] weights, with no whole-tensor
transient. With ``quantize`` (int8 or int4, llama only) the layers are
staged dense one at a time and quantized as each completes, so the peak is
the quantized model plus about one dense layer, not the dense model: the
bytes are those of loading dense and then quantizing, as the JAX entry
point does. The refusals of config_from_hf_opt and config_from_hf_falcon
exit with the JAX messages.
The JAX loader's hub fallback is not ported: the port loads local
checkpoints only.
"""
from __future__ import annotations

import json
import os
import re
import struct
from types import SimpleNamespace
from typing import Any, Dict, Iterable, Tuple

import numpy as np
import torch

from torch import nn

from substratus_tpu_torch.models import registry
from substratus_tpu_torch.models.falcon import FalconConfig
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.models.llama import LlamaConfig
from substratus_tpu_torch.models.opt import OPTConfig
from substratus_tpu_torch.utils.device import DeviceLike, resolve_device

def config_from_hf(hf_cfg: Any, dtype: torch.dtype = torch.bfloat16) -> LlamaConfig:
    """Map a transformers Llama/Mistral/Mixtral config (or a namespace of
    its config.json) to LlamaConfig, the MoE fields as the JAX package maps
    them."""
    get = lambda name, default=None: getattr(hf_cfg, name, default)  # noqa: E731
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
        n_experts=get("num_local_experts", 0) or 0,
        n_experts_per_token=get("num_experts_per_tok", 2) or 2,
        router_aux_weight=get("router_aux_loss_coef", 0.01) or 0.01,
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
    # Mixtral: the router; experts.N.{w1,w3,w2} are HF_EXPERT's
    "block_sparse_moe.gate.weight": ("router", True),
}
# Mixtral's expert weights [out, in] -> (the port's stacked weight, expert).
HF_EXPERT = re.compile(r"block_sparse_moe\.experts\.(\d+)\.(w[123])\.weight")
HF_EXPERT_NAMES = {"w1": "w_gate", "w3": "w_up", "w2": "w_down"}


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


def port_name(hf_name: str, cfg) -> Tuple[str, bool, int | None] | None:
    """(the port's state_dict name, whether the HF tensor is transposed
    into it, the expert it fills of a stacked expert weight or None) of an
    HF tensor name of the config's family; None for a tensor the model
    does not hold (rotary tables, a tied lm_head and the like) and for
    Falcon's fused query_key_value (copy_hf_state splits it)."""
    prefixes, layers, top, layer = hf_layout(cfg)
    name = hf_name
    for prefix in prefixes:
        if name.startswith(prefix):
            name = name.removeprefix(prefix)
            break
    if name in top:
        return (*top[name], None)
    parts = name.split(".", 2)
    if len(parts) == 3 and parts[0] == layers:
        if parts[2] in layer:
            port, transposed = layer[parts[2]]
            return f"layers.{parts[1]}.{port}", transposed, None
        expert = HF_EXPERT.fullmatch(parts[2]) if getattr(cfg, "n_experts", 0) > 0 else None
        if expert:
            return f"layers.{parts[1]}.{HF_EXPERT_NAMES[expert[2]]}", True, int(expert[1])
    return None


def falcon_qkv(w: torch.Tensor, cfg: FalconConfig) -> Dict[str, torch.Tensor]:
    """A fused query_key_value [(H + 2 KH) hd, D], per kv group [G q | k |
    v] heads, -> {wq: [D, H hd], wk, wv: [D, KH hd]} (views where the
    layout allows), the port's [D, H, hd] and [D, KH, hd] flattened."""
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_size
    grouped = w.view(KH, H // KH + 2, hd, w.shape[1])
    return {"wq": grouped[:, :-2].reshape(H * hd, -1).t(), "wk": grouped[:, -2].reshape(KH * hd, -1).t(),
            "wv": grouped[:, -1].reshape(KH * hd, -1).t()}


class _Staging:
    """Dense staging of a llama model laid out quantized (llama.Llama(cfg,
    quantize=...)): every tensor of a layer (norms and router too) lands in
    a dense LlamaBlock, and the lm_head in a dense tensor, which is
    quantized into the model as soon as its last tensor arrives and
    replaces the model's (uninitialized) storage.

    With a `mesh` (a gang rank's tensor shard, `model` laid out by
    llama.shard_config's config) every tensor is staged, at the whole
    model's shape (`whole`, its config): a full layer (or the embedding,
    the final norm, the lm_head) is quantized whole, then sliced by
    parallel.sharding.shard_params into the model's shard, so an int8
    shard keeps the whole weight's scales and no rank holds more than one
    whole layer beside its shard. An int4 slice is whole scale groups (or
    the weight is kept whole), so its bytes are quantize4 of the slice's
    dense values as well."""

    TOP = ("tok_embed", "out_norm", "lm_head")

    def __init__(self, model: nn.Module, quantize: str, whole=None, mesh=None):
        self.model, self.quantize, self.cfg = model, quantize, whole or model.cfg
        self.mesh = mesh
        self.layer_axes = llama._layer_contracting(self.cfg)
        self.blocks: Dict[str, Tuple[nn.Module, set]] = {}  # "layers.i" or "" -> (dense owner, names to fill)

    def target(self, name: str) -> torch.Tensor:
        """The dense tensor `name` (a quantized weight's) fills."""
        owner, _, attr = name.rpartition(".")
        if owner not in self.blocks:
            if owner:
                block = llama.LlamaBlock(self.cfg, self.model.device)
                self.blocks[owner] = (block, set(dict(block.named_parameters())))
            else:
                cfg = self.cfg
                shapes = {"tok_embed": (cfg.vocab_size, cfg.dim), "out_norm": (cfg.dim,),
                          "lm_head": (cfg.dim, cfg.vocab_size)}
                names = [n for n in self.TOP if hasattr(self.model, n)] if self.mesh is not None else [attr]
                holder = nn.Module()
                for n in names:
                    setattr(holder, n, llama._weight(shapes[n], cfg, self.model.device))
                self.blocks[owner] = (holder, set(names))
        return getattr(self.blocks[owner][0], attr)

    def done(self, name: str) -> None:
        """`name`'s tensor is in: quantize and install its owner once full."""
        owner, _, attr = name.rpartition(".")
        block, todo = self.blocks[owner]
        todo.discard(attr)
        if todo:
            return
        del self.blocks[owner]
        if self.mesh is not None:
            self._install_shard(owner, block)
        elif owner:
            llama._quantize_module(block, self.quantize, self.layer_axes, self.cfg)
            self.model.layers[int(owner.split(".")[1])] = block
        else:
            w = llama.quantize_leaf(getattr(block, attr), llama.quant_contracting(self.cfg)["lm_head"], self.quantize)
            delattr(self.model, attr)
            setattr(self.model, attr, w)

    def _install_shard(self, owner: str, block: nn.Module) -> None:
        """Quantize a staged whole owner, slice it, copy the slices into the
        model's shard."""
        from substratus_tpu_torch.parallel.sharding import shard_params

        top = {"lm_head": llama.quant_contracting(self.cfg).get("lm_head", ())}
        llama._quantize_module(block, self.quantize, self.layer_axes if owner else top, self.cfg)
        prefix = f"{owner}." if owner else ""
        state = {prefix + k: v for k, v in block.state_dict().items()}
        shard = shard_params(state, llama.param_logical_axes(self.cfg), self.mesh)
        missing, unexpected = llama.load_shard(self.model, shard, strict=False)
        if unexpected:
            raise KeyError(f"staged {unexpected} that the shard does not hold")


@torch.no_grad()
def copy_hf_state(model: nn.Module, items: Iterable[Tuple[str, torch.Tensor]], quantize: str = "none",
                  shard=None) -> None:
    """Copy (HF name, tensor) pairs into `model` (any family's module; the
    names those of model.cfg's family), each as it comes: moved to the
    model's device, transposed there into the port's layout, and rounded to
    the model's dtype; an expert's tensor into its slice of the stacked
    weight. With quantize (a llama model laid out by Llama(cfg,
    quantize=quantize)), each layer is staged dense and quantized when its
    last tensor arrives (_Staging). With `shard` (the whole model's config
    and a gang's mesh; `model` a rank's shard) every tensor is staged whole
    and sliced as its owner completes. Raises KeyError naming every weight
    of the model that no item filled."""
    cfg = model.cfg
    state = model.state_dict(keep_vars=True)
    stage = _Staging(model, quantize) if quantize != "none" else None
    if shard is not None:
        stage = _Staging(model, quantize, *shard)
    experts = getattr(cfg, "n_experts", 0)
    wanted = {name for name in state if not name.endswith("._extra_state")}
    if stage is not None:  # a quantized weight is wanted by its dense name
        wanted = {name.rsplit(".", 1)[0] if name.endswith((".packed", ".q", ".scale")) else name
                  for name in wanted}
    filled: Dict[str, set] = {}

    def put(name: str, hf_name: str, w: torch.Tensor, expert: int | None = None) -> None:
        staged = stage is not None and (shard is not None or name.startswith("layers.") or name not in state)
        target = stage.target(name) if staged else state[name]
        if expert is not None:
            target = target[expert]
        if target.numel() != w.numel():
            raise ValueError(f"{hf_name}: shape {tuple(w.shape)} does not fit {name} {tuple(target.shape)}")
        target.view(w.shape).copy_(w)
        got = filled.setdefault(name, set())
        got.add(expert)
        if staged and (expert is None or len(got) == experts):
            stage.done(name)

    for hf_name, w in items:
        if registry.family_of(cfg) == "falcon" and hf_name.endswith(FALCON_QKV):
            layer = hf_name.removesuffix("." + FALCON_QKV).rsplit(".", 1)[1]
            for port, part in falcon_qkv(w.to(state["tok_embed"].device), cfg).items():
                put(f"layers.{layer}.{port}", hf_name, part)
            continue
        found = port_name(hf_name, cfg)
        if found is None or found[0] not in wanted:
            continue
        name, transposed, expert = found
        w = w.to(model.tok_embed.device)
        put(name, hf_name, w.t() if transposed else w, expert)
    missing = sorted(name for name in wanted if name not in filled
                     or (name.rsplit(".", 1)[-1] in llama.EXPERT_WEIGHTS and experts
                         and len(filled[name]) != experts))
    if missing:
        raise KeyError(f"the checkpoint has no tensor for {missing}")
    if stage is not None and stage.blocks:
        raise KeyError(f"the checkpoint left {sorted(stage.blocks)} incomplete")


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


def load_pretrained(path: str, dtype: torch.dtype = torch.bfloat16, device: DeviceLike = None,
                    quantize: str = "none", mesh_for=None) -> Tuple[Any, nn.Module]:
    """A local HF directory of the llama (Mixtral included), OPT or Falcon
    family -> (config, the family's module on `device`), cuda unless the
    caller asks for the CPU; a llama model quantized at load with
    quantize="int8"|"int4" (layer by layer: copy_hf_state; another family
    loads dense, its caller says it skips the quantization). Exits for any
    other path (the port reads no hub), for other model types and for the
    OPT and Falcon variants the JAX converters refuse. With `mesh_for`
    (cfg -> a gang's mesh with a tensor axis above 1), a llama checkpoint
    loads as this rank's tensor shard (llama.shard_model's, a layer at a
    time: copy_hf_state); the returned cfg is the shard's."""
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
    if not getattr(registry.module_for(family), "SUPPORTS_QUANTIZE", False):
        quantize = "none"
    mesh = mesh_for(cfg) if mesh_for is not None and family == "llama" else None
    if mesh is not None and mesh.shape["tensor"] > 1:
        t = mesh.shape["tensor"]
        model = llama.Llama(llama.shard_config(cfg, t), device=device, quantize=quantize)
        copy_hf_state(model, _state_items(path), quantize, shard=(cfg, mesh))
        model.tp = llama.tensor_shard(cfg, mesh, llama.down_kept_whole(cfg, t, quantize))
        return model.cfg, model
    model = (llama.Llama(cfg, device=device, quantize=quantize) if quantize != "none"
             else registry.MODEL_CLASSES[family](cfg, device=device))
    copy_hf_state(model, _state_items(path), quantize)
    return cfg, model
