"""Checkpoint writers for tests and the on-card smoke run: a port model of
any family written as a local HF directory (config.json with
transformers' keys and safetensors shards under its names, with their
index; Falcon's q, k and v fused into query_key_value per kv group, the
order load/hf.py's converter undoes; a mixture of experts as Mixtral's
``block_sparse_moe`` gate and experts.N.w1/w3/w2, model_type mixtral),
or a dense llama model as a llama.cpp GGUF
file (F32, F16, Q4_0 or Q8_0 tensors,
q/k permuted as llama.cpp's converter permutes them, an embedded
SentencePiece vocabulary). The serving path never imports this module.

Quantization runs on the model's device with torch ops, as ggml's
reference quantizers compute it (Q4_0: d = the block's signed absmax / -8,
codes min(15, trunc(x / d + 8.5)); Q8_0: d = absmax / 127, codes
round-half-away(x / d)); ``write_gguf`` returns the model a loader must
produce: each weight dequantized as GGML defines it (f16 d -> f32 times
the code, then f16), in the port's layout and the model's dtype.

    python -m substratus_tpu_torch.tools.ckpt_writer --config tiny --hf DIR --gguf FILE [--device cpu]
    python -m substratus_tpu_torch.tools.ckpt_writer --config falcon-7b --hf DIR
    # mixtral-8x7b's width at 2 layers (6.33 GB of bf16)
    python -m substratus_tpu_torch.tools.ckpt_writer --config mixtral-8x7b --shape n_layers=2 --hf DIR
    # facebook/opt-2.7b's published shape (head_dim 80) as overrides of opt-1.3b
    python -m substratus_tpu_torch.tools.ckpt_writer --config opt-1.3b \
        --shape dim=2560,n_heads=32,n_layers=32,hidden_dim=10240 --hf DIR
    # a written directory through batch generation (a JSONL manifest of
    # {"prompt": ...} or {"tokens": [...]} records, sharded JSONL out)
    python -m substratus_tpu_torch.serve.batchgen --model DIR --params '' --manifest m.jsonl --output out/
"""
from __future__ import annotations

import argparse
import json
import os
import random
import struct
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from substratus_tpu_torch.load.gguf import (
    _BLOCK, _NAME_MAP, GGML_F16, GGML_F32, GGML_Q4_0, GGML_Q8_0, _gguf_string, gguf_header)
from torch import nn

from substratus_tpu_torch.load.hf import FALCON_QKV, HF_EXPERT_NAMES, copy_hf_state, hf_layout
from substratus_tpu_torch.models import registry
from substratus_tpu_torch.models.llama import EXPERT_WEIGHTS, Llama, LlamaConfig

_ST_NAMES = {torch.bfloat16: "BF16", torch.float16: "F16", torch.float32: "F32"}
SHARD_BYTES = 5 * 10**9  # the shard size of transformers' save_pretrained


def _to_hf(name: str, w: torch.Tensor, transposed: bool) -> torch.Tensor:
    """A port weight in an HF tensor's layout: a Linear's [in..., out...]
    as [out, in] (contiguous; wo's input is [H, hd]), OPT's q/k/v biases
    [H, hd] flat, the rest as they are."""
    if transposed:
        return (w.flatten(0, 1) if name.endswith(".wo") else w.flatten(1)).t().contiguous()
    return w.flatten() if name.rsplit(".", 1)[-1] in ("bq", "bk", "bv") else w


def _fused_qkv(lp: nn.Module, cfg) -> torch.Tensor:
    """Falcon's query_key_value [(H + 2 KH) hd, D] of a layer's wq [D, H,
    hd], wk, wv [D, KH, hd]: per kv group its G query heads, then its k,
    then its v head (transformers' layout, which load/hf.py::falcon_qkv
    splits)."""
    H, KH, hd, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_size, cfg.dim
    q = lp.wq.permute(1, 2, 0).reshape(KH, H // KH, hd, D)
    k = lp.wk.permute(1, 2, 0).reshape(KH, 1, hd, D)
    v = lp.wv.permute(1, 2, 0).reshape(KH, 1, hd, D)
    return torch.cat([q, k, v], dim=1).reshape((H + 2 * KH) * hd, D)


def hf_tensors(model: nn.Module) -> Iterator[Tuple[str, torch.Tensor]]:
    """(HF name, tensor) of every weight of a dense port model of any
    family, on its device and in its dtype: Linear weights [out, in]
    (contiguous), under transformers' names for the family (a tied head
    written once, as save_pretrained writes it; a stacked expert weight as
    its experts' tensors)."""
    cfg = model.cfg
    family = registry.family_of(cfg)
    prefixes, layers, top, layer = hf_layout(cfg)
    top_prefix, layer_prefix = prefixes[0], prefixes[0] + layers
    to_hf = {port: (hf, t) for hf, (port, t) in top.items()}
    to_hf_layer = {port: (hf, t) for hf, (port, t) in layer.items()}
    expert_hf = {port: hf for hf, port in HF_EXPERT_NAMES.items()}
    for name, w in model.state_dict().items():
        if name.startswith("layers."):
            _, i, port = name.split(".")
            if family == "falcon" and port in ("wq", "wk", "wv"):
                if port == "wq":  # the fused tensor, once a layer
                    yield f"{layer_prefix}.{i}.{FALCON_QKV}", _fused_qkv(model.layers[int(i)], cfg)
                continue
            if getattr(cfg, "n_experts", 0) > 0 and port in EXPERT_WEIGHTS:
                for e in range(cfg.n_experts):
                    yield (f"{layer_prefix}.{i}.block_sparse_moe.experts.{e}.{expert_hf[port]}.weight",
                           w[e].t().contiguous())
                continue
            hf, transposed = to_hf_layer[port]
            hf = f"{layer_prefix}.{i}.{hf}"
        else:
            hf, transposed = to_hf[name]
            hf = hf if hf == "lm_head.weight" else top_prefix + hf
        yield hf, _to_hf(name, w, transposed)


def hf_config(cfg) -> Dict[str, Any]:
    """config.json of a port config, with the keys transformers writes
    for the family's model."""
    dtype = str(cfg.dtype).removeprefix("torch.")
    family = registry.family_of(cfg)
    if family == "opt":
        return {"architectures": ["OPTForCausalLM"], "model_type": "opt", "vocab_size": cfg.vocab_size,
                "hidden_size": cfg.dim, "ffn_dim": cfg.hidden_dim, "num_hidden_layers": cfg.n_layers,
                "num_attention_heads": cfg.n_heads, "max_position_embeddings": cfg.max_seq_len,
                "do_layer_norm_before": True, "activation_function": "relu", "word_embed_proj_dim": cfg.dim,
                "enable_bias": True, "layer_norm_elementwise_affine": True, "tie_word_embeddings": True,
                "torch_dtype": dtype, "bos_token_id": 2, "eos_token_id": 2, "pad_token_id": 1}
    if family == "falcon":
        if not cfg.separate_ln and cfg.n_kv_heads not in (1, cfg.n_heads):
            raise ValueError(f"a 7b-style Falcon config has 1 or {cfg.n_heads} kv heads in transformers' format, "
                             f"not {cfg.n_kv_heads}")
        return {"architectures": ["FalconForCausalLM"], "model_type": "falcon", "vocab_size": cfg.vocab_size,
                "hidden_size": cfg.dim, "num_hidden_layers": cfg.n_layers, "num_attention_heads": cfg.n_heads,
                "num_kv_heads": cfg.n_kv_heads, "multi_query": cfg.n_kv_heads == 1,
                "new_decoder_architecture": cfg.separate_ln, "parallel_attn": True, "bias": False, "alibi": False,
                "layer_norm_epsilon": cfg.norm_eps, "rope_theta": cfg.rope_theta,
                "max_position_embeddings": cfg.max_seq_len, "tie_word_embeddings": True, "torch_dtype": dtype,
                "bos_token_id": 11, "eos_token_id": 11}
    if cfg.n_experts > 0:
        return {"architectures": ["MixtralForCausalLM"], "model_type": "mixtral", "vocab_size": cfg.vocab_size,
                "hidden_size": cfg.dim, "intermediate_size": cfg.hidden_dim, "num_hidden_layers": cfg.n_layers,
                "num_attention_heads": cfg.n_heads, "num_key_value_heads": cfg.n_kv_heads,
                "head_dim": cfg.head_size, "num_local_experts": cfg.n_experts,
                "num_experts_per_tok": cfg.n_experts_per_token, "router_aux_loss_coef": cfg.router_aux_weight,
                "output_router_logits": False, "sliding_window": None, "rms_norm_eps": cfg.norm_eps,
                "rope_theta": cfg.rope_theta, "max_position_embeddings": cfg.max_seq_len,
                "tie_word_embeddings": cfg.tie_embeddings, "torch_dtype": dtype, "hidden_act": "silu",
                "bos_token_id": 1, "eos_token_id": 2}
    return {"architectures": ["LlamaForCausalLM"], "model_type": "llama", "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.dim, "intermediate_size": cfg.hidden_dim, "num_hidden_layers": cfg.n_layers,
            "num_attention_heads": cfg.n_heads, "num_key_value_heads": cfg.n_kv_heads, "head_dim": cfg.head_size,
            "rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta, "max_position_embeddings": cfg.max_seq_len,
            "tie_word_embeddings": cfg.tie_embeddings, "torch_dtype": dtype,
            "hidden_act": "silu", "bos_token_id": 1, "eos_token_id": 2}


def _st_header(entries: List[Tuple[str, torch.Tensor]]) -> bytes:
    header, offset = {}, 0
    for name, t in entries:
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    header["__metadata__"] = {"format": "pt"}
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # the data starts 8-aligned, as the format's writer pads it
    return struct.pack("<Q", len(raw)) + raw


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).cpu().numpy()


def write_hf(path: str, model: nn.Module, shard_bytes: int = SHARD_BYTES) -> Dict[str, Any]:
    """Write `model` as an HF directory: config.json and safetensors
    shards of at most `shard_bytes` (one file, or several with
    model.safetensors.index.json). Returns {"files", "bytes"}."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config(model.cfg), f, indent=2)
    names = [(hf, tuple(t.shape), t.numel() * t.element_size()) for hf, t in hf_tensors(model)]
    shards: List[List[str]] = [[]]
    size = 0
    for hf, _, n in names:
        if shards[-1] and size + n > shard_bytes:
            shards.append([])
            size = 0
        shards[-1].append(hf)
        size += n
    files = (["model.safetensors"] if len(shards) == 1 else
             [f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors" for i in range(len(shards))])
    shard_of = {hf: files[i] for i, shard in enumerate(shards) for hf in shard}
    tensors = hf_tensors(model)
    total = 0
    for fname, shard in zip(files, shards):
        entries = [next(tensors) for _ in shard]
        with open(os.path.join(path, fname), "wb") as f:
            f.write(_st_header(entries))
            for _, t in entries:
                _host_bytes(t).tofile(f)
                total += t.numel() * t.element_size()
    if len(files) > 1:
        with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {"total_size": total}, "weight_map": shard_of}, f, indent=2)
    return {"files": files, "bytes": total}


def _permute_qk(w: torch.Tensor, n_head: int) -> torch.Tensor:
    """llama.cpp's HF->GGUF reorder of a q/k projection's rows (any
    trailing dims): each head's rotate-half halves interleaved."""
    out = w.shape[0]
    return w.reshape(n_head, 2, out // n_head // 2, *w.shape[1:]).transpose(1, 2).reshape(w.shape)


def _quantize_blocks(w: torch.Tensor, ggml_type: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(blocks [out, in/32, block bytes] uint8, dequantized f16 [out, in])
    of a [out, in] weight, per ggml's reference quantizer."""
    x = w.float().reshape(w.shape[0], -1, 32)
    if ggml_type == GGML_Q4_0:
        idx = x.abs().argmax(dim=-1, keepdim=True)  # the first largest |x|, with its sign
        d = x.gather(-1, idx) / -8
        inv = torch.where(d != 0, 1.0 / d, torch.zeros_like(d))
        q = torch.clamp(torch.trunc(x * inv + 8.5), max=15).to(torch.uint8)
        packed = q[..., :16] | (q[..., 16:] << 4)
        codes = q.float() - 8
    else:  # Q8_0
        d = x.abs().amax(dim=-1, keepdim=True) / 127
        inv = torch.where(d != 0, 1.0 / d, torch.zeros_like(d))
        v = x * inv
        codes = torch.sign(v) * torch.floor(v.abs() + 0.5)  # roundf: half away from zero
        packed = codes.to(torch.int8).view(torch.uint8)
    d16 = d.to(torch.float16)
    blocks = torch.cat([d16.view(torch.uint8), packed], dim=-1)
    return blocks, (codes * d16.float()).to(torch.float16).reshape(w.shape)


def default_gguf_types(hf_name: str) -> int:
    """llama.cpp's Q4_0 mix: 1-D tensors F32, the embedding and the output
    Q8_0, every other matmul Q4_0."""
    if hf_name.endswith("norm.weight"):
        return GGML_F32
    if "embed_tokens" in hf_name or hf_name == "lm_head.weight":
        return GGML_Q8_0
    return GGML_Q4_0


def gguf_meta(cfg: LlamaConfig, vocab: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The llama architecture's metadata keys of `cfg`, plus a vocab's."""
    meta = {"general.architecture": "llama", "general.alignment": 32, "llama.context_length": cfg.max_seq_len,
            "llama.embedding_length": cfg.dim, "llama.block_count": cfg.n_layers,
            "llama.feed_forward_length": cfg.hidden_dim, "llama.attention.head_count": cfg.n_heads,
            "llama.attention.head_count_kv": cfg.n_kv_heads, "llama.attention.key_length": cfg.head_size,
            "llama.attention.value_length": cfg.head_size, "llama.rope.freq_base": float(cfg.rope_theta),
            "llama.attention.layer_norm_rms_epsilon": float(cfg.norm_eps)}
    meta.update(vocab or {})
    return meta


def write_gguf(path: str, model: Llama, vocab: Optional[Dict[str, Any]] = None,
               ggml_type: Callable[[str], int] = default_gguf_types) -> Llama:
    """Write `model` as a GGUF v3 file (tensor types by HF name, q/k rows
    permuted, `vocab`'s tokenizer.* keys embedded) and return the model a
    loader must produce from it, on the same device: every weight as the
    file holds it, dequantized per GGML."""
    cfg = model.cfg
    gname = {v: k for k, v in _NAME_MAP.items()}
    items = []  # (gguf name, HF name, numpy shape, ggml type)
    for hf, t in hf_tensors(model):
        bare = hf.removeprefix("model.")
        parts = bare.split(".", 2)
        g = gname["layers.{i}." + parts[2]].format(i=parts[1]) if parts[0] == "layers" else gname[bare]
        items.append((g, hf, tuple(t.shape), ggml_type(hf)))
    head = bytearray(gguf_header(gguf_meta(cfg, vocab), len(items)))
    offset = 0
    for g, _, shape, gt in items:
        head += _gguf_string(g) + struct.pack("<I", len(shape))
        head += b"".join(struct.pack("<Q", d) for d in reversed(shape))  # ne[0] = the contiguous dim
        head += struct.pack("<I", gt) + struct.pack("<Q", offset)
        qk, bsz = _BLOCK[gt]
        nbytes = int(np.prod(shape)) // qk * bsz
        offset += -(-nbytes // 32) * 32  # each tensor's data 32-aligned
    head += b"\0" * (-len(head) % 32)
    expected = Llama(cfg, device=model.device)

    def dequantized():
        with open(path, "wb") as f:
            f.write(head)
            for (g, hf, shape, gt), (_, w) in zip(items, hf_tensors(model)):
                heads = cfg.n_heads if ".attn_q." in g else cfg.n_kv_heads if ".attn_k." in g else 0
                if gt == GGML_F32:
                    data, deq = w.float(), w.float()
                elif gt == GGML_F16:
                    data = deq = w.to(torch.float16)
                else:
                    data, deq = _quantize_blocks(w, gt)
                if heads:  # llama.cpp's row order; the rows hold whole blocks
                    data = _permute_qk(data, heads)
                raw = _host_bytes(data)
                raw.tofile(f)
                f.write(b"\0" * (-raw.size % 32))
                yield hf, deq

    copy_hf_state(expected, dequantized())
    return expected


# A Llama-2-style chat template (jinja, as GGUF files embed it in
# tokenizer.chat_template): BOS, an optional <<SYS>> block, [INST] turns,
# assistant turns closed by EOS; other roles raise through the renderer's
# raise_exception helper.
LLAMA2_CHAT_TEMPLATE = (
    "{{ bos_token }}{% for message in messages %}"
    "{% if message['role'] == 'system' %}<<SYS>>\n{{ message['content'] | trim }}\n<</SYS>>\n\n"
    "{% elif message['role'] == 'user' %}[INST] {{ message['content'] | trim }} [/INST]"
    "{% elif message['role'] == 'assistant' %} {{ message['content'] | trim }} {{ eos_token }}"
    "{% else %}{{ raise_exception('roles are system, user and assistant') }}{% endif %}{% endfor %}"
)


def spm_vocab(size: int = 32000, seed: int = 0, texts: Tuple[str, ...] = (),
              chat_template: Optional[str] = None) -> Dict[str, Any]:
    """An embedded SentencePiece vocabulary of `size` pieces: <unk>, <s>,
    </s>, the 256 <0xXX> byte pieces, then every prefix of "▁" + word for
    the words of `texts` and of a seeded corpus of syllable words, most
    frequent first (so the greedy merge reaches every such word), scored
    by rank; with `chat_template`, that jinja template too."""
    if size < 300:
        raise ValueError(f"an SPM vocabulary of {size} pieces leaves no room beyond the 259 special and byte pieces")
    rng = random.Random(seed)
    syllables = [c + v for c in "bcdfghjklmnprstvwz" for v in "aeiou"]
    corpus = [w for text in texts for w in text.lower().split()]
    corpus += ["".join(rng.choices(syllables, k=rng.randint(1, 4))) for _ in range(60000)]
    counts: Dict[str, int] = {}
    for w in corpus:
        counts[w] = counts.get(w, 0) + 1
    pieces = dict.fromkeys(["▁"] + list("abcdefghijklmnopqrstuvwxyz0123456789"))
    for w in sorted(counts, key=lambda w: (-counts[w], w)):
        for end in range(2, len(w) + 2):
            pieces.setdefault(("▁" + w)[:end])
            if len(pieces) >= size - 259:
                break
        if len(pieces) >= size - 259:
            break
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)] + list(pieces)[: size - 259]
    tokens += [f"<unused{i}>" for i in range(size - len(tokens))]
    n = len(tokens)
    return {"tokenizer.ggml.model": "llama", "tokenizer.ggml.tokens": tokens,
            "tokenizer.ggml.scores": [0.0] * 259 + [-float(i) for i in range(n - 259)],
            "tokenizer.ggml.token_type": [2, 3, 3] + [6] * 256 + [1] * (n - 259),
            "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2,
            "tokenizer.ggml.unknown_token_id": 0,
            **({"tokenizer.chat_template": chat_template} if chat_template else {})}


def shape_overrides(cfg, text: Optional[str]):
    """cfg with the integer fields of `text` ("dim=2560,n_heads=32")
    replaced: a published shape the named configs lack, written without a
    new CONFIGS entry."""
    if not text:
        return cfg
    fields = {}
    for item in text.split(","):
        key, _, value = item.partition("=")
        if not isinstance(getattr(cfg, key.strip(), None), int) or not value.strip().isdigit():
            raise SystemExit(f"--shape {item!r}: not an integer field of {type(cfg).__name__} set to a count")
        fields[key.strip()] = int(value)
    return cfg.replace(**fields)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m substratus_tpu_torch.tools.ckpt_writer")
    ap.add_argument("--config", default="tiny", help="named config, random weights from --seed")
    ap.add_argument("--shape", default=None, help="integer overrides of the config, e.g. dim=2560,n_heads=32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hf", default=None, help="write an HF safetensors directory here")
    ap.add_argument("--gguf", default=None, help="write a Q4_0 GGUF file with an SPM vocabulary here")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    family, cfg = registry.find_named_config(args.config)
    cfg = shape_overrides(cfg, args.shape)
    if args.gguf and (registry.family_of(cfg) != "llama" or getattr(cfg, "n_experts", 0)):
        raise SystemExit(f"--gguf writes dense llama models; {args.config} is not one")
    if args.gguf and cfg.vocab_size < 512:  # room for the byte pieces and some merges
        cfg = cfg.replace(vocab_size=512)
    model = family.init_params(cfg, seed=args.seed, device=args.device)
    if args.hf:
        print(f"{args.hf}: {write_hf(args.hf, model)}")
    if args.gguf:
        write_gguf(args.gguf, model, spm_vocab(cfg.vocab_size, args.seed))
        print(f"{args.gguf}: {os.path.getsize(args.gguf)} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
