"""GGUF checkpoint import (port of substratus_tpu/load/gguf.py): a
llama.cpp model file served or finetuned by the port.

The file is parsed (v2/v3: header, metadata, tensor infos) and its data
section memory-mapped. ``load_gguf`` takes it tensor by tensor: the raw
blocks go to the model's device, dequantize there with torch ops (F32,
F16, Q4_0, Q4_1, Q5_0, Q8_0; non-F32 tensors end in f16, as the JAX
``read_gguf`` leaves them), q/k projections un-permute from llama.cpp's
rope layout to the HF one, and load/hf.py's ``copy_hf_state`` writes each
into an allocated ``Llama`` in the port's layout and dtype. No dequantized
copy of the whole model is ever held on the host. The values are the JAX
loader's bit for bit: a block is f16 d -> f32 times its integer codes in
f32 (one rounding), then f16, then the model dtype (round to nearest even).

``read_gguf`` returns every tensor dequantized as numpy, as the JAX
function does (tests, tools). ``GGUFTokenizer`` is the embedded
SentencePiece vocabulary with the JAX class's pure-Python heap merge (the
JAX class may also drive a native library that gives the same ids).

Format notes (GGUF spec, ggml/docs/gguf.md):
  header: magic "GGUF", version u32, n_tensors u64, n_kv u64
  kv: string key, u32 value-type, value (strings u64-length-prefixed;
      arrays are [elem-type u32][count u64][elems])
  tensor infos: name, n_dims u32, dims u64[n] (ne[0] = contiguous dim),
      ggml type u32, offset u64 (relative to the aligned data section)
  data: aligned to general.alignment (default 32)
"""
from __future__ import annotations

import glob
import heapq
import os
import struct
from dataclasses import dataclass
from typing import Any, BinaryIO, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from substratus_tpu_torch.models.llama import Llama, LlamaConfig
from substratus_tpu_torch.utils.device import DeviceLike, resolve_device

GGUF_MAGIC = b"GGUF"

# ggml tensor types (type id -> (block elements, block bytes))
GGML_F32 = 0
GGML_F16 = 1
GGML_Q4_0 = 2
GGML_Q4_1 = 3
GGML_Q5_0 = 6
GGML_Q8_0 = 8
_BLOCK = {
    GGML_F32: (1, 4),
    GGML_F16: (1, 2),
    GGML_Q4_0: (32, 2 + 16),
    GGML_Q4_1: (32, 2 + 2 + 16),
    GGML_Q5_0: (32, 2 + 4 + 16),
    GGML_Q8_0: (32, 2 + 32),
}

# gguf metadata value types
_SCALAR_FMT = {
    0: "B", 1: "b", 2: "<H", 3: "<h", 4: "<I", 5: "<i", 6: "<f",
    7: "?", 10: "<Q", 11: "<q", 12: "<d",
}
_T_STRING = 8
_T_ARRAY = 9


def _read(f: BinaryIO, fmt: str):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))[0]


def _read_string(f: BinaryIO) -> str:
    n = _read(f, "<Q")
    return f.read(n).decode("utf-8", "replace")


def _read_value(f: BinaryIO, vtype: int):
    if vtype in _SCALAR_FMT:
        return _read(f, _SCALAR_FMT[vtype])
    if vtype == _T_STRING:
        return _read_string(f)
    if vtype == _T_ARRAY:
        etype = _read(f, "<I")
        count = _read(f, "<Q")
        return [_read_value(f, etype) for _ in range(count)]
    raise ValueError(f"gguf: unknown metadata value type {vtype}")


def _unsupported(ggml_type: int) -> str:
    return (f"unsupported type {ggml_type} (supported: F32/F16/Q4_0/Q4_1/Q5_0/Q8_0; K-quants like Q4_K are not — "
            "re-export with a supported quantization)")


def _dequantize(raw: torch.Tensor, ggml_type: int, n: int) -> torch.Tensor:
    """GGML blocks (a uint8 tensor, on any device) -> float32 [n] there,
    with the JAX function's arithmetic: each value one f32 product of its
    integer code and the block's f16 scale (Q4_1: then plus its f16 min)."""
    if ggml_type not in _BLOCK:
        raise ValueError(f"gguf: {_unsupported(ggml_type)}")
    if ggml_type == GGML_F32:
        return raw.view(torch.float32)[:n].clone()
    if ggml_type == GGML_F16:
        return raw.view(torch.float16)[:n].float()
    qk, bsz = _BLOCK[ggml_type]
    blocks = raw[: n // qk * bsz].view(n // qk, bsz)
    d = blocks[:, :2].contiguous().view(torch.float16).float()  # [nb, 1]
    if ggml_type == GGML_Q8_0:
        q = blocks[:, 2:].contiguous().view(torch.int8)
        return (q.float() * d).reshape(-1)
    if ggml_type == GGML_Q4_1:
        m = blocks[:, 2:4].contiguous().view(torch.float16).float()
        qs = blocks[:, 4:]
        q = torch.cat([qs & 0x0F, qs >> 4], dim=1)  # [nb, 32]: j, j+16 halves
        return (q.float() * d + m).reshape(-1)
    if ggml_type == GGML_Q4_0:
        qs = blocks[:, 2:]
        q = torch.cat([qs & 0x0F, qs >> 4], dim=1).to(torch.int8) - 8
        return (q.float() * d).reshape(-1)
    # Q5_0: a u32 of fifth bits (little-endian), then the low nibbles.
    qh = blocks[:, 2:6].long()
    qh = qh[:, 0] | qh[:, 1] << 8 | qh[:, 2] << 16 | qh[:, 3] << 24
    bit = (qh[:, None] >> torch.arange(32, device=raw.device)) & 1  # [nb, 32]
    qs = blocks[:, 6:].long()
    q = torch.cat([(qs & 0x0F) | bit[:, :16] << 4, (qs >> 4) | bit[:, 16:] << 4], dim=1) - 16
    return (q.float() * d).reshape(-1)


@dataclass(frozen=True)
class GGUFTensor:
    """A tensor of the file: its numpy/torch shape (reversed ne), GGML
    type and the absolute byte range of its blocks."""
    name: str
    shape: Tuple[int, ...]
    ggml_type: int
    start: int
    nbytes: int

    @property
    def numel(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))


# (path, mtime) -> metadata dict. The serve startup parses the same file
# for weights and again for the tokenizer; vocab arrays are the bulk of
# the kv section and decode via per-element struct calls, so parse once.
_META_CACHE: Dict[Tuple[str, float], Dict[str, Any]] = {}


def _parse(path: str, with_tensors: bool = True) -> Tuple[Dict[str, Any], List[GGUFTensor]]:
    """(metadata, tensor infos) of a .gguf file; only the metadata (cached
    per (path, mtime)) when with_tensors is False."""
    cache_key = (path, os.path.getmtime(path))
    cached = _META_CACHE.get(cache_key)
    if cached is not None and not with_tensors:
        return cached, []
    with open(path, "rb") as f:
        if f.read(4) != GGUF_MAGIC:
            raise ValueError(f"{path}: not a GGUF file")
        version = _read(f, "<I")
        if version not in (2, 3):
            raise ValueError(f"{path}: unsupported GGUF version {version}")
        n_tensors = _read(f, "<Q")
        n_kv = _read(f, "<Q")
        meta: Dict[str, Any] = {}
        for _ in range(n_kv):
            key = _read_string(f)
            vtype = _read(f, "<I")
            meta[key] = _read_value(f, vtype)
        _META_CACHE.clear()  # one model per process; don't hoard vocabs
        _META_CACHE[cache_key] = meta
        if not with_tensors:
            return meta, []
        raw_infos = []
        for _ in range(n_tensors):
            name = _read_string(f)
            n_dims = _read(f, "<I")
            ne = [_read(f, "<Q") for _ in range(n_dims)]
            raw_infos.append((name, ne, _read(f, "<I"), _read(f, "<Q")))
        align = int(meta.get("general.alignment", 32))
        data_start = (f.tell() + align - 1) // align * align
    infos = []
    for name, ne, ggml_type, offset in raw_infos:
        if ggml_type not in _BLOCK:
            raise ValueError(f"gguf: tensor {name!r} has {_unsupported(ggml_type)}")
        qk, bsz = _BLOCK[ggml_type]
        n = int(np.prod(ne, dtype=np.int64))
        infos.append(GGUFTensor(name, tuple(reversed(ne)), ggml_type, data_start + offset, n // qk * bsz))
    return meta, infos


def _tensors(path: str, infos: List[GGUFTensor], device: torch.device) -> Iterator[Tuple[GGUFTensor, torch.Tensor]]:
    """Each tensor dequantized on `device` in its file shape: f32 for F32
    tensors, f16 for the rest. The blocks come from a memory map of the
    file, one tensor at a time."""
    mm = np.memmap(path, dtype=np.uint8, mode="c")  # copy-on-write: torch may wrap it, nothing writes it
    for info in infos:
        raw = torch.from_numpy(mm[info.start:info.start + info.nbytes])
        # A copy either way: to the device, or a fresh (aligned) host tensor.
        raw = raw.to(device) if device.type != "cpu" else raw.clone()
        w = _dequantize(raw, info.ggml_type, info.numel)
        if info.ggml_type != GGML_F32:
            w = w.to(torch.float16)  # as the JAX read_gguf: the source never had more precision
        yield info, w.reshape(info.shape)


def read_gguf(path: str, with_tensors: bool = True) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """Parse a .gguf file -> (metadata dict, {tensor name: ndarray}), the
    JAX function's result: arrays in the llama.cpp/torch orientation
    ([out_features, in_features] for matmuls), F32 tensors f32 and the
    rest dequantized to f16. with_tensors=False parses only the metadata
    (cached per (path, mtime))."""
    meta, infos = _parse(path, with_tensors)
    if not with_tensors:
        return meta, {}
    return meta, {info.name: w.numpy() for info, w in _tensors(path, infos, torch.device("cpu"))}


def _unpermute_qk(w: torch.Tensor, n_head: int) -> torch.Tensor:
    """Invert llama.cpp's rope permutation on a q/k projection [out, in]:
    its HF->GGUF conversion wrote each head's rows as
    reshape(n_head, 2, h/2) -> swap(1, 2); the port's models (as the
    JAX package's) use HF's rotate-half layout."""
    out, dim = w.shape
    hd = out // n_head
    return w.reshape(n_head, hd // 2, 2, dim).transpose(1, 2).reshape(out, dim)


# gguf tensor name -> HF state-dict name ({i} = layer index)
_NAME_MAP = {
    "token_embd.weight": "embed_tokens.weight",
    "output_norm.weight": "norm.weight",
    "output.weight": "lm_head.weight",
    "blk.{i}.attn_norm.weight": "layers.{i}.input_layernorm.weight",
    "blk.{i}.attn_q.weight": "layers.{i}.self_attn.q_proj.weight",
    "blk.{i}.attn_k.weight": "layers.{i}.self_attn.k_proj.weight",
    "blk.{i}.attn_v.weight": "layers.{i}.self_attn.v_proj.weight",
    "blk.{i}.attn_output.weight": "layers.{i}.self_attn.o_proj.weight",
    "blk.{i}.ffn_norm.weight": "layers.{i}.post_attention_layernorm.weight",
    "blk.{i}.ffn_gate.weight": "layers.{i}.mlp.gate_proj.weight",
    "blk.{i}.ffn_up.weight": "layers.{i}.mlp.up_proj.weight",
    "blk.{i}.ffn_down.weight": "layers.{i}.mlp.down_proj.weight",
}


def _hf_name(gname: str) -> Optional[str]:
    """The HF name of a gguf tensor; None for what is derived, not loaded
    (rope frequency tables)."""
    parts = gname.split(".")
    if parts[0] == "blk":
        hf = _NAME_MAP.get(".".join(["blk", "{i}"] + parts[2:]))
        return None if hf is None else hf.format(i=parts[1])
    return _NAME_MAP.get(gname)


def config_from_gguf(path: str, meta: Dict[str, Any], infos: List[GGUFTensor],
                     dtype: torch.dtype = torch.bfloat16) -> LlamaConfig:
    """The LlamaConfig of a llama-architecture file (the Llama/Mistral
    GGUF ecosystem); other architectures, rope scaling and a mixture of
    experts raise (the JAX GGUF loader maps no expert tensors either: a
    Mixtral loads from its HF directory)."""
    arch = meta.get("general.architecture")
    if arch != "llama":
        raise ValueError(f"{path}: gguf architecture {arch!r} unsupported (llama only)")
    p = "llama."
    if int(meta.get(p + "expert_count", 0) or 0) > 0:
        raise ValueError(f"{path}: a mixture-of-experts GGUF (expert_count={meta[p + 'expert_count']}) is not "
                         "mapped (the GGUF loader maps dense llama tensors, as the JAX package's does); load "
                         "the model's HF directory")
    scaling = meta.get(p + "rope.scaling.type")
    if scaling and scaling != "none":
        # loud-not-silent: serving to an extended context with unscaled
        # rope would produce garbage past the base window
        raise ValueError(f"{path}: rope scaling {scaling!r} is not supported — the model would misbehave beyond "
                         "its base context")
    shapes = {info.name: info.shape for info in infos}
    n_heads = int(meta[p + "attention.head_count"])
    return LlamaConfig(
        vocab_size=int(shapes["token_embd.weight"][0]),
        dim=int(meta[p + "embedding_length"]),
        n_layers=int(meta[p + "block_count"]),
        n_heads=n_heads,
        n_kv_heads=int(meta.get(p + "attention.head_count_kv", n_heads)),
        head_dim=int(meta[p + "attention.key_length"]) if p + "attention.key_length" in meta else None,
        hidden_dim=int(meta[p + "feed_forward_length"]),
        max_seq_len=int(meta.get(p + "context_length", 4096)),
        rope_theta=float(meta.get(p + "rope.freq_base", 10000.0)),
        norm_eps=float(meta.get(p + "attention.layer_norm_rms_epsilon", 1e-5)),
        tie_embeddings="output.weight" not in shapes,
        dtype=dtype,
    )


def load_gguf(path: str, dtype: torch.dtype = torch.bfloat16, device: DeviceLike = None) -> Tuple[LlamaConfig, Llama]:
    """.gguf file -> (LlamaConfig, Llama on `device`), ready for the engine
    (cuda unless the caller asks for the CPU). Each tensor is dequantized
    on the device and copied into the allocated model before the next is
    read."""
    from substratus_tpu_torch.load.hf import copy_hf_state

    device = resolve_device(device)
    meta, infos = _parse(path)
    cfg = config_from_gguf(path, meta, infos, dtype)
    model = Llama(cfg, device=device)

    def hf_items():
        for info, w in _tensors(path, [i for i in infos if _hf_name(i.name) is not None], device):
            part = info.name.split(".")[2] if info.name.startswith("blk.") else ""
            if part in ("attn_q", "attn_k"):
                w = _unpermute_qk(w, cfg.n_heads if part == "attn_q" else cfg.n_kv_heads)
            yield _hf_name(info.name), w

    copy_hf_state(model, hf_items())
    return cfg, model


class GGUFTokenizer:
    """SentencePiece-BPE tokenizer from the GGUF-embedded vocab
    (tokenizer.ggml.tokens/scores/token_type + bos/eos ids) — the same
    greedy highest-score bigram merge llama.cpp's SPM tokenizer runs, so
    a .gguf file serves standalone with its own real tokenizer.

    Token types follow the sentencepiece proto: 1 normal, 2 unknown,
    3 control (skipped on decode), 6 byte (`<0xXX>` pieces). The file's
    jinja chat template (tokenizer.chat_template) renders chat messages
    (apply_chat_template) for /v1/chat/completions."""

    def __init__(self, meta: Dict[str, Any]):
        t = "tokenizer.ggml."
        self.tokens: List[str] = meta[t + "tokens"]
        n = len(self.tokens)
        self.scores = meta.get(t + "scores") or [0.0] * n
        self.types = meta.get(t + "token_type") or [1] * n
        self.bos_id = int(meta.get(t + "bos_token_id", 1))
        self.eos_id = int(meta.get(t + "eos_token_id", 2))
        self.unk_id = int(meta.get(t + "unknown_token_id", 0))
        self.chat_template: Optional[str] = meta.get("tokenizer.chat_template")
        self._compiled_template = None
        self._special_re = None
        self.vocab_size = n
        self._index = {tok: i for i, tok in enumerate(self.tokens)}
        self._byte = {}
        for i, (tok, ty) in enumerate(zip(self.tokens, self.types)):
            if ty == 6 and tok.startswith("<0x") and tok.endswith(">"):
                self._byte[int(tok[3:-1], 16)] = i

    def encode(self, text: str) -> List[int]:
        """BOS + greedy merge of the SP-normalized text (spaces->U+2581,
        one dummy prefix)."""
        return [self.bos_id] + self._encode_norm("▁" + text.replace(" ", "▁"))

    def _encode_norm(self, norm: str) -> List[int]:
        """Greedy highest-score bigram merge (llama.cpp llm_tokenizer_spm)
        of an ALREADY-normalized piece string, no BOS, via a
        lazy-invalidated heap: O(n log n), safe on the request hot path
        for long prompts."""
        pieces = list(norm)
        n = len(pieces)
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        alive = [True] * n

        def push(heap, i):
            j = nxt[i]
            if j >= n:
                return
            cand = pieces[i] + pieces[j]
            idx = self._index.get(cand)
            if idx is not None:
                # ties broken leftmost, like the linear scan
                heapq.heappush(heap, (-self.scores[idx], i, cand, idx))

        heap: List[Tuple[float, int, str, int]] = []
        for i in range(n - 1):
            push(heap, i)
        while heap:
            _, i, cand, idx = heapq.heappop(heap)
            j = nxt[i] if i < n else n
            # lazy invalidation: stale entries no longer describe the list
            if not (i < n and alive[i] and j < n and alive[j] and pieces[i] + pieces[j] == cand):
                continue
            pieces[i] = cand
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[j] < n:
                prev[nxt[j]] = i
            if prev[i] >= 0:
                push(heap, prev[i])
            push(heap, i)
        out: List[int] = []
        i = 0
        while i < n:
            if not alive[i]:
                i += 1
                continue
            idx = self._index.get(pieces[i])
            if idx is not None:
                out.append(idx)
            else:
                for b in pieces[i].encode("utf-8"):  # byte fallback
                    out.append(self._byte.get(b, self.unk_id))
            i = nxt[i]
        return out

    def apply_chat_template(self, messages) -> Optional[str]:
        """Render with the GGUF's embedded jinja chat template (the format
        the checkpoint was trained on; tokenizer.chat_template). None when
        the file carries no template (callers fall back to the generic
        transcript)."""
        if not self.chat_template:
            return None
        if self._compiled_template is None:
            # Sandboxed: the template ships inside a model file, as
            # transformers treats it. Compiled once (this runs per chat
            # request), with the helpers transformers guarantees
            # (raise_exception, strftime_now, tojson), so real Mistral,
            # Zephyr and Llama-3 templates render. jinja2 is a requirement
            # of the torch wheel.
            import datetime
            import json as _json

            from jinja2.sandbox import ImmutableSandboxedEnvironment

            env = ImmutableSandboxedEnvironment(keep_trailing_newline=True, autoescape=False)

            def raise_exception(message):
                raise ValueError(f"chat template error: {message}")

            env.globals["raise_exception"] = raise_exception
            env.globals["strftime_now"] = lambda fmt: datetime.datetime.now().strftime(fmt)
            env.filters["tojson"] = lambda v, **kw: _json.dumps(v, **kw)
            self._compiled_template = env.from_string(self.chat_template)
        bos = self.tokens[self.bos_id] if self.bos_id < self.vocab_size else ""
        eos = self.tokens[self.eos_id] if self.eos_id < self.vocab_size else ""
        return self._compiled_template.render(messages=messages, add_generation_prompt=True, bos_token=bos,
                                              eos_token=eos)

    def encode_templated(self, text: str) -> List[int]:
        """Encode a TEMPLATE-RENDERED prompt: control-token strings the
        template injected ('<s>', '<|im_start|>', ...) map to their ids
        instead of being SPM-merged as literal characters, and no BOS is
        auto-prepended beyond what the template itself rendered
        (llama.cpp's tokenize with parse_special=true)."""
        import re

        if self._special_re is None:
            specials = sorted((t for t, ty in zip(self.tokens, self.types) if ty == 3), key=len, reverse=True)
            self._special_re = re.compile(
                "(" + "|".join(map(re.escape, specials)) + ")"
            ) if specials else re.compile(r"(?!x)x")  # never matches
        out: List[int] = []
        first_segment = True
        for part in self._special_re.split(text):
            if not part:
                continue
            idx = self._index.get(part)
            if idx is not None and self.types[idx] == 3:
                out.append(idx)
                first_segment = False
                continue
            # SP-normalize the segment; the dummy ▁ prefix applies only
            # at the very start of raw text, never mid-template
            norm = part.replace(" ", "▁")
            if first_segment:
                norm = "▁" + norm
                first_segment = False
            out.extend(self._encode_norm(norm))
        return out

    def decode(self, ids: List[int]) -> str:
        buf = bytearray()
        for i in ids:
            if not 0 <= i < self.vocab_size or self.types[i] == 3:
                continue  # control tokens (bos/eos) don't render
            if self.types[i] == 6:
                buf += bytes([int(self.tokens[i][3:-1], 16)])
            else:
                buf += self.tokens[i].encode("utf-8")
        text = buf.decode("utf-8", "replace").replace("▁", " ")
        # strip exactly the ONE SentencePiece dummy-prefix space — more
        # would eat real leading whitespace (indented code continuations)
        return text[1:] if text.startswith(" ") else text


def _gguf_string(x: str) -> bytes:
    b = x.encode("utf-8")
    return struct.pack("<Q", len(b)) + b


def gguf_value(v) -> bytes:
    """A metadata value as GGUF writes it (type u32, then the value):
    bool, str, float (f32), int (i32) or a list of one of str/int/float."""
    if isinstance(v, bool):
        return struct.pack("<I", 7) + struct.pack("?", v)
    if isinstance(v, str):
        return struct.pack("<I", _T_STRING) + _gguf_string(v)
    if isinstance(v, float):
        return struct.pack("<I", 6) + struct.pack("<f", v)
    if isinstance(v, int):
        return struct.pack("<I", 5) + struct.pack("<i", v)
    if isinstance(v, list):
        if all(isinstance(e, str) for e in v):
            etype, enc = _T_STRING, _gguf_string
        elif all(isinstance(e, int) and not isinstance(e, bool) for e in v):
            etype, enc = 5, lambda e: struct.pack("<i", e)
        else:
            etype, enc = 6, lambda e: struct.pack("<f", float(e))
        return struct.pack("<I", _T_ARRAY) + struct.pack("<I", etype) + struct.pack("<Q", len(v)) + b"".join(
            enc(e) for e in v)
    raise ValueError(f"gguf: cannot serialize metadata value {v!r}")


def gguf_header(meta: Dict[str, Any], n_tensors: int) -> bytes:
    """A GGUF v3 header and metadata section for `n_tensors` tensors."""
    buf = bytearray(GGUF_MAGIC + struct.pack("<I", 3) + struct.pack("<Q", n_tensors) + struct.pack("<Q", len(meta)))
    for k, v in meta.items():
        buf += _gguf_string(k) + gguf_value(v)
    return bytes(buf)


def write_tokenizer_gguf(path: str, meta: Dict[str, Any]) -> bool:
    """Write a metadata-only .gguf holding a source file's tokenizer.* (+
    architecture) keys — the artifact-sidecar form of the embedded vocab,
    so an artifact trained from a GGUF base still serves with the model's
    real tokenizer (load_tokenizer resolves any *.gguf in the artifact
    dir, metadata-only). Returns False when the source had no tokenizer."""
    keep = {k: v for k, v in meta.items() if k.startswith("tokenizer.") or k == "general.architecture"}
    if "tokenizer.ggml.tokens" not in keep:
        return False
    with open(path, "wb") as f:
        f.write(gguf_header(keep, 0))
    return True


class UnsupportedGGUFTokenizer(ValueError):
    """The file embeds a vocab this importer can't drive (e.g. a BPE
    'gpt2' vocab — Llama-3-era GGUFs). Serving with a byte fallback would
    silently produce garbage, so callers must surface this."""


def tokenizer_from_gguf(path: str) -> Optional[GGUFTokenizer]:
    """The embedded tokenizer of a .gguf file; None when the file carries
    no vocab at all (smoke files). Raises UnsupportedGGUFTokenizer for a
    vocab model we can't run — loud-not-silent, a mistokenized prompt is
    garbage out with no error anywhere else."""
    meta, _ = read_gguf(path, with_tensors=False)
    model = meta.get("tokenizer.ggml.model")
    if "tokenizer.ggml.tokens" not in meta and model is None:
        return None
    if model not in ("llama", "spm"):
        raise UnsupportedGGUFTokenizer(
            f"{path}: embedded tokenizer model {model!r} unsupported (SentencePiece only) — place a tokenizer.json "
            "next to the file to serve it"
        )
    if "tokenizer.ggml.tokens" not in meta:
        return None
    return GGUFTokenizer(meta)


def gguf_has_tensors(path: str) -> bool:
    """False only for a VALID gguf header declaring zero tensors — the
    metadata-only tokenizer sidecar write_tokenizer_gguf leaves inside
    artifacts. Unreadable/corrupt files return True so they still route
    to read_gguf, whose bad-magic error is the clearer one.
    Header: magic(4) version(4) tensor_count(8)."""
    try:
        with open(path, "rb") as f:
            head = f.read(16)
        if len(head) < 16 or head[:4] != GGUF_MAGIC:
            return True
        return struct.unpack("<Q", head[8:16])[0] > 0
    except OSError:
        return True


def resolve_gguf_or_exit(path: str) -> Optional[str]:
    """resolve_gguf(strict=True) with the one-line SystemExit every
    entrypoint (train/serve) wants instead of a traceback."""
    try:
        return resolve_gguf(path, strict=True)
    except (FileNotFoundError, ValueError) as e:
        raise SystemExit(str(e))


def resolve_gguf(path: str, strict: bool = False, weights: bool = True) -> Optional[str]:
    """The .gguf file behind a model path, or None for non-GGUF paths.

    strict=True raises on the ambiguous/missing cases (a path explicitly
    naming .gguf must exist; a dir with several .gguf files is a split
    checkpoint we don't support); strict=False returns None for them —
    the tokenizer resolver shares this so path semantics can't drift.

    weights=True (the checkpoint path) ignores metadata-only files when
    scanning a directory — an artifact holds a tokenizer.gguf sidecar that
    must not shadow its weights — and raises on an explicitly named
    metadata-only file. The tokenizer resolver passes weights=False: the
    sidecar is exactly what it wants."""
    if path.endswith(".gguf"):
        if os.path.isfile(path):
            if weights and not gguf_has_tensors(path):
                if strict:
                    raise ValueError(f"{path}: metadata-only GGUF (no tensors) — this is a tokenizer sidecar, not a "
                                     "weight checkpoint")
                return None
            return path
        if strict:
            raise FileNotFoundError(f"no such file: {path}")
        return None
    if os.path.isdir(path):
        found = sorted(glob.glob(os.path.join(path, "*.gguf")))
        if weights:
            found = [f for f in found if gguf_has_tensors(f)]
        if len(found) > 1:
            if strict:
                raise ValueError(f"{path}: {len(found)} .gguf files found — pass the exact file (split/multi-shard "
                                 "GGUF is unsupported)")
            return None
        if found:
            return found[0]
    return None
