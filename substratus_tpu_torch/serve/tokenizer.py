"""Tokenizers of the port's serving stack (port of
substratus_tpu/serve/tokenizer.py).

A checkpoint's tokenizer resolves as in the JAX package: the vocab a GGUF
file embeds (load/gguf.py's GGUFTokenizer), then tokenizer files beside
the weights (HFTokenizer, through transformers), then UTF-8 bytes
(ByteTokenizer: tests and random-weight configs). A GGUF's chat template
and an HF tokenizer's render /v1/chat/completions messages
(apply_chat_template, encoded by encode_templated); bytes have none, and
the server joins the messages into a generic transcript. The card's
machine has no transformers: a directory whose tokenizer files need it exits there,
naming the package, rather than serve bytes against a real vocabulary.
"""
from __future__ import annotations

import os
import shutil
from typing import List, Optional, Protocol

HF_TOKENIZER_FILES = ("tokenizer.json", "tokenizer.model", "tokenizer_config.json", "special_tokens_map.json")


class Tokenizer(Protocol):
    eos_id: int
    vocab_size: int

    def encode(self, text: str) -> List[int]: ...
    def decode(self, ids: List[int]) -> str: ...


class ByteTokenizer:
    """UTF-8 bytes as tokens; ids 0..255 are bytes, 256 is BOS, 257 is EOS."""

    bos_id = 256
    eos_id = 257
    vocab_size = 258

    def encode(self, text: str) -> List[int]:
        return [self.bos_id] + list(text.encode("utf-8"))

    def decode(self, ids: List[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", errors="replace")


class HFTokenizer:
    """A transformers tokenizer loaded from a checkpoint directory."""

    def __init__(self, path: str):
        try:
            from transformers import AutoTokenizer
        except ImportError:
            raise SystemExit(f"{path}: its tokenizer files need the transformers package, which is not installed; "
                             "the port will not serve bytes against a real vocabulary") from None
        self._tok = AutoTokenizer.from_pretrained(path)
        self.eos_id = self._tok.eos_token_id
        self.vocab_size = len(self._tok)

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text)

    def decode(self, ids: List[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)

    def apply_chat_template(self, messages) -> Optional[str]:
        """Rendered prompt, or None when the checkpoint ships no template
        (callers fall back to the generic transcript)."""
        if not getattr(self._tok, "chat_template", None):
            return None
        return self._tok.apply_chat_template(messages, tokenize=False, add_generation_prompt=True)

    def encode_templated(self, text: str) -> List[int]:
        """Encode a template-rendered prompt: the template already laid
        down BOS and the special tokens, so none are added again."""
        return self._tok.encode(text, add_special_tokens=False)


def _has_hf_tokenizer(path: str) -> bool:
    return os.path.isdir(path) and any(os.path.exists(os.path.join(path, f)) for f in HF_TOKENIZER_FILES[:3])


def load_tokenizer(path: Optional[str]) -> Tokenizer:
    """The tokenizer of a model path (None: bytes)."""
    if path is None:
        return ByteTokenizer()
    # A GGUF checkpoint carries its own vocab: prefer the embedded
    # SentencePiece tokenizer, then tokenizer files sitting next to it.
    # An embedded vocab we CANNOT run (BPE) is only an error when no
    # sibling tokenizer files can stand in.
    from substratus_tpu_torch.load.gguf import UnsupportedGGUFTokenizer, resolve_gguf, tokenizer_from_gguf

    gguf = resolve_gguf(path, weights=False)
    unsupported: Optional[UnsupportedGGUFTokenizer] = None
    if gguf is not None:
        try:
            tok = tokenizer_from_gguf(gguf)
        except UnsupportedGGUFTokenizer as e:
            tok, unsupported = None, e
        if tok is not None:
            return tok
        path = os.path.dirname(gguf) or "."
    if _has_hf_tokenizer(path):
        return HFTokenizer(path)
    if unsupported is not None:
        # no stand-in found: serving raw bytes against a real vocab would
        # be silent garbage — fail with the actionable message instead
        raise SystemExit(str(unsupported))
    return ByteTokenizer()


def copy_tokenizer(model_path: str, out: str) -> bool:
    """Carry a model's tokenizer into an artifact directory `out`, so that
    load_tokenizer(out) finds it: a GGUF vocab as a metadata-only
    tokenizer.gguf sidecar, tokenizer files as copies. False when the
    model has neither (it serves with bytes)."""
    from substratus_tpu_torch.load.gguf import read_gguf, resolve_gguf, write_tokenizer_gguf

    gguf = resolve_gguf(model_path, weights=False)
    if gguf is not None and write_tokenizer_gguf(os.path.join(out, "tokenizer.gguf"),
                                                 read_gguf(gguf, with_tensors=False)[0]):
        return True
    src = os.path.dirname(gguf) if gguf is not None else model_path
    copied = [f for f in HF_TOKENIZER_FILES if os.path.isfile(os.path.join(src, f))] if os.path.isdir(src) else []
    for fname in copied:
        shutil.copy(os.path.join(src, fname), os.path.join(out, fname))
    return bool(copied)
