"""Tokenizer for the port's serving stack (copy of the JAX package's
ByteTokenizer). Checkpoint tokenizers (HF, GGUF) wait until the port
loads checkpoints: ROADMAP Queue 1."""
from __future__ import annotations

from typing import List, Optional


class ByteTokenizer:
    """UTF-8 bytes as tokens; ids 0..255 are bytes, 256 is BOS, 257 is EOS."""

    bos_id = 256
    eos_id = 257
    vocab_size = 258

    def encode(self, text: str) -> List[int]:
        return [self.bos_id] + list(text.encode("utf-8"))

    def decode(self, ids: List[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", errors="replace")


def load_tokenizer(path: Optional[str]) -> ByteTokenizer:
    if path is not None:
        raise NotImplementedError(
            "checkpoint tokenizers are not ported yet (random-weight --config only): ROADMAP Queue 1"
        )
    return ByteTokenizer()
