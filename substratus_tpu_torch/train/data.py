"""Training data pipeline (the port's own copy of
substratus_tpu/train/data.py, one process): files -> packed fixed-shape
token batches. Documents are tokenized, joined with EOS and packed into
dense [batch, seq_len] blocks: static shapes and no padding.

Supported inputs (a directory or a single file):
  *.jsonl  -- {"text": ...} or {"prompt": ..., "completion": ...} per line
  *.txt    -- plain text, one document per file
  *.npy    -- a pre-tokenized 1-D int array (a concatenated token stream)

Per-process sharding of the sources waits for multi-GPU training (ROADMAP
Queue 1, multi-GPU). For the same files and seed the batches are the JAX
package's, block for block.
"""
from __future__ import annotations

import json
import os
from typing import Iterator, List

import numpy as np


def _walk(path: str) -> List[str]:
    """Every file under `path` in a fixed order (sorted directories and
    names), or `path` itself."""
    if not os.path.isdir(path):
        return [path]
    paths: List[str] = []
    for root, dirs, files in os.walk(path):
        dirs.sort()
        paths.extend(os.path.join(root, f) for f in sorted(files))
    return paths


def _iter_documents(path: str) -> Iterator[str]:
    for p in _walk(path):
        if p.endswith(".jsonl"):
            with open(p) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    row = json.loads(line)
                    if "text" in row:
                        yield row["text"]
                    elif "prompt" in row:
                        yield str(row["prompt"]) + str(row.get("completion", ""))
        elif p.endswith(".txt"):
            with open(p) as f:
                yield f.read()


def _token_stream(path: str, tokenizer, eos_id: int) -> np.ndarray:
    """The corpus as one int32 stream: pre-tokenized .npy sources first,
    then each text document's tokens followed by EOS."""
    chunks: List[np.ndarray] = [np.load(p).astype(np.int32).reshape(-1)
                                for p in _walk(path) if p.endswith(".npy")]
    for doc in _iter_documents(path):
        chunks.append(np.asarray(tokenizer.encode(doc) + [eos_id], np.int32))
    if not chunks:
        raise FileNotFoundError(f"no training documents found under {path}")
    return np.concatenate(chunks)


class PackedDataset:
    """Infinite iterator of {"tokens": [B, S] int32, "weights": [B, S]
    f32} batches: each row a block of seq_len tokens drawn at random (with
    replacement) from the packed stream by np.random.default_rng(seed)."""

    def __init__(self, path: str, tokenizer, batch_size: int, seq_len: int, seed: int = 0):
        stream = _token_stream(path, tokenizer, tokenizer.eos_id)
        n_blocks = len(stream) // seq_len
        if n_blocks == 0:
            # Tile tiny corpora up to one full block so smoke datasets work.
            stream = np.tile(stream, seq_len // max(1, len(stream)) + 1)
            n_blocks = len(stream) // seq_len
        self.blocks = stream[: n_blocks * seq_len].reshape(n_blocks, seq_len)
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.n_tokens = int(self.blocks.size)

    def __iter__(self):
        return self

    def __next__(self):
        idx = self.rng.integers(0, len(self.blocks), size=self.batch_size)
        tokens = self.blocks[idx]
        return {"tokens": tokens.astype(np.int32), "weights": np.ones_like(tokens, np.float32)}
