"""Prompt-manifest I/O for offline batch generation (the port's own copy
of substratus_tpu/load/manifest.py, which it imports nothing from).

A batch-generation run (serve/batchgen.py) is driven by a JSONL
*manifest*: one JSON object per line, each describing one generation
request. The controller mounts it read-only under /content/data (the
same Dataset-artifact mount a finetune uses for its corpus), and the
run writes results as sharded JSONL under the run's artifact
directory. This module is the torch-free half of that contract: manifest
iteration, the completed-record scan that makes restarts exactly-once,
and shard naming.

Manifest record keys (all but one of prompt/tokens optional):

    {"id": "doc-17",            # echoed into the output record
     "prompt": "Summarize: …",  # text — encoded with the run's tokenizer
     "tokens": [1, 2, 3],       # OR pre-tokenized ids (wins over prompt)
     "max_tokens": 64,          # per-record generation budget
     "temperature": 0.0, "top_p": 1.0,
     "model": "tenant-a"}       # LoRA adapter id (multi-tenant serving)

The record's *index* is its 0-based line number in the manifest — the
stable identity resume keys on: an output line carries its index, and a
restarted run skips every index already present in a parseable
output line. A line torn by a mid-write kill fails to parse, is ignored
by the scan, and its record is simply generated again — into a NEW
shard (resumed runs never append to existing shards, so a torn tail can
never corrupt a fresh record).
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Iterator, List, Set, Tuple

SHARD_RE = re.compile(r"^shard-(\d{5})\.jsonl$")


def shard_name(idx: int) -> str:
    return f"shard-{idx:05d}.jsonl"


def record_prompt_tokens(rec: Dict[str, Any], tokenizer=None) -> List[int]:
    """The prompt token ids of one manifest record: explicit `tokens`
    win; otherwise `prompt` text through the run's tokenizer."""
    toks = rec.get("tokens")
    if toks is not None:
        if not isinstance(toks, list) or not all(
            isinstance(t, int) for t in toks
        ):
            raise ValueError(f"manifest 'tokens' must be a list of ints: {toks!r}")
        return list(toks)
    text = rec.get("prompt")
    if text is None:
        raise ValueError("manifest record needs 'prompt' or 'tokens'")
    if tokenizer is None:
        raise ValueError(
            "manifest record has text 'prompt' but the run has no tokenizer"
        )
    return tokenizer.encode(str(text))


def iter_manifest(path: str) -> Iterator[Tuple[int, Dict[str, Any]]]:
    """Yield (index, record) for every non-blank manifest line. The index
    is the line number (0-based, blanks included) so it never shifts when
    other lines change. A malformed line is a hard error naming it —
    silently skipping would violate exactly-once."""
    with open(path) as f:
        for lineno, line in enumerate(f):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except ValueError as e:
                raise ValueError(
                    f"{path}:{lineno + 1}: malformed manifest line ({e})"
                )
            if not isinstance(rec, dict):
                raise ValueError(
                    f"{path}:{lineno + 1}: manifest line is not an object"
                )
            yield lineno, rec


def count_records(path: str) -> int:
    n = 0
    with open(path) as f:
        for line in f:
            if line.strip():
                n += 1
    return n


def list_shards(out_dir: str) -> List[str]:
    if not os.path.isdir(out_dir):
        return []
    return sorted(
        os.path.join(out_dir, name)
        for name in os.listdir(out_dir)
        if SHARD_RE.match(name)
    )


def next_shard_index(out_dir: str) -> int:
    """First unused shard number. Resumed runs start a fresh shard past
    every existing one — appending after a torn tail line would glue new
    JSON onto the partial record and corrupt both."""
    last = -1
    for path in list_shards(out_dir):
        m = SHARD_RE.match(os.path.basename(path))
        last = max(last, int(m.group(1)))
    return last + 1


def completed_indices(out_dir: str) -> Set[int]:
    """Manifest indices already durably written across every shard.
    Unparseable lines (the torn tail of a killed run) and lines without
    an integer `index` are ignored — their records get regenerated."""
    done: Set[int] = set()
    for path in list_shards(out_dir):
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn tail of a killed run
                idx = rec.get("index") if isinstance(rec, dict) else None
                if isinstance(idx, int):
                    done.add(idx)
    return done


def write_manifest(path: str, records: List[Dict[str, Any]]) -> None:
    """Write a manifest (tests/bench helper; production manifests come
    from the Dataset artifact mount)."""
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
