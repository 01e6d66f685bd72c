"""Episode buffer and batch assembly for the RL loop (port of
substratus_tpu/rl/buffer.py, numpy for numpy).

The actors' sink thread deposits scored episodes here (through the
batchgen ``record_hook``), and the learner drains them into fixed-shape
``{"tokens", "weights"}`` batches, the contract ``Trainer.train_step``
already speaks, with the per-token weights carrying the reward:

* prompt positions and padding get weight 0 (the learner never trains
  on the prompt it was given);
* completion positions get the episode's normalized reward weight:
  rewards shifted positive (min-shift + eps) and scaled to mean 1.0
  across the drain, so the loss stays comparable to supervised training
  and a uniform-reward drain is plain cross-entropy (reward-weighted
  regression).

Fixed [B, S] shapes keep the learner's step the same shape every update.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, Iterator, List

import numpy as np


@dataclass
class Episode:
    """One generated completion with its scalar reward."""

    prompt_tokens: List[int]
    completion_tokens: List[int]
    reward: float
    meta: Dict = field(default_factory=dict)


class ReplayBuffer:
    """Thread-safe episode accumulator.

    ``add`` is called from the batchgen sink thread while the learner's
    thread may drain: a lock (never held across I/O) covers the list
    swap. On-policy: ``drain`` hands over everything and empties the
    buffer; there is no replay across rounds."""

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._episodes: List[Episode] = []
        self.dropped = 0

    def add(self, episode: Episode) -> None:
        with self._lock:
            if len(self._episodes) >= self.capacity:
                # Newest wins on overflow: stale on-policy episodes are
                # the least valuable.
                self._episodes.pop(0)
                self.dropped += 1
            self._episodes.append(episode)

    def __len__(self) -> int:
        with self._lock:
            return len(self._episodes)

    def drain(self) -> List[Episode]:
        with self._lock:
            out, self._episodes = self._episodes, []
            return out


def reward_weights(episodes: List[Episode]) -> List[float]:
    """Per-episode loss weights from raw rewards: shifted positive
    (min-shift + eps, so the worst episode keeps a little weight) and
    normalized to mean 1.0; all-equal rewards give 1.0 each (plain
    cross-entropy)."""
    rewards = [float(ep.reward) for ep in episodes]
    if not rewards:
        return []
    lo, hi = min(rewards), max(rewards)
    if hi - lo < 1e-9:
        return [1.0] * len(rewards)
    eps = 0.05 * (hi - lo)
    shifted = [r - lo + eps for r in rewards]
    mean = sum(shifted) / len(shifted)
    return [s / mean for s in shifted]


def episodes_to_batches(
    episodes: List[Episode],
    batch_size: int,
    seq_len: int,
    pad_id: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Episodes -> fixed-shape Trainer batches.

    Every batch is exactly [batch_size, seq_len]: long episodes truncate,
    and the last ragged batch pads with filler rows (the last episode's
    tokens at weight 0: fixed shapes, nothing learned). Yields nothing
    for an empty drain."""
    if batch_size < 1 or seq_len < 2:
        raise ValueError("batch_size >= 1 and seq_len >= 2 required")
    if not episodes:
        return
    weights = reward_weights(episodes)
    rows = []
    for ep, w in zip(episodes, weights):
        toks = (list(ep.prompt_tokens) + list(ep.completion_tokens))[:seq_len]
        row_t = np.full((seq_len,), pad_id, np.int32)
        row_t[: len(toks)] = np.asarray(toks, np.int32)
        row_w = np.zeros((seq_len,), np.float32)
        # The completion positions only: the loss reads weights[:, 1:]
        # against targets tokens[:, 1:], so position j weights the
        # prediction of token j.
        start = min(len(ep.prompt_tokens), seq_len)
        end = min(len(toks), seq_len)
        row_w[start:end] = w
        rows.append((row_t, row_w))
    while len(rows) % batch_size:
        filler_t, _ = rows[-1]
        rows.append((filler_t.copy(), np.zeros((seq_len,), np.float32)))
    for i in range(0, len(rows), batch_size):
        chunk = rows[i : i + batch_size]
        yield {
            "tokens": np.stack([t for t, _ in chunk]),
            "weights": np.stack([w for _, w in chunk]),
        }
