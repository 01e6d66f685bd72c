"""The learner half of the RL loop (port of substratus_tpu/rl/learner.py):
the port's Trainer plus episode batches.

A thin composition: the reward-carrying ``weights`` in the loss, the
optimizer and gradient accumulation live in train/trainer.py; the learner
assembles episode batches (rl/buffer.py) and keeps the loss history.
Full finetuning only: ``swap_params`` ships whole weight sets to the
actors, and shipping a LoRA delta instead is the adapter store's job
(serve/adapters.py), not a second weight path. One card, so no mesh
(multi-GPU learners: ROADMAP Queue 1, multi-GPU).
"""
from __future__ import annotations

import copy
import logging
from typing import Dict, List, Optional

import torch
from torch import nn

from substratus_tpu_torch.observability.metrics import METRICS
from substratus_tpu_torch.rl.buffer import Episode, episodes_to_batches
from substratus_tpu_torch.train.trainer import TrainConfig, Trainer
from substratus_tpu_torch.utils.device import DeviceLike

log = logging.getLogger(__name__)

METRICS.describe(
    "substratus_rl_learner_updates_total",
    "Optimizer updates applied by the RL learner.",
    type="counter",
)
METRICS.describe(
    "substratus_rl_episodes_total",
    "Episodes consumed by the RL learner.",
    type="counter",
)
METRICS.describe(
    "substratus_rl_learner_loss",
    "Reward-weighted loss of the learner's most recent update.",
    type="gauge",
)


class RLLearner:
    """Consumes episode drains, returns per-update losses.

    ``seq_len`` fixes the batch shape; pick it to cover prompt +
    max_tokens of the actor run. ``params`` seeds the learner from the
    actors' boot weights, so round 0's gradient is taken against the
    policy that generated the episodes. The port's trainer updates its
    module in place, so the learner trains its own deep copy of
    ``params`` (on their device), never a module an engine serves."""

    def __init__(
        self,
        cfg,
        tc: TrainConfig,
        params: Optional[nn.Module] = None,
        device: DeviceLike = None,
        batch_size: int = 8,
        seq_len: int = 128,
        pad_id: int = 0,
    ):
        if tc.lora_rank > 0:
            raise ValueError(
                "the RL learner is full-finetune only (lora_rank=0): "
                "swap_params ships full param trees to the actors"
            )
        own = copy.deepcopy(params) if params is not None else None
        self.trainer = Trainer(cfg, tc, params=own, device=device)
        self.batch_size = int(batch_size)
        self.seq_len = int(seq_len)
        self.pad_id = int(pad_id)
        self.losses: List[float] = []

    def learn(self, episodes: List[Episode]) -> List[float]:
        """One pass over a drain of episodes; returns that pass's losses
        (empty for an empty drain: the loop treats a dry round as nothing
        to learn, not an error)."""
        out: List[float] = []
        for batch in episodes_to_batches(episodes, self.batch_size, self.seq_len, pad_id=self.pad_id):
            loss = self.trainer.train_step(batch)
            out.append(loss)
            METRICS.inc("substratus_rl_learner_updates_total")
            METRICS.set("substratus_rl_learner_loss", loss)
        if episodes:
            METRICS.inc("substratus_rl_episodes_total", by=len(episodes))
        self.losses.extend(out)
        if out:
            log.info("rl learner: %d episodes -> %d updates, loss %.4f -> %.4f",
                     len(episodes), len(out), out[0], out[-1])
        return out

    def snapshot_params(self) -> Dict[str, torch.Tensor]:
        """A host copy of the current policy's weights (Trainer.snapshot_params:
        names, shapes and dtypes of the served model's state dict), the
        object the loop hands to Engine.swap_params; the next update
        cannot change it."""
        return self.trainer.snapshot_params()

    @property
    def step(self) -> int:
        return self.trainer.step
