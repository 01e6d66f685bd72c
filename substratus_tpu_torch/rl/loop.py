"""The closed loop (port of substratus_tpu/rl/loop.py): actors generate,
the learner updates, the weights swap back, and the engines never restart.

The batchgen driver (serve/batchgen.py) drives the actor engines through
a per-round prompt manifest as an offline run would (continuous refill,
sharded exactly-once output), and its ``record_hook`` tees every
completed record into the episode buffer, scored by the caller's
``reward_fn``. When the round's manifest drains, the learner does a pass
over the episodes (rl/learner.py) and the refreshed weights go to every
actor through ``Engine.swap_params``: a settled pipeline and an in-place
copy into the served tensors, so every captured graph replays the new
weights with no capture. Round N+1 generates with round N's policy on the
same live engines.

Failure semantics: an engine death aborts the round (BatchGenDriver.run
raises); a swap rejection (a shape or dtype drift, which cannot happen
when the learner was seeded from the actors' weights) raises out of the
loop; a dry round (no ok record) skips the learn and the swap.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Any, Callable, Dict, List, Optional, Sequence

from substratus_tpu_torch.observability.metrics import METRICS
from substratus_tpu_torch.rl.buffer import Episode, ReplayBuffer
from substratus_tpu_torch.rl.learner import RLLearner
from substratus_tpu_torch.serve.batchgen import BatchGenDriver

log = logging.getLogger(__name__)

METRICS.describe(
    "substratus_rl_rounds_total",
    "Completed actor->learner->actor RL rounds.",
    type="counter",
)
METRICS.describe(
    "substratus_rl_mean_reward",
    "Mean episode reward of the most recent RL round.",
    type="gauge",
)

# reward_fn(output_record, prompt_tokens) -> float. The record is the
# batchgen output line (tokens, finish_reason, and text when a tokenizer
# is attached); the prompt ids ride alongside, as the record stores only
# their count.
RewardFn = Callable[[Dict[str, Any], List[int]], float]


class RLLoop:
    """Drives actor->learner->actor rounds over live engines.

    ``prompts`` are token-id lists (the manifest's ``tokens`` form: no
    tokenizer on the hot path; pass ``tokenizer`` only if the reward
    function wants decoded text on the records)."""

    def __init__(
        self,
        engines: Sequence[Any],
        learner: RLLearner,
        prompts: Sequence[List[int]],
        reward_fn: RewardFn,
        out_dir: str,
        *,
        max_tokens: int = 32,
        temperature: float = 1.0,
        top_p: float = 1.0,
        tokenizer=None,
    ):
        if not engines:
            raise ValueError("the RL loop needs at least one actor engine")
        if not prompts:
            raise ValueError("the RL loop needs at least one prompt")
        self.engines = list(engines)
        self.learner = learner
        self.prompts = [list(p) for p in prompts]
        self.reward_fn = reward_fn
        self.out_dir = out_dir
        self.max_tokens = int(max_tokens)
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.tokenizer = tokenizer
        self.rounds_done = 0
        self.history: List[Dict[str, Any]] = []
        # The weight generation the loop has pushed; each engine reports
        # it as weights_version after a swap (round r -> version base + r).
        self._version = max(int(getattr(e, "weights_version", 0)) for e in self.engines)

    def _write_manifest(self, rnd: int, round_dir: str) -> str:
        path = os.path.join(round_dir, "manifest.jsonl")
        with open(path, "w") as f:
            for i, toks in enumerate(self.prompts):
                f.write(json.dumps({"id": f"r{rnd}-{i}", "tokens": toks}))
                f.write("\n")
        return path

    def run_round(self, rnd: Optional[int] = None) -> Dict[str, Any]:
        """One actor->learner->actor round. Returns the round's report:
        {round, episodes, mean_reward, losses, weights_version, gen}."""
        rnd = self.rounds_done if rnd is None else int(rnd)
        round_dir = os.path.join(self.out_dir, f"round{rnd:03d}")
        os.makedirs(round_dir, exist_ok=True)
        manifest = self._write_manifest(rnd, round_dir)
        buffer = ReplayBuffer(capacity=max(len(self.prompts), 1))

        def hook(record: Dict[str, Any], prompt_tokens: List[int]) -> None:
            buffer.add(Episode(
                prompt_tokens=prompt_tokens,
                completion_tokens=list(record.get("tokens") or []),
                reward=float(self.reward_fn(record, prompt_tokens)),
                meta={"id": record.get("id"), "round": rnd},
            ))

        driver = BatchGenDriver(
            self.engines,
            manifest,
            os.path.join(round_dir, "out"),
            tokenizer=self.tokenizer,
            max_tokens=self.max_tokens,
            temperature=self.temperature,
            top_p=self.top_p,
            record_hook=hook,
        )
        gen = driver.run()
        episodes = buffer.drain()
        mean_reward = sum(ep.reward for ep in episodes) / len(episodes) if episodes else 0.0
        METRICS.set("substratus_rl_mean_reward", mean_reward)
        losses = self.learner.learn(episodes)
        version = self._version
        if losses:
            # The refreshed policy to every live actor; the explicit
            # version keeps a fleet on one generation a round (None would
            # let each engine count from where it started).
            version = self._version + 1
            params = self.learner.snapshot_params()
            for e in self.engines:
                e.swap_params(params, version=version)
            self._version = version
        report = {
            "round": rnd,
            "episodes": len(episodes),
            "mean_reward": round(mean_reward, 6),
            "losses": losses,
            "weights_version": version,
            "gen": gen,
        }
        self.rounds_done += 1
        self.history.append(report)
        METRICS.inc("substratus_rl_rounds_total")
        log.info("rl round %d: %d episodes, mean reward %.4f, %d updates, weights_version=%d",
                 rnd, len(episodes), mean_reward, len(losses), version)
        return report

    def run(self, rounds: int) -> List[Dict[str, Any]]:
        return [self.run_round() for _ in range(int(rounds))]
