"""The RL actor-learner closed loop on one card (port of
substratus_tpu/rl/): batchgen actor engines generate episodes into the
buffer, a learner built on train/'s Trainer consumes them with a
reward-weighted loss, and the refreshed weights flow back to the live
actors through Engine.swap_params: no engine restart, no graph captured
again.

The port keeps its own copies of the JAX package's modules (rl/buffer.py
imports no JAX there either); multi-GPU learners and actor fleets on
several cards wait for ROADMAP Queue 1, multi-GPU.
"""
from substratus_tpu_torch.rl.buffer import Episode, ReplayBuffer, episodes_to_batches, reward_weights
from substratus_tpu_torch.rl.learner import RLLearner
from substratus_tpu_torch.rl.loop import RLLoop

__all__ = [
    "Episode",
    "ReplayBuffer",
    "episodes_to_batches",
    "reward_weights",
    "RLLearner",
    "RLLoop",
]
