"""The trainer's optimizer: optax's chain(clip_by_global_norm, adamw) with
a warmup-cosine schedule, as substratus_tpu/train/trainer.py::make_optimizer
builds it, reproduced in PyTorch (the port imports no optax).

Where optax and torch.optim differ, this follows optax:

* the schedule is read at the update count BEFORE it is incremented, so
  the first update has learning rate warmup_cosine(0) = 0;
* clipping scales by max_norm / norm only when norm >= max_norm (torch's
  clip_grad_norm_ scales by max_norm / (norm + 1e-6));
* AdamW: eps 1e-8 outside the square root, eps_root 0, decoupled decay
  added to the Adam direction before the learning rate; both moments in
  the parameter's dtype (bf16 for bf16 weights and adapters), and every
  scalar rounded to that dtype before it meets a tensor, as JAX's weak
  types round it.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int, end_value: float = 0.0,
) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule (exponent 1): linear from
    init_value to peak_value over warmup_steps, then cosine to end_value at
    decay_steps; evaluated in float32 as optax evaluates it."""
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(f"decay_steps ({decay_steps}) must exceed warmup_steps ({warmup_steps})")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = f32(1) - f32(count) / f32(warmup_steps)
            return float((f32(init_value) - f32(peak_value)) * frac + f32(peak_value))
        c = f32(min(count - warmup_steps, cos_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(cos_steps), dtype=np.float32))
        return float(f32(peak_value) * ((f32(1) - f32(alpha)) * cosine + f32(alpha)))

    return schedule


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum over tensors of each one's sum of
    squares, each sum in the tensor's dtype."""
    total = None
    for g in grads:
        s = (g * g).sum()
        total = s if total is None else total + s
    return total.sqrt()


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: unchanged when the global norm is below
    max_norm, else each tensor t / norm * max_norm."""
    norm = global_norm(grads)
    if bool(norm < _scalar(max_norm, norm)):
        return grads
    return [(g / norm.to(g.dtype)) * _scalar(max_norm, g) for g in grads]


class AdamW:
    """optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, b1, b2,
    weight_decay)) over a fixed list of tensors, updated in place."""

    def __init__(self, params: Sequence[torch.Tensor], schedule: Callable[[int], float], grad_clip: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0):
        self.params = list(params)
        self.schedule, self.grad_clip = schedule, grad_clip
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> float:
        """One step: clip, Adam moments, bias correction, decay, the
        schedule's learning rate at the current count; returns that rate."""
        grads = clip_by_global_norm(list(grads), self.grad_clip)
        lr = self.schedule(self.count)
        self.count += 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(self.b1) ** f32(self.count))
        bc2 = float(f32(1) - f32(self.b2) ** f32(self.count))
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            c = lambda x: _scalar(x, p)  # noqa: E731 -- a scalar in p's dtype
            mu.copy_(c(1 - self.b1) * g + c(self.b1) * mu)
            nu.copy_(c(1 - self.b2) * (g * g) + c(self.b2) * nu)
            u = (mu / c(bc1)) / (torch.sqrt(nu / c(bc2)) + c(self.eps))
            u = u + c(self.weight_decay) * p
            p.copy_(p + c(-lr) * u)
        return lr

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: Dict) -> None:
        if len(state["mu"]) != len(self.params):
            raise ValueError(f"optimizer state holds {len(state['mu'])} tensors, the trainer {len(self.params)}")
        self.count = int(state["count"])
        for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            dst.copy_(src)
