"""The trainer (port of substratus_tpu/train/trainer.py) on one card: full
or LoRA finetuning of a model of any family (llama, opt, falcon; the
family module comes from models/registry.py, as in the JAX trainer), with
gradient accumulation and per-block recompute (remat).

Where the JAX trainer jits one sharded step over a mesh, this one runs the
step eagerly on one device: the forward (the family's, attention
through the flash kernel and its FlashAttention backward), the loss in f32,
torch.autograd.grad for the trainable tensors, then the optax-equivalent
optimizer of train/optim.py. Meshes, process counts and globally sharded
batches wait for multi-GPU (ROADMAP Queue 1, multi-GPU).

In LoRA mode the base weights stay frozen and only the adapters
(train/lora.py) train; otherwise every weight trains. A mixture of
experts adds router_aux_weight x the mean of the forward's "moe_aux" to
the loss (token-weighted in the accumulated form), as the JAX trainer
does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from torch import nn

from substratus_tpu_torch.models import registry
from substratus_tpu_torch.ops.headdim import check_head_dim
from substratus_tpu_torch.train import lora as lora_lib
from substratus_tpu_torch.train.optim import AdamW, warmup_cosine_decay_schedule
from substratus_tpu_torch.utils.device import DeviceLike, resolve_device


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 2e-5
    weight_decay: float = 0.0
    warmup_steps: int = 10
    total_steps: int = 100
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.999
    # LoRA: rank 0 disables (full finetune)
    lora_rank: int = 0
    lora_alpha: float = 16.0
    # Projections to adapt (train/lora.py).
    lora_targets: tuple = ("wq", "wv")
    remat: bool = True
    seed: int = 0
    # Gradient accumulation: the batch splits into this many microbatches,
    # each run forward and backward in turn (activation memory scales with
    # the microbatch, optimizer cadence with the batch).
    grad_accum_steps: int = 1


def cross_entropy_sum(
    logits: torch.Tensor,  # [B, S, V] float32
    targets: torch.Tensor,  # [B, S] integer
    weights: Optional[torch.Tensor] = None,  # [B, S] per-token loss weights
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weighted nll sum, weight sum): the accumulation-friendly form.
    The weights are real-valued: a 0/1 loss mask, or the RL learner's
    reward weights (rl/buffer.py: 0 on the prompt and filler rows)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    if weights is None:
        weights = torch.ones_like(nll)
    weights = weights.float()
    return (nll * weights).sum(), weights.sum()


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    s, w = cross_entropy_sum(logits, targets, weights)
    return s / torch.clamp(w, min=1.0)


def make_optimizer(tc: TrainConfig, params: List[torch.Tensor]) -> AdamW:
    """optax.chain(clip_by_global_norm(grad_clip), adamw(warmup_cosine))
    over `params`, as the JAX make_optimizer builds it."""
    schedule = warmup_cosine_decay_schedule(
        init_value=0.0,
        peak_value=tc.learning_rate,
        warmup_steps=tc.warmup_steps,
        decay_steps=max(tc.total_steps, tc.warmup_steps + 1),
    )
    return AdamW(params, schedule, tc.grad_clip, b1=tc.b1, b2=tc.b2, weight_decay=tc.weight_decay)


class Trainer:
    """Owns the model, the trainable tensors and the optimizer state.

    In LoRA mode `lora` holds the adapters (the trainable tensors) and
    `params` stays frozen; otherwise every tensor of `params` trains.
    Random weights come from the family's init_params(seed=tc.seed),
    adapters from init_lora(seed=tc.seed + 1), unless `params` is given.
    The family module comes from the config's type. Attention through the
    flash kernels (every family but llama at attn_impl "plain") refuses a
    head dim above the kernels' largest here (ops/headdim.py); a smaller
    one the kernels are not built for runs padded."""

    def __init__(self, cfg, tc: TrainConfig, params: Optional[nn.Module] = None,
                 device: DeviceLike = None):
        self.cfg, self.tc = cfg, tc
        self.model = registry.module_of(cfg)
        if getattr(cfg, "attn_impl", "flash") == "flash":
            check_head_dim(cfg.head_size, "the trainer's flash attention")
        if tc.lora_rank > 0 and not getattr(self.model, "SUPPORTS_LORA", False):
            raise NotImplementedError(f"LoRA is not implemented for the {registry.family_of(cfg)} family; use full "
                                      "finetuning (lora_rank: 0)")
        if params is None:
            params = self.model.init_params(cfg, seed=tc.seed, device=resolve_device(device))
        self.params = params
        self.device = params.device
        if tc.lora_rank > 0:
            self.lora = lora_lib.init_lora(cfg, seed=tc.seed + 1, rank=tc.lora_rank,
                                           targets=tuple(tc.lora_targets), device=self.device)
            self.lora_scale = tc.lora_alpha / tc.lora_rank
            self.trainable = list(self.lora.parameters())
        else:
            self.lora, self.lora_scale = None, None
            self.trainable = list(params.parameters())
        for p in params.parameters():
            p.requires_grad_(self.lora is None)
        self.optimizer = make_optimizer(tc, self.trainable)
        self.step = 0

    def trainable_module(self) -> torch.nn.Module:
        """The module whose state_dict is the trainable state."""
        return self.lora if self.lora is not None else self.params

    def _forward(self, tokens: torch.Tensor, weights: torch.Tensor):
        """((logits, targets, weights) of next-token prediction, the router
        aux term: router_aux_weight x the layers' mean aux, None without
        experts)."""
        lora = {"layers": self.lora.layers, "scale": self.lora_scale} if self.lora is not None else None
        logits, kv = self.model.forward(self.params, tokens, self.cfg, lora=lora, remat=self.tc.remat, train=True)
        aux = self.cfg.router_aux_weight * kv["moe_aux"].mean() if "moe_aux" in kv else None
        return (logits[:, :-1], tokens[:, 1:], weights[:, 1:]), aux

    def loss_inputs(self, tokens: torch.Tensor, weights: torch.Tensor):
        """(logits, targets, weights) of next-token prediction: the
        arguments of cross_entropy_sum / cross_entropy_loss (loss() adds a
        mixture of experts' aux term)."""
        return self._forward(tokens, weights)[0]

    def loss(self, tokens: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        """One batch's training loss, as train_step takes its gradient
        without accumulation: the weighted mean nll, plus the router's aux
        term under a mixture of experts (the JAX trainer's loss_fn)."""
        inputs, aux = self._forward(tokens, weights)
        loss = cross_entropy_loss(*inputs)
        return loss if aux is None else loss + aux

    def train_step(self, batch: Dict[str, np.ndarray]) -> float:
        """batch: {"tokens": [B, S] int, "weights": [B, S] f32} as numpy.
        One optimizer update; returns the loss (weighted mean nll, plus
        the router's aux term under a mixture of experts)."""
        tokens = torch.from_numpy(np.asarray(batch["tokens"])).to(self.device, torch.long)
        weights = torch.from_numpy(np.asarray(batch["weights"], np.float32)).to(self.device)
        accum = max(1, self.tc.grad_accum_steps)
        if tokens.shape[0] % accum:
            raise ValueError(f"batch size {tokens.shape[0]} must split into grad_accum_steps={accum} microbatches")
        if accum == 1:
            loss = self.loss(tokens, weights)
            grads = torch.autograd.grad(loss, self.trainable)
        else:
            # Grad-of-sum per microbatch, accumulated in f32 and normalized
            # once by the total token weight: exactly the single-step update
            # even when microbatches carry different numbers of loss tokens.
            s_sum = torch.zeros((), device=self.device)
            w_sum = torch.zeros((), device=self.device)
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=self.device) for p in self.trainable]
            for mb_tokens, mb_weights in zip(tokens.chunk(accum), weights.chunk(accum)):
                inputs, aux = self._forward(mb_tokens, mb_weights)
                s, w = cross_entropy_sum(*inputs)
                if aux is not None:  # token-weighted, so the sum normalizes as the loss does
                    s = s + aux * w
                for a, g in zip(acc, torch.autograd.grad(s, self.trainable)):
                    a += g.float()
                s_sum, w_sum = s_sum + s.detach(), w_sum + w
            denom = torch.clamp(w_sum, min=1.0)
            loss = s_sum / denom
            # Back to the parameter dtype, as the JAX step casts them.
            grads = [(a / denom).to(p.dtype) for a, p in zip(acc, self.trainable)]
        self.optimizer.update(grads)
        self.step += 1
        return float(loss.detach())

    def snapshot_params(self) -> Dict[str, torch.Tensor]:
        """A host copy of the model's state dict (the base weights in LoRA
        mode), safe to hand to a consumer that outlives the next step."""
        return {name: t.detach().to("cpu", copy=True) for name, t in self.params.state_dict().items()}
