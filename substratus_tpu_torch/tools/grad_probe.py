"""Card only: how far a LoRA step's gradients through the flash kernels lie
from the plain attention's, and how much of that is the kernels' bf16
rounding of p rather than their padding of the head dim.

    python -m substratus_tpu_torch.tools.grad_probe [--heads 32 40] [--layers 4 32]

An OPT at facebook/opt-2.7b's width (hidden 2560, FFN 10240, vocabulary
50272; seeded weights, bf16) with each --heads count: 32 heads is
opt-2.7b's head_dim 80, which the kernels run padded to 128; 40 heads is
head_dim 64, which they are built for. LoRA r16 on wq/wv (B drawn at
1e-2), one seeded batch of 2 x 512 tokens, remat. The trainable gradients
through four attentions:

* kernel: ops/flash_attention.py's flash_attention (the forward, dQ and
  dK/dV kernels; padded where the head dim is not built);
* twin: torch autograd of flash_attention_plain at the true head dim, the
  kernels' plain version, which rounds p to bf16 before PV as they do;
* plain: ops/attention.py's dot_product_attention (the JAX reference's
  function: the softmax kept in f32);
* fault: the kernels at the softmax scale of head_dim 128, what a padded
  route that took the padded D's scale would compute (a planted fault).

For each pair: the cosine over all gradients as one vector, and per
tensor the worst cosine and the worst relative (Frobenius) error, the
quantities chip_smoke.py's grad_check holds. --layers gives the depths
(the model's first layers: the same widths and weights' seeds).
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from substratus_tpu_torch.models import opt
from substratus_tpu_torch.ops.attention import dot_product_attention
from substratus_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
from substratus_tpu_torch.tools.ckpt_writer import shape_overrides
from substratus_tpu_torch.train.trainer import TrainConfig, Trainer, cross_entropy_loss

ATTENTIONS = {
    "kernel": flash_attention,
    "twin": lambda q, k, v, causal: flash_attention_plain(q, k, v, causal),
    "plain": lambda q, k, v, causal: dot_product_attention(q, k, v, causal=causal),
    "fault": lambda q, k, v, causal: flash_attention(q, k, v, causal, scale=128**-0.5),
}


def compare(a, b) -> dict:
    dot = na = nb = 0.0
    worst_cos, worst_rel = 1.0, 0.0
    for x, y in zip(a, b):
        x, y = x.float().flatten(), y.float().flatten()
        dot, na, nb = dot + (x @ y).item(), na + (x @ x).item(), nb + (y @ y).item()
        if y.norm().item() > 0:
            worst_cos = min(worst_cos, (x @ y / (x.norm() * y.norm()).clamp(min=1e-30)).item())
            worst_rel = max(worst_rel, ((x - y).norm() / y.norm()).item())
    return {"cosine_all": dot / max((na * nb) ** 0.5, 1e-30), "worst_cosine": worst_cos, "worst_rel_err": worst_rel}


def probe(heads: int, layers: int) -> dict:
    cfg = shape_overrides(opt.CONFIGS["opt-1.3b"], f"dim=2560,n_layers={layers},hidden_dim=10240,n_heads={heads}")
    trainer = Trainer(cfg, TrainConfig(lora_rank=16, lora_alpha=16, seed=0, remat=True), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():
        for layer in trainer.lora.layers:
            for ab in layer.values():
                ab["b"].copy_(torch.randn(ab["b"].shape, generator=gen, device="cuda") * 1e-2)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 512))).to("cuda")
    weights = torch.ones((2, 512), device="cuda")
    grads = {}
    for name, attend in ATTENTIONS.items():
        opt.flash_attention = attend
        try:
            loss = cross_entropy_loss(*trainer.loss_inputs(tokens, weights))
            grads[name] = torch.autograd.grad(loss, trainer.trainable)
        finally:
            opt.flash_attention = flash_attention
    out = {"heads": heads, "head_dim": cfg.head_size, "layers": layers}
    for a, b in (("kernel", "plain"), ("twin", "plain"), ("kernel", "twin"), ("fault", "plain")):
        out[f"{a}_vs_{b}"] = compare(grads[a], grads[b])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m substratus_tpu_torch.tools.grad_probe")
    ap.add_argument("--heads", type=int, nargs="+", default=[32, 40])
    ap.add_argument("--layers", type=int, nargs="+", default=[4, 32])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("grad_probe needs the card")
    print(torch.cuda.get_device_name(0), flush=True)
    for layers in args.layers:
        for heads in args.heads:
            print(json.dumps(probe(heads, layers)), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
