"""Train-loop telemetry (port of substratus_tpu/train/telemetry.py): one
JSON progress line per logging interval with the step time, throughput and
model FLOPs utilization (MFU), under the JAX package's keys.

The shared metrics registry (histograms, gauges) and the trace ids on each
line wait for the port's observability (ROADMAP Queue 1, the rest of the
serving surface: /metrics and tracing).
"""
from __future__ import annotations

import json
import time
from typing import Optional, Tuple

import torch

# Dense bf16 tensor-core peaks of NVIDIA cards (data sheets, without
# sparsity), matched in order against torch.cuda.get_device_name(); the
# SXM H100 reports itself as "NVIDIA H100 80GB HBM3".
PEAK_FLOPS = (
    ("H100 PCIe", 756e12),
    ("H100 NVL", 835e12),
    ("H100", 989e12),
    ("H200", 989e12),
    ("A100", 312e12),
)


def device_peak_flops(device: Optional[torch.device] = None) -> Optional[float]:
    """The card's dense bf16 peak FLOP/s, or None for the CPU and for a
    card the table does not name (MFU is then 0, never computed against a
    guessed peak)."""
    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device)
    return next((peak for key, peak in PEAK_FLOPS if key in name), None)


class StepLogger:
    """Per-step telemetry of the train loop.

    `tokens_per_step` is the batch in tokens (batch_size * seq_len);
    `n_params` drives the 6 * N * tokens FLOPs estimate (forward and
    backward of a dense decoder; attention FLOPs excluded, as MFU is
    quoted in the scaling literature)."""

    LOG_EVERY = 10

    def __init__(self, n_params: int, tokens_per_step: int, peak_flops: Optional[float] = None):
        self.n_params = int(n_params)
        self.tokens_per_step = int(tokens_per_step)
        self.peak_flops = peak_flops
        self._t_start = time.perf_counter()

    def rates(self, step_seconds: float) -> Tuple[float, float]:
        """(tokens per second, MFU) of a step that took step_seconds; MFU
        is 0 without a known peak."""
        step_seconds = max(step_seconds, 1e-9)
        mfu = 0.0
        if self.peak_flops:
            mfu = (6.0 * self.n_params * self.tokens_per_step) / (step_seconds * self.peak_flops)
        return self.tokens_per_step / step_seconds, mfu

    def log_step(self, step: int, loss: float, step_seconds: float, last: bool = False,
                 data_seconds: Optional[float] = None, checkpoint_seconds: Optional[float] = None) -> Optional[dict]:
        """Record one completed step; the JSON line goes out every
        LOG_EVERY steps and on the last. Returns the record, or None."""
        step_seconds = max(step_seconds, 1e-9)
        tps, mfu = self.rates(step_seconds)
        if step % self.LOG_EVERY and not last:
            return None
        record = {
            "event": "train_step",
            "step": step,
            "loss": round(float(loss), 6),
            "step_seconds": round(step_seconds, 4),
            "tokens_per_second": round(tps, 1),
            "mfu": round(mfu, 4),
            "elapsed_seconds": round(time.perf_counter() - self._t_start, 1),
        }
        if data_seconds is not None:
            record["data_seconds"] = round(data_seconds, 4)
        if checkpoint_seconds is not None:
            record["checkpoint_seconds"] = round(checkpoint_seconds, 4)
        print(json.dumps(record, separators=(",", ":")), flush=True)
        return record
