"""Train-loop telemetry (port of substratus_tpu/train/telemetry.py): every
step's time, throughput, phase splits and model FLOPs utilization (MFU)
into the shared metrics registry (observability/metrics.py, the JAX
package's series: /debug/perfz reads substratus_train_phase_seconds when a
server shares the process), and one JSON progress line per logging
interval under the JAX package's keys, with the trace and span ids of the
active span (train.main runs its steps in ``train.run``), so a slow step's
line leads to its trace.
"""
from __future__ import annotations

import json
import time
from typing import Optional, Tuple

import torch

from substratus_tpu_torch.observability.metrics import METRICS, RATIO_BUCKETS, THROUGHPUT_BUCKETS
from substratus_tpu_torch.observability.tracing import tracer

METRICS.histogram(
    "substratus_train_step_seconds",
    "Wall time of one optimizer step, device-synchronized (seconds).",
)
METRICS.histogram(
    "substratus_train_tokens_per_second",
    "Training throughput per step (global batch tokens / step seconds).",
    buckets=THROUGHPUT_BUCKETS,
)
METRICS.histogram(
    "substratus_train_mfu_ratio",
    "Model FLOPs utilization per step (6*N*tokens / peak), when the device's peak FLOPs are known.",
    buckets=RATIO_BUCKETS,
)
METRICS.histogram(
    "substratus_train_phase_seconds",
    "Wall time of one train-loop phase (seconds), labeled by phase: data_load (next batch from the dataset), step "
    "(the optimizer step, device-synchronized), checkpoint (checkpoint save, 0 when the step saved nothing).",
)
for _name, _help in (
    ("substratus_train_step", "Last completed optimizer step."),
    ("substratus_train_loss", "Loss at the last completed step."),
    ("substratus_train_mfu", "MFU at the last completed step (0 when the device's peak FLOPs are unknown)."),
):
    METRICS.describe(_name, _help, type="gauge")

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
        """Record one completed step: the registry every step, the JSON
        line every LOG_EVERY steps and on the last. Returns the record, or
        None."""
        step_seconds = max(step_seconds, 1e-9)
        tps, mfu = self.rates(step_seconds)
        METRICS.observe("substratus_train_step_seconds", step_seconds)
        METRICS.observe("substratus_train_tokens_per_second", tps)
        METRICS.observe("substratus_train_phase_seconds", step_seconds, {"phase": "step"})
        if data_seconds is not None:
            METRICS.observe("substratus_train_phase_seconds", data_seconds, {"phase": "data_load"})
        if checkpoint_seconds is not None:
            METRICS.observe("substratus_train_phase_seconds", checkpoint_seconds, {"phase": "checkpoint"})
        if self.peak_flops:
            METRICS.observe("substratus_train_mfu_ratio", mfu)
        METRICS.set("substratus_train_step", step)
        METRICS.set("substratus_train_loss", float(loss))
        METRICS.set("substratus_train_mfu", mfu)
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
        ctx = tracer.current_context()
        if ctx is not None:
            record["trace_id"] = ctx.trace_id
            record["span_id"] = ctx.span_id
        print(json.dumps(record, separators=(",", ":")), flush=True)
        return record
