"""Training entry point of the port (port of substratus_tpu/train/main.py):

    python -m substratus_tpu_torch.train.main [--model PATH] [--data DIR] [--out DIR] [--params FILE] [--device cpu]

Container contract: the base model at /content/model, the dataset at
/content/data, hyperparameters at /content/params.json, outputs to
/content/artifacts. It trains from a checkpoint (``--model``, else the
mounted /content/model: a .gguf file, a port artifact or a local HF
directory, resolved as serve.main resolves it, the tokenizer from the same
path), or else a named configuration from random weights (``config``: any
family's, e.g. ``llama2-7b``, ``opt-125m``, ``falcon-7b``), on one card,
or on the CPU with ``--device cpu``. The trainer takes the family's module
from the registry; LoRA adapts the attention projections of every family
(and llama's MLP).

params.json keys served, under the JAX entry point's names and defaults:
``steps`` (or ``max_steps``), ``batch_size``, ``seq_len``,
``learning_rate``, ``warmup_steps``, ``save_steps``, ``lora_rank``,
``lora_alpha``, ``config``, ``remat``, ``seed``, ``grad_accum_steps``;
``lora_targets`` (the port's own key: a list of the family's LoRA
targets, default wq and wv as the JAX entry point trains; on a mixture of
experts w_gate/w_up/w_down are expert-routed, a pair an expert);
``quantize``: ``int8`` quantizes a loaded base that is not quantized yet
(QLoRA: LoRA adapters over int8 weights, as the JAX entry point does; a
llama base only: an OPT or Falcon base exits), ``none`` leaves it; without
a model it exits (QLoRA needs a base model); ``attn_impl``: absent, ``xla``
or ``flash`` run the flash kernels and their backward (the port has no
XLA), ``plain`` the plain attention (for the CPU); OPT and Falcon run the
flash kernels and print that ``attn_impl`` is ignored, as the JAX entry
point prints it; ``dp``/``fsdp``/``sequence``/``tensor`` only as 1 or -1 (one
card); ``profile_steps`` ``[a, b]``: a torch.profiler capture of steps a
to b (CUDA activity on the card), clamped to the steps this run takes (a
resume can skip past it), written as a Chrome trace under {out}/profile,
stopped and flushed however the run ends (a malformed value is said and
ignored, as in the JAX entry point). Every other key or value exits naming
the ROADMAP item that will serve it, as does an operator's environment
that names a multi-process gang (JAX_NUM_PROCESSES > 1 with
JAX_COORDINATOR_ADDRESS set), where each process would train alone.

Tracing: the steps run in a ``train.run`` span that joins the spawner's
trace (the ``TRACEPARENT`` variable); each progress line carries its trace
and span ids (train/telemetry.py), and the spans are appended as JSONL to
{out}/trace.jsonl (or ``SUBSTRATUS_TRACE_EXPORT``) before the artifact is
written.

It resumes from the newest checkpoint under {out}/checkpoints (skipping
the batches the finished steps drew, so a resumed run sees the batches an
uninterrupted one would), prints one JSON line per 10 steps
(train/telemetry.py), and writes the artifact to {out}: the merged model
for a LoRA run, plus the adapter under {out}/adapter, and the base
model's tokenizer (serve/tokenizer.py::copy_tokenizer), so that serve.main
serves {out} as it is.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, List, Optional, Tuple

from substratus_tpu_torch.ops.headdim import head_dim_route
from substratus_tpu_torch.serve.main import (
    ATTN_IMPLS, check_single_process, check_vocab, load_checkpoint, load_params_json, resolve_model_path)

_SERVED = ("steps", "max_steps", "batch_size", "seq_len", "learning_rate", "warmup_steps", "save_steps",
           "lora_rank", "lora_alpha", "config", "remat", "seed", "grad_accum_steps", "attn_impl", "quantize",
           "lora_targets", "profile_steps")
_MESH_AXES = ("dp", "fsdp", "sequence", "tensor")
_MULTI_GPU = "Queue 1, multi-GPU (training meshes, ring and Ulysses attention)"


def check_params(p: Dict[str, Any]) -> None:
    """Exit on a key or value the port does not train with yet, naming
    its ROADMAP item, and on an unknown key."""
    for key, value in p.items():
        if key in _MESH_AXES:
            if int(value) not in (1, -1):
                raise SystemExit(f"params.json: {key}={value!r}: the port trains on one card; ROADMAP {_MULTI_GPU}")
        elif key == "quantize":
            if value not in ("none", "int8"):
                raise SystemExit(f"params.json: quantize={value!r} invalid for training (none, or int8: QLoRA)")
            if value == "int8" and int(p.get("lora_rank", 0)) <= 0:
                raise SystemExit("params.json: quantize='int8' (QLoRA) trains LoRA adapters over the int8 base: "
                                 "set lora_rank")
        elif key == "attn_impl":
            if value in ("ring", "ulysses"):
                raise SystemExit(f"params.json: attn_impl={value!r} is not served by the PyTorch port yet: "
                                 f"ROADMAP {_MULTI_GPU}")
            if value not in ATTN_IMPLS:
                raise SystemExit(f"params.json: attn_impl={value!r} invalid (one of {sorted(ATTN_IMPLS)})")
        elif key == "lora_targets":
            if not isinstance(value, list) or not value or not all(isinstance(v, str) for v in value):
                raise SystemExit(f"params.json: lora_targets={value!r} invalid (a list of projection names)")
        elif key not in _SERVED:
            raise SystemExit(f"params.json: unknown key {key!r}")


def profile_window(prof: Any, start_step: int, steps: int) -> Optional[Tuple[int, int]]:
    """params.json ``profile_steps`` [a, b] clamped to the steps this run
    takes (start_step..steps-1), as the JAX entry point clamps it; None
    when the window is empty, absent or malformed (said)."""
    if prof and isinstance(prof, (list, tuple)) and len(prof) == 2:
        a, b = (int(x) for x in prof)
        a, b = max(a, start_step), min(b, steps - 1)
        return (a, b) if a <= b else None
    if prof:
        print(f"ignoring malformed profile_steps {prof!r} (need [start, end])", flush=True)
    return None


class ProfileWindow:
    """A torch.profiler capture of a window of steps (CPU activity, and CUDA
    activity on the card), written as a Chrome trace into `out_dir` when it
    stops."""

    def __init__(self, device, out_dir: str):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.device, self.out_dir = device, out_dir
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        self.prof = profile(activities=activities)
        self.prof.start()
        self._torch = torch

    def stop(self) -> str:
        """End the capture (the card's kernels in flight included) and write
        the trace; its path."""
        if self.device.type == "cuda":
            self._torch.cuda.synchronize(self.device)
        self.prof.stop()
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, "trace.json")
        self.prof.export_chrome_trace(path)
        return path


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m substratus_tpu_torch.train.main")
    ap.add_argument("--data", default="/content/data")
    ap.add_argument("--model", default=None,
                    help="base model: a .gguf file, a port artifact or a local HF directory (default: "
                         "/content/model if mounted)")
    ap.add_argument("--out", default="/content/artifacts")
    ap.add_argument("--params", default="/content/params.json")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run(argv=None) -> Dict[str, Any]:
    """Train as main() does and return what a caller inspects: the
    trainer, the config, the model written as the artifact (for a LoRA
    run the merged copy; the trainer keeps its base and adapters), the
    StepLogger, the first step of this run, and per step of this run the
    loss, step seconds and checkpoint seconds; the artifact's seconds; the
    profile window and its trace file (None without one) and the span
    export's path."""
    from substratus_tpu_torch.models import registry
    from substratus_tpu_torch.observability.propagation import context_from_env
    from substratus_tpu_torch.observability.tracing import tracer
    from substratus_tpu_torch.ops.quant import is_quantized
    from substratus_tpu_torch.serve.tokenizer import copy_tokenizer, load_tokenizer
    from substratus_tpu_torch.train.checkpoints import CheckpointManager, save_adapter_artifact, save_artifact
    from substratus_tpu_torch.train.data import PackedDataset
    from substratus_tpu_torch.train.lora import merge_lora
    from substratus_tpu_torch.train.telemetry import StepLogger, device_peak_flops
    from substratus_tpu_torch.train.trainer import TrainConfig, Trainer
    from substratus_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    p = load_params_json(args.params)
    check_params(p)
    check_single_process("training")
    model_path = resolve_model_path(args.model, {})
    if p.get("quantize", "none") != "none" and model_path is None:
        raise SystemExit("params.json: quantize='int8' is QLoRA, which needs a base model (--model or "
                         "/content/model)")
    device = resolve_device(args.device)

    steps = int(p.get("steps", p.get("max_steps", 100)))
    batch_size = int(p.get("batch_size", 8))
    seq_len = int(p.get("seq_len", 512))
    lora_rank = int(p.get("lora_rank", 0))
    lora_alpha = float(p.get("lora_alpha", 16.0))
    params = None
    if model_path:
        # A QLoRA base quantizes as it loads (HF llama; the others after).
        cfg, params = load_checkpoint(model_path, device, quantize=p.get("quantize", "none"))
        tokenizer = load_tokenizer(model_path)
        check_vocab(tokenizer, cfg)
        family = registry.module_of(cfg)
        if p.get("quantize") == "int8" and not getattr(family, "SUPPORTS_QUANTIZE", False):
            raise SystemExit(f"params.json: quantize='int8' (QLoRA) trains over an int8 llama base; "
                             f"{type(cfg).__name__} weights are not quantized (as in the JAX package)")
        if p.get("quantize") == "int8" and not is_quantized(params):  # int8 artifacts arrive quantized
            family.quantize_weights(params, "int8")
        print(f"base model {model_path}: {cfg.n_layers} layers, dim {cfg.dim}, {cfg.dtype}"
              f"{', int8 (QLoRA)' if is_quantized(params) else ''}", flush=True)
    else:
        _, cfg = registry.find_named_config(p.get("config", "tiny"))
        tokenizer = load_tokenizer(None)
        if cfg.vocab_size < tokenizer.vocab_size:
            cfg = cfg.replace(vocab_size=tokenizer.vocab_size)
    if hasattr(cfg, "attn_impl"):
        cfg = cfg.replace(attn_impl=ATTN_IMPLS[p.get("attn_impl", "xla")])
    elif "attn_impl" in p:
        print(f"attn_impl ignored for the {type(cfg).__name__} family", flush=True)
    accum = max(1, int(p.get("grad_accum_steps", 1)))
    if batch_size % accum:
        batch_size = (batch_size // accum + 1) * accum
        print(f"batch_size rounded up to {batch_size} (a multiple of grad_accum_steps={accum})", flush=True)

    tc = TrainConfig(
        learning_rate=float(p.get("learning_rate", 2e-5)),
        warmup_steps=int(p.get("warmup_steps", min(10, steps // 10 + 1))),
        total_steps=steps,
        lora_rank=lora_rank,
        lora_alpha=lora_alpha,
        lora_targets=tuple(p.get("lora_targets", TrainConfig.lora_targets)),
        remat=bool(p.get("remat", True)),
        seed=int(p.get("seed", 0)),
        grad_accum_steps=accum,
    )
    trainer = Trainer(cfg, tc, params=params, device=device)
    data = PackedDataset(args.data, tokenizer, batch_size, seq_len, seed=tc.seed)
    print(f"training on {device}: steps={steps}, batch {batch_size} x {seq_len}, corpus={data.n_tokens} tokens, "
          f"lora_rank={lora_rank}, attention {getattr(cfg, 'attn_impl', 'flash')} at {head_dim_route(cfg.head_size)}",
          flush=True)

    ckpt = CheckpointManager(os.path.join(args.out, "checkpoints"),
                             save_steps=int(p.get("save_steps", max(1, steps // 5))))
    start_step = 0
    resumed = ckpt.restore_latest(map_location=trainer.device)
    if resumed is not None:
        start_step, state = resumed
        trainer.trainable_module().load_state_dict(state["trainable"])
        trainer.optimizer.load_state_dict(state["opt_state"])
        trainer.step = start_step
        for _ in range(start_step):  # the batches the finished steps drew
            next(data)
        print(f"resumed from step {start_step}", flush=True)

    prof_range = profile_window(p.get("profile_steps"), start_step, steps)
    step_log = StepLogger(n_params=sum(t.numel() for t in trainer.params.parameters()),
                          tokens_per_step=batch_size * seq_len, peak_flops=device_peak_flops(trainer.device))
    losses: List[float] = []
    step_seconds: List[float] = []
    checkpoint_seconds: List[float] = []
    window, profile_trace = None, None
    try:
        with tracer.span("train.run", parent=context_from_env(), steps=steps, start_step=start_step,
                         batch_size=batch_size, seq_len=seq_len, lora_rank=lora_rank):
            for step in range(start_step, steps):
                if prof_range and step == prof_range[0]:
                    window = ProfileWindow(trainer.device, os.path.join(args.out, "profile"))
                # Phase splits: data, the step (its loss read waits for the
                # device), the checkpoint.
                t0 = time.perf_counter()
                batch = next(data)
                t_step = time.perf_counter()
                loss = trainer.train_step(batch)
                t_ckpt = time.perf_counter()
                if window is not None and step == prof_range[1]:
                    profile_trace, window = window.stop(), None
                ckpt.maybe_save(step + 1, {"trainable": trainer.trainable_module().state_dict(),
                                           "opt_state": trainer.optimizer.state_dict()}, force=step == steps - 1)
                t_end = time.perf_counter()
                step_log.log_step(step, loss, t_ckpt - t_step, last=step == steps - 1,
                                  data_seconds=t_step - t0, checkpoint_seconds=t_end - t_ckpt)
                losses.append(loss)
                step_seconds.append(t_ckpt - t_step)
                checkpoint_seconds.append(t_end - t_ckpt)
    finally:
        if window is not None:  # a run that ended inside the window still writes its trace
            profile_trace = window.stop()
    if profile_trace is not None:
        print(f"profile of steps {prof_range[0]}..{prof_range[1]} written to {profile_trace}", flush=True)
    ckpt.close()
    trace_path = os.environ.get("SUBSTRATUS_TRACE_EXPORT", os.path.join(args.out, "trace.jsonl"))
    try:
        tracer.export_jsonl(trace_path)
    except OSError as e:
        print(f"trace export failed (continuing): {e}", flush=True)

    t0 = time.perf_counter()
    final = merge_lora(trainer.params, trainer.lora, trainer.lora_scale) if trainer.lora is not None else trainer.params
    save_artifact(args.out, final, cfg, extra_meta={"trained_steps": steps})
    if model_path and copy_tokenizer(model_path, args.out):
        print(f"the base model's tokenizer copied to {args.out}", flush=True)
    if trainer.lora is not None:
        save_adapter_artifact(os.path.join(args.out, "adapter"), trainer.lora, alpha=lora_alpha, rank=lora_rank,
                              extra_meta={"trained_steps": steps})
        print(f"adapter artifact saved to {args.out}/adapter", flush=True)
    artifact_seconds = time.perf_counter() - t0
    print(f"artifact saved to {args.out} in {artifact_seconds:.1f} s", flush=True)
    return {"trainer": trainer, "cfg": cfg, "merged": final, "step_log": step_log, "start_step": start_step,
            "losses": losses, "step_seconds": step_seconds, "checkpoint_seconds": checkpoint_seconds,
            "artifact_seconds": artifact_seconds, "profile_window": prof_range, "profile_trace": profile_trace,
            "trace_path": trace_path}


def main(argv: Optional[List[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
