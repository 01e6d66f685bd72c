"""Model-loader entry point of the port (port of substratus_tpu/load/main.py),
the container contract's import step: a checkpoint in, a servable artifact
out.

    python -m substratus_tpu_torch.load.main [--out /content/artifacts] [--params /content/params.json]
        [--name PATH] [--config NAME] [--device cpu]

params.json keys, under the JAX entry point's names: ``name`` (a .gguf
file, or a directory holding one, or a local HF directory; the port reads
no hub, as its serving and training loaders read none), ``config`` (with
no ``name``: a named configuration of any family, drawn from ``seed``,
default 0), ``quantize`` (``int8`` stores llama's weights quantized;
another family says it skips it, as the JAX entry point does; ``none``)
and ``seed``. ``--name`` and ``--config`` stand for the keys. Any other
key or value exits, as in the port's other entry points.

It writes the port's artifact (train/checkpoints.py::save_artifact:
params.pt and the substratus.json sidecar, whose ``source`` names the
input and ``quantize`` the int8 storage) to ``--out``, with the source's
tokenizer beside it: a GGUF's embedded vocabulary as a metadata-only
``tokenizer.gguf`` sidecar, an HF directory's tokenizer files as copies.
A drawn configuration's vocabulary grows to the byte tokenizer's 258 ids
where it has fewer, as serve.main and train.main draw it, so the artifact
serves. serve.main --model and train.main --model take the artifact.

The run is a ``load.run`` span that joins the spawner's trace (the
``TRACEPARENT`` variable); the spans are appended as JSONL to
{out}/trace.jsonl (or ``SUBSTRATUS_TRACE_EXPORT``). The weights load on the
card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, Optional

import torch

_SERVED = ("name", "config", "quantize", "seed")
_QUANTIZE = ("none", "int8")


def check_params(p: Dict[str, Any]) -> None:
    """Exit on an unknown key or an unserved quantize value."""
    for key, value in p.items():
        if key not in _SERVED:
            raise SystemExit(f"params.json: unknown key {key!r} (load.main takes {', '.join(_SERVED)})")
        if key == "quantize" and value not in _QUANTIZE:
            raise SystemExit(f"params.json: quantize={value!r} invalid for load.main (one of {_QUANTIZE})")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m substratus_tpu_torch.load.main")
    ap.add_argument("--out", default="/content/artifacts")
    ap.add_argument("--params", default="/content/params.json")
    ap.add_argument("--name", default=None, help="the checkpoint: a .gguf file or a local HF directory")
    ap.add_argument("--config", default=None, help="with no checkpoint: a named configuration drawn from the seed")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run(argv=None, dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """Import as main() does and return what a caller inspects: the
    config, the model written, the sidecar's extra keys, the artifact's
    directory, the seconds of the load (the weights on their device) and of
    the whole import, and the span export's path. `dtype` is the loaded
    weights' (GGUF and HF sources; a drawn configuration keeps its own)."""
    from substratus_tpu_torch.load.gguf import load_gguf, resolve_gguf_or_exit
    from substratus_tpu_torch.load.hf import load_pretrained
    from substratus_tpu_torch.models import registry
    from substratus_tpu_torch.observability.propagation import context_from_env
    from substratus_tpu_torch.observability.tracing import tracer
    from substratus_tpu_torch.serve.main import load_params_json
    from substratus_tpu_torch.serve.tokenizer import ByteTokenizer, copy_tokenizer
    from substratus_tpu_torch.train.checkpoints import save_artifact
    from substratus_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    p = load_params_json(args.params)
    check_params(p)
    name: Optional[str] = args.name or p.get("name")
    device = resolve_device(args.device)
    t_start = time.perf_counter()
    with tracer.span("load.run", parent=context_from_env(), source=name or "random"):
        if name:
            gguf_path = resolve_gguf_or_exit(name)
            if gguf_path is not None:
                try:
                    cfg, params = load_gguf(gguf_path, dtype=dtype, device=device)
                except ValueError as e:  # a non-llama architecture, rope scaling: the resolver's clean exit
                    raise SystemExit(str(e))
            else:
                cfg, params = load_pretrained(name, dtype=dtype, device=device)
            meta: Dict[str, Any] = {"source": name}
        else:
            cfg_name = args.config or p.get("config", "tiny")
            family, cfg = registry.find_named_config(cfg_name)
            if cfg.vocab_size < ByteTokenizer.vocab_size:
                cfg = cfg.replace(vocab_size=ByteTokenizer.vocab_size)
            params = family.init_params(cfg, seed=int(p.get("seed", 0)), device=device)
            meta = {"source": f"random:{cfg_name}"}
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        load_s = time.perf_counter() - t_start

        if p.get("quantize", "none") == "int8":
            family = registry.module_of(cfg)
            if getattr(family, "SUPPORTS_QUANTIZE", False):
                params = family.quantize_weights(params, "int8")
                meta["quantize"] = "int8"
            else:
                print("int8 quantization not supported for this family; skipping", flush=True)

        save_artifact(args.out, params, cfg, extra_meta=meta)

        # The tokenizer beside the weights, so serving needs no network (a
        # GGUF's vocabulary as a metadata-only sidecar, which load_tokenizer
        # resolves: without it the artifact would serve bytes).
        if name and copy_tokenizer(name, args.out):
            print(f"the source's tokenizer written beside the artifact in {args.out}", flush=True)
    trace_path = os.environ.get("SUBSTRATUS_TRACE_EXPORT", os.path.join(args.out, "trace.jsonl"))
    try:
        tracer.export_jsonl(trace_path)
    except OSError as e:
        print(f"trace export failed (continuing): {e}", flush=True)
    seconds = time.perf_counter() - t_start
    print(f"model artifact written to {args.out} (loaded in {load_s:.2f} s, {seconds:.2f} s in all)", flush=True)
    return {"cfg": cfg, "params": params, "meta": meta, "out": args.out, "load_seconds": load_s,
            "seconds": seconds, "trace_path": trace_path}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
