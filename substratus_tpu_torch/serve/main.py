"""Serving entry point of the port (port of substratus_tpu/serve/main.py):

    python -m substratus_tpu_torch.serve.main --config llama2-7b --port 8080 [--device cpu]

It serves a named configuration with random weights from a seed (the JAX
entry point's weightless ``--config`` mode) over the OpenAI surface of
serve/server.py, on the card unless ``--device cpu`` is given.

Knobs come from flags or from the container contract's params file
(``/content/params.json``, or ``--params``); flags win. The port serves
the subset ``config``, ``max_batch``, ``max_seq_len``, ``max_prefill_len``,
``kv_cache_dtype``, ``max_queue`` and ``overlap`` (absent or ``true``: the
overlapped scheduler; ``false``: the synchronous one; on the card the
decode step is a CUDA graph in both), the weight knobs

* ``quantize``: ``none``, ``int8`` (weight-only int8, plain torch ops) and
  ``int4`` (nibble-packed groups through the int4 matmul kernel of
  ops/quant4.py); the random weights are quantized on the device, layer by
  layer, as the JAX entry point's _maybe_quantize does. ``w8a8`` exits;
* ``q4_impl``: ``pallas`` and ``xla`` both run the int4 kernel;

and the attention knobs under the JAX entry point's names:

* ``decode_attn_impl``: ``fused`` runs the fused cache-write + decode
  kernel (ops/fused_decode.py); ``xla`` (the JAX default) and ``pallas``
  run the decode kernel (ops/decode_attention.py);
* ``chunk_attn_impl``: ``flash`` and ``xla`` (the JAX default) both run the
  cached flash kernel (ops/flash_attention.py) on the chunks of a long
  prompt;
* ``attn_impl``: ``flash`` and ``xla`` (the JAX default off the TPU) run
  the flash kernel (ops/flash_attention.py) on a single-shot prefill,
  ``plain`` its plain PyTorch version; ``ring`` and ``ulysses`` exit.

The port has no XLA, so a reference name runs a kernel too; the startup
line says which. ``fused`` with ``kv_layout: paged`` exits, as in the JAX
entry point. Every other key of the JAX entry point exits with the
ROADMAP queue that will serve it, unless it holds the one value this port
already serves (for example ``kv_layout: dense``): a knob is never
silently ignored, and an unknown value of a served knob exits too.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Optional, Tuple

# params.json keys the port does not serve yet: the value it does serve
# (a key holding it passes), and where the rest waits.
_NOT_SERVED = {
    "model": (None, "Queue 1, checkpoint loading (waits for weights in the repository)"),
    "baseModel": (None, "Queue 1, checkpoint loading (waits for weights in the repository)"),
    "kv_layout": ("dense", "Queue 1, paged KV"),
    "spec_k": (0, "Queue 1, speculative decoding"),
    "draft_model": (None, "Queue 1, speculative decoding"),
    "adapters": (None, "Queue 1, multi-tenant adapters"),
    "role": ("both", "Queue 1, disaggregated prefill/decode"),
    "disaggregated": (None, "Queue 1, disaggregated prefill/decode"),
    "transfer_port": (None, "Queue 1, disaggregated prefill/decode"),
    "decode_peers": (None, "Queue 1, disaggregated prefill/decode"),
    "batchGenerate": (None, "Queue 1, batch generation"),
    "tensor": (None, "Queue 1, multi-GPU serving"),
    "sequence": (None, "Queue 1, multi-GPU serving"),
    "replicas": (None, "Queue 1, multi-GPU serving"),
    "drain_grace": (None, "Queue 1, the serving surface (gateway contract)"),
}
_SERVED = ("config", "max_batch", "max_seq_len", "max_prefill_len", "kv_cache_dtype", "max_queue", "overlap",
           "decode_attn_impl", "chunk_attn_impl", "attn_impl", "quantize", "q4_impl")
_QUANTIZE = ("none", "int8", "int4")
# The port has no XLA: both of the JAX entry point's int4 lowerings run the kernel.
_Q4_IMPLS = ("pallas", "xla")
# The JAX entry point's attention names -> the port's models/llama.py
# setting (JAX default first). The port has no XLA: "xla" runs a kernel.
_DECODE_IMPLS = {"xla": "kernel", "pallas": "kernel", "fused": "fused"}
_CHUNK_IMPLS = {"xla": "flash", "flash": "flash"}
# The JAX entry points' attn_impl (serving and training) -> models/llama.py's.
ATTN_IMPLS = {"xla": "flash", "flash": "flash", "plain": "plain"}
_MULTI_GPU = "Queue 1 item 10 (multi-GPU: ring and Ulysses attention)"


def load_params_json(path: Optional[str]) -> Dict[str, Any]:
    if path and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def resolve_attn_impls(params: Dict[str, Any]) -> Tuple[str, str, str]:
    """(decode_attn_impl, chunk_attn_impl, attn_impl) of models/llama.py
    for the params.json names; exits on an unknown name, on the multi-GPU
    attentions and, as the JAX entry point's resolve_kv_layout does, on
    fused decode with the paged layout (the paged decode path never
    reaches the fused kernel)."""
    decode = params.get("decode_attn_impl", "xla")
    chunk = params.get("chunk_attn_impl", "xla")
    prefill = params.get("attn_impl", "xla")
    if prefill in ("ring", "ulysses"):
        raise SystemExit(f"params.json: attn_impl={prefill!r} is not served by the PyTorch port yet: "
                         f"ROADMAP {_MULTI_GPU}")
    if prefill not in ATTN_IMPLS:
        raise SystemExit(f"params.json: attn_impl={prefill!r} invalid (one of {sorted(ATTN_IMPLS)})")
    if decode not in _DECODE_IMPLS:
        raise SystemExit(f"params.json: decode_attn_impl={decode!r} invalid (one of {sorted(_DECODE_IMPLS)})")
    if chunk not in _CHUNK_IMPLS:
        raise SystemExit(f"params.json: chunk_attn_impl={chunk!r} invalid (one of {sorted(_CHUNK_IMPLS)})")
    if decode == "fused" and params.get("kv_layout") == "paged":
        raise SystemExit(
            "params.json: decode_attn_impl=fused requires kv_layout=dense "
            "(the paged decode path does not use the fused kernel)"
        )
    return _DECODE_IMPLS[decode], _CHUNK_IMPLS[chunk], ATTN_IMPLS[prefill]


def resolve_quantize(params: Dict[str, Any]) -> str:
    """The weight mode of params.json; exits on w8a8 (not ported), on an
    unknown mode and on a q4_impl other than the JAX entry point's two."""
    quantize = params.get("quantize", "none")
    if quantize == "w8a8":
        raise SystemExit("params.json: quantize='w8a8' is not served by the PyTorch port yet: ROADMAP Queue 1 "
                         "item 11 (qeinsum_w8a8, an int8 x int8 product that wants a kernel of its own)")
    if quantize not in _QUANTIZE:
        raise SystemExit(f"params.json: quantize={quantize!r} invalid (one of {_QUANTIZE + ('w8a8',)})")
    q4_impl = params.get("q4_impl")
    if q4_impl is not None and q4_impl not in _Q4_IMPLS:
        raise SystemExit(f"params.json: q4_impl={q4_impl!r} invalid (one of {_Q4_IMPLS})")
    return quantize


def resolve_overlap(params: Dict[str, Any]) -> Optional[bool]:
    """EngineConfig.overlap from params.json, as the JAX entry point passes
    it (absent: None, which the engine resolves to on); exits on a value
    that is not a boolean."""
    overlap = params.get("overlap")
    if overlap is not None and not isinstance(overlap, bool):
        raise SystemExit(f"params.json: overlap={overlap!r} invalid (true or false)")
    return overlap


def check_params(params: Dict[str, Any]) -> None:
    """Exit on any key the port does not serve yet (naming its ROADMAP
    queue), on any key it does not know, and on an attention, weight or
    scheduler mode it does not serve."""
    resolve_attn_impls(params)
    resolve_quantize(params)
    resolve_overlap(params)
    for key, value in params.items():
        if key in _NOT_SERVED:
            served, where = _NOT_SERVED[key]
            if value != served:
                raise SystemExit(
                    f"params.json: {key}={value!r} is not served by the PyTorch port yet: ROADMAP {where}"
                )
        elif key not in _SERVED:
            raise SystemExit(f"params.json: unknown key {key!r}")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m substratus_tpu_torch.serve.main")
    ap.add_argument("--config", default=None, help="named config served with random weights (default tiny)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8080, help="0 picks a free port")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--params", default="/content/params.json", help="params file (container contract)")
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument("--max-seq-len", type=int, default=None)
    return ap.parse_args(argv)


def build(argv=None):
    """Parse the flags, build the model, engine and HTTP server, start the
    engine, and return the (not yet serving) serve.server.Server."""
    from substratus_tpu_torch.models import registry
    from substratus_tpu_torch.serve.engine import Engine, EngineConfig
    from substratus_tpu_torch.serve.server import Server, ServerState
    from substratus_tpu_torch.serve.tokenizer import load_tokenizer
    from substratus_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    params_json = load_params_json(args.params)
    check_params(params_json)
    device = resolve_device(args.device)

    name = args.config or params_json.get("config", "tiny")
    family, cfg = registry.find_named_config(name)
    tokenizer = load_tokenizer(None)
    if cfg.vocab_size < tokenizer.vocab_size:
        cfg = cfg.replace(vocab_size=tokenizer.vocab_size)
    decode_impl, chunk_impl, prefill_impl = resolve_attn_impls(params_json)
    cfg = cfg.replace(decode_attn_impl=decode_impl, chunk_attn_impl=chunk_impl, attn_impl=prefill_impl)
    quantize = resolve_quantize(params_json)
    params = family.quantize_weights(family.init_params(cfg, seed=0, device=device), quantize)

    def knob(flag, key, default):
        return flag if flag is not None else params_json.get(key, default)

    max_batch = int(knob(args.max_batch, "max_batch", 8))
    # Bounded admission: 4x max_batch waiters by default, 0 = unbounded,
    # as the JAX entry point has it.
    max_queue = int(params_json.get("max_queue", 4 * max_batch))
    ec = EngineConfig(
        max_batch=max_batch,
        max_seq_len=int(knob(args.max_seq_len, "max_seq_len", 1024)),
        max_prefill_len=int(params_json.get("max_prefill_len", EngineConfig.max_prefill_len)),
        kv_cache_dtype=params_json.get("kv_cache_dtype", "model"),
        eos_token_id=tokenizer.eos_id,
        max_queue=max_queue if max_queue > 0 else None,
        overlap=resolve_overlap(params_json),
    )
    engine = Engine(cfg, params, ec, device=device, model=family)
    server = Server(ServerState(engine, tokenizer, name), host=args.host, port=args.port)
    engine.start()
    weights = {"none": f"{str(cfg.dtype).removeprefix('torch.')} weights, torch.matmul",
               "int8": "int8 weights (scale after the dot), torch.einsum",
               "int4": f"int4 weights, int4 matmul kernel (q4_impl={params_json.get('q4_impl', 'auto')})"}
    prefill = "flash kernel" if prefill_impl == "flash" else "plain PyTorch"
    print(f"serving {name} on {args.host}:{server.port} ({device}); {weights[quantize]}; prefill attention: "
          f"{prefill} (attn_impl={params_json.get('attn_impl', 'xla')}); decode attention: "
          f"{'fused cache-write + decode kernel' if decode_impl == 'fused' else 'decode kernel'} "
          f"(decode_attn_impl={params_json.get('decode_attn_impl', 'xla')}), long-prompt chunks: "
          f"cached flash kernel (chunk_attn_impl={params_json.get('chunk_attn_impl', 'xla')}); scheduler: "
          f"{'overlapped' if engine.overlap else 'synchronous'}, decode step "
          f"{'one CUDA graph' if engine.decode_graph else 'eager'}", flush=True)
    return server


def main(argv=None) -> int:
    build(argv).serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
