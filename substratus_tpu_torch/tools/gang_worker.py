"""One rank of a serving gang, for the tests and the card (the port's
counterpart of the JAX package's tools/multihost_serve_worker.py).

Run one process per rank under the operator's gang environment:

    JAX_COORDINATOR_ADDRESS=127.0.0.1:9911 JAX_NUM_PROCESSES=2 TPU_WORKER_ID=0 \\
        python -m substratus_tpu_torch.tools.gang_worker --requests reqs.json --out rank0.json [--device cpu]

Each rank joins the gang (parallel/distributed.py), loads its tensor shard
of the model (serve.main's load path: ``--model`` a checkpoint, else
``--config`` drawn from seed 0; or ``--weights``, a whole-model state dict
file, with ``--config``/``--shape``/``--vocab``/``--dtype``), builds the engine with
the gang's StepSync, and the leader generates the request list
(``--requests``: ``{"concurrent": bool, "requests": [{"prompt": [ids],
"max_tokens": n, "temperature": t, "cancel_after": k}, ...]}``; sequential
unless concurrent, a request with ``cancel_after`` cancelled after k
tokens). A follower records what its mirror requests would deliver, so
each rank writes its own tokens: the port's follower has no HTTP. With
``--logits`` (a JSON token batch) every rank first runs one forward over
it and the leader writes the full-vocab logits beside the result
(``{out}.logits.npy``). The leader then stops the gang, or with ``--hold``
keeps it idling until its engine fails (the test of a killed follower;
``{out}.hold`` marks the moment) and exits 1.

The mesh is serve.main's (``gang_mesh``): ``tensor`` from the params,
or the world over ``--data``; ``max_batch`` rounds up to a multiple of
the data axis. ``--quantize`` (none, int8, int4, w8a8; else the params'
``quantize``) quantizes the whole weights before each rank takes its
shard (``--weights``), or loads them so (``--model``/``--config``).

``--params`` may be a JSON list: the rank then serves one leg a params
object, in turn, in the one gang (each leg its own mesh groups, engine and
stop), with ``--requests`` one plan for every leg or a list of them; the
result holds ``{"legs": [...]}``, the last leg's ``--hold`` too.

Speculation and tenants, after the JAX package's
tools/multihost_serve_worker.py: a leg's ``spec_k`` proposes by prompt
lookup, or with its ``draft_model`` by a draft model, which every rank
loads and shards (serve.main's gang_draft): a checkpoint, or a whole-model
state dict (``.pt``) of ``--config`` with ``--draft-shape``'s overrides. A
leg whose params hold ``adapters`` (serve.main's object: capacity, rank,
dir) serves a store built by serve.main's build_adapter_store, its tenants
from the object's ``dir``, else ``--adapters-dir`` (seeded_tenants draws
tenants to write there). A request's ``adapter`` names its tenant; in a
concurrent plan a request with ``after`` is submitted when the request of
that index has ended (a tenant hot-loaded mid-run).

Each leg zeroes the kernel counters before its engine starts, so a leg's
``launches`` are its own run's.

With ``--probe-allreduce`` every rank first times the tensor group's
all-reduce in the model's dtype on its device at the decode step's and a
prefill chunk's activation shapes ([8, 1, dim] and [1, 512, dim]; the
median of 50), and with a data axis the token exchange's all-reduce
([max_batch] int64) and the int32 all-reduce of a row-parallel w8a8
w_down's partials ([16, 1, dim]).

The result (``--out``): rank, world, leader, the startup line (backend,
mesh, device, collective timeout, weight mode), the mesh's shape and this
rank's coordinates, tokens and finish reasons a request (the leader's with
its time to first token), the broadcast timings ``[(bytes, seconds)]``,
the data exchange's host-clock seconds a call, the engine's stats and
error, the adapter store's snapshot, the kernel launches (serve/server.py's
counters) and on the card the peak memory.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List

import numpy as np
import torch


class RecordingSink:
    """A follower's mirror request's tokens, recorded (serve/multihost.py's
    NullSink drops them)."""

    made: List["RecordingSink"] = []

    def __init__(self) -> None:
        self.tokens: List[int] = []
        self.done = False
        RecordingSink.made.append(self)

    def put(self, item) -> None:
        if item is None:
            self.done = True
        else:
            self.tokens.append(int(item))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m substratus_tpu_torch.tools.gang_worker")
    ap.add_argument("--out", required=True, help="this rank's result (JSON)")
    ap.add_argument("--requests", required=True, help="the leader's request list (JSON)")
    ap.add_argument("--device", default=None, help="cuda (default: cuda:(rank % cards)) or cpu")
    ap.add_argument("--model", default=None, help="a checkpoint, loaded as serve.main loads it")
    ap.add_argument("--config", default="tiny", help="a named llama config")
    ap.add_argument("--weights", default=None, help="a whole-model state dict (torch.save) for --config")
    ap.add_argument("--shape", default=None, help="--config's integer overrides with --weights, e.g. n_kv_heads=4")
    ap.add_argument("--vocab", type=int, default=None, help="--config's vocab size (with --weights)")
    ap.add_argument("--dtype", default="bfloat16", help="--config's dtype (with --weights)")
    ap.add_argument("--params", default="{}", help="params.json's keys as a JSON object (kv_layout, max_batch, "
                                                   "max_seq_len, max_prefill_len, kv_cache_dtype, quantize, tensor), "
                                                   "or a list of them: one leg each")
    ap.add_argument("--quantize", default=None, help="the weight mode (none|int8|int4|w8a8; default: the params')")
    ap.add_argument("--data", type=int, default=None, help="the mesh's data axis (tensor = world / data)")
    ap.add_argument("--eos", type=int, default=None, help="the engine's eos id (default: the tokenizer's)")
    ap.add_argument("--logits", default=None, help="a JSON token batch [[ids], ...] run through one forward")
    ap.add_argument("--hold", action="store_true", help="after the requests, idle until the engine fails")
    ap.add_argument("--probe-allreduce", action="store_true", help="time the tensor group's all-reduce first")
    ap.add_argument("--timeout", type=int, default=300, help="collective timeout, seconds")
    ap.add_argument("--draft-shape", default=None, help="--config's integer overrides for a .pt draft_model, "
                                                        "e.g. n_layers=1")
    ap.add_argument("--adapters-dir", default=None, help="a directory of adapter artifacts (legs with adapters)")
    return ap.parse_args(argv)


def seeded_tenants(cfg, n: int, rank: int, alpha: float = None) -> dict:
    """N tenants {f"t{i}": {name: {"a": [L, in, r], "b": [L, r, *out]}}} of
    every llama target (wq, wk, wv, wo, w_gate, w_up, w_down), float32
    numpy from seeds 50 + i (a ~ N(0, 1/in), b scaled so a delta's norm is
    about 0.3 of its projection's), at the whole model's shapes (`cfg` the
    whole model's); alpha defaults to 2 x rank."""
    from substratus_tpu_torch.models.llama import LORA_TARGETS
    from substratus_tpu_torch.serve.adapters import _target_shapes

    alpha = 2.0 * rank if alpha is None else alpha
    sigma = 0.3 / ((alpha / rank) * rank**0.5)
    out = {}
    for i in range(n):
        rng = np.random.default_rng(50 + i)
        out[f"t{i}"] = {name: {"a": rng.standard_normal((cfg.n_layers, ind, rank), dtype=np.float32)
                               * np.float32(ind**-0.5),
                               "b": rng.standard_normal((cfg.n_layers, rank) + shape, dtype=np.float32)
                               * np.float32(sigma)}
                        for name, (ind, shape) in _target_shapes(cfg, LORA_TARGETS).items()}
    return out


def load(args, params_json, gang):
    """(cfg, this rank's shard, mesh, eos): --weights into --config, else
    serve.main's load_model with the gang's mesh."""
    from substratus_tpu_torch.models import llama
    from substratus_tpu_torch.serve import main as serve_main
    from substratus_tpu_torch.tools.ckpt_writer import shape_overrides

    quantize = serve_main.resolve_quantize(params_json)
    if args.weights:
        cfg = shape_overrides(llama.CONFIGS[args.config], args.shape).replace(dtype=getattr(torch, args.dtype))
        if args.vocab:
            cfg = cfg.replace(vocab_size=args.vocab)
        whole = llama.Llama(cfg, device=gang.device)
        whole.load_state_dict(torch.load(args.weights, map_location=gang.device, weights_only=True))
        llama.quantize_weights(whole, serve_main.weight_mode(quantize))
        mesh = serve_main.gang_mesh(gang.world, params_json, cfg)
        params = llama.shard_model(whole, mesh)
        del whole
        return (params.cfg.replace(quant_activations=quantize == "w8a8"), params, mesh,
                args.eos if args.eos is not None else 2)
    mesh_for = serve_main.GangMesh(gang.world, params_json)
    cfg, params, tokenizer, _, _, _ = serve_main.load_model(
        args.model, args.config, params_json, gang.device, quantize, mesh_for)
    return cfg, params, mesh_for.mesh, args.eos if args.eos is not None else tokenizer.eos_id


def load_draft(args, params_json, cfg, mesh, device, quantize: str):
    """(draft cfg, this rank's shard of it) of the leg's draft_model,
    quantized as the target, or None."""
    from substratus_tpu_torch.models import llama
    from substratus_tpu_torch.serve import main as serve_main
    from substratus_tpu_torch.tools.ckpt_writer import shape_overrides

    path = params_json.get("draft_model")
    if not path:
        return None
    if path.endswith(".pt"):
        dcfg = shape_overrides(llama.CONFIGS[args.config], args.draft_shape).replace(
            dtype=cfg.dtype, vocab_size=args.vocab or llama.CONFIGS[args.config].vocab_size)
        whole = llama.Llama(dcfg, device=device)
        whole.load_state_dict(torch.load(path, map_location=device, weights_only=True))
    else:
        dcfg, whole = serve_main.load_checkpoint(path, device)
    llama.quantize_weights(whole, serve_main.weight_mode(quantize))
    return serve_main.gang_draft(llama, dcfg.replace(quant_activations=cfg.quant_activations), whole, mesh)


def adapter_store(args, params_json, cfg, params, device):
    """The leg's AdapterStore (serve.main's build_adapter_store over the
    params' adapters object), or None when the leg has none."""
    from substratus_tpu_torch.models import llama
    from substratus_tpu_torch.serve import main as serve_main

    if "adapters" not in params_json:
        return None
    return serve_main.build_adapter_store(llama, cfg, params_json, args.adapters_dir, device, tp=params.tp)


def leader_run(engine, plan) -> List[dict]:
    """Generate the plan's requests (sequentially unless concurrent; a
    concurrent request with ``after`` once that request has ended); every
    request's tokens, finish reason and time to first token."""
    import threading

    from substratus_tpu_torch.serve.engine import Request

    def submit(i, spec):
        return engine.submit(Request(list(spec["prompt"]), max_tokens=int(spec.get("max_tokens", 16)),
                                     temperature=float(spec.get("temperature", 0.0)), id=f"req-{i}",
                                     adapter=spec.get("adapter")))

    def read(req, spec):
        got, ttft = [], None
        while (tok := req.out.get(timeout=600)) is not None:
            if ttft is None:
                ttft = time.perf_counter() - req.submit_ts
            got.append(tok)
            if spec.get("cancel_after") and len(got) >= spec["cancel_after"]:
                req.cancelled = True
        return {"tokens": got, "finish_reason": req.finish_reason, "ttft_s": ttft,
                "seconds": time.perf_counter() - req.submit_ts}

    specs = plan["requests"]
    if not plan.get("concurrent"):
        return [read(submit(i, spec), spec) for i, spec in enumerate(specs)]
    ended = [threading.Event() for _ in specs]
    out = [None] * len(specs)
    reqs = {i: submit(i, spec) for i, spec in enumerate(specs) if "after" not in spec}

    def one(i, spec):
        if i not in reqs:
            ended[spec["after"]].wait(timeout=600)
            reqs[i] = submit(i, spec)
        out[i] = read(reqs[i], spec)
        ended[i].set()

    threads = [threading.Thread(target=one, args=(i, spec)) for i, spec in enumerate(specs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def probe_allreduce(mesh, cfg, device, max_batch: int, reps: int = 50) -> dict:
    """Median seconds of the tensor group's all-reduce at [8, 1, dim] and
    [1, 512, dim] in the model's dtype and at [16, 1, dim] int32 (a
    row-parallel w8a8 w_down's partials; with MAX, [16, 1, 1] f32: its
    rows' amax), and of the data group's token exchange ([max_batch]
    int64), each axis above 1 (every rank calls it)."""
    import statistics

    import torch.distributed as dist

    cases = []
    if mesh.shape["tensor"] > 1:
        cases += [("tensor", (8, 1, cfg.dim), cfg.dtype, dist.ReduceOp.SUM),
                  ("tensor", (1, 512, cfg.dim), cfg.dtype, dist.ReduceOp.SUM),
                  ("tensor", (16, 1, cfg.dim), torch.int32, dist.ReduceOp.SUM),
                  ("tensor", (16, 1, 1), torch.float32, dist.ReduceOp.MAX)]
    if mesh.shape["data"] > 1:
        cases.append(("data", (max_batch,), torch.int64, dist.ReduceOp.SUM))
    out = {}
    for axis, shape, dtype, op in cases:
        x = torch.zeros(shape, dtype=dtype, device=device)
        times = []
        for i in range(reps + 5):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            dist.all_reduce(x, op=op, group=mesh.group(axis))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            if i >= 5:
                times.append(time.perf_counter() - t0)
        key = "x".join(map(str, shape))
        if dtype != cfg.dtype:
            key += f"_{str(dtype).removeprefix('torch.')}" + ("_max" if op == dist.ReduceOp.MAX else "")
        out[key] = statistics.median(times)
    return out


def run_leg(args, gang, params_json: dict, plan: dict, hold: bool) -> dict:
    """One leg: load this rank's shard, serve the plan (the leader) or
    mirror it (a follower), stop; the leg's result."""
    from substratus_tpu_torch.serve import main as serve_main
    from substratus_tpu_torch.serve.engine import Engine, EngineConfig
    from substratus_tpu_torch.serve.multihost import StepSync
    from substratus_tpu_torch.serve.server import kernel_launches, reset_kernel_launches

    params_json = dict(params_json)
    if args.quantize is not None:
        params_json["quantize"] = args.quantize
    if args.data is not None and "tensor" not in params_json:
        params_json["tensor"] = gang.world // args.data
    cfg, params, mesh, eos = load(args, params_json, gang)
    quantize = serve_main.resolve_quantize(params_json)
    spec_k = int(params_json.get("spec_k", 0))
    draft = load_draft(args, params_json, cfg, mesh, gang.device, quantize) if spec_k else None
    adapters = adapter_store(args, params_json, cfg, params, gang.device)
    ec = EngineConfig(max_batch=serve_main.gang_batch(int(params_json.get("max_batch", 4)), mesh),
                      max_seq_len=int(params_json.get("max_seq_len", 64)),
                      max_prefill_len=int(params_json.get("max_prefill_len", EngineConfig.max_prefill_len)),
                      kv_cache_dtype=params_json.get("kv_cache_dtype", "model"),
                      kv_layout=params_json.get("kv_layout", "auto"), eos_token_id=eos,
                      kv_pool_tokens=params_json.get("kv_pool_tokens"), spec_k=spec_k)
    sync = StepSync()
    engine = Engine(cfg, params, ec, device=gang.device, mesh=mesh, sync=sync, draft=draft, adapters=adapters)
    RecordingSink.made = []
    engine.follower_sink = RecordingSink
    spec = "off" if not spec_k else (f"k={spec_k}, a draft of {draft[0].n_layers} layers ({draft[0].n_heads} heads, "
                                     f"{draft[0].n_kv_heads} kv heads a rank)" if draft else f"k={spec_k}, prompt lookup")
    store = "none" if adapters is None else f"capacity {adapters.capacity}, rank {adapters.rank}, {adapters.loaded_ids()}"
    line = (f"gang worker rank {gang.rank}/{gang.world} ({'leader' if gang.leader else 'follower'}); mesh "
            f"{mesh.describe()}; data backend {gang.backend} (event broadcast: gloo); device {gang.device}; "
            f"kv_layout {'paged' if engine.paged else 'dense'}; decode step "
            f"{'one CUDA graph' if engine.decode_graph else 'eager'}; heads {cfg.n_heads} kv heads "
            f"{cfg.n_kv_heads} per rank; weights {quantize}: {serve_main.shard_layout(params)}; max_batch "
            f"{ec.max_batch}, slots {engine.rows[0]}-{engine.rows[1] - 1} here; collective timeout {gang.timeout_s} s; "
            f"speculation {spec}; adapter store {store}")
    print(line, flush=True)
    if gang.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(gang.device)
    if args.logits:
        with open(args.logits) as f:
            batch = torch.tensor(json.load(f), dtype=torch.long, device=gang.device)
        with torch.inference_mode():
            logits, _ = engine.model.forward(params, batch, cfg)
        if gang.leader:
            np.save(args.out + ".logits.npy", logits.float().cpu().numpy())
    result = {"rank": gang.rank, "world": gang.world, "leader": gang.leader, "startup": line,
              "backend": gang.backend, "mesh": mesh.shape, "coords": mesh.coords, "device": str(gang.device),
              "n_layers": cfg.n_layers, "max_batch": ec.max_batch, "rows": list(engine.rows), "quantize": quantize}
    if args.probe_allreduce:
        result["allreduce_s"] = probe_allreduce(mesh, cfg, gang.device, ec.max_batch)
    reset_kernel_launches()
    engine.start()
    result["held"] = False
    if gang.leader:
        t0 = time.perf_counter()
        result["requests"] = leader_run(engine, plan)
        result["seconds"] = time.perf_counter() - t0
        if hold:
            open(args.out + ".hold", "w").close()
            engine._thread.join(timeout=args.timeout + 60)
            result["held"] = True
        else:
            engine.stop()
    else:
        engine._thread.join()
        result["requests"] = [{"tokens": s.tokens, "done": s.done} for s in RecordingSink.made]
    result["stopped"] = not engine._thread.is_alive()
    result["error"] = repr(engine.error) if engine.error else None
    result["stats"] = dict(engine.stats)
    result["adapters"] = adapters.snapshot() if adapters is not None else None
    result["timings"] = list(sync.timings)
    result["exchange_s"] = list(engine.exchange_s)
    result["launches"] = kernel_launches(engine)
    if gang.device.type == "cuda":
        result["peak_memory_bytes"] = torch.cuda.max_memory_allocated(gang.device)
    del engine, params, draft, adapters
    if gang.device.type == "cuda":
        torch.cuda.empty_cache()
    return result


def main(argv=None) -> int:
    from substratus_tpu_torch.parallel import distributed

    args = parse_args(argv)
    params_json = json.loads(args.params)
    if not distributed.maybe_initialize(args.timeout, "cpu" if args.device == "cpu" else "cuda"):
        raise SystemExit("gang_worker needs the gang environment: JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES > 1, "
                         "TPU_WORKER_ID")
    gang = distributed.current()
    with open(args.requests) as f:
        plans = json.load(f)
    legs = params_json if isinstance(params_json, list) else [params_json]
    plans = plans if isinstance(plans, list) else [plans] * len(legs)
    results = []
    for i, (leg, plan) in enumerate(zip(legs, plans)):
        results.append(run_leg(args, gang, leg, plan, args.hold and i == len(legs) - 1))
        if results[-1]["error"] is not None:
            break
    result = results[0] if not isinstance(params_json, list) else {"legs": results, "rank": gang.rank}
    with open(args.out, "w") as f:
        json.dump(result, f)
    error = results[-1]["error"]
    if error is not None:
        print(f"rank {gang.rank} engine died: {error}", file=sys.stderr, flush=True)
        return 1
    if results[-1]["held"]:
        return 1
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
