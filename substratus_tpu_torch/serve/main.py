"""Serving entry point of the port (port of substratus_tpu/serve/main.py):

    python -m substratus_tpu_torch.serve.main [--model PATH] [--config llama2-7b] [--port 8080] [--device cpu]

It serves a checkpoint, or a named configuration of any family with random
weights from a seed (the JAX entry point's weightless ``--config`` mode:
``llama2-7b``, ``opt-125m``, ``falcon-7b``, ...), over the
container contract's serving surface of serve/server.py (``GET /``,
``/loadz``, ``/metrics``, ``/v1/models``, ``POST /v1/completions`` with
``stop``, ``/v1/chat/completions``, ``/swapz``, ``/debug/profile``; 429,
504 and 503 admission), on the card unless ``--device cpu`` is given. On
SIGTERM or SIGINT it drains: readiness answers 503 at once, requests in
flight finish within ``drain_grace`` seconds (params.json, else the
SUBSTRATUS_DRAIN_GRACE environment variable, else 30), then it exits 0.
``POST /swapz`` loads the named checkpoint through the boot path's load
and quantize pipeline and swaps it in (serve/engine.py swap_params).

The checkpoint is ``--model``, else params.json ``model``, else a
directory mounted at ``/content/model`` (the container contract), resolved
as the JAX entry point's load_checkpoint does: a .gguf file (or a
directory holding one), then the port's own artifact (train/checkpoints.py),
then a local HF directory of the llama, OPT or Falcon family (load/hf.py);
its tokenizer comes from the same path (serve/tokenizer.py) and its
directory's name is the served model's.

OPT and Falcon serve on the dense cache in the model dtype, as in the JAX
package: ``kv_layout`` ``auto`` resolves to dense for them, and
``kv_layout: paged`` or ``kv_cache_dtype: int8`` exits with the engine's
refusal; ``quantize`` prints "... quantization not supported for this
family; skipping" and serves dense weights; the attention knobs print that
they are ignored (they exist on llama alone); prompt lookup (``spec_k``)
works, a draft model (which needs the paged pool) is turned off with
JAX's message.

Knobs come from flags or from the container contract's params file
(``/content/params.json``, or ``--params``); flags win. The port serves
the subset ``model``, ``config``, ``max_batch``, ``max_seq_len``,
``max_prefill_len``, ``kv_cache_dtype``, ``max_queue`` (429 beyond it; 0
unbounded), ``drain_grace`` and ``overlap`` (absent or ``true``: the
overlapped scheduler; ``false``: the synchronous one; on the card the
decode step is a CUDA graph in both), speculative decoding

* ``spec_k`` (``--spec-k``): up to k proposals a greedy request a round,
  verified by one target forward (serve/engine.py); with ``draft_model``
  (``--draft-model``, a checkpoint path resolved as ``model`` is, of the
  same family, quantized as the target) a draft model proposes, else
  prompt lookup does. A draft needs the paged pool: with ``kv_layout``
  dense the entry point says so and serves without speculation, as the JAX
  one does;

the cache's layout

* ``kv_layout``: ``auto`` (the default) serves llama on the paged pool, as
  the JAX entry point does: pages of 16 tokens, a pool of max_batch x
  max_seq_len tokens, prompt prefixes shared, preempt-and-resume under
  pressure (serve/engine.py); ``paged`` asks for it and ``dense`` for one
  region a slot. ``decode_attn_impl: fused`` resolves ``auto`` to dense and
  exits with ``paged`` (resolve_kv_layout, as in the JAX entry point). As
  there, the page size, the pool's size and the prefix cache are
  EngineConfig's alone: params.json has no key for them;

the weight knobs

* ``quantize``: ``none``, ``int8`` (weight-only int8, plain torch ops),
  ``int4`` (nibble-packed groups through the int4 matmul kernel of
  ops/quant4.py) and ``w8a8`` (int8 weights times per-token int8
  activations: the weights quantize as int8 and ``quant_activations`` is
  set, so the projections run ops/quant.py's w8a8 kernels; wo stays
  weight-only, as in JAX); the loaded or random weights are quantized on
  the device, layer by layer, as the JAX entry point's _maybe_quantize
  does (weights an artifact holds quantized stay as they are);
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
line says which. On the paged pool the attention knobs choose nothing:
every prompt runs as chunks through its block-table row, and chunks and
decode steps alike attend the pages gathered through it with the plain
attention, as in the JAX package.

Multi-tenant adapters (serve/adapters.py): ``--adapters-dir``, else
params.json ``adapters`` (``dir``, ``paths`` {id: artifact dir},
``capacity`` (8), ``rank`` and ``targets``, inferred from the artifacts
when absent), else a directory mounted at ``/content/adapters`` (the
container contract) builds an AdapterStore (build_adapter_store): every
artifact subdir is a tenant named by the subdir, preloaded up to the
capacity, the rest hot-loaded by the first request whose ``model`` field
names it; the startup line prints the store. ``baseModel`` is a known key
with no effect here, as in the JAX entry point (the controller reads it).

Disaggregated prefill/decode (serve/disagg.py): ``--role`` (``both``, the
default; ``prefill``; ``decode``), else the SUBSTRATUS_SERVE_ROLE
variable, else params.json ``role``; ``--decode-peers`` (a prefill tier's
comma-separated ``host:port`` transfer endpoints of its decode tier), else
SUBSTRATUS_DECODE_PEERS, else params.json ``decode_peers`` (a list); and
``--transfer-port`` (a decode tier's listener, 8500 by default), else
SUBSTRATUS_TRANSFER_PORT, else params.json ``transfer_port``: flag > env >
params, as in the JAX entry point (the controller stamps the variable per
tier while both tiers share one params file). Both tiers need the paged
layout; a prefill tier without peers exits; a decode tier answers
completions 503 ``wrong_role``. ``disaggregated`` is a known key with no
effect here, as in the JAX entry point (the controller reads it).

Every other key of the JAX entry point exits with the ROADMAP item that
will serve it, named by its title (``sequence``, ``replicas``: multi-GPU
serving), unless it holds the one value this port already serves: a knob
is never silently ignored, and an unknown value of a served knob exits
too.

Gangs (parallel/, serve/multihost.py): an operator's environment that
names one (JAX_NUM_PROCESSES > 1 with JAX_COORDINATOR_ADDRESS set, this
process's rank in TPU_WORKER_ID) makes every process join it with a TCP
rendezvous at the coordinator's address, one process a card: rank r runs
on cuda:(r % the cards it sees), or on the CPU with ``--device cpu``. The
ranks form a ``data`` x ``tensor`` mesh: ``tensor`` is params.json's,
lowered until it divides the kv heads (the JAX entry point's loop: the
llama2-70b example's 16 on 16 ranks is data=2 x tensor=8), else the
largest size up to the world that divides them; ``data`` is the rest,
printed as the JAX entry point's ``serving mesh`` line, and ``max_batch``
rounds up to a multiple of it. A gang serves speculation (prompt lookup,
or a draft model, which every rank loads and shards by the same rules: its
kv heads must divide ``tensor``) and multi-tenant adapters (every rank's
store holds its slice of each tenant, hot loads alike; the ranks check
each adapter admission equal, so a tenant one rank cannot load fails the
gang); a disaggregated role in a gang exits, as the JAX entry point
refuses it, naming ROADMAP Queue 1. Every rank loads the
checkpoint and keeps its tensor shard (models/llama.py's shard_model, any
weight mode: int4 in whole scale groups or whole, w8a8 as int8; an HF
directory is staged a layer at a time, so no rank holds the whole model),
and runs the engine over it with the scheduler replicated by a
per-iteration broadcast; each data replica decodes its own block of
slots (serve/engine.py). Only rank 0, the
leader, binds HTTP; a follower runs no server, mirrors the leader until
its stop broadcast and exits 0, or 1 if its engine failed. The leader exits
1 when the gang fails under it (a follower's death fails its next
collective), and a SIGTERM to the leader drains, broadcasts stop and ends
every rank with 0. ``tensor`` without a gang exits (one process serves
one card).

``batchGenerate`` is a known key, as in the JAX entry point: the batch
run itself is ``python -m substratus_tpu_torch.serve.batchgen``.

Tracing: a ``serve.start`` span joins the trace named by the
``TRACEPARENT`` variable, and with ``SUBSTRATUS_TRACE_EXPORT`` set every
buffered span (the server's ``serve.http``, the engine's) is appended to
that file as JSONL at exit.
"""
from __future__ import annotations

import argparse
import atexit
import contextlib
import hashlib
import json
import os
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Tuple

import torch

from substratus_tpu_torch.observability.propagation import context_from_env
from substratus_tpu_torch.observability.tracing import tracer
from substratus_tpu_torch.parallel import distributed

# params.json keys the port does not serve yet: the value it does serve
# (a key holding it passes), and where the rest waits.
_NOT_SERVED = {
    "sequence": (None, "Queue 1, multi-GPU serving"),
    "replicas": (None, "Queue 1, multi-GPU serving"),
}
_SERVED = ("model", "config", "max_batch", "max_seq_len", "max_prefill_len", "kv_cache_dtype", "max_queue",
           "overlap", "kv_layout", "decode_attn_impl", "chunk_attn_impl", "attn_impl", "quantize", "q4_impl",
           "spec_k", "draft_model", "drain_grace", "batchGenerate", "adapters", "baseModel", "role", "disaggregated",
           "transfer_port", "decode_peers", "tensor")
_ROLES = ("both", "prefill", "decode")
_KV_LAYOUTS = ("auto", "paged", "dense")
_QUANTIZE = ("none", "int8", "int4", "w8a8")
# The port has no XLA: both of the JAX entry point's int4 lowerings run the kernel.
_Q4_IMPLS = ("pallas", "xla")
# The JAX entry point's attention names -> the port's models/llama.py
# setting (JAX default first). The port has no XLA: "xla" runs a kernel.
_DECODE_IMPLS = {"xla": "kernel", "pallas": "kernel", "fused": "fused"}
_CHUNK_IMPLS = {"xla": "flash", "flash": "flash"}
# The JAX entry points' attn_impl (serving and training) -> models/llama.py's.
ATTN_IMPLS = {"xla": "flash", "flash": "flash", "plain": "plain"}
_MULTI_GPU = "Queue 1, multi-GPU (ring and Ulysses attention)"
_GANGS = "Queue 1, multi-GPU (gangs: one model over several processes)"
_CARDS = "Queue 1, multi-GPU (several cards in one process)"
# The container contract's model and adapter mounts.
CONTENT_MODEL = "/content/model"
CONTENT_ADAPTERS = "/content/adapters"


def load_params_json(path: Optional[str]) -> Dict[str, Any]:
    if path and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def resolve_attn_impls(params: Dict[str, Any]) -> Tuple[str, str, str]:
    """(decode_attn_impl, chunk_attn_impl, attn_impl) of models/llama.py
    for the params.json names; exits on an unknown name and on the
    multi-GPU attentions."""
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
    return _DECODE_IMPLS[decode], _CHUNK_IMPLS[chunk], ATTN_IMPLS[prefill]


def resolve_kv_layout(params: Dict[str, Any]) -> str:
    """EngineConfig.kv_layout of params.json, as the JAX entry point
    resolves it: the fused decode kernel lives on the dense path (the paged
    read never reaches it), so fused with auto resolves to dense, and fused
    with paged, a contradiction, exits. Also exits on an unknown layout."""
    layout = params.get("kv_layout", "auto")
    if layout not in _KV_LAYOUTS:
        raise SystemExit(f"params.json: kv_layout={layout!r} invalid (one of {_KV_LAYOUTS})")
    fused = params.get("decode_attn_impl") == "fused"
    if fused and layout == "auto":
        return "dense"
    if fused and layout == "paged":
        raise SystemExit(
            "params.json: decode_attn_impl=fused requires kv_layout=dense "
            "(the paged decode path does not use the fused kernel)"
        )
    return layout


def resolve_quantize(params: Dict[str, Any]) -> str:
    """The weight mode of params.json; exits on an unknown mode and on a
    q4_impl other than the JAX entry point's two."""
    quantize = params.get("quantize", "none")
    if quantize not in _QUANTIZE:
        raise SystemExit(f"params.json: quantize={quantize!r} invalid (one of {_QUANTIZE})")
    q4_impl = params.get("q4_impl")
    if q4_impl is not None and q4_impl not in _Q4_IMPLS:
        raise SystemExit(f"params.json: q4_impl={q4_impl!r} invalid (one of {_Q4_IMPLS})")
    return quantize


def weight_mode(quantize: str) -> str:
    """How a quantize mode stores the weights: w8a8's are int8 (its
    activations quantize at run time, cfg.quant_activations)."""
    return "int8" if quantize == "w8a8" else quantize


def resolve_overlap(params: Dict[str, Any]) -> Optional[bool]:
    """EngineConfig.overlap from params.json, as the JAX entry point passes
    it (absent: None, which the engine resolves to on); exits on a value
    that is not a boolean."""
    overlap = params.get("overlap")
    if overlap is not None and not isinstance(overlap, bool):
        raise SystemExit(f"params.json: overlap={overlap!r} invalid (true or false)")
    return overlap


def resolve_spec(flag: Optional[int], draft_flag: Optional[str], params: Dict[str, Any]) -> Tuple[int, Optional[str]]:
    """(spec_k, draft checkpoint path) from the flags, else params.json;
    exits on a spec_k that is not a count."""
    spec_k = flag if flag is not None else params.get("spec_k", 0)
    if isinstance(spec_k, bool) or not isinstance(spec_k, int) or spec_k < 0:
        raise SystemExit(f"params.json: spec_k={spec_k!r} invalid (a count of proposals, 0 = off)")
    return spec_k, draft_flag or params.get("draft_model")


def resolve_drain_grace(params: Dict[str, Any]) -> Optional[float]:
    """params.json drain_grace (seconds; absent: None, which the server
    resolves from SUBSTRATUS_DRAIN_GRACE, else 30); exits on a value that
    is not a non-negative number."""
    grace = params.get("drain_grace")
    if grace is None:
        return None
    if isinstance(grace, bool) or not isinstance(grace, (int, float)) or not grace >= 0:
        raise SystemExit(f"params.json: drain_grace={grace!r} invalid (seconds, >= 0)")
    return float(grace)


def check_single_process(what: str) -> None:
    """Exit when the operator's environment names a multi-process gang, as
    the JAX package's parallel/distributed.py reads it: JAX_NUM_PROCESSES
    above 1 with JAX_COORDINATOR_ADDRESS set. For the entry points without
    a gang yet (train.main): every process would train alone."""
    n = int(os.environ.get("JAX_NUM_PROCESSES", "1") or 1)
    if n > 1 and os.environ.get("JAX_COORDINATOR_ADDRESS"):
        raise SystemExit(f"JAX_NUM_PROCESSES={n} with JAX_COORDINATOR_ADDRESS set: {what} across {n} processes is "
                         f"not served by the PyTorch port yet: ROADMAP {_GANGS}")


def resolve_tensor(params: Dict[str, Any]) -> Optional[int]:
    """params.json ``tensor`` (None when absent); exits on a value that is
    not a positive count, and on one above 1 outside a gang: one process
    serves one card."""
    tensor = params.get("tensor")
    if tensor is None:
        return None
    if isinstance(tensor, bool) or not isinstance(tensor, int) or tensor < 1:
        raise SystemExit(f"params.json: tensor={tensor!r} invalid (a count of ranks)")
    coord, world, _ = distributed.world_info()
    if tensor > 1 and (world <= 1 or coord is None):
        raise SystemExit(f"params.json: tensor={tensor} needs a gang of processes (JAX_NUM_PROCESSES, "
                         "JAX_COORDINATOR_ADDRESS, TPU_WORKER_ID); one process serves one card, and several cards "
                         f"in one process are not served by the PyTorch port yet: ROADMAP {_CARDS}")
    return tensor


def gang_mesh(world: int, params: Dict[str, Any], cfg):
    """The gang's mesh: tensor from params.json, else the largest size up
    to the world that divides the kv heads, lowered until it divides both
    (the JAX entry point's loop: llama2-70b's 8 kv heads take the example's
    tensor 16 on 16 ranks as data=2 x tensor=8); data the rest. Exits on a
    tensor above the world."""
    from substratus_tpu_torch.parallel.mesh import build_mesh

    tensor = resolve_tensor(params)
    if tensor is not None and tensor > world:
        raise SystemExit(f"params.json: tensor={tensor} is larger than the gang ({world} processes)")
    tp = tensor or min(world, cfg.n_kv_heads)
    while world % tp or cfg.n_kv_heads % tp:
        tp -= 1
    return build_mesh(data=world // tp, tensor=tp)


class GangMesh:
    """A gang's mesh as load_model's `mesh_for` (cfg -> mesh): built at
    the first call, from the whole model's config (its process groups are
    made collectively, once, in the same order on every rank)."""

    def __init__(self, world: int, params: Dict[str, Any]):
        self.world, self.params = world, params
        self.mesh = None

    def __call__(self, model_cfg):
        if self.mesh is None:
            self.mesh = gang_mesh(self.world, self.params, model_cfg)
        return self.mesh


def mesh_line(mesh) -> str:
    """The JAX entry point's line naming the serving mesh (its sequence
    axis is not served here)."""
    return f"serving mesh: data={mesh.shape['data']} tensor={mesh.shape['tensor']}"


def gang_batch(max_batch: int, mesh) -> int:
    """max_batch rounded up to a multiple of the mesh's data axis, as the
    JAX entry point rounds it: each data replica owns an equal block of
    slots."""
    dp = mesh.shape["data"] if mesh is not None else 1
    return max_batch if max_batch % dp == 0 else (max_batch // dp + 1) * dp


def shard_layout(params) -> str:
    """The startup line's account of a rank's quantized weights: each
    kind's storage and whether its slices are row-parallel, column-parallel
    or whole on every rank (an int4 weight q4_row_parallel keeps whole)."""
    tp = getattr(params, "tp", None)
    if tp is None:
        return "whole (tensor=1)"
    layer = params.layers[0]
    kinds = []
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        w = getattr(layer, name)
        mode = "int4" if hasattr(w, "packed") else "int8" if hasattr(w, "q") else "dense"
        if name == "w_down" and tp.down_whole:
            how = "whole"
        elif name in ("wo", "w_down"):
            how = "row-parallel" if name == "wo" or tp.mlp_sharded else "whole"
        else:
            how = "column-parallel"
        kinds.append(f"{name} {mode} {how}")
    return ", ".join(kinds)


def check_gang_params(params: Dict[str, Any], args) -> None:
    """Exit, before the rendezvous, on a disaggregated role in a gang, as
    the JAX engine refuses it (one gang is one replica of one pool)."""
    if resolve_role(args.role, params) != "both":
        raise SystemExit("a disaggregated role in a gang: disaggregated roles are incompatible with lockstep sync (a "
                         "gang engine is one replica; split pools across gangs); ROADMAP Queue 1, multi-GPU")


def gang_draft(family, draft_cfg, draft_params, mesh):
    """A gang rank's shard of the draft model, by the target's serving
    rules (the JAX engine shards the draft over the same mesh); exits
    where the tensor axis does not divide its heads (JAX keeps such heads
    whole on every device; a rank here would attend heads it does not
    hold)."""
    t = mesh.shape["tensor"]
    if draft_cfg.n_kv_heads % t or draft_cfg.n_heads % t:
        raise SystemExit(f"a draft model of {draft_cfg.n_heads} heads and {draft_cfg.n_kv_heads} kv heads at "
                         f"tensor={t}: heads the tensor axis does not divide are not served by the PyTorch port yet: "
                         "ROADMAP Queue 1, multi-GPU (a gang's heads that the tensor axis does not divide)")
    shard = family.shard_model(draft_params, mesh)
    return shard.cfg.replace(quant_activations=draft_cfg.quant_activations), shard


def resolve_role(flag: Optional[str], params: Dict[str, Any]) -> str:
    """The disaggregated role: the flag, else SUBSTRATUS_SERVE_ROLE, else
    params.json ``role``, else "both"; exits on any other value."""
    role = flag or os.environ.get("SUBSTRATUS_SERVE_ROLE") or str(params.get("role", "both"))
    if role not in _ROLES:
        raise SystemExit(f"role {role!r} invalid (both|prefill|decode)")
    return role


def resolve_decode_peers(flag: Optional[str], params: Dict[str, Any]) -> List[str]:
    """A prefill tier's decode peers (host:port): the flag, else
    SUBSTRATUS_DECODE_PEERS (comma-separated both), else params.json
    ``decode_peers`` (a list)."""
    peers = params.get("decode_peers") or []
    if isinstance(peers, str) or not all(isinstance(p, str) for p in peers):
        raise SystemExit(f"params.json: decode_peers={peers!r} invalid (a list of host:port)")
    raw = flag or os.environ.get("SUBSTRATUS_DECODE_PEERS") or ",".join(peers)
    return [p.strip() for p in raw.split(",") if p.strip()]


def resolve_transfer_port(flag: Optional[int], params: Dict[str, Any]) -> int:
    """A decode tier's transfer port: the flag, else
    SUBSTRATUS_TRANSFER_PORT, else params.json ``transfer_port``, else
    8500 (serve/disagg.py's DEFAULT_TRANSFER_PORT)."""
    from substratus_tpu_torch.serve.disagg import DEFAULT_TRANSFER_PORT

    port = flag if flag is not None else os.environ.get("SUBSTRATUS_TRANSFER_PORT") or params.get(
        "transfer_port", DEFAULT_TRANSFER_PORT)
    try:
        return int(port)
    except (TypeError, ValueError):
        raise SystemExit(f"transfer_port={port!r} invalid (a port number)") from None


def check_params(params: Dict[str, Any]) -> None:
    """Exit on any key the port does not serve yet (naming its ROADMAP
    queue), on any key it does not know, and on an attention, weight,
    scheduler, speculation or drain setting it does not serve."""
    resolve_attn_impls(params)
    resolve_kv_layout(params)
    resolve_quantize(params)
    resolve_overlap(params)
    resolve_spec(None, None, params)
    resolve_drain_grace(params)
    if params.get("role", "both") not in _ROLES:
        raise SystemExit(f"params.json: role={params['role']!r} invalid (both|prefill|decode)")
    resolve_decode_peers(None, params)
    if "transfer_port" in params:
        resolve_transfer_port(params["transfer_port"], {})
    resolve_tensor(params)
    for key, value in params.items():
        if key in _NOT_SERVED:
            served, where = _NOT_SERVED[key]
            if value != served:
                raise SystemExit(
                    f"params.json: {key}={value!r} is not served by the PyTorch port yet: ROADMAP {where}"
                )
        elif key not in _SERVED:
            raise SystemExit(f"params.json: unknown key {key!r}")


def load_checkpoint(path: str, device=None, dtype=torch.bfloat16, quantize: str = "none",
                    mesh_for=None) -> Tuple[Any, Any]:
    """(cfg, model on `device`) of a checkpoint path, by the JAX entry
    point's rule: a .gguf file (or a directory holding one), then the
    port's own artifact, then a local HF directory. A JAX Orbax artifact
    exits: reading it needs JAX and Orbax. `dtype` applies to GGUF and HF
    checkpoints; an artifact keeps the dtype it was saved in. With
    quantize, an HF llama checkpoint is quantized as it loads, layer by
    layer (a Mixtral's dense bf16 would not fit the card); the caller
    quantizes the others after loading (quantize_weights), which gives the
    same bytes. With `mesh_for` (cfg -> a gang's mesh) an HF llama
    checkpoint loads as this rank's tensor shard, a layer at a time
    (load/hf.py); the caller shards the others (load_model)."""
    from substratus_tpu_torch.load.gguf import load_gguf, resolve_gguf_or_exit
    from substratus_tpu_torch.load.hf import load_pretrained
    from substratus_tpu_torch.train.checkpoints import FORMAT, META_FILE, load_artifact

    gguf = resolve_gguf_or_exit(path)
    if gguf is not None:
        return load_gguf(gguf, dtype=dtype, device=device)
    meta_path = os.path.join(path, META_FILE)
    if os.path.isfile(meta_path):
        with open(meta_path) as f:
            fmt = json.load(f).get("format")
        if fmt != FORMAT:
            raise SystemExit(f"{path}: an artifact of format {fmt!r} (the JAX package's Orbax artifacts are "
                             f"'substratus-tpu-v1', their weights need JAX and Orbax to read); the PyTorch port "
                             f"serves its own artifacts ({FORMAT!r}), GGUF files and local HF directories")
        return load_artifact(path, device=device)
    return load_pretrained(path, dtype=dtype, device=device, quantize=quantize, mesh_for=mesh_for)


def build_adapter_store(family, cfg, params_json: Dict[str, Any], adapters_dir_flag: Optional[str], device,
                        tp=None):
    """The multi-tenant AdapterStore (the JAX entry point's
    build_adapter_store), shared by this server and serve/batchgen.py, so
    a batch record's `model` field selects the same LoRA slots a request
    would: from --adapters-dir, else params.json `adapters`, else the
    mounted /content/adapters, on `device` in the model's dtype; on a gang
    rank (`tp`, its params' TensorShard) the rank's slice of each tenant.
    None when no adapters are configured, or when the family cannot index
    them (said, not silent)."""
    from substratus_tpu_torch.serve.adapters import AdapterStore, infer_store_shape, is_adapter_artifact

    adapters_cfg = params_json.get("adapters") or {}
    if not isinstance(adapters_cfg, dict):
        raise SystemExit(f"params.json: adapters={adapters_cfg!r} invalid (an object: dir, paths, capacity, rank, "
                         "targets)")
    adapters_dir = adapters_dir_flag or adapters_cfg.get("dir") or (
        CONTENT_ADAPTERS if os.path.isdir(CONTENT_ADAPTERS) else None)
    if not adapters_dir and not adapters_cfg.get("paths"):
        return None
    if not getattr(family, "SUPPORTS_INDEXED_LORA", False):
        # Tell the operator the tenants will not be served instead of
        # answering every adapter request 404 with nothing in the logs.
        print("multi-tenant adapters unsupported for this family; serving the base model only", flush=True)
        return None
    explicit = dict(adapters_cfg.get("paths") or {})
    discovered = {}
    if adapters_dir and os.path.isdir(adapters_dir):
        for entry in sorted(os.listdir(adapters_dir)):
            path = os.path.join(adapters_dir, entry)
            if is_adapter_artifact(path):
                discovered[entry] = path
    inferred_rank, inferred_targets = infer_store_shape(list(explicit.values()) + list(discovered.values()))
    store = AdapterStore(cfg, capacity=int(adapters_cfg.get("capacity", 8)),
                         rank=int(adapters_cfg.get("rank", inferred_rank)),
                         targets=tuple(adapters_cfg.get("targets", inferred_targets)), search_dir=adapters_dir,
                         device=device, tp=tp)
    for aid, path in explicit.items():
        store.register_path(aid, path)
    # Preload up to capacity, so first requests do not pay the artifact
    # read; the rest hot-load on demand (a cache miss).
    for aid in list(store.available_ids())[: store.capacity]:
        try:
            store.load(aid)
        except (OSError, ValueError) as e:
            print(f"adapter {aid!r} failed to preload: {e}", flush=True)
    print(f"adapter store: {len(store.loaded_ids())} loaded / {len(store.available_ids())} available "
          f"(capacity {store.capacity}, rank {store.rank}, targets {','.join(store.targets)})", flush=True)
    return store


def resolve_model_path(flag: Optional[str], params: Dict[str, Any]) -> Optional[str]:
    """The checkpoint to serve or train from: the flag, else params.json
    ``model``, else the container contract's mount if it exists."""
    return flag or params.get("model") or (CONTENT_MODEL if os.path.isdir(CONTENT_MODEL) else None)


def weights_digest(params) -> str:
    """A short digest of served weights: each state-dict tensor's name,
    shape, dtype and 4096 of its values at an even stride, read to the
    host. Replicas that must hold the same weights (the two tiers of a
    disaggregated pair) print the same digest."""
    h = hashlib.sha256()
    for name, t in sorted(params.state_dict().items()):
        if not torch.is_tensor(t):
            continue
        flat = t.detach().reshape(-1)
        sample = flat[:: max(1, flat.numel() // 4096)][:4096].contiguous().cpu()
        h.update(f"{name}{tuple(t.shape)}{t.dtype}".encode())
        h.update(sample.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def check_vocab(tokenizer, cfg) -> None:
    """Exit if the tokenizer has ids the model's embedding has no row for."""
    if tokenizer.vocab_size > cfg.vocab_size:
        raise SystemExit(f"the tokenizer has {tokenizer.vocab_size} ids but the model's embedding only "
                         f"{cfg.vocab_size} rows")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m substratus_tpu_torch.serve.main")
    ap.add_argument("--model", default=None,
                    help="checkpoint: a .gguf file, a port artifact or a local HF directory (default: params.json "
                         "model, else /content/model if mounted)")
    ap.add_argument("--config", default=None, help="named config served with random weights (default tiny)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8080, help="0 picks a free port")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--params", default="/content/params.json", help="params file (container contract)")
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument("--max-seq-len", type=int, default=None)
    ap.add_argument("--draft-model", default=None, help="draft checkpoint for speculative decoding (params.json "
                                                        "draft_model)")
    ap.add_argument("--spec-k", type=int, default=None, help="proposals a verify round (0 = off; params.json spec_k)")
    ap.add_argument("--adapters-dir", default=None,
                    help="directory of LoRA adapter artifacts served multi-tenant (one subdir per adapter id; "
                         "default: params.json adapters.dir, else /content/adapters when mounted)")
    ap.add_argument("--role", default=None, choices=_ROLES,
                    help="disaggregated serving role (serve/disagg.py): prefill workers hand KV pages to decode "
                         "workers; default both (monolithic). Env SUBSTRATUS_SERVE_ROLE, params.json role "
                         "(flag > env > params)")
    ap.add_argument("--transfer-port", type=int, default=None,
                    help="KV-transfer listen port of a decode tier (default 8500; env SUBSTRATUS_TRANSFER_PORT, "
                         "params.json transfer_port)")
    ap.add_argument("--decode-peers", default=None,
                    help="comma-separated host:port transfer endpoints of the decode tier, for a prefill tier "
                         "(env SUBSTRATUS_DECODE_PEERS, params.json decode_peers)")
    return ap.parse_args(argv)


def _skip_llama_knobs(cfg, params_json: Dict[str, Any], quantize: str) -> None:
    """Say which llama-only knobs a family without them skips, as the JAX
    entry point's _maybe_quantize and decode_attn_impl messages do."""
    if quantize != "none":
        print(f"{quantize} quantization not supported for this family; skipping", flush=True)
    for key in ("decode_attn_impl", "chunk_attn_impl", "attn_impl"):
        if params_json.get(key):
            print(f"{key} ignored: {type(cfg).__name__} has no attention implementation switch", flush=True)


def load_model(model_flag: Optional[str], config_flag: Optional[str], params_json: Dict[str, Any], device,
               quantize: str, mesh_for=None):
    """The served model, as both serving entry points (this one and
    serve/batchgen.py) load it: (cfg, params, tokenizer, name, family,
    quantize). A checkpoint (resolve_model_path) or a named config with
    random weights from seed 0; llama takes the attention knobs of
    params.json and is quantized on its device, layer by layer (drawn or
    loaded so: the dense model never stands whole, as mixtral-8x7b's could
    not); another family says which knobs it skips (quantize becomes
    "none"). With `mesh_for` (cfg -> a gang's mesh), a gang rank's: the
    whole model quantized, then this rank's tensor shard of it (an HF
    directory loads as the shard a layer at a time), and the returned cfg
    the shard's."""
    from substratus_tpu_torch.models import registry
    from substratus_tpu_torch.serve.tokenizer import load_tokenizer

    model_path = resolve_model_path(model_flag, params_json)
    stored = weight_mode(quantize)
    if model_path:
        cfg, params = load_checkpoint(model_path, device, quantize=stored, mesh_for=mesh_for)
        name = os.path.basename(os.path.normpath(model_path))
        tokenizer = load_tokenizer(model_path)
        tp = getattr(params, "tp", None)  # a shard's config holds its vocab rows; the tokenizer spans the model's
        check_vocab(tokenizer, cfg if tp is None else cfg.replace(vocab_size=tp.vocab_size))
    else:
        name = config_flag or params_json.get("config", "tiny")
        cfg = registry.find_named_config(name)[1]
        tokenizer = load_tokenizer(None)
        if cfg.vocab_size < tokenizer.vocab_size:
            cfg = cfg.replace(vocab_size=tokenizer.vocab_size)
        family = registry.module_of(cfg)
        drawn = {"quantize": stored} if getattr(family, "SUPPORTS_QUANTIZE", False) else {}
        params = family.init_params(cfg, seed=0, device=device, **drawn)
    family = registry.module_of(cfg)
    # The attention switches and quantized weights are llama's alone.
    if getattr(family, "SUPPORTS_QUANTIZE", False):
        decode_impl, chunk_impl, prefill_impl = resolve_attn_impls(params_json)
        knobs = dict(decode_attn_impl=decode_impl, chunk_attn_impl=chunk_impl, attn_impl=prefill_impl,
                     quant_activations=quantize == "w8a8")
        cfg = cfg.replace(**knobs)
        params = family.quantize_weights(params, stored)
        if mesh_for is not None:
            params = family.shard_model(params, mesh_for(cfg))
            cfg = params.cfg.replace(**knobs)
    elif mesh_for is not None:
        raise SystemExit(f"{family.__name__.rsplit('.', 1)[-1]} in a gang is not served by the PyTorch port yet: "
                         "ROADMAP Queue 1, multi-GPU (OPT and Falcon in a gang)")
    else:
        _skip_llama_knobs(cfg, params_json, quantize)
        quantize = "none"
    return cfg, params, tokenizer, name, family, quantize


def build(argv=None):
    """Parse the flags, build the model, engine and HTTP server, start the
    engine, and return the (not yet serving) serve.server.Server, with its
    checkpoint loader for POST /swapz and its drain grace."""
    from substratus_tpu_torch.models import registry
    from substratus_tpu_torch.serve.engine import Engine, EngineConfig
    from substratus_tpu_torch.serve.server import Server, ServerState
    from substratus_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    # Distributed tracing: join the spawner's trace (the TRACEPARENT
    # variable) and, with SUBSTRATUS_TRACE_EXPORT set, append the buffered
    # spans there as JSONL at exit, as the JAX entry point does.
    with tracer.span("serve.start", parent=context_from_env()):
        pass
    trace_export = os.environ.get("SUBSTRATUS_TRACE_EXPORT")
    if trace_export:
        atexit.register(tracer.export_jsonl, trace_export)
    params_json = load_params_json(args.params)
    check_params(params_json)
    role = resolve_role(args.role, params_json)
    peers = resolve_decode_peers(args.decode_peers, params_json) if role == "prefill" else []
    if role == "prefill" and not peers:
        raise SystemExit("role=prefill needs --decode-peers")
    gang, mesh_for = None, None
    coord, world, _ = distributed.world_info()
    if world > 1 and coord:
        # Refuse what a gang does not serve before the rendezvous, then join.
        check_gang_params(params_json, args)
        distributed.maybe_initialize(device_type="cpu" if args.device == "cpu" else "cuda")
        gang = distributed.current()
        device = gang.device
        mesh_for = GangMesh(gang.world, params_json)
    else:
        device = resolve_device(args.device)

    cfg, params, tokenizer, name, family, quantize = load_model(
        args.model, args.config, params_json, device, resolve_quantize(params_json), mesh_for=mesh_for)
    mesh = mesh_for.mesh if mesh_for is not None else None
    llama_knobs = getattr(family, "SUPPORTS_QUANTIZE", False)
    decode_impl = getattr(cfg, "decode_attn_impl", "kernel")
    prefill_impl = getattr(cfg, "attn_impl", "flash")

    def knob(flag, key, default):
        return flag if flag is not None else params_json.get(key, default)

    max_batch = gang_batch(int(knob(args.max_batch, "max_batch", 8)), mesh)
    # Bounded admission: 4x max_batch waiters by default, 0 = unbounded,
    # as the JAX entry point has it.
    max_queue = int(params_json.get("max_queue", 4 * max_batch))
    kv_layout = resolve_kv_layout(params_json)
    spec_k, draft_path = resolve_spec(args.spec_k, args.draft_model, params_json)
    if spec_k and draft_path and (kv_layout == "dense" or not getattr(family, "SUPPORTS_PAGED", False)):
        # The draft shares the target's page tables; prompt lookup would
        # work on the dense cache, but the operator asked for a draft.
        print("draft spec_k needs kv_layout=paged; speculation disabled", flush=True)
        spec_k = 0
    draft = None
    if spec_k and draft_path:
        draft_cfg, draft_params = load_checkpoint(draft_path, device)
        try:
            same_family = registry.module_of(draft_cfg) is family
        except TypeError:  # a family the port has not ported
            same_family = False
        if not same_family:
            raise SystemExit("draft model must be the same family as the target")
        # The draft rides the target's quantization: it is there to cut
        # the bytes a token costs, not to add bf16 streams.
        if llama_knobs:
            draft_cfg = draft_cfg.replace(quant_activations=cfg.quant_activations)
            draft_params = family.quantize_weights(draft_params, weight_mode(quantize))
        if mesh is not None:
            draft_cfg, draft_params = gang_draft(family, draft_cfg, draft_params, mesh)
        draft = (draft_cfg, draft_params)
    ec = EngineConfig(
        max_batch=max_batch,
        max_seq_len=int(knob(args.max_seq_len, "max_seq_len", 1024)),
        max_prefill_len=int(params_json.get("max_prefill_len", EngineConfig.max_prefill_len)),
        kv_cache_dtype=params_json.get("kv_cache_dtype", "model"),
        kv_layout=kv_layout,
        eos_token_id=tokenizer.eos_id,
        max_queue=max_queue if max_queue > 0 else None,
        overlap=resolve_overlap(params_json),
        spec_k=spec_k,
        role=role,
    )
    adapters = build_adapter_store(family, cfg, params_json, args.adapters_dir, device, tp=getattr(params, "tp", None))
    handoff = None
    if role == "prefill":
        from substratus_tpu_torch.serve.disagg import HandoffManager, PoolSpec

        handoff = HandoffManager(peers, PoolSpec.from_engine_config(cfg, ec))
        print(f"prefill role: decode peers {peers}", flush=True)
    sync = None
    if gang is not None:
        from substratus_tpu_torch.serve.multihost import StepSync

        sync = StepSync()
    try:
        engine = Engine(cfg, params, ec, device=device, model=family, draft=draft, adapters=adapters,
                        handoff=handoff, mesh=mesh, sync=sync)
    except ValueError:  # a role off the paged pool, a layout the family lacks
        if handoff is not None:
            handoff.close()
        raise
    spec = "off"
    if spec_k:
        spec = f"draft={draft_path} k={spec_k}" if draft is not None else f"prompt-lookup k={spec_k}"
    gang_line = ""
    if gang is not None:
        draft_shard = ""
        if draft is not None:
            draft_shard = f" ({draft[0].n_heads} heads, {draft[0].n_kv_heads} kv heads a rank)"
        store = "none" if adapters is None else (f"capacity {adapters.capacity}, rank {adapters.rank}, this rank's "
                                                 f"slice of each tenant")
        gang_line = (f"; gang: rank {gang.rank}/{gang.world} ({'leader' if gang.leader else 'follower'}), mesh "
                     f"{mesh.describe()}, data backend {gang.backend} (event broadcast: gloo), device {device}, "
                     f"collective timeout {gang.timeout_s} s; weights {quantize}: {shard_layout(params)}; max_batch "
                     f"{max_batch} (slots {engine.rows[0]}-{engine.rows[1] - 1} on this data replica); speculation "
                     f"{spec}{draft_shard}, eager rounds; adapter store {store}")
    if gang is not None and not gang.leader:
        # A follower binds no HTTP: it mirrors the leader's scheduler.
        engine.start()
        print(f"gang follower of {name} ({device}); scheduler: synchronous (lockstep), decode step eager, graph: "
              f"off (gang){gang_line}", flush=True)
        print(mesh_line(mesh), flush=True)
        return Follower(engine)

    def checkpoint_loader(ref: str):
        """POST /swapz's checkpoint ref -> weights ready to install: boot's
        load and quantize pipeline, so a checkpoint of the same
        architecture matches the served weights (any other is rejected by
        Engine.swap_params, never installed)."""
        if not os.path.exists(ref):
            raise FileNotFoundError(f"{ref}: no such checkpoint")
        # On the card, on a stream of its own: on the scheduler's, each of
        # the load's host copies would wait for the decode rounds queued
        # there. The host waits for the load alone before the swap.
        side = torch.cuda.Stream(device) if device.type == "cuda" else None
        try:
            with torch.cuda.stream(side) if side is not None else contextlib.nullcontext():
                _, new_params = load_checkpoint(ref, device, quantize=weight_mode(quantize) if llama_knobs else "none")
                if llama_knobs:
                    new_params = family.quantize_weights(new_params, weight_mode(quantize))
        except SystemExit as e:  # a file this port cannot load: the swap is refused
            raise ValueError(str(e)) from None
        if side is not None:
            side.synchronize()
        return new_params

    server = Server(ServerState(engine, tokenizer, name, checkpoint_loader=checkpoint_loader), host=args.host,
                    port=args.port, drain_grace_s=resolve_drain_grace(params_json))
    engine.start()
    if handoff is not None:
        server.closers.append(handoff.close)
    if role == "decode":
        from substratus_tpu_torch.serve.disagg import HandoffServer

        transfer = HandoffServer(engine, host=args.host, port=resolve_transfer_port(args.transfer_port, params_json))
        server.closers.append(transfer.close)
        print(f"decode role: KV transfer on :{transfer.port}", flush=True)
    weights = {"none": f"{str(cfg.dtype).removeprefix('torch.')} weights, torch.matmul",
               "int8": "int8 weights (scale after the dot), torch.einsum",
               "int4": f"int4 weights, int4 matmul kernel (q4_impl={params_json.get('q4_impl', 'auto')})",
               "w8a8": "w8a8: int8 weights x per-token int8 activations, the w8a8 quantize and s8 matmul kernels "
                       "(wo weight-only)"}
    # An artifact may hold quantized weights without a quantize knob (QLoRA's int8 base).
    held = set(family.quantized_layout(params).values()) if llama_knobs else set()
    shown = quantize if quantize != "none" or len(held) != 1 else held.pop()
    layout = f"kv_layout={params_json.get('kv_layout', 'auto')}"
    if engine.paged:
        cache = (f"paged KV ({layout}): pages of {engine.page_size} tokens, a pool of {engine.n_pages} pages and "
                 f"the trash page, prefix cache {'on' if engine.prefix is not None else 'off'}; prompts in chunks "
                 "through their block-table rows, chunks and decode steps attending the gathered pages with "
                 "plain PyTorch attention")
    else:
        prefill = "flash kernel" if prefill_impl == "flash" else "plain PyTorch"
        cache = (f"dense KV ({layout}); prefill attention: {prefill} "
                 f"(attn_impl={params_json.get('attn_impl', 'xla')}); decode attention: "
                 f"{'fused cache-write + decode kernel' if decode_impl == 'fused' else 'decode kernel'} "
                 f"(decode_attn_impl={params_json.get('decode_attn_impl', 'xla')}), long-prompt chunks: "
                 f"cached flash kernel (chunk_attn_impl={params_json.get('chunk_attn_impl', 'xla')}); "
                 f"{engine.attention_route()}")
    graph = ('a CUDA graph a width' if engine.spec else 'one CUDA graph') if engine.decode_graph else 'eager'
    if gang is not None:
        graph += ", graph: off (gang)"
    print(f"serving {name} on {args.host}:{server.port} ({device}); {weights[shown]}; {cache}; scheduler: "
          f"{'overlapped' if engine.overlap else 'synchronous'}, decode step {graph}; "
          f"speculative decoding: {spec}; role: {role}; weights digest {weights_digest(params)}; adapters: "
          + ("none" if adapters is None else f"{adapters.loaded_ids()} resident of {adapters.available_ids()} "
             f"(capacity {adapters.capacity}, rank {adapters.rank})") + gang_line, flush=True)
    if mesh is not None:
        print(mesh_line(mesh), flush=True)
    return server


class Follower:
    """A gang follower's stand-in for the Server: no HTTP; serve_forever
    waits for the engine, which ends on the leader's stop broadcast or on
    a failed collective."""

    def __init__(self, engine):
        self.state = SimpleNamespace(engine=engine)

    def serve_forever(self) -> bool:
        self.state.engine._thread.join()
        return self.state.engine.error is None


def main(argv=None) -> int:
    """Serve until SIGTERM or SIGINT, then drain (serve/server.py) and
    exit 0. A gang's rank exits 1 when its engine failed (a follower's
    death fails the leader's next collective); a follower exits 0 on the
    leader's stop."""
    server = build(argv)
    server.serve_forever()
    engine = server.state.engine
    if distributed.current() is not None:
        if engine.error is not None:
            print(f"gang rank {distributed.current().rank} engine died: {engine.error!r}", flush=True)
            return 1
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
