"""Continuous-batching inference engine (port of
substratus_tpu/serve/engine.py), on the paged pool or the dense cache, for
any model family (models/registry.py): llama on either layout, OPT and
Falcon on the dense cache in the model dtype (the JAX engine's
SUPPORTS_PAGED and SUPPORTS_INT8_KV are llama's alone).

  * the decode batch is a fixed array of slots. EngineConfig.kv_layout
    picks their cache: "paged" (a pool of pages [L, P, bs, KH, hd] shared
    by all slots, each slot's pages named by its row of a block table),
    "dense" (one max_seq_len region a slot, [L, B, KH, S, hd]) or "auto",
    the default, which is paged for a model family that supports it (llama
    does), as the JAX engine resolves it; either in the model dtype or
    int8;
  * paged: a prompt's full pages are published in a chain-hash registry
    (serve/paged_kv.py), so a later prompt with the same prefix shares
    them and prefills only the rest; the prompt runs as chunks of
    ``max_prefill_len`` through its block-table row. Pages are allocated
    as decoding crosses page boundaries; when the pool runs dry the
    registry's least recently used entries are evicted, then the youngest
    slot is preempted and later resumed with prompt + generated tokens
    (re-prefilled), and a request alone in a dry pool ends as truncated;
  * dense: each request is prefilled alone at a power-of-two bucket length
    and its KV fragment inserted into a free slot; a prompt longer than
    ``max_prefill_len`` runs as a sequence of chunks written straight into
    its slot's cache, each attending everything before it;
  * every decode step advances all slots one token and samples on the
    device; finished slots are freed and refilled between steps. On the
    card the step's device work is one CUDA graph, captured once and
    replayed (serve/decode_graph.py); on the paged pool the block table
    is one of its inputs.

Threading model: callers enqueue Requests (thread-safe); one scheduler
thread owns the model, the cache, the page bookkeeping and the generator,
so every cache write and every kernel launch is ordered on that thread's
current stream.

Scheduling (EngineConfig.overlap): the overlapped scheduler, the default,
dispatches step N+1, each continuing slot's token fed from step N's
output on the device, before it reads step N's tokens to the host, so the
host half of a step (the read, emits, release, admission) runs while the
card computes step N+1. A slot released at step N's drain still rides
step N+1; that step's token for it is dropped by the drain's identity
check. Pages a released slot held may be handed to a new request while
that step is in flight: its writes come after the step's on the stream.
Preemption and truncation first flush the step in flight, so they see a
settled batch. overlap=False reads each step's tokens before the next
dispatch.

Speculative decoding (EngineConfig.spec_k > 0): each round a proposer
guesses up to spec_k greedy tokens a slot, and one target forward over
[B, width] (a verify) scores them all; a greedy slot emits the longest
matching prefix plus the target's correction (full acceptance: the
proposals and no bonus token, the last one seeding the next round), a
sampling slot the verify's position-0 sample. The proposer is a draft
model (Engine(..., draft=(cfg, params)), on the paged pool only: its own
pool of the same pages, named by the target's block table, prefilled at
admission from the prefix hit on) or, without one, prompt lookup (the
continuation after the latest earlier match of the context's trailing
n-gram, host work). Per slot an EWMA of the acceptance rate sets the
draft length, degrades the slot to a plain row below spec_threshold and
re-probes it every spec_probe_every rounds. A round where nothing
proposes is a width-1 verify, a plain decode step. Rounds overlap as
steps do: round N+1 chains its tokens and positions from round N's
device outputs by the accept walk on the device, and round N's host walk
runs in round N+1's drain slot. On the card a round is a few CUDA graphs
(serve/decode_graph.py::SpecGraph).

The serving surface (serve/server.py) reads the engine through the JAX
engine's hooks: Request.cancelled (a stop-sequence match releases the slot
at the request's next emit, "stop"), load_snapshot() (/loadz), the JAX
engine's histograms and counters in observability/metrics.py (host clocks
read where the scheduler already waits: no metric adds a device sync) and
swap_params() (POST /swapz: the new weights copied into the served tensors
by the scheduler thread on a settled pipeline, so every captured graph
stays valid).

Batch generation (serve/batchgen.py) attaches a pull source
(set_source): the scheduler thread pulls the next request the moment a
slot frees, after the resume list and the submit queue, and admission
fills every free slot while a source is attached.

Multi-tenant adapters (Engine(..., adapters=AdapterStore), serve/adapters.py):
one engine serves N LoRA tenants on one base model, as the JAX engine
does. A request's adapter is resolved and its store slot pinned at
admission (hot-loaded on a miss; every slot pinned holds the request, an
unknown or unreadable artifact ends it as "error"); its prefill and every
chunk run with that slot's id, each decode step and verify with the
batch's per-row ids (a static input of the decode graph, slot 0 the
identity for rows without one), and the paged prefix chain is salted with
the adapter id, so pages never cross tenants. The store's device tensors
are written in place by this thread (AdapterStore.sync, before each
admission's prefill and each iteration), so no graph is captured again.

Forensics, as the JAX engine records them, all host clocks and host
integers the scheduler already holds (no device read is added, and nothing
enters a captured graph): each Request carries a RequestJourney
(observability/journey.py), made at submit under the submitter's span
context and stamped at the JAX engine's sites (admit, prefill, prefix
hit, the pool's and the adapter store's waits, preemption, flushes, each
drain and speculative round at the drain, each emit, the end); a finished
journey lands in the engine's JourneyLog (/debug/requestz?id=) and, when
it breached an SLO, in its SlowRing (/debug/slowz). Each scheduler
iteration that decodes is one record of the engine's StepTimeline
(observability/timeline.py, /debug/stepz), its time above the device
floor attributed to flushes, admission, a dry pool or host overrun.
Admission's prefill runs in an "engine.prefill" span under the request's
context, passed explicitly across the thread hop; the first decode
iteration in "engine.first_compile".

Disaggregated roles (EngineConfig.role, serve/disagg.py), on the paged
pool: a "prefill" engine runs a prompt's chunks, samples its first token,
reads the request's pages to the host once (_handoff_request), frees the
slot and ships pages and sampling state through its HandoffManager; it
never decodes, so its overlap resolves off. A "decode" engine refuses
submit() and a pull source: requests arrive as migrations
(submit_migration), whose pages are copied into freshly allocated pages of
its pool on the scheduler thread's stream, behind any step in flight
(_install_migration), and decode on. A requeued request (its decode worker
lost) boards the prefill engine again through resubmit().

Gangs (Engine(..., mesh=, sync=), serve/multihost.py): every rank of a
gang runs this engine over its tensor shard of the model
(models/llama.py's tensor-parallel forward), and the scheduler is
replicated: at the top of every iteration (_sync_iterate) the leader drains
its queue, numbers the new requests (sync_id) and broadcasts them with the
cancel latches, the stop and the swap barrier; every rank applies the same
events and runs the same iteration, so every rank issues the same
collectives in the same order. A follower refuses submit() and delivers
into a NullSink. Under a sync the scheduler is the synchronous one (a
settled batch each broadcast) with the idle tick of the JAX engine; under
a tensor axis the decode step and a speculative round run eagerly (no CUDA
graph can capture gloo's collectives). What a gang decides on the host is
a function of the event stream: the lookup scan, the round's width, each
slot's EWMA, the adapter store's LRU and hot loads (every rank admits in
broadcast order, and the ranks check each adapter admission's verdict and
slot equal before acting on it); the draft model is a shard of its own
(the target's serving rules), and a rank's adapter store holds its slice
of every tenant. The leader's pull source (batch generation) is pulled
inside _sync_iterate, so pulled requests ride the broadcast.

A mesh with a data axis above 1 splits the batch's slots into blocks,
as a NamedSharding of the batch over "data" lays them out: replica d owns
slots [d B/dp, (d+1) B/dp). The scheduler stays replicated (every rank
keeps every slot's state); a decode step runs the model on the replica's
own rows only, and the step's sampled tokens are exchanged over the data
group (an all-reduce of each replica's rows written into a zeroed [B]
buffer), at the same point of every iteration on every rank, so every
rank applies every row's token (a speculative round's verify exchanges
its greedy choices and position-0 samples [B, w + 1], the draft its
proposals [B, k], the same way). The dense cache holds the owned rows
only ([L, B/dp, KH, S, D]): a prefill runs on the slot's replica, which
broadcasts the first token over the data group. The paged pool is
replicated, as the JAX package keeps it (its block tables are global and a
prefix hit may name a page another replica's prompt wrote): every replica
runs every prefill, so every page a prompt writes is on every replica,
while decode writes land in pages only their own row reads (the prefix
registry holds prompt pages alone).
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import itertools
import logging
import math
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from substratus_tpu_torch.models import registry
from substratus_tpu_torch.observability.journey import JourneyLog, RequestJourney, SlowRing
from substratus_tpu_torch.observability.metrics import METRICS, RATIO_BUCKETS
from substratus_tpu_torch.observability.sketch import SLOTracker
from substratus_tpu_torch.observability.timeline import StepTimeline
from substratus_tpu_torch.observability.tracing import SpanContext, tracer
from substratus_tpu_torch.ops.decode_attention import pack_fragment
from substratus_tpu_torch.ops.headdim import check_head_dim, head_dim_route
from substratus_tpu_torch.ops.quant import dequantize_kv, quantize_kv
from substratus_tpu_torch.ops.sampling import sample
from substratus_tpu_torch.serve.adapters import AdapterCapacityError, UnknownAdapter
from substratus_tpu_torch.serve.decode_graph import DecodeGraph, SpecGraph
from substratus_tpu_torch.serve.multihost import NullSink, decode_events, encode_events
from substratus_tpu_torch.serve.paged_kv import PageAllocator, PrefixRegistry, SlotPages, chain_entries
from substratus_tpu_torch.utils.device import DeviceLike, resolve_device, seeded_generator


# The JAX engine's serving histograms and counters, under its names,
# types, labels and buckets (observed at the points where it observes
# them; declared at import so /metrics carries HELP and TYPE before the
# first request).
METRICS.histogram(
    "substratus_serve_ttft_seconds",
    "Time from request submission to its first generated token (seconds).",
)
METRICS.histogram(
    "substratus_serve_inter_token_seconds",
    "Gap between consecutive generated tokens of one request (seconds).",
)
METRICS.histogram(
    "substratus_serve_queue_wait_seconds",
    "Time from request submission to the start of its prefill (seconds).",
)
METRICS.histogram(
    "substratus_serve_batch_occupancy_ratio",
    "Active decode slots / max_batch, sampled once per scheduler iteration.",
    buckets=RATIO_BUCKETS,
)
METRICS.histogram(
    "substratus_serve_kv_page_utilization_ratio",
    "Allocated KV pages / pool size, sampled once per scheduler iteration "
    "(paged layout only).",
    buckets=RATIO_BUCKETS,
)
METRICS.histogram(
    "substratus_serve_phase_seconds",
    "Wall time of one scheduler phase (seconds), labeled by phase: "
    "admission (queue -> slots, prefill included), prefill (device prefill "
    "inside admission), sample (first-token sampling + host read), decode "
    "(the batched decode/verify dispatch of one iteration and, overlapped, "
    "the drain of the one before).",
)
METRICS.describe(
    "substratus_serve_first_compile_seconds",
    "Wall time of the first decode iteration (on the card the decode "
    "step's warm-up and CUDA graph capture dominate; steady-state decode "
    'is substratus_serve_phase_seconds{phase="decode"}).',
    type="gauge",
)
METRICS.histogram(
    "substratus_serve_host_overlap_seconds",
    "Host-side work (the deferred token read, emits, stop handling) "
    "hidden under the in-flight decode step by the overlapped scheduler "
    "(seconds).",
)
METRICS.describe(
    "substratus_serve_pipeline_flushes_total",
    "Overlapped-scheduler pipeline flushes by reason (drain|preempt|swap|"
    "graph|handoff): points where the engine must observe a settled batch "
    "before proceeding (graph: a new model config's decode graph; handoff: "
    "a prefill-role engine's page export).",
    type="counter",
)
METRICS.describe(
    "substratus_serve_prefill_tokens_total",
    "Prompt tokens actually prefilled through the model (prefix-cache "
    "misses; the cold-work half of the reuse ratio).",
    type="counter",
)
METRICS.describe(
    "substratus_serve_prefix_hit_tokens_total",
    "Prompt tokens satisfied from shared prefix pages instead of "
    "recompute (paged layout, serve/paged_kv.py).",
    type="counter",
)
METRICS.describe(
    "substratus_serve_spec_proposed_tokens_total",
    "Draft tokens proposed to speculative verify rounds (greedy streams "
    "only; placeholder rows and degraded streams do not count).",
    type="counter",
)
METRICS.describe(
    "substratus_serve_spec_accepted_tokens_total",
    "Proposed draft tokens the target model accepted (longest matching "
    "prefix of each verify round).",
    type="counter",
)
METRICS.describe(
    "substratus_serve_weight_swaps_total",
    "Hot weight-swaps by outcome: applied (weights copied into the served "
    "tensors, every captured graph kept) or rejected (name/shape/dtype "
    "mismatch; the engine keeps serving the old weights).",
    type="counter",
)
METRICS.describe(
    "substratus_serve_weights_version",
    "Version of the weights the engine is currently serving "
    "(bumped by Engine.swap_params; also on load_snapshot()/ /loadz).",
    type="gauge",
)


class EngineOverloaded(RuntimeError):
    """submit() rejected: the waiting queue is at its configured bound.
    `retry_after` (seconds) is the server's Retry-After, 1 s as the JAX
    engine gives it."""

    def __init__(self, queue_depth: int, retry_after: float = 1.0):
        super().__init__(f"engine overloaded: {queue_depth} requests already waiting")
        self.queue_depth = queue_depth
        self.retry_after = retry_after


class _StagedSwap:
    """One pending hot weight-swap, staged by swap_params() from any
    thread and applied by the scheduler thread at the top of its next
    iteration. The caller parks on `done`; `applied`/`error` carry the
    outcome back across the thread boundary (written before `done` is
    set)."""

    __slots__ = ("state", "version", "source", "done", "applied", "error")

    def __init__(self, state: Dict[str, object], version: Optional[int], source: str = "swap"):
        self.state = state
        self.version = version
        self.source = source  # the journey event in-flight requests record: "swap" or "rollout"
        self.done = threading.Event()
        self.applied: Optional[int] = None
        self.error: Optional[BaseException] = None


@dataclass
class EngineConfig:
    max_batch: int = 8  # decode slots
    max_seq_len: int = 1024  # cache length per slot
    # Longest single-shot prefill; longer prompts run in chunks of this size.
    max_prefill_len: int = 512
    # Waiting-queue bound: submit() raises EngineOverloaded beyond it.
    max_queue: Optional[int] = None
    top_k: int = 0  # static top-k (0 = disabled)
    eos_token_id: int = 2
    # "model" keeps the cache in the model dtype; "int8" stores entries
    # quantized per vector with f32 scales.
    kv_cache_dtype: str = "model"
    # KV layout (module docstring): "paged", "dense", or "auto" (paged when
    # the model family supports it), as in the JAX engine.
    kv_layout: str = "auto"
    page_size: int = 16  # tokens a page (paged)
    # The pool's size in tokens (paged). None = max_batch * max_seq_len,
    # the dense footprint; fewer oversubscribes the slots, and the
    # scheduler preempts (and later resumes) the youngest slot when the
    # pool runs dry.
    kv_pool_tokens: Optional[int] = None
    prefix_cache: bool = True  # share full prompt pages across requests (paged)
    # The overlapped scheduler (module docstring). None = on, as the JAX
    # engine resolves it for a single-process engine of role "both" or
    # "decode"; a "prefill" engine never decodes and resolves it off. False
    # gives the synchronous scheduler.
    overlap: Optional[bool] = None
    # Disaggregated serving (serve/disagg.py; module docstring): "both", the
    # monolithic engine; "prefill" (needs a HandoffManager and the paged
    # layout) or "decode" (accepts migrations, refuses submit()).
    role: str = "both"
    # Speculative decoding (module docstring): up to spec_k proposals a
    # greedy slot a round; 0 = off. Per slot the draft length is
    # ceil(ewma * spec_k) while the acceptance EWMA (decay spec_ewma_decay)
    # holds spec_threshold, else 0 (a plain row) with a k = 1 probe every
    # spec_probe_every rounds; spec_threshold 0 always proposes spec_k.
    spec_k: int = 0
    spec_threshold: float = 0.35
    spec_probe_every: int = 8
    spec_ewma_decay: float = 0.8
    # SLO thresholds (observability/sketch.py): emits over budget count in
    # substratus_slo_burn_total{slo=...}, and the mergeable percentile
    # sketches ride load_snapshot() (/loadz).
    slo_ttft_s: float = 2.0
    slo_inter_token_s: float = 0.25
    # Request-journey forensics (observability/journey.py): each request's
    # lifecycle event ring and the /debug/slowz ring of SLO-breaching
    # journeys. Pure host work on the scheduler thread, so it stays on.
    journey_events: int = 256
    slow_journeys: int = 32
    # The JAX engine's bench and test knob: the least wall time of a decode
    # iteration and of a prefill chunk (a simulated device step, so that a
    # CPU run of a tiny model lasts long enough to be interrupted). 0 = off.
    step_floor_s: float = 0.0


@dataclass
class Request:
    prompt_tokens: List[int]
    max_tokens: int = 64
    temperature: float = 0.0
    top_p: float = 1.0
    eos_token_id: Optional[int] = None
    # Each generated token id is put on this queue; None marks completion.
    out: "queue.Queue[Optional[int]]" = field(default_factory=queue.Queue)
    id: str = ""
    # Set before the terminal None: "stop" (eos or cancelled), "length"
    # (max_tokens or context window) or "error" (engine died).
    finish_reason: str = "stop"
    # Cooperative cancellation: a consumer (the server on a stop-sequence
    # match) sets it; the scheduler releases the slot (and its pages) at
    # the request's next emit instead of decoding to max_tokens.
    cancelled: bool = False
    # Host clocks for the latency histograms: submission (queue wait,
    # TTFT) and the previous emit (inter-token gap).
    submit_ts: float = 0.0
    last_emit_ts: float = 0.0
    # Multi-tenant serving (serve/adapters.py): the LoRA adapter id this
    # request runs under (None = the base model; a server's `model` field,
    # a batch record's `model`). `adapter_slot` is engine bookkeeping: the
    # store slot pinned for it while it holds a decode slot (0 = identity).
    adapter: Optional[str] = None
    adapter_slot: int = 0
    # The submitter's span context (taken at submit on the submitting
    # thread), the parent of the engine's spans on the scheduler thread;
    # and the request's lifecycle journey, made at submit under its trace
    # id and copied into the engine's JourneyLog when it ends.
    trace_ctx: Optional[SpanContext] = None
    journey: Optional[RequestJourney] = None
    # Gangs: the leader's number for the request (every rank's mirror
    # carries it), and the cancellation every rank applies, latched from
    # `cancelled` by the iteration's broadcast.
    sync_id: Optional[int] = None
    cancel_latched: bool = False


@dataclass
class _InFlightStep:
    """One dispatched decode step whose host read is deferred. `slots`
    pins the (slot, Request) pairs active at dispatch: a slot released or
    re-admitted before the drain fails the identity check, and its token
    never reaches a consumer. `pos_next` is the positions array after this
    step's advance, so the drain's context-window check is this step's
    even when a later dispatch has moved the live array on."""

    read: Callable[[], np.ndarray]  # waits for this step's tokens, host copy [B]
    slots: List[Tuple[int, "Request"]]
    pos_next: np.ndarray
    t_dispatch: float = 0.0  # host clock at the launch (a journey's drain latency)


@dataclass
class _InFlightSpecStep:
    """One dispatched speculative round whose host read is deferred, with
    _InFlightStep's identity check. The next round chains off its device
    outputs (SpecGraph's advance); `read` is its one host read. The base
    positions are the host's: a spec dispatch does not advance them, the
    drain does."""

    read: Callable[[], Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]]  # (choices, samples, draft props)
    props: Optional[np.ndarray]  # host [B, width-1] lookup proposals (None with a draft: read them)
    k_eff: np.ndarray  # host [B] each slot's draft length this round
    tried: np.ndarray  # host [B] planned a proposal (the EWMA decays on a lookup miss)
    greedy: np.ndarray  # host [B] rows of the accept walk
    slots: List[Tuple[int, "Request"]]
    t_dispatch: float = 0.0  # host clock at the launch (a journey's drain latency)


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _pad_to_bucket(tokens, cap: int):
    """Right-pad a token list to its power-of-two bucket (capped)."""
    true_len = len(tokens)
    bucket = min(_bucket(true_len), cap)
    padded = np.zeros((1, bucket), np.int64)
    padded[0, :true_len] = tokens
    return padded, true_len


class Engine:
    def __init__(
        self,
        cfg,
        params: nn.Module,
        ec: Optional[EngineConfig] = None,
        *,
        device: DeviceLike = None,
        model=None,
        decode_graph: bool = True,
        draft: Optional[Tuple[object, nn.Module]] = None,
        padded_cache: Optional[bool] = None,
        adapters=None,
        handoff=None,
        mesh=None,
        sync=None,
    ):
        """Serve `params` (the family module's parameter container, e.g. a
        models.llama.Llama) on `device`: cuda unless the caller passes
        device="cpu"; params must already live there. `model` is the
        family module, from the config's type when omitted.
        On the card the decode step (or the speculative round) is captured
        as CUDA graphs unless decode_graph=False (the eager step, kept to
        compare the two); on the CPU it always runs eagerly. `draft`
        (cfg, params of the same family, on the same device) proposes for
        ec.spec_k > 0; without it, prompt lookup does. The dense cache is
        laid out as the kernels read it (models/llama.py::init_cache:
        padded, default on the card); padded_cache=True asks for that
        layout on the CPU too. A head dim above the kernels' largest is
        refused here on the dense layout, where they read the cache.
        `adapters` (a serve.adapters.AdapterStore on the same device)
        serves its LoRA tenants multi-tenant: each batch row gathers its
        own adapter by slot index (a family without SUPPORTS_INDEXED_LORA
        raises, as in the JAX engine). `handoff` (a
        serve.disagg.HandoffManager) is where a prefill-role engine ships
        its requests. `mesh` (parallel.mesh.Mesh) with a tensor axis above
        1 serves `params`, this rank's shard (models.llama.shard_model),
        eagerly (with `draft`, the draft's shard too); `sync` (a
        serve.multihost.StepSync or TcpSync of more than one process)
        replicates the scheduler over the gang."""
        # Copy before clamping: never mutate the caller's config.
        ec = dataclasses.replace(ec) if ec is not None else EngineConfig()
        self.device = resolve_device(device)
        if params.device != self.device:
            raise ValueError(f"params live on {params.device}, engine device is {self.device}")
        if ec.kv_cache_dtype not in ("model", "int8"):
            raise ValueError(f"kv_cache_dtype {ec.kv_cache_dtype!r} invalid (expected 'model' or 'int8')")
        if ec.role not in ("both", "prefill", "decode"):
            raise ValueError(f"role {ec.role!r} invalid (both|prefill|decode)")
        if ec.role != "both" and sync is not None:
            raise ValueError("disaggregated roles are incompatible with lockstep sync (a gang engine is one replica; "
                             "split pools across gangs)")
        self.mesh = mesh
        tensor = mesh.shape["tensor"] if mesh is not None else 1
        self.data = mesh.shape["data"] if mesh is not None else 1
        if self.data > 1:
            if sync is None:
                raise ValueError("a data axis above 1 needs the gang's replicated scheduler (sync)")
            if ec.max_batch % self.data:
                raise ValueError(f"max_batch {ec.max_batch} is not a multiple of data={self.data} (serve.main rounds "
                                 "it up, as the JAX entry point does)")
        per = ec.max_batch // self.data
        # This replica's block of slots: [lo, hi).
        self.rows = (mesh.coords["data"] * per, (mesh.coords["data"] + 1) * per) if self.data > 1 else (0, per)
        # Host-clock seconds of the last exchanges over the data group (data > 1): a decode step's tokens, a
        # verify's choices and samples, a draft's proposals.
        self.exchange_s: Deque[float] = collections.deque(maxlen=4096)
        tp = getattr(params, "tp", None)
        if (tp.size if tp is not None else 1) != tensor:
            raise ValueError(f"the mesh's tensor axis is {tensor} but params are a shard of "
                             f"{tp.size if tp is not None else 1}: serve a rank's shard (models.llama.shard_model)")
        ec.max_seq_len = min(ec.max_seq_len, cfg.max_seq_len)
        ec.max_prefill_len = min(ec.max_prefill_len, ec.max_seq_len)
        if ec.max_prefill_len < 1 or ec.max_batch < 1 or ec.max_seq_len < 2:
            raise ValueError(
                f"invalid engine config: max_prefill_len={ec.max_prefill_len} "
                f"max_batch={ec.max_batch} max_seq_len={ec.max_seq_len}"
            )
        model = model if model is not None else registry.module_of(cfg)
        self.cfg, self.params, self.ec, self.model = cfg, params, ec, model
        B, S = ec.max_batch, ec.max_seq_len
        if ec.kv_cache_dtype == "int8" and not getattr(model, "SUPPORTS_INT8_KV", False):
            raise ValueError(f"kv_cache_dtype=int8 unsupported for {model.__name__}")
        cache_dtype = torch.int8 if ec.kv_cache_dtype == "int8" else None
        supports_paged = getattr(model, "SUPPORTS_PAGED", False)
        layout = ec.kv_layout
        if layout == "auto":
            layout = "paged" if supports_paged else "dense"
        if layout not in ("paged", "dense"):
            raise ValueError(f"kv_layout {layout!r} invalid")
        if layout == "paged" and not supports_paged:
            raise ValueError(f"kv_layout=paged unsupported for {model.__name__}")
        self.paged = layout == "paged"
        if ec.role != "both" and not self.paged:
            # The handoff ships pool pages; the dense slot cache has no
            # page-granular export.
            raise ValueError(f"role={ec.role!r} requires the paged kv layout")
        self.handoff = handoff
        if ec.role == "prefill":
            if handoff is None:
                raise ValueError("role='prefill' needs a serve.disagg.HandoffManager")
            handoff.bind_engine(self)
        if self.paged:
            bs = ec.page_size
            if bs < 1:
                raise ValueError(f"page_size {bs} invalid")
            if ec.kv_pool_tokens is not None and ec.kv_pool_tokens < 1:
                raise ValueError(f"kv_pool_tokens {ec.kv_pool_tokens} invalid")
            # One full-length sequence (and its one-past-the-prompt slot)
            # always fits.
            pool_tokens = max(B * S if ec.kv_pool_tokens is None else ec.kv_pool_tokens, S + bs)
            self.page_size = bs
            self.n_pages = -(-pool_tokens // bs)
            self.max_pages = -(-S // bs)  # a slot's block-table width
            # Physical page 0 is the trash page: idle slots' decode writes
            # land there (their block-table rows are zero), never in a live
            # page. The allocator hands out ids 1..n_pages.
            self.cache = model.init_paged_cache(cfg, self.n_pages + 1, bs, dtype=cache_dtype, device=self.device)
            self.block_table = np.zeros((B, self.max_pages), np.int64)
            self.alloc = PageAllocator(self.n_pages, first_page=1)
            self.prefix = PrefixRegistry(self.alloc) if ec.prefix_cache else None
            self.slot_pages = SlotPages(B)
        else:
            check_head_dim(cfg.head_size, "the engine's dense kv layout")
            self.cache = model.init_cache(cfg, B // self.data, S, dtype=cache_dtype, device=self.device,
                                          padded=padded_cache)
        if ec.spec_k < 0:
            raise ValueError(f"spec_k {ec.spec_k} invalid")
        self.spec = bool(ec.spec_k)
        # The adaptive draft length: each slot's acceptance EWMA (1.0, the
        # optimistic start, at admission) and its count of degraded rounds.
        self._spec_ewma = np.ones((B,), np.float64)
        self._spec_degraded = np.zeros((B,), np.int64)
        self.spec_draft = self.spec and draft is not None
        if self.spec_draft and not self.paged:
            # The draft names its pages through the target's block table;
            # a dense draft cache has no insert path. Prompt lookup works on
            # either layout.
            raise ValueError("draft-model spec_k requires the paged kv layout")
        if self.spec_draft:
            self.draft_cfg, self.draft_params = draft
            if self.draft_params.device != self.device:
                raise ValueError(f"draft params live on {self.draft_params.device}, engine device is {self.device}")
            draft_tp = getattr(self.draft_params, "tp", None)
            if (draft_tp.size if draft_tp is not None else 1) != tensor:
                # The draft is sharded by the target's serving rules (the
                # JAX engine's shard_tree of the draft over the same mesh).
                raise ValueError(f"the mesh's tensor axis is {tensor} but the draft is a shard of "
                                 f"{draft_tp.size if draft_tp is not None else 1}: serve the draft's shard too "
                                 "(models.llama.shard_model)")
            # The target's page ids index this pool too, in the same dtype.
            self.draft_cache = model.init_paged_cache(self.draft_cfg, self.n_pages + 1, bs, dtype=cache_dtype,
                                                      device=self.device)
        self.adapters = adapters
        if adapters is not None:
            if not getattr(model, "SUPPORTS_INDEXED_LORA", False):
                raise NotImplementedError(f"multi-tenant adapters unsupported for {model.__name__}")
            if adapters.device != self.device:
                raise ValueError(f"the adapter store lives on {adapters.device}, engine device is {self.device}")
        # Per-row adapter slot fed to every prefill, decode step and verify
        # (0 = identity); slot_adapter mirrors the pins so release can unpin.
        self.adapter_ids = np.zeros((B,), np.int64)
        self.slot_adapter: List[int] = [0] * B
        self.generator = seeded_generator(0, self.device)
        # Multi-process lockstep (serve/multihost.py): the broadcast list
        # replaces the queue as the scheduler's source, so requests enter it
        # only through _sync_iterate, identically on every rank.
        self.sync = sync if (sync is not None and sync.num_processes > 1) else None
        self._sync_seq = 0
        self._pulling = False  # the iteration's broadcast: the leader pulls from a source
        self._sync_reqs: Dict[int, Request] = {}
        self._synced: List[Request] = []
        # Where a follower's mirror requests deliver: nowhere (a tool that
        # reads a follower's tokens sets a recording sink's class).
        self.follower_sink = NullSink
        # A prefill-role engine never decodes, and a gang's broadcast needs a
        # settled batch: nothing to pipeline.
        self.overlap = ec.overlap is not False and ec.role != "prefill" and self.sync is None
        # No CUDA graph captures a mesh's collectives (gloo's run on the
        # host): its decode step runs eagerly.
        self.decode_graph = decode_graph and self.device.type == "cuda" and tensor == 1 and self.data == 1

        # Per-slot decode inputs live on the host and go to the device
        # each step (a few bytes per row).
        self.tokens = np.zeros((B,), np.int64)
        self.positions = np.zeros((B,), np.int64)
        self.temps = np.zeros((B,), np.float32)
        self.top_ps = np.ones((B,), np.float32)
        self.slot_req: List[Optional[Request]] = [None] * B
        self.slot_generated: List[int] = [0] * B
        self.active = np.zeros(B, dtype=bool)
        # Each slot's delivered tokens (a preempted request resumes with
        # prompt + these) and its admission order (preemption takes the
        # youngest slot, so the oldest requests keep their progress).
        self.slot_tokens: List[List[int]] = [[] for _ in range(B)]
        self.slot_admit_seq: List[int] = [0] * B
        self._admit_counter = 0
        # Requests that board before the queue: preempted ones, and one
        # held back because the pool was dry at its admission.
        self._resume: List[Request] = []
        # The pipeline's one in-flight step, and the per-slot "the host token
        # is newer" mask of the device feedback: a slot not fresh takes the
        # last dispatched step's token from the device (the graph's `out`);
        # admission marks its slot fresh, and once a drain or flush has
        # settled the batch every slot is.
        self._pending: Optional[_InFlightStep] = None
        self._token_fresh = np.ones((B,), bool)
        self._graph = None  # the DecodeGraph, or the SpecGraph of a spec engine
        self._graph_cfg = None  # the model config the graph was made for

        self.queue: "queue.Queue[Request]" = queue.Queue()
        # A decode-role engine's migrations (serve/disagg.py), fed by the
        # HandoffServer's connection threads; ones held back (pool dry,
        # adapter slots pinned) wait in _resume_migrations, in front.
        self._migrations: "queue.Queue" = queue.Queue()
        self._resume_migrations: List = []
        # The pull source of batch generation (set_source), or None.
        self.source = None
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._admitting: Optional[Request] = None
        self.error: Optional[BaseException] = None
        # Host-clock counters of the scheduler thread (read by benches).
        # "prefills" counts single-shot prefills, "prefill_chunks" the
        # chunks of chunked ones (on the paged pool every prompt runs as
        # chunks through its block-table row); "prefill_seconds" covers
        # both. "prefill_tokens" counts the tokens run through the model,
        # "prefix_hit_tokens" those a prompt took from shared pages instead;
        # "preemptions" and "truncated_by_pool" count the pool's two
        # answers to pressure, "max_active" the most slots ever decoding.
        # "decode_steps" counts dispatched steps and "decode_seconds" the
        # wall time of the scheduler iterations that decode (the dispatch of
        # one step and, overlapped, the drain of the one before), so its
        # mean is the gap between steps a client sees in either scheduler.
        # On the card "graph_replays" counts replays of the captured step
        # and "graph_warmups" its eager warm-up runs (decode_graph.py).
        # Speculation: "decode_steps" counts rounds, "verify_passes" those
        # wider than one token, "rounds_w<w>" those of width w;
        # "spec_proposed" and "spec_accepted" count greedy proposals and
        # the accepted ones; "draft_prefill_chunks" the draft's chunks;
        # a round's "graph_replays" holds one "replays_<graph>" of each of
        # its SpecGraph graphs. Disaggregated roles: "handoffs" counts a
        # prefill engine's shipped requests, "migrations_in" a decode
        # engine's installed ones.
        self.stats: Dict[str, float] = {
            "prefills": 0,
            "prefill_chunks": 0,
            "prefill_tokens": 0,
            "prefix_hit_tokens": 0,
            "prefill_seconds": 0.0,
            "preemptions": 0,
            "truncated_by_pool": 0,
            "max_active": 0,
            "decode_steps": 0,
            "decode_seconds": 0.0,
            "graph_replays": 0,
            "graph_warmups": 0,
            "verify_passes": 0,
            "spec_proposed": 0,
            "spec_accepted": 0,
            "draft_prefill_chunks": 0,
            "adapter_requests": 0,
            "handoffs": 0,
            "migrations_in": 0,
        }
        self.stats.update({f"rounds_w{w}": 0 for w in range(1, ec.spec_k + 2)} if self.spec else {})
        # Serving telemetry: one SLO tracker fed from _emit (its sketches
        # ride load_snapshot()), the first decode iteration's wall time
        # (substratus_serve_first_compile_seconds: the graph's warm-up and
        # capture on the card), a per-engine load-report sequence
        # (itertools.count is atomic under the GIL; HTTP threads call
        # load_snapshot concurrently), and the hot weight-swap's version
        # and staging queue.
        self.slo = SLOTracker({"ttft": ec.slo_ttft_s, "inter_token": ec.slo_inter_token_s})
        self._first_decode_done = False
        self._load_seq = itertools.count(1)
        self.weights_version = 0
        self._swap_q: "queue.Queue[_StagedSwap]" = queue.Queue()
        # Forensics: the step timeline (written by the scheduler thread
        # only; /debug/stepz reads it), the finished journeys
        # (/debug/requestz?id=) and the SLO-breaching ones (/debug/slowz),
        # both read by HTTP threads under their own locks. The _tl_
        # accumulators are the scheduler thread's scratch for the
        # iteration's record, reset at each loop top.
        self.timeline = StepTimeline()
        self.journey_log = JourneyLog()
        self.slow = SlowRing(ec.slow_journeys)
        self._tl_iter_t0 = 0.0
        self._tl_flush_s = 0.0
        self._tl_flush_reasons: List[str] = []
        self._tl_dispatch_s = 0.0
        self._tl_drain_s = 0.0
        self._tl_drain_off_s = 0.0
        self._tl_pool_dry = False

    # --- public API -------------------------------------------------------

    def clipped_prompt(self, prompt_tokens: List[int]) -> List[int]:
        """Keep the newest tokens that fit the cache, minus one slot for
        generation."""
        return prompt_tokens[-(self.ec.max_seq_len - 1):]

    def submit(self, req: Request) -> Request:
        if self.sync is not None and not self.sync.leader:
            raise RuntimeError("follower engine: requests arrive via the leader broadcast")
        if self.ec.role == "decode":
            raise RuntimeError("decode-role engine: requests arrive as KV migrations from the prefill tier "
                               "(serve/disagg.py)")
        if self.error is not None:
            req.finish_reason = "error"
            req.out.put(None)  # engine is dead; never strand the caller
            return req
        if self.ec.max_queue is not None:
            # Approximate (another submitter may race the read): overload
            # control holds the queue near its bound, not exactly at it.
            depth = self.queue.qsize()
            if depth >= self.ec.max_queue:
                raise EngineOverloaded(depth)
        if req.adapter is not None and (self.adapters is None or not self.adapters.known(req.adapter)):
            # Refuse an unservable adapter in the caller's thread, so the
            # server answers 404 before anything is queued.
            raise UnknownAdapter(req.adapter)
        req.submit_ts = time.perf_counter()
        if req.trace_ctx is None:
            # Taken on the submitting thread: the scheduler thread has no
            # span of the request's.
            req.trace_ctx = tracer.current_context()
        if req.journey is None:
            req.journey = RequestJourney(trace_id=req.trace_ctx.trace_id if req.trace_ctx else None,
                                         rid=req.id or None, origin=self.ec.role, cap=self.ec.journey_events)
        req.journey.record("submit", queue=self.queue.qsize(), prompt_tokens=len(req.prompt_tokens))
        self.queue.put(req)
        self._wake.set()
        if self.error is not None:
            # The scheduler may have died (and drained the queue) between
            # the check above and the put.
            req.finish_reason = "error"
            req.out.put(None)
        return req

    def resubmit(self, req: Request) -> None:
        """Board a request that already passed admission once again (a
        handoff requeued after its decode worker was lost,
        serve/disagg.py), past the max_queue bound: shedding an accepted
        request halfway through its stream would turn a worker's failure
        into a client's 429."""
        if self.error is not None:
            req.finish_reason = "error"
            req.out.put(None)
            return
        if req.journey is not None:
            req.journey.record("requeue", queue=self.queue.qsize())
        self.queue.put(req)
        self._wake.set()
        if self.error is not None:  # submit()'s race: never strand it
            req.finish_reason = "error"
            req.out.put(None)

    def submit_migration(self, mig) -> None:
        """Board a migrated request (a serve.disagg.Migration): its KV pages
        were computed by a prefill engine and are installed without
        recompute. Called from the HandoffServer's connection threads; the
        scheduler thread is the only consumer."""
        if self.ec.role != "decode":
            raise RuntimeError(f"role={self.ec.role!r} engine cannot accept migrations")
        if self.error is not None:
            mig.req.finish_reason = "error"
            mig.req.out.put(None)
            return
        self._migrations.put(mig)
        self._wake.set()
        if self.error is not None:
            mig.req.finish_reason = "error"
            mig.req.out.put(None)

    def set_source(self, source) -> None:
        """Attach (or detach, with None) a pull-based request source, the
        batch-generation admission path (serve/batchgen.py). The source's
        pull() runs on the scheduler thread and returns a Request (with its
        out sink) or None; pending() says whether pull() could yield. It is
        read after the resume list and the submit queue, so submitted
        requests board first. A decode-role engine refuses one: its
        requests arrive as migrations. On a gang the leader's source is
        pulled inside _sync_iterate, so pulled requests ride the broadcast
        like submitted ones; a follower refuses one."""
        if source is not None and self.ec.role == "decode":
            raise RuntimeError("decode-role engine: requests arrive as KV migrations, not from a pull source")
        if source is not None and self.sync is not None and not self.sync.leader:
            raise RuntimeError("follower engine: the leader owns the source; followers receive pulled requests via "
                               "the broadcast")
        self.source = source
        self._wake.set()

    def attention_route(self) -> str:
        """What the attention kernels run at, for the startup lines: the
        head dim (padded where the kernels are not built for it) and, on
        the dense layout, the cache's rows and head dim as laid out."""
        route = head_dim_route(self.cfg.head_size)
        if self.paged:
            return f"{route} (paged: plain attention, no kernel)"
        s, hd = self.cache["k"].shape[3:]
        return f"{route}; dense cache laid out {s} rows x head_dim {hd}"

    def swap_params(self, new_params, version: Optional[int] = None, *, source: str = "swap",
                    timeout_s: float = 120.0, wait: bool = True) -> Optional[int]:
        """Hot weight-swap: serve `new_params` (a module of the served
        model's structure, or its state dict) on the live engine.

        Callable from any thread. The new state must have the served
        one's names, and each tensor its shape and dtype (quantized
        weights: the packed values and scales, and the same packing); a
        mismatch raises ValueError here and the engine keeps serving the
        old weights. An accepted swap is staged for the scheduler thread,
        which installs it at the top of its next iteration on a settled
        pipeline (_flush("swap")) by copying every tensor into the served
        one in place: the decode graph, every SpecGraph width and the int4
        matmul's operand views read the weights by address, so each stays
        valid, with no new capture (the JAX engine's "no recompile"). The
        prefix registry is emptied (its pages hold the old weights' K/V);
        in-flight streams keep their own pages, positions and generator,
        so a swap to value-identical weights is token-exact across the
        boundary. The draft model is not swapped. The version becomes
        `version`, or the current one + 1; each in-flight request's journey
        records a `source` event ("swap", or "rollout" for a controller's
        rolling swap).

        On a gang the leader's staged swap sets the barrier: its version
        rides the iteration's broadcast and every rank installs its own
        staged weights at that iteration (stage with wait=False on the
        followers first; a follower with nothing staged within 60 s fails
        the gang). The broadcast version wins over a follower's `version`.

        With `wait` (the default) blocks until the scheduler applied the
        swap and returns the new version; wait=False returns None at once
        (gang followers)."""
        if self.error is not None:
            raise RuntimeError("engine is dead") from self.error
        if self._thread is None or self._stop.is_set():
            raise RuntimeError("swap_params needs a running engine")
        cur = self.params.state_dict()
        new = new_params.state_dict() if hasattr(new_params, "state_dict") else dict(new_params)
        mismatch = None
        if set(new) != set(cur):
            mismatch = f"names differ ({sorted(set(new) ^ set(cur))[:4]} not in both)"
        else:
            for name, c in cur.items():
                n = new[name]
                if torch.is_tensor(c) != torch.is_tensor(n):
                    mismatch = f"{name}: a tensor in one state only"
                elif torch.is_tensor(c) and (c.shape != n.shape or c.dtype != n.dtype):
                    mismatch = f"{name}: {tuple(n.shape)}/{n.dtype} vs served {tuple(c.shape)}/{c.dtype}"
                elif not torch.is_tensor(c) and c != n:
                    mismatch = f"{name}: {n} vs served {c}"
                if mismatch is not None:
                    break
        if mismatch is not None:
            METRICS.inc("substratus_serve_weight_swaps_total", {"outcome": "rejected"})
            raise ValueError(f"swap_params rejected: {mismatch}; matching structure is what keeps every captured "
                             "graph valid: load a checkpoint of the served architecture (or drain and restart for a "
                             "different one)")
        if source not in ("swap", "rollout"):
            raise ValueError(f"swap source {source!r} invalid (swap or rollout)")
        sw = _StagedSwap(new, version, source)
        self._swap_q.put(sw)
        self._wake.set()
        if not wait:
            return None
        deadline = time.monotonic() + timeout_s
        while not sw.done.wait(timeout=0.05):
            if not self._thread.is_alive():
                # Staged after the scheduler's last look at the queue.
                self._fail_staged_swaps(self.error or RuntimeError("engine stopped before the swap was applied"))
            elif time.monotonic() > deadline:
                raise TimeoutError(f"swap_params: the scheduler did not apply the swap within {timeout_s}s")
        if sw.error is not None:
            raise sw.error
        return sw.applied

    def _apply_swap(self, sw: _StagedSwap, version: int) -> None:
        """Install one staged swap (scheduler thread only): settle the
        pipeline so no step mixes two weight versions, then copy each
        tensor into the served one on this thread's stream (ordered before
        every later replay)."""
        self._flush("swap")
        with torch.no_grad():
            for name, t in self.params.state_dict().items():
                if torch.is_tensor(t):
                    t.copy_(sw.state[name])
        if self.device.type == "cuda":
            # The new tensors may come from another stream's pool (a
            # loader's): they are read before they can be freed and reused.
            torch.cuda.current_stream(self.device).synchronize()
        if self.paged and self.prefix is not None:
            while self.prefix.evict_lru():
                pass
        self.weights_version = version
        METRICS.inc("substratus_serve_weight_swaps_total", {"outcome": "applied"})
        METRICS.set("substratus_serve_weights_version", version)
        for req in self.slot_req:
            if req is not None and req.journey is not None:
                req.journey.record(sw.source, version=version)
        sw.applied = version
        sw.done.set()

    def _apply_staged_swaps(self) -> None:
        """Install every staged swap, in order."""
        while True:
            try:
                sw = self._swap_q.get_nowait()
            except queue.Empty:
                return
            self._apply_swap(sw, sw.version if sw.version is not None else self.weights_version + 1)

    def _fail_staged_swaps(self, exc: BaseException) -> None:
        """Unblock swap_params() waiters when the scheduler exits with
        their swap still staged (stop or crash)."""
        while True:
            try:
                sw = self._swap_q.get_nowait()
            except queue.Empty:
                return
            sw.error = exc
            sw.done.set()

    def load_snapshot(self) -> Dict[str, object]:
        """The load report of the gateway protocol (gateway/loadreport.py),
        the JAX engine's keys: host counters only, no device read, no
        lock (a slightly torn snapshot routes marginally worse, which is
        fine). Served on /loadz and compacted into the x-substratus-load
        header. `role` and `transfer_queue_depth` (a prefill engine's
        transfer queue, a decode engine's waiting migrations) are what a
        role-aware gateway routes by."""
        active = int(self.active.sum())
        if self.paged:
            kv_free = self.alloc.free_pages / max(1, self.n_pages)
        else:
            kv_free = (self.ec.max_batch - active) / self.ec.max_batch
        if self.ec.role == "prefill":
            transfer_q = self.handoff.depth()
        elif self.ec.role == "decode":
            transfer_q = self._migrations.qsize() + len(self._resume_migrations)
        else:
            transfer_q = 0
        snap = {
            "queue_depth": self.queue.qsize() + len(self._resume),
            "active_slots": active,
            "max_slots": self.ec.max_batch,
            "kv_free_frac": round(kv_free, 4),
            "max_queue": self.ec.max_queue,
            "role": self.ec.role,
            "transfer_queue_depth": transfer_q,
            "overlap": self.overlap,
            "weights_version": self.weights_version,
            "prefill_tokens": self.stats["prefill_tokens"],
            "prefix_hit_tokens": self.stats["prefix_hit_tokens"],
            # Report ordering for the gateway's fleet aggregator.
            "load_seq": next(self._load_seq),
            "load_ts": round(time.time(), 3),
            "slo": self.slo.snapshot(),
        }
        if self.adapters is not None:
            # Resident adapter ids and the hit/miss/evict counters: the
            # gateway's affinity scoring reads `adapters`
            # (gateway/loadreport.py).
            a = self.adapters.snapshot()
            snap["adapters"] = a["loaded"]
            snap["adapter_capacity"] = a["capacity"]
            snap["adapter_hits"] = a["hits"]
            snap["adapter_misses"] = a["misses"]
            snap["adapter_evictions"] = a["evictions"]
        src = self.source
        if src is not None and hasattr(src, "progress"):
            # Batch-generation progress (serve/batchgen.py), as the JAX
            # engine reports it.
            snap["batchgen"] = src.progress()
        if self.spec:
            # Lifetime acceptance, and each active greedy stream's draft
            # length as the policy would plan it next (0: degraded or
            # sampling).
            prop, acc = self.stats["spec_proposed"], self.stats["spec_accepted"]
            ks = []
            for slot in np.flatnonzero(self.active):
                req = self.slot_req[int(slot)]
                ewma = float(self._spec_ewma[int(slot)])
                if req is None or req.temperature != 0.0 or ewma < self.ec.spec_threshold:
                    ks.append(0)
                else:
                    ks.append(min(self.ec.spec_k, max(1, math.ceil(ewma * self.ec.spec_k))))
            snap["spec"] = {"proposed_tokens": prop, "accepted_tokens": acc,
                            "acceptance": round(acc / prop, 4) if prop else None, "adaptive_k": ks}
        return snap

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, name="engine-scheduler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop the scheduler; a step still in flight is drained first
        (_loop), so its tokens and releases reach their consumers."""
        self._stop.set()
        self._wake.set()
        if self._thread:
            self._thread.join(timeout=60)

    def generate(self, prompt_tokens: List[int], max_tokens: int = 32, **kw) -> List[int]:
        """Blocking single-request generation (engine must be started)."""
        req = self.submit(Request(prompt_tokens, max_tokens=max_tokens, **kw))
        out: List[int] = []
        while True:
            tok = req.out.get(timeout=600)
            if tok is None:
                return out
            out.append(tok)

    # --- scheduler ----------------------------------------------------------

    def _next_request(self) -> Optional[Request]:
        """Preempted and held-back requests board before the queue, the
        queue before the pull source."""
        if self._resume:
            return self._resume.pop(0)
        if self.sync is not None:
            # Lockstep: the queue drains only at _sync_iterate; admission
            # takes the broadcast's order, the same on every rank.
            return self._synced.pop(0) if self._synced else None
        try:
            return self.queue.get_nowait()
        except queue.Empty:
            pass
        if self.source is not None:
            # Continuous refill: a freed slot's replacement boards in this
            # same scheduler iteration, straight off the source.
            return self.source.pull()
        return None

    def _has_pending(self) -> bool:
        if self.sync is not None:
            return bool(self._resume) or bool(self._synced)
        return (bool(self._resume) or not self.queue.empty()
                or (self.source is not None and self.source.pending()))

    def _is_cancelled(self, req: Request) -> bool:
        """Lockstep reads the broadcast latch (every rank's at a given
        iteration); one process reads the live flag."""
        return req.cancel_latched if self.sync is not None else req.cancelled

    def _sync_iterate(self) -> bool:
        """The top of a scheduler iteration; False when the engine should
        stop. One process installs its staged swaps. A gang first settles
        the batch (_flush("gang")); the leader drains its queue, numbers
        the new requests and broadcasts them with this iteration's cancel
        latches, stop and swap barrier; every rank then applies them
        identically. The leader's pull source tops the gang up to its
        free slots here, its requests numbered and broadcast like
        submitted ones."""
        if self.sync is None:
            self._apply_staged_swaps()
            return not self._stop.is_set()
        self._flush("gang")
        leader_sw = None
        if self.sync.leader:
            new: List[Request] = []
            while True:
                try:
                    new.append(self.queue.get_nowait())
                except queue.Empty:
                    break
            if self.source is not None:
                budget = (self.ec.max_batch - int(self.active.sum()) - len(self._synced) - len(self._resume)
                          - len(new))
                while budget > 0:
                    r = self.source.pull()
                    if r is None:
                        break
                    new.append(r)
                    budget -= 1
            for r in new:
                self._sync_seq += 1
                r.sync_id = self._sync_seq
            cancels = [i for i, r in self._sync_reqs.items() if r.cancelled and not r.cancel_latched]
            stop = self._stop.is_set()
            # The swap barrier: one staged swap an iteration rides the
            # broadcast as its target version; not taken when stopping (the
            # exit path fails its waiter instead).
            if not stop:
                try:
                    leader_sw = self._swap_q.get_nowait()
                except queue.Empty:
                    pass
            swap_version = None
            if leader_sw is not None:
                swap_version = leader_sw.version if leader_sw.version is not None else self.weights_version + 1
            self.sync.broadcast(encode_events(new, cancels, stop, swap=swap_version, source=self.source is not None))
            msg = {"cancels": cancels, "stop": stop, "swap": swap_version, "source": self.source is not None}
        else:
            msg = decode_events(self.sync.broadcast(None))
            new = []
            for d in msg["reqs"]:
                self._sync_seq += 1  # mirrors the leader's numbering
                new.append(Request(prompt_tokens=d["p"], max_tokens=d["m"], temperature=d["t"], top_p=d["tp"],
                                   eos_token_id=d["e"], id=d["id"], adapter=d.get("ad"), out=self.follower_sink(),
                                   sync_id=d["sid"]))
        # Admission fills freely while the leader pulls from a source: the
        # broadcast's word, the same on every rank.
        self._pulling = bool(msg.get("source"))
        for r in new:
            self._sync_reqs[r.sync_id] = r
            self._synced.append(r)
        for cid in msg["cancels"]:
            r = self._sync_reqs.get(cid)
            if r is not None:
                r.cancel_latched = True
        if msg["stop"]:
            self._stop.set()
            return False
        swap_version = msg.get("swap")
        if swap_version is not None:
            if self.sync.leader:
                sw = leader_sw
            else:
                # The leader committed the gang to swap at this iteration;
                # this rank's weights come through its own swap_params(...,
                # wait=False). A bounded wait keeps a misconfigured rollout
                # from wedging the gang silently.
                try:
                    sw = self._swap_q.get(timeout=60.0)
                except queue.Empty:
                    raise RuntimeError(f"gang swap barrier: leader swapped to weights_version {swap_version} but no "
                                       "params were staged on this process within 60s; call swap_params(..., "
                                       "wait=False) on every process") from None
            # The broadcast version wins: the gang agrees on what it serves.
            self._apply_swap(sw, int(swap_version))
        return True

    def _admit(self) -> int:
        """Fill free slots from the queue and the pull source; capped per
        iteration while slots decode, so a burst of arrivals cannot starve
        them, but not while a source is attached (an offline run's only
        objective is keeping every slot busy), as in the JAX engine. On the
        paged pool a request that finds too few pages is held at the front
        of the line and the round ends: decoding slots will free pages. A
        request's adapter is pinned first (_acquire_adapter): with every
        store slot pinned it is held the same way; an adapter that cannot
        be loaded ends the request as "error" and the slot stays free.
        A decode-role engine boards its migrations first (and they count
        toward the cap)."""
        admitted = self._admit_migrations()
        pulling = self._pulling if self.sync is not None else self.source is not None
        busy = self.active.any() and not pulling
        cap = max(1, self.ec.max_batch // 4) if busy else self.ec.max_batch
        while admitted < cap and self._has_pending() and not self.active.all():
            req = self._next_request()
            if req is None:
                break
            self._admitting = req
            verdict = self._acquire_adapter(req)
            if verdict == "dead":
                self._admitting = None
                continue
            if verdict == "wait":
                # Transient: every adapter slot is pinned by an active
                # request. Hold it at the front; decoding slots will unpin.
                if req.journey is not None:
                    req.journey.record_once("adapter_wait")
                self._admitting = None
                self._resume.insert(0, req)
                break
            slot = self._free_slot()
            # Queue wait is submission -> first prefill; a preempted
            # request boarding again (last_emit_ts set) already paid it.
            if req.submit_ts and not req.last_emit_ts:
                METRICS.observe("substratus_serve_queue_wait_seconds", time.perf_counter() - req.submit_ts)
            if req.journey is not None:
                wait_us = int((time.perf_counter() - req.submit_ts) * 1e6) if req.submit_ts and not req.last_emit_ts \
                    else 0
                req.journey.record("admit", slot=slot, wait_us=wait_us)
            t_prefill = time.perf_counter()
            # The request's context crosses from its submitter's thread
            # here, as an explicit parent.
            with tracer.span("engine.prefill", parent=req.trace_ctx, request_id=req.id, slot=slot,
                             prompt_tokens=len(req.prompt_tokens)):
                if self.paged:
                    ok = self._admit_paged(req, slot)
                else:
                    self._admit_dense(req, slot)
                    ok = True
            METRICS.observe("substratus_serve_phase_seconds", time.perf_counter() - t_prefill, {"phase": "prefill"})
            self._admitting = None
            if not ok:
                # Pool dry: the adapter pin drops too; boarding again
                # acquires it again. The timeline bills this iteration's
                # admission to capacity (pool_dry), not to host speed.
                if req.journey is not None:
                    req.journey.record_once("pool_wait")
                self._release_adapter_pin(req)
                self._resume.insert(0, req)
                self._tl_pool_dry = True
                break
            admitted += 1
        self.stats["max_active"] = max(self.stats["max_active"], int(self.active.sum()))
        return admitted

    def _acquire_adapter(self, req: Request) -> str:
        """Resolve and pin the request's adapter before its prefill (the
        JAX engine's). Returns "ok" (adapter_slot set; 0 = base), "wait"
        (every store slot is pinned: transient, hold the request) or
        "dead" (the adapter is unknown or its artifact unreadable: the
        request ends with finish_reason "error", the engine serves on).
        A gang's ranks admit in broadcast order, so the LRU choice and a
        hot load are the same on every rank; they agree on the verdict
        and the slot before acting on it (_agree_adapter), so a load that
        fails on one rank only fails the gang instead of diverging."""
        req.adapter_slot = 0
        if req.adapter is None:
            return "ok"
        error = None
        try:
            if self.adapters is None:
                raise UnknownAdapter(req.adapter)
            req.adapter_slot = self.adapters.acquire(req.adapter)
            verdict = "ok"
        except AdapterCapacityError:
            verdict = "wait"
        except (UnknownAdapter, OSError, ValueError) as e:
            verdict, error = "dead", e
        if self.sync is not None:
            self._agree_adapter(req, verdict)
        if verdict == "ok":
            self.stats["adapter_requests"] += 1
        elif verdict == "dead":
            # The artifact vanished (or is corrupt) between submit()'s
            # known() check and admission: fail this request, not the engine.
            logging.getLogger(__name__).warning("adapter %r failed to load for request %s: %s", req.adapter,
                                                req.id, error)
            req.finish_reason = "error"
            self._journey_end(req, "error", cause="adapter")
            req.out.put(None)
        return verdict

    def _agree_adapter(self, req: Request, verdict: str) -> None:
        """Every rank's admission of one adapter request, checked equal
        over the gang's control group (the same point of every rank's
        iteration): the verdict and the store slot. Raises (the engine
        dies, the rank exits 1) where they differ, e.g. an artifact one
        rank cannot read."""
        slots = self.adapters.n_slots if self.adapters is not None else 1
        code = ("ok", "wait", "dead").index(verdict) * slots + req.adapter_slot
        lo, hi = self.sync.agree(code)
        if lo != hi:
            raise RuntimeError(f"gang ranks disagree on adapter {req.adapter!r} of request {req.sync_id}: this rank "
                               f"{verdict} (slot {req.adapter_slot}); codes {lo}..{hi} (verdict x {slots} + slot)")

    def _release_adapter_pin(self, req: Request) -> None:
        if self.adapters is not None and req.adapter_slot:
            self.adapters.release(req.adapter_slot)
        req.adapter_slot = 0

    # --- disaggregated roles (serve/disagg.py) ------------------------------

    def _admit_migrations(self) -> int:
        """Board migrated requests (decode role): their pages arrive
        computed, so admission is an allocation and one scatter, no model
        forward, and no cap but the free slots. A migration that finds its
        adapter's store slots all pinned, or the pool dry, waits at the
        front (decoding slots will free them); none is preempted for, since
        a migration is cheaper to delay than a decode is to evict."""
        admitted = 0
        while (self._resume_migrations or not self._migrations.empty()) and not self.active.all():
            if self._resume_migrations:
                mig = self._resume_migrations.pop(0)
            else:
                try:
                    mig = self._migrations.get_nowait()
                except queue.Empty:
                    break
            if int(mig.pages["k"].shape[1]) > self.max_pages:
                # More pages than a slot holds (a prefill tier with a longer
                # max_seq_len): the request fails, not the engine.
                mig.req.finish_reason = "error"
                self._journey_end(mig.req, "error", cause="migration")
                mig.req.out.put(None)
                continue
            verdict = self._acquire_adapter(mig.req)
            if verdict == "dead":
                continue
            if verdict == "wait":
                self._resume_migrations.insert(0, mig)
                break
            if not self._install_migration(mig):
                self._release_adapter_pin(mig.req)
                self._resume_migrations.insert(0, mig)
                self._tl_pool_dry = True  # held for pages: the same bubble as a dry admission
                break
            admitted += 1
        return admitted

    def _install_migration(self, mig) -> bool:
        """Allocate pages for one migration, write its transferred KV into
        them and activate its slot, emitting the first token (sampled by the
        prefill engine, delivered by this one). False when the pool is dry
        (nothing held)."""
        req = mig.req
        n = int(mig.pages["k"].shape[1])
        owned = self._try_alloc(n)
        if owned is None:
            return False
        slot = int(np.flatnonzero(~self.active)[0])
        self.slot_pages.assign(slot, [], owned)  # imported pages are this engine's own
        self.block_table[slot] = 0
        self.block_table[slot, :n] = owned
        self._import_pages(mig.convert, owned, mig.pages)
        self.stats["migrations_in"] += 1
        self.slot_req[slot] = req
        self.slot_generated[slot] = 0
        self.slot_tokens[slot] = []
        self.slot_adapter[slot] = req.adapter_slot
        self.adapter_ids[slot] = req.adapter_slot
        self._admit_counter += 1
        self.slot_admit_seq[slot] = self._admit_counter
        self.active[slot] = True
        self.tokens[slot] = mig.first_token
        self._token_fresh[slot] = True  # the next dispatch feeds the host's token
        self._spec_ewma[slot] = 1.0
        self._spec_degraded[slot] = 0
        self.positions[slot] = mig.true_len
        self.temps[slot] = req.temperature
        self.top_ps[slot] = req.top_p
        if req.journey is not None:
            req.journey.record("install", slot=slot, pages=n, tokens=mig.true_len)
        self._emit(slot, mig.first_token)
        return True

    def _import_pages(self, convert: str, owned: List[int], pages: Dict[str, torch.Tensor]) -> None:
        """Write transferred pages (on this engine's device) into the pool's
        pages `owned`, on this thread's stream, so behind any step in
        flight: "none" casts (bf16 <-> f32), "quantize" writes model-dtype
        pages into the int8 pool by the pool's own per-vector quantization,
        "dequantize" int8 pages into a model-dtype pool."""
        ids = self._to_device(np.asarray(owned, np.int64))
        if convert == "quantize":
            for name in ("k", "v"):
                q, scale = quantize_kv(pages[name])
                self.cache[name].index_copy_(1, ids, q)
                self.cache[f"{name}_scale"].index_copy_(1, ids, scale)
        elif convert == "dequantize":
            for name in ("k", "v"):
                self.cache[name].index_copy_(1, ids, dequantize_kv(pages[name], pages[f"{name}_scale"],
                                                                   self.cache[name].dtype))
        else:
            for name, t in self.cache.items():
                t.index_copy_(1, ids, pages[name].to(t.dtype))
        if self.device.type == "cuda":
            # Staged on the HandoffServer's copy stream: not freed for reuse
            # there before this stream's reads are done.
            stream = torch.cuda.current_stream(self.device)
            for t in pages.values():
                t.record_stream(stream)

    def _export_pages(self, pages: List[int]) -> Dict[str, torch.Tensor]:
        """One request's pages out of the pool, read to the host once (into
        pinned memory on the card): {name: [L, n, bs, KH, hd]} (scales
        [..., 1])."""
        ids = self._to_device(np.asarray(pages, np.int64))
        cuda = self.device.type == "cuda"
        host = {}
        for name, t in self.cache.items():
            frag = t.index_select(1, ids)
            host[name] = torch.empty(frag.shape, dtype=frag.dtype, pin_memory=cuda)
            host[name].copy_(frag, non_blocking=cuda)
        if cuda:
            torch.cuda.current_stream(self.device).synchronize()
        return host

    def _handoff_request(self, req: Request, slot: int, first_id: int, true_len: int) -> None:
        """Prefill role: export the admitted slot's pages (shared prefix
        pages too), free the slot (its own pages; registered ones stay in
        the prefix registry) and hand pages, first token and sampling state
        to the transfer layer. The slot never activates: the decode tier
        owns the rest of the request. The export reads the live pool, so
        it must see a settled batch; a prefill engine never decodes, so
        this flush is a guard that pins the invariant."""
        self._flush("handoff")
        pages = list(self.slot_pages.pages[slot])
        t0 = time.perf_counter()
        host = self._export_pages(pages)
        export_us = int((time.perf_counter() - t0) * 1e6)
        self.slot_pages.release(slot, self.alloc)
        self.block_table[slot] = 0
        self._release_adapter_pin(req)
        self.stats["handoffs"] += 1
        if req.journey is not None:
            # export_us: the gather and the read to the host.
            req.journey.record("ship", tokens=true_len, pages=len(pages),
                               bytes=sum(t.numel() * t.element_size() for t in host.values()), export_us=export_us)
        self.handoff.ship(req, host, true_len, first_id)

    def _prefill_lora(self, req: Request) -> Dict[str, object]:
        """forward()'s keywords for one request's prefill: the store's
        device tree and a [1] adapter id, after copying any slot the store
        wrote since the last sync (a hot load at this admission); {}
        without a store."""
        if self.adapters is None:
            return {}
        self.adapters.sync()
        return {"lora": self.adapters.device_tree(),
                "adapter_ids": self._to_device(np.array([req.adapter_slot], np.int64))}

    def _batch_lora(self, adapter_ids: Optional[torch.Tensor]) -> Dict[str, object]:
        """forward()'s keywords for a batched step: the device tree and the
        rows' ids [B] (a decode graph input); {} without a store."""
        if adapter_ids is None:
            return {}
        return {"lora": self.adapters.device_tree(), "adapter_ids": adapter_ids}

    def _free_slot(self) -> int:
        """The slot an admission takes: the first free one; under a data
        axis the first free one of the replica decoding the fewest rows,
        so that the replicas share the batch (JAX's engine takes the first
        free slot, and its first replica decodes every row of a batch up
        to B/dp; the rows' tokens are the same either way)."""
        free = np.flatnonzero(~self.active)
        if self.data == 1:
            return int(free[0])
        per = self.ec.max_batch // self.data
        load = self.active.reshape(self.data, per).sum(axis=1)
        return int(min(free, key=lambda s: (load[s // per], s)))

    def _owns(self, slot: int) -> bool:
        """Whether this data replica's block holds `slot`."""
        return self.rows[0] <= slot < self.rows[1]

    def _admit_dense(self, req: Request, slot: int) -> None:
        t0 = time.perf_counter()
        prompt = self.clipped_prompt(req.prompt_tokens)
        true_len = len(prompt)
        lora = self._prefill_lora(req)
        # An empty prompt, as the reference's dense path admits it, pads to
        # the smallest bucket and samples from the last padded row
        # (true_len - 1 = -1); decoding starts at position 0.
        if not self._owns(slot):
            # Another data replica's slot: its prefill runs there, and the
            # first token arrives by _finalize_admit's broadcast.
            last_logits = None
        elif true_len <= self.ec.max_prefill_len:
            padded, true_len = _pad_to_bucket(prompt, self.ec.max_prefill_len)
            with torch.inference_mode():  # serving builds no autograd graph
                logits, kv = self.model.forward(self.params, self._to_device(padded), self.cfg, **lora)
            self._insert(kv, slot)
            last_logits = logits[0, true_len - 1]
            self.stats["prefills"] += 1
        else:
            last_logits = self._chunked_prefill(prompt, slot, lora)
        self.stats["prefill_tokens"] += true_len
        METRICS.inc("substratus_serve_prefill_tokens_total", by=true_len)
        if req.journey is not None:
            req.journey.record("prefill", tokens=true_len, chunks=max(1, -(-true_len // self.ec.max_prefill_len)))
        self._finalize_admit(req, slot, last_logits, true_len)
        # _finalize_admit's host read of the first token ends the prefill.
        self.stats["prefill_seconds"] += time.perf_counter() - t0

    def _chunked_prefill(self, prompt: List[int], slot: int,
                         lora: Optional[Dict[str, object]] = None) -> torch.Tensor:
        """Prefill a prompt longer than one bucket on the dense cache: its
        chunks written in place into cache[:, slot] (a view whose per-layer
        slices are contiguous), each attending everything before it.
        Returns the last real token's logits."""
        row = slot - self.rows[0]  # the slot's row of this replica's dense cache
        slot_cache = {name: t[:, row : row + 1] for name, t in self.cache.items()}
        return self._run_chunks(prompt, 0, cache=slot_cache, lora=lora)

    def _run_chunks(self, prompt: List[int], start: int, cache: Dict[str, torch.Tensor],
                    block_table: Optional[torch.Tensor] = None, draft: bool = False,
                    lora: Optional[Dict[str, object]] = None) -> torch.Tensor:
        """Run prompt[start:] through the model (the draft model with
        `draft`: the base, as in the JAX engine) in bucket-sized chunks
        against `cache` (one slot's dense cache, or a paged pool through a
        block-table row [1, M]), each chunk attending everything before it,
        with the request's adapter keywords `lora` (_prefill_lora).
        Returns the last real token's logits."""
        params, cfg = (self.draft_params, self.draft_cfg) if draft else (self.params, self.cfg)
        counter = "draft_prefill_chunks" if draft else "prefill_chunks"
        chunk = self.ec.max_prefill_len
        kw = dict(lora or {})
        if block_table is not None:
            kw["block_table"] = block_table
        offset, last_logits = start, None
        while offset < len(prompt):
            t0 = time.perf_counter()
            padded, clen = _pad_to_bucket(prompt[offset : offset + chunk], chunk)
            tokens = self._to_device(padded)
            # The padded tail clamps onto the one slot past the prompt: real
            # queries never attend it, and the first decode step writes that
            # slot before reading it. Prompts are kept within
            # max_seq_len - 1, so the slot exists (paged: admission owns a
            # page for it).
            positions = torch.clamp(torch.arange(offset, offset + tokens.shape[1], device=self.device),
                                    max=offset + clen)[None, :]
            with torch.inference_mode():
                logits, _ = self.model.forward(params, tokens, cfg, positions=positions, cache=cache, **kw)
            last_logits = logits[0, clen - 1]
            offset += clen
            self.stats[counter] += 1
            self._floor(t0)
        return last_logits

    def _floor(self, t0: float) -> None:
        """Sleep out EngineConfig.step_floor_s since t0 (a simulated device
        step; 0, the default, never sleeps)."""
        dt = time.perf_counter() - t0
        if self.ec.step_floor_s > dt:
            time.sleep(self.ec.step_floor_s - dt)

    def _admit_paged(self, req: Request, slot: int) -> bool:
        """Paged admission: take the registry's pages for the prompt's
        shared prefix, allocate the rest, prefill only the unshared part
        through the slot's block-table row, then publish the prompt's full
        pages. False (nothing held) when the pool is dry."""
        t0 = time.perf_counter()
        bs = self.page_size
        # An empty prompt runs one pad token through the model, so that
        # first-token logits exist, as the JAX engine's paged path does.
        prompt = self.clipped_prompt(req.prompt_tokens) or [0]
        true_len = len(prompt)
        # Prefix chains are salted with the adapter id: K/V written under
        # one tenant's wk/wv deltas must never seed another tenant's (or
        # the base model's) prompt.
        entries = chain_entries(prompt, bs, salt=req.adapter) if self.prefix is not None else []
        # Reuse only pages strictly before the last prompt token: that
        # token must run through the model for its logits.
        shared = self.prefix.match(entries[: (true_len - 1) // bs]) if self.prefix is not None else []
        reuse = len(shared) * bs
        # Claim the shared pages before allocating owned ones: _try_alloc
        # may evict registry entries, and an unclaimed matched page could be
        # evicted and handed back as an owned one, one page in both roles.
        if shared:
            self.prefix.claim(shared)
        # Owned pages cover positions reuse..true_len: the bucket padding
        # writes the one slot past the prompt.
        owned = self._try_alloc(-(-(true_len + 1) // bs) - len(shared))
        if owned is None:
            for pid in shared:
                self.alloc.decref(pid)
            return False
        self.slot_pages.assign(slot, shared, owned)
        pages = self.slot_pages.pages[slot]
        self.block_table[slot] = 0
        self.block_table[slot, : len(pages)] = pages
        row = self._to_device(self.block_table[slot : slot + 1].copy())
        last_logits = self._run_chunks(prompt, reuse, cache=self.cache, block_table=row, lora=self._prefill_lora(req))
        if self.spec_draft:
            # The draft's prefill starts at the hit too: a shared page was
            # written by the admission that registered it, for both pools
            # (later writes land past every registered full page).
            self._run_chunks(prompt, reuse, cache=self.draft_cache, block_table=row, draft=True)
        self.stats["prefill_tokens"] += true_len - reuse
        self.stats["prefix_hit_tokens"] += reuse
        METRICS.inc("substratus_serve_prefill_tokens_total", by=true_len - reuse)
        if reuse:
            METRICS.inc("substratus_serve_prefix_hit_tokens_total", by=reuse)
        if req.journey is not None:
            if reuse:
                req.journey.record("prefix_hit", tokens=reuse)
            req.journey.record("prefill", tokens=true_len - reuse,
                               chunks=max(1, -(-(true_len - reuse) // self.ec.max_prefill_len)))
        n_full = true_len // bs
        if self.prefix is not None and n_full:
            self.prefix.register(entries[:n_full], pages[:n_full])
        self._finalize_admit(req, slot, last_logits, true_len)
        # _finalize_admit's host read of the first token ends the prefill.
        self.stats["prefill_seconds"] += time.perf_counter() - t0
        return True

    def _insert(self, kv: Dict[str, torch.Tensor], slot: int) -> None:
        """Write a prefill fragment {k, v: [L, 1, Sb, KH, hd]} into
        cache[:, slot, :, :Sb] (quantized when the cache is int8)."""
        frag = pack_fragment(self.cache, kv)
        row = slot - self.rows[0]  # the slot's row of this replica's dense cache
        for key, value in frag.items():
            sb = value.shape[3]
            self.cache[key][:, row, :, :sb].copy_(value[:, 0])

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device; on the card through pinned
        memory, so the copy makes the host wait for nothing."""
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _sample(self, logits: torch.Tensor, temps: np.ndarray, top_ps: np.ndarray) -> torch.Tensor:
        return sample(
            logits, self.generator, self._to_device(temps), top_k=self.ec.top_k, top_p=self._to_device(top_ps)
        )

    def _finalize_admit(self, req: Request, slot: int, last_logits, true_len: int) -> None:
        t_sample = time.perf_counter()
        first = None
        if last_logits is not None:
            first = self._sample(
                last_logits[None, :],
                np.array([req.temperature], np.float32),
                np.array([req.top_p], np.float32),
            )
        if self.data > 1 and not self.paged:
            first = self._share_first(first, slot)
        first_id = int(first[0])  # the host read of the first token
        METRICS.observe("substratus_serve_phase_seconds", time.perf_counter() - t_sample, {"phase": "sample"})
        if self.ec.role == "prefill":
            self._handoff_request(req, slot, first_id, true_len)
            return
        self.slot_req[slot] = req
        self.slot_generated[slot] = 0
        self.slot_tokens[slot] = []
        self.slot_adapter[slot] = req.adapter_slot
        self.adapter_ids[slot] = req.adapter_slot
        self._admit_counter += 1
        self.slot_admit_seq[slot] = self._admit_counter
        self.active[slot] = True
        self.tokens[slot] = first_id
        # The device's tokens predate this admission: the next dispatch
        # takes this slot's first token from the host.
        self._token_fresh[slot] = True
        # Adaptive speculation starts optimistic: no history of the slot's
        # last tenant carries over.
        self._spec_ewma[slot] = 1.0
        self._spec_degraded[slot] = 0
        self.positions[slot] = true_len
        self.temps[slot] = req.temperature
        self.top_ps[slot] = req.top_p
        self._emit(slot, first_id)

    def _share_first(self, first: Optional[torch.Tensor], slot: int) -> torch.Tensor:
        """A dense admission's first token [1] on every data replica: the
        slot's replica sampled it, and broadcasts it over the data group
        from its rank of this rank's other coordinates (ranks are laid out
        data-major, parallel/mesh.py)."""
        buf = torch.zeros((1,), dtype=torch.int64, device=self.device)
        if first is not None:
            buf.copy_(first)
        per_replica = self.mesh.size // self.data
        src = slot // (self.ec.max_batch // self.data) * per_replica + self.mesh.rank % per_replica
        dist.broadcast(buf, src=src, group=self.mesh.group("data"))
        return buf

    def _exchange(self, rows: torch.Tensor) -> torch.Tensor:
        """Every row's values [B, ...] (int64) from each data replica's own
        rows [B/dp, ...]: its rows written into a zeroed buffer, summed over
        the data group (gloo takes no all_gather of CUDA tensors; zeros add
        exactly). Every rank reaches every exchange, idle rows or not."""
        t0 = time.perf_counter()
        full = torch.zeros((self.ec.max_batch,) + tuple(rows.shape[1:]), dtype=torch.int64, device=self.device)
        full[self.rows[0]:self.rows[1]] = rows
        dist.all_reduce(full, group=self.mesh.group("data"))
        self.exchange_s.append(time.perf_counter() - t0)
        return full

    def _device_step(self, cfg, tokens: torch.Tensor, positions: torch.Tensor,
                     temps: torch.Tensor, top_ps: torch.Tensor,
                     block_table: Optional[torch.Tensor] = None,
                     adapter_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The decode step's device work: advance every slot one token (the
        cache is written in place; on the paged pool through the block
        table; each row with its adapter) and sample, all on the device.
        Under a data axis: this replica's rows only, then the exchange."""
        tokens, positions, temps, top_ps, block_table, adapter_ids = self._replica_rows(
            tokens, positions, temps, top_ps, block_table, adapter_ids)
        kw = self._batch_lora(adapter_ids)
        if block_table is not None:
            kw["block_table"] = block_table
        logits, _ = self.model.decode_step(self.params, self.cache, tokens, positions, cfg, **kw)
        sampled = sample(logits, self.generator, temps, top_k=self.ec.top_k, top_p=top_ps)
        return sampled if self.data == 1 else self._exchange(sampled)

    def _replica_rows(self, *inputs):
        """A step's per-row inputs (None passes) cut to this data
        replica's block of slots; all of them with one replica."""
        if self.data == 1:
            return inputs
        lo, hi = self.rows
        return tuple(None if t is None else t[lo:hi] for t in inputs)

    def _verify_step(self, cfg, tokens: torch.Tensor, positions: torch.Tensor,
                     temps: torch.Tensor, top_ps: torch.Tensor,
                     block_table: Optional[torch.Tensor] = None,
                     adapter_ids: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """A speculative round's target forward over tokens [B, w] at
        positions [B, w] (the cache written in place; each row with its
        adapter): the greedy choice at every position and the sample of
        position 0. At w = 1 it is the decode step. Under a data axis:
        this replica's rows only, then one exchange of the choices and
        the samples."""
        tokens, positions, temps, top_ps, block_table, adapter_ids = self._replica_rows(
            tokens, positions, temps, top_ps, block_table, adapter_ids)
        kw = self._batch_lora(adapter_ids)
        if block_table is not None:
            kw["block_table"] = block_table
        logits, _ = self.model.forward(self.params, tokens, cfg, positions=positions, cache=self.cache, **kw)
        sampled = sample(logits[:, 0], self.generator, temps, top_k=self.ec.top_k, top_p=top_ps)
        choices = logits.argmax(dim=-1)
        if self.data == 1:
            return choices, sampled
        both = self._exchange(torch.cat([choices, sampled.to(torch.int64)[:, None]], dim=1))
        return both[:, :-1], both[:, -1]

    def _propose_steps(self, tokens: torch.Tensor, positions: torch.Tensor, k: int,
                       block_table: torch.Tensor) -> torch.Tensor:
        """k greedy decode steps of the draft through its paged pool from
        tokens [B] at positions [B]: its proposals [B, k]. Under a data
        axis: this replica's rows, then one exchange of the proposals."""
        tokens, positions, block_table = self._replica_rows(tokens, positions, block_table)
        props = []
        for i in range(k):
            logits, _ = self.model.forward(self.draft_params, tokens[:, None], self.draft_cfg,
                                           positions=(positions + i)[:, None], cache=self.draft_cache,
                                           block_table=block_table)
            tokens = logits[:, 0].argmax(dim=-1)
            props.append(tokens)
        props = torch.stack(props, dim=1)
        return props if self.data == 1 else self._exchange(props)

    def _decode_graph(self):
        """The step's graph (a SpecGraph for a spec engine) for the current
        model config. A captured graph replays the config it was captured
        with, so a new config (a profile's turn of another decode
        attention) gets a new graph, after a flush: the device feedback
        lives in the old graph's buffers."""
        if self._graph is None or self._graph_cfg is not self.cfg:
            self._flush("graph")
            self._graph_cfg = self.cfg
            pages = self.max_pages if self.paged else 0
            if self.spec:
                self._graph = SpecGraph(functools.partial(self._verify_step, self.cfg),
                                        self._propose_steps if self.spec_draft else None, self.ec.max_batch,
                                        self.ec.spec_k, self.ec.max_seq_len - 1, self.device, self.generator,
                                        self.stats, capture=self.decode_graph, pages=pages,
                                        adapters=self.adapters is not None)
            else:
                self._graph = DecodeGraph(functools.partial(self._device_step, self.cfg), self.ec.max_batch,
                                          self.device, self.generator, self.stats, capture=self.decode_graph,
                                          pages=pages, adapters=self.adapters is not None)
        return self._graph

    def replayed_launches(self, counter: str) -> int:
        """The launches of a kernel counter ("function.counter", e.g.
        "decode_attention.launches") made by replays of the step's graphs,
        which the counter itself does not see: its launches in one replay
        times stats["graph_replays"] (a SpecGraph: summed over its graphs,
        each by its own replays)."""
        return self._graph.replayed_launches(counter) if self._graph is not None else 0

    # --- the paged pool under pressure -----------------------------------

    def _try_alloc(self, n: int) -> Optional[List[int]]:
        """n fresh pages, evicting the registry's least recently used
        entries under pressure; None (nothing held) when the pool is dry."""
        got: List[int] = []
        while len(got) < n:
            pid = self.alloc.alloc()
            if pid is not None:
                got.append(pid)
            elif self.prefix is None or not self.prefix.evict_lru():
                for p in got:
                    self.alloc.decref(p)
                return None
        return got

    def _pick_victim(self, exclude: int) -> Optional[int]:
        """The youngest active slot other than `exclude`."""
        others = [int(s) for s in np.flatnonzero(self.active) if s != exclude]
        return max(others, key=lambda s: self.slot_admit_seq[s], default=None)

    def _preempt(self, victim: int) -> None:
        """Evict a slot mid-decode: its pages free now, and its request (the
        same object, whose consumer keeps reading) boards again first, with
        prompt := prompt + delivered tokens and the budget that is left, so
        its re-prefill rebuilds the slot's context."""
        req = self.slot_req[victim]
        gen = self.slot_tokens[victim]
        req.prompt_tokens = list(req.prompt_tokens) + gen
        req.max_tokens -= len(gen)
        if req.journey is not None:
            req.journey.record("preempt", generated=len(gen))
        self._release_slot(victim)
        self._resume.insert(0, req)
        self.stats["preemptions"] += 1

    def _ensure_capacity(self, slot: int, upto: Optional[int] = None) -> None:
        """Before a step writes the slot's positions up to `upto` (default
        its next position), make sure pages back them: allocate, evicting
        registry entries, then preempt the youngest other slot. Alone in a
        dry pool, the request ends as truncated ("length"). Positions past
        the window need no page (their writes go to the trash page)."""
        if not self.active[slot]:
            return  # preempted earlier in this pass
        pos = min(int(self.positions[slot]) if upto is None else upto, self.ec.max_seq_len - 1)
        while pos // self.page_size >= len(self.slot_pages.pages[slot]):
            got = self._try_alloc(1)
            while got is None:
                if self._pending is not None:
                    # Preemption and truncation need a settled batch: the
                    # step in flight may release slots (and free pages) at
                    # its drain, and a victim's resume prompt needs every
                    # token it generated. Flush, then try again.
                    self._flush("preempt")
                    if not self.active[slot]:
                        return  # the flush released this very slot
                    got = self._try_alloc(1)
                    continue
                victim = self._pick_victim(exclude=slot)
                if victim is None:
                    req = self.slot_req[slot]
                    req.finish_reason = "length"
                    self._journey_end(req, "length", cause="pool")
                    req.out.put(None)
                    self._release_slot(slot)
                    if req.sync_id is not None:
                        self._sync_reqs.pop(req.sync_id, None)
                    self.stats["truncated_by_pool"] += 1
                    return
                self._preempt(victim)
                got = self._try_alloc(1)
            self.block_table[slot, len(self.slot_pages.pages[slot])] = got[0]
            self.slot_pages.append(slot, got[0])

    # --- speculative rounds ------------------------------------------------

    @staticmethod
    def _prompt_lookup(ctx, k: int, max_n: int = 3) -> Optional[np.ndarray]:
        """Prompt-lookup proposal: the continuation after the most recent
        earlier occurrence of the context's trailing n-gram (largest n
        first), k tokens (a short continuation padded with its last token),
        or None when nothing matches."""
        a = np.asarray(ctx, np.int32)
        n_ctx = a.size
        for n in range(min(max_n, n_ctx - 1), 0, -1):
            tgt = a[n_ctx - n:]
            # Starts 0..n_ctx-n-1: windowing a[:-1] leaves out the trailing n-gram itself.
            win = np.lib.stride_tricks.sliding_window_view(a[: n_ctx - 1], n)
            hits = np.flatnonzero((win == tgt).all(axis=1))
            if hits.size:
                j = int(hits[-1])
                cont = a[j + n : j + n + k]
                if cont.size:
                    out = np.full((k,), cont[-1], np.int32)
                    out[: cont.size] = cont
                    return out
        return None

    def _plan_spec_round(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The adaptive draft length of the next round, per active slot:
        sampling slots never propose; greedy ones propose
        ceil(ewma * spec_k) while the EWMA holds spec_threshold, else none,
        with a k = 1 probe every spec_probe_every degraded rounds. Returns
        host (k_eff, tried, greedy) [B]; a lookup miss may still zero
        k_eff."""
        ec = self.ec
        k_eff = np.zeros((ec.max_batch,), np.int64)
        tried = np.zeros((ec.max_batch,), bool)
        greedy = np.zeros((ec.max_batch,), bool)
        for slot in np.flatnonzero(self.active):
            slot = int(slot)
            if self.slot_req[slot].temperature != 0.0:
                continue
            greedy[slot] = True
            ewma = float(self._spec_ewma[slot])
            if ewma >= ec.spec_threshold:
                k_eff[slot] = min(ec.spec_k, max(1, math.ceil(ewma * ec.spec_k)))
                tried[slot] = True
                self._spec_degraded[slot] = 0
            else:
                self._spec_degraded[slot] += 1
                if self._spec_degraded[slot] >= ec.spec_probe_every:
                    self._spec_degraded[slot] = 0
                    k_eff[slot] = 1
                    tried[slot] = True
        return k_eff, tried, greedy

    def _spec_history(self, slot: int) -> Optional[List[int]]:
        """The lookup scan's context: prompt and delivered tokens, extended
        through the round in flight as if its proposals were all accepted
        (the verify rejects a wrong guess, so only speed depends on it). An
        in-flight row that proposed nothing has an unknown next token: the
        scan's own one-token guess stands in, and with none the slot
        proposes nothing this round (None)."""
        req = self.slot_req[slot]
        ctx = list(self.clipped_prompt(req.prompt_tokens) or [0]) + self.slot_tokens[slot]
        p = self._pending
        if p is None or self._token_fresh[slot]:
            return ctx  # a settled batch, or a slot admitted since the dispatch
        ke = int(p.k_eff[slot])
        if ke > 0:
            return ctx + [int(x) for x in p.props[slot, :ke]]
        guess = self._prompt_lookup(ctx, 1)
        return None if guess is None else ctx + [int(guess[0])]

    def _spec_dispatch(self) -> Optional[_InFlightSpecStep]:
        """Device half of one speculative round: plan each slot's draft
        length, scan for lookup proposals (host work that runs while the
        round before occupies the card), grow the pages the round writes,
        launch it (its tokens and positions chained from the round in
        flight on the device) and return the bookkeeping without reading
        anything back. The width is max(k_eff) + 1; width 1 is a plain
        decode step. None when capacity handling emptied the batch."""
        k_eff, tried, greedy = self._plan_spec_round()
        ec = self.ec
        lookup = None
        if not self.spec_draft:
            lookup = np.zeros((ec.max_batch, ec.spec_k), np.int64)
            for slot in np.flatnonzero(k_eff > 0):
                slot = int(slot)
                ctx = self._spec_history(slot)
                guess = None if ctx is None else self._prompt_lookup(ctx, int(k_eff[slot]))
                if guess is None:
                    # A plain row this round. A failed scan decays the EWMA;
                    # an unknowable history says nothing about the stream.
                    tried[slot] = ctx is not None
                    k_eff[slot] = 0
                else:
                    lookup[slot, : guess.size] = guess
        width = int(k_eff.max()) + 1
        if self.paged:
            # The round in flight may still move a slot on by its own
            # max(1, k_eff) before this one writes: that slack joins the
            # bound. _pending is read per slot, since _ensure_capacity may
            # flush it (the positions are then settled and the slack 0).
            for slot in np.flatnonzero(self.active):
                slot = int(slot)
                p = self._pending
                slack = max(1, int(p.k_eff[slot])) if p is not None and not self._token_fresh[slot] else 0
                self._ensure_capacity(slot, int(self.positions[slot]) + slack + width - 1)
            if not self.active.any():
                return None
        graph = self._decode_graph()
        # With nothing in flight every row takes the host's token and position.
        fresh = self._token_fresh if self._pending is not None else np.ones_like(self._token_fresh)
        t_dispatch = time.perf_counter()
        read = graph.launch(self.tokens, self.positions, self.temps, self.top_ps, fresh, k_eff, greedy, width,
                            props=lookup, **self._step_inputs())
        if width > 1:
            # Width-1 rounds are plain decode steps, not verify passes.
            self.stats["verify_passes"] += 1
        self.stats[f"rounds_w{width}"] += 1
        self.stats["decode_steps"] += 1
        self._token_fresh[:] = False
        return _InFlightSpecStep(read=read, props=None if lookup is None else lookup[:, : width - 1],
                                 k_eff=k_eff, tried=tried, greedy=greedy,
                                 slots=[(int(s), self.slot_req[int(s)]) for s in np.flatnonzero(self.active)],
                                 t_dispatch=t_dispatch)

    def _spec_drain(self, step: _InFlightSpecStep) -> None:
        """Host half of one speculative round: its one host read, then per
        slot active at dispatch (and still its request's) the accept walk,
        emits, release, and the EWMA's update. A greedy row emits the
        longest matching prefix of its proposals plus the target's
        correction, or on full acceptance the proposals alone (the last one
        seeds the next round); a sampling row its position-0 sample. The
        host positions move only here, so on entry a slot's is this
        round's base, and each emit carries its own (pos0 + i) for the
        window's release."""
        chs, smp, draft_props = step.read()
        t_drained = time.perf_counter()
        props = step.props if step.props is not None else draft_props
        d = self.ec.spec_ewma_decay
        for slot, req in step.slots:
            if self.slot_req[slot] is not req:
                continue  # released (or re-admitted) since the dispatch
            if req.journey is not None:
                # Stamped after the round's host read: the round's device
                # window never waits for forensics.
                req.journey.record("drain", lat_us=int((t_drained - step.t_dispatch) * 1e6))
            ke = int(step.k_eff[slot])
            pos0 = int(self.positions[slot])
            if not step.greedy[slot]:
                emit = [int(smp[slot])]
            else:
                accepted = 0
                while accepted < ke and props[slot, accepted] == chs[slot, accepted]:
                    accepted += 1
                if ke > 0:
                    if req.journey is not None:
                        req.journey.record("spec_round", k=ke, accepted=accepted)
                    self.stats["spec_proposed"] += ke
                    self.stats["spec_accepted"] += accepted
                    METRICS.inc("substratus_serve_spec_proposed_tokens_total", by=ke)
                    METRICS.inc("substratus_serve_spec_accepted_tokens_total", by=accepted)
                    self._spec_ewma[slot] = d * self._spec_ewma[slot] + (1.0 - d) * (accepted / ke)
                elif step.tried[slot]:
                    # A planned proposal the lookup could not make: a zero
                    # observation that leaves the counters alone.
                    self._spec_ewma[slot] = d * self._spec_ewma[slot]
                if ke > 0 and accepted == ke:
                    emit = [int(x) for x in props[slot, :ke]]
                else:
                    emit = [int(x) for x in props[slot, :accepted]] + [int(chs[slot, accepted])]
            self.tokens[slot] = emit[-1]
            for i, tok in enumerate(emit, start=1):
                self._emit(slot, tok, pos0 + i)
                if self.slot_req[slot] is not req:
                    break  # EOS, budget, window or cancellation within the run
            self.positions[slot] = min(pos0 + len(emit), self.ec.max_seq_len - 1)
        if not self.overlap:
            # Synchronous: the next round feeds host values only.
            self._token_fresh[:] = True

    def _dispatch_any(self):
        """The dispatch half on the engine's kind: a speculative round or a
        plain decode step."""
        return self._spec_dispatch() if self.spec else self._dispatch()

    def _drain_any(self, step) -> None:
        """The drain half matching the in-flight bookkeeping's kind."""
        if isinstance(step, _InFlightSpecStep):
            self._spec_drain(step)
        else:
            self._drain(step)

    def _step_inputs(self) -> Dict[str, np.ndarray]:
        """The host inputs a step's graph takes beyond the tokens and the
        sampling knobs: the block table on the paged pool, the rows'
        adapter slots with a store."""
        inputs = {}
        if self.paged:
            inputs["block_table"] = self.block_table
        if self.adapters is not None:
            inputs["adapter_ids"] = self.adapter_ids
        return inputs

    def _dispatch(self) -> Optional[_InFlightStep]:
        """Device half of one decode step: launch it (each continuing slot's
        token from the last step's output on the device, each freshly
        admitted one's from the host) and return the bookkeeping without
        reading anything back. Everything that waits for the device belongs
        in _drain, which the overlapped scheduler runs a step later. On the
        paged pool every slot first gets the page its write needs (which
        may flush, preempt or truncate); None when that emptied the batch."""
        if self.paged:
            for slot in np.flatnonzero(self.active):
                self._ensure_capacity(int(slot))
            if not self.active.any():
                return None
        graph = self._decode_graph()
        t_dispatch = time.perf_counter()
        read = graph.launch(self.tokens, self.positions, self.temps, self.top_ps, self._token_fresh,
                            **self._step_inputs())
        self._token_fresh[:] = False
        # Clamp at the last cache row: active slots are released at the
        # window before reaching it (_emit's hit_window), so the clamp only
        # holds inactive slots, whose positions would otherwise drift past
        # the cache every step they sit idle.
        self.positions = np.minimum(self.positions + 1, self.ec.max_seq_len - 1)
        self.stats["decode_steps"] += 1
        return _InFlightStep(read=read, slots=[(int(s), self.slot_req[int(s)]) for s in np.flatnonzero(self.active)],
                             pos_next=self.positions.copy(), t_dispatch=t_dispatch)

    def _drain(self, step: _InFlightStep) -> None:
        """Host half of one decode step: the one host read of the sampled
        tokens (it waits on the step's own event, never on the stream, so
        a step dispatched since keeps the card busy), then per-slot emits
        and EOS/budget/window release for the slots active at dispatch
        whose request still holds them."""
        host = step.read()
        t_drained = time.perf_counter()
        for slot, req in step.slots:
            if self.slot_req[slot] is not req:
                continue  # released (or re-admitted) since the dispatch
            if req.journey is not None:
                # Stamped after the host read, never inside the dispatch.
                req.journey.record("drain", lat_us=int((t_drained - step.t_dispatch) * 1e6))
            self.tokens[slot] = host[slot]
            self._emit(slot, int(host[slot]), int(step.pos_next[slot]))
        if not self.overlap:
            # Synchronous: the next dispatch feeds host tokens only.
            self._token_fresh[:] = True

    def _flush(self, reason: str = "drain") -> None:
        """Drain the in-flight step (or round) now, where the engine must
        see a settled batch: before the scheduler exits ("drain"),
        preemption or truncation ("preempt"), a weight swap ("swap"), a
        new decode graph ("graph") and a prefill-role engine's page export
        ("handoff"); counted by reason in
        substratus_serve_pipeline_flushes_total. The batch is then
        settled, and the next dispatch feeds host tokens for every slot."""
        pending, self._pending = self._pending, None
        if pending is None:
            return
        METRICS.inc("substratus_serve_pipeline_flushes_total", {"reason": reason})
        for slot, req in pending.slots:
            if self.slot_req[slot] is req and req.journey is not None:
                req.journey.record("flush", reason=reason)
        t_flush = time.perf_counter()
        self._drain_any(pending)
        # The timeline's flush bubble: a drain the pipeline could not hide.
        self._tl_flush_s += time.perf_counter() - t_flush
        self._tl_flush_reasons.append(reason)
        self._token_fresh[:] = True

    def _decode_step(self) -> None:
        """One synchronous iteration (overlap=False): dispatch, then drain
        at once (the simulated step floor between the two, as in JAX)."""
        t0 = time.perf_counter()
        step = self._dispatch_any()
        self._tl_dispatch_s = time.perf_counter() - t0
        if step is not None:
            self._floor(t0)
            t_drain = time.perf_counter()
            self._drain_any(step)
            self._tl_drain_off_s = t_drain - self._tl_iter_t0
            self._tl_drain_s = time.perf_counter() - t_drain

    def _step_overlapped(self) -> None:
        """One pipelined iteration: dispatch step N, then drain step N-1
        while step N occupies the card. Dispatch first: a dispatch that
        replaces the graph, or preempts, flushes the pending step itself."""
        t0 = time.perf_counter()
        launched = self._dispatch_any()
        self._tl_dispatch_s = time.perf_counter() - t0
        prev, self._pending = self._pending, launched
        if prev is not None:
            t_drain = time.perf_counter()
            self._drain_any(prev)
            self._tl_drain_off_s = t_drain - self._tl_iter_t0
            self._tl_drain_s = time.perf_counter() - t_drain
            if self._pending is not None:
                # Host work hidden under the step in flight.
                METRICS.observe("substratus_serve_host_overlap_seconds", time.perf_counter() - t_drain)
        self._floor(t0)

    def _step(self) -> None:
        """One scheduler iteration's decoding, on the resolved scheduler."""
        if self.overlap:
            self._step_overlapped()
        else:
            self._decode_step()

    def _emit(self, slot: int, token_id: int, pos_next: Optional[int] = None) -> None:
        """Deliver one token; release the slot at EOS, budget or context
        window. `pos_next` is the slot's next-write position as of the step
        that sampled the token: under overlap the live positions array has
        already moved on for the step in flight, and reading it would
        release a request at the window one token early."""
        req = self.slot_req[slot]
        eos = req.eos_token_id if req.eos_token_id is not None else self.ec.eos_token_id
        self.slot_generated[slot] += 1
        if pos_next is None:
            pos_next = int(self.positions[slot])
        hit_eos = token_id == eos
        hit_budget = self.slot_generated[slot] >= req.max_tokens
        hit_window = pos_next + 1 >= self.ec.max_seq_len
        cancelled = self._is_cancelled(req)
        if not hit_eos and not cancelled:
            now = time.perf_counter()
            if req.last_emit_ts:
                self._observe_latency(req, "inter_token", now - req.last_emit_ts)
            elif req.submit_ts:
                self._observe_latency(req, "ttft", now - req.submit_ts)
            req.last_emit_ts = now
            req.out.put(token_id)
            self.slot_tokens[slot].append(token_id)
            if req.journey is not None:
                req.journey.record("emit", t=token_id)
        if hit_eos or hit_budget or hit_window or cancelled:
            # EOS and cancellation are natural stops; the budget and the
            # context window truncate ("length").
            req.finish_reason = "stop" if hit_eos or cancelled else "length"
            self._journey_end(req, "cancel" if cancelled else req.finish_reason, tokens=self.slot_generated[slot])
            req.out.put(None)
            self._release_slot(slot)
            if req.sync_id is not None:
                self._sync_reqs.pop(req.sync_id, None)

    def _observe_latency(self, req: Request, slo: str, seconds: float) -> None:
        """One TTFT or inter-token gap: its SLO sketch and its histogram; a
        breach attaches the request's trace id to the histogram's bucket
        (an exemplar) and marks its journey for the slow ring."""
        breach = self.slo.observe(slo, seconds)
        j = req.journey
        METRICS.observe(f"substratus_serve_{slo}_seconds", seconds,
                        exemplar=j.trace_id if breach and j is not None else None)
        if breach and j is not None:
            j.breach(slo, seconds, self.slo.thresholds.get(slo, 0.0))
            METRICS.inc("substratus_serve_slo_exemplars_total", {"slo": slo})

    def _journey_end(self, req: Request, reason: str, **data) -> None:
        """Stamp the journey's "end" once, then keep the finished journey:
        in the JourneyLog, and in the slow ring when an SLO breached.
        Runs before the request's terminal None."""
        j = req.journey
        if j is None or j.ended:
            return
        j.record("end", reason=reason, **data)
        snap = j.snapshot()
        self.journey_log.add(snap)
        if j.breaches:
            self.slow.add(snap)

    def _release_slot(self, slot: int) -> None:
        self.active[slot] = False
        self.slot_req[slot] = None
        self.slot_tokens[slot] = []
        if self.adapters is not None and self.slot_adapter[slot]:
            self.adapters.release(self.slot_adapter[slot])
        self.slot_adapter[slot] = 0
        # Idle rows gather the identity adapter: their decode writes go on
        # (static shapes) and must stay adapter-free.
        self.adapter_ids[slot] = 0
        if self.paged:
            self.slot_pages.release(slot, self.alloc)
            # Point the idle row at the trash page: its decode writes go on
            # (static shapes) and must never land in a page the allocator
            # may hand to another request.
            self.block_table[slot] = 0

    def _loop(self) -> None:
        try:
            while self._sync_iterate():
                # The timeline's accumulators for this iteration's record:
                # _flush, the dispatch and drain halves and _admit fill them.
                t_iter = time.perf_counter()
                self._tl_iter_t0 = t_iter
                self._tl_flush_s = 0.0
                self._tl_flush_reasons = []
                self._tl_dispatch_s = self._tl_drain_s = self._tl_drain_off_s = 0.0
                self._tl_pool_dry = False
                if self.adapters is not None:
                    # Slots a host thread loaded since the last iteration,
                    # in place, ordered behind the step in flight.
                    self.adapters.sync()
                t_admit = time.perf_counter()
                admitted = self._admit()
                admit_s = time.perf_counter() - t_admit
                if admitted:
                    # Only iterations that boarded someone: an idle engine
                    # waking on its empty queue would flood it with ~0 s.
                    METRICS.observe("substratus_serve_phase_seconds", admit_s, {"phase": "admission"})
                if not self.active.any():
                    # Nothing decoding: a step still in flight holds only
                    # released slots, and waits for the next dispatch or
                    # the stop's flush. A gang keeps the 20 ms tick: every
                    # iteration pays a broadcast, and a follower's wake
                    # event never fires for the leader's submissions.
                    if self.sync is not None:
                        time.sleep(0.02)
                    else:
                        self._wake.wait(timeout=0.05)
                        self._wake.clear()
                    continue
                n_active = int(self.active.sum())
                METRICS.observe("substratus_serve_batch_occupancy_ratio", n_active / self.ec.max_batch)
                if self.paged:
                    METRICS.observe("substratus_serve_kv_page_utilization_ratio",
                                    (self.n_pages - self.alloc.free_pages) / self.n_pages)
                t0 = time.perf_counter()
                if not self._first_decode_done:
                    # The first iteration holds the decode graph's warm-up
                    # and capture: kept out of the steady-state histogram
                    # and the timeline, as the JAX engine keeps its compile.
                    with tracer.span("engine.first_compile") as span:
                        self._step()
                        dt = time.perf_counter() - t0
                        span.set_attribute("seconds", round(dt, 6))
                    self.stats["decode_seconds"] += dt
                    self._first_decode_done = True
                    METRICS.set("substratus_serve_first_compile_seconds", dt)
                    continue
                self._step()
                dt = time.perf_counter() - t0
                self.stats["decode_seconds"] += dt
                METRICS.observe("substratus_serve_phase_seconds", dt, {"phase": "decode"})
                self.timeline.record_iteration(
                    t_start=t_iter, wall_s=time.perf_counter() - t_iter, admit_s=admit_s, admitted=admitted,
                    dispatch_s=self._tl_dispatch_s, drain_s=self._tl_drain_s, drain_off_s=self._tl_drain_off_s,
                    flush_s=self._tl_flush_s, flush_reasons=self._tl_flush_reasons, pool_dry=self._tl_pool_dry,
                    active_slots=n_active, max_slots=self.ec.max_batch, configured_floor_s=self.ec.step_floor_s)
            # A clean stop with a step in flight delivers its tokens first.
            self._flush("drain")
            self._fail_staged_swaps(RuntimeError("engine stopped before the swap was applied"))
        except BaseException as e:  # propagate to waiting callers
            # Every request still held gets its terminal None: the slots of
            # the step in flight are among slot_req until their drain.
            self._pending = None
            self.error = e
            self._fail_staged_swaps(e)
            if self.sync is not None and self.sync.leader:
                # Best effort: a stop broadcast lets followers waiting at
                # the next iteration's broadcast exit instead of hanging.
                try:
                    self.sync.broadcast(encode_events([], [], True))
                except Exception:  # the collective itself may be what broke; `e` is re-raised below
                    logging.getLogger(__name__).warning("stop broadcast failed after an engine error",
                                                        exc_info=True)

            def kill(req: Request) -> None:
                req.finish_reason = "error"
                self._journey_end(req, "error", cause="engine")
                req.out.put(None)

            if self._admitting is not None:
                kill(self._admitting)
            for req in self._resume:
                kill(req)
            for mig in self._resume_migrations:
                kill(mig.req)
            while True:
                try:
                    kill(self._migrations.get_nowait().req)
                except queue.Empty:
                    break
            for req in self.slot_req:
                if req is not None:
                    kill(req)
            while True:
                try:
                    kill(self.queue.get_nowait())
                except queue.Empty:
                    break
            raise
