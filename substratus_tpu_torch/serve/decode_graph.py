"""The device half of one decode step over static buffers, captured on the
card as one CUDA graph (the counterpart of the JAX engine's jitted
``_build_decode``, substratus_tpu/serve/engine.py), and of a speculative
round (SpecGraph, below: a few graphs sharing one memory pool).

A DecodeGraph owns the step's inputs on the device (``tokens``,
``positions``, ``temps``, ``top_ps`` and the ``fresh`` mask; for an engine
on the paged pool also its ``block_table`` [B, max_pages]; for an engine
with an adapter store its rows' ``adapter_ids`` [B]) and its output
(``out``, the sampled tokens). The step itself, ``step(tokens, positions,
temps, top_ps[, block_table][, adapter_ids=]) -> sampled``, is the
engine's decode_step + sample over its cache and params, for any family:
the engine passes the family's ``decode_step`` only the arguments it
takes (a block table on the paged pool alone, so OPT and Falcon, dense
only, get none; adapter ids with a store alone, which only llama takes;
no attention switch, which only llama's config carries). The block table
and the adapter ids are inputs like the others, so a replay reads the
pages the engine has grown and the adapter slots its rows have taken
since the capture (the store's tensors are written in place, never
reallocated). Each launch:

  1. writes the host inputs into a pinned staging set (two sets, used in
     turns) and copies them into the static buffers without a host sync;
  2. runs the step on ``where(fresh, tokens, out)``: a slot admitted since
     the last step takes its first token from the host, every other slot
     the token the previous step sampled, straight from the device;
  3. copies ``out`` into a pinned host buffer of the same turn and records
     an event, before any later launch can overwrite ``out``.

``read`` waits on that event only, never on the stream, so a launch made
after it (the overlapped scheduler's next step) keeps the card busy. A
staging set and host buffer are reused two launches later, so every
launch must be read before the next-but-one: the engine's schedulers
drain each step before dispatching the one after next.

On the card with ``capture`` the first launch warms the step up on a side
stream (first-use work happens there: the kernels' build, the SM count,
the int4 matmul's cluster capacity and weight checks) and then captures
it under ``torch.cuda.graph``, the engine's generator registered with the
graph so each replay draws new numbers; every later launch replays it. A
capture that fails raises: there is no eager fallback. Without capture
(the CPU, or ``decode_graph=False`` on the card) the step runs eagerly
over the same buffers.

The kernel wrappers count launches in Python, when they are called, and
a replay calls none of them. So the capture records how many launches of
each counter one replay holds (``captured``, keyed ``"function.counter"``),
the counters are set back to their values before the capture (which
launched nothing), and ``stats["graph_replays"]`` counts replays: a
counter's launches are its value plus captured x replays. The warm-up's
launches are real and counted (``stats["graph_warmups"]``).
"""
from __future__ import annotations

import functools
import time
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from substratus_tpu_torch.ops.decode_attention import decode_attention
from substratus_tpu_torch.ops.flash_attention import flash_cached_attention
from substratus_tpu_torch.ops.fused_decode import fused_decode_attention
from substratus_tpu_torch.ops.quant import w8a8_matmul, w8a8_quantize
from substratus_tpu_torch.ops.quant4 import check_weight, q4_matmul

# The kernel wrappers a decode step or a speculative round can call, each
# with host-side counters (the cached flash kernel: a verify of more than
# one token on the dense cache; the w8a8 kernels under quantize: w8a8).
COUNTED = (decode_attention, fused_decode_attention, flash_cached_attention, q4_matmul, check_weight,
           w8a8_quantize, w8a8_matmul)

_INPUTS = ("tokens", "positions", "temps", "top_ps", "fresh")
# The optional inputs, each staged only when the engine has it.
_OPTIONAL = ("block_table", "adapter_ids")


def _counters() -> Iterator[Tuple[str, object, str]]:
    for fn in COUNTED:
        for attr, value in vars(fn).items():
            if isinstance(value, int) and (attr.startswith("launches") or attr == "calls"):
                yield f"{fn.__name__}.{attr}", fn, attr


def capture(body: Callable[[], None], device: torch.device, generator: torch.Generator, stats: Dict[str, float],
            pool=None) -> Tuple["torch.cuda.CUDAGraph", Dict[str, int], float]:
    """Warm `body` up on a side stream (real launches, counted), then
    capture it as a CUDA graph with the generator registered (in `pool`,
    where graphs share one). Returns (graph, the launches of each counter
    in one replay, host seconds of both); the counters are set back to
    their values before the capture, which launched nothing."""
    t0 = time.perf_counter()
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        body()
    current.wait_stream(side)
    stats["graph_warmups"] += 1
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(generator)
    before = {key: getattr(fn, attr) for key, fn, attr in _counters()}
    with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
        body()
    captured = {}
    for key, fn, attr in _counters():
        if getattr(fn, attr) != before[key]:
            captured[key] = getattr(fn, attr) - before[key]
            setattr(fn, attr, before[key])
    return graph, captured, time.perf_counter() - t0


class _Staged:
    """The host side of a launch over static buffers: host inputs written
    into one of two pinned staging sets (used in turns) and copied into
    the device buffers of the same names without a host sync; outputs
    copied into that turn's pinned host buffers behind an event, which a
    read waits on. A turn's buffers are reused two launches later, so
    each launch must be read before the launch after next."""

    what = "launch"

    def _init_staging(self, inputs: Tuple[str, ...], outputs: Tuple[str, ...]) -> None:
        cuda = self.device.type == "cuda"
        self.inputs = inputs

        def host(names):
            return {name: torch.empty(getattr(self, name).shape, dtype=getattr(self, name).dtype, pin_memory=cuda)
                    for name in names}

        self._staging = [host(inputs) for _ in range(2)]
        self._host_out = [host(outputs) for _ in range(2)]
        self._done = [torch.cuda.Event() if cuda else None for _ in range(2)]
        self._unread = [False, False]
        self._turn = 0

    def _stage(self, values) -> int:
        """Stage one launch's host inputs (in the order of `inputs`);
        returns its turn."""
        turn = self._turn
        if self._unread[turn]:
            raise RuntimeError(f"{self.what} launched before the one two launches back was read")
        self._turn ^= 1
        staging = self._staging[turn]
        for name, value in zip(self.inputs, values):
            staging[name].numpy()[:] = value
            getattr(self, name).copy_(staging[name], non_blocking=True)
        return turn

    def _finish(self, turn: int) -> None:
        """Queue the outputs' copy to the host behind the turn's event."""
        for name, out in self._host_out[turn].items():
            out.copy_(getattr(self, name), non_blocking=True)
        if self._done[turn] is not None:
            self._done[turn].record(torch.cuda.current_stream(self.device))
        self._unread[turn] = True

    def _wait(self, turn: int) -> Dict[str, np.ndarray]:
        """The turn's outputs on the host, once its event has passed."""
        if self._done[turn] is not None:
            self._done[turn].synchronize()
        self._unread[turn] = False
        return {name: out.numpy().copy() for name, out in self._host_out[turn].items()}

    def _init_optional(self, batch: int, pages: int, adapters: bool) -> None:
        """The optional device inputs: the paged pool's block table [batch,
        pages] and the rows' adapter slots [batch]; None where absent."""
        self.block_table = torch.zeros(batch, pages, dtype=torch.int64, device=self.device) if pages else None
        self.adapter_ids = torch.zeros(batch, dtype=torch.int64, device=self.device) if adapters else None

    def _optional(self) -> Tuple[str, ...]:
        return tuple(name for name in _OPTIONAL if getattr(self, name) is not None)

    def _check_optional(self, given: Dict[str, Optional[np.ndarray]]) -> None:
        owner = {"block_table": "the paged engine's step", "adapter_ids": "the step of an engine with an adapter store"}
        for name in _OPTIONAL:
            if (given[name] is None) != (getattr(self, name) is None):
                raise ValueError(f"a {name.replace('_', ' ')} is an input of exactly {owner[name]}")

    def _pages(self) -> tuple:
        """The block table as the step's positional argument, if any."""
        return () if self.block_table is None else (self.block_table,)

    def _ids(self) -> Dict[str, torch.Tensor]:
        """The rows' adapter slots as the step's keyword, if any."""
        return {} if self.adapter_ids is None else {"adapter_ids": self.adapter_ids}


class DecodeGraph(_Staged):
    """One decode step's static buffers and the step over them: captured
    and replayed on the card, run eagerly otherwise (module docstring)."""

    what = "decode step"

    def __init__(
        self,
        step: Callable[..., torch.Tensor],
        batch: int,
        device: torch.device,
        generator: torch.Generator,
        stats: Dict[str, float],
        capture: bool,
        pages: int = 0,
        adapters: bool = False,
    ):
        """`pages` > 0: the step also takes a block table [batch, pages];
        `adapters`: the rows' adapter slots [batch]."""
        if capture and device.type != "cuda":
            raise ValueError(f"a decode graph is captured on the card, not on {device}")
        self.step, self.device, self.generator, self.stats = step, device, generator, stats
        self.capture = capture
        self.tokens = torch.zeros(batch, dtype=torch.int64, device=device)
        self.positions = torch.zeros(batch, dtype=torch.int64, device=device)
        self.temps = torch.zeros(batch, dtype=torch.float32, device=device)
        self.top_ps = torch.ones(batch, dtype=torch.float32, device=device)
        self.fresh = torch.ones(batch, dtype=torch.bool, device=device)
        self.out = torch.zeros(batch, dtype=torch.int32, device=device)
        self._init_optional(batch, pages, adapters)
        self._init_staging(_INPUTS + self._optional(), ("out",))
        self.graph = None
        self.captured: Dict[str, int] = {}  # launches of each counter in one replay
        self.capture_seconds = 0.0  # host clock of the warm-up and the capture

    def _body(self) -> None:
        with torch.inference_mode():  # serving builds no autograd graph
            tokens = torch.where(self.fresh, self.tokens, self.out.to(torch.int64))
            self.out.copy_(self.step(tokens, self.positions, self.temps, self.top_ps, *self._pages(), **self._ids()))

    def _capture(self) -> None:
        self.graph, self.captured, self.capture_seconds = capture(self._body, self.device, self.generator, self.stats)

    def launch(self, tokens: np.ndarray, positions: np.ndarray, temps: np.ndarray, top_ps: np.ndarray,
               fresh: np.ndarray, block_table: Optional[np.ndarray] = None,
               adapter_ids: Optional[np.ndarray] = None) -> Callable[[], np.ndarray]:
        """Stage the host inputs, run the step (replay, capture first, or
        eager) and queue its tokens' copy to the host. Returns the read of
        this launch's tokens."""
        given = {"block_table": block_table, "adapter_ids": adapter_ids}
        self._check_optional(given)
        turn = self._stage((tokens, positions, temps, top_ps, fresh) + tuple(given[n] for n in self._optional()))
        if self.capture and self.graph is None:
            self._capture()
        if self.graph is not None:
            self.graph.replay()
            self.stats["graph_replays"] += 1
        else:
            self._body()
        self._finish(turn)
        return functools.partial(self._read, turn)

    def _read(self, turn: int) -> np.ndarray:
        return self._wait(turn)["out"]

    def replayed_launches(self, counter: str) -> int:
        """A kernel counter's launches inside the replays of the step."""
        return self.captured.get(counter, 0) * int(self.stats["graph_replays"])


# A speculative round's host inputs, staged as the decode step's are.
_SPEC_INPUTS = ("tokens", "positions", "temps", "top_ps", "fresh", "k_eff", "greedy")


class SpecGraph(_Staged):
    """One speculative round's device work over static buffers (the
    counterpart of the JAX engine's ``_build_spec_advance``,
    ``_build_propose`` and ``_build_verify``): captured on the card as a
    few CUDA graphs sharing one memory pool, run eagerly otherwise.

    A round of width w (1..spec_k+1) runs, in one launch:

      1. the host inputs (tokens, positions, temps, top_ps, the ``fresh``
         mask, this round's ``k_eff`` and ``greedy`` rows; with prompt
         lookup its proposals ``props_in`` [B, spec_k]; on the paged pool
         the block table; with an adapter store the rows' adapter slots,
         which the verify reads and the draft does not: it runs the base,
         as in the JAX engine) staged as in DecodeGraph;
      2. ``advance``: the previous round's accept walk on the device, from
         the state it left (``st_*``: its greedy choices, position-0
         samples, proposals, base positions, k_eff and greedy rows): per
         greedy row the longest matching prefix, full acceptance advancing
         k_eff with the last proposal as the next token, a mismatch
         accepted + 1 with the correction; other rows one position with
         their sample; a fresh row (admitted since, or every row after a
         settled batch) takes the host's token and position. Writes
         ``tok_in``, ``pos_in``;
      3. with a draft model, ``propose`` (spec_k greedy draft steps into
         ``draft_props``) for a wide round, or ``propose1`` (one draft
         step, its token dropped, so the draft cache keeps no hole) for a
         width-1 round;
      4. ``verify{w}``: one target forward over [tok_in, props[:, :w-1]]
         at positions pos_in.., its greedy choices and the position-0
         sample (a width-1 round is a plain decode step), then this
         round's state for the next advance;
      5. the host copy of choices, samples (and draft proposals) with an
         event, read as DecodeGraph's.

    Each graph reads no buffer it writes, so its eager warm-up and the
    replay that follows it in the same launch compute the same values.
    Captures are lazy (a width's graph at its first round). Replays count
    in ``stats["replays_<graph>"]``; ``captured[graph]`` holds one
    replay's launches of each kernel counter."""

    what = "speculative round"

    def __init__(
        self,
        verify: Callable[..., Tuple[torch.Tensor, torch.Tensor]],
        propose: Optional[Callable[..., torch.Tensor]],
        batch: int,
        spec_k: int,
        max_pos: int,
        device: torch.device,
        generator: torch.Generator,
        stats: Dict[str, float],
        capture: bool,
        pages: int = 0,
        adapters: bool = False,
    ):
        """verify(tokens [B, w], positions [B, w], temps, top_ps[,
        block_table][, adapter_ids=]) -> (greedy choices [B, w], samples
        of position 0 [B]); propose(tokens [B], positions [B], k[,
        block_table]) -> the draft's k greedy tokens [B, k], or None for
        prompt lookup (the proposals are then a host input); `pages` > 0:
        the paged pool's block table [batch, pages] is an input of both;
        `adapters`: the rows' adapter slots [batch], of the verify."""
        if capture and device.type != "cuda":
            raise ValueError(f"a speculative round is captured on the card, not on {device}")
        self.verify, self.propose, self.spec_k, self.max_pos = verify, propose, spec_k, max_pos
        self.device, self.generator, self.stats, self.capture = device, generator, stats, capture
        b, k = batch, spec_k

        def zeros(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.tokens, self.positions = zeros(b), zeros(b)
        self.temps, self.top_ps = zeros(b, dtype=torch.float32), torch.ones(b, device=device)
        self.fresh = torch.ones(b, dtype=torch.bool, device=device)
        self.k_eff, self.greedy = zeros(b), zeros(b, dtype=torch.bool)
        self.props_in = zeros(b, k) if propose is None else None
        self._init_optional(b, pages, adapters)
        self.tok_in, self.pos_in = zeros(b), zeros(b)
        self.draft_props = zeros(b, k) if propose is not None else None
        self.props_src = self.draft_props if propose is not None else self.props_in
        self.st_choices, self.st_sampled, self.st_props = zeros(b, k + 1), zeros(b), zeros(b, k)
        self.st_pos0, self.st_keff, self.st_greedy = zeros(b), zeros(b), zeros(b, dtype=torch.bool)
        self.arange = torch.arange(k + 1, device=device)
        inputs = _SPEC_INPUTS + (("props_in",) if propose is None else ()) + self._optional()
        self._init_staging(inputs, ("st_choices", "st_sampled", "st_props"))
        self.pool = torch.cuda.graph_pool_handle() if capture else None
        self.graphs: Dict[str, "torch.cuda.CUDAGraph"] = {}
        self.captured: Dict[str, Dict[str, int]] = {}  # per graph, launches of each counter in one replay
        self.capture_seconds = 0.0  # host clock of every warm-up and capture

    # --- the round's device work ------------------------------------------

    def _advance(self) -> None:
        k_eff, props, choices = self.st_keff, self.st_props, self.st_choices
        valid = self.arange[None, : self.spec_k] < k_eff[:, None]
        run = torch.cumprod(((props == choices[:, :-1]) & valid).to(torch.int64), dim=1)
        accepted = run.sum(dim=1)
        full = (accepted == k_eff) & (k_eff > 0)
        last_prop = props.gather(1, torch.clamp(k_eff - 1, min=0)[:, None])[:, 0]
        corr = choices.gather(1, accepted[:, None])[:, 0]
        adv = torch.where(self.st_greedy, torch.where(full, k_eff, accepted + 1), 1)
        tok = torch.where(self.st_greedy, torch.where(full, last_prop, corr), self.st_sampled)
        nxt = torch.clamp(self.st_pos0 + adv, max=self.max_pos)
        self.tok_in.copy_(torch.where(self.fresh, self.tokens, tok))
        self.pos_in.copy_(torch.where(self.fresh, self.positions, nxt))

    def _propose(self, k: int) -> None:
        with torch.inference_mode():  # serving builds no autograd graph
            props = self.propose(self.tok_in, self.pos_in, k, *self._pages())
            if k == self.spec_k:
                self.draft_props.copy_(props)

    def _verify(self, width: int) -> None:
        with torch.inference_mode():
            props = self.props_src[:, : width - 1]
            tokens = torch.cat([self.tok_in[:, None], props], dim=1)
            positions = self.pos_in[:, None] + self.arange[None, :width]
            choices, sampled = self.verify(tokens, positions, self.temps, self.top_ps, *self._pages(),
                                           **self._ids())
            self.st_choices[:, :width].copy_(choices)
            self.st_sampled.copy_(sampled)
            self.st_props[:, : width - 1].copy_(props)
            self.st_pos0.copy_(self.pos_in)
            self.st_keff.copy_(self.k_eff)
            self.st_greedy.copy_(self.greedy)

    def _run(self, key: str, body: Callable[[], None]) -> None:
        """Replay graph `key` (captured first if new), or run it eagerly."""
        if self.capture and key not in self.graphs:
            self.graphs[key], self.captured[key], seconds = capture(body, self.device, self.generator, self.stats,
                                                                    self.pool)
            self.capture_seconds += seconds
        if key in self.graphs:
            self.graphs[key].replay()
            self.stats[f"replays_{key}"] = self.stats.get(f"replays_{key}", 0) + 1
        else:
            body()

    def launch(self, tokens: np.ndarray, positions: np.ndarray, temps: np.ndarray, top_ps: np.ndarray,
               fresh: np.ndarray, k_eff: np.ndarray, greedy: np.ndarray, width: int,
               props: Optional[np.ndarray] = None, block_table: Optional[np.ndarray] = None,
               adapter_ids: Optional[np.ndarray] = None) -> Callable[[], Tuple[np.ndarray, ...]]:
        """Stage the host inputs and run one round of `width` (its lookup
        proposals `props` [B, spec_k] without a draft). Returns the read of
        this round's (choices [B, width], samples [B], draft proposals
        [B, width-1] or None)."""
        if not 1 <= width <= self.spec_k + 1:
            raise ValueError(f"verify width {width} outside 1..{self.spec_k + 1}")
        if (props is None) != (self.propose is not None):
            raise ValueError("lookup proposals are an input of exactly the draft-free round")
        given = {"block_table": block_table, "adapter_ids": adapter_ids}
        self._check_optional(given)
        turn = self._stage((tokens, positions, temps, top_ps, fresh, k_eff, greedy)
                           + (() if props is None else (props,)) + tuple(given[n] for n in self._optional()))
        self._run("advance", self._advance)
        if self.propose is not None:
            if width > 1:
                self._run("propose", functools.partial(self._propose, self.spec_k))
            else:
                self._run("propose1", functools.partial(self._propose, 1))
        self._run(f"verify{width}", functools.partial(self._verify, width))
        if self.graphs:
            self.stats["graph_replays"] += 1
        self._finish(turn)
        return functools.partial(self._read, turn, width)

    def _read(self, turn: int, width: int) -> Tuple[np.ndarray, ...]:
        host = self._wait(turn)
        props = host["st_props"][:, : width - 1] if self.propose is not None else None
        return host["st_choices"][:, :width], host["st_sampled"], props

    def replayed_launches(self, counter: str) -> int:
        """A kernel counter's launches inside this engine's replays."""
        return sum(launches.get(counter, 0) * int(self.stats.get(f"replays_{key}", 0))
                   for key, launches in self.captured.items())
