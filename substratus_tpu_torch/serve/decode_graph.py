"""The device half of one decode step over static buffers, captured on the
card as one CUDA graph (the counterpart of the JAX engine's jitted
``_build_decode``, substratus_tpu/serve/engine.py).

A DecodeGraph owns the step's inputs on the device (``tokens``,
``positions``, ``temps``, ``top_ps`` and the ``fresh`` mask; for an engine
on the paged pool also its ``block_table`` [B, max_pages]) and its output
(``out``, the sampled tokens). The step itself, ``step(tokens, positions,
temps, top_ps[, block_table]) -> sampled``, is the engine's decode_step +
sample over its cache and params. The block table is an input like the
others, so a replay reads the pages the engine has grown since the
capture. Each launch:

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
from substratus_tpu_torch.ops.fused_decode import fused_decode_attention
from substratus_tpu_torch.ops.quant4 import check_weight, q4_matmul

# The kernel wrappers a decode step can call, each with host-side counters.
COUNTED = (decode_attention, fused_decode_attention, q4_matmul, check_weight)

_INPUTS = ("tokens", "positions", "temps", "top_ps", "fresh")
_PAGED_INPUTS = _INPUTS + ("block_table",)


def _counters() -> Iterator[Tuple[str, object, str]]:
    for fn in COUNTED:
        for attr, value in vars(fn).items():
            if isinstance(value, int) and (attr.startswith("launches") or attr == "calls"):
                yield f"{fn.__name__}.{attr}", fn, attr


class DecodeGraph:
    """One decode step's static buffers and the step over them: captured
    and replayed on the card, run eagerly otherwise (module docstring)."""

    def __init__(
        self,
        step: Callable[..., torch.Tensor],
        batch: int,
        device: torch.device,
        generator: torch.Generator,
        stats: Dict[str, float],
        capture: bool,
        pages: int = 0,
    ):
        """`pages` > 0: the step also takes a block table [batch, pages]."""
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
        self.block_table = torch.zeros(batch, pages, dtype=torch.int64, device=device) if pages else None
        self.inputs = _PAGED_INPUTS if pages else _INPUTS
        cuda = device.type == "cuda"
        self._staging = [{name: torch.empty(getattr(self, name).shape, dtype=getattr(self, name).dtype,
                                            pin_memory=cuda)
                          for name in self.inputs} for _ in range(2)]
        self._host_out = [torch.empty(batch, dtype=torch.int32, pin_memory=cuda) for _ in range(2)]
        self._done = [torch.cuda.Event() if cuda else None for _ in range(2)]
        self._unread = [False, False]
        self._turn = 0
        self.graph = None
        self.captured: Dict[str, int] = {}  # launches of each counter in one replay
        self.capture_seconds = 0.0  # host clock of the warm-up and the capture

    def _body(self) -> None:
        with torch.inference_mode():  # serving builds no autograd graph
            tokens = torch.where(self.fresh, self.tokens, self.out.to(torch.int64))
            pages = () if self.block_table is None else (self.block_table,)
            self.out.copy_(self.step(tokens, self.positions, self.temps, self.top_ps, *pages))

    def _capture(self) -> None:
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self._body()
        current.wait_stream(side)
        self.stats["graph_warmups"] += 1
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        before = {key: getattr(fn, attr) for key, fn, attr in _counters()}
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self._body()
        for key, fn, attr in _counters():
            if getattr(fn, attr) != before[key]:
                self.captured[key] = getattr(fn, attr) - before[key]
                setattr(fn, attr, before[key])
        self.graph = graph
        self.capture_seconds = time.perf_counter() - t0

    def launch(self, tokens: np.ndarray, positions: np.ndarray, temps: np.ndarray, top_ps: np.ndarray,
               fresh: np.ndarray, block_table: Optional[np.ndarray] = None) -> Callable[[], np.ndarray]:
        """Stage the host inputs, run the step (replay, capture first, or
        eager) and queue its tokens' copy to the host. Returns the read of
        this launch's tokens."""
        if (block_table is None) != (self.block_table is None):
            raise ValueError("a block table is an input of exactly the paged engine's step")
        turn = self._turn
        if self._unread[turn]:
            raise RuntimeError("decode step launched before the step two launches back was read")
        self._turn ^= 1
        staging = self._staging[turn]
        for name, value in zip(self.inputs, (tokens, positions, temps, top_ps, fresh, block_table)):
            staging[name].numpy()[:] = value
            getattr(self, name).copy_(staging[name], non_blocking=True)
        if self.capture and self.graph is None:
            self._capture()
        if self.graph is not None:
            self.graph.replay()
            self.stats["graph_replays"] += 1
        else:
            self._body()
        self._host_out[turn].copy_(self.out, non_blocking=True)
        if self._done[turn] is not None:
            self._done[turn].record(torch.cuda.current_stream(self.device))
        self._unread[turn] = True
        return functools.partial(self._read, turn)

    def _read(self, turn: int) -> np.ndarray:
        if self._done[turn] is not None:
            self._done[turn].synchronize()
        self._unread[turn] = False
        return self._host_out[turn].numpy().copy()
