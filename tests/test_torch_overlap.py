"""The port's overlapped scheduler (substratus_tpu_torch/serve/engine.py,
EngineConfig.overlap) and the static buffers of its decode step
(serve/decode_graph.py), on the CPU.

The tiny float32 config with the JAX weights carried across by
bridge.params_from_jax. Greedy outputs of the port's overlapped engine
must be token-exact against JAX Engine(overlap=False), JAX
Engine(overlap=True) and the port's own overlap=False engine: a full
concurrent batch, slots released and re-admitted while a step is in
flight, chunked prefill admitted while a step is in flight, and requests
released at the context window. Driven step by step: the post-stop token
of an EOS-lagged slot never surfaces, a slot re-admitted between dispatch
and drain gets only its own tokens, the window check reads the positions
of the step that sampled the token (not the live array a later dispatch
has moved on), and stop() drains the step in flight. Sampled rows are
held by their masked logits (the generators differ). Each test asserts
the precondition it depends on.
"""
import queue
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substratus_tpu.models import llama as jllama
from substratus_tpu.serve.engine import Engine as JEngine
from substratus_tpu.serve.engine import EngineConfig as JEngineConfig
from substratus_tpu.serve.engine import Request as JRequest
from substratus_tpu_torch.bridge import params_from_jax
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.ops.sampling import masked_logits
from substratus_tpu_torch.serve.decode_graph import DecodeGraph
from substratus_tpu_torch.serve.engine import Engine, EngineConfig, Request


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread keeps torch's worker
    pool from spinning on cores that timing-sensitive tests share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


EOS = 257
J_CFG = jllama.CONFIGS["tiny"].replace(vocab_size=258, dtype=jnp.float32)
T_CFG = llama.CONFIGS["tiny"].replace(vocab_size=258, dtype=torch.float32)


def _prompts(seed, *lengths):
    r = np.random.default_rng(seed)
    return [[256] + r.integers(0, 256, n - 1).tolist() for n in lengths]


@pytest.fixture(scope="module")
def weights():
    j_params = jllama.init_params(J_CFG, jax.random.key(0))
    t_params = llama.Llama(T_CFG, device="cpu")
    t_params.load_state_dict(params_from_jax(jax.device_get(j_params)))
    return j_params, t_params


def _port(t_params, overlap=None, **ec):
    ec = {"max_batch": 4, "max_seq_len": 64, "eos_token_id": EOS, "kv_layout": "dense", **ec}
    return Engine(T_CFG, t_params, EngineConfig(overlap=overlap, **ec), device="cpu")


def _jax(j_params, overlap, **ec):
    ec = {"max_batch": 4, "max_seq_len": 64, "eos_token_id": EOS, **ec}
    return JEngine(J_CFG, j_params, JEngineConfig(kv_layout="dense", overlap=overlap, **ec))


def _collect(req):
    toks = []
    while (tok := req.out.get(timeout=300)) is not None:
        toks.append(tok)
    return toks, req.finish_reason


class _SubmitAtSecondToken(queue.Queue):
    """A token queue that calls `hook` once, on the scheduler thread, as
    its second token is put: under overlap that is the drain of the first
    step, with the next step already dispatched, so whatever `hook`
    submits is admitted while a step holding this request is in flight,
    whatever the host's load."""

    def __init__(self, hook):
        super().__init__()
        self.hook, self.puts = hook, 0

    def put(self, item, *args, **kw):
        super().put(item, *args, **kw)
        self.puts += 1
        if self.puts == 2 and item is not None:
            self.hook()


def _serve(engine, req_cls, prompts, max_tokens, later=()):
    """Submit `prompts` before the scheduler starts (the first admission
    boards as many as there are slots), and the `later` prompts as the
    first request's second token is put (_SubmitAtSecondToken); returns
    [(tokens, finish)] in submission order."""
    reqs = []

    def submit_later():
        reqs.extend(engine.submit(req_cls(list(p), max_tokens=n, temperature=0.0)) for p, n in later)

    reqs += [engine.submit(req_cls(list(p), max_tokens=n, temperature=0.0,
                                   **({"out": _SubmitAtSecondToken(submit_later)} if later and i == 0 else {})))
             for i, (p, n) in enumerate(zip(prompts, max_tokens))]
    n_all = len(prompts) + len(later)
    engine.start()
    try:
        outs = [_collect(reqs[0])]
        assert len(reqs) == n_all, "the later prompts were never submitted"
        return outs + [_collect(r) for r in reqs[1:]]
    finally:
        engine.stop()


def _drain_sink(req):
    out = []
    while not req.out.empty():
        out.append(req.out.get_nowait())
    return out


def _admit(engine, prompt, **kw):
    req = Request(list(prompt), temperature=0.0, **kw)
    engine.queue.put(req)
    assert engine._admit() == 1
    return req


# name: (engine config, prompts with max_tokens, prompts submitted once the first has a token)
SCENARIOS = {
    "full_batch": ({}, list(zip(_prompts(1, 5, 9, 17, 30), (12, 12, 12, 12))), []),
    "readmit": ({}, list(zip(_prompts(2, 4, 11, 6, 20, 8, 13), (3, 12, 5, 12, 8, 6))), []),
    "chunked": ({"max_prefill_len": 16}, [(_prompts(3, 5)[0], 30)], list(zip(_prompts(4, 40, 33), (8, 8)))),
    "window": ({"max_seq_len": 32}, list(zip(_prompts(5, 28, 20, 9), (12, 12, 12))), []),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_overlapped_matches_jax_and_synchronous(weights, scenario):
    j_params, t_params = weights
    ec, first, later = SCENARIOS[scenario]
    prompts, max_tokens = zip(*first)

    eng = _port(t_params, None, **ec)
    assert eng.overlap
    seen = {"batch": 0, "admitted_in_flight": 0, "readmitted_in_flight": 0, "chunked_in_flight": 0}
    finalize, chunked = eng._finalize_admit, eng._chunked_prefill

    def watch_admit(req, slot, *args):
        pending = eng._pending
        seen["admitted_in_flight"] += pending is not None
        seen["readmitted_in_flight"] += pending is not None and any(s == slot for s, _ in pending.slots)
        finalize(req, slot, *args)
        seen["batch"] = max(seen["batch"], int(eng.active.sum()))

    def watch_chunks(*args):  # a step holding a decoding request is in flight
        pending = eng._pending
        seen["chunked_in_flight"] += pending is not None and any(eng.slot_req[s] is r for s, r in pending.slots)
        return chunked(*args)

    eng._finalize_admit, eng._chunked_prefill = watch_admit, watch_chunks
    got = _serve(eng, Request, prompts, max_tokens, later)
    # Each scenario's precondition.
    if scenario == "full_batch":
        assert seen["batch"] == eng.ec.max_batch == len(prompts)
    if scenario == "readmit":
        assert seen["readmitted_in_flight"] >= 1, seen
    if scenario == "chunked":
        assert seen["chunked_in_flight"] >= 1 and eng.stats["prefill_chunks"] >= 5, (seen, eng.stats)
    if scenario == "window":
        windowed = [len(t) for (t, f), n in zip(got, max_tokens) if f == "length" and len(t) < n]
        assert windowed == [32 - 28], got
    assert all(toks for toks, _ in got)

    assert got == _serve(_port(t_params, False, **ec), Request, prompts, max_tokens, later)
    for overlap in (False, True):
        want = _serve(_jax(j_params, overlap, **ec), JRequest, prompts, max_tokens, later)
        assert got == want, f"JAX Engine(overlap={overlap})"


def test_overlap_resolution_and_step_buffers(weights):
    """overlap None (the default) and True give the overlapped scheduler,
    False the synchronous one; the CPU never captures a graph. The step's
    buffers: a fresh slot takes the host token, another the last step's
    output; a launch over an unread launch two back raises."""
    _, t_params = weights
    assert EngineConfig().overlap is None
    for overlap, want in ((None, True), (True, True), (False, False)):
        assert _port(t_params, overlap).overlap is want
    eng = Engine(T_CFG, t_params, EngineConfig(max_batch=2, max_seq_len=64), device="cpu", decode_graph=True)
    assert eng.decode_graph is False

    stats = {"graph_replays": 0, "graph_warmups": 0}
    gen = torch.Generator()
    with pytest.raises(ValueError, match="captured on the card"):
        DecodeGraph(lambda *a: a[0], 2, torch.device("cpu"), gen, stats, capture=True)
    graph = DecodeGraph(lambda tokens, *rest: (tokens + 1).to(torch.int32), 2, torch.device("cpu"), gen, stats,
                        capture=False)
    temps, top_ps, pos = np.zeros(2, np.float32), np.ones(2, np.float32), np.zeros(2, np.int64)
    read1 = graph.launch(np.array([5, 7]), pos, temps, top_ps, np.array([True, True]))
    read2 = graph.launch(np.array([10, 0]), pos, temps, top_ps, np.array([True, False]))
    with pytest.raises(RuntimeError, match="two launches back"):
        graph.launch(np.array([0, 0]), pos, temps, top_ps, np.array([True, True]))
    assert read1().tolist() == [6, 8] and read2().tolist() == [11, 9]
    read3 = graph.launch(np.array([0, 0]), pos, temps, top_ps, np.array([False, True]))
    assert read3().tolist() == [12, 1] and stats == {"graph_replays": 0, "graph_warmups": 0}


def test_eos_lag_never_emits_post_stop_token(weights):
    """A slot that hits EOS at step N's drain still rides step N+1, already
    dispatched; that step's token for it never reaches the consumer."""
    _, t_params = weights
    prompt = [256, 50, 60]
    probe_eng = _port(t_params)
    probe = _admit(probe_eng, prompt, max_tokens=8)
    for _ in range(6):
        probe_eng._step()
    probe_eng._flush()
    seen = [t for t in _drain_sink(probe) if t is not None]
    assert len(seen) == 7
    # EOS: a token the request emits after its first, never before.
    k = next((i for i in range(1, len(seen)) if seen[i] not in seen[:i]), None)
    assert k is not None, seen

    eng = _port(t_params)
    lagged = []
    release = eng._release_slot

    def watch_release(slot):
        pending = eng._pending
        lagged.append(pending is not None and any(s == slot and r is req for s, r in pending.slots))
        release(slot)

    eng._release_slot = watch_release
    req = _admit(eng, prompt, max_tokens=8, eos_token_id=seen[k])
    while eng.active.any():
        eng._step()
    eng._flush()
    assert lagged == [True]  # released while its next step was in flight
    assert _drain_sink(req) == seen[:k] + [None] and req.finish_reason == "stop"


def test_slot_readmitted_between_dispatch_and_drain(weights):
    """One slot: A finishes at step 1's drain while step 2 (still A's) is in
    flight, B is admitted into the slot, and step 2's token is dropped by
    the identity check; both get the synchronous engine's tokens."""
    _, t_params = weights
    pa, pb = _prompts(6, 7, 12)
    eng = _port(t_params, max_batch=1)
    a = _admit(eng, pa, max_tokens=2)
    eng._step()
    eng._step()  # dispatches step 2, drains step 1: A's budget is spent
    assert not eng.active[0] and eng._pending.slots == [(0, a)]
    b = _admit(eng, pb, max_tokens=3)
    assert eng.slot_req[0] is b and eng._pending.slots == [(0, a)]
    while eng.active.any():
        eng._step()
    eng._flush()
    sync = _port(t_params, False, max_batch=1)
    sync.start()
    try:
        want = [sync.generate(list(p), max_tokens=n, temperature=0.0) for p, n in ((pa, 2), (pb, 3))]
    finally:
        sync.stop()
    assert _drain_sink(a) == want[0] + [None] and _drain_sink(b) == want[1] + [None]
    assert len(want[0]) == 2 and len(want[1]) == 3


def test_window_release_reads_the_dispatch_positions(weights):
    """A request at the context window is released after the token of the
    step that reaches it, though the live positions array has already
    moved on for the step in flight: S - len(prompt) tokens, as the
    synchronous engine gives."""
    _, t_params = weights
    prompt = _prompts(7, 12)[0]
    eng = _port(t_params, max_batch=2, max_seq_len=16)
    moved_on = []
    drain = eng._drain

    def watch_drain(step):
        moved_on.append(any(eng.positions[s] != step.pos_next[s] for s, _ in step.slots))
        drain(step)

    eng._drain = watch_drain
    req = _admit(eng, prompt, max_tokens=100)
    while eng.active.any():
        eng._step()
    eng._flush()
    assert any(moved_on)  # a drain ran after a later dispatch advanced the live array
    got = _drain_sink(req)
    sync = _port(t_params, False, max_batch=2, max_seq_len=16)
    sync.start()
    try:
        want = sync.generate(list(prompt), max_tokens=100, temperature=0.0)
    finally:
        sync.stop()
    assert got == want + [None] and len(want) == 16 - 12 and req.finish_reason == "length"


def test_stop_flushes_inflight_step(weights):
    """stop() with a step in flight drains it before the scheduler exits:
    the consumer has the token of every dispatched step."""
    _, t_params = weights
    prompt = _prompts(8, 6)[0]
    eng = _port(t_params)
    ready = threading.Event()
    drain = eng._drain

    def gated(step):  # after the second drain, hold the scheduler until stop()
        drain(step)
        if eng.stats["decode_steps"] >= 3 and not ready.is_set():
            ready.set()
            eng._stop.wait(timeout=60)

    eng._drain = gated
    req = eng.submit(Request(list(prompt), max_tokens=40, temperature=0.0))
    eng.start()
    assert ready.wait(timeout=120)
    assert eng._pending is not None  # step 3 is in flight
    eng.stop()
    assert not eng._thread.is_alive()
    got = _drain_sink(req)
    assert None not in got and len(got) == eng.stats["decode_steps"] + 1 == 4
    assert eng._pending is None and eng._token_fresh.all()
    sync = _port(t_params, False)
    sync.start()
    try:
        want = sync.generate(list(prompt), max_tokens=40, temperature=0.0)
    finally:
        sync.stop()
    assert got == want[: len(got)]


def test_sampled_rows_hold_under_the_mask(weights):
    """Sampled requests on the overlapped engine: every token lies inside
    the top-k / top-p mask of the JAX model's teacher-forced logits, and
    some are not the argmax."""
    j_params, t_params = weights
    eng = _port(t_params, max_batch=2, top_k=8)
    prompts = _prompts(9, 6, 14)
    eng.start()
    try:
        reqs = [eng.submit(Request(list(p), max_tokens=12, temperature=0.9, top_p=0.9)) for p in prompts]
        outs = [_collect(r)[0] for r in reqs]
    finally:
        eng.stop()
    off_argmax = 0
    for prompt, toks in zip(prompts, outs):
        assert toks
        logits, _ = jllama.forward(j_params, jnp.asarray([prompt + toks[:-1]]), J_CFG)
        logits = torch.from_numpy(np.array(logits[0, len(prompt) - 1:]))
        n = len(toks)
        masked = masked_logits(logits, torch.full((n,), 0.9), 8, torch.full((n,), 0.9))
        assert torch.isfinite(masked[torch.arange(n), torch.tensor(toks)]).all(), (prompt, toks)
        off_argmax += sum(int(logits[i].argmax()) != t for i, t in enumerate(toks))
    assert off_argmax > 0
