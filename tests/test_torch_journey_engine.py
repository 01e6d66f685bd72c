"""The port's Engine records request journeys and the step timeline as the
JAX Engine does: the same requests (token ids from a seed, every one
submitted before start, so the schedule is fixed) through both packages'
engines on the same tiny float32 weights (bridge.params_from_jax).

The synchronous engine gives each request the JAX engine's sequence of
journey event types exactly (submit, admit, prefix hits, prefills, each
drain and emit, speculative rounds, preemptions, the pool's and the
adapter store's waits, the end), with the same finish reasons and tokens,
on the dense and the paged layout, chunked, preempted on a small pool,
speculating by prompt lookup, waiting for an adapter slot and cancelled.
The overlapped engine gives the same lifecycle markers in the same order.
With the SLO thresholds at 0 both slow rings hold the same journeys and
breaches; the synchronous run's timeline counts the same iterations and
flushes. The engine's prefill span joins the submitter's trace across
the scheduler thread.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substratus_tpu.models import llama as jllama
from substratus_tpu.observability.tracing import tracer as jtracer
from substratus_tpu.serve import adapters as jadapters
from substratus_tpu.serve.engine import Engine as JEngine
from substratus_tpu.serve.engine import EngineConfig as JEngineConfig
from substratus_tpu.serve.engine import Request as JRequest
from substratus_tpu_torch.bridge import params_from_jax
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.observability.journey import EVENT_TYPES
from substratus_tpu_torch.observability.metrics import METRICS
from substratus_tpu_torch.observability.tracing import tracer
from substratus_tpu_torch.serve import adapters
from substratus_tpu_torch.serve.engine import Engine, EngineConfig, Request

J_CFG = jllama.CONFIGS["tiny"].replace(vocab_size=258, dtype=jnp.float32)
T_CFG = llama.CONFIGS["tiny"].replace(vocab_size=258, dtype=torch.float32)
EOS = 257
NO_SLO = {"slo_ttft_s": 1e9, "slo_inter_token_s": 1e9}  # no breach from a slow CPU run
_r = np.random.default_rng(11)
PROMPTS = [[256] + _r.integers(0, 256, n - 1).tolist() for n in (5, 23, 40, 9, 31, 17)]
# Markers the overlapped schedulers record in the same order (their drains,
# emits and flushes interleave by the pipeline's timing).
MARKERS = ("submit", "admit", "prefix_hit", "prefill", "preempt", "pool_wait", "adapter_wait", "end")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    j_params = jllama.init_params(J_CFG, jax.random.key(0))
    t_params = llama.Llama(T_CFG, device="cpu")
    t_params.load_state_dict(params_from_jax(jax.device_get(j_params)))
    return j_params, t_params


def engines(weights, j_adapters=None, t_adapters=None, **ec):
    """A JAX engine and the port's on the same weights and knobs."""
    j_params, t_params = weights
    ec = {"max_batch": 4, "max_seq_len": 64, "max_prefill_len": 16, "eos_token_id": EOS, **NO_SLO, **ec}
    return (JEngine(J_CFG, j_params, JEngineConfig(**ec), adapters=j_adapters),
            Engine(T_CFG, t_params, EngineConfig(**ec), device="cpu", adapters=t_adapters))


def run(engine, req_cls, prompts=PROMPTS, max_tokens=8, tenants=None, cancel=()):
    """Submit every request before start (a fixed schedule), the ones in
    `cancel` already cancelled; each request's (event types, finish reason,
    tokens), the engine stopped."""
    tenants = tenants or [None] * len(prompts)
    reqs = [engine.submit(req_cls(list(p), max_tokens=max_tokens, temperature=0.0, adapter=a, id=f"r{i}"))
            for i, (p, a) in enumerate(zip(prompts, tenants))]
    for i in cancel:
        reqs[i].cancelled = True
    engine.start()
    try:
        out = []
        for req in reqs:
            toks = []
            while (tok := req.out.get(timeout=300)) is not None:
                toks.append(tok)
            out.append(([ev[1] for ev in req.journey.snapshot()["events"]], req.finish_reason, toks))
        return out
    finally:
        engine.stop()


def check_journeys(got, want):
    assert got == want
    for types, _, toks in got:
        assert set(types) <= set(EVENT_TYPES)
        assert types[0] == "submit" and types[-1] == "end" and types.count("end") == 1
        assert types.count("emit") == len(toks)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_synchronous_journeys_match_jax(weights, layout):
    """Chunked prompts (16-token chunks) and short ones, on either layout:
    the JAX engine's event types request for request."""
    jeng, teng = engines(weights, overlap=False, kv_layout=layout)
    want = run(jeng, JRequest)
    got = run(teng, Request)
    check_journeys(got, want)
    assert all(t.count("prefill") == 1 for t, _, _ in got)
    assert sum(t.count("drain") for t, _, _ in got) > 0


def test_prefix_hits_and_preemption_match_jax(weights):
    """Paged, a 64-token pool: prompts sharing a 32-token prefix take its
    pages (prefix_hit), and a full pool preempts the youngest slot, which
    boards again (preempt, admits again, waits for pages: pool_wait)."""
    shared = PROMPTS[2][:33]
    prompts = [shared + [5, 6, 7], shared + [8, 9], PROMPTS[0], PROMPTS[3]]
    jeng, teng = engines(weights, overlap=False, kv_layout="paged", kv_pool_tokens=64)
    want = run(jeng, JRequest, prompts, max_tokens=20)
    got = run(teng, Request, prompts, max_tokens=20)
    check_journeys(got, want)
    assert any("prefix_hit" in t for t, _, _ in got)
    assert any("preempt" in t and t.count("admit") >= 2 for t, _, _ in got)
    assert any("pool_wait" in t for t, _, _ in got)  # a held admission waits for pages
    assert teng.stats["preemptions"] > 0


def test_lookup_speculation_journeys_match_jax(weights):
    """Prompt lookup (spec_k 3) on repetitive prompts: spec_round events
    where a slot proposed, at the JAX engine's places."""
    prompts = [[256] + [3, 4, 5, 6] * 6, [256] + [9, 8, 7] * 5, PROMPTS[1]]
    jeng, teng = engines(weights, overlap=False, spec_k=3)
    want = run(jeng, JRequest, prompts, max_tokens=12)
    got = run(teng, Request, prompts, max_tokens=12)
    check_journeys(got, want)
    assert sum(t.count("spec_round") for t, _, _ in got) > 0


def test_adapter_wait_journeys_match_jax(weights, tmp_path):
    """A store of capacity 1 and two tenants submitted together: the second
    tenant's requests wait for the pinned slot (adapter_wait, once each)."""
    r = np.random.default_rng(3)
    shapes = adapters._target_shapes(T_CFG, ("wq", "wv"))
    for aid in ("a", "b"):
        lora = {n: {"a": r.standard_normal((T_CFG.n_layers, i, 2)).astype(np.float32) / 2,
                    "b": (r.standard_normal((T_CFG.n_layers, 2) + o) * 0.2).astype(np.float32)}
                for n, (i, o) in shapes.items()}
        jadapters.save_adapter_artifact(str(tmp_path / aid), lora, alpha=2.0, rank=2)
    j_store = jadapters.AdapterStore(J_CFG, capacity=1, rank=2, targets=("wq", "wv"), dtype=jnp.float32,
                                     search_dir=str(tmp_path))
    t_store = adapters.AdapterStore(T_CFG, capacity=1, rank=2, targets=("wq", "wv"), device="cpu",
                                    search_dir=str(tmp_path))
    jeng, teng = engines(weights, j_store, t_store, overlap=False, kv_layout="dense")
    tenants = ["a", "b", "a", "b"]
    want = run(jeng, JRequest, PROMPTS[:4], max_tokens=4, tenants=tenants)
    got = run(teng, Request, PROMPTS[:4], max_tokens=4, tenants=tenants)
    check_journeys(got, want)
    assert any(t.count("adapter_wait") == 1 for t, _, _ in got)


def test_cancel_journey_matches_jax(weights):
    """A request cancelled before it boards ends at its first emit with
    reason "cancel"; the others run on."""
    jeng, teng = engines(weights, overlap=False)
    want = run(jeng, JRequest, PROMPTS[:3], cancel=(1,))
    got = run(teng, Request, PROMPTS[:3], cancel=(1,))
    check_journeys(got, want)
    assert got[1][0][-1] == "end" and got[1][1] == "stop" and "emit" not in got[1][0]
    assert teng.journey_log.find("r1")["marks"]["end"][2]["reason"] == "cancel"


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_overlapped_lifecycle_markers_match_jax(weights, layout):
    """The overlapped scheduler on either layout: the same markers in the
    same order, the same tokens and finish reasons; every emit after the
    first has a drain before it."""
    jeng, teng = engines(weights, overlap=True, kv_layout=layout)
    want = run(jeng, JRequest)
    got = run(teng, Request)
    for (gt, gf, gk), (wt, wf, wk) in zip(got, want):
        assert [t for t in gt if t in MARKERS] == [t for t in wt if t in MARKERS]
        assert (gf, gk) == (wf, wk)
        for types in (gt, wt):
            emits = [i for i, t in enumerate(types) if t == "emit"]
            assert all("drain" in types[a:b] for a, b in zip(emits, emits[1:]))


def test_slow_ring_and_finish_reasons_with_slo_at_zero(weights):
    """SLO thresholds 0: every TTFT and gap breaches, so each finished
    journey lands in the slow ring with its breaches, as in JAX; the
    exemplar counter and the histograms' exemplars carry the trace ids."""
    jeng, teng = engines(weights, overlap=False, slo_ttft_s=0.0, slo_inter_token_s=0.0)
    before = METRICS.get("substratus_serve_slo_exemplars_total", {"slo": "ttft"}) or 0
    want = run(jeng, JRequest, PROMPTS[:4])
    got = run(teng, Request, PROMPTS[:4])
    check_journeys(got, want)
    j_slow, t_slow = jeng.slow.snapshot(), teng.slow.snapshot()
    assert [(e["rid"], [b["slo"] for b in e["breaches"]]) for e in t_slow] == \
        [(e["rid"], [b["slo"] for b in e["breaches"]]) for e in j_slow]
    assert teng.slow.total == jeng.slow.total == 4
    assert all(e["journey"]["marks"]["end"] for e in t_slow)
    assert (METRICS.get("substratus_serve_slo_exemplars_total", {"slo": "ttft"}) or 0) - before == 4
    ids = {e["trace_id"] for e in t_slow}
    assert {ex["trace_id"] for ex in METRICS.exemplars("substratus_serve_ttft_seconds").values()} <= ids
    assert [s["rid"] for s in teng.journey_log.ids()] == [s["rid"] for s in jeng.journey_log.ids()]


def test_timeline_of_a_synchronous_run_matches_jax(weights):
    """The synchronous run's timeline: as many iteration records as the JAX
    engine's (the first decode iteration, the compile or graph capture,
    left out), no flush, every record's keys; the bubble counter by cause."""
    jeng, teng = engines(weights, overlap=False, kv_layout="paged", kv_pool_tokens=64)
    prompts = [PROMPTS[2][:20], PROMPTS[4][:20], PROMPTS[0], PROMPTS[3]]
    run(jeng, JRequest, prompts, max_tokens=20)
    run(teng, Request, prompts, max_tokens=20)
    j_recs, t_recs = jeng.timeline.records(), teng.timeline.records()
    assert len(t_recs) == len(j_recs) > 0
    assert [r["flush_reasons"] for r in t_recs] == [r["flush_reasons"] for r in j_recs]
    assert [r["admitted"] for r in t_recs] == [r["admitted"] for r in j_recs]
    assert [r["active_slots"] for r in t_recs] == [r["active_slots"] for r in j_recs]
    assert [r["pool_dry"] for r in t_recs] == [r["pool_dry"] for r in j_recs]
    assert set(t_recs[0]) == set(j_recs[0])
    tot = teng.timeline.bubble_totals()
    assert tot["iterations"] == jeng.timeline.bubble_totals()["iterations"] == len(t_recs)
    assert set(tot) == set(jeng.timeline.bubble_totals())


def test_flush_journeys_and_timeline_overlapped(weights):
    """Overlapped on a 64-token pool: a preemption flushes the step in
    flight, which the requests riding it record ("flush", reason preempt)
    and the timeline bills to its flush cause, in both packages."""
    jeng, teng = engines(weights, overlap=True, kv_layout="paged", kv_pool_tokens=64)
    prompts = [PROMPTS[2][:20], PROMPTS[4][:20], PROMPTS[0], PROMPTS[3]]
    want = run(jeng, JRequest, prompts, max_tokens=20)
    got = run(teng, Request, prompts, max_tokens=20)
    for res, eng in ((got, teng), (want, jeng)):
        assert any("flush" in t for t, _, _ in res)
        reasons = [x for r in eng.timeline.records() for x in r["flush_reasons"]]
        assert "preempt" in reasons
    assert [(f, k) for _, f, k in got] == [(f, k) for _, f, k in want]


def test_prefill_span_joins_the_submitters_trace(weights):
    """A request submitted inside a span: the engine's prefill span on the
    scheduler thread is its child, the journey carries its trace id, and a
    request submitted outside any span gets a root prefill span; the first
    decode iteration is an engine.first_compile span, in both packages."""
    out = {}
    jeng, teng = engines(weights)
    for name, eng, req_cls, tr in (("jax", jeng, JRequest, jtracer), ("port", teng, Request, tracer)):
        tr.clear()
        with tr.span("client") as client:
            inside = eng.submit(req_cls(PROMPTS[0], max_tokens=3, temperature=0.0, id="in"))
        outside = eng.submit(req_cls(PROMPTS[1], max_tokens=3, temperature=0.0, id="out"))
        eng.start()
        try:
            for req in (inside, outside):
                while req.out.get(timeout=300) is not None:
                    pass
        finally:
            eng.stop()
        spans = tr.finished()
        prefill = {s["attributes"]["request_id"]: s for s in spans if s["name"] == "engine.prefill"}
        assert prefill["in"]["trace_id"] == client.trace_id == inside.journey.trace_id
        assert prefill["in"]["parent_id"] == client.span_id
        assert prefill["out"]["parent_id"] is None and outside.trace_ctx is None
        out[name] = (sorted(s["name"] for s in spans), sorted(prefill["in"]["attributes"]))
        tr.clear()
    assert out["port"] == out["jax"]
    assert "engine.first_compile" in out["port"][0]
