"""The port's request journeys and step timeline
(substratus_tpu_torch/observability/{journey,timeline}.py) against the JAX
package's modules of the same names.

Each scenario runs once on each package with the same calls; the clocks
and ids are injected (each module's `time` and `uuid` replaced by the same
deterministic stand-ins), so what both return is compared exactly: the
cases of tests/test_journey.py (the bounded ring and its marks, record_once
and breaches, the wire form, stitch, the waterfall and the Chrome trace,
malformed segments, the JourneyLog and the SlowRing), and one sequence of
StepTimeline.record_iteration calls (the records, the bubble totals, the
bubble counter's increments, the floor estimate, the Chrome trace).
"""
import pytest

from substratus_tpu.observability import journey as jjourney
from substratus_tpu.observability import metrics as jmetrics
from substratus_tpu.observability import timeline as jtimeline
from substratus_tpu_torch.observability import journey, metrics, timeline
from test_torch_tracing import deterministic

PACKAGES = {"jax": (jjourney, jtimeline, jmetrics), "port": (journey, timeline, metrics)}


def both(monkeypatch, fn):
    out = {}
    for name, mods in PACKAGES.items():
        with monkeypatch.context() as m:
            deterministic(m, *mods[:2])
            out[name] = fn(*mods)
    return out["jax"], out["port"]


def types_of(snapshot):
    return [ev[1] for ev in snapshot["events"]]


def _ring(jm, *_):
    j = jm.RequestJourney(rid="r1", origin="test", cap=8)
    j.record("submit", queue=0)
    j.record("admit", slot=1)
    for i in range(100):
        j.record("emit", t=i)
    j.record("end", reason="stop")
    return j.snapshot(), j.ended, jm.RequestJourney(cap=0).cap


def test_ring_bounded_and_marks_survive_eviction(monkeypatch):
    want, got = both(monkeypatch, _ring)
    assert got == want
    snap, ended, floor = got
    assert len(snap["events"]) == 8 and snap["total"] == 103 and snap["dropped"] == 95
    assert set(snap["marks"]) == {"submit", "admit", "emit", "end"} and snap["marks"]["emit"][2] == {"t": 0}
    assert ended and floor == 8
    assert [ev[0] for ev in snap["events"]] == sorted(ev[0] for ev in snap["events"])


def _once_and_breach(jm, *_):
    j = jm.RequestJourney(trace_id="ab" * 16, rid="r")
    j.record_once("pool_wait")
    j.record_once("pool_wait")
    j.record_once("adapter_wait")
    j.breach("ttft", 3.5, 2.0)
    j.breach("inter_token", 0.1234567891, 0.05)
    return j.snapshot(), j.ended


def test_record_once_and_breach_bookkeeping(monkeypatch):
    want, got = both(monkeypatch, _once_and_breach)
    assert got == want
    snap, ended = got
    assert types_of(snap) == ["pool_wait", "adapter_wait", "slo_breach", "slo_breach"] and not ended
    assert snap["breaches"] == [{"slo": "ttft", "seconds": 3.5, "threshold_s": 2.0},
                                {"slo": "inter_token", "seconds": 0.123457, "threshold_s": 0.05}]


def test_event_types_are_jax_catalog():
    assert journey.EVENT_TYPES == jjourney.EVENT_TYPES
    assert len(set(journey.EVENT_TYPES)) == len(journey.EVENT_TYPES)


def _stitch(jm, *_):
    pre = jm.RequestJourney(rid="req-1", origin="prefill")
    pre.record("submit")
    pre.record("admit")
    pre.record("ship", pages=2)
    dec = jm.RequestJourney(trace_id=pre.trace_id, rid="req-1", origin="decode")
    dec.record("kv_recv", bytes=1024)
    dec.record("install", slot=0)
    dec.record("emit", t=7)
    dec.breach("inter_token", 0.5, 0.25)
    dec.record("end", reason="stop")
    wire = dec.to_wire()
    ok = pre.stitch(wire)
    again = pre.stitch(jm.RequestJourney.from_wire(wire))  # an already parsed snapshot stitches too
    pre.record("end", reason="stop")
    snap = pre.snapshot()
    return wire, ok, again, snap, jm.waterfall(snap), jm.chrome_trace(snap)


def test_wire_roundtrip_stitch_waterfall_and_chrome_trace(monkeypatch):
    want, got = both(monkeypatch, _stitch)
    assert got == want
    wire, ok, again, snap, rows, doc = got
    assert ok and again and len(snap["segments"]) == 2 and snap["segments"][0]["origin"] == "decode"
    assert snap["breaches"][0]["slo"] == "inter_token"
    assert [r["ts_us"] for r in rows] == sorted(r["ts_us"] for r in rows)
    assert {r["origin"] for r in rows} == {"prefill", "decode"}
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"ship", "install", "handoff", "decode", "queue", "prefill"} <= names
    assert doc["otherData"]["trace_id"] == snap["trace_id"]


def test_malformed_wire_segments_rejected():
    for bad in (None, b"garbage", [], {"ev": []}, {"tid": 7, "ev": []}, {"tid": "x", "ev": "nope"}, "s"):
        for jm in (jjourney, journey):
            assert jm.RequestJourney.from_wire(bad) is None
            j = jm.RequestJourney()
            assert j.stitch(bad) is False and j.snapshot()["segments"] == []
    seg = {"tid": "t", "ev": [[1, "emit", None], "junk"], "mk": "junk", "o": 5}
    assert journey.RequestJourney.from_wire(seg) == jjourney.RequestJourney.from_wire(seg)


def _wire_limit(jm, *_):
    j = jm.RequestJourney(cap=512)
    j.record("submit")
    for i in range(300):
        j.record("emit", t=i)
    return j.to_wire(limit=16)


def test_wire_limit_truncates_but_keeps_marks(monkeypatch):
    want, got = both(monkeypatch, _wire_limit)
    assert got == want
    assert len(got["ev"]) == 16 and got["n"] == 301 and "submit" in got["mk"]


def _rings(jm, *_):
    log = jm.JourneyLog(cap=4)
    snaps = []
    for i in range(6):
        j = jm.RequestJourney(rid=f"req-{i}")
        j.record("end", reason="stop")
        snaps.append(j.snapshot())
        log.add(snaps[-1])
    live = jm.RequestJourney(rid="live")
    log.add(live)
    live.record("arrive")  # a live object is snapshotted at read time
    found = (log.find("req-0"), log.find("req-5"), log.find(snaps[4]["trace_id"]), log.find(""), log.find("live"))
    ring = jm.SlowRing(cap=2)
    for i in range(5):
        j = jm.RequestJourney(rid=f"slow-{i}")
        j.breach("ttft", 9.0, 2.0)
        ring.add(j.snapshot())
    return log.ids(), found, log.live(live.trace_id) is live, log.snapshot(2), ring.total, ring.snapshot()


def test_journey_log_and_slow_ring(monkeypatch):
    want, got = both(monkeypatch, _rings)
    assert got[:2] == want[:2] and got[3:] == want[3:] and got[2] and want[2]
    ids, found, _, last_two, total, slow = got
    assert len(ids) == 4 and found[0] is None and found[1]["rid"] == "req-5" and found[2]["rid"] == "req-4"
    assert found[3] is None and types_of(found[4]) == ["arrive"] and len(last_two) == 2
    assert total == 5 and [e["rid"] for e in slow] == ["slow-3", "slow-4"]
    assert set(slow[0]) == {"trace_id", "rid", "breaches", "journey"}


# One scheduler's iterations: steady steps, a flush, admissions (one held
# for pages), an idle-cause iteration, a faster step that lowers the floor.
ITERATIONS = [
    dict(wall_s=0.010, dispatch_s=0.001, drain_s=0.002, drain_off_s=0.0005, active_slots=4),
    dict(wall_s=0.012, dispatch_s=0.001, drain_s=0.003, drain_off_s=0.0004, active_slots=4),
    dict(wall_s=0.030, dispatch_s=0.001, drain_s=0.002, flush_s=0.015, flush_reasons=("preempt",), active_slots=3),
    dict(wall_s=0.050, admit_s=0.035, admitted=2, dispatch_s=0.001, drain_s=0.002, active_slots=4),
    dict(wall_s=0.020, admit_s=0.008, pool_dry=True, dispatch_s=0.001, active_slots=4),
    dict(wall_s=0.015, admit_s=0.004, admitted=0, active_slots=2),
    dict(wall_s=0.008, dispatch_s=0.001, drain_s=0.001, active_slots=1),
    dict(wall_s=0.011, dispatch_s=0.001, drain_s=0.002, flush_s=0.002, flush_reasons=("swap", "graph"),
         active_slots=4),
]


def _timeline(jm, tm, mm, floor_s=0.0):
    tl = tm.StepTimeline(capacity=6, floor_window=4)
    name = "substratus_serve_pipeline_bubble_seconds"
    before = {c: mm.METRICS.get(name, {"cause": c}) or 0.0 for c in tm.BUBBLE_CAUSES}
    recs = [tl.record_iteration(t_start=tl._epoch_perf + 0.1 * i, max_slots=4, configured_floor_s=floor_s, **it)
            for i, it in enumerate(ITERATIONS)]
    after = {c: (mm.METRICS.get(name, {"cause": c}) or 0.0) - before[c] for c in tm.BUBBLE_CAUSES}
    return recs, tl.records(), tl.bubble_totals(), tl.floor_estimate(), tl.chrome_trace(), after


def test_step_timeline_matches_jax(monkeypatch):
    for floor_s in (0.0, 0.009):
        want, got = both(monkeypatch, lambda *m: _timeline(*m, floor_s=floor_s))
        recs, ring, totals, floor, doc, counted = got
        assert recs == want[0] and ring == want[1] and totals == want[2] and floor == want[3] and doc == want[4]
        assert counted == pytest.approx(want[5], abs=1e-12)
        assert len(ring) == 6 and totals["iterations"] == 8 and floor == 0.008
        assert recs[2]["bubble"].get("flush", 0) > 0 and recs[4]["pool_dry"] and "pool_dry" in recs[4]["bubble"]
        assert "admission_stall" in recs[3]["bubble"] and "admission_stall" not in recs[5]["bubble"]
        assert counted == pytest.approx(totals["by_cause"], abs=1e-5)
    assert timeline.BUBBLE_CAUSES == jtimeline.BUBBLE_CAUSES


def test_step_timeline_rejects_bad_shapes():
    for tm in (jtimeline, timeline):
        for kw in ({"capacity": 0}, {"floor_window": 0}):
            with pytest.raises(ValueError, match="invalid timeline shape"):
                tm.StepTimeline(**kw)
        tl = tm.StepTimeline()
        assert tl.floor_estimate() is None and tl.bubble_totals()["attributed_frac"] == 1.0
