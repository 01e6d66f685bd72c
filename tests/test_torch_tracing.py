"""The port's spans, traceparent propagation, event recorder and RBAC
authorizer (substratus_tpu_torch/observability/{tracing,propagation,
events,authz}.py) against the JAX package's modules of the same names.

Each scenario runs once on each package with the same inputs; clocks and
random ids are injected (each module's `time` and `uuid` replaced by the
same deterministic stand-ins), so what both return is compared exactly:
finished spans and their JSONL, parse and format over valid and malformed
traceparent values, the parent rules (an explicit parent=None is a root),
the event recorder's de-duplication, drops and kube write-through, and the
authorizer's decisions, cache and 5xx rule against one fake review client.
"""
import itertools
import json

import pytest

from substratus_tpu.kube.client import KubeError as JKubeError
from substratus_tpu.observability import authz as jauthz
from substratus_tpu.observability import events as jevents
from substratus_tpu.observability import propagation as jprop
from substratus_tpu.observability import tracing as jtracing
from substratus_tpu_torch.observability import authz, events, propagation, tracing

PACKAGES = {"jax": (jtracing, jprop, jevents, jauthz, JKubeError),
            "port": (tracing, propagation, events, authz, authz.KubeError)}


class FakeTime:
    """A clock that advances 1 ms per read, for time_ns, perf_counter, time
    and monotonic alike."""

    def __init__(self):
        self.t = 1_700_000_000.0

    def _tick(self) -> float:
        self.t += 0.001
        return self.t

    def time(self) -> float:
        return self._tick()

    def perf_counter(self) -> float:
        return self._tick()

    def monotonic(self) -> float:
        return self._tick()

    def time_ns(self) -> int:
        return int(self._tick() * 1e9)


class FakeUUID:
    """uuid4() with hex ids from a counter."""

    def __init__(self):
        self.n = itertools.count(1)

    def uuid4(self):
        class U:
            hex = f"{next(self.n):032x}"
        return U()


def deterministic(monkeypatch, *modules):
    clock, ids = FakeTime(), FakeUUID()
    for mod in modules:
        if hasattr(mod, "time"):
            monkeypatch.setattr(mod, "time", clock)
        if hasattr(mod, "uuid"):
            monkeypatch.setattr(mod, "uuid", ids)


def both(monkeypatch, fn):
    """fn(*package modules) on each package, each with fresh clocks and ids."""
    out = {}
    for name, mods in PACKAGES.items():
        with monkeypatch.context() as m:
            deterministic(m, *mods[:4])
            out[name] = fn(*mods)
    return out["jax"], out["port"]


TRACEPARENTS = [
    "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
    "00-" + "AB" * 16 + "-" + "CD" * 8 + "-00",  # upper case is folded
    "  00-" + "12" * 16 + "-" + "34" * 8 + "-01 ",  # surrounding space
    "7f-" + "12" * 16 + "-" + "34" * 8 + "-01",  # a future version
    "ff-" + "12" * 16 + "-" + "34" * 8 + "-01",  # forbidden version
    "00-" + "0" * 32 + "-" + "34" * 8 + "-01",  # all-zero trace id
    "00-" + "12" * 16 + "-" + "0" * 16 + "-01",  # all-zero span id
    "00-" + "12" * 15 + "-" + "34" * 8 + "-01",  # short trace id
    "00-" + "12" * 16 + "-" + "34" * 8,  # no flags
    "00-" + "gg" * 16 + "-" + "34" * 8 + "-01",  # not hex
    "", None, 7, "garbage",
]


def test_traceparent_parse_and_format_match_jax():
    for value in TRACEPARENTS:
        want = jprop.parse_traceparent(value)
        got = propagation.parse_traceparent(value)
        assert (None if want is None else tuple(want)) == (None if got is None else tuple(got)), value
    ctx = ("ab" * 16, "cd" * 8)
    assert propagation.format_traceparent(tracing.SpanContext(*ctx)) == jprop.format_traceparent(
        jtracing.SpanContext(*ctx)) == "00-" + ctx[0] + "-" + ctx[1] + "-01"
    assert propagation.TRACEPARENT_ENV == jprop.TRACEPARENT_ENV == "TRACEPARENT"
    assert propagation.TRACEPARENT_HEADER == jprop.TRACEPARENT_HEADER


def test_deterministic_traceparent_matches_jax():
    for parts in [("Model", "default", "llama"), ("a",), ("Server", "ns", "x", "uid-1"), ()]:
        got = propagation.deterministic_traceparent(*parts)
        assert got == jprop.deterministic_traceparent(*parts)
        assert propagation.parse_traceparent(got) is not None
    assert propagation.deterministic_traceparent("a") != propagation.deterministic_traceparent("b")


def _span_scenario(tr, prop, *_):
    t = tr.Tracer(capacity=6)
    remote = tr.SpanContext("f" * 32, "e" * 16)
    with t.span("root", a=1) as root:
        root.set_attribute("b", "two")
        with t.span("child"):
            with t.span("grandchild", n=3):
                pass
        with t.span("explicit-root", parent=None):  # an explicit None: a root, never the ambient span
            inner = t.current_context()
        with t.span("explicit-parent", parent=remote):
            pass
    with t.attach(remote):
        with t.span("attached"):
            pass
    with t.attach(None):
        with t.span("detached"):
            pass
    with pytest.raises(KeyError):
        with t.span("boom"):
            raise KeyError("x")
    return t.finished(), t.dropped, t.to_jsonl(), tuple(inner)


def test_spans_and_parent_rules_match_jax(monkeypatch):
    want, got = both(monkeypatch, _span_scenario)
    assert got == want
    spans, dropped, jsonl, _ = got
    assert dropped == 2 and len(spans) == 6  # a bounded ring: the oldest go first
    by_name = {s["name"]: s for s in spans}
    assert by_name["explicit-root"]["parent_id"] is None
    assert by_name["explicit-parent"]["parent_id"] == "e" * 16
    assert by_name["explicit-parent"]["trace_id"] == "f" * 32
    assert by_name["attached"]["trace_id"] == "f" * 32 and by_name["attached"]["parent_id"] == "e" * 16
    assert by_name["detached"]["parent_id"] is None
    assert by_name["boom"]["status"] == "error:KeyError"
    lines = [json.loads(ln) for ln in jsonl.splitlines()]
    assert [set(ln) for ln in lines] == [{"trace_id", "span_id", "parent_id", "name", "start_us", "duration_us",
                                          "attributes", "status"}] * 6


def _export_scenario(tr, prop, *_, path):
    t = tr.Tracer()
    for i in range(3):
        with t.span(f"s{i}"):
            pass
    first = t.export_jsonl(str(path))
    again = t.export_jsonl(str(path))  # drained: nothing twice
    with t.span("late"):
        pass
    third = t.export_jsonl(str(path))
    text = path.read_text()
    path.unlink()
    return first, again, third, text, t.finished()


def test_export_jsonl_appends_and_drains_as_jax(monkeypatch, tmp_path):
    path = tmp_path / "d" / "trace.jsonl"
    want, got = both(monkeypatch, lambda *m: _export_scenario(*m, path=path))
    assert got == want
    assert got[:3] == (3, 0, 1) and got[4] == []
    assert [json.loads(ln)["name"] for ln in got[3].splitlines()] == ["s0", "s1", "s2", "late"]


def _context_scenario(tr, prop, *_):
    env = {"TRACEPARENT": "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"}
    from_env = prop.context_from_env(env)
    bad_env = prop.context_from_env({"TRACEPARENT": "nope"})
    outside = (prop.inject_headers({"a": "b"}), prop.current_traceparent(), tr.current_trace_id())
    with tr.tracer.span("inside", parent=from_env):
        inside = (prop.inject_headers({"a": "b"}), prop.current_traceparent(), tr.current_trace_id())
    tr.tracer.clear()
    return tuple(from_env), bad_env, outside, inside


def test_context_from_env_and_injection_match_jax(monkeypatch):
    want, got = both(monkeypatch, _context_scenario)
    assert got == want
    assert got[2] == ({"a": "b"}, None, None)
    headers, tp, tid = got[3]
    assert tid == "ab" * 16 and headers["traceparent"] == tp and tp.startswith("00-" + "ab" * 16)


class FakeKubeEvents:
    """A client for the recorder's write-through: get_or_none, create and
    update, each call logged."""

    def __init__(self, fail: bool = False):
        self.objects, self.calls, self.fail = {}, [], fail

    def get_or_none(self, kind, ns, name):
        self.calls.append(("get", kind, ns, name))
        if self.fail:
            raise RuntimeError("apiserver down")
        obj = self.objects.get((ns, name))
        return dict(obj) if obj is not None else None

    def create(self, obj):
        self.calls.append(("create", obj["metadata"]["name"]))
        self.objects[(obj["metadata"]["namespace"], obj["metadata"]["name"])] = dict(obj)

    def update(self, obj):
        self.calls.append(("update", obj["metadata"]["name"], obj["count"]))
        self.objects[(obj["metadata"]["namespace"], obj["metadata"]["name"])] = dict(obj)


def _events_scenario(tr, prop, ev, *_):
    rec = ev.EventRecorder(capacity=3)
    kube = FakeKubeEvents()
    rec.attach_kube(kube)
    out = [rec.emit("Started", kind="Server", name="a", message="m")]
    out.append(rec.emit("Started", kind="Server", name="a", message="m"))  # deduplicated: count 2
    with tr.tracer.span("traced", parent=tr.SpanContext("ab" * 16, "cd" * 8)):
        out.append(rec.emit("Started", kind="Server", name="a", message="m"))  # the trace id refreshed
        out.append(rec.emit("Failed", kind="Model", name="b", type="Warning"))
    for i in range(3):
        out.append(rec.emit("Tick", name=f"t{i}"))  # evicts the oldest two
    recent, dropped = rec.recent(), rec.dropped
    limited = rec.recent(2)
    rec.attach_kube(FakeKubeEvents(fail=True))
    out.append(rec.emit("Tick", name="t0"))  # a failed write-through never fails the emit
    rec.clear()
    tr.tracer.clear()
    return out, recent, dropped, limited, kube.calls, sorted(kube.objects), rec.recent(), rec.dropped


def test_event_recorder_dedup_drops_and_write_through_match_jax(monkeypatch):
    want, got = both(monkeypatch, _events_scenario)
    assert got == want
    out, recent, dropped, limited, calls, objects, cleared, dropped_after = got
    assert [e["count"] for e in out[:3]] == [1, 2, 3] and out[2]["trace_id"] == "ab" * 16
    assert out[0]["trace_id"] is None and dropped == 2 and len(recent) == 3 and len(limited) == 2
    assert [e["reason"] for e in recent] == ["Tick"] * 3 and cleared == [] and dropped_after == 0
    assert [c[0] for c in calls if c[0] != "get"] == ["create", "update", "update", "create", "create", "create",
                                                      "create"]
    assert events.EVENTS is not None and events.EVENT_SOURCE == jevents.EVENT_SOURCE


class FakeReviews:
    """One review client for both packages: TokenReview by a token table,
    SubjectAccessReview by a reader set; `down` makes every call raise the
    package's KubeError. Calls are counted."""

    def __init__(self, error_cls):
        self.error_cls = error_cls
        self.tokens = {"good": {"username": "prom", "groups": ["sa"]}, "lowly": {"username": "nobody"}}
        self.readers = {"prom"}
        self.down = False
        self.calls = 0

    def create(self, manifest):
        self.calls += 1
        if self.down:
            raise self.error_cls("connection refused")
        if manifest["kind"] == "TokenReview":
            user = self.tokens.get(manifest["spec"]["token"])
            return {"status": {"authenticated": user is not None, "user": user or {}}}
        return {"status": {"allowed": manifest["spec"]["user"] in self.readers}}


def _authz_scenario(tr, prop, ev, az, error_cls):
    kube = FakeReviews(error_cls)
    a = az.MetricsAuthorizer(kube, ttl_s=0.02)
    out = [a.allow(h) for h in (None, "Basic abc", "Bearer ", "Bearer unknown", "Bearer lowly", "Bearer good")]
    calls = kube.calls
    kube.readers.clear()
    out.append(a.allow("Bearer good"))  # cached: no call, the old verdict
    out.append(kube.calls - calls)
    kube.down = True
    out.append(a.allow("Bearer fresh"))  # a 5xx ...
    kube.down = False
    kube.tokens["fresh"] = {"username": "prom"}
    kube.readers.add("prom")
    out.append(a.allow("Bearer fresh"))  # ... is never cached
    for _ in range(30):  # past the TTL (1 ms a clock read)
        a.allow("Bearer other")
    kube.readers.clear()
    out.append(a.allow("Bearer good"))  # expired: reviewed again
    return out


def test_authorizer_decisions_cache_and_5xx_match_jax(monkeypatch):
    want, got = both(monkeypatch, _authz_scenario)
    assert got == want
    assert [s for s, _ in got[:6]] == [401, 401, 401, 401, 403, 200]
    assert got[6] == (200, "ok") and got[7] == 0
    assert got[8][0] == 500 and got[9] == (200, "ok") and got[10][0] == 403


def test_authorizer_cache_is_bounded():
    for az, error_cls in ((jauthz, JKubeError), (authz, authz.KubeError)):
        a = az.MetricsAuthorizer(FakeReviews(error_cls))
        for i in range(1030):
            assert a.allow(f"Bearer t{i}")[0] == 401
        assert len(a._cache) == 1024 and "t0" not in a._cache and "t1029" in a._cache
    assert authz.CACHE_TTL_S == jauthz.CACHE_TTL_S


def test_batchgen_run_span_joins_traceparent(tmp_path, monkeypatch):
    """serve.batchgen runs its manifest in a batchgen.run span under the
    TRACEPARENT variable, as the JAX entry point does, with the manifest
    and its record count."""
    from substratus_tpu_torch.serve import batchgen

    man = tmp_path / "m.jsonl"
    man.write_text("".join(json.dumps({"tokens": [256, 1 + i, 2], "max_tokens": 2}) + "\n" for i in range(3)))
    monkeypatch.setenv("TRACEPARENT", f"00-{'ab' * 16}-{'cd' * 8}-01")
    tracing.tracer.clear()
    assert batchgen.main(["--config", "tiny", "--params", "", "--device", "cpu", "--manifest", str(man), "--output",
                          str(tmp_path / "out")]) == 0
    spans = tracing.tracer.finished()
    run = [s for s in spans if s["name"] == "batchgen.run"]
    assert len(run) == 1 and run[0]["trace_id"] == "ab" * 16 and run[0]["parent_id"] == "cd" * 8
    assert run[0]["attributes"] == {"manifest": str(man), "records": 3}
    tracing.tracer.clear()
