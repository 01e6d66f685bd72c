"""The port's telemetry (substratus_tpu_torch/observability/) against the
JAX package's, on the CPU.

* The registry: given the same calls (the cases of
  tests/test_observability.py's registry tests), the port's Metrics
  renders the JAX text byte for byte, and both lint it alike.
* SLOTracker: the same observations give equal snapshots (the /loadz
  `slo` field) and quantiles.
* /metrics after the same requests through both servers (paged, prompt
  lookup spec_k 3; SLO thresholds 0, so every latency burns in both):
  every serving family of the JAX exposition is in the port's with the
  same type, except those of modules the port has not taken yet (each
  named with its ROADMAP item); the deltas of the prefill and prefix-hit
  token totals, the spec totals and the TTFT histogram's count are equal.
  METRICS is process-global in both packages, so deltas are compared.
"""
import threading

import pytest
from test_torch_surface import (  # noqa: F401
    _one_torch_thread, close_pair, jax_http, port_http, serve_pair, wait_idle, weights)

from substratus_tpu.observability import metrics as jmetrics
from substratus_tpu.observability import sketch as jsketch
from substratus_tpu.serve import disagg as jdisagg  # noqa: F401 (declares its families)
from substratus_tpu_torch.observability import metrics, sketch
from substratus_tpu_torch.serve import disagg  # noqa: F401 (declares its families)


def _labels(m):
    m.describe("jobs_total", "Jobs processed.", type="counter")
    m.inc("jobs_total", {"path": 'a\\b"c\nd'})
    m.inc("jobs_total", {"path": "x", "kind": "Model"}, by=2)
    m.set("temp_celsius", 21.5)


def _integers(m):
    m.set("slots", 4.0)
    m.inc("reqs_total", by=2.0)
    m.set("slots", 4)
    m.set("frac", 0.25)
    m.set("inf_gauge", float("inf"))


def _histograms(m):
    m.observe("lat", 0.5, buckets=(1.0, 2.0))
    m.observe("lat", 1.5, buckets=(1.0, 2.0))
    m.observe("lat", 99.0, buckets=(1.0, 2.0))
    m.histogram("ratio", "A ratio.", buckets=metrics.RATIO_BUCKETS)
    for v in (0.05, 0.5, 0.95, 1.0):
        m.observe("ratio", v, {"phase": "decode"})
    m.observe("ratio", 0.3, {"phase": "admission"})


def _concurrent(m):
    h = m.histogram("work_seconds", "t", buckets=(0.5, 1.0, 5.0))

    def work(i):
        for j in range(200):
            h.observe(0.25 if (i + j) % 2 else 2.0)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


@pytest.mark.parametrize("case", [_labels, _integers, _histograms, _concurrent])
def test_registry_renders_the_jax_text(case):
    mine, theirs = metrics.Metrics(), jmetrics.Metrics()
    case(mine)
    case(theirs)
    assert mine.render() == theirs.render()
    assert metrics.lint_exposition(mine.render()) == jmetrics.lint_exposition(theirs.render()) == []
    for name in ("jobs_total", "lat", "ratio", "work_seconds", "slots"):
        assert mine.histogram_series(name) == theirs.histogram_series(name)
        assert mine.get(name) == theirs.get(name)


def test_type_conflicts_and_bad_names_rejected_alike():
    for m in (metrics.Metrics(), jmetrics.Metrics()):
        m.inc("a_total")
        for bad in (lambda: m.set("a_total", 1), lambda: m.inc("bad-name"),
                    lambda: m.inc("ok_name", {"bad-label": 1})):
            with pytest.raises(ValueError):
                bad()


def test_slo_tracker_snapshots_match_jax():
    thresholds = {"ttft": 0.2, "inter_token": 0.05}
    mine, theirs = sketch.SLOTracker(thresholds), jsketch.SLOTracker(thresholds)
    values = [0.0004, 0.003, 0.04, 0.07, 0.3, 1.7, 200.0]
    for slo in ("ttft", "inter_token", "unknown"):
        for v in values:
            assert mine.observe(slo, v) == theirs.observe(slo, v)
    assert mine.snapshot() == theirs.snapshot()
    assert mine.burn("ttft") == theirs.burn("ttft") == 3
    merged, jmerged = sketch.Sketch(), jsketch.Sketch()
    merged.merge(sketch.Sketch.from_dict(mine.snapshot()["ttft"]["sketch"]))
    jmerged.merge(jsketch.Sketch.from_dict(theirs.snapshot()["ttft"]["sketch"]))
    for q in (0.5, 0.9, 0.99):
        assert merged.quantile(q) == jmerged.quantile(q)


# Serving families of the JAX exposition whose modules the port has not
# taken yet: the journeys and the step timeline (item 3b), adapters
# (item 6). Disaggregation's (serve/disagg.py, imported above so that its
# families are declared, as the JAX module's are wherever it was imported)
# are held like the rest.
NOT_PORTED = {
    "substratus_serve_slo_exemplars_total": "Queue 1 item 3b (journeys)",
    "substratus_serve_journey_events_total": "Queue 1 item 3b (journeys)",
    "substratus_serve_pipeline_bubble_seconds": "Queue 1 item 3b (the step timeline)",
    "substratus_serve_adapter_requests": "Queue 1 item 6",
    "substratus_serve_adapter_cache_hits_total": "Queue 1 item 6",
    "substratus_serve_adapter_cache_misses_total": "Queue 1 item 6",
    "substratus_serve_adapter_evictions_total": "Queue 1 item 6",
    "substratus_serve_adapters_loaded": "Queue 1 item 6",
}
DELTAS = ("substratus_serve_prefill_tokens_total", "substratus_serve_prefix_hit_tokens_total",
          "substratus_serve_spec_proposed_tokens_total", "substratus_serve_spec_accepted_tokens_total",
          "substratus_serve_ttft_seconds")
SYSTEM = "System: answer with the page, the token and the page again. "


def _families(text: str) -> dict:
    return {line.split(" ")[2]: line.split(" ")[3] for line in text.splitlines() if line.startswith("# TYPE ")}


def _samples(text: str, name: str) -> list:
    """The sample lines of family `name` (a histogram's _bucket, _sum and _count too)."""
    own = (name, f"{name}_bucket", f"{name}_sum", f"{name}_count")
    return [line for line in text.splitlines() if line.split("{")[0].split(" ")[0] in own]


@pytest.fixture(scope="module")
def scraped():
    """Both servers (paged, spec_k 3, SLO thresholds 0) serve the same
    greedy requests one after another (a shared 60-character prefix, so
    prefix hits; repetitive text, so lookup proposals), then both
    /metrics. Returns ({package: exposition}, {package: {name: delta}},
    {package: its registry's exposition before the traffic}): the
    registries are the process's, so other tests run in this process may
    have left series in one package's alone."""
    j_params, t_params = weights(0)
    pair = serve_pair(j_params, t_params, spec_k=3, slo_ttft_s=0.0, slo_inter_token_s=0.0)
    registries = {"jax": jmetrics.METRICS, "port": metrics.METRICS}
    before = {k: {n: r.get(n) or 0 for n in DELTAS} for k, r in registries.items()}
    rendered = {k: r.render() for k, r in registries.items()}
    try:
        calls = [("POST", "/v1/completions", {"prompt": SYSTEM + text, "max_tokens": 24, "temperature": 0}, None)
                 for text in ("read the page", "write the token, read the page, write the token", "the page",
                              "again and again and again")]
        calls.append(("POST", "/v1/completions", {"prompt": SYSTEM, "max_tokens": 16, "temperature": 0,
                                                  "stream": True}, None))
        for call in calls:  # one at a time: the same schedule in both engines
            (j,), (t,) = jax_http(pair.jstate, [call]), port_http(pair.srv, [call])
            assert j[0] == t[0] == 200
            wait_idle(pair.teng, pair.jeng)
        (j,), (t,) = jax_http(pair.jstate, [("GET", "/metrics", None, None)]), port_http(
            pair.srv, [("GET", "/metrics", None, None)])
        assert t[1]["Content-Type"] == j[1]["Content-Type"] == "text/plain; version=0.0.4; charset=utf-8"
    finally:
        close_pair(pair)
    after = {k: {n: r.get(n) or 0 for n in DELTAS} for k, r in registries.items()}
    deltas = {k: {n: after[k][n] - before[k][n] for n in DELTAS} for k in registries}
    return {"jax": j[2], "port": t[2]}, deltas, rendered


def test_metrics_families_and_types_match_jax(scraped):
    text, _, before = scraped
    assert metrics.lint_exposition(text["port"]) == []
    jax_f, port_f = _families(text["jax"]), _families(text["port"])
    serving = {n: k for n, k in jax_f.items() if n.startswith(("substratus_serve_", "substratus_slo_",
                                                                 "substratus_http_"))}
    # A JAX family whose samples this traffic left as they were is another
    # test's (a JAX disaggregation test's transfers, say), not this traffic's.
    untouched = {n for n in serving if _samples(before["jax"], n) == _samples(text["jax"], n)}
    missing = sorted(n for n in serving if n not in port_f and n not in NOT_PORTED and n not in untouched)
    assert not missing
    assert {n: port_f[n] for n in serving if n in port_f} == {n: k for n, k in serving.items() if n in port_f}
    for name in ("substratus_serve_ttft_seconds", "substratus_serve_phase_seconds",
                 "substratus_serve_spec_proposed_tokens_total", "substratus_slo_burn_total",
                 "substratus_serve_kv_page_utilization_ratio", "substratus_serve_first_compile_seconds",
                 "substratus_http_requests_total", "substratus_serve_requests_total"):
        assert name in serving and port_f[name] == serving[name]
    for phase in ("admission", "prefill", "sample", "decode"):
        assert f'substratus_serve_phase_seconds_count{{phase="{phase}"}}' in text["port"]


def test_metrics_deltas_match_jax(scraped):
    _, deltas, _ = scraped
    assert deltas["port"] == deltas["jax"]
    d = deltas["port"]
    assert d["substratus_serve_ttft_seconds"] == 5
    assert d["substratus_serve_prefix_hit_tokens_total"] > 0 and d["substratus_serve_spec_proposed_tokens_total"] > 0
