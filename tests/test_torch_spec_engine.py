"""The port's Engine with speculative decoding (substratus_tpu_torch/serve/
engine.py, EngineConfig.spec_k) against the JAX Engine's, on the CPU.

The tiny float32 config (vocabulary 258, EOS 257) with the JAX weights
carried across by bridge.params_from_jax. Port and JAX engines take the
same prompts, all queued before the scheduler starts; greedy tokens are
exact and spec_proposed, spec_accepted and verify_passes equal JAX's, for
prompt lookup on the paged pool and the dense cache with either
scheduler, a self-draft and a disagreeing one-layer draft on the pool,
int4 weights with the fused decode on the dense cache (the JAX stack of
every decode lever), chunked prefill, the window's edge, and a
preemption in the middle of a round on a small pool (lookup and a draft,
whose pool is prefilled again on resume). The adaptive draft length is
compared as the trajectory of each slot's acceptance EWMA. Then sampling
rows, and serve.main's spec_k and draft_model. EOS is an id the tiny model
never samples here, and each test that compares tokens asserts it.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substratus_tpu.models import llama as jllama
from substratus_tpu.ops.quant4 import quantize4_params as j_quantize4_params
from substratus_tpu.serve.engine import Engine as JEngine
from substratus_tpu.serve.engine import EngineConfig as JEngineConfig
from substratus_tpu.serve.engine import Request as JRequest
from substratus_tpu_torch.bridge import params_from_jax
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.serve import main
from substratus_tpu_torch.serve.engine import Engine, EngineConfig, Request


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


EOS = 257
J_CFG = jllama.CONFIGS["tiny"].replace(vocab_size=258, dtype=jnp.float32)
T_CFG = llama.CONFIGS["tiny"].replace(vocab_size=258, dtype=torch.float32)
SPEC_STATS = ("spec_proposed", "spec_accepted", "verify_passes")


def _port(j_params, cfg, quantize="none"):
    model = llama.Llama(cfg, device="cpu", quantize=quantize)
    model.load_state_dict(params_from_jax(jax.device_get(j_params)))
    return model


@pytest.fixture(scope="module")
def weights():
    """(JAX, port) weights: the target (seed 0) and a one-layer draft
    (seed 1) that disagrees with it."""
    jt = jllama.init_params(J_CFG, jax.random.key(0))
    jd = jllama.init_params(J_CFG.replace(n_layers=1), jax.random.key(1))
    return (jt, _port(jt, T_CFG)), (jd, _port(jd, T_CFG.replace(n_layers=1)))


def _rep_prompts(n=4, length=16, base=10):
    """Repetitive prompts, a distinct 4-gram each: lookup matches."""
    return [([base + 5 * i + j for j in range(4)] * -(-length // 4))[:length] for i in range(n)]


def _run(engine, req_cls, prompts, max_tokens=12, temperature=0.0):
    """Submit every prompt before the scheduler starts, then collect each
    stream: [(tokens, finish)] in submission order."""
    reqs = [engine.submit(req_cls(list(p), max_tokens=max_tokens, temperature=temperature)) for p in prompts]
    engine.start()
    try:
        outs = []
        for req in reqs:
            toks = []
            while (tok := req.out.get(timeout=300)) is not None:
                toks.append(tok)
            outs.append((toks, req.finish_reason))
        return outs
    finally:
        engine.stop()


def _both(weights, prompts, max_tokens=12, draft=None, port_params=None, j_params=None, t_cfg=T_CFG, j_cfg=J_CFG,
          **ec):
    """The same prompts through the port's and the JAX engine of one
    config; returns (port engine, its outputs, JAX engine, its outputs)."""
    (jt, tt), (jd, td) = weights
    ec = dict(ec, eos_token_id=EOS)
    drafts = {None: (None, None), "self": ((T_CFG, tt), (J_CFG, jt)),
              "other": ((T_CFG.replace(n_layers=1), td), (J_CFG.replace(n_layers=1), jd))}[draft]
    port = Engine(t_cfg, tt if port_params is None else port_params, EngineConfig(**ec), device="cpu",
                  draft=drafts[0])
    jeng = JEngine(j_cfg, jt if j_params is None else j_params, JEngineConfig(**ec), draft=drafts[1])
    return port, _run(port, Request, prompts, max_tokens), jeng, _run(jeng, JRequest, prompts, max_tokens)


def _assert_matches(port, got, jeng, want, finish="length"):
    assert got == want
    assert all(f == finish for _, f in got), got  # EOS never sampled
    assert {k: port.stats[k] for k in SPEC_STATS} == {k: jeng.stats[k] for k in SPEC_STATS}


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_prompt_lookup_matches_jax(weights, layout, overlap):
    port, got, jeng, want = _both(weights, _rep_prompts(), max_batch=4, max_seq_len=64, kv_layout=layout, spec_k=3,
                                  overlap=overlap)
    _assert_matches(port, got, jeng, want)
    assert port.stats["spec_accepted"] > 0 and port.stats["verify_passes"] > 0
    assert port.stats["decode_steps"] == sum(port.stats[f"rounds_w{w}"] for w in range(1, 5))


@pytest.mark.parametrize("draft", ["self", "other"])
def test_draft_model_matches_jax(weights, draft):
    """A self-draft accepts every proposal; a disagreeing draft (seed 1)
    is rejected, and its streams degrade to plain rows."""
    prompts = [[256, 3, 4, 5], [256, 11, 12, 13], [256, 20, 21, 22]]
    port, got, jeng, want = _both(weights, prompts, 24, draft=draft, max_batch=3, max_seq_len=96,
                                  spec_k=4 if draft == "self" else 3)
    _assert_matches(port, got, jeng, want)
    assert port.spec_draft and port.stats["draft_prefill_chunks"] == 3
    if draft == "self":
        assert port.stats["spec_accepted"] == port.stats["spec_proposed"] > 0
        assert port.stats["verify_passes"] < sum(len(t) for t, _ in got)
    else:
        assert port.stats["spec_accepted"] < port.stats["spec_proposed"] and port.stats["rounds_w1"] > 0
    assert port.alloc.free_pages + len(port.prefix) == port.n_pages


def test_int4_fused_dense_lookup_stack(weights):
    """int4 weights + the fused decode on the dense cache + prompt lookup:
    JAX's test_all_decode_levers_stack_dense_fused_int4_lookup, against
    the JAX engine of the same stack and against the plain port engine."""
    (jt, _), _ = weights
    jq = j_quantize4_params(jt, jllama.quant_contracting(J_CFG))
    tq = _port(jq, T_CFG, "int4")
    prompts = [[256, 3, 4, 5, 3, 4, 5, 3, 4], [256, 9, 8, 9, 8, 9, 8]]
    port, got, jeng, want = _both(weights, prompts, 24, port_params=tq, j_params=jq,
                                  t_cfg=T_CFG.replace(decode_attn_impl="fused"),
                                  j_cfg=J_CFG.replace(decode_attn_impl="fused"), max_batch=2, max_seq_len=96,
                                  kv_layout="dense", spec_k=3)
    _assert_matches(port, got, jeng, want)
    plain = _run(Engine(T_CFG, tq, EngineConfig(max_batch=2, max_seq_len=96, eos_token_id=EOS, kv_layout="dense"),
                        device="cpu"), Request, prompts, 24)
    assert got == plain and port.stats["verify_passes"] > 0 and port.stats["spec_accepted"] > 0


def test_chunked_prefill_matches_jax(weights):
    """Prompts of several chunks admitted while rounds are in flight: the
    fresh rows of the accept walk pick up their chunked first token."""
    port, got, jeng, want = _both(weights, _rep_prompts(3, 40), 8, max_batch=4, max_seq_len=64, max_prefill_len=16,
                                  spec_k=3)
    _assert_matches(port, got, jeng, want)
    assert port.stats["prefill_chunks"] == 9  # 16 + 16 + 8 tokens a prompt


def test_window_edge_matches_jax(weights):
    """The window lands inside an accepted run: each emit releases on its
    own position, one token more or fewer than JAX fails."""
    port, got, jeng, want = _both(weights, _rep_prompts(3, 8, base=30), 64, max_batch=4, max_seq_len=24, spec_k=3, overlap=True)
    _assert_matches(port, got, jeng, want)
    assert all(0 < len(t) < 64 for t, _ in got)  # the window, not the budget, stopped them


@pytest.mark.parametrize("draft", [None, "self"])
def test_preempt_mid_round_matches_jax(weights, draft):
    """Pool pressure while rounds pipeline: a wide round's growth flushes
    the round in flight before it preempts, and a resumed request is
    prefilled again (with a draft: in both pools)."""
    port, got, jeng, want = _both(weights, _rep_prompts(3, 4), 16, draft=draft, max_batch=4, max_seq_len=48,
                                  kv_layout="paged", page_size=4, kv_pool_tokens=48, prefix_cache=False, spec_k=2,
                                  overlap=True)
    _assert_matches(port, got, jeng, want)
    assert port.stats["preemptions"] == jeng.stats["preemptions"] >= 1
    assert port.alloc.free_pages == port.n_pages and not port.block_table.any()
    if draft:
        assert port.stats["draft_prefill_chunks"] >= 3 + port.stats["preemptions"]


def test_adaptive_k_trajectory_matches_jax(weights):
    """Prompt lookup on two unrepetitive prompts: early proposals are
    rejected and both streams degrade below spec_threshold; they probe
    every spec_probe_every=3 rounds and climb back once the model's output
    repeats. The per-slot EWMA and degraded-round count after every round
    equal JAX's."""
    (jt, tt), _ = weights
    ec = dict(max_batch=2, max_seq_len=128, eos_token_id=EOS, spec_k=4, spec_probe_every=3, overlap=False)
    trajectories = []
    for eng, req_cls in ((Engine(T_CFG, tt, EngineConfig(**ec), device="cpu"), Request),
                         (JEngine(J_CFG, jt, JEngineConfig(**ec)), JRequest)):
        reqs = [req_cls(p, max_tokens=80, temperature=0.0)
                for p in ([256, 220, 115, 229, 203], [256, 59, 196, 13, 145, 103, 255, 50, 242, 23])]
        for req in reqs:
            eng.queue.put(req)
        assert eng._admit() == 2
        rounds = []
        while eng.active.any():
            eng._step()
            rounds.append(eng._spec_ewma.tolist() + eng._spec_degraded.tolist())
        assert all(r.finish_reason == "length" for r in reqs)  # EOS never sampled
        trajectories.append(rounds)
    assert trajectories[0] == trajectories[1]
    ewma = np.array(trajectories[0])[:, :2]
    for slot in range(2):  # degraded, then a probe's acceptance won something back
        low = int(ewma[:, slot].argmin())
        assert ewma[low, slot] < 0.35 and (np.diff(ewma[low:, slot]) > 0).any()


def test_sampling_rows_complete_and_never_propose(weights):
    """Sampling rows take the verify's position-0 sample, one token a
    round, and complete; they never count as proposals, so the greedy
    rows beside them keep JAX's tokens and counters (their samples differ:
    the port draws from a torch.Generator)."""
    (jt, tt), (jd, td) = weights
    prompts = _rep_prompts(4)
    temps = [0.0, 0.8, 0.0, 0.8]
    outs = []
    for eng, req_cls in ((Engine(T_CFG, tt, EngineConfig(max_batch=4, max_seq_len=64, eos_token_id=EOS, spec_k=3),
                                 device="cpu"), Request),
                         (JEngine(J_CFG, jt, JEngineConfig(max_batch=4, max_seq_len=64, eos_token_id=EOS, spec_k=3)),
                          JRequest)):
        reqs = [eng.submit(req_cls(list(p), max_tokens=12, temperature=t)) for p, t in zip(prompts, temps)]
        outs.append((eng, _collect(eng, reqs)))
    (port, got), (jeng, want) = outs
    for i, t in enumerate(temps):
        assert 1 <= len(got[i][0]) <= 12 and got[i][1] in ("length", "stop")
        if t == 0.0:
            assert got[i] == want[i] and got[i][1] == "length"
    assert {k: port.stats[k] for k in SPEC_STATS} == {k: jeng.stats[k] for k in SPEC_STATS}
    # Only the greedy rows proposed: at most k a round each.
    assert 0 < port.stats["spec_proposed"] <= 3 * 2 * port.stats["verify_passes"]


def _collect(engine, reqs):
    engine.start()
    try:
        outs = []
        for req in reqs:
            toks = []
            while (tok := req.out.get(timeout=300)) is not None:
                toks.append(tok)
            outs.append((toks, req.finish_reason))
        return outs
    finally:
        engine.stop()


def test_serve_main_spec_knobs(tmp_path, monkeypatch, capsys):
    """serve.main takes spec_k and draft_model (params.json, or --spec-k
    and --draft-model): prompt lookup without a draft, the draft loaded
    and quantized like the target with one; a draft of another family
    exits; a draft on kv_layout dense turns speculation off with the JAX
    entry point's message."""
    draft_cfg = T_CFG.replace(n_layers=1)
    loads = []

    def fake_load(path, device=None, dtype=torch.bfloat16):
        loads.append(path)
        if path == "/models/other-family":
            return object(), None
        return draft_cfg, llama.init_params(draft_cfg, seed=1, device=device)

    monkeypatch.setattr(main, "load_checkpoint", fake_load)
    base = {"config": "tiny", "max_batch": 2, "max_seq_len": 64}

    def build(params, *argv):
        path = tmp_path / "params.json"
        path.write_text(json.dumps({**base, **params}))
        return main.build(["--device", "cpu", "--host", "127.0.0.1", "--port", "0", "--params", str(path), *argv])

    srv = build({"spec_k": 3})
    srv.stop()
    assert srv.state.engine.spec and not srv.state.engine.spec_draft and srv.state.engine.ec.spec_k == 3
    assert "speculative decoding: prompt-lookup k=3" in capsys.readouterr().out
    srv = build({"quantize": "int4"}, "--spec-k", "2", "--draft-model", "/models/draft")
    srv.stop()
    eng = srv.state.engine
    assert eng.spec_draft and eng.ec.spec_k == 2 and loads == ["/models/draft"]
    assert type(eng.draft_params.layers[0].wq).__name__ == "Q4Tensor"  # quantized like the target
    assert "speculative decoding: draft=/models/draft k=2" in capsys.readouterr().out
    srv = build({"spec_k": 3, "draft_model": "/models/draft", "kv_layout": "dense"})
    srv.stop()
    assert not srv.state.engine.spec and loads == ["/models/draft"]  # not even loaded
    assert "draft spec_k needs kv_layout=paged; speculation disabled" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="same family"):
        build({"spec_k": 3, "draft_model": "/models/other-family"})
    with pytest.raises(ValueError, match="paged kv layout"):
        Engine(T_CFG, srv.state.engine.params, EngineConfig(kv_layout="dense", spec_k=2), device="cpu",
               draft=(draft_cfg, llama.init_params(draft_cfg, seed=1, device="cpu")))
