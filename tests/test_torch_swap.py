"""The port's hot weight swap (Engine.swap_params, POST /swapz) on the CPU,
after tests/test_weight_swap.py's cases, against the JAX engine.

Tiny float32 llama weights from a seed (bridge.params_from_jax carries
the JAX ones across), the paged pool: a swap to value-identical weights
in the middle of a decode is token for token an unswapped twin's and
writes into the served tensors (their storage stays); after a swap to
other weights the tokens are the JAX engine's after the same swap; an
explicit version is kept; a structure or dtype mismatch is rejected and
serving goes on; a swap on a stopped engine raises, and one staged when
the engine stops fails its waiter; the same under speculation and
overlap; int8 and int4 weights swap the same way; the prefix registry is
emptied (its pages hold the old weights' K/V); /swapz answers 200, 400,
409 and 501 as the JAX app does, and serve.main's checkpoint loader runs
the boot path's load.
"""
import json
import queue
import threading

import jax
import pytest
import torch
from test_torch_surface import (  # noqa: F401
    EOS, J_CFG, T_CFG, _one_torch_thread, jax_http, port_http, weights)

from substratus_tpu.models import llama as jllama
from substratus_tpu.serve.engine import Engine as JEngine
from substratus_tpu.serve.engine import EngineConfig as JEngineConfig
from substratus_tpu.serve.server import ServerState as JServerState
from substratus_tpu.serve.tokenizer import ByteTokenizer as JByteTokenizer
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.observability.metrics import METRICS
from substratus_tpu_torch.serve import main
from substratus_tpu_torch.serve.engine import Engine, EngineConfig, Request
from substratus_tpu_torch.serve.server import Server, ServerState
from substratus_tpu_torch.serve.tokenizer import ByteTokenizer

PROMPT = [256, 5, 6, 7]


@pytest.fixture(scope="module")
def seeds():
    return {seed: weights(seed) for seed in (0, 3)}


def _port_weights(seeds, seed, quantize="none"):
    """A fresh copy of the port's weights of a seed (quantized if asked)."""
    model = llama.Llama(T_CFG, device="cpu")
    model.load_state_dict(seeds[seed][1].state_dict())
    return llama.quantize_weights(model, quantize)


def _engine(params, **ec):
    ec = {"max_batch": 4, "max_seq_len": 96, "eos_token_id": EOS, **ec}
    eng = Engine(params.cfg, params, EngineConfig(**ec), device="cpu")
    eng.start()
    return eng


def _drain(req, already=()):
    toks = list(already)
    while (t := req.out.get(timeout=120)) is not None:
        toks.append(t)
    return toks


def test_swap_mid_decode_is_token_exact_and_in_place(seeds):
    twin = _engine(_port_weights(seeds, 0))
    try:
        want = twin.generate(PROMPT, max_tokens=16)
    finally:
        twin.stop()
    eng = _engine(_port_weights(seeds, 0))
    storage = {n: t.data_ptr() for n, t in eng.params.state_dict().items()}
    try:
        for version in (1, 2, 3):
            req = eng.submit(Request(PROMPT, max_tokens=16))
            head = [req.out.get(timeout=120) for _ in range(4)]
            assert eng.swap_params(_port_weights(seeds, 0)) == version
            assert _drain(req, head) == want
        assert eng.weights_version == 3 and eng.load_snapshot()["weights_version"] == 3
        assert {n: t.data_ptr() for n, t in eng.params.state_dict().items()} == storage
        assert eng.generate(PROMPT, max_tokens=16) == want
    finally:
        eng.stop()


def test_swap_to_other_weights_matches_jax_and_keeps_an_explicit_version(seeds):
    (j0, _), (j3, _) = seeds[0], seeds[3]
    jeng = JEngine(J_CFG, j0, JEngineConfig(max_batch=4, max_seq_len=96, eos_token_id=EOS))
    jeng.start()
    eng = _engine(_port_weights(seeds, 0))
    try:
        old = eng.generate(PROMPT, max_tokens=12)
        assert old == jeng.generate(PROMPT, max_tokens=12)
        assert jeng.swap_params(j3, version=7) == eng.swap_params(_port_weights(seeds, 3), version=7) == 7
        new = eng.generate(PROMPT, max_tokens=12)
        assert new == jeng.generate(PROMPT, max_tokens=12) != old
        assert eng.swap_params(_port_weights(seeds, 3)) == jeng.swap_params(j3) == 8
        assert eng.load_snapshot()["weights_version"] == jeng.load_snapshot()["weights_version"] == 8
        assert METRICS.get("substratus_serve_weights_version") == 8
    finally:
        jeng.stop()
        eng.stop()


def test_structure_mismatch_is_rejected_and_serving_goes_on(seeds):
    eng = _engine(_port_weights(seeds, 0))
    rejected = METRICS.get("substratus_serve_weight_swaps_total", {"outcome": "rejected"}) or 0
    try:
        want = eng.generate(PROMPT, max_tokens=8)
        shallow = llama.init_params(T_CFG.replace(n_layers=1), device="cpu")
        bf16 = _port_weights(seeds, 0).to(torch.bfloat16)
        for bad in (shallow, bf16, _port_weights(seeds, 0, "int8")):
            with pytest.raises(ValueError, match="matching structure"):
                eng.swap_params(bad)
        assert eng.weights_version == 0
        assert METRICS.get("substratus_serve_weight_swaps_total", {"outcome": "rejected"}) == rejected + 3
        assert eng.generate(PROMPT, max_tokens=8) == want
    finally:
        eng.stop()


def test_swap_on_a_stopped_engine_and_stop_with_a_staged_swap(seeds):
    eng = _engine(_port_weights(seeds, 0))
    eng.stop()
    with pytest.raises(RuntimeError, match="running engine"):
        eng.swap_params(_port_weights(seeds, 0))
    eng = _engine(_port_weights(seeds, 0))
    errs = queue.Queue()
    new = _port_weights(seeds, 3)

    def racer():
        try:
            eng.swap_params(new, timeout_s=60.0)
            errs.put(None)
        except BaseException as e:  # relayed to the assert
            errs.put(e)

    t = threading.Thread(target=racer, daemon=True)
    t.start()
    eng.stop()
    got = errs.get(timeout=60)
    assert got is None or isinstance(got, RuntimeError), got
    t.join(timeout=10)


def test_swap_under_speculation_and_overlap(seeds):
    twin = _engine(_port_weights(seeds, 0), spec_k=3)
    fresh3 = _engine(_port_weights(seeds, 3), spec_k=3)
    try:
        want = twin.generate(PROMPT, max_tokens=16)
        want3 = fresh3.generate(PROMPT, max_tokens=8)
    finally:
        twin.stop()
        fresh3.stop()
    eng = _engine(_port_weights(seeds, 0), spec_k=3)
    try:
        assert eng.overlap and eng.spec
        req = eng.submit(Request(PROMPT, max_tokens=16))
        head = [req.out.get(timeout=120) for _ in range(3)]
        eng.swap_params(_port_weights(seeds, 0))
        assert _drain(req, head) == want
        eng.swap_params(_port_weights(seeds, 3))
        assert eng.generate(PROMPT, max_tokens=8) == want3
        assert eng.weights_version == 2 and eng.stats["verify_passes"] > 0
    finally:
        eng.stop()


@pytest.mark.parametrize("quantize", ["int8", "int4"])
def test_quantized_weights_swap_the_same_way(seeds, quantize):
    """int8 values and scales, int4 packed values and scales (and their
    packing, the extra state): copied in place, the int4 operand views
    kept, the tokens a fresh engine's on the new quantized weights."""
    fresh = _engine(_port_weights(seeds, 3, quantize))
    try:
        want = fresh.generate(PROMPT, max_tokens=10)
    finally:
        fresh.stop()
    eng = _engine(_port_weights(seeds, 0, quantize))
    storage = {n: t.data_ptr() for n, t in eng.params.state_dict().items() if torch.is_tensor(t)}
    try:
        old = eng.generate(PROMPT, max_tokens=10)
        assert eng.swap_params(_port_weights(seeds, 3, quantize)) == 1
        assert eng.generate(PROMPT, max_tokens=10) == want != old
        assert {n: t.data_ptr() for n, t in eng.params.state_dict().items() if torch.is_tensor(t)} == storage
    finally:
        eng.stop()


def test_swap_empties_the_prefix_registry(seeds):
    """Registered pages hold the old weights' K/V: after a swap the same
    prompt is prefilled whole, and its tokens are a fresh engine's on the
    new weights. (The JAX engine keeps its registry across a swap; ROADMAP
    Queue 3 records the difference.)"""
    prompt = [256] + list(range(40, 80))  # 41 tokens: two full pages registered
    fresh = _engine(_port_weights(seeds, 3))
    try:
        want = fresh.generate(prompt, max_tokens=8)
    finally:
        fresh.stop()
    eng = _engine(_port_weights(seeds, 0))
    try:
        eng.generate(prompt, max_tokens=8)
        assert len(eng.prefix) == 2
        eng.swap_params(_port_weights(seeds, 3))
        hits = eng.stats["prefix_hit_tokens"]
        assert eng.generate(prompt, max_tokens=8) == want
        assert eng.stats["prefix_hit_tokens"] == hits and len(eng.prefix) == 2
    finally:
        eng.stop()


def test_swapz_answers_as_the_jax_app(seeds):
    """POST /swapz through both servers with loaders of the same
    checkpoints: 200 with the version (also on /loadz), an explicit
    version and source, 409 for another architecture, 400 for an unknown
    checkpoint and a bad body, 501 without a loader."""
    (j0, _), (j3, _) = seeds[0], seeds[3]
    j_shallow = jllama.init_params(J_CFG.replace(n_layers=1), jax.random.key(0))

    def jloader(ref):
        if ref not in ("good", "wrong-arch"):
            raise FileNotFoundError(ref)
        return j3 if ref == "good" else j_shallow

    def tloader(ref):
        if ref == "good":
            return _port_weights(seeds, 3)
        if ref == "wrong-arch":
            return llama.init_params(T_CFG.replace(n_layers=1), device="cpu")
        raise FileNotFoundError(ref)

    jeng = JEngine(J_CFG, j0, JEngineConfig(max_batch=4, max_seq_len=96, eos_token_id=EOS))
    jeng.start()
    eng = _engine(_port_weights(seeds, 0))
    jstate = JServerState(jeng, JByteTokenizer(), "tiny", checkpoint_loader=jloader)
    srv = Server(ServerState(eng, ByteTokenizer(), "tiny", checkpoint_loader=tloader), host="127.0.0.1",
                 port=0).start()
    calls = [("POST", "/swapz", {"checkpoint": "good"}, None), ("GET", "/loadz", None, None),
             ("POST", "/swapz", {"checkpoint": "good", "version": 4, "source": "rollout"}, None),
             ("POST", "/swapz", {"checkpoint": "wrong-arch"}, None), ("POST", "/swapz", {"checkpoint": "gone"}, None),
             ("POST", "/swapz", {}, None), ("POST", "/swapz", {"checkpoint": "good", "source": "oops"}, None),
             ("POST", "/swapz", {"checkpoint": "good", "version": "v2"}, None), ("POST", "/swapz", b"{", None)]
    try:
        j, t = jax_http(jstate, calls), port_http(srv, calls)
        assert [c[0] for c in t] == [c[0] for c in j] == [200, 200, 200, 409, 400, 400, 400, 400, 400]
        assert json.loads(t[0][2]) == json.loads(j[0][2]) == {"weights_version": 1, "checkpoint": "good",
                                                              "source": "swap"}
        assert json.loads(t[1][2])["weights_version"] == json.loads(j[1][2])["weights_version"] == 1
        assert json.loads(t[2][2]) == json.loads(j[2][2])
        assert json.loads(t[3][2])["error"]["type"] == json.loads(j[3][2])["error"]["type"] == "swap_rejected"
        assert json.loads(t[4][2]) == json.loads(j[4][2])
        assert [c[2] for c in t[5:]] == [c[2] for c in j[5:]]
        assert eng.weights_version == 4
        jstate.checkpoint_loader = srv.state.checkpoint_loader = None
        calls = [("POST", "/swapz", {"checkpoint": "good"}, None)]
        (jn,), (tn,) = jax_http(jstate, calls), port_http(srv, calls)
        assert tn[0] == jn[0] == 501 and json.loads(tn[2]) == json.loads(jn[2])
    finally:
        jeng.stop()
        srv.stop()


def test_serve_main_swaps_checkpoints_through_its_loader(tmp_path):
    """serve.main's loader: the boot path's load and quantize pipeline on a
    checkpoint ref; another architecture 409, a missing path 400."""
    from substratus_tpu_torch.tools import ckpt_writer

    for name, seed, layers in (("boot", 0, 2), ("next", 1, 2), ("shallow", 0, 1)):
        ckpt_writer.write_hf(str(tmp_path / name), llama.init_params(T_CFG.replace(n_layers=layers), seed=seed,
                                                                     device="cpu"))
    params = tmp_path / "params.json"
    params.write_text(json.dumps({"max_batch": 2, "max_seq_len": 64, "quantize": "int8"}))
    srv = main.build(["--device", "cpu", "--host", "127.0.0.1", "--port", "0", "--params", str(params),
                      "--model", str(tmp_path / "boot")]).start()
    try:
        before = port_http(srv, [("POST", "/v1/completions", {"prompt": "hi", "max_tokens": 6, "temperature": 0},
                                  None)])[0]
        got = port_http(srv, [("POST", "/swapz", {"checkpoint": str(tmp_path / "next")}, None),
                              ("POST", "/v1/completions", {"prompt": "hi", "max_tokens": 6, "temperature": 0}, None),
                              ("POST", "/swapz", {"checkpoint": str(tmp_path / "shallow")}, None),
                              ("POST", "/swapz", {"checkpoint": str(tmp_path / "missing")}, None),
                              ("POST", "/swapz", {"checkpoint": str(tmp_path / "boot")}, None),
                              ("POST", "/v1/completions", {"prompt": "hi", "max_tokens": 6, "temperature": 0}, None)])
        assert [g[0] for g in got] == [200, 200, 409, 400, 200, 200]
        assert json.loads(got[0][2])["weights_version"] == 1 and json.loads(got[4][2])["weights_version"] == 2
        assert json.loads(got[5][2])["choices"] == json.loads(before[2])["choices"]
        assert srv.state.engine.params.layers[0].wq.q.dtype == torch.int8
    finally:
        srv.stop()
