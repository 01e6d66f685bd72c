"""The port's disaggregated pair (a prefill-role Engine -> real TCP -> a
decode-role Engine, substratus_tpu_torch/serve/disagg.py and the engine's
roles) against the JAX monolithic engine and the port's own, on the CPU.

Greedy tokens through the handoff are identical to both monoliths', in the
model-dtype and int8 pools, with a prompt of three chunks and a prefix hit
on the prefill side, one request at a time and four at once (the decode
tier overlapped, installing migrations between its steps). Mixed pools
negotiate and decode to the full budget; the pool's import is bit for bit
JAX's quantize_kv / dequantize_kv / cast of the same pages. The failure
cases end as JAX's do, each within its own timeout: a structural mismatch
ends the request with "error", a truncated stream is discarded and the
decode engine serves on, a dead decode worker's request resumes token for
token on a survivor, and with none left ends with "error". The role checks
raise JAX's messages, overlap resolves as in JAX, load_snapshot reports
the role and the transfer queue, resubmit passes max_queue and records the
requeue, and an adapter tenant's request through the handoff equals a
store engine's.

Tiny float32 llama weights from a seed (bridge.params_from_jax).
"""
import json
import socket
import struct
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substratus_tpu.models import llama as jllama
from substratus_tpu.ops.quant import dequantize_kv as j_dequantize_kv
from substratus_tpu.ops.quant import quantize_kv as j_quantize_kv
from substratus_tpu.serve.engine import Engine as JEngine
from substratus_tpu.serve.engine import EngineConfig as JEngineConfig
from substratus_tpu.serve.engine import Request as JRequest
from substratus_tpu_torch.bridge import params_from_jax
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.observability.metrics import METRICS
from substratus_tpu_torch.serve import adapters, disagg
from substratus_tpu_torch.serve.engine import Engine, EngineConfig, EngineOverloaded, Request

EOS = 257
J_CFG = jllama.CONFIGS["tiny"].replace(vocab_size=258, dtype=jnp.float32)
T_CFG = llama.CONFIGS["tiny"].replace(vocab_size=258, dtype=torch.float32)
PROMPTS = [[256, 5, 6, 7], [256, 70, 71], list(range(1, 40))]  # the last: three pages, three chunks
POOLS = {"model": {}, "int8": {"kv_cache_dtype": "int8"}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    j_params = jllama.init_params(J_CFG, jax.random.key(0))
    t_params = llama.Llama(T_CFG, device="cpu")
    t_params.load_state_dict(params_from_jax(jax.device_get(j_params)))
    return j_params, t_params


def ec(cls=EngineConfig, **kw):
    return cls(**{"max_batch": 4, "max_seq_len": 64, "max_prefill_len": 16, "eos_token_id": EOS,
                  "kv_layout": "paged", **kw})


def drain(req, timeout=120):
    out = []
    while (tok := req.out.get(timeout=timeout)) is not None:
        out.append(tok)
    return out


def generate(engine, prompt, max_tokens=6, **kw):
    cls = Request if isinstance(engine, Engine) else JRequest
    req = engine.submit(cls(list(prompt), max_tokens=max_tokens, temperature=0.0, **kw))
    out = drain(req)
    assert req.finish_reason == "length", req.finish_reason  # EOS is never sampled here
    return out


def monolith(cls, cfg_cls, params, prompts, max_tokens=6, cfg=None, **kw):
    """A started monolithic engine's greedy tokens, one request at a time."""
    eng = cls(cfg or (J_CFG if cls is JEngine else T_CFG), params, ec(cfg_cls, **kw),
              **({"device": "cpu"} if cls is Engine else {}))
    eng.start()
    try:
        return [generate(eng, p, max_tokens) for p in prompts]
    finally:
        eng.stop()


class Pair:
    """The port's prefill engine and its HandoffManager, and decode engines
    each behind a HandoffServer, over loopback TCP."""

    def __init__(self, params, pre_kw=None, dec_kw=None, n_decode=1, manager_kw=None, store=None):
        """`store`, when given, makes each engine's AdapterStore."""
        extra = (lambda: {"adapters": store()}) if store is not None else dict
        self.decs, self.srvs = [], []
        for _ in range(n_decode):
            dec = Engine(T_CFG, params, ec(role="decode", **(dec_kw or {})), device="cpu", **extra())
            dec.start()
            self.decs.append(dec)
            self.srvs.append(disagg.HandoffServer(dec, host="127.0.0.1"))
        pre_ec = ec(role="prefill", **(pre_kw or {}))
        kw = {"connect_timeout": 5.0, "ship_timeout": 10.0, "io_timeout": 60.0, **(manager_kw or {})}
        self.mgr = disagg.HandoffManager([f"127.0.0.1:{s.port}" for s in self.srvs],
                                         disagg.PoolSpec.from_engine_config(T_CFG, pre_ec), **kw)
        self.pre = Engine(T_CFG, params, pre_ec, device="cpu", handoff=self.mgr, **extra())
        self.pre.start()

    def close(self):
        self.pre.stop()
        self.mgr.close()
        for dec, srv in zip(self.decs, self.srvs):
            dec.stop()
            srv.close()


@pytest.mark.parametrize("pool", list(POOLS))
def test_pair_token_exact_against_both_monoliths(weights, pool):
    """One at a time (a prompt of three chunks; the long prompt again takes
    its two full pages from the prefill tier's registry), then four at
    once: every greedy token equals the JAX monolith's and the port's."""
    kw = POOLS[pool]
    want = monolith(JEngine, JEngineConfig, weights[0], PROMPTS, **kw)
    assert monolith(Engine, EngineConfig, weights[1], PROMPTS, **kw) == want
    pair = Pair(weights[1], kw, kw)
    try:
        assert pair.decs[0].overlap and not pair.pre.overlap
        got = [generate(pair.pre, p) for p in PROMPTS]
        again = generate(pair.pre, PROMPTS[2])
        reqs = [pair.pre.submit(Request(list(p), max_tokens=6, temperature=0.0)) for p in PROMPTS + PROMPTS[:1]]
        together = [drain(r) for r in reqs]
        stats = dict(pair.pre.stats), dict(pair.decs[0].stats)
    finally:
        pair.close()
    assert got == want and again == want[2] and together == want + want[:1]
    assert stats[0]["handoffs"] == stats[1]["migrations_in"] == 8
    assert stats[0]["prefix_hit_tokens"] >= 32 and stats[0]["prefill_chunks"] > 8
    assert stats[0]["decode_steps"] == 0 and stats[1]["prefill_chunks"] == 0


@pytest.mark.parametrize("pools", [("model", "int8"), ("int8", "model")])
def test_mixed_pools_decode_to_the_budget(weights, pools):
    """model -> int8 (quantized on import) and int8 -> model (dequantized):
    not token for token either monolith by construction, but the pair
    negotiates, decodes the whole budget and ends "length"."""
    pair = Pair(weights[1], POOLS[pools[0]], POOLS[pools[1]])
    try:
        for p in PROMPTS:
            assert len(generate(pair.pre, p)) == 6
        assert pair.decs[0].stats["migrations_in"] == 3
    finally:
        pair.close()


def test_import_is_bit_for_bit_jax(weights):
    """The pool's three imports of the same pages: quantize (f32 pages into
    an int8 pool) equals JAX's quantize_kv, dequantize (int8 pages and
    scales into an f32 pool) JAX's dequantize_kv, none (bf16 pages into an
    f32 pool) a plain cast; other pages stay untouched."""
    rng = np.random.default_rng(3)
    shape = (T_CFG.n_layers, 3, 16, T_CFG.n_kv_heads, T_CFG.head_size)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x[0, 0, 0, 0] = 0.0  # an all-zero vector: scale 1
    owned = [2, 5, 7]
    eng = Engine(T_CFG, weights[1], ec(role="decode", kv_cache_dtype="int8"), device="cpu")
    before = {n: t.clone() for n, t in eng.cache.items()}
    eng._import_pages("quantize", owned, {"k": torch.from_numpy(x), "v": torch.from_numpy(-x)})
    for name, src in (("k", x), ("v", -x)):
        q, s = j_quantize_kv(jnp.asarray(src))
        assert np.array_equal(eng.cache[name][:, owned].numpy(), np.asarray(q))
        assert np.array_equal(eng.cache[f"{name}_scale"][:, owned].numpy(), np.asarray(s))
        rest = [i for i in range(eng.cache[name].shape[1]) if i not in owned]
        assert torch.equal(eng.cache[name][:, rest], before[name][:, rest])
    q8 = rng.integers(-127, 128, shape).astype(np.int8)
    sc = rng.random(shape[:-1] + (1,), np.float32)
    eng = Engine(T_CFG, weights[1], ec(role="decode"), device="cpu")
    eng._import_pages("dequantize", owned, {"k": torch.from_numpy(q8), "v": torch.from_numpy(q8),
                                            "k_scale": torch.from_numpy(sc), "v_scale": torch.from_numpy(sc)})
    want = np.asarray(j_dequantize_kv(jnp.asarray(q8), jnp.asarray(sc), jnp.float32))
    assert np.array_equal(eng.cache["k"][:, owned].numpy(), want)
    bf = torch.from_numpy(x).to(torch.bfloat16)
    eng._import_pages("none", owned, {"k": bf, "v": bf})
    assert torch.equal(eng.cache["v"][:, owned], bf.float())


def test_structural_mismatch_ends_the_request_with_error(weights):
    """A prefill tier whose page size disagrees is rejected at the hello:
    the request ends "error" promptly, never hangs. A migration of more
    pages than the decode tier's slots hold (its max_seq_len shorter) ends
    its request with "error" and the decode engine serves on."""
    dec = Engine(T_CFG, weights[1], ec(role="decode"), device="cpu")
    dec.start()
    srv = disagg.HandoffServer(dec, host="127.0.0.1")
    pre_ec = ec(role="prefill", page_size=8)
    mgr = disagg.HandoffManager([f"127.0.0.1:{srv.port}"], disagg.PoolSpec.from_engine_config(T_CFG, pre_ec),
                                connect_timeout=5.0, ship_timeout=5.0)
    pre = Engine(T_CFG, weights[1], pre_ec, device="cpu", handoff=mgr)
    pre.start()
    try:
        t0 = time.monotonic()
        req = pre.submit(Request([256, 1, 2], max_tokens=4, temperature=0.0))
        assert req.out.get(timeout=60) is None and req.finish_reason == "error"
        assert time.monotonic() - t0 < 10
        assert dec.stats["migrations_in"] == 0
    finally:
        pre.stop()
        mgr.close()
        dec.stop()
        srv.close()
    pair = Pair(weights[1], dec_kw={"max_seq_len": 32})
    try:
        req = pair.pre.submit(Request(list(PROMPTS[2]), max_tokens=4, temperature=0.0))  # 3 pages; a slot holds 2
        assert req.out.get(timeout=60) is None and req.finish_reason == "error"
        assert pair.decs[0].error is None and len(generate(pair.pre, PROMPTS[0], 4)) == 4
    finally:
        pair.close()


def test_truncated_stream_is_discarded_and_the_decode_engine_serves_on(weights):
    """A kv frame cut mid-payload, and a garbled header on a fresh
    connection: nothing reaches the engine, it stays alive, and a pair
    connecting afterwards is served token for token."""
    pair = Pair(weights[1])
    dec, srv = pair.decs[0], pair.srvs[0]
    try:
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
        disagg.send_frame(s, {"t": "hello", "spec": disagg.PoolSpec.from_engine(dec).to_dict()})
        assert disagg.recv_frame(s)[0]["t"] == "hello"
        hdr = json.dumps({"t": "kv", "rid": "x", "p": [1, 2], "tl": 2, "first": 3, "m": 4, "temp": 0.0, "tp": 1.0,
                          "eos": None, "ad": None, "arrays": [{"n": "k", "s": [2, 1, 16, 2, 16], "d": "float32"}]})
        s.sendall(struct.pack("<I", len(hdr)) + hdr.encode() + struct.pack("<I", 9999) + b"short")
        s.close()
        s2 = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
        s2.sendall(struct.pack("<I", 12) + b"not-json-at!")
        s2.close()
        time.sleep(0.5)
        assert dec.stats["migrations_in"] == 0 and dec.error is None
        assert generate(pair.pre, PROMPTS[0]) == monolith(Engine, EngineConfig, weights[1], PROMPTS[:1])[0]
    finally:
        pair.close()


def test_dead_decode_worker_fails_over_token_exact(weights):
    """The first decode worker dies after three streamed tokens: the
    flight is requeued (prompt + streamed tokens) and the survivor
    finishes it; the client's whole stream equals both monoliths'."""
    prompt = [256, 5, 6, 7]
    want = monolith(JEngine, JEngineConfig, weights[0], [prompt], max_tokens=12)[0]
    assert monolith(Engine, EngineConfig, weights[1], [prompt], max_tokens=12)[0] == want
    requeued = METRICS.get("substratus_serve_kv_transfers_total", 'outcome="requeued"') or 0
    # A 50 ms step floor on the decode tiers: the worker is still decoding when it is killed.
    pair = Pair(weights[1], n_decode=2, dec_kw={"step_floor_s": 0.05})
    try:
        req = pair.pre.submit(Request(list(prompt), max_tokens=12, temperature=0.0))
        out = []
        while (tok := req.out.get(timeout=120)) is not None:
            out.append(tok)
            if len(out) == 3:
                pair.srvs[0].close()
                pair.decs[0].stop()
        assert out == want and req.finish_reason == "length"
        assert pair.decs[1].stats["migrations_in"] >= 1
        assert METRICS.get("substratus_serve_kv_transfers_total", 'outcome="requeued"') == requeued + 1
        assert "requeue" in [e[1] for e in req.journey.snapshot()["events"]]
    finally:
        pair.close()


def test_no_decode_worker_left_ends_with_error(weights):
    """The only decode worker dies mid-stream: the requeued request finds
    no worker and ends with "error" within the ship timeout."""
    pair = Pair(weights[1], dec_kw={"step_floor_s": 0.05}, manager_kw={"connect_timeout": 2.0, "ship_timeout": 5.0})
    try:
        req = pair.pre.submit(Request([256, 5, 6, 7], max_tokens=24, temperature=0.0))
        assert req.out.get(timeout=120) is not None
        pair.srvs[0].close()
        pair.decs[0].stop()
        t0 = time.monotonic()
        while req.out.get(timeout=30) is not None:
            pass
        assert req.finish_reason == "error"
        assert time.monotonic() - t0 < pair.mgr.ship_timeout
    finally:
        pair.close()


def test_role_checks_raise_jax_messages(weights):
    """Each refusal of the JAX engine, with its message: an invalid role, a
    role off the paged pool, a prefill engine without a manager, submit()
    and a pull source on a decode engine, a migration into another role."""
    class Manager:
        def bind_engine(self, engine):
            pass

    def message(fn):
        try:
            fn()
        except (ValueError, RuntimeError) as e:
            return type(e), str(e)
        raise AssertionError("no refusal")

    j, t = weights
    for kw, handoff in (({"role": "wat"}, None), ({"role": "prefill", "kv_layout": "dense"}, Manager()),
                        ({"role": "decode", "kv_layout": "dense"}, None), ({"role": "prefill"}, None)):
        assert message(lambda: Engine(T_CFG, t, ec(**kw), device="cpu", handoff=handoff)) == message(
            lambda: JEngine(J_CFG, j, ec(JEngineConfig, **kw), handoff=handoff))
    tdec, jdec = Engine(T_CFG, t, ec(role="decode"), device="cpu"), JEngine(J_CFG, j, ec(JEngineConfig, role="decode"))
    assert message(lambda: tdec.submit(Request([1, 2]))) == message(lambda: jdec.submit(JRequest([1, 2])))
    source = SimpleNamespace(pull=lambda: None, pending=lambda: False)
    assert message(lambda: tdec.set_source(source)) == message(lambda: jdec.set_source(source))
    tboth, jboth = Engine(T_CFG, t, ec(), device="cpu"), JEngine(J_CFG, j, ec(JEngineConfig))
    mig = SimpleNamespace(req=Request([1]))
    assert message(lambda: tboth.submit_migration(mig)) == message(lambda: jboth.submit_migration(mig))


def test_overlap_and_load_snapshot_as_in_jax(weights):
    """overlap resolves off on a prefill engine and on (unless asked off)
    on a decode one, as the JAX engine resolves it; load_snapshot carries
    the role and the transfer queue's depth (a prefill engine's manager's,
    a decode engine's waiting migrations) under JAX's keys."""
    class Manager:
        def bind_engine(self, engine):
            pass

        def depth(self):
            return 3

    j, t = weights
    for role in ("both", "prefill", "decode"):
        for overlap in (None, True, False):
            kw = {"role": role, "overlap": overlap}
            tm = Engine(T_CFG, t, ec(**kw), device="cpu", handoff=Manager())
            jm = JEngine(J_CFG, j, ec(JEngineConfig, **kw), handoff=Manager())
            assert tm.overlap == jm.overlap == (overlap is not False and role != "prefill")
            ts, js = tm.load_snapshot(), jm.load_snapshot()
            assert (ts["role"], ts["transfer_queue_depth"]) == (js["role"], js["transfer_queue_depth"]) == (
                role, 3 if role == "prefill" else 0)
            assert set(js) - set(ts) <= {"sequence_parallel"}, set(js) ^ set(ts)
    dec = Engine(T_CFG, t, ec(role="decode"), device="cpu")
    req = Request([1, 2], max_tokens=2)
    dec.submit_migration(disagg.Migration(req=req, pages={}, true_len=2, first_token=3, convert="none"))
    assert dec.load_snapshot()["transfer_queue_depth"] == 1


def test_resubmit_passes_max_queue_and_records_the_requeue(weights):
    """A requeued request boards past the max_queue bound that sheds a new
    one, and its journey records "requeue", as in the JAX engine."""
    j, t = weights
    for eng, cls in ((Engine(T_CFG, t, ec(max_queue=1), device="cpu"), Request),
                     (JEngine(J_CFG, j, ec(JEngineConfig, max_queue=1)), JRequest)):
        first = eng.submit(cls([1, 2], max_tokens=2))
        with pytest.raises(Exception) as shed:
            eng.submit(cls([3], max_tokens=2))
        assert type(shed.value).__name__ == EngineOverloaded.__name__
        eng.resubmit(first)
        assert eng.queue.qsize() == 2
        assert [e[1] for e in first.journey.snapshot()["events"]] == ["submit", "requeue"]


def test_adapter_tenant_through_the_handoff(weights):
    """One adapter tenant (both tiers hold the same store): its request
    through the handoff equals a store engine's monolithic tokens; the pin
    is taken on the prefill tier for its prefill, released at the
    handoff, and taken again on the decode tier."""
    rng = np.random.default_rng(1)
    shapes = adapters._target_shapes(T_CFG, ("wq", "wv"))
    lora = {name: {"a": (rng.standard_normal((T_CFG.n_layers, ind, 4)) / 4).astype(np.float32),
                   "b": (rng.standard_normal((T_CFG.n_layers, 4) + out) * 0.2).astype(np.float32)}
            for name, (ind, out) in shapes.items()}

    def store():
        s = adapters.AdapterStore(T_CFG, capacity=2, rank=4, targets=("wq", "wv"), device="cpu")
        s.install("t1", lora, 2.0)
        return s

    mono = Engine(T_CFG, weights[1], ec(), device="cpu", adapters=store())
    mono.start()
    try:
        want = [generate(mono, p, adapter="t1") for p in PROMPTS]
        base = generate(mono, PROMPTS[2])
    finally:
        mono.stop()
    assert base != want[2]  # the adapter changes the tokens
    pair = Pair(weights[1], store=store)
    try:
        got = [generate(pair.pre, p, adapter="t1") for p in PROMPTS]
        assert pair.decs[0].stats["adapter_requests"] == 3 and pair.pre.stats["adapter_requests"] == 3
    finally:
        pair.close()
    assert got == want
