"""The port's disaggregation protocol (substratus_tpu_torch/serve/disagg.py)
against the JAX module (substratus_tpu/serve/disagg.py), on the CPU.

PoolSpecs, their dicts and convert modes, and the mismatch messages equal
JAX's; a frame's bytes on a socket equal JAX's for the same header and
payload, small and large; the page manifests and payloads equal JAX's for
float32, int8 with scales and bfloat16 (the port's torch tensors against
JAX's ml_dtypes arrays), and each side decodes the other's; truncated,
oversize and garbled frames raise what JAX raises. Then the wire both ways
over real TCP on loopback: a JAX prefill Engine + HandoffManager into the
port's decode Engine + HandoffServer, and the port's prefill tier into
JAX's decode server, each in the model dtype and int8 pools, greedy tokens
identical to the JAX monolithic engine's. A handoff past the receiver's
frame limit fails before it is sent.

Tiny float32 llama weights from a seed, carried across by
bridge.params_from_jax. Every socket is on loopback with an ephemeral port,
and every blocking read has its own timeout.
"""
import json
import socket
import struct
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from substratus_tpu.models import llama as jllama
from substratus_tpu.serve import disagg as jdisagg
from substratus_tpu.serve.engine import Engine as JEngine
from substratus_tpu.serve.engine import EngineConfig as JEngineConfig
from substratus_tpu.serve.engine import Request as JRequest
from substratus_tpu_torch.bridge import params_from_jax
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.serve import disagg
from substratus_tpu_torch.serve.engine import Engine, EngineConfig, Request

EOS = 257
J_CFG = jllama.CONFIGS["tiny"].replace(vocab_size=258, dtype=jnp.float32)
T_CFG = llama.CONFIGS["tiny"].replace(vocab_size=258, dtype=torch.float32)
PROMPTS = [[256, 5, 6, 7], [256, 70, 71], list(range(1, 40))]  # the last: three pages, chunks of 16
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


def ec(cls, **kw):
    kw = {"max_batch": 4, "max_seq_len": 64, "max_prefill_len": 16, "eos_token_id": EOS, "kv_layout": "paged", **kw}
    return cls(**kw)


def generate(engine, prompt, max_tokens=6):
    """Greedy tokens of one request through a started engine (either
    package's generate), with a read timeout."""
    cls = Request if isinstance(engine, Engine) else JRequest
    req = engine.submit(cls(list(prompt), max_tokens=max_tokens, temperature=0.0))
    out = []
    while (tok := req.out.get(timeout=120)) is not None:
        out.append(tok)
    assert req.finish_reason == "length", req.finish_reason  # EOS is never sampled here
    return out


@pytest.fixture(scope="module")
def jax_reference(weights):
    """The JAX monolithic engine's greedy tokens for PROMPTS, per pool."""
    out = {}
    for pool, kw in POOLS.items():
        eng = JEngine(J_CFG, weights[0], ec(JEngineConfig, **kw))
        eng.start()
        try:
            out[pool] = [generate(eng, p) for p in PROMPTS]
        finally:
            eng.stop()
    return out


def _pages(dtype: str, seed: int = 0):
    """(JAX's numpy pages, the port's tensors) of the same values: k and v
    [L, n, bs, KH, hd], with f32 scales [..., 1] for int8."""
    rng = np.random.default_rng(seed)
    shape = (2, 3, 16, 2, 8)
    if dtype == "int8":
        j = {n: rng.integers(-127, 128, shape).astype(np.int8) for n in ("k", "v")}
        j.update({f"{n}_scale": rng.random(shape[:-1] + (1,), np.float32) for n in ("k", "v")})
        return j, {n: torch.from_numpy(a.copy()) for n, a in j.items()}
    x = {n: rng.standard_normal(shape).astype(np.float32) for n in ("k", "v")}
    if dtype == "bfloat16":
        return ({n: a.astype(ml_dtypes.bfloat16) for n, a in x.items()},
                {n: torch.from_numpy(a).to(torch.bfloat16) for n, a in x.items()})
    return x, {n: torch.from_numpy(a.copy()) for n, a in x.items()}


# --- the pool contract --------------------------------------------------------


def test_pool_specs_and_convert_modes_match_jax(weights):
    """from_engine_config for model-dtype (f32, bf16) and int8 pools, the
    dict form both ways, every convert mode and each structural mismatch's
    message, as JAX's; from_engine on built engines too."""
    for kw in ({}, {"kv_cache_dtype": "int8"}, {"page_size": 8}):
        mine = disagg.PoolSpec.from_engine_config(T_CFG, ec(EngineConfig, **kw))
        theirs = jdisagg.PoolSpec.from_engine_config(J_CFG, ec(JEngineConfig, **kw))
        assert mine.to_dict() == theirs.to_dict()
        assert disagg.PoolSpec.from_dict(theirs.to_dict()) == mine
    bf = disagg.PoolSpec.from_engine_config(T_CFG.replace(dtype=torch.bfloat16), ec(EngineConfig))
    assert bf.to_dict() == jdisagg.PoolSpec.from_engine_config(J_CFG.replace(dtype=jnp.bfloat16),
                                                               ec(JEngineConfig)).to_dict()
    assert bf.dtype == "bfloat16"
    for kw in ({}, {"kv_cache_dtype": "int8"}):
        teng = Engine(T_CFG, weights[1], ec(EngineConfig, **kw), device="cpu")
        jeng = JEngine(J_CFG, weights[0], ec(JEngineConfig, **kw))
        assert disagg.PoolSpec.from_engine(teng).to_dict() == jdisagg.PoolSpec.from_engine(jeng).to_dict()
    base = dict(n_layers=2, page_size=16, kv_heads=2, head_dim=8)
    specs = [(dtype, q, {**base, **change}) for dtype, q in (("float32", False), ("int8", True))
             for change in ({}, {"page_size": 8}, {"n_layers": 3}, {"kv_heads": 4}, {"head_dim": 16})]
    for a_dtype, a_q, a in specs:
        for b_dtype, b_q, b in specs:
            mine, theirs = (disagg.PoolSpec(dtype=a_dtype, quantized=a_q, **a),
                            jdisagg.PoolSpec(dtype=a_dtype, quantized=a_q, **a))
            msrc, jsrc = (disagg.PoolSpec(dtype=b_dtype, quantized=b_q, **b),
                          jdisagg.PoolSpec(dtype=b_dtype, quantized=b_q, **b))
            try:
                want = theirs.convert_mode(jsrc)
            except jdisagg.NegotiationError as e:
                with pytest.raises(disagg.NegotiationError) as got:
                    mine.convert_mode(msrc)
                assert str(got.value) == str(e)
                continue
            assert mine.convert_mode(msrc) == want
    assert {disagg.PoolSpec(dtype="int8", quantized=True, **base).convert_mode(
        disagg.PoolSpec(dtype="float32", quantized=False, **base))} == {"quantize"}
    with pytest.raises(ValueError, match="paged"):
        disagg.PoolSpec.from_engine(Engine(T_CFG, weights[1], ec(EngineConfig, kv_layout="dense"), device="cpu"))


# --- framing ------------------------------------------------------------------


def _exchange(send, header, payload, read):
    """Run one send_frame call on one end of a socket pair (its own
    thread: a large frame outgrows the socket's buffer) and `read` on the
    other; returns what `read` returned."""
    a, b = socket.socketpair()
    a.settimeout(10)
    b.settimeout(10)

    def write():
        send(a, header, payload)
        a.shutdown(socket.SHUT_WR)

    writer = threading.Thread(target=write)
    writer.start()
    try:
        return read(b)
    finally:
        writer.join(timeout=10)
        assert not writer.is_alive()
        a.close()
        b.close()


def _all_bytes(sock) -> bytes:
    chunks = []
    while chunk := sock.recv(1 << 20):
        chunks.append(chunk)
    return b"".join(chunks)


@pytest.mark.parametrize("size", [0, 1000, 300_000])
def test_frame_bytes_equal_jax(size):
    """The same header and payload give the same bytes on the wire (a
    payload past 64 KiB goes out of its own buffer), and each side's
    recv_frame reads the other's frame."""
    header = {"t": "kv", "rid": "r1", "p": [1, 2, 3], "tl": 3, "first": 9, "m": 4, "temp": 0.0, "tp": 1.0,
              "eos": None, "ad": None, "tpar": None, "arrays": []}
    payload = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8).tobytes()
    mine = _exchange(disagg.send_frame, header, payload, _all_bytes)
    assert mine == _exchange(jdisagg.send_frame, header, payload, _all_bytes)
    assert len(mine) == 8 + len(json.dumps(header, separators=(",", ":"))) + size
    for recv, send in ((disagg.recv_frame, jdisagg.send_frame), (jdisagg.recv_frame, disagg.send_frame)):
        got_header, got_payload = _exchange(send, header, payload, recv)
        assert got_header == header and bytes(got_payload) == payload


@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
def test_encode_pages_equal_jax(dtype):
    """Manifests and payloads equal JAX's (bf16: JAX's ml_dtypes arrays
    against the port's torch tensors, raw 2-byte words under the name
    "bfloat16"), and each side decodes the other's bytes to the same
    values, into writable tensors."""
    j_pages, t_pages = _pages(dtype)
    jm, jp = jdisagg.encode_pages(j_pages)
    tm, tp = disagg.encode_pages(t_pages)
    assert tm == jm and tp == jp
    assert [m["d"] for m in tm] == [dtype] * len(tm) if dtype != "int8" else [m["d"] for m in tm] == [
        "int8", "float32", "int8", "float32"]
    back = disagg.decode_pages(jm, bytearray(jp))
    assert sorted(back) == sorted(t_pages)
    for name, t in back.items():
        assert t.dtype == t_pages[name].dtype and torch.equal(t, t_pages[name])
        t.add_(0)  # writable
    jback = jdisagg.decode_pages(tm, tp)
    for name, a in jback.items():
        assert a.dtype == j_pages[name].dtype and np.array_equal(a.view(np.uint8), j_pages[name].view(np.uint8))


def test_truncated_garbled_and_oversize_frames_raise_as_jax():
    """EOF mid-frame is a ConnectionError; a zero or oversize header
    length, an oversize payload length, a payload shorter or longer than
    its manifest and an unknown dtype are ValueErrors, in both packages;
    so is, in the port, a manifest's huge or negative shape."""
    hdr = json.dumps({"t": "kv"}).encode()
    streams = {
        "truncated payload": (struct.pack("<I", len(hdr)) + hdr + struct.pack("<I", 9999) + b"short", ConnectionError),
        "truncated header": (struct.pack("<I", 50) + b"{", ConnectionError),
        "empty": (b"", ConnectionError),
        "zero header": (struct.pack("<I", 0), ValueError),
        "oversize header": (struct.pack("<I", 1 << 31), ValueError),
        "oversize payload": (struct.pack("<I", len(hdr)) + hdr + struct.pack("<I", 1 << 31), ValueError),
        "garbled header": (struct.pack("<I", 12) + b"not-json-at!", ValueError),
    }
    for name, (data, exc) in streams.items():
        for recv in (disagg.recv_frame, jdisagg.recv_frame):
            a, b = socket.socketpair()
            try:
                b.settimeout(10)
                a.sendall(data)
                a.shutdown(socket.SHUT_WR)
                with pytest.raises(exc):
                    recv(b)
            finally:
                a.close()
                b.close()
    manifest = [{"n": "k", "s": [2, 3], "d": "float32"}]
    for payload in (b"\0" * 20, b"\0" * 28):
        for decode in (disagg.decode_pages, jdisagg.decode_pages):
            with pytest.raises(ValueError, match="payload (shorter|longer)"):
                decode(manifest, payload)
    with pytest.raises(ValueError):
        disagg.decode_pages([{"n": "k", "s": [2], "d": "complex64"}], b"\0" * 16)
    # A manifest from a peer is outside input: a huge or negative shape is refused before anything is allocated.
    for shape in ([1 << 40], [-4, 1]):
        with pytest.raises(ValueError):
            disagg.decode_pages([{"n": "k", "s": shape, "d": "float32"}], b"\0" * 16)


# --- the wire both ways, engines over real TCP ----------------------------------


@pytest.mark.parametrize("pool", list(POOLS))
def test_jax_prefill_into_port_decode(weights, jax_reference, pool):
    """A JAX prefill Engine and HandoffManager ship into the port's decode
    Engine and HandoffServer: greedy tokens equal to the JAX monolithic
    engine's, including a prompt of three chunks and a prefix hit on the
    JAX side (the long prompt again: its two full pages from the registry)."""
    kw = POOLS[pool]
    dec = Engine(T_CFG, weights[1], ec(EngineConfig, role="decode", **kw), device="cpu")
    dec.start()
    srv = disagg.HandoffServer(dec, host="127.0.0.1")
    pre_ec = ec(JEngineConfig, role="prefill", **kw)
    mgr = jdisagg.HandoffManager([f"127.0.0.1:{srv.port}"], jdisagg.PoolSpec.from_engine_config(J_CFG, pre_ec),
                                 connect_timeout=5.0, ship_timeout=10.0, io_timeout=60.0)
    pre = JEngine(J_CFG, weights[0], pre_ec, handoff=mgr)
    pre.start()
    try:
        got = [generate(pre, p) for p in PROMPTS]
        again = generate(pre, PROMPTS[2])
        assert pre.stats["handoffs"] == 4 and dec.stats["migrations_in"] == 4
        assert pre.stats["prefix_hit_tokens"] > 0
    finally:
        pre.stop()
        mgr.close()
        dec.stop()
        srv.close()
    assert got == jax_reference[pool]
    assert again == jax_reference[pool][2]


@pytest.mark.parametrize("pool", list(POOLS))
def test_port_prefill_into_jax_decode(weights, jax_reference, pool):
    """The port's prefill Engine and HandoffManager ship into JAX's decode
    Engine and HandoffServer: greedy tokens equal to the JAX monolithic
    engine's; the port's pool spec negotiates with JAX's."""
    kw = POOLS[pool]
    dec = JEngine(J_CFG, weights[0], ec(JEngineConfig, role="decode", **kw))
    dec.start()
    srv = jdisagg.HandoffServer(dec, host="127.0.0.1")
    pre_ec = ec(EngineConfig, role="prefill", **kw)
    mgr = disagg.HandoffManager([f"127.0.0.1:{srv.port}"], disagg.PoolSpec.from_engine_config(T_CFG, pre_ec),
                                connect_timeout=5.0, ship_timeout=10.0, io_timeout=60.0)
    pre = Engine(T_CFG, weights[1], pre_ec, device="cpu", handoff=mgr)
    pre.start()
    try:
        got = [generate(pre, p) for p in PROMPTS]
        again = generate(pre, PROMPTS[2])
        assert pre.stats["handoffs"] == 4 and dec.stats["migrations_in"] == 4
        assert pre.stats["prefix_hit_tokens"] > 0
    finally:
        pre.stop()
        mgr.close()
        dec.stop()
        srv.close()
    assert got == jax_reference[pool]
    assert again == jax_reference[pool][2]


def test_handoff_past_the_frame_limit_fails_before_sending(weights, monkeypatch):
    """A payload the receiver would refuse (MAX_FRAME) ends the request
    with an error at once and reaches no decode engine; the next request,
    under the limit, is served."""
    dec = Engine(T_CFG, weights[1], ec(EngineConfig, role="decode"), device="cpu")
    dec.start()
    srv = disagg.HandoffServer(dec, host="127.0.0.1")
    pre_ec = ec(EngineConfig, role="prefill")
    mgr = disagg.HandoffManager([f"127.0.0.1:{srv.port}"], disagg.PoolSpec.from_engine_config(T_CFG, pre_ec),
                                connect_timeout=5.0, ship_timeout=10.0, io_timeout=60.0)
    pre = Engine(T_CFG, weights[1], pre_ec, device="cpu", handoff=mgr)
    pre.start()
    try:
        # A page of the tiny f32 pool is 8 KiB (2 layers x 16 rows x 2 heads x 16 x 4 bytes, k and v): the
        # 39-token prompt ships 3 pages, the 3-token one 1.
        monkeypatch.setattr(disagg, "MAX_FRAME", 10_000)
        req = pre.submit(Request(list(PROMPTS[2]), max_tokens=4, temperature=0.0))
        assert req.out.get(timeout=60) is None and req.finish_reason == "error"
        assert dec.stats["migrations_in"] == 0
        assert len(generate(pre, PROMPTS[1], 4)) == 4
        assert dec.stats["migrations_in"] == 1
    finally:
        pre.stop()
        mgr.close()
        dec.stop()
        srv.close()
