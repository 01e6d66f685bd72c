"""The port's serve/multihost.py against the JAX package's, on the CPU.

encode_events gives JAX's bytes; a JAX TcpSync leader feeds a port
TcpSync follower and the other way round; a two-process gloo StepSync
delivers payloads under, at and over INLINE with the same count of
collectives on both ranks (the overflow's second, bucket-padded
broadcast), and records its timings and the broadcast phase's histogram.
"""
import json
import os
import socket
import subprocess
import sys
import threading
from types import SimpleNamespace

from substratus_tpu.serve import multihost as jmh
from substratus_tpu_torch.serve import multihost as mh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _req(sid, prompt, **kw):
    base = dict(sync_id=sid, prompt_tokens=prompt, max_tokens=6, temperature=0.0, top_p=1.0, eos_token_id=None,
                id="", adapter=None)
    return SimpleNamespace(**{**base, **kw})


def test_encode_events_bytes_match_jax():
    """The same JSON, keys in the same order, byte for byte; decode_events
    inverts it; the helpers agree."""
    cases = [([], [], False, None), ([], [3, 1], True, None), ([_req(1, [256, 5, 6, 7])], [], False, 4),
             ([_req(2, list(range(300)), temperature=0.7, top_p=0.9, eos_token_id=257, id="cmpl-x",
                    adapter="t0"), _req(3, [])], [2], False, None)]
    for reqs, cancels, stop, swap in cases:
        got = mh.encode_events(reqs, cancels, stop, swap=swap)
        assert got == jmh.encode_events(reqs, cancels, stop, swap=swap)
        assert mh.decode_events(got) == jmh.decode_events(got) == json.loads(got)
    for n in (0, 1, 256, 257, 1020, 5000):
        assert mh._bucket_bytes(n) == jmh._bucket_bytes(n)
        assert mh.struct_pack_u32(n) == jmh.struct_pack_u32(n)
    mh.NullSink().put(1)
    mh.NullSink().put(None)


def test_tcp_sync_interoperates_with_jax():
    """A JAX TcpSync leader feeds a port follower, and a port leader a
    JAX follower: the same length-prefixed frames, the same payloads
    delivered, timings recorded on both sides, close() wakes nothing
    left."""
    payloads = [b"", b"x", mh.encode_events([_req(1, [256, 5])], [], False), b"y" * 5000]
    for leader_cls, follower_cls in ((jmh.TcpSync, mh.TcpSync), (mh.TcpSync, jmh.TcpSync)):
        port = _free_port()
        got, errors = [], []

        def follow():
            try:
                f = follower_cls(1, 2, port, timeout=30)
                got.extend(f.broadcast(None) for _ in payloads)
                assert len(f.timings) == len(payloads)
                f.close()
            except Exception as e:  # surfaced by the assertion below
                errors.append(e)

        t = threading.Thread(target=follow)
        t.start()
        leader = leader_cls(0, 2, port, timeout=30)
        sent = [leader.broadcast(p) for p in payloads]
        t.join(timeout=60)
        leader.close()
        assert not t.is_alive() and not errors, errors
        assert sent == payloads and got == payloads
        assert [n for n, _ in leader.timings] == [len(p) for p in payloads]
    single = mh.TcpSync(0, 1, _free_port())
    assert single.broadcast(b"solo") == b"solo" and not single.timings


_GLOO_RANK = r"""
import datetime, json, sys
import torch.distributed as dist
from substratus_tpu_torch.observability.metrics import METRICS
from substratus_tpu_torch.serve.multihost import StepSync
rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank,
                        timeout=datetime.timedelta(seconds=60))
sync = StepSync(group=dist.new_group(backend="gloo"))
calls = []
inner = sync._bcast
sync._bcast = lambda buf: calls.append(len(buf)) or inner(buf)
sizes = [0, 5, StepSync.INLINE - 4, StepSync.INLINE - 3, 5000]
got = [sync.broadcast(bytes([i % 251 + 1]) * n if rank == 0 else None) for i, n in enumerate(sizes)]
json.dump({"leader": sync.leader, "world": sync.num_processes, "got": [g.hex() for g in got], "calls": calls,
           "timings": [n for n, _ in sync.timings],
           "metric": 'phase="broadcast"' in METRICS.render()}, open(out, "w"))
dist.destroy_process_group()
"""


def test_step_sync_two_gloo_processes(tmp_path):
    """Two processes, gloo: payloads of 0 and 5 bytes, exactly INLINE - 4
    (one collective) and one byte more and 5000 (two: the 1024-byte
    header and a bucket of 1024 or 8192) arrive whole on the follower,
    both ranks make the same collectives, and each delivery is timed."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    outs = [tmp_path / f"r{r}.json" for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", _GLOO_RANK, str(r), str(port), str(outs[r])], env=env,
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    r0, r1 = (json.loads(o.read_text()) for o in outs)
    sizes = [0, 5, mh.StepSync.INLINE - 4, mh.StepSync.INLINE - 3, 5000]
    want = [(bytes([i % 251 + 1]) * n).hex() for i, n in enumerate(sizes)]
    assert r0["got"] == r1["got"] == want
    assert r0["leader"] and not r1["leader"] and r0["world"] == r1["world"] == 2
    assert r0["calls"] == r1["calls"] == [1024, 1024, 1024, 1024, 1024, 1024, 8192]
    assert r0["timings"] == r1["timings"] == sizes
    assert r0["metric"] and r1["metric"]
