"""The disaggregated handoff's page export and import on the card
(serve/engine.py::_export_pages, _import_pages; serve/disagg.py's pinned
decode and side-stream staging), held bit for bit against the same engine
code on the CPU, and a prefill/decode pair on the card token for token
against the monolithic engine.

Every test here needs an NVIDIA card and skips without one. The file
imports only torch and the port, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda -rP tests/test_torch_disagg_cuda.py

tinyllama-1.1b's widths at 2 layers (4 kv heads, head dim 64), pools of
bf16 and of int8 with f32 scales filled from a seed: the export of a
request's pages (the gather and the read into pinned memory) equals the
CPU engine's bytes; the imports "none" (bf16 and int8 pages), "quantize"
(bf16 pages into an int8 pool) and "dequantize" (int8 pages into a bf16
pool) leave the card's pool equal to the CPU's, bit for bit; and a pair
over loopback TCP (the decode tier's copies staged on its side stream,
its step a CUDA graph) gives the monolith's greedy tokens.
"""
import pytest
import torch

from substratus_tpu_torch.models import llama
from substratus_tpu_torch.serve import disagg
from substratus_tpu_torch.serve.engine import Engine, EngineConfig, Request

pytestmark = pytest.mark.cuda
CFG = llama.CONFIGS["tinyllama-1.1b"].replace(n_layers=2)
OWNED = [3, 9, 4, 17]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the export reads card memory into pinned memory")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def params():
    return {dev: llama.init_params(CFG, seed=0, device=dev) for dev in ("cpu", "cuda")} \
        if torch.cuda.is_available() else None


def _engines(params, cuda, pool: str, role: str = "decode"):
    """(card engine, CPU engine) of the same config, their pools filled
    with the same seeded values."""
    ec = EngineConfig(max_batch=2, max_seq_len=512, kv_layout="paged", role=role,
                      kv_cache_dtype="int8" if pool == "int8" else "model")
    out = (Engine(CFG, params["cuda"], ec, device=cuda), Engine(CFG, params["cpu"], ec, device="cpu"))
    gen = torch.Generator().manual_seed(5)
    for name, t in out[1].cache.items():
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen, dtype=torch.int8))
        else:
            t.copy_(torch.rand(t.shape, generator=gen) * 4 - 2)
        out[0].cache[name].copy_(t)
    return out


def _pages(pool: str, n: int = len(OWNED)):
    gen = torch.Generator().manual_seed(11)
    shape = (CFG.n_layers, n, 16, CFG.n_kv_heads, CFG.head_size)
    if pool == "int8":
        pages = {k: torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8) for k in ("k", "v")}
        pages.update({f"{k}_scale": torch.rand(shape[:-1] + (1,), generator=gen) for k in ("k", "v")})
        return pages
    return {k: (torch.randn(shape, generator=gen) * 3).to(torch.bfloat16) for k in ("k", "v")}


@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_export_is_the_cpu_paths_bytes(cuda, params, pool):
    card, cpu = _engines(params, cuda, pool)
    got, want = card._export_pages(OWNED), cpu._export_pages(OWNED)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].device.type == "cpu" and got[name].is_pinned()
        assert got[name].dtype == want[name].dtype and torch.equal(got[name], want[name])
    print(f"{pool}: {sum(t.numel() * t.element_size() for t in got.values())} bytes of {len(OWNED)} pages equal")


@pytest.mark.parametrize("convert,pool,pages", [("none", "bf16", "bf16"), ("none", "int8", "int8"),
                                                ("quantize", "int8", "bf16"), ("dequantize", "bf16", "int8")])
def test_import_is_the_cpu_paths_bytes(cuda, params, convert, pool, pages):
    card, cpu = _engines(params, cuda, pool)
    host = _pages(pages)
    # The card's pages as the HandoffServer stages them: decoded into
    # pinned memory and copied on its side stream.
    manifest, payload = disagg.encode_pages(host)
    staged = disagg.stage_pages(disagg.decode_pages(manifest, payload, pin=True), card.device,
                                torch.cuda.Stream(card.device))
    assert all(t.device.type == "cuda" for t in staged.values())
    card._import_pages(convert, OWNED, staged)
    cpu._import_pages(convert, OWNED, host)
    torch.cuda.synchronize()
    for name, t in cpu.cache.items():
        assert torch.equal(card.cache[name].cpu(), t), name


def test_pair_on_the_card_is_the_monolith_token_for_token(cuda, params):
    ec = dict(max_batch=4, max_seq_len=512, max_prefill_len=64, kv_layout="paged", eos_token_id=CFG.vocab_size)
    prompts = [[1] + list(range(100, 100 + n)) for n in (5, 70, 150)]
    mono = Engine(CFG, params["cuda"], EngineConfig(**ec), device=cuda)
    mono.start()
    try:
        want = [mono.generate(p, max_tokens=16) for p in prompts]
    finally:
        mono.stop()
    dec = Engine(CFG, params["cuda"], EngineConfig(role="decode", **ec), device=cuda)
    dec.start()
    srv = disagg.HandoffServer(dec, host="127.0.0.1")
    pre_ec = EngineConfig(role="prefill", **ec)
    mgr = disagg.HandoffManager([f"127.0.0.1:{srv.port}"], disagg.PoolSpec.from_engine_config(CFG, pre_ec),
                                connect_timeout=5.0, ship_timeout=30.0, io_timeout=60.0)
    pre = Engine(CFG, params["cuda"], pre_ec, device=cuda, handoff=mgr)
    pre.start()
    try:
        reqs = [pre.submit(Request(list(p), max_tokens=16, temperature=0.0)) for p in prompts]
        got = []
        for req in reqs:
            toks = []
            while (tok := req.out.get(timeout=120)) is not None:
                toks.append(tok)
            got.append(toks)
        assert dec.stats["migrations_in"] == 3 and dec.stats["graph_replays"] > 0 and dec.overlap
    finally:
        pre.stop()
        mgr.close()
        dec.stop()
        srv.close()
    assert got == want
    print(f"pair on the card: {[len(g) for g in got]} tokens, the monolith's; decode tier "
          f"{dec.stats['graph_replays']} replays")
