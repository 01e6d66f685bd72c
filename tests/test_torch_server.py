"""The port's standard-library OpenAI server (substratus_tpu_torch/serve/
server.py, serve/main.py) on the CPU with the tiny config: readiness, the
non-streamed body with usage, SSE chunks ending in [DONE], int4 and int8
weights, and the params.json policy of serve.main."""
import json
import urllib.error
import urllib.request

import pytest
import torch

from substratus_tpu_torch.ops.quant import QTensor
from substratus_tpu_torch.ops.quant4 import Q4Tensor
from substratus_tpu_torch.serve import main


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread keeps torch's worker
    pool from spinning on cores that timing-sensitive tests share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    params = tmp_path_factory.mktemp("params") / "params.json"
    params.write_text(json.dumps({"config": "tiny", "max_batch": 4, "max_seq_len": 64,
                                  "max_prefill_len": 32, "kv_cache_dtype": "int8"}))
    srv = main.build(["--device", "cpu", "--host", "127.0.0.1", "--port", "0", "--params", str(params)]).start()
    yield srv
    srv.stop()


def _post(srv, body):
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/v1/completions",
                                 data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=120)


def test_readiness(server):
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/", timeout=30) as r:
        assert r.status == 200 and r.read() == b"ok"
    assert server.state.engine.cache["k"].dtype.is_floating_point is False  # int8 from params.json


def test_completion_body_counts_generated_tokens(server):
    with _post(server, {"prompt": "hello", "max_tokens": 7, "temperature": 0}) as r:
        body = json.loads(r.read())
    assert body["object"] == "text_completion" and body["model"] == "tiny"
    usage = body["usage"]
    assert usage["prompt_tokens"] == 6  # BOS + 5 bytes
    engine = server.state.engine
    want = engine.generate(engine.clipped_prompt([256] + list(b"hello")), max_tokens=7, temperature=0.0)
    assert usage["completion_tokens"] == len(want)
    assert usage["total_tokens"] == 6 + len(want)
    choice = body["choices"][0]
    assert choice["text"] == server.state.tokenizer.decode(want)
    assert choice["finish_reason"] == ("length" if len(want) == 7 else "stop")


def test_streamed_sse_ends_with_done(server):
    with _post(server, {"prompt": "stream me", "max_tokens": 5, "temperature": 0.7, "top_p": 0.9,
                        "stream": True, "stream_options": {"include_usage": True}}) as r:
        assert r.headers["Content-Type"] == "text/event-stream"
        lines = [ln.decode().strip() for ln in r if ln.strip()]
    assert all(ln.startswith("data: ") for ln in lines) and lines[-1] == "data: [DONE]"
    chunks = [json.loads(ln[6:]) for ln in lines[:-1]]
    usage = chunks[-1]["usage"]
    text_chunks = [c for c in chunks if c["choices"]]
    assert len(text_chunks) == usage["completion_tokens"] + 1  # one per token, then the finish
    assert text_chunks[-1]["choices"][0]["finish_reason"] in ("length", "stop")
    assert all(c["object"] == "text_completion" for c in chunks)


@pytest.mark.parametrize("body,status", [
    ({"max_tokens": 3}, 400),  # no prompt
    ({"prompt": "x", "max_tokens": 0}, 400),
    ({"prompt": "x", "top_p": 1.5}, 400),
    ({"prompt": "x", "temperature": -1}, 400),
])
def test_bad_requests(server, body, status):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, body)
    assert e.value.code == status


def test_long_prompt_is_served_in_chunks(server):
    """41 tokens at max_prefill_len=32: two chunks, then decode."""
    engine = server.state.engine
    chunks = engine.stats["prefill_chunks"]
    with _post(server, {"prompt": "x" * 40, "max_tokens": 4, "temperature": 0}) as r:
        assert r.status == 200
        body = json.loads(r.read())
    assert body["usage"]["prompt_tokens"] == 41 and 1 <= body["usage"]["completion_tokens"] <= 4
    assert engine.stats["prefill_chunks"] == chunks + 2


@pytest.mark.parametrize("quantize,kind", [("int4", Q4Tensor), ("int8", QTensor)])
def test_quantized_weights_are_served(tmp_path, quantize, kind):
    """quantize: int4 / int8 quantize the random weights at startup (the
    projections and the lm_head; tok_embed and the norms stay dense) and
    the server answers with the engine's own greedy tokens."""
    params = tmp_path / "params.json"
    params.write_text(json.dumps({"config": "tiny", "max_batch": 2, "max_seq_len": 64, "quantize": quantize,
                                  "q4_impl": "pallas", "decode_attn_impl": "fused", "attn_impl": "plain"}))
    srv = main.build(["--device", "cpu", "--host", "127.0.0.1", "--port", "0", "--params", str(params)]).start()
    try:
        assert srv.state.engine.cfg.attn_impl == "plain"
        model = srv.state.engine.params
        assert isinstance(model.layers[1].wo, kind) and isinstance(model.lm_head, kind)
        assert isinstance(model.tok_embed, torch.nn.Parameter) and isinstance(model.layers[0].mlp_norm,
                                                                               torch.nn.Parameter)
        with _post(srv, {"prompt": "quant", "max_tokens": 6, "temperature": 0}) as r:
            body = json.loads(r.read())
        want = srv.state.engine.generate([256] + list(b"quant"), max_tokens=6, temperature=0.0)
        assert body["choices"][0]["text"] == srv.state.tokenizer.decode(want)
        assert body["usage"]["completion_tokens"] == len(want) >= 1
    finally:
        srv.stop()


def test_overlap_is_served(server, tmp_path):
    """params.json overlap: absent gives the overlapped scheduler (the
    module's server), false the synchronous one, which answers the same
    greedy tokens; a value that is not a boolean exits."""
    assert server.state.engine.overlap is True and main.resolve_overlap({}) is None
    params = tmp_path / "params.json"
    params.write_text(json.dumps({"config": "tiny", "max_batch": 4, "max_seq_len": 64, "max_prefill_len": 32,
                                  "kv_cache_dtype": "int8", "overlap": False}))
    srv = main.build(["--device", "cpu", "--host", "127.0.0.1", "--port", "0", "--params", str(params)]).start()
    try:
        assert srv.state.engine.overlap is False and srv.state.engine.ec.overlap is False
        with _post(srv, {"prompt": "sync", "max_tokens": 6, "temperature": 0}) as r:
            sync_text = json.loads(r.read())["choices"][0]["text"]
    finally:
        srv.stop()
    with _post(server, {"prompt": "sync", "max_tokens": 6, "temperature": 0}) as r:
        assert json.loads(r.read())["choices"][0]["text"] == sync_text
    main.check_params({"overlap": True})
    for value in ("false", 0, 1):
        with pytest.raises(SystemExit, match="overlap.*invalid"):
            main.check_params({"overlap": value})


def test_params_policy():
    """Served keys, and unserved knobs at the one value the port serves,
    pass; every other knob exits naming its ROADMAP queue. The attention
    knobs take the JAX names (the reference names run the kernels)."""
    main.check_params({"config": "tiny", "max_batch": 2, "kv_layout": "dense", "quantize": "none",
                       "role": "both", "spec_k": 0, "overlap": False, "decode_attn_impl": "fused",
                       "chunk_attn_impl": "flash", "attn_impl": "flash"})
    assert main.resolve_attn_impls({}) == ("kernel", "flash", "flash")
    assert main.resolve_attn_impls({"decode_attn_impl": "fused", "kv_layout": "dense"}) == ("fused", "flash", "flash")
    assert main.resolve_attn_impls({"decode_attn_impl": "pallas", "chunk_attn_impl": "xla"}) == (
        "kernel", "flash", "flash")
    # attn_impl, the single-shot prefill: the reference names run the flash kernel, plain its plain version.
    for impl, want in (("xla", "flash"), ("flash", "flash"), ("plain", "plain")):
        main.check_params({"attn_impl": impl})
        assert main.resolve_attn_impls({"attn_impl": impl})[2] == want
    for quantize in ("none", "int8", "int4", "w8a8"):  # w8a8: served (int8 weights x int8 activations)
        for q4_impl in ("pallas", "xla"):
            main.check_params({"quantize": quantize, "q4_impl": q4_impl})
    assert main.resolve_quantize({}) == "none" and main.resolve_quantize({"quantize": "int4"}) == "int4"
    assert main.resolve_quantize({"quantize": "w8a8"}) == "w8a8" and main.weight_mode("w8a8") == "int8"
    for layout in ("auto", "paged", "dense"):  # every layout is served; no key is the paged pool
        main.check_params({"kv_layout": layout})
    main.check_params({"spec_k": 4, "draft_model": "/models/draft"})  # served: speculative decoding
    main.check_params({"adapters": {"dir": "x"}, "baseModel": "m"})  # served: multi-tenant adapters
    # served: the disaggregated roles (serve/disagg.py) and the controller's key
    main.check_params({"role": "prefill", "decode_peers": ["d:8500"], "transfer_port": 8500, "disaggregated": True})
    for params in ({"tensor": 2}, {"attn_impl": "ring"}, {"attn_impl": "ulysses"}):
        with pytest.raises(SystemExit, match="ROADMAP"):
            main.check_params(params)
    for params, match in (({"decode_attn_impl": "fused", "kv_layout": "paged"}, "requires kv_layout=dense"),
                          ({"decode_attn_impl": "magic"}, "invalid"), ({"chunk_attn_impl": "plain"}, "invalid"),
                          ({"attn_impl": "splash"}, "invalid"), ({"role": "sideways"}, "invalid"),
                          ({"quantize": "int3"}, "invalid"), ({"quantize": "int4", "q4_impl": "triton"}, "invalid"),
                          ({"q4_impl": "auto"}, "invalid"), ({"spec_k": -1}, "invalid"), ({"spec_k": "3"}, "invalid")):
        with pytest.raises(SystemExit, match=match):
            main.check_params(params)
    with pytest.raises(SystemExit, match="unknown key"):
        main.check_params({"no_such_knob": 1})
