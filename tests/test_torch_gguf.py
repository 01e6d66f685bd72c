"""The port's GGUF import (substratus_tpu_torch/load/gguf.py) against the
JAX package's (substratus_tpu/load/gguf.py), on files written as
tests/test_gguf.py writes them and by the port's own writer
(substratus_tpu_torch/tools/ckpt_writer.py).

* read_gguf equals the JAX read_gguf bit for bit for every supported type
  (F32, F16, Q4_0, Q4_1, Q5_0, Q8_0), arrays and dtypes;
* load_gguf's state equals bridge.params_from_jax of the JAX load_gguf
  exactly (float32, and bf16 through f32), tied and untied, with the q/k
  rope un-permutation; the writer's files read the same through the JAX
  reader, and load to what the writer says a loader must produce;
* garbage, K-quant, rope-scaling and non-llama files are refused with the
  JAX messages; resolve_gguf agrees with the JAX one in its strict,
  non-strict and sidecar cases;
* GGUFTokenizer's ids and decodes equal the JAX class's pure-Python merge
  (SUBSTRATUS_SPM_NATIVE=0), a 24k-character prompt in under 2 s;
* the port's Engine on a loaded Q4_0/Q8_0 file gives the JAX Engine's
  greedy tokens on the same file.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_gguf import _META, _VOCAB_TOKENS, KV_HEADS, VOCAB, _gguf_tensors, _hf_weights, _tok_meta, _write_gguf

from substratus_tpu.load import gguf as jgguf
from substratus_tpu.serve.engine import Engine as JEngine
from substratus_tpu.serve.engine import EngineConfig as JEngineConfig
from substratus_tpu.serve.engine import Request as JRequest
from substratus_tpu_torch.bridge import params_from_jax
from substratus_tpu_torch.load import gguf
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.serve.engine import Engine, EngineConfig, Request
from substratus_tpu_torch.tools import ckpt_writer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread keeps torch's worker
    pool from spinning on cores that timing-sensitive tests share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _pure_python_spm(monkeypatch):
    monkeypatch.setenv("SUBSTRATUS_SPM_NATIVE", "0")


def _mix(g):
    """norms F32, the embedding F16, attention Q8_0, the MLP Q4_0, the output Q4_1."""
    if "norm" in g:
        return 0
    return {"token_embd": 1, "output": 3}.get(g.split(".")[0], 8 if ".attn_" in g else 2)


def _assert_state_equal(got, want):
    assert set(got) == set(want)
    for name, t in got.items():
        assert t.shape == want[name].shape, name
        assert torch.equal(t.float(), want[name].float()), name


@pytest.mark.parametrize("gtype", [0, 1, 2, 3, 6, 8], ids=["F32", "F16", "Q4_0", "Q4_1", "Q5_0", "Q8_0"])
def test_read_gguf_matches_jax(tmp_path, gtype):
    path = str(tmp_path / "m.gguf")
    _write_gguf(path, _META, _gguf_tensors(_hf_weights(jax.random.key(gtype)), lambda g: gtype))
    meta, tensors = gguf.read_gguf(path)
    j_meta, j_tensors = jgguf.read_gguf(path)
    assert meta == j_meta and set(tensors) == set(j_tensors)
    for name, arr in tensors.items():
        assert arr.dtype == j_tensors[name].dtype == (np.float32 if gtype == 0 else np.float16)
        np.testing.assert_array_equal(arr, j_tensors[name], err_msg=name)
    assert gguf.read_gguf(path, with_tensors=False) == (j_meta, {})


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_load_gguf_matches_jax(tmp_path, tied):
    tensors = _gguf_tensors(_hf_weights(jax.random.key(3)), _mix)
    if tied:
        del tensors["output.weight"]
    path = str(tmp_path / "m.gguf")
    _write_gguf(path, _META, tensors)
    for j_dtype, dtype in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        j_cfg, j_params = jgguf.load_gguf(path, dtype=j_dtype)
        cfg, model = gguf.load_gguf(path, dtype=dtype, device="cpu")
        assert cfg.tie_embeddings == j_cfg.tie_embeddings == tied and cfg.n_kv_heads == KV_HEADS
        assert (cfg.dim, cfg.n_layers, cfg.hidden_dim, cfg.vocab_size, cfg.head_size, cfg.norm_eps) == (
            j_cfg.dim, j_cfg.n_layers, j_cfg.hidden_dim, j_cfg.vocab_size, j_cfg.head_size, j_cfg.norm_eps)
        assert model.layers[0].wq.dtype == dtype
        _assert_state_equal(model.state_dict(), params_from_jax(jax.device_get(j_params)))


def test_writer_files_read_by_jax(tmp_path):
    """ckpt_writer's GGUF (Q4_0 matmuls, Q8_0 embedding and output, F32
    norms, an SPM vocabulary) reads through the JAX reader as through the
    port's, and loads to the model the writer says a loader must give."""
    cfg = llama.CONFIGS["tiny"].replace(vocab_size=300, dtype=torch.float32)
    model = llama.init_params(cfg, seed=1, device="cpu")
    path = str(tmp_path / "w.gguf")
    want = ckpt_writer.write_gguf(path, model, ckpt_writer.spm_vocab(300, 0, ("hello world",)))
    meta, tensors = gguf.read_gguf(path)
    j_meta, j_tensors = jgguf.read_gguf(path)
    assert meta == j_meta and all(np.array_equal(tensors[n], j_tensors[n]) for n in j_tensors)
    _, j_params = jgguf.load_gguf(path, dtype=jnp.float32)
    _, got = gguf.load_gguf(path, dtype=torch.float32, device="cpu")
    _assert_state_equal(got.state_dict(), want.state_dict())
    _assert_state_equal(params_from_jax(jax.device_get(j_params)), want.state_dict())
    # quantized, not equal: within Q4_0's error of the source
    assert 0 < (got.layers[0].w_up - model.layers[0].w_up).abs().max() < 0.1
    tok, j_tok = gguf.tokenizer_from_gguf(path), jgguf.tokenizer_from_gguf(path)
    for text in ("hello world", "Hello, World!"):
        assert tok.encode(text) == j_tok.encode(text) and tok.decode(tok.encode(text)) == text


def test_refusals_match_jax(tmp_path):
    sd = _hf_weights(jax.random.key(0))
    garbage = tmp_path / "not.gguf"
    garbage.write_bytes(b"NOPE" + b"\0" * 64)
    kquant = tmp_path / "k.gguf"
    _write_gguf(kquant, _META, _gguf_tensors(sd, lambda g: 0))
    raw = bytearray(kquant.read_bytes())
    at = raw.index(b"token_embd.weight") + len(b"token_embd.weight") + 4 + 2 * 8  # ndims u32 + 2 dims
    raw[at: at + 4] = (12).to_bytes(4, "little")  # Q4_K
    kquant.write_bytes(bytes(raw))
    scaled, falcon = tmp_path / "scaled.gguf", tmp_path / "falcon.gguf"
    _write_gguf(scaled, dict(_META, **{"llama.rope.scaling.type": "linear"}), _gguf_tensors(sd, lambda g: 0))
    _write_gguf(falcon, dict(_META, **{"general.architecture": "falcon"}), _gguf_tensors(sd, lambda g: 0))
    for path, match in ((garbage, "not a GGUF file"), (kquant, "unsupported type 12"),
                        (scaled, "rope scaling"), (falcon, "llama only")):
        with pytest.raises(ValueError, match=match) as j_err:
            jgguf.load_gguf(str(path))
        with pytest.raises(ValueError, match=match) as err:
            gguf.load_gguf(str(path), device="cpu")
        assert str(err.value) == str(j_err.value)


def test_resolve_gguf_matches_jax(tmp_path):
    sd = _hf_weights(jax.random.key(0))
    one, two, side = tmp_path / "one", tmp_path / "two", tmp_path / "side"
    for d in (one, two, side):
        d.mkdir()
    _write_gguf(one / "a.gguf", _META, _gguf_tensors(sd, lambda g: 0))
    for name in ("a.gguf", "b.gguf"):
        _write_gguf(two / name, _META, _gguf_tensors(sd, lambda g: 0))
    assert gguf.write_tokenizer_gguf(str(side / "tokenizer.gguf"), _tok_meta())
    assert not gguf.write_tokenizer_gguf(str(side / "none.gguf"), _META)
    (side / "none.gguf").write_bytes((one / "a.gguf").read_bytes())  # a weights file beside the sidecar
    cases = [str(one), str(one / "a.gguf"), str(two), str(side), str(side / "tokenizer.gguf"),
             str(tmp_path / "missing.gguf"), str(tmp_path / "nope"), str(tmp_path)]

    def outcome(fn, *args, **kw):
        try:
            return fn(*args, **kw)
        except (ValueError, FileNotFoundError, SystemExit) as e:
            return type(e).__name__, str(e)

    for path in cases:
        for kw in ({}, {"strict": True}, {"weights": False}, {"strict": True, "weights": False}):
            assert outcome(gguf.resolve_gguf, path, **kw) == outcome(jgguf.resolve_gguf, path, **kw), (path, kw)
        assert outcome(gguf.resolve_gguf_or_exit, path) == outcome(jgguf.resolve_gguf_or_exit, path), path
        assert gguf.gguf_has_tensors(path) == jgguf.gguf_has_tensors(path)
    assert gguf.resolve_gguf(str(side)) == str(side / "none.gguf")
    assert gguf.resolve_gguf(str(side), weights=False) is None  # two .gguf files: ambiguous
    # The JAX writer's sidecar, byte for byte.
    assert jgguf.write_tokenizer_gguf(str(tmp_path / "j.gguf"), _tok_meta())
    assert (tmp_path / "j.gguf").read_bytes() == (side / "tokenizer.gguf").read_bytes()


TEXTS = ["hello world", "héllo wörld", " leading", "   three leading", "hello\tworld\n", "", "worldhello he lo",
         "<s>hello</s>", "日本"]


def test_tokenizer_matches_jax():
    tok, j_tok = gguf.GGUFTokenizer(_tok_meta()), jgguf.GGUFTokenizer(_tok_meta())
    assert j_tok._native is None
    assert (tok.bos_id, tok.eos_id, tok.unk_id, tok.vocab_size) == (1, 2, 0, len(_VOCAB_TOKENS))
    for text in TEXTS:
        ids = tok.encode(text)
        assert ids == j_tok.encode(text), text
        assert tok.decode(ids) == j_tok.decode(ids) == text
        assert tok.encode_templated(text) == j_tok.encode_templated(text), text
    sp, he = _VOCAB_TOKENS.index("▁"), _VOCAB_TOKENS.index("he")
    for ids in ([sp, sp, sp, sp, he], [1, 300, 2, 72], [5, 6, 7, 260]):
        assert tok.decode(ids) == j_tok.decode(ids)
    assert tok.decode([sp, sp, sp, sp, he]) == "   he"  # one dummy-prefix space stripped
    text = "hello world " * 2000  # about 24k characters
    t0 = time.perf_counter()
    ids = tok.encode(text)
    assert time.perf_counter() - t0 < 2.0
    assert ids == j_tok.encode(text) and tok.decode(ids) == text


def test_tokenizer_resolution(tmp_path):
    from substratus_tpu_torch.serve.tokenizer import ByteTokenizer, load_tokenizer

    sd = _hf_weights(jax.random.key(0))
    with_tok = tmp_path / "with-tok.gguf"
    _write_gguf(with_tok, _tok_meta(), _gguf_tensors(sd, lambda g: 0))
    assert isinstance(load_tokenizer(str(with_tok)), gguf.GGUFTokenizer)
    assert isinstance(load_tokenizer(str(tmp_path)), gguf.GGUFTokenizer)  # a dir holding one gguf
    bare = tmp_path / "bare"
    bare.mkdir()
    _write_gguf(bare / "no-tok.gguf", _META, _gguf_tensors(sd, lambda g: 0))
    assert isinstance(load_tokenizer(str(bare / "no-tok.gguf")), ByteTokenizer)
    bpe = tmp_path / "bpe"
    bpe.mkdir()
    _write_gguf(bpe / "bpe.gguf", dict(_tok_meta(), **{"tokenizer.ggml.model": "gpt2"}), _gguf_tensors(sd, lambda g: 0))
    with pytest.raises(SystemExit, match="SentencePiece only"):
        load_tokenizer(str(bpe / "bpe.gguf"))


def test_engine_on_loaded_gguf_matches_jax_engine(tmp_path):
    path = str(tmp_path / "m.gguf")
    _write_gguf(path, _META, _gguf_tensors(_hf_weights(jax.random.key(5)), _mix))
    j_cfg, j_params = jgguf.load_gguf(path, dtype=jnp.float32)
    cfg, model = gguf.load_gguf(path, dtype=torch.float32, device="cpu")
    r = np.random.default_rng(0)
    prompts = [[1] + r.integers(3, VOCAB, n - 1).tolist() for n in (3, 11, 20)]
    ec = dict(max_batch=2, max_seq_len=64, eos_token_id=2)

    def run(engine, req_cls):
        engine.start()
        try:
            reqs = [engine.submit(req_cls(list(p), max_tokens=10, temperature=0.0)) for p in prompts]
            outs = []
            for req in reqs:
                toks = []
                while (tok := req.out.get(timeout=300)) is not None:
                    toks.append(tok)
                outs.append((toks, req.finish_reason))
            return outs
        finally:
            engine.stop()

    got = run(Engine(cfg, model, EngineConfig(kv_layout="dense", **ec), device="cpu"), Request)
    want = run(JEngine(j_cfg, j_params, JEngineConfig(kv_layout="dense", overlap=False, **ec)), JRequest)
    assert got == want and all(toks for toks, _ in got)
