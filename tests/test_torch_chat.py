"""Chat templates of the port's tokenizers (substratus_tpu_torch/load/gguf.py
GGUFTokenizer, serve/tokenizer.py HFTokenizer) and /v1/chat/completions
against the JAX package, on the CPU.

A tiny llama written by tools/ckpt_writer.py as a GGUF (F32 tensors, so
both loaders give the same float32 weights) with spm_vocab's SPM vocab and
its Llama-2-style tokenizer.chat_template: the port's and the JAX
GGUFTokenizer.apply_chat_template render the same string for the same
messages (and refuse a role the template rejects alike), encode_templated
gives the same ids, and a greedy chat completion, whole and streamed, is
the same through both servers. An HF tokenizer directory with a
chat_template in its config renders and encodes alike through both
HFTokenizers (transformers, present here).
"""
import json

import jax.numpy as jnp
import pytest
import torch
from test_torch_load_hf import _tokenizer_dir
from test_torch_surface import (  # noqa: F401
    _one_torch_thread, close_pair, jax_http, port_http, result, serve_pair, sse)

from substratus_tpu.load import gguf as jgguf
from substratus_tpu.serve.server import ServerState as JServerState
from substratus_tpu.serve.tokenizer import load_tokenizer as j_load_tokenizer
from substratus_tpu_torch.load import gguf
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.serve.server import ServerState
from substratus_tpu_torch.serve.tokenizer import HFTokenizer, load_tokenizer
from substratus_tpu_torch.tools import ckpt_writer

CHATS = [
    [{"role": "user", "content": "read the page"}],
    [{"role": "system", "content": "  Answer with the token.  "}, {"role": "user", "content": "write the token"}],
    [{"role": "user", "content": "one"}, {"role": "assistant", "content": "two"}, {"role": "user", "content": "ok"}],
]


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    cfg = llama.CONFIGS["tiny"].replace(vocab_size=512, dtype=torch.float32)
    texts = tuple(m["content"] for chat in CHATS for m in chat) + ("the page of the token",)
    vocab = ckpt_writer.spm_vocab(cfg.vocab_size, 0, texts, chat_template=ckpt_writer.LLAMA2_CHAT_TEMPLATE)
    path = tmp_path_factory.mktemp("chat") / "tiny-chat.gguf"
    ckpt_writer.write_gguf(str(path), llama.init_params(cfg, seed=0, device="cpu"), vocab,
                           ggml_type=lambda name: gguf.GGML_F32)
    return str(path)


def test_gguf_template_renders_and_encodes_as_in_jax(gguf_path):
    tok, j_tok = gguf.tokenizer_from_gguf(gguf_path), jgguf.tokenizer_from_gguf(gguf_path)
    assert tok.chat_template == j_tok.chat_template == ckpt_writer.LLAMA2_CHAT_TEMPLATE
    for chat in CHATS:
        rendered = tok.apply_chat_template(chat)
        assert rendered == j_tok.apply_chat_template(chat)
        assert rendered.startswith("<s>") and rendered.endswith("[/INST]")
        ids = tok.encode_templated(rendered)
        assert ids == j_tok.encode_templated(rendered) and ids[0] == tok.bos_id and ids.count(tok.bos_id) == 1
        assert ServerState(None, tok, "m").render_chat(chat) == JServerState(None, j_tok, "m").render_chat(chat)
    bad = [{"role": "tool", "content": "x"}]
    for t in (tok, j_tok):
        with pytest.raises(ValueError, match="chat template error"):
            t.apply_chat_template(bad)
    # A broken template falls back to the generic transcript in both servers.
    assert ServerState(None, tok, "m").render_chat(bad) == JServerState(None, j_tok, "m").render_chat(bad) == (
        "tool: x\nassistant:", False)
    tok.chat_template = None
    assert tok.apply_chat_template(CHATS[0]) is None


def test_chat_completion_through_both_servers(gguf_path):
    j_cfg, j_params = jgguf.load_gguf(gguf_path, dtype=jnp.float32)
    cfg, params = gguf.load_gguf(gguf_path, dtype=torch.float32, device="cpu")
    tok, j_tok = gguf.tokenizer_from_gguf(gguf_path), jgguf.tokenizer_from_gguf(gguf_path)
    pair = serve_pair(j_params, params, j_cfg=j_cfg, j_tok=j_tok, t_tok=tok, eos_token_id=tok.eos_id)
    try:
        for chat in CHATS[1:]:
            body = {"messages": chat, "max_tokens": 12, "temperature": 0}
            calls = [("POST", "/v1/chat/completions", body, None),
                     ("POST", "/v1/chat/completions", {**body, "stream": True}, None)]
            j, t = jax_http(pair.jstate, calls), port_http(pair.srv, calls)
            got = result(t[0], chat=True)
            assert got == result(j[0], chat=True)
            assert got[2]["prompt_tokens"] == len(tok.encode_templated(tok.apply_chat_template(chat)))
            jp, jf, _ = sse(j[1][2], chat=True)
            tp, tf, _ = sse(t[1][2], chat=True)
            assert "".join(tp) == "".join(jp) == got[0] and tf == jf == got[1]
    finally:
        close_pair(pair)


def test_hf_template_renders_and_encodes_as_in_jax(tmp_path):
    _tokenizer_dir(tmp_path)
    config = json.loads((tmp_path / "tokenizer_config.json").read_text())
    config["chat_template"] = ckpt_writer.LLAMA2_CHAT_TEMPLATE
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(config))
    tok, j_tok = load_tokenizer(str(tmp_path)), j_load_tokenizer(str(tmp_path))
    assert isinstance(tok, HFTokenizer)
    for chat in CHATS:
        rendered = tok.apply_chat_template(chat)
        assert rendered == j_tok.apply_chat_template(chat)
        assert rendered.startswith("<s>") and rendered.endswith("[/INST]")
        assert tok.encode_templated(rendered) == j_tok.encode_templated(rendered)
    config.pop("chat_template")
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(config))
    assert load_tokenizer(str(tmp_path)).apply_chat_template(CHATS[0]) is None
