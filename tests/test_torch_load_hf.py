"""The port's HF checkpoint import (substratus_tpu_torch/load/hf.py) and
its checkpoint tokenizers (serve/tokenizer.py) against the JAX package's,
on tiny transformers LlamaForCausalLM checkpoints written with
save_pretrained (no download): one safetensors file, sharded safetensors
(max_shard_size, with the index), torch .bin, and tied embeddings.

* load_pretrained's state equals bridge.params_from_jax of the JAX
  load_pretrained exactly (float32; bf16 through f32), and the port's
  logits match transformers' within tests/test_torch_model.py's 1e-4;
* the hand-written safetensors reader equals safetensors.safe_open on
  BF16, F16 and F32 tensors, and refuses another dtype by name;
* the OPT and Falcon variants the JAX converters refuse, another
  model_type and a path that is not a local checkpoint exit (Mixtral
  loads: tests/test_torch_moe_load.py);
* load_tokenizer on a tokenizers-built tokenizer.json gives the JAX
  load_tokenizer's ids; without transformers it exits naming it.
"""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import save_file
from transformers import LlamaConfig as HFLlamaConfig
from transformers import LlamaForCausalLM

from substratus_tpu.load.hf import load_pretrained as j_load_pretrained
from substratus_tpu.serve.tokenizer import load_tokenizer as j_load_tokenizer
from substratus_tpu_torch.bridge import params_from_jax
from substratus_tpu_torch.load.hf import load_pretrained, read_safetensors
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.serve.tokenizer import HFTokenizer, load_tokenizer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread keeps torch's worker
    pool from spinning on cores that timing-sensitive tests share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hf_model(tied=False, seed=0):
    """A tiny GQA Llama (2 layers, dim 64, 4 heads, 2 kv heads) in f32."""
    cfg = HFLlamaConfig(vocab_size=300, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
                        rms_norm_eps=1e-6, tie_word_embeddings=tied, attn_implementation="eager")
    torch.manual_seed(seed)
    model = LlamaForCausalLM(cfg).eval()
    with torch.no_grad():  # norms away from 1, so that a swapped norm shows
        for name, p in model.named_parameters():
            if "norm" in name:
                p.add_(0.1 * torch.randn_like(p))
    return model


LAYOUTS = {"safetensors": {}, "sharded": {"max_shard_size": "60KB"}, "bin": {"safe_serialization": False},
           "tied": {}}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_load_pretrained_matches_jax_and_transformers(tmp_path, layout):
    hf = _hf_model(tied=layout == "tied")
    hf.save_pretrained(tmp_path, **LAYOUTS[layout])
    files = sorted(p.name for p in tmp_path.iterdir())
    assert any(f.endswith(".bin" if layout == "bin" else ".safetensors") for f in files)
    assert ("model.safetensors.index.json" in files) == (layout == "sharded")
    j_cfg, j_params = j_load_pretrained(str(tmp_path), dtype=jnp.float32)
    cfg, model = load_pretrained(str(tmp_path), dtype=torch.float32, device="cpu")
    assert (cfg.n_kv_heads, cfg.tie_embeddings, cfg.norm_eps) == (2, layout == "tied", 1e-6)
    assert (cfg.dim, cfg.n_layers, cfg.hidden_dim, cfg.vocab_size) == (j_cfg.dim, j_cfg.n_layers, j_cfg.hidden_dim,
                                                                      j_cfg.vocab_size)
    want = params_from_jax(jax.device_get(j_params))
    assert set(model.state_dict()) == set(want)
    for name, t in model.state_dict().items():
        assert torch.equal(t, want[name]), name
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 300, (2, 24)))
    with torch.inference_mode():
        got, _ = llama.forward(model, tokens, cfg)
        ref = hf(tokens).logits
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4, rtol=1e-4)
    if layout == "safetensors":  # the default dtype: bf16, as the JAX loader's
        _, j_bf16 = j_load_pretrained(str(tmp_path))
        _, bf16 = load_pretrained(str(tmp_path), device="cpu")
        want = params_from_jax(jax.device_get(j_bf16))
        assert all(t.dtype == torch.bfloat16 and torch.equal(t.float(), want[n]) for n, t in bf16.state_dict().items())


def test_safetensors_reader_matches_safe_open(tmp_path):
    g = torch.Generator().manual_seed(0)
    tensors = {"bf16": torch.randn(7, 5, generator=g).bfloat16(), "f16": torch.randn(3, generator=g).half(),
               "f32": torch.randn(2, 3, 4, generator=g), "odd_f16": torch.randn(5, generator=g).half(),
               "after_odd": torch.randn(9, generator=g), "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 4)}
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got = read_safetensors(path)
    with safe_open(path, framework="pt") as f:
        assert sorted(f.keys()) == sorted(got)
        for name in f.keys():
            want = f.get_tensor(name)
            assert got[name].dtype == want.dtype and got[name].shape == want.shape, name
            assert torch.equal(got[name], want), name
    save_file({"ids": torch.arange(4)}, str(tmp_path / "i.safetensors"))
    with pytest.raises(ValueError, match="'ids' has dtype I64"):
        read_safetensors(str(tmp_path / "i.safetensors"))


def test_unported_and_non_local_checkpoints_exit(tmp_path):
    # OPT and Falcon load (tests/test_torch_families_load.py); the variants
    # their JAX converters refuse exit.
    for name, raw, match in (("opt", {"model_type": "opt", "do_layer_norm_before": False, "hidden_size": 8},
                              "post-LN OPT"),
                             ("falcon", {"model_type": "falcon", "alibi": True}, "alibi"),
                             ("gpt2", {"model_type": "gpt2"}, "unsupported HF model_type")):
        (tmp_path / name).mkdir()
        (tmp_path / name / "config.json").write_text(json.dumps(raw))
        with pytest.raises(SystemExit, match=match):
            load_pretrained(str(tmp_path / name), device="cpu")
    for path in ("meta-llama/Llama-2-7b-hf", str(tmp_path / "nowhere"), str(tmp_path)):
        with pytest.raises(SystemExit, match="local checkpoints only"):
            load_pretrained(path, device="cpu")


def _tokenizer_dir(path):
    """A BPE tokenizer trained offline with `tokenizers` on a small corpus,
    saved as tokenizer.json with its tokenizer_config.json."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    corpus = ["the quick brown fox jumps over the lazy dog", "a tiny checkpoint serves its own tokenizer"] * 50
    tok.train_from_iterator(corpus, trainers.BpeTrainer(vocab_size=280, special_tokens=["<unk>", "<s>", "</s>"],
                                                        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    path.mkdir(exist_ok=True)
    tok.save(str(path / "tokenizer.json"))
    (path / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast", "bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>"}))


def test_load_tokenizer_matches_jax(tmp_path, monkeypatch):
    _tokenizer_dir(tmp_path)
    tok, j_tok = load_tokenizer(str(tmp_path)), j_load_tokenizer(str(tmp_path))
    assert isinstance(tok, HFTokenizer) and tok.eos_id == j_tok.eos_id == 2 and tok.vocab_size <= 300
    for text in ("the quick brown fox", "a tiny checkpoint, unseen words!", ""):
        ids = tok.encode(text)
        assert ids == j_tok.encode(text) and len(ids) > 0 or text == ""
        assert tok.decode(ids) == j_tok.decode(ids)
    monkeypatch.setitem(sys.modules, "transformers", None)  # the card's machine
    with pytest.raises(SystemExit, match="transformers"):
        load_tokenizer(str(tmp_path))
