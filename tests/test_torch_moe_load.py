"""Mixtral checkpoints in the port (load/hf.py, tools/ckpt_writer.py,
serve/main.py::load_checkpoint) against the JAX loader and transformers,
on tiny MixtralForCausalLM checkpoints written with save_pretrained (no
download) and by the port's writer.

* config_from_hf maps num_local_experts, num_experts_per_tok and
  router_aux_loss_coef as the JAX config_from_hf does; a Mixtral
  config.json that the port used to refuse now loads;
* the state equals bridge.params_from_jax of the JAX
  convert_llama_state_dict exactly (f32), each expert into its slice of
  the stacked weight, from one file and from shards that split a layer;
* the port's logits match transformers' MixtralForCausalLM within 1e-4;
* ckpt_writer writes a Mixtral directory (model_type mixtral) that
  transformers and the port load to the same weights;
* quantize at load (int8, int4, layer by layer) equals loading dense and
  quantizing after, bit for bit; a mixture-of-experts GGUF is refused.
"""
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substratus_tpu.load.hf import config_from_hf as j_config_from_hf
from substratus_tpu.load.hf import convert_llama_state_dict
from substratus_tpu_torch.bridge import params_from_jax
from substratus_tpu_torch.load import gguf
from substratus_tpu_torch.load.hf import config_from_hf, load_pretrained
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.serve.main import load_checkpoint
from substratus_tpu_torch.tools.ckpt_writer import hf_config, write_hf

transformers = pytest.importorskip("transformers")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hf_model(seed=0):
    """A tiny Mixtral (2 layers, dim 64, 4 heads on 2 kv heads, 4 experts,
    top 2) in f32, norms moved away from 1."""
    cfg = transformers.MixtralConfig(
        vocab_size=256, hidden_size=64, intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, num_local_experts=4, num_experts_per_tok=2, max_position_embeddings=128,
        rms_norm_eps=1e-6, router_aux_loss_coef=0.02, tie_word_embeddings=False, attn_implementation="eager")
    torch.manual_seed(seed)
    model = transformers.MixtralForCausalLM(cfg).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.add_(0.1 * torch.randn_like(p))
    return model


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """The model and its save_pretrained directories: one file, and shards
    of 60 KB (a layer's experts over several files)."""
    model = _hf_model()
    dirs = {}
    for layout, kw in (("one", {}), ("sharded", {"max_shard_size": "60KB"})):
        path = tmp_path_factory.mktemp(layout)
        model.save_pretrained(path, **kw)
        dirs[layout] = path
    assert len(list(dirs["sharded"].glob("*.safetensors"))) > 3
    return model, dirs


def test_config_from_hf_maps_moe_fields_as_jax():
    """The MoE fields as JAX maps them; the config.json the port once
    refused (tests/test_torch_load_hf.py's old exit case) now maps."""
    hf = _hf_model().config
    cfg, jcfg = config_from_hf(hf), j_config_from_hf(hf)
    fields = ("n_experts", "n_experts_per_token", "router_aux_weight", "dim", "n_layers", "n_heads", "n_kv_heads",
              "hidden_dim", "vocab_size", "rope_theta", "norm_eps", "max_seq_len", "tie_embeddings")
    assert {f: getattr(cfg, f) for f in fields} == {f: getattr(jcfg, f) for f in fields}
    assert (cfg.n_experts, cfg.n_experts_per_token, cfg.router_aux_weight) == (4, 2, 0.02)
    raw = {"model_type": "mixtral", "num_local_experts": 8, "vocab_size": 32, "hidden_size": 8, "num_hidden_layers": 1,
           "num_attention_heads": 2, "intermediate_size": 16}
    cfg, jcfg = config_from_hf(SimpleNamespace(**raw)), j_config_from_hf(SimpleNamespace(**raw))
    assert (cfg.n_experts, cfg.n_experts_per_token, cfg.router_aux_weight) == (8, 2, 0.01)
    assert {f: getattr(cfg, f) for f in fields} == {f: getattr(jcfg, f) for f in fields}


@pytest.mark.parametrize("layout", ["one", "sharded"])
def test_state_matches_jax_converter_and_logits_transformers(hf_dirs, layout):
    """load_pretrained's state equals the JAX converter's exactly; the
    logits match transformers' dropless Mixtral within 1e-4."""
    model, dirs = hf_dirs
    cfg, loaded = load_pretrained(str(dirs[layout]), dtype=torch.float32, device="cpu")
    assert cfg.n_experts == 4
    jcfg = j_config_from_hf(model.config).replace(dtype=jnp.float32)
    want = params_from_jax(jax.device_get(convert_llama_state_dict(model.state_dict(), jcfg, dtype=jnp.float32)))
    got = loaded.state_dict()
    assert got.keys() == want.keys()
    for name, t in got.items():
        assert torch.equal(t, want[name]), name
    tokens = np.random.default_rng(0).integers(0, 256, (2, 13))
    with torch.no_grad():
        ref = model(torch.from_numpy(tokens)).logits.numpy()
        ours, _ = llama.forward(loaded, torch.from_numpy(tokens), cfg)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4, rtol=0)


def test_writer_round_trip(tmp_path):
    """ckpt_writer writes tiny-moe as a Mixtral directory: model_type
    mixtral, experts.N.w1/w3/w2 and the gate; the port loads it back bit
    for bit, and transformers loads it to the same logits."""
    cfg = llama.CONFIGS["tiny-moe"].replace(dtype=torch.float32)
    model = llama.init_params(cfg, seed=3, device="cpu")
    info = write_hf(str(tmp_path), model)
    assert info["files"] == ["model.safetensors"]
    meta = json.loads((tmp_path / "config.json").read_text())
    assert meta == hf_config(cfg) and meta["model_type"] == "mixtral" and meta["num_local_experts"] == 4
    back_cfg, back = load_pretrained(str(tmp_path), dtype=torch.float32, device="cpu")
    assert (back_cfg.n_experts, back_cfg.n_experts_per_token) == (4, 2)
    for name, t in model.state_dict().items():
        assert torch.equal(back.state_dict()[name], t), name
    hf = transformers.MixtralForCausalLM.from_pretrained(str(tmp_path), torch_dtype=torch.float32,
                                                         attn_implementation="eager").eval()
    w1 = hf.model.layers[1].block_sparse_moe.experts[2].w1.weight
    assert torch.equal(w1, model.layers[1].w_gate[2].t())
    tokens = np.random.default_rng(1).integers(0, 256, (1, 9))
    with torch.no_grad():
        ref = hf(torch.from_numpy(tokens)).logits.numpy()
        ours, _ = llama.forward(model, torch.from_numpy(tokens), cfg)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("quantize", ["int8", "int4"])
def test_quantize_at_load_equals_load_then_quantize(hf_dirs, quantize):
    """load_checkpoint(..., quantize=) stages each layer dense and
    quantizes it as its last shard arrives: every tensor bit for bit
    quantize_weights of the dense load; the router and norms dense."""
    _, dirs = hf_dirs
    _, dense = load_pretrained(str(dirs["sharded"]), device="cpu")
    want = llama.quantize_weights(dense, quantize).state_dict()
    cfg, got_model = load_checkpoint(str(dirs["sharded"]), "cpu", quantize=quantize)
    got = got_model.state_dict()
    assert got.keys() == want.keys() and cfg.n_experts == 4
    for name, t in want.items():
        assert (torch.equal(got[name], t) if isinstance(t, torch.Tensor) else got[name] == t), name
    assert got_model.layers[0].router.dtype == torch.bfloat16
    assert llama.quantized_layout(got_model)["layers.1.w_down"] == quantize


def test_incomplete_checkpoint_and_moe_gguf_refused(tmp_path):
    """A Mixtral directory missing one expert's tensor names the weight;
    a GGUF with an expert count is refused (its tensors are not mapped,
    as in the JAX GGUF loader)."""
    from substratus_tpu_torch.load.hf import read_safetensors
    from substratus_tpu_torch.tools.ckpt_writer import _st_header

    cfg = llama.CONFIGS["tiny-moe"].replace(dtype=torch.float32)
    write_hf(str(tmp_path), llama.init_params(cfg, seed=1, device="cpu"))
    tensors = read_safetensors(str(tmp_path / "model.safetensors"))  # views of the file's map: copied before rewriting
    entries = [(n, t.clone()) for n, t in tensors.items()
               if n != "model.layers.1.block_sparse_moe.experts.3.w2.weight"]
    del tensors
    with open(tmp_path / "model.safetensors", "wb") as f:
        f.write(_st_header(entries))
        for _, t in entries:
            f.write(t.contiguous().numpy().tobytes())
    with pytest.raises(KeyError, match="layers.1.w_down"):
        load_pretrained(str(tmp_path), dtype=torch.float32, device="cpu")
    meta = {"general.architecture": "llama", "llama.expert_count": 8, "llama.attention.head_count": 4}
    infos = [SimpleNamespace(name="token_embd.weight", shape=(64, 256))]
    with pytest.raises(ValueError, match="mixture-of-experts GGUF"):
        gguf.config_from_gguf("m.gguf", meta, infos)
