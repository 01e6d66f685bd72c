"""OPT and Falcon HF checkpoints in the port (substratus_tpu_torch/load/hf.py,
tools/ckpt_writer.py) against the JAX package's loader (substratus_tpu/
load/hf.py), on the CPU.

tools/ckpt_writer.py writes tiny seeded models of each family as HF
directories: config.json with transformers' keys, tensors under
transformers' names (Falcon's q, k and v fused into query_key_value per
kv group), as safetensors (sharded) or a torch .bin. The port's
load_pretrained and JAX's load_pretrained read each into the same weights
bit for bit (f32), equal to the model written, and into the same config.
Full-width configs round-trip through config.json. The variants the JAX
converters refuse exit with JAX's messages.
"""
import dataclasses
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest
import torch

from substratus_tpu.load import hf as jhf
from substratus_tpu_torch.bridge import params_from_jax
from substratus_tpu_torch.load import hf
from substratus_tpu_torch.models import registry
from substratus_tpu_torch.tools import ckpt_writer

NAMES = ("tiny-opt", "tiny-falcon", "tiny-falcon-40b-style")


def _model(name, seed=0):
    family, cfg = registry.find_named_config(name)
    cfg = cfg.replace(dtype=torch.float32)
    return family.init_params(cfg, seed=seed, device="cpu")


def _same_config(t_cfg, j_cfg):
    """Every field of the JAX config equals the port's (dtype apart)."""
    j = {k: v for k, v in dataclasses.asdict(j_cfg).items() if k != "dtype"}
    t = {k: v for k, v in dataclasses.asdict(t_cfg).items() if k != "dtype"}
    assert t == j


def _check_loads(path, model):
    t_cfg, loaded = hf.load_pretrained(str(path), dtype=torch.float32, device="cpu")
    j_cfg, j_params = jhf.load_pretrained(str(path), dtype=jnp.float32)
    _same_config(t_cfg, j_cfg)
    assert t_cfg == model.cfg and type(loaded) is type(model)
    want = params_from_jax(jax.device_get(j_params))
    state = loaded.state_dict()
    assert set(state) == set(want) == set(model.state_dict())
    for name, t in state.items():
        assert torch.equal(t, want[name]), name
        assert torch.equal(t, model.state_dict()[name]), name


@pytest.mark.parametrize("name", NAMES)
def test_safetensors_dir_loads_as_jax_loads(name, tmp_path):
    model = _model(name)
    written = ckpt_writer.write_hf(str(tmp_path / name), model, shard_bytes=40_000)
    assert len(written["files"]) > 1  # shards with their index
    raw = json.loads((tmp_path / name / "config.json").read_text())
    assert raw["model_type"] == registry.family_of(model.cfg)
    _check_loads(tmp_path / name, model)


def test_bin_dirs_load_as_jax_loads(tmp_path):
    for name in ("tiny-opt", "tiny-falcon"):
        model = _model(name, seed=1)
        d = tmp_path / name
        d.mkdir()
        (d / "config.json").write_text(json.dumps(ckpt_writer.hf_config(model.cfg)))
        tensors = dict(ckpt_writer.hf_tensors(model))
        if name == "tiny-falcon":
            assert "transformer.h.1.self_attention.query_key_value.weight" in tensors
            assert tensors["transformer.h.1.self_attention.query_key_value.weight"].shape == (6 * 16, 64)
        else:
            assert "model.decoder.layers.0.self_attn.q_proj.bias" in tensors
        torch.save(tensors, d / "pytorch_model.bin")
        _check_loads(d, model)


def test_full_width_configs_round_trip():
    """falcon-7b, falcon-40b, opt-125m and opt-6.7b through config.json and
    both converters' config functions."""
    for name in ("falcon-7b", "falcon-40b", "opt-125m", "opt-6.7b"):
        _, cfg = registry.find_named_config(name)
        raw = SimpleNamespace(**ckpt_writer.hf_config(cfg))
        if registry.family_of(cfg) == "falcon":
            t_cfg, j_cfg = hf.config_from_hf_falcon(raw), jhf.config_from_hf_falcon(raw)
        else:
            t_cfg, j_cfg = hf.config_from_hf_opt(raw), jhf.config_from_hf_opt(raw)
        assert t_cfg == cfg, name
        _same_config(t_cfg, j_cfg)


OPT_RAW = {"model_type": "opt", "vocab_size": 256, "hidden_size": 64, "num_hidden_layers": 2,
           "num_attention_heads": 4, "ffn_dim": 128, "max_position_embeddings": 128}
FALCON_RAW = {"model_type": "falcon", "vocab_size": 256, "hidden_size": 64, "num_hidden_layers": 2,
              "num_attention_heads": 4}
REFUSALS = [
    ("opt", {"do_layer_norm_before": False}, "post-LN OPT variants"),
    ("opt", {"activation_function": "gelu"}, "OPT activation 'gelu' not supported"),
    ("opt", {"word_embed_proj_dim": 32}, "word_embed_proj_dim=32"),
    ("falcon", {"parallel_attn": False}, "non-parallel Falcon blocks"),
    ("falcon", {"alibi": True}, "alibi"),
    ("falcon", {"bias": True}, "biased Falcon projections"),
    ("falcon", {"tie_word_embeddings": False}, "untied Falcon LM heads"),
]


@pytest.mark.parametrize("family,extra,match", REFUSALS, ids=[m.split()[0] + str(i) for i, (_, _, m) in
                                                                enumerate(REFUSALS)])
def test_refused_variants_exit_with_jax_message(family, extra, match, tmp_path):
    raw = dict(OPT_RAW if family == "opt" else FALCON_RAW, **extra)
    config_fn = jhf.config_from_hf_opt if family == "opt" else jhf.config_from_hf_falcon
    with pytest.raises(NotImplementedError, match=match) as j_err:
        config_fn(SimpleNamespace(**raw))
    (tmp_path / "config.json").write_text(json.dumps(raw))
    with pytest.raises(SystemExit, match=match) as t_err:
        hf.load_pretrained(str(tmp_path), device="cpu")
    assert str(t_err.value) == str(j_err.value)
