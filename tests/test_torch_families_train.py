"""Finetuning the OPT and Falcon families in the port (substratus_tpu_torch/
train/) against the JAX package's, then serving what it writes, on the CPU.

* The port's Trainer (its family module from the registry) against the
  JAX Trainer on a one-device mesh, float32 tiny configs, LoRA rank 4 on
  all four attention projections (Falcon's wk/wv adapters [D, r] x [r, KH,
  hd], KH = 1 on tiny-falcon), the weights and adapters carried across by
  params_from_jax / lora_from_jax, a ragged loss mask, four steps at peak
  rate 2e-4: losses within 1e-5 until the adapters first move and 1e-4
  after, adapters within two bf16 ulps or 1e-5, as
  tests/test_torch_train.py holds llama's (the port runs FlashAttention's
  plain forward and backward, JAX its XLA attention).
* train.main of each family (a named config, and an HF directory written
  by tools/ckpt_writer.py) writes an artifact that records its family;
  serve.main --model serves it with the greedy tokens of an Engine on the
  merged model; QLoRA on an OPT or Falcon base exits, and attn_impl is
  reported ignored, as the JAX entry point reports it.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substratus_tpu.models import falcon as jfalcon
from substratus_tpu.models import opt as jopt
from substratus_tpu.parallel.mesh import build_mesh
from substratus_tpu.train.trainer import TrainConfig as JTrainConfig
from substratus_tpu.train.trainer import Trainer as JTrainer
from substratus_tpu_torch.bridge import lora_from_jax, params_from_jax
from substratus_tpu_torch.models import falcon, registry
from substratus_tpu_torch.serve import main as serve_main
from substratus_tpu_torch.serve.engine import Engine, EngineConfig
from substratus_tpu_torch.tools import ckpt_writer
from substratus_tpu_torch.train import main as train_main
from substratus_tpu_torch.train.checkpoints import META_FILE, load_artifact
from substratus_tpu_torch.train.lora import init_lora
from substratus_tpu_torch.train.trainer import TrainConfig, Trainer


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


NAMES = ("tiny-opt", "tiny-falcon", "tiny-falcon-40b-style")
J_MODULES = {"tiny-opt": jopt, "tiny-falcon": jfalcon, "tiny-falcon-40b-style": jfalcon}
TARGETS = ("wq", "wk", "wv", "wo")
TC = dict(learning_rate=2e-4, warmup_steps=2, total_steps=10, lora_rank=4, lora_targets=TARGETS)


def _batch(b=4, s=32, seed=0):
    rng = np.random.default_rng(seed)
    weights = np.ones((b, s), np.float32)
    for i in range(b):  # a ragged loss mask
        weights[i, : rng.integers(0, 24)] = 0.0
    return {"tokens": rng.integers(0, 256, (b, s)).astype(np.int32), "weights": weights}


@pytest.mark.parametrize("name", NAMES)
def test_lora_trainer_matches_jax(name):
    jcfg = J_MODULES[name].CONFIGS[name].replace(dtype=jnp.float32)
    tcfg = registry.find_named_config(name)[1].replace(dtype=torch.float32)
    jt = JTrainer(jcfg, JTrainConfig(remat=False, **TC), build_mesh(devices=jax.devices()[:1]))
    module = registry.MODEL_CLASSES[registry.family_of(tcfg)]
    tt = Trainer(tcfg, TrainConfig(remat=True, **TC), params=module(tcfg, device="cpu"))
    assert tt.model is registry.module_of(tcfg)
    tt.params.load_state_dict(params_from_jax(jax.device_get(jt.params)))
    tt.lora.load_state_dict(lora_from_jax(jax.device_get(jt.lora)))
    batch = _batch()
    want = [jt.train_step(batch) for _ in range(4)]
    got = [tt.train_step(batch) for _ in range(4)]
    assert got[0] == got[1] and got[3] < got[1] - 1e-3  # rate 0 at step 0, then it trains
    np.testing.assert_allclose(got[:2], want[:2], atol=1e-5)
    np.testing.assert_allclose(got, want, atol=1e-4)
    ref = lora_from_jax(jax.device_get(jt.lora))
    for key, t in tt.lora.state_dict().items():
        assert t.dtype == torch.bfloat16
        np.testing.assert_allclose(t.float().numpy(), ref[key].numpy(), rtol=2 * 2**-8, atol=1e-5, err_msg=key)
    base = params_from_jax(jax.device_get(jt.params))
    assert all(torch.equal(t, base[n]) for n, t in tt.params.state_dict().items())  # the base stays frozen


def test_lora_shapes_and_targets():
    """Falcon-7b's wk/wv adapters at KH = 1; the MLP targets, llama's
    alone, refused for OPT and Falcon by name."""
    cfg = falcon.CONFIGS["falcon-7b"].replace(n_layers=1, vocab_size=64)
    ad = init_lora(cfg, rank=16, targets=("wq", "wk", "wv", "wo"), device="cpu")
    shapes = {n: (tuple(ab["a"].shape), tuple(ab["b"].shape)) for n, ab in ad.layers[0].items()}
    assert shapes == {"wq": ((4544, 16), (16, 71, 64)), "wk": ((4544, 16), (16, 1, 64)),
                      "wv": ((4544, 16), (16, 1, 64)), "wo": ((4544, 16), (16, 4544))}
    for name in ("tiny-opt", "tiny-falcon"):
        with pytest.raises(ValueError, match="unknown LoRA targets"):
            init_lora(registry.find_named_config(name)[1], targets=("wq", "w_up"), device="cpu")


def _corpus(tmp_path):
    data = tmp_path / "data.jsonl"
    data.write_text("\n".join(json.dumps({"text": f"document {i}: the quick brown fox"}) for i in range(24)))
    return data


def _train(tmp_path, params, model=None):
    p = tmp_path / "train.json"
    p.write_text(json.dumps({"steps": 2, "batch_size": 2, "seq_len": 32, "lora_rank": 4, "learning_rate": 1e-2,
                             "warmup_steps": 1, **params}))
    out = tmp_path / "out"
    argv = ["--data", str(_corpus(tmp_path)), "--out", str(out), "--params", str(p), "--device", "cpu"]
    return train_main.run(argv + (["--model", model] if model else [])), out


@pytest.mark.parametrize("source", ["tiny-opt", "tiny-falcon-40b-style-hf"])
def test_train_main_artifact_served(source, tmp_path, monkeypatch, capsys):
    """train.main on a named config (opt) or an HF directory (falcon,
    40b-style), then serve.main --model on its artifact: the merged
    weights, the family recorded, greedy tokens those of an Engine on the
    merged model."""
    model = None
    params = {"attn_impl": "flash"}
    if source.endswith("-hf"):
        family, cfg = registry.find_named_config(source.removesuffix("-hf"))
        model = str(tmp_path / "hf")
        ckpt_writer.write_hf(model, family.init_params(cfg.replace(vocab_size=300), seed=0, device="cpu"))
    else:
        params["config"] = source
    res, out = _train(tmp_path, params, model)
    assert "attn_impl ignored for the" in capsys.readouterr().out
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))
    family = registry.family_of(res["cfg"])
    assert json.loads((out / META_FILE).read_text())["family"] == family
    cfg, loaded = load_artifact(str(out), device="cpu")
    merged = res["merged"].state_dict()
    assert cfg == res["cfg"] and all(torch.equal(t, merged[n]) for n, t in loaded.state_dict().items())
    monkeypatch.setattr(serve_main, "load_checkpoint", functools.partial(serve_main.load_checkpoint,
                                                                         dtype=torch.float32))
    (tmp_path / "serve.json").write_text(json.dumps({"max_batch": 2, "max_seq_len": 64}))
    srv = serve_main.build(["--device", "cpu", "--host", "127.0.0.1", "--port", "0", "--params",
                            str(tmp_path / "serve.json"), "--model", str(out)])
    engine = Engine(cfg, res["merged"], EngineConfig(max_batch=2, max_seq_len=64, eos_token_id=10**6), device="cpu")
    engine.start()
    try:
        assert type(srv.state.engine.params) is type(res["merged"]) and not srv.state.engine.paged
        for prompt in ([1, 2, 3], list(range(5, 40))):
            want = engine.generate(prompt, max_tokens=6, temperature=0.0)
            got = srv.state.engine.generate(prompt, max_tokens=6, temperature=0.0)
            assert got == want[: len(got)] and len(got) >= 1
    finally:
        engine.stop()
        srv.stop()


def test_qlora_is_llama_only(tmp_path):
    family, cfg = registry.find_named_config("tiny-falcon")
    ckpt_writer.write_hf(str(tmp_path / "hf"), family.init_params(cfg.replace(vocab_size=300), device="cpu"))
    with pytest.raises(SystemExit, match="QLoRA"):
        _train(tmp_path, {"quantize": "int8"}, str(tmp_path / "hf"))
