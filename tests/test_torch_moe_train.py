"""Finetuning a mixture of experts with the port (train/lora.py,
train/trainer.py, train/main.py) against the JAX package, on tiny-moe in
float32.

* init_lora's expert-routed pairs (a [E, in, r], b [E, r, out] on
  w_gate/w_up/w_down) beside the attention pairs, carried across by
  lora_from_jax, and merge_lora's [E, D, M] deltas against JAX's merge, on
  a dense and an int8 base; zero B leaves the forward as it was.
* Trainer against the JAX Trainer on a one-device mesh (the capacity
  dispatch in every training forward, the router's aux in the loss),
  weights and adapters carried across: four steps' losses within 1e-4,
  with grad_accum_steps 1 and 2, LoRA on the attention and expert targets,
  and full finetuning (the router trains too).
* train.main on config tiny-moe with lora_targets naming the experts: its
  losses finite, the artifact merged and served by serve.main --model.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substratus_tpu.models import llama as jllama
from substratus_tpu.ops import quant as jquant
from substratus_tpu.parallel.mesh import build_mesh
from substratus_tpu.train import lora as jlora
from substratus_tpu.train.trainer import TrainConfig as JTrainConfig
from substratus_tpu.train.trainer import Trainer as JTrainer
from substratus_tpu_torch.bridge import lora_from_jax, params_from_jax
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.serve import main as serve_main
from substratus_tpu_torch.train import main as train_main
from substratus_tpu_torch.train.lora import init_lora, merge_lora
from substratus_tpu_torch.train.trainer import TrainConfig, Trainer

J_CFG = jllama.CONFIGS["tiny-moe"].replace(dtype=jnp.float32)
T_CFG = llama.CONFIGS["tiny-moe"].replace(dtype=torch.float32)
TARGETS = ("wq", "wv", "w_gate", "w_up", "w_down")
ALL = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(b=4, s=32, seed=0):
    rng = np.random.default_rng(seed)
    weights = np.ones((b, s), np.float32)
    for i in range(b):  # a ragged loss mask: microbatches carry different token counts
        weights[i, : rng.integers(0, 24)] = 0.0
    return {"tokens": rng.integers(0, 256, (b, s)).astype(np.int32), "weights": weights}


def _j_adapters(seed=2):
    """JAX adapters on every target with B drawn (trained-looking)."""
    j_ad = jlora.init_lora(J_CFG, jax.random.key(1), rank=4, targets=ALL)
    rng = np.random.default_rng(seed)
    return {n: {"a": ab["a"], "b": jnp.asarray(rng.standard_normal(ab["b"].shape) * 0.1, jnp.bfloat16)}
            for n, ab in j_ad.items()}


def test_init_lora_expert_pairs():
    """Expert-routed pairs on the MLP targets, dense pairs on attention,
    bf16, B zero; the shapes JAX's init_lora gives a layer; zero B leaves
    the forward unchanged."""
    ad = init_lora(T_CFG, seed=3, rank=4, targets=ALL, device="cpu")
    j_ad = jlora.init_lora(J_CFG, jax.random.key(1), rank=4, targets=ALL)
    for name in ALL:
        for key in ("a", "b"):
            t = ad.layers[1][name][key]
            assert tuple(t.shape) == tuple(j_ad[name][key].shape[1:]) and t.dtype == torch.bfloat16, (name, key)
    assert tuple(ad.layers[0]["w_gate"]["a"].shape) == (4, 64, 4)
    assert tuple(ad.layers[0]["w_down"]["b"].shape) == (4, 4, 64) and not ad.layers[0]["w_down"]["b"].any()
    params = llama.init_params(T_CFG, seed=0, device="cpu")
    tokens = torch.from_numpy(_batch()["tokens"]).long()
    base, _ = llama.forward(params, tokens, T_CFG)
    with_lora, _ = llama.forward(params, tokens, T_CFG, lora={"layers": ad.layers, "scale": 2.0})
    assert torch.equal(base, with_lora)


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_expert_lora_forward_and_merge_match_jax(quantize):
    """Trained-looking adapters on every target: the forward with the
    adapters (the expert pairs added inside the routed FFN, both branches)
    within 1e-5 of JAX's, and merge_lora's weights within 1e-6 of JAX's
    merge (dense base) or JAX's bf16 merge exactly (int8 base, QLoRA)."""
    j_params = jllama.init_params(J_CFG, jax.random.key(0))
    if quantize == "int8":
        j_params = jquant.quantize_params(j_params, jllama.quant_contracting(J_CFG))
    j_ad = _j_adapters()
    params = llama.Llama(T_CFG, device="cpu", quantize=quantize)
    params.load_state_dict(params_from_jax(jax.device_get(j_params)))
    ad = init_lora(T_CFG, seed=3, rank=4, targets=ALL, device="cpu")
    ad.load_state_dict(lora_from_jax(jax.device_get(j_ad)))
    tokens = _batch()["tokens"]
    for train in (False, True):
        jlog, jkv = jllama.forward(j_params, jnp.asarray(tokens), J_CFG, lora={"layers": j_ad, "scale": 0.5},
                                   train=train)
        tlog, tkv = llama.forward(params, torch.from_numpy(tokens).long(), T_CFG,
                                  lora={"layers": ad.layers, "scale": 0.5}, train=train)
        np.testing.assert_allclose(tlog.detach().numpy(), np.asarray(jlog), atol=1e-4 if quantize != "none" else 1e-5)
        np.testing.assert_allclose(tkv["moe_aux"].detach().numpy(), np.asarray(jkv["moe_aux"]), atol=1e-6)
    merged = merge_lora(params, ad, 0.5)
    want = params_from_jax(jax.device_get(jlora.merge_lora(j_params, j_ad, 0.5)))
    for name, t in merged.state_dict().items():
        if quantize == "none":
            np.testing.assert_allclose(t.numpy(), want[name].numpy(), atol=1e-6, err_msg=name)
        elif isinstance(t, torch.Tensor):
            assert torch.equal(t.float(), want[name].float()), name
    assert merged.layers[0].w_gate.shape == (4, 64, 128)


def _trainers(**kw):
    tc = dict(learning_rate=2e-4, warmup_steps=2, total_steps=10, **kw)
    jt = JTrainer(J_CFG, JTrainConfig(remat=False, **tc), build_mesh(devices=jax.devices()[:1]))
    tt = Trainer(T_CFG, TrainConfig(remat=True, **tc), params=llama.Llama(T_CFG, device="cpu"))
    tt.params.load_state_dict(params_from_jax(jax.device_get(jt.params)))
    if tt.lora is not None:
        tt.lora.load_state_dict(lora_from_jax(jax.device_get(jt.lora)))
    return jt, tt


@pytest.mark.parametrize("kw", [{"lora_rank": 4, "lora_targets": TARGETS},
                                {"lora_rank": 4, "lora_targets": TARGETS, "grad_accum_steps": 2},
                                {"grad_accum_steps": 2}], ids=["lora", "lora-accum2", "full-accum2"])
def test_trainer_matches_jax(kw):
    """Four steps on one batch: the losses (cross entropy plus
    router_aux_weight x the mean aux, through the capacity dispatch)
    within 1e-4 of the JAX Trainer's; the aux term is in them."""
    jt, tt = _trainers(**kw)
    batch = _batch()
    want = [jt.train_step(batch) for _ in range(4)]
    got = [tt.train_step(batch) for _ in range(4)]
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert got[0] == got[1] and got[3] < got[1]  # rate 0 at step 0, then it trains
    tokens = torch.from_numpy(batch["tokens"]).long()
    weights = torch.from_numpy(batch["weights"])
    with torch.no_grad():
        from substratus_tpu_torch.train.trainer import cross_entropy_loss

        plain = cross_entropy_loss(*tt.loss_inputs(tokens, weights))
        assert float(tt.loss(tokens, weights) - plain) > 0.005  # 0.01 x an aux near 1
    if tt.lora is None:
        ref = params_from_jax(jax.device_get(jt.params))
        np.testing.assert_allclose(tt.params.layers[0].router.detach().numpy(), ref["layers.0.router"].numpy(),
                                   atol=1e-5)


def test_train_main_tiny_moe(tmp_path):
    """train.main on config tiny-moe, LoRA on the attention and expert
    targets, 3 steps: finite losses, the expert pairs in the adapter
    artifact, and the merged artifact served by serve.main --model."""
    (tmp_path / "data.jsonl").write_text("\n".join(json.dumps({"text": f"moe document {i} " * 20})
                                                   for i in range(8)))
    (tmp_path / "params.json").write_text(json.dumps({
        "config": "tiny-moe", "steps": 3, "batch_size": 2, "seq_len": 32, "lora_rank": 4,
        "lora_targets": list(TARGETS), "learning_rate": 1e-3, "warmup_steps": 1}))
    out = tmp_path / "out"
    run = train_main.run(["--device", "cpu", "--data", str(tmp_path / "data.jsonl"), "--out", str(out),
                          "--params", str(tmp_path / "params.json")])
    assert len(run["losses"]) == 3 and np.isfinite(run["losses"]).all()
    trainer = run["trainer"]
    assert trainer.cfg.n_experts == 4 and tuple(trainer.lora.layers[0]["w_up"]["a"].shape) == (4, 64, 4)
    assert run["merged"].layers[1].w_up.shape == (4, 64, 128)
    (tmp_path / "serve.json").write_text(json.dumps({"max_batch": 2, "max_seq_len": 64}))
    srv = serve_main.build(["--device", "cpu", "--host", "127.0.0.1", "--port", "0", "--model", str(out),
                            "--params", str(tmp_path / "serve.json")])
    try:
        assert srv.state.engine.cfg.n_experts == 4
        assert len(srv.state.engine.generate([1, 2, 3], max_tokens=4, temperature=0.0)) == 4
    finally:
        srv.stop()
    with pytest.raises(SystemExit, match="lora_targets"):
        train_main.check_params({"lora_targets": "wq"})
