"""The port's trainer (substratus_tpu_torch/train/) against the JAX
package's.

* The optimizer against optax directly (the JAX make_optimizer): the
  warmup-cosine schedule at every count (the first update has rate 0),
  then clip_by_global_norm + adamw over five steps of the same gradients,
  with clipping on and off: bf16 parameters bit for bit (moments in bf16,
  scalars rounded to bf16 as JAX's weak types are), f32 within 1e-7.
* cross_entropy_sum, init_lora, merge_lora and lora_from_jax against JAX.
* Trainer against the JAX Trainer on a one-device mesh (attn_impl "xla":
  JAX's flash kernel runs compiled only on a TPU), weights carried across
  by params_from_jax / lora_from_jax, f32 tiny config, a ragged loss mask,
  four steps at peak rate 2e-4 (the first has rate 0): full finetune and
  grad_accum_steps=4 losses and weights within 1e-5; LoRA (bf16 adapters,
  as in JAX) losses within 1e-5 until the adapters first move and within
  1e-4 after, adapters within two bf16 ulps or 1e-5 (a twentieth of the
  rate: the f32 gradients round to bf16 adapters, and a rounding flip of a
  near-zero gradient moves its Adam step). The port's model
  runs its flash path: FlashAttention's plain forward and backward.
* remat equals no remat; a served forward builds no graph.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from substratus_tpu.models import llama as jllama
from substratus_tpu.parallel.mesh import build_mesh
from substratus_tpu.train import lora as jlora
from substratus_tpu.train.trainer import TrainConfig as JTrainConfig
from substratus_tpu.train.trainer import Trainer as JTrainer
from substratus_tpu.train.trainer import cross_entropy_sum as j_ce_sum
from substratus_tpu.train.trainer import make_optimizer as j_make_optimizer
from substratus_tpu_torch.bridge import lora_from_jax, params_from_jax
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.serve.engine import Engine, EngineConfig
from substratus_tpu_torch.train.lora import LoraAdapters, init_lora, merge_lora
from substratus_tpu_torch.train.trainer import TrainConfig, Trainer, cross_entropy_sum, make_optimizer

J_CFG = jllama.CONFIGS["tiny"].replace(dtype=jnp.float32)
T_CFG = llama.CONFIGS["tiny"].replace(dtype=torch.float32)
TC = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10)


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


@pytest.mark.parametrize("warmup,total", [(2, 10), (10, 8), (0, 5), (3, 4)])
def test_schedule_matches_optax(warmup, total):
    opt = make_optimizer(TrainConfig(learning_rate=3e-4, warmup_steps=warmup, total_steps=total), [])
    want = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup, max(total, warmup + 1))
    assert opt.schedule(0) == 0.0 or warmup == 0
    for count in range(total + 3):
        np.testing.assert_allclose(opt.schedule(count), float(want(count)), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_clip_and_adamw_match_optax(dtype):
    rng = np.random.default_rng(0)
    shapes = [(64, 4), (4, 4, 16), (33,)]
    p0 = [rng.standard_normal(s).astype(np.float32) * 0.1 for s in shapes]
    # Norms above and below grad_clip: clipping on in steps 0-2, off after.
    grads = [[rng.standard_normal(s).astype(np.float32) * (0.3 if i < 3 else 0.01) for s in shapes]
             for i in range(5)]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    opt = j_make_optimizer(JTrainConfig(weight_decay=0.1, **TC))
    jp = [jnp.asarray(x, jdt) for x in p0]
    state = opt.init(jp)

    @jax.jit
    def update(g, state, p):
        u, state = opt.update(g, state, p)
        return optax.apply_updates(p, u), state

    tp = [torch.tensor(x).to(tdt) for x in p0]
    topt = make_optimizer(TrainConfig(weight_decay=0.1, **TC), tp)
    for i, g in enumerate(grads):
        jp, state = update([jnp.asarray(x, jdt) for x in g], state, jp)
        lr = topt.update([torch.tensor(x).to(tdt) for x in g])
        assert (lr == 0.0) == (i == 0)
        for a, b in zip(jp, tp):
            assert b.dtype == tdt
            np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32), rtol=0,
                                       atol=0 if dtype == "bfloat16" else 1e-7)
    assert all(m.dtype == tdt for m in topt.mu + topt.nu)


def test_cross_entropy_sum_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 7, 11)).astype(np.float32) * 3
    targets = rng.integers(0, 11, (2, 7)).astype(np.int32)
    weights = (rng.random((2, 7)) > 0.3).astype(np.float32)
    for w in (weights, None):
        s, n = cross_entropy_sum(torch.from_numpy(logits), torch.from_numpy(targets),
                                 None if w is None else torch.from_numpy(w))
        js, jn = j_ce_sum(jnp.asarray(logits), jnp.asarray(targets), None if w is None else jnp.asarray(w))
        np.testing.assert_allclose(s.item(), float(js), rtol=1e-6)
        assert n.item() == float(jn)


def _trainers(**kw):
    # A peak rate of 2e-4 (the example finetune's): Adam's steps on
    # near-zero gradients follow their summation noise, and the rate
    # bounds how far such a step can differ.
    tc = dict(TC, learning_rate=2e-4, **kw)
    jt = JTrainer(J_CFG, JTrainConfig(remat=False, **tc), build_mesh(devices=jax.devices()[:1]))
    tt = Trainer(T_CFG, TrainConfig(remat=True, **tc), params=llama.Llama(T_CFG, device="cpu"))
    tt.params.load_state_dict(params_from_jax(jax.device_get(jt.params)))
    if tt.lora is not None:
        tt.lora.load_state_dict(lora_from_jax(jax.device_get(jt.lora)))
    return jt, tt


@pytest.mark.parametrize("kw", [{}, {"lora_rank": 4}, {"grad_accum_steps": 4}], ids=["full", "lora", "accum"])
def test_trainer_matches_jax(kw):
    jt, tt = _trainers(**kw)
    batch = _batch()
    want = [jt.train_step(batch) for _ in range(4)]
    got = [tt.train_step(batch) for _ in range(4)]
    assert tt.step == 4 and tt.optimizer.count == 4
    assert got[0] == got[1] and got[3] < got[1] - 1e-3  # rate 0 at step 0, then it trains
    if tt.lora is None:
        np.testing.assert_allclose(got, want, atol=1e-5)
        ref = params_from_jax(jax.device_get(jt.params))
        for name, t in tt.params.state_dict().items():
            np.testing.assert_allclose(t.numpy(), ref[name].numpy(), atol=1e-5, err_msg=name)
        snap = tt.snapshot_params()  # a host copy that the next step leaves alone
        tt.train_step(batch)
        assert any(not torch.equal(snap[n], t) for n, t in tt.params.state_dict().items())
        return
    np.testing.assert_allclose(got[:2], want[:2], atol=1e-5)  # step 0 has rate 0: B leaves 0 at step 1
    np.testing.assert_allclose(got, want, atol=1e-4)
    ref = lora_from_jax(jax.device_get(jt.lora))
    for name, t in tt.lora.state_dict().items():
        assert t.dtype == torch.bfloat16
        np.testing.assert_allclose(t.float().numpy(), ref[name].numpy(), rtol=2 * 2**-8, atol=1e-5, err_msg=name)
    # The base stays frozen.
    base = params_from_jax(jax.device_get(jt.params))
    assert all(torch.equal(t, base[n]) for n, t in tt.params.state_dict().items())


def test_remat_equals_no_remat():
    losses, states = [], []
    for remat in (True, False):
        tt = Trainer(T_CFG, TrainConfig(remat=remat, lora_rank=4, **TC), device="cpu")
        losses.append([tt.train_step(_batch(seed=s)) for s in range(3)])
        states.append(tt.lora.state_dict())
    assert losses[0] == losses[1]
    assert all(torch.equal(states[0][k], states[1][k]) for k in states[0])


def test_init_and_merge_lora_match_jax():
    """init_lora's shapes, dtypes and scale; lora_from_jax; merge_lora of
    trained-looking adapters (B nonzero) on every target, wo included."""
    targets = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    ad = init_lora(T_CFG, seed=3, rank=4, targets=targets, device="cpu")
    assert isinstance(ad, LoraAdapters) and len(ad.layers) == T_CFG.n_layers and ad.targets == sorted(targets)
    a, b = ad.layers[1]["wo"]["a"], ad.layers[1]["wo"]["b"]
    assert a.dtype == b.dtype == torch.bfloat16  # bf16 on an f32 model, as in JAX
    assert a.shape == (64, 4) and b.shape == (4, 64) and not b.any()
    assert 0.15 < a.float().std().item() < 0.35  # N(0, 1) / rank
    j_params = jllama.init_params(J_CFG, jax.random.key(0))
    j_ad = jlora.init_lora(J_CFG, jax.random.key(1), rank=4, targets=targets)
    rng = np.random.default_rng(2)
    j_ad = {n: {"a": ab["a"], "b": jnp.asarray(rng.standard_normal(ab["b"].shape) * 0.1, jnp.bfloat16)}
            for n, ab in j_ad.items()}
    ad.load_state_dict(lora_from_jax(jax.device_get(j_ad)))
    assert ad.layers[0]["wq"]["b"].dtype == torch.bfloat16
    params = llama.Llama(T_CFG, device="cpu")
    params.load_state_dict(params_from_jax(jax.device_get(j_params)))
    base = {name: t.clone() for name, t in params.state_dict().items()}
    merged = merge_lora(params, ad, 0.5)
    want = params_from_jax(jax.device_get(jlora.merge_lora(j_params, j_ad, 0.5)))
    for name, t in merged.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), atol=1e-6, err_msg=name)
    assert all(torch.equal(t, base[name]) for name, t in params.state_dict().items())  # params left as they were


def test_served_forward_builds_no_graph():
    """With every weight requiring grad (as a trainer leaves them), the
    engine's prefill and decode logits carry no grad_fn."""
    cfg = llama.CONFIGS["tiny"]
    params = llama.init_params(cfg, device="cpu")
    for p in params.parameters():
        p.requires_grad_(True)
    seen = []

    def capture(fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            seen.append(out[0])
            return out
        return wrapped

    model = types.SimpleNamespace(forward=capture(llama.forward), decode_step=capture(llama.decode_step),
                                  init_cache=llama.init_cache)
    engine = Engine(cfg, params, EngineConfig(max_batch=2, max_seq_len=64, max_prefill_len=16), device="cpu",
                    model=model)
    engine.start()
    try:
        assert len(engine.generate([1] + [65] * 20, max_tokens=3)) == 3  # two chunks, then decode steps
    finally:
        engine.stop()
    assert len(seen) >= 4
    assert all(t.grad_fn is None and not t.requires_grad for t in seen)
