"""The RL loop in the port (substratus_tpu_torch/rl/) against the JAX
package's (substratus_tpu/rl/), on the CPU.

* Buffer, reward weights and batches: the same episodes give JAX's
  weights, arrays and dtypes exactly; overflow drops the oldest, as JAX's.
* RLLearner: the same drains give JAX's loss history within 1e-4
  (float32 tiny config, the weights carried by the bridge; another
  summation order in the forward, the backward and Adam's updates, which
  stay within the trainer parity tests' bounds); the LoRA refusal and the
  metric names and help are JAX's.
* RLLoop, 3 rounds, against JAX's on one actor each: the same episodes
  (tokens and rewards, in the same order), the same losses within 1e-4,
  the same weights_version. The drain's order decides how episodes are cut
  into batches, so the configuration makes it deterministic and the test
  asserts it: one actor, greedy decoding, every prompt admitted at once
  (max_batch >= the prompts) and an EOS no model samples, so every request
  finishes at the same step, in manifest order.
* Two actors sampling (temperature 0.9) for 3 rounds: versions 1, 2, 3,
  no scheduler thread restarted, finite losses, and after the last swap
  each actor's greedy tokens are an engine's on the learner's snapshot.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substratus_tpu.models import llama as jllama
from substratus_tpu.observability.metrics import METRICS as JMETRICS
from substratus_tpu.parallel.mesh import build_mesh
from substratus_tpu.rl import buffer as jbuffer
from substratus_tpu.rl.learner import RLLearner as JRLLearner
from substratus_tpu.rl.loop import RLLoop as JRLLoop
from substratus_tpu.serve.engine import Engine as JEngine
from substratus_tpu.serve.engine import EngineConfig as JEngineConfig
from substratus_tpu.train.trainer import TrainConfig as JTrainConfig
from substratus_tpu_torch.bridge import config_from_jax, params_from_jax
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.observability.metrics import METRICS
from substratus_tpu_torch.rl import buffer
from substratus_tpu_torch.rl.learner import RLLearner
from substratus_tpu_torch.rl.loop import RLLoop
from substratus_tpu_torch.serve.engine import Engine, EngineConfig
from substratus_tpu_torch.train.trainer import TrainConfig

NEVER = 10**6  # an EOS id no model of vocabulary 258 samples
TC = dict(learning_rate=1e-2, warmup_steps=1, total_steps=30, remat=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _episodes(mod, seed=0):
    """Episodes of the same numpy draws, in either package's Episode."""
    r = np.random.default_rng(seed)
    out = []
    for i in range(7):
        prompt = r.integers(0, 256, int(r.integers(1, 12))).tolist()
        completion = r.integers(0, 256, int(r.integers(0, 30))).tolist()
        out.append(mod.Episode(prompt, completion, float(r.uniform(-2, 3)) if i != 3 else 0.0))
    out.append(mod.Episode([7] * 40, [9] * 5, 1.0))  # the prompt alone fills seq_len
    return out


def test_reward_weights_and_batches_equal_jax():
    for seed in range(4):
        jeps, teps = _episodes(jbuffer, seed), _episodes(buffer, seed)
        assert buffer.reward_weights(teps) == jbuffer.reward_weights(jeps)
        for bs, sl, pad in ((2, 16, 0), (3, 32, 5), (8, 64, 0), (1, 2, 1)):
            want = list(jbuffer.episodes_to_batches(jeps, bs, sl, pad_id=pad))
            got = list(buffer.episodes_to_batches(teps, bs, sl, pad_id=pad))
            assert len(got) == len(want) and len(got) * bs >= len(teps)
            for g, w in zip(got, want):
                assert g.keys() == w.keys()
                for k in g:
                    assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), (seed, bs, sl, k)
    same = [buffer.Episode([1], [2], 0.7) for _ in range(3)]
    assert buffer.reward_weights(same) == [1.0] * 3 and buffer.reward_weights([]) == []
    assert list(buffer.episodes_to_batches([], 2, 16)) == []
    for bad in ((0, 16), (2, 1)):
        with pytest.raises(ValueError, match="required") as t_err:
            list(buffer.episodes_to_batches(teps, *bad))
        with pytest.raises(ValueError) as j_err:
            list(jbuffer.episodes_to_batches(jeps, *bad))
        assert str(t_err.value) == str(j_err.value)


def test_replay_buffer_overflow_as_jax():
    jbuf, tbuf = jbuffer.ReplayBuffer(capacity=3), buffer.ReplayBuffer(capacity=3)
    for i in range(7):
        jbuf.add(jbuffer.Episode([i], [i], float(i)))
        tbuf.add(buffer.Episode([i], [i], float(i)))
        assert len(tbuf) == len(jbuf) and tbuf.dropped == jbuf.dropped
    assert [e.reward for e in tbuf.drain()] == [e.reward for e in jbuf.drain()] == [4.0, 5.0, 6.0]
    assert len(tbuf) == 0 and tbuf.drain() == [] and tbuf.dropped == 4


def _models():
    jcfg = jllama.CONFIGS["tiny"].replace(vocab_size=258, dtype=jnp.float32)
    j_params = jllama.init_params(jcfg, jax.random.key(0))
    tcfg = config_from_jax(jcfg)
    t_params = llama.Llama(tcfg, device="cpu")
    t_params.load_state_dict(params_from_jax(jax.device_get(j_params)))
    return jcfg, j_params, tcfg, t_params


def _mesh1():
    return build_mesh(devices=jax.devices()[:1])


def test_learner_loss_history_matches_jax():
    jcfg, j_params, tcfg, t_params = _models()
    jl = JRLLearner(jcfg, JTrainConfig(**TC), _mesh1(), params=j_params, batch_size=3, seq_len=32)
    tl = RLLearner(tcfg, TrainConfig(**TC), params=t_params, device="cpu", batch_size=3, seq_len=32)
    assert tl.trainer.params is not t_params  # the learner trains its own copy
    for seed in range(3):
        want = jl.learn(_episodes(jbuffer, seed))
        got = tl.learn(_episodes(buffer, seed))
        assert len(got) == len(want) == 3
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert len(tl.losses) == 9 and tl.step == jl.step == 9
    assert tl.learn([]) == [] and tl.step == 9
    snap = tl.snapshot_params()
    assert snap.keys() == t_params.state_dict().keys()
    assert all(v.device.type == "cpu" and v.dtype == torch.float32 for v in snap.values())
    assert not torch.equal(snap["layers.0.wq"], t_params.layers[0].wq)  # it learned; the source is untouched


def test_learner_refusal_and_metrics_as_jax():
    jcfg, _, tcfg, _ = _models()
    with pytest.raises(ValueError) as j_err:
        JRLLearner(jcfg, JTrainConfig(lora_rank=4), _mesh1())
    with pytest.raises(ValueError) as t_err:
        RLLearner(tcfg, TrainConfig(lora_rank=4), device="cpu")
    assert str(t_err.value) == str(j_err.value) and "full-finetune only" in str(t_err.value)
    for name in ("substratus_rl_learner_updates_total", "substratus_rl_episodes_total", "substratus_rl_learner_loss",
                 "substratus_rl_rounds_total", "substratus_rl_mean_reward"):
        assert METRICS._help[name] == JMETRICS._help[name] and METRICS._types[name] == JMETRICS._types[name]


def _reward(record, prompt_tokens):
    """The share of completion tokens in the lower half of the vocabulary
    (JAX's own loop test's reward)."""
    toks = record.get("tokens") or []
    return sum(1 for t in toks if t < 128) / max(len(toks), 1)


def _prompts(n=8, seed=3):
    r = np.random.default_rng(seed)
    return [r.integers(10, 250, 6).tolist() for _ in range(n)]


def test_three_rounds_match_jax(tmp_path):
    jcfg, j_params, tcfg, t_params = _models()
    prompts = _prompts()
    ec = dict(max_batch=len(prompts), max_seq_len=64, eos_token_id=NEVER)  # every prompt admitted at once
    runs = {}
    for side in ("jax", "port"):
        seen = []

        def reward(record, prompt_tokens, seen=seen):
            seen.append((record["id"], list(record["tokens"]), record["finish_reason"]))
            return _reward(record, prompt_tokens)

        if side == "jax":
            engine = JEngine(jcfg, j_params, JEngineConfig(overlap=False, **ec))
            learner = JRLLearner(jcfg, JTrainConfig(**TC), _mesh1(), params=j_params, batch_size=4, seq_len=32)
            loop_cls = JRLLoop
        else:
            engine = Engine(tcfg, t_params, EngineConfig(**ec), device="cpu")
            learner = RLLearner(tcfg, TrainConfig(**TC), params=t_params, device="cpu", batch_size=4, seq_len=32)
            loop_cls = RLLoop
        engine.start()
        thread = engine._thread
        try:
            loop = loop_cls([engine], learner, prompts, reward, str(tmp_path / side), max_tokens=12,
                            temperature=0.0)
            reports = loop.run(3)
            assert engine._thread is thread and thread.is_alive() and engine.error is None
            assert engine.weights_version == 3
        finally:
            engine.stop()
        runs[side] = (reports, seen)
    (jrep, jseen), (trep, tseen) = runs["jax"], runs["port"]
    # The precondition of a deterministic drain: every record of a round
    # ends by length at the same step, in manifest order, on both sides.
    for seen in (jseen, tseen):
        assert [s[0] for s in seen] == [f"r{r}-{i}" for r in range(3) for i in range(len(prompts))]
        assert all(finish == "length" and len(toks) == 12 for _, toks, finish in seen)
    assert tseen == jseen
    assert [r["weights_version"] for r in trep] == [r["weights_version"] for r in jrep] == [1, 2, 3]
    for t, j in zip(trep, jrep):
        assert (t["round"], t["episodes"], t["mean_reward"]) == (j["round"], j["episodes"], j["mean_reward"])
        assert len(t["losses"]) == len(j["losses"]) == 2 and t["gen"]["errors"] == j["gen"]["errors"] == 0
        np.testing.assert_allclose(t["losses"], j["losses"], atol=1e-4, rtol=1e-4)
    rounds = [tseen[8 * r: 8 * r + 8] for r in range(3)]
    assert rounds[0] != rounds[2]  # the swapped weights generate other tokens


def test_two_actors_versions_and_threads(tmp_path):
    _, _, tcfg, t_params = _models()
    ec = EngineConfig(max_batch=4, max_seq_len=64, eos_token_id=257)
    engines = [Engine(tcfg, t_params if i == 0 else llama.Llama(tcfg, device="cpu"), ec, device="cpu")
               for i in range(2)]
    engines[1].params.load_state_dict(t_params.state_dict())
    for e in engines:
        e.start()
    threads = [e._thread for e in engines]
    learner = RLLearner(tcfg, TrainConfig(**TC), params=t_params, device="cpu", batch_size=4, seq_len=32)
    try:
        reports = RLLoop(engines, learner, _prompts(), _reward, str(tmp_path), max_tokens=12,
                         temperature=0.9).run(3)
        assert [r["weights_version"] for r in reports] == [1, 2, 3]
        for r in reports:
            assert r["episodes"] == 8 and r["gen"]["errors"] == 0 and len(r["losses"]) == 2
        losses = [x for r in reports for x in r["losses"]]
        assert np.isfinite(losses).all()
        for e, th in zip(engines, threads):
            assert e.weights_version == 3 and e.error is None and e._thread is th and th.is_alive()
        probe = _prompts(1, 9)[0]
        served = [e.generate(probe, max_tokens=8, temperature=0.0) for e in engines]
    finally:
        for e in engines:
            e.stop()
    fresh = llama.Llama(tcfg, device="cpu")
    fresh.load_state_dict(learner.snapshot_params())
    ref = Engine(tcfg, fresh, ec, device="cpu")
    ref.start()
    try:
        assert served[0] == served[1] == ref.generate(probe, max_tokens=8, temperature=0.0)
    finally:
        ref.stop()
