"""Head dims the attention kernels are not built for (ops/headdim.py): the
padded route against the plain versions at the true D, on the CPU.

A head dim of 20, 80, 96 or 192 runs padded to 32, 128, 128 and 256: zero columns
of q and k change no score, v's extra columns are sliced off the output,
and the softmax scale stays the true D^-0.5. On the CPU the wrappers run
the same route over the plain versions, so what is held here is the
route's arithmetic: every attention wrapper (the flash forward and its
LSE, dQ, dK/dV and the autograd function, the cached flash, the decode
attention and the fused decode over a cache laid out padded, f32 and
int8) against its plain version at the true D, within 1e-5 of
the output's scale (another summation length, nothing else). Then a tiny
OPT at head dim 20 served from the padded dense cache matches the JAX
engine token for token; a llama config with a group of 3, an int8 cache
and max_seq_len 1022 is laid out for the split design (rows rounded to
1024, head dim 16 padded to 64) and matches the JAX int8 engine; a
llama at head dim 256 (built) and 192 (padded to 256) matches the JAX
dense engine token for token and the JAX trainer's LoRA steps; and a head
dim above 256 is refused when the engine or the trainer is built.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substratus_tpu.models import llama as jllama
from substratus_tpu.models import opt as jopt
from substratus_tpu.parallel.mesh import build_mesh
from substratus_tpu.serve.engine import Engine as JEngine
from substratus_tpu.serve.engine import EngineConfig as JEngineConfig
from substratus_tpu.serve.engine import Request as JRequest
from substratus_tpu.train.trainer import TrainConfig as JTrainConfig
from substratus_tpu.train.trainer import Trainer as JTrainer
from substratus_tpu_torch.bridge import lora_from_jax, params_from_jax
from substratus_tpu_torch.models import llama, opt
from substratus_tpu_torch.ops import flash_attention as fa
from substratus_tpu_torch.ops.decode_attention import (
    decode_attention, decode_attention_plain, pack_fragment, update_cache_and_attend)
from substratus_tpu_torch.ops.fused_decode import (
    cache_layout, decode_design, fused_decode_attention, fused_decode_attention_plain)
from substratus_tpu_torch.ops.headdim import head_dim_route, pad_head, padded_head_dim
from substratus_tpu_torch.ops.quant import quantize_kv
from substratus_tpu_torch.serve.engine import Engine, EngineConfig, Request
from substratus_tpu_torch.train.trainer import TrainConfig, Trainer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-5  # relative to the output's largest value: f32 sums of another length
EOS = 257


def _close(got, ref):
    scale = max(1.0, ref.abs().max().item())
    assert got.shape == ref.shape
    assert (got - ref).abs().max().item() <= TOL * scale


def _randn(r, *shape):
    return torch.from_numpy(r.standard_normal(shape).astype(np.float32))


def test_routes_and_layouts():
    """The padded size of each head dim, the startup lines' names, and the
    dense cache's layout by design."""
    assert [padded_head_dim(d) for d in (8, 16, 20, 48, 64, 80, 96, 128, 160, 192, 256, 288)] == [
        16, 16, 32, 64, 64, 128, 128, 128, 256, 256, 256, None]
    assert head_dim_route(80) == "head_dim 80 padded to 128" and head_dim_route(128) == "head_dim 128"
    assert head_dim_route(192) == "head_dim 192 padded to 256" and head_dim_route(256) == "head_dim 256"
    # 256: the rows design at groups 1, 2, 4, 8; the split design's instance at 256 at any other
    assert decode_design(256, 1024, False, 1) == decode_design(256, 1022, True, 8) == "rows"
    assert decode_design(256, 1024, False, 3) == "split" and cache_layout(192, 1022, True, 3) == (1024, 256)
    assert cache_layout(192, 1022, True, 2) == (1022, 256)
    assert cache_layout(80, 1024, False, 1) == (1024, 128)  # opt-2.7b: the split design at 128
    assert cache_layout(80, 1022, True, 1) == (1022, 128)  # int8, S % 4: the rows design takes group 1
    assert cache_layout(128, 1022, True, 3) == (1024, 128)  # int8, S % 4, group 3: split, rows rounded up
    assert cache_layout(20, 64, False, 3) == (64, 64)  # head dim 32 at a group of 3: split at 64
    assert cache_layout(20, 64, False, 2) == (64, 32)  # the rows design at 32
    assert decode_design(128, 1022, True, 3) == "split" and decode_design(128, 1022, True, 1) == "rows"
    assert decode_design(128, 1024, True, 3) == decode_design(64, 64, False, 3) == "split"
    assert decode_design(32, 64, False, 2) == "rows"
    with pytest.raises(ValueError, match="above 256"):
        cache_layout(288, 64, False, 1)


@pytest.mark.parametrize("d", [20, 80, 96, 192])
def test_padded_route_matches_plain(d):
    """Every wrapper at head dim d against its plain version at d."""
    r = np.random.default_rng(d)
    b, s, h, kh = 2, 40, 4, 2
    dp = padded_head_dim(d)
    q, do = _randn(r, b, s, h, d), _randn(r, b, s, h, d)
    k, v = _randn(r, b, s, kh, d), _randn(r, b, s, kh, d)

    # The flash forward with its LSE, and the backward wrappers.
    out, lse = fa.flash_attention(q, k, v, True, return_lse=True)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, True, return_lse=True)
    _close(out, ref)
    _close(lse, ref_lse)
    delta = fa.bwd_delta(ref, do)
    got = (fa.flash_attention_bwd_dq(q, k, v, do, lse, delta), *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta))
    want = (fa._bwd_dq_plain(q, k, v, do, ref_lse, delta, True, d**-0.5),
            *fa._bwd_dkv_plain(q, k, v, do, ref_lse, delta, True, d**-0.5))
    for g, w in zip(got, want):
        _close(g, w)
    # The padded run itself: its extra output columns and gradients are 0.
    padded = [pad_head(t, dp) for t in (q, k, v, do)]
    assert padded[0].shape[-1] == dp
    assert fa.flash_attention_plain(*padded[:3], True, scale=d**-0.5)[..., d:].abs().max().item() == 0.0
    # Autograd through FlashAttention: the backward's slices.
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    grads = torch.autograd.grad(fa.flash_attention(*leaves, True), leaves, do)
    for g, w in zip(grads, want):
        _close(g, w)

    # The cached flash, the decode attention and the fused decode over a
    # cache laid out at dp (zero columns), against the plain versions over
    # the cache at d.
    sk = 48
    ck, cv = _randn(r, b, kh, sk, d), _randn(r, b, kh, sk, d)
    pos = torch.tensor([[10 + i for i in range(5)], [40 + i for i in range(5)]])
    qc = _randn(r, b, 5, h, d)
    _close(fa.flash_cached_attention(qc, pad_head(ck, dp), pad_head(cv, dp), pos),
           fa.flash_cached_attention_plain(qc, ck, cv, pos))
    q1 = _randn(r, b, 1, h, d)
    dpos = torch.tensor([7, sk - 1])
    (kq, ks), (vq, vs) = quantize_kv(ck), quantize_kv(cv)
    (kqp, ksp), (vqp, vsp) = quantize_kv(pad_head(ck, dp)), quantize_kv(pad_head(cv, dp))
    assert torch.equal(ks, ksp) and torch.equal(kqp[..., :d], kq) and not kqp[..., d:].any()  # bit for bit
    ks, vs = ks[..., 0], vs[..., 0]
    _close(decode_attention(q1, pad_head(ck, dp), pad_head(cv, dp), dpos), decode_attention_plain(q1, ck, cv, dpos))
    _close(decode_attention(q1, kqp, vqp, dpos, ks, vs), decode_attention_plain(q1, kq, vq, dpos, ks, vs))
    nk, nv = _randn(r, b, kh, 1, d), _randn(r, b, kh, 1, d)
    kp, vp = pad_head(ck, dp), pad_head(cv, dp)
    got, kp, vp = fused_decode_attention(q1, pad_head(nk, dp), pad_head(nv, dp), kp, vp, dpos)
    want, ck2, cv2 = fused_decode_attention_plain(q1, nk, nv, ck.clone(), cv.clone(), dpos)
    _close(got, want)
    assert torch.equal(kp[..., :d], ck2) and torch.equal(vp[..., :d], cv2) and not kp[..., d:].any()

    # update_cache_and_attend pads the rows it writes; pack_fragment the
    # prefill fragment (int8: the same scales, zero columns).
    for dtype in (torch.float32, torch.int8):
        cache = llama.init_cache(llama.CONFIGS["tiny"].replace(dim=h * d, n_heads=h, n_kv_heads=kh,
                                                               dtype=torch.float32),
                                 b, sk, dtype=dtype, device="cpu", padded=True)
        assert cache["k"].shape[-1] == cache_layout(d, sk, dtype == torch.int8, h // kh)[1] >= dp
        layer = {name: t[0] for name, t in cache.items()}
        frag = {"k": _randn(r, 1, b, sk, kh, d), "v": _randn(r, 1, b, sk, kh, d)}
        packed, plain = pack_fragment(cache, frag), pack_fragment({"k": torch.zeros(1), "v": torch.zeros(1)}, frag)
        if dtype == torch.int8:
            assert torch.equal(packed["k_scale"], quantize_kv(frag["k"].transpose(-3, -2))[1][..., 0])
        assert not packed["k"][..., d:].any() and packed["k"].shape[-1] == cache["k"].shape[-1]
        if dtype == torch.float32:
            assert torch.equal(packed["k"][..., :d], plain["k"])
        attn, _ = update_cache_and_attend(layer, q1, nk.transpose(1, 2), nv.transpose(1, 2), dpos[:, None])
        assert attn.shape == q1.shape and torch.isfinite(attn).all()


def _opt_weights():
    jcfg = jopt.CONFIGS["tiny-opt"].replace(vocab_size=258, dim=80, dtype=jnp.float32)
    tcfg = opt.CONFIGS["tiny-opt"].replace(vocab_size=258, dim=80, dtype=torch.float32)
    j_params = jopt.init_params(jcfg, jax.random.key(0))
    t_params = opt.OPT(tcfg, device="cpu")
    t_params.load_state_dict(params_from_jax(jax.device_get(j_params)))
    return jcfg, j_params, tcfg, t_params


def _run(engine, req_cls, prompts, max_tokens=10):
    reqs = [engine.submit(req_cls(list(p), max_tokens=max_tokens, temperature=0.0)) for p in prompts]
    engine.start()
    try:
        outs = []
        for req in reqs:
            toks = []
            while (tok := req.out.get(timeout=300)) is not None:
                toks.append(tok)
            outs.append((toks, req.finish_reason))
        return outs
    finally:
        engine.stop()


_r = np.random.default_rng(1)
PROMPTS = [[256] + _r.integers(0, 256, n - 1).tolist() for n in (3, 11, 20, 37)]


def test_tiny_opt_at_head_dim_20_matches_jax_engine():
    """OPT at head dim 20 (dim 80, 4 heads) from the dense cache laid out
    at 32, chunks included (max_prefill_len 16), token for token the JAX
    engine's, synchronous and overlapped."""
    jcfg, j_params, tcfg, t_params = _opt_weights()
    assert tcfg.head_size == 20
    ec = dict(max_batch=4, max_seq_len=64, max_prefill_len=16, eos_token_id=EOS)
    want = _run(JEngine(jcfg, j_params, JEngineConfig(overlap=False, **ec), model=jopt), JRequest, PROMPTS)
    assert [len(t) for t, _ in want] == [10] * 4
    for overlap in (False, None):
        engine = Engine(tcfg, t_params, EngineConfig(overlap=overlap, **ec), device="cpu", padded_cache=True)
        assert engine.cache["k"].shape[-1] == 32 and "head_dim 20 padded to 32" in engine.attention_route()
        assert _run(engine, Request, PROMPTS) == want, overlap
        assert engine.stats["prefill_chunks"] > 0 and engine.stats["prefills"] > 0


def test_group_of_3_int8_cache_1022_rows_matches_jax_engine():
    """llama with a group of 3 (6 heads on 2 kv heads, head dim 16), an
    int8 dense cache and max_seq_len 1022: laid out for the split design
    (1024 rows at head dim 64), its greedy tokens the JAX int8 engine's."""
    jcfg = jllama.CONFIGS["tiny"].replace(vocab_size=258, dim=96, n_heads=6, n_kv_heads=2, max_seq_len=1022,
                                          dtype=jnp.float32)
    tcfg = llama.CONFIGS["tiny"].replace(vocab_size=258, dim=96, n_heads=6, n_kv_heads=2, max_seq_len=1022,
                                         dtype=torch.float32)
    j_params = jllama.init_params(jcfg, jax.random.key(0))
    t_params = llama.Llama(tcfg, device="cpu")
    t_params.load_state_dict(params_from_jax(jax.device_get(j_params)))
    ec = dict(max_batch=3, max_seq_len=1022, max_prefill_len=16, eos_token_id=EOS, kv_cache_dtype="int8",
              kv_layout="dense")
    assert decode_design(16, 1022, True, 3) == "split" and cache_layout(16, 1022, True, 3) == (1024, 64)
    want = _run(JEngine(jcfg, j_params, JEngineConfig(overlap=False, **ec)), JRequest, PROMPTS[:3])
    engine = Engine(tcfg, t_params, EngineConfig(**ec), device="cpu", padded_cache=True)
    assert tuple(engine.cache["k"].shape[3:]) == (1024, 64) and engine.cache["k_scale"].shape[3] == 1024
    assert _run(engine, Request, PROMPTS[:3]) == want


def test_head_dim_above_128_refused_when_built():
    """Above 128 the kernels are built at 256 (129-255 padded to it), so
    head dim 160 builds; above 256, head dim 288: the dense engine and the
    trainer's flash attention refuse it when built, naming the limit; the
    paged engine (no kernel reads its pages) and the trainer at attn_impl
    plain build."""
    cfg = llama.CONFIGS["tiny"].replace(dim=320, n_heads=2, n_kv_heads=2, dtype=torch.float32)
    assert cfg.head_size == 160
    engine = Engine(cfg, llama.init_params(cfg, seed=0, device="cpu"),
                    EngineConfig(kv_layout="dense", max_seq_len=64), device="cpu", padded_cache=True)
    assert engine.cache["k"].shape[-1] == 256 and "head_dim 160 padded to 256" in engine.attention_route()
    cfg = llama.CONFIGS["tiny"].replace(dim=576, n_heads=2, n_kv_heads=2, dtype=torch.float32)
    assert cfg.head_size == 288
    params = llama.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="head_dim 288 is above 256"):
        Engine(cfg, params, EngineConfig(kv_layout="dense", max_seq_len=64), device="cpu")
    assert Engine(cfg, params, EngineConfig(kv_layout="paged", max_seq_len=64), device="cpu").paged
    with pytest.raises(ValueError, match="head_dim 288 is above 256"):
        Trainer(cfg, TrainConfig(), params=params)
    Trainer(cfg.replace(attn_impl="plain"), TrainConfig(), params=params)


def _wide_heads(d):
    """tiny at head dim d (4 heads on 2 kv heads), f32, in both packages."""
    jcfg = jllama.CONFIGS["tiny"].replace(vocab_size=258, head_dim=d, dtype=jnp.float32)
    tcfg = llama.CONFIGS["tiny"].replace(vocab_size=258, head_dim=d, dtype=torch.float32)
    return jcfg, tcfg


@pytest.mark.parametrize("d", [192, 256])
def test_dense_engine_at_head_dim_above_128_matches_jax_engine(d):
    """The dense engine at head dim 256 (built) and 192 (the cache laid
    out at 256), short prompts and chunks, int8 and model-dtype caches:
    greedy tokens the JAX dense engine's, synchronous and overlapped."""
    jcfg, tcfg = _wide_heads(d)
    j_params = jllama.init_params(jcfg, jax.random.key(0))
    t_params = llama.Llama(tcfg, device="cpu")
    t_params.load_state_dict(params_from_jax(jax.device_get(j_params)))
    for cache_dtype in ("model", "int8"):
        ec = dict(max_batch=4, max_seq_len=64, max_prefill_len=16, eos_token_id=EOS, kv_layout="dense",
                  kv_cache_dtype=cache_dtype)
        want = _run(JEngine(jcfg, j_params, JEngineConfig(overlap=False, **ec)), JRequest, PROMPTS)
        assert [len(t) for t, _ in want] == [10] * 4
        for overlap in (False, None):
            engine = Engine(tcfg, t_params, EngineConfig(overlap=overlap, **ec), device="cpu", padded_cache=True)
            assert engine.cache["k"].shape[-1] == 256 and f"head_dim {d}" in engine.attention_route()
            assert _run(engine, Request, PROMPTS) == want, (cache_dtype, overlap)
            assert engine.stats["prefill_chunks"] > 0


@pytest.mark.parametrize("d", [192, 256])
def test_lora_steps_at_head_dim_above_128_match_jax_trainer(d):
    """Three LoRA steps at head dim d through the trainer's flash attention
    (the plain version at 256 on the CPU: 192 padded) against the JAX
    trainer from the same weights and adapters: losses and adapters."""
    jcfg, tcfg = _wide_heads(d)
    tc = dict(learning_rate=2e-4, warmup_steps=1, total_steps=10, lora_rank=4)
    jt = JTrainer(jcfg, JTrainConfig(remat=False, **tc), build_mesh(devices=jax.devices()[:1]))
    tt = Trainer(tcfg, TrainConfig(remat=False, **tc), params=llama.Llama(tcfg, device="cpu"))
    tt.params.load_state_dict(params_from_jax(jax.device_get(jt.params)))
    tt.lora.load_state_dict(lora_from_jax(jax.device_get(jt.lora)))
    rng = np.random.default_rng(d)
    batch = {"tokens": rng.integers(0, 256, (2, 24)).astype(np.int32), "weights": np.ones((2, 24), np.float32)}
    want = [jt.train_step(batch) for _ in range(3)]
    got = [tt.train_step(batch) for _ in range(3)]
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert got[2] < got[0]
    ref = lora_from_jax(jax.device_get(jt.lora))
    for name, t in tt.lora.state_dict().items():
        np.testing.assert_allclose(t.float().numpy(), ref[name].numpy(), rtol=2 * 2**-8, atol=1e-5, err_msg=name)
