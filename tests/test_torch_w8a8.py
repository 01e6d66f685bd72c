"""w8a8 (int8 weights x dynamic per-token int8 activations) in the port,
against the JAX package's qeinsum_w8a8 path, on the CPU.

* The activation quantization (w8a8_quantize's plain version, which the
  card kernel csrc/w8a8_quantize.cu repeats) gives the int8 rows and f32
  scales of JAX's formula bit for bit, zero rows, exact halves and bf16
  inputs included.
* qeinsum_w8a8 equals JAX's bit for bit in f32 on every equation the
  model runs (q/k/v, gate/up/down, the lm_head, the three expert
  einsums), on permuted outputs, and takes JAX's fallbacks (wo's two
  contracted dims, a contracted dim that is not x's last, a scale that
  varies along the contracted dim, an int4 or a dense weight) to the
  weight-only qeinsum, never quantizing the activation there.
* w8a8_matmul's plain version is the exact s32 product on strided row
  views (an expert's slice), and its epilogue is JAX's order.
* The tiny and tiny-moe models (f32, weights quantized by JAX's
  quantize_params and carried by the bridge, the config by
  bridge.config_from_jax) give JAX's forward logits within 1e-5 and its
  greedy decode tokens. JAX jits decode_step, where XLA divides by 127
  as a multiply by the reciprocal (an ulp off at times), so the decode
  logits are held within 1e-4, not bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import greedy_decode

from substratus_tpu.models import llama as jllama
from substratus_tpu.ops import quant as jquant
from substratus_tpu.ops.kvcache import insert_prefill
from substratus_tpu.ops.quant4 import quantize4 as j_quantize4
from substratus_tpu_torch import bridge
from substratus_tpu_torch.bridge import config_from_jax, params_from_jax
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.ops import quant
from substratus_tpu_torch.ops.decode_attention import pack_fragment
from substratus_tpu_torch.ops.quant4 import Q4Tensor


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_quantize_activations(x):
    """JAX's qeinsum_w8a8 lines that quantize the activation, unjitted."""
    x = jnp.asarray(x)
    amax = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=-1, keepdims=True)
    ascale = jnp.where(amax == 0, 1.0, amax / 127.0)
    xq = jnp.clip(jnp.round(x.astype(jnp.float32) / ascale), -127, 127).astype(jnp.int8)
    return np.asarray(xq), np.asarray(ascale)


def test_activation_quantization_bit_for_bit():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 7, 4096)).astype(np.float32) * rng.uniform(0.01, 50, (6, 7, 1)).astype(np.float32)
    x[0, 0] = 0.0  # a zero row: scale 1, every value 0
    x[1, 1, :3] = [127.0, 63.5, -0.5]  # exact halves of the step (127 / 127 = 1): half to even
    x[1, 1, 3:] = 0.0
    cases = [x, x.astype(jnp.bfloat16).astype(np.float32)]
    for case in cases:
        want_q, want_s = _jax_quantize_activations(case)
        got_q, got_s = quant.w8a8_quantize(torch.from_numpy(case))
        assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32 and tuple(got_s.shape) == (6, 7, 1)
        np.testing.assert_array_equal(got_q.numpy(), want_q)
        np.testing.assert_array_equal(got_s.numpy(), want_s)
    assert quant.w8a8_quantize(torch.from_numpy(x))[0][1, 1, :3].tolist() == [127, 64, 0]
    bf = torch.from_numpy(cases[1]).to(torch.bfloat16)  # the card's activations: bf16 in, the same bytes out
    for got, want in zip(quant.w8a8_quantize(bf), quant.w8a8_quantize(torch.from_numpy(cases[1]))):
        assert torch.equal(got, want)


def _weights(wshape, contracting, rng, kind="int8"):
    w = rng.standard_normal(wshape).astype(np.float32)
    if kind == "int4":
        jw = j_quantize4(jnp.asarray(w), contracting)
        tw = Q4Tensor.empty(wshape, contracting)
        tw.load_state_dict({k[1:]: v for k, v in bridge._entries(jw).items()})
        return jw, tw
    if kind == "dense":
        return jnp.asarray(w), torch.from_numpy(w)
    jw = jquant.quantize(jnp.asarray(w), contracting)
    return jw, quant.QTensor(torch.from_numpy(np.array(jw.q)), torch.from_numpy(np.array(jw.scale)))


# (equation, x shape, w shape, the weight's contracting dims, kind, w8a8 taken)
EQUATIONS = [
    ("bsd,dhk->bshk", (2, 3, 64), (64, 4, 16), (0,), "int8", True),  # wq/wk/wv
    ("bsd,dm->bsm", (2, 3, 64), (64, 128), (0,), "int8", True),  # w_gate/w_up
    ("bsm,md->bsd", (2, 3, 128), (128, 64), (0,), "int8", True),  # w_down
    ("bsd,dv->bsv", (2, 5, 64), (64, 258), (0,), "int8", True),  # the lm_head
    ("bsd,edm->bsem", (2, 3, 64), (4, 64, 32), (1,), "int8", True),  # serving's experts
    ("bsem,emd->bsed", (2, 3, 4, 32), (4, 32, 64), (1,), "int8", True),
    ("ebcd,edm->ebcm", (4, 2, 3, 64), (4, 64, 32), (1,), "int8", True),  # training's capacity dispatch
    ("ebcm,emd->ebcd", (4, 2, 3, 32), (4, 32, 64), (1,), "int8", True),
    ("bsd,dhk->bhsk", (2, 3, 64), (64, 4, 16), (0,), "int8", True),  # permuted outputs
    ("bsd,dhk->hkbs", (2, 3, 64), (64, 4, 16), (0,), "int8", True),
    ("bsd,hdk->bshk", (2, 3, 64), (4, 64, 16), (1,), "int8", True),  # the contracted dim not first in w
    ("bshk,hkd->bsd", (2, 3, 4, 16), (4, 16, 64), (0, 1), "int8", False),  # wo: two contracted dims
    ("bds,dm->bsm", (2, 64, 3), (64, 128), (0,), "int8", False),  # the contracted dim not x's last
    ("bsd,dm->bsm", (2, 3, 64), (64, 128), (1,), "int8", False),  # a scale along the contracted dim
    ("bsd,dm->bsm", (2, 3, 64), (64, 128), (0,), "int4", False),
    ("bsd,dm->bsm", (2, 3, 64), (64, 128), (0,), "dense", False),
]


def test_qeinsum_w8a8_matches_jax_and_its_fallbacks(monkeypatch):
    rng = np.random.default_rng(1)
    calls = []
    real = quant.w8a8_quantize
    monkeypatch.setattr(quant, "w8a8_quantize", lambda x: calls.append(x.shape) or real(x))
    for eq, xshape, wshape, contracting, kind, takes in EQUATIONS:
        x = rng.standard_normal(xshape).astype(np.float32)
        jw, tw = _weights(wshape, contracting, rng, kind)
        want = np.asarray(jquant.qeinsum_w8a8(eq, jnp.asarray(x), jw, jnp.float32))
        calls.clear()
        got = quant.qeinsum_w8a8(eq, torch.from_numpy(x), tw, torch.float32)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape, eq
        assert bool(calls) == takes, (eq, kind)
        if takes:  # the s32 sums are exact and the epilogue is JAX's order
            np.testing.assert_array_equal(got.numpy(), want, err_msg=eq)
            assert not np.array_equal(want, np.asarray(jquant.qeinsum(eq, jnp.asarray(x), jw, jnp.float32)))
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5, err_msg=eq)
            np.testing.assert_array_equal(got.numpy(), quant.qeinsum(eq, torch.from_numpy(x), tw, torch.float32)
                                          .numpy())


def test_matmul_plain_is_exact_on_row_views():
    """The plain product on an expert's strided slices: the exact s32 sum
    (against int64 numpy), written into a strided output view, raw or
    through the epilogue (float(y) * ascale * wscale, then the cast)."""
    rng = np.random.default_rng(2)
    E, C, N = 3, 4096, 48
    xq = torch.from_numpy(rng.integers(-127, 128, (2, 5, E, C)).astype(np.int8))
    ascale = torch.from_numpy(rng.uniform(0.01, 1, (2, 5, E)).astype(np.float32))
    wq = torch.from_numpy(rng.integers(-127, 128, (C, N)).astype(np.int8))
    wscale = torch.from_numpy(rng.uniform(0.001, 0.1, N).astype(np.float32))
    xq[0, 0, 1] = 127  # one sum of 127^2 x 4096 (66 million): past f32's exact integers
    wq[:, 7] = 127
    out = torch.zeros((2, 5, E, N), dtype=torch.int32)
    raw = torch.zeros((2, 5, E, N), dtype=torch.int32)
    scaled = torch.zeros((2, 5, E, N), dtype=torch.bfloat16)
    for e in range(E):
        x2 = quant._rows(xq.select(2, e), C)
        assert x2.stride() == (E * C, 1)
        quant.w8a8_matmul(x2, quant._rows(ascale.select(2, e), 1)[:, 0], wq, wscale,
                          quant._rows(raw.select(2, e), N), raw=True)
        quant.w8a8_matmul(x2, quant._rows(ascale.select(2, e), 1)[:, 0], wq, wscale,
                          quant._rows(scaled.select(2, e), N))
        out.select(2, e).copy_(torch.from_numpy(xq.select(2, e).numpy().astype(np.int64)
                                                @ wq.numpy().astype(np.int64)).int())
    assert torch.equal(raw, out) and raw.abs().max() > 2**24
    assert torch.equal(scaled, (out.float() * ascale[..., None] * wscale).to(torch.bfloat16))
    with pytest.raises(ValueError, match="not rows of one stride"):
        quant._rows(xq.permute(1, 0, 2, 3), C)


def _models(name):
    jcfg = jllama.CONFIGS[name].replace(vocab_size=258, dtype=jnp.float32, quant_activations=True)
    dense = jllama.init_params(jcfg, jax.random.key(0))
    j_params = jquant.quantize_params(dense, jllama.quant_contracting(jcfg))
    tcfg = config_from_jax(jcfg)
    t_params = llama.Llama(tcfg, device="cpu", quantize="int8")
    t_params.load_state_dict(params_from_jax(jax.device_get(j_params)))
    return jcfg, j_params, tcfg, t_params


@pytest.fixture(scope="module", params=["tiny", "tiny-moe"])
def models(request):
    return _models(request.param)


def test_config_carries_quant_activations(models):
    jcfg, _, tcfg, t_params = models
    assert tcfg.quant_activations and tcfg.dtype == torch.float32 and tcfg.n_experts == jcfg.n_experts
    assert config_from_jax(jcfg.replace(quant_activations=False)) == tcfg.replace(quant_activations=False)
    assert all(isinstance(m, quant.QTensor) for m in (t_params.layers[0].wq, t_params.layers[0].w_down,
                                                       t_params.lm_head))


def test_forward_logits_match_jax(models, monkeypatch):
    """Logits within 1e-5 of JAX's unjitted forward, and the w8a8 path taken
    by every projection but wo and by the lm_head: 6 a layer + 1."""
    jcfg, j_params, tcfg, t_params = models
    tokens = np.random.default_rng(3).integers(0, 258, (2, 24)).astype(np.int32)
    calls = []
    real = quant.w8a8_quantize
    monkeypatch.setattr(quant, "w8a8_quantize", lambda x: calls.append(x.shape) or real(x))
    want, _ = jllama.forward(j_params, jnp.asarray(tokens), jcfg)
    got, _ = llama.forward(t_params, torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert len(calls) == 6 * tcfg.n_layers + 1
    weight_only, _ = jllama.forward(j_params, jnp.asarray(tokens), jcfg.replace(quant_activations=False))
    assert np.abs(np.asarray(weight_only) - np.asarray(want)).max() > 1e-4  # w8a8 is another function


def test_greedy_decode_matches_jax(models):
    """The prefill and 15 cached decode steps (dense model-dtype cache,
    the decode and the fused plain paths) give JAX's greedy tokens; each
    step's logits within 1e-4 of the JAX jitted decode_step's."""
    jcfg, j_params, tcfg, t_params = models
    prompt = [3, 141, 59, 26, 53, 58, 97, 93, 23]
    want = greedy_decode(jllama, j_params, jcfg, prompt, 16)
    for impl in ("kernel", "fused"):
        cfg = tcfg.replace(decode_attn_impl=impl)
        logits, kv = llama.forward(t_params, torch.tensor([prompt]), cfg)
        cache = llama.init_cache(cfg, 1, 256, device="cpu")
        for key, value in pack_fragment(cache, kv).items():
            cache[key][:, :, :, : value.shape[3]] = value
        jcache = jllama.init_cache(jcfg, 1, 256)
        _, jkv = jllama.forward(j_params, jnp.asarray([prompt], jnp.int32), jcfg)
        jcache = insert_prefill(jcache, jkv, len(prompt))
        out, pos = [int(logits[0, -1].argmax())], len(prompt)
        while len(out) < 16:
            lg, cache = llama.decode_step(t_params, cache, torch.tensor([out[-1]]), torch.tensor([pos]), cfg)
            jlg, jcache = jllama.decode_step(j_params, jcache, jnp.asarray([out[-1]], jnp.int32),
                                             jnp.asarray([pos], jnp.int32), jcfg)
            np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4, rtol=1e-4)
            out.append(int(lg[0].argmax()))
            pos += 1
        assert out == want, impl
