"""Quantized weights in a serving gang of the port against the JAX package,
on the CPU: int4 and w8a8 shards, and the row-parallel w8a8 product.

For every leaf of int4 (quantize4_params) and w8a8 (int8 quantize_params
under quant_activations) llama trees, f32, rank r's shard (sharding.
shard_params, and bridge.shard_from_jax) is byte for byte JAX's
addressable shard under shard_tree on the device of rank r of an
in-process data=2 x tensor=2 CPU mesh, on two configurations: the dims of
tests/test_sharded_serving.py's per-shard kernel test (dim 256, head_dim
64, hidden 512), where w_down is row-parallel, and CONFIGS["tiny"], where
sharding.q4_row_parallel keeps its w_down whole (JAX stores it sharded and
gathers it at every product: the port's whole leaf is JAX's global array).
quantize4 of a rank's dense slice is the slice of JAX's quantize4, byte for
byte, and an HF directory loads at int4 as each rank's shard. Two gloo
processes run the row-parallel w8a8 w_down (each rank's contracting slice,
the rows' amax all-reduced, the s32 partials summed before the scales):
bit for bit JAX's qeinsum_w8a8 on the whole operands, where a local amax
and scaled partials summed both fail the same assertion.
"""
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substratus_tpu.models import llama as jllama
from substratus_tpu.ops.quant import qeinsum_w8a8 as j_qeinsum_w8a8
from substratus_tpu.ops.quant import quantize as j_quantize
from substratus_tpu.ops.quant import quantize_params as j_quantize_params
from substratus_tpu.ops.quant4 import quantize4 as j_quantize4
from substratus_tpu.ops.quant4 import quantize4_params as j_quantize4_params
from substratus_tpu.parallel import mesh as jmesh
from substratus_tpu.parallel import sharding as jsharding
from substratus_tpu_torch.bridge import params_from_jax, shard_from_jax
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.ops.quant4 import quantize4
from substratus_tpu_torch.parallel import mesh, sharding

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROW_DIMS = dict(dim=256, n_heads=4, n_kv_heads=4, head_dim=64, hidden_dim=512)  # tests/test_sharded_serving.py:90-93
CONFIGS = {"row-parallel": ROW_DIMS, "tiny": {}}


def _cfgs(dims):
    jcfg = jllama.CONFIGS["tiny"].replace(vocab_size=258, dtype=jnp.float32, **dims)
    cfg = llama.CONFIGS["tiny"].replace(vocab_size=258, dtype=torch.float32, **dims)
    return jcfg, cfg


def _jax_tree(jcfg, mode):
    dense = jllama.init_params(jcfg, jax.random.key(0))
    if mode == "int4":
        return dense, j_quantize4_params(dense, jllama.quant_contracting(jcfg))
    return dense, j_quantize_params(dense, jllama.quant_contracting(jcfg))


def _jax_mesh():
    return jmesh.build_mesh(data=2, tensor=2, devices=jax.devices()[:4])


def _jax_rank_view(tree, jcfg, jm, rank):
    """Each leaf of `tree` under sharding_tree's shardings (SERVE_RULES) on
    `jm`: the block on device `rank` (the port's layout: data-major), as
    numpy."""
    shardings = jsharding.sharding_tree(tree, jm, jllama.param_logical_axes(jcfg), jsharding.SERVE_RULES)
    dev = jm.devices.reshape(-1)[rank]
    return jax.tree.map(lambda x, s: np.asarray(x)[s.devices_indices_map(x.shape)[dev]], tree, shardings)


@pytest.mark.parametrize("mode", ["int4", "w8a8"])
@pytest.mark.parametrize("dims", list(CONFIGS), ids=list(CONFIGS))
def test_quantized_shards_equal_jax_shard_tree(dims, mode):
    """Every leaf, all four ranks: shard_params of the port's copy of JAX's
    tree and shard_from_jax equal JAX's addressable shard, byte for byte;
    an int4 leaf q4_row_parallel keeps whole (tiny's w_down) equals JAX's
    global array and holds JAX's shard as its block. The shards load into
    shard_model's layout, with down_whole where w_down is whole."""
    jcfg, cfg = _cfgs(CONFIGS[dims])
    _, tree = _jax_tree(jcfg, mode)
    jm = _jax_mesh()
    state = params_from_jax(jax.device_get(tree))
    whole = llama.Llama(cfg.replace(quant_activations=mode == "w8a8"), device="cpu",
                        quantize="int4" if mode == "int4" else "int8")
    whole.load_state_dict(state)
    kept_whole = dims == "tiny" and mode == "int4"
    assert llama.down_kept_whole(cfg, 2, "int4") == (dims == "tiny")
    for rank in range(4):
        m = mesh.build_mesh(data=2, tensor=2, world=4, rank=rank)
        want = params_from_jax(_jax_rank_view(tree, jcfg, jm, rank))
        got = sharding.shard_params(state, llama.param_logical_axes(cfg), m)
        bridged = shard_from_jax(jax.device_get(tree), cfg, m)
        assert set(got) == set(want) == set(bridged)
        for name, value in want.items():
            if not torch.is_tensor(value):
                assert got[name] == value, name
                continue
            if kept_whole and ".w_down." in name:
                # JAX's shard is a block of its global array, gathered at
                # every product; the port's leaf is that array.
                torch.testing.assert_close(got[name], state[name], rtol=0, atol=0, msg=name)
                assert got[name].shape != value.shape or name.endswith("scale"), name
            else:
                torch.testing.assert_close(got[name], value, rtol=0, atol=0, msg=f"{name} rank {rank}")
            assert bridged[name].is_contiguous() and torch.equal(bridged[name], got[name]), name
        m.groups["tensor"] = None
        local = llama.shard_model(whole, m)
        assert local.tp.down_whole == kept_whole and local.tp.index == rank % 2
        for name, value in local.state_dict().items():
            if torch.is_tensor(value):
                torch.testing.assert_close(value, got[name], rtol=0, atol=0, msg=name)


def test_quantize4_of_a_slice_is_the_slice_of_jax_quantize4():
    """Row-parallel dims: for every int4 weight whose spec shards it, rank
    r's dense slice quantized by the port's quantize4 is, byte for byte,
    rank r's shard of JAX's quantize4 of the whole weight (its slices are
    whole scale groups), so a rank may quantize its slice at load."""
    jcfg, cfg = _cfgs(ROW_DIMS)
    dense, tree = _jax_tree(jcfg, "int4")
    jm = _jax_mesh()
    contracting = llama._layer_contracting(cfg)
    for rank in (0, 3):
        q_shard = _jax_rank_view(tree, jcfg, jm, rank)
        d_shard = _jax_rank_view(dense, jcfg, jm, rank)
        checked = 0
        for name, axes in contracting.items():
            if not axes:
                continue
            for layer in range(cfg.n_layers):
                sliced = torch.from_numpy(np.array(d_shard["layers"][name][layer]))
                got = quantize4(sliced, axes)
                want = q_shard["layers"][name]
                assert np.array_equal(got.packed.numpy(), np.asarray(want.packed[layer])), name
                assert np.array_equal(got.scale.numpy(), np.asarray(want.scale[layer])), name
                checked += 1
        assert checked == 7 * cfg.n_layers
        j_whole = j_quantize4(dense["lm_head"], (0,))
        got = quantize4(torch.from_numpy(np.array(d_shard["lm_head"])), (0,))
        assert np.array_equal(got.packed.numpy(), np.asarray(q_shard["lm_head"].packed))
        assert np.array_equal(np.asarray(j_whole.packed)[:, (rank % 2) * 129:(rank % 2 + 1) * 129],
                              got.packed.numpy())


@pytest.mark.parametrize("dims", list(CONFIGS), ids=list(CONFIGS))
def test_hf_directory_loads_int4_as_each_ranks_shard(tmp_path, dims):
    """An HF directory loaded at int4 as a rank's shard, a layer at a time
    (no rank holds more than one dense layer), equals shard_model of the
    whole model loaded at int4, bit for bit, for every rank of data=2 x
    tensor=2; down_whole as the configuration asks."""
    from substratus_tpu_torch.load.hf import load_pretrained
    from substratus_tpu_torch.tools.ckpt_writer import write_hf

    _, cfg = _cfgs(CONFIGS[dims])
    write_hf(str(tmp_path / "hf"), llama.init_params(cfg, seed=3, device="cpu"))
    _, whole = load_pretrained(str(tmp_path / "hf"), dtype=torch.float32, device="cpu", quantize="int4")
    for rank in range(4):
        m = mesh.build_mesh(data=2, tensor=2, world=4, rank=rank)
        m.groups["tensor"] = None
        local_cfg, shard = load_pretrained(str(tmp_path / "hf"), dtype=torch.float32, device="cpu",
                                           quantize="int4", mesh_for=lambda _: m)
        want = llama.shard_model(whole, m)
        assert local_cfg == want.cfg and shard.tp.down_whole == want.tp.down_whole == (dims == "tiny")
        got, ref = shard.state_dict(), want.state_dict()
        assert set(got) == set(ref)
        for name, value in ref.items():
            if torch.is_tensor(value):
                torch.testing.assert_close(got[name], value, rtol=0, atol=0, msg=name)


ROW_WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from substratus_tpu_torch.ops import quant
from substratus_tpu_torch.parallel.sharding import TensorShard

rank, port, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
x = torch.from_numpy(np.load(f"{d}/x.npy"))
q = torch.from_numpy(np.load(f"{d}/q.npy"))
s = torch.from_numpy(np.load(f"{d}/s.npy"))
c = x.shape[-1] // 2
xs, w = x[..., rank * c:(rank + 1) * c].contiguous(), quant.QTensor(q[rank * c:(rank + 1) * c].contiguous(), s)
tp = TensorShard(None, 2, rank, 258, vocab_sharded=False, mlp_sharded=True)
out = {"port": quant.qeinsum_w8a8("bsm,md->bsd", xs, w, torch.float32, tp=tp)}

# Planted: each rank's own amax (the reduce skipped).
real_amax = quant.w8a8_row_amax
reduce = tp.reduce
tp.reduce = lambda t, op=dist.ReduceOp.SUM: t if op == dist.ReduceOp.MAX else reduce(t, op)
out["local_amax"] = quant.qeinsum_w8a8("bsm,md->bsd", xs, w, torch.float32, tp=tp)
tp.reduce = reduce
# Planted: the global scale, each rank's partial scaled, then the sum.
amax = tp.reduce(quant.w8a8_row_amax(xs), op=dist.ReduceOp.MAX)
xq, ascale = quant.w8a8_quantize_scaled(xs, amax)
part = quant.w8a8_matmul_plain(xq.reshape(-1, c), w.q)
y = quant.w8a8_scale(part, ascale.reshape(-1), s.reshape(-1), torch.float32)
out["scaled_partials"] = tp.reduce(y).reshape(out["port"].shape)
np.savez(f"{d}/r{rank}.npz", **{k: v.numpy() for k, v in out.items()})
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_row_parallel_w8a8_is_bit_for_bit_jax(tmp_path):
    """w_down at the row-parallel dims' MLP width (512 over 2 ranks), f32:
    both ranks' outputs equal JAX's qeinsum_w8a8 on the whole operands bit
    for bit; a local amax and scaled partials summed both differ."""
    rng = np.random.default_rng(24)
    x = (rng.standard_normal((2, 5, 512)) * np.linspace(0.2, 3.0, 512)).astype(np.float32)
    w = rng.standard_normal((512, 256)).astype(np.float32) / 20
    jw = j_quantize(jnp.asarray(w), (0,))
    want = np.asarray(j_qeinsum_w8a8("bsm,md->bsd", jnp.asarray(x), jw, jnp.float32))
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "q.npy", np.asarray(jw.q))
    np.save(tmp_path / "s.npy", np.asarray(jw.scale))
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", ROW_WORKER, str(r), str(port), str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    for r in range(2):
        got = np.load(tmp_path / f"r{r}.npz")
        assert np.array_equal(got["port"], want), np.abs(got["port"] - want).max()
        for planted in ("local_amax", "scaled_partials"):
            assert not np.array_equal(got[planted], want), planted
