"""The port's parallel/ (rendezvous, mesh, sharding) against the JAX
package's, on the CPU.

world_info reads the operator's environment as JAX's does; build_mesh
gives JAX's sizes and errors over the same counts; the logical rules give
JAX's specs for every leaf of the llama trees; and for every leaf of a
tiny llama (dense and int8 quantize_params, f32) rank r's shard is JAX's
addressable shard on the tensor-axis device r of an in-process CPU mesh
(tensor=2), including leaves that `fit` leaves whole (an odd vocab). The
shards load into the config shard_config gives, and shard_model of the
port's model equals them, as does an HF directory loaded as each rank's
shard a layer at a time (dense and int8); int4 and w8a8 weights shard
(held against JAX's shards in tests/test_torch_gang_quant.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substratus_tpu.models import llama as jllama
from substratus_tpu.ops.quant import quantize_params as j_quantize_params
from substratus_tpu.parallel import distributed as jdist
from substratus_tpu.parallel import mesh as jmesh
from substratus_tpu.parallel import sharding as jsharding
from substratus_tpu_torch.bridge import params_from_jax, shard_from_jax
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.parallel import distributed, mesh, sharding

ENVS = [
    {},
    {"JAX_COORDINATOR_ADDRESS": "10.0.0.1:8476", "JAX_NUM_PROCESSES": "4", "TPU_WORKER_ID": "3"},
    {"JAX_COORDINATOR_ADDRESS": "h:1", "JAX_NUM_PROCESSES": "2", "TPU_WORKER_ID": "worker-1"},
    {"JAX_NUM_PROCESSES": "", "TPU_WORKER_ID": ""},
    {"JAX_COORDINATOR_ADDRESS": "h:1", "JAX_NUM_PROCESSES": "1"},
]


def test_world_info_matches_jax(monkeypatch):
    """The same three variables and defaults: a TPU_WORKER_ID that does
    not parse is 0; one process (or none named) is no gang, and
    maybe_initialize is a no-op there."""
    for env in ENVS:
        for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "TPU_WORKER_ID"):
            monkeypatch.delenv(var, raising=False)
        for var, value in env.items():
            monkeypatch.setenv(var, value)
        assert distributed.world_info() == jdist.world_info(), env
        coord, n, _ = distributed.world_info()
        if n <= 1 or coord is None:
            assert distributed.maybe_initialize(device_type="cpu") is False
            assert distributed.current() is None


def test_build_mesh_sizes_and_errors_match_jax():
    """Sizes over 1-8 ranks (with -1 once, dcn_data) equal the JAX mesh's
    shape over as many devices, and every refusal is JAX's message; the
    coordinates lay ranks out row-major over MESH_AXES, as the device
    array is laid out."""
    assert mesh.MESH_AXES == jmesh.MESH_AXES and mesh.KNOWN_AXES == jmesh.KNOWN_AXES
    assert [mesh.axis_names(a) for a in (None, "tensor", ("data", "fsdp"))] == \
        [jmesh.axis_names(a) for a in (None, "tensor", ("data", "fsdp"))]
    cases = [(1, {}), (2, {"tensor": 2}), (8, {"data": 2, "fsdp": 2, "tensor": 2}), (8, {"tensor": -1}),
             (8, {"data": -1, "tensor": 2}), (4, {"sequence": 2, "tensor": 2}), (8, {"data": 4, "tensor": 2,
                                                                                     "dcn_data": 2}),
             (8, {"data": -1, "tensor": -1}), (6, {"tensor": 4, "data": -1}), (4, {"tensor": 2}),
             (8, {"data": 2, "tensor": 4, "dcn_data": 4}), (8, {"expert": 8}), (4, {"stage": 2, "fsdp": 2})]
    for n, kw in cases:
        devices = jax.devices()[:n]
        try:
            want = dict(jmesh.build_mesh(**kw, devices=devices).shape)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                mesh.build_mesh(**kw, world=n)
            assert str(got.value) == str(e), (n, kw)
            continue
        m = mesh.build_mesh(**kw, world=n, rank=n - 1)
        assert m.shape == want, (n, kw)
        jm = jmesh.build_mesh(**kw, devices=devices)
        where = np.argwhere(np.vectorize(lambda d: d.id)(jm.devices) == devices[n - 1].id)[0]
        assert [m.coords[a] for a in mesh.MESH_AXES] == list(where), (n, kw)
    assert mesh.local_mesh().shape == {a: 1 for a in mesh.MESH_AXES}


def _logical_trees(cfg):
    return [jllama.param_logical_axes(cfg), jllama.cache_logical_axes(cfg, True),
            jllama.paged_cache_logical_axes(cfg, True)]


def test_logical_axes_and_rules_match_jax():
    """param/cache/paged-cache logical axes are JAX's trees, and spec_for
    gives JAX's PartitionSpec for each under the default, serving and
    sequence-serving rules (and a rule mapping to a tuple of axes)."""
    for name in ("tiny", "tiny-moe"):
        jcfg = jllama.CONFIGS[name]
        cfg = llama.CONFIGS[name]
        assert llama.param_logical_axes(cfg) == jllama.param_logical_axes(jcfg)
        assert llama.cache_logical_axes(cfg, True) == jllama.cache_logical_axes(jcfg, True)
        assert llama.cache_logical_axes(cfg) == jllama.cache_logical_axes(jcfg)
        assert llama.paged_cache_logical_axes(cfg, True) == jllama.paged_cache_logical_axes(jcfg, True)
        leaves = [leaf for tree in _logical_trees(jcfg)
                  for leaf in jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, tuple))]
        jseq = jmesh.build_mesh(sequence=2, tensor=4, devices=jax.devices())
        pairs = [(sharding.DEFAULT_RULES, jsharding.DEFAULT_RULES), (sharding.SERVE_RULES, jsharding.SERVE_RULES),
                 (sharding.serve_rules_for(mesh.build_mesh(sequence=2, tensor=4, world=8)),
                  jsharding.serve_rules_for(jseq)),
                 (sharding.serve_rules_for(None), jsharding.serve_rules_for(None)),
                 (sharding.DEFAULT_RULES.replace(heads=("tensor", "expert")),
                  jsharding.DEFAULT_RULES.replace(heads=("tensor", "expert")))]
        for port_rules, jax_rules in pairs:
            for axes in leaves + [("batch", "seq", "act_heads"), ("heads", "kv_heads")]:
                assert sharding.spec_for(axes, port_rules) == tuple(jsharding.spec_for(axes, jax_rules)), axes


def _jax_shards(tree, jcfg, devices, rank):
    """Each leaf of `tree` placed by JAX's shard_tree on a tensor=2 mesh
    over `devices`, as the port's state dict of the block on tensor-axis
    device `rank`."""
    jm = jmesh.build_mesh(tensor=2, devices=devices)
    placed = jsharding.shard_tree(tree, jm, jllama.param_logical_axes(jcfg), jsharding.SERVE_RULES)
    dev = jm.devices.reshape(-1)[rank]

    def local(x):
        return next(np.asarray(s.data) for s in x.addressable_shards if s.device == dev)

    return params_from_jax(jax.tree.map(local, placed))


@pytest.mark.parametrize("vocab", [258, 257])
def test_rank_shards_equal_jax_addressable_shards(vocab):
    """Every leaf, dense and int8 (values and scales, the scale's
    contracting dims whole), f32: rank r's shard is JAX's addressable shard
    on the tensor-axis device r; a vocab of 257 stays whole (fit). The
    shards load into Llama(shard_config(...)), whose heads are halved with
    the head dim pinned, and shard_model of the port's whole model gives
    the same tensors."""
    jcfg = jllama.CONFIGS["tiny"].replace(vocab_size=vocab, dtype=jnp.float32)
    cfg = llama.CONFIGS["tiny"].replace(vocab_size=vocab, dtype=torch.float32)
    dense = jllama.init_params(jcfg, jax.random.key(0))
    int8 = j_quantize_params(dense, jllama.quant_contracting(jcfg))
    devices = jax.devices()[:2]
    local_cfg = llama.shard_config(cfg, 2)
    assert (local_cfg.n_heads, local_cfg.n_kv_heads, local_cfg.head_size) == (2, 1, cfg.head_size)
    assert local_cfg.hidden_dim == cfg.hidden_dim // 2
    assert local_cfg.vocab_size == (vocab // 2 if vocab % 2 == 0 else vocab)
    for tree, quantize in ((dense, "none"), (int8, "int8")):
        whole = llama.Llama(cfg, device="cpu", quantize=quantize)
        whole.load_state_dict(params_from_jax(jax.tree.map(np.asarray, tree)))
        for rank in range(2):
            m = mesh.build_mesh(tensor=2, world=2, rank=rank)
            want = _jax_shards(tree, jcfg, devices, rank)
            got = shard_from_jax(jax.tree.map(np.asarray, tree), cfg, m)
            assert set(got) == set(want)
            for name, value in want.items():
                torch.testing.assert_close(got[name], value, rtol=0, atol=0, msg=f"{name} rank {rank}")
            shard = llama.Llama(local_cfg, device="cpu", quantize=quantize)
            shard.load_state_dict(got)
            # shard_model on a mesh without process groups: the slices alone.
            m.groups["tensor"] = None
            by_model = llama.shard_model(whole, m).state_dict()
            for name, value in shard.state_dict().items():
                torch.testing.assert_close(by_model[name], value, rtol=0, atol=0, msg=name)
    with pytest.raises(ValueError, match="must divide the heads"):
        llama.shard_config(cfg, 4)
    m = mesh.build_mesh(tensor=2, world=2, rank=0)
    m.groups["tensor"] = None
    # int4 and w8a8 shard (tests/test_torch_gang_quant.py holds their bytes
    # against JAX's): tiny's int4 w_down stays whole, w8a8 slices as int8.
    q4 = llama.shard_model(llama.init_params(cfg, seed=0, device="cpu", quantize="int4"), m)
    assert q4.tp.down_whole and q4.layers[0].w_down.shape == (cfg.hidden_dim, cfg.dim)
    assert q4.layers[0].wq.shape == (cfg.dim, cfg.n_heads // 2, cfg.head_size)
    w8a8 = llama.init_params(cfg.replace(quant_activations=True), seed=0, device="cpu", quantize="int8")
    shard = llama.shard_model(w8a8, m)
    assert shard.cfg.quant_activations and not shard.tp.down_whole
    assert shard.layers[0].w_down.q.shape == (cfg.hidden_dim // 2, cfg.dim)


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_hf_directory_loads_as_each_ranks_shard(tmp_path, quantize):
    """An HF directory loaded as a rank's tensor shard, a layer at a time
    (each staged whole, quantized whole, then sliced) equals shard_model of
    the whole model loaded and quantized, bit for bit, for both ranks; its
    config is shard_config's and its TensorShard the mesh's."""
    from substratus_tpu_torch.load.hf import load_pretrained
    from substratus_tpu_torch.tools.ckpt_writer import write_hf

    cfg = llama.CONFIGS["tiny"].replace(vocab_size=258, dtype=torch.float32)
    write_hf(str(tmp_path / "hf"), llama.init_params(cfg, seed=3, device="cpu"))
    _, whole = load_pretrained(str(tmp_path / "hf"), dtype=torch.float32, device="cpu", quantize=quantize)
    for rank in range(2):
        m = mesh.build_mesh(tensor=2, world=2, rank=rank)
        m.groups["tensor"] = None
        local_cfg, shard = load_pretrained(str(tmp_path / "hf"), dtype=torch.float32, device="cpu",
                                           quantize=quantize, mesh_for=lambda _: m)
        assert local_cfg == llama.shard_config(whole.cfg, 2) and shard.tp.index == rank and shard.tp.size == 2
        assert llama.quantized_layout(shard) == llama.quantized_layout(whole)
        want = llama.shard_model(whole, m).state_dict()
        got = shard.state_dict()
        assert set(got) == set(want)
        for name, value in want.items():
            if torch.is_tensor(value):
                torch.testing.assert_close(got[name], value, rtol=0, atol=0, msg=name)
