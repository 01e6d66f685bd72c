"""Carry weights from the JAX package's parameter tree into the port.

``params_from_jax`` carries the model's weights: it takes a family's
params pytree with numpy (or numpy-convertible) leaves -- top-level
leaves beside ``layers``, whose per-layer weights are stacked on a
leading L axis -- and returns the port's ``state_dict`` for the family's
module (``models.llama.Llama``, ``models.opt.OPT``,
``models.falcon.Falcon``): the three trees share that shape and their
names, so one mapping serves every family. It needs no JAX: leaves go
through ``numpy.asarray``.

``lora_from_jax`` does the same for the trainer's LoRA adapters, whose
layout every family shares: the state_dict of ``train.lora.LoraAdapters``.
For multi-tenant serving, ``adapter_layers_from_jax`` gives a JAX LoRA tree
as the float32 numpy tree ``serve.adapters.AdapterStore.install`` takes,
and ``adapter_store_from_jax`` carries a JAX AdapterStore's slots (host
buffers and ids) into the port's store.

A mixture of experts' leaves carry over the same way: the router [L, D,
E] and the experts [L, E, D, M] / [L, E, M, D] split on their layer axis
into each block's [D, E] and [E, ...], and expert-routed LoRA pairs [L, E,
in, r] / [L, E, r, out] into each layer's [E, in, r] / [E, r, out].

``shard_from_jax`` gives a gang rank's share of a llama tree: the state
dict of its tensor shard (parallel/sharding.py's shard_params, the JAX
package's sharding_tree rule), to load into
``Llama(llama.shard_config(cfg, tensor))``.

``config_from_jax`` gives the port's config of a JAX family config: the
fields the two share (``quant_activations``, w8a8, among them) and the
dtype by name; the attention switches keep the port's defaults, since
the port's names differ (it has no XLA).

Quantized leaves carry over as they are: an int4 ``Q4Tensor`` as its
``packed`` bytes, ``scale`` and (as the module's extra state) its
``pack_axis`` and ``block``; an int8 ``QTensor`` as ``q`` and ``scale``.
Load them into ``Llama(cfg, quantize="int4")`` (or ``"int8"``). The
negative ``pack_axis`` stays valid when the layer axis is split off.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch


def _tensor(leaf: Any) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        # torch.from_numpy rejects ml_dtypes' bfloat16; f32 holds it exactly.
        arr = arr.astype(np.float32)
    # A copy: device_get hands out read-only buffers, which torch must not share.
    return torch.from_numpy(np.array(arr))


def _entries(leaf: Any) -> Dict[str, Any]:
    """A leaf's state-dict entries relative to its own name ("" for a
    dense tensor), each tensor still carrying the stacked layer axis."""
    if hasattr(leaf, "packed"):  # Q4Tensor
        return {".packed": _tensor(leaf.packed), ".scale": _tensor(leaf.scale),
                "._extra_state": {"pack_axis": int(leaf.pack_axis), "block": int(leaf.block)}}
    if hasattr(leaf, "q") and hasattr(leaf, "scale"):  # QTensor
        return {".q": _tensor(leaf.q), ".scale": _tensor(leaf.scale)}
    return {"": _tensor(leaf)}


# The JAX config classes' names -> the port's family names.
_FAMILY_OF_JAX_CONFIG = {"LlamaConfig": "llama", "OPTConfig": "opt", "FalconConfig": "falcon"}
# Switches whose values name JAX's implementations ("xla", "pallas").
_IMPL_FIELDS = ("attn_impl", "decode_attn_impl", "chunk_attn_impl")


def config_from_jax(jcfg: Any):
    """The port's config (models/registry.py's class of the family) of a
    JAX family config: every field both have but the attention switches,
    and the dtype by its numpy name (jnp.float32 -> torch.float32)."""
    from substratus_tpu_torch.models import registry

    cls = registry.config_class(_FAMILY_OF_JAX_CONFIG[type(jcfg).__name__])
    names = {f.name for f in dataclasses.fields(cls)} - set(_IMPL_FIELDS) - {"dtype"}
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name in names}
    return cls(**kw, dtype=getattr(torch, np.dtype(jcfg.dtype).name))


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """JAX params {name: leaf, ..., layers: {name: [L, ...]}} of any family
    (llama: tok_embed, out_norm[, lm_head]; opt: tok_embed, pos_embed,
    final_ln_scale, final_ln_bias; falcon: the same without pos_embed) ->
    {"{name}[.buffer]", "layers.{i}.{name}[.buffer]"}."""
    state: Dict[str, Any] = {}
    for name, leaf in tree.items():
        if name != "layers":
            state.update({name + suffix: v for suffix, v in _entries(leaf).items()})
    for name, stacked in tree["layers"].items():
        entries = _entries(stacked)
        n_layers = next(v.shape[0] for v in entries.values() if isinstance(v, torch.Tensor))
        for i in range(n_layers):
            for suffix, value in entries.items():
                # Tensors lose the layer axis; extra state is every layer's.
                state[f"layers.{i}.{name}{suffix}"] = value[i] if isinstance(value, torch.Tensor) else value
    return state


def shard_from_jax(tree: Dict[str, Any], cfg, mesh) -> Dict[str, Any]:
    """JAX llama params (as params_from_jax takes them) -> the state dict
    of `mesh`'s rank's tensor shard (contiguous tensors): each weight
    sliced by its logical axes (models/llama.py's param_logical_axes) under
    the serving rules, an int8 QTensor's scale (a w8a8 weight's too) by the
    keepdims rule, an int4 Q4Tensor's packed bytes and scales each fitted
    to its own shape, or whole where parallel.sharding.q4_row_parallel
    refuses the slices."""
    from substratus_tpu_torch.models import llama
    from substratus_tpu_torch.parallel.sharding import SERVE_RULES, shard_params

    shard = shard_params(params_from_jax(tree), llama.param_logical_axes(cfg), mesh, SERVE_RULES)
    return {k: v.contiguous() if isinstance(v, torch.Tensor) else v for k, v in shard.items()}


def lora_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX LoRA adapters {name: {"a": [L, in, r], "b": [L, r, *out]}}
    (train/lora.py::init_lora, or Trainer.lora) -> the state_dict of the
    port's train.lora.LoraAdapters: {"layers.{i}.{name}.a", ...}, f32
    (bf16 leaves convert exactly; load_state_dict casts them back)."""
    state: Dict[str, torch.Tensor] = {}
    for name, ab in tree.items():
        for key in ("a", "b"):
            stacked = _tensor(ab[key])
            for i in range(stacked.shape[0]):
                state[f"layers.{i}.{name}.{key}"] = stacked[i]
    return state


def adapter_layers_from_jax(tree: Dict[str, Any]) -> Dict[str, Dict[str, np.ndarray]]:
    """A JAX LoRA tree {name: {"a": [L, in, r], "b": [L, r, *out]}}
    (train/lora.py::init_lora, Trainer.lora, or load_adapter_artifact's
    tree) as float32 numpy arrays, the tree serve/adapters.py's
    AdapterStore.install takes (bf16 leaves convert exactly)."""
    return {name: {key: _tensor(ab[key]).float().numpy() for key in ("a", "b")} for name, ab in tree.items()}


def adapter_store_from_jax(jax_store, store) -> None:
    """Carry a JAX AdapterStore's tenants into the port's `store` (built on
    the same config, capacity, rank and targets): every slot's float32 host
    buffers (the scale already folded into b) and its adapter id, so both
    engines gather the same adapter for the same slot index; the device
    sees them at the store's next sync. Reads the JAX store's host state
    only, under its lock: no JAX call is made."""
    with jax_store._lock:
        layers = {name: (np.array(jax_store._a[name]), np.array(jax_store._b[name])) for name in jax_store._a}
        slot_ids = list(jax_store._slot_id)
    if set(layers) != set(store._shapes) or len(slot_ids) != store.n_slots:
        raise ValueError(f"store shapes differ: targets {sorted(layers)} vs {sorted(store._shapes)}, "
                         f"{len(slot_ids)} vs {store.n_slots} slots")
    with store._lock:
        for name, (a, b) in layers.items():
            if a.shape != store._a[name].shape or b.shape != store._b[name].shape:
                raise ValueError(f"{name}: {a.shape}/{b.shape} vs {store._a[name].shape}/{store._b[name].shape}")
            store._a[name][...] = a
            store._b[name][...] = b
        store._slot_id = slot_ids
        store._by_id = {aid: slot for slot, aid in enumerate(slot_ids) if aid is not None}
        store._dirty.update(range(1, store.n_slots))
