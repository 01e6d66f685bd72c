"""Logical-axis sharding rules (port of substratus_tpu/parallel/sharding.py).

Arrays in models/ are annotated with *logical* axis names; a rules table maps
each logical name to zero or more *mesh* axes (parallel/mesh.py). The JAX
package hands the result to XLA as a PartitionSpec; the port slices each
tensor itself: ``shard_params`` gives this rank its block of every leaf,
by the same spec and the same ``fit`` rule as the JAX package's
``sharding_tree``, and the model issues the collectives
(models/llama.py's tensor-parallel forward).

Logical axis vocabulary:
  activations: "batch", "seq", "act_embed", "act_heads", "act_kv", "act_mlp"
  params:      "vocab", "embed", "heads", "kv_heads", "head_dim", "mlp",
               "layers" (scan axis, never sharded), "expert", "lora_rank"

A spec is a tuple with one entry per dimension (a mesh-axis name, a tuple
of names, or None), trailing Nones dropped, as a PartitionSpec's entries.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from substratus_tpu_torch.parallel.mesh import Mesh, axis_names

Axes = Tuple[Optional[Union[str, Tuple[str, ...]]], ...]
Spec = Tuple[Optional[Union[str, Tuple[str, ...]]], ...]


@dataclass(frozen=True)
class LogicalRules:
    """Mapping from logical axis name -> mesh axis (or tuple of mesh axes)."""

    rules: Tuple[Tuple[str, Union[None, str, Tuple[str, ...]]], ...]

    def mesh_axes(self, logical: Sequence[Optional[str]]) -> Spec:
        table = dict(self.rules)
        out, used = [], set()
        for name in logical:
            if name is None:
                out.append(None)
                continue
            mapped = table.get(name)
            # A mesh axis may appear only once in a spec; later logical
            # axes that map to an already-used mesh axis stay replicated
            # (flax.linen's logical partitioning, as in the JAX package).
            if mapped is None:
                out.append(None)
                continue
            axes = (mapped,) if isinstance(mapped, str) else tuple(mapped)
            free = tuple(a for a in axes if a not in used)
            used.update(free)
            if not free:
                out.append(None)
            elif len(free) == 1:
                out.append(free[0])
            else:
                out.append(free)
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    def replace(self, **kv) -> "LogicalRules":
        table = dict(self.rules)
        table.update(kv)
        return LogicalRules(tuple(table.items()))


# Training defaults: FSDP shards the param embed dim, tensor shards heads/mlp,
# batch is data-parallel over both data and fsdp axes, sequence parallelism
# shards activation seq.
DEFAULT_RULES = LogicalRules(
    (
        ("batch", ("data", "fsdp")),
        ("seq", "sequence"),
        ("act_embed", None),
        ("act_heads", "tensor"),
        ("act_kv", "tensor"),
        ("act_mlp", "tensor"),
        ("vocab", "tensor"),
        ("embed", "fsdp"),
        ("heads", "tensor"),
        ("kv_heads", "tensor"),
        ("head_dim", None),
        ("mlp", "tensor"),
        ("layers", None),
        ("expert", "expert"),
        ("lora_rank", None),
        ("cache_batch", ("data", "fsdp")),
        ("cache_seq", None),
    )
)

# Serving: no fsdp (weights fit, or are tensor-sharded); batch over data.
SERVE_RULES = DEFAULT_RULES.replace(
    batch="data", embed=None, cache_batch="data"
)


def serve_rules_for(mesh: Optional[Mesh]) -> LogicalRules:
    """SERVE_RULES, with the KV cache's sequence dim sharded over the
    mesh's "sequence" axis when the serving mesh has one (>1)."""
    if mesh is not None and mesh.shape.get("sequence", 1) > 1:
        return SERVE_RULES.replace(cache_seq="sequence")
    return SERVE_RULES


def spec_for(logical: Sequence[Optional[str]], rules: LogicalRules = DEFAULT_RULES) -> Spec:
    return rules.mesh_axes(logical)


def _axis_size(mesh: Mesh, entry) -> int:
    size = 1
    for a in axis_names(entry):
        size *= mesh.shape[a]
    return size


def fit(shape: Sequence[int], spec: Spec, mesh: Mesh) -> Spec:
    """Drop spec entries whose mesh-axis size does not divide the dim (one
    kv head, or a vocab of 32001, under tensor=2): that dim stays whole,
    as the JAX package's sharding_tree fits it."""
    return tuple(entry if entry is None or shape[i] % _axis_size(mesh, entry) == 0 else None
                 for i, entry in enumerate(spec))


def shard_tensor(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of `t` under `spec` (a view): along each sharded
    dim, the slice at the rank's coordinate, the mesh axes of a tuple entry
    major to minor, as a NamedSharding lays the blocks out."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        size, index = 1, 0
        for a in axis_names(entry):
            index = index * mesh.shape[a] + mesh.coords[a]
            size *= mesh.shape[a]
        if size == 1:
            continue
        block = t.shape[dim] // size
        t = t.narrow(dim, index * block, block)
    return t


def _leaf_axes(logical_axes: Mapping[str, Any], name: str) -> Axes:
    """The logical axes of a port state-dict weight name ("tok_embed",
    "layers.3.wq") in the JAX package's tree, whose layer leaves carry a
    leading "layers" axis the port's per-layer tensors do not have."""
    if name.startswith("layers."):
        _, _, attr = name.split(".", 2)
        return tuple(logical_axes["layers"][attr][1:])
    return tuple(logical_axes[name])


def q4_row_parallel(c: int, groups: int, block: int, size: int) -> bool:
    """Whether an int4 weight whose contracting dims (C values, in
    `groups` scale groups of `block`) lie sharded over `size` ranks stays
    row-parallel: the JAX package's rule (ops/quant4.py _q4_axes) keeps it
    so only when every shard's slice covers whole scale groups (the
    groups divide by the axis, the local C is a multiple of `block`).
    Otherwise JAX stores the weight sharded and gathers it at every
    product; the port keeps it whole on every rank, the same function."""
    return groups % size == 0 and (c // size) % block == 0


def _q4_specs(packed: torch.Tensor, scale: torch.Tensor, pack_axis: int, block: int, spec: Spec,
              axes: Axes, mesh: Mesh) -> Tuple[Spec, Spec]:
    """The specs of a Q4Tensor's packed bytes and scales: the weight's spec
    fitted to each buffer's own shape, as the JAX package's sharding_tree
    fits them; both whole when the contracting dims (every dim up to the
    pack axis but an expert axis) are sharded and q4_row_parallel refuses."""
    base = tuple(spec) + (None,) * (packed.ndim - len(spec))
    pspec, sspec = fit(packed.shape, base, mesh), fit(scale.shape, base, mesh)
    pack = pack_axis % packed.ndim
    contracting = [i for i in range(pack + 1) if axes[i] != "expert"]
    size = 1
    for i in contracting:
        if pspec[i] is not None:
            size *= _axis_size(mesh, pspec[i])
    if size > 1:
        c = 2 * math.prod(packed.shape[i] for i in contracting)
        groups = math.prod(scale.shape[i] for i in contracting)
        if not q4_row_parallel(c, groups, block, size):
            return (), ()
    return pspec, sspec


def shard_params(params: Mapping[str, Any], logical_axes: Mapping[str, Any], mesh: Mesh,
                 rules: LogicalRules = SERVE_RULES) -> Dict[str, Any]:
    """This rank's slice of every leaf of `params` (a port state dict:
    "tok_embed", "layers.{i}.{name}", an int8 weight's ".q" and ".scale",
    an int4 weight's ".packed" and ".scale" with its extra state), by the
    JAX package's sharding_tree: each weight's spec from its logical axes
    (`logical_axes`, the JAX tree of models/llama.py's param_logical_axes)
    fitted to its shape; an int8 QTensor's values take the weight's spec
    and its per-channel scale the same spec with its size-1 (contracting,
    keepdims) dims left whole (a w8a8 weight is such a QTensor); an int4
    Q4Tensor's packed bytes and scales each take the weight's spec fitted
    to their own shapes, both whole where q4_row_parallel refuses the
    slices. Sliced leaves are contiguous copies (the int4 kernels stream a
    weight as it lies); whole ones and entries that are not tensors pass
    as they are."""
    out: Dict[str, Any] = {}
    for name, value in params.items():
        if not torch.is_tensor(value):
            out[name] = value
            continue
        base, _, suffix = name.rpartition(".")
        if suffix in ("q", "scale", "packed") and f"{base}.scale" in params and (
                f"{base}.q" in params or f"{base}.packed" in params):
            axes = _leaf_axes(logical_axes, base)
            weight = params.get(f"{base}.q", params.get(f"{base}.packed"))
            if f"{base}.packed" in params:
                extra = params[f"{base}._extra_state"]
                packed, scale = params[f"{base}.packed"], params[f"{base}.scale"]
                logical = list(packed.shape)
                logical[extra["pack_axis"]] *= 2
                specs = _q4_specs(packed, scale, extra["pack_axis"], extra["block"],
                                  fit(logical, rules.mesh_axes(axes), mesh), axes, mesh)
                spec = specs[0] if suffix == "packed" else specs[1]
            else:
                spec = fit(weight.shape, rules.mesh_axes(axes), mesh)
                if suffix == "scale":
                    spec = tuple(a if value.shape[i] != 1 else None for i, a in enumerate(spec))
        else:
            spec = fit(value.shape, rules.mesh_axes(_leaf_axes(logical_axes, name)), mesh)
        sliced = shard_tensor(value, spec, mesh)
        out[name] = sliced.contiguous() if sliced.shape != value.shape else value
    return out


class TensorShard:
    """A rank's place on the mesh's "tensor" axis, and the collectives the
    tensor-parallel forward issues over its group (models/llama.py):

      * the embedding of a vocab shard writes zeros for ids outside it,
        and an all-reduce sums the ranks' rows;
      * the partial outputs of wo and w_down (their contracting dims are
        sharded) are all-reduced before the residual add, in the model's
        dtype, as XLA's psum reduces them (int4 too: each rank's kernel
        runs its contracting slice, as the JAX package's partitioning
        rule runs the Pallas kernel per shard and adds the psum); a w8a8
        w_down sums its s32 partials inside the product instead
        (ops/quant.py::qeinsum_w8a8, `group`);
      * an int4 w_down kept whole (`down_whole`: sharding.q4_row_parallel
        refused its slices) while w_gate and w_up shard over the MLP takes
        the MLP activation gathered to its full width, and its output
        needs no reduce;
      * the logits of a vocab shard are gathered to the full vocab.

    A gather is an all-reduce of each rank's slice written into a zeroed
    full-width buffer, not an all_gather: gloo takes CUDA tensors for
    all_reduce and broadcast only, so one collective serves every backend,
    and adding zeros is exact. A dim that the axis does not divide stays
    whole on every rank (sharding.fit): a whole vocab needs neither the
    embedding's sum nor the gather, a whole MLP no reduce of w_down."""

    def __init__(self, group, size: int, index: int, vocab_size: int, vocab_sharded: bool, mlp_sharded: bool,
                 down_whole: bool = False):
        self.group, self.size, self.index = group, size, index
        self.vocab_size = vocab_size
        self.vocab_rows = vocab_size // size if vocab_sharded else None
        self.mlp_sharded = mlp_sharded
        self.down_whole = down_whole

    @property
    def reduce_down(self) -> bool:
        """Whether w_down's output is a partial sum over the group."""
        return self.mlp_sharded and not self.down_whole

    def reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """Reduce `x` over the tensor group (a sum unless `op`), in place, in
        its own dtype."""
        dist.all_reduce(x, op=op, group=self.group)
        return x

    def _gather(self, x: torch.Tensor, width: int) -> torch.Tensor:
        """x's last dim, this rank's block of `width`, gathered whole."""
        full = x.new_zeros(*x.shape[:-1], width)
        rows = x.shape[-1]
        full[..., self.index * rows:(self.index + 1) * rows] = x
        return self.reduce(full)

    def embed(self, table: torch.Tensor, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The embedding rows of `tokens` from this rank's vocab shard
        `table`, summed over the group (a whole table needs no sum)."""
        if self.vocab_rows is None:
            return table[tokens].to(dtype)
        local = tokens - self.index * self.vocab_rows
        inside = (local >= 0) & (local < self.vocab_rows)
        rows = table[local.clamp(0, self.vocab_rows - 1)].to(dtype)
        return self.reduce(torch.where(inside[..., None], rows, torch.zeros((), dtype=dtype, device=rows.device)))

    def gather_mlp(self, h: torch.Tensor) -> torch.Tensor:
        """The MLP activation at its full width from this rank's columns,
        for a w_down kept whole."""
        return self._gather(h, h.shape[-1] * self.size)

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """Full-vocab logits from this rank's vocab columns (as they are
        when the vocab is whole)."""
        if self.vocab_rows is None:
            return logits
        return self._gather(logits, self.vocab_size)
