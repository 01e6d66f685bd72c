"""Multi-tenant LoRA adapter serving: one base model, many adapters (the
port's own copy of substratus_tpu/serve/adapters.py).

`train/` produces LoRA adapters (train/lora.py); serving each finetune on
an engine of its own would mean one model copy, one KV pool and one
replica set a tenant. This module packs N tenants into ONE engine: the
`AdapterStore` loads adapter artifacts into stacked per-layer tensors
(``a`` [L, A, in, r], ``b`` [L, A, r, *out]; adapter slot 0 is the all-zero
identity adapter, so a request without one pays only the rank-r products)
and the model gathers each batch row's pair by slot index
(ops/basics.py::lora_delta_indexed). Shapes are fixed when the store is
built (capacity, rank, targets), so a load or an eviction changes no
shape, and a mixed-tenant batch runs in the decode step the engine
already has.

The device tensors, unlike the JAX module's device tree, are allocated
once, on the model's device and in its dtype, and never rebuilt: the
decode step's CUDA graph, every SpecGraph width and the int4 matmul's
operand views read them by address and stay valid with no new capture.
Host threads (the HTTP handlers, a preload) write only the float32 host
buffers, under the lock, and mark the slot dirty; the engine's scheduler
thread copies the dirty slots into the device tensors in place, on its
own stream, before it next prefills or dispatches (``sync``, the pattern
of Engine._apply_swap). A copy is ordered on that stream behind the step
in flight, so no replay reads a half-written slot, and a pinned slot
(one an active request uses) is never the target of a new load: loads go
to an empty slot or evict an unpinned one.

Threading contract: the store is shared between the scheduler thread
(sync, acquire and release at admission and release) and HTTP handlers
(`known()`, snapshots, explicit loads). All shared host state is mutated
under `self._lock`.

Artifact layouts read (docs/container-contract.md "Adapter artifacts"):

    <dir>/substratus.json   {"format": "substratus-tpu-adapter-v1",
                             "lora": {"rank", "alpha", "targets"}, ...}
    <dir>/adapters.npz      {name}.a [L, in, r] / {name}.b [L, r, *out]

the contract's format, which numpy reads with no JAX, and the port's own
training artifact (train/checkpoints.py::save_adapter_artifact):

    <dir>/substratus.json   {"format": "substratus-tpu-torch-adapter-v1", "lora": {...}}
    <dir>/adapters.pt       the LoraAdapters state_dict, layers.{i}.{name}.{a|b}

so what ``train.main`` writes serves as it is. The container contract
mounts adapter artifacts under ``/content/adapters/<id>/``; the store's
`search_dir` makes every subdir there loadable on demand: the cache-miss
path is the hot-load path.

On a gang rank (``tp``, the rank's TensorShard) the store holds its slice
of every tenant, by the rule the rank's weight follows, since the model
adds each delta inside the projection (models/llama.py ``proj``): ``b``
by output columns for wq, wk, wv (heads) and w_gate, w_up (the MLP, where
the axis divides it), ``a`` by input rows for wo (heads) and a w_down
whose output is summed over the group, so each rank's partial delta is
summed with the weight's partial output; a w_down kept whole keeps its
``a`` whole. Artifacts are the whole model's; ``install`` slices them, and
the device tensors are allocated once at the rank's shapes. (The JAX
store replicates the stacked tree and lets GSPMD partition the delta.)
"""
from __future__ import annotations

import itertools
import json
import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from substratus_tpu_torch.observability.metrics import METRICS
from substratus_tpu_torch.train.lora import DEFAULT_TARGETS
from substratus_tpu_torch.utils.device import DeviceLike, resolve_device

ADAPTER_META_FILE = "substratus.json"
ADAPTER_FORMAT = "substratus-tpu-adapter-v1"
ADAPTER_WEIGHTS_FILE = "adapters.npz"
# The port's trainer writes its adapters as a torch state dict
# (train/checkpoints.py); the store reads that format too.
TORCH_ADAPTER_FORMAT = "substratus-tpu-torch-adapter-v1"
TORCH_ADAPTER_FILE = "adapters.pt"
_FORMATS = (ADAPTER_FORMAT, TORCH_ADAPTER_FORMAT)

# Adapter-serving metric catalog, the JAX module's (docs/observability.md).
# Declared at import so /metrics carries HELP/TYPE before the first load.
METRICS.describe(
    "substratus_serve_adapters_loaded",
    "LoRA adapters currently resident in the engine's adapter slots "
    "(identity slot 0 excluded).",
    type="gauge",
)
METRICS.describe(
    "substratus_serve_adapter_evictions_total",
    "Adapters evicted from their slot to make room for another load.",
    type="counter",
)
METRICS.describe(
    "substratus_serve_adapter_cache_hits_total",
    "Requests whose adapter was already resident at admission.",
    type="counter",
)
METRICS.describe(
    "substratus_serve_adapter_cache_misses_total",
    "Requests whose adapter had to be hot-loaded from its artifact at "
    "admission.",
    type="counter",
)


class UnknownAdapter(KeyError):
    """The adapter id is neither loaded nor loadable from any known
    artifact path: the HTTP layer turns this into a 404."""

    def __init__(self, adapter_id: str):
        super().__init__(adapter_id)
        self.adapter_id = adapter_id

    def __str__(self) -> str:
        return f"unknown adapter {self.adapter_id!r}"


class AdapterCapacityError(RuntimeError):
    """Every adapter slot is pinned by an active request; transient: the
    scheduler holds the request until a decode slot frees one."""


def _target_shapes(cfg, targets: Sequence[str]) -> Dict[str, Tuple[int, Tuple[int, ...]]]:
    """(in_dim, out_shape) per target projection: the layout train/lora.py
    uses, minus the expert-routed MoE leaves (a per-row gather over an
    [L, A, E, ...] tree is not implemented; the attention and dense-MLP
    projections are)."""
    hd = cfg.head_size
    out_shape = {
        "wq": (cfg.n_heads, hd),
        "wk": (cfg.n_kv_heads, hd),
        "wv": (cfg.n_kv_heads, hd),
        "wo": (cfg.dim,),
        "w_gate": (cfg.hidden_dim,),
        "w_up": (cfg.hidden_dim,),
        "w_down": (cfg.dim,),
    }
    in_dim = {
        "wq": cfg.dim, "wk": cfg.dim, "wv": cfg.dim,
        "wo": cfg.n_heads * hd,
        "w_gate": cfg.dim, "w_up": cfg.dim,
        "w_down": cfg.hidden_dim,
    }
    moe = getattr(cfg, "n_experts", 0) > 0
    shapes = {}
    for name in targets:
        if name not in out_shape:
            raise ValueError(f"unknown adapter target {name!r}")
        if moe and name in ("w_gate", "w_up", "w_down"):
            raise ValueError(
                f"adapter target {name!r} is expert-routed under MoE "
                "configs; slot-indexed serving supports the attention "
                "and dense-MLP projections"
            )
        shapes[name] = (in_dim[name], out_shape[name])
    return shapes


def _rank_slices(cfg, targets: Sequence[str], tp) -> Dict[str, Tuple[int, int, Tuple[int, ...]]]:
    """Per target on a gang rank: (leaf, axis of the artifact's [L, ...]
    leaf, whole size along it) to slice, or absent where the rank holds
    it whole. `cfg` is the rank's (models/llama.py shard_config's)."""
    if tp is None or tp.size == 1:
        return {}
    t, hd = tp.size, cfg.head_size
    heads, kv = cfg.n_heads * t, cfg.n_kv_heads * t
    mlp = cfg.hidden_dim * t if tp.mlp_sharded else cfg.hidden_dim
    rule = {"wq": ("b", 2, heads), "wk": ("b", 2, kv), "wv": ("b", 2, kv), "wo": ("a", 1, heads * hd)}
    if tp.mlp_sharded:
        rule.update(w_gate=("b", 2, mlp), w_up=("b", 2, mlp))
    if tp.reduce_down:
        rule["w_down"] = ("a", 1, mlp)
    return {name: rule[name] for name in targets if name in rule}


def save_adapter_artifact(
    path: str,
    adapters: Dict[str, Any],  # {name: {"a": [L, in, r], "b": [L, r, ...]}}
    alpha: float,
    rank: int,
    extra_meta: Optional[Dict[str, Any]] = None,
) -> None:
    """Write a servable LoRA adapter artifact in the contract's format:
    npz weights (float32) and the config sidecar."""
    os.makedirs(path, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    for name, ab in adapters.items():
        arrays[f"{name}.a"] = np.asarray(ab["a"], np.float32)
        arrays[f"{name}.b"] = np.asarray(ab["b"], np.float32)
    np.savez(os.path.join(path, ADAPTER_WEIGHTS_FILE), **arrays)
    meta = {
        "format": ADAPTER_FORMAT,
        "lora": {
            "rank": int(rank),
            "alpha": float(alpha),
            "targets": sorted(adapters),
        },
    }
    meta.update(extra_meta or {})
    with open(os.path.join(path, ADAPTER_META_FILE), "w") as f:
        json.dump(meta, f, indent=2)


def _read_meta(path: str) -> Optional[dict]:
    try:
        with open(os.path.join(path, ADAPTER_META_FILE)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def is_adapter_artifact(path: str) -> bool:
    """A directory holding an adapter artifact of either format."""
    meta = _read_meta(path)
    return meta is not None and meta.get("format") in _FORMATS


def _torch_layers(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """The port's adapters.pt (layers.{i}.{name}.{a|b}) stacked on a
    leading layer axis, float32, as the npz format holds it."""
    state = torch.load(os.path.join(path, TORCH_ADAPTER_FILE), map_location="cpu", weights_only=True)
    per: Dict[str, Dict[str, Dict[int, np.ndarray]]] = {}
    for key, t in state.items():
        parts = key.split(".")
        if len(parts) != 4 or parts[0] != "layers" or parts[3] not in ("a", "b"):
            raise ValueError(f"{path}: unexpected weight key {key!r}")
        per.setdefault(parts[2], {}).setdefault(parts[3], {})[int(parts[1])] = t.float().numpy()
    layers: Dict[str, Dict[str, np.ndarray]] = {}
    for name, ab in per.items():
        layers[name] = {}
        for leaf, by_layer in ab.items():
            if sorted(by_layer) != list(range(len(by_layer))):
                raise ValueError(f"{path}: target {name!r} {leaf} misses layers")
            layers[name][leaf] = np.stack([by_layer[i] for i in range(len(by_layer))])
    return layers


def load_adapter_artifact(path: str) -> Tuple[Dict[str, Any], float, dict]:
    """Read an adapter artifact dir of either format; returns (layers_tree,
    scale, meta), the tree {name: {"a": [L, in, r], "b": [L, r, *out]}} in
    float32 and scale = alpha / rank, the factor the model applies."""
    with open(os.path.join(path, ADAPTER_META_FILE)) as f:
        meta = json.load(f)
    fmt = meta.get("format")
    if fmt not in _FORMATS:
        raise ValueError(f"{path}: not an adapter artifact (format={fmt!r})")
    lora = meta.get("lora") or {}
    rank = int(lora.get("rank", 0))
    alpha = float(lora.get("alpha", rank))
    if rank < 1:
        raise ValueError(f"{path}: adapter metadata missing a valid rank")
    if fmt == TORCH_ADAPTER_FORMAT:
        layers = _torch_layers(path)
    else:
        with np.load(os.path.join(path, ADAPTER_WEIGHTS_FILE)) as z:
            layers = {}
            for key in z.files:
                name, _, leaf = key.rpartition(".")
                if leaf not in ("a", "b") or not name:
                    raise ValueError(f"{path}: unexpected weight key {key!r}")
                layers.setdefault(name, {})[leaf] = np.asarray(z[key], np.float32)
    for name, ab in layers.items():
        if set(ab) != {"a", "b"}:
            raise ValueError(f"{path}: target {name!r} missing a/b pair")
    return layers, alpha / rank, meta


def infer_store_shape(paths: Sequence[str]) -> Tuple[int, Tuple[str, ...]]:
    """(max rank, union of targets) across adapter artifacts: the store
    shape that can hold all of them (smaller ranks zero-pad exactly).
    Falls back to (8, DEFAULT_TARGETS) when nothing is readable."""
    rank, targets = 0, set()
    for path in paths:
        meta = _read_meta(path)
        if meta is None:
            continue
        lora = meta.get("lora") or {}
        rank = max(rank, int(lora.get("rank", 0)))
        targets.update(lora.get("targets") or ())
    if rank < 1 or not targets:
        return 8, tuple(DEFAULT_TARGETS)
    return rank, tuple(sorted(targets))


class AdapterStore:
    """Stacked adapter slots for one engine.

    Slot 0 is the identity adapter (all zero): requests without an
    adapter gather zeros and pay only the rank-r products, the price of
    one decode step for the whole mixed batch.

    `capacity` counts loadable tenant slots (identity slot excluded). The
    per-target host buffers are float32 with the adapter's alpha/rank
    scale folded into `b`, so the device tensors (`dtype`, default the
    model's, on `device`, cuda unless the caller asks for the CPU) carry
    one scale of 1.0 for every slot whatever each tenant's training
    hyperparameters.

    `tp` (a gang rank's parallel.sharding.TensorShard; `cfg` the rank's
    config) makes the store hold the rank's slice of every tenant (the
    module docstring); artifacts and `install` trees stay the whole
    model's.
    """

    def __init__(
        self,
        cfg,
        capacity: int = 8,
        rank: int = 8,
        targets: Sequence[str] = DEFAULT_TARGETS,
        dtype: Optional[torch.dtype] = None,
        search_dir: Optional[str] = None,
        device: DeviceLike = None,
        tp=None,
    ):
        if capacity < 1:
            raise ValueError(f"adapter capacity {capacity} invalid")
        if rank < 1:
            raise ValueError(f"adapter rank {rank} invalid")
        self.cfg = cfg
        self.capacity = capacity
        self.rank = rank
        self.targets = tuple(targets)
        self.dtype = dtype if dtype is not None else cfg.dtype
        self.device = resolve_device(device)
        self.search_dir = search_dir
        L = cfg.n_layers
        A = capacity + 1  # + identity slot 0
        self.n_slots = A
        self._shapes = _target_shapes(cfg, self.targets)
        # A gang rank's slices: the whole model's shapes are what installs
        # check; a w_down kept whole (its activation gathered) reads all
        # of the MLP's rows.
        self.tp = tp
        self._slices = _rank_slices(cfg, self.targets, tp)
        self._whole = dict(self._shapes)
        for name, (leaf, axis, size) in self._slices.items():
            ind, out = self._whole[name]
            self._whole[name] = (size, out) if leaf == "a" else (ind, (size,) + out[1:])
        if tp is not None and tp.down_whole and "w_down" in self._shapes:
            whole_in = cfg.hidden_dim * tp.size
            self._shapes["w_down"] = self._whole["w_down"] = (whole_in, self._shapes["w_down"][1])
        self._lock = threading.Lock()
        # Everything below is shared between the scheduler thread and HTTP
        # handlers and only ever touched under self._lock.
        self._a = {name: np.zeros((L, A, ind, rank), np.float32) for name, (ind, _out) in self._shapes.items()}
        self._b = {name: np.zeros((L, A, rank) + out, np.float32) for name, (_ind, out) in self._shapes.items()}
        self._slot_id: List[Optional[str]] = [None] * A  # slot -> adapter id
        self._by_id: Dict[str, int] = {}
        self._paths: Dict[str, str] = {}  # id -> artifact dir (reloadable)
        self._refs = [0] * A  # active engine slots pinning this adapter
        # The LRU order by a logical clock of the store's uses: a gang's
        # ranks, making the same uses in the same order, evict alike.
        self._clock = itertools.count(1)
        self._last_used = [0] * A
        self._dirty: set = set()  # slots whose host buffers the device has not seen
        self.stats: Dict[str, int] = {"hits": 0, "misses": 0, "evictions": 0}
        # The device tensors, allocated once (zeros: every slot the
        # identity until loaded), and each layer's views of them, the
        # `lora` tree the models' forward takes.
        self._dev_a = {name: torch.zeros(a.shape, dtype=self.dtype, device=self.device) for name, a in self._a.items()}
        self._dev_b = {name: torch.zeros(b.shape, dtype=self.dtype, device=self.device) for name, b in self._b.items()}
        self._tree = {
            "layers": [{name: {"a": self._dev_a[name][i], "b": self._dev_b[name][i]} for name in self._shapes}
                       for i in range(L)],
            "scale": 1.0,
        }

    # -- registration / lookup (any thread) --------------------------------

    def register_path(self, adapter_id: str, path: str) -> None:
        """Make an adapter loadable by id without loading it yet."""
        with self._lock:
            self._paths[adapter_id] = path

    def scan_search_dir(self) -> List[str]:
        """Register every artifact subdir of search_dir; returns the ids
        found (the container contract's /content/adapters layout)."""
        if not self.search_dir or not os.path.isdir(self.search_dir):
            return []
        found = []
        for entry in sorted(os.listdir(self.search_dir)):
            path = os.path.join(self.search_dir, entry)
            if is_adapter_artifact(path):
                self.register_path(entry, path)
                found.append(entry)
        return found

    def _path_of(self, adapter_id: str) -> Optional[str]:
        # caller holds the lock
        path = self._paths.get(adapter_id)
        if path is None and self.search_dir:
            cand = os.path.join(self.search_dir, adapter_id)
            if is_adapter_artifact(cand):
                self._paths[adapter_id] = cand
                path = cand
        return path

    def known(self, adapter_id: str) -> bool:
        """Resident or loadable: the HTTP layer's pre-submit check."""
        with self._lock:
            return adapter_id in self._by_id or self._path_of(adapter_id) is not None

    def loaded_ids(self) -> List[str]:
        with self._lock:
            return sorted(self._by_id)

    def available_ids(self) -> List[str]:
        """Resident + registered + discoverable adapters: what /v1/models
        advertises as servable."""
        self.scan_search_dir()
        with self._lock:
            return sorted(set(self._by_id) | set(self._paths))

    def snapshot(self) -> Dict[str, Any]:
        """/loadz block: what is resident plus the hit/miss/evict counters
        (mirrored from the metrics registry so a scrapeless poll still
        sees them)."""
        with self._lock:
            return {
                "loaded": sorted(self._by_id),
                "capacity": self.capacity,
                "hits": self.stats["hits"],
                "misses": self.stats["misses"],
                "evictions": self.stats["evictions"],
            }

    # -- load / evict -------------------------------------------------------

    def install(self, adapter_id: str, layers: Dict[str, Any], scale: float = 1.0) -> int:
        """Install an in-memory adapter tree into a slot (evicting the LRU
        unpinned resident if full); returns the slot index. The device
        sees it at the scheduler's next sync.

        Accepts rank <= the store rank (zero-padded: exact, the extra rank
        columns contribute nothing) and any subset of the store's targets
        (missing targets stay zero). `layers` holds the whole model's
        shapes; a gang rank's store keeps its slice of them."""
        if not adapter_id:
            raise ValueError("adapter id must be non-empty")
        unknown = set(layers) - set(self._shapes)
        if unknown:
            raise ValueError(
                f"adapter {adapter_id!r} targets {sorted(unknown)} not in "
                f"the store's target set {sorted(self._shapes)}"
            )
        checked: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        for name, (ind, out) in self._whole.items():
            ab = layers.get(name)
            if ab is None:
                continue
            a = np.asarray(ab["a"], np.float32)
            b = np.asarray(ab["b"], np.float32)
            want_a = (self.cfg.n_layers, ind)
            if a.ndim != 3 or a.shape[:2] != want_a or a.shape[2] > self.rank:
                raise ValueError(
                    f"adapter {adapter_id!r} {name}.a shape {a.shape} "
                    f"incompatible with [L={want_a[0]}, in={want_a[1]}, "
                    f"r<={self.rank}]"
                )
            if b.shape[0] != self.cfg.n_layers or b.shape[1] != a.shape[2] or b.shape[2:] != out:
                raise ValueError(
                    f"adapter {adapter_id!r} {name}.b shape {b.shape} "
                    f"incompatible with [L, r={a.shape[2]}, {out}]"
                )
            if name in self._slices:
                leaf, axis, size = self._slices[name]
                block = size // self.tp.size
                index = slice(self.tp.index * block, (self.tp.index + 1) * block)
                if leaf == "a":
                    a = a[(slice(None),) * axis + (index,)]
                else:
                    b = b[(slice(None),) * axis + (index,)]
            checked[name] = (a, b)
        with self._lock:
            slot = self._by_id.get(adapter_id)
            if slot is None:
                slot = self._free_slot_locked()
            for name in self._shapes:
                self._a[name][:, slot] = 0.0
                self._b[name][:, slot] = 0.0
                if name not in checked:
                    continue
                a, b = checked[name]
                r = a.shape[2]
                self._a[name][:, slot, :, :r] = a
                # Fold the tenant's alpha/rank scale into b (f32, before
                # the cast to the device dtype): the device tensors then
                # carry one scale (1.0) for every slot.
                self._b[name][:, slot, :r] = b * scale
            self._slot_id[slot] = adapter_id
            self._by_id[adapter_id] = slot
            self._last_used[slot] = next(self._clock)
            self._dirty.add(slot)
            METRICS.set("substratus_serve_adapters_loaded", len(self._by_id))
            return slot

    def load(self, adapter_id: str, path: Optional[str] = None) -> int:
        """Load an adapter artifact into a slot (the hot-load path)."""
        with self._lock:
            path = path or self._path_of(adapter_id)
        if path is None:
            raise UnknownAdapter(adapter_id)
        layers, scale, _meta = load_adapter_artifact(path)
        slot = self.install(adapter_id, layers, scale)
        with self._lock:
            self._paths[adapter_id] = path
        return slot

    def _free_slot_locked(self) -> int:
        """A slot for a new adapter: an empty one, else evict the LRU
        unpinned resident. Caller holds the lock."""
        for slot in range(1, self.n_slots):
            if self._slot_id[slot] is None:
                return slot
        victim, oldest = 0, float("inf")
        for slot in range(1, self.n_slots):
            if self._refs[slot] == 0 and self._last_used[slot] < oldest:
                victim, oldest = slot, self._last_used[slot]
        if victim == 0:
            raise AdapterCapacityError(f"all {self.capacity} adapter slots are pinned by active requests")
        evicted = self._slot_id[victim]
        del self._by_id[evicted]
        self._slot_id[victim] = None
        self.stats["evictions"] += 1
        METRICS.inc("substratus_serve_adapter_evictions_total")
        METRICS.set("substratus_serve_adapters_loaded", len(self._by_id))
        return victim

    # -- admission pinning (engine scheduler thread) ------------------------

    def acquire(self, adapter_id: str) -> int:
        """Resolve an adapter id to its slot for one boarding request,
        hot-loading from its artifact on a miss, and pin the slot so an
        eviction cannot take the weights from an active decode. Raises
        UnknownAdapter (no artifact anywhere) or AdapterCapacityError
        (transient: every slot pinned)."""
        with self._lock:
            slot = self._by_id.get(adapter_id)
            if slot is not None:
                self.stats["hits"] += 1
                METRICS.inc("substratus_serve_adapter_cache_hits_total")
                self._refs[slot] += 1
                self._last_used[slot] = next(self._clock)
                return slot
            # Miss (counted, as the JAX store counts it, also when the
            # request then has to wait). With every slot pinned the load
            # would fail in install(): refuse before reading the artifact,
            # which the scheduler would otherwise read again on every
            # iteration the request waits.
            self.stats["misses"] += 1
            METRICS.inc("substratus_serve_adapter_cache_misses_total")
            pinned = all(self._slot_id[s] is not None and self._refs[s] for s in range(1, self.n_slots))
            if pinned and self._path_of(adapter_id) is not None:  # an unknown id raises UnknownAdapter below
                raise AdapterCapacityError(f"all {self.capacity} adapter slots are pinned by active requests")
        # The file read happens outside the lock (install() takes it only
        # for the buffer writes).
        slot = self.load(adapter_id)
        with self._lock:
            self._refs[slot] += 1
            self._last_used[slot] = next(self._clock)
            return slot

    def release(self, slot: int) -> None:
        if slot <= 0:
            return
        with self._lock:
            self._refs[slot] = max(0, self._refs[slot] - 1)

    # -- device tensors (engine scheduler thread) ---------------------------

    def sync(self) -> int:
        """Copy every dirty slot's host buffers into the device tensors, in
        place, on the calling thread's current stream (the scheduler's), so
        the copy is ordered after the step in flight and before the next
        one; returns the slots copied. On the card the host side goes
        through pinned memory, which PyTorch keeps until the copy is done,
        so the host does not wait for the device."""
        with self._lock:
            if not self._dirty:
                return 0
            slots = sorted(self._dirty)
            self._dirty.clear()
            staged = [(slot, {name: (self._a[name][:, slot].copy(), self._b[name][:, slot].copy())
                              for name in self._shapes}) for slot in slots]
        cuda = self.device.type == "cuda"
        with torch.no_grad():
            for slot, bufs in staged:
                for name, (a, b) in bufs.items():
                    for dev, host in ((self._dev_a[name], a), (self._dev_b[name], b)):
                        t = torch.from_numpy(host).to(self.dtype)
                        if cuda:
                            t = t.pin_memory()
                        dev[:, slot].copy_(t, non_blocking=cuda)
        return len(staged)

    def device_tree(self) -> Dict[str, Any]:
        """The stacked adapter tensors as the models' forward takes them:
        {"layers": [{name: {"a": [A, in, r], "b": [A, r, *out]}} a layer],
        "scale": 1.0}, views of tensors allocated once (their addresses
        never change). Only the scheduler thread's sync writes them."""
        return self._tree
