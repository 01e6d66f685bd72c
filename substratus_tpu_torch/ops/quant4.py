"""Weight-only int4 quantization with a CUDA unpack-dequant matmul (port of
substratus_tpu/ops/quant4.py).

Storage is the JAX package's, byte for byte: two int4 values nibble-pack
into one uint8 along the LAST contracting dim of the weight, block-folded
(within each block of ``block`` rows, byte r holds rows r and r + block/2
as its low and high nibbles), with a symmetric f32 scale (absmax/7, values
clipped to [-8, 7]) per group of ``block`` rows and every other channel.

``q4_matmul`` replaces the TPU kernel ``_matmul_kernel``: x[M, C] @ W
with W unpacked from the nibbles and scaled per group inside the kernel,
so only the packed bytes and the scales leave device memory. Three CUDA
designs compute it, chosen by shape alone (``q4_design``): the decode
kernel csrc/q4_matmul_decode.cu (the weights as mma.sync's register A
operand, a TMA ring, split-K summed inside one cluster launch, tiles from
``q4_decode_plan``) for M <= 16, the prefill kernel
csrc/q4_matmul_wgmma.cu (TMA, wgmma, the dequantization overlapped with
the products) for M > 16, both with N a multiple of 16 and groups of 128,
and csrc/q4_matmul.cu (mma.sync, split-K in a second launch) for every
other shape. On CUDA tensors it launches one of them or raises; on CPU
tensors it runs ``q4_matmul_plain``. ``q4_matmul.launches`` counts every
launch, ``launches_decode``, ``launches_wgmma`` and ``launches_mma`` those
of each design. ``q4einsum`` routes every dense-layer projection
(wq/wk/wv, wo, gate/up/down, lm_head) through them, with the weight
checked once per pair of buffers (``q4_operands``) and a call's Python
kept to the activation's checks and the launch. A mixture of experts'
einsums (the weight [E, C/2, N] with a leading kept expert letter) run
one launch an expert, each expert's slice checked once as well, where the
JAX package dequantizes every expert and runs XLA's einsum: the same
function, without 25 GB of dequantized weights a step at mixtral-8x7b's
width. Any other equation that does not fit dequantizes and runs a plain
einsum on the CPU, as in the JAX package, and raises on the card.

The card runs a kernel for every M >= 1, where the JAX package gives
M < 8 to its XLA formula because of the TPU's tiling; the math is the same.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from substratus_tpu_torch import kernels
from substratus_tpu_torch.ops.fused_decode import sm_count

BLOCK = 128  # pack-fold / scale-group size along the packed dim
KERNEL_BLOCKS = (32, 64, 128)  # groups the CUDA kernels are built for
WGMMA_MIN_M = 16  # rows above which the prefill design serves; up to it the decode design (a step has at most max_batch)


def _pack_block_for(dim: int) -> int:
    """Largest power of two <= BLOCK dividing `dim` (tiny test configs have
    sub-128 dims; every real config dim is a multiple of 128)."""
    b = BLOCK
    while b > 2 and dim % b:
        b //= 2
    if dim % b:
        raise ValueError(f"int4 pack dim {dim} must be even")
    return b


class Q4Tensor(nn.Module):
    """Nibble-packed int4 weight + per-group float32 scale, as buffers, so
    that ``.to(device)`` and ``state_dict`` carry it with the model.

    packed: uint8, original weight rank, pack axis at half size.
    scale:  f32, original rank, pack axis at size dim/block.
    pack_axis: NEGATIVE axis index (stable when a leading layer dim is
        sliced off both buffers).
    block: fold/group size along the pack axis (counted before packing).
    pack_axis and block travel in the state dict as extra state.
    """

    def __init__(self, packed: torch.Tensor, scale: torch.Tensor, pack_axis: int, block: int):
        super().__init__()
        self.register_buffer("packed", packed)
        self.register_buffer("scale", scale)
        self.pack_axis = pack_axis
        self.block = block
        self._operands = None  # q4_operands' checked views of the buffers: (packed, scale, {key: views})

    def _apply(self, fn, *args, **kwargs):
        self._operands = None  # .to() and the like make new buffers: drop the old ones' views
        return super()._apply(fn, *args, **kwargs)

    @classmethod
    def empty(cls, shape: Sequence[int], contracting: Sequence[int], device=None) -> "Q4Tensor":
        """Uninitialized storage of a `shape` weight quantized along
        `contracting` (for load_state_dict)."""
        ax = max(c % len(shape) for c in contracting)
        block = _pack_block_for(shape[ax])
        packed = list(shape)
        packed[ax] //= 2
        scale = list(shape)
        scale[ax] //= block
        return cls(torch.empty(packed, dtype=torch.uint8, device=device),
                   torch.empty(scale, dtype=torch.float32, device=device), ax - len(shape), block)

    @property
    def shape(self) -> Tuple[int, ...]:
        """Logical (unpacked) shape."""
        s = list(self.packed.shape)
        s[self.pack_axis] *= 2
        return tuple(s)

    def get_extra_state(self) -> Dict[str, int]:
        return {"pack_axis": self.pack_axis, "block": self.block}

    def set_extra_state(self, state: Dict[str, int]) -> None:
        self.pack_axis, self.block = int(state["pack_axis"]), int(state["block"])

    def dequant(self, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """Unpack + dequantize to a dense tensor."""
        ax = self.pack_axis % self.packed.ndim
        dim2 = self.packed.shape[ax]
        half = self.block // 2
        pre, post = self.packed.shape[:ax], self.packed.shape[ax + 1:]
        lo, hi = _nibbles(self.packed)
        lo = lo.reshape(*pre, dim2 // half, half, *post)
        hi = hi.reshape(*pre, dim2 // half, half, *post)
        w = torch.cat([lo, hi], dim=ax + 1)  # [.., G, block, ..]
        w = w.float() * self.scale.unsqueeze(ax + 1)
        return w.reshape(*pre, dim2 * 2, *post).to(dtype)


def _nibbles(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sign-extended int8 planes (low, high) from packed uint8: a 4-bit
    value v sign-extends as (v ^ 8) - 8."""
    p = packed.to(torch.int16)
    lo = ((p & 0x0F) ^ 8) - 8
    hi = ((p >> 4) ^ 8) - 8
    return lo.to(torch.int8), hi.to(torch.int8)


@torch.no_grad()
def quantize4(w: torch.Tensor, contracting: Sequence[int]) -> Q4Tensor:
    """Symmetric int4 group quantization: groups of `block` along the last
    contracting dim, per-channel over every other dim. Division and
    round-half-to-even match jnp's, so the bytes are the JAX package's."""
    contracting = tuple(sorted(c % w.ndim for c in contracting))
    ax = contracting[-1]
    dim = w.shape[ax]
    block = _pack_block_for(dim)
    g, half = dim // block, block // 2
    pre, post = w.shape[:ax], w.shape[ax + 1:]
    wf = w.float().reshape(*pre, g, block, *post)
    absmax = wf.abs().amax(dim=ax + 1, keepdim=True)
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax / 7.0)  # [.., G, 1, ..]
    q = torch.clamp(torch.round(wf / scale), -8, 7).to(torch.int8)
    # Block-fold: byte r of each block <- rows (r, r + block/2).
    lo, hi = q.narrow(ax + 1, 0, half), q.narrow(ax + 1, half, half)
    byte = (lo & 0x0F).to(torch.uint8) | ((hi & 0x0F).to(torch.uint8) << 4)
    return Q4Tensor(byte.reshape(*pre, dim // 2, *post), scale.squeeze(ax + 1), ax - w.ndim, block)


def quantize4_params(params: Any, contracting_of: Any) -> Any:
    """quantize4 every leaf of a dict tree with a non-empty entry in
    `contracting_of` (same contract as quant.quantize_params; () = keep
    dense)."""
    if isinstance(params, dict):
        return {k: quantize4_params(v, contracting_of[k]) for k, v in params.items()}
    return quantize4(params, contracting_of) if contracting_of else params


# ---------------------------------------------------------------------------
# x [M, C] @ packed [C/2, N] (scale [C/block, N]) -> [M, N]
# ---------------------------------------------------------------------------


def q4_matmul_plain(x2: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor, block: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: each group dequantized as
    (int4 * scale) in f32 rounded to x's dtype (quant4.py _matmul_kernel),
    the product in f32, the result in x's dtype."""
    c2, n = packed.shape
    half = block // 2
    g = c2 // half
    lo, hi = _nibbles(packed)
    w = torch.cat([lo.reshape(g, half, n), hi.reshape(g, half, n)], dim=1)  # [G, block, N]
    w = (w.float() * scale.reshape(g, 1, n)).reshape(2 * c2, n).to(x2.dtype)
    return torch.matmul(x2.float(), w.float()).to(x2.dtype)


# The decode design, csrc/q4_matmul_decode.cu: its chunk of columns, ring
# depth, cluster limit and shared memory, kept in step with the source.
DECODE_CHUNK = 128
DECODE_RING = 8
DECODE_MAX_SPLITS = 8
DECODE_SMEM = 232448  # a block's dynamic shared memory


def q4_decode_smem(m: int, cpb: int, gps: int, splits: int) -> int:
    """Dynamic shared memory of a q4_matmul_decode.cu block (its
    ``layout``): the ring of packed bytes and scales, x's tiles (m rows
    padded to 8 or 16; one a stage, or with cpb > 1 chunks one for each of
    the gps groups, kept for every chunk), two buffers of the sets'
    sums, the f32 partials of every split of cpb chunks when the groups are
    split (rank 0 sums them), the barriers."""
    rows = 8 if m <= 8 else 16
    x_tiles = gps if cpb > 1 else DECODE_RING
    part = splits * cpb * rows * DECODE_CHUNK * 4 if splits > 1 else 0
    return (DECODE_RING * (BLOCK // 2 * DECODE_CHUNK + DECODE_CHUNK * 4) + x_tiles * rows * BLOCK * 2
            + 2 * DECODE_CHUNK // 16 * 32 * rows // 2 * 4 + part
            + 8 * (2 * DECODE_RING + 1 + (gps if cpb > 1 else 0)) + 1024)


@functools.lru_cache(maxsize=None)
def q4_decode_plan(m: int, n: int, c: int, sms: int, held: Optional[Tuple[int, ...]] = None) -> Tuple[int, int]:
    """(bn, splits) of csrc/q4_matmul_decode.cu for x[m, c] @ W[c, n] on a
    card of `sms` SMs: each block owns bn columns (bn / 128 chunks walked
    in turn) and one of `splits` splits of the c / 128 scale groups, split
    i taking groups [i G / splits, (i + 1) G / splits), so the splits
    differ by at most one group and each has one (splits <= G); the splits
    of a column tile are a cluster. held[s - 1]: how many clusters of s
    blocks the card runs at once (``cluster_capacity``; a block fills an
    SM, and a cluster's blocks share a GPC, so fewer than sms / s), sms //
    s where not given. Among the plans whose shared memory fits: the
    fewest waves, then the least work of a block (counted in stages of one
    group's chunk, a split tile's sum counted as one stage a chunk); then
    fewer splits, fewer chunks."""
    chunks, groups = -(-n // DECODE_CHUNK), c // BLOCK
    best = None
    for splits in range(1, min(DECODE_MAX_SPLITS, groups) + 1):
        gps = -(-groups // splits)
        for cpb in range(1, chunks + 1):
            if q4_decode_smem(m, cpb, gps, splits) > DECODE_SMEM:
                break  # from two chunks on, more only add partials
            slots = held[splits - 1] if held else sms // splits
            tiles = -(-chunks // cpb)
            key = (-(-tiles // max(slots, 1)), cpb * gps + (cpb if splits > 1 else 0), splits, cpb)
            if best is None or key < best[0]:
                best = (key, (cpb * DECODE_CHUNK, splits))
    if best is None:
        raise ValueError(f"q4_decode_plan: no plan fits x[{m}, {c}] @ W[{c}, {n}]")
    return best[1]


@functools.lru_cache(maxsize=None)
def cluster_capacity(device_index: int, m: int) -> Tuple[int, ...]:
    """How many clusters of 1..8 blocks of the decode design (for x of m
    rows) the card runs at once (cudaOccupancyMaxActiveClusters), for
    q4_decode_plan. A block's threads and registers fill an SM, whatever
    its shared memory."""
    lib = kernels.library()
    held = tuple(lib.q4_matmul_decode_clusters(m, s, DECODE_SMEM // 2) for s in range(1, DECODE_MAX_SPLITS + 1))
    if min(held) < 1:
        raise RuntimeError(f"q4_matmul_decode_clusters: {held}")
    return held


def q4_design(m: int, n: int, c: int, block: int) -> str:
    """The CUDA design that serves x[m, c] @ W[c, n] in groups of `block`,
    by shape alone:
    "decode" (csrc/q4_matmul_decode.cu: the weights as mma.sync's register
    A operand, a TMA ring, split-K summed inside one cluster launch) for
    m <= 16 with n a multiple of 16 and groups of 128 -- every llama2-7b
    and llama3-8b projection and lm_head at decode and the 16-token bucket;
    "wgmma" (csrc/q4_matmul_wgmma.cu: TMA rings, each group dequantized in
    registers as wgmma's A operand under the products of the group before)
    for m > 16 with n a multiple of 16 and groups of 128 -- every prefill
    bucket or chunk; "mma" (csrc/q4_matmul.cu: mma.sync, split-K at
    m <= 16) for every other shape (groups of 32 or 64, n a multiple of 8
    but not of 16). A launch that fails raises, it is not retried on
    another design."""
    if n % 16 or block != 128 or c % block:
        return "mma"
    return "wgmma" if m > WGMMA_MIN_M else "decode"


@functools.lru_cache(maxsize=None)
def _mma_splits(m: int, n: int, c: int, block: int, device_index: int) -> int:
    """Split-K factor of csrc/q4_matmul.cu's C loop, chosen by the source
    from the card's SM count (it owns the tile shapes). Cached: a model
    asks the same few shapes on every forward."""
    return kernels.library().q4_matmul_splits(m, n, c, block, sm_count(device_index))


def check_weight(packed: torch.Tensor, scale: torch.Tensor, block: int) -> None:
    """Raise unless the kernels take packed [C/2, N] uint8 and scale
    [C/block, N] f32 as they lie: contiguous, 16-byte aligned, on one
    device, block in KERNEL_BLOCKS, N a multiple of 8. The kernels stream
    the weight as it is: no copies of it."""
    check_weight.calls += 1
    if packed.dtype != torch.uint8 or scale.dtype != torch.float32:
        raise ValueError(f"q4_matmul: packed must be uint8 and scale f32, got {packed.dtype}/{scale.dtype}")
    if block not in KERNEL_BLOCKS:
        raise ValueError(f"q4_matmul: group size {block} not built {KERNEL_BLOCKS}")
    if packed.ndim != 2 or packed.shape[1] % 8 or scale.shape != (2 * packed.shape[0] // block, packed.shape[1]) \
            or (2 * packed.shape[0]) % block:
        raise ValueError(f"q4_matmul: unsupported weight packed{tuple(packed.shape)} scale{tuple(scale.shape)} "
                         f"block {block}")
    if packed.device != scale.device:
        raise ValueError("q4_matmul: packed and scale must be on one device")
    if not (packed.is_contiguous() and scale.is_contiguous()) or (packed.data_ptr() | scale.data_ptr()) % 16:
        raise ValueError("q4_matmul: packed and scale must be contiguous and 16-byte aligned")


check_weight.calls = 0  # weights checked (once per weight on the model's path)


def q4_operands(w: Q4Tensor, nc: int, expert: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """w's packed [C/2, N] and scale [C/block, N] as the kernels take them
    (nc contracted dims flattened into C; of w[expert] for a stacked
    expert weight [E, ...]), checked by check_weight once per pair of
    buffers: the views are kept on w and reused while its buffers are the
    same tensors. ``.to()`` (Q4Tensor._apply), an assignment or
    load_state_dict(assign=True) gives new buffers, which are checked
    again; an in-place load_state_dict keeps buffers and layout."""
    cached = w._operands
    if cached is None or cached[0] is not w.packed or cached[1] is not w.scale:
        cached = w._operands = (w.packed, w.scale, {})
    views = cached[2].get((nc, expert))
    if views is None:
        packed, scale = (w.packed, w.scale) if expert is None else (w.packed[expert], w.scale[expert])
        c = 1
        for d in packed.shape[:nc]:
            c *= d
        p2 = packed.reshape(c, -1)
        s2 = scale.reshape(-1, p2.shape[1])
        check_weight(p2, s2, w.block)
        views = cached[2][(nc, expert)] = (p2, s2)
    return views


def _launch(x2: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor, block: int) -> torch.Tensor:
    """x2 [M, C] on the card @ a weight check_weight has passed: the
    activation's checks and one launch of the design q4_design names."""
    if x2.device.type != "cuda":
        raise ValueError(f"q4_matmul: unsupported device {x2.device}")
    if x2.dtype != torch.bfloat16:
        raise ValueError(f"q4_matmul: the kernel takes bf16 activations, got {x2.dtype}")
    m, c = x2.shape
    c2, n = packed.shape
    if m < 1 or c != 2 * c2 or x2.device != packed.device:
        raise ValueError(f"q4_matmul: x{tuple(x2.shape)} ({x2.device}) does not fit the weight "
                         f"packed{tuple(packed.shape)} ({packed.device})")
    x2 = x2.contiguous()
    if x2.data_ptr() % 16:
        raise ValueError("q4_matmul: x must be 16-byte aligned")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x2.device)
    design = q4_design(m, n, c, block)
    lib, stream = kernels.library(), kernels.stream_ptr(x2.device)
    if design == "decode":
        index = x2.device.index
        bn, splits = q4_decode_plan(m, n, c, sm_count(index), cluster_capacity(index, 8 if m <= 8 else 16))
        rc = lib.q4_matmul_decode(x2.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(), m, n, c,
                                  block, bn, splits, stream)
        kernels.check(rc, "q4_matmul (decode)")
        q4_matmul.launches_decode += 1
    elif design == "wgmma":
        rc = lib.q4_matmul_wgmma(x2.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(), m, n, c,
                                 block, stream)
        kernels.check(rc, "q4_matmul (wgmma)")
        q4_matmul.launches_wgmma += 1
    else:
        splits = _mma_splits(m, n, c, block, x2.device.index)
        ws = torch.empty((splits, m, n), dtype=torch.float32, device=x2.device) if splits > 1 else None
        rc = lib.q4_matmul(x2.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
                           ws.data_ptr() if ws is not None else None, m, n, c, block, splits, stream)
        kernels.check(rc, "q4_matmul")
        q4_matmul.launches_mma += 1
    q4_matmul.launches += 1
    return out


def q4_matmul(x2: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor, block: int) -> torch.Tensor:
    """x2 [M, C] @ int4-packed [C/2, N] -> [M, N] in x2's dtype. CUDA
    tensors launch the design ``q4_design`` names (bf16 x, a weight
    check_weight takes, C a multiple of block) or raise; CPU tensors run
    the plain version. The weight is checked on every call here; q4einsum
    checks a model's weight once (q4_operands)."""
    if x2.device.type == "cpu":
        return q4_matmul_plain(x2, packed, scale, block)
    check_weight(packed, scale, block)
    return _launch(x2, packed, scale, block)


q4_matmul.launches = 0  # every launch
q4_matmul.launches_decode = 0  # csrc/q4_matmul_decode.cu (the decode design)
q4_matmul.launches_wgmma = 0  # csrc/q4_matmul_wgmma.cu (the prefill design)
q4_matmul.launches_mma = 0  # csrc/q4_matmul.cu (every other shape)


@functools.lru_cache(maxsize=None)
def _contracted_count(eq: str, pack_dim: int) -> int:
    """The number of contracted dims when q4einsum's matmul path takes
    `eq` for a weight packed along dim `pack_dim`, else 0. It takes the
    contracted letters trailing in x and leading in w in the same order,
    the pack axis the LAST contracted dim, and kept letters order-preserved
    into the output (x's kept dims before w's). Cached: the model asks the
    same few equations on every forward."""
    ins, out = eq.split("->")
    xsub, wsub = ins.split(",")
    contracted = "".join(c for c in xsub if c not in out)
    nc = len(contracted)
    ok = (
        nc >= 1
        and xsub[-nc:] == contracted
        and wsub[:nc] == contracted
        and pack_dim == nc - 1
        and [l for l in out if l in xsub] + [l for l in out if l in wsub] == list(out)
        and [l for l in xsub if l in out] == [l for l in out if l in xsub]
        and [l for l in wsub if l in out] == [l for l in out if l in wsub]
    )
    return nc if ok else 0


@functools.lru_cache(maxsize=None)
def _expert_split(eq: str, pack_dim: int) -> Optional[Tuple[str, int, int, int]]:
    """(the equation of one expert, x's axis of the expert letter or -1,
    the output's axis of it, the per-expert contracted count) when `eq`'s
    weight leads with a kept letter (an expert axis, kept in the output)
    and the equation without it takes q4einsum's matmul path: the MoE
    expert einsums "bsd,edm->bsem", "bsem,emd->bsed", "ebcd,edm->ebcm" and
    "ebcm,emd->ebcd". Else None."""
    ins, out = eq.split("->")
    xsub, wsub = ins.split(",")
    e = wsub[0]
    if e not in out or pack_dim < 1 or xsub.count(e) > 1:
        return None
    sub = f"{xsub.replace(e, '')},{wsub[1:]}->{out.replace(e, '')}"
    nc = _contracted_count(sub, pack_dim - 1)
    return (sub, xsub.find(e), out.index(e), nc) if nc else None


def _einsum(eq: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """torch.einsum with jnp.einsum's type promotion of mixed operands."""
    ct = torch.promote_types(x.dtype, w.dtype)
    return torch.einsum(eq, x.to(ct), w.to(ct))


def _q4_matmul_nd(x: torch.Tensor, w: Q4Tensor, nc: int, dtype: torch.dtype, expert: Optional[int] = None):
    """x's trailing nc dims contracted with w (or w[expert]) through
    q4_matmul: the plain version on the CPU, one launch on the card."""
    packed, scale = (w.packed, w.scale) if expert is None else (w.packed[expert], w.scale[expert])
    batch_shape = x.shape[:-nc]
    m = 1
    for d in batch_shape:
        m *= d
    c = 1
    for d in x.shape[-nc:]:
        c *= d
    x2 = x.reshape(m, c).to(dtype)
    if x2.device.type == "cpu":
        y = q4_matmul_plain(x2, packed.reshape(c // 2, -1), scale.reshape(c // w.block, -1), w.block)
    else:
        y = _launch(x2, *q4_operands(w, nc, expert), w.block)
    return y.reshape(*batch_shape, *packed.shape[nc:])


def q4einsum(eq: str, x: torch.Tensor, w: Q4Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """einsum(eq, x, w) for a nibble-packed int4 weight: x's contracted
    dims flatten into C (for wo, "bshk,hkd->bsd", C = H * hd, folded along
    hd) and go through q4_matmul. The MoE expert einsums (_expert_split)
    run one q4_matmul an expert, stacked on the expert axis. An equation
    that fits neither dequantizes and runs a plain einsum on CPU tensors,
    as the JAX package does, and raises on the card, where every
    projection must reach the kernel."""
    pack_dim = w.pack_axis % w.packed.ndim
    nc = _contracted_count(eq, pack_dim)
    if nc:
        return _q4_matmul_nd(x, w, nc, dtype).to(dtype)
    split = _expert_split(eq, pack_dim)
    if split is not None:
        _, x_axis, out_axis, nc = split
        ys = [_q4_matmul_nd(x if x_axis < 0 else x.select(x_axis, e), w, nc, dtype, e)
              for e in range(w.packed.shape[0])]
        return torch.stack(ys, dim=out_axis).to(dtype)
    if x.device.type != "cpu":
        raise ValueError(f"q4einsum: {eq!r} with the weight packed along axis {w.pack_axis} does not "
                         "fit the int4 kernel (contracted dims trailing in x and leading in w, the "
                         "pack axis the last of them, after at most one leading expert axis)")
    return _einsum(eq, x, w.dequant(dtype))
