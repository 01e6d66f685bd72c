"""Weight-only int4 quantization with a CUDA unpack-dequant matmul (port of
substratus_tpu/ops/quant4.py).

Storage is the JAX package's, byte for byte: two int4 values nibble-pack
into one uint8 along the LAST contracting dim of the weight, block-folded
(within each block of ``block`` rows, byte r holds rows r and r + block/2
as its low and high nibbles), with a symmetric f32 scale (absmax/7, values
clipped to [-8, 7]) per group of ``block`` rows and every other channel.

``q4_matmul`` replaces the TPU kernel ``_matmul_kernel``: x[M, C] @ W
with W unpacked from the nibbles and scaled per group inside the kernel,
so only the packed bytes and the scales leave device memory. Two CUDA
designs compute it, chosen by shape alone (``q4_design``): the prefill
kernel csrc/q4_matmul_wgmma.cu (TMA, wgmma, the dequantization
overlapped with the products) for M > 16 with N a multiple of 16 and
groups of 128, and csrc/q4_matmul.cu (mma.sync, split-K at M <= 16) for
every decode step and every other shape. On CUDA tensors it launches one
of them or raises; on CPU tensors it runs ``q4_matmul_plain``.
``q4_matmul.launches`` counts every launch, ``launches_wgmma`` and
``launches_mma`` those of each design. ``q4einsum`` routes every
dense-layer projection (wq/wk/wv, wo, gate/up/down, lm_head) through it;
an equation that does not fit dequantizes and runs a plain einsum on the
CPU, as in the JAX package, and raises on the card.

The card runs a kernel for every M >= 1, where the JAX package gives
M < 8 to its XLA formula because of the TPU's tiling; the math is the same.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Sequence, Tuple

import torch
from torch import nn

from substratus_tpu_torch import kernels

BLOCK = 128  # pack-fold / scale-group size along the packed dim
KERNEL_BLOCKS = (32, 64, 128)  # groups the CUDA kernels are built for
WGMMA_MIN_M = 16  # rows above which the prefill design serves (a decode step has at most max_batch)


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


@functools.lru_cache(maxsize=None)
def _splits(m: int, n: int, c: int, block: int, device_index: int) -> int:
    """Split-K factor of the kernel's C loop, chosen by csrc/q4_matmul.cu
    from the card's SM count (it owns the tile shapes). Cached: a model
    asks the same few shapes on every forward."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return kernels.library().q4_matmul_splits(m, n, c, block, sms)


def q4_design(m: int, n: int, c: int, block: int) -> str:
    """The CUDA design that serves x[m, c] @ W[c, n] in groups of `block`:
    "wgmma" (csrc/q4_matmul_wgmma.cu: TMA rings, each group dequantized in
    registers as wgmma's A operand under the products of the group before)
    for the prefill regime, m > 16 with n a multiple of 16 (TMA's 16-byte
    row stride of the packed bytes) and groups of 128 -- every llama2-7b
    projection and the lm_head over a prefill bucket or chunk; "mma"
    (csrc/q4_matmul.cu: mma.sync, split-K at m <= 16) for every decode
    step and every other shape (n = 1000, groups of 64). By shape alone:
    a launch that fails raises, it is not retried on the other design."""
    return "wgmma" if m > WGMMA_MIN_M and n % 16 == 0 and block == 128 and c % block == 0 else "mma"


def q4_matmul(x2: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor, block: int) -> torch.Tensor:
    """x2 [M, C] @ int4-packed [C/2, N] -> [M, N] in x2's dtype. CUDA
    tensors launch the design ``q4_design`` names (bf16 x, block in
    KERNEL_BLOCKS, N a multiple of 8, C a multiple of block) or raise; CPU
    tensors run the plain version."""
    if x2.device.type == "cpu":
        return q4_matmul_plain(x2, packed, scale, block)
    if x2.device.type != "cuda":
        raise ValueError(f"q4_matmul: unsupported device {x2.device}")
    m, c = x2.shape
    c2, n = packed.shape
    if x2.dtype != torch.bfloat16:
        raise ValueError(f"q4_matmul: the kernel takes bf16 activations, got {x2.dtype}")
    if block not in KERNEL_BLOCKS:
        raise ValueError(f"q4_matmul: group size {block} not built {KERNEL_BLOCKS}")
    if m < 1 or c != 2 * c2 or c % block or n % 8 or scale.shape != (c // block, n):
        raise ValueError(f"q4_matmul: unsupported shapes x{tuple(x2.shape)} packed{tuple(packed.shape)} "
                         f"scale{tuple(scale.shape)} block {block}")
    if packed.dtype != torch.uint8 or scale.dtype != torch.float32:
        raise ValueError(f"q4_matmul: packed must be uint8 and scale f32, got {packed.dtype}/{scale.dtype}")
    if packed.device != x2.device or scale.device != x2.device:
        raise ValueError("q4_matmul: all operands must be on one device")
    # The kernel streams the weight as it lies: no copies of it.
    if not (packed.is_contiguous() and scale.is_contiguous()) or (packed.data_ptr() | scale.data_ptr()) % 16:
        raise ValueError("q4_matmul: packed and scale must be contiguous and 16-byte aligned")
    x2 = x2.contiguous()
    if x2.data_ptr() % 16:
        raise ValueError("q4_matmul: x must be 16-byte aligned")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x2.device)
    if q4_design(m, n, c, block) == "wgmma":
        rc = kernels.library().q4_matmul_wgmma(
            x2.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(), m, n, c, block,
            kernels.stream_ptr(x2.device),
        )
        kernels.check(rc, "q4_matmul (wgmma)")
        q4_matmul.launches_wgmma += 1
    else:
        splits = _splits(m, n, c, block, x2.device.index)
        ws = torch.empty((splits, m, n), dtype=torch.float32, device=x2.device) if splits > 1 else None
        rc = kernels.library().q4_matmul(
            x2.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None, m, n, c, block, splits,
            kernels.stream_ptr(x2.device),
        )
        kernels.check(rc, "q4_matmul")
        q4_matmul.launches_mma += 1
    q4_matmul.launches += 1
    return out


q4_matmul.launches = 0  # every launch
q4_matmul.launches_wgmma = 0  # csrc/q4_matmul_wgmma.cu (the prefill design)
q4_matmul.launches_mma = 0  # csrc/q4_matmul.cu (decode steps, other shapes)


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


def _einsum(eq: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """torch.einsum with jnp.einsum's type promotion of mixed operands."""
    ct = torch.promote_types(x.dtype, w.dtype)
    return torch.einsum(eq, x.to(ct), w.to(ct))


def q4einsum(eq: str, x: torch.Tensor, w: Q4Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """einsum(eq, x, w) for a nibble-packed int4 weight: x's contracted
    dims flatten into C (for wo, "bshk,hkd->bsd", C = H * hd, folded along
    hd) and go through q4_matmul. An equation that does not fit (the MoE
    expert einsums) dequantizes and runs a plain einsum on CPU tensors, as
    the JAX package does, and raises on the card, where every projection
    must reach the kernel."""
    nc = _contracted_count(eq, w.pack_axis % w.packed.ndim)
    if not nc:
        if x.device.type != "cpu":
            raise ValueError(f"q4einsum: {eq!r} with the weight packed along axis {w.pack_axis} does not "
                             "fit the int4 kernel (contracted dims trailing in x and leading in w, the "
                             "pack axis the last of them)")
        return _einsum(eq, x, w.dequant(dtype))
    batch_shape = x.shape[:-nc]
    m = 1
    for d in batch_shape:
        m *= d
    c = 1
    for d in x.shape[-nc:]:
        c *= d
    x2 = x.reshape(m, c).to(dtype)
    p2 = w.packed.reshape(c // 2, -1)
    n = p2.shape[1]
    s2 = w.scale.reshape(-1, n)
    y = q4_matmul(x2, p2, s2, w.block)
    return y.reshape(*batch_shape, *w.packed.shape[nc:]).to(dtype)
