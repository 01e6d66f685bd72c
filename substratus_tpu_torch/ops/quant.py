"""Quantization (port of substratus_tpu/ops/quant.py): int8 weights, the
w8a8 product, and the int8 KV cache.

Weights: ``QTensor`` holds symmetric per-output-channel int8 values and a
broadcastable f32 scale (contracting dims size 1); ``qeinsum`` applies
the scale after the dot, dequantizes when the scale varies along a
contracted dim, and hands a ``Q4Tensor`` to ``q4einsum`` (ops/quant4.py).
int8 weight-only is plain torch ops, as the JAX package computes it with
XLA ops and has no kernel for it.

w8a8 (``qeinsum_w8a8``, models/llama.py under ``quant_activations``):
each activation row is quantized to int8 with its own f32 scale
(``w8a8_quantize``, csrc/w8a8_quantize.cu on the card), the int8 rows
times the int8 weight sum exactly in s32 and the two scales apply after
the dot (``w8a8_matmul``, csrc/w8a8_matmul.cu: mma.sync s8 x s8 -> s32
with the scales in its epilogue). Neither replaces a TPU kernel: the JAX
package runs XLA ops and an s8 einsum there. Where JAX falls back to the
weight-only product (a Q4Tensor, a scale that varies along a contracted
dim, more than one contracted dim or one that is not x's last: wo's
"bshk,hkd->bsd"), so does the port, decided the same way. CPU tensors run
each kernel's plain version; CUDA tensors launch the kernel or raise.

torch.round rounds half to even, as jnp.round does, so the port's int8
values match the JAX package's bit for bit.
"""
from __future__ import annotations

from typing import Any, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from substratus_tpu_torch import kernels
from substratus_tpu_torch.ops.quant4 import Q4Tensor, _contracted_count, _einsum, _expert_split, q4einsum


class QTensor(nn.Module):
    """int8 values + broadcastable float32 scale (contracting dims size-1),
    as buffers, so that ``.to(device)`` and ``state_dict`` carry them."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)
        self._operands = None  # w8a8_operands' checked views of the buffers: (q, scale, {expert: views})

    @classmethod
    def empty(cls, shape: Sequence[int], contracting: Sequence[int], device=None) -> "QTensor":
        """Uninitialized storage of a `shape` weight quantized along
        `contracting` (for load_state_dict)."""
        axes = {c % len(shape) for c in contracting}
        scale = [1 if i in axes else d for i, d in enumerate(shape)]
        return cls(torch.empty(tuple(shape), dtype=torch.int8, device=device),
                   torch.empty(scale, dtype=torch.float32, device=device))

    def dequant(self, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        return (self.q.float() * self.scale).to(dtype)


@torch.no_grad()
def quantize(w: torch.Tensor, contracting: Sequence[int]) -> QTensor:
    """Symmetric int8 quantization, per-channel over non-contracting dims."""
    wf = w.float()
    absmax = wf.abs().amax(dim=tuple(contracting), keepdim=True)
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax / 127.0)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QTensor(q, scale)


def materialize(w: Any, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """QTensor/Q4Tensor -> dense; dense floating tensors are cast to
    `dtype`."""
    if isinstance(w, (QTensor, Q4Tensor)):
        return w.dequant(dtype)
    if w.is_floating_point() and w.dtype != dtype:
        return w.to(dtype)
    return w


def qeinsum(eq: str, x: torch.Tensor, w: Any, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """einsum(eq, x, w) with scale-after-dot for quantized weights.

    For a QTensor whose scale is constant along every contracted dim
    (per-output-channel, what quantize() produces), the scale commutes out
    of the contraction: einsum(x, q) * scale (with a leading expert axis
    of the weight kept in the output, one such product an expert, stacked
    on that axis). Falls back to
    dequant-then-dot when the scale varies along a contracted dim, and to
    a plain einsum for dense weights; a Q4Tensor goes to q4einsum."""
    if isinstance(w, Q4Tensor):
        return q4einsum(eq, x, w, dtype)
    if not isinstance(w, QTensor):
        return _einsum(eq, x, materialize(w, dtype))
    ins, out = eq.split("->")
    xsub, wsub = ins.split(",")
    for i, letter in enumerate(wsub):
        if letter not in out and w.scale.shape[i] != 1:
            return _einsum(eq, x, w.dequant(dtype))
    e = wsub[0]
    if e in out and xsub.count(e) <= 1:
        # A leading kept axis of the weight (a mixture of experts' expert
        # axis): one product an expert, so that each expert's bf16 copy is
        # an expert's (117 MB at mixtral-8x7b's width, not 940) and the
        # einsum never lays the whole weight out again.
        sub_out = out.replace(e, "")
        sub = f"{xsub.replace(e, '')},{wsub[1:]}->{sub_out}"
        ys = [_einsum(sub, x if e not in xsub else x.select(xsub.index(e), i), w.q[i].to(dtype))
              * _scale_for_out(w.scale[i], wsub[1:], sub_out).to(dtype) for i in range(w.q.shape[0])]
        return torch.stack(ys, dim=out.index(e))
    y = _einsum(eq, x, w.q.to(dtype))
    return y * _scale_for_out(w.scale, wsub, out).to(dtype)


def _scale_for_out(scale: torch.Tensor, opsub: str, out: str) -> torch.Tensor:
    """Reshape an operand-indexed scale (contracted dims size-1) so it
    broadcasts against the einsum output. A plain reshape scrambles values
    when the kept letters are permuted between operand and output (e.g.
    'bsd,dhk->bhsk' vs '->bshk'), so transpose the kept dims into output
    order first when needed."""
    kept = [i for i, letter in enumerate(opsub) if letter in out]
    order = sorted(kept, key=lambda i: out.index(opsub[i]))
    if order != kept:
        perm = order + [i for i in range(len(opsub)) if i not in kept]
        scale = scale.permute(perm)
        opsub = "".join(opsub[i] for i in perm)
    shape = [1] * len(out)
    for i, letter in enumerate(opsub):
        if letter in out:
            shape[out.index(letter)] = scale.shape[i]
    return scale.reshape(shape)


def w8a8_quantize_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xq int8, ascale f32 [..., 1]): per-row symmetric int8 over x's
    last dim, the JAX formula: ascale = where(amax == 0, 1, amax / 127)
    in f32, xq = clip(round(x / ascale), -127, 127). Both divisions by a
    tensor (on the card a Python-scalar divisor is a multiply by its
    reciprocal, an ulp off at times)."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    ascale = torch.where(amax == 0, torch.ones_like(amax), amax / amax.new_full((), 127.0))
    return torch.clamp(torch.round(x32 / ascale), -127, 127).to(torch.int8), ascale


def w8a8_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """w8a8_quantize_plain's result: the plain version for CPU tensors;
    on the card one launch of csrc/w8a8_quantize.cu, which takes bf16 rows
    of a width that is a multiple of 8, else raises."""
    if x.device.type == "cpu":
        return w8a8_quantize_plain(x)
    c = x.shape[-1]
    if x.device.type != "cuda" or x.dtype != torch.bfloat16 or c % 8 or x.numel() == 0:
        raise ValueError(f"w8a8_quantize: the kernel takes non-empty bf16 CUDA rows of a multiple of 8 values, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    x2 = x.reshape(-1, c)
    if x2.stride(1) != 1 or x2.stride(0) % 8 or x2.data_ptr() % 16:
        x2 = x2.contiguous()
    xq = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    ascale = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    rc = kernels.library().w8a8_quantize(x2.data_ptr(), x2.stride(0), xq.data_ptr(), None, ascale.data_ptr(),
                                         x2.shape[0], c, 0, kernels.stream_ptr(x.device))
    kernels.check(rc, "w8a8_quantize")
    w8a8_quantize.launches += 1
    return xq, ascale


w8a8_quantize.launches = 0  # every launch of csrc/w8a8_quantize.cu
w8a8_quantize.launches_amax = 0  # mode 1: the rows' amax of a slice (row-parallel)
w8a8_quantize.launches_scaled = 0  # mode 2: the values from a given amax (row-parallel)


def w8a8_scaled_plain(x: torch.Tensor, amax: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """w8a8_quantize_plain's (xq, ascale) with each row's amax given
    (amax [..., 1] f32: a max over more than x's own values)."""
    ascale = torch.where(amax == 0, torch.ones_like(amax), amax / amax.new_full((), 127.0))
    return torch.clamp(torch.round(x.float() / ascale), -127, 127).to(torch.int8), ascale


def _rows_launch(x: torch.Tensor, mode: int, amax=None):
    """One launch of csrc/w8a8_quantize.cu's row-parallel modes over x's
    rows (bf16 on the card, a width a multiple of 8), else a raise."""
    c = x.shape[-1]
    if x.device.type != "cuda" or x.dtype != torch.bfloat16 or c % 8 or x.numel() == 0:
        raise ValueError(f"w8a8_quantize: the kernel takes non-empty bf16 CUDA rows of a multiple of 8 values, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    x2 = x.reshape(-1, c)
    if x2.stride(1) != 1 or x2.stride(0) % 8 or x2.data_ptr() % 16:
        x2 = x2.contiguous()
    xq = ascale = None
    if mode == 1:
        amax = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    else:
        xq = torch.empty(x.shape, dtype=torch.int8, device=x.device)
        ascale = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    rc = kernels.library().w8a8_quantize(x2.data_ptr(), x2.stride(0), None if xq is None else xq.data_ptr(),
                                         amax.contiguous().data_ptr(), None if ascale is None else ascale.data_ptr(),
                                         x2.shape[0], c, mode, kernels.stream_ptr(x.device))
    kernels.check(rc, "w8a8_quantize (row-parallel)")
    w8a8_quantize.launches += 1
    return amax if mode == 1 else (xq, ascale)


def w8a8_row_amax(x: torch.Tensor) -> torch.Tensor:
    """Each row's amax of x as f32 [..., 1] (the first half of a
    row-parallel quantization): the plain ops on the CPU, csrc/
    w8a8_quantize.cu's mode 1 on the card."""
    if x.device.type == "cpu":
        return x.float().abs().amax(dim=-1, keepdim=True)
    out = _rows_launch(x, 1)
    w8a8_quantize.launches_amax += 1
    return out


def w8a8_quantize_scaled(x: torch.Tensor, amax: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """w8a8_scaled_plain's result (the second half): the plain version on
    the CPU, csrc/w8a8_quantize.cu's mode 2 on the card."""
    if x.device.type == "cpu":
        return w8a8_scaled_plain(x, amax)
    out = _rows_launch(x, 2, amax)
    w8a8_quantize.launches_scaled += 1
    return out


def w8a8_matmul_plain(xq2: torch.Tensor, wq2: torch.Tensor) -> torch.Tensor:
    """The exact s32 product xq2 [M, C] int8 @ wq2 [C, N] int8: int32
    torch.mm on the CPU; on the card float64, exact below 2^53 (|sum| <=
    127^2 C), as CUDA has no integer matmul."""
    if xq2.device.type == "cpu":
        return torch.mm(xq2.int(), wq2.int())
    return torch.mm(xq2.double(), wq2.double()).to(torch.int32)


def w8a8_scale(y: torch.Tensor, ascale1: torch.Tensor, wscale1: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The epilogue of the w8a8 product, in the JAX formula's order:
    (y.f32 * ascale[m]) * wscale[n], then the cast."""
    return (y.float() * ascale1[:, None] * wscale1).to(dtype)


def w8a8_matmul(xq2: torch.Tensor, ascale1: torch.Tensor, wq2: torch.Tensor, wscale1: torch.Tensor,
                out2: torch.Tensor, raw: bool = False) -> torch.Tensor:
    """out2 [M, N] = w8a8_scale(xq2 @ wq2, ascale1, wscale1) in out2's
    dtype (raw: out2 int32 takes the s32 sums). xq2 [M, C] int8 and out2
    may be strided row views (an expert's slice), ascale1 [M] f32 likewise,
    wq2 [C, N] int8 and wscale1 [N] f32 contiguous. CPU tensors run the
    plain version; CUDA tensors one launch of csrc/w8a8_matmul.cu (bf16
    out, or int32 raw; C, N and the row strides multiples of 16, 8 for
    out2; 16-byte aligned), else it raises."""
    if xq2.device.type == "cpu":
        y = w8a8_matmul_plain(xq2, wq2)
        return out2.copy_(y if raw else w8a8_scale(y, ascale1, wscale1, out2.dtype))
    m, c = xq2.shape
    n = wq2.shape[1]
    want = torch.int32 if raw else torch.bfloat16
    if (xq2.dtype != torch.int8 or wq2.dtype != torch.int8 or ascale1.dtype != torch.float32
            or wscale1.dtype != torch.float32 or out2.dtype != want or xq2.device.type != "cuda"
            or len({t.device for t in (xq2, ascale1, wq2, wscale1, out2)}) != 1):
        raise ValueError(f"w8a8_matmul: the kernel takes int8 x and W with f32 scales into {want} on one card, got "
                         f"{xq2.dtype}/{wq2.dtype}/{ascale1.dtype}/{wscale1.dtype} -> {out2.dtype}")
    if (wq2.shape[0] != c or tuple(out2.shape) != (m, n) or ascale1.shape != (m,) or wscale1.shape != (n,)
            or m < 1 or c % 16 or n % 16 or xq2.stride(1) != 1 or xq2.stride(0) % 16 or out2.stride(1) != 1
            or out2.stride(0) % 8 or not wq2.is_contiguous() or not wscale1.is_contiguous()
            or (xq2.data_ptr() | wq2.data_ptr() | wscale1.data_ptr() | out2.data_ptr()) % 16):
        raise ValueError(f"w8a8_matmul: unsupported operands x{tuple(xq2.shape)}/{xq2.stride()} "
                         f"W{tuple(wq2.shape)} out{tuple(out2.shape)}/{out2.stride()}: C and N multiples of 16, "
                         "rows contiguous with 16-byte aligned strides")
    rc = kernels.library().w8a8_matmul(xq2.data_ptr(), xq2.stride(0), ascale1.data_ptr(), ascale1.stride(0),
                                       wq2.data_ptr(), wscale1.data_ptr(), out2.data_ptr(), out2.stride(0),
                                       int(raw), m, n, c, kernels.stream_ptr(xq2.device))
    kernels.check(rc, "w8a8_matmul")
    w8a8_matmul.launches += 1
    return out2


w8a8_matmul.launches = 0


def w8a8_operands(w: QTensor, c: int, expert=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """w's int8 values [C, N] and f32 scales [N] (of w[expert] for a
    stacked expert weight), as w8a8_matmul takes them, made once per pair
    of buffers and kept on w while its buffers are the same tensors (an
    in-place load or swap keeps them)."""
    cached = w._operands
    if cached is None or cached[0] is not w.q or cached[1] is not w.scale:
        cached = w._operands = (w.q, w.scale, {})
    views = cached[2].get(expert)
    if views is None:
        q, scale = (w.q, w.scale) if expert is None else (w.q[expert], w.scale[expert])
        q2 = q.reshape(c, -1)
        views = cached[2][expert] = (q2, scale.expand(1, *q.shape[1:]).reshape(-1))
    return views


def _rows(t: torch.Tensor, width: int) -> torch.Tensor:
    """t as a [rows, width] view (no copy), for a kernel that steps rows by
    a stride; raises when t's leading dims do not merge into one stride."""
    try:
        return t.view(-1, width)
    except RuntimeError:
        raise ValueError(f"w8a8: a {tuple(t.shape)} slice with strides {t.stride()} is not rows of one "
                         "stride") from None


def qeinsum_w8a8(eq: str, x: torch.Tensor, w: Any, dtype: torch.dtype = torch.bfloat16, tp=None) -> torch.Tensor:
    """qeinsum with dynamic per-token activation quantization (JAX's
    qeinsum_w8a8): both operands int8, the product summed exactly in s32,
    then (y.f32 * ascale * wscale).to(dtype).

    With `tp` (a parallel.sharding.TensorShard) the product is
    row-parallel: x holds this rank's slice of the contracted dim and w the
    matching rows, and the result is JAX's qeinsum_w8a8 on the whole
    operands as GSPMD partitions it: each row's amax of the slice is
    all-reduced (MAX, f32) over the tensor group before the quantization,
    and the s32 partial products are all-reduced (SUM, int32: |sum| <=
    127^2 C stays below 2^31) before the scales apply. A product this path
    does not take sums its weight-only result over the group instead.

    It takes (a) a per-output-channel QTensor and (b) an activation whose
    LAST dim is the single contracted dim, as JAX decides: the q/k/v,
    gate/up/down and lm_head projections and the expert einsums; anything
    else (a Q4Tensor or dense weight, wo's "bshk,hkd->bsd") goes to
    qeinsum, weight-only. x is quantized once (one w8a8_quantize), then
    each product is a w8a8_matmul: one for a dense equation, one an
    expert for a weight with a leading kept expert axis, each writing its
    slice of the output in place. On the CPU an equation that is neither
    runs an exact int32 einsum, as JAX's s8 einsum; on the card it raises."""
    def fallback():
        y = qeinsum(eq, x, w, dtype)
        return y if tp is None else tp.reduce(y)

    if not isinstance(w, QTensor):
        return fallback()
    ins, out = eq.split("->")
    xsub, wsub = ins.split(",")
    contracted = [c for c in xsub if c not in out]
    if len(contracted) != 1 or xsub[-1] != contracted[0]:
        return fallback()
    for i, letter in enumerate(wsub):
        if letter not in out and w.scale.shape[i] != 1:
            return fallback()
    if tp is None:
        xq, ascale = w8a8_quantize(x)
    else:
        xq, ascale = w8a8_quantize_scaled(x, tp.reduce(w8a8_row_amax(x), op=dist.ReduceOp.MAX))
    sizes = dict(zip(xsub, x.shape))
    sizes.update(zip(wsub, w.q.shape))
    c = x.shape[-1]
    shape = [sizes[letter] for letter in out]
    y = torch.empty(shape, dtype=dtype, device=x.device)
    # Row-parallel: the s32 partials first, summed over the group, then the
    # epilogue (w8a8_scale, the kernel's own formula) into y.
    raw = None if tp is None else torch.empty(shape, dtype=torch.int32, device=x.device)
    if _contracted_count(eq, 0) == 1:
        q2, s1 = w8a8_operands(w, c)
        a1 = ascale.reshape(-1)
        if raw is None:
            w8a8_matmul(xq.reshape(-1, c), a1, q2, s1, y.view(-1, q2.shape[1]))
            return y
        w8a8_matmul(xq.reshape(-1, c), a1, q2, s1, raw.view(-1, q2.shape[1]), raw=True)
        y.view(-1, q2.shape[1]).copy_(w8a8_scale(tp.reduce(raw).view(-1, q2.shape[1]), a1, s1, dtype))
        return y
    split = _expert_split(eq, 1)
    if split is not None and split[3] == 1:
        _, x_axis, out_axis, _ = split
        for e in range(w.q.shape[0]):
            xe, ae = (xq, ascale) if x_axis < 0 else (xq.select(x_axis, e), ascale.select(x_axis, e))
            q2, s1 = w8a8_operands(w, c, e)
            dest = y if raw is None else raw
            w8a8_matmul(_rows(xe, c), _rows(ae, 1)[:, 0], q2, s1, _rows(dest.select(out_axis, e), q2.shape[1]),
                        raw=raw is not None)
        if raw is not None:
            tp.reduce(raw)
            for e in range(w.q.shape[0]):
                ae = ascale if x_axis < 0 else ascale.select(x_axis, e)
                ye = _rows(y.select(out_axis, e), w.q.shape[-1])
                ye.copy_(w8a8_scale(_rows(raw.select(out_axis, e), w.q.shape[-1]), _rows(ae, 1)[:, 0],
                                    w8a8_operands(w, c, e)[1], dtype))
        return y
    if tp is not None:
        raise ValueError(f"qeinsum_w8a8: {eq!r} has no row-parallel form here")
    if x.device.type != "cpu":
        raise ValueError(f"qeinsum_w8a8: {eq!r} does not fit the w8a8 kernel (the contracted dim last in x and "
                         "first in w, kept dims in order, after at most one leading expert axis)")
    y = torch.einsum(eq, xq.int(), w.q.int())
    return (y.float() * _scale_for_out(ascale, xsub, out) * _scale_for_out(w.scale, wsub, out)).to(dtype)


def is_quantized(params: Any) -> bool:
    """True if any leaf of a module or dict tree is a QTensor/Q4Tensor."""
    if isinstance(params, (QTensor, Q4Tensor)):
        return True
    if isinstance(params, nn.Module):
        return any(isinstance(m, (QTensor, Q4Tensor)) for m in params.modules())
    if isinstance(params, dict):
        return any(is_quantized(v) for v in params.values())
    return False


def quantize_params(params: Any, contracting_of: Any) -> Any:
    """Quantize every leaf of a dict tree with a non-empty entry in
    `contracting_of` (a matching tree of contracting-dim tuples; the empty
    tuple keeps the leaf dense: norms and embeddings)."""
    if isinstance(params, dict):
        return {k: quantize_params(v, contracting_of[k]) for k, v in params.items()}
    return quantize(params, contracting_of) if contracting_of else params


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-vector symmetric int8 over the trailing head_dim; the f32
    scale keeps a size-1 trailing dim."""
    x32 = x.float()
    absmax = x32.abs().amax(dim=-1, keepdim=True)
    # A tensor divisor: on the card, PyTorch divides by a Python scalar as a
    # multiply by its reciprocal, an ulp off the quotient the CPU (and JAX)
    # computes at times; this keeps the card's pages bit for bit the CPU's.
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax / absmax.new_full((), 127.0))
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(
    q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    return (q.float() * scale).to(dtype)
