"""Quantization (port of substratus_tpu/ops/quant.py): int8 weights, and
the int8 KV cache.

Weights: ``QTensor`` holds symmetric per-output-channel int8 values and a
broadcastable f32 scale (contracting dims size 1); ``qeinsum`` applies
the scale after the dot, dequantizes when the scale varies along a
contracted dim, and hands a ``Q4Tensor`` to ``q4einsum`` (ops/quant4.py).
int8 weight-only is plain torch ops, as the JAX package computes it with
XLA ops and has no kernel for it; its int8 x int8 activation path
(``qeinsum_w8a8``) is not ported.

torch.round rounds half to even, as jnp.round does, so the port's int8
values match the JAX package's bit for bit.
"""
from __future__ import annotations

from typing import Any, Sequence, Tuple

import torch
from torch import nn

from substratus_tpu_torch.ops.quant4 import Q4Tensor, _einsum, q4einsum


class QTensor(nn.Module):
    """int8 values + broadcastable float32 scale (contracting dims size-1),
    as buffers, so that ``.to(device)`` and ``state_dict`` carry them."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)

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
