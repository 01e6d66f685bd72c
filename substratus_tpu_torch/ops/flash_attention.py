"""Flash attention: CUDA kernels, each beside its plain PyTorch version.

* ``flash_attention`` replaces
  substratus_tpu/ops/flash_attention.py::_flash_kernel, the no-cache
  prefill attention of the serving path and the forward of training. Two
  designs compute it, chosen by shape alone (``flash_fwd_design``):
  csrc/flash_fwd_wgmma.cu (wgmma, a TMA ring, a producer warpgroup) at
  head_dim 64 and 128, every model but ``tiny``; csrc/flash_fwd.cu
  (mma.sync) at 16, 32 and 256.
* ``flash_cached_attention`` replaces ``_cached_kernel``: a multi-token
  chunk against the dense slot cache (every chunk of a chunked prefill),
  per-row limits from the query positions, bf16 or int8 cache
  (``flash_cached_design``: csrc/flash_fwd_wgmma.cu at head_dim 64 and
  128, csrc/flash_cached.cu at 16, 32 and 256).

* ``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkv`` replace
  ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``, the training backward:
  ``FlashAttention`` (a torch.autograd.Function, the counterpart of the
  JAX custom_vjp) saves q, k, v, out and the LSE of the forward kernel and
  calls both. Two designs compute them, chosen by head_dim alone
  (``flash_bwd_design``): csrc/flash_bwd_wgmma.cu (wgmma, TMA rings, a
  producer warpgroup) at head_dim 64 and 128, every model but ``tiny``;
  csrc/flash_bwd.cu (mma.sync) at 16, 32 and 256. See the source notes.

Each wrapper serves any head dim up to 256 (ops/headdim.py): one the
kernels are not built for runs padded with zero columns to the next built
size, at the true softmax scale, and comes back sliced (the cached flash
takes q at the true D against a cache laid out at the padded one). Each
wrapper launches its kernel for CUDA tensors (or raises) and runs the
plain version only for tensors on the CPU. ``flash_attention.launches``,
``flash_cached_attention.launches``, ``flash_attention_bwd_dq.launches``
and ``flash_attention_bwd_dkv.launches`` count kernel launches (each one's
``launches_wgmma`` and ``launches_mma`` those of each design,
``launches_padded`` those at a padded head dim). See the source notes in
csrc/ for each design and its bound.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from substratus_tpu_torch import kernels
from substratus_tpu_torch.ops.headdim import HEAD_DIMS, pad_head, padded_head_dim

NEG_INF = -1e30


def flash_attention_plain(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, KH, D]
    v: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
    return_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The kernel's function in plain PyTorch: f32 scores, causal mask
    col <= row, p = exp(s - m) rounded to v's dtype for the PV product,
    out = (p . v) / l; LSE [B*H, Sq] = m + log(l)."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    if scale is None:
        scale = d**-0.5
    qf = q.float().reshape(b, sq, kh, g, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * scale
    if causal:
        live = torch.arange(sk, device=q.device)[None, :] <= torch.arange(sq, device=q.device)[:, None]
        s = torch.where(live, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if causal:
        p = torch.where(live, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    pv = p.to(v.dtype).float()
    l_safe = torch.where(l == 0, 1.0, l)
    out = torch.einsum("bkgqs,bskd->bqkgd", pv, v.float()) / l_safe.permute(0, 3, 1, 2, 4)
    out = out.reshape(b, sq, h, d).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l == 0, NEG_INF, m + torch.log(l_safe))  # [B, KH, G, Sq, 1]
    return out, lse.reshape(b * h, sq)


def _check_qkv(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *more: torch.Tensor):
    """The checks every flash kernel of this module makes on [B, S, H|KH,
    D] operands; returns them contiguous (`more` must be shaped like q)."""
    b, sq, h, d = q.shape
    kh = k.shape[2]
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16) or any(t.dtype != q.dtype for t in more):
        raise ValueError(
            f"{name}: the kernel takes bf16 operands, got {q.dtype}/{k.dtype}/{v.dtype} "
            "(attn_impl='plain' serves other dtypes)"
        )
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} above {HEAD_DIMS[-1]}, the largest the kernels take (a smaller one "
                         "runs padded to the next built size)")
    if (k.shape[-1] != d or v.shape != k.shape or k.shape[0] != b
            or any(t.shape != q.shape for t in more)):
        raise ValueError(f"{name}: unsupported shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    if h % kh:
        raise ValueError(f"{name}: {h} query heads not a multiple of {kh} kv heads")
    if any(t.device != q.device for t in (k, v) + more):
        raise ValueError(f"{name}: all operands must be on one device")
    tensors = tuple(t.contiguous() for t in (q, k, v) + more)
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: operands must be 16-byte aligned (the kernel loads 16-byte rows)")
    return tensors


def flash_attention(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, KH, D]
    v: torch.Tensor,  # [B, Sk, KH, D]
    causal: bool = True,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Self-attention (no cache) over [B, S, H|KH, D]; returns the output
    in q's dtype, and with return_lse the f32 row logsumexp [B*H, Sq].

    When autograd records (grad enabled and an input requires grad) the
    call goes through FlashAttention, whose backward runs the two backward
    kernels; otherwise only the forward kernel runs, without the LSE."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if return_lse:
            raise ValueError("flash_attention: return_lse is not differentiable")
        return FlashAttention.apply(q, k, v, causal, scale)
    return _flash_forward(q, k, v, causal, scale, return_lse)


def flash_fwd_design(d: int) -> str:
    """The CUDA design of the forward kernel at head_dim d: "wgmma"
    (csrc/flash_fwd_wgmma.cu: wgmma, a TMA ring of K/V tiles, 128 query
    rows a block) at 64 and 128, "mma" (csrc/flash_fwd.cu: mma.sync, 64
    rows a block) at 16, 32 and 256. 64-row blocks of the wgmma design were
    slower at both the serving and the training shape (PERF.md), so
    no other shape picks them. By shape alone: a launch that fails raises,
    it is not retried on the other design."""
    return "wgmma" if d in (64, 128) else "mma"


def _flash_forward(q, k, v, causal: bool, scale: float, return_lse: bool):
    """The forward kernel's launch (or, for CPU tensors, its plain version);
    a head dim not built runs padded (q, k, v) and is sliced back (the LSE
    is the padded run's: zero columns change no score)."""
    d = q.shape[-1]
    dp = padded_head_dim(d)
    if dp is not None and dp != d:
        res = _flash_forward(pad_head(q, dp), pad_head(k, dp), pad_head(v, dp), causal, scale, return_lse)
        if q.device.type == "cuda":
            flash_attention.launches_padded += 1
        return (res[0][..., :d], res[1]) if return_lse else res[..., :d]
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, scale, return_lse)
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    q, k, v = _check_qkv("flash_attention", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device) if return_lse else None
    wgmma = flash_fwd_design(d) == "wgmma"
    name = "flash_fwd_wgmma" if wgmma else "flash_fwd"
    rc = getattr(kernels.library(), name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        b, sq, sk, h, kh, d, kernels.DTYPE_CODES[q.dtype], float(scale), int(causal),
        kernels.stream_ptr(q.device),
    )
    kernels.check(rc, name)
    flash_attention.launches += 1
    if wgmma:
        flash_attention.launches_wgmma += 1
    else:
        flash_attention.launches_mma += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0  # every launch
flash_attention.launches_wgmma = 0  # csrc/flash_fwd_wgmma.cu (head_dim 64, 128)
flash_attention.launches_mma = 0  # csrc/flash_fwd.cu (head_dim 16, 32, 256)
flash_attention.launches_padded = 0  # at a head dim padded to a built one (ops/headdim.py)


def _bwd_probs(q, k, v, do, lse, delta, causal: bool, scale: float):
    """p and ds [B, KH, G, Sq, Sk] of the Pallas backward kernels, in f32
    with the values of q's dtype: f32 scores times scale, the col <= row
    mask, p = exp(s - lse) (0 where masked), ds = p (dO.V^T - D) scale;
    both rounded to q's dtype before their products."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float().reshape(b, sq, kh, g, d), k.float()) * scale
    lse = lse.reshape(b, kh, g, sq, 1)
    p = torch.exp(s - lse)
    if causal:
        live = torch.arange(sk, device=q.device)[None, :] <= torch.arange(sq, device=q.device)[:, None]
        p = torch.where(live, p, 0.0)
    dp = torch.einsum("bqkgd,bskd->bkgqs", do.float().reshape(b, sq, kh, g, d), v.float())
    ds = p * (dp - delta.reshape(b, kh, g, sq, 1)) * scale
    return p.to(q.dtype).float(), ds.to(q.dtype).float()


def _bwd_dq_plain(q, k, v, do, lse, delta, causal: bool, scale: float) -> torch.Tensor:
    b, sq, h, d = q.shape
    _, ds = _bwd_probs(q, k, v, do, lse, delta, causal, scale)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float())
    return dq.reshape(b, sq, h, d).to(q.dtype)


def _bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool, scale: float):
    b, sq, h, d = q.shape
    kh = k.shape[2]
    p, ds = _bwd_probs(q, k, v, do, lse, delta, causal, scale)
    qf = q.float().reshape(b, sq, kh, h // kh, d)
    dof = do.float().reshape(b, sq, kh, h // kh, d)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf)  # the GQA group summed in f32
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    return dk.to(k.dtype), dv.to(v.dtype)


def bwd_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO * O) in f32, [B*H, Sq] like the LSE (plain torch, as
    it is XLA work in the JAX package). O is promoted to f32 inside the
    multiply: one f32 copy of [B, Sq, H, D] fewer than with O.float()."""
    b, sq, h, _ = out.shape
    return (do.float() * out).sum(-1).transpose(1, 2).reshape(b * h, sq).contiguous()


def flash_attention_bwd_plain(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, KH, D]
    v: torch.Tensor,
    out: torch.Tensor,  # [B, Sq, H, D], the forward's output
    lse: torch.Tensor,  # [B*H, Sq] f32, the forward's row logsumexp
    do: torch.Tensor,  # [B, Sq, H, D], the output's gradient
    causal: bool = True,
    scale: Optional[float] = None,
):
    """(dq, dk, dv) of flash attention in plain PyTorch, following the
    Pallas _bwd_dq_kernel / _bwd_dkv_kernel (not autograd of the forward):
    f32 scores, the col <= row mask, p = exp(s - lse) recomputed, ds = p
    (dO.V^T - D) scale, ds and p rounded to the input dtype before their
    products, dK/dV summed over the GQA group."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    delta = bwd_delta(out, do)
    return (_bwd_dq_plain(q, k, v, do, lse, delta, causal, scale),
            *_bwd_dkv_plain(q, k, v, do, lse, delta, causal, scale))


def flash_bwd_design(d: int) -> str:
    """The CUDA design of the backward kernels at head_dim d: "wgmma"
    (csrc/flash_bwd_wgmma.cu: TMA rings, wgmma products, 128 rows a block)
    at 64 and 128, "mma" (csrc/flash_bwd.cu: mma.sync) at 16, 32 and 256. By
    shape alone: a launch that fails raises, it is not retried on the
    other design."""
    return "wgmma" if d in (64, 128) else "mma"


def _check_stats(name: str, q: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor):
    b, sq, h, _ = q.shape
    for t in (lse, delta):
        if t.shape != (b * h, sq) or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(f"{name}: lse and delta must be f32 [B*H, Sq] = [{b * h}, {sq}] on q's device")
    return lse.contiguous(), delta.contiguous()


def flash_attention_bwd_dq(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, KH, D]
    v: torch.Tensor,
    do: torch.Tensor,  # [B, Sq, H, D]
    lse: torch.Tensor,  # [B*H, Sq] f32
    delta: torch.Tensor,  # [B*H, Sq] f32, bwd_delta(out, do)
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """dQ [B, Sq, H, D] in q's dtype. CUDA tensors launch the kernel (or
    raise); CPU tensors run the plain version."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    d = q.shape[-1]
    dp = padded_head_dim(d)
    if dp is not None and dp != d:  # q, k, v and dO padded, dQ sliced
        dq = flash_attention_bwd_dq(*(pad_head(t, dp) for t in (q, k, v, do)), lse, delta, causal, scale)
        if q.device.type == "cuda":
            flash_attention_bwd_dq.launches_padded += 1
        return dq[..., :d]
    if q.device.type == "cpu":
        return _bwd_dq_plain(q, k, v, do, lse, delta, causal, scale)
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    q, k, v, do = _check_qkv("flash_attention_bwd_dq", q, k, v, do)
    lse, delta = _check_stats("flash_attention_bwd_dq", q, lse, delta)
    dq = torch.empty_like(q)
    wgmma = flash_bwd_design(d) == "wgmma"
    name = "flash_bwd_dq_wgmma" if wgmma else "flash_bwd_dq"
    rc = getattr(kernels.library(), name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), b, sq, sk, h, kh, d, kernels.DTYPE_CODES[q.dtype], float(scale), int(causal),
        kernels.stream_ptr(q.device),
    )
    kernels.check(rc, name)
    flash_attention_bwd_dq.launches += 1
    if wgmma:
        flash_attention_bwd_dq.launches_wgmma += 1
    else:
        flash_attention_bwd_dq.launches_mma += 1
    return dq


flash_attention_bwd_dq.launches = 0  # every launch
flash_attention_bwd_dq.launches_wgmma = 0  # csrc/flash_bwd_wgmma.cu (head_dim 64, 128)
flash_attention_bwd_dq.launches_mma = 0  # csrc/flash_bwd.cu (head_dim 16, 32, 256)
flash_attention_bwd_dq.launches_padded = 0  # at a padded head dim


def flash_attention_bwd_dkv(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, KH, D]
    v: torch.Tensor,
    do: torch.Tensor,  # [B, Sq, H, D]
    lse: torch.Tensor,  # [B*H, Sq] f32
    delta: torch.Tensor,  # [B*H, Sq] f32
    causal: bool = True,
    scale: Optional[float] = None,
):
    """(dK, dV) [B, Sk, KH, D] in k's dtype, summed over each kv head's
    query heads. CUDA tensors launch the kernel (or raise); CPU tensors run
    the plain version."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    d = q.shape[-1]
    dp = padded_head_dim(d)
    if dp is not None and dp != d:  # q, k, v and dO padded, dK and dV sliced
        dk, dv = flash_attention_bwd_dkv(*(pad_head(t, dp) for t in (q, k, v, do)), lse, delta, causal, scale)
        if q.device.type == "cuda":
            flash_attention_bwd_dkv.launches_padded += 1
        return dk[..., :d], dv[..., :d]
    if q.device.type == "cpu":
        return _bwd_dkv_plain(q, k, v, do, lse, delta, causal, scale)
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    q, k, v, do = _check_qkv("flash_attention_bwd_dkv", q, k, v, do)
    lse, delta = _check_stats("flash_attention_bwd_dkv", q, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    wgmma = flash_bwd_design(d) == "wgmma"
    name = "flash_bwd_dkv_wgmma" if wgmma else "flash_bwd_dkv"
    rc = getattr(kernels.library(), name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, sq, sk, h, kh, d, kernels.DTYPE_CODES[q.dtype], float(scale),
        int(causal), kernels.stream_ptr(q.device),
    )
    kernels.check(rc, name)
    flash_attention_bwd_dkv.launches += 1
    if wgmma:
        flash_attention_bwd_dkv.launches_wgmma += 1
    else:
        flash_attention_bwd_dkv.launches_mma += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0  # every launch
flash_attention_bwd_dkv.launches_wgmma = 0  # csrc/flash_bwd_wgmma.cu (head_dim 64, 128)
flash_attention_bwd_dkv.launches_mma = 0  # csrc/flash_bwd.cu (head_dim 16, 32, 256)
flash_attention_bwd_dkv.launches_padded = 0  # at a padded head dim


class FlashAttention(torch.autograd.Function):
    """Flash attention with its hand-written backward: the counterpart of
    the JAX package's custom_vjp (q, k, v differentiable; causal and scale
    not). The forward runs the forward kernel with the LSE and saves q, k,
    v, out and LSE; the backward computes D = rowsum(dO * O) in plain
    torch and runs the dQ and dK/dV kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        out, lse = _flash_forward(q, k, v, causal, scale, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        delta = bwd_delta(out, do)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, ctx.causal, ctx.scale)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_cached_attention_plain(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, KH, Sk, D] (int8 when k_scale given)
    v: torch.Tensor,
    q_positions: torch.Tensor,  # [B, Sq]
    k_scale: Optional[torch.Tensor] = None,  # [B, KH, Sk] f32
    v_scale: Optional[torch.Tensor] = None,
    kv_length: Optional[torch.Tensor] = None,  # [B]
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, following the Pallas
    _cached_kernel (not _xla): the cache converts to q's dtype, scores are
    f32 sums of q.k products in that dtype, times `scale` (D^-0.5 when
    None) and then k_scale;
    row r attends columns 0..min(q_pos, kv_length-1); p = exp(s - m) sums
    into l, takes v_scale, and is rounded to q's dtype before the PV
    product; out = acc / l, and a row with no live column is 0."""
    b, sq, h, d = q.shape
    kh, sk = k.shape[1], k.shape[2]
    dt = q.dtype
    limit = q_positions.long()
    if kv_length is not None:
        limit = torch.minimum(limit, kv_length.long()[:, None] - 1)
    qf = q.float().reshape(b, sq, kh, h // kh, d)
    s = torch.einsum("bqkgd,bksd->bkgqs", qf, k.to(dt).float()) * (d**-0.5 if scale is None else scale)
    if k_scale is not None:
        s = s * k_scale[:, :, None, None, :]
    live = torch.arange(sk, device=q.device)[None, None, :] <= limit[:, :, None]  # [B, Sq, Sk]
    live = live[:, None, None]
    s = torch.where(live, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(live & (m > NEG_INF / 2), torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale[:, :, None, None, :]
    out = torch.einsum("bkgqs,bksd->bkgqd", p.to(dt).float(), v.to(dt).float())
    out = out / torch.where(l == 0, 1.0, l)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(dt)


def flash_cached_design(d: int) -> str:
    """The CUDA design of the cached flash kernel at head_dim d: "wgmma"
    (csrc/flash_fwd_wgmma.cu, 128 query rows a block; an int8 cache's
    tiles converted to bf16 in shared memory) at 64 and 128, "mma"
    (csrc/flash_cached.cu: mma.sync) at 16, 32 and 256, for a bf16 or an int8
    cache alike. By head_dim alone: a launch that fails raises, it is not
    retried on the other design."""
    return "wgmma" if d in (64, 128) else "mma"


def flash_cached_attention(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, KH, Sk, D] slot-cache layout (int8 when scales given)
    v: torch.Tensor,
    q_positions: torch.Tensor,  # [B, Sq] absolute positions
    k_scale: Optional[torch.Tensor] = None,  # [B, KH, Sk] f32
    v_scale: Optional[torch.Tensor] = None,
    kv_length: Optional[torch.Tensor] = None,  # [B] valid-prefix mask
) -> torch.Tensor:
    """A multi-token chunk against the slot cache: row r of batch b
    attends cache columns 0..min(q_positions[b, r], kv_length[b] - 1).
    Returns [B, Sq, H, D] in q's dtype. A cache laid out at a padded head
    dim (fused_decode.cache_layout) takes q padded to it, at q's own
    D^-0.5, and the output is sliced back. CUDA tensors launch the kernel
    (or raise); CPU tensors run the plain version."""
    d = q.shape[-1]
    if k.shape[-1] > d:
        out = _flash_cached(pad_head(q, k.shape[-1]), k, v, q_positions, k_scale, v_scale, kv_length, d**-0.5)
        if q.device.type == "cuda":
            flash_cached_attention.launches_padded += 1
        return out[..., :d]
    return _flash_cached(q, k, v, q_positions, k_scale, v_scale, kv_length, d**-0.5)


def _flash_cached(q, k, v, q_positions, k_scale, v_scale, kv_length, scale: float) -> torch.Tensor:
    """The cached flash kernel's launch at the cache's head dim (or, for
    CPU tensors, its plain version)."""
    if q.device.type == "cpu":
        return flash_cached_attention_plain(q, k, v, q_positions, k_scale, v_scale, kv_length, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_cached_attention: unsupported device {q.device}")
    b, sq, h, d = q.shape
    _, kh, sk, dk = k.shape
    quantized = k_scale is not None
    if dk != d or v.shape != k.shape or k.shape[0] != b or h % kh or q_positions.shape != (b, sq):
        raise ValueError(
            f"flash_cached_attention: unsupported shapes q{tuple(q.shape)} k{tuple(k.shape)} "
            f"positions{tuple(q_positions.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_cached_attention: head_dim {d} not built ({HEAD_DIMS}): lay the cache out at the "
                         "padded head dim (ops/fused_decode.py::cache_layout)")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"flash_cached_attention: the kernel takes bf16 queries, got {q.dtype}")
    want = torch.int8 if quantized else torch.bfloat16
    if k.dtype != want or v.dtype != want:
        raise ValueError(f"flash_cached_attention: cache must be {want}, got {k.dtype}/{v.dtype}")
    if quantized and (
        v_scale is None or k_scale.shape != (b, kh, sk) or v_scale.shape != (b, kh, sk)
        or k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32
        or not (k_scale.is_contiguous() and v_scale.is_contiguous())
    ):
        raise ValueError("flash_cached_attention: int8 caches need contiguous f32 k_scale and v_scale [B, KH, Sk]")
    tensors = (q, k, v, q_positions) + ((k_scale, v_scale) if quantized else ()) + (
        (kv_length,) if kv_length is not None else ())
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash_cached_attention: all operands must be on one device")
    # The kernel reads 16-byte rows straight from the cache: no copies of it.
    if not (k.is_contiguous() and v.is_contiguous()) or (k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError("flash_cached_attention: k/v must be contiguous and 16-byte aligned")
    q = q.contiguous()
    pos = q_positions.to(torch.int32).contiguous()
    kv_len = kv_length.to(torch.int32).contiguous() if kv_length is not None else None
    out = torch.empty_like(q)
    wgmma = flash_cached_design(d) == "wgmma"
    name = "flash_cached_wgmma" if wgmma else "flash_cached"
    rc = getattr(kernels.library(), name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        pos.data_ptr(), kv_len.data_ptr() if kv_len is not None else None, out.data_ptr(),
        b, sq, sk, h, kh, d, kernels.DTYPE_CODES[k.dtype], float(scale),
        kernels.stream_ptr(q.device),
    )
    kernels.check(rc, name)
    flash_cached_attention.launches += 1
    if wgmma:
        flash_cached_attention.launches_wgmma += 1
    else:
        flash_cached_attention.launches_mma += 1
    return out


flash_cached_attention.launches = 0  # every launch
flash_cached_attention.launches_wgmma = 0  # csrc/flash_fwd_wgmma.cu (head_dim 64, 128)
flash_cached_attention.launches_mma = 0  # csrc/flash_cached.cu (head_dim 16, 32, 256)
flash_cached_attention.launches_padded = 0  # q padded to a cache laid out at a padded head dim
