"""Flash-attention forward: the CUDA kernel csrc/flash_fwd.cu beside its
plain PyTorch version.

Replaces substratus_tpu/ops/flash_attention.py::_flash_kernel (entry
point flash_attention), the prefill attention of the serving path. Both of its
products run on the tensor cores (mma.sync, bf16 in, f32 accumulate); at
the llama2-7b prefill shape its bound on an H100 is the bytes of
q/k/v/o. See the source note in csrc/flash_fwd.cu.

``flash_attention`` launches the kernel for CUDA tensors (or raises) and
runs the plain version only for tensors on the CPU. ``flash_attention.launches``
counts kernel launches.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from substratus_tpu_torch import kernels

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)


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


def flash_attention(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, KH, D]
    v: torch.Tensor,  # [B, Sk, KH, D]
    causal: bool = True,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Self-attention (no cache) over [B, S, H|KH, D]; returns the output
    in q's dtype, and with return_lse the f32 row logsumexp [B*H, Sq]."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, scale, return_lse)
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(
            f"flash_attention: the kernel takes bf16 q/k/v, got {q.dtype}/{k.dtype}/{v.dtype} "
            "(attn_impl='plain' serves other dtypes)"
        )
    if d not in HEAD_DIMS or k.shape[-1] != d or v.shape != k.shape or k.shape[0] != b:
        raise ValueError(f"flash_attention: unsupported shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    if h % kh:
        raise ValueError(f"flash_attention: {h} query heads not a multiple of {kh} kv heads")
    if not (k.device == v.device == q.device):
        raise ValueError("flash_attention: q, k, v must be on one device")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError("flash_attention: q/k/v must be 16-byte aligned (the kernel loads 16-byte rows)")
    out = torch.empty_like(q)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device) if return_lse else None
    rc = kernels.library().flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        b, sq, sk, h, kh, d, kernels.DTYPE_CODES[q.dtype], float(scale), int(causal),
        kernels.stream_ptr(q.device),
    )
    kernels.check(rc, "flash_fwd")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
