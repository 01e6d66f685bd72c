"""The head dims the attention kernels are built for, and the padded route
that serves the others up to the largest.

Every attention kernel of the port is compiled for head_dim 16, 32, 64,
128 and 256: the wgmma designs (csrc/flash_fwd_wgmma.cu, flash_bwd_wgmma.cu)
and the split decode (decode_split.cu) at 64 and 128, the mma.sync designs
(flash_fwd.cu, flash_cached.cu, flash_bwd.cu) and the rows decode
(decode_attn.cu, fused_decode.cu) at 16, 32 and 256, the split decode at
256 too for the query groups the rows design does not take. A checkpoint
may have another: facebook/opt-2.7b has 80 (hidden 2560, 32 heads). The
JAX reference attends such a model through XLA, which takes any head dim.
The port pads D up to the next built size instead: zero columns of q and k
add nothing to a score, the extra columns of v come out as extra columns
of the output and are sliced off, and the softmax scale stays the true
D^-0.5 (each C entry point takes the scale as an argument). So 80 and 96
run at 128, 192 at 256, 48 at 64, 20 at 32. The dense cache is allocated
at the padded D where a kernel reads it (fused_decode.cache_layout), so no
step copies it. A head dim above 256 has no route (no model the repository
names has one): the engine's dense layout and the trainer's flash
attention refuse it when they are built (check_head_dim).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

HEAD_DIMS = (16, 32, 64, 128, 256)  # built by every attention kernel family
MAX_HEAD_DIM = HEAD_DIMS[-1]


def padded_head_dim(d: int) -> Optional[int]:
    """The built head dim that serves d: d itself when built, else the next
    larger one; None above MAX_HEAD_DIM (no kernel takes it)."""
    return next((x for x in HEAD_DIMS if x >= d), None)


def pad_head(t: torch.Tensor, dp: int) -> torch.Tensor:
    """t [..., D] with zero columns appended up to dp (t itself when D is
    at least dp)."""
    return t if t.shape[-1] >= dp else F.pad(t, (0, dp - t.shape[-1]))


def head_dim_route(d: int) -> str:
    """The route of head_dim d as the entry points' startup lines name it."""
    dp = padded_head_dim(d)
    if dp is None:
        return f"head_dim {d} (above {MAX_HEAD_DIM}: no kernel)"
    return f"head_dim {d}" if dp == d else f"head_dim {d} padded to {dp}"


def check_head_dim(d: int, what: str) -> None:
    """Refuse a head dim no attention kernel takes, naming the limit."""
    if padded_head_dim(d) is None:
        raise ValueError(
            f"{what}: head_dim {d} is above {MAX_HEAD_DIM}, the largest the attention kernels take (built at "
            f"{HEAD_DIMS}, a smaller head dim padded up to the next); ROADMAP Queue 3")
