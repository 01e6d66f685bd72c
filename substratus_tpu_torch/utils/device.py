"""Device resolution for the port's entry points.

The card is the default. The CPU is used only when the caller names it
(``device="cpu"`` / ``--device cpu``); with no card and no such request
the entry point raises instead of drifting to the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on, with its index filled in (a
    tensor's ``.device`` is ``cuda:0``, never bare ``cuda``, so the two
    compare equal)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (expected cuda or cpu)")
    if dev.type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device cpu) to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device() if dev.index is None else dev.index)


def seeded_generator(seed: int, device: Optional[torch.device]) -> torch.Generator:
    """A torch.Generator on `device`, seeded: every random draw in the
    port goes through an explicit generator, never the global one."""
    gen = torch.Generator(device=device or "cpu")
    gen.manual_seed(seed)
    return gen
