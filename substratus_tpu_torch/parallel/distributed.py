"""Multi-process bootstrap (port of substratus_tpu/parallel/distributed.py).

The operator injects a gang's environment into each pod (TPU_WORKER_ID,
JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES); the JAX package turns it into
``jax.distributed.initialize``, the port into
``torch.distributed.init_process_group`` with a TCP rendezvous at the
coordinator's address. The design is one process per card: rank r runs on
``cuda:(r % torch.cuda.device_count())``, so two ranks on a one-card host
share the card.

Three process groups come out of ``maybe_initialize``:

  * the default group, gloo: only the rendezvous's own exchange (which
    rank holds which card on which host);
  * the control group, gloo whatever the data backend is: the serving
    scheduler's per-iteration event broadcast (serve/multihost.py), a small
    CPU tensor;
  * the data backend, named by ``Gang.backend`` and used by the mesh's
    axis groups (parallel/mesh.py): the model's collectives.

The data backend is chosen by an explicit rule, printed on the startup
line, never by trying one and falling back: gloo on the CPU, or where two
ranks share a card (NCCL refuses two ranks on one device); NCCL where
every rank has a card of its own. Gloo takes CUDA tensors for all_reduce
and broadcast, staging them through the host.

Call ``maybe_initialize()`` first in an entry point; it is a no-op for a
single process, so the same containers work everywhere.
"""
from __future__ import annotations

import datetime
import os
import socket
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300


@dataclass(frozen=True)
class Gang:
    """This process's place in the gang, and its groups."""

    rank: int
    world: int
    device: torch.device
    backend: str  # the data backend: "gloo" or "nccl"
    control: object  # the gloo ProcessGroup of the event broadcast
    timeout_s: int  # every collective's timeout, given at init_process_group

    @property
    def leader(self) -> bool:
        return self.rank == 0


_gang: Optional[Gang] = None


def world_info() -> tuple[Optional[str], int, int]:
    """(coordinator_address, num_processes, process_id) from the operator's
    environment, with the JAX package's defaults: a TPU_WORKER_ID that does
    not parse is 0."""
    coord = os.environ.get("JAX_COORDINATOR_ADDRESS")
    n = int(os.environ.get("JAX_NUM_PROCESSES", "1") or 1)
    pid_raw = os.environ.get("TPU_WORKER_ID", "0") or "0"
    try:
        pid = int(pid_raw)
    except ValueError:
        pid = 0
    return coord, n, pid


def rank_device(rank: int, device_type: str) -> torch.device:
    """Rank r's device: the CPU when asked, else cuda:(r % cards)."""
    if device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' (--device cpu) to run on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def data_backend(device: torch.device, placements: list) -> str:
    """The rule: gloo on the CPU or where two ranks share a (host, card);
    NCCL where each rank has a card of its own. `placements` is every
    rank's (host, device) pair."""
    if device.type == "cpu" or len(set(placements)) < len(placements):
        return "gloo"
    return "nccl"


def maybe_initialize(timeout_seconds: int = DEFAULT_TIMEOUT_S, device_type: str = "cuda") -> bool:
    """Join the gang the operator's environment names; a no-op (False) for
    one process. Idempotent. `device_type` "cpu" makes a CPU gang."""
    global _gang
    if _gang is not None:
        return True
    coord, n, pid = world_info()
    if n <= 1 or coord is None:
        return False
    device = rank_device(pid, device_type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    timeout = datetime.timedelta(seconds=timeout_seconds)
    dist.init_process_group("gloo", init_method=f"tcp://{coord}", world_size=n, rank=pid, timeout=timeout)
    placements = [None] * n
    dist.all_gather_object(placements, (socket.gethostname(), str(device)))
    control = dist.new_group(backend="gloo", timeout=timeout)
    _gang = Gang(rank=pid, world=n, device=device, backend=data_backend(device, placements), control=control,
                 timeout_s=timeout_seconds)
    return True


def current() -> Optional[Gang]:
    """The gang this process joined, or None."""
    return _gang


def shutdown() -> None:
    """Leave the gang (tests and tools that join more than once)."""
    global _gang
    if _gang is not None and dist.is_initialized():
        dist.destroy_process_group()
    _gang = None
