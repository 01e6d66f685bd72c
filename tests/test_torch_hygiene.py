"""Import and device hygiene of the PyTorch port (substratus_tpu_torch/):

* no module of the port, nor chip_smoke.py, imports jax or the JAX
  package (substratus_tpu), even one that does not import jax;
* every module imports without CUDA, nvcc or triton;
* the entry points run on cuda unless asked for the CPU, and raise here
  rather than drift to the CPU.
"""
import ast
import importlib
import pkgutil
from pathlib import Path

import pytest
import torch

import substratus_tpu_torch
from substratus_tpu_torch.models import llama
from substratus_tpu_torch.serve import main
from substratus_tpu_torch.serve.engine import Engine
from substratus_tpu_torch.train import main as train_main
from substratus_tpu_torch.train.trainer import TrainConfig, Trainer
from substratus_tpu_torch.utils import device

REPO = Path(__file__).resolve().parents[1]
SOURCES = sorted((REPO / "substratus_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_and_no_jax_package():
    assert len(SOURCES) > 10
    bad = [f"{path.relative_to(REPO)}: imports {name}" for path in SOURCES for name in _imports(path)
           if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "substratus_tpu")]
    assert not bad


def test_every_module_imports_without_cuda():
    names = [m.name for m in pkgutil.walk_packages(substratus_tpu_torch.__path__, "substratus_tpu_torch.")]
    assert "substratus_tpu_torch.serve.server" in names and "substratus_tpu_torch.kernels" in names
    for name in names:
        importlib.import_module(name)
    from substratus_tpu_torch import kernels

    assert kernels._lib is None  # nothing was built at import


def test_entry_points_default_to_cuda_and_raise_without_it():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA"):
        device.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        llama.init_params(llama.CONFIGS["tiny"])
    params = llama.init_params(llama.CONFIGS["tiny"], device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(llama.CONFIGS["tiny"], params)
    with pytest.raises(RuntimeError, match="CUDA"):
        main.build(["--config", "tiny", "--params", "", "--port", "0"])
    assert main.parse_args([]).device is None
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(llama.CONFIGS["tiny"], TrainConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        train_main.run(["--params", "", "--data", str(REPO / "examples"), "--out", "unused"])
    assert train_main.parse_args([]).device is None


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert device.resolve_device(None) == torch.device("cuda", 0)
    assert device.resolve_device("cuda:1") == torch.device("cuda", 1)
    assert device.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        device.resolve_device("mps")


def test_cpu_kernel_wrappers_use_plain_version_only_for_cpu_tensors():
    """A tensor on another device than the CPU never reaches the plain
    version: without a card the wrappers raise instead of computing."""
    from substratus_tpu_torch.ops.decode_attention import decode_attention
    from substratus_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_cached_attention)
    from substratus_tpu_torch.ops.fused_decode import fused_decode_attention

    q = torch.zeros((1, 4, 2, 64), device="meta")
    kv = q.transpose(1, 2)
    with pytest.raises((ValueError, RuntimeError)):
        flash_attention(q, q, q)
    with pytest.raises((ValueError, RuntimeError)):
        decode_attention(q[:, :1], kv, kv, torch.zeros(1, dtype=torch.int32))
    with pytest.raises((ValueError, RuntimeError)):
        flash_cached_attention(q, kv, kv, torch.zeros((1, 4), dtype=torch.int32))
    with pytest.raises((ValueError, RuntimeError)):
        fused_decode_attention(q[:, :1], kv[:, :, :1], kv[:, :, :1], kv, kv, torch.zeros(1, dtype=torch.int32))
    stats = torch.zeros((8, 4), device="meta")
    with pytest.raises((ValueError, RuntimeError)):
        flash_attention_bwd_dq(q, q, q, q, stats, stats)
    with pytest.raises((ValueError, RuntimeError)):
        flash_attention_bwd_dkv(q, q, q, q, stats, stats)
    assert (flash_cached_attention.launches, fused_decode_attention.launches) == (0, 0)
    assert (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches) == (0, 0)
