"""Import and device hygiene of the PyTorch port (substratus_tpu_torch/):

* no module of the port, nor chip_smoke.py, imports jax or the JAX
  package (substratus_tpu), even one that does not import jax (the
  serving surface's observability/ and gateway/ subpackages are the
  port's own copies), nor aiohttp (the server is the standard library's),
  nor transformers or safetensors at module level (the card's machine has
  none of them);
* every module imports without CUDA, nvcc or triton, and every module
  imports with transformers and safetensors unimportable;
* the entry points run on cuda unless asked for the CPU, and raise here
  rather than drift to the CPU; so do the checkpoint loaders.
"""
import ast
import importlib
import pkgutil
import subprocess
import sys
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


def _module_level_imports(path: Path):
    """The imports a module runs when it is imported: not those inside a
    function's body."""
    todo = list(ast.parse(path.read_text(), str(path)).body)
    while todo:
        node = todo.pop()
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            todo.extend(ast.iter_child_nodes(node))


def test_no_jax_and_no_jax_package():
    assert len(SOURCES) > 10
    scanned = {str(path.relative_to(REPO)) for path in SOURCES}
    for sub in ("observability/metrics.py", "observability/sketch.py", "observability/httpstats.py",
                "gateway/loadreport.py", "gateway/limiter.py", "rl/buffer.py", "rl/learner.py", "rl/loop.py"):
        assert f"substratus_tpu_torch/{sub}" in scanned
    bad = [f"{path.relative_to(REPO)}: imports {name}" for path in SOURCES for name in _imports(path)
           if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "substratus_tpu", "aiohttp")]
    assert not bad
    bad = [f"{path.relative_to(REPO)}: imports {name} at module level" for path in SOURCES
           for name in _module_level_imports(path) if name.split(".")[0] in ("transformers", "safetensors")]
    assert not bad
    hf_tokenizer = REPO / "substratus_tpu_torch" / "serve" / "tokenizer.py"
    assert "transformers" in _imports(hf_tokenizer) and "transformers" not in _module_level_imports(hf_tokenizer)


def test_every_module_imports_without_cuda():
    names = [m.name for m in pkgutil.walk_packages(substratus_tpu_torch.__path__, "substratus_tpu_torch.")]
    assert "substratus_tpu_torch.serve.server" in names and "substratus_tpu_torch.kernels" in names
    assert {"substratus_tpu_torch.observability.metrics", "substratus_tpu_torch.observability.sketch",
            "substratus_tpu_torch.observability.httpstats", "substratus_tpu_torch.gateway.loadreport",
            "substratus_tpu_torch.gateway.limiter", "substratus_tpu_torch.rl.buffer", "substratus_tpu_torch.rl.learner",
            "substratus_tpu_torch.rl.loop"} <= set(names)
    for name in names:
        importlib.import_module(name)
    from substratus_tpu_torch import kernels

    assert kernels._lib is None  # nothing was built at import


def test_modules_import_without_transformers_and_safetensors():
    """In a fresh interpreter, as on the card's machine: every module of
    the port imports with both packages unimportable."""
    code = ("import sys, importlib, pkgutil\n"
            "sys.modules['transformers'] = sys.modules['safetensors'] = None\n"
            "import substratus_tpu_torch\n"
            "names = [m.name for m in pkgutil.walk_packages(substratus_tpu_torch.__path__, 'substratus_tpu_torch.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "assert 'substratus_tpu_torch.load.hf' in names and 'substratus_tpu_torch.load.gguf' in names\n"
            "assert sys.modules['transformers'] is None and 'jax' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


def test_checkpoint_loaders_default_to_cuda_and_raise_without_it(tmp_path):
    from substratus_tpu_torch.load.gguf import load_gguf
    from substratus_tpu_torch.load.hf import load_pretrained
    from substratus_tpu_torch.tools import ckpt_writer
    from substratus_tpu_torch.train.checkpoints import save_artifact

    model = llama.init_params(llama.CONFIGS["tiny"], device="cpu")
    ckpt_writer.write_hf(str(tmp_path / "hf"), model)
    ckpt_writer.write_gguf(str(tmp_path / "m.gguf"), model)
    save_artifact(str(tmp_path / "art"), model, model.cfg)
    for load in (lambda: load_gguf(str(tmp_path / "m.gguf")), lambda: load_pretrained(str(tmp_path / "hf")),
                 lambda: main.load_checkpoint(str(tmp_path / "m.gguf")),
                 lambda: main.load_checkpoint(str(tmp_path / "hf")),
                 lambda: main.load_checkpoint(str(tmp_path / "art"))):
        with pytest.raises(RuntimeError, match="CUDA"):
            load()
    with pytest.raises(RuntimeError, match="CUDA"):
        main.build(["--model", str(tmp_path / "hf"), "--params", "", "--port", "0"])
    _, cpu = main.load_checkpoint(str(tmp_path / "hf"), "cpu")
    assert cpu.device == torch.device("cpu")


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
    from substratus_tpu_torch.ops.quant import w8a8_matmul, w8a8_quantize

    with pytest.raises((ValueError, RuntimeError)):
        w8a8_quantize(q.to(torch.bfloat16))
    xq = torch.zeros((2, 64), dtype=torch.int8, device="meta")
    with pytest.raises((ValueError, RuntimeError)):
        w8a8_matmul(xq, torch.ones(2, device="meta"), xq.t().contiguous(), torch.ones(2, device="meta"),
                    torch.empty((2, 2), dtype=torch.bfloat16, device="meta"))
    assert (w8a8_quantize.launches, w8a8_matmul.launches) == (0, 0)
    assert (flash_cached_attention.launches, fused_decode_attention.launches) == (0, 0)
    assert (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches) == (0, 0)
