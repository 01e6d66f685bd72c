"""Build and load the port's hand-written CUDA kernels.

Every source under ``substratus_tpu_torch/csrc/`` is compiled by ``nvcc``
for ``sm_90a`` (one ``nvcc -c`` per source, all started together), then
linked into one shared library with a plain C interface that ``ctypes``
loads. Nothing includes PyTorch's headers, so a build takes seconds.

The build runs at the first call of ``library()`` -- never at import --
into ``build/kernels/`` at the repository root (listed in .gitignore, or
``SUBSTRATUS_KERNEL_BUILD_DIR``). The library's name carries a hash of
the sources, so an edited source rebuilds and an unchanged one loads.

Each C entry point launches on the stream it is given (PyTorch's
current stream), allocates nothing, and returns ``cudaGetLastError()``;
``check`` raises when that is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
NVCC_FLAGS = ["-std=c++17", "-O3", ARCH, "-Xcompiler", "-fPIC", "-lineinfo"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of csrc/*.cu's extern "C" entry points.
SIGNATURES = {
    # q, k, v, o, lse, B, Sq, Sk, H, KH, D, dtype, scale, causal, stream
    "flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    # the same at head_dim 64 and 128 (csrc/flash_fwd_wgmma.cu)
    "flash_fwd_wgmma": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    # q, k, v, k_scale, v_scale, pos, o, B, H, KH, S, D, cache_dtype, scale, stream
    "decode_attn": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    # q, k, v, k_scale, v_scale, pos, o, ws, B, H, KH, S, D, cache_dtype, scale, rows, n_split, stream
    # (csrc/decode_split.cu)
    "decode_split": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    # q, k, v, k_scale, v_scale, pos, kv_len, o, B, Sq, Sk, H, KH, D, cache_dtype, scale, stream
    "flash_cached": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    # the same at head_dim 64 and 128 (csrc/flash_fwd_wgmma.cu)
    "flash_cached_wgmma": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    # q, new_k, new_v, new_ks, new_vs, k, v, k_scale, v_scale, pos, o,
    # B, H, KH, S, D, cache_dtype, scale, stream
    "fused_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    # q, new_k, new_v, new_ks, new_vs, k, v, k_scale, v_scale, pos, o, ws,
    # B, H, KH, S, D, cache_dtype, scale, rows, n_split, stream (csrc/decode_split.cu)
    "fused_decode_split": [_P] * 12 + [_I, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    # x, packed, scale, out, ws, M, N, C, block, splits, stream
    "q4_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, packed, scale, out, M, N, C, block, stream (the prefill design)
    "q4_matmul_wgmma": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, packed, scale, out, M, N, C, block, bn, splits, stream (the decode
    # design, csrc/q4_matmul_decode.cu; bn and splits from q4_decode_plan)
    "q4_matmul_decode": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # M, splits, shared memory of a block -> clusters the card runs at once
    "q4_matmul_decode_clusters": [_I, _I, _I],
    # M, N, C, block, sms -> split-K factor of q4_matmul
    "q4_matmul_splits": [_I, _I, _I, _I, _I],
    # q, k, v, do, lse, delta, dq, B, Sq, Sk, H, KH, D, dtype, scale, causal, stream
    "flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    # q, k, v, do, lse, delta, dk, dv, B, Sq, Sk, H, KH, D, dtype, scale, causal, stream
    "flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    # the same two at head_dim 64 and 128 (csrc/flash_bwd_wgmma.cu)
    "flash_bwd_dq_wgmma": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    "flash_bwd_dkv_wgmma": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    # x, ldx, xq, amax, ascale, M, C, mode, stream (csrc/w8a8_quantize.cu;
    # mode 0 the whole quantization, 1 the rows' amax, 2 the values from a
    # given amax: a row-parallel product's halves)
    "w8a8_quantize": [_P, _I, _P, _P, _P, _I, _I, _I, _P],
    # xq, lda, ascale, as_stride, w, wscale, out, ldo, raw, M, N, C, stream (csrc/w8a8_matmul.cu)
    "w8a8_matmul": [_P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}
# dtype codes shared with csrc/*.cu
DTYPE_CODES = {torch.bfloat16: 0, torch.int8: 1}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build


def build_dir() -> Path:
    default = Path(__file__).resolve().parents[2] / "build" / "kernels"
    return Path(os.environ.get("SUBSTRATUS_KERNEL_BUILD_DIR", default))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu"))


def build() -> Path:
    """Compile csrc/*.cu into the shared library (reused when the
    sources are unchanged) and return its path."""
    global build_seconds
    sources = _sources()
    digest = hashlib.sha256()
    for src in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode() + src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out_dir = build_dir()
    lib_path = out_dir / f"libsubstratus_kernels_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sources:
        obj = out_dir / f"{src.stem}.{os.getpid()}.o"
        objs.append(obj)
        procs.append(
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
        )
    failures = []
    for src, proc in zip(sources, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{src.name}:\n{out}")
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or nothing
    for obj in objs:
        obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, name: str) -> None:
    """Raise when a launch returned a CUDA error (refused launch, bad
    configuration) or the wrapper's C side rejected its arguments."""
    if rc == 0:
        return
    if rc < 0:
        raise RuntimeError(f"{name}: unsupported arguments (code {rc})")
    raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
