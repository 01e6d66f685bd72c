"""Variants of the flash backward's Hopper kernels (csrc/flash_bwd_wgmma.cu),
timed in turns on the card, to see what bounds them:

    python -m substratus_tpu_torch.tools.flash_bwd_probe [--all]

Each variant is the source with one change, a text substitution that must
apply, built by nvcc into its own library under build/kernels/probe/ and
called through the C entry points with the wrapper's arguments:

  built        as the repository builds it;
  light_first  the lightest block of each head (or chunk) first;
  heads_1      chunks of one head: a head's blocks together, heaviest
               first;
  heads_all    one chunk of every head: every head's heaviest block,
               then every head's next, ...;
  loads_only   the consumers free each stage without computing: TMA, the
               barriers and the epilogue (loads_only_heads_all: in the
               order of heads_all);
  no_products  every wgmma removed;
  no_exp       exp2 removed from p.

Shapes: one llama2-7b layer in training (B=8, S=1024, H=KH=32, D=128,
causal); with --all also GQA 4 (KH=8) and tinyllama's heads (H=32, KH=4,
D=64). Prints, for each shape and variant, the median over three rounds
(alternating order) of each kernel's time (a round: the median of 25
launches between CUDA events) and the largest error per output vector
against the plain version (variants that drop work disagree by design),
and writes chiprun_out/flash_bwd_probe.json. Needs the card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from substratus_tpu_torch import kernels
from substratus_tpu_torch.ops import flash_attention as fa

SOURCE = kernels.CSRC / "flash_bwd_wgmma.cu"
OUT = Path(__file__).resolve().parents[2] / "chiprun_out" / "flash_bwd_probe.json"


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"flash_bwd_probe: the source no longer holds {old!r}: update the variant")
    return text.replace(old, new)


def variants(src: str) -> dict:
    chunk_rule = "  return sms / tiles > 1 ? sms / tiles : 1;"

    def loads_only(text):
        text = _sub(text, "      if (causal && k0 >= q_lo + TILE) {", "      if (true) {")
        return _sub(text, "      const bool live = !causal || q0 + TILE > key_lo;", "      const bool live = false;")

    heads_all = _sub(src, chunk_rule, "  return 65536;")
    return {
        "built": src,
        "light_first": _sub(src, "  rank = r / heads;", "  rank = n_tiles - 1 - r / heads;"),
        "heads_1": _sub(src, chunk_rule, "  return 1;"),
        "heads_all": heads_all,
        "loads_only": loads_only(src),
        "loads_only_heads_all": loads_only(heads_all),
        "no_products": _sub(_sub(src, "wgmma_ss(", "(void)("), "wgmma_rs<1>(", "(void)("),
        "no_exp": _sub(src, "exp2f(", "("),
    }


def build(texts: dict) -> dict:
    out = kernels.build_dir() / "probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        cu = out / f"flash_bwd_{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-I", str(kernels.CSRC), "-o", str(cu.with_suffix(".so")),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"flash_bwd_probe: nvcc failed for {name}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(out / f"flash_bwd_{name}.so"))
        for fn in ("flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma"):
            getattr(lib, fn).argtypes = kernels.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def time_ms(fn, n: int = 25) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def row_err(got, ref) -> float:
    g, r = got.float(), ref.float()
    norms = r.norm(dim=-1)
    den = torch.maximum(norms, norms.square().mean().sqrt() * 2**-8)
    return ((g - r).norm(dim=-1) / den).max().item()


def probe_shape(libs: dict, b: int, s: int, h: int, kh: int, d: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, do = (torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((b, s, kh, d), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2))
    out, lse = fa.flash_attention(q, k, v, True, return_lse=True)
    delta = fa.bwd_delta(out, do)
    scale = d**-0.5
    ref = (fa._bwd_dq_plain(q, k, v, do, lse, delta, True, scale),
           *fa._bwd_dkv_plain(q, k, v, do, lse, delta, True, scale))
    stream = torch.cuda.current_stream().cuda_stream
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr())
    tail = (b, s, s, h, kh, d, kernels.DTYPE_CODES[torch.bfloat16], scale, 1, stream)
    runs, outs = {}, {}
    for name, lib in libs.items():
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        outs[name] = (dq, dk, dv)

        def call_dq(lib=lib, dq=dq):
            kernels.check(lib.flash_bwd_dq_wgmma(*ins, dq.data_ptr(), *tail), "flash_bwd_dq_wgmma")

        def call_dkv(lib=lib, dk=dk, dv=dv):
            kernels.check(lib.flash_bwd_dkv_wgmma(*ins, dk.data_ptr(), dv.data_ptr(), *tail), "flash_bwd_dkv_wgmma")

        runs[name] = {"dq": call_dq, "dkv": call_dkv}
    times = {name: {"dq": [], "dkv": []} for name in runs}
    order = list(runs)
    for rnd in range(3):
        for name in order if rnd % 2 == 0 else order[::-1]:
            for kernel, fn in runs[name].items():
                times[name][kernel].append(time_ms(fn))
    torch.cuda.synchronize()
    label = f"B={b} S={s} H={h} KH={kh} D={d} causal"
    result = {}
    for name in runs:
        errs = [row_err(g, r) for g, r in zip(outs[name], ref)]
        result[name] = {"dq_ms": statistics.median(times[name]["dq"]), "dkv_ms": statistics.median(times[name]["dkv"]),
                        "rounds": times[name], "row_err": errs}
        print(f"flash_bwd_probe [{label}] {name:12s} dq {result[name]['dq_ms']:.4f} ms, dkv "
              f"{result[name]['dkv_ms']:.4f} ms; row error dq {errs[0]:.3g} dk {errs[1]:.3g} dv {errs[2]:.3g}",
              flush=True)
    return {label: result}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m substratus_tpu_torch.tools.flash_bwd_probe")
    ap.add_argument("--all", action="store_true", help="also GQA 4 and tinyllama's heads")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_bwd_probe: needs the card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"flash_bwd_probe: {card}", flush=True)
    libs = build(variants(SOURCE.read_text()))
    shapes = [(8, 1024, 32, 32, 128)] + ([(8, 1024, 32, 8, 128), (8, 1024, 32, 4, 64)] if args.all else [])
    report = {"card": card}
    for shape in shapes:
        report.update(probe_shape(libs, *shape))
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
