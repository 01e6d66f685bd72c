"""Variants of the flash kernels' Hopper designs, timed in turns on the card,
to see what bounds them:

    python -m substratus_tpu_torch.tools.flash_bwd_probe [--all]   # the backward
    python -m substratus_tpu_torch.tools.flash_bwd_probe --forward  # the forward, the cached flash

Each variant is the sources with one change, a text substitution that must
apply (in the kernel's source or in csrc/hopper.cuh, which holds the block
order), built by nvcc into its own library under build/kernels/probe/ and
called through the C entry points with the wrapper's arguments.

The backward (csrc/flash_bwd_wgmma.cu):

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
D=64).

The forward (--forward; csrc/flash_fwd_wgmma.cu, both of its kernels):
built, light_first, loads_only (the consumers wait for each stage and
free it), no_products (every wgmma removed, the scores zero), no_exp
(exp2 removed from p), no_store (the output not written), stages_2 (a
ring of two stages), kt_64 (K/V tiles of 64 keys; kt_64_stages_6 with a
ring of six), block_64 (64-row blocks: one consumer warpgroup), and
head_major (the built kernel on [B, H, S, D] copies of q, k, v, as B*H
batches of one head: SDPA's layout); beside them SDPA on those copies and
on strided views of q, k, v (each with a copy of its output).
Shapes: the llama2-7b prefill (B=1, S=512) and training layer (B=8,
S=1024), causal, and the cached flash's fifth 512-token chunk of a
4096-row cache.

Prints, for each shape and variant, the median over three rounds
(alternating order) of each kernel's time (a round: the median of 25
launches between CUDA events, the card held 0.3 ms before each so that
the host's time is not counted) and the largest error per output vector
against the plain version (variants that drop work disagree by design),
and writes chiprun_out/flash_bwd_probe.json. Needs the card and nvcc.
With --forward the file is flash_fwd_probe.json beside it.
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

OUT = Path(__file__).resolve().parents[2] / "chiprun_out" / "flash_bwd_probe.json"
HEADER = "hopper.cuh"


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"flash_bwd_probe: the source no longer holds {old!r}: update the variant")
    return text.replace(old, new)


def _sources(kernel: str) -> dict:
    return {name: (kernels.CSRC / name).read_text() for name in (kernel, HEADER)}


def _orders(src: dict, kernel: str) -> dict:
    """The block orders of hopper.cuh's block_work and head_chunk."""
    h = src[HEADER]
    chunk_rule = "  return sms / tiles > 1 ? sms / tiles : 1;"
    return {
        "light_first": {**src, HEADER: _sub(h, "  rank = r / heads;", "  rank = n_tiles - 1 - r / heads;")},
        "heads_1": {**src, HEADER: _sub(h, chunk_rule, "  return 1;")},
        "heads_all": {**src, HEADER: _sub(h, chunk_rule, "  return 65536;")},
    }


def bwd_variants() -> dict:
    kernel = "flash_bwd_wgmma.cu"
    src = _sources(kernel)
    k = src[kernel]

    def loads_only(text):
        text = _sub(text, "      if (causal && k0 >= q_lo + TILE) {", "      if (true) {")
        return _sub(text, "      const bool live = !causal || q0 + TILE > key_lo;", "      const bool live = false;")

    orders = _orders(src, kernel)
    return {
        "built": src,
        **orders,
        "loads_only": {**src, kernel: loads_only(k)},
        "loads_only_heads_all": {**orders["heads_all"], kernel: loads_only(k)},
        "no_products": {**src, kernel: _sub(_sub(k, "wgmma_ss(", "(void)("), "wgmma_rs<1>(", "(void)(")},
        "no_exp": {**src, kernel: _sub(k, "exp2f(", "(")},
    }


def fwd_variants() -> dict:
    kernel = "flash_fwd_wgmma.cu"
    src = _sources(kernel)
    k = src[kernel]
    loads_only = _sub(k, "      if (n_tiles > 0) {\n        float alpha[2];", (
        "      if (n_tiles > 0) {\n        mbar_wait(q_full, 0);\n"
        "        for (int t = 0; t < n_tiles; ++t) mbar_wait(full + 8 * (t % ST), (t / ST) & 1), release(t % ST);\n"
        "      }\n      if (false) {\n        float alpha[2];"))
    no_products = _sub(_sub(k, "wgmma_ss(", "(void)("), "wgmma_rs<1>(", "(void)(")
    no_products = _sub(no_products, "float o_acc[D / 2], sacc[T / 2];", "float o_acc[D / 2], sacc[T / 2] = {};")
    store = "      store_acc<D>(o + ((size_t)b * Sq * H + h) * D"
    kt_64 = _sub(k, "constexpr int KT = 128;", "constexpr int KT = 64;")
    stages = "static constexpr int STAGES = D == 128 ? 3 : 4;"
    orders = _orders(src, kernel)
    return {
        "built": src,
        "light_first": orders["light_first"],
        "loads_only": {**src, kernel: loads_only},
        "no_products": {**src, kernel: no_products},
        "no_exp": {**src, kernel: _sub(k, "exp2f(fmaf(", "(fmaf(")},
        "no_store": {**src, kernel: _sub(k, store, "      if (o_acc[0] == 12345.f) " + store.lstrip())},
        "stages_2": {**src, kernel: _sub(k, stages, "static constexpr int STAGES = 2;")},
        "kt_64": {**src, kernel: kt_64},
        "kt_64_stages_6": {**src, kernel: _sub(kt_64, stages, "static constexpr int STAGES = D == 128 ? 6 : 8;")},
        "block_64": {**src, kernel: _sub(k, "constexpr int NC = 2;", "constexpr int NC = 1;")},
    }


def build(variants: dict, kernel: str, entries) -> dict:
    out = kernels.build_dir() / "probe"
    procs = {}
    for name, files in variants.items():
        d = out / f"{Path(kernel).stem}_{name}"
        d.mkdir(parents=True, exist_ok=True)
        for fname, text in files.items():
            (d / fname).write_text(text)
        # The variant's own hopper.cuh first: a quoted include searches the
        # including file's directory before -I.
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-I", str(kernels.CSRC), "-o", str(d / "probe.so"),
             str(d / kernel)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"flash_bwd_probe: nvcc failed for {name}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(out / f"{Path(kernel).stem}_{name}" / "probe.so"))
        for fn in entries:
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
        torch.cuda._sleep(500_000)  # hold the card until the host has enqueued the launch
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


def in_rounds(label: str, runs: dict, outs: dict, ref) -> dict:
    """runs: {variant: {kernel: call}}; three rounds in alternating order."""
    times = {name: {kernel: [] for kernel in calls} for name, calls in runs.items()}
    order = list(runs)
    for rnd in range(3):
        for name in order if rnd % 2 == 0 else order[::-1]:
            for kernel, fn in runs[name].items():
                times[name][kernel].append(time_ms(fn))
    torch.cuda.synchronize()
    result = {}
    for name in runs:
        errs = [row_err(g, r) for g, r in zip(outs[name], ref)]
        result[name] = {**{f"{kernel}_ms": statistics.median(ts) for kernel, ts in times[name].items()},
                        "rounds": times[name], "row_err": errs}
        print(f"flash_bwd_probe [{label}] {name:20s} "
              + ", ".join(f"{kernel} {result[name][f'{kernel}_ms']:.4f} ms" for kernel in times[name])
              + "; row error " + " ".join(f"{e:.3g}" for e in errs), flush=True)
    return {label: result}


def probe_bwd(libs: dict, b: int, s: int, h: int, kh: int, d: int) -> dict:
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
    return in_rounds(f"B={b} S={s} H={h} KH={kh} D={d} causal", runs, outs, ref)


def probe_fwd(libs: dict, b: int, s: int, h: int, kh: int, d: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((b, s, kh, d), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2))
    ref = (fa.flash_attention_plain(q, k, v, True),)
    stream = torch.cuda.current_stream().cuda_stream
    runs, outs = {}, {}
    for name, lib in libs.items():
        o = torch.empty_like(q)
        outs[name] = (o,)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None, b, s, s, h, kh, d,
                kernels.DTYPE_CODES[torch.bfloat16], d**-0.5, 1, stream)
        runs[name] = {"fwd": lambda lib=lib, args=args: kernels.check(lib.flash_fwd_wgmma(*args), "flash_fwd_wgmma")}
    if kh == h:  # the built kernel on head-major copies ([B, H, S, D]: B*H batches of one head), SDPA's layout
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        o = torch.empty_like(qt)
        outs["head_major"] = (o.transpose(1, 2),)
        args = (qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), o.data_ptr(), None, b * h, s, s, 1, 1, d,
                kernels.DTYPE_CODES[torch.bfloat16], d**-0.5, 1, stream)
        runs["head_major"] = {"fwd": lambda args=args: kernels.check(libs["built"].flash_fwd_wgmma(*args),
                                                                     "flash_fwd_wgmma")}
        # The yardstick on both layouts: SDPA on the head-major copies (as
        # chip_smoke.py times it) and on strided views of q, k, v.
        for name, xs in (("sdpa_head_major", (qt, kt, vt)), ("sdpa_strided", tuple(x.transpose(1, 2) for x in (q, k, v)))):
            out = torch.empty_like(qt)
            outs[name] = (out.transpose(1, 2),)

            def sdpa(xs=xs, out=out):
                out.copy_(torch.nn.functional.scaled_dot_product_attention(*xs, is_causal=True))

            runs[name] = {"fwd": sdpa}
    return in_rounds(f"forward B={b} S={s} H={h} KH={kh} D={d} causal", runs, outs, ref)


def probe_cached(libs: dict, sq: int = 512, sk: int = 4096, start: int = 2048, h: int = 32, d: int = 128) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((1, sq, h, d), generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((1, h, sk, d), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2))
    pos = (start + torch.arange(sq, device="cuda")).to(torch.int32)[None]
    ref = (fa.flash_cached_attention_plain(q, k, v, pos),)
    stream = torch.cuda.current_stream().cuda_stream
    runs, outs = {}, {}
    for name, lib in libs.items():
        o = torch.empty_like(q)
        outs[name] = (o,)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None, pos.data_ptr(), None, o.data_ptr(), 1, sq, sk,
                h, h, d, kernels.DTYPE_CODES[torch.bfloat16], d**-0.5, stream)
        runs[name] = {"cached": lambda lib=lib, args=args: kernels.check(lib.flash_cached_wgmma(*args),
                                                                         "flash_cached_wgmma")}
    return in_rounds(f"cached Sq={sq} Sk={sk} H=KH={h} D={d} pos {start}..{start + sq - 1}", runs, outs, ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m substratus_tpu_torch.tools.flash_bwd_probe")
    ap.add_argument("--all", action="store_true", help="backward: also GQA 4 and tinyllama's heads")
    ap.add_argument("--forward", action="store_true", help="the forward and the cached flash instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_bwd_probe: needs the card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"flash_bwd_probe: {card}", flush=True)
    report = {"card": card}
    if args.forward:
        libs = build(fwd_variants(), "flash_fwd_wgmma.cu", ("flash_fwd_wgmma", "flash_cached_wgmma"))
        for shape in ((1, 512, 32, 32, 128), (8, 1024, 32, 32, 128)):
            report.update(probe_fwd(libs, *shape))
        report.update(probe_cached(libs))
        out = OUT.with_name("flash_fwd_probe.json")
    else:
        libs = build(bwd_variants(), "flash_bwd_wgmma.cu", ("flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma"))
        shapes = [(8, 1024, 32, 32, 128)] + ([(8, 1024, 32, 8, 128), (8, 1024, 32, 4, 64)] if args.all else [])
        for shape in shapes:
            report.update(probe_bwd(libs, *shape))
        out = OUT
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
