"""Variants and plans of the int4 matmul's decode design
(csrc/q4_matmul_decode.cu), timed in turns on the card, to see what bounds
it, and the host time of a call of the model's int4 projection:

    python -m substratus_tpu_torch.tools.q4_decode_probe
    python substratus_tpu_torch/tools/q4_decode_probe.py --host   # any checkout's package

Each source variant is the source with one change, a text substitution that
must apply, built by nvcc into its own library under build/kernels/probe/
(tools/flash_bwd_probe.py's build) and called through the C entry point:

  built       as the repository builds it;
  loads_only  the consumers wait for each stage and free it without
              computing: TMA, the barriers, the epilogue and the sum;
  no_dequant  the packed bytes go to the products as they are, without the
              dequantization;
  no_cvt      the dequantized pairs packed by a byte permute (dropping the
              low bits) in place of the rounding conversion;
  no_sum      the splits' partials are neither sent to rank 0 nor summed
              (nothing stored when the groups are split);
  empty       no groups: no loads, no products, zeros sent, summed and
              stored (the launch's floor at that grid);
  ring_4      a ring of four stages in place of eight;
  one_block   120 KB more shared memory a block, so that one block, not
              two, runs on an SM (plans whose memory would not fit are
              left out);
  compute_only the producer arrives on each stage without loading it: the
              consumers' work alone, on stale shared memory.

Each variant runs at q4_decode_plan's plan (with the card's cluster
capacity); the built library also at other plans (bn, splits), the plan
of an ideal capacity (sms / splits clusters) among them, and once without
the L2 flush. Beside them
q4_matmul.cu's kernel (the mma design, with its workspace and second
launch), torch.matmul on the dequantized bf16 weight, and a memset of the
output (one small launch). Every launch is timed with the 50 MB L2 flushed
by a 256 MB read and the card held 0.3 ms until the host has enqueued it:
the median of 25 launches between CUDA events, three rounds in
alternating order. Also each plan's clusters against what the card holds
at once (cudaOccupancyMaxActiveClusters).

Shapes: llama2-7b at M = 8 (w_gate/w_up, w_down, lm_head, wq/wk/wv/wo),
w_gate at M = 1 and 16, and llama3-8b's lm_head and w_gate at M = 8.

--host: the host time of one call of q4einsum (the model's int4
projection, "bsd,dm->bsm" at llama2-7b's w_gate, B = 8) with the card held
busy, so that only the Python and the enqueue are counted, and of its
parts alone; it needs only quantize4 and q4einsum, so the same file times
another checkout's package (without the parts) when that package comes
first on PYTHONPATH.

Prints each reading, writes chiprun_out/q4_decode_probe.json (--host:
q4_host_probe.json). Needs the card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

OUT = Path(__file__).resolve().parents[2] / "chiprun_out"
KERNEL = "q4_matmul_decode.cu"
CASES = [  # (label, M, C, N)
    ("w_gate", 8, 4096, 11008), ("w_down", 8, 11008, 4096), ("lm_head", 8, 4096, 32000), ("wq", 8, 4096, 4096),
    ("w_gate M=1", 1, 4096, 11008), ("w_gate M=16", 16, 4096, 11008),
    ("llama3 lm_head", 8, 4096, 128256), ("llama3 w_gate", 8, 4096, 14336),
]
OTHER_PLANS = {  # (bn, splits) beside the plan's
    "w_gate": [(128, 1), (128, 2), (256, 3), (384, 4)], "w_down": [(128, 2), (128, 3), (128, 4), (256, 7)],
    "lm_head": [(128, 1), (256, 2)], "wq": [(128, 2), (128, 3), (128, 4)],
    "llama3 w_gate": [(256, 2), (384, 3)], "llama3 lm_head": [(512, 1), (1024, 2)],
}


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def variants() -> dict:
    from substratus_tpu_torch.tools.flash_bwd_probe import HEADER, _sources, _sub

    src = _sources(KERNEL)
    k, h = src[KERNEL], src[HEADER]
    compute = "        uint32_t r[2][4], a[8][4], b[4][MT][4];\n"
    release = "        __syncwarp();  // the products have read the stage's x tile\n"
    dequant = "          dequant_reg(r[q / 4][q % 4], scales, a[j][h], a[j][h + 1], a[j + 4][h], a[j + 4][h + 1]);"
    raw = "          a[j][h] = a[j][h + 1] = a[j + 4][h] = a[j + 4][h + 1] = r[q / 4][q % 4];"
    pack = "  lo0 = pack_bf16(lo[0], lo[2]);\n  lo1 = pack_bf16(lo[1], lo[3]);\n  hi0 = pack_bf16(hi[0], hi[2]);\n  hi1 = pack_bf16(hi[1], hi[3]);"
    prmt = "\n".join(f"  {o} = __byte_perm(__float_as_uint({v}[{i}]), __float_as_uint({v}[{i + 2}]), 0x7632);"
                     for o, v, i in (("lo0", "lo", 0), ("lo1", "lo", 1), ("hi0", "hi", 0), ("hi1", "hi", 1)))
    no_sum = _sub(_sub(k, "          } else {\n            st_async_f2(", "          } else if (M < 0) {\n            st_async_f2("),
                  "    if (splits > 1 && rank == 0 && set == 0) {", "    if (M < 0) {")
    # the producer arrives on each stage's barrier without loading: the
    # consumers compute on whatever shared memory holds
    compute_only = _sub(k, "          if (RES && c == 0) mbar_expect_tx(xbar, X_BYTES);\n"
                           "          mbar_expect_tx(bar, P_BYTES + S_BYTES + (RES ? 0 : X_BYTES));\n",
                        "          if (RES && c == 0) mbar_arrive(xbar);\n          mbar_arrive(bar);\n")
    compute_only = compute_only.replace("            tma_load_2d(", "            if (M < 0) tma_load_2d(")
    compute_only = compute_only.replace("          tma_load_2d(", "          if (M < 0) tma_load_2d(")
    return {
        "built": src,
        "loads_only": {**src, KERNEL: _sub(_sub(k, compute, "        if (M < 0) {\n" + compute), release,
                                           "        }\n" + release)},
        "no_dequant": {**src, KERNEL: _sub(k, dequant, raw)},
        "no_cvt": {**src, HEADER: _sub(h, pack, prmt)},
        "no_sum": {**src, KERNEL: no_sum},
        "empty": {**src, KERNEL: _sub(k, "ng = (rank + 1) * G / splits - g0;", "ng = M < 0 ? 1 : 0;")},
        "ring_4": {**src, KERNEL: _sub(k, "constexpr int RING = 8;", "constexpr int RING = 4;")},
        "one_block": {**src, KERNEL: _sub(k, "  L.total = L.bar_off", "  L.total = 120 * 1024 + L.bar_off")},
        "compute_only": {**src, KERNEL: compute_only},
    }


def flushed_ms(fn, flush, n: int = 25) -> float:
    """Median of n launches between CUDA events, each after an L2 flush and
    a 0.3 ms spin that holds the start event until the host has enqueued."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        flush()
        torch.cuda._sleep(500_000)
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


def probe(libs: dict, label: str, m: int, c: int, n: int) -> dict:
    from substratus_tpu_torch import kernels
    from substratus_tpu_torch.ops.fused_decode import sm_count
    from substratus_tpu_torch.ops.quant4 import (
        _mma_splits, cluster_capacity, q4_decode_plan, q4_decode_smem, q4_matmul_plain, quantize4)

    gen = torch.Generator(device="cuda").manual_seed(c + n + m)
    qt = quantize4(torch.randn((c, n), generator=gen, device="cuda") * c**-0.5, (0,))
    packed, scale = qt.packed, qt.scale
    x = torch.randn((m, c), generator=gen, device="cuda").to(torch.bfloat16)
    ref = q4_matmul_plain(x, packed, scale, 128)
    dense = qt.dequant(torch.bfloat16)
    l2 = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    stream = kernels.stream_ptr(x.device)
    plan = q4_decode_plan(m, n, c, sm_count(0), cluster_capacity(0, 8 if m <= 8 else 16))
    others = [p for p in dict.fromkeys([q4_decode_plan(m, n, c, sm_count(0))] + OTHER_PLANS.get(label, []))
              if p != plan]
    head = (x.data_ptr(), packed.data_ptr(), scale.data_ptr())
    runs, outs = {}, {}

    def add(name, lib, bn, splits):
        out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
        if lib.q4_matmul_decode(*head, out.data_ptr(), m, n, c, 128, bn, splits, stream) != 0:
            return  # a plan this variant cannot take
        runs[name] = lambda: lib.q4_matmul_decode(*head, out.data_ptr(), m, n, c, 128, bn, splits, stream)
        outs[name] = out

    for name, lib in libs.items():
        add(f"{name}@{plan[0]}x{plan[1]}", lib, *plan)
    for bn, splits in others:
        add(f"built@{bn}x{splits}", libs["built"], bn, splits)
    mma_out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
    splits = _mma_splits(m, n, c, 128, 0)
    ws = torch.empty((splits, m, n), dtype=torch.float32, device="cuda")
    runs["q4_matmul.cu"] = lambda: kernels.check(kernels.library().q4_matmul(
        *head, mma_out.data_ptr(), ws.data_ptr(), m, n, c, 128, splits, stream), "q4_matmul")
    outs["q4_matmul.cu"] = mma_out
    lib_out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
    runs["torch.matmul"] = lambda: torch.matmul(x, dense, out=lib_out)
    outs["torch.matmul"] = lib_out
    zeros = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
    runs["memset of the output"] = zeros.zero_  # one small launch: the events' and the launch's floor
    outs["memset of the output"] = zeros
    runs["built, L2 not flushed"] = runs[f"built@{plan[0]}x{plan[1]}"]
    outs["built, L2 not flushed"] = outs[f"built@{plan[0]}x{plan[1]}"]
    times = {name: [] for name in runs}
    order = list(runs)
    for rnd in range(3):
        for name in order if rnd % 2 == 0 else order[::-1]:
            flush = (lambda: None) if name == "built, L2 not flushed" else (lambda: l2.sum())
            times[name].append(flushed_ms(runs[name], flush))
    torch.cuda.synchronize()
    nbytes = m * c * 2 + packed.numel() + 4 * scale.numel() + m * n * 2
    result = {"plan": plan, "bound_ms": nbytes / 3.35e12 * 1e3}
    for name in runs:
        result[name] = {"ms": statistics.median(times[name]), "rounds": times[name],
                        "row_err": row_err(outs[name], ref)}
    for bn, splits in [plan] + others:
        tiles = -(-(-(-n // 128)) // (bn // 128))
        smem = q4_decode_smem(m, bn // 128, -(-(c // 128) // splits), splits)
        result[f"clusters@{bn}x{splits}"] = [tiles, libs["built"].q4_matmul_decode_clusters(m, splits, smem)]
    line = ", ".join(f"{name} {r['ms']:.4f} (err {r['row_err']:.2g})" for name, r in result.items()
                     if isinstance(r, dict))
    print(f"q4_decode_probe [{label}: M={m} C={c} N={n}, plan {plan}, bound {result['bound_ms']:.4f} ms] {line}; "
          "clusters needed/held: " + ", ".join(f"{k[9:]} {v[0]}/{v[1]}" for k, v in result.items()
                                                 if k.startswith("clusters@")), flush=True)
    return {label: result}


def _host_us(fn, n_calls: int, rounds: int = 5) -> list:
    """Host microseconds of one call of fn, in rounds of n_calls, while a
    long spin keeps the card busy (only the Python and the enqueue)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        torch.cuda._sleep(200_000_000)  # about 0.1 s of spinning, longer than the calls' enqueue
        t0 = time.perf_counter()
        for _ in range(n_calls):
            fn()
        out.append((time.perf_counter() - t0) / n_calls * 1e6)
        torch.cuda.synchronize()
    return out


def host_probe(n_calls: int = 200) -> dict:
    """Host microseconds of one q4einsum call (w_gate at B = 8) with the
    card busy: the wrapper's Python and the enqueue. Where the package has
    the decode design, also the call's parts, each alone."""
    import substratus_tpu_torch
    from substratus_tpu_torch.ops import quant4

    gen = torch.Generator(device="cuda").manual_seed(0)
    w = quant4.quantize4(torch.randn((4096, 11008), generator=gen, device="cuda") * 4096**-0.5, (0,))
    x = torch.randn((8, 1, 4096), generator=gen, device="cuda").to(torch.bfloat16)
    parts = {"q4einsum": lambda: quant4.q4einsum("bsd,dm->bsm", x, w)}
    if hasattr(quant4, "q4_operands"):
        from substratus_tpu_torch import kernels
        from substratus_tpu_torch.ops.fused_decode import sm_count

        x2 = x.reshape(8, 4096)
        p2, s2 = quant4.q4_operands(w, 1)
        out = torch.empty((8, 11008), dtype=torch.bfloat16, device="cuda")
        lib, stream = kernels.library(), kernels.stream_ptr(x.device)
        plan = quant4.q4_decode_plan(8, 11008, 4096, sm_count(0), quant4.cluster_capacity(0, 8))
        args = (x2.data_ptr(), p2.data_ptr(), s2.data_ptr(), out.data_ptr(), 8, 11008, 4096, 128, *plan, stream)
        parts.update({
            "_launch (checks of x, plan, output, launch)": lambda: quant4._launch(x2, p2, s2, 128),
            "C entry point (three tensor maps, the launch)": lambda: lib.q4_matmul_decode(*args),
            "torch.empty of the output": lambda: torch.empty((8, 11008), dtype=torch.bfloat16, device="cuda"),
            "kernels.stream_ptr": lambda: kernels.stream_ptr(x.device),
            "q4_decode_plan (cached) with its capacity": lambda: quant4.q4_decode_plan(
                8, 11008, 4096, sm_count(0), quant4.cluster_capacity(0, 8)),
            "q4_operands (cached views)": lambda: quant4.q4_operands(w, 1),
        })
    result = {"package": str(Path(substratus_tpu_torch.__file__).parent)}
    for name, fn in parts.items():
        rounds = _host_us(fn, n_calls)
        result[name] = {"us_per_call": rounds, "median_us": statistics.median(rounds)}
        print(f"q4_decode_probe --host [{result['package']}] {name}: host us a call, rounds "
              + ", ".join(f"{r:.1f}" for r in rounds) + f"; median {statistics.median(rounds):.1f}", flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m substratus_tpu_torch.tools.q4_decode_probe")
    ap.add_argument("--host", action="store_true", help="the host time of a q4einsum call only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("q4_decode_probe: needs the card", file=sys.stderr)
        return 1
    report = {"card": card()}
    print(f"q4_decode_probe: {report['card']}", flush=True)
    if args.host:
        report.update(host_probe())
        name = "q4_host_probe.json"
    else:
        from substratus_tpu_torch.tools.flash_bwd_probe import build

        libs = build(variants(), KERNEL, ("q4_matmul_decode", "q4_matmul_decode_clusters"))
        for case in CASES:
            report.update(probe(libs, *case))
        name = "q4_decode_probe.json"
    OUT.mkdir(exist_ok=True)
    (OUT / name).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
