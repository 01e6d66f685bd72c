"""Variants of the decode kernels' split design (csrc/decode_split.cu), timed
in turns on the card, to see what bounds it:

    python -m substratus_tpu_torch.tools.decode_probe

Each source variant is the source with one change, a text substitution that
must apply, built by nvcc into its own library under build/kernels/probe/
(tools/flash_bwd_probe.py's build) and called through the C entry points:

  built           as the repository builds it: eight warps a block, one
                  tile in flight each;
  loads_only      each warp waits for its tiles and refills its stage
                  without computing: the loads, the barriers, the merge
                  and the combine;
  warps_4_ring_2  four warps a block, two tiles in flight each (the same
                  shared memory);
  warps_4         four warps a block, one tile in flight each (half the
                  shared memory).

Each runs at decode_split_plan's plan and at 256, 512 and 1024 rows a
split and at one split (whose block writes o and launches no combine);
beside them the built library with every slot before the cache (decode,
pos = -1: every block exits at once and the combine writes zeros: the
floor of the two launches at that plan), and the rows design
(csrc/decode_attn.cu, csrc/fused_decode.cu).

Shapes: the decode attention at llama2-7b's heads (B=8, S=1024, KH=32),
GQA 4 (KH=8) and tinyllama's heads (KH=4, D=64), and the fused kernel at
B=8, S=4096 (KH=32 and KH=8), serve-int4's int8 cache (B=8, S=2048), B=1,
S=4096 at position 4000, and B=8, S=4096 with one slot at 4000 and seven
at 10; positions spread over the cache as in chip_smoke.py. Prints the
median over three rounds (alternating order) of each call's time (a round:
the median of 25 launches between CUDA events, the card held 0.3 ms before
each), the largest error per output vector against the plain version
(loads_only and the empty call disagree by design), and writes
chiprun_out/decode_probe.json. Needs the card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from substratus_tpu_torch import kernels
from substratus_tpu_torch.ops.decode_attention import decode_attention_plain
from substratus_tpu_torch.ops.fused_decode import decode_split_plan, fused_decode_attention_plain, sm_count
from substratus_tpu_torch.ops.quant import quantize_kv
from substratus_tpu_torch.tools.flash_bwd_probe import OUT, _sources, _sub, build, in_rounds

KERNEL = "decode_split.cu"


def variants() -> dict:
    src = _sources(KERNEL)
    k = src[KERNEL]
    start = "    const int n = min(T, r1 - (r0 + t * T));  // live rows of the tile; the rest are stale\n"
    end = "    __syncwarp();\n    if (lane == 0 && t + RING * NW < n_tiles) {"
    return {
        "built": src,
        "loads_only": {**src, KERNEL: _sub(_sub(k, start, start + "    if (n > T) {\n"), end, "    }\n" + end)},
        "warps_4_ring_2": {**src, KERNEL: _sub(_sub(k, "constexpr int NW = 8;", "constexpr int NW = 4;"),
                                               "constexpr int RING = 1;", "constexpr int RING = 2;")},
        "warps_4": {**src, KERNEL: _sub(k, "constexpr int NW = 8;", "constexpr int NW = 4;")},
    }


def probe(libs: dict, fused: bool, b: int, s: int, h: int, kh: int, d: int, positions, int8=False) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(s + kh)
    dev = "cuda"
    q = torch.randn((b, 1, h, d), generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((b, kh, s, d), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    nk, nv = (torch.randn((b, kh, 1, d), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    scales, new_scales = (None, None), (None, None)
    if int8:
        (k, ks), (v, vs), (nk, nks), (nv, nvs) = map(quantize_kv, (k, v, nk, nv))
        scales = (ks[..., 0].contiguous(), vs[..., 0].contiguous())
        new_scales = (nks[..., 0].contiguous(), nvs[..., 0].contiguous())
    sp = [x.data_ptr() if x is not None else None for x in scales + new_scales]
    n_split, rows = decode_split_plan(s, b * kh, sm_count(0))
    g = h // kh
    ws = torch.empty(b * kh * (s // 32 + 1) * g * (d + 2), dtype=torch.float32, device=dev)  # room for any plan
    dims = (b, h, kh, s, d, kernels.DTYPE_CODES[k.dtype], d**-0.5)
    stream = kernels.stream_ptr(q.device)
    runs, outs = {}, {}

    def add(name, lib, plan, p=pos):
        o = torch.empty_like(q)
        if fused:
            head = (q.data_ptr(), nk.data_ptr(), nv.data_ptr(), sp[2], sp[3], k.data_ptr(), v.data_ptr(), sp[0], sp[1],
                    p.data_ptr(), o.data_ptr())
            call = ((lambda: kernels.check(lib.fused_decode_split(*head, ws.data_ptr(), *dims, *plan, stream), name))
                    if plan else (lambda: kernels.check(lib.fused_decode(*head, *dims, stream), name)))
        else:
            head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), sp[0], sp[1], p.data_ptr(), o.data_ptr())
            call = ((lambda: kernels.check(lib.decode_split(*head, ws.data_ptr(), *dims, *plan, stream), name))
                    if plan else (lambda: kernels.check(lib.decode_attn(*head, *dims, stream), name)))
        runs[name] = {"kernel": call}
        outs[name] = [o]

    for name, lib in libs.items():
        for r in sorted({rows, 256, 512, 1024, s} if name != "loads_only" else {rows}):
            if r <= s or r == rows:
                add(f"{name}@{r}", lib, (r, -(-s // r)))
    if not fused:
        add("built_empty", libs["built"], (rows, n_split), torch.full_like(pos, -1))
    add("rows_design", kernels.library(), None)
    if fused:
        ref = fused_decode_attention_plain(q, nk, nv, k.clone(), v.clone(), pos, *new_scales, *scales)[0]
    else:
        ref = decode_attention_plain(q, k, v, pos, *scales)
    label = (f"{'fused' if fused else 'decode'} B={b} S={s} H={h} KH={kh} D={d}{' int8' if int8 else ''} "
             f"pos={positions} plan {n_split}x{rows}")
    result = in_rounds(label, runs, outs, [ref])
    if not fused:
        result[label]["built_empty"]["row_err"] = None  # pos = -1: zeros by design
    return result


def main(argv=None) -> int:
    argparse.ArgumentParser(prog="python -m substratus_tpu_torch.tools.decode_probe").parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_probe: needs the card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"decode_probe: {card}", flush=True)
    libs = build(variants(), KERNEL, ("decode_split", "fused_decode_split"))
    report = {"card": card}
    spread_1k = [0, 1, 17, 255, 511, 700, 1000, 1023]
    spread_2k = [0, 1, 150, 512, 1023, 1500, 2000, 2047]
    spread_4k = [0, 1, 300, 1024, 2047, 3000, 4000, 4095]
    one_long = [4000] + [10] * 7
    for fused, shape, positions, int8 in ((False, (8, 1024, 32, 32, 128), spread_1k, False),
                                          (False, (8, 1024, 32, 8, 128), spread_1k, False),
                                          (False, (8, 1024, 32, 4, 64), spread_1k, False),
                                          (True, (8, 4096, 32, 32, 128), spread_4k, False),
                                          (True, (8, 2048, 32, 32, 128), spread_2k, True),
                                          (True, (8, 4096, 32, 8, 128), spread_4k, False),
                                          (True, (1, 4096, 32, 32, 128), [4000], False),
                                          (True, (8, 4096, 32, 32, 128), one_long, False)):
        report.update(probe(libs, fused, *shape, positions, int8))
    out = OUT.with_name("decode_probe.json")
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
