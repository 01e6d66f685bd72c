#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (substratus_tpu_torch).

    python3 chip_smoke.py            # every phase but profile, one H100
    python3 chip_smoke.py --phases card,build,kernels
    python3 chip_smoke.py --phases card,build,kernels,serve,profile
    python3 chip_smoke.py --phases card,build,kernels,serve-int4,profile

Phases, each of which exits non-zero on failure:

  card        the card's name and power limit (nvidia-smi) and torch's name;
  build       nvcc builds csrc/*.cu for sm_90a (one process per source);
  kernels     each kernel against its plain PyTorch version on the card, in
              bf16 (and int8 caches), at the serving path's shapes: max-abs
              error beside its tolerance, the kernel's time, the plain
              version's, one PyTorch library call's (timed as a yardstick
              only; the port never calls it) and the least time the card
              could take (bytes at 3.35 TB/s, operations at 989 TFLOP/s
              bf16); for the fused decode kernel also the unfused path's
              time (row writes plus the decode kernel) for the same work;
              the int4 matmul at llama2-7b's projection and lm_head widths,
              timed with the 50 MB L2 flushed (by a 256 MB read) before
              each launch, as a decode step streams 3.5 GB of weights; its
              library call one torch.matmul over the dequantized bf16
              weight;
  serve       serve.main's server in-process at llama2-7b's full width and
              depth (random weights from a seed, bf16, max_seq_len 1024),
              five concurrent /v1/completions requests, the kernels' launch
              counts against 32 x prefills and 32 x decode steps, and the
              served tokens held against a direct greedy run of the model;
  serve-long  the same server at max_seq_len 4096 with decode_attn_impl
              "fused": four concurrent requests of about 3000, 1500, 600
              and 40 tokens, whose chunks run through the cached flash
              kernel (32 x prefill chunks) and whose decode steps through
              the fused kernel (32 x steps, the decode kernel never); every
              served greedy token held against a single-shot forward;
  serve-int4  the JAX package's throughput stack: int4 weights (the random
              bf16 weights quantized on the card), int8 cache, fused
              decode, max_seq_len 2048; serve's five prompts and one of
              1500 tokens (3 chunks); every projection and the lm_head
              through the int4 matmul kernel ((7 x 32 + 1) x forwards),
              the attention kernels as in serve-long, every served greedy
              token held against a single-shot forward on the int4 weights;
  profile     (only when named) host-clock prefill and decode-step times
              and, under torch.profiler, their device busy time and top
              kernels, after serve (prompts of 16 and 400 tokens) and after
              serve-long (40 and 3000 tokens, the slots filled at 1000;
              the decode steps also unfused, in turns with the fused ones)
              and after serve-int4 (16 and 1500 tokens), with the int4
              matmul's and the GEMMs' share of the device time.

The line before the last is one JSON object with every kernel's numbers
(launches from the serve phase whose path runs the kernel); the last line
is {"ok": true, "device": {...}}. Details go to chip_smoke.json in OUT_DIR.
Nothing here imports JAX.
"""
from __future__ import annotations

import argparse
import gc
import json
import queue
import random
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"
# bf16 tolerance: the kernel and the plain version round p (flash) and the
# output to bf16 after summing in another order, so they differ by about
# one bf16 ulp of values of order 1 (2^-7 to 2^-6).
BF16_ATOL = 2e-2
LSE_ATOL = 1e-3  # f32 row logsumexp, summed in another order


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, n: int = 25, flush=None) -> float:
    """Median of n launches, each between two CUDA events, after a warm-up;
    flush() runs before each launch, outside the events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        if flush is not None:
            flush()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


# --- kernels against their plain versions -------------------------------------


def flash_case(gen, b, s, h, kh, causal, d=128):
    import torch
    import torch.nn.functional as F

    from substratus_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    dev = "cuda"
    q = torch.randn((b, s, h, d), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((b, s, kh, d), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((b, s, kh, d), generator=gen, device=dev).to(torch.bfloat16)
    out, lse = flash_attention(q, k, v, causal, return_lse=True)
    ref, ref_lse = flash_attention_plain(q, k, v, causal, return_lse=True)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    if not (torch.isfinite(out.float()).all() and err <= BF16_ATOL and lse_err <= LSE_ATOL):
        fail(f"flash b{b} s{s} h{h}/{kh} causal={causal}: max|err| {err} (tol {BF16_ATOL}), "
             f"lse {lse_err} (tol {LSE_ATOL})")
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    gqa = {"enable_gqa": True} if h != kh else {}
    pairs = s * (s + 1) // 2 if causal else s * s
    b_ms, by = bound(2 * (2 * b * s * h * d + 2 * b * s * kh * d), 4 * d * h * b * pairs)
    return {
        "case": f"B={b} S={s} H={h} KH={kh} D={d} causal={causal}",
        "max_abs_err": err, "lse_max_abs_err": lse_err, "tol": BF16_ATOL,
        "ms": time_ms(lambda: flash_attention(q, k, v, causal)),
        "plain_ms": time_ms(lambda: flash_attention_plain(q, k, v, causal)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, **gqa)),
        "bound_ms": b_ms, "bound_by": by,
    }


def decode_case(gen, b, s, h, kh, int8, positions, d=128):
    import torch
    import torch.nn.functional as F

    from substratus_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain
    from substratus_tpu_torch.ops.quant import quantize_kv

    dev = "cuda"
    q = torch.randn((b, 1, h, d), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((b, kh, s, d), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((b, kh, s, d), generator=gen, device=dev).to(torch.bfloat16)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    ks = vs = None
    if int8:
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
        ks, vs = ks[..., 0].contiguous(), vs[..., 0].contiguous()
    out = decode_attention(q, k, v, pos, ks, vs)
    ref = decode_attention_plain(q, k, v, pos, ks, vs)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not (torch.isfinite(out.float()).all() and err <= BF16_ATOL):
        fail(f"decode b{b} s{s} h{h}/{kh} int8={int8}: max|err| {err} (tol {BF16_ATOL})")
    rows = sum(min(p + 1, s) for p in positions if p >= 0)  # cache rows the data needs
    elem = 1 if int8 else 2
    nbytes = 2 * b * h * d * 2 + 2 * rows * kh * d * elem + (2 * rows * kh * 4 if int8 else 0) + 4 * b
    b_ms, by = bound(nbytes, 4 * d * rows * kh * (h // kh))
    library_ms = None
    if not int8:  # no PyTorch call takes an int8 cache with per-row scales
        qt = q.transpose(1, 2)
        mask = (torch.arange(s, device=dev)[None, :] <= pos[:, None].long())[:, None, None, :]
        gqa = {"enable_gqa": True} if h != kh else {}
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, k, v, attn_mask=mask, **gqa))
    return {
        "case": f"B={b} S={s} H={h} KH={kh} D={d} {'int8' if int8 else 'bf16'} pos={positions}",
        "max_abs_err": err, "tol": BF16_ATOL,
        "ms": time_ms(lambda: decode_attention(q, k, v, pos, ks, vs)),
        "plain_ms": time_ms(lambda: decode_attention_plain(q, k, v, pos, ks, vs)),
        "library_ms": library_ms, "bound_ms": b_ms, "bound_by": by,
    }


def cached_case(gen, h, kh, int8, limit_row=False, b=1, sq=512, sk=4096, start=2048, d=128):
    """A chunk of sq queries at positions start.. against an sk-row cache
    (the fifth 512-token chunk of a long prompt by default). limit_row:
    kv_length clips the chunk and the first row's position is -1, so that
    row's limit is -1 and its output must be exactly 0."""
    import torch
    import torch.nn.functional as F

    from substratus_tpu_torch.ops.flash_attention import flash_cached_attention, flash_cached_attention_plain
    from substratus_tpu_torch.ops.quant import quantize_kv

    dev = "cuda"
    q = torch.randn((b, sq, h, d), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((b, kh, sk, d), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((b, kh, sk, d), generator=gen, device=dev).to(torch.bfloat16)
    pos = (start + torch.arange(sq, device=dev)).repeat(b, 1).to(torch.int32)
    kv_len = None
    if limit_row:
        pos[:, 0] = -1
        kv_len = torch.full((b,), start + sq // 2, dtype=torch.int32, device=dev)
    ks = vs = None
    if int8:
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
        ks, vs = ks[..., 0].contiguous(), vs[..., 0].contiguous()
    args = (q, k, v, pos, ks, vs, kv_len)
    out = flash_cached_attention(*args)
    ref = flash_cached_attention_plain(*args)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not (torch.isfinite(out.float()).all() and err <= BF16_ATOL):
        fail(f"flash_cached h{h}/{kh} int8={int8} limit_row={limit_row}: max|err| {err} (tol {BF16_ATOL})")
    if limit_row and not torch.all(out[:, 0] == 0):
        fail("flash_cached: a row with limit -1 is not exactly 0")
    limit = pos.long() if kv_len is None else torch.minimum(pos.long(), kv_len.long()[:, None] - 1)
    live_cols = (limit.clamp(min=-1) + 1).clamp(max=sk)  # [B, Sq]
    rows = int(live_cols.amax(dim=1).sum())  # cache rows the blocks must read
    elem = 1 if int8 else 2
    nbytes = 2 * b * sq * h * d * 2 + 2 * rows * kh * d * elem + (2 * rows * kh * 4 if int8 else 0) + 4 * b * sq
    b_ms, by = bound(nbytes, 4 * d * h * int(live_cols.sum()))
    library_ms = None
    if not int8:  # no PyTorch call takes an int8 cache with per-row scales
        qt = q.transpose(1, 2)
        mask = (torch.arange(sk, device=dev)[None, None, :] <= limit[:, :, None])[:, None]
        gqa = {"enable_gqa": True} if h != kh else {}
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, k, v, attn_mask=mask, **gqa))
    return {
        "case": f"B={b} Sq={sq} Sk={sk} H={h} KH={kh} D={d} {'int8' if int8 else 'bf16'} pos {start}.."
                f"{start + sq - 1}{' kv_length, one row at limit -1' if limit_row else ''}",
        "max_abs_err": err, "tol": BF16_ATOL,
        "ms": time_ms(lambda: flash_cached_attention(*args)),
        "plain_ms": time_ms(lambda: flash_cached_attention_plain(*args)),
        "library_ms": library_ms, "bound_ms": b_ms, "bound_by": by,
    }


def fused_case(gen, h, kh, int8, positions, b=8, s=4096, d=128):
    """The fused cache write + decode attention at decode positions spread
    over the cache. After the launch the cache row at pos must be the new
    row. Also timed: the unfused path for the same work (the row writes of
    update_cache_and_attend plus the decode kernel)."""
    import torch
    import torch.nn.functional as F

    from substratus_tpu_torch.ops.decode_attention import _write_rows, decode_attention
    from substratus_tpu_torch.ops.fused_decode import fused_decode_attention, fused_decode_attention_plain
    from substratus_tpu_torch.ops.quant import quantize_kv

    dev = "cuda"
    q = torch.randn((b, 1, h, d), generator=gen, device=dev).to(torch.bfloat16)
    nk, nv = (torch.randn((b, kh, 1, d), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    ck, cv = (torch.randn((b, kh, s, d), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    pos2 = pos.long()[:, None]
    rows = (torch.arange(b, device=dev)[:, None], torch.arange(kh, device=dev)[None, :], pos2)
    scales = ()
    if int8:
        (nk, nks), (nv, nvs), (ck, cks), (cv, cvs) = map(quantize_kv, (nk, nv, ck, cv))
        nks, nvs, cks, cvs = nks[..., 0], nvs[..., 0], cks[..., 0].contiguous(), cvs[..., 0].contiguous()
        cks[rows], cvs[rows] = nks[..., 0], nvs[..., 0]  # the caller's scale writes
        scales = (nks, nvs, cks, cvs)
    kc, vc, kp, vp = ck.clone(), cv.clone(), ck.clone(), cv.clone()
    out, _, _ = fused_decode_attention(q, nk, nv, kc, vc, pos, *scales)
    ref, _, _ = fused_decode_attention_plain(q, nk, nv, kp, vp, pos, *scales)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not (torch.isfinite(out.float()).all() and err <= BF16_ATOL):
        fail(f"fused_decode h{h}/{kh} int8={int8}: max|err| {err} (tol {BF16_ATOL})")
    if not (torch.equal(kc[rows], nk[:, :, 0]) and torch.equal(vc[rows], nv[:, :, 0])
            and torch.equal(kc, kp) and torch.equal(vc, vp)):
        fail(f"fused_decode h{h}/{kh} int8={int8}: the cache row at pos is not the new row")
    hist = sum(positions)  # history rows 0..pos-1 the kernel must read
    elem = 1 if int8 else 2
    nbytes = (2 * b * h * d * 2 + 2 * hist * kh * d * elem + (2 * hist * kh * 4 if int8 else 0)
              + 2 * 2 * b * kh * d * elem + (2 * b * kh * 4 if int8 else 0) + 4 * b)
    b_ms, by = bound(nbytes, 4 * d * h * (hist + b))
    ks_c, vs_c = (scales[2], scales[3]) if int8 else (None, None)

    def unfused():
        _write_rows(kc, nk, pos2)
        _write_rows(vc, nv, pos2)
        if int8:
            _write_rows(ks_c, scales[0], pos2)
            _write_rows(vs_c, scales[1], pos2)
        decode_attention(q, kc, vc, pos, ks_c, vs_c)

    library_ms = None
    if not int8:
        qt = q.transpose(1, 2)
        mask = (torch.arange(s, device=dev)[None, :] <= pos2)[:, None, None, :]
        gqa = {"enable_gqa": True} if h != kh else {}
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kc, vc, attn_mask=mask, **gqa))
    unfused_ms = time_ms(unfused)
    return {
        "case": f"B={b} S={s} H={h} KH={kh} D={d} {'int8' if int8 else 'bf16'} pos={positions}",
        "max_abs_err": err, "tol": BF16_ATOL,
        "ms": time_ms(lambda: fused_decode_attention(q, nk, nv, kc, vc, pos, *scales)),
        "plain_ms": time_ms(lambda: fused_decode_attention_plain(q, nk, nv, kp, vp, pos, *scales)),
        "unfused_ms": unfused_ms, "library_ms": library_ms, "bound_ms": b_ms, "bound_by": by,
    }


def q4_case(gen, m, n, c=4096, heads=None):
    """x [m, c] bf16 times a random weight [c, n] quantized by quantize4
    as the model's own (heads: wo's [heads, c / heads, n] layout, groups
    along head_dim), the L2 flushed before each timed launch."""
    import torch

    from substratus_tpu_torch.ops.quant4 import q4_matmul, q4_matmul_plain, quantize4

    dev = "cuda"
    shape, contracting = ((heads, c // heads, n), (0, 1)) if heads else ((c, n), (0,))
    qt = quantize4(torch.randn(shape, generator=gen, device=dev) * c**-0.5, contracting)
    packed, scale, block = qt.packed.reshape(c // 2, n), qt.scale.reshape(-1, n), qt.block
    x = torch.randn((m, c), generator=gen, device=dev).to(torch.bfloat16)
    out = q4_matmul(x, packed, scale, block)
    ref = q4_matmul_plain(x, packed, scale, block)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    # Both sides multiply the same bf16 weights: the output's bf16 rounding
    # (2^-8 relative) and the f32 summation order differ.
    tol = 1e-2 * ref.float().abs().max().item()
    if not (torch.isfinite(out.float()).all() and err <= tol):
        fail(f"q4_matmul m{m} c{c} n{n} block {block}: max|err| {err} (tol {tol})")
    dense = qt.dequant(torch.bfloat16).reshape(c, n)
    l2 = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)  # 256 MB, 5x the 50 MB L2

    def flush():  # a read: written lines would be written back inside the timed launch
        l2.sum()

    b_ms, by = bound(m * c * 2 + packed.numel() + 4 * scale.numel() + m * n * 2, 2 * m * c * n)
    return {
        "case": f"M={m} C={c} N={n} block={block}{f' (wo, {heads} heads)' if heads else ''}",
        "max_abs_err": err, "tol": tol,
        "ms": time_ms(lambda: q4_matmul(x, packed, scale, block), flush=flush),
        "plain_ms": time_ms(lambda: q4_matmul_plain(x, packed, scale, block), flush=flush),
        "library_ms": time_ms(lambda: torch.matmul(x, dense), flush=flush),
        "bound_ms": b_ms, "bound_by": by,
    }


def kernel_phase():
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flash = [
        flash_case(gen, 1, 512, 32, 32, True),  # llama2-7b prefill, bucket 512
        flash_case(gen, 1, 100, 32, 32, True),  # a ragged length
        flash_case(gen, 1, 512, 32, 8, True),  # llama3-8b heads (GQA 4)
        flash_case(gen, 1, 384, 32, 32, False),
    ]
    positions = [0, 1, 17, 255, 511, 700, 1000, 1023]
    decode = [
        decode_case(gen, 8, 1024, 32, 32, False, positions),  # llama2-7b decode, B=8
        decode_case(gen, 8, 1024, 32, 32, True, positions),
        decode_case(gen, 8, 1024, 32, 8, False, positions),  # llama3-8b heads (GQA 4)
        decode_case(gen, 8, 1024, 32, 8, True, positions),
    ]
    cached = [
        cached_case(gen, 32, 32, False),  # llama2-7b, the fifth chunk of a long prompt
        cached_case(gen, 32, 32, True),
        cached_case(gen, 32, 8, False),  # llama3-8b heads (GQA 4)
        cached_case(gen, 32, 32, False, limit_row=True),
    ]
    spread = [0, 1, 300, 1024, 2047, 3000, 4000, 4095]  # one slot at S-1
    fused = [
        fused_case(gen, 32, 32, False, spread),  # llama2-7b decode, B=8, S=4096
        fused_case(gen, 32, 32, True, spread),
        fused_case(gen, 32, 8, False, spread),  # llama3-8b heads (GQA 4)
    ]
    q4 = [
        q4_case(gen, 8, 11008),  # llama2-7b w_gate/w_up at B=8
        q4_case(gen, 8, 32000),  # the lm_head at B=8
        q4_case(gen, 8, 4096, c=11008),  # w_down at B=8
        q4_case(gen, 8, 4096),  # wq/wk/wv/wo at B=8
        q4_case(gen, 512, 11008),  # w_gate over a 512-token prefill bucket or chunk
        q4_case(gen, 128, 32000),  # the lm_head over a 128-token prefill bucket
        q4_case(gen, 1, 11008),  # one decoding slot
        q4_case(gen, 8, 2048, c=2048, heads=32),  # tinyllama's wo: groups of 64
    ]
    report = {"flash_fwd": flash, "decode_attn": decode, "flash_cached": cached, "fused_decode": fused,
              "q4_matmul": q4}
    for name, cases in report.items():
        for c in cases:
            lib = "n/a" if c["library_ms"] is None else f"{c['library_ms']:.4f}"
            print(f"kernel {name} [{c['case']}]: max|err| {c['max_abs_err']:.3g} (tol {c['tol']})"
                  f"{' lse ' + format(c['lse_max_abs_err'], '.3g') if 'lse_max_abs_err' in c else ''}"
                  f" | ms {c['ms']:.4f} plain {c['plain_ms']:.4f} library {lib}"
                  f"{' unfused ' + format(c['unfused_ms'], '.4f') if 'unfused_ms' in c else ''}"
                  f" bound {c['bound_ms']:.4f} ({c['bound_by']})", flush=True)
    return report


# --- the main path: serve.main's server ---------------------------------------

PROMPTS = [  # (text, max_tokens, temperature, stream): ByteTokenizer ids = 1 + bytes
    ("The quick brown", 32, 0.0, False),  # 16 tokens -> bucket 16
    ("x" * 99, 32, 0.0, True),  # 100 tokens -> bucket 128, streamed
    ("serve " * 66 + "abc", 32, 0.0, False),  # 400 tokens -> bucket 512
    ("A sampled reply " * 6 + "!!!", 32, 0.8, False),  # 100 tokens, temperature 0.8
    ("Greedy again, sixteen..", 32, 0.0, False),
]


def post(base: str, body: dict):
    req = urllib.request.Request(f"{base}/v1/completions", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as resp:
        if not body.get("stream"):
            return resp.status, json.loads(resp.read()), None
        usage, finish, n_chunks, ttft = None, None, 0, None
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            if line == "data: [DONE]":
                break
            obj = json.loads(line[6:])
            if obj.get("usage"):
                usage = obj["usage"]
            for ch in obj["choices"]:
                if ttft is None:
                    ttft = time.perf_counter() - t0
                n_chunks += 1
                finish = ch["finish_reason"] or finish
        return resp.status, {"usage": usage, "finish": finish, "chunks": n_chunks}, ttft


def wait_idle(engine) -> None:
    """Let the scheduler finish the iteration that released the last slot
    (its step counters land just after the final token is delivered)."""
    deadline = time.time() + 30
    while engine.active.any() and time.time() < deadline:
        time.sleep(0.01)
    time.sleep(0.5)


def reference_check(engine) -> dict:
    """Hold the engine's greedy tokens (decode kernel over the slot cache)
    against one teacher-forced forward of prompt + tokens through the
    flash kernel, and that forward against the plain attention path."""
    import torch

    from substratus_tpu_torch.models import llama
    from substratus_tpu_torch.serve.tokenizer import ByteTokenizer

    prompt = ByteTokenizer().encode(PROMPTS[0][0])
    toks = engine.generate(prompt, max_tokens=16, temperature=0.0)
    seq = torch.tensor([prompt + toks[:-1]], device=engine.device)
    cfg = engine.cfg
    kern, _ = llama.forward(engine.params, seq, cfg)
    plain, _ = llama.forward(engine.params, seq, cfg.replace(attn_impl="plain"))
    kern, plain = kern[0, len(prompt) - 1:], plain[0, len(prompt) - 1:]
    scale = kern.abs().max().item()
    path_err = (kern - plain).abs().max().item()
    # How far below the reference's best logit each served token lies.
    gaps = (kern.max(dim=-1).values - kern[torch.arange(len(toks)), torch.tensor(toks)]).tolist()
    agree = sum(int(kern[i].argmax()) == t for i, t in enumerate(toks))
    out = {"tokens": toks, "logit_scale": scale, "kernel_vs_plain_max_abs": path_err,
           "argmax_agree": agree, "max_gap": max(gaps)}
    print(f"reference: {agree}/{len(toks)} served greedy tokens are the argmax of the teacher-forced "
          f"forward (largest gap {max(gaps):.4g}); kernel vs plain logits max|diff| {path_err:.4g} "
          f"at logit scale {scale:.4g}", flush=True)
    if not (torch.isfinite(kern).all() and torch.isfinite(plain).all()):
        fail("non-finite logits")
    if not toks or path_err > 0.05 * scale or max(gaps) > 0.05 * scale:
        fail(f"served tokens or logits disagree with the reference: {out}")
    return out


# Kernel-name fragments of the int4 matmul and of cuBLAS's GEMMs.
Q4_NAMES = ("q4_matmul", "q4_splitk")
GEMM_NAMES = ("gemm", "gemv", "nvjet", "xmma", "cutlass")


def _device_summary(prof, wall: float, reps: int, top_n: int = 10) -> dict:
    """Device busy time, the top kernels, and the time of the int4 matmul
    and of the GEMMs, of a profile (device-side events only: the CPU ops
    that launched them carry the same time)."""
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    def ms_of(names):
        return sum(dev_us(e) for e in kernels if any(s in e.key.lower() for s in names)) / 1e3 / reps

    busy = sum(dev_us(e) for e in kernels) / 1e6
    top = sorted(kernels, key=dev_us, reverse=True)[:top_n]
    return {"profiled_ms": 1e3 * wall / reps, "device_busy_ms": 1e3 * busy / reps,
            "q4_matmul_ms": ms_of(Q4_NAMES), "gemm_ms": ms_of(GEMM_NAMES),
            "top": [{"name": e.key, "ms": dev_us(e) / 1e3 / reps, "calls": e.count / reps} for e in top]}


def profile_engine(engine, label: str = "profile", lens=(16, 400), fill: int = 100, steps: int = 8,
                   alt_decode=None) -> dict:
    """Host-clock prefill times of prompts of `lens` tokens and the
    decode-step time, and, under torch.profiler, the device busy time and
    top kernels of the longer prefill and of decode steps with every slot
    active (the rest filled with `fill`-token prompts). With alt_decode,
    the same slots also decode with that decode_attn_impl, in turns with
    the configured one. Driven from this thread after the scheduler has
    stopped."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from substratus_tpu_torch.serve.engine import Request

    def admit(n: int) -> float:  # one prompt of n tokens into a free slot
        engine.queue.put(Request([256] + [65] * (n - 1), max_tokens=10_000, temperature=0.0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if engine._admit() != 1:
            fail("profile: admission failed")
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def decode(n: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            engine._decode_step()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    short, long = lens
    out = {"prefill_ms": {n: 1e3 * min(admit(n), admit(n)) for n in lens}}
    chunks = engine.stats["prefill_chunks"]
    with profile(activities=activities) as prof:
        wall = admit(long)
    out[f"prefill_{long}"] = _device_summary(prof, wall, 1)
    out["chunks"] = int(engine.stats["prefill_chunks"] - chunks)
    while not engine.active.all():
        admit(fill)
    decode(2)
    out["decode_step_ms"] = 1e3 * decode(steps) / steps
    with profile(activities=activities) as prof:
        wall = decode(steps)
    out["decode"] = _device_summary(prof, wall, steps)
    out["batch"] = int(engine.active.sum())
    if alt_decode is not None:
        cfg = engine.cfg
        turns = {cfg.decode_attn_impl: [out["decode_step_ms"]], alt_decode: []}
        for impl in (alt_decode, alt_decode, cfg.decode_attn_impl):
            engine.cfg = cfg.replace(decode_attn_impl=impl)
            turns[impl].append(1e3 * decode(steps) / steps)
        engine.cfg = cfg.replace(decode_attn_impl=alt_decode)
        with profile(activities=activities) as prof:
            wall = decode(steps)
        engine.cfg = cfg
        out["decode_turns_ms"] = turns
        out[f"decode_{alt_decode}"] = _device_summary(prof, wall, steps)
        print(f"{label}: decode step at B={out['batch']} in turns, ms: "
              + "; ".join(f"{impl} {', '.join(f'{t:.2f}' for t in ts)}" for impl, ts in turns.items())
              + f"; device busy {out['decode']['device_busy_ms']:.2f} ms ({cfg.decode_attn_impl}) against "
              f"{out[f'decode_{alt_decode}']['device_busy_ms']:.2f} ms ({alt_decode})", flush=True)
    print(f"{label}: prefill {short} tokens {out['prefill_ms'][short]:.1f} ms, {long} tokens "
          f"{out['prefill_ms'][long]:.1f} ms in {out['chunks'] or 1} chunk(s) (device busy "
          f"{out[f'prefill_{long}']['device_busy_ms']:.2f} ms); decode step at B={out['batch']} "
          f"{out['decode_step_ms']:.2f} ms (device busy {out['decode']['device_busy_ms']:.2f} ms, "
          f"{100 * out['decode']['device_busy_ms'] / out['decode_step_ms']:.1f}%; int4 matmul "
          f"{out['decode']['q4_matmul_ms']:.3f} ms, GEMMs {out['decode']['gemm_ms']:.3f} ms of it)", flush=True)
    for phase in (f"prefill_{long}", "decode"):
        for e in out[phase]["top"]:
            print(f"{label} {phase}: {e['ms']:8.3f} ms {e['calls']:6.1f} calls  {e['name'][:80]}", flush=True)
    return out


def start_server(name: str, params: dict):
    """serve.main's server in-process from a params.json, at llama2-7b's
    full width and depth, answering GET / and warmed up by one request.
    Returns (server, engine, base URL)."""
    import torch

    from substratus_tpu_torch.serve import main as serve_main

    OUT_DIR.mkdir(exist_ok=True)
    params_path = OUT_DIR / f"chip_smoke_params_{name}.json"
    params_path.write_text(json.dumps(params))
    t0 = time.perf_counter()
    server = serve_main.build(["--params", str(params_path), "--host", "127.0.0.1", "--port", "0"])
    engine = server.state.engine
    torch.cuda.synchronize()
    cfg = engine.cfg
    if (cfg.dim, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.vocab_size) != (4096, 32, 32, 32, 32000):
        fail(f"not llama2-7b at full width and depth: {cfg}")
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    print(f"{name}: llama2-7b built in {time.perf_counter() - t0:.1f} s "
          f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card)", flush=True)
    with urllib.request.urlopen(f"{base}/", timeout=60) as r:
        if r.status != 200:
            fail(f"GET / -> {r.status}")
    post(base, {"prompt": "warm up", "max_tokens": 2, "temperature": 0.0})  # cuBLAS handles etc.
    wait_idle(engine)
    return server, engine, base


def run_concurrent(base: str, prompts) -> tuple:
    """POST every (text, max_tokens, temperature, stream) at once; returns
    ([(status, body, ttft)], wall seconds)."""
    results = [None] * len(prompts)

    def run(i, text, max_tokens, temp, stream):
        body = {"prompt": text, "max_tokens": max_tokens, "temperature": temp}
        if stream:
            body.update(stream=True, stream_options={"include_usage": True})
        try:
            results[i] = post(base, body)
        except Exception as e:  # reported by check_usage as a failed request
            results[i] = (None, repr(e), None)

    t_run = time.perf_counter()
    threads = [threading.Thread(target=run, args=(i, *p)) for i, p in enumerate(prompts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results, time.perf_counter() - t_run


def check_usage(prompts, results) -> int:
    """Every status 200 with the right usage and finish; returns the
    number of generated tokens."""
    generated = 0
    for (text, max_tokens, temp, stream), (status, body, _) in zip(prompts, results):
        if status != 200:
            fail(f"request {text[:20]!r}: {status} {body}")
        usage = body["usage"]
        n_prompt = len(text.encode()) + 1
        if usage is None or usage["prompt_tokens"] != n_prompt or not 1 <= usage["completion_tokens"] <= max_tokens:
            fail(f"request {text[:20]!r}: usage {usage}, want {n_prompt} prompt tokens")
        finish = body["finish"] if stream else body["choices"][0]["finish_reason"]
        if (finish == "length") != (usage["completion_tokens"] == max_tokens):
            fail(f"request {text[:20]!r}: finish {finish} with {usage['completion_tokens']} tokens")
        if stream and body["chunks"] != usage["completion_tokens"] + 1:
            fail(f"streamed request: {body['chunks']} chunks for {usage['completion_tokens']} tokens")
        generated += usage["completion_tokens"]
    return generated


def zero_counts(engine, counters) -> None:
    for k, v in engine.stats.items():
        engine.stats[k] = 0 * v
    for c in counters:
        c.launches = 0


def serve_phase(card: str, profile_steps: bool = False):
    from substratus_tpu_torch.ops.decode_attention import decode_attention
    from substratus_tpu_torch.ops.flash_attention import flash_attention

    server, engine, base = start_server("serve", {
        "config": "llama2-7b", "max_batch": 8, "max_seq_len": 1024, "max_prefill_len": 512,
        "kv_cache_dtype": "model"})
    try:
        zero_counts(engine, (flash_attention, decode_attention))
        results, wall = run_concurrent(base, PROMPTS)
        wait_idle(engine)
        launches = {"flash_fwd": flash_attention.launches, "decode_attn": decode_attention.launches}
        stats = dict(engine.stats)
        reference = reference_check(engine)
    finally:
        server.stop()
    profiled = profile_engine(engine) if profile_steps else None

    generated = check_usage(PROMPTS, results)
    L = engine.cfg.n_layers
    if stats["prefills"] != len(PROMPTS):
        fail(f"{stats['prefills']} prefills for {len(PROMPTS)} requests")
    if launches["flash_fwd"] != L * stats["prefills"] or launches["decode_attn"] != L * stats["decode_steps"]:
        fail(f"launches {launches} against {L} x {stats['prefills']} prefills and "
             f"{L} x {stats['decode_steps']} decode steps")
    if launches["flash_fwd"] == 0 or launches["decode_attn"] == 0:
        fail(f"a kernel of the main path never launched: {launches}")
    ttft = stats["prefill_seconds"] / stats["prefills"]
    step_ms = 1e3 * stats["decode_seconds"] / stats["decode_steps"]
    decode_tps = (generated - len(PROMPTS)) / stats["decode_seconds"]
    print(f"serve: {len(PROMPTS)} concurrent requests, {generated} tokens in {wall:.2f} s; "
          f"{stats['prefills']} prefills, {stats['decode_steps']} decode steps; launches {launches}", flush=True)
    print(f"serve [{card}]: mean prefill (TTFT on the engine) {ttft * 1e3:.1f} ms, "
          f"decode {decode_tps:.1f} tokens/s, mean step {step_ms:.2f} ms", flush=True)
    return {"launches": launches, "stats": stats, "wall_s": wall, "generated": generated,
            "ttft_ms": ttft * 1e3, "decode_tokens_per_s": decode_tps, "step_ms": step_ms,
            "requests": [r[1] for r in results], "reference": reference, "profile": profiled}


def _long_text(n_bytes: int, seed: int) -> str:
    rng = random.Random(seed)
    words = ["the", "cache", "of", "a", "long", "prompt", "runs", "in", "chunks", "through",
             "flash", "kernel", "served", "tokens", "decode", "step", "card", "model"]
    text = ""
    while len(text) < n_bytes:
        text += rng.choice(words) + " "
    return text[:n_bytes]


# Long prompts through the chunked prefill: (text, max_tokens, temperature,
# stream); ByteTokenizer ids = 1 + bytes, so 3000 / 1500 / 600 / 40 tokens,
# which max_prefill_len=512 runs as 6 / 3 / 2 chunks and one single-shot
# prefill. The 3000-token request is streamed for its time to first token.
LONG_PARAMS = {"config": "llama2-7b", "max_batch": 8, "max_seq_len": 4096, "max_prefill_len": 512,
               "kv_cache_dtype": "model", "decode_attn_impl": "fused", "chunk_attn_impl": "flash"}
LONG_PROMPTS = [
    (_long_text(2999, 1), 32, 0.0, True),
    (_long_text(1499, 2), 32, 0.0, False),
    (_long_text(599, 3), 32, 0.0, False),
    (_long_text(39, 4), 32, 0.0, False),
]


class _TeeQueue(queue.Queue):
    """A request's token queue that also keeps every token it delivers."""

    def __init__(self):
        super().__init__()
        self.tokens = []

    def put(self, item, block=True, timeout=None):
        if item is not None:
            self.tokens.append(item)
        super().put(item, block, timeout)


def tee_requests(engine) -> list:
    """Keep every request the engine is handed from now on, each token
    queue a _TeeQueue; `del engine.submit` ends it."""
    requests = []
    submit = engine.submit

    def tee_submit(req):
        req.out = _TeeQueue()
        requests.append(req)
        return submit(req)

    engine.submit = tee_submit
    return requests


def long_reference_check(engine, requests, label: str = "serve-long") -> dict:
    """Each served greedy token (chunked prefill + fused decode) within 5%
    of the logit scale of the best logit of one teacher-forced single-shot
    forward (flash prefill, no cache) over prompt + served tokens, on the
    engine's own weights."""
    import torch

    from substratus_tpu_torch.models import llama

    out = []
    for req in requests:
        prompt, toks = engine.clipped_prompt(req.prompt_tokens), req.out.tokens
        seq = torch.tensor([prompt + toks[:-1]], device=engine.device)
        logits, _ = llama.forward(engine.params, seq, engine.cfg)
        logits = logits[0, len(prompt) - 1:]
        if not torch.isfinite(logits).all():
            fail(f"{label}: non-finite logits in the reference of a {len(prompt)}-token prompt")
        scale = logits.abs().max().item()
        gaps = logits.max(dim=-1).values - logits[torch.arange(len(toks)), torch.tensor(toks)]
        agree = sum(int(logits[i].argmax()) == t for i, t in enumerate(toks))
        out.append({"prompt_tokens": len(prompt), "tokens": len(toks), "argmax_agree": agree,
                    "max_gap": gaps.max().item(), "logit_scale": scale})
        print(f"{label} reference: {len(prompt)}-token prompt, {agree}/{len(toks)} served greedy tokens are "
              f"the argmax of the single-shot forward (largest gap {gaps.max().item():.4g} at logit scale "
              f"{scale:.4g})", flush=True)
        if not toks or gaps.max().item() > 0.05 * scale:
            fail(f"{label}: served tokens disagree with the single-shot reference: {out[-1]}")
    return {"requests": out}


def serve_long_phase(card: str, profile_steps: bool = False):
    """Long prompts on the dense cache: chunked prefill through the cached
    flash kernel, decode through the fused kernel, llama2-7b at
    max_seq_len 4096 (a 17.2 GB bf16 cache beside 13.5 GB of weights)."""
    import torch

    from substratus_tpu_torch.ops.decode_attention import decode_attention
    from substratus_tpu_torch.ops.flash_attention import flash_attention, flash_cached_attention
    from substratus_tpu_torch.ops.fused_decode import fused_decode_attention

    gc.collect()  # the serve phase's server and cache
    torch.cuda.empty_cache()
    server, engine, base = start_server("serve-long", LONG_PARAMS)
    counters = {"flash_cached": flash_cached_attention, "fused_decode": fused_decode_attention,
                "flash_fwd": flash_attention, "decode_attn": decode_attention}
    requests = tee_requests(engine)
    try:
        zero_counts(engine, counters.values())
        results, wall = run_concurrent(base, LONG_PROMPTS)
        wait_idle(engine)
        launches = {name: c.launches for name, c in counters.items()}
        stats = dict(engine.stats)
    finally:
        server.stop()
    generated = check_usage(LONG_PROMPTS, results)
    del engine.submit
    L = engine.cfg.n_layers
    want = {"flash_cached": L * stats["prefill_chunks"], "flash_fwd": L * stats["prefills"],
            "fused_decode": L * stats["decode_steps"], "decode_attn": 0}
    chunk = LONG_PARAMS["max_prefill_len"]
    lengths = [len(text.encode()) + 1 for text, *_ in LONG_PROMPTS]
    chunks = sum(-(-n // chunk) for n in lengths if n > chunk)  # 6 + 3 + 2
    singles = sum(n <= chunk for n in lengths)
    if launches != want or (stats["prefill_chunks"], stats["prefills"]) != (chunks, singles):
        fail(f"serve-long: launches {launches} against {want}; stats {stats}, want {chunks} chunks "
             f"and {singles} single-shot prefills")
    if not all(launches[name] > 0 for name in ("flash_cached", "fused_decode", "flash_fwd")):
        fail(f"serve-long: a kernel of the path never launched: {launches}")
    reference = long_reference_check(engine, requests)
    profiled = profile_engine(engine, "profile-long", (40, 3000), 1000, alt_decode="kernel") if profile_steps else None
    ttft = results[0][2]
    step_ms = 1e3 * stats["decode_seconds"] / stats["decode_steps"]
    decode_tps = (generated - len(LONG_PROMPTS)) / stats["decode_seconds"]
    print(f"serve-long: {len(LONG_PROMPTS)} concurrent requests ({', '.join(str(len(p[0]) + 1) for p in LONG_PROMPTS)}"
          f" prompt tokens), {generated} tokens in {wall:.2f} s; {stats['prefill_chunks']} prefill chunks, "
          f"{stats['prefills']} single-shot prefill, {stats['decode_steps']} decode steps; launches {launches}",
          flush=True)
    print(f"serve-long [{card}]: TTFT of the 3000-token request {ttft * 1e3:.1f} ms (client, streamed), "
          f"engine prefill time {stats['prefill_seconds'] * 1e3:.1f} ms in all, decode {decode_tps:.1f} tokens/s, "
          f"mean step {step_ms:.2f} ms", flush=True)
    return {"launches": launches, "stats": stats, "wall_s": wall, "generated": generated,
            "ttft_3000_ms": ttft * 1e3, "decode_tokens_per_s": decode_tps, "step_ms": step_ms,
            "requests": [r[1] for r in results], "reference": reference, "profile": profiled}


# The JAX package's throughput stack (int4 weights, int8 cache, fused
# decode) at llama2-7b's full width and depth: serve's five prompts and one
# greedy 1500-token prompt, which max_prefill_len=512 runs as 3 chunks,
# streamed for its time to first token.
INT4_PARAMS = {"config": "llama2-7b", "quantize": "int4", "kv_cache_dtype": "int8", "decode_attn_impl": "fused",
               "chunk_attn_impl": "flash", "max_batch": 8, "max_seq_len": 2048, "max_prefill_len": 512}
INT4_PROMPTS = PROMPTS + [(_long_text(1499, 5), 32, 0.0, True)]


def serve_int4_phase(card: str, profile_steps: bool = False):
    """int4 weights through serve.main: every projection and the lm_head
    of every forward (single-shot prefill, chunk or decode step) launch
    the int4 matmul once; the served greedy tokens are held against a
    single-shot forward on the same int4 weights."""
    import torch

    from substratus_tpu_torch.ops.decode_attention import decode_attention
    from substratus_tpu_torch.ops.flash_attention import flash_attention, flash_cached_attention
    from substratus_tpu_torch.ops.fused_decode import fused_decode_attention
    from substratus_tpu_torch.ops.quant import is_quantized
    from substratus_tpu_torch.ops.quant4 import q4_matmul

    gc.collect()  # the earlier phases' servers and caches
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    server, engine, base = start_server("serve-int4", INT4_PARAMS)
    params = engine.params
    nbytes = {"weights": sum(t.numel() * t.element_size() for t in params.state_dict().values()
                             if isinstance(t, torch.Tensor)),
              "cache": sum(t.numel() * t.element_size() for t in engine.cache.values()),
              "allocated": torch.cuda.memory_allocated(), "peak_while_building": torch.cuda.max_memory_allocated()}
    print(f"serve-int4: bytes on the card after quantization: {nbytes['weights']} of weights (int4 projections "
          f"and lm_head, bf16 tok_embed and norms), {nbytes['cache']} of int8 cache, {nbytes['allocated']} "
          f"allocated in all; peak {nbytes['peak_while_building']} while the bf16 weights were quantized",
          flush=True)
    if not is_quantized(params.layers[0].wq) or not is_quantized(params.lm_head):
        fail("serve-int4: the weights were not quantized")
    counters = {"q4_matmul": q4_matmul, "flash_fwd": flash_attention, "flash_cached": flash_cached_attention,
                "fused_decode": fused_decode_attention, "decode_attn": decode_attention}
    requests = tee_requests(engine)
    try:
        zero_counts(engine, counters.values())
        results, wall = run_concurrent(base, INT4_PROMPTS)
        wait_idle(engine)
        launches = {name: c.launches for name, c in counters.items()}
        stats = dict(engine.stats)
    finally:
        server.stop()
    generated = check_usage(INT4_PROMPTS, results)
    del engine.submit
    L = engine.cfg.n_layers
    forwards = stats["prefills"] + stats["prefill_chunks"] + stats["decode_steps"]
    want = {"q4_matmul": (7 * L + 1) * forwards, "flash_fwd": L * stats["prefills"],
            "flash_cached": L * stats["prefill_chunks"], "fused_decode": L * stats["decode_steps"], "decode_attn": 0}
    chunk = INT4_PARAMS["max_prefill_len"]
    lengths = [len(text.encode()) + 1 for text, *_ in INT4_PROMPTS]
    chunks = sum(-(-n // chunk) for n in lengths if n > chunk)
    singles = sum(n <= chunk for n in lengths)
    if launches != want or (stats["prefill_chunks"], stats["prefills"]) != (chunks, singles):
        fail(f"serve-int4: launches {launches} against {want}; stats {stats}, want {chunks} chunks "
             f"and {singles} single-shot prefills")
    if not all(launches[name] > 0 for name in ("q4_matmul", "flash_fwd", "flash_cached", "fused_decode")):
        fail(f"serve-int4: a kernel of the path never launched: {launches}")
    reference = long_reference_check(engine, [r for r in requests if r.temperature == 0.0], "serve-int4")
    profiled = profile_engine(engine, "profile-int4", (16, 1500)) if profile_steps else None
    ttft = results[-1][2]
    step_ms = 1e3 * stats["decode_seconds"] / stats["decode_steps"]
    decode_tps = (generated - len(INT4_PROMPTS)) / stats["decode_seconds"]
    prefill_ms = 1e3 * stats["prefill_seconds"] / len(INT4_PROMPTS)
    print(f"serve-int4: {len(INT4_PROMPTS)} concurrent requests, {generated} tokens in {wall:.2f} s; "
          f"{stats['prefills']} single-shot prefills, {stats['prefill_chunks']} prefill chunks, "
          f"{stats['decode_steps']} decode steps; launches {launches}", flush=True)
    print(f"serve-int4 [{card}]: mean prefill (engine) {prefill_ms:.1f} ms, decode {decode_tps:.1f} tokens/s, "
          f"mean step {step_ms:.2f} ms, TTFT of the 1500-token request {ttft * 1e3:.1f} ms (client, streamed)",
          flush=True)
    return {"launches": launches, "stats": stats, "bytes": nbytes, "wall_s": wall, "generated": generated,
            "prefill_ms": prefill_ms, "decode_tokens_per_s": decode_tps, "step_ms": step_ms,
            "ttft_1500_ms": ttft * 1e3, "requests": [r[1] for r in results], "reference": reference,
            "profile": profiled}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="card,build,kernels,serve,serve-long,serve-int4")
    phases = ap.parse_args().phases.split(",")

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs the card")
    try:
        from substratus_tpu_torch import kernels
    except ImportError as e:
        fail(f"the port is not importable here: {e}")

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}", flush=True)
    report = {"card": card, "kind": kind}
    if "build" in phases:
        t0 = time.perf_counter()
        kernels.library()
        print(f"build: {time.perf_counter() - t0:.1f} s (nvcc {kernels.build_seconds} s)", flush=True)
    if "kernels" in phases:
        report["kernels"] = kernel_phase()
    if "serve" in phases:
        report["serve"] = serve_phase(card, profile_steps="profile" in phases)
    if "serve-long" in phases:
        report["serve-long"] = serve_long_phase(card, profile_steps="profile" in phases)
    if "serve-int4" in phases:
        report["serve-int4"] = serve_int4_phase(card, profile_steps="profile" in phases)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    if "kernels" in phases:
        sources = {"flash_fwd": ("substratus_tpu_torch/csrc/flash_fwd.cu",
                                 "substratus_tpu/ops/flash_attention.py:91"),
                   "decode_attn": ("substratus_tpu_torch/csrc/decode_attn.cu",
                                   "substratus_tpu/ops/decode_attention.py:138"),
                   "flash_cached": ("substratus_tpu_torch/csrc/flash_cached.cu",
                                    "substratus_tpu/ops/flash_attention.py:452"),
                   "fused_decode": ("substratus_tpu_torch/csrc/fused_decode.cu",
                                    "substratus_tpu/ops/fused_decode.py:48"),
                   "q4_matmul": ("substratus_tpu_torch/csrc/q4_matmul.cu", "substratus_tpu/ops/quant4.py:168")}
        # Each kernel's launches come from the serve phase whose path runs it.
        phase_of = {"flash_fwd": "serve", "decode_attn": "serve",
                    "flash_cached": "serve-long", "fused_decode": "serve-long", "q4_matmul": "serve-int4"}
        line = []
        for name, cases in report["kernels"].items():
            main_case = cases[0]  # the serving path's shape
            line.append({
                "name": name, "route": "cuda", "source": sources[name][0], "replaces": sources[name][1],
                "launches": report.get(phase_of[name], {}).get("launches", {}).get(name, 0),
                "max_abs_err": main_case["max_abs_err"], "ms": main_case["ms"],
                "plain_ms": main_case["plain_ms"], "bound_ms": main_case["bound_ms"],
                "bound_by": main_case["bound_by"], "library_ms": main_case["library_ms"],
            })
        print(card, flush=True)
        print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
