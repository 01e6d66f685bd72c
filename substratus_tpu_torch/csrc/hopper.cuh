// Hopper (sm_90a) building blocks of the port's wgmma kernels
// (q4_matmul_wgmma.cu, flash_bwd_wgmma.cu, flash_fwd_wgmma.cu), of
// decode_split.cu and of q4_matmul_decode.cu: mbarriers, TMA tile loads
// with tensor maps encoded on the host by the CUDA driver, 1-D bulk copies
// that need no map, cp.async tracked by an mbarrier, the int4
// dequantization into A registers, wgmma's shared-memory descriptors and
// products, setmaxnreg, and the flash kernels' operand descriptors,
// fragment conversions, stores and block order.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the function comes from the driver at run time)

#include "mma.cuh"

namespace substratus {

// --- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// --- thread-block clusters --------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The cluster barrier in two halves: every thread of every block of the
// cluster arrives (without ordering memory), and waits before it first
// touches another block's shared memory (or exits) until all have arrived.
// (Not .aligned: a warp may reach them diverged.)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory"); }

// The address of `addr` (this block's shared memory) in the shared memory
// of the cluster's block `rank`.
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// Two floats into another block's shared memory (addresses from
// cluster_map), counted as 8 bytes on that block's barrier `bar`.
__device__ __forceinline__ void st_async_f2(uint32_t addr, float x, float y, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n"
               ::"r"(addr), "f"(x), "f"(y), "r"(bar)
               : "memory");
}

// mbar_wait for a phase completed by other blocks of the cluster (their
// st.async bytes): acquire at cluster scope.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// --- TMA ------------------------------------------------------------------

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// TMA's 1-D form: `bytes` contiguous bytes from global memory into shared
// memory, completing on the barrier; no tensor map. Both addresses and the
// size are multiples of 16 bytes.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// 4-byte cp.async into shared memory; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// One arrival on the barrier once this thread's earlier cp.asyncs have
// landed (counted among the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// --- setmaxnreg: the producer warpgroup gives registers to the consumers ----

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// --- int4 weights as a register A operand (q4_matmul_wgmma.cu,
// q4_matmul_decode.cu) --------------------------------------------------------
//
// Packed int4 bytes [64 rows, 128 columns] (a group of 128 K rows: row r
// holds K rows r and r + 64 as its low and high nibbles) lie in shared
// memory as TMA writes a [64, 128] box with the 128-byte swizzle. Read as
// 16-bit pairs of columns with ldmatrix.trans, a thread receives bytes
// (k, 2c), (k, 2c + 1), (k + 1, 2c), (k + 1, 2c + 1) -- exactly its
// m16n8k16 A fragment when A row c is mapped to column 2c and row c + 8 to
// column 2c + 1 -- and dequant_reg turns them into bf16 A registers.

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// (t & mask) ^ magic in one instruction (the compiler splits it into two
// when both constants are immediates).
__device__ __forceinline__ float and_xor(uint32_t t, uint32_t mask, uint32_t magic) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n" : "=r"(d) : "r"(t), "r"(mask), "r"(magic));
  return __uint_as_float(d);
}

// One register of ldmatrix.trans output, bytes (k, c0), (k, c1), (k + 1,
// c0), (k + 1, c1), into four A registers: the low nibbles (K rows k,
// k + 1 of the group) and the high nibbles (rows k + 64, k + 65) of column
// c0 (lo0, hi0) and of column c1 (lo1, hi1), each a bf16 pair. A nibble u
// in bits [b, b + 4) of a word, b <= 12, masked, xor-ed with 8 << b and
// or-ed into 0x4B000000, is the float 2^23 + 2^b (u ^ 8) exactly; one
// subtraction gives 2^b q for the sign-extended q, and times s 2^-b (sc,
// exact for scales above 2^-114) gives f32(q * s) exactly. Bytes 2 and 3
// are shifted down to the bit positions of bytes 0 and 1.
__device__ __forceinline__ void dequant_reg(uint32_t w, const float (&sc)[4], uint32_t& lo0, uint32_t& lo1,
                                            uint32_t& hi0, uint32_t& hi1) {
  float lo[4], hi[4];  // by byte: (k, c0), (k, c1), (k + 1, c0), (k + 1, c1)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t t = i ? w >> 16 : w;
    lo[2 * i] = (and_xor(t, 0xFu, 0x4B000008u) - 8388616.f) * sc[0];         // 2^23 + 8
    hi[2 * i] = (and_xor(t, 0xF0u, 0x4B000080u) - 8388736.f) * sc[1];        // 2^23 + 2^7
    lo[2 * i + 1] = (and_xor(t, 0xF00u, 0x4B000800u) - 8390656.f) * sc[2];   // 2^23 + 2^11
    hi[2 * i + 1] = (and_xor(t, 0xF000u, 0x4B008000u) - 8421376.f) * sc[3];  // 2^23 + 2^15
  }
  lo0 = pack_bf16(lo[0], lo[2]);
  lo1 = pack_bf16(lo[1], lo[3]);
  hi0 = pack_bf16(hi[0], hi[2]);
  hi1 = pack_bf16(hi[1], hi[3]);
}

// --- wgmma ------------------------------------------------------------------

// A wgmma shared-memory descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets, each in 16-byte units. For a
// K-major operand (rows of 64 bf16 along K, as TMA writes a [rows, 64]
// box) the stride offset is 1024 (eight rows, one swizzle atom) and the
// leading offset is unused; a k16 step adds 32 bytes to the start. For an
// MN-major operand (the same box read with its rows as K) the leading
// offset is the distance between 64-column boxes along MN and the stride
// offset 1024 (eight K rows); a k16 step adds 16 rows (2048 bytes).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 | (uint64_t)(sbo >> 4) << 32 |
         (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The compiler must not move registers that a wgmma in flight reads or
// writes.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[j][i])::"memory");
}

// wgmma_rs: d[64 x N] (+)= A[64 x 16] * B[16 x N], bf16 in, f32
// accumulators (N / 2 a thread). A in registers: warp w holds rows
// 16 w.. as the m16n8k16 A fragment, which is also the layout of an m64
// accumulator's columns 16 k.. (a[0] = pack(d[8k], d[8k+1]), a[1] =
// pack(d[8k+2], d[8k+3]), a[2] = pack(d[8k+4], d[8k+5]), a[3] = pack(d[8k+6],
// d[8k+7])). B in shared memory (descriptor b): K-major, or MN-major when
// TransB. d is overwritten when scale_d is 0. Accumulator i of a thread
// (warp w, lane l) is row 16 w + l / 4 + 8 ((i / 2) % 2), column
// 8 (i / 4) + 2 (l % 4) + i % 2.
template <int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TransB));
}

template <int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TransB));
}

template <int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TransB));
}

// d[64 x N] += A[64 x 16] * B[16 x N] in the accumulators of wgmma_rs
// (scale_d = 1, B K-major).
template <int R>
__device__ __forceinline__ void wgmma(float (&d)[R], const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs<0>(d, a, b, 1);
}

// wgmma_ss: d[64 x 64] (+)= A[64 x 16] * B[16 x 64], both in shared
// memory (descriptors a and b, both K-major); d is overwritten when
// scale_d is 0.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// wgmma_ss with N = 128: d[64 x 128] (+)= A[64 x 16] * B[16 x 128].
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// --- the flash kernels' operands (flash_bwd_wgmma.cu, flash_fwd_wgmma.cu) ---
//
// Every bf16 operand lies in shared memory as TMA writes it: boxes of
// [rows, 64] columns (128-byte rows, the 128-byte swizzle), one box per 64
// columns of D, each box 1024-byte aligned.

constexpr int WG = 128;     // threads of a warpgroup
constexpr int ROW = 128;    // bytes of a box row: 64 bf16 columns
constexpr int KSTEP = 16 * ROW;  // 16 rows: one k16 step of an MN-major operand
constexpr float LOG2E = 1.4426950408889634f;

// K-major descriptor of k16 step j of a [rows, D] operand stored as boxes
// of `box` bytes ([rows, 64] each) from `addr`.
__device__ __forceinline__ uint64_t kmajor(uint32_t addr, int box, int j) {
  return smem_desc(addr + (j / 4) * box + (j % 4) * 32, 16, 1024);
}

// MN-major descriptor of k16 step kk of a [rows, D] operand read with its
// rows as K (N = D across its boxes of `box` bytes).
__device__ __forceinline__ uint64_t mnmajor(uint32_t addr, int box, int kk) {
  return smem_desc(addr + kk * KSTEP, box, 1024);
}

// The A fragments (k16 steps over N columns) of an m64nN accumulator
// rounded to bf16.
template <int R>
__device__ __forceinline__ void to_a(uint32_t (&a)[R / 8][4], const float (&x)[R]) {
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// Rows row0 and row0 + 8 of a [*, stride] bf16 matrix from an m64nD
// accumulator (columns 8 j + 2 t, + 1); rows at or past n are not written.
template <int D>
__device__ __forceinline__ void store_acc(__nv_bfloat16* base, size_t stride, int row0, int n,
                                          const float (&acc)[D / 2], int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n) continue;
    __nv_bfloat16* out = base + (size_t)row * stride + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// The block's tile rank (0 = heaviest under causal masking) and head, for a
// one-dimensional grid of n_tiles blocks per head. Heads go in chunks of
// `chunk`, and within a chunk every head's rank 0, then every head's rank
// 1, ...: the blocks in flight share a few heads' streamed tiles in L2, and
// each chunk starts with its heaviest blocks.
__device__ __forceinline__ void block_work(int n_tiles, int chunk, int& rank, int& head) {
  const int n_heads = gridDim.x / n_tiles;
  const int c0 = blockIdx.x / (chunk * n_tiles) * chunk;  // the chunk's first head
  const int heads = min(chunk, n_heads - c0);
  const int r = blockIdx.x - c0 * n_tiles;
  rank = r / heads;
  head = c0 + r % heads;
}

// Heads per chunk of block_work: about one wave of blocks (one block an
// SM).
inline int head_chunk(int tiles) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms / tiles > 1 ? sms / tiles : 1;
}

// --- tensor maps (host) --------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (the library
// is not linked against libcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status) == cudaSuccess &&
        status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D row-major map: dims {inner, outer}, row stride in bytes, box {bi, bo}.
inline bool make_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, uint64_t inner, uint64_t outer,
                     uint64_t row_bytes, uint32_t bi, uint32_t bo, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {bi, bo};
  const cuuint32_t elem[2] = {1, 1};
  return encode_tiled()(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 4-D bf16 map with the 128-byte swizzle over the contiguous tensor
// dims[3] x dims[2] x dims[1] x dims[0] (dims[0] = D innermost).
inline bool make_bf16_map(CUtensorMap* map, const void* ptr, const cuuint64_t (&dims)[4], const cuuint32_t (&box)[4]) {
  const cuuint64_t strides[3] = {dims[0] * 2, dims[1] * dims[0] * 2, dims[2] * dims[1] * dims[0] * 2};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A map over a contiguous bf16 [B, S, H, D] tensor as the 4-D (D, H, S, B),
// box {64, 1, rows, 1}: one [rows, 64] slab of one head, exactly a K-major
// wgmma operand (or an MN-major one read with its rows as K). Rows past S
// read as zero.
inline bool make_head_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int D, int rows) {
  return make_bf16_map(map, ptr, {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B},
                       {64, 1, (cuuint32_t)rows, 1});
}

// The same over the slot-cache layout [B, KH, S, D] as (D, S, KH, B), box
// {64, rows, 1, 1}.
inline bool make_cache_map(CUtensorMap* map, const void* ptr, int B, int KH, int S, int D, int rows) {
  return make_bf16_map(map, ptr, {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)KH, (cuuint64_t)B},
                       {64, (cuuint32_t)rows, 1, 1});
}

// An int8 slot cache [B, KH, S, D] as (D, S, KH, B), box {D, rows, 1, 1}
// with no swizzle: `rows` dense rows of D bytes. Rows past S read as zero.
inline bool make_int8_cache_map(CUtensorMap* map, const void* ptr, int B, int KH, int S, int D, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)KH, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D, (cuuint64_t)S * D, (cuuint64_t)KH * S * D};
  const cuuint32_t box[4] = {(cuuint32_t)D, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace substratus
