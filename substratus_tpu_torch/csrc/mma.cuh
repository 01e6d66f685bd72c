// Tensor-core building blocks shared by the flash kernels (flash_fwd.cu,
// flash_cached.cu, flash_bwd.cu): ldmatrix fragment loads from shared
// memory, the mma.sync m16n8k16 bf16 product with f32 accumulation, bf16
// packing, and the padded-tile loader.
#pragma once

#include "common.cuh"

namespace substratus {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16x16, row-major) * b (16x8, column-major), bf16 in, f32 out.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [s0, s0 + ROWS) of a [*, stride]-strided bf16 matrix into a
// shared tile whose rows are padded by 8 elements (16 bytes, so ldmatrix
// reads are free of bank conflicts), 16 bytes per thread per step with NT
// threads; rows past `n` read 0.
template <int ROWS, int D, int NT>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          size_t stride, int s0, int n) {
  constexpr int CHUNKS = D / 8;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += NT) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (s0 + r < n) v = *reinterpret_cast<const uint4*>(src + (size_t)(s0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = v;
  }
}

}  // namespace substratus
