// Per-token int8 activation quantization for the w8a8 product (sm_90a):
// for each row of x [M, C] (bf16), ascale = amax == 0 ? 1 : amax / 127 in
// f32 and xq = clamp(round_half_even(x / ascale), -127, 127) as int8.
//
// Replaces no TPU kernel: the JAX package computes this with XLA ops
// inside qeinsum_w8a8 (substratus_tpu/ops/quant.py:142-146), ahead of its
// s8 x s8 -> s32 einsum. The port gives it a kernel of its own because
// w8a8_matmul.cu takes int8 rows and their scales, and a chain of PyTorch
// ops (abs, amax, where, divide, round, clamp, cast) would be seven
// launches and four round trips of the activation through device memory.
//
// Numerics are the JAX formula's bit for bit: the absmax in f32 (exact,
// any order), the scale by IEEE division (__fdiv_rn: never a multiply by
// the reciprocal 1/127, which is an ulp off at times), the quotient x /
// ascale by IEEE division, __float2int_rn (round half to even, as
// jnp.round and torch.round), then the clamp.
//
// Row-parallel mode (a tensor-parallel gang's w_down, whose x is sharded
// over its contracting dim): the per-token amax is a max over the WHOLE
// row, as GSPMD computes qeinsum_w8a8 on a sharded x, so the kernel runs in
// two halves around the gang's all-reduce(MAX): mode 1 writes each row's
// amax of this rank's slice and nothing else; mode 2 takes the global amax
// a row, derives the scale as mode 0 does and quantizes the slice with it.
//
// Design: one block of 256 threads a row. Pass 1 reads the row in 16-byte
// vectors (8 bf16) and reduces |x| over the block (row_amax); pass 2 reads the row again
// (from L1/L2: a row is 8-22 KB) and writes 8 int8 values a store. Bound
// on an H100 (3.35 TB/s): bytes, 3 bytes a value (2 in, 1 out) plus 4 a
// row; at a decode step's 8 rows there are only 8 blocks, so a launch is
// latency-bound (a few microseconds), far from that bound.
#include "common.cuh"

namespace substratus {
namespace {

constexpr int QT = 256;  // threads a row

// The largest |x| of a row, over the block (warp shuffles, then the eight
// warps' maxima through shared memory).
__device__ __forceinline__ float row_amax(const __nv_bfloat16* __restrict__ xr, int C) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float amax = 0.f;
  for (int c = threadIdx.x * 8; c < C; c += QT * 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + c);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  __shared__ float part[QT / 32];
  if (lane == 0) part[warp] = amax;
  __syncthreads();
  amax = part[0];
#pragma unroll
  for (int w = 1; w < QT / 32; ++w) amax = fmaxf(amax, part[w]);
  return amax;
}

// MODE 0: amax, scale and values; 1: the row's amax into `amax_io` only; 2:
// the scale and values from the given `amax_io`.
template <int MODE>
__global__ void __launch_bounds__(QT) w8a8_quantize_kernel(const __nv_bfloat16* __restrict__ x, int ldx,
                                                          int8_t* __restrict__ xq, float* __restrict__ amax_io,
                                                          float* __restrict__ ascale, int C) {
  const size_t row = blockIdx.x;
  const __nv_bfloat16* xr = x + row * (size_t)ldx;
  const float amax = MODE == 2 ? amax_io[row] : row_amax(xr, C);
  if (MODE == 1) {
    if (threadIdx.x == 0) amax_io[row] = amax;
    return;
  }
  int8_t* qr = xq + row * (size_t)C;
  const float scale = amax == 0.f ? 1.f : __fdiv_rn(amax, 127.f);
  if (threadIdx.x == 0) ascale[row] = scale;

  for (int c = threadIdx.x * 8; c < C; c += QT * 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + c);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      const int q0 = max(-127, min(127, __float2int_rn(__fdiv_rn(f.x, scale))));
      const int q1 = max(-127, min(127, __float2int_rn(__fdiv_rn(f.y, scale))));
      packed[j / 2] |= ((uint32_t)(q0 & 0xff) | ((uint32_t)(q1 & 0xff) << 8)) << (16 * (j % 2));
    }
    *reinterpret_cast<uint2*>(qr + c) = make_uint2(packed[0], packed[1]);
  }
}

}  // namespace
}  // namespace substratus

// x [M, C] bf16 with row stride ldx (elements). mode 0: xq [M, C] int8 and
// ascale [M] f32, both contiguous (amax unused: pass null); mode 1 writes
// amax [M] f32 only; mode 2 reads amax [M] and writes xq and ascale. C and
// ldx multiples of 8, x 16-byte aligned, xq 8-byte aligned.
extern "C" int w8a8_quantize(const void* x, int ldx, void* xq, void* amax, void* ascale, int M, int C, int mode,
                             void* stream) {
  using namespace substratus;
  if (M < 1 || C < 8 || C % 8 != 0 || ldx < C || ldx % 8 != 0 || mode < 0 || mode > 2) return -1;
  if ((mode != 0 && amax == nullptr) || (mode != 1 && (xq == nullptr || ascale == nullptr))) return -1;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(xq) % 8 != 0) return -1;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* q = static_cast<int8_t*>(xq);
  auto* a = static_cast<float*>(amax);
  auto* sc = static_cast<float*>(ascale);
  const auto s = static_cast<cudaStream_t>(stream);
  if (mode == 0) w8a8_quantize_kernel<0><<<M, QT, 0, s>>>(xb, ldx, q, a, sc, C);
  else if (mode == 1) w8a8_quantize_kernel<1><<<M, QT, 0, s>>>(xb, ldx, q, a, sc, C);
  else w8a8_quantize_kernel<2><<<M, QT, 0, s>>>(xb, ldx, q, a, sc, C);
  return (int)cudaGetLastError();
}
