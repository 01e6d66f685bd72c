// The w8a8 product for Hopper (sm_90a): out[M, N] = (xq @ W) scaled, with
// xq [M, C] int8 activations (per-row f32 scales ascale), W [C, N] int8
// weights (per-column f32 scales wscale), the sum exact in s32 on the
// tensor cores (mma.sync m16n8k32 s8 x s8 -> s32), and the epilogue
// bf16((float(sum) * ascale[m]) * wscale[n]), the JAX formula's order.
// With `raw` it writes the s32 sums instead (the card check compares them
// bit for bit with an exact plain product).
//
// Replaces no TPU kernel: the JAX package runs this product as XLA's
// einsum with preferred_element_type=int32 (substratus_tpu/ops/quant.py:147
// in qeinsum_w8a8), which the TPU's MXU takes natively. PyTorch has no
// route on this card: CUDA has no integer torch.matmul, torch._int_mm
// (cuBLASLt) refuses M <= 16, and a bf16 product is not w8a8.
//
// Layouts are the model's as they lie: W is QTensor.q in the JAX layout,
// [C, N] with N contiguous (wq [D, H, hd] flattened), no second K-major
// copy. s8 mma wants K contiguous in both operands, so each weight tile is
// transposed in registers: a thread reads four 4-byte words (four K rows,
// four neighbouring columns) and eight byte permutes turn them into four
// B fragments of four K values each, one for each of four n8 tiles. The
// mma's logical column g of n8 tile i is physical column 4g + i of the
// block's 32, so a thread's accumulators for a row are physical columns
// 8t..8t+7: one 16-byte store each in the epilogue. Rows of x are read as
// they lie with a row stride (lda), so an expert's slice of a [B, S, E, M]
// activation needs no copy; the output likewise (ldo).
//
// Design: a block of four warps owns BN = 32 output columns and BM = 16
// rows (M <= 16, a decode step; MT = 1) or 64 rows (MT = 4, each warp
// reusing its B fragments over four m16 tiles). C streams through a ring
// of cp.async stages of BK = 128 K rows ([128, 32] weight bytes, [BM,
// 128] x bytes); each warp takes one k32 slice of every stage, and the
// four warps' s32 partial sums meet in shared memory at the end (integer
// sums: exact, in any order). Shared layouts avoid bank conflicts: within
// each 16-row group of the weight stage, row 4t + j sits at slot 4j + t
// (the 32 words a warp reads then lie in 32 banks); x rows are padded to
// 144 bytes. Ragged M, N (a multiple of 16) and C (a multiple of 16) are
// zero-filled and not stored.
//
// Bound on an H100 (SXM, 3.35 TB/s, 1,979 TOP/s dense int8): at a decode
// step (M = 8) the weight bytes, 45.1 MB for w_gate [4096, 11008] (13.5
// us). The grid is ceil(M / BM) x N / 32 blocks (128 at N = 4096), each
// streaming its columns' C x 32 bytes through an 8-deep ring. At M = 512
// the operations bound it (46.2 GOP for w_gate, 23 us); mma.sync with the
// byte permutes and the per-warp fragment loads runs well below the
// tensor cores' rate there (wgmma with a TMA ring is the later design).
#include "common.cuh"
#include "mma.cuh"

namespace substratus {
namespace {

constexpr int W_NT = 128;  // four warps, one k32 slice of each stage apiece
constexpr int W_BN = 32;   // output columns a block: four n8 tiles
constexpr int W_BK = 128;  // K rows a stage
constexpr int W_LDA = W_BK + 16;  // bytes of an x row in shared memory

template <int MT>
struct W8Smem {
  static constexpr int BM = 16 * MT;
  static constexpr int STAGES = MT == 1 ? 8 : 4;
  static constexpr size_t w_bytes = W_BK * W_BN;
  static constexpr size_t a_bytes = BM * W_LDA;
  static constexpr size_t stage = w_bytes + a_bytes;
  static constexpr size_t red = 4 * BM * W_BN * sizeof(int32_t);
  static constexpr size_t total = STAGES * stage > red ? STAGES * stage : red;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit16() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait16() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c += a (16x32, row-major s8) * b (32x8, column-major s8), s32 sums.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four words r[0..3] hold K rows k..k+3, each the bytes of four columns;
// out[i] holds column i's four K values, row k in the low byte.
__device__ __forceinline__ void transpose4(const uint32_t (&r)[4], uint32_t (&out)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140), t3 = __byte_perm(r[2], r[3], 0x7362);
  out[0] = __byte_perm(t0, t2, 0x5410);
  out[1] = __byte_perm(t0, t2, 0x7632);
  out[2] = __byte_perm(t1, t3, 0x5410);
  out[3] = __byte_perm(t1, t3, 0x7632);
}

template <int MT>
__global__ void __launch_bounds__(W_NT) w8a8_matmul_kernel(
    const int8_t* __restrict__ xq, int lda, const float* __restrict__ ascale, int as_stride,
    const int8_t* __restrict__ w, const float* __restrict__ wscale, void* __restrict__ out, int ldo,
    int raw, int M, int N, int C) {
  using S = W8Smem<MT>;
  constexpr int BM = S::BM, STAGES = S::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * W_BN;
  const int niter = (C + W_BK - 1) / W_BK;

  auto load_stage = [&](int slot, int it) {
    unsigned char* ws = smem_raw + slot * S::stage;
    unsigned char* as = ws + S::w_bytes;
    const int k0 = it * W_BK;
#pragma unroll
    for (int i = tid; i < W_BK * 2; i += W_NT) {  // weight rows, two 16-byte chunks each
      const int r = i / 2, c = i % 2;
      const bool ok = k0 + r < C && n0 + 16 * c < N;
      const int slotrow = (r & ~15) | ((r & 3) << 2) | ((r >> 2) & 3);
      cp_async16(ws + slotrow * W_BN + 16 * c, ok ? w + (size_t)(k0 + r) * N + n0 + 16 * c : w, ok);
    }
#pragma unroll
    for (int i = tid; i < BM * (W_BK / 16); i += W_NT) {  // x rows, eight 16-byte chunks each
      const int r = i / (W_BK / 16), c = i % (W_BK / 16);
      const bool ok = m0 + r < M && k0 + 16 * c < C;
      cp_async16(as + r * W_LDA + 16 * c, ok ? xq + (size_t)(m0 + r) * lda + k0 + 16 * c : xq, ok);
    }
  };

  int acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[mt][i][0] = acc[mt][i][1] = acc[mt][i][2] = acc[mt][i][3] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < niter) load_stage(s, s);
    cp_async_commit16();
  }

  for (int it = 0; it < niter; ++it) {
    cp_async_wait16<STAGES - 2>();
    __syncthreads();  // stage `it` landed; every warp is done with stage it - 1's slot
    const int next = it + STAGES - 1;
    if (next < niter) load_stage(next % STAGES, next);
    cp_async_commit16();

    const unsigned char* ws = smem_raw + (it % STAGES) * S::stage + warp * 32 * W_BN;
    const unsigned char* as = smem_raw + (it % STAGES) * S::stage + S::w_bytes + warp * 32;
    uint32_t lo[4], hi[4], b0[4], b1[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // K rows 4t + j and 16 + 4t + j of the slice, at their slots
      lo[j] = *reinterpret_cast<const uint32_t*>(ws + (4 * j + t) * W_BN + 4 * g);
      hi[j] = *reinterpret_cast<const uint32_t*>(ws + (16 + 4 * j + t) * W_BN + 4 * g);
    }
    transpose4(lo, b0);
    transpose4(hi, b1);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const unsigned char* ar = as + (mt * 16 + g) * W_LDA + 4 * t;
      const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(ar),
                             *reinterpret_cast<const uint32_t*>(ar + 8 * W_LDA),
                             *reinterpret_cast<const uint32_t*>(ar + 16),
                             *reinterpret_cast<const uint32_t*>(ar + 8 * W_LDA + 16)};
#pragma unroll
      for (int i = 0; i < 4; ++i) mma_s8(acc[mt][i], a, b0[i], b1[i]);
    }
  }
  cp_async_wait16<0>();
  __syncthreads();  // the ring is free: it becomes the four warps' partial sums

  // Thread (g, t) holds, for row g (+ 8), physical columns 8t + i (c0/c2 of
  // tile i) and 8t + 4 + i (c1/c3).
  int32_t* red = reinterpret_cast<int32_t*>(smem_raw);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int32_t* dst = red + ((size_t)warp * BM + mt * 16 + g + 8 * h) * W_BN + 8 * t;
      *reinterpret_cast<int4*>(dst) = make_int4(acc[mt][0][2 * h], acc[mt][1][2 * h], acc[mt][2][2 * h],
                                                acc[mt][3][2 * h]);
      *reinterpret_cast<int4*>(dst + 4) = make_int4(acc[mt][0][2 * h + 1], acc[mt][1][2 * h + 1],
                                                    acc[mt][2][2 * h + 1], acc[mt][3][2 * h + 1]);
    }
  }
  __syncthreads();

  for (int idx = tid; idx < BM * (W_BN / 8); idx += W_NT) {
    const int r = idx / (W_BN / 8), cc = idx % (W_BN / 8);
    const int row = m0 + r, col = n0 + 8 * cc;
    if (row >= M || col >= N) continue;
    int s[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int wp = 0; wp < 4; ++wp) {
      const int32_t* src = red + ((size_t)wp * BM + r) * W_BN + 8 * cc;
      const int4 u = *reinterpret_cast<const int4*>(src), v = *reinterpret_cast<const int4*>(src + 4);
      s[0] += u.x, s[1] += u.y, s[2] += u.z, s[3] += u.w;
      s[4] += v.x, s[5] += v.y, s[6] += v.z, s[7] += v.w;
    }
    if (raw) {
      int32_t* o = static_cast<int32_t*>(out) + (size_t)row * ldo + col;
      *reinterpret_cast<int4*>(o) = make_int4(s[0], s[1], s[2], s[3]);
      *reinterpret_cast<int4*>(o + 4) = make_int4(s[4], s[5], s[6], s[7]);
      continue;
    }
    const float a = ascale[(size_t)row * as_stride];
    const float4 w0 = *reinterpret_cast<const float4*>(wscale + col);
    const float4 w1 = *reinterpret_cast<const float4*>(wscale + col + 4);
    const float ws8[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    uint32_t packed[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float lo_v = __fmul_rn(__fmul_rn(__int2float_rn(s[2 * j]), a), ws8[2 * j]);
      const float hi_v = __fmul_rn(__fmul_rn(__int2float_rn(s[2 * j + 1]), a), ws8[2 * j + 1]);
      const __nv_bfloat162 p = __halves2bfloat162(__float2bfloat16_rn(lo_v), __float2bfloat16_rn(hi_v));
      packed[j] = *reinterpret_cast<const uint32_t*>(&p);
    }
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + (size_t)row * ldo + col) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
}

template <int MT>
int launch_w8a8(const void* xq, int lda, const void* ascale, int as_stride, const void* w, const void* wscale,
                void* out, int ldo, int raw, int M, int N, int C, cudaStream_t stream) {
  constexpr size_t smem = W8Smem<MT>::total;
  auto kernel = w8a8_matmul_kernel<MT>;
  static bool configured = false;
  const cudaError_t err = allow_smem(kernel, smem, configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + 16 * MT - 1) / (16 * MT), (N + W_BN - 1) / W_BN);
  kernel<<<grid, W_NT, smem, stream>>>(static_cast<const int8_t*>(xq), lda, static_cast<const float*>(ascale),
                                       as_stride, static_cast<const int8_t*>(w),
                                       static_cast<const float*>(wscale), out, ldo, raw, M, N, C);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace substratus

// xq [M, C] int8 (row stride lda bytes), ascale [M] f32 (stride
// as_stride), w [C, N] int8 contiguous, wscale [N] f32 -> out [M, N] with
// row stride ldo: bf16, or the raw s32 sums when raw != 0. C, N, lda
// multiples of 16; ldo a multiple of 8; xq, w, wscale and out 16-byte
// aligned.
extern "C" int w8a8_matmul(const void* xq, int lda, const void* ascale, int as_stride, const void* w,
                           const void* wscale, void* out, int ldo, int raw, int M, int N, int C, void* stream) {
  using namespace substratus;
  if (M < 1 || N < 16 || N % 16 != 0 || C < 16 || C % 16 != 0 || lda < C || lda % 16 != 0) return -1;
  if (ldo < N || ldo % 8 != 0 || (N + W_BN - 1) / W_BN > 65535) return -1;
  const uintptr_t misaligned = reinterpret_cast<uintptr_t>(xq) | reinterpret_cast<uintptr_t>(w) |
                               reinterpret_cast<uintptr_t>(wscale) | reinterpret_cast<uintptr_t>(out);
  if (misaligned % 16 != 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 16) return launch_w8a8<1>(xq, lda, ascale, as_stride, w, wscale, out, ldo, raw, M, N, C, s);
  return launch_w8a8<4>(xq, lda, ascale, as_stride, w, wscale, out, ldo, raw, M, N, C, s);
}
