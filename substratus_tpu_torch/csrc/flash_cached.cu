// Cached flash attention for Hopper (sm_90a): a multi-token chunk of
// queries against the dense slot cache, with an online softmax, so the
// [Sq, Sk] score matrix never reaches device memory.
//
// Replaces the TPU kernel substratus_tpu/ops/flash_attention.py
// _cached_kernel (driven by _cached_impl / flash_cached_attention) at
// head_dim 16, 32 and 256 (ops/flash_attention.py::flash_cached_design;
// 129-255 on a cache laid out at 256); flash_fwd_wgmma.cu takes 64 and
// 128, and this kernel's 64 and 128 instances serve chip_smoke.py's
// side-by-side timing. At 256 the shared memory is 101,376 B and the
// registers spill as in flash_fwd.cu's instance at 256.
//
// Layout: q [B, Sq, H, D] bf16; k/v [B, KH, Sk, D] bf16, or int8 with f32
// scales [B, KH, Sk]; pos [B, Sq] int32 absolute positions of the queries;
// kv_len [B] int32 (optional); o [B, Sq, H, D] bf16. All contiguous. Query
// head h reads kv head h / (H / KH). Row r of batch b attends cache
// columns 0..limit, limit = min(pos[b, r], kv_len[b] - 1); a row whose
// limit is negative outputs exactly 0.
//
// Design. flash_fwd.cu's, changed where the TPU kernel differs from
// self-attention. One block of four warps per (q-tile of BQ=64 rows,
// b*h); each warp owns 16 query rows; the k axis is a loop over tiles of
// BK=64 cache rows staged through shared memory, with S = Q K^T and
// O += P V on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate) and P kept in registers.
// - Per-row limits come from `pos`, not from the row index. The block
//   loads its 64 limits into shared memory and loops only to the largest
//   of them (the TPU kernel's dead-block skip), masking each column past
//   its row's own limit. Rows past Sq get limit -1.
// - A row with every column masked keeps m = -1e30 and p = 0 (masked
//   scores are exactly -1e30 and give p = 0), so l = 0 and the epilogue
//   writes 0 with no NaN, as the TPU kernel's guard does.
// - int8 tiles convert to bf16 (exactly: |x| <= 127) on the way into
//   shared memory; there is no dequantized copy in device memory.
//   k_scale multiplies the score after the dot; v_scale multiplies p
//   after l has summed it and before P is rounded to bf16.
// - Ragged Sq and Sk: the last q- and k-tiles are masked, so any bucket
//   and any cache length work (no block fitting).
//
// Numerics follow _cached_kernel: s = (q . k) * scale in f32 (times
// k_scale); p = exp(s - m_new); l sums the f32 p; p (times v_scale) is
// rounded to bf16 before the PV product; out = acc / l (l == 0 -> 1).
//
// Bound on an H100 (SXM, 3.35 TB/s, 989 TFLOP/s bf16): at the fifth
// 512-token chunk of a long llama2-7b prompt (Sq=512, H=KH=32, D=128,
// positions 2048..2559) the products are about 19 GFLOP against about
// 42 MB of live k/v rows, so the bound is the operations (about 20 us).
// Like flash_fwd.cu this version loads tiles synchronously and uses
// mma.sync, not wgmma; each query head of a GQA group reads its kv tiles
// again (through L2).
#include "mma.cuh"

namespace substratus {
namespace {

constexpr int BQ = 64;  // query rows per block (16 per warp)
constexpr int BK = 64;  // cache rows per shared-memory tile
constexpr int NWARP = BQ / 16;
constexpr int NT = NWARP * 32;
constexpr int PAD = 8;  // bf16 elements of row padding (16 bytes)

template <int D>
constexpr size_t cached_smem_bytes() {
  return sizeof(__nv_bfloat16) * (BQ + 2 * BK) * (D + PAD);
}

// Copy rows [s0, s0 + ROWS) of a [*, stride]-strided matrix into a padded
// bf16 shared tile; rows past `n` read 0. bf16: 16 bytes per thread per
// step.
template <int ROWS, int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          size_t stride, int s0, int n) {
  constexpr int CHUNKS = D / 8;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += NT) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (s0 + r < n) v = *reinterpret_cast<const uint4*>(src + (size_t)(s0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * (D + PAD) + c) = v;
  }
}

// int8: 16 values (16 bytes) per thread per step, converted to bf16.
template <int ROWS, int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const int8_t* src, size_t stride,
                                          int s0, int n) {
  constexpr int CHUNKS = D / 16;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += NT) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 16;
    int4 raw = make_int4(0, 0, 0, 0);
    if (s0 + r < n) raw = *reinterpret_cast<const int4*>(src + (size_t)(s0 + r) * stride + c);
    const int8_t* x = reinterpret_cast<const int8_t*>(&raw);
    uint32_t w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j] = pack_bf16((float)x[2 * j], (float)x[2 * j + 1]);
    uint4* out = reinterpret_cast<uint4*>(dst + r * (D + PAD) + c);
    out[0] = make_uint4(w[0], w[1], w[2], w[3]);
    out[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

template <typename TC, int D>
__global__ void __launch_bounds__(NT) flash_cached_kernel(
    const __nv_bfloat16* __restrict__ q, const TC* __restrict__ k, const TC* __restrict__ v,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ pos, const int* __restrict__ kv_len, __nv_bfloat16* __restrict__ o,
    int Sq, int Sk, int H, int KH, float scale) {
  constexpr bool kQuant = sizeof(TC) == 1;
  constexpr int LD = D + PAD;
  constexpr int KSTEPS = D / 16;  // k-steps of the QK^T product
  constexpr int DT = D / 8;       // n8 tiles of the output
  constexpr int NTS = BK / 8;     // n8 tiles of the scores
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * LD;
  __nv_bfloat16* Vs = Ks + BK * LD;
  __shared__ int lim_s[BQ];
  __shared__ int lim_max;
  __shared__ float ks_s[BK];
  __shared__ float vs_s[BK];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KH);
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // accumulator row (and row + 8)
  const int t = lane % 4;  // accumulator column pair
  const int r0 = warp * 16 + g;  // this thread's two rows within the tile: r0, r0 + 8

  if (threadIdx.x == 0) lim_max = -1;
  __syncthreads();
  if (threadIdx.x < BQ) {
    const int row = q0 + threadIdx.x;
    int lim = -1;
    if (row < Sq) {
      lim = pos[(size_t)b * Sq + row];
      if (kv_len != nullptr) lim = min(lim, kv_len[b] - 1);
    }
    lim_s[threadIdx.x] = lim;
    atomicMax(&lim_max, lim);
  }

  const size_t q_stride = (size_t)H * D;
  const size_t head = (size_t)b * KH + kvh;
  const TC* kb = k + head * Sk * D;
  const TC* vb = v + head * Sk * D;
  load_rows<BQ, D>(Qs, q + ((size_t)b * Sq * H + h) * D, q_stride, q0, Sq);
  __syncthreads();
  const int lim0 = lim_s[r0];
  const int lim1 = lim_s[r0 + 8];
  // The dead-block skip: no row of this tile attends past lim_max.
  const int k_end = min(Sk, lim_max + 1);

  // Q fragments for the whole loop (layout as in flash_fwd.cu).
  uint32_t qf[KSTEPS][4];
  {
    const int m = lane / 8;
    const __nv_bfloat16* base = Qs + (warp * 16 + (m & 1) * 8 + lane % 8) * LD + (m >> 1) * 8;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) ldmatrix_x4(qf[ks], base + ks * 16);
  }

  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const unsigned full = 0xffffffffu;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // every warp is done with the previous tiles and scales
    load_rows<BK, D>(Ks, kb, D, k0, Sk);
    load_rows<BK, D>(Vs, vb, D, k0, Sk);
    if (kQuant && threadIdx.x < BK) {
      const int col = k0 + threadIdx.x;
      ks_s[threadIdx.x] = col < Sk ? k_scale[head * Sk + col] : 0.f;
      vs_s[threadIdx.x] = col < Sk ? v_scale[head * Sk + col] : 0.f;
    }
    __syncthreads();

    // S = Q K^T (fragment layout as in flash_fwd.cu).
    float s[NTS][4];
#pragma unroll
    for (int j = 0; j < NTS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    {
      const int m = lane / 8;
      const __nv_bfloat16* base = Ks + ((m >> 1) * 8 + lane % 8) * LD + (m & 1) * 8;
#pragma unroll
      for (int jp = 0; jp < NTS; jp += 2) {
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) {
          uint32_t kf[4];
          ldmatrix_x4(kf, base + jp * 8 * LD + ks * 16);
          mma_bf16(s[jp], qf[ks], kf[0], kf[1]);
          mma_bf16(s[jp + 1], qf[ks], kf[2], kf[3]);
        }
      }
    }

    // Scale (and k_scale), per-row limit mask, online-softmax update.
    float m_cur[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NTS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1);
        const int col = k0 + c;
        const bool live = col < Sk && col <= (e < 2 ? lim0 : lim1);
        float sv = s[j][e] * scale;
        if (kQuant) sv *= ks_s[c];
        s[j][e] = live ? sv : kNegInf;
        m_cur[e / 2] = fmaxf(m_cur[e / 2], s[j][e]);
      }
    }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_cur[r] = fmaxf(m_cur[r], __shfl_xor_sync(full, m_cur[r], 1));
      m_cur[r] = fmaxf(m_cur[r], __shfl_xor_sync(full, m_cur[r], 2));
      const float m_new = fmaxf(m_run[r], m_cur[r]);
      alpha[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NTS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[j][e] == kNegInf ? 0.f : expf(s[j][e] - m_run[e / 2]);
        psum[e / 2] += p;
        // v_scale folds into p after l has summed it.
        s[j][e] = kQuant ? p * vs_s[j * 8 + 2 * t + (e & 1)] : p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(full, psum[r], 1);
      psum[r] += __shfl_xor_sync(full, psum[r], 2);
      l_run[r] = alpha[r] * l_run[r] + psum[r];
    }
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }

    // O += P V, P (rounded to bf16) from the score registers (as in
    // flash_fwd.cu).
    {
      const int m = lane / 8;
      const __nv_bfloat16* base = Vs + ((m & 1) * 8 + lane % 8) * LD + (m >> 1) * 8;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < DT; dp += 2) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, base + kk * 16 * LD + dp * 8);
          mma_bf16(acc[dp], pa, vf[0], vf[1]);
          mma_bf16(acc[dp + 1], pa, vf[2], vf[3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    if (row >= Sq) continue;
    const float l_safe = l_run[r] == 0.f ? 1.f : l_run[r];
    __nv_bfloat16* ob = o + ((size_t)b * Sq + row) * q_stride + (size_t)h * D;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(ob + i * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[i][2 * r] / l_safe, acc[i][2 * r + 1] / l_safe);
    }
  }
}

template <typename TC, int D>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* pos, const void* kv_len, void* o, int B, int Sq, int Sk, int H, int KH,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = cached_smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_cached_kernel<TC, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_cached_kernel<TC, D><<<grid, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const TC*>(k),
      static_cast<const TC*>(v), static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(pos), static_cast<const int*>(kv_len),
      static_cast<__nv_bfloat16*>(o), Sq, Sk, H, KH, scale);
  return (int)cudaGetLastError();
}

template <typename TC>
int dispatch_d(int D, const void* q, const void* k, const void* v, const void* ks,
               const void* vs, const void* pos, const void* kv_len, void* o, int B, int Sq,
               int Sk, int H, int KH, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<TC, 16>(q, k, v, ks, vs, pos, kv_len, o, B, Sq, Sk, H, KH, scale, s);
    case 32: return launch<TC, 32>(q, k, v, ks, vs, pos, kv_len, o, B, Sq, Sk, H, KH, scale, s);
    case 64: return launch<TC, 64>(q, k, v, ks, vs, pos, kv_len, o, B, Sq, Sk, H, KH, scale, s);
    case 128: return launch<TC, 128>(q, k, v, ks, vs, pos, kv_len, o, B, Sq, Sk, H, KH, scale, s);
    case 256: return launch<TC, 256>(q, k, v, ks, vs, pos, kv_len, o, B, Sq, Sk, H, KH, scale, s);
    default: return -2;
  }
}

}  // namespace
}  // namespace substratus

extern "C" int flash_cached(const void* q, const void* k, const void* v, const void* k_scale,
                            const void* v_scale, const void* pos, const void* kv_len, void* o,
                            int B, int Sq, int Sk, int H, int KH, int D, int cache_dtype,
                            float scale, void* stream) {
  using namespace substratus;
  if (B < 1 || Sq < 1 || Sk < 1 || KH < 1 || H % KH != 0) return -1;
  if (B * H > 65535) return -1;  // grid.y limit
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cache_dtype) {
    case kBF16:
      return dispatch_d<__nv_bfloat16>(D, q, k, v, nullptr, nullptr, pos, kv_len, o, B, Sq, Sk,
                                       H, KH, scale, s);
    case kInt8:
      if (k_scale == nullptr || v_scale == nullptr) return -1;
      return dispatch_d<int8_t>(D, q, k, v, k_scale, v_scale, pos, kv_len, o, B, Sq, Sk, H, KH,
                                scale, s);
    default:
      return -3;
  }
}
