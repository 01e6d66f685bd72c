// Flash-attention backward for Hopper (sm_90a) at head_dim 16, 32 and 256: dQ
// and dK/dV from the forward's row logsumexp, recomputing the
// probabilities tile by tile so no [Sq, Sk] matrix reaches device memory.
//
// Replaces, with flash_bwd_wgmma.cu (head_dim 64 and 128, every model but
// the tiny test configs and head dims above 128), the TPU kernels
// substratus_tpu/ops/flash_attention.py _bwd_dq_kernel and
// _bwd_dkv_kernel (driven by _flash_backward), the training backward of
// every attention layer; ops/flash_attention.py::flash_bwd_design routes
// by head_dim.
//
// Layout: q, dO [B, Sq, H, D], k, v [B, Sk, KH, D], bf16, contiguous; lse
// and delta = rowsum(dO * O) [B*H, Sq] f32 (delta is computed outside, as
// XLA computes it in the JAX package); dq like q, dk/dv like k. Query head
// h reads kv head h / (H / KH).
//
// Math (as the Pallas kernels): s = (q . k) * scale in f32; live = col <=
// row under causal (and inside the ragged edges); p = exp(s - lse), 0 where
// not live; dp = dO . v; ds = p (dp - delta) scale. dQ = ds K; dV = p^T dO;
// dK = ds^T Q. p and ds are rounded to bf16 before their products, as the
// TPU kernels round them to the input dtype.
//
// Design. Both kernels take flash_fwd.cu's design: four warps, each owning
// 16 rows of the block's tile; padded shared tiles (load_tile); mma.sync
// m16n8k16 with f32 accumulators; an accumulator tile reused in registers
// as the A operand of the next product. The TPU grid's sequential axis
// becomes a loop inside the block, and ragged tiles are masked instead of
// fitted.
//  * dQ: one block per (q-tile of 64 rows, b*h). Q and dO stay in shared
//    memory; the loop walks k-tiles of 64 keys up to the diagonal:
//    S = Q K^T and dP = dO V^T (K and V as B operands by plain ldmatrix),
//    dS in the score registers, dQ += dS K (K through ldmatrix.trans).
//  * dK/dV: one block per (k-tile of 64 keys, b*kh). K and V stay in
//    shared memory; the loop walks the kv head's G query heads and, from
//    the diagonal on, their q-tiles of 32 rows, computing S^T = K Q^T and
//    dP^T = V dO^T directly, so P^T and dS^T sit in accumulator registers
//    as the A operands of dV += P^T dO and dK += dS^T Q. The GQA group is
//    summed inside the block: no per-query-head f32 partials (the TPU
//    kernel writes [B*H, Sk, D] f32 and sums afterwards). Per-column lse
//    and delta of the q-tile go through shared memory.
//  * Head dim 256 (gemma's; 129-255 run padded to it). Shared memory
//    fits: dQ 135,168 B, dK/dV 101,632 B. Registers do not: dK and dV of
//    16 keys x 256 columns in f32 are 256 a thread. So at 256 a dK/dV
//    block writes one half of the columns (DO = 128, grid.z = 2): both
//    halves compute the whole S^T and dP^T (over all 256 columns of K, Q,
//    V and dO), and each accumulates dV and dK for its own 128 columns of
//    dO and Q. That doubles the two score products, a quarter more work
//    in all, for accumulators of 128 registers. dQ keeps its 16 x 256
//    accumulator (128 registers) beside the scores and spills some of
//    them (nvcc -Xptxas -v prints how much).
//
// Bound on an H100 (SXM, 3.35 TB/s, 989 TFLOP/s bf16) at the llama2-7b
// training shape (B=8, S=1024, H=KH=32, D=128, causal): dQ runs three
// products over the causal half (103 GFLOP, 0.104 ms) against 0.34 GB of
// q/k/v/dO/dQ (0.10 ms); dK/dV four products (137 GFLOP, 0.139 ms)
// against 0.40 GB: both bound by operations. These first versions load
// tiles synchronously (no cp.async/TMA pipeline) and use mma.sync rather
// than wgmma, as the forward does; at head_dim 128 they reached 12-13% of
// the bound, and flash_bwd_wgmma.cu took that shape over.
#include "mma.cuh"

namespace substratus {
namespace {

constexpr int NWARP = 4;
constexpr int NT = NWARP * 32;
constexpr int PAD = 8;      // bf16 elements of row padding, as load_tile writes
constexpr int DQ_BQ = 64;   // dQ: query rows per block (16 per warp)
constexpr int DQ_BK = 64;   // dQ: keys per shared-memory tile
constexpr int KV_BK = 64;   // dK/dV: keys per block (16 per warp)
constexpr int KV_BQ = 32;   // dK/dV: query rows per shared-memory tile

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(__nv_bfloat16) * (2 * DQ_BQ + 2 * DQ_BK) * (D + PAD);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(__nv_bfloat16) * (2 * KV_BK + 2 * KV_BQ) * (D + PAD) + sizeof(float) * 2 * KV_BQ;
}

// A fragment (16 x 16, row-major) of a padded tile: rows r0.., columns c0..
// Matrix m of ldmatrix.x4 is rows (m & 1) * 8.. and columns (m >> 1) * 8..
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int r0, int c0,
                                       int lane) {
  const int m = lane / 8;
  ldmatrix_x4(a, tile + (r0 + (m & 1) * 8 + lane % 8) * LD + c0 + (m >> 1) * 8);
}

// B fragments of X Y^T for two adjacent n8 tiles, where the n index runs
// over the tile's rows n0..n0+15 and k over its columns c0..c0+15: matrix m
// is rows (m >> 1) * 8.. and columns (m & 1) * 8.., i.e. (b0, b1) of n-tile
// n0 / 8 and of the next.
template <int LD>
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4], const __nv_bfloat16* tile, int n0, int c0,
                                            int lane) {
  const int m = lane / 8;
  ldmatrix_x4(b, tile + (n0 + (m >> 1) * 8 + lane % 8) * LD + c0 + (m & 1) * 8);
}

// B fragments of X Y for two adjacent n8 tiles, where k runs over the
// tile's rows k0..k0+15 and n over its columns n0..n0+15 (ldmatrix.trans):
// matrix m is rows (m & 1) * 8.. and columns (m >> 1) * 8...
template <int LD>
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4], const __nv_bfloat16* tile, int k0, int n0,
                                             int lane) {
  const int m = lane / 8;
  ldmatrix_x4_trans(b, tile + (k0 + (m & 1) * 8 + lane % 8) * LD + n0 + (m >> 1) * 8);
}

// c (16 x 8*NTILE) += rows r0..r0+15 of `a_tile` times the first 8*NTILE
// rows of `b_tile` transposed, contracting over D columns.
template <int NTILE, int D>
__device__ __forceinline__ void mma_abt(float (&c)[NTILE][4], const __nv_bfloat16* a_tile, int r0,
                                        const __nv_bfloat16* b_tile, int lane) {
  constexpr int LD = D + PAD;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t a[4];
    load_a<LD>(a, a_tile, r0, ks * 16, lane);
#pragma unroll
    for (int jp = 0; jp < NTILE; jp += 2) {
      uint32_t b[4];
      load_b_rows<LD>(b, b_tile, jp * 8, ks * 16, lane);
      mma_bf16(c[jp], a, b[0], b[1]);
      mma_bf16(c[jp + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x DO) += x (16 x 8*NTILE, accumulator registers rounded to
// bf16) times the first 8*NTILE rows of `y_tile` (D columns a row), its
// columns c0..c0+DO-1. The m16n8 accumulators of tiles 2kk and 2kk+1 are
// the m16k16 A fragment of k-step kk.
template <int NTILE, int D, int DO = D>
__device__ __forceinline__ void mma_xy(float (&acc)[DO / 8][4], const float (&x)[NTILE][4],
                                       const __nv_bfloat16* y_tile, int lane, int c0 = 0) {
  constexpr int LD = D + PAD;
#pragma unroll
  for (int kk = 0; kk < NTILE / 2; ++kk) {
    const uint32_t a[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]), pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                           pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < DO / 8; dp += 2) {
      uint32_t b[4];
      load_b_trans<LD>(b, y_tile, kk * 16, c0 + dp * 8, lane);
      mma_bf16(acc[dp], a, b[0], b[1]);
      mma_bf16(acc[dp + 1], a, b[2], b[3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
}

// Rows row0 and row0 + 8 of a [*, stride] bf16 matrix from accumulator
// tiles (16 x D), this thread's column pairs; rows past n are not written.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, size_t stride, int row0, int n,
                                           const float (&acc)[D / 8][4], int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n) continue;
    __nv_bfloat16* out = base + (size_t)row * stride;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(out + i * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[i][2 * r], acc[i][2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
    int Sq, int Sk, int H, int KH, float scale, int causal) {
  constexpr int LD = D + PAD;
  constexpr int NTS = DQ_BK / 8;  // n8 tiles of the scores
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + DQ_BQ * LD;
  __nv_bfloat16* Ks = dOs + DQ_BQ * LD;
  __nv_bfloat16* Vs = Ks + DQ_BK * LD;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KH);
  const int q0 = blockIdx.x * DQ_BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // accumulator row (and row + 8)
  const int t = lane % 4;  // accumulator column pair
  const int row0 = q0 + warp * 16 + g;
  const size_t q_stride = (size_t)H * D;
  const size_t kv_stride = (size_t)KH * D;
  const size_t q_off = ((size_t)b * Sq * H + h) * D;
  const __nv_bfloat16* kb = k + ((size_t)b * Sk * KH + kvh) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * Sk * KH + kvh) * D;

  load_tile<DQ_BQ, D, NT>(Qs, q + q_off, q_stride, q0, Sq);
  load_tile<DQ_BQ, D, NT>(dOs, dout + q_off, q_stride, q0, Sq);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse_r[r] = row < Sq ? lse[(size_t)bh * Sq + row] : 0.f;
    delta_r[r] = row < Sq ? delta[(size_t)bh * Sq + row] : 0.f;
  }
  float acc[D / 8][4];
  zero(acc);

  // Causal: a k-tile is live unless it lies entirely above the block's diagonal.
  const int k_end = causal ? min(Sk, q0 + DQ_BQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += DQ_BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<DQ_BK, D, NT>(Ks, kb, kv_stride, k0, Sk);
    load_tile<DQ_BK, D, NT>(Vs, vb, kv_stride, k0, Sk);
    __syncthreads();

    float s[NTS][4], dp[NTS][4];
    zero(s);
    zero(dp);
    mma_abt<NTS, D>(s, Qs, warp * 16, Ks, lane);    // S = Q K^T
    mma_abt<NTS, D>(dp, dOs, warp * 16, Vs, lane);  // dP = dO V^T
#pragma unroll
    for (int j = 0; j < NTS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 8 * (e / 2);
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const bool live = row < Sq && col < Sk && (!causal || col <= row);
        const float p = live ? expf(s[j][e] * scale - lse_r[e / 2]) : 0.f;
        s[j][e] = p * (dp[j][e] - delta_r[e / 2]) * scale;  // dS, rounded to bf16 by mma_xy
      }
    }
    mma_xy<NTS, D>(acc, s, Ks, lane);  // dQ += dS K
  }
  store_rows<D>(dq + q_off, q_stride, row0, Sq, acc, t);
}

// DO: the columns of dK and dV a block writes, c0 = blockIdx.z * DO
// (DO = D but at 256: above).
template <int D, int DO>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int H, int KH, float scale, int causal) {
  constexpr int LD = D + PAD;
  constexpr int NTQ = KV_BQ / 8;  // n8 tiles of the transposed scores
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + KV_BK * LD;
  __nv_bfloat16* Qs = Vs + KV_BK * LD;
  __nv_bfloat16* dOs = Qs + KV_BQ * LD;
  float* lse_s = reinterpret_cast<float*>(dOs + KV_BQ * LD);
  float* delta_s = lse_s + KV_BQ;

  const int bkh = blockIdx.y;
  const int b = bkh / KH;
  const int kvh = bkh % KH;
  const int G = H / KH;
  const int k0 = blockIdx.x * KV_BK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int key0 = k0 + warp * 16 + g;  // this thread's two keys: key0, key0 + 8
  const size_t q_stride = (size_t)H * D;
  const size_t kv_stride = (size_t)KH * D;
  const size_t kv_off = ((size_t)b * Sk * KH + kvh) * D;
  const int c0 = blockIdx.z * DO;

  load_tile<KV_BK, D, NT>(Ks, k + kv_off, kv_stride, k0, Sk);
  load_tile<KV_BK, D, NT>(Vs, v + kv_off, kv_stride, k0, Sk);
  float dk_acc[DO / 8][4], dv_acc[DO / 8][4];
  zero(dk_acc);
  zero(dv_acc);

  // Causal: query rows before k0 attend none of the block's keys.
  const int q_begin = causal ? (k0 / KV_BQ) * KV_BQ : 0;
  for (int hq = kvh * G; hq < (kvh + 1) * G; ++hq) {
    const size_t q_off = ((size_t)b * Sq * H + hq) * D;
    const float* lse_h = lse + ((size_t)b * H + hq) * Sq;
    const float* delta_h = delta + ((size_t)b * H + hq) * Sq;
    for (int q0 = q_begin; q0 < Sq; q0 += KV_BQ) {
      __syncthreads();  // every warp is done with the previous Q/dO tile
      load_tile<KV_BQ, D, NT>(Qs, q + q_off, q_stride, q0, Sq);
      load_tile<KV_BQ, D, NT>(dOs, dout + q_off, q_stride, q0, Sq);
      for (int i = threadIdx.x; i < KV_BQ; i += NT) {
        lse_s[i] = q0 + i < Sq ? lse_h[q0 + i] : 0.f;
        delta_s[i] = q0 + i < Sq ? delta_h[q0 + i] : 0.f;
      }
      __syncthreads();

      float st[NTQ][4], dpt[NTQ][4];
      zero(st);
      zero(dpt);
      mma_abt<NTQ, D>(st, Ks, warp * 16, Qs, lane);    // S^T = K Q^T
      mma_abt<NTQ, D>(dpt, Vs, warp * 16, dOs, lane);  // dP^T = V dO^T
#pragma unroll
      for (int j = 0; j < NTQ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + 8 * (e / 2);
          const int qi = j * 8 + 2 * t + (e & 1);
          const int row = q0 + qi;
          const bool live = key < Sk && row < Sq && (!causal || key <= row);
          const float p = live ? expf(st[j][e] * scale - lse_s[qi]) : 0.f;
          st[j][e] = p;                                         // P^T
          dpt[j][e] = p * (dpt[j][e] - delta_s[qi]) * scale;  // dS^T
        }
      }
      mma_xy<NTQ, D, DO>(dv_acc, st, dOs, lane, c0);  // dV += P^T dO
      mma_xy<NTQ, D, DO>(dk_acc, dpt, Qs, lane, c0);  // dK += dS^T Q
    }
  }
  store_rows<DO>(dk + kv_off + c0, kv_stride, key0, Sk, dk_acc, t);
  store_rows<DO>(dv + kv_off + c0, kv_stride, key0, Sk, dv_acc, t);
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, int B, int Sq, int Sk, int H, int KH, float scale,
              int causal, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  static bool configured = false;
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<D>, smem, configured);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + DQ_BQ - 1) / DQ_BQ, B * H);
  flash_bwd_dq_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse, delta,
      static_cast<__nv_bfloat16*>(dq), Sq, Sk, H, KH, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dk, void* dv, int B, int Sq, int Sk, int H, int KH,
               float scale, int causal, cudaStream_t stream) {
  constexpr int DO = D == 256 ? D / 2 : D;
  constexpr size_t smem = dkv_smem_bytes<D>();
  static bool configured = false;
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<D, DO>, smem, configured);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sk + KV_BK - 1) / KV_BK, B * KH, D / DO);
  flash_bwd_dkv_kernel<D, DO><<<grid, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse, delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), Sq, Sk, H, KH, scale, causal);
  return (int)cudaGetLastError();
}

int check_args(int B, int Sq, int Sk, int H, int KH, int dtype) {
  if (B < 1 || Sq < 1 || Sk < 1 || KH < 1 || H % KH != 0) return -1;
  if (B * H > 65535) return -1;  // grid.y limit
  if (dtype != kBF16) return -3;
  return 0;
}

}  // namespace
}  // namespace substratus

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int B, int Sq, int Sk,
                            int H, int KH, int D, int dtype, float scale, int causal, void* stream) {
  using namespace substratus;
  if (int rc = check_args(B, Sq, Sk, H, KH, dtype)) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (D) {
    case 16:
      return launch_dq<16>(q, k, v, dout, l, dl, dq, B, Sq, Sk, H, KH, scale, causal, s);
    case 32:
      return launch_dq<32>(q, k, v, dout, l, dl, dq, B, Sq, Sk, H, KH, scale, causal, s);
    case 256:
      return launch_dq<256>(q, k, v, dout, l, dl, dq, B, Sq, Sk, H, KH, scale, causal, s);
    default:
      return -2;
  }
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int B, int Sq,
                             int Sk, int H, int KH, int D, int dtype, float scale, int causal,
                             void* stream) {
  using namespace substratus;
  if (int rc = check_args(B, Sq, Sk, H, KH, dtype)) return rc;
  if (B * KH > 65535) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (D) {
    case 16:
      return launch_dkv<16>(q, k, v, dout, l, dl, dk, dv, B, Sq, Sk, H, KH, scale, causal, s);
    case 32:
      return launch_dkv<32>(q, k, v, dout, l, dl, dk, dv, B, Sq, Sk, H, KH, scale, causal, s);
    case 256:
      return launch_dkv<256>(q, k, v, dout, l, dl, dk, dv, B, Sq, Sk, H, KH, scale, causal, s);
    default:
      return -2;
  }
}
