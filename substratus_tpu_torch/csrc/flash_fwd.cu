// Flash-attention forward for Hopper (sm_90a): blockwise self-attention
// with an online softmax, so the [Sq, Sk] score matrix never reaches
// device memory.
//
// Replaces the TPU kernel substratus_tpu/ops/flash_attention.py
// _flash_kernel (driven by _flash_forward / flash_attention) at head_dim
// 16, 32 and 256 (ops/flash_attention.py::flash_fwd_design; 129-255 run
// padded to 256, ops/headdim.py); flash_fwd_wgmma.cu takes 64 and 128,
// and this kernel's 64 and 128 instances serve chip_smoke.py's
// side-by-side timing.
//
// At head_dim 256 the shared memory is (64 + 2 * 64) * 264 * 2 B =
// 101,376 B; a warp's 16 x 256 f32 output tile is 128 registers a thread
// and the Q fragments 64 more, beside the 32 of the scores, so the
// compiler spills some of them to local memory (nvcc -Xptxas -v prints
// how much). This first instance at 256 is right and simple; keeping the
// output in two column halves, or wgmma with the accumulator split over
// two consumer warpgroups, is the way to take the spills back.
//
// Layout: q [B, Sq, H, D], k/v [B, Sk, KH, D], o [B, Sq, H, D], bf16,
// contiguous; lse (optional) [B*H, Sq] f32. Query head h reads kv head
// h / (H / KH) (GQA without duplicating k/v).
//
// Design. One block of four warps per (q-tile of BQ=64 rows, b*h); each
// warp owns 16 query rows. The TPU kernel's sequential k grid axis
// becomes a loop over k-tiles of BK=64 keys staged through shared memory
// (rows padded by 16 bytes so ldmatrix reads are free of bank
// conflicts). Both products run on the tensor cores with mma.sync
// m16n8k16 (bf16 in, f32 accumulate): S = Q K^T from ldmatrix fragments
// of Q (kept in registers for the whole loop) and K, then O += P V with P
// taken straight from S's accumulator registers (the m16n8 accumulator
// layout is the m16k16 A-operand layout) and V through ldmatrix.trans.
// The running max m, normaliser l and the f32 O accumulator stay in
// registers; row reductions go through the four lanes that share a row.
// Causal tiles entirely above the block's diagonal are never loaded.
// Instead of the TPU's block fitting (blocks halved until they divide
// S), the last q- and k-tiles are ragged and masked, so any length works.
//
// Numerics follow _flash_kernel: s = (q . k) * scale in f32; masked
// logits -1e30; p = exp(s - m_new); l sums the f32 p; p is rounded to
// bf16 before the PV product; out = acc / l (l == 0 -> 1); lse = m +
// log(l), or -1e30 for a row with nothing live.
//
// Bound on an H100 (SXM, 3.35 TB/s, 989 TFLOP/s bf16): at the serving
// prefill shape of llama2-7b (B=1, S=512, H=32, D=128, causal) the work
// is 2.2 GFLOP against 16.8 MB of q/k/v/o, so the bound is the bytes,
// about 5 us. This version reads each k/v tile once per q-tile and keeps
// p out of device memory, as the TPU kernel does, but loads tiles
// synchronously (no cp.async/TMA pipeline) and uses mma.sync rather than
// wgmma: overlapping the loads with the products is the next step.
#include "mma.cuh"

namespace substratus {
namespace {

constexpr int BQ = 64;  // query rows per block (16 per warp)
constexpr int BK = 64;  // keys per shared-memory tile
constexpr int NWARP = BQ / 16;
constexpr int NT = NWARP * 32;
constexpr int PAD = 8;  // bf16 elements of row padding (16 bytes)

template <int D>
constexpr size_t flash_smem_bytes() {
  return sizeof(__nv_bfloat16) * (BQ + 2 * BK) * (D + PAD);
}

template <int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
    int Sq, int Sk, int H, int KH, float scale, int causal) {
  constexpr int LD = D + PAD;
  constexpr int KSTEPS = D / 16;  // k-steps of the QK^T product
  constexpr int DT = D / 8;       // n8 tiles of the output
  constexpr int NTS = BK / 8;     // n8 tiles of the scores
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * LD;
  __nv_bfloat16* Vs = Ks + BK * LD;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KH);
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // accumulator row (and row + 8)
  const int t = lane % 4;  // accumulator column pair
  const int row0 = q0 + warp * 16 + g;  // this thread's two query rows
  const int row1 = row0 + 8;

  const size_t q_stride = (size_t)H * D;
  const size_t kv_stride = (size_t)KH * D;
  const __nv_bfloat16* kb = k + ((size_t)b * Sk * KH + kvh) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * Sk * KH + kvh) * D;

  load_tile<BQ, D, NT>(Qs, q + ((size_t)b * Sq * H + h) * D, q_stride, q0, Sq);
  __syncthreads();
  // Q fragments for the whole loop: matrix m of ldmatrix.x4 is rows
  // (m & 1) * 8.. and columns (m >> 1) * 8.. of the 16x16 A tile.
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

  // Causal: a k-tile is live unless it lies entirely above the block's diagonal.
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  const unsigned full = 0xffffffffu;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<BK, D, NT>(Ks, kb, kv_stride, k0, Sk);
    load_tile<BK, D, NT>(Vs, vb, kv_stride, k0, Sk);
    __syncthreads();

    // S = Q K^T: matrix m of ldmatrix.x4 is keys (m >> 1) * 8.. and head
    // columns (m & 1) * 8.., i.e. (b0, b1) of two adjacent n8 tiles.
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

    // Scale, mask, and the online-softmax update of this thread's two rows.
    float m_cur[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NTS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row0 : row1;
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const bool live = col < Sk && (!causal || col <= row);
        s[j][e] = live ? s[j][e] * scale : kNegInf;
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
        s[j][e] = p;
        psum[e / 2] += p;
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

    // O += P V. P (rounded to bf16) comes from the score registers: the
    // m16n8 accumulator of tiles 2kk and 2kk+1 is the m16k16 A fragment.
    // V^T fragments: matrix m of ldmatrix.x4.trans is keys (m & 1) * 8..
    // and head columns (m >> 1) * 8.., i.e. (b0, b1) of two n8 tiles.
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
    const int row = r == 0 ? row0 : row1;
    if (row >= Sq) continue;
    const float l_safe = l_run[r] == 0.f ? 1.f : l_run[r];
    __nv_bfloat16* ob = o + ((size_t)b * Sq + row) * q_stride + (size_t)h * D;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(ob + i * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[i][2 * r] / l_safe, acc[i][2 * r + 1] / l_safe);
    }
    if (lse != nullptr && t == 0) {
      lse[(size_t)bh * Sq + row] = l_run[r] == 0.f ? kNegInf : m_run[r] + logf(l_safe);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Sq,
           int Sk, int H, int KH, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = flash_smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, Sq, Sk, H, KH,
      scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace substratus

extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int B, int Sq, int Sk, int H, int KH, int D, int dtype, float scale,
                         int causal, void* stream) {
  using namespace substratus;
  if (B < 1 || Sq < 1 || Sk < 1 || KH < 1 || H % KH != 0) return -1;
  if (B * H > 65535) return -1;  // grid.y limit
  if (dtype != kBF16) return -3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, o, lse_f, B, Sq, Sk, H, KH, scale, causal, s);
    case 32:
      return launch<32>(q, k, v, o, lse_f, B, Sq, Sk, H, KH, scale, causal, s);
    case 64:
      return launch<64>(q, k, v, o, lse_f, B, Sq, Sk, H, KH, scale, causal, s);
    case 128:
      return launch<128>(q, k, v, o, lse_f, B, Sq, Sk, H, KH, scale, causal, s);
    case 256:
      return launch<256>(q, k, v, o, lse_f, B, Sq, Sk, H, KH, scale, causal, s);
    default:
      return -2;
  }
}
