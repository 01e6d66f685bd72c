// int4 unpack-dequant matmul for Hopper (sm_90a): out[M, N] = x[M, C] @ W,
// W unpacked from nibble-packed bytes and scaled per group inside the
// kernel, so only the packed bytes and the f32 scales are read from device
// memory.
//
// Replaces the TPU kernel substratus_tpu/ops/quant4.py _matmul_kernel
// (driven by _matmul), the serving path's projections and lm_head under
// quantize=int4 (7 * n_layers + 1 launches a forward), together with
// q4_matmul_decode.cu and q4_matmul_wgmma.cu. Which design serves which
// shape (ops/quant4.py::q4_design, by shape alone): at N a multiple of 16
// and groups of 128 (every llama2-7b projection and the lm_head) the
// decode steps (M <= 16) go to q4_matmul_decode.cu and larger M to
// q4_matmul_wgmma.cu; this kernel keeps the rest (groups of 32 and 64, as
// tinyllama's wo, and N a multiple of 8 but not of 16), at any M: its
// [16, 64] tiles with split-K up to 16 rows, [64, 128] tiles above.
//
// Layout: x [M, C] bf16, packed [C/2, N] uint8, scale [C/block, N] f32,
// out [M, N] bf16, all contiguous; ws [splits, M, N] f32 scratch when
// splits > 1. Packing is the JAX package's block fold: in group g, byte
// (g * block/2 + r, n) holds W[g * block + r, n] in its low nibble and
// W[g * block + block/2 + r, n] in its high nibble, each a sign-extended
// int4 times scale[g, n].
//
// Numerics follow _matmul_kernel: each W value is (int4 * scale) in f32,
// rounded to bf16 (round to nearest even) before the product; products
// accumulate in f32 on the tensor cores; the output is rounded to bf16.
//
// Design. One block of four warps per [BM, BN] output tile walks C one
// scale group (block rows) at a time. A three-stage cp.async ring stages
// the group's packed bytes ([block/2, BN], 16- or 8-byte vectors along
// N), its BN scales and the x tile ([BM, block]); each group's nibble
// planes are sign-extended, scaled, rounded to bf16 and stored as a
// [block, BN] bf16 tile (rows padded by 16 bytes so ldmatrix reads are
// free of bank conflicts), then multiplied on mma.sync m16n8k16 with x
// fragments from ldmatrix and W fragments from ldmatrix.trans. Two tile
// shapes: M <= 16 (a decode step) takes [16, 64] with each warp on 16
// columns (44 KB of shared memory, so five blocks fit an SM), M > 16 (a
// shape q4_matmul_wgmma.cu does not take) [64, 128] with each warp on
// 32 x 64. Rows past M and columns past N are zero-filled and not written.
//
// Bound on an H100 (SXM, 3.35 TB/s, 989 TFLOP/s bf16): at decode (M = 8)
// the bytes, 24.2 MB for a [4096, 11008] weight (7.2 us), since there are
// 2 x 8 products a weight byte; [16, 64] tiles give only 172 blocks for
// that shape, so C is split over grid.z until each SM has four blocks
// (q4_matmul_splits), each split writes f32 partials and a second kernel
// sums them in a fixed order and rounds to bf16. The dequantization does
// not overlap the loads (four warps a block, two barriers a group). At
// M = 512 the operations bound it (46.2 GFLOP, 47 us); every [64, 128]
// tile dequantizes its groups again, every column tile reads x again, and
// the products use mma.sync rather than wgmma: 4.6x behind cuBLAS there,
// which is why q4_matmul_wgmma.cu takes those shapes.
#include "mma.cuh"

namespace substratus {
namespace {

constexpr int NT = 128;        // threads per block (four warps)
constexpr int PAD = 8;         // bf16 elements of row padding (16 bytes)
constexpr int STAGES = 3;      // depth of the cp.async ring
constexpr int DECODE_BN = 64;  // output columns per block at M <= 16

// 16 or 8 bytes from global to shared memory, zero-filled when !valid.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The sign-extended int4 in bits [shift, shift + 4) of w, as a float,
// with integer and float adds in place of a conversion instruction: for
// the nibble u, (u ^ 8) - 8 sign-extends it, and the float whose bits are
// 0x4B000000 | x is exactly 2^23 + x for x < 2^23.
__device__ __forceinline__ float nibble(uint32_t w, int shift) {
  return __uint_as_float(((w >> shift) & 0xFu) ^ 0x4B000008u) - 8388616.f;
}

template <int BLOCK, int BM, int BN>
struct Smem {
  static constexpr int HALF = BLOCK / 2;
  static constexpr int LDX = BLOCK + PAD;
  static constexpr int LDW = BN + PAD;
  static constexpr size_t scale_bytes = sizeof(float) * BN;
  static constexpr size_t packed_bytes = HALF * BN;
  static constexpr size_t x_bytes = sizeof(__nv_bfloat16) * BM * LDX;
  static constexpr size_t w_bytes = sizeof(__nv_bfloat16) * BLOCK * LDW;
  static constexpr size_t total = STAGES * (scale_bytes + packed_bytes + x_bytes) + w_bytes;
};

// A [16 * MT * WM, BN] output tile: WM x WN warps, each on MT m16 tiles
// and BN / WN columns; VEC bytes of packed weight per cp.async (16, or 8
// when N is not a multiple of 16).
template <int BLOCK, int BN, int WM, int WN, int MT, int VEC>
__global__ void __launch_bounds__(NT) q4_matmul_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
    const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, float* __restrict__ ws, int M,
    int N, int C, int groups_per_split) {
  static_assert(WM * WN * 32 == NT, "four warps");
  constexpr int BM = 16 * MT * WM;
  using S = Smem<BLOCK, BM, BN>;
  constexpr int HALF = S::HALF, LDX = S::LDX, LDW = S::LDW;
  constexpr int WCOLS = BN / WN;  // columns per warp
  constexpr int NT8 = WCOLS / 8;  // n8 tiles per warp
  constexpr int CH = BN / VEC;    // packed vectors per row of the tile
  constexpr int XCH = BLOCK / 8;  // 16-byte x vectors per row
  constexpr int PV = (HALF * CH + NT - 1) / NT;  // packed vectors per thread

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ss = reinterpret_cast<float*>(smem_raw);
  uint8_t* Ps = smem_raw + STAGES * S::scale_bytes;
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(Ps + STAGES * S::packed_bytes);
  __nv_bfloat16* Ws = Xs + STAGES * BM * LDX;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / WN, wn = warp % WN;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int G = C / BLOCK;
  const int g0 = blockIdx.z * groups_per_split;
  const int niter = max(0, min(G, g0 + groups_per_split) - g0);

  auto load_stage = [&](int slot, int g) {
    for (int i = tid; i < BN / 4; i += NT) {  // the group's scales
      const int col = n0 + 4 * i;
      cp_async<16>(Ss + slot * BN + 4 * i, scale + (size_t)g * N + (col < N ? col : 0), col < N);
    }
    for (int i = tid; i < HALF * CH; i += NT) {  // its packed rows
      const int r = i / CH, c = (i % CH) * VEC, col = n0 + c;
      cp_async<VEC>(Ps + slot * S::packed_bytes + r * BN + c,
                    packed + ((size_t)g * HALF + r) * N + (col < N ? col : 0), col < N);
    }
    for (int i = tid; i < BM * XCH; i += NT) {  // the x tile
      const int r = i / XCH, c = (i % XCH) * 8, row = m0 + r;
      cp_async<16>(Xs + (slot * BM + r) * LDX + c,
                   x + (size_t)(row < M ? row : 0) * C + (size_t)g * BLOCK + c, row < M);
    }
  };

  float acc[MT][NT8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT8; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < niter) load_stage(s, g0 + s);
    cp_async_commit();
  }

  for (int it = 0; it < niter; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage `it` landed; every warp is done with Ws
    const int slot = it % STAGES;

    // Dequantize: byte row r gives W rows r (low nibbles) and r + HALF.
#pragma unroll
    for (int k = 0; k < PV; ++k) {
      const int i = tid + k * NT;
      if (i >= HALF * CH) break;
      const int r = i / CH, c = (i % CH) * VEC;
      uint32_t words[VEC / 4];
      const uint8_t* src = Ps + slot * S::packed_bytes + r * BN + c;
      if constexpr (VEC == 16) {
        const uint4 v = *reinterpret_cast<const uint4*>(src);
        words[0] = v.x, words[1] = v.y, words[2] = v.z, words[3] = v.w;
      } else {
        const uint2 v = *reinterpret_cast<const uint2*>(src);
        words[0] = v.x, words[1] = v.y;
      }
      float sc[VEC];
#pragma unroll
      for (int j = 0; j < VEC; j += 4) {
        const float4 f = *reinterpret_cast<const float4*>(Ss + slot * BN + c + j);
        sc[j] = f.x, sc[j + 1] = f.y, sc[j + 2] = f.z, sc[j + 3] = f.w;
      }
      uint32_t lo[VEC / 2], hi[VEC / 2];
#pragma unroll
      for (int j = 0; j < VEC; j += 2) {
        const uint32_t w = words[j / 4];
        const int sh = 8 * (j % 4);
        lo[j / 2] = pack_bf16(nibble(w, sh) * sc[j], nibble(w, sh + 8) * sc[j + 1]);
        hi[j / 2] = pack_bf16(nibble(w, sh + 4) * sc[j], nibble(w, sh + 12) * sc[j + 1]);
      }
#pragma unroll
      for (int j = 0; j < VEC / 8; ++j) {
        *reinterpret_cast<uint4*>(Ws + r * LDW + c + 8 * j) =
            make_uint4(lo[4 * j], lo[4 * j + 1], lo[4 * j + 2], lo[4 * j + 3]);
        *reinterpret_cast<uint4*>(Ws + (r + HALF) * LDW + c + 8 * j) =
            make_uint4(hi[4 * j], hi[4 * j + 1], hi[4 * j + 2], hi[4 * j + 3]);
      }
    }

    const int next = it + STAGES - 1;  // refills the slot of stage it - 1
    if (next < niter) load_stage(next % STAGES, g0 + next);
    cp_async_commit();
    __syncthreads();  // Ws holds the group

    // x fragments: matrix m of ldmatrix.x4 is rows (m & 1) * 8.. and
    // columns (m >> 1) * 8.. of the 16x16 A tile. W fragments through
    // ldmatrix.trans: matrix m is k rows (m & 1) * 8.. and columns
    // (m >> 1) * 8.., i.e. (b0, b1) of two adjacent n8 tiles.
    const int m = lane / 8;
    const __nv_bfloat16* xa = Xs + (slot * BM + wm * MT * 16 + (m & 1) * 8 + lane % 8) * LDX + (m >> 1) * 8;
    const __nv_bfloat16* wb = Ws + ((m & 1) * 8 + lane % 8) * LDW + wn * WCOLS + (m >> 1) * 8;
#pragma unroll
    for (int ks = 0; ks < BLOCK / 16; ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(a[mt], xa + mt * 16 * LDX + ks * 16);
#pragma unroll
      for (int jp = 0; jp < NT8; jp += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, wb + ks * 16 * LDW + jp * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][jp], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][jp + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }

  // Accumulator (row g, columns 2t, 2t+1) and (row g + 8, same columns).
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < NT8; ++j) {
      const int col = n0 + wn * WCOLS + j * 8 + 2 * t;
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + (wm * MT + mt) * 16 + g + 8 * h;
        if (row >= M) continue;
        if (ws == nullptr) {
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
              __floats2bfloat162_rn(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
        } else {
          *reinterpret_cast<float2*>(ws + ((size_t)blockIdx.z * M + row) * N + col) =
              make_float2(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
        }
      }
    }
  }
}

// out = bf16(sum over the splits of ws), in split order.
__global__ void q4_splitk_reduce(const float* __restrict__ ws, __nv_bfloat16* __restrict__ out,
                                 size_t pairs, int splits) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < pairs;
       i += (size_t)gridDim.x * blockDim.x) {
    float2 s = make_float2(0.f, 0.f);
    for (int k = 0; k < splits; ++k) {
      const float2 v = reinterpret_cast<const float2*>(ws + k * 2 * pairs)[i];
      s.x += v.x;
      s.y += v.y;
    }
    reinterpret_cast<__nv_bfloat162*>(out)[i] = __floats2bfloat162_rn(s.x, s.y);
  }
}

template <int BLOCK, int BN, int WM, int WN, int MT, int VEC>
int launch(const void* x, const void* packed, const void* scale, void* out, void* ws, int M, int N,
           int C, int splits, cudaStream_t stream) {
  constexpr int BM = 16 * MT * WM;
  constexpr size_t smem = Smem<BLOCK, BM, BN>::total;
  auto kernel = q4_matmul_kernel<BLOCK, BN, WM, WN, MT, VEC>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int G = C / BLOCK;
  const int per_split = (G + splits - 1) / splits;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out),
      splits > 1 ? static_cast<float*>(ws) : nullptr, M, N, C, per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t pairs = (size_t)M * N / 2;
  const size_t want = (pairs + 255) / 256;
  const int blocks = want < 1024 ? (int)want : 1024;
  q4_splitk_reduce<<<blocks, 256, 0, stream>>>(static_cast<const float*>(ws),
                                               static_cast<__nv_bfloat16*>(out), pairs, splits);
  return (int)cudaGetLastError();
}

template <int BLOCK>
int dispatch(const void* x, const void* packed, const void* scale, void* out, void* ws, int M,
             int N, int C, int splits, cudaStream_t s) {
  const bool vec16 = N % 16 == 0;
  if (M <= 16) {
    return vec16 ? launch<BLOCK, DECODE_BN, 1, 4, 1, 16>(x, packed, scale, out, ws, M, N, C, splits, s)
                 : launch<BLOCK, DECODE_BN, 1, 4, 1, 8>(x, packed, scale, out, ws, M, N, C, splits, s);
  }
  return vec16 ? launch<BLOCK, 128, 2, 2, 2, 16>(x, packed, scale, out, ws, M, N, C, splits, s)
               : launch<BLOCK, 128, 2, 2, 2, 8>(x, packed, scale, out, ws, M, N, C, splits, s);
}

}  // namespace
}  // namespace substratus

// Split-K factor for q4_matmul on a card of `sms` SMs: at M <= 16 the
// launch streams weight bytes and its [16, DECODE_BN] tiles alone would
// not give each SM four blocks; larger M has enough tiles. Every split
// gets at least one scale group.
extern "C" int q4_matmul_splits(int M, int N, int C, int block, int sms) {
  using namespace substratus;
  if (M > 16 || block < 1 || C < block) return 1;
  const int groups = C / block;
  const int tiles = (N + DECODE_BN - 1) / DECODE_BN;
  const int fill = (4 * sms + tiles - 1) / tiles;
  const int want = fill < 1 ? 1 : (fill > groups ? groups : fill);
  const int per_split = (groups + want - 1) / want;
  return (groups + per_split - 1) / per_split;
}

extern "C" int q4_matmul(const void* x, const void* packed, const void* scale, void* out, void* ws,
                         int M, int N, int C, int block, int splits, void* stream) {
  using namespace substratus;
  if (M < 1 || N < 8 || N % 8 != 0 || block < 1 || C < block || C % block != 0) return -1;
  if (splits < 1 || splits > C / block || (splits > 1 && ws == nullptr)) return -1;
  if ((M + 63) / 64 > 65535) return -1;  // grid.y limit
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (block) {
    case 32:
      return dispatch<32>(x, packed, scale, out, ws, M, N, C, splits, s);
    case 64:
      return dispatch<64>(x, packed, scale, out, ws, M, N, C, splits, s);
    case 128:
      return dispatch<128>(x, packed, scale, out, ws, M, N, C, splits, s);
    default:
      return -2;
  }
}
