// int4 unpack-dequant matmul for Hopper (sm_90a) at prefill shapes:
// out[M, N] = x[M, C] @ W, the same function as q4_matmul.cu's kernel
// (W[g * 128 + r, n] the low nibble of packed byte (g * 64 + r, n),
// W[g * 128 + 64 + r, n] its high nibble, each sign-extended and times
// scale[g, n]), for groups of 128 and N a multiple of 16.
//
// Replaces, with q4_matmul_decode.cu and q4_matmul.cu, the TPU kernel
// substratus_tpu/ops/quant4.py _matmul_kernel. ops/quant4.py::q4_design
// routes a call here when M > 16, N % 16 == 0 and the group is 128: every
// llama2-7b projection and the lm_head over a prefill bucket (32..512
// rows) or a 512-row chunk. q4_matmul_decode.cu takes the same shapes at
// M <= 16 (the decode steps), q4_matmul.cu every other shape.
//
// Numerics are the plain version's: each W value is (int4 * scale) in f32
// rounded to bf16 (round to nearest even), products accumulate in f32 on
// the tensor cores, the output is rounded once to bf16.
//
// Bound on an H100 (SXM, 989 TFLOP/s bf16, 3.35 TB/s): the operations at
// M >= 64 (M = 512, C = 4096, N = 11008: 46.2 GFLOP, 47 us). q4_matmul.cu's
// [64, 128] tiles serialise the dequantization with mma.sync (two barriers
// a group), dequantize every weight again in each 64-row tile, and cannot
// reach the bf16 rate, which only wgmma reaches.
//
// Design: the transposed product, out^T[N, M] = W^T x^T, so that the
// dequantized weights are wgmma's A operand in registers and never pass
// through shared memory.
//
// - A block of three warpgroups owns 128 output columns (n) by BM rows
//   (m). Warpgroup 2 is the producer: two of its threads keep two TMA
//   rings in flight (tensor maps encoded on the host for each call), one
//   of x tiles [BM, 128] bf16 (two [BM, 64] boxes, 128-byte swizzle:
//   exactly the K-major B operand of wgmma), and one, running further
//   ahead, of a group's packed bytes [64, 128] (128-byte swizzle) and its
//   128 scales. TMA zero-fills x's rows past M and the columns past N.
//   setmaxnreg gives the producer's registers to the consumers.
// - Warpgroups 0 and 1 consume, each on 64 columns. A warp's 16 columns
//   are its 16 rows of A; with ldmatrix.trans on the packed bytes (as
//   16-bit pairs of columns) a thread receives bytes (k, 2c), (k, 2c + 1),
//   (k + 1, 2c), (k + 1, 2c + 1) -- exactly its A fragment when A row c is
//   mapped to column 2c and row c + 8 to column 2c + 1 -- and dequantizes
//   them in registers (about 3.6 instructions a weight). The dequantized
//   weights never pass through shared memory, which holds only TMA stages.
// - Each consumer issues group g's eight m64nBMk16 wgmmas on its A
//   registers, dequantizes group g + 1 into a second set of registers
//   while they run, then waits for them. (A first version dequantized into
//   a double-buffered bf16 W tile in shared memory, read as wgmma's
//   MN-major B operand: 1.4x slower at M = 512, its rings shallower for
//   the 64 KB of W tiles.)
// - BM (the output rows of a block, wgmma's N) is 32 up to 32 rows, 64 up
//   to 64, and 128 above unless 64 fills the card better (q4_bm): every
//   weight is dequantized once per BM rows, and the tensor cores do little
//   work for rows past M.
//
// Waves on the 132 SMs (one block per SM) at M = 512 (BM = 128): 128 tiles
// for N = 4096 (one wave), 344 for N = 11008 (2.6), 1000 for N = 32000
// (7.6). At M = 128 there are N / 128 column tiles: 86 for N = 11008 and
// 250 for N = 32000 at BM = 128, while for N = 4096 BM = 64 doubles its 32
// tiles. x is read again by every column tile, from L2 (361 MB at M = 512,
// N = 11008, for 22.5 MB of packed bytes). Measured on an H100 against
// torch.matmul on the dequantized bf16 weight: PERF.md. A persistent tile
// scheduler, clusters with TMA multicast of the x tile, and split-K where
// a shape gives few tiles (N = 4096 below 128 rows) are later steps.
#include "hopper.cuh"

namespace substratus {
namespace {

constexpr int BN = 128;      // output columns per block (64 per consumer warpgroup)
constexpr int GROUP = 128;   // rows of W per scale group (K per stage)
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 128;  // two consumer warpgroups and the producer's

// Shared memory of a block: the ring of x tiles (XSTAGES) and the ring of
// packed bytes with their scales (PSTAGES), filled by TMA.
template <int BM>
struct Layout {
  static constexpr int XSTAGES = BM == 128 ? 5 : 8;
  static constexpr int PSTAGES = BM == 128 ? 6 : BM == 64 ? 8 : 12;
  static constexpr int x_bytes = BM * GROUP * 2;   // two [BM, 64] swizzled boxes
  static constexpr int p_bytes = GROUP / 2 * BN;   // packed bytes of a group
  static constexpr int s_bytes = BN * 4;           // scales of a group
  static constexpr int x_off = 0;
  static constexpr int p_off = x_off + XSTAGES * x_bytes;
  static constexpr int s_off = p_off + PSTAGES * p_bytes;
  static constexpr int bar_off = s_off + PSTAGES * s_bytes;
  // full and empty barriers of both rings, + slack to align the base to 1024
  static constexpr int total = bar_off + 16 * (XSTAGES + PSTAGES) + 1024;
};

template <int BM>
__global__ void __launch_bounds__(THREADS, 1) q4_matmul_wgmma_kernel(
    const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap p_map,
    const __grid_constant__ CUtensorMap s_map, __nv_bfloat16* __restrict__ out, int M, int N, int G) {
  using L = Layout<BM>;
  constexpr int XS = L::XSTAGES, PS = L::PSTAGES;
  constexpr int ACC = BM / 2;  // f32 accumulators a thread: m64 x nBM over 128 threads

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the 128-byte swizzle repeats every 1024 bytes
  const uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t x_full = base + L::bar_off, x_empty = x_full + 8 * XS;
  const uint32_t p_full = x_empty + 8 * XS, p_empty = p_full + 8 * PS;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  if (threadIdx.x == 0) {
    // full: the producer's expect_tx, completed by TMA's bytes; empty: lane
    // 0 of each of the eight consumer warps when it is done with a stage.
    for (int s = 0; s < XS; ++s) mbar_init(x_full + 8 * s, 1), mbar_init(x_empty + 8 * s, 8);
    for (int s = 0; s < PS; ++s) mbar_init(p_full + 8 * s, 1), mbar_init(p_empty + 8 * s, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // Producer warpgroup: lane 0 of its first warp fills the x ring, lane
    // 0 of its second the ring of packed bytes and scales.
    setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS) {
      for (int g = 0; g < G; ++g) {
        const int s = g % XS;
        if (g >= XS) mbar_wait(x_empty + 8 * s, ((g / XS) - 1) & 1);
        const uint32_t bar = x_full + 8 * s, xs = base + L::x_off + s * L::x_bytes;
        mbar_expect_tx(bar, L::x_bytes);
        tma_load_2d(xs, &x_map, bar, g * GROUP, m0);
        tma_load_2d(xs + L::x_bytes / 2, &x_map, bar, g * GROUP + 64, m0);
      }
    } else if (threadIdx.x == CONSUMERS + 32) {
      for (int g = 0; g < G; ++g) {
        const int s = g % PS;
        if (g >= PS) mbar_wait(p_empty + 8 * s, ((g / PS) - 1) & 1);
        const uint32_t bar = p_full + 8 * s;
        mbar_expect_tx(bar, L::p_bytes + L::s_bytes);
        tma_load_2d(base + L::p_off + s * L::p_bytes, &p_map, bar, n0, g * (GROUP / 2));
        tma_load_2d(base + L::s_off + s * L::s_bytes, &s_map, bar, n0, g);
      }
    }
  } else {
    // Consumer warpgroups.
    setmaxnreg_inc<232>();
    const int ct = threadIdx.x, wg = ct / 128, warp = (ct % 128) / 32, lane = ct % 32;
    const int col = wg * 64 + warp * 16;  // the warp's 16 columns: its A rows, permuted
    // ldmatrix rows: lane l gives packed row l (then 32 + l), in the
    // swizzled position of the warp's 16-byte chunk.
    const uint32_t ld = lane * 128 + (((col / 16) ^ (lane & 7)) << 4);
    float acc[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

    // Group g's A fragments: a[j] for the K rows 16 j.. of the group (j < 4
    // low nibbles, j >= 4 high nibbles); ldmatrix matrix q holds K rows
    // 8 q.. of the low half, the first (q even) or second 8 of step q / 2.
    auto dequant = [&](int g, uint32_t (&a)[8][4]) {
      const int s = g % PS;
      mbar_wait(p_full + 8 * s, (g / PS) & 1);
      const uint32_t P = base + L::p_off + s * L::p_bytes;
      uint32_t r[2][4];
      ldmatrix_x4_trans(r[0], P + ld);
      ldmatrix_x4_trans(r[1], P + ld + 32 * 128);
      const float2 sc = *reinterpret_cast<const float2*>(gbase + L::s_off + s * L::s_bytes +
                                                         4 * (col + 2 * (lane / 4)));
      // column c0's scale for nibbles at bits 0 and 4, c1's at bits 8 and 12
      const float scales[4] = {sc.x, sc.x * 0x1p-4f, sc.y * 0x1p-8f, sc.y * 0x1p-12f};
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int j = q / 2, h = 2 * (q % 2);
        dequant_reg(r[q / 4][q % 4], scales, a[j][h], a[j][h + 1], a[j + 4][h], a[j + 4][h + 1]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(p_empty + 8 * s);
    };
    // Group g's eight products on its A registers, issued asynchronously;
    // group g + 1 dequantized into next while they run; then the products
    // are waited for and the x stage freed.
    auto step = [&](int g, uint32_t (&a)[8][4], uint32_t (&next)[8][4]) {
      const int s = g % XS;
      mbar_wait(x_full + 8 * s, (g / XS) & 1);
      const uint32_t xs = base + L::x_off + s * L::x_bytes;
      fence_regs(acc);
      fence_regs(a);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < GROUP / 16; ++j)  // 16 K rows are 32 bytes of a swizzled 128-byte row
        wgmma(acc, a[j], smem_desc(xs + (j / 4) * (L::x_bytes / 2) + (j % 4) * 32, 16, 1024));
      wgmma_commit();
      if (g + 1 < G) dequant(g + 1, next);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(a);
      __syncwarp();
      if (lane == 0) mbar_arrive(x_empty + 8 * s);
    };

    uint32_t a0[8][4], a1[8][4];
    dequant(0, a0);
    for (int g = 0; g < G; g += 2) {
      step(g, a0, a1);
      if (g + 1 < G) step(g + 1, a1, a0);
    }

    // Accumulator i: A row 16 warp + lane / 4 + 8 ((i / 2) % 2), i.e. column
    // col + 2 (lane / 4) + (i / 2) % 2, and B column (output row)
    // 8 (i / 4) + 2 (lane % 4) + i % 2: each thread writes column pairs.
    const int c = n0 + col + 2 * (lane / 4);
    if (c < N) {
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        const int row = m0 + 8 * j + 2 * (lane % 4);
        if (row < M)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + c) =
              __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 2]);
        if (row + 1 < M)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(row + 1) * N + c) =
              __floats2bfloat162_rn(acc[4 * j + 1], acc[4 * j + 3]);
      }
    }
  }
}

template <int BM>
int launch(const void* x, const void* packed, const void* scale, void* out, int M, int N, int C,
           cudaStream_t stream) {
  constexpr int smem = Layout<BM>::total;
  auto kernel = q4_matmul_wgmma_kernel<BM>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  CUtensorMap x_map, p_map, s_map;
  const int G = C / GROUP;
  if (!make_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, C, M, (uint64_t)C * 2, 64, BM,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&p_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, packed, N, C / 2, N, BN, GROUP / 2,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&s_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scale, N, G, (uint64_t)N * 4, BN, 1,
                CU_TENSOR_MAP_SWIZZLE_NONE))
    return -3;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, THREADS, smem, stream>>>(x_map, p_map, s_map, static_cast<__nv_bfloat16*>(out), M, N, G);
  return (int)cudaGetLastError();
}

// The block's output rows: the smallest of 32, 64 and 128 that covers M,
// except that above 64 rows 64 is kept while 128-row tiles would fill at
// most half of the card's SMs (at M = 128: N = 4096 takes 64 tiles of 64
// rows, which ran faster than 32 of 128 on an H100; N = 11008 takes 86 of
// 128, faster than 172 of 64, 1.3 waves).
int q4_bm(int M, int N) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  if (M <= 32) return 32;
  if (M <= 64) return 64;
  const int tiles = (N + BN - 1) / BN * ((M + 127) / 128);
  return 2 * tiles <= sms ? 64 : 128;
}

}  // namespace
}  // namespace substratus

// x [M, C] bf16, packed [C/2, N] uint8, scale [C/128, N] f32, out [M, N]
// bf16, all contiguous and 16-byte aligned. -1 for a shape this design
// does not take (ops/quant4.py::q4_design routes those to q4_matmul), -3
// when the driver gives no tensor map.
extern "C" int q4_matmul_wgmma(const void* x, const void* packed, const void* scale, void* out, int M, int N,
                               int C, int block, void* stream) {
  using namespace substratus;
  if (block != GROUP || M < 1 || N < 16 || N % 16 != 0 || C < GROUP || C % GROUP != 0) return -1;
  if (((uintptr_t)x | (uintptr_t)packed | (uintptr_t)scale) % 16 != 0) return -1;
  if ((M + 31) / 32 > 65535) return -1;  // grid.y limit
  if (encode_tiled() == nullptr) return -3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q4_bm(M, N)) {
    case 128:
      return launch<128>(x, packed, scale, out, M, N, C, s);
    case 64:
      return launch<64>(x, packed, scale, out, M, N, C, s);
    default:
      return launch<32>(x, packed, scale, out, M, N, C, s);
  }
}
