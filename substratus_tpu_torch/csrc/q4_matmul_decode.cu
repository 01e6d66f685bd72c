// int4 unpack-dequant matmul for Hopper (sm_90a) at decode shapes:
// out[M, N] = x[M, C] @ W for M <= 16 rows (a decode step of up to
// max_batch slots, the 16-token prefill bucket), groups of 128 and N a
// multiple of 16, the same function as q4_matmul.cu's and
// q4_matmul_wgmma.cu's kernels (W[g * 128 + r, n] the low nibble of packed
// byte (g * 64 + r, n), W[g * 128 + 64 + r, n] its high nibble, each
// sign-extended and times scale[g, n]).
//
// Replaces, with q4_matmul_wgmma.cu (M > 16) and q4_matmul.cu (groups of
// 32 and 64, N not a multiple of 16), the TPU kernel
// substratus_tpu/ops/quant4.py _matmul_kernel. ops/quant4.py::q4_design
// routes a call here; ops/quant4.py::q4_decode_plan picks its tiles.
//
// Numerics are the plain version's: each W value is (int4 * scale) in f32
// rounded to bf16, products accumulate in f32 (mma.sync), the splits'
// partials are summed in f32 in rank order, the output is rounded once to
// bf16. Two calls on the same inputs give the same bits.
//
// Bound on an H100 (SXM, 3.35 TB/s, 989 TFLOP/s bf16): the bytes. At M = 8
// there are 16 products a weight byte; llama2-7b's w_gate [4096, 11008]
// is 22.5 MB of packed bytes and 0.7 MB of scales (7.2 us), a decode step
// 3.51 GB of int4 weights (1.05 ms). q4_matmul.cu streamed them at 0.78
// TB/s: its dequantized tiles went through shared memory between two
// barriers a group, its m16 tiles held 8 rows of zeros at M = 8, and
// split-K took a second launch and a workspace.
//
// Design: the transposed product, out^T[N, M] = W^T x^T, so that the
// dequantized weights are the A operand of mma.sync m16n8k16 in registers
// and x^T is B (one n8 tile for M <= 8, two for M <= 16; TMA zero-fills
// x's rows past M). No weight passes through shared memory after its
// packed bytes, and no tensor-core row is wasted.
//
// - A block is sixteen consumer warps and one producer warp. It owns BN
//   columns (BN / 128 chunks of 128, walked in turn) and one split of the
//   scale groups. Each consumer warp takes a 16-column slice of a chunk,
//   in every other stage: two sets of eight warps work on two stages at
//   once. With ldmatrix.trans on the swizzled packed bytes a warp's lanes
//   receive their A fragments' bytes (hopper.cuh's mapping, shared with
//   q4_matmul_wgmma.cu: A rows c and c + 8 are columns 2c and 2c + 1, and
//   the epilogue writes them so), and dequant_reg turns them into bf16 A
//   registers. At a chunk's end set 1 hands its sums to set 0 through
//   shared memory. The consumers' instructions bound the block: about 5
//   a weight, 3.6 of them the dequantization (exact f32 products rounded
//   to bf16 leave little to remove); eight warps, one a slice, hid too
//   little of their latency, and sixteen on half a stage each spent more
//   instructions a weight on the stage's bookkeeping (PERF.md, with
//   tools/q4_decode_probe.py's readings).
// - One lane of the producer warp keeps a ring of RING stages in flight
//   by TMA, each a group's packed bytes of a chunk ([64, 128], 128-byte
//   swizzle) and their 128 scales; consumers wait on full barriers and
//   release on empty ones. x's rows of a group come with its stage; a
//   block of more than one chunk keeps them instead for every chunk, one
//   [rows, 128] tile a group with its own barrier (the plan keeps them
//   within the shared memory).
// - Split-K inside the one launch: the splits of a column tile form a
//   thread-block cluster (at most 8, the portable size; q4_decode_plan
//   keeps a plan's clusters within what the card runs at once, since a
//   cluster's blocks share a GPC). The other ranks
//   write their f32 partials into rank 0's shared memory by st.async,
//   counted on a barrier of rank 0's, which sums them in rank order,
//   rounds to bf16 and stores. A cluster barrier, arrived at on entry and
//   waited for before the first partial is sent, keeps the partials off
//   rank 0 until its barrier is set up; every thread of every rank reaches
//   it, whatever its groups. No workspace, no second launch; a call of one
//   split stores from registers. (Summing instead through loads of the
//   other ranks' shared memory, between two cluster barriers, was slower;
//   PERF.md.)
#include "hopper.cuh"

namespace substratus {
namespace {

constexpr int CHUNK = 128;     // columns of a chunk: one TMA box of packed bytes
constexpr int GROUP = 128;     // K rows of a scale group
constexpr int SLICES = CHUNK / 16;             // 16-column slices of a chunk
constexpr int CONSUMERS = 2 * SLICES;          // consumer warps: two sets of one a slice
constexpr int THREADS = 32 * (CONSUMERS + 1);  // and the producer warp
constexpr int RING = 8;        // stages of the ring of packed bytes and scales (a power of two)
constexpr int MAX_SPLITS = 8;  // the portable cluster size
constexpr int MAX_SMEM = 232448;            // dynamic shared memory a block may use
constexpr int P_BYTES = GROUP / 2 * CHUNK;  // packed bytes of a group's chunk
constexpr int S_BYTES = CHUNK * 4;          // their scales

// Shared memory of a block (kept in step with ops/quant4.py::
// q4_decode_smem): the ring of packed bytes, x's tiles (one a stage, or
// with more than one chunk one for each of the block's groups), the ring
// of scales, two buffers for the sets' sums, the splits' f32 partials
// of the tile (kept by rank 0), barriers.
struct Layout {
  bool resident;  // x's tiles stay for every chunk
  int x_bytes, x_off, s_off, xch_off, part_off, bar_off, total;
};

// rows: x's rows padded to the n8 tiles (8 or 16); gps: groups of the
// largest split; chunks: BN / CHUNK.
__host__ __device__ inline Layout layout(int rows, int gps, int chunks, int splits) {
  Layout L;
  L.resident = chunks > 1;
  L.x_bytes = rows * GROUP * 2;  // two [rows, 64] boxes, 128-byte swizzle
  L.x_off = RING * P_BYTES;
  L.s_off = L.x_off + (L.resident ? gps : RING) * L.x_bytes;
  L.xch_off = L.s_off + RING * S_BYTES;
  L.part_off = L.xch_off + 2 * SLICES * 32 * (rows / 2) * 4;
  L.bar_off = L.part_off + (splits > 1 ? splits * chunks * rows * CHUNK * 4 : 0);
  // full and empty barriers of the ring, the sum's, the resident x tiles';
  // + slack to align the base to 1024
  L.total = L.bar_off + 8 * (2 * RING + 1 + (L.resident ? gps : 0)) + 1024;
  return L;
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// MT: n8 tiles of x^T, 1 for M <= 8, 2 for M <= 16. RES: x's tiles stay
// for every chunk (a block of more than one chunk; Layout::resident).
template <int MT, bool RES>
__global__ void __launch_bounds__(THREADS, 1) q4_matmul_decode_kernel(
    const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap p_map,
    const __grid_constant__ CUtensorMap s_map, __nv_bfloat16* __restrict__ out, int M, int N, int G, int splits,
    int cpb) {
  constexpr int ROWS = 8 * MT, X_BYTES = ROWS * GROUP * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the 128-byte swizzle repeats every 1024 bytes
  uint8_t* gbase = smem_raw + (base - raw);
  const int rank = (int)cluster_rank();  // blockIdx.x % splits
  const int n0 = blockIdx.x / splits * cpb * CHUNK;
  const int chunks = min(cpb, (N - n0 + CHUNK - 1) / CHUNK);
  const int g0 = rank * G / splits, ng = (rank + 1) * G / splits - g0;  // groups differ by at most one
  const Layout L = layout(ROWS, (G + splits - 1) / splits, cpb, splits);
  const uint32_t full = base + L.bar_off, empty = full + 8 * RING, sum_full = empty + 8 * RING;
  const uint32_t x_full = sum_full + 8;
  const int part_bytes = cpb * ROWS * CHUNK * 4;  // a rank's partials of the tile in rank 0's shared memory
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    // full: the producer's expect_tx, completed by TMA's bytes; empty: lane
    // 0 of each warp of the stage's set when it is done with it; x_full: one
    // resident x tile each, completed once; sum_full (rank 0 of a split
    // tile): the other ranks' partials, completed by their bytes.
    for (int s = 0; s < RING; ++s) mbar_init(full + 8 * s, 1), mbar_init(empty + 8 * s, SLICES);
    if (RES)
      for (int i = 0; i < ng; ++i) mbar_init(x_full + 8 * i, 1);
    if (splits > 1 && rank == 0) {
      mbar_init(sum_full, 1);
      mbar_expect_tx(sum_full, (splits - 1) * chunks * ROWS * CHUNK * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // Every thread of the cluster arrives now and waits before it first
  // writes to rank 0 or exits: rank 0's barrier is set up before any
  // partial reaches it.
  if (splits > 1) cluster_arrive_relaxed();

  if (warp == CONSUMERS) {
    if (lane == 0) {  // the producer: stage t is group i of chunk c
      for (int c = 0; c < chunks; ++c) {
        for (int i = 0; i < ng; ++i) {
          const int t = c * ng + i, s = t % RING;
          if (t >= RING) mbar_wait(empty + 8 * s, (t / RING - 1) & 1);
          const uint32_t bar = full + 8 * s;
          // x's tile of the group: with the stage (one expect_tx for all its
          // bytes), or once, on its own barrier
          const uint32_t xbar = RES ? x_full + 8 * i : bar;
          const uint32_t xs = base + L.x_off + (RES ? i : s) * X_BYTES;
          if (RES && c == 0) mbar_expect_tx(xbar, X_BYTES);
          mbar_expect_tx(bar, P_BYTES + S_BYTES + (RES ? 0 : X_BYTES));
          if (!RES || c == 0) {
            tma_load_2d(xs, &x_map, xbar, (g0 + i) * GROUP, 0);
            tma_load_2d(xs + X_BYTES / 2, &x_map, xbar, (g0 + i) * GROUP + 64, 0);
          }
          tma_load_2d(base + s * P_BYTES, &p_map, bar, n0 + c * CHUNK, (g0 + i) * (GROUP / 2));
          tma_load_2d(base + L.s_off + s * S_BYTES, &s_map, bar, n0 + c * CHUNK, g0 + i);
        }
      }
    }
  } else {
    // Warp (set, slice): the slice's 16 columns of each chunk (its A rows,
    // permuted) in the stages of set's parity (group i of a chunk for
    // i % 2 == set): the two sets of eight warps work on two stages at once.
    const int slice = warp % SLICES, set = warp / SLICES;
    const int col = 16 * slice;
    // ldmatrix rows: lane l gives packed row l (then 32 + l), in the
    // swizzled position of the slice's 16-byte chunk.
    const uint32_t ld = base + lane * 128 + ((slice ^ (lane & 7)) << 4);
    const float* scale_of = reinterpret_cast<const float*>(gbase + L.s_off) + col + 2 * (lane / 4);
    const uint32_t x_base = base + L.x_off;
    // x's B fragments: lane l gives row l % 8 (+ 8 for the second n8 tile)
    // of k-chunk (8 values) 4 jj + l / 8, i.e. (b0, b1) of steps 2 jj and
    // 2 jj + 1; the 128-byte swizzle by the row.
    uint32_t x_ld[4][MT];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int tt = 0; tt < MT; ++tt) {
        const int q = 4 * jj + lane / 8, row = lane % 8 + 8 * tt;
        x_ld[jj][tt] = (q / 8) * (X_BYTES / 2) + row * 128 + (((q % 8) ^ (row & 7)) << 4);
      }
    }
    for (int c = 0; c < chunks; ++c) {
      float acc[2][MT][4] = {};  // even and odd k16 steps: two chains of products
      for (int i = set; i < ng; i += 2) {
        const uint32_t t = c * ng + i, s = t % RING;
        mbar_wait(full + 8 * s, (t / RING) & 1);
        // The group's A fragments: a[j] for its K rows 16 j.. (j < 4 low
        // nibbles, j >= 4 high nibbles); ldmatrix matrix q holds K rows
        // 8 q.. of the low half, the first (q even) or second 8 of step q / 2.
        uint32_t r[2][4], a[8][4], b[4][MT][4];
        ldmatrix_x4_trans(r[0], ld + s * P_BYTES);
        ldmatrix_x4_trans(r[1], ld + s * P_BYTES + 32 * 128);
        if (RES) mbar_wait(x_full + 8 * i, 0);
        const uint32_t X = x_base + (RES ? i : s) * X_BYTES;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int tt = 0; tt < MT; ++tt) ldmatrix_x4(b[jj][tt], X + x_ld[jj][tt]);
        const float2 sc = *reinterpret_cast<const float2*>(scale_of + s * CHUNK);
        // column 2c's scale for nibbles at bits 0 and 4, 2c + 1's at bits 8 and 12
        const float scales[4] = {sc.x, sc.x * 0x1p-4f, sc.y * 0x1p-8f, sc.y * 0x1p-12f};
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int j = q / 2, h = 2 * (q % 2);
          dequant_reg(r[q / 4][q % 4], scales, a[j][h], a[j][h + 1], a[j + 4][h], a[j + 4][h + 1]);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
          for (int tt = 0; tt < MT; ++tt) {
            mma_bf16(acc[0][tt], a[2 * jj], b[jj][tt][0], b[jj][tt][1]);
            mma_bf16(acc[1][tt], a[2 * jj + 1], b[jj][tt][2], b[jj][tt][3]);
          }
        }
        __syncwarp();  // the products have read the stage's x tile
        if (lane == 0) mbar_arrive(empty + 8 * s);
      }
      // The slice's two sets: set 1 hands its sums to set 0, through one of
      // two buffers (a chunk's, and the next's, in flight); the sums add
      // in a fixed order.
      float* xch = reinterpret_cast<float*>(gbase + L.xch_off) + (c & 1) * SLICES * 32 * ROWS / 2 + slice * 32 + lane;
      if (set == 1) {
#pragma unroll
        for (int tt = 0; tt < MT; ++tt)
#pragma unroll
          for (int e = 0; e < 4; ++e) xch[(4 * tt + e) * SLICES * 32] = acc[0][tt][e] + acc[1][tt][e];
      }
      named_sync(1, 32 * CONSUMERS);
      if (set == 1) continue;
      float sum[MT][4];
#pragma unroll
      for (int tt = 0; tt < MT; ++tt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[tt][e] = (acc[0][tt][e] + acc[1][tt][e]) + xch[(4 * tt + e) * SLICES * 32];
      // Accumulator e of tile tt: A row lane / 4 + 8 (e / 2), i.e. column
      // col + 2 (lane / 4) + e / 2, and x row 8 tt + 2 (lane % 4) + e % 2:
      // each thread writes column pairs. A split tile's partials go to
      // rank 0's shared memory (rank r's at r * part_bytes), rank 0's own
      // locally, the others' by st.async onto rank 0's sum_full.
      if (splits > 1 && rank != 0 && c == 0) cluster_wait();
      const int cc = col + 2 * (lane / 4), n = n0 + c * CHUNK + cc;
#pragma unroll
      for (int tt = 0; tt < MT; ++tt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = 8 * tt + 2 * (lane % 4) + e;
          const uint32_t part = base + L.part_off + rank * part_bytes + ((c * ROWS + m) * CHUNK + cc) * 4;
          if (splits == 1) {
            if (m < M && n < N)
              *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * N + n) =
                  __floats2bfloat162_rn(sum[tt][e], sum[tt][2 + e]);
          } else if (rank == 0) {
            *reinterpret_cast<float2*>(gbase + (part - base)) = make_float2(sum[tt][e], sum[tt][2 + e]);
          } else {
            st_async_f2(cluster_map(part, 0), sum[tt][e], sum[tt][2 + e], cluster_map(sum_full, 0));
          }
        }
      }
    }
    if (splits > 1 && rank == 0 && set == 0) {
      // The tile's outputs as column pairs (chunk, row, pair), each summed
      // over the ranks in rank order by set 0 of rank 0.
      named_sync(2, 32 * SLICES);  // rank 0's own partials are written
      mbar_wait_cluster(sum_full, 0);
      const int pairs = chunks * M * (CHUNK / 2);
      for (int p = threadIdx.x; p < pairs; p += 32 * SLICES) {
        const int c = p / (M * CHUNK / 2), m = p / (CHUNK / 2) % M, cp = 2 * (p % (CHUNK / 2));
        const int n = n0 + c * CHUNK + cp;
        if (n >= N) continue;
        const float* part = reinterpret_cast<const float*>(gbase + L.part_off) + (c * ROWS + m) * CHUNK + cp;
        float2 sum = *reinterpret_cast<const float2*>(part);
        for (int q = 1; q < splits; ++q) {
          const float2 v = *reinterpret_cast<const float2*>(part + q * part_bytes / 4);
          sum.x += v.x;
          sum.y += v.y;
        }
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * N + n) = __floats2bfloat162_rn(sum.x, sum.y);
      }
    }
  }
  // Each thread's wait of the cluster barrier it arrived at (the partials'
  // writers, set 0 of the other ranks, have waited already).
  if (splits > 1 && !(warp < SLICES && rank != 0)) cluster_wait();
}

// The launch: a cluster of `splits` blocks a column tile.
template <int MT>
cudaLaunchConfig_t config(int N, int C, int bn, int splits, cudaStream_t stream, cudaLaunchAttribute* attr) {
  const int cpb = bn / CHUNK, tiles = ((N + CHUNK - 1) / CHUNK + cpb - 1) / cpb;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = splits;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = layout(8 * MT, (C / GROUP + splits - 1) / splits, cpb, splits).total;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int MT, bool RES>
int launch(const void* x, const void* packed, const void* scale, void* out, int M, int N, int C, int bn,
           int splits, cudaStream_t stream) {
  auto kernel = q4_matmul_decode_kernel<MT, RES>;
  static bool configured = false;
  cudaError_t err = allow_smem(kernel, MAX_SMEM, configured);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<MT>(N, C, bn, splits, stream, &attr);
  if (cfg.dynamicSmemBytes > (size_t)MAX_SMEM) return -1;
  CUtensorMap x_map, p_map, s_map;
  const int G = C / GROUP;
  if (!make_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, C, M, (uint64_t)C * 2, 64, 8 * MT,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&p_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, packed, N, C / 2, N, CHUNK, GROUP / 2,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&s_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scale, N, G, (uint64_t)N * 4, CHUNK, 1,
                CU_TENSOR_MAP_SWIZZLE_NONE))
    return -3;
  err = cudaLaunchKernelEx(&cfg, kernel, x_map, p_map, s_map, static_cast<__nv_bfloat16*>(out), M, N, G, splits,
                           bn / CHUNK);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

bool takes(int M, int N, int C, int block, int bn, int splits) {
  return block == GROUP && M >= 1 && M <= 16 && N >= 16 && N % 16 == 0 && C >= GROUP && C % GROUP == 0 &&
         bn >= CHUNK && bn % CHUNK == 0 && splits >= 1 && splits <= MAX_SPLITS && splits <= C / GROUP;
}

}  // namespace
}  // namespace substratus

// x [M, C] bf16, packed [C/2, N] uint8, scale [C/128, N] f32, out [M, N]
// bf16, all contiguous and 16-byte aligned; bn columns a block (a multiple
// of 128) and `splits` splits of the groups (ops/quant4.py::
// q4_decode_plan). -1, launching nothing, for a shape this design does not
// take (ops/quant4.py::q4_design routes those elsewhere) or a plan whose
// shared memory does not fit; -3 when the driver gives no tensor map.
extern "C" int q4_matmul_decode(const void* x, const void* packed, const void* scale, void* out, int M, int N,
                                int C, int block, int bn, int splits, void* stream) {
  using namespace substratus;
  if (!takes(M, N, C, block, bn, splits)) return -1;
  if (((uintptr_t)x | (uintptr_t)packed | (uintptr_t)scale | (uintptr_t)out) % 16 != 0) return -1;
  if (encode_tiled() == nullptr) return -3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn > CHUNK)
    return M <= 8 ? launch<1, true>(x, packed, scale, out, M, N, C, bn, splits, s)
                  : launch<2, true>(x, packed, scale, out, M, N, C, bn, splits, s);
  return M <= 8 ? launch<1, false>(x, packed, scale, out, M, N, C, bn, splits, s)
                : launch<2, false>(x, packed, scale, out, M, N, C, bn, splits, s);
}

// How many clusters of `splits` blocks, each with `smem` bytes of dynamic
// shared memory, the card runs at once (cudaOccupancyMaxActiveClusters), for
// x of M rows; ops/quant4.py::cluster_capacity asks it for q4_decode_plan.
// A cluster's blocks share a GPC. -1 for arguments out of range.
extern "C" int q4_matmul_decode_clusters(int M, int splits, int smem) {
  using namespace substratus;
  if (M < 1 || M > 16 || splits < 1 || splits > MAX_SPLITS || smem < 0 || smem > MAX_SMEM) return -1;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = splits;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits * 1024);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  cudaError_t err;
  if (M <= 8) {
    static bool configured = false;
    err = allow_smem(q4_matmul_decode_kernel<1, false>, MAX_SMEM, configured);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, q4_matmul_decode_kernel<1, false>, &cfg);
  } else {
    static bool configured = false;
    err = allow_smem(q4_matmul_decode_kernel<2, false>, MAX_SMEM, configured);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, q4_matmul_decode_kernel<2, false>, &cfg);
  }
  return err == cudaSuccess ? n : -(int)err;
}
