// Flash-attention backward for Hopper (sm_90a) at head_dim 64 and 128:
// dQ and dK/dV from the forward's row logsumexp, the same functions as
// flash_bwd.cu's kernels (which keep head_dim 16 and 32), redesigned on
// wgmma and TMA.
//
// Replaces the TPU kernels substratus_tpu/ops/flash_attention.py
// _bwd_dq_kernel (flash_bwd_dq_wgmma_kernel) and _bwd_dkv_kernel
// (flash_bwd_dkv_wgmma_kernel), the training backward of every attention
// layer; ops/flash_attention.py::flash_bwd_design routes a call here by
// head_dim alone.
//
// Layout and math as flash_bwd.cu: q, dO [B, Sq, H, D], k, v [B, Sk, KH,
// D] bf16, contiguous; lse and delta [B*H, Sq] f32; query head h reads kv
// head h / (H / KH). s = (q . k) scale in f32; p = exp(s - lse), 0 where
// not live (col <= row under causal, inside the ragged edges); dp = dO . v;
// ds = p (dp - delta) scale; p and ds rounded to bf16 before their
// products, f32 accumulation, outputs rounded once to bf16. p is computed
// as exp2(s scale log2(e) - lse log2(e)).
//
// Bound on an H100 (SXM, 989 TFLOP/s bf16, 3.35 TB/s) at the llama2-7b
// training shape (B=8, S=1024, H=KH=32, D=128, causal): dQ runs three
// products over the causal half (103 GFLOP, 0.104 ms) against 0.34 GB
// (0.10 ms), dK/dV four (137 GFLOP, 0.139 ms) against 0.40 GB: both bound
// by operations. flash_bwd.cu's mma.sync kernels reached 12-13% of that:
// mma.sync cannot reach the bf16 rate on this card, and their loads were
// synchronous. Here every product is a wgmma, every tile arrives by TMA
// into a ring that a producer warpgroup keeps ahead of the products, and
// the score tiles never leave registers. Measured, these kernels reach
// about a third of the bound: each streams about 600 MB of tiles from L2
// into shared memory, and that time adds to the products' instead of
// hiding under it (tools/flash_bwd_probe.py, PERF.md).
//
// Design. A block has three warpgroups: two consumers of 64 rows each
// (wgmma's M) and a producer whose first warp keeps the ring full
// (setmaxnreg moves its registers to the consumers: 24 and 240 a thread).
// Tensor maps over [B, S, heads, D] as (D, heads, S, B), encoded on the
// host for each call, cut [rows, 64] boxes with the 128-byte swizzle:
// K-major operands as they lie, and MN-major (transposed) ones through
// the descriptor's transpose bit. TMA reads rows past S as zero; the
// masks row < Sq and key < Sk keep them out of p.
//  * dK/dV: one block per 128 keys of one kv head. K and V arrive once.
//    The ring carries (Q, dO) tiles of 64 rows with their 64 lse and
//    delta values (cp.async from the producer warp's 32 lanes: lse's rows
//    are not 16-byte aligned for TMA at every S), walking the kv head's G
//    query heads and, under causal masking, their q-tiles from the
//    diagonal on. Per tile each consumer computes S^T = K Q^T and
//    dP^T = V dO^T (both operands K-major in shared memory), turns them
//    into P^T and dS^T, rounds them into register A fragments (the m64
//    accumulator layout is the k16 A layout), and accumulates
//    dV += P^T dO and dK += dS^T Q with dO and Q read MN-major. dK and dV
//    stay in registers until one bf16 store: the GQA group is summed in
//    the block, with no atomics and no f32 scratch.
//  * dQ: one block per 128 query rows of one head. Q and dO arrive once;
//    the ring carries (K, V) tiles of 64 keys up to the diagonal. Per
//    tile: S = Q K^T and dP = dO V^T, then dQ += dS K with K read
//    MN-major.
//  * Two kernels rather than one that adds dQ with atomics inside the
//    dK/dV loop: no f32 scratch and no third launch, sums in a fixed
//    order (deterministic), and each kernel the counterpart of one TPU
//    kernel.
//  * Work order: a one-dimensional grid walks the heads in chunks of
//    about one wave of blocks (block_work): in a chunk every head's
//    heaviest block under causal masking (dQ's last q-tile, dK/dV's first
//    k-tile), then every head's next, and so on. The blocks in flight
//    share a few heads' K and V (dQ) or Q and dO (dK/dV) in L2, and each
//    chunk starts with its heaviest blocks. Every head's block in flight
//    at once missed L2 (at KH = 32 the loads alone took 1.6 times as
//    long); a head's blocks together, heaviest first, started a GQA
//    head's heaviest dK/dV block in the last wave (1.5 times as long at
//    KH = 4).
//    substratus_tpu_torch/tools/flash_bwd_probe.py times these orders
//    and the kernels without their loads, products or exponentials
//    (PERF.md).
#include "hopper.cuh"

namespace substratus {
namespace {

constexpr int THREADS = 3 * WG;      // two consumer warpgroups and the producer
constexpr int TILE = 64;             // rows of a consumer (wgmma's M) and of a streamed tile
constexpr int BLOCK = 2 * TILE;      // keys (dK/dV) or query rows (dQ) of a block
constexpr int BOX = TILE * ROW;      // a [64, 64] box

// Shared memory of the dK/dV kernel: K and V of the block (NB boxes of
// [128, 64] each), then the ring of (Q, dO) tiles (NB boxes of [64, 64]
// each), then each stage's lse (times log2 e) and delta, then barriers.
template <int D>
struct DkvLayout {
  static constexpr int NB = D / 64;
  static constexpr int STAGES = D == 128 ? 4 : 8;
  static constexpr int kv_bytes = BLOCK * D * 2;
  static constexpr int tile_bytes = TILE * D * 2;
  static constexpr int k_off = 0;
  static constexpr int v_off = kv_bytes;
  static constexpr int q_off = 2 * kv_bytes;  // stage s: Q at q_off + 2 s tile_bytes, dO after it
  static constexpr int stat_off = q_off + STAGES * 2 * tile_bytes;
  static constexpr int bar_off = stat_off + STAGES * 2 * TILE * 4;
  // full and empty barriers of the ring, K/V's, + slack to align the base to 1024
  static constexpr int total = bar_off + 8 * (2 * STAGES + 1) + 1024;
};

// Shared memory of the dQ kernel: Q and dO of the block (NB boxes of
// [128, 64] each), then the ring of (K, V) tiles, then barriers.
template <int D>
struct DqLayout {
  static constexpr int NB = D / 64;
  static constexpr int STAGES = D == 128 ? 4 : 8;
  static constexpr int q_bytes = BLOCK * D * 2;
  static constexpr int tile_bytes = TILE * D * 2;
  static constexpr int q_off = 0;
  static constexpr int do_off = q_bytes;
  static constexpr int k_off = 2 * q_bytes;  // stage s: K at k_off + 2 s tile_bytes, V after it
  static constexpr int bar_off = k_off + STAGES * 2 * tile_bytes;
  static constexpr int total = bar_off + 8 * (2 * STAGES + 1) + 1024;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int H, int KH, float scale, int causal, int chunk) {
  using L = DkvLayout<D>;
  constexpr int NB = L::NB, ST = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the 128-byte swizzle repeats every 1024 bytes
  const float* stats = reinterpret_cast<const float*>(smem_raw + (base - raw) + L::stat_off);
  const uint32_t full = base + L::bar_off, empty = full + 8 * ST, kv_full = empty + 8 * ST;

  int rank, bkh;
  block_work((Sk + BLOCK - 1) / BLOCK, chunk, rank, bkh);
  const int b = bkh / KH, kvh = bkh % KH, G = H / KH;
  const int k0 = rank * BLOCK;  // k-tile 0 is the heaviest: under causal masking every query row meets it
  const int q_begin = causal ? k0 : 0;  // query rows before k0 attend none of the block's keys
  const int n_q = Sq > q_begin ? (Sq - q_begin + TILE - 1) / TILE : 0;
  const int n_tiles = G * n_q;

  if (threadIdx.x == 0) {
    // full: the TMA thread's expect_tx and the cp.asyncs of the 32 lanes
    // that bring the stage's lse and delta; empty: lane 0 of each of the
    // eight consumer warps when it is done with a stage.
    for (int s = 0; s < ST; ++s) mbar_init(full + 8 * s, 33), mbar_init(empty + 8 * s, 8);
    mbar_init(kv_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 2 * WG) {
    setmaxnreg_dec<24>();
    if (threadIdx.x < 2 * WG + 32) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * L::kv_bytes);
        for (int j = 0; j < NB; ++j) {
          tma_load_4d(base + L::k_off + j * BLOCK * ROW, &k_map, kv_full, 64 * j, kvh, k0, b);
          tma_load_4d(base + L::v_off + j * BLOCK * ROW, &v_map, kv_full, 64 * j, kvh, k0, b);
        }
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % ST, hq = kvh * G + t / n_q, q0 = q_begin + (t % n_q) * TILE;
        if (t >= ST) mbar_wait(empty + 8 * s, (t / ST - 1) & 1);
        const uint32_t bar = full + 8 * s, qs = base + L::q_off + s * 2 * L::tile_bytes;
        if (lane == 0) {
          mbar_expect_tx(bar, 2 * L::tile_bytes);
          for (int j = 0; j < NB; ++j) {
            tma_load_4d(qs + j * BOX, &q_map, bar, 64 * j, hq, q0, b);
            tma_load_4d(qs + L::tile_bytes + j * BOX, &do_map, bar, 64 * j, hq, q0, b);
          }
        }
        // lse and delta of the tile's rows (lse's rows are not 16-byte
        // aligned for TMA at every Sq); rows past Sq (masked) read 0.
        const size_t row = ((size_t)b * H + hq) * Sq;
        const uint32_t st = base + L::stat_off + s * 2 * TILE * 4;
        for (int i = lane; i < TILE; i += 32) {
          const int n = q0 + i < Sq ? 4 : 0;
          cp_async_4(st + 4 * i, lse + row + (n ? q0 + i : 0), n);
          cp_async_4(st + 4 * (TILE + i), delta + row + (n ? q0 + i : 0), n);
        }
        cp_async_mbar_arrive(bar);
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int wg = threadIdx.x / WG, warp = (threadIdx.x % WG) / 32, lane = threadIdx.x % 32;
    const int t4 = lane % 4;
    const int key_lo = k0 + wg * TILE;                 // the consumer's 64 keys
    const int key0 = key_lo + warp * 16 + lane / 4;    // this thread's rows of S^T: key0, key0 + 8
    const float scale_log2 = scale * LOG2E;
    const uint32_t ks = base + L::k_off + wg * BOX, vs = base + L::v_off + wg * BOX;
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    mbar_wait(kv_full, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % ST, q0 = q_begin + (t % n_q) * TILE;
      // Under causal masking a q-tile that ends before the consumer's
      // first key holds no live entry (the diagonal tile of consumer 1).
      const bool live = !causal || q0 + TILE > key_lo;
      mbar_wait(full + 8 * s, (t / ST) & 1);
      const uint32_t qs = base + L::q_off + s * 2 * L::tile_bytes, dos = qs + L::tile_bytes;
      const float* st = stats + s * 2 * TILE;
      if (live) {
        // Four commit groups, each waited for only when its result is
        // needed: p is computed under dP^T's products, dS under dV's.
        float sacc[TILE / 2], dpacc[TILE / 2];
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < D / 16; ++j)  // S^T = K Q^T
          wgmma_ss(sacc, kmajor(ks, BLOCK * ROW, j), kmajor(qs, BOX, j), j > 0);
        wgmma_commit();
#pragma unroll
        for (int j = 0; j < D / 16; ++j)  // dP^T = V dO^T
          wgmma_ss(dpacc, kmajor(vs, BLOCK * ROW, j), kmajor(dos, BOX, j), j > 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sacc);

        // Column (query row) q0 + 8 j + 2 t4 + e % 2 of accumulator 4 j + e,
        // key key0 + 8 (e / 2).
        const bool edge = (causal && q0 < key_lo + TILE) || q0 + TILE > Sq || key_lo + TILE > Sk;
#pragma unroll
        for (int j = 0; j < TILE / 8; ++j) {
          const float2 l2 = *reinterpret_cast<const float2*>(st + 8 * j + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            float p = exp2f(sacc[i] * scale_log2 - (e & 1 ? l2.y : l2.x) * LOG2E);
            if (edge) {
              const int key = key0 + 8 * (e / 2), qr = q0 + 8 * j + 2 * t4 + (e & 1);
              if (!(key < Sk && qr < Sq && (!causal || key <= qr))) p = 0.f;
            }
            sacc[i] = p;  // P^T
          }
        }
        uint32_t pa[TILE / 16][4], dsa[TILE / 16][4];
        to_a(pa, sacc);
        fence_regs(pa);
        fence_regs(dv_acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk)  // dV += P^T dO
          wgmma_rs<1>(dv_acc, pa[kk], mnmajor(dos, BOX, kk), 1);
        wgmma_commit();
        wgmma_wait<1>();  // dP^T (the groups complete in order)
        fence_regs(dpacc);

#pragma unroll
        for (int j = 0; j < TILE / 8; ++j) {
          const float2 dl = *reinterpret_cast<const float2*>(st + TILE + 8 * j + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            dpacc[i] = sacc[i] * (dpacc[i] - (e & 1 ? dl.y : dl.x)) * scale;  // dS^T
          }
        }
        to_a(dsa, dpacc);
        fence_regs(dsa);
        fence_regs(dk_acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk)  // dK += dS^T Q
          wgmma_rs<1>(dk_acc, dsa[kk], mnmajor(qs, BOX, kk), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        fence_regs(pa);
        fence_regs(dsa);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    const size_t stride = (size_t)KH * D, off = ((size_t)b * Sk * KH + kvh) * D;
    store_acc<D>(dk + off, stride, key0, Sk, dk_acc, t4);
    store_acc<D>(dv + off, stride, key0, Sk, dv_acc, t4);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int Sq,
    int Sk, int H, int KH, float scale, int causal, int chunk) {
  using L = DqLayout<D>;
  constexpr int NB = L::NB, ST = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t full = base + L::bar_off, empty = full + 8 * ST, q_full = empty + 8 * ST;

  const int n_qt = (Sq + BLOCK - 1) / BLOCK;
  int rank, bh;
  block_work(n_qt, chunk, rank, bh);
  const int b = bh / H, h = bh % H, kvh = h / (H / KH);
  const int q0 = (n_qt - 1 - rank) * BLOCK;  // the last q-tile is the heaviest under causal masking
  const int k_end = causal ? min(Sk, q0 + BLOCK) : Sk;
  const int n_tiles = (k_end + TILE - 1) / TILE;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) mbar_init(full + 8 * s, 1), mbar_init(empty + 8 * s, 8);
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 2 * WG) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 2 * WG) {
      mbar_expect_tx(q_full, 2 * L::q_bytes);
      for (int j = 0; j < NB; ++j) {
        tma_load_4d(base + L::q_off + j * BLOCK * ROW, &q_map, q_full, 64 * j, h, q0, b);
        tma_load_4d(base + L::do_off + j * BLOCK * ROW, &do_map, q_full, 64 * j, h, q0, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % ST;
        if (t >= ST) mbar_wait(empty + 8 * s, (t / ST - 1) & 1);
        const uint32_t bar = full + 8 * s, ks = base + L::k_off + s * 2 * L::tile_bytes;
        mbar_expect_tx(bar, 2 * L::tile_bytes);
        for (int j = 0; j < NB; ++j) {
          tma_load_4d(ks + j * BOX, &k_map, bar, 64 * j, kvh, t * TILE, b);
          tma_load_4d(ks + L::tile_bytes + j * BOX, &v_map, bar, 64 * j, kvh, t * TILE, b);
        }
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int wg = threadIdx.x / WG, warp = (threadIdx.x % WG) / 32, lane = threadIdx.x % 32;
    const int t4 = lane % 4;
    const int q_lo = q0 + wg * TILE;                 // the consumer's 64 query rows
    const int row0 = q_lo + warp * 16 + lane / 4;    // this thread's rows: row0, row0 + 8
    const float scale_log2 = scale * LOG2E;
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = row0 + 8 * r < Sq;
      lse_r[r] = in ? lse[(size_t)bh * Sq + row0 + 8 * r] * LOG2E : 0.f;
      delta_r[r] = in ? delta[(size_t)bh * Sq + row0 + 8 * r] : 0.f;
    }
    const uint32_t qs = base + L::q_off + wg * BOX, dos = base + L::do_off + wg * BOX;
    float dq_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
    mbar_wait(q_full, 0);

    // dQ += dS K of tile t stays in flight under tile t + 1's S and dP;
    // its stage is freed when it completes.
    uint32_t dsa[TILE / 16][4];
    int held = -1;  // the stage that dQ's product in flight reads
    auto release = [&](int stage) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * stage);
    };
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % ST, k0 = t * TILE;
      mbar_wait(full + 8 * s, (t / ST) & 1);
      // Under causal masking a k-tile that starts after the consumer's
      // last row holds no live entry (the diagonal tile of consumer 0).
      if (causal && k0 >= q_lo + TILE) {
        release(s);
        continue;
      }
      const uint32_t ks = base + L::k_off + s * 2 * L::tile_bytes, vs = ks + L::tile_bytes;
      float sacc[TILE / 2], dpacc[TILE / 2];
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < D / 16; ++j)  // S = Q K^T
        wgmma_ss(sacc, kmajor(qs, BLOCK * ROW, j), kmajor(ks, BOX, j), j > 0);
      wgmma_commit();
#pragma unroll
      for (int j = 0; j < D / 16; ++j)  // dP = dO V^T
        wgmma_ss(dpacc, kmajor(dos, BLOCK * ROW, j), kmajor(vs, BOX, j), j > 0);
      wgmma_commit();
      if (held >= 0) {
        wgmma_wait<2>();  // the previous tile's dQ product
        fence_regs(dsa);
        release(held);
      }
      wgmma_wait<1>();
      fence_regs(sacc);

      // Row row0 + 8 (e / 2) and key k0 + 8 j + 2 t4 + e % 2 of accumulator 4 j + e.
      const bool edge = (causal && k0 + TILE - 1 > q_lo) || k0 + TILE > Sk || q_lo + TILE > Sq;
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e, r = e / 2;
          float p = exp2f(sacc[i] * scale_log2 - lse_r[r]);
          if (edge) {
            const int row = row0 + 8 * r, key = k0 + 8 * j + 2 * t4 + (e & 1);
            if (!(row < Sq && key < Sk && (!causal || key <= row))) p = 0.f;
          }
          sacc[i] = p;
        }
      }
      wgmma_wait<0>();
      fence_regs(dpacc);
#pragma unroll
      for (int i = 0; i < TILE / 2; ++i) dpacc[i] = sacc[i] * (dpacc[i] - delta_r[(i / 2) % 2]) * scale;  // dS
      to_a(dsa, dpacc);

      fence_regs(dsa);
      fence_regs(dq_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk)  // dQ += dS K
        wgmma_rs<1>(dq_acc, dsa[kk], mnmajor(ks, BOX, kk), 1);
      wgmma_commit();
      held = s;
    }
    wgmma_wait<0>();
    fence_regs(dq_acc);
    fence_regs(dsa);
    if (held >= 0) release(held);

    store_acc<D>(dq + ((size_t)b * Sq * H + h) * D, (size_t)H * D, row0, Sq, dq_acc, t4);
  }
}

// Each call encodes its four tensor maps on the host (the pointers change
// from call to call); chip_smoke.py prints the host time of a call beside
// that of flash_bwd.cu's, which encodes none (PERF.md).
template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* delta,
              void* dq, int B, int Sq, int Sk, int H, int KH, float scale, int causal, cudaStream_t stream) {
  constexpr int smem = DqLayout<D>::total;
  static bool configured = false;
  if (cudaError_t err = allow_smem(flash_bwd_dq_wgmma_kernel<D>, smem, configured)) return (int)err;
  CUtensorMap qm, km, vm, dom;
  if (!make_head_map(&qm, q, B, Sq, H, D, BLOCK) || !make_head_map(&dom, dout, B, Sq, H, D, BLOCK) ||
      !make_head_map(&km, k, B, Sk, KH, D, TILE) || !make_head_map(&vm, v, B, Sk, KH, D, TILE))
    return -3;
  const int tiles = (Sq + BLOCK - 1) / BLOCK;
  flash_bwd_dq_wgmma_kernel<D><<<tiles * B * H, THREADS, smem, stream>>>(
      qm, km, vm, dom, lse, delta, static_cast<__nv_bfloat16*>(dq), Sq, Sk, H, KH, scale, causal,
      head_chunk(tiles));
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dk, void* dv, int B, int Sq, int Sk, int H, int KH, float scale,
               int causal, cudaStream_t stream) {
  constexpr int smem = DkvLayout<D>::total;
  static bool configured = false;
  if (cudaError_t err = allow_smem(flash_bwd_dkv_wgmma_kernel<D>, smem, configured)) return (int)err;
  CUtensorMap qm, km, vm, dom;
  if (!make_head_map(&qm, q, B, Sq, H, D, TILE) || !make_head_map(&dom, dout, B, Sq, H, D, TILE) ||
      !make_head_map(&km, k, B, Sk, KH, D, BLOCK) || !make_head_map(&vm, v, B, Sk, KH, D, BLOCK))
    return -3;
  const int tiles = (Sk + BLOCK - 1) / BLOCK;
  flash_bwd_dkv_wgmma_kernel<D><<<tiles * B * KH, THREADS, smem, stream>>>(
      qm, km, vm, dom, lse, delta, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), Sq, Sk, H,
      KH, scale, causal, head_chunk(tiles));
  return (int)cudaGetLastError();
}

// -1 for shapes this design does not take, -3 for a dtype other than
// bf16 or when the driver gives no tensor map.
int check_args(int B, int Sq, int Sk, int H, int KH, int dtype, const void* const* ptrs, int n) {
  if (B < 1 || Sq < 1 || Sk < 1 || KH < 1 || H % KH != 0) return -1;
  if ((int64_t)B * H * (((Sq > Sk ? Sq : Sk) + BLOCK - 1) / BLOCK) > INT32_MAX) return -1;  // grid.x limit
  for (int i = 0; i < n; ++i)
    if ((uintptr_t)ptrs[i] % 16 != 0) return -1;
  if (dtype != kBF16 || encode_tiled() == nullptr) return -3;
  return 0;
}

}  // namespace
}  // namespace substratus

// The C interface of flash_bwd.cu's flash_bwd_dq / flash_bwd_dkv, for
// head_dim 64 and 128 (-2 for any other).
extern "C" int flash_bwd_dq_wgmma(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                  const void* delta, void* dq, int B, int Sq, int Sk, int H, int KH, int D,
                                  int dtype, float scale, int causal, void* stream) {
  using namespace substratus;
  const void* ptrs[] = {q, k, v, dout};
  if (int rc = check_args(B, Sq, Sk, H, KH, dtype, ptrs, 4)) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (D) {
    case 64:
      return launch_dq<64>(q, k, v, dout, l, dl, dq, B, Sq, Sk, H, KH, scale, causal, s);
    case 128:
      return launch_dq<128>(q, k, v, dout, l, dl, dq, B, Sq, Sk, H, KH, scale, causal, s);
    default:
      return -2;
  }
}

extern "C" int flash_bwd_dkv_wgmma(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                   const void* delta, void* dk, void* dv, int B, int Sq, int Sk, int H, int KH,
                                   int D, int dtype, float scale, int causal, void* stream) {
  using namespace substratus;
  const void* ptrs[] = {q, k, v, dout};
  if (int rc = check_args(B, Sq, Sk, H, KH, dtype, ptrs, 4)) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (D) {
    case 64:
      return launch_dkv<64>(q, k, v, dout, l, dl, dk, dv, B, Sq, Sk, H, KH, scale, causal, s);
    case 128:
      return launch_dkv<128>(q, k, v, dout, l, dl, dk, dv, B, Sq, Sk, H, KH, scale, causal, s);
    default:
      return -2;
  }
}
