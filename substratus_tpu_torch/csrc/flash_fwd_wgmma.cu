// Flash-attention forward and cached flash attention for Hopper (sm_90a)
// at head_dim 64 and 128, over a bf16 or an int8 cache: the functions of
// flash_fwd.cu and flash_cached.cu (which keep head_dim 16 and 32),
// redesigned on wgmma and TMA.
//
// Replaces the TPU kernels substratus_tpu/ops/flash_attention.py
// _flash_kernel (flash_fwd_wgmma_kernel<D, false, false>: the prefill of
// the serving path and the forward and recompute of every training step)
// and _cached_kernel (flash_fwd_wgmma_kernel<D, true, INT8>: every chunk
// of a chunked prefill); ops/flash_attention.py's
// flash_fwd_design and flash_cached_design route a call here.
//
// Layout and math as the two sources it redesigns. Forward: q [B, Sq, H,
// D], k, v [B, Sk, KH, D], o [B, Sq, H, D] bf16, contiguous; lse
// (optional) [B*H, Sq] f32; row r attends keys 0..Sk-1, or 0..r under
// causal masking. Cached: k, v the slot cache [B, KH, Sk, D] bf16, or int8
// with f32 scales [B, KH, Sk] (k_scale multiplies the score after the dot,
// v_scale p after l has summed it and before the bf16 rounding); row r
// of batch b attends cache rows 0..min(pos[b, r], kv_len[b] - 1), and a
// row whose limit is negative outputs exactly 0. Query head h reads kv
// head h / (H / KH). s = q . k in f32; p = exp(scale (s - m)) computed as
// exp2(s scale log2(e) - m scale log2(e)) with m the running row max; l
// sums the f32 p; p is rounded to bf16 before the PV product; out = acc /
// l (l == 0 -> 1), rounded once to bf16; lse = m scale + log(l), or -1e30
// for a row with nothing live.
//
// Bound on an H100 (SXM, 989 TFLOP/s bf16, 3.35 TB/s): the llama2-7b
// prefill (B=1, S=512, H=32, D=128, causal) moves 16.8 MB against 2.2
// GFLOP, bound by the bytes (5 us); one training layer (B=8, S=1024) 268
// MB against 69 GFLOP, bound by the bytes too (80 us; the operations 70); a
// 512-token chunk at positions 2048..2559 of a 4096-row cache 19 GFLOP
// against 42 MB of live cache rows, bound by the operations (20 us).
// flash_fwd.cu and flash_cached.cu loaded every tile synchronously and
// ran mma.sync, which cannot reach the bf16 rate on this card; at 64
// query rows a block they read each K/V tile once per 64 rows.
//
// Design. A block has two consumer warpgroups of 64 query rows each
// (wgmma's M: 128 rows a block) and a producer warpgroup whose first
// thread keeps a three-stage ring of (K, V) tiles of 128 keys full by TMA
// (setmaxnreg moves its registers to the consumers: 24 and 240 a thread).
// Q arrives once by TMA and stays in shared memory as the
// K-major A operand of S = Q K^T (ptxas reused the registers of a
// long-lived register operand in the flash backward). Per tile each
// consumer computes S = Q K^T (m64n128, both operands K-major in shared
// memory), the online softmax in registers over the m64 accumulator
// layout (each row's max and sum across the four lanes that share it; the
// sum's cross-lane reduction once, at the end), rounds p into register-A
// fragments (the m64 accumulator layout is the k16 A layout), and runs
// O += P V with V read MN-major through the descriptor's transpose bit.
// Tile t's score product and tile t-1's PV product are issued together,
// and the softmax of tile t runs while the PV product is in flight
// (wgmma.wait_group 1): one warpgroup overlaps its exponentials with its
// own tensor-core work; the two consumers never take turns.
//  * Masks. Tensor maps over [B, S, heads, D] as (D, heads, S, B) (cached:
//    [B, KH, S, D] as (D, S, KH, B)) with the 128-byte swizzle read rows
//    past S as zero, whose score is 0, not -1e30: each row's limit
//    (forward: min(row, Sk - 1) under causal masking, else Sk - 1;
//    cached: min(pos, kv_len - 1, Sk - 1), -1 past Sq) masks every key
//    past it, in the tiles that reach past the smallest limit of a
//    thread's two rows (under causal masking only the diagonal tile).
//  * Tiles past the block's largest limit are never loaded: under causal
//    masking the tiles above the diagonal, in the cached kernel every tile
//    past the largest limit of the block's rows (the TPU kernel's
//    dead-block skip). A consumer whose 64 rows all lie past Sq does no
//    work, and a block with no live row loads nothing.
//  * Work order: the one-dimensional grid walks the heads in chunks of
//    about one wave of blocks, each head's heaviest block (its last
//    q-tile) first (block_work, as in flash_bwd_wgmma.cu).
//  * The int8 cache: tiles of 64 rows. TMA brings the int8 tiles (rows of
//    D bytes, no swizzle) into a ring of their own, the producer warp's 32
//    lanes the stage's scales by cp.async (a scale row is not 16-byte
//    aligned for TMA at every Sk); the consumers convert each tile into
//    one of two bf16 buffers laid out as TMA lays out a bf16 tile (the
//    128-byte swizzle: 16-byte chunk c of row r at chunk c ^ (r % 8)),
//    each consumer half of it, exactly (|x| <= 127), between two named
//    barriers (the buffer's previous tile retired by both; the conversion
//    done by both, after a proxy fence for the products' async reads).
//    At 128-key tiles an int8 ring beside the bf16 buffers would not fit
//    in shared memory.
//  * No LSE in the cached kernel (its caller takes none).
//  * Measured (PERF.md): at B=8 S=1024 the loads alone (the consumers
//    free each stage at once) take two thirds of the kernel's time, and
//    the products add to them rather than hiding them. 64-row blocks (one
//    consumer), a two-stage ring and 64-key tiles were slower at the
//    serving and the training shape, and so were two remedies built and
//    taken out again: a cluster of two q-blocks sharing each K/V tile by
//    TMA multicast (the loads alone did not get faster) and a persistent
//    grid walking the items in a fixed order. Without exp2 the kernel is
//    6% faster; on [B, H, S, D] copies of q, k, v it is as fast as on the
//    activation layout. substratus_tpu_torch/tools/flash_bwd_probe.py
//    --forward builds the variants of this source and times them in
//    turns.
#include <type_traits>

#include "hopper.cuh"

namespace substratus {
namespace {

constexpr int NC = 2;     // consumer warpgroups of a block
constexpr int TILE = 64;  // query rows of a consumer warpgroup (wgmma's M)
constexpr int BLOCK = NC * TILE;  // query rows of a block
constexpr int KT = 128;   // keys of a streamed K/V tile (the score product's N)

// Shared memory: Q of the block (NB boxes of [BLOCK, 64]), then the ring
// of (K, V) tiles (NB boxes of [128, 64] each), then barriers.
template <int D>
struct FwdLayout {
  static constexpr int NB = D / 64;
  static constexpr int STAGES = D == 128 ? 3 : 4;
  static constexpr int q_bytes = BLOCK * D * 2;
  static constexpr int tile_bytes = KT * D * 2;  // one of K, V
  static constexpr int q_off = 0;
  static constexpr int k_off = q_bytes;  // stage s: K at k_off + 2 s tile_bytes, V after it
  static constexpr int bar_off = k_off + STAGES * 2 * tile_bytes;
  static constexpr int scale_off = 0;  // no scales
  // full and empty barriers of the ring, Q's, + slack to align the base to 1024
  static constexpr int total = bar_off + 8 * (2 * STAGES + 1) + 1024;
  static_assert(total + 4 * (BLOCK + BLOCK / 32) <= 232448, "shared memory of one block");
};

// The int8 cache: tiles of KT8 rows. Shared memory: Q, two bf16 (K, V)
// buffers the consumers convert the int8 tiles into (laid out as TMA lays
// out a bf16 tile), the ring of int8 (K, V) tiles as TMA writes them
// (rows of D bytes, no swizzle), each stage's k_scale and v_scale rows,
// then barriers.
constexpr int KT8 = 64;
template <int D>
struct Int8Layout {
  static constexpr int NB = D / 64;
  static constexpr int STAGES = 3;
  static constexpr int q_bytes = BLOCK * D * 2;
  static constexpr int tile_bytes = KT8 * D * 2;  // one bf16 tile
  static constexpr int raw_bytes = KT8 * D;       // one int8 tile
  static constexpr int q_off = 0;
  static constexpr int k_off = q_bytes;                           // buffer u: K at k_off + 2 u tile_bytes, V after
  static constexpr int raw_off = k_off + 4 * tile_bytes;          // stage s: K at raw_off + 2 s raw_bytes, V after
  static constexpr int scale_off = raw_off + STAGES * 2 * raw_bytes;  // stage s: KT8 k_scales, KT8 v_scales
  static constexpr int bar_off = scale_off + STAGES * 2 * KT8 * 4;
  static constexpr int total = bar_off + 8 * (2 * STAGES + 1) + 1024;
  static_assert(total + 4 * (BLOCK + BLOCK / 32) <= 232448, "shared memory of one block");
};

// Named barrier 1 over the consumer threads of a block.
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

template <int D, bool CACHED, bool INT8>
__global__ void __launch_bounds__((NC + 1) * WG, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
    const int* __restrict__ pos, const int* __restrict__ kv_len, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, int Sq, int Sk, int H, int KH, float scale, int causal, int chunk) {
  static_assert(CACHED || !INT8, "an int8 cache is the cached kernel's");
  using L = std::conditional_t<INT8, Int8Layout<D>, FwdLayout<D>>;
  constexpr int NB = L::NB, ST = L::STAGES, T = INT8 ? KT8 : KT;  // T: keys of a tile
  constexpr int BOX_T = T * ROW;  // a [T, 64] box of a bf16 K/V tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ int lim_s[CACHED ? BLOCK : 1];  // cached: each row's limit
  __shared__ int lim_w[BLOCK / 32];          // cached: each warp's largest
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the 128-byte swizzle repeats every 1024 bytes
  const uint32_t full = base + L::bar_off, empty = full + 8 * ST, q_full = empty + 8 * ST;

  const int n_qt = (Sq + BLOCK - 1) / BLOCK;
  int rank, bh;
  block_work(n_qt, chunk, rank, bh);
  const int b = bh / H, h = bh % H, kvh = h / (H / KH);
  const int q0 = (n_qt - 1 - rank) * BLOCK;  // the last q-tile is the heaviest
  const int active = min(NC, (Sq - q0 + TILE - 1) / TILE);  // consumers with a row before Sq

  if constexpr (CACHED) {
    if (threadIdx.x < BLOCK) {
      const int row = q0 + threadIdx.x;
      int lim = -1;
      if (row < Sq) {
        lim = pos[(size_t)b * Sq + row];
        if (kv_len != nullptr) lim = min(lim, kv_len[b] - 1);
      }
      lim = max(min(lim, Sk - 1), -1);
      lim_s[threadIdx.x] = lim;
      lim = __reduce_max_sync(0xffffffffu, lim);
      if (threadIdx.x % 32 == 0) lim_w[threadIdx.x / 32] = lim;
    }
  }
  if (threadIdx.x == 0) {
    // full: the TMA thread's expect_tx (int8: and the cp.asyncs of the 32
    // lanes that bring the stage's scales); empty: lane 0 of each active
    // consumer warp when it is done with a stage.
    for (int s = 0; s < ST; ++s) mbar_init(full + 8 * s, INT8 ? 33 : 1), mbar_init(empty + 8 * s, 4 * active);
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int k_end;  // keys the block's rows attend: 0..k_end-1
  if constexpr (CACHED) {
    int m = -1;
#pragma unroll
    for (int w = 0; w < BLOCK / 32; ++w) m = max(m, lim_w[w]);
    k_end = m + 1;
  } else {
    k_end = causal ? min(Sk, q0 + BLOCK) : Sk;
  }
  const int n_tiles = (k_end + T - 1) / T;

  if (threadIdx.x >= NC * WG) {
    if constexpr (NC == 2) setmaxnreg_dec<24>();  // NC = 1, a probe's variant, keeps 255 a thread
    const int lane = threadIdx.x % 32;
    // The first thread issues the loads; with an int8 cache its warp's 32
    // lanes also bring each stage's scales.
    if (threadIdx.x < NC * WG + (INT8 ? 32 : 1) && n_tiles > 0) {
      if (lane == 0) {
        mbar_expect_tx(q_full, L::q_bytes);
        for (int j = 0; j < NB; ++j) tma_load_4d(base + L::q_off + j * BLOCK * ROW, &q_map, q_full, 64 * j, h, q0, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % ST;
        if (t >= ST) mbar_wait(empty + 8 * s, (t / ST - 1) & 1);
        const uint32_t bar = full + 8 * s;
        if constexpr (INT8) {
          const uint32_t ks = base + L::raw_off + s * 2 * L::raw_bytes;
          if (lane == 0) {
            mbar_expect_tx(bar, 2 * L::raw_bytes);
            tma_load_4d(ks, &k_map, bar, 0, t * T, kvh, b);
            tma_load_4d(ks + L::raw_bytes, &v_map, bar, 0, t * T, kvh, b);
          }
          // The stage's scales (a scale row is not 16-byte aligned for
          // TMA at every Sk); keys past Sk read 0.
          const size_t row = ((size_t)b * KH + kvh) * Sk;
          const uint32_t st = base + L::scale_off + s * 2 * T * 4;
          for (int i = lane; i < T; i += 32) {
            const int key = t * T + i, n = key < Sk ? 4 : 0;
            cp_async_4(st + 4 * i, k_scale + row + (n ? key : 0), n);
            cp_async_4(st + 4 * (T + i), v_scale + row + (n ? key : 0), n);
          }
          cp_async_mbar_arrive(bar);
        } else if (lane == 0) {
          const uint32_t ks = base + L::k_off + s * 2 * L::tile_bytes;
          mbar_expect_tx(bar, 2 * L::tile_bytes);
          for (int j = 0; j < NB; ++j) {
            if constexpr (CACHED) {
              tma_load_4d(ks + j * BOX_T, &k_map, bar, 64 * j, t * T, kvh, b);
              tma_load_4d(ks + L::tile_bytes + j * BOX_T, &v_map, bar, 64 * j, t * T, kvh, b);
            } else {
              tma_load_4d(ks + j * BOX_T, &k_map, bar, 64 * j, kvh, t * T, b);
              tma_load_4d(ks + L::tile_bytes + j * BOX_T, &v_map, bar, 64 * j, kvh, t * T, b);
            }
          }
        }
      }
    }
  } else {
    if constexpr (NC == 2) setmaxnreg_inc<240>();
    const int wg = threadIdx.x / WG;
    if (wg < active) {
      const int warp = (threadIdx.x % WG) / 32, lane = threadIdx.x % 32, t4 = lane % 4;
      const int r_loc = wg * TILE + warp * 16 + lane / 4;  // this thread's rows in the block: r_loc, r_loc + 8
      const int row0 = q0 + r_loc;
      int lim[2];  // the last key each of the two rows attends
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if constexpr (CACHED)
          lim[r] = lim_s[r_loc + 8 * r];
        else
          lim[r] = causal ? min(row0 + 8 * r, Sk - 1) : Sk - 1;
      }
      const int lim_lo = min(lim[0], lim[1]);
      const float sl2 = scale * LOG2E;
      const uint32_t qs = base + L::q_off + wg * TILE * ROW;  // the consumer's 64 rows of each Q box
      const float* scales = reinterpret_cast<const float*>(smem_raw + (base - raw) + L::scale_off);  // int8

      float o_acc[D / 2], sacc[T / 2];
      uint32_t pa[T / 16][4];
      float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};  // l_run: this thread's share of the row sum
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;

      // The bf16 K of tile t (V after it): its ring stage, or (int8) the
      // buffer it was converted into.
      auto k_tile = [&](int t) {
        return base + L::k_off + (INT8 ? t % 2 : t % ST) * 2 * L::tile_bytes;
      };
      auto release = [&](int t) {  // this warp is done with tile t's stage
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * (t % ST));
      };
      // Wait for tile t; an int8 tile the consumers then convert, each
      // thread 8 values at a time, into buffer t % 2 (free: every consumer
      // retired tile t - 2's products before the first barrier).
      auto acquire = [&](int t) {
        mbar_wait(full + 8 * (t % ST), (t / ST) & 1);
        if constexpr (INT8) {
          constexpr int ROW8 = D / 8;  // 8-value units of a row
          const int threads = active * WG, me = threadIdx.x;
          const uint32_t src = base + L::raw_off + (t % ST) * 2 * L::raw_bytes, dst = k_tile(t);
          consumers_sync(threads);
          for (int u = me; u < 2 * T * ROW8; u += threads) {
            const int kv = u / (T * ROW8), r = u / ROW8 % T, c = u % ROW8;
            uint32_t w0, w1;
            asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                         : "=r"(w0), "=r"(w1)
                         : "r"(src + kv * L::raw_bytes + r * D + 8 * c));
            const int8_t* x0 = reinterpret_cast<const int8_t*>(&w0);
            const int8_t* x1 = reinterpret_cast<const int8_t*>(&w1);
            const uint32_t y0 = pack_bf16((float)x0[0], (float)x0[1]), y1 = pack_bf16((float)x0[2], (float)x0[3]);
            const uint32_t y2 = pack_bf16((float)x1[0], (float)x1[1]), y3 = pack_bf16((float)x1[2], (float)x1[3]);
            // Box c / 8, row r, 16-byte chunk c % 8 under the 128-byte swizzle.
            const uint32_t at = dst + kv * L::tile_bytes + (c / 8) * BOX_T + r * ROW + (((c % 8) ^ (r % 8)) << 4);
            asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(at), "r"(y0), "r"(y1), "r"(y2), "r"(y3)
                         : "memory");
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the products read it through the async proxy
          consumers_sync(threads);
        }
      };
      auto scores = [&](int t) {  // S = Q K^T of tile t, one commit group
#pragma unroll
        for (int j = 0; j < D / 16; ++j)
          wgmma_ss(sacc, kmajor(qs, BLOCK * ROW, j), kmajor(k_tile(t), BOX_T, j), j > 0);
        wgmma_commit();
      };
      auto pv = [&](int t) {  // O += P V of tile t, one commit group
#pragma unroll
        for (int kk = 0; kk < T / 16; ++kk)
          wgmma_rs<1>(o_acc, pa[kk], mnmajor(k_tile(t) + L::tile_bytes, BOX_T, kk), 1);
        wgmma_commit();
      };
      // The masks and the online softmax of tile t in sacc: p in place, the
      // running max and sums; alpha rescales O. Accumulator i is row
      // row0 + 8 ((i / 2) % 2), key t T + 8 (i / 4) + 2 t4 + i % 2. An int8
      // tile's k_scale multiplies the score after the dot.
      auto softmax = [&](int t, float (&alpha)[2]) {
        const int k0 = t * T;
        if constexpr (INT8) {
          const float* ks = scales + (t % ST) * 2 * T;
#pragma unroll
          for (int j = 0; j < T / 8; ++j) {
            const float2 kk = *reinterpret_cast<const float2*>(ks + 8 * j + 2 * t4);
            sacc[4 * j] *= kk.x, sacc[4 * j + 1] *= kk.y, sacc[4 * j + 2] *= kk.x, sacc[4 * j + 3] *= kk.y;
          }
        }
        if (k0 + T - 1 > lim_lo) {
#pragma unroll
          for (int i = 0; i < T / 2; ++i)
            if (k0 + 8 * (i / 4) + 2 * t4 + (i & 1) > lim[(i / 2) & 1]) sacc[i] = kNegInf;
        }
        float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
        for (int i = 0; i < T / 2; ++i) mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], sacc[i]);
        float msc[2], ls[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          alpha[r] = exp2f((m_run[r] - mx[r]) * sl2);
          m_run[r] = mx[r];
          msc[r] = mx[r] == kNegInf ? 0.f : mx[r] * sl2;  // a row with nothing live yet: every p is 0
        }
#pragma unroll
        for (int i = 0; i < T / 2; ++i) {
          const float p = exp2f(fmaf(sacc[i], sl2, -msc[(i / 2) & 1]));
          sacc[i] = p;
          ls[(i / 2) & 1] += p;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + ls[r];
      };
      // P of tile t into register-A fragments; an int8 tile's v_scale
      // multiplies p after l has summed it, before the bf16 rounding.
      auto to_p = [&](int t) {
        if constexpr (INT8) {
          const float* vs = scales + (t % ST) * 2 * T + T;
#pragma unroll
          for (int j = 0; j < T / 8; ++j) {
            const float2 vv = *reinterpret_cast<const float2*>(vs + 8 * j + 2 * t4);
            sacc[4 * j] *= vv.x, sacc[4 * j + 1] *= vv.y, sacc[4 * j + 2] *= vv.x, sacc[4 * j + 3] *= vv.y;
          }
        }
        to_a(pa, sacc);
      };

      if (n_tiles > 0) {
        float alpha[2];
        mbar_wait(q_full, 0);
        acquire(0);
        wgmma_fence();
        scores(0);
        wgmma_wait<0>();
        fence_regs(sacc);
        softmax(0, alpha);
        to_p(0);
        if (INT8) release(0);  // converted, and its scales read
        for (int t = 1; t < n_tiles; ++t) {
          acquire(t);
          fence_regs(pa);
          fence_regs(o_acc);
          wgmma_fence();
          scores(t);
          pv(t - 1);
          wgmma_wait<1>();  // the scores (the groups complete in order)
          fence_regs(sacc);
          softmax(t, alpha);
          wgmma_wait<0>();
          fence_regs(o_acc);
          fence_regs(pa);
          if (!INT8) release(t - 1);
#pragma unroll
          for (int i = 0; i < D / 2; ++i) o_acc[i] *= alpha[(i / 2) & 1];
          to_p(t);
          if (INT8) release(t);
        }
        fence_regs(pa);
        fence_regs(o_acc);
        wgmma_fence();
        pv(n_tiles - 1);
        wgmma_wait<0>();
        fence_regs(o_acc);
        fence_regs(pa);
      }

      float l[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = l_run[r] + __shfl_xor_sync(0xffffffffu, l_run[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        const float li = l[(i / 2) & 1];
        o_acc[i] = o_acc[i] / (li == 0.f ? 1.f : li);
      }
      store_acc<D>(o + ((size_t)b * Sq * H + h) * D, (size_t)H * D, row0, Sq, o_acc, t4);
      if (!CACHED && lse != nullptr && t4 == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (row0 + 8 * r < Sq)
            lse[(size_t)bh * Sq + row0 + 8 * r] = l[r] == 0.f ? kNegInf : m_run[r] * scale + logf(l[r]);
      }
    }
  }
}

// Each call encodes its three tensor maps on the host (the pointers change
// from call to call); chip_smoke.py prints the host time of a call beside
// that of the mma design's entry point, which encodes none (PERF.md).
template <int D, bool CACHED, bool INT8>
int launch(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm, void* o, float* lse, const int* pos,
           const int* kv_len, const float* k_scale, const float* v_scale, int B, int Sq, int Sk, int H, int KH,
           float scale, int causal, cudaStream_t stream) {
  constexpr int smem = std::conditional_t<INT8, Int8Layout<D>, FwdLayout<D>>::total;
  static bool configured = false;
  if (cudaError_t err = allow_smem(flash_fwd_wgmma_kernel<D, CACHED, INT8>, smem, configured)) return (int)err;
  const int tiles = (Sq + BLOCK - 1) / BLOCK;
  flash_fwd_wgmma_kernel<D, CACHED, INT8><<<tiles * B * H, (NC + 1) * WG, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), lse, pos, kv_len, k_scale, v_scale, Sq, Sk, H, KH, scale, causal,
      head_chunk(tiles));
  return (int)cudaGetLastError();
}

// -1 for shapes this design does not take, -2 for a head_dim other than
// 64 and 128, -3 when the CUDA driver gives no tensor map.
int check_args(int B, int Sq, int Sk, int H, int KH, int D, const void* const* ptrs, int n) {
  if (B < 1 || Sq < 1 || Sk < 1 || KH < 1 || H % KH != 0) return -1;
  if ((int64_t)B * H * ((Sq + TILE - 1) / TILE) > INT32_MAX) return -1;  // grid.x limit
  for (int i = 0; i < n; ++i)
    if ((uintptr_t)ptrs[i] % 16 != 0) return -1;
  if (D != 64 && D != 128) return -2;
  if (encode_tiled() == nullptr) return -3;
  return 0;
}

}  // namespace
}  // namespace substratus

// The C interface of flash_fwd.cu's flash_fwd, for head_dim 64 and 128
// (-3 for a dtype other than bf16).
extern "C" int flash_fwd_wgmma(const void* q, const void* k, const void* v, void* o, void* lse, int B, int Sq,
                               int Sk, int H, int KH, int D, int dtype, float scale, int causal, void* stream) {
  using namespace substratus;
  const void* ptrs[] = {q, k, v, o};
  if (int rc = check_args(B, Sq, Sk, H, KH, D, ptrs, 4)) return rc;
  if (dtype != kBF16) return -3;
  CUtensorMap qm, km, vm;
  if (!make_head_map(&qm, q, B, Sq, H, D, BLOCK) || !make_head_map(&km, k, B, Sk, KH, D, KT) ||
      !make_head_map(&vm, v, B, Sk, KH, D, KT))
    return -3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  return D == 64
             ? launch<64, false, false>(qm, km, vm, o, l, nullptr, nullptr, nullptr, nullptr, B, Sq, Sk, H, KH, scale,
                                        causal, s)
             : launch<128, false, false>(qm, km, vm, o, l, nullptr, nullptr, nullptr, nullptr, B, Sq, Sk, H, KH,
                                         scale, causal, s);
}

// The C interface of flash_cached.cu's flash_cached, for head_dim 64 and
// 128: a bf16 cache (k_scale and v_scale null) or an int8 one with its f32
// scales [B, KH, Sk] (-1 without them; -3 for another dtype).
extern "C" int flash_cached_wgmma(const void* q, const void* k, const void* v, const void* k_scale,
                                  const void* v_scale, const void* pos, const void* kv_len, void* o, int B, int Sq,
                                  int Sk, int H, int KH, int D, int cache_dtype, float scale, void* stream) {
  using namespace substratus;
  const void* ptrs[] = {q, k, v, o};
  if (int rc = check_args(B, Sq, Sk, H, KH, D, ptrs, 4)) return rc;
  const bool int8 = cache_dtype == kInt8;
  if (!int8 && cache_dtype != kBF16) return -3;
  if (int8 != (k_scale != nullptr) || int8 != (v_scale != nullptr)) return -1;
  CUtensorMap qm, km, vm;
  const bool maps = make_head_map(&qm, q, B, Sq, H, D, BLOCK) &&
                    (int8 ? make_int8_cache_map(&km, k, B, KH, Sk, D, KT8) && make_int8_cache_map(&vm, v, B, KH, Sk, D, KT8)
                          : make_cache_map(&km, k, B, KH, Sk, D, KT) && make_cache_map(&vm, v, B, KH, Sk, D, KT));
  if (!maps) return -3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  const int* kl = static_cast<const int*>(kv_len);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  if (int8)
    return D == 64 ? launch<64, true, true>(qm, km, vm, o, nullptr, p, kl, ks, vs, B, Sq, Sk, H, KH, scale, 1, s)
                   : launch<128, true, true>(qm, km, vm, o, nullptr, p, kl, ks, vs, B, Sq, Sk, H, KH, scale, 1, s);
  return D == 64 ? launch<64, true, false>(qm, km, vm, o, nullptr, p, kl, nullptr, nullptr, B, Sq, Sk, H, KH, scale, 1, s)
                 : launch<128, true, false>(qm, km, vm, o, nullptr, p, kl, nullptr, nullptr, B, Sq, Sk, H, KH, scale, 1,
                                            s);
}
