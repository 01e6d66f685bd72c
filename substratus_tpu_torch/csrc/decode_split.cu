// Single-token decode attention, and the fused cache write + decode
// attention, over the dense slot cache (bf16 or int8), split over blocks
// along S (flash-decoding), for Hopper (sm_90a). One kernel template
// serves both: decode_split_kernel<TC, D, G, FUSED>, where G is the query
// rows a block serves (1, 2, 4 or 8; below).
//
// Replaces the TPU kernels substratus_tpu/ops/decode_attention.py _kernel
// (FUSED = false: row b attends cache rows 0..pos[b], none when
// pos[b] < 0, and then outputs 0) and substratus_tpu/ops/fused_decode.py
// _kernel (FUSED = true: the fresh row is written into row pos, pos
// clamped to [0, S-1], the history is rows 0..pos-1 and the current
// token's term comes from the operands). Each runs once per layer on
// every decode step. csrc/decode_attn.cu and csrc/fused_decode.cu keep
// the shapes this design does not take (head_dim 16 and 32; int8 caches
// whose S is not a multiple of 4; head_dim 256 at a group of 1, 2, 4 or
// 8, which ops/fused_decode.py::decode_design gives them: this design's
// instance at 256 serves the other groups, on 4 warps, below).
//
// Layout: q [B, 1, H, D] bf16; k/v [B, KH, S, D] bf16 or int8 with f32
// scales [B, KH, S]; pos [B] int32; o [B, 1, H, D] bf16; fused: the fresh
// row new_k/new_v [B, KH, 1, D] in the cache dtype, its f32 scales
// new_ks/new_vs [B, KH, 1] for int8 (already scattered into the cache
// scales by the caller).
//
// Bound on an H100: the live cache rows must be read once (3.35 TB/s), so
// both are bound by bytes. The TPU kernel walks S in order on one core,
// carrying m, l and acc in scratch; here that sequential axis becomes
// parallel blocks and a combine.
//
// Design.
// - Grid (B * KH, n_split, n_slice): block (head, split, slice) reads
//   rows [split * rows, (split + 1) * rows) of one kv head, clipped to the
//   slot's limit (pos for decode, pos - 1 for the fused kernel's strict
//   history), and serves G query rows of the group of H / KH: the whole
//   group when it has 1, 2, 4 or 8 rows (n_slice = 1, so each cache tile
//   is read once per kv head), else slices of G = 8 rows (G = 4 or 8 for
//   a group of 3 or 5-7), the last one masked: falcon-7b's 71 rows on its
//   one kv head are 9 slices, the ninth of 7 rows. Each slice keeps the
//   registers and shared memory of a group of 8 (qr[G][VEC], acc[G][CPL],
//   the [G][T] scores) and reads its kv head's tiles again; after the
//   first slice those reads mostly hit L2 (falcon-7b's cache at B = 16, S
//   = 1024 is 4.2 MB a layer). A masked row's query is 0 and its output
//   is never written. n_split and rows come from the shapes and the SM
//   count alone (ops/fused_decode.py::decode_split_plan, over B * KH *
//   n_slice blocks): no position is read on the host. A block whose rows
//   begin past the limit exits at once.
// - A ring of NW * RING = 8 tile stages in shared memory (4 at head_dim
//   256: NWARPS), each of the NW = 8 warps a pipeline of its own over the block's 32-row tiles w,
//   w + NW, ... through its RING = 1 stage: each tile one contiguous span
//   of the head's K rows, one of its V rows (and of each scale row for
//   int8), copied by cp.async.bulk (TMA's 1-D form, no tensor map to
//   encode) onto the stage's mbarrier. Only the live rows are copied, so
//   no block ever reads the fused kernel's row pos. A warp refills its
//   stage as soon as it is done with it. In flight: up to 8 tiles a block,
//   128 KB at bf16 and head_dim 128 (64 KB at int8 or head_dim 64), five
//   times the 25 KB an SM's share of the card's bandwidth needs over a
//   microsecond of latency. Four warps with two stages each moved the
//   same bytes but were 5-25% slower where a block holds few tiles (GQA,
//   tinyllama's heads), whose compute then ran on half the warps
//   (tools/decode_probe.py, PERF.md).
// - Scores: 16 bytes of a row a lane (D/8 lanes a row), q in registers
//   scaled by `scale` in f32; the partial dots of a batch of D/8 scores
//   are summed over their lanes by a reduce-scatter (D/8 - 1 shuffles for
//   D/8 sums, not log2(D/8) per sum). The tile's scores go to shared
//   memory, then one lane a row: one tile max and one rescale of acc a
//   tile for each query row, one exp a score; int8 k_scale multiplies the
//   score, v_scale folds into p. PV: D/32 columns a lane, p broadcast
//   from shared memory, f32 throughout.
// - The warps' states merge in shared memory. With n_split = 1 the block
//   writes o; otherwise it writes f32 (acc[D], m, l) for its live rows to
//   the workspace `ws` [B * KH, n_split, H / KH, D + 2] (allocated by the
//   caller) and a second launch, decode_combine_kernel, merges the live
//   splits of each (slot, kv head, slice) and writes o. A second launch was chosen over
//   a last-block counter: it needs no zeroed counter kept between calls
//   (the C side allocates nothing) and holds no state a CUDA graph replay
//   would have to find reset.
// - Fused: the block of split 0 and slice 0 copies the fresh k and v rows
//   into row pos before anything else; no block reads row pos, so no ordering across
//   blocks is needed. The current token's score and value enter where o
//   is written (the combine, or the single split), scaled by new_ks and
//   new_vs for int8; pos = 0 attends to the current token alone.
//
// Numerics follow _kernel: q scaled by D^-0.5 in f32, scores, softmax and
// PV in f32, out = acc / l (0 for a decode row with no live column). The
// split changes only the order of the sums.
#include "hopper.cuh"

namespace substratus {
namespace {

// Warps a block, each its own pipeline of tiles: 8 at head_dim 64 and 128;
// 4 at 256, where one stage of 32 K and 32 V rows is 32 KB of bf16 and
// eight stages would pass the 227 KB a block may have.
template <int D>
constexpr int NWARPS = D == 256 ? 4 : 8;
constexpr int RING = 1;  // tiles in flight a warp: the block's ring holds NW
constexpr int T = 32;    // rows of a tile (one a lane in the softmax)
constexpr int VEC = 8;   // elements of a row a lane reads for the scores
constexpr int COMBINE_THREADS = 128;

struct Args {
  const __nv_bfloat16* q;  // [B, H, D]
  void* k;                 // [B, KH, S, D] (fused: row pos written)
  void* v;
  const float* ks;  // [B, KH, S] (int8)
  const float* vs;
  const void* nk;    // fused: [B, KH, D]
  const void* nv;
  const float* nks;  // fused int8: [B, KH]
  const float* nvs;
  const int* pos;          // [B]
  __nv_bfloat16* o;        // [B, H, D]
  float* ws;               // n_split > 1: [B * KH, n_split, group, D + 2]
  int KH, S, rows, n_split;
  int group;  // H / KH query rows a kv head (a block serves G of them)
  float scale;
};

// Bytes of one tile's stage: K rows, V rows, and for int8 the two scale rows.
template <typename TC, int D>
struct Stage {
  static constexpr int kv = T * D * (int)sizeof(TC);
  static constexpr int bytes = 2 * kv + (sizeof(TC) == 1 ? 2 * T * 4 : 0);
};

// Cache rows slot b attends, [0, limit): decode rows 0..pos (none when
// pos < 0); fused the history 0..pos-1 with pos clamped to [0, S-1].
template <bool FUSED>
__device__ __forceinline__ int row_limit(int pos, int S) {
  return FUSED ? min(max(pos, 0), S - 1) : (pos < 0 ? 0 : min(pos + 1, S));
}

// 8 cache elements at p (16 bytes of bf16, 8 of int8) as f32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&out)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Four int8 of a word as f32, without I2F: x + 128 in the low byte of
// 2^23's float is 2^23 + 128 + x exactly.
__device__ __forceinline__ void i8x4(uint32_t w, float* out) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) - 8388736.f;
}

__device__ __forceinline__ void load8(const int8_t* p, float (&out)[8]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  i8x4(raw.x, out);
  i8x4(raw.y, out + 4);
}

// N (= 2, 4, 8) consecutive cache elements at p as f32 (the PV columns of a lane).
template <int N>
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p, float (&out)[N]) {
  if constexpr (N == 8) {
    load8(p, out);
  } else if constexpr (N == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    out[0] = __uint_as_float(raw.x << 16), out[1] = __uint_as_float(raw.x & 0xffff0000u);
    out[2] = __uint_as_float(raw.y << 16), out[3] = __uint_as_float(raw.y & 0xffff0000u);
  } else {
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
    out[0] = __uint_as_float(raw << 16), out[1] = __uint_as_float(raw & 0xffff0000u);
  }
}

template <int N>
__device__ __forceinline__ void load_cols(const int8_t* p, float (&out)[N]) {
  if constexpr (N == 8) {
    load8(p, out);
  } else if constexpr (N == 4) {
    i8x4(*reinterpret_cast<const uint32_t*>(p), out);
  } else {
    float f[4];
    i8x4(*reinterpret_cast<const uint16_t*>(p), f);
    out[0] = f[0], out[1] = f[1];
  }
}

// G consecutive floats of shared memory (p's row of a tile).
template <int G>
__device__ __forceinline__ void load_p(const float* p, float (&out)[G]) {
  if constexpr (G >= 4) {
#pragma unroll
    for (int i = 0; i < G; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      out[i] = x.x, out[i + 1] = x.y, out[i + 2] = x.z, out[i + 3] = x.w;
    }
  } else if constexpr (G == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x, out[1] = x.y;
  } else {
    out[0] = p[0];
  }
}

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return (float)x; }

// Reduce-scatter over the N lanes lane ^ 1 .. lane ^ (N/2) (N a power of
// two): each holds x[0..N), and after it lane holds in x[0] the sum over
// those lanes of x[lane % N]. Step h: the lanes whose bit h is set keep
// the upper half, send the lower, and their partners the reverse.
template <int H, int N>
__device__ __forceinline__ void reduce_scatter(float (&x)[N], int lane) {
  if constexpr (H >= 1) {
    const bool up = lane & H;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = up ? x[i] : x[i + H];
      const float keep = up ? x[i + H] : x[i];
      x[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
    }
    reduce_scatter<H / 2, N>(x, lane);
  }
}

// The current token's score for each of the block's n_rows live query
// rows, from row q0 of q, into cur[G] (fused only): warp w takes rows w,
// w + nw, ...; ends with __syncthreads().
template <typename TC, int D, int G>
__device__ __forceinline__ void current_scores(const Args& a, int head, size_t q0, int n_rows, int nw,
                                               float* cur) {
  constexpr bool kQuant = sizeof(TC) == 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const TC* nk = static_cast<const TC*>(a.nk) + (size_t)head * D;
  for (int g = warp; g < n_rows; g += nw) {
    const __nv_bfloat16* qg = a.q + (q0 + g) * D;
    float dot = 0.f;
    for (int d = lane; d < D; d += 32) dot += __bfloat162float(qg[d]) * a.scale * to_float(nk[d]);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (lane == 0) cur[g] = kQuant ? dot * a.nks[head] : dot;
  }
  __syncthreads();
}

// o for (g, d) from n states (m, l, acc) given by state(i, m, l, acc),
// and for the fused kernel the current token (score cur_g, value vd).
template <bool FUSED, typename State>
__device__ __forceinline__ float merge_states(int n, State state, float cur_g, float vd) {
  float mx = FUSED ? cur_g : kNegInf;
  for (int i = 0; i < n; ++i) {
    float m, l, acc;
    state(i, m, l, acc);
    mx = fmaxf(mx, m);
  }
  float lsum = 0.f, a = 0.f;
  for (int i = 0; i < n; ++i) {
    float m, l, acc;
    state(i, m, l, acc);
    const float c = expf(m - mx);
    lsum += c * l;
    a += c * acc;
  }
  if (FUSED) {
    const float pc = expf(cur_g - mx);
    lsum += pc;
    a += pc * vd;
  }
  return lsum == 0.f ? 0.f : a / lsum;
}

template <typename TC, int D, int G>
constexpr int split_smem() {
  return NWARPS<D> * RING * Stage<TC, D>::bytes + 2 * NWARPS<D> * G * T * 4;
}

template <typename TC, int D, int G, bool FUSED>
__global__ void __launch_bounds__(NWARPS<D> * 32) decode_split_kernel(const Args a) {
  using St = Stage<TC, D>;
  constexpr int NW = NWARPS<D>;
  constexpr bool kQuant = sizeof(TC) == 1;
  constexpr int LPR = D / VEC;   // lanes a row in the scores
  constexpr int RPI = 32 / LPR;  // rows an iteration
  constexpr int I = LPR / G;     // iterations a batch of LPR sums
  constexpr int CPL = D / 32;    // output columns a lane
  static_assert(LPR >= G && (T / RPI) % I == 0 && T / RPI / I == G, "tile shape");
  static_assert(NW * RING * St::bytes >= NW * G * (D + 2) * 4, "partials alias the ring");

  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[NW][RING];
  __shared__ float cur[G];

  const int head = blockIdx.x;  // b * KH + kv head
  const int split = blockIdx.y;
  const int g0 = blockIdx.z * G;                // the slice's first row of the group
  const int n_rows = min(G, a.group - g0);      // its live query rows
  const size_t q0 = (size_t)head * a.group + g0;  // its first row of q and o
  const int b = head / a.KH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int limit = row_limit<FUSED>(a.pos[b], a.S);
  const int r0 = split * a.rows;
  const int r1 = min(r0 + a.rows, limit);
  const size_t hrow = (size_t)head * a.S;  // the head's first cache row

  if (FUSED && split == 0 && blockIdx.z == 0) {  // the fresh row into row pos (= limit), 16 bytes a thread
    constexpr int CH = D * (int)sizeof(TC) / 16;
    if (threadIdx.x < 2 * CH) {
      const bool is_v = threadIdx.x >= CH;
      const int c = threadIdx.x % CH;
      const uint4* src = reinterpret_cast<const uint4*>(static_cast<const TC*>(is_v ? a.nv : a.nk) + (size_t)head * D) + c;
      uint4* dst = reinterpret_cast<uint4*>(static_cast<TC*>(is_v ? a.v : a.k) + (hrow + limit) * D) + c;
      *dst = *src;
    }
  }
  if (r0 >= r1 && a.n_split > 1) return;  // no live rows: the combine skips this split
  const int n_tiles = r0 < r1 ? (r1 - r0 + T - 1) / T : 0;

  if (threadIdx.x == 0) {
    for (int w = 0; w < NW; ++w)
      for (int s = 0; s < RING; ++s) mbar_init(smem_addr(&bars[w][s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  unsigned char* ring = smem + warp * RING * St::bytes;
  float* sc = reinterpret_cast<float*>(smem + NW * RING * St::bytes) + warp * G * T;       // [G][T] scores
  float* pr = reinterpret_cast<float*>(smem + NW * RING * St::bytes) + (NW + warp) * G * T;  // [T][G] p
  const TC* kh = static_cast<const TC*>(a.k) + hrow * D;
  const TC* vh = static_cast<const TC*>(a.v) + hrow * D;

  // Lane 0: tile t of the block into slot `slot` of this warp's ring.
  auto issue = [&](int t, int slot) {
    const int row0 = r0 + t * T;
    const int n = min(T, r1 - row0);
    const uint32_t bar = smem_addr(&bars[warp][slot]);
    const uint32_t st = smem_addr(ring + slot * St::bytes);
    const uint32_t kv_bytes = n * D * sizeof(TC);
    const uint32_t s_bytes = kQuant ? ((n + 3) & ~3) * 4 : 0;  // rows rounded up to 16 bytes (S % 4 == 0)
    mbar_expect_tx(bar, 2 * kv_bytes + 2 * s_bytes);
    bulk_load(st, kh + (size_t)row0 * D, kv_bytes, bar);
    bulk_load(st + St::kv, vh + (size_t)row0 * D, kv_bytes, bar);
    if (kQuant) {
      bulk_load(st + 2 * St::kv, a.ks + hrow + row0, s_bytes, bar);
      bulk_load(st + 2 * St::kv + T * 4, a.vs + hrow + row0, s_bytes, bar);
    }
  };
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < RING; ++j)
      if (warp + j * NW < n_tiles) issue(warp + j * NW, j);
  }

  // This lane's VEC elements of each query row, scaled in f32 (0 for a
  // masked row).
  const int e0 = (lane % LPR) * VEC;
  const int rg = lane / LPR;
  float qr[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      qr[g][e] = g < n_rows ? __bfloat162float(a.q[(q0 + g) * D + e0 + e]) * a.scale : 0.f;
  }
  float m[G], l[G], acc[G][CPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;  // this lane's rows' share; summed over the lanes at the end
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[g][c] = 0.f;
  }

  for (int j = 0;; ++j) {
    const int t = warp + j * NW;
    if (t >= n_tiles) break;
    const int slot = j % RING;
    mbar_wait(smem_addr(&bars[warp][slot]), (j / RING) & 1);
    const unsigned char* st = ring + slot * St::bytes;
    const TC* kt = reinterpret_cast<const TC*>(st);
    const TC* vt = reinterpret_cast<const TC*>(st + St::kv);
    const float* kst = reinterpret_cast<const float*>(st + 2 * St::kv);
    const float* vst = kst + T;
    const int n = min(T, r1 - (r0 + t * T));  // live rows of the tile; the rest are stale

    // Scores: G batches of I iterations, each RPI rows of LPR lanes.
#pragma unroll
    for (int bt = 0; bt < G; ++bt) {
      float x[LPR];  // x[i * G + g]
#pragma unroll
      for (int i = 0; i < I; ++i) {
        float kf[VEC];
        load8(kt + ((bt * I + i) * RPI + rg) * D + e0, kf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) dot = fmaf(qr[g][e], kf[e], dot);
          x[i * G + g] = dot;
        }
      }
      reduce_scatter<LPR / 2, LPR>(x, lane);
      const int idx = lane % LPR;  // this lane's sum: iteration idx / G, query row idx % G
      sc[(idx % G) * T + (bt * I + idx / G) * RPI + rg] = x[0];
    }
    __syncwarp();

    // Softmax, one lane a row: one max and one rescale a tile.
    const bool live = lane < n;
    const float kscale = kQuant ? kst[lane] : 1.f;
    const float vscale = kQuant ? vst[lane] : 1.f;
    float alpha[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float s = live ? sc[g * T + lane] * kscale : kNegInf;
      float mt = s;
#pragma unroll
      for (int off = 16; off > 0; off /= 2) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[g], mt);
      alpha[g] = expf(m[g] - m_new);
      const float p = live ? expf(s - m_new) : 0.f;
      l[g] = l[g] * alpha[g] + p;
      pr[lane * G + g] = live ? p * vscale : 0.f;
      m[g] = m_new;
    }
    __syncwarp();

    // PV over the live rows.
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[g][c] *= alpha[g];
    }
#pragma unroll 4
    for (int r = 0; r < n; ++r) {
      float vf[CPL], p[G];
      load_cols<CPL>(vt + r * D + lane * CPL, vf);
      load_p<G>(pr + r * G, p);
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[g][c] = fmaf(p[g], vf[c], acc[g][c]);
      }
    }
    __syncwarp();
    if (lane == 0 && t + RING * NW < n_tiles) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the generic reads before the async write
      issue(t + RING * NW, slot);
    }
  }

  // The warps' states, merged in shared memory (over the ring: every
  // issued tile has been consumed).
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int off = 16; off > 0; off /= 2) l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
  }
  __syncthreads();
  float* pm = reinterpret_cast<float*>(smem);  // [NW][G]
  float* pl = pm + NW * G;                     // [NW][G]
  float* pacc = pl + NW * G;                   // [NW][G][D]
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) pm[warp * G + g] = m[g], pl[warp * G + g] = l[g];
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int c = 0; c < CPL; ++c) pacc[(warp * G + g) * D + lane * CPL + c] = acc[g][c];
  }
  __syncthreads();

  if (a.n_split == 1) {
    if (FUSED) current_scores<TC, D, G>(a, head, q0, n_rows, NW, cur);
    const float vs_cur = kQuant && FUSED ? a.nvs[head] : 1.f;
    for (int i = threadIdx.x; i < n_rows * D; i += NW * 32) {
      const int g = i / D, d = i % D;
      const float vd = FUSED ? vs_cur * to_float(static_cast<const TC*>(a.nv)[(size_t)head * D + d]) : 0.f;
      const float out = merge_states<FUSED>(
          NW, [&](int w, float& mw, float& lw, float& aw) {
            mw = pm[w * G + g], lw = pl[w * G + g], aw = pacc[(w * G + g) * D + d];
          },
          FUSED ? cur[g] : 0.f, vd);
      a.o[(q0 + g) * D + d] = __float2bfloat16(out);
    }
    return;
  }
  for (int i = threadIdx.x; i < n_rows * D; i += NW * 32) {
    const int g = i / D, d = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, pm[w * G + g]);
    float lsum = 0.f, acc_d = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = expf(pm[w * G + g] - mx);
      lsum += c * pl[w * G + g];
      acc_d += c * pacc[(w * G + g) * D + d];
    }
    float* part = a.ws + (((size_t)head * a.n_split + split) * a.group + g0 + g) * (D + 2);
    part[d] = acc_d;
    if (d == 0) part[D] = mx, part[D + 1] = lsum;
  }
}

// The live splits of each (slot, kv head, slice), and the fused kernel's
// current token, into o: one block a (slot, kv head, slice), one thread a
// (g, d).
template <typename TC, int D, int G, bool FUSED>
__global__ void __launch_bounds__(COMBINE_THREADS) decode_combine_kernel(const Args a) {
  constexpr bool kQuant = sizeof(TC) == 1;
  __shared__ float cur[G];
  const int head = blockIdx.x;
  const int g0 = blockIdx.y * G;
  const int n_rows = min(G, a.group - g0);
  const size_t q0 = (size_t)head * a.group + g0;
  const int limit = row_limit<FUSED>(a.pos[head / a.KH], a.S);
  const int live = (limit + a.rows - 1) / a.rows;
  if (FUSED) current_scores<TC, D, G>(a, head, q0, n_rows, COMBINE_THREADS / 32, cur);
  const float vs_cur = kQuant && FUSED ? a.nvs[head] : 1.f;
  for (int i = threadIdx.x; i < n_rows * D; i += COMBINE_THREADS) {
    const int g = i / D, d = i % D;
    const float* part = a.ws + ((size_t)head * a.n_split * a.group + g0 + g) * (D + 2);
    const float vd = FUSED ? vs_cur * to_float(static_cast<const TC*>(a.nv)[(size_t)head * D + d]) : 0.f;
    const float out = merge_states<FUSED>(
        live, [&](int s, float& ms, float& ls, float& as) {
          const float* ps = part + (size_t)s * a.group * (D + 2);
          ms = ps[D], ls = ps[D + 1], as = ps[d];
        },
        FUSED ? cur[g] : 0.f, vd);
    a.o[(q0 + g) * D + d] = __float2bfloat16(out);
  }
}

// Query rows a block for a group of `group` rows: the group itself at 1, 2,
// 4 and 8, the next of those above it below 8, else slices of 8
// (ops/fused_decode.py::group_slices computes the same).
int block_rows(int group) {
  if (group >= 8) return 8;
  int g = 1;
  while (g < group) g *= 2;
  return g;
}

template <typename TC, int D, int G, bool FUSED>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int smem = split_smem<TC, D, G>();
  static bool configured = false;
  if (cudaError_t err = allow_smem(decode_split_kernel<TC, D, G, FUSED>, smem, configured)) return (int)err;
  const int n_slice = (a.group + G - 1) / G;
  decode_split_kernel<TC, D, G, FUSED><<<dim3(B * a.KH, a.n_split, n_slice), NWARPS<D> * 32, smem, stream>>>(a);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  if (a.n_split > 1)
    decode_combine_kernel<TC, D, G, FUSED><<<dim3(B * a.KH, n_slice), COMBINE_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename TC, int D, bool FUSED>
int dispatch_g(const Args& a, int B, cudaStream_t s) {
  switch (block_rows(a.group)) {
    case 1: return launch<TC, D, 1, FUSED>(a, B, s);
    case 2: return launch<TC, D, 2, FUSED>(a, B, s);
    case 4: return launch<TC, D, 4, FUSED>(a, B, s);
    default: return launch<TC, D, 8, FUSED>(a, B, s);
  }
}

template <bool FUSED>
int dispatch(int D, bool int8, const Args& a, int B, cudaStream_t s) {
  if (D == 64) return int8 ? dispatch_g<int8_t, 64, FUSED>(a, B, s) : dispatch_g<__nv_bfloat16, 64, FUSED>(a, B, s);
  if (D == 128)
    return int8 ? dispatch_g<int8_t, 128, FUSED>(a, B, s) : dispatch_g<__nv_bfloat16, 128, FUSED>(a, B, s);
  if (D == 256)
    return int8 ? dispatch_g<int8_t, 256, FUSED>(a, B, s) : dispatch_g<__nv_bfloat16, 256, FUSED>(a, B, s);
  return -2;
}

// -1 for arguments this design does not take, -2 for a head_dim other than
// 64, 128 and 256, -3 for another cache dtype.
int check_args(int B, int H, int KH, int S, int D, int cache_dtype, int rows, int n_split, const Args& a) {
  if (B < 1 || S < 1 || KH < 1 || H % KH != 0) return -1;
  if (cache_dtype != kBF16 && cache_dtype != kInt8) return -3;
  const bool int8 = cache_dtype == kInt8;
  if (int8 != (a.ks != nullptr) || int8 != (a.vs != nullptr)) return -1;
  // Rows of a split: whole tiles, every row covered, no split empty for
  // every slot, within the grid's limit.
  if (rows < T || rows % T != 0 || n_split < 1 || n_split > 65535 || (int64_t)n_split * rows < S ||
      (int64_t)(n_split - 1) * rows >= S)
    return -1;
  if (n_split > 1 && a.ws == nullptr) return -1;
  if (int8 && S % 4 != 0) return -1;  // scale rows copied in 16-byte pieces
  const void* aligned[] = {a.k, a.v, a.ks, a.vs, a.nk, a.nv};
  for (const void* p : aligned)
    if ((uintptr_t)p % 16 != 0) return -1;
  if (D != 64 && D != 128 && D != 256) return -2;
  if ((H / KH + 7) / 8 > 65535) return -1;  // slices of the grid's z
  return 0;
}

}  // namespace
}  // namespace substratus

// decode_attn's function (csrc/decode_attn.cu) split over blocks: rows and
// n_split from ops/fused_decode.py::decode_split_plan; ws [B * KH *
// n_split * G * (D + 2)] f32 when n_split > 1 (else null).
extern "C" int decode_split(const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
                            const void* pos, void* o, void* ws, int B, int H, int KH, int S, int D, int cache_dtype,
                            float scale, int rows, int n_split, void* stream) {
  using namespace substratus;
  const Args a{static_cast<const __nv_bfloat16*>(q), const_cast<void*>(k), const_cast<void*>(v),
               static_cast<const float*>(k_scale), static_cast<const float*>(v_scale), nullptr, nullptr, nullptr,
               nullptr, static_cast<const int*>(pos), static_cast<__nv_bfloat16*>(o), static_cast<float*>(ws), KH, S,
               rows, n_split, KH > 0 ? H / KH : 0, scale};
  if (int rc = check_args(B, H, KH, S, D, cache_dtype, rows, n_split, a)) return rc;
  return dispatch<false>(D, cache_dtype == kInt8, a, B, static_cast<cudaStream_t>(stream));
}

// fused_decode's function (csrc/fused_decode.cu) split over blocks, with
// the same rows, n_split and ws as decode_split.
extern "C" int fused_decode_split(const void* q, const void* new_k, const void* new_v, const void* new_ks,
                                  const void* new_vs, void* k, void* v, const void* k_scale, const void* v_scale,
                                  const void* pos, void* o, void* ws, int B, int H, int KH, int S, int D,
                                  int cache_dtype, float scale, int rows, int n_split, void* stream) {
  using namespace substratus;
  const Args a{static_cast<const __nv_bfloat16*>(q), k, v, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale), new_k, new_v, static_cast<const float*>(new_ks),
               static_cast<const float*>(new_vs), static_cast<const int*>(pos), static_cast<__nv_bfloat16*>(o),
               static_cast<float*>(ws), KH, S, rows, n_split, KH > 0 ? H / KH : 0, scale};
  if (int rc = check_args(B, H, KH, S, D, cache_dtype, rows, n_split, a)) return rc;
  if (new_k == nullptr || new_v == nullptr || (cache_dtype == kInt8) != (new_ks != nullptr && new_vs != nullptr))
    return -1;
  return dispatch<true>(D, cache_dtype == kInt8, a, B, static_cast<cudaStream_t>(stream));
}
