// Fused cache write + single-token decode attention over the dense slot
// cache, bf16 or int8, for Hopper (sm_90a).
//
// Replaces the TPU kernel substratus_tpu/ops/fused_decode.py _kernel
// (driven by _fused_impl / fused_decode_attention), run once per layer on
// every decode step when decode_attn_impl="fused".
//
// Layout: q [B, 1, H, D] bf16; the fresh row new_k/new_v [B, KH, 1, D] in
// the cache dtype, with f32 scales new_ks/new_vs [B, KH, 1] for int8; the
// caches k/v [B, KH, S, D] (written in place) with f32 scales [B, KH, S]
// for int8, the fresh scales already scattered by the caller; pos [B]
// int32; o [B, 1, H, D] bf16. The kernel clamps pos to [0, S-1], so a
// drifted idle slot writes row S-1 and never another head's rows.
//
// Design. decode_attn.cu's, with three changes.
// - Each block (b, kv head) first copies the fresh k and v rows into
//   cache row pos, 16 bytes per thread. No other block touches this
//   head's rows, so the write needs no ordering across blocks.
// - The history loop (decode_common.cuh) reads only rows 0..pos-1: a
//   strict mask, a trip count that follows pos, and row pos never loaded
//   at all, so a half-written row can never reach the accumulator (the
//   TPU kernel waits for its row DMA for the same reason).
// - The epilogue adds the current token's term from the operands, scaled
//   by new_ks/new_vs when int8. Its own query always attends to it, so
//   l > 0; pos = 0 runs no history rows, only the epilogue.
//
// Numerics follow _kernel: q is scaled by D^-0.5 in f32, dots and the
// softmax are f32, p stays f32 for the PV product, out = acc / l.
//
// Bound on an H100 (3.35 TB/s): the history rows 0..pos-1 must be read
// once and one row written, so the kernel is bound by bytes, as the
// unfused decode attention is; the fusion saves the separate row-write
// launches and the re-read of the fresh row. At llama2-7b, B=8, S=4096,
// bf16, positions spread over 0..4095 (14,467 history rows), it reads
// about 237 MB per layer (about 71 us). csrc/decode_split.cu serves
// head_dim 64 and 128 (S split over blocks; ops/fused_decode.py::
// decode_design); this kernel serves 16, 32 and 256 (129-255
// padded to 256; a group other than 1, 2, 4 or 8 at 256 goes to the split
// design), and its 64/128 instances
// stay for chip_smoke.py's side-by-side timing.
#include "decode_common.cuh"

namespace substratus {
namespace {

using decode::NW;

template <typename TC, int D, int G>
__global__ void __launch_bounds__(NW * 32) fused_decode_kernel(
    const __nv_bfloat16* __restrict__ q, const TC* __restrict__ new_k,
    const TC* __restrict__ new_v, const float* __restrict__ new_ks,
    const float* __restrict__ new_vs, TC* k, TC* v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ pos,
    __nv_bfloat16* __restrict__ o, int KH, int S, float scale) {
  constexpr bool kQuant = sizeof(TC) == 1;
  constexpr int ROW_CHUNKS = D * (int)sizeof(TC) / 16;  // 16-byte pieces of one row
  static_assert(ROW_CHUNKS >= 1 && 2 * ROW_CHUNKS <= NW * 32, "unsupported head_dim");
  decode::Partials<G, D>& part = decode::partials<G, D>();
  __shared__ float cur_s[G];

  const int b = blockIdx.x / KH;
  const int kvh = blockIdx.x % KH;
  const int H = KH * G;
  const int p = min(max(pos[b], 0), S - 1);
  const size_t head = (size_t)b * KH + kvh;
  const __nv_bfloat16* qg = q + ((size_t)b * H + kvh * G) * D;

  // The fresh row into cache[b, kvh, p]. The history loop below never
  // reads row p, so no barrier has to separate the two.
  if (threadIdx.x < 2 * ROW_CHUNKS) {
    const bool is_v = threadIdx.x >= ROW_CHUNKS;
    const int c = threadIdx.x % ROW_CHUNKS;
    const uint4* src = reinterpret_cast<const uint4*>((is_v ? new_v : new_k) + head * D) + c;
    uint4* dst = reinterpret_cast<uint4*>((is_v ? v : k) + (head * S + p) * D) + c;
    *dst = *src;
  }

  // History: rows 0..p-1 only (strict).
  decode::attend_rows<TC, D, G>(qg, k + head * S * D, v + head * S * D,
                                kQuant ? k_scale + head * S : nullptr,
                                kQuant ? v_scale + head * S : nullptr, p, scale, part);

  // The current token's score, one warp per query row of the group.
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp < G) {
    const TC* nk = new_k + head * D;
    float dot = 0.f;
    for (int d = lane; d < D; d += 32) {
      dot += __bfloat162float(qg[warp * D + d]) * scale * decode::to_float(nk[d]);
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (lane == 0) cur_s[warp] = kQuant ? dot * new_ks[head] : dot;
  }
  __syncthreads();

  // Merge the warps' history states with the current token: one thread
  // per (g, d).
  const float vs_cur = kQuant ? new_vs[head] : 1.f;
  for (int i = threadIdx.x; i < G * D; i += NW * 32) {
    const int g = i / D, d = i % D;
    const float sc = cur_s[g];
    float mx = sc;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, part.m[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = expf(part.m[w][g] - mx);
      lsum += c * part.l[w][g];
      a += c * part.acc[w][g][d];
    }
    const float pc = expf(sc - mx);
    lsum += pc;
    a += pc * vs_cur * decode::to_float(new_v[head * D + d]);
    o[((size_t)b * H + kvh * G + g) * D + d] = __float2bfloat16(a / lsum);
  }
}

template <typename TC, int D, int G>
int launch(const void* q, const void* nk, const void* nv, const void* nks, const void* nvs,
           void* k, void* v, const void* ks, const void* vs, const void* pos, void* o, int B,
           int KH, int S, float scale, cudaStream_t stream) {
  static bool configured = false;
  return decode::launch_rows<G, D>(
      fused_decode_kernel<TC, D, G>, B * KH, stream, configured, static_cast<const __nv_bfloat16*>(q),
      static_cast<const TC*>(nk), static_cast<const TC*>(nv), static_cast<const float*>(nks),
      static_cast<const float*>(nvs), static_cast<TC*>(k), static_cast<TC*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(pos), static_cast<__nv_bfloat16*>(o), KH, S,
      scale);
}

#define FUSED_ARGS q, nk, nv, nks, nvs, k, v, ks, vs, pos, o, B, KH, S, scale, stream

template <typename TC, int D>
int dispatch_g(int G, const void* q, const void* nk, const void* nv, const void* nks,
               const void* nvs, void* k, void* v, const void* ks, const void* vs,
               const void* pos, void* o, int B, int KH, int S, float scale,
               cudaStream_t stream) {
  switch (G) {
    case 1: return launch<TC, D, 1>(FUSED_ARGS);
    case 2: return launch<TC, D, 2>(FUSED_ARGS);
    case 4: return launch<TC, D, 4>(FUSED_ARGS);
    case 8: return launch<TC, D, 8>(FUSED_ARGS);
    default: return -2;
  }
}

template <typename TC>
int dispatch_d(int D, int G, const void* q, const void* nk, const void* nv, const void* nks,
               const void* nvs, void* k, void* v, const void* ks, const void* vs,
               const void* pos, void* o, int B, int KH, int S, float scale,
               cudaStream_t stream) {
  switch (D) {
    case 16: return dispatch_g<TC, 16>(G, FUSED_ARGS);
    case 32: return dispatch_g<TC, 32>(G, FUSED_ARGS);
    case 64: return dispatch_g<TC, 64>(G, FUSED_ARGS);
    case 128: return dispatch_g<TC, 128>(G, FUSED_ARGS);
    case 256: return dispatch_g<TC, 256>(G, FUSED_ARGS);
    default: return -2;
  }
}

#undef FUSED_ARGS

}  // namespace
}  // namespace substratus

extern "C" int fused_decode(const void* q, const void* new_k, const void* new_v,
                            const void* new_ks, const void* new_vs, void* k, void* v,
                            const void* k_scale, const void* v_scale, const void* pos, void* o,
                            int B, int H, int KH, int S, int D, int cache_dtype, float scale,
                            void* stream) {
  using namespace substratus;
  if (B < 1 || S < 1 || KH < 1 || H % KH != 0) return -1;
  const int G = H / KH;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cache_dtype) {
    case kBF16:
      return dispatch_d<__nv_bfloat16>(D, G, q, new_k, new_v, nullptr, nullptr, k, v, nullptr,
                                       nullptr, pos, o, B, KH, S, scale, s);
    case kInt8:
      if (new_ks == nullptr || new_vs == nullptr || k_scale == nullptr || v_scale == nullptr)
        return -1;
      return dispatch_d<int8_t>(D, G, q, new_k, new_v, new_ks, new_vs, k, v, k_scale, v_scale,
                                pos, o, B, KH, S, scale, s);
    default:
      return -3;
  }
}
