// Single-token decode attention over the dense slot cache, bf16 or int8,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel substratus_tpu/ops/decode_attention.py _kernel
// (driven by _pallas / decode_attention(impl="pallas")), run once per
// layer on every decode step.
//
// Layout: q [B, 1, H, D] bf16; k/v [B, KH, S, D] bf16 or int8, with f32
// scales [B, KH, S] for int8; pos [B] int32; o [B, 1, H, D] bf16. Row b
// attends cache columns 0..pos[b] (all S when pos[b] >= S; none when
// pos[b] < 0, and then its output is 0).
//
// Design. One block per (b, kv head), serving the G = H / KH query rows
// of its group, so each kv head's history is read once for all of them.
// The loop covers only columns 0..pos[b]: that trip count is where the
// bandwidth goes. The loop (decode_common.cuh, shared with
// fused_decode.cu) reads 16 bytes per lane, keeps one online-softmax
// state per sub-group of lanes and merges them by shuffles; the states of
// the warps merge here through shared memory. int8: k_scale multiplies
// the score after the dot and v_scale folds into p, so no dequantized
// copy of the cache is made.
//
// Numerics follow _kernel: q is scaled by D^-0.5 in f32, dots and the
// softmax are f32, p stays f32 for the PV product, out = acc / l.
//
// Bound on an H100 (3.35 TB/s): the cache rows 0..pos[b] must be read
// once, so the kernel is bound by bytes (at llama2-7b, B=8, S=1024,
// bf16: 2 x 8 x 32 x 1024 x 128 x 2 B = 134 MB per layer at full
// positions, about 40 us). At llama2-7b (KH=32) and B=8 the grid is 256
// blocks on 132 SMs; a GQA model at small batch (KH=8, B=8: 64 blocks)
// fills under half of them. csrc/decode_split.cu splits S over more
// blocks and serves head_dim 64 and 128 (ops/fused_decode.py::
// decode_design); this kernel serves 16, 32 and 256 (129-255
// padded to 256; a group other than 1, 2, 4 or 8 at 256 goes to the split
// design), and its 64/128
// instances stay for chip_smoke.py's side-by-side timing.
#include "decode_common.cuh"

namespace substratus {
namespace {

using decode::NW;

template <typename TC, int D, int G>
__global__ void __launch_bounds__(NW * 32) decode_attn_kernel(
    const __nv_bfloat16* __restrict__ q, const TC* __restrict__ k,
    const TC* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ pos,
    __nv_bfloat16* __restrict__ o, int KH, int S, float scale) {
  constexpr bool kQuant = sizeof(TC) == 1;
  decode::Partials<G, D>& part = decode::partials<G, D>();

  const int b = blockIdx.x / KH;
  const int kvh = blockIdx.x % KH;
  const int H = KH * G;
  const int p = pos[b];
  const int n = p < 0 ? 0 : min(p + 1, S);
  const size_t head = (size_t)b * KH + kvh;
  decode::attend_rows<TC, D, G>(q + ((size_t)b * H + kvh * G) * D, k + head * S * D,
                                v + head * S * D, kQuant ? k_scale + head * S : nullptr,
                                kQuant ? v_scale + head * S : nullptr, n, scale, part);

  // Merge across warps: one thread per (g, d).
  for (int i = threadIdx.x; i < G * D; i += NW * 32) {
    const int g = i / D, d = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, part.m[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = expf(part.m[w][g] - mx);
      lsum += c * part.l[w][g];
      a += c * part.acc[w][g][d];
    }
    const float out = lsum == 0.f ? 0.f : a / lsum;
    o[((size_t)b * H + kvh * G + g) * D + d] = __float2bfloat16(out);
  }
}

template <typename TC, int D, int G>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* pos, void* o, int B, int KH, int S, float scale, cudaStream_t stream) {
  static bool configured = false;
  return decode::launch_rows<G, D>(
      decode_attn_kernel<TC, D, G>, B * KH, stream, configured, static_cast<const __nv_bfloat16*>(q),
      static_cast<const TC*>(k), static_cast<const TC*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(pos), static_cast<__nv_bfloat16*>(o), KH, S,
      scale);
}

template <typename TC, int D>
int dispatch_g(int G, const void* q, const void* k, const void* v, const void* ks,
               const void* vs, const void* pos, void* o, int B, int KH, int S, float scale,
               cudaStream_t stream) {
  switch (G) {
    case 1: return launch<TC, D, 1>(q, k, v, ks, vs, pos, o, B, KH, S, scale, stream);
    case 2: return launch<TC, D, 2>(q, k, v, ks, vs, pos, o, B, KH, S, scale, stream);
    case 4: return launch<TC, D, 4>(q, k, v, ks, vs, pos, o, B, KH, S, scale, stream);
    case 8: return launch<TC, D, 8>(q, k, v, ks, vs, pos, o, B, KH, S, scale, stream);
    default: return -2;
  }
}

template <typename TC>
int dispatch_d(int D, int G, const void* q, const void* k, const void* v, const void* ks,
               const void* vs, const void* pos, void* o, int B, int KH, int S, float scale,
               cudaStream_t stream) {
  switch (D) {
    case 16: return dispatch_g<TC, 16>(G, q, k, v, ks, vs, pos, o, B, KH, S, scale, stream);
    case 32: return dispatch_g<TC, 32>(G, q, k, v, ks, vs, pos, o, B, KH, S, scale, stream);
    case 64: return dispatch_g<TC, 64>(G, q, k, v, ks, vs, pos, o, B, KH, S, scale, stream);
    case 128: return dispatch_g<TC, 128>(G, q, k, v, ks, vs, pos, o, B, KH, S, scale, stream);
    case 256: return dispatch_g<TC, 256>(G, q, k, v, ks, vs, pos, o, B, KH, S, scale, stream);
    default: return -2;
  }
}

}  // namespace
}  // namespace substratus

extern "C" int decode_attn(const void* q, const void* k, const void* v, const void* k_scale,
                           const void* v_scale, const void* pos, void* o, int B, int H, int KH,
                           int S, int D, int cache_dtype, float scale, void* stream) {
  using namespace substratus;
  if (B < 1 || S < 1 || KH < 1 || H % KH != 0) return -1;
  const int G = H / KH;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cache_dtype) {
    case kBF16:
      return dispatch_d<__nv_bfloat16>(D, G, q, k, v, nullptr, nullptr, pos, o, B, KH, S, scale, s);
    case kInt8:
      if (k_scale == nullptr || v_scale == nullptr) return -1;
      return dispatch_d<int8_t>(D, G, q, k, v, k_scale, v_scale, pos, o, B, KH, S, scale, s);
    default:
      return -3;
  }
}
