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
// bandwidth goes. Each warp splits into sub-groups of D/8 lanes; a
// sub-group reads one cache row at a time, 8 elements (16 bytes of bf16)
// per lane, two rows in flight per iteration. Every sub-group keeps its
// own online-softmax state (m, l, acc) per query row; the states merge
// across sub-groups by shuffles and across warps through shared memory.
// int8: k_scale multiplies the score after the dot and v_scale folds
// into p, so no dequantized copy of the cache is made.
//
// Numerics follow _kernel: q is scaled by D^-0.5 in f32, dots and the
// softmax are f32, p stays f32 for the PV product, out = acc / l.
//
// Bound on an H100 (3.35 TB/s): the cache rows 0..pos[b] must be read
// once, so the kernel is bound by bytes (at llama2-7b, B=8, S=1024,
// bf16: 2 x 8 x 32 x 1024 x 128 x 2 B = 134 MB per layer at full
// positions, about 40 us). At llama2-7b (KH=32) and B=8 the grid is 256
// blocks on 132 SMs; a GQA model at small batch (KH=8, B=8: 64 blocks)
// fills under half of them. Splitting S over more blocks
// (flash-decoding) is later work.
#include "common.cuh"

namespace substratus {
namespace {

constexpr int NW = 8;   // warps per block
constexpr int VEC = 8;  // cache elements per lane per row
constexpr int U = 2;    // rows in flight per sub-group per iteration

template <typename TC> struct Row8;

// 8 bf16 = 16 bytes
template <> struct Row8<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h2[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

// 8 int8 = 8 bytes
template <> struct Row8<int8_t> {
  static __device__ __forceinline__ void load(const int8_t* p, float* out) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = (float)c[i];
  }
};

template <typename TC, int D, int G>
__global__ void __launch_bounds__(NW * 32) decode_attn_kernel(
    const __nv_bfloat16* __restrict__ q, const TC* __restrict__ k,
    const TC* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ pos,
    __nv_bfloat16* __restrict__ o, int KH, int S, float scale) {
  constexpr int LPR = D / VEC;    // lanes per cache row
  constexpr int RPW = 32 / LPR;   // rows per warp at a time
  constexpr int NSUB = NW * RPW;  // sub-groups per block
  static_assert(D % VEC == 0 && 32 % LPR == 0, "unsupported head_dim");
  constexpr bool kQuant = sizeof(TC) == 1;

  __shared__ float sm_m[NW][G];
  __shared__ float sm_l[NW][G];
  __shared__ float sm_acc[NW][G][D];

  const int b = blockIdx.x / KH;
  const int kvh = blockIdx.x % KH;
  const int H = KH * G;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane / LPR;
  const int e0 = (lane % LPR) * VEC;  // this lane's first element
  const int group = warp * RPW + sub;
  const unsigned full = 0xffffffffu;

  const int p = pos[b];
  const int n = p < 0 ? 0 : min(p + 1, S);

  float qr[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const __nv_bfloat16* qp = q + ((size_t)b * H + kvh * G + g) * D + e0;
#pragma unroll
    for (int e = 0; e < VEC; ++e) qr[g][e] = __bfloat162float(qp[e]) * scale;
  }
  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

  const size_t head = (size_t)b * KH + kvh;
  const TC* kh = k + head * S * D + e0;
  const TC* vh = v + head * S * D + e0;
  const float* ksh = kQuant ? k_scale + head * S : nullptr;
  const float* vsh = kQuant ? v_scale + head * S : nullptr;

  for (int base = 0; base < n; base += NSUB * U) {
    float kf[U][VEC], vf[U][VEC], ks[U], vs[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = base + u * NSUB + group;
      ok[u] = s < n;
      if (ok[u]) {
        Row8<TC>::load(kh + (size_t)s * D, kf[u]);
        Row8<TC>::load(vh + (size_t)s * D, vf[u]);
        ks[u] = kQuant ? ksh[s] : 1.f;
        vs[u] = kQuant ? vsh[s] : 1.f;
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[u][e] = vf[u][e] = 0.f;
        ks[u] = vs[u] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot += qr[g][e] * kf[u][e];
        // Reduce over the sub-group's lanes (all lanes take part: the
        // shuffles sit outside the ok[u] branch).
#pragma unroll
        for (int off = LPR / 2; off > 0; off /= 2) dot += __shfl_xor_sync(full, dot, off);
        if (ok[u]) {
          const float s = kQuant ? dot * ks[u] : dot;
          const float m_new = fmaxf(m[g], s);
          const float alpha = expf(m[g] - m_new);
          const float pr = expf(s - m_new);
          l[g] = alpha * l[g] + pr;
          const float pv = kQuant ? pr * vs[u] : pr;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[g][e] = acc[g][e] * alpha + pv * vf[u][e];
          m[g] = m_new;
        }
      }
    }
  }

  // Merge the RPW sub-groups of this warp: lanes lane and lane ^ (k*LPR)
  // hold the same elements for different rows.
#pragma unroll
  for (int off = LPR; off < 32; off *= 2) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float m_o = __shfl_xor_sync(full, m[g], off);
      const float l_o = __shfl_xor_sync(full, l[g], off);
      const float m_new = fmaxf(m[g], m_o);
      const float a = expf(m[g] - m_new);
      const float a_o = expf(m_o - m_new);
      l[g] = a * l[g] + a_o * l_o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float acc_o = __shfl_xor_sync(full, acc[g][e], off);
        acc[g][e] = a * acc[g][e] + a_o * acc_o;
      }
      m[g] = m_new;
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) sm_acc[warp][g][e0 + e] = acc[g][e];
    }
  }
  __syncthreads();

  // Merge across warps: one thread per (g, d).
  for (int i = threadIdx.x; i < G * D; i += NW * 32) {
    const int g = i / D, d = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = expf(sm_m[w][g] - mx);
      lsum += c * sm_l[w][g];
      a += c * sm_acc[w][g][d];
    }
    const float out = lsum == 0.f ? 0.f : a / lsum;
    o[((size_t)b * H + kvh * G + g) * D + d] = __float2bfloat16(out);
  }
}

template <typename TC, int D, int G>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* pos, void* o, int B, int KH, int S, float scale, cudaStream_t stream) {
  decode_attn_kernel<TC, D, G><<<B * KH, NW * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const TC*>(k),
      static_cast<const TC*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(pos),
      static_cast<__nv_bfloat16*>(o), KH, S, scale);
  return (int)cudaGetLastError();
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
