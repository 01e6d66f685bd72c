// The single-token attention loop shared by decode_attn.cu and
// fused_decode.cu: one block of NW warps serves the G query rows of one
// (batch, kv head) over cache rows [0, n).
//
// Each warp splits into sub-groups of D/8 lanes; a sub-group reads one
// cache row at a time, 8 elements (16 bytes of bf16) per lane, U rows in
// flight per iteration. Every sub-group keeps its own online-softmax
// state (m, l, acc) per query row; the states merge across the sub-groups
// of a warp by shuffles, and each warp leaves its merged state in shared
// memory for the caller's epilogue. int8: k_scale multiplies the score
// after the dot and v_scale folds into p, so no dequantized copy of the
// cache is made. q is scaled by `scale` in f32; dots, the softmax and
// the PV product are f32.
#pragma once

#include "common.cuh"

namespace substratus {
namespace decode {

constexpr int NW = 8;   // warps per block
constexpr int VEC = 8;  // cache elements per lane per row
constexpr int U = 2;    // rows in flight per sub-group per iteration

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return (float)x; }

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

// Per-warp online-softmax state of the G query rows. It lives in dynamic
// shared memory (partials): at head_dim 256 and G = 8 it is 64 KB, above
// the 48 KB a block's static shared memory may hold.
template <int G, int D>
struct Partials {
  float m[NW][G];
  float l[NW][G];
  float acc[NW][G][D];
};

template <int G, int D>
__device__ __forceinline__ Partials<G, D>& partials() {
  extern __shared__ __align__(16) unsigned char partials_raw[];
  return *reinterpret_cast<Partials<G, D>*>(partials_raw);
}

// Launch `kernel` (one block of NW warps per (slot, kv head)) with its
// Partials in dynamic shared memory, allowed once per instantiation.
template <int G, int D, typename Kernel, typename... Args>
int launch_rows(Kernel kernel, int blocks, cudaStream_t stream, bool& configured, Args... args) {
  constexpr size_t smem = sizeof(Partials<G, D>);
  if (cudaError_t err = allow_smem(kernel, smem, configured)) return (int)err;
  kernel<<<blocks, NW * 32, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// Attend cache rows [0, n) of one kv head: q [G, D] bf16 (the group's
// query rows), k/v [S, D] of that head, ks/vs [S] f32 when TC is int8.
// Leaves each warp's merged state in `part`; ends with __syncthreads().
template <typename TC, int D, int G>
__device__ __forceinline__ void attend_rows(const __nv_bfloat16* q, const TC* k, const TC* v,
                                            const float* ks_row, const float* vs_row, int n,
                                            float scale, Partials<G, D>& part) {
  constexpr int LPR = D / VEC;    // lanes per cache row
  constexpr int RPW = 32 / LPR;   // rows per warp at a time
  constexpr int NSUB = NW * RPW;  // sub-groups per block
  static_assert(D % VEC == 0 && 32 % LPR == 0, "unsupported head_dim");
  constexpr bool kQuant = sizeof(TC) == 1;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane / LPR;
  const int e0 = (lane % LPR) * VEC;  // this lane's first element
  const int group = warp * RPW + sub;
  const unsigned full = 0xffffffffu;

  float qr[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) qr[g][e] = __bfloat162float(q[g * D + e0 + e]) * scale;
  }
  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

  const TC* kh = k + e0;
  const TC* vh = v + e0;
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
        ks[u] = kQuant ? ks_row[s] : 1.f;
        vs[u] = kQuant ? vs_row[s] : 1.f;
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
        part.m[warp][g] = m[g];
        part.l[warp][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) part.acc[warp][g][e0 + e] = acc[g][e];
    }
  }
  __syncthreads();
}

}  // namespace decode
}  // namespace substratus
