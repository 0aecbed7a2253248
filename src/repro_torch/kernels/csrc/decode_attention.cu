// One-token decode attention against the KV cache, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention / _kernel).  Same function: each query row q[b, h]
// attends the cached rows p of kv head h / (Hq / Hkv) with
// p < valid_len and, for window > 0, p > valid_len - window; scores
// q.k / sqrt(hd) in float32, optional softcap, online softmax, output
// acc / max(l, 1e-37) in q's dtype.  Layouts: q, o [B, Hq, hd];
// cache k, v [B, Hkv, S, hd]; valid_len int32 [B], one length per slot (the
// TPU kernel took one scalar for the whole batch; the engine's slots are
// ragged).  A row needs valid_len >= 1; valid_len > S reads S rows.
//
// Design.  The TPU kernel streams the whole cache through a sequential kv
// grid axis with a [S] bias vector of 0 / -2e38.  Here one block of 8 warps
// owns one (b, kv head) and serves all g q heads of its group, so each
// cached row is read once per group, and it loops only over the admitted
// positions [max(0, valid - window + 1), valid): the masked part of the
// cache is never read.  Warp w takes groups of 4 rows at positions
// first + 4 (w + 8 i); a lane holds hd / 32 elements of each row (one vector
// load), dot products are warp shuffles, and each warp keeps its own m / l /
// acc per head in registers.  The 8 partial states are merged in shared
// memory at the end (the flash-decoding combine).
//
// What bounds it on an H100: bytes.  It reads each admitted K and V row
// once (2 * hd * dtype bytes per row per kv head) and does 4 * hd * g
// flops per row, far below the card's ridge point.  One block per
// (b, kv head) gives 128 blocks at the serving path's shapes (8 slots x 16
// kv heads), about one per SM; splitting each slot's positions over more
// blocks is a later change.  The measured time and bound are in PERF.md.

#include <cmath>

#include "attention_common.cuh"

namespace attn {

constexpr int kDecodeWarps = 8;
constexpr int kDecodeRows = 4;   // rows per warp step
constexpr int kMaxGroup = 8;     // q heads per kv head

template <typename T, int HD>
__global__ void __launch_bounds__(kDecodeWarps * 32)
decode_forward(const T* __restrict__ q, const T* __restrict__ ck,
               const T* __restrict__ cv, const int32_t* __restrict__ valid_len,
               T* __restrict__ o, int Hq, int Hkv, int S, int window,
               float softcap, float scale) {
  constexpr int E = HD / 32;  // elements of a row per lane
  constexpr int U = kDecodeRows;
  constexpr int NW = kDecodeWarps;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int g = Hq / Hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const int valid = valid_len[b];
  const int hi = min(valid, S);
  const int first = window > 0 ? max(0, valid - window + 1) : 0;

  float qf[kMaxGroup][E], acc[kMaxGroup][E], m[kMaxGroup], l[kMaxGroup];
#pragma unroll
  for (int h = 0; h < kMaxGroup; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      qf[h][e] = 0.f;
      acc[h][e] = 0.f;
    }
    if (h < g) {
      load_f32<T, E>(q + (int64_t(b) * Hq + hk * g + h) * HD + lane * E,
                     qf[h]);
#pragma unroll
      for (int e = 0; e < E; ++e) qf[h][e] *= scale;
    }
  }

  const int64_t base = (int64_t(b) * Hkv + hk) * S * HD + lane * E;
  for (int p0 = first + warp * U; p0 < hi; p0 += NW * U) {
    float kf[U][E], vf[U][E];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int e = 0; e < E; ++e) kf[u][e] = vf[u][e] = 0.f;
      if (p0 + u < hi) {
        load_f32<T, E>(ck + base + int64_t(p0 + u) * HD, kf[u]);
        load_f32<T, E>(cv + base + int64_t(p0 + u) * HD, vf[u]);
      }
    }
    float s[kMaxGroup][U];
#pragma unroll
    for (int h = 0; h < kMaxGroup; ++h)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float dot = 0.f;
        if (h < g) {
#pragma unroll
          for (int e = 0; e < E; ++e) dot = fmaf(qf[h][e], kf[u][e], dot);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
        }
        s[h][u] = dot;
      }
#pragma unroll
    for (int h = 0; h < kMaxGroup; ++h) {
      if (h >= g) continue;
      float mx = m[h];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float x = p0 + u < hi ? cap_score(s[h][u], softcap) : kNegInf;
        s[h][u] = x;
        mx = fmaxf(mx, x);
      }
      const float alpha = expf(m[h] - mx);
      l[h] *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[h][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = expf(s[h][u] - mx);
        l[h] += p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[h][e] = fmaf(p, vf[u][e], acc[h][e]);
      }
      m[h] = mx;
    }
  }

  // merge the warps' partial states: [NW][g] m and l, [NW][g][HD] acc
  extern __shared__ float smem[];
  float* sm_m = smem;
  float* sm_l = sm_m + NW * g;
  float* sm_acc = sm_l + NW * g;
#pragma unroll
  for (int h = 0; h < kMaxGroup; ++h) {
    if (h >= g) continue;
    if (lane == 0) {
      sm_m[warp * g + h] = m[h];
      sm_l[warp * g + h] = l[h];
    }
#pragma unroll
    for (int e = 0; e < E; ++e)
      sm_acc[(warp * g + h) * HD + lane * E + e] = acc[h][e];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < g * HD; t += blockDim.x) {
    const int h = t / HD, d = t % HD;
    float mx = kNegInf;
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w * g + h]);
    float den = 0.f, num = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float f = expf(sm_m[w * g + h] - mx);
      den = fmaf(sm_l[w * g + h], f, den);
      num = fmaf(sm_acc[(w * g + h) * HD + d], f, num);
    }
    o[(int64_t(b) * Hq + hk * g + h) * HD + d] =
        from_f32<T>(num / fmaxf(den, kMinDenom));
  }
}

template <typename T, int HD>
int launch_decode(const void* q, const void* k, const void* v,
                  const void* valid_len, void* o, int B, int Hq, int Hkv,
                  int S, int window, float softcap, void* stream) {
  const int g = Hq / Hkv;
  const int smem = kDecodeWarps * g * (HD + 2) * int(sizeof(float));
  const dim3 grid(Hkv, B);
  decode_forward<T, HD><<<grid, kDecodeWarps * 32, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(valid_len),
      static_cast<T*>(o), Hq, Hkv, S, window, softcap,
      static_cast<float>(1.0 / std::sqrt(double(HD))));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attn

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; hd: 64 or 128; Hq / Hkv <= 8.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a shape the kernel does not take (the wrapper refuses those first).
int attn_decode_forward(const void* q, const void* k, const void* v,
                        const void* valid_len, void* o, int B, int Hq,
                        int Hkv, int S, int hd, int dtype, int window,
                        float softcap, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > attn::kMaxGroup ||
      S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && hd == 128)
    return attn::launch_decode<float, 128>(q, k, v, valid_len, o, B, Hq, Hkv,
                                           S, window, softcap, stream);
  if (dtype == 0 && hd == 64)
    return attn::launch_decode<float, 64>(q, k, v, valid_len, o, B, Hq, Hkv,
                                          S, window, softcap, stream);
  if (dtype == 1 && hd == 128)
    return attn::launch_decode<__nv_bfloat16, 128>(
        q, k, v, valid_len, o, B, Hq, Hkv, S, window, softcap, stream);
  if (dtype == 1 && hd == 64)
    return attn::launch_decode<__nv_bfloat16, 64>(
        q, k, v, valid_len, o, B, Hq, Hkv, S, window, softcap, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
