// Decode attention: one query token per (sequence, head) against a KV cache.
//
// Replaces the TPU kernel `_decode_kernel` of
// src/repro/kernels/decode_attention/kernel.py (wrapper `decode_attention`).
// For every sequence b and query head h it attends keys [start_b, len_b) of
// the (B, S, KV, hd) caches, start_b = max(len_b - window, 0) when a window
// is set, else 0, with an online softmax in float32, and writes
// acc / max(l, 1e-30) in q's type.  Keys outside [start_b, len_b) are never
// read: the NaN-poisoned-cache test holds it to that.
//
// What bounds it on an H100: bytes.  Each kept key costs 2 * hd * sizeof(cache)
// bytes of K and V and 4 * G * hd operations for the G query heads that share
// it, about G operations per byte in bf16 -- far below the card's ~20 f32
// operations per byte.  So the design spends its effort on reading each K/V row
// once and no row it does not need:
//
//  * one block per (kv head, sequence) serves all G = H / KV query heads of the
//    group, so a K/V row is read once per group, not G times;
//  * the block loads its own len_b (the TPU's scalar prefetch) and loops only
//    over the 32-key tiles from the one holding start_b to the one holding
//    len_b - 1; rows outside [start_b, len_b) of those tiles are zero-filled,
//    not loaded, so the cache length needs no relation to the tile (the TPU
//    wrapper's `s % block_k == 0` does not carry over);
//  * tiles are staged in shared memory as float with 16-byte loads, the K tile
//    padded by one column so the 32 lanes of a warp (one key each) read it
//    without bank conflicts;
//  * a warp owns a query head: lane = key for the score, max and sum by warp
//    shuffles; then each thread owns (head, dim) pairs of the output
//    accumulator in registers.
//
// Simple first: no cp.async/TMA double buffering yet, so a block waits for each
// tile's loads; many blocks per SM hide part of that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;               // keys per tile: one per lane
constexpr int kMaxGroup = 16;           // query heads per kv head
constexpr int kHeadsPerWarp = kMaxGroup / kWarps;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows k0 .. k0 + kTile - 1 of a cache slice into `dst` (float, row stride
// `ld`): rows in [lo, hi) are loaded with 16-byte loads, the rest zeroed.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long row_stride, int k0,
                                          int lo, int hi) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = HD / VEC;
  for (int c = threadIdx.x; c < kTile * PER_ROW; c += kThreads) {
    const int r = c / PER_ROW;
    const int col = (c % PER_ROW) * VEC;
    const int key = k0 + r;
    float* d = dst + r * ld + col;
    if (key >= lo && key < hi) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + key * row_stride + col);
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) d[j] = to_f(vals[j]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) d[j] = 0.f;
    }
  }
}

template <typename TQ, typename TKV, int HD>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_cache,
              const TKV* __restrict__ v_cache, const int* __restrict__ lengths,
              TQ* __restrict__ out, int H, int KV, int S, int window) {
  constexpr int G_STRIDE = kThreads / HD;     // heads per accumulator pass
  constexpr int MAX_ACC = kMaxGroup / G_STRIDE;
  __shared__ float ks[kTile][HD + 1];
  __shared__ float vs[kTile][HD];
  __shared__ float qs[kMaxGroup][HD];
  __shared__ float ps[kMaxGroup][kTile];
  __shared__ float corr_s[kMaxGroup];
  __shared__ float l_s[kMaxGroup];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int len = min(max(lengths[b], 0), S);
  const int start = window > 0 ? max(len - window, 0) : 0;
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));

  const TQ* qb = q + (static_cast<long long>(b) * H + kvh * G) * HD;
  for (int i = tid; i < G * HD; i += kThreads) qs[i / HD][i % HD] = to_f(qb[i]);

  const long long row_stride = static_cast<long long>(KV) * HD;
  const long long base =
      (static_cast<long long>(b) * S * KV + kvh) * static_cast<long long>(HD);
  const TKV* kb = k_cache + base;
  const TKV* vb = v_cache + base;

  float m[kHeadsPerWarp], l[kHeadsPerWarp];
#pragma unroll
  for (int i = 0; i < kHeadsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  const int d = tid % HD;
  const int g0 = tid / HD;
  float acc[MAX_ACC];
#pragma unroll
  for (int i = 0; i < MAX_ACC; ++i) acc[i] = 0.f;

  for (int k0 = (start / kTile) * kTile; k0 < len; k0 += kTile) {
    load_tile<TKV, HD>(&ks[0][0], HD + 1, kb, row_stride, k0, start, len);
    load_tile<TKV, HD>(&vs[0][0], HD, vb, row_stride, k0, start, len);
    __syncthreads();

    const int key = k0 + lane;
    const bool valid = key >= start && key < len;
#pragma unroll
    for (int i = 0; i < kHeadsPerWarp; ++i) {
      const int g = warp + i * kWarps;
      if (g < G) {                              // uniform across the warp
        float s = 0.f;
#pragma unroll 16
        for (int e = 0; e < HD; ++e) s += qs[g][e] * ks[lane][e];
        s = valid ? s * scale : kNegInf;
        const float m_new = fmaxf(m[i], warp_max(s));
        const float p = expf(s - m_new);
        const float c = expf(m[i] - m_new);
        l[i] = l[i] * c + warp_sum(p);
        m[i] = m_new;
        ps[g][lane] = p;
        if (lane == 0) corr_s[g] = c;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < MAX_ACC; ++i) {
      const int g = g0 + i * G_STRIDE;
      if (g < G) {
        float a = acc[i] * corr_s[g];
#pragma unroll 8
        for (int kk = 0; kk < kTile; ++kk) a += ps[g][kk] * vs[kk][d];
        acc[i] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kHeadsPerWarp; ++i) {
    const int g = warp + i * kWarps;
    if (g < G && lane == 0) l_s[g] = l[i];
  }
  __syncthreads();

  TQ* ob = out + (static_cast<long long>(b) * H + kvh * G) * HD;
#pragma unroll
  for (int i = 0; i < MAX_ACC; ++i) {
    const int g = g0 + i * G_STRIDE;
    if (g < G) ob[g * HD + d] = from_f<TQ>(acc[i] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename TQ, typename TKV>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const int* lengths, void* out, int B, int H, int KV,
                         int S, int hd, int window, cudaStream_t stream) {
  const dim3 grid(KV, B);
  const TQ* qt = static_cast<const TQ*>(q);
  const TKV* kt = static_cast<const TKV*>(k);
  const TKV* vt = static_cast<const TKV*>(v);
  TQ* ot = static_cast<TQ*>(out);
  switch (hd) {
    case 16:
      decode_kernel<TQ, TKV, 16><<<grid, kThreads, 0, stream>>>(
          qt, kt, vt, lengths, ot, H, KV, S, window);
      break;
    case 32:
      decode_kernel<TQ, TKV, 32><<<grid, kThreads, 0, stream>>>(
          qt, kt, vt, lengths, ot, H, KV, S, window);
      break;
    case 64:
      decode_kernel<TQ, TKV, 64><<<grid, kThreads, 0, stream>>>(
          qt, kt, vt, lengths, ot, H, KV, S, window);
      break;
    case 128:
      decode_kernel<TQ, TKV, 128><<<grid, kThreads, 0, stream>>>(
          qt, kt, vt, lengths, ot, H, KV, S, window);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// q (B, H, hd) and out in float32 (q_bf16 = 0) or bfloat16; caches
// (B, S, KV, hd) in float32 (kv_bf16 = 0) or bfloat16; lengths (B,) int32.
// All contiguous and 16-byte aligned.  Returns the launch's CUDA error code.
extern "C" int dynims_decode_attention(int q_bf16, int kv_bf16, const void* q,
                                       const void* k_cache,
                                       const void* v_cache,
                                       const void* lengths, void* out, int B,
                                       int H, int KV, int S, int hd,
                                       int window, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || H / KV > kMaxGroup || S <= 0)
    return cudaErrorInvalidValue;
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16 && kv_bf16)
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(
        q, k_cache, v_cache, lens, out, B, H, KV, S, hd, window, st);
  if (q_bf16)
    return launch_typed<__nv_bfloat16, float>(
        q, k_cache, v_cache, lens, out, B, H, KV, S, hd, window, st);
  if (kv_bf16)
    return launch_typed<float, __nv_bfloat16>(
        q, k_cache, v_cache, lens, out, B, H, KV, S, hd, window, st);
  return launch_typed<float, float>(q, k_cache, v_cache, lens, out, B, H, KV,
                                    S, hd, window, st);
}
