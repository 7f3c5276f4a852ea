// Flash attention: GQA self-attention with causal and sliding-window masks.
//
// Replaces the TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention/kernel.py (wrapper `flash_attention`).
// q (B, Sq, H, hd) attends k/v (B, Skv, KV, hd), query head h reading kv head
// h / (H / KV), over positions arange(Sq) and arange(Skv): key k is kept for
// query i iff (not causal or k <= i) and (no window or k > i - window).  The
// softmax runs online over kv tiles in float32 and the output, acc / max(l,
// 1e-30), is written in q's type.
//
// What bounds it on an H100: operations (4 * hd per kept (query, key) pair
// against 2 * hd * 2 bytes of K/V per key per 64-row q tile).  The design:
//
//  * one block per (64-row q tile, head, sequence); a loop inside the block
//    takes the TPU grid's sequential kv axis, carrying the row max, row sum and
//    the (64 x hd) accumulator in registers;
//  * the loop covers only tiles that hold a kept key: from the first key the
//    window reaches to the last key the causal diagonal reaches
//    (kernel.py:45-50 skips the same tiles by a test per tile);
//  * Q, K and V tiles are staged in shared memory as float with 16-byte loads;
//    each thread computes a 4 x 8 block of scores from registers loaded once
//    per head dimension, so a shared-memory read feeds 2.7 multiply-adds;
//  * rows past Sq and keys past Skv are zero-filled, so any Sq and Skv work.
//
// Simple first: the products run on the CUDA cores in float32 (67 TFLOP/s),
// not the tensor cores (989 TFLOP/s in bf16), and nothing overlaps a tile's
// loads with the previous tile's math.  mma/wgmma and TMA are for a later PR.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;           // 16 row groups x 8 column lanes
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kRows = 4;                // rows per thread: 16 x 4 = 64
constexpr int kCols = 8;                // score columns per thread: 8 x 8 = 64
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

// Rows r0 .. r0 + 63 of a (rows, heads, hd) slice into `dst` (float, row
// stride `ld`): rows below `n` are loaded with 16-byte loads, the rest zeroed.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long row_stride, int r0,
                                          int n) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = HD / VEC;
  for (int c = threadIdx.x; c < 64 * PER_ROW; c += kThreads) {
    const int r = c / PER_ROW;
    const int col = (c % PER_ROW) * VEC;
    float* d = dst + r * ld + col;
    if (r0 + r < n) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          src + (r0 + r) * row_stride + col);
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) d[j] = to_f(vals[j]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) d[j] = 0.f;
    }
  }
}

template <int HD>
constexpr int smem_bytes() {
  return (kBQ * (HD + 1) + kBK * (HD + 1) + kBK * HD + kBQ * (kBK + 1)) * 4;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Sq, int Skv,
             int H, int KV, int causal, int window) {
  constexpr int DCOLS = HD / 8;         // output dims per thread
  extern __shared__ float smem[];
  float* qs = smem;                              // [kBQ][HD + 1]
  float* ks = qs + kBQ * (HD + 1);               // [kBK][HD + 1]
  float* vs = ks + kBK * (HD + 1);               // [kBK][HD]
  float* ps = vs + kBK * HD;                     // [kBQ][kBK + 1]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int ty = tid / 8;
  const int tx = tid % 8;
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));

  const long long q_stride = static_cast<long long>(H) * HD;
  const long long kv_stride = static_cast<long long>(KV) * HD;
  const T* qb = q + (static_cast<long long>(b) * Sq * H + h) * HD;
  const T* kb = k + (static_cast<long long>(b) * Skv * KV + kvh) * HD;
  const T* vb = v + (static_cast<long long>(b) * Skv * KV + kvh) * HD;
  load_tile<T, HD>(qs, HD + 1, qb, q_stride, q0, Sq);

  float m[kRows], l[kRows], acc[kRows][DCOLS];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DCOLS; ++j) acc[i][j] = 0.f;
  }

  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int k_end = causal ? min(Skv, q_last + 1) : Skv;
  const int k_first = window > 0 ? max(q0 - window + 1, 0) : 0;

  for (int k0 = (k_first / kBK) * kBK; k0 < k_end; k0 += kBK) {
    load_tile<T, HD>(ks, HD + 1, kb, kv_stride, k0, Skv);
    load_tile<T, HD>(vs, HD, vb, kv_stride, k0, Skv);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int e = 0; e < HD; ++e) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty * kRows + i) * (HD + 1) + e];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = ks[(tx + 8 * j) * (HD + 1) + e];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + ty * kRows + i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + tx + 8 * j;
        bool keep = kj < Skv;
        if (causal) keep = keep && kj <= qi;
        if (window > 0) keep = keep && kj > qi - window;
        s[i][j] = keep ? s[i][j] * scale : kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
      // the 8 lanes of a row group are adjacent: reduce over lane bits 0-2
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 2));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 4));
      const float m_new = fmaxf(m[i], rmax);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty * kRows + i) * (kBK + 1) + tx + 8 * j] = p;
        rsum += p;
      }
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 2);
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 4);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DCOLS; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[kRows], vv[DCOLS];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty * kRows + i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < DCOLS; ++j) vv[j] = vs[kk * HD + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < DCOLS; ++j) acc[i][j] += pv[i] * vv[j];
    }
    __syncthreads();
  }

  T* ob = out + (static_cast<long long>(b) * Sq * H + h) * HD;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty * kRows + i;
    if (qi < Sq) {
      const float inv = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < DCOLS; ++j)
        ob[qi * q_stride + tx + 8 * j] = from_f<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* out,
                      int B, int Sq, int Skv, int H, int KV, int causal,
                      int window, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, H, KV, causal,
      window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         void* out, int B, int Sq, int Skv, int H, int KV,
                         int hd, int causal, int window, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch_hd<T, 16>(q, k, v, out, B, Sq, Skv, H, KV, causal, window,
                              stream);
    case 32:
      return launch_hd<T, 32>(q, k, v, out, B, Sq, Skv, H, KV, causal, window,
                              stream);
    case 64:
      return launch_hd<T, 64>(q, k, v, out, B, Sq, Skv, H, KV, causal, window,
                              stream);
    case 128:
      return launch_hd<T, 128>(q, k, v, out, B, Sq, Skv, H, KV, causal,
                               window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Sq, H, hd), k and v (B, Skv, KV, hd) and out (B, Sq, H, hd), all
// float32 (bf16 = 0) or all bfloat16, contiguous and 16-byte aligned.
// Returns the launch's CUDA error code.
extern "C" int dynims_flash_attention(int bf16, const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int Skv, int H, int KV, int hd,
                                      int causal, int window, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KV <= 0 || H % KV != 0 || H > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_typed<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H, KV, hd,
                                       causal, window, st);
  return launch_typed<float>(q, k, v, out, B, Sq, Skv, H, KV, hd, causal,
                             window, st);
}
