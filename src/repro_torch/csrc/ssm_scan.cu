// Selective scan (Mamba S6): h_t = a_t * h_{t-1} + b_t over time.
//
// Replaces the TPU kernel `_ssm_kernel` of src/repro/kernels/ssm_scan/kernel.py
// (wrapper `ssm_scan`).  decay a and drive b are (B, S, C, N) in float32 or
// bfloat16, h0 is (B, C, N) float32, and the output (B, S, C, N) float32 holds
// every h_t.  The C * N lanes of a sequence are independent; time is the only
// sequential axis.
//
// What bounds it on an H100: bytes.  Each element is read twice (a, b) and
// written once in float32, 12 bytes for 2 operations, some 250 times below the
// card's ~20 float32 operations per byte.  So the design only has to keep the
// memory system busy and never read an element twice:
//
//  * one thread per (b, c, n) lane carries h in a register and walks S in
//    order; the TPU grid's sequential chunk axis, with its carry in VMEM,
//    becomes that loop, so no chunk size or divisibility remains;
//  * for a fixed t the threads of a warp touch consecutive elements of the
//    contiguous C * N axis, so every load and store is coalesced; any C and N
//    work, the ragged last block is masked;
//  * the loop is unrolled by kUnroll: the 2 * kUnroll loads of a stretch do
//    not depend on h, so they are all in flight before the first multiply.
//
// Rounding: h = a * h, then h = h + b, each rounded once (__fmul_rn,
// __fadd_rn, never contracted into a multiply-add), as the plain PyTorch
// version rounds them, so kernel and plain version agree bit for bit.
//
// Simple first: no cp.async/TMA prefetch of the next time rows, and the C . h
// readout of the Mamba layer is not fused in, so all of (B, S, C, N) goes
// through device memory.  Both are for a later PR.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ decay, const T* __restrict__ drive,
                const float* __restrict__ h0, float* __restrict__ out, int S,
                long long lanes) {
  const long long lane =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= lanes) return;
  const long long b = blockIdx.y;
  float h = h0[b * lanes + lane];
  const long long base = b * S * lanes + lane;
  const T* a_p = decay + base;
  const T* b_p = drive + base;
  float* o_p = out + base;
  for (int t0 = 0; t0 < S; t0 += kUnroll) {
    float a[kUnroll], d[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < S) {
        const long long off = static_cast<long long>(t0 + u) * lanes;
        a[u] = to_f(a_p[off]);
        d[u] = to_f(b_p[off]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < S) {
        h = __fadd_rn(__fmul_rn(a[u], h), d[u]);
        o_p[static_cast<long long>(t0 + u) * lanes] = h;
      }
    }
  }
}

template <typename T>
cudaError_t launch_typed(const void* decay, const void* drive,
                         const float* h0, float* out, int B, int S,
                         long long lanes, cudaStream_t stream) {
  const long long blocks = (lanes + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL || B > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks), B);
  ssm_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(decay), static_cast<const T*>(drive), h0, out, S,
      lanes);
  return cudaGetLastError();
}

}  // namespace

// decay, drive (B, S, C, N) in float32 (bf16 = 0) or bfloat16; h0 (B, C, N)
// and out (B, S, C, N) float32.  All contiguous.  Returns the launch's CUDA
// error code.
extern "C" int dynims_ssm_scan(int bf16, const void* decay, const void* drive,
                               const void* h0, void* out, int B, int S, int C,
                               int N, void* stream) {
  if (B <= 0 || S <= 0 || C <= 0 || N <= 0) return cudaErrorInvalidValue;
  const long long lanes = static_cast<long long>(C) * N;
  const float* h = static_cast<const float*>(h0);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_typed<__nv_bfloat16>(decay, drive, h, o, B, S, lanes, st);
  return launch_typed<float>(decay, drive, h, o, B, S, lanes, st);
}
