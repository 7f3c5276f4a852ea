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
// What bounds it on an H100: operations, 4 * hd per kept (query, key) pair
// against 2 * hd * sizeof(T) bytes of K/V per key per q tile (0.139 ms at a
// causal 2 x 4096 forward of 32/8 heads of 64 in bf16 at 989 TFLOP/s; in f32,
// three TF32 products each at 495 TFLOP/s, 0.833 ms).  The design,
// flash-attention-2 on the tensor cores with `mma.sync`:
//
//  * one block per (q tile, head, sequence), the heaviest causal q tiles
//    launched first: 4 warps and 64 rows for bf16, 8 warps and 128 rows for
//    f32 (`Shape`); each warp owns 16 query rows and keeps their row max,
//    row sum and (16 x hd) accumulator in registers for the whole kv loop,
//    and in bf16 up to hd 128 their Q fragments too.  At hd 256 the
//    accumulator alone takes 128 registers: bf16 reads Q from shared memory
//    at each tile, as the f32 route always does, and f32 (8 warps, 64 rows)
//    gives each 16 rows to two warps, which both compute the rows' scores
//    and softmax, bit for bit alike, and each keep half of the output
//    columns: Q.K^T is done twice, and no warp spills;
//  * the loop covers only tiles that hold a kept key: from the first key the
//    window reaches to the last key the causal diagonal reaches
//    (kernel.py:45-50 skips the same tiles by a test per tile); a warp applies
//    the per-element mask only on a tile that crosses the diagonal, the
//    window's edge or Skv, and skips a tile wholly past its causal rows;
//  * K/V tiles of 64 keys (32 for f32 at hd 128 and bf16 at hd 256, 16 for
//    f32 at hd 256) stay in shared memory in their own type, double
//    buffered: `cp.async` brings tile j + 1 while tile j is multiplied.
//    Rows are swizzled (the 16-byte chunk index XOR the row) so that
//    `ldmatrix` and the f32 path's V reads meet no bank conflict; keys past
//    Skv and q rows past Sq are zero-filled, so any Sq and Skv work;
//  * bf16: `mma.m16n8k16` bf16 in f32; K comes in through `ldmatrix`, V
//    through `ldmatrix.trans`; the scores stay in registers, where two
//    adjacent n8 tiles of the accumulator, rounded to bf16, are the A
//    fragment of P.V;
//  * f32: 3xTF32 on `mma.m16n8k8` tf32 (CUTLASS's "fast f32"): each operand
//    x splits into hi = tf32(x) and lo = tf32(x - hi), and hi.lo + lo.hi +
//    hi.hi accumulate in f32, near f32 accuracy at three TF32 products.  Q
//    and each K/V tile are split once, by the whole block, into shared
//    memory (hi in place, lo beside it), not by every warp that reads them;
//    P is split in registers.  An n8 tile of the score accumulator is the A
//    fragment of P.V once the keys of the reduction are permuted (slot t
//    holds key 2t, slot t + 4 key 2t + 1); the V fragments are read in the
//    same permuted order.  Each tile's P.V is summed from zero and then added
//    to O, so the tensor cores' f32 rounding runs over 24 products, not over
//    a whole row's (at hd 256 in passes of 4 n8 tiles of the output).
//
// Not done yet: `wgmma` (the full tensor-core rate), TMA loads with mbarriers,
// warp specialisation (producer warp, two consumer warpgroups in ping-pong),
// and one block per GQA group sharing its K/V tiles (L2 serves them today).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// A (kRows x HD) tile of T in shared memory, rows of HD / (16 / sizeof(T))
// 16-byte chunks, the chunk index XOR-swizzled by the row so that the eight
// rows one `ldmatrix` phase reads fall on eight different bank groups.
template <typename T, int HD>
struct Tile {
  // keys per kv tile: 64; fewer where 64 would not fit shared memory (f32:
  // beside the low halves and Q's two halves; bf16 at hd 256: beside Q, two
  // blocks an SM)
  static constexpr int kRows =
      sizeof(T) == 4 ? (HD == 256 ? 16 : HD == 128 ? 32 : 64)
                     : (HD == 256 ? 32 : 64);
  static constexpr int kElems = 16 / sizeof(T);      // elements per chunk
  static constexpr int kChunks = HD / kElems;        // chunks per row
  static constexpr int kSize = kRows * HD;           // elements per tile

  __device__ static __forceinline__ int chunk(int row, int c) {
    if constexpr (kChunks >= 8) {
      return c ^ (row & 7);
    } else {                       // 8 / kChunks rows share a 128-byte line
      return c ^ ((row / (8 / kChunks)) & (kChunks - 1));
    }
  }
  __device__ static __forceinline__ int at(int row, int col) {
    return row * HD + chunk(row, col / kElems) * kElems + col % kElems;
  }
};

// The block's shape by input type and head dim.  bf16: 4 warps (a 64-row q
// tile), Q kept in registers up to hd 128.  f32: 8 warps (128 rows), which
// halves the K/V tile loads and splits per product, with Q's halves read
// from shared memory at each tile, which leaves the registers to the 3xTF32
// operands; at hd 256 the 8 warps split the output columns in two (kSplit)
// over 64 rows, as Q's two halves of 128 rows would take 256 KB.  On the
// H100 each type ran faster in its own shape than in the other's (hd
// 16-128).
template <typename T, int HD>
struct Shape {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int kWarps = kBf16 ? 4 : 8;
  static constexpr int kThreads = 32 * kWarps;
  // warps that share 16 rows, each keeping HD / kSplit output columns
  static constexpr int kSplit = !kBf16 && HD == 256 ? 2 : 1;
  static constexpr int kBQ = 16 * kWarps / kSplit;   // q rows per block
  static constexpr bool kQRegs = kBf16 && HD <= 128;
  // n8 tiles of the output that one pass of f32's P.V sums from zero, and
  // the unrolling of Q.K^T's depth loop (whole: HD / 8 >= its steps); the
  // split instance's values ran fastest of those tried on the H100, all
  // without spills
  static constexpr int kPV = kSplit > 1 ? 4 : HD / 8;
  static constexpr int kUnrollQK = kSplit > 1 ? 8 : HD / 8;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a.b on one m16n8k16 bf16 tile, in f32
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a.b on one m16n8k8 tf32 tile, in f32
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to ~22 bits, each a tf32 value
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// Split n floats (a multiple of 4 * threads): hi = tf32(x) in place, lo =
// tf32(x - hi) at the same offset in `lo`, so both keep the tile's layout.
template <int kThreads>
__device__ __forceinline__ void split_tile(float* x, float* lo, int n) {
  float4* hi4 = reinterpret_cast<float4*>(x);
  float4* lo4 = reinterpret_cast<float4*>(lo);
  for (int i = threadIdx.x; i < n / 4; i += kThreads) {
    float4 h = hi4[i], l;
    uint32_t hb, lb;
    split_tf32(h.x, hb, lb);
    h.x = __uint_as_float(hb);
    l.x = __uint_as_float(lb);
    split_tf32(h.y, hb, lb);
    h.y = __uint_as_float(hb);
    l.y = __uint_as_float(lb);
    split_tf32(h.z, hb, lb);
    h.z = __uint_as_float(hb);
    l.z = __uint_as_float(lb);
    split_tf32(h.w, hb, lb);
    h.w = __uint_as_float(hb);
    l.w = __uint_as_float(lb);
    hi4[i] = h;
    lo4[i] = l;
  }
}

// c += a.b in 3xTF32: the small terms first, then hi.hi
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* ah,
                                           const uint32_t* al, uint32_t bh0,
                                           uint32_t bh1, uint32_t bl0,
                                           uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// 2^x on the SFU (relative error below 2^-22; results below 2^-126 flush
// to 0, which the softmax's sums cannot see)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ void store_pair(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// Rows r0 .. r0 + ROWS - 1 of a (rows, heads, hd) slice into a swizzled tile
// with 16-byte cp.async copies; rows at or past `n` are zero-filled.
template <typename T, int HD, int ROWS = Tile<T, HD>::kRows>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long row_stride, int r0,
                                          int n) {
  using L = Tile<T, HD>;
  constexpr int kThreads = Shape<T, HD>::kThreads;
  static_assert(ROWS * L::kChunks % kThreads == 0, "whole copies a thread");
#pragma unroll
  for (int it = 0; it < ROWS * L::kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / L::kChunks;
    const int c = i % L::kChunks;
    const bool in = r0 + r < n;
    const T* g = src + (in ? r0 + r : 0) * row_stride + c * L::kElems;
    cp_async16(dst + r * HD + L::chunk(r, c) * L::kElems, g, in ? 16 : 0);
  }
}

// K0 V0 K1 V1; f32 then the low halves of the current K and V, Q's high
// and Q's low halves; bf16 at hd 256 then Q (up to hd 128 bf16 stages Q in
// K1 and V1 before the loop)
template <typename T, int HD>
constexpr int smem_bytes() {
  using S = Shape<T, HD>;
  constexpr int lo = S::kBf16 ? 0 : 2 * Tile<T, HD>::kSize;
  constexpr int qs = S::kQRegs ? 0 : (S::kBf16 ? 1 : 2) * S::kBQ * HD;
  return (4 * Tile<T, HD>::kSize + lo + qs) * static_cast<int>(sizeof(T));
}

template <typename T, int HD>
__global__ void __launch_bounds__(Shape<T, HD>::kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Sq, int Skv,
             int H, int KV, int causal, int window) {
  using L = Tile<T, HD>;
  using Sh = Shape<T, HD>;
  constexpr bool kBf16 = Sh::kBf16;
  constexpr bool kQRegs = Sh::kQRegs;
  constexpr int kBQ = Sh::kBQ;
  constexpr int kPV = Sh::kPV;
  constexpr int KS = kBf16 ? 16 : 8;    // depth of one mma
  constexpr int NQK = HD / KS;          // mma depth steps of Q.K^T
  constexpr int HDW = HD / Sh::kSplit;  // output columns a warp keeps
  constexpr int ND = HDW / 8;           // n8 tiles of the warp's output
  static_assert(kPV == ND || kPV % 4 == 0, "passes of whole groups");
  static_assert(!kBf16 || Sh::kSplit == 1, "bf16 keeps whole rows");
  constexpr int kBK = L::kRows;         // keys per kv tile
  constexpr int kNT = kBK / 8;          // n8 tiles of scores per warp
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x / 32;
  const int rg = warp % (Sh::kWarps / Sh::kSplit);   // the warp's 16 rows
  const int c0 = warp / (Sh::kWarps / Sh::kSplit) * HDW;  // its columns
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;               // accumulator row (and row + 8)
  const int t = lane % 4;               // accumulator columns 2t, 2t + 1
  const int w0 = q0 + 16 * rg;          // the warp's first query row
  const float scale = kLog2e / sqrtf(static_cast<float>(HD));

  const long long q_stride = static_cast<long long>(H) * HD;
  const long long kv_stride = static_cast<long long>(KV) * HD;
  const T* qb = q + (static_cast<long long>(b) * Sq * H + h) * HD;
  const T* kb = k + (static_cast<long long>(b) * Skv * KV + kvh) * HD;
  const T* vb = v + (static_cast<long long>(b) * Skv * KV + kvh) * HD;

  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int k_end = causal ? min(Skv, q_last + 1) : Skv;
  const int k_first = window > 0 ? max(q0 - window + 1, 0) : 0;
  const int kt0 = (k_first / kBK) * kBK;
  const int n_tiles = k_end > kt0 ? (k_end - kt0 + kBK - 1) / kBK : 0;

  T* lo = smem + 4 * L::kSize;          // f32: the tile's low K, V halves
  T* qs = smem + (kQRegs ? 2 : kBf16 ? 4 : 6) * L::kSize;
  static_assert(!kQRegs || kBQ <= 2 * kBK, "Q is staged in K1 and V1");
  load_tile<T, HD, kBQ>(qs, qb, q_stride, q0, Sq);
  if (n_tiles > 0) {
    load_tile<T, HD>(smem, kb, kv_stride, kt0, Skv);
    load_tile<T, HD>(smem + L::kSize, vb, kv_stride, kt0, Skv);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  T* ql_s = qs + kBQ * HD;              // f32: Q's low halves
  if constexpr (!kBf16) {
    split_tile<Sh::kThreads>(qs, ql_s, kBQ * HD);
    __syncthreads();
  }
  uint32_t qf[kQRegs ? NQK : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int kk = 0; kk < NQK; ++kk)
      ldsm_x4(qf[kk], qs + L::at(16 * rg + (lane & 15),
                                 kk * KS + (lane >> 4) * L::kElems));
    __syncthreads();                    // K1 is overwritten below
  }

  float o[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};      // rows g and g + 8, log2 domain
  float l[2] = {0.f, 0.f};              // this thread's part of the row sum
  const bool active = w0 < Sq;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = kt0 + j * kBK;
    if (j + 1 < n_tiles) {
      T* nxt = smem + ((j + 1) & 1) * 2 * L::kSize;
      load_tile<T, HD>(nxt, kb, kv_stride, k0 + kBK, Skv);
      load_tile<T, HD>(nxt + L::kSize, vb, kv_stride, k0 + kBK, Skv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    T* ks = smem + (j & 1) * 2 * L::kSize;
    const T* vs = ks + L::kSize;
    if constexpr (!kBf16) {
      // split K and V once for all warps (the two are adjacent)
      split_tile<Sh::kThreads>(ks, lo, 2 * L::kSize);
      __syncthreads();
    }
    const T* kl_s = lo;
    const T* vl_s = lo + L::kSize;

    // a warp whose rows all lie before the tile's first key skips it: each
    // row has met its own key already, so the tile would add exactly 0
    if (active && !(causal && k0 > w0 + 15)) {
      // S = Q.K^T for the warp's 16 rows and the tile's keys
      float s[kNT][4];
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll(Sh::kUnrollQK)
      for (int kk = 0; kk < NQK; ++kk) {
        uint32_t qh[4], ql[4];
        const uint32_t* qa = qh;          // the A fragment of bf16's mma
        if constexpr (kQRegs) {
          qa = qf[kk];
        } else {
          const int at = L::at(16 * rg + (lane & 15),
                               kk * KS + (lane >> 4) * L::kElems);
          ldsm_x4(qh, qs + at);
          if constexpr (!kBf16) ldsm_x4(ql, ql_s + at);
        }
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          // n8 tiles 2np and 2np + 1: b0, b1 of each
          uint32_t kf[4];
          const int at = L::at(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                               kk * KS + ((lane >> 3) & 1) * L::kElems);
          ldsm_x4(kf, ks + at);
          if constexpr (kBf16) {
            mma_bf16(s[2 * np], qa, kf[0], kf[1]);
            mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
          } else {
            uint32_t kl[4];
            ldsm_x4(kl, kl_s + at);
            mma_3xtf32(s[2 * np], qh, ql, kf[0], kf[1], kl[0], kl[1]);
            mma_3xtf32(s[2 * np + 1], qh, ql, kf[2], kf[3], kl[2], kl[3]);
          }
        }
      }

      // scale, mask where the tile needs it, online softmax
      const bool whole = k0 + kBK <= Skv &&
                         (!causal || k0 + kBK - 1 <= w0) &&
                         (window <= 0 || k0 > w0 + 15 - window);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale;
          if (!whole) {
            const int row = w0 + g + (e >> 1) * 8;
            const int key = k0 + 8 * n + 2 * t + (e & 1);
            const bool keep = key < Skv && (!causal || key <= row) &&
                              (window <= 0 || key > row - window);
            x = keep ? x : kNegInf;
          }
          s[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // the 4 lanes of a row are lanes 4g .. 4g + 3
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = ex2(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(s[n][e] - m[e >> 1]);
          s[n][e] = p;
          l[e >> 1] += p;
        }

      // O = O * corr + P.V
      if constexpr (kBf16) {
#pragma unroll
        for (int d = 0; d < ND; ++d)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[d][e] *= corr[e >> 1];
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const uint32_t pa[4] = {
              pack_bf16(s[2 * kk][0], s[2 * kk][1]),
              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
          for (int dp = 0; dp < ND / 2; ++dp) {
            uint32_t vf[4];
            ldsm_x4_trans(vf, vs + L::at(kk * 16 + (lane & 7) +
                                             ((lane >> 3) & 1) * 8,
                                         dp * 16 + (lane >> 4) * 8));
            mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
            mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
          }
        }
      } else {
        // the tile's P.V is summed from zero and added to O in f32, so the
        // tensor cores' rounding runs over one tile's 24 products, not the
        // whole row's; kPV n8 tiles of the output a pass
#pragma unroll
        for (int d0 = 0; d0 < ND; d0 += kPV) {
          float pv[kPV][4];
#pragma unroll
          for (int d = 0; d < kPV; ++d)
#pragma unroll
            for (int e = 0; e < 4; ++e) pv[d][e] = 0.f;
#pragma unroll
          for (int n = 0; n < kNT; ++n) {
            // slot t <- key 2t, slot t + 4 <- key 2t + 1 of n8 tile n
            uint32_t ph[4], pl[4];
            split_tf32(s[n][0], ph[0], pl[0]);
            split_tf32(s[n][2], ph[1], pl[1]);
            split_tf32(s[n][1], ph[2], pl[2]);
            split_tf32(s[n][3], ph[3], pl[3]);
            const int key = 8 * n + 2 * t;
#pragma unroll
            for (int d = 0; d < kPV; ++d) {
              // the swizzle permutes chunks within aligned groups of 8 (32
              // floats), so pass d0's columns lie 8 * d0 past pass 0's,
              // and the warp's c0 past column 0: constant offsets
              const int a0 = L::at(key, 8 * d + g) + 8 * d0 + c0;
              const int a1 = L::at(key + 1, 8 * d + g) + 8 * d0 + c0;
              const uint32_t vh0 = __float_as_uint(vs[a0]);
              const uint32_t vl0 = __float_as_uint(vl_s[a0]);
              const uint32_t vh1 = __float_as_uint(vs[a1]);
              const uint32_t vl1 = __float_as_uint(vl_s[a1]);
              mma_3xtf32(pv[d], ph, pl, vh0, vh1, vl0, vl1);
            }
          }
#pragma unroll
          for (int d = 0; d < kPV; ++d)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              o[d0 + d][e] = fmaf(o[d0 + d][e], corr[e >> 1], pv[d][e]);
        }
      }
    }
    __syncthreads();                    // before tile j + 2 overwrites it
  }

  T* ob = out + (static_cast<long long>(b) * Sq * H + h) * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
    const int row = w0 + g + 8 * r;
    if (row < Sq) {
#pragma unroll
      for (int d = 0; d < ND; ++d)
        store_pair(ob + row * q_stride + c0 + 8 * d + 2 * t, o[d][2 * r] * inv,
                   o[d][2 * r + 1] * inv);
    }
  }
}

template <typename T, int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* out,
                      int B, int Sq, int Skv, int H, int KV, int causal,
                      int window, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<T, HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  constexpr int kBQ = Shape<T, HD>::kBQ;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_kernel<T, HD><<<grid, Shape<T, HD>::kThreads, bytes, stream>>>(
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
    case 256:
      return launch_hd<T, 256>(q, k, v, out, B, Sq, Skv, H, KV, causal,
                               window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Sq, H, hd), k and v (B, Skv, KV, hd) and out (B, Sq, H, hd), all
// float32 (bf16 = 0) or all bfloat16, contiguous and 16-byte aligned;
// B and H at most 65535 (grid limits).  Returns the launch's CUDA error code.
extern "C" int dynims_flash_attention(int bf16, const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int Skv, int H, int KV, int hd,
                                      int causal, int window, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KV <= 0 || H % KV != 0 || H > 65535 ||
      B > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_typed<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H, KV, hd,
                                       causal, window, st);
  return launch_typed<float>(q, k, v, out, B, Sq, Skv, H, KV, hd, causal,
                             window, st);
}
