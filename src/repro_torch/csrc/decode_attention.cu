// Decode attention: one query token per (sequence, head) against a KV cache.
//
// Replaces the TPU kernel `_decode_kernel` of
// src/repro/kernels/decode_attention/kernel.py (wrapper `decode_attention`).
// For every sequence b and query head h it attends keys [start_b, len_b) of
// the (B, S, KV, hd) caches, start_b = max(len_b - window, 0) when a window
// is set, else 0, with an online softmax in float32, and writes
// acc / max(l, 1e-30) in q's type; a sequence with no kept key gets zeros.
// Query head h reads kv head h / G, G = H / KV <= 16.  Keys outside
// [start_b, len_b) are never read: the NaN-poisoned-cache checks hold it to
// that.
//
// What bounds it on an H100: bytes.  Each kept key costs 2 * hd *
// sizeof(cache) bytes of K and V (256 in bf16 at hd 64) and 4 * G * hd
// operations, about G operations per byte -- far below the card's ~20 f32
// operations per byte, so the math stays on the CUDA cores in f32 and the
// design spends its effort on keeping enough bytes in flight.  At one layer of
// decode_32k (128 x 32768 x 8 x 64, bf16) the bound is 2.5645 ms.
//
//  * Split-KV (flash-decoding).  The grid is (KV, B, splits).  The wrapper
//    picks `splits` from B * KV, S and the SM count (1 when B * KV blocks
//    already fill the card, else at most one wave of resident blocks), never
//    from the lengths, which stay on the card.  Each block reads len_b
//    itself and cuts the live tiles of [start_b, len_b) into `used` <=
//    splits tile-aligned parts of at least kMinSplitTiles tiles, so a short
//    sequence pays for no merge; blocks past `used` return at once, and a
//    windowed layer splits its `window` live keys, not the cache.  A part
//    left empty writes an empty partial (m = -1e30, l = 0).
//  * One launch, fixed-order merge.  With used > 1 each block writes
//    (acc[G][hd], m[G], l[G]) in f32 to a workspace the wrapper allocates;
//    then, after __threadfence(), takes a ticket from its (b, kv head)
//    counter with atomicAdd.  The last block merges the partials in split
//    order (rescaled by exp2(m_i - max m)) and resets the counter to 0, so
//    the same inputs give the same bits on every run and no memset is
//    launched.  A second merge kernel would add a launch to a host-bound
//    serving step for no saving in bytes, so the ticket was chosen.  The
//    counters are shared by the device's launches: one stream at a time.
//    With used = 1 the block writes the output and touches neither.
//  * A cp.async ring of K/V tiles in their own type.  Tiles of 64 keys (32
//    above 8 heads per kv head; half that for a float32 cache at hd 256,
//    where a stage of 64 keys takes 128 KB) move with 16-byte cp.async.cg
//    into a ring of 2-4 stages in dynamic shared memory (up to 128 KB, at
//    hd 256), so the loads of the
//    next tiles are in flight while one is used; rows outside
//    [start_b, len_b) use the zero-fill form (src-size 0) and are not read.
//    One __syncthreads per tile, the ring's stage barrier.
//  * Scores in registers, heads balanced.  Each of the 8 warps takes 8 keys
//    of every tile (4 for a float32 cache at hd 256) and serves all G heads
//    of the group for them (above 8 heads, two sets of 4 warps split the
//    heads evenly), so G = 5 loads
//    every warp alike.  A warp computes a fixed number of head slots (4, 5
//    or 8) without branches, so its score chains interleave; guarding each
//    head with `if (g < G)` serialised them behind convergence barriers;
//    the empty slots read zeroed rows of q and write nothing.  A key's hd
//    dims lie on hd / 8 lanes (4 at hd 16, all 32 at hd 256); its score is a
//    shuffle
//    sum, and each group of lanes keeps its own online softmax (max, sum,
//    output slice) in registers, rescaled lazily: only when a tile's max
//    passes the running one by 2^8.  The groups merge by shuffles and the
//    warps through shared memory once, at the end.  Q is staged once,
//    scaled by log2(e) / sqrt(hd), so p = exp2(s - m).
//
// Left for later: TMA with mbarriers in place of cp.async, a persistent grid,
// and a paged cache read from the pool's blocks in place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKeysPerWarp = 8;          // keys of each tile one warp takes
constexpr int kMaxGroup = 16;            // query heads per kv head
constexpr int kRingBytes = 96 * 1024;    // the stages fit in this
constexpr int kMinSplitTiles = 8;        // tiles a part holds at least
constexpr float kSlack = 8.f;            // lazy rescaling, in log2 units
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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

// VE values from shared memory, as float.
template <int VE>
__device__ __forceinline__ void load_f(const float* p, float* o) {
#pragma unroll
  for (int i = 0; i < VE; i += 4) {
    const float4 t = *reinterpret_cast<const float4*>(p + i);
    o[i] = t.x;
    o[i + 1] = t.y;
    o[i + 2] = t.z;
    o[i + 3] = t.w;
  }
}

template <int VE>
__device__ __forceinline__ void load_f(const __nv_bfloat16* p, float* o) {
  static_assert(VE == 8 || VE == 4, "bf16 vectors are 16 or 8 bytes");
  using Raw = typename std::conditional<VE == 8, uint4, uint2>::type;
  const Raw raw = *reinterpret_cast<const Raw*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < VE / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// 16 bytes global -> shared; with valid false the zero-fill form reads none.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shapes of one instance: cache type, head dim, head sets, heads per warp.
template <typename TKV, int HD, int HSETS, int HPW>
struct Cfg {
  static constexpr int KSL = kWarps / HSETS;            // key slices
  // keys of each tile one warp takes: half for a float32 cache at hd 256,
  // so that two stages fit shared memory
  static constexpr int KPW =
      HD * static_cast<int>(sizeof(TKV)) > 512 ? kKeysPerWarp / 2
                                                : kKeysPerWarp;
  static constexpr int TILE = KSL * KPW;                // keys per tile
  static constexpr int DPL = HD / 4 < 8 ? HD / 4 : 8;   // dims per lane
  static constexpr int LPK = HD / DPL;                  // lanes per key
  static constexpr int KPI = 32 / LPK;                  // keys per warp pass
  static constexpr int ITER = KPW / KPI;                // passes per tile
  static constexpr int CHUNK = 16 / static_cast<int>(sizeof(TKV));
  static constexpr int VE = CHUNK < DPL ? CHUNK : DPL;  // values per read
  static constexpr int NV = DPL / VE;                   // reads per row
  static constexpr int CPR = HD / CHUNK;                // 16 B copies per row
  static constexpr int TILE_ELEMS = TILE * HD;
  static constexpr int STAGE_BYTES =
      2 * TILE_ELEMS * static_cast<int>(sizeof(TKV));
  static constexpr int FIT = kRingBytes / STAGE_BYTES;
  static constexpr int STAGES = FIT > 4 ? 4 : (FIT < 2 ? 2 : FIT);
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr int RED_BYTES = kWarps * HPW * HD * 4;
  static constexpr int SMEM = RING_BYTES > RED_BYTES ? RING_BYTES : RED_BYTES;
  static_assert(ITER >= 1 && KPI * ITER == KPW, "lane layout");
  static_assert(HSETS * HPW <= kMaxGroup, "heads per block");
};

template <typename TQ, typename TKV, int HD, int HSETS, int HPW>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 2 : 1)
decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_cache,
              const TKV* __restrict__ v_cache, const int* __restrict__ lengths,
              TQ* __restrict__ out, float* __restrict__ ws,
              int* __restrict__ counters, int H, int KV, int S, int window,
              int splits) {
  using C = Cfg<TKV, HD, HSETS, HPW>;
  constexpr int TILE = C::TILE, DPL = C::DPL, LPK = C::LPK, KPI = C::KPI;
  constexpr int ITER = C::ITER, VE = C::VE, NV = C::NV, STAGES = C::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TKV* ring = reinterpret_cast<TKV*>(smem_raw);
  __shared__ __align__(16) float q_s[kMaxGroup * HD];
  __shared__ float red_m[kWarps][HPW];
  __shared__ float red_l[kWarps][HPW];
  __shared__ int last_s;

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int kg = lane / LPK;               // key group of the lane
  const int dc = lane % LPK;               // its slice of the head dim
  const int hset = warp / C::KSL;
  const int kslice = warp % C::KSL;
  const int hb = (G + HSETS - 1) / HSETS;  // heads per set (<= HPW)
  const int g_lo = hset * hb;
  const int n_g = max(0, min(hb, G - g_lo));

  const int len = min(max(lengths[b], 0), S);
  const int start = window > 0 ? max(len - window, 0) : 0;
  // this block's tile-aligned part of the live tiles of [start, len)
  const int t_first = start / TILE;
  const int n_live = len > start ? (len + TILE - 1) / TILE - t_first : 0;
  // parts of at least kMinSplitTiles tiles: a short sequence pays no
  // merge; the blocks past `used` have nothing to do
  const int used =
      max(1, min(splits, (n_live + kMinSplitTiles - 1) / kMinSplitTiles));
  if (split >= used) return;
  const int per = (n_live + used - 1) / used;
  const int tb = t_first + split * per;
  const int n_tiles = max(min(per, n_live - split * per), 0);

  const float qscale = kLog2e / sqrtf(static_cast<float>(HD));
  const TQ* qb = q + (static_cast<long long>(b) * H + kvh * G) * HD;
  for (int i = tid; i < kMaxGroup * HD; i += kThreads)
    q_s[i] = i < G * HD ? to_f(qb[i]) * qscale : 0.f;

  const long long row_stride = static_cast<long long>(KV) * HD;
  const long long base =
      (static_cast<long long>(b) * S * KV + kvh) * static_cast<long long>(HD);
  const TKV* kb = k_cache + base;
  const TKV* vb = v_cache + base;

  constexpr int NCOPY = 2 * TILE * C::CPR;    // 16-byte copies a tile
  constexpr int RSTEP = kThreads / C::CPR;     // rows a round of copies
  const int col = (tid % C::CPR) * C::CHUNK;
  const int row0 = tid / C::CPR;
  auto prefetch = [&](int j) {             // tile tb + j into its slot
    TKV* dst = ring + (j % STAGES) * 2 * C::TILE_ELEMS;
    const int k0 = (tb + j) * TILE;
#pragma unroll
    for (int i = 0; i < (NCOPY + kThreads - 1) / kThreads; ++i) {
      const int row = row0 + i * RSTEP;    // K rows, then V rows
      if (NCOPY % kThreads == 0 || row < 2 * TILE) {
        const bool is_v = row >= TILE;
        const int key = k0 + row - (is_v ? TILE : 0);
        const bool ok = key >= start && key < len;
        const TKV* src =
            (is_v ? vb : kb) + (ok ? key * row_stride : 0) + col;
        cp_async16(dst + row * HD + col, src, ok);
      }
    }
  };

#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < n_tiles) prefetch(j);
    cp_async_commit();
  }

  float m[HPW], l[HPW], acc[HPW][DPL];
#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[i][e] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<STAGES - 2>();           // tile j has landed (this thread)
    __syncthreads();                       // ... for every thread; slot
    if (j + STAGES - 1 < n_tiles) prefetch(j + STAGES - 1);  // j - 1 is free
    cp_async_commit();
    const TKV* kt = ring + (j % STAGES) * 2 * C::TILE_ELEMS;
    const TKV* vt = kt + C::TILE_ELEMS;
    const int k0 = (tb + j) * TILE;

    float s[HPW][ITER];
    unsigned valid = 0;
#pragma unroll
    for (int it = 0; it < ITER; ++it) {
      const int r = kslice * C::KPW + it * KPI + kg;
      const int key = k0 + r;
      if (key >= start && key < len) valid |= 1u << it;
      float kf[DPL];
#pragma unroll
      for (int v = 0; v < NV; ++v)
        load_f<VE>(kt + r * HD + (dc + v * LPK) * VE, kf + v * VE);
#pragma unroll
      for (int gi = 0; gi < HPW; ++gi) {   // every slot, so the chains
        const float* qg = q_s + (g_lo + gi) * HD;   // interleave
        float d = 0.f;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          float qf[VE];
          load_f<VE>(qg + (dc + v * LPK) * VE, qf);
#pragma unroll
          for (int e = 0; e < VE; ++e) d += qf[e] * kf[v * VE + e];
        }
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, o);
        s[gi][it] = d;
      }
    }

    // Lazy rescaling: the running max moves (and acc, l are rescaled)
    // only when a lane's tile max passes it by kSlack, so p <= 2^kSlack.
    float tmax[HPW];
    bool grow = false;
#pragma unroll
    for (int gi = 0; gi < HPW; ++gi) {
      float mx = kNegInf;
#pragma unroll
      for (int it = 0; it < ITER; ++it)
        if (valid >> it & 1u) mx = fmaxf(mx, s[gi][it]);
      tmax[gi] = mx;
      grow |= mx > m[gi] + kSlack;
    }
    if (__any_sync(0xffffffffu, grow)) {
#pragma unroll
      for (int gi = 0; gi < HPW; ++gi) {
        const float mx = fmaxf(m[gi], tmax[gi]);
        const float c = exp2f(m[gi] - mx);
        m[gi] = mx;
        l[gi] *= c;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[gi][e] *= c;
      }
    }
#pragma unroll
    for (int gi = 0; gi < HPW; ++gi) {
      float sum = 0.f;
#pragma unroll
      for (int it = 0; it < ITER; ++it) {
        const float p = (valid >> it & 1u) ? exp2f(s[gi][it] - m[gi]) : 0.f;
        s[gi][it] = p;
        sum += p;
      }
      l[gi] += sum;
    }

#pragma unroll
    for (int it = 0; it < ITER; ++it) {
      const int r = kslice * C::KPW + it * KPI + kg;
      float vf[DPL];
#pragma unroll
      for (int v = 0; v < NV; ++v)
        load_f<VE>(vt + r * HD + (dc + v * LPK) * VE, vf + v * VE);
#pragma unroll
      for (int gi = 0; gi < HPW; ++gi) {
        const float p = s[gi][it];
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[gi][e] += p * vf[e];
      }
    }
  }
  cp_async_wait<0>();                      // only empty groups are left
  __syncthreads();                         // the ring becomes `red`

  // merge the warp's key groups (lanes LPK apart), then the warps
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1) {
#pragma unroll
    for (int gi = 0; gi < HPW; ++gi) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[gi], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[gi], o);
      const float mx = fmaxf(m[gi], mo);
      const float a = exp2f(m[gi] - mx);
      const float c = exp2f(mo - mx);
      l[gi] = l[gi] * a + lo * c;
      m[gi] = mx;
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        acc[gi][e] = acc[gi][e] * a +
                     __shfl_xor_sync(0xffffffffu, acc[gi][e], o) * c;
    }
  }
  float* red = reinterpret_cast<float*>(smem_raw);   // [kWarps][HPW][HD]
#pragma unroll
  for (int gi = 0; gi < HPW; ++gi) {
    if (gi < n_g) {
      if (lane < LPK) {
#pragma unroll
        for (int v = 0; v < NV; ++v)
#pragma unroll
          for (int e = 0; e < VE; ++e)
            red[(warp * HPW + gi) * HD + (dc + v * LPK) * VE + e] =
                acc[gi][v * VE + e];
      }
      if (lane == 0) {
        red_m[warp][gi] = m[gi];
        red_l[warp][gi] = l[gi];
      }
    }
  }
  __syncthreads();

  const long long pair = static_cast<long long>(b) * KV + kvh;
  TQ* ob = out + (static_cast<long long>(b) * H + kvh * G) * HD;
  const int rec = G * (HD + 2);            // one partial: acc, m, l
  float* part = used == 1 ? nullptr : ws + (pair * splits + split) * rec;
  for (int i = tid; i < G * HD; i += kThreads) {
    const int g = i / HD;
    const int d = i % HD;
    const int hs = g / hb;
    const int gi = g - hs * hb;
    float mx = kNegInf;
#pragma unroll
    for (int k = 0; k < C::KSL; ++k)
      mx = fmaxf(mx, red_m[hs * C::KSL + k][gi]);
    float sum = 0.f, o = 0.f;
#pragma unroll
    for (int k = 0; k < C::KSL; ++k) {
      const int w = hs * C::KSL + k;
      const float e = exp2f(red_m[w][gi] - mx);
      sum += red_l[w][gi] * e;
      o += red[(w * HPW + gi) * HD + d] * e;
    }
    if (used == 1) {
      ob[i] = from_f<TQ>(o / fmaxf(sum, 1e-30f));
    } else {
      part[i] = o;
      if (d == 0) {
        part[G * HD + g] = mx;
        part[G * HD + G + g] = sum;
      }
    }
  }
  if (used == 1) return;

  __threadfence();                         // the partial, before the ticket
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(counters + pair, 1) == used - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  const float* parts = ws + pair * splits * rec;
  for (int i = tid; i < G * HD; i += kThreads) {
    const int g = i / HD;
    float mx = kNegInf;
    for (int p = 0; p < used; ++p)
      mx = fmaxf(mx, __ldcg(parts + p * rec + G * HD + g));
    float sum = 0.f, o = 0.f;
    for (int p = 0; p < used; ++p) {       // split order: the same bits
      const float* pp = parts + p * rec;   // on every run
      const float e = exp2f(__ldcg(pp + G * HD + g) - mx);
      sum += __ldcg(pp + G * HD + G + g) * e;
      o += __ldcg(pp + i) * e;
    }
    ob[i] = from_f<TQ>(o / fmaxf(sum, 1e-30f));
  }
  if (tid == 0) counters[pair] = 0;        // ready for the next launch
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* out;
  float* ws;
  int* counters;
  int B, H, KV, S, hd, window, splits;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int HD, int HSETS, int HPW>
cudaError_t launch_cfg(const Args& a) {
  auto kernel = decode_kernel<TQ, TKV, HD, HSETS, HPW>;
  constexpr int smem = Cfg<TKV, HD, HSETS, HPW>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  // splits slowest: the blocks of split 0 come first and spread over
  // the SMs, so a short sequence's one working block shares no SM with
  // another's
  const dim3 grid(a.KV, a.B, a.splits);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
      static_cast<const TKV*>(a.v), a.lengths, static_cast<TQ*>(a.out), a.ws,
      a.counters, a.H, a.KV, a.S, a.window, a.splits);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int HD>
cudaError_t launch_hd(const Args& a) {
  const int g = a.H / a.KV;
  if (g <= 4) return launch_cfg<TQ, TKV, HD, 1, 4>(a);
  if (g == 5) return launch_cfg<TQ, TKV, HD, 1, 5>(a);
  if (g <= 8) return launch_cfg<TQ, TKV, HD, 1, 8>(a);
  return launch_cfg<TQ, TKV, HD, 2, 8>(a);
}

template <typename TQ, typename TKV>
cudaError_t launch_typed(const Args& a) {
  switch (a.hd) {
    case 16: return launch_hd<TQ, TKV, 16>(a);
    case 32: return launch_hd<TQ, TKV, 32>(a);
    case 64: return launch_hd<TQ, TKV, 64>(a);
    case 128: return launch_hd<TQ, TKV, 128>(a);
    case 256: return launch_hd<TQ, TKV, 256>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, hd) and out in float32 (q_bf16 = 0) or bfloat16; caches
// (B, S, KV, hd) in float32 (kv_bf16 = 0) or bfloat16; lengths (B,) int32.
// All contiguous and 16-byte aligned.  With splits > 1, `workspace` holds
// B * KV * splits * G * (hd + 2) floats and `counters` B * KV ints that are
// 0 on entry (and left 0); with splits = 1 neither is read.  Returns the
// launch's CUDA error code.
extern "C" int dynims_decode_attention(int q_bf16, int kv_bf16, const void* q,
                                       const void* k_cache,
                                       const void* v_cache,
                                       const void* lengths, void* out,
                                       void* workspace, void* counters, int B,
                                       int H, int KV, int S, int hd,
                                       int window, int splits, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || H / KV > kMaxGroup || S <= 0 ||
      B > 65535 || splits > 65535 || splits < 1 ||
      (splits > 1 && (workspace == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  const Args a{q, k_cache, v_cache, static_cast<const int*>(lengths), out,
               static_cast<float*>(workspace), static_cast<int*>(counters),
               B, H, KV, S, hd, window, splits,
               static_cast<cudaStream_t>(stream)};
  if (q_bf16 && kv_bf16) return launch_typed<__nv_bfloat16, __nv_bfloat16>(a);
  if (q_bf16) return launch_typed<__nv_bfloat16, float>(a);
  if (kv_bf16) return launch_typed<float, __nv_bfloat16>(a);
  return launch_typed<float, float>(a);
}
