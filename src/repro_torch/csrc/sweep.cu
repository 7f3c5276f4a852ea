// The fused DynIMS sweep step for Hopper (sm_90a).
//
// Replaces the TPU kernel `_sweep_kernel` in repro/lab/pallas_sweep.py
// (step math `_fused_step`).  One thread runs one (gain lane, node)
// closed loop over the segment [t0, t0 + T): paper Eq. 1 with the
// optional feedforward / asymmetric gain / deadband, the CacheLoop
// carry, the Kahan / count / max accumulators, and the lane's p99
// histogram: every update's uint16 utilization code is counted as
// `code >> 4` into 4096 bins.  The plain PyTorch version is
// `sweep_segment_plain` in repro_torch/kernels/sweep.py; the two must
// agree bit for bit without the cache (state and histogram) and to
// 1e-6 relative with it.
//
// Layout (all row-major, contiguous):
//   demand  (T, N)     float32, or bfloat16 when BF16
//   lp      (10, L)    lane params: r0 lam lam_grant u_min u_max deadband
//                      feedforward inv_r0 thr_over thr_settle
//   np_rows (4, N)     node rows: M inv_M W inv_W
//   alive   (1, L)     lane is live iff alive > 0.5
//   state   (S, L, N)  planes in repro_torch.kernels.sweep.state_names
//   hist    (L, 4096)  int32 counts, added to in place (the wrapper
//                      hands in a copy of the caller's histogram)
//
// Bound: the kernel moves little -- the demand rows (shared by every
// lane, so read from L2 after the first lane), the state once in and
// once out, and 16 KB of histogram per lane -- so it is bound by
// operations: 33 per update without the cache, 86 with it (two of
// those float64 transcendentals, ~85 float64 operations in SASS), and
// in practice by instruction issue.  Design:
//   * state lives in registers for the whole segment, blocks run along
//     the node axis (coalesced loads and stores), and the TPU grid's
//     sequential time axis becomes the loop in the thread.  Without the
//     cache a thread runs two nodes' loops, whose chains interleave;
//     with it, one (registers);
//   * the histogram lives in shared memory, one private 4096-bin copy
//     per block (one block = one lane): zeroed at entry, one shared
//     atomic per update, and its non-zero bins added to the lane's
//     global row with atomicAdd at exit.  Integer adds commute, so two
//     calls give the same bits.  Eq. 1 drives every node towards r0, so
//     the 32 nodes of a warp often share a bin; the hardware's shared
//     atomic (ATOMS.POPC.INC) adds equal addresses of a warp at once,
//     which grouping them in software (__match_any_sync) only slowed;
//   * demand is loaded kAhead intervals before its use into a ring of
//     registers, so no step waits on an L2 round trip; the unrolled
//     main loop needs no guard, the last rows go one by one.
//
// Where bit parity could break, and what keeps it:
//   * multiply-add contraction: built with -fmad=false, so every product
//     and sum rounds where the plain version's separate torch ops round;
//     the five multiply-adds the reference's XLA build contracts are
//     hardware FMAs here (fma_once) and exact FMAs in the plain version;
//   * division: true IEEE division (no fast math), as torch divides by a
//     device tensor;
//   * the hit-curve power exp2(e * log2(f)): float32 exp2f/log2f differ
//     from torch's in the last bit, so both sides evaluate it in float64
//     and round once to float32; the cache path is held at 1e-6 for the
//     rare float64 disagreement that crosses a float32 rounding;
//   * the code: fminf/fmaxf clamp, then a truncating cast, as
//     `astype(uint16)` truncates, then `>> 4`;
//   * bf16 demand: rounded to nearest even by torch before the launch,
//     widened exactly here by __bfloat162float;
//   * the v_prev seed and the warm resident seed are computed by the
//     caller's `_init_state`, shared with the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

struct SweepConsts {
  float occupancy;
  float interval_s;
  float conc;
  float one_minus_conc;
  float hit_exp;
  float miss_pen;
  float evict_pen;
  float access_g;
  float refill_b;
  float access_b;
  float cold_mix;
  float warm_frac;
  int pow_mode;  // 0: exp2(e * log2(max(f, 1e-30))), 1: f, 2: 1
};

namespace {

enum LaneRow { R0 = 0, LAM, LAM_GRANT, U_MIN, U_MAX, DB, FF, INV_R0,
               THR_OVER, THR_SETTLE };
enum NodeRow { ROW_M = 0, ROW_INV_M, ROW_W, ROW_INV_W };

constexpr float kInvGiB = 9.313225746154785e-10f;  // float32(2**-30)
constexpr float kGiB = 1073741824.0f;
constexpr int kThreads = 128;  // threads per block
constexpr int kBins = 4096;    // histogram bins: code >> 4
constexpr int kAhead = 4;      // demand rows in flight per loop

// Loops per thread: two independent chains interleave without the
// cache; with it, registers allow one.
__host__ __device__ constexpr int nodes_per_thread(bool has_cache) {
  return has_cache ? 1 : 2;
}

// a * b + c rounded once: the multiply-adds the reference's XLA build
// contracts.  core.control.fma computes the same exactly-rounded value.
__device__ __forceinline__ float fma_once(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

__device__ __forceinline__ void kahan(float& total, float& comp, float x) {
  const float y = x - comp;
  const float t = total + y;
  comp = (t - total) - y;
  total = t;
}

// Fig.-2 pressure multiplier; every branch is the value torch.where
// selects in hpl_slowdown_curve.
__device__ __forceinline__ float hpl_slowdown(float r) {
  const float u = fminf(fmaxf(r, 0.0f), 1.5f);
  if (u <= 0.92f) return 1.0f;
  if (u <= 0.98f) return 1.0f + (u - 0.92f) / 0.06f * 0.35f;
  if (u <= 1.0f) return 1.35f + (u - 0.98f) / 0.02f * 2.65f;
  return 4.0f + (u - 1.0f) * 300.0f;
}

// demand[i]; the wrapper keeps (t0 + T) * N below 2^31, so i is an int.
template <bool BF16>
__device__ __forceinline__ float load_demand(const void* demand, int i) {
  if (BF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(demand)[i]);
  }
  return static_cast<const float*>(demand)[i];
}

// One gain lane's parameters (the lp column).
struct Lane {
  float r0, lam, lam_grant, u_min, u_max, db, ff, inv_r0, thr_over,
      thr_settle;
};

// One (lane, node) loop: its carried state, in registers for the whole
// segment, and its node's constants.
struct Loop {
  float u, v_prev, resident;
  float us, us_c, cs, cs_c, c2, mx, n_r0, n_viol, last_bad;
  float hs, hs_c, es, es_c, ts, ts_c;
  float inv_m, w, inv_w, wf0;
};

// Plane indices of the (S, L, N) state, in state_names order.
template <bool PAPER_LAW, bool HAS_CACHE>
struct Planes {
  static constexpr int kVPrev = 1;
  static constexpr int kRes = PAPER_LAW ? 1 : 2;
  static constexpr int kAcc = 1 + (PAPER_LAW ? 0 : 1) + (HAS_CACHE ? 1 : 0);
  static constexpr int kCacheAcc = kAcc + 9;
  static constexpr int kS = kCacheAcc + (HAS_CACHE ? 6 : 0);
};

template <bool PAPER_LAW, bool HAS_CACHE>
__device__ __forceinline__ void load_loop(Loop& s, const float* state,
                                          size_t LN, size_t ln) {
  using P = Planes<PAPER_LAW, HAS_CACHE>;
  const float* acc = state + P::kAcc * LN + ln;
  s.u = state[ln];
  s.v_prev = PAPER_LAW ? 0.0f : state[P::kVPrev * LN + ln];
  s.resident = HAS_CACHE ? state[P::kRes * LN + ln] : 0.0f;
  s.us = acc[0];
  s.us_c = acc[LN];
  s.cs = acc[2 * LN];
  s.cs_c = acc[3 * LN];
  s.c2 = acc[4 * LN];
  s.mx = acc[5 * LN];
  s.n_r0 = acc[6 * LN];
  s.n_viol = acc[7 * LN];
  s.last_bad = acc[8 * LN];
  s.hs = s.hs_c = s.es = s.es_c = s.ts = s.ts_c = 0.0f;
  if (HAS_CACHE) {
    const float* cache = state + P::kCacheAcc * LN + ln;
    s.hs = cache[0];
    s.hs_c = cache[LN];
    s.es = cache[2 * LN];
    s.es_c = cache[3 * LN];
    s.ts = cache[4 * LN];
    s.ts_c = cache[5 * LN];
  }
}

template <bool PAPER_LAW, bool HAS_CACHE>
__device__ __forceinline__ void store_loop(const Loop& s, float* state,
                                           size_t LN, size_t ln) {
  using P = Planes<PAPER_LAW, HAS_CACHE>;
  float* acc = state + P::kAcc * LN + ln;
  state[ln] = s.u;
  if (!PAPER_LAW) state[P::kVPrev * LN + ln] = s.v_prev;
  if (HAS_CACHE) state[P::kRes * LN + ln] = s.resident;
  acc[0] = s.us;
  acc[LN] = s.us_c;
  acc[2 * LN] = s.cs;
  acc[3 * LN] = s.cs_c;
  acc[4 * LN] = s.c2;
  acc[5 * LN] = s.mx;
  acc[6 * LN] = s.n_r0;
  acc[7 * LN] = s.n_viol;
  acc[8 * LN] = s.last_bad;
  if (HAS_CACHE) {
    float* cache = state + P::kCacheAcc * LN + ln;
    cache[0] = s.hs;
    cache[LN] = s.hs_c;
    cache[2 * LN] = s.es;
    cache[3 * LN] = s.es_c;
    cache[4 * LN] = s.ts;
    cache[5 * LN] = s.ts_c;
  }
}

// One interval of one loop; returns the interval's histogram bin.
template <bool PAPER_LAW, bool UNIT_OCC, bool HAS_CACHE>
__device__ __forceinline__ int step(Loop& s, const Lane& p,
                                    const SweepConsts& c, float d, float tf) {
  float v;
  if (HAS_CACHE) {
    v = d + s.resident;
  } else if (UNIT_OCC) {
    v = d + s.u;
  } else {
    v = fma_once(c.occupancy, s.u, d);
  }
  const float v_eff = PAPER_LAW ? v : fma_once(p.ff, v - s.v_prev, v);

  // Eq. 1 (vectorized_step with the reciprocal multiplies).
  const float err = fma_once(v_eff, s.inv_m, -p.r0);
  const float lam_eff = PAPER_LAW ? p.lam : (err < 0.0f ? p.lam_grant : p.lam);
  float u_next = fma_once(-(lam_eff * v_eff), err * p.inv_r0, s.u);
  if (!PAPER_LAW && fabsf(err) <= p.db) u_next = s.u;
  u_next = fminf(fmaxf(u_next, p.u_min), p.u_max);

  const float r = v * s.inv_m;
  kahan(s.us, s.us_c, r);
  const float cap_gib = u_next * kInvGiB;
  kahan(s.cs, s.cs_c, cap_gib);
  s.c2 = fma_once(cap_gib, cap_gib, s.c2);
  s.mx = fmaxf(s.mx, r);
  s.n_r0 = s.n_r0 + (r > p.thr_over ? 1.0f : 0.0f);
  s.n_viol = s.n_viol + (r > 1.0f ? 1.0f : 0.0f);
  s.last_bad = r > p.thr_settle ? tf : s.last_bad;
  if (!PAPER_LAW) s.v_prev = v;

  if (HAS_CACHE) {
    const float res_ev = fminf(s.resident, u_next);
    const float ev_g = (s.resident - res_ev) * kInvGiB;
    const float f = fminf(res_ev * s.inv_w, 1.0f);
    float pw;
    if (c.pow_mode == 1) {
      pw = f;
    } else if (c.pow_mode == 2) {
      pw = 1.0f;
    } else {
      // float64, rounded once: see _fast_pow in kernels/sweep.py.
      pw = static_cast<float>(exp2(static_cast<double>(c.hit_exp) *
                                   log2(static_cast<double>(fmaxf(f, 1e-30f)))));
    }
    float hit = c.conc * pw + c.one_minus_conc * f;
    const float scanned = tf * c.access_b;
    const float wf = fminf(s.wf0, f);
    hit = scanned < s.w ? wf + c.cold_mix * (hit - wf) : hit;
    const float miss_g = (1.0f - hit) * c.access_g;
    const float target = fminf(u_next, s.w);
    s.resident = fminf(target, res_ev + fminf(miss_g * kGiB, c.refill_b));
    const float dt_app = c.interval_s * hpl_slowdown(r) +
                         miss_g * c.miss_pen + ev_g * c.evict_pen;
    kahan(s.hs, s.hs_c, hit * c.access_g);
    kahan(s.es, s.es_c, ev_g);
    kahan(s.ts, s.ts_c, dt_app);
  }
  s.u = u_next;
  // The bin code >> 4 of code = trunc(clamp(r * 32768, 0, 65535)):
  // scaling by 2^-4 is exact and trunc(trunc(x) / 16) = trunc(x / 16)
  // for x >= 0, so it is trunc(clamp(r * 2048, 0, 4095)).
  return static_cast<int>(fminf(fmaxf(r * 2048.0f, 0.0f), 4095.0f));
}

// One update into the block's histogram; a loop past the last node
// counts into the spare bin kBins, which is never flushed.
__device__ __forceinline__ void count(int* bins, int bin, bool counted) {
  atomicAdd(&bins[counted ? bin : kBins], 1);
}

template <bool PAPER_LAW, bool UNIT_OCC, bool HAS_CACHE, bool BF16>
__global__ void __launch_bounds__(kThreads) sweep_kernel(
    const void* __restrict__ demand, const float* __restrict__ lp,
    const float* __restrict__ np_rows, const float* __restrict__ alive,
    const float* __restrict__ state_in, float* __restrict__ state_out,
    int* __restrict__ hist, int T, int L, int N, int t0, SweepConsts c) {
  constexpr int J = nodes_per_thread(HAS_CACHE);
  __shared__ int bins[kBins + 1];
  const int l = blockIdx.y;
  const size_t LN = static_cast<size_t>(L) * N;
  // Loop j of a thread runs node blockIdx.x * J * kThreads + j * kThreads
  // + threadIdx.x, so each of its loads and stores is coalesced.  Loops
  // past the last node run node N - 1 (every warp stays whole for the
  // histogram), count into the spare bin and store nothing.
  int n[J];
  bool active[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int node = (blockIdx.x * J + j) * kThreads + threadIdx.x;
    active[j] = node < N;
    n[j] = active[j] ? node : N - 1;
  }

  if (!(alive[l] > 0.5f)) {  // the whole block: its lane is dead
    constexpr int kS = Planes<PAPER_LAW, HAS_CACHE>::kS;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const size_t ln = static_cast<size_t>(l) * N + n[j];
      if (!active[j]) continue;
      for (int s = 0; s < kS; ++s) state_out[s * LN + ln] = state_in[s * LN + ln];
    }
    return;
  }
  for (int b = threadIdx.x; b <= kBins; b += kThreads) bins[b] = 0;

  Lane p;
  p.r0 = lp[R0 * L + l];
  p.lam = lp[LAM * L + l];
  p.lam_grant = lp[LAM_GRANT * L + l];
  p.u_min = lp[U_MIN * L + l];
  p.u_max = lp[U_MAX * L + l];
  p.db = lp[DB * L + l];
  p.ff = lp[FF * L + l];
  p.inv_r0 = lp[INV_R0 * L + l];
  p.thr_over = lp[THR_OVER * L + l];
  p.thr_settle = lp[THR_SETTLE * L + l];
  Loop loop[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    Loop& s = loop[j];
    load_loop<PAPER_LAW, HAS_CACHE>(s, state_in, LN,
                                    static_cast<size_t>(l) * N + n[j]);
    s.inv_m = np_rows[ROW_INV_M * N + n[j]];
    s.w = np_rows[ROW_W * N + n[j]];
    s.inv_w = np_rows[ROW_INV_W * N + n[j]];
    s.wf0 = HAS_CACHE ? (c.warm_frac * fminf(p.u_max, s.w)) * s.inv_w : 0.0f;
  }
  __syncthreads();  // the bins are zero

  // Rows k + kAhead load while row k is used: a ring of registers, so no
  // step waits on the (L2) round trip.  The unrolled main loop runs while
  // every row it loads exists, with no guard or clamp; the rest of the
  // rows go one by one.
  float ring[kAhead][J];
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      ring[i][j] = load_demand<BF16>(demand, min(i, T - 1) * N + n[j]);
    }
  }
  int k0 = 0;
  int row = kAhead * N;  // offset of row k0 + kAhead
  for (; k0 + 2 * kAhead <= T; k0 += kAhead) {
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const float tf = static_cast<float>(t0 + k0 + i);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const float d = ring[i][j];
        ring[i][j] = load_demand<BF16>(demand, row + n[j]);
        count(bins, step<PAPER_LAW, UNIT_OCC, HAS_CACHE>(loop[j], p, c, d, tf),
              active[j]);
      }
      row += N;
    }
  }
#pragma unroll 1
  for (int k = k0; k < T; ++k) {
    const float tf = static_cast<float>(t0 + k);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float d = load_demand<BF16>(demand, k * N + n[j]);
      count(bins, step<PAPER_LAW, UNIT_OCC, HAS_CACHE>(loop[j], p, c, d, tf),
            active[j]);
    }
  }
  __syncthreads();  // every update is counted
  int* out = hist + static_cast<size_t>(l) * kBins;
  for (int b = threadIdx.x; b < kBins; b += kThreads) {
    const int counted = bins[b];
    if (counted) atomicAdd(&out[b], counted);
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (active[j]) {
      store_loop<PAPER_LAW, HAS_CACHE>(loop[j], state_out, LN,
                                       static_cast<size_t>(l) * N + n[j]);
    }
  }
}

using SweepFn = void (*)(const void*, const float*, const float*,
                         const float*, const float*, float*, int*, int, int,
                         int, int, SweepConsts);

template <bool PAPER_LAW, bool UNIT_OCC, bool HAS_CACHE>
SweepFn pick_instance(bool bf16) {
  return bf16 ? sweep_kernel<PAPER_LAW, UNIT_OCC, HAS_CACHE, true>
              : sweep_kernel<PAPER_LAW, UNIT_OCC, HAS_CACHE, false>;
}

// The template instance for one specialization.  A cache segment always
// runs with unit occupancy (the resident set replaces the occupancy
// model).
SweepFn pick(int paper_law, int unit_occupancy, int has_cache, int bf16) {
  const bool b = bf16 != 0;
  if (has_cache) {
    return paper_law ? pick_instance<true, true, true>(b)
                     : pick_instance<false, true, true>(b);
  }
  if (paper_law) {
    return unit_occupancy ? pick_instance<true, true, false>(b)
                          : pick_instance<true, false, false>(b);
  }
  return unit_occupancy ? pick_instance<false, true, false>(b)
                        : pick_instance<false, false, false>(b);
}

}  // namespace

// Launches one segment on `stream`; returns cudaGetLastError() after
// the launch (0 on success).  `hist` must already hold the counts to
// add to.
extern "C" int dynims_sweep_segment(int paper_law, int unit_occupancy,
                                    int has_cache, int bf16,
                                    const void* demand, const float* lp,
                                    const float* np_rows, const float* alive,
                                    const float* state_in, float* state_out,
                                    int* hist, int T, int L, int N, int t0,
                                    const SweepConsts* consts, void* stream) {
  if (T <= 0 || L <= 0 || N <= 0) return 0;
  const int block_nodes = kThreads * nodes_per_thread(has_cache != 0);
  const dim3 grid((N + block_nodes - 1) / block_nodes, L);
  pick(paper_law, unit_occupancy, has_cache, bf16)
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          demand, lp, np_rows, alive, state_in, state_out, hist, T, L, N, t0,
          *consts);
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread, static shared memory per block and resident
// blocks per SM of one template instance, into out[0..2]; returns the
// CUDA error (0 on success).
extern "C" int dynims_sweep_resources(int paper_law, int unit_occupancy,
                                      int has_cache, int bf16, int* out) {
  const SweepFn fn = pick(paper_law, unit_occupancy, has_cache, bf16);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], fn, kThreads, 0);
  return static_cast<int>(err);
}
