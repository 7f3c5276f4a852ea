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
// and with HAS_GRAPH:
//   work    (S+1, N)   float32 GiB of each stage row on each node
//   stage   (2, S+1)   float32 rows: held demand (bytes), barrier flag
//   ws      (L, 4)     int32, zeroed: the per-lane barrier's workspace
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
//
// AppGraph (HAS_GRAPH): the queue/barrier carry of the reference's XLA
// scan (repro/lab/sweep.py, `app_graph`), which JAX runs beside the
// Pallas kernel and the port runs in it.  Five more planes: the stage
// row `sidx` (a float holding a small integer), the work left, the
// Kahan work done and `t_done`, the lane's finish interval, held in
// every node of the lane.  Per launch: the (S+1, N) work matrix, the
// (2, S+1) per-row held demand and barrier flags (row S is the
// sentinel: no work, no demand, no barrier), S and comp_itv.  Each
// interval the active row's held bytes join the demand before the law
// sees it, the queue drains comp_itv * (interval_s / dt_eff), and a
// barrier row promotes when the lane-wide min of the progress code
// 2 * sidx + fin says every node finished it.  So every interval needs
// one reduction over the lane's nodes:
//   * one block holds the lane (N <= 256, or 128 with the cache): a
//     warp reduction and one __syncthreads;
//   * several blocks hold it: each block's min meets the others' at a
//     per-lane barrier in device memory (arrival counter, generation,
//     two min slots by parity, in a workspace the wrapper zeroes).  The
//     barrier needs every block of the launch resident at once, so the
//     entry launches such a grid cooperatively, which fails rather
//     than deadlocks when the blocks do not fit, and the wrapper caps
//     the lanes a launch holds.
// The reference's second reduction, min(sidx) >= S for t_done, is read
// off the next interval's min instead: a node past the last row has
// code 2 * S and any other node less, so that min is 2 * S exactly when
// every node finished on the interval before.  One more reduction at
// the segment's end settles its last interval.  Loops past the last
// node run node N - 1 and enter the min with node N - 1's own code.
// Without the cache dt_eff is the pressure curve as XLA compiles it
// (folded slopes, one rounding per segment: hpl_slowdown_fused); with
// it, the CacheLoop's dt_app.  Bound: the carry adds ~20 operations per
// update and the lane's reductions, which serialise the intervals: a
// small fleet is bound by their latency, not by operations or bytes.

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
constexpr int kWarps = kThreads / 32;
constexpr int kBig = 1 << 30;  // lane-min slots hold kBig - min, from 0

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

// The same curve as the reference's XLA build computes it: the slopes
// folded to one float32 constant each and each segment's multiply-add
// contracted.  kernels/sweep.py::hpl_slowdown_fused is its plain form.
__device__ __forceinline__ float hpl_slowdown_fused(float r) {
  const float u = fminf(fmaxf(r, 0.0f), 1.5f);
  if (u <= 0.92f) return 1.0f;
  if (u <= 0.98f) return fma_once(u - 0.92f, 5.83333349f, 1.0f);
  if (u <= 1.0f) return fma_once(u - 0.98f, 132.5f, 1.35f);
  return fma_once(u - 1.0f, 300.0f, 4.0f);
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
  // the AppGraph carry, and the step's r and dt_app it reads
  int sidx;
  float wleft, wd, wd_c, t_done, r, dt;
};

// Plane indices of the (S, L, N) state, in state_names order.
template <bool PAPER_LAW, bool HAS_CACHE, bool HAS_GRAPH = false>
struct Planes {
  static constexpr int kVPrev = 1;
  static constexpr int kRes = PAPER_LAW ? 1 : 2;
  static constexpr int kAcc = 1 + (PAPER_LAW ? 0 : 1) + (HAS_CACHE ? 1 : 0);
  static constexpr int kCacheAcc = kAcc + 9;
  static constexpr int kGraph = kCacheAcc + (HAS_CACHE ? 6 : 0);
  static constexpr int kS = kGraph + (HAS_GRAPH ? 5 : 0);
};

template <bool PAPER_LAW, bool HAS_CACHE, bool HAS_GRAPH = false>
__device__ __forceinline__ void load_loop(Loop& s, const float* state,
                                          size_t LN, size_t ln) {
  using P = Planes<PAPER_LAW, HAS_CACHE, HAS_GRAPH>;
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
  if (HAS_GRAPH) {
    const float* graph = state + P::kGraph * LN + ln;
    s.sidx = static_cast<int>(graph[0]);
    s.wleft = graph[LN];
    s.wd = graph[2 * LN];
    s.wd_c = graph[3 * LN];
    s.t_done = graph[4 * LN];
  }
}

template <bool PAPER_LAW, bool HAS_CACHE, bool HAS_GRAPH = false>
__device__ __forceinline__ void store_loop(const Loop& s, float* state,
                                           size_t LN, size_t ln) {
  using P = Planes<PAPER_LAW, HAS_CACHE, HAS_GRAPH>;
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
  if (HAS_GRAPH) {
    float* graph = state + P::kGraph * LN + ln;
    graph[0] = static_cast<float>(s.sidx);
    graph[LN] = s.wleft;
    graph[2 * LN] = s.wd;
    graph[3 * LN] = s.wd_c;
    graph[4 * LN] = s.t_done;
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
  s.r = r;
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
    s.dt = dt_app;
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

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// The min of v over every block of the lane, by thread 0 of each: the
// lane's barrier episode e.  bar[0] counts arrivals, bar[1] the episodes
// completed, bar[2 + e % 2] holds kBig - min (zero: no value yet).  The
// last block to arrive clears the other parity's slot (every block read
// it in episode e - 1 before arriving here) and releases the others.
__device__ int grid_lane_min(int* bar, int v, int e) {
  int* slot = bar + 2 + (e & 1);
  atomicMax(slot, kBig - v);
  __threadfence();
  if (atomicAdd(bar, 1) == static_cast<int>(gridDim.x) - 1) {
    atomicExch(bar, 0);
    atomicExch(bar + 2 + ((e + 1) & 1), 0);
    __threadfence();
    atomicAdd(bar + 1, 1);
  } else {
    while (ld_acquire(bar + 1) <= e) {
    }
  }
  return kBig - atomicAdd(slot, 0);
}

// The min of v over the lane's nodes, episode e: every thread passes
// its loops' min and gets the lane's.  Buffers alternate by parity, so
// one __syncthreads an episode separates a write from the reads of the
// episode before.
__device__ __forceinline__ int lane_min(int v, int e, int (*red)[kWarps],
                                        int* fleet, int* bar) {
  v = __reduce_min_sync(0xffffffffu, v);
  const int par = e & 1;
  if ((threadIdx.x & 31) == 0) red[par][threadIdx.x >> 5] = v;
  __syncthreads();
  int m = red[par][0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = min(m, red[par][w]);
  if (gridDim.x == 1) return m;
  if (threadIdx.x == 0) fleet[par] = grid_lane_min(bar, m, e);
  __syncthreads();
  return fleet[par];
}

// The segment with the AppGraph carry: one interval at a time, each
// ending in the lane's min of the progress code (see the header).  The
// next interval's demand row loads while this one waits on the min.
template <bool PAPER_LAW, bool UNIT_OCC, bool HAS_CACHE, bool BF16, int J>
__device__ __forceinline__ void graph_segment(
    Loop (&loop)[J], const int (&n)[J], const bool (&active)[J],
    const Lane& p, const SweepConsts& c, int* bins, const void* demand,
    const float* __restrict__ work, const float* __restrict__ stage,
    int* bar, int T, int N, int t0, int S, float comp_itv) {
  __shared__ int red[2][kWarps];
  __shared__ int fleet_sh[2];
  const float* stage_demand = stage;
  const float* stage_barrier = stage + (S + 1);
  float d_now[J];
#pragma unroll
  for (int j = 0; j < J; ++j) d_now[j] = load_demand<BF16>(demand, n[j]);
#pragma unroll 1
  for (int k = 0; k < T; ++k) {
    const float tf = static_cast<float>(t0 + k);
    const int k_next = min(k + 1, T - 1);
    float d_next[J];
    bool fin[J];
    int lvl = 2 * S;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      d_next[j] = load_demand<BF16>(demand, k_next * N + n[j]);
      Loop& s = loop[j];
      const float d = d_now[j] + __ldg(stage_demand + s.sidx);
      count(bins, step<PAPER_LAW, UNIT_OCC, HAS_CACHE>(s, p, c, d, tf),
            active[j]);
      const float dt_eff =
          HAS_CACHE ? s.dt : c.interval_s * hpl_slowdown_fused(s.r);
      const bool on_row = s.sidx < S;
      const float adv = on_row ? comp_itv * (c.interval_s / dt_eff) : 0.0f;
      kahan(s.wd, s.wd_c, fminf(adv, s.wleft));
      s.wleft = fmaxf(s.wleft - adv, 0.0f);
      fin[j] = on_row && s.wleft <= 0.0f;
      lvl = min(lvl, 2 * s.sidx + (fin[j] ? 1 : 0));
    }
    const int fleet = lane_min(lvl, k, red, fleet_sh, bar);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      Loop& s = loop[j];
      // every node sat on the sentinel row: the DAG finished last interval
      if (fleet == 2 * S && s.t_done < 0.0f) s.t_done = tf;
      const bool barrier_row = __ldg(stage_barrier + s.sidx) != 0.0f;
      if (fin[j] && (!barrier_row || fleet >= 2 * s.sidx + 1)) {
        s.sidx += 1;
        s.wleft = work[s.sidx * N + n[j]];
      }
      d_now[j] = d_next[j];
    }
  }
  int rows_done = S;
#pragma unroll
  for (int j = 0; j < J; ++j) rows_done = min(rows_done, loop[j].sidx);
  const int fleet = lane_min(rows_done, T, red, fleet_sh, bar);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (fleet >= S && loop[j].t_done < 0.0f) {
      loop[j].t_done = static_cast<float>(t0 + T);
    }
  }
}

template <bool PAPER_LAW, bool UNIT_OCC, bool HAS_CACHE, bool BF16,
          bool HAS_GRAPH>
__global__ void __launch_bounds__(kThreads) sweep_kernel(
    const void* __restrict__ demand, const float* __restrict__ lp,
    const float* __restrict__ np_rows, const float* __restrict__ alive,
    const float* __restrict__ state_in, float* __restrict__ state_out,
    int* __restrict__ hist, int T, int L, int N, int t0, SweepConsts c,
    const float* __restrict__ work, const float* __restrict__ stage,
    int* __restrict__ ws, int S, float comp_itv) {
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
    constexpr int kS = Planes<PAPER_LAW, HAS_CACHE, HAS_GRAPH>::kS;
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
    load_loop<PAPER_LAW, HAS_CACHE, HAS_GRAPH>(
        s, state_in, LN, static_cast<size_t>(l) * N + n[j]);
    s.inv_m = np_rows[ROW_INV_M * N + n[j]];
    s.w = np_rows[ROW_W * N + n[j]];
    s.inv_w = np_rows[ROW_INV_W * N + n[j]];
    s.wf0 = HAS_CACHE ? (c.warm_frac * fminf(p.u_max, s.w)) * s.inv_w : 0.0f;
  }
  __syncthreads();  // the bins are zero

  if constexpr (HAS_GRAPH) {
    graph_segment<PAPER_LAW, UNIT_OCC, HAS_CACHE, BF16>(
        loop, n, active, p, c, bins, demand, work, stage, ws + 4 * l, T, N,
        t0, S, comp_itv);
  } else {
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
          count(bins,
                step<PAPER_LAW, UNIT_OCC, HAS_CACHE>(loop[j], p, c, d, tf),
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
        count(bins,
              step<PAPER_LAW, UNIT_OCC, HAS_CACHE>(loop[j], p, c, d, tf),
              active[j]);
      }
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
      store_loop<PAPER_LAW, HAS_CACHE, HAS_GRAPH>(
          loop[j], state_out, LN, static_cast<size_t>(l) * N + n[j]);
    }
  }
}

using SweepFn = void (*)(const void*, const float*, const float*,
                         const float*, const float*, float*, int*, int, int,
                         int, int, SweepConsts, const float*, const float*,
                         int*, int, float);

template <bool PAPER_LAW, bool UNIT_OCC, bool HAS_CACHE, bool HAS_GRAPH>
SweepFn pick_instance(bool bf16) {
  return bf16 ? sweep_kernel<PAPER_LAW, UNIT_OCC, HAS_CACHE, true, HAS_GRAPH>
              : sweep_kernel<PAPER_LAW, UNIT_OCC, HAS_CACHE, false, HAS_GRAPH>;
}

template <bool HAS_GRAPH>
SweepFn pick_law(int paper_law, int unit_occupancy, int has_cache, bool b) {
  if (has_cache) {
    return paper_law ? pick_instance<true, true, true, HAS_GRAPH>(b)
                     : pick_instance<false, true, true, HAS_GRAPH>(b);
  }
  if (paper_law) {
    return unit_occupancy ? pick_instance<true, true, false, HAS_GRAPH>(b)
                          : pick_instance<true, false, false, HAS_GRAPH>(b);
  }
  return unit_occupancy ? pick_instance<false, true, false, HAS_GRAPH>(b)
                        : pick_instance<false, false, false, HAS_GRAPH>(b);
}

// The template instance for one specialization.  A cache segment always
// runs with unit occupancy (the resident set replaces the occupancy
// model).
SweepFn pick(int paper_law, int unit_occupancy, int has_cache, int bf16,
             int has_graph) {
  const bool b = bf16 != 0;
  return has_graph ? pick_law<true>(paper_law, unit_occupancy, has_cache, b)
                   : pick_law<false>(paper_law, unit_occupancy, has_cache, b);
}

}  // namespace

// Launches one segment on `stream`; returns the launch's CUDA error (0
// on success).  `hist` must already hold the counts to add to.  With
// `has_graph`, `work` (S+1, N), `stage` (2, S+1) and the zeroed (L, 4)
// int32 workspace `ws` are the AppGraph's; a lane wider than one block
// makes the launch cooperative, which the runtime refuses (an error,
// not a hang) when its blocks cannot all be resident.
extern "C" int dynims_sweep_segment(int paper_law, int unit_occupancy,
                                    int has_cache, int bf16, int has_graph,
                                    const void* demand, const float* lp,
                                    const float* np_rows, const float* alive,
                                    const float* state_in, float* state_out,
                                    int* hist, const float* work,
                                    const float* stage, int* ws, int T, int L,
                                    int N, int t0, int S, float comp_itv,
                                    const SweepConsts* consts, void* stream) {
  if (T <= 0 || L <= 0 || N <= 0) return 0;
  const int block_nodes = kThreads * nodes_per_thread(has_cache != 0);
  const dim3 grid((N + block_nodes - 1) / block_nodes, L);
  const SweepFn fn = pick(paper_law, unit_occupancy, has_cache, bf16,
                          has_graph);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  SweepConsts c = *consts;
  if (has_graph && grid.x > 1) {
    void* args[] = {&demand, &lp,   &np_rows, &alive, &state_in, &state_out,
                    &hist,   &T,    &L,       &N,     &t0,       &c,
                    &work,   &stage, &ws,     &S,     &comp_itv};
    const cudaError_t err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(fn), grid, dim3(kThreads), args, 0, s);
    const cudaError_t last = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err : last);
  }
  fn<<<grid, kThreads, 0, s>>>(demand, lp, np_rows, alive, state_in,
                               state_out, hist, T, L, N, t0, c, work, stage,
                               ws, S, comp_itv);
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread, static shared memory per block and resident
// blocks per SM of one template instance, into out[0..2]; returns the
// CUDA error (0 on success).
extern "C" int dynims_sweep_resources(int paper_law, int unit_occupancy,
                                      int has_cache, int bf16, int has_graph,
                                      int* out) {
  const SweepFn fn = pick(paper_law, unit_occupancy, has_cache, bf16,
                          has_graph);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], fn, kThreads, 0);
  return static_cast<int>(err);
}
