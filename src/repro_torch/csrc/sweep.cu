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
// and for the AppGraph instances (graph_kernel):
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
// AppGraph (graph_kernel): the queue/barrier carry of the reference's XLA
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
// one reduction over the lane's nodes, and the intervals are serial:
// a small fleet is bound by the latency of that chain, not by
// operations or bytes, and a large one by the card's registers, which
// decide how many lanes run at once.  The graph instances are their own
// kernel (graph_kernel), shaped per launch by the wrapper's planner
// (kernels/sweep.py::graph_route): J loops a thread (a template
// parameter: 1, or wide_loops), the threads of a block (up to 512) and
// the blocks of a lane arrive as launch dimensions.  Each warp reduces
// its min with __reduce_min_sync and, where the lane has more than one
// warp, folds it into its block's slot in shared memory (atomicMin; three
// slots by episode, so one barrier an interval separates a write from
// the reads of the interval before and the refill of the one before
// that).  Then by shape:
//   * one warp holds the lane: the warp's min is the lane's;
//   * one block: __syncthreads, and every thread reads the slot;
//   * one thread-block cluster (<= 16 blocks, co-scheduled on one GPC,
//     launched with cudaLaunchKernelEx): the hardware cluster barrier
//     (barrier.cluster.arrive.release ... wait.acquire, the free rows'
//     promotions in between), and each warp reads every block's slot
//     over distributed shared memory (ld.shared::cluster).  Only a
//     cluster has to be resident, so any number of lanes may wait for
//     the card;
//   * wider lanes: the block's min meets the other blocks' at a per-lane
//     barrier in device memory (arrival counter, generation, two min
//     slots by parity, in a workspace the wrapper zeroes), which needs
//     every block of the launch resident: a cooperative launch, refused
//     (an error, not a hang) when they do not fit.
// Each interval's reads that do not depend on the min are issued before
// it: the demand kAhead rows ahead (a ring of registers, as the
// graph-free loop), the stage rows (copied into shared memory at entry)
// and the promotion's work entry; its histogram counts go after it, to
// drain while the next interval steps (before it, they queue in front of
// the slot reads).  Integer mins commute, so every route computes the
// same bits.
// The reference's second reduction, min(sidx) >= S for t_done, is read
// off the next interval's min instead: a node past the last row has
// code 2 * S and any other node less, so that min is 2 * S exactly when
// every node finished on the interval before.  One more reduction at
// the segment's end settles its last interval.  Loops past the last
// node run node N - 1 and enter the min with node N - 1's own code.
// Without the cache dt_eff is the pressure curve as XLA compiles it
// (folded slopes, one rounding per segment: hpl_slowdown_fused); with
// it, the CacheLoop's dt_app.  The carry adds ~20 operations an update.
//
// The one-interval graph entry (dynims_sweep_graph_interval): when a
// lane's nodes are split over shards (devices, or streams of one card),
// the lane min has to leave the launch.  Each launch then runs one
// interval with the loop body rotated: it first finishes the previous
// interval with the fleet min the caller folded over the shards (the
// t_done test and the promotion, mode bit kPromote, reading `fleet_in`),
// then steps its interval up to the progress code and atomicMins its
// shard's lane min into `lvl_out` (kStep).  The segment's closing
// reduction is two more launches: the min of the stage rows (kRows),
// then the t_done of a DAG that finished on the last interval (kClose).
// State stays in `state`, read and written in place once a launch; the
// histogram row gets each interval's counts by warp-aggregated atomics.

#include <climits>

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

template <bool PAPER_LAW, bool UNIT_OCC, bool HAS_CACHE, bool BF16>
__global__ void __launch_bounds__(kThreads) sweep_kernel(
    const void* __restrict__ demand, const float* __restrict__ lp,
    const float* __restrict__ np_rows, const float* __restrict__ alive,
    const float* __restrict__ state_in, float* __restrict__ state_out,
    int* __restrict__ hist, int T, int L, int N, int t0, SweepConsts c,
    const float* __restrict__ work, const float* __restrict__ stage,
    int* __restrict__ ws, int S, float comp_itv) {
  // work, stage, ws, S and comp_itv are graph_kernel's operands, unused
  // here: both kernels take one parameter list (SweepFn).
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

// ---- The AppGraph instances (see the header) -----------------------------

constexpr int kGraphThreads = 512;  // threads of a graph block, at most
constexpr int kMaxCluster = 16;     // blocks of a cluster (non-portable)

// Loops a thread of the wide graph instance runs: the more, the more
// independent chains hide an interval's latency and the fewer threads
// meet at the barrier; registers allow four without the cache, two
// with it.  Lanes of at most 32 nodes take one.
__host__ __device__ constexpr int wide_loops(bool has_cache) {
  return has_cache ? 2 : 4;
}

// How the lane's min is taken: in the warp, in the block, in the
// cluster, or at the grid barrier in device memory.
enum MeetRoute { kMeetWarp = 0, kMeetBlock, kMeetCluster, kMeetGrid };

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

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ unsigned cluster_blocks() {
  unsigned n;
  asm("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return n;
}

// The shared::cluster address of *p in the cluster's block `rank`.
__device__ __forceinline__ unsigned cluster_addr(const void* p, int rank) {
  const unsigned local = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned out;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(local),
      "r"(rank));
  return out;
}

__device__ __forceinline__ int ld_cluster(unsigned addr) {
  int v;
  asm volatile("ld.shared::cluster.s32 %0, [%1];" : "=r"(v) : "r"(addr)
               : "memory");
  return v;
}

// Where a lane's mins meet: the route, the block's min of each episode
// in one of three shared slots (episode e in slot e % 3), the grid
// route's result (fleet) and barrier (bar), and on the cluster route the
// shared::cluster address of slot 0 in the block this thread's lane of
// the warp reads (lane < n_blocks).
struct Meet {
  int route;
  int n_blocks;
  int* slot;
  int* fleet;
  int* bar;
  unsigned src;
};

// The min of v over the lane's nodes, episode e, by every thread of the
// lane.  Each warp folds its min into the block's slot (a shared
// atomicMin).  On the block route the slot is read after __syncthreads;
// on the cluster route every block's slot is read over distributed
// shared memory once the cluster's hardware barrier has passed.  Then
// thread 0 refills the slot of episode e - 1, which every thread read
// before arriving at this barrier and none writes before the next.  On
// the grid route thread 0 of each block meets the others at the barrier
// in device memory.  between() runs while the blocks meet.
template <typename F>
__device__ __forceinline__ int lane_min(int v, int e, const Meet& m,
                                        F&& between) {
  v = __reduce_min_sync(0xffffffffu, v);
  if (m.route == kMeetWarp) {
    between();
    return v;
  }
  const int s = e % 3;
  if ((threadIdx.x & 31) == 0) atomicMin(&m.slot[s], v);
  if (m.route == kMeetCluster) {
    cluster_arrive();
    between();
    cluster_wait();
    if (threadIdx.x == 0) m.slot[(s + 2) % 3] = INT_MAX;
    const int lane = threadIdx.x & 31;
    const int x = lane < m.n_blocks ? ld_cluster(m.src + s * 4u) : INT_MAX;
    return __reduce_min_sync(0xffffffffu, x);
  }
  between();
  __syncthreads();
  if (m.route == kMeetBlock) {
    const int x = m.slot[s];
    if (threadIdx.x == 0) m.slot[(s + 2) % 3] = INT_MAX;
    return x;
  }
  if (threadIdx.x == 0) {
    m.fleet[e & 1] = grid_lane_min(m.bar, m.slot[s], e);
    m.slot[(s + 2) % 3] = INT_MAX;
  }
  __syncthreads();
  return m.fleet[e & 1];
}

// The segment with the AppGraph carry, one (lane, node) loop per j of a
// thread, J of them: one interval at a time, each ending in the lane's
// min of the progress code.  Grid (blocks a lane, L), blockDim.x threads
// (a multiple of 32, at most kGraphThreads); the route follows from the
// launch: one block of one warp; one block; one cluster holding every
// block of the lane; or several blocks in clusters of one, which meet at
// the grid barrier on `ws`.  Dynamic shared memory holds the (2, S+1)
// stage rows.
template <bool PAPER_LAW, bool UNIT_OCC, bool HAS_CACHE, bool BF16, int J>
__global__ void __launch_bounds__(kGraphThreads, 1) graph_kernel(
    const void* __restrict__ demand, const float* __restrict__ lp,
    const float* __restrict__ np_rows, const float* __restrict__ alive,
    const float* __restrict__ state_in, float* __restrict__ state_out,
    int* __restrict__ hist, int T, int L, int N, int t0, SweepConsts c,
    const float* __restrict__ work, const float* __restrict__ stage,
    int* __restrict__ ws, int S, float comp_itv) {
  __shared__ int bins[kBins + 1];
  __shared__ int slot[3];
  __shared__ int fleet_sh[2];
  extern __shared__ float stage_sh[];
  const int threads = blockDim.x;
  const int l = blockIdx.y;
  const size_t LN = static_cast<size_t>(L) * N;
  int n[J];
  bool active[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int node = (blockIdx.x * J + j) * threads + threadIdx.x;
    active[j] = node < N;
    n[j] = active[j] ? node : N - 1;
  }
  if (!(alive[l] > 0.5f)) {  // the whole lane is dead: every block of it
    constexpr int kS = Planes<PAPER_LAW, HAS_CACHE, true>::kS;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const size_t ln = static_cast<size_t>(l) * N + n[j];
      if (!active[j]) continue;
      for (int s = 0; s < kS; ++s) state_out[s * LN + ln] = state_in[s * LN + ln];
    }
    return;
  }
  for (int b = threadIdx.x; b <= kBins; b += threads) bins[b] = 0;
  for (int i = threadIdx.x; i < 2 * (S + 1); i += threads) {
    stage_sh[i] = stage[i];
  }
  if (threadIdx.x < 3) slot[threadIdx.x] = INT_MAX;
  const float* stage_demand = stage_sh;
  const float* stage_barrier = stage_sh + (S + 1);

  Meet m;
  m.slot = slot;
  m.fleet = fleet_sh;
  m.bar = ws + 4 * l;
  m.n_blocks = static_cast<int>(gridDim.x);
  m.src = 0u;
  if (m.n_blocks == 1) {
    m.route = threads == 32 ? kMeetWarp : kMeetBlock;
  } else if (m.n_blocks > static_cast<int>(cluster_blocks())) {
    m.route = kMeetGrid;
  } else {
    m.route = kMeetCluster;
    const int lane = threadIdx.x & 31;
    if (lane < m.n_blocks) m.src = cluster_addr(slot, lane);
  }

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
    load_loop<PAPER_LAW, HAS_CACHE, true>(s, state_in, LN,
                                          static_cast<size_t>(l) * N + n[j]);
    s.inv_m = np_rows[ROW_INV_M * N + n[j]];
    s.w = np_rows[ROW_W * N + n[j]];
    s.inv_w = np_rows[ROW_INV_W * N + n[j]];
    s.wf0 = HAS_CACHE ? (c.warm_frac * fminf(p.u_max, s.w)) * s.inv_w : 0.0f;
  }
  // demand rows k .. k + kAhead - 1 in flight, as the graph-free loop
  float ring[kAhead][J];
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      ring[i][j] = load_demand<BF16>(demand, min(i, T - 1) * N + n[j]);
    }
  }
  __syncthreads();  // the bins are zero, the slots full, the stage rows in

#pragma unroll 1
  for (int k0 = 0; k0 < T; k0 += kAhead) {
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const int k = k0 + i;
      if (k < T) {  // the same k in every thread of the lane
        const float tf = static_cast<float>(t0 + k);
        const int ahead = min(k + kAhead, T - 1) * N;
        int bin[J];
        bool fin[J], wait_row[J];
        float w_next[J];
        int lvl = 2 * S;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          Loop& s = loop[j];
          const float d = ring[i][j] + stage_demand[s.sidx];
          ring[i][j] = load_demand<BF16>(demand, ahead + n[j]);
          bin[j] = step<PAPER_LAW, UNIT_OCC, HAS_CACHE>(s, p, c, d, tf);
          const float dt_eff =
              HAS_CACHE ? s.dt : c.interval_s * hpl_slowdown_fused(s.r);
          const bool on_row = s.sidx < S;
          const float adv = on_row ? comp_itv * (c.interval_s / dt_eff) : 0.0f;
          kahan(s.wd, s.wd_c, fminf(adv, s.wleft));
          s.wleft = fmaxf(s.wleft - adv, 0.0f);
          fin[j] = on_row && s.wleft <= 0.0f;
          lvl = min(lvl, 2 * s.sidx + (fin[j] ? 1 : 0));
          // the promotion's reads, ahead of the min it may wait for
          w_next[j] = fin[j] ? work[(s.sidx + 1) * N + n[j]] : 0.0f;
          wait_row[j] = stage_barrier[s.sidx] != 0.0f;
        }
        // a free row promotes once its own work is drained, while the
        // lane's blocks meet; a barrier row when the min says every node
        // finished it
        const int fleet = lane_min(lvl, k, m, [&] {
#pragma unroll
          for (int j = 0; j < J; ++j) {
            Loop& s = loop[j];
            if (fin[j] && !wait_row[j]) {
              s.sidx += 1;
              s.wleft = w_next[j];
              fin[j] = false;
            }
          }
        });
#pragma unroll
        for (int j = 0; j < J; ++j) {
          Loop& s = loop[j];
          // every node sat on the sentinel row: the DAG finished
          if (fleet == 2 * S && s.t_done < 0.0f) s.t_done = tf;
          if (fin[j] && fleet >= 2 * s.sidx + 1) {
            s.sidx += 1;
            s.wleft = w_next[j];
          }
        }
        // the interval's counts drain while the next interval steps
#pragma unroll
        for (int j = 0; j < J; ++j) count(bins, bin[j], active[j]);
      }
    }
  }
  int rows_done = S;
#pragma unroll
  for (int j = 0; j < J; ++j) rows_done = min(rows_done, loop[j].sidx);
  const int fleet = lane_min(rows_done, T, m, [] {});
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (fleet >= S && loop[j].t_done < 0.0f) {
      loop[j].t_done = static_cast<float>(t0 + T);
    }
  }
  // no block of a cluster leaves while another may read its slots
  if (m.route == kMeetCluster) cluster_arrive();
  __syncthreads();  // every update is counted
  int* out = hist + static_cast<size_t>(l) * kBins;
  for (int b = threadIdx.x; b < kBins; b += threads) {
    const int counted = bins[b];
    if (counted) atomicAdd(&out[b], counted);
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (active[j]) {
      store_loop<PAPER_LAW, HAS_CACHE, true>(
          loop[j], state_out, LN, static_cast<size_t>(l) * N + n[j]);
    }
  }
  if (m.route == kMeetCluster) cluster_wait();
}

// Mode bits of the one-interval graph entry (kernels/sweep.py GRAPH_*).
constexpr int kPromote = 1;  // finish interval t - 1 with fleet_in
constexpr int kStep = 2;     // step interval t (demand row `row`)
constexpr int kRows = 4;     // the lane min of the stage rows
constexpr int kClose = 8;    // fleet_in is the rows min: t_done = t

// One update into a lane's histogram row in device memory: the warp's
// equal bins are added by one atomic.  A loop past the last node counts
// nothing.
__device__ __forceinline__ void count_row(int* row, int bin, bool counted) {
  const int key = counted ? bin : -1;
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  if (key >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1) {
    atomicAdd(row + key, __popc(peers));
  }
}

template <bool PAPER_LAW, bool UNIT_OCC, bool HAS_CACHE, bool BF16>
__global__ void __launch_bounds__(kThreads) graph_interval_kernel(
    const void* __restrict__ demand, int row, const float* __restrict__ lp,
    const float* __restrict__ np_rows, const float* __restrict__ alive,
    float* __restrict__ state, int* __restrict__ hist,
    const float* __restrict__ work, const float* __restrict__ stage,
    const int* __restrict__ fleet_in, int* __restrict__ lvl_out, int L,
    int N, int t, int S, float comp_itv, SweepConsts c, int mode) {
  constexpr int J = nodes_per_thread(HAS_CACHE);
  __shared__ int red[kWarps];
  const int l = blockIdx.y;
  if (!(alive[l] > 0.5f)) return;  // the whole block: its lane is dead
  const size_t LN = static_cast<size_t>(L) * N;
  int n[J];
  bool active[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int node = (blockIdx.x * J + j) * kThreads + threadIdx.x;
    active[j] = node < N;
    n[j] = active[j] ? node : N - 1;
  }
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
  const float* stage_demand = stage;
  const float* stage_barrier = stage + (S + 1);
  Loop loop[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    Loop& s = loop[j];
    load_loop<PAPER_LAW, HAS_CACHE, true>(s, state, LN,
                                          static_cast<size_t>(l) * N + n[j]);
    s.inv_m = np_rows[ROW_INV_M * N + n[j]];
    s.w = np_rows[ROW_W * N + n[j]];
    s.inv_w = np_rows[ROW_INV_W * N + n[j]];
    s.wf0 = HAS_CACHE ? (c.warm_frac * fminf(p.u_max, s.w)) * s.inv_w : 0.0f;
  }
  if (mode & kPromote) {
    // the end of interval t - 1, as graph_segment ends each interval
    const int fleet = fleet_in[l];
    const float tf_prev = static_cast<float>(t - 1);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      Loop& s = loop[j];
      if (fleet == 2 * S && s.t_done < 0.0f) s.t_done = tf_prev;
      const bool fin = s.sidx < S && s.wleft <= 0.0f;
      const bool barrier_row = __ldg(stage_barrier + s.sidx) != 0.0f;
      if (fin && (!barrier_row || fleet >= 2 * s.sidx + 1)) {
        s.sidx += 1;
        s.wleft = work[s.sidx * N + n[j]];
      }
    }
  }
  if (mode & kClose) {
    const int rows_done = fleet_in[l];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (rows_done >= S && loop[j].t_done < 0.0f) {
        loop[j].t_done = static_cast<float>(t);
      }
    }
  }
  int v = INT_MAX;
  if (mode & kStep) {
    const float tf = static_cast<float>(t);
    int* bins = hist + static_cast<size_t>(l) * kBins;
    v = 2 * S;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      Loop& s = loop[j];
      const float d = load_demand<BF16>(demand, row * N + n[j]) +
                      __ldg(stage_demand + s.sidx);
      count_row(bins, step<PAPER_LAW, UNIT_OCC, HAS_CACHE>(s, p, c, d, tf),
                active[j]);
      const float dt_eff =
          HAS_CACHE ? s.dt : c.interval_s * hpl_slowdown_fused(s.r);
      const bool on_row = s.sidx < S;
      const float adv = on_row ? comp_itv * (c.interval_s / dt_eff) : 0.0f;
      kahan(s.wd, s.wd_c, fminf(adv, s.wleft));
      s.wleft = fmaxf(s.wleft - adv, 0.0f);
      const bool fin = on_row && s.wleft <= 0.0f;
      v = min(v, 2 * s.sidx + (fin ? 1 : 0));
    }
  } else if (mode & kRows) {
    v = S;
#pragma unroll
    for (int j = 0; j < J; ++j) v = min(v, loop[j].sidx);
  }
  if (mode & (kStep | kRows)) {
    v = __reduce_min_sync(0xffffffffu, v);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
      int m = red[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) m = min(m, red[w]);
      atomicMin(lvl_out + l, m);
    }
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (active[j]) {
      store_loop<PAPER_LAW, HAS_CACHE, true>(
          loop[j], state, LN, static_cast<size_t>(l) * N + n[j]);
    }
  }
}

using IntervalFn = void (*)(const void*, int, const float*, const float*,
                            const float*, float*, int*, const float*,
                            const float*, const int*, int*, int, int, int,
                            int, float, SweepConsts, int);

template <bool PAPER_LAW, bool UNIT_OCC, bool HAS_CACHE>
IntervalFn pick_interval_instance(bool bf16) {
  return bf16 ? graph_interval_kernel<PAPER_LAW, UNIT_OCC, HAS_CACHE, true>
              : graph_interval_kernel<PAPER_LAW, UNIT_OCC, HAS_CACHE, false>;
}

IntervalFn pick_interval(int paper_law, int unit_occupancy, int has_cache,
                         int bf16) {
  const bool b = bf16 != 0;
  if (has_cache) {
    return paper_law ? pick_interval_instance<true, true, true>(b)
                     : pick_interval_instance<false, true, true>(b);
  }
  if (paper_law) {
    return unit_occupancy ? pick_interval_instance<true, true, false>(b)
                          : pick_interval_instance<true, false, false>(b);
  }
  return unit_occupancy ? pick_interval_instance<false, true, false>(b)
                        : pick_interval_instance<false, false, false>(b);
}

using SweepFn = void (*)(const void*, const float*, const float*,
                         const float*, const float*, float*, int*, int, int,
                         int, int, SweepConsts, const float*, const float*,
                         int*, int, float);

template <bool PAPER_LAW, bool UNIT_OCC, bool HAS_CACHE>
SweepFn pick_instance(bool bf16) {
  return bf16 ? sweep_kernel<PAPER_LAW, UNIT_OCC, HAS_CACHE, true>
              : sweep_kernel<PAPER_LAW, UNIT_OCC, HAS_CACHE, false>;
}

// The graph instance of J loops a thread: 1 or wide_loops(HAS_CACHE);
// null for any other J.
template <bool PAPER_LAW, bool UNIT_OCC, bool HAS_CACHE>
SweepFn pick_graph_instance(bool bf16, int j) {
  constexpr int kWide = wide_loops(HAS_CACHE);
  if (j == 1) {
    return bf16 ? graph_kernel<PAPER_LAW, UNIT_OCC, HAS_CACHE, true, 1>
                : graph_kernel<PAPER_LAW, UNIT_OCC, HAS_CACHE, false, 1>;
  }
  if (j == kWide) {
    return bf16 ? graph_kernel<PAPER_LAW, UNIT_OCC, HAS_CACHE, true, kWide>
                : graph_kernel<PAPER_LAW, UNIT_OCC, HAS_CACHE, false, kWide>;
  }
  return nullptr;
}

// The template instance for one specialization: the graph-free kernel
// when j is 0, else the graph instance of j loops a thread.  A cache
// segment always runs with unit occupancy (the resident set replaces the
// occupancy model).
SweepFn pick(int paper_law, int unit_occupancy, int has_cache, int bf16,
             int j) {
  const bool b = bf16 != 0;
  if (j > 0) {
    if (has_cache) {
      return paper_law ? pick_graph_instance<true, true, true>(b, j)
                       : pick_graph_instance<false, true, true>(b, j);
    }
    if (paper_law) {
      return unit_occupancy ? pick_graph_instance<true, true, false>(b, j)
                            : pick_graph_instance<true, false, false>(b, j);
    }
    return unit_occupancy ? pick_graph_instance<false, true, false>(b, j)
                          : pick_graph_instance<false, false, false>(b, j);
  }
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

// Dynamic shared memory of a graph launch over S + 1 stage rows; past the
// default 48 KB a block may take only after the kernel is allowed it.
cudaError_t graph_smem(SweepFn fn, int rows, size_t* bytes) {
  *bytes = 2 * static_cast<size_t>(rows) * sizeof(float);
  if (*bytes <= 16 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(fn),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*bytes));
}

// A launch configuration of `cluster` blocks a cluster (none when 1).
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;

  ClusterLaunch(SweepFn fn, dim3 grid, int threads, size_t smem, int cluster,
                cudaStream_t stream, cudaError_t* err) : cfg(), attr() {
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    *err = cudaSuccess;
    if (cluster > 1) {
      attr.id = cudaLaunchAttributeClusterDimension;
      attr.val.clusterDim.x = cluster;
      attr.val.clusterDim.y = 1;
      attr.val.clusterDim.z = 1;
      cfg.attrs = &attr;
      cfg.numAttrs = 1;
      if (cluster > 8) {
        *err = cudaFuncSetAttribute(
            reinterpret_cast<const void*>(fn),
            cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      }
    }
  }
};

}  // namespace

// Launches one graph-free segment on `stream`; returns the launch's CUDA
// error (0 on success).  `hist` must already hold the counts to add to.
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
  const SweepFn fn = pick(paper_law, unit_occupancy, has_cache, bf16, 0);
  fn<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      demand, lp, np_rows, alive, state_in, state_out, hist, T, L, N, t0,
      *consts, nullptr, nullptr, nullptr, 0, 0.0f);
  return static_cast<int>(cudaGetLastError());
}

// Launches one segment with the AppGraph carry on `stream`, shaped as
// the wrapper's planner chose (kernels/sweep.py::graph_route): `j` loops
// a thread, `threads` a block (a multiple of 32, at most kGraphThreads),
// ceil(N / (j * threads)) blocks a lane, and either `cluster` equal to
// those blocks (one block or one cluster a lane) or `cooperative` with
// clusters of one, the lanes' blocks meeting at the zeroed (L, 4) int32
// barrier workspace `ws`.  `work` is (S+1, N) and `stage` (2, S+1).
// Returns the launch's CUDA error (0 on success): a shape this entry
// does not take is cudaErrorInvalidValue, and a cluster or cooperative
// grid the card cannot hold resident is refused by the runtime (an
// error, not a hang).
extern "C" int dynims_graph_segment(
    int paper_law, int unit_occupancy, int has_cache, int bf16, int j,
    int threads, int cluster, int cooperative, const void* demand,
    const float* lp, const float* np_rows, const float* alive,
    const float* state_in, float* state_out, int* hist, const float* work,
    const float* stage, int* ws, int T, int L, int N, int t0, int S,
    float comp_itv, const SweepConsts* consts, void* stream) {
  if (T <= 0 || L <= 0 || N <= 0) return 0;
  const SweepFn fn = pick(paper_law, unit_occupancy, has_cache, bf16, j);
  if (fn == nullptr || threads < 32 || threads > kGraphThreads ||
      threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (N + j * threads - 1) / (j * threads);
  const bool shape_ok = cooperative
                            ? cluster == 1 && blocks > 1
                            : cluster == blocks && cluster <= kMaxCluster;
  if (!shape_ok) return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  cudaError_t err = graph_smem(fn, S + 1, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(blocks, L);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  SweepConsts c = *consts;
  if (cooperative) {
    void* args[] = {&demand, &lp,   &np_rows, &alive, &state_in, &state_out,
                    &hist,   &T,    &L,       &N,     &t0,       &c,
                    &work,   &stage, &ws,     &S,     &comp_itv};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fn),
                                      grid, dim3(threads), args, smem, s);
  } else {
    ClusterLaunch launch(fn, grid, threads, smem, cluster, s, &err);
    if (err == cudaSuccess) {
      err = cudaLaunchKernelEx(&launch.cfg, fn, demand, lp, np_rows, alive,
                               state_in, state_out, hist, T, L, N, t0, c,
                               work, stage, ws, S, comp_itv);
    }
  }
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// Launches one interval of the graph carry on `stream` (see the header's
// one-interval entry); returns the launch's CUDA error (0 on success).
// `state` (S, L, N) and `hist` (L, 4096) are updated in place; `lvl_out`
// (L,) int32 must hold INT_MAX, or a min to fold into, before the launch.
extern "C" int dynims_sweep_graph_interval(
    int paper_law, int unit_occupancy, int has_cache, int bf16,
    const void* demand, int row, const float* lp, const float* np_rows,
    const float* alive, float* state, int* hist, const float* work,
    const float* stage, const int* fleet_in, int* lvl_out, int L, int N,
    int t, int S, float comp_itv, const SweepConsts* consts, int mode,
    void* stream) {
  if (L <= 0 || N <= 0) return 0;
  const int block_nodes = kThreads * nodes_per_thread(has_cache != 0);
  const dim3 grid((N + block_nodes - 1) / block_nodes, L);
  const IntervalFn fn = pick_interval(paper_law, unit_occupancy, has_cache,
                                      bf16);
  fn<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      demand, row, lp, np_rows, alive, state, hist, work, stage, fleet_in,
      lvl_out, L, N, t, S, comp_itv, *consts, mode);
  return static_cast<int>(cudaGetLastError());
}

// Of one template instance (j as in pick: 0 for the graph-free kernel),
// into out[0..4]: registers a thread, static shared bytes a block,
// resident blocks an SM at `threads` a block and the dynamic shared
// memory of `rows` stage rows, the most clusters of `cluster` blocks the
// card holds at once (0 when cluster < 2), and local (spilled) bytes a
// thread.  Returns the CUDA error (0 on success).
extern "C" int dynims_sweep_resources(int paper_law, int unit_occupancy,
                                      int has_cache, int bf16, int j,
                                      int threads, int cluster, int rows,
                                      int* out) {
  const SweepFn fn = pick(paper_law, unit_occupancy, has_cache, bf16, j);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = 0;
  out[4] = static_cast<int>(attr.localSizeBytes);
  size_t smem = 0;
  if (j > 0) {
    err = graph_smem(fn, rows, &smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], fn, threads,
                                                      smem);
  if (err != cudaSuccess || cluster < 2) return static_cast<int>(err);
  ClusterLaunch launch(fn, dim3(cluster, 1), threads, smem, cluster,
                       nullptr, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      &out[3], reinterpret_cast<const void*>(fn), &launch.cfg));
}
