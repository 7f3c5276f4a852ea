// The fused DynIMS sweep step for Hopper (sm_90a).
//
// Replaces the TPU kernel `_sweep_kernel` in repro/lab/pallas_sweep.py
// (step math `_fused_step`).  One thread runs one (gain lane, node)
// closed loop over the segment [t0, t0 + T): paper Eq. 1 with the
// optional feedforward / asymmetric gain / deadband, the CacheLoop
// carry, the Kahan / count / max accumulators, and one uint16
// utilization code per (t, lane, node).  The plain PyTorch version is
// `sweep_segment_plain` in repro_torch/kernels/sweep.py; the two must
// agree bit for bit without the cache and to 1e-6 relative with it.
//
// Layout (all row-major, contiguous):
//   demand  (T, N)     float32, or bfloat16 when BF16
//   lp      (10, L)    lane params: r0 lam lam_grant u_min u_max deadband
//                      feedforward inv_r0 thr_over thr_settle
//   np_rows (4, N)     node rows: M inv_M W inv_W
//   alive   (1, L)     lane is live iff alive > 0.5
//   state   (S, L, N)  planes in repro_torch.kernels.sweep.state_names
//   codes   (T, L, N)  uint16
//
// Bound: without the cache the code stream (2 bytes per update) is the
// traffic that matters -- demand rows are shared by every lane and stay
// in L2 -- so the kernel is bound by bytes (32 operations per 2-byte
// code); with the cache the 85 operations per update (two of them
// float64 transcendentals) bound it.  Design: state lives in
// registers for the whole segment (read once, written once), blocks
// run along the node axis so every load and store is coalesced, and
// the TPU grid's sequential time axis becomes the loop in the thread.
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
//   * the uint16 code: fminf/fmaxf clamp, then a truncating cast, as
//     `astype(uint16)` truncates;
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
constexpr int kBlock = 128;

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

template <bool PAPER_LAW, bool UNIT_OCC, bool HAS_CACHE, bool BF16>
__global__ void __launch_bounds__(kBlock) sweep_kernel(
    const void* __restrict__ demand, const float* __restrict__ lp,
    const float* __restrict__ np_rows, const float* __restrict__ alive,
    const float* __restrict__ state_in, float* __restrict__ state_out,
    uint16_t* __restrict__ codes, int T, int L, int N, int t0,
    SweepConsts c) {
  // Plane indices, in state_names order.
  constexpr int kVPrev = 1;
  constexpr int kRes = PAPER_LAW ? 1 : 2;
  constexpr int kAcc = 1 + (PAPER_LAW ? 0 : 1) + (HAS_CACHE ? 1 : 0);
  constexpr int kCacheAcc = kAcc + 9;
  constexpr int kS = kCacheAcc + (HAS_CACHE ? 6 : 0);

  const int n = blockIdx.x * kBlock + threadIdx.x;
  const int l = blockIdx.y;
  if (n >= N) return;
  const size_t LN = static_cast<size_t>(L) * N;
  const size_t ln = static_cast<size_t>(l) * N + n;

  if (!(alive[l] > 0.5f)) {
    for (int s = 0; s < kS; ++s) state_out[s * LN + ln] = state_in[s * LN + ln];
    for (int k = 0; k < T; ++k) codes[k * LN + ln] = 0;
    return;
  }

  float u = state_in[ln];
  float v_prev = PAPER_LAW ? 0.0f : state_in[kVPrev * LN + ln];
  float resident = HAS_CACHE ? state_in[kRes * LN + ln] : 0.0f;
  float acc[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) acc[i] = state_in[(kAcc + i) * LN + ln];
  float us = acc[0], us_c = acc[1], cs = acc[2], cs_c = acc[3], c2 = acc[4];
  float mx = acc[5], n_r0 = acc[6], n_viol = acc[7], last_bad = acc[8];
  float hs = 0.0f, hs_c = 0.0f, es = 0.0f, es_c = 0.0f, ts = 0.0f,
        ts_c = 0.0f;
  if (HAS_CACHE) {
    hs = state_in[(kCacheAcc + 0) * LN + ln];
    hs_c = state_in[(kCacheAcc + 1) * LN + ln];
    es = state_in[(kCacheAcc + 2) * LN + ln];
    es_c = state_in[(kCacheAcc + 3) * LN + ln];
    ts = state_in[(kCacheAcc + 4) * LN + ln];
    ts_c = state_in[(kCacheAcc + 5) * LN + ln];
  }

  const float r0 = lp[R0 * L + l];
  const float lam = lp[LAM * L + l];
  const float lam_grant = lp[LAM_GRANT * L + l];
  const float u_min = lp[U_MIN * L + l];
  const float u_max = lp[U_MAX * L + l];
  const float db = lp[DB * L + l];
  const float ff = lp[FF * L + l];
  const float inv_r0 = lp[INV_R0 * L + l];
  const float thr_over = lp[THR_OVER * L + l];
  const float thr_settle = lp[THR_SETTLE * L + l];
  const float inv_m = np_rows[ROW_INV_M * N + n];
  const float w = np_rows[ROW_W * N + n];
  const float inv_w = np_rows[ROW_INV_W * N + n];
  float wf0 = 0.0f;
  if (HAS_CACHE) wf0 = (c.warm_frac * fminf(u_max, w)) * inv_w;

  for (int k = 0; k < T; ++k) {
    float d;
    if (BF16) {
      d = __bfloat162float(
          static_cast<const __nv_bfloat16*>(demand)[static_cast<size_t>(k) * N + n]);
    } else {
      d = static_cast<const float*>(demand)[static_cast<size_t>(k) * N + n];
    }
    float v;
    if (HAS_CACHE) {
      v = d + resident;
    } else if (UNIT_OCC) {
      v = d + u;
    } else {
      v = fma_once(c.occupancy, u, d);
    }
    const float v_eff = PAPER_LAW ? v : fma_once(ff, v - v_prev, v);

    // Eq. 1 (vectorized_step with the reciprocal multiplies).
    const float err = fma_once(v_eff, inv_m, -r0);
    const float lam_eff = PAPER_LAW ? lam : (err < 0.0f ? lam_grant : lam);
    float u_next = fma_once(-(lam_eff * v_eff), err * inv_r0, u);
    if (!PAPER_LAW && fabsf(err) <= db) u_next = u;
    u_next = fminf(fmaxf(u_next, u_min), u_max);

    const float r = v * inv_m;
    const float tf = static_cast<float>(t0 + k);
    kahan(us, us_c, r);
    const float cap_gib = u_next * kInvGiB;
    kahan(cs, cs_c, cap_gib);
    c2 = fma_once(cap_gib, cap_gib, c2);
    mx = fmaxf(mx, r);
    n_r0 = n_r0 + (r > thr_over ? 1.0f : 0.0f);
    n_viol = n_viol + (r > 1.0f ? 1.0f : 0.0f);
    last_bad = r > thr_settle ? tf : last_bad;
    if (!PAPER_LAW) v_prev = v;

    if (HAS_CACHE) {
      const float res_ev = fminf(resident, u_next);
      const float ev_g = (resident - res_ev) * kInvGiB;
      const float f = fminf(res_ev * inv_w, 1.0f);
      float p;
      if (c.pow_mode == 1) {
        p = f;
      } else if (c.pow_mode == 2) {
        p = 1.0f;
      } else {
        // float64, rounded once: see _fast_pow in kernels/sweep.py.
        p = static_cast<float>(exp2(static_cast<double>(c.hit_exp) *
                                    log2(static_cast<double>(fmaxf(f, 1e-30f)))));
      }
      float hit = c.conc * p + c.one_minus_conc * f;
      const float scanned = tf * c.access_b;
      const float wf = fminf(wf0, f);
      hit = scanned < w ? wf + c.cold_mix * (hit - wf) : hit;
      const float miss_g = (1.0f - hit) * c.access_g;
      const float target = fminf(u_next, w);
      resident = fminf(target, res_ev + fminf(miss_g * kGiB, c.refill_b));
      const float dt_app = c.interval_s * hpl_slowdown(r) +
                           miss_g * c.miss_pen + ev_g * c.evict_pen;
      kahan(hs, hs_c, hit * c.access_g);
      kahan(es, es_c, ev_g);
      kahan(ts, ts_c, dt_app);
    }
    u = u_next;
    codes[static_cast<size_t>(k) * LN + ln] =
        static_cast<uint16_t>(fminf(fmaxf(r * 32768.0f, 0.0f), 65535.0f));
  }

  state_out[ln] = u;
  if (!PAPER_LAW) state_out[kVPrev * LN + ln] = v_prev;
  if (HAS_CACHE) state_out[kRes * LN + ln] = resident;
  const float out[9] = {us, us_c, cs, cs_c, c2, mx, n_r0, n_viol, last_bad};
#pragma unroll
  for (int i = 0; i < 9; ++i) state_out[(kAcc + i) * LN + ln] = out[i];
  if (HAS_CACHE) {
    state_out[(kCacheAcc + 0) * LN + ln] = hs;
    state_out[(kCacheAcc + 1) * LN + ln] = hs_c;
    state_out[(kCacheAcc + 2) * LN + ln] = es;
    state_out[(kCacheAcc + 3) * LN + ln] = es_c;
    state_out[(kCacheAcc + 4) * LN + ln] = ts;
    state_out[(kCacheAcc + 5) * LN + ln] = ts_c;
  }
}

template <bool PAPER_LAW, bool UNIT_OCC, bool HAS_CACHE, bool BF16>
void launch(dim3 grid, cudaStream_t stream, const void* demand,
            const float* lp, const float* np_rows, const float* alive,
            const float* state_in, float* state_out, uint16_t* codes, int T,
            int L, int N, int t0, const SweepConsts& c) {
  sweep_kernel<PAPER_LAW, UNIT_OCC, HAS_CACHE, BF16>
      <<<grid, kBlock, 0, stream>>>(demand, lp, np_rows, alive, state_in,
                                    state_out, codes, T, L, N, t0, c);
}

template <bool PAPER_LAW, bool UNIT_OCC, bool HAS_CACHE>
void launch_dtype(bool bf16, dim3 grid, cudaStream_t stream,
                  const void* demand, const float* lp, const float* np_rows,
                  const float* alive, const float* state_in, float* state_out,
                  uint16_t* codes, int T, int L, int N, int t0,
                  const SweepConsts& c) {
  if (bf16) {
    launch<PAPER_LAW, UNIT_OCC, HAS_CACHE, true>(
        grid, stream, demand, lp, np_rows, alive, state_in, state_out, codes,
        T, L, N, t0, c);
  } else {
    launch<PAPER_LAW, UNIT_OCC, HAS_CACHE, false>(
        grid, stream, demand, lp, np_rows, alive, state_in, state_out, codes,
        T, L, N, t0, c);
  }
}

}  // namespace

// Launches one segment on `stream`; returns cudaGetLastError() after
// the launch (0 on success).  A cache segment always runs with unit
// occupancy (the resident set replaces the occupancy model).
extern "C" int dynims_sweep_segment(int paper_law, int unit_occupancy,
                                    int has_cache, int bf16,
                                    const void* demand, const float* lp,
                                    const float* np_rows, const float* alive,
                                    const float* state_in, float* state_out,
                                    uint16_t* codes, int T, int L, int N,
                                    int t0, const SweepConsts* consts,
                                    void* stream) {
  if (T <= 0 || L <= 0 || N <= 0) return 0;
  const dim3 grid((N + kBlock - 1) / kBlock, L);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const SweepConsts& c = *consts;
#define DYNIMS_ARGS bf16 != 0, grid, s, demand, lp, np_rows, alive, state_in, \
                    state_out, codes, T, L, N, t0, c
  if (has_cache) {
    if (paper_law) {
      launch_dtype<true, true, true>(DYNIMS_ARGS);
    } else {
      launch_dtype<false, true, true>(DYNIMS_ARGS);
    }
  } else if (paper_law) {
    if (unit_occupancy) {
      launch_dtype<true, true, false>(DYNIMS_ARGS);
    } else {
      launch_dtype<true, false, false>(DYNIMS_ARGS);
    }
  } else if (unit_occupancy) {
    launch_dtype<false, true, false>(DYNIMS_ARGS);
  } else {
    launch_dtype<false, false, false>(DYNIMS_ARGS);
  }
#undef DYNIMS_ARGS
  return static_cast<int>(cudaGetLastError());
}
