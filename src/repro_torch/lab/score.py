"""Scoring: streamed fleet-stability metrics and gain objectives.

Counterpart of ``repro/lab/score.py`` on torch tensors.  The sweep
engine never materializes a closed-loop history: per-node accumulators
stream through the step (:func:`kahan_add`), utilization is quantized
to ``uint16`` codes on a 65536-bin grid (:func:`utilization_codes`), and
each gain lane counts its codes in a histogram of ``code >> 4``
(:func:`hist_add`; the sweep kernel keeps it in shared memory), out of
which :func:`quantile_from_hist` reads the p99 bisection's bracket with
one prefix sum.  :func:`quantile_from_codes`, the bisection over the
codes themselves, is what the histogram is held to.
:func:`finalize_fleet_stats` folds the accumulators into
:class:`FleetStats`; here it folds the last (node) axis, so one call
finalizes every gain lane at once where the JAX package vmaps over
lanes.

The objectives (:func:`default_score`, :func:`runtime_score`,
:func:`makespan_score`) take numpy or torch fields and compute in
float32, as ``jnp.asarray`` does with x64 off: an f64 ranking would
break near-ties differently from the reference.

Every division by a scalar here divides by a float32 tensor on the
operand's device.  A Python scalar divisor would take CUDA's shortcut
(multiply by the reciprocal), which rounds differently from the
reference's true division.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..core.control import f32, fma
from ..core.traces import GiB

Array = Union[np.ndarray, torch.Tensor]

# A few thousandths over r0 is measurement noise, not pressure.
OVER_R0_EPS = 1e-3
# Settle band: the fleet has settled once its max utilization stays
# within this margin above r0.
SETTLE_TOL = 0.02

# Streaming-quantile fixed-bin grid: uint16 codes over [0, 2).
QUANT_BINS = 65536
QUANT_RANGE: Tuple[float, float] = (0.0, 2.0)
_QUANT_SCALE = QUANT_BINS / (QUANT_RANGE[1] - QUANT_RANGE[0])

# Bisection depth of the streaming quantile: 12 levels resolve the
# 2^16-bin code space to a 16-bin bracket (~5e-4 utilization worst
# case); 16 recovers the exact (quantized) order statistic.
QUANT_LEVELS = 12

# The per-lane histogram counts code >> HIST_SHIFT: 4096 bins of 16
# codes, the bracket the 12-level bisection ends on.
HIST_SHIFT = 4
HIST_BINS = QUANT_BINS >> HIST_SHIFT


class FleetStats(NamedTuple):
    """Per-gain stability metrics; each field is scalar or ``(G,)``.

    The same fields, in the same order, as the JAX package's
    ``FleetStats``; with cache modeling off the CacheLoop fields hold
    their neutral values, and ``makespan`` is the ideal horizon.
    """

    mean_utilization: Array
    p99_utilization: Array
    max_utilization: Array
    frac_intervals_over_r0: Array    # share of (t, n) samples with r > r0
    max_over_r0: Array               # worst excursion above r0
    pressure_violation_rate: Array   # share of (t, n) samples with r > 1
    mean_capacity_gib: Array
    capacity_std_gib: Array
    granted_volume_gib_s: Array      # integral of the storage grant
    settle_intervals: Array          # first t after which max util <= r0+tol
    hit_ratio: Array                 # fleet cache hits / accesses (bytes)
    evicted_bytes: Array             # controller-forced eviction flux
    app_runtime: Array               # modeled app runtime, s (fleet barrier)
    app_slowdown: Array              # app_runtime / ideal horizon wall-clock
    makespan: Array                  # AppGraph end-to-end makespan, s


def kahan_add(total: torch.Tensor, comp: torch.Tensor,
              x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One compensated-summation step: ``total + x`` carrying ``comp``."""
    y = x - comp
    t = total + y
    return t, (t - total) - y


def hpl_slowdown_curve(utilization: torch.Tensor) -> torch.Tensor:
    """Fig.-2 execution-time multiplier, elementwise.

    Flat to 92% utilization, ~1.35x at 98%, 4x at 100%, then the
    deep-swap cliff -- the reference's nested ``where`` with its
    float32 constants and true divisions.
    """
    u = torch.as_tensor(utilization, dtype=torch.float32)
    dev = u.device
    u = torch.minimum(torch.maximum(u, f32(0.0, dev)), f32(1.5, dev))
    one = f32(1.0, dev)
    seg1 = one + (u - f32(0.92, dev)) / f32(0.06, dev) * f32(0.35, dev)
    seg2 = (f32(1.35, dev)
            + (u - f32(0.98, dev)) / f32(0.02, dev) * f32(2.65, dev))
    seg3 = f32(4.0, dev) + (u - one) * f32(300.0, dev)
    return torch.where(
        u <= f32(0.92, dev), one,
        torch.where(u <= f32(0.98, dev), seg1,
                    torch.where(u <= one, seg2, seg3)))


def utilization_codes(utils: torch.Tensor) -> torch.Tensor:
    """Quantize utilization ratios onto the fixed streaming-bin grid.

    The float-to-``uint16`` cast truncates, as ``astype(uint16)`` does.
    """
    idx = torch.as_tensor(utils, dtype=torch.float32) * _QUANT_SCALE
    return idx.clamp(0, QUANT_BINS - 1).to(torch.uint16)


def quantile_from_codes(codes: torch.Tensor, q: float, n_total: int,
                        levels: int = QUANT_LEVELS,
                        lane_dim: Optional[int] = None) -> torch.Tensor:
    """Quantile of the implicit fixed-bin histogram behind ``codes``.

    Bisects the 2^16 code space with ``levels`` count reductions and
    returns the dequantized midpoint of the final bracket around the
    order statistic at ``floor(q * (n_total - 1))``.  With
    ``lane_dim`` set, every index along that axis is one gain lane with
    its own bracket (the result has that axis' length); otherwise the
    whole array is one histogram (a 0-d result).

    The codes are widened to int32 once before the bisection: ``uint16``
    has no ``<=`` kernel in PyTorch.
    """
    target = int(np.floor(q * (n_total - 1)))
    dev = codes.device
    wide = codes.to(torch.int32)
    # mid broadcasts along the lane axis; the count folds every other.
    shape = [1] * wide.ndim
    dims = tuple(range(wide.ndim))
    n_lanes = 1
    if lane_dim is not None:
        n_lanes = shape[lane_dim] = codes.shape[lane_dim]
        dims = tuple(d for d in dims if d != lane_dim % wide.ndim)
    lo = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
    hi = torch.full((n_lanes,), QUANT_BINS - 1, dtype=torch.int32,
                    device=dev)
    for _ in range(min(levels, 16)):
        mid = (lo + hi) >> 1
        count = (wide <= mid.view(shape)).sum(dim=dims).reshape(n_lanes)
        go_left = count > target
        lo, hi = torch.where(go_left, lo, mid + 1), torch.where(go_left,
                                                                 mid, hi)
    mid_code = (lo.float() + hi.float() + f32(1.0, dev)) * f32(0.5, dev)
    out = f32(QUANT_RANGE[0], dev) + mid_code / f32(_QUANT_SCALE, dev)
    return out[0] if lane_dim is None else out


def hist_add(hist: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Count ``codes >> HIST_SHIFT`` into ``hist`` in place; returns it.

    ``hist`` is (L, HIST_BINS) int32 and ``codes`` (L, ...) ``uint16``:
    row ``l`` of ``hist`` counts every code of lane ``l``.
    """
    idx = codes.reshape(codes.shape[0], -1).to(torch.int64) >> HIST_SHIFT
    return hist.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.int32))


def quantile_from_hist(hist: torch.Tensor, q: float, n_total: int,
                       levels: int = QUANT_LEVELS) -> torch.Tensor:
    """:func:`quantile_from_codes` per lane, from code histograms.

    ``hist`` is (L, HIST_BINS) (or one (HIST_BINS,) row, for a 0-d
    result) with ``n_total`` counts per lane.  It returns the bracket of
    the same bisection, bit for bit: for ``levels <= 12`` every
    threshold ``mid`` the bisection tests is 15 mod 16, so
    ``count(code <= mid)`` is the prefix sum of the bins up to ``mid >>
    HIST_SHIFT``, and the bisection goes left exactly when the first bin
    whose prefix sum passes the target lies at or left of that bin.  So
    its final bracket is the aligned block of ``2**(16 - levels)`` codes
    holding that bin, which one prefix sum and one count find, without
    the 12 dependent steps.  Deeper bisections need the codes
    themselves.
    """
    if not 0 <= levels <= 12:
        raise ValueError(f"a histogram of {HIST_BINS} bins resolves 0 to "
                         f"12 bisection levels; got levels={levels}")
    target = int(np.floor(q * (n_total - 1)))
    rows = hist.reshape(-1, HIST_BINS)
    # the first bin whose prefix count passes the target (the last bin
    # when none does, where the bisection also ends)
    first = (rows.cumsum(dim=1) <= target).sum(dim=1).clamp_max(HIST_BINS - 1)
    # The bracket [lo, lo + 2**shift - 1] has its midpoint at code
    # lo + 2**(shift - 1) (shift >= 4): an integer below 2**16, exact in
    # float32 and scaled by a power of two, so this is the value
    # quantile_from_codes computes, bit for bit.
    shift = 16 - levels
    mid = ((first >> (12 - levels)) << shift) + (1 << (shift - 1))
    out = QUANT_RANGE[0] + mid.to(torch.float32) * (1.0 / _QUANT_SCALE)
    return out[0] if hist.ndim == 1 else out


def _fold(x: torch.Tensor) -> torch.Tensor:
    """Sum over the node axis in float64, rounded once to float32."""
    return x.sum(-1, dtype=torch.float64).to(torch.float32)


def finalize_fleet_stats(
    *,
    util_sum: torch.Tensor,          # (..., N) Kahan sum of r over T
    util_max: torch.Tensor,          # (..., N) running max of r
    caps_sum_gib: torch.Tensor,      # (..., N) Kahan sum of u / GiB
    caps_sumsq_gib: torch.Tensor,    # (..., N) sum of (u / GiB)^2
    over_r0_count: torch.Tensor,     # (..., N) count of r > r0 + OVER_R0_EPS
    violation_count: torch.Tensor,   # (..., N) count of r > 1
    last_bad: torch.Tensor,          # (..., N) last t with r > r0 + SETTLE_TOL
    p99_utilization: torch.Tensor,   # (...) from quantile_from_hist
    r0: torch.Tensor,                # (...)
    n_intervals: int,
    interval_s: float,
    hits_gib: Optional[torch.Tensor] = None,     # (..., N) hit GiB
    evicted_gib: Optional[torch.Tensor] = None,  # (..., N) evicted GiB
    app_time_s: Optional[torch.Tensor] = None,   # (..., N) modeled app time
    accesses_gib: Optional[float] = None,        # per-node access total
    work_done_gib: Optional[torch.Tensor] = None,  # (..., N) AppGraph wd
    total_work_gib: Optional[float] = None,      # the DAG's work, fleet
    t_done: Optional[torch.Tensor] = None,       # (...) finish interval
) -> FleetStats:
    """Assemble :class:`FleetStats` from streamed per-node accumulators.

    Reduces the last (node) axis; leading axes (the gain lanes) are
    kept.  The metric definitions match the reference's.  The node
    sums run in float64 and round once to float32, so the card and the
    CPU fold identical accumulators to identical stats whatever order
    their reductions take (the reference's float32 fold differs from
    either by about an ulp).
    ``app_runtime`` is the slowest node's modeled time (the fleet
    synchronizes on a barrier).  ``makespan`` is the AppGraph's end to
    end wall clock: ``t_done * interval_s`` once the DAG finished, else
    the work-linear extrapolation ``max(horizon * total / max(done,
    1e-6), horizon)`` (the node sum of ``work_done_gib`` folded in
    float64 as the other fields are); without a graph it is the neutral
    ideal horizon.
    """
    dev = util_sum.device
    t = n_intervals
    n = util_sum.shape[-1]
    samples = f32(t * n, dev)
    summed = [util_sum, caps_sum_gib, caps_sumsq_gib, over_r0_count,
              violation_count]
    if app_time_s is not None:
        summed += [hits_gib, evicted_gib]
    # every node sum in one fold, and the five means in one division:
    # the sweep's finalize is host-bound, so each operation saved counts
    totals = _fold(torch.stack(summed))
    caps_total = totals[1]
    util_mean, caps_mean, caps_sq_mean, over_frac, viol_rate = \
        (totals[:5] / samples).unbind(0)
    caps_var = torch.clamp_min(fma(-caps_mean, caps_mean, caps_sq_mean),
                               0.0)
    max_util = util_max.amax(-1)
    ideal_s = t * interval_s
    lanes = max_util.shape
    if app_time_s is None:
        hit_ratio = torch.ones(lanes, dtype=torch.float32, device=dev)
        evicted_bytes = torch.zeros(lanes, dtype=torch.float32, device=dev)
        app_runtime = torch.full(lanes, ideal_s, dtype=torch.float32,
                                 device=dev)
    else:
        hits_total, evicted_total = totals[5:].unbind(0)
        hit_ratio = hits_total / f32(n * accesses_gib, dev)
        # a float32 product with a scalar rounds as with a 0-d tensor
        evicted_bytes = evicted_total * float(np.float32(GiB))
        app_runtime = app_time_s.amax(-1)
    return FleetStats(
        mean_utilization=util_mean,
        p99_utilization=p99_utilization,
        max_utilization=max_util,
        frac_intervals_over_r0=over_frac,
        max_over_r0=torch.clamp_min(max_util - r0, 0.0),
        pressure_violation_rate=viol_rate,
        mean_capacity_gib=caps_mean,
        capacity_std_gib=torch.sqrt(caps_var),
        granted_volume_gib_s=(caps_total / f32(n, dev)
                              * float(np.float32(interval_s))),
        settle_intervals=(last_bad.amax(-1) + 1).to(torch.int32),
        hit_ratio=hit_ratio,
        evicted_bytes=evicted_bytes,
        app_runtime=app_runtime,
        app_slowdown=app_runtime / f32(ideal_s, dev),
        makespan=_makespan(t_done, work_done_gib, total_work_gib, t,
                           interval_s, lanes, dev),
    )


def _makespan(t_done, work_done_gib, total_work_gib, n_intervals,
              interval_s, lanes, dev) -> torch.Tensor:
    """``FleetStats.makespan``: the reference's float32 arithmetic."""
    if t_done is None:
        return torch.full(lanes, n_intervals * interval_s,
                          dtype=torch.float32, device=dev)
    iv = f32(interval_s, dev)
    horizon = f32(n_intervals, dev) * iv
    done = torch.clamp_min(_fold(work_done_gib), 1e-6)
    extrapolated = torch.maximum(horizon * f32(total_work_gib, dev) / done,
                                 horizon)
    return torch.where(t_done >= 0, t_done * iv, extrapolated)


# GiB-equivalents one full unit of modeled app slowdown costs in
# default_score.
RUNTIME_WEIGHT = 50.0


def _field(x: Array) -> torch.Tensor:
    """One stats field as float32 torch, on its own device."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32))


def default_score(stats: FleetStats) -> torch.Tensor:
    """Storage yield minus pressure penalties; higher is better.

    Units are GiB of mean granted capacity; violations dominate, time
    above ``r0`` and slow settling cost less, and the app-runtime term
    is zero whenever cache modeling is off.
    """
    cap = _field(stats.mean_capacity_gib)
    dev = cap.device
    return (cap
            - f32(200.0, dev) * _field(stats.frac_intervals_over_r0)
            - f32(2000.0, dev) * _field(stats.pressure_violation_rate)
            - f32(100.0, dev) * _field(stats.max_over_r0)
            - f32(0.01, dev) * _field(stats.settle_intervals)
            - f32(RUNTIME_WEIGHT, dev) * (_field(stats.app_slowdown)
                                          - f32(1.0, dev)))


def runtime_score(stats: FleetStats) -> torch.Tensor:
    """Negated modeled slowdown of the fleet's straggler node."""
    return -_field(stats.app_slowdown)


def makespan_score(stats: FleetStats) -> torch.Tensor:
    """Negated AppGraph end-to-end makespan; higher is better."""
    return -_field(stats.makespan)


def stats_mismatches(a: FleetStats, b: FleetStats, *, n_samples: int,
                     rtol: float = 1e-4, rtol_p99: float = 5e-4,
                     rtol_moment: float = 1e-5) -> List[str]:
    """Fields where two sweeps of the same lanes disagree (empty: agree).

    The brackets the port is held to, against the JAX package and
    between the card and the CPU, which round products and sums in
    other places (multiply-add contraction, reduction order):

    * every field at ``rtol`` (atol 1e-12);
    * ``p99_utilization`` at ``rtol_p99``, the estimator's bracket;
    * the two rate fields also at atol ``1 / n_samples``: one sample
      (of T x N) can sit on a threshold and flip;
    * ``capacity_std_gib`` through the second moment it is computed
      from: ``std**2 + mean**2`` at ``rtol_moment``.  The std is the
      square root of ``E[x^2] - E[x]^2``, which cancels when a lane's
      grant barely moves, so a few ulps in ``E[x^2]`` can move it by
      tens of percent in any float32 implementation.
    """
    def arr(x):
        return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x,
                          np.float64)

    out = []
    for name in FleetStats._fields:
        x, y = arr(getattr(a, name)), arr(getattr(b, name))
        if x.shape != y.shape:
            out.append(f"{name}: shape {x.shape} != {y.shape}")
            continue
        if name == "capacity_std_gib":
            mx, my = arr(a.mean_capacity_gib), arr(b.mean_capacity_gib)
            x, y, tol, atol = x * x + mx * mx, y * y + my * my, \
                rtol_moment, 1e-12
        elif name == "p99_utilization":
            tol, atol = rtol_p99, 1e-12
        elif name in ("frac_intervals_over_r0", "pressure_violation_rate"):
            tol, atol = rtol, 1.0 / n_samples
        else:
            tol, atol = rtol, 1e-12
        bad = ~np.isclose(x, y, rtol=tol, atol=atol)
        if bad.any():
            i = int(np.flatnonzero(bad)[0])
            out.append(f"{name}: {int(bad.sum())} lane(s) differ, first "
                       f"[{i}] {x.flat[i]!r} vs {y.flat[i]!r}")
    return out


def stats_to_dict(stats: FleetStats,
                  index: Optional[int] = None) -> Dict[str, float]:
    """One gain point's stats as a plain-float dict (JSON-friendly)."""
    out = {}
    for name, value in stats._asdict().items():
        arr = np.asarray(value.cpu() if isinstance(value, torch.Tensor)
                         else value)
        out[name] = float(arr if arr.ndim == 0 else arr[index])
    return out
