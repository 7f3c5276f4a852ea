"""Workload models calibrated to the paper's measurements.

A numpy-only copy of ``repro/core/traces.py``: the port keeps its own
copy so that it imports nothing of the JAX package, and
``tests/test_torch_port_rules.py`` holds the traces both build equal
byte for byte.

Two empirical facts ground DynIMS (Sec. II):

* **Fig. 1** -- HPCC's per-node memory usage over time: long low-usage
  phases (~5-35 GB) punctuated by bursts peaking ~75 GB (HPL/PTRANS),
  with >=40 GB unused most of the time.  :func:`hpcc_trace` generates a
  phase-structured trace with those statistics.
* **Fig. 2** -- HPL throughput vs system memory utilization: flat until
  ~95%, collapsing near 100%, catastrophic once swapping.
  :func:`hpl_slowdown` is that response curve; the simulator uses it to
  price un-relieved memory pressure.

Both are deterministic given a seed, so every experiment is replayable.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

GiB = float(2**30)


@dataclass(frozen=True)
class Phase:
    """One HPCC sub-benchmark phase."""

    name: str
    duration_s: float
    base_gib: float          # plateau usage
    peak_gib: float          # burst peak (== base for flat phases)
    burst_frac: float = 0.0  # fraction of the phase spent at/near peak


# Phase structure shaped after Fig. 1: usage plateaus with two big bursts
# (HPL and PTRANS regions) peaking near 75 GB; >=40 GB unused most of the
# run.  Durations are relative weights, scaled by ``duration_s``.
HPCC_PHASES: Tuple[Phase, ...] = (
    Phase("startup",      0.05,  5.0,  5.0),
    Phase("hpl",          0.30, 20.0, 75.0, burst_frac=0.45),
    Phase("dgemm",        0.10, 18.0, 30.0, burst_frac=0.30),
    Phase("stream",       0.10, 28.0, 32.0, burst_frac=0.50),
    Phase("ptrans",       0.15, 25.0, 73.0, burst_frac=0.35),
    Phase("randomaccess", 0.10, 15.0, 22.0, burst_frac=0.30),
    Phase("fft",          0.12, 20.0, 42.0, burst_frac=0.35),
    Phase("network",      0.08,  8.0, 10.0),
)


def hpcc_trace(
    duration_s: float = 600.0,
    interval_s: float = 0.1,
    seed: int = 0,
    noise_gib: float = 0.5,
    phases: Sequence[Phase] = HPCC_PHASES,
) -> np.ndarray:
    """Per-interval compute-tenant memory usage (bytes), Fig.-1-shaped.

    Bursts ramp up over ~2 s (the paper's motivation for sub-second
    control response: usage can climb tens of GB in seconds).
    """
    rng = np.random.default_rng(seed)
    n = int(round(duration_s / interval_s))
    total_weight = sum(p.duration_s for p in phases)
    out = np.empty(n, dtype=np.float64)
    i = 0
    for phase in phases:
        steps = max(int(round(n * phase.duration_s / total_weight)), 1)
        steps = min(steps, n - i)
        if steps <= 0:
            break
        seg = np.full(steps, phase.base_gib)
        if phase.peak_gib > phase.base_gib and phase.burst_frac > 0:
            burst_len = max(int(steps * phase.burst_frac), 1)
            start = (steps - burst_len) // 2
            ramp = max(int(2.0 / interval_s), 1)          # ~2 s ramp
            ramp = min(ramp, max(burst_len // 2, 1))
            prof = np.full(burst_len, phase.peak_gib)
            prof[:ramp] = np.linspace(phase.base_gib, phase.peak_gib, ramp)
            prof[-ramp:] = np.linspace(phase.peak_gib, phase.base_gib, ramp)
            seg[start:start + burst_len] = prof[: steps - start]
        out[i:i + steps] = seg
        i += steps
    if i < n:
        out[i:] = phases[-1].base_gib
    out += rng.normal(0.0, noise_gib, size=n)
    peak = max(p.peak_gib for p in phases)
    return np.clip(out, 1.0, peak) * GiB


def constant_trace(duration_s: float, interval_s: float,
                   usage_gib: float) -> np.ndarray:
    n = int(round(duration_s / interval_s))
    return np.full(n, usage_gib * GiB)


def fleet_demand_traces(
    n_nodes: int,
    n_intervals: int,
    interval_s: float = 0.1,
    seed: int = 0,
    amp_range: Tuple[float, float] = (0.8, 1.2),
    phase_shift: bool = True,
    base: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Batched multi-node demand: ``(n_nodes, n_intervals)`` in bytes.

    Every node replays the same base trace (Fig.-1-shaped HPCC by
    default) phase-shifted by a random offset and amplitude-jittered
    within ``amp_range`` -- the fleet-scale workload model
    :func:`~repro.core.cluster_sim.simulate_fleet` and the ScenarioLab
    sweep engine share.  Deterministic given ``seed``; the RNG draw
    order (base trace, then shifts, then amplitudes) is part of the
    contract so both consumers see identical fleets.
    """
    rng = np.random.default_rng(seed)
    if base is None:
        base = hpcc_trace(float(n_intervals) * interval_s, interval_s,
                          seed=seed)
    base = np.asarray(base, dtype=np.float64)
    if phase_shift:
        shifts = rng.integers(0, len(base), size=n_nodes)
    else:
        shifts = np.zeros(n_nodes, dtype=np.int64)
    amp = rng.uniform(amp_range[0], amp_range[1], size=n_nodes)
    demand = np.stack([np.roll(base, s) * a for s, a in zip(shifts, amp)])
    if demand.shape[1] < n_intervals:
        reps = -(-n_intervals // demand.shape[1])
        demand = np.tile(demand, (1, reps))
    return demand[:, :n_intervals]


def bursty_trace(
    n_intervals: int,
    interval_s: float = 0.1,
    base_gib: float = 40.0,
    burst_gib: float = 40.0,
    burst_every_s: float = 20.0,
    burst_len_s: float = 2.0,
    ramp_s: float = 0.5,
    noise_gib: float = 0.5,
    seed: int = 0,
) -> np.ndarray:
    """Periodic load spikes over a plateau (bytes).

    Models bursty serving pressure (KV-cache admission waves): every
    ``burst_every_s`` the demand ramps from ``base_gib`` up to
    ``base_gib + burst_gib`` over ``ramp_s`` seconds, holds for
    ``burst_len_s``, and ramps back down.
    """
    rng = np.random.default_rng(seed)
    out = np.full(n_intervals, base_gib, dtype=np.float64)
    period = max(int(round(burst_every_s / interval_s)), 1)
    blen = max(int(round(burst_len_s / interval_s)), 1)
    ramp = max(int(round(ramp_s / interval_s)), 1)
    for start in range(period // 2, n_intervals, period):
        up = np.linspace(base_gib, base_gib + burst_gib, ramp)
        hold = np.full(blen, base_gib + burst_gib)
        down = np.linspace(base_gib + burst_gib, base_gib, ramp)
        prof = np.concatenate([up, hold, down])
        end = min(start + len(prof), n_intervals)
        out[start:end] = prof[: end - start]
    out += rng.normal(0.0, noise_gib, size=n_intervals)
    return np.clip(out, 0.5, None) * GiB


def hpl_slowdown(utilization: float, swap_frac: float = 0.0) -> float:
    """Relative HPL execution-time multiplier at a memory utilization.

    Fig. 2 digitized: performance is flat to ~92%, loses ~25% by 98%,
    collapses approaching 100%, and degrades by an order of magnitude
    once swap is engaged (the paper controls swap at 0.5% / 1% of RAM
    and observes severe drops).

    Returns a multiplier >= 1 on execution time (1 == full speed).
    """
    u = float(np.clip(utilization, 0.0, 1.5))
    if u <= 0.92:
        slowdown = 1.0
    elif u <= 0.98:
        slowdown = 1.0 + (u - 0.92) / 0.06 * 0.35          # -> 1.35x @ 98%
    elif u <= 1.0:
        slowdown = 1.35 + (u - 0.98) / 0.02 * 2.65         # -> 4x @ 100%
    else:
        slowdown = 4.0 + (u - 1.0) * 300.0                 # deep swap
    if swap_frac > 0.0:
        slowdown *= 1.0 + 12.0 * min(swap_frac / 0.01, 4.0)
    return float(slowdown)


@dataclass(frozen=True)
class IterativeAppSpec:
    """A Spark-like iterative analytics job (K-means & friends, Sec. IV).

    The app makes ``iterations`` passes over ``dataset_gib`` of input
    split into ``block_gib`` blocks, with ``compute_s_per_gib`` of CPU
    work per block per pass.  Reads hit one of three tiers (Fig. 5's
    analysis): compute-node cache, data-node OS buffer cache, or disk.
    """

    name: str = "kmeans"
    dataset_gib: float = 320.0
    block_gib: float = 1.0
    iterations: int = 10
    compute_s_per_gib: float = 0.55

    @property
    def n_blocks(self) -> int:
        return int(round(self.dataset_gib / self.block_gib))


@dataclass(frozen=True)
class TierSpec:
    """Read bandwidths of the three storage tiers (paper Table II era).

    Values are effective per-node GiB/s: local RAM copy, 10 GbE remote
    buffer-cache read, and remote 7200rpm-RAID disk read (incl. network).
    """

    local_mem_gibps: float = 6.0
    remote_cache_gibps: float = 1.05     # 10 GbE wire ~ 1.16 GiB/s raw
    remote_disk_gibps: float = 0.35

    def read_time_s(self, gib: float, tier: str) -> float:
        bw = {
            "local": self.local_mem_gibps,
            "remote_cache": self.remote_cache_gibps,
            "disk": self.remote_disk_gibps,
        }[tier]
        return gib / bw


# Spark-level RDD-cache penalty (Sec. IV.B): deserialized SequenceFile
# objects are larger than their on-disk bytes, so a Spark-RDD cache of
# equal capacity holds fewer input blocks.  Fig. 5 reports 1.3x.
RDD_DESERIALIZATION_BLOAT = 1.9
