"""Declarative closed-loop scenarios for the ScenarioLab sweep engine.

A numpy-only copy of ``repro/lab/scenarios.py``, so that the port
imports nothing of the JAX package.  It leaves out the
``runtime-churn`` registration, whose demand comes from the runtime's
fault machinery (ROADMAP A1).

A :class:`ScenarioSpec` names everything the sweep engine needs to
compile a fleet's compute-tenant demand into a dense ``(N, T)`` array:
the trace family, fleet size, per-node heterogeneity (amplitude /
phase / total-memory jitter), and burst / failure injection.  Specs are
frozen dataclasses, so a scenario is a value: hashable, replayable
(deterministic given ``seed``), and cheap to :meth:`~ScenarioSpec.replace`
into variants.

The registry ships the paper's four Sec. IV.A configurations expressed
as demand scenarios plus beyond-paper stress shapes (bursty serving
pressure, heterogeneous fleets, swap storms, phase-shifted replay).
``register_scenario`` admits new ones; ``get_scenario`` accepts either
a name or a spec everywhere the lab takes a scenario.

**ReplayLoop**: the ``"replay"`` family closes the loop with live
deployments.  :meth:`ScenarioSpec.from_capture` turns a
:class:`~repro_torch.core.plane.CapturedTrace` (what a running ``MemoryPlane``
observed) into a scenario that carries the raw demand for *exact*
replay through the sweep engine -- interpolated to any horizon,
padded/tiled to any fleet size using the capture's fitted
amplitude/phase/heterogeneity statistics -- plus a fitted
:class:`CacheSpec` whenever cache residency was observed.  Every
captured workload is thereby a new sweepable scenario.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from ..core.eviction import POLICY_MODELS
from ..core.traces import (GiB, bursty_trace, constant_trace,
                           fleet_demand_traces, hpcc_trace)
from .appgraph import AppGraphSpec, StageSpec, compile_graph

TRACE_FAMILIES = ("hpcc", "constant", "bursty", "replay")


class ReplayTrace:
    """Immutable captured-demand payload carried by ``"replay"`` specs.

    Wraps the raw per-node demand (bytes, ``(N, T)``) and per-node
    total memory (``(N,)``) of a capture so a :class:`ScenarioSpec`
    stays a hashable value: equality and hash go through a content
    digest, and the arrays are frozen read-only.
    """

    __slots__ = ("demand", "node_memory", "interval_s", "_digest")

    def __init__(self, demand: np.ndarray, node_memory: np.ndarray,
                 interval_s: float = 0.1):
        demand = np.ascontiguousarray(demand, dtype=np.float64)
        if demand.ndim != 2 or demand.size == 0:
            raise ValueError("demand must be a non-empty (N, T) array")
        node_memory = np.ascontiguousarray(
            np.broadcast_to(np.asarray(node_memory, np.float64),
                            (demand.shape[0],)))
        if (node_memory <= 0).any():
            raise ValueError("node_memory must be positive")
        demand.setflags(write=False)
        node_memory.setflags(write=False)
        object.__setattr__(self, "demand", demand)
        object.__setattr__(self, "node_memory", node_memory)
        object.__setattr__(self, "interval_s", float(interval_s))
        object.__setattr__(self, "_digest", hash(
            (demand.shape, float(interval_s), demand.tobytes(),
             node_memory.tobytes())))

    def __setattr__(self, name, value):          # pragma: no cover - guard
        raise AttributeError("ReplayTrace is immutable")

    @property
    def n_nodes(self) -> int:
        return self.demand.shape[0]

    @property
    def n_intervals(self) -> int:
        return self.demand.shape[1]

    def __hash__(self) -> int:
        return self._digest

    def __eq__(self, other) -> bool:
        return (isinstance(other, ReplayTrace)
                and self._digest == other._digest
                and self.interval_s == other.interval_s
                and np.array_equal(self.demand, other.demand)
                and np.array_equal(self.node_memory, other.node_memory))

    def __repr__(self) -> str:
        return (f"ReplayTrace(n_nodes={self.n_nodes}, "
                f"n_intervals={self.n_intervals}, "
                f"interval_s={self.interval_s})")


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """CacheLoop workload knobs: the storage tenant's cache dynamics.

    Attached to a :class:`ScenarioSpec` this turns the sweep engine's
    saturated-store model into a per-node cache simulation carried
    through the scan: a resident set bounded by the controller's grant,
    an analytic reuse-distance hit curve (see
    :class:`~repro_torch.core.eviction.PolicyModel`), eviction flux when the
    grant shrinks, read-through refill when misses are admitted back,
    and a penalty model converting misses + evictions + memory pressure
    into modeled app runtime.  ``None`` (the default) keeps the
    paper-faithful saturated store and its specialized fast path.

    Fields:
      policy:        eviction policy whose analytic model shapes the
                     hit curve (``lfu`` -- the paper's Alluxio setup --
                     ``lru``, ``fifo``, ``adaptive``).
      reuse_skew:    Zipf exponent alpha of block popularity in [0, 1);
                     0 = uniform / cyclic-scan reuse, ->1 = hot-spot.
      working_set_frac: app working set as a fraction of per-node total
                     memory (Sec. IV: 100-200 GB datasets on 125 GB
                     nodes -> per-node fractions around 0.2-0.5).
      access_gibps:  per-node rate at which the app reads its working
                     set (block scans per wall second).
      refill_gibps:  read-through admission bandwidth -- how fast
                     misses can repopulate a grown grant (remote-tier
                     read bandwidth in the paper's testbed).
      miss_penalty_s_per_gib: extra modeled seconds per GiB served
                     remotely instead of from the local cache (~1/remote
                     read bandwidth; Table-II-era default).
      evict_penalty_s_per_gib: churn cost per evicted GiB (invalidation
                     and re-registration overhead; small).
      warm_frac:     fraction of the initial grant resident at t=0
                     (0 = cold start, matching ``cluster_sim``).
    """

    policy: str = "lfu"
    reuse_skew: float = 0.6
    working_set_frac: float = 0.5
    access_gibps: float = 2.0
    refill_gibps: float = 1.05
    miss_penalty_s_per_gib: float = 0.95
    evict_penalty_s_per_gib: float = 0.05
    warm_frac: float = 0.0

    def __post_init__(self) -> None:
        if self.policy not in POLICY_MODELS:
            raise ValueError(f"policy must be one of "
                             f"{sorted(POLICY_MODELS)}")
        if not (0.0 <= self.reuse_skew < 1.0):
            raise ValueError("reuse_skew must be in [0, 1)")
        if self.working_set_frac <= 0.0:
            raise ValueError("working_set_frac must be positive")
        if self.access_gibps <= 0.0 or self.refill_gibps <= 0.0:
            raise ValueError("access_gibps and refill_gibps must be "
                             "positive")
        if (self.miss_penalty_s_per_gib < 0.0
                or self.evict_penalty_s_per_gib < 0.0):
            raise ValueError("penalties must be non-negative")
        if not (0.0 <= self.warm_frac <= 1.0):
            raise ValueError("warm_frac must be in [0, 1]")

    def replace(self, **kw) -> "CacheSpec":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One closed-loop experiment, declared as data.

    Demand is the compute tenant's memory usage; the sweep engine adds
    the (saturated) storage grant on top when it closes the loop.  All
    ``*_gib`` fields are GiB; compiled traces are bytes.

    Fields:
      family:          base trace shape -- ``hpcc`` (Fig.-1 replay),
                       ``constant``, or ``bursty`` (periodic spikes).
      n_nodes / n_intervals / interval_s: fleet size and horizon.
      node_memory_gib: per-node budget M (Table I: 125).
      offset_gib:      static demand floor added to every interval
                       (Spark executor + OS baseline in the paper
                       configs).
      base_gib:        plateau level for constant/bursty families.
      amp_range:       per-node amplitude jitter (heterogeneous load).
      phase_shift:     roll each node's trace by a random offset.
      memory_jitter:   fractional spread of per-node total memory
                       (0.2 -> M drawn from [0.8, 1.2] * node_memory).
      burst_gib / burst_every_s / burst_len_s: injected spikes on top
                       of the family trace (0 burst_gib -> off).
      failure_rate:    per-node probability of one failure event: the
                       node's demand collapses to near zero for
                       ``failure_len_s`` (crash + restart), then
                       resumes -- exercises the grant path.
      occupancy:       how full the storage tenant keeps its grant
                       (paper experiments: hot cache, 1.0).
      cache:           optional :class:`CacheSpec` enabling CacheLoop
                       (hit-ratio / eviction / app-runtime dynamics in
                       the scanned loop).  ``None`` keeps the saturated
                       store; a cache spec requires ``occupancy == 1``
                       (the resident set replaces the occupancy
                       abstraction).
      app_graph:       optional :class:`~repro_torch.lab.appgraph.AppGraphSpec`
                       enabling the DAG co-simulation (per-node task
                       queues advancing under live memory pressure,
                       barrier stages gated on the fleet's slowest
                       node, stage-held demand fed back into the
                       trace).  Sweeps then report end-to-end
                       ``FleetStats.makespan``.  Validated against
                       ``n_nodes`` (slow-node indices must exist).
      replay:          the captured demand a ``"replay"`` scenario
                       carries (required for that family, forbidden
                       elsewhere).  Build with
                       :meth:`ScenarioSpec.from_capture`; the first
                       ``min(n_nodes, capture)`` nodes replay the raw
                       trace exactly (time-interpolated when the
                       horizon differs), extra nodes are tiled clones
                       jittered by ``amp_range`` / ``phase_shift`` /
                       ``memory_jitter``.
    """

    name: str
    family: str = "hpcc"
    n_nodes: int = 64
    n_intervals: int = 600
    interval_s: float = 0.1
    node_memory_gib: float = 125.0
    offset_gib: float = 0.0
    base_gib: float = 40.0
    amp_range: Tuple[float, float] = (0.8, 1.2)
    phase_shift: bool = True
    memory_jitter: float = 0.0
    burst_gib: float = 0.0
    burst_every_s: float = 20.0
    burst_len_s: float = 2.0
    failure_rate: float = 0.0
    failure_len_s: float = 5.0
    occupancy: float = 1.0
    cache: Optional[CacheSpec] = None
    app_graph: Optional[AppGraphSpec] = None
    replay: Optional[ReplayTrace] = None
    description: str = ""

    def __post_init__(self) -> None:
        if self.family not in TRACE_FAMILIES:
            raise ValueError(f"family must be one of {TRACE_FAMILIES}")
        if (self.family == "replay") != (self.replay is not None):
            raise ValueError(
                "family='replay' requires a ReplayTrace payload (build "
                "one with ScenarioSpec.from_capture) and other families "
                "must not carry one")
        if self.n_nodes < 1 or self.n_intervals < 1:
            raise ValueError("need n_nodes >= 1 and n_intervals >= 1")
        if not (0.0 <= self.memory_jitter < 1.0):
            raise ValueError("memory_jitter must be in [0, 1)")
        if not (0.0 <= self.failure_rate <= 1.0):
            raise ValueError("failure_rate must be in [0, 1]")
        if not (0.0 < self.occupancy <= 1.0):
            raise ValueError("occupancy must be in (0, 1]")
        if self.cache is not None and self.occupancy != 1.0:
            raise ValueError("cache modeling replaces the occupancy "
                             "abstraction; need occupancy == 1.0")
        if self.app_graph is not None:
            # Fails fast on out-of-range slow_nodes / bad DAGs; the
            # compiled arrays themselves are rebuilt (cheaply) at sweep
            # staging time.
            compile_graph(self.app_graph, self.n_nodes)

    def replace(self, **kw) -> "ScenarioSpec":
        return dataclasses.replace(self, **kw)

    @property
    def duration_s(self) -> float:
        return self.n_intervals * self.interval_s

    # -- capture -> scenario -------------------------------------------------
    @classmethod
    def from_capture(cls, capture, *, name: str = "captured",
                     n_nodes: Optional[int] = None,
                     n_intervals: Optional[int] = None,
                     fit_cache: Optional[bool] = None,
                     **overrides) -> "ScenarioSpec":
        """Fit a live :class:`~repro_torch.core.plane.CapturedTrace` into a
        replayable scenario.

        The returned spec carries the raw captured demand
        (:class:`ReplayTrace`) for exact replay through the sweep
        engine, plus fitted summary statistics -- ``amp_range`` from
        the per-node mean-demand spread, ``phase_shift`` from how
        decorrelated nodes were from the fleet-mean trace,
        ``memory_jitter`` from the per-node total-memory spread -- that
        parameterize any clone nodes a larger ``n_nodes`` asks for.
        When the capture observed cache-like residency (the managed
        stores held bytes *and* visibly lagged the grant -- residency
        that tracks the grant exactly is the saturated-store model), a
        :class:`CacheSpec` is fitted from the residency dynamics:
        ``working_set_frac`` from the
        residency ceiling, ``warm_frac`` from the initial
        residency/grant ratio, ``refill_gibps`` from the admission
        flux (p90 of positive residency increments).  Access rate,
        skew and policy are not observable from capacity telemetry
        alone, so they keep the :class:`CacheSpec` defaults -- pass
        ``cache=`` in ``overrides`` to pin them, or ``fit_cache=False``
        to replay the saturated-store model.

        ``capture`` is duck-typed: anything exposing ``demand``,
        ``total_memory``, ``interval_s`` and optionally ``residency`` /
        ``grant`` arrays works (``CapturedTrace`` does).
        """
        demand = np.asarray(capture.demand, np.float64)
        if demand.ndim != 2 or demand.size == 0:
            raise ValueError("capture.demand must be a non-empty (N, T) "
                             "array")
        m = np.broadcast_to(np.asarray(capture.total_memory, np.float64),
                            (demand.shape[0],))
        trace = ReplayTrace(demand, m, interval_s=float(capture.interval_s))

        node_mean = demand.mean(axis=1)
        fleet_mean = float(node_mean.mean())
        if fleet_mean > 0:
            rel = node_mean / fleet_mean
            amp_range = (float(np.clip(rel.min(), 0.05, 1.0)),
                         float(max(rel.max(), 1.0)))
        else:
            amp_range = (1.0, 1.0)
        # Clones should be phase-shifted iff the captured nodes were
        # visibly desynchronized from the fleet-mean shape.
        phase_shift = True
        if demand.shape[0] > 1 and demand.shape[1] > 2:
            fleet_trace = demand.mean(axis=0)
            if fleet_trace.std() > 0:
                corr = [np.corrcoef(row, fleet_trace)[0, 1]
                        for row in demand if row.std() > 0]
                phase_shift = bool(corr and float(np.median(corr)) < 0.9)
        m_mean = float(m.mean())
        memory_jitter = float(np.clip(
            (m.max() - m.min()) / (2.0 * m_mean), 0.0, 0.5))

        cache = None
        residency = np.asarray(getattr(capture, "residency", np.zeros(())),
                               np.float64)
        grant = np.asarray(getattr(capture, "grant", residency), np.float64)
        observed = residency.size > 0 and float(residency.max()) > 0.0
        if fit_cache is None:
            # Auto-fit only when the residency behaved like a *cache*:
            # visibly below the grant somewhere (cold fill, slow
            # refill, eviction lag).  Residency that tracks the grant
            # exactly IS the saturated-store model -- fitting a cache
            # to it would re-simulate warmup that never happened.
            # Samples are observed *before* the interval's decision
            # while ``grant`` is the post-decision capacity, so
            # residency is compared against the grant in force during
            # the interval (the previous tick's decision).
            in_force = np.concatenate([grant[:, :1], grant[:, :-1]], axis=1) \
                if grant.ndim == 2 and grant.shape[1] else grant
            gap = (in_force - residency) / np.maximum(in_force, 1.0)
            fit_cache = observed and bool((gap > 0.02).mean() > 0.05)
        if fit_cache:
            if not observed:
                raise ValueError("fit_cache=True but the capture holds no "
                                 "nonzero cache residency")
            cache = _fit_cache_spec(residency, m, grant,
                                    float(capture.interval_s))

        kw = dict(
            name=name, family="replay",
            n_nodes=n_nodes or trace.n_nodes,
            n_intervals=n_intervals or trace.n_intervals,
            interval_s=trace.interval_s,
            node_memory_gib=m_mean / GiB,
            base_gib=fleet_mean / GiB,
            amp_range=amp_range, phase_shift=phase_shift,
            memory_jitter=memory_jitter, cache=cache, replay=trace,
            description=(f"replay of {trace.n_intervals} intervals x "
                         f"{trace.n_nodes} nodes captured from a live "
                         "MemoryPlane"))
        kw.update(overrides)
        return cls(**kw)

    # -- compilation ---------------------------------------------------------
    def build_demand(self, seed: int = 0) -> np.ndarray:
        """Compile the per-node demand traces: ``(N, T)`` bytes."""
        n, t = self.n_nodes, self.n_intervals
        if self.family == "replay":
            demand = self._replay_demand(seed)
            if self.burst_gib > 0.0:
                demand = demand + self._injected_bursts(seed)
            if self.failure_rate > 0.0:
                demand = demand * self._failure_mask(seed)
            return demand + self.offset_gib * GiB
        if self.family == "hpcc":
            demand = fleet_demand_traces(
                n, t, self.interval_s, seed=seed, amp_range=self.amp_range,
                phase_shift=self.phase_shift)
        elif self.family == "constant":
            base = constant_trace(self.duration_s, self.interval_s,
                                  self.base_gib)
            demand = fleet_demand_traces(
                n, t, self.interval_s, seed=seed, amp_range=self.amp_range,
                phase_shift=False, base=base)
        else:                                              # bursty
            base = bursty_trace(
                t, self.interval_s, base_gib=self.base_gib,
                burst_gib=self.burst_gib,
                burst_every_s=self.burst_every_s,
                burst_len_s=self.burst_len_s, seed=seed)
            demand = fleet_demand_traces(
                n, t, self.interval_s, seed=seed, amp_range=self.amp_range,
                phase_shift=self.phase_shift, base=base)
        if self.burst_gib > 0.0 and self.family != "bursty":
            demand = demand + self._injected_bursts(seed)
        if self.failure_rate > 0.0:
            demand = demand * self._failure_mask(seed)
        return demand + self.offset_gib * GiB

    def _replay_demand(self, seed: int) -> np.ndarray:
        """Captured demand, time-interpolated and node-tiled: (N, T).

        Rows ``0..min(n_nodes, captured)`` are the raw capture (linear
        time interpolation when the horizon differs -- the identity
        when it matches, so same-shape replay is exact).  Clone rows
        tile the captured traces cyclically with per-clone amplitude
        jitter (``amp_range``) and, under ``phase_shift``, a random
        circular roll, so a 5-node capture can drive a 500-node sweep
        without 100 perfectly synchronized copies.
        """
        tr = self.replay
        base = np.asarray(tr.demand, np.float64)
        nc, tc = base.shape
        if self.n_intervals != tc:
            x_old = np.arange(tc, dtype=np.float64)
            x_new = np.linspace(0.0, tc - 1.0, self.n_intervals)
            base = np.stack([np.interp(x_new, x_old, row) for row in base])
        out = np.empty((self.n_nodes, self.n_intervals))
        out[:min(self.n_nodes, nc)] = base[:self.n_nodes]
        if self.n_nodes > nc:
            rng = np.random.default_rng(seed)
            for i in range(nc, self.n_nodes):
                row = base[i % nc]
                amp = rng.uniform(*self.amp_range)
                roll = (int(rng.integers(0, self.n_intervals))
                        if self.phase_shift else 0)
                out[i] = np.roll(row * amp, roll)
        return out

    def build_node_memory(self, seed: int = 0) -> np.ndarray:
        """Per-node total memory M: ``(N,)`` bytes."""
        if self.family == "replay":
            src = np.asarray(self.replay.node_memory, np.float64)
            nc = src.shape[0]
            m = src[np.arange(self.n_nodes) % nc].copy()
            if self.memory_jitter > 0.0 and self.n_nodes > nc:
                # jitter only the tiled clones: captured nodes keep
                # their observed memory so same-shape replay is exact
                rng = np.random.default_rng(seed + 1)
                m[nc:] *= rng.uniform(1.0 - self.memory_jitter,
                                      1.0 + self.memory_jitter,
                                      size=self.n_nodes - nc)
            return m
        m = np.full(self.n_nodes, self.node_memory_gib * GiB)
        if self.memory_jitter > 0.0:
            rng = np.random.default_rng(seed + 1)
            m *= rng.uniform(1.0 - self.memory_jitter,
                             1.0 + self.memory_jitter, size=self.n_nodes)
        return m

    def _injected_bursts(self, seed: int) -> np.ndarray:
        rng = np.random.default_rng(seed + 2)
        n, t = self.n_nodes, self.n_intervals
        period = max(int(round(self.burst_every_s / self.interval_s)), 1)
        blen = max(int(round(self.burst_len_s / self.interval_s)), 1)
        out = np.zeros((n, t))
        starts = rng.integers(0, period, size=n)          # desynchronized
        for i in range(n):
            for s in range(int(starts[i]), t, period):
                out[i, s:s + blen] = self.burst_gib * GiB
        return out

    def _failure_mask(self, seed: int) -> np.ndarray:
        rng = np.random.default_rng(seed + 3)
        n, t = self.n_nodes, self.n_intervals
        flen = max(int(round(self.failure_len_s / self.interval_s)), 1)
        mask = np.ones((n, t))
        failed = rng.random(n) < self.failure_rate
        starts = rng.integers(0, max(t - flen, 1), size=n)
        for i in np.flatnonzero(failed):
            mask[i, starts[i]:starts[i] + flen] = 0.05    # kernel remnant
        return mask


def _fit_cache_spec(residency: np.ndarray, node_memory: np.ndarray,
                    grant: np.ndarray, interval_s: float) -> CacheSpec:
    """Fit CacheLoop knobs from observed residency/grant telemetry.

    Only capacity-visible quantities are fitted; access rate, reuse
    skew and policy are unobservable from byte counts alone and keep
    the :class:`CacheSpec` defaults.
    """
    residency = np.atleast_2d(residency)
    grant = np.atleast_2d(grant)
    ceiling = residency.max(axis=1)                      # (N,) bytes
    ws_frac = float(np.clip((ceiling / node_memory).mean(), 0.01, 1e6))
    g0 = np.maximum(grant[:, 0], 1.0)
    warm_frac = float(np.clip((residency[:, 0] / g0).mean(), 0.0, 1.0))
    flux = np.diff(residency, axis=1) / interval_s       # bytes / s
    inflow = flux[flux > 0]
    refill = (float(np.quantile(inflow, 0.9)) / GiB if inflow.size
              else CacheSpec.refill_gibps)
    refill = max(refill, 0.01)
    return CacheSpec(working_set_frac=ws_frac, warm_frac=warm_frac,
                     refill_gibps=refill,
                     access_gibps=max(2.0 * refill, CacheSpec.access_gibps))


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ScenarioSpec] = {}


def register_scenario(spec: ScenarioSpec, *, overwrite: bool = False) -> ScenarioSpec:
    if not overwrite and spec.name in _REGISTRY:
        raise ValueError(f"scenario {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def get_scenario(scenario: Union[str, ScenarioSpec]) -> ScenarioSpec:
    if isinstance(scenario, ScenarioSpec):
        return scenario
    try:
        return _REGISTRY[scenario]
    except KeyError:
        known = ", ".join(sorted(_REGISTRY))
        raise KeyError(f"unknown scenario {scenario!r}; known: {known}") \
            from None


def list_scenarios() -> List[str]:
    return sorted(_REGISTRY)


# The paper's four Sec. IV.A memory configurations, expressed as demand
# scenarios (5 nodes, 125 GB, HPCC as the priority tenant).  What varies
# across them is the static demand floor (Spark executor + RDD cache +
# OS baseline) and whether HPCC runs at all; the storage policy under
# test is supplied by the sweep's gain set.
register_scenario(ScenarioSpec(
    name="paper-c1-spark45", family="hpcc", n_nodes=5, n_intervals=4200,
    offset_gib=47.0, amp_range=(1.0, 1.0), phase_shift=False,
    description="Sec. IV.A config 1: Spark 20G + 25G RDD cache + OS, HPCC"))
register_scenario(ScenarioSpec(
    name="paper-c2-static25", family="hpcc", n_nodes=5, n_intervals=4200,
    offset_gib=22.0, amp_range=(1.0, 1.0), phase_shift=False,
    description="Sec. IV.A config 2: Spark 20G + OS, static Alluxio 25G"))
register_scenario(ScenarioSpec(
    name="paper-c3-dynims60", family="hpcc", n_nodes=5, n_intervals=4200,
    offset_gib=22.0, amp_range=(1.0, 1.0), phase_shift=False,
    description="Sec. IV.A config 3: Spark 20G + OS, DynIMS U_max=60G"))
register_scenario(ScenarioSpec(
    name="paper-c4-nohpcc", family="constant", n_nodes=5, n_intervals=4200,
    base_gib=0.0, offset_gib=22.0, amp_range=(1.0, 1.0),
    description="Sec. IV.A config 4: no HPCC -- static upper bound"))

# Beyond-paper stress scenarios.
register_scenario(ScenarioSpec(
    name="bursty-serving", family="bursty", n_nodes=256, n_intervals=1200,
    base_gib=55.0, burst_gib=50.0, burst_every_s=15.0, burst_len_s=3.0,
    amp_range=(0.9, 1.1),
    description="KV-admission waves: 55G plateau, +50G spikes every 15 s"))
register_scenario(ScenarioSpec(
    name="hetero-fleet", family="hpcc", n_nodes=512, n_intervals=1000,
    amp_range=(0.5, 1.5), memory_jitter=0.2,
    description="mixed hardware: M in [100, 150]G, load amp in [0.5, 1.5]"))
register_scenario(ScenarioSpec(
    name="swap-storm", family="bursty", n_nodes=128, n_intervals=1000,
    base_gib=85.0, burst_gib=45.0, burst_every_s=10.0, burst_len_s=4.0,
    description="demand bursts past M: reclaim must race the swap cliff"))
register_scenario(ScenarioSpec(
    name="phase-replay", family="hpcc", n_nodes=1024, n_intervals=1000,
    amp_range=(0.8, 1.2), phase_shift=True,
    description="fleet-scale phase-shifted HPCC replay (simulate_fleet's "
                "workload)"))
register_scenario(ScenarioSpec(
    name="failover-churn", family="constant", n_nodes=256, n_intervals=1200,
    base_gib=60.0, amp_range=(0.9, 1.1), failure_rate=0.15,
    failure_len_s=10.0,
    description="15% of nodes crash-restart: grant path under churn"))

# CacheLoop scenarios: the same demand families with cache dynamics in
# the scanned loop, so sweeps score modeled app runtime (the paper's
# headline metric) and not just control-loop stability.
register_scenario(ScenarioSpec(
    name="spark-iterative-cache", family="hpcc", n_nodes=64,
    n_intervals=1500, offset_gib=22.0, amp_range=(0.9, 1.1),
    cache=CacheSpec(policy="lfu", reuse_skew=0.6, working_set_frac=0.5,
                    access_gibps=2.0, refill_gibps=1.05),
    description="Sec. IV workload with CacheLoop: iterative Spark scans a "
                "~62G working set through an LFU cache under HPCC bursts"))
register_scenario(ScenarioSpec(
    name="cache-churn", family="bursty", n_nodes=64, n_intervals=1200,
    base_gib=70.0, burst_gib=40.0, burst_every_s=12.0, burst_len_s=3.0,
    amp_range=(0.9, 1.1),
    cache=CacheSpec(policy="lru", reuse_skew=0.3, working_set_frac=0.45,
                    access_gibps=2.0, refill_gibps=0.7,
                    evict_penalty_s_per_gib=0.1),
    description="bursts force evict/refill cycles through a slow-refill "
                "LRU cache: reclaim aggression now costs reloads"))

# AppGraph scenarios: the application is a stage DAG co-simulated
# inside the sweep, scored on end-to-end makespan.  "spark-dag" is the
# paper's Sec. IV workload restated as structure -- an iterative
# map->shuffle->reduce job whose queues drain through an LFU cache
# under HPCC pressure, where the tuned dynamic controller's makespan
# gap over the static Table-I 25G grant is *emergent* (no penalty
# weight; see tests/test_appgraph.py and BENCH_appgraph.json).
# "limplock" isolates the barrier coupling: one 4x-degraded node gates
# every shuffle barrier, inflating fleet makespan ~4x.
register_scenario(ScenarioSpec(
    name="spark-dag", family="hpcc", n_nodes=16, n_intervals=1800,
    offset_gib=22.0, amp_range=(0.55, 0.65), phase_shift=False,
    cache=CacheSpec(policy="lfu", reuse_skew=0.3, working_set_frac=0.5,
                    access_gibps=6.0, refill_gibps=2.5,
                    miss_penalty_s_per_gib=0.95, warm_frac=0.25),
    app_graph=AppGraphSpec(
        stages=(
            StageSpec(name="map", tasks=64, task_gib=6.0, barrier=False,
                      demand_gib=2.0),
            StageSpec(name="shuffle", tasks=0, task_gib=24.0,
                      barrier=True, demand_gib=6.0, deps=("map",)),
            StageSpec(name="reduce", tasks=32, task_gib=12.0,
                      barrier=True, demand_gib=3.0, deps=("shuffle",)),
        ),
        iterations=4, compute_gibps=4.0),
    description="iterative Spark DAG (4 x map->shuffle->reduce, ~288G "
                "of task data per node) drained through an LFU cache "
                "under synchronized HPCC pressure (HPL phases hit every "
                "node at once); scored on emergent makespan"))
register_scenario(ScenarioSpec(
    name="limplock", family="constant", n_nodes=8, n_intervals=1200,
    base_gib=40.0, amp_range=(1.0, 1.0), phase_shift=False,
    app_graph=AppGraphSpec(
        stages=(
            StageSpec(name="map", tasks=0, task_gib=8.0, barrier=True,
                      demand_gib=4.0),
            StageSpec(name="shuffle", tasks=0, task_gib=8.0,
                      barrier=True, demand_gib=8.0, deps=("map",)),
            StageSpec(name="reduce", tasks=0, task_gib=8.0, barrier=True,
                      demand_gib=2.0, deps=("shuffle",)),
        ),
        iterations=2, compute_gibps=2.0, slow_nodes=(0,),
        slow_factor=4.0),
    description="one 4x-degraded node behind every shuffle barrier: the "
                "limplock effect -- fleet makespan tracks the straggler, "
                "not the healthy median"))
