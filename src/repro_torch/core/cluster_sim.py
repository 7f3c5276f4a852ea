"""Discrete-event cluster simulator reproducing the paper's experiments.

A copy of ``repro/core/cluster_sim.py``: :func:`simulate` and the
AppGraph oracle are host numpy (float64) and give the JAX package's
results to the bit; only :func:`simulate_fleet` touches a device.

The paper evaluates DynIMS on 5 compute nodes + a 2-node OrangeFS
cluster, running HPCC (the priority compute tenant) concurrently with
Spark iterative analytics whose input is cached in Alluxio (the
opportunistic storage tenant).  This module models that testbed:

* per compute node: 125 GB RAM; a Spark executor (20 GB pinned, or
  45 GB for the Spark-only config with an RDD cache); an HPCC job whose
  usage follows :func:`~repro_torch.core.traces.hpcc_trace`; an in-memory
  block cache (the Alluxio worker) whose capacity is either static or
  driven by a real :class:`~repro_torch.core.plane.MemoryPlane` at the
  paper's 100 ms interval (scalar reference backend: bit-exact float64
  reproduction of the paper's per-node law),
* a 2-node data tier: shared disk + network bandwidth (readers divide
  it) and a 160 GB aggregate LRU OS buffer cache,
* the iterative app: each iteration every node scans its partition
  block-by-block; a block read costs local-RAM / remote-buffer-cache /
  remote-disk time depending on where it lives; compute follows,
* memory-pressure coupling: when a node's utilization approaches 100%
  the HPL-calibrated slowdown (:func:`~repro_torch.core.traces.hpl_slowdown`)
  stretches both tenants' progress -- the paper's Fig. 2 penalty.

The four memory configurations of Sec. IV.A map to
:func:`make_paper_config`(1..4), and :func:`run_paper_experiment`
returns everything needed for Figs 5-8.

The simulator is fully deterministic given a seed.  For 1000+-node
studies, :func:`simulate_fleet` runs the vectorized control law over
thousands of node controllers: through the sweep kernel on the card, or
one fused torch step per interval.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..device import DeviceLike, resolve_device
from .control import ControllerParams, control_step
from .eviction import LFUPolicy
from .plane import CapturedTrace, MemoryPlane, NodeSpec, PlaneSpec
from .monitor import SimulatedMonitor
from .store import ShardCache, StoreRegistry
from .traces import (GiB, IterativeAppSpec, TierSpec, hpcc_trace,
                     hpl_slowdown, RDD_DESERIALIZATION_BLOAT)


@dataclass
class SimConfig:
    """One experimental configuration (Sec. IV.A)."""

    name: str
    n_compute: int = 5
    node_memory_gib: float = 125.0
    ramdisk_gib: float = 60.0                 # Alluxio U_max (Table I)
    spark_exec_gib: float = 20.0
    os_reserved_gib: float = 5.0              # slack the operators keep free
    os_base_gib: float = 2.0                  # kernel/daemon baseline usage
    data_cache_gib: float = 160.0             # aggregate OS buffer cache
    agg_disk_gibps: float = 0.45              # 2 nodes x ~0.22 GiB/s RAID read
    agg_net_gibps: float = 2.20               # 2 x 10 GbE wire-rate
    tier: TierSpec = field(default_factory=TierSpec)
    app: IterativeAppSpec = field(default_factory=IterativeAppSpec)
    interval_s: float = 0.1                   # control interval T
    controller: Optional[ControllerParams] = None   # None -> static
    static_cache_gib: float = 25.0
    rdd_cache_gib: float = 0.0                # config 1: Spark RDD cache
    run_hpcc: bool = True
    hpcc_duration_s: float = 420.0
    warm_data_cache: bool = True              # dataset gen leaves buffer cache warm
    seed: int = 0
    max_sim_s: float = 3600.0 * 4
    # ReplayLoop: keep the last trace_capacity control intervals of the
    # plane's telemetry and return them as SimResult.trace, so a
    # simulated deployment's own workload becomes a sweepable scenario
    # (ScenarioSpec.from_capture).  Only meaningful with a controller.
    record_trace: bool = False
    trace_capacity: int = 4096


@dataclass
class SimResult:
    config: str
    app_runtime_s: float
    iteration_times_s: List[float]
    hit_ratio: float                          # compute-node in-memory hit ratio
    remote_bytes_gib: float
    disk_reads_gib: float
    hpcc_runtime_s: Optional[float]
    # Fig. 7 timelines (per tick, node-0): execution / storage / free, GiB
    t_s: np.ndarray = field(default_factory=lambda: np.empty(0))
    exec_gib: np.ndarray = field(default_factory=lambda: np.empty(0))
    storage_gib: np.ndarray = field(default_factory=lambda: np.empty(0))
    free_gib: np.ndarray = field(default_factory=lambda: np.empty(0))
    cap_gib: np.ndarray = field(default_factory=lambda: np.empty(0))
    peak_utilization: float = 0.0
    mean_cap_gib: float = 0.0
    trace: Optional[CapturedTrace] = None     # cfg.record_trace capture


class _DataTier:
    """2-node data cluster: LRU OS buffer cache over shared disk."""

    def __init__(self, cache_gib: float, block_gib: float):
        self.capacity = cache_gib
        self.block = block_gib
        self._lru: "Dict[int, None]" = {}
        self.disk_reads = 0
        self.cache_reads = 0

    def warm(self, blocks: List[int]) -> None:
        for b in blocks:
            self._touch(b)

    def read_tier(self, block_id: int) -> str:
        """Returns which remote tier serves the block, updating LRU."""
        if block_id in self._lru:
            self.cache_reads += 1
            self._touch(block_id)
            return "remote_cache"
        self.disk_reads += 1
        self._touch(block_id)
        return "disk"

    def _touch(self, block_id: int) -> None:
        self._lru.pop(block_id, None)
        self._lru[block_id] = None
        while len(self._lru) * self.block > self.capacity:
            self._lru.pop(next(iter(self._lru)))


@dataclass
class _BlockJob:
    """Progress state of the block a node is currently processing."""

    block_id: int
    read_left_s: float
    compute_left_s: float
    tier: str


class _Node:
    """One compute node: HPCC tenant + Spark tenant + block cache."""

    def __init__(self, idx: int, cfg: SimConfig, partition: List[int],
                 cache_gib: float):
        self.idx = idx
        self.cfg = cfg
        self.partition = partition
        # Scan-resistant LFU (MRU tie-break) + frequency admission: keeps
        # the resident set stable under cyclic scans and keeps eviction
        # victims inclusive with the data-node buffer cache (Sec. IV.B).
        self.cache = ShardCache(
            name=f"alluxio-{idx}", capacity=cache_gib * GiB,
            policy=LFUPolicy(tie="mru"), admission=True)
        self.registry = StoreRegistry()
        self.registry.register(self.cache, max_bytes=cfg.ramdisk_gib * GiB)
        self.iteration = 0
        self.block_pos = 0
        self.job: Optional[_BlockJob] = None
        self.waiting_barrier = False
        self.done = False
        self.hpcc_clock = 0.0
        self.hpcc_done = not cfg.run_hpcc
        self.hpcc_finish_s: Optional[float] = None
        # effective RDD-cached blocks (config 1): pinned, immune to eviction
        bloat = RDD_DESERIALIZATION_BLOAT
        n_pinned = int((cfg.rdd_cache_gib / bloat) // cfg.app.block_gib)
        self.pinned = set(partition[:n_pinned])
        self.pinned_gib = len(self.pinned) * cfg.app.block_gib
        self.local_reads = 0
        self.remote_reads = 0

    # -- memory accounting -------------------------------------------------
    def hpcc_usage_gib(self, trace: np.ndarray) -> float:
        if self.hpcc_done:
            return 0.0
        i = min(int(self.hpcc_clock / self.cfg.interval_s), len(trace) - 1)
        return trace[i] / GiB

    def spark_usage_gib(self) -> float:
        # Config 1 allocates the full RDD-cache region in the JVM heap
        # regardless of how many (bloated) blocks actually fit in it.
        return self.cfg.spark_exec_gib + self.cfg.rdd_cache_gib

    def used_gib(self, trace: np.ndarray) -> float:
        # The paper's 5 GB "reserved space" is slack (kept free), not
        # usage; only the kernel/daemon baseline counts as used.
        return (self.hpcc_usage_gib(trace) + self.spark_usage_gib()
                + self.cfg.os_base_gib + self.cache.used() / GiB)


def _partition_blocks(n_blocks: int, n_nodes: int) -> List[List[int]]:
    """Contiguous partitions (Spark locality-preserving split)."""
    out, start = [], 0
    for i in range(n_nodes):
        size = n_blocks // n_nodes + (1 if i < n_blocks % n_nodes else 0)
        out.append(list(range(start, start + size)))
        start += size
    return out


def simulate(cfg: SimConfig) -> SimResult:
    app, tier = cfg.app, cfg.tier
    partitions = _partition_blocks(app.n_blocks, cfg.n_compute)
    static_cap = 0.0 if cfg.rdd_cache_gib else cfg.static_cache_gib
    init_cap = cfg.ramdisk_gib if cfg.controller is not None else static_cap
    nodes = [_Node(i, cfg, partitions[i], init_cap)
             for i in range(cfg.n_compute)]
    data_tier = _DataTier(cfg.data_cache_gib, app.block_gib)
    if cfg.warm_data_cache:
        # Dataset generation streams blocks through the data nodes; the
        # OS buffer cache retains the most recent cache_gib worth.
        data_tier.warm(list(range(app.n_blocks)))

    trace = (hpcc_trace(cfg.hpcc_duration_s, cfg.interval_s, seed=cfg.seed)
             if cfg.run_hpcc else np.zeros(1))

    plane: Optional[MemoryPlane] = None
    if cfg.controller is not None:
        plane = MemoryPlane(PlaneSpec(
            params=cfg.controller,
            backend="scalar",    # float64 reference law, paper-faithful
            record=cfg.trace_capacity if cfg.record_trace else 0,
            nodes=tuple(
                NodeSpec(
                    name=f"node{node.idx}",
                    monitor=SimulatedMonitor(
                        node=f"node{node.idx}",
                        total=cfg.node_memory_gib * GiB,
                        usage=_UsageProbe(node, trace),
                        storage_used_fn=node.cache.used,
                        dt=cfg.interval_s),
                    registry=node.registry,
                    u0=cfg.ramdisk_gib * GiB)
                for node in nodes)))

    dt = cfg.interval_s
    t = 0.0
    iter_start = [0.0]
    iteration_times: List[float] = []
    tl_t, tl_exec, tl_stor, tl_free, tl_cap = [], [], [], [], []
    peak_util = 0.0
    cap_samples: List[float] = []
    n_ticks = 0

    while t < cfg.max_sim_s:
        n_ticks += 1
        # ---- control interval: DynIMS observes and actuates ---------------
        if plane is not None:
            plane.tick()

        # ---- shared remote bandwidth this tick -----------------------------
        disk_readers = sum(1 for n in nodes if n.job and n.job.tier == "disk"
                           and n.job.read_left_s > 0)
        net_readers = sum(1 for n in nodes
                          if n.job and n.job.tier == "remote_cache"
                          and n.job.read_left_s > 0)
        disk_share = cfg.agg_disk_gibps / max(disk_readers, 1)
        net_share = cfg.agg_net_gibps / max(net_readers, 1)

        all_done = True
        barrier_count = 0
        for node in nodes:
            util = node.used_gib(trace) / cfg.node_memory_gib
            peak_util = max(peak_util, util)
            slowdown = hpl_slowdown(util)
            progress = dt / slowdown

            # HPCC tenant advances on its own clock, stretched by pressure.
            if not node.hpcc_done:
                node.hpcc_clock += progress
                if node.hpcc_clock >= cfg.hpcc_duration_s:
                    node.hpcc_done = True
                    node.hpcc_finish_s = t

            # Spark tenant
            if node.done:
                continue
            all_done = False
            if node.waiting_barrier:
                barrier_count += 1
                continue
            if node.job is None:
                node.job = _start_block(node, data_tier, tier)
            job = node.job
            if job.read_left_s > 0:
                # Remote read times are priced at the tier's *aggregate*
                # bandwidth; concurrent readers divide it evenly.
                consume = progress
                if job.tier == "disk" and disk_readers > 1:
                    consume = progress / disk_readers
                elif job.tier == "remote_cache" and net_readers > 1:
                    consume = progress / net_readers
                job.read_left_s -= consume
                if job.read_left_s > 0:
                    continue
            if job.compute_left_s > 0:
                job.compute_left_s -= progress
                if job.compute_left_s > 0:
                    continue
            # block finished
            node.block_pos += 1
            node.job = None
            if node.block_pos >= len(node.partition):
                node.block_pos = 0
                node.waiting_barrier = True
                barrier_count += 1

        # ---- iteration barrier (Spark stage boundary) ----------------------
        active = [n for n in nodes if not n.done]
        if active and all(n.waiting_barrier for n in active):
            iteration_times.append(t + dt - iter_start[0])
            iter_start[0] = t + dt
            for n in active:
                n.iteration += 1
                n.waiting_barrier = False
                if n.iteration >= app.iterations:
                    n.done = True

        # ---- timelines (node 0) --------------------------------------------
        n0 = nodes[0]
        exec_g = n0.hpcc_usage_gib(trace) + n0.spark_usage_gib() \
            + cfg.os_base_gib
        stor_g = n0.cache.used() / GiB
        tl_t.append(t)
        tl_exec.append(exec_g)
        tl_stor.append(stor_g)
        tl_free.append(max(cfg.node_memory_gib - exec_g - stor_g, 0.0))
        tl_cap.append(n0.cache.capacity() / GiB)
        cap_samples.append(n0.cache.capacity() / GiB)

        t += dt
        if all_done:
            break

    hits = sum(n.cache.stats.hits for n in nodes)
    misses = sum(n.cache.stats.misses for n in nodes)
    pinned_hits = sum(n.local_reads for n in nodes)
    total_local = hits + pinned_hits
    total_reads = hits + misses + pinned_hits
    hpcc_fin = None
    if cfg.run_hpcc:
        fins = [n.hpcc_finish_s for n in nodes if n.hpcc_finish_s is not None]
        hpcc_fin = max(fins) if fins else None
    captured = (plane.capture()
                if plane is not None and cfg.record_trace and n_ticks
                else None)
    return SimResult(
        config=cfg.name,
        app_runtime_s=float(sum(iteration_times)),
        iteration_times_s=[float(x) for x in iteration_times],
        hit_ratio=total_local / total_reads if total_reads else 0.0,
        remote_bytes_gib=sum(n.cache.stats.bytes_read_remote
                             for n in nodes) / GiB,
        disk_reads_gib=data_tier.disk_reads * app.block_gib,
        hpcc_runtime_s=hpcc_fin,
        t_s=np.asarray(tl_t),
        exec_gib=np.asarray(tl_exec),
        storage_gib=np.asarray(tl_stor),
        free_gib=np.asarray(tl_free),
        cap_gib=np.asarray(tl_cap),
        peak_utilization=peak_util,
        mean_cap_gib=float(np.mean(cap_samples)) if cap_samples else 0.0,
        trace=captured,
    )


class _UsageProbe:
    """Callable feeding SimulatedMonitor the node's *compute* usage."""

    def __init__(self, node: _Node, trace: np.ndarray):
        self._node = node
        self._trace = trace

    def __call__(self, i: int) -> float:
        n = self._node
        return (n.hpcc_usage_gib(self._trace) + n.spark_usage_gib()
                + n.cfg.os_base_gib) * GiB


def _start_block(node: _Node, data_tier: _DataTier,
                 tier: TierSpec) -> _BlockJob:
    cfg = node.cfg
    block_id = node.partition[node.block_pos]
    block_gib = cfg.app.block_gib
    compute_s = cfg.app.compute_s_per_gib * block_gib

    if block_id in node.pinned:
        node.local_reads += 1
        return _BlockJob(block_id, tier.read_time_s(block_gib, "local"),
                         compute_s, "local")

    cached = node.cache.get(block_id)
    if cached is not None:
        return _BlockJob(block_id, tier.read_time_s(block_gib, "local"),
                         compute_s, "local")

    node.remote_reads += 1
    remote = data_tier.read_tier(block_id)
    if remote == "remote_cache":
        read_s = block_gib / cfg.agg_net_gibps       # share applied per-tick
    else:
        read_s = block_gib / cfg.agg_disk_gibps
    node.cache.stats.bytes_read_remote += block_gib * GiB
    # Insert into the node cache (admission may reject under scan).
    node.cache.put(block_id, _SizedBlock(block_gib * GiB))
    return _BlockJob(block_id, read_s, compute_s, remote)


class _SizedBlock:
    __slots__ = ("nbytes",)

    def __init__(self, nbytes: float):
        self.nbytes = nbytes


# ---------------------------------------------------------------------------
# The paper's four configurations (Sec. IV.A)
# ---------------------------------------------------------------------------

def make_paper_config(configuration: int, *, app: Optional[IterativeAppSpec]
                      = None, seed: int = 0, **overrides) -> SimConfig:
    app = app or IterativeAppSpec()
    base = dict(app=app, seed=seed)
    base.update(overrides)
    if configuration == 1:      # Spark(45GB), no Alluxio caching
        return SimConfig(name="spark45", spark_exec_gib=20.0,
                         rdd_cache_gib=25.0, static_cache_gib=0.0,
                         controller=None, run_hpcc=True, **base)
    if configuration == 2:      # Spark(20)/Alluxio(25) static
        return SimConfig(name="spark20_alluxio25", static_cache_gib=25.0,
                         controller=None, run_hpcc=True, **base)
    if configuration == 3:      # Spark(20)/DynIMS(60)
        return SimConfig(name="spark20_dynims60",
                         controller=paper_controller_params(), run_hpcc=True,
                         **base)
    if configuration == 4:      # Spark(20)/Alluxio(60), no HPCC: upper bound
        return SimConfig(name="spark20_alluxio60_nohpcc",
                         static_cache_gib=60.0, controller=None,
                         run_hpcc=False, **base)
    raise ValueError("configuration must be 1..4")


def make_cache_parity_config(*, n_compute: int = 2, cache_gib: float = 32.0,
                             dataset_gib: float = 128.0, iterations: int = 25,
                             seed: int = 0, **overrides) -> SimConfig:
    """The CacheLoop oracle configuration: a pure cache-dynamics run.

    A small static-capacity, no-HPCC setup whose discrete-event hit
    ratio the analytic cache model in the scanned sweep must reproduce:
    each node cyclically scans a ``dataset_gib / n_compute`` partition
    through a ``cache_gib`` LFU cache, so after the cold first pass the
    admission-stabilized resident prefix yields exactly
    ``(iterations - 1) * cache_gib`` block hits out of
    ``iterations * partition`` reads.  The network bandwidth is raised
    so the run stays compute-shaped (fewer ticks); hit counting is
    bandwidth-independent.  ``tests/test_cacheloop.py`` asserts the
    sweep engine's ``hit_ratio`` lands within 0.02 of this oracle.
    """
    app = IterativeAppSpec(name="parity-scan", dataset_gib=dataset_gib,
                           block_gib=1.0, iterations=iterations,
                           compute_s_per_gib=0.2)
    kw = dict(name="cache-parity", n_compute=n_compute,
              static_cache_gib=cache_gib, controller=None, run_hpcc=False,
              app=app, agg_net_gibps=8.0, seed=seed)
    kw.update(overrides)
    return SimConfig(**kw)


def paper_controller_params(**overrides) -> ControllerParams:
    """Table I parameters."""
    kw = dict(total_memory=125.0 * GiB, r0=0.95, lam=0.5,
              u_min=0.0, u_max=60.0 * GiB, interval_s=0.1)
    kw.update(overrides)
    return ControllerParams(**kw)


def run_paper_experiment(app: Optional[IterativeAppSpec] = None,
                         seed: int = 0, configs: Tuple[int, ...] = (1, 2, 3, 4),
                         **overrides) -> Dict[int, SimResult]:
    return {c: simulate(make_paper_config(c, app=app, seed=seed, **overrides))
            for c in configs}


# ---------------------------------------------------------------------------
# AppGraph oracle: float64 discrete-event makespan reference
# ---------------------------------------------------------------------------

def simulate_app_graph(graph, demand: np.ndarray, *,
                       node_memory: float,
                       interval_s: float = 1.0,
                       params: Optional[ControllerParams] = None,
                       static_grant: float = 25.0 * GiB,
                       cache=None) -> Dict[str, object]:
    """Float64 discrete-event oracle for the AppGraph makespan.

    An independent implementation of the stage-DAG co-simulation the
    sweep engine streams through its scan
    (:mod:`repro_torch.lab.appgraph`): per node, one scalar Eq.-1 controller
    (:func:`~repro_torch.core.control.control_step`, the float64 reference
    law) observes external demand plus the active stage's held memory,
    and the node's task queue drains at ``compute_gibps`` stretched by
    the Fig.-2 curve (and, with a :class:`~repro_torch.lab.scenarios.CacheSpec`,
    by the same analytic miss/eviction stalls, mirrored here in f64).

    Where the scan quantizes the queue to whole control intervals, this
    oracle **splits events sub-interval**: within an interval the drain
    rate is piecewise constant, a node finishing a stage row mid-
    interval promotes (non-barrier) or blocks (barrier) at the exact
    event time, a barrier releases every blocked node at the instant
    the fleet's slowest finishes, and rates are re-derived at each
    split from the new row's held demand.  The parity tests pin the
    streamed f32 interval-quantized makespan against this to a
    relative tolerance that brackets the quantization gap.

    Args:
      graph: a :class:`repro_torch.lab.appgraph.AppGraphSpec`.
      demand: ``(N, T)`` external (HPCC) demand in **bytes** per node
        per control interval -- the same array the sweep consumes
        (transposed).
      node_memory: per-node total memory M, bytes.
      interval_s: control interval T.
      params: controller parameters; ``None`` runs the static baseline
        with the grant pinned at ``static_grant`` bytes.
      cache: optional ``CacheSpec``; mirrors CacheLoop's analytic
        resident/hit/refill dynamics in float64 (interval-quantized,
        as in the scan -- only the *queue* is event-split).

    Returns a dict: ``makespan_s`` (finished -> exact event time,
    else the sweep's work-linear extrapolation), ``finished``,
    ``t_done_s``, ``stage_finish_s`` (per compiled row: the wall clock
    at which the row cleared fleet-wide, -1 if never), and
    ``work_done_gib`` per node.
    """
    from ..lab.appgraph import compile_graph   # lazy: core must not
    # import the lab at module scope (the lab imports core)

    g = compile_graph(graph, demand.shape[0])
    n_nodes, t_steps = demand.shape
    demand = np.asarray(demand, np.float64)
    m = float(node_memory)
    w = g.work_gib.astype(np.float64)              # (S+1, N) GiB
    stage_demand = g.demand_bytes.astype(np.float64)
    barrier = g.barrier.astype(np.float64)
    s_tot = g.n_rows
    comp = float(graph.compute_gibps)              # GiB/s nominal

    u0 = float(params.u_max) if params is not None else float(static_grant)
    u = np.full(n_nodes, u0, np.float64)
    v_prev: List[Optional[float]] = [None] * n_nodes

    if cache is not None:
        from .eviction import policy_model
        conc = float(policy_model(cache.policy).concentration)
        hit_exp = 1.0 - float(cache.reuse_skew)
        wset = float(cache.working_set_frac) * m   # bytes
        access_g = float(cache.access_gibps) * interval_s   # GiB/interval
        refill_b = float(cache.refill_gibps) * GiB * interval_s
        access_b = access_g * GiB
        cold_mix = float(cache.reuse_skew)
        res0 = float(cache.warm_frac) * min(u0, wset)
        wf0 = res0 / wset
        resident = np.full(n_nodes, res0, np.float64)

    sidx = np.zeros(n_nodes, np.int64)
    wleft = w[0].copy()
    wdone = np.zeros(n_nodes, np.float64)
    blocked = np.zeros(n_nodes, bool)
    stage_finish = np.full(s_tot, -1.0, np.float64)
    t_done_s = -1.0

    def slowdown_at(n_i: int, store: np.ndarray, t: int) -> float:
        d_i = demand[n_i, t] + stage_demand[sidx[n_i]]
        return hpl_slowdown((d_i + store[n_i]) / m)

    for t in range(t_steps):
        d = demand[:, t] + stage_demand[sidx]
        store = resident if cache is not None else u
        v = d + store
        r = v / m
        if params is not None:
            u_next = np.array([control_step(u[i], v[i], params,
                                            v_prev=v_prev[i])
                               for i in range(n_nodes)])
        else:
            u_next = u
        stall = np.zeros(n_nodes, np.float64)
        if cache is not None:
            res_ev = np.minimum(resident, u_next)
            ev_g = (resident - res_ev) / GiB
            f = np.minimum(res_ev / wset, 1.0)
            hit = conc * f ** hit_exp + (1.0 - conc) * f
            if t * access_b < wset:                # cold-scan window
                wf = np.minimum(wf0, f)
                hit = wf + cold_mix * (hit - wf)
            miss_g = (1.0 - hit) * access_g
            resident = np.minimum(np.minimum(u_next, wset),
                                  res_ev + np.minimum(miss_g * GiB,
                                                      refill_b))
            stall = (miss_g * cache.miss_penalty_s_per_gib
                     + ev_g * cache.evict_penalty_s_per_gib)

        # --- event-split queue advance over [t, t+1) * interval_s ----
        # Rate is piecewise constant between events; miss/eviction
        # stalls stretch the whole interval uniformly (cache state is
        # interval-level), the Fig.-2 term re-derives at each split.
        # ``store`` still holds the pre-update values -- the scan's
        # dt_app uses the same pre-eviction observation.
        rate = np.array([comp * interval_s
                         / (interval_s * slowdown_at(i, store, t)
                            + stall[i]) for i in range(n_nodes)])
        elapsed = np.zeros(n_nodes, np.float64)
        while t_done_s < 0.0:
            eta = np.full(n_nodes, np.inf)
            act = (~blocked) & (sidx < s_tot)
            eta[act] = elapsed[act] + wleft[act] / rate[act]
            i = int(np.argmin(eta))
            if eta[i] > interval_s:
                break
            t_ev = float(eta[i])
            abs_t = t * interval_s + t_ev
            wdone[i] += wleft[i]
            wleft[i] = 0.0
            elapsed[i] = t_ev
            s = int(sidx[i])
            if barrier[s] > 0.0:
                blocked[i] = True
                if bool(np.all(blocked & (sidx == s))):
                    stage_finish[s] = abs_t
                    blocked[:] = False
                    sidx[:] = s + 1
                    if s + 1 >= s_tot:
                        t_done_s = abs_t
                        break
                    wleft = w[s + 1].copy()
                    elapsed[:] = t_ev
                    rate = np.array([
                        comp * interval_s
                        / (interval_s * slowdown_at(j, store, t)
                           + stall[j]) for j in range(n_nodes)])
            else:
                stage_finish[s] = max(stage_finish[s], abs_t)
                sidx[i] = s + 1
                if int(np.min(sidx)) >= s_tot:
                    t_done_s = abs_t
                    break
                if sidx[i] < s_tot:
                    wleft[i] = w[sidx[i], i]
                    rate[i] = (comp * interval_s
                               / (interval_s * slowdown_at(i, store, t)
                                  + stall[i]))
        if t_done_s >= 0.0:
            break
        act = (~blocked) & (sidx < s_tot)
        prog = rate * (interval_s - elapsed)
        wdone[act] += np.minimum(prog, wleft)[act]
        wleft[act] = np.maximum(wleft - prog, 0.0)[act]
        v_prev = list(v)
        u = u_next

    horizon_s = t_steps * interval_s
    if t_done_s >= 0.0:
        makespan = t_done_s
    else:
        makespan = max(horizon_s * float(w.sum())
                       / max(float(wdone.sum()), 1e-6), horizon_s)
    return {"makespan_s": makespan, "finished": t_done_s >= 0.0,
            "t_done_s": t_done_s, "stage_finish_s": stage_finish,
            "work_done_gib": wdone}


# ---------------------------------------------------------------------------
# Fleet-scale control simulation (1000+ nodes) via the vectorized law
# ---------------------------------------------------------------------------

def simulate_fleet(n_nodes: int = 4096, n_intervals: int = 1000,
                   seed: int = 0,
                   params: Optional[ControllerParams] = None,
                   engine: str = "lab", device: DeviceLike = None) -> dict:
    """Vectorized closed-loop sim of ``n_nodes`` controllers.

    Each node gets a phase-shifted, amplitude-jittered HPCC trace
    (:func:`~repro_torch.core.traces.fleet_demand_traces`) and the whole
    fleet's Eq. 1 updates run batched on ``device`` (the card by
    default; ``"cpu"`` runs the plain versions).  Two engines:

    * ``engine="lab"`` (default) -- delegate to the ScenarioLab sweep
      (:func:`~repro_torch.lab.sweep.sweep_demand`): the whole horizon
      is one launch of the sweep kernel, whose statistics (p99 through
      the per-lane histogram) stay on the device until one readback.
    * ``engine="python"`` -- one fused torch step per interval, every
      interval's utilization and grant kept for numpy's statistics.
      A parity test pins both engines' metrics together.

    Returns stability metrics the fleet-scale test asserts on.
    """
    from .traces import fleet_demand_traces

    p = params or paper_controller_params()
    dev = resolve_device(device)
    demand = fleet_demand_traces(n_nodes, n_intervals, p.interval_s,
                                 seed=seed)

    if engine == "lab":
        from ..lab.score import stats_to_dict
        from ..lab.sweep import GainSet, sweep_demand
        stats = sweep_demand(
            demand, GainSet.from_params(p), node_memory=p.total_memory,
            interval_s=p.interval_s, device=dev)
        out = stats_to_dict(stats, 0)
        out["n_nodes"] = n_nodes
        return out
    if engine != "python":
        raise ValueError("engine must be lab|python")

    import torch

    from .control import f32, vectorized_step

    m = p.total_memory
    # The JAX engine jits this step with M and r0 as constants: XLA
    # multiplies by their float32 reciprocals and contracts the
    # multiply-adds (ROADMAP C3, C9); ``vectorized_step`` does the same
    # with the reciprocals given.
    inv_m = f32(np.float32(1.0) / np.float32(m), dev)
    inv_r0 = np.float32(1.0) / np.float32(p.r0)
    lam_grant = p.lam_grant
    d_all = torch.from_numpy(np.ascontiguousarray(demand.T, np.float32)).to(
        dev)                                             # (T, N)
    u = torch.full((n_nodes,), float(np.float32(p.u_max)),
                   dtype=torch.float32, device=dev)
    # First interval runs without a previous observation: seeding v_prev
    # with that interval's own usage zeroes the slope term exactly (the
    # lab engine uses the same convention, keeping the engines in parity
    # for feedforward params too).
    v_prev = d_all[0] + u
    utils = torch.empty((n_intervals, n_nodes), dtype=torch.float32,
                        device=dev)
    caps = torch.empty_like(utils)
    for i in range(n_intervals):
        v = d_all[i] + u                                 # saturated store
        u = vectorized_step(u, v, total_memory=m, r0=p.r0, lam=p.lam,
                            u_min=p.u_min, u_max=p.u_max,
                            lam_grant=lam_grant, deadband=p.deadband,
                            v_prev=v_prev, feedforward=p.feedforward,
                            inv_total_memory=inv_m, inv_r0=inv_r0)
        utils[i] = v * inv_m
        caps[i] = u
        v_prev = v
    utils = utils.cpu().numpy()                          # (T, N)
    caps = caps.cpu().numpy()
    # overshoot: utilization above r0 one interval after the law engages
    over = np.clip(utils - p.r0 / 1.0, 0.0, None)
    return {
        "n_nodes": n_nodes,
        "mean_utilization": float(utils.mean()),
        "p99_utilization": float(np.quantile(utils, 0.99)),
        "max_utilization": float(utils.max()),
        "mean_capacity_gib": float(caps.mean() / GiB),
        "capacity_std_gib": float(caps.std() / GiB),
        "frac_intervals_over_r0": float((utils > p.r0 + 1e-3).mean()),
        "max_over_r0": float(over.max()),
    }
