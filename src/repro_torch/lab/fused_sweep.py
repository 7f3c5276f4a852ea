"""The fused (gains x nodes) sweep and in-scan successive halving.

Counterpart of ``repro/lab/pallas_sweep.py``.  One launch of the sweep
kernel (:func:`repro_torch.kernels.sweep.sweep_segment`) advances a
block of gain lanes over a demand segment: the control law, the
CacheLoop carry and the streamed Kahan / count / max accumulators, over
a stacked ``(S, L, N)`` state block, and each lane's ``(HIST_BINS,)``
code histogram, from which the p99 is read.  Around the kernel, this
module packs the operands on the host (numpy, as the reference does),
seeds the state (:func:`_init_state`), folds it into per-lane stats
(:func:`_finalize_lanes`, plain PyTorch on the device), and drives two
programs:

* :func:`fused_sweep_demand` -- every gain over the full horizon, in
  lane chunks (:func:`~repro_torch.lab.sweep._resolve_chunk`), mixed
  law classes partitioned;
* :func:`halving_sweep` -- the whole successive-halving schedule on the
  device: at each horizon boundary the lanes are finalized, scored and
  ranked with a stable descending sort, and the survivors (plus the
  baseline lanes and dead padding) are gathered into a smaller block
  with their prefix state and histograms.  Every lane's loop is
  deterministic, so the prefix accumulators equal a from-scratch run
  truncated there.

A scenario's AppGraph (``app_graph=``) adds the queue/barrier carry to
the state block and the stage DAG's work matrix and per-row constants
to the launch (:func:`_stage_graph`); its lanes finalize to a live
``makespan``.  On the card a lane wider than one block needs all of its
launch's blocks resident at once, so the lane chunk is capped by
:func:`~repro_torch.kernels.sweep.graph_lane_limit`.

Numerics: state and accumulators stay float32; ``precision="bf16"``
stores only the demand stream in bfloat16 (rounded to nearest even
once, widened before use).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.control import f32, fma
from ..core.eviction import policy_model
from ..core.traces import GiB
from ..device import DeviceLike, resolve_device
from ..kernels.sweep import (N_NODE_ROWS, N_PARAM_ROWS, _DB, _FF, _INV_M,
                             _INV_R0, _INV_W, _LAM, _LAM_GRANT, _M, _R0,
                             _STAGE_BARRIER, _STAGE_DEMAND, _THR_OVER,
                             _THR_SETTLE, _U_MAX, _U_MIN, _W,
                             graph_lane_limit, state_names, sweep_segment,
                             warm_fraction0)
from .appgraph import AppGraphSpec, compile_graph
from .scenarios import CacheSpec
from .score import (FleetStats, HIST_BINS, OVER_R0_EPS, SETTLE_TOL,
                    default_score, finalize_fleet_stats, quantile_from_hist)
from .sweep import GainSet, _resolve_chunk, paper_law_mask, \
    plan_specialization

# Lane blocks are padded to a multiple of this many lanes (the
# reference's 8-lane tile); padding lanes are marked dead.
LANE_TILE = 8


@dataclasses.dataclass(frozen=True)
class _EngineConsts:
    """Constants one sweep specializes on (float32-exact host values)."""

    paper_law: bool
    unit_occupancy: bool
    occupancy: float
    interval_s: float
    precision: str
    has_cache: bool = False
    conc: float = 0.0
    hit_exp: float = 1.0
    miss_pen: float = 0.0
    evict_pen: float = 0.0
    access_g: float = 0.0
    refill_b: float = 0.0
    access_b: float = 0.0
    cold_mix: float = 0.0
    warm_frac: float = 0.0
    has_graph: bool = False
    comp_itv: float = 0.0        # AppGraph drain per interval, GiB


def _engine_consts(plan, cache: Optional[CacheSpec], interval_s: float,
                   occupancy: float, precision: str,
                   app_graph: Optional[AppGraphSpec] = None) -> _EngineConsts:
    iv = np.float32(interval_s)
    base = dict(paper_law=plan.paper_law, unit_occupancy=plan.unit_occupancy,
                occupancy=float(occupancy), interval_s=float(iv),
                precision=precision)
    if app_graph is not None:
        base.update(has_graph=True, comp_itv=float(
            np.float32(app_graph.compute_gibps) * iv))
    if cache is None:
        return _EngineConsts(**base)
    access_g = np.float32(cache.access_gibps) * iv
    return _EngineConsts(
        has_cache=True,
        conc=float(policy_model(cache.policy).concentration),
        hit_exp=1.0 - float(cache.reuse_skew),
        miss_pen=float(np.float32(cache.miss_penalty_s_per_gib)),
        evict_pen=float(np.float32(cache.evict_penalty_s_per_gib)),
        access_g=float(access_g),
        refill_b=float(np.float32(cache.refill_gibps * GiB) * iv),
        access_b=float(access_g * np.float32(GiB)),
        cold_mix=float(np.float32(cache.reuse_skew)),
        warm_frac=float(np.float32(cache.warm_frac)),
        **base)


def _lane_pack(gains: GainSet) -> np.ndarray:
    """Gain columns + derived rows as one (P, L) float32 matrix."""
    pack = np.zeros((N_PARAM_ROWS, len(gains)), np.float32)
    r0 = np.asarray(gains.r0, np.float32)
    pack[_R0] = r0
    pack[_LAM] = np.asarray(gains.lam, np.float32)
    pack[_LAM_GRANT] = np.asarray(gains.lam_grant, np.float32)
    pack[_U_MIN] = np.asarray(gains.u_min, np.float32)
    pack[_U_MAX] = np.asarray(gains.u_max, np.float32)
    pack[_DB] = np.asarray(gains.deadband, np.float32)
    pack[_FF] = np.asarray(gains.feedforward, np.float32)
    pack[_INV_R0] = np.float32(1.0) / r0
    pack[_THR_OVER] = r0 + np.float32(OVER_R0_EPS)
    pack[_THR_SETTLE] = r0 + np.float32(SETTLE_TOL)
    return pack


def _node_pack(node_memory, n_nodes: int,
               cache: Optional[CacheSpec]) -> np.ndarray:
    pack = np.ones((N_NODE_ROWS, n_nodes), np.float32)
    m = np.broadcast_to(np.asarray(node_memory, np.float64),
                        (n_nodes,)).astype(np.float32)
    pack[_M] = m
    pack[_INV_M] = np.float32(1.0) / m
    if cache is not None:
        w = np.float32(cache.working_set_frac) * m
        pack[_W] = w
        pack[_INV_W] = np.float32(1.0) / w
    return pack


def _pad_gains(gains: GainSet, multiple: int) -> GainSet:
    short = (-len(gains)) % multiple
    if not short:
        return gains
    pad = GainSet(*(np.repeat(getattr(gains, f.name)[-1:], short)
                    for f in dataclasses.fields(GainSet)))
    return gains.concat(pad)


def _init_state(lp: torch.Tensor, np_rows: torch.Tensor, d0: torch.Tensor,
                con: _EngineConsts, names: Tuple[str, ...],
                graph=None) -> torch.Tensor:
    """Stacked initial (S, L, N) state -- the reference's seeds.

    With an AppGraph (``graph``, :func:`_stage_graph`'s pair) every node
    starts on row 0 with its row-0 work, and the first interval's
    observed demand includes row 0's held bytes.
    """
    cols = lp[:, :, None]
    zeros = torch.zeros((lp.shape[1], np_rows.shape[-1]),
                        dtype=torch.float32, device=lp.device)
    u0 = zeros + cols[_U_MAX]
    planes = {n: zeros for n in names}
    planes["u"] = u0
    planes["last_bad"] = zeros - 1.0
    if con.has_graph:
        work, stage = graph
        d0 = d0 + stage[_STAGE_DEMAND][0]
        planes["wleft"] = zeros + work[0]
        planes["t_done"] = zeros - 1.0
    if con.has_cache:
        planes["resident"] = zeros + warm_fraction0(cols, np_rows, con)[0]
    if not con.paper_law:
        # Seed v_prev with the first interval's usage so the slope term
        # is exactly zero before there is a previous observation.
        if con.has_cache:
            planes["v_prev"] = d0 + planes["resident"]
        elif con.unit_occupancy:
            planes["v_prev"] = d0 + u0
        else:
            planes["v_prev"] = fma(f32(con.occupancy, lp.device), u0, d0)
    return torch.stack([planes[n] for n in names])


def _finalize_lanes(state: torch.Tensor, hist: torch.Tensor,
                    lp: torch.Tensor, con: _EngineConsts,
                    names: Tuple[str, ...], n_steps: int,
                    total_work_gib: Optional[float] = None) -> FleetStats:
    """Per-lane :class:`FleetStats` from the stacked accumulators.

    ``hist`` is the (L, HIST_BINS) prefix code histogram; every lane's
    p99 is read out of its own row.  With an AppGraph,
    ``total_work_gib`` is the DAG's fleet-total work (the makespan's
    extrapolation when the DAG has not finished).
    """
    planes = dict(zip(names, state.unbind(0)))
    n_nodes = state.shape[-1]
    p99 = quantile_from_hist(hist, 0.99, n_steps * n_nodes)
    cache_kw = {}
    if con.has_cache:
        cache_kw = dict(hits_gib=planes["hs"], evicted_gib=planes["es"],
                        app_time_s=planes["ts"],
                        accesses_gib=con.access_g * n_steps)
    if con.has_graph:
        cache_kw.update(work_done_gib=planes["wd"],
                        total_work_gib=total_work_gib,
                        t_done=planes["t_done"][..., 0])
    return finalize_fleet_stats(
        util_sum=planes["us"], util_max=planes["mx"],
        caps_sum_gib=planes["cs"], caps_sumsq_gib=planes["c2"],
        over_r0_count=planes["n_r0"], violation_count=planes["n_viol"],
        last_bad=planes["last_bad"], p99_utilization=p99, r0=lp[_R0],
        n_intervals=n_steps, interval_s=con.interval_s, **cache_kw)


def _stage(demand: np.ndarray, lanes: GainSet, node_memory,
           cache: Optional[CacheSpec], precision: str,
           device: torch.device):
    """Demand (T, N), node pack and lane pack on ``device``.

    The demand is cast to float32 on the host in its own (N, T) order and
    transposed on the device: a transposing copy on the host costs more
    than the sweep.
    """
    demand_tn = torch.from_numpy(np.ascontiguousarray(
        demand, np.float32)).to(device).T.contiguous()
    if precision == "bf16":
        demand_tn = demand_tn.to(torch.bfloat16)
    n_nodes = demand.shape[0]
    np_rows = torch.from_numpy(_node_pack(node_memory, n_nodes,
                                          cache)).to(device)
    lp = torch.from_numpy(_lane_pack(lanes)).to(device)
    return demand_tn, np_rows, lp


def _stage_graph(app_graph: Optional[AppGraphSpec], n_nodes: int,
                 device: torch.device):
    """The AppGraph's launch operands on ``device`` and its total work.

    Returns ``((work (S+1, N), stage constants (2, S+1)), total GiB)``,
    or ``(None, None)`` without a graph.  The reference stages the
    per-row demand and barrier flags from a 1-node compile with
    ``slow_nodes`` stripped; they depend on the row only, so the
    N-node compile gives the same values.
    """
    if app_graph is None:
        return None, None
    cg = compile_graph(app_graph, n_nodes)
    stage = np.zeros((2, cg.n_rows + 1), np.float32)
    stage[_STAGE_DEMAND] = cg.demand_bytes
    stage[_STAGE_BARRIER] = cg.barrier
    total = float(np.float32(cg.work_gib.astype(np.float64).sum()))
    return ((torch.from_numpy(cg.work_gib).to(device),
             torch.from_numpy(stage).to(device)), total)


def _alive(n_lanes: int, n_live: int, device: torch.device) -> torch.Tensor:
    alive = torch.zeros((1, n_lanes), dtype=torch.float32)
    alive[0, :n_live] = 1.0
    return alive.to(device)


def _check_args(demand: np.ndarray, cache, occupancy: float,
                precision: str, horizon: Optional[int]) -> np.ndarray:
    if cache is not None and float(occupancy) != 1.0:
        raise ValueError("cache modeling replaces the occupancy "
                         "abstraction; need occupancy == 1.0")
    if precision not in ("f32", "bf16"):
        raise ValueError("precision must be f32|bf16")
    if horizon is not None:
        if not 1 <= horizon <= demand.shape[1]:
            raise ValueError(f"horizon must be in [1, {demand.shape[1]}]")
        demand = demand[:, :horizon]
    return demand


def _zero_hist(lp: torch.Tensor) -> torch.Tensor:
    return torch.zeros((lp.shape[1], HIST_BINS), dtype=torch.int32,
                       device=lp.device)


def _sweep_program(demand_tn, np_rows, lp, alive, con, names, graph=None,
                   total_work_gib=None) -> FleetStats:
    """One lane chunk over the full horizon, on the device."""
    state0 = _init_state(lp, np_rows, demand_tn[0].float(), con, names,
                         graph)
    state, hist = sweep_segment(state0, _zero_hist(lp), demand_tn, lp,
                                np_rows, alive, t0=0, con=con, names=names,
                                graph=graph)
    return _finalize_lanes(state, hist, lp, con, names, demand_tn.shape[0],
                           total_work_gib)


def fused_sweep_demand(
    demand: np.ndarray,
    gains: GainSet,
    *,
    node_memory,
    interval_s: float = 0.1,
    occupancy: float = 1.0,
    chunk: Optional[int] = None,
    cache: Optional[CacheSpec] = None,
    app_graph: Optional[AppGraphSpec] = None,
    horizon: Optional[int] = None,
    precision: str = "f32",
    device: DeviceLike = None,
) -> FleetStats:
    """Sweep an ``(N, T)`` demand matrix (bytes) over every gain point.

    Returns ``(G,)``-field stats as numpy.  Mixed law classes are
    partitioned and stitched back in gain order; gain lanes go in
    chunks of at most ``DEFAULT_CHUNK`` (``chunk`` overrides it), each
    padded up to :data:`LANE_TILE` lanes with dead lanes.  ``app_graph``
    co-simulates the stage DAG (a live ``makespan``); on the card a
    lane wider than one block caps the chunk at the lanes whose blocks
    can all be resident at once.  ``precision="bf16"`` stores only the
    demand stream in bfloat16.
    """
    dev = resolve_device(device)
    demand = _check_args(np.asarray(demand), cache, occupancy, precision,
                         horizon)
    mask = paper_law_mask(gains)
    if mask.any() and not mask.all():
        sub_kw = dict(node_memory=node_memory, interval_s=interval_s,
                      occupancy=occupancy, chunk=chunk, cache=cache,
                      app_graph=app_graph, precision=precision, device=dev)
        idx_fast = np.flatnonzero(mask)
        idx_slow = np.flatnonzero(~mask)
        fast = fused_sweep_demand(demand, gains.take(idx_fast), **sub_kw)
        slow = fused_sweep_demand(demand, gains.take(idx_slow), **sub_kw)
        merged = []
        for f in FleetStats._fields:
            a, b = getattr(fast, f), getattr(slow, f)
            out = np.empty(len(gains), dtype=a.dtype)
            out[idx_fast] = a
            out[idx_slow] = b
            merged.append(out)
        return FleetStats(*merged)
    n_nodes = demand.shape[0]
    chunk = _resolve_chunk(chunk, len(gains), n_nodes)
    chunk = -(-chunk // LANE_TILE) * LANE_TILE
    n_real = len(gains)
    plan = plan_specialization(gains, occupancy)
    con = _engine_consts(plan, cache, interval_s, occupancy, precision,
                         app_graph)
    if con.has_graph and dev.type == "cuda":
        limit = graph_lane_limit(con, n_nodes, dev)
        chunk = chunk if limit is None else min(chunk, limit)
    gains = _pad_gains(gains, chunk)
    names = state_names(con.paper_law, con.has_cache, con.has_graph)
    demand_tn, np_rows, lp = _stage(demand, gains, node_memory, cache,
                                    precision, dev)
    graph, total_work = _stage_graph(app_graph, n_nodes, dev)
    alive = _alive(len(gains), n_real, dev)
    chunks = [_sweep_program(demand_tn, np_rows,
                             lp[:, lo:lo + chunk].contiguous(),
                             alive[:, lo:lo + chunk].contiguous(), con, names,
                             graph, total_work)
              for lo in range(0, len(gains), chunk)]
    return FleetStats(*(np.concatenate(f)[:n_real]
                        for f in zip(*map(_to_host, chunks))))


def _to_host(stats: FleetStats) -> FleetStats:
    """Every (L,) field to numpy in one copy (one sync, not fifteen)."""
    host = torch.stack([x.view(torch.float32) for x in stats]).cpu().numpy()
    return FleetStats(*(row.view(np.int32) if x.dtype == torch.int32
                        else row for row, x in zip(host, stats)))


# ---------------------------------------------------------------------------
# In-scan successive halving
# ---------------------------------------------------------------------------

class HalvingSweep(NamedTuple):
    """Everything one in-scan halving program returned, host-side."""

    stats: FleetStats          # final-round lanes: (k_last + B,) fields
    scores: np.ndarray         # objective over the same lanes
    survivor_idx: np.ndarray   # (k_last,) original candidate indices
    rounds: List[dict]         # {horizon, n_candidates, elapsed_s}
    elapsed_s: float


def halving_schedule(n_intervals: int, n_candidates: int,
                     rounds: Sequence[float], keep: float,
                     min_survivors: int) -> Tuple[List[int], List[int]]:
    """(horizons, survivor counts) exactly as the host tuner computes."""
    fracs = sorted(set(float(f) for f in rounds))
    if not fracs or fracs[0] <= 0.0 or fracs[-1] > 1.0:
        raise ValueError("rounds must be fractions in (0, 1]")
    if fracs[-1] != 1.0:
        fracs.append(1.0)
    horizons = [max(int(round(n_intervals * f)), 1) for f in fracs]
    horizons[-1] = n_intervals
    keeps = []
    n = n_candidates
    for _ in fracs[:-1]:
        k = min(max(int(np.ceil(n * keep)), min_survivors), n)
        keeps.append(k)
        n = k
    return horizons, keeps


def _halving_program(demand_tn, np_rows, lp, alive, con, names,
                     horizons: Sequence[int], keeps: Sequence[int],
                     n_cand: int, n_base: int, objective: Callable):
    """The whole halving schedule on the device.

    Candidate lanes ``[0, n_cand)``, baseline lanes right after, dead
    padding last.  At each boundary: finalize prefix stats, score,
    rank the candidate lanes with a stable descending sort (ties go to
    the lower index, as ``jax.lax.top_k`` breaks them -- ``torch.topk``
    does not), and gather survivors + baseline + padding, prefix state
    and histograms included, into the next lane block.
    """
    dev = lp.device
    state = _init_state(lp, np_rows, demand_tn[0].float(), con, names)
    hist = _zero_hist(lp)
    orig = torch.arange(lp.shape[1], device=dev)
    t_prev = 0
    cand = n_cand
    for i, h in enumerate(horizons):
        if h > t_prev:
            state, hist = sweep_segment(
                state, hist, demand_tn[t_prev:h], lp, np_rows, alive,
                t0=t_prev, con=con, names=names)
            t_prev = h
        stats = _finalize_lanes(state, hist, lp, con, names, h)
        scores = objective(stats)
        if i == len(horizons) - 1:
            n_out = cand + n_base
            return (FleetStats(*(x[:n_out] for x in stats)),
                    scores[:n_out], orig[:cand])
        k = keeps[i]
        idx = torch.sort(scores[:cand], descending=True,
                         stable=True).indices[:k]
        sel = torch.cat([idx, torch.arange(cand, cand + n_base, device=dev)])
        pad_n = (-(k + n_base)) % LANE_TILE
        if pad_n:
            sel = torch.cat([sel, sel[-1:].expand(pad_n)])
        state = state[:, sel, :]
        hist = hist[sel]
        lp = lp[:, sel]
        orig = orig[sel]
        alive = _alive(k + n_base + pad_n, k + n_base, dev)
        cand = k
    raise AssertionError("unreachable")


def halving_sweep(
    demand: np.ndarray,
    gains: GainSet,
    base: GainSet,
    *,
    node_memory,
    interval_s: float = 0.1,
    occupancy: float = 1.0,
    cache: Optional[CacheSpec] = None,
    rounds: Sequence[float] = (0.125, 0.5, 1.0),
    keep: float = 0.25,
    min_survivors: int = 4,
    objective: Callable = default_score,
    horizon: Optional[int] = None,
    precision: str = "f32",
    device: DeviceLike = None,
) -> HalvingSweep:
    """Run the whole successive-halving schedule as one device program.

    ``gains`` are the candidates, ``base`` the always-alive baseline
    lanes scored at the final horizon; ``objective`` maps torch
    :class:`FleetStats` to torch scores (both registry objectives do).
    A mixed paper/beyond-paper gain set runs whole on the generic law
    (identical results; the lanes must share one block for the
    gathers).  Returns a :class:`HalvingSweep`;
    :func:`repro_torch.lab.tune.halving_tune` wraps it into a
    :class:`~repro_torch.lab.tune.TuneResult`.
    """
    dev = resolve_device(device)
    demand = _check_args(np.asarray(demand), cache, occupancy, precision,
                         horizon)
    n_steps = demand.shape[1]
    horizons, keeps = halving_schedule(n_steps, len(gains), rounds, keep,
                                       min_survivors)
    n_cand, n_base = len(gains), len(base)
    lanes = _pad_gains(gains.concat(base), LANE_TILE)
    plan = plan_specialization(lanes, occupancy)
    con = _engine_consts(plan, cache, interval_s, occupancy, precision)
    names = state_names(con.paper_law, con.has_cache)
    demand_tn, np_rows, lp = _stage(demand, lanes, node_memory, cache,
                                    precision, dev)
    alive = _alive(len(lanes), n_cand + n_base, dev)
    t0 = time.perf_counter()
    stats_dev, scores_dev, orig_dev = _halving_program(
        demand_tn, np_rows, lp, alive, con, names, horizons, keeps, n_cand,
        n_base, objective)
    stats = _to_host(stats_dev)
    scores = scores_dev.cpu().numpy()
    survivor_idx = orig_dev.cpu().numpy()
    elapsed = time.perf_counter() - t0
    counts = [n_cand] + list(keeps)
    round_log = [{"horizon": h,
                  "n_candidates": counts[i] + (n_base if final else 0),
                  "elapsed_s": elapsed if final else 0.0}
                 for i, h in enumerate(horizons)
                 for final in [i == len(horizons) - 1]]
    return HalvingSweep(stats=stats, scores=scores,
                        survivor_idx=survivor_idx, rounds=round_log,
                        elapsed_s=elapsed)
