"""The fleet sweep: the two-level control loop over every gain, batched.

The port of ``repro/fleet/sweep.py``.  :func:`fleet_sweep_demand`
rolls the *composed* two-level system forward -- every tenant's Eq. 1
loop every interval, the global arbiter every ``epoch_intervals``
intervals -- for every gain point of a
:class:`~repro_torch.lab.sweep.GainSet`.  The JAX package runs this
carry as XLA (its ``engine="pallas"`` falls back), never as a Pallas
kernel, so here it is plain PyTorch: an epoch loop over an interval
loop on the host, each step one batch of tensor operations over
``(gains, tenants, nodes)`` on ``device`` (the card by default), every
gain lane of a chunk in one tensor.  Nothing is read back until the
chunk ends.

Stats are the lab's :class:`~repro_torch.lab.score.FleetStats` on the
*fleet-level* closed loop -- utilization is all tenants' usage over
physical node memory, capacity the summed storage grant -- and
:class:`FleetExtras` carries the arbitration invariants (conservation
slack, floor slack, per-tenant budget statistics) over every epoch of
every gain point.  The p99 counts each interval's utilization codes
into a per-lane histogram (:func:`~repro_torch.lab.score.hist_add`)
and reads it with :func:`~repro_torch.lab.score.quantile_from_hist`:
the JAX package's bisection over its code stream, bit for bit, with no
stream kept.

The carry makes the JAX program's roundings as XLA compiles it on the
CPU: sums over tenants are left folds (:func:`~.arbiter.ksum`), and the
multiply-adds XLA contracts are rounded once (``core.control.fma``):
the feedforward, the Kahan step's ``v_sum * inv_m - comp``, the
capacity's second moment, the initial budgets' ``f_eff + share * rem``
(contracted around ``f * scale``), each need's ``usage * c - f_eff``
(``arbitrate(desired_scale=)``) and the effective floors' reduction
(:func:`~.arbiter.kdot`).  So its carry equals JAX's bit for bit on
the CPU, and the card and the CPU take one path.

:func:`fleet_reference` is the float64 numpy oracle -- scalar per-node
loops, :func:`~.arbiter.arbitrate_reference` every epoch -- with
:func:`~repro_torch.lab.score.compute_fleet_stats` for its stats.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..analysis.runtime import dispatch_guard
from ..core.control import f32, fma, vectorized_step
from ..core.traces import GiB
from ..device import DeviceLike
from ..lab.mesh import check_layout, layout, node_columns, to_lead
from ..lab.score import (FleetStats, HIST_BINS, OVER_R0_EPS, SETTLE_TOL,
                         _axis_min, _axis_sum, compute_fleet_stats,
                         finalize_fleet_stats, finalize_partials,
                         fleet_partials, hist_add, kahan_add,
                         quantile_from_hist, utilization_codes)
from ..lab.sweep import DevicesLike, GainSet, resolve_devices
from .arbiter import (MIN_TENANT_BUDGET, arbitrate, arbitrate_reference,
                      kdot, ksum)
from .specs import POLICIES

Array = Union[np.ndarray, torch.Tensor]

# Gains per chunk.  The JAX package's 8 bounds its code history; here
# no history is kept and the carry's cost is the host issuing the same
# operations for any number of lanes, so a chunk holds up to 64.
FLEET_CHUNK = 64


class FleetExtras(NamedTuple):
    """Arbitration invariants streamed out of the fleet loop.

    Each field is per gain point; slacks are worst-case over every
    (epoch, node) -- non-negative iff the invariant held at every
    arbitration the sweep performed.
    """

    conservation_slack_gib: Array    # (G,) min of M - sum_k B[k]
    floor_slack_gib: Array           # (G,) min of B[k] - effective floor
    tenant_budget_mean_gib: Array    # (G, K) mean budget per tenant
    tenant_budget_min_gib: Array     # (G, K) min budget per tenant


def _effective_floors_np(floors, m):
    """Floors as granted (float64 numpy): raised, admissible."""
    f = np.maximum(floors[:, None], MIN_TENANT_BUDGET)
    scale = np.minimum(1.0, m / np.maximum(f.sum(0), 1.0))
    return f * scale                                   # (K, N)


def _initial_budgets_np(weights, floors, m):
    """:meth:`~.arbiter.FleetArbiter.initial_budgets` over nodes."""
    f_eff = _effective_floors_np(floors, m)
    rem = np.maximum(m - f_eff.sum(0), 0.0)
    share = (weights / weights.sum())[:, None]
    return f_eff + share * rem                         # (K, N)


def _floors_and_budgets(weights, floors, m):
    """Effective floors and the pre-telemetry budgets, float32 torch.

    Floors plus a weight share of the remainder, as XLA computes the
    JAX package's ``_initial_budgets``: the remainder's reduction
    contracted (:func:`kdot`), and ``f * scale + share * rem`` rounded
    once around ``f * scale``.
    """
    dev = m.device
    f = torch.clamp_min(floors[:, None], MIN_TENANT_BUDGET)   # (K, 1)
    scale = torch.minimum(f32(1.0, dev),
                          m / torch.clamp_min(ksum(f), 1.0))  # (N,)
    f_eff = f * scale                                         # (K, N)
    rem = torch.clamp_min(m - kdot(f, scale), 0.0)
    share = (weights / ksum(weights[:, None]))[:, None]       # (K, 1)
    b0 = fma(*torch.broadcast_tensors(f, scale, share * rem))
    return f_eff, b0


def _fleet_chunk(demand, m, w, fl, gains, interval_s, *, policy,
                 priority_order):
    """The composed closed loop for one chunk of gain lanes.

    ``demand`` is ``(n_epochs, E, K, N)`` float32 bytes on the device,
    epoch-major; ``m`` the ``(N,)`` node memory; ``w``/``fl`` the
    ``(K,)`` weights and floors; ``gains`` the seven ``(G,)`` float32
    gain columns.  Epoch semantics mirror the live
    :class:`~repro_torch.fleet.plane.FleetPlane`: epoch 0 runs under
    the weight-share initial budgets; at the top of epoch ``e >= 1``
    the arbiter folds epoch ``e-1``'s mean usage into new budgets
    (``desired = usage / r0``, hit ratio 1 -- the saturated store
    misses nothing), shrunk tenants evict down to their grant at once
    (``u = min(u, B)``), and every tenant then runs Eq. 1 inside its
    grant for the epoch's ``E`` intervals.

    Returns the per-node accumulators (:func:`finalize_fleet_stats`'
    keywords), the (G, HIST_BINS) code histogram and the extras'
    ``(cons_min, floor_min, b_sum, b_min)``, still unfolded over devices:
    the arbitration is per node, so a node shard runs this on its
    columns alone.
    """
    n_epochs, ep_len, k, n_nodes = demand.shape
    dev = demand.device
    r0, lam, lam_grant, u_min, u_max, db, ff = gains
    g = r0.shape[0]

    def col(x):                                        # (G,) -> (G, 1, 1)
        return x.view(g, 1, 1)

    f_eff, b0 = _floors_and_budgets(w, fl, m)
    inv_m = f32(1.0, dev) / m
    inv_r0 = f32(1.0, dev) / r0
    thr_over = (r0 + f32(OVER_R0_EPS, dev)).view(g, 1)
    thr_settle = (r0 + f32(SETTLE_TOL, dev)).view(g, 1)
    one = f32(1.0, dev)
    inv_gib = f32(1.0 / GiB, dev)
    inv_ep_r0 = col(f32(1.0 / ep_len, dev) * inv_r0)
    r0_g, lam_g, lam_grant_g, db_g, ff_g, inv_r0_g = (
        col(x) for x in (r0, lam, lam_grant, db, ff, inv_r0))
    u_min_g, u_max_g = col(u_min), col(u_max)

    def zeros(dtype=torch.float32):
        return torch.zeros((g, n_nodes), dtype=dtype, device=dev)

    us, us_c, cs, cs_c, c2, mx = (zeros() for _ in range(6))
    n_r0, n_viol = zeros(torch.int32), zeros(torch.int32)
    last_bad = torch.full((g, n_nodes), -1, dtype=torch.int32, device=dev)
    hist = torch.zeros((g, HIST_BINS), dtype=torch.int32, device=dev)
    codes = torch.empty((g, ep_len, n_nodes), dtype=torch.uint16,
                        device=dev)
    cons_min = torch.full((g,), float("inf"), device=dev)
    floor_min = torch.full((g,), float("inf"), device=dev)
    b_sum = torch.zeros((g, k), device=dev)
    b_min = torch.full((g, k), float("inf"), device=dev)

    b = b0.expand(g, k, n_nodes)
    u = torch.minimum(u_max_g, b)
    # Seed v_prev with the first interval's usage so the slope term is
    # exactly zero before there is a previous observation.
    v_prev = demand[0, 0] + u
    usage = None
    t = 0
    for e in range(n_epochs):
        if e > 0:
            # desired = usage * inv_ep_r0, contracted into the need
            b = arbitrate(usage, m, weights=w, floors=fl,
                          priority_order=priority_order, policy=policy,
                          rr_offset=e - 1, desired_scale=inv_ep_r0)
        # Shrunk tenants evict down to the new grant at the boundary --
        # the plane's apply_capacity semantics; grown tenants let the
        # law climb.
        u = torch.minimum(u, b)
        u_max_eff = torch.minimum(u_max_g, b)
        u_min_eff = torch.minimum(u_min_g, u_max_eff)
        usage = torch.zeros_like(u)
        for j in range(ep_len):
            v = demand[e, j] + u                       # saturated store
            # The feedforward is applied to v up front, as the
            # reference does; XLA contracts it into one rounding.
            v_eff = fma(ff_g, v - v_prev, v)
            u_next = vectorized_step(
                u, v_eff, total_memory=b, r0=r0_g, lam=lam_g,
                u_min=u_min_eff, u_max=u_max_eff, lam_grant=lam_grant_g,
                deadband=db_g, inv_r0=inv_r0_g)
            v_sum = ksum(v)
            r = v_sum * inv_m                          # fleet-level (G, N)
            # XLA contracts r's product into the Kahan step's first
            # subtraction, y = r - us_c
            y = fma(v_sum, inv_m.expand_as(v_sum), -us_c)
            t_us = us + y
            us, us_c = t_us, (t_us - us) - y
            cap_gib = ksum(u_next) * inv_gib
            cs, cs_c = kahan_add(cs, cs_c, cap_gib)
            c2 = fma(cap_gib, cap_gib, c2)
            mx = torch.maximum(mx, r)
            n_r0 += r > thr_over
            n_viol += r > one
            last_bad = torch.where(r > thr_settle, t, last_bad)
            codes[:, j] = utilization_codes(r)
            usage = usage + v
            v_prev = v
            u = u_next
            t += 1
        hist_add(hist, codes)
        cons_min = torch.minimum(cons_min, (m - ksum(b)).amin(-1))
        floor_min = torch.minimum(floor_min, (b - f_eff).amin((-2, -1)))
        # node sums in float64, rounded once: one order on both devices
        b_sum = b_sum + b.sum(-1, dtype=torch.float64).to(torch.float32)
        b_min = torch.minimum(b_min, b.amin(-1))
    acc = dict(util_sum=us, util_max=mx, caps_sum_gib=cs, caps_sumsq_gib=c2,
               over_r0_count=n_r0, violation_count=n_viol, last_bad=last_bad)
    return acc, hist, (cons_min, floor_min, b_sum, b_min)


def _finalize_chunk(acc, hist, ext, r0, *, n_epochs: int, ep_len: int,
                    interval_s: float) -> Tuple[FleetStats, FleetExtras]:
    """One device's chunk: the stats and extras of its lanes."""
    dev = hist.device
    n_nodes = acc["util_sum"].shape[-1]
    n_steps = n_epochs * ep_len
    p99 = quantile_from_hist(hist, 0.99, n_steps * n_nodes)
    stats = finalize_fleet_stats(p99_utilization=p99, r0=r0,
                                 n_intervals=n_steps, interval_s=interval_s,
                                 **acc)
    return stats, _extras(*ext, n_epochs * n_nodes, dev)


def _extras(cons_min, floor_min, b_sum, b_min, n_budgets: int,
            dev) -> FleetExtras:
    inv_gib = f32(1.0 / GiB, dev)
    return FleetExtras(
        conservation_slack_gib=cons_min * inv_gib,
        floor_slack_gib=floor_min * inv_gib,
        tenant_budget_mean_gib=b_sum * inv_gib / f32(n_budgets, dev),
        tenant_budget_min_gib=b_min * inv_gib)


def _fold_row(row, results, r0, *, n_nodes: int, n_epochs: int,
              ep_len: int, interval_s: float
              ) -> Tuple[FleetStats, FleetExtras]:
    """A gain shard's chunk from its node shards' ``(acc, hist, extras)``,
    on the row's first shard.  One node shard finalizes its own nodes
    (:func:`_finalize_chunk`); several fold as JAX's mesh folds them:
    each shard's node partials, then the stats' sums and maxes, the
    histograms (read with the global count), ``cons_min``,
    ``floor_min`` and ``b_min`` by min, ``b_sum`` by sum (in float64,
    rounded once)."""
    lead = row[0]
    if len(row) == 1:
        with lead.ctx():
            return _finalize_chunk(*results[0], r0, n_epochs=n_epochs,
                                   ep_len=ep_len, interval_s=interval_s)
    parts = []
    for s, (acc, _, _) in zip(row, results):
        with s.ctx():
            parts.append(fleet_partials(**acc))
    with lead.ctx():
        parts = [{key: to_lead(lead, s, v) for key, v in p.items()}
                 for s, p in zip(row, parts)]
        hists = [to_lead(lead, s, hist) for s, (_, hist, _) in
                 zip(row, results)]
        exts = [tuple(to_lead(lead, s, x) for x in ext)
                for s, (_, _, ext) in zip(row, results)]
        n_steps = n_epochs * ep_len
        p99 = quantile_from_hist(_axis_sum(hists), 0.99, n_steps * n_nodes)
        stats = finalize_partials(parts, n_nodes=n_nodes,
                                  p99_utilization=p99, r0=r0,
                                  n_intervals=n_steps, interval_s=interval_s)
        cons_min, floor_min, b_sum, b_min = (list(x) for x in zip(*exts))
        b_sum = _axis_sum([b.double() for b in b_sum]).float()
        return stats, _extras(_axis_min(cons_min), _axis_min(floor_min),
                              b_sum, _axis_min(b_min), n_epochs * n_nodes,
                              hists[0].device)


def fleet_sweep_demand(
    demand: np.ndarray,
    gains: GainSet,
    *,
    node_memory: Union[float, np.ndarray],
    weights: np.ndarray,
    floors: np.ndarray,
    policy: str = "proportional",
    priority_order: Optional[Tuple[int, ...]] = None,
    epoch_intervals: int = 50,
    interval_s: float = 0.1,
    chunk: Optional[int] = None,
    horizon: Optional[int] = None,
    devices: DevicesLike = None,
    node_shards: int = 1,
    device: DeviceLike = None,
) -> Tuple[FleetStats, FleetExtras]:
    """Sweep a ``(K, N, T)`` per-tenant demand tensor over every gain.

    The fleet analogue of :func:`repro_torch.lab.sweep.sweep_demand`:
    ``demand[k, n, t]`` is tenant ``k``'s compute demand on node ``n``
    at interval ``t`` (bytes), ``T`` must divide into
    ``epoch_intervals``-sized arbitration epochs, and every gain point
    runs the full two-level loop.  Returns ``(G,)``-field
    :class:`~repro_torch.lab.score.FleetStats` over the *fleet-level*
    closed loop plus :class:`FleetExtras` with the arbitration
    invariants, as numpy.  ``horizon`` truncates to the first
    ``horizon`` intervals (still a whole number of epochs); ``chunk``
    bounds the gain lanes one pass carries (default
    :data:`FLEET_CHUNK`).  Runs on ``device``, the card by default.

    ``devices`` and ``node_shards`` lay the sweep out as the lab sweep's
    (:func:`~repro_torch.lab.sweep.sweep_demand`): gain shards, and node
    shards whose stats and extras fold at the chunk's end (JAX's
    ``psum``/``pmin``).  One device runs the unsharded program
    whatever ``node_shards`` says.
    """
    demand = np.asarray(demand)
    if demand.ndim != 3:
        raise ValueError("demand must be (tenants, nodes, intervals)")
    if horizon is not None:
        if not 1 <= horizon <= demand.shape[2]:
            raise ValueError(f"horizon must be in [1, {demand.shape[2]}]")
        demand = demand[:, :, :horizon]
    k, n_nodes, n_steps = demand.shape
    if epoch_intervals < 1 or n_steps % epoch_intervals:
        raise ValueError(
            f"n_intervals ({n_steps}) must divide into whole epochs of "
            f"{epoch_intervals}")
    if policy not in POLICIES:
        raise ValueError(f"policy must be one of {POLICIES}")
    weights = np.asarray(weights, np.float64)
    floors = np.asarray(floors, np.float64)
    if weights.shape != (k,) or floors.shape != (k,):
        raise ValueError("weights and floors must be (tenants,)")
    if priority_order is None:
        priority_order = tuple(range(k))
    if sorted(priority_order) != list(range(k)):
        raise ValueError("priority_order must be a permutation of tenants")
    if node_shards < 1:
        raise ValueError("node_shards must be >= 1")
    devs = resolve_devices(devices, device)
    node_shards = check_layout(devs, node_shards, n_nodes)
    n_epochs = n_steps // epoch_intervals
    # epoch-major (n_epochs, E, K, N): one interval's tenants x nodes
    # is a contiguous slice
    demand_e = np.ascontiguousarray(
        demand.transpose(2, 0, 1).reshape(n_epochs, epoch_intervals, k,
                                          n_nodes), dtype=np.float32)
    m = np.broadcast_to(np.asarray(node_memory, np.float64),
                        (n_nodes,)).astype(np.float32)
    n_real = len(gains)
    chunk = min(FLEET_CHUNK if chunk is None else max(int(chunk), 1),
                max(n_real, 1))
    run_kw = dict(interval_s=interval_s, policy=policy,
                  priority_order=tuple(int(i) for i in priority_order))
    fin_kw = dict(n_epochs=n_epochs, ep_len=epoch_intervals,
                  interval_s=interval_s)
    return _layout_sweep(demand_e, m, weights, floors, gains, devs,
                         node_shards, chunk, run_kw, fin_kw)


def _concat_host(pending, n_real: int) -> Tuple[FleetStats, FleetExtras]:
    """The chunks' ``(shard, (stats, extras))`` as numpy, each read on
    the stream that made it, concatenated in gain order and cut to the
    real gains."""
    host = []
    for shard, pair in pending:
        with shard.ctx():
            host.append([[x.cpu().numpy() for x in part] for part in pair])
    stats, extras = ([np.concatenate(f)[:n_real] for f in zip(*parts)]
                     for parts in zip(*host))
    return FleetStats(*stats), FleetExtras(*extras)


def _layout_sweep(demand_e, m, weights, floors, gains: GainSet, devs,
                  node_shards: int, chunk: int, run_kw, fin_kw
                  ) -> Tuple[FleetStats, FleetExtras]:
    """:func:`fleet_sweep_demand`'s chunk loop over a (gains x nodes)
    layout, one process driving every shard
    (:mod:`repro_torch.lab.mesh`); one device is the unsharded program.

    As the JAX package's fleet mesh: with several gain shards the chunk
    rounds up to a multiple of them and the gains pad to whole chunks by
    repeating the last one; each chunk's gains split evenly over the
    gain shards.  A node shard runs the carry on its columns (the
    arbitration is per node, so nothing crosses the shards until the
    chunk ends), and the row's first shard folds them (:func:`_fold_row`).
    """
    grid = layout(devs, node_shards)
    n_gain = len(grid)
    n_nodes = demand_e.shape[-1]
    n_real = len(gains)
    if n_gain > 1:
        chunk = -(-chunk // n_gain) * n_gain
        if n_real % chunk:
            pad = GainSet(*(np.repeat(getattr(gains, f.name)[-1:],
                                      chunk - n_real % chunk)
                            for f in dataclasses.fields(GainSet)))
            gains = gains.concat(pad)
    per = chunk // n_gain
    columns = node_columns(n_nodes, node_shards)
    staged = []          # per shard: demand, m, weights, floors, gain cols
    for row in grid:
        for s, cols in zip(row, columns):
            with s.ctx():
                staged.append((
                    torch.from_numpy(np.ascontiguousarray(
                        demand_e[..., cols])).to(s.device),
                    torch.from_numpy(m[cols]).to(s.device),
                    f32(weights.astype(np.float32), s.device),
                    f32(floors.astype(np.float32), s.device),
                    [f32(np.asarray(getattr(gains, f.name), np.float32),
                         s.device) for f in dataclasses.fields(GainSet)]))
    pending = []
    with dispatch_guard():
        for lo in range(0, len(gains), chunk):     # planecheck: hot-loop
            for g, row in enumerate(grid):
                a, b = lo + g * per, lo + (g + 1) * per
                results = []
                for j, s in enumerate(row):
                    dem, m_s, w_s, fl_s, cols = staged[g * node_shards + j]
                    with s.ctx():
                        results.append(_fleet_chunk(
                            dem, m_s, w_s, fl_s, [c[a:b] for c in cols],
                            **run_kw))
                r0 = staged[g * node_shards][4][0][a:b]
                pending.append((row[0], _fold_row(row, results, r0,
                                                  n_nodes=n_nodes,
                                                  **fin_kw)))
    return _concat_host(pending, n_real)


# ---------------------------------------------------------------------------
# The float64 reference (parity oracle)
# ---------------------------------------------------------------------------

def fleet_reference(
    demand: np.ndarray,
    gains: GainSet,
    *,
    node_memory: Union[float, np.ndarray],
    weights: np.ndarray,
    floors: np.ndarray,
    policy: str = "proportional",
    priority_order: Optional[Tuple[int, ...]] = None,
    epoch_intervals: int = 50,
    interval_s: float = 0.1,
) -> Tuple[FleetStats, FleetExtras]:
    """Scalar float64 oracle for :func:`fleet_sweep_demand`.

    Dense numpy per-gain loops, arbitration via
    :func:`~repro_torch.fleet.arbiter.arbitrate_reference` -- readable,
    exact, slow.  Stats come from
    :func:`~repro_torch.lab.score.compute_fleet_stats` on the
    materialized fleet history, so the only expected divergence from
    the batched path is float32 accumulation and the streaming
    quantile's quantization.  Test sizes only: the history is dense.
    """
    demand = np.asarray(demand, np.float64)
    k, n_nodes, n_steps = demand.shape
    if priority_order is None:
        priority_order = tuple(range(k))
    weights = np.asarray(weights, np.float64)
    floors = np.asarray(floors, np.float64)
    m = np.broadcast_to(np.asarray(node_memory, np.float64), (n_nodes,))
    n_epochs = n_steps // epoch_intervals
    f_eff = _effective_floors_np(floors, m)
    stats_rows = []
    extras_rows = []
    for g in range(len(gains)):
        r0 = float(gains.r0[g])
        lam = float(gains.lam[g])
        lam_grant = float(gains.lam_grant[g])
        u_min = float(gains.u_min[g])
        u_max = float(gains.u_max[g])
        db = float(gains.deadband[g])
        ff = float(gains.feedforward[g])
        b = _initial_budgets_np(weights, floors, m)
        u = np.minimum(u_max, b)
        v_prev = demand[:, :, 0] + u
        utils = np.empty((n_steps, n_nodes))
        caps = np.empty((n_steps, n_nodes))
        cons_min = np.inf
        floor_min = np.inf
        b_sum = np.zeros(k)
        b_min = np.full(k, np.inf)
        for e in range(n_epochs):
            if e > 0:
                lo = (e - 1) * epoch_intervals
                usage = (demand[:, :, lo:lo + epoch_intervals]
                         + u_hist[..., :]).mean(-1)
                b = arbitrate_reference(
                    usage / r0, m, weights=weights, floors=floors,
                    priority_order=priority_order, policy=policy,
                    rr_offset=(e - 1) % k)
                u = np.minimum(u, b)
            cons_min = min(cons_min, float((m - b.sum(0)).min()))
            floor_min = min(floor_min, float((b - f_eff).min()))
            b_sum += b.sum(1)
            b_min = np.minimum(b_min, b.min(1))
            u_hist = np.empty((k, n_nodes, epoch_intervals))
            for j in range(epoch_intervals):
                t = e * epoch_intervals + j
                d = demand[:, :, t]
                v = d + u
                v_eff = v + ff * (v - v_prev)
                r_t = v_eff / b
                err = r_t - r0
                lam_eff = np.where(err < 0, lam_grant, lam)
                u_max_eff = np.minimum(u_max, b)
                u_min_eff = np.minimum(u_min, u_max_eff)
                u_next = np.where(np.abs(err) <= db, u,
                                  u - lam_eff * v_eff * err / r0)
                u_next = np.clip(u_next, u_min_eff, u_max_eff)
                u_hist[:, :, j] = u
                utils[t] = v.sum(0) / m
                caps[t] = u_next.sum(0)
                v_prev = v
                u = u_next
        stats_rows.append(FleetStats(*(
            np.asarray(x) for x in compute_fleet_stats(
                utils, caps, r0=r0, interval_s=interval_s))))
        extras_rows.append(FleetExtras(
            conservation_slack_gib=cons_min / GiB,
            floor_slack_gib=floor_min / GiB,
            tenant_budget_mean_gib=b_sum / GiB / (n_epochs * n_nodes),
            tenant_budget_min_gib=b_min / GiB))
    stats = FleetStats(*(np.stack([getattr(s, f) for s in stats_rows])
                         for f in FleetStats._fields))
    extras = FleetExtras(*(np.stack([np.asarray(getattr(x, f))
                                     for x in extras_rows])
                           for f in FleetExtras._fields))
    return stats, extras


def run_fleet_sweep(scenario, gains: GainSet, *, seed: int = 0,
                    chunk: Optional[int] = None,
                    horizon: Optional[int] = None,
                    devices: DevicesLike = None, node_shards: int = 1,
                    device: DeviceLike = None
                    ) -> Tuple[FleetStats, FleetExtras]:
    """Sweep a registered (or inline) :class:`FleetScenario`.

    Resolves the scenario's per-tenant demand tensor and arbitration
    shape and hands them to :func:`fleet_sweep_demand`.
    """
    from .scenario import get_fleet_scenario
    fs = get_fleet_scenario(scenario)
    demand = fs.build_demand(seed=seed)
    return fleet_sweep_demand(
        demand, gains, node_memory=fs.node_memory_gib * GiB,
        weights=fs.weights(), floors=fs.floors_bytes(),
        policy=fs.policy, priority_order=fs.priority_order(),
        epoch_intervals=fs.epoch_intervals, interval_s=fs.interval_s,
        chunk=chunk, horizon=horizon, devices=devices,
        node_shards=node_shards, device=device)
