"""Sharded sweeps: one process drives every shard.

The counterpart of the JAX package's meshes (``_compiled_sweep`` in
``repro/lab/sweep.py``, ``_compiled_fleet_sweep`` in
``repro/fleet/sweep.py``), with JAX's single-controller semantics: no
``torch.distributed``, one Python process issues every shard's work.

* A layout is ``devices`` reshaped to ``(gain shards, node shards)``, as
  JAX reshapes its device grid (:func:`layout`).  Each entry is a
  :class:`Shard`: its device and, on a card, a CUDA stream of its own, so
  a device named twice holds two shards that run side by side.  One
  device is a 1 x 1 layout on the caller's stream: the unsharded
  program, which :func:`~repro_torch.lab.fused_sweep.fused_sweep_demand`
  runs through the same loop.
* The gain axis splits: each gain shard stages the demand once and runs
  its share of the gains in lane chunks on its own stream.  Lanes are
  independent, so this is bit-identical to one device.
* With ``node_shards > 1`` the node axis splits too: each node shard
  stages its columns of the demand, node memory and (AppGraph) work
  matrix, compiled once against the whole fleet.  The stat folds become
  collectives: each shard folds its nodes on its own device
  (:func:`~repro_torch.lab.score.fleet_partials`), and the partials and
  histograms fold over the shards in shard order on the first shard's
  device (:func:`~repro_torch.lab.score.finalize_partials`).
* AppGraph's per-interval barrier crosses the node shards.  Each shard
  runs the sweep kernel's one-interval graph entry
  (:func:`~repro_torch.kernels.sweep.graph_interval`); between launches
  the shards' (L,) lane mins fold on the first shard's stream and go
  back to every shard, ordered by events (:func:`graph_exchange`), with
  no host synchronization.

Every fold and exchange reports its bytes as an ``"all-reduce"``
(:func:`~repro_torch.kernels.count_collective`), which
:mod:`repro_torch.roofline.cost` reads.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..analysis.runtime import dispatch_guard
from ..kernels import count_collective
from ..kernels.sweep import (LVL_EMPTY, graph_interval, graph_lane_limit,
                             interval_schedule, state_names, sweep_segment)
from .score import FleetStats

__all__ = ["Shard", "check_layout", "graph_exchange", "layout",
           "mesh_sweep_demand", "node_columns", "to_lead"]


class Shard:
    """One entry of a layout: a device and, on a card, its own stream
    (``own_stream=False``: the caller's current stream)."""

    def __init__(self, device: torch.device, own_stream: bool = True):
        self.device = device
        self.stream = (torch.cuda.Stream(device)
                       if own_stream and device.type == "cuda" else None)

    def ctx(self):
        """Issue work on this shard's stream (no-op on the CPU)."""
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    def record(self) -> Optional[torch.cuda.Event]:
        if self.stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self.stream)
        return ev

    def wait(self, ev: Optional[torch.cuda.Event]) -> None:
        if self.stream is not None and ev is not None:
            self.stream.wait_event(ev)


def check_layout(devices: Sequence[torch.device], node_shards: int,
                 n_nodes: int) -> int:
    """JAX's checks of a (gains x nodes) layout; returns the node shards
    to use: one device always runs unsharded, whatever was asked."""
    if node_shards < 1:
        raise ValueError("node_shards must be >= 1")
    if len(devices) <= 1:
        return 1
    if len(devices) % node_shards:
        raise ValueError(f"devices ({len(devices)}) must divide evenly "
                         f"into node_shards={node_shards}")
    if n_nodes % node_shards:
        raise ValueError(f"n_nodes ({n_nodes}) must be divisible by "
                         f"node_shards={node_shards}")
    return node_shards


def layout(devices: Sequence[torch.device],
           node_shards: int) -> List[List[Shard]]:
    """``devices`` as ``(gain shards, node shards)`` of :class:`Shard`,
    row-major as JAX's ``devices.reshape(-1, node_shards)``.  One device
    is one shard on the caller's stream: the unsharded program."""
    shards = [Shard(d, own_stream=len(devices) > 1) for d in devices]
    return [shards[i:i + node_shards]
            for i in range(0, len(shards), node_shards)]


def to_lead(lead: Shard, shard: Shard, x: torch.Tensor) -> torch.Tensor:
    """``x``, made on ``shard``'s stream, on ``lead``'s device and ordered
    before ``lead``'s later work.  Call inside ``lead.ctx()``."""
    if shard is lead:
        return x
    with shard.ctx():
        y = x.to(lead.device, non_blocking=True)
    lead.wait(shard.record())
    if y is x and lead.stream is not None:
        x.record_stream(lead.stream)      # read on lead's stream too
    return y


def _from_lead(lead: Shard, shard: Shard, x: torch.Tensor,
               ev: Optional[torch.cuda.Event],
               out: Optional[torch.Tensor]) -> torch.Tensor:
    """``x`` (lead's, recorded by ``ev``) for ``shard``'s next launch:
    read in place on the lead's device, copied into ``out`` on another.
    A copy between devices runs on the source device's current stream,
    so it is issued on ``lead``'s, which made ``x`` and frees it; the
    destination's stream waits for the copy."""
    shard.wait(ev)
    if shard.device == lead.device:
        return x
    with lead.ctx(), shard.ctx():
        out.copy_(x, non_blocking=True)
    return out


def graph_exchange(shards: Sequence[Shard], states, hists, demands, lp,
                   rows, alives, graphs, *, t0: int, con, names
                   ) -> None:
    """A segment of the AppGraph carry with a lane's nodes over
    ``shards``: every shard's launches of
    :func:`~repro_torch.kernels.sweep.interval_schedule`, the lane mins
    folded between them on the first shard's stream.

    ``states`` and ``hists`` (each shard's (S, L, N_s) state and (L,
    HIST_BINS) histogram, contiguous) are updated in place; ``demands``,
    ``rows``, ``alives`` and ``graphs`` are each shard's segment
    operands, ``lp`` each shard's lane pack (the same lanes).
    """
    lead = shards[0]
    t_seg = demands[0].shape[0]
    n_lanes = lp[0].shape[1]
    # one row per fold: launch k folds into row k, launch k + 1 reads it
    lvls, fleets = [], []
    for s in shards:
        with s.ctx():
            lvls.append(torch.full((t_seg + 1, n_lanes), LVL_EMPTY,
                                   dtype=torch.int32, device=s.device))
            fleets.append(None if s.device == lead.device else
                          torch.empty((t_seg + 1, n_lanes), dtype=torch.int32,
                                      device=s.device))
    with lead.ctx():
        fold = torch.empty((t_seg + 1, n_lanes), dtype=torch.int32,
                           device=lead.device)
    for s in shards[1:]:
        if s.device == lead.device and s.stream is not None:
            fold.record_stream(s.stream)  # read in place on s's stream
    fleet_in: List[Optional[torch.Tensor]] = [None] * len(shards)
    for k, mode in interval_schedule(t_seg):    # planecheck: hot-loop
        for i, s in enumerate(shards):
            with s.ctx():
                graph_interval(states[i], hists[i], demands[i], lp[i],
                               rows[i], alives[i], k=k, t0=t0, con=con,
                               names=names, graph=graphs[i],
                               fleet_in=fleet_in[i],
                               out=lvls[i][k] if k <= t_seg else None,
                               mode=mode)
        if k > t_seg:
            break
        with lead.ctx():
            mins = [to_lead(lead, s, lvls[i][k])
                    for i, s in enumerate(shards)]
            count_collective("all-reduce", mins)
            torch.amin(torch.stack(mins), 0, out=fold[k])
            ev = lead.record()
        fleet_in = [_from_lead(lead, s, fold[k], ev,
                               None if fleets[i] is None else fleets[i][k])
                    for i, s in enumerate(shards)]


def node_columns(n_nodes: int, node_shards: int) -> List[slice]:
    """Each node shard's columns of the fleet, in order."""
    cols = n_nodes // node_shards
    return [slice(j * cols, (j + 1) * cols) for j in range(node_shards)]


@dataclasses.dataclass
class _NodeShard:
    """One node shard's staged operands for one gain shard."""

    shard: Shard
    demand_tn: torch.Tensor
    np_rows: torch.Tensor
    lp: torch.Tensor
    alive: torch.Tensor
    graph: Optional[Tuple[torch.Tensor, torch.Tensor]]


def _stage_node_shard(shard: Shard, demand, lanes, n_live: int,
                      node_memory, cols: slice, cache, precision, host_graph
                      ) -> _NodeShard:
    from .fused_sweep import _alive, _stage
    n_nodes = demand.shape[0]
    m = np.broadcast_to(np.asarray(node_memory, np.float64), (n_nodes,))
    with shard.ctx():
        demand_tn, np_rows, lp = _stage(demand[cols], lanes, m[cols], cache,
                                        precision, shard.device)
        graph = None
        if host_graph is not None:
            work, stage, _ = host_graph
            graph = (torch.from_numpy(np.ascontiguousarray(work[:, cols]))
                     .to(shard.device),
                     torch.from_numpy(stage).to(shard.device))
        alive = _alive(len(lanes), n_live, shard.device)
    return _NodeShard(shard, demand_tn, np_rows, lp, alive, graph)


def _node_sharded_chunk(nodes: Sequence[_NodeShard], lo: int, hi: int, con,
                        names, n_nodes: int, total_work) -> FleetStats:
    """One lane chunk over every node shard of a gain shard: the kernel
    on each shard's columns, then the folds on the first shard."""
    from .fused_sweep import (_finalize_parts, _init_state, _lane_partials,
                              _zero_hist)
    operands = []
    for nd in nodes:
        with nd.shard.ctx():
            lp = nd.lp[:, lo:hi].contiguous()
            alive = nd.alive[:, lo:hi].contiguous()
            state = _init_state(lp, nd.np_rows, nd.demand_tn[0].float(), con,
                                names, nd.graph)
            operands.append((state, _zero_hist(lp), lp, alive))
    if con.has_graph:
        states = [o[0] for o in operands]
        hists = [o[1] for o in operands]
        graph_exchange([nd.shard for nd in nodes], states, hists,
                       [nd.demand_tn for nd in nodes],
                       [o[2] for o in operands], [nd.np_rows for nd in nodes],
                       [o[3] for o in operands], [nd.graph for nd in nodes],
                       t0=0, con=con, names=names)
        results = list(zip(states, hists))
    else:
        results = []
        for nd, (state, hist, lp, alive) in zip(nodes, operands):
            with nd.shard.ctx():
                results.append(sweep_segment(
                    state, hist, nd.demand_tn, lp, nd.np_rows, alive, t0=0,
                    con=con, names=names))
    parts, hists = [], []
    for nd, (state, hist) in zip(nodes, results):
        with nd.shard.ctx():
            parts.append(_lane_partials(state, con, names))
        hists.append(hist)
    lead = nodes[0].shard
    with lead.ctx():
        parts = [{key: to_lead(lead, nd.shard, v) for key, v in p.items()}
                 for nd, p in zip(nodes, parts)]
        hists = [to_lead(lead, nd.shard, h) for nd, h in zip(nodes, hists)]
        return _finalize_parts(parts, hists, operands[0][2], con, n_nodes,
                               nodes[0].demand_tn.shape[0], total_work)


def mesh_sweep_demand(demand: np.ndarray, gains, *, devices, node_shards: int,
                      node_memory, interval_s: float = 0.1,
                      occupancy: float = 1.0, chunk: Optional[int] = None,
                      cache=None, app_graph=None,
                      horizon: Optional[int] = None,
                      precision: str = "f32") -> FleetStats:
    """:func:`~repro_torch.lab.sweep.sweep_demand` over a layout of
    ``devices`` (see the module docstring); one device runs the
    unsharded program, whatever ``node_shards`` says."""
    from .fused_sweep import (LANE_TILE, _check_args, _engine_consts,
                              _graph_host, _pad_gains, _sweep_program,
                              _to_host, by_law_class)
    from .sweep import _resolve_chunk, plan_specialization

    demand = _check_args(np.asarray(demand), cache, occupancy, precision,
                         horizon)
    merged = by_law_class(gains, lambda part: mesh_sweep_demand(
        demand, part, devices=devices, node_shards=node_shards,
        node_memory=node_memory, interval_s=interval_s,
        occupancy=occupancy, chunk=chunk, cache=cache, app_graph=app_graph,
        precision=precision))
    if merged is not None:
        return merged
    n_nodes = demand.shape[0]
    node_shards = check_layout(devices, node_shards, n_nodes)
    grid = layout(devices, node_shards)
    n_real = len(gains)
    per_shard = -(-n_real // len(grid))
    plan = plan_specialization(gains, occupancy)
    con = _engine_consts(plan, cache, interval_s, occupancy, precision,
                         app_graph)
    names = state_names(con.paper_law, con.has_cache, con.has_graph)
    host_graph = (None if app_graph is None
                  else _graph_host(app_graph, n_nodes))
    total_work = None if host_graph is None else host_graph[2]
    columns = node_columns(n_nodes, node_shards)
    n_cols = n_nodes // node_shards
    staged = []                     # (gain shard, real lanes, chunk, nodes)
    for g, row in enumerate(grid):
        lanes = gains.slice(g * per_shard, min((g + 1) * per_shard, n_real))
        if not len(lanes):
            continue
        lane_chunk = _resolve_chunk(chunk, len(lanes), n_cols)
        lane_chunk = -(-lane_chunk // LANE_TILE) * LANE_TILE
        if (con.has_graph and node_shards == 1
                and row[0].device.type == "cuda"):
            limit = graph_lane_limit(con, n_nodes, row[0].device,
                                     host_graph[1].shape[1])
            lane_chunk = lane_chunk if limit is None \
                else min(lane_chunk, limit)
        padded = _pad_gains(lanes, lane_chunk)
        staged.append((row[0], len(lanes), lane_chunk, [
            _stage_node_shard(s, demand, padded, len(lanes), node_memory,
                              cols, cache, precision, host_graph)
            for s, cols in zip(row, columns)]))
    pending = []                    # per gain shard: its lane chunks' stats
    with dispatch_guard():
        for lead, _, lane_chunk, nodes in staged:  # planecheck: hot-loop
            chunks = []
            for lo in range(0, nodes[0].lp.shape[1], lane_chunk):
                hi = lo + lane_chunk
                if node_shards > 1:
                    chunks.append(_node_sharded_chunk(
                        nodes, lo, hi, con, names, n_nodes, total_work))
                    continue
                nd = nodes[0]
                with nd.shard.ctx():
                    chunks.append(_sweep_program(
                        nd.demand_tn, nd.np_rows,
                        nd.lp[:, lo:hi].contiguous(),
                        nd.alive[:, lo:hi].contiguous(), con, names,
                        nd.graph, total_work))
            pending.append(chunks)
    out = []
    for (lead, n_live, _, _), chunks in zip(staged, pending):
        with lead.ctx():
            host = [_to_host(st) for st in chunks]
        out.append([np.concatenate(f)[:n_live] for f in zip(*host)])
    return FleetStats(*(np.concatenate(f) for f in zip(*out)))
