"""The fused sweep step: the CUDA kernel's wrapper and its plain version.

Replaces the TPU kernel ``_sweep_kernel`` of
``repro/lab/pallas_sweep.py`` (launched by ``_segment``; its step math
is ``_fused_step``).  One call advances every (gain lane, node) closed
loop over a demand segment ``[t0, t0 + T)``: Eq. 1 with the optional
feedforward, asymmetric gain and deadband, the CacheLoop carry, the
Kahan / count / max accumulators, and each lane's p99 histogram, which
counts every update's ``uint16`` utilization code as ``code >> 4`` in
:data:`~repro_torch.lab.score.HIST_BINS` int32 bins.  It returns the
``(S, L, N)`` float32 state and the ``(L, HIST_BINS)`` histogram; both
are accumulators, handed in and returned anew, never updated in place.

* :func:`sweep_segment` dispatches on where the tensors lie: CPU
  tensors take :func:`sweep_segment_plain`; CUDA tensors launch the
  kernel in ``csrc/sweep.cu`` (built at first use by
  :mod:`repro_torch.kernels._build`) or raise.  Nothing falls back.
* :func:`sweep_segment_plain` is a Python loop over t of
  :func:`fused_step`, which mirrors the reference's ``_fused_step`` op
  for op in float32, and bins each interval's codes with
  :func:`~repro_torch.lab.score.hist_add`.
* :data:`LAUNCHES` counts kernel launches, and only those.

**AppGraph.**  With a scenario's stage DAG (``graph=``: the ``(S+1, N)``
work matrix and the ``(2, S+1)`` stage-demand and barrier rows of
:func:`~repro_torch.lab.appgraph.compile_graph`), five more planes carry
the queue/barrier state of the reference's XLA scan
(``repro/lab/sweep.py``): the stage row ``sidx`` (a float holding a
small integer exactly), the work left ``wleft``, the Kahan work done
``wd``/``wd_c``, and ``t_done``, the lane's finish interval (held in
every node of the lane: all nodes agree on it).  Each interval the
active row's held demand joins the observed demand before the law sees
it, the queue drains ``comp_itv * (interval_s / dt_eff)``, and a barrier
row promotes once the lane-wide min of ``2 * sidx + fin`` says every
node finished it.  On the card the lane-wide min is a block reduction
when one block holds the lane, and a per-lane barrier between blocks
(a cooperative launch) when it does not.  Without the cache ``dt_eff``
is the interval stretched by the pressure curve in the form XLA compiles
it (:func:`hpl_slowdown_fused`); with it, the CacheLoop's ``dt_app``.

**On the card.**  A thread owns the (lane, node) loops of two nodes (one
with the cache) and keeps their state in registers for the whole
segment: state is read from ``(S, L, N)`` once and written once.  Each
step reads ``demand[t, n]`` (coalesced along n, loaded a few intervals
ahead; every lane rereads the same row, which stays in L2) and adds one
to its lane's histogram in shared memory; a block (one lane, 256 nodes,
or 128 with the cache) adds its histogram to the lane's row in device
memory once, at exit.  So the kernel moves only the demand, the state
and 16 KB of histogram per lane, and is bound by operations.  The TPU
grid's sequential time axis becomes the loop inside the thread, since
Hopper blocks carry no state to each other.  The law/cache/bf16
branches are template parameters, as they were trace-time branches.

**Parity.**  The kernel is compiled with ``-fmad=false``, so each
product and sum rounds where the plain version's separate ops round.
The five multiply-adds the reference's XLA build contracts (the
occupancy and feedforward terms, the error, the update, the sum of
squares) are rounded once on both sides: hardware FMAs in the kernel,
``core.control.fma`` here.  The hit-curve power runs in float64 on
both sides (:func:`_fast_pow`).  The cache-off path is bit-identical,
histogram included (integer counts commute); the cache path is held at
1e-6 relative, the room left for the two float64 ``exp2``/``log2``
builds disagreeing across a float32 rounding boundary.  A lane whose
``alive`` is 0 leaves its state and its histogram row unchanged (the
reference skips whole 8-lane tiles; padding lanes never reach a result
either way).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.control import GiB, f32, fma, vectorized_step
from ..lab.score import (HIST_BINS, hist_add, hpl_slowdown_curve, kahan_add,
                          utilization_codes)

# Rows of the packed per-lane parameter matrix (P, L).  The derived
# rows (reciprocal, thresholds) are float32 host arithmetic.
_R0, _LAM, _LAM_GRANT, _U_MIN, _U_MAX, _DB, _FF = range(7)
_INV_R0, _THR_OVER, _THR_SETTLE = 7, 8, 9
N_PARAM_ROWS = 10

# Rows of the packed per-node constant matrix (R, N).
_M, _INV_M, _W, _INV_W = range(4)
N_NODE_ROWS = 4

# float32-exact module constants.
_INV_GIB = float(np.float32(1.0 / GiB))
_GIB_F32 = float(np.float32(GiB))

# Rows of the (2, S+1) per-stage-row constants of an AppGraph launch.
_STAGE_DEMAND, _STAGE_BARRIER = range(2)
N_STAGE_CONST_ROWS = 2

# The pressure curve's slopes as XLA compiles them: it folds ``/ 0.06 *
# 0.35`` and ``/ 0.02 * 2.65`` into one multiply each (float32 constants)
# and contracts each segment's multiply-add into an FMA.
_SLOPE_1 = float(np.float32(5.83333349))
_SLOPE_2 = 132.5

# Kernel launches since import (or since a caller reset it).
LAUNCHES = 0


def state_names(paper_law: bool, has_cache: bool,
                has_graph: bool = False) -> Tuple[str, ...]:
    """Plane order of the stacked (S, L, N) state block.

    ``csrc/sweep.cu`` reads and writes the planes in this order.
    """
    names = ["u"]
    if not paper_law:
        names.append("v_prev")
    if has_cache:
        names.append("resident")
    names += ["us", "us_c", "cs", "cs_c", "c2", "mx",
              "n_r0", "n_viol", "last_bad"]
    if has_cache:
        names += ["hs", "hs_c", "es", "es_c", "ts", "ts_c"]
    if has_graph:
        names += ["sidx", "wleft", "wd", "wd_c", "t_done"]
    return tuple(names)


def hpl_slowdown_fused(r: torch.Tensor, k: "_Lifted") -> torch.Tensor:
    """The Fig.-2 multiplier as the reference's XLA scan computes it.

    :func:`~repro_torch.lab.score.hpl_slowdown_curve` divides as the
    source reads; XLA multiplies by the folded slopes and rounds each
    segment's multiply-add once, which the AppGraph carry's cache-off
    ``dt_eff`` follows so its queue drains by the reference's bits.
    """
    u = torch.minimum(torch.maximum(r, k.zero), k.u_cap)
    seg1 = fma(u - k.knee1, k.slope1, k.one)
    seg2 = fma(u - k.knee2, k.slope2, k.base2)
    seg3 = fma(u - k.one, k.slope3, k.base3)
    return torch.where(u <= k.knee1, k.one,
                       torch.where(u <= k.knee2, seg1,
                                   torch.where(u <= k.one, seg2, seg3)))


def warm_fraction0(cols: torch.Tensor, rows: torch.Tensor, con):
    """Warm-seeded resident set and working-set fraction per (lane, node)."""
    res0 = f32(con.warm_frac, cols.device) * torch.minimum(cols[_U_MAX],
                                                          rows[_W])
    return res0, res0 * rows[_INV_W]


class _Lifted:
    """The engine constants as float32 tensors on one device.

    Lifted once per segment so the step loop does no host-to-device
    copies.
    """

    def __init__(self, con, device: torch.device):
        def c(x):
            return f32(x, device)
        self.one = c(1.0)
        self.inv_gib = c(_INV_GIB)
        self.occupancy = c(con.occupancy)
        if con.has_graph:
            self.interval_s = c(con.interval_s)
            self.comp_itv = c(con.comp_itv)
            self.zero = c(0.0)
            self.u_cap = c(1.5)
            self.knee1, self.knee2 = c(0.92), c(0.98)
            self.slope1, self.slope2, self.slope3 = (c(_SLOPE_1), c(_SLOPE_2),
                                                     c(300.0))
            self.base2, self.base3 = c(1.35), c(4.0)
        if con.has_cache:
            self.gib = c(_GIB_F32)
            self.conc = c(con.conc)
            self.one_minus_conc = c(1.0 - con.conc)
            self.hit_exp = c(con.hit_exp)
            self.tiny = c(1e-30)
            self.interval_s = c(con.interval_s)
            self.miss_pen = c(con.miss_pen)
            self.evict_pen = c(con.evict_pen)
            self.access_g = c(con.access_g)
            self.refill_b = c(con.refill_b)
            self.cold_mix = c(con.cold_mix)


def _fast_pow(x: torch.Tensor, e: float, k: _Lifted) -> torch.Tensor:
    """``x ** e`` for x in [0, 1] via exp2/log2, exact at e in {0, 1}.

    The reference's ``exp2(e * log2(max(x, 1e-30)))``, evaluated in
    float64 and rounded once to float32.  In float32 the last bit of
    ``exp2``/``log2`` depends on the implementation: CUDA's differs from
    the kernel's, and on the CPU PyTorch's vectorized body differs from
    its scalar tail, so a lane's result would depend on where it sits
    in the block.  In float64 those differences lie far below the one
    float32 rounding.
    """
    if e == 1.0:
        return x
    if e == 0.0:
        return torch.ones_like(x)
    x64 = torch.maximum(x, k.tiny).double()
    return torch.exp2(k.hit_exp.double() * torch.log2(x64)).float()


def fused_step(state: Tuple[torch.Tensor, ...], d: torch.Tensor, t: int,
               cols: torch.Tensor, rows: torch.Tensor, wf0, con,
               names: Tuple[str, ...], ix: Dict[str, int], k: _Lifted,
               graph: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """One closed-loop interval on a tuple of (L, N) state planes.

    ``cols[row]`` are lane parameters of shape (L, 1) and ``rows[row]``
    node constants of shape (N,); ``graph`` is the AppGraph's (work,
    stage constants) pair when ``con.has_graph``.  Returns the new
    planes (in ``names`` order) and the interval's (L, N) ``uint16``
    codes, which the caller bins into its histogram.
    """
    if con.has_graph:
        # An active stage holds its declared bytes: the law observes
        # demand including them.
        work, stage = graph
        sidx = state[ix["sidx"]]
        row = sidx.long()
        d = d + stage[_STAGE_DEMAND][row]
    u = state[ix["u"]]
    if con.has_cache:
        resident = state[ix["resident"]]
        v = d + resident
    elif con.unit_occupancy:
        v = d + u
    else:
        v = fma(k.occupancy, u, d)
    if con.paper_law:
        v_eff = v
    else:
        v_eff = fma(cols[_FF], v - state[ix["v_prev"]], v)
    u_next = vectorized_step(
        u, v_eff, total_memory=rows[_M], r0=cols[_R0], lam=cols[_LAM],
        u_min=cols[_U_MIN], u_max=cols[_U_MAX],
        lam_grant=None if con.paper_law else cols[_LAM_GRANT],
        deadband=0.0 if con.paper_law else cols[_DB],
        inv_total_memory=rows[_INV_M], inv_r0=cols[_INV_R0])
    r = v * rows[_INV_M]
    tf = float(t)
    us, us_c = kahan_add(state[ix["us"]], state[ix["us_c"]], r)
    cap_gib = u_next * k.inv_gib
    cs, cs_c = kahan_add(state[ix["cs"]], state[ix["cs_c"]], cap_gib)
    out = {
        "u": u_next,
        "us": us, "us_c": us_c, "cs": cs, "cs_c": cs_c,
        "c2": fma(cap_gib, cap_gib, state[ix["c2"]]),
        "mx": torch.maximum(state[ix["mx"]], r),
        "n_r0": state[ix["n_r0"]] + (r > cols[_THR_OVER]).float(),
        "n_viol": state[ix["n_viol"]] + (r > k.one).float(),
        "last_bad": torch.where(r > cols[_THR_SETTLE], tf,
                                state[ix["last_bad"]]),
    }
    if not con.paper_law:
        out["v_prev"] = v
    if con.has_cache:
        res_ev = torch.minimum(resident, u_next)
        ev_g = (resident - res_ev) * k.inv_gib
        f = torch.minimum(res_ev * rows[_INV_W], k.one)
        hit = k.conc * _fast_pow(f, con.hit_exp, k) + k.one_minus_conc * f
        scanned = float(np.float32(t) * np.float32(con.access_b))
        wf = torch.minimum(wf0, f)
        hit = torch.where(rows[_W] > scanned,
                          wf + k.cold_mix * (hit - wf), hit)
        miss_g = (k.one - hit) * k.access_g
        target = torch.minimum(u_next, rows[_W])
        out["resident"] = torch.minimum(
            target, res_ev + torch.minimum(miss_g * k.gib, k.refill_b))
        dt_app = (k.interval_s * hpl_slowdown_curve(r)
                  + miss_g * k.miss_pen + ev_g * k.evict_pen)
        hs, hs_c = kahan_add(state[ix["hs"]], state[ix["hs_c"]],
                             hit * k.access_g)
        es, es_c = kahan_add(state[ix["es"]], state[ix["es_c"]], ev_g)
        ts, ts_c = kahan_add(state[ix["ts"]], state[ix["ts_c"]], dt_app)
        out.update(hs=hs, hs_c=hs_c, es=es, es_c=es_c, ts=ts, ts_c=ts_c)
    if con.has_graph:
        # The queue drains interval_s / dt_eff of its nominal progress;
        # a barrier row promotes when the lane-wide min of the progress
        # code 2 * row + fin says every node finished it.
        n_rows = stage.shape[1] - 1
        dt_eff = dt_app if con.has_cache \
            else k.interval_s * hpl_slowdown_fused(r, k)
        active = sidx < n_rows
        wleft = state[ix["wleft"]]
        adv = torch.where(active, k.comp_itv * (k.interval_s / dt_eff),
                          k.zero)
        wd, wd_c = kahan_add(state[ix["wd"]], state[ix["wd_c"]],
                             torch.minimum(adv, wleft))
        wleft = torch.maximum(wleft - adv, k.zero)
        fin = active & (wleft <= k.zero)
        fleet_lvl = (sidx * 2 + fin.float()).amin(-1, keepdim=True)
        can = fin & ((stage[_STAGE_BARRIER][row] == k.zero)
                     | (fleet_lvl >= sidx * 2 + 1))
        sidx = sidx + can.float()
        wleft = torch.where(can, work.gather(0, sidx.long()), wleft)
        done_all = sidx.amin(-1, keepdim=True) >= n_rows
        t_done = torch.where((state[ix["t_done"]] < 0) & done_all,
                             float(t + 1), state[ix["t_done"]])
        out.update(sidx=sidx, wleft=wleft, wd=wd, wd_c=wd_c, t_done=t_done)
    return tuple(out[n] for n in names), utilization_codes(r)


def _check(state, hist, demand_seg, lp, np_rows, alive, t0, con,
           names, graph) -> None:
    """Shapes, types and layout the kernel (and its plain version) take."""
    if names != state_names(con.paper_law, con.has_cache, con.has_graph):
        raise ValueError(f"state planes {names} do not match the kernel's "
                         f"layout for paper_law={con.paper_law}, "
                         f"has_cache={con.has_cache}, "
                         f"has_graph={con.has_graph}")
    if (graph is not None) != con.has_graph:
        raise ValueError("the graph operands (work, stage) go with "
                         "has_graph, and only with it")
    if con.has_cache and not con.unit_occupancy:
        raise ValueError("cache modeling needs occupancy == 1.0")
    if demand_seg.ndim != 2 or demand_seg.shape[0] < 1:
        raise ValueError(f"demand segment must be (T>=1, N); got "
                         f"{tuple(demand_seg.shape)}")
    t_seg, n_nodes = demand_seg.shape
    if (t0 + t_seg) * n_nodes >= 2**31:
        raise ValueError(f"{t0 + t_seg} intervals x {n_nodes} nodes can "
                         f"overflow a lane's int32 histogram counts")
    n_lanes = lp.shape[-1]
    want = {
        "state": (state, (len(names), n_lanes, n_nodes), torch.float32),
        "hist": (hist, (n_lanes, HIST_BINS), torch.int32),
        "lp": (lp, (N_PARAM_ROWS, n_lanes), torch.float32),
        "np_rows": (np_rows, (N_NODE_ROWS, n_nodes), torch.float32),
        "alive": (alive, (1, n_lanes), torch.float32),
    }
    if graph is not None:
        work, stage = graph
        n_rows = stage.shape[-1] - 1
        if stage.ndim != 2 or n_rows < 1:
            raise ValueError(f"stage constants must be ({N_STAGE_CONST_ROWS}"
                             f", S+1) with S >= 1; got {tuple(stage.shape)}")
        want["stage"] = (stage, (N_STAGE_CONST_ROWS, n_rows + 1),
                         torch.float32)
        want["work"] = (work, (n_rows + 1, n_nodes), torch.float32)
        if (n_rows + 1) * n_nodes >= 2**31:
            raise ValueError(f"a work matrix of {n_rows + 1} x {n_nodes} "
                             f"overflows the kernel's int32 offsets")
    dem_dtype = torch.bfloat16 if con.precision == "bf16" else torch.float32
    if demand_seg.dtype != dem_dtype:
        raise ValueError(f"demand must be {dem_dtype} for precision="
                         f"{con.precision!r}; got {demand_seg.dtype}")
    for name, (x, shape, dtype) in want.items():
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} of shape {shape}; got "
                             f"{x.dtype} of shape {tuple(x.shape)}")
        if x.device != demand_seg.device:
            raise ValueError(f"{name} is on {x.device}, demand on "
                             f"{demand_seg.device}")


def sweep_segment_plain(state, hist, demand_seg, lp, np_rows, alive, *,
                        t0: int, con, names: Tuple[str, ...], graph=None):
    """The plain PyTorch version of the kernel, on any device."""
    _check(state, hist, demand_seg, lp, np_rows, alive, t0, con, names,
           graph)
    ix = {n: i for i, n in enumerate(names)}
    k = _Lifted(con, state.device)
    cols = lp[:, :, None]
    wf0 = warm_fraction0(cols, np_rows, con)[1] if con.has_cache else None
    st = tuple(state.unbind(0))
    counts = torch.zeros_like(hist)
    for i in range(demand_seg.shape[0]):
        st, codes = fused_step(st, demand_seg[i].float(), t0 + i, cols,
                               np_rows, wf0, con, names, ix, k, graph)
        hist_add(counts, codes)
    live = alive[0] > 0.5
    out = torch.where(live[None, :, None], torch.stack(st), state)
    return out, torch.where(live[:, None], hist + counts, hist)


class _SweepConsts(ctypes.Structure):
    """``struct SweepConsts`` of ``csrc/sweep.cu``, field for field."""

    _fields_ = [(name, ctypes.c_float) for name in (
        "occupancy", "interval_s", "conc", "one_minus_conc", "hit_exp",
        "miss_pen", "evict_pen", "access_g", "refill_b", "access_b",
        "cold_mix", "warm_frac")] + [("pow_mode", ctypes.c_int)]


def _consts(con) -> _SweepConsts:
    def c(x):
        return float(np.float32(x))
    pow_mode = 1 if con.hit_exp == 1.0 else 2 if con.hit_exp == 0.0 else 0
    return _SweepConsts(
        c(con.occupancy), c(con.interval_s), c(con.conc),
        c(1.0 - con.conc), c(con.hit_exp), c(con.miss_pen),
        c(con.evict_pen), c(con.access_g), c(con.refill_b),
        c(con.access_b), c(con.cold_mix), c(con.warm_frac), pow_mode)


# Threads per block of csrc/sweep.cu (kThreads), and the loops a thread
# runs: two nodes without the cache, one with it.
KERNEL_THREADS = 128


def block_nodes(has_cache: bool) -> int:
    """Nodes one block of the kernel holds (one lane's slice)."""
    return KERNEL_THREADS * (1 if has_cache else 2)


def coresident_lanes(n_nodes: int, has_cache: bool, blocks_per_sm: int,
                     n_sms: int) -> Optional[int]:
    """Most lanes one AppGraph launch may hold, or None for no limit.

    A lane that one block holds needs no barrier between blocks, so any
    number of its lanes may wait for the card.  A lane spread over
    several blocks meets at a barrier every interval, so every block of
    the launch must be resident at once: at most ``blocks_per_sm *
    n_sms`` blocks in all.  Raises when not even one lane fits.
    """
    per_lane = -(-n_nodes // block_nodes(has_cache))
    if per_lane == 1:
        return None
    lanes = blocks_per_sm * n_sms // per_lane
    if lanes < 1:
        raise ValueError(f"an AppGraph lane of {n_nodes} nodes needs "
                         f"{per_lane} co-resident blocks; the card holds "
                         f"{blocks_per_sm} x {n_sms}")
    return lanes


def instance_resources(paper_law: bool, unit_occupancy: bool,
                       has_cache: bool, bf16: bool, has_graph: bool,
                       lib=None) -> Tuple[int, int, int]:
    """(registers, static shared bytes, blocks per SM at KERNEL_THREADS)
    of one template instance, from the CUDA runtime."""
    if lib is None:
        from ._build import load_library
        lib = load_library().lib
    fn = lib.dynims_sweep_resources
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 3)()
    rc = fn(int(paper_law), int(unit_occupancy), int(has_cache), int(bf16),
            int(has_graph), ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {rc}")
    return out[0], out[1], out[2]


def graph_lane_limit(con, n_nodes: int,
                     device: torch.device) -> Optional[int]:
    """:func:`coresident_lanes` for the graph instance on ``device``."""
    if -(-n_nodes // block_nodes(con.has_cache)) == 1:
        return None
    blocks_per_sm = instance_resources(
        con.paper_law, con.unit_occupancy, con.has_cache,
        con.precision == "bf16", True)[2]
    n_sms = torch.cuda.get_device_properties(device).multi_processor_count
    return coresident_lanes(n_nodes, con.has_cache, blocks_per_sm, n_sms)


def _launch(state, hist, demand_seg, lp, np_rows, alive, *, t0: int, con,
            names: Tuple[str, ...], graph=None):
    from ._build import load_library

    _check(state, hist, demand_seg, lp, np_rows, alive, t0, con, names,
           graph)
    t_seg, n_nodes = demand_seg.shape
    n_lanes = lp.shape[1]
    if n_lanes > 65535:
        raise ValueError("at most 65535 gain lanes per launch")
    operands = [x.contiguous() for x in (demand_seg, lp, np_rows, alive,
                                         state)]
    state_out = torch.empty(state.shape, dtype=torch.float32,
                            device=state.device)
    hist_out = hist.clone(memory_format=torch.contiguous_format)
    consts = _consts(con)
    graph_ptrs, n_rows, comp_itv = [0, 0, 0], 0, 0.0
    if graph is not None:
        work, stage = (x.contiguous() for x in graph)
        # the per-lane barrier's arrivals, generation and two min slots,
        # zeroed for the launch (used when several blocks hold a lane)
        ws = torch.zeros((n_lanes, 4), dtype=torch.int32,
                         device=state.device)
        graph_ptrs = [work.data_ptr(), stage.data_ptr(), ws.data_ptr()]
        n_rows, comp_itv = stage.shape[1] - 1, con.comp_itv
    lib = load_library().lib
    rc = lib.dynims_sweep_segment(
        int(con.paper_law), int(con.unit_occupancy), int(con.has_cache),
        int(con.precision == "bf16"), int(con.has_graph),
        *(x.data_ptr() for x in operands), state_out.data_ptr(),
        hist_out.data_ptr(), *graph_ptrs, t_seg, n_lanes, n_nodes, int(t0),
        n_rows, comp_itv, ctypes.byref(consts),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sweep kernel launch failed: CUDA error {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return state_out, hist_out


def sweep_segment(state, hist, demand_seg, lp, np_rows, alive, *, t0: int,
                  con, names: Tuple[str, ...], graph=None):
    """Advance every lane over ``demand_seg``; returns (state, hist).

    ``state`` is (S, L, N) float32, ``hist`` the (L, HIST_BINS) int32
    counts so far (zeros at the horizon's start), ``demand_seg`` (T, N)
    float32 or bfloat16 (per ``con.precision``), ``lp`` the (10, L)
    lane pack, ``np_rows`` the (4, N) node pack and ``alive`` the
    (1, L) mask; ``t0`` is the segment's first interval.  With
    ``con.has_graph``, ``graph`` is the AppGraph's (work (S+1, N), stage
    constants (2, S+1)) pair, float32 on the same device.  CPU tensors
    run :func:`sweep_segment_plain`; CUDA tensors launch the kernel.
    Any other device raises.
    """
    if state.device.type == "cpu":
        return sweep_segment_plain(state, hist, demand_seg, lp, np_rows,
                                   alive, t0=t0, con=con, names=names,
                                   graph=graph)
    if state.device.type != "cuda":
        raise ValueError(f"sweep_segment runs on cpu or cuda, not "
                         f"{state.device}")
    return _launch(state, hist, demand_seg, lp, np_rows, alive, t0=t0,
                   con=con, names=names, graph=graph)
