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
from typing import Dict, Tuple

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

# Kernel launches since import (or since a caller reset it).
LAUNCHES = 0


def state_names(paper_law: bool, has_cache: bool) -> Tuple[str, ...]:
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
    return tuple(names)


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
               names: Tuple[str, ...], ix: Dict[str, int], k: _Lifted):
    """One closed-loop interval on a tuple of (L, N) state planes.

    ``cols[row]`` are lane parameters of shape (L, 1) and ``rows[row]``
    node constants of shape (N,).  Returns the new planes (in ``names``
    order) and the interval's (L, N) ``uint16`` codes, which the caller
    bins into its histogram.
    """
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
    return tuple(out[n] for n in names), utilization_codes(r)


def _check(state, hist, demand_seg, lp, np_rows, alive, t0, con,
           names) -> None:
    """Shapes, types and layout the kernel (and its plain version) take."""
    if names != state_names(con.paper_law, con.has_cache):
        raise ValueError(f"state planes {names} do not match the kernel's "
                         f"layout for paper_law={con.paper_law}, "
                         f"has_cache={con.has_cache}")
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
                        t0: int, con, names: Tuple[str, ...]):
    """The plain PyTorch version of the kernel, on any device."""
    _check(state, hist, demand_seg, lp, np_rows, alive, t0, con, names)
    ix = {n: i for i, n in enumerate(names)}
    k = _Lifted(con, state.device)
    cols = lp[:, :, None]
    wf0 = warm_fraction0(cols, np_rows, con)[1] if con.has_cache else None
    st = tuple(state.unbind(0))
    counts = torch.zeros_like(hist)
    for i in range(demand_seg.shape[0]):
        st, codes = fused_step(st, demand_seg[i].float(), t0 + i, cols,
                               np_rows, wf0, con, names, ix, k)
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


def _launch(state, hist, demand_seg, lp, np_rows, alive, *, t0: int, con,
            names: Tuple[str, ...]):
    from ._build import load_library

    _check(state, hist, demand_seg, lp, np_rows, alive, t0, con, names)
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
    lib = load_library().lib
    rc = lib.dynims_sweep_segment(
        int(con.paper_law), int(con.unit_occupancy), int(con.has_cache),
        int(con.precision == "bf16"),
        *(x.data_ptr() for x in operands), state_out.data_ptr(),
        hist_out.data_ptr(), t_seg, n_lanes, n_nodes, int(t0),
        ctypes.byref(consts), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sweep kernel launch failed: CUDA error {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return state_out, hist_out


def sweep_segment(state, hist, demand_seg, lp, np_rows, alive, *, t0: int,
                  con, names: Tuple[str, ...]):
    """Advance every lane over ``demand_seg``; returns (state, hist).

    ``state`` is (S, L, N) float32, ``hist`` the (L, HIST_BINS) int32
    counts so far (zeros at the horizon's start), ``demand_seg`` (T, N)
    float32 or bfloat16 (per ``con.precision``), ``lp`` the (10, L)
    lane pack, ``np_rows`` the (4, N) node pack and ``alive`` the
    (1, L) mask; ``t0`` is the segment's first interval.  CPU tensors
    run :func:`sweep_segment_plain`; CUDA tensors launch the kernel.
    Any other device raises.
    """
    if state.device.type == "cpu":
        return sweep_segment_plain(state, hist, demand_seg, lp, np_rows,
                                   alive, t0=t0, con=con, names=names)
    if state.device.type != "cuda":
        raise ValueError(f"sweep_segment runs on cpu or cuda, not "
                         f"{state.device}")
    return _launch(state, hist, demand_seg, lp, np_rows, alive, t0=t0,
                   con=con, names=names)
