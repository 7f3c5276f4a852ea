"""The work of each kernel of the port, from its shapes alone.

Each function returns the :class:`Work` one call does: its operations,
the bytes it must move (each input read once, each output written once,
whatever the kernel reads again) and the peak rate of its route, so a
bound reads the same whatever implements the kernel (the CUDA kernel,
its plain PyTorch version, a library call).  Where the work depends on
the data (decode attention's lengths, a mask's kept pairs), the caller
passes what this call's data needs.  The bound is the larger of the
bytes over :data:`~.constants.HBM_BW` and the operations over the
route's peak, in milliseconds, with the term that binds it.

* B1, the sweep (``csrc/sweep.cu``): :data:`OPS_PER_UPDATE` float32
  operations per (lane, node, interval) update, counted from the
  kernel's source, plus :data:`GRAPH_OPS_PER_UPDATE` for the AppGraph
  carry; its one-interval graph entry (:func:`sweep_interval`) moves the
  whole state in and out every launch, and of the histogram and the
  work matrix only what the launch touches; its segment route over node
  shards on one card (:func:`sweep_shard_segment`) is the graph
  instance on a shard's columns with the lanes' barriers.  The
  AppGraph carry's
  intervals are serial (each waits on the lane's min), so beside those
  two terms its :attr:`Work.critical_path_ms` is the intervals times
  :data:`GRAPH_CHAIN_OPS` dependent operations at
  :data:`~.constants.F32_DEP_LATENCY_S` each: a bound no number of lanes
  or nodes lowers.
* B2, flash attention: 4 * hd operations per kept (query, key) pair, at
  the bf16 tensor-core rate, or for float32 (run as 3xTF32: three TF32
  products for each) at a third of the TF32 rate.
* B3, decode attention: the kept keys' K and V read once, q read and
  the output written once; 4 * hd float32 operations per (key, head).
* B4, the SSM scan: (B, S, C, N) decay and drive read, h0 read, the
  (B, S, C, N) states written; 2 operations per element.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from .analysis import roofline_terms
from .constants import (F32_DEP_LATENCY_S, HBM_BW, PEAK_BF16, PEAK_F32,
                        PEAK_F64, PEAK_TF32)

# Operations per (lane, node, interval) update of the paper-law step in
# csrc/sweep.cu, counted from its source: every add, multiply, divide,
# compare, select, min/max, the code's conversion and the histogram's
# add.  A multiply-add rounded through float64 counts as two, each
# float64 log2/exp2 as one, and all at the float32 rate, so the bound
# stays a lower bound.
OPS_PER_UPDATE = {"cache-off": 33, "cache-on": 86}
# The AppGraph carry's operations per update on top of those, counted the
# same way from csrc/sweep.cu's graph_segment: the held demand's add, the
# fused pressure curve and dt_eff (cache-off only: 10), the drain, its
# Kahan sum, the progress code, the finish and promotion tests.  The
# lane's reductions are not counted, so the bound stays a lower bound.
GRAPH_OPS_PER_UPDATE = {"cache-off": 36, "cache-on": 26}
# The dependent operations of one interval of the graph instance's
# serial chain, counted from csrc/sweep.cu's graph_kernel (the law's
# own recurrence in u runs beside it, shorter): the row's held demand
# read and added, the observed v; without the cache r, the fused
# pressure curve (max, min, the segment's subtract and multiply-add, the
# select: 5) and dt_eff; with it the error, the update (two multiplies,
# the FMA, the clamp's two), the resident set and hit fraction (min,
# multiply, min), the float64 power (clamp, two conversions, log2,
# multiply, exp2: 6), the hit (2), the cold-start mix (4), the miss (2)
# and dt_app's three; then the drain's divide, multiply and select, the
# work left's subtract and max, the finish test, the progress code and
# its min (2), the warp's min, and the promotion's compare, test and
# step (3).  Barriers, shared and distributed shared memory are not
# counted, so the bound stays a lower bound.
GRAPH_CHAIN_OPS = {"cache-off": 22, "cache-on": 40}
# The two float64 transcendentals of the cache-on count (see
# sweep_f64_bound_ms).
F64_CALLS_PER_UPDATE = 2


def bound(n_bytes: float, n_ops: float, peak_ops: float
          ) -> Tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time for the work, the
    roofline of :func:`.analysis.roofline_terms` with no collective."""
    t = roofline_terms(hlo_flops_per_chip=n_ops, hlo_bytes_per_chip=n_bytes,
                       collective_bytes_per_chip=0.0, peak_flops=peak_ops)
    return t["bound_s"] * 1e3, ("bytes" if t["memory_s"] >= t["compute_s"]
                                else "operations")


@dataclasses.dataclass(frozen=True)
class Work:
    """What one call of a kernel must do."""

    ops: float           # operations (FLOPs for the attention kernels)
    bytes: float         # each input read once, each output written once
    peak: float          # the route's operations per second
    serial_ops: float = 0.0   # the longest chain of dependent operations

    @property
    def critical_path_ms(self) -> float:
        """The serial chain's least time, beside :attr:`bound_ms` (which
        it does not enter): each dependent operation waits on the one
        before, whatever the card's width."""
        return self.serial_ops * F32_DEP_LATENCY_S * 1e3

    @property
    def bound_ms(self) -> float:
        return bound(self.bytes, self.ops, self.peak)[0]

    @property
    def bound_by(self) -> str:
        return bound(self.bytes, self.ops, self.peak)[1]


# ---- B1: the sweep -------------------------------------------------------

def sweep(n_nodes: int, n_intervals: int, n_lanes: int, *, cache: bool,
          paper_law: bool = True, n_stages: Optional[int] = None,
          demand_itemsize: int = 4) -> Work:
    """One sweep launch over (nodes, intervals, lanes): the demand
    stream, the lane parameters and node rows, the alive mask and the
    histogram read once, the state read and written; with ``n_stages``
    the AppGraph instance, its work matrix and stage constants read
    too, and the intervals' serial chain (:attr:`Work.critical_path_ms`)."""
    from ..kernels.sweep import (N_NODE_ROWS, N_PARAM_ROWS,
                                 N_STAGE_CONST_ROWS, state_names)
    from ..lab.score import HIST_BINS

    graph = n_stages is not None
    planes = len(state_names(paper_law, cache, graph))
    n_bytes = (n_intervals * n_nodes * demand_itemsize
               + (N_PARAM_ROWS + 1 + HIST_BINS) * n_lanes * 4
               + N_NODE_ROWS * n_nodes * 4
               + 2 * planes * n_lanes * n_nodes * 4)
    if graph:
        n_bytes += ((n_stages + 1) * n_nodes
                    + N_STAGE_CONST_ROWS * (n_stages + 1)) * 4
    tag = "cache-on" if cache else "cache-off"
    per_update = OPS_PER_UPDATE[tag] + (GRAPH_OPS_PER_UPDATE[tag] if graph
                                        else 0)
    return Work(ops=n_nodes * n_intervals * n_lanes * per_update,
                bytes=n_bytes, peak=PEAK_F32,
                serial_ops=n_intervals * GRAPH_CHAIN_OPS[tag] if graph
                else 0.0)


# Node rows the one-interval graph entry reads (1 / m, the working set
# and its inverse; not m).
INTERVAL_NODE_ROWS = 3


def sweep_interval(n_nodes: int, n_lanes: int, *, cache: bool,
                   paper_law: bool = True, n_stages: int,
                   hist_updates: Optional[int] = None,
                   work_reads: Optional[int] = None,
                   demand_itemsize: int = 4) -> Work:
    """One launch of the one-interval graph entry on a shard of
    ``n_nodes``: the state read and written once, one demand row, the
    lane parameters and the alive mask, the node rows it reads, the stage
    constants, the (L,) int32 fleet min read and lane min written.  Of
    the histogram only the bins the launch adds to, each read and
    written (``hist_updates``; at most one a live (lane, node) and one a
    bin, the default), and of the work matrix only the entries its
    promotions read (``work_reads``; by default one row).  The
    operations are one interval of :func:`sweep`'s graph instance."""
    from ..kernels.sweep import (N_PARAM_ROWS, N_STAGE_CONST_ROWS,
                                 state_names)
    from ..lab.score import HIST_BINS

    planes = len(state_names(paper_law, cache, True))
    if hist_updates is None:
        hist_updates = n_lanes * min(n_nodes, HIST_BINS)
    if work_reads is None:
        work_reads = n_nodes
    n_bytes = (2 * planes * n_lanes * n_nodes * 4
               + n_nodes * demand_itemsize
               + (N_PARAM_ROWS + 1) * n_lanes * 4
               + INTERVAL_NODE_ROWS * n_nodes * 4
               + N_STAGE_CONST_ROWS * (n_stages + 1) * 4
               + 2 * n_lanes * 4
               + 2 * hist_updates * 4
               + work_reads * 4)
    ops = sweep(n_nodes, 1, n_lanes, cache=cache, paper_law=paper_law,
                n_stages=n_stages).ops
    return Work(ops=ops, bytes=n_bytes, peak=PEAK_F32)


# The int32 words of a lane's barrier in the node shards' segment route
# (arrivals, episodes, two min slots).
BARRIER_WORDS = 4


def sweep_shard_segment(n_nodes: int, n_intervals: int, n_lanes: int, *,
                        cache: bool, paper_law: bool = True, n_stages: int,
                        demand_itemsize: int = 4) -> Work:
    """One node shard's launch of the segment route
    (``kernels.sweep.graph_segment_shards``) on a shard of ``n_nodes``:
    :func:`sweep`'s graph instance over the shard's columns (the state
    once in and out, its demand rows, the histogram, its columns of the
    work matrix, the operations and the intervals' serial chain), plus
    the lanes' barriers read and written.  The barrier's latency, an
    atomic round trip a meet, is not added: the bound stays a lower
    bound."""
    one = sweep(n_nodes, n_intervals, n_lanes, cache=cache,
                paper_law=paper_law, n_stages=n_stages,
                demand_itemsize=demand_itemsize)
    return dataclasses.replace(
        one, bytes=one.bytes + 2 * BARRIER_WORDS * n_lanes * 4)


def sweep_f64_bound_ms(work: Work, n_updates: int,
                       f64_per_update: float) -> float:
    """The cache-on bound with ``f64_per_update`` float64 operations an
    update (a static count of the kernel's SASS) at the float64 rate in
    place of the two transcendentals counted at the float32 rate."""
    f32_ops = work.ops - n_updates * F64_CALLS_PER_UPDATE
    t_ops = (f32_ops / PEAK_F32 + n_updates * f64_per_update / PEAK_F64)
    return max(work.bytes / HBM_BW, t_ops) * 1e3


# ---- B2: flash attention ---------------------------------------------------

def kept_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps over positions arange(Sq/Skv)."""
    total = 0
    for i in range(sq):
        hi = min(i + 1, skv) if causal else skv
        lo = max(i - window + 1, 0) if window else 0
        total += max(hi - lo, 0)
    return total


def flash(b: int, sq: int, h: int, kv: int, hd: int, *,
          skv: Optional[int] = None, causal: bool = True, window: int = 0,
          bf16: bool = False) -> Work:
    """One forward: q, k, v read and the output written once."""
    skv = sq if skv is None else skv
    itemsize = 2 if bf16 else 4
    return Work(ops=4 * b * h * kept_pairs(sq, skv, causal, window) * hd,
                bytes=(2 * b * sq * h + 2 * b * skv * kv) * hd * itemsize,
                peak=PEAK_BF16 if bf16 else PEAK_TF32 / 3)


# ---- B3: decode attention ---------------------------------------------------

def decode_kept_keys(lengths: Sequence[int], s: int, window: int = 0) -> int:
    """Keys the sequences' ``[len - window, len)`` ranges keep, cut to
    the cache's ``s`` positions."""
    total = 0
    for n in lengths:
        hi = min(max(int(n), 0), s)
        total += hi - (max(hi - window, 0) if window else 0)
    return total


def decode(lengths: Sequence[int], s: int, h: int, kv: int, hd: int, *,
           window: int = 0, q_itemsize: int = 4,
           kv_itemsize: int = 2) -> Work:
    """One decode step of ``len(lengths)`` sequences over a cache of
    ``s`` positions."""
    n_keys = decode_kept_keys(lengths, s, window)
    b = len(lengths)
    return Work(ops=4 * n_keys * h * hd,
                bytes=(n_keys * kv * hd * 2 * kv_itemsize
                       + 2 * b * h * hd * q_itemsize + b * 4),
                peak=PEAK_F32)


# ---- B4: the SSM scan -------------------------------------------------------

def ssm_scan(b: int, s: int, c: int, n: int, itemsize: int = 4) -> Work:
    n_el = b * s * c * n
    return Work(ops=2 * n_el, bytes=(3 * n_el + b * c * n) * itemsize,
                peak=PEAK_F32)


# ---- the optimizer ----------------------------------------------------------

def adamw(n_params: int) -> Work:
    """One AdamW update: the parameter, its gradient and two moments read
    and the parameter and moments written, float32 (28 bytes each)."""
    return Work(ops=0, bytes=28 * n_params, peak=PEAK_F32)
