"""A profiled window and what the benchmark reads from its trace.

``torch.profiler`` records the host's ranges (the benchmark's ``pb.*``
spans), the runtime's launches and the device's kernels, copies and
fills.  The trace is written as Chrome JSON into the run's temporary
directory, read back and deleted.  From it:

* ``busy_s``: the union of the device's operations over the window;
* ``device_s``: each ``pb.*`` range's device seconds: the kernels
  launched inside the range on its host thread, and those launched by
  the backward of the operations it ran (autograd's sequence numbers
  link them), summed;
* ``ops``: device seconds by operation name;
* ``gaps``: the device's idle seconds, each gap named by the innermost
  ``pb.*`` range the host was in at the gap's middle;
* ``op_counts``: launches by operation name, to tell whether the
  profiler saw every launch of a kernel.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class Trace:
    window_s: float
    busy_s: float
    device_s: Dict[str, float] = field(default_factory=dict)
    ops: Dict[str, float] = field(default_factory=dict)
    gaps: Dict[str, float] = field(default_factory=dict)
    op_counts: Dict[str, int] = field(default_factory=dict)

    def count(self, needle: str) -> int:
        return sum(n for name, n in self.op_counts.items() if needle in name)

    def seconds(self, needle: str) -> float:
        return sum(s for name, s in self.ops.items() if needle in name)


def profiler(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _inside(merged: List[Tuple[float, float]], starts: List[float],
            t: float) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and merged[i][0] <= t <= merged[i][1]


def read(prof, window: str = "pb.step") -> Trace:
    """The trace of ``prof`` over the ``window`` ranges (first start to
    last end).  A range's device seconds count the kernels launched
    inside it and, through autograd's sequence numbers, those of the
    backward of every operation it ran."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)
    direct = defaultdict(list)          # (name, tid) -> [(start, end)]
    host = []                           # (start, end, name)
    launches = {}                       # correlation -> (ts, tid)
    device = []                         # (start, end, name, correlation)
    fwd, bwd = [], []                   # autograd's forward / backward ops
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = str(ev.get("cat", "")).lower()
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        args = ev.get("args") or {}
        tid = ev.get("tid")
        if cat == "user_annotation" and str(ev.get("name", "")
                                            ).startswith("pb."):
            direct[(ev["name"], tid)].append((ts, ts + dur))
            host.append((ts, ts + dur, ev["name"]))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (ts, tid)
        elif cat in DEVICE_CATS:
            device.append((ts, ts + dur, str(ev.get("name", cat)),
                           args.get("correlation")))
        elif cat == "cpu_op" and "Sequence number" in args:
            if "Fwd thread id" in args:
                bwd.append((ts, ts + dur, tid, args["Sequence number"]))
            else:
                fwd.append((ts, tid, args["Sequence number"]))
    steps = [(a, b) for (name, _), rs in direct.items() if name == window
             for a, b in rs]
    if not steps:
        return Trace(window_s=0.0, busy_s=0.0)
    w0, w1 = min(a for a, _ in steps), max(b for _, b in steps)
    merged = {k: _union(v) for k, v in direct.items()}
    reach = defaultdict(list)
    for (name, tid), rs in merged.items():
        starts = [a for a, _ in rs]
        seqs = {q for ts, t, q in fwd
                if t == tid and _inside(rs, starts, ts)}
        reach[(name, tid)].extend(rs)
        for a, b, t, q in bwd:
            if q in seqs:
                reach[(name, t)].append((a, b))
    reach = {k: _union(v) for k, v in reach.items()}
    reach_starts = {k: [a for a, _ in v] for k, v in reach.items()}
    inside = [(max(a, w0), min(b, w1), n, c) for a, b, n, c in device
              if b > w0 and a < w1]
    busy_iv = _union([(a, b) for a, b, _, _ in inside])
    ops, counts = defaultdict(float), defaultdict(int)
    per_range = defaultdict(float)
    for a, b, name, corr in inside:
        ops[name] += (b - a) / 1e6
        counts[name] += 1
        if corr not in launches:
            continue
        ts, tid = launches[corr]
        for (rname, rtid), rs in reach.items():
            if rtid == tid and _inside(rs, reach_starts[(rname, rtid)], ts):
                per_range[rname] += (b - a) / 1e6
    gaps = defaultdict(float)
    edges = [w0] + [x for ab in busy_iv for x in ab] + [w1]
    host.sort()
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        inner = [r for r in host[:bisect.bisect_right(host, (mid, 1e300))]
                 if r[1] >= mid]
        label = (min(inner, key=lambda r: r[1] - r[0])[2] if inner
                 else "outside pb ranges")
        gaps[label] += (b - a) / 1e6
    return Trace(window_s=(w1 - w0) / 1e6,
                 busy_s=sum(b - a for a, b in busy_iv) / 1e6,
                 device_s=dict(per_range), ops=dict(ops), gaps=dict(gaps),
                 op_counts=dict(counts))


def breakdown(trace: Trace) -> dict:
    """The ten longest device operations and idle gaps, as the result
    line carries them."""
    top = sorted(trace.ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(trace.gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:160], s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in gaps]}
