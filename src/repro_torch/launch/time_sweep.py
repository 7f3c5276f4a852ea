"""End-to-end time of the fused sweep on the card, and where it goes.

    python -m repro_torch.launch.time_sweep [--reps 15] [--chunks 64 32]
                                            [--profile]

Times ``fused_sweep_demand`` -- numpy demand in, numpy stats out -- at
the lab benchmark's fleet, 4096 nodes x 1000 intervals x 64 paper-law
gains (``fleet_demand_traces(4096, 1000, 0.1, seed=0)``, 125 GiB a
node), without the cache and with spark-iterative-cache's
``CacheSpec``: the host clock around each call, which ends in
``torch.cuda.synchronize()``, median of ``--reps`` warm runs, with
closed-loop updates per second.  ``--chunks`` lists lanes per launch
to compare (0: the package's own choice, the default); they run in
turns, one call of each per round, so a drift of the shared host hits
them alike.  Also timed alone: staging the operands on the card
(``_stage``: the (N, T) demand as (T, N) float32 on the card).  With
``--profile``, one more call of each runs under ``torch.profiler``,
which gives the device's busy time (the sum of kernels and copies),
the idle share and device time by name.

The script calls only entry points that every slice of the port has,
and imports the package by absolute name, so the same file times
another checkout: put that checkout's ``src`` first on ``PYTHONPATH``
and run the file by its path::

    PYTHONPATH=<checkout>/src python3 src/repro_torch/launch/time_sweep.py

The last line is one JSON object with the numbers, the card's name and
its power limit.  Runs on the card only: without one it raises.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.traces import GiB, fleet_demand_traces
from repro_torch.lab import fused_sweep as fs
from repro_torch.lab.scenarios import get_scenario
from repro_torch.lab.tune import grid_gains
from repro_torch.launch.profile_serve import device_us, on_device

N_NODES, N_STEPS = 4096, 1000
REPS = 15


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def time_fused_sweep(demand: np.ndarray, cache,
                     chunks: Sequence[Optional[int]] = (None,),
                     reps: int = REPS) -> List[dict]:
    """Host-clock ms of one ``fused_sweep_demand`` call on the card, for
    each lanes-per-launch setting of ``chunks`` (None: the package's),
    timed in turns."""
    gains = grid_gains()                        # 8 lam x 8 r0, paper law
    m = np.full(demand.shape[0], 125 * GiB)

    def run(chunk):
        t0 = time.perf_counter()
        fs.fused_sweep_demand(demand, gains, node_memory=m, cache=cache,
                              chunk=chunk, device="cuda")
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for chunk in chunks:                        # builds, allocator
        run(chunk)
        run(chunk)
    times = {i: [] for i in range(len(chunks))}
    for _ in range(reps):
        for i, chunk in enumerate(chunks):
            times[i].append(run(chunk))
    n_upd = demand.shape[0] * demand.shape[1] * len(gains)
    out = []
    for i, chunk in enumerate(chunks):
        ms = statistics.median(times[i])
        out.append(dict(ms=ms, min_ms=min(times[i]), max_ms=max(times[i]),
                        updates_s=n_upd / ms * 1e3, chunk=chunk))
    return out


def time_stage(demand: np.ndarray, cache, reps: int = REPS) -> float:
    """Host-clock ms of staging the operands on the card."""
    gains = fs._pad_gains(grid_gains(), fs.LANE_TILE)
    m = np.full(demand.shape[0], 125 * GiB)
    times = []
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        fs._stage(demand, gains, m, cache, "f32", torch.device("cuda"))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def _profiled(fn, reps: int = 1):
    """Run ``fn`` ``reps`` times under torch.profiler; returns the host
    ms of the whole window and the kernel and copy rows."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # "Activity Buffer Request" is the profiler's own buffer, not work
    return wall, [e for e in prof.key_averages()
                  if on_device(e) and e.key != "Activity Buffer Request"]


def device_ms(fn, reps: int = 5) -> float:
    """Device time (kernels and copies) of one call of ``fn``."""
    fn()
    _, table = _profiled(fn, reps)
    return sum(device_us(e) for e in table) / 1e3 / reps


def profile_fused_sweep(demand: np.ndarray, cache, top: int = 8) -> dict:
    """One call under torch.profiler: device busy ms and the top names."""
    gains = grid_gains()
    m = np.full(demand.shape[0], 125 * GiB)
    wall, table = _profiled(lambda: fs.fused_sweep_demand(
        demand, gains, node_memory=m, cache=cache, device="cuda"))
    busy = sum(device_us(e) for e in table) / 1e3
    if busy == 0.0:
        raise RuntimeError("the profiler recorded no device time")
    return dict(
        profiled_ms=wall, device_busy_ms=busy,
        device_ops=sum(e.count for e in table),
        top=[(e.key[:60], device_us(e) / 1e3, e.count)
             for e in sorted(table, key=device_us, reverse=True)[:top]])


def main(argv: Sequence[str] = ()) -> None:
    ap = argparse.ArgumentParser(prog="time_sweep")
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--chunks", type=int, nargs="+", default=[0])
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(list(argv))
    if not torch.cuda.is_available():
        raise RuntimeError("time_sweep times the card; no CUDA card is "
                           "available")
    smi = card_name()
    demand = fleet_demand_traces(N_NODES, N_STEPS, 0.1, seed=0)
    out = {"card": smi, "shape": f"{N_NODES} nodes x {N_STEPS} intervals "
           f"x 64 gains, f32, paper law"}
    for tag, cache in (("cache-off", None),
                       ("cache-on", get_scenario("spark-iterative-cache")
                        .cache)):
        chunks = [c or None for c in args.chunks]
        runs = time_fused_sweep(demand, cache, chunks, args.reps)
        for e in runs:
            print(f"{tag}: fused_sweep_demand, "
                  f"{e['chunk'] or 'default'} lanes a launch: {e['ms']:.3f} "
                  f"ms (min {e['min_ms']:.3f}, max {e['max_ms']:.3f}; "
                  f"{e['updates_s']:.4e} updates/s)", flush=True)
        r = dict(runs[0], runs=runs)
        r["stage_ms"] = time_stage(demand, cache, args.reps)
        line = f"{tag}: staging {r['stage_ms']:.3f} ms"
        if args.profile:
            r.update(profile_fused_sweep(demand, cache))
            line += (f"; profiled {r['profiled_ms']:.3f} ms, device busy "
                     f"{r['device_busy_ms']:.3f} ms in {r['device_ops']} "
                     f"kernels and copies, idle share "
                     f"{1 - r['device_busy_ms'] / r['ms']:.3f}")
        print(line, flush=True)
        for name, ms, count in r.get("top", []):
            print(f"    {ms:9.4f} ms  {count:4d}x  {name}")
        out[tag] = r
    print(smi)
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:])
