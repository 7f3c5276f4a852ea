"""Where a serving step's time goes on the card: one profiler window.

    python -m repro_torch.launch.profile_serve [llama3.2-1b | hymba-1.5b |
                                               gemma3-1b | qwen2-1.5b |
                                               qwen2-moe-a2.7b |
                                               llama-3.2-vision-11b |
                                               whisper-large-v3 | xlstm-125m]

Sets up one of the full-width serving workloads of
:mod:`repro_torch.launch.serve` (``WORKLOADS``, llama3.2-1b by default),
which ``chip_smoke.py`` serves in phases 7, 11, 19b, 20b, 21b and 22a: the
model at its published widths, float32 weights from seed 0, bfloat16
cache, 8 slots of 1024 tokens, 16 requests of 256-token prompts, the KV
pool under a live plane that ticks once per step.  Runs ``WARM`` engine steps so all
8 slots are busy, times ``STEPS`` steps on the host clock (each step
ends on its argmax sync), then profiles as many more with
``torch.profiler`` and prints, per step: the host-clock time without
and with the profiler, the device's busy time (the sum of the kernels'
and copies' device times, which barely overlap: the plane's few small
kernels run on a stream of their own), the idle share against the
unprofiled step, the kernels and copies, and device time by kernel name
(top 15).  Then the plane's tick: its host ms (median and max over the
timed steps) and share of the step, the synchronizing CUDA calls per
step and per tick (torch's sync debug mode), and the kernels and copies
a tick launches (``torch.profiler`` over ``STEPS`` ticks alone), the
host ms of the controller's ``flush`` alone (staging upload, fused
step, readback, actuation of an empty registry) on the card and on the
CPU device, and the lines the step's syncs come from.  Runs on the card
only: without one it raises, and a profile with no device time exits
nonzero.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import statistics
import subprocess
import sys
import time
import warnings
from typing import List, Sequence

import torch

from ..core.plane import ArrayController
from ..core.store import StoreRegistry
from ..core.stream import AggregatedMetrics
from .serve import WORKLOADS, build_engine

STEPS, WARM = 20, 20


def device_us(evt) -> float:
    """An averaged event's own device time, across torch versions."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def on_device(evt) -> bool:
    """A kernel or copy row: ``aten::`` operator rows also carry the
    device time of the kernels they launch, which would count it twice."""
    return device_us(evt) > 0 and not evt.key.startswith("aten::")


def watch_ticks(plane) -> List[float]:
    """Record the host-clock seconds of each tick of ``plane`` from now
    on (``plane.tick`` is wrapped); returns the list they go to."""
    seconds: List[float] = []
    inner = plane.tick

    def tick():
        t0 = time.perf_counter()
        try:
            return inner()
        finally:
            seconds.append(time.perf_counter() - t0)

    plane.tick = tick
    return seconds


@contextlib.contextmanager
def count_syncs():
    """Count the synchronizing CUDA calls made in the block, as torch's
    sync debug mode reports them; yields the list of their warnings."""
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        found: List[warnings.WarningMessage] = []
        try:
            yield found
        finally:
            torch.cuda.set_sync_debug_mode(prev)
            found.extend(w for w in caught if "called a synchronizing"
                         in str(w.message))


def tick_launches(plane, ticks: int) -> float:
    """Kernels and copies per tick of ``plane``, over ``ticks`` ticks
    alone under ``torch.profiler``."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(ticks):
            plane.tick()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if on_device(e)) / ticks


def flush_ms(params, device, reps: int) -> float:
    """Median host ms of one ``ArrayController.flush`` of one node on
    ``device``, the tick's controller part, apart from its sampling,
    health checks and bus."""
    ctl = ArrayController(params, device=device)
    ctl.attach_node("n0", StoreRegistry(), u0=2.0**28)
    agg = AggregatedMetrics(
        node="n0", timestamp=0.0, total=8e10, used_latest=6e9,
        used_ewma=6e9, used_mean=6e9, used_max=6e9, slope_per_interval=0.0,
        storage_used=0.0, swap_used=0.0, n_samples=1)
    times = []
    for _ in range(reps + 1):                # the first call warms up
        ctl.observe(agg)
        t0 = time.perf_counter()
        ctl.flush()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def main(argv: Sequence[str] = ()) -> None:
    ap = argparse.ArgumentParser(prog="profile_serve")
    ap.add_argument("arch", nargs="?", default="llama3.2-1b",
                    choices=sorted(WORKLOADS))
    arch = ap.parse_args(list(argv)).arch
    eng = build_engine(**WORKLOADS[arch])  # the card; raises without one
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    for _ in range(WARM):
        eng.step()
    torch.cuda.synchronize()
    busy_slots = sum(not s.free for s in eng.slots)
    tick_s = watch_ticks(eng.plane)
    t0 = time.perf_counter()
    for _ in range(STEPS):
        eng.step()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    tick_ms = [t * 1e3 for t in tick_s]

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    table = [e for e in prof.key_averages() if on_device(e)]
    busy = sum(device_us(e) for e in table) / 1e3          # ms
    launches = sum(e.count for e in table)
    n = STEPS
    wall_ms = wall * 1e3
    print(f"{arch}: {smi}; {busy_slots} of {eng.cfg.max_batch} slots busy; "
          f"{n} steps profiled")
    print(f"per step: host clock {plain_ms / n:.3f} ms ({wall_ms / n:.3f} "
          f"ms under the profiler), device busy {busy / n:.3f} ms, idle "
          f"share {1 - busy / plain_ms:.3f}, {launches / n:.1f} kernels "
          f"and copies")
    print("device time by name (ms per step, calls per step):")
    for e in sorted(table, key=device_us, reverse=True)[:15]:
        print(f"  {device_us(e) / 1e3 / n:9.4f}  {e.count / n:6.1f}  "
              f"{e.key[:90]}")
    with count_syncs() as step_syncs:
        for _ in range(STEPS):
            eng.step()
    with count_syncs() as tick_syncs:
        for _ in range(STEPS):
            eng.plane.tick()
    print(f"plane tick: host {statistics.median(tick_ms):.3f} ms median, "
          f"{max(tick_ms):.3f} ms max, {sum(tick_ms) / plain_ms:.4f} of "
          f"the step; syncs {len(step_syncs) / n:.2f} per step, "
          f"{len(tick_syncs) / n:.2f} per tick; "
          f"{tick_launches(eng.plane, n):.1f} kernels and copies per tick")
    params = eng.plane.params
    print(f"of a tick, the controller's flush alone: "
          f"{flush_ms(params, eng.device, n):.3f} ms on the card, "
          f"{flush_ms(params, 'cpu', n):.3f} ms on the CPU device (median "
          f"of {n})")
    print("syncs per step by the line that made them:")
    sites = collections.Counter(
        (w.filename.rsplit("src/", 1)[-1], w.lineno) for w in step_syncs)
    for (path, line), count in sites.most_common(8):
        print(f"  {count / n:6.2f}  {path}:{line}")
    if busy == 0.0:
        sys.exit("profile_serve: the profiler recorded no device time")


if __name__ == "__main__":
    main(sys.argv[1:])
