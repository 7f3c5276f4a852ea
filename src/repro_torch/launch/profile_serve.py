"""Where a serving step's time goes on the card: one profiler window.

    python -m repro_torch.launch.profile_serve [llama3.2-1b | hymba-1.5b]

Sets up one of the full-width serving workloads of
:mod:`repro_torch.launch.serve` (``WORKLOADS``, llama3.2-1b by default),
which ``chip_smoke.py`` serves in phases 7 and 11: the model at its
published widths, float32 weights from seed 0, bfloat16 cache, 8 slots
of 1024 tokens, 16 requests of 256-token prompts.  Runs ``WARM`` engine
steps so all 8 slots are busy, times ``STEPS`` steps on the host clock
(each step ends on its argmax sync), then profiles as many more with
``torch.profiler`` and prints, per step: the host-clock time without
and with the profiler, the device's busy time (the sum of the
kernels' and copies' device times; one stream, so they do not
overlap), the idle share against the unprofiled step, the kernels and
copies, and device time by kernel name (top 15).  Runs on the card
only: without one it raises, and a profile with no device time exits
nonzero.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from typing import Sequence

import torch

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
    t0 = time.perf_counter()
    for _ in range(STEPS):
        eng.step()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3

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
    if busy == 0.0:
        sys.exit("profile_serve: the profiler recorded no device time")


if __name__ == "__main__":
    main(sys.argv[1:])
