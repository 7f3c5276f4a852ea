"""Serving entry point: continuous batching over a DynIMS-managed pool.

    python -m repro_torch.launch.serve --arch llama3.2-1b [--burst]
    python -m repro_torch.launch.serve --arch hymba-1.5b [--burst]
    python -m repro_torch.launch.serve --arch hymba-1.5b-smoke --device cpu

Serves synthetic prompts with weights drawn from ``--seed`` through an
engine whose KV pool a live :class:`~repro_torch.core.plane.MemoryPlane`
resizes (``hbm_pool_params``, a device-memory monitor, one tick per
step), and prints tokens/s and steps/s beside the device's name, then
the engine's counters and the plane's health.  ``--burst`` simulates a
memory burst as the JAX launcher does: after 10 steps the KV pool is
shrunk by hand to 25% of its capacity (preempting sequences, which
requeue); with no sustained pressure on the device the plane re-grants
it on the next tick, and the engine drains.  Without ``--device`` it
runs on the card and raises when there is none.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..configs import get_config
from ..configs.dynims import hbm_pool_params
from ..core.plane import MemoryPlane, PlaneSpec
from ..device import DeviceLike, resolve_device
from ..models import Model
from ..serving import ServingConfig, ServingEngine


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


# The full-width workloads, one per served architecture: served by
# ``chip_smoke.py`` with the burst (llama in phase 7, hymba in phase 11)
# and profiled by ``repro_torch.launch.profile_serve``.
FULL_WIDTH = dict(arch="llama3.2-1b", requests=16, prompt_len=256,
                  max_new=32, max_batch=8, max_len=1024, seed=0)
FULL_WIDTH_HYMBA = dict(FULL_WIDTH, arch="hymba-1.5b")
WORKLOADS = {w["arch"]: w for w in (FULL_WIDTH, FULL_WIDTH_HYMBA)}


def build_engine(arch: str = "llama3.2-1b-smoke", *, requests: int = 12,
                 prompt_len: int = 16, max_new: int = 16, max_batch: int = 4,
                 max_len: int = 128, seed: int = 0,
                 device: DeviceLike = None) -> ServingEngine:
    """The model drawn from ``seed`` and an engine (``ServingConfig``'s
    block size and cache type) with ``requests`` synthetic prompts
    queued, its pool attached to a plane on the same device."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    model = Model(cfg, seed=seed, device=dev)
    plane = MemoryPlane(PlaneSpec(params=hbm_pool_params(), device=dev))
    engine = ServingEngine(model, ServingConfig(max_batch=max_batch,
                                                max_len=max_len), device=dev,
                           plane=plane)
    rng = np.random.default_rng(seed)
    for _ in range(requests):
        engine.submit(rng.integers(0, cfg.vocab_size, prompt_len),
                      max_new_tokens=max_new)
    return engine


def serve(*, burst: bool = False, **workload) -> dict:
    """Serve the prompts of :func:`build_engine` (``workload`` is its
    keywords) until drained; returns the run's report.

    The report holds the engine, its finished requests, the wall time of
    the serving loop (host clock, ending on the last step's host sync),
    the tokens generated and the device's name; with ``burst``, also
    the pool's capacity after each of the 5 steps that follow the
    shrink (``after_shrink``) and its full capacity (``full``).
    """
    engine = build_engine(**workload)
    report = {}
    t0 = time.perf_counter()
    if burst:
        for _ in range(10):
            engine.step()
        report["full"] = full = engine.pool.capacity()
        engine.pool.set_capacity(full * 0.25)
        report["after_shrink"] = []
        for _ in range(5):
            engine.step()
            report["after_shrink"].append(engine.pool.capacity())
    finished = engine.run_until_drained()
    seconds = time.perf_counter() - t0
    report.update(engine=engine, finished=finished, seconds=seconds,
                  tokens=sum(len(r.output) for r in finished.values()),
                  device=device_name(engine.device))
    return report


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b-smoke")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--burst", action="store_true",
                    help="shrink the KV pool to 25%% after 10 steps; the "
                         "plane re-grants it")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    args = ap.parse_args(argv)

    report = serve(arch=args.arch, requests=args.requests,
                   prompt_len=args.prompt_len, max_new=args.max_new,
                   max_batch=args.max_batch, max_len=args.max_len,
                   burst=args.burst, seed=args.seed, device=args.device)
    stats = report["engine"].stats()
    dt = report["seconds"]
    print(f"served {len(report['finished'])} requests, {report['tokens']} "
          f"tokens in {dt:.3f}s: {report['tokens'] / dt:.1f} tok/s, "
          f"{stats['steps'] / dt:.1f} steps/s on {report['device']}")
    print("engine:", stats)
    print(report["engine"].plane.health().summary())
    return report


if __name__ == "__main__":
    main()
