"""Serving entry point: continuous batching over a DynIMS-managed pool.

    python -m repro_torch.launch.serve --arch llama3.2-1b [--burst]
    python -m repro_torch.launch.serve --arch llama3.2-1b --burst --retune
    python -m repro_torch.launch.serve --arch hymba-1.5b [--burst]
    python -m repro_torch.launch.serve --arch gemma3-1b [--burst]
    python -m repro_torch.launch.serve --arch qwen2-1.5b [--burst]
    python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b [--burst]
    python -m repro_torch.launch.serve --arch llama-3.2-vision-11b [--burst]
    python -m repro_torch.launch.serve --arch whisper-large-v3 [--burst]
    python -m repro_torch.launch.serve --arch xlstm-125m [--burst]
    python -m repro_torch.launch.serve --arch hymba-1.5b-smoke --device cpu

Serves synthetic prompts with weights drawn from ``--seed`` through an
engine whose KV pool a live :class:`~repro_torch.core.plane.MemoryPlane`
resizes (``hbm_pool_params``, a device-memory monitor, one tick per
step), and prints tokens/s and steps/s beside the device's name, then
the engine's counters and the plane's health.  ``--burst`` simulates a
memory burst as the JAX launcher does: after 10 steps the KV pool is
shrunk by hand to 25% of its capacity (preempting sequences, which
requeue); with no sustained pressure on the device the plane re-grants
it on the next tick, and the engine drains.  ``--retune`` closes the
ReplayLoop on the serving path, as the JAX launcher does: the plane
records its own KV-pool telemetry during the first wave of requests,
``retune_online`` re-tunes the pool gains on the captured workload (the
sweep on the same device) and hot-swaps the winner into the live plane,
and a second wave of ``requests // 2`` prompts serves under the new
parameter epoch.  Without ``--device`` it runs on the card and raises
when there is none.  The cross-attention families serve as JAX's
engine serves them: with zero cross caches (and ``enc_len`` 0), since
no request carries images or frames.  The ssm family (xlstm-125m)
attends nowhere: its slots carry recurrent state, and its pool is JAX's
notional KV pool, sized as if it had K/V (ROADMAP C26).
"""

from __future__ import annotations

import argparse
import inspect
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..configs import get_config
from ..configs.dynims import hbm_pool_params
from ..core.plane import MemoryPlane, PlaneSpec
from ..device import DeviceLike, resolve_device
from ..lab.tune import retune_online
from ..models import Model
from ..serving import ServingConfig, ServingEngine


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


# The full-width workloads, one per served architecture: served by
# ``chip_smoke.py`` with the burst (llama in phase 7, hymba in phase 11,
# gemma3 and qwen2 in phase 19b, qwen2-moe in phase 20b, the vision and
# audio models in phase 21b, xlstm in phase 22a) and profiled by
# ``repro_torch.launch.profile_serve``.  288 tokens a request fit
# whisper's deployed 448-token decoder.
FULL_WIDTH = dict(arch="llama3.2-1b", requests=16, prompt_len=256,
                  max_new=32, max_batch=8, max_len=1024, seed=0)
FULL_WIDTH_HYMBA = dict(FULL_WIDTH, arch="hymba-1.5b")
FULL_WIDTH_GEMMA3 = dict(FULL_WIDTH, arch="gemma3-1b")
FULL_WIDTH_QWEN2 = dict(FULL_WIDTH, arch="qwen2-1.5b")
FULL_WIDTH_QWEN2_MOE = dict(FULL_WIDTH, arch="qwen2-moe-a2.7b")
FULL_WIDTH_VLM = dict(FULL_WIDTH, arch="llama-3.2-vision-11b")
FULL_WIDTH_WHISPER = dict(FULL_WIDTH, arch="whisper-large-v3")
FULL_WIDTH_XLSTM = dict(FULL_WIDTH, arch="xlstm-125m")
WORKLOADS = {w["arch"]: w for w in (FULL_WIDTH, FULL_WIDTH_HYMBA,
                                    FULL_WIDTH_GEMMA3, FULL_WIDTH_QWEN2,
                                    FULL_WIDTH_QWEN2_MOE, FULL_WIDTH_VLM,
                                    FULL_WIDTH_WHISPER, FULL_WIDTH_XLSTM)}


def prompts(vocab: int, prompt_len: int, seed: int, n: int) -> list:
    """The first ``n`` synthetic prompts of ``seed`` (a second wave
    takes the ones after the first wave's)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, prompt_len) for _ in range(n)]


def build_engine(arch: str = "llama3.2-1b-smoke", *, requests: int = 12,
                 prompt_len: int = 16, max_new: int = 16, max_batch: int = 4,
                 max_len: int = 128, seed: int = 0, record: int = 0,
                 device: DeviceLike = None) -> ServingEngine:
    """The model drawn from ``seed`` and an engine (``ServingConfig``'s
    block size and cache type) with ``requests`` synthetic prompts
    queued, its pool attached to a plane on the same device that
    records its last ``record`` intervals (0: none)."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    model = Model(cfg, seed=seed, device=dev)
    plane = MemoryPlane(PlaneSpec(params=hbm_pool_params(), record=record,
                                  device=dev))
    engine = ServingEngine(model, ServingConfig(max_batch=max_batch,
                                                max_len=max_len), device=dev,
                           plane=plane)
    for p in prompts(cfg.vocab_size, prompt_len, seed, requests):
        engine.submit(p, max_new_tokens=max_new)
    return engine


_BUILD_DEFAULTS = {k: p.default for k, p in
                   inspect.signature(build_engine).parameters.items()
                   if p.default is not inspect.Parameter.empty}


def serve(*, burst: bool = False, retune: bool = False,
          retune_budget: int = 16, retune_restarts: int = 2,
          **workload) -> dict:
    """Serve the prompts of :func:`build_engine` (``workload`` is its
    keywords) until drained; returns the run's report.

    The report holds the engine, its finished requests, the wall time of
    the serving loop (host clock, ending on the last step's host sync),
    the tokens generated, the device's name, and the engine's counters
    and the plane's health report then (``stats``, ``health``); with
    ``burst``, also the pool's capacity after each of the 5 steps that
    follow the shrink (``after_shrink``) and its full capacity
    (``full``).  With ``retune`` the plane records 2048 intervals; then
    one supervised :func:`~repro_torch.lab.tune.retune_online` round
    (name ``"kv-pool-replay"``) runs on its capture, and a second wave
    serves; the report adds ``retune`` (the ``RetuneResult``),
    ``retune_attempts``, ``retune_restarts``, ``retune_seconds`` (host
    clock of the round), the plane's ``params`` and
    ``health_after_retune`` after it, and ``wave2``: the second wave's
    requests, seconds, tokens and the plane's epoch it served under.
    """
    workload = {**_BUILD_DEFAULTS, **workload}
    if retune:
        workload["record"] = 2048
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
    report.update(engine=engine, finished=dict(finished), seconds=seconds,
                  tokens=sum(len(r.output) for r in finished.values()),
                  stats=engine.stats(), health=engine.plane.health(),
                  device=device_name(engine.device))
    if retune:
        report.update(retune_round(engine, retune_budget, retune_restarts))
        report["wave2"] = second_wave(engine, workload)
    return report


def retune_round(engine: ServingEngine, budget: int, restarts: int) -> dict:
    """One supervised retune of the engine's plane on its own capture,
    on the engine's device; waits for it."""
    t0 = time.perf_counter()
    handle = retune_online(engine.plane, name="kv-pool-replay",
                           budget=budget, block=False, restarts=restarts,
                           device=engine.device)
    result = handle.result()
    seconds = time.perf_counter() - t0
    return dict(retune=result, retune_attempts=handle.attempts,
                retune_restarts=handle.restarts, retune_seconds=seconds,
                params=engine.plane.params,
                health_after_retune=engine.plane.health())


def second_wave(engine: ServingEngine, workload: dict) -> dict:
    """Serve ``requests // 2`` (at least 1) more prompts -- the ones
    after the first wave's -- until drained."""
    n1 = workload["requests"]
    n2 = max(n1 // 2, 1)
    before = len(engine.finished)
    tokens0 = sum(len(r.output) for r in engine.finished.values())
    for p in prompts(engine.model.cfg.vocab_size, workload["prompt_len"],
                     workload["seed"], n1 + n2)[n1:]:
        engine.submit(p, max_new_tokens=workload["max_new"])
    t0 = time.perf_counter()
    finished = engine.run_until_drained()
    return dict(requests=len(finished) - before, finished=len(finished),
                seconds=time.perf_counter() - t0,
                tokens=sum(len(r.output) for r in finished.values())
                - tokens0, epoch=engine.plane.epoch)


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
    ap.add_argument("--retune", action="store_true",
                    help="capture the KV-pool workload, re-tune the pool "
                         "gains on it online, hot-swap, serve a second wave")
    ap.add_argument("--retune-budget", type=int, default=16)
    ap.add_argument("--retune-restarts", type=int, default=2,
                    help="supervised retune: restart a crashed tuning "
                         "round up to N times with backoff")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    args = ap.parse_args(argv)

    report = serve(arch=args.arch, requests=args.requests,
                   prompt_len=args.prompt_len, max_new=args.max_new,
                   max_batch=args.max_batch, max_len=args.max_len,
                   burst=args.burst, seed=args.seed, device=args.device,
                   retune=args.retune, retune_budget=args.retune_budget,
                   retune_restarts=args.retune_restarts)
    stats = report["stats"]
    dt = report["seconds"]
    print(f"served {len(report['finished'])} requests, {report['tokens']} "
          f"tokens in {dt:.3f}s: {report['tokens'] / dt:.1f} tok/s, "
          f"{stats['steps'] / dt:.1f} steps/s on {report['device']}")
    print("engine:", stats)
    print(report["health"].summary())
    if args.retune:
        print("-- ReplayLoop: re-tuning pool gains on the captured "
              "KV workload --")
        print("  ", report["retune"].summary())
        if report["retune_restarts"]:
            print(f"   retune supervisor: {report['retune_attempts']} "
                  f"attempts, {report['retune_restarts']} restarts")
        p, w2 = report["params"], report["wave2"]
        print(f"   live params now: r0={p.r0:.4f} lam={p.lam:.4f} "
              f"lam_grant={p.lam_grant} (epoch {w2['epoch']})")
        print("  ", report["health_after_retune"].summary())
        print(f"   second wave under epoch {w2['epoch']}: served "
              f"{w2['finished']} requests")
    return report


if __name__ == "__main__":
    main()
