#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the sweep kernel from ``src/repro_torch/csrc/sweep.cu``, holds
it against its plain PyTorch version on the card, drives the port's
main path (``run_sweep``, ``sweep_demand``, ``tune_gains``) at the
lab benchmark's fleet size (4096 nodes x 1000 intervals x 64 gains)
and at the registry scenarios' declared sizes, checks the card's
results against the port's own CPU run and the checked-in presets, and
times the kernel.  Every phase prints a line; any failed check raises
and the exit code is nonzero.  The last line is the JSON the driver
reads; the line before it lists the kernel with its numbers.

Needs a CUDA card and ``nvcc``; imports nothing of JAX or of the JAX
package.  Without a card it exits nonzero before printing a result.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA card is available")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs.dynims import (LAB_TUNED,  # noqa: E402
                                        LAB_TUNED_OBJECTIVES)
from repro_torch.core.traces import GiB, fleet_demand_traces  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import sweep as ks  # noqa: E402
from repro_torch.lab import fused_sweep as fs  # noqa: E402
from repro_torch.lab.scenarios import get_scenario  # noqa: E402
from repro_torch.lab.score import stats_mismatches  # noqa: E402
from repro_torch.lab.sweep import (plan_specialization, run_sweep,  # noqa
                                   sweep_demand)
from repro_torch.lab.tune import grid_gains, tune_gains  # noqa: E402

CUDA = torch.device("cuda")
N_NODES, N_STEPS = 4096, 1000            # the lab benchmark's fleet
CACHE = get_scenario("spark-iterative-cache").cache
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 FLOP/s
# outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# Operations per (lane, node, interval) update of the paper-law step in
# csrc/sweep.cu, counted from its source: every add, multiply, divide,
# compare, select, min/max and the code's conversion.  A multiply-add
# rounded through float64 counts as two, each float64 log2/exp2 as one,
# and all at the float32 rate, so the bound stays a lower bound.
OPS_PER_UPDATE = {"cache-off": 32, "cache-on": 85}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def cuda_ms(fn, reps: int = 5, warm: int = 2) -> float:
    """Median of ``reps`` warm runs, timed with CUDA events."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def gains_64(law: str):
    if law == "paper":
        return grid_gains()                         # 8 lam x 8 r0
    return grid_gains(lam=np.linspace(0.1, 1.8, 8), r0=(0.92, 0.96),
                      lam_grant=(0.25,), deadband=(0.0, 0.005),
                      feedforward=(0.0, 0.5))


def segment_inputs(demand, gains, cache, precision, n_dead=0,
                   occupancy=1.0):
    plan = plan_specialization(gains, occupancy)
    con = fs._engine_consts(plan, cache, 0.1, occupancy, precision)
    names = ks.state_names(con.paper_law, con.has_cache)
    dtn, rows, lp = fs._stage(demand, gains, np.full(N_NODES, 125 * GiB),
                              cache, precision, CUDA)
    alive = fs._alive(len(gains), len(gains) - n_dead, CUDA)
    state0 = fs._init_state(lp, rows, dtn[0].float(), con, names)
    return (state0, dtn, lp, rows, alive), dict(t0=0, con=con, names=names)


def compare_planes(names, got, want):
    """Largest |diff| and largest diff relative to its plane's scale.

    A Kahan compensation plane (``*_c``) is scaled by its sum's plane:
    it is part of that sum's value.
    """
    max_abs, max_rel = 0.0, 0.0
    for i, name in enumerate(names):
        ref = want[names.index(name[:-2])] if name.endswith("_c") \
            else want[i]
        diff = float((got[i] - want[i]).abs().max())
        scale = float(ref.abs().max())
        max_abs = max(max_abs, diff)
        if diff:
            max_rel = max(max_rel, diff / scale if scale else float("inf"))
    return max_abs, max_rel


def phase1(demand):
    log("phase 1: kernel vs plain on the card, 4096 nodes x 1000 "
        "intervals x 64 gains")
    variants = [("paper", None, "f32", 1.0), ("generic", None, "f32", 1.0),
                ("paper", CACHE, "f32", 1.0), ("generic", CACHE, "f32", 1.0),
                ("paper", None, "bf16", 1.0), ("generic", CACHE, "bf16", 1.0),
                ("paper", None, "f32", 0.8)]
    worst_abs = 0.0
    for law, cache, precision, occ in variants:
        args, kw = segment_inputs(demand, gains_64(law), cache, precision,
                                  n_dead=5, occupancy=occ)
        before = ks.LAUNCHES
        sk, ck = ks.sweep_segment(*args, **kw)
        torch.cuda.synchronize()
        check(ks.LAUNCHES == before + 1, "the kernel did not launch")
        sp, cp = ks.sweep_segment_plain(*args, **kw)
        torch.cuda.synchronize()
        max_abs, max_rel = compare_planes(kw["names"], sk, sp)
        code_diff = (ck.to(torch.int32) - cp.to(torch.int32)).abs()
        n_codes = int((code_diff != 0).sum())
        dead_ok = (int(ck[:, -5:].to(torch.int32).abs().sum()) == 0
                   and torch.equal(sk[:, -5:], args[0][:, -5:]))
        tag = (f"{law:7s} {'cache-on' if cache else 'cache-off':9s} "
               f"{precision:4s} occ={occ}")
        log(f"  {tag}: bit-identical={torch.equal(sk, sp) and n_codes == 0}"
            f" max_abs={max_abs:.3e} max_rel={max_rel:.3e} "
            f"codes_differing={n_codes} max_code_diff="
            f"{int(code_diff.max())} dead_lanes_ok={dead_ok}")
        check(dead_ok, f"{tag}: dead lanes wrote codes or moved state")
        check(bool(torch.isfinite(sk).all()), f"{tag}: non-finite state")
        if cache is None:
            check(torch.equal(sk, sp) and n_codes == 0,
                  f"{tag}: cache-off kernel is not bit-identical")
        else:
            check(max_rel <= 1e-6, f"{tag}: cache-on state off by "
                  f"{max_rel:.3e} relative (bound 1e-6)")
        worst_abs = max(worst_abs, max_abs)
    return worst_abs


def assert_same(tag, card, cpu, n_samples):
    bad = stats_mismatches(card, cpu, n_samples=n_samples)
    for f in card._fields:
        v = np.asarray(getattr(card, f))
        check(v.shape == np.asarray(getattr(cpu, f)).shape
              and np.isfinite(v).all(), f"{tag}: {f} malformed")
    check(not bad, f"{tag}: card and CPU disagree:\n" + "\n".join(bad))
    exact = sum(np.array_equal(getattr(card, f), getattr(cpu, f))
                for f in card._fields)
    log(f"  {tag}: card == CPU within the test brackets ({exact} of "
        f"{len(card._fields)} fields bit-identical)")


def phase2(demand):
    log("phase 2: the main path, card against the port's CPU run")
    spec = get_scenario("phase-replay")
    t0 = time.perf_counter()
    card = run_sweep("phase-replay", grid_gains())
    t_card = time.perf_counter() - t0
    cpu = run_sweep("phase-replay", grid_gains(), device="cpu")
    assert_same(f"run_sweep(phase-replay, {spec.n_nodes} nodes, 64 gains,"
                f" card {t_card:.2f}s)", card.stats, cpu.stats,
                spec.n_nodes * spec.n_intervals)
    check(card.best() == cpu.best(), "phase-replay: winners differ")
    m = np.full(N_NODES, 125 * GiB)
    for tag, cache in (("cache-off", None), ("cache-on", CACHE)):
        t0 = time.perf_counter()
        a = sweep_demand(demand, grid_gains(), node_memory=m, cache=cache)
        t_card = time.perf_counter() - t0
        b = sweep_demand(demand, grid_gains(), node_memory=m, cache=cache,
                         device="cpu")
        assert_same(f"sweep_demand 4096x1000x64 {tag} (card {t_card:.2f}s)",
                    a, b, N_NODES * N_STEPS)


def phase3():
    log("phase 3: in-scan halving, tune_gains(swap-storm, halving, 512)")
    card = tune_gains("swap-storm", method="halving", budget=512)
    cpu = tune_gains("swap-storm", method="halving", budget=512,
                     device="cpu")
    sched = " -> ".join(f"{r['n_candidates']}@T={r['horizon']}"
                        for r in card.rounds)
    log(f"  rounds: {sched}")
    same = all(np.array_equal(getattr(card.sweep.gains, f),
                              getattr(cpu.sweep.gains, f))
               for f in ("r0", "lam", "lam_grant", "deadband", "feedforward"))
    check(same, "in-scan survivors differ between the card and the CPU")
    check(card.params == cpu.params, "halving winners differ")
    log(f"  survivors equal ({card.sweep.n_configs} final lanes); winner "
        f"r0={card.params.r0:.4f} lam={card.params.lam:.4f} "
        f"lam_grant={card.params.lam_grant} score={card.score:.6f}")


def phase4():
    log("phase 4: the six LAB_TUNED presets regenerate on the card")
    for name in sorted(LAB_TUNED):
        objective = LAB_TUNED_OBJECTIVES.get(name)
        r = tune_gains(name, budget=100, objective=objective)
        preset = LAB_TUNED[name]
        ok = r.params == preset
        s = r.sweep.scores()
        order = np.argsort(-s)
        margin = float(s[order[0]] - s[order[1]])
        log(f"  {name} [{objective or 'default'}]: "
            f"{'ok' if ok else 'STALE'} score={r.score:.6f} "
            f"margin_to_second={margin:.3e}")
        if not ok:
            g = r.sweep.gains
            idx = [i for i in range(len(g))
                   if g.params_at(i, preset) == preset]
            want = float(s[idx[0]]) if idx else float("nan")
            check(False, f"{name}: tuned {r.params} != preset {preset}; "
                  f"winner {r.score!r} vs preset {want!r}")


def phase5(demand):
    log("phase 5: times on the card (CUDA events, median of 5 warm runs)")
    out = {}
    n_upd = N_NODES * N_STEPS * 64
    for tag, cache in (("cache-off", None), ("cache-on", CACHE)):
        args, kw = segment_inputs(demand, gains_64("paper"), cache, "f32")
        ms = cuda_ms(lambda: ks.sweep_segment(*args, **kw), reps=7)
        plain = cuda_ms(lambda: ks.sweep_segment_plain(*args, **kw), reps=5,
                        warm=1)
        state, codes = ks.sweep_segment(*args, **kw)
        fin = cuda_ms(lambda: fs._finalize_lanes(state, codes, args[2],
                                                 kw["con"], kw["names"],
                                                 N_STEPS))
        state_bytes = 2 * state.numel() * 4
        n_bytes = (codes.numel() * 2 + args[1].numel() * 4 + state_bytes
                   + args[2].numel() * 4 + args[3].numel() * 4
                   + args[4].numel() * 4)
        t_bytes = n_bytes / PEAK_BYTES_S * 1e3
        t_ops = n_upd * OPS_PER_UPDATE[tag] / PEAK_F32_S * 1e3
        out[tag] = dict(ms=ms, plain_ms=plain, finalize_ms=fin,
                        bound_ms=max(t_bytes, t_ops),
                        bound_by="bytes" if t_bytes >= t_ops
                        else "operations")
        log(f"  {tag}: kernel {ms:.4f} ms ({n_upd / ms * 1e3:.3e} updates/s)"
            f", plain {plain:.1f} ms, _finalize_lanes {fin:.4f} ms, bound "
            f"{out[tag]['bound_ms']:.4f} ms by {out[tag]['bound_by']} "
            f"(bytes {t_bytes:.4f} ms, ops {t_ops:.4f} ms)")
    return out


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log("phase 0: " + smi)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib = _build.load_library()
    log(f"  kernel build {time.perf_counter() - t0:.2f}s (nvcc "
        f"{lib.build_s:.2f}s) -> {os.path.relpath(lib.path)}")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas: " + line.strip())

    demand = fleet_demand_traces(N_NODES, N_STEPS, 0.1, seed=0)
    max_abs = phase1(demand)

    ks.LAUNCHES = 0                        # the main path starts here
    phase2(demand)
    phase3()
    phase4()
    launches = ks.LAUNCHES
    log(f"main path: sweep kernel launched {launches} times")
    check(launches > 0, "the main path never launched the sweep kernel")

    t = phase5(demand)
    off, on = t["cache-off"], t["cache-on"]
    kernel = {
        "name": "sweep_segment", "route": "cuda",
        "source": "src/repro_torch/csrc/sweep.cu",
        "replaces": "src/repro/lab/pallas_sweep.py:305",
        "launches": launches, "max_abs_err": max_abs,
        "ms": off["ms"], "plain_ms": off["plain_ms"],
        "bound_ms": off["bound_ms"], "bound_by": off["bound_by"],
        "library_ms": None,
        "cache_on": {"ms": on["ms"], "plain_ms": on["plain_ms"],
                     "bound_ms": on["bound_ms"], "bound_by": on["bound_by"]},
        "finalize_ms": {"cache-off": off["finalize_ms"],
                        "cache-on": on["finalize_ms"]},
        "shape": "4096 nodes x 1000 intervals x 64 gains, f32, paper law",
    }
    print(smi)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
