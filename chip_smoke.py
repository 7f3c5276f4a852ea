#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the four kernels from ``src/repro_torch/csrc/`` (one ``nvcc``
each, all at once) and drives the port's main paths on the card:

* the sweep (phases 1-5): the sweep kernel against its plain PyTorch
  version (state, the per-lane p99 histogram, and the p99 against the
  bisection over the plain loop's codes), then ``run_sweep``,
  ``sweep_demand`` and ``tune_gains`` at the lab benchmark's fleet size
  (4096 nodes x 1000 intervals x 64 gains) and the registry scenarios'
  declared sizes, checked against the port's own CPU run and the
  checked-in presets, then its times: the kernel, also under full
  contention and, with the cache, with the float64 power skipped, the
  finalize, and ``fused_sweep_demand`` end to end;
* serving llama3.2-1b at full width (phases 6-9): the decode- and
  flash-attention kernels against their plain versions, the
  continuous-batching engine through a pool burst under a live
  ``MemoryPlane`` (ticks = steps, healthy, the pool re-granted on the
  tick after the shrink), forward (flash)
  against decode (decode attention), mixed progress against isolated
  serving, then the kernels' times beside their bounds, their plain
  versions and PyTorch's ``scaled_dot_product_attention`` (flash
  attention in bf16 and in f32, and at the main path's f32 shapes);
* serving hymba-1.5b at full width (phases 10-13): the scan kernel
  against its plain version bit for bit, and both attention kernels at
  hymba's heads and window; the engine through the same burst; forward
  (flash and scan) against decode past the 1024-token window, mixed
  progress against isolated serving; then the scan kernel's time beside
  its bound and its plain version;
* the live plane under real device-memory pressure (phase 14):
  llama3.2-1b served while one tensor holds the card at (r0 + 0.03) M;
  the plane alone empties the pool, preempting, re-grants it once the
  tensor is freed, and its card actions equal a CPU replay of the
  recorded samples bit for bit; the tick's host time, syncs and
  launches;
* the ReplayLoop (phase 15): llama3.2-1b served through the burst under
  a recording plane, the pool's gains re-tuned on the capture by the
  sweep kernel on the card (non-blocking, supervised) to the CPU
  round's decision, a second wave served under the plane's epoch; the
  paper's testbed (``cluster_sim``, config 3) captured on the host and
  replayed on the card within JAX's fidelity gates, then tuned at 4096
  nodes; ``simulate_fleet`` at 4096 x 1000 against the CPU and JAX's
  fleet gates;
* AppGraph (phase 16): the sweep kernel's graph instance (the stage
  DAG's queue/barrier carry) against its plain version, one block a
  lane (limplock, spark-dag at their sizes) and several with a barrier
  between them (both at 4096 nodes x 64 lanes); ``BENCH_appgraph.json``'s
  gates (spark-dag's >= 2x makespan gap, limplock's ~4x) with the card's
  makespans equal to the CPU's; ``halving_tune(spark-dag, makespan)``
  making the CPU's decision; ``runtime-churn`` card against CPU; and
  the graph instance's times beside the graph-free instance on the same
  demand.

Decode attention at the engines' shapes (phases 9 and 13) is timed three
ways, also in a fresh process that has built no plane (``chip_smoke.py
--decode-times LENGTHS``, started by phase 9).

Every phase prints a line; any failed check raises and the exit code is
nonzero.  The last line is a JSON object naming the device; the one
before it lists the kernels with their numbers, and the one before
that the card's name and power limit.

Needs a CUDA card and ``nvcc``; imports nothing of JAX or of the JAX
package.  Without a card it exits nonzero before printing a result.
"""

import concurrent.futures
import dataclasses
import itertools
import json
import math
import os
import re
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

from repro_torch.configs import DECODE_32K, get_config  # noqa: E402
from repro_torch.configs.dynims import (LAB_TUNED,  # noqa: E402
                                        LAB_TUNED_OBJECTIVES, PAPER_TABLE_I,
                                        hbm_pool_params)
from repro_torch.core.cluster_sim import (make_paper_config,  # noqa: E402
                                          paper_controller_params, simulate,
                                          simulate_fleet)
from repro_torch.core.monitor import SimulatedMonitor  # noqa: E402
from repro_torch.core.plane import (MemoryPlane, NodeSpec,  # noqa: E402
                                    PlaneSpec)
from repro_torch.core.store import StoreRegistry  # noqa: E402
from repro_torch.core.traces import GiB, fleet_demand_traces  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as kd  # noqa: E402
from repro_torch.kernels import flash_attention as kf  # noqa: E402
from repro_torch.kernels import ssm_scan as kscan  # noqa: E402
from repro_torch.kernels import sweep as ks  # noqa: E402
from repro_torch.lab import fused_sweep as fs  # noqa: E402
from repro_torch.lab import tune as tune_mod  # noqa: E402
from repro_torch.lab.scenarios import (ScenarioSpec,  # noqa: E402
                                       get_scenario)
from repro_torch.lab.score import (FleetStats,  # noqa: E402
                                   quantile_from_codes, quantile_from_hist,
                                   stats_mismatches)
from repro_torch.lab.sweep import (DEFAULT_CHUNK, GainSet,  # noqa: E402
                                   plan_specialization, run_sweep,
                                   sweep_demand)
from repro_torch.lab.tune import (grid_gains, halving_tune,  # noqa: E402
                                  retune_online, tune_gains)
from repro_torch.launch.profile_serve import (count_syncs,  # noqa: E402
                                              device_us, tick_launches,
                                              watch_ticks)
from repro_torch.launch.serve import (FULL_WIDTH,  # noqa: E402
                                      FULL_WIDTH_HYMBA, build_engine, serve)
from repro_torch.launch.time_sweep import (_profiled,  # noqa: E402
                                           device_ms, time_fused_sweep)
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models.transformer import layer_windows  # noqa: E402
from repro_torch.serving import ServingConfig, ServingEngine  # noqa: E402

CUDA = torch.device("cuda")
N_NODES, N_STEPS = 4096, 1000            # the lab benchmark's fleet
CACHE = get_scenario("spark-iterative-cache").cache
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 FLOP/s
# outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_BF16_S = 989e12                     # dense, tensor cores
PEAK_TF32_S = 495e12                     # dense, tensor cores
PEAK_F64_S = 34e12                       # float64 outside the tensor cores
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
# The two float64 transcendentals of the cache-on count; phase 5 also
# states a bound with their SASS instructions at the float64 rate.
F64_CALLS_PER_UPDATE = 2


# (phase, host clock at its first line), for the run's seconds by phase
PHASE_STARTS = []


def log(msg: str) -> None:
    m = re.match(r"phase (\d+[a-z]?)(:| \()", msg)
    if m and not (PHASE_STARTS and PHASE_STARTS[-1][0] == m.group(1)):
        PHASE_STARTS.append((m.group(1), time.perf_counter()))
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


# Cycles of the device-side spin queued before the start event when a
# run is timed with ``lead``: ~1 ms at the H100's clock, longer than the
# host takes to issue one kernel.
LEAD_CYCLES = 2_000_000


def cuda_ms(fn, reps: int = 5, warm: int = 2, flush=None,
            lead: bool = False) -> float:
    """Median of ``reps`` warm runs, timed with CUDA events.

    ``flush``, a large tensor, is overwritten before each timed run so
    the run finds the 50 MB L2 cache cold, as a caller between other
    work does.  Without ``lead`` the window between the events also
    holds whatever part of the host's issue of ``fn`` the device waits
    for; with it, a ~1 ms spin on the device ahead of the start event
    lets the host issue ``fn`` first, so the window holds the device's
    work alone.
    """
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.fill_(1.0)
        if lead:
            torch.cuda._sleep(LEAD_CYCLES)
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
    return ((state0, fs._zero_hist(lp), dtn, lp, rows, alive),
            dict(t0=0, con=con, names=names))


def plain_codes(args, kw):
    """The (T, L, N) codes of the plain version's fused_step loop."""
    state0, _, dtn, lp, rows, _ = args
    con, names = kw["con"], kw["names"]
    ix = {n: i for i, n in enumerate(names)}
    k = ks._Lifted(con, CUDA)
    cols = lp[:, :, None]
    wf0 = ks.warm_fraction0(cols, rows, con)[1] if con.has_cache else None
    st = tuple(state0.unbind(0))
    codes = torch.empty((dtn.shape[0],) + tuple(state0.shape[1:]),
                        dtype=torch.uint16, device=CUDA)
    for i in range(dtn.shape[0]):
        st, codes[i] = ks.fused_step(st, dtn[i].float(), kw["t0"] + i, cols,
                                     rows, wf0, con, names, ix, k)
    return codes


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
        "intervals x 64 gains (state, p99 histogram, p99)")
    variants = [("paper", None, "f32", 1.0), ("generic", None, "f32", 1.0),
                ("paper", CACHE, "f32", 1.0), ("generic", CACHE, "f32", 1.0),
                ("paper", None, "bf16", 1.0), ("generic", CACHE, "bf16", 1.0),
                ("paper", None, "f32", 0.8)]
    worst_abs, bins_on = 0.0, 0
    n_total = N_STEPS * N_NODES
    for law, cache, precision, occ in variants:
        args, kw = segment_inputs(demand, gains_64(law), cache, precision,
                                  n_dead=5, occupancy=occ)
        before = ks.LAUNCHES
        sk, hk = ks.sweep_segment(*args, **kw)
        torch.cuda.synchronize()
        check(ks.LAUNCHES == before + 1, "the kernel did not launch")
        sp, hp = ks.sweep_segment_plain(*args, **kw)
        torch.cuda.synchronize()
        max_abs, max_rel = compare_planes(kw["names"], sk, sp)
        n_bins = int((hk != hp).sum())
        live = hk.shape[0] - 5
        dead_ok = (int(hk[live:].abs().sum()) == 0
                   and torch.equal(sk[:, live:], args[0][:, live:]))
        counts_ok = hk[:live].sum(1).tolist() == [n_total] * live
        p99_hist = quantile_from_hist(hk[:live], 0.99, n_total)
        p99_codes = quantile_from_codes(plain_codes(args, kw)[:, :live],
                                        0.99, n_total, lane_dim=1)
        n_p99 = int((p99_hist != p99_codes).sum())
        tag = (f"{law:7s} {'cache-on' if cache else 'cache-off':9s} "
               f"{precision:4s} occ={occ}")
        log(f"  {tag}: bit-identical={torch.equal(sk, sp) and n_bins == 0}"
            f" max_abs={max_abs:.3e} max_rel={max_rel:.3e} "
            f"hist_bins_differing={n_bins} p99_lanes_differing_from_codes="
            f"{n_p99} of {live} counts_ok={counts_ok} dead_lanes_ok="
            f"{dead_ok}")
        check(dead_ok, f"{tag}: dead lanes counted codes or moved state")
        check(counts_ok, f"{tag}: a live lane did not count T x N updates")
        check(bool(torch.isfinite(sk).all()), f"{tag}: non-finite state")
        if cache is None:
            check(torch.equal(sk, sp) and n_bins == 0,
                  f"{tag}: cache-off kernel is not bit-identical")
            check(n_p99 == 0, f"{tag}: the histogram's p99 differs from "
                  f"the bisection over the plain loop's codes")
        else:
            # the float64 power may move a rare code across a bin edge,
            # which moves one count between two bins: at most one such
            # update per lane on average, and the p99 holds
            check(max_rel <= 1e-6, f"{tag}: cache-on state off by "
                  f"{max_rel:.3e} relative (bound 1e-6)")
            check(n_bins <= live, f"{tag}: {n_bins} histogram bins differ "
                  f"(bound {live}, one per live lane)")
            check(n_p99 == 0, f"{tag}: the histogram's p99 differs from "
                  f"the bisection over the plain loop's codes")
            bins_on = max(bins_on, n_bins)
        worst_abs = max(worst_abs, max_abs)
    return worst_abs, bins_on


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


def sweep_resources(lib):
    """Registers, static shared memory and resident blocks per SM of
    every template instance of the sweep kernel, from the runtime."""
    rows = {}
    for (law, occ, cache), bf16, graph in itertools.product(
            ((1, 1, 0), (1, 0, 0), (0, 1, 0), (0, 0, 0), (1, 1, 1),
             (0, 1, 1)), (0, 1), (0, 1)):
        out = ks.instance_resources(law, occ, cache, bf16, graph, lib=lib)
        tag = (f"{'paper' if law else 'generic'} "
               f"{'unit-occ' if occ else 'occ'} "
               f"{'cache-on' if cache else 'cache-off'} "
               f"{'bf16' if bf16 else 'f32'}"
               f"{' graph' if graph else ''}")
        rows[tag] = dict(registers=out[0], smem_bytes=out[1],
                         blocks_per_sm=out[2], warps_per_sm=out[2] * 4)
        log(f"    {tag}: {out[0]} registers, {out[1]} B shared, "
            f"{out[2]} blocks ({out[2] * 4} warps) per SM")
    return rows


def sass_f64_ops(lib_path):
    """float64 operations per update of the cache-on paper-law f32
    instance, counted in its SASS (cuobjdump): DFMA as two, every other
    float64 arithmetic, compare and conversion instruction and each
    MUFU.*64H as one, divided by the copies of the step that the SASS
    holds (one F2F.F32.F64 each: the power's one rounding to float32).
    A static count, so an upper estimate of what an update executes: it
    includes the rarely taken special-case paths of exp2 and log2.
    Returns (operations per update, step copies, instruction counts)."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True).stdout
    want = "sweep_kernelILb1ELb1ELb1ELb0ELb0EE"
    body = next(f for f in sass.split("Function : ")[1:]
                if want in f.split("\n", 1)[0])
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)", body)
    n = {"DFMA": 0, "D other": 0, "MUFU 64H": 0, "F2F f64": 0, "CALL": 0}
    copies = sum(op.startswith("F2F.F32.F64") for op in ops)
    check(copies > 0, "no float64 power in the cache-on instance's SASS")
    for op in ops:
        if op.startswith("DFMA"):
            n["DFMA"] += 1
        elif op[:4] in ("DADD", "DMUL", "DSET", "DMNM", "DMIN", "DMAX"):
            n["D other"] += 1
        elif op.startswith("MUFU") and op.endswith("64H"):
            n["MUFU 64H"] += 1
        elif op.startswith(("F2F", "I2F", "F2I")) and "64" in op \
                and ".S64" not in op and ".U64" not in op:
            n["F2F f64"] += 1
        elif op.startswith("CALL"):
            n["CALL"] += 1
    flops = 2 * n["DFMA"] + n["D other"] + n["MUFU 64H"] + n["F2F f64"]
    return flops / copies, copies, n


def equal_demand(demand):
    """Every node sees node 0's demand: each warp adds to one bin."""
    return np.repeat(demand[:1], demand.shape[0], axis=0)


def phase5(demand, sweep_lib):
    log("phase 5: times on the card (CUDA events, median of 7 warm runs; "
        "end to end on the host clock, median of 15, the two chunkings in "
        "turns)")
    out = {}
    n_upd = N_NODES * N_STEPS * 64
    flat = equal_demand(demand)
    for tag, cache in (("cache-off", None), ("cache-on", CACHE)):
        args, kw = segment_inputs(demand, gains_64("paper"), cache, "f32")
        eq_args, _ = segment_inputs(flat, gains_64("paper"), cache, "f32")
        ms = cuda_ms(lambda: ks.sweep_segment(*args, **kw), reps=7)
        equal_ms = cuda_ms(lambda: ks.sweep_segment(*eq_args, **kw), reps=7)
        plain = cuda_ms(lambda: ks.sweep_segment_plain(*args, **kw), reps=5,
                        warm=1)
        state, hist = ks.sweep_segment(*args, **kw)

        def finalize():
            fs._finalize_lanes(state, hist, args[3], kw["con"], kw["names"],
                               N_STEPS)
        fin = cuda_ms(finalize)
        fin_device = device_ms(finalize)
        n_bytes = (args[2].numel() * 4 + args[3].numel() * 4
                   + args[4].numel() * 4 + args[5].numel() * 4
                   + 2 * state.numel() * 4 + hist.numel() * 4)
        t_bytes = n_bytes / PEAK_BYTES_S * 1e3
        t_ops = n_upd * OPS_PER_UPDATE[tag] / PEAK_F32_S * 1e3
        e2e, e2e32 = time_fused_sweep(demand, cache, (None, 32))
        r = dict(ms=ms, all_nodes_equal_ms=equal_ms, plain_ms=plain,
                 finalize_ms=fin, finalize_device_ms=fin_device,
                 bound_ms=max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations",
                 bytes=n_bytes, kernel_plus_finalize_ms=ms + fin,
                 fused_sweep_demand=e2e, fused_sweep_demand_chunk32=e2e32)
        log(f"  {tag}: kernel {ms:.4f} ms ({n_upd / ms * 1e3:.3e} "
            f"updates/s; {equal_ms:.4f} ms with every node's demand equal, "
            f"one bin per warp and interval), plain {plain:.1f} ms, "
            f"_finalize_lanes {fin:.4f} ms ({fin_device:.4f} ms of it on the "
            f"device), kernel + finalize {ms + fin:.4f} ms; bound "
            f"{r['bound_ms']:.4f} ms by "
            f"{r['bound_by']} (bytes {t_bytes:.4f} ms for "
            f"{n_bytes / 1e6:.2f} MB, ops {t_ops:.4f} ms at "
            f"{OPS_PER_UPDATE[tag]} per update)")
        if cache is not None:
            f64, copies, n = sass_f64_ops(sweep_lib.path)
            t_f64 = n_upd * ((OPS_PER_UPDATE[tag] - F64_CALLS_PER_UPDATE)
                             / PEAK_F32_S + f64 / PEAK_F64_S) * 1e3
            # the power's exponent at 1 skips the float64 exp2/log2
            linear = dict(kw, con=dataclasses.replace(kw["con"], hit_exp=1.0))
            no_pow = cuda_ms(lambda: ks.sweep_segment(*args, **linear),
                             reps=7)
            r.update(f64_ops_per_update_static=f64, sass_f64=n,
                     sass_step_copies=copies,
                     bound_f64_static_ms=max(t_bytes, t_f64),
                     power_skipped_ms=no_pow)
            log(f"    float64 power, static SASS count (an upper estimate: "
                f"it holds exp2/log2's rarely taken special paths): {n} in "
                f"{copies} copies of the step -> {f64:.1f} float64 "
                f"operations per update; bound with them at "
                f"{PEAK_F64_S / 1e12:.0f} TFLOP/s: "
                f"{r['bound_f64_static_ms']:.4f} ms")
            log(f"    the same kernel with the power skipped (hit_exp = 1, "
                f"no float64): {no_pow:.4f} ms")
        for key, e in ((f"{DEFAULT_CHUNK} lanes a launch", e2e),
                       ("32 lanes a launch", e2e32)):
            log(f"    fused_sweep_demand ({key}): {e['ms']:.3f} ms (min "
                f"{e['min_ms']:.3f}, max {e['max_ms']:.3f}), "
                f"{e['updates_s']:.4e} updates/s")
        out[tag] = r
    return out


# ---- serving llama3.2-1b: the attention kernels ------------------------

ARCH = FULL_WIDTH["arch"]
# ((b, s, h, kv, hd, window), lengths or None for random ones in
# [window + 1, s)): tests/test_kernels.py's DECODE_CASES; a cache length
# that is a multiple of no tile at the model's heads, with len 1 and len
# S; one (sequence, kv head) pair over 4000 keys, split the most; 320
# pairs, which fill the card with one split each; head dims 16 and 128
# with len 0 and 1 in one batch; windows that start mid-tile (677, 50);
# 16 and 12 query heads per kv head (two head sets of warps).
DECODE_CASES = [((4, 512, 8, 2, 64, 0), None), ((2, 1024, 4, 4, 32, 0), None),
                ((3, 512, 8, 4, 64, 200), None),
                ((1, 256, 2, 1, 128, 0), None),
                ((5, 1000, 32, 8, 64, 0), [1, 1000, 333, 999, 17]),
                ((1, 4000, 4, 1, 64, 0), [4000]),
                ((40, 300, 32, 8, 64, 0), None),
                ((4, 700, 8, 2, 16, 0), [0, 1, 700, 333]),
                ((4, 900, 16, 4, 128, 0), [0, 1, 900, 555]),
                ((3, 777, 8, 2, 64, 100), [777, 0, 150]),
                ((2, 500, 16, 1, 64, 0), [500, 37]),
                ((2, 300, 24, 2, 32, 50), [300, 1])]
# (b, sq, skv, h, kv, hd, causal, window): tests/test_kernels.py's
# FLASH_CASES, then ragged lengths at the model's heads, then head dims
# 16 and 128 at an Sq that is a multiple of neither 64 nor 16, causal,
# windowed and non-causal with Sq < Skv.
FLASH_CASES = [(2, 256, 256, 4, 2, 64, True, 0),
               (1, 128, 128, 4, 4, 32, True, 0),
               (2, 128, 256, 4, 1, 64, False, 0),
               (1, 256, 256, 8, 2, 64, True, 64),
               (1, 512, 512, 2, 2, 128, True, 0),
               (2, 192, 192, 4, 2, 64, True, 48),
               (2, 300, 300, 32, 8, 64, True, 0),
               (2, 77, 77, 4, 2, 16, True, 0),
               (1, 77, 333, 8, 2, 128, False, 0),
               (2, 200, 200, 4, 1, 128, True, 40),
               (1, 61, 300, 4, 4, 16, False, 0),
               (1, 100, 300, 2, 1, 32, False, 50)]
F32, BF16 = torch.float32, torch.bfloat16
# (B, S) of one decode_32k layer: 128 x 32768, 8.6 GB of bf16 K/V
DECODE_LONG = (DECODE_32K.global_batch, DECODE_32K.seq_len)
FLASH_TIMED = (2, 4096)          # (B, S) of the timed causal forward
FLASH_MAIN_LLAMA = (2, 256)      # (B, S) of phase 8's forward
FLASH_MAIN_HYMBA = (1, 1088)     # (B, S) of phase 12's forward


def randn(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device=CUDA).to(dtype)


def max_err(got, want, tol, tag):
    """Largest |got - want|; raises past ``atol = rtol = tol``."""
    check(bool(torch.isfinite(got).all()), f"{tag}: non-finite output")
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol,
                               msg=lambda m: f"{tag}: {m}")
    return float((got.float() - want.float()).abs().max())


def decode_splits(b, s, h, kv):
    """The split count the decode wrapper picks on this card."""
    return kd.choose_splits(b, kv, s, h // kv, kd.sm_count(CUDA.index or 0))


def check_decode(case, lens, gen, errs):
    """Decode kernel against plain at one case, for each pair of types;
    a second call on the same inputs must give the same bits."""
    b, s, h, kv, hd, window = case
    splits = decode_splits(b, s, h, kv)
    for qdt, kdt in ((F32, F32), (BF16, BF16), (F32, BF16)):
        q = randn((b, h, hd), qdt, gen)
        kc, vc = randn((b, s, kv, hd), kdt, gen), \
            randn((b, s, kv, hd), kdt, gen)
        if lens is None:
            lo = window + 1 if window else 1
            lens_b = torch.randint(lo, s, (b,), generator=gen,
                                   device=CUDA).tolist()
        else:
            lens_b = lens
        lens_b = torch.tensor(lens_b, dtype=torch.int32, device=CUDA)
        before = kd.LAUNCHES
        out = kd.decode_attention(q, kc, vc, lens_b, window=window)
        torch.cuda.synchronize()
        check(kd.LAUNCHES == before + 1, "decode kernel did not launch")
        again = kd.decode_attention(q, kc, vc, lens_b, window=window)
        ref = kd.decode_attention_plain(q, kc, vc, lens_b, window=window)
        # both sides compute in f32 from the same cache values, so
        # the output's type sets the tolerance
        tol = 3e-2 if qdt == BF16 else 2e-5
        tag = (f"decode b{b} S{s} H{h}/KV{kv} hd{hd} w{window} "
               f"q={str(qdt)[6:]} cache={str(kdt)[6:]} splits {splits}")
        check(torch.equal(out, again), f"{tag}: two calls differ")
        err = max_err(out, ref, tol, tag)
        key = "f32" if tol == 2e-5 else "bf16"
        errs["decode"][key] = max(errs["decode"].get(key, 0.0), err)
        log(f"  {tag}: max_abs_err={err:.3e} ok, bit-identical twice")


def check_flash(case, gen, errs):
    """Flash kernel against plain at one case, in f32 and in bf16."""
    b, sq, skv, h, kv, hd, causal, window = case
    for dt in (F32, BF16):
        q = randn((b, sq, h, hd), dt, gen)
        k, v = randn((b, skv, kv, hd), dt, gen), \
            randn((b, skv, kv, hd), dt, gen)
        before = kf.LAUNCHES
        out = kf.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        check(kf.LAUNCHES == before + 1, "flash kernel did not launch")
        ref = kf.flash_attention_plain(q, k, v, causal=causal,
                                       window=window)
        tol = 2e-2 if dt == BF16 else 2e-5
        tag = (f"flash b{b} Sq{sq} Skv{skv} H{h}/KV{kv} hd{hd} "
               f"causal={causal} w{window} {str(dt)[6:]}")
        err = max_err(out, ref, tol, tag)
        key = "f32" if dt == F32 else "bf16"
        errs["flash"][key] = max(errs["flash"].get(key, 0.0), err)
        log(f"  {tag}: max_abs_err={err:.3e} ok")


def phase6():
    log("phase 6: attention kernels vs plain on the card (tolerance by "
        "the output's type: 2e-5 f32, 3e-2 decode / 2e-2 flash bf16)")
    gen = torch.Generator(device=CUDA).manual_seed(6)
    errs = {"decode": {}, "flash": {}}
    for case, lens in DECODE_CASES:
        check_decode(case, lens, gen, errs)
    b, s, h, kv, hd = 2, 1024, 4, 2, 64          # NaN past len_b (and
    splits = decode_splits(b, s, h, kv)          # before the window)
    check(splits > 1, f"the poisoned cache runs {splits} split(s)")
    for window in (0, 600):                      # the 700-key sequence
        for kdt in (F32, BF16):                  # runs in 2 parts
            q = randn((b, h, hd), F32, gen)
            kc, vc = randn((b, s, kv, hd), kdt, gen), \
                randn((b, s, kv, hd), kdt, gen)
            lens = torch.tensor([700, 17], dtype=torch.int32, device=CUDA)
            pos = torch.arange(s, device=CUDA)[None]
            dead = pos >= lens[:, None]
            if window:
                dead |= pos < lens[:, None] - window
            dead = dead[..., None, None]
            a = kd.decode_attention(q, kc, vc, lens, window=window)
            p = kd.decode_attention(q, kc.masked_fill(dead, float("nan")),
                                    vc.masked_fill(dead, float("nan")), lens,
                                    window=window)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(p).all()) and torch.equal(a, p),
                  f"decode read a poisoned key (window {window}, {kdt})")
    log(f"  poisoned cache (NaN past len_b, and before the window; "
        f"{splits} splits, 2 parts used for the 700-key sequence): output "
        f"unchanged and finite, f32 and bf16 caches")
    for case in FLASH_CASES:
        check_flash(case, gen, errs)
    return errs


def serve_full_width(phase, w, smi):
    """Serve workload ``w`` through the burst; returns the engine, the
    decode kernel's launches while serving, and the serving numbers."""
    cfg = get_config(w["arch"])
    log(f"phase {phase}: serve {w['arch']} at full width ({cfg.n_layers} "
        f"layers, d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; f32 weights, seed "
        f"{w['seed']}; bf16 cache), {w['requests']} requests x "
        f"{w['prompt_len']}-token prompts x {w['max_new']} new tokens, "
        f"max_batch {w['max_batch']}, max_len {w['max_len']}, block 16, "
        f"the pool under a live plane on the card (hbm_pool_params, "
        f"device-memory monitor), shrunk by hand to 25% after 10 steps")
    kd.LAUNCHES = 0                        # the serving path starts here
    report = serve(**w, burst=True)
    launches = kd.LAUNCHES
    eng = report["engine"]
    st = eng.stats()
    fin = report["finished"]
    dt = report["seconds"]
    check(len(fin) == w["requests"]
          and all(len(r.output) == w["max_new"] for r in fin.values()),
          f"not drained: {st}")
    check(st["preemptions"] >= 1, f"the burst preempted nothing: {st}")
    check(st["logits_finite"], "non-finite logits")
    check(launches == st["decode_steps"] * cfg.n_layers,
          f"decode kernel launched {launches} times for "
          f"{st['decode_steps']} steps x {cfg.n_layers} layers")
    health = check_plane(eng)
    after = report["after_shrink"]
    check(after[0] == report["full"], f"the plane did not re-grant the pool "
          f"on the tick after the shrink: {after} of {report['full']}")
    log(f"  drained {len(fin)}/{w['requests']}, {report['tokens']} tokens, "
        f"{st['preemptions']} preemption(s), {st['steps']} steps "
        f"({st['decode_steps']} with an active slot); decode kernel "
        f"launches {launches} = steps x {cfg.n_layers}; logits finite")
    log(f"  plane: {health.ticks} ticks = steps, {health.summary()}; pool "
        f"{after[0] / 2**20:.0f} of {report['full'] / 2**20:.0f} MiB on the "
        f"tick after the shrink")
    log(f"  {report['tokens'] / dt:.1f} tok/s, {st['steps'] / dt:.2f} "
        f"steps/s ({dt:.3f} s, host clock) on {smi}")
    return eng, launches, {"tok_s": report["tokens"] / dt,
                           "steps_s": st["steps"] / dt, "seconds": dt,
                           "steps": st["steps"],
                           "preemptions": st["preemptions"]}


def check_plane(eng):
    """The engine's plane ticked once per step, healthy, no fault logged;
    returns its health report."""
    health = eng.plane.health()
    check(health.ticks == eng.steps, f"{health.ticks} plane ticks for "
          f"{eng.steps} engine steps")
    check(health.healthy and not eng.plane.fault_log.snapshot(),
          f"plane not healthy: {health.summary()}, faults "
          f"{eng.plane.fault_log.snapshot()}")
    return health


def forward_decode_rel(model, tokens):
    """Max |forward - decode| over max |forward| of the logits (decode
    with an f32 cache), and the forward's launches of flash and scan."""
    kf.LAUNCHES = kscan.LAUNCHES = 0       # the forward path starts here
    fwd = model(tokens)
    launches = {"flash": kf.LAUNCHES, "scan": kscan.LAUNCHES}
    check(bool(torch.isfinite(fwd).all()), "non-finite forward logits")
    b, s = tokens.shape
    state = D.init_state(model, b, s, cache_dtype="float32")
    dec = torch.cat([D.decode_step(model, state, tokens[:, t:t + 1])
                     for t in range(s)], dim=1)
    return float((fwd - dec).abs().max() / fwd.abs().max()), launches


def forward_against_decode(phase, model, batch, seq):
    """Forward (flash, and scan in a hybrid) against decode (decode
    attention) on ``batch`` x ``seq`` tokens with an f32 cache, then
    mixed progress against isolated serving.  Returns the forward's
    launches of the flash and scan kernels."""
    cfg = model.cfg
    hybrid = cfg.family == "hybrid"
    log(f"phase {phase}: forward ({'flash + scan' if hybrid else 'flash'}) "
        f"against decode (decode attention) at full width, {batch} x {seq} "
        f"tokens, f32 cache; mixed progress")
    gen = torch.Generator(device=CUDA).manual_seed(phase)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device=CUDA)
    rel, launches = forward_decode_rel(model, tokens)
    want = {"flash": cfg.n_layers, "scan": cfg.n_layers if hybrid else 0}
    check(launches == want, f"forward launched {launches} for "
          f"{cfg.n_layers} layers, expected {want}")
    check(rel < 5e-3, f"forward and decode differ by {rel:.3e} relative "
          f"(bound 5e-3)")
    log(f"  forward launches {launches}; forward vs decode: max relative "
        f"diff {rel:.3e} (bound 5e-3)")

    rng = np.random.default_rng(phase)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 9, 3)]

    def run(prompt_list):
        eng = ServingEngine(model, ServingConfig(
            max_batch=3, max_len=64, block_tokens=8, cache_dtype="float32"))
        rids = [eng.submit(p, 6) for p in prompt_list]
        done = eng.run_until_drained(max_steps=2000)
        return [done[r].output for r in rids]

    together = run(prompts)
    alone = [run([p])[0] for p in prompts]
    check(together == alone, f"mixed progress {together} != isolated "
          f"{alone}")
    log(f"  three prompts served together == each served alone: "
        f"{together}")
    return launches


def sdpa(q, k, v, **kw):
    """PyTorch's fused attention on the port's (B, S, H, hd) layouts."""
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        enable_gqa=True, **kw).transpose(1, 2)


def bound(n_bytes, n_ops, peak_ops):
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def host_us(fn, reps: int = 20) -> float:
    """Median host microseconds to issue one call of ``fn`` (no sync)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def decode_ways(run, flush, reps: int = 20):
    """B3 timed three ways at one shape: one launch between two events
    with the L2 flushed first (the earlier phases 9 and 13), the same
    with a device-side lead (the events then hold the kernel alone), and
    the profiler's device time over ``reps`` calls, with the launches
    the profiler saw of them; and the host's time to issue a call."""
    run()
    _, rows = _profiled(run, reps)
    seen = sum(e.count for e in rows if "decode" in e.key)
    return dict(events_ms=cuda_ms(run, reps=7, flush=flush),
                events_lead_ms=cuda_ms(run, reps=7, flush=flush, lead=True),
                device_ms=sum(device_us(e) for e in rows) / 1e3 / reps,
                profiler_launches_seen=seen, launches=reps,
                host_us=host_us(run))


def time_decode(tag, q, kc, vc, lens, flush, window=0):
    """B3 at one shape: kernel, plain, SDPA.  The bound counts the kept
    keys' K and V read once, q read and the output written once.  The
    kernel's and SDPA's ``ms`` are event times with a device-side lead
    (``cuda_ms(lead=True)``): a ~14 us kernel alone between two events
    otherwise reads the host's issue time on a slow host."""
    b, h, hd = q.shape
    s, kv = kc.shape[1], kc.shape[2]
    hi = lens.clamp(min=0, max=s).long()
    lo = (hi - window).clamp(min=0) if window else torch.zeros_like(hi)
    n_keys = int((hi - lo).sum())
    n_bytes = (n_keys * kv * hd * 2 * kc.element_size()
               + 2 * q.numel() * q.element_size() + lens.numel() * 4)
    bound_ms, by = bound(n_bytes, 4 * n_keys * h * hd, PEAK_F32_S)
    run = lambda: kd.decode_attention(  # noqa: E731
        q, kc, vc, lens, window=window)
    plain_run = lambda: kd.decode_attention_plain(  # noqa: E731
        q, kc, vc, lens, window=window)
    ways = decode_ways(run, flush)
    ms = ways["events_lead_ms"]
    plain = cuda_ms(plain_run, reps=3, warm=1, flush=flush, lead=True)
    got = run()
    err = max_err(got, plain_run(), 3e-2 if q.dtype == BF16 else 2e-5,
                  f"decode {tag}")
    check(torch.equal(got, run()), f"decode {tag}: two calls differ")
    splits = decode_splits(b, s, h, kv)
    qs = q.to(kc.dtype)[:, None]                     # (B, 1, H, hd)
    pos = torch.arange(s, device=CUDA)[None]
    mask = ((pos < hi[:, None])
            & (pos >= lo[:, None]))[:, None, None, :]  # (B, 1, 1, S)
    lib_out = sdpa(qs, kc, vc, attn_mask=mask)[:, 0]
    check(bool(torch.isfinite(lib_out).all()), f"{tag}: SDPA non-finite")
    lib = cuda_ms(lambda: sdpa(qs, kc, vc, attn_mask=mask), reps=5,
                  flush=flush, lead=True)
    log(f"  decode {tag}: {splits} split(s), kernel {ms:.4f} ms, plain "
        f"{plain:.3f} ms, SDPA {lib:.4f} ms, bound {bound_ms:.4f} ms by {by} "
        f"({n_bytes / 1e9:.4f} GB; {n_bytes / ms / 1e6:.1f} GB/s achieved, "
        f"{bound_ms / ms:.1%} of bound); kernel vs plain max |diff| "
        f"{err:.2e}, bit-identical twice; SDPA vs kernel max |diff| "
        f"{float((lib_out.float() - got.float()).abs().max()):.2e}")
    log(f"    the kernel three ways: one launch between two events "
        f"{ways['events_ms']:.4f} ms, with the device-side lead "
        f"{ms:.4f} ms, profiler device time {ways['device_ms']:.4f} ms "
        f"({ways['profiler_launches_seen']} of {ways['launches']} launches "
        f"seen); host issue {ways['host_us']:.1f} us a call")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound_ms,
                bound_by=by, shape=tag, max_abs_err=err, splits=splits,
                gb_s=n_bytes / ms / 1e6, ways=ways)


def kept_pairs(sq, skv, causal, window):
    """(query, key) pairs the mask keeps over positions arange(Sq/Skv)."""
    i = torch.arange(sq, dtype=torch.int64)
    hi = torch.clamp(i + 1, max=skv) if causal else torch.full_like(i, skv)
    lo = torch.clamp(i - window + 1, min=0) if window else torch.zeros_like(i)
    return int((hi - lo).clamp(min=0).sum())


def time_flash(b, s, h, kv, hd, dtype, window, gen, flush):
    """B2 at one causal (B, S) self-attention shape: kernel, plain, SDPA.

    The bound counts 4 * hd operations per kept (query, key) pair at the
    rate of the kernel's route (bf16 tensor cores; f32 as 3xTF32, three
    TF32 products for each, so a third of the TF32 rate), and q, k, v
    read and the output written once.  f32 rows also print the bound of
    the CUDA cores' f32 rate.
    """
    q = randn((b, s, h, hd), dtype, gen)
    k, v = randn((b, s, kv, hd), dtype, gen), randn((b, s, kv, hd), dtype,
                                                    gen)
    n_ops = 4 * b * h * kept_pairs(s, s, True, window) * hd
    n_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bound_ms, by = bound(n_bytes, n_ops, PEAK_BF16_S if dtype == BF16
                         else PEAK_TF32_S / 3)
    run = lambda: kf.flash_attention(q, k, v, window=window)  # noqa: E731
    plain_run = lambda: kf.flash_attention_plain(  # noqa: E731
        q, k, v, window=window)
    ms = cuda_ms(run, reps=7, flush=flush)
    plain = cuda_ms(plain_run, reps=3, warm=1, flush=flush)
    tol = 2e-2 if dtype == BF16 else 2e-5
    tag = (f"B{b} x S{s} x H{h}/KV{kv} x hd{hd} {str(dtype)[6:]} causal"
           + (f" window {window}" if window else ""))
    got = run()
    err = max_err(got, plain_run(), tol, f"flash {tag}")
    mask = kf.make_mask(torch.arange(s, device=CUDA),
                        torch.arange(s, device=CUDA), causal=True,
                        window=window)
    lib_kw = dict(attn_mask=mask) if window else dict(is_causal=True)
    lib_out = sdpa(q, k, v, **lib_kw)
    diff = float((lib_out.float() - got.float()).abs().max())
    lib = cuda_ms(lambda: sdpa(q, k, v, **lib_kw), reps=7, flush=flush)
    extra = ""
    if dtype == F32:
        cores_ms, _ = bound(n_bytes, n_ops, PEAK_F32_S)
        extra = f" (f32 CUDA cores: {cores_ms:.4f} ms)"
    log(f"  flash {tag}: kernel {ms:.4f} ms ({n_ops / ms / 1e9:.2f} "
        f"TFLOP/s), plain {plain:.3f} ms, SDPA {lib:.4f} ms, bound "
        f"{bound_ms:.4f} ms by {by}{extra}, {bound_ms / ms:.1%} of bound; "
        f"kernel vs plain max |diff| {err:.2e}; SDPA vs kernel max |diff| "
        f"{diff:.2e}")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound_ms,
                bound_by=by, shape=tag, max_abs_err=err,
                tflop_s=n_ops / ms / 1e9)


def engine_decode_shapes():
    """(tag, heads, kv heads, head dim, window) of B3 at the engine's
    shape for the two served models (phases 9 and 13)."""
    llama = get_config(ARCH)
    return [("llama", llama.n_heads, llama.n_kv_heads, llama.head_dim, 0),
            ("hymba", HYMBA.n_heads, HYMBA.n_kv_heads, HYMBA.head_dim,
             max(layer_windows(HYMBA)))]


def fresh_decode_times(lens):
    """B3 at both engine shapes with the served ``lens``, timed as
    :func:`decode_ways` does, in a process that has built no plane and
    served nothing (``chip_smoke.py --decode-times LENS``)."""
    _build.load_library("decode_attention.cu")
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=CUDA)
    gen = torch.Generator(device=CUDA).manual_seed(99)
    b, s = FULL_WIDTH["max_batch"], FULL_WIDTH["max_len"]
    lengths = torch.tensor(lens, dtype=torch.int32, device=CUDA)
    out = {}
    for tag, h, kv, hd, window in engine_decode_shapes():
        q = randn((b, h, hd), F32, gen)
        kc, vc = randn((b, s, kv, hd), BF16, gen), randn((b, s, kv, hd),
                                                          BF16, gen)
        out[tag] = decode_ways(lambda: kd.decode_attention(
            q, kc, vc, lengths, window=window), flush)
    return out


def run_fresh_decode_times(lens):
    """:func:`fresh_decode_times` in a new process; waits for it."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--decode-times",
         json.dumps(lens)], capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"the fresh decode-timing process failed:\n"
          f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def phase9(state, scfg):
    log("phase 9: times on the card (CUDA events, median of warm runs, L2 "
        "flushed before each; peaks 989 TFLOP/s bf16 and 495 TF32 on the "
        "tensor cores, 67 f32 on the CUDA cores, 3.35 TB/s)")
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=CUDA)
    gen = torch.Generator(device=CUDA).manual_seed(9)
    cfg = get_config(ARCH)
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out = {}
    lens = (state.pos + 1).clamp(max=scfg.max_len).to(torch.int32)
    out["lens"] = lens.tolist()
    t0 = time.perf_counter()
    out["fresh"] = fresh = run_fresh_decode_times(out["lens"])
    for tag, w in fresh.items():
        log(f"  decode at {tag}'s engine shape in a fresh process (no "
            f"plane, nothing served; {time.perf_counter() - t0:.1f} s): one "
            f"launch between two events {w['events_ms']:.4f} ms, with the "
            f"device-side lead {w['events_lead_ms']:.4f} ms, profiler "
            f"device time {w['device_ms']:.4f} ms "
            f"({w['profiler_launches_seen']} of {w['launches']} launches "
            f"seen); host issue {w['host_us']:.1f} us a call")
    q = randn((scfg.max_batch, h, hd), F32, gen)
    out["decode_engine"] = time_decode(
        f"engine B{scfg.max_batch} x S{scfg.max_len} x KV{kv} x hd{hd}, q "
        f"f32, bf16 cache, lengths {lens.tolist()}", q, state.k[0],
        state.v[0], lens, flush)
    del state
    b, s = DECODE_LONG                               # one layer of decode_32k
    kc, vc = randn((b, s, kv, hd), BF16, gen), randn((b, s, kv, hd), BF16,
                                                      gen)
    q = randn((b, h, hd), BF16, gen)
    lens = torch.full((b,), s, dtype=torch.int32, device=CUDA)
    out["decode_32k"] = time_decode(
        f"decode_32k layer B{b} x S{s} x KV{kv} x hd{hd} bf16, full lengths",
        q, kc, vc, lens, flush)
    del kc, vc
    torch.cuda.empty_cache()
    b, s = FLASH_TIMED
    out["flash"] = time_flash(b, s, h, kv, hd, BF16, 0, gen, flush)
    out["flash_f32"] = time_flash(b, s, h, kv, hd, F32, 0, gen, flush)
    out["flash_main"] = []
    for arch, (b, s) in ((ARCH, FLASH_MAIN_LLAMA),
                         (FULL_WIDTH_HYMBA["arch"], FLASH_MAIN_HYMBA)):
        c = get_config(arch)
        windows = layer_windows(c)
        for window in sorted(set(windows), reverse=True):
            row = time_flash(b, s, c.n_heads, c.n_kv_heads, c.head_dim, F32,
                             window, gen, flush)
            row["launches_per_forward"] = windows.count(window)
            row["model"] = arch
            out["flash_main"].append(row)
    return out


# ---- serving hymba-1.5b: the scan kernel --------------------------------

HYMBA = get_config(FULL_WIDTH_HYMBA["arch"])
# (b, s, c, n): tests/test_kernels.py's SSM_CASES, one step, then a few
# hundred steps at hymba's C = 3200, N = 16, and a ragged C x N
SCAN_CASES = [(2, 256, 128, 16), (1, 128, 256, 8), (3, 64, 128, 4),
              (2, 1, 3200, 16), (2, 300, 3200, 16), (2, 37, 5, 3)]
SCAN_TIMED = (2, 4096)           # (B, S) of the timed scan: one layer of a
#                                  2 x 4096 forward at C = 3200, N = 16
# hymba's heads (25/5 of 64) with its window of 1024, past it, with a
# ragged length; and global layers' full attention; flash also at head
# dims 16 and 128, Sq 77, and non-causal with Sq < Skv
# decode also at one (sequence, kv head) pair over 4000 keys with the
# window (its 1024 live keys split the most), at 320 pairs (one split),
# at head dims 16 and 128 with len 0 and 1 in one batch, and with windows
# that start mid-tile (313, 476)
HYMBA_DECODE = [((4, 1500, 25, 5, 64, 1024), [1, 1025, 1500, 1337]),
                ((2, 1100, 25, 5, 64, 0), [1100, 777]),
                ((1, 4000, 5, 1, 64, 1024), [3337]),
                ((64, 1100, 25, 5, 64, 1024), None),
                ((3, 700, 25, 5, 16, 1024), [0, 1, 700]),
                ((3, 1500, 25, 5, 128, 1024), [0, 1, 1500])]
HYMBA_FLASH = [(1, 1100, 1100, 25, 5, 64, True, 1024),
               (1, 1088, 1088, 25, 5, 64, True, 0),
               (2, 77, 77, 25, 5, 16, True, 50),
               (1, 1100, 1100, 25, 5, 128, True, 1024),
               (1, 77, 300, 25, 5, 128, False, 0),
               (1, 300, 1100, 25, 5, 16, False, 0)]


def scan_inputs(b, s, c, n, dtype, gen):
    decay = (torch.rand((b, s, c, n), generator=gen, device=CUDA) * 0.7
             + 0.3).to(dtype)
    drive = (randn((b, s, c, n), F32, gen) * 0.2).to(dtype)
    return decay, drive, randn((b, c, n), F32, gen)


def phase10():
    log("phase 10: the scan kernel vs plain on the card (f32 bit for bit, "
        "bf16 inputs within 1e-5); attention kernels at hymba's heads "
        "(25/5 of 64) and window 1024")
    gen = torch.Generator(device=CUDA).manual_seed(10)
    worst = 0.0
    for case in SCAN_CASES:
        for dt in (F32, BF16):
            decay, drive, h0 = scan_inputs(*case, dt, gen)
            before = kscan.LAUNCHES
            out = kscan.ssm_scan(decay, drive, h0)
            torch.cuda.synchronize()
            check(kscan.LAUNCHES == before + 1, "scan kernel did not launch")
            ref = kscan.ssm_scan_plain(decay, drive, h0)
            tag = f"scan {'x'.join(map(str, case))} {str(dt)[6:]}"
            same = torch.equal(out, ref)
            if dt == F32:
                check(same, f"{tag}: not bit-identical")
            err = max_err(out, ref, 1e-5, tag)
            worst = max(worst, err)
            log(f"  {tag}: bit-identical={same} max_abs_err={err:.3e}")
    decay, drive, h0 = scan_inputs(2, 300, 3200, 16, F32, gen)
    whole = kscan.ssm_scan(decay, drive, h0)
    first = kscan.ssm_scan(decay[:, :123], drive[:, :123], h0)
    second = kscan.ssm_scan(decay[:, 123:], drive[:, 123:], first[:, -1])
    torch.cuda.synchronize()
    check(torch.equal(torch.cat([first, second], dim=1), whole),
          "two calls carrying h0 differ from one call")
    log("  two calls, the first's last h carried as h0 == one call over "
        "the whole sequence, bit for bit")
    errs = {"decode": {}, "flash": {}}
    for case, lens in HYMBA_DECODE:
        check_decode(case, lens, gen, errs)
    for case in HYMBA_FLASH:
        check_flash(case, gen, errs)
    return worst, errs


def mamba_paper_init(model, seed):
    """Give every Mamba branch the A and dt of the Mamba paper's init
    (S4D-real A = -(1, ..., N) per channel; dt log-uniform in [1e-3,
    1e-1] per channel through ``dt_bias``), in place.

    The JAX init kinds (``a_log`` ones, ``dt_bias`` zeros) make A and dt
    the same for every channel, and dt one scalar per token, so
    ``y + x * d_skip = x * (1 + dt * B.C) + ...`` cancels in every
    channel at once where ``dt * B.C`` nears -1.  The weightless RMS
    fusion then scales that token's rounding up to unit size, and 32
    layers compound it: forward and decode, which round differently,
    drift apart by ~1e-2 however right both are.
    """
    gen = torch.Generator(device=CUDA).manual_seed(seed)
    lo, hi = np.log(1e-3), np.log(1e-1)
    with torch.no_grad():
        for layer in model.layers:
            p = layer.mamba
            inner, n = p.a_log.shape
            p.a_log.copy_(torch.log(torch.arange(1, n + 1, device=CUDA,
                                                 dtype=F32)).expand(inner, n))
            dt = torch.exp(torch.rand(inner, generator=gen, device=CUDA)
                           * (hi - lo) + lo)
            p.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))   # softplus^-1


def phase12(model):
    """Forward against decode at 1 x 1088 tokens, past the window, so the
    local layers really window.  Returns the gated run's launches and the
    served (JAX-init) model's forward-vs-decode difference."""
    gen = torch.Generator(device=CUDA).manual_seed(120)
    tokens = torch.randint(0, model.cfg.vocab_size, (1, 1088), generator=gen,
                           device=CUDA)
    rel_jax_init, _ = forward_decode_rel(model, tokens)
    log(f"phase 12 (not gated): the served model, JAX init of a_log/dt_bias: "
        f"forward vs decode max relative diff {rel_jax_init:.3e} at 1 x 1088 "
        f"tokens")
    mamba_paper_init(model, 12)
    return forward_against_decode(12, model, 1, 1088), rel_jax_init


def phase13(state, scfg):
    """The decode kernel at hymba's engine shape, on phase 11's final
    cache and lengths, then the scan kernel at one layer of a 2 x 4096
    forward.  Returns the two rows."""
    b, s = SCAN_TIMED
    c, n = HYMBA.ssm_expand * HYMBA.d_model, HYMBA.ssm_state
    log(f"phase 13: decode and scan kernel times on the card (CUDA events, "
        f"median of warm runs, L2 flushed before each; 3.35 TB/s, f32 67 "
        f"TFLOP/s); decode at hymba's engine shape, scan at {b} x {s} x {c}"
        f" x {n} f32")
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=CUDA)
    gen = torch.Generator(device=CUDA).manual_seed(13)
    h, kv, hd = HYMBA.n_heads, HYMBA.n_kv_heads, HYMBA.head_dim
    window = max(layer_windows(HYMBA))
    lens = (state.pos + 1).clamp(max=scfg.max_len).to(torch.int32)
    q = randn((scfg.max_batch, h, hd), F32, gen)
    # max_len 1024 <= the window, so a local layer keeps every key as a
    # global one does: this one row stands for both kinds of layer
    dec = time_decode(
        f"hymba engine B{scfg.max_batch} x S{scfg.max_len} x H{h}/KV{kv} x "
        f"hd{hd}, q f32, bf16 cache, window {window} (keeps every key at "
        f"max_len {scfg.max_len}: local and global layers alike), lengths "
        f"{lens.tolist()}", q, state.k[0], state.v[0], lens, flush,
        window=window)
    dec["lens"] = lens.tolist()
    del state
    decay, drive, h0 = scan_inputs(b, s, c, n, F32, gen)
    n_el = decay.numel()
    # each input read once, each output written once; 2 operations each
    n_bytes = (decay.numel() + drive.numel() + h0.numel() + n_el) * 4
    bound_ms, by = bound(n_bytes, 2 * n_el, PEAK_F32_S)
    ms = cuda_ms(lambda: kscan.ssm_scan(decay, drive, h0), reps=7,
                 flush=flush)
    plain = cuda_ms(lambda: kscan.ssm_scan_plain(decay, drive, h0), reps=3,
                    warm=1, flush=flush)
    got = kscan.ssm_scan(decay, drive, h0)
    ref = kscan.ssm_scan_plain(decay, drive, h0)
    err = float((got - ref).abs().max())
    check(torch.equal(got, ref), f"timed scan differs from plain by {err}")
    tag = f"B{b} x S{s} x C{c} x N{n} f32"
    log(f"  scan {tag}: kernel {ms:.4f} ms ({n_bytes / ms / 1e6:.1f} GB/s), "
        f"plain {plain:.3f} ms, bound {bound_ms:.4f} ms by {by} "
        f"({n_bytes / 1e9:.3f} GB), {bound_ms / ms:.1%} of bound; library "
        f"none; kernel vs plain max |diff| {err:.2e}")
    return dec, dict(ms=ms, plain_ms=plain, library_ms=None,
                     bound_ms=bound_ms, bound_by=by, shape=tag,
                     max_abs_err=err, share_of_bound=bound_ms / ms)


# ---- llama3.2-1b under device-memory pressure: the live plane ---------

WARM_STEPS = 10          # steps before the pressure (u climbs to u_max)
PRESSURE_TICKS = 30      # at most, until the plane has emptied the pool
RECOVERY_TICKS = 3       # the pool must be full again within these
ALONE_TICKS = 20         # ticks timed alone for syncs and launches


def plane_replay(cap, u0, node):
    """The captured samples through a CPU plane (array backend): its
    actions, one per tick."""
    used = cap.demand[0] + cap.residency[0]   # exact: integer byte counts
    replay = MemoryPlane(PlaneSpec(
        params=hbm_pool_params(), device="cpu",
        nodes=(NodeSpec(node, monitor=SimulatedMonitor(
            node, total=float(cap.total_memory[0]), usage=list(used)),
            registry=StoreRegistry(), u0=u0),)))
    return [replay.tick()[0] for _ in range(len(used))]


def phase14(smi):
    """Serve FULL_WIDTH while one tensor takes the card to (r0 + 0.03) M:
    the plane alone resizes the pool.  Returns the decode kernel's
    launches and the phase's numbers."""
    w = FULL_WIDTH
    cfg = get_config(w["arch"])
    torch.cuda.empty_cache()
    kd.LAUNCHES = 0                        # the pressure path starts here
    eng = build_engine(**w)
    plane, node = eng.plane, eng.node
    plane.record()
    full = eng.pool.capacity()
    p = plane.params
    log(f"phase 14: serve {w['arch']} at full width as in phase 7, the "
        f"pool ({full / 2**20:.0f} MiB) under the plane alone (r0 {p.r0}, "
        f"lam {p.lam}, lam_grant {p.lam_grant}, u_max {p.u_max:.4e} B); "
        f"after {WARM_STEPS} steps one tensor takes memory_allocated to "
        f"(r0 + 0.03) M for up to {PRESSURE_TICKS} ticks")
    with count_syncs() as syncs:
        for _ in range(WARM_STEPS):
            eng.step()
    syncs_per_step = len(syncs) / WARM_STEPS
    tick_s, step_s = watch_ticks(plane), []

    def step():
        t0 = time.perf_counter()
        eng.step()
        step_s.append(time.perf_counter() - t0)

    total = float(plane.capture().total_memory[0])
    target = (p.r0 + 0.03) * total
    need = math.ceil(target) - torch.cuda.memory_allocated()
    free = torch.cuda.mem_get_info()[0]
    check(0 < need <= free - GiB, f"cannot take the card to (r0 + 0.03) M = "
          f"{target:.4e} B: {need} B more needed, {free} B free less 1 GiB")
    burst = torch.empty(need, dtype=torch.uint8, device=CUDA)
    check(torch.cuda.memory_allocated() >= target, "the tensor fell short")
    at = eng.steps                          # ticks before the pressure
    for _ in range(PRESSURE_TICKS):
        step()
        if eng.pool.capacity() == 0:
            break
    check(eng.pool.capacity() == 0, f"the plane did not empty the pool in "
          f"{eng.steps - at} ticks")
    del burst
    released = eng.steps
    for _ in range(RECOVERY_TICKS):
        step()
        if eng.pool.capacity() == full:
            break
    recovery = eng.steps - released
    check(eng.pool.capacity() == full, f"pool not full {RECOVERY_TICKS} "
          f"ticks after the release: {eng.pool.capacity()} of {full}")
    while eng.queue or any(not s.free for s in eng.slots):
        step()
        check(eng.steps < 5000, "the engine did not drain")
    launches = kd.LAUNCHES
    st = eng.stats()
    fin = eng.finished
    check(len(fin) == w["requests"]
          and all(len(r.output) == w["max_new"] for r in fin.values()),
          f"not drained: {st}")
    check(st["logits_finite"], "non-finite logits")
    check(launches == st["decode_steps"] * cfg.n_layers,
          f"decode kernel launched {launches} times for "
          f"{st['decode_steps']} steps x {cfg.n_layers} layers")
    health = check_plane(eng)
    acts = plane.actions(node=node)
    check(len(acts) == eng.steps, f"{len(acts)} actions for {eng.steps} "
          f"ticks")
    evicted = [sum(len(r.evicted_keys) for r in a.reports) for a in acts]
    shrunk = [min(r.applied_capacity for r in a.reports) < full
              for a in acts]
    check(sum(evicted) >= 1, "the plane preempted nothing")
    first_shrink = shrunk.index(True) + 1 - at
    first_preempt = next(i for i, n in enumerate(evicted) if n) + 1 - at
    replay = plane_replay(plane.capture(), full, node)
    same = [(a.u_prev, a.u_next, a.epoch) for a in acts] == \
        [(a.u_prev, a.u_next, a.epoch) for a in replay]
    check(same, "the card's actions differ from their CPU replay")
    n_steps = len(step_s)
    tick_ms = [t * 1e3 for t in tick_s[:n_steps]]
    share = sum(tick_s[:n_steps]) / sum(step_s)
    with count_syncs() as syncs:
        for _ in range(ALONE_TICKS):
            plane.tick()
    syncs_per_tick = len(syncs) / ALONE_TICKS
    check(syncs_per_tick <= 1, f"a tick made {syncs_per_tick} syncs")
    per_tick = tick_launches(plane, ALONE_TICKS)
    u = [a.u_next for a in acts]
    log(f"  M {total:.4e} B (monitor), tensor {need:.4e} B; u before the "
        f"pressure (ticks 1-{at}): "
        + ", ".join(f"{x:.4e}" for x in u[:at]))
    log(f"  u under pressure (ticks {at + 1}-{released}): "
        + ", ".join(f"{x:.4e}" for x in u[at:released])
        + f"; after the release: "
        + ", ".join(f"{x:.4e}" for x in u[released:released + recovery]))
    log(f"  ticks from the allocation to the first shrink {first_shrink}, "
        f"to the first preemption {first_preempt}; {sum(evicted)} "
        f"sequence(s) preempted by the plane, {st['preemptions']} "
        f"preemption(s) in all; pool full {recovery} tick(s) after the "
        f"release (re-grant {u[released] - u[released - 1]:.4e} B)")
    log(f"  drained {len(fin)}/{w['requests']}, {st['steps']} steps "
        f"({st['decode_steps']} with an active slot); decode kernel "
        f"launches {launches} = steps x {cfg.n_layers}; {health.summary()}; "
        f"card u_next == CPU replay bit for bit over {len(acts)} ticks")
    log(f"  tick host ms median {statistics.median(tick_ms):.4f}, max "
        f"{max(tick_ms):.4f}, {share:.4f} of the step ({n_steps} steps); "
        f"syncs {syncs_per_step:.2f} per step (the first {WARM_STEPS}), "
        f"{syncs_per_tick:.2f} per tick alone; {per_tick:.1f} kernels and "
        f"copies per tick, on {smi}")
    return launches, {
        "total_memory": total, "tensor_bytes": need, "ticks": eng.steps,
        "first_shrink_tick": first_shrink,
        "first_preemption_tick": first_preempt,
        "preempted_by_plane": sum(evicted), "recovery_ticks": recovery,
        "regrant_bytes": u[released] - u[released - 1],
        "tick_ms_median": statistics.median(tick_ms),
        "tick_ms_max": max(tick_ms), "tick_share_of_step": share,
        "syncs_per_step": syncs_per_step, "syncs_per_tick": syncs_per_tick,
        "launches_per_tick": per_tick, "u_next": u[:released + recovery]}


# ---- the ReplayLoop on the card: capture, replay, retune ---------------

RETUNE_BUDGET, RETUNE_RESTARTS = 16, 2     # the serve CLI's defaults
FLEET_TUNE_BUDGET = 512                    # halving at the fleet's size
# The paper testbed's burst window: the run cut at this many intervals
# (the default trace keeps the last 4096, after HPCC has finished).
BURST_WINDOW = 4096


def sweep_kernel_events(fn):
    """``fn()`` with every sweep kernel launch timed by a pair of CUDA
    events on the launching stream, each after a device-side lead (so
    the pair holds the kernel alone): ``fn``'s result, the kernels' ms
    summed, and the launches."""
    pairs, inner = [], ks._launch

    def timed(*args, **kw):
        torch.cuda._sleep(LEAD_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = inner(*args, **kw)
        b.record()
        pairs.append((a, b))
        return out

    ks._launch = timed
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        ks._launch = inner
    return out, sum(a.elapsed_time(b) for a, b in pairs), len(pairs)


def same_round(card, cpu, n_samples, tag):
    """Two retune rounds on one capture make one decision."""
    same = all(np.array_equal(getattr(card.tune.sweep.gains, f),
                              getattr(cpu.tune.sweep.gains, f))
               for f in ("r0", "lam", "lam_grant", "deadband",
                         "feedforward"))
    check(same, f"{tag}: the halving survivors differ, card vs CPU")
    check(card.params == cpu.params, f"{tag}: winners differ: "
          f"{card.params} vs {cpu.params}")
    check((card.swapped, card.epoch) == (cpu.swapped, cpu.epoch),
          f"{tag}: swapped/epoch {card.swapped}/{card.epoch} vs "
          f"{cpu.swapped}/{cpu.epoch}")
    assert_same(f"{tag}: final lanes", card.tune.sweep.stats,
                cpu.tune.sweep.stats, n_samples)


def phase15a(smi):
    """Serve FULL_WIDTH through the burst under a recording plane, retune
    the pool's gains on the capture on the card (non-blocking, supervised)
    and serve a second wave; the same round on the CPU from the same
    capture.  Returns the sweep and decode kernels' launches and the
    numbers."""
    w = FULL_WIDTH
    cfg = get_config(w["arch"])
    log(f"phase 15a: serve {w['arch']} at full width with the burst under "
        f"a plane recording 2048 intervals; retune_online(kv-pool-replay, "
        f"budget {RETUNE_BUDGET}, restarts {RETUNE_RESTARTS}, "
        f"block=False) on the card; a second wave of "
        f"{w['requests'] // 2} prompts")
    torch.cuda.empty_cache()
    kd.LAUNCHES = ks.LAUNCHES = 0          # the retune path starts here
    report = serve(**w, burst=True, retune=True,
                   retune_budget=RETUNE_BUDGET,
                   retune_restarts=RETUNE_RESTARTS)
    n_sweep, n_decode = ks.LAUNCHES, kd.LAUNCHES
    eng, res, w2 = report["engine"], report["retune"], report["wave2"]
    st, first = eng.stats(), report["stats"]["steps"]
    cap = res.capture
    check(n_sweep > 0, "the retune round never launched the sweep kernel")
    check(report["retune_attempts"] == 1 and not report["retune_restarts"],
          f"the round restarted: {report['retune_attempts']} attempts")
    check(cap.n_intervals == first, f"capture of {cap.n_intervals} "
          f"intervals for {first} steps")
    check(w2["requests"] == w["requests"] // 2 and w2["epoch"] ==
          eng.plane.epoch, f"second wave: {w2}")
    check(all(len(r.output) == w["max_new"] for r in eng.finished.values())
          and len(eng.finished) == w["requests"] + w["requests"] // 2,
          f"not drained: {st}")
    check(n_decode == st["decode_steps"] * cfg.n_layers,
          f"decode kernel launched {n_decode} times for "
          f"{st['decode_steps']} steps x {cfg.n_layers} layers")
    health = check_plane(eng)
    acts = eng.plane.actions(node=eng.node)
    epochs = [a.epoch for a in acts]
    check(len(acts) == eng.steps, f"{len(acts)} actions for {eng.steps} "
          f"ticks")
    check(epochs[:first] == [0] * first and epochs[first:] ==
          [eng.plane.epoch] * (eng.steps - first),
          "an action of a wave is not stamped with the epoch it ran under")
    cpu_plane = MemoryPlane(PlaneSpec(params=res.old_params,
                                      backend="scalar"))
    t0 = time.perf_counter()
    cpu = retune_online(cpu_plane, capture=cap, name="kv-pool-replay",
                        budget=RETUNE_BUDGET, device="cpu")
    cpu_s = time.perf_counter() - t0
    same_round(res, cpu, cap.demand.size, "kv-pool-replay")
    _, b1_ms, b1_n = sweep_kernel_events(lambda: tune_gains(
        res.scenario, base_params=res.old_params, method="halving",
        budget=RETUNE_BUDGET))
    cache = res.scenario.cache
    rounds = " -> ".join(f"{r['n_candidates']}@T={r['horizon']}"
                         for r in res.tune.rounds)
    log(f"  capture: {cap.n_intervals} intervals x {len(cap.nodes)} node, "
        f"demand {cap.demand.min():.4e}-{cap.demand.max():.4e} B, grant "
        f"{cap.grant.min():.4e}-{cap.grant.max():.4e} B, residency "
        f"{cap.residency.min():.4e}-{cap.residency.max():.4e} B")
    log(f"  CacheSpec fitted: {cache is not None}"
        + (f" ({cache})" if cache is not None else "") + f"; rungs {rounds}")
    log(f"  {res.summary()}; epoch {eng.plane.epoch}; the round "
        f"{report['retune_seconds'] * 1e3:.1f} ms wall (host clock, card), "
        f"{cpu_s * 1e3:.1f} ms on the CPU; same survivors, winner, swapped "
        f"and epoch on both")
    log(f"  sweep kernel: {n_sweep} launches in the round; one halving of "
        f"the round's scenario again, each launch between two events: "
        f"{b1_n} launches, {b1_ms:.4f} ms")
    tok1 = report["tokens"] / report["seconds"]
    tok2 = w2["tokens"] / w2["seconds"]
    log(f"  wave 1: {len(report['finished'])} requests, {report['tokens']} "
        f"tokens, {tok1:.1f} tok/s ({first} steps); wave 2 under epoch "
        f"{w2['epoch']}: {w2['requests']} requests, {w2['tokens']} tokens, "
        f"{tok2:.1f} tok/s; {health.summary()}; decode launches "
        f"{n_decode} = steps x {cfg.n_layers}; on {smi}")
    return n_sweep, n_decode, {
        "round_ms": report["retune_seconds"] * 1e3, "cpu_round_ms":
        cpu_s * 1e3, "sweep_launches": n_sweep, "sweep_ms": b1_ms,
        "sweep_launches_timed": b1_n, "cache_fitted": cache is not None,
        "cache": None if cache is None else dataclasses.asdict(cache),
        "rounds": res.tune.rounds, "swapped": res.swapped,
        "epoch": eng.plane.epoch, "deployed_score": res.tune.baseline_score,
        "tuned_score": res.tune.score, "capture_intervals": cap.n_intervals,
        "wave1_tok_s": tok1, "wave2_tok_s": tok2, "steps": eng.steps}


def replay_capture(tag, cap, gated):
    """``cap`` as a replay scenario through ``run_sweep`` at Table I, on
    the card against the CPU, and against the capture's own p99 and mean
    utilization (gated: JAX's fidelity gates, 0.02 and 0.01)."""
    spec = ScenarioSpec.from_capture(cap, name="paper-testbed")
    gains = GainSet.from_params(paper_controller_params())
    card = run_sweep(spec, gains)
    cpu = run_sweep(spec, gains, device="cpu")
    assert_same(f"replay of the {tag}", card.stats, cpu.stats,
                cap.demand.size)
    p99, mean = float(card.stats.p99_utilization[0]), \
        float(card.stats.mean_utilization[0])
    d_p99 = abs(p99 - cap.utilization_p99())
    d_mean = abs(mean - float(cap.utilization.mean()))
    log(f"  {tag} ({cap.n_intervals} intervals x {len(cap.nodes)} nodes, "
        f"CacheSpec fitted: {spec.cache is not None}): replay p99 "
        f"{p99:.6f} vs captured {cap.utilization_p99():.6f} (|diff| "
        f"{d_p99:.2e}), mean {mean:.6f} vs {cap.utilization.mean():.6f} "
        f"(|diff| {d_mean:.2e})" + ("" if gated else "; not gated"))
    if gated:
        check(d_p99 <= 0.02 and d_mean <= 0.01, f"{tag}: the replay misses "
              f"the capture (p99 {d_p99:.3e} > 0.02 or mean {d_mean:.3e} > "
              f"0.01)")
    return dict(p99_replay=p99, p99_captured=cap.utilization_p99(),
                mean_replay=mean, mean_captured=float(cap.utilization.mean()),
                cache_fitted=spec.cache is not None)


def tune_fleet(tag, cap):
    """``cap`` tiled to the lab fleet's 4096 nodes, halving over
    FLEET_TUNE_BUDGET candidates on the card: wall time, and the sweep
    kernel's launches and time in a second call, each launch between two
    events."""
    spec = ScenarioSpec.from_capture(cap, name="paper-testbed-4096",
                                     n_nodes=N_NODES)

    def tune():
        return tune_gains(spec, method="halving", budget=FLEET_TUNE_BUDGET)

    before = ks.LAUNCHES
    t0 = time.perf_counter()
    r = tune()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ks.LAUNCHES - before
    _, b1_ms, b1_n = sweep_kernel_events(tune)
    rounds = " -> ".join(f"{x['n_candidates']}@T={x['horizon']}"
                         for x in r.rounds)
    log(f"  {tag} tiled to {N_NODES} nodes, halving over "
        f"{FLEET_TUNE_BUDGET} candidates ({rounds}; CacheSpec fitted: "
        f"{spec.cache is not None}): {wall:.3f} s wall (host clock, from "
        f"the scenario), sweep kernel {b1_n} launches, {b1_ms:.4f} ms; "
        f"winner "
        f"r0={r.params.r0:.4f} lam={r.params.lam:.4f} lam_grant="
        f"{r.params.lam_grant} score {r.score:.6f} (Table I "
        f"{r.baseline_score:.6f})")
    return dict(wall_s=wall, sweep_launches=launches, sweep_ms=b1_ms,
                rounds=r.rounds, cache_fitted=spec.cache is not None,
                score=r.score, baseline_score=r.baseline_score)


def phase15b():
    """The paper's testbed (config 3, Table I) simulated on the host with
    its plane recording; its capture replayed and tuned on the card.
    Returns the sweep kernel's launches (the replays and each capture's
    first tuning call) and the numbers."""
    log(f"phase 15b: simulate(make_paper_config(3, record_trace=True)) on "
        f"the host (5 nodes of 125 GiB, Table I), its capture replayed "
        f"through run_sweep on the card, then tuned at {N_NODES} nodes; "
        f"also the burst window (the run cut at {BURST_WINDOW} intervals)")
    t0 = time.perf_counter()
    sim = simulate(make_paper_config(3, record_trace=True))
    window = simulate(make_paper_config(3, record_trace=True,
                                        max_sim_s=BURST_WINDOW * 0.1))
    sim_s = time.perf_counter() - t0
    log(f"  simulated in {sim_s:.1f} s (host): app runtime "
        f"{sim.app_runtime_s:.1f} s over {len(sim.t_s)} intervals, hit "
        f"ratio {sim.hit_ratio:.4f}; the trace keeps the last "
        f"{sim.trace.n_intervals}")
    ks.LAUNCHES = 0                        # the testbed path starts here
    out = {"simulate_s": sim_s,
           "replay": replay_capture("testbed capture", sim.trace, True),
           "replay_burst_window": replay_capture("burst window",
                                                 window.trace, False)}
    launches = ks.LAUNCHES
    check(launches > 0, "the replay never launched the sweep kernel")
    out["tune_4096"] = tune_fleet("testbed capture", sim.trace)
    out["tune_4096_burst_window"] = tune_fleet("burst window", window.trace)
    launches += sum(out[k]["sweep_launches"]
                    for k in ("tune_4096", "tune_4096_burst_window"))
    return launches, out


def phase15c():
    """``simulate_fleet(4096, 1000, seed=1)``, lab engine, on the card
    against the port's CPU run and JAX's fleet gates."""
    log(f"phase 15c: simulate_fleet({N_NODES}, {N_STEPS}, seed=1), lab "
        f"engine, card against the CPU")
    ks.LAUNCHES = 0                        # the fleet path starts here
    t0 = time.perf_counter()
    card = simulate_fleet(N_NODES, N_STEPS, seed=1)
    wall = time.perf_counter() - t0
    launches = ks.LAUNCHES
    cpu = simulate_fleet(N_NODES, N_STEPS, seed=1, device="cpu")

    def stats(d):
        return FleetStats(*(np.array([d[f]]) for f in FleetStats._fields))
    assert_same("simulate_fleet", stats(card), stats(cpu), N_NODES * N_STEPS)
    check(card["p99_utilization"] <= 1.0
          and card["frac_intervals_over_r0"] < 0.08
          and card["mean_utilization"] < 0.95, f"fleet gates: {card}")
    _, b1_ms, b1_n = sweep_kernel_events(
        lambda: simulate_fleet(N_NODES, N_STEPS, seed=1))
    log(f"  {launches} launch(es), {wall * 1e3:.1f} ms wall (host clock); "
        f"again with each launch between two events: {b1_n} launch(es), "
        f"{b1_ms:.4f} ms of sweep kernel; p99 "
        f"{card['p99_utilization']:.6f} <= 1.0, over r0 "
        f"{card['frac_intervals_over_r0']:.6f} < 0.08, mean "
        f"{card['mean_utilization']:.6f} < 0.95")
    check(launches > 0, "simulate_fleet never launched the sweep kernel")
    return launches, {"wall_ms": wall * 1e3, "sweep_ms": b1_ms,
                      "sweep_launches_timed": b1_n,
                      **{k: card[k] for k in ("p99_utilization",
                                              "frac_intervals_over_r0",
                                              "mean_utilization")}}

# ---- AppGraph: the queue/barrier carry in the sweep kernel -------------

GRAPH_M = 125 * GiB                        # the registry's node memory
GRAPH_TUNE_BUDGET = 64


def spark_dag_fleet(n_nodes):
    """spark-dag at ``n_nodes``, each stage's task count scaled by
    n_nodes / 16 so that a node keeps the registry's ~288 GiB of work
    (a task count of 0, one task a node, stays 0)."""
    spec = get_scenario("spark-dag")
    scale = n_nodes // spec.n_nodes
    stages = tuple(dataclasses.replace(st, tasks=st.tasks * scale)
                   for st in spec.app_graph.stages)
    return spec.replace(n_nodes=n_nodes,
                        app_graph=spec.app_graph.replace(stages=stages))


def graph_fleets():
    """(tag, scenario, 64 gains) of phase 16's kernel checks and times:
    limplock and spark-dag at their sizes (one block a lane), and at the
    sweep bench's 4096 nodes (several blocks a lane, a barrier between
    them every interval)."""
    return [("limplock 8x1200", get_scenario("limplock"), gains_64("paper")),
            ("spark-dag 16x1800", get_scenario("spark-dag"),
             gains_64("generic")),
            (f"limplock {N_NODES}x1200",
             get_scenario("limplock").replace(n_nodes=N_NODES),
             gains_64("generic")),
            (f"spark-dag {N_NODES}x1800", spark_dag_fleet(N_NODES),
             gains_64("paper"))]


def graph_inputs(spec, gains, n_dead=0, graph=True):
    """The segment operands of ``spec``'s whole horizon on the card (the
    graph instance's, or the graph-free instance's on the same demand)."""
    app = spec.app_graph if graph else None
    plan = plan_specialization(gains)
    con = fs._engine_consts(plan, spec.cache, spec.interval_s, 1.0, "f32",
                            app)
    names = ks.state_names(con.paper_law, con.has_cache, con.has_graph)
    demand = spec.build_demand(seed=0)
    dtn, rows, lp = fs._stage(demand, gains, GRAPH_M, spec.cache, "f32",
                              CUDA)
    g, total = fs._stage_graph(app, spec.n_nodes, CUDA)
    alive = fs._alive(len(gains), len(gains) - n_dead, CUDA)
    state0 = fs._init_state(lp, rows, dtn[0].float(), con, names, g)
    return ((state0, fs._zero_hist(lp), dtn, lp, rows, alive),
            dict(t0=0, con=con, names=names, graph=g), total)


def graph_kernel(args, kw):
    """The kernel over every lane of ``args``, in as many launches as
    co-residency asks (one where one block holds a lane)."""
    state0, hist0, dtn, lp, rows, alive = args
    n_lanes = lp.shape[1]
    limit = n_lanes
    if kw["con"].has_graph:
        limit = ks.graph_lane_limit(kw["con"], dtn.shape[1], CUDA) or n_lanes
    outs = [ks.sweep_segment(state0[:, lo:lo + limit].contiguous(),
                             hist0[lo:lo + limit].contiguous(), dtn,
                             lp[:, lo:lo + limit].contiguous(), rows,
                             alive[:, lo:lo + limit].contiguous(), **kw)
            for lo in range(0, n_lanes, limit)]
    if len(outs) == 1:
        return outs[0]
    return (torch.cat([o[0] for o in outs], 1),
            torch.cat([o[1] for o in outs], 0))


def phase16a():
    """The graph instance against its plain version on the card: the
    state planes and histograms, and the makespans they finalize to."""
    log("phase 16a: the sweep kernel's AppGraph instance vs plain on the "
        "card, 64 lanes (5 dead): limplock and spark-dag at their sizes "
        "(one block a lane) and at 4096 nodes (a barrier between blocks)")
    worst, out = 0.0, {}
    for tag, spec, gains in graph_fleets():
        args, kw, total = graph_inputs(spec, gains, n_dead=5)
        con, names = kw["con"], kw["names"]
        limit = ks.graph_lane_limit(con, spec.n_nodes, CUDA)
        before = ks.LAUNCHES
        sk, hk = graph_kernel(args, kw)
        torch.cuda.synchronize()
        n_launch = ks.LAUNCHES - before
        sp, hp = ks.sweep_segment_plain(*args, **kw)
        torch.cuda.synchronize()
        max_abs, max_rel = compare_planes(names, sk, sp)
        live = hk.shape[0] - 5
        n_bins = int((hk != hp).sum())
        dead_ok = (int(hk[live:].abs().sum()) == 0
                   and torch.equal(sk[:, live:], args[0][:, live:]))
        counts_ok = hk[:live].sum(1).tolist() == \
            [spec.n_intervals * spec.n_nodes] * live
        fin = [fs._finalize_lanes(st, h, args[3], con, names,
                                  spec.n_intervals, total).makespan[:live]
               for st, h in ((sk, hk), (sp, hp))]
        same_makespan = torch.equal(*fin)
        t_done = sk[names.index("t_done")][:live]
        finished = int((t_done[:, 0] >= 0).sum())
        agree = bool((t_done == t_done[:, :1]).all())
        exact = torch.equal(sk, sp) and n_bins == 0
        log(f"  {tag} ({'cache-on' if spec.cache else 'cache-off'}, "
            f"{n_launch} launch(es), lanes a launch "
            f"{limit or 'unlimited'}): bit-identical={exact} max_abs="
            f"{max_abs:.3e} max_rel={max_rel:.3e} hist_bins_differing="
            f"{n_bins} makespan_equal={same_makespan} finished {finished} "
            f"of {live} lanes (makespan {float(fin[0].min()):.2f}-"
            f"{float(fin[0].max()):.2f} s) t_done_agrees_over_nodes={agree}"
            f" dead_lanes_ok={dead_ok} counts_ok={counts_ok}")
        check(dead_ok, f"{tag}: dead lanes counted codes or moved state")
        check(counts_ok, f"{tag}: a live lane did not count T x N updates")
        check(agree, f"{tag}: the nodes of a lane disagree on t_done")
        check(bool(torch.isfinite(sk).all()), f"{tag}: non-finite state")
        check(same_makespan, f"{tag}: makespans differ, kernel vs plain")
        if spec.cache is None:
            check(exact, f"{tag}: the cache-off graph instance is not "
                  f"bit-identical to its plain version")
        else:
            check(max_rel <= 1e-6, f"{tag}: cache-on state off by "
                  f"{max_rel:.3e} relative (bound 1e-6)")
            check(n_bins <= live, f"{tag}: {n_bins} histogram bins differ")
        worst = max(worst, max_abs)
        out[tag] = dict(bit_identical=exact, max_abs_err=max_abs,
                        max_rel_err=max_rel, hist_bins_differing=n_bins,
                        launches=n_launch, lanes_per_launch=limit,
                        lanes_finished=finished)
    return worst, out


def static_gains(grant_gib=25.0):
    """The paper's static baseline: the grant pinned, the law inert."""
    return GainSet.from_params(paper_controller_params(
        lam=0.0, u_min=grant_gib * GiB, u_max=grant_gib * GiB))


def phase16b():
    """BENCH_appgraph.json's gates on the card, and the card's makespans
    against the port's CPU run."""
    log("phase 16b: the AppGraph gates on the card (spark-dag static 25 "
        "GiB vs Table I >= 2.0x; limplock one 4x node vs healthy in [3.5, "
        "4.5]), card against CPU")
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "BENCH_appgraph.json")) as f:
        jax_rec = json.load(f)
    spark = get_scenario("spark-dag")
    kw = dict(node_memory=GRAPH_M, interval_s=spark.interval_s,
              cache=spark.cache, app_graph=spark.app_graph)
    demand = spark.build_demand(seed=0)
    gains = static_gains().concat(GainSet.from_params(PAPER_TABLE_I))
    card = sweep_demand(demand, gains, **kw)
    cpu = sweep_demand(demand, gains, device="cpu", **kw)
    assert_same("spark-dag static + Table I", card, cpu, demand.size)
    gap = float(card.makespan[0]) / float(card.makespan[1])
    lim = get_scenario("limplock")
    healthy = lim.replace(app_graph=lim.app_graph.replace(slow_nodes=(),
                                                          slow_factor=1.0))
    runs = {}
    for name, spec in (("one-4x-node", lim), ("healthy", healthy)):
        runs[name] = (run_sweep(spec, static_gains()).stats,
                      run_sweep(spec, static_gains(), device="cpu").stats)
        assert_same(f"limplock {name}", *runs[name],
                    spec.n_nodes * spec.n_intervals)
    inflation = float(runs["one-4x-node"][0].makespan[0]) / float(
        runs["healthy"][0].makespan[0])
    card_ms = [float(x) for x in card.makespan] + [
        float(runs[k][0].makespan[0]) for k in ("one-4x-node", "healthy")]
    cpu_ms = [float(x) for x in cpu.makespan] + [
        float(runs[k][1].makespan[0]) for k in ("one-4x-node", "healthy")]
    rec = {r["config"]: r["makespan_s"]
           for r in jax_rec["makespan_gap"] + jax_rec["limplock"]}
    log(f"  spark-dag makespan static {card_ms[0]:.4f} s, Table I "
        f"{card_ms[1]:.4f} s: gap {gap:.4f}x (JAX's record "
        f"{rec['static-25g']:.2f} / {rec['dynamic-table1']:.2f} s)")
    log(f"  limplock one 4x node {card_ms[2]:.4f} s, healthy {card_ms[3]:.4f}"
        f" s: inflation {inflation:.4f}x (JAX's record "
        f"{rec['one-4x-node']:.1f} / {rec['healthy']:.1f} s)")
    log(f"  card makespans == CPU: {card_ms == cpu_ms} ({card_ms} vs "
        f"{cpu_ms})")
    check(gap >= 2.0, f"spark-dag gap {gap:.3f}x < 2.0x")
    check(3.5 <= inflation <= 4.5, f"limplock inflation {inflation:.3f}x "
          f"outside [3.5, 4.5]")
    check(card_ms == cpu_ms, "the card's makespans differ from the CPU's")
    return dict(spark_dag_static_s=card_ms[0], spark_dag_table1_s=card_ms[1],
                gap=gap, limplock_slow_s=card_ms[2],
                limplock_healthy_s=card_ms[3], inflation=inflation)


def recorded_rounds(fn):
    """``fn()`` with the gain sets of every run_sweep the tuner makes."""
    seen, inner = [], tune_mod.run_sweep

    def record(spec, gains, **kw):
        seen.append(gains)
        return inner(spec, gains, **kw)

    tune_mod.run_sweep = record
    try:
        return fn(), seen
    finally:
        tune_mod.run_sweep = inner


def phase16c():
    """halving_tune(spark-dag, makespan) on the card makes the CPU's
    decision: the survivors of every round, and the winner."""
    log(f"phase 16c: halving_tune(spark-dag, objective=makespan, budget="
        f"{GRAPH_TUNE_BUDGET}) on the card against the CPU")
    t0 = time.perf_counter()
    card, card_rounds = recorded_rounds(lambda: halving_tune(
        "spark-dag", objective="makespan", budget=GRAPH_TUNE_BUDGET))
    wall = time.perf_counter() - t0
    cpu, cpu_rounds = recorded_rounds(lambda: halving_tune(
        "spark-dag", objective="makespan", budget=GRAPH_TUNE_BUDGET,
        device="cpu"))
    check(len(card_rounds) == len(cpu_rounds), "round counts differ")
    for i, (a, b) in enumerate(zip(card_rounds, cpu_rounds)):
        check(all(np.array_equal(getattr(a, f.name), getattr(b, f.name))
                  for f in dataclasses.fields(GainSet)),
              f"round {i}: the survivors differ, card vs CPU")
    check(card.params == cpu.params, f"winners differ: {card.params} vs "
          f"{cpu.params}")
    rounds = " -> ".join(f"{r['n_candidates']}@T={r['horizon']}"
                         for r in card.rounds)
    log(f"  {rounds}; same survivors every round and the same winner: "
        f"r0={card.params.r0:.4f} lam={card.params.lam:.4f} lam_grant="
        f"{card.params.lam_grant} makespan {-card.score:.4f} s (Table I "
        f"{-card.baseline_score:.4f} s); {wall:.3f} s wall on the card")
    return dict(rounds=card.rounds, wall_s=wall, makespan_s=-card.score,
                baseline_makespan_s=-card.baseline_score)


def phase16d():
    """runtime-churn through run_sweep, card against CPU."""
    log("phase 16d: run_sweep(runtime-churn, 64 gains), card against CPU")
    spec = get_scenario("runtime-churn")
    card = run_sweep("runtime-churn", grid_gains())
    cpu = run_sweep("runtime-churn", grid_gains(), device="cpu")
    assert_same(f"runtime-churn {spec.n_nodes}x{spec.n_intervals}",
                card.stats, cpu.stats, spec.n_nodes * spec.n_intervals)
    check(card.best() == cpu.best(), "runtime-churn: winners differ")


def phase16e():
    """The graph instance's times beside the graph-free instance on the
    same demand (the carry's cost, and the barrier's across blocks), its
    plain version and its operation bound."""
    log("phase 16e: times of the graph instance (CUDA events after a ~1 "
        "ms device-side lead, median of 7), 64 lanes")
    out = {}
    for tag, spec, gains in graph_fleets():
        args, kw, _ = graph_inputs(spec, gains)
        free_args, free_kw, _ = graph_inputs(spec, gains, graph=False)
        ms = cuda_ms(lambda: graph_kernel(args, kw), reps=7, lead=True)
        free = cuda_ms(lambda: graph_kernel(free_args, free_kw), reps=7,
                       lead=True)
        state0, hist0, dtn, lp, rows, alive = args
        cache = "cache-on" if spec.cache else "cache-off"
        n_upd = spec.n_nodes * spec.n_intervals * lp.shape[1]
        n_bytes = (sum(x.numel() * x.element_size()
                       for x in (dtn, lp, rows, alive, hist0))
                   + 2 * state0.numel() * 4
                   + sum(x.numel() * 4 for x in kw["graph"]))
        t_bytes = n_bytes / PEAK_BYTES_S * 1e3
        t_ops = n_upd * (OPS_PER_UPDATE[cache] + GRAPH_OPS_PER_UPDATE[cache]
                         ) / PEAK_F32_S * 1e3
        r = dict(ms=ms, graph_free_ms=free, carry_ms=ms - free,
                 bound_ms=max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations",
                 launches=len(range(0, lp.shape[1], ks.graph_lane_limit(
                     kw["con"], spec.n_nodes, CUDA) or lp.shape[1])),
                 us_per_interval=ms * 1e3 / spec.n_intervals)
        if tag.startswith("spark-dag"):
            # one run: a Python loop of small launches, host-bound
            r["plain_ms"] = cuda_ms(lambda: ks.sweep_segment_plain(*args,
                                                                   **kw),
                                    reps=1, warm=0)
        out[tag] = r
        log(f"  {tag} ({cache}): {ms:.4f} ms in {r['launches']} launch(es)"
            f" ({r['us_per_interval']:.3f} us an interval); graph-free "
            f"instance on the same demand {free:.4f} ms (the carry "
            f"{ms - free:+.4f} ms); bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}"
            + (f"; plain {r['plain_ms']:.1f} ms" if "plain_ms" in r else ""))
    return out


def phase16():
    """Phase 16: returns the sweep kernel's launches on the AppGraph
    paths (16b-16d) and the numbers."""
    max_abs, parity = phase16a()
    ks.LAUNCHES = 0                        # the AppGraph paths start here
    gates = phase16b()
    tuned = phase16c()
    phase16d()
    launches = ks.LAUNCHES
    log(f"main path: sweep kernel launched {launches} times (phase 16b-d)")
    check(launches > 0, "the AppGraph paths never launched the kernel")
    times = phase16e()
    return launches, max_abs, {"parity": parity, "gates": gates,
                               "halving": tuned, "times": times}


def main() -> None:
    if sys.argv[1:2] == ["--decode-times"]:
        print(json.dumps(fresh_decode_times(json.loads(sys.argv[2]))))
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log("phase 0: " + smi)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    sources = list(_build.LIBRARIES)             # one nvcc each, at once
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(_build.load_library, sources)))
    log(f"  kernel builds {time.perf_counter() - t0:.2f}s in parallel")
    for name, lib in libs.items():
        log(f"  {name}: nvcc {lib.build_s:.2f}s -> "
            f"{os.path.relpath(lib.path)}")
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line \
                    or "entry function" in line:
                log("    ptxas: " + line.strip())
    log("  sweep.cu instances (cudaFuncGetAttributes, occupancy at 128 "
        "threads a block):")
    resources = sweep_resources(libs["sweep.cu"].lib)

    demand = fleet_demand_traces(N_NODES, N_STEPS, 0.1, seed=0)
    max_abs, bins_on = phase1(demand)

    ks.LAUNCHES = 0                        # the main path starts here
    phase2(demand)
    phase3()
    phase4()
    launches = ks.LAUNCHES
    log(f"main path: sweep kernel launched {launches} times")
    check(launches > 0, "the main path never launched the sweep kernel")

    t = phase5(demand, libs["sweep.cu"])
    off, on = t["cache-off"], t["cache-on"]
    timed = ("ms", "all_nodes_equal_ms", "plain_ms", "bound_ms",
             "bound_by", "finalize_ms", "finalize_device_ms",
             "kernel_plus_finalize_ms", "fused_sweep_demand",
             "fused_sweep_demand_chunk32")
    kernel = {
        "name": "sweep_segment", "route": "cuda",
        "source": "src/repro_torch/csrc/sweep.cu",
        "replaces": "src/repro/lab/pallas_sweep.py:305",
        "launches": launches, "max_abs_err": max_abs,
        **{k: off[k] for k in timed}, "library_ms": None,
        "cache_on": {**{k: on[k] for k in timed},
                     **{k: on[k] for k in (
                         "bound_f64_static_ms", "f64_ops_per_update_static",
                         "sass_step_copies", "power_skipped_ms")},
                     "hist_bins_differing": bins_on},
        "instances": resources,
        "shape": "4096 nodes x 1000 intervals x 64 gains, f32, paper law",
    }

    errs = phase6()
    eng, n_decode, served = serve_full_width(7, FULL_WIDTH, smi)
    n_flash = forward_against_decode(8, eng.model, 2, 256)["flash"]
    launches = {"decode": n_decode, "flash": n_flash}
    log(f"main path: decode attention launched {n_decode} times (phase 7), "
        f"flash attention {n_flash} times (phase 8's forward)")
    check(min(launches.values()) > 0,
          "the serving path skipped an attention kernel")
    state, scfg = eng.state, eng.cfg
    del eng                                # free the weights for phase 9
    t = phase9(state, scfg)
    del state
    dec, dec32, fl = t["decode_engine"], t["decode_32k"], t["flash"]
    decode = {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:28",
        "launches": launches["decode"],
        "max_abs_err": max(*errs["decode"].values(), dec["max_abs_err"],
                           dec32["max_abs_err"]),
        "max_abs_err_f32": max(errs["decode"]["f32"], dec["max_abs_err"]),
        **{k: dec[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "shape", "splits", "gb_s",
                               "ways")},
        "ways_fresh_process": t["fresh"]["llama"],
        "decode_32k": dec32,
    }
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "shape", "max_abs_err", "tflop_s")
    flash = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:28",
        "launches": launches["flash"],
        "max_abs_err": max(*errs["flash"].values(), fl["max_abs_err"]),
        "max_abs_err_f32": max(errs["flash"]["f32"],
                               t["flash_f32"]["max_abs_err"],
                               *(r["max_abs_err"] for r in t["flash_main"])),
        **{k: fl[k] for k in timed if k != "max_abs_err"},
        "f32": {k: t["flash_f32"][k] for k in timed},
        "main_path_shapes": [
            {k: r[k] for k in timed + ("model", "launches_per_forward")}
            for r in t["flash_main"]],
    }
    serving = {k: served[k] for k in ("tok_s", "steps_s", "seconds",
                                      "steps", "preemptions")}
    log(f"serving {ARCH}: " + json.dumps(serving))

    scan_err, hymba_errs = phase10()
    eng, n_decode_h, served_h = serve_full_width(11, FULL_WIDTH_HYMBA, smi)
    n_fwd, rel_jax_init = phase12(eng.model)
    log(f"main path: decode attention launched {n_decode_h} times (phase "
        f"11), flash attention {n_fwd['flash']} and the scan "
        f"{n_fwd['scan']} times (phase 12's forward)")
    check(min(n_decode_h, *n_fwd.values()) > 0,
          "the hybrid serving path skipped a kernel")
    state, scfg = eng.state, eng.cfg
    del eng                                # free the weights
    torch.cuda.empty_cache()
    dec_h, sc = phase13(state, scfg)
    del state
    dec_h["ways_fresh_process"] = t["fresh"]["hymba"]
    log(f"  phase 13's lengths {dec_h['lens']} "
        f"{'equal' if dec_h['lens'] == t['lens'] else 'differ from'} the "
        f"fresh process's (phase 9's) {t['lens']}")
    decode["hymba_engine"] = dec_h
    for name, d in (("decode", decode), ("flash", flash)):
        d["max_abs_err"] = max(d["max_abs_err"], *hymba_errs[name].values())
        d["max_abs_err_f32"] = max(d["max_abs_err_f32"],
                                   hymba_errs[name]["f32"])
    decode["max_abs_err_f32"] = max(decode["max_abs_err_f32"],
                                    dec_h["max_abs_err"])
    decode["launches"] = n_decode + n_decode_h
    decode["launches_by_path"] = {f"{ARCH} serving (phase 7)": n_decode,
                                  f"{HYMBA.name} serving (phase 11)":
                                  n_decode_h}
    flash["launches"] = n_flash + n_fwd["flash"]
    flash["launches_by_path"] = {f"{ARCH} forward (phase 8)": n_flash,
                                 f"{HYMBA.name} forward (phase 12)":
                                 n_fwd["flash"]}
    scan = {
        "name": "ssm_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan/kernel.py:25",
        "launches": n_fwd["scan"],
        "launches_by_path": {f"{HYMBA.name} forward (phase 12)":
                             n_fwd["scan"]},
        "max_abs_err": max(scan_err, sc["max_abs_err"]),
        **{k: sc[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "share_of_bound", "shape")},
    }
    serving_h = {k: served_h[k] for k in ("tok_s", "steps_s", "seconds",
                                          "steps", "preemptions")}
    serving_h["forward_vs_decode_jax_init"] = rel_jax_init
    log(f"serving {HYMBA.name}: " + json.dumps(serving_h))

    n_decode_p, pressure = phase14(smi)
    log(f"main path: decode attention launched {n_decode_p} times (phase "
        f"14)")
    check(n_decode_p > 0, "the pressure path skipped decode attention")
    decode["launches"] += n_decode_p
    decode["launches_by_path"][f"{ARCH} under device-memory pressure "
                               f"(phase 14)"] = n_decode_p
    log(f"plane under pressure, {ARCH}: " + json.dumps(pressure))

    seconds = [time.perf_counter()]
    n_retune, n_decode_r, retune = phase15a(smi)
    log(f"main path: sweep kernel launched {n_retune} times (phase 15a's "
        f"round), decode attention {n_decode_r} times (phase 15a)")
    seconds.append(time.perf_counter())
    n_testbed, testbed = phase15b()
    seconds.append(time.perf_counter())
    n_fleet, fleet = phase15c()
    seconds.append(time.perf_counter())
    log(f"main path: sweep kernel launched {n_testbed} times (phase 15b's "
        f"replays and 4096-node tunings), {n_fleet} (phase 15c)")
    log("phase 15 seconds (host clock): " + ", ".join(
        f"15{p} {b - a:.1f}" for p, a, b in zip("abc", seconds, seconds[1:])))
    t16 = time.perf_counter()
    n_graph, graph_err, graph = phase16()
    log(f"phase 16 seconds (host clock): {time.perf_counter() - t16:.1f}")
    kernel["launches_by_path"] = {
        "run_sweep, sweep_demand, tune_gains (phases 2-4)":
        kernel["launches"], "serving retune round (phase 15a)": n_retune,
        "paper testbed replays and 4096-node tunings (phase 15b)":
        n_testbed,
        "simulate_fleet (phase 15c)": n_fleet,
        "AppGraph sweeps, gates and tunings (phase 16)": n_graph}
    kernel["max_abs_err"] = max(kernel["max_abs_err"], graph_err)
    big = graph["times"][f"spark-dag {N_NODES}x1800"]
    kernel["app_graph"] = {
        "name": "sweep_segment (graph instance)", "route": "cuda",
        "source": "src/repro_torch/csrc/sweep.cu",
        "replaces": "src/repro/lab/sweep.py:387 (XLA beside "
                    "src/repro/lab/pallas_sweep.py:305)",
        "launches": n_graph, "max_abs_err": graph_err,
        **{k: big[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "shape": f"spark-dag {N_NODES} x 1800 x 64, cache-on",
        **graph}
    kernel["launches"] = sum(kernel["launches_by_path"].values())
    kernel["retune"] = {"serving": retune, "testbed": testbed,
                        "fleet": fleet}
    decode["launches"] += n_decode_r
    decode["launches_by_path"][f"{ARCH} serving with the retune (phase "
                               f"15a)"] = n_decode_r
    log("retune on the card: " + json.dumps(kernel["retune"], default=str))
    ends = [t for _, t in PHASE_STARTS[1:]] + [time.perf_counter()]
    log("seconds by phase (host clock): " + ", ".join(
        f"{name} {end - start:.1f}"
        for (name, start), end in zip(PHASE_STARTS, ends)))
    print(smi)
    print(json.dumps({"kernels": [kernel, decode, flash, scan]},
                     default=float))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
