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
  DAG's queue/barrier carry) against its plain version, one warp a lane
  (limplock, spark-dag at their sizes) and one thread-block cluster a
  lane (both at 4096 nodes x 64 lanes, one launch each), with the route
  the planner took; ``BENCH_appgraph.json``'s
  gates (spark-dag's >= 2x makespan gap, limplock's ~4x) with the card's
  makespans equal to the CPU's; ``halving_tune(spark-dag, makespan)``
  making the CPU's decision; ``runtime-churn`` card against CPU; and
  the graph instance's times beside the graph-free instance on the same
  demand and the design it replaced, with its bound and its serial
  chain's;
* FleetPlane and the ChaosPlane harness (phase 17): ``arbitrate`` on the
  card bit for bit the CPU's under every policy, with its invariants;
  ``fleet_sweep_demand`` (plain PyTorch: the JAX package runs the fleet
  carry as XLA) on the registry's fleets under every policy, at
  ``benchmarks/fleet_bench.py``'s largest row and at the sweep bench's
  width, card against CPU, with its time, launches an interval and idle
  share; the live FleetPlane (HPCC + Spark) on the card, its budgets
  equal to a CPU FleetPlane's every epoch; the chaos drill
  (``repro_torch.launch.chaos_drill``) at full size with planes on the
  card, its gates held and its supervised retune, killed and restarted,
  launching the sweep kernel;
* the training tenant (phase 18): llama3.2-1b trained at full width
  for 6 steps through the training CLI's wiring (plain PyTorch under
  autograd: no TPU kernel lies on this path), its shard cache under a
  live plane, an async checkpoint at the end: the loss finite and
  falling, ms a step, tokens/s, peak memory, the device's idle share,
  the plane's ticks, the checkpoint's bytes and seconds; the smoke model
  on the card against the CPU, and a restart on the card; the kernels
  refusing inputs that require grad, and the trained model's forward
  through flash attention against its training forward;
* the dense features and hybrid training (phase 19): flash and decode
  attention at gemma3-1b's head dim of 256 and qwen2-1.5b's group of 6
  against their plain versions (0 spills in the new instances) and
  timed beside their bounds and SDPA; gemma3-1b and qwen2-1.5b served
  at full width through the burst under the plane, their forwards
  against decode and against the training forward; hymba-1.5b,
  gemma3-1b and qwen2-1.5b trained at full width and half depth for 4
  steps (no kernel launched; hymba's ms a step, tokens/s, peak memory
  and idle share);
  the three smoke models trained on the card and the CPU alike;
* the moe family (phase 20): flash and decode attention at
  qwen2-moe-a2.7b's 16/16 heads of 128 (decode's group of 1) against
  their plain versions and timed beside their bounds and SDPA;
  qwen2-moe-a2.7b served at full width and depth (60.6 GB of float32
  weights, 64 padded experts) through the burst under the plane, with
  the busy slots' choices the experts' capacity dropped; one moe layer
  on the card against the CPU with and without drops; its forward
  against the training forward, and at cf 8.0 against decode; the model
  trained at full width cut to 2 layers (the router's aux logged), and
  the qwen2-moe and dbrx smoke models trained on the card and the CPU
  alike;
* the cross-attention families (phase 21): flash attention non-causal
  at whisper-large-v3's 20/20 heads of 64 and llama-3.2-vision-11b's
  32/8 heads of 128 (Sq > Skv), decode attention at group 4 and over
  cross caches (read whole, at enc_len 1500 and at 0), against their
  plain versions, spills, and times beside their bounds and SDPA; both
  models served at full width and depth through the burst under the
  plane (zero cross caches, as JAX's engine serves them), then 8
  prompts prefilled with images or frames attached (the vision model's
  gates drawn non-zero) and decoded; their forwards against the
  training forward and against decode with the context attached;
  whisper trained at half depth and the vision model cut to one group,
  at full width; the vision, whisper and mistral smoke models trained
  on the card and the CPU alike;
* the ssm family (phase 22): xlstm-125m (mLSTM and sLSTM blocks, plain
  PyTorch: JAX has no Pallas kernel behind either) served at full width
  and depth through the burst under the plane, its forward against the
  training forward and against decode across mLSTM chunks, one mLSTM
  block chunked against stepped, trained at full width and depth, and
  its smoke model trained on the card and the CPU alike; no kernel
  launches anywhere in the phase;
* the tooling (phase 23): a llama3.2-1b decode step and training step
  counted on meta tensors (``repro_torch.roofline.analyze_step``) beside
  the ms a step phases 7 and 18a measured, and a small
  ``fused_sweep_demand`` with ``PLANECHECK_SANITIZERS=1``: its chunk loop
  under ``dispatch_guard`` passes, and raises on an injected ``.item()``;
* the multi-device sweeps (phase 24), on one card laid out as four
  shards with a stream each (``("cuda:0",) * 4``; distinct cards too
  where the machine has them): ``sweep_demand`` at 4096 x 1000 x 64,
  cache off and on, over 4 gain shards (bit for bit one device's) and
  2 x 2 and 1 x 4 node shards (within the test brackets); the AppGraph
  at 16e's spark-dag 4096 x 1800 x 64 over 4 node shards, the sweep
  kernel's one-interval graph entry launched per interval with the
  barrier's min exchanged between launches (the makespans bit for bit,
  no host sync under the sanitizers); that entry against its plain
  version, and one launch timed beside its bound; the fleet sweep over
  node shards.

Every bound comes from ``repro_torch.roofline`` (the H100's data-sheet
peaks and each kernel's work from its shapes).  Phases 19c, 20d, 21d
and 22c train without the end-of-run checkpoint that 18a writes and
times.  To keep the script well inside its time limit on a slow host,
phase 2 holds ``sweep_demand`` against the CPU at 16 of the 64 gains
(phase 1 holds the kernel at all 64), 17b runs the registry's fleets
over their first 700 intervals and fleet_bench's rows over 250, 16e
times the graph instance's plain version at 4096 nodes only, and 21b
prefills prompts of 64 tokens.

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
import contextlib
import dataclasses
import gc
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

T_START = time.perf_counter()

import numpy as np  # noqa: E402
import torch  # noqa: E402

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
from repro_torch.core.control import ControllerParams  # noqa: E402
from repro_torch.core.plane import (MemoryPlane, NodeSpec,  # noqa: E402
                                    PlaneSpec)
from repro_torch.core.store import StoreRegistry  # noqa: E402
from repro_torch.fleet import (FleetExtras, FleetPlane,  # noqa: E402
                               FleetSpec, POLICIES, TenantSpec, arbitrate,
                               fleet_sweep_demand, get_fleet_scenario)
from repro_torch.fleet.arbiter import ksum  # noqa: E402
from repro_torch.fleet.sweep import _floors_and_budgets  # noqa: E402
from repro_torch.core.traces import (GiB,  # noqa: E402
                                     fleet_demand_traces, hpcc_trace)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as kd  # noqa: E402
from repro_torch.kernels import flash_attention as kf  # noqa: E402
from repro_torch.kernels import ssm_scan as kscan  # noqa: E402
from repro_torch.kernels import sweep as ks  # noqa: E402
from repro_torch.lab import fused_sweep as fs  # noqa: E402
from repro_torch.lab import mesh  # noqa: E402
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
from repro_torch.launch import chaos_drill  # noqa: E402
from repro_torch.launch.profile_serve import (count_syncs,  # noqa: E402
                                              device_us, on_device,
                                              tick_launches, watch_ticks)
from repro_torch.launch.serve import (FULL_WIDTH,  # noqa: E402
                                      FULL_WIDTH_GEMMA3, FULL_WIDTH_HYMBA,
                                      FULL_WIDTH_QWEN2, FULL_WIDTH_QWEN2_MOE,
                                      FULL_WIDTH_VLM, FULL_WIDTH_WHISPER,
                                      FULL_WIDTH_XLSTM, build_engine, serve)
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.time_sweep import (_profiled,  # noqa: E402
                                           device_ms, time_fused_sweep)
from repro_torch.models import Model, decode as D  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models.transformer import layer_windows  # noqa: E402
from repro_torch.roofline import analyze_step, bound  # noqa: E402
from repro_torch.roofline import kernels as rk  # noqa: E402
from repro_torch.train import step as train_step  # noqa: E402
from repro_torch.roofline.constants import (HBM_BW,  # noqa: E402
                                            PEAK_F32, PEAK_F64)
from repro_torch.serving import ServingConfig, ServingEngine  # noqa: E402

CUDA = torch.device("cuda")
N_NODES, N_STEPS = 4096, 1000            # the lab benchmark's fleet
CACHE = get_scenario("spark-iterative-cache").cache


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


def kernel_counts():
    """Each kernel wrapper's launches since the counts were last zeroed."""
    return {"sweep": ks.LAUNCHES, "decode": kd.LAUNCHES,
            "flash": kf.LAUNCHES, "scan": kscan.LAUNCHES}


def zero_kernel_counts():
    ks.LAUNCHES = kd.LAUNCHES = kf.LAUNCHES = kscan.LAUNCHES = 0


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


# Phase 2's sweep_demand against the CPU: 16 gains spread over the
# default 8 x 8 grid, its corners included (the CPU runs at all 64 take
# ~60 s; phase 1 holds the kernel at all 64 lanes bit for bit)
PHASE2_GAINS = grid_gains(lam=(0.1, 0.5, 1.0, 1.8),
                          r0=(0.88, 0.92, 0.95, 0.98))


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
        a = sweep_demand(demand, PHASE2_GAINS, node_memory=m, cache=cache)
        t_card = time.perf_counter() - t0
        b = sweep_demand(demand, PHASE2_GAINS, node_memory=m, cache=cache,
                         device="cpu")
        assert_same(f"sweep_demand 4096x1000x{len(PHASE2_GAINS.r0)} {tag} "
                    f"(card {t_card:.2f}s)", a, b, N_NODES * N_STEPS)


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
    """Registers, shared memory and residency of every template instance
    of the sweep kernel, from the runtime: the graph-free instances at
    128 threads a block; the graph instances at the shapes the planner
    picks for phase 16's fleets (one warp of one loop a thread for the
    registry's lanes; the wide loops in the cluster of a 4096-node lane),
    with the clusters the card holds at once, there and at 16 blocks."""
    rows = {}
    stage_rows = fs._graph_host(get_scenario("spark-dag").app_graph,
                                16)[1].shape[1]
    for (law, occ, cache), bf16 in itertools.product(
            ((1, 1, 0), (1, 0, 0), (0, 1, 0), (0, 0, 0), (1, 1, 1),
             (0, 1, 1)), (0, 1)):
        tag = (f"{'paper' if law else 'generic'} "
               f"{'unit-occ' if occ else 'occ'} "
               f"{'cache-on' if cache else 'cache-off'} "
               f"{'bf16' if bf16 else 'f32'}")
        out = ks.instance_resources(law, occ, cache, bf16, lib=lib)
        rows[tag] = dict(registers=out.registers, smem_bytes=out.smem_bytes,
                         blocks_per_sm=out.blocks_per_sm,
                         warps_per_sm=out.blocks_per_sm * 4)
        log(f"    {tag}: {out.registers} registers, {out.smem_bytes} B "
            f"shared, {out.blocks_per_sm} blocks "
            f"({out.blocks_per_sm * 4} warps) per SM")
        wide = ks.WIDE_LOOPS[bool(cache)]
        shapes = [(1, 32, 1)] + [(wide, *reversed(ks._spread(N_NODES, wide,
                                                              cap)))
                                 for cap in ks.GRAPH_BLOCKS]
        most = ks.instance_resources(law, occ, cache, bf16, wide,
                                     ks.GRAPH_THREADS, ks.MAX_CLUSTER,
                                     stage_rows, lib=lib).clusters
        for loops, threads, cluster in shapes:
            r = ks.instance_resources(law, occ, cache, bf16, loops, threads,
                                      cluster, stage_rows, lib=lib)
            rows[f"{tag} graph J={loops} {threads}x{cluster}"] = dict(
                registers=r.registers, spill_bytes=r.spill_bytes,
                smem_bytes=r.smem_bytes, threads=threads,
                blocks_per_sm=r.blocks_per_sm, cluster=cluster,
                clusters=r.clusters,
                clusters_of_16=most if cluster > 1 else None)
            log(f"    {tag} graph J={loops}: {r.registers} registers, "
                f"{r.spill_bytes} B spilled, {r.smem_bytes} B shared + "
                f"{8 * stage_rows} B of stage rows; {r.blocks_per_sm} "
                f"blocks of {threads} threads per SM"
                + (f", {r.clusters} clusters of {cluster} (a {N_NODES}-"
                   f"node lane) resident at once; {most} of 16 blocks of "
                   f"{ks.GRAPH_THREADS}" if cluster > 1 else ""))
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
    want = "sweep_kernelILb1ELb1ELb1ELb0EE"
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
        work = rk.sweep(N_NODES, N_STEPS, 64, cache=cache is not None)
        n_bytes = work.bytes
        t_bytes = n_bytes / HBM_BW * 1e3
        t_ops = work.ops / work.peak * 1e3
        e2e, e2e32 = time_fused_sweep(demand, cache, (None, 32))
        r = dict(ms=ms, all_nodes_equal_ms=equal_ms, plain_ms=plain,
                 finalize_ms=fin, finalize_device_ms=fin_device,
                 bound_ms=work.bound_ms, bound_by=work.bound_by,
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
            f"{rk.OPS_PER_UPDATE[tag]} per update)")
        if cache is not None:
            f64, copies, n = sass_f64_ops(sweep_lib.path)
            # the power's exponent at 1 skips the float64 exp2/log2
            linear = dict(kw, con=dataclasses.replace(kw["con"], hit_exp=1.0))
            no_pow = cuda_ms(lambda: ks.sweep_segment(*args, **linear),
                             reps=7)
            r.update(f64_ops_per_update_static=f64, sass_f64=n,
                     sass_step_copies=copies,
                     bound_f64_static_ms=rk.sweep_f64_bound_ms(work, n_upd,
                                                               f64),
                     power_skipped_ms=no_pow)
            log(f"    float64 power, static SASS count (an upper estimate: "
                f"it holds exp2/log2's rarely taken special paths): {n} in "
                f"{copies} copies of the step -> {f64:.1f} float64 "
                f"operations per update; bound with them at "
                f"{PEAK_F64 / 1e12:.0f} TFLOP/s: "
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
    per_step = decode_launches_per_step(eng.model)
    check(launches == st["decode_steps"] * per_step,
          f"decode kernel launched {launches} times for "
          f"{st['decode_steps']} steps x {per_step} attention layers")
    health = check_plane(eng)
    after = report["after_shrink"]
    check(after[0] == report["full"], f"the plane did not re-grant the pool "
          f"on the tick after the shrink: {after} of {report['full']}")
    log(f"  drained {len(fin)}/{w['requests']}, {report['tokens']} tokens, "
        f"{st['preemptions']} preemption(s), {st['steps']} steps "
        f"({st['decode_steps']} with an active slot); decode kernel "
        f"launches {launches} = steps x {per_step}; logits finite")
    log(f"  plane: {health.ticks} ticks = steps, {health.summary()}; pool "
        f"{after[0] / 2**20:.0f} of {report['full'] / 2**20:.0f} MiB on the "
        f"tick after the shrink")
    log(f"  {report['tokens'] / dt:.1f} tok/s, {st['steps'] / dt:.2f} "
        f"steps/s ({dt:.3f} s, host clock) on {smi}")
    return eng, launches, {"tok_s": report["tokens"] / dt,
                           "steps_s": st["steps"] / dt, "seconds": dt,
                           "steps": st["steps"],
                           "preemptions": st["preemptions"],
                           "after_shrink": after, "full": report["full"]}


def decode_launches_per_step(model):
    """Decode attention's launches in one decode step: one per self
    layer, and one per cross-attention (a vlm cross layer, an audio
    decoder layer's cross); none in the ssm family."""
    n = len(model.layers)
    if model.cfg.family == "ssm":          # attention-free
        return 0
    if model.cfg.family == "vlm":
        return n + len(model.cross_layers)
    return 2 * n if model.cfg.family == "audio" else n


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


def forward_against_decode(phase, model, batch, seq, mixed=True):
    """Forward (flash, and scan in a hybrid) against decode (decode
    attention) on ``batch`` x ``seq`` tokens with an f32 cache, then,
    with ``mixed``, mixed progress against isolated serving.  Returns
    the forward's launches of the flash and scan kernels."""
    cfg = model.cfg
    hybrid = cfg.family == "hybrid"
    log(f"phase {phase}: forward ({'flash + scan' if hybrid else 'flash'}) "
        f"against decode (decode attention) at full width, {cfg.n_layers} "
        f"layers, {batch} x {seq} tokens, f32 cache"
        + ("; mixed progress" if mixed else ""))
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
    if not mixed:
        return launches

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
    work = rk.decode(lens.tolist(), s, h, kv, hd, window=window,
                     q_itemsize=q.element_size(),
                     kv_itemsize=kc.element_size())
    n_bytes, bound_ms, by = work.bytes, work.bound_ms, work.bound_by
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


def time_flash(b, s, h, kv, hd, dtype, window, gen, flush, *, skv=None,
               causal=True):
    """B2 at one (B, S) self-attention shape, causal, or with ``skv`` and
    ``causal=False`` at one non-causal (B, S, Skv) shape (an encoder's,
    or queries over a cross-attention's context): kernel, plain, SDPA.

    The bound counts 4 * hd operations per kept (query, key) pair at the
    rate of the kernel's route (bf16 tensor cores; f32 as 3xTF32, three
    TF32 products for each, so a third of the TF32 rate), and q, k, v
    read and the output written once.  f32 rows also print the bound of
    the CUDA cores' f32 rate.
    """
    skv = s if skv is None else skv
    q = randn((b, s, h, hd), dtype, gen)
    k, v = randn((b, skv, kv, hd), dtype, gen), \
        randn((b, skv, kv, hd), dtype, gen)
    work = rk.flash(b, s, h, kv, hd, skv=skv, causal=causal, window=window,
                    bf16=dtype == BF16)
    n_ops, n_bytes = work.ops, work.bytes
    bound_ms, by = work.bound_ms, work.bound_by
    run = lambda: kf.flash_attention(  # noqa: E731
        q, k, v, causal=causal, window=window)
    plain_run = lambda: kf.flash_attention_plain(  # noqa: E731
        q, k, v, causal=causal, window=window)
    ms = cuda_ms(run, reps=7, flush=flush)
    plain = cuda_ms(plain_run, reps=3, warm=1, flush=flush)
    tol = 2e-2 if dtype == BF16 else 2e-5
    tag = (f"B{b} x S{s}" + (f" x Skv{skv}" if skv != s else "")
           + f" x H{h}/KV{kv} x hd{hd} {str(dtype)[6:]} "
           + ("causal" if causal else "non-causal")
           + (f" window {window}" if window else ""))
    got = run()
    err = max_err(got, plain_run(), tol, f"flash {tag}")
    mask = kf.make_mask(torch.arange(s, device=CUDA),
                        torch.arange(skv, device=CUDA), causal=causal,
                        window=window)
    lib_kw = (dict(attn_mask=mask) if window else
              dict(is_causal=True) if causal else {})
    lib_out = sdpa(q, k, v, **lib_kw)
    diff = float((lib_out.float() - got.float()).abs().max())
    lib = cuda_ms(lambda: sdpa(q, k, v, **lib_kw), reps=7, flush=flush)
    extra = ""
    if dtype == F32:
        cores_ms, _ = bound(n_bytes, n_ops, PEAK_F32)
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


# Phase 12 runs the served model's first layers only, so phase 21 fits
# the script's time limit: the ungated pass (C8's JAX-init drift) 4
# layers, the gated pass 16 (windowed layers 0-14 and the global layer
# 15).  At full depth they took ~85 s and ~75 s on an NVIDIA H100 80GB
# HBM3 at 700 W, the ungated pass giving 4.064e-3.
JAX_INIT_12_LAYERS = 4
FORWARD_12_LAYERS = 16


@contextlib.contextmanager
def first_layers(model, n):
    """``model`` cut to its first ``n`` layers (the same tensors) inside
    the block; a decode state built there holds ``n`` layers."""
    full = model.cfg, model.layers, model.windows
    model.cfg = dataclasses.replace(model.cfg, n_layers=n)
    model.layers = torch.nn.ModuleList(list(full[1])[:n])
    model.windows = full[2][:n]
    try:
        yield model
    finally:
        model.cfg, model.layers, model.windows = full


def phase12(model):
    """Forward against decode at 1 x 1088 tokens, past the window, so the
    local layers really window, over the served model's first
    ``FORWARD_12_LAYERS`` layers.  Returns the gated run's launches and
    the served (JAX-init) model's forward-vs-decode difference over its
    first ``JAX_INIT_12_LAYERS`` layers."""
    gen = torch.Generator(device=CUDA).manual_seed(120)
    tokens = torch.randint(0, model.cfg.vocab_size, (1, 1088), generator=gen,
                           device=CUDA)
    with first_layers(model, JAX_INIT_12_LAYERS):
        rel_jax_init, _ = forward_decode_rel(model, tokens)
    log(f"phase 12 (not gated): the served model's first "
        f"{JAX_INIT_12_LAYERS} of {model.cfg.n_layers} layers, JAX init of "
        f"a_log/dt_bias: forward vs decode max relative diff "
        f"{rel_jax_init:.3e} at 1 x 1088 tokens")
    mamba_paper_init(model, 12)
    with first_layers(model, FORWARD_12_LAYERS):
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
    work = rk.ssm_scan(b, s, c, n)
    n_bytes, bound_ms, by = work.bytes, work.bound_ms, work.bound_by
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


def graph_route(kw, n_nodes):
    """The planner's route for a graph launch of ``kw``'s operands."""
    return ks.graph_plan(kw["con"], n_nodes, CUDA,
                         kw["graph"][1].shape[1])


def route_text(route, n_launches):
    """J, threads, cluster and launches of a route, for a log line."""
    return (f"{route.name} route: J={route.loops}, {route.threads} threads "
            f"x {route.blocks} block(s) a lane, cluster {route.cluster}, "
            f"{n_launches} launch(es)")


def graph_kernel(args, kw):
    """The kernel over every lane of ``args``, in as many launches as
    co-residency asks (one unless the route is cooperative)."""
    state0, hist0, dtn, lp, rows, alive = args
    n_lanes = lp.shape[1]
    limit = n_lanes
    if kw["con"].has_graph:
        limit = graph_route(kw, dtn.shape[1]).lanes or n_lanes
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
        "(one warp a lane) and at 4096 nodes (one cluster a lane)")
    worst, out = 0.0, {}
    for tag, spec, gains in graph_fleets():
        args, kw, total = graph_inputs(spec, gains, n_dead=5)
        con, names = kw["con"], kw["names"]
        route = graph_route(kw, spec.n_nodes)
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
            f"{route_text(route, n_launch)}, lanes a launch "
            f"{route.lanes or 'unlimited'}): bit-identical={exact} max_abs="
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
                        launches=n_launch, lanes_per_launch=route.lanes,
                        route=route._asdict(), lanes_finished=finished)
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


# Phase 16e's times of the design the graph instance's routes replaced
# (one 128-thread block a lane up to 256 nodes, 128 with the cache, else
# cooperative launches whose blocks met at a per-lane barrier in device
# memory, the lanes split over two launches at 4096 nodes), measured by
# this phase in an earlier run on an NVIDIA H100 80GB HBM3 at 700.00 W:
# for the log line only, never reported as this run's
EARLIER_16E_MS = {"limplock 8x1200": 0.6536, "spark-dag 16x1800": 1.3677,
                  f"limplock {N_NODES}x1200": 7.1722,
                  f"spark-dag {N_NODES}x1800": 15.9520}


def phase16e():
    """The graph instance's times beside the graph-free instance on the
    same demand (the carry's cost), its plain version (at 4096 nodes
    only) and its operation bound; the log line adds the earlier
    design's recorded time and the serial chain's computed one."""
    log("phase 16e: times of the graph instance (CUDA events after a ~1 "
        "ms device-side lead, median of 7), 64 lanes")
    out = {}
    for tag, spec, gains in graph_fleets():
        args, kw, _ = graph_inputs(spec, gains)
        free_args, free_kw, _ = graph_inputs(spec, gains, graph=False)
        before = ks.LAUNCHES
        ms = cuda_ms(lambda: graph_kernel(args, kw), reps=7, lead=True)
        n_launch = (ks.LAUNCHES - before) // 9
        free = cuda_ms(lambda: graph_kernel(free_args, free_kw), reps=7,
                       lead=True)
        state0, hist0, dtn, lp, rows, alive = args
        cache = "cache-on" if spec.cache else "cache-off"
        route = graph_route(kw, spec.n_nodes)
        work = rk.sweep(spec.n_nodes, spec.n_intervals, lp.shape[1],
                        cache=bool(spec.cache),
                        paper_law=kw["con"].paper_law,
                        n_stages=kw["graph"][1].shape[1] - 1,
                        demand_itemsize=dtn.element_size())
        r = dict(ms=ms, graph_free_ms=free, carry_ms=ms - free,
                 bound_ms=work.bound_ms, bound_by=work.bound_by,
                 launches=n_launch, route=route._asdict(),
                 us_per_interval=ms * 1e3 / spec.n_intervals)
        if tag == f"spark-dag {N_NODES}x1800":
            # one run: a Python loop of small launches, host-bound
            r["plain_ms"] = cuda_ms(lambda: ks.sweep_segment_plain(*args,
                                                                   **kw),
                                    reps=1, warm=0)
        out[tag] = r
        log(f"  {tag} ({cache}): {ms:.4f} ms, {route_text(route, n_launch)}"
            f" ({r['us_per_interval']:.3f} us an interval); the earlier "
            f"design {EARLIER_16E_MS[tag]:.4f} ms (recorded, not this run);"
            f" graph-free instance on the same demand {free:.4f} ms (the "
            f"carry {ms - free:+.4f} ms); bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}, serial chain {work.critical_path_ms:.4f} ms "
            f"(computed)"
            + (f"; plain {r['plain_ms']:.1f} ms" if "plain_ms" in r else ""))
        check(n_launch == 1 or route.cooperative,
              f"{tag}: {n_launch} launches on the {route.name} route")
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


# ---- FleetPlane (two-level arbitration) and the ChaosPlane harness ----

FLEET_M = 125 * GiB                        # Table I's node memory
# 16 grid gains around Table I: 4 lam x 4 r0
FLEET_GAINS = grid_gains(lam=(0.3, 0.5, 0.8, 1.2),
                         r0=(0.90, 0.92, 0.95, 0.97))
# the 4096-node fleet: 1e-3 GiB of conservation slack is the float32
# rounding of K summed grants (the sweep's own bracket)
SLACK_GIB = -1e-3
# 17b runs each registry fleet over its first 700 intervals (hpcc-spark
# has 4200, ~10 s a policy on the card, host-bound) and fleet_bench's
# rows over 250 (the 4096-node row's CPU reference takes ~25 s at 1000)
FLEET_17B_INTERVALS = 700
FLEET_17B_BENCH_INTERVALS = 250


def phase17a():
    """arbitrate on the card against the port's CPU arbitrate, bit for
    bit, and its invariants at every node."""
    k, n = 8, 4096
    log(f"phase 17a: arbitrate on the card, (K, N) = ({k}, {n}), every "
        f"policy, rr_offset 0..{k - 1}, against the CPU bit for bit")
    rng = np.random.default_rng(17)
    desired = torch.from_numpy(
        (rng.uniform(0.0, 80.0, (k, n)) * GiB).astype(np.float32))
    # nodes from 40 GiB: some too small for the floors, which then scale
    m = torch.from_numpy(
        (rng.uniform(40.0, 160.0, n) * GiB).astype(np.float32))
    w = rng.uniform(0.5, 4.0, k)
    fl = rng.uniform(0.0, 12.0, k) * GiB
    order = tuple(int(i) for i in rng.permutation(k))
    f_eff, _ = _floors_and_budgets(torch.tensor(w, dtype=torch.float32),
                                   torch.tensor(fl, dtype=torch.float32), m)
    d_card, m_card = desired.to(CUDA), m.to(CUDA)
    differing, cons, floor_slack, times = 0, np.inf, np.inf, {}
    for policy in POLICIES:
        for off in range(k):
            kw = dict(weights=w, floors=fl, priority_order=order,
                      policy=policy, rr_offset=off)
            card = arbitrate(d_card, m_card, **kw).cpu()
            cpu = arbitrate(desired, m, **kw)
            differing += int((card != cpu).sum())
            cons = min(cons, float((m - ksum(card)).min()))
            floor_slack = min(floor_slack, float((card - f_eff).min()))
        times[policy] = cuda_ms(lambda: arbitrate(d_card, m_card, **kw))
    log(f"  card == CPU bit for bit: {differing == 0} ({differing} of "
        f"{3 * k * k * n} elements differ); floor slack min "
        f"{floor_slack:.1f} B (>= 0); conservation slack min {cons:.1f} B "
        f"({cons / GiB:.3e} GiB, >= {SLACK_GIB} GiB: float32 sums of {k} "
        f"grants); ms a call " + ", ".join(
            f"{p} {t:.4f}" for p, t in times.items()))
    check(differing == 0, "arbitrate: the card differs from the CPU")
    check(floor_slack >= 0.0, f"arbitrate: floor slack {floor_slack}")
    check(cons >= SLACK_GIB * GiB, f"arbitrate: conservation slack {cons}")
    return {"bit_identical": differing == 0, "floor_slack_b": floor_slack,
            "conservation_slack_b": cons, "ms": times}


def fleet_case(tag, demand, kw, gains=FLEET_GAINS, warm=False):
    """One fleet sweep on the card against the CPU: brackets, bits, the
    invariants, and its time; launches per interval and idle share over
    its first epoch under the profiler (the profiler's table of a whole
    call takes minutes to build)."""
    k, n, t = demand.shape
    if warm:
        fleet_sweep_demand(demand, gains, **kw)
    t0 = time.perf_counter()
    card, card_ex = fleet_sweep_demand(demand, gains, **kw)
    ms = (time.perf_counter() - t0) * 1e3      # numpy out: synchronized
    t0 = time.perf_counter()
    cpu, cpu_ex = fleet_sweep_demand(demand, gains, device="cpu", **kw)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    bad = stats_mismatches(card, cpu, n_samples=n * t)
    diff = [f for f, a, b in zip(FleetStats._fields + FleetExtras._fields,
                                 card + card_ex, cpu + cpu_ex)
            if not np.array_equal(a, b)]
    check(not bad, f"{tag}: card against CPU: {bad}")
    for f in FleetExtras._fields:
        np.testing.assert_allclose(getattr(card_ex, f), getattr(cpu_ex, f),
                                   rtol=2e-4, atol=1e-3, err_msg=f"{tag} {f}")
    cons = float(card_ex.conservation_slack_gib.min())
    floor = float(card_ex.floor_slack_gib.min())
    check(cons >= SLACK_GIB and floor >= SLACK_GIB,
          f"{tag}: slack conservation {cons}, floor {floor}")
    t_prof = kw["epoch_intervals"]
    wall, table = _profiled(lambda: fleet_sweep_demand(
        demand, gains, horizon=t_prof, **kw))
    busy = sum(device_us(e) for e in table) / 1e3
    n_launch = sum(e.count for e in table)
    r = dict(ms=ms, cpu_ms=cpu_ms, bit_identical=not diff,
             fields_differing=diff, conservation_slack_gib=cons,
             floor_slack_gib=floor,
             launches_per_interval=n_launch / t_prof,
             idle_share=(1.0 - busy / wall) if busy > 0 else None,
             device_busy_ms=busy, profiled_intervals=t_prof,
             shape=f"{k} x {n} x {t} x {len(gains)}")
    log(f"  {tag} ({r['shape']}, {kw.get('policy')}): {ms:.1f} ms end to "
        f"end (CPU {cpu_ms:.1f}); card == CPU bit for bit: {not diff}"
        + (f" (differ: {diff})" if diff else "") + f"; slack min "
        f"conservation {cons:.3e}, floor {floor:.3e} GiB; "
        f"{r['launches_per_interval']:.1f} launches an interval, device "
        f"busy {busy:.1f} ms of {wall:.1f} (idle "
        + (f"{r['idle_share']:.1%}" if busy > 0 else "not measured: the "
           "profiler saw no device time") + f", over the first {t_prof} "
        "intervals)")
    return r


def phase17b():
    """The fleet sweep on the card: the registry's fleets under every
    policy, fleet_bench's largest row, and the sweep bench's width."""
    log(f"phase 17b: fleet_sweep_demand on the card, {len(FLEET_GAINS)} "
        f"grid gains, against the CPU")
    out = {}
    for name in ("tenant-churn", "hpcc-spark"):
        fs_ = get_fleet_scenario(name)
        demand = np.ascontiguousarray(
            fs_.build_demand(seed=0)[..., :FLEET_17B_INTERVALS])
        for policy in POLICIES:
            kw = dict(node_memory=fs_.node_memory_gib * GiB,
                      weights=fs_.weights(), floors=fs_.floors_bytes(),
                      policy=policy, priority_order=fs_.priority_order(),
                      epoch_intervals=fs_.epoch_intervals,
                      interval_s=fs_.interval_s)
            out[f"{name} {policy}"] = fleet_case(name, demand, kw,
                                                 warm=not out)
    # benchmarks/fleet_bench.py's problem: per-tenant fleet traces,
    # weights 3..1, an 8 GiB floor on the last tenant, 50-interval epochs,
    # its 16 gains; its largest row, then the sweep bench's 4096 nodes
    bench_gains = grid_gains(lam=np.linspace(0.1, 1.8, 4),
                             r0=np.linspace(0.88, 0.98, 4))
    t = FLEET_17B_BENCH_INTERVALS
    for k, n in ((8, 1024), (4, 4096)):
        demand = np.stack([fleet_demand_traces(n, t, 0.1, seed=j * 7919)
                           for j in range(k)])
        floors = np.zeros(k)
        floors[-1] = 8.0 * GiB
        kw = dict(node_memory=FLEET_M, weights=np.linspace(3.0, 1.0, k),
                  floors=floors, policy="proportional",
                  epoch_intervals=50, interval_s=0.1)
        out[f"{k}x{n}x{t}"] = fleet_case(f"{k} tenants x {n} nodes", demand,
                                         kw, gains=bench_gains)
    return out


MIXED_EPOCH, MIXED_EPOCHS, MIXED_NODES = 20, 12, 5


def mixed_fleet(device):
    """``examples/mixed_workload.py::build_fleet``: HPCC + Spark over 5
    nodes x 125 GiB, proportional, 20-interval epochs; both tenants'
    planes on the array backend on ``device``."""
    horizon, interval_s = MIXED_EPOCHS * MIXED_EPOCH, 0.1
    hpcc = hpcc_trace(horizon * interval_s, interval_s, seed=0)
    hpcc = np.tile(hpcc, -(-horizon // len(hpcc)))[:horizon] / GiB
    spark = (30.0 + 2.0 * np.random.default_rng(1).standard_normal(
        horizon)).clip(20.0)

    def nodes(trace_gib):
        return tuple(
            NodeSpec(f"node{i}", monitor=SimulatedMonitor(
                f"node{i}", total=FLEET_M,
                usage=lambda t, tr=trace_gib, i=i:
                    float(tr[min(t, len(tr) - 1)]) * GiB * (0.9 + 0.05 * i)))
            for i in range(MIXED_NODES))

    def plane(trace_gib):
        return PlaneSpec(params=ControllerParams(
            total_memory=FLEET_M, u_max=60 * GiB, interval_s=interval_s),
            nodes=nodes(trace_gib), backend="array", device=device)

    return FleetSpec(tenants=(
        TenantSpec("hpcc", plane(hpcc), weight=3.0, priority=1,
                   floor_gib=10.0),
        TenantSpec("spark", plane(spark), weight=1.0, priority=0,
                   floor_gib=22.0)),
        policy="proportional", epoch_intervals=MIXED_EPOCH,
        fleet_memory_gib=FLEET_M / GiB)


def phase17c():
    """The live FleetPlane on the card against a CPU FleetPlane of the
    same spec, tick for tick."""
    log(f"phase 17c: the live FleetPlane on the card (HPCC + Spark, "
        f"{MIXED_NODES} nodes x 125 GiB, {MIXED_EPOCHS} epochs of "
        f"{MIXED_EPOCH}) against the CPU")
    card, cpu = FleetPlane(mixed_fleet(None)), FleetPlane(mixed_fleet("cpu"))
    check(card.budgets() == cpu.budgets(), "initial budgets differ")
    tick_ms, epochs_equal, table = [], 0, []
    for t in range(MIXED_EPOCHS * MIXED_EPOCH):
        epoch = card.epoch
        t0 = time.perf_counter()
        got = card.tick()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        want = cpu.tick()
        b = card.budgets()
        check(sum(b.values()) <= FLEET_M, f"tick {t}: budgets sum "
              f"{sum(b.values()) / GiB} GiB > 125")
        for name, acts in got.items():
            check(all(a.epoch == epoch for a in acts),
                  f"tick {t}: {name} action not stamped with epoch {epoch}")
            check([(a.node, a.u_next) for a in acts]
                  == [(a.node, a.u_next) for a in want[name]],
                  f"tick {t}: {name}'s card actions differ from the CPU's")
        if (t + 1) % MIXED_EPOCH == 0:
            check(b == cpu.budgets(), f"epoch {card.epoch}: card budgets "
                  f"{b} != CPU {cpu.budgets()}")
            epochs_equal += 1
            table.append((card.epoch, b["hpcc"] / GiB, b["spark"] / GiB))
    with count_syncs() as syncs:
        for _ in range(10):
            card.tick()
    r = dict(epochs_bit_identical=epochs_equal,
             tick_host_ms_median=statistics.median(tick_ms),
             tick_host_ms_max=max(tick_ms), syncs_per_tick=len(syncs) / 10,
             budgets_gib=[(e, round(h, 4), round(s, 4)) for e, h, s in table])
    log(f"  budgets equal the CPU's bit for bit at {epochs_equal} of "
        f"{MIXED_EPOCHS} epochs; conservation held at every tick; every "
        f"action stamped with its epoch; epoch (hpcc, spark) GiB: "
        + ", ".join(f"{e} ({h:.1f}, {s:.1f})" for e, h, s in table))
    log(f"  fleet tick: {r['tick_host_ms_median']:.3f} ms median, "
        f"{r['tick_host_ms_max']:.3f} max (host clock), "
        f"{r['syncs_per_tick']:.1f} syncs a tick")
    check(epochs_equal == MIXED_EPOCHS, "not every epoch compared")
    return r


def phase17d():
    """The ChaosPlane drill at full size with planes on the card; its
    supervised retune round launches the sweep kernel."""
    log("phase 17d: the ChaosPlane drill (16 nodes, the full catalog, "
        "retune-kill; then the fleet's crashed tenant), planes on the card")
    out, runs = {}, {}
    for where, device in (("card", None), ("cpu", "cpu")):
        args = type("DrillArgs", (), dict(smoke=False, seed=0,
                                          device=device))()
        failures = []
        if device is None:
            ks.LAUNCHES = 0                # the drill's retune starts here
        t0 = time.perf_counter()
        plane, chaos, counts = chaos_drill.phase_memory_plane(args, failures)
        if device is None:
            out["sweep_launches"] = ks.LAUNCHES
        fleet, fleet_counts = chaos_drill.phase_fleet_plane(args, failures)
        check(not failures, f"drill on the {where}: {failures}")
        runs[where] = (chaos.counts(), counts, fleet_counts, fleet.budgets())
        out[f"{where}_s"] = time.perf_counter() - t0
    (inj, counts, fcounts, budgets), (c_inj, c_counts, c_fcounts,
                                      c_budgets) = runs["card"], runs["cpu"]

    def steady(c):
        # retune-kill and the restarts it causes hit the supervised
        # attempts inside the window, whose timing is the host clock's
        return {k: v for k, v in c.items() if not k.startswith("retune")}

    check(steady(inj) == steady(c_inj),
          f"injected faults: card {inj} != CPU {c_inj}")
    check(steady(counts) == steady(c_counts),
          f"plane fault log: card {counts} != CPU {c_counts}")
    check(fcounts == c_fcounts and budgets == c_budgets,
          "the fleet phase differs from the CPU's")
    check(inj.get("retune-kill", 0) >= 1, "the retune was never killed")
    check(out["sweep_launches"] >= 1,
          "the restarted retune never launched the sweep kernel")
    out.update(injected=inj, injected_cpu=c_inj)
    log(f"  gates held on the card and on the CPU; injected faults equal "
        f"but for retune-kill (card {inj.get('retune-kill')}, CPU "
        f"{c_inj.get('retune-kill')}): {steady(inj)}; the restarted "
        f"retune launched the sweep kernel {out['sweep_launches']} "
        f"time(s); {out['card_s']:.1f} s on the card, {out['cpu_s']:.1f} s "
        f"on the CPU")
    return out


def phase17():
    """Phase 17: returns the sweep kernel's launches in the drill's
    retune (17d) and the numbers."""
    t0 = time.perf_counter()
    r = {"arbitrate": phase17a(), "sweep": phase17b(),
         "plane": phase17c(), "drill": phase17d()}
    r["seconds"] = time.perf_counter() - t0
    log(f"phase 17 seconds (host clock): {r['seconds']:.1f}")
    return r["drill"]["sweep_launches"], r


# Phase 18: the training tenant.  18a trains llama3.2-1b at full width
# through the training CLI's wiring; 18b the smoke model on the card
# against the CPU; 18c the kernels' refusal of autograd and the trained
# model's training forward against its kernel forward (B2).
TRAIN_FULL = dict(arch="llama3.2-1b", steps=6, batch=8, seq=1024,
                  microbatches=2)
TRAIN_SMOKE = dict(arch="llama3.2-1b-smoke", steps=8, batch=4, seq=32,
                   microbatches=2)
TRAIN_PROFILED = (4, 5)          # 18a's steps under the profiler
TRAIN_CARD_CPU_RTOL = 1e-5       # 18b: the smoke losses, card against CPU


def train_args(w, tmp, device=None):
    device = str(CUDA) if device is None else str(device)
    return ttrain.parse_args([
        "--arch", w["arch"], "--steps", str(w["steps"]),
        "--batch-size", str(w["batch"]), "--seq-len", str(w["seq"]),
        "--microbatches", str(w["microbatches"]),
        "--lr", str(w.get("lr", 3e-4)),
        "--data-dir", os.path.join(tmp, "corpus"),
        "--checkpoint-dir", os.path.join(tmp, "ckpt"), "--device", device])


class NoCheckpoint:
    """A trainer's checkpointer that writes nothing.  Phases 19c, 20d,
    21d and 22c train through it: phase 18a writes and times the same
    code's checkpoint and 18b restarts from one, while theirs would put
    tens of GB on disk that nothing reads (ROADMAP C29)."""

    def save(self, tree, step):
        pass

    def wait(self):
        pass


def host_available_bytes():
    with open("/proc/meminfo") as fh:
        for line in fh:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("/proc/meminfo has no MemAvailable")


def profile_steps(trainer, steps, host_ops=True):
    """Run the trainer's steps ``steps`` (consecutive) under the profiler:
    the window opens before the first one's step function (the device
    idle) and closes after the last one's, synchronized.  Returns a dict
    that the window's wall ms and its profiler fill in; ``window_rows``
    reads the profiler after the run.  Without ``host_ops`` only the
    device's activity is recorded: a step of ~10^5 launches would
    otherwise take the profiler minutes to read."""
    inner, first, last = trainer._step_fn, steps[0], steps[-1]
    out, calls = {}, iter(itertools.count())
    activities = [torch.profiler.ProfilerActivity.CUDA]
    if host_ops:
        activities.append(torch.profiler.ProfilerActivity.CPU)
    prof = torch.profiler.profile(activities=activities)

    def stepped(params, state, batch):
        step = next(calls)
        if step == first:
            torch.cuda.synchronize()
            prof.start()
            out["t0"] = time.perf_counter()
        result = inner(params, state, batch)
        if step == last:
            torch.cuda.synchronize()
            out["wall_ms"] = (time.perf_counter() - out.pop("t0")) * 1e3
            prof.stop()
            out["prof"] = prof
        return result

    trainer._step_fn = stepped
    return out


def window_rows(window):
    """The profiled window's device busy ms, kernels and copies, and the
    top six by device time."""
    rows = [e for e in window.pop("prof").key_averages() if on_device(e)
            and e.key != "Activity Buffer Request"]
    window["busy_ms"] = sum(device_us(e) for e in rows) / 1e3
    window["launches"] = sum(e.count for e in rows)
    window["top"] = [(e.key[:50], round(device_us(e) / 1e3, 3), e.count)
                     for e in sorted(rows, key=device_us, reverse=True)[:6]]
    return window

def time_adamw(trainer, state):
    """One ``adamw_update`` over the whole model at the trained state
    (the moments standing in for gradients), timed with CUDA events,
    and its bound: 28 bytes a parameter at the card's memory rate."""
    from repro_torch.optim import adamw_update
    params = {n: p.detach() for n, p in trainer.model.named_parameters()}
    lr = torch.tensor(3e-4, device=CUDA)
    ms = cuda_ms(lambda: adamw_update(state.adam.mu, state.adam, params,
                                      lr=lr), reps=3, warm=1)
    n = sum(p.numel() for p in params.values())
    return {"ms": ms, "bound_ms": rk.adamw(n).bound_ms}


def phase18a(smi):
    """Train llama3.2-1b at full width; returns the trained model and the
    numbers."""
    w = TRAIN_FULL
    cfg = get_config(w["arch"])
    log(f"phase 18a: train {cfg.name} at full width ({cfg.n_layers} layers,"
        f" d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, tied; float32, no TF32; seed "
        f"0) through launch/train.py's wiring: batch {w['batch']} x "
        f"{w['seq']}, {w['microbatches']} microbatches, remat full, "
        f"attention auto (dense), {w['steps']} steps, the shard cache under "
        f"MemoryPlane(host_cache_params(64 GiB)), an async checkpoint at "
        f"the end; on {smi}")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    tmp = tempfile.mkdtemp(prefix="repro-torch-train-")
    try:
        trainer = ttrain.build(train_args(w, tmp), async_checkpoint=True,
                               log_every=1)
        model, pipe, plane = trainer.model, trainer.pipeline, trainer.plane
        n_params = sum(p.numel() for p in model.parameters())
        ckpt_need = 3 * 4 * n_params         # params, mu, nu in float32
        disk = shutil.disk_usage(tmp).free
        ram = host_available_bytes()
        log(f"  params {n_params:,}; corpus {pipe.store.manifest}; the "
            f"checkpoint needs {ckpt_need / 1e9:.2f} GB: temp disk "
            f"{disk / 1e9:.1f} GB free, host RAM {ram / 1e9:.1f} GB "
            f"available")
        check(disk > 1.1 * ckpt_need and ram > 1.1 * ckpt_need,
              f"the machine cannot hold the {ckpt_need / 1e9:.2f} GB "
              f"checkpoint: {disk / 1e9:.1f} GB of temp disk, "
              f"{ram / 1e9:.1f} GB of RAM")
        window = profile_steps(trainer, TRAIN_PROFILED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_kernel_counts()
        t0 = time.monotonic()
        _, state = trainer.fit()
        t_end = time.monotonic()
        launched = kernel_counts()
        check(not any(launched.values()), f"the training path launched "
              f"{launched}")
        peak = torch.cuda.max_memory_allocated()
        window_rows(window)
        opt = time_adamw(trainer, state)
        del state
        pipe.close()
        rows = trainer.metrics_log
        losses = [r["loss"] for r in rows]
        check(len(rows) == w["steps"] and all(map(math.isfinite, losses)),
              f"losses {losses}")
        check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
        ends = [t0] + trainer.logged_at
        step_ms = [(b - a) * 1e3 for a, b in zip(ends, ends[1:])]
        plain = [step_ms[i] for i in range(1, w["steps"])
                 if i not in TRAIN_PROFILED]
        med = statistics.median(plain)
        slowest = max(plain)
        tokens = w["batch"] * w["seq"]
        step_dir = os.path.join(tmp, "ckpt", f"step-{w['steps']:09d}")
        ckpt_bytes = sum(os.path.getsize(os.path.join(step_dir, f))
                         for f in os.listdir(step_dir))
        ckpt_s = t_end - trainer.logged_at[-1]
        health = plane.health()
        idle = 1.0 - window["busy_ms"] / window["wall_ms"]
        log(f"  losses {[round(x, 4) for x in losses]}: finite, "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}")
        log(f"  ms a step (host clock, each ending in its metrics' read): "
            f"{[round(x, 1) for x in step_ms]} (step 0 the first call's "
            f"setup; steps {TRAIN_PROFILED} under the profiler, the last "
            f"also its stop); unprofiled steps median {med:.1f}, max "
            f"{slowest:.1f}; "
            f"{tokens / med * 1e3:.1f} tokens/s; lr peak "
            f"{max(r['lr'] for r in rows):.2e}")
        log(f"  peak memory allocated {peak / 1e9:.2f} GB "
            f"(torch.cuda.max_memory_allocated)")
        log(f"  profiler window, steps {TRAIN_PROFILED}: {window['wall_ms']:.1f}"
            f" ms, device busy {window['busy_ms']:.1f} ms, idle "
            f"{idle:.1%}, {window['launches']} kernels and copies; top "
            f"{window['top']}")
        log(f"  adamw_update alone on the run's moments: {opt['ms']:.2f} ms "
            f"(CUDA events) against a {opt['bound_ms']:.2f} ms bound "
            f"(bytes: read p, g, m, v, write p, m, v), "
            f"{opt['ms'] / med:.1%} of a step")
        log(f"  plane: {health.ticks} ticks, {len(plane.actions())} actions,"
            f" {health.summary()}; cache hit ratio {pipe.hit_ratio:.3f}, "
            f"store reads {pipe.store.reads}")
        check(health.ticks == w["steps"], f"{health.ticks} plane ticks for "
              f"{w['steps']} steps")
        log(f"  checkpoint: {ckpt_bytes / 1e9:.3f} GB written in "
            f"{ckpt_s:.1f} s after the last step's read (staging and "
            f"write; host clock)")
        return model, {
            "arch": cfg.name, "params": n_params, "tokens_per_step": tokens,
            "losses": losses, "step_ms": step_ms, "step_ms_median": med,
            "step_ms_max": slowest, "tokens_s": tokens / med * 1e3,
            "adamw_ms": opt["ms"], "adamw_bound_ms": opt["bound_ms"],
            "peak_gb": peak / 1e9, "idle_share": idle,
            "profiled_ms": window["wall_ms"], "busy_ms": window["busy_ms"],
            "launches_2_steps": window["launches"],
            "plane_ticks": health.ticks, "plane_actions": len(
                plane.actions()), "cache_hit": pipe.hit_ratio,
            "checkpoint_gb": ckpt_bytes / 1e9, "checkpoint_s": ckpt_s}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def smoke_trainer(w, tmp, ckpt, model, device, steps=None,
                  schedule_steps=None):
    """A trainer over the smoke corpus with ``model`` on ``device``."""
    args = train_args(dict(w, steps=schedule_steps or w["steps"]), tmp,
                      device)
    args.checkpoint_dir = os.path.join(tmp, ckpt)
    return ttrain.build(args, model=model, steps=steps or w["steps"],
                        checkpoint_every=4, log_every=1)


def phase18b():
    """The smoke model on the card against the CPU, and restart on the
    card."""
    w = TRAIN_SMOKE
    cfg = get_config(w["arch"])
    log(f"phase 18b: {cfg.name} for {w['steps']} steps on the card and on "
        f"the CPU from the same init; restart on the card (straight against "
        f"4 steps, a crash and resume to {w['steps']})")
    init = Model(cfg, seed=0, device="cpu")

    def copy_of(device):
        m = Model(cfg, device=device, init=False)
        with torch.no_grad():
            for p, q in zip(m.parameters(), init.parameters()):
                p.copy_(q)
        return m

    tmp = tempfile.mkdtemp(prefix="repro-torch-smoke-")
    try:
        runs = []
        for i, dev in enumerate((torch.device("cpu"), CUDA)):
            tr = smoke_trainer(w, tmp, f"ck-{i}", copy_of(dev), dev)
            params, _ = tr.fit()
            tr.pipeline.close()
            runs.append(([r["loss"] for r in tr.metrics_log], params))
        (lc, _), (lg, straight) = runs
        rel = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
        check(rel <= TRAIN_CARD_CPU_RTOL, f"card losses {lg} against CPU "
              f"{lc}: {rel:.3e} relative (bound {TRAIN_CARD_CPU_RTOL})")
        log(f"  losses card {[round(x, 6) for x in lg]}; CPU "
            f"{[round(x, 6) for x in lc]}; max relative difference "
            f"{rel:.3e} (bound {TRAIN_CARD_CPU_RTOL})")
        tr = smoke_trainer(w, tmp, "ck-crash", copy_of(CUDA), CUDA,
                           steps=4, schedule_steps=w["steps"])
        tr.fit()
        tr.pipeline.close()
        junk = Model(cfg, seed=42, device=CUDA)
        tr = smoke_trainer(w, tmp, "ck-crash", junk, CUDA)
        resumed, _ = tr.resume()
        tr.pipeline.close()
        worst = 0.0
        for name, a in straight.items():
            b = resumed[name]
            check(torch.allclose(b, a, atol=1e-6, rtol=1e-5),
                  f"resumed {name} differs from the straight run")
            worst = max(worst, float((a - b).abs().max()))
        log(f"  restart on the card: resumed at step 4, final parameters "
            f"within atol 1e-6, rtol 1e-5 of the straight run (max |diff| "
            f"{worst:.3e}; the embedding's backward adds with atomics)")
        return {"loss_rel_card_cpu": rel, "restart_max_abs": worst}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase18c(model):
    """The kernels refuse autograd; the trained model's training forward
    against its kernel forward.  Returns flash attention's launches."""
    log("phase 18c: the kernels refuse inputs that require grad; the "
        "trained model's training forward (plain dense attention) against "
        "Model.forward (flash attention, B2, f32 3xTF32), 2 x 256 tokens")
    gen = torch.Generator(device=CUDA).manual_seed(18)
    kc = torch.randn((1, 64, 2, 64), generator=gen, device=CUDA)
    a = torch.rand((1, 16, 8, 4), generator=gen, device=CUDA)
    lens = torch.tensor([64], dtype=torch.int32, device=CUDA)
    h0 = torch.zeros((1, 8, 4), device=CUDA)
    calls = {
        "flash_attention": (lambda x: kf.flash_attention(x, kc, kc),
                            torch.randn((1, 64, 4, 64), generator=gen,
                                        device=CUDA)),
        "decode_attention": (lambda x: kd.decode_attention(x, kc, kc, lens),
                             torch.randn((1, 4, 64), generator=gen,
                                         device=CUDA)),
        "ssm_scan": (lambda x: kscan.ssm_scan(x, a, h0), a.clone()),
    }
    before = (kf.LAUNCHES, kd.LAUNCHES, kscan.LAUNCHES)
    for name, (call, x) in calls.items():
        x.requires_grad_(True)
        try:
            call(x)
        except RuntimeError as exc:
            check("no backward" in str(exc), f"{name}: {exc}")
        else:
            raise AssertionError(f"{name} took an input that requires grad")
    check((kf.LAUNCHES, kd.LAUNCHES, kscan.LAUNCHES) == before,
          "a refused call launched a kernel")
    log(f"  {', '.join(calls)}: each raised under autograd, no launch")
    cfg = model.cfg
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen,
                           device=CUDA)
    with torch.no_grad():
        ref = model.forward_train(tokens)
        kf.LAUNCHES = 0                    # the kernel forward starts here
        got = model(tokens)
        launches = kf.LAUNCHES
    check(launches == cfg.n_layers, f"the forward launched flash attention "
          f"{launches} times for {cfg.n_layers} layers")
    check(bool(torch.isfinite(got).all()), "non-finite kernel logits")
    rel = float((got - ref).abs().max() / ref.abs().max())
    check(rel < 5e-3, f"kernel forward against training forward: {rel:.3e} "
          f"relative (bound 5e-3)")
    log(f"  flash attention launched {launches} times; max relative "
        f"difference {rel:.3e} (phase 8's bound 5e-3)")
    return launches, {"forward_vs_train_rel": rel}


def phase18(smi):
    """Phase 18: returns flash attention's launches in 18c and the
    numbers."""
    t0 = time.perf_counter()
    model, full = phase18a(smi)
    r = {"full_width": full, "smoke": phase18b()}
    n_flash, r["kernel_forward"] = phase18c(model)
    del model
    torch.cuda.empty_cache()
    r["seconds"] = time.perf_counter() - t0
    log(f"phase 18 seconds (host clock): {r['seconds']:.1f}")
    return n_flash, r


# Phase 19: the dense features and hybrid training.  19a B2 and B3 at
# head dim 256 (gemma3-1b's) against their plain versions and timed;
# 19b gemma3-1b and qwen2-1.5b served and their forwards against decode
# and the training forward; 19c the three models trained at full width
# and half depth;
# 19d the smoke models, card against CPU.
GEMMA3 = get_config(FULL_WIDTH_GEMMA3["arch"])
QWEN2 = get_config(FULL_WIDTH_QWEN2["arch"])
# gemma3's heads (4/1 of 256) at ragged lengths, windowed and global,
# non-causal with Sq < Skv; two head sets (16/4) and qwen2's group of 6
# (the 8-slot instance, two slots empty); windows that start mid-tile
HD256_FLASH = [(2, 77, 77, 4, 1, 256, True, 0),
               (1, 77, 300, 4, 2, 256, False, 0),
               (2, 600, 600, 4, 1, 256, True, 512),
               (1, 300, 300, 12, 2, 128, True, 0)]
HD256_DECODE = [((8, 1024, 4, 1, 256, 512), None),
                ((4, 900, 16, 4, 256, 0), [0, 1, 900, 555]),
                ((1, 4000, 4, 1, 256, 0), [4000]),
                ((3, 777, 8, 2, 256, 100), [777, 0, 150]),
                ((8, 1024, 12, 2, 128, 0), None)]
GEMMA3_FLASH = (2, 1088)         # (B, S) of 19a's f32 forward shapes
FORWARD_19B = {GEMMA3.name: (1, 600), QWEN2.name: (2, 256)}
TRAIN_19C = dict(TRAIN_FULL, steps=4)
TRAIN_19C_ARCHS = (HYMBA.name, GEMMA3.name, QWEN2.name)
# 19c trains each at full width and a quarter of its depth (8 of 32, 6
# of 26: one 5:1 group, 7 of 28 layers), so phases 20 and 21 fit the
# script's time limit
TRAIN_19C_DEPTH = 0.25
TRAIN_19C_PROFILED = (2,)        # hymba's step under the profiler
SMOKE_19D_ARCHS = tuple(a + "-smoke" for a in TRAIN_19C_ARCHS)


def spill_lines(lib, marker):
    """ptxas's spill lines of the instances whose name holds ``marker``
    (empty when the library was reused, not built)."""
    out, fn = [], None
    for line in lib.log.splitlines():
        if "entry function" in line:
            fn = line
        elif fn and marker in fn and "spill" in line:
            out.append(line.strip())
    return out


def phase19a(libs):
    """B2 and B3 at hd 256 against plain, the new instances' spills, and
    their times at gemma3's shapes.  Returns the errors and the rows."""
    log("phase 19a: flash and decode attention at head dim 256 (gemma3-1b) "
        "and group 6 (qwen2-1.5b) vs plain on the card; spills of the new "
        "instances; times at gemma3's shapes")
    for name in ("flash_attention.cu", "decode_attention.cu"):
        lines = spill_lines(libs[name], "Li256E")
        check(all(ln.startswith("0 bytes stack frame, 0 bytes spill")
                  for ln in lines), f"{name}: hd-256 instances spill: {lines}")
        log(f"  {name}: {len(lines)} hd-256 instances, "
            + ("0 bytes spilled by each" if lines else
               "reused (not built in this run): spills not read"))
    gen = torch.Generator(device=CUDA).manual_seed(19)
    errs = {"decode": {}, "flash": {}}
    for case, lens in HD256_DECODE:
        check_decode(case, lens, gen, errs)
    for case in HD256_FLASH:
        check_flash(case, gen, errs)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=CUDA)
    rows = {}
    b, s = GEMMA3_FLASH
    c = GEMMA3
    windows = layer_windows(c)
    rows["flash_f32"] = []
    for window in sorted(set(windows), reverse=True):
        row = time_flash(b, s, c.n_heads, c.n_kv_heads, c.head_dim, F32,
                         window, gen, flush)
        row["launches_per_forward"] = windows.count(window)
        rows["flash_f32"].append(row)
    b, s = FLASH_TIMED
    rows["flash_bf16"] = time_flash(b, s, c.n_heads, c.n_kv_heads,
                                    c.head_dim, BF16, 0, gen, flush)
    w = FULL_WIDTH_GEMMA3
    bsz, max_len = w["max_batch"], w["max_len"]
    prompt = w["prompt_len"]
    for tag, cfg, window in (("gemma3", GEMMA3, max(windows)),
                             ("qwen2", QWEN2, 0)):
        h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = randn((bsz, h, hd), F32, gen)
        kc, vc = randn((bsz, max_len, kv, hd), BF16, gen), \
            randn((bsz, max_len, kv, hd), BF16, gen)
        lens = torch.randint(prompt, prompt + w["max_new"] + 1, (bsz,),
                             generator=gen, device=CUDA).to(torch.int32)
        rows[f"decode_{tag}"] = time_decode(
            f"{tag} engine B{bsz} x S{max_len} x H{h}/KV{kv} x hd{hd}, q "
            f"f32, bf16 cache, window {window}, lengths {lens.tolist()}", q,
            kc, vc, lens, flush, window=window)
    return errs, rows


def phase19b(smi):
    """gemma3-1b and qwen2-1.5b served, and their forwards against decode
    and against the training forward.  Returns the launches and numbers."""
    out = {}
    for w in (FULL_WIDTH_GEMMA3, FULL_WIDTH_QWEN2):
        eng, n_decode, served = serve_full_width("19b", w, smi)
        model = eng.model
        del eng
        torch.cuda.empty_cache()
        b, s = FORWARD_19B[model.cfg.name]
        # the engine's mixed progress is model-agnostic: phases 8 and 12
        launches = forward_against_decode(19, model, b, s, mixed=False)
        gen = torch.Generator(device=CUDA).manual_seed(191)
        tokens = torch.randint(0, model.cfg.vocab_size, (b, s), generator=gen,
                               device=CUDA)
        with torch.no_grad():
            ref = model.forward_train(tokens)
            got = model(tokens)
        rel = float((got - ref).abs().max() / ref.abs().max())
        check(rel < 5e-3, f"{model.cfg.name}: kernel forward against training "
              f"forward {rel:.3e} relative (bound 5e-3)")
        log(f"  {model.cfg.name}: Model.forward (flash) against forward_train "
            f"(plain dense attention) on {b} x {s} tokens: max relative "
            f"difference {rel:.3e} (bound 5e-3)")
        out[model.cfg.name] = {"decode": n_decode, "flash": launches["flash"],
                               "serving": served, "forward_vs_train": rel}
        del model
        torch.cuda.empty_cache()
    return out


def phase19c(smi):
    """The three models trained at full width and cut depth through the
    training CLI's wiring; hymba timed and profiled.  Returns the
    numbers."""
    out = {}
    for arch in TRAIN_19C_ARCHS:
        w = dict(TRAIN_19C, arch=arch)
        full = get_config(arch)
        cfg = dataclasses.replace(
            full, n_layers=round(full.n_layers * TRAIN_19C_DEPTH))
        hybrid = cfg.family == "hybrid"
        log(f"phase 19c: train {arch} at full width with its depth cut to "
            f"{cfg.n_layers} of {full.n_layers} layers (d {cfg.d_model}, "
            f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff "
            f"{cfg.d_ff}, vocab {cfg.vocab_size}; "
            f"float32, no TF32; seed 0) through launch/train.py's wiring: "
            f"batch {w['batch']} x {w['seq']}, {w['microbatches']} "
            f"microbatches, remat full, {w['steps']} steps; on {smi}")
        tmp = tempfile.mkdtemp(prefix="repro-torch-train19-")
        try:
            trainer = ttrain.build(train_args(w, tmp), log_every=1,
                                   model=Model(cfg, seed=0, device=CUDA))
            trainer.ckpt = NoCheckpoint()
            window = (profile_steps(trainer, TRAIN_19C_PROFILED,
                                    host_ops=False) if hybrid else None)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_kernel_counts()
            t0 = time.monotonic()
            trainer.fit()
            launched = kernel_counts()
            check(not any(launched.values()), f"{arch}: the training path "
                  f"launched {launched}")
            peak = torch.cuda.max_memory_allocated()
            trainer.pipeline.close()
            losses = [r["loss"] for r in trainer.metrics_log]
            check(len(losses) == w["steps"]
                  and all(map(math.isfinite, losses)), f"losses {losses}")
            check(losses[-1] < losses[0], f"{arch}: the loss did not fall: "
                  f"{losses}")
            ends = [t0] + trainer.logged_at
            step_ms = [(b - a) * 1e3 for a, b in zip(ends, ends[1:])]
            plain = [step_ms[i] for i in range(1, w["steps"])
                     if i not in TRAIN_19C_PROFILED]
            med = statistics.median(plain)
            tokens = w["batch"] * w["seq"]
            row = {"losses": losses, "step_ms": step_ms,
                   "step_ms_median": med, "tokens_s": tokens / med * 1e3,
                   "peak_gb": peak / 1e9, "params": sum(
                       p.numel() for p in trainer.model.parameters())}
            log(f"  losses {[round(x, 4) for x in losses]}: finite, "
                f"{losses[0]:.4f} -> {losses[-1]:.4f}; no kernel launched")
            log(f"  ms a step (host clock): {[round(x, 1) for x in step_ms]}"
                f" (step 0 the first call's setup"
                + (f"; step {TRAIN_19C_PROFILED} under the profiler"
                   if hybrid else "") + f"); median of the others {med:.1f},"
                f" {tokens / med * 1e3:.1f} tokens/s; peak memory allocated "
                f"{peak / 1e9:.2f} GB")
            if hybrid:
                window_rows(window)
                row["idle_share"] = idle = 1.0 - window["busy_ms"] / \
                    window["wall_ms"]
                row.update(profiled_ms=window["wall_ms"],
                           busy_ms=window["busy_ms"],
                           launches_1_step=window["launches"])
                log(f"  profiler window, step {TRAIN_19C_PROFILED}: "
                    f"{window['wall_ms']:.1f} ms, device busy "
                    f"{window['busy_ms']:.1f} ms, idle {idle:.1%}, "
                    f"{window['launches']} kernels and copies; top "
                    f"{window['top']}")
            out[arch] = row
            del trainer
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
            torch.cuda.empty_cache()
    return out


def phase19d(archs=SMOKE_19D_ARCHS, phase="19d"):
    """The smoke models ``archs`` trained on the card and on the CPU from
    the same init; their losses within 18b's bracket."""
    out = {}
    for arch in archs:
        w = dict(TRAIN_SMOKE, arch=arch)
        cfg = get_config(w["arch"])
        log(f"phase {phase}: {cfg.name} for {w['steps']} steps on the card "
            f"and on the CPU from the same init")
        init = Model(cfg, seed=0, device="cpu")
        if cfg.family == "vlm":
            draw_gates(init, 19)
        tmp = tempfile.mkdtemp(prefix="repro-torch-smoke19-")
        try:
            runs = []
            for i, dev in enumerate((torch.device("cpu"), CUDA)):
                m = Model(cfg, device=dev, init=False)
                with torch.no_grad():
                    for p, q in zip(m.parameters(), init.parameters()):
                        p.copy_(q)
                tr = smoke_trainer(w, tmp, f"ck-{i}", m, dev)
                with_context(tr.pipeline, cfg, w["batch"])
                tr.fit()
                tr.pipeline.close()
                runs.append([r["loss"] for r in tr.metrics_log])
            lc, lg = runs
            rel = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
            check(rel <= TRAIN_CARD_CPU_RTOL, f"{cfg.name}: card losses {lg} "
                  f"against CPU {lc}: {rel:.3e} relative (bound "
                  f"{TRAIN_CARD_CPU_RTOL})")
            log(f"  losses card {[round(x, 6) for x in lg]}; CPU "
                f"{[round(x, 6) for x in lc]}; max relative difference "
                f"{rel:.3e} (bound {TRAIN_CARD_CPU_RTOL})")
            out[cfg.name] = rel
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return out


def phase19(libs, smi):
    """Phase 19: returns the kernels' errors and rows and the launches and
    numbers of the served and trained models."""
    t0 = time.perf_counter()
    errs, rows = phase19a(libs)
    served = phase19b(smi)
    r = {"served": served, "trained": phase19c(smi),
         "smoke_card_vs_cpu": phase19d()}
    r["seconds"] = time.perf_counter() - t0
    log(f"phase 19 seconds (host clock): {r['seconds']:.1f}")
    return errs, rows, r


# Phase 20: the moe family.  20a B2 and B3 at qwen2-moe-a2.7b's heads
# (16/16 of 128: B3's group of 1) against their plain versions and
# timed; 20b qwen2-moe-a2.7b served at full width and depth through the
# burst, with the choices the experts' capacity dropped; 20c one moe
# layer on the card against the CPU, with and without drops, and the
# forward (B2) against forward_train and, at cf 8.0, against decode;
# 20d the family trained: qwen2-moe at full width cut to 2 layers, and
# both smoke models on the card against the CPU.
QWEN2_MOE = get_config(FULL_WIDTH_QWEN2_MOE["arch"])
# qwen2-moe's heads at ragged lengths and a mid-tile window, one (sequence,
# kv head) pair per head over 4000 keys; flash causal and non-causal
MOE_DECODE = [((8, 1024, 16, 16, 128, 0), None),
              ((3, 777, 16, 16, 128, 100), [777, 0, 150]),
              ((1, 4000, 16, 16, 128, 0), [4000])]
MOE_FLASH = [(2, 300, 300, 16, 16, 128, True, 0),
             (1, 77, 300, 16, 16, 128, False, 0)]
MOE_FORWARD = (2, 1088)          # 20c's forward: 2176 tokens, 4 groups of 544
MOE_FORWARD_DECODE = (1, 256)    # 20c's forward against decode, cf 8.0
# 20c's one layer, card against CPU: (capacity factor, tokens)
MOE_LAYER_CASES = ((1.25, 1024), (8.0, 128))
MOE_LAYER_RTOL = 1e-5            # max |card - CPU| over max |CPU|
MOE_TRAIN_LAYERS = 2             # 20d's depth cut at full width
# 20d's shape: one microbatch, so the step logs the routers' aux (JAX's
# microbatched step logs a zero), of 4 x 1024 tokens, so the 152k-entry
# readout's float32 logits and their gradients fit beside 29 GB of weights
# and AdamW state
TRAIN_20D = dict(TRAIN_FULL, arch=QWEN2_MOE.name, steps=4, batch=4,
                 microbatches=1)
SMOKE_20D_ARCHS = (QWEN2_MOE.name + "-smoke", "dbrx-132b-smoke")


def phase20a():
    """B2 and B3 at qwen2-moe's heads against plain, and their times at
    its shapes.  Returns the errors and the rows."""
    log("phase 20a: flash and decode attention at qwen2-moe-a2.7b's 16/16 "
        "heads of 128 (decode's group of 1) vs plain on the card; times at "
        "its shapes")
    gen = torch.Generator(device=CUDA).manual_seed(20)
    errs = {"decode": {}, "flash": {}}
    for case, lens in MOE_DECODE:
        check_decode(case, lens, gen, errs)
    for case in MOE_FLASH:
        check_flash(case, gen, errs)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=CUDA)
    c = QWEN2_MOE
    h, kv, hd = c.n_heads, c.n_kv_heads, c.head_dim
    b, s = MOE_FORWARD
    rows = {"flash_f32": time_flash(b, s, h, kv, hd, F32, 0, gen, flush)}
    rows["flash_f32"]["launches_per_forward"] = c.n_layers
    w = FULL_WIDTH_QWEN2_MOE
    bsz, max_len, prompt = w["max_batch"], w["max_len"], w["prompt_len"]
    q = randn((bsz, h, hd), F32, gen)
    kc, vc = randn((bsz, max_len, kv, hd), BF16, gen), \
        randn((bsz, max_len, kv, hd), BF16, gen)
    lens = torch.randint(prompt, prompt + w["max_new"] + 1, (bsz,),
                         generator=gen, device=CUDA).to(torch.int32)
    rows["decode"] = time_decode(
        f"qwen2-moe engine B{bsz} x S{max_len} x H{h}/KV{kv} x hd{hd}, q "
        f"f32, bf16 cache, lengths {lens.tolist()}", q, kc, vc, lens, flush)
    return errs, rows


def record_routing(fn):
    """``fn()`` with every ``moe_apply`` call's (experts, keep) recorded;
    returns its result and the records, in call order."""
    seen = []
    TM.ROUTE_HOOK = lambda experts, keep: seen.append((experts, keep))
    try:
        return fn(), seen
    finally:
        TM.ROUTE_HOOK = None


def routing_by_layer(records, b, s):
    """A forward's records (one (G, Sg, k) pair a layer) as experts and
    keep of shape (L, B, S, k)."""
    return tuple(torch.stack([r[i].reshape(b, s, -1) for r in records])
                 for i in (0, 1))


def agreeing_prefix(a, b):
    """Per sequence, the positions before the first one whose routing
    (experts or keep, in any layer) differs between ``a`` and ``b``
    ((L, B, S, k) pairs): there both ran the same experts on every
    token, and causal attention keeps later tokens out.  Returns the
    prefix lengths (B,) and the count of differing (layer, token)
    pairs."""
    diff = ((a[0] != b[0]) | (a[1] != b[1])).any(-1)       # (L, B, S)
    pairs = int(diff.sum())
    first = diff.any(0).int()                              # (B, S)
    s = first.shape[1]
    prefix = torch.where(first.any(1), first.argmax(1),
                         torch.full_like(first[:, 0], s))
    return prefix.tolist(), pairs


def prefix_rel(got, want, prefix):
    """max |got - want| over max |want| on each sequence's (non-empty)
    prefix."""
    num = max(float((got[i, :p] - want[i, :p]).abs().max())
              for i, p in enumerate(prefix))
    den = max(float(want[i, :p].abs().max()) for i, p in enumerate(prefix))
    return num / den


def serve_moe(smi):
    """qwen2-moe-a2.7b served through the burst, with the drops of busy
    slots' choices counted over every step.  Returns the model, the
    decode launches and the numbers."""
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    log(f"phase 20b: {before / 1e9:.2f} GB allocated before the model is "
        f"built (earlier phases' models and caches freed)")
    # 60.6 GB of weights, 1.6 GB of cache, 20c's second copy of a layer's
    # experts (2.2 GB) and a forward's activations leave ~18 GB of the card
    check(before < 8e9, f"{before / 1e9:.2f} GB still allocated")
    busy = []
    next_tokens = ServingEngine._next_tokens

    def recording(eng):
        tokens, feeding = next_tokens(eng)
        busy.append(sorted(feeding))
        return tokens, feeding

    torch.cuda.reset_peak_memory_stats()
    ServingEngine._next_tokens = recording
    try:
        (eng, launches, served), seen = record_routing(
            lambda: serve_full_width("20b", FULL_WIDTH_QWEN2_MOE, smi))
    finally:
        ServingEngine._next_tokens = next_tokens
    peak = torch.cuda.max_memory_allocated()
    model, cfg = eng.model, eng.model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    e_pad = model.layers[0].moe.wi.shape[0]
    check(e_pad == TM.padded_experts(cfg), f"{e_pad} padded experts")
    steps = len(busy)
    check(len(seen) == steps * cfg.n_layers, f"{len(seen)} routings for "
          f"{steps} decode steps x {cfg.n_layers} layers")
    keep = torch.stack([k for _, k in seen]).reshape(
        steps, cfg.n_layers, -1, cfg.experts_per_token)   # (T, L, B, k)
    mask = torch.zeros((steps, keep.shape[2]), dtype=torch.bool,
                       device=CUDA)
    for t, slots in enumerate(busy):
        mask[t, slots] = True
    dropped = ~keep
    busy_drops = int((dropped & mask[:, None, :, None]).sum())
    all_drops = int(dropped.sum())
    busy_choices = int(mask.sum()) * cfg.n_layers * cfg.experts_per_token
    served.update(params=n_params, peak_gb=peak / 1e9,
                  pool_after_shrink=served["after_shrink"][0],
                  busy_choices_dropped=busy_drops,
                  choices_dropped=all_drops, busy_choices=busy_choices)
    log(f"  {n_params:,} parameters ({e_pad} padded experts), peak memory "
        f"allocated {peak / 1e9:.2f} GB; pool "
        f"{served['after_shrink'][0] / 2**20:.0f} MiB on the tick after "
        f"the shrink")
    log(f"  capacity drops (cap 4 a step's group of 8, free slots routing "
        f"token 0 as JAX's do): {busy_drops} of {busy_choices} busy "
        f"slots' choices, {all_drops} in all slots, over {steps} steps x "
        f"{cfg.n_layers} layers")
    del eng
    torch.cuda.empty_cache()
    return model, launches, served


def moe_layer(cfg, arrays, device):
    """One ``MoE`` module on ``device`` holding ``arrays`` (name -> numpy)."""
    def make(shape, kind):
        return torch.nn.Parameter(torch.empty(shape, device=device),
                                  requires_grad=False)

    moe = TM.MoE(cfg, make)
    with torch.no_grad():
        for name, p in moe.named_parameters():
            p.copy_(torch.from_numpy(arrays[name]))
    return moe


def phase20c_layer(model):
    """Layer 0's experts of the served model, carried to numpy (the shared
    gate drawn at random: the init gives zeros), on the card and on the
    CPU from those arrays, on the same inputs: with drops (cf 1.25, 1024
    tokens) and without (cf 8.0, 128 tokens)."""
    rng = np.random.default_rng(20)
    arrays = {n: p.detach().cpu().numpy()
              for n, p in model.layers[0].moe.named_parameters()}
    arrays["shared.gate"] = rng.normal(0, 0.5, arrays["shared.gate"].shape
                                       ).astype(np.float32)
    out = {}
    for cf, n in MOE_LAYER_CASES:
        cfg = dataclasses.replace(model.cfg, capacity_factor=cf)
        x = rng.normal(0, 1, (1, n, cfg.d_model)).astype(np.float32)
        runs = []
        for dev in (CUDA, torch.device("cpu")):
            moe = moe_layer(cfg, arrays, dev)
            (y, aux), seen = record_routing(lambda: TM.moe_apply(
                moe, torch.from_numpy(x).to(dev), cfg))
            runs.append((y.cpu(), float(aux), seen[0][0].cpu(),
                         seen[0][1].cpu()))
            del moe
        (yg, ag, eg, kg), (yc, ac, ec, kc) = runs
        drops = int((~kc).sum())
        check(torch.equal(eg, ec) and torch.equal(kg, kc),
              f"cf {cf}: the card chose or kept other pairs than the CPU")
        check((drops > 0) == (cf < 8.0), f"cf {cf}: {drops} drops")
        rel = float((yg - yc).abs().max() / yc.abs().max())
        aux_rel = abs(ag - ac) / ac
        check(rel <= MOE_LAYER_RTOL and aux_rel <= MOE_LAYER_RTOL,
              f"cf {cf}: card against CPU {rel:.3e}, aux {aux_rel:.3e} "
              f"(bound {MOE_LAYER_RTOL})")
        log(f"  one layer's moe_apply, cf {cf}, 1 x {n} tokens: the card's "
            f"choices and drops == the CPU's ({drops} of {kc.numel()} "
            f"dropped); output max |diff| / max {rel:.3e}, aux "
            f"{ag:.6f} vs {ac:.6f} (bound {MOE_LAYER_RTOL})")
        out[f"cf{cf}"] = {"rel": rel, "aux_rel": aux_rel, "drops": drops}
    return out


def phase20c(model):
    """The layer card against CPU, the forward (B2) against
    forward_train, and, at cf 8.0, against decode.  Returns flash
    attention's launches in the forward and the numbers."""
    log(f"phase 20c: qwen2-moe-a2.7b's moe layer on the card against the "
        f"CPU; Model.forward (flash) against forward_train at "
        f"{MOE_FORWARD[0]} x {MOE_FORWARD[1]} tokens and, at cf 8.0, "
        f"against decode at {MOE_FORWARD_DECODE[0]} x "
        f"{MOE_FORWARD_DECODE[1]}")
    r = {"layer": phase20c_layer(model)}
    cfg = model.cfg
    gen = torch.Generator(device=CUDA).manual_seed(201)
    b, s = MOE_FORWARD
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=CUDA)
    with torch.no_grad():
        kf.LAUNCHES = 0                    # the forward path starts here
        got, fwd_routes = record_routing(lambda: model(tokens))
        launches = kf.LAUNCHES
        ref, train_routes = record_routing(
            lambda: model.forward_train(tokens))
    check(launches == cfg.n_layers, f"the forward launched flash "
          f"{launches} times for {cfg.n_layers} layers")
    check(bool(torch.isfinite(got).all()), "non-finite forward logits")
    a = routing_by_layer(fwd_routes, b, s)
    prefix, pairs = agreeing_prefix(a, routing_by_layer(train_routes, b, s))
    drops = int((~a[1]).sum())
    check(pairs <= 0.01 * a[1][..., 0].numel() and min(prefix) > 0,
          f"forward and forward_train routed {pairs} (layer, token) pairs "
          f"apart")
    rel = prefix_rel(got, ref, prefix)
    check(rel < 5e-3, f"forward against forward_train {rel:.3e} relative "
          f"(bound 5e-3)")
    sg = TM._group_size(b * s)
    log(f"  forward: flash launched {launches} times; {b * s // sg} groups "
        f"of {sg} tokens, {drops} choices dropped; forward_train "
        f"routed {pairs} (layer, token) pairs otherwise (positions compared "
        f"{prefix} of {s}); logits max relative difference {rel:.3e} "
        f"(bound 5e-3)")
    r["forward_vs_train"] = {"rel": rel, "routing_pairs_differing": pairs,
                             "drops": drops, "positions": prefix}
    del got, ref
    cfg8 = dataclasses.replace(cfg, capacity_factor=8.0)
    model.cfg = cfg8
    try:
        b, s = MOE_FORWARD_DECODE
        tokens = tokens[:b, :s]
        with torch.no_grad():
            fwd, fwd_routes = record_routing(lambda: model(tokens))

            def decode_all():
                state = D.init_state(model, b, s, cache_dtype="float32")
                return torch.cat([D.decode_step(model, state,
                                                tokens[:, t:t + 1])
                                  for t in range(s)], dim=1)

            dec, dec_routes = record_routing(decode_all)
    finally:
        model.cfg = cfg
    a = routing_by_layer(fwd_routes, b, s)
    n = cfg.n_layers
    steps = [routing_by_layer(dec_routes[t * n:(t + 1) * n], b, 1)
             for t in range(s)]
    d = tuple(torch.cat([st[i] for st in steps], dim=2) for i in (0, 1))
    check(bool(a[1].all()) and bool(d[1].all()), "cf 8.0 dropped a choice")
    prefix, pairs = agreeing_prefix(a, d)
    check(pairs <= 0.01 * a[1][..., 0].numel() and min(prefix) > 0,
          f"forward and decode routed {pairs} (layer, token) pairs apart")
    rel = prefix_rel(dec, fwd, prefix)
    check(rel < 5e-3, f"forward against decode {rel:.3e} relative (bound "
          f"5e-3)")
    log(f"  cf 8.0 (the smoke reduction's; at cf 1.25 the forward's groups "
        f"of {TM._group_size(b * s)} and decode's of {b} drop different "
        f"choices by design): no "
        f"choice dropped; decode routed {pairs} (layer, token) pairs "
        f"otherwise (positions compared {prefix} of {s}); forward vs "
        f"decode max relative difference {rel:.3e} (bound 5e-3)")
    r["forward_vs_decode_cf8"] = {"rel": rel,
                                  "routing_pairs_differing": pairs,
                                  "positions": prefix}
    return launches, r


def phase20d(smi):
    """qwen2-moe trained at full width cut to 2 layers through the
    training CLI's wiring; then both smoke models card against CPU.
    Returns the numbers."""
    w = TRAIN_20D
    cfg = dataclasses.replace(QWEN2_MOE, n_layers=MOE_TRAIN_LAYERS)
    log(f"phase 20d: train {QWEN2_MOE.name} at full width with its depth "
        f"cut to {MOE_TRAIN_LAYERS} of {QWEN2_MOE.n_layers} layers (d "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}, {TM.padded_experts(cfg)} padded experts of "
        f"{cfg.d_ff_expert}, top "
        f"{cfg.experts_per_token}, {cfg.n_shared_experts} shared, vocab "
        f"{cfg.vocab_size}; float32, no TF32; seed 0) through "
        f"launch/train.py's wiring: batch {w['batch']} x {w['seq']}, "
        f"{w['microbatches']} microbatch, remat full, {w['steps']} steps; on "
        f"{smi}")
    tmp = tempfile.mkdtemp(prefix="repro-torch-train20-")
    out = {}
    try:
        model = Model(cfg, seed=0, device=CUDA)
        trainer = ttrain.build(train_args(w, tmp), model=model, log_every=1)
        trainer.ckpt = NoCheckpoint()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_kernel_counts()
        t0 = time.monotonic()
        trainer.fit()
        launched = kernel_counts()
        check(not any(launched.values()), f"the training path launched "
              f"{launched}")
        peak = torch.cuda.max_memory_allocated()
        trainer.pipeline.close()
        rows = trainer.metrics_log
        losses = [r["loss"] for r in rows]
        auxes = [r["aux"] for r in rows]
        check(len(losses) == w["steps"] and all(map(math.isfinite, losses))
              and all(a > 0 for a in auxes), f"losses {losses}, aux {auxes}")
        check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
        ends = [t0] + trainer.logged_at
        step_ms = [(b - a) * 1e3 for a, b in zip(ends, ends[1:])]
        med = statistics.median(step_ms[1:])
        tokens = w["batch"] * w["seq"]
        n_params = sum(p.numel() for p in model.parameters())
        log(f"  {n_params:,} parameters; losses "
            f"{[round(x, 4) for x in losses]} (aux "
            f"{[round(x, 5) for x in auxes]}): finite, {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}; no kernel launched")
        log(f"  ms a step (host clock): {[round(x, 1) for x in step_ms]} "
            f"(step 0 the first call's setup); median of the others "
            f"{med:.1f}, {tokens / med * 1e3:.1f} tokens/s; peak memory "
            f"allocated {peak / 1e9:.2f} GB")
        out["full_width_2_layers"] = {
            "layers": MOE_TRAIN_LAYERS, "params": n_params,
            "losses": losses, "aux": auxes, "step_ms": step_ms,
            "step_ms_median": med, "tokens_s": tokens / med * 1e3,
            "peak_gb": peak / 1e9}
        del trainer, model
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    out["smoke_card_vs_cpu"] = phase19d(SMOKE_20D_ARCHS, "20d")
    return out


def phase20(smi):
    """Phase 20: returns the kernels' errors and rows, and the launches
    and numbers of the served and trained family."""
    t0 = time.perf_counter()
    errs, rows = phase20a()
    model, n_decode, served = serve_moe(smi)
    n_flash, r = phase20c(model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    r.update(served=served, trained=phase20d(smi),
             decode_launches=n_decode, flash_launches=n_flash)
    r["seconds"] = time.perf_counter() - t0
    log(f"phase 20 seconds (host clock): {r['seconds']:.1f}")
    return errs, rows, r


# Phase 21: the cross-attention families.  21a B2 and B3 at the new
# shapes (non-causal at hd 64 and 128, Sq > Skv, group 1 at hd 64; B3 at
# group 4 over a bf16 cache, cross caches read whole and at length 0)
# against their plain versions, their spills, and their times beside
# their bounds and SDPA; 21b llama-3.2-vision-11b and whisper-large-v3
# served at full width and depth through the burst (zero cross caches,
# as JAX's engine serves them), then 8 prompts prefilled with images or
# frames attached and decoded; 21c the kernel forward against
# forward_train and against decode with the context attached; 21d both
# trained at full width (the vision model cut to one group); 21e the
# smoke models, card against CPU.
VLM = get_config(FULL_WIDTH_VLM["arch"])
WHISPER = get_config(FULL_WIDTH_WHISPER["arch"])
# B3: the vision model's self cache (32/8 of 128, group 4) and its cross
# cache read whole (1600 image tokens); whisper's self cache (20/20 of
# 64, group 1) and its cross cache at enc_len 1500 of 1536 and at 0;
# ragged lengths that are multiples of no tile
CROSS_DECODE = [((8, 1024, 32, 8, 128, 0), None),
                ((8, 1600, 32, 8, 128, 0), [1600] * 8),
                ((8, 1024, 20, 20, 64, 0), None),
                ((8, 1536, 20, 20, 64, 0), [1500] * 4 + [0] * 4),
                ((3, 1601, 32, 8, 128, 0), [1601, 777, 1]),
                ((3, 1537, 20, 20, 64, 0), [1499, 0, 1537])]
# B2 non-causal: whisper's encoder (20/20 of 64), its decoder's
# cross-attention, the vision model's (32/8 of 128) with Sq > Skv and
# Sq < Skv; then ragged lengths
CROSS_FLASH = [(2, 1536, 1536, 20, 20, 64, False, 0),
               (2, 288, 1536, 20, 20, 64, False, 0),
               (2, 2048, 1600, 32, 8, 128, False, 0),
               (2, 300, 1600, 32, 8, 128, False, 0),
               (1, 1500, 1500, 20, 20, 64, False, 0),
               (1, 1001, 999, 32, 8, 128, False, 0),
               (1, 77, 1601, 32, 8, 128, False, 0)]
# The template instances these shapes launch, by the mangled names'
# markers (type list, head dim, and for decode the head sets and heads a
# warp): their spills are gated at 0
CROSS_INSTANCES = {"flash_attention.cu": ("Li64EE", "Li128EE"),
                   "decode_attention.cu": ("Li64ELi1ELi4EE",
                                           "Li128ELi1ELi4EE")}
# 21a's timed B2 instances, f32: (b, sq, skv, h, kv, hd), non-causal
CROSS_FLASH_TIMED = [(2, 1536, 1536, 20, 20, 64), (2, 288, 1536, 20, 20, 64),
                     (2, 2048, 1600, 32, 8, 128), (2, 300, 1600, 32, 8, 128),
                     (1, 1500, 1500, 20, 20, 64)]
# 21b: the context (image tokens, whisper's 1500 frames) prefilled with
# 8 prompts of 64 tokens, then 32 greedy decode steps (the prefill is
# one decode step a token: prompts of 256 take ~22 s a model)
CONTEXT_LEN = {VLM.name: VLM.vision_tokens, WHISPER.name: 1500}
PREFILL_21B = (8, 64, 32)
FORWARD_21C = (2, 40)            # 21c's tokens, with the full context
# Both train at a peak lr of 3e-5: at the CLI's 3e-4 (one warmup step)
# their losses rose after the first step on an NVIDIA H100 80GB HBM3 at
# 700 W (whisper 11.42, 10.30, 15.70, 19.79; the vision model's group
# 12.21, 17.68, 13.79, 12.95)
TRAIN_21D = {WHISPER.name: dict(TRAIN_FULL, arch=WHISPER.name, steps=4,
                                batch=4, seq=448, microbatches=1, lr=3e-5),
             VLM.name: dict(TRAIN_FULL, arch=VLM.name, steps=4, batch=4,
                            seq=1024, microbatches=1, lr=3e-5)}
# the vision model trains cut to one group (5 self layers and a cross
# layer): its 46 GB of float32 weights and AdamW's state do not fit.
# whisper trains at half its depth (16 encoder and 16 decoder layers)
# to keep the script inside its time limit: at full depth 21d took
# 70.4 s on an NVIDIA H100 80GB HBM3 at 700 W, most of it the two
# end-of-run checkpoints (19 GB for whisper, 28 GB for the vision group),
# which it no longer writes (NoCheckpoint).
TRAIN_21D_VLM_GROUPS = 1
TRAIN_21D_WHISPER_DEPTH = 0.5
SMOKE_21E_ARCHS = (VLM.name + "-smoke", WHISPER.name + "-smoke",
                   "mistral-large-123b-smoke")


def with_context(pipe, cfg, batch, n=None):
    """``pipe.batch`` with the images (vlm) or frames (audio) the model
    attends to beside the tokens: ``n`` positions (default
    ``vision_tokens``) drawn once from seed 21, the same each step.
    Other families' pipelines are left as they are."""
    key = {"vlm": "images", "audio": "frames"}.get(cfg.family)
    if key is None:
        return pipe
    ctx = np.random.default_rng(21).standard_normal(
        (batch, n or cfg.vision_tokens, cfg.d_model), dtype=np.float32)
    plain = pipe.batch
    pipe.batch = lambda step: {**plain(step), key: ctx}
    return pipe


def context_kw(cfg, ctx):
    return {"images" if cfg.family == "vlm" else "frames": ctx}


def draw_gates(model, seed):
    """The vision model's cross gates drawn from N(0, 1), in place (JAX's
    init gives zeros, which makes the cross layers add nothing)."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    with torch.no_grad():
        for c in model.cross_layers:
            c.gate.copy_(torch.randn((1,), generator=gen,
                                     device=model.device))
    gates = [float(c.gate) for c in model.cross_layers]
    check(all(g != 0.0 for g in gates), f"a zero gate: {gates}")
    return gates


def phase21a(libs):
    """B2 and B3 at the new shapes against plain, the spills of the hd-64
    and hd-128 instances, and their times.  Returns the errors and the
    rows."""
    log("phase 21a: flash attention non-causal at hd 64 (whisper-large-v3, "
        "20/20 heads) and hd 128 (llama-3.2-vision-11b, 32/8, Sq > Skv), "
        "decode attention at group 4 over a bf16 cache and over cross "
        "caches (read whole, at enc_len 1500 and at 0), vs plain on the "
        "card; spills; times")
    for name, markers in CROSS_INSTANCES.items():
        for marker in markers:
            lines = spill_lines(libs[name], marker)
            check(all(ln.startswith("0 bytes stack frame, 0 bytes spill")
                      for ln in lines), f"{name}: {marker} spills: {lines}")
            log(f"  {name}: {len(lines)} {marker} instances (the slice's), "
                + ("0 bytes spilled by each" if lines else
                   "reused (not built in this run): spills not read"))
    others = [ln for ln in spill_lines(libs["decode_attention.cu"], "Li")
              if not ln.startswith("0 bytes stack frame, 0 bytes spill")]
    log(f"  decode_attention.cu: {len(others)} instances off this slice's "
        f"path spill (hd 32 and 64 at 6-8 heads a kv head; not gated): "
        f"{sorted(set(others))}")
    gen = torch.Generator(device=CUDA).manual_seed(21)
    errs = {"decode": {}, "flash": {}}
    for case, lens in CROSS_DECODE:
        check_decode(case, lens, gen, errs)
    for case in CROSS_FLASH:
        check_flash(case, gen, errs)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=CUDA)
    rows = {"flash_f32": []}
    for b, sq, skv, h, kv, hd in CROSS_FLASH_TIMED:
        rows["flash_f32"].append(time_flash(b, sq, h, kv, hd, F32, 0, gen,
                                            flush, skv=skv, causal=False))
    w = FULL_WIDTH_VLM
    bsz, max_len, prompt = w["max_batch"], w["max_len"], w["prompt_len"]
    for tag, cfg, s, lens in (
            ("vlm_self", VLM, max_len, None),
            ("vlm_cross", VLM, VLM.vision_tokens, [VLM.vision_tokens] * bsz),
            ("whisper_self", WHISPER, max_len, None),
            ("whisper_cross", WHISPER, WHISPER.vision_tokens, [1500] * bsz)):
        h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = randn((bsz, h, hd), F32, gen)
        kc, vc = randn((bsz, s, kv, hd), BF16, gen), \
            randn((bsz, s, kv, hd), BF16, gen)
        if lens is None:           # the engine's: prompt + generated
            lens = torch.randint(prompt, prompt + w["max_new"] + 1, (bsz,),
                                 generator=gen, device=CUDA)
        lens = torch.as_tensor(lens, device=CUDA).to(torch.int32)
        rows[f"decode_{tag}"] = time_decode(
            f"{tag} B{bsz} x S{s} x H{h}/KV{kv} x hd{hd}, q f32, bf16 "
            f"cache, lengths {lens.tolist()}", q, kc, vc, lens, flush)
    # whisper's cross cache at enc_len 0, as its engine serves: zeros
    lens = torch.zeros((bsz,), dtype=torch.int32, device=CUDA)
    out = kd.decode_attention(q, kc, vc, lens)
    ref = kd.decode_attention_plain(q, kc, vc, lens)
    check(not out.any() and not ref.any(), "enc_len 0: not zeros")
    ms = cuda_ms(lambda: kd.decode_attention(q, kc, vc, lens), reps=7,
                 flush=flush, lead=True)
    rows["decode_whisper_cross_len0"] = {"ms": ms, "zeros": True}
    log(f"  decode whisper_cross at enc_len 0 (B{bsz} x S"
        f"{WHISPER.vision_tokens}): kernel and plain give zeros; kernel "
        f"{ms:.4f} ms (no key to read)")
    return errs, rows


def serve_cross(w, smi):
    """One cross-attention model served through the burst (zero cross
    caches), then its gates drawn (vlm) and 8 prompts prefilled with a
    drawn context attached and decoded.  Returns the model, the decode
    launches of both runs and the numbers."""
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    check(before < 8e9, f"{before / 1e9:.2f} GB still allocated")
    torch.cuda.reset_peak_memory_stats()
    eng, launches, served = serve_full_width("21b", w, smi)
    peak = torch.cuda.max_memory_allocated()
    model, cfg = eng.model, eng.model.cfg
    st = eng.state
    check(not st.cross_k.any() and (st.enc_len is None
                                    or int(st.enc_len) == 0),
          "the engine's cross caches are not zero")
    del eng, st
    torch.cuda.empty_cache()
    n_params = sum(p.numel() for p in model.parameters())
    served.update(params=n_params, peak_gb=peak / 1e9)
    log(f"  {n_params:,} parameters ({len(model.layers)} self layers"
        + (f", {len(model.cross_layers)} cross layers" if cfg.family == "vlm"
           else f", {len(model.enc_layers)} encoder layers")
        + f"); peak memory allocated {peak / 1e9:.2f} GB; cross caches zero"
        + (", enc_len 0" if cfg.family == "audio" else ""))
    gates = draw_gates(model, 21) if cfg.family == "vlm" else None
    b, s, new = PREFILL_21B
    n_ctx = CONTEXT_LEN[cfg.name]
    gen = torch.Generator(device=CUDA).manual_seed(211)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=CUDA)
    ctx = torch.randn((b, n_ctx, cfg.d_model), generator=gen, device=CUDA)
    torch.cuda.synchronize()
    kd.LAUNCHES = 0                        # the prefill path starts here
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, state = D.prefill(model, tokens, s + new,
                                  **context_kw(cfg, ctx))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = []
        for _ in range(new):
            nxt = logits[:, -1].argmax(-1, keepdim=True)
            out.append(nxt)
            logits = D.decode_step(model, state, nxt)
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    n_launch = kd.LAUNCHES
    per_step = decode_launches_per_step(model)
    check(n_launch == (s + new) * per_step, f"decode launched {n_launch} "
          f"times for {s + new} steps x {per_step}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    kept = n_ctx if cfg.family == "vlm" else int(state.enc_len)
    check(kept == n_ctx, f"enc_len {kept} for {n_ctx} frames")
    nonzero = [bool(state.cross_k[i, :, :kept].any()
                    and state.cross_v[i, :, :kept].any())
               for i in range(state.cross_k.shape[0])]
    check(all(nonzero) and not state.cross_k[:, :, kept:].any(),
          f"cross caches: non-zero {nonzero}, zeros past {kept}")
    tokens_out = torch.cat(out, 1)
    row = {"prefill_s": t1 - t0, "decode_s": t2 - t1,
           "prefill_tok_s": b * s / (t1 - t0),
           "decode_tok_s": b * new / (t2 - t1), "launches": n_launch,
           "gates": gates, "distinct_tokens": int(tokens_out.unique().numel())}
    log(f"  prefill {b} x {s} tokens with {n_ctx} "
        f"{'image tokens' if cfg.family == 'vlm' else 'frames'} attached"
        + (f" (gates drawn: {[round(g, 3) for g in gates]})" if gates
           else f" (enc_len {kept} of {state.cross_k.shape[2]})")
        + f": {t1 - t0:.2f} s ({row['prefill_tok_s']:.1f} tok/s), then "
        f"{new} decode steps {t2 - t1:.2f} s ({row['decode_tok_s']:.1f} "
        f"tok/s), host clock; {state.cross_k.shape[0]} cross caches "
        f"non-zero; logits finite; decode launches {n_launch} = "
        f"{s + new} steps x {per_step}")
    del state, logits
    torch.cuda.empty_cache()
    served["prefill"] = row
    return model, launches + n_launch, served


def phase21c(model):
    """The served model's kernel forward against forward_train (dense
    attention) and against decode with the context attached (f32
    cache).  Returns flash's launches in the forward and the numbers."""
    cfg = model.cfg
    b, s = FORWARD_21C
    n_ctx = CONTEXT_LEN[cfg.name]
    log(f"phase 21c: {cfg.name}: Model.forward (flash) against forward_train "
        f"(dense attention) and against prefill/decode_step with the "
        f"context attached (f32 cache), {b} x {s} tokens, {n_ctx} "
        f"{'image tokens' if cfg.family == 'vlm' else 'frames'}")
    gen = torch.Generator(device=CUDA).manual_seed(212)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=CUDA)
    kw = context_kw(cfg, torch.randn((b, n_ctx, cfg.d_model), generator=gen,
                                     device=CUDA))
    with torch.no_grad():
        kf.LAUNCHES = 0                    # the forward path starts here
        fwd = model(tokens, **kw)
        launches = kf.LAUNCHES
        check(bool(torch.isfinite(fwd).all()), "non-finite forward logits")
        model.attn_impl = "dense"
        ref = model.forward_train(tokens, **kw)
        state = D.init_state(model, b, s, cache_dtype="float32")
        D.attach_cross_context(model, state, **kw)
        dec = torch.cat([D.decode_step(model, state, tokens[:, t:t + 1])
                         for t in range(s)], dim=1)
    model.attn_impl = "auto"
    want = decode_launches_per_step(model)      # one flash per attention
    want += len(model.enc_layers) if cfg.family == "audio" else 0
    check(launches == want, f"the forward launched flash {launches} times, "
          f"expected {want}")
    rel_train = float((fwd - ref).abs().max() / ref.abs().max())
    rel_dec = float((fwd - dec).abs().max() / fwd.abs().max())
    check(rel_train < 5e-3, f"forward against forward_train {rel_train:.3e}")
    check(rel_dec < 5e-3, f"forward against decode {rel_dec:.3e}")
    log(f"  forward: flash launched {launches} times; against forward_train "
        f"{rel_train:.3e}, against decode {rel_dec:.3e} max relative "
        f"difference (bound 5e-3 each"
        + ("; decode attends the images' bf16 rounding, as JAX's does)"
           if cfg.family == "vlm" else ")"))
    return launches, {"forward_vs_train": rel_train,
                      "forward_vs_decode": rel_dec, "flash": launches}


def phase21d(smi):
    """whisper-large-v3 at half depth and the vision model cut to one
    group trained at full width through the training CLI's wiring, the
    context drawn beside the tokens.  Returns the numbers."""
    out = {}
    for name, w in TRAIN_21D.items():
        full = get_config(name)
        if full.family == "vlm":
            cfg = dataclasses.replace(
                full, n_layers=TRAIN_21D_VLM_GROUPS * full.cross_attn_group)
        else:
            cfg = dataclasses.replace(
                full,
                n_layers=round(full.n_layers * TRAIN_21D_WHISPER_DEPTH),
                n_encoder_layers=round(full.n_encoder_layers
                                       * TRAIN_21D_WHISPER_DEPTH))
        n_ctx = WHISPER.vision_tokens if full.family == "audio" \
            else full.vision_tokens
        log(f"phase 21d: train {name} at full width"
            + (f", cut to {TRAIN_21D_VLM_GROUPS} group ({cfg.n_layers} self "
               f"layers and 1 cross layer of {full.n_layers} and "
               f"{full.n_layers // full.cross_attn_group})"
               if full.family == "vlm" else f", its depth cut to "
               f"{cfg.n_encoder_layers} encoder and {cfg.n_layers} decoder "
               f"layers of {full.n_encoder_layers} and {full.n_layers}")
            + f" (d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
            f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
            f"float32, no TF32; seed 0) through launch/train.py's wiring: "
            f"batch {w['batch']} x {w['seq']} tokens with {n_ctx} "
            f"{'image tokens' if cfg.family == 'vlm' else 'frames'} each, "
            f"{w['microbatches']} microbatch, remat full, peak lr "
            f"{w.get('lr', 3e-4)}, {w['steps']} steps; on {smi}")
        tmp = tempfile.mkdtemp(prefix="repro-torch-train21-")
        try:
            model = Model(cfg, seed=0, device=CUDA)
            if cfg.family == "vlm":
                draw_gates(model, 22)
            trainer = ttrain.build(train_args(w, tmp), model=model,
                                   log_every=1)
            trainer.ckpt = NoCheckpoint()
            with_context(trainer.pipeline, cfg, w["batch"], n_ctx)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_kernel_counts()
            t0 = time.monotonic()
            trainer.fit()
            launched = kernel_counts()
            check(not any(launched.values()), f"the training path launched "
                  f"{launched}")
            peak = torch.cuda.max_memory_allocated()
            trainer.pipeline.close()
            losses = [r["loss"] for r in trainer.metrics_log]
            check(len(losses) == w["steps"]
                  and all(map(math.isfinite, losses)), f"losses {losses}")
            check(losses[-1] < losses[0], f"{name}: the loss did not fall: "
                  f"{losses}")
            ends = [t0] + trainer.logged_at
            step_ms = [(b - a) * 1e3 for a, b in zip(ends, ends[1:])]
            med = statistics.median(step_ms[1:])
            tokens = w["batch"] * w["seq"]
            n_params = sum(p.numel() for p in model.parameters())
            log(f"  {n_params:,} parameters; losses "
                f"{[round(x, 4) for x in losses]}: finite, {losses[0]:.4f} "
                f"-> {losses[-1]:.4f}; no kernel launched")
            log(f"  ms a step (host clock): {[round(x, 1) for x in step_ms]} "
                f"(step 0 the first call's setup); median of the others "
                f"{med:.1f}, {tokens / med * 1e3:.1f} tokens/s; peak memory "
                f"allocated {peak / 1e9:.2f} GB")
            out[name] = {"layers": cfg.n_layers, "params": n_params,
                         "losses": losses, "step_ms": step_ms,
                         "step_ms_median": med,
                         "tokens_s": tokens / med * 1e3,
                         "peak_gb": peak / 1e9}
            del trainer, model
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
            gc.collect()
            torch.cuda.empty_cache()
    return out


def phase21(libs, smi):
    """Phase 21: returns the kernels' errors and rows, and the launches
    and numbers of the served and trained families."""
    t0 = time.perf_counter()
    errs, rows = phase21a(libs)
    r = {"served": {}, "decode_launches": {}, "flash_launches": {}}
    for w in (FULL_WIDTH_VLM, FULL_WIDTH_WHISPER):
        model, n_decode, served = serve_cross(w, smi)
        n_flash, r[w["arch"]] = phase21c(model)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        r["served"][w["arch"]] = served
        r["decode_launches"][w["arch"]] = n_decode
        r["flash_launches"][w["arch"]] = n_flash
    r["trained"] = phase21d(smi)
    r["smoke_card_vs_cpu"] = phase19d(SMOKE_21E_ARCHS, "21e")
    r["seconds"] = time.perf_counter() - t0
    log(f"phase 21 seconds (host clock): {r['seconds']:.1f}")
    return errs, rows, r


# Phase 22: the ssm family (xlstm-125m: six pairs of an mLSTM and an
# sLSTM block, no attention).  JAX runs both blocks as XLA (a scan over
# chunks, a scan over time) with no Pallas kernel behind them, so the
# port runs them in plain PyTorch and the phase gates that no kernel
# launches.  22a served at full width and depth through the burst; 22b
# the forward against forward_train and against decode over 2 x 300
# tokens (three mLSTM chunks of 128), and one mLSTM block chunked
# against stepped beside JAX's own bracket; 22c trained at full width
# and depth; 22d the smoke model, card against CPU.
XLSTM = get_config(FULL_WIDTH_XLSTM["arch"])
FORWARD_22B = (2, 300)
# tests/test_models.py::test_mlstm_chunked_matches_sequential (smoke width)
MLSTM_BRACKET = (2e-4, 2e-3)     # (atol, rtol)
# The sLSTM runs token by token, ~105 kernels a token a layer under full
# remat: on an NVIDIA H100 80GB HBM3 at 700 W a step took 8678.6 ms at
# 4 x 512 (322,717 kernels, 93.8% idle; 108.3 s for 22c) and 5201.8 ms
# at 8 x 256 (162,685 kernels; 53.8 s).  8 x 160 keeps two mLSTM chunks,
# the second padded, inside the script's time limit.
TRAIN_22C = dict(TRAIN_FULL, arch=XLSTM.name, steps=4, batch=8, seq=160,
                 microbatches=1)
TRAIN_22C_PROFILED = (2,)
SMOKE_22D_ARCHS = (XLSTM.name + "-smoke",)


def phase22a(smi):
    """xlstm-125m served through the burst; no kernel launched.  Returns
    the model and the numbers."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_counts()                   # the ssm serving path starts here
    eng, _, served = serve_full_width("22a", FULL_WIDTH_XLSTM, smi)
    launched = kernel_counts()
    check(not any(launched.values()), f"the ssm serving path launched "
          f"{launched}")
    peak = torch.cuda.max_memory_allocated()
    model, st = eng.model, eng.state
    rec = sum(t.numel() * t.element_size() for leaves in
              st.recurrent.values() for t in leaves.values())
    pool = eng.pool.total_blocks * eng.pool.block_bytes
    n_params = sum(p.numel() for p in model.parameters())
    served.update(params=n_params, peak_gb=peak / 1e9,
                  recurrent_state_mb=rec / 1e6, notional_pool_mb=pool / 1e6,
                  block_bytes=eng.pool.block_bytes, launched=launched)
    log(f"  {n_params:,} parameters ({len(model.layers)} pairs of an mLSTM "
        f"and an sLSTM); peak memory allocated {peak / 1e9:.2f} GB; "
        f"recurrent state {rec / 1e6:.1f} MB, fixed; the plane's pool "
        f"{pool / 1e6:.1f} MB of notional K/V blocks ({eng.pool.block_bytes:,}"
        f" B each, ROADMAP C26); kernels launched {launched}")
    del eng, st
    return model, served


def phase22b(model):
    """The forward against forward_train and against decode (f32), and
    the first mLSTM block chunked against stepped."""
    b, s = FORWARD_22B
    log(f"phase 22b: {model.cfg.name}: Model.forward against forward_train "
        f"and against prefill/decode_step, {b} x {s} tokens (mLSTM chunks "
        f"of 128); the first mLSTM block chunked against stepped")
    gen = torch.Generator(device=CUDA).manual_seed(221)
    tokens = torch.randint(0, model.cfg.vocab_size, (b, s), generator=gen,
                           device=CUDA)
    zero_kernel_counts()                   # the ssm forward path starts here
    with torch.no_grad():
        fwd = model(tokens)
        ref = model.forward_train(tokens)
        state = D.init_state(model, b, s, cache_dtype="float32")
        dec = torch.cat([D.decode_step(model, state, tokens[:, t:t + 1])
                         for t in range(s)], dim=1)
        block = model.layers[0]["0_mlstm"]
        u = block.norm.new_empty((b, s, model.cfg.d_model)).normal_(
            generator=gen)
        chunked = TS.mlstm_apply(block.block, u, model.cfg)
        st = {k: torch.full(v, -1e30 if k == "m" else 0.0, device=CUDA)
              for k, v in TS.mlstm_state_shapes(model.cfg, b).items()}
        stepped = []
        for t in range(s):
            y, st = TS.mlstm_decode_step(block.block, u[:, t:t + 1], st,
                                         model.cfg)
            stepped.append(y)
        stepped = torch.cat(stepped, dim=1)
    launched = kernel_counts()
    check(not any(launched.values()), f"the ssm forward path launched "
          f"{launched}")
    for name, t in (("forward", fwd), ("forward_train", ref),
                    ("decode", dec), ("mLSTM chunked", chunked)):
        check(bool(torch.isfinite(t).all()), f"non-finite {name} output")
    rel_train = float((fwd - ref).abs().max() / ref.abs().max())
    rel_dec = float((fwd - dec).abs().max() / fwd.abs().max())
    check(rel_train < 5e-3, f"forward against forward_train {rel_train:.3e}")
    check(rel_dec < 5e-3, f"forward against decode {rel_dec:.3e}")
    atol, rtol = MLSTM_BRACKET
    gap = (chunked - stepped).abs()
    excess = float((gap - rtol * stepped.abs()).max())
    block_abs = float(gap.max())
    log(f"  forward against forward_train {rel_train:.3e}, against decode "
        f"{rel_dec:.3e} max relative difference (bound 5e-3 each); no "
        f"kernel launched ({launched})")
    log(f"  mLSTM block (layer 0), chunked against stepped over {s} tokens: "
        f"max |diff| {block_abs:.3e}, max(|diff| - rtol |stepped|) "
        f"{excess:.3e} against JAX's smoke-width bracket atol {atol:g}, "
        f"rtol {rtol:g}: {'within' if excess <= atol else 'outside'}")
    return {"forward_vs_train": rel_train, "forward_vs_decode": rel_dec,
            "mlstm_chunked_vs_stepped_abs": block_abs,
            "mlstm_excess_over_rtol": excess,
            "mlstm_within_jax_bracket": excess <= atol}


def phase22c(smi):
    """xlstm-125m trained at full width and depth through the training
    CLI's wiring; one step profiled.  Returns the numbers."""
    w = TRAIN_22C
    cfg = XLSTM
    log(f"phase 22c: train {cfg.name} at full width and depth ({cfg.n_layers}"
        f" blocks in {cfg.n_layers // 2} pairs, d {cfg.d_model}, "
        f"{cfg.n_heads} heads, vocab {cfg.vocab_size}, tied; float32, no "
        f"TF32; seed 0) through launch/train.py's wiring: batch "
        f"{w['batch']} x {w['seq']}, {w['microbatches']} microbatch, remat "
        f"full, {w['steps']} steps; on {smi}")
    tmp = tempfile.mkdtemp(prefix="repro-torch-train22-")
    try:
        trainer = ttrain.build(train_args(w, tmp), log_every=1,
                               model=Model(cfg, seed=0, device=CUDA))
        trainer.ckpt = NoCheckpoint()
        window = profile_steps(trainer, TRAIN_22C_PROFILED, host_ops=False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_kernel_counts()               # the ssm training path starts here
        t0 = time.monotonic()
        trainer.fit()
        launched = kernel_counts()
        check(not any(launched.values()), f"the training path launched "
              f"{launched}")
        peak = torch.cuda.max_memory_allocated()
        trainer.pipeline.close()
        losses = [r["loss"] for r in trainer.metrics_log]
        check(len(losses) == w["steps"] and all(map(math.isfinite, losses)),
              f"losses {losses}")
        check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
        ends = [t0] + trainer.logged_at
        step_ms = [(b - a) * 1e3 for a, b in zip(ends, ends[1:])]
        plain = [step_ms[i] for i in range(1, w["steps"])
                 if i not in TRAIN_22C_PROFILED]
        med = statistics.median(plain)
        tokens = w["batch"] * w["seq"]
        window_rows(window)
        idle = 1.0 - window["busy_ms"] / window["wall_ms"]
        n_params = sum(p.numel() for p in trainer.model.parameters())
        log(f"  {n_params:,} parameters; losses {[round(x, 4) for x in losses]}"
            f": finite, {losses[0]:.4f} -> {losses[-1]:.4f}; no kernel "
            f"launched")
        log(f"  ms a step (host clock): {[round(x, 1) for x in step_ms]} "
            f"(step 0 the first call's setup; step {TRAIN_22C_PROFILED} under "
            f"the profiler); median of the others {med:.1f}, "
            f"{tokens / med * 1e3:.1f} tokens/s; peak memory allocated "
            f"{peak / 1e9:.2f} GB")
        log(f"  profiler window, step {TRAIN_22C_PROFILED}: "
            f"{window['wall_ms']:.1f} ms, device busy {window['busy_ms']:.1f} "
            f"ms, idle {idle:.1%}, {window['launches']} kernels and copies; "
            f"top {window['top']}")
        del trainer
        return {"params": n_params, "losses": losses, "step_ms": step_ms,
                "step_ms_median": med, "tokens_s": tokens / med * 1e3,
                "peak_gb": peak / 1e9, "idle_share": idle,
                "profiled_ms": window["wall_ms"],
                "busy_ms": window["busy_ms"],
                "launches_1_step": window["launches"],
                "shape": f"{w['batch']} x {w['seq']}"}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def phase22(smi):
    """Phase 22: the ssm family's numbers; every kernel's count unmoved."""
    t0 = time.perf_counter()
    model, served = phase22a(smi)
    r = {"served": served, "forward": phase22b(model)}
    del model
    gc.collect()
    torch.cuda.empty_cache()
    r["trained"] = phase22c(smi)
    r["smoke_card_vs_cpu"] = phase19d(SMOKE_22D_ARCHS, "22d")
    r["seconds"] = time.perf_counter() - t0
    log(f"phase 22 seconds (host clock): {r['seconds']:.1f}")
    return r


# Phase 23: the tooling (repro_torch.roofline, repro_torch.analysis).
# 23b's sweep: (nodes, intervals) of a small fleet under 16 gains
SANITIZED_SWEEP = (256, 200)


def count_steps(w):
    """23a: one llama3.2-1b decode step at the engine's (slots, max_len)
    and one training step at 18a's shape (``w``), counted on meta
    tensors: nothing runs on the card and nothing is allocated."""
    cfg = get_config(ARCH)
    model = Model(cfg, device="meta", init=False)
    n = sum(p.numel() for p in model.parameters())
    b, s = FULL_WIDTH["max_batch"], FULL_WIDTH["max_len"]
    state = D.init_state(model, b, s)
    tokens = torch.zeros((b, 1), dtype=torch.int64, device="meta")
    with torch.no_grad():
        dec = analyze_step(D.decode_step, model, state, tokens, desc=dict(
            arch=cfg.name, kind="decode", tokens=b, n_params=n,
            dtype="float32", shape=f"{b} slots x {s}"))
    params = train_step.model_params(model)
    step_cfg = train_step.TrainStepConfig(microbatches=w["microbatches"])
    batch = {k: torch.zeros((w["batch"], w["seq"]), dtype=torch.int32,
                            device="meta") for k in ("tokens", "labels")}
    train = analyze_step(
        train_step.build_train_step(model, step_cfg), params,
        train_step.init_train_state(params, step_cfg), batch, desc=dict(
            arch=cfg.name, kind="train", tokens=w["batch"] * w["seq"],
            n_params=n, dtype="float32",
            shape=f"{w['batch']} x {w['seq']}, {w['microbatches']} "
                  f"microbatches, remat full"))
    return dec, train


def sanitized_sweeps():
    """23b, 23c: ``fused_sweep_demand`` on the card with the sanitizers
    on, its chunk loop under ``dispatch_guard``: once as it is, equal to
    the same sweep without them, and once with a ``.item()`` injected
    into the loop's body, which must raise.  Returns the error's text."""
    n, t = SANITIZED_SWEEP
    demand = fleet_demand_traces(n, t, 0.1, seed=23)
    gains = grid_gains(lam=np.linspace(0.2, 1.8, 8), r0=(0.9, 0.95))
    kw = dict(node_memory=125 * GiB, chunk=8)          # two launches
    plain = fs.fused_sweep_demand(demand, gains, **kw)
    before = os.environ.get("PLANECHECK_SANITIZERS")
    inner = fs._sweep_program

    def injected(demand_tn, *args):
        demand_tn.sum().item()                 # the injected host sync
        return inner(demand_tn, *args)

    raised = None
    os.environ["PLANECHECK_SANITIZERS"] = "1"
    try:
        guarded = fs.fused_sweep_demand(demand, gains, **kw)
        fs._sweep_program = injected
        try:
            fs.fused_sweep_demand(demand, gains, **kw)
        except RuntimeError as e:              # the guard's error, expected
            raised = str(e)
    finally:
        fs._sweep_program = inner
        if before is None:
            del os.environ["PLANECHECK_SANITIZERS"]
        else:
            os.environ["PLANECHECK_SANITIZERS"] = before
    check(all(np.array_equal(a, b) for a, b in zip(guarded, plain)),
          "the guarded sweep differs from the same sweep unguarded")
    check(raised is not None and "synchroniz" in raised,
          f"an .item() inside the guarded chunk loop did not raise: {raised}")
    check(torch.cuda.get_sync_debug_mode() == 0,
          "dispatch_guard left the sync debug mode set")
    return raised


def phase23(served, trained, smi):
    """Phase 23: a decode step and a training step counted beside the
    times phases 7 and 18a measured; the sanitizers on the card."""
    t0 = time.perf_counter()
    log(f"phase 23: the roofline of a {ARCH} decode step and training step"
        f" (repro_torch.roofline.analyze_step on meta tensors, so nothing "
        f"is launched: FLOPs from FlopCounterMode, bytes of every aten op "
        f"with gathers and in-place writes counted as slices, B3's work "
        f"from its shapes; float32 at 67 TFLOP/s, 3.35 TB/s; data-sheet "
        f"peaks) "
        f"beside the measured ms a step on {smi}")
    dec, train = count_steps(TRAIN_FULL)
    measured = {"decode": 1e3 * served["seconds"] / served["steps"],
                "train": trained["step_ms_median"]}
    rows = {}
    for kind, row, where in (("decode", dec, "phase 7's serving, host "
                              "clock, every step of the run"),
                             ("train", train, "phase 18a, host clock, "
                              "median of the unprofiled steps")):
        t = row["roofline"]
        log(f"  {kind} ({row['shape']}): {row['hlo_flops_per_chip']:.4e} "
            f"FLOPs, {row['hlo_bytes_per_chip']:.4e} bytes; compute "
            f"{t['compute_s'] * 1e3:.4f} ms, memory {t['memory_s'] * 1e3:.4f}"
            f" ms, bound {t['bound_s'] * 1e3:.4f} ms by {t['dominant']}; "
            f"model FLOPs {row['model_flops_total']:.4e} (useful ratio "
            f"{row['useful_flops_ratio']:.4f}, MFU bound "
            f"{row['model_flops_utilization_bound']:.4f}); kernel calls "
            f"counted on meta {row['kernels']}; measured "
            f"{measured[kind]:.3f} ms a step ({where}), "
            f"{t['bound_s'] * 1e3 / measured[kind]:.2%} of it the bound")
        rows[kind] = {k: row[k] for k in (
            "shape", "hlo_flops_per_chip", "hlo_bytes_per_chip", "roofline",
            "model_flops_total", "useful_flops_ratio",
            "model_flops_utilization_bound")}
        rows[kind]["kernel_calls_counted_on_meta"] = row["kernels"]
        rows[kind]["measured_ms"] = measured[kind]
    log(f"phase 23b: fused_sweep_demand ({SANITIZED_SWEEP[0]} nodes x "
        f"{SANITIZED_SWEEP[1]} intervals x 16 gains, 8 lanes a launch) with "
        f"PLANECHECK_SANITIZERS=1, its chunk loop under dispatch_guard "
        f"(torch.cuda.set_sync_debug_mode('error'))")
    raised = sanitized_sweeps()
    log("  guarded sweep: no error, equal to the unguarded sweep")
    log(f"phase 23c: an .item() injected into the guarded chunk loop "
        f"raised: {raised.splitlines()[0][:120]}")
    rows["seconds"] = time.perf_counter() - t0
    log(f"phase 23 seconds (host clock): {rows['seconds']:.1f}")
    return rows


# ---- the multi-device sweeps (phase 24) ----

# One card laid out as four shards, each with a stream of its own: the
# port's counterpart of JAX's --xla_force_host_platform_device_count=4
ONE_CARD_FOUR = ("cuda:0",) * 4
LAYOUTS_24 = (("4 gain shards", dict(devices=ONE_CARD_FOUR)),
              ("2 x 2", dict(devices=ONE_CARD_FOUR, node_shards=2)),
              ("1 x 4", dict(devices=ONE_CARD_FOUR, node_shards=4)))
# fields a fold over node shards leaves exact: counts, maxes, the settle
# interval
EXACT_24 = ("max_utilization", "frac_intervals_over_r0", "max_over_r0",
            "pressure_violation_rate", "settle_intervals")
# 24c: (nodes, intervals, lanes) of the entry against its plain version
ENTRY_24C = (1024, 600, 16)
# 24c: the intervals of the case at 24b's own operands
HORIZON_24C = 40
# 24d: 17b's 8 x 1024 fleet row over its first 200 intervals (hpcc-spark's
# 5 nodes divide by neither 2 nor 4)
FLEET_24D = (8, 1024, 200)


def distinct_cards():
    """Up to four distinct cards, or None on a one-card machine."""
    n = torch.cuda.device_count()
    return tuple(f"cuda:{i}" for i in range(min(n, 4))) if n >= 2 else None


def synced_ms(fn):
    """(fn(), its host-clock ms with the card idle before and after)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def bits_differing(a, b, fields):
    return [f for f in fields
            if not np.array_equal(getattr(a, f), getattr(b, f))]


def phase24a(demand):
    """sweep_demand at the lab benchmark's fleet in four layouts of one
    card (and of distinct cards where the machine has them)."""
    log("phase 24a: sweep_demand 4096 x 1000 x 64, cache off and on, in "
        "four layouts of one card (devices=1; 4 gain shards, bit for bit; "
        "2 x 2 and 1 x 4 node shards, within the test brackets); ms end to "
        "end on the host clock, numpy in and out, each layout's second run")
    layouts = list(LAYOUTS_24)
    cards = distinct_cards()
    if cards:
        layouts += [(f"{len(cards)} cards, gain shards",
                     dict(devices=cards)),
                    (f"{len(cards)} cards, 1 x {len(cards)}",
                     dict(devices=cards, node_shards=len(cards)))]
    log("  distinct cards: " + (f"{cards} ran too" if cards else
                                f"not run ({torch.cuda.device_count()} "
                                f"card on this machine)"))
    gains, m = grid_gains(), np.full(N_NODES, 125 * GiB)
    out = {"distinct_cards": cards}
    launches = 0        # the timed sharded runs' (not devices=1 or warm-ups)
    for tag, cache in (("cache-off", None), ("cache-on", CACHE)):
        kw = dict(node_memory=m, cache=cache)
        # each layout timed on its second run: the first makes its
        # streams and allocations
        sweep_demand(demand, gains, devices=1, **kw)
        one, ms1 = synced_ms(lambda: sweep_demand(demand, gains, devices=1,
                                                  **kw))
        row = {"devices=1": {"ms": ms1}}
        for name, lay in layouts:
            sweep_demand(demand, gains, **lay, **kw)
            ks.LAUNCHES = 0                # this sharded run starts here
            got, ms = synced_ms(lambda: sweep_demand(demand, gains, **lay,
                                                     **kw))
            launches += ks.LAUNCHES
            bits = bits_differing(got, one, FleetStats._fields)
            bad = stats_mismatches(got, one, n_samples=N_NODES * N_STEPS)
            sharded = lay.get("node_shards", 1) > 1
            log(f"  {tag} {name}: {ms:.1f} ms end to end (devices=1 "
                f"{ms1:.1f}); fields differing from devices=1 bit for bit: "
                f"{bits or 'none'}; brackets: {bad or 'held'}")
            if sharded:
                check(not bad, f"24a {tag} {name}: {bad}")
                check(not set(bits) & set(EXACT_24),
                      f"24a {tag} {name}: an exact field differs: {bits}")
            else:
                check(not bits, f"24a {tag} {name}: gain shards differ from "
                      f"one device: {bits}")
            row[name] = {"ms": ms, "fields_differing": bits}
        out[tag] = row
    out["launches"] = launches
    log(f"main path: sweep kernel launched {launches} times (phase 24a's "
        f"timed sharded sweeps, each counted from 0 just before it)")
    check(launches > 0, "24a's sharded sweeps launched no sweep kernel")
    return out


def exchange_operands(spec, gains, device, n_shards, n_dead=0):
    """Each node shard's graph segment operands of ``spec``'s horizon."""
    con = fs._engine_consts(plan_specialization(gains), spec.cache,
                            spec.interval_s, 1.0, "f32", spec.app_graph)
    names = ks.state_names(con.paper_law, con.has_cache, True)
    demand = spec.build_demand(seed=0)
    work, stage, total = fs._graph_host(spec.app_graph, spec.n_nodes)
    cols = spec.n_nodes // n_shards
    ops = []
    for j in range(n_shards):
        c = slice(j * cols, (j + 1) * cols)
        dtn, rows, lp = fs._stage(demand[c], gains, GRAPH_M, spec.cache,
                                  "f32", device)
        g = (torch.from_numpy(np.ascontiguousarray(work[:, c])).to(device),
             torch.from_numpy(stage).to(device))
        alive = fs._alive(len(gains), len(gains) - n_dead, device)
        ops.append(dict(state=fs._init_state(lp, rows, dtn[0], con, names,
                                             g),
                        hist=fs._zero_hist(lp), demand=dtn, lp=lp,
                        rows=rows, alive=alive, graph=g))
    return ops, con, names, total


def run_exchange(spec, gains, device, n_shards, n_dead):
    """graph_exchange over ``n_shards`` shards of one device: the state
    (nodes in order) and the histograms summed, on the CPU."""
    ops, con, names, _ = exchange_operands(spec, gains, device, n_shards,
                                           n_dead)
    shards = [mesh.Shard(torch.device(device)) for _ in ops]
    states = [o["state"].clone() for o in ops]
    hists = [o["hist"].clone() for o in ops]
    mesh.graph_exchange(shards, states, hists, [o["demand"] for o in ops],
                        [o["lp"] for o in ops], [o["rows"] for o in ops],
                        [o["alive"] for o in ops], [o["graph"] for o in ops],
                        t0=0, con=con, names=names)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return (torch.cat(states, -1).cpu(), sum(h.cpu() for h in hists),
            names)


def phase24b(big_ms):
    """The graph instance over 4 node shards at phase 16e's spark-dag
    4096 x 1800 x 64 (the one-interval entry and its exchange) against
    one device, guarded against host syncs."""
    spec = spark_dag_fleet(N_NODES)
    log(f"phase 24b: spark-dag {N_NODES} x {spec.n_intervals} x 64 "
        f"(cache-on) over 1 x 4 node shards of one card, the barrier's min "
        f"exchanged every interval, against devices=1")
    gains = gains_64("paper")
    demand = spec.build_demand(seed=0)
    kw = dict(node_memory=GRAPH_M, interval_s=spec.interval_s,
              cache=spec.cache, app_graph=spec.app_graph)
    one, ms1 = synced_ms(lambda: sweep_demand(demand, gains, devices=1,
                                              **kw))
    ks.INTERVAL_LAUNCHES = 0               # the node-sharded path starts here
    four, ms4 = synced_ms(lambda: sweep_demand(
        demand, gains, devices=ONE_CARD_FOUR, node_shards=4, **kw))
    launches = ks.INTERVAL_LAUNCHES
    log(f"main path: the one-interval graph entry launched {launches} "
        f"times (phase 24b)")
    check(launches == 4 * (spec.n_intervals + 2),
          f"24b: {launches} launches, not 4 x (T + 2)")
    same = np.array_equal(four.makespan, one.makespan)
    bad = stats_mismatches(four, one, n_samples=N_NODES * spec.n_intervals)
    bits = bits_differing(four, one, FleetStats._fields)
    finished = int((one.makespan < spec.n_intervals * spec.interval_s).sum())
    log(f"  makespan bit for bit: {same} ({finished} of 64 lanes finished, "
        f"{float(one.makespan.min()):.2f}-{float(one.makespan.max()):.2f} "
        f"s); brackets: {bad or 'held'}; fields differing bit for bit: "
        f"{bits or 'none'}")
    check(same, "24b: the node-sharded makespans differ from one device's")
    check(not bad, f"24b: {bad}")
    before = os.environ.get("PLANECHECK_SANITIZERS")
    os.environ["PLANECHECK_SANITIZERS"] = "1"
    try:
        guarded = sweep_demand(demand, gains, devices=ONE_CARD_FOUR,
                               node_shards=4, **kw)
    finally:
        if before is None:
            del os.environ["PLANECHECK_SANITIZERS"]
        else:
            os.environ["PLANECHECK_SANITIZERS"] = before
    check(not bits_differing(guarded, four, FleetStats._fields),
          "24b: the guarded sharded sweep differs")
    log(f"  under PLANECHECK_SANITIZERS=1 (sync debug mode 'error' over the "
        f"dispatch): no host sync, the same stats")
    log(f"  route: {ms4:.1f} ms end to end over 4 x {spec.n_intervals + 2} "
        f"launches ({ms4 * 1e3 / spec.n_intervals:.1f} us an interval); "
        f"devices=1 {ms1:.1f} ms end to end; the unsharded graph kernel "
        f"{big_ms:.4f} ms (phase 16e)")
    return dict(launches=launches, route_ms=ms4, devices1_ms=ms1,
                unsharded_kernel_ms=big_ms, makespan_equal=same,
                fields_differing=bits, lanes_finished=finished)


def phase24c(smi):
    """The one-interval entry against its plain version (the exchange on
    the CPU), at a cut size and at the main path's own shard shape, and
    one launch's time at that shape."""
    n, t, lanes = ENTRY_24C
    log(f"phase 24c: the one-interval graph entry over node shards on the "
        f"card against its plain version on the CPU: {n} nodes x {t} "
        f"intervals x {lanes} lanes (2 dead) over 2 shards, and 24b's own "
        f"operands ({N_NODES} nodes over 4 shards x 64 lanes) over "
        f"{HORIZON_24C} intervals; one launch timed at 24b's shard shape "
        f"on {smi}")
    small = grid_gains(lam=np.linspace(0.2, 1.6, 8), r0=(0.9, 0.95))
    limp = get_scenario("limplock")
    cases = [("limplock, cache-off", limp.replace(
        n_nodes=n, n_intervals=t, app_graph=limp.app_graph.replace(
            iterations=1, slow_nodes=(n - n // 3,))), small, 2, 2),
             ("spark-dag, cache-on", spark_dag_fleet(n // 2).replace(
                 n_intervals=t // 2), small, 2, 2),
             ("spark-dag at 24b's shard shape, cache-on",
              spark_dag_fleet(N_NODES).replace(n_intervals=HORIZON_24C),
              gains_64("paper"), 4, 0)]
    worst, out = 0.0, {}
    for tag, spec, gains, n_shards, n_dead in cases:
        live = len(gains) - n_dead
        sk, hk, names = run_exchange(spec, gains, CUDA, n_shards, n_dead)
        sp, hp, _ = run_exchange(spec, gains, "cpu", n_shards, n_dead)
        max_abs, max_rel = compare_planes(names, sk, sp)
        exact = torch.equal(sk, sp) and torch.equal(hk, hp)
        n_bins = int((hk != hp).sum())
        rows_equal = all(torch.equal(sk[names.index(p)], sp[names.index(p)])
                         for p in ("sidx", "t_done"))
        t_done = sk[names.index("t_done"), :live, 0]
        log(f"  {tag} ({spec.n_nodes} x {spec.n_intervals} over {n_shards} "
            f"shards): bit-identical={exact} max_abs={max_abs:.3e} "
            f"max_rel={max_rel:.3e} hist_bins_differing={n_bins} "
            f"rows_and_t_done_equal={rows_equal} lanes finished "
            f"{int((t_done >= 0).sum())} of {live}")
        check(rows_equal, f"24c {tag}: stage rows or t_done differ")
        if spec.cache is None:
            check(exact, f"24c {tag}: not bit-identical to the plain version")
        else:
            check(max_rel <= 1e-6 and n_bins <= live,
                  f"24c {tag}: {max_rel:.3e} relative, {n_bins} bins")
        worst = max(worst, max_abs)
        out[tag] = dict(bit_identical=exact, max_abs_err=max_abs,
                        max_rel_err=max_rel, hist_bins_differing=n_bins)
    spec = spark_dag_fleet(N_NODES)
    ops, con, names, _ = exchange_operands(spec, gains_64("paper"), CUDA, 4)
    o = ops[0]
    fleet_in = torch.zeros((64,), dtype=torch.int32, device=CUDA)
    lvl = torch.full((64,), ks.LVL_EMPTY, dtype=torch.int32, device=CUDA)
    kw = dict(k=1, t0=0, con=con, names=names, graph=o["graph"],
              fleet_in=fleet_in, out=lvl,
              mode=ks.GRAPH_STEP | ks.GRAPH_PROMOTE)
    args = (o["state"], o["hist"], o["demand"], o["lp"], o["rows"],
            o["alive"])
    before = ks.INTERVAL_LAUNCHES
    # what the timed launch touches, from one launch on copies: the bins
    # it adds to and the work entries (row, node) its promotions read
    st, hist = o["state"].clone(), o["hist"].clone()
    ks.graph_interval(st, hist, *args[2:], **{**kw, "out": lvl.clone()})
    hist_updates = int((hist != o["hist"]).sum())
    sidx = names.index("sidx")
    moved = st[sidx] != o["state"][sidx]
    node = torch.arange(st.shape[-1], device=CUDA).expand_as(moved)
    work_reads = int(torch.unique(st[sidx][moved].long() * st.shape[-1]
                                  + node[moved]).numel())
    ms = cuda_ms(lambda: ks.graph_interval(*args, **kw), reps=21,
                 lead=True)
    ks.INTERVAL_LAUNCHES = before          # timing launches are not the path
    plain_ms = cuda_ms(lambda: ks.graph_interval_plain(*args, **kw),
                       reps=5, warm=1)
    work = rk.sweep_interval(N_NODES // 4, 64, cache=True, paper_law=True,
                             n_stages=o["graph"][1].shape[1] - 1,
                             hist_updates=hist_updates,
                             work_reads=work_reads)
    log(f"  one launch (a shard of {N_NODES // 4} nodes x 64 lanes, "
        f"cache-on, stepping and promoting): {ms:.4f} ms (CUDA events after "
        f"a ~1 ms device-side lead, median of 21); plain {plain_ms:.4f} ms; "
        f"bound {work.bound_ms:.4f} ms by {work.bound_by} "
        f"({work.bytes / 1e6:.2f} MB: the state read and written, "
        f"{hist_updates} histogram bins added to, {work_reads} work entries "
        f"read), the launch at {work.bound_ms / ms:.1%} of it")
    out.update(ms=ms, plain_ms=plain_ms, bound_ms=work.bound_ms,
               bound_by=work.bound_by, max_abs_err=worst,
               hist_updates=hist_updates, work_reads=work_reads)
    return out


def phase24d():
    """The fleet sweep over node shards against one device."""
    k, n, t = FLEET_24D
    log(f"phase 24d: fleet_sweep_demand {k} x {n} x {t} x 16 over 2 x 2 "
        f"and 1 x 4 layouts of one card against devices=1")
    demand = np.stack([fleet_demand_traces(n, t, 0.1, seed=j * 7919)
                       for j in range(k)])
    floors = np.zeros(k)
    floors[-1] = 8.0 * GiB
    kw = dict(node_memory=FLEET_M, weights=np.linspace(3.0, 1.0, k),
              floors=floors, policy="proportional", epoch_intervals=50,
              interval_s=0.1)
    gains = grid_gains(lam=np.linspace(0.1, 1.8, 4),
                       r0=np.linspace(0.88, 0.98, 4))
    (one, one_ex), ms1 = synced_ms(lambda: fleet_sweep_demand(
        demand, gains, devices=1, **kw))
    out = {"devices=1": {"ms": ms1}}
    for name, lay in LAYOUTS_24[1:]:
        (got, ex), ms = synced_ms(lambda: fleet_sweep_demand(
            demand, gains, **lay, **kw))
        bad = stats_mismatches(got, one, n_samples=n * t)
        bits = bits_differing(got, one, FleetStats._fields)
        ex_bits = bits_differing(ex, one_ex, FleetExtras._fields)
        for f in FleetExtras._fields:
            np.testing.assert_allclose(getattr(ex, f), getattr(one_ex, f),
                                       rtol=2e-4, atol=1e-3,
                                       err_msg=f"24d {name} {f}")
        mins_exact = not set(ex_bits) & {"conservation_slack_gib",
                                         "floor_slack_gib",
                                         "tenant_budget_min_gib"}
        log(f"  {name}: {ms:.1f} ms end to end (devices=1 {ms1:.1f}); "
            f"brackets: {bad or 'held'}; differing bit for bit: stats "
            f"{bits or 'none'}, extras {ex_bits or 'none'}")
        check(not bad, f"24d {name}: {bad}")
        check(mins_exact, f"24d {name}: a min fold differs: {ex_bits}")
        out[name] = {"ms": ms, "fields_differing": bits + ex_bits}
    return out


def phase24(demand, big_ms, smi):
    """Phase 24: the multi-device sweeps on one card."""
    t0 = time.perf_counter()
    a = phase24a(demand)
    b = phase24b(big_ms)
    c = phase24c(smi)
    d = phase24d()
    seconds = time.perf_counter() - t0
    log(f"phase 24 seconds (host clock): {seconds:.1f}")
    return dict(sweep=a, graph=b, entry=c, fleet=d, seconds=seconds)


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
    log("  sweep.cu instances (cudaFuncGetAttributes, "
        "cudaOccupancyMaxActiveBlocksPerMultiprocessor, "
        "cudaOccupancyMaxActiveClusters):")
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
    n_drill, fleet17 = phase17()
    log(f"main path: sweep kernel launched {n_drill} times (phase 17d's "
        f"restarted retune)")
    n_flash_t, training = phase18(smi)
    log(f"main path: phase 18a's training launched none of the four "
        f"kernels; flash attention launched {n_flash_t} times (phase 18c's "
        f"kernel forward of the trained model)")
    flash["launches"] += n_flash_t
    flash["launches_by_path"][f"{ARCH} trained model's forward (phase "
                              f"18c)"] = n_flash_t
    errs19, rows19, dense19 = phase19(libs, smi)
    for name, served19 in dense19["served"].items():
        log(f"main path: decode attention launched {served19['decode']} "
            f"times ({name} serving, phase 19b), flash attention "
            f"{served19['flash']} times ({name} forward, phase 19b)")
        check(served19["decode"] > 0 and served19["flash"] > 0,
              f"{name}'s serving path skipped an attention kernel")
        decode["launches"] += served19["decode"]
        decode["launches_by_path"][f"{name} serving (phase 19b)"] = \
            served19["decode"]
        flash["launches"] += served19["flash"]
        flash["launches_by_path"][f"{name} forward (phase 19b)"] = \
            served19["flash"]
    for name, d in (("decode", decode), ("flash", flash)):
        d["max_abs_err"] = max(d["max_abs_err"], *errs19[name].values())
        d["max_abs_err_f32"] = max(d["max_abs_err_f32"],
                                   errs19[name]["f32"])
    flash["gemma3_hd256"] = {"f32_2x1088": rows19["flash_f32"],
                             "bf16_2x4096": rows19["flash_bf16"]}
    f32_errs = [r["max_abs_err"] for r in rows19["flash_f32"]]
    flash["max_abs_err"] = max(flash["max_abs_err"], *f32_errs,
                               rows19["flash_bf16"]["max_abs_err"])
    flash["max_abs_err_f32"] = max(flash["max_abs_err_f32"], *f32_errs)
    decode["gemma3_engine"] = rows19["decode_gemma3"]
    decode["qwen2_engine"] = rows19["decode_qwen2"]
    decode["max_abs_err_f32"] = max(
        decode["max_abs_err_f32"], rows19["decode_gemma3"]["max_abs_err"],
        rows19["decode_qwen2"]["max_abs_err"])
    kernel["launches_by_path"] = {
        "run_sweep, sweep_demand, tune_gains (phases 2-4)":
        kernel["launches"], "serving retune round (phase 15a)": n_retune,
        "paper testbed replays and 4096-node tunings (phase 15b)":
        n_testbed,
        "simulate_fleet (phase 15c)": n_fleet,
        "AppGraph sweeps, gates and tunings (phase 16)": n_graph,
        "ChaosPlane drill's supervised retune (phase 17d)": n_drill}
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
    log("fleet and chaos on the card: " + json.dumps(fleet17, default=str))
    log("training on the card: " + json.dumps(training, default=str))
    log("dense features and hybrid training on the card: "
        + json.dumps(dense19, default=str))
    errs20, rows20, moe20 = phase20(smi)
    n_decode_m, n_flash_m = moe20["decode_launches"], moe20["flash_launches"]
    log(f"main path: decode attention launched {n_decode_m} times "
        f"({QWEN2_MOE.name} serving, phase 20b), flash attention "
        f"{n_flash_m} times ({QWEN2_MOE.name} forward, phase 20c)")
    check(n_decode_m > 0 and n_flash_m > 0,
          f"{QWEN2_MOE.name}'s serving path skipped an attention kernel")
    decode["launches"] += n_decode_m
    decode["launches_by_path"][f"{QWEN2_MOE.name} serving (phase 20b)"] = \
        n_decode_m
    flash["launches"] += n_flash_m
    flash["launches_by_path"][f"{QWEN2_MOE.name} forward (phase 20c)"] = \
        n_flash_m
    for name, d in (("decode", decode), ("flash", flash)):
        d["max_abs_err"] = max(d["max_abs_err"], *errs20[name].values())
        d["max_abs_err_f32"] = max(d["max_abs_err_f32"],
                                   errs20[name]["f32"])
    decode["qwen2_moe_engine"] = rows20["decode"]
    flash["qwen2_moe_f32"] = rows20["flash_f32"]
    decode["max_abs_err_f32"] = max(decode["max_abs_err_f32"],
                                    rows20["decode"]["max_abs_err"])
    flash["max_abs_err"] = max(flash["max_abs_err"],
                               rows20["flash_f32"]["max_abs_err"])
    flash["max_abs_err_f32"] = max(flash["max_abs_err_f32"],
                                   rows20["flash_f32"]["max_abs_err"])
    log("moe family on the card: " + json.dumps(moe20, default=str))
    errs21, rows21, cross21 = phase21(libs, smi)
    for name in (VLM.name, WHISPER.name):
        n_dec = cross21["decode_launches"][name]
        n_fl = cross21["flash_launches"][name]
        log(f"main path: decode attention launched {n_dec} times ({name} "
            f"serving and prefill, phase 21b), flash attention {n_fl} times "
            f"({name} forward, phase 21c)")
        check(n_dec > 0 and n_fl > 0,
              f"{name}'s serving path skipped an attention kernel")
        decode["launches"] += n_dec
        decode["launches_by_path"][f"{name} serving and prefill (phase "
                                   f"21b)"] = n_dec
        flash["launches"] += n_fl
        flash["launches_by_path"][f"{name} forward (phase 21c)"] = n_fl
    for name, d in (("decode", decode), ("flash", flash)):
        d["max_abs_err"] = max(d["max_abs_err"], *errs21[name].values())
        d["max_abs_err_f32"] = max(d["max_abs_err_f32"],
                                   errs21[name]["f32"])
    flash["cross_families_f32"] = rows21["flash_f32"]
    f32_errs = [row["max_abs_err"] for row in rows21["flash_f32"]]
    flash["max_abs_err"] = max(flash["max_abs_err"], *f32_errs)
    flash["max_abs_err_f32"] = max(flash["max_abs_err_f32"], *f32_errs)
    for tag in ("vlm_self", "vlm_cross", "whisper_self", "whisper_cross"):
        row = rows21[f"decode_{tag}"]
        decode[f"{tag}_engine"] = row
        decode["max_abs_err_f32"] = max(decode["max_abs_err_f32"],
                                        row["max_abs_err"])
    decode["whisper_cross_len0"] = rows21["decode_whisper_cross_len0"]
    log("cross-attention families on the card: "
        + json.dumps(cross21, default=str))
    ssm22 = phase22(smi)
    log(f"main path: {XLSTM.name} served, forwarded, decoded and trained "
        f"(phase 22) launched none of the four kernels")
    log("ssm family on the card: " + json.dumps(ssm22, default=str))
    tooling = phase23(served, training["full_width"], smi)
    log("tooling on the card: " + json.dumps(tooling, default=str))
    mesh24 = phase24(demand, big["ms"], smi)
    kernel["launches_by_path"]["timed sharded sweep_demand layouts (phase "
                               "24a)"] = \
        mesh24["sweep"]["launches"]
    kernel["launches"] = sum(kernel["launches_by_path"].values())
    entry = mesh24["entry"]
    interval = {
        "name": "graph_interval (sweep_segment's graph instance, one "
                "interval a launch)", "route": "cuda",
        "source": "src/repro_torch/csrc/sweep.cu",
        "replaces": "src/repro/lab/sweep.py:403 (the barrier's pmin across "
                    "node shards; XLA beside "
                    "src/repro/lab/pallas_sweep.py:407)",
        "launches": mesh24["graph"]["launches"],
        "launches_by_path": {"spark-dag 4096 x 1800 x 64 over 1 x 4 node "
                             "shards (phase 24b)":
                             mesh24["graph"]["launches"]},
        "max_abs_err": entry["max_abs_err"],
        **{k: entry[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "shape": f"one launch: a shard of {N_NODES // 4} nodes x 64 lanes, "
                 f"spark-dag cache-on, stepping and promoting",
        "route_ms": mesh24["graph"]["route_ms"],
        "unsharded_kernel_ms": mesh24["graph"]["unsharded_kernel_ms"],
        "parity": {k: v for k, v in entry.items()
                   if isinstance(v, dict)}}
    log("multi-device sweeps on the card: "
        + json.dumps(mesh24, default=str))
    ends = [t for _, t in PHASE_STARTS[1:]] + [time.perf_counter()]
    log("seconds by phase (host clock): " + ", ".join(
        f"{name} {end - start:.1f}"
        for (name, start), end in zip(PHASE_STARTS, ends)))
    log(f"script total (host clock, from its start): "
        f"{time.perf_counter() - T_START:.1f} s")
    print(smi)
    print(json.dumps({"kernels": [kernel, interval, decode, flash, scan]},
                     default=float))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
