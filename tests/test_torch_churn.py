"""The port's runtime copies held against the JAX package's runtime.

``churn_demand`` runs the straggler detector and the heartbeat monitor
over a simulated fleet; the port's copy must give the same demand byte
for byte and the same event log, and the detectors must decide as
JAX's do on the same inputs.  ``runtime-churn`` is the registry
scenario built from that demand.
"""

import dataclasses

import numpy as np
import pytest

import repro.lab as jlab
import repro.runtime as jrt
from repro.runtime.churn import churn_demand as jax_churn_demand
from repro_torch import runtime as trt
from repro_torch.convert import gainset_from_numpy
from repro_torch.lab import scenarios as tsc
from repro_torch.lab.score import stats_mismatches
from repro_torch.lab.sweep import run_sweep
import torch

# One intra-op thread: the suite's workers share the cores, and torch's
# OpenMP threads, oversubscribed, spin-wait ~100x longer than the ops.
torch.set_num_threads(1)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(n_nodes=10, n_intervals=200, seed=3),
    dict(n_nodes=40, n_intervals=300, seed=7, straggler_frac=0.3,
         failure_frac=0.25, failure_len=30, check_every=4),
], ids=["registry", "small", "dense"])
def test_churn_demand_equals_jax_byte_for_byte(kw):
    d_ref, ev_ref = jax_churn_demand(**kw)
    d_got, ev_got = trt.churn_demand(**kw)
    assert d_got.dtype == d_ref.dtype and d_got.shape == d_ref.shape
    assert d_got.tobytes() == d_ref.tobytes()
    assert ev_got == ev_ref
    assert sum(len(v) for v in ev_got.values()) > 0


def test_runtime_churn_scenario_sweeps_as_jax():
    jg = jlab.grid_gains(lam=(0.3, 1.2), r0=(0.9, 0.96),
                         lam_grant=(None, 0.3))
    a = jlab.run_sweep("runtime-churn", jg, seed=0)
    b = run_sweep("runtime-churn", gainset_from_numpy(
        {f.name: getattr(jg, f.name) for f in dataclasses.fields(jg)}),
        seed=0, device="cpu")
    spec = tsc.get_scenario("runtime-churn")
    assert (spec.n_nodes, spec.n_intervals, spec.family) == (24, 480,
                                                             "replay")
    bad = stats_mismatches(b.stats, a.stats,
                           n_samples=spec.n_nodes * spec.n_intervals)
    assert bad == [], "\n".join(bad)
    assert a.best() == b.best()


def _detector_run(mod, times, checks):
    log = []
    det = mod.StragglerDetector(
        window=8, threshold=1.5, grace=2,
        squeeze_cb=lambda w, f: log.append(("squeeze", w, f)),
        evict_cb=lambda w: log.append(("evict", w)))
    reports = []
    for t, row in enumerate(times):
        for i, x in enumerate(row):
            det.record(f"w{i}", float(x))
        if t in checks:
            reports.append([(r.worker, r.median_s, r.fleet_median_s, r.action)
                            for r in det.check()])
    return log, reports


def test_straggler_detector_decides_as_jax():
    rng = np.random.default_rng(0)
    times = rng.uniform(0.9, 1.1, (60, 6))
    times[10:, 2] *= 2.5                         # a straggler from step 10
    times[20:40, 4] *= 1.8                       # a transient one
    checks = set(range(3, 60, 5))
    ref = _detector_run(jrt, times, checks)
    got = _detector_run(trt, times, checks)
    assert got == ref
    assert any(a[0] == "evict" for a in got[0])


def _monitor_run(mod, beats, n_workers, timeout):
    mon = mod.HeartbeatMonitor(interval_s=0.5, timeout_intervals=timeout)
    events = []
    mon.on_failure(lambda w: events.append(("fail", w)))
    mon.on_recovery(lambda w: events.append(("recover", w)))
    for i in range(n_workers):
        mon.heartbeat(f"w{i}", now=0.0)         # first beat registers
    out = []
    for t, alive in enumerate(beats):
        now = 0.5 * (t + 1)
        for i in np.flatnonzero(alive):
            mon.heartbeat(f"w{i}", now=now)
        out.append((mon.check(now=now), sorted(mon.healthy_workers()),
                    sorted(mon.failed_workers())))
    return events, out


def test_heartbeat_monitor_decides_as_jax():
    rng = np.random.default_rng(1)
    beats = rng.uniform(size=(80, 7)) > 0.3
    beats[20:40, 3] = False                      # a long outage
    ref = _monitor_run(jrt, beats, 7, 3)
    got = _monitor_run(trt, beats, 7, 3)
    assert got == ref
    assert ("fail", "w3") in got[0] and ("recover", "w3") in got[0]
    assert trt.WorkerState("w", 1.0).healthy


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_limplock_nodes_decides_as_jax(seed):
    rng = np.random.default_rng(seed)
    times = rng.uniform(1.0, 1.2, 16)
    times[rng.integers(16, size=2)] *= 3.0
    for thr in (1.2, 1.5, 2.0):
        assert trt.limplock_nodes(times, thr) == jrt.limplock_nodes(times,
                                                                     thr)
    assert trt.limplock_nodes([5.0]) == jrt.limplock_nodes([5.0]) == []
    assert trt.limplock_nodes(np.zeros(4)) == []


def test_runtime_exports_only_the_copies():
    """The copies: the detectors, the churn demand, the chaos harness and
    the elastic mesh planner (every name of JAX's, and churn_demand)."""
    assert sorted(trt.__all__) == sorted(list(jrt.__all__) + ["churn_demand"])
    assert "FAULT_KINDS" in trt.__all__ and "inject" in trt.__all__
    assert "ElasticMeshPlanner" in trt.__all__ and "MeshPlan" in trt.__all__
