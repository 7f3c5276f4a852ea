"""The port's ChaosPlane harness against the JAX package's, on the CPU.

Mirrors ``tests/test_chaos.py`` case for case on the port -- fault
injection through the real harness, the health state machine on both
plane backends, fail-static degradation, retune supervision, and the
FleetPlane's quarantined tenant and rebalance rollback -- and adds the
twins: the same :class:`ChaosSpec` injected into a JAX plane (or fleet)
and into the port's delivers the same fault log ``(kind, node, tick)``
and the same health counts, and the fleet's budgets stay equal bit for
bit.  The drill (``repro_torch.launch.chaos_drill``) delivers JAX's
injected-fault counts, all but ``retune-kill``: how many supervised
capture attempts land inside the kill window depends on the host's
clock (the backoff is in seconds, the window in ticks).  Planes run
with ``device="cpu"``.
"""

import importlib.util
import math
import pathlib
import threading
import time
import types

import pytest

import repro.core as JC
import repro.fleet as JF
import repro.runtime as JR
from repro_torch.core import (ControllerParams, GiB, HealthPolicy,
                              MemoryPlane, MemorySample, MonitorFault,
                              NodeHealth, NodeSpec, PlaneSpec, ShardCache,
                              SimulatedMonitor, StoreRegistry, StoreSpec,
                              validate_sample)
from repro_torch.core.plane import FaultEvent, FaultLog
from repro_torch.fleet import FleetPlane, FleetSpec, TenantSpec
from repro_torch.lab import retune_online
from repro_torch.launch import chaos_drill
from repro_torch.runtime import (ACTUATION_KINDS, ChaosError, ChaosSpec,
                                 FAULT_KINDS, FaultSpec, HeartbeatMonitor,
                                 TELEMETRY_KINDS, inject)
import torch

# One intra-op thread: the suite's workers share the cores, and torch's
# OpenMP threads, oversubscribed, spin-wait ~100x longer than the ops.
torch.set_num_threads(1)

CPU = "cpu"
M = 125.0 * GiB
BACKENDS = ("scalar", "array")
REPO = pathlib.Path(__file__).resolve().parents[1]


def _params(**kw):
    kw.setdefault("total_memory", M)
    kw.setdefault("u_max", 60.0 * GiB)
    kw.setdefault("u_min", 5.0 * GiB)
    return ControllerParams(**kw)


def _plane(backend, n_nodes=4, policy=None, usage=None, pkg=None,
           **spec_kw):
    """A plane of the port (or, with ``pkg=JC``, of the JAX package)."""
    c = pkg or types.SimpleNamespace(
        ControllerParams=ControllerParams, MemoryPlane=MemoryPlane,
        PlaneSpec=PlaneSpec, HealthPolicy=HealthPolicy, NodeSpec=NodeSpec,
        SimulatedMonitor=SimulatedMonitor, StoreRegistry=StoreRegistry)
    params = c.ControllerParams(total_memory=M, u_max=60.0 * GiB,
                                u_min=5.0 * GiB)
    usage = usage or (lambda k: 80.0 * GiB)
    if pkg is None:
        spec_kw.setdefault("device", CPU)
    plane = c.MemoryPlane(c.PlaneSpec(
        params=params, backend=backend,
        health=policy or c.HealthPolicy(stale_budget=2, rejoin_intervals=3),
        nodes=tuple(
            c.NodeSpec(f"n{i}",
                       monitor=c.SimulatedMonitor(f"n{i}", total=M,
                                                  usage=usage),
                       registry=c.StoreRegistry(), u0=30.0 * GiB)
            for i in range(n_nodes)),
        **spec_kw))
    return plane, params


# ---------------------------------------------------------------------------
# Spec validation + deterministic scheduling
# ---------------------------------------------------------------------------

def test_fault_spec_validation():
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultSpec("gremlin")
    with pytest.raises(ValueError):
        FaultSpec("nan", start=-1)
    with pytest.raises(ValueError):
        FaultSpec("nan", duration=0)
    with pytest.raises(ValueError):
        FaultSpec("nan", probability=0.0)
    with pytest.raises(ValueError):
        FaultSpec("nan", probability=1.5)
    with pytest.raises(TypeError):
        ChaosSpec(faults=("nan",))
    f = FaultSpec("slow-sample", nodes=["a", "b"])
    assert f.nodes == ("a", "b")
    assert f.effective_magnitude() > 0.0


def test_catalog_equals_jax():
    assert FAULT_KINDS == JR.FAULT_KINDS and len(FAULT_KINDS) == 11
    assert TELEMETRY_KINDS == JR.TELEMETRY_KINDS
    assert ACTUATION_KINDS == JR.ACTUATION_KINDS
    for kind in FAULT_KINDS:
        assert FaultSpec(kind).effective_magnitude() == \
            JR.FaultSpec(kind).effective_magnitude()
    assert issubclass(ChaosError, MonitorFault)


def test_chaos_schedule_is_deterministic_and_windowed():
    spec = ChaosSpec(faults=(
        FaultSpec("nan", nodes=("n0",), start=5, duration=10,
                  probability=0.4),
    ), seed=7)
    fires = [spec.fires(0, "n0", t) for t in range(30)]
    assert fires == [spec.fires(0, "n0", t) for t in range(30)]
    assert not any(fires[:5]) and not any(fires[15:])
    assert any(fires[5:15])
    assert not spec.fires(0, "n1", 7)
    other = ChaosSpec(faults=spec.faults, seed=8)
    assert fires != [other.fires(0, "n0", t) for t in range(30)]


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_schedule_equals_jax_for_every_fault_node_and_tick(seed):
    """``fires`` is zlib- and numpy-seeded; the port's schedule is JAX's
    for every (fault, node, tick)."""
    kw = [dict(kind="nan", nodes=("n0", "n2"), start=3, duration=20,
               probability=0.3),
          dict(kind="crash", start=7, duration=None, probability=0.55),
          dict(kind="actuate-partial", nodes=("n1",), probability=1.0,
               magnitude=0.25),
          dict(kind="retune-kill", start=1, duration=40, probability=0.5)]
    ours = ChaosSpec(faults=tuple(FaultSpec(**k) for k in kw), seed=seed)
    ref = JR.ChaosSpec(faults=tuple(JR.FaultSpec(**k) for k in kw),
                       seed=seed)
    for i in range(len(kw)):
        for node in ("n0", "n1", "n2", "victim-n0", "retune"):
            assert [ours.fires(i, node, t) for t in range(60)] == \
                [ref.fires(i, node, t) for t in range(60)], (i, node)


def test_validate_sample_catches_garbage():
    good = MemorySample("n", 0.0, 10.0, 100.0)
    assert validate_sample(good) is None
    bad = [
        MemorySample("n", 0.0, float("nan"), 100.0),
        MemorySample("n", 0.0, float("inf"), 100.0),
        MemorySample("n", 0.0, -5.0, 100.0),
        MemorySample("n", 0.0, 10.0, 0.0),
        MemorySample("n", 0.0, 10.0, 100.0, storage_used=-1.0),
    ]
    assert all(validate_sample(s) is not None for s in bad)


def test_simulated_monitor_fault_modes_are_seeded():
    def make(seed):
        return SimulatedMonitor("n0", total=100.0,
                                usage=lambda i: 50.0 + i,
                                faults={"dropout": 0.3, "nan": 0.2},
                                fault_seed=seed)

    def run(mon, n=40):
        out = []
        for _ in range(n):
            try:
                u = mon.sample().used
                out.append("nan" if math.isnan(u) else u)
            except MonitorFault:
                out.append("drop")
        return out

    a, b = run(make(3)), run(make(3))
    assert a == b
    assert a != run(make(4))
    assert "drop" in a and "nan" in a
    with pytest.raises(ValueError, match="unknown fault kinds"):
        SimulatedMonitor("n", total=1.0, usage=lambda i: 1.0,
                         faults={"gremlin": 0.5})


def test_simulated_monitor_freeze_returns_last_good():
    mon = SimulatedMonitor("n0", total=100.0, usage=lambda i: float(i),
                           faults={"freeze": 1.0}, fault_seed=0)
    first = mon.sample()
    frozen = [mon.sample() for _ in range(3)]
    assert all(s.used == first.used for s in frozen)


# ---------------------------------------------------------------------------
# The health state machine under injected faults (both backends)
# ---------------------------------------------------------------------------

CATALOG = (
    dict(kind="dropout", nodes=("n0",), start=3, duration=10,
         probability=0.5),
    dict(kind="freeze", nodes=("n1",), start=3, duration=8),
    dict(kind="nan", nodes=("n2",), start=3, duration=8),
    dict(kind="negative", nodes=("n2",), start=11, duration=4),
    dict(kind="crash", nodes=("n3",), start=5, duration=15),
    dict(kind="actuate-raise", nodes=("n4",), start=3, duration=8),
    dict(kind="actuate-partial", nodes=("n4",), start=12, duration=4),
)


@pytest.mark.parametrize("backend", BACKENDS)
def test_invariants_hold_under_full_catalog(backend):
    plane, params = _plane(backend, n_nodes=5)
    spec = ChaosSpec(faults=tuple(FaultSpec(**f) for f in CATALOG), seed=1)
    audit = []
    with inject(plane, spec) as chaos:
        for _ in range(30):
            audit.extend(plane.tick())
    for _ in range(30):
        audit.extend(plane.tick())
    assert chaos.counts()
    for a in audit:
        assert math.isfinite(a.u_next) and math.isfinite(a.u_prev)
        assert a.u_next <= params.u_max + 1.0
        assert a.u_next >= params.u_min - 1.0
        assert a.u_next <= M
    for i in range(5):
        epochs = [a.epoch for a in audit if a.node == f"n{i}"]
        assert all(y >= x for x, y in zip(epochs, epochs[1:]))
    report = plane.health()
    assert not report.degraded(), report.summary()
    assert report.fault_counts.get("quarantine", 0) >= 1
    assert report.fault_counts.get("rejoin", 0) >= 1


def _log(events):
    return [(e.kind, e.node, e.tick) for e in events]


@pytest.mark.parametrize("backend", BACKENDS)
def test_full_catalog_equals_jax(backend):
    """One ChaosSpec, a JAX plane and the port's: the same delivered
    faults, the same fault log, the same actions."""
    ours, _ = _plane(backend, n_nodes=5)
    ref, _ = _plane(backend, n_nodes=5, pkg=JC)
    faults = CATALOG + (dict(kind="inf", nodes=("n1",), start=14,
                             duration=3),
                        dict(kind="actuate-timeout", nodes=("n0",),
                             start=20, duration=2, magnitude=0.0),
                        dict(kind="slow-sample", nodes=("n3",), start=22,
                             duration=2, magnitude=0.001))
    got_acts, want_acts = [], []
    with inject(ours, ChaosSpec(faults=tuple(FaultSpec(**f)
                                             for f in faults), seed=1)) \
            as got, \
            JR.inject(ref, JR.ChaosSpec(faults=tuple(
                JR.FaultSpec(**f) for f in faults), seed=1)) as want:
        for _ in range(30):
            got_acts += ours.tick()
            want_acts += ref.tick()
    for _ in range(10):
        got_acts += ours.tick()
        want_acts += ref.tick()
    assert _log(got.events()) == _log(want.events())
    assert got.counts() == want.counts() and len(got.counts()) == 10
    assert _log(ours.fault_log.snapshot()) == _log(ref.fault_log.snapshot())
    assert ours.health().fault_counts == ref.health().fault_counts
    assert [(a.node, a.u_next, a.epoch) for a in got_acts] == \
        [(a.node, a.u_next, a.epoch) for a in want_acts]


@pytest.mark.parametrize("backend", BACKENDS)
def test_quarantine_entry_and_rejoin_are_bounded(backend):
    policy = HealthPolicy(stale_budget=3, rejoin_intervals=4)
    plane, _ = _plane(backend, n_nodes=2, policy=policy)
    for _ in range(5):
        plane.tick()
    crash = ChaosSpec(faults=(FaultSpec("crash", nodes=("n0",)),), seed=0)
    handle = inject(plane, crash)
    states = []
    for _ in range(10):
        plane.tick()
        states.append(plane.health().nodes["n0"].state)
    assert states[policy.stale_budget - 2] is not NodeHealth.QUARANTINED
    assert states[policy.stale_budget - 1] is NodeHealth.QUARANTINED
    assert states[-1] is NodeHealth.QUARANTINED
    handle.revert()
    rejoin_at = None
    for t in range(policy.rejoin_intervals + 3):
        plane.tick()
        if plane.health().nodes["n0"].state is NodeHealth.HEALTHY:
            rejoin_at = t
            break
    assert rejoin_at is not None, "node never rejoined after chaos lifted"
    assert rejoin_at + 1 >= policy.rejoin_intervals


@pytest.mark.parametrize("backend", BACKENDS)
def test_quarantined_node_is_pinned_fail_static(backend):
    policy = HealthPolicy(stale_budget=2, rejoin_intervals=3)
    cache = ShardCache(capacity=30.0 * GiB)
    params = _params()
    plane = MemoryPlane(PlaneSpec(
        params=params, backend=backend, health=policy, device=CPU,
        nodes=(NodeSpec(
            "n0",
            monitor=SimulatedMonitor("n0", total=M,
                                     usage=lambda k: 80.0 * GiB,
                                     storage_used_fn=cache.used),
            stores=(StoreSpec(cache, max_bytes=60.0 * GiB),),
            u0=30.0 * GiB),)))
    for _ in range(3):
        plane.tick()
    with inject(plane, ChaosSpec(
            faults=(FaultSpec("dropout", nodes=("n0",)),), seed=0)):
        for _ in range(policy.stale_budget + 4):
            acted = plane.tick()
        info = plane.health().nodes["n0"]
        assert info.state is NodeHealth.QUARANTINED
        assert info.pin_grant == policy.fail_static_grant(
            params.u_min, params.u_max) == params.u_min
        assert cache.capacity() == pytest.approx(info.pin_grant)
        assert acted == []


@pytest.mark.parametrize("backend", BACKENDS)
def test_nan_telemetry_never_reaches_the_law(backend):
    plane, params = _plane(backend, n_nodes=1)
    for _ in range(3):
        plane.tick()
    u_before = plane.capacity("n0")
    with inject(plane, ChaosSpec(
            faults=(FaultSpec("nan", nodes=("n0",), duration=2),), seed=0)):
        acts = plane.tick() + plane.tick()
    assert acts, "stale holdover should keep the law running"
    for a in acts:
        assert math.isfinite(a.u_next)
        assert params.u_min <= a.u_next <= params.u_max
    assert math.isfinite(plane.capacity("n0"))
    assert plane.health().fault_counts["telemetry-invalid"] == 2
    assert u_before == pytest.approx(plane.capacity("n0"), rel=0.5)


def test_actuation_retry_backoff_and_recovery():
    policy = HealthPolicy(actuation_retries=2, retry_backoff_cap=4)
    plane, _ = _plane("scalar", n_nodes=1, policy=policy)
    for _ in range(2):
        plane.tick()
    with inject(plane, ChaosSpec(
            faults=(FaultSpec("actuate-raise", nodes=("n0",),
                              duration=6),), seed=0)):
        for _ in range(6):
            plane.tick()
        info = plane.health().nodes["n0"]
        assert info.actuation_degraded
        assert info.actuation_failures >= policy.actuation_retries
        counts = plane.fault_log.counts()
        assert counts["actuation-error"] < 6
        assert counts.get("actuation-degraded", 0) == 1
    for _ in range(2 * policy.retry_backoff_cap + 2):
        plane.tick()
    info = plane.health().nodes["n0"]
    assert not info.actuation_degraded and info.actuation_failures == 0
    assert plane.fault_log.counts().get("actuation-recovered", 0) == 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_chaos_revert_restores_the_plane(backend):
    """Every wiring path -- the plane's lock, its monitors, each
    shield's inner registry, ``capture`` and ``tick`` -- is installed
    and restored."""
    plane, _ = _plane(backend, n_nodes=2, record=8)
    plane.tick()                             # a last-good sample each
    mon0 = plane._monitors["n0"]
    inner0 = plane._registries["n0"]._inner
    tick0 = plane.tick
    capture0 = plane.capture
    handle = inject(plane, ChaosSpec(
        faults=(FaultSpec("crash",), FaultSpec("retune-kill")), seed=0))
    assert plane._monitors["n0"] is not mon0
    assert plane._registries["n0"]._inner is not inner0
    assert plane.capture is not capture0
    plane.tick()
    with pytest.raises(ChaosError, match="retune kill"):
        plane.capture()
    assert handle.counts()["retune-kill"] == 1
    assert handle.counts()["crash"] >= 2          # both monitors
    handle.revert()
    handle.revert()                          # idempotent
    assert plane._monitors["n0"] is mon0
    assert plane._registries["n0"]._inner is inner0
    assert plane.tick == tick0
    assert plane.capture == capture0
    assert plane.tick()


def test_fault_log_is_bounded():
    log = FaultLog(maxlen=4)
    for i in range(10):
        log.append(FaultEvent(kind="k", node="n", tick=i, timestamp=0.0))
    assert len(log) == 4
    assert [e.tick for e in log.snapshot()] == [6, 7, 8, 9]
    assert log.counts() == {"k": 10}


def test_tick_deadline_watchdog():
    policy = HealthPolicy(tick_deadline_s=1e-9)
    plane, _ = _plane("scalar", n_nodes=1, policy=policy)
    plane.tick()
    report = plane.health()
    assert report.deadline_misses == 1
    assert report.fault_counts.get("tick-deadline", 0) == 1


# ---------------------------------------------------------------------------
# Retune supervision
# ---------------------------------------------------------------------------

def _recording_plane(ticks=30):
    plane, _ = _plane(
        "array", n_nodes=3, record=ticks,
        usage=lambda k: (60.0 + 30.0 * math.sin(0.3 * k)) * GiB)
    for _ in range(ticks):
        plane.tick()
    return plane


def test_retune_supervisor_restarts_after_kill():
    plane = _recording_plane()
    real_capture = plane.capture
    boom = [2]

    def flaky_capture(*a, **kw):
        if boom[0] > 0:
            boom[0] -= 1
            raise ChaosError("injected retune kill")
        return real_capture(*a, **kw)

    plane.capture = flaky_capture
    handle = retune_online(plane, method="random", budget=4, seed=0,
                           block=False, swap=False, restarts=4,
                           restart_backoff_s=0.01, device=CPU)
    result = handle.result(timeout=300)
    assert handle.attempts == 3 and handle.restarts == 2
    assert result.tune.score >= result.tune.baseline_score
    counts = plane.fault_log.counts()
    assert counts.get("retune-restart", 0) == 2
    assert "retune-dead" not in counts


def test_retune_kill_through_the_harness():
    """``retune-kill`` wired by ``inject``: the supervised round dies
    while the kill window is open and lands once it has closed."""
    plane = _recording_plane()
    with inject(plane, ChaosSpec(faults=(
            FaultSpec("retune-kill", start=0, duration=3),), seed=0)) \
            as chaos:
        plane.tick()                         # the clock reads tick 0
        handle = retune_online(plane, method="random", budget=4, seed=0,
                               block=False, swap=False, restarts=6,
                               restart_backoff_s=0.01, device=CPU)
        deadline = time.monotonic() + 60.0
        while (not plane.fault_log.counts().get("retune-restart")
               and time.monotonic() < deadline):
            time.sleep(0.002)                # the clock holds at tick 0
        for _ in range(3):
            plane.tick()                     # the window closes
        handle.result(timeout=60)
    assert handle.restarts >= 1
    assert chaos.counts()["retune-kill"] == handle.restarts
    assert plane.fault_log.counts()["retune-restart"] == handle.restarts


def test_retune_supervisor_gives_up_and_reports_dead():
    plane = _recording_plane(ticks=10)
    plane.capture = lambda *a, **kw: (_ for _ in ()).throw(
        ChaosError("wedged"))
    handle = retune_online(plane, block=False, restarts=2,
                           restart_backoff_s=0.01, device=CPU)
    with pytest.raises(ChaosError):
        handle.result(timeout=60)
    assert handle.attempts == 3 and handle.restarts == 2
    assert plane.fault_log.counts().get("retune-dead", 0) == 1


def test_retune_unsupervised_keeps_legacy_eager_capture():
    plane, _ = _plane("scalar", n_nodes=1)
    with pytest.raises(ValueError, match="not recording"):
        retune_online(plane, block=False, device=CPU)


# ---------------------------------------------------------------------------
# FleetPlane: quarantined tenants and rollback
# ---------------------------------------------------------------------------

def _fleet(n_nodes=2, epoch_intervals=3, backend="array", pkg=None):
    """The two-tenant chaos fleet, of the port or (``pkg``) of JAX."""
    if pkg is None:
        c = types.SimpleNamespace(
            ControllerParams=ControllerParams, HealthPolicy=HealthPolicy,
            NodeSpec=NodeSpec, SimulatedMonitor=SimulatedMonitor,
            PlaneSpec=PlaneSpec, TenantSpec=TenantSpec,
            FleetSpec=FleetSpec, FleetPlane=FleetPlane)
        dev = dict(device=CPU)
    else:
        c = types.SimpleNamespace(
            ControllerParams=JC.ControllerParams,
            HealthPolicy=JC.HealthPolicy, NodeSpec=JC.NodeSpec,
            SimulatedMonitor=JC.SimulatedMonitor, PlaneSpec=JC.PlaneSpec,
            TenantSpec=JF.TenantSpec, FleetSpec=JF.FleetSpec,
            FleetPlane=JF.FleetPlane)
        dev = {}
    params = c.ControllerParams(total_memory=M, u_max=60.0 * GiB,
                                u_min=5.0 * GiB, interval_s=0.01)
    policy = c.HealthPolicy(stale_budget=2, rejoin_intervals=2)

    def tenant(name, usage_gib, **kw):
        nodes = tuple(
            c.NodeSpec(f"{name}-n{i}", monitor=c.SimulatedMonitor(
                f"{name}-n{i}", total=M,
                usage=lambda t, g=usage_gib: g * GiB))
            for i in range(n_nodes))
        return c.TenantSpec(name, c.PlaneSpec(params=params, nodes=nodes,
                                              health=policy,
                                              backend=backend, **dev), **kw)

    return c.FleetPlane(c.FleetSpec(tenants=(
        tenant("victim", 40.0, weight=2.0, floor_gib=8.0),
        tenant("bystander", 30.0, weight=1.0, floor_gib=8.0),
    ), epoch_intervals=epoch_intervals))


@pytest.mark.parametrize("backend", BACKENDS)
def test_fleet_quarantined_tenant_gets_floor_and_rejoins(backend):
    fleet = _fleet(backend=backend)
    floor = 8.0 * GiB
    with fleet:
        for _ in range(6):
            fleet.tick()
        pre = fleet.budgets()
        assert pre["victim"] > floor * 1.5
        handle = inject(fleet.plane("victim"), ChaosSpec(
            faults=(FaultSpec("crash", nodes=("victim-n0",
                                              "victim-n1")),), seed=0))
        floored = False
        for _ in range(12):
            fleet.tick()
            b = fleet.budgets()
            assert sum(b.values()) <= M + 1.0
            if ("victim" in fleet.quarantined_tenants()
                    and b["victim"] <= floor + 1.0):
                floored = True
        assert floored, "dark tenant never squeezed to its floor"
        assert fleet.budgets()["bystander"] > floor
        vic = fleet._tenants["victim"]
        assert vic.last_telemetry is not None
        assert vic.last_telemetry.usage_bytes > 0.0
        handle.revert()
        for _ in range(14):
            fleet.tick()
            assert sum(fleet.budgets().values()) <= M + 1.0
        assert fleet.quarantined_tenants() == []
        assert fleet.budgets()["victim"] > floor * 1.5
        counts = fleet.fault_log.counts()
        assert counts.get("tenant-quarantine", 0) >= 1
        assert counts.get("tenant-rejoin", 0) >= 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_fleet_chaos_equals_jax(backend):
    """The same crash injected into the whole fleet (every tenant's
    nested plane wired, the fleet tick driving the clock): the same
    delivered faults, fleet and tenant fault logs and health counts, and
    the same budgets every tick, bit for bit."""
    ours, ref = _fleet(backend=backend), _fleet(backend=backend, pkg=JF)
    faults = (dict(kind="crash", nodes=("victim-n0", "victim-n1"), start=6,
                   duration=12),
              dict(kind="nan", nodes=("bystander-n1",), start=4,
                   duration=6, probability=0.5))
    with ours, ref:
        with inject(ours, ChaosSpec(faults=tuple(
                FaultSpec(**f) for f in faults), seed=3)) as got, \
                JR.inject(ref, JR.ChaosSpec(faults=tuple(
                    JR.FaultSpec(**f) for f in faults), seed=3)) as want:
            for tick in range(30):
                ours.tick()
                ref.tick()
                assert ours.budgets() == ref.budgets(), tick
                assert ours.quarantined_tenants() == \
                    ref.quarantined_tenants(), tick
        assert _log(got.events()) == _log(want.events())
        assert got.counts() == want.counts()
        assert _log(ours.fault_log.snapshot()) == \
            _log(ref.fault_log.snapshot())
        for name in ("victim", "bystander"):
            assert ours.plane(name).health().fault_counts == \
                ref.plane(name).health().fault_counts, name
        assert "tenant-quarantine" in ours.fault_log.counts()


def test_fleet_rebalance_rolls_back_on_partial_swap_failure():
    fleet = _fleet()
    with fleet:
        for _ in range(6):
            fleet.tick()
        before = fleet.budgets()
        grant_before = fleet.last_grant()
        bystander = fleet._tenants["bystander"].plane
        real_swap = bystander.swap_params
        bystander.swap_params = lambda *a, **kw: (_ for _ in ()).throw(
            RuntimeError("wedged swap"))
        telemetry = fleet._snapshot_telemetry()
        grant = fleet.rebalance(telemetry)
        after = fleet.budgets()
        assert after == before
        assert sum(after.values()) <= M + 1.0
        assert fleet.last_grant() == grant_before
        assert grant == grant_before
        assert fleet.fault_log.counts().get("rebalance-rollback", 0) == 1
        bystander.swap_params = real_swap
        fleet.tick()


# ---------------------------------------------------------------------------
# The drill, against JAX's
# ---------------------------------------------------------------------------

def _jax_drill():
    path = REPO / "examples" / "chaos_drill.py"
    spec = importlib.util.spec_from_file_location("jax_chaos_drill", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_drill_delivers_jax_fault_counts():
    """``--smoke``: both drills pass their gates, and every fault kind
    but the clock-dependent ``retune-kill`` is delivered as often."""
    args = types.SimpleNamespace(smoke=True, seed=0, device=CPU)
    jax_drill = _jax_drill()
    failures, ref_failures = [], []
    plane, chaos, counts = chaos_drill.phase_memory_plane(args, failures)
    ref_plane, ref_chaos, ref_counts = jax_drill.phase_memory_plane(
        args, ref_failures)
    fleet, fleet_counts = chaos_drill.phase_fleet_plane(args, failures)
    ref_fleet, ref_fleet_counts = jax_drill.phase_fleet_plane(
        args, ref_failures)
    assert failures == [] and ref_failures == []

    def steady(c):
        return {k: v for k, v in c.items() if not k.startswith("retune")}

    assert steady(chaos.counts()) == steady(ref_chaos.counts())
    assert chaos.counts()["retune-kill"] >= 1
    assert steady(counts) == steady(ref_counts)
    assert fleet_counts == ref_fleet_counts
    assert fleet.budgets() == ref_fleet.budgets()


# ---------------------------------------------------------------------------
# HeartbeatMonitor race hardening
# ---------------------------------------------------------------------------

def test_heartbeat_callbacks_fire_outside_the_lock():
    hb = HeartbeatMonitor(interval_s=0.01, timeout_intervals=1)
    hb.register("w0")
    seen = []
    hb.on_failure(lambda w: seen.append(("fail", w, hb.failed_workers())))
    hb.on_recovery(lambda w: seen.append(("rec", w, hb.healthy_workers())))
    assert hb.check(now=time.monotonic() + 1.0) == ["w0"]
    hb.heartbeat("w0")
    assert ("fail", "w0", ["w0"]) in seen
    assert ("rec", "w0", ["w0"]) in seen


def test_heartbeat_concurrent_registration_and_check():
    hb = HeartbeatMonitor(interval_s=0.001, timeout_intervals=1)
    for i in range(16):
        hb.register(f"w{i}")
    errors = []
    stop = threading.Event()

    def churn():
        try:
            while not stop.is_set():
                hb.on_failure(lambda w: None)
                hb.on_recovery(lambda w: None)
                hb.heartbeat("w0")
        except Exception as exc:                     # pragma: no cover
            errors.append(exc)

    threads = [threading.Thread(target=churn) for _ in range(4)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 0.5
    try:
        while time.monotonic() < deadline:
            hb.check(now=time.monotonic() + 1.0)
            for i in range(16):
                hb.heartbeat(f"w{i}")
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert not errors
    assert set(hb.healthy_workers()) == {f"w{i}" for i in range(16)}
