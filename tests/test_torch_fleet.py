"""The port's FleetPlane against the JAX package's, on the CPU.

Mirrors ``tests/test_fleet.py`` case for case (the 2-D device mesh and
the single-device fallback are in ``tests/test_torch_mesh.py``), each
on the port, and holds the port to JAX with twins built from the same
literals:

* ``arbitrate`` equals ``jax.jit(arbitrate)`` bit for bit under every
  policy at K in {2, 3, 8}, with and without a gain axis, and the numpy
  oracle equals JAX's bit for bit;
* ``FleetArbiter`` grants and live ``FleetPlane`` budgets (both plane
  backends) equal JAX's bit for bit, every epoch, and so do the
  tenants' actions;
* ``fleet_sweep_demand``'s carry -- every streamed accumulator, the p99
  and the slack minima -- equals the JAX XLA engine's bit for bit (the
  JAX finalize is intercepted to read its raw accumulators), and its
  stats are within the ROADMAP brackets (``stats_mismatches``:
  ``FleetStats`` at 1e-4, p99 at 5e-4, the rates at 1/(T*N)), its
  ``FleetExtras`` within rtol 2e-4 / atol 1e-3, under every policy on
  ``_small_problem`` and ``tenant-churn``.

The port runs with ``device="cpu"``.
"""

import dataclasses
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fleet as J
import repro.fleet.sweep as jsweep
import repro_torch.fleet.sweep as tsweep
from repro.core import plane as jplane
from repro.core.cluster_sim import paper_controller_params as jax_params
from repro.core.monitor import SimulatedMonitor as JSimulatedMonitor
from repro.lab import grid_gains as jax_grid_gains
from repro_torch.core.cluster_sim import paper_controller_params
from repro_torch.core.control import ControllerParams
from repro_torch.core.monitor import SimulatedMonitor
from repro_torch.core.plane import NodeSpec, PlaneSpec
from repro_torch.core.traces import GiB
from repro_torch.fleet import (FleetArbiter, FleetExtras, FleetPlane,
                               FleetScenario, FleetSpec, FleetTenant,
                               MIN_TENANT_BUDGET, POLICIES, TenantMonitor,
                               TenantSpec, TenantTelemetry, arbitrate,
                               arbitrate_reference, fleet_reference,
                               fleet_sweep_demand, get_fleet_scenario,
                               list_fleet_scenarios, run_fleet_sweep)
from repro_torch.lab import FleetStats, get_scenario, grid_gains
from repro_torch.lab.score import stats_mismatches
from repro_torch.lab.sweep import GainSet
from repro_torch.runtime.churn import FAILED_DEMAND, churn_demand

# One intra-op thread: the suite's workers share the cores, and torch's
# OpenMP threads, oversubscribed, spin-wait ~100x longer than the ops.
torch.set_num_threads(1)

CPU = "cpu"
M = 125.0 * GiB


def _params(**kw):
    kw.setdefault("total_memory", M)
    kw.setdefault("u_max", 60.0 * GiB)
    kw.setdefault("interval_s", 0.01)
    return ControllerParams(**kw)


def _tenant_spec(name, usage_gib, n_nodes=2, backend="array", **kw):
    nodes = tuple(
        NodeSpec(f"{name}-n{i}", monitor=SimulatedMonitor(
            f"{name}-n{i}", total=M, usage=lambda t, g=usage_gib: g * GiB))
        for i in range(n_nodes))
    return TenantSpec(name, PlaneSpec(params=_params(), nodes=nodes,
                                      backend=backend, device=CPU), **kw)


THREE = (("heavy", 45.0, dict(weight=3.0, priority=2, floor_gib=10.0)),
         ("steady", 25.0, dict(weight=1.5, priority=1, floor_gib=8.0)),
         ("light", 8.0, dict(weight=1.0, priority=0)))


def _three_tenants(backend="array", **fleet_kw):
    return FleetSpec(
        tenants=tuple(_tenant_spec(n, g, backend=backend, **kw)
                      for n, g, kw in THREE), **fleet_kw)


def _jax_three_tenants(backend="array", **fleet_kw):
    """The same fleet declared with the JAX package's classes."""
    from repro.core.control import ControllerParams as JParams
    tenants = []
    for name, g, kw in THREE:
        nodes = tuple(
            jplane.NodeSpec(f"{name}-n{i}", monitor=JSimulatedMonitor(
                f"{name}-n{i}", total=M,
                usage=lambda t, g=g: g * GiB))
            for i in range(2))
        tenants.append(J.TenantSpec(name, jplane.PlaneSpec(
            params=JParams(total_memory=M, u_max=60.0 * GiB,
                           interval_s=0.01), nodes=nodes, backend=backend),
            **kw))
    return J.FleetSpec(tenants=tuple(tenants), **fleet_kw)


def _port_gains(jg):
    return GainSet(*(getattr(jg, f.name) for f in dataclasses.fields(jg)))


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def test_spec_validation():
    plane = _tenant_spec("a", 10.0).plane
    with pytest.raises(ValueError):
        TenantSpec("", plane)
    with pytest.raises(ValueError):
        TenantSpec("a", plane, weight=0.0)
    with pytest.raises(ValueError):
        TenantSpec("a", plane, floor_gib=-1.0)
    with pytest.raises(ValueError):
        FleetSpec(tenants=())
    with pytest.raises(ValueError):                      # duplicate names
        FleetSpec(tenants=(TenantSpec("a", plane), TenantSpec("a", plane)))
    with pytest.raises(ValueError):
        FleetSpec(tenants=(TenantSpec("a", plane),), policy="lottery")
    with pytest.raises(ValueError):                      # floors > memory
        FleetSpec(tenants=(TenantSpec("a", plane, floor_gib=100.0),
                           TenantSpec("b", plane, floor_gib=50.0)),
                  fleet_memory_gib=125.0)
    spec = _three_tenants()
    assert spec.names == ("heavy", "steady", "light")
    assert spec.priority_order() == (0, 1, 2)
    assert len(spec) == 3
    flat = spec.replace(tenants=tuple(
        t.replace(priority=0) for t in spec.tenants))
    assert flat.priority_order() == (0, 1, 2)


def test_specs_derive_as_jax_does():
    spec, ref = _three_tenants(), _jax_three_tenants()
    assert spec.names == ref.names
    assert spec.priority_order() == ref.priority_order()
    assert spec.index() == ref.index()
    assert spec.weights().tobytes() == ref.weights().tobytes()
    assert spec.floors_bytes().tobytes() == ref.floors_bytes().tobytes()
    assert spec.fleet_memory_bytes == ref.fleet_memory_bytes


def test_nested_plane_rejects_per_node_params():
    base = _tenant_spec("a", 10.0)
    pinned = base.plane.nodes[0].replace(
        params=_params(total_memory=64 * GiB))
    bad = base.replace(plane=base.plane.replace(
        nodes=(pinned,) + base.plane.nodes[1:]))
    with pytest.raises(ValueError, match="per-node params"):
        FleetPlane(FleetSpec(tenants=(bad,)))


# ---------------------------------------------------------------------------
# Arbiter policies: invariants, the oracle, and bit parity with JAX
# ---------------------------------------------------------------------------

def _random_problem(rng, k=4, n=6):
    desired = rng.uniform(0.0, 80.0, (k, n)) * GiB
    m = rng.uniform(64.0, 160.0, n) * GiB
    weights = rng.uniform(0.5, 4.0, k)
    floors = rng.uniform(0.0, 12.0, k) * GiB
    return desired, m, weights, floors


@pytest.mark.parametrize("policy", POLICIES)
def test_arbitrate_reference_invariants(policy):
    rng = np.random.default_rng(7)
    for trial in range(20):
        desired, m, weights, floors = _random_problem(rng)
        k = desired.shape[0]
        alloc = arbitrate_reference(
            desired, m, weights=weights, floors=floors,
            priority_order=tuple(range(k)), policy=policy,
            rr_offset=trial % k)
        assert (alloc >= 0).all()
        assert (alloc.sum(0) <= m * (1 + 1e-9)).all(), trial
        f = np.maximum(floors[:, None], MIN_TENANT_BUDGET)
        f_eff = f * np.minimum(1.0, m / np.maximum(f.sum(0), 1.0))
        assert (alloc >= f_eff * (1 - 1e-9)).all(), trial
        assert (alloc <= np.maximum(desired, f_eff) + 1.0).all(), trial


@pytest.mark.parametrize("policy", POLICIES)
def test_arbitrate_reference_equals_jax(policy):
    """The float64 oracle is a copy: JAX's, bit for bit."""
    rng = np.random.default_rng(11)
    for trial in range(10):
        desired, m, weights, floors = _random_problem(rng, k=5, n=7)
        kw = dict(weights=weights, floors=floors,
                  priority_order=tuple(rng.permutation(5)), policy=policy,
                  rr_offset=trial)
        assert arbitrate_reference(desired, m, **kw).tobytes() == \
            J.arbitrate_reference(desired, m, **kw).tobytes()


@pytest.mark.parametrize("policy", POLICIES)
def test_arbitrate_matches_reference(policy):
    rng = np.random.default_rng(3)
    for trial in range(5):
        desired, m, weights, floors = _random_problem(rng, k=5, n=4)
        k = desired.shape[0]
        order = tuple(rng.permutation(k))
        kw = dict(weights=weights, floors=floors, priority_order=order,
                  policy=policy, rr_offset=trial)
        ref = arbitrate_reference(desired, m, **kw)
        got = arbitrate(torch.from_numpy(desired.astype(np.float32)),
                        torch.from_numpy(m.astype(np.float32)), **kw)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1024.0)


def _jax_arbitrate(policy, order, scaled=False):
    """``arbitrate`` jitted with its operands traced, as the JAX fleet
    sweep compiles it (constant floors would fold their division)."""
    def fn(d, c, m, w, fl, off):
        return J.arbitrate(d * c if scaled else d, m, weights=w, floors=fl,
                           priority_order=order, policy=policy,
                           rr_offset=off)
    return jax.jit(fn)


@pytest.mark.parametrize("k", [2, 3, 8])
@pytest.mark.parametrize("policy", POLICIES)
def test_arbitrate_is_jax_bit_for_bit(policy, k):
    """Undersized nodes (scaled floors) included, so the effective
    floors' contracted reduction is exercised; a gain axis arbitrates
    every lane at once."""
    rng = np.random.default_rng(100 + k)
    for trial in range(6):
        n = 512
        desired = (rng.uniform(0.0, 80.0, (3, k, n)) * GiB).astype(
            np.float32)
        m = (rng.uniform(4.0 if trial % 2 else 64.0, 160.0, n)
             * GiB).astype(np.float32)
        w = rng.uniform(0.5, 4.0, k).astype(np.float32)
        fl = (rng.uniform(0.0, 36.0, k) * GiB).astype(np.float32)
        order = tuple(int(i) for i in rng.permutation(k))
        off = trial % k - (trial == 0)                     # -1 included
        ref = np.asarray(jax.vmap(
            lambda d: _jax_arbitrate(policy, order)(d, 1.0, m, w, fl, off))(
                desired))
        got = arbitrate(torch.from_numpy(desired), torch.from_numpy(m),
                        weights=w, floors=fl, priority_order=order,
                        policy=policy, rr_offset=off)
        assert got.shape == (3, k, n)
        assert np.array_equal(got.numpy(), ref), (trial, int(
            (got.numpy() != ref).sum()))


@pytest.mark.parametrize("policy", POLICIES)
def test_arbitrate_with_a_desire_scale_is_jax_bit_for_bit(policy):
    """``desired_scale``: the product fuses into each need as XLA fuses
    the sweep's ``usage * (1 / (E * r0))``."""
    rng = np.random.default_rng(5)
    k, n = 3, 4096
    usage = (rng.uniform(0.0, 2400.0, (k, n)) * GiB).astype(np.float32)
    c = np.float32(1.0 / 30) * (np.float32(1.0) / np.float32(0.93))
    m = np.full(n, M, np.float32)
    w = np.array([3.0, 1.5, 1.0], np.float32)
    fl = np.array([10.0, 8.0, 0.0], np.float32) * np.float32(GiB)
    ref = np.asarray(_jax_arbitrate(policy, (2, 0, 1), scaled=True)(
        usage, c, m, w, fl, 0))
    got = arbitrate(torch.from_numpy(usage), torch.from_numpy(m), weights=w,
                    floors=fl, priority_order=(2, 0, 1), policy=policy,
                    desired_scale=torch.tensor(c))
    assert np.array_equal(got.numpy(), ref)


def test_arbitrate_rejects_unknown_policy():
    with pytest.raises(ValueError, match="policy"):
        arbitrate(torch.zeros(2, 3), torch.ones(3), weights=np.ones(2),
                  floors=np.zeros(2), priority_order=(0, 1),
                  policy="lottery")


def test_priority_starves_only_without_floor():
    desired = np.full((3, 1), 80.0) * GiB
    m = np.array([100.0 * GiB])
    kw = dict(weights=np.ones(3), priority_order=(0, 1, 2),
              policy="priority")
    starved = arbitrate_reference(desired, m, floors=np.zeros(3), **kw)
    assert starved[0, 0] == pytest.approx(80.0 * GiB)
    assert starved[2, 0] <= MIN_TENANT_BUDGET
    floored = arbitrate_reference(desired, m,
                                  floors=np.array([0, 0, 15.0 * GiB]), **kw)
    assert floored[2, 0] >= 15.0 * GiB * (1 - 1e-9)


def test_round_robin_rotation_is_starvation_free():
    k = 3
    desired = np.full((k, 1), 90.0) * GiB
    m = np.array([100.0 * GiB])
    best = np.zeros(k)
    for off in range(k):
        alloc = arbitrate_reference(
            desired, m, weights=np.ones(k), floors=np.zeros(k),
            priority_order=tuple(range(k)), policy="round_robin",
            rr_offset=off)
        best = np.maximum(best, alloc[:, 0])
    assert (best >= 90.0 * GiB * (1 - 1e-9)).all()


def test_proportional_waterfill_redistributes():
    m = np.array([100.0 * GiB])
    alloc = arbitrate_reference(
        np.array([[10.0], [200.0], [200.0]]) * GiB, m,
        weights=np.array([2.0, 1.0, 1.0]), floors=np.zeros(3),
        priority_order=(0, 1, 2), policy="proportional")
    assert alloc[0, 0] == pytest.approx(10.0 * GiB)
    assert alloc[1, 0] == pytest.approx(45.0 * GiB, rel=1e-6)
    assert alloc[2, 0] == pytest.approx(45.0 * GiB, rel=1e-6)
    hungry = arbitrate_reference(
        np.full((2, 1), 500.0) * GiB, m,
        weights=np.array([3.0, 1.0]), floors=np.zeros(2),
        priority_order=(0, 1), policy="proportional")
    assert hungry[0, 0] / hungry[1, 0] == pytest.approx(3.0, rel=1e-4)


def test_fleet_arbiter_runtime():
    spec = _three_tenants(policy="round_robin")
    arb = FleetArbiter(spec)
    b0 = arb.initial_budgets(M)
    assert sum(b0.values()) == pytest.approx(M, rel=1e-9)
    assert b0["heavy"] > b0["light"]
    tele = {n: TenantTelemetry(usage_bytes=20.0 * GiB, budget_bytes=b)
            for n, b in b0.items()}
    g1 = arb.allocate(tele, M)
    g2 = arb.allocate(tele, M)
    assert (g1.epoch, g2.epoch) == (1, 2)
    assert arb.last_grant() is g2
    assert g2.total() <= M * (1 + 1e-9)
    g3 = arb.allocate({}, M)
    assert g3.budgets["light"] <= MIN_TENANT_BUDGET * (1 + 1e-9)
    t = TenantTelemetry(usage_bytes=30.0, budget_bytes=40.0, hit_ratio=0.5)
    assert t.pressure == pytest.approx(0.75)
    assert t.slack_bytes == pytest.approx(10.0)
    assert t.desired_bytes(r0=1.0) == pytest.approx(45.0)


@pytest.mark.parametrize("policy", POLICIES)
def test_fleet_arbiter_grants_equal_jax(policy):
    """The same telemetry sequence gives the same grants, bit for bit."""
    arb = FleetArbiter(_three_tenants(policy=policy))
    ref = J.FleetArbiter(_jax_three_tenants(policy=policy))
    assert arb.initial_budgets(M) == ref.initial_budgets(M)
    rng = np.random.default_rng(2)
    for epoch in range(12):
        tele = {n: (rng.uniform(1.0, 90.0) * GiB, rng.uniform(10.0, 80.0)
                    * GiB, rng.uniform(0.5, 1.0))
                for n in ("heavy", "steady", "light")
                if rng.random() > 0.15}
        got = arb.allocate({n: TenantTelemetry(*v) for n, v in tele.items()},
                           M)
        want = ref.allocate({n: J.TenantTelemetry(*v)
                             for n, v in tele.items()}, M)
        assert got.budgets == want.budgets and got.epoch == want.epoch


# ---------------------------------------------------------------------------
# Live FleetPlane
# ---------------------------------------------------------------------------

def test_fleet_plane_end_to_end():
    spec = _three_tenants(epoch_intervals=4)
    with FleetPlane(spec) as fp:
        for _ in range(20):
            actions = fp.tick()
            assert set(actions) == {"heavy", "steady", "light"}
            assert sum(fp.budgets().values()) <= M * (1 + 1e-9)
        assert fp.epoch == 5
        final = fp.budgets()
        assert final["heavy"] > final["steady"] > final["light"]
        mon = fp.plane("light").spec.nodes[0].monitor
        assert isinstance(mon, TenantMonitor)
        assert mon.sample().total == pytest.approx(final["light"])
        acts = fp.plane("heavy").tick()
        assert acts and acts[0].epoch == 5
        assert fp.last_grant().epoch == 5
        assert 0.0 < fp.fleet_utilization() < 1.0


@pytest.mark.parametrize("backend", ["array", "scalar"])
@pytest.mark.parametrize("policy", POLICIES)
def test_fleet_plane_equals_jax(backend, policy):
    """Budgets after every epoch, and every tenant action's capacities
    and epoch stamp, bit for bit the JAX FleetPlane's, under a demand
    that moves the grants."""
    def usage(t, base):
        return (base + 18.0 * np.sin(0.4 * t + base)) * GiB

    ours = FleetPlane(FleetSpec(tenants=tuple(
        t.replace(plane=t.plane.replace(nodes=tuple(
            ns.replace(monitor=SimulatedMonitor(
                ns.name, total=M, usage=lambda k, b=g: usage(k, b)))
            for ns in t.plane.nodes)))
        for t, (_, g, _) in zip(_three_tenants(backend).tenants, THREE)),
        policy=policy, epoch_intervals=3))
    ref_spec = _jax_three_tenants(backend, policy=policy, epoch_intervals=3)
    ref_spec = ref_spec.replace(tenants=tuple(
        t.replace(plane=t.plane.replace(nodes=tuple(
            ns.replace(monitor=JSimulatedMonitor(
                ns.name, total=M, usage=lambda k, b=g: usage(k, b)))
            for ns in t.plane.nodes)))
        for t, (_, g, _) in zip(ref_spec.tenants, THREE)))
    ref = J.FleetPlane(ref_spec)
    assert ours.budgets() == ref.budgets()
    with ours, ref:
        for tick in range(24):
            got, want = ours.tick(), ref.tick()
            for name in want:
                assert [(a.node, a.u_prev, a.u_next, a.epoch)
                        for a in got[name]] == \
                    [(a.node, a.u_prev, a.u_next, a.epoch)
                     for a in want[name]], (tick, name)
            assert ours.budgets() == ref.budgets(), tick
        assert ours.epoch == ref.epoch == 8
        assert ours.last_grant().budgets == ref.last_grant().budgets


def test_torn_budget_audit_under_concurrent_ticks():
    """The auditor spins on ``budgets()`` while the fleet ticks.  Every
    torch operation of a tick releases the GIL and waits the switch
    interval to take it back from the spinning auditor, so the interval
    is shortened (5 ms -> 0.1 ms): the same race, 50x the ticks per
    second."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        _torn_budget_audit()
    finally:
        sys.setswitchinterval(old)


def _torn_budget_audit():
    spec = _three_tenants(epoch_intervals=2)
    violations = []
    stop = threading.Event()

    def audit(fp):
        while not stop.is_set():
            total = sum(fp.budgets().values())
            if total > M * (1 + 1e-9):
                violations.append(total)

    with FleetPlane(spec) as fp:
        auditor = threading.Thread(target=audit, args=(fp,))
        auditor.start()
        try:
            for _ in range(30):
                actions = fp.tick()
                for name, acts in actions.items():
                    epochs = {a.epoch for a in acts}
                    assert len(epochs) <= 1, (name, epochs)
        finally:
            stop.set()
            auditor.join()
    assert not violations
    assert fp.epoch == 15


# ---------------------------------------------------------------------------
# The fleet sweep against JAX's XLA engine and the float64 oracle
# ---------------------------------------------------------------------------

def _small_problem(k=3, n=6, t=120, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(10.0, 45.0, (k, 1, 1))
    wave = 1.0 + 0.4 * np.sin(
        np.linspace(0, 6 * np.pi, t) + rng.uniform(0, np.pi, (k, n, 1)))
    demand = (base * wave * (0.9 + 0.2 * rng.random((k, n, 1)))) * GiB
    weights = np.array([3.0, 1.5, 1.0])[:k]
    floors = np.array([10.0, 8.0, 0.0])[:k] * GiB
    return demand.astype(np.float64), weights, floors


def _jax_gains(n=2, **axes):
    axes.setdefault("lam", np.linspace(0.3, 0.9, n))
    axes.setdefault("r0", np.linspace(0.9, 0.96, n))
    return jax_grid_gains(jax_params(), **axes)


def _gains(n=2):
    p = paper_controller_params()
    return grid_gains(p, lam=np.linspace(0.3, 0.9, n),
                      r0=np.linspace(0.9, 0.96, n))


# every knob of the law: asymmetric grant, deadband, feedforward
KNOBS = dict(lam=(0.5, 1.2), r0=(0.92, 0.95), lam_grant=(None, 0.3),
             deadband=(0.0, 0.01), feedforward=(0.0, 0.5))


def _check_against_jax(demand, jg, kw):
    stats, extras = fleet_sweep_demand(demand, _port_gains(jg), device=CPU,
                                       **kw)
    ref_stats, ref_extras = J.fleet_sweep_demand(demand, jg, **kw)
    n_samples = demand.shape[1] * demand.shape[2]
    assert stats_mismatches(FleetStats(*map(np.asarray, ref_stats)), stats,
                            n_samples=n_samples) == []
    for f in FleetExtras._fields:
        np.testing.assert_allclose(getattr(extras, f),
                                   np.asarray(getattr(ref_extras, f)),
                                   rtol=2e-4, atol=1e-3, err_msg=f)


@pytest.mark.parametrize("policy", POLICIES)
def test_fleet_sweep_matches_jax_small_problem(policy):
    demand, weights, floors = _small_problem()
    kw = dict(node_memory=M, weights=weights, floors=floors, policy=policy,
              priority_order=(2, 0, 1), epoch_intervals=30, interval_s=0.1)
    _check_against_jax(demand, _jax_gains(3), kw)
    _check_against_jax(demand, jax_grid_gains(jax_params(), **KNOBS), kw)


@pytest.mark.parametrize("policy", POLICIES)
def test_fleet_sweep_matches_jax_tenant_churn(policy):
    fs = get_fleet_scenario("tenant-churn")
    demand = fs.build_demand(seed=0)
    kw = dict(node_memory=fs.node_memory_gib * GiB, weights=fs.weights(),
              floors=fs.floors_bytes(), policy=policy,
              priority_order=fs.priority_order(),
              epoch_intervals=fs.epoch_intervals, interval_s=fs.interval_s)
    _check_against_jax(demand, _jax_gains(2), kw)


RAW = ("util_sum", "util_max", "caps_sum_gib", "caps_sumsq_gib",
       "over_r0_count", "violation_count", "last_bad", "p99_utilization")


def _jax_raw(monkeypatch, demand, jg, kw):
    """JAX's streamed accumulators, read by intercepting its finalize."""
    def raw(**acc):
        vals = [acc[name] for name in RAW]
        zeros = [jnp.zeros(())] * (len(FleetStats._fields) - len(RAW))
        return J.sweep.FleetStats(*vals, *zeros)

    jsweep._compiled_fleet_sweep.cache_clear()
    with monkeypatch.context() as mp:
        mp.setattr(jsweep, "finalize_fleet_stats", raw)
        stats, extras = J.fleet_sweep_demand(demand, jg, **kw)
    jsweep._compiled_fleet_sweep.cache_clear()
    return dict(zip(RAW, (np.asarray(s) for s in stats))), extras


def _port_raw(monkeypatch, demand, gains, kw):
    seen = []
    real = tsweep.finalize_fleet_stats

    def spy(**acc):
        seen.append({name: acc[name].numpy() for name in RAW})
        return real(**acc)

    with monkeypatch.context() as mp:
        mp.setattr(tsweep, "finalize_fleet_stats", spy)
        _, extras = fleet_sweep_demand(demand, gains, device=CPU, **kw)
    return {name: np.concatenate([s[name] for s in seen])
            for name in RAW}, extras


@pytest.mark.parametrize("policy", POLICIES)
def test_fleet_sweep_carry_is_jax_bit_for_bit(monkeypatch, policy):
    """Every accumulator the carry streams, the p99 from the histogram,
    and the slack minima equal the XLA engine's bit for bit: the port
    makes XLA's roundings (left folds over K, the five contracted
    multiply-adds).  Only the per-tenant budget mean sums nodes in
    another order."""
    demand, weights, floors = _small_problem(seed=1)
    kw = dict(node_memory=M, weights=weights, floors=floors, policy=policy,
              priority_order=(2, 0, 1), epoch_intervals=30, interval_s=0.1)
    for jg in (_jax_gains(3), jax_grid_gains(jax_params(), **KNOBS)):
        ref, ref_ex = _jax_raw(monkeypatch, demand, jg, kw)
        got, got_ex = _port_raw(monkeypatch, demand, _port_gains(jg), kw)
        for name in RAW:
            assert np.array_equal(got[name], ref[name]), name
        for f in ("conservation_slack_gib", "floor_slack_gib",
                  "tenant_budget_min_gib"):
            assert np.array_equal(getattr(got_ex, f),
                                  np.asarray(getattr(ref_ex, f))), f


@pytest.mark.parametrize("policy", POLICIES)
def test_fleet_sweep_matches_reference(policy):
    demand, weights, floors = _small_problem()
    gains = _gains()
    kw = dict(node_memory=M, weights=weights, floors=floors,
              policy=policy, priority_order=(2, 0, 1),
              epoch_intervals=30, interval_s=0.1)
    stats, extras = fleet_sweep_demand(demand, gains, device=CPU, **kw)
    ref_stats, ref_extras = fleet_reference(demand, gains, **kw)
    for f in FleetStats._fields:
        atol = 1e-2 if f == "p99_utilization" else 1e-4
        np.testing.assert_allclose(getattr(stats, f), getattr(ref_stats, f),
                                   rtol=2e-4, atol=atol, err_msg=f)
    for f in FleetExtras._fields:
        np.testing.assert_allclose(getattr(extras, f), getattr(ref_extras, f),
                                   rtol=2e-4, atol=1e-3, err_msg=f)


def test_fleet_reference_stats_match_jax():
    """The oracle's float32 ``compute_fleet_stats`` against JAX's."""
    demand, weights, floors = _small_problem(seed=4)
    kw = dict(node_memory=M, weights=weights, floors=floors,
              policy="proportional", epoch_intervals=30, interval_s=0.1)
    stats, extras = fleet_reference(demand, _gains(), **kw)
    ref_stats, ref_extras = J.fleet_reference(demand, _jax_gains(), **kw)
    for f in FleetStats._fields:
        np.testing.assert_allclose(getattr(stats, f), getattr(ref_stats, f),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    for f in FleetExtras._fields:
        assert np.array_equal(getattr(extras, f), getattr(ref_extras, f)), f


@pytest.mark.parametrize("policy", POLICIES)
def test_fleet_sweep_extras_invariants(policy):
    demand, weights, floors = _small_problem(seed=5)
    stats, ex = fleet_sweep_demand(
        demand, _gains(), node_memory=M, weights=weights, floors=floors,
        policy=policy, epoch_intervals=20, interval_s=0.1, device=CPU)
    assert (ex.conservation_slack_gib >= -1e-3).all()
    assert (ex.floor_slack_gib >= -1e-3).all()
    assert (ex.tenant_budget_min_gib <= ex.tenant_budget_mean_gib
            + 1e-6).all()
    if policy != "priority":
        assert (ex.tenant_budget_min_gib > 0.0).all()
    assert np.isfinite(stats.mean_utilization).all()


def test_fleet_sweep_chunk_invariance():
    demand, weights, floors = _small_problem(k=2, n=4, t=60, seed=2)
    gains = _gains(3)
    kw = dict(node_memory=M, weights=weights[:2], floors=floors[:2],
              epoch_intervals=20, interval_s=0.1, device=CPU)
    base = fleet_sweep_demand(demand, gains, **kw)
    for chunk in (2, 9):
        other = fleet_sweep_demand(demand, gains, chunk=chunk, **kw)
        for got, want, f in zip(other[0] + other[1], base[0] + base[1],
                                FleetStats._fields + FleetExtras._fields):
            np.testing.assert_array_equal(got, want, err_msg=f)


def test_fleet_sweep_horizon_truncates_to_whole_epochs():
    demand, weights, floors = _small_problem(k=2, n=4, t=60, seed=3)
    kw = dict(node_memory=M, weights=weights[:2], floors=floors[:2],
              epoch_intervals=20, interval_s=0.1, device=CPU)
    cut = fleet_sweep_demand(demand, _gains(), horizon=40, **kw)
    short = fleet_sweep_demand(demand[:, :, :40], _gains(), **kw)
    for got, want in zip(cut[0] + cut[1], short[0] + short[1]):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        fleet_sweep_demand(demand, _gains(), horizon=30, **kw)


def test_fleet_sweep_validates_args():
    demand, weights, floors = _small_problem(k=2, n=4, t=60)
    kw = dict(node_memory=M, weights=weights[:2], floors=floors[:2],
              device=CPU)
    with pytest.raises(ValueError):                       # ragged epochs
        fleet_sweep_demand(demand, _gains(), epoch_intervals=7, **kw)
    with pytest.raises(ValueError):                       # bad order
        fleet_sweep_demand(demand, _gains(), epoch_intervals=20,
                           priority_order=(0, 0), **kw)
    with pytest.raises(ValueError):
        fleet_sweep_demand(demand[0], _gains(), epoch_intervals=20, **kw)
    with pytest.raises(ValueError):
        fleet_sweep_demand(demand, _gains(), epoch_intervals=20,
                           node_memory=M, weights=weights,
                           floors=np.zeros(3), device=CPU)
    with pytest.raises(ValueError, match="policy"):
        fleet_sweep_demand(demand, _gains(), epoch_intervals=60,
                           policy="lottery", **kw)


# ---------------------------------------------------------------------------
# Scenario composition + runtime churn
# ---------------------------------------------------------------------------

def test_registered_fleet_scenarios():
    names = list_fleet_scenarios()
    assert names == J.list_fleet_scenarios()
    assert {"hpcc-spark", "tenant-churn"} <= set(names)
    fs = get_fleet_scenario("tenant-churn")
    assert fs.n_tenants == 3 and fs.n_nodes == 24
    d = fs.build_demand(seed=0)
    assert d.shape == (3, 24, 480) and (d >= 0).all()
    assert np.array_equal(d, fs.build_demand(seed=0))
    with pytest.raises(ValueError):
        FleetScenario("bad", tenants=(
            FleetTenant("a", "runtime-churn"),
            FleetTenant("b", "paper-c3-dynims60")))
    with pytest.raises(ValueError):
        FleetScenario("bad", tenants=(FleetTenant("a", "runtime-churn"),),
                      epoch_intervals=7)
    with pytest.raises(KeyError):
        get_fleet_scenario("no-such-fleet")
    with pytest.raises(ValueError, match="already registered"):
        from repro_torch.fleet import register_fleet_scenario
        register_fleet_scenario(fs)


def test_runtime_churn_scenario():
    demand, events = churn_demand(n_nodes=12, n_intervals=240, seed=1)
    assert demand.shape == (12, 240)
    assert events["squeeze"] and events["evict"]
    assert events["fail"] and events["recover"]
    assert min(events["evict"]) > min(events["squeeze"])
    t_fail = events["fail"][0]
    col = demand[:, t_fail]
    assert col.min() <= FAILED_DEMAND * demand[:, 0].max() * 1.5
    d2, e2 = churn_demand(n_nodes=12, n_intervals=240, seed=1)
    assert np.array_equal(demand, d2) and events == e2
    spec = get_scenario("runtime-churn")
    assert spec.family == "replay"
    assert spec.build_demand(seed=0).shape == (24, 480)


def test_run_fleet_sweep_tenant_churn():
    fs = get_fleet_scenario("tenant-churn")
    stats, extras = run_fleet_sweep(fs, _gains(), seed=0, device=CPU)
    assert stats.mean_utilization.shape == (4,)
    assert (extras.conservation_slack_gib >= -1e-3).all()
    assert (extras.floor_slack_gib >= -1e-3).all()


def test_cell_tenant_deployment():
    from repro_torch.launch.cells import DEFAULT_CELL_PRIORITY, cell_tenant
    plane = _tenant_spec("cell", 10.0).plane
    t = cell_tenant("hymba-1.5b", "decode_32k", plane=plane,
                    floor_gib=4.0)
    assert t.name == "hymba-1.5b:decode_32k"
    assert t.priority == DEFAULT_CELL_PRIORITY["decode"] == 2
    assert t.weight > 0 and t.floor_gib == 4.0
    train = cell_tenant("hymba-1.5b", "train_4k", plane=plane)
    assert train.priority == DEFAULT_CELL_PRIORITY["train"] == 0
    spec = FleetSpec(tenants=(t.replace(name="serve"),
                              train.replace(name="train")))
    assert FleetArbiter(spec).initial_budgets(M)["serve"] > 0


@pytest.mark.parametrize("arch", ["hymba-1.5b", "llama3.2-1b"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_cell_tenant_equals_jax(arch, shape):
    from repro.launch.cells import (DEFAULT_CELL_PRIORITY as JPRIO,
                                    cell_tenant as jax_cell_tenant)
    from repro_torch.launch.cells import DEFAULT_CELL_PRIORITY, cell_tenant
    assert DEFAULT_CELL_PRIORITY == JPRIO
    got = cell_tenant(arch, shape, plane=_tenant_spec("c", 1.0).plane,
                      floor_gib=2.0)
    want = jax_cell_tenant(arch, shape, plane=None, floor_gib=2.0)
    assert (got.name, got.weight, got.priority, got.floor_gib) == \
        (want.name, want.weight, want.priority, want.floor_gib)
