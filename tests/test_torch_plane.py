"""The port's control plane against the JAX package's, on the CPU.

Ports every test of ``tests/test_plane.py`` and ``tests/test_stream.py``
(bus, aggregator, MemoryPlane end to end, both backends, lifecycle, the
legacy shim) and the MemoryPlane-only tests of ``tests/test_chaos.py``
(telemetry validation, seeded monitor faults, quarantine entry and
rejoin, no NaN reaching the law, actuation retry and backoff, the
bounded fault log, the tick deadline), with faults injected by
test-local monitor and store wrappers in place of the ChaosPlane
harness.  Twins hold the port to JAX: the 256-node heterogeneous fleet
gives bit-equal float32 ``u_next`` from both ArrayControllers, and the
same seeded faults give the same ``(kind, node, tick)`` fault log and
the same actions.  The array backend runs with ``device="cpu"``.
"""

import math
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro_torch.configs.dynims import PAPER_TABLE_I
from repro_torch.core import (AGG_TOPIC, CONTROL_TOPIC, RAW_TOPIC,
                              AggregatedMetrics, ArrayController,
                              ControlPlane, ControllerParams, GiB,
                              HealthPolicy, MemoryPlane, MemorySample,
                              MessageBus, MetricAggregator, MonitorFault,
                              NodeHealth, NodeSpec, PlaneSpec, ShardCache,
                              Signal, SimulatedMonitor, StoreRegistry,
                              StoreSpec, validate_sample)
from repro_torch.core.plane import FaultEvent, FaultLog

# One intra-op thread: the suite's workers share the cores, and torch's
# OpenMP threads, oversubscribed, spin-wait ~100x longer than the ops.
torch.set_num_threads(1)

CPU = "cpu"
M = 125.0 * GiB
BACKENDS = ("scalar", "array")


class Blob:
    def __init__(self, nbytes):
        self.nbytes = nbytes


def paper_params(**kw):
    """Table I (``repro.core.cluster_sim.paper_controller_params``)."""
    return PAPER_TABLE_I.replace(**kw)


def sample(used, node="n0", i=0, total=125 * GiB, storage=0.0, swap=0.0):
    return MemorySample(node=node, timestamp=i * 0.1, used=used, total=total,
                        storage_used=storage, swap_used=swap)


# ---------------------------------------------------------------------------
# Bus and aggregator (tests/test_plane.py, tests/test_stream.py)
# ---------------------------------------------------------------------------

def test_bus_pubsub_and_poll():
    bus = MessageBus()
    seen = []
    unsub = bus.subscribe("t", seen.append)
    bus.publish("t", 1)
    bus.publish("t", 2)
    assert seen == [1, 2]
    assert bus.poll("t", group="g1") == [1, 2]
    assert bus.poll("t", group="g1") == []
    bus.publish("t", 3)
    assert bus.poll("t", group="g1") == [3]
    unsub()
    bus.publish("t", 4)
    assert seen == [1, 2, 3]


def test_bus_isolates_subscriber_exceptions():
    bus = MessageBus()
    bus.subscribe("t", lambda m: 1 / 0)
    bus.publish("t", "x")              # must not raise
    assert len(bus.errors) == 1


def test_sample_json_roundtrip():
    s = MemorySample(node="n0", timestamp=1.5, used=10.0, total=100.0,
                     storage_used=4.0)
    assert MemorySample.from_json(s.to_json()) == s


def test_aggregator_window_and_slope():
    agg = MetricAggregator(window=4)
    out = None
    for i, used in enumerate([10, 20, 30, 40]):
        out = agg.update(MemorySample("n", float(i), used, 100.0))
    assert out.used_latest == 40
    assert out.used_mean == 25
    assert out.used_max == 40
    assert abs(out.slope_per_interval - 10.0) < 1e-9


def test_single_sample_aggregates():
    agg = MetricAggregator(window=4)
    a = agg.update(sample(10 * GiB))
    assert a.used_latest == a.used_mean == a.used_max == 10 * GiB
    assert a.used_ewma == 10 * GiB          # EWMA seeds at first sample
    assert a.slope_per_interval == 0.0      # no slope from one point
    assert a.n_samples == 1
    assert a.utilization == pytest.approx(10 / 125)


def test_window_mean_max_and_eviction():
    agg = MetricAggregator(window=3)
    for i, used in enumerate([10.0, 20.0, 30.0, 40.0]):
        a = agg.update(sample(used, i=i))
    assert a.used_latest == 40.0
    assert a.used_mean == pytest.approx(30.0)
    assert a.used_max == 40.0
    assert a.n_samples == 3


def test_ewma_recursion():
    alpha = 0.25
    agg = MetricAggregator(window=8, ewma_alpha=alpha)
    values = [10.0, 50.0, 30.0]
    expected = values[0]
    for i, used in enumerate(values):
        a = agg.update(sample(used, i=i))
        expected = alpha * used + (1 - alpha) * expected if i else values[0]
    assert a.used_ewma == pytest.approx(expected)


def test_slope_least_squares():
    agg = MetricAggregator(window=8)
    for i in range(5):
        a = agg.update(sample(100.0 + 7.0 * i, i=i))
    assert a.slope_per_interval == pytest.approx(7.0)
    for i in range(5, 10):
        a = agg.update(sample(128.0, i=i))
    assert 0.0 <= a.slope_per_interval < 7.0
    rng = np.random.default_rng(0)
    agg2 = MetricAggregator(window=8)
    for i in range(8):
        a2 = agg2.update(sample(5.0 * i + float(rng.normal(0, 1e-3)), i=i))
    assert a2.slope_per_interval == pytest.approx(5.0, abs=1e-2)


def test_per_node_isolation():
    agg = MetricAggregator(window=4)
    agg.update(sample(10.0, node="a"))
    b = agg.update(sample(99.0, node="b"))
    a = agg.update(sample(20.0, node="a", i=1))
    assert a.used_mean == pytest.approx(15.0)
    assert b.used_mean == pytest.approx(99.0)
    assert agg.latest("a").used == 20.0
    assert agg.latest("b").used == 99.0
    assert agg.latest("missing") is None


def test_bus_raw_to_agg_pipeline():
    bus = MessageBus()
    MetricAggregator(window=4, bus=bus)
    got = []
    bus.subscribe(AGG_TOPIC, got.append)
    mon = SimulatedMonitor("n0", total=125 * GiB, usage=[10 * GiB, 20 * GiB])
    bus.publish(RAW_TOPIC, mon.sample())
    bus.publish(RAW_TOPIC, mon.sample())
    assert len(got) == 2
    assert isinstance(got[-1], AggregatedMetrics)
    assert got[-1].node == "n0"
    assert got[-1].used_latest == 20 * GiB
    assert got[-1].used_max == 20 * GiB
    assert got[-1].n_samples == 2


def test_window_validation():
    with pytest.raises(ValueError):
        MetricAggregator(window=0)


def test_aggregates_equal_the_jax_aggregator():
    rng = np.random.default_rng(3)
    ja, ta = J.MetricAggregator(window=5, ewma_alpha=0.3), \
        MetricAggregator(window=5, ewma_alpha=0.3)
    for i in range(40):
        node = f"n{i % 3}"
        used = float(rng.uniform(0, 125)) * GiB
        a = ja.update(J.MemorySample(node, i * 0.1, used, M, 2.0 * GiB))
        b = ta.update(MemorySample(node, i * 0.1, used, M, 2.0 * GiB))
        assert vars(a) == vars(b)


# ---------------------------------------------------------------------------
# MemoryPlane end to end (tests/test_plane.py)
# ---------------------------------------------------------------------------

def _burst_cache():
    cache = ShardCache(capacity=60 * GiB, sizeof=lambda v: v.nbytes)
    for i in range(60):
        cache.put(i, Blob(1 * GiB))
    return cache


BURST = ([20 * GiB] * 10) + ([95 * GiB] * 20) + ([20 * GiB] * 40)


def test_control_plane_closed_loop_burst():
    """Burst -> cache shrinks within intervals; burst clears -> cache
    regrows (paper Fig. 7 behaviour)."""
    with pytest.warns(DeprecationWarning):
        plane = ControlPlane(paper_params())
    cache = _burst_cache()
    reg = StoreRegistry()
    reg.register(cache, max_bytes=60 * GiB)
    mon = SimulatedMonitor("n0", total=125 * GiB, usage=BURST,
                           storage_used_fn=cache.used)
    plane.attach("n0", mon, reg, u0=60 * GiB)
    caps = []
    for _ in range(len(BURST)):
        plane.tick()
        caps.append(cache.capacity() / GiB)
    assert min(caps[10:30]) < 30            # u* = 0.95*125 - 95 = 23.75
    assert caps[-1] > 55
    assert cache.used() <= cache.capacity()
    assert cache.stats.evictions >= 25


def test_control_actions_published():
    with pytest.warns(DeprecationWarning):
        plane = ControlPlane(paper_params())
    cache = ShardCache(capacity=0, sizeof=lambda v: 1.0)
    reg = StoreRegistry()
    reg.register(cache, max_bytes=60 * GiB)
    mon = SimulatedMonitor("n0", total=125 * GiB, usage=[50 * GiB] * 5)
    plane.attach("n0", mon, reg)
    for _ in range(5):
        plane.tick()
    actions = plane.bus.poll(CONTROL_TOPIC, group="test")
    assert len(actions) == 5
    assert all(a.node == "n0" for a in actions)


def test_signal_enum_coercion():
    assert Signal.coerce("latest") is Signal.LATEST
    assert Signal.coerce(Signal.EWMA) is Signal.EWMA
    with pytest.raises(ValueError):
        Signal.coerce("p99")
    with pytest.raises(ValueError):
        PlaneSpec(params=paper_params(), signal="bogus")


def test_plane_spec_rejects_unknown_backend():
    with pytest.raises(ValueError):
        PlaneSpec(params=paper_params(), backend="quantum")


def test_memory_plane_array_backend_closed_loop():
    cache = _burst_cache()
    plane = MemoryPlane(PlaneSpec(
        params=paper_params(), backend="array", device=CPU,
        nodes=(NodeSpec(
            "n0",
            monitor=SimulatedMonitor("n0", total=125 * GiB, usage=BURST,
                                     storage_used_fn=cache.used),
            stores=(StoreSpec(cache, max_bytes=60 * GiB),),
            u0=60 * GiB),),
    ))
    caps = []
    for _ in range(len(BURST)):
        actions = plane.tick()
        assert len(actions) == 1
        caps.append(cache.capacity() / GiB)
    assert min(caps[10:30]) < 30
    assert caps[-1] > 55
    assert cache.used() <= cache.capacity()
    assert cache.stats.evictions >= 25
    assert plane.capacity("n0") == pytest.approx(caps[-1] * GiB, rel=1e-6)


def _fleet_inputs(variant, base, n=256, t=30):
    """tests/test_plane.py's heterogeneous fleet: numpy inputs."""
    rng = np.random.default_rng(42)
    Mn = rng.uniform(64, 256, n) * GiB
    u_max = rng.uniform(20, 60, n) * GiB
    u_min = rng.uniform(0, 5, n) * GiB
    u0 = rng.uniform(u_min, u_max)
    if variant == "paper":
        demand = rng.uniform(0.5, 1.05, (n, t)) * Mn[:, None]
        law = {}
    else:
        law = dict(feedforward=0.5, deadband=0.015, lam_grant=0.25)
        offsets = np.array([-0.25, -0.10, -0.04, 0.02, 0.06, 0.12])
        levels = rng.choice(offsets, size=(n, t // 5 + 1))
        demand = ((base.r0 + np.repeat(levels, 5, axis=1)[:, :t])
                  * Mn[:, None])
    return Mn, u_min, u_max, u0, demand, law


def _heterogeneous_fleet(mod, backend, variant, **spec_kw):
    """One plane (``mod`` is either package's core) with per-node
    capacity overrides and trace monitors."""
    base = mod.ControllerParams(total_memory=125 * GiB)
    Mn, u_min, u_max, u0, demand, law = _fleet_inputs(variant, base)
    base = base.replace(**law)
    nodes = tuple(
        mod.NodeSpec(
            f"n{i}",
            monitor=mod.SimulatedMonitor(f"n{i}", total=Mn[i],
                                         usage=demand[i]),
            registry=mod.StoreRegistry(), u0=u0[i],
            params=base.replace(total_memory=Mn[i], u_min=u_min[i],
                                u_max=u_max[i]))
        for i in range(len(Mn)))
    return mod.MemoryPlane(mod.PlaneSpec(params=base, backend=backend,
                                         nodes=nodes, **spec_kw))


@pytest.mark.parametrize("variant", ["paper", "extended"])
def test_array_scalar_parity_256_heterogeneous_nodes(variant):
    """The array backend matches the scalar reference within 1e-4
    relative tolerance across a mixed fleet."""
    planes = {"scalar": _heterogeneous_fleet(T, "scalar", variant),
              "array": _heterogeneous_fleet(T, "array", variant,
                                            device=CPU)}
    for _ in range(30):
        for plane in planes.values():
            plane.tick()
    ref = np.array([planes["scalar"].capacity(f"n{i}") for i in range(256)])
    got = np.array([planes["array"].capacity(f"n{i}") for i in range(256)])
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e4)


@pytest.mark.parametrize("variant", ["paper", "extended"])
def test_array_controller_equals_the_jax_array_controller(variant):
    """Over the same fleet the port's float32 ``u_next`` equals JAX's
    bit for bit, every node, every tick."""
    jp = _heterogeneous_fleet(J, "array", variant)
    tp = _heterogeneous_fleet(T, "array", variant, device=CPU)
    for tick in range(30):
        ja, ta = jp.tick(), tp.tick()
        assert len(ja) == len(ta) == 256
        for a, b in zip(ja, ta):
            assert (a.node, a.epoch) == (b.node, b.epoch)
            assert np.float32(a.u_next).tobytes() == \
                np.float32(b.u_next).tobytes(), (tick, a.node)
            assert a.u_prev == b.u_prev and a.u_next == b.u_next


def test_fused_step_equals_jax_fused_step_over_gains():
    """``make_fused_step`` against JAX's on random operands, for the
    Table I law and for every law variant of the presets."""
    rng = np.random.default_rng(11)
    n = 4096
    for kw in ({}, dict(r0=0.92, lam=0.8, lam_grant=0.3),
               dict(r0=0.935, lam=1.6, feedforward=0.5),
               dict(r0=0.97, lam=1.6, lam_grant=0.25, deadband=0.015,
                    feedforward=0.5)):
        jf = J.make_fused_step(J.ControllerParams(total_memory=M, **kw))
        tf = T.make_fused_step(ControllerParams(total_memory=M, **kw), CPU)
        m = rng.uniform(64, 256, n) * GiB
        ops = [rng.uniform(0, 60, n) * GiB, rng.uniform(0.5, 1.05, n) * m,
               rng.uniform(0.5, 1.05, n) * m, rng.random(n) < 0.8,
               rng.random(n) < 0.9, m, rng.uniform(0, 5, n) * GiB,
               rng.uniform(20, 60, n) * GiB]
        a = np.asarray(jf(*[jnp.asarray(x) if x.dtype == bool else
                            jnp.asarray(x, jnp.float32) for x in ops]))
        b = tf(*[torch.from_numpy(x) if x.dtype == bool else
                 torch.from_numpy(x.astype(np.float32)) for x in ops])
        assert a.tobytes() == b.numpy().tobytes(), kw


def test_memory_plane_lifecycle_restart():
    params = paper_params(interval_s=0.01)
    plane = MemoryPlane(PlaneSpec(params=params, backend="array",
                                  device=CPU))
    plane.attach("n0",
                 SimulatedMonitor("n0", total=125 * GiB,
                                  usage=lambda i: 80 * GiB),
                 registry=StoreRegistry(), u0=30 * GiB)
    assert plane.nodes() == ["n0"]
    assert len(plane.tick()) == 1
    assert not plane.running
    plane.start()
    assert plane.running
    time.sleep(0.15)
    plane.stop()
    assert not plane.running
    n1 = len(plane.actions())
    assert n1 > 1
    plane.start()                      # restart after stop
    time.sleep(0.15)
    plane.stop()
    assert len(plane.actions()) > n1
    with plane:                        # context-manager lifecycle
        assert plane.running
        time.sleep(0.05)
    assert not plane.running


def test_action_history_is_bounded():
    plane = MemoryPlane(PlaneSpec(
        params=paper_params(), backend="array", history=8, device=CPU,
        nodes=(NodeSpec("n0",
                        monitor=SimulatedMonitor(
                            "n0", total=125 * GiB,
                            usage=lambda i: 100 * GiB),
                        registry=StoreRegistry(), u0=30 * GiB),)))
    for _ in range(40):
        plane.tick()
    assert len(plane.actions()) == 8
    assert len(plane.actions(limit=3)) == 3
    with pytest.warns(DeprecationWarning):
        shim = ControlPlane(paper_params(), max_history=8)
    shim.attach("n0", SimulatedMonitor("n0", total=125 * GiB,
                                       usage=lambda i: 100 * GiB),
                StoreRegistry(), u0=30 * GiB)
    for _ in range(40):
        shim.tick()
    assert len(shim.controller.actions) == 8


def test_squeeze_clamps_without_moving_control_state():
    cache = ShardCache(capacity=40 * GiB, sizeof=lambda v: v.nbytes)
    for i in range(40):
        cache.put(i, Blob(1 * GiB))
    plane = MemoryPlane(PlaneSpec(
        params=paper_params(), backend="array", device=CPU,
        nodes=(NodeSpec("n0",
                        monitor=SimulatedMonitor(
                            "n0", total=125 * GiB,
                            usage=lambda i: 40 * GiB,
                            storage_used_fn=cache.used),
                        stores=(StoreSpec(cache, 60 * GiB),),
                        u0=40 * GiB),)))
    assert plane.squeeze("n0", 0.25)
    assert cache.capacity() == pytest.approx(10 * GiB)
    assert plane.capacity("n0") == pytest.approx(40 * GiB)   # u untouched
    plane.tick()                       # law re-grants from slack
    assert cache.capacity() > 10 * GiB
    assert not plane.squeeze("ghost", 0.5)


def test_per_node_gain_override_rejected_on_array_backend():
    base = paper_params()
    ac = ArrayController(base, device=CPU)
    with pytest.raises(ValueError):
        ac.attach_node("n0", StoreRegistry(), u0=0.0,
                       params=base.replace(lam=1.5))
    ac.attach_node("n1", StoreRegistry(), u0=0.0,
                   params=base.replace(u_max=10 * GiB))   # capacities ok


def test_control_plane_shim_is_deprecated_memory_plane():
    with pytest.warns(DeprecationWarning):
        shim = ControlPlane(paper_params())
    assert isinstance(shim, MemoryPlane)
    from repro_torch.core.controller import ControlPlane as legacy_path
    assert legacy_path is ControlPlane


@pytest.mark.parametrize("backend", BACKENDS)
def test_tick_returns_full_fleet_despite_small_history(backend):
    plane = MemoryPlane(PlaneSpec(
        params=paper_params(), backend=backend, history=4, device=CPU,
        nodes=tuple(
            NodeSpec(f"n{i}",
                     monitor=SimulatedMonitor(
                         f"n{i}", total=125 * GiB,
                         usage=lambda t: 90 * GiB),
                     registry=StoreRegistry(), u0=30 * GiB)
            for i in range(12))))
    assert len(plane.tick()) == 12
    assert len(plane.actions()) == 4          # retained log stays bounded


def test_attach_rejects_registry_and_stores_together():
    plane = MemoryPlane(PlaneSpec(params=paper_params(), device=CPU))
    cache = ShardCache(capacity=1 * GiB)
    with pytest.raises(ValueError):
        plane.attach("n0",
                     SimulatedMonitor("n0", total=125 * GiB,
                                      usage=lambda i: 50 * GiB),
                     registry=StoreRegistry(),
                     stores=(StoreSpec(cache, 1 * GiB),))


@pytest.mark.parametrize("backend", BACKENDS)
def test_swap_params_lands_between_intervals(backend):
    """A hot-swap moves the epoch for the next interval only and keeps
    the control state; the swapped plane equals JAX's, swapped alike."""
    def run(mod, **kw):
        plane = mod.MemoryPlane(mod.PlaneSpec(
            params=mod.ControllerParams(total_memory=M), backend=backend,
            nodes=(mod.NodeSpec("n0", monitor=mod.SimulatedMonitor(
                "n0", total=M, usage=lambda i: (70 + 40 * (i % 3)) * GiB),
                registry=mod.StoreRegistry(), u0=30 * GiB),), **kw))
        out = [plane.tick() for _ in range(4)]
        assert plane.swap_params(plane.params.replace(
            lam=1.6, lam_grant=0.25)) == 1
        out += [plane.tick() for _ in range(4)]
        return [(a.u_prev, a.u_next, a.epoch) for acts in out for a in acts]

    port = run(T, device=CPU)
    assert [e for _, _, e in port] == [0] * 4 + [1] * 4
    assert port == run(J)


def test_stability_helpers_equal_jax():
    for lam in (0.3, 1.0, 1.9, 2.1):
        jp = J.ControllerParams(total_memory=M, lam=lam)
        tp = ControllerParams(total_memory=M, lam=lam)
        assert T.is_stable(tp) == J.is_stable(jp)
        assert T.closed_loop_eigenvalue(tp) == J.closed_loop_eigenvalue(jp)
        assert T.fixed_point_capacity(tp, 80 * GiB) == \
            J.fixed_point_capacity(jp, 80 * GiB)
        demand = np.r_[np.full(20, 40.0), np.full(40, 90.0)] * GiB
        a = T.simulate_saturated_loop(tp, demand, 30 * GiB)
        assert a.tobytes() == J.simulate_saturated_loop(
            jp, demand, 30 * GiB).tobytes()
        target = T.fixed_point_capacity(tp, 90 * GiB)
        assert T.settling_time(a, target) == J.settling_time(a, target)


# ---------------------------------------------------------------------------
# Health layer (the MemoryPlane-only tests of tests/test_chaos.py)
# ---------------------------------------------------------------------------

def _chaos_params(mod=T, **kw):
    kw.setdefault("total_memory", M)
    kw.setdefault("u_max", 60.0 * GiB)
    kw.setdefault("u_min", 5.0 * GiB)
    return mod.ControllerParams(**kw)


class Faulty:
    """A monitor wrapper whose faults the test switches on and off:
    ``"crash"`` raises, ``"nan"`` corrupts ``used``, ``None`` passes
    the inner sample through.  Works with either package's samples."""

    def __init__(self, inner, error=MonitorFault):
        self.inner, self.fault, self.error = inner, None, error

    def sample(self):
        s = self.inner.sample()
        if self.fault == "crash":
            raise self.error(f"{s.node}: injected crash")
        if self.fault == "nan":
            return type(s)(s.node, s.timestamp, float("nan"), s.total,
                           s.storage_used, s.swap_used)
        return s


class WedgedStore:
    """A store whose ``set_capacity`` raises while ``down``."""

    name, priority = "wedged", 0

    def __init__(self):
        self.down, self._cap = False, 0.0

    def capacity(self):
        return self._cap

    def used(self):
        return 0.0

    def set_capacity(self, capacity):
        if self.down:
            raise RuntimeError("store wedged")
        self._cap = float(capacity)


def _chaos_plane(mod, backend, n_nodes=4, policy=None, usage=None,
                 stores=None, **spec_kw):
    usage = usage or (lambda k: 80.0 * GiB)
    error = mod.MonitorFault
    mons = [Faulty(mod.SimulatedMonitor(f"n{i}", total=M, usage=usage),
                   error) for i in range(n_nodes)]
    nodes = tuple(
        mod.NodeSpec(f"n{i}", monitor=mons[i],
                     stores=stores[i] if stores else (),
                     registry=None if stores else mod.StoreRegistry(),
                     u0=30.0 * GiB)
        for i in range(n_nodes))
    if mod is T and backend == "array":
        spec_kw.setdefault("device", CPU)
    plane = mod.MemoryPlane(mod.PlaneSpec(
        params=_chaos_params(mod), backend=backend,
        health=policy or mod.HealthPolicy(stale_budget=2,
                                          rejoin_intervals=3),
        nodes=nodes, **spec_kw))
    return plane, mons


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
    assert [validate_sample(s) for s in bad] == [
        J.validate_sample(J.MemorySample(**vars(s))) for s in bad]


def _run_faulty(mon, n=40):
    out = []
    for _ in range(n):
        try:
            u = mon.sample().used
            out.append("nan" if math.isnan(u) else u)
        except (MonitorFault, J.MonitorFault):
            out.append("drop")
    return out


def test_simulated_monitor_fault_modes_are_seeded():
    def make(mod, seed):
        return mod.SimulatedMonitor("n0", total=100.0,
                                    usage=lambda i: 50.0 + i,
                                    faults={"dropout": 0.3, "nan": 0.2},
                                    fault_seed=seed)

    a, b = _run_faulty(make(T, 3)), _run_faulty(make(T, 3))
    assert a == b                                  # deterministic replay
    assert a != _run_faulty(make(T, 4))            # seed changes schedule
    assert "drop" in a and "nan" in a
    assert a == _run_faulty(make(J, 3))            # the JAX schedule
    with pytest.raises(ValueError, match="unknown fault kinds"):
        SimulatedMonitor("n", total=1.0, usage=lambda i: 1.0,
                         faults={"gremlin": 0.5})


def test_simulated_monitor_freeze_returns_last_good():
    mon = SimulatedMonitor("n0", total=100.0, usage=lambda i: float(i),
                           faults={"freeze": 1.0}, fault_seed=0)
    first = mon.sample()          # nothing cached yet -> fresh sample
    frozen = [mon.sample() for _ in range(3)]
    assert all(s.used == first.used for s in frozen)


@pytest.mark.parametrize("backend", BACKENDS)
def test_quarantine_entry_and_rejoin_are_bounded(backend):
    policy = HealthPolicy(stale_budget=3, rejoin_intervals=4)
    plane, mons = _chaos_plane(T, backend, n_nodes=2, policy=policy)
    for _ in range(5):
        plane.tick()                                   # warm last-good
    mons[0].fault = "crash"
    states = []
    for _ in range(10):
        plane.tick()
        states.append(plane.health().nodes["n0"].state)
    assert states[policy.stale_budget - 2] is not NodeHealth.QUARANTINED
    assert states[policy.stale_budget - 1] is NodeHealth.QUARANTINED
    assert states[-1] is NodeHealth.QUARANTINED
    mons[0].fault = None
    rejoin_at = None
    for t in range(policy.rejoin_intervals + 3):
        plane.tick()
        if plane.health().nodes["n0"].state is NodeHealth.HEALTHY:
            rejoin_at = t
            break
    assert rejoin_at is not None, "node never rejoined after the fault"
    assert rejoin_at + 1 >= policy.rejoin_intervals    # hysteresis


@pytest.mark.parametrize("backend", BACKENDS)
def test_quarantined_node_is_pinned_fail_static(backend):
    policy = HealthPolicy(stale_budget=2, rejoin_intervals=3)
    cache = ShardCache(capacity=30.0 * GiB)
    params = _chaos_params()
    mon = Faulty(SimulatedMonitor("n0", total=M, usage=lambda k: 80.0 * GiB,
                                  storage_used_fn=cache.used))
    plane = MemoryPlane(PlaneSpec(
        params=params, backend=backend, health=policy, device=CPU,
        nodes=(NodeSpec("n0", monitor=mon,
                        stores=(StoreSpec(cache, max_bytes=60.0 * GiB),),
                        u0=30.0 * GiB),)))
    for _ in range(3):
        plane.tick()
    mon.fault = "crash"
    for _ in range(policy.stale_budget + 4):
        acted = plane.tick()
    info = plane.health().nodes["n0"]
    assert info.state is NodeHealth.QUARANTINED
    assert info.pin_grant == policy.fail_static_grant(
        params.u_min, params.u_max) == params.u_min
    assert cache.capacity() == pytest.approx(info.pin_grant)
    assert acted == []                   # law not running on n0


@pytest.mark.parametrize("backend", BACKENDS)
def test_nan_telemetry_never_reaches_the_law(backend):
    plane, mons = _chaos_plane(T, backend, n_nodes=1)
    params = plane.params
    for _ in range(3):
        plane.tick()
    u_before = plane.capacity("n0")
    mons[0].fault = "nan"
    acts = plane.tick() + plane.tick()
    mons[0].fault = None
    assert acts, "stale holdover should keep the law running"
    for a in acts:
        assert math.isfinite(a.u_next)
        assert params.u_min <= a.u_next <= params.u_max
    assert math.isfinite(plane.capacity("n0"))
    assert plane.health().fault_counts["telemetry-invalid"] == 2
    assert u_before == pytest.approx(plane.capacity("n0"), rel=0.5)


def test_actuation_retry_backoff_and_recovery():
    policy = HealthPolicy(actuation_retries=2, retry_backoff_cap=4)
    store = WedgedStore()
    plane, _ = _chaos_plane(T, "scalar", n_nodes=1, policy=policy,
                            stores=[(StoreSpec(store, 60 * GiB),)])
    for _ in range(2):
        plane.tick()
    store.down = True
    for _ in range(6):
        plane.tick()
    info = plane.health().nodes["n0"]
    assert info.actuation_degraded      # retries exhausted -> flagged
    assert info.actuation_failures >= policy.actuation_retries
    counts = plane.fault_log.counts()
    assert counts["actuation-error"] < 6     # backoff skips apply calls
    assert counts.get("actuation-degraded", 0) == 1
    store.down = False
    for _ in range(2 * policy.retry_backoff_cap + 2):
        plane.tick()
    info = plane.health().nodes["n0"]
    assert not info.actuation_degraded and info.actuation_failures == 0
    assert plane.fault_log.counts().get("actuation-recovered", 0) == 1


def test_fault_log_is_bounded():
    log = FaultLog(maxlen=4)
    for i in range(10):
        log.append(FaultEvent(kind="k", node="n", tick=i, timestamp=0.0))
    assert len(log) == 4
    assert [e.tick for e in log.snapshot()] == [6, 7, 8, 9]
    assert log.counts() == {"k": 10}         # counts survive eviction


def test_tick_deadline_watchdog():
    plane, _ = _chaos_plane(T, "scalar", n_nodes=1,
                            policy=HealthPolicy(tick_deadline_s=1e-9))
    plane.tick()
    report = plane.health()
    assert report.deadline_misses == 1
    assert report.fault_counts.get("tick-deadline", 0) == 1


# -- the same faults through both packages ----------------------------------

def _faults_in(mod, backend, scenario):
    """Drive one fault scenario; returns the ``(kind, node, tick)`` fault
    log, every action's ``(node, u_prev, u_next, epoch)`` and the final
    health states."""
    wedged = [WedgedStore() for _ in range(2)]
    stores = None
    if scenario == "actuation":
        stores = [(mod.StoreSpec(w, 60 * GiB),) for w in wedged]
    plane, mons = _chaos_plane(
        mod, backend, n_nodes=2, stores=stores,
        usage=lambda k: (60.0 + 30.0 * math.sin(0.3 * k)) * GiB,
        policy=mod.HealthPolicy(stale_budget=2, rejoin_intervals=3,
                                actuation_retries=2, retry_backoff_cap=4))
    if scenario == "seeded":
        for i, m in enumerate(mons):
            m.inner = mod.SimulatedMonitor(
                f"n{i}", total=M,
                usage=lambda k: (60.0 + 30.0 * math.sin(0.3 * k)) * GiB,
                faults={"dropout": 0.15, "freeze": 0.1, "nan": 0.1},
                fault_seed=5)
    actions = []
    for t in range(40):
        if scenario == "crash":
            mons[0].fault = "crash" if 5 <= t < 15 else None
            mons[1].fault = "nan" if 8 <= t < 10 else None
        for w in wedged:              # down for ticks 4-11
            w.down = 4 <= t < 12
        actions += [(a.node, a.u_prev, a.u_next, a.epoch)
                    for a in plane.tick()]
    log = [(e.kind, e.node, e.tick) for e in plane.fault_log.snapshot()]
    states = {n: i.state.value for n, i in plane.health().nodes.items()}
    return log, actions, states


@pytest.mark.parametrize("scenario", ["seeded", "crash", "actuation"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_health_layer_equals_jax(backend, scenario):
    port = _faults_in(T, backend, scenario)
    assert port[0], "no fault fired"
    assert port == _faults_in(J, backend, scenario)
