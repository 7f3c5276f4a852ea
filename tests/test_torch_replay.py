"""The port's ReplayLoop against the JAX package's, on the CPU.

* ``ScenarioSpec.from_capture`` equals JAX's field for field (the
  fitted ``CacheSpec`` and the ``ReplayTrace`` arrays included) on
  ``tests/test_replay.py``'s fake, warm-residency and saturated
  captures, under the cache-fit options and a horizon/fleet change, and
  on a plane's own capture -- which itself equals the JAX plane's bit
  for bit.  The replayed demand equals JAX's byte for byte.
* The capture's replay reproduces the live loop (JAX's gates: p99
  within 0.02 and mean utilization within 0.01 of the capture's).
* ``retune_online`` on the same saturated plane makes JAX's decision --
  winner, ``swapped``, epoch -- and its score agrees to rtol 1e-5 (both
  rank in float32); ``min_improvement`` keeps the deployed gains; the
  supervisor restarts after injected crashes, with JAX's counters and
  fault events, and reports a dead round.
"""

import dataclasses
import math

import numpy as np
import pytest

import repro.core as J
import repro.lab as jlab
from repro.configs.dynims import PAPER_TABLE_I as J_TABLE_I
import repro_torch.core as T
from repro_torch.configs.dynims import PAPER_TABLE_I
from repro_torch.convert import params_from_dict
from repro_torch.core.traces import GiB
from repro_torch.lab import scenarios as tsc
from repro_torch.lab.scenarios import ScenarioSpec
from repro_torch.lab.sweep import GainSet, run_sweep
from repro_torch.lab.tune import retune_online
import torch

# One intra-op thread: the suite's workers share the cores, and torch's
# OpenMP threads, oversubscribed, spin-wait ~100x longer than the ops.
torch.set_num_threads(1)


def _arrays(n=4, t=120, seed=0):
    rng = np.random.default_rng(seed)
    return dict(nodes=tuple(f"n{i}" for i in range(n)), interval_s=0.1,
                demand=rng.uniform(20, 80, (n, t)) * GiB,
                utilization=rng.uniform(0.5, 1.0, (n, t)),
                grant=np.full((n, t), 60 * GiB),
                residency=np.zeros((n, t)),
                total_memory=np.full(n, 125 * GiB))


def _captures(kind):
    """The same capture as JAX's and as the port's ``CapturedTrace``."""
    a = _arrays()
    if kind == "warm":
        a["residency"] = np.minimum(np.cumsum(np.full(a["demand"].shape,
                                                      0.25 * GiB), axis=1),
                                    40 * GiB)
    elif kind == "saturated":
        a["residency"] = a["grant"].copy()
    elif kind == "lagging":           # residency under the grant in force
        a["grant"] = np.linspace(20, 60, a["demand"].shape[1])[None] \
            * np.ones((4, 1)) * GiB
        a["residency"] = 0.9 * a["grant"]
        a["total_memory"] = np.array([100, 125, 150, 125]) * GiB
    return J.CapturedTrace(**a), T.CapturedTrace(**a)


def _fields(spec):
    d = {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}
    d["cache"] = None if spec.cache is None else dataclasses.asdict(
        spec.cache)
    tr = d.pop("replay")
    d["replay"] = (tr.demand.tobytes(), tr.node_memory.tobytes(),
                   tr.interval_s)
    return d


@pytest.mark.parametrize("kw", [{}, {"fit_cache": False},
                                {"n_nodes": 10, "n_intervals": 200},
                                {"name": "x", "offset_gib": 3.0}],
                         ids=["auto", "no-fit", "tiled", "overrides"])
@pytest.mark.parametrize("kind", ["fake", "warm", "saturated", "lagging"])
def test_from_capture_equals_jax_field_for_field(kind, kw):
    jc, tc = _captures(kind)
    ref = jlab.ScenarioSpec.from_capture(jc, **kw)
    got = ScenarioSpec.from_capture(tc, **kw)
    assert _fields(got) == _fields(ref)
    for seed in (0, 3):
        assert got.build_demand(seed).tobytes() == \
            ref.build_demand(seed).tobytes()
        assert got.build_node_memory(seed).tobytes() == \
            ref.build_node_memory(seed).tobytes()


def test_from_capture_fits_cache_from_residency():
    _, cap = _captures("fake")
    # no residency observed -> saturated store; asking for a fit fails
    assert ScenarioSpec.from_capture(cap).cache is None
    with pytest.raises(ValueError):
        ScenarioSpec.from_capture(cap, fit_cache=True)
    _, warm = _captures("warm")
    cache = ScenarioSpec.from_capture(warm).cache
    # residency ceiling: 0.25 GiB x 120 intervals = 30 GiB on 125 GiB
    assert cache.working_set_frac == pytest.approx(30 / 125, rel=0.01)
    # refill flux: 0.25 GiB per 0.1 s interval = 2.5 GiB/s
    assert cache.refill_gibps == pytest.approx(2.5, rel=0.05)
    assert ScenarioSpec.from_capture(warm, fit_cache=False).cache is None
    # residency that tracks the grant is the saturated store
    _, saturated = _captures("saturated")
    assert ScenarioSpec.from_capture(saturated).cache is None
    spec = ScenarioSpec.from_capture(cap, name="exact")
    assert spec.family == "replay"
    np.testing.assert_array_equal(spec.build_demand(seed=3), cap.demand)
    assert hash(spec) == hash(spec.replace())
    assert spec.replace(n_nodes=8) != spec


def _saturated_plane(core, demand, node_memory, params, record,
                     backend="array", **spec_kw):
    """tests/test_replay.py's plane: monitors report demand + grant."""
    plane = core.MemoryPlane(core.PlaneSpec(params=params, backend=backend,
                                            record=record, **spec_kw))
    t = demand.shape[1]
    for i in range(demand.shape[0]):
        name = f"node{i}"
        plane.attach(
            name,
            core.SimulatedMonitor(
                name, total=float(node_memory[i]),
                usage=lambda k, row=demand[i]: float(row[k % t]),
                storage_used_fn=lambda nm=name, p=plane: p.capacity(nm)),
            registry=core.StoreRegistry(), u0=params.u_max)
    return plane


def _twin_planes(n_nodes, n_intervals, seed):
    spec = tsc.get_scenario("swap-storm").replace(n_nodes=n_nodes,
                                                  n_intervals=n_intervals)
    demand = spec.build_demand(seed=seed)
    m = spec.build_node_memory(seed=seed)
    jp = _saturated_plane(J, demand, m, J_TABLE_I, record=n_intervals)
    tp = _saturated_plane(T, demand, m, PAPER_TABLE_I, record=n_intervals,
                          device="cpu")
    for _ in range(n_intervals):
        jp.tick()
        tp.tick()
    return jp, tp


def test_plane_capture_and_its_replay_equal_jax():
    jp, tp = _twin_planes(6, 150, seed=0)
    jc, tc = jp.capture(), tp.capture()
    assert tc.nodes == jc.nodes and tc.interval_s == jc.interval_s
    for f in ("demand", "utilization", "grant", "residency",
              "total_memory"):
        np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f),
                                      err_msg=f)
    ref = jlab.ScenarioSpec.from_capture(jc, name="fidelity")
    got = ScenarioSpec.from_capture(tc, name="fidelity")
    assert _fields(got) == _fields(ref)
    # the replay reproduces the live loop (tests/test_replay.py's gates)
    r = run_sweep(got, GainSet.from_params(PAPER_TABLE_I), seed=0,
                  device="cpu")
    assert abs(float(r.stats.p99_utilization[0])
               - tc.utilization_p99()) <= 0.02
    assert abs(float(r.stats.mean_utilization[0])
               - float(tc.utilization.mean())) <= 0.01


def _same_decision(got, ref):
    assert got.swapped == ref.swapped and got.epoch == ref.epoch
    assert got.params == params_from_dict(dataclasses.asdict(ref.params))
    assert got.old_params == params_from_dict(
        dataclasses.asdict(ref.old_params))
    assert np.isclose(got.tune.score, ref.tune.score, rtol=1e-5)
    assert np.isclose(got.tune.baseline_score, ref.tune.baseline_score,
                      rtol=1e-5)
    assert got.summary().split(";")[1] == ref.summary().split(";")[1]


def test_retune_online_makes_the_jax_decision():
    jp, tp = _twin_planes(5, 120, seed=0)
    ref = jlab.retune_online(jp, name="retune-test", method="halving",
                             budget=12, seed=0, block=True)
    got = retune_online(tp, name="retune-test", method="halving",
                        budget=12, seed=0, block=True, device="cpu")
    _same_decision(got, ref)
    assert got.swapped and got.epoch == 1
    assert got.tune.score >= got.tune.baseline_score
    assert tp.params == got.params != PAPER_TABLE_I
    assert tp.tick()[0].epoch == 1
    assert "hot-swapped" in got.summary()


def test_retune_online_respects_min_improvement():
    jp, tp = _twin_planes(4, 80, seed=1)
    ref = jlab.retune_online(jp, budget=8, seed=1, block=False,
                             min_improvement=float("inf")).result(
                                 timeout=300)
    handle = retune_online(tp, budget=8, seed=1, block=False,
                           min_improvement=float("inf"), device="cpu")
    got = handle.result(timeout=300)
    assert handle.done
    _same_decision(got, ref)
    assert not got.swapped and got.epoch is None
    assert tp.params == PAPER_TABLE_I and tp.epoch == 0


def _recording_plane(core, ticks=30, **spec_kw):
    """tests/test_chaos.py's recording plane: 3 nodes, sinusoidal use."""
    params = core.ControllerParams(total_memory=125 * GiB, u_max=60 * GiB)
    plane = core.MemoryPlane(core.PlaneSpec(params=params, backend="array",
                                            record=ticks, **spec_kw))
    for i in range(3):
        plane.attach(f"n{i}", core.SimulatedMonitor(
            f"n{i}", total=125 * GiB,
            usage=lambda k: (60.0 + 30.0 * math.sin(0.3 * k)) * GiB),
            registry=core.StoreRegistry(), u0=60 * GiB)
    for _ in range(ticks):
        plane.tick()
    return plane


def _flaky(plane, n):
    real, boom = plane.capture, [n]

    def capture(*a, **kw):
        if boom[0] > 0:
            boom[0] -= 1
            raise RuntimeError("injected retune kill")
        return real(*a, **kw)

    plane.capture = capture


def test_retune_supervisor_restarts_after_crashes_as_jax_does():
    jp, tp = _recording_plane(J), _recording_plane(T, device="cpu")
    _flaky(jp, 2)
    _flaky(tp, 2)
    kw = dict(method="random", budget=4, seed=0, block=False, swap=False,
              restarts=4, restart_backoff_s=0.01)
    jh = jlab.retune_online(jp, **kw)
    th = retune_online(tp, device="cpu", **kw)
    ref, got = jh.result(timeout=300), th.result(timeout=300)
    assert (th.attempts, th.restarts) == (jh.attempts, jh.restarts) == (3, 2)
    _same_decision(got, ref)
    assert got.tune.score >= got.tune.baseline_score
    assert tp.fault_log.counts() == jp.fault_log.counts()
    assert tp.fault_log.counts().get("retune-restart", 0) == 2
    assert "retune-dead" not in tp.fault_log.counts()


def test_retune_supervisor_gives_up_and_reports_dead():
    plane = _recording_plane(T, ticks=10, device="cpu")
    _flaky(plane, 10)
    handle = retune_online(plane, block=False, restarts=2,
                           restart_backoff_s=0.01, device="cpu")
    with pytest.raises(RuntimeError, match="injected"):
        handle.result(timeout=60)
    assert handle.attempts == 3 and handle.restarts == 2
    assert plane.fault_log.counts().get("retune-dead", 0) == 1
    # unsupervised, an empty recorder raises in the caller
    idle = T.MemoryPlane(T.PlaneSpec(params=PAPER_TABLE_I,
                                     backend="scalar"))
    with pytest.raises(ValueError, match="not recording"):
        retune_online(idle, block=False, device="cpu")
    with pytest.raises(ValueError, match="restarts"):
        retune_online(idle, restarts=-1, device="cpu")
