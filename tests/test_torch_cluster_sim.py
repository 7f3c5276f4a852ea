"""The port's cluster simulator against the JAX package's, on the CPU.

* ``simulate`` (host float64 over a scalar-backend plane) equals JAX's to
  the bit for the paper's four configurations on a reduced app: runtime,
  iteration times, hit ratio, the Fig. 7 timelines and the recorded
  trace.
* The paper gates of ``tests/test_paper_validation.py`` (headline
  speedups, upper bound, hit ratios, Figs. 6-8, fleet stability) hold on
  the port's own run.
* ``simulate_fleet``: the ``python`` engine equals JAX's ``python`` engine
  to the bit (both fold the divisions by the constants M and r0 into
  multiplies by their float32 reciprocals and round the multiply-adds
  once); the ``lab`` engine agrees with it, and with JAX's ``lab``
  engine, within the tolerances of ``tests/test_lab.py`` (rtol 1e-4,
  p99 within its 5e-4 estimator bracket).
* The cache-parity oracle holds the port's cache-on sweep hit ratio
  within 0.02, as ``tests/test_cacheloop.py`` holds JAX's; and the
  float64 AppGraph oracle equals JAX's to the bit.
"""

import numpy as np
import pytest

import repro.core.cluster_sim as J
import repro.lab as jlab
from repro.core.traces import IterativeAppSpec as JApp
from repro_torch.core import cluster_sim as T
from repro_torch.core.traces import GiB, IterativeAppSpec
from repro_torch.lab import scenarios as tsc
from repro_torch.lab.scenarios import CacheSpec, ScenarioSpec
from repro_torch.lab.sweep import GainSet, run_sweep
import torch

# One intra-op thread: the suite's workers share the cores, and torch's
# OpenMP threads, oversubscribed, spin-wait ~100x longer than the ops.
torch.set_num_threads(1)

PARITY_KEYS = ("mean_utilization", "p99_utilization", "max_utilization",
               "mean_capacity_gib", "capacity_std_gib",
               "frac_intervals_over_r0", "max_over_r0")
P99_ATOL = 5e-4
TIMELINES = ("t_s", "exec_gib", "storage_gib", "free_gib", "cap_gib")
TRACE_FIELDS = ("demand", "utilization", "grant", "residency",
                "total_memory")


def _same_result(j, t):
    for f in ("config", "app_runtime_s", "iteration_times_s", "hit_ratio",
              "remote_bytes_gib", "disk_reads_gib", "hpcc_runtime_s",
              "peak_utilization", "mean_cap_gib"):
        assert getattr(t, f) == getattr(j, f), f
    for f in TIMELINES:
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f),
                                      err_msg=f)
    assert (t.trace is None) == (j.trace is None)
    if j.trace is not None:
        assert t.trace.nodes == j.trace.nodes
        assert t.trace.interval_s == j.trace.interval_s
        for f in TRACE_FIELDS:
            np.testing.assert_array_equal(getattr(t.trace, f),
                                          getattr(j.trace, f), err_msg=f)


@pytest.mark.parametrize("configuration", [1, 2, 3, 4])
def test_simulate_equals_jax_to_the_bit(configuration):
    kw = dict(dataset_gib=90.0, iterations=4)
    j = J.simulate(J.make_paper_config(configuration, app=JApp(**kw),
                                       seed=3, record_trace=True,
                                       hpcc_duration_s=120.0))
    t = T.simulate(T.make_paper_config(configuration,
                                       app=IterativeAppSpec(**kw), seed=3,
                                       record_trace=True,
                                       hpcc_duration_s=120.0))
    _same_result(j, t)
    assert (t.trace is not None) == (configuration == 3)


def test_cache_parity_config_equals_jax():
    j = J.simulate(J.make_cache_parity_config(iterations=4))
    t = T.simulate(T.make_cache_parity_config(iterations=4))
    _same_result(j, t)


# ---- the paper's gates on the port's own run ---------------------------

@pytest.fixture(scope="module")
def paper_results():
    return T.run_paper_experiment()


def test_headline_speedups(paper_results):
    d = paper_results
    s1 = d[1].app_runtime_s / d[3].app_runtime_s
    s2 = d[2].app_runtime_s / d[3].app_runtime_s
    # paper: 5.1x over Spark(45GB), 3.8x over Spark(20)/Alluxio(25)
    assert 4.3 <= s1 <= 6.2, s1
    assert 3.0 <= s2 <= 4.6, s2


def test_near_upper_bound(paper_results):
    d = paper_results
    assert d[3].app_runtime_s / d[4].app_runtime_s <= 1.35


def test_hit_ratios(paper_results):
    d = paper_results
    # paper: 'up to 75%' dynamic vs 'at most 31%' static
    assert 0.70 <= d[3].hit_ratio <= 0.90
    assert 0.25 <= d[2].hit_ratio <= 0.42
    assert d[3].hit_ratio > d[2].hit_ratio + 0.3


def test_config1_vs_config2_ratio(paper_results):
    d = paper_results
    ratio = d[1].app_runtime_s / d[2].app_runtime_s
    assert 1.15 <= ratio <= 1.6, ratio


def test_fig7_burst_shrink_recover(paper_results):
    r = paper_results[3]
    cap = r.cap_gib
    assert cap[0] == pytest.approx(60, abs=1)
    assert cap.min() < 30                      # shrunk during burst
    assert cap[-1] > 55                        # recovered after HPCC
    assert r.peak_utilization < 1.04


def test_fig8_iterations_recover(paper_results):
    dyn = paper_results[3].iteration_times_s
    ub = paper_results[4].iteration_times_s
    assert np.mean(dyn[-3:]) <= np.mean(ub[-3:]) * 1.25
    assert max(dyn[:3]) > 2.0 * np.mean(dyn[-3:])


def test_fig6_problem_size_scaling():
    sizes = [80.0, 240.0, 400.0]
    dyn, static = [], []
    for gib in sizes:
        app = IterativeAppSpec(dataset_gib=gib, iterations=4)
        dyn.append(T.simulate(T.make_paper_config(3, app=app)).app_runtime_s)
        static.append(T.simulate(T.make_paper_config(2, app=app))
                      .app_runtime_s)
    assert dyn == sorted(dyn) and static == sorted(static)
    assert static[-1] / static[0] > 2.0 * dyn[-1] / dyn[0]


def test_recorded_trace_is_the_plane_capture(paper_results):
    """Config 3 with ``record_trace``: one interval per tick, node 0's
    grant equal to the Fig. 7 capacity timeline."""
    r = T.simulate(T.make_paper_config(3, record_trace=True,
                                       trace_capacity=100000))
    assert r.trace.n_intervals == len(r.t_s)
    np.testing.assert_array_equal(r.trace.grant[0] / GiB, r.cap_gib)
    np.testing.assert_array_equal(r.cap_gib, paper_results[3].cap_gib)


# ---- simulate_fleet ----------------------------------------------------

KNOBS = [dict(), dict(lam_grant=0.2, deadband=0.005, feedforward=0.5)]


@pytest.mark.parametrize("knobs", KNOBS, ids=["paper", "knobs"])
def test_python_engine_equals_jax_python_engine(knobs):
    ref = J.simulate_fleet(48, 200, seed=5, engine="python",
                           params=J.paper_controller_params(**knobs))
    got = T.simulate_fleet(48, 200, seed=5, engine="python", device="cpu",
                           params=T.paper_controller_params(**knobs))
    assert got == ref


def _parity(a, b):
    for k in PARITY_KEYS:
        atol = P99_ATOL if k == "p99_utilization" else 1e-5
        np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("knobs", KNOBS, ids=["paper", "knobs"])
def test_lab_engine_matches_python_engine_and_jax(knobs):
    p = T.paper_controller_params(**knobs)
    lab = T.simulate_fleet(48, 200, seed=5, params=p, engine="lab",
                           device="cpu")
    py = T.simulate_fleet(48, 200, seed=5, params=p, engine="python",
                          device="cpu")
    ref = J.simulate_fleet(48, 200, seed=5, engine="lab",
                           params=J.paper_controller_params(**knobs))
    assert lab["n_nodes"] == 48
    _parity(lab, py)
    _parity(lab, ref)


def test_fleet_scale_stability():
    m = T.simulate_fleet(n_nodes=4096, n_intervals=400, seed=1,
                         device="cpu")
    assert m["p99_utilization"] <= 1.0
    assert m["frac_intervals_over_r0"] < 0.08
    assert m["mean_utilization"] < 0.95


def test_unknown_engine_raises():
    with pytest.raises(ValueError, match="lab|python"):
        T.simulate_fleet(4, 4, engine="xla", device="cpu")


# ---- oracles -------------------------------------------------------------

def test_hit_ratio_matches_discrete_event_oracle():
    """tests/test_cacheloop.py's gate on the port: the analytic cache
    model of the sweep (plain version) reproduces the port's
    discrete-event per-key LFU hit ratio within 0.02."""
    cfg = T.make_cache_parity_config()
    oracle = T.simulate(cfg)
    assert oracle.peak_utilization < 0.9
    n_intervals = 1600
    w_gib = cfg.app.dataset_gib / cfg.n_compute
    access = cfg.app.iterations * w_gib / (n_intervals * cfg.interval_s)
    spec = ScenarioSpec(
        name="cache-parity", family="constant", n_nodes=cfg.n_compute,
        n_intervals=n_intervals, base_gib=0.0,
        offset_gib=cfg.spark_exec_gib + cfg.os_base_gib,
        amp_range=(1.0, 1.0), phase_shift=False,
        node_memory_gib=cfg.node_memory_gib,
        cache=CacheSpec(policy="lfu", reuse_skew=0.0,
                        working_set_frac=w_gib / cfg.node_memory_gib,
                        access_gibps=access, refill_gibps=access,
                        miss_penalty_s_per_gib=0.4))
    gains = GainSet.from_params(T.paper_controller_params(
        u_min=cfg.static_cache_gib * GiB, u_max=cfg.static_cache_gib * GiB))
    r = run_sweep(spec, gains, seed=0, device="cpu")
    assert abs(float(r.stats.hit_ratio[0]) - oracle.hit_ratio) <= 0.02
    assert float(r.stats.app_runtime[0]) == pytest.approx(
        oracle.app_runtime_s, rel=0.15)
    assert float(r.stats.evicted_bytes[0]) == 0.0


@pytest.mark.parametrize("name,controlled", [("limplock", True),
                                             ("spark-dag", False)])
def test_app_graph_oracle_equals_jax(name, controlled):
    js = jlab.get_scenario(name).replace(n_intervals=300)
    ts = tsc.get_scenario(name).replace(n_intervals=300)
    demand = ts.build_demand(seed=0)
    assert demand.tobytes() == js.build_demand(seed=0).tobytes()
    kw = dict(node_memory=125 * GiB, interval_s=0.1)
    ref = J.simulate_app_graph(
        js.app_graph, demand, cache=js.cache,
        params=J.paper_controller_params() if controlled else None, **kw)
    got = T.simulate_app_graph(
        ts.app_graph, demand, cache=ts.cache,
        params=T.paper_controller_params() if controlled else None, **kw)
    assert got.keys() == ref.keys()
    for k in ("makespan_s", "finished", "t_done_s"):
        assert got[k] == ref[k], k
    for k in ("stage_finish_s", "work_done_gib"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)

