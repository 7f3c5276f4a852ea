"""The port's sweep (plain PyTorch on the CPU) held against the JAX package.

The same demand and gains (numpy, from a seed) go through the JAX
package's fused engine on its CPU ``scan`` backend
(``pallas_sweep_demand``, which runs the same ``_fused_step`` as the
TPU kernel) or its XLA engine, and through the port.  Brackets are the
repo's own, applied by ``repro_torch.lab.score.stats_mismatches``:
fields at rtol 1e-4, p99 at 5e-4, the two rate fields also at atol
1/(T*N), and ``capacity_std_gib`` through its second moment.
"""

import dataclasses

import numpy as np
import pytest

import repro.lab as jlab
from repro.configs.dynims import PAPER_TABLE_I as J_TABLE_I
from repro.lab.pallas_sweep import pallas_sweep_demand
from repro_torch.convert import gainset_from_numpy
from repro_torch.lab import scenarios as tsc
from repro_torch.lab.fused_sweep import fused_sweep_demand
from repro_torch.lab.score import FleetStats, stats_mismatches
from repro_torch.lab.sweep import run_sweep, sweep_demand

N_NODES, N_STEPS = 12, 96

# Every registry scenario without an app_graph, less runtime-churn
# (its demand comes from the runtime's fault machinery; a later slice).
SCENARIOS = ("bursty-serving", "cache-churn", "failover-churn",
             "hetero-fleet", "paper-c1-spark45", "paper-c2-static25",
             "paper-c3-dynims60", "paper-c4-nohpcc", "phase-replay",
             "spark-iterative-cache", "swap-storm")


def _port_gains(g):
    return gainset_from_numpy({f.name: getattr(g, f.name)
                               for f in dataclasses.fields(g)})


def _port_cache(cache):
    return None if cache is None else tsc.CacheSpec(
        **dataclasses.asdict(cache))


def _jax_gains(law="mixed"):
    kw = dict(lam=np.linspace(0.2, 1.7, 3), r0=np.linspace(0.88, 0.97, 2))
    if law == "mixed":
        kw["lam_grant"] = (None, 0.25)
    elif law == "deadband":
        kw["deadband"] = (0.0, 0.01)
    elif law == "feedforward":
        kw["feedforward"] = (0.5,)
    return jlab.grid_gains(J_TABLE_I, **kw)


def _inputs(name, seed=3, **replace):
    spec = jlab.get_scenario(name).replace(n_nodes=N_NODES,
                                           n_intervals=N_STEPS, **replace)
    return (spec.build_demand(seed=seed), spec.build_node_memory(seed=seed),
            spec)


def _both(demand, jgains, spec, **kw):
    ref = pallas_sweep_demand(demand, jgains, node_memory=kw["m"],
                              interval_s=spec.interval_s,
                              occupancy=spec.occupancy, cache=spec.cache,
                              **kw.get("jax_kw", {}))
    got = fused_sweep_demand(demand, _port_gains(jgains),
                             node_memory=kw["m"], interval_s=spec.interval_s,
                             occupancy=spec.occupancy,
                             cache=_port_cache(spec.cache), device="cpu",
                             **kw.get("port_kw", {}))
    return ref, got


def _assert_close(ref, got, n_steps=N_STEPS, n_nodes=N_NODES):
    bad = stats_mismatches(got, ref, n_samples=n_steps * n_nodes)
    assert bad == [], "\n".join(bad)


def test_scenario_list_is_every_portable_registry_scenario():
    want = {n for n in jlab.list_scenarios()
            if jlab.get_scenario(n).app_graph is None} - {"runtime-churn"}
    assert set(SCENARIOS) == want


@pytest.mark.parametrize("name", SCENARIOS)
def test_sweep_matches_jax_fused_engine(name):
    """Every portable scenario, mixed law set (partitioned), as declared."""
    demand, m, spec = _inputs(name)
    ref, got = _both(demand, _jax_gains("mixed"), spec, m=m)
    _assert_close(ref, got)


@pytest.mark.parametrize("name", ["swap-storm", "spark-iterative-cache"])
def test_sweep_demand_matches_jax_xla_engine(name):
    demand, m, spec = _inputs(name, seed=5)
    jg = _jax_gains("mixed")
    ref = jlab.sweep_demand(demand, jg, node_memory=m, interval_s=0.1,
                            cache=spec.cache, engine="xla")
    got = sweep_demand(demand, _port_gains(jg), node_memory=m,
                       interval_s=0.1, cache=_port_cache(spec.cache),
                       device="cpu")
    _assert_close(ref, got)


@pytest.mark.parametrize("law", ["paper", "deadband", "feedforward"])
@pytest.mark.parametrize("cache", [False, True])
def test_law_variants_match(law, cache):
    """Paper law and the generic law (deadband, feedforward), cache on/off."""
    demand, m, spec = _inputs("cache-churn", seed=2,
                              **({} if cache else {"cache": None}))
    ref, got = _both(demand, _jax_gains(law), spec, m=m)
    _assert_close(ref, got)


def test_non_unit_occupancy_matches():
    demand, m, spec = _inputs("hetero-fleet", seed=4, occupancy=0.7)
    ref, got = _both(demand, _jax_gains("mixed"), spec, m=m)
    _assert_close(ref, got)


@pytest.mark.parametrize("cache", [False, True])
def test_bf16_demand_matches(cache):
    demand, m, spec = _inputs("spark-iterative-cache", seed=6,
                              **({} if cache else {"cache": None}))
    ref, got = _both(demand, _jax_gains("mixed"), spec, m=m,
                     jax_kw=dict(precision="bf16"),
                     port_kw=dict(precision="bf16"))
    _assert_close(ref, got)


def test_chunk_and_horizon_invariance():
    """Lane chunking changes no bit; horizon= equals a sliced trace."""
    demand, m, spec = _inputs("hetero-fleet", seed=1)
    g = _port_gains(_jax_gains("mixed"))
    kw = dict(node_memory=m, interval_s=0.1, device="cpu")
    whole = fused_sweep_demand(demand, g, **kw)
    for chunk in (1, 8):
        split = fused_sweep_demand(demand, g, chunk=chunk, **kw)
        for f in FleetStats._fields:
            np.testing.assert_array_equal(getattr(split, f),
                                          getattr(whole, f), err_msg=f)
    a = sweep_demand(demand, g, horizon=64, **kw)
    b = sweep_demand(demand[:, :64], g, **kw)
    for f in FleetStats._fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_run_sweep_matches_jax_run_sweep():
    jspec = jlab.get_scenario("swap-storm").replace(n_nodes=N_NODES,
                                                    n_intervals=N_STEPS)
    tspec = tsc.get_scenario("swap-storm").replace(n_nodes=N_NODES,
                                                   n_intervals=N_STEPS)
    jg = _jax_gains("mixed")
    a = jlab.run_sweep(jspec, jg, engine="pallas", seed=5,
                       objective="default")
    b = run_sweep(tspec, _port_gains(jg), seed=5, objective="default",
                  device="cpu")
    _assert_close(a.stats, b.stats)
    np.testing.assert_allclose(b.scores(), a.scores(), rtol=1e-5)
    assert a.best() == b.best()
    assert b.throughput > 0


def test_app_graph_scenarios_raise_not_implemented():
    g = _port_gains(_jax_gains("paper"))
    for name in ("spark-dag", "limplock"):
        spec = tsc.get_scenario(name).replace(n_intervals=20)
        with pytest.raises(NotImplementedError, match="app_graph|AppGraph"):
            run_sweep(spec, g, device="cpu")


def test_bad_arguments_raise():
    demand, m, spec = _inputs("swap-storm")
    g = _port_gains(_jax_gains("paper"))
    kw = dict(node_memory=m, device="cpu")
    with pytest.raises(ValueError, match="precision"):
        fused_sweep_demand(demand, g, precision="fp8", **kw)
    with pytest.raises(ValueError, match="horizon"):
        sweep_demand(demand, g, horizon=N_STEPS + 1, **kw)
    with pytest.raises(ValueError, match="occupancy"):
        sweep_demand(demand, g, occupancy=0.5, cache=tsc.CacheSpec(), **kw)
