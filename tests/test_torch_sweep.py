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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.lab as jlab
from repro.configs.dynims import PAPER_TABLE_I as J_TABLE_I
from repro.lab import score as js
from repro.lab.pallas_sweep import pallas_sweep_demand
from repro_torch.convert import gainset_from_numpy
from repro_torch.kernels import sweep as ks
from repro_torch.lab import appgraph as tag
from repro_torch.lab import fused_sweep as fs
from repro_torch.lab import scenarios as tsc
from repro_torch.lab import score as ts
from repro_torch.lab.fused_sweep import fused_sweep_demand
from repro_torch.lab.score import FleetStats, stats_mismatches
from repro_torch.lab.sweep import (DEFAULT_CHUNK, _resolve_chunk,
                                   plan_specialization, run_sweep,
                                   sweep_demand)

N_NODES, N_STEPS = 12, 96

# Every registry scenario: the two AppGraph ones run their stage DAG
# (JAX's fused engine falls back to its XLA scan for them), and
# runtime-churn replays the demand of the runtime's fault machinery.
SCENARIOS = ("bursty-serving", "cache-churn", "failover-churn",
             "hetero-fleet", "limplock", "paper-c1-spark45",
             "paper-c2-static25", "paper-c3-dynims60", "paper-c4-nohpcc",
             "phase-replay", "runtime-churn", "spark-dag",
             "spark-iterative-cache", "swap-storm")


def _port_gains(g):
    return gainset_from_numpy({f.name: getattr(g, f.name)
                               for f in dataclasses.fields(g)})


def _port_cache(cache):
    return None if cache is None else tsc.CacheSpec(
        **dataclasses.asdict(cache))


def _port_graph(graph):
    if graph is None:
        return None
    stages = tuple(tag.StageSpec(**dataclasses.asdict(st))
                   for st in graph.stages)
    return tag.AppGraphSpec(**{**dataclasses.asdict(graph),
                               "stages": stages})


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
                              app_graph=spec.app_graph,
                              **kw.get("jax_kw", {}))
    got = fused_sweep_demand(demand, _port_gains(jgains),
                             node_memory=kw["m"], interval_s=spec.interval_s,
                             occupancy=spec.occupancy,
                             cache=_port_cache(spec.cache),
                             app_graph=_port_graph(spec.app_graph),
                             device="cpu", **kw.get("port_kw", {}))
    return ref, got


def _assert_close(ref, got, n_steps=N_STEPS, n_nodes=N_NODES):
    bad = stats_mismatches(got, ref, n_samples=n_steps * n_nodes)
    assert bad == [], "\n".join(bad)


def test_scenario_list_is_every_portable_registry_scenario():
    assert set(SCENARIOS) == set(jlab.list_scenarios())


@pytest.mark.filterwarnings("ignore:pallas_sweep_demand:RuntimeWarning")
@pytest.mark.parametrize("name", SCENARIOS)
def test_sweep_matches_jax_fused_engine(name):
    """Every scenario, mixed law set (partitioned), as declared."""
    demand, m, spec = _inputs(name)
    ref, got = _both(demand, _jax_gains("mixed"), spec, m=m)
    _assert_close(ref, got)


@pytest.mark.parametrize("name", ["swap-storm", "spark-iterative-cache",
                                  "runtime-churn", "spark-dag", "limplock"])
def test_sweep_demand_matches_jax_xla_engine(name):
    demand, m, spec = _inputs(name, seed=5)
    jg = _jax_gains("mixed")
    ref = jlab.sweep_demand(demand, jg, node_memory=m, interval_s=0.1,
                            cache=spec.cache, app_graph=spec.app_graph,
                            engine="xla")
    got = sweep_demand(demand, _port_gains(jg), node_memory=m,
                       interval_s=0.1, cache=_port_cache(spec.cache),
                       app_graph=_port_graph(spec.app_graph), device="cpu")
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


@pytest.mark.parametrize("name", ["spark-dag", "limplock"])
def test_app_graph_scenarios_run_and_match_jax(name):
    """The AppGraph scenarios sweep through run_sweep (they raised
    NotImplementedError before the carry was ported) and match JAX's
    run_sweep, makespan included."""
    jg = _jax_gains("paper")
    a = jlab.run_sweep(jlab.get_scenario(name).replace(n_intervals=20), jg,
                       seed=1)
    b = run_sweep(tsc.get_scenario(name).replace(n_intervals=20),
                  _port_gains(jg), seed=1, device="cpu")
    _assert_close(a.stats, b.stats, n_steps=20,
                  n_nodes=b.scenario.n_nodes)
    assert (b.stats.makespan > 20 * 0.1).all()     # extrapolated: unfinished


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


def _segment(name, law, cache, seed=8):
    demand, m, spec = _inputs(name, seed=seed,
                              **({} if cache else {"cache": None}))
    gains = _port_gains(_jax_gains(law))
    cspec = _port_cache(spec.cache)
    con = fs._engine_consts(plan_specialization(gains), cspec, 0.1, 1.0,
                            "f32")
    names = ks.state_names(con.paper_law, con.has_cache)
    dtn, rows, lp = fs._stage(demand, gains, m, cspec, "f32",
                              torch.device("cpu"))
    alive = fs._alive(len(gains), len(gains), torch.device("cpu"))
    state0 = fs._init_state(lp, rows, dtn[0], con, names)
    return (state0, dtn, lp, rows, alive), con, names


@pytest.mark.parametrize("law", ["paper", "mixed"])
@pytest.mark.parametrize("cache", [False, True])
def test_plain_histogram_equals_binned_fused_step_codes(law, cache):
    """The plain segment's histogram is hist_add over the codes its
    fused_step loop produces, added to the histogram handed in, and its
    p99 is JAX's quantile_from_codes over those codes."""
    (state0, dtn, lp, rows, alive), con, names = _segment(
        "cache-churn", "paper" if law == "paper" else "deadband", cache)
    t0, n_lanes = 5, lp.shape[1]
    hist0 = torch.randint(0, 3, (n_lanes, ts.HIST_BINS), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(0))
    state, hist = ks.sweep_segment(state0, hist0, dtn, lp, rows, alive,
                                   t0=t0, con=con, names=names)
    ix = {n: i for i, n in enumerate(names)}
    k = ks._Lifted(con, state0.device)
    cols = lp[:, :, None]
    wf0 = ks.warm_fraction0(cols, rows, con)[1] if con.has_cache else None
    st, codes = tuple(state0.unbind(0)), []
    for i in range(dtn.shape[0]):
        st, c = ks.fused_step(st, dtn[i], t0 + i, cols, rows, wf0, con,
                              names, ix, k)
        codes.append(c)
    codes = torch.stack(codes, dim=1)                   # (L, T, N)
    want = ts.hist_add(hist0.clone(), codes)
    assert torch.equal(hist, want)
    assert torch.equal(state, torch.stack(st))
    n = codes[0].numel()
    p99 = ts.quantile_from_hist(hist - hist0, 0.99, n)
    ref = jax.vmap(lambda c: js.quantile_from_codes(c, 0.99, n))(
        jnp.asarray(codes.numpy().reshape(n_lanes, n)))
    np.testing.assert_array_equal(p99.numpy(), np.asarray(ref))


def test_segment_checks_the_histogram():
    (state0, dtn, lp, rows, alive), con, names = _segment(
        "swap-storm", "paper", False)
    kw = dict(con=con, names=names)
    hist = fs._zero_hist(lp)
    with pytest.raises(ValueError, match="hist must be torch.int32"):
        ks.sweep_segment(state0, hist.long(), dtn, lp, rows, alive, t0=0,
                         **kw)
    with pytest.raises(ValueError, match="hist must be"):
        ks.sweep_segment(state0, hist[:-1], dtn, lp, rows, alive, t0=0,
                         **kw)
    # a lane's count reaches (t0 + T) * N by the segment's end
    t_end = -(-2**31 // N_NODES)          # the first end that can reach 2^31
    with pytest.raises(ValueError, match="overflow"):
        ks.sweep_segment(state0, hist, dtn, lp, rows, alive,
                         t0=t_end - N_STEPS, **kw)
    ks.sweep_segment(state0, hist, dtn[:1], lp, rows, alive, t0=t_end - 2,
                     **kw)


def test_auto_chunk_is_bounded_by_what_a_launch_allocates():
    """No code stream: the horizon no longer shrinks the chunk, only a
    fleet whose state planes outgrow the budget does."""
    assert _resolve_chunk(None, 64, 4096) == DEFAULT_CHUNK
    assert _resolve_chunk(None, 5, 4096) == 5
    assert _resolve_chunk(8, 64, 4096) == 8
    assert _resolve_chunk(None, 64, 1 << 20) == 1
