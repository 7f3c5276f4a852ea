"""The port's AppGraph carry held against the JAX package.

The same demand and gains (numpy, from the registry's seeds) go through
JAX's XLA sweep engine (what its fused engine falls back to for an
AppGraph) and through the port's plain version of the sweep kernel's
graph instance, on the CPU.  Brackets: ``stats_mismatches`` (the port's
usual ones) on every field; ``makespan`` exact without the cache, and
within ``(n_stage_rows + 1) * interval_s`` with it, the slack JAX's own
off-knife-edge test allows (the cache's hit-curve power differs from
JAX's in the last bit, C6, and a row boundary can slip an interval).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.lab as jlab
from repro.configs.dynims import PAPER_TABLE_I as J_TABLE_I
from repro.core import cluster_sim as jcs
from repro.lab import score as jscore
from repro_torch.configs.dynims import PAPER_TABLE_I
from repro_torch.convert import gainset_from_numpy
from repro_torch.core import cluster_sim as tcs
from repro_torch.core.traces import GiB
from repro_torch.kernels import sweep as ks
from repro_torch.lab import appgraph as tag
from repro_torch.lab import fused_sweep as fs
from repro_torch.lab import scenarios as tsc
from repro_torch.lab.score import FleetStats, makespan_score, stats_mismatches
from repro_torch.lab.sweep import (GainSet, plan_specialization, run_sweep,
                                   sweep_demand)
from repro_torch.lab.tune import grid_gains, halving_tune, tune_gains
from repro_torch.runtime import limplock_nodes

# One intra-op thread: the suite's workers share the cores, and torch's
# OpenMP threads, oversubscribed, spin-wait ~100x longer than the ops.
torch.set_num_threads(1)

M = 125.0 * GiB
STABILITY_FIELDS = FleetStats._fields[:10]

# tests/test_appgraph.py's graph whose rows do not align with the
# interval's advance, on a bursty trace that drives the pressure curve
OFF_EDGE = jlab.AppGraphSpec(
    stages=(jlab.StageSpec(name="map", tasks=9, task_gib=1.7,
                           barrier=False, demand_gib=3.0),
            jlab.StageSpec(name="shuffle", task_gib=5.3, demand_gib=9.0,
                           deps=("map",)),
            jlab.StageSpec(name="reduce", tasks=5, task_gib=2.9,
                           deps=("shuffle",), demand_gib=1.0)),
    iterations=3, compute_gibps=1.7, slow_nodes=(2,), slow_factor=2.3)


def _port_graph(graph):
    stages = tuple(tag.StageSpec(**dataclasses.asdict(st))
                   for st in graph.stages)
    return tag.AppGraphSpec(**{**dataclasses.asdict(graph),
                               "stages": stages})


def _port_cache(cache):
    return None if cache is None else tsc.CacheSpec(
        **dataclasses.asdict(cache))


def _port_gains(g):
    return gainset_from_numpy({f.name: getattr(g, f.name)
                               for f in dataclasses.fields(g)})


def _static(grant_gib=25.0):
    """The paper's static baseline: the grant pinned, the law inert."""
    return jlab.GainSet.from_params(jcs.paper_controller_params(
        lam=0.0, u_min=grant_gib * GiB, u_max=grant_gib * GiB))


def _dynamic():
    return jlab.GainSet.from_params(J_TABLE_I)


def _off_edge_spec():
    return jlab.get_scenario("bursty-serving").replace(
        n_nodes=6, n_intervals=900, app_graph=OFF_EDGE)


# (tag, scenario, gains, intervals kept)
CASES = [
    ("limplock-static", lambda: jlab.get_scenario("limplock"), _static, None),
    ("limplock-table1", lambda: jlab.get_scenario("limplock"), _dynamic,
     None),
    ("limplock-300", lambda: jlab.get_scenario("limplock"), _static, 300),
    ("spark-dag-static", lambda: jlab.get_scenario("spark-dag"), _static,
     None),
    ("spark-dag-table1", lambda: jlab.get_scenario("spark-dag"), _dynamic,
     None),
    ("off-edge-static", _off_edge_spec, lambda: _static(30.0), None),
    ("off-edge-grid", _off_edge_spec,
     lambda: jlab.grid_gains(J_TABLE_I, lam=(0.4, 0.9, 1.3), r0=(0.9, 0.95),
                             lam_grant=(None, 0.3)), None),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sweep_demand_matches_jax_xla_engine(case):
    _, make_spec, make_gains, keep = case
    spec, gains = make_spec(), make_gains()
    demand = np.asarray(spec.build_demand(seed=0))[:, :keep]
    ref = jlab.sweep_demand(demand, gains, node_memory=M,
                            interval_s=spec.interval_s, cache=spec.cache,
                            app_graph=spec.app_graph, engine="xla")
    got = sweep_demand(demand, _port_gains(gains), node_memory=M,
                       interval_s=spec.interval_s,
                       cache=_port_cache(spec.cache),
                       app_graph=_port_graph(spec.app_graph), device="cpu")
    bad = stats_mismatches(got, ref, n_samples=demand.size)
    assert bad == [], "\n".join(bad)
    if spec.cache is None:
        np.testing.assert_array_equal(got.makespan, ref.makespan)
    else:
        slack = (spec.app_graph.n_stage_rows + 1) * spec.interval_s
        diff = np.abs(got.makespan - ref.makespan)
        print(f"cache-on makespan |port - JAX| max {diff.max():.6g} s")
        assert (diff <= slack).all()


@pytest.mark.parametrize("which", ["limplock", "off-edge"])
def test_reference_makespan_copy_equals_jax(which):
    if which == "limplock":
        spec, grant_gib = jlab.get_scenario("limplock"), 25.0
    else:
        spec, grant_gib = _off_edge_spec(), 30.0
    demand = np.asarray(spec.build_demand(seed=5))
    grant = np.full(demand.shape, grant_gib * GiB)
    ref = jlab.reference_makespan(spec.app_graph, demand, M, grant,
                                  interval_s=spec.interval_s)
    got = tag.reference_makespan(_port_graph(spec.app_graph), demand, M,
                                 grant, interval_s=spec.interval_s)
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(ref[key]), err_msg=key)


def test_graph_off_keeps_the_neutral_horizon():
    spec = tsc.get_scenario("bursty-serving").replace(n_nodes=8,
                                                      n_intervals=200)
    r = run_sweep(spec, GainSet.from_params(PAPER_TABLE_I), device="cpu")
    assert float(r.stats.makespan[0]) == spec.n_intervals * spec.interval_s
    np.testing.assert_allclose(r.scores(makespan_score), -20.0, rtol=1e-6)


def test_zero_demand_graph_keeps_stability_fields_bitwise():
    p = tcs.paper_controller_params()
    demand = tsc.get_scenario("bursty-serving").replace(
        n_nodes=12, n_intervals=200).build_demand(seed=3)
    gains = grid_gains(p, lam=(0.3, 0.9), r0=(0.9, 0.95))
    ghost = tag.AppGraphSpec(
        stages=(tag.StageSpec(name="map", task_gib=3.0, barrier=False),
                tag.StageSpec(name="red", task_gib=2.0, deps=("map",))),
        iterations=2)
    kw = dict(node_memory=p.total_memory, interval_s=p.interval_s,
              device="cpu")
    off = sweep_demand(demand, gains, **kw)
    on = sweep_demand(demand, gains, app_graph=ghost, **kw)
    for f in STABILITY_FIELDS:
        np.testing.assert_array_equal(getattr(off, f), getattr(on, f),
                                      err_msg=f)
    assert not np.allclose(on.makespan, off.makespan)


def test_stage_demand_feeds_back_into_observed_pressure():
    p = tcs.paper_controller_params()
    demand = tsc.get_scenario("bursty-serving").replace(
        n_nodes=8, n_intervals=200).build_demand(seed=1)
    heavy = tag.AppGraphSpec(stages=(tag.StageSpec(
        name="shuffle", task_gib=1e6, demand_gib=20.0),))
    kw = dict(node_memory=p.total_memory, interval_s=p.interval_s,
              device="cpu")
    off = sweep_demand(demand, GainSet.from_params(p), **kw)
    on = sweep_demand(demand, GainSet.from_params(p), app_graph=heavy, **kw)
    assert float(on.mean_utilization[0]) > float(off.mean_utilization[0])


def test_chunking_is_bit_invariant():
    spec = tsc.get_scenario("spark-dag").replace(n_nodes=8, n_intervals=300)
    gains = grid_gains(tcs.paper_controller_params(), lam=(0.4, 0.9, 1.3),
                       r0=(0.9, 0.95))
    runs = [run_sweep(spec, gains, seed=4, chunk=c, device="cpu")
            for c in (None, 2, 5)]
    for other in runs[1:]:
        for f in FleetStats._fields:
            np.testing.assert_array_equal(getattr(runs[0].stats, f),
                                          getattr(other.stats, f),
                                          err_msg=f)


@pytest.mark.parametrize("cache", [False, True])
def test_segments_carry_the_finish_interval(cache):
    """The kernel settles t_done per segment (the min of the next
    interval, and one more fold at the segment's end): the plain version
    split at any interval equals one segment, DAG finished or not."""
    spec = tsc.get_scenario("limplock").replace(
        n_intervals=400, **({"cache": tsc.CacheSpec()} if cache else {}))
    graph = spec.app_graph.replace(iterations=1, slow_nodes=())
    gains = _port_gains(_static())
    con = fs._engine_consts(plan_specialization(gains), spec.cache, 0.1, 1.0,
                            "f32", graph)
    names = ks.state_names(con.paper_law, con.has_cache, True)
    demand = spec.build_demand(seed=0)
    cpu = torch.device("cpu")
    dtn, rows, lp = fs._stage(demand, gains, M, spec.cache, "f32", cpu)
    g, _ = fs._stage_graph(graph, spec.n_nodes, cpu)
    alive = fs._alive(len(gains), len(gains), cpu)
    state0 = fs._init_state(lp, rows, dtn[0], con, names, g)
    kw = dict(con=con, names=names, graph=g)
    whole, hist = ks.sweep_segment(state0, fs._zero_hist(lp), dtn, lp, rows,
                                   alive, t0=0, **kw)
    t_done = float(whole[names.index("t_done"), 0, 0])
    assert t_done > 0                              # it finished
    for cut in (1, int(t_done) - 1, int(t_done), 399):
        a, ha = ks.sweep_segment(state0, fs._zero_hist(lp), dtn[:cut], lp,
                                 rows, alive, t0=0, **kw)
        b, hb = ks.sweep_segment(a, ha, dtn[cut:], lp, rows, alive, t0=cut,
                                 **kw)
        assert torch.equal(b, whole) and torch.equal(hb, hist), cut


def test_segment_checks_the_graph_operands():
    spec = tsc.get_scenario("limplock").replace(n_intervals=10)
    gains = _port_gains(_static())
    cpu = torch.device("cpu")
    con = fs._engine_consts(plan_specialization(gains), None, 0.1, 1.0,
                            "f32", spec.app_graph)
    names = ks.state_names(con.paper_law, False, True)
    dtn, rows, lp = fs._stage(spec.build_demand(), gains, M, None, "f32",
                              cpu)
    (work, stage), _ = fs._stage_graph(spec.app_graph, spec.n_nodes, cpu)
    alive = fs._alive(1, 1, cpu)
    state0 = fs._init_state(lp, rows, dtn[0], con, names, (work, stage))
    args = (state0, fs._zero_hist(lp), dtn, lp, rows, alive)
    with pytest.raises(ValueError, match="graph operands"):
        ks.sweep_segment(*args, t0=0, con=con, names=names)
    with pytest.raises(ValueError, match="work must be"):
        ks.sweep_segment(*args, t0=0, con=con, names=names,
                         graph=(work[:, :-1], stage))
    with pytest.raises(ValueError, match="stage must be"):
        ks.sweep_segment(*args, t0=0, con=con, names=names,
                         graph=(work, stage.double()))
    with pytest.raises(ValueError, match="do not match"):
        ks.sweep_segment(*args, t0=0, con=con, names=names[:-1],
                         graph=(work, stage))


def test_fused_pressure_curve_is_xlas():
    """C11: XLA folds the curve's ``/ 0.06 * 0.35`` and ``/ 0.02 *
    2.65`` into one multiply each and contracts each segment into an
    FMA; hpl_slowdown_fused gives its bits, the source's divisions do
    not."""
    from repro_torch.lab.score import hpl_slowdown_curve
    r = np.random.default_rng(0).uniform(0.85, 1.3, 100_000) \
        .astype(np.float32)
    ref = np.asarray(jax.jit(jscore.hpl_slowdown_curve)(r))
    con = fs._engine_consts(plan_specialization(_port_gains(_static())),
                            None, 0.1, 1.0, "f32", OFF_EDGE)
    k = ks._Lifted(con, torch.device("cpu"))
    got = ks.hpl_slowdown_fused(torch.from_numpy(r), k).numpy()
    np.testing.assert_array_equal(got, ref)
    divided = hpl_slowdown_curve(torch.from_numpy(r)).numpy()
    assert (divided != ref).sum() > 1000


# ---------------------------------------------------------------------------
# The acceptance gates of tests/test_appgraph.py and BENCH_appgraph.json
# ---------------------------------------------------------------------------

def test_limplock_oracle_reads_96_seconds():
    spec = tsc.get_scenario("limplock")
    demand = spec.build_demand(seed=0)
    o = tcs.simulate_app_graph(spec.app_graph, demand, node_memory=M,
                               interval_s=spec.interval_s, params=None,
                               static_grant=25.0 * GiB)
    np.testing.assert_allclose(o["stage_finish_s"],
                               [16.0, 32.0, 48.0, 64.0, 80.0, 96.0])
    stats = sweep_demand(demand, _port_gains(_static()), node_memory=M,
                         interval_s=spec.interval_s,
                         app_graph=spec.app_graph, device="cpu")
    assert float(stats.makespan[0]) == pytest.approx(96.0, abs=0.2)


@pytest.mark.parametrize("dynamic", [False, True],
                         ids=["static-25g", "dynamic-table1"])
def test_spark_dag_within_15pct_of_discrete_event_oracle(dynamic):
    spec = tsc.get_scenario("spark-dag")
    demand = spec.build_demand(seed=0)
    gains = _port_gains(_dynamic() if dynamic else _static())
    stats = sweep_demand(demand, gains, node_memory=M,
                         interval_s=spec.interval_s, cache=spec.cache,
                         app_graph=spec.app_graph, device="cpu")
    o = tcs.simulate_app_graph(spec.app_graph, demand, node_memory=M,
                               interval_s=spec.interval_s,
                               params=PAPER_TABLE_I if dynamic else None,
                               static_grant=25.0 * GiB, cache=spec.cache)
    assert float(stats.makespan[0]) == pytest.approx(o["makespan_s"],
                                                     rel=0.15)


def test_spark_dag_dynamic_beats_static_2x_and_limplock_inflates_4x():
    spec = tsc.get_scenario("spark-dag")
    kw = dict(node_memory=M, interval_s=spec.interval_s, cache=spec.cache,
              app_graph=spec.app_graph, device="cpu")
    demand = spec.build_demand(seed=0)
    static = sweep_demand(demand, _port_gains(_static()), **kw)
    dynamic = sweep_demand(demand, _port_gains(_dynamic()), **kw)
    ratio = float(static.makespan[0]) / float(dynamic.makespan[0])
    assert ratio >= 2.0, f"emergent speedup only {ratio:.2f}x"
    assert float(makespan_score(dynamic)[0]) > float(
        makespan_score(static)[0])
    lim = tsc.get_scenario("limplock")
    healthy = lim.app_graph.replace(slow_nodes=(), slow_factor=1.0)
    r_slow = run_sweep(lim, _port_gains(_static()), device="cpu")
    r_ok = run_sweep(lim.replace(app_graph=healthy), _port_gains(_static()),
                     device="cpu")
    ratio = float(r_slow.stats.makespan[0]) / float(r_ok.stats.makespan[0])
    assert ratio == pytest.approx(4.0, rel=0.05)
    assert 3.5 <= ratio <= 4.5                     # BENCH_appgraph.json
    cg = tag.compile_graph(lim.app_graph, lim.n_nodes)
    per_node_s = cg.work_gib.sum(axis=0) / lim.app_graph.compute_gibps
    assert limplock_nodes(per_node_s) == [0]


# ---------------------------------------------------------------------------
# Tuning on makespan
# ---------------------------------------------------------------------------

def _same_gains(a, b):
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in ("r0", "lam", "lam_grant", "u_min", "u_max",
                         "deadband", "feedforward"))


@pytest.mark.parametrize("method", ["halving", "grid", "random"])
def test_tuners_on_makespan_make_jaxs_decisions(method):
    jspec = jlab.get_scenario("spark-dag").replace(n_nodes=8,
                                                   n_intervals=400)
    tspec = tsc.get_scenario("spark-dag").replace(n_nodes=8,
                                                  n_intervals=400)
    if method == "halving":
        a = jlab.halving_tune(jspec, budget=64, objective="makespan")
        b = halving_tune(tspec, budget=64, objective="makespan",
                         device="cpu")
        assert [r["horizon"] for r in b.rounds] == \
            [r["horizon"] for r in a.rounds]
        assert [r["n_candidates"] for r in b.rounds] == \
            [r["n_candidates"] for r in a.rounds]
    else:
        a = jlab.tune_gains(jspec, method=method, budget=8,
                            objective="makespan", seed=0)
        b = tune_gains(tspec, method=method, budget=8, objective="makespan",
                       seed=0, device="cpu")
    assert _same_gains(a.sweep.gains, b.sweep.gains)   # survivors
    assert dataclasses.asdict(a.params) == dataclasses.asdict(b.params)
    assert b.score >= b.baseline_score
    np.testing.assert_allclose(b.sweep.scores(),
                               -np.asarray(b.sweep.stats.makespan))


# ---------------------------------------------------------------------------
# Co-residency of the multi-block route
# ---------------------------------------------------------------------------

def test_coresident_lane_planner():
    # one block holds the lane: no barrier between blocks, no limit
    assert ks.coresident_lanes(2048, False, 1, 1) is None
    assert ks.coresident_lanes(1024, True, 1, 1) is None
    # 4096 nodes: one cluster a lane, which only has to be resident as a
    # whole: no limit
    assert ks.coresident_lanes(4096, False, 13, 132) is None
    assert ks.coresident_lanes(4096, True, 8, 132) is None
    # past the largest cluster the lane's 17 blocks meet in device memory
    assert ks.coresident_lanes(32769, False, 2, 132, 16) == 2 * 132 // 17
    with pytest.raises(ValueError, match="co-resident"):
        ks.coresident_lanes(32769, False, 1, 16, 16)
    assert ks.coresident_lanes(16385, False, 1, 9) == 1
    assert ks.block_nodes(False) == ks.WIDE_LOOPS[False] * ks.GRAPH_THREADS
    assert ks.block_nodes(True) == ks.WIDE_LOOPS[True] * ks.GRAPH_THREADS


def _model_card(max_cluster=16):
    """A card of 132 SMs of 64K registers and threads of 128 registers,
    whose clusters pack without loss."""
    def per_sm(threads):
        return 65536 // (128 * threads)
    return ks.GraphLimits(max_cluster, 132, per_sm,
                          lambda threads, blocks: per_sm(threads) * 132
                          // blocks)


# (nodes, cache, route, loops a thread, threads, blocks a lane) at each
# edge of the planner's routes on _model_card: the largest one-warp
# lane of one loop and one node more, the largest one-warp lane of the
# wide loops and one more, the largest one-block lane and one more, a
# tie between block sizes (the smaller wins), 4096 nodes, the largest
# cluster of the smaller blocks and one node more (the larger blocks),
# the largest cluster and one node more (the cooperative route)
ROUTE_EDGES = [
    (32, False, "warp", 1, 32, 1), (33, False, "warp", 4, 32, 1),
    (128, False, "warp", 4, 32, 1), (129, False, "block", 4, 64, 1),
    (1024, False, "block", 4, 256, 1), (1025, False, "cluster", 4, 160, 2),
    (2048, False, "cluster", 4, 256, 2), (4096, False, "cluster", 4, 256, 4),
    (16384, False, "cluster", 4, 256, 16),
    (16385, False, "cluster", 4, 480, 9),
    (32768, False, "cluster", 4, 512, 16),
    (32769, False, "cooperative", 4, 512, 17),
    (32, True, "warp", 1, 32, 1), (33, True, "warp", 2, 32, 1),
    (64, True, "warp", 2, 32, 1), (65, True, "block", 2, 64, 1),
    (512, True, "block", 2, 256, 1), (513, True, "cluster", 2, 160, 2),
    (4096, True, "cluster", 2, 256, 8),
    (8192, True, "cluster", 2, 256, 16), (8193, True, "cluster", 2, 480, 9),
    (16384, True, "cluster", 2, 512, 16),
    (16385, True, "cooperative", 2, 512, 17),
]


@pytest.mark.parametrize("edge", ROUTE_EDGES, ids=str)
def test_graph_route_at_each_routes_edge(edge):
    n_nodes, cache, name, loops, threads, blocks = edge
    route = ks.graph_route(n_nodes, cache, _model_card())
    assert (route.name, route.loops, route.threads, route.blocks) == \
        (name, loops, threads, blocks)
    # the kernel's own count of blocks: ceil(N / (loops * threads))
    per_block = route.loops * route.threads
    assert -(-n_nodes // per_block) == route.blocks
    assert route.threads % 32 == 0 and route.threads <= ks.GRAPH_THREADS
    assert route.cluster == (1 if route.cooperative else route.blocks)
    assert (route.lanes is None) == (not route.cooperative)
    if route.cooperative:
        assert route.lanes == 132 // route.blocks
    # a card that schedules portable clusters only takes the cooperative
    # route past 8 blocks of the larger size
    portable = ks.graph_route(n_nodes, cache, _model_card(8))
    assert portable.cooperative == (-(-n_nodes // ks.block_nodes(cache))
                                    > 8)


def test_graph_route_takes_the_block_size_the_card_holds_most_of():
    """At 4096 nodes the card holds 66 clusters of two 512-thread blocks
    but 62 of four 256-thread ones: the larger blocks, so 64 lanes run at
    once; a shape it cannot hold at all is not taken."""
    base = _model_card()
    holds = {(512, 2): 66, (256, 4): 62}
    card = base._replace(clusters=lambda t, b: holds.get((t, b), 0))
    assert ks.graph_route(4096, False, card)[:3] == (4, 512, 2)
    card = base._replace(clusters=lambda t, b: 0 if t == 512 else 30)
    assert ks.graph_route(4096, False, card)[:3] == (4, 256, 4)
    with pytest.raises(ValueError, match="holds no cluster"):
        ks.graph_route(4096, False, base._replace(clusters=lambda t, b: 0))
