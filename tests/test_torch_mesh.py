"""The port's sharded sweeps (``devices=``, ``node_shards=``) on the CPU.

One process drives every shard, as JAX's ``shard_map`` does; a device
named several times holds several shards, so ``("cpu",) * 4`` lays out
four shards here, the counterpart of JAX's
``--xla_force_host_platform_device_count=4``.  JAX's own mesh tests
(``tests/test_sweep_stream.py::test_sharded_sweep_matches_single_device``,
``tests/test_fleet.py::test_2d_mesh_matches_single_device``) fail on
this jax (ROADMAP C2), so the reference is the single-device run, on
both packages:

* gain shards are bit-identical to one device (lanes are independent),
  with and without CacheLoop's cache;
* node shards (2 x 2 and 1 x 4) agree with the port's one device within
  JAX's mesh tolerances (rtol 2e-4, atol 2e-3) and with JAX's
  ``devices=1`` within the tier-1 brackets (``stats_mismatches``);
  counts, maxes and the settle interval are exact;
* AppGraph's barrier crosses the node shards: the makespan and the
  finish interval are exact, the sharded segment equals the unsharded
  plain version plane for plane;
* one device runs the unsharded program whatever ``node_shards`` says,
  the argument checks raise JAX's errors, the tuners pass the layout on,
  and the one-device entries warn once.

Sizes are JAX's scripts': 64 nodes x 300 intervals x 12 gains, and
32 x 200 x 8.
"""

import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

import repro.lab as jlab
from repro.core.cluster_sim import paper_controller_params as jax_params
from repro.fleet import fleet_sweep_demand as jax_fleet_sweep_demand
from repro_torch.configs.dynims import PAPER_TABLE_I
from repro_torch.convert import gainset_from_numpy
from repro_torch.core.traces import GiB, fleet_demand_traces
from repro_torch.fleet import FleetExtras, fleet_sweep_demand
from repro_torch.kernels import sweep as ks
from repro_torch.lab import fused_sweep as fs
from repro_torch.lab import mesh
from repro_torch.lab import scenarios as tsc
from repro_torch.lab.score import FleetStats, stats_mismatches
from repro_torch.lab.sweep import (plan_specialization, resolve_devices,
                                   run_sweep, sweep_demand)
from repro_torch.lab.tune import grid_gains, halving_tune, tune_gains

# One intra-op thread: the suite's workers share the cores, and torch's
# OpenMP threads, oversubscribed, spin-wait ~100x longer than the ops.
torch.set_num_threads(1)

FOUR = ("cpu",) * 4
P = jax_params()
M = P.total_memory
IV = P.interval_s
# fields a fold over node shards leaves exact: counts over the global
# samples (integer sums in float64), maxes, the settle interval
EXACT = ("max_utilization", "frac_intervals_over_r0", "max_over_r0",
         "pressure_violation_rate", "settle_intervals")


def _jax_gains(lam, r0):
    return jlab.grid_gains(P, lam=lam, r0=r0)


def _port_gains(g):
    return gainset_from_numpy({f.name: getattr(g, f.name)
                               for f in dataclasses.fields(g)})


def _port_cache(cache):
    return None if cache is None else tsc.CacheSpec(
        **dataclasses.asdict(cache))


def _differing(a, b, fields):
    return [f for f in fields
            if not np.array_equal(getattr(a, f), getattr(b, f))]


def _close(a, b, fields, **tol):
    for f in fields:
        np.testing.assert_allclose(np.asarray(getattr(a, f)),
                                   np.asarray(getattr(b, f)), err_msg=f,
                                   **tol)


# ---- the lab sweep -----------------------------------------------------------

@pytest.mark.parametrize("cache", [False, True])
def test_gain_shards_are_bit_identical(cache):
    """tests/test_sweep_stream.py::MULTIDEVICE_SCRIPT on the port."""
    demand = fleet_demand_traces(64, 300, IV, seed=3)
    gains = _port_gains(_jax_gains((0.3, 0.6, 0.9, 1.2), (0.9, 0.93, 0.95)))
    kw = dict(node_memory=M, interval_s=IV,
              cache=tsc.get_scenario("cache-churn").cache if cache else None)
    single = sweep_demand(demand, gains, device="cpu", **kw)
    multi = sweep_demand(demand, gains, devices=FOUR, **kw)
    assert _differing(multi, single, FleetStats._fields) == []


@pytest.mark.parametrize("cache", [False, True])
@pytest.mark.parametrize("node_shards", [2, 4])
def test_node_shards_match_one_device_and_jax(node_shards, cache):
    """tests/test_fleet.py::MESH2D_SCRIPT's lab half on the port (2 x 2
    and 1 x 4 layouts), also against JAX's ``devices=1``."""
    demand = fleet_demand_traces(32, 200, IV, seed=3)
    jg = _jax_gains((0.3, 0.6, 0.9, 1.2), (0.9, 0.95))
    jcache = jlab.get_scenario("cache-churn").cache if cache else None
    kw = dict(node_memory=M, interval_s=IV, cache=_port_cache(jcache))
    single = sweep_demand(demand, _port_gains(jg), device="cpu", **kw)
    multi = sweep_demand(demand, _port_gains(jg), devices=FOUR,
                         node_shards=node_shards, **kw)
    _close(multi, single, FleetStats._fields, rtol=2e-4, atol=2e-3)
    exact = EXACT + (("app_runtime",) if cache else ())
    assert _differing(multi, single, exact) == []
    ref = jlab.sweep_demand(demand, jg, node_memory=M, interval_s=IV,
                            cache=jcache, devices=1)
    bad = stats_mismatches(multi, ref, n_samples=32 * 200)
    assert bad == [], "\n".join(bad)


def test_one_device_ignores_node_shards():
    """JAX's bit-exact fallback (tests/test_fleet.py:375): one device
    runs the unsharded program whatever node_shards asks."""
    demand = fleet_demand_traces(32, 200, IV, seed=3)
    gains = _port_gains(_jax_gains((0.3, 0.9), (0.9, 0.95)))
    kw = dict(node_memory=M, interval_s=IV)
    one = sweep_demand(demand, gains, device="cpu", **kw)
    for devices in (("cpu",), None):
        got = sweep_demand(demand, gains, devices=devices, device="cpu",
                           node_shards=4, **kw)
        assert _differing(got, one, FleetStats._fields) == []


# ---- AppGraph across node shards ---------------------------------------------

def _graph_segment_inputs(spec, graph, gains, cols=slice(None)):
    con = fs._engine_consts(plan_specialization(gains), spec.cache,
                            spec.interval_s, 1.0, "f32", graph)
    names = ks.state_names(con.paper_law, con.has_cache, True)
    demand = spec.build_demand(seed=0)
    work, stage, total = fs._graph_host(graph, spec.n_nodes)
    cpu = torch.device("cpu")
    dtn, rows, lp = fs._stage(demand[cols], gains,
                              125 * GiB, spec.cache, "f32", cpu)
    g = (torch.from_numpy(np.ascontiguousarray(work[:, cols])),
         torch.from_numpy(stage))
    alive = fs._alive(len(gains), len(gains) - 1, cpu)
    state0 = fs._init_state(lp, rows, dtn[0], con, names, g)
    return state0, dtn, lp, rows, alive, g, con, names, total


@pytest.mark.parametrize("cache", [False, True])
def test_graph_exchange_equals_the_unsharded_segment(cache):
    """The one-interval entry's plain version over 4 node shards, in two
    segments, equals the graph instance's plain version over the whole
    lane in one: every plane (t_done and the stage rows included), the
    histograms summed over the shards, and the makespans.  The slow node
    lies in the third shard: the work matrix is the whole fleet's."""
    spec = tsc.get_scenario("limplock").replace(
        n_intervals=800, **({"cache": tsc.CacheSpec()} if cache else {}))
    graph = spec.app_graph.replace(iterations=1, slow_nodes=(5,))
    gains = _port_gains(_jax_gains((0.3, 0.9, 1.5), (0.9, 0.95)))
    state0, dtn, lp, rows, alive, g, con, names, total = \
        _graph_segment_inputs(spec, graph, gains)
    whole, hist = ks.sweep_segment(state0, fs._zero_hist(lp), dtn, lp, rows,
                                   alive, t0=0, con=con, names=names,
                                   graph=g)
    t_done = whole[names.index("t_done"), :5, 0]
    assert bool((t_done > 0).all())                    # every lane finished
    shards = [mesh.Shard(torch.device("cpu")) for _ in range(4)]
    cols = [slice(2 * j, 2 * j + 2) for j in range(4)]
    parts = [_graph_segment_inputs(spec, graph, gains, c) for c in cols]
    states = [p[0].clone() for p in parts]
    hists = [fs._zero_hist(lp) for _ in parts]
    before = ks.INTERVAL_LAUNCHES
    for lo, hi in ((0, 250), (250, 800)):
        mesh.graph_exchange(shards, states, hists,
                            [p[1][lo:hi] for p in parts],
                            [p[2] for p in parts], [p[3] for p in parts],
                            [p[4] for p in parts], [p[5] for p in parts],
                            t0=lo, con=con, names=names)
    assert ks.INTERVAL_LAUNCHES == before      # the CPU launches nothing
    sharded = torch.cat(states, dim=-1)
    if cache:
        torch.testing.assert_close(sharded, whole, rtol=1e-6, atol=0.0)
        for name in ("sidx", "t_done"):
            i = names.index(name)
            assert torch.equal(sharded[i], whole[i]), name
    else:
        assert torch.equal(sharded, whole)
    assert torch.equal(sum(hists), hist)
    fin = [fs._finalize_lanes(st, h, lp, con, names, 800, total).makespan
           for st, h in ((sharded, sum(hists)), (whole, hist))]
    assert torch.equal(*fin)


@pytest.mark.parametrize("name,size", [("limplock", (8, 1200)),
                                       ("spark-dag", (16, 1800))])
def test_node_sharded_app_graph_makespan_is_exact(name, size):
    """limplock and spark-dag over 4 node shards: the makespan of every
    lane (finished: t_done x interval) equals one device's bit for bit,
    the rest within the brackets."""
    spec = tsc.get_scenario(name).replace(n_nodes=size[0],
                                          n_intervals=size[1])
    gains = _port_gains(_jax_gains((0.4, 1.2), (0.9, 0.95)))
    one = run_sweep(spec, gains, device="cpu").stats
    four = run_sweep(spec, gains, devices=FOUR, node_shards=4).stats
    assert (one.makespan < size[1] * spec.interval_s).all()   # finished
    assert np.array_equal(four.makespan, one.makespan)
    assert _differing(four, one, EXACT) == []
    bad = stats_mismatches(four, one, n_samples=size[0] * size[1])
    assert bad == [], "\n".join(bad)


def test_graph_interval_checks_its_exchange_operands():
    spec = tsc.get_scenario("limplock").replace(n_intervals=10)
    gains = _port_gains(_jax_gains((0.4,), (0.9,)))
    state0, dtn, lp, rows, alive, g, con, names, _ = \
        _graph_segment_inputs(spec, spec.app_graph, gains)
    hist = fs._zero_hist(lp)
    out = torch.full((lp.shape[1],), ks.LVL_EMPTY, dtype=torch.int32)
    kw = dict(k=1, t0=0, con=con, names=names, graph=g)
    with pytest.raises(ValueError, match="fleet_in"):
        ks.graph_interval(state0, hist, dtn, lp, rows, alive, out=out,
                          mode=ks.GRAPH_STEP | ks.GRAPH_PROMOTE, **kw)
    with pytest.raises(ValueError, match="needs out"):
        ks.graph_interval(state0, hist, dtn, lp, rows, alive,
                          mode=ks.GRAPH_STEP, **kw)
    with pytest.raises(ValueError, match="int32"):
        ks.graph_interval(state0, hist, dtn, lp, rows, alive,
                          out=out.long(), mode=ks.GRAPH_STEP, **kw)
    assert [m for _, m in ks.interval_schedule(2)] == [
        ks.GRAPH_STEP, ks.GRAPH_STEP | ks.GRAPH_PROMOTE,
        ks.GRAPH_PROMOTE | ks.GRAPH_ROWS, ks.GRAPH_CLOSE]


# ---- the fleet sweep -----------------------------------------------------------

def _fleet_problem():
    rng = np.random.default_rng(0)
    demand = rng.uniform(10.0, 45.0, (3, 16, 120)) * GiB
    kw = dict(node_memory=M, weights=np.array([3.0, 1.5, 1.0]),
              floors=np.array([10.0, 8.0, 0.0]) * GiB, epoch_intervals=30,
              interval_s=IV)
    return demand, kw


@pytest.mark.parametrize("node_shards", [2, 4])
def test_fleet_node_shards_match_one_device_and_jax(node_shards):
    """tests/test_fleet.py::MESH2D_SCRIPT's fleet half on the port: the
    stats and every FleetExtras field, also against JAX's devices=1."""
    demand, kw = _fleet_problem()
    jg = _jax_gains((0.3, 0.6, 0.9, 1.2), (0.9, 0.95))
    gains = _port_gains(jg)
    fs1, fe1 = fleet_sweep_demand(demand, gains, device="cpu", **kw)
    ms, me = fleet_sweep_demand(demand, gains, devices=FOUR,
                                node_shards=node_shards, **kw)
    _close(ms, fs1, FleetStats._fields, rtol=2e-4, atol=2e-3)
    _close(me, fe1, FleetExtras._fields, rtol=2e-4, atol=2e-3)
    assert _differing(ms, fs1, EXACT) == []
    # the min folds are exact
    assert _differing(me, fe1, ("conservation_slack_gib", "floor_slack_gib",
                                "tenant_budget_min_gib")) == []
    ref, ref_ex = jax_fleet_sweep_demand(demand, jg, devices=1, **kw)
    bad = stats_mismatches(ms, ref, n_samples=16 * 120)
    assert bad == [], "\n".join(bad)
    _close(me, ref_ex, FleetExtras._fields, rtol=2e-4, atol=1e-3)


def test_fleet_gain_shards_and_fallback_are_bit_identical():
    demand, kw = _fleet_problem()
    gains = _port_gains(_jax_gains((0.3, 0.6, 0.9), (0.9, 0.95)))
    one = fleet_sweep_demand(demand, gains, device="cpu", **kw)
    for layout in (dict(devices=("cpu",), node_shards=4),
                   dict(devices=FOUR)):
        got = fleet_sweep_demand(demand, gains, **layout, **kw)
        for a, b, fields in ((got[0], one[0], FleetStats._fields),
                             (got[1], one[1], FleetExtras._fields)):
            assert _differing(a, b, fields) == [], layout


# ---- the arguments -------------------------------------------------------------

def _jax_error(fn, *args, **kw):
    with pytest.raises(ValueError) as err:
        fn(*args, **kw)
    return str(err.value)


@pytest.mark.parametrize("layout,n_nodes", [
    (dict(devices=4, node_shards=0), 32),
    (dict(devices=4, node_shards=3), 32),
    (dict(devices=4, node_shards=4), 30)])
def test_layout_checks_raise_jaxs_errors(layout, n_nodes):
    demand = fleet_demand_traces(n_nodes, 20, IV, seed=1)
    jg = _jax_gains((0.5,), (0.9,))
    jdevs = [jax.devices()[0]] * layout["devices"]
    kw = dict(node_memory=M, interval_s=IV)
    want = _jax_error(jlab.sweep_demand, demand, jg, devices=jdevs,
                      node_shards=layout["node_shards"], **kw)
    got = _jax_error(sweep_demand, demand, _port_gains(jg),
                     devices=("cpu",) * layout["devices"],
                     node_shards=layout["node_shards"], **kw)
    assert got == want
    fdemand = np.stack([demand, demand])
    fkw = dict(node_memory=M, weights=np.ones(2), floors=np.zeros(2),
               epoch_intervals=10, interval_s=IV)
    want = _jax_error(jax_fleet_sweep_demand, fdemand, jg, devices=jdevs,
                      node_shards=layout["node_shards"], **fkw)
    got = _jax_error(fleet_sweep_demand, fdemand, _port_gains(jg),
                     devices=("cpu",) * layout["devices"],
                     node_shards=layout["node_shards"], **fkw)
    assert got == want


def test_resolve_devices(monkeypatch):
    cpu = torch.device("cpu")
    assert resolve_devices(device="cpu") == (cpu,)
    assert resolve_devices(FOUR) == (cpu,) * 4          # repeats are shards
    assert resolve_devices(["cpu", cpu], device="cpu") == (cpu, cpu)
    with pytest.raises(ValueError, match="one type"):
        resolve_devices(["cpu", "meta"])
    with pytest.raises(ValueError, match="disagrees"):
        resolve_devices(FOUR, device="meta")
    with pytest.raises(ValueError, match="at least one"):
        resolve_devices(())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            resolve_devices()                          # as resolve_device
        with pytest.raises(ValueError,
                           match="devices=2 but only 0 local devices exist"):
            resolve_devices(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    cuda = [torch.device("cuda", i) for i in range(3)]
    assert resolve_devices(2) == tuple(cuda[:2])
    assert resolve_devices() == tuple(cuda)
    assert resolve_devices(2, device="cuda") == tuple(cuda[:2])
    with pytest.raises(ValueError, match="disagrees"):
        resolve_devices(2, device="cuda:1")
    with pytest.raises(ValueError, match="disagrees"):
        resolve_devices(1, device="cpu")
    with pytest.raises(ValueError,
                       match="devices=4 but only 3 local devices exist"):
        resolve_devices(4)


def test_tuners_pass_the_layout_on():
    """tune_gains over two gain shards makes one device's decision, and
    the AppGraph halving's host rounds shard their sweeps."""
    one = tune_gains("swap-storm", budget=16, device="cpu")
    two = tune_gains("swap-storm", budget=16, devices=("cpu",) * 2)
    assert two.params == one.params and two.score == one.score
    assert two.index == one.index
    spec = tsc.get_scenario("spark-dag").replace(n_nodes=8, n_intervals=400)
    gains = grid_gains(PAPER_TABLE_I, lam=(0.3, 0.9, 1.5), r0=(0.9, 0.95))
    kw = dict(gains=gains, objective="makespan", rounds=(0.5, 1.0), keep=0.5,
              min_survivors=2)
    a = halving_tune(spec, device="cpu", **kw)
    b = halving_tune(spec, devices=("cpu",) * 2, node_shards=2, **kw)
    assert b.params == a.params and b.score == a.score


def test_one_device_entries_warn_once_and_run_on_the_first():
    """fused_sweep_demand and halving_sweep run on one device, as the
    JAX package's pallas engine does: a layout warns once a process."""
    demand = fleet_demand_traces(16, 50, IV, seed=2)
    gains = _port_gains(_jax_gains((0.3, 0.9), (0.9, 0.95)))
    kw = dict(node_memory=M, interval_s=IV)
    one = fs.fused_sweep_demand(demand, gains, device="cpu", **kw)
    fs._WARNED.clear()
    with pytest.warns(RuntimeWarning, match="runs on one device"):
        got = fs.fused_sweep_demand(demand, gains, devices=("cpu",) * 2,
                                    **kw)
    assert _differing(got, one, FleetStats._fields) == []
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fs.fused_sweep_demand(demand, gains, devices=("cpu",) * 2, **kw)
    with pytest.warns(RuntimeWarning) as caught:
        fs.halving_sweep(demand, gains, gains.slice(0, 1),
                         devices=("cpu",) * 2, node_shards=2,
                         rounds=(0.5, 1.0), **kw)
    said = [str(w.message) for w in caught]
    assert any("halving_sweep runs on one device" in m for m in said)
    assert any("node_shards=2" in m for m in said)
