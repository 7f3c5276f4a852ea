"""AppGraph over node shards that share a device, on the CPU.

Where every node shard of a gain shard is on one card, each shard runs
the whole segment in one launch and the launches meet every interval at
a per-lane barrier in device memory (``csrc/sweep.cu::barrier_min``,
``repro_torch.kernels.sweep.graph_segment_shards``).  No card here, so:

* the barrier's protocol is modelled step by step in Python (arrival
  counter, episode counter, two min slots by parity holding ``kBig -
  min`` under ``atomicMax``, the last arrival clearing the other
  parity's slot) and run under seeded random interleavings of 2-8
  parties over hundreds of episodes: every party reads each episode's
  min over all parties, and no slot is cleared before every party has
  read it;
* the route's predicate picks the segment route for shards on one device
  and the exchange for any other layout;
* the lane cap counts every shard on a device, of every gain shard;
* off the card the segment route and its kernel wrapper run their plain
  version, the exchange (``mesh.graph_exchange``), bit for bit, and a
  node-sharded sweep gives the same stats by either route.

``tests/test_torch_mesh.py`` holds both against one device and JAX.
"""

import functools
import random

import numpy as np
import pytest
import torch

from repro_torch.core.traces import GiB
from repro_torch.kernels import sweep as ks
from repro_torch.lab import fused_sweep as fs
from repro_torch.lab import mesh
from repro_torch.lab import scenarios as tsc
from repro_torch.lab.sweep import plan_specialization, run_sweep
from repro_torch.lab.tune import grid_gains

# One intra-op thread: the suite's workers share the cores, and torch's
# OpenMP threads, oversubscribed, spin-wait ~100x longer than the ops.
torch.set_num_threads(1)

K_BIG = 1 << 30          # csrc/sweep.cu kBig
ARRIVALS, DONE = 0, 1    # bar[0], bar[1]; the min slots are bar[2 + e % 2]


def _party(i, bar, values, parties, reads, cleared):
    """One party of ``barrier_min`` over ``len(values)`` episodes, a
    ``yield`` before each access to ``bar`` (each atomic, each load)."""
    for e, v in enumerate(values):
        slot = 2 + (e & 1)
        yield                                   # atomicMax(slot, kBig - v)
        bar[slot] = max(bar[slot], K_BIG - v)
        yield                                   # atomicAdd(bar, 1)
        arrived = bar[ARRIVALS]
        bar[ARRIVALS] += 1
        if arrived == parties - 1:
            yield                               # atomicExch(bar, 0)
            bar[ARRIVALS] = 0
            yield                               # clear the other parity
            other = 2 + ((e + 1) & 1)
            cleared.append((e - 1, {p for p, ep in reads if ep == e - 1}))
            bar[other] = 0
            yield                               # atomicAdd(bar + 1, 1)
            bar[DONE] += 1
        else:
            while True:
                yield                           # ld.acquire bar[1]
                if bar[DONE] > e:
                    break
        yield                                   # atomicAdd(slot, 0)
        reads[(i, e)] = K_BIG - bar[slot]


@pytest.mark.parametrize("seed", range(12))
def test_barrier_protocol_under_random_interleavings(seed):
    rng = random.Random(seed)
    parties = rng.randint(2, 8)
    episodes = rng.randint(200, 400)
    values = [[rng.randint(0, 24) for _ in range(episodes)]
              for _ in range(parties)]
    bar = [0, 0, 0, 0]
    reads, cleared = {}, []
    running = {i: _party(i, bar, values[i], parties, reads, cleared)
               for i in range(parties)}
    while running:
        i = rng.choice(list(running))
        try:
            next(running[i])
        except StopIteration:
            del running[i]
    for e in range(episodes):
        want = min(values[i][e] for i in range(parties))
        assert [reads[(i, e)] for i in range(parties)] == [want] * parties
    # each clear of episode e - 1's slot came after every party read it
    assert len(cleared) == episodes
    for e, readers in cleared:
        if e >= 0:
            assert readers == set(range(parties)), (e, readers)
    assert bar[DONE] == episodes and bar[ARRIVALS] == 0


def test_route_predicate():
    cpu, c0, c1 = (torch.device("cpu"), torch.device("cuda:0"),
                   torch.device("cuda:1"))
    assert mesh.shares_a_device((c0,) * 4)
    assert mesh.shares_a_device(("cuda:0", "cuda:0"))
    assert mesh.shares_a_device((cpu,) * 2)
    assert not mesh.shares_a_device((c0, c1))
    assert not mesh.shares_a_device((c0, c0, c1, c1))
    assert not mesh.shares_a_device((cpu, c0))


def test_the_lane_cap_counts_every_shard_on_a_device():
    c0, c1 = torch.device("cuda:0"), torch.device("cuda:1")
    assert mesh.launches_on_devices([(c0, c0), (c0, c0)]) == {c0: 4}
    assert mesh.launches_on_devices([("cuda:0",) * 4]) == {c0: 4}
    assert mesh.launches_on_devices([(c0, c0), (c1, c1)]) == {c0: 2, c1: 2}
    assert mesh.launches_on_devices([(c0, c1), (c0, c0)]) == {c0: 3, c1: 1}
    assert mesh.launches_on_devices([(c0, c0)]) == {c0: 2}


def _shard_inputs(spec, gains, n_shards, cache):
    con = fs._engine_consts(plan_specialization(gains), spec.cache,
                            spec.interval_s, 1.0, "f32", spec.app_graph)
    names = ks.state_names(con.paper_law, con.has_cache, True)
    demand = spec.build_demand(seed=4)
    work, stage, _ = fs._graph_host(spec.app_graph, spec.n_nodes)
    cols = spec.n_nodes // n_shards
    ops = []
    for j in range(n_shards):
        c = slice(j * cols, (j + 1) * cols)
        dtn, rows, lp = fs._stage(demand[c], gains, 125 * GiB, spec.cache,
                                  "f32", torch.device("cpu"))
        g = (torch.from_numpy(np.ascontiguousarray(work[:, c])),
             torch.from_numpy(stage))
        alive = fs._alive(len(gains), len(gains) - 1, torch.device("cpu"))
        ops.append((fs._init_state(lp, rows, dtn[0], con, names, g),
                    fs._zero_hist(lp), dtn, lp, rows, alive, g))
    return ops, con, names


@pytest.mark.parametrize("cache", [False, True])
def test_segment_route_equals_the_exchange(cache):
    """The segment route, its kernel wrapper and the exchange over four
    shards of the CPU, where the first two run the exchange as their
    plain version: the same state and histograms, bit for bit, and no
    kernel launched."""
    spec = tsc.get_scenario("limplock").replace(
        n_intervals=800, **({"cache": tsc.CacheSpec()} if cache else {}))
    spec = spec.replace(app_graph=spec.app_graph.replace(
        iterations=1, slow_nodes=(5,)))
    gains = grid_gains(lam=(0.3, 0.9), r0=(0.9, 0.95))
    def wrapper(shards, *args, **kw):
        ks.graph_segment_shards(*args, streams=None, xbar=None, **kw)
    out = []
    for route in (functools.partial(mesh.graph_segment, xbar=None), wrapper,
                  mesh.graph_exchange):
        ops, con, names = _shard_inputs(spec, gains, 4, cache)
        shards = [mesh.Shard(torch.device("cpu")) for _ in ops]
        states = [o[0] for o in ops]
        hists = [o[1] for o in ops]
        before = (ks.SHARD_LAUNCHES, ks.INTERVAL_LAUNCHES)
        route(shards, states, hists, *[list(x) for x in zip(*ops)][2:],
              t0=0, con=con, names=names)
        assert (ks.SHARD_LAUNCHES, ks.INTERVAL_LAUNCHES) == before
        out.append((torch.cat(states, -1), sum(hists)))
    t_done = out[0][0][names.index("t_done"), :3, 0]
    assert bool((t_done > 0).all())                  # the DAG finished
    for state, hist in out[1:]:
        assert torch.equal(out[0][0], state)
        assert torch.equal(out[0][1], hist)


def test_sweep_takes_either_route_to_the_same_stats(monkeypatch):
    """A node-sharded AppGraph sweep on the CPU runs the segment route
    (its shards share the device), which off the card is the exchange;
    with the predicate forced to another layout it runs the exchange
    alone: the same stats, bit for bit."""
    spec = tsc.get_scenario("spark-dag").replace(n_nodes=16,
                                                 n_intervals=600)
    gains = grid_gains(lam=(0.4, 1.2), r0=(0.9, 0.95))
    four = ("cpu",) * 4
    calls = []
    for route in ("graph_segment", "graph_exchange"):
        monkeypatch.setattr(mesh, route, lambda *a, _f=getattr(mesh, route),
                            **k: calls.append(_f.__name__) or _f(*a, **k))
    seg = run_sweep(spec, gains, devices=four, node_shards=4).stats
    assert calls and calls == ["graph_segment", "graph_exchange"] * (
        len(calls) // 2)
    monkeypatch.setattr(mesh, "shares_a_device", lambda devices: False)
    calls.clear()
    ex = run_sweep(spec, gains, devices=four, node_shards=4).stats
    assert set(calls) == {"graph_exchange"}
    for f in seg._fields:
        np.testing.assert_array_equal(getattr(seg, f), getattr(ex, f),
                                      err_msg=f)


def test_segment_entry_checks_its_operands():
    spec = tsc.get_scenario("limplock").replace(n_nodes=8, n_intervals=10)
    gains = grid_gains(lam=(0.5, 1.0), r0=(0.9,))
    ops, con, names = _shard_inputs(spec, gains, 2, False)
    args = [list(x) for x in zip(*ops)]
    kw = dict(t0=0, con=con, names=names, streams=None, xbar=None)
    with pytest.raises(ValueError, match="every shard needs"):
        ks.graph_segment_shards(*args[:6], args[6][:1], **kw)
    bad = [list(a) for a in args]
    bad[0][1] = bad[0][1][:, :, :2].contiguous()    # fewer nodes a shard
    with pytest.raises(ValueError, match="must be"):
        ks.graph_segment_shards(*bad, **kw)
    bad = [list(a) for a in args]
    bad[0][1] = bad[0][1].permute(2, 1, 0).contiguous().permute(2, 1, 0)
    with pytest.raises(ValueError, match="contiguous"):
        ks.graph_segment_shards(*bad, **kw)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ks.graph_segment_shards(*[[x.to("meta") for x in a] if i < 6 else
                                  [tuple(t.to("meta") for t in g)
                                   for g in a]
                                  for i, a in enumerate(args)], **kw)
