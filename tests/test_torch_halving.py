"""In-scan successive halving in the port, held against the JAX package.

The port's ``halving_sweep`` (plain PyTorch on the CPU) must select the
survivors the JAX ``halving_sweep`` selects (CPU ``scan`` backend) and
the host-side ``halving_tune`` selects, with final stats inside the
repo's brackets (``stats_mismatches``).  Ties between candidates go to
the lower index in both: ``jax.lax.top_k`` breaks them that way and the
port ranks with a stable descending sort, never ``torch.topk``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.lab as jlab
from repro.configs.dynims import PAPER_TABLE_I as J_TABLE_I
from repro.lab.pallas_sweep import halving_schedule as j_schedule
from repro.lab.pallas_sweep import halving_sweep as j_halving
from repro_torch.convert import gainset_from_numpy, params_from_dict
from repro_torch.kernels import sweep as ks
from repro_torch.lab import fused_sweep as fs
from repro_torch.lab import scenarios as tsc
from repro_torch.lab.score import HIST_BINS, stats_mismatches
from repro_torch.lab.sweep import GainSet, plan_specialization
from repro_torch.lab.tune import halving_tune

# One intra-op thread: the suite's workers share the cores, and torch's
# OpenMP threads, oversubscribed, spin-wait ~100x longer than the ops.
torch.set_num_threads(1)

N_NODES, N_STEPS = 16, 120


def _port(g):
    return gainset_from_numpy({f.name: getattr(g, f.name)
                               for f in dataclasses.fields(g)})


def _random_gains(n, seed=7):
    rng = np.random.default_rng(seed)
    return jlab.GainSet(
        r0=rng.uniform(0.85, 0.98, n), lam=rng.uniform(0.2, 1.8, n),
        lam_grant=np.full(n, 0.5), u_min=np.zeros(n),
        u_max=np.full(n, 60.0 * 2**30))


def _inputs(name, seed=5):
    spec = jlab.get_scenario(name).replace(n_nodes=N_NODES,
                                           n_intervals=N_STEPS)
    cache = None if spec.cache is None else tsc.CacheSpec(
        **dataclasses.asdict(spec.cache))
    return (spec.build_demand(seed=seed), spec.build_node_memory(seed=seed),
            spec, cache)


@pytest.mark.parametrize("name", ["swap-storm", "spark-iterative-cache"])
def test_halving_sweep_matches_jax(name):
    demand, m, spec, cache = _inputs(name)
    gains = _random_gains(12)
    base = jlab.GainSet.from_params(J_TABLE_I)
    kw = dict(node_memory=m, interval_s=0.1, min_survivors=2)
    ref = j_halving(demand, gains, base, cache=spec.cache, **kw)
    got = fs.halving_sweep(demand, _port(gains), _port(base), cache=cache,
                           device="cpu", **kw)
    np.testing.assert_array_equal(got.survivor_idx, ref.survivor_idx)
    assert [r["horizon"] for r in got.rounds] == \
        [r["horizon"] for r in ref.rounds]
    assert [r["n_candidates"] for r in got.rounds] == \
        [r["n_candidates"] for r in ref.rounds]
    bad = stats_mismatches(got.stats, ref.stats,
                           n_samples=N_STEPS * N_NODES)
    assert bad == [], "\n".join(bad)
    np.testing.assert_allclose(got.scores, ref.scores, rtol=1e-5)


def test_halving_tune_matches_host_tuner():
    """The in-scan tuner picks what the JAX host-side loop picks."""
    spec = jlab.get_scenario("swap-storm").replace(n_nodes=N_NODES,
                                                   n_intervals=160)
    gains = _random_gains(12, seed=3)
    ref = jlab.halving_tune(spec, gains=gains, seed=5, engine="xla")
    tspec = tsc.get_scenario("swap-storm").replace(n_nodes=N_NODES,
                                                   n_intervals=160)
    got = halving_tune(tspec, gains=_port(gains), seed=5, device="cpu")
    assert got.params == params_from_dict(dataclasses.asdict(ref.params))
    assert np.isclose(got.score, ref.score, rtol=1e-5)
    assert np.isclose(got.baseline_score, ref.baseline_score, rtol=1e-5)
    assert [r["n_candidates"] for r in got.rounds] == \
        [r["n_candidates"] for r in ref.rounds]


def test_ties_break_by_index_like_jax():
    """Duplicated gain points score identically; survivors must match."""
    demand, m, spec, _ = _inputs("swap-storm", seed=2)
    uniq = _random_gains(3, seed=11)
    gains = uniq.take([0, 1, 0, 2, 1, 0, 2, 1, 2])
    base = jlab.GainSet.from_params(J_TABLE_I)
    kw = dict(node_memory=m, interval_s=0.1, min_survivors=3, keep=0.3)
    ref = j_halving(demand, gains, base, **kw)
    got = fs.halving_sweep(demand, _port(gains), _port(base), device="cpu",
                           **kw)
    np.testing.assert_array_equal(got.survivor_idx, ref.survivor_idx)
    # The sort, not topk, is what holds this: on these scores
    # torch.topk may order tied lanes differently.
    s = torch.tensor([1.0, 3.0, 3.0, 2.0, 3.0])
    assert torch.sort(s, descending=True,
                      stable=True).indices[:3].tolist() == [1, 2, 4]


def test_halving_schedule_matches_jax():
    for args in [(160, 24, (0.125, 0.5, 1.0), 0.25, 4),
                 (100, 8, (0.5, 1.0), 0.5, 2), (1000, 513, (0.1,), 0.3, 4)]:
        assert fs.halving_schedule(*args) == j_schedule(*args)


@pytest.mark.parametrize("cache", [False, True])
def test_dead_lanes_write_zero_codes_and_keep_state(cache):
    """A dead lane counts no code into its histogram row and keeps its
    state; live lanes equal a run of the live lanes alone."""
    demand, m, spec, cache_spec = _inputs("spark-iterative-cache")
    cache_spec = cache_spec if cache else None
    gains = _port(_random_gains(8))
    con = fs._engine_consts(plan_specialization(gains), cache_spec, 0.1,
                            1.0, "f32")
    names = ks.state_names(con.paper_law, con.has_cache)
    dev = torch.device("cpu")
    dtn, rows, lp = fs._stage(demand, gains, m, cache_spec, "f32", dev)
    alive = fs._alive(8, 5, dev)
    state0 = fs._init_state(lp, rows, dtn[0], con, names)
    hist0 = fs._zero_hist(lp)
    state, hist = ks.sweep_segment(state0, hist0, dtn, lp, rows, alive,
                                   t0=0, con=con, names=names)
    assert hist.dtype == torch.int32 and hist.shape == (8, HIST_BINS)
    assert int(hist[5:].abs().sum()) == 0
    assert hist[:5].sum(1).tolist() == [N_STEPS * N_NODES] * 5
    assert torch.equal(state[:, 5:], state0[:, 5:])
    assert int(hist0.abs().sum()) == 0            # the input is not written
    # Live lanes are untouched by their dead neighbours.
    solo, solo_hist = ks.sweep_segment(
        state0[:, :5].contiguous(), hist0[:5], dtn, lp[:, :5].contiguous(),
        rows, fs._alive(5, 5, dev), t0=0, con=con, names=names)
    assert torch.equal(solo, state[:, :5])
    assert torch.equal(solo_hist, hist[:5])
    # A dead lane's row is carried as it came in, not reset.
    again = ks.sweep_segment(state, hist, dtn[:7], lp, rows, alive, t0=0,
                             con=con, names=names)[1]
    assert torch.equal(again[5:], hist[5:])


def test_survivor_stats_equal_a_plain_sweep_of_the_survivors():
    demand, m, spec, cache = _inputs("spark-iterative-cache", seed=4)
    gains = _port(_random_gains(12, seed=9))
    base = GainSet.from_params(params_from_dict(
        dataclasses.asdict(J_TABLE_I)))
    hs = fs.halving_sweep(demand, gains, base, node_memory=m,
                          interval_s=0.1, cache=cache, device="cpu")
    assert len(hs.scores) == len(hs.survivor_idx) + 1
    assert len(set(hs.survivor_idx.tolist())) == len(hs.survivor_idx)
    ref = fs.fused_sweep_demand(demand, gains.take(hs.survivor_idx)
                                .concat(base), node_memory=m,
                                interval_s=0.1, cache=cache, device="cpu")
    np.testing.assert_array_equal(ref.mean_utilization,
                                  hs.stats.mean_utilization)
    np.testing.assert_array_equal(ref.p99_utilization,
                                  hs.stats.p99_utilization)
