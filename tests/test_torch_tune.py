"""The port's grid/random tuner picks what the JAX package's tuner picks.

Two reduced scenarios, one of them CacheLoop, under both registry
objectives: ``tune_gains`` must return the same argmax index and the
same ``ControllerParams`` as the JAX package (XLA engine), with scores
inside rtol 1e-5 (both rank in float32).  ``tune_portfolio`` over both
scenarios, worst-case and mean, does the same for the aggregate.
"""

import dataclasses

import numpy as np
import pytest

import repro.lab as jlab
from repro.configs.dynims import PAPER_TABLE_I as J_TABLE_I
from repro.lab.tune import _default_candidates as j_candidates
from repro_torch.configs.dynims import PAPER_TABLE_I
from repro_torch.convert import gainset_from_numpy, params_from_dict
from repro_torch.lab import scenarios as tsc
from repro_torch.lab.tune import (_default_candidates, tune_gains,
                                  tune_portfolio)
import torch

# One intra-op thread: the suite's workers share the cores, and torch's
# OpenMP threads, oversubscribed, spin-wait ~100x longer than the ops.
torch.set_num_threads(1)


def _port(g):
    return gainset_from_numpy({f.name: getattr(g, f.name)
                               for f in dataclasses.fields(g)})


def _gains():
    g = jlab.grid_gains(J_TABLE_I, lam=(0.3, 0.95, 1.6),
                        r0=(0.9, 0.935, 0.97))
    return g.concat(jlab.grid_gains(J_TABLE_I, lam=(1.6,), r0=(0.9,),
                                    lam_grant=(0.25,)))


@pytest.mark.parametrize("name,objective", [
    ("swap-storm", "default"), ("swap-storm", "runtime"),
    ("spark-iterative-cache", "default"),
    ("spark-iterative-cache", "runtime")])
def test_tune_gains_picks_the_jax_winner(name, objective):
    jspec = jlab.get_scenario(name).replace(n_nodes=12, n_intervals=150)
    tspec = tsc.get_scenario(name).replace(n_nodes=12, n_intervals=150)
    g = _gains()
    ref = jlab.tune_gains(jspec, gains=g, objective=objective, seed=1,
                          engine="xla")
    got = tune_gains(tspec, gains=_port(g), objective=objective, seed=1,
                     device="cpu")
    assert got.index == ref.index
    assert got.params == params_from_dict(dataclasses.asdict(ref.params))
    assert np.isclose(got.score, ref.score, rtol=1e-5)
    assert np.isclose(got.baseline_score, ref.baseline_score, rtol=1e-5)
    assert got.summary().splitlines()[0].startswith(f"scenario={name}")


@pytest.mark.parametrize("method,budget", [("grid", 100), ("grid", 512),
                                           ("random", 40)])
def test_default_candidates_equal_jax(method, budget):
    ref = j_candidates(method, budget, J_TABLE_I, seed=0)
    got = _default_candidates(method, budget, PAPER_TABLE_I, seed=0)
    for f in dataclasses.fields(ref):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      getattr(ref, f.name))


def test_random_method_runs_exactly_budget_plus_baseline():
    spec = tsc.get_scenario("swap-storm").replace(n_nodes=8, n_intervals=60)
    r = tune_gains(spec, method="random", budget=6, device="cpu")
    assert r.sweep.n_configs == 7
    assert r.score >= r.baseline_score
    with pytest.raises(ValueError, match="method"):
        tune_gains(spec, method="anneal", device="cpu")


@pytest.mark.parametrize("aggregate,objective", [("worst", "default"),
                                                 ("mean", "runtime")])
def test_tune_portfolio_picks_the_jax_winner(aggregate, objective):
    names = ("swap-storm", "spark-iterative-cache")
    jspecs = [jlab.get_scenario(n).replace(n_nodes=12, n_intervals=150)
              for n in names]
    tspecs = [tsc.get_scenario(n).replace(n_nodes=12, n_intervals=150)
              for n in names]
    g = _gains()
    ref = jlab.tune_portfolio(jspecs, gains=g, aggregate=aggregate,
                              objective=objective, seed=2, engine="xla")
    got = tune_portfolio(tspecs, gains=_port(g), aggregate=aggregate,
                         objective=objective, seed=2, device="cpu")
    assert got.index == ref.index and got.aggregate == aggregate
    assert got.params == params_from_dict(dataclasses.asdict(ref.params))
    assert np.isclose(got.score, ref.score, rtol=1e-5)
    assert np.isclose(got.baseline_score, ref.baseline_score, rtol=1e-5)
    assert got.scenario_scores.keys() == ref.scenario_scores.keys()
    for name, score in ref.scenario_scores.items():
        assert np.isclose(got.scenario_scores[name], score, rtol=1e-5)
    assert got.score >= got.baseline_score
    with pytest.raises(ValueError, match="aggregate"):
        tune_portfolio(tspecs, aggregate="median", device="cpu")
    with pytest.raises(ValueError, match="scenario"):
        tune_portfolio([], device="cpu")
