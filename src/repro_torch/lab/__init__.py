"""ScenarioLab on PyTorch: scenarios, the fused sweep, scoring, tuning.

The names of ``repro.lab`` that the port has are exported here, each
loaded from its module on first use: the kernel module reads
``lab.score``, so importing the package must not import the sweep
(which imports the kernel module) eagerly.

* :mod:`.scenarios` -- declarative :class:`ScenarioSpec`, the registry,
  and :meth:`ScenarioSpec.from_capture` (a live capture as a replay
  scenario);
* :mod:`.sweep` / :mod:`.fused_sweep` -- :func:`run_sweep` and
  :func:`sweep_demand` over the sweep kernel;
* :mod:`.score` -- :class:`FleetStats` and the objectives;
* :mod:`.tune` -- :func:`tune_gains`, :func:`halving_tune`,
  :func:`tune_portfolio` and the ReplayLoop's :func:`retune_online`.

* :mod:`.appgraph` -- the AppGraph stage DAG (:class:`AppGraphSpec`)
  and :func:`reference_makespan`, the float64 mirror of the carry the
  sweep runs.

The JAX package's engine selection (``ENGINES``, ``XLA_DEFAULT_CHUNK``,
``CODES_BUDGET_BYTES``, ``resolve_devices``) and ``compute_fleet_stats``
have no counterpart here.
"""

import importlib

_EXPORTS = {
    "appgraph": ("AppGraphSpec", "CompiledGraph", "StageSpec",
                 "compile_graph", "reference_makespan", "topo_order"),
    "scenarios": ("CacheSpec", "ReplayTrace", "ScenarioSpec",
                  "TRACE_FAMILIES", "get_scenario", "list_scenarios",
                  "register_scenario"),
    "score": ("FleetStats", "OVER_R0_EPS", "QUANT_BINS", "QUANT_LEVELS",
              "QUANT_RANGE", "RUNTIME_WEIGHT", "SETTLE_TOL", "default_score",
              "finalize_fleet_stats", "hpl_slowdown_curve", "kahan_add",
              "makespan_score", "quantile_from_codes", "runtime_score",
              "stats_to_dict", "utilization_codes"),
    "sweep": ("GainSet", "SweepPlan", "SweepResult", "paper_law_mask",
              "plan_specialization", "run_sweep", "sweep_demand"),
    "tune": ("OBJECTIVES", "Objective", "PortfolioResult", "RetuneHandle",
             "RetuneResult", "TuneResult", "grid_gains", "halving_tune",
             "random_gains", "resolve_objective", "retune_online",
             "tune_gains", "tune_portfolio"),
}
_MODULE_OF = {name: mod for mod, names in _EXPORTS.items() for name in names}

__all__ = sorted(_MODULE_OF)


def __getattr__(name: str):
    mod = _MODULE_OF.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{mod}", __name__), name)
