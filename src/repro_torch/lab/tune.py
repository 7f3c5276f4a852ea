"""Gain autotuning over the fused sweep.

Counterpart of the single-scenario tuners in ``repro/lab/tune.py``:
build a gain grid (:func:`grid_gains`) or a random cloud
(:func:`random_gains`), sweep a scenario's closed loop over all of it,
and materialize the argmax as a
:class:`~repro_torch.core.control.ControllerParams`.

* ``grid`` / ``random`` -- every candidate scored on the full horizon
  (one :func:`~repro_torch.lab.sweep.run_sweep`).
* ``halving`` -- successive halving run in-scan on the device
  (:func:`~repro_torch.lab.fused_sweep.halving_sweep`): every candidate
  is scored on T/8, survivors promote through T/2 to the full horizon
  without leaving the device.  The final ranking is recomputed on the
  host from the final lanes' stats.

The baseline gains are always scored on the full horizon beside the
candidates, so a tuned result never scores below them on the tuning
scenario.  Portfolio tuning and online re-tuning are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from ..configs.dynims import PAPER_TABLE_I
from ..core.control import ControllerParams
from ..device import DeviceLike
from .fused_sweep import halving_sweep
from .scenarios import ScenarioSpec, get_scenario
from .score import (FleetStats, default_score, makespan_score,
                    runtime_score, stats_to_dict)
from .sweep import GainSet, SweepResult, run_sweep

Objective = Callable[[FleetStats], object]

# Named objectives accepted anywhere an objective goes.
OBJECTIVES: Dict[str, Objective] = {
    "default": default_score,
    "runtime": runtime_score,
    "makespan": makespan_score,
}


def resolve_objective(objective: Union[str, Objective]) -> Objective:
    """Accept a named objective or any ``FleetStats -> (G,)`` callable."""
    if callable(objective):
        return objective
    try:
        return OBJECTIVES[objective]
    except KeyError:
        raise ValueError(f"unknown objective {objective!r}; named "
                         f"objectives: {sorted(OBJECTIVES)}") from None


def grid_gains(
    base: Optional[ControllerParams] = None,
    *,
    lam: Sequence[float] = (0.1, 0.25, 0.5, 0.75, 1.0, 1.25, 1.5, 1.8),
    r0: Sequence[float] = (0.88, 0.90, 0.92, 0.94, 0.95, 0.96, 0.97, 0.98),
    lam_grant: Sequence[Optional[float]] = (None,),
    u_max: Optional[Sequence[float]] = None,
    deadband: Optional[Sequence[float]] = None,
    feedforward: Optional[Sequence[float]] = None,
) -> GainSet:
    """Cartesian product of gain axes around ``base`` (paper Table I).

    ``lam_grant=None`` entries mean symmetric gains; ``u_max`` entries
    are bytes and default to the base cap.
    """
    base = base or PAPER_TABLE_I
    u_maxes = tuple(u_max) if u_max is not None else (base.u_max,)
    deadbands = tuple(deadband) if deadband is not None else (base.deadband,)
    feedforwards = (tuple(feedforward) if feedforward is not None
                    else (base.feedforward,))
    rows = [(r, l, l if g is None else g, um, db, ff)
            for r in r0 for l in lam for g in lam_grant for um in u_maxes
            for db in deadbands for ff in feedforwards]
    arr = np.asarray(rows, dtype=np.float64)
    return GainSet(r0=arr[:, 0], lam=arr[:, 1], lam_grant=arr[:, 2],
                   u_min=np.full(len(rows), base.u_min), u_max=arr[:, 3],
                   deadband=arr[:, 4], feedforward=arr[:, 5])


def random_gains(
    n: int,
    base: Optional[ControllerParams] = None,
    *,
    seed: int = 0,
    lam_range: Sequence[float] = (0.05, 1.9),
    r0_range: Sequence[float] = (0.85, 0.98),
    asymmetric: bool = True,
) -> GainSet:
    """``n`` random gain points inside the stable region (0 < lam < 2)."""
    base = base or PAPER_TABLE_I
    rng = np.random.default_rng(seed)
    lam = rng.uniform(*lam_range, size=n)
    r0 = rng.uniform(*r0_range, size=n)
    lam_grant = rng.uniform(*lam_range, size=n) if asymmetric else lam.copy()
    return GainSet(r0=r0, lam=lam, lam_grant=lam_grant,
                   u_min=np.full(n, base.u_min), u_max=np.full(n, base.u_max),
                   deadband=base.deadband, feedforward=base.feedforward)


@dataclasses.dataclass
class TuneResult:
    """Outcome of one autotuning run."""

    params: ControllerParams          # the tuned gains, ready to deploy
    score: float
    baseline_params: ControllerParams
    baseline_score: float
    index: int                        # argmax into ``sweep.gains``
    sweep: SweepResult
    # halving only: per-round records {horizon, n_candidates, elapsed_s}
    rounds: Optional[List[dict]] = None
    objective: Objective = default_score

    @property
    def improvement(self) -> float:
        return self.score - self.baseline_score

    def best_stats(self) -> dict:
        return stats_to_dict(self.sweep.stats, self.index)

    def summary(self, k: int = 5) -> str:
        """Human-readable top-``k`` table."""
        s = self.sweep.scores(self.objective)
        lines = [f"scenario={self.sweep.scenario.name} "
                 f"configs={self.sweep.n_configs} "
                 f"throughput={self.sweep.throughput:.2e} node*intv*cfg/s",
                 f"{'rank':>4} {'r0':>6} {'lam':>6} {'lam_g':>6} "
                 f"{'u_max_gib':>9} {'score':>9}"]
        g = self.sweep.gains
        for rank, i in enumerate(self.sweep.top(k, self.objective)):
            lines.append(
                f"{rank:4d} {g.r0[i]:6.3f} {g.lam[i]:6.3f} "
                f"{g.lam_grant[i]:6.3f} {g.u_max[i] / 2**30:9.1f} "
                f"{s[i]:9.3f}")
        lines.append(
            f"baseline (r0={self.baseline_params.r0}, "
            f"lam={self.baseline_params.lam}) score="
            f"{self.baseline_score:.3f}  ->  tuned +{self.improvement:.3f}")
        return "\n".join(lines)


def _default_candidates(method: str, budget: int, base: ControllerParams,
                        seed: int) -> GainSet:
    if method == "grid":
        # ~3/4 of the budget on the paper-law (lam, r0) plane, the rest
        # split across the three beyond-paper variants (asymmetric
        # grant, deadband, feedforward).  Ceilings keep the candidate
        # count at or above ``budget``.
        k = max(int(np.ceil(np.sqrt(budget * 0.75))), 2)
        g = grid_gains(base, lam=np.linspace(0.1, 1.8, k),
                       r0=np.linspace(0.88, 0.98, k))
        kv = max(int(np.ceil(np.sqrt(max(budget - k * k, 0) / 3.0))), 2)
        vlam = np.linspace(0.3, 1.6, kv)
        vr0 = np.linspace(0.90, 0.97, kv)
        for knob in (dict(lam_grant=(0.25,)), dict(deadband=(0.005,)),
                     dict(feedforward=(0.5,))):
            g = g.concat(grid_gains(base, lam=vlam, r0=vr0, **knob))
        return g
    if method == "random":
        return random_gains(budget, base, seed=seed + 7)
    raise ValueError("method must be grid|random|halving")


def tune_gains(
    scenario: Union[str, ScenarioSpec],
    *,
    base_params: Optional[ControllerParams] = None,
    gains: Optional[GainSet] = None,
    method: str = "grid",
    budget: int = 64,
    seed: int = 0,
    objective: Union[None, str, Objective] = None,
    chunk: Optional[int] = None,
    device: DeviceLike = None,
) -> TuneResult:
    """Search gains for ``scenario`` and return the winner.

    ``method`` is ``"grid"`` (a paper-law lam x r0 plane plus the
    beyond-paper variants, at least ``budget`` points), ``"random"``
    (exactly ``budget`` points) or ``"halving"`` (:func:`halving_tune`);
    ``gains`` brings your own candidates.  The baseline
    (``base_params``, default paper Table I) is scored on the full
    horizon beside the candidates.
    """
    objective = resolve_objective(objective or default_score)
    base = base_params or PAPER_TABLE_I
    if method == "halving":
        return halving_tune(scenario, base_params=base, gains=gains,
                            budget=budget, seed=seed, objective=objective,
                            device=device)
    if gains is None:
        gains = _default_candidates(method, budget, base, seed)
    candidates = gains.concat(GainSet.from_params(base))
    result = run_sweep(scenario, candidates, seed=seed, chunk=chunk,
                       objective=objective, device=device)
    scores = result.scores(objective)
    best = int(np.argmax(scores))
    return TuneResult(
        params=candidates.params_at(best, base),
        score=float(scores[best]),
        baseline_params=base,
        baseline_score=float(scores[-1]),           # base appended last
        index=best,
        sweep=result,
        objective=objective,
    )


def halving_tune(
    scenario: Union[str, ScenarioSpec],
    *,
    base_params: Optional[ControllerParams] = None,
    gains: Optional[GainSet] = None,
    budget: int = 64,
    rounds: Sequence[float] = (0.125, 0.5, 1.0),
    keep: float = 0.25,
    min_survivors: int = 4,
    seed: int = 0,
    objective: Union[None, str, Objective] = None,
    device: DeviceLike = None,
) -> TuneResult:
    """Successive-halving gain search, run in-scan on the device.

    Every candidate is scored on the scenario's first ``rounds[0] * T``
    intervals; the top ``keep`` fraction (at least ``min_survivors``)
    promotes to the next horizon, and only the last round pays for the
    full loop.  ``result.sweep.gains`` holds the surviving candidates
    with the baseline appended last.  The final ranking is recomputed
    on the host from the final lanes' stats.
    """
    objective = resolve_objective(objective or default_score)
    spec = get_scenario(scenario)
    if spec.app_graph is not None:
        raise NotImplementedError(
            f"scenario {spec.name!r} attaches an app_graph, whose "
            "queue/barrier carry is not ported yet")
    base = base_params or PAPER_TABLE_I
    if gains is None:
        gains = _default_candidates("grid", budget, base, seed)
    hs = halving_sweep(
        spec.build_demand(seed=seed), gains, GainSet.from_params(base),
        node_memory=spec.build_node_memory(seed=seed),
        interval_s=spec.interval_s, occupancy=spec.occupancy,
        cache=spec.cache, rounds=rounds, keep=keep,
        min_survivors=min_survivors, objective=objective, device=device)
    survivors = gains.take(hs.survivor_idx).concat(
        GainSet.from_params(base))
    sweep = SweepResult(scenario=spec, gains=survivors, stats=hs.stats,
                        seed=seed, elapsed_s=hs.elapsed_s,
                        objective=objective)
    scores = sweep.scores(objective)
    best = int(np.argmax(scores))
    return TuneResult(
        params=survivors.params_at(best, base),
        score=float(scores[best]),
        baseline_params=base,
        baseline_score=float(scores[-1]),           # base appended last
        index=best,
        sweep=sweep,
        rounds=hs.rounds,
        objective=objective,
    )
