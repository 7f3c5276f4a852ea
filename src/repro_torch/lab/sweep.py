"""The scenario-sweep entry points: gain sets, ``sweep_demand``, ``run_sweep``.

Counterpart of ``repro/lab/sweep.py``.  A scenario's demand compiles
to a dense ``(N, T)`` array, and every gain point of a :class:`GainSet`
runs the closed loop over it; stats stream out as per-lane
:class:`~repro_torch.lab.score.FleetStats`.

The port has one engine: the fused kernel of
:mod:`repro_torch.lab.fused_sweep` (the JAX package's
``engine="pallas"``), so the ``engine=`` keyword is gone.  It runs on
the card by default (``device=None``); ``device="cpu"`` runs the
kernel's plain PyTorch version.  A scenario's ``app_graph`` (AppGraph)
runs its queue/barrier carry in the same kernel, in its graph instance,
and scores a live ``FleetStats.makespan``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from ..core.control import ControllerParams
from ..device import DeviceLike
from .appgraph import AppGraphSpec
from ..kernels.sweep import state_names
from .scenarios import CacheSpec, ScenarioSpec, get_scenario
from .score import HIST_BINS, FleetStats, default_score

# Upper bound on gain lanes per launch; the auto chunk lowers it when
# what one launch allocates per lane would exceed the budget.
DEFAULT_CHUNK = 64
LAUNCH_BUDGET_BYTES = 256 << 20
# Float32 state planes of the widest specialization (generic law, cache).
_MAX_PLANES = len(state_names(paper_law=False, has_cache=True))


@dataclasses.dataclass(frozen=True)
class GainSet:
    """``G`` candidate control-law gain points, packed as arrays.

    A :class:`ControllerParams` round-trips losslessly through
    :meth:`from_params` / :meth:`params_at`.  ``lam_grant`` equals
    ``lam`` where the gains are symmetric; capacities are bytes.
    Scalar / length-1 fields broadcast to the set's length.
    """

    r0: np.ndarray
    lam: np.ndarray
    lam_grant: np.ndarray
    u_min: np.ndarray
    u_max: np.ndarray
    deadband: np.ndarray = 0.0
    feedforward: np.ndarray = 0.0

    def __post_init__(self) -> None:
        arrays = {f.name: np.atleast_1d(np.asarray(getattr(self, f.name),
                                                   dtype=np.float64))
                  for f in dataclasses.fields(self)}
        g = max(a.shape[0] for a in arrays.values())
        sizes = {a.shape[0] for a in arrays.values()} - {1, g}
        if sizes:
            raise ValueError(f"gain arrays must share a length or be "
                             f"scalar; got lengths {sizes | {g}}")
        for name, arr in arrays.items():
            object.__setattr__(self, name,
                               np.broadcast_to(arr, (g,)).copy()
                               if arr.shape[0] != g else arr)

    def __len__(self) -> int:
        return self.r0.shape[0]

    @classmethod
    def from_params(cls, params: ControllerParams,
                    *more: ControllerParams) -> "GainSet":
        ps = (params,) + more
        return cls(
            r0=np.array([p.r0 for p in ps]),
            lam=np.array([p.lam for p in ps]),
            lam_grant=np.array([p.lam_grant if p.lam_grant is not None
                                else p.lam for p in ps]),
            u_min=np.array([p.u_min for p in ps]),
            u_max=np.array([p.u_max for p in ps]),
            deadband=np.array([p.deadband for p in ps]),
            feedforward=np.array([p.feedforward for p in ps]),
        )

    def params_at(self, i: int, base: ControllerParams) -> ControllerParams:
        """Materialize gain point ``i`` as a :class:`ControllerParams`."""
        lam = float(self.lam[i])
        lam_grant = float(self.lam_grant[i])
        return base.replace(
            r0=float(self.r0[i]), lam=lam,
            lam_grant=None if lam_grant == lam else lam_grant,
            u_min=float(self.u_min[i]), u_max=float(self.u_max[i]),
            deadband=float(self.deadband[i]),
            feedforward=float(self.feedforward[i]))

    def concat(self, other: "GainSet") -> "GainSet":
        return GainSet(*(np.concatenate([getattr(self, f.name),
                                         getattr(other, f.name)])
                         for f in dataclasses.fields(self)))

    def slice(self, lo: int, hi: int) -> "GainSet":
        return GainSet(*(getattr(self, f.name)[lo:hi]
                         for f in dataclasses.fields(self)))

    def take(self, idx: Sequence[int]) -> "GainSet":
        """Gather gain points by index (survivor promotion in halving)."""
        idx = np.asarray(idx, dtype=np.int64)
        return GainSet(*(getattr(self, f.name)[idx]
                         for f in dataclasses.fields(self)))


def _resolve_chunk(chunk: Optional[int], n_gains: int, n_nodes: int) -> int:
    """Gain lanes per launch, capped by the launch budget.

    The auto chunk never allocates more than :data:`LAUNCH_BUDGET_BYTES`
    per launch: state planes and histograms, each in and out -- a huge
    fleet degrades to one gain per launch rather than overshooting
    device memory.
    """
    if chunk is None:
        per_gain = 2 * 4 * (_MAX_PLANES * n_nodes + HIST_BINS)
        chunk = min(max(int(LAUNCH_BUDGET_BYTES // per_gain), 1),
                    DEFAULT_CHUNK)
    chunk = max(int(chunk), 1)
    return min(chunk, max(n_gains, 1))


class SweepPlan(NamedTuple):
    """The specializations one gain set runs under."""

    paper_law: bool
    unit_occupancy: bool


def paper_law_mask(gains: GainSet) -> np.ndarray:
    """Per gain point: does the specialized paper-faithful law apply?

    A point leaves the fast path only when a beyond-paper knob is
    active -- asymmetric grant gain, nonzero deadband, or slope
    feedforward.
    """
    return ((gains.feedforward == 0.0) & (gains.deadband == 0.0)
            & (gains.lam_grant == gains.lam))


def plan_specialization(gains: GainSet,
                        occupancy: float = 1.0) -> SweepPlan:
    """The specializations :func:`sweep_demand` runs ``gains`` under.

    A fully paper-faithful gain set sheds the slope state and both law
    branches.  Mixed gain sets are partitioned by
    :func:`paper_law_mask` first, so this expects one law class.
    """
    return SweepPlan(paper_law=bool(paper_law_mask(gains).all()),
                     unit_occupancy=float(occupancy) == 1.0)


def sweep_demand(
    demand: np.ndarray,
    gains: GainSet,
    *,
    node_memory: Union[float, np.ndarray],
    interval_s: float = 0.1,
    occupancy: float = 1.0,
    chunk: Optional[int] = None,
    cache: Optional[CacheSpec] = None,
    app_graph: Optional[AppGraphSpec] = None,
    horizon: Optional[int] = None,
    device: DeviceLike = None,
) -> FleetStats:
    """Sweep a raw ``(N, T)`` demand matrix over every gain point.

    Returns ``(G,)``-field stats as numpy.  ``horizon`` truncates the
    loop to the first ``horizon`` intervals; ``chunk`` bounds the gain
    lanes per launch (default: the launch budget); ``cache`` enables
    CacheLoop.  A gain set mixing paper-faithful and beyond-paper points
    is partitioned by law class, each class on its own specialization,
    and the stats are stitched back in gain order.  ``app_graph``
    co-simulates a stage DAG and streams out its ``makespan``.
    """
    from .fused_sweep import fused_sweep_demand

    return fused_sweep_demand(
        demand, gains, node_memory=node_memory, interval_s=interval_s,
        occupancy=occupancy, chunk=chunk, cache=cache, app_graph=app_graph,
        horizon=horizon, device=device)


@dataclasses.dataclass
class SweepResult:
    """Everything one sweep produced, gain-point-aligned."""

    scenario: ScenarioSpec
    gains: GainSet
    stats: FleetStats                 # (G,) numpy fields
    seed: int
    elapsed_s: float
    objective: Optional[object] = None  # score fn the sweep was run under

    @property
    def n_configs(self) -> int:
        return len(self.gains)

    @property
    def throughput(self) -> float:
        """node * interval * config closed-loop updates per second."""
        work = (self.scenario.n_nodes * self.scenario.n_intervals
                * self.n_configs)
        return work / self.elapsed_s if self.elapsed_s > 0 else float("inf")

    def scores(self, score_fn=None) -> np.ndarray:
        """Score every gain point (float32); defaults to the objective."""
        fn = score_fn or self.objective or default_score
        s = fn(self.stats)
        return s.cpu().numpy() if isinstance(s, torch.Tensor) \
            else np.asarray(s)

    def best(self, score_fn=None) -> int:
        return int(np.argmax(self.scores(score_fn)))

    def top(self, k: int = 5, score_fn=None) -> Sequence[int]:
        s = self.scores(score_fn)
        return list(np.argsort(-s)[:k])


def run_sweep(
    scenario: Union[str, ScenarioSpec],
    gains: GainSet,
    *,
    seed: int = 0,
    chunk: Optional[int] = None,
    node_memory: Optional[Union[float, np.ndarray]] = None,
    horizon: Optional[int] = None,
    objective=None,
    device: DeviceLike = None,
) -> SweepResult:
    """Compile ``scenario`` and run its closed loop over every gain.

    ``node_memory`` overrides the scenario's per-node budget (bytes);
    ``horizon`` truncates to the first ``horizon`` intervals;
    ``objective`` (a registry name or ``FleetStats -> scores``
    callable) is stored on the result for ``scores()`` / ``best()``.
    """
    if objective is not None:
        from .tune import resolve_objective
        objective = resolve_objective(objective)
    spec = get_scenario(scenario)
    demand = spec.build_demand(seed=seed)
    if horizon is not None:
        if not 1 <= horizon <= spec.n_intervals:
            raise ValueError(f"horizon must be in [1, {spec.n_intervals}]")
        demand = demand[:, :horizon]
        spec = spec.replace(n_intervals=horizon)
    m = spec.build_node_memory(seed=seed) if node_memory is None \
        else node_memory
    t0 = time.perf_counter()
    stats = sweep_demand(
        demand, gains, node_memory=m, interval_s=spec.interval_s,
        occupancy=spec.occupancy, chunk=chunk, cache=spec.cache,
        app_graph=spec.app_graph, device=device)
    elapsed = time.perf_counter() - t0
    return SweepResult(scenario=spec, gains=gains, stats=stats, seed=seed,
                       elapsed_s=elapsed, objective=objective)
