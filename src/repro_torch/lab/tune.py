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
  host from the final lanes' stats.  A scenario with an AppGraph runs
  the reference's host-side rounds instead, each a fresh
  :func:`~repro_torch.lab.sweep.run_sweep` at its horizon.

* :func:`tune_portfolio` -- multi-scenario tuning: one gain set scored
  across a scenario list, aggregated worst-case (default) or mean.

The baseline gains are always scored on the full horizon beside the
candidates, so a tuned result never scores below them on the tuning
scenario.

**ReplayLoop** closes the loop on live deployments:
:func:`retune_online` snapshots a running ``MemoryPlane``'s
:class:`~repro_torch.core.plane.TraceRecorder`, fits the capture into a
``"replay"`` scenario (:meth:`ScenarioSpec.from_capture`), runs
:func:`halving_tune` on it in a background thread -- on a CUDA stream of
its own, so its readbacks never wait for work a serving engine queued on
the default stream -- and, when the winner beats the currently deployed
gains on the replayed workload, atomically hot-swaps the tuned
:class:`ControllerParams` into the still-running plane at an interval
boundary.  The plane's action history is epoch-stamped, so the swap is
auditable: no interval is dropped or duplicated.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..configs.dynims import PAPER_TABLE_I
from ..core.control import ControllerParams
from ..device import DeviceLike, resolve_device
from .fused_sweep import halving_sweep
from .scenarios import ScenarioSpec, get_scenario
from .score import (FleetStats, default_score, makespan_score,
                    runtime_score, stats_to_dict)
from .sweep import (DevicesLike, GainSet, SweepResult, resolve_devices,
                    run_sweep)

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
    devices: DevicesLike = None,
    node_shards: int = 1,
    device: DeviceLike = None,
) -> TuneResult:
    """Search gains for ``scenario`` and return the winner.

    ``method`` is ``"grid"`` (a paper-law lam x r0 plane plus the
    beyond-paper variants, at least ``budget`` points), ``"random"``
    (exactly ``budget`` points) or ``"halving"`` (:func:`halving_tune`);
    ``gains`` brings your own candidates.  The baseline
    (``base_params``, default paper Table I) is scored on the full
    horizon beside the candidates.  ``devices`` and ``node_shards``
    shard the sweep (:func:`~repro_torch.lab.sweep.sweep_demand`).
    """
    objective = resolve_objective(objective or default_score)
    base = base_params or PAPER_TABLE_I
    if method == "halving":
        return halving_tune(scenario, base_params=base, gains=gains,
                            budget=budget, seed=seed, objective=objective,
                            devices=devices, node_shards=node_shards,
                            device=device)
    if gains is None:
        gains = _default_candidates(method, budget, base, seed)
    candidates = gains.concat(GainSet.from_params(base))
    result = run_sweep(scenario, candidates, seed=seed, chunk=chunk,
                       objective=objective, devices=devices,
                       node_shards=node_shards, device=device)
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
    devices: DevicesLike = None,
    node_shards: int = 1,
    device: DeviceLike = None,
) -> TuneResult:
    """Successive-halving gain search, run in-scan on the device.

    Every candidate is scored on the scenario's first ``rounds[0] * T``
    intervals; the top ``keep`` fraction (at least ``min_survivors``)
    promotes to the next horizon, and only the last round pays for the
    full loop.  ``result.sweep.gains`` holds the surviving candidates
    with the baseline appended last.  The final ranking is recomputed
    on the host from the final lanes' stats.

    A scenario with an ``app_graph`` runs the rounds on the host, as the
    reference's halving does for it: each round is a fresh sweep
    truncated to its horizon (the graph planes do not ride the in-scan
    schedule's lane gathers); ``devices`` and ``node_shards`` shard its
    rounds' sweeps.  The in-scan program runs on one device: with a
    layout of several it warns and takes the first (as the JAX
    package's pallas engine does).
    """
    objective = resolve_objective(objective or default_score)
    spec = get_scenario(scenario)
    base = base_params or PAPER_TABLE_I
    if gains is None:
        gains = _default_candidates("grid", budget, base, seed)
    if spec.app_graph is not None:
        return _halving_host(spec, base, gains, rounds=rounds, keep=keep,
                             min_survivors=min_survivors, seed=seed,
                             objective=objective, devices=devices,
                             node_shards=node_shards, device=device)
    hs = halving_sweep(
        spec.build_demand(seed=seed), gains, GainSet.from_params(base),
        node_memory=spec.build_node_memory(seed=seed),
        interval_s=spec.interval_s, occupancy=spec.occupancy,
        cache=spec.cache, rounds=rounds, keep=keep,
        min_survivors=min_survivors, objective=objective, devices=devices,
        node_shards=node_shards, device=device)
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


def _halving_host(spec: ScenarioSpec, base: ControllerParams,
                  gains: GainSet, *, rounds, keep, min_survivors, seed,
                  objective: Objective, devices: DevicesLike,
                  node_shards: int, device: DeviceLike) -> TuneResult:
    """Successive halving with a fresh truncated sweep per round.

    The reference's host-side loop: candidates score on the first
    ``round(T * frac)`` intervals, the best ``ceil(keep * n)`` (at
    least ``min_survivors``) promote, and the base joins, last, in the
    final full-horizon round.
    """
    fracs = sorted(set(float(f) for f in rounds))
    if not fracs or fracs[0] <= 0.0 or fracs[-1] > 1.0:
        raise ValueError("rounds must be fractions in (0, 1]")
    if fracs[-1] != 1.0:
        fracs.append(1.0)
    survivors = gains
    round_log: List[dict] = []
    for i, frac in enumerate(fracs):
        final = i == len(fracs) - 1
        horizon = max(int(round(spec.n_intervals * frac)), 1)
        if final:
            survivors = survivors.concat(GainSet.from_params(base))
        result = run_sweep(spec, survivors, seed=seed, objective=objective,
                           horizon=None if frac == 1.0 else horizon,
                           devices=devices, node_shards=node_shards,
                           device=device)
        scores = result.scores(objective)
        round_log.append({"horizon": horizon,
                          "n_candidates": len(survivors),
                          "elapsed_s": result.elapsed_s})
        if final:
            best = int(np.argmax(scores))
            return TuneResult(
                params=survivors.params_at(best, base),
                score=float(scores[best]),
                baseline_params=base,
                baseline_score=float(scores[-1]),   # base appended last
                index=best,
                sweep=result,
                rounds=round_log,
                objective=objective,
            )
        n_keep = max(int(np.ceil(len(survivors) * keep)), min_survivors)
        n_keep = min(n_keep, len(survivors))
        survivors = survivors.take(np.argsort(-scores)[:n_keep])
    raise AssertionError("unreachable")


@dataclasses.dataclass
class PortfolioResult:
    """Outcome of one multi-scenario (portfolio) tuning run."""

    params: ControllerParams          # best aggregate gains, deployable
    score: float                      # aggregated over the portfolio
    baseline_params: ControllerParams
    baseline_score: float
    index: int
    aggregate: str                    # "worst" | "mean"
    scenario_scores: Dict[str, float]      # winner's per-scenario scores
    sweeps: Dict[str, SweepResult]         # full per-scenario results

    @property
    def improvement(self) -> float:
        return self.score - self.baseline_score


def tune_portfolio(
    scenarios: Sequence[Union[str, ScenarioSpec]],
    *,
    base_params: Optional[ControllerParams] = None,
    gains: Optional[GainSet] = None,
    method: str = "grid",
    budget: int = 64,
    aggregate: str = "worst",
    seed: int = 0,
    objective: Union[None, str, Objective] = None,
    chunk: Optional[int] = None,
    devices: DevicesLike = None,
    node_shards: int = 1,
    device: DeviceLike = None,
) -> PortfolioResult:
    """One gain set scored across a scenario portfolio.

    Sweeps the same candidates over every scenario and aggregates the
    (S, G) score matrix per gain point -- ``"worst"`` (min over
    scenarios: robust gains that degrade gracefully everywhere) or
    ``"mean"``.  ``objective`` accepts the named objectives too
    (``"runtime"`` portfolio-tunes modeled app runtime across CacheLoop
    scenarios).  The baseline rides along, so the winner's aggregate
    never falls below the paper defaults across the portfolio.
    """
    objective = resolve_objective(objective or default_score)
    if not scenarios:
        raise ValueError("need at least one scenario")
    if aggregate not in ("worst", "mean"):
        raise ValueError("aggregate must be worst|mean")
    base = base_params or PAPER_TABLE_I
    if gains is None:
        gains = _default_candidates(method, budget, base, seed)
    candidates = gains.concat(GainSet.from_params(base))
    sweeps: Dict[str, SweepResult] = {}
    matrix = []
    for sc in scenarios:
        spec = get_scenario(sc)
        result = run_sweep(spec, candidates, seed=seed, chunk=chunk,
                           objective=objective, devices=devices,
                           node_shards=node_shards, device=device)
        sweeps[spec.name] = result
        matrix.append(result.scores(objective))
    matrix = np.stack(matrix)                       # (S, G)
    agg = matrix.min(axis=0) if aggregate == "worst" else matrix.mean(axis=0)
    best = int(np.argmax(agg))
    return PortfolioResult(
        params=candidates.params_at(best, base),
        score=float(agg[best]),
        baseline_params=base,
        baseline_score=float(agg[-1]),              # base appended last
        index=best,
        aggregate=aggregate,
        scenario_scores={name: float(matrix[i, best])
                         for i, name in enumerate(sweeps)},
        sweeps=sweeps,
    )


# ---------------------------------------------------------------------------
# ReplayLoop: capture -> replay -> re-tune -> hot-swap
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RetuneResult:
    """Outcome of one online re-tuning round."""

    scenario: ScenarioSpec            # the fitted replay scenario
    tune: TuneResult                  # full tuning outcome on the replay
    old_params: ControllerParams      # what the plane was running
    params: ControllerParams          # the replay winner (== tune.params)
    swapped: bool                     # did the plane adopt the winner?
    epoch: Optional[int]              # parameter epoch after the swap
    capture: object                   # the CapturedTrace that was tuned on

    @property
    def improvement(self) -> float:
        """Winner's score minus the deployed gains' score on the replay."""
        return self.tune.improvement

    def summary(self) -> str:
        verdict = (f"hot-swapped at epoch {self.epoch}" if self.swapped
                   else "kept deployed gains (no improvement on replay)")
        return (f"retune[{self.scenario.name}]: deployed "
                f"{self.tune.baseline_score:.3f} -> tuned "
                f"{self.tune.score:.3f} (+{self.improvement:.3f}); "
                f"{verdict}")


class RetuneHandle:
    """Join handle on a supervised background :func:`retune_online` round.

    Besides joining for the result, it exposes the supervisor's live
    counters: ``attempts`` (rounds started, including the first) and
    ``restarts`` (rounds restarted after a crashed attempt).
    """

    def __init__(self, thread: threading.Thread, box: dict,
                 stats: Optional[dict] = None,
                 stats_lock: Optional[threading.Lock] = None):
        # The box is written only by the supervisor thread and read
        # only after join() -- synchronized by the join, not by a lock.
        self._thread = thread
        self._box = box          # guarded-by: join(_thread)
        self._stats_lock = stats_lock or threading.Lock()
        self._stats = stats if stats is not None else {
            "attempts": 1, "restarts": 0}   # guarded-by: _stats_lock

    @property
    def done(self) -> bool:
        return not self._thread.is_alive()

    @property
    def attempts(self) -> int:
        """Rounds started so far (>= 1 once the thread runs)."""
        with self._stats_lock:
            return self._stats["attempts"]

    @property
    def restarts(self) -> int:
        """Rounds restarted after a crashed attempt."""
        with self._stats_lock:
            return self._stats["restarts"]

    def result(self, timeout: Optional[float] = None) -> RetuneResult:
        """Wait for the round and return its result (re-raising errors)."""
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("retune round still running")
        if "error" in self._box:
            raise self._box["error"]
        return self._box["result"]


def retune_online(
    plane,
    *,
    capture=None,
    name: str = "captured",
    method: str = "halving",
    budget: int = 32,
    objective: Union[None, str, Objective] = None,
    n_intervals: Optional[int] = None,
    n_nodes: Optional[int] = None,
    fit_cache: Optional[bool] = None,
    min_improvement: float = 0.0,
    swap: bool = True,
    block: bool = True,
    seed: int = 0,
    chunk: Optional[int] = None,
    restarts: int = 0,
    restart_backoff_s: float = 0.05,
    devices: DevicesLike = None,
    node_shards: int = 1,
    device: DeviceLike = None,
    **scenario_overrides,
) -> Union[RetuneResult, "RetuneHandle"]:
    """Re-tune a running ``MemoryPlane`` on its own captured workload.

    The ReplayLoop in one call: snapshot the plane's recorded telemetry
    (``plane.capture()``, or pass an explicit ``capture``), fit it into
    a ``"replay"`` scenario, search gains on it with the sweep on
    ``device`` (the card by default; ``method``/``budget``/``objective``
    as in :func:`tune_gains`, successive halving by default), and -- if
    the winner improves on the *currently deployed* parameters by more
    than ``min_improvement`` -- hot-swap it into the plane via
    ``plane.swap_params`` (atomic, interval-boundary, epoch-stamped).

    The deployed parameters are the tuning baseline, so the returned
    ``tune.score`` never falls below what the plane is already running
    on the replayed workload, and a no-improvement round swaps nothing.

    Tuning runs on a daemon thread; the plane keeps ticking while the
    search sweeps.  On a card the round's device work runs on a CUDA
    stream of its own: every thread shares the device's default stream,
    and the sweep's readbacks would otherwise wait for the steps a
    serving engine keeps queueing there.  ``block=True`` (default) joins
    and returns the :class:`RetuneResult`; ``block=False`` returns a
    :class:`RetuneHandle` immediately (``handle.result()`` joins).
    Extra keywords pass through to :meth:`ScenarioSpec.from_capture`
    (e.g. ``cache=`` to pin a hand-fitted :class:`CacheSpec`);
    ``devices`` and ``node_shards`` pass to the tuner, and the round's
    own stream is on the first device.

    **Supervision** (``restarts > 0``): a crashed round -- capture,
    sweep, or swap raising -- is restarted up to ``restarts`` times with
    exponential backoff (``restart_backoff_s * 2**attempt``, capped at
    5 s).  Each retry re-captures (when ``capture`` was not pinned) and
    re-reads the deployed params, so a restart tunes on fresh
    telemetry.  The supervisor runs entirely on its own thread and
    never holds the plane's tick lock across a round -- a wedged sweep
    cannot stall control.  Restarts are visible as ``handle.restarts``
    and, when the plane has a fault log, as ``retune-restart`` /
    ``retune-dead`` events.
    """
    if restarts < 0:
        raise ValueError("restarts must be >= 0")
    devs = (resolve_devices(devices, device) if devices is not None
            else (resolve_device(device),))
    dev = devs[0]
    tune_kw = (dict(device=dev) if devices is None
               else dict(devices=devs, node_shards=node_shards))
    if capture is None and restarts == 0:
        # Unsupervised: capture eagerly so an empty recorder raises in
        # the caller, not the round thread.
        capture = plane.capture()
    box: dict = {}
    stats = {"attempts": 0, "restarts": 0}      # guarded-by: stats_lock
    stats_lock = threading.Lock()

    def _attempt() -> RetuneResult:
        cap = capture if capture is not None else plane.capture()
        deployed = plane.params
        spec = ScenarioSpec.from_capture(
            cap, name=name, n_intervals=n_intervals, n_nodes=n_nodes,
            fit_cache=fit_cache, **scenario_overrides)
        tune = tune_gains(spec, base_params=deployed, method=method,
                          budget=budget, seed=seed, objective=objective,
                          chunk=chunk, **tune_kw)
        swapped, epoch = False, None
        if swap and tune.improvement > min_improvement:
            epoch = plane.swap_params(tune.params)
            swapped = True
        return RetuneResult(
            scenario=spec, tune=tune, old_params=deployed,
            params=tune.params, swapped=swapped, epoch=epoch, capture=cap)

    def _supervised() -> None:
        log_fault = getattr(plane, "log_fault", None)
        on_stream = (torch.cuda.stream(torch.cuda.Stream(dev))
                     if dev.type == "cuda" else contextlib.nullcontext())
        with on_stream:
            for attempt in range(restarts + 1):
                with stats_lock:
                    stats["attempts"] += 1
                try:
                    box["result"] = _attempt()
                    box.pop("error", None)       # earlier attempts' crash
                    return
                except BaseException as exc:     # surfaced via result()
                    box["error"] = exc
                    if attempt >= restarts:
                        if log_fault is not None and restarts > 0:
                            log_fault("retune-dead",
                                      detail=f"{type(exc).__name__}: {exc}")
                        return
                    with stats_lock:
                        stats["restarts"] += 1
                    if log_fault is not None:
                        log_fault("retune-restart",
                                  detail=f"attempt {attempt + 1} died: "
                                         f"{type(exc).__name__}: {exc}")
                    time.sleep(min(restart_backoff_s * (2 ** attempt), 5.0))

    thread = threading.Thread(target=_supervised, daemon=True,
                              name="retune-online")
    thread.start()
    handle = RetuneHandle(thread, box, stats, stats_lock)
    return handle.result() if block else handle
