"""AppGraph: DAG-aware application co-simulation inside the scanned sweep.

A numpy-only copy of the declarations in ``repro/lab/appgraph.py``
(:class:`StageSpec`, :class:`AppGraphSpec`, :func:`compile_graph`): the
scenario registry declares ``spark-dag`` and ``limplock`` with them.
The port does not run the queue/barrier carry yet -- sweeping a
scenario with an ``app_graph`` raises ``NotImplementedError``.

CacheLoop (PR 4) priced memory pressure into a per-interval *penalty
model*: every interval pays ``interval * hpl_slowdown + misses *
miss_penalty`` and the sum is the modeled runtime.  That reproduces the
paper's 5X claim only as a weighted objective term.  AppGraph makes it
**emergent**: the application is declared as a stage DAG
(map -> shuffle -> reduce with dependency edges, per-stage task counts
and data sizes), and the sweep engine co-simulates per-node task queues
*inside* the same ``lax.scan`` that runs the control loop --

* each node advances its current stage's work queue at a rate modulated
  by that node's live memory state: the Fig.-2 swap curve stretches the
  interval, and (with a :class:`~repro_torch.lab.scenarios.CacheSpec`
  attached) cache misses and eviction churn stretch it further, so a
  starved cache *slows the queue down* instead of adding a penalty;
* barrier stages wait on the slowest node -- one limplocked node
  throttles the whole stage fleet-wide (the limplock effect: one
  node at 4x work or under swap pressure sets every node's stage
  completion);
* an active stage holds its declared shuffle/scratch memory
  (``demand_gib``), *allocated when the stage starts and released when
  it completes* -- stage transitions feed demand back into the trace the
  controller observes, closing the demand <-> pressure loop.

The score is end-to-end **makespan** (:class:`~repro_torch.lab.score.FleetStats`
``makespan``): the wall-clock at which the last node drains the last
stage.  No penalty weight is involved -- a controller that keeps caches
warm and nodes off the swap cliff finishes the DAG earlier, period.

Execution model: the declared DAG is validated and topologically
linearized at compile time (:func:`compile_graph`); per node, one stage
is active at a time, in topological order -- Spark's stage scheduling
within a job, where an executor works wave by wave.  ``barrier=True``
stages (shuffle boundaries) gate *every* node's promotion on the
fleet's slowest; ``barrier=False`` stages let each node proceed
independently (map-side pipelining).  The whole thing compiles to O(N)
carry state (stage pointer, work remaining, Kahan work-done lanes) plus
two trace-time constant vectors and one ``(S+1, N)`` work-matrix
operand, so an AppGraph sweep is still one fused XLA dispatch per gain
chunk, and ``app_graph=None`` compiles the exact pre-AppGraph program.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Tuple

import numpy as np

from ..core.traces import GiB


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One stage of the application DAG.

    Fields:
      name:       stage identifier, unique within the graph (dependency
                  edges reference it).
      tasks:      number of tasks in the stage, distributed round-robin
                  over the fleet (node ``n`` of ``N`` gets
                  ``tasks // N + (n < tasks % N)``).  ``0`` means one
                  task per node (an embarrassingly node-parallel stage).
      task_gib:   data each task processes (GiB) -- the unit of work the
                  queue drains.
      barrier:    does the stage end in a fleet-wide barrier (a shuffle
                  boundary)?  With ``True`` no node enters the next
                  stage until *every* node finished this one -- the
                  limplock coupling.  ``False`` pipelines per node.
      demand_gib: per-node memory the stage holds while active (shuffle
                  buffers, scratch): allocated the interval the node
                  enters the stage, released the interval it leaves --
                  this is the demand the controller *sees*.
      deps:       names of stages that must precede this one (validated
                  and topologically ordered by :func:`compile_graph`;
                  an empty tuple chains onto the declaration order).
    """

    name: str
    tasks: int = 0
    task_gib: float = 1.0
    barrier: bool = True
    demand_gib: float = 0.0
    deps: Tuple[str, ...] = ()

    def __post_init__(self) -> None:
        if not self.name:
            raise ValueError("stage needs a non-empty name")
        if self.tasks < 0:
            raise ValueError("tasks must be >= 0 (0 = one per node)")
        if self.task_gib <= 0.0:
            raise ValueError("task_gib must be positive")
        if self.demand_gib < 0.0:
            raise ValueError("demand_gib must be non-negative")


@dataclasses.dataclass(frozen=True)
class AppGraphSpec:
    """A declarative application DAG co-simulated by the sweep engine.

    Attached to a :class:`~repro_torch.lab.scenarios.ScenarioSpec` as
    ``app_graph=``, this turns every sweep over that scenario into a
    DAG co-simulation scored on end-to-end makespan (see the module
    docstring).  Frozen and hashable, so a graph is a value the
    compiled-sweep cache can key on.

    Fields:
      stages:        the stage DAG (:class:`StageSpec` tuple).  Declared
                     order is the tie-break; ``deps`` edges are
                     validated and topologically sorted.
      iterations:    how many times the whole DAG repeats (iterative
                     Spark jobs re-run map->shuffle->reduce per
                     iteration); the compiled stage sequence is the
                     topological order tiled ``iterations`` times.
      compute_gibps: per-node queue drain rate with no memory
                     interference (GiB of task data per wall second).
      slow_nodes:    global node indices with a compute skew (hardware
                     limplock: a degraded disk/NIC/CPU).
      slow_factor:   work multiplier on ``slow_nodes`` (2.0 = the node
                     needs twice the wall time per task).
    """

    stages: Tuple[StageSpec, ...]
    iterations: int = 1
    compute_gibps: float = 2.0
    slow_nodes: Tuple[int, ...] = ()
    slow_factor: float = 1.0

    def __post_init__(self) -> None:
        if not self.stages:
            raise ValueError("need at least one stage")
        names = [s.name for s in self.stages]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate stage names in {names}")
        if self.iterations < 1:
            raise ValueError("iterations must be >= 1")
        if self.compute_gibps <= 0.0:
            raise ValueError("compute_gibps must be positive")
        if self.slow_factor < 1.0:
            raise ValueError("slow_factor must be >= 1 (it multiplies "
                             "work; use demand for memory skew)")
        if any(i < 0 for i in self.slow_nodes):
            raise ValueError("slow_nodes are non-negative node indices")
        # Validate + topo-order eagerly so a bad DAG fails at spec
        # construction, not inside a traced sweep.
        topo_order(self.stages)

    def replace(self, **kw) -> "AppGraphSpec":
        return dataclasses.replace(self, **kw)

    @property
    def n_stage_rows(self) -> int:
        """Compiled stage-sequence length (stages x iterations)."""
        return len(self.stages) * self.iterations

    def total_work_gib(self, n_nodes: int) -> float:
        """Fleet-total task data over the full run (skew included)."""
        return float(compile_graph(self, n_nodes).work_gib.sum())


def topo_order(stages: Tuple[StageSpec, ...]) -> List[int]:
    """Topological order of ``stages`` (Kahn), declaration-order ties.

    Raises on unknown dependency names and on cycles.  A graph with no
    ``deps`` edges keeps its declaration order -- the implicit chain.
    """
    index = {s.name: i for i, s in enumerate(stages)}
    for s in stages:
        for d in s.deps:
            if d not in index:
                raise ValueError(f"stage {s.name!r} depends on unknown "
                                 f"stage {d!r}")
            if d == s.name:
                raise ValueError(f"stage {s.name!r} depends on itself")
    indeg = {i: len(set(s.deps)) for i, s in enumerate(stages)}
    out = []
    ready = sorted(i for i, d in indeg.items() if d == 0)
    while ready:
        i = ready.pop(0)
        out.append(i)
        for j, s in enumerate(stages):
            if stages[i].name in s.deps:
                indeg[j] -= s.deps.count(stages[i].name) and 1
                if indeg[j] == 0:
                    ready.append(j)
        ready.sort()
    if len(out) != len(stages):
        cyc = sorted(s.name for i, s in enumerate(stages) if i not in out)
        raise ValueError(f"dependency cycle through stages {cyc}")
    return out


class CompiledGraph(NamedTuple):
    """Numpy arrays one :class:`AppGraphSpec` compiles to for ``N`` nodes.

    All arrays have a trailing sentinel row/entry for the "done" state
    (index ``S``): zero work, zero demand, no barrier -- a finished
    node gathers neutral values forever.
    """

    work_gib: np.ndarray      # (S+1, N) f32: per-node work per stage row
    demand_bytes: np.ndarray  # (S+1,)  f32: held memory while row active
    barrier: np.ndarray       # (S+1,)  f32: 1.0 = fleet barrier at row end
    names: Tuple[str, ...]    # (S,) row -> "stage@iteration" labels

    @property
    def n_rows(self) -> int:
        return self.barrier.shape[0] - 1


def compile_graph(graph: AppGraphSpec, n_nodes: int) -> CompiledGraph:
    """Lower a stage DAG to the sweep engine's dense operands.

    Topologically linearizes the DAG, tiles it ``iterations`` times,
    and materializes per-node work (round-robin task placement,
    ``slow_nodes`` skew applied per *global* node index), per-row held
    demand, and per-row barrier flags.  Pure numpy -- runs once per
    (graph, fleet size) at trace staging time, never inside the scan.
    """
    if n_nodes < 1:
        raise ValueError("n_nodes must be >= 1")
    bad = [i for i in graph.slow_nodes if i >= n_nodes]
    if bad:
        raise ValueError(f"slow_nodes {bad} out of range for "
                         f"n_nodes={n_nodes}")
    order = topo_order(graph.stages)
    rows = [graph.stages[i] for i in order] * graph.iterations
    s_tot = len(rows)
    skew = np.ones(n_nodes, np.float64)
    if graph.slow_nodes:
        skew[list(graph.slow_nodes)] = graph.slow_factor
    work = np.zeros((s_tot + 1, n_nodes), np.float64)
    demand = np.zeros(s_tot + 1, np.float64)
    barrier = np.zeros(s_tot + 1, np.float64)
    n = n_nodes
    for j, st in enumerate(rows):
        tasks = st.tasks if st.tasks else n
        per_node = tasks // n + (np.arange(n) < tasks % n)
        work[j] = per_node * st.task_gib * skew
        demand[j] = st.demand_gib * GiB
        barrier[j] = 1.0 if st.barrier else 0.0
    names = tuple(f"{st.name}@{j // len(graph.stages)}"
                  for j, st in enumerate(rows))
    return CompiledGraph(work_gib=work.astype(np.float32),
                         demand_bytes=demand.astype(np.float32),
                         barrier=barrier.astype(np.float32),
                         names=names)
