"""ChaosPlane drill: every fault family thrown at live planes.

The port of ``examples/chaos_drill.py``: the same two phases and gates,
with every plane's array backend on ``--device`` (the card by default)
and the supervised retune round's sweep there too.

Phase 1 runs a recording ``MemoryPlane`` (array backend) through a
seed-deterministic :class:`~repro_torch.runtime.chaos.ChaosSpec` covering the
full fault catalog -- sensor dropout/freeze/NaN/Inf/negative, slow
samples, node crash+rejoin, actuation raise/timeout/partial-apply, and
a ``retune-kill`` that murders the supervised online-retune round --
then audits the degradation contract:

* no grant ever exceeds ``u_max`` (or goes below ``u_min``), faulted
  telemetry or not;
* every published control action is finite -- NaN/Inf telemetry never
  reaches the law;
* per-node action epochs stay monotone through the storm;
* crashed nodes quarantine (fail-static pin) and rejoin within the
  hysteresis window once the chaos lifts;
* the supervised retune round restarts after being killed and still
  lands (or cleanly reports dead);
* the bounded FaultLog tells the whole story (written as an artifact).

Phase 2 nests the same storm one level up: a ``FleetPlane`` whose
"victim" tenant loses every node.  The victim must be quarantined at
the next arbitration epoch and squeezed to its floor (fail-static at
fleet level), the sum of live budgets must conserve at *every* tick,
and the victim must rejoin and win budget back after recovery.

    PYTHONPATH=src python -m repro_torch.launch.chaos_drill [--smoke]
        [--seed 0] [--device cpu] [--out-dir artifacts]

Exit status is nonzero if any degradation guarantee fails;
``--out-dir`` writes the fault logs and injected-fault counts as
``faultlog.json``.
"""

import argparse
import dataclasses
import json
import math
import os
import sys
import time

from ..configs.dynims import PAPER_TABLE_I
from ..core import (GiB, HealthPolicy, MemoryPlane, PlaneSpec,
                    SimulatedMonitor, StoreRegistry)
from ..core.control import ControllerParams
from ..core.plane import NodeSpec
from ..fleet import FleetPlane, FleetSpec, TenantSpec
from ..lab.tune import retune_online
from ..runtime import ChaosSpec, FaultSpec, inject

M = 125.0 * GiB
EPS = 1.0          # byte-scale tolerance on grant bounds


def build_plane(n_nodes: int, params, policy: HealthPolicy,
                record: int, device=None) -> MemoryPlane:
    """A recording plane with gently varying synthetic demand."""
    plane = MemoryPlane(PlaneSpec(params=params, backend="array",
                                  health=policy, record=record,
                                  device=device))
    for i in range(n_nodes):
        name = f"node{i}"
        plane.attach(
            name,
            SimulatedMonitor(
                name, total=M,
                usage=lambda k, ph=i: (70.0 + 20.0 * math.sin(
                    0.15 * k + 0.7 * ph)) * GiB,
                storage_used_fn=lambda nm=name: plane.capacity(nm)),
            registry=StoreRegistry(),
            u0=params.u_max)
    return plane


def chaos_schedule(n_nodes: int, start: int, span: int) -> ChaosSpec:
    """Every fault family, spread across the fleet inside one window."""
    node = lambda i: (f"node{i % n_nodes}",)
    half = span // 2
    return ChaosSpec(faults=(
        FaultSpec("dropout", nodes=node(0), start=start, duration=span,
                  probability=0.5),
        FaultSpec("freeze", nodes=node(1), start=start, duration=half),
        FaultSpec("slow-sample", nodes=node(1), start=start + half,
                  duration=4, magnitude=0.001),
        FaultSpec("nan", nodes=node(2), start=start, duration=half),
        FaultSpec("inf", nodes=node(2), start=start + half, duration=4),
        FaultSpec("negative", nodes=node(3), start=start, duration=6),
        FaultSpec("crash", nodes=node(4), start=start, duration=span),
        FaultSpec("actuate-raise", nodes=node(5), start=start,
                  duration=half),
        FaultSpec("actuate-timeout", nodes=node(5), start=start + half,
                  duration=3, magnitude=0.0),
        FaultSpec("actuate-partial", nodes=node(3), start=start + 8,
                  duration=6, magnitude=0.5),
        FaultSpec("retune-kill", start=start, duration=span),
    ), seed=0)


def audit_actions(audit, n_nodes, failures, leg):
    for i in range(n_nodes):
        acts = [a for a in audit if a.node == f"node{i}"]
        for a in acts:
            if not (math.isfinite(a.u_next) and math.isfinite(a.u_prev)):
                failures.append(f"{leg}: node{i} published a non-finite "
                                f"action (u_next={a.u_next})")
                break
        epochs = [a.epoch for a in acts]
        if any(b < a for a, b in zip(epochs, epochs[1:])):
            failures.append(f"{leg}: node{i} epochs not monotone")


def phase_memory_plane(args, failures):
    n_nodes = 6 if args.smoke else 16
    pre, span, recover = (8, 40, 40) if args.smoke else (20, 80, 60)
    params = PAPER_TABLE_I.replace(interval_s=0.01)
    policy = HealthPolicy(stale_budget=3, rejoin_intervals=4,
                          actuation_retries=3, retry_backoff_cap=8,
                          fault_log=2048, seed=args.seed)
    plane = build_plane(n_nodes, params, policy, record=pre + span + recover,
                        device=args.device)
    spec = chaos_schedule(n_nodes, start=pre, span=span)
    audit = []
    saw_quarantine = False

    print(f"== phase 1: MemoryPlane under the full fault catalog "
          f"({n_nodes} nodes, {len(spec.faults)} fault specs, "
          f"window [{pre}, {pre + span}))")
    handle = None
    with inject(plane, spec) as chaos:
        for t in range(pre + span):
            actions = plane.tick()
            audit.extend(actions)
            for a in actions:
                if a.u_next > params.u_max + EPS or a.u_next > M + EPS:
                    failures.append(
                        f"plane: grant {a.u_next / GiB:.1f} GiB on "
                        f"{a.node} exceeds the cap at tick {t}")
            if t == pre + 2:
                # Supervised retune starts inside the retune-kill
                # window: the first attempt dies by construction.
                handle = retune_online(
                    plane, name="chaos-replay", method="random", budget=4,
                    seed=args.seed, block=False, swap=False,
                    restarts=8, restart_backoff_s=0.05,
                    device=args.device)
            if plane.health().quarantined():
                saw_quarantine = True
        report = plane.health()
        print(f"   under chaos: {report.summary()}")
        print(f"   injected: {chaos.counts()}")
        if not saw_quarantine:
            failures.append("plane: crash fault never drove a node to "
                            "QUARANTINED")
    # Chaos reverted: the plane must heal within the hysteresis window
    # plus the actuation shield's worst-case backoff tail (a long
    # failure streak leaves up to ~2*cap skipped apply calls pending).
    deadline = (policy.stale_budget + policy.rejoin_intervals
                + 2 * policy.retry_backoff_cap + 4)
    for t in range(recover):
        audit.extend(plane.tick())
        report = plane.health()
        if not report.degraded():
            break
    healed_in = t + 1
    if report.degraded():
        failures.append(f"plane: still degraded {recover} ticks after the "
                        f"chaos lifted: {report.summary()}")
    elif healed_in > deadline:
        failures.append(f"plane: rejoin took {healed_in} ticks, "
                        f"hysteresis allows {deadline}")
    else:
        print(f"   recovered in {healed_in} ticks "
              f"(hysteresis allows {deadline})")
    audit_actions(audit, n_nodes, failures, "plane")

    # The retune supervisor must have restarted past the injected kill.
    while handle is not None and not handle.done:
        plane.tick()
        time.sleep(0.01)
    if handle is not None:
        if handle.restarts < 1:
            failures.append("retune: supervisor never restarted despite "
                            "the retune-kill fault")
        try:
            handle.result()
            print(f"   retune survived: {handle.attempts} attempts, "
                  f"{handle.restarts} restarts")
        except Exception as exc:
            failures.append(f"retune: dead after {handle.attempts} "
                            f"attempts: {exc}")
    counts = plane.fault_log.counts()
    for expected in ("sample-error", "telemetry-invalid", "quarantine",
                     "rejoin", "actuation-error", "retune-restart"):
        if counts.get(expected, 0) < 1:
            failures.append(f"plane: fault log missing {expected!r} "
                            f"events (got {sorted(counts)})")
    return plane, chaos, counts


def phase_fleet_plane(args, failures):
    n_nodes = 2
    epoch_intervals = 4
    pre, span, recover = (8, 24, 32) if args.smoke else (12, 40, 48)
    params = ControllerParams(total_memory=M, u_max=60.0 * GiB,
                              interval_s=0.01)
    policy = HealthPolicy(stale_budget=2, rejoin_intervals=3,
                          fault_log=1024, seed=args.seed)

    def tenant(name, usage_gib, **kw):
        nodes = tuple(
            NodeSpec(f"{name}-n{i}", monitor=SimulatedMonitor(
                f"{name}-n{i}", total=M,
                usage=lambda t, g=usage_gib: g * GiB))
            for i in range(n_nodes))
        return TenantSpec(name, PlaneSpec(params=params, nodes=nodes,
                                          health=policy,
                                          device=args.device), **kw)

    spec = FleetSpec(tenants=(
        tenant("victim", 40.0, weight=2.0, floor_gib=8.0),
        tenant("bystander", 30.0, weight=1.0, floor_gib=8.0),
    ), epoch_intervals=epoch_intervals)
    fleet = FleetPlane(spec)
    floor = max(8.0 * GiB, 1 << 20)
    chaos = ChaosSpec(faults=(
        FaultSpec("crash",
                  nodes=tuple(f"victim-n{i}" for i in range(n_nodes)),
                  start=pre, duration=span),
    ), seed=args.seed)

    print(f"== phase 2: FleetPlane with tenant 'victim' fully crashed "
          f"for ticks [{pre}, {pre + span})")
    victim_floored = False
    with fleet, inject(fleet.plane("victim"), chaos):
        for t in range(pre + span):
            fleet.tick()
            budgets = fleet.budgets()
            if sum(budgets.values()) > M + EPS:
                failures.append(f"fleet: budgets sum "
                                f"{sum(budgets.values()) / GiB:.1f} GiB > "
                                f"{M / GiB:.0f} GiB at tick {t}")
            if ("victim" in fleet.quarantined_tenants()
                    and budgets["victim"] <= floor + EPS):
                victim_floored = True
        if not victim_floored:
            failures.append("fleet: quarantined victim was never squeezed "
                            "to its floor")
        print(f"   mid-chaos budgets: "
              f"{ {k: round(v / GiB, 1) for k, v in fleet.budgets().items()} } "
              f"quarantined={fleet.quarantined_tenants()}")
        # Chaos lifts inside the context: the victim's nested plane must
        # rejoin and the next epochs must grow its budget back.
        for t in range(recover):
            fleet.tick()
        if fleet.quarantined_tenants():
            failures.append(f"fleet: {fleet.quarantined_tenants()} still "
                            f"quarantined {recover} ticks after recovery")
        if fleet.budgets()["victim"] <= floor + EPS:
            failures.append("fleet: victim budget never recovered above "
                            "its floor after rejoin")
        counts = fleet.fault_log.counts()
        for expected in ("tenant-quarantine", "tenant-rejoin"):
            if counts.get(expected, 0) < 1:
                failures.append(f"fleet: fault log missing {expected!r}")
        print(f"   post-recovery budgets: "
              f"{ {k: round(v / GiB, 1) for k, v in fleet.budgets().items()} }")
    return fleet, counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run: fewer nodes, shorter windows")
    ap.add_argument("--out-dir", default=None,
                    help="write faultlog.json here")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where the planes step (default: the CUDA card)")
    args = ap.parse_args(argv)

    failures = []
    plane, chaos, plane_counts = phase_memory_plane(args, failures)
    fleet, fleet_counts = phase_fleet_plane(args, failures)

    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        path = os.path.join(args.out_dir, "faultlog.json")
        with open(path, "w") as fh:
            json.dump({
                "seed": args.seed,
                "injected": chaos.counts(),
                "plane_fault_counts": plane_counts,
                "plane_events": [dataclasses.asdict(e)
                                 for e in plane.fault_log.snapshot()],
                "fleet_fault_counts": fleet_counts,
                "fleet_events": [dataclasses.asdict(e)
                                 for e in fleet.fault_log.snapshot()],
                "failures": failures,
            }, fh, indent=2)
        print(f"   artifact: {path}")

    if failures:
        print("FAILED:")
        for f in failures:
            print("  -", f)
        return 1
    print("OK: every degradation guarantee held under the full fault "
          "catalog (plane + fleet)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
