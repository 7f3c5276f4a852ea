"""One run of one cell: arguments, device checks, the result line.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs the cell of ``BENCHMARK.json`` named ``<cell>``:
its configuration file (``configs/``), its traffic mix (``traffic/``,
whose ``kind`` picks the serving or the training runner), and, by the
names in ``BENCHMARK.json``, the readers of its metrics
(``metrics/<name>.py``, each ``read(run) -> value or None``, and
``WRAPS``, the program's calls it reads spans of).  With
``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics.  The comparisons that decide
``correct`` are printed last on standard error and carried last in the
line, each with its limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Optional

import torch

from . import check
from .port import load_config
from .trace import breakdown
from .traffic import load_mix

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, cell: str, traced: bool) -> list:
    """The cell's metrics of the run's kind, in the file's order."""
    kind = "per_layer" if traced else "end_to_end"
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


_METRICS: dict = {}


def metric(name: str):
    """The module of ``metrics/<name>.py``: ``read(run)``, and ``WRAPS``,
    the program's calls a traced run times for it (see
    :func:`portbench.spans.Spans.install`)."""
    if name not in _METRICS:
        path = os.path.join(HERE, "metrics", name + ".py")
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + name.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _METRICS[name] = mod
    return _METRICS[name]


def reader(name: str):
    return metric(name).read


def wraps_of(bench: dict, cell: str) -> list:
    """The calls the cell's per-layer metrics declare, each span once."""
    out = {}
    for m in metrics_of(bench, cell, True):
        for w in getattr(metric(m["name"]), "WRAPS", ()):
            out.setdefault(w[2], w)
    return list(out.values())


def forbidden_modules(names=None) -> list:
    """Loaded modules (or ``names``) whose top-level name is JAX's or the
    JAX package's, compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(bench: dict, cell: dict, seed: int, seconds: float,
             traced: bool, device: torch.device, t_start: float,
             fault=None, cfg: Optional[dict] = None,
             mix: Optional[dict] = None) -> dict:
    """Run ``cell`` once on ``device``; returns the result line's dict
    (and the run under ``_run``).  The tests pass a smaller ``cfg`` and
    ``mix`` and a ``fault``."""
    from . import serve, train

    cfg = cfg or load_config(cell["config"])
    mix = mix or load_mix(cell["traffic"])
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
    runner = {"serve": serve, "train": train}[mix["kind"]]
    run, checks = runner.run(cfg, mix, seed, seconds, traced, device,
                             t_start, cell["name"], fault=fault,
                             wraps=wraps_of(bench, cell["name"]))
    attempted, failed = runner.attempted_failed(run)
    metrics = {}
    for m in metrics_of(bench, cell["name"], traced):
        value = reader(m["name"])(run)
        if value is None:
            print(f"metric {m['name']}: nothing to read", file=sys.stderr)
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(run.peak_bytes)}
    out = {"correct": check.passed(checks) and failed == 0,
           "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": dev}
    if traced and run.trace is not None:
        busy = run.trace.busy_s + _missed_busy(run)
        dev.update(busy_s=busy, window_s=run.trace.window_s)
        out["breakdown"] = breakdown(run.trace)
    out["checks"] = check.report(checks)
    out["_run"] = run
    return out


def _missed_busy(run) -> float:
    """B3's event-timed seconds where the profiler missed its launches."""
    b3 = getattr(run, "b3", None)
    if b3 and b3["profiled_s"] is None:
        return b3["event_s"]
    return 0.0


def samples(run) -> str:
    """The sample counts behind a serving window's percentiles."""
    if run.kind != "serve":
        return (f"{run.tokens} tokens, longest step issue "
                f"{run.longest_step_s:.3f} s, {run.alloc_retries} "
                f"allocator retries")
    first = sum(1 for r in run.recs if not r.first_wave
                and run.in_window(r.t_first))
    done = sum(1 for r in run.recs if run.in_window(r.t_done)
               and r.n_out >= 5)
    return (f"{first} first tokens, {done} completions, "
            f"{run.preemptions} preemptions, longest step "
            f"{run.longest_step_s:.3f} s")


def main(argv: Optional[list] = None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_benchmark()
    cell = find_cell(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.set_num_threads(1)
    out = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                   device, t_start)
    run = out.pop("_run")
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package are loaded: {bad}",
              file=sys.stderr)
        return 3
    print(f"{power_limit()}; setup_s {run.setup_s:.3f}; window "
          f"{run.window_s:.3f} s, {run.steps} steps; {samples(run)}",
          file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0
