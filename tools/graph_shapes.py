#!/usr/bin/env python3
"""Time the sweep kernel's AppGraph instance at every candidate shape.

    python tools/graph_shapes.py [--ablate]

On the card only (the machine with the card: ``nvcc`` and a GPU).  For
each fleet of ``chip_smoke.py``'s phase 16e (limplock and spark-dag at
their registry sizes and at 4096 nodes, 64 gain lanes each) it prints
the planner's route (``kernels/sweep.py::graph_route``) and, for every
shape the planner weighs -- the loops a thread, the threads a block
(``GRAPH_BLOCKS``), one cluster a lane, and the cooperative route --
the instance's registers, spills, resident blocks an SM and resident
clusters (``cudaOccupancyMaxActiveClusters``), its agreement with the
plain version over the fleet's first 150 intervals, and its time at 64
and 8 lanes (CUDA events after a device-side lead, median of 5; the
cooperative route in as many launches as co-residency asks).

``--ablate`` also builds timing-only variants of ``csrc/sweep.cu``
that compute wrong results -- the histogram's counts dropped, the
lane's min taken per warp only, both -- and times the planned route of
each fleet with them at 64 and 8 lanes: what one interval's histogram
and meet cost.  A CUDA profiler does not run on that machine, so this
ablation is the breakdown.
"""

import concurrent.futures
import contextlib
import ctypes
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))
ABLATE = "--ablate" in sys.argv[1:]
sys.argv = sys.argv[:1]        # chip_smoke reads its own arguments

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

ks = cs.ks
LANES = (64, 8)

# Timing-only edits of the graph kernel: (source text, replacement).
COUNTS = ("#pragma unroll\n        for (int j = 0; j < J; ++j) "
          "count(bins, bin[j], active[j]);\n")
MEET = ("  if (m.route == kMeetWarp) {\n    between();\n    return v;\n  }",
        "  if (true) {\n    between();\n    return v;\n  }")
ABLATIONS = {"no histogram": [(COUNTS, "")],
             "no meet": [MEET],
             "neither": [(COUNTS, ""), MEET]}


def shapes(spec, con, rows):
    """The planner's candidates for ``spec``'s lanes: one warp for a
    lane of up to 32 nodes; else each block size of GRAPH_BLOCKS as one
    cluster, one loop a thread in the largest blocks, and the
    cooperative route."""
    if spec.n_nodes <= 32:
        return [ks.GraphRoute(1, 32, 1, 1, False, None)]
    wide = ks.WIDE_LOOPS[bool(spec.cache)]
    out = []
    for loops, cap in [(wide, c) for c in ks.GRAPH_BLOCKS] + [
            (1, ks.GRAPH_THREADS)]:
        blocks, threads = ks._spread(spec.n_nodes, loops, cap)
        if blocks <= ks.MAX_CLUSTER:
            out.append(ks.GraphRoute(loops, threads, blocks, blocks, False,
                                     None))
    blocks, threads = ks._spread(spec.n_nodes, wide, ks.GRAPH_THREADS)
    per_sm = ks.instance_resources(con.paper_law, con.unit_occupancy,
                                   con.has_cache, False, wide, threads, 1,
                                   rows).blocks_per_sm
    out.append(ks.GraphRoute(wide, threads, blocks, 1, True,
                             per_sm * torch.cuda.get_device_properties(
                                 0).multi_processor_count // blocks))
    return out


@contextlib.contextmanager
def forced(route):
    """Every graph launch inside at ``route``: the planner overridden."""
    planner = ks.graph_plan
    ks.graph_plan = lambda con, n_nodes, device, rows=1: route
    try:
        yield
    finally:
        ks.graph_plan = planner


def timed(args, kw, route, n_lanes):
    """ms of ``n_lanes`` lanes of ``args`` at ``route``."""
    state0, hist0, dtn, lp, rows, alive = args
    limit = route.lanes or n_lanes

    def run():
        for lo in range(0, n_lanes, limit):
            hi = min(lo + limit, n_lanes)
            ks.sweep_segment(state0[:, lo:hi].contiguous(),
                             hist0[lo:hi].contiguous(), dtn,
                             lp[:, lo:hi].contiguous(), rows,
                             alive[:, lo:hi].contiguous(), **kw)
    with forced(route):
        return cs.cuda_ms(run, lead=True)


def agrees(spec, gains, route):
    """The route against the plain version over 150 intervals, 3 lanes
    dead (bit for bit without the cache, 1e-6 with it)."""
    args, kw, _ = cs.graph_inputs(spec.replace(n_intervals=150), gains,
                                  n_dead=3)
    if route.lanes is not None and route.lanes < args[3].shape[1]:
        return "not run (lanes)"
    with forced(route):
        sk, hk = ks.sweep_segment(*args, **kw)
    sp, hp = ks.sweep_segment_plain(*args, **kw)
    if spec.cache is None:
        return torch.equal(sk, sp) and torch.equal(hk, hp)
    scale = sp.abs().amax(dim=(1, 2), keepdim=True).clamp_min(1e-30)
    return float(((sk - sp).abs() / scale).max()) <= 1e-6


def per_lanes(args, kw, route, spec):
    return "; ".join(
        f"{n} lanes {ms:.4f} ms ({ms * 1e3 / spec.n_intervals:.3f} us an "
        f"interval)" for n, ms in ((n, timed(args, kw, route, n))
                                   for n in LANES))


def variant(name, edits, out_dir):
    """Build csrc/sweep.cu with ``edits`` into its own library."""
    src = (REPO / "src/repro_torch/csrc/sweep.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"{name}: the source no longer has {old!r}")
        src = src.replace(old, new)
    path = out_dir / (name.replace(" ", "_") + ".cu")
    path.write_text(src)
    lib_path = path.with_suffix(".so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    str(path)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    _build._declare(lib, _build.LIBRARIES["sweep.cu"])
    return name, _build.Library(lib=lib, path=lib_path, build_s=0.0, log="")


def main() -> int:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    fleets = [(tag, spec, gains, *cs.graph_inputs(spec, gains)[:2])
              for tag, spec, gains in cs.graph_fleets()]
    for tag, spec, gains, args, kw in fleets:
        con, rows = kw["con"], kw["graph"][1].shape[1]
        print(f"{tag}: planned {cs.graph_route(kw, spec.n_nodes)}",
              flush=True)
        for route in shapes(spec, con, rows):
            r = ks.instance_resources(con.paper_law, con.unit_occupancy,
                                      con.has_cache, False, route.loops,
                                      route.threads, route.cluster, rows)
            print(f"  {route.name} J={route.loops} {route.threads} threads "
                  f"x {route.blocks} blocks: {r.registers} registers, "
                  f"{r.spill_bytes} B spilled, {r.blocks_per_sm} blocks an "
                  f"SM, {r.clusters} clusters resident; agrees "
                  f"{agrees(spec, gains, route)}; "
                  + per_lanes(args, kw, route, spec), flush=True)
    if not ABLATE:
        return 0
    out_dir = REPO / "build" / "graph_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(ABLATIONS)) as pool:
        libs = dict(pool.map(lambda kv: variant(*kv, out_dir),
                             ABLATIONS.items()))
    for name, lib in [("as built", _build.load_library())] + list(
            libs.items()):
        _build.load_library = lambda source="sweep.cu", lib=lib: lib
        ks._graph_fn.cache_clear()
        ks._card_resources.cache_clear()
        for tag, spec, gains, args, kw in fleets:
            route = cs.graph_route(kw, spec.n_nodes)
            print(f"{name}: {tag}: " + per_lanes(args, kw, route, spec),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
