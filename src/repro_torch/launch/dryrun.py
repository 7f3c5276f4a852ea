"""Multi-pod dry-run entry point.

The port of ``repro/launch/dryrun.py``.  For every (architecture x
input-shape) cell, on both production meshes (16 x 16 single-pod and
2 x 16 x 16 multi-pod), it builds the cell on ``meta`` tensors
(:func:`~repro_torch.launch.cells.build_cell`), counts its global step
once and splits the count over the chips by the specs
(:mod:`repro_torch.roofline.sharding`): per-chip FLOPs, bytes, the
collectives the layout implies, and ``argument_size_in_bytes`` (the
inputs' shard bytes) against the H100's 80 GB.  It needs no card and
allocates nothing: JAX's lowers and compiles on 512 forced host
devices, the port has no SPMD compiler, so nothing here is a device
time.  One JSON artifact per cell and mesh under ``--out``.

Counting at full width costs host time (a step of mistral-large-123b is
~1.4e5 meta ops a microbatch, xlstm-125m's sLSTM ~100 ops a token a
layer), so :func:`count_cell` scales where that is exact, and the
artifact's ``scaling`` says along which axes: a stack of identical
layers is counted at depths of one and two layers (pairs for the ssm
family), the ssm family's sequence at two and three mLSTM chunks, a step
of 6 or more identical microbatches at 2 and 3, each extrapolated
linearly.  The port's step is linear along each (each layer, chunk or
microbatch runs the same ops on the same shapes), which
``tests/test_torch_sharding.py`` checks against full counts.

Usage:
    python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod-only|--single-pod-only]
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import sys
import time
import traceback
from typing import Optional, Sequence

import torch

from ..configs import cells as all_cells
from ..configs import get_config, get_shape
from ..configs.base import ArchConfig, InputShape
from ..launch.cells import CellSettings, build_cell, cell_settings
from ..launch.mesh import describe, make_production_mesh
from ..models.layers import _frequency_table
from ..models.transformer import layer_windows
from ..roofline.sharding import analyze_cell, combine, sharded_cost


def _count(cfg, shape, st) -> dict:
    fn, inputs, _ = build_cell(cfg, shape, make_production_mesh(), st)
    return sharded_cost(fn, *inputs,
                        params=dict(fn.model.named_parameters()))


def _linear(points, target):
    """Weights of a linear extrapolation through two points to target."""
    (a, b) = points
    return {a: (b - target) / (b - a), b: (target - a) / (b - a)}


# The ssm family's sequence axis scales in whole mLSTM chunks
# (models/ssm.py::mlstm_apply's default chunk)
MLSTM_CHUNK = 128


def scaling_axes(cfg: ArchConfig, shape: InputShape,
                 settings: CellSettings) -> dict:
    """{axis: (two counted values, the cell's value)} of each axis along
    which the cell's step is linear and long enough to be worth scaling:
    ``depth`` for a stack of identical layers (the dense and moe families
    with one window; the ssm family's pairs), ``seq_len`` for the ssm
    family's train and prefill (its sLSTM runs token by token; whole
    mLSTM chunks), ``microbatches`` for 6 or more identical
    microbatches."""
    axes = {}
    unit = len(cfg.block_pattern) if cfg.family == "ssm" else 1
    if (cfg.family in ("dense", "moe", "ssm") and cfg.n_layers > 2 * unit
            and len(set(layer_windows(cfg))) == 1):
        axes["depth"] = ((unit, 2 * unit), cfg.n_layers)
    if (cfg.family == "ssm" and shape.kind != "decode"
            and shape.seq_len > 3 * MLSTM_CHUNK
            and shape.seq_len % MLSTM_CHUNK == 0):
        axes["seq_len"] = ((2 * MLSTM_CHUNK, 3 * MLSTM_CHUNK), shape.seq_len)
    if shape.kind == "train" and settings.microbatches > 5:
        axes["microbatches"] = ((2, 3), settings.microbatches)
    return axes


@functools.lru_cache(maxsize=8)
def count_cell(cfg: ArchConfig, shape: InputShape, settings: CellSettings,
               scale: bool = True):
    """(global count, scaling) of a cell's step, counted on meta tensors
    once for every mesh (:func:`~repro_torch.roofline.sharding.
    sharded_cost`); with ``scale``, along each of
    :func:`scaling_axes` counted at two values and extrapolated
    linearly (the product of the axes' weights over every combination of
    their values), which ``scaling`` lists."""
    # the rope table is built once a process; build it before counting so
    # that every count leaves it out alike
    _frequency_table(cfg.head_dim, cfg.rope_theta, torch.device("meta"))
    axes = scaling_axes(cfg, shape, settings) if scale else {}
    weights = [({}, 1.0)]
    for name, (points, target) in axes.items():
        weights = [({**at, name: v}, w * wv) for at, w in weights
                   for v, wv in _linear(points, target).items()]
    per_mb = shape.global_batch // settings.microbatches
    parts = []
    for at, w in weights:
        mb = at.get("microbatches", settings.microbatches)
        parts.append((w, _count(
            dataclasses.replace(cfg, n_layers=at.get("depth", cfg.n_layers)),
            dataclasses.replace(shape, global_batch=per_mb * mb,
                                seq_len=at.get("seq_len", shape.seq_len)),
            dataclasses.replace(settings, microbatches=mb))))
    scaling = {name: {"counted": list(points), "of": target}
               for name, (points, target) in axes.items()}
    return combine(parts), scaling


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str,
             settings_override: Optional[dict] = None, tag: str = "") -> dict:
    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod)
    st = cell_settings(arch, shape)
    if settings_override:
        st = dataclasses.replace(st, **settings_override)
    fn, inputs, desc = build_cell(arch, shape, mesh, settings=st)
    desc["mesh"] = describe(mesh)
    desc["multi_pod"] = multi_pod
    t_build = time.time() - t0
    cost, scaling = count_cell(get_config(arch), get_shape(shape), st)
    t_count = time.time() - t0 - t_build
    result = analyze_cell(cost, desc, inputs, fn.model, mesh)
    result["scaling"] = scaling
    result["counted_not_measured"] = (
        "counted on meta tensors on the host (no device ran): per-chip "
        "FLOPs, bytes and collective bytes split from one count of the "
        "global step by the specs; the roofline terms are bounds from the "
        "H100's data-sheet peaks")
    result["backend_cost_analysis"] = {}     # no compiler: nothing to read
    result["timing"] = {"build_s": round(t_build, 1),
                        "count_s": round(t_count, 1)}

    mesh_tag = "pod2" if multi_pod else "pod1"
    name = f"{arch}__{shape}__{mesh_tag}{tag}.json"
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    with open(path + ".tmp", "w") as fh:
        json.dump(result, fh, indent=1, default=str)
    os.replace(path + ".tmp", path)
    return result


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--settings", default="",
                    help='JSON overrides, e.g. {"microbatches":8}')
    args = ap.parse_args(argv)

    if args.all:
        targets = all_cells()
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required without --all")
        targets = [(args.arch, args.shape)]

    meshes = []
    if not args.multi_pod_only:
        meshes.append(False)
    if not args.single_pod_only:
        meshes.append(True)
    if args.multi_pod:
        meshes = [True]

    overrides = json.loads(args.settings) if args.settings else None
    failures = []
    for arch, shape in targets:
        for mp in meshes:
            tag = "pod2" if mp else "pod1"
            out = os.path.join(args.out, f"{arch}__{shape}__{tag}.json")
            if args.skip_existing and os.path.exists(out):
                print(f"[skip] {arch} x {shape} x {tag}")
                continue
            print(f"[dryrun] {arch} x {shape} x {tag} ...", flush=True)
            try:
                r = run_cell(arch, shape, mp, args.out,
                             settings_override=overrides)
                t = r["roofline"]
                print(f"  ok ({r['timing']['count_s']}s count) "
                      f"compute={t['compute_s']:.4f}s "
                      f"memory={t['memory_s']:.4f}s "
                      f"collective={t['collective_s']:.4f}s "
                      f"dominant={t['dominant']}", flush=True)
                per = r["memory_analysis"]["argument_size_in_bytes"]
                print(f"  memory/device: args = {per / 2**30:.2f} GiB",
                      flush=True)
            except Exception as e:
                failures.append((arch, shape, tag, repr(e)))
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        return 1
    print("\nall dry-run cells counted")
    return 0


if __name__ == "__main__":
    sys.exit(main())
