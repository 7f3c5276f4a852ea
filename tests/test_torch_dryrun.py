"""The dry-run's per-chip counts (``repro_torch.roofline.sharding``,
``repro_torch.launch.dryrun``) on the CPU.

* on the 1 x 1 mesh a cell's count equals ``analyze_step``'s for the
  same step, kernels' work included;
* the depth, sequence and microbatch scaling of ``count_cell`` equals a
  full count, split over every mesh;
* on 4 x 2 and 2 x 2 x 2, llama3.2-1b-smoke's three kinds at 8 x 64
  tokens are compiled by JAX (8 forced host devices and an Auto-axis
  ``jax.sharding.Mesh`` entered as ``with mesh:``, one subprocess: JAX's
  own ``make_mesh`` + ``activate_mesh`` cannot lower a cell on this jax,
  ROADMAP C32) and the ratios of the port's per-chip FLOPs and
  collective bytes to XLA's are printed, not asserted: the port splits
  one count by the specs where XLA partitions a program.  Asserted: the
  structural rules (replicated work counted whole, the collective kinds
  the specs imply).
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_config, get_shape
from repro_torch.launch import cells as TCELLS
from repro_torch.launch.dryrun import count_cell
from repro_torch.launch.mesh import Mesh
from repro_torch.roofline import analyze_step
from repro_torch.roofline.sharding import (BATCH, TP, analyze_cell, divisor,
                                           per_chip, sharded_cost)

torch.set_num_threads(1)

POD1 = Mesh((16, 16), ("data", "model"))
POD2 = Mesh((2, 16, 16), ("pod", "data", "model"))
SMALL = {"4x2": Mesh((4, 2), ("data", "model")),
         "2x2x2": Mesh((2, 2, 2), ("pod", "data", "model"))}
ONE = Mesh((1, 1), ("data", "model"))
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _run_jax(script, timeout=600):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, env=env, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


SMOKE = "llama3.2-1b-smoke"


def _small(kind, b=8, s=64):
    return dataclasses.replace(get_shape(kind), global_batch=b, seq_len=s)


def _settings(kind, mb=2):
    return TCELLS.CellSettings(microbatches=mb if kind == "train_4k" else 1,
                               attn_impl="dense")


def _counted(cfg, shape, st, mesh):
    fn, inputs, desc = TCELLS.build_cell(cfg, shape, mesh, st)
    return sharded_cost(fn, *inputs,
                        params=dict(fn.model.named_parameters())), \
        (fn, inputs, desc)


@pytest.mark.parametrize("kind", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("name", [SMOKE, "hymba-1.5b-smoke",
                                  "qwen2-moe-a2.7b-smoke"])
def test_one_chip_count_equals_analyze_step(name, kind):
    cfg, shape = get_config(name), _small(kind, b=4, s=32)
    st = _settings(kind, mb=1 if name.startswith("hymba") else 2)
    count_cell(cfg, shape, st, scale=False)           # the rope table, once
    cost, (fn, inputs, desc) = _counted(cfg, shape, st, ONE)
    row = analyze_cell(cost, desc, inputs, fn.model, ONE)
    fn, inputs, desc = TCELLS.build_cell(cfg, shape, ONE, st)
    ref = analyze_step(fn, *inputs, desc=desc, n_chips=1)
    assert row["hlo_flops_per_chip"] == ref["hlo_flops_per_chip"]
    assert row["hlo_bytes_per_chip"] == ref["hlo_bytes_per_chip"]
    assert row["roofline"] == ref["roofline"]
    assert row["collectives"]["total_bytes"] == 0.0
    assert row["model_flops_utilization_bound"] == \
        ref["model_flops_utilization_bound"]


@pytest.mark.parametrize("name,kind,mb,depth,seq", [
    (SMOKE, "train_4k", 6, 5, 64), ("qwen2-moe-a2.7b-smoke", "train_4k", 2,
                                    5, 64),
    (SMOKE, "prefill_32k", 1, 5, 64),
    ("qwen2-moe-a2.7b-smoke", "decode_32k", 1, 5, 64),
    ("xlstm-125m-smoke", "prefill_32k", 1, 2, 512)])
def test_scaling_equals_a_full_count(name, kind, mb, depth, seq):
    cfg = dataclasses.replace(get_config(name), n_layers=depth)
    b = 12 if kind == "train_4k" else (8 if seq == 64 else 1)
    shape, st = _small(kind, b=b, s=seq), _settings(kind, mb)
    scaled, scaling = count_cell(cfg, shape, st)
    want = {"depth"} if depth > 2 else {"seq_len"}
    if mb > 5:
        want.add("microbatches")
    assert set(scaling) == want
    full, none = count_cell(cfg, shape, st, scale=False)
    assert none == {}
    assert scaled["flops"] == full["flops"]
    assert scaled["bytes"] == full["bytes"]
    for mesh in (*SMALL.values(), POD1, POD2):
        a, b = per_chip(scaled, mesh), per_chip(full, mesh)
        assert a["flops"] == pytest.approx(b["flops"], rel=1e-12)
        assert a["bytes"] == pytest.approx(b["bytes"], rel=1e-12)


XLA_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json
import numpy as np
import jax
from jax.sharding import Mesh
import repro.configs.base as B
from repro.launch.cells import CellSettings, build_cell
from repro.roofline.analysis import analyze_compiled
out = {}
for shape, axes in (((4, 2), ("data", "model")),
                    ((2, 2, 2), ("pod", "data", "model"))):
    mesh = Mesh(np.array(jax.devices()).reshape(shape), axes)
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        shp = B.SHAPES[name]
        saved = dict(B.SHAPES)
        B.SHAPES[name] = dataclasses.replace(shp, seq_len=64, global_batch=8)
        try:
            with mesh:
                fn, inputs, desc = build_cell(
                    "llama3.2-1b-smoke", name, mesh, settings=CellSettings(
                        microbatches=2 if shp.kind == "train" else 1,
                        attn_impl="dense"))
                compiled = jax.jit(fn).lower(*inputs).compile()
            r = analyze_compiled(compiled, desc, 8)
        finally:
            B.SHAPES.update(saved)
        out["x".join(map(str, shape)) + "|" + name] = {
            "flops": r["hlo_flops_per_chip"],
            "collective_bytes": r["collectives"]["total_bytes"]}
print(json.dumps(out))
"""


def test_small_mesh_counts_beside_xla():
    """Ratios of the port's per-chip counts to XLA's, printed (they are
    recorded in PERF.md, not asserted); asserted: the structural rules."""
    ref = _run_jax(XLA_SCRIPT)
    cfg = get_config(SMOKE)
    for mesh_tag, mesh in SMALL.items():
        for kind in ("train_4k", "prefill_32k", "decode_32k"):
            shape, st = _small(kind), _settings(kind)
            cost, (fn, inputs, desc) = _counted(cfg, shape, st, mesh)
            row = analyze_cell(cost, desc, inputs, fn.model, mesh)
            xla = ref[f"{mesh_tag}|{kind}"]
            print(f"{mesh_tag} {kind}: FLOPs port/XLA "
                  f"{row['hlo_flops_per_chip'] / xla['flops']:.3f}, "
                  f"collective bytes port/XLA "
                  f"{row['collectives']['total_bytes'] / xla['collective_bytes']:.3f}")
            assert xla["flops"] > 0 and row["hlo_flops_per_chip"] > 0
            # the smoke model's 4 heads do not divide by the production TP
            # size: attention is replicated over model, counted whole
            replicated = sum(f for r, (f, _) in cost["by_roles"].items()
                             if r & BATCH and not r & TP)
            assert replicated > 0
            assert row["hlo_flops_per_chip"] > cost["flops"] / mesh.size
            kinds = row["collectives"]["by_formula"]
            if kind == "decode_32k":
                assert set(kinds) == {"decode_partial_sums"}
                # the replicated one-token activations: work on every chip
                assert cost["by_roles"][0][1] > 0
            else:
                assert row["hlo_flops_per_chip"] <= \
                    cost["flops"] / divisor(BATCH, mesh)
                assert "fsdp_all_gather" in kinds and "tp_all_reduce" in kinds
            if kind == "train_4k":
                assert "grad_reduce_scatter" in kinds
                assert ("grad_all_reduce_pod" in kinds) == (mesh_tag == "2x2x2")
