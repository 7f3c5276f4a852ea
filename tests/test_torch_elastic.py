"""The port's meshes, elastic planner, dry-run entry point and bulk decode.

* ``ElasticMeshPlanner.plan`` and ``replan_after_failures`` equal JAX's
  for every healthy count 1-600 at model axes 1-16, and the cases of
  ``tests/test_runtime.py``; ``MeshPlan.make`` and ``make_mesh`` raise
  with no card when ``devices`` is None;
* the production meshes describe themselves with JAX's keys;
* ``dryrun.main`` writes JAX's file names (through a ``.tmp`` rename)
  with JAX's ``analyze_compiled`` keys, and exits 0;
* ``decode_step(uniform_pos=True)`` writes the caches with one slice a
  layer and gives the general path's bits when every position is equal.
"""

import json
import os

import pytest
import torch

from repro.roofline.analysis import analyze_compiled as jax_analyze_compiled
from repro.runtime import ElasticMeshPlanner as JaxPlanner
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (Mesh, describe, make_mesh,
                                     make_production_mesh,
                                     single_device_mesh)
from repro_torch.models import Model
from repro_torch.models import decode as D
from repro_torch.runtime import ElasticMeshPlanner, MeshPlan

torch.set_num_threads(1)


def _plan(planner, *args):
    try:
        p = planner.plan(*args)
    except RuntimeError as e:
        return ("raises", str(e))
    return (tuple(p.shape), tuple(p.axis_names), p.n_devices, p.dropped)


@pytest.mark.parametrize("model_axis", [1, 2, 4, 8, 16])
def test_planner_equals_jax(model_axis):
    ours, ref = ElasticMeshPlanner(model_axis), JaxPlanner(model_axis)
    for healthy in range(0, 601):
        assert _plan(ours, healthy) == _plan(ref, healthy), healthy
        for override in (None, 4):
            assert _plan(ours, healthy, override) == \
                _plan(ref, healthy, override)
    for total, failed in ((256, 16), (512, 1), (16, 15), (8, 8)):
        try:
            want = ref.replan_after_failures(total, failed)
        except RuntimeError:
            with pytest.raises(RuntimeError):
                ours.replan_after_failures(total, failed)
            continue
        got = ours.replan_after_failures(total, failed)
        assert (got.shape, got.axis_names, got.n_devices, got.dropped) == \
            (want.shape, want.axis_names, want.n_devices, want.dropped)


def test_planner_cases_of_the_runtime_tests():
    pl = ElasticMeshPlanner(model_axis=16)
    full = pl.plan(256)
    assert full.shape == (16, 16) and full.dropped == 0
    degraded = pl.replan_after_failures(256, 16)
    assert degraded.shape == (15, 16) and degraded.dropped == 0
    odd = pl.plan(250)
    assert odd.shape == (15, 16) and odd.dropped == 10
    tiny = pl.plan(12)
    assert tiny.shape[1] == 8 and tiny.shape[0] == 1
    with pytest.raises(RuntimeError):
        pl.plan(0)
    mesh = ElasticMeshPlanner(model_axis=1).plan(1).make(["cpu"])
    assert mesh.shape == (1, 1) and mesh.devices == (torch.device("cpu"),)


def test_meshes_that_run_want_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plan = MeshPlan(shape=(1, 1), axis_names=("data", "model"),
                    n_devices=1, dropped=0)
    for call in (plan.make, lambda: make_mesh((2, 2), ("data", "model")),
                 single_device_mesh):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert single_device_mesh("cpu").devices == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh((2, 2), ("data", "model"), ["cpu"])


def test_production_meshes_are_descriptions_with_jax_keys():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert one.devices is None and two.devices is None
    assert describe(one) == {"shape": {"data": 16, "model": 16},
                             "n_devices": 256,
                             "axis_names": ["data", "model"]}
    assert describe(two) == {"shape": {"pod": 2, "data": 16, "model": 16},
                             "n_devices": 512,
                             "axis_names": ["pod", "data", "model"]}
    assert two.axis_size("pod") == 2 and one.axis_size("pod") == 1
    with pytest.raises(ValueError, match="differ in length"):
        Mesh((2, 2), ("data",))


def _jax_row_keys():
    """The keys of JAX's dry-run artifact: ``analyze_compiled``'s row of
    a program with nothing in it, with the dry-run's own keys."""
    class Empty:
        def cost_analysis(self):
            return {}

        def memory_analysis(self):
            return None

    desc = {"arch": "a", "shape": "s", "kind": "decode", "n_params": 1,
            "n_active_params": 1, "tokens": 1, "settings": {},
            "sharding_report": {}, "mesh": {}, "multi_pod": False}
    hlo = ("HloModule m\n\nENTRY %main () -> f32[] {\n"
           "  ROOT %c = f32[] constant(0)\n}\n")
    row = jax_analyze_compiled(Empty(), desc, 1, hlo_text=hlo)
    return set(row) | {"timing"}


def test_dryrun_main_writes_jax_names_and_keys(tmp_path, capsys):
    out = str(tmp_path / "dr")
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                        "--out", out]) == 0
    names = sorted(os.listdir(out))
    assert names == ["llama3.2-1b__decode_32k__pod1.json",
                     "llama3.2-1b__decode_32k__pod2.json"]
    printed = capsys.readouterr().out
    assert "[dryrun] llama3.2-1b x decode_32k x pod1 ..." in printed
    assert "all dry-run cells counted" in printed
    for name in names:
        row = json.load(open(os.path.join(out, name)))
        assert _jax_row_keys() <= set(row)
        assert row["roofline"]["dominant"] in ("compute", "memory",
                                               "collective")
        assert row["hlo_flops_per_chip"] > 0
        assert row["mesh"]["n_devices"] == (512 if "pod2" in name else 256)
        assert "argument_size_in_bytes" in row["memory_analysis"]
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                        "--out", out, "--skip-existing",
                        "--single-pod-only"]) == 0
    assert "[skip] llama3.2-1b x decode_32k x pod1" in capsys.readouterr().out


def test_dryrun_main_fails_on_an_unsupported_cell(tmp_path, capsys):
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape", "long_500k",
                        "--out", str(tmp_path), "--multi-pod"]) == 1
    assert "1 FAILURES" in capsys.readouterr().out


# ---- bulk decode ---------------------------------------------------------

UNIFORM_ARCHS = ["llama3.2-1b-smoke", "hymba-1.5b-smoke", "gemma3-1b-smoke",
                 "qwen2-moe-a2.7b-smoke", "llama-3.2-vision-11b-smoke",
                 "whisper-large-v3-smoke", "xlstm-125m-smoke"]


@pytest.mark.parametrize("pos", [5, 15, 20])
@pytest.mark.parametrize("name", UNIFORM_ARCHS)
def test_uniform_pos_decode_equals_the_general_path(name, pos):
    """Every slot at ``pos`` (past the 16-slot cache's end at 20, where
    both clamp the write): logits and every state tensor bit for bit."""
    model = Model(get_config(name), seed=1, device="cpu")
    gen = torch.Generator().manual_seed(2)
    states = [D.init_state(model, 3, 16) for _ in range(2)]
    first, second = states
    for field in ("k", "v", "cross_k", "cross_v"):
        t = getattr(first, field)
        if t is not None:
            t.copy_(torch.randn(t.shape, generator=gen).to(t.dtype))
            getattr(second, field).copy_(t)
    for st in states:
        st.pos.fill_(pos)
    tokens = torch.randint(0, 400, (3, 1), generator=gen)
    with torch.no_grad():
        want = D.decode_step(model, first, tokens)
        got = D.decode_step(model, second, tokens, uniform_pos=True)
    assert torch.equal(got, want)
    for field in ("k", "v", "pos", "mamba_h", "mamba_conv"):
        a, b = getattr(first, field), getattr(second, field)
        assert (a is None and b is None) or torch.equal(a, b), field
    for key, leaves in (first.recurrent or {}).items():
        for leaf, t in leaves.items():
            assert torch.equal(t, second.recurrent[key][leaf]), (key, leaf)
