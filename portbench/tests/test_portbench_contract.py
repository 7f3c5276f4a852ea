"""The result line's contract, the whole-name import check, and runs
with the timed path broken underneath, each of which must read
``correct`` false.  Every run here skips the harness's look for a card
and drives the rest of a run on the CPU at smoke sizes."""

import ast
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness
from portbench.tests import smoke

CPU = torch.device("cpu")
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = {"hymba-1.5b.chat": ("hymba-1.5b", "chat"),
         "qwen2-moe-a2.7b.chat": ("qwen2-moe-a2.7b", "chat"),
         "qwen2-moe-a2.7b.train-4k": ("qwen2-moe-a2.7b-3l", "train-4k")}


def _run(cell, traced=False, fault=None, seed=2 ** 31 + 11, seconds=1.5):
    bench = harness.load_benchmark()
    cfg, mix = CELLS[cell]
    out = harness.run_cell(bench, harness.find_cell(bench, cell), seed,
                           seconds, traced, CPU, time.perf_counter(),
                           fault=fault, cfg=smoke.config(cfg),
                           mix=smoke.mix(mix))
    out.pop("_run")
    return out


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(cell, traced):
    out = _run(cell, traced)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[:5] == keys
    assert list(out)[-1] == "checks"
    assert ("breakdown" in out) == traced
    checks = out["checks"]
    if cell.endswith("train-4k"):
        # the smoke leaves hold ~1e3 times fewer elements than the cell's,
        # so the round-off of 3 small AdamW steps weighs more in a norm
        late = checks.pop("update_gap")
        assert late["value"] < 1e-4
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks
    assert out["attempted"] > 0 and out["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        out["device"])
    bench = harness.load_benchmark()
    want = {m["name"] for m in harness.metrics_of(bench, cell, traced)}
    # the CPU reads no device metric; what it reads is the cell's
    assert set(out["metrics"]) <= want
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in checks.values():
        assert set(c) == {"value", "limit"} and c["limit"] is not None
    json.dumps(out)


def test_every_named_metric_has_a_reader():
    bench = harness.load_benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(["repro_torch.models", "torch",
                                      "jaxtyping", "reproduce"]) == []
    assert harness.forbidden_modules(["repro.core.plane", "jax.numpy",
                                      "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "repro"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_references_import_nothing_of_the_program_or_jax():
    ref = os.path.join(HERE, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref, name))}
            assert not tops & {"repro_torch", "repro", "jax", "jaxlib",
                               "flax"}, name
    code = ("import sys; import portbench.reference.model, "
            "portbench.reference.train, portbench.reference.plane, "
            "portbench.weights, portbench.yardstick; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=os.path.dirname(HERE), check=True)
    tops = set(eval(out.stdout))
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_the_harness_loads_no_jax():
    code = ("import sys; sys.path[:0] = ['src']; "
            "import portbench.harness as h, portbench.serve, "
            "portbench.train, repro_torch.launch.serve, "
            "repro_torch.launch.train; print(h.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=os.path.dirname(HERE), check=True)
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload",
         "hymba-1.5b.chat", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout.strip() == ""


# ---- faults: each must read correct false --------------------------------

def _alter_tokens(loop):
    """A token altered where it is produced: every other token of each
    request, after the engine has picked it."""
    eng = loop.engine
    consume = eng._consume

    def altered(logits, feeding):
        consume(logits, feeding)
        for slot in eng.slots:
            r = slot.request
            if r is not None and len(r.output) % 2 == 1:
                r.output[-1] = (r.output[-1] + 1) % len(eng.model.tokens)
    eng._consume = altered


def _state_unchanged(loop):
    """A step that returns its state unchanged: positions and recurrent
    state restored after every step."""
    import repro_torch.models.decode as D

    step = D.decode_step

    def frozen(model, state, tokens, *a, **kw):
        keep = [t.clone() for t in (state.pos, state.mamba_h,
                                    state.mamba_conv) if t is not None]
        out = step(model, state, tokens, *a, **kw)
        for old, t in zip(keep, [t for t in (state.pos, state.mamba_h,
                                             state.mamba_conv)
                                 if t is not None]):
            t.copy_(old)
        return out
    D.decode_step = frozen


def _plane_altered(loop):
    """A capacity decision altered where the controller produces it."""
    ctl = loop.plane.controller
    step = ctl._step
    ctl._step = lambda packed: step(packed) * 0.999


def _route_reversed(loop):
    """Routing altered where the router produces it: the experts picked
    from the least likely up."""
    import repro_torch.models.moe as M

    route = M.route
    M.route = lambda probs, k, cap: route(-probs, k, cap)


@pytest.mark.parametrize("cell", ["hymba-1.5b.chat", "qwen2-moe-a2.7b.chat"])
@pytest.mark.parametrize("fault", [_alter_tokens, _state_unchanged,
                                   _plane_altered])
def test_serving_faults_read_incorrect(cell, fault):
    import repro_torch.models.decode as D

    step = D.decode_step
    try:
        out = _run(cell, fault=fault)
    finally:
        D.decode_step = step
    assert out["correct"] is False, out["checks"]


def test_routing_fault_reads_incorrect():
    import repro_torch.models.moe as M

    route = M.route
    try:
        out = _run("qwen2-moe-a2.7b.chat", fault=_route_reversed)
    finally:
        M.route = route
    assert out["correct"] is False, out["checks"]
    assert out["checks"]["route_gap"]["value"] > 0.01


def _train_unchanged(loop):
    """A step that returns its state unchanged."""
    step = loop.step_fn

    def same(params, state, batch):
        _, _, metrics = step(params, state, batch)
        return params, state, metrics
    loop.step_fn = same


def _half_batch(loop):
    """Half of the batch left out, the mean taken over the rest."""
    step = loop.step_fn

    def half(params, state, batch):
        return step(params, state,
                    {k: v[:len(v) // 2] for k, v in batch.items()})
    loop.step_fn = half


@pytest.mark.parametrize("fault", [_train_unchanged, _half_batch])
def test_training_faults_read_incorrect(fault):
    out = _run("qwen2-moe-a2.7b.train-4k", fault=fault)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("change", [{"dtype": "bfloat16"},
                                    {"plane": {"preset": "host_cache"}}])
def test_configurations_the_harness_does_not_build_are_refused(change):
    from portbench.port import check_config, load_config

    cfg = load_config("hymba-1.5b")
    for k, v in change.items():
        cfg[k] = dict(cfg[k], **v) if isinstance(v, dict) else v
    with pytest.raises(ValueError):
        check_config(cfg)


def test_every_cell_reports_what_its_metrics_move():
    bench = harness.load_benchmark()
    for cell in bench["workloads"]:
        name = cell["name"]
        e2e = {m["name"] for m in harness.metrics_of(bench, name, False)}
        layer = harness.metrics_of(bench, name, True)
        assert "setup_s" in e2e and len(e2e) >= 2, name
        assert layer, name
        for m in layer:
            assert m["moves"] in e2e, (name, m["name"])
