"""PlaneCheck for the port (``repro_torch.analysis``) against JAX's.

* LockLint is a copy: on every PC-L fixture of ``tests/test_analysis.py``
  and on both source trees it gives JAX's findings (rule, file, symbol,
  line).
* TraceLint's hot-loop rules (PC-H001..H004): each fires on an injected
  case in a marked loop and in a callee, and stays silent outside a hot
  loop, on shape metadata, behind ``is None``/membership tests and in a
  cached builder; the ignore pragma suppresses one line.
* The gate: ``python -m repro_torch.analysis --check src/repro_torch``
  exits 0 on the tree with every baseline entry justified, and an
  injected ``.item()`` in any of the four marked hot loops fails it.
* The runtime sanitizers do nothing with ``PLANECHECK_SANITIZERS`` off
  and count as JAX's do with it on; a kernel library loaded twice in a
  process shows as an excess build.
"""

import ast
import json
import os
import shutil
import textwrap

import pytest

from repro.analysis import analyze_locks as jax_analyze_locks
from repro.analysis import runtime as jax_runtime
from repro_torch.analysis import (Baseline, RULES, analyze_hot_loops,
                                  analyze_locks, run)
from repro_torch.analysis import runtime
from repro_torch.analysis.__main__ import main as planecheck_main
from repro_torch.kernels import _build
import torch

# One intra-op thread: the suite's workers share the cores, and torch's
# OpenMP threads, oversubscribed, spin-wait ~100x longer than the ops.
torch.set_num_threads(1)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
BASELINE = os.path.join(REPO, "PLANECHECK_TORCH_BASELINE.json")


def _key(f):
    return (f.rule, f.file, f.symbol, f.line)


def _write(tmp_path, code, name="snippet.py"):
    p = tmp_path / name
    p.write_text(textwrap.dedent(code))
    return str(p)


def hot_rules(tmp_path, code):
    return [f.rule for f in analyze_hot_loops([_write(tmp_path, code)],
                                              root=str(tmp_path))]


# ---------------------------------------------------------------------------
# LockLint: JAX's findings
# ---------------------------------------------------------------------------

def _lock_fixtures():
    """The code every ``lock_rules`` call of tests/test_analysis.py checks,
    read from its source."""
    path = os.path.join(REPO, "tests", "test_analysis.py")
    tree = ast.parse(open(path).read())
    consts = {t.id: n.value.value for n in tree.body
              if isinstance(n, ast.Assign) and isinstance(n.value, ast.Constant)
              for t in n.targets if isinstance(t, ast.Name)}
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Name) and node.func.id == "lock_rules":
            arg = node.args[1]
            if isinstance(arg, ast.Constant):
                out.append(arg.value)
            elif isinstance(arg, ast.Name) and arg.id in consts:
                out.append(consts[arg.id])
        elif isinstance(node.func, ast.Attribute) and \
                node.func.attr == "format" and \
                _name(node.func.value) == "GUARDED":
            out.append(consts["GUARDED"].format(
                body=ast.literal_eval(node.keywords[0].value)))
    return out


def _name(node):
    return node.id if isinstance(node, ast.Name) else None


LOCK_FIXTURES = _lock_fixtures()


def test_lock_fixtures_are_all_of_jax_ones():
    # one INVERSION, two inline pairs for L001, four GUARDED variants
    # minus the documentation-only one that is inline, three for L003
    assert len(LOCK_FIXTURES) == 10
    assert len(set(LOCK_FIXTURES)) == 10


@pytest.mark.parametrize("i", range(len(LOCK_FIXTURES)))
def test_locklint_gives_jax_findings_on_its_fixtures(tmp_path, i):
    path = _write(tmp_path, LOCK_FIXTURES[i])
    want = [_key(f) for f in jax_analyze_locks([path], root=str(tmp_path))]
    got = [_key(f) for f in analyze_locks([path], root=str(tmp_path))]
    assert got == want


@pytest.mark.parametrize("tree", ["src/repro_torch", "src/repro"])
def test_locklint_gives_jax_findings_on_the_trees(monkeypatch, tree):
    monkeypatch.chdir(REPO)
    want = sorted(_key(f) for f in jax_analyze_locks([tree]))
    got = sorted(_key(f) for f in analyze_locks([tree]))
    assert got == want
    if tree == "src/repro":                 # JAX's baselined lock debt
        assert {f[0] for f in got} == {"PC-L003"}


def test_rule_catalog_is_the_lock_rules_and_the_hot_loop_rules():
    assert sorted(RULES) == ["PC-H001", "PC-H002", "PC-H003", "PC-H004",
                             "PC-L001", "PC-L002", "PC-L003"]


# ---------------------------------------------------------------------------
# TraceLint: the hot-loop rules
# ---------------------------------------------------------------------------

LOOP = """
    import numpy as np
    import torch

    def helper(t):
        {callee}
        return t

    def f(xs, dev):
        out = []
        for x in xs:  {pragma}
            y = torch.relu(x)
            {body}
            out.append(helper(y))
        return out
    """

CASES = {
    # rule: (statement on the tensor y, the same in a callee on t)
    "PC-H001": ("v = y.item()", "v = t.tolist()"),
    "PC-H002": ("v = float(y)", "v = int(t)"),
    "PC-H003": ("if y > 0:\n                pass",
                "if t.sum() > 0:\n            pass"),
    "PC-H004": ("v = torch.tensor(2.0, device=dev)",
                "v = torch.from_numpy(np.ones(3)).to(t.device)"),
}


def _loop(body="pass", callee="pass", pragma="# planecheck: hot-loop"):
    return LOOP.format(body=body, callee=callee, pragma=pragma)


@pytest.mark.parametrize("rule", sorted(CASES))
def test_rule_fires_in_a_marked_loop(tmp_path, rule):
    assert hot_rules(tmp_path, _loop(body=CASES[rule][0])) == [rule]


@pytest.mark.parametrize("rule", sorted(CASES))
def test_rule_fires_in_a_callee_of_a_marked_loop(tmp_path, rule):
    findings = analyze_hot_loops([_write(tmp_path, _loop(
        callee=CASES[rule][1]))], root=str(tmp_path))
    assert [(f.rule, f.symbol) for f in findings] == [(rule, "helper")]


@pytest.mark.parametrize("rule", sorted(CASES))
def test_rule_is_silent_outside_a_hot_loop(tmp_path, rule):
    code = _loop(body=CASES[rule][0], callee=CASES[rule][1], pragma="")
    assert hot_rules(tmp_path, code) == []


def test_shape_metadata_does_not_fire(tmp_path):
    body = ("n = int(y.shape[0]) + y.dim() + y.size(0) + int(y.numel())\n"
            "            if y.ndim > 1 and y.dtype == torch.float32:\n"
            "                pass")
    assert hot_rules(tmp_path, _loop(body=body)) == []


def test_is_none_and_membership_do_not_fire(tmp_path):
    body = ("d = {'k': y}\n"
            "            if y is None or 'k' in d or y in out:\n"
            "                pass")
    assert hot_rules(tmp_path, _loop(body=body)) == []


def test_cpu_and_synchronize_fire_on_anything(tmp_path):
    body = ("v = xs.cpu()\n"
            "            torch.cuda.synchronize()\n"
            "            torch.cuda.current_stream().synchronize()")
    assert hot_rules(tmp_path, _loop(body=body)) == ["PC-H001"] * 3


def test_device_fills_and_host_arrays_do_not_fire(tmp_path):
    body = ("v = torch.full((), 2.0, device=dev) * y\n"
            "            w = np.ones(3).item() + float(np.ones(2).sum())\n"
            "            u = torch.tensor([1.0, 2.0])")
    assert hot_rules(tmp_path, _loop(body=body)) == []


def test_a_marked_function_comprehension_and_while(tmp_path):
    code = """
        import torch

        def step(x: torch.Tensor):  # planecheck: hot-loop
            return x.item()

        def sweep(lp):
            return [lp[i].cpu()  # planecheck: hot-loop
                    for i in range(3)]

        def spin(t):
            t = torch.zeros(1)
            while t < 3:  # planecheck: hot-loop
                t = t + 1
        """
    findings = analyze_hot_loops([_write(tmp_path, code)],
                                 root=str(tmp_path))
    assert sorted((f.rule, f.symbol) for f in findings) == [
        ("PC-H001", "step"), ("PC-H001", "sweep"), ("PC-H003", "spin")]


def test_tensor_fields_of_an_annotated_dataclass_are_tensors(tmp_path):
    code = """
        import dataclasses
        import torch

        @dataclasses.dataclass
        class State:
            pos: torch.Tensor
            n: int

        def step(state: State):  # planecheck: hot-loop
            a = state.n + 1
            if a > 2:
                pass
            return state.pos.item()
        """
    assert hot_rules(tmp_path, code) == ["PC-H001"]


def test_a_cached_builder_and_an_isinstance_guard_do_not_fire(tmp_path):
    code = """
        import functools
        import torch

        @functools.lru_cache(maxsize=None)
        def table(theta, device):
            return torch.tensor(theta, device=device)

        def step(x: torch.Tensor, d):  # planecheck: hot-loop
            if not (isinstance(d, (int, float)) and d == 0.0):
                x = x + d
            return x * table(1e4, x.device)
        """
    assert hot_rules(tmp_path, code) == []


def test_ignore_pragma_suppresses_one_line(tmp_path):
    # the pragma covers its own line and the one below it
    body = ("v = y.item()  # planecheck: ignore[PC-H001]\n"
            "            u = y + 1\n"
            "            w = y.item()")
    findings = analyze_hot_loops([_write(tmp_path, _loop(body=body))],
                                 root=str(tmp_path))
    assert [f.rule for f in findings] == ["PC-H001"]
    assert "w = y.item()" in open(tmp_path / "snippet.py").read().splitlines(
    )[findings[0].line - 1]


# ---------------------------------------------------------------------------
# The baseline and the gate
# ---------------------------------------------------------------------------

def test_baseline_entry_without_justification_fails(tmp_path, monkeypatch):
    b = Baseline([{"rule": "PC-H001", "file": "f.py", "symbol": "g",
                   "justification": " "}])
    assert b.validate()
    monkeypatch.chdir(REPO)
    doc = json.load(open(BASELINE))
    doc["entries"][0]["justification"] = ""
    bad = tmp_path / "baseline.json"
    bad.write_text(json.dumps(doc))
    assert planecheck_main(["src/repro_torch", "--check", "--baseline",
                            str(bad)]) == 1


def test_tree_passes_the_gate_with_every_entry_justified(monkeypatch):
    monkeypatch.chdir(REPO)
    baseline = Baseline.load(BASELINE)
    assert baseline.validate() == []
    findings, new = run(["src/repro_torch"], baseline)
    assert new == [], "\n".join(f.format() for f in new)
    assert baseline.stale() == []
    assert {f.rule for f in findings} == {"PC-H001", "PC-H004"}
    assert planecheck_main(["src/repro_torch", "--check"]) == 0


HOT_LOOPS = {
    # entry's file: (file of its marked loop, marked line, injected text
    # placed after it, hot symbol)
    "lab/fused_sweep.py": (
        "lab/mesh.py",
        "        for lead, _, lane_chunk, nodes in staged:  # planecheck: "
        "hot-loop\n", "            torch.zeros(1).item()\n",
        "mesh_sweep_demand"),
    "fleet/sweep.py": (
        "fleet/sweep.py",
        "        for lo in range(0, len(gains), chunk):     # planecheck: "
        "hot-loop\n", "            torch.zeros(1).item()\n",
        "_layout_sweep"),
    "core/plane.py": (
        "core/plane.py",
        "            pending, self._pending = self._pending, {}\n",
        "            torch.zeros(1).item()\n", "ArrayController.flush"),
    "models/decode.py": (
        "models/decode.py",
        "    cfg = model.cfg\n", "    tokens.sum().item()\n", "decode_step"),
}


@pytest.mark.parametrize("rel", sorted(HOT_LOOPS))
def test_injected_item_in_a_hot_loop_fails_the_gate(tmp_path, monkeypatch,
                                                    rel):
    shutil.copytree(os.path.join(REPO, "src", "repro_torch"),
                    tmp_path / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("*.cu", "__pycache__"))
    loop_file, needle, inject, symbol = HOT_LOOPS[rel]
    path = tmp_path / "src" / "repro_torch" / loop_file
    src = path.read_text()
    assert src.count(needle) == 1 and "planecheck: hot-loop" in src
    path.write_text(src.replace(needle, needle + inject))
    monkeypatch.chdir(tmp_path)
    findings, new = run(["src/repro_torch"], Baseline.load(BASELINE))
    assert [(f.rule, f.symbol) for f in new] == [("PC-H001", symbol)]
    assert planecheck_main(["src/repro_torch", "--check", "--baseline",
                            BASELINE]) == 1


def test_jax_gate_still_passes_over_the_whole_tree(monkeypatch):
    from repro.analysis import Baseline as JaxBaseline
    from repro.analysis import run as jax_run
    monkeypatch.chdir(REPO)
    _, new = jax_run(["src"], JaxBaseline.load("PLANECHECK_BASELINE.json"))
    assert new == []


# ---------------------------------------------------------------------------
# Runtime sanitizers
# ---------------------------------------------------------------------------

@pytest.fixture
def sanitizers(monkeypatch):
    monkeypatch.setenv("PLANECHECK_SANITIZERS", "1")
    runtime.reset_trace_counts()
    jax_runtime.reset_trace_counts()
    yield
    runtime.reset_trace_counts()
    jax_runtime.reset_trace_counts()


def test_sanitizers_off_do_nothing(monkeypatch):
    monkeypatch.delenv("PLANECHECK_SANITIZERS", raising=False)
    runtime.reset_trace_counts()
    runtime.record_trace("unit.off", shape=4)
    assert runtime.trace_counts() == {}
    mode = torch.cuda.get_sync_debug_mode() \
        if torch.cuda.is_available() else None
    with runtime.dispatch_guard():
        assert float(torch.ones(4).sum()) == 4.0
    if mode is not None:
        assert torch.cuda.get_sync_debug_mode() == mode


def test_record_trace_counts_as_jax_does(sanitizers):
    for rt in (runtime, jax_runtime):
        rt.record_trace("unit.test", shape=4)
        rt.record_trace("unit.test", shape=4)
        rt.record_trace("unit.test", shape=8, flags="x")
        rt.record_trace("other", shape=4)
    assert runtime.trace_counts() == jax_runtime.trace_counts()
    assert runtime.trace_counts("unit.") == {
        "unit.test{shape=4}": 2, "unit.test{flags=x,shape=8}": 1}
    assert runtime.excess_traces("unit.") == \
        jax_runtime.excess_traces("unit.") == {"unit.test{shape=4}": 2}


def test_a_library_loaded_twice_is_an_excess_build(sanitizers,
                                                   monkeypatch, tmp_path):
    # no nvcc here: each attempt records its build, then fails to compile
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    _build.load_library.cache_clear()
    try:
        for _ in range(2):
            with pytest.raises(RuntimeError, match="nvcc"):
                _build.load_library("ssm_scan.cu")
    finally:
        _build.load_library.cache_clear()
    (key, n), = runtime.excess_traces("kernels.build").items()
    assert key.startswith("kernels.build{digest=") and \
        key.endswith(",library=ssm_scan}") and n == 2


def test_dispatch_guard_without_a_card_passes_through(sanitizers):
    with runtime.dispatch_guard():
        assert torch.ones(3).sum().item() == 3.0
