"""The rules the port keeps: what it imports, what it copies, where it runs.

* No module of ``src/repro_torch/`` and not ``chip_smoke.py`` imports
  JAX or anything of the JAX package (an AST walk, so a lazy import
  inside a function counts too).
* The numpy copies have not drifted: every scenario the port copies
  builds demand and node memory equal byte for byte to the JAX
  package's, and the presets equal the JAX package's presets.
* The config copies equal the JAX configs field by field.
* Entry points run on CUDA unless asked for the CPU, and raise without
  a card (the plane's array backend and the device monitor too); a
  CUDA tensor never reaches the plain version, and a CPU tensor never
  launches a kernel.
* Each kernel library is built with its own flags and declarations;
  the sweep's flags, on which its bit parity rests, stay as they were.
"""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import repro.lab as jlab
from repro.configs import dynims as jd
from repro.configs import get_config as jax_config
from repro_torch.configs import dynims as td
from repro_torch.configs import get_config
from repro_torch.convert import gainset_from_numpy
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import sweep as ks
from repro_torch.lab import fused_sweep as fs
from repro_torch.lab import scenarios as tsc
from repro_torch.lab import sweep as tsw
from repro_torch.lab import tune as ttu
from repro_torch.launch import profile_serve as tprofile
from repro_torch.launch import serve as tserve
from repro_torch.launch import time_sweep as ttime
from repro_torch.models import Model
from repro_torch.serving import ServingConfig, ServingEngine

REPO = pathlib.Path(__file__).resolve().parents[1]


def _port_files():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_port_imports_nothing_of_jax_or_repro(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == [], f"{path.relative_to(REPO)} imports {bad}"


def test_import_rule_covers_every_package_of_the_port():
    """Each subpackage of the port (the runtime copies too) is walked."""
    walked = {p.parent.name for p in _port_files()}
    for pkg in ("core", "kernels", "lab", "runtime", "serving"):
        assert pkg in walked


def test_every_scenario_copy_builds_identical_inputs():
    copied = set(tsc.list_scenarios())
    assert copied == set(jlab.list_scenarios())
    for name in sorted(copied):
        js, ts = jlab.get_scenario(name), tsc.get_scenario(name)
        assert js.n_nodes == ts.n_nodes and js.n_intervals == ts.n_intervals
        for seed in (0, 3):
            a, b = js.build_demand(seed=seed), ts.build_demand(seed=seed)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
            a = js.build_node_memory(seed=seed)
            b = ts.build_node_memory(seed=seed)
            assert a.tobytes() == b.tobytes(), name


def test_presets_equal_the_jax_presets():
    for name, p in jd.LAB_TUNED.items():
        assert dataclasses.asdict(td.LAB_TUNED[name]) == \
            dataclasses.asdict(p)
    assert td.LAB_TUNED_OBJECTIVES == jd.LAB_TUNED_OBJECTIVES
    assert td.PAPER_SCENARIOS == jd.PAPER_SCENARIOS
    assert dataclasses.asdict(td.PAPER_TABLE_I) == \
        dataclasses.asdict(jd.PAPER_TABLE_I)


def test_simulator_configs_equal_the_jax_configs():
    """The cluster simulator's defaults, the paper's four configurations,
    the cache-parity oracle and Table I, field for field."""
    from repro.core import cluster_sim as jcs
    from repro_torch.core import cluster_sim as tcs
    pairs = [(jcs.SimConfig(name="x"), tcs.SimConfig(name="x")),
             (jcs.make_cache_parity_config(), tcs.make_cache_parity_config()),
             (jcs.paper_controller_params(), tcs.paper_controller_params()),
             (jcs.paper_controller_params(lam=1.2),
              tcs.paper_controller_params(lam=1.2))]
    pairs += [(jcs.make_paper_config(c), tcs.make_paper_config(c))
              for c in (1, 2, 3, 4)]
    for ref, got in pairs:
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    with pytest.raises(ValueError, match="1..4"):
        tcs.make_paper_config(5)


def test_tier_params_equal_the_jax_tier_params():
    for kw in ({}, dict(hbm_bytes=80 * 2**30), dict(u_max_frac=0.5, lam=1.2)):
        assert dataclasses.asdict(td.hbm_pool_params(**kw)) == \
            dataclasses.asdict(jd.hbm_pool_params(**kw))
    for kw in ({}, dict(u_max_frac=0.25, r0=0.9)):
        assert dataclasses.asdict(td.host_cache_params(512 * 2**30, **kw)) \
            == dataclasses.asdict(jd.host_cache_params(512 * 2**30, **kw))
    assert td.tuned_scenarios() == jd.tuned_scenarios()


def test_plane_and_monitor_raise_without_cuda(monkeypatch):
    """No device means the card, for the plane's array backend and the
    device monitor alike; the scalar backend is host float64 and needs
    none.  On the CPU device the monitor reads as JAX's does there."""
    import jax
    from repro.core import DeviceMemoryMonitor as JaxMonitor
    from repro_torch.core import (ArrayController, DeviceMemoryMonitor,
                                  MemoryPlane, PlaneSpec)
    cpu = DeviceMemoryMonitor("cpu", node="cpu:0").sample()
    ref = JaxMonitor(jax.devices()[0]).sample()
    assert (cpu.node, cpu.used, cpu.total) == (ref.node, ref.used, ref.total)
    assert DeviceMemoryMonitor("cpu").node == ref.node
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = td.hbm_pool_params()
    for call in (lambda: MemoryPlane(PlaneSpec(params=params)),
                 lambda: ArrayController(params),
                 DeviceMemoryMonitor):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    MemoryPlane(PlaneSpec(params=params, backend="scalar")).tick()


def test_entry_points_raise_without_cuda_when_no_device_given(monkeypatch):
    from repro_torch.core import MemoryPlane, PlaneSpec, cluster_sim
    plane = MemoryPlane(PlaneSpec(params=td.PAPER_TABLE_I, backend="scalar",
                                  record=4))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = tsc.get_scenario("swap-storm").replace(n_nodes=4, n_intervals=8)
    g = ttu.grid_gains(lam=(0.5,), r0=(0.95,))
    demand = spec.build_demand()
    calls = [
        lambda: ttu.tune_portfolio([spec], budget=4),
        lambda: ttu.retune_online(plane, capture=object(), block=False),
        lambda: cluster_sim.simulate_fleet(4, 8),
        lambda: cluster_sim.simulate_fleet(4, 8, engine="python"),
        lambda: tsw.sweep_demand(demand, g, node_memory=125 * 2**30),
        lambda: tsw.run_sweep(spec, g),
        lambda: ttu.tune_gains(spec, budget=4),
        lambda: ttu.halving_tune(spec, budget=4),
        lambda: ttu.halving_tune(tsc.get_scenario("limplock").replace(
            n_intervals=8), budget=4, objective="makespan"),
        lambda: fs.halving_sweep(demand, g, g, node_memory=125 * 2**30),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_serving_entry_points_raise_without_cuda(monkeypatch):
    cfg = get_config("llama3.2-1b-smoke")
    cpu_model = Model(cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: Model(cfg),
        lambda: ServingEngine(cpu_model, ServingConfig()),
        lambda: tserve.main(["--requests", "1"]),
        tprofile.main,
        ttime.main,
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="lies on cpu"):
        ServingEngine(cpu_model, ServingConfig(), device="meta")


@pytest.mark.parametrize("arch", ["llama3.2-1b", "llama3.2-1b-smoke"])
def test_config_copies_equal_the_jax_configs(arch):
    port, ref = get_config(arch), jax_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.padded_vocab == ref.padded_vocab
    assert port.n_params() == ref.n_params()


def test_unported_archs_raise_naming_the_roadmap():
    with pytest.raises(KeyError, match="ROADMAP A5"):
        get_config("xlstm-125m")


def test_cpu_tensors_never_launch_the_attention_kernels():
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 4, 32), generator=g)
    kc = torch.randn((2, 40, 2, 32), generator=g)
    before = (da.LAUNCHES, fa.LAUNCHES)
    da.decode_attention(q, kc, kc, torch.tensor([3, 40], dtype=torch.int32))
    x = torch.randn((1, 20, 4, 32), generator=g)
    fa.flash_attention(x, x[:, :, :2], x[:, :, 2:])
    Model(get_config("llama3.2-1b-smoke"), device="cpu")(
        torch.zeros((1, 5), dtype=torch.long))
    assert (da.LAUNCHES, fa.LAUNCHES) == before


class _OnCuda:
    """Stands in for a CUDA tensor: dispatch reads only ``.device``."""

    device = torch.device("cuda", 0)


def test_cuda_tensors_launch_the_kernel_and_never_the_plain_version(
        monkeypatch):
    launched = []

    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(ks, "sweep_segment_plain", plain)
    monkeypatch.setattr(ks, "_launch",
                        lambda *a, **k: launched.append(a) or "kernel")
    out = ks.sweep_segment(_OnCuda(), None, None, None, None, None, t0=0,
                           con=None, names=())
    assert out == "kernel" and len(launched) == 1
    meta = torch.empty((1, 1, 1), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ks.sweep_segment(meta, None, None, None, None, None, t0=0,
                         con=None, names=())


def test_each_library_has_its_flags_and_declarations():
    """The sweep keeps exactly the flags (and so the library hash) it
    was measured with, and the scan, held bit for bit too, shares them;
    the attention libraries drop only -fmad=false, and every declared
    symbol is exported by its source."""
    from repro_torch.kernels import _build
    assert _build.NVCC_FLAGS == (
        "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
    exact = ("sweep.cu", "ssm_scan.cu")
    for name in exact:
        assert _build.LIBRARIES[name].flags is _build.NVCC_FLAGS
    for name, spec in _build.LIBRARIES.items():
        src = (REPO / "src/repro_torch/csrc" / name).read_text()
        assert f'extern "C" int {spec.symbol}(' in src
        assert len(spec.argtypes()) == src[src.index(spec.symbol):].split(
            ")")[0].count(",") + 1
        if name not in exact:
            assert spec.flags == tuple(
                f for f in _build.NVCC_FLAGS if f != "-fmad=false")
    with pytest.raises(KeyError, match="no library"):
        _build.load_library("nothing.cu")


def test_kernel_layout_and_build_flags():
    """The wrapper's plane order and the flags parity depends on."""
    from repro_torch.kernels import _build
    assert "-fmad=false" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert not any("fast_math" in f for f in _build.NVCC_FLAGS)
    src = (REPO / "src/repro_torch/csrc/sweep.cu").read_text()
    assert "extern \"C\" int dynims_sweep_segment(" in src
    fields = [f for f, _ in ks._SweepConsts._fields_]
    body = src[src.index("struct SweepConsts {"):src.index("};")]
    decl = [ln.split("//")[0].split() for ln in body.splitlines()[1:]]
    assert [d[-1].rstrip(";") for d in decl if d] == fields
    assert ks.state_names(True, False)[:1] == ("u",)
    assert len(ks.state_names(False, True)) == 18
    assert ks.state_names(False, True, True)[18:] == (
        "sidx", "wleft", "wd", "wd_c", "t_done")
    assert f"constexpr int kThreads = {ks.KERNEL_THREADS};" in src


def test_convert_checks_gainset_fields():
    g = jlab.grid_gains(lam=(0.5, 1.0), r0=(0.95,))
    fields = {f.name: getattr(g, f.name) for f in dataclasses.fields(g)}
    port = gainset_from_numpy(fields)
    for name, arr in fields.items():
        np.testing.assert_array_equal(getattr(port, name), arr)
    fields.pop("deadband")
    with pytest.raises(ValueError, match="deadband"):
        gainset_from_numpy(fields)


def test_build_dir_is_ignored_by_git():
    assert "build/" in (REPO / ".gitignore").read_text().split()
