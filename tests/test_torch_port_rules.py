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
* The fleet and chaos copies: the fleet scenarios build demand equal
  byte for byte, their specs equal the JAX package's field by field,
  and the fault catalog is JAX's.
* The training copies: ``write_corpus`` writes JAX's bytes, the
  pipeline, step and trainer configs equal JAX's field by field, and
  the trainer, the pipeline's staging, the training CLI and a
  checkpoint's restore raise without a card.  The kernels refuse
  inputs that require grad, since they have no backward.
"""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import repro.lab as jlab
from repro.configs import dynims as jd
from repro.configs import ARCH_IDS as jax_arch_ids
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

# One intra-op thread: the suite's workers share the cores, and torch's
# OpenMP threads, oversubscribed, spin-wait ~100x longer than the ops.
torch.set_num_threads(1)

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
    for pkg in ("analysis", "checkpoint", "core", "data", "fleet",
                "kernels", "lab", "launch", "optim", "roofline", "runtime",
                "serving", "train"):
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


def test_fleet_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch import fleet as tf
    from repro_torch.core import NodeSpec, PlaneSpec, SimulatedMonitor
    from repro_torch.launch import chaos_drill
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = ttu.grid_gains(lam=(0.5,), r0=(0.95,))
    demand = np.full((2, 3, 8), 30.0 * 2**30)
    node = NodeSpec("n0", monitor=SimulatedMonitor(
        "n0", total=125 * 2**30, usage=lambda k: 2**30))
    tenant = tf.TenantSpec("t", PlaneSpec(params=td.PAPER_TABLE_I,
                                          nodes=(node,)))
    calls = [
        lambda: tf.fleet_sweep_demand(demand, g, node_memory=125 * 2**30,
                                      weights=np.ones(2),
                                      floors=np.zeros(2), epoch_intervals=4),
        lambda: tf.run_fleet_sweep("tenant-churn", g),
        lambda: tf.FleetPlane(tf.FleetSpec(tenants=(tenant,))),
        lambda: chaos_drill.main(["--smoke"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


@pytest.mark.parametrize("name", ["hpcc-spark", "tenant-churn"])
def test_fleet_scenario_copies_build_identical_demand(name):
    from repro.fleet import get_fleet_scenario as jax_fleet
    from repro_torch.fleet import get_fleet_scenario
    js, ts = jax_fleet(name), get_fleet_scenario(name)
    for seed in (0, 5):
        a, b = js.build_demand(seed=seed), ts.build_demand(seed=seed)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), (name, seed)
    assert ts.weights().tobytes() == js.weights().tobytes()
    assert ts.floors_bytes().tobytes() == js.floors_bytes().tobytes()
    assert ts.priority_order() == js.priority_order()
    assert (ts.n_tenants, ts.n_nodes, ts.n_intervals, ts.interval_s) == \
        (js.n_tenants, js.n_nodes, js.n_intervals, js.interval_s)


def _fields(cls):
    return [(f.name, f.default, str(f.type)) for f in dataclasses.fields(cls)]


def test_fleet_specs_equal_the_jax_specs_field_by_field():
    import repro.fleet as JF
    import repro_torch.fleet as TF
    for name in ("TenantSpec", "FleetSpec", "FleetScenario", "FleetTenant",
                 "TenantTelemetry", "FleetGrant"):
        assert _fields(getattr(TF, name)) == _fields(getattr(JF, name)), name
    assert TF.POLICIES == JF.POLICIES
    assert TF.MIN_TENANT_BUDGET == JF.MIN_TENANT_BUDGET
    assert sorted(TF.__all__) == sorted(JF.__all__)
    assert TF.list_fleet_scenarios() == JF.list_fleet_scenarios()
    for name in TF.list_fleet_scenarios():
        ts, js = TF.get_fleet_scenario(name), JF.get_fleet_scenario(name)
        for f in ("name", "policy", "epoch_intervals", "node_memory_gib",
                  "description"):
            assert getattr(ts, f) == getattr(js, f), (name, f)
        for tt, jt in zip(ts.tenants, js.tenants, strict=True):
            assert (tt.name, tt.weight, tt.priority, tt.floor_gib) == \
                (jt.name, jt.weight, jt.priority, jt.floor_gib)
            if isinstance(jt.scenario, str):
                assert tt.scenario == jt.scenario
            else:
                assert dataclasses.asdict(tt.scenario) == \
                    dataclasses.asdict(jt.scenario)


def test_chaos_catalog_equals_the_jax_catalog():
    import repro.runtime as JR
    import repro_torch.runtime as TR
    assert TR.FAULT_KINDS == JR.FAULT_KINDS
    assert TR.TELEMETRY_KINDS == JR.TELEMETRY_KINDS
    assert TR.ACTUATION_KINDS == JR.ACTUATION_KINDS
    for name in ("FaultSpec", "ChaosSpec", "InjectedFault"):
        assert _fields(getattr(TR, name)) == _fields(getattr(JR, name)), name


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


@pytest.mark.parametrize("arch", ["llama3.2-1b", "llama3.2-1b-smoke",
                                  "gemma3-1b", "gemma3-1b-smoke",
                                  "qwen2-1.5b", "qwen2-1.5b-smoke",
                                  "qwen2-moe-a2.7b", "qwen2-moe-a2.7b-smoke",
                                  "dbrx-132b", "dbrx-132b-smoke",
                                  "mistral-large-123b",
                                  "mistral-large-123b-smoke",
                                  "llama-3.2-vision-11b",
                                  "llama-3.2-vision-11b-smoke",
                                  "whisper-large-v3",
                                  "whisper-large-v3-smoke",
                                  "xlstm-125m", "xlstm-125m-smoke"])
def test_config_copies_equal_the_jax_configs(arch):
    port, ref = get_config(arch), jax_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.padded_vocab == ref.padded_vocab
    assert port.n_params() == ref.n_params()


def test_unported_archs_raise_naming_the_roadmap():
    """Every arch of the JAX registry is ported (ROADMAP A5.3 is done);
    a name outside the registry raises, naming the archs there are."""
    with pytest.raises(KeyError, match="unknown arch 'xlstm-350m'.*"
                                       "xlstm-125m"):
        get_config("xlstm-350m")


@pytest.mark.parametrize("arch", jax_arch_ids)
def test_every_jax_arch_builds_forwards_and_trains_in_the_port(arch):
    """For every name of JAX's registry: the port's config equals JAX's,
    full and ``-smoke``; ``check_supported`` raises for neither; the
    ``-smoke`` model builds, forwards to finite logits and takes one
    train step on the CPU, its loss finite."""
    from repro_torch.models.transformer import check_supported
    from repro_torch.train import TrainStepConfig
    from repro_torch.train.step import (build_train_step, init_train_state,
                                        model_params)
    for name in (arch, arch + "-smoke"):
        port, ref = get_config(name), jax_config(name)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        check_supported(port)
    cfg = get_config(arch + "-smoke")
    model = Model(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen)
    ctx = {}
    if cfg.family == "vlm":
        ctx["images"] = torch.randn((2, cfg.vision_tokens, cfg.d_model),
                                    generator=gen)
    if cfg.family == "audio":
        ctx["frames"] = torch.randn((2, 6, cfg.d_model), generator=gen)
    assert bool(torch.isfinite(model(tokens, **ctx)).all())
    step_cfg = TrainStepConfig(total_steps=4)
    params = model_params(model)
    new, _, metrics = build_train_step(model, step_cfg)(
        params, init_train_state(params, step_cfg), {"tokens": tokens, **ctx})
    assert np.isfinite(float(metrics["loss"]))
    assert sorted(new) == sorted(params)


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
    assert f"constexpr int kGraphThreads = {ks.GRAPH_THREADS};" in src
    assert f"constexpr int kMaxCluster = {ks.MAX_CLUSTER};" in src
    assert (f"return has_cache ? {ks.WIDE_LOOPS[True]} : "
            f"{ks.WIDE_LOOPS[False]};") in src
    assert "extern \"C\" int dynims_graph_segment(" in src


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


@pytest.mark.parametrize("kw", [
    dict(n_shards=6, tokens_per_shard=2048, vocab_size=101, seed=3),
    dict(n_shards=3, tokens_per_shard=500, vocab_size=128256, seed=0,
         zipf_exponent=0.0)], ids=["zipf", "uniform"])
def test_write_corpus_copy_writes_jax_bytes(tmp_path, kw):
    from repro.data import write_corpus as jax_write_corpus
    from repro_torch.data import write_corpus
    man = write_corpus(str(tmp_path / "p"), **kw)
    assert man.__dict__ == jax_write_corpus(str(tmp_path / "j"), **kw).__dict__
    names = sorted(p.name for p in (tmp_path / "p").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir())
    assert "manifest.json" in names and len(names) == kw["n_shards"] + 1
    for name in names:
        assert (tmp_path / "p" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name


def _defaults(cls):
    out = []
    for f in dataclasses.fields(cls):
        d = f.default
        out.append((f.name, getattr(d, "__name__", d), str(f.type)))
    return out


def test_training_configs_equal_the_jax_configs_field_by_field():
    """Names, defaults (a schedule by its function's name) and types."""
    import repro.data as JD
    import repro.train as JT
    import repro_torch.data as TD
    import repro_torch.train as TT
    assert _defaults(TD.PipelineConfig) == _defaults(JD.PipelineConfig)
    assert _defaults(TT.TrainStepConfig) == _defaults(JT.TrainStepConfig)
    assert _defaults(TT.TrainerConfig) == _defaults(JT.TrainerConfig)
    assert TT.TrainStepConfig().schedule.__module__ == \
        "repro_torch.optim.schedules"


# Names of the JAX package's ``__all__`` the port leaves out by design
# (ROADMAP A): the ParamDef schema and what it derives -- the port's
# Model builds its nn.Modules, Model.specs gives the specs and a meta
# Model the shapes.
NOT_PORTED_BY_DESIGN = {
    "repro.models": {"ParamDef", "Schema", "init_params", "param_shapes",
                     "param_specs", "stack_schema"},
}


def test_training_package_names_equal_jax():
    import repro.checkpoint as JC
    import repro.data as JD
    import repro.optim as JO
    import repro.train as JT
    import repro_torch.checkpoint as TC
    import repro_torch.data as TD
    import repro_torch.optim as TO
    import repro_torch.train as TT
    for ref, port in ((JC, TC), (JD, TD), (JO, TO), (JT, TT)):
        assert sorted(port.__all__) == sorted(ref.__all__)
    import repro.launch as JL
    import repro.models as JM
    import repro.runtime as JR
    import repro_torch.launch as TL
    import repro_torch.models as TM
    import repro_torch.runtime as TR
    for ref, port in ((JM, TM), (JR, TR), (JL, TL)):
        want = set(getattr(ref, "__all__", ())) \
            - NOT_PORTED_BY_DESIGN.get(ref.__name__, set())
        assert want <= set(getattr(port, "__all__", ())), ref.__name__
        for name in want:
            assert hasattr(port, name), (ref.__name__, name)


def test_training_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import (DataPipeline, PipelineConfig, ShardStore,
                                  write_corpus)
    from repro_torch.launch import train as ttrain
    from repro_torch.train import Trainer, TrainerConfig, TrainStepConfig
    write_corpus(str(tmp_path / "c"), n_shards=2, tokens_per_shard=256,
                 vocab_size=503)
    pipe = DataPipeline(ShardStore(str(tmp_path / "c")), PipelineConfig(
        batch_size=2, seq_len=8, prefetch_depth=0, dynims=False))
    model = Model(get_config("llama3.2-1b-smoke"), device="cpu")
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: Trainer(model, pipe, TrainStepConfig(), TrainerConfig(
            checkpoint_dir=str(tmp_path / "ck"))),
        lambda: pipe.to_device(pipe.batch(0)),
        lambda: ttrain.main(["--steps", "1"]),
        lambda: ckpt.restore_latest({"a": torch.zeros(1)}),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_trainer_refuses_a_model_on_another_device(tmp_path):
    from repro_torch.train import Trainer, TrainerConfig, TrainStepConfig
    model = Model(get_config("llama3.2-1b-smoke"), device="cpu")
    with pytest.raises(ValueError, match="lies on cpu"):
        Trainer(model, None, TrainStepConfig(),
                TrainerConfig(checkpoint_dir=str(tmp_path)), device="meta")


def _grad_inputs():
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 6, 4, 16), generator=g)
    dq = torch.randn((1, 4, 16), generator=g)
    kc = torch.randn((1, 6, 2, 16), generator=g)
    a = torch.rand((1, 5, 3, 2), generator=g)
    return q, dq, kc, a


@pytest.mark.parametrize("kernel", ["flash", "decode", "scan"])
def test_kernel_wrappers_refuse_inputs_that_require_grad(kernel):
    """No kernel has a backward: under grad mode an input that requires
    grad raises (naming the plain path to use), on the CPU as on the
    card; under no_grad, or with no input requiring grad, it runs."""
    from repro_torch.kernels import ssm_scan as kscan
    q, dq, kc, a = _grad_inputs()
    lens = torch.tensor([5], dtype=torch.int32)
    h0 = torch.zeros((1, 3, 2))
    call = {
        "flash": lambda x: fa.flash_attention(x, kc, kc),
        "decode": lambda x: da.decode_attention(x, kc, kc, lens),
        "scan": lambda x: kscan.ssm_scan(x, a, h0),
    }[kernel]
    x = {"flash": q, "decode": dq, "scan": a}[kernel].clone()
    plain = call(x)
    x.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward.*differentiable"):
        call(x)
    with torch.no_grad():
        assert torch.equal(call(x), plain)
