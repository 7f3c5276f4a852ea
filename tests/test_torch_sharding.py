"""The port's sharding substrate against the JAX package, on the CPU.

* the parameter specs (``Model.specs``) leaf for leaf against JAX's
  ``Model(cfg, axes=...).specs()`` for every arch and its smoke config
  under the three ``Axes``, JAX's stacked leading layer axes dropped
  (leaves matched through ``convert.py``'s name map); ``state_specs``
  at every decode cell's shape, and ``opt_state_specs``;
* ``sharding_report``, ``cells``, ``all_configs``, ``CellSettings``,
  ``DRYRUN_SETTINGS`` and ``cell_settings`` equal JAX's, and
  ``batch_inputs`` gives JAX's shapes, dtypes and specs;
* per-chip ``argument_size_in_bytes`` at full width, for all 66 (cell,
  mesh) pairs, equals the ``shard_shape`` bytes of JAX's ``build_cell``
  inputs leaf for leaf and in total.  JAX's come from one subprocess
  with 512 forced host devices and an Auto-axis ``jax.sharding.Mesh``
  entered as ``with mesh:``, with no lowering (``jax.make_mesh`` +
  ``jax.set_mesh`` cannot lower a cell on this jax: ROADMAP C32);
* the dry-run's counts are ``tests/test_torch_dryrun.py``'s.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.launch.cells as JCELLS
from repro.models import decode as JD
from repro.models import params as JP
from repro.models.transformer import Model as JModel
from repro.optim.adamw import opt_state_specs as jax_opt_state_specs
from repro_torch.configs import (ARCH_IDS, SHAPES, all_configs, cells,
                                 get_config, get_shape)
from repro_torch.convert import _port_arrays
from repro_torch.launch import cells as TCELLS
from repro_torch.launch.mesh import Mesh
from repro_torch.models import Model
from repro_torch.models import decode as TD
from repro_torch.models.params import (MULTI_POD_AXES, SINGLE_POD_AXES,
                                       UNSHARDED_AXES, Spec, axes_for,
                                       shard_shape)
from repro_torch.optim import opt_state_specs
from repro_torch.roofline.sharding import argument_bytes

torch.set_num_threads(1)

AXES = {"single": (SINGLE_POD_AXES, JP.SINGLE_POD_AXES),
        "multi": (MULTI_POD_AXES, JP.MULTI_POD_AXES),
        "unsharded": (UNSHARDED_AXES, JP.UNSHARDED_AXES)}
NAMES = [n for a in ARCH_IDS for n in (a, a + "-smoke")]
POD1 = Mesh((16, 16), ("data", "model"))
POD2 = Mesh((2, 16, 16), ("pod", "data", "model"))
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _padded(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


def _jax_leaves_by_port_name(schema, cfg):
    """{port parameter name: JAX ParamDef} through convert's name map."""
    leaves, tdef = jax.tree.flatten(schema, is_leaf=JP.is_leaf)
    ids = [np.broadcast_to(np.array(i), d.shape) for i, d in enumerate(leaves)]
    named = _port_arrays(jax.tree.unflatten(tdef, ids), cfg)
    return {n: leaves[int(np.asarray(a).flat[0])] for n, a in named.items()}


def _assert_leaf_spec(name, jdef, port_shape, port_spec):
    k = len(jdef.shape) - len(port_shape)
    js = _padded(jdef.spec, len(jdef.shape))
    assert js[:k] == (None,) * k, (name, js)
    assert js[k:] == _padded(port_spec, len(port_shape)), (name, js, port_spec)


# ---- specs ---------------------------------------------------------------

@pytest.mark.parametrize("axes", list(AXES))
@pytest.mark.parametrize("name", NAMES)
def test_param_specs_equal_jax_leaf_for_leaf(name, axes):
    taxes, jaxes = AXES[axes]
    cfg = get_config(name)
    model = Model(cfg, device="meta", init=False)
    specs = model.specs(taxes)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert list(specs) == list(shapes)
    jm = JModel(JC.get_config(name), axes=jaxes)
    ref = _jax_leaves_by_port_name(jm.schema(), cfg)
    assert set(ref) == set(specs)
    for n, jdef in ref.items():
        assert tuple(jdef.shape[len(jdef.shape) - len(shapes[n]):]) == shapes[n]
        _assert_leaf_spec(n, jdef, shapes[n], specs[n])


def _state_leaf(state, path, family):
    last = path[-1]
    if path in (("pos",), ("enc_len",)):
        return getattr(state, last), False
    if family == "ssm":
        return state.recurrent[path[-2]][last], True
    return getattr(state, {"h": "mamba_h", "conv": "mamba_conv"}.get(
        last, last)), True


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


DECODE_CELLS = [(n, s.name) for n in NAMES for s in SHAPES.values()
                if s.kind == "decode" and get_config(n).supports_shape(s)]


@pytest.mark.parametrize("axes", list(AXES))
@pytest.mark.parametrize("name,shape", DECODE_CELLS)
def test_state_specs_equal_jax(name, shape, axes):
    taxes, jaxes = AXES[axes]
    cfg, shp = get_config(name), get_shape(shape)
    model = Model(cfg, device="meta", init=False)
    b, s = shp.global_batch, shp.seq_len
    specs = TD.state_specs(model, b, s, taxes)
    state = TD.init_state(model, b, s)
    sch = JD.state_schema(JModel(JC.get_config(name), axes=jaxes), b, s)
    n = 0
    for path, jdef in _flat(sch):
        t, stacked = _state_leaf(state, path, cfg.family)
        sp, _ = _state_leaf(specs, path, cfg.family)
        k = len(jdef.shape) - t.dim()
        if stacked:             # the port stacks every layer on one axis
            assert tuple(jdef.shape[k + 1:]) == tuple(t.shape[1:]), path
        else:
            assert tuple(jdef.shape) == tuple(t.shape), path
        _assert_leaf_spec(path, jdef, t.shape, sp)
        n += 1
    assert n > 1


@pytest.mark.parametrize("name", ["llama3.2-1b", "qwen2-moe-a2.7b",
                                  "hymba-1.5b-smoke"])
def test_opt_state_specs_equal_jax(name):
    """The moments take their parameters' specs and the step is
    replicated, as JAX's ``opt_state_specs`` gives them."""
    specs = Model(get_config(name), device="meta",
                  init=False).specs(SINGLE_POD_AXES)
    ours = opt_state_specs(specs)
    jspecs = JModel(JC.get_config(name), axes=JP.SINGLE_POD_AXES).specs()
    ref = jax_opt_state_specs(jspecs)
    assert tuple(ours.step) == tuple(ref.step) == ()
    assert ref.mu is jspecs and ref.nu is jspecs
    assert ours.mu == specs and ours.nu == specs


def test_spec_prepends_a_layer_axis_and_shard_shape_raises_as_jax():
    s = Spec("data", ("pod", "model"))
    assert s.with_layer_axis() == Spec(None, "data", ("pod", "model"))
    assert s.axes() == ("data", "pod", "model")
    assert shard_shape((32, 64, 3), s, POD2) == (2, 2, 3)
    with pytest.raises(ValueError, match="evenly divide"):
        shard_shape((24, 64), s, POD2)
    with pytest.raises(ValueError, match="lacks"):
        shard_shape((32, 64), s, POD1)
    assert axes_for(POD1) == SINGLE_POD_AXES
    assert axes_for(POD2) == MULTI_POD_AXES
    assert axes_for(Mesh((1,), ("x",))) == UNSHARDED_AXES


# ---- reports, cells, settings, batches -----------------------------------

@pytest.mark.parametrize("mesh", [(16, 16), (4, 2), (8, 4), (2, 16)])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_sharding_report_equals_jax(arch, mesh):
    assert get_config(arch).sharding_report(*mesh) == \
        JC.get_config(arch).sharding_report(*mesh)


def test_cells_configs_and_settings_equal_jax():
    assert cells() == JC.cells()
    assert cells(True) == JC.cells(True)
    assert len(cells()) == 33
    ours, ref = all_configs(), JC.all_configs()
    assert list(ours) == list(ref)
    for a in ours:
        assert dataclasses.asdict(ours[a]) == dataclasses.asdict(ref[a])
    assert dataclasses.asdict(TCELLS.CellSettings()) == \
        dataclasses.asdict(JCELLS.CellSettings())
    assert [f.name for f in dataclasses.fields(TCELLS.CellSettings)] == \
        [f.name for f in dataclasses.fields(JCELLS.CellSettings)]
    assert {k: dataclasses.asdict(v)
            for k, v in TCELLS.DRYRUN_SETTINGS.items()} == \
        {k: dataclasses.asdict(v) for k, v in JCELLS.DRYRUN_SETTINGS.items()}
    for arch, shape in cells(True):
        assert dataclasses.asdict(TCELLS.cell_settings(arch, shape)) == \
            dataclasses.asdict(JCELLS.cell_settings(arch, shape))


# ---- the JAX reference at full width, one subprocess ---------------------

JAX_ARGS_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json
import numpy as np
import jax
from jax.sharding import Mesh
from repro.configs import cells
from repro.launch.cells import build_cell
out = {}
for mp in (False, True):
    shape = (2, 16, 16) if mp else (16, 16)
    axes = ("pod", "data", "model") if mp else ("data", "model")
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                axes)
    with mesh:
        for arch, shp in cells():
            fn, inputs, desc = build_cell(arch, shp, mesh)
            rec = {}
            for path, leaf in jax.tree_util.tree_leaves_with_path(inputs):
                n = int(np.prod(leaf.sharding.shard_shape(leaf.shape)))
                rec[jax.tree_util.keystr(path)] = [
                    n * leaf.dtype.itemsize, list(leaf.shape),
                    str(leaf.dtype),
                    [list(p) if isinstance(p, tuple) else p
                     for p in leaf.sharding.spec]]
            out[f"{arch}|{shp}|{'pod2' if mp else 'pod1'}"] = rec
print(json.dumps(out))
"""


def _run_jax(script, timeout=600):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, env=env, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def jax_args():
    return _run_jax(JAX_ARGS_SCRIPT)


def _jax_param_path(cfg):
    """{port parameter name: JAX keystr of its stacked leaf}."""
    schema = JModel(JC.get_config(cfg.name), axes=JP.SINGLE_POD_AXES).schema()
    paths = {id(d): jax.tree_util.keystr(p) for p, d in
             jax.tree_util.tree_leaves_with_path(schema, is_leaf=JP.is_leaf)}
    return {n: paths[id(d)]
            for n, d in _jax_leaves_by_port_name(schema, cfg).items()}


def _group(port_bytes, key):
    out = {}
    for path, n in port_bytes.items():
        k = key(path)
        out[k] = out.get(k, 0) + n
    return out


@pytest.mark.parametrize("arch,shape", cells())
def test_argument_bytes_equal_jax_at_full_width(arch, shape, jax_args):
    cfg = get_config(arch)
    to_jax = _jax_param_path(cfg)
    kind = get_shape(shape).kind
    for tag, mesh in (("pod1", POD1), ("pod2", POD2)):
        ref = jax_args[f"{arch}|{shape}|{tag}"]
        fn, inputs, desc = TCELLS.build_cell(arch, shape, mesh)
        ours = argument_bytes(inputs, mesh)
        assert sum(ours.values()) == sum(v[0] for v in ref.values()), tag

        def key(path):
            head, _, rest = path.partition(".")
            if head == "0":
                return "[0]" + to_jax[rest]
            if kind == "train" and head == "1":      # the AdamW state
                if rest == "adam.step":
                    return "[1].adam.step"
                _, moment, name = rest.split(".", 2)
                return f"[1].adam.{moment}{to_jax[name]}"
            return path

        grouped = _group(ours, key)
        jgrouped = {k: v[0] for k, v in ref.items()}
        params = {k: v for k, v in grouped.items() if k.startswith("[0]")}
        jparams = {k: v for k, v in jgrouped.items() if k.startswith("[0]")}
        assert params == jparams, tag
        if kind == "train":
            moments = {k: v for k, v in grouped.items()
                       if k.startswith("[1].adam.")}
            jmoments = {k: v for k, v in jgrouped.items()
                        if k.startswith("[1].adam.")}
            assert moments == jmoments, tag
            batch = {k.split(".")[1]: v for k, v in grouped.items()
                     if k.startswith("2.")}
            jbatch = {k.split("'")[1]: v for k, v in jgrouped.items()
                      if k.startswith("[2]")}
            assert batch == jbatch, tag
        elif kind == "prefill":
            batch = {k.split(".")[1]: v for k, v in grouped.items()
                     if k.startswith("1.")}
            jbatch = {k.split("'")[1]: v for k, v in jgrouped.items()
                      if k.startswith("[1]")}
            assert batch == jbatch, tag
        else:       # the decode state by its leaves' names, and the tokens
            def leaf_name(path):
                last = path.rsplit(".", 1)[-1]
                return {"mamba_h": "h", "mamba_conv": "conv"}.get(last, last)
            # (the ssm family's k and v stack no layer: 0 bytes)
            state = _group({k: v for k, v in ours.items()
                            if k.startswith("1.") and v}, leaf_name)
            jstate = _group({k: v[0] for k, v in ref.items()
                             if k.startswith("[1]")},
                            lambda p: p.rsplit("'", 2)[-2])
            assert state == jstate, tag
            assert ours["2"] == ref["[2]"][0], tag


@pytest.mark.parametrize("arch", ["whisper-large-v3", "llama-3.2-vision-11b",
                                  "llama3.2-1b"])
def test_batch_inputs_equal_jax(arch, jax_args):
    cfg = get_config(arch)
    for kind, shape in (("train", "train_4k"), ("prefill", "prefill_32k")):
        ref = jax_args[f"{arch}|{shape}|pod2"]
        batch = TCELLS.batch_inputs(cfg, get_shape(shape), MULTI_POD_AXES,
                                    POD2, with_labels=kind == "train")
        idx = "[2]" if kind == "train" else "[1]"
        jbatch = {k.split("'")[1]: v for k, v in ref.items()
                  if k.startswith(idx)}
        assert set(batch) == set(jbatch)
        for name, t in batch.items():
            nbytes, shp, dtype, spec = jbatch[name]
            assert list(t.shape) == shp and str(t.dtype) == "torch." + dtype
            assert [list(p) if isinstance(p, tuple) else p
                    for p in t.spec] == spec
            assert t.device.type == "meta"
