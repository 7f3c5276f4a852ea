"""The port's checkpoints: JAX's layout, atomicity, manifest checks,
retention and async staging (``tests/test_checkpoint.py``'s cases), the
leaves' names checked on restore, the files equal to JAX's for the
same tree, and the trainer's tree of every family's ``-smoke`` model
saved and restored."""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_pytree as jax_save_pytree
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_pytree, save_pytree)
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.optim import AdamWState
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.train.step import model_params

# One intra-op thread: the suite's workers share the cores, and torch's
# OpenMP threads, oversubscribed, spin-wait ~100x longer than the ops.
torch.set_num_threads(1)


def tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.normal(0, 1, (4, 8)).astype(np.float32)),
            "b": {"c": torch.from_numpy(
                rng.integers(0, 9, (3,)).astype(np.int32))},
            "step": 7}


def test_roundtrip(tmp_path):
    t = tree()
    save_pytree(t, str(tmp_path), 5)
    out = restore_pytree(tree(seed=1), str(tmp_path), 5, device="cpu")
    assert torch.equal(out["a"], t["a"])
    assert torch.equal(out["b"]["c"], t["b"]["c"])
    assert out["b"]["c"].dtype == torch.int32 and out["step"] == 7


def test_layout_and_leaves_equal_jax(tmp_path):
    """The same tree saved by both packages: the same files, the same leaf
    order (sorted keys) and bytes, and the manifest's shapes and dtypes."""
    t = tree()
    port = save_pytree(t, str(tmp_path / "port"), 12)
    ref = jax_save_pytree({"a": jnp.asarray(t["a"].numpy()),
                           "b": {"c": jnp.asarray(t["b"]["c"].numpy())},
                           "step": 7}, str(tmp_path / "jax"), 12)
    assert os.path.basename(port) == os.path.basename(ref) == \
        "step-000000012"
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    for name in os.listdir(port):
        if name.startswith("leaf-"):
            assert np.load(os.path.join(port, name)).tobytes() == \
                np.load(os.path.join(ref, name)).tobytes(), name
    mp, mj = (json.load(open(os.path.join(d, "manifest.json")))
              for d in (port, ref))
    assert (mp["step"], mp["n_leaves"]) == (mj["step"], mj["n_leaves"])
    assert [{k: r[k] for k in ("shape", "dtype")} for r in mp["leaves"]] \
        == mj["leaves"]
    assert [r["name"] for r in mp["leaves"]] == ["a", "b.c", "step"]


def test_incomplete_checkpoint_invisible(tmp_path):
    path = save_pytree(tree(), str(tmp_path), 5)
    os.remove(os.path.join(path, "_COMPLETE"))
    assert latest_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        restore_pytree(tree(), str(tmp_path), 5, device="cpu")


@pytest.mark.parametrize("bad", ["shape", "name", "count"])
def test_mismatch_rejected(tmp_path, bad):
    save_pytree(tree(), str(tmp_path), 1)
    t = tree()
    if bad == "shape":
        t["a"] = torch.zeros((2, 2))
    elif bad == "name":
        t["z"] = t.pop("a")
    else:
        t["extra"] = torch.zeros(1)
    with pytest.raises(ValueError):
        restore_pytree(t, str(tmp_path), 1, device="cpu")


def test_latest_step_picks_newest_complete(tmp_path):
    for s in (1, 3, 7):
        save_pytree(tree(), str(tmp_path), s)
    assert latest_step(str(tmp_path)) == 7
    shutil.rmtree(os.path.join(str(tmp_path), "step-000000007"))
    assert latest_step(str(tmp_path)) == 3


def test_manager_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(tree(), s)
    steps = sorted(n for n in os.listdir(str(tmp_path))
                   if n.startswith("step-"))
    assert len(steps) == 2
    assert latest_step(str(tmp_path)) == 4


def test_manager_async_save_and_flush(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    t = tree()
    mgr.save(t, 9)
    t["a"].add_(1.0)            # the staged copy is already taken
    mgr.wait()
    restored, step = mgr.restore_latest(tree(seed=2), device="cpu")
    assert step == 9
    assert torch.equal(restored["a"], tree()["a"])
    assert mgr.used() == 0.0


def test_manager_staging_buffer_pressure(tmp_path):
    """Shrinking the staging store forces the pending save to flush --
    the DynIMS coupling for checkpoint staging."""
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(tree(), 3)
    report = mgr.set_capacity(0.0)             # burst: no staging allowed
    assert mgr.used() == 0.0
    assert latest_step(str(tmp_path)) == 3
    assert report.store == "ckpt-staging" and mgr.priority == 5


def test_named_tuple_leaves_roundtrip(tmp_path):
    """An optimizer state (a NamedTuple) comes back as one, its tensors on
    the device asked for, its int32 step an int32 tensor."""
    mu = {"w": torch.randn(3, 2), "layers.0.norm": torch.randn(2)}
    state = AdamWState(step=torch.tensor(4, dtype=torch.int32), mu=mu,
                       nu={k: v * 2 for k, v in mu.items()})
    mgr = CheckpointManager(str(tmp_path))
    mgr.save({"opt": state, "step": 4}, 4)
    like = AdamWState(step=torch.zeros((), dtype=torch.int32),
                      mu={k: torch.zeros_like(v) for k, v in mu.items()},
                      nu={k: torch.zeros_like(v) for k, v in mu.items()})
    out, step = mgr.restore_latest({"opt": like, "step": 0}, device="cpu")
    assert step == 4 and out["step"] == 4
    assert isinstance(out["opt"], AdamWState)
    assert out["opt"].step.dtype == torch.int32 and int(out["opt"].step) == 4
    for k in mu:
        assert torch.equal(out["opt"].mu[k], mu[k])
        assert torch.equal(out["opt"].nu[k], state.nu[k])


def test_restore_latest_without_a_checkpoint(tmp_path):
    assert CheckpointManager(str(tmp_path)).restore_latest(
        tree(), device="cpu") == (None, None)


# one arch of each family the port trains
FAMILY_ARCHS = ("llama3.2-1b", "hymba-1.5b", "gemma3-1b", "qwen2-1.5b",
                "qwen2-moe-a2.7b", "llama-3.2-vision-11b",
                "whisper-large-v3", "xlstm-125m")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_each_familys_training_tree_roundtrips(tmp_path, arch):
    """The tree the trainer saves (``params``, the AdamW state ``opt``
    past one update, ``step``) of the ``-smoke`` model comes back leaf
    for leaf into a tree of another seed, through the async manager."""
    cfg = get_config(arch + "-smoke")
    params = model_params(Model(cfg, device="cpu", seed=0))
    rng = np.random.default_rng(3)
    grads = {n: torch.from_numpy(rng.normal(0, 1, p.shape).astype(
        np.float32)) for n, p in params.items()}
    params, adam = adamw_update(grads, adamw_init(params), params, lr=1e-3)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save({"params": params, "opt": adam, "step": 1}, 1)
    mgr.wait()
    like = model_params(Model(cfg, device="cpu", seed=1))
    restored, step = mgr.restore_latest(
        {"params": like, "opt": adamw_init(like), "step": 0}, device="cpu")
    assert step == 1 and restored["step"] == 1
    assert isinstance(restored["opt"], AdamWState)
    assert torch.equal(restored["opt"].step, adam.step)
    for got, want in ((restored["params"], params),
                      (restored["opt"].mu, adam.mu),
                      (restored["opt"].nu, adam.nu)):
        assert sorted(got) == sorted(want)
        for name in want:
            assert torch.equal(got[name], want[name]), name
