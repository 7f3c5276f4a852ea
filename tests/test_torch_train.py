"""The port's training path against the JAX package's, on the CPU.

* ``attention_dense`` and ``attention_chunked`` (causal, windowed, a
  padded last chunk): forward and the q, k, v gradients against
  ``jax.grad`` of JAX's, to 1e-5.
* ``Model.loss`` and its whole gradient on ``llama3.2-1b-smoke`` from
  JAX's init (carried by ``convert``), under each remat policy and
  both attention paths: the loss to 1e-5 relative, every gradient leaf
  (JAX's stacked leaves mapped per layer) to atol 1e-5, rtol 1e-4.
* The trainer on ``tests/test_trainer.py``'s setup (corpus 8 x 4096,
  vocab 503, batch 4, seq 32, 2 microbatches, warmup 2), 8 steps from
  JAX's init: every logged loss within ``LOSS_TOL`` of JAX's.  At step 1
  Adam's ``mhat / sqrt(vhat)`` is +-1 for every element, so a gradient
  near zero whose sign differs between the packages would move its
  parameter by 2 lr; over these 8 steps none does visibly, and the
  largest difference measured is stated beside ``LOSS_TOL``.
* Restart: 8 steps straight against 4, a crash and ``resume`` to 8, the
  final parameters equal (``torch.equal``); a JAX checkpoint at step 4,
  read by JAX's ``restore_pytree`` and carried by ``convert``, resumed
  in the port to 8 with JAX's straight run's losses.
* The plane during training: ticks and the straggler squeeze as in
  ``tests/test_trainer.py``, and both packages' host monitors reading
  one scripted ``/proc/meminfo`` sequence give the same actions.
* The training CLI prints JAX's ``arch=... params=...`` line and, from
  JAX's init, its losses.
"""

import ast
import os
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_pytree as jax_restore_pytree
from repro.configs import get_config as jax_config
from repro.configs.dynims import host_cache_params as jax_host_cache_params
from repro.core import monitor as jax_monitor
from repro.core.plane import MemoryPlane as JaxPlane
from repro.core.plane import PlaneSpec as JaxPlaneSpec
from repro.data import DataPipeline as JaxPipeline
from repro.data import PipelineConfig as JaxPipelineConfig
from repro.data import ShardStore as JaxStore
from repro.data import write_corpus as jax_write_corpus
from repro.launch import train as jax_train_cli
from repro.models import Model as JaxModel
from repro.models import attention as JA
from repro.train import Trainer as JaxTrainer
from repro.train import TrainerConfig as JaxTrainerConfig
from repro.train import TrainStepConfig as JaxStepConfig
from repro.train.step import init_train_state as jax_init_train_state
from repro_torch.configs import get_config
from repro_torch.configs.dynims import host_cache_params
from repro_torch.convert import (_port_arrays, model_params_from_numpy,
                                 train_state_from_numpy)
from repro_torch.core import GiB
from repro_torch.core import monitor as torch_monitor
from repro_torch.core.plane import ControlPlane, MemoryPlane, PlaneSpec
from repro_torch.data import (DataPipeline, PipelineConfig, ShardStore,
                              write_corpus)
from repro_torch.launch import train as train_cli
from repro_torch.models import Model
from repro_torch.models import attention as TA
from repro_torch.train import Trainer, TrainerConfig, TrainStepConfig
from repro_torch.train.step import TrainState, model_params

# One intra-op thread: the suite's workers share the cores, and torch's
# OpenMP threads, oversubscribed, spin-wait ~100x longer than the ops.
torch.set_num_threads(1)

ARCH = "llama3.2-1b-smoke"
STEPS = 8
# Logged losses, port against JAX from the same init (absolute, on a loss
# of ~6.2).  Largest difference measured over the 8 steps: 9.54e-7, two
# float32 ulps, both straight and resumed from JAX's checkpoint; the
# logged grad norms differ by at most 9.1e-7 relative.
LOSS_TOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _t(x):
    return torch.from_numpy(np.array(x))


# ---- attention ---------------------------------------------------------------

ATTN_CASES = [
    # (b, sq, h, kv, hd, causal, window, chunk)
    (2, 24, 4, 2, 16, True, 0, 8),           # causal, chunks exact
    (1, 40, 4, 4, 16, True, 9, 16),          # windowed, padded last chunk
    (2, 19, 6, 2, 8, False, 0, 7),           # bidirectional, padded
    (1, 33, 4, 1, 16, True, 5, 64),          # one chunk wider than Skv
]


def _attn_inputs(case, seed):
    b, s, h, kv, hd = case[:5]
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.normal(0, 1, sh).astype(np.float32)
    return f(b, s, h, hd), f(b, s, kv, hd), f(b, s, kv, hd), f(b, s, h, hd)


@pytest.mark.parametrize("impl", ["dense", "chunked"])
@pytest.mark.parametrize("case", ATTN_CASES,
                         ids=["causal", "window-pad", "bidir-pad", "wide"])
def test_attention_forward_and_gradients_match_jax(impl, case):
    cfg_j, cfg_t = jax_config(ARCH), get_config(ARCH)
    causal, window, chunk = case[5:]
    q, k, v, r = _attn_inputs(case, seed=sum(case[:5]))
    s = q.shape[1]
    pos = np.arange(s, dtype=np.int32)

    def jax_fn(q, k, v):
        if impl == "dense":
            mask = (JA.make_mask(jnp.asarray(pos), jnp.asarray(pos),
                                 causal=causal, window=window)
                    if causal or window else None)
            o = JA.attention_dense(q, k, v, mask, cfg_j)
        else:
            o = JA.attention_chunked(q, k, v, jnp.asarray(pos),
                                     jnp.asarray(pos), cfg_j, causal=causal,
                                     window=window, chunk=chunk)
        return o

    ref = jax_fn(*map(jnp.asarray, (q, k, v)))
    jgrads = jax.grad(lambda *a: jnp.sum(jax_fn(*a) * r), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))

    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    tpos = _t(pos)
    if impl == "dense":
        mask = (TA.make_mask(tpos, tpos, causal=causal, window=window)
                if causal or window else None)
        out = TA.attention_dense(tq, tk, tv, mask, cfg_t)
    else:
        out = TA.attention_chunked(tq, tk, tv, tpos, tpos, cfg_t,
                                   causal=causal, window=window, chunk=chunk)
    grads = torch.autograd.grad((out * _t(r)).sum(), (tq, tk, tv))
    assert _rel(out.detach().numpy(), ref) <= 1e-5
    for name, got, want in zip("qkv", grads, jgrads):
        assert _rel(got.numpy(), want) <= 1e-5, name


def test_training_self_attention_chooses_by_jax_rule(monkeypatch):
    """"auto" is dense up to 2048^2 (query, key) pairs, chunked past it."""
    seen = []
    monkeypatch.setattr(TA, "attention_dense",
                        lambda *a, **k: seen.append("dense") or a[0])
    monkeypatch.setattr(TA, "attention_chunked",
                        lambda *a, **k: seen.append("chunked") or a[0])
    monkeypatch.setattr(TA, "DENSE_MAX_PAIRS", 8 * 8)
    m = Model(get_config(ARCH), device="cpu")
    for s in (8, 9):
        TA.self_attention_train(m.layers[0].attn, torch.zeros((1, s, 64)),
                                m.cfg, 0)
    assert seen == ["dense", "chunked"]
    with pytest.raises(ValueError, match="attn_impl"):
        TA.self_attention_train(m.layers[0].attn, torch.zeros((1, 4, 64)),
                                m.cfg, 0, impl="flash")


# ---- Model.loss ----------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_init():
    cfg = jax_config(ARCH)
    params = JaxModel(cfg).init(jax.random.key(0))
    return params, jax.tree.map(np.asarray, params)


def _port_model(tree, **fields):
    model = model_params_from_numpy(tree, get_config(ARCH), device="cpu")
    for k, v in fields.items():
        setattr(model, k, v)
    return model


@pytest.mark.parametrize("remat,impl,labels", [
    ("full", "dense", True), ("none", "dense", True),
    ("dots", "dense", True), ("full", "dense", False),
    ("none", "chunked", True)])
def test_model_loss_and_gradient_match_jax(jax_init, remat, impl, labels):
    params, tree = jax_init
    cfg = jax_config(ARCH)
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    batch = {"tokens": tokens}
    if labels:
        batch["labels"] = rng.integers(0, cfg.vocab_size,
                                       (2, 40)).astype(np.int32)
    jm = JaxModel(cfg, remat=remat, attn_impl=impl, attn_chunk=16)
    (jloss, jparts), jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(params)
    model = _port_model(tree, remat=remat, attn_impl=impl, attn_chunk=16)
    model.requires_grad_(True)
    loss, parts = model.loss({k: _t(v) for k, v in batch.items()})
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(
        model.parameters()))))
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * float(jloss)
    assert float(parts["aux"]) == float(jparts["aux"]) == 0.0
    assert float(parts["ce"].detach()) == float(loss.detach())
    want = _port_arrays(jax.tree.map(np.asarray, jgrads), get_config(ARCH))
    assert sorted(want) == sorted(grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name], atol=1e-5,
                                   rtol=1e-4, err_msg=name)


def test_hybrid_loss_matches_jax():
    """hymba-1.5b-smoke's loss from JAX's init, JAX's to 1e-5 relative
    (its gradient: tests/test_torch_hybrid_train.py)."""
    arch = "hymba-1.5b-smoke"
    params = JaxModel(jax_config(arch)).init(jax.random.key(0))
    tokens = np.random.default_rng(12).integers(0, 503, (2, 24)).astype(
        np.int32)
    jloss, jparts = JaxModel(jax_config(arch)).loss(
        params, {"tokens": jnp.asarray(tokens)})
    model = model_params_from_numpy(jax.tree.map(np.asarray, params),
                                    get_config(arch), device="cpu")
    loss, parts = model.loss({"tokens": _t(tokens)})
    assert abs(float(loss) - float(jloss)) <= 1e-5 * float(jloss)
    assert float(parts["aux"]) == float(jparts["aux"]) == 0.0


def test_remat_policy_is_checked():
    with pytest.raises(ValueError, match="remat"):
        Model(get_config(ARCH), device="cpu", remat="some")


# ---- the trainer against JAX's -------------------------------------------------

def _jax_trainer(corpus, model, steps, ckpt, plane=None,
                 schedule_steps=None):
    pipe = JaxPipeline(JaxStore(corpus), JaxPipelineConfig(
        batch_size=4, seq_len=32, cache_bytes=1 << 20, prefetch_depth=0,
        dynims=plane is not None), plane=plane)
    return pipe, JaxTrainer(
        model, pipe,
        JaxStepConfig(microbatches=2, warmup_steps=2,
                      total_steps=schedule_steps or steps),
        JaxTrainerConfig(steps=steps, checkpoint_every=4,
                         checkpoint_dir=ckpt, log_every=1),
        plane=plane)


def _trainer(corpus, model, steps, ckpt, plane=None, schedule_steps=None):
    pipe = DataPipeline(ShardStore(corpus), PipelineConfig(
        batch_size=4, seq_len=32, cache_bytes=1 << 20, prefetch_depth=0,
        dynims=plane is not None), plane=plane)
    return pipe, Trainer(
        model, pipe,
        TrainStepConfig(microbatches=2, warmup_steps=2,
                        total_steps=schedule_steps or steps),
        TrainerConfig(steps=steps, checkpoint_every=4,
                      checkpoint_dir=ckpt, log_every=1),
        plane=plane, device="cpu")


@pytest.fixture(scope="module")
def setup(tmp_path_factory, jax_init):
    """The corpus, and JAX's runs: 8 steps straight, and 4 steps that
    checkpoint at step 4 on the same 8-step schedule."""
    tmp = tmp_path_factory.mktemp("train")
    corpus = str(tmp / "corpus")
    write_corpus(corpus, n_shards=8, tokens_per_shard=4096, vocab_size=503)
    params, tree = jax_init
    jm = JaxModel(jax_config(ARCH), remat="full", attn_impl="dense")
    pipe, tr = _jax_trainer(corpus, jm, STEPS, str(tmp / "jax-straight"))
    tr.fit(params)
    pipe.close()
    straight = tr.metrics_log
    pipe, tr = _jax_trainer(corpus, jm, 4, str(tmp / "jax-crash"),
                            schedule_steps=STEPS)
    tr.fit(params)
    pipe.close()
    return tmp, corpus, tree, jm, straight


def _losses(log):
    return {int(r["step"]): r["loss"] for r in log}


def test_corpus_is_jax_corpus(setup, tmp_path):
    tmp, corpus = setup[:2]
    jax_write_corpus(str(tmp_path), n_shards=8, tokens_per_shard=4096,
                     vocab_size=503)
    for name in os.listdir(corpus):
        assert (tmp_path / name).read_bytes() == \
            open(os.path.join(corpus, name), "rb").read()


def test_trainer_losses_match_jax(setup):
    tmp, corpus, tree, _, straight = setup
    model = _port_model(tree, remat="full", attn_impl="dense")
    pipe, tr = _trainer(corpus, model, STEPS, str(tmp / "port-straight"))
    tr.fit()
    pipe.close()
    got, want = _losses(tr.metrics_log), _losses(straight)
    assert sorted(got) == sorted(want) == list(range(STEPS))
    for step in want:
        assert abs(got[step] - want[step]) <= LOSS_TOL, step
    for rp, rj in zip(tr.metrics_log, straight):
        assert rp["lr"] == pytest.approx(rj["lr"], rel=1e-6)
        assert rp["grad_norm"] == pytest.approx(rj["grad_norm"], rel=1e-5)
        assert rp["ce"] == rp["loss"] and rp["aux"] == 0.0
    assert got[STEPS - 1] < got[0]                    # test_loss_decreases


def test_restart_is_exact(setup):
    """Straight-through training and crash + resume give the same final
    parameters, bit for bit on the CPU."""
    tmp, corpus, tree = setup[:3]
    pipe, tr = _trainer(corpus, _port_model(tree), STEPS, str(tmp / "ckA"))
    pa, sa = tr.fit()
    pipe.close()
    pipe, tr = _trainer(corpus, _port_model(tree), 4, str(tmp / "ckB"),
                        schedule_steps=STEPS)
    tr.fit()
    pipe.close()
    junk = Model(get_config(ARCH), seed=42, device="cpu")
    pipe, tr = _trainer(corpus, junk, STEPS, str(tmp / "ckB"))
    pb, sb = tr.resume()
    pipe.close()
    assert [int(r["step"]) for r in tr.metrics_log] == list(range(4, STEPS))
    for name in pa:
        assert torch.equal(pa[name], pb[name]), name
        assert torch.equal(sa.adam.mu[name], sb.adam.mu[name]), name
        assert torch.equal(model_params(junk)[name], pb[name]), name
    assert int(sa.adam.step) == int(sb.adam.step) == STEPS


def test_jax_checkpoint_resumes_in_the_port(setup):
    tmp, corpus, tree, jm, straight = setup
    params = jm.init(jax.random.key(7))               # structure only
    like = {"params": params,
            "opt": jax_init_train_state(params, JaxStepConfig()).adam,
            "step": 0}
    restored = jax_restore_pytree(like, str(tmp / "jax-crash"), 4)
    model = _port_model(restored["params"])
    adam = train_state_from_numpy(restored["opt"], model)
    assert int(adam.step) == 4 and adam.step.dtype == torch.int32
    pipe, tr = _trainer(corpus, model, STEPS, str(tmp / "port-from-jax"))
    tr.fit(state=TrainState(adam=adam, compression=None),
           start_step=int(restored["step"]))
    pipe.close()
    got, want = _losses(tr.metrics_log), _losses(straight)
    assert sorted(got) == list(range(4, STEPS))
    for step in got:
        assert abs(got[step] - want[step]) <= LOSS_TOL, step


def test_convert_rejects_a_misshapen_optimizer_state(setup):
    tree = setup[2]
    model = _port_model(tree)
    zeros = jax.tree.map(np.zeros_like, tree)
    bad = {"step": np.int32(3), "mu": zeros,
           "nu": {**zeros, "final_norm": {"scale": np.zeros(3)}}}
    with pytest.raises(ValueError, match="final_norm"):
        train_state_from_numpy(bad, model)
    del bad["nu"]["final_norm"]
    with pytest.raises(ValueError, match="missing"):
        train_state_from_numpy(bad, model)


# ---- the plane during training ---------------------------------------------------

def test_dynims_plane_ticks_during_training(setup):
    tmp, corpus, tree = setup[:3]
    with pytest.warns(DeprecationWarning):
        plane = ControlPlane(host_cache_params(64 * GiB))
    pipe, tr = _trainer(corpus, _port_model(tree), 6, str(tmp / "ck2"),
                        plane=plane)
    tr.fit()
    assert len(plane.controller.actions) >= 6
    assert pipe.hit_ratio >= 0.0
    pipe.close()


def test_straggler_squeeze_shrinks_cache(setup):
    tmp, corpus, tree = setup[:3]
    plane = MemoryPlane(PlaneSpec(params=host_cache_params(64 * GiB),
                                  device="cpu"))
    pipe, tr = _trainer(corpus, _port_model(tree), 4, str(tmp / "ck3"),
                        plane=plane)
    cap0 = pipe.cache.capacity()
    tr._squeeze_worker("localhost", 0.5)
    assert pipe.cache.capacity() <= cap0 * 0.5 + 1
    assert tr._squeezed == {"localhost": 0.5}
    pipe.close()


# available host memory (GiB of 64) the scripted /proc/meminfo reports,
# one reading per tick: headroom, a burst that takes the node past r0,
# and its release
AVAILABLE_GIB = [40.0, 30.0, 2.5, 1.0, 20.0, 41.0, 47.5, 50.0]


def _scripted_meminfo():
    calls = iter(range(10 ** 6))

    def read():
        avail = AVAILABLE_GIB[next(calls) % len(AVAILABLE_GIB)]
        return {"MemTotal": int(64 * 2**30), "MemAvailable": int(avail * 2**30),
                "SwapTotal": 0, "SwapFree": 0}
    return read


@pytest.mark.parametrize("backend", ["array", "scalar"])
def test_plane_actions_equal_jax_under_scripted_meminfo(setup, monkeypatch,
                                                        backend):
    tmp, corpus, tree, jm, _ = setup
    monkeypatch.setattr(jax_monitor, "_read_proc_meminfo",
                        _scripted_meminfo())
    monkeypatch.setattr(torch_monitor, "_read_proc_meminfo",
                        _scripted_meminfo())
    jplane = JaxPlane(JaxPlaneSpec(
        params=jax_host_cache_params(64 * GiB), backend=backend))
    pipe, tr = _jax_trainer(corpus, jm, len(AVAILABLE_GIB),
                            str(tmp / f"jax-plane-{backend}"), plane=jplane)
    tr.fit(jax.tree.map(jnp.asarray, tree))
    pipe.close()
    jax_cap = pipe.cache.capacity()
    plane = MemoryPlane(PlaneSpec(params=host_cache_params(64 * GiB),
                                  backend=backend, device="cpu"))
    pipe, tr = _trainer(corpus, _port_model(tree), len(AVAILABLE_GIB),
                        str(tmp / f"port-plane-{backend}"), plane=plane)
    tr.fit()
    cap = pipe.cache.capacity()
    pipe.close()
    fields = ("node", "u_prev", "u_next", "utilization", "epoch")
    want = [tuple(getattr(a, f) for f in fields) for a in jplane.actions()]
    got = [tuple(getattr(a, f) for f in fields) for a in plane.actions()]
    assert len(got) == len(AVAILABLE_GIB)
    assert got == want
    assert min(a[2] for a in got) < max(a[2] for a in got)   # it moved
    assert plane.capacity("localhost") == jplane.capacity("localhost")
    assert cap == jax_cap



# ---- the CLI -------------------------------------------------------------------

def _rows(text):
    lines = text.strip().splitlines()
    return lines[0], [ast.literal_eval(ln) for ln in lines[1:]]


def test_train_cli_prints_jax_lines(jax_init, monkeypatch, tmp_path, capsys):
    """``launch.train --arch llama3.2-1b-smoke --steps 8 --seq-len 32
    --batch-size 4`` in both packages, the port's from JAX's init."""
    _, tree = jax_init
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    args = ["--arch", ARCH, "--steps", "8", "--seq-len", "32",
            "--batch-size", "4"]
    monkeypatch.setattr(sys, "argv", ["train"] + args)
    jax_train_cli.main()
    head_j, rows_j = _rows(capsys.readouterr().out)
    monkeypatch.setattr(
        train_cli, "Model",
        lambda cfg, seed, device: model_params_from_numpy(tree, cfg,
                                                          device=device))
    train_cli.main(args + ["--device", "cpu"])
    head_t, rows_t = _rows(capsys.readouterr().out)
    assert head_t == head_j == "arch=llama3.2-1b-smoke params=197,184"
    assert [r["step"] for r in rows_t] == [r["step"] for r in rows_j] \
        == [0, 7]
    for rt, rj in zip(rows_t, rows_j):
        assert list(rt) == list(rj)
        # the rows are rounded to 4 decimals
        assert abs(rt["loss"] - rj["loss"]) <= LOSS_TOL + 1e-4
        assert rt["lr"] == rj["lr"]
