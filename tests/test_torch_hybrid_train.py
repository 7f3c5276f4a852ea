"""Training the hybrid family (hymba-1.5b) and the new dense configs in the
port, against the JAX package, on the CPU.

* ``associative_scan`` against ``jax.lax.associative_scan`` with JAX's
  ``combine`` (the same recursion, the same order of operations).
* ``mamba_apply_chunked``, the differentiable Mamba branch, against
  JAX's ``mamba_apply``: the output and ``jax.grad`` of every ``mamba``
  leaf and of the input, at S = 128 (one chunk) and S = 200 (a padded
  second chunk), with non-zero ``conv_b`` and ``dt_bias``; each to 1e-5
  of the array's largest entry.  Against the kernel path's
  ``mamba_apply`` (B4's plain version) at the bound of
  ``tests/test_models.py::test_mamba_chunked_matches_sequential``.
* ``Model.loss`` and every gradient leaf of ``hymba-1.5b-smoke``,
  ``gemma3-1b-smoke`` and ``qwen2-1.5b-smoke`` (random QKV biases) from
  JAX's init: the loss to 1e-5 relative, each leaf to atol 1e-5, rtol
  1e-4 as ``tests/test_torch_train.py`` holds llama's, widened by twice
  the leaf's own float32 sensitivity: how far JAX's gradient moves when
  every parameter moves by one ulp.  hymba's mean fusion divides each
  branch by its RMS, and at JAX's init one ulp moves JAX's own
  gradient by up to ~2e-3 of a leaf's largest entry; for the dense
  models the widening is below 1e-6.
* AdamW on hymba's stacked Mamba vectors (``conv_b``, ``dt_bias``,
  ``d_skip``): decayed as JAX decays them, and JAX's optimizer state
  carried across by ``train_state_from_numpy`` for all three models.
* The trainer: 8 steps of ``hymba-1.5b-smoke`` from JAX's init on
  ``tests/test_trainer.py``'s setup, every logged loss within
  ``LOSS_TOL`` of JAX's, widened by twice JAX's own drift under a
  one-ulp move of the initial parameters (the gradients' sensitivity
  above, carried through Adam's steps: 4.9e-5 at step 6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data import DataPipeline as JaxPipeline
from repro.data import PipelineConfig as JaxPipelineConfig
from repro.data import ShardStore as JaxStore
from repro.models import Model as JaxModel
from repro.models import ssm as jssm
from repro.models.params import Axes, init_params
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.train import Trainer as JaxTrainer
from repro.train import TrainerConfig as JaxTrainerConfig
from repro.train import TrainStepConfig as JaxStepConfig
from repro_torch.configs import get_config
from repro_torch.convert import (_port_arrays, model_params_from_numpy,
                                 train_state_from_numpy)
from repro_torch.data import (DataPipeline, PipelineConfig, ShardStore,
                              write_corpus)
from repro_torch.models import Model
from repro_torch.models import ssm as tssm
from repro_torch.optim import adamw_update
from repro_torch.optim.adamw import decays
from repro_torch.train import Trainer, TrainerConfig, TrainStepConfig

# One intra-op thread: the suite's workers share the cores, and torch's
# OpenMP threads, oversubscribed, spin-wait ~100x longer than the ops.
torch.set_num_threads(1)

HYMBA = "hymba-1.5b-smoke"
ARCHS = [HYMBA, "gemma3-1b-smoke", "qwen2-1.5b-smoke"]
# Logged losses, port against JAX from the same init (absolute, on a loss
# of ~6.6), as tests/test_torch_train.py holds llama's.
LOSS_TOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _t(x):
    return torch.from_numpy(np.array(x))


# ---- the associative scan ---------------------------------------------------

def _combine(e1, e2):
    a1, b1 = e1
    a2, b2 = e2
    return a1 * a2, a2 * b1 + b2


@pytest.mark.parametrize("n", [1, 2, 5, 8, 128])
def test_associative_scan_matches_jax(n):
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 3, 4)).astype(np.float32)
    b = rng.normal(0, 1, (2, n, 3, 4)).astype(np.float32)
    ja, jb = jax.lax.associative_scan(_combine, (jnp.asarray(a),
                                                 jnp.asarray(b)), axis=1)
    ta, tb = tssm.associative_scan(_t(a), _t(b))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6,
                               atol=1e-6)
    # the recurrence it computes: h_t = a_t h_{t-1} + b_t from h = 0
    h = np.zeros((2, 3, 4), np.float64)
    for s in range(n):
        h = a[:, s] * h + b[:, s]
    np.testing.assert_allclose(tb[:, -1].numpy(), h, rtol=1e-5, atol=1e-5)


# ---- the differentiable Mamba branch ----------------------------------------

@pytest.fixture(scope="module")
def mamba_leaves():
    """JAX's Mamba parameters with non-zero ``conv_b`` and ``dt_bias``."""
    cfg = jax_config(HYMBA)
    params = init_params(jssm.mamba_schema(cfg, Axes()), jax.random.key(3),
                         jnp.float32)
    rng = np.random.default_rng(3)
    leaves = {k: np.asarray(v) for k, v in params.items()}
    for name in ("conv_b", "dt_bias"):
        leaves[name] = rng.normal(0, 0.5, leaves[name].shape).astype(
            np.float32)
    return leaves


def _port_mamba(leaves):
    mamba = Model(get_config(HYMBA), device="cpu").layers[0].mamba
    with torch.no_grad():
        for name, value in leaves.items():
            getattr(mamba, name).copy_(_t(value))
    return mamba


@pytest.mark.parametrize("s", [128, 200])
def test_chunked_mamba_and_its_gradients_match_jax(mamba_leaves, s):
    cfg_j, cfg_t = jax_config(HYMBA), get_config(HYMBA)
    rng = np.random.default_rng(s)
    u = rng.normal(0, 1, (2, s, cfg_t.d_model)).astype(np.float32)
    r = rng.normal(0, 1, (2, s, cfg_t.d_model)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in mamba_leaves.items()}
    ref = jssm.mamba_apply(jp, jnp.asarray(u), cfg_j)
    jgrads, jgu = jax.grad(
        lambda p, x: jnp.sum(jssm.mamba_apply(p, x, cfg_j) * r),
        argnums=(0, 1))(jp, jnp.asarray(u))
    mamba = _port_mamba(mamba_leaves)
    mamba.requires_grad_(True)
    tu = _t(u).requires_grad_()
    out = tssm.mamba_apply_chunked(mamba, tu, cfg_t)
    names = sorted(mamba_leaves)
    grads = torch.autograd.grad((out * _t(r)).sum(),
                                [getattr(mamba, n) for n in names] + [tu])
    assert _rel(out.detach().numpy(), ref) <= 1e-5
    for name, got in zip(names + ["u"], grads):
        want = jgu if name == "u" else jgrads[name]
        assert _rel(got.numpy(), want) <= 1e-5, name


def test_chunked_mamba_equals_the_kernel_path(mamba_leaves):
    """The training branch against the serving branch (B4's plain
    version, a sequential scan) over three chunks, the last padded."""
    cfg = get_config(HYMBA)
    u = _t(np.random.default_rng(9).normal(0, 1, (2, 300, cfg.d_model))
           .astype(np.float32))
    mamba = _port_mamba(mamba_leaves)
    got = tssm.mamba_apply_chunked(mamba, u, cfg)
    want = tssm.mamba_apply(mamba, u, cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4,
                               rtol=2e-3)


def test_training_forward_never_reaches_the_scan_kernel(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the training path called the scan kernel")

    monkeypatch.setattr(tssm, "ssm_scan", refuse)
    model = Model(get_config(HYMBA), device="cpu")
    model.requires_grad_(True)
    loss, parts = model.loss({"tokens": torch.zeros((1, 6),
                                                    dtype=torch.long)})
    loss.backward()
    assert float(parts["aux"]) == 0.0
    assert all(p.grad is not None for p in model.parameters())


# ---- Model.loss and its gradient --------------------------------------------

BIASES = ("bq", "bk", "bv")


def _with_random_biases(tree, rng):
    if not isinstance(tree, dict):
        return tree
    return {k: (rng.normal(0, 0.5, np.shape(v)).astype(np.float32)
                if k in BIASES else _with_random_biases(v, rng))
            for k, v in tree.items()}


def _one_ulp(tree, rng):
    """Every parameter moved one float32 ulp, up or down at random."""
    return jax.tree.map(lambda x: jnp.asarray(np.nextafter(
        np.asarray(x), np.where(rng.random(np.shape(x)) < 0.5, np.inf,
                                -np.inf).astype(np.float32))), tree)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("remat,impl", [("full", "dense"),
                                        ("none", "chunked")])
def test_model_loss_and_gradient_match_jax(arch, remat, impl):
    cfg_j, cfg_t = jax_config(arch), get_config(arch)
    rng = np.random.default_rng(11)
    tree = _with_random_biases(jax.tree.map(np.asarray, JaxModel(
        cfg_j).init(jax.random.key(0))), rng)
    params = jax.tree.map(jnp.asarray, tree)
    batch = {"tokens": rng.integers(0, cfg_t.vocab_size, (2, 40)),
             "labels": rng.integers(0, cfg_t.vocab_size, (2, 40))}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    # chunks of 8 tile the 40 positions: no padded chunk
    jm = JaxModel(cfg_j, remat=remat, attn_impl=impl, attn_chunk=8)

    def jax_loss_and_grads(p):
        (loss, _), g = jax.value_and_grad(
            lambda p: jm.loss(p, {k: jnp.asarray(v)
                                  for k, v in batch.items()}),
            has_aux=True)(p)
        return float(loss), _port_arrays(jax.tree.map(np.asarray, g), cfg_t)

    jloss, want = jax_loss_and_grads(params)
    _, moved = jax_loss_and_grads(_one_ulp(params, rng))
    model = model_params_from_numpy(tree, cfg_t, device="cpu")
    model.remat, model.attn_impl, model.attn_chunk = remat, impl, 8
    model.requires_grad_(True)
    loss, parts = model.loss({k: _t(v) for k, v in batch.items()})
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(
        model.parameters()))))
    assert abs(float(loss.detach()) - jloss) <= 1e-5 * jloss
    assert float(parts["aux"]) == 0.0
    assert sorted(want) == sorted(grads)
    for name, g in grads.items():
        noise = float(np.abs(moved[name] - want[name]).max())
        np.testing.assert_allclose(g.numpy(), want[name],
                                   atol=1e-5 + 2 * noise, rtol=1e-4,
                                   err_msg=name)


# ---- AdamW and the optimizer state ------------------------------------------

def test_adamw_decays_hymba_stacked_mamba_vectors_as_jax():
    """JAX's second AdamW step, from its first step's state carried
    across: JAX stacks ``conv_b``, ``dt_bias`` and ``d_skip`` (inner,)
    into (L, inner) arrays, which decay; the port decays them too."""
    cfg_t = get_config(HYMBA)
    params = JaxModel(jax_config(HYMBA)).init(jax.random.key(0))
    rng = np.random.default_rng(12)
    grads = jax.tree.map(lambda p: jnp.asarray(
        rng.normal(0, 1e-2, p.shape), jnp.float32), params)
    p1, s1 = jax_adamw_update(grads, jax_adamw_init(params), params,
                              lr=1e-2)
    p2, _ = jax_adamw_update(grads, s1, p1, lr=1e-2)
    model = model_params_from_numpy(jax.tree.map(np.asarray, p1), cfg_t,
                                    device="cpu")
    tparams = dict(model.named_parameters())
    tgrads = {n: _t(a) for n, a in _port_arrays(
        jax.tree.map(np.asarray, grads), cfg_t).items()}
    carried = train_state_from_numpy(jax.tree.map(np.asarray, s1), model)
    assert int(carried.step) == 1
    got, _ = adamw_update(tgrads, carried, tparams, lr=1e-2)
    undecayed, _ = adamw_update(tgrads, carried, tparams, lr=1e-2,
                                weight_decay=0.0)
    want = _port_arrays(jax.tree.map(np.asarray, p2), cfg_t)
    for name in ("conv_b", "dt_bias", "d_skip"):
        full = f"layers.1.mamba.{name}"
        assert decays(full, tparams[full])
        assert not torch.equal(got[full], undecayed[full])
    assert not decays("final_norm", tparams["final_norm"])
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=1e-6,
                                   atol=1e-7, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_from_numpy_carries_jax_adamw_state(arch):
    cfg_j, cfg_t = jax_config(arch), get_config(arch)
    params = JaxModel(cfg_j).init(jax.random.key(1))
    rng = np.random.default_rng(13)
    grads = jax.tree.map(lambda p: jnp.asarray(
        rng.normal(0, 1, p.shape), jnp.float32), params)
    _, state = jax_adamw_update(grads, jax_adamw_init(params), params,
                                lr=1e-3)
    model = model_params_from_numpy(jax.tree.map(np.asarray, params), cfg_t,
                                    device="cpu")
    adam = train_state_from_numpy(jax.tree.map(np.asarray, state), model)
    for field in ("mu", "nu"):
        want = _port_arrays(jax.tree.map(np.asarray, getattr(state, field)),
                            cfg_t)
        got = getattr(adam, field)
        assert sorted(got) == sorted(want) == sorted(
            n for n, _ in model.named_parameters())
        for name in want:
            np.testing.assert_array_equal(got[name].numpy(), want[name])


# ---- the trainer ------------------------------------------------------------

def test_hymba_trainer_losses_match_jax(tmp_path):
    """Each logged loss within ``LOSS_TOL`` of JAX's, widened by twice
    JAX's own drift so far: how far JAX's losses move when every initial
    parameter moves by one ulp (4.9e-5 at step 6 as measured, with the
    port's difference 4.86e-5 there: the same float32 chaos)."""
    corpus = str(tmp_path / "corpus")
    write_corpus(corpus, n_shards=8, tokens_per_shard=4096, vocab_size=503)
    cfg_j = jax_config(HYMBA)
    params = JaxModel(cfg_j).init(jax.random.key(0))
    steps = 8
    step_kw = dict(microbatches=2, warmup_steps=2, total_steps=steps)
    trainer_kw = dict(steps=steps, checkpoint_every=4, log_every=1)
    pipe_kw = dict(batch_size=4, seq_len=32, cache_bytes=1 << 20,
                   prefetch_depth=0, dynims=False)

    def jax_losses(init, tag):
        pipe = JaxPipeline(JaxStore(corpus), JaxPipelineConfig(**pipe_kw))
        tr = JaxTrainer(JaxModel(cfg_j, remat="full", attn_impl="dense"),
                        pipe, JaxStepConfig(**step_kw), JaxTrainerConfig(
                            checkpoint_dir=str(tmp_path / tag),
                            **trainer_kw))
        tr.fit(init)
        pipe.close()
        return {int(r["step"]): r["loss"] for r in tr.metrics_log}

    want = jax_losses(params, "jax")
    moved = jax_losses(_one_ulp(params, np.random.default_rng(0)), "ulp")
    model = model_params_from_numpy(jax.tree.map(np.asarray, params),
                                    get_config(HYMBA), device="cpu")
    pipe = DataPipeline(ShardStore(corpus), PipelineConfig(**pipe_kw))
    tr = Trainer(model, pipe, TrainStepConfig(**step_kw), TrainerConfig(
        checkpoint_dir=str(tmp_path / "port"), **trainer_kw), device="cpu")
    tr.fit()
    pipe.close()
    got = {int(r["step"]): r["loss"] for r in tr.metrics_log}
    assert sorted(got) == sorted(want) == list(range(steps))
    drift = 0.0
    for step in range(steps):
        drift = max(drift, abs(moved[step] - want[step]))
        assert abs(got[step] - want[step]) <= LOSS_TOL + 2 * drift, step
