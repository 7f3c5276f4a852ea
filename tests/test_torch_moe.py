"""The moe family in the port against the JAX package, on the CPU.

* ``moe_apply`` (``repro_torch/models/moe.py``) against JAX's on numpy
  inputs from a seed, output and aux loss to 1e-5 relative, on
  ``dbrx-132b-smoke`` and ``qwen2-moe-a2.7b-smoke``: at their capacity
  factor of 8.0 (no drops), at 1.25 and 0.25 (drops), over one group and
  over two groups of 600 tokens that mix sequences; with 20 experts
  padded to 32 and top 4 (no dummy is ever chosen); and with exact ties
  in the router's probabilities.  The (token, choice) pairs and which of
  them were kept equal JAX's (its ``lax.top_k`` and cumulative count).
  JAX's init gives the shared experts' gate zeros, where a wrong gate
  would pass as ``sigmoid(0)``, so the gate is drawn at random on both
  sides, as are qwen2-moe's QKV biases.
* ``Model.forward`` and 12 ``decode_step``s of both smoke models against
  JAX's to 1e-4 relative, as ``tests/test_torch_models.py`` holds
  llama's.
* ``Model.loss``, its ``aux`` and every gradient leaf (router, experts,
  shared experts) against ``jax.grad``, with and without drops, to the
  tolerances of ``tests/test_torch_train.py`` (loss 1e-5 relative,
  leaves atol 1e-5, rtol 1e-4).  Unlike hymba's (ROADMAP C21) the moe
  gradient is well conditioned at JAX's init: moving every parameter
  one float32 ulp moves JAX's own gradient by at most 6.4e-6 of a
  leaf's largest entry, and the port differs from JAX by at most 5.7e-6
  of it, so the plain tolerances hold.  The trainer's losses from JAX's
  init, 8 steps with one microbatch (``aux`` logged) and with two,
  within ``LOSS_TOL``.
* The init (ROADMAP C22): JAX's ``ParamDef`` default takes the fan-in
  over the leading axis, which for the expert stacks (E_pad, d, f) and
  (E_pad, f, d) is the number of padded experts; the port draws the
  same.  The converter refuses a misshapen or incomplete moe tree.
"""

import dataclasses

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
from repro.models import decode as JD
from repro.models import moe as JM
from repro.models.params import UNSHARDED_AXES, count_params, init_params
from repro.train import Trainer as JaxTrainer
from repro.train import TrainerConfig as JaxTrainerConfig
from repro.train import TrainStepConfig as JaxStepConfig
from repro_torch.configs import get_config
from repro_torch.convert import _port_arrays, model_params_from_numpy
from repro_torch.data import (DataPipeline, PipelineConfig, ShardStore,
                              write_corpus)
from repro_torch.models import Model, decode as D
from repro_torch.models import moe as TM
from repro_torch.optim.adamw import decays
from repro_torch.train import Trainer, TrainerConfig, TrainStepConfig

# One intra-op thread: the suite's workers share the cores, and torch's
# OpenMP threads, oversubscribed, spin-wait ~100x longer than the ops.
torch.set_num_threads(1)

QWEN = "qwen2-moe-a2.7b-smoke"
DBRX = "dbrx-132b-smoke"
ARCHS = [QWEN, DBRX]
RANDOM = ("bq", "bk", "bv", "gate")      # zeros at JAX's init
# Logged losses, port against JAX from the same init (absolute, on a loss
# of ~6.4-6.9), as tests/test_torch_train.py holds llama's.  Largest
# difference measured over the 8 steps: 1.9e-6 (qwen2-moe, step 2).
LOSS_TOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _t(x):
    return torch.from_numpy(np.array(x))


def _configs(arch, **change):
    return (dataclasses.replace(jax_config(arch), **change),
            dataclasses.replace(get_config(arch), **change))


def _randomized(tree, rng):
    """The tree with the leaves JAX initializes to zeros drawn at random."""
    if not isinstance(tree, dict):
        return tree
    return {k: (rng.normal(0, 0.5, np.shape(v)).astype(np.float32)
                if k in RANDOM else _randomized(v, rng))
            for k, v in tree.items()}


# ---- one layer's experts ----------------------------------------------------

def _moe_pair(cfg_j, cfg_t, seed):
    """JAX's moe parameters (random shared gate) as numpy, and the port's
    ``MoE`` module holding them."""
    tree = _randomized(jax.tree.map(np.asarray, init_params(
        JM.moe_schema(cfg_j, UNSHARDED_AXES), jax.random.key(seed))),
        np.random.default_rng(seed))
    moe = Model(cfg_t, device="cpu").layers[0].moe
    with torch.no_grad():
        for name, p in moe.named_parameters():
            leaf = tree
            for part in name.split("."):
                leaf = leaf[part]
            p.copy_(_t(leaf))
    return tree, moe


def _jax_routing(p, x, cfg):
    """JAX's (token, choice) experts and kept mask, computed by the lines
    of ``repro/models/moe.py::moe_apply`` that make them."""
    b, s, d = x.shape
    e_pad = p["router"].shape[-1]
    k = cfg.experts_per_token
    n = b * s
    sg = JM._group_size(n)
    g = n // sg
    cap = max(int(cfg.capacity_factor * k * sg / e_pad), 4)
    logits = jnp.einsum("gsd,de->gse", x.reshape(g, sg, d), p["router"],
                        preferred_element_type=jnp.float32)
    if e_pad != cfg.n_experts:
        logits = jnp.where(jnp.arange(e_pad) >= cfg.n_experts, -1e30,
                           logits)
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    onehot = jax.nn.one_hot(idx, e_pad, dtype=jnp.int32)
    pos = (jnp.cumsum(onehot.reshape(g, sg * k, e_pad), axis=1) - 1
           ).reshape(g, sg, k, e_pad)
    keep = (pos * onehot).sum(-1) < cap
    return np.asarray(idx), np.asarray(keep)


# (arch, config changes, input shape, router: None or "zeros" for ties
# everywhere, "ties" for three equal columns beside a random one)
MOE_CASES = {
    "qwen-cf8": (QWEN, {}, (2, 40), None),
    "dbrx-cf8": (DBRX, {}, (2, 40), None),
    "qwen-cf1.25": (QWEN, {"capacity_factor": 1.25}, (2, 40), None),
    "dbrx-cf1.25": (DBRX, {"capacity_factor": 1.25}, (2, 40), None),
    "qwen-cf0.25": (QWEN, {"capacity_factor": 0.25}, (2, 40), None),
    "dbrx-cf0.25": (DBRX, {"capacity_factor": 0.25}, (2, 40), None),
    "qwen-2groups-cf1.25": (QWEN, {"capacity_factor": 1.25}, (3, 400),
                            None),
    "dbrx-2groups-cf0.25": (DBRX, {"capacity_factor": 0.25}, (2, 600),
                            None),
    "qwen-20-padded-32-top4": (QWEN, {"n_experts": 20,
                                      "experts_per_token": 4}, (2, 40),
                               None),
    "qwen-20-padded-32-top4-cf1.25": (
        QWEN, {"n_experts": 20, "experts_per_token": 4,
               "capacity_factor": 1.25}, (2, 40), None),
    "dbrx-ties-everywhere-cf0.25": (DBRX, {"capacity_factor": 0.25},
                                    (2, 40), "zeros"),
    "qwen-ties-cf1.25": (QWEN, {"capacity_factor": 1.25}, (2, 40), "ties"),
    "qwen-20-padded-ties": (QWEN, {"n_experts": 20, "experts_per_token": 4},
                            (2, 40), "ties"),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_matches_jax(case):
    arch, change, shape, router = MOE_CASES[case]
    cfg_j, cfg_t = _configs(arch, **change)
    seed = sum(map(ord, case))
    tree, moe = _moe_pair(cfg_j, cfg_t, seed)
    e_real, e_pad = cfg_t.n_experts, TM.padded_experts(cfg_t)
    if router is not None:           # exact ties among the routed experts
        r = np.zeros_like(tree["router"])
        if router == "ties":
            r[:, 0] = np.random.default_rng(seed).normal(0, 0.2, len(r))
        tree["router"] = r
        with torch.no_grad():
            moe.router.copy_(_t(r))
    rng = np.random.default_rng(seed + 1)
    x = rng.normal(0, 1, shape + (cfg_t.d_model,)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    ref, ref_aux = JM.moe_apply(jp, jnp.asarray(x), cfg_j)
    want_idx, want_keep = _jax_routing(jp, jnp.asarray(x), cfg_j)

    seen = []
    TM.ROUTE_HOOK = lambda experts, keep: seen.append((experts, keep))
    try:
        out, aux = TM.moe_apply(moe, _t(x), cfg_t)
    finally:
        TM.ROUTE_HOOK = None
    (idx, keep), = seen
    assert out.shape == x.shape and out.dtype == torch.float32
    assert _rel(out.numpy(), ref) <= 1e-5
    assert abs(float(aux) - float(ref_aux)) <= 1e-5 * abs(float(ref_aux))
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert int(idx.max()) < e_real                 # no dummy is chosen
    dropped = int((~keep).sum())
    if change.get("capacity_factor", 8.0) < 1:
        assert dropped > 0, "the case meant to drop choices dropped none"
    if change.get("capacity_factor", 8.0) == 8.0:
        assert dropped == 0
    if e_pad != e_real:
        assert (e_real, e_pad) == (20, 32)
    if router == "zeros":            # every token: experts 0..k-1, in order
        assert (idx.numpy() == np.arange(cfg_t.experts_per_token)).all()
    if router == "ties":             # a tie across the top-k boundary
        assert (idx.numpy() == np.arange(1, cfg_t.experts_per_token + 1)
                ).all(-1).any()


def test_dropped_choices_are_not_renormalized():
    """A token whose second choice is dropped keeps its first choice's
    renormalized gate: its output is that expert's alone, times the gate
    of the top 2, not 1."""
    cfg_j, cfg_t = _configs(DBRX, capacity_factor=0.25)
    tree, moe = _moe_pair(cfg_j, cfg_t, 3)
    x = _t(np.random.default_rng(4).normal(0, 1, (1, 64, cfg_t.d_model))
           .astype(np.float32))
    seen = []
    TM.ROUTE_HOOK = lambda experts, keep: seen.append((experts, keep))
    try:
        out, _ = TM.moe_apply(moe, x, cfg_t)
    finally:
        TM.ROUTE_HOOK = None
    _, keep = seen[0]
    half = (keep[0, :, 0] & ~keep[0, :, 1]).nonzero()
    assert len(half) > 0
    s = int(half[0, 0])
    probs = torch.softmax(x[0, s] @ moe.router, -1)
    top = torch.sort(probs, descending=True, stable=True)
    e, gate = int(top.indices[0]), float(top.values[0] / top.values[:2].sum())
    act = torch.nn.functional.silu
    xe = x[0, s]
    y = (act(xe @ moe.wg[e]) * (xe @ moe.wi[e])) @ moe.wo[e]
    np.testing.assert_allclose(out[0, s].numpy(), (gate * y).numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_experts,want", [(60, 64), (16, 16), (4, 4),
                                            (20, 32), (64, 64)])
def test_padded_experts_match_jax(n_experts, want):
    cfg_j, cfg_t = _configs(QWEN, n_experts=n_experts)
    assert TM.padded_experts(cfg_t) == JM.padded_experts(cfg_j) == want


@pytest.mark.parametrize("n,sg", [(2176, 544), (8, 8), (1024, 1024),
                                  (4096, 1024), (80, 80), (1200, 600)])
def test_group_size_matches_jax(n, sg):
    assert TM._group_size(n) == JM._group_size(n) == sg


def test_capacity_at_full_width():
    """80 slots an expert for a 1024-token group at cf 1.25, top 4 of 64
    padded experts; 4 (the floor) for a decode step of 8 slots."""
    cfg = get_config("qwen2-moe-a2.7b")
    assert TM.padded_experts(cfg) == 64
    for n, cap in ((1024, 80), (8, 4)):
        sg = TM._group_size(n)
        assert max(int(cfg.capacity_factor * cfg.experts_per_token * sg
                       / 64), 4) == cap


# ---- the model --------------------------------------------------------------

def _model_pair(arch, seed=1, **change):
    """JAX's model and parameters (random biases and shared gates), and
    the port's copy."""
    cfg_j, cfg_t = _configs(arch, **change)
    jm = JaxModel(cfg_j, remat="none", attn_impl="dense")
    tree = _randomized(jax.tree.map(np.asarray, jm.init(
        jax.random.key(seed))), np.random.default_rng(seed))
    return jm, jax.tree.map(jnp.asarray, tree), \
        model_params_from_numpy(tree, cfg_t, device="cpu"), tree


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _model_pair(request.param)


def test_forward_matches_jax(pair):
    jm, params, tm, _ = pair
    tokens = np.random.default_rng(4).integers(
        0, tm.cfg.vocab_size, (2, 40)).astype(np.int32)
    ref, ref_aux = jm.forward(params, {"tokens": jnp.asarray(tokens)})
    out, aux = tm(_t(tokens), aux=True)
    assert out.shape == (2, 40, tm.cfg.padded_vocab)
    assert _rel(out.numpy(), ref) <= 1e-4
    assert abs(float(aux) - float(ref_aux)) <= 1e-5 * float(ref_aux)
    assert torch.equal(tm(_t(tokens)), out)


def test_decode_steps_match_jax(pair):
    jm, params, tm, _ = pair
    b, steps = 3, 12
    tokens = np.random.default_rng(5).integers(
        0, tm.cfg.vocab_size, (b, steps)).astype(np.int32)
    js = JD.init_state(jm, b, 32, cache_dtype="float32")
    ts = D.init_state(tm, b, 32, cache_dtype="float32")
    for t in range(steps):
        ref, js = JD.decode_step(jm, params, js,
                                 jnp.asarray(tokens[:, t:t + 1]))
        out = D.decode_step(tm, ts, _t(tokens[:, t:t + 1]))
        assert _rel(out.numpy(), ref) <= 1e-4, t


def test_decode_routes_the_step_as_one_group(pair):
    """A decode step routes its B tokens as one group of B with the
    floor's capacity of 4, free slots included."""
    _, _, tm, _ = pair
    seen = []
    TM.ROUTE_HOOK = lambda experts, keep: seen.append(keep.shape)
    try:
        state = D.init_state(tm, 5, 16)
        D.decode_step(tm, state, torch.zeros((5, 1), dtype=torch.long))
    finally:
        TM.ROUTE_HOOK = None
    assert seen == [(1, 5, tm.cfg.experts_per_token)] * tm.cfg.n_layers


def test_decode_reproduces_forward(pair):
    """At the smoke reduction's cf 8.0 nothing is dropped, so forward's
    groups and decode's route alike."""
    _, _, tm, _ = pair
    tokens = _t(np.random.default_rng(6).integers(0, tm.cfg.vocab_size,
                                                  (2, 20)))
    fwd = tm(tokens)
    state = D.init_state(tm, 2, 32, cache_dtype="float32")
    dec = torch.cat([D.decode_step(tm, state, tokens[:, t:t + 1])
                     for t in range(20)], dim=1)
    assert _rel(dec.numpy(), fwd.numpy()) < 5e-3


def test_parameters_are_jax_parameters():
    """The port's parameters: the names and count of JAX's tree, the
    padded experts included; ``ArchConfig.n_params`` counts the real
    experts only and no shared gate."""
    for arch, change in ((QWEN, {}), (DBRX, {}),
                         (QWEN, {"n_experts": 20, "experts_per_token": 4})):
        cfg_j, cfg_t = _configs(arch, **change)
        m = Model(cfg_t, seed=0, device="cpu")
        schema = JaxModel(cfg_j).schema()
        assert sum(p.numel() for p in m.parameters()) == \
            count_params(schema)
        assert sorted(n for n, _ in m.named_parameters()) == sorted(
            _port_arrays(jax.tree.map(np.asarray, JaxModel(cfg_j).init(
                jax.random.key(0))), cfg_t))
    # qwen2-moe-a2.7b: 60.6 GB in float32 with 64 padded experts
    full = get_config("qwen2-moe-a2.7b")
    assert count_params(JaxModel(jax_config(full.name)).schema()) == \
        15_146_977_280
    assert full.n_params() == 14_316_259_328


# ---- the init (ROADMAP C22) ---------------------------------------------------

def test_init_fans_are_jax_fans():
    """JAX draws the expert stacks with fan = E_pad (the leading axis),
    the router with fan d, the shared experts' ``wi``/``wg`` with d and
    ``wo`` with n_shared·f; the shared gate is zeros.  The port draws
    alike: std within 10% of 1/sqrt(fan)."""
    cfg_j, cfg_t = _configs(QWEN, n_experts=20, experts_per_token=4)
    sch = JM.moe_schema(cfg_j, UNSHARDED_AXES)
    d, f, e = cfg_t.d_model, cfg_t.d_ff_expert, 32
    fans = {"router": d, "wi": e, "wg": e, "wo": e, "shared.wi": d,
            "shared.wg": d, "shared.wo": cfg_t.n_shared_experts * f}
    for name in fans:
        leaf = sch
        for part in name.split("."):
            leaf = leaf[part]
        assert leaf.init == "fan_in" and leaf.fan_in_axes == (0,), name
    assert sch["shared"]["gate"].init == "zeros"
    assert sch["wi"].shape == (e, d, f) and sch["wo"].shape == (e, f, d)
    moe = Model(cfg_t, seed=5, device="cpu").layers[1].moe
    params = dict(moe.named_parameters())
    for name, fan in fans.items():
        std = float(params[name].std())
        assert abs(std * fan ** 0.5 - 1.0) < 0.1, (name, std)
    assert not params["shared.gate"].any()
    # the finding: at qwen2-moe's widths the expert stacks draw with std
    # 1/8 where a fan over d (or f) would give 1/45 (1/38)
    full = get_config("qwen2-moe-a2.7b")
    assert (TM.padded_experts(full), full.d_model, full.d_ff_expert) == \
        (64, 2048, 1408)


def test_converter_refuses_a_misshapen_moe_tree():
    _, _, _, tree = _model_pair(QWEN, seed=2)
    cfg = get_config(QWEN)
    bad = jax.tree.map(np.copy, tree)
    wi = bad["layers"]["flat"]["moe"]["wi"]
    bad["layers"]["flat"]["moe"]["wi"] = wi[:, :3]
    with pytest.raises(ValueError, match="moe.wi"):
        model_params_from_numpy(bad, cfg, device="cpu")
    bad = jax.tree.map(np.copy, tree)
    del bad["layers"]["flat"]["moe"]["shared"]["gate"]
    with pytest.raises(ValueError, match="missing.*moe.shared.gate"):
        model_params_from_numpy(bad, cfg, device="cpu")
    bad = jax.tree.map(np.copy, tree)
    bad["layers"]["flat"]["mlp"] = bad["layers"]["flat"]["moe"]
    with pytest.raises(ValueError, match="does not carry"):
        model_params_from_numpy(bad, cfg, device="cpu")


def test_shared_gate_decays_as_jax_decays_it():
    """JAX stacks the (d, 1) shared gate into an (L, d, 1) array, which
    AdamW decays (ROADMAP C19); so do the router and the experts."""
    m = Model(get_config(QWEN), device="cpu")
    for name, p in m.named_parameters():
        if ".moe." in name:
            assert decays(name, p), name


# ---- loss and gradients -------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [8.0, 0.5], ids=["no-drops", "drops"])
def test_model_loss_and_gradient_match_jax(arch, cf):
    jm, params, model, tree = _model_pair(arch, seed=0, capacity_factor=cf)
    cfg_t = model.cfg
    rng = np.random.default_rng(11)
    batch = {"tokens": rng.integers(0, cfg_t.vocab_size, (2, 40)),
             "labels": rng.integers(0, cfg_t.vocab_size, (2, 40))}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    jm = JaxModel(jm.cfg, remat="full", attn_impl="dense")

    (jloss, jparts), jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(params)
    jloss, jaux = float(jloss), float(jparts["aux"])
    want = _port_arrays(jax.tree.map(np.asarray, jgrads), cfg_t)
    seen = []
    TM.ROUTE_HOOK = lambda experts, keep: seen.append(int((~keep).sum()))
    try:
        model.requires_grad_(True)
        loss, parts = model.loss({k: _t(v) for k, v in batch.items()})
    finally:
        TM.ROUTE_HOOK = None
    assert (sum(seen) > 0) == (cf < 1)
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(
        model.parameters()))))
    assert abs(float(loss.detach()) - jloss) <= 1e-5 * jloss
    assert jaux > 0
    assert abs(float(parts["aux"].detach()) - jaux) <= 1e-5 * jaux
    assert float((parts["ce"] + parts["aux"]).detach()) == pytest.approx(
        float(loss.detach()), rel=1e-6)
    assert sorted(want) == sorted(grads)
    assert any(".moe.router" in n for n in grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name], atol=1e-5,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("arch,microbatches", [(QWEN, 1), (DBRX, 2)])
def test_trainer_losses_match_jax(tmp_path, arch, microbatches):
    """8 steps from JAX's init on ``tests/test_trainer.py``'s setup: each
    logged loss within ``LOSS_TOL`` of JAX's; with one microbatch the
    logged ``aux`` is the routers', JAX's within 1e-5 relative
    (microbatched, both log a zero ``aux``)."""
    corpus = str(tmp_path / "corpus")
    write_corpus(corpus, n_shards=8, tokens_per_shard=4096, vocab_size=503)
    cfg_j = jax_config(arch)
    params = JaxModel(cfg_j).init(jax.random.key(0))
    steps = 8
    step_kw = dict(microbatches=microbatches, warmup_steps=2,
                   total_steps=steps)
    trainer_kw = dict(steps=steps, checkpoint_every=4, log_every=1)
    pipe_kw = dict(batch_size=4, seq_len=32, cache_bytes=1 << 20,
                   prefetch_depth=0, dynims=False)

    def jax_rows(init, tag):
        pipe = JaxPipeline(JaxStore(corpus), JaxPipelineConfig(**pipe_kw))
        tr = JaxTrainer(JaxModel(cfg_j, remat="full", attn_impl="dense"),
                        pipe, JaxStepConfig(**step_kw), JaxTrainerConfig(
                            checkpoint_dir=str(tmp_path / tag),
                            **trainer_kw))
        tr.fit(init)
        pipe.close()
        return {int(r["step"]): r for r in tr.metrics_log}

    want = jax_rows(params, "jax")
    model = model_params_from_numpy(jax.tree.map(np.asarray, params),
                                    get_config(arch), device="cpu")
    pipe = DataPipeline(ShardStore(corpus), PipelineConfig(**pipe_kw))
    tr = Trainer(model, pipe, TrainStepConfig(**step_kw), TrainerConfig(
        checkpoint_dir=str(tmp_path / "port"), **trainer_kw), device="cpu")
    tr.fit()
    pipe.close()
    got = {int(r["step"]): r for r in tr.metrics_log}
    assert sorted(got) == sorted(want) == list(range(steps))
    for step in range(steps):
        g, w = got[step], want[step]
        assert abs(g["loss"] - w["loss"]) <= LOSS_TOL, step
        if microbatches == 1:
            assert w["aux"] > 0
            assert abs(g["aux"] - w["aux"]) <= 1e-5 * w["aux"], step
            assert g["ce"] + g["aux"] == pytest.approx(g["loss"], rel=1e-6)
        else:
            assert g["aux"] == w["aux"] == 0.0
    assert got[steps - 1]["loss"] < got[0]["loss"]
