"""The vlm family (llama-3.2-vision-11b) in the port against the JAX
package, on the CPU, at ``llama-3.2-vision-11b-smoke`` (2 groups of 5
self layers and one gated cross layer, 8 image tokens).

JAX initializes each cross layer's ``gate`` to zeros, and ``x +
tanh(gate) * attn`` then adds nothing: at JAX's init any cross-attention
at all would pass.  Every comparison here draws the gates from the seed,
non-zero, on both sides (only the test of the finding keeps them zero).

* ``Model.forward`` (the kernel path: flash attention's plain version)
  and ``forward_train`` against JAX's ``forward`` with
  ``attn_impl="dense"``, to 1e-5 relative; the chunked path with a
  chunk that does not divide the 8 image tokens attends JAX's zero
  padding as JAX's does (ROADMAP C20), to 1e-5.
* Decode after ``attach_cross_context`` over 12 tokens, and ``prefill``,
  against JAX's.  Both round the images and their cross K/V to bfloat16
  (JAX's ``_attach_cross_context``) whatever the cache's type.  With a
  float32 cache, to 1e-5 (6.3e-7 measured); with a bfloat16 cache, to
  1e-3 (1.2e-4 measured): where the float32 K/V behind a cache entry
  differ in the last bit, its bfloat16 rounding can differ by 2^-8
  relative.  The port's own forward against its decode within JAX's
  5e-3.
* ``Model.loss`` and every gradient leaf against ``jax.grad``: the loss
  to 1e-5 relative, each leaf to atol 1e-5, rtol 1e-4, as
  ``tests/test_torch_train.py`` holds llama's.
* The trainer's losses from JAX's init (gates drawn), 8 steps with the
  images beside the tokens, in 1 and 2 microbatches (the images split
  with the tokens), within ``LOSS_TOL`` of JAX's.
* The serving engine's greedy tokens against JAX's engine, whose cross
  caches stay zero (neither engine attaches images).
* The converter refuses a misshapen nested tree and carries JAX's AdamW
  moments over (``train_state_from_numpy``); AdamW decays the stacked
  gates and cross norms as JAX's does (ROADMAP C19).
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
from repro.models.params import count_params
from repro.optim import adamw_init as jax_adamw_init
from repro.serving import ServingConfig as JaxServingConfig
from repro.serving import ServingEngine as JaxEngine
from repro.train import Trainer as JaxTrainer
from repro.train import TrainerConfig as JaxTrainerConfig
from repro.train import TrainStepConfig as JaxStepConfig
from repro_torch.configs import get_config
from repro_torch.convert import (_port_arrays, model_params_from_numpy,
                                 train_state_from_numpy)
from repro_torch.data import (DataPipeline, PipelineConfig, ShardStore,
                              write_corpus)
from repro_torch.models import Model, decode as D
from repro_torch.optim.adamw import decays
from repro_torch.serving import ServingConfig, ServingEngine
from repro_torch.train import Trainer, TrainerConfig, TrainStepConfig

# One intra-op thread: the suite's workers share the cores, and torch's
# OpenMP threads, oversubscribed, spin-wait ~100x longer than the ops.
torch.set_num_threads(1)

ARCH = "llama-3.2-vision-11b-smoke"
# Logged losses, port against JAX from the same init (absolute, on a loss
# of ~6.9), as tests/test_torch_train.py holds llama's.
LOSS_TOL = 1e-5
# decode and prefill against JAX's, by the cache's type (see the module
# docstring)
DECODE_RTOL = {"float32": 1e-5, "bfloat16": 1e-3}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _t(x):
    return torch.from_numpy(np.array(x))


def _gated(tree, rng):
    """The tree with every cross layer's gate drawn (JAX's init: zeros)."""
    cross = tree["layers"]["cross"]
    cross["gate"] = rng.normal(0, 1.0, cross["gate"].shape).astype(
        np.float32)
    assert np.all(cross["gate"] != 0)
    return tree


def _model_pair(seed=1, gates=True, **change):
    """JAX's model and parameters (gates drawn), and the port's copy."""
    cfg_j = dataclasses.replace(jax_config(ARCH), **change)
    cfg_t = dataclasses.replace(get_config(ARCH), **change)
    jm = JaxModel(cfg_j, remat="none", attn_impl="dense")
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    if gates:
        tree = _gated(tree, np.random.default_rng(seed))
    return jm, jax.tree.map(jnp.asarray, tree), \
        model_params_from_numpy(tree, cfg_t, device="cpu"), tree


@pytest.fixture(scope="module")
def pair():
    return _model_pair()


def _inputs(cfg, seed, b, s):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    images = rng.normal(0, 1, (b, cfg.vision_tokens, cfg.d_model)).astype(
        np.float32)
    return tokens, images


def test_smoke_shapes_are_jax_smoke_shapes(pair):
    """10 self layers in 2 groups of 5, one cross layer a group, 8 image
    tokens; the port's parameters are JAX's tree, name for name."""
    jm, _, tm, tree = pair
    cfg = tm.cfg
    assert (cfg.n_layers, cfg.cross_attn_group, cfg.vision_tokens) == \
        (10, 5, 8)
    assert len(tm.layers) == 10 and len(tm.cross_layers) == 2
    assert tree["layers"]["selfs"]["attn"]["wq"].shape[:2] == (2, 5)
    assert sorted(n for n, _ in tm.named_parameters()) == sorted(
        _port_arrays(tree, cfg))
    assert sum(p.numel() for p in tm.parameters()) == count_params(
        jm.schema())
    for c in tm.cross_layers:            # no QKV biases, gated MLP as usual
        assert c.attn.bq is None and c.mlp.wg is not None


def test_full_model_has_40_self_and_8_cross_layers():
    """JAX stacks L // g = 8 groups of g = 5 self layers and a cross layer:
    40 self layers and 8 cross layers, 11.52 B parameters (46.08 GB in
    float32), where the config's notes say 8 groups of (4 self + 1
    cross) (ROADMAP C23).  The port builds the same stack."""
    cfg = jax_config("llama-3.2-vision-11b")
    sch = JaxModel(cfg).schema()
    assert sch["layers"]["selfs"]["attn"]["wq"].shape[:2] == (8, 5)
    assert sch["layers"]["cross"]["gate"].shape == (8, 1)
    assert count_params(sch) == 11_520_053_256
    assert "4 self" in cfg.notes
    assert dataclasses.asdict(get_config(cfg.name)) == \
        dataclasses.asdict(cfg)


def test_forward_matches_jax(pair):
    jm, params, tm, _ = pair
    tokens, images = _inputs(tm.cfg, 4, 2, 12)
    ref, _ = jm.forward(params, {"tokens": jnp.asarray(tokens),
                                 "images": jnp.asarray(images)})
    out = tm(_t(tokens), images=_t(images))
    assert out.shape == (2, 12, tm.cfg.padded_vocab)
    assert _rel(out.numpy(), ref) <= 1e-5
    with torch.no_grad():
        train = tm.forward_train(_t(tokens), images=_t(images))
    assert _rel(train.numpy(), ref) <= 1e-5


def test_gate_at_init_makes_the_cross_layers_inert():
    """At JAX's init (gates zero) the logits do not depend on the images
    in either package; with the gates drawn they do."""
    jm, params, tm, _ = _model_pair(seed=2, gates=False)
    tokens, img_a = _inputs(tm.cfg, 5, 1, 6)
    img_b = img_a[:, ::-1].copy() * 3.0
    outs = [tm(_t(tokens), images=_t(i)) for i in (img_a, img_b)]
    assert torch.equal(*outs)
    refs = [jm.forward(params, {"tokens": jnp.asarray(tokens),
                                "images": jnp.asarray(i)})[0]
            for i in (img_a, img_b)]
    assert np.array_equal(*refs)
    _, _, gated, _ = _model_pair(seed=2)
    a, b = (gated(_t(tokens), images=_t(i)) for i in (img_a, img_b))
    assert _rel(a.numpy(), b.numpy()) > 1e-3


def test_chunked_cross_attention_attends_the_padding_as_jax_does():
    """A chunk of 3 over the 8 image tokens pads one zero key at position
    -1e9, which the non-causal unwindowed mask keeps (ROADMAP C20): the
    port's chunked path gives JAX's padded answer, and both differ from
    the dense path."""
    jm, params, tm, _ = _model_pair(seed=3)
    tokens, images = _inputs(tm.cfg, 6, 2, 10)
    batch = {"tokens": jnp.asarray(tokens), "images": jnp.asarray(images)}
    jc = JaxModel(jm.cfg, remat="none", attn_impl="chunked", attn_chunk=3)
    ref, _ = jc.forward(params, batch)
    dense, _ = jm.forward(params, batch)
    tm.attn_impl, tm.attn_chunk = "chunked", 3
    with torch.no_grad():
        out = tm.forward_train(_t(tokens), images=_t(images))
    assert _rel(out.numpy(), ref) <= 1e-5
    assert _rel(ref, dense) > 1e-4


def test_decode_after_attach_matches_jax(pair):
    jm, params, tm, _ = pair
    b, steps = 3, 12
    tokens, images = _inputs(tm.cfg, 7, b, steps)
    js = JD.init_state(jm, b, 32, cache_dtype="float32")
    js = JD._attach_cross_context(jm, params, js,
                                  {"images": jnp.asarray(images)})
    ts = D.init_state(tm, b, 32, cache_dtype="float32")
    D.attach_cross_context(tm, ts, images=_t(images))
    assert ts.cross_k.shape == (2, b, 8, tm.cfg.n_kv_heads,
                                tm.cfg.head_dim)
    np.testing.assert_array_equal(
        ts.cross_k.numpy(),
        np.asarray(js["layers"]["cross_k"]).astype(np.float32))
    assert bool(ts.cross_v.any())
    for t in range(steps):
        ref, js = JD.decode_step(jm, params, js,
                                 jnp.asarray(tokens[:, t:t + 1]))
        out = D.decode_step(tm, ts, _t(tokens[:, t:t + 1]))
        assert _rel(out.numpy(), ref) <= DECODE_RTOL["float32"], t


@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
def test_prefill_matches_jax(pair, cache):
    jm, params, tm, _ = pair
    tokens, images = _inputs(tm.cfg, 8, 2, 9)
    ref, js = JD.prefill(jm, params, {"tokens": jnp.asarray(tokens),
                                      "images": jnp.asarray(images)}, 16)
    if cache == "float32":              # JAX's prefill takes the default
        js = JD.init_state(jm, 2, 16, cache_dtype="float32")
        js = JD._attach_cross_context(jm, params, js,
                                      {"images": jnp.asarray(images)})
        for t in range(tokens.shape[1]):
            ref, js = JD.decode_step(jm, params, js,
                                     jnp.asarray(tokens[:, t:t + 1]))
    out, ts = D.prefill(tm, _t(tokens), 16, cache, images=_t(images))
    assert _rel(out.numpy(), ref) <= DECODE_RTOL[cache]
    assert int(ts.pos[0]) == 9 and ts.cross_k.dtype == getattr(torch, cache)


def test_forward_against_decode_within_jax_bound(pair):
    """The forward projects the images in float32, decode their bfloat16
    rounding (as JAX's do): within JAX's own bound of 5e-3."""
    _, _, tm, _ = pair
    tokens, images = _inputs(tm.cfg, 9, 2, 16)
    fwd = tm(_t(tokens), images=_t(images))
    state = D.init_state(tm, 2, 32, cache_dtype="float32")
    D.attach_cross_context(tm, state, images=_t(images))
    dec = torch.cat([D.decode_step(tm, state, _t(tokens[:, t:t + 1]))
                     for t in range(16)], dim=1)
    assert _rel(dec.numpy(), fwd.numpy()) < 5e-3


def test_context_is_required_and_checked(pair):
    _, _, tm, _ = pair
    tokens, images = _inputs(tm.cfg, 10, 1, 4)
    with pytest.raises(ValueError, match="images"):
        tm(_t(tokens))
    with pytest.raises(ValueError, match="images"):
        tm(_t(tokens), images=_t(images), frames=_t(images))
    state = D.init_state(tm, 1, 8)
    with pytest.raises(ValueError, match="images alone"):
        D.attach_cross_context(tm, state)


def test_model_loss_and_gradient_match_jax():
    jm, params, model, _ = _model_pair(seed=0)
    cfg = model.cfg
    rng = np.random.default_rng(11)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 12)),
             "labels": rng.integers(0, cfg.vocab_size, (2, 12))}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    batch["images"] = rng.normal(0, 1, (2, 8, cfg.d_model)).astype(
        np.float32)
    jm = JaxModel(jm.cfg, remat="full", attn_impl="dense")
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(params)
    want = _port_arrays(jax.tree.map(np.asarray, jgrads), cfg)
    model.requires_grad_(True)
    loss, _ = model.loss({k: _t(v) for k, v in batch.items()})
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(
        model.parameters()))))
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * float(jloss)
    assert sorted(want) == sorted(grads)
    assert any(n.endswith(".gate") for n in grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name], atol=1e-5,
                                   rtol=1e-4, err_msg=name)
    for name in ("cross_layers.0.gate", "cross_layers.1.attn.wk"):
        assert np.abs(want[name]).max() > 1e-4, name


def _with_images(pipe, batch, cfg):
    """``pipe.batch`` with images drawn from the step beside the tokens."""
    plain = pipe.batch

    def batch_fn(step):
        out = dict(plain(step))
        out["images"] = np.random.default_rng(1000 + step).normal(
            0, 1, (batch, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
        return out

    pipe.batch = batch_fn
    return pipe


@pytest.mark.parametrize("microbatches", [1, 2])
def test_trainer_losses_match_jax(tmp_path, microbatches):
    """8 steps from JAX's init (gates drawn) on
    ``tests/test_trainer.py``'s setup with images beside the tokens: each
    logged loss within ``LOSS_TOL`` of JAX's; in two microbatches each
    takes its half of the images."""
    corpus = str(tmp_path / "corpus")
    write_corpus(corpus, n_shards=8, tokens_per_shard=4096, vocab_size=503)
    cfg_j, cfg_t = jax_config(ARCH), get_config(ARCH)
    tree = _gated(jax.tree.map(np.asarray, JaxModel(cfg_j).init(
        jax.random.key(0))), np.random.default_rng(0))
    steps, bsz = 8, 4
    step_kw = dict(microbatches=microbatches, warmup_steps=2,
                   total_steps=steps)
    trainer_kw = dict(steps=steps, checkpoint_every=4, log_every=1)
    pipe_kw = dict(batch_size=bsz, seq_len=32, cache_bytes=1 << 20,
                   prefetch_depth=0, dynims=False)

    pipe = _with_images(JaxPipeline(JaxStore(corpus),
                                    JaxPipelineConfig(**pipe_kw)), bsz, cfg_t)
    jt = JaxTrainer(JaxModel(cfg_j, remat="full", attn_impl="dense"), pipe,
                    JaxStepConfig(**step_kw), JaxTrainerConfig(
                        checkpoint_dir=str(tmp_path / "jax"), **trainer_kw))
    jt.fit(jax.tree.map(jnp.asarray, tree))
    pipe.close()
    want = {int(r["step"]): r["loss"] for r in jt.metrics_log}

    model = model_params_from_numpy(tree, cfg_t, device="cpu")
    pipe = _with_images(DataPipeline(ShardStore(corpus),
                                     PipelineConfig(**pipe_kw)), bsz, cfg_t)
    seen = []
    step_fn = model.loss

    def loss(batch):
        seen.append(tuple(batch["images"].shape))
        return step_fn(batch)

    model.loss = loss
    tr = Trainer(model, pipe, TrainStepConfig(**step_kw), TrainerConfig(
        checkpoint_dir=str(tmp_path / "port"), **trainer_kw), device="cpu")
    tr.fit()
    pipe.close()
    got = {int(r["step"]): r["loss"] for r in tr.metrics_log}
    assert sorted(got) == sorted(want) == list(range(steps))
    assert seen == [(bsz // microbatches, 8, cfg_t.d_model)] \
        * (steps * microbatches)
    for step in range(steps):
        assert abs(got[step] - want[step]) <= LOSS_TOL, step
    assert got[steps - 1] < got[0]


def test_engine_tokens_match_the_jax_engine(pair):
    """Both engines serve with zero cross caches (no request carries
    images): the same greedy tokens and steps, float32 cache."""
    jm, params, tm, _ = pair
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, tm.cfg.vocab_size, n) for n in (4, 9, 6, 3)]
    kw = dict(max_batch=3, max_len=32, block_tokens=8, cache_dtype="float32")
    jeng = JaxEngine(jm, params, JaxServingConfig(**kw))
    teng = ServingEngine(tm, ServingConfig(**kw), device="cpu")
    jr = [jeng.submit(p, 6) for p in prompts]
    tr = [teng.submit(p, 6) for p in prompts]
    jf, tf = jeng.run_until_drained(2000), teng.run_until_drained(2000)
    assert [jf[r].output for r in jr] == [tf[r].output for r in tr]
    assert jeng.steps == teng.steps
    assert not teng.state.cross_k.any() and teng.state.enc_len is None
    assert teng.pool.block_bytes == jeng.pool.block_bytes


def test_converter_refuses_a_misshapen_nested_tree(pair):
    cfg = get_config(ARCH)
    tree = pair[3]
    bad = jax.tree.map(np.copy, tree)
    bad["layers"]["cross"]["gate"] = bad["layers"]["cross"]["gate"][:, :0]
    with pytest.raises(ValueError, match="cross_layers.0.gate"):
        model_params_from_numpy(bad, cfg, device="cpu")
    bad = jax.tree.map(np.copy, tree)
    del bad["layers"]["cross"]["mlp_norm"]
    with pytest.raises(ValueError, match="missing.*cross_layers.0.mlp_norm"):
        model_params_from_numpy(bad, cfg, device="cpu")
    bad = jax.tree.map(np.copy, tree)
    bad["layers"]["flat"] = bad["layers"].pop("selfs")
    with pytest.raises(ValueError, match="selfs and a cross layer"):
        model_params_from_numpy(bad, cfg, device="cpu")
    bad = jax.tree.map(np.copy, tree)
    bad["layers"]["cross"]["attn"]["bq"] = np.zeros((4, 16), np.float32)
    with pytest.raises(ValueError, match="does not carry"):
        model_params_from_numpy(bad, cfg, device="cpu")


def test_stacked_cross_parameters_decay_as_jax_decays_them(pair):
    """JAX stacks the (1,) gate into a (groups, 1) array and every layer
    norm into (groups[, g], d): AdamW decays them all but
    ``final_norm``."""
    _, _, tm, _ = pair
    for name, p in tm.named_parameters():
        assert decays(name, p) == (name != "final_norm"), name


def test_train_state_carries_jax_moments_over(pair):
    """JAX's AdamW state over the nested tree lands under the port's
    names: each moment equal to JAX's array, the step kept."""
    _, params, tm, _ = pair
    state = jax_adamw_init(params)
    state = state._replace(
        mu=jax.tree.map(lambda p: p * 0.5, params),
        nu=jax.tree.map(lambda p: p * p, params),
        step=jnp.asarray(3, jnp.int32))
    got = train_state_from_numpy(jax.tree.map(np.asarray, state), tm)
    mu = _port_arrays(jax.tree.map(np.asarray, state.mu), tm.cfg)
    nu = _port_arrays(jax.tree.map(np.asarray, state.nu), tm.cfg)
    assert int(got.step) == 3
    assert sorted(got.mu) == sorted(mu) == sorted(
        n for n, _ in tm.named_parameters())
    for name in mu:
        np.testing.assert_array_equal(got.mu[name].numpy(), mu[name])
        np.testing.assert_array_equal(got.nu[name].numpy(), nu[name])
