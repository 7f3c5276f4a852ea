"""The audio family (whisper-large-v3) in the port against the JAX
package, on the CPU, at ``whisper-large-v3-smoke`` (2 encoder layers, 4
decoder layers, 4/4 heads of 16, layernorm with its bias, an ungated
gelu MLP, 8 encoder frames in the cross cache).

JAX initializes every layernorm's bias to zeros and scale to ones, where
a port that dropped the bias or the scale would pass; the comparisons
here draw them from the seed on both sides.

* ``layer_norm`` against JAX's ``apply_norm`` (layernorm), to 1e-6.
* ``Model.forward`` (the kernel path: flash attention's plain version)
  and ``forward_train`` against JAX's ``forward`` with
  ``attn_impl="dense"``, at 8 frames and at 5, to 1e-5 relative.  The
  chunked path with a chunk that does not divide the frames attends
  JAX's zero padding in the encoder and the cross-attention as JAX's
  does (ROADMAP C20), to 1e-5.
* Decode after ``attach_cross_context`` over 12 tokens, and
  ``prefill``, against JAX's with a float32 cache, to 1e-5: with 8
  frames, with 5 (left-aligned in the cache with zeros after them,
  ``enc_len`` 5), and with 11 (cut to the cache's 8); 7.2e-7 measured.
  With a bfloat16 cache, 1e-3 (5.9e-4 measured): where the float32 K/V
  behind a cache entry differ in the last bit, its bfloat16 rounding can
  differ by 2^-8 relative.  The port's own forward against its decode
  within JAX's 5e-3.
* ``Model.loss`` and every gradient leaf against ``jax.grad``: the loss
  to 1e-5 relative, each leaf to atol 1e-5, rtol 1e-4, as
  ``tests/test_torch_train.py`` holds llama's.
* The trainer's losses from JAX's init, 8 steps with frames beside the
  tokens, in 1 and 2 microbatches (the frames split with the tokens),
  within ``LOSS_TOL`` of JAX's.
* The serving engine's greedy tokens against JAX's engine at
  ``enc_len`` 0 with zero cross caches (neither engine attaches
  frames): JAX's mask keeps no cross key and its softmax spreads evenly
  over the zero cache, the decode kernel's plain version keeps none and
  gives zeros; both add 0.
* The converter refuses a misshapen encoder tree and carries JAX's
  AdamW moments over (``train_state_from_numpy``); AdamW decays what JAX
  decays: every stacked norm and bias, not ``enc_norm`` or
  ``final_norm``.
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
from repro.models.layers import apply_norm as jax_apply_norm
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
from repro_torch.models import decode as D
from repro_torch.models.layers import layer_norm
from repro_torch.optim.adamw import decays
from repro_torch.serving import ServingConfig, ServingEngine
from repro_torch.train import Trainer, TrainerConfig, TrainStepConfig

# One intra-op thread: the suite's workers share the cores, and torch's
# OpenMP threads, oversubscribed, spin-wait ~100x longer than the ops.
torch.set_num_threads(1)

ARCH = "whisper-large-v3-smoke"
# Logged losses, port against JAX from the same init (absolute, on a loss
# of ~6.9), as tests/test_torch_train.py holds llama's.
LOSS_TOL = 1e-5
# decode and prefill against JAX's: float32 cache, and a bfloat16 cache
# (its roundings; see the module docstring)
DECODE_RTOL = {"float32": 1e-5, "bfloat16": 1e-3}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _t(x):
    return torch.from_numpy(np.array(x))


def _drawn(tree, rng):
    """The tree with every norm's scale and bias drawn (JAX's init: ones
    and zeros)."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k == "scale":
            out[k] = (1 + rng.normal(0, 0.2, v.shape)).astype(np.float32)
        elif k == "bias":
            out[k] = rng.normal(0, 0.2, v.shape).astype(np.float32)
        else:
            out[k] = _drawn(v, rng)
    return out


def _model_pair(seed=1, **change):
    """JAX's model and parameters (norms drawn), and the port's copy."""
    cfg_j = dataclasses.replace(jax_config(ARCH), **change)
    cfg_t = dataclasses.replace(get_config(ARCH), **change)
    jm = JaxModel(cfg_j, remat="none", attn_impl="dense")
    tree = _drawn(jax.tree.map(np.asarray, jm.init(jax.random.key(seed))),
                  np.random.default_rng(seed))
    return jm, jax.tree.map(jnp.asarray, tree), \
        model_params_from_numpy(tree, cfg_t, device="cpu"), tree


@pytest.fixture(scope="module")
def pair():
    return _model_pair()


def _inputs(cfg, seed, b, s, n_frames=8):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    frames = rng.normal(0, 1, (b, n_frames, cfg.d_model)).astype(
        np.float32)
    return tokens, frames


def test_layer_norm_matches_jax():
    cfg = jax_config(ARCH)
    rng = np.random.default_rng(0)
    x = rng.normal(2.0, 3.0, (3, 5, 64)).astype(np.float32)
    scale = rng.normal(1, 0.3, 64).astype(np.float32)
    bias = rng.normal(0, 0.3, 64).astype(np.float32)
    ref = jax_apply_norm({"scale": jnp.asarray(scale),
                          "bias": jnp.asarray(bias)}, jnp.asarray(x), cfg)
    out = layer_norm(_t(x), _t(scale), _t(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=1e-6)


def test_smoke_shapes_are_jax_smoke_shapes(pair):
    """2 encoder layers, 4 decoder layers with cross-attention, 8 frames
    in the cross cache; the port's parameters are JAX's tree, name for
    name (the norms' biases ``<norm>_bias``)."""
    jm, _, tm, tree = pair
    cfg = tm.cfg
    assert (cfg.n_encoder_layers, cfg.n_layers, cfg.vision_tokens) == \
        (2, 4, 8)
    assert len(tm.enc_layers) == 2 and len(tm.layers) == 4
    names = sorted(n for n, _ in tm.named_parameters())
    assert names == sorted(_port_arrays(tree, cfg))
    assert "enc_norm_bias" in names and "layers.3.cross_norm_bias" in names
    assert sum(p.numel() for p in tm.parameters()) == count_params(
        jm.schema())
    for layer in tm.layers:
        assert layer.cross.bq is None and layer.mlp.wg is None
    full = jax_config("whisper-large-v3")
    assert count_params(JaxModel(full).schema()) == 1_601_459_200


@pytest.mark.parametrize("n_frames", [8, 5])
def test_forward_matches_jax(pair, n_frames):
    jm, params, tm, _ = pair
    tokens, frames = _inputs(tm.cfg, 4, 2, 12, n_frames)
    ref, _ = jm.forward(params, {"tokens": jnp.asarray(tokens),
                                 "frames": jnp.asarray(frames)})
    out = tm(_t(tokens), frames=_t(frames))
    assert out.shape == (2, 12, tm.cfg.padded_vocab)
    assert _rel(out.numpy(), ref) <= 1e-5
    with torch.no_grad():
        train = tm.forward_train(_t(tokens), frames=_t(frames))
    assert _rel(train.numpy(), ref) <= 1e-5


def test_chunked_attention_attends_the_padding_as_jax_does():
    """A chunk of 3 over 8 frames pads one zero key at position -1e9 in
    the encoder's attention and in the decoder's cross-attention; the
    non-causal unwindowed mask keeps it (ROADMAP C20).  The port's
    chunked path gives JAX's padded answer, and both differ from the
    dense path."""
    jm, params, tm, _ = _model_pair(seed=3)
    tokens, frames = _inputs(tm.cfg, 6, 2, 9)
    batch = {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)}
    jc = JaxModel(jm.cfg, remat="none", attn_impl="chunked", attn_chunk=3)
    ref, _ = jc.forward(params, batch)
    dense, _ = jm.forward(params, batch)
    tm.attn_impl, tm.attn_chunk = "chunked", 3
    with torch.no_grad():
        out = tm.forward_train(_t(tokens), frames=_t(frames))
    assert _rel(out.numpy(), ref) <= 1e-5
    assert _rel(ref, dense) > 1e-4


@pytest.mark.parametrize("n_frames,cache", [(8, "float32"), (5, "float32"),
                                            (11, "float32"),
                                            (8, "bfloat16")])
def test_decode_after_attach_matches_jax(pair, n_frames, cache):
    jm, params, tm, _ = pair
    b, steps = 3, 12
    tokens, frames = _inputs(tm.cfg, 7, b, steps, n_frames)
    js = JD.init_state(jm, b, 32, cache_dtype=cache)
    js = JD._attach_cross_context(jm, params, js,
                                  {"frames": jnp.asarray(frames)})
    ts = D.init_state(tm, b, 32, cache_dtype=cache)
    D.attach_cross_context(tm, ts, frames=_t(frames))
    kept = min(n_frames, 8)
    assert int(ts.enc_len) == int(js["enc_len"]) == kept
    assert ts.cross_k.shape == (4, b, 8, 4, 16)
    assert bool(ts.cross_k[:, :, :kept].any())
    assert not ts.cross_k[:, :, kept:].any()
    assert not ts.cross_v[:, :, kept:].any()
    for t in range(steps):
        ref, js = JD.decode_step(jm, params, js,
                                 jnp.asarray(tokens[:, t:t + 1]))
        out = D.decode_step(tm, ts, _t(tokens[:, t:t + 1]))
        assert _rel(out.numpy(), ref) <= DECODE_RTOL[cache], t
    assert int(ts.enc_len) == kept


def test_prefill_matches_jax(pair):
    """JAX's ``prefill`` (its default bfloat16 cache) with 6 frames."""
    jm, params, tm, _ = pair
    tokens, frames = _inputs(tm.cfg, 8, 2, 9, 6)
    ref, js = JD.prefill(jm, params, {"tokens": jnp.asarray(tokens),
                                      "frames": jnp.asarray(frames)}, 16)
    out, ts = D.prefill(tm, _t(tokens), 16, frames=_t(frames))
    assert _rel(out.numpy(), ref) <= DECODE_RTOL["bfloat16"]
    assert int(ts.enc_len) == int(js["enc_len"]) == 6
    assert int(ts.pos[0]) == 9


def test_forward_against_decode_within_jax_bound(pair):
    _, _, tm, _ = pair
    tokens, frames = _inputs(tm.cfg, 9, 2, 16, 7)
    fwd = tm(_t(tokens), frames=_t(frames))
    state = D.init_state(tm, 2, 32, cache_dtype="float32")
    D.attach_cross_context(tm, state, frames=_t(frames))
    dec = torch.cat([D.decode_step(tm, state, _t(tokens[:, t:t + 1]))
                     for t in range(16)], dim=1)
    assert _rel(dec.numpy(), fwd.numpy()) < 5e-3


def test_context_is_required_and_checked(pair):
    _, _, tm, _ = pair
    tokens, frames = _inputs(tm.cfg, 10, 1, 4)
    with pytest.raises(ValueError, match="frames"):
        tm(_t(tokens))
    with pytest.raises(ValueError, match="frames"):
        tm(_t(tokens), images=_t(frames))
    state = D.init_state(tm, 1, 8)
    with pytest.raises(ValueError, match="frames alone"):
        D.attach_cross_context(tm, state, images=_t(frames))


def test_model_loss_and_gradient_match_jax():
    jm, params, model, _ = _model_pair(seed=0)
    cfg = model.cfg
    rng = np.random.default_rng(11)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 12)),
             "labels": rng.integers(0, cfg.vocab_size, (2, 12))}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    batch["frames"] = rng.normal(0, 1, (2, 7, cfg.d_model)).astype(
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
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name], atol=1e-5,
                                   rtol=1e-4, err_msg=name)
    for name in ("enc_layers.0.attn.wq", "enc_norm_bias",
                 "layers.0.cross.wk", "layers.2.cross_norm_bias"):
        assert np.abs(want[name]).max() > 1e-4, name


def _with_frames(pipe, batch, cfg, n_frames):
    """``pipe.batch`` with frames drawn from the step beside the tokens."""
    plain = pipe.batch

    def batch_fn(step):
        out = dict(plain(step))
        out["frames"] = np.random.default_rng(1000 + step).normal(
            0, 1, (batch, n_frames, cfg.d_model)).astype(np.float32)
        return out

    pipe.batch = batch_fn
    return pipe


@pytest.mark.parametrize("microbatches", [1, 2])
def test_trainer_losses_match_jax(tmp_path, microbatches):
    """8 steps from JAX's init on ``tests/test_trainer.py``'s setup with
    12 frames beside the tokens: each logged loss within ``LOSS_TOL`` of
    JAX's; in two microbatches each takes its half of the frames."""
    corpus = str(tmp_path / "corpus")
    write_corpus(corpus, n_shards=8, tokens_per_shard=4096, vocab_size=503)
    cfg_j, cfg_t = jax_config(ARCH), get_config(ARCH)
    params = JaxModel(cfg_j).init(jax.random.key(0))
    steps, bsz, n_frames = 8, 4, 12
    step_kw = dict(microbatches=microbatches, warmup_steps=2,
                   total_steps=steps)
    trainer_kw = dict(steps=steps, checkpoint_every=4, log_every=1)
    pipe_kw = dict(batch_size=bsz, seq_len=32, cache_bytes=1 << 20,
                   prefetch_depth=0, dynims=False)

    pipe = _with_frames(JaxPipeline(JaxStore(corpus),
                                    JaxPipelineConfig(**pipe_kw)), bsz, cfg_t,
                        n_frames)
    jt = JaxTrainer(JaxModel(cfg_j, remat="full", attn_impl="dense"), pipe,
                    JaxStepConfig(**step_kw), JaxTrainerConfig(
                        checkpoint_dir=str(tmp_path / "jax"), **trainer_kw))
    jt.fit(params)
    pipe.close()
    want = {int(r["step"]): r["loss"] for r in jt.metrics_log}

    model = model_params_from_numpy(jax.tree.map(np.asarray, params), cfg_t,
                                    device="cpu")
    pipe = _with_frames(DataPipeline(ShardStore(corpus),
                                     PipelineConfig(**pipe_kw)), bsz, cfg_t,
                        n_frames)
    seen = []
    loss_fn = model.loss

    def loss(batch):
        seen.append(tuple(batch["frames"].shape))
        return loss_fn(batch)

    model.loss = loss
    tr = Trainer(model, pipe, TrainStepConfig(**step_kw), TrainerConfig(
        checkpoint_dir=str(tmp_path / "port"), **trainer_kw), device="cpu")
    tr.fit()
    pipe.close()
    got = {int(r["step"]): r["loss"] for r in tr.metrics_log}
    assert sorted(got) == sorted(want) == list(range(steps))
    assert seen == [(bsz // microbatches, n_frames, cfg_t.d_model)] \
        * (steps * microbatches)
    for step in range(steps):
        assert abs(got[step] - want[step]) <= LOSS_TOL, step
    assert got[steps - 1] < got[0]


def test_engine_at_enc_len_0_matches_the_jax_engine(pair):
    """Neither engine attaches frames: zero cross caches at ``enc_len``
    0, the same greedy tokens and steps (float32 cache)."""
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
    assert int(teng.state.enc_len) == int(jeng.state["enc_len"]) == 0
    assert not teng.state.cross_k.any() and not teng.state.cross_v.any()
    assert teng.pool.block_bytes == jeng.pool.block_bytes


def test_converter_refuses_a_misshapen_encoder_tree(pair):
    cfg = get_config(ARCH)
    tree = pair[3]
    bad = jax.tree.map(np.copy, tree)
    wq = bad["enc_layers"]["attn"]["wq"]
    bad["enc_layers"]["attn"]["wq"] = wq[:, :, :2]
    with pytest.raises(ValueError, match="enc_layers.0.attn.wq"):
        model_params_from_numpy(bad, cfg, device="cpu")
    bad = jax.tree.map(np.copy, tree)
    del bad["enc_norm"]["bias"]
    with pytest.raises(ValueError, match="missing.*enc_norm_bias"):
        model_params_from_numpy(bad, cfg, device="cpu")
    bad = jax.tree.map(np.copy, tree)
    bad["enc_layers"] = jax.tree.map(lambda a: a[:1], bad["enc_layers"])
    with pytest.raises(ValueError, match="stacks 1 enc_layers"):
        model_params_from_numpy(bad, cfg, device="cpu")


def test_parameters_decay_as_jax_decays_them(pair):
    """Every stacked norm, bias and weight decays; ``enc_norm`` and
    ``final_norm`` (and their biases) are (d,) arrays in JAX and do
    not."""
    _, _, tm, _ = pair
    last = {"enc_norm", "enc_norm_bias", "final_norm", "final_norm_bias"}
    for name, p in tm.named_parameters():
        assert decays(name, p) == (name not in last), name


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
