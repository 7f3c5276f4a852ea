"""gemma3-1b and qwen2-1.5b in the port against the JAX package, on the CPU.

The dense features these configs add: the ungated and gelu MLPs
(``jax.nn.gelu``'s tanh form, held below its ~1e-3 gap to the exact
erf form), gemma's sqrt(d) embedding scale in the table's type, and
qwen2's QKV biases, added after the projection's cast and before RoPE.
JAX initializes the biases to zeros, where a dropped bias would pass, so
the models here carry random ones on both sides.  ``Model.forward``
(flash attention's plain version) and 12 ``decode_step``s (decode
attention's plain version) of ``gemma3-1b-smoke`` and
``qwen2-1.5b-smoke`` against JAX's ``Model.forward`` and
``decode_step`` to 1e-4 relative, as ``tests/test_torch_models.py``
holds llama's; gemma3's 5:1 window schedule against JAX's grouped
stacks, at full depth and through a reduction with a tail.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import Model as JaxModel
from repro.models import decode as JD
from repro.models import layers as JL
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import Model, decode as D
from repro_torch.models import layers as L
from repro_torch.models.transformer import layer_windows

# One intra-op thread: the suite's workers share the cores, and torch's
# OpenMP threads, oversubscribed, spin-wait ~100x longer than the ops.
torch.set_num_threads(1)

ARCHS = ["gemma3-1b-smoke", "qwen2-1.5b-smoke"]
BIASES = ("bq", "bk", "bv")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _with_random_biases(tree, rng):
    """The tree with every QKV bias drawn from N(0, 0.5)."""
    if not isinstance(tree, dict):
        return tree
    return {k: (rng.normal(0, 0.5, np.shape(v)).astype(np.float32)
                if k in BIASES else _with_random_biases(v, rng))
            for k, v in tree.items()}


def _pair(cfg_j, cfg_t, seed=1):
    """JAX's model and parameters (random biases where the config has
    them), and the port's copy."""
    jm = JaxModel(cfg_j, remat="none", attn_impl="dense")
    tree = _with_random_biases(
        jax.tree.map(np.asarray, jm.init(jax.random.key(seed))),
        np.random.default_rng(seed))
    params = jax.tree.map(jnp.asarray, tree)
    return jm, params, model_params_from_numpy(tree, cfg_t, device="cpu")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _pair(jax_config(request.param), get_config(request.param))


MLPS = [("silu", True), ("gelu", True), ("gelu", False), ("silu", False)]


@pytest.mark.parametrize("act,gated", MLPS, ids=str)
def test_mlp_matches_jax(act, gated):
    cfg = dataclasses.replace(jax_config("gemma3-1b-smoke"), act=act,
                              mlp_gated=gated)
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1.5, (3, 7, 64)).astype(np.float32)
    w = {n: rng.normal(0, 0.2, s).astype(np.float32)
         for n, s in (("wi", (64, 128)), ("wg", (64, 128)),
                      ("wo", (128, 64)))}
    if not gated:
        del w["wg"]
    ref = JL.apply_mlp({k: jnp.asarray(v) for k, v in w.items()},
                       jnp.asarray(x), cfg)
    t = {k: torch.from_numpy(v) for k, v in w.items()}
    out = L.apply_mlp(torch.from_numpy(x), t["wi"], t.get("wg"), t["wo"],
                      act)
    assert _rel(out.numpy(), ref) <= 1e-6


def test_gelu_is_jax_tanh_form_not_erf():
    x = np.linspace(-6, 6, 4001).astype(np.float32)
    ref = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = L.gelu(torch.from_numpy(x)).numpy()
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)
    assert np.abs(erf - ref).max() > 1e-4      # the gap the test sits under


@pytest.mark.parametrize("arch", ["gemma3-1b-smoke", "llama3.2-1b-smoke"])
@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_embedding_scale_matches_jax(arch, table_dtype):
    cfg = jax_config(arch)
    rng = np.random.default_rng(3)
    jdt = jnp.bfloat16 if table_dtype == "bfloat16" else jnp.float32
    table = jnp.asarray(rng.normal(0, 0.02, (cfg.padded_vocab,
                                             cfg.d_model)), jdt)
    ids = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    ref = JL.embed_tokens({"tokens": table}, jnp.asarray(ids), cfg,
                          dtype=jnp.float32)
    t_table = torch.from_numpy(np.array(table, np.float32)).to(
        getattr(torch, table_dtype))
    out = L.embed_tokens(t_table, torch.from_numpy(ids), torch.float32,
                         cfg.name)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    scaled = not np.array_equal(out.numpy(), t_table[ids].float().numpy())
    assert scaled == arch.startswith("gemma")


def test_forward_matches_jax(pair):
    jm, params, tm = pair
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, tm.cfg.vocab_size, (2, 40)).astype(np.int32)
    ref, _ = jm.forward(params, {"tokens": jnp.asarray(tokens)})
    out = tm(torch.from_numpy(tokens))
    assert out.shape == (2, 40, tm.cfg.padded_vocab)
    assert _rel(out.numpy(), ref) <= 1e-4


def test_decode_steps_match_jax(pair):
    jm, params, tm = pair
    b, steps = 3, 12
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, tm.cfg.vocab_size, (b, steps)).astype(np.int32)
    js = JD.init_state(jm, b, 32, cache_dtype="float32")
    ts = D.init_state(tm, b, 32, cache_dtype="float32")
    for t in range(steps):
        ref, js = JD.decode_step(jm, params, js,
                                 jnp.asarray(tokens[:, t:t + 1]))
        out = D.decode_step(tm, ts, torch.from_numpy(tokens[:, t:t + 1]))
        assert _rel(out.numpy(), ref) <= 1e-4, t


def test_decode_reproduces_forward(pair):
    _, _, tm = pair
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, tm.cfg.vocab_size, (2, 20)))
    fwd = tm(tokens)
    state = D.init_state(tm, 2, 32, cache_dtype="float32")
    dec = torch.cat([D.decode_step(tm, state, tokens[:, t:t + 1])
                     for t in range(20)], dim=1)
    assert _rel(dec.numpy(), fwd.numpy()) < 5e-3


def test_qkv_biases_reach_every_path():
    """Zeroing qwen2's biases moves the forward, the decode step and the
    training forward far past the tolerance above: the biases are used."""
    arch = "qwen2-1.5b-smoke"
    _, _, tm = _pair(jax_config(arch), get_config(arch))
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, tm.cfg.vocab_size, (2, 8)))

    def outputs():
        state = D.init_state(tm, 2, 16, cache_dtype="float32")
        return (tm(tokens), D.decode_step(tm, state, tokens[:, :1]),
                tm.forward_train(tokens))

    with torch.no_grad():
        biased = outputs()
        for layer in tm.layers:
            for name in BIASES:
                getattr(layer.attn, name).zero_()
        zeroed = outputs()
    for a, b in zip(biased, zeroed):
        assert _rel(a.numpy(), b.numpy()) > 1e-2


def test_gemma3_window_schedule_is_jax_grouped_stack():
    """26 layers = 4 groups of 5 local (512) + 1 global, and 2 local."""
    cfg = get_config("gemma3-1b")
    assert layer_windows(cfg) == ([512] * 5 + [0]) * 4 + [512, 512]
    shapes = JaxModel(jax_config("gemma3-1b")).shapes()["layers"]
    assert set(shapes) == {"groups", "tail"}
    assert shapes["groups"]["locals"]["attn"]["wq"].shape[:2] == (4, 5)
    assert shapes["groups"]["glob"]["attn"]["wq"].shape[0] == 4
    assert shapes["tail"]["attn"]["wq"].shape[0] == 2


def test_gemma3_reduction_with_a_tail_matches_jax():
    """8 layers at period 3: 2 groups of 2 local + 1 global and a tail
    of 2, through the converter's group, glob and tail mapping."""
    kw = dict(n_layers=8, global_every=3)
    cfg_j = dataclasses.replace(jax_config("gemma3-1b-smoke"), **kw)
    cfg_t = dataclasses.replace(get_config("gemma3-1b-smoke"), **kw)
    jm, params, tm = _pair(cfg_j, cfg_t, seed=8)
    assert set(params["layers"]) == {"groups", "tail"}
    assert tm.windows == [16, 16, 0, 16, 16, 0, 16, 16]
    tokens = np.random.default_rng(9).integers(0, cfg_t.vocab_size,
                                               (2, 40)).astype(np.int32)
    ref, _ = jm.forward(params, {"tokens": jnp.asarray(tokens)})
    assert _rel(tm(torch.from_numpy(tokens)).numpy(), ref) <= 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_parameters_are_jax_parameters(arch):
    """The port's parameters: JAX's count (``ArchConfig.n_params``, the
    biases included, no ``wg`` when ungated), zero biases at init."""
    cfg = get_config(arch)
    m = Model(cfg, seed=0, device="cpu")
    assert sum(p.numel() for p in m.parameters()) == cfg.n_params()
    for layer in m.layers:
        assert (layer.mlp.wg is None) == (not cfg.mlp_gated)
        for name in BIASES:
            b = getattr(layer.attn, name)
            assert (b is None) == (not cfg.qkv_bias)
            assert b is None or not b.any()
    ungated = dataclasses.replace(cfg, act="gelu", mlp_gated=False)
    m = Model(ungated, device="cpu")
    assert sum(p.numel() for p in m.parameters()) == ungated.n_params()
