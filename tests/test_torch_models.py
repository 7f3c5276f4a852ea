"""The port's dense decoder against the JAX package's, on the CPU.

Layers (RMSNorm, RoPE, SwiGLU) to 1e-6 relative; ``Model.forward`` of
``llama3.2-1b-smoke`` with the JAX parameters carried across by
``model_params_from_numpy`` against JAX ``Model(attn_impl="dense")``,
and 12 ``decode_step``s with a float32 cache against JAX's, both to
1e-4 relative on the logits (float32 sums taken in another order; the
RoPE frequencies' ``pow`` may round an ulp apart between XLA and
PyTorch).  On the CPU the attention kernels run as their plain
versions.
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
from repro.models.attention import make_mask as jax_make_mask
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import Model, decode as D
from repro_torch.models import layers as L
from repro_torch.models.attention import make_mask, update_kv_cache
from repro_torch.models.transformer import init_tensor

# One intra-op thread: the suite's workers share the cores, and torch's
# OpenMP threads, oversubscribed, spin-wait ~100x longer than the ops.
torch.set_num_threads(1)

ARCH = "llama3.2-1b-smoke"


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


@pytest.fixture(scope="module")
def pair():
    """The JAX model and its parameters, and the port's copy of them."""
    cfg = jax_config(ARCH)
    jm = JaxModel(cfg, remat="none", attn_impl="dense")
    params = jm.init(jax.random.key(1))
    tree = jax.tree.map(np.asarray, params)
    tm = model_params_from_numpy(tree, get_config(ARCH), device="cpu")
    return jm, params, tm


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 3, (2, 5, 64)).astype(np.float32)
    scale = rng.normal(1, 0.1, (64,)).astype(np.float32)
    ref = JL.apply_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                        jax_config(ARCH))
    out = L.rms_norm(torch.from_numpy(x), torch.from_numpy(scale))
    assert _rel(out.numpy(), ref) <= 1e-6


def test_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 9, 4, 64)).astype(np.float32)
    pos = np.arange(1000, 1009, dtype=np.int32)
    ref = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500_000.0)
    out = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 500_000.0)
    assert _rel(out.numpy(), ref) <= 1e-6
    per_slot = np.array([[3], [4000]], np.int32)          # decode: (B, 1)
    ref = JL.apply_rope(jnp.asarray(x[:, :1]), jnp.asarray(per_slot),
                        500_000.0)
    out = L.apply_rope(torch.from_numpy(x[:, :1]),
                       torch.from_numpy(per_slot), 500_000.0)
    assert _rel(out.numpy(), ref) <= 1e-6


def test_swiglu_matches_jax():
    """The gated silu MLP (``apply_mlp`` with ``wg``)."""
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (3, 7, 64)).astype(np.float32)
    w = {n: rng.normal(0, 0.1, s).astype(np.float32)
         for n, s in (("wi", (64, 128)), ("wg", (64, 128)),
                      ("wo", (128, 64)))}
    ref = JL.apply_mlp({k: jnp.asarray(v) for k, v in w.items()},
                       jnp.asarray(x), jax_config(ARCH))
    out = L.apply_mlp(torch.from_numpy(x),
                      *(torch.from_numpy(w[n]) for n in ("wi", "wg", "wo")),
                      "silu")
    assert _rel(out.numpy(), ref) <= 1e-6


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 5)])
def test_make_mask_matches_jax(causal, window):
    qp, kp = np.arange(12), np.arange(16)
    ref = jax_make_mask(jnp.asarray(qp), jnp.asarray(kp), causal=causal,
                        window=window)
    out = make_mask(torch.from_numpy(qp), torch.from_numpy(kp),
                    causal=causal, window=window)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_forward_matches_jax(pair):
    jm, params, tm = pair
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, tm.cfg.vocab_size, (2, 16)).astype(np.int32)
    ref, _ = jm.forward(params, {"tokens": jnp.asarray(tokens)})
    out = tm(torch.from_numpy(tokens))
    assert out.shape == (2, 16, tm.cfg.padded_vocab) and out.dtype == \
        torch.float32
    assert _rel(out.numpy(), ref) <= 1e-4


def test_decode_steps_match_jax(pair):
    jm, params, tm = pair
    b, steps = 3, 12
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, tm.cfg.vocab_size, (b, steps)).astype(np.int32)
    js = JD.init_state(jm, b, 32, cache_dtype="float32")
    ts = D.init_state(tm, b, 32, cache_dtype="float32")
    for t in range(steps):
        ref, js = JD.decode_step(jm, params, js, jnp.asarray(tokens[:, t:t + 1]))
        out = D.decode_step(tm, ts, torch.from_numpy(tokens[:, t:t + 1]))
        assert _rel(out.numpy(), ref) <= 1e-4, t
    np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js["pos"]))
    assert _rel(ts.k.numpy(), js["layers"]["flat"]["k"]) <= 1e-4


def test_decode_reproduces_forward(pair):
    """The port's decode (kernel B3's plain version) against its forward
    (B2's), the bound of tests/test_models.py."""
    _, _, tm = pair
    tokens = torch.from_numpy(
        np.random.default_rng(5).integers(0, tm.cfg.vocab_size, (2, 12)))
    fwd = tm(tokens)
    state = D.init_state(tm, 2, 32, cache_dtype="float32")
    dec = torch.cat([D.decode_step(tm, state, tokens[:, t:t + 1])
                     for t in range(12)], dim=1)
    assert _rel(dec.numpy(), fwd.numpy()) < 5e-3
    logits, st = D.prefill(tm, tokens, 32, cache_dtype="float32")
    assert torch.equal(logits, dec[:, -1:]) and st.pos.tolist() == [12, 12]


def test_cache_write_clamps_and_rounds_like_jax():
    """Past the cache's end the write lands on S - 1 (JAX's
    dynamic_update_slice clamps); the bf16 cast rounds to nearest even."""
    from repro.models.attention import update_kv_cache as jax_update
    rng = np.random.default_rng(6)
    kc = np.zeros((3, 8, 2, 16), np.float32)
    k = rng.normal(0, 1, (3, 1, 2, 16)).astype(np.float32)
    pos = np.array([0, 7, 12], np.int32)
    jk, _ = jax_update(jnp.asarray(kc, jnp.bfloat16),
                       jnp.asarray(kc, jnp.bfloat16), jnp.asarray(k),
                       jnp.asarray(k), jnp.asarray(pos))
    tk = torch.zeros((3, 8, 2, 16), dtype=torch.bfloat16)
    tv = torch.zeros_like(tk)
    update_kv_cache(tk, tv, torch.from_numpy(k), torch.from_numpy(k),
                    torch.from_numpy(pos))
    np.testing.assert_array_equal(tk.float().numpy(),
                                  np.asarray(jk, np.float32))
    assert torch.equal(tk, tv)


def test_init_kinds_and_scales():
    g = torch.Generator().manual_seed(0)
    cpu = torch.device("cpu")
    assert torch.equal(init_tensor((3,), "zeros", g, torch.float32, cpu),
                       torch.zeros(3))
    assert torch.equal(init_tensor((3,), "const", g, torch.float32, cpu,
                                   scale=-1e30), torch.full((3,), -1e30))
    x = init_tensor((256, 64), "normal", g, torch.float32, cpu, scale=2.0)
    assert 1.9 < float(x.std()) < 2.1
    with pytest.raises(ValueError, match="unknown init"):
        init_tensor((3,), "xavier", g, torch.float32, cpu)
    cfg = get_config("llama3.2-1b-smoke")
    m = Model(cfg, seed=3, device="cpu")
    assert 0.018 < float(m.tokens.std()) < 0.022
    assert torch.equal(m.final_norm, torch.ones(cfg.d_model))
    lay = m.layers[0]
    assert torch.equal(lay.attn_norm, torch.ones(cfg.d_model))
    # fan_in over the leading axis, as params.ParamDef's default
    for w, fan in ((lay.attn.wq, cfg.d_model), (lay.attn.wo, cfg.n_heads),
                   (lay.mlp.wi, cfg.d_model), (lay.mlp.wo, cfg.d_ff)):
        assert abs(float(w.std()) * fan ** 0.5 - 1.0) < 0.1
    same = Model(cfg, seed=3, device="cpu")
    assert torch.equal(same.layers[1].mlp.wg, m.layers[1].mlp.wg)
    assert not any(p.requires_grad for p in m.parameters())


@pytest.mark.parametrize("change", [
    {"family": "rnn"},           # every family of the JAX package is ported
    {"attn_logit_softcap": 30.0}, {"act": "relu"},   # layernorm is ported
])
def test_unported_features_raise(change):
    cfg = dataclasses.replace(get_config(ARCH), **change)
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        Model(cfg, device="cpu")


@pytest.mark.parametrize("change", [
    {"qkv_bias": True}, {"act": "gelu", "mlp_gated": False},
], ids=["qkv_bias", "gelu_ungated"])
def test_ported_features_match_jax(change):
    """The two features that raised until gemma3-1b and qwen2-1.5b were
    ported, on llama's smoke model: ``Model.forward`` against JAX's, the
    biases drawn at random on both sides (JAX's init gives zeros)."""
    cfg_j = dataclasses.replace(jax_config(ARCH), **change)
    cfg_t = dataclasses.replace(get_config(ARCH), **change)
    jm = JaxModel(cfg_j, remat="none", attn_impl="dense")
    rng = np.random.default_rng(8)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(2)))
    for layer in (tree["layers"]["flat"],):
        for name in ("bq", "bk", "bv"):
            if name in layer["attn"]:
                layer["attn"][name] = rng.normal(
                    0, 0.5, layer["attn"][name].shape).astype(np.float32)
    tm = model_params_from_numpy(tree, cfg_t, device="cpu")
    assert (tm.layers[0].attn.bq is not None) == cfg_t.qkv_bias
    assert (tm.layers[0].mlp.wg is None) == (not cfg_t.mlp_gated)
    tokens = rng.integers(0, cfg_t.vocab_size, (2, 16)).astype(np.int32)
    ref, _ = jm.forward(jax.tree.map(jnp.asarray, tree),
                        {"tokens": jnp.asarray(tokens)})
    assert _rel(tm(torch.from_numpy(tokens)).numpy(), ref) <= 1e-4


def test_convert_rejects_a_misshapen_tree(pair):
    jm, params, _ = pair
    tree = jax.tree.map(np.asarray, params)
    tree["layers"]["flat"]["mlp"]["wi"] = tree["layers"]["flat"]["mlp"][
        "wi"][:, :, :64]
    with pytest.raises(ValueError, match="shape"):
        model_params_from_numpy(tree, get_config(ARCH), device="cpu")
