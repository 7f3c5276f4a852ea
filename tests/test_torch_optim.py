"""The port's optimizer substrate and loss against the JAX package's.

Schedules at every step to rtol 1e-6 (XLA's float32 ``cos`` and
torch's may differ by an ulp); AdamW on the same numpy parameters,
gradients and moments for several steps to rtol 1e-6: run eagerly, JAX
gives the port's bits; jitted, as the train step runs it, XLA on the
CPU contracts ``b1*m + (1-b1)*g`` and its kin into FMAs (ROADMAP C3),
and the worst difference seen is 1.2e-7 of the largest element;
global-norm clipping and the
int8 error-feedback compression with ``tests/test_optim.py``'s
tolerances; ``cross_entropy``'s value and gradient to 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.optim import adamw as JA
from repro.optim import compress as JC
from repro.optim import schedules as JS
from repro.train import step as JT
from repro_torch.models.layers import cross_entropy
from repro_torch.optim import (adamw_init, adamw_update, compress_decompress,
                               compression_init, constant, int8_dequantize,
                               int8_quantize, linear_warmup_cosine)
from repro_torch.optim.adamw import decays
from repro_torch.train.step import clip_by_global_norm, global_norm

# One intra-op thread: the suite's workers share the cores, and torch's
# OpenMP threads, oversubscribed, spin-wait ~100x longer than the ops.
torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("kw", [
    dict(peak_lr=3e-4, warmup_steps=100, total_steps=1000),
    dict(peak_lr=1.0, warmup_steps=10, total_steps=100),
    dict(peak_lr=3e-4, warmup_steps=2, total_steps=8, final_frac=0.0),
    dict(peak_lr=0.5, warmup_steps=0, total_steps=50),
], ids=["default", "unit", "short", "no-warmup"])
def test_linear_warmup_cosine_matches_jax_at_every_step(kw):
    steps = np.arange(kw["total_steps"] + 1, dtype=np.int32)
    ref = np.asarray(jax.vmap(
        lambda s: JS.linear_warmup_cosine(s, **kw))(jnp.asarray(steps)))
    got = linear_warmup_cosine(torch.from_numpy(steps), **kw).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    # a Python int and a scalar tensor give the same as the vector
    for s in (0, kw["warmup_steps"], kw["total_steps"]):
        assert float(linear_warmup_cosine(s, **kw)) == float(got[s])


def test_constant_matches_jax():
    for step in (0, 7, torch.tensor(3, dtype=torch.int32)):
        ref = JS.constant(np.asarray(step), peak_lr=2.5e-4, warmup_steps=3)
        got = constant(step, peak_lr=2.5e-4, warmup_steps=3)
        assert got.dtype == torch.float32 and float(got) == float(ref)


def _adam_case(seed):
    """JAX's stacked tree and the port's flat names for the same numbers:
    a 2-D weight, a 1-D final norm, and a layer stack of (L, d) norms and
    (L, d, f) weights that the port holds per layer."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(0, 1, s).astype(np.float32)
    jax_tree = {"w": f32(6, 5), "final_norm": f32(5),
                "layers": {"norm": f32(3, 5), "wi": f32(3, 5, 4)}}
    return jax_tree, _flat_of(jax_tree)


def _flat_of(jax_tree):
    out = {"w": jax_tree["w"], "final_norm": jax_tree["final_norm"]}
    for i in range(3):
        out[f"layers.{i}.norm"] = jax_tree["layers"]["norm"][i]
        out[f"layers.{i}.wi"] = jax_tree["layers"]["wi"][i]
    return out


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
@pytest.mark.parametrize("weight_decay", [0.1, 0.0])
def test_adamw_update_matches_jax_over_steps(weight_decay, jit):
    update = (jax.jit(JA.adamw_update, static_argnames="weight_decay")
              if jit else JA.adamw_update)
    jp, flat = _adam_case(0)
    jp = jax.tree.map(jnp.asarray, jp)
    tp = {k: _t(v) for k, v in flat.items()}
    js, ts = JA.adamw_init(jp), adamw_init(tp)
    assert ts.step.dtype == torch.int32 and int(ts.step) == 0
    worst = 0.0
    for step in range(5):
        jg, flat_g = _adam_case(100 + step)
        jg = jax.tree.map(lambda x: jnp.asarray(x * 0.1), jg)
        tg = {k: _t(v * 0.1) for k, v in flat_g.items()}
        lr = 1e-2 * (step + 1)
        jp, js = update(jg, js, jp, lr=jnp.float32(lr),
                        weight_decay=weight_decay)
        tp, ts = adamw_update(tg, ts, tp, lr=torch.tensor(lr),
                              weight_decay=weight_decay)
        assert int(ts.step) == int(js.step) == step + 1
        for tree_j, tree_t in ((jp, tp), (js.mu, ts.mu), (js.nu, ts.nu)):
            ref = _flat_of(jax.tree.map(np.asarray, tree_j))
            for name, arr in ref.items():
                got = tree_t[name].numpy()
                np.testing.assert_allclose(got, arr, rtol=1e-6, atol=1e-7,
                                           err_msg=name)
                worst = max(worst, _rel(got, arr))
    assert worst < 1e-6
    assert jit or worst == 0.0


def test_adamw_decays_what_jax_decays():
    """JAX decays arrays of ndim >= 2: the stacked layer norms (L, d) but
    not the final norm (d,).  The port decides on JAX's arrays."""
    _, flat = _adam_case(0)
    got = {k: decays(k, _t(v)) for k, v in flat.items()}
    assert got == {k: k != "final_norm" for k in flat}
    p = {"final_norm": torch.ones(8), "layers.0.attn_norm": torch.ones(8)}
    g = {k: torch.zeros(8) for k in p}
    new, _ = adamw_update(g, adamw_init(p), p, lr=torch.tensor(0.1),
                          weight_decay=0.5)
    assert torch.equal(new["final_norm"], torch.ones(8))
    assert float(new["layers.0.attn_norm"][0]) == pytest.approx(0.95)


def test_adamw_does_not_touch_its_inputs():
    _, flat = _adam_case(1)
    p = {k: _t(v) for k, v in flat.items()}
    before = {k: v.clone() for k, v in p.items()}
    state = adamw_init(p)
    new, state2 = adamw_update({k: torch.ones_like(v) for k, v in p.items()},
                               state, p, lr=torch.tensor(0.1))
    for k in p:
        assert torch.equal(p[k], before[k])
        assert torch.equal(state.mu[k], torch.zeros_like(p[k]))
        assert not torch.equal(new[k], p[k])
    assert int(state.step) == 0 and int(state2.step) == 1


def test_global_norm_and_clip_match_jax():
    rng = np.random.default_rng(3)
    tree = {"a": rng.normal(0, 2, (4, 8)).astype(np.float32),
            "b": rng.normal(0, 1, (5,)).astype(np.float32)}
    jt = jax.tree.map(jnp.asarray, tree)
    tt = {k: _t(v) for k, v in tree.items()}
    assert float(global_norm(tt)) == pytest.approx(
        float(JT.global_norm(jt)), rel=1e-6)
    for max_norm in (1.0, 100.0):
        jc, jn = JT.clip_by_global_norm(jt, max_norm)
        tc, tn = clip_by_global_norm(tt, max_norm)
        assert float(tn) == pytest.approx(float(jn), rel=1e-6)
        for k in tree:
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       rtol=1e-5)
    # test_optim.py's case: norm 10, clipped to 1, untouched below
    tree = {"a": torch.full((4,), 3.0), "b": torch.full((4,), 4.0)}
    assert float(global_norm(tree)) == pytest.approx(10.0)
    clipped, reported = clip_by_global_norm(tree, 1.0)
    assert float(reported) == pytest.approx(10.0)
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    same, _ = clip_by_global_norm(tree, 100.0)
    assert torch.equal(same["a"], tree["a"])


@pytest.mark.parametrize("scale", [1e-3, 1.0, 100.0])
def test_int8_quantize_matches_jax(scale):
    x = (np.random.default_rng(4).normal(0, 1, (257,)) * scale).astype(
        np.float32)
    jq, js = JC.int8_quantize(jnp.asarray(x))
    tq, ts = int8_quantize(_t(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    deq = int8_dequantize(tq, ts)
    np.testing.assert_array_equal(deq.numpy(),
                                  np.asarray(JC.int8_dequantize(jq, js)))
    assert float((_t(x) - deq).abs().max()) <= float(ts) * 0.5 + 1e-6


def test_compress_decompress_matches_jax_and_keeps_the_invariant():
    """deq_t + residual_{t+1} == grad_t + residual_t: no signal is lost,
    only delayed (test_optim.py's error-feedback invariant), and each
    step's payload equals JAX's."""
    g = np.random.default_rng(0).normal(0, 1, (64,)).astype(np.float32)
    jstate = JC.compression_init({"w": jnp.zeros(64)})
    tstate = compression_init({"w": torch.zeros(64)})
    total_in, total_out = np.zeros(64), np.zeros(64)
    for t in range(20):
        gt = (g * (t + 1) / 10.0).astype(np.float32)
        jd, jstate = JC.compress_decompress({"w": jnp.asarray(gt)}, jstate)
        td, tstate = compress_decompress({"w": _t(gt)}, tstate)
        np.testing.assert_allclose(td["w"].numpy(), np.asarray(jd["w"]),
                                   rtol=1e-6, atol=1e-6)
        total_in += gt
        total_out += td["w"].numpy()
    np.testing.assert_allclose(total_out + tstate.residual["w"].numpy(),
                               total_in, rtol=1e-5, atol=1e-5)


def test_compressed_training_still_converges():
    """test_optim.py's toy regression, in the port."""
    rng = np.random.default_rng(0)
    X = _t(rng.normal(0, 1, (128, 8)).astype(np.float32))
    y = X @ _t(rng.normal(0, 1, (8,)).astype(np.float32))

    def run(compress):
        p = {"w": torch.zeros(8)}
        state, comp = adamw_init(p), compression_init(p)
        for _ in range(300):
            w = p["w"].clone().requires_grad_()
            loss = ((X @ w - y) ** 2).mean()
            g = {"w": torch.autograd.grad(loss, w)[0]}
            if compress:
                g, comp = compress_decompress(g, comp)
            p, state = adamw_update(g, state, p, lr=torch.tensor(0.05),
                                    weight_decay=0.0)
        return float(((X @ p["w"] - y) ** 2).mean())

    assert run(True) < 1e-2
    assert run(True) < run(False) * 50 + 1e-3


@pytest.mark.parametrize("masked", [False, True], ids=["all", "mask"])
def test_cross_entropy_value_and_gradient_match_jax(masked):
    rng = np.random.default_rng(5)
    logits = rng.normal(0, 3, (2, 7, 96)).astype(np.float32)
    labels = rng.integers(0, 96, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.6).astype(np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    ref, jgrad = jax.value_and_grad(
        lambda lg: JL.cross_entropy(lg, jnp.asarray(labels), jm))(
            jnp.asarray(logits))
    x = _t(logits).requires_grad_()
    got = cross_entropy(x, _t(labels),
                        None if mask is None else _t(mask))
    (grad,) = torch.autograd.grad(got, x)
    assert got.dtype == torch.float32
    assert _rel(float(got.detach()), float(ref)) <= 1e-6
    assert _rel(grad.numpy(), jgrad) <= 1e-6


def test_cross_entropy_of_bf16_logits_is_float32():
    logits = torch.randn((1, 3, 64), generator=torch.Generator().manual_seed(0))
    labels = torch.tensor([[1, 2, 3]])
    ref = cross_entropy(logits.bfloat16().float(), labels)
    got = cross_entropy(logits.bfloat16(), labels)
    assert got.dtype == torch.float32 and float(got) == float(ref)
