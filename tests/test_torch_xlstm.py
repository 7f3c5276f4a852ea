"""The ssm family (xlstm-125m) in the port against the JAX package, on
the CPU, at ``xlstm-125m-smoke`` (one pair of an mLSTM and an sLSTM
block, d 64, 4 heads: the mLSTM's inner width 128 at hd 32, the
sLSTM's hd 16) and at a 4-layer (2-pair) variant of it.

JAX initializes the norms' scales and ``out_norm`` to ones and ``b_if``
and ``b_gates`` to zeros, where a port that dropped or misplaced them
would pass; the comparisons draw them from the seed on both sides.

* ``mlstm_apply`` against JAX's: at S = 20 with a chunk of 8 (the
  padding), and at S < 128 with the default chunk; ``slstm_apply``;
  both decode steps step by step from JAX's -1e30 state; all to atol
  1e-5, rtol 1e-4 (each block's output is O(1)).
* ROADMAP C27: at xlstm-125m's full width and init, one chunk of 128
  tokens makes JAX's ``mlstm_apply`` NaN (``exp`` overflows on the
  masked upper triangle before ``* causal``); the port's is finite and
  equals the token-by-token recurrence (``mlstm_decode_step``) to 1e-4
  relative, and JAX's own form where that is finite (S = 100).
* ``Model.forward``, ``forward_train``, ``Model.loss`` and every
  gradient leaf against ``jax.grad``: the logits to 1e-5 relative, the
  loss to 1e-5 relative, each leaf to atol 1e-5, rtol 1e-4, as the
  dense tests hold theirs.
* ``decode_step`` over 12 tokens and ``prefill`` against JAX's, to
  1e-5 relative (the recurrent state is float32 whatever the cache's
  type); the port's own forward against its decode within 5e-3.
* The serving engine's greedy tokens equal JAX's engine's, token for
  token, over more requests than slots: slot reuse after the reset, a
  free slot that runs many steps, and a preemption under a shrunk pool;
  the reset restores every m to -1e30 (C26: the pool is JAX's notional
  KV pool, sized as if the model had K/V).
* The converter carries JAX's parameters and AdamW moments over and
  refuses a misshapen pair; AdamW decays what JAX's ``ndim >= 2``
  decays (every stacked leaf, not ``final_norm``).
* The trainer's losses from JAX's init in 1 and 2 microbatches, within
  ``LOSS_TOL`` of JAX's.
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
from repro.models import ssm as jssm
from repro.models.params import Axes, count_params, init_params
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
from repro_torch.kernels import decode_attention as kd
from repro_torch.kernels import flash_attention as kf
from repro_torch.kernels import ssm_scan as kscan
from repro_torch.launch import profile_serve, serve
from repro_torch.models import Model, decode as D
from repro_torch.models import ssm as tssm
from repro_torch.optim.adamw import decays
from repro_torch.serving import ServingConfig, ServingEngine
from repro_torch.train import Trainer, TrainerConfig, TrainStepConfig

# One intra-op thread: the suite's workers share the cores, and torch's
# OpenMP threads, oversubscribed, spin-wait ~100x longer than the ops.
torch.set_num_threads(1)

ARCH = "xlstm-125m-smoke"
# Logged losses, port against JAX from the same init (absolute, on a loss
# of ~6.2), as tests/test_torch_train.py holds llama's.
LOSS_TOL = 1e-5
# A block's output or a leaf of the state, port against JAX
ATOL, RTOL = 1e-5, 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _t(x):
    return torch.from_numpy(np.array(x))


_DRAWN = {"scale": 1.0, "out_norm": 1.0, "b_if": 0.0, "b_gates": 0.0}


def _drawn(tree, rng):
    """The tree with every norm's scale, ``out_norm``, ``b_if`` and
    ``b_gates`` drawn around their init (ones and zeros)."""
    if not isinstance(tree, dict):
        return tree
    return {k: ((_DRAWN[k] + rng.normal(0, 0.2, v.shape)).astype(np.float32)
                if k in _DRAWN else _drawn(v, rng))
            for k, v in tree.items()}


def _model_pair(seed=1, **change):
    """JAX's model and parameters (norms and biases drawn), the port's
    copy, and the numpy tree."""
    cfg_j = dataclasses.replace(jax_config(ARCH), **change)
    cfg_t = dataclasses.replace(get_config(ARCH), **change)
    jm = JaxModel(cfg_j, remat="none")
    tree = _drawn(jax.tree.map(np.asarray, jm.init(jax.random.key(seed))),
                  np.random.default_rng(seed))
    return jm, jax.tree.map(jnp.asarray, tree), \
        model_params_from_numpy(tree, cfg_t, device="cpu"), tree


@pytest.fixture(scope="module")
def pair():
    return _model_pair()


@pytest.fixture(scope="module")
def pair4():
    return _model_pair(seed=2, n_layers=4)


def _blocks(pair, p=0):
    """Pair ``p``'s (JAX params, port module) of the mLSTM and sLSTM."""
    _, params, tm, _ = pair
    out = {}
    for key, block in tm.layers[p].items():
        leaves = jax.tree.map(lambda a: a[p], params["layers"][key]["block"])
        out[block.kind] = (leaves, block.block)
    return out


def _u(seed, b, s, d=64):
    return np.random.default_rng(seed).normal(0, 1, (b, s, d)).astype(
        np.float32)


# ---- the blocks ------------------------------------------------------------

@pytest.mark.parametrize("s,chunk", [(20, 8), (24, 8), (50, 128)],
                         ids=["pad", "whole-chunks", "default-chunk"])
def test_mlstm_apply_matches_jax(pair, s, chunk):
    jp, tp = _blocks(pair)["mlstm"]
    cfg = pair[2].cfg
    u = _u(3, 2, s)
    ref = jssm.mlstm_apply(jp, jnp.asarray(u), pair[0].cfg, chunk=chunk)
    out = tssm.mlstm_apply(tp, _t(u), cfg, chunk=chunk)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_slstm_apply_matches_jax(pair):
    jp, tp = _blocks(pair)["slstm"]
    u = _u(4, 3, 17)
    ref = jssm.slstm_apply(jp, jnp.asarray(u), pair[0].cfg)
    out = tssm.slstm_apply(tp, _t(u), pair[2].cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_steps_match_jax_from_the_starting_state(pair, kind):
    """Eight tokens one at a time from JAX's state (m = -1e30, the rest
    0): every output and every leaf of the state."""
    jp, tp = _blocks(pair)[kind]
    jcfg, cfg = pair[0].cfg, pair[2].cfg
    shapes = (jssm.mlstm_state_shapes if kind == "mlstm"
              else jssm.slstm_state_shapes)(jcfg, 2)
    assert shapes == (tssm.mlstm_state_shapes if kind == "mlstm"
                      else tssm.slstm_state_shapes)(cfg, 2)
    jst = {k: jnp.full(v, -1e30 if k == "m" else 0.0, jnp.float32)
           for k, v in shapes.items()}
    tst = {k: _t(np.asarray(v)) for k, v in jst.items()}
    jstep = jssm.mlstm_decode_step if kind == "mlstm" \
        else jssm.slstm_decode_step
    tstep = tssm.mlstm_decode_step if kind == "mlstm" \
        else tssm.slstm_decode_step
    u = _u(5, 2, 8)
    for t in range(8):
        ref, jst = jstep(jp, jnp.asarray(u[:, t:t + 1]), jst, jcfg)
        out, tst = tstep(tp, _t(u[:, t:t + 1]), tst, cfg)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                                   rtol=RTOL, err_msg=str(t))
        for k in jst:
            np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                       atol=ATOL, rtol=RTOL,
                                       err_msg=f"{t} {k}")


def test_mlstm_gradients_match_jax_through_the_padding(pair):
    """Every leaf's gradient of a chunked, padded mLSTM (S = 20, chunk 8)
    and the input's, against ``jax.grad``."""
    jp, tp = _blocks(pair)["mlstm"]
    u = _u(6, 2, 20)
    w = np.random.default_rng(7).normal(0, 1, u.shape).astype(np.float32)
    cfg_j = pair[0].cfg

    def jloss(p, x):
        return (jssm.mlstm_apply(p, x, cfg_j, chunk=8) * w).sum()

    jg, jgu = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(u))
    names = [n for n, _ in tp.named_parameters()]
    ut = _t(u).requires_grad_(True)
    with torch.enable_grad():
        tp.requires_grad_(True)
        loss = (tssm.mlstm_apply(tp, ut, pair[2].cfg, chunk=8) * _t(w)).sum()
        grads = torch.autograd.grad(loss, list(tp.parameters()) + [ut])
        tp.requires_grad_(False)
    for name, g in zip(names + ["u"], grads):
        want = np.asarray(jgu if name == "u" else jg[name])
        assert np.isfinite(g.numpy()).all(), name
        np.testing.assert_allclose(g.numpy(), want, atol=ATOL, rtol=RTOL,
                                   err_msg=name)


@pytest.fixture(scope="module")
def full_mlstm():
    """One mLSTM block at xlstm-125m's full width and JAX's init."""
    cfg = jax_config("xlstm-125m")
    jp = init_params(jssm.mlstm_schema(cfg, Axes()), jax.random.key(0),
                     jnp.float32)

    def make_from(arrays):
        names = iter(["up_proj", "wq", "wk", "wv", "w_if", "b_if",
                      "out_norm", "down_proj"])

        def make(shape, kind, **kw):
            a = np.asarray(arrays[next(names)])
            assert a.shape == shape
            return torch.nn.Parameter(_t(a), requires_grad=False)
        return make

    tp = tssm.MLSTM(get_config("xlstm-125m"), make_from(jp))
    return cfg, jp, tp


def test_mlstm_at_full_width_is_finite_where_jax_overflows(full_mlstm):
    """ROADMAP C27.  At S = 128 (one whole chunk) JAX's mLSTM is NaN at
    xlstm-125m's init; the port's equals the recurrence stepped token by
    token.  At S = 100 JAX is finite and the port equals it."""
    cfg, jp, tp = full_mlstm
    tcfg = get_config("xlstm-125m")
    u = _u(8, 1, 128, 768)
    ref = np.asarray(jssm.mlstm_apply(jp, jnp.asarray(u), cfg))
    assert np.isnan(ref).any()
    out = tssm.mlstm_apply(tp, _t(u), tcfg)
    assert torch.isfinite(out).all()
    state = {k: torch.full(v, -1e30 if k == "m" else 0.0)
             for k, v in tssm.mlstm_state_shapes(tcfg, 1).items()}
    steps = []
    for t in range(128):
        y, state = tssm.mlstm_decode_step(tp, _t(u[:, t:t + 1]), state, tcfg)
        steps.append(y)
    assert _rel(out.numpy(), torch.cat(steps, 1).numpy()) <= 1e-4
    ref = jssm.mlstm_apply(jp, jnp.asarray(u[:, :100]), cfg)
    out = tssm.mlstm_apply(tp, _t(u[:, :100]), tcfg)
    assert _rel(out.numpy(), ref) <= 1e-5


# ---- the model --------------------------------------------------------------

def test_smoke_shapes_are_jax_smoke_shapes(pair, pair4):
    """One pair (two pairs at 4 layers) named as JAX's tree; the
    parameter count is JAX's schema's; xlstm-125m's full count too."""
    for jm, _, tm, tree in (pair, pair4):
        cfg = tm.cfg
        assert len(tm.layers) == cfg.n_layers // 2
        assert [b.kind for b in tm.layers[0].values()] == ["mlstm", "slstm"]
        assert sorted(n for n, _ in tm.named_parameters()) == \
            sorted(_port_arrays(tree, cfg))
        assert sum(p.numel() for p in tm.parameters()) == count_params(
            jm.schema())
    cfg = pair[2].cfg
    assert (cfg.d_model, cfg.n_heads, cfg.ssm_expand * cfg.d_model) == \
        (64, 4, 128)
    block = pair[2].layers[0]["0_mlstm"].block
    assert tuple(block.wq.shape) == (128, 4, 32)
    assert tuple(pair[2].layers[0]["1_slstm"].block.r_gates.shape) == \
        (4, 4, 16, 16)
    full = JaxModel(jax_config("xlstm-125m")).schema()
    assert count_params(full) == 123_782_448
    ported = Model(get_config("xlstm-125m"), device="cpu", init=False)
    assert sum(p.numel() for p in ported.parameters()) == 123_782_448


def test_init_kinds_are_jax_kinds():
    """``w_if`` small (std 0.02), ``r_gates`` fan-in over its axis 2,
    ``b_if``/``b_gates`` zeros, the norms ones, the rest fan-in over
    axis 0."""
    cfg = dataclasses.replace(get_config("xlstm-125m"), n_layers=2)
    m = Model(cfg, seed=0, device="cpu")
    ml, sl = m.layers[0]["0_mlstm"], m.layers[0]["1_slstm"]
    assert abs(float(ml.block.w_if.std()) / 0.02 - 1) < 0.05
    assert abs(float(sl.block.r_gates.std()) * 192 ** 0.5 - 1) < 0.05
    assert abs(float(sl.block.w_gates.std()) * 768 ** 0.5 - 1) < 0.05
    assert abs(float(ml.block.wq.std()) * 1536 ** 0.5 - 1) < 0.05
    for t in (ml.block.b_if, sl.block.b_gates):
        assert not t.any()
    for t in (ml.norm, sl.norm, ml.block.out_norm, sl.block.out_norm):
        assert bool((t == 1).all())


@pytest.mark.parametrize("which", ["pair", "pair4"])
def test_forward_matches_jax(request, which):
    jm, params, tm, _ = request.getfixturevalue(which)
    tokens = np.random.default_rng(9).integers(
        0, tm.cfg.vocab_size, (2, 21)).astype(np.int32)
    ref, aux = jm.forward(params, {"tokens": jnp.asarray(tokens)})
    out = tm(_t(tokens))
    assert out.shape == (2, 21, tm.cfg.padded_vocab)
    assert _rel(out.numpy(), ref) <= 1e-5
    with torch.no_grad():
        train, taux = tm.forward_train(_t(tokens), aux=True)
    assert _rel(train.numpy(), ref) <= 1e-5
    assert float(taux) == float(aux) == 0.0 and taux.dtype == torch.float32


def test_ssm_path_launches_no_kernel(pair, monkeypatch):
    """Neither forward, training forward nor decode reaches an attention
    kernel or the scan: each wrapper raises if called, where the models
    call it."""
    from repro_torch.models import attention as tattn
    tm = pair[2]

    def refuse(*a, **k):
        raise AssertionError("the ssm path reached a kernel wrapper")

    for mod, name in ((tattn, "decode_attention"), (tattn, "flash_attention"),
                      (tssm, "ssm_scan")):
        monkeypatch.setattr(mod, name, refuse)
    before = (kd.LAUNCHES, kf.LAUNCHES, kscan.LAUNCHES)
    tokens = torch.randint(0, 500, (2, 9))
    tm(tokens)
    with torch.no_grad():
        tm.forward_train(tokens)
    D.prefill(tm, tokens, 16)
    assert (kd.LAUNCHES, kf.LAUNCHES, kscan.LAUNCHES) == before


@pytest.mark.parametrize("which,remat", [("pair", "full"), ("pair4", "full"),
                                         ("pair4", "dots")])
def test_model_loss_and_gradient_match_jax(request, which, remat):
    jm, params, model, _ = request.getfixturevalue(which)
    cfg = model.cfg
    rng = np.random.default_rng(11)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 19)),
             "labels": rng.integers(0, cfg.vocab_size, (2, 19))}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    jr = JaxModel(jm.cfg, remat=remat)
    (jloss, jparts), jgrads = jax.value_and_grad(
        lambda p: jr.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(params)
    want = _port_arrays(jax.tree.map(np.asarray, jgrads), cfg)
    model.remat = remat
    model.requires_grad_(True)
    try:
        loss, parts = model.loss({k: _t(v) for k, v in batch.items()})
        names = [n for n, _ in model.named_parameters()]
        grads = dict(zip(names, torch.autograd.grad(loss, list(
            model.parameters()))))
    finally:
        model.requires_grad_(False)
        model.remat = "full"
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * float(jloss)
    assert float(parts["aux"]) == float(jparts["aux"]) == 0.0
    assert sorted(want) == sorted(grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name], atol=ATOL,
                                   rtol=RTOL, err_msg=name)
    for name in ("layers.0.0_mlstm.block.w_if", "layers.0.0_mlstm.block.b_if",
                 "layers.0.1_slstm.block.r_gates",
                 "layers.0.1_slstm.block.b_gates", "layers.0.1_slstm.norm"):
        assert np.abs(want[name]).max() > 1e-5, name


# ---- decode and serving -----------------------------------------------------

def test_decode_matches_jax(pair4):
    """The state has no K/V (the cache's type shapes nothing) and starts
    as JAX's; 12 steps, then every leaf of it."""
    jm, params, tm, _ = pair4
    cache = "bfloat16"
    b, steps = 3, 12
    tokens = np.random.default_rng(12).integers(
        0, tm.cfg.vocab_size, (b, steps)).astype(np.int32)
    js = JD.init_state(jm, b, 32, cache_dtype=cache)
    ts = D.init_state(tm, b, 32, cache_dtype=cache)
    assert ts.k.shape[0] == 0 and ts.mamba_h is None
    for key, leaves in ts.recurrent.items():
        for name, leaf in leaves.items():
            np.testing.assert_array_equal(
                leaf.numpy(), np.asarray(js["layers"][key][name]))
    for t in range(steps):
        ref, js = JD.decode_step(jm, params, js,
                                 jnp.asarray(tokens[:, t:t + 1]))
        out = D.decode_step(tm, ts, _t(tokens[:, t:t + 1]))
        assert _rel(out.numpy(), ref) <= 1e-5, t
    for key, leaves in ts.recurrent.items():
        for name, leaf in leaves.items():
            np.testing.assert_allclose(
                leaf.numpy(), np.asarray(js["layers"][key][name]),
                atol=ATOL, rtol=RTOL, err_msg=f"{key} {name}")
    assert ts.pos.tolist() == np.asarray(js["pos"]).tolist() == [steps] * b


def test_prefill_matches_jax(pair):
    jm, params, tm, _ = pair
    tokens = np.random.default_rng(13).integers(
        0, tm.cfg.vocab_size, (2, 9)).astype(np.int32)
    ref, js = JD.prefill(jm, params, {"tokens": jnp.asarray(tokens)}, 16)
    out, ts = D.prefill(tm, _t(tokens), 16)
    assert _rel(out.numpy(), ref) <= 1e-5
    assert ts.pos.tolist() == np.asarray(js["pos"]).tolist() == [9, 9]


def test_forward_against_decode_within_jax_bound(pair4):
    tm = pair4[2]
    tokens = torch.randint(0, tm.cfg.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(14))
    fwd = tm(tokens)
    state = D.init_state(tm, 2, 64)
    dec = torch.cat([D.decode_step(tm, state, tokens[:, t:t + 1])
                     for t in range(40)], dim=1)
    assert _rel(dec.numpy(), fwd.numpy()) < 5e-3


def test_engine_tokens_equal_the_jax_engines(pair4):
    """Five requests over two slots: each slot serves several requests
    after its reset, slot 1 idles (a free slot stepping) while slot 0
    finishes a long one, and a shrunk pool preempts; the greedy tokens
    equal JAX's engine's token for token, and the steps too."""
    jm, params, tm, _ = pair4
    kw = dict(max_batch=2, max_len=48, block_tokens=4, cache_dtype="float32")
    jeng = JaxEngine(jm, params, JaxServingConfig(**kw))
    teng = ServingEngine(tm, ServingConfig(**kw), device="cpu")
    assert teng.pool.block_bytes == jeng.pool.block_bytes
    rng = np.random.default_rng(15)
    prompts = [rng.integers(0, tm.cfg.vocab_size, n) for n in (9, 3, 14, 6,
                                                              11)]
    news = [8, 3, 20, 5, 7]
    jr = [jeng.submit(p, n) for p, n in zip(prompts, news)]
    tr = [teng.submit(p, n) for p, n in zip(prompts, news)]
    for eng in (jeng, teng):
        for _ in range(14):
            eng.step()
        eng.pool.set_capacity(eng.pool.block_bytes * 3)
        for _ in range(3):
            eng.step()
        eng.pool.set_capacity(eng.pool.block_bytes * eng.pool.total_blocks)
    jf, tf = jeng.run_until_drained(3000), teng.run_until_drained(3000)
    assert teng.stats()["preemptions"] >= 1 and teng.stats()["logits_finite"]
    assert jeng.steps == teng.steps
    assert [jf[r].output for r in jr] == [tf[r].output for r in tr]
    assert [len(tf[r].output) for r in tr] == news


def test_reset_restores_the_starting_state(pair):
    """A slot's reset puts every m back at -1e30 and every other leaf at
    0, and leaves the other slots alone; admission resets, so mixed
    progress equals isolated serving."""
    tm = pair[2]
    state = D.init_state(tm, 2, 8)
    for leaves in state.recurrent.values():
        for leaf in leaves.values():
            leaf.fill_(0.5)
    state.reset_slot(1)
    for leaves in state.recurrent.values():
        for name, leaf in leaves.items():
            assert bool((leaf[:, 1] == (-1e30 if name == "m" else 0.0)).all())
            assert bool((leaf[:, 0] == 0.5).all())
    rng = np.random.default_rng(16)
    prompts = [rng.integers(0, tm.cfg.vocab_size, n) for n in (5, 9, 3)]

    def run(prompt_list):
        eng = ServingEngine(tm, ServingConfig(
            max_batch=3, max_len=64, block_tokens=8), device="cpu")
        rids = [eng.submit(p, 6) for p in prompt_list]
        fin = eng.run_until_drained(max_steps=2000)
        return [fin[r].output for r in rids]

    assert run(prompts) == [run([p])[0] for p in prompts]


# ---- converter, optimizer, trainer ------------------------------------------

def test_converter_refuses_a_misshapen_pair(pair):
    cfg, tree = pair[2].cfg, pair[3]
    bad = jax.tree.map(np.copy, tree)
    bad["layers"]["1_slstm"]["block"]["r_gates"] = \
        bad["layers"]["1_slstm"]["block"]["r_gates"][..., :8]
    with pytest.raises(ValueError, match="layers.0.1_slstm.block.r_gates"):
        model_params_from_numpy(bad, cfg, device="cpu")
    bad = jax.tree.map(np.copy, tree)
    del bad["layers"]["0_mlstm"]["block"]["b_if"]
    with pytest.raises(ValueError, match="missing.*0_mlstm.block.b_if"):
        model_params_from_numpy(bad, cfg, device="cpu")
    bad = jax.tree.map(np.copy, tree)
    bad["layers"]["2_mlstm"] = bad["layers"].pop("0_mlstm")
    with pytest.raises(ValueError, match="stacks pairs"):
        model_params_from_numpy(bad, cfg, device="cpu")
    bad = jax.tree.map(np.copy, tree)
    bad["layers"] = jax.tree.map(lambda a: np.concatenate([a, a]),
                                 bad["layers"])
    with pytest.raises(ValueError, match="stacks 2 layers"):
        model_params_from_numpy(bad, cfg, device="cpu")


def test_parameters_decay_as_jax_decays_them(pair4):
    """JAX's ``ndim >= 2`` over its stacked arrays: every leaf of the
    pairs (norms, ``out_norm``, ``b_if``, ``b_gates`` included) decays,
    ``final_norm`` does not."""
    _, params, tm, _ = pair4
    want = _port_arrays(jax.tree.map(lambda a: np.full(a.shape, a.ndim >= 2),
                                     params), tm.cfg)
    for name, p in tm.named_parameters():
        assert decays(name, p) == bool(want[name].all()), name
    assert not decays("final_norm", tm.final_norm)
    assert decays("layers.1.0_mlstm.block.b_if", tm.layers[1]["0_mlstm"]
                  .block.b_if)


def test_train_state_carries_jax_moments_over(pair4):
    _, params, tm, _ = pair4
    state = jax_adamw_init(params)
    state = state._replace(
        mu=jax.tree.map(lambda p: p * 0.5, params),
        nu=jax.tree.map(lambda p: p * p, params),
        step=jnp.asarray(5, jnp.int32))
    got = train_state_from_numpy(jax.tree.map(np.asarray, state), tm)
    mu = _port_arrays(jax.tree.map(np.asarray, state.mu), tm.cfg)
    nu = _port_arrays(jax.tree.map(np.asarray, state.nu), tm.cfg)
    assert int(got.step) == 5
    assert sorted(got.mu) == sorted(mu) == sorted(
        n for n, _ in tm.named_parameters())
    for name in mu:
        np.testing.assert_array_equal(got.mu[name].numpy(), mu[name])
        np.testing.assert_array_equal(got.nu[name].numpy(), nu[name])


@pytest.mark.parametrize("microbatches", [1, 2])
def test_trainer_losses_match_jax(tmp_path, microbatches):
    """8 steps from JAX's init on ``tests/test_trainer.py``'s setup: each
    logged loss within ``LOSS_TOL`` of JAX's, and falling."""
    corpus = str(tmp_path / "corpus")
    write_corpus(corpus, n_shards=8, tokens_per_shard=4096, vocab_size=503)
    cfg_j, cfg_t = jax_config(ARCH), get_config(ARCH)
    params = JaxModel(cfg_j).init(jax.random.key(0))
    steps = 8
    step_kw = dict(microbatches=microbatches, warmup_steps=2,
                   total_steps=steps)
    trainer_kw = dict(steps=steps, checkpoint_every=4, log_every=1)
    pipe_kw = dict(batch_size=4, seq_len=32, cache_bytes=1 << 20,
                   prefetch_depth=0, dynims=False)
    pipe = JaxPipeline(JaxStore(corpus), JaxPipelineConfig(**pipe_kw))
    jt = JaxTrainer(JaxModel(cfg_j, remat="full"), pipe,
                    JaxStepConfig(**step_kw), JaxTrainerConfig(
                        checkpoint_dir=str(tmp_path / "jax"), **trainer_kw))
    jt.fit(params)
    pipe.close()
    want = {int(r["step"]): r["loss"] for r in jt.metrics_log}

    model = model_params_from_numpy(jax.tree.map(np.asarray, params), cfg_t,
                                    device="cpu")
    pipe = DataPipeline(ShardStore(corpus), PipelineConfig(**pipe_kw))
    tr = Trainer(model, pipe, TrainStepConfig(**step_kw), TrainerConfig(
        checkpoint_dir=str(tmp_path / "port"), **trainer_kw), device="cpu")
    tr.fit()
    pipe.close()
    got = {int(r["step"]): r["loss"] for r in tr.metrics_log}
    assert sorted(got) == sorted(want) == list(range(steps))
    for step in range(steps):
        assert abs(got[step] - want[step]) <= LOSS_TOL, step
    assert got[steps - 1] < got[0]


# ---- configs and launchers --------------------------------------------------

def test_serve_cli_serves_xlstm_on_the_cpu(capsys):
    report = serve.main(["--arch", ARCH, "--device", "cpu", "--requests",
                         "5", "--prompt-len", "40", "--max-new", "6",
                         "--max-batch", "3", "--max-len", "64", "--burst"])
    stats = report["engine"].stats()
    assert len(report["finished"]) == 5 and report["tokens"] == 30
    assert stats["preemptions"] >= 1 and stats["logits_finite"]
    assert "tok/s" in capsys.readouterr().out
    assert serve.WORKLOADS["xlstm-125m"] == dict(serve.FULL_WIDTH,
                                                 arch="xlstm-125m")


def test_profile_serve_takes_the_xlstm_workload(monkeypatch):
    """``profile_serve xlstm-125m`` builds the full-width workload (the
    card; here `build_engine` is intercepted before it touches a device)."""
    seen = []

    def build(**w):
        seen.append(w)
        raise RuntimeError("stop")

    monkeypatch.setattr(profile_serve, "build_engine", build)
    with pytest.raises(RuntimeError, match="stop"):
        profile_serve.main(["xlstm-125m"])
    assert seen == [serve.FULL_WIDTH_XLSTM]
