"""The port's hybrid family (hymba-1.5b) against the JAX package's, on the CPU.

* Kernel B4's plain version (``ssm_scan_plain``) against the JAX oracle
  ``ssm_scan_ref`` on the cases of ``tests/test_kernels.py``, in float32
  and with bfloat16 inputs, at that file's tolerance (1e-5).  The Pallas
  kernel does not build on this JAX (ROADMAP C1), so the oracle stands
  in.
* The Mamba branch: ``mamba_apply`` against JAX's at the bound of
  ``tests/test_models.py::test_mamba_chunked_matches_sequential`` (atol
  2e-4, rtol 2e-3: JAX's scan is associative, the port's sequential),
  and 24 ``mamba_decode_step``s to 1e-4 relative.
* hymba-1.5b-smoke with the JAX parameters carried across by
  ``model_params_from_numpy``: ``Model.forward`` against JAX
  ``Model(attn_impl="dense")`` and 24 decode steps past the window of 16
  against JAX ``decode_step``, both to 1e-4 relative on the logits;
  decode against forward within 5e-3; the engine's greedy tokens against
  the JAX engine's through a preemption, and with a free slot ticking
  past ``max_len + window`` (ROADMAP C7); a 5-layer reduction with a
  tail layer for the converter's group, glob and tail mapping.
* The config copies, the B4 wrapper's checks and its dispatch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels.ssm_scan.ref import ssm_scan_ref
from repro.models import Model as JaxModel
from repro.models import decode as JD
from repro.models import ssm as jssm
from repro.models.params import Axes, init_params
from repro.serving import ServingConfig as JaxServingConfig
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.kernels import ssm_scan as ks
from repro_torch.launch import profile_serve, serve
from repro_torch.models import Model, decode as D
from repro_torch.models import ssm as tssm
from repro_torch.models.transformer import layer_windows
from repro_torch.serving import ServingConfig, ServingEngine

# One intra-op thread: the suite's workers share the cores, and torch's
# OpenMP threads, oversubscribed, spin-wait ~100x longer than the ops.
torch.set_num_threads(1)

ARCH = "hymba-1.5b-smoke"

# (b, s, c, n) of tests/test_kernels.py's SSM_CASES, then its chunk-carry
# case (constant decay and drive from h0 = 1)
SSM_CASES = [(2, 256, 128, 16), (1, 128, 256, 8), (3, 64, 128, 4)]
CARRY = (1, 128, 128, 8)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _to_torch(x):
    """A JAX array's values as a torch tensor of the same type."""
    t = torch.from_numpy(np.array(x, np.float32))
    return t.bfloat16() if x.dtype == jnp.bfloat16 else t


@pytest.mark.parametrize("case", SSM_CASES + [CARRY], ids=str)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_scan_matches_ref(case, dtype):
    b, s, c, n = case
    jdt, tdt = DTYPES[dtype]
    if case == CARRY:
        decay = jnp.full((b, s, c, n), 0.99, jdt)
        drive = jnp.full((b, s, c, n), 0.01, jdt)
        h0 = jnp.ones((b, c, n), jnp.float32)
    else:
        rng = np.random.default_rng(0)
        decay = jnp.asarray(rng.uniform(0.3, 1.0, (b, s, c, n)), jdt)
        drive = jnp.asarray(rng.normal(0, 0.2, (b, s, c, n)), jdt)
        h0 = jnp.asarray(rng.normal(0, 1.0, (b, c, n)), jnp.float32)
    before = ks.LAUNCHES
    out = ks.ssm_scan(_to_torch(decay), _to_torch(drive), _to_torch(h0))
    assert ks.LAUNCHES == before
    assert out.dtype == torch.float32 and out.shape == (b, s, c, n)
    ref = ssm_scan_ref(decay, drive, h0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_plain_scan_carries_h0_across_calls():
    """Two calls, the first's last h as the second's h0, equal one call."""
    g = torch.Generator().manual_seed(1)
    decay = torch.rand((2, 40, 8, 4), generator=g)
    drive = torch.randn((2, 40, 8, 4), generator=g)
    h0 = torch.randn((2, 8, 4), generator=g)
    whole = ks.ssm_scan(decay, drive, h0)
    first = ks.ssm_scan(decay[:, :25], drive[:, :25], h0)
    second = ks.ssm_scan(decay[:, 25:], drive[:, 25:], first[:, -1])
    assert torch.equal(torch.cat([first, second], dim=1), whole)


# ---- the Mamba branch --------------------------------------------------------

@pytest.fixture(scope="module")
def mamba_pair():
    """JAX Mamba parameters and the port's Mamba holding their values."""
    cfg = jax_config(ARCH)
    sch = jssm.mamba_schema(cfg, Axes(fsdp=None, tp=None, batch=(None,)))
    params = init_params(sch, jax.random.key(0), jnp.float32)
    # a_log and dt_bias start constant; spread them so every channel differs
    rng = np.random.default_rng(2)
    params["a_log"] = jnp.asarray(rng.normal(0, 0.5, params["a_log"].shape),
                                  jnp.float32)
    params["dt_bias"] = jnp.asarray(
        rng.normal(-1, 0.5, params["dt_bias"].shape), jnp.float32)
    port = tssm.Mamba(get_config(ARCH), lambda shape, kind: torch.nn.Parameter(
        torch.empty(shape), requires_grad=False))
    with torch.no_grad():
        for name, p in port.named_parameters():
            p.copy_(torch.from_numpy(np.array(params[name])))
    return cfg, params, port


def test_mamba_apply_matches_jax(mamba_pair):
    cfg, params, port = mamba_pair
    x = np.random.default_rng(3).normal(0, 1, (2, 24, cfg.d_model)).astype(
        np.float32)
    ref = jssm.mamba_apply(params, jnp.asarray(x), cfg, chunk=8)
    before = ks.LAUNCHES
    out = tssm.mamba_apply(port, torch.from_numpy(x), get_config(ARCH))
    assert ks.LAUNCHES == before
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4,
                               rtol=2e-3)


def test_mamba_decode_steps_match_jax(mamba_pair):
    cfg, params, port = mamba_pair
    x = np.random.default_rng(4).normal(0, 1, (3, 24, cfg.d_model)).astype(
        np.float32)
    hshape, cshape = jssm.mamba_state_shape(cfg, 3)
    assert tssm.mamba_state_shape(get_config(ARCH), 3) == (hshape, cshape)
    jh, jc = jnp.zeros(hshape), jnp.zeros(cshape)
    th, tc = torch.zeros(hshape), torch.zeros(cshape)
    for t in range(24):
        ref, jh, jc = jssm.mamba_decode_step(params, jnp.asarray(x[:, t:t + 1]),
                                             jh, jc, cfg)
        out, th, tc = tssm.mamba_decode_step(
            port, torch.from_numpy(x[:, t:t + 1]), th, tc, get_config(ARCH))
        assert _rel(out.numpy(), ref) <= 1e-4, t
        assert _rel(th.numpy(), jh) <= 1e-4, t
        assert _rel(tc.numpy(), jc) <= 1e-4, t


# ---- hymba-1.5b-smoke --------------------------------------------------------

def _models(change=None, seed=1):
    jcfg = dataclasses.replace(jax_config(ARCH), **(change or {}))
    tcfg = dataclasses.replace(get_config(ARCH), **(change or {}))
    jm = JaxModel(jcfg, remat="none", attn_impl="dense")
    params = jm.init(jax.random.key(seed))
    tree = jax.tree.map(np.asarray, params)
    return jm, params, model_params_from_numpy(tree, tcfg, device="cpu")


@pytest.fixture(scope="module")
def pair():
    return _models()


def test_forward_matches_jax(pair):
    jm, params, tm = pair
    assert tm.windows == [16, 0, 16, 0] and tm.unembed is not None
    tokens = np.random.default_rng(5).integers(
        0, tm.cfg.vocab_size, (2, 40)).astype(np.int32)
    ref, _ = jm.forward(params, {"tokens": jnp.asarray(tokens)})
    before = ks.LAUNCHES
    out = tm(torch.from_numpy(tokens))
    assert ks.LAUNCHES == before
    assert out.shape == (2, 40, tm.cfg.padded_vocab)
    assert _rel(out.numpy(), ref) <= 1e-4


def test_decode_steps_past_the_window_match_jax(pair):
    jm, params, tm = pair
    b, steps = 3, 24                       # past the window of 16
    tokens = np.random.default_rng(6).integers(
        0, tm.cfg.vocab_size, (b, steps)).astype(np.int32)
    js = JD.init_state(jm, b, 32, cache_dtype="float32")
    ts = D.init_state(tm, b, 32, cache_dtype="float32")
    step = jax.jit(lambda p, s, tok: JD.decode_step(jm, p, s, tok))
    for t in range(steps):
        ref, js = step(params, js, jnp.asarray(tokens[:, t:t + 1]))
        out = D.decode_step(tm, ts, torch.from_numpy(tokens[:, t:t + 1]))
        assert _rel(out.numpy(), ref) <= 1e-4, t
    glob = js["layers"]["groups"]["glob"]["mamba"]
    assert _rel(ts.mamba_h[1].numpy(), glob["h"][0]) <= 1e-4
    assert _rel(ts.mamba_conv[3].numpy(), glob["conv"][1]) <= 1e-4
    np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js["pos"]))


def test_decode_reproduces_forward(pair):
    _, _, tm = pair
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, tm.cfg.vocab_size, (2, 30)))
    fwd = tm(tokens)
    logits, state = D.prefill(tm, tokens, 32, cache_dtype="float32")
    state = D.init_state(tm, 2, 32, cache_dtype="float32")
    dec = torch.cat([D.decode_step(tm, state, tokens[:, t:t + 1])
                     for t in range(30)], dim=1)
    assert _rel(dec.numpy(), fwd.numpy()) < 5e-3
    assert torch.equal(logits, dec[:, -1:])


def test_converter_maps_groups_glob_and_tail():
    """n_layers 5, global_every 2: two groups of (local, global) and one
    local tail layer, each carried to its place in the flat stack."""
    jm, params, tm = _models({"n_layers": 5}, seed=2)
    assert layer_windows(tm.cfg) == [16, 0, 16, 0, 16]
    stack = params["layers"]
    assert sorted(stack) == ["groups", "tail"]
    want = {0: stack["groups"]["locals"]["mamba"]["a_log"][0, 0],
            1: stack["groups"]["glob"]["mamba"]["a_log"][0],
            2: stack["groups"]["locals"]["mamba"]["a_log"][1, 0],
            3: stack["groups"]["glob"]["mamba"]["a_log"][1],
            4: stack["tail"]["mamba"]["a_log"][0]}
    for i, arr in want.items():
        np.testing.assert_array_equal(tm.layers[i].mamba.a_log.numpy(),
                                      np.asarray(arr))
    np.testing.assert_array_equal(tm.unembed.numpy(),
                                  np.asarray(params["embed"]["unembed"]))
    tokens = np.random.default_rng(8).integers(
        0, tm.cfg.vocab_size, (1, 24)).astype(np.int32)
    ref, _ = jm.forward(params, {"tokens": jnp.asarray(tokens)})
    assert _rel(tm(torch.from_numpy(tokens)).numpy(), ref) <= 1e-4


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "flat"])
def test_convert_rejects_a_mismatched_tree(pair, fault):
    _, params, _ = pair
    tree = jax.tree.map(np.asarray, params)
    glob = tree["layers"]["groups"]["glob"]
    if fault == "missing":
        del glob["mamba"]["d_skip"]
    elif fault == "extra":
        glob["mamba"]["bias"] = glob["mamba"]["d_skip"]
    elif fault == "shape":
        glob["mamba"]["x_dbc"] = glob["mamba"]["x_dbc"][:, :, :5]
    else:
        tree["layers"] = {"flat": glob}
    with pytest.raises(ValueError, match={
            "missing": "missing", "extra": "does not carry",
            "shape": "shape", "flat": "grouped"}[fault]):
        model_params_from_numpy(tree, get_config(ARCH), device="cpu")


def _same_tokens(tm, pairs):
    """Equal greedy tokens wherever the choice is not a near tie: at the
    first difference, if any, the port's top-two margin must be <= 1e-3."""
    for jreq, treq in pairs:
        if jreq.output == treq.output:
            continue
        i = next(i for i, (a, b) in enumerate(zip(jreq.output, treq.output))
                 if a != b)
        ctx = np.concatenate([treq.prompt, treq.output[:i]])
        top = torch.topk(tm(torch.as_tensor(ctx[None]))[0, -1], 2).values
        assert float(top[0] - top[1]) <= 1e-3, (jreq.output, treq.output)


def test_engine_tokens_equal_the_jax_engines_through_a_preemption(pair):
    jm, params, tm = pair
    kw = dict(max_batch=3, max_len=48, block_tokens=4, cache_dtype="float32")
    jeng = JaxEngine(jm, params, JaxServingConfig(**kw))
    teng = ServingEngine(tm, ServingConfig(**kw), device="cpu")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, tm.cfg.vocab_size, n) for n in (9, 14, 6, 11)]
    jr = [jeng.submit(p, 8) for p in prompts]
    tr = [teng.submit(p, 8) for p in prompts]
    for eng in (jeng, teng):
        for _ in range(12):
            eng.step()
        eng.pool.set_capacity(eng.pool.block_bytes * 5)
        for _ in range(3):
            eng.step()
        eng.pool.set_capacity(eng.pool.block_bytes * eng.pool.total_blocks)
    jf, tf = jeng.run_until_drained(2000), teng.run_until_drained(2000)
    assert teng.stats()["preemptions"] >= 1 and teng.stats()["logits_finite"]
    assert jeng.steps == teng.steps
    _same_tokens(tm, [(jf[a], tf[b]) for a, b in zip(jr, tr)])
    assert all(len(tf[b].output) == 8 for b in tr)


def test_admission_resets_the_recurrent_state(pair):
    """A slot's Mamba state starts from zero for every request it serves,
    so mixed progress equals isolated serving."""
    tm = pair[2]
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, tm.cfg.vocab_size, n) for n in (5, 9, 3)]

    def run(prompt_list):
        eng = ServingEngine(tm, ServingConfig(
            max_batch=3, max_len=64, block_tokens=8, cache_dtype="float32"),
            device="cpu")
        rids = [eng.submit(p, 6) for p in prompt_list]
        fin = eng.run_until_drained(max_steps=2000)
        return [fin[r].output for r in rids]

    assert run(prompts) == [run([p])[0] for p in prompts]
    state = D.init_state(tm, 2, 8)
    state.mamba_h.fill_(1.0)
    state.mamba_conv.fill_(1.0)
    state.pos.fill_(5)
    state.reset_slot(1)
    assert state.pos.tolist() == [5, 0]
    assert float(state.mamba_h[:, 1].abs().sum()) == 0.0
    assert float(state.mamba_conv[:, 1].abs().sum()) == 0.0
    assert bool((state.mamba_h[:, 0] == 1.0).all())


def test_free_slot_past_max_len_plus_window(pair):
    """ROADMAP C7 under a window: with max_len 16 and window 16, slot 1
    stays free while its position runs past max_len + window, where JAX's
    mask admits no key and the port attends the cache's last 16.  Only
    that slot's discarded output differs: the served tokens equal the JAX
    engine's and every logit stays finite."""
    jm, params, tm = pair
    assert tm.cfg.sliding_window == 16
    kw = dict(max_batch=2, max_len=16, block_tokens=4, cache_dtype="float32")
    jeng = JaxEngine(jm, params, JaxServingConfig(**kw))
    teng = ServingEngine(tm, ServingConfig(**kw), device="cpu")
    rng = np.random.default_rng(11)
    pairs = []
    for _ in range(5):
        p = rng.integers(0, tm.cfg.vocab_size, 5)
        a, b = jeng.submit(p, 6), teng.submit(p, 6)
        jeng.run_until_drained(1000)
        teng.run_until_drained(1000)
        pairs.append((jeng.finished[a], teng.finished[b]))
    assert int(teng.state.pos[1]) > 16 + 16
    assert int(teng.state.pos[1]) == int(np.asarray(jeng.state["pos"])[1])
    _same_tokens(tm, pairs)
    assert all(len(t.output) == 6 for _, t in pairs)
    assert teng.stats()["logits_finite"]


# ---- configs, launchers, the B4 wrapper ----------------------------------------

@pytest.mark.parametrize("arch", ["hymba-1.5b", "hymba-1.5b-smoke"])
def test_config_copies_equal_the_jax_configs(arch):
    port, ref = get_config(arch), jax_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.padded_vocab == ref.padded_vocab
    assert port.n_params() == ref.n_params()


def test_full_width_schedule_and_smoke_reduction():
    assert layer_windows(get_config("hymba-1.5b")) == \
        [0 if i in (15, 31) else 1024 for i in range(32)]
    smoke = get_config(ARCH)
    assert (smoke.n_layers, smoke.global_every, smoke.sliding_window,
            smoke.d_model, smoke.n_heads, smoke.n_kv_heads, smoke.head_dim,
            smoke.ssm_state, smoke.ssm_expand * smoke.d_model) == \
        (4, 2, 16, 64, 4, 4, 16, 8, 128)
    assert layer_windows(get_config("llama3.2-1b")) == [0] * 16


def test_serve_cli_serves_hymba_on_the_cpu(capsys):
    report = serve.main(["--arch", ARCH, "--device", "cpu", "--requests",
                         "5", "--prompt-len", "40", "--max-new", "6",
                         "--max-batch", "3", "--max-len", "64", "--burst"])
    stats = report["engine"].stats()
    assert len(report["finished"]) == 5 and report["tokens"] == 30
    assert stats["preemptions"] >= 1 and stats["logits_finite"]
    assert "tok/s" in capsys.readouterr().out
    assert serve.WORKLOADS["hymba-1.5b"] == dict(serve.FULL_WIDTH,
                                                 arch="hymba-1.5b")


def test_profile_serve_takes_either_workload(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["hymba-1.5b"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            profile_serve.main(argv)
    with pytest.raises(SystemExit):      # no full-width workload of its own
        profile_serve.main(["dbrx-132b"])


@pytest.mark.parametrize("bad", ["rank", "shapes", "h0_shape", "float16",
                                 "mixed", "h0_type"])
def test_scan_wrapper_rejects_what_the_kernel_cannot_take(bad):
    decay = torch.zeros((2, 5, 3, 4))
    drive = torch.zeros((2, 5, 3, 4))
    h0 = torch.zeros((2, 3, 4))
    if bad == "rank":
        decay = drive = torch.zeros((2, 5, 12))
    elif bad == "shapes":
        drive = torch.zeros((2, 6, 3, 4))
    elif bad == "h0_shape":
        h0 = torch.zeros((2, 4, 3))
    elif bad == "float16":
        decay, drive = decay.half(), drive.half()
    elif bad == "mixed":
        drive = drive.bfloat16()
    else:
        h0 = h0.double()
    before = ks.LAUNCHES
    with pytest.raises(ValueError):
        ks._launch(decay, drive, h0)
    assert ks.LAUNCHES == before


class _OnCuda:
    """Stands in for a CUDA tensor: dispatch reads only ``.device``."""

    device = torch.device("cuda", 0)


def test_cuda_tensors_launch_the_scan_kernel_and_never_the_plain_version(
        monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(ks, "ssm_scan_plain", refuse)
    monkeypatch.setattr(ks, "_launch", lambda *a, **k: "kernel")
    assert ks.ssm_scan(_OnCuda(), None, None) == "kernel"
    with pytest.raises(ValueError, match="cpu or cuda"):
        ks.ssm_scan(torch.empty((1, 1, 1, 1), device="meta"), None, None)


def test_cpu_tensors_never_launch_the_scan_kernel():
    before = ks.LAUNCHES
    m = Model(get_config(ARCH), device="cpu")
    m(torch.zeros((1, 7), dtype=torch.long))
    state = D.init_state(m, 2, 8)
    D.decode_step(m, state, torch.zeros((2, 1), dtype=torch.long))
    assert ks.LAUNCHES == before
