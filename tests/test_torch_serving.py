"""The port's serving engine against the JAX package's, on the CPU.

The five engine tests of ``tests/test_serving.py`` run on the port, plus
more: the port's and JAX's engines give the same greedy tokens on the
same prompts and parameters (float32 cache), and a slot left free while
its position ticks past ``max_len`` breaks nothing (the cache write
clamps to ``S - 1`` and the kernel length to ``S``, as JAX's clamped
update and mask do).  The KV pool copy is held to the JAX pool on one
sequence of grants, touches and shrinks.  With a live plane on each
(``tests/test_plane.py``'s idle-engine tick too), both engines under
the same simulated memory pressure give the same tokens, preemptions,
pool capacity after every step and plane actions.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.core as J
from repro.configs import get_config as jax_config
from repro.configs.dynims import hbm_pool_params as jax_hbm_pool_params
from repro.core.store import KVBlockPool as JaxPool
from repro.models import Model as JaxModel
from repro.serving import ServingConfig as JaxServingConfig
from repro.serving import ServingEngine as JaxEngine
import repro_torch.core as T
import repro_torch.serving.engine as E
from repro_torch.configs import get_config
from repro_torch.configs.dynims import hbm_pool_params
from repro_torch.convert import model_params_from_numpy
from repro_torch.core.store import KVBlockPool
from repro_torch.launch import profile_serve, serve
from repro_torch.serving import ServingConfig, ServingEngine

# One intra-op thread: the suite's workers share the cores, and torch's
# OpenMP threads, oversubscribed, spin-wait ~100x longer than the ops.
torch.set_num_threads(1)

ARCH = "llama3.2-1b-smoke"


@pytest.fixture(scope="module")
def models():
    """JAX model + params, and the port's model on the same numbers."""
    cfg = jax_config(ARCH)
    jm = JaxModel(cfg, remat="none", attn_impl="dense")
    params = jm.init(jax.random.key(0))
    tm = model_params_from_numpy(jax.tree.map(np.asarray, params),
                                 get_config(ARCH), device="cpu")
    return jm, params, tm


def make_engine(model, **kw):
    sc = ServingConfig(max_batch=kw.pop("max_batch", 3),
                       max_len=kw.pop("max_len", 64),
                       block_tokens=kw.pop("block_tokens", 8), **kw)
    return ServingEngine(model, sc, device="cpu")


def test_engine_drains_all_requests(models):
    tm = models[2]
    eng = make_engine(tm)
    rng = np.random.default_rng(0)
    rids = [eng.submit(rng.integers(0, tm.cfg.vocab_size, 7), 5)
            for _ in range(7)]
    fin = eng.run_until_drained(max_steps=2000)
    assert sorted(fin) == sorted(rids)
    assert all(len(r.output) == 5 for r in fin.values())
    st = eng.stats()
    assert st["logits_finite"] and st["decode_steps"] <= st["steps"]


def test_mixed_progress_equals_isolated(models):
    tm = models[2]
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, tm.cfg.vocab_size, n) for n in (5, 9, 3)]

    def run(prompt_list):
        eng = make_engine(tm, cache_dtype="float32")
        rids = [eng.submit(p, 6) for p in prompt_list]
        fin = eng.run_until_drained(max_steps=2000)
        return [fin[r].output for r in rids]

    assert run(prompts) == [run([p])[0] for p in prompts]


def test_preemption_requeues_and_finishes(models):
    tm = models[2]
    eng = make_engine(tm)
    rng = np.random.default_rng(2)
    for _ in range(6):
        eng.submit(rng.integers(0, tm.cfg.vocab_size, 12), 10)
    for _ in range(8):
        eng.step()
    eng.pool.set_capacity(eng.pool.block_bytes * 3)
    for _ in range(4):
        eng.step()
    eng.pool.set_capacity(eng.pool.block_bytes * eng.pool.total_blocks)
    fin = eng.run_until_drained(max_steps=5000)
    assert len(fin) == 6
    assert eng.stats()["preemptions"] >= 1
    assert all(len(r.output) == 10 for r in fin.values())


def test_preempted_output_preserved(models):
    tm = models[2]
    eng = make_engine(tm, max_batch=1, block_tokens=4,
                      cache_dtype="float32")
    prompt = np.random.default_rng(3).integers(0, tm.cfg.vocab_size, 6)
    rid = eng.submit(prompt, 8)
    for _ in range(9):
        eng.step()
    tokens_before = list(eng.slots[0].request.output)
    assert tokens_before
    eng.pool.set_capacity(0)                     # hard burst
    eng.step()
    assert eng.queue and eng.queue[0].rid == rid
    eng.pool.set_capacity(eng.pool.block_bytes * eng.pool.total_blocks)
    fin = eng.run_until_drained(max_steps=4000)
    assert fin[rid].output[:len(tokens_before)] == tokens_before
    assert len(fin[rid].output) == 8
    assert fin[rid].preemptions >= 1


def test_admission_respects_pool_budget(models):
    tm = models[2]
    eng = make_engine(tm)
    eng.pool.set_capacity(eng.pool.block_bytes * 2)   # room for 1 request
    rng = np.random.default_rng(4)
    for _ in range(3):
        eng.submit(rng.integers(0, tm.cfg.vocab_size, 8), 4)
    eng.step()
    assert sum(not s.free for s in eng.slots) == 1
    assert len(eng.queue) == 2


def _greedy_margin(tm, tokens):
    """Top-two logit gap after ``tokens`` under the port's forward."""
    logits = tm(torch.as_tensor(np.asarray(tokens)[None]))[0, -1]
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


def _serve_both(models, prompts, max_new, **kw):
    jm, params, tm = models
    jeng = JaxEngine(jm, params, JaxServingConfig(cache_dtype="float32",
                                                  **kw))
    teng = ServingEngine(tm, ServingConfig(cache_dtype="float32", **kw),
                         device="cpu")
    jr = [jeng.submit(p, max_new) for p in prompts]
    tr = [teng.submit(p, max_new) for p in prompts]
    jf, tf = jeng.run_until_drained(4000), teng.run_until_drained(4000)
    return jeng, teng, [(jf[a], tf[b]) for a, b in zip(jr, tr)]


def _assert_same_tokens(tm, pairs):
    """Equal greedy tokens wherever the choice is not a near tie: at the
    first difference, if any, the port's top-two margin must be <= 1e-3."""
    for jreq, treq in pairs:
        if jreq.output == treq.output:
            continue
        i = next(i for i, (a, b) in enumerate(zip(jreq.output, treq.output))
                 if a != b)
        ctx = np.concatenate([treq.prompt, treq.output[:i]])
        assert _greedy_margin(tm, ctx) <= 1e-3, (jreq.output, treq.output)


def test_same_greedy_tokens_as_the_jax_engine(models):
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, models[2].cfg.vocab_size, n)
               for n in (4, 11, 6, 9, 3)]
    jeng, teng, pairs = _serve_both(models, prompts, 7, max_batch=3,
                                    max_len=64, block_tokens=8)
    _assert_same_tokens(models[2], pairs)
    assert jeng.steps == teng.steps


def test_free_slot_ticking_past_max_len_is_clamped(models):
    """One request at a time through two slots: slot 1 stays free, its
    position runs past ``max_len`` and its writes land on ``S - 1``."""
    jm, params, tm = models
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, tm.cfg.vocab_size, 5) for _ in range(4)]
    max_len = 16
    out_j, out_t = [], []
    jeng = JaxEngine(jm, params, JaxServingConfig(
        max_batch=2, max_len=max_len, block_tokens=4,
        cache_dtype="float32"))
    teng = ServingEngine(tm, ServingConfig(max_batch=2, max_len=max_len,
                                           block_tokens=4,
                                           cache_dtype="float32"),
                         device="cpu")
    for p in prompts:
        out_j.append(jeng.submit(p, 6))
        out_t.append(teng.submit(p, 6))
        jeng.run_until_drained(1000)
        teng.run_until_drained(1000)
    assert int(teng.state.pos[1]) > max_len
    assert int(teng.state.pos[1]) == int(np.asarray(jeng.state["pos"])[1])
    pairs = [(jeng.finished[a], teng.finished[b])
             for a, b in zip(out_j, out_t)]
    _assert_same_tokens(tm, pairs)
    assert all(len(t.output) == 6 for _, t in pairs)
    assert teng.stats()["logits_finite"]


def test_pool_copy_matches_the_jax_pool():
    rng = np.random.default_rng(9)
    jp, tp = JaxPool("kv", 24, 1024.0), KVBlockPool("kv", 24, 1024.0)
    for step in range(300):
        op = rng.integers(0, 10)
        seq = int(rng.integers(0, 6))
        if op < 6:
            a, b = jp.alloc_block(seq), tp.alloc_block(seq)
        elif op < 8:
            jp.touch(seq), tp.touch(seq)
            a = b = None
        elif op < 9:
            a, b = jp.free_seq(seq), tp.free_seq(seq)
        else:
            cap = float(rng.integers(0, 25)) * 1024.0
            a = jp.set_capacity(cap).evicted_keys
            b = tp.set_capacity(cap).evicted_keys
        assert a == b, step
        assert jp.num_free_blocks() == tp.num_free_blocks()
        assert jp.used() == tp.used() and jp.capacity() == tp.capacity()
        assert jp.drain_preempted() == tp.drain_preempted()
        assert sorted(jp.live_sequences()) == sorted(tp.live_sequences())


def test_serve_cli_on_the_cpu(capsys):
    report = serve.main(["--device", "cpu", "--requests", "5",
                         "--prompt-len", "40", "--max-new", "6",
                         "--max-batch", "3", "--max-len", "64",
                         "--burst"])
    stats = report["engine"].stats()
    assert len(report["finished"]) == 5 and report["tokens"] == 30
    assert stats["preemptions"] >= 1 and stats["logits_finite"]
    # no hand restore: the plane re-grants the pool on the next tick
    assert report["after_shrink"][0] == report["full"]
    health = report["engine"].plane.health()
    assert health.ticks == stats["steps"] and health.healthy
    assert "tok/s" in capsys.readouterr().out


def test_profile_counts_each_kernel_once():
    """Operator rows carry their kernels' device time; only kernel and
    copy rows add to the device's busy time."""
    class Row:
        def __init__(self, key, us):
            self.key, self.self_device_time_total = key, us

    rows = [Row("aten::mm", 30.0), Row("gemv_kernel", 30.0),
            Row("Memcpy HtoD (Pageable -> Device)", 2.0),
            Row("cudaLaunchKernel", 0.0)]
    kept = [r.key for r in rows if profile_serve.on_device(r)]
    assert kept == ["gemv_kernel", "Memcpy HtoD (Pageable -> Device)"]


def test_idle_engine_still_ticks_plane():
    """A fully idle (e.g. fully preempted) engine must keep ticking its
    plane or a reclaimed pool can never be re-granted."""
    class _Plane:
        ticks = 0

        def tick(self):
            self.ticks += 1
            return []

    eng = E.ServingEngine.__new__(E.ServingEngine)
    eng.steps = 0
    eng.plane = _Plane()
    eng.queue = []
    eng.finished = {}
    eng.slots = [E._Slot()]
    eng.pool = type("P", (), {"drain_preempted": staticmethod(lambda: []),
                              "num_free_blocks": staticmethod(lambda: 0)})()
    eng.cfg = E.ServingConfig(max_batch=1)
    eng.step()
    assert eng.plane.ticks == 1


def _engines_with_planes(models, backend):
    """JAX's engine and the port's on the same model, pool and simulated
    pressure: compute demand at 1.5 pools' worth of bytes out of M = 4
    pools for 6 ticks, then 3.6 (past r0) for 20, then 1.0."""
    jm, params, tm = models
    kw = dict(max_batch=3, max_len=64, block_tokens=8, cache_dtype="float32")
    cfg = tm.cfg
    block = float(kw["block_tokens"] * 2 * cfg.n_kv_heads * cfg.head_dim
                  * 2 * cfg.n_layers)
    n_blocks = kw["max_batch"] * (kw["max_len"] // kw["block_tokens"])
    pool_bytes = n_blocks * block
    total = 4 * pool_bytes

    def usage(i):
        return (1.5 if i < 6 else 3.6 if i < 26 else 1.0) * pool_bytes

    def build(core, params_fn, pool_cls, **spec_kw):
        pool = pool_cls("kv-pool", n_blocks, block)
        plane = core.MemoryPlane(core.PlaneSpec(
            params=params_fn(total), backend=backend, **spec_kw))
        mon = core.SimulatedMonitor("serve0", total=total, usage=usage,
                                    storage_used_fn=pool.used)
        return pool, plane, mon

    pool, plane, mon = build(J, jax_hbm_pool_params, JaxPool)
    jeng = JaxEngine(jm, params, JaxServingConfig(**kw), pool=pool,
                     plane=plane, monitor=mon)
    pool, plane, mon = build(T, hbm_pool_params, KVBlockPool, device="cpu")
    teng = ServingEngine(tm, ServingConfig(**kw), pool=pool, device="cpu",
                         plane=plane, monitor=mon)
    return jeng, teng, pool_bytes


@pytest.mark.parametrize("backend", ["array", "scalar"])
def test_engine_with_plane_matches_the_jax_engine_with_plane(models,
                                                            backend):
    jeng, teng, pool_bytes = _engines_with_planes(models, backend)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, models[2].cfg.vocab_size, n)
               for n in (5, 11, 8, 14, 3, 9, 6, 12, 7)]
    jr = [jeng.submit(p, 12) for p in prompts]
    tr = [teng.submit(p, 12) for p in prompts]
    keys = ("steps", "finished", "queued", "active", "pool_free_blocks",
            "pool_capacity_bytes", "preemptions")
    caps = []

    def busy(e):
        return e.queue or any(not s.free for s in e.slots)

    while busy(jeng) or busy(teng):
        jeng.step()
        teng.step()
        js, ts = jeng.stats(), teng.stats()
        assert {k: js[k] for k in keys} == {k: ts[k] for k in keys}
        caps.append(ts["pool_capacity_bytes"])
        assert ts["steps"] < 2000, "did not drain"
    assert min(caps) < pool_bytes and caps[-1] == pool_bytes
    assert teng.stats()["preemptions"] >= 1
    ja = [(a.u_prev, a.u_next, a.epoch) for a in jeng.plane.actions()]
    ta = [(a.u_prev, a.u_next, a.epoch) for a in teng.plane.actions()]
    assert len(ta) == teng.steps and ja == ta
    _assert_same_tokens(models[2], [(jeng.finished[a], teng.finished[b])
                                    for a, b in zip(jr, tr)])


def test_serve_retune_cli_makes_the_jax_clis_decision(monkeypatch, capsys):
    """``serve --burst --retune`` at llama3.2-1b-smoke, seed 0: the port's
    CLI on the CPU records the capture JAX's CLI records (bit for bit),
    re-tunes on it with the same halving rungs to the same decision
    (deployed -16.598, kept, epoch 0; scores to rtol 1e-5, both rank in
    float32), prints JAX's retune lines, and serves the second wave."""
    import repro.lab.tune as jtune
    from repro.launch import serve as jserve

    seen = {}
    real = jtune.retune_online

    def spy(plane, **kw):
        handle = real(plane, **kw)
        seen.update(plane=plane, handle=handle)
        return handle

    monkeypatch.setattr(jtune, "retune_online", spy)
    monkeypatch.setattr("sys.argv", ["serve", "--arch", ARCH, "--burst",
                                     "--retune"])
    jserve.main()
    jax_out = capsys.readouterr().out
    ref = seen["handle"].result()
    report = serve.main(["--arch", ARCH, "--device", "cpu", "--burst",
                         "--retune"])
    out = capsys.readouterr().out
    got = report["retune"]
    jc, tc = ref.capture, got.capture
    assert tc.nodes == jc.nodes and tc.interval_s == jc.interval_s
    assert tc.n_intervals == report["stats"]["steps"] == 93
    for f in ("demand", "utilization", "grant", "residency",
              "total_memory"):
        np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f),
                                      err_msg=f)
    assert [r["horizon"] for r in got.tune.rounds] == \
        [r["horizon"] for r in ref.tune.rounds]
    assert (got.swapped, got.epoch) == (ref.swapped, ref.epoch) == \
        (False, None)
    assert got.old_params == hbm_pool_params()
    assert dataclasses.asdict(got.params) == dataclasses.asdict(ref.params)
    assert np.isclose(got.tune.score, ref.tune.score, rtol=1e-5)
    assert np.isclose(got.tune.baseline_score, ref.tune.baseline_score,
                      rtol=1e-5)
    assert (report["retune_attempts"], report["retune_restarts"]) == \
        (seen["handle"].attempts, seen["handle"].restarts) == (1, 0)
    assert report["wave2"]["epoch"] == seen["plane"].epoch == 0
    assert report["wave2"]["requests"] == 6
    health = report["engine"].plane.health()
    assert health.ticks == report["engine"].steps and health.healthy

    def retune_lines(text):
        lines = text.splitlines()
        i = lines.index("-- ReplayLoop: re-tuning pool gains on the "
                        "captured KV workload --")
        return lines[i:i + 3] + lines[-1:]

    assert retune_lines(out) == retune_lines(jax_out)
    assert "deployed -16.598 -> tuned -16.598 (+0.000); kept deployed " \
        "gains" in out
    assert out.splitlines()[-1] == \
        "   second wave under epoch 0: served 18 requests"
