#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the four kernels from ``src/repro_torch/csrc/`` (one ``nvcc``
each, all at once) and drives the port's three main paths on the card:

* the sweep (phases 1-5): the sweep kernel against its plain PyTorch
  version, then ``run_sweep``, ``sweep_demand`` and ``tune_gains`` at
  the lab benchmark's fleet size (4096 nodes x 1000 intervals x 64
  gains) and the registry scenarios' declared sizes, checked against
  the port's own CPU run and the checked-in presets, then its times;
* serving llama3.2-1b at full width (phases 6-9): the decode- and
  flash-attention kernels against their plain versions, the
  continuous-batching engine through a pool burst, forward (flash)
  against decode (decode attention), mixed progress against isolated
  serving, then the kernels' times beside their bounds, their plain
  versions and PyTorch's ``scaled_dot_product_attention`` (flash
  attention in bf16 and in f32, and at the main path's f32 shapes);
* serving hymba-1.5b at full width (phases 10-13): the scan kernel
  against its plain version bit for bit, and both attention kernels at
  hymba's heads and window; the engine through the same burst; forward
  (flash and scan) against decode past the 1024-token window, mixed
  progress against isolated serving; then the scan kernel's time beside
  its bound and its plain version.

Every phase prints a line; any failed check raises and the exit code is
nonzero.  The last line is a JSON object naming the device; the one
before it lists the kernels with their numbers, and the one before
that the card's name and power limit.

Needs a CUDA card and ``nvcc``; imports nothing of JAX or of the JAX
package.  Without a card it exits nonzero before printing a result.
"""

import concurrent.futures
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA card is available")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs import DECODE_32K, get_config  # noqa: E402
from repro_torch.configs.dynims import (LAB_TUNED,  # noqa: E402
                                        LAB_TUNED_OBJECTIVES)
from repro_torch.core.traces import GiB, fleet_demand_traces  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as kd  # noqa: E402
from repro_torch.kernels import flash_attention as kf  # noqa: E402
from repro_torch.kernels import ssm_scan as kscan  # noqa: E402
from repro_torch.kernels import sweep as ks  # noqa: E402
from repro_torch.lab import fused_sweep as fs  # noqa: E402
from repro_torch.lab.scenarios import get_scenario  # noqa: E402
from repro_torch.lab.score import stats_mismatches  # noqa: E402
from repro_torch.lab.sweep import (plan_specialization, run_sweep,  # noqa
                                   sweep_demand)
from repro_torch.lab.tune import grid_gains, tune_gains  # noqa: E402
from repro_torch.launch.serve import (FULL_WIDTH,  # noqa: E402
                                      FULL_WIDTH_HYMBA, serve)
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models.transformer import layer_windows  # noqa: E402
from repro_torch.serving import ServingConfig, ServingEngine  # noqa: E402

CUDA = torch.device("cuda")
N_NODES, N_STEPS = 4096, 1000            # the lab benchmark's fleet
CACHE = get_scenario("spark-iterative-cache").cache
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 FLOP/s
# outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_BF16_S = 989e12                     # dense, tensor cores
PEAK_TF32_S = 495e12                     # dense, tensor cores
# Operations per (lane, node, interval) update of the paper-law step in
# csrc/sweep.cu, counted from its source: every add, multiply, divide,
# compare, select, min/max and the code's conversion.  A multiply-add
# rounded through float64 counts as two, each float64 log2/exp2 as one,
# and all at the float32 rate, so the bound stays a lower bound.
OPS_PER_UPDATE = {"cache-off": 32, "cache-on": 85}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def cuda_ms(fn, reps: int = 5, warm: int = 2, flush=None) -> float:
    """Median of ``reps`` warm runs, timed with CUDA events.

    ``flush``, a large tensor, is overwritten before each timed run so
    the run finds the 50 MB L2 cache cold, as a caller between other
    work does.
    """
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.fill_(1.0)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def gains_64(law: str):
    if law == "paper":
        return grid_gains()                         # 8 lam x 8 r0
    return grid_gains(lam=np.linspace(0.1, 1.8, 8), r0=(0.92, 0.96),
                      lam_grant=(0.25,), deadband=(0.0, 0.005),
                      feedforward=(0.0, 0.5))


def segment_inputs(demand, gains, cache, precision, n_dead=0,
                   occupancy=1.0):
    plan = plan_specialization(gains, occupancy)
    con = fs._engine_consts(plan, cache, 0.1, occupancy, precision)
    names = ks.state_names(con.paper_law, con.has_cache)
    dtn, rows, lp = fs._stage(demand, gains, np.full(N_NODES, 125 * GiB),
                              cache, precision, CUDA)
    alive = fs._alive(len(gains), len(gains) - n_dead, CUDA)
    state0 = fs._init_state(lp, rows, dtn[0].float(), con, names)
    return (state0, dtn, lp, rows, alive), dict(t0=0, con=con, names=names)


def compare_planes(names, got, want):
    """Largest |diff| and largest diff relative to its plane's scale.

    A Kahan compensation plane (``*_c``) is scaled by its sum's plane:
    it is part of that sum's value.
    """
    max_abs, max_rel = 0.0, 0.0
    for i, name in enumerate(names):
        ref = want[names.index(name[:-2])] if name.endswith("_c") \
            else want[i]
        diff = float((got[i] - want[i]).abs().max())
        scale = float(ref.abs().max())
        max_abs = max(max_abs, diff)
        if diff:
            max_rel = max(max_rel, diff / scale if scale else float("inf"))
    return max_abs, max_rel


def phase1(demand):
    log("phase 1: kernel vs plain on the card, 4096 nodes x 1000 "
        "intervals x 64 gains")
    variants = [("paper", None, "f32", 1.0), ("generic", None, "f32", 1.0),
                ("paper", CACHE, "f32", 1.0), ("generic", CACHE, "f32", 1.0),
                ("paper", None, "bf16", 1.0), ("generic", CACHE, "bf16", 1.0),
                ("paper", None, "f32", 0.8)]
    worst_abs = 0.0
    for law, cache, precision, occ in variants:
        args, kw = segment_inputs(demand, gains_64(law), cache, precision,
                                  n_dead=5, occupancy=occ)
        before = ks.LAUNCHES
        sk, ck = ks.sweep_segment(*args, **kw)
        torch.cuda.synchronize()
        check(ks.LAUNCHES == before + 1, "the kernel did not launch")
        sp, cp = ks.sweep_segment_plain(*args, **kw)
        torch.cuda.synchronize()
        max_abs, max_rel = compare_planes(kw["names"], sk, sp)
        code_diff = (ck.to(torch.int32) - cp.to(torch.int32)).abs()
        n_codes = int((code_diff != 0).sum())
        dead_ok = (int(ck[:, -5:].to(torch.int32).abs().sum()) == 0
                   and torch.equal(sk[:, -5:], args[0][:, -5:]))
        tag = (f"{law:7s} {'cache-on' if cache else 'cache-off':9s} "
               f"{precision:4s} occ={occ}")
        log(f"  {tag}: bit-identical={torch.equal(sk, sp) and n_codes == 0}"
            f" max_abs={max_abs:.3e} max_rel={max_rel:.3e} "
            f"codes_differing={n_codes} max_code_diff="
            f"{int(code_diff.max())} dead_lanes_ok={dead_ok}")
        check(dead_ok, f"{tag}: dead lanes wrote codes or moved state")
        check(bool(torch.isfinite(sk).all()), f"{tag}: non-finite state")
        if cache is None:
            check(torch.equal(sk, sp) and n_codes == 0,
                  f"{tag}: cache-off kernel is not bit-identical")
        else:
            check(max_rel <= 1e-6, f"{tag}: cache-on state off by "
                  f"{max_rel:.3e} relative (bound 1e-6)")
        worst_abs = max(worst_abs, max_abs)
    return worst_abs


def assert_same(tag, card, cpu, n_samples):
    bad = stats_mismatches(card, cpu, n_samples=n_samples)
    for f in card._fields:
        v = np.asarray(getattr(card, f))
        check(v.shape == np.asarray(getattr(cpu, f)).shape
              and np.isfinite(v).all(), f"{tag}: {f} malformed")
    check(not bad, f"{tag}: card and CPU disagree:\n" + "\n".join(bad))
    exact = sum(np.array_equal(getattr(card, f), getattr(cpu, f))
                for f in card._fields)
    log(f"  {tag}: card == CPU within the test brackets ({exact} of "
        f"{len(card._fields)} fields bit-identical)")


def phase2(demand):
    log("phase 2: the main path, card against the port's CPU run")
    spec = get_scenario("phase-replay")
    t0 = time.perf_counter()
    card = run_sweep("phase-replay", grid_gains())
    t_card = time.perf_counter() - t0
    cpu = run_sweep("phase-replay", grid_gains(), device="cpu")
    assert_same(f"run_sweep(phase-replay, {spec.n_nodes} nodes, 64 gains,"
                f" card {t_card:.2f}s)", card.stats, cpu.stats,
                spec.n_nodes * spec.n_intervals)
    check(card.best() == cpu.best(), "phase-replay: winners differ")
    m = np.full(N_NODES, 125 * GiB)
    for tag, cache in (("cache-off", None), ("cache-on", CACHE)):
        t0 = time.perf_counter()
        a = sweep_demand(demand, grid_gains(), node_memory=m, cache=cache)
        t_card = time.perf_counter() - t0
        b = sweep_demand(demand, grid_gains(), node_memory=m, cache=cache,
                         device="cpu")
        assert_same(f"sweep_demand 4096x1000x64 {tag} (card {t_card:.2f}s)",
                    a, b, N_NODES * N_STEPS)


def phase3():
    log("phase 3: in-scan halving, tune_gains(swap-storm, halving, 512)")
    card = tune_gains("swap-storm", method="halving", budget=512)
    cpu = tune_gains("swap-storm", method="halving", budget=512,
                     device="cpu")
    sched = " -> ".join(f"{r['n_candidates']}@T={r['horizon']}"
                        for r in card.rounds)
    log(f"  rounds: {sched}")
    same = all(np.array_equal(getattr(card.sweep.gains, f),
                              getattr(cpu.sweep.gains, f))
               for f in ("r0", "lam", "lam_grant", "deadband", "feedforward"))
    check(same, "in-scan survivors differ between the card and the CPU")
    check(card.params == cpu.params, "halving winners differ")
    log(f"  survivors equal ({card.sweep.n_configs} final lanes); winner "
        f"r0={card.params.r0:.4f} lam={card.params.lam:.4f} "
        f"lam_grant={card.params.lam_grant} score={card.score:.6f}")


def phase4():
    log("phase 4: the six LAB_TUNED presets regenerate on the card")
    for name in sorted(LAB_TUNED):
        objective = LAB_TUNED_OBJECTIVES.get(name)
        r = tune_gains(name, budget=100, objective=objective)
        preset = LAB_TUNED[name]
        ok = r.params == preset
        s = r.sweep.scores()
        order = np.argsort(-s)
        margin = float(s[order[0]] - s[order[1]])
        log(f"  {name} [{objective or 'default'}]: "
            f"{'ok' if ok else 'STALE'} score={r.score:.6f} "
            f"margin_to_second={margin:.3e}")
        if not ok:
            g = r.sweep.gains
            idx = [i for i in range(len(g))
                   if g.params_at(i, preset) == preset]
            want = float(s[idx[0]]) if idx else float("nan")
            check(False, f"{name}: tuned {r.params} != preset {preset}; "
                  f"winner {r.score!r} vs preset {want!r}")


def phase5(demand):
    log("phase 5: times on the card (CUDA events, median of 5 warm runs)")
    out = {}
    n_upd = N_NODES * N_STEPS * 64
    for tag, cache in (("cache-off", None), ("cache-on", CACHE)):
        args, kw = segment_inputs(demand, gains_64("paper"), cache, "f32")
        ms = cuda_ms(lambda: ks.sweep_segment(*args, **kw), reps=7)
        plain = cuda_ms(lambda: ks.sweep_segment_plain(*args, **kw), reps=5,
                        warm=1)
        state, codes = ks.sweep_segment(*args, **kw)
        fin = cuda_ms(lambda: fs._finalize_lanes(state, codes, args[2],
                                                 kw["con"], kw["names"],
                                                 N_STEPS))
        state_bytes = 2 * state.numel() * 4
        n_bytes = (codes.numel() * 2 + args[1].numel() * 4 + state_bytes
                   + args[2].numel() * 4 + args[3].numel() * 4
                   + args[4].numel() * 4)
        t_bytes = n_bytes / PEAK_BYTES_S * 1e3
        t_ops = n_upd * OPS_PER_UPDATE[tag] / PEAK_F32_S * 1e3
        out[tag] = dict(ms=ms, plain_ms=plain, finalize_ms=fin,
                        bound_ms=max(t_bytes, t_ops),
                        bound_by="bytes" if t_bytes >= t_ops
                        else "operations")
        log(f"  {tag}: kernel {ms:.4f} ms ({n_upd / ms * 1e3:.3e} updates/s)"
            f", plain {plain:.1f} ms, _finalize_lanes {fin:.4f} ms, bound "
            f"{out[tag]['bound_ms']:.4f} ms by {out[tag]['bound_by']} "
            f"(bytes {t_bytes:.4f} ms, ops {t_ops:.4f} ms)")
    return out

# ---- serving llama3.2-1b: the attention kernels ------------------------

ARCH = FULL_WIDTH["arch"]
# ((b, s, h, kv, hd, window), lengths or None for random ones in
# [window + 1, s)): tests/test_kernels.py's DECODE_CASES; a cache length
# that is a multiple of no tile at the model's heads, with len 1 and len
# S; one (sequence, kv head) pair over 4000 keys, split the most; 320
# pairs, which fill the card with one split each; head dims 16 and 128
# with len 0 and 1 in one batch; windows that start mid-tile (677, 50);
# 16 and 12 query heads per kv head (two head sets of warps).
DECODE_CASES = [((4, 512, 8, 2, 64, 0), None), ((2, 1024, 4, 4, 32, 0), None),
                ((3, 512, 8, 4, 64, 200), None),
                ((1, 256, 2, 1, 128, 0), None),
                ((5, 1000, 32, 8, 64, 0), [1, 1000, 333, 999, 17]),
                ((1, 4000, 4, 1, 64, 0), [4000]),
                ((40, 300, 32, 8, 64, 0), None),
                ((4, 700, 8, 2, 16, 0), [0, 1, 700, 333]),
                ((4, 900, 16, 4, 128, 0), [0, 1, 900, 555]),
                ((3, 777, 8, 2, 64, 100), [777, 0, 150]),
                ((2, 500, 16, 1, 64, 0), [500, 37]),
                ((2, 300, 24, 2, 32, 50), [300, 1])]
# (b, sq, skv, h, kv, hd, causal, window): tests/test_kernels.py's
# FLASH_CASES, then ragged lengths at the model's heads, then head dims
# 16 and 128 at an Sq that is a multiple of neither 64 nor 16, causal,
# windowed and non-causal with Sq < Skv.
FLASH_CASES = [(2, 256, 256, 4, 2, 64, True, 0),
               (1, 128, 128, 4, 4, 32, True, 0),
               (2, 128, 256, 4, 1, 64, False, 0),
               (1, 256, 256, 8, 2, 64, True, 64),
               (1, 512, 512, 2, 2, 128, True, 0),
               (2, 192, 192, 4, 2, 64, True, 48),
               (2, 300, 300, 32, 8, 64, True, 0),
               (2, 77, 77, 4, 2, 16, True, 0),
               (1, 77, 333, 8, 2, 128, False, 0),
               (2, 200, 200, 4, 1, 128, True, 40),
               (1, 61, 300, 4, 4, 16, False, 0),
               (1, 100, 300, 2, 1, 32, False, 50)]
F32, BF16 = torch.float32, torch.bfloat16
# (B, S) of one decode_32k layer: 128 x 32768, 8.6 GB of bf16 K/V
DECODE_LONG = (DECODE_32K.global_batch, DECODE_32K.seq_len)
FLASH_TIMED = (2, 4096)          # (B, S) of the timed causal forward
FLASH_MAIN_LLAMA = (2, 256)      # (B, S) of phase 8's forward
FLASH_MAIN_HYMBA = (1, 1088)     # (B, S) of phase 12's forward


def randn(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device=CUDA).to(dtype)


def max_err(got, want, tol, tag):
    """Largest |got - want|; raises past ``atol = rtol = tol``."""
    check(bool(torch.isfinite(got).all()), f"{tag}: non-finite output")
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol,
                               msg=lambda m: f"{tag}: {m}")
    return float((got.float() - want.float()).abs().max())


def decode_splits(b, s, h, kv):
    """The split count the decode wrapper picks on this card."""
    return kd.choose_splits(b, kv, s, h // kv, kd.sm_count(CUDA.index or 0))


def check_decode(case, lens, gen, errs):
    """Decode kernel against plain at one case, for each pair of types;
    a second call on the same inputs must give the same bits."""
    b, s, h, kv, hd, window = case
    splits = decode_splits(b, s, h, kv)
    for qdt, kdt in ((F32, F32), (BF16, BF16), (F32, BF16)):
        q = randn((b, h, hd), qdt, gen)
        kc, vc = randn((b, s, kv, hd), kdt, gen), \
            randn((b, s, kv, hd), kdt, gen)
        if lens is None:
            lo = window + 1 if window else 1
            lens_b = torch.randint(lo, s, (b,), generator=gen,
                                   device=CUDA).tolist()
        else:
            lens_b = lens
        lens_b = torch.tensor(lens_b, dtype=torch.int32, device=CUDA)
        before = kd.LAUNCHES
        out = kd.decode_attention(q, kc, vc, lens_b, window=window)
        torch.cuda.synchronize()
        check(kd.LAUNCHES == before + 1, "decode kernel did not launch")
        again = kd.decode_attention(q, kc, vc, lens_b, window=window)
        ref = kd.decode_attention_plain(q, kc, vc, lens_b, window=window)
        # both sides compute in f32 from the same cache values, so
        # the output's type sets the tolerance
        tol = 3e-2 if qdt == BF16 else 2e-5
        tag = (f"decode b{b} S{s} H{h}/KV{kv} hd{hd} w{window} "
               f"q={str(qdt)[6:]} cache={str(kdt)[6:]} splits {splits}")
        check(torch.equal(out, again), f"{tag}: two calls differ")
        err = max_err(out, ref, tol, tag)
        key = "f32" if tol == 2e-5 else "bf16"
        errs["decode"][key] = max(errs["decode"].get(key, 0.0), err)
        log(f"  {tag}: max_abs_err={err:.3e} ok, bit-identical twice")


def check_flash(case, gen, errs):
    """Flash kernel against plain at one case, in f32 and in bf16."""
    b, sq, skv, h, kv, hd, causal, window = case
    for dt in (F32, BF16):
        q = randn((b, sq, h, hd), dt, gen)
        k, v = randn((b, skv, kv, hd), dt, gen), \
            randn((b, skv, kv, hd), dt, gen)
        before = kf.LAUNCHES
        out = kf.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        check(kf.LAUNCHES == before + 1, "flash kernel did not launch")
        ref = kf.flash_attention_plain(q, k, v, causal=causal,
                                       window=window)
        tol = 2e-2 if dt == BF16 else 2e-5
        tag = (f"flash b{b} Sq{sq} Skv{skv} H{h}/KV{kv} hd{hd} "
               f"causal={causal} w{window} {str(dt)[6:]}")
        err = max_err(out, ref, tol, tag)
        key = "f32" if dt == F32 else "bf16"
        errs["flash"][key] = max(errs["flash"].get(key, 0.0), err)
        log(f"  {tag}: max_abs_err={err:.3e} ok")


def phase6():
    log("phase 6: attention kernels vs plain on the card (tolerance by "
        "the output's type: 2e-5 f32, 3e-2 decode / 2e-2 flash bf16)")
    gen = torch.Generator(device=CUDA).manual_seed(6)
    errs = {"decode": {}, "flash": {}}
    for case, lens in DECODE_CASES:
        check_decode(case, lens, gen, errs)
    b, s, h, kv, hd = 2, 1024, 4, 2, 64          # NaN past len_b (and
    splits = decode_splits(b, s, h, kv)          # before the window)
    check(splits > 1, f"the poisoned cache runs {splits} split(s)")
    for window in (0, 600):                      # the 700-key sequence
        for kdt in (F32, BF16):                  # runs in 2 parts
            q = randn((b, h, hd), F32, gen)
            kc, vc = randn((b, s, kv, hd), kdt, gen), \
                randn((b, s, kv, hd), kdt, gen)
            lens = torch.tensor([700, 17], dtype=torch.int32, device=CUDA)
            pos = torch.arange(s, device=CUDA)[None]
            dead = pos >= lens[:, None]
            if window:
                dead |= pos < lens[:, None] - window
            dead = dead[..., None, None]
            a = kd.decode_attention(q, kc, vc, lens, window=window)
            p = kd.decode_attention(q, kc.masked_fill(dead, float("nan")),
                                    vc.masked_fill(dead, float("nan")), lens,
                                    window=window)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(p).all()) and torch.equal(a, p),
                  f"decode read a poisoned key (window {window}, {kdt})")
    log(f"  poisoned cache (NaN past len_b, and before the window; "
        f"{splits} splits, 2 parts used for the 700-key sequence): output "
        f"unchanged and finite, f32 and bf16 caches")
    for case in FLASH_CASES:
        check_flash(case, gen, errs)
    return errs


def serve_full_width(phase, w, smi):
    """Serve workload ``w`` through the burst; returns the engine, the
    decode kernel's launches while serving, and the serving numbers."""
    cfg = get_config(w["arch"])
    log(f"phase {phase}: serve {w['arch']} at full width ({cfg.n_layers} "
        f"layers, d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; f32 weights, seed "
        f"{w['seed']}; bf16 cache), {w['requests']} requests x "
        f"{w['prompt_len']}-token prompts x {w['max_new']} new tokens, "
        f"max_batch {w['max_batch']}, max_len {w['max_len']}, block 16, "
        f"pool to 25% after 10 steps, restored 5 steps later")
    kd.LAUNCHES = 0                        # the serving path starts here
    report = serve(**w, burst=True)
    launches = kd.LAUNCHES
    eng = report["engine"]
    st = eng.stats()
    fin = report["finished"]
    dt = report["seconds"]
    check(len(fin) == w["requests"]
          and all(len(r.output) == w["max_new"] for r in fin.values()),
          f"not drained: {st}")
    check(st["preemptions"] >= 1, f"the burst preempted nothing: {st}")
    check(st["logits_finite"], "non-finite logits")
    check(launches == st["decode_steps"] * cfg.n_layers,
          f"decode kernel launched {launches} times for "
          f"{st['decode_steps']} steps x {cfg.n_layers} layers")
    log(f"  drained {len(fin)}/{w['requests']}, {report['tokens']} tokens, "
        f"{st['preemptions']} preemption(s), {st['steps']} steps "
        f"({st['decode_steps']} with an active slot); decode kernel "
        f"launches {launches} = steps x {cfg.n_layers}; logits finite")
    log(f"  {report['tokens'] / dt:.1f} tok/s, {st['steps'] / dt:.2f} "
        f"steps/s ({dt:.3f} s, host clock) on {smi}")
    return eng, launches, {"tok_s": report["tokens"] / dt,
                           "steps_s": st["steps"] / dt, "seconds": dt,
                           "steps": st["steps"],
                           "preemptions": st["preemptions"]}


def forward_decode_rel(model, tokens):
    """Max |forward - decode| over max |forward| of the logits (decode
    with an f32 cache), and the forward's launches of flash and scan."""
    kf.LAUNCHES = kscan.LAUNCHES = 0       # the forward path starts here
    fwd = model(tokens)
    launches = {"flash": kf.LAUNCHES, "scan": kscan.LAUNCHES}
    check(bool(torch.isfinite(fwd).all()), "non-finite forward logits")
    b, s = tokens.shape
    state = D.init_state(model, b, s, cache_dtype="float32")
    dec = torch.cat([D.decode_step(model, state, tokens[:, t:t + 1])
                     for t in range(s)], dim=1)
    return float((fwd - dec).abs().max() / fwd.abs().max()), launches


def forward_against_decode(phase, model, batch, seq):
    """Forward (flash, and scan in a hybrid) against decode (decode
    attention) on ``batch`` x ``seq`` tokens with an f32 cache, then
    mixed progress against isolated serving.  Returns the forward's
    launches of the flash and scan kernels."""
    cfg = model.cfg
    hybrid = cfg.family == "hybrid"
    log(f"phase {phase}: forward ({'flash + scan' if hybrid else 'flash'}) "
        f"against decode (decode attention) at full width, {batch} x {seq} "
        f"tokens, f32 cache; mixed progress")
    gen = torch.Generator(device=CUDA).manual_seed(phase)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device=CUDA)
    rel, launches = forward_decode_rel(model, tokens)
    want = {"flash": cfg.n_layers, "scan": cfg.n_layers if hybrid else 0}
    check(launches == want, f"forward launched {launches} for "
          f"{cfg.n_layers} layers, expected {want}")
    check(rel < 5e-3, f"forward and decode differ by {rel:.3e} relative "
          f"(bound 5e-3)")
    log(f"  forward launches {launches}; forward vs decode: max relative "
        f"diff {rel:.3e} (bound 5e-3)")

    rng = np.random.default_rng(phase)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 9, 3)]

    def run(prompt_list):
        eng = ServingEngine(model, ServingConfig(
            max_batch=3, max_len=64, block_tokens=8, cache_dtype="float32"))
        rids = [eng.submit(p, 6) for p in prompt_list]
        done = eng.run_until_drained(max_steps=2000)
        return [done[r].output for r in rids]

    together = run(prompts)
    alone = [run([p])[0] for p in prompts]
    check(together == alone, f"mixed progress {together} != isolated "
          f"{alone}")
    log(f"  three prompts served together == each served alone: "
        f"{together}")
    return launches


def sdpa(q, k, v, **kw):
    """PyTorch's fused attention on the port's (B, S, H, hd) layouts."""
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        enable_gqa=True, **kw).transpose(1, 2)


def bound(n_bytes, n_ops, peak_ops):
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def time_decode(tag, q, kc, vc, lens, flush, window=0):
    """B3 at one shape: kernel, plain, SDPA.  The bound counts the kept
    keys' K and V read once, q read and the output written once."""
    b, h, hd = q.shape
    s, kv = kc.shape[1], kc.shape[2]
    hi = lens.clamp(min=0, max=s).long()
    lo = (hi - window).clamp(min=0) if window else torch.zeros_like(hi)
    n_keys = int((hi - lo).sum())
    n_bytes = (n_keys * kv * hd * 2 * kc.element_size()
               + 2 * q.numel() * q.element_size() + lens.numel() * 4)
    bound_ms, by = bound(n_bytes, 4 * n_keys * h * hd, PEAK_F32_S)
    run = lambda: kd.decode_attention(  # noqa: E731
        q, kc, vc, lens, window=window)
    plain_run = lambda: kd.decode_attention_plain(  # noqa: E731
        q, kc, vc, lens, window=window)
    ms = cuda_ms(run, reps=7, flush=flush)
    plain = cuda_ms(plain_run, reps=3, warm=1, flush=flush)
    got = run()
    err = max_err(got, plain_run(), 3e-2 if q.dtype == BF16 else 2e-5,
                  f"decode {tag}")
    check(torch.equal(got, run()), f"decode {tag}: two calls differ")
    splits = decode_splits(b, s, h, kv)
    qs = q.to(kc.dtype)[:, None]                     # (B, 1, H, hd)
    pos = torch.arange(s, device=CUDA)[None]
    mask = ((pos < hi[:, None])
            & (pos >= lo[:, None]))[:, None, None, :]  # (B, 1, 1, S)
    lib_out = sdpa(qs, kc, vc, attn_mask=mask)[:, 0]
    check(bool(torch.isfinite(lib_out).all()), f"{tag}: SDPA non-finite")
    lib = cuda_ms(lambda: sdpa(qs, kc, vc, attn_mask=mask), reps=5,
                  flush=flush)
    log(f"  decode {tag}: {splits} split(s), kernel {ms:.4f} ms, plain "
        f"{plain:.3f} ms, SDPA {lib:.4f} ms, bound {bound_ms:.4f} ms by {by} "
        f"({n_bytes / 1e9:.4f} GB; {n_bytes / ms / 1e6:.1f} GB/s achieved, "
        f"{bound_ms / ms:.1%} of bound); kernel vs plain max |diff| "
        f"{err:.2e}, bit-identical twice; SDPA vs kernel max |diff| "
        f"{float((lib_out.float() - got.float()).abs().max()):.2e}")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound_ms,
                bound_by=by, shape=tag, max_abs_err=err, splits=splits,
                gb_s=n_bytes / ms / 1e6)


def kept_pairs(sq, skv, causal, window):
    """(query, key) pairs the mask keeps over positions arange(Sq/Skv)."""
    i = torch.arange(sq, dtype=torch.int64)
    hi = torch.clamp(i + 1, max=skv) if causal else torch.full_like(i, skv)
    lo = torch.clamp(i - window + 1, min=0) if window else torch.zeros_like(i)
    return int((hi - lo).clamp(min=0).sum())


def time_flash(b, s, h, kv, hd, dtype, window, gen, flush):
    """B2 at one causal (B, S) self-attention shape: kernel, plain, SDPA.

    The bound counts 4 * hd operations per kept (query, key) pair at the
    rate of the kernel's route (bf16 tensor cores; f32 as 3xTF32, three
    TF32 products for each, so a third of the TF32 rate), and q, k, v
    read and the output written once.  f32 rows also print the bound of
    the CUDA cores' f32 rate.
    """
    q = randn((b, s, h, hd), dtype, gen)
    k, v = randn((b, s, kv, hd), dtype, gen), randn((b, s, kv, hd), dtype,
                                                    gen)
    n_ops = 4 * b * h * kept_pairs(s, s, True, window) * hd
    n_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bound_ms, by = bound(n_bytes, n_ops, PEAK_BF16_S if dtype == BF16
                         else PEAK_TF32_S / 3)
    run = lambda: kf.flash_attention(q, k, v, window=window)  # noqa: E731
    plain_run = lambda: kf.flash_attention_plain(  # noqa: E731
        q, k, v, window=window)
    ms = cuda_ms(run, reps=7, flush=flush)
    plain = cuda_ms(plain_run, reps=3, warm=1, flush=flush)
    tol = 2e-2 if dtype == BF16 else 2e-5
    tag = (f"B{b} x S{s} x H{h}/KV{kv} x hd{hd} {str(dtype)[6:]} causal"
           + (f" window {window}" if window else ""))
    got = run()
    err = max_err(got, plain_run(), tol, f"flash {tag}")
    mask = kf.make_mask(torch.arange(s, device=CUDA),
                        torch.arange(s, device=CUDA), causal=True,
                        window=window)
    lib_kw = dict(attn_mask=mask) if window else dict(is_causal=True)
    lib_out = sdpa(q, k, v, **lib_kw)
    diff = float((lib_out.float() - got.float()).abs().max())
    lib = cuda_ms(lambda: sdpa(q, k, v, **lib_kw), reps=7, flush=flush)
    extra = ""
    if dtype == F32:
        cores_ms, _ = bound(n_bytes, n_ops, PEAK_F32_S)
        extra = f" (f32 CUDA cores: {cores_ms:.4f} ms)"
    log(f"  flash {tag}: kernel {ms:.4f} ms ({n_ops / ms / 1e9:.2f} "
        f"TFLOP/s), plain {plain:.3f} ms, SDPA {lib:.4f} ms, bound "
        f"{bound_ms:.4f} ms by {by}{extra}, {bound_ms / ms:.1%} of bound; "
        f"kernel vs plain max |diff| {err:.2e}; SDPA vs kernel max |diff| "
        f"{diff:.2e}")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound_ms,
                bound_by=by, shape=tag, max_abs_err=err,
                tflop_s=n_ops / ms / 1e9)


def phase9(state, scfg):
    log("phase 9: times on the card (CUDA events, median of warm runs, L2 "
        "flushed before each; peaks 989 TFLOP/s bf16 and 495 TF32 on the "
        "tensor cores, 67 f32 on the CUDA cores, 3.35 TB/s)")
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=CUDA)
    gen = torch.Generator(device=CUDA).manual_seed(9)
    cfg = get_config(ARCH)
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out = {}
    lens = (state.pos + 1).clamp(max=scfg.max_len).to(torch.int32)
    q = randn((scfg.max_batch, h, hd), F32, gen)
    out["decode_engine"] = time_decode(
        f"engine B{scfg.max_batch} x S{scfg.max_len} x KV{kv} x hd{hd}, q "
        f"f32, bf16 cache, lengths {lens.tolist()}", q, state.k[0],
        state.v[0], lens, flush)
    del state
    b, s = DECODE_LONG                               # one layer of decode_32k
    kc, vc = randn((b, s, kv, hd), BF16, gen), randn((b, s, kv, hd), BF16,
                                                      gen)
    q = randn((b, h, hd), BF16, gen)
    lens = torch.full((b,), s, dtype=torch.int32, device=CUDA)
    out["decode_32k"] = time_decode(
        f"decode_32k layer B{b} x S{s} x KV{kv} x hd{hd} bf16, full lengths",
        q, kc, vc, lens, flush)
    del kc, vc
    torch.cuda.empty_cache()
    b, s = FLASH_TIMED
    out["flash"] = time_flash(b, s, h, kv, hd, BF16, 0, gen, flush)
    out["flash_f32"] = time_flash(b, s, h, kv, hd, F32, 0, gen, flush)
    out["flash_main"] = []
    for arch, (b, s) in ((ARCH, FLASH_MAIN_LLAMA),
                         (FULL_WIDTH_HYMBA["arch"], FLASH_MAIN_HYMBA)):
        c = get_config(arch)
        windows = layer_windows(c)
        for window in sorted(set(windows), reverse=True):
            row = time_flash(b, s, c.n_heads, c.n_kv_heads, c.head_dim, F32,
                             window, gen, flush)
            row["launches_per_forward"] = windows.count(window)
            row["model"] = arch
            out["flash_main"].append(row)
    return out


# ---- serving hymba-1.5b: the scan kernel --------------------------------

HYMBA = get_config(FULL_WIDTH_HYMBA["arch"])
# (b, s, c, n): tests/test_kernels.py's SSM_CASES, one step, then a few
# hundred steps at hymba's C = 3200, N = 16, and a ragged C x N
SCAN_CASES = [(2, 256, 128, 16), (1, 128, 256, 8), (3, 64, 128, 4),
              (2, 1, 3200, 16), (2, 300, 3200, 16), (2, 37, 5, 3)]
SCAN_TIMED = (2, 4096)           # (B, S) of the timed scan: one layer of a
#                                  2 x 4096 forward at C = 3200, N = 16
# hymba's heads (25/5 of 64) with its window of 1024, past it, with a
# ragged length; and global layers' full attention; flash also at head
# dims 16 and 128, Sq 77, and non-causal with Sq < Skv
# decode also at one (sequence, kv head) pair over 4000 keys with the
# window (its 1024 live keys split the most), at 320 pairs (one split),
# at head dims 16 and 128 with len 0 and 1 in one batch, and with windows
# that start mid-tile (313, 476)
HYMBA_DECODE = [((4, 1500, 25, 5, 64, 1024), [1, 1025, 1500, 1337]),
                ((2, 1100, 25, 5, 64, 0), [1100, 777]),
                ((1, 4000, 5, 1, 64, 1024), [3337]),
                ((64, 1100, 25, 5, 64, 1024), None),
                ((3, 700, 25, 5, 16, 1024), [0, 1, 700]),
                ((3, 1500, 25, 5, 128, 1024), [0, 1, 1500])]
HYMBA_FLASH = [(1, 1100, 1100, 25, 5, 64, True, 1024),
               (1, 1088, 1088, 25, 5, 64, True, 0),
               (2, 77, 77, 25, 5, 16, True, 50),
               (1, 1100, 1100, 25, 5, 128, True, 1024),
               (1, 77, 300, 25, 5, 128, False, 0),
               (1, 300, 1100, 25, 5, 16, False, 0)]


def scan_inputs(b, s, c, n, dtype, gen):
    decay = (torch.rand((b, s, c, n), generator=gen, device=CUDA) * 0.7
             + 0.3).to(dtype)
    drive = (randn((b, s, c, n), F32, gen) * 0.2).to(dtype)
    return decay, drive, randn((b, c, n), F32, gen)


def phase10():
    log("phase 10: the scan kernel vs plain on the card (f32 bit for bit, "
        "bf16 inputs within 1e-5); attention kernels at hymba's heads "
        "(25/5 of 64) and window 1024")
    gen = torch.Generator(device=CUDA).manual_seed(10)
    worst = 0.0
    for case in SCAN_CASES:
        for dt in (F32, BF16):
            decay, drive, h0 = scan_inputs(*case, dt, gen)
            before = kscan.LAUNCHES
            out = kscan.ssm_scan(decay, drive, h0)
            torch.cuda.synchronize()
            check(kscan.LAUNCHES == before + 1, "scan kernel did not launch")
            ref = kscan.ssm_scan_plain(decay, drive, h0)
            tag = f"scan {'x'.join(map(str, case))} {str(dt)[6:]}"
            same = torch.equal(out, ref)
            if dt == F32:
                check(same, f"{tag}: not bit-identical")
            err = max_err(out, ref, 1e-5, tag)
            worst = max(worst, err)
            log(f"  {tag}: bit-identical={same} max_abs_err={err:.3e}")
    decay, drive, h0 = scan_inputs(2, 300, 3200, 16, F32, gen)
    whole = kscan.ssm_scan(decay, drive, h0)
    first = kscan.ssm_scan(decay[:, :123], drive[:, :123], h0)
    second = kscan.ssm_scan(decay[:, 123:], drive[:, 123:], first[:, -1])
    torch.cuda.synchronize()
    check(torch.equal(torch.cat([first, second], dim=1), whole),
          "two calls carrying h0 differ from one call")
    log("  two calls, the first's last h carried as h0 == one call over "
        "the whole sequence, bit for bit")
    errs = {"decode": {}, "flash": {}}
    for case, lens in HYMBA_DECODE:
        check_decode(case, lens, gen, errs)
    for case in HYMBA_FLASH:
        check_flash(case, gen, errs)
    return worst, errs


def mamba_paper_init(model, seed):
    """Give every Mamba branch the A and dt of the Mamba paper's init
    (S4D-real A = -(1, ..., N) per channel; dt log-uniform in [1e-3,
    1e-1] per channel through ``dt_bias``), in place.

    The JAX init kinds (``a_log`` ones, ``dt_bias`` zeros) make A and dt
    the same for every channel, and dt one scalar per token, so
    ``y + x * d_skip = x * (1 + dt * B.C) + ...`` cancels in every
    channel at once where ``dt * B.C`` nears -1.  The weightless RMS
    fusion then scales that token's rounding up to unit size, and 32
    layers compound it: forward and decode, which round differently,
    drift apart by ~1e-2 however right both are.
    """
    gen = torch.Generator(device=CUDA).manual_seed(seed)
    lo, hi = np.log(1e-3), np.log(1e-1)
    with torch.no_grad():
        for layer in model.layers:
            p = layer.mamba
            inner, n = p.a_log.shape
            p.a_log.copy_(torch.log(torch.arange(1, n + 1, device=CUDA,
                                                 dtype=F32)).expand(inner, n))
            dt = torch.exp(torch.rand(inner, generator=gen, device=CUDA)
                           * (hi - lo) + lo)
            p.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))   # softplus^-1


def phase12(model):
    """Forward against decode at 1 x 1088 tokens, past the window, so the
    local layers really window.  Returns the gated run's launches and the
    served (JAX-init) model's forward-vs-decode difference."""
    gen = torch.Generator(device=CUDA).manual_seed(120)
    tokens = torch.randint(0, model.cfg.vocab_size, (1, 1088), generator=gen,
                           device=CUDA)
    rel_jax_init, _ = forward_decode_rel(model, tokens)
    log(f"phase 12 (not gated): the served model, JAX init of a_log/dt_bias: "
        f"forward vs decode max relative diff {rel_jax_init:.3e} at 1 x 1088 "
        f"tokens")
    mamba_paper_init(model, 12)
    return forward_against_decode(12, model, 1, 1088), rel_jax_init


def phase13(state, scfg):
    """The decode kernel at hymba's engine shape, on phase 11's final
    cache and lengths, then the scan kernel at one layer of a 2 x 4096
    forward.  Returns the two rows."""
    b, s = SCAN_TIMED
    c, n = HYMBA.ssm_expand * HYMBA.d_model, HYMBA.ssm_state
    log(f"phase 13: decode and scan kernel times on the card (CUDA events, "
        f"median of warm runs, L2 flushed before each; 3.35 TB/s, f32 67 "
        f"TFLOP/s); decode at hymba's engine shape, scan at {b} x {s} x {c}"
        f" x {n} f32")
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=CUDA)
    gen = torch.Generator(device=CUDA).manual_seed(13)
    h, kv, hd = HYMBA.n_heads, HYMBA.n_kv_heads, HYMBA.head_dim
    window = max(layer_windows(HYMBA))
    lens = (state.pos + 1).clamp(max=scfg.max_len).to(torch.int32)
    q = randn((scfg.max_batch, h, hd), F32, gen)
    # max_len 1024 <= the window, so a local layer keeps every key as a
    # global one does: this one row stands for both kinds of layer
    dec = time_decode(
        f"hymba engine B{scfg.max_batch} x S{scfg.max_len} x H{h}/KV{kv} x "
        f"hd{hd}, q f32, bf16 cache, window {window} (keeps every key at "
        f"max_len {scfg.max_len}: local and global layers alike), lengths "
        f"{lens.tolist()}", q, state.k[0], state.v[0], lens, flush,
        window=window)
    del state
    decay, drive, h0 = scan_inputs(b, s, c, n, F32, gen)
    n_el = decay.numel()
    # each input read once, each output written once; 2 operations each
    n_bytes = (decay.numel() + drive.numel() + h0.numel() + n_el) * 4
    bound_ms, by = bound(n_bytes, 2 * n_el, PEAK_F32_S)
    ms = cuda_ms(lambda: kscan.ssm_scan(decay, drive, h0), reps=7,
                 flush=flush)
    plain = cuda_ms(lambda: kscan.ssm_scan_plain(decay, drive, h0), reps=3,
                    warm=1, flush=flush)
    got = kscan.ssm_scan(decay, drive, h0)
    ref = kscan.ssm_scan_plain(decay, drive, h0)
    err = float((got - ref).abs().max())
    check(torch.equal(got, ref), f"timed scan differs from plain by {err}")
    tag = f"B{b} x S{s} x C{c} x N{n} f32"
    log(f"  scan {tag}: kernel {ms:.4f} ms ({n_bytes / ms / 1e6:.1f} GB/s), "
        f"plain {plain:.3f} ms, bound {bound_ms:.4f} ms by {by} "
        f"({n_bytes / 1e9:.3f} GB), {bound_ms / ms:.1%} of bound; library "
        f"none; kernel vs plain max |diff| {err:.2e}")
    return dec, dict(ms=ms, plain_ms=plain, library_ms=None,
                     bound_ms=bound_ms, bound_by=by, shape=tag,
                     max_abs_err=err, share_of_bound=bound_ms / ms)


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log("phase 0: " + smi)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    sources = list(_build.LIBRARIES)             # one nvcc each, at once
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(_build.load_library, sources)))
    log(f"  kernel builds {time.perf_counter() - t0:.2f}s in parallel")
    for name, lib in libs.items():
        log(f"  {name}: nvcc {lib.build_s:.2f}s -> "
            f"{os.path.relpath(lib.path)}")
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line \
                    or "entry function" in line:
                log("    ptxas: " + line.strip())

    demand = fleet_demand_traces(N_NODES, N_STEPS, 0.1, seed=0)
    max_abs = phase1(demand)

    ks.LAUNCHES = 0                        # the main path starts here
    phase2(demand)
    phase3()
    phase4()
    launches = ks.LAUNCHES
    log(f"main path: sweep kernel launched {launches} times")
    check(launches > 0, "the main path never launched the sweep kernel")

    t = phase5(demand)
    off, on = t["cache-off"], t["cache-on"]
    kernel = {
        "name": "sweep_segment", "route": "cuda",
        "source": "src/repro_torch/csrc/sweep.cu",
        "replaces": "src/repro/lab/pallas_sweep.py:305",
        "launches": launches, "max_abs_err": max_abs,
        "ms": off["ms"], "plain_ms": off["plain_ms"],
        "bound_ms": off["bound_ms"], "bound_by": off["bound_by"],
        "library_ms": None,
        "cache_on": {"ms": on["ms"], "plain_ms": on["plain_ms"],
                     "bound_ms": on["bound_ms"], "bound_by": on["bound_by"]},
        "finalize_ms": {"cache-off": off["finalize_ms"],
                        "cache-on": on["finalize_ms"]},
        "shape": "4096 nodes x 1000 intervals x 64 gains, f32, paper law",
    }

    errs = phase6()
    eng, n_decode, served = serve_full_width(7, FULL_WIDTH, smi)
    n_flash = forward_against_decode(8, eng.model, 2, 256)["flash"]
    launches = {"decode": n_decode, "flash": n_flash}
    log(f"main path: decode attention launched {n_decode} times (phase 7), "
        f"flash attention {n_flash} times (phase 8's forward)")
    check(min(launches.values()) > 0,
          "the serving path skipped an attention kernel")
    state, scfg = eng.state, eng.cfg
    del eng                                # free the weights for phase 9
    t = phase9(state, scfg)
    del state
    dec, dec32, fl = t["decode_engine"], t["decode_32k"], t["flash"]
    decode = {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:28",
        "launches": launches["decode"],
        "max_abs_err": max(*errs["decode"].values(), dec["max_abs_err"],
                           dec32["max_abs_err"]),
        "max_abs_err_f32": max(errs["decode"]["f32"], dec["max_abs_err"]),
        **{k: dec[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "shape", "splits", "gb_s")},
        "decode_32k": dec32,
    }
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "shape", "max_abs_err", "tflop_s")
    flash = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:28",
        "launches": launches["flash"],
        "max_abs_err": max(*errs["flash"].values(), fl["max_abs_err"]),
        "max_abs_err_f32": max(errs["flash"]["f32"],
                               t["flash_f32"]["max_abs_err"],
                               *(r["max_abs_err"] for r in t["flash_main"])),
        **{k: fl[k] for k in timed if k != "max_abs_err"},
        "f32": {k: t["flash_f32"][k] for k in timed},
        "main_path_shapes": [
            {k: r[k] for k in timed + ("model", "launches_per_forward")}
            for r in t["flash_main"]],
    }
    serving = {k: served[k] for k in ("tok_s", "steps_s", "seconds",
                                      "steps", "preemptions")}
    log(f"serving {ARCH}: " + json.dumps(serving))

    scan_err, hymba_errs = phase10()
    eng, n_decode_h, served_h = serve_full_width(11, FULL_WIDTH_HYMBA, smi)
    n_fwd, rel_jax_init = phase12(eng.model)
    log(f"main path: decode attention launched {n_decode_h} times (phase "
        f"11), flash attention {n_fwd['flash']} and the scan "
        f"{n_fwd['scan']} times (phase 12's forward)")
    check(min(n_decode_h, *n_fwd.values()) > 0,
          "the hybrid serving path skipped a kernel")
    state, scfg = eng.state, eng.cfg
    del eng                                # free the weights
    torch.cuda.empty_cache()
    dec_h, sc = phase13(state, scfg)
    del state
    decode["hymba_engine"] = dec_h
    for name, d in (("decode", decode), ("flash", flash)):
        d["max_abs_err"] = max(d["max_abs_err"], *hymba_errs[name].values())
        d["max_abs_err_f32"] = max(d["max_abs_err_f32"],
                                   hymba_errs[name]["f32"])
    decode["max_abs_err_f32"] = max(decode["max_abs_err_f32"],
                                    dec_h["max_abs_err"])
    decode["launches"] = n_decode + n_decode_h
    decode["launches_by_path"] = {f"{ARCH} serving (phase 7)": n_decode,
                                  f"{HYMBA.name} serving (phase 11)":
                                  n_decode_h}
    flash["launches"] = n_flash + n_fwd["flash"]
    flash["launches_by_path"] = {f"{ARCH} forward (phase 8)": n_flash,
                                 f"{HYMBA.name} forward (phase 12)":
                                 n_fwd["flash"]}
    scan = {
        "name": "ssm_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan/kernel.py:25",
        "launches": n_fwd["scan"],
        "launches_by_path": {f"{HYMBA.name} forward (phase 12)":
                             n_fwd["scan"]},
        "max_abs_err": max(scan_err, sc["max_abs_err"]),
        **{k: sc[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "share_of_bound", "shape")},
    }
    serving_h = {k: served_h[k] for k in ("tok_s", "steps_s", "seconds",
                                          "steps", "preemptions")}
    serving_h["forward_vs_decode_jax_init"] = rel_jax_init
    log(f"serving {HYMBA.name}: " + json.dumps(serving_h))
    print(smi)
    print(json.dumps({"kernels": [kernel, decode, flash, scan]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
