"""The CUDA kernels on the card, held against their plain PyTorch versions.

Marked ``cuda``: each test skips, with its reason, where no CUDA card is
present (a CUDA kernel has no CPU mode).  On a machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` makes the same comparisons at the main path's sizes.
Tolerances of the attention kernels are those of
``tests/test_kernels.py``: 2e-5 in float32, 3e-2 (decode) and 2e-2
(flash) in bfloat16.  The sweep without the cache (state and p99
histogram) and the scan are held bit for bit, the sweep's AppGraph
instance too, where one block holds a lane and where a barrier joins
several; with the cache to 1e-6 and an equal makespan.  The live plane on the
card: the device monitor's counters follow a tensor, a card plane's
actions equal a CPU plane's bit for bit, a tick adds one sync (its
readback), and it does not wait for work queued on the default stream.
"""

import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import (ControllerParams, DeviceMemoryMonitor,
                              MemoryPlane, NodeSpec, PlaneSpec,
                              SimulatedMonitor, StoreRegistry)
from repro_torch.core.traces import GiB, fleet_demand_traces
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssm_scan as ks_scan
from repro_torch.kernels import sweep as ks
from repro_torch.lab import fused_sweep as fs
from repro_torch.lab.scenarios import get_scenario
from repro_torch.lab.score import quantile_from_hist, stats_mismatches
from repro_torch.lab.sweep import plan_specialization, run_sweep
from repro_torch.lab.tune import grid_gains, retune_online
from repro_torch.launch.profile_serve import count_syncs
from repro_torch.launch.serve import build_engine, prompts
from repro_torch.models import Model, decode as D

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _segment_on_card(card, demand, law, cache, n_dead=2):
    gains = grid_gains(lam=np.linspace(0.2, 1.8, 4), r0=(0.9, 0.95),
                       lam_grant=(None,) if law == "paper" else (0.25,))
    spec = get_scenario("spark-iterative-cache").cache if cache else None
    con = fs._engine_consts(plan_specialization(gains), spec, 0.1, 1.0,
                            "f32")
    names = ks.state_names(con.paper_law, con.has_cache)
    n_nodes = demand.shape[0]
    dtn, rows, lp = fs._stage(demand, gains, np.full(n_nodes, 125 * GiB),
                              spec, "f32", card)
    alive = fs._alive(len(gains), len(gains) - n_dead, card)
    state0 = fs._init_state(lp, rows, dtn[0], con, names)
    return (state0, fs._zero_hist(lp), dtn, lp, rows, alive), \
        dict(t0=3, con=con, names=names)


@pytest.mark.parametrize("law", ["paper", "generic"])
@pytest.mark.parametrize("cache", [False, True])
def test_kernel_matches_plain_version(card, law, cache):
    n_nodes, n_steps = 300, 80
    demand = fleet_demand_traces(n_nodes, n_steps, 0.1, seed=1)
    args, kw = _segment_on_card(card, demand, law, cache)
    before = ks.LAUNCHES
    sk, hk = ks.sweep_segment(*args, **kw)
    assert ks.LAUNCHES == before + 1
    sp, hp = ks.sweep_segment_plain(*args, **kw)
    torch.cuda.synchronize()
    assert int(hk[-2:].abs().sum()) == 0          # dead lanes count nothing
    assert hk.sum(1).tolist()[:-2] == [n_nodes * n_steps] * (len(hk) - 2)
    if cache:
        scale = sp.abs().amax(dim=(1, 2), keepdim=True).clamp_min(1e-30)
        assert float(((sk - sp).abs() / scale).max()) <= 1e-6
        # the float64 power may move a rare code across a bin edge: each
        # such update moves one count between two bins; the p99 holds
        live = len(hk) - 2
        n_bins = int((hk != hp).sum())
        print(f"cache-on: {n_bins} histogram bins differ")
        assert n_bins <= live
        n = n_nodes * n_steps
        assert torch.equal(quantile_from_hist(hk[:live], 0.99, n),
                           quantile_from_hist(hp[:live], 0.99, n))
    else:
        assert torch.equal(sk, sp)
        assert torch.equal(hk, hp)


def test_kernel_histogram_under_full_contention(card):
    """Every node sees the same demand, so every warp adds to one bin at
    each interval: each live lane still counts T x N updates, as the
    plain version does."""
    n_nodes, n_steps = 300, 80
    one = fleet_demand_traces(1, n_steps, 0.1, seed=2)
    args, kw = _segment_on_card(card, np.repeat(one, n_nodes, axis=0),
                                "paper", False)
    sk, hk = ks.sweep_segment(*args, **kw)
    sp, hp = ks.sweep_segment_plain(*args, **kw)
    torch.cuda.synchronize()
    assert hk.sum(1).tolist() == [n_nodes * n_steps] * (len(hk) - 2) + [0, 0]
    assert torch.equal(hk, hp) and torch.equal(sk, sp)


def test_run_sweep_on_the_card_matches_the_cpu(card):
    spec = get_scenario("swap-storm").replace(n_nodes=64, n_intervals=200)
    gains = grid_gains(lam=(0.5, 1.0, 1.6), r0=(0.9, 0.95),
                       lam_grant=(None, 0.25))
    a = run_sweep(spec, gains)
    b = run_sweep(spec, gains, device="cpu")
    assert stats_mismatches(a.stats, b.stats, n_samples=64 * 200) == []
    assert a.best() == b.best()


def _graph_segment(card, spec, law, n_dead=2):
    gains = grid_gains(lam=np.linspace(0.2, 1.8, 4), r0=(0.9, 0.95),
                       lam_grant=(None,) if law == "paper" else (0.25,))
    con = fs._engine_consts(plan_specialization(gains), spec.cache,
                            spec.interval_s, 1.0, "f32", spec.app_graph)
    names = ks.state_names(con.paper_law, con.has_cache, True)
    dtn, rows, lp = fs._stage(spec.build_demand(seed=2), gains, 125 * GiB,
                              spec.cache, "f32", card)
    graph, total = fs._stage_graph(spec.app_graph, spec.n_nodes, card)
    alive = fs._alive(len(gains), len(gains) - n_dead, card)
    state0 = fs._init_state(lp, rows, dtn[0], con, names, graph)
    return ((state0, fs._zero_hist(lp), dtn, lp, rows, alive),
            dict(t0=0, con=con, names=names, graph=graph), total)


# (scenario, nodes, intervals): one block a lane (limplock 8, spark-dag
# 16), several (300 nodes: 2 blocks, 3 with the cache), the cache-on
# 4096-node fleet (32 blocks a lane), a horizon the DAG finishes in
GRAPH_CARD_CASES = [("limplock", 8, 1200), ("spark-dag", 16, 600),
                    ("limplock", 300, 1000), ("spark-dag", 300, 400),
                    ("spark-dag", 4096, 200)]


@pytest.mark.parametrize("case", GRAPH_CARD_CASES, ids=str)
@pytest.mark.parametrize("law", ["paper", "generic"])
def test_graph_instance_matches_plain_version(card, case, law):
    name, n_nodes, n_steps = case
    spec = get_scenario(name).replace(n_nodes=n_nodes, n_intervals=n_steps)
    args, kw, total = _graph_segment(card, spec, law)
    limit = ks.graph_lane_limit(kw["con"], n_nodes, card)
    assert (limit is None) == (n_nodes <= ks.block_nodes(spec.cache
                                                         is not None))
    before = ks.LAUNCHES
    sk, hk = ks.sweep_segment(*args, **kw)
    assert ks.LAUNCHES == before + 1
    sp, hp = ks.sweep_segment_plain(*args, **kw)
    torch.cuda.synchronize()
    live = len(hk) - 2
    assert torch.equal(sk[:, live:], args[0][:, live:])     # dead lanes
    names, lp = kw["names"], args[3]
    mk = fs._finalize_lanes(sk, hk, lp, kw["con"], names, n_steps, total)
    mp = fs._finalize_lanes(sp, hp, lp, kw["con"], names, n_steps, total)
    assert torch.equal(mk.makespan, mp.makespan)
    if spec.cache is None:
        assert torch.equal(sk, sp) and torch.equal(hk, hp)
    else:
        scale = sp.abs().amax(dim=(1, 2), keepdim=True).clamp_min(1e-30)
        assert float(((sk - sp).abs() / scale).max()) <= 1e-6
        assert int((hk != hp).sum()) <= live


def test_graph_lane_chunk_that_cannot_be_resident_raises(card):
    """The multi-block route launches cooperatively: a lane chunk past
    co-residency is refused, never left to hang, and the largest one
    that fits runs."""
    spec = get_scenario("limplock").replace(n_nodes=4096, n_intervals=20)
    args, kw, _ = _graph_segment(card, spec, "paper", n_dead=0)
    state0, hist0, dtn, lp, rows, alive = args
    limit = ks.graph_lane_limit(kw["con"], 4096, card)

    def lanes(n):
        reps = -(-n // lp.shape[1])
        return (torch.cat([state0] * reps, 1)[:, :n].contiguous(),
                torch.cat([hist0] * reps, 0)[:n].contiguous(), dtn,
                torch.cat([lp] * reps, 1)[:, :n].contiguous(), rows,
                torch.cat([alive] * reps, 1)[:, :n].contiguous())

    with pytest.raises(RuntimeError, match="CUDA error"):
        ks.sweep_segment(*lanes(limit + 1), **kw)
    torch.cuda.synchronize()
    state, _ = ks.sweep_segment(*lanes(limit), **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(state).all())


def test_app_graph_sweeps_on_the_card_match_the_cpu(card):
    for name in ("spark-dag", "limplock"):
        spec = get_scenario(name).replace(n_intervals=300)
        gains = grid_gains(lam=(0.5, 1.0, 1.6), r0=(0.9, 0.95),
                           lam_grant=(None, 0.25))
        a = run_sweep(spec, gains)
        b = run_sweep(spec, gains, device="cpu")
        assert stats_mismatches(a.stats, b.stats,
                                n_samples=spec.n_nodes * 300) == []
        np.testing.assert_array_equal(a.stats.makespan, b.stats.makespan)


def _randn(card, shape, dtype, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    return torch.randn(shape, generator=g, device=card).to(dtype)


# ((b, s, h, kv, hd, window), lengths or None for [1, S, S/2 + 3, S - 7,
# ...]): the first two as before; one (sequence, kv head) pair split the
# most; 320 pairs, one split each; head dims 16 and 128 with len 0 and 1
# in one batch; windows that start mid-tile; 16 query heads per kv head
# (two head sets of warps); hymba's 25/5 heads with its window.
DECODE_CARD_CASES = [((4, 512, 8, 2, 64, 0), None),
                     ((3, 1000, 8, 4, 64, 200), None),
                     ((1, 4000, 4, 1, 64, 0), [4000]),
                     ((40, 300, 32, 8, 64, 0), None),
                     ((4, 700, 8, 2, 16, 0), [0, 1, 700, 333]),
                     ((4, 900, 16, 4, 128, 0), [0, 1, 900, 555]),
                     ((3, 777, 8, 2, 64, 100), [777, 0, 150]),
                     ((2, 500, 16, 1, 64, 0), [500, 37]),
                     ((4, 1500, 25, 5, 64, 1024), [1, 1025, 1500, 1337])]


@pytest.mark.parametrize("case,lens", DECODE_CARD_CASES, ids=str)
@pytest.mark.parametrize("qdt,kdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.bfloat16)],
                         ids=["f32", "bf16", "f32-over-bf16"])
def test_decode_kernel_matches_plain_version(card, case, lens, qdt, kdt):
    b, s, h, kv, hd, window = case
    q = _randn(card, (b, h, hd), qdt, 1)
    kc = _randn(card, (b, s, kv, hd), kdt, 2)
    vc = _randn(card, (b, s, kv, hd), kdt, 3)
    if lens is None:
        lens = [1, s, s // 2 + 3][:b] + [s - 7] * (b - 3)
    lens = torch.tensor(lens, dtype=torch.int32, device=card)
    before = da.LAUNCHES
    out = da.decode_attention(q, kc, vc, lens, window=window)
    assert da.LAUNCHES == before + 1
    ref = da.decode_attention_plain(q, kc, vc, lens, window=window)
    torch.cuda.synchronize()
    tol = 3e-2 if qdt == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    # the partials merge in a fixed order: the same bits on every call
    assert torch.equal(out, da.decode_attention(q, kc, vc, lens,
                                                window=window))


@pytest.mark.parametrize("window", [0, 600])   # the 700-key sequence
@pytest.mark.parametrize("kdt", [torch.float32, torch.bfloat16],  # runs
                         ids=["f32", "bf16"])                     # in 2 parts
def test_decode_kernel_never_reads_past_length(card, window, kdt):
    b, s, h, kv, hd = 2, 1024, 4, 2, 64
    assert da.choose_splits(b, kv, s, h // kv,
                            da.sm_count(card.index or 0)) > 1
    q = _randn(card, (b, h, hd), torch.float32, 4)
    kc = _randn(card, (b, s, kv, hd), kdt, 5)
    vc = _randn(card, (b, s, kv, hd), kdt, 6)
    lens = torch.tensor([700, 17], dtype=torch.int32, device=card)
    out1 = da.decode_attention(q, kc, vc, lens, window=window)
    pos = torch.arange(s, device=card)[None]
    dead = pos >= lens[:, None]
    if window:
        dead |= pos < lens[:, None] - window
    dead = dead[..., None, None]
    out2 = da.decode_attention(q, kc.masked_fill(dead, float("nan")),
                               vc.masked_fill(dead, float("nan")), lens,
                               window=window)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out2).all()) and torch.equal(out1, out2)


@pytest.mark.parametrize("case", [(2, 256, 256, 4, 2, 64, True, 0),
                                  (2, 192, 192, 4, 2, 64, True, 48),
                                  (2, 77, 77, 4, 2, 16, True, 0),
                                  (1, 77, 333, 8, 2, 128, False, 0),
                                  (2, 200, 200, 4, 1, 128, True, 40),
                                  (1, 61, 300, 4, 4, 16, False, 0),
                                  (1, 100, 300, 2, 1, 32, False, 50),
                                  (2, 77, 77, 25, 5, 16, True, 50),
                                  (1, 77, 300, 25, 5, 128, False, 0)],
                         ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernel_matches_plain_version(card, case, dtype):
    b, sq, skv, h, kv, hd, causal, window = case
    q = _randn(card, (b, sq, h, hd), dtype, 7)
    k = _randn(card, (b, skv, kv, hd), dtype, 8)
    v = _randn(card, (b, skv, kv, hd), dtype, 9)
    before = fa.LAUNCHES
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.LAUNCHES == before + 1
    ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("case", [(2, 256, 128, 16), (1, 128, 256, 8),
                                  (3, 64, 128, 4), (2, 1, 3200, 16),
                                  (1, 300, 3200, 16), (2, 37, 5, 3)],
                         ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_scan_kernel_is_bit_identical_to_plain_version(card, case, dtype):
    b, s, c, n = case
    decay = torch.rand((b, s, c, n), device=card,
                       generator=torch.Generator(device=card).manual_seed(10)
                       ).mul(0.7).add(0.3).to(dtype)
    drive = _randn(card, (b, s, c, n), dtype, 11).mul(0.2)
    h0 = _randn(card, (b, c, n), torch.float32, 12)
    before = ks_scan.LAUNCHES
    out = ks_scan.ssm_scan(decay, drive, h0)
    assert ks_scan.LAUNCHES == before + 1
    ref = ks_scan.ssm_scan_plain(decay, drive, h0)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def test_scan_kernel_carries_h0_across_calls(card):
    decay = torch.full((1, 128, 128, 8), 0.99, device=card)
    drive = torch.full((1, 128, 128, 8), 0.01, device=card)
    h0 = torch.ones((1, 128, 8), device=card)
    whole = ks_scan.ssm_scan(decay, drive, h0)
    first = ks_scan.ssm_scan(decay[:, :50], drive[:, :50], h0)
    second = ks_scan.ssm_scan(decay[:, 50:], drive[:, 50:], first[:, -1])
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([first, second], dim=1), whole)


def test_hybrid_forward_launches_the_scan_once_per_layer(card):
    cfg = get_config("hymba-1.5b-smoke")
    model = Model(cfg, seed=0, device=card)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), device=card)
    before = (ks_scan.LAUNCHES, fa.LAUNCHES)
    fwd = model(tokens)
    assert (ks_scan.LAUNCHES - before[0], fa.LAUNCHES - before[1]) == \
        (cfg.n_layers, cfg.n_layers)
    state = D.init_state(model, 2, 64, cache_dtype="float32")
    dec = torch.cat([D.decode_step(model, state, tokens[:, t:t + 1])
                     for t in range(40)], dim=1)
    rel = float((fwd - dec).abs().max() / fwd.abs().max())
    assert bool(torch.isfinite(fwd).all()) and rel < 5e-3


def test_device_monitor_follows_a_tensor(card):
    mon = DeviceMemoryMonitor(card, node="n0")
    assert mon.node == "n0" and mon.total == torch.cuda.mem_get_info()[1]
    assert mon.total != mon.assumed_total
    with count_syncs() as syncs:
        before = mon.sample()
    assert [(str(w.message), w.filename, w.lineno) for w in syncs] == []
    n = 256 * 2**20
    t = torch.empty(n, dtype=torch.uint8, device=card)
    during = mon.sample()
    del t
    after = mon.sample()
    assert during.used - before.used == n
    assert after.used == before.used


def _card_fleet(device, variant, n=256, t=30):
    """tests/test_plane.py's heterogeneous fleet, on one device."""
    rng = np.random.default_rng(42)
    M = rng.uniform(64, 256, n) * GiB
    u_max = rng.uniform(20, 60, n) * GiB
    u_min = rng.uniform(0, 5, n) * GiB
    u0 = rng.uniform(u_min, u_max)
    base = ControllerParams(total_memory=125 * GiB)
    if variant == "paper":
        demand = rng.uniform(0.5, 1.05, (n, t)) * M[:, None]
    else:
        base = base.replace(feedforward=0.5, deadband=0.015, lam_grant=0.25)
        offsets = np.array([-0.25, -0.10, -0.04, 0.02, 0.06, 0.12])
        levels = rng.choice(offsets, size=(n, t // 5 + 1))
        demand = (base.r0 + np.repeat(levels, 5, axis=1)[:, :t]) * M[:, None]
    nodes = tuple(
        NodeSpec(f"n{i}", monitor=SimulatedMonitor(f"n{i}", total=M[i],
                                                   usage=demand[i]),
                 registry=StoreRegistry(), u0=u0[i],
                 params=base.replace(total_memory=M[i], u_min=u_min[i],
                                     u_max=u_max[i]))
        for i in range(n))
    return MemoryPlane(PlaneSpec(params=base, nodes=nodes, device=device))


@pytest.mark.parametrize("variant", ["paper", "extended"])
def test_card_plane_equals_cpu_plane(card, variant):
    on_card, on_cpu = _card_fleet(card, variant), _card_fleet("cpu", variant)
    for _ in range(30):
        a, b = on_card.tick(), on_cpu.tick()
        assert [(x.node, x.u_prev, x.u_next) for x in a] == \
            [(x.node, x.u_prev, x.u_next) for x in b]


def _one_node_plane(card):
    plane = MemoryPlane(PlaneSpec(
        params=ControllerParams(total_memory=80 * GiB), device=card))
    plane.attach("n0", DeviceMemoryMonitor(card, node="n0"),
                 registry=StoreRegistry(), u0=GiB)
    return plane


def test_a_tick_adds_one_sync(card):
    plane = _one_node_plane(card)
    plane.tick()
    torch.cuda.synchronize()
    with count_syncs() as syncs:
        for _ in range(5):
            assert len(plane.tick()) == 1
    assert len(syncs) == 5


def test_a_tick_does_not_wait_for_the_default_stream(card):
    plane = _one_node_plane(card)
    plane.tick()
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)           # ~1 s on the default stream
    queued = torch.cuda.Event()
    queued.record()
    t0 = time.perf_counter()
    plane.tick()
    tick_s = time.perf_counter() - t0
    busy = not queued.query()
    torch.cuda.synchronize()
    assert busy, "the default stream drained before the tick returned"
    assert tick_s < 0.2


def _recorded_capture(device, n=5, t=120):
    """A saturated-store plane over swap-storm demand, ticked ``t``
    times while recording (tests/test_replay.py's plane)."""
    spec = get_scenario("swap-storm").replace(n_nodes=n, n_intervals=t)
    demand = spec.build_demand(seed=0)
    params = ControllerParams(total_memory=125 * GiB)
    plane = MemoryPlane(PlaneSpec(params=params, record=t, device=device))
    for i in range(n):
        name = f"node{i}"
        plane.attach(name, SimulatedMonitor(
            name, total=125 * GiB,
            usage=lambda k, row=demand[i]: float(row[k % t]),
            storage_used_fn=lambda nm=name: plane.capacity(nm)),
            registry=StoreRegistry(), u0=params.u_max)
    for _ in range(t):
        plane.tick()
    return plane


def test_retune_on_the_card_makes_the_cpu_decision(card):
    plane = _recorded_capture(card)
    cap = plane.capture()
    before = ks.LAUNCHES
    got = retune_online(plane, capture=cap, budget=24, swap=False,
                        device=card)
    assert ks.LAUNCHES > before
    ref = retune_online(plane, capture=cap, budget=24, swap=False,
                        device="cpu")
    for f in ("r0", "lam", "lam_grant", "deadband", "feedforward"):
        np.testing.assert_array_equal(getattr(got.tune.sweep.gains, f),
                                      getattr(ref.tune.sweep.gains, f))
    assert got.params == ref.params and got.tune.index == ref.tune.index
    assert not stats_mismatches(got.tune.sweep.stats, ref.tune.sweep.stats,
                                n_samples=cap.demand.size)


def test_a_retune_round_does_not_wait_for_the_default_stream(card):
    plane = _recorded_capture(card)
    cap = plane.capture()
    retune_online(plane, capture=cap, budget=8, swap=False, device=card)
    torch.cuda.synchronize()                   # built and warm
    torch.cuda._sleep(2_000_000_000)           # ~1 s on the default stream
    queued = torch.cuda.Event()
    queued.record()
    t0 = time.perf_counter()
    retune_online(plane, capture=cap, budget=8, swap=False, device=card)
    round_s = time.perf_counter() - t0
    busy = not queued.query()
    torch.cuda.synchronize()
    assert busy, "the default stream drained before the round returned"
    assert round_s < 0.5


def test_a_nonblocking_round_while_the_engine_steps(card):
    eng = build_engine("llama3.2-1b-smoke", record=2048, device=card)
    eng.run_until_drained()
    first = eng.steps
    before = ks.LAUNCHES
    handle = retune_online(eng.plane, name="kv-pool-replay", budget=16,
                           restarts=2, block=False, device=card)
    for p in prompts(eng.model.cfg.vocab_size, 16, 0, 18)[12:]:
        eng.submit(p, max_new_tokens=16)
    while not handle.done:
        eng.step()
    result = handle.result()
    eng.run_until_drained()
    assert ks.LAUNCHES > before
    assert result.capture.n_intervals >= first
    assert result.epoch == (1 if result.swapped else None)
    health = eng.plane.health()
    assert health.ticks == eng.steps and health.healthy
    acts = eng.plane.actions()
    assert len(acts) == eng.steps
    epochs = [a.epoch for a in acts]
    assert epochs == sorted(epochs) and epochs[-1] == eng.plane.epoch
    assert len(eng.finished) == 18
