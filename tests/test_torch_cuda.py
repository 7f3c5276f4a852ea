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
Training: the kernels refuse CUDA inputs that require grad, a batch
staged through the pipeline's pinned buffer arrives intact, and a few
train steps of each smoke model (llama3.2-1b, hymba-1.5b, gemma3-1b,
qwen2-1.5b) on the card follow the CPU's.  The attention kernels also
at gemma3-1b's head dim of 256, qwen2-1.5b's group of 6 and
qwen2-moe-a2.7b's group of 1, and at the cross-attention families'
shapes: non-causal at hd 64 (whisper-large-v3's encoder, group 1) and
hd 128 with Sq > Skv (llama-3.2-vision-11b's cross layers), a cross cache
read whole, and a cross cache at length 0 (zeros).  One moe layer
(``moe_apply``) on the card against the CPU, with and without drops: the
same choices kept.  The sweep's one-interval graph entry over node
shards of the card against its plain version on the CPU, and the
sharded sweeps over four shards of one card against one device.
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


# (scenario, nodes, intervals) at every edge of the graph instance's
# routes (kernels/sweep.py::graph_route): one warp of one loop a thread
# (8, 16, 32 nodes) and of the wide loops (33, 64 with the cache, 128),
# one block (65, 129, 300, 512, 1024), one cluster (513, 1025, 2048,
# 4096; of the smaller blocks at their largest, 8192 and 16384, and one
# node more, of the larger; the largest, 16384 and 32768 where the card
# schedules 16 blocks) and the cooperative route one node past it
# (16385, 32769); limplock 8 at a horizon the DAG finishes in
GRAPH_CARD_CASES = [("limplock", 8, 1200), ("spark-dag", 16, 600),
                    ("limplock", 32, 600), ("limplock", 33, 600),
                    ("limplock", 128, 600), ("limplock", 129, 600),
                    ("spark-dag", 64, 400), ("spark-dag", 65, 400),
                    ("limplock", 300, 1000), ("spark-dag", 300, 400),
                    ("spark-dag", 512, 200), ("spark-dag", 513, 200),
                    ("limplock", 1024, 200), ("limplock", 1025, 200),
                    ("limplock", 2048, 200), ("spark-dag", 4096, 200),
                    ("limplock", 4096, 200),
                    ("spark-dag", 8192, 100), ("spark-dag", 8193, 100),
                    ("limplock", 16384, 100), ("limplock", 16385, 100),
                    ("spark-dag", 16384, 60), ("spark-dag", 16385, 60),
                    ("limplock", 32768, 60), ("limplock", 32769, 60)]


@pytest.mark.parametrize("case", GRAPH_CARD_CASES, ids=str)
@pytest.mark.parametrize("law", ["paper", "generic"])
def test_graph_instance_matches_plain_version(card, case, law):
    name, n_nodes, n_steps = case
    spec = get_scenario(name).replace(n_nodes=n_nodes, n_intervals=n_steps)
    args, kw, total = _graph_segment(card, spec, law)
    rows = kw["graph"][1].shape[1]
    route = ks.graph_plan(kw["con"], n_nodes, card, rows)
    print(f"{name} {n_nodes}: {route}")
    assert (route.lanes is None) == (not route.cooperative)
    assert ks.graph_lane_limit(kw["con"], n_nodes, card, rows) == route.lanes
    # one launch, or as many as the cooperative route's co-residency asks
    state0, hist0, dtn, lp, node_rows, alive = args
    limit = route.lanes or lp.shape[1]
    before = ks.LAUNCHES
    outs = [ks.sweep_segment(state0[:, lo:lo + limit].contiguous(),
                             hist0[lo:lo + limit].contiguous(), dtn,
                             lp[:, lo:lo + limit].contiguous(), node_rows,
                             alive[:, lo:lo + limit].contiguous(), **kw)
            for lo in range(0, lp.shape[1], limit)]
    assert ks.LAUNCHES == before + -(-lp.shape[1] // limit)
    sk = torch.cat([o[0] for o in outs], 1)
    hk = torch.cat([o[1] for o in outs], 0)
    sp, hp = ks.sweep_segment_plain(*args, **kw)
    torch.cuda.synchronize()
    live = len(hk) - 2
    assert torch.equal(sk[:, live:], args[0][:, live:])     # dead lanes
    assert int(hk[live:].abs().sum()) == 0
    names = kw["names"]
    t_done = sk[names.index("t_done")][:live]
    assert bool((t_done == t_done[:, :1]).all())
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
    """Past the largest cluster the lane's blocks meet in device memory,
    a cooperative launch: a lane chunk past co-residency is refused,
    never left to hang, and the largest one that fits runs."""
    base = get_scenario("limplock")
    kw0 = _graph_segment(card, base, "paper")[1]
    stage_rows = kw0["graph"][1].shape[1]       # S + 1, whatever the nodes
    n_nodes = ks.block_nodes(False) * ks.graph_limits(
        kw0["con"], card, stage_rows).max_cluster + 1
    spec = base.replace(n_nodes=n_nodes, n_intervals=20)
    args, kw, _ = _graph_segment(card, spec, "paper", n_dead=0)
    state0, hist0, dtn, lp, rows, alive = args
    route = ks.graph_plan(kw["con"], n_nodes, card, stage_rows)
    assert route.cooperative
    limit = route.lanes

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


def test_a_cluster_launch_holds_every_lane(card):
    """A lane one cluster holds needs only its own blocks resident: 4096
    nodes at 256 lanes, far more than the card holds at once, run in one
    launch and match the plain version."""
    spec = get_scenario("limplock").replace(n_nodes=4096, n_intervals=30)
    args, kw, _ = _graph_segment(card, spec, "paper", n_dead=0)
    state0, hist0, dtn, lp, rows, alive = args
    reps = 256 // lp.shape[1]
    wide = (torch.cat([state0] * reps, 1).contiguous(),
            torch.cat([hist0] * reps, 0).contiguous(), dtn,
            torch.cat([lp] * reps, 1).contiguous(), rows,
            torch.cat([alive] * reps, 1).contiguous())
    assert ks.graph_plan(kw["con"], 4096, card,
                         kw["graph"][1].shape[1]).name == "cluster"
    before = ks.LAUNCHES
    sk, hk = ks.sweep_segment(*wide, **kw)
    assert ks.LAUNCHES == before + 1
    sp, hp = ks.sweep_segment_plain(*wide, **kw)
    torch.cuda.synchronize()
    assert torch.equal(sk, sp) and torch.equal(hk, hp)


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


def _exchange(device, spec, gains, n_shards):
    """The one-interval graph entry over ``n_shards`` node shards of
    ``device`` (streams of their own on the card), the state's nodes in
    order and the histograms summed, on the CPU."""
    from repro_torch.lab import mesh
    con = fs._engine_consts(plan_specialization(gains), spec.cache, 0.1,
                            1.0, "f32", spec.app_graph)
    names = ks.state_names(con.paper_law, con.has_cache, True)
    demand = spec.build_demand(seed=0)
    work, stage, _ = fs._graph_host(spec.app_graph, spec.n_nodes)
    cols = spec.n_nodes // n_shards
    ops = []
    for j in range(n_shards):
        c = slice(j * cols, (j + 1) * cols)
        dtn, rows, lp = fs._stage(demand[c], gains, 125 * GiB, spec.cache,
                                  "f32", device)
        g = (torch.from_numpy(np.ascontiguousarray(work[:, c])).to(device),
             torch.from_numpy(stage).to(device))
        alive = fs._alive(len(gains), len(gains) - 1, device)
        ops.append((fs._init_state(lp, rows, dtn[0], con, names, g),
                    fs._zero_hist(lp), dtn, lp, rows, alive, g))
    states = [o[0] for o in ops]
    hists = [o[1] for o in ops]
    mesh.graph_exchange([mesh.Shard(torch.device(device)) for _ in ops],
                        states, hists, *[list(x) for x in zip(*ops)][2:],
                        t0=0, con=con, names=names)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return torch.cat(states, -1).cpu(), sum(h.cpu() for h in hists), names


@pytest.mark.parametrize("cache", [False, True])
def test_graph_interval_entry_matches_plain_version(card, cache):
    """The one-interval entry over 2 node shards of the card (512 nodes
    each: several blocks a lane) equals its plain version on the CPU:
    bit for bit without the cache, to 1e-6 with it (the stage rows and
    finish intervals exact)."""
    spec = get_scenario("limplock").replace(n_nodes=1024, n_intervals=600)
    spec = spec.replace(app_graph=spec.app_graph.replace(
        iterations=1, slow_nodes=(700,)),
        **({"cache": get_scenario("spark-iterative-cache").cache}
           if cache else {}))
    gains = grid_gains(lam=(0.5, 1.0, 1.6), r0=(0.9, 0.95))
    before = ks.INTERVAL_LAUNCHES
    sk, hk, names = _exchange(card, spec, gains, 2)
    assert ks.INTERVAL_LAUNCHES - before == 2 * (600 + 2)
    sp, hp, _ = _exchange("cpu", spec, gains, 2)
    for plane in ("sidx", "t_done"):
        assert torch.equal(sk[names.index(plane)], sp[names.index(plane)])
    if cache:
        torch.testing.assert_close(sk, sp, rtol=1e-6, atol=0.0)
    else:
        assert torch.equal(sk, sp) and torch.equal(hk, hp)


def test_sharded_sweeps_on_one_card_match_one_device(card):
    """Four shards of one card: gain shards bit for bit, node shards
    within the brackets and AppGraph's makespan exact."""
    demand = fleet_demand_traces(256, 300, 0.1, seed=3)
    gains = grid_gains(lam=(0.3, 0.6, 0.9, 1.2), r0=(0.9, 0.95))
    four = ("cuda:0",) * 4
    kw = dict(node_memory=125 * GiB)
    from repro_torch.lab.sweep import sweep_demand
    one = sweep_demand(demand, gains, devices=1, **kw)
    got = sweep_demand(demand, gains, devices=four, **kw)
    for f in one._fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(one, f))
    got = sweep_demand(demand, gains, devices=four, node_shards=4, **kw)
    assert stats_mismatches(got, one, n_samples=256 * 300) == []
    spec = get_scenario("spark-dag").replace(n_intervals=300)
    a = run_sweep(spec, gains, devices=1)
    b = run_sweep(spec, gains, devices=four, node_shards=4)
    np.testing.assert_array_equal(b.stats.makespan, a.stats.makespan)
    assert stats_mismatches(b.stats, a.stats,
                            n_samples=spec.n_nodes * 300) == []


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
                     ((4, 1500, 25, 5, 64, 1024), [1, 1025, 1500, 1337]),
                     # gemma3-1b's 4/1 heads of 256, window 512; two head
                     # sets at hd 256; qwen2-1.5b's group of 6
                     ((8, 1024, 4, 1, 256, 512), None),
                     ((4, 900, 16, 4, 256, 0), [0, 1, 900, 555]),
                     ((8, 1024, 12, 2, 128, 0), None),
                     # qwen2-moe-a2.7b's 16/16 heads of 128: group 1
                     ((8, 1024, 16, 16, 128, 0), None),
                     # llama-3.2-vision-11b's 32/8 heads of 128 (group
                     # 4): its self cache, and its cross cache of 1600
                     # image tokens read whole; whisper-large-v3's 20/20
                     # heads of 64: its self cache, and its cross cache
                     # at enc_len 1500 of 1536 and at 0
                     ((8, 1024, 32, 8, 128, 0), None),
                     ((8, 1600, 32, 8, 128, 0), [1600] * 8),
                     ((8, 1024, 20, 20, 64, 0), None),
                     ((4, 1536, 20, 20, 64, 0), [1500, 0, 1500, 0])]


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


@pytest.mark.parametrize("kdt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_decode_kernel_gives_zeros_at_length_zero(card, kdt):
    """A sequence with no key (an audio model's cross cache at enc_len 0)
    gets zeros, from the kernel and its plain version, over a cache of
    anything: whisper's 20/20 heads of 64 over 1536 frames."""
    b, s, h, kv, hd = 4, 1536, 20, 20, 64
    q = _randn(card, (b, h, hd), torch.float32, 10)
    kc = _randn(card, (b, s, kv, hd), kdt, 11)
    vc = _randn(card, (b, s, kv, hd), kdt, 12)
    lens = torch.zeros((b,), dtype=torch.int32, device=card)
    out = da.decode_attention(q, kc, vc, lens)
    ref = da.decode_attention_plain(q, kc, vc, lens)
    torch.cuda.synchronize()
    assert not out.any() and not ref.any()


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
                                  (1, 77, 300, 25, 5, 128, False, 0),
                                  (2, 77, 77, 4, 1, 256, True, 0),
                                  (1, 77, 300, 4, 2, 256, False, 0),
                                  (2, 600, 600, 4, 1, 256, True, 512),
                                  # whisper-large-v3's encoder (20/20 of
                                  # 64, non-causal) and its decoder's
                                  # cross-attention; the vision model's
                                  # cross-attention (32/8 of 128) with
                                  # Sq > Skv and Sq < Skv
                                  (1, 300, 300, 20, 20, 64, False, 0),
                                  (1, 77, 300, 20, 20, 64, False, 0),
                                  (1, 300, 100, 32, 8, 128, False, 0),
                                  (1, 77, 300, 32, 8, 128, False, 0)],
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


# ---- FleetPlane ---------------------------------------------------------

def test_fleet_sweep_on_the_card_equals_the_cpu(card):
    from repro_torch.fleet import POLICIES, fleet_sweep_demand
    rng = np.random.default_rng(0)
    demand = rng.uniform(8.0, 48.0, (3, 40, 120)) * GiB
    gains = grid_gains(lam=(0.5, 1.2), r0=(0.92, 0.95), lam_grant=(None, 0.3),
                       deadband=(0.0, 0.01), feedforward=(0.0, 0.5))
    for policy in POLICIES:
        kw = dict(node_memory=125 * GiB, weights=np.array([3.0, 1.5, 1.0]),
                  floors=np.array([10.0, 8.0, 0.0]) * GiB, policy=policy,
                  priority_order=(2, 0, 1), epoch_intervals=30)
        got = fleet_sweep_demand(demand, gains, device=card, **kw)
        want = fleet_sweep_demand(demand, gains, device="cpu", **kw)
        names = got[0]._fields + got[1]._fields
        assert [f for f, a, b in zip(names, got[0] + got[1],
                                     want[0] + want[1])
                if not np.array_equal(a, b)] == [], policy


def _card_fleet_spec(device):
    from repro_torch.fleet import FleetSpec, TenantSpec

    def tenant(name, base, **kw):
        nodes = tuple(
            NodeSpec(f"{name}-n{i}", monitor=SimulatedMonitor(
                f"{name}-n{i}", total=125 * GiB,
                usage=lambda t, b=base, i=i: (b + 15.0 * np.sin(0.3 * t + i))
                * GiB))
            for i in range(4))
        return TenantSpec(name, PlaneSpec(
            params=ControllerParams(total_memory=125 * GiB, u_max=60 * GiB),
            nodes=nodes, device=device), **kw)

    return FleetSpec(tenants=(tenant("heavy", 45.0, weight=3.0,
                                     floor_gib=10.0),
                              tenant("light", 20.0, weight=1.0,
                                     floor_gib=8.0)),
                     epoch_intervals=5)


def test_fleet_plane_ticks_on_the_card(card):
    from repro_torch.fleet import FleetPlane
    on_card = FleetPlane(_card_fleet_spec(card))
    on_cpu = FleetPlane(_card_fleet_spec("cpu"))
    for tick in range(40):
        a, b = on_card.tick(), on_cpu.tick()
        for name in b:
            assert [(x.node, x.u_next, x.epoch) for x in a[name]] == \
                [(x.node, x.u_next, x.epoch) for x in b[name]], tick
        assert on_card.budgets() == on_cpu.budgets(), tick
    assert on_card.epoch == 8
    torch.cuda.synchronize()
    with count_syncs() as syncs:
        on_card.tick()
    assert len(syncs) == 2                  # one readback per tenant


@pytest.mark.parametrize("kernel", ["flash", "decode", "scan"])
def test_kernels_refuse_cuda_inputs_that_require_grad(card, kernel):
    g = torch.Generator(device=card).manual_seed(0)
    kc = torch.randn((1, 6, 2, 16), generator=g, device=card)
    a = torch.rand((1, 5, 3, 2), generator=g, device=card)
    lens = torch.tensor([5], dtype=torch.int32, device=card)
    h0 = torch.zeros((1, 3, 2), device=card)
    call, x = {
        "flash": (lambda x: fa.flash_attention(x, kc, kc),
                  torch.randn((1, 6, 4, 16), generator=g, device=card)),
        "decode": (lambda x: da.decode_attention(x, kc, kc, lens),
                   torch.randn((1, 4, 16), generator=g, device=card)),
        "scan": (lambda x: ks_scan.ssm_scan(x, a, h0), a.clone()),
    }[kernel]
    x.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        call(x)
    with torch.no_grad():
        assert torch.isfinite(call(x)).all()


def test_training_on_the_card_follows_the_cpu(card, tmp_path):
    from repro_torch.data import (DataPipeline, PipelineConfig, ShardStore,
                                  write_corpus)
    from repro_torch.train import Trainer, TrainerConfig, TrainStepConfig
    write_corpus(str(tmp_path / "c"), n_shards=4, tokens_per_shard=1024,
                 vocab_size=503)
    cfg = get_config("llama3.2-1b-smoke")
    cpu = Model(cfg, seed=0, device="cpu")
    losses = {}
    for dev in ("cpu", "cuda"):
        model = Model(cfg, seed=0, device=dev)
        with torch.no_grad():
            for p, q in zip(model.parameters(), cpu.parameters()):
                p.copy_(q)
        pipe = DataPipeline(ShardStore(str(tmp_path / "c")), PipelineConfig(
            batch_size=4, seq_len=32, prefetch_depth=0, dynims=False))
        batch = pipe.batch(0)
        staged = pipe.to_device(batch, dev)
        for k, v in batch.items():
            assert np.array_equal(staged[k].cpu().numpy(), v)
        tr = Trainer(model, pipe, TrainStepConfig(microbatches=2,
                                                  warmup_steps=2,
                                                  total_steps=4),
                     TrainerConfig(steps=4, checkpoint_every=4, log_every=1,
                                   checkpoint_dir=str(tmp_path / dev)),
                     device=dev)
        tr.fit()
        losses[dev] = [r["loss"] for r in tr.metrics_log]
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)


@pytest.mark.parametrize("arch", ["hymba-1.5b-smoke", "gemma3-1b-smoke",
                                  "qwen2-1.5b-smoke"])
def test_new_architectures_train_on_the_card_as_on_the_cpu(card, tmp_path,
                                                          arch):
    """Four train steps of each smoke model on the card and on the CPU
    from the same init: the losses within 1e-5 relative, and no kernel
    launched on the training path."""
    from repro_torch.data import (DataPipeline, PipelineConfig, ShardStore,
                                  write_corpus)
    from repro_torch.train import Trainer, TrainerConfig, TrainStepConfig
    write_corpus(str(tmp_path / "c"), n_shards=4, tokens_per_shard=1024,
                 vocab_size=503)
    cfg = get_config(arch)
    cpu = Model(cfg, seed=0, device="cpu")
    losses = {}
    for dev in ("cpu", "cuda"):
        model = Model(cfg, device=dev, init=False)
        with torch.no_grad():
            for p, q in zip(model.parameters(), cpu.parameters()):
                p.copy_(q)
        pipe = DataPipeline(ShardStore(str(tmp_path / "c")), PipelineConfig(
            batch_size=4, seq_len=32, prefetch_depth=0, dynims=False))
        tr = Trainer(model, pipe, TrainStepConfig(microbatches=2,
                                                  warmup_steps=2,
                                                  total_steps=4),
                     TrainerConfig(steps=4, checkpoint_every=4, log_every=1,
                                   checkpoint_dir=str(tmp_path / dev)),
                     device=dev)
        before = (fa.LAUNCHES, da.LAUNCHES, ks_scan.LAUNCHES)
        tr.fit()
        assert (fa.LAUNCHES, da.LAUNCHES, ks_scan.LAUNCHES) == before
        losses[dev] = [r["loss"] for r in tr.metrics_log]
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)


@pytest.mark.parametrize("cf", [8.0, 1.25], ids=["no-drops", "drops"])
def test_moe_layer_on_the_card_equals_the_cpu(card, cf):
    """One qwen2-moe layer's experts at a reduced width (d 256, 60
    experts padded to 64, top 4, 4 shared) on 2 x 600 tokens (two groups
    of 600): the card's output and aux within 1e-5 of the CPU's, and the
    same (token, choice) pairs kept."""
    import dataclasses
    from repro_torch.models import moe as TM
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b"), d_model=256,
                              d_ff_expert=128, n_layers=1, vocab_size=512,
                              capacity_factor=cf)
    cpu = Model(cfg, seed=0, device="cpu").layers[0].moe
    with torch.no_grad():
        cpu.shared.gate.normal_(0.0, 0.5)
    x = torch.randn((2, 600, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    out = {}
    for dev in ("cpu", "cuda"):
        moe = Model(cfg, device=dev, init=False).layers[0].moe
        with torch.no_grad():
            for p, q in zip(moe.parameters(), cpu.parameters()):
                p.copy_(q)
        seen = []
        TM.ROUTE_HOOK = lambda experts, keep: seen.append(
            (experts.cpu(), keep.cpu()))
        try:
            y, aux = TM.moe_apply(moe, x.to(dev), cfg)
        finally:
            TM.ROUTE_HOOK = None
        out[dev] = (y.cpu(), float(aux), seen[0])
    (yc, ac, (ec, kc)), (yg, ag, (eg, kg)) = out["cpu"], out["cuda"]
    assert torch.equal(ec, eg) and torch.equal(kc, kg)
    assert bool((~kc).any()) == (cf < 8.0)
    torch.testing.assert_close(yg, yc, atol=1e-5, rtol=1e-5)
    assert abs(ag - ac) <= 1e-5 * ac


def test_analyze_step_counts_a_card_decode_steps_attention(card):
    """A decode step of the llama smoke model on the card: each decode
    attention launch is counted at the lengths it was given, which no
    dispatch mode sees (the kernel goes through ctypes)."""
    from repro_torch.roofline import analyze_step
    from repro_torch.roofline import kernels as rk
    cfg = get_config("llama3.2-1b-smoke")
    model = Model(cfg, device=card)
    state = D.init_state(model, 4, 64)
    state.pos.copy_(torch.tensor([0, 5, 17, 63], dtype=torch.int32))
    tokens = torch.zeros((4, 1), dtype=torch.int64, device=card)
    before = da.LAUNCHES
    with torch.no_grad():
        row = analyze_step(D.decode_step, model, state, tokens,
                           desc=dict(kind="decode", tokens=4, n_params=0))
    dec = row["kernels"]["decode_attention"]
    assert dec["calls"] == da.LAUNCHES - before == cfg.n_layers
    one = rk.decode([1, 6, 18, 64], 64, cfg.n_heads, cfg.n_kv_heads,
                    cfg.head_dim, q_itemsize=4, kv_itemsize=2)
    assert dec["bytes"] == cfg.n_layers * one.bytes
    assert dec["ops"] == cfg.n_layers * one.ops
