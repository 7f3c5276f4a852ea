"""The CUDA kernels on the card, held against their plain PyTorch versions.

Marked ``cuda``: each test skips, with its reason, where no CUDA card is
present (a CUDA kernel has no CPU mode).  On a machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` makes the same comparisons at the main path's sizes.
Tolerances of the attention kernels are those of
``tests/test_kernels.py``: 2e-5 in float32, 3e-2 (decode) and 2e-2
(flash) in bfloat16.  The sweep without the cache and the scan are
held bit for bit.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.traces import GiB, fleet_demand_traces
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssm_scan as ks_scan
from repro_torch.kernels import sweep as ks
from repro_torch.lab import fused_sweep as fs
from repro_torch.lab.scenarios import get_scenario
from repro_torch.lab.score import stats_mismatches
from repro_torch.lab.sweep import plan_specialization, run_sweep
from repro_torch.lab.tune import grid_gains
from repro_torch.models import Model, decode as D

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("law", ["paper", "generic"])
@pytest.mark.parametrize("cache", [False, True])
def test_kernel_matches_plain_version(card, law, cache):
    n_nodes, n_steps = 300, 80
    demand = fleet_demand_traces(n_nodes, n_steps, 0.1, seed=1)
    gains = grid_gains(lam=np.linspace(0.2, 1.8, 4), r0=(0.9, 0.95),
                       lam_grant=(None,) if law == "paper" else (0.25,))
    spec = get_scenario("spark-iterative-cache").cache if cache else None
    con = fs._engine_consts(plan_specialization(gains), spec, 0.1, 1.0,
                            "f32")
    names = ks.state_names(con.paper_law, con.has_cache)
    dtn, rows, lp = fs._stage(demand, gains, np.full(n_nodes, 125 * GiB),
                              spec, "f32", card)
    alive = fs._alive(len(gains), len(gains) - 2, card)
    state0 = fs._init_state(lp, rows, dtn[0], con, names)
    before = ks.LAUNCHES
    sk, ck = ks.sweep_segment(state0, dtn, lp, rows, alive, t0=3, con=con,
                              names=names)
    assert ks.LAUNCHES == before + 1
    sp, cp = ks.sweep_segment_plain(state0, dtn, lp, rows, alive, t0=3,
                                    con=con, names=names)
    torch.cuda.synchronize()
    if cache:
        scale = sp.abs().amax(dim=(1, 2), keepdim=True).clamp_min(1e-30)
        assert float(((sk - sp).abs() / scale).max()) <= 1e-6
    else:
        assert torch.equal(sk, sp)
        assert torch.equal(ck.to(torch.int32), cp.to(torch.int32))


def test_run_sweep_on_the_card_matches_the_cpu(card):
    spec = get_scenario("swap-storm").replace(n_nodes=64, n_intervals=200)
    gains = grid_gains(lam=(0.5, 1.0, 1.6), r0=(0.9, 0.95),
                       lam_grant=(None, 0.25))
    a = run_sweep(spec, gains)
    b = run_sweep(spec, gains, device="cpu")
    assert stats_mismatches(a.stats, b.stats, n_samples=64 * 200) == []
    assert a.best() == b.best()


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
