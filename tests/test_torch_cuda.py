"""The sweep kernel on the card, held against its plain PyTorch version.

Marked ``cuda``: each test skips, with its reason, where no CUDA card is
present (a CUDA kernel has no CPU mode).  On a machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` makes the same comparison at the lab benchmark's size.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.traces import GiB, fleet_demand_traces
from repro_torch.kernels import sweep as ks
from repro_torch.lab import fused_sweep as fs
from repro_torch.lab.scenarios import get_scenario
from repro_torch.lab.score import stats_mismatches
from repro_torch.lab.sweep import plan_specialization, run_sweep
from repro_torch.lab.tune import grid_gains

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sweep kernel has no CPU mode")
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
