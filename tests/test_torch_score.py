"""The port's streamed statistics and objectives held against the JAX ones.

Codes, histograms and quantiles are integer results and must be equal
exactly on identical inputs.  The float folds (finalize, objectives, the Fig.-2
curve) are held at rtol 1e-6: XLA on the CPU contracts multiply-adds
and sums in another order than eager PyTorch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.lab import score as js
from repro_torch.lab import score as ts

T, L, N = 40, 5, 12


def _utils(seed=0, shape=(T, N)):
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.3, 1.2, shape).astype(np.float32)
    u.flat[:4] = [0.0, 1.99999, 2.5, -0.1]        # saturate both ends
    return u


def test_utilization_codes_equal_exactly():
    u = _utils()
    ref = np.asarray(js.utilization_codes(jnp.asarray(u)))
    got = ts.utilization_codes(torch.from_numpy(u))
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  ref.astype(np.int64))


@pytest.mark.parametrize("q", [0.5, 0.9, 0.99])
@pytest.mark.parametrize("levels", [12, 16])
def test_quantile_from_codes_equal_exactly(q, levels):
    codes = np.array(js.utilization_codes(jnp.asarray(_utils(seed=7))))
    ref = np.asarray(js.quantile_from_codes(jnp.asarray(codes), q,
                                            codes.size, levels=levels))
    got = ts.quantile_from_codes(torch.from_numpy(codes), q, codes.size,
                                 levels=levels)
    assert got.dtype == torch.float32
    assert float(got) == float(ref)


def test_quantile_per_lane_equals_lane_by_lane():
    u = _utils(seed=3, shape=(T, L, N))
    codes = np.array(js.utilization_codes(jnp.asarray(u)))
    got = ts.quantile_from_codes(torch.from_numpy(codes), 0.99, T * N,
                                 lane_dim=1).numpy()
    ref = [float(js.quantile_from_codes(jnp.asarray(codes[:, i]), 0.99,
                                        T * N)) for i in range(L)]
    np.testing.assert_array_equal(got, np.asarray(ref, np.float32))


def _code_lanes(case):
    """(L, M) uint16 codes, one lane per row: the histogram's cases."""
    rng = np.random.default_rng(11)
    if case == "spread":
        # lanes from tight (1e-4) to wide (0.5) around r0, both ends cut
        spread = np.geomspace(1e-4, 0.5, L)[:, None]
        u = (0.93 + spread * rng.standard_normal((L, T * N))).astype(
            np.float32)
        u[-1, :3] = [-0.5, 2.5, 1.99999]
        return np.array(js.utilization_codes(jnp.asarray(u)))
    if case == "one-bin":
        return (1601 * 16 + rng.integers(0, 16, (L, T * N))).astype(np.uint16)
    if case == "ends":
        ends = np.where(rng.random((L, T * N)) < np.linspace(0, 1, L)[:, None],
                        65535, 0)
        return ends.astype(np.uint16)
    assert case == "n_total=1"
    return rng.integers(0, 65536, (L, 1)).astype(np.uint16)


@pytest.mark.parametrize("case", ["spread", "one-bin", "ends", "n_total=1"])
@pytest.mark.parametrize("q", [0.0, 0.5, 0.99, 1.0])
@pytest.mark.parametrize("levels", range(1, 13))
def test_quantile_from_hist_equals_jax_quantile_from_codes(case, q, levels):
    """The per-lane histogram of code >> 4 gives JAX's bracket, bit for
    bit, at every depth the 4096 bins resolve."""
    codes = _code_lanes(case)
    n = codes.shape[1]
    ref = jax.vmap(lambda c: js.quantile_from_codes(c, q, n, levels=levels))(
        jnp.asarray(codes))
    hist = torch.zeros((L, ts.HIST_BINS), dtype=torch.int32)
    assert ts.hist_add(hist, torch.from_numpy(codes)) is hist
    assert int(hist.sum()) == L * n
    got = ts.quantile_from_hist(hist, q, n, levels=levels)
    assert got.dtype == torch.float32 and got.shape == (L,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # one row alone gives lane 0's value as a 0-d result
    assert float(ts.quantile_from_hist(hist[0], q, n, levels=levels)) == \
        float(ref[0])


def test_quantile_from_hist_refuses_levels_past_the_bins():
    hist = torch.zeros((2, ts.HIST_BINS), dtype=torch.int32)
    ts.quantile_from_hist(hist, 0.99, 1, levels=12)
    with pytest.raises(ValueError, match="12 bisection levels"):
        ts.quantile_from_hist(hist, 0.99, 1, levels=13)
    with pytest.raises(ValueError, match="12 bisection levels"):
        ts.quantile_from_hist(hist, 0.99, 1, levels=-1)


def test_hpl_slowdown_curve_and_kahan_match():
    u = np.linspace(-0.1, 1.6, 341).astype(np.float32)
    np.testing.assert_allclose(
        ts.hpl_slowdown_curve(torch.from_numpy(u)).numpy(),
        np.asarray(js.hpl_slowdown_curve(jnp.asarray(u))), rtol=1e-6)
    rng = np.random.default_rng(0)
    a, c, x = (rng.normal(size=N).astype(np.float32) for _ in range(3))
    ref = js.kahan_add(jnp.asarray(a), jnp.asarray(c), jnp.asarray(x))
    got = ts.kahan_add(*(torch.from_numpy(v) for v in (a, c, x)))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _accumulators(seed, cache):
    rng = np.random.default_rng(seed)

    def f(lo, hi):
        return rng.uniform(lo, hi, (L, N)).astype(np.float32)

    acc = dict(util_sum=f(20, 38), util_max=f(0.8, 1.3),
               caps_sum_gib=f(500, 2400), caps_sumsq_gib=f(2e4, 1e5),
               over_r0_count=np.floor(f(0, 30)),
               violation_count=np.floor(f(0, 5)),
               last_bad=np.floor(f(-1, T)))
    if cache:
        acc.update(hits_gib=f(0, 8), evicted_gib=f(0, 30),
                   app_time_s=f(4, 9))
    return acc


@pytest.mark.parametrize("cache", [False, True])
def test_finalize_and_objectives_match(cache):
    acc = _accumulators(11, cache)
    r0 = np.linspace(0.88, 0.98, L).astype(np.float32)
    p99 = np.linspace(0.9, 1.1, L).astype(np.float32)
    extra = dict(accesses_gib=0.2 * T) if cache else {}
    ref = [js.finalize_fleet_stats(
        **{k: jnp.asarray(v[i]) for k, v in acc.items()},
        p99_utilization=jnp.asarray(p99[i]), r0=jnp.asarray(r0[i]),
        n_intervals=T, interval_s=0.1, **extra) for i in range(L)]
    got = ts.finalize_fleet_stats(
        **{k: torch.from_numpy(v) for k, v in acc.items()},
        p99_utilization=torch.from_numpy(p99), r0=torch.from_numpy(r0),
        n_intervals=T, interval_s=0.1, **extra)
    ref_np = js.FleetStats(*(np.asarray([np.asarray(getattr(s, f))
                                         for s in ref])
                             for f in js.FleetStats._fields))
    for name in ts.FleetStats._fields:
        assert getattr(got, name).numpy().dtype == \
            getattr(ref_np, name).dtype, name
    # capacity_std is read through its second moment (see
    # stats_mismatches): the std itself cancels in float32.
    assert ts.stats_mismatches(got, ref_np, n_samples=T * N, rtol=1e-6,
                               rtol_p99=1e-6, rtol_moment=1e-6) == []
    for jfn, tfn in [(js.default_score, ts.default_score),
                     (js.runtime_score, ts.runtime_score),
                     (js.makespan_score, ts.makespan_score)]:
        want = np.asarray(jfn(ref_np))
        for stats in (got, ts.FleetStats(*ref_np)):   # torch and numpy in
            have = tfn(stats).numpy()
            assert have.dtype == np.float32
            np.testing.assert_allclose(have, want, rtol=1e-6)


def test_stats_mismatches_reads_the_second_moment_for_std():
    base = ts.FleetStats(*(np.ones(3, np.float32) for _ in
                           ts.FleetStats._fields))
    near = base._replace(capacity_std_gib=np.full(3, 1.0 + 1e-7,
                                                  np.float32))
    assert ts.stats_mismatches(base, near, n_samples=100) == []
    far = base._replace(mean_capacity_gib=np.full(3, 1.01, np.float32))
    assert [m.split(":")[0] for m in
            ts.stats_mismatches(base, far, n_samples=100)] == \
        ["mean_capacity_gib", "capacity_std_gib"]
