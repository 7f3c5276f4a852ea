"""The port's control law held against the JAX package's.

Same inputs (numpy, from a seed) through ``repro.core.control`` and
``repro_torch.core.control``.  Tolerance: rtol 1e-6.  XLA on the CPU
contracts ``a*b + c`` into fused multiply-adds; the port rounds the
law's multiply-adds once too (``fma``, checked here against exact
rational arithmetic), but whatever else XLA fuses or reorders may move
the last bits of a step.
"""

import dataclasses
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import control as jc
from repro_torch.convert import params_from_dict
from repro_torch.core import control as tc

# One intra-op thread: the suite's workers share the cores, and torch's
# OpenMP threads, oversubscribed, spin-wait ~100x longer than the ops.
torch.set_num_threads(1)

GiB = 2.0**30
N = 16


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    m = rng.uniform(100, 150, N).astype(np.float32) * np.float32(GiB)
    u = rng.uniform(0, 60, N).astype(np.float32) * np.float32(GiB)
    v = (rng.uniform(0.7, 1.1, N).astype(np.float32) * m)
    v_prev = v * rng.uniform(0.9, 1.1, N).astype(np.float32)
    return m, u, v, v_prev


CASES = {
    "paper": dict(r0=0.95, lam=0.5),
    "asymmetric": dict(r0=0.93, lam=1.6, lam_grant=0.25),
    "deadband": dict(r0=0.95, lam=0.8, deadband=0.02),
    "feedforward": dict(r0=0.9, lam=1.2, feedforward=0.5),
    "per_node_bounds": dict(r0=0.95, lam=1.0, bounds=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("reciprocals", [False, True])
def test_vectorized_step_matches_jax(case, reciprocals):
    kw = dict(CASES[case])
    m, u, v, v_prev = _inputs(seed=len(case))
    if kw.pop("bounds", False):
        kw["u_min"] = (0.05 * m).astype(np.float32)
        kw["u_max"] = (0.45 * m).astype(np.float32)
    if "feedforward" in kw:
        kw["v_prev"] = v_prev
    if reciprocals:
        kw["inv_total_memory"] = (np.float32(1.0) / m)
        kw["inv_r0"] = np.float32(1.0) / np.float32(kw["r0"])
    ref = np.asarray(jc.vectorized_step(
        jnp.asarray(u), jnp.asarray(v), total_memory=jnp.asarray(m),
        **{k: jnp.asarray(x) if isinstance(x, np.ndarray) else x
           for k, x in kw.items()}))
    got = tc.vectorized_step(
        torch.from_numpy(u), torch.from_numpy(v),
        total_memory=torch.from_numpy(m),
        **{k: torch.from_numpy(x) if isinstance(x, np.ndarray) else x
           for k, x in kw.items()}).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0.0)


def test_control_step_matches_jax_scalar_law():
    jp = jc.ControllerParams(total_memory=125 * GiB, r0=0.93, lam=1.2,
                             lam_grant=0.3, deadband=0.01, feedforward=0.4)
    tp = params_from_dict(dataclasses.asdict(jp))
    rng = np.random.default_rng(3)
    for _ in range(200):
        u, v, vp = (float(x) for x in rng.uniform(0, 130, 3) * GiB)
        assert tc.control_step(u, v, tp, v_prev=vp) == \
            jc.control_step(u, v, jp, v_prev=vp)
    assert tp.is_paper_faithful == jp.is_paper_faithful


def test_params_from_dict_rejects_unknown_fields():
    with pytest.raises(ValueError, match="unexpected"):
        params_from_dict({"total_memory": 1.0, "gain": 2.0})


def _exact_fma32(a, b, c):
    """a*b + c rounded once to float32, from exact rational arithmetic."""
    x = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    r = np.float32(float(x))
    cands = (np.nextafter(r, np.float32(-np.inf)), r,
             np.nextafter(r, np.float32(np.inf)))
    return min(cands, key=lambda y: (abs(Fraction(float(y)) - x),
                                     int(np.float32(y).view(np.int32)) & 1))


def test_fma_rounds_once_like_hardware():
    rng = np.random.default_rng(5)
    n = 3000
    a = (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 6, n))
    b = (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 6, n))
    c = (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 6, n))
    # Sums that land exactly between two floats after the float64
    # rounding, where rounding twice would go the wrong way.
    # Exact sums just above and just below such a midpoint, the tie
    # rule pointing the other way each time.
    k = np.arange(1, 65, dtype=np.float64)
    tiny = 2.0**-24 * (1 + k * 2.0**-23)
    a = np.concatenate([a, -tiny, tiny])
    b = np.concatenate([b, 1 - k * 2.0**-23, 1 - k * 2.0**-23])
    c = np.concatenate([c, np.full(128, 1 + 2.0**-23)])
    a, b, c = (x.astype(np.float32) for x in (a, b, c))
    got = tc.fma(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    want = np.array([_exact_fma32(*t) for t in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (twice[-128:] != want[-128:]).all()    # the cases are real
