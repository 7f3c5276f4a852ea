"""The DynIMS feedback control law (paper Eq. 1), PyTorch form.

Counterpart of ``repro/core/control.py``.  :class:`Signal`,
:class:`ControllerParams`, the scalar :func:`control_step` and the
stability helpers (:func:`fixed_point_capacity`, :func:`is_stable`,
:func:`simulate_saturated_loop`, :func:`settling_time`) are
numpy-only copies;
:func:`vectorized_step` steps ``N`` node controllers at once on torch
tensors, in the reference's float32 operation order:

    u_{i+1} = clamp(u_i - lam * v_i * (r_i - r0) / r0,  u_min, u_max)

with the reciprocal multiplies, the ``lam_grant`` select on ``err < 0``,
the deadband hold and the clamp exactly where the JAX form has them,
and its multiply-adds rounded once (:func:`fma`), as XLA contracts them.
Python-scalar and numpy operands are lifted to float32 tensors on the
operands' device first, as ``jnp`` lifts weakly typed scalars; that also
keeps CUDA's "divide by a host scalar" shortcut (a multiply by the
reciprocal) out of the arithmetic.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Union

import numpy as np
import torch

GiB = float(2**30)

Scalar = Union[float, np.ndarray, torch.Tensor]


class Signal(enum.Enum):
    """Which aggregate of the usage window drives Eq. 1.

    Plain strings are accepted anywhere a :class:`Signal` is expected
    via :meth:`coerce`.
    """

    LATEST = "latest"
    EWMA = "ewma"
    MAX = "max"

    @classmethod
    def coerce(cls, value: "Signal | str") -> "Signal":
        if isinstance(value, Signal):
            return value
        try:
            return cls(str(value).lower())
        except ValueError:
            raise ValueError("signal must be latest|ewma|max") from None

    def pick(self, agg) -> float:
        """Extract this signal's value from an ``AggregatedMetrics``."""
        return float(getattr(agg, f"used_{self.value}"))


@dataclasses.dataclass(frozen=True)
class ControllerParams:
    """Parameters of the DynIMS control law (paper Table I).

    All capacities are in bytes.
    """

    total_memory: float                 # M
    r0: float = 0.95                    # utilization threshold
    lam: float = 0.5                    # aggressiveness
    u_min: float = 0.0
    u_max: float = 60.0 * GiB
    interval_s: float = 0.1             # T

    # --- beyond-paper knobs (paper-faithful defaults) -------------------
    lam_grant: Optional[float] = None   # gain when r < r0 (None -> lam)
    deadband: float = 0.0               # |r - r0| <= deadband -> hold
    feedforward: float = 0.0            # 0 = off; else weight on dv/dt * T

    def __post_init__(self) -> None:
        if self.total_memory <= 0:
            raise ValueError("total_memory must be positive")
        if not (0.0 < self.r0 <= 1.0):
            raise ValueError("r0 must be in (0, 1]")
        if self.u_min < 0 or self.u_max < self.u_min:
            raise ValueError("need 0 <= u_min <= u_max")
        if self.interval_s <= 0:
            raise ValueError("interval_s must be positive")

    @property
    def is_paper_faithful(self) -> bool:
        return (
            self.lam_grant is None
            and self.deadband == 0.0
            and self.feedforward == 0.0
        )

    def replace(self, **kw) -> "ControllerParams":
        return dataclasses.replace(self, **kw)


def control_step(
    u: float,
    v: float,
    params: ControllerParams,
    *,
    v_prev: Optional[float] = None,
) -> float:
    """One scalar update of the paper's Eq. 1 with clamping."""
    m = params.total_memory
    v_eff = v
    if params.feedforward > 0.0 and v_prev is not None:
        v_eff = v + params.feedforward * (v - v_prev)
    r = v_eff / m
    err = r - params.r0
    if abs(err) <= params.deadband:
        return float(np.clip(u, params.u_min, params.u_max))
    lam = params.lam
    if err < 0 and params.lam_grant is not None:
        lam = params.lam_grant
    u_next = u - lam * v_eff * err / params.r0
    return float(np.clip(u_next, params.u_min, params.u_max))


def f32(x: Scalar, device: torch.device) -> torch.Tensor:
    """``x`` as a float32 tensor on ``device`` (scalars become 0-d).

    A scalar is filled in on the device, rounded to float32 as numpy
    rounds it: a copy from host memory would wait for the device's
    queue to drain, and the sweep's finalize makes a dozen of them.
    """
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    if np.ndim(x) == 0:
        return torch.full((), float(np.float32(x)), dtype=torch.float32,
                          device=device)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to float32: an exact fused multiply-add.

    The reference's XLA build contracts the law's multiply-adds into
    FMAs, and near-critical gains carry a different rounding there into
    a different trajectory within a few hundred intervals (enough to
    reorder the tuner's winners).  The kernel issues hardware FMAs
    (``__fmaf_rn``); PyTorch has no FMA operator, so this computes the
    same result in float64: the product of two floats is exact there,
    and the one case where rounding the float64 sum to float32 rounds
    twice -- the sum landing exactly between two floats -- is settled
    by the sum's exact error (TwoSum).
    """
    a, b, c = a.double(), b.double(), c.double()
    p = a * b                                 # exact: 24 x 24 bits
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)             # p + c == s + err exactly
    r = s.float()
    r64 = r.double()
    inf = torch.full_like(r, float("inf"))
    other = torch.nextafter(r, torch.where(s > r64, inf, -inf))
    tie = (s - r64).abs() == (other.double() - r64).abs() * 0.5
    up = torch.where(err > 0, torch.maximum(r, other),
                     torch.minimum(r, other))
    return torch.where(tie & (err != 0), up, r)


def vectorized_step(
    u: torch.Tensor,
    v: torch.Tensor,
    *,
    total_memory: Scalar,
    r0: Scalar = 0.95,
    lam: Scalar = 0.5,
    u_min: Scalar = 0.0,
    u_max: Scalar = 60.0 * GiB,
    lam_grant: Optional[Scalar] = None,
    deadband: Scalar = 0.0,
    v_prev: Optional[torch.Tensor] = None,
    feedforward: float = 0.0,
    inv_total_memory: Optional[Scalar] = None,
    inv_r0: Optional[Scalar] = None,
    lam_inv_r0: Optional[Scalar] = None,
) -> torch.Tensor:
    """Eq. 1 applied to ``N`` node controllers at once.

    Shapes: ``u``, ``v`` (and optional ``v_prev``) are ``(..., N)``;
    every other operand broadcasts against them.  ``inv_total_memory``
    / ``inv_r0`` are precomputed reciprocals for hot loops: two
    divisions per interval become multiplies.  ``lam_grant=None`` and a
    Python ``deadband == 0.0`` are resolved here, before any arithmetic,
    as the JAX form resolves them at trace time.  ``lam_inv_r0``, the
    float32 product ``lam * (1 / r0)``, takes XLA's form for a
    one-element fleet with constant gains: ``u - (v_eff * err) *
    lam_inv_r0``, contracted (ROADMAP C18).
    """
    u = torch.as_tensor(u, dtype=torch.float32)
    dev = u.device
    v = f32(v, dev)
    v_eff = v
    if feedforward > 0.0 and v_prev is not None:
        v_eff = fma(f32(feedforward, dev), v - f32(v_prev, dev), v)
    if inv_total_memory is not None:
        err = fma(v_eff, f32(inv_total_memory, dev), -f32(r0, dev))
    else:
        err = v_eff / f32(total_memory, dev) - f32(r0, dev)
    if lam_grant is None:
        lam_eff = f32(lam, dev)
    else:
        lam_eff = torch.where(err < 0, f32(lam_grant, dev), f32(lam, dev))
    if lam_inv_r0 is not None:
        if lam_grant is not None:
            raise ValueError("lam_inv_r0 folds a constant lam; it cannot "
                             "take an asymmetric lam_grant")
        u_next = fma(-(v_eff * err), f32(lam_inv_r0, dev), u)
    else:
        if inv_r0 is not None:
            scaled_err = err * f32(inv_r0, dev)
        else:
            scaled_err = err / f32(r0, dev)
        u_next = fma(-(lam_eff * v_eff), scaled_err, u)     # u - delta
    if not (isinstance(deadband, (int, float)) and deadband == 0.0):
        # With no deadband the hold could only trigger at err == 0,
        # where delta is 0 anyway -- identical result, fewer ops.
        u_next = torch.where(torch.abs(err) <= f32(deadband, dev), u,
                             u_next)
    return torch.minimum(torch.maximum(u_next, f32(u_min, dev)),
                         f32(u_max, dev))


# ----------------------------------------------------------------------
# Analysis helpers
# ----------------------------------------------------------------------

def fixed_point_capacity(params: ControllerParams,
                         compute_demand: float) -> float:
    """Equilibrium storage capacity under constant compute demand.

    With a saturated store, v = d + u, so r = r0  <=>  u* = r0*M - d,
    clamped to the admissible range.
    """
    u_star = params.r0 * params.total_memory - compute_demand
    return float(np.clip(u_star, params.u_min, params.u_max))


def closed_loop_eigenvalue(params: ControllerParams) -> float:
    """f'(u*) of the saturated-store closed loop: 1 - lam."""
    return 1.0 - params.lam


def is_stable(params: ControllerParams) -> bool:
    """Asymptotic stability of the saturated-store closed loop."""
    return abs(closed_loop_eigenvalue(params)) < 1.0


def simulate_saturated_loop(
    params: ControllerParams,
    compute_demand: np.ndarray,
    u0: float,
    occupancy: float = 1.0,
) -> np.ndarray:
    """Roll the scalar loop forward against a compute-demand trace.

    The store is modelled as ``occupancy``-full.  Returns the capacity
    trace ``u[t]`` with ``u[0] == u0``, one entry per demand sample.
    """
    demand = np.asarray(compute_demand, dtype=np.float64)
    out = np.empty(demand.shape[0], dtype=np.float64)
    u = float(u0)
    v_prev: Optional[float] = None
    for i, d in enumerate(demand):
        out[i] = u
        v = d + occupancy * u
        u = control_step(u, v, params, v_prev=v_prev)
        v_prev = v
    return out


def settling_time(
    trace: np.ndarray, target: float, tol_frac: float = 0.02
) -> Optional[int]:
    """First index after which the trace stays within tol_frac of target."""
    tol = max(abs(target) * tol_frac, 1e-9)
    ok = np.abs(np.asarray(trace) - target) <= tol
    for i in range(len(ok)):
        if ok[i:].all():
            return i
    return None
