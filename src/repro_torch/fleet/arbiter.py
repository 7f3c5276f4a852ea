"""The two-level arbiter: per-tenant budgets from fleet telemetry.

The port of ``repro/fleet/arbiter.py``.  Level one of FleetPlane's
control hierarchy: every arbitration epoch the global arbiter folds each
tenant's telemetry (demand pressure, hit ratio, slack) into a *desired*
budget and allocates the physical per-node DRAM among tenants under one
of three policies; level two is each tenant's own Eq. 1 loop running
inside its grant.

Policies (all floor-respecting and conserving):

``priority``
    Strict precedence: after floors, tenants drain the remaining pool
    in priority order (ties in declaration order).
``round_robin``
    The *starting* tenant of the precedence chain rotates by one each
    epoch, so over any K consecutive epochs every tenant is first
    exactly once.
``proportional``
    Weighted max-min fairness with floors: the above-floor remainder is
    water-filled in proportion to tenant weights, capped at each
    tenant's desire; freed capacity re-divides among still-hungry
    tenants (K rounds suffice for K tenants).

Two implementations: :func:`arbitrate_reference` is the float64 numpy
oracle (a copy; :class:`FleetArbiter` runs it live, so its grants equal
the JAX package's bit for bit), and :func:`arbitrate` is the batched
float32 torch form over ``(..., tenants, nodes)`` -- one-hot drains and
a static K-unroll, no scatters and no host syncs, with any leading axes
(the fleet sweep's gain lanes) arbitrated in one call.

It makes the JAX package's roundings as that package's jitted callers
compile them: every sum over the tenant axis is a left fold over K
(:func:`ksum`; XLA's order), and the one product reduced over K, the
effective floors' ``(f * scale).sum(0)``, is contracted into fused
multiply-adds in XLA's loop, which :func:`kdot` rounds the same way.
So the card and the CPU add in one order, and both equal
``jax.jit(arbitrate)``.

Invariants (``tests/test_torch_fleet.py``):

* conservation -- ``sum_k alloc[k, n] <= m[n]`` for every node;
* floor respect -- ``alloc[k] >= min(floor[k], fair share of m)``;
* demand boundedness -- no tenant receives more than
  ``max(desired, effective floor)``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..core.control import f32, fma
from .specs import FleetSpec, POLICIES

Array = Union[np.ndarray, torch.Tensor]

#: Smallest budget any tenant is ever granted (bytes).  Keeps a starved
#: tenant's nested ``ControllerParams(total_memory=...)`` valid
#: (total_memory must be positive) and its utilization ratio finite.
MIN_TENANT_BUDGET = float(1 << 20)

# A byte-scale epsilon: tenants needing less than this are "satisfied"
# for water-filling purposes, which makes the K-round unroll exact.
_NEED_EPS = 0.5


def ksum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the tenant axis (-2) as a left fold, XLA's order."""
    acc = x[..., 0, :]
    for k in range(1, x.shape[-2]):
        acc = acc + x[..., k, :]
    return acc


def kdot(f: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``(f * scale).sum(-2)`` as XLA's fused reduce computes it.

    Inside a jitted program XLA emits the product into the reduction
    loop and contracts each step into a fused multiply-add: the first
    product rounds alone, every later one is added unrounded.
    """
    f, scale = torch.broadcast_tensors(f, scale.unsqueeze(-2))
    acc = f[..., 0, :] * scale[..., 0, :]
    for k in range(1, f.shape[-2]):
        acc = fma(f[..., k, :], scale[..., k, :], acc)
    return acc


def _prepare_np(desired, m, floors):
    """The numpy oracle's pre-policy math (float64)."""
    f = np.maximum(floors, MIN_TENANT_BUDGET)          # (K, 1)
    fsum = f.sum(0)                                    # (1,) broadcasts
    scale = np.minimum(1.0, m / np.maximum(fsum, 1.0))
    f_eff = f * scale                                  # (K, N)
    rem = np.maximum(m - (f * scale).sum(0), 0.0)      # (N,)
    need = np.maximum(desired - f_eff, 0.0)            # (K, N)
    return f_eff, need, rem


def _prepare(desired, m, floors, desired_scale=None):
    """Shared pre-policy math: effective floors and the free pool.

    Floors are raised to :data:`MIN_TENANT_BUDGET` and -- should an
    undersized node make the raised floors inadmissible -- scaled down
    proportionally so they always fit.  Returns ``(alloc0, need, rem)``
    with floors pre-granted.  ``floors`` is ``(K, 1)``, ``m`` ``(N,)``;
    with ``desired_scale`` the desire is ``desired * desired_scale``,
    contracted into the need's subtraction.
    """
    dev = desired.device
    f = torch.clamp_min(floors, MIN_TENANT_BUDGET)     # (K, 1)
    fsum = ksum(f)                                     # (1,)
    scale = torch.minimum(
        f32(1.0, dev), m / torch.clamp_min(fsum, 1.0))  # (N,)
    f_eff = f * scale                                  # (K, N)
    rem = torch.clamp_min(m - kdot(f, scale), 0.0)     # (N,)
    if desired_scale is None:
        need = desired - f_eff
    else:
        need = fma(*torch.broadcast_tensors(desired, desired_scale, -f_eff))
    return f_eff, torch.clamp_min(need, 0.0), rem        # need (..., K, N)


def _column(x: Array, k: int, dev: torch.device) -> torch.Tensor:
    """A ``(K,)`` operand as a float32 ``(K, 1)`` tensor on ``dev``."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x, np.float32)
    return f32(x, dev).reshape(k, 1)


def arbitrate(
    desired: torch.Tensor,
    m: torch.Tensor,
    *,
    weights: Array,
    floors: Array,
    priority_order: Tuple[int, ...],
    policy: str,
    rr_offset: int = 0,
    desired_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Batched allocation over a ``(..., tenants, nodes)`` grid.

    Args:
      desired:  ``(..., K, N)`` float32 bytes each tenant wants on each
                node; leading axes (gain lanes) are arbitrated at once.
      m:        ``(N,)`` float32 physical memory per node.
      weights:  ``(K,)`` proportional-share weights.
      floors:   ``(K,)`` guaranteed minima (bytes).
      priority_order: tenant indices, highest precedence first.
      policy:   one of :data:`~repro_torch.fleet.specs.POLICIES`.
      rr_offset: rotation of the round-robin precedence chain.
      desired_scale: a factor broadcasting against ``desired``; the
                desire is then their product, rounded as XLA rounds it
                where a caller's product fuses into the arbitration:
                contracted into each tenant's need, ``desired * scale -
                floor``, never rounded alone.  The fleet sweep passes
                its epoch usage and ``1 / (E * r0)`` so.

    Returns ``(..., K, N)`` float32 granted budgets on ``desired``'s
    device.  One-hot selects instead of scatters, every loop a static
    K-unroll, and nothing read back to the host.
    """
    if policy not in POLICIES:
        raise ValueError(f"policy must be one of {POLICIES}")
    desired = torch.as_tensor(desired, dtype=torch.float32)
    dev = desired.device
    k = desired.shape[-2]
    m = f32(m, dev)
    w = _column(weights, k, dev)
    floors = _column(floors, k, dev)
    if desired_scale is not None:
        desired_scale = f32(desired_scale, dev)
    alloc, need, rem = _prepare(desired, m, floors, desired_scale)
    alloc = alloc.expand_as(need)
    lanes = torch.arange(k, device=dev).view(k, 1)

    def drain(alloc, need, rem, idx):
        # One-hot select: grants tenant ``idx`` its residual need out of
        # ``rem``.  The fold adds one need to zeros, and adding or
        # subtracting the selected take is exact, as in the reference.
        sel = lanes == idx
        take = torch.minimum(need[..., idx, :], rem)
        give = torch.where(sel, take.unsqueeze(-2), 0.0)
        return (alloc + give, need - give,
                torch.clamp_min(rem - take, 0.0))

    if policy == "priority":
        for idx in priority_order:                     # static unroll
            alloc, need, rem = drain(alloc, need, rem, int(idx))
    elif policy == "round_robin":
        for j in range(k):                             # static unroll
            alloc, need, rem = drain(alloc, need, rem,
                                     (int(rr_offset) + j) % k)
    else:                                              # proportional
        # Weighted max-min water-filling: K rounds always converge for
        # K tenants (each round either satisfies a tenant or exhausts
        # the pool), so the loop is a static unroll too.
        tiny = f32(1e-30, dev)
        for _ in range(k):
            active = need > _NEED_EPS
            w_act = torch.where(active, w, 0.0)
            wsum = ksum(w_act).unsqueeze(-2)
            share = torch.where(wsum > 0.0,
                                w_act / torch.maximum(wsum, tiny), 0.0)
            give = torch.minimum(need, share * rem.unsqueeze(-2))
            alloc = alloc + give
            need = need - give
            rem = torch.clamp_min(rem - ksum(give), 0.0)
    return alloc


def arbitrate_reference(
    desired: np.ndarray,
    m: np.ndarray,
    *,
    weights: np.ndarray,
    floors: np.ndarray,
    priority_order: Tuple[int, ...],
    policy: str,
    rr_offset: int = 0,
) -> np.ndarray:
    """Float64 numpy oracle for :func:`arbitrate` (same contract).

    Per-node Python loops and exact water-filling -- the readable
    semantics the batched path is held against, and the implementation
    :class:`FleetArbiter` runs live.
    """
    if policy not in POLICIES:
        raise ValueError(f"policy must be one of {POLICIES}")
    desired = np.asarray(desired, np.float64)
    k, n = desired.shape
    m = np.broadcast_to(np.asarray(m, np.float64), (n,))
    w = np.asarray(weights, np.float64).reshape(k, 1)
    floors = np.asarray(floors, np.float64).reshape(k, 1)
    alloc, need, rem = _prepare_np(desired, m, floors)
    alloc = alloc * np.ones((k, n))
    need = need * np.ones((k, n))
    rem = rem.copy()
    if policy == "priority":
        chain = list(priority_order)
    elif policy == "round_robin":
        chain = [(rr_offset + j) % k for j in range(k)]
    else:
        chain = None
    if chain is not None:
        for idx in chain:
            take = np.minimum(need[idx], rem)
            alloc[idx] += take
            need[idx] -= take
            rem = np.maximum(rem - take, 0.0)
        return alloc
    for _ in range(k):
        active = need > _NEED_EPS
        if not active.any():
            break
        w_act = w * active
        wsum = w_act.sum(0)
        with np.errstate(invalid="ignore", divide="ignore"):
            share = np.where(wsum > 0.0, w_act / np.maximum(wsum, 1e-30),
                             0.0)
        give = np.minimum(need, share * rem)
        alloc += give
        need -= give
        rem = np.maximum(rem - give.sum(0), 0.0)
    return alloc


# ---------------------------------------------------------------------------
# Runtime telemetry and the live arbiter
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TenantTelemetry:
    """One tenant's aggregate state over the closing epoch.

    ``usage_bytes`` is the tenant's mean observed memory usage (compute
    demand plus its storage grant) per node; ``budget_bytes`` the
    budget it ran the epoch under; ``hit_ratio`` its cache service
    quality (1.0 when the tenant models no cache).
    """

    usage_bytes: float
    budget_bytes: float
    hit_ratio: float = 1.0

    @property
    def pressure(self) -> float:
        """Demand pressure: how full the tenant ran its grant."""
        return (self.usage_bytes / self.budget_bytes
                if self.budget_bytes > 0 else 0.0)

    @property
    def slack_bytes(self) -> float:
        """Unused budget -- what the tenant could cede without pain."""
        return max(self.budget_bytes - self.usage_bytes, 0.0)

    def desired_bytes(self, r0: float = 0.95) -> float:
        """The budget that would hold this tenant at utilization r0.

        Scaled up by the miss ratio: a tenant thrashing its cache
        (``hit_ratio`` < 1) bids for headroom beyond its raw usage,
        which is how service quality feeds arbitration.
        """
        base = self.usage_bytes / max(r0, 1e-6)
        return base * (1.0 + (1.0 - self.hit_ratio))


@dataclasses.dataclass(frozen=True)
class FleetGrant:
    """One arbitration decision: per-tenant budgets for an epoch."""

    epoch: int
    timestamp: float
    budgets: Dict[str, float]          # tenant name -> bytes per node
    policy: str

    def total(self) -> float:
        return float(sum(self.budgets.values()))


class FleetArbiter:
    """The live epoch-driven allocator behind :class:`FleetPlane`.

    Thread-safe and lock-leaf: ``_lock`` guards only the arbiter's own
    epoch/rotation/history state and is never held while calling into
    planes, the device, or any other lock holder -- the fleet lock graph
    stays acyclic with this as a terminal node, and the numpy reference
    policy math keeps device work off the locked path.
    """

    def __init__(self, spec: FleetSpec) -> None:
        self.spec = spec
        self._names = spec.names
        self._weights = spec.weights()
        self._floors = spec.floors_bytes().reshape(-1, 1)
        self._order = spec.priority_order()
        self._lock = threading.Lock()
        self._epoch = 0                        # guarded-by: _lock
        self._rr_offset = 0                    # guarded-by: _lock
        self._last: Optional[FleetGrant] = None  # guarded-by: _lock

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def last_grant(self) -> Optional[FleetGrant]:
        with self._lock:
            return self._last

    def initial_budgets(self, node_memory: float) -> Dict[str, float]:
        """Pre-telemetry budgets: floors plus a weight-share of the rest.

        What every tenant starts under before the first epoch closes --
        arbitration-policy-independent, so a fleet's startup transient
        does not depend on which policy it later runs.
        """
        k = len(self._names)
        f = np.maximum(self._floors[:, 0], MIN_TENANT_BUDGET)
        scale = min(1.0, node_memory / max(f.sum(), 1.0))
        f_eff = f * scale
        rem = max(node_memory - f_eff.sum(), 0.0)
        share = self._weights / self._weights.sum()
        b = f_eff + share * rem
        return {self._names[i]: float(b[i]) for i in range(k)}

    def allocate(self, telemetry: Dict[str, TenantTelemetry],
                 node_memory: float) -> FleetGrant:
        """Close one epoch: fold telemetry into next-epoch budgets.

        Missing tenants (no telemetry yet) bid their floor.  Pure numpy
        under the lock -- no device work, no I/O -- so a concurrent
        ticking fleet never blocks on arbitration for more than the
        policy arithmetic.
        """
        desired = np.array(
            [[telemetry[name].desired_bytes()
              if name in telemetry else 0.0]
             for name in self._names], np.float64)
        with self._lock:
            alloc = arbitrate_reference(
                desired, np.array([node_memory], np.float64),
                weights=self._weights, floors=self._floors[:, 0],
                priority_order=self._order, policy=self.spec.policy,
                rr_offset=self._rr_offset)
            self._rr_offset = (self._rr_offset + 1) % len(self._names)
            self._epoch += 1
            grant = FleetGrant(
                epoch=self._epoch, timestamp=time.time(),
                budgets={self._names[i]: float(alloc[i, 0])
                         for i in range(len(self._names))},
                policy=self.spec.policy)
            self._last = grant
            return grant
