"""Analytic eviction-policy models (the sweep engine's reuse abstraction).

The part of ``repro/core/eviction.py`` the port needs: the per-key
policies stay with the JAX package's live stores, and only the analytic
:class:`PolicyModel` table that the scenarios and the CacheLoop carry
read is copied here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class PolicyModel:
    """Analytic stand-in for a policy inside the vectorized sweep.

    The discrete policies above run per-key; the ScenarioLab sweep
    engine (``repro_torch.lab.fused_sweep``) cannot, so it models a cache holding a
    fraction ``f`` of the working set under Zipf(``alpha``)-skewed
    reuse with the hit curve

        h(f) = c * f**(1 - alpha) + (1 - c) * f

    ``concentration`` ``c`` is how closely the policy approximates
    keeping exactly the hottest ``f`` fraction resident (the
    frequency-ideal mass of the top-``f`` slice is ``f**(1-alpha)``):
    LFU with the scan-resistant admission filter tracks it, LRU mixes
    recency in and captures less of the skew, FIFO barely exploits it.
    At ``alpha == 0`` (uniform / cyclic-scan reuse) every policy
    degrades to ``h = f``, matching the admission-stabilized resident
    prefix :class:`~repro.core.store.ShardCache` sustains under cyclic
    scans (Sec. IV.B).
    """

    concentration: float

    def __post_init__(self) -> None:
        if not (0.0 <= self.concentration <= 1.0):
            raise ValueError("concentration must be in [0, 1]")


POLICY_MODELS: Dict[str, PolicyModel] = {
    "lfu": PolicyModel(concentration=1.0),
    "adaptive": PolicyModel(concentration=0.9),
    "lru": PolicyModel(concentration=0.65),
    "fifo": PolicyModel(concentration=0.35),
}


def policy_model(name: str) -> PolicyModel:
    """The analytic :class:`PolicyModel` behind a named policy."""
    try:
        return POLICY_MODELS[name]
    except KeyError:
        raise ValueError(f"no analytic model for policy {name!r}; "
                         f"available: {sorted(POLICY_MODELS)}") from None
