"""DynIMS controller parameters: paper Table I, the ScenarioLab presets
and the framework's memory tiers.

A copy of ``repro/configs/dynims.py`` over the port's own
:class:`~repro_torch.core.control.ControllerParams`.
``LAB_TUNED`` holds the argmax of the default widened grid at
``budget=100``, seed 0, per named scenario (objective in
``LAB_TUNED_OBJECTIVES``); the port's tuner must reproduce each one
exactly, which ``chip_smoke.py`` checks on the card.
"""

from __future__ import annotations

from typing import Dict, List

from ..core.control import ControllerParams, GiB

# The paper's exact Table I configuration.
PAPER_TABLE_I = ControllerParams(
    total_memory=125.0 * GiB,
    r0=0.95,
    lam=0.5,
    u_min=0.0,
    u_max=60.0 * GiB,
    interval_s=0.1,
)

LAB_TUNED: Dict[str, ControllerParams] = {
    "bursty-serving": PAPER_TABLE_I.replace(r0=0.935, lam=1.6,
                                            lam_grant=0.25),
    "swap-storm": PAPER_TABLE_I.replace(r0=0.90, lam=1.6, lam_grant=0.25),
    "hetero-fleet": PAPER_TABLE_I.replace(r0=0.97, lam=1.6, lam_grant=0.25),
    "failover-churn": PAPER_TABLE_I.replace(r0=0.98, lam=0.95),
    "spark-iterative-cache": PAPER_TABLE_I.replace(r0=0.935, lam=1.6,
                                                   feedforward=0.5),
    "cache-churn": PAPER_TABLE_I.replace(r0=0.90, lam=1.6, feedforward=0.5),
}

# Which tuning objective produced each preset ("default" when absent).
LAB_TUNED_OBJECTIVES: Dict[str, str] = {
    "spark-iterative-cache": "runtime",
    "cache-churn": "runtime",
}

# The registry names of the paper's Sec. IV.A scenarios.
PAPER_SCENARIOS = ("paper-c1-spark45", "paper-c2-static25",
                   "paper-c3-dynims60", "paper-c4-nohpcc")


def tuned_params(scenario: str, **overrides) -> ControllerParams:
    """The checked-in ScenarioLab preset for a named scenario.

    The paper's own scenarios resolve to Table I itself; unknown names
    raise with the choices.
    """
    if scenario in PAPER_SCENARIOS:
        base = PAPER_TABLE_I
    else:
        try:
            base = LAB_TUNED[scenario]
        except KeyError:
            known = ", ".join(sorted(LAB_TUNED) + list(PAPER_SCENARIOS))
            raise KeyError(
                f"no tuned preset for {scenario!r} (have: {known}); run "
                "repro_torch.lab.tune_gains to derive one") from None
    return base.replace(**overrides) if overrides else base


def tuned_scenarios() -> List[str]:
    return sorted(LAB_TUNED)


def host_cache_params(total_host_ram: float, *, u_max_frac: float = 0.5,
                      **overrides) -> ControllerParams:
    """Dataset shard cache in host RAM (paper roles preserved)."""
    kw = dict(total_memory=total_host_ram, r0=0.95, lam=0.5, u_min=0.0,
              u_max=u_max_frac * total_host_ram, interval_s=0.1)
    kw.update(overrides)
    return ControllerParams(**kw)


def hbm_pool_params(hbm_bytes: float = 16 * GiB, *,
                    u_max_frac: float = 0.85, **overrides) -> ControllerParams:
    """Serving KV-block pool in device memory: tighter r0 (running out
    of memory is fatal on the device), faster reclaim than grant
    (beyond-paper asymmetric gains).  ``hbm_bytes`` sizes only ``u_max``
    here: the plane replaces ``total_memory`` with the monitor's total
    at its first interval."""
    kw = dict(total_memory=hbm_bytes, r0=0.92, lam=0.8, lam_grant=0.3,
              u_min=0.0, u_max=u_max_frac * hbm_bytes, interval_s=0.05)
    kw.update(overrides)
    return ControllerParams(**kw)
