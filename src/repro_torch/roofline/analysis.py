"""Three-term roofline of a step on the H100 (the counterpart of JAX's
``roofline/analysis.py``).

    compute    = FLOPs          / (chips * peak_FLOP/s of the step's type)
    memory     = bytes          / (chips * HBM_bw)
    collective = collective_B   / (chips * link_bw)

:func:`model_flops` and :func:`roofline_terms` are JAX's, with the same
arguments and keys.  :func:`analyze_step` stands where JAX's
``analyze_compiled`` does: it counts one run of the step
(:func:`.cost.step_cost`) in place of reading a compiled artifact, and
returns the same row keys where they make sense.  MODEL_FLOPS is the
analytic useful work (6·N·D train, 2·N·D inference, N_active for MoE);
its ratio against the counted FLOPs exposes remat recompute and
dispatch overhead.  The MFU bound is taken against the peak of the
step's type (``desc["dtype"]``, float32 by default), not a fixed bf16
one.
"""

from __future__ import annotations

from typing import Callable, Dict

from .constants import HBM_BW, ICI_BW, PEAK_BY_DTYPE, PEAK_FLOPS
from .cost import step_cost


def model_flops(n_params: int, n_active: int, tokens: int,
                kind: str) -> float:
    n = n_active or n_params
    if kind == "train":
        return 6.0 * n * tokens
    return 2.0 * n * tokens          # prefill / decode forward-only


def roofline_terms(*, hlo_flops_per_chip: float, hlo_bytes_per_chip: float,
                   collective_bytes_per_chip: float,
                   peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
                   ici_bw: float = ICI_BW) -> Dict[str, float]:
    compute = hlo_flops_per_chip / peak_flops
    memory = hlo_bytes_per_chip / hbm_bw
    collective = collective_bytes_per_chip / ici_bw
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    dominant = max(terms, key=terms.get)
    bound = max(compute, memory, collective)
    total = max(bound, 1e-30)
    return {
        **terms,
        "dominant": dominant.replace("_s", ""),
        "bound_s": bound,
        "compute_fraction_of_roofline": compute / total,
    }


def analyze_step(fn: Callable, *args, desc: dict, n_chips: int = 1,
                 **kwargs) -> dict:
    """The roofline row of one step: ``fn(*args, **kwargs)`` run once
    under :func:`.cost.step_cost`.  ``desc`` carries ``n_params``,
    ``tokens``, ``kind`` ("train", "prefill" or "decode"), optionally
    ``n_active_params`` and ``dtype`` (a key of
    :data:`~.constants.PEAK_BY_DTYPE`)."""
    cost = step_cost(fn, *args, **kwargs)
    flops, nbytes = cost["flops"] / n_chips, cost["bytes"] / n_chips
    peak = PEAK_BY_DTYPE[desc.get("dtype", "float32")]
    terms = roofline_terms(
        hlo_flops_per_chip=flops, hlo_bytes_per_chip=nbytes,
        collective_bytes_per_chip=cost["collective_bytes"] / n_chips,
        peak_flops=peak)
    mf = model_flops(desc["n_params"], desc.get("n_active_params", 0),
                     desc["tokens"], desc["kind"])
    mf_per_chip = mf / n_chips
    return {
        **desc,
        "n_chips": n_chips,
        "hlo_flops_per_chip": flops,
        "hlo_bytes_per_chip": nbytes,
        "bytes_by_op": cost["bytes_by_op"],
        "kernels": cost["kernels"],
        "collectives": cost["collectives"],
        "roofline": terms,
        "model_flops_total": mf,
        "model_flops_per_chip": mf_per_chip,
        "useful_flops_ratio": (mf_per_chip / flops) if flops else 0.0,
        "step_time_bound_s": terms["bound_s"],
        "model_flops_utilization_bound": (
            mf_per_chip / peak / terms["bound_s"]
            if terms["bound_s"] > 0 else 0.0),
    }
