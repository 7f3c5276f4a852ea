"""Collective bytes of a step (the counterpart of JAX's
``roofline/hlo.py::parse_collectives``).

JAX reads every collective out of the compiled HLO text and sums each
one's operand bytes -- the payload a chip must move -- by op kind.  The
port compiles no program: a sharded path reports each fold and exchange
over its shards as it issues it (:func:`repro_torch.kernels.
count_collective`: the HLO kind JAX would run, and the shards' operand
bytes from their shapes), and :func:`.cost.step_cost` hands the records
here.  A fold over shards is an ``all-reduce``, as JAX's ``psum``,
``pmax`` and ``pmin`` are.  The bytes are every shard's: divide by the
chips for JAX's per-chip count, as :func:`.analysis.analyze_step` does.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute")


def parse_collectives(records: Iterable[Tuple[str, float]]
                      ) -> Dict[str, object]:
    """Sum the reported ``(kind, bytes)`` records by kind, with JAX's
    keys: ``total_bytes``, ``per_kind_bytes``, ``per_kind_count``,
    ``n_ops`` and ``largest`` (the ten largest ``(kind, bytes)``)."""
    per_kind: Dict[str, float] = defaultdict(float)
    per_kind_count: Dict[str, int] = defaultdict(int)
    ops: List[Tuple[str, float]] = []
    for kind, nbytes in records:
        if kind not in COLLECTIVE_OPS:
            raise ValueError(f"unknown collective {kind!r}; expected one "
                             f"of {COLLECTIVE_OPS}")
        if nbytes == 0:
            continue
        per_kind[kind] += float(nbytes)
        per_kind_count[kind] += 1
        ops.append((kind, float(nbytes)))
    return {
        "total_bytes": float(sum(per_kind.values())),
        "per_kind_bytes": dict(per_kind),
        "per_kind_count": dict(per_kind_count),
        "n_ops": len(ops),
        "largest": sorted(ops, key=lambda t: -t[1])[:10],
    }
