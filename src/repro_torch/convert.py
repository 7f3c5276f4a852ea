"""Convert the JAX package's parameters, given as numpy, into the port's.

This system has no model weights; its parameters are the controller's
gains.  The JAX package's :class:`GainSet` and :class:`ControllerParams`
cross over as plain numpy arrays and floats (``dataclasses.asdict`` or
a field-by-field dict), so both packages compute on identical gains
while neither imports the other.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np

from .core.control import ControllerParams
from .lab.sweep import GainSet


def gainset_from_numpy(fields: Mapping[str, np.ndarray]) -> GainSet:
    """A :class:`GainSet` from its seven field arrays, by name."""
    names = [f.name for f in dataclasses.fields(GainSet)]
    missing = set(names) - set(fields)
    extra = set(fields) - set(names)
    if missing or extra:
        raise ValueError(f"GainSet fields mismatch: missing "
                         f"{sorted(missing)}, unexpected {sorted(extra)}")
    return GainSet(**{n: np.asarray(fields[n]) for n in names})


def params_from_dict(d: Mapping[str, object]) -> ControllerParams:
    """A :class:`ControllerParams` from a dict of its fields."""
    names = {f.name for f in dataclasses.fields(ControllerParams)}
    extra = set(d) - names
    if extra:
        raise ValueError(f"unexpected ControllerParams fields "
                         f"{sorted(extra)}")
    return ControllerParams(**dict(d))
