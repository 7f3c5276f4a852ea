"""Convert the JAX package's parameters, given as numpy, into the port's.

The controller's gains -- :class:`GainSet` and :class:`ControllerParams`
-- cross over as plain numpy arrays and floats (``dataclasses.asdict``
or a field-by-field dict).  A model's parameter pytree crosses over as
``jax.tree.map(np.asarray, params)``, stacked layers under
``["layers"]["flat"]``, into the port's :class:`Model`
(:func:`model_params_from_numpy`).  Both packages then compute on
identical numbers while neither imports the other.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .configs.base import ArchConfig
from .core.control import ControllerParams
from .device import DeviceLike
from .lab.sweep import GainSet
from .models.transformer import Model


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


def model_params_from_numpy(tree: Mapping, cfg: ArchConfig, *,
                            device: DeviceLike = None) -> Model:
    """A :class:`Model` holding the JAX parameter pytree's numbers.

    The JAX layouts carry over unchanged: ``wq`` (d, H, hd),
    ``wk``/``wv`` (d, KV, hd), attention ``wo`` (H, hd, d), ``wi``/``wg``
    (d, f), MLP ``wo`` (f, d), ``tokens`` (Vp, d); layer ``i`` takes
    index ``i`` of the stack's leading axis.  The model's type is the
    arrays' type.  Raises on a missing, extra or misshapen array.
    """
    stack = tree["layers"]["flat"]
    dtype = torch.from_numpy(
        np.empty(0, np.asarray(tree["embed"]["tokens"]).dtype)).dtype
    model = Model(cfg, dtype=dtype, device=device, init=False)
    pairs = [(model.tokens, tree["embed"]["tokens"]),
             (model.final_norm, tree["final_norm"]["scale"])]
    for i, layer in enumerate(model.layers):
        pairs += [(layer.attn_norm, stack["attn_norm"]["scale"][i]),
                  (layer.mlp_norm, stack["mlp_norm"]["scale"][i])]
        pairs += [(getattr(layer.attn, n), stack["attn"][n][i])
                  for n in ("wq", "wk", "wv", "wo")]
        pairs += [(getattr(layer.mlp, n), stack["mlp"][n][i])
                  for n in ("wi", "wg", "wo")]
    if len(stack["attn_norm"]["scale"]) != cfg.n_layers:
        raise ValueError(f"the tree stacks {len(stack['attn_norm']['scale'])}"
                         f" layers, {cfg.name} has {cfg.n_layers}")
    extra = set(stack["attn"]) - {"wq", "wk", "wv", "wo"} \
        | set(stack["mlp"]) - {"wi", "wg", "wo"}
    if extra:
        raise ValueError(f"parameters the port does not carry: "
                         f"{sorted(extra)}")
    with torch.no_grad():
        for param, arr in pairs:
            src = torch.from_numpy(np.array(arr))
            if tuple(src.shape) != tuple(param.shape):
                raise ValueError(f"shape {tuple(src.shape)} where the port "
                                 f"has {tuple(param.shape)}")
            param.copy_(src)
    return model
