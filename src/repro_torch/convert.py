"""Convert the JAX package's parameters, given as numpy, into the port's.

The controller's gains -- :class:`GainSet` and :class:`ControllerParams`
-- cross over as plain numpy arrays and floats (``dataclasses.asdict``
or a field-by-field dict).  A model's parameter pytree crosses over as
``jax.tree.map(np.asarray, params)``, its layers stacked flat or in the
grouped local:global stack, into the port's :class:`Model`
(:func:`model_params_from_numpy`), and an optimizer's ``AdamWState``
(stacked moments and the step) into the port's
(:func:`train_state_from_numpy`), so a JAX checkpoint resumes in the
port.  Both packages then compute on identical numbers while neither
imports the other.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping

import numpy as np
import torch

from .configs.base import ArchConfig
from .core.control import ControllerParams
from .device import DeviceLike
from .lab.sweep import GainSet
from .models.transformer import Model
from .optim.adamw import AdamWState


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


def _index(tree, *idx):
    """Every array of a nested dict at index ``idx`` of its leading axes."""
    if isinstance(tree, Mapping):
        return {k: _index(v, *idx) for k, v in tree.items()}
    return np.asarray(tree)[idx]


def _stacked(tree: Mapping) -> int:
    """The length of a stack's leading axis (that of its first array)."""
    while isinstance(tree, Mapping):
        tree = next(iter(tree.values()))
    return len(tree)


def _layer_trees(layers: Mapping, cfg: ArchConfig) -> List[Mapping]:
    """The JAX stack's per-layer trees, in the order of the port's layers.

    ``["flat"]`` gives layer i at index i; the grouped local:global stack
    of ``_windowed_stack_schema`` (period p, n_groups = L // p) gives
    ``["groups"]["locals"][g][j]`` -> layer g * p + j,
    ``["groups"]["glob"][g]`` -> layer g * p + p - 1 and ``["tail"][t]`` ->
    layer n_groups * p + t.
    """
    p = cfg.global_every
    grouped = bool(cfg.sliding_window and p) and cfg.n_layers >= p
    if set(layers) - {"flat", "groups", "tail"} \
            or grouped != ("groups" in layers):
        raise ValueError(f"{cfg.name} stacks its layers "
                         f"{'grouped' if grouped else 'flat'}; the tree "
                         f"holds {sorted(layers)}")
    if not grouped:
        return [_index(layers["flat"], i)
                for i in range(_stacked(layers["flat"]))]
    groups = layers["groups"]
    out = []
    for g in range(_stacked(groups["glob"])):
        out += [_index(groups["locals"], g, j) for j in range(p - 1)]
        out.append(_index(groups["glob"], g))
    if "tail" in layers:
        out += [_index(layers["tail"], t)
                for t in range(_stacked(layers["tail"]))]
    return out


def _stacks(tree: Mapping, cfg: ArchConfig) -> Dict[str, List[Mapping]]:
    """The per-layer trees of each of the port's layer lists, by name.

    vlm: ``layers["selfs"][g][j]`` -> ``layers`` g * cross_attn_group +
    j and ``layers["cross"][g]`` -> ``cross_layers`` g; audio:
    ``enc_layers[i]`` -> ``enc_layers`` i and ``layers[i]`` -> ``layers``
    i, stacked directly (``Model.schema``); ssm: ``layers[key][p]`` for
    each block ``key`` of the pattern (``"0_mlstm"``, ``"1_slstm"``) ->
    pair p of ``layers``; the other families as :func:`_layer_trees`
    gives them.
    """
    layers = tree["layers"]
    if cfg.family == "ssm":
        keys = {f"{i}_{kind}" for i, kind in enumerate(cfg.block_pattern)}
        if set(layers) != keys:
            raise ValueError(f"{cfg.name} stacks pairs of {sorted(keys)}; "
                             f"the tree holds {sorted(layers)}")
        return {"layers": [_index(layers, p)
                           for p in range(_stacked(layers))]}
    if cfg.family == "vlm":
        if set(layers) != {"selfs", "cross"}:
            raise ValueError(f"{cfg.name} stacks groups of selfs and a "
                             f"cross layer; the tree holds {sorted(layers)}")
        n, g = _stacked(layers["cross"]), cfg.cross_attn_group
        return {"layers": [_index(layers["selfs"], i, j) for i in range(n)
                           for j in range(g)],
                "cross_layers": [_index(layers["cross"], i)
                                 for i in range(n)]}
    if cfg.family == "audio":
        return {name: [_index(tree[name], i)
                       for i in range(_stacked(tree[name]))]
                for name in ("enc_layers", "layers")}
    return {"layers": _layer_trees(layers, cfg)}


def _named(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Dotted names of a nested dict's arrays, as the port names its
    parameters: a norm's ``scale`` is the norm itself and its ``bias``
    the norm's name with ``_bias``; JAX's ``embed`` holds the model's
    ``tokens`` and ``unembed``."""
    out = {}
    for k, v in tree.items():
        name = prefix + k
        if isinstance(v, Mapping):
            out.update(_named(v, "" if k == "embed" else name + "."))
        elif k in ("scale", "bias"):
            out[prefix[:-1] + ("_bias" if k == "bias" else "")] = \
                np.asarray(v)
        else:
            out[name] = np.asarray(v)
    return out


def _port_arrays(tree: Mapping, cfg: ArchConfig) -> Dict[str, np.ndarray]:
    """A parameter-shaped JAX tree's arrays under the port's names."""
    stacks = _stacks(tree, cfg)
    want = {"layers": cfg.n_layers, "enc_layers": cfg.n_encoder_layers,
            "cross_layers": cfg.n_layers // max(cfg.cross_attn_group, 1)}
    if cfg.family == "vlm":
        want["layers"] = want["cross_layers"] * cfg.cross_attn_group
    if cfg.family == "ssm":
        want["layers"] = cfg.n_layers // len(cfg.block_pattern)
    for name, layers in stacks.items():
        if len(layers) != want[name]:
            raise ValueError(f"the tree stacks {len(layers)} {name}, "
                             f"{cfg.name} has {want[name]}")
    arrays = _named({k: v for k, v in tree.items() if k not in stacks})
    for name, layers in stacks.items():
        for i, layer in enumerate(layers):
            arrays.update(_named(layer, f"{name}.{i}."))
    return arrays


def _check_names(want, have) -> None:
    missing, extra = set(want) - set(have), set(have) - set(want)
    if missing or extra:
        raise ValueError(f"parameters missing from the tree: "
                         f"{sorted(missing)}; parameters the port does not "
                         f"carry: {sorted(extra)}")


def model_params_from_numpy(tree: Mapping, cfg: ArchConfig, *,
                            device: DeviceLike = None) -> Model:
    """A :class:`Model` holding the JAX parameter pytree's numbers.

    The JAX names and layouts carry over unchanged: ``wq`` (d, H, hd),
    ``wk``/``wv`` (d, KV, hd), attention ``wo`` (H, hd, d), ``wi``/``wg``
    (d, f), MLP ``wo`` (f, d), the Mamba leaves of ``mamba_schema``, the
    experts of ``moe_schema`` (``moe.router`` (d, E_pad), ``moe.wi``/
    ``moe.wg`` (E_pad, d, f), ``moe.wo`` (E_pad, f, d), and the shared
    experts' ``moe.shared.{wi, wg, wo, gate}``), ``tokens`` (Vp, d) and,
    untied, ``unembed`` (d, Vp); a norm's ``scale`` and, layernorm, its
    ``bias``.  The layer stack, flat or grouped, maps onto the port's
    flat layers (:func:`_layer_trees`); the vlm family's groups of
    ``selfs`` and a ``cross`` layer, the audio family's ``enc_layers``,
    and the ssm family's pairs (``layers["0_mlstm"|"1_slstm"]["norm"|
    "block"]``, the mLSTM and sLSTM leaves of ``mlstm_schema`` and
    ``slstm_schema``), onto theirs (:func:`_stacks`).  The model's type
    is the arrays' type.
    Raises on a missing, extra or misshapen array.
    """
    dtype = torch.from_numpy(
        np.empty(0, np.asarray(tree["embed"]["tokens"]).dtype)).dtype
    model = Model(cfg, dtype=dtype, device=device, init=False)
    arrays = _port_arrays(tree, cfg)
    params = dict(model.named_parameters())
    _check_names(params, arrays)
    with torch.no_grad():
        for name, param in params.items():
            src = torch.from_numpy(np.array(arrays[name]))
            if tuple(src.shape) != tuple(param.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} where "
                                 f"the port has {tuple(param.shape)}")
            param.copy_(src)
    return model


def train_state_from_numpy(adam_tree, model: Model) -> AdamWState:
    """The port's :class:`AdamWState` from JAX's, as numpy.

    ``adam_tree`` is JAX's ``AdamWState`` (or a mapping with its fields)
    after ``jax.tree.map(np.asarray, ...)`` or a restored checkpoint's
    ``"opt"``: ``mu`` and ``nu`` parameter-shaped, stacked as the
    parameters are (:func:`_stacks`), ``step`` an int32 scalar.
    The moments land under the model's parameter names, float32, on the
    model's device.  Raises on a missing, extra or misshapen array.
    """
    get = (adam_tree.get if isinstance(adam_tree, Mapping)
           else lambda k: getattr(adam_tree, k))
    params = dict(model.named_parameters())
    moments = {}
    for field in ("mu", "nu"):
        arrays = _port_arrays(get(field), model.cfg)
        _check_names(params, arrays)
        moments[field] = {}
        for name, p in params.items():
            a = np.asarray(arrays[name], np.float32)
            if a.shape != tuple(p.shape):
                raise ValueError(f"{field} {name}: shape {a.shape} where "
                                 f"the port has {tuple(p.shape)}")
            moments[field][name] = torch.from_numpy(a.copy()).to(p.device)
    step = torch.tensor(int(np.asarray(get("step"))), dtype=torch.int32,
                        device=model.device)
    return AdamWState(step=step, mu=moments["mu"], nu=moments["nu"])
