"""Glue between the benchmark's data files and the program under test.

Builds the port's ``ArchConfig`` from a configuration file, and its
``Model`` with the benchmark's seeded weights (the model is made on the
meta device and every parameter is pointed at a drawn block), after
checking that the model's parameters are exactly the layout the weights
are drawn in.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch
from torch import nn

from . import weights as W
from .reference.model import layout

HERE = os.path.dirname(os.path.abspath(__file__))


def load_config(name: str) -> dict:
    with open(os.path.join(HERE, "configs", name + ".json")) as fh:
        cfg = json.load(fh)
    check_config(cfg)
    return cfg


def check_config(cfg: dict) -> None:
    """Raise where a configuration asks for what the benchmark does not
    build: weights in another type than float32 (:mod:`.weights` draws
    float32), or a plane other than ``hbm_pool_params``'."""
    if cfg["dtype"] != "float32":
        raise ValueError(f"{cfg['name']}: dtype {cfg['dtype']!r} is not "
                         f"implemented (weights are drawn in float32)")
    preset = cfg.get("plane", {}).get("preset", "hbm_pool_params")
    if preset != "hbm_pool_params":
        raise ValueError(f"{cfg['name']}: plane preset {preset!r} is not "
                         f"implemented")


def arch_config(cfg: dict):
    """The port's ``ArchConfig`` of a configuration file's ``arch``."""
    from repro_torch.configs.base import ArchConfig

    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    kw = {k: v for k, v in cfg["arch"].items() if k in fields}
    return ArchConfig(name=cfg["name"], **kw)


def check_layout(model, arch: dict) -> None:
    """Raise unless the model's parameters are the layout's, name for
    name and shape for shape."""
    want = {name: tuple(shape) for _, leaves in layout(arch)
            for name, shape, _ in leaves}
    have = {n: tuple(p.shape) for n, p in model.named_parameters()}
    if want != have:
        missing = sorted(set(want) - set(have))
        extra = sorted(set(have) - set(want))
        shapes = sorted(n for n in set(want) & set(have)
                        if want[n] != have[n])
        raise RuntimeError(f"the program's parameters are not the "
                           f"benchmark's layout: missing {missing[:5]}, "
                           f"extra {extra[:5]}, other shapes {shapes[:5]}")


def build_model(cfg: dict, seed: int, device: torch.device, **model_kw):
    """The port's ``Model`` of ``cfg`` holding the weights of ``seed``."""
    from repro_torch.models import Model
    from repro_torch.models.moe import padded_experts

    arch = cfg["arch"]
    port_cfg = arch_config(cfg)
    if port_cfg.is_moe and padded_experts(port_cfg) != arch[
            "experts_padded_to"]:
        raise RuntimeError("the program pads the experts otherwise than "
                           "the configuration states")
    model = Model(port_cfg, device="meta", init=False, **model_kw)
    check_layout(model, arch)
    for _, leaves in W.draw(arch, seed, device):
        for name, t in leaves.items():
            owner, _, leaf = name.rpartition(".")
            module = model.get_submodule(owner) if owner else model
            setattr(module, leaf, nn.Parameter(t, requires_grad=False))
    return model
