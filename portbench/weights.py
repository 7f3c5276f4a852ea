"""Seeded weights, drawn on the device a block at a time.

Each block of :func:`portbench.reference.model.layout` (the embedding,
each layer, the head) is one standard-normal draw from a
``torch.Generator`` on the device, seeded from the run's seed and the
block's index, and cut into the block's leaves, each scaled by its
kind in place.  So the program is handed every weight in a few large
calls, and the reference draws any block again, bit for bit, after the
program's state is freed.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import torch

from .reference.model import layout, std_of

F32 = torch.float32
_MIX = 0x9E3779B97F4A7C15


def block_seed(seed: int, index: int) -> int:
    """A 63-bit generator seed for block ``index`` of a run's ``seed``."""
    return (int(seed) * 1_000_003 + index * _MIX + 1) % (1 << 63)


def draw_block(arch: dict, seed: int, index: int,
               device: torch.device) -> Dict[str, torch.Tensor]:
    """Block ``index`` of ``arch``'s layout: {name: tensor}, views of one
    float32 buffer."""
    _, leaves = layout(arch)[index]
    total = sum(math.prod(shape) for _, shape, _ in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(block_seed(seed, index))
    flat = torch.randn(total, generator=gen, dtype=F32, device=device)
    out, at = {}, 0
    for name, shape, kind in leaves:
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        t.mul_(std_of(shape, kind))
        if kind == "one":
            t.add_(1.0)
        out[name] = t
        at += n
    return out


def draw(arch: dict, seed: int, device: torch.device
         ) -> Iterator[Tuple[str, Dict[str, torch.Tensor]]]:
    """Every block in order: (block name, its leaves)."""
    for i, (name, _) in enumerate(layout(arch)):
        yield name, draw_block(arch, seed, i, device)


def block_drawer(arch: dict, seed: int, device: torch.device):
    """``weights(block name) -> leaves``, for the reference."""
    index = {name: i for i, (name, _) in enumerate(layout(arch))}
    return lambda name: draw_block(arch, seed, index[name], device)
