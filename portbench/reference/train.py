"""Plain reference of the first training steps: loss, gradient, AdamW.

The stated optimizer, step by step: the loss of
:func:`portbench.reference.model.train_loss` over the whole batch, its
gradient clipped to the global norm ``clip_norm``, then AdamW with the
decay added to the Adam step before the rate (every leaf decays but
those in ``no_decay``), at the rate of a linear warm-up and a cosine
decay to ``final_frac`` of the peak.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from .model import train_loss

F32 = torch.float32


def rate(opt: dict, step: int) -> float:
    """The learning rate of (0-based) ``step``."""
    peak, warm = opt["peak_lr"], max(opt["warmup_steps"], 1)
    if step < warm:
        return peak * (step + 1) / warm
    progress = (step - warm) / max(opt["total_steps"] - warm, 1)
    progress = min(max(progress, 0.0), 1.0)
    ff = opt["final_frac"]
    return peak * (ff + (1 - ff) * 0.5 * (1 + math.cos(math.pi * progress)))


def steps(arch: dict, opt: dict, z_loss: float,
          params: Dict[str, torch.Tensor],
          batches: List[Tuple[torch.Tensor, torch.Tensor]],
          routes: Optional[List[dict]] = None
          ) -> Tuple[List[float], Dict[str, float]]:
    """Train ``params`` (updated in place) on ``batches``; returns each
    step's loss and the norm of every leaf's first clipped gradient.
    ``routes``: each step's routing record for :func:`train_loss`
    (choices to follow; its ``gap`` and ``own`` are filled in)."""
    names = list(params)
    for p in params.values():
        p.requires_grad_(True)
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    losses, first = [], {}
    for t, (tokens, labels) in enumerate(batches):
        loss = train_loss(arch, params, tokens, labels, z_loss,
                          None if routes is None else routes[t])
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        losses.append(float(loss.detach()))
        del loss
        with torch.no_grad():
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = min(opt["clip_norm"] / max(float(norm), 1e-12), 1.0)
            lr = rate(opt, t)
            for n, g in zip(names, grads):
                g = g * scale
                if t == 0:
                    first[n] = float(torch.linalg.vector_norm(g))
                p = params[n]
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).add_(g * g, alpha=1 - b2)
                delta = (m[n] / (1 - b1 ** (t + 1))) / (
                    torch.sqrt(v[n] / (1 - b2 ** (t + 1))) + eps)
                if n not in opt["no_decay"]:
                    delta = delta + opt["weight_decay"] * p
                p.sub_(lr * delta)
        del grads
    for p in params.values():
        p.requires_grad_(False)
    return losses, first
