"""Learning-rate schedules (pure functions of the step counter).

A copy of ``repro/optim/schedules.py``.  The step becomes a float32
tensor on its own device (``jnp.asarray(step, float32)``), so a step
counter on the card gives a rate on the card with no host sync.
"""

from __future__ import annotations

import math

import torch

F32 = torch.float32


def _step(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(F32)
    return torch.tensor(step, dtype=F32)


def linear_warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                         total_steps: int, final_frac: float = 0.1
                         ) -> torch.Tensor:
    step = _step(step)
    # (step+1): the first step must train, not idle at lr=0
    warm = peak_lr * (step + 1) / max(warmup_steps, 1)
    progress = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    progress = progress.clamp(0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (
        1 + torch.cos(math.pi * progress))
    return torch.where(step < warmup_steps, warm, peak_lr * cos)


def constant(step, *, peak_lr: float, **_) -> torch.Tensor:
    return torch.full_like(_step(step), peak_lr)
