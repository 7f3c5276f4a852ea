"""Train-step builder: CE + z-loss, microbatched gradient accumulation,
global-norm clipping, AdamW, optional int8 error-feedback compression.

A copy of ``repro/train/step.py``.  The returned function has JAX's
signature::

    step_fn(params, state, batch) -> (params, state, metrics)

``params`` is a dict of tensors keyed by the model's parameter names.
The model holds the function: ``step_fn`` points the model's
parameters at ``params`` (:func:`bind_params`, no copy), differentiates
``Model.loss`` with ``torch.autograd.grad`` and returns new tensors, to
which it points the model again; nothing passed in is changed.

Microbatching: the global batch is split into ``microbatches`` equal
slices run one after the other, with float32 gradients accumulated as
``g / n`` each and the loss as ``loss / n`` -- the activation-memory
knob.  The metrics stay tensors on the device; reading them syncs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from ..models.transformer import Model
from ..optim.adamw import AdamWState, adamw_init, adamw_update
from ..optim.compress import (CompressionState, compress_decompress,
                              compression_init)
from ..optim.schedules import linear_warmup_cosine

F32 = torch.float32
Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    clip_norm: float = 1.0
    compress: bool = False
    schedule: Callable = linear_warmup_cosine


class TrainState(NamedTuple):
    adam: AdamWState
    compression: Optional[CompressionState]


def init_train_state(params: Mapping[str, torch.Tensor],
                     cfg: TrainStepConfig) -> TrainState:
    return TrainState(
        adam=adamw_init(params),
        compression=compression_init(params) if cfg.compress else None,
    )


def model_params(model: Model) -> Params:
    """The model's parameters by name, detached (they share its memory
    as it stands now)."""
    return {n: p.detach() for n, p in model.named_parameters()}


@torch.no_grad()
def bind_params(model: Model, params: Mapping[str, torch.Tensor]) -> None:
    """Point each of the model's parameters at ``params``' tensor of its
    name (no copy), requiring grad."""
    for name, p in model.named_parameters():
        t = params[name]
        if t is not p:
            p.data = t
        p.requires_grad_(True)


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(F32))) for x in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def clip_by_global_norm(tree: Mapping[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Params, torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {n: x.to(F32) * scale for n, x in tree.items()}, norm


def build_train_step(model: Model, cfg: TrainStepConfig):
    """-> step_fn(params, state, batch)."""
    names = [n for n, _ in model.named_parameters()]

    def grad_fn(micro):
        loss, parts = model.loss(micro)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        return loss.detach(), {k: v.detach() for k, v in parts.items()}, \
            dict(zip(names, grads))

    def accumulate(batch):
        n = cfg.microbatches
        if n == 1:
            loss, parts, grads = grad_fn(batch)
            return grads, loss, parts
        split = {k: x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))
                 for k, x in batch.items()}
        acc = {name: torch.zeros(p.shape, dtype=F32, device=p.device)
               for name, p in model.named_parameters()}
        loss_acc = torch.zeros((), dtype=F32, device=model.device)
        for i in range(n):
            loss, _, grads = grad_fn({k: x[i] for k, x in split.items()})
            with torch.no_grad():
                for name, g in grads.items():
                    acc[name] += g.to(F32) / n
                loss_acc = loss_acc + loss / n
            del grads
        zero = torch.zeros((), dtype=F32, device=model.device)
        return acc, loss_acc, {"ce": loss_acc, "aux": zero}

    def step_fn(params: Mapping[str, torch.Tensor], state: TrainState,
                batch: Mapping[str, torch.Tensor]
                ) -> Tuple[Params, TrainState, Dict[str, torch.Tensor]]:
        bind_params(model, params)
        grads, loss, parts = accumulate(batch)
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
        comp = state.compression
        if cfg.compress:
            grads, comp = compress_decompress(grads, comp)
        lr = cfg.schedule(state.adam.step, peak_lr=cfg.peak_lr,
                          warmup_steps=cfg.warmup_steps,
                          total_steps=cfg.total_steps)
        new_params, adam = adamw_update(
            grads, state.adam, {n: params[n].detach() for n in names},
            lr=lr, b1=cfg.b1, b2=cfg.b2, weight_decay=cfg.weight_decay)
        bind_params(model, new_params)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr,
                   "step": adam.step, **parts}
        return new_params, TrainState(adam=adam, compression=comp), metrics

    return step_fn
