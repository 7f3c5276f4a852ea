"""AdamW with decoupled weight decay and float32 moments.

A copy of ``repro/optim/adamw.py``, functional as there:
``adamw_init(params) -> state`` and ``adamw_update(grads, state,
params, lr=...) -> (new_params, new_state)``, over dicts of tensors
keyed by the port's parameter names.  Nothing is updated in place, and
the update runs under ``torch.no_grad()``.  ``torch.optim.AdamW`` is
not used: it multiplies the decay by ``lr`` apart from the Adam step,
where JAX adds it to ``delta`` first, and it decays every tensor.

Which tensors decay follows the JAX package's arrays, not the port's:
JAX decays arrays with ``ndim >= 2``, and it stacks every layer's
parameters along a leading layer axis (the encoder's and the cross
layers' too), so a layer's (d,) norm and layernorm bias are (L, d)
arrays there and decay, and so does a vlm cross layer's (1,) gate;
only ``final_norm`` and ``enc_norm`` (and their biases) do not
(:func:`decays`).
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple

import torch

F32 = torch.float32

# Parameters under these prefixes are stacked along a layer axis in JAX.
STACKED_PREFIXES = ("layers.", "cross_layers.", "enc_layers.")


class AdamWState(NamedTuple):
    step: torch.Tensor                  # int32 scalar
    mu: Dict[str, torch.Tensor]         # first moment (float32)
    nu: Dict[str, torch.Tensor]         # second moment (float32)


def adamw_init(params: Mapping[str, torch.Tensor]) -> AdamWState:
    first = next(iter(params.values()))
    zeros = {n: torch.zeros(p.shape, dtype=F32, device=p.device)
             for n, p in params.items()}
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        mu=zeros,
        nu={n: torch.zeros_like(z) for n, z in zeros.items()},
    )


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether JAX's ``p.ndim >= 2`` holds for this parameter's JAX array
    (one axis more for a parameter of the layer stack)."""
    return p.ndim + name.startswith(STACKED_PREFIXES) >= 2


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], state: AdamWState,
                 params: Mapping[str, torch.Tensor], *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1):
    step = state.step + 1
    t = step.to(F32)
    c1 = 1.0 - torch.pow(b1, t)
    c2 = 1.0 - torch.pow(b2, t)
    new_params, new_mu, new_nu = {}, {}, {}
    for name, p in params.items():
        g = grads[name].to(F32)
        m = b1 * state.mu[name] + (1 - b1) * g
        v = b2 * state.nu[name] + (1 - b2) * g * g
        mhat = m / c1
        vhat = v / c2
        delta = mhat / (torch.sqrt(vhat) + eps)
        if weight_decay and decays(name, p):   # none on the last norms
            delta = delta + weight_decay * p.to(F32)
        new_params[name] = (p.to(F32) - lr * delta).to(p.dtype)
        new_mu[name], new_nu[name] = m, v
    return new_params, AdamWState(step=step, mu=new_mu, nu=new_nu)
