"""Mixture-of-Experts: a top-k router and grouped capacity (GShard) dispatch.

The port of ``repro/models/moe.py`` (``padded_experts``, ``moe_schema``,
``_group_size``, ``moe_apply``).  Tokens are flattened to (B·S) and cut
into contiguous groups of :func:`_group_size` tokens, so a group mixes
sequences; each expert takes at most ``cap`` (token, choice) pairs of a
group, counted token-major and choice-minor, and drops the rest.

JAX dispatches and combines through per-group one-hots (``disp``,
``comb``: (G, Sg, E, cap)) contracted with einsums.  Here the kept pairs
are scattered into the (G, E, cap, d) expert buffers by index and the
expert outputs gathered back: a one-hot contraction adds exact zeros, so
the buffers hold the same numbers and the combine adds the same k
products, in another order.  The expert products are batched matrix
products over every padded expert, as JAX's einsums are.

Expert padding: when ``n_experts`` does not divide by the expert-
parallel hint (qwen2-moe: 60 % 16 != 0), the experts are padded to the
next multiple with dummies whose router logits are -1e30, so no token
chooses them.  Shared experts (qwen2-moe) run densely beside the routed
path behind a sigmoid gate.

Parameters keep JAX's names and layouts: ``router`` (d, E_pad),
``wi``/``wg`` (E_pad, d, f), ``wo`` (E_pad, f, d) and, with shared
experts, ``shared.wi``/``shared.wg`` (d, n_shared·f), ``shared.wo``
(n_shared·f, d) and ``shared.gate`` (d, 1).  Their init is JAX's
``ParamDef`` default, fan-in over the leading axis: for the expert
stacks that axis is E_pad, not d or f (ROADMAP C22).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ArchConfig
from .layers import ACTIVATIONS, matmul_f32

F32 = torch.float32

EP_HINT = 16        # the expert-parallel size JAX pads the experts to
GROUP_TOKENS = 1024

# Observes each call's routing when set: ``ROUTE_HOOK(experts, keep)``,
# both (G, Sg, k) on the input's device: each (token, choice) pair's
# expert, and True where the pair found room in that expert's buffer.
# None costs nothing.
ROUTE_HOOK: Optional[Callable[[torch.Tensor, torch.Tensor], None]] = None


def padded_experts(cfg: ArchConfig, hint: int = EP_HINT) -> int:
    """The expert count padded to a multiple of ``hint`` (kept as is when
    it divides or is smaller)."""
    e = cfg.n_experts
    if e % hint == 0 or e < hint:
        return e
    return -(-e // hint) * hint


def _group_size(n_tokens: int, want: int = GROUP_TOKENS) -> int:
    """The largest divisor of ``n_tokens`` that is at most ``want``."""
    g = min(want, n_tokens)
    while n_tokens % g:
        g -= 1
    return g


class SharedExperts(nn.Module):
    """``wi``/``wg`` (d, n_shared·f), ``wo`` (n_shared·f, d), ``gate``
    (d, 1), zeros at init."""

    def __init__(self, cfg: ArchConfig, make):
        super().__init__()
        d, f = cfg.d_model, cfg.n_shared_experts * cfg.d_ff_expert
        self.wi = make((d, f), "fan_in")
        self.wg = make((d, f), "fan_in")
        self.wo = make((f, d), "fan_in")
        self.gate = make((d, 1), "zeros")


class MoE(nn.Module):
    """The routed experts of one layer (``moe_schema``) and, with
    ``n_shared_experts``, the shared ones (``shared``, else None)."""

    def __init__(self, cfg: ArchConfig, make):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff_expert, padded_experts(cfg)
        self.act = cfg.act
        self.router = make((d, e), "fan_in")
        self.wi = make((e, d, f), "fan_in")
        self.wg = make((e, d, f), "fan_in")
        self.wo = make((e, f, d), "fan_in")
        self.shared = (SharedExperts(cfg, make) if cfg.n_shared_experts
                       else None)


def route(probs: torch.Tensor, k: int, cap: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k choices of each token and their buffer slots.

    probs (G, Sg, E) -> gates (G, Sg, k) renormalized to sum 1, experts
    (G, Sg, k), slots (G, Sg, k): the pair's place in its expert's
    buffer, counted over the group token-major and choice-minor, and
    keep (G, Sg, k), slot < cap.  Ties go to the lower expert index, as
    ``jax.lax.top_k`` breaks them (a stable descending sort; ROADMAP C4).
    """
    g, sg, e = probs.shape
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = vals[..., :k], idx[..., :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    onehot = torch.zeros((g, sg * k, e), dtype=torch.int32,
                         device=probs.device)
    onehot.scatter_(2, experts.reshape(g, sg * k, 1), 1)
    slots = torch.gather(torch.cumsum(onehot, dim=1) - 1, 2,
                         experts.reshape(g, sg * k, 1)).reshape(g, sg, k)
    return gates, experts, slots, slots < cap


def _shared(sh: SharedExperts, x: torch.Tensor, act) -> torch.Tensor:
    """The gated shared experts in float32: ``act(x wg) * (x wi)`` cast
    to x's type before ``wo``, times ``sigmoid(x gate)``."""
    h = act(matmul_f32(x, sh.wg)) * matmul_f32(x, sh.wi)
    ys = matmul_f32(h.to(x.dtype), sh.wo)
    return ys * torch.sigmoid(matmul_f32(x, sh.gate))


def moe_apply(moe: MoE, x: torch.Tensor, cfg: ArchConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d) in x's type, aux loss, a float32
    scalar), as ``repro/models/moe.py::moe_apply``."""
    b, s, d = x.shape
    e_pad = moe.router.shape[-1]
    e_real = cfg.n_experts
    k = cfg.experts_per_token
    n = b * s
    sg = _group_size(n)
    g = n // sg
    cap = max(int(cfg.capacity_factor * k * sg / e_pad), 4)
    xt = x.reshape(g, sg, d)

    logits = matmul_f32(xt, moe.router)                    # (G, Sg, E)
    if e_pad != e_real:                    # dummy experts unroutable
        pad = torch.arange(e_pad, device=x.device) >= e_real
        logits = logits.masked_fill(pad, -1e30)
    probs = torch.softmax(logits, dim=-1)
    gates, experts, slots, keep = route(probs, k, cap)
    if ROUTE_HOOK is not None:
        ROUTE_HOOK(experts, keep)

    # each pair's row of the (G, E, cap) buffers, flattened; a dropped
    # pair is written to one spare row past them and read back with
    # weight 0 (no host sync: the kept count stays on the device)
    group = torch.arange(g, device=x.device)[:, None, None]
    rows = ((group * e_pad + experts) * cap
            + torch.clamp(slots, max=cap - 1)).reshape(n * k)
    n_rows = g * e_pad * cap
    dest = torch.where(keep.reshape(n * k), rows, n_rows)
    xs = x.reshape(n, 1, d).expand(n, k, d).reshape(n * k, d)
    xe = torch.zeros((n_rows + 1, d), dtype=x.dtype, device=x.device)
    xe = xe.index_copy(0, dest, xs)[:n_rows]
    xe = xe.reshape(g, e_pad, cap, d).transpose(0, 1).reshape(
        e_pad, g * cap, d)
    act = ACTIVATIONS[moe.act]
    h = torch.bmm(xe.to(F32), moe.wi.to(F32))
    gt = torch.bmm(xe.to(F32), moe.wg.to(F32))
    h = (act(gt) * h).to(x.dtype)
    ye = torch.bmm(h.to(F32), moe.wo.to(F32))              # (E, G·cap, d)
    ye = ye.reshape(e_pad, g, cap, d).transpose(0, 1).reshape(
        g * e_pad * cap, d)
    weights = torch.where(keep, gates, torch.zeros_like(gates))
    out = (ye[rows].reshape(g, sg, k, d)
           * weights[..., None]).sum(2)                    # (G, Sg, d) f32

    # load-balance auxiliary loss (Switch-style), real experts only;
    # ``ce`` counts a chosen expert whether or not the pair was kept
    me = probs[..., :e_real].mean((0, 1))
    chosen = torch.zeros((g, sg, e_pad), dtype=F32, device=x.device)
    chosen.scatter_(2, experts, 1.0)
    ce = chosen[..., :e_real].mean((0, 1))
    aux = cfg.router_aux_coef * e_real * torch.sum(me * ce)

    out = out.to(x.dtype).reshape(b, s, d)
    if moe.shared is not None:
        out = out + _shared(moe.shared, x, act).to(x.dtype)
    return out, aux
