"""Common layers: RMSNorm and LayerNorm, rotary embeddings, the MLP
(gated or not, silu or gelu), embed/unembed, and the training loss.

The port of ``repro/models/layers.py``.  Every product accumulates in
float32 and every norm and rotation runs in float32, as the JAX package's
``preferred_element_type=F32`` and ``astype(F32)`` do; results are cast
back to the activation type where the reference casts them.  Weights
keep the JAX layouts (``wi``/``wg`` ``(d, f)``, ``wo`` ``(f, d)``,
``tokens`` ``(Vp, d)``, ``unembed`` ``(d, Vp)``).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

F32 = torch.float32


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` accumulated and returned in float32 (``w`` is (in, out))."""
    return torch.matmul(x.to(F32), w.to(F32))


def rms(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Weightless RMS normalization over the last axis (``_rms``)."""
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in float32, back in x's type (layers.py ``apply_norm``)."""
    xf = x.to(F32)
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.to(F32)).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm in float32 with its scale and bias, back in x's type
    (layers.py ``apply_norm``, ``norm="layernorm"``)."""
    xf = x.to(F32)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.to(F32) + bias.to(F32)).to(x.dtype)


def apply_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: Optional[torch.Tensor], norm: str) -> torch.Tensor:
    """The config's norm (``cfg.norm``): "layernorm" with ``bias``, else
    RMSNorm, which has none."""
    if norm == "layernorm":
        return layer_norm(x, scale, bias)
    return rms_norm(x, scale)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=F32, device=device) / half
    return 1.0 / (torch.tensor(theta, dtype=F32, device=device) ** exps)


@functools.lru_cache(maxsize=None)
def _frequency_table(head_dim: int, theta: float,
                     device: torch.device) -> torch.Tensor:
    """:func:`rope_frequencies`, built once per (head dim, theta, device):
    building it copies ``theta`` to the device, which on a card waits
    for the work queued before it."""
    with torch.no_grad():
        return rope_frequencies(head_dim, theta, device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Split-halves rotary embedding in float32.

    x (..., S, H, hd); positions broadcastable to (..., S).
    """
    hd = x.shape[-1]
    freqs = _frequency_table(hd, theta, x.device)          # (hd/2,)
    angles = positions[..., :, None].to(F32) * freqs       # (..., S, hd/2)
    angles = angles[..., None, :]                          # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.to(F32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (PyTorch's
    default is the exact erf form, up to ~1e-3 away)."""
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {"silu": F.silu, "gelu": gelu}


def apply_mlp(x: torch.Tensor, wi: torch.Tensor, wg: Optional[torch.Tensor],
              wo: torch.Tensor, act: str) -> torch.Tensor:
    """``act(x wg) * (x wi)`` when gated (``wg`` given), else ``act(x
    wi)``, in float32, cast to x's type before ``wo`` (``apply_mlp``)."""
    fn = ACTIVATIONS[act]
    h = matmul_f32(x, wi)
    h = fn(h) if wg is None else fn(matmul_f32(x, wg)) * h
    return matmul_f32(h.to(x.dtype), wo).to(x.dtype)


def embed_tokens(tokens_table: torch.Tensor, ids: torch.Tensor,
                 dtype: torch.dtype, name: str) -> torch.Tensor:
    """Rows ``ids`` of the table in ``dtype``; a gemma model (``name``
    starting "gemma") scales them by sqrt(d) in the table's type first."""
    out = tokens_table[ids]
    if name.startswith("gemma"):
        # filled on the device: a copy from the host would wait for the
        # device's queue on every decode step
        out = out * torch.full((), tokens_table.shape[1] ** 0.5,
                               dtype=out.dtype, device=out.device)
    return out.to(dtype)


def unembed(tokens_table: torch.Tensor, x: torch.Tensor,
            untied: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Readout over the padded vocabulary, float32 logits: through the
    embedding table (tied) or through ``untied`` (d, Vp), JAX's
    ``embed["unembed"]``."""
    return matmul_f32(x, tokens_table.t() if untied is None else untied)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  z_loss: float = 1e-4) -> torch.Tensor:
    """Token-mean CE with an optional z-loss regularizer (MaxText-style).

    In float32, with the max taken out of the gradient as JAX's
    ``stop_gradient`` does.  The gold logit is gathered
    (``torch.gather``) where JAX reduces a (B, S, Vp) one-hot over the
    vocabulary: the one-hot is there for a vocabulary sharded across
    chips, the value and gradient are the same for finite logits, and
    at llama3.2-1b's full width the one-hot of a 4 x 1024-token
    microbatch would cost 2.1 GB of float32.
    """
    logits = logits.to(F32)
    m = logits.max(dim=-1, keepdim=True).values.detach()
    shifted = logits - m
    sumexp = torch.exp(shifted).sum(-1)
    lse = torch.log(sumexp) + m[..., 0]
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse ** 2
    if mask is None:
        return nll.mean()
    mask = mask.to(F32)
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)
