"""Int8 error-feedback gradient compression.

A copy of ``repro/optim/compress.py``: quantize (grad + residual) to
symmetric per-tensor int8, dequantize, carry the residual.  The
error-feedback invariant holds exactly: ``deq_t + residual_{t+1} ==
grad_t + residual_t``.  JAX feeds the int8 payload to the pod-axis
all-reduce; the port has no collective yet (ROADMAP A5.4), so here it
is the numerical core alone, over dicts of tensors.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Tuple

import torch

F32 = torch.float32


class CompressionState(NamedTuple):
    residual: Dict[str, torch.Tensor]    # float32 residuals, zeros at init


def compression_init(params: Mapping[str, torch.Tensor]) -> CompressionState:
    return CompressionState(residual={
        n: torch.zeros(p.shape, dtype=F32, device=p.device)
        for n, p in params.items()})


def int8_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns (q, scale)."""
    amax = x.abs().max()
    scale = amax.clamp(min=1e-12) / 127.0
    q = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


@torch.no_grad()
def compress_decompress(grads: Mapping[str, torch.Tensor],
                        state: CompressionState
                        ) -> Tuple[Dict[str, torch.Tensor], CompressionState]:
    """Quantize (grad + residual) to int8; return the dequantized grads
    and the new residuals."""
    deq, res = {}, {}
    for name, g in grads.items():
        g = g.to(F32) + state.residual[name]
        q, scale = int8_quantize(g)
        deq[name] = int8_dequantize(q, scale)
        res[name] = g - deq[name]
    return deq, CompressionState(residual=res)
