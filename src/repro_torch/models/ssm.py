"""The Mamba (S6) branch of the hybrid family: full sequence and one token.

The port of the Mamba part of ``repro/models/ssm.py`` (``mamba_schema``,
``_mamba_gates``, ``mamba_apply``, ``mamba_state_shape``,
``mamba_decode_step``).  The arithmetic is JAX's: ``dt`` is one scalar
per token, ``softplus(dbc[..., 0:1] + dt_bias)``, broadcast to the
channels; ``A = -exp(a_log)``; the convolution is causal, a sum over the
input padded by ``k - 1`` in front, and in decode the window is
``concat([conv_state, x])`` whose last ``k - 1`` rows become the next
state.

Where JAX runs the recurrence of :func:`mamba_apply` as a chunked
``associative_scan`` with the ``C . h`` readout inside each chunk, the
port's serving forward runs it as one launch of the scan kernel (B4,
:func:`~repro_torch.kernels.ssm_scan.ssm_scan`) over the whole
sequence from ``h0 = 0`` and reads ``C . h`` out afterwards.  B4 has
no backward, so training runs :func:`mamba_apply_chunked`, JAX's own
scheme in plain PyTorch under autograd.  The one-token step needs no
kernel in either package.  The mLSTM and sLSTM blocks come with the
``ssm`` family (ROADMAP A5).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from ..kernels.ssm_scan import ssm_scan
from .layers import matmul_f32

F32 = torch.float32


class Mamba(nn.Module):
    """The parameters of ``mamba_schema``, in its names and layouts.

    ``in_proj`` (d, 2 * inner), ``conv_w`` (k, inner), ``conv_b``
    (inner,), ``x_dbc`` (inner, 1 + 2N), ``dt_bias`` (inner,), ``a_log``
    (inner, N), ``d_skip`` (inner,), ``out_proj`` (inner, d).
    """

    def __init__(self, cfg: ArchConfig, make):
        """``make(shape, kind)`` gives each parameter (``Model``'s)."""
        super().__init__()
        d, n = cfg.d_model, cfg.ssm_state
        inner = cfg.ssm_expand * d
        self.in_proj = make((d, 2 * inner), "fan_in")
        self.conv_w = make((cfg.ssm_conv, inner), "fan_in")
        self.conv_b = make((inner,), "zeros")
        self.x_dbc = make((inner, 1 + 2 * n), "fan_in")
        self.dt_bias = make((inner,), "zeros")
        self.a_log = make((inner, n), "ones")
        self.d_skip = make((inner,), "ones")
        self.out_proj = make((inner, d), "fan_in")


def _dt_bc(p: Mamba, x: torch.Tensor, n: int):
    """dt (..., inner), B and C (..., N) from the conv output x."""
    dbc = matmul_f32(x, p.x_dbc)
    dt = F.softplus(dbc[..., 0:1] + p.dt_bias.to(F32))
    return dt, dbc[..., 1:1 + n], dbc[..., 1 + n:]


def _mamba_gates(p: Mamba, u: torch.Tensor, cfg: ArchConfig):
    """Projections, causal conv, dt/B/C of u (B, S, d) (``_mamba_gates``)."""
    xz = matmul_f32(u, p.in_proj)
    x, z = xz.chunk(2, dim=-1)                               # (B, S, inner)
    k, s = cfg.ssm_conv, x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    x = sum(xp[:, i:i + s] * p.conv_w[i].to(F32) for i in range(k)) \
        + p.conv_b.to(F32)
    x = F.silu(x)
    dt, bmat, cmat = _dt_bc(p, x, cfg.ssm_state)
    a = -torch.exp(p.a_log.to(F32))                          # (inner, N)
    return x, z, dt, bmat, cmat, a


def _readout(p: Mamba, y: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """(y + x * d_skip) * silu(z), projected back to d in ``dtype``."""
    y = y + x * p.d_skip.to(F32)
    y = y * F.silu(z)
    return matmul_f32(y.to(dtype), p.out_proj).to(dtype)


def mamba_apply(p: Mamba, u: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The selective scan over a whole sequence: u (B, S, d) -> (B, S, d).

    decay = exp(dt * A) and drive = dt * x * B, both (B, S, inner, N) in
    float32, go through one launch of the scan kernel from h0 = 0; the
    readout ``C . h`` follows as an einsum.
    """
    x, z, dt, bmat, cmat, a = _mamba_gates(p, u, cfg)
    decay = torch.exp(dt[..., None] * a)
    drive = (dt * x)[..., None] * bmat[:, :, None, :]
    b_, _, inner = x.shape
    h0 = torch.zeros((b_, inner, cfg.ssm_state), dtype=F32, device=u.device)
    h = ssm_scan(decay, drive, h0)
    y = torch.einsum("bsin,bsn->bsi", h, cmat)
    return _readout(p, y, x, z, u.dtype)


def associative_scan(a: torch.Tensor, b: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along dim 1 of the pairs (a_t, b_t) under JAX's
    ``combine``: (a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2).

    The recursion of ``jax.lax.associative_scan``, in its order of
    operations: combine adjacent pairs, scan those at half the length,
    then fill in the even positions; log depth, differentiable.  Each
    level writes its odd and even positions into one new tensor.
    """
    n = a.shape[1]
    if n < 2:
        return a, b
    odd_a, odd_b = associative_scan(a[:, 1::2] * a[:, 0:-1:2],
                                    a[:, 1::2] * b[:, 0:-1:2] + b[:, 1::2])
    prev_a, prev_b = ((odd_a[:, :-1], odd_b[:, :-1]) if n % 2 == 0
                      else (odd_a, odd_b))
    out_a, out_b = torch.empty_like(a), torch.empty_like(b)
    out_a[:, 1::2], out_b[:, 1::2] = odd_a, odd_b
    out_a[:, :1], out_b[:, :1] = a[:, :1], b[:, :1]
    out_a[:, 2::2] = prev_a * a[:, 2::2]
    out_b[:, 2::2] = a[:, 2::2] * prev_b + b[:, 2::2]
    return out_a, out_b


def mamba_apply_chunked(p: Mamba, u: torch.Tensor, cfg: ArchConfig,
                        chunk: int = 128) -> torch.Tensor:
    """The selective scan of :func:`mamba_apply` in plain PyTorch, for
    training: u (B, S, d) -> (B, S, d), differentiable.

    JAX's ``mamba_apply``: decay and drive padded to whole chunks (decay
    by 1, drive and C by 0); in each chunk an associative scan gives
    (aa, bb), the states are h = aa * h0 + bb and the readout ``C . h``
    is taken there, so one chunk's (B, chunk, inner, N) states exist at
    a time; the chunk's last state is the next chunk's h0.  The scans
    do not depend on h0, so all chunks' run as one batch: a few hundred
    launches a layer, not a few thousand.  Never a cumulative product
    and a division by it, which underflows over a chunk.
    """
    x, z, dt, bmat, cmat, a = _mamba_gates(p, u, cfg)
    b_, s, inner = x.shape
    n = cfg.ssm_state
    decay = torch.exp(dt[..., None] * a)
    drive = (dt * x)[..., None] * bmat[:, :, None, :]
    chunk = min(chunk, s)
    n_chunks = -(-s // chunk)
    pad = n_chunks * chunk - s
    if pad:
        decay = F.pad(decay, (0, 0, 0, 0, 0, pad), value=1.0)
        drive = F.pad(drive, (0, 0, 0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    per_chunk = (b_ * n_chunks, chunk, inner, n)
    aa, bb = associative_scan(decay.reshape(per_chunk),
                              drive.reshape(per_chunk))
    aa = aa.reshape(b_, n_chunks, chunk, inner, n)
    bb = bb.reshape(b_, n_chunks, chunk, inner, n)
    h = torch.zeros((b_, inner, n), dtype=F32, device=u.device)
    ys = []
    for c in range(n_chunks):
        hs = aa[:, c] * h[:, None] + bb[:, c]         # (B, chunk, inner, N)
        ys.append(torch.einsum("bcin,bcn->bci", hs,
                               cmat[:, c * chunk:(c + 1) * chunk]))
        h = hs[:, -1]
    y = torch.cat(ys, dim=1)[:, :s]
    return _readout(p, y, x, z, u.dtype)


def mamba_state_shape(cfg: ArchConfig, batch: int
                      ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Shapes of the recurrent state h (B, inner, N) and conv (B, k-1, inner)."""
    inner = cfg.ssm_expand * cfg.d_model
    return (batch, inner, cfg.ssm_state), (batch, cfg.ssm_conv - 1, inner)


def mamba_decode_step(p: Mamba, u: torch.Tensor, state: torch.Tensor,
                      conv_state: torch.Tensor, cfg: ArchConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One token: u (B, 1, d), state (B, inner, N), conv (B, k-1, inner).

    Returns (out (B, 1, d), new state, new conv state); the caller's
    tensors are left as they were.
    """
    xz = matmul_f32(u, p.in_proj)
    x, z = xz.chunk(2, dim=-1)                               # (B, 1, inner)
    window = torch.cat([conv_state, x], dim=1)               # (B, k, inner)
    x = torch.einsum("bki,ki->bi", window, p.conv_w.to(F32)) \
        + p.conv_b.to(F32)
    x = F.silu(x)[:, None]                                   # (B, 1, inner)
    dt, bmat, cmat = _dt_bc(p, x, cfg.ssm_state)
    a = -torch.exp(p.a_log.to(F32))
    decay = torch.exp(dt[:, 0, :, None] * a)                 # (B, inner, N)
    drive = (dt * x)[:, 0, :, None] * bmat[:, 0, None, :]
    state = decay * state + drive
    y = torch.einsum("bin,bn->bi", state, cmat[:, 0])[:, None]
    return _readout(p, y, x, z, u.dtype), state, window[:, 1:]
