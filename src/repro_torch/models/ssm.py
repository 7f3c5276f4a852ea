"""The recurrent blocks: Mamba (S6) for the hybrid family, mLSTM and
sLSTM for the ssm family; full sequence and one token each.

The port of ``repro/models/ssm.py``.  Mamba (``mamba_schema``,
``_mamba_gates``, ``mamba_apply``, ``mamba_state_shape``,
``mamba_decode_step``): the arithmetic is JAX's: ``dt`` is one scalar
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
kernel in either package.

The mLSTM (``mlstm_schema``, ``_mlstm_qkvg``, ``mlstm_apply``,
``mlstm_decode_step``) and the sLSTM (``slstm_schema``, ``_slstm_cell``,
``slstm_apply``, ``slstm_decode_step``) of xlstm-125m: JAX runs them as
XLA, a ``lax.scan`` over chunks and a ``lax.scan`` over time, with no
Pallas kernel behind either, so the port runs them in plain PyTorch,
serving and training alike: the chunks as a Python loop, the sLSTM's
time steps as one.  The mLSTM's intra-chunk decay weights are masked
before their exponential, where JAX multiplies ``exp`` by the causal
mask after it: the masked entries' exponents grow with the chunk, and
past ~110 tokens of a chunk at xlstm-125m's init their ``exp``
overflows and ``inf * 0`` makes JAX's output NaN (ROADMAP C27).  Where
JAX's output is finite the two agree.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from ..kernels.ssm_scan import ssm_scan
from .layers import matmul_f32, rms

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


# ===========================================================================
# mLSTM (matrix memory, chunkwise-parallel with stabilized gating)
# ===========================================================================

class MLSTM(nn.Module):
    """The parameters of ``mlstm_schema``, in its names and layouts, with
    inner = ``ssm_expand * d`` and hd = inner / H.

    ``up_proj`` (d, 2 * inner), ``wq``/``wk``/``wv`` (inner, H, hd),
    ``w_if`` (inner, H, 2) "small", ``b_if`` (H, 2) zeros, ``out_norm``
    (inner,) ones, ``down_proj`` (inner, d).
    """

    def __init__(self, cfg: ArchConfig, make):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        inner = cfg.ssm_expand * d
        hd = inner // h
        self.up_proj = make((d, 2 * inner), "fan_in")
        self.wq = make((inner, h, hd), "fan_in")
        self.wk = make((inner, h, hd), "fan_in")
        self.wv = make((inner, h, hd), "fan_in")
        self.w_if = make((inner, h, 2), "small")
        self.b_if = make((h, 2), "zeros")
        self.out_norm = make((inner,), "ones")
        self.down_proj = make((inner, d), "fan_in")


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsi,ihk->bshk", x, w)`` in float32, as one product."""
    return matmul_f32(x, w.flatten(1)).unflatten(-1, w.shape[1:])


def _mlstm_qkvg(p: MLSTM, u: torch.Tensor):
    """q, k, v (B, S, H, hd), the gate z (B, S, inner), log i and log f
    (B, S, H), all float32, from u (B, S, d)."""
    xz = matmul_f32(u, p.up_proj)
    x, z = xz.chunk(2, dim=-1)                               # (B, S, inner)
    q, k, v = _heads(x, p.wq), _heads(x, p.wk), _heads(x, p.wv)
    gates = _heads(x, p.w_if) + p.b_if.to(F32)
    return q, k, v, z, gates[..., 0], F.logsigmoid(gates[..., 1])


def _mlstm_out(p: MLSTM, hs: torch.Tensor, z: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """rms(h * silu(z)) * out_norm over the whole inner width, projected
    back to d in ``dtype``."""
    out = rms(hs * F.silu(z)) * p.out_norm.to(F32)
    return matmul_f32(out.to(dtype), p.down_proj).to(dtype)


def mlstm_apply(p: MLSTM, u: torch.Tensor, cfg: ArchConfig,
                chunk: int = 128) -> torch.Tensor:
    """The chunked mLSTM: u (B, S, d) -> (B, S, d), differentiable.

    JAX's ``mlstm_apply``: the sequence padded to whole chunks (padded
    tokens take log i = -1e30 and log f = 0, so they add nothing), then
    chunk by chunk from c = 0, n = 0, m = -1e30: within a chunk the
    cumulative log forget gates F give the decay exponents d[t, j] = F_t
    - F_j + log i_j (j <= t), the stabilizer m_t is the larger of their
    row's max and F_t + m_in, and the output is the inter-chunk term
    (q . C_in, decayed) plus the intra-chunk one (a small decayed
    attention), over max(|q . n|, exp(-m_t)); (C, n, m) then move to the
    chunk's end.  The masked max is ``amax``, whose gradient splits ties
    evenly as JAX's reduce-max does.
    """
    q, k, v, z, log_i, log_f = _mlstm_qkvg(p, u)
    b_, s, h, hd = q.shape
    hd_v = v.shape[-1]
    scale = hd ** -0.5
    chunk = min(chunk, s)
    n_chunks = -(-s // chunk)
    pad = n_chunks * chunk - s
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        log_i = F.pad(log_i, (0, 0, 0, pad), value=-1e30)
        log_f = F.pad(log_f, (0, 0, 0, pad))
    above = ~torch.ones((chunk, chunk), dtype=torch.bool,
                        device=u.device).tril()[None, :, :, None]
    c = torch.zeros((b_, h, hd, hd_v), dtype=F32, device=u.device)
    n = torch.zeros((b_, h, hd), dtype=F32, device=u.device)
    m = torch.full((b_, h), -1e30, dtype=F32, device=u.device)
    hs = []
    for j in range(n_chunks):
        at = slice(j * chunk, (j + 1) * chunk)
        qj, kj, vj = q[:, at] * scale, k[:, at], v[:, at]
        li, lf = log_i[:, at], log_f[:, at]                  # (B, C, H)
        fcum = lf.cumsum(1)
        ftot = fcum[:, -1]                                   # (B, H)
        dmat = fcum[:, :, None] - fcum[:, None] + li[:, None]   # (B,t,j,H)
        m_intra = dmat.masked_fill(above, float("-inf")).amax(2) \
            .clamp_min(-1e30)
        m_inter = fcum + m[:, None]
        m_t = torch.maximum(m_intra, m_inter)
        w_inter = torch.exp(m_inter - m_t)
        h_inter = torch.einsum("bchk,bhkv->bchv", qj, c) * w_inter[..., None]
        n_inter = torch.einsum("bchk,bhk->bch", qj, n) * w_inter
        w_intra = torch.exp((dmat - m_t[:, :, None]).masked_fill(
            above, float("-inf")))
        sw = torch.einsum("bthk,bjhk->btjh", qj, kj) * w_intra
        h_intra = torch.einsum("btjh,bjhv->bthv", sw, vj)
        n_den = torch.maximum((n_inter + sw.sum(2)).abs(), torch.exp(-m_t))
        hs.append((h_inter + h_intra) / n_den[..., None])
        m_out = torch.maximum(ftot + m, (ftot[:, None] - fcum + li).amax(1))
        w_carry = torch.exp(ftot + m - m_out)                # (B, H)
        w_k = torch.exp(ftot[:, None] - fcum + li - m_out[:, None])
        c = c * w_carry[..., None, None] + torch.einsum(
            "bchk,bchv->bhkv", kj * w_k[..., None], vj)
        n = n * w_carry[..., None] + torch.einsum("bchk,bch->bhk", kj, w_k)
        m = m_out
    hs = torch.cat(hs, dim=1)[:, :s].reshape(b_, s, h * hd_v)
    return _mlstm_out(p, hs, z, u.dtype)


def mlstm_state_shapes(cfg: ArchConfig, batch: int):
    """Shapes of the mLSTM's state: c (B, H, hd, hd), n (B, H, hd), m
    (B, H)."""
    inner = cfg.ssm_expand * cfg.d_model
    h = cfg.n_heads
    hd = inner // h
    return {"c": (batch, h, hd, hd), "n": (batch, h, hd), "m": (batch, h)}


def mlstm_decode_step(p: MLSTM, u: torch.Tensor, state, cfg: ArchConfig):
    """One token: u (B, 1, d) and the state of
    :func:`mlstm_state_shapes` -> (out (B, 1, d), the new state); the
    caller's tensors are left as they were."""
    q, k, v, z, log_i, log_f = _mlstm_qkvg(p, u)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]                     # (B, H, hd)
    li, lf = log_i[:, 0], log_f[:, 0]                       # (B, H)
    qs = q * q.shape[-1] ** -0.5
    c, n, m = state["c"], state["n"], state["m"]
    m_new = torch.maximum(lf + m, li)
    fw = torch.exp(lf + m - m_new)
    iw = torch.exp(li - m_new)
    c = c * fw[..., None, None] + iw[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n = n * fw[..., None] + iw[..., None] * k
    h_num = torch.einsum("bhk,bhkv->bhv", qs, c)
    n_den = torch.maximum(torch.einsum("bhk,bhk->bh", qs, n).abs(),
                          torch.exp(-m_new))
    h_out = (h_num / n_den[..., None]).reshape(u.shape[0], 1, -1)
    return _mlstm_out(p, h_out, z, u.dtype), {"c": c, "n": n, "m": m_new}


# ===========================================================================
# sLSTM (scalar memory with memory mixing; sequential by design)
# ===========================================================================

class SLSTM(nn.Module):
    """The parameters of ``slstm_schema``, with hd = d / H: ``w_gates``
    (d, 4, H, hd), ``r_gates`` (4, H, hd, hd), fan-in over its axis 2,
    ``b_gates`` (4, H, hd) zeros, ``out_norm`` (d,) ones, ``out_proj``
    (d, d).  The four gates are i, f, z, o in that order."""

    def __init__(self, cfg: ArchConfig, make):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        hd = d // h
        self.w_gates = make((d, 4, h, hd), "fan_in")
        self.r_gates = make((4, h, hd, hd), "fan_in", fan_in_axes=(2,))
        self.b_gates = make((4, h, hd), "zeros")
        self.out_norm = make((d,), "ones")
        self.out_proj = make((d, d), "fan_in")


def slstm_state_shapes(cfg: ArchConfig, batch: int):
    """Shapes of the sLSTM's state: c, n, h and m, each (B, H, hd)."""
    h = cfg.n_heads
    hd = cfg.d_model // h
    return {k: (batch, h, hd) for k in ("c", "n", "h", "m")}


def _recurrence(p: SLSTM) -> torch.Tensor:
    """``r_gates`` as (H, hd, 4 * hd) float32, so that each step's
    ``einsum("bhk,ghkl->bghl", h, r)`` is one batched product."""
    g, h, hd, _ = p.r_gates.shape
    return p.r_gates.to(F32).permute(1, 2, 0, 3).reshape(h, hd, g * hd)


def _slstm_cell(r: torch.Tensor, bias: torch.Tensor, wx_t: torch.Tensor,
                state):
    """One step: ``r`` from :func:`_recurrence`, ``bias`` ``b_gates`` in
    float32, wx_t (B, 4, H, hd) the input's projections."""
    b_, g, h, hd = wx_t.shape
    rec = torch.bmm(state["h"].transpose(0, 1), r)           # (H, B, 4 hd)
    rec = rec.unflatten(-1, (g, hd)).permute(1, 2, 0, 3)     # (B, 4, H, hd)
    raw = wx_t + rec + bias
    li = raw[:, 0]
    lf = F.logsigmoid(raw[:, 1])
    zg = torch.tanh(raw[:, 2])
    og = torch.sigmoid(raw[:, 3])
    decayed = lf + state["m"]
    m_new = torch.maximum(decayed, li)
    fw = torch.exp(decayed - m_new)
    iw = torch.exp(li - m_new)
    c = fw * state["c"] + iw * zg
    n = fw * state["n"] + iw
    h_new = og * c / n.clamp_min(1e-6)
    return {"c": c, "n": n, "h": h_new, "m": m_new}


def _slstm_out(p: SLSTM, hs: torch.Tensor, dtype: torch.dtype
               ) -> torch.Tensor:
    """rms(h) * out_norm, projected by ``out_proj`` in ``dtype``."""
    hs = rms(hs) * p.out_norm.to(F32)
    return matmul_f32(hs.to(dtype), p.out_proj).to(dtype)


def _gate_inputs(p: SLSTM, u: torch.Tensor) -> torch.Tensor:
    """u (B, S, d) -> its projections (B, S, 4, H, hd), float32 from
    u in float32."""
    return matmul_f32(u.to(F32), p.w_gates.flatten(1)).unflatten(
        -1, p.w_gates.shape[1:])


def slstm_apply(p: SLSTM, u: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The sLSTM over a sequence, one step after another from c = n =
    h = 0 and m = -1e30 (JAX's ``lax.scan`` over time): u (B, S, d) ->
    (B, S, d), differentiable; ~20 small operations a token."""
    b_, s, d = u.shape
    wx = _gate_inputs(p, u)
    state = {k: torch.zeros(wx.shape[0:1] + wx.shape[3:], dtype=F32,
                            device=u.device) for k in ("c", "n", "h")}
    state["m"] = torch.full_like(state["c"], -1e30)
    r, bias = _recurrence(p), p.b_gates.to(F32)
    hs = []
    for t in range(s):
        state = _slstm_cell(r, bias, wx[:, t], state)
        hs.append(state["h"])
    return _slstm_out(p, torch.stack(hs, dim=1).reshape(b_, s, d), u.dtype)


def slstm_decode_step(p: SLSTM, u: torch.Tensor, state, cfg: ArchConfig):
    """One token: u (B, 1, d) and the state of :func:`slstm_state_shapes`
    -> (out (B, 1, d), the new state); the caller's tensors are left as
    they were."""
    b_, _, d = u.shape
    new = _slstm_cell(_recurrence(p), p.b_gates.to(F32),
                      _gate_inputs(p, u)[:, 0], state)
    return _slstm_out(p, new["h"].reshape(b_, 1, d), u.dtype), new
