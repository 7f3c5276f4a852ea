"""Plain float32 reference of the served and trained language models.

Written from the architectures' descriptions, in plain PyTorch: no
kernel, no cache manager, no batching of requests.  It imports nothing
of the program under test and takes nothing the program made: the
weights come from :mod:`portbench.weights`, drawn again from the seed,
and the configuration from the benchmark's JSON file.

Families:

* ``moe`` (Qwen1.5-MoE / Qwen2-MoE): pre-norm layers of grouped-query
  attention with QKV biases and rotary embeddings, then routed experts
  (softmax router, top-k renormalised, SwiGLU experts) beside a shared
  SwiGLU expert behind a sigmoid gate.  Routing follows GShard's grouped
  capacity: tokens flattened and cut into contiguous groups, each expert
  keeping at most ``cap`` (token, choice) pairs of a group, counted
  token-major and choice-minor.
* ``hybrid`` (Hymba): every layer runs attention and a Mamba (S6) branch
  in parallel on one normed input and adds the mean of their
  RMS-normalised outputs, then a SwiGLU MLP.  Windowed layers attend to
  the last ``sliding_window`` positions, global ones to all.
* ``dense``: attention and a SwiGLU MLP.

Parameter names and layouts are the ones the weights are drawn in
(:func:`layout`): ``wq`` (d, H, hd), ``wk``/``wv`` (d, KV, hd), ``wo``
(H, hd, d), MLP ``wi``/``wg`` (d, f) and ``wo`` (f, d), experts stacked
(E, d, f), the embedding (V, d) and the readout (d, V).

Serving keeps K and V in the cache's type, so the reference rounds them
to it before attending (``kv_dtype``); training keeps them in float32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

F32 = torch.float32
NEG = -1e30


# ---------------------------------------------------------------------------
# The parameters
# ---------------------------------------------------------------------------

def padded_experts(arch: dict) -> int:
    return int(arch.get("experts_padded_to") or arch.get("n_experts", 0))


def padded_vocab(arch: dict) -> int:
    p = int(arch.get("vocab_pad_to", 256))
    return -(-int(arch["vocab_size"]) // p) * p


def head_dim(arch: dict) -> int:
    return int(arch.get("head_dim") or arch["d_model"] // arch["n_heads"])


def layer_windows(arch: dict) -> List[int]:
    """Each layer's window (0: global): with a window and a period p,
    the last layer of each whole group of p is global."""
    w, p, n = (int(arch.get("sliding_window", 0)),
               int(arch.get("global_every", 0)), int(arch["n_layers"]))
    if not (w and p) or n < p:
        return [w] * n
    grouped = n // p * p
    return [0 if i < grouped and i % p == p - 1 else w for i in range(n)]


def layout(arch: dict) -> List[Tuple[str, List[Tuple[str, tuple, str]]]]:
    """The blocks of parameters in drawing order: ``[(block, [(name,
    shape, kind)])]``.  Kinds: ``fan_in`` (std 1/sqrt(shape[0])),
    ``embed`` (std 0.02), ``one`` (1 + 0.1 N), ``small`` (0.1 N)."""
    d, h, kv, hd = (arch["d_model"], arch["n_heads"], arch["n_kv_heads"],
                    head_dim(arch))
    fam = arch["family"]
    vp = padded_vocab(arch)
    blocks = [("embed", [("tokens", (vp, d), "embed")])]
    for i in range(arch["n_layers"]):
        p = f"layers.{i}."
        leaves = []
        norm = "norm" if fam == "hybrid" else "attn_norm"
        leaves.append((p + norm, (d,), "one"))
        leaves += [(p + "attn.wq", (d, h, hd), "fan_in"),
                   (p + "attn.wk", (d, kv, hd), "fan_in"),
                   (p + "attn.wv", (d, kv, hd), "fan_in"),
                   (p + "attn.wo", (h, hd, d), "fan_in_hd")]
        if arch.get("qkv_bias"):
            leaves += [(p + "attn.bq", (h, hd), "small"),
                       (p + "attn.bk", (kv, hd), "small"),
                       (p + "attn.bv", (kv, hd), "small")]
        if fam == "hybrid":
            inner, n, k = (arch["ssm_expand"] * d, arch["ssm_state"],
                           arch["ssm_conv"])
            m = p + "mamba."
            leaves += [(m + "in_proj", (d, 2 * inner), "fan_in"),
                       (m + "conv_w", (k, inner), "fan_in"),
                       (m + "conv_b", (inner,), "small"),
                       (m + "x_dbc", (inner, 1 + 2 * n), "fan_in"),
                       (m + "dt_bias", (inner,), "small"),
                       (m + "a_log", (inner, n), "one"),
                       (m + "d_skip", (inner,), "one"),
                       (m + "out_proj", (inner, d), "fan_in")]
        leaves.append((p + "mlp_norm", (d,), "one"))
        if fam == "moe":
            e, f = padded_experts(arch), arch["d_ff_expert"]
            fs = arch["n_shared_experts"] * f
            leaves += [(p + "moe.router", (d, e), "fan_in"),
                       (p + "moe.wi", (e, d, f), "fan_in_1"),
                       (p + "moe.wg", (e, d, f), "fan_in_1"),
                       (p + "moe.wo", (e, f, d), "fan_in_1")]
            if fs:
                leaves += [(p + "moe.shared.wi", (d, fs), "fan_in"),
                           (p + "moe.shared.wg", (d, fs), "fan_in"),
                           (p + "moe.shared.wo", (fs, d), "fan_in"),
                           (p + "moe.shared.gate", (d, 1), "fan_in")]
        else:
            f = arch["d_ff"]
            leaves += [(p + "mlp.wi", (d, f), "fan_in"),
                       (p + "mlp.wg", (d, f), "fan_in"),
                       (p + "mlp.wo", (f, d), "fan_in")]
        blocks.append((f"layers.{i}", leaves))
    blocks.append(("head", [("final_norm", (d,), "one"),
                            ("unembed", (d, vp), "fan_in")]))
    return blocks


def std_of(shape: tuple, kind: str) -> float:
    """The standard deviation a leaf of ``kind`` is drawn with."""
    if kind == "fan_in":
        return shape[0] ** -0.5
    if kind == "fan_in_1":            # a stack of matrices: fan of each
        return shape[1] ** -0.5
    if kind == "fan_in_hd":           # (H, hd, d): fan over H * hd
        return (shape[0] * shape[1]) ** -0.5
    if kind == "embed":
        return 0.02
    if kind in ("one", "small"):
        return 0.1
    raise ValueError(f"unknown kind {kind!r}")


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: Optional[torch.Tensor],
             eps: float) -> torch.Tensor:
    y = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return y if scale is None else y * scale


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over split halves: x (B, S, heads, hd), pos (S,)."""
    half = x.shape[-1] // 2
    freq = 1.0 / theta ** (torch.arange(half, dtype=F32,
                                        device=x.device) / half)
    ang = pos.to(F32)[:, None] * freq                       # (S, half)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(w: Dict[str, torch.Tensor], p: str, h: torch.Tensor,
              arch: dict, window: int,
              kv_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """Causal grouped-query attention of h (B, S, d) over itself."""
    b, s, d = h.shape
    nh, nkv, hd = arch["n_heads"], arch["n_kv_heads"], head_dim(arch)
    q = torch.einsum("bsd,dhk->bshk", h, w[p + "wq"])
    k = torch.einsum("bsd,dhk->bshk", h, w[p + "wk"])
    v = torch.einsum("bsd,dhk->bshk", h, w[p + "wv"])
    if p + "bq" in w:
        q, k, v = q + w[p + "bq"], k + w[p + "bk"], v + w[p + "bv"]
    pos = torch.arange(s, device=h.device)
    theta = float(arch["rope_theta"])
    q, k = rope(q, pos, theta), rope(k, pos, theta)
    if kv_dtype is not None:
        k, v = k.to(kv_dtype).to(F32), v.to(kv_dtype).to(F32)
    g = nh // nkv
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    keep = pos[None, :] <= pos[:, None]
    if window:
        keep &= pos[None, :] > pos[:, None] - window
    outs = []
    for i in range(b):           # one sequence's (heads, S, S) at a time
        if torch.is_grad_enabled():      # keep q, k, v; not the scores
            outs.append(checkpoint(_core, q[i], k[i], v[i], keep, hd,
                                   use_reentrant=False))
        else:
            outs.append(_core(q[i], k[i], v[i], keep, hd))
    return torch.einsum("bshk,hkd->bsd", torch.stack(outs), w[p + "wo"])


def _core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          keep: torch.Tensor, hd: int) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd), masked) v for one sequence (S, H, hd)."""
    sc = torch.einsum("qhk,shk->hqs", q, k) / math.sqrt(hd)
    sc = sc.masked_fill(~keep, NEG)
    return torch.einsum("hqs,shk->qhk", torch.softmax(sc, -1), v)


def swiglu(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
           wo: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ wg) * (x @ wi)) @ wo


def mamba(w: Dict[str, torch.Tensor], p: str, u: torch.Tensor,
          arch: dict) -> torch.Tensor:
    """The selective scan (S6) of u (B, S, d), one position at a time:
    a causal depthwise convolution, dt one scalar a position (softplus,
    broadcast to the channels), h_t = exp(dt A) h_{t-1} + dt x B, and the
    readout (C . h + D x) * silu(z)."""
    n, kc = arch["ssm_state"], arch["ssm_conv"]
    b, s, _ = u.shape
    x, z = (u @ w[p + "in_proj"]).chunk(2, dim=-1)
    xp = F.pad(x, (0, 0, kc - 1, 0))
    conv = w[p + "conv_w"]
    x = sum(xp[:, j:j + s] * conv[j] for j in range(kc)) + w[p + "conv_b"]
    x = F.silu(x)
    dbc = x @ w[p + "x_dbc"]
    dt = F.softplus(dbc[..., :1] + w[p + "dt_bias"])         # (B, S, inner)
    bm, cm = dbc[..., 1:1 + n], dbc[..., 1 + n:]
    a = -torch.exp(w[p + "a_log"])                            # (inner, N)
    hs = torch.zeros(b, x.shape[-1], n, dtype=F32, device=u.device)
    ys = []
    for t in range(s):
        hs = (torch.exp(dt[:, t, :, None] * a) * hs
              + (dt[:, t] * x[:, t])[..., None] * bm[:, t, None, :])
        ys.append(torch.einsum("bin,bn->bi", hs, cm[:, t]))
    y = torch.stack(ys, dim=1) + x * w[p + "d_skip"]
    return (y * F.silu(z)) @ w[p + "out_proj"]


def group_size(n_tokens: int, want: int = 1024) -> int:
    """The largest divisor of ``n_tokens`` that is at most ``want``."""
    g = min(want, n_tokens)
    while n_tokens % g:
        g -= 1
    return g


def experts(w: Dict[str, torch.Tensor], p: str, x: torch.Tensor,
            arch: dict, capacity: bool,
            route: Optional[dict] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed and shared experts of x (B, S, d); returns (out, aux).

    ``capacity``: GShard's grouped capacity drops pairs past ``cap`` of
    an expert in a group; without it every pair is kept.

    ``route`` follows given choices: its ``force`` (B, S, k) holds each
    token's experts (-1: the reference's own).  A forced token's gates
    are its choices' probabilities renormalised, and ``route["gap"]``
    keeps the largest amount by which a forced choice's probability lies
    below the k-th best, or inf for a choice that is no real expert or
    repeats, or where the capacity keeps other pairs than ``keep`` (the
    pairs the program kept, when given).  ``route["own"]`` receives the
    reference's own choices."""
    b, s, d = x.shape
    e_real, e_pad = arch["n_experts"], padded_experts(arch)
    k = arch["experts_per_token"]
    xt = x.reshape(b * s, d)
    n = xt.shape[0]
    unused = torch.arange(e_pad, device=x.device) >= e_real
    logits = (xt @ w[p + "router"]).masked_fill(unused, NEG)
    probs = torch.softmax(logits, -1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = top[:, :k] / top[:, :k].sum(-1, keepdim=True).clamp(min=1e-9)
    choice = idx[:, :k]                                        # (n, k)
    if route is not None:
        route["own"].append(choice.reshape(b, s, k))
    if route is not None and route.get("force") is not None and (
            route["force"].numel() != n * k):
        route["gap"] = float("inf")         # a record of other tokens
    elif route is not None and route.get("force") is not None:
        force = route["force"].reshape(n, k)
        given = (force >= 0).all(-1)
        choice = torch.where(given[:, None], force, choice)
        picked = probs.gather(1, choice.clamp(0, e_pad - 1))
        gates = picked / picked.sum(-1, keepdim=True).clamp(min=1e-9)
        below = (top[:, k - 1] - picked.min(-1).values).clamp(min=0)
        srt = choice.sort(-1).values
        bad = ((choice >= e_real) | (choice < 0)).any(-1) | (
            srt[:, 1:] == srt[:, :-1]).any(-1)
        below = torch.where(bad, torch.full_like(below, float("inf")),
                            below)
        route["gap"] = max(route["gap"], float(below[given].detach().max())
                           if bool(given.any()) else 0.0)
    keep = torch.ones_like(choice, dtype=torch.bool)
    if capacity:
        sg = group_size(n)
        cap = max(int(arch["capacity_factor"] * k * sg / e_pad), 4)
        c = choice.clamp(0, e_pad - 1).reshape(n // sg, sg * k)
        onehot = F.one_hot(c, e_pad)
        slot = (onehot.cumsum(1) - 1).gather(2, c[..., None]).reshape(n, k)
        keep = slot < cap
        kept = None if route is None else route.get("keep")
        if kept is not None and (kept.numel() != n * k or bool(
                (keep != kept.reshape(n, k)).any())):
            route["gap"] = float("inf")
    out = torch.zeros_like(xt)
    for e in range(e_real):
        tok, j = torch.nonzero((choice == e) & keep, as_tuple=True)
        if tok.numel():
            y = swiglu(xt[tok], w[p + "wi"][e], w[p + "wg"][e],
                       w[p + "wo"][e])
            out = out.index_add(0, tok, y * gates[tok, j, None])
    if p + "shared.wi" in w:
        ys = swiglu(xt, w[p + "shared.wi"], w[p + "shared.wg"],
                    w[p + "shared.wo"])
        out = out + ys * torch.sigmoid(xt @ w[p + "shared.gate"])
    me = probs[:, :e_real].mean(0)
    ce = F.one_hot(choice, e_pad).sum(1)[:, :e_real].to(F32).mean(0)
    aux = arch.get("router_aux_coef", 0.01) * e_real * torch.sum(me * ce)
    return out.reshape(b, s, d), aux


def layer(w: Dict[str, torch.Tensor], i: int, x: torch.Tensor, arch: dict,
          window: int, kv_dtype: Optional[torch.dtype], capacity: bool,
          route: Optional[dict] = None
          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Layer ``i``: x (B, S, d) -> (x, the layer's aux loss or None)."""
    p, eps, fam = f"layers.{i}.", arch["norm_eps"], arch["family"]
    aux = None
    if fam == "hybrid":
        h = rms_norm(x, w[p + "norm"], eps)
        a = attention(w, p + "attn.", h, arch, window, kv_dtype)
        m = mamba(w, p + "mamba.", h, arch)
        x = x + 0.5 * (rms_norm(a, None, eps) + rms_norm(m, None, eps))
    else:
        h = rms_norm(x, w[p + "attn_norm"], eps)
        x = x + attention(w, p + "attn.", h, arch, window, kv_dtype)
    h = rms_norm(x, w[p + "mlp_norm"], eps)
    if fam == "moe":
        y, aux = experts(w, p + "moe.", h, arch, capacity, route)
    else:
        y = swiglu(h, w[p + "mlp.wi"], w[p + "mlp.wg"], w[p + "mlp.wo"])
    return x + y, aux


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------

def serve_logits(arch: dict, weights: Callable[[str], Dict[str, torch.Tensor]],
                 tokens: torch.Tensor, rows: Sequence[Sequence[int]],
                 kv_dtype: Optional[torch.dtype],
                 route: Optional[dict] = None) -> List[torch.Tensor]:
    """The logits of sequence ``b`` of ``tokens`` (B, S) at positions
    ``rows[b]``, one block of weights at a time (``weights(block)`` draws
    it).  Every pair the router picks is kept (a served step is dropless
    by the configuration's capacity).  ``route``: ``force`` (L, B, S, k)
    or None, and :func:`experts`' ``gap`` and ``own`` (a list the
    layers' (B, S, k) choices are appended to)."""
    blocks = [name for name, _ in layout(arch)]
    w = weights("embed")
    x = w["tokens"][tokens]
    del w
    windows = layer_windows(arch)
    for i in range(arch["n_layers"]):
        w = weights(blocks[1 + i])
        step = None
        if route is not None:
            force = route.get("force")
            step = dict(route, force=None if force is None else force[i])
        x, _ = layer(w, i, x, arch, windows[i], kv_dtype, capacity=False,
                     route=step)
        if step is not None:
            route["gap"] = step["gap"]
        del w
    w = weights("head")
    out = []
    for bi, r in enumerate(rows):
        h = rms_norm(x[bi, list(r)], w["final_norm"], arch["norm_eps"])
        out.append(h @ w["unembed"])
    return out


def train_loss(arch: dict, w: Dict[str, torch.Tensor],
               tokens: torch.Tensor, labels: torch.Tensor,
               z_loss: float, route: Optional[dict] = None) -> torch.Tensor:
    """Token-mean cross entropy with a z-loss, plus the layers' mean
    load-balance loss (moe), over the whole batch; differentiable.
    ``route``: as :func:`serve_logits`', with ``force`` and ``keep``
    lists of each layer's choices and kept pairs, or None."""
    x = w["tokens"][tokens.long()]
    windows = layer_windows(arch)
    aux_sum = torch.zeros((), dtype=F32, device=tokens.device)
    for i in range(arch["n_layers"]):
        step = None
        if route is not None:
            step = dict(route, **{key: None if route.get(key) is None
                                  else route[key][i]
                                  for key in ("force", "keep")})
        x, aux = layer(w, i, x, arch, windows[i], None, capacity=True,
                       route=step)
        if step is not None:
            route["gap"] = step["gap"]
        if aux is not None:
            aux_sum = aux_sum + aux
    logits = rms_norm(x, w["final_norm"], arch["norm_eps"]) @ w["unembed"]
    lse = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - gold + z_loss * lse ** 2
    return nll.mean() + aux_sum / arch["n_layers"]
