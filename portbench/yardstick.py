"""The yardstick: data-sheet peaks, kernel work and useful model FLOPs.

The peaks are NVIDIA's H100 SXM data sheet (dense rates, no sparsity,
at the full 700 W power limit).  Work is counted from shapes: each
input byte read once, each output byte written once, whatever the
kernel reads again; FLOPs are the model's useful ones (no recompute,
no padded experts, only the routed choices).
"""

from __future__ import annotations

from typing import Iterable, Tuple

from .reference.model import head_dim, layer_windows

HBM_BW = 3.35e12          # bytes/s
PEAK_F32 = 67e12          # float32 FLOP/s outside the tensor cores


def bound_s(flops: float, n_bytes: float, peak: float = PEAK_F32) -> float:
    """The least time for the work: the larger of its two terms."""
    return max(flops / peak, n_bytes / HBM_BW)


def decode_attention_work(lengths: Iterable[int], s: int, heads: int,
                          kv_heads: int, hd: int, window: int,
                          q_bytes: int = 4, kv_bytes: int = 2
                          ) -> Tuple[float, float]:
    """(FLOPs, bytes) of one decode-attention call: the K and V of the
    positions each slot attends (``min(len, window)``, cut to the cache's
    ``s``) read once, q read and the output written once, the lengths
    read; 4 * hd FLOPs per (key, query head)."""
    lengths = list(lengths)
    keys = 0
    for n in lengths:
        n = min(max(int(n), 0), s)
        keys += min(n, window) if window else n
    b = len(lengths)
    n_bytes = (keys * kv_heads * hd * 2 * kv_bytes
               + 2 * b * heads * hd * q_bytes + 4 * b)
    return 4.0 * keys * heads * hd, float(n_bytes)


def _dense_token_flops(arch: dict) -> float:
    """Matrix FLOPs of one token through every layer and the readout,
    attention's scores and values excepted."""
    d, h, kv = arch["d_model"], arch["n_heads"], arch["n_kv_heads"]
    hd = head_dim(arch)
    per = 2 * d * (h + 2 * kv) * hd + 2 * h * hd * d
    fam = arch["family"]
    if fam == "moe":
        f, k = arch["d_ff_expert"], arch["experts_per_token"]
        per += 2 * d * arch["n_experts"] + k * 6 * d * f
        per += 6 * d * arch["n_shared_experts"] * f + 2 * d
    else:
        per += 6 * d * arch["d_ff"]
    if fam == "hybrid":
        inner, n = arch["ssm_expand"] * d, arch["ssm_state"]
        per += (4 * d * inner + 2 * inner * (1 + 2 * n) + 2 * inner * d
                + 2 * arch["ssm_conv"] * inner + 4 * inner * n)
    return float(arch["n_layers"] * per + 2 * d * arch["vocab_size"])


def _attention_flops(arch: dict, context: int) -> float:
    """Scores and values of one query at ``context`` positions, over
    every layer, each layer's window applied."""
    h, hd = arch["n_heads"], head_dim(arch)
    return float(sum(4 * h * hd * (min(context, w) if w else context)
                     for w in layer_windows(arch)))


def decode_token_flops(arch: dict, context: int) -> float:
    """Useful FLOPs of one token fed at a cache of ``context`` positions
    (itself included)."""
    return _dense_token_flops(arch) + _attention_flops(arch, context)


def train_step_flops(arch: dict, batch: int, seq: int) -> float:
    """Useful FLOPs of one training step: three times the forward's
    (forward, and the backward's two products), causal attention."""
    attn = sum(_attention_flops(arch, pos + 1) for pos in range(seq))
    return 3.0 * batch * (seq * _dense_token_flops(arch) + attn)


def serve_window_flops(run) -> float:
    """Useful FLOPs of the tokens a serving window fed: each token's
    dense FLOPs, and attention's over the keys it attended (``run.ctx``:
    per window, the keys summed over the fed tokens)."""
    arch = run.arch
    h, hd = arch["n_heads"], head_dim(arch)
    windows = layer_windows(arch)
    attn = sum(4 * h * hd * windows.count(w) * keys
               for w, keys in run.ctx.items())
    return run.fed * _dense_token_flops(arch) + attn
