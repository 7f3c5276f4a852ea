"""The decode kernel's split-KV scheme, emulated in torch on the CPU.

Kernel B3 (``csrc/decode_attention.cu``) cuts the live keys
``[start_b, len_b)`` of each (sequence, kv head) into ``splits``
tile-aligned parts, one block each; a block runs an online softmax over
its part, tile by tile, in base 2 (q scaled by log2(e) / sqrt(hd)), and
the partials merge in split order.  The CUDA code runs only on the card,
so the scheme is emulated here in plain torch -- the wrapper's split
count, each block's part, the per-part online softmax over the kernel's
tile size, the fixed-order merge -- and held against the plain version
and the JAX package's ``decode_attention_ref`` with the tolerances of
``tests/test_kernels.py`` (2e-5 in float32, 3e-2 in bfloat16).
"""

import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels import decode_attention as da

# One intra-op thread: the suite's workers share the cores, and torch's
# OpenMP threads, oversubscribed, spin-wait ~100x longer than the ops.
torch.set_num_threads(1)

LOG2E = 1.4426950408889634
SMS = 132                         # an H100 SXM's SMs
MIN_SPLIT_TILES = 8               # the kernel's kMinSplitTiles

CASES = [
    # (b, s, h, kv, hd, window) of tests/test_kernels.py's DECODE_CASES
    (4, 512, 8, 2, 64, 0),
    (2, 1024, 4, 4, 32, 0),
    (3, 512, 8, 4, 64, 200),
    (1, 256, 2, 1, 128, 0),
    # hymba-1.5b's heads (25/5 of 64) with its window of 1024
    (2, 1500, 25, 5, 64, 1024),
    # one (sequence, kv head) pair over a long cache: many parts
    (1, 4000, 4, 1, 64, 0),
    # gemma3-1b's engine shape (4/1 heads of 256, window 512) and
    # qwen2-1.5b's (12/2 heads of 128: the 8-head slots, two left empty)
    (8, 1024, 4, 1, 256, 512),
    (8, 1024, 12, 2, 128, 0),
]


def split_parts(length, window, s, splits, tile):
    """The parts as the kernel cuts them: (start, len, [(first tile, tile
    count)] for each block that works).  Of the ``splits`` blocks a pair
    gets, the first ``used`` take parts of at least MIN_SPLIT_TILES
    tiles; the rest stay idle."""
    length = min(max(length, 0), s)
    start = max(length - window, 0) if window > 0 else 0
    t_first = start // tile
    n_live = -(-length // tile) - t_first if length > start else 0
    used = max(1, min(splits, -(-n_live // MIN_SPLIT_TILES)))
    per = -(-n_live // used)
    return start, length, [(t_first + i * per,
                            max(min(per, n_live - i * per), 0))
                           for i in range(used)]


def emulate_split_decode(q, k, v, lengths, window, splits):
    """The kernel's scheme in float32 torch, one (b, kv head) at a time."""
    b, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    tile = da.tile_keys(g, hd, k.element_size())
    qs = q.float().reshape(b, kvh, g, hd) * (LOG2E / math.sqrt(hd))
    out = torch.zeros(b, kvh, g, hd)
    for bi in range(b):
        start, length, parts = split_parts(int(lengths[bi]), window, s,
                                           splits, tile)
        for kv in range(kvh):
            ms, ls, accs = [], [], []
            for tb, n in parts:                  # one block each
                m = torch.full((g,), -1e30)
                lsum = torch.zeros(g)
                acc = torch.zeros(g, hd)
                for t in range(tb, tb + n):      # its tiles, in order
                    lo, hi = max(t * tile, start), min((t + 1) * tile, length)
                    sc = qs[bi, kv] @ k[bi, lo:hi, kv].float().T   # (g, n)
                    mx = torch.maximum(m, sc.max(dim=1).values)
                    c = torch.exp2(m - mx)
                    p = torch.exp2(sc - mx[:, None])
                    lsum = lsum * c + p.sum(dim=1)
                    acc = acc * c[:, None] + p @ v[bi, lo:hi, kv].float()
                    m = mx
                ms.append(m)
                ls.append(lsum)
                accs.append(acc)
            top = torch.stack(ms).max(dim=0).values
            total = torch.zeros(g)
            o = torch.zeros(g, hd)
            for m, lsum, acc in zip(ms, ls, accs):   # split order
                e = torch.exp2(m - top)
                total = total + lsum * e
                o = o + acc * e[:, None]
            out[bi, kv] = o / total.clamp_min(1e-30)[:, None]
    return out.reshape(b, h, hd).to(q.dtype)


def _inputs(case, dtype, seed, lens=None):
    b, s, h, kv, hd, window = case
    rng = np.random.default_rng(seed)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]

    def make(shape):
        return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)
                                ).to(tdt)

    q, k, v = make((b, h, hd)), make((b, s, kv, hd)), make((b, s, kv, hd))
    if lens is None:
        lo = window + 1 if window else 1
        lens = rng.integers(lo, s, (b,))
    return q, k, v, torch.tensor(lens, dtype=torch.int32)


def _tol(dtype):
    return 3e-2 if dtype == "bfloat16" else 2e-5


def _assert_close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=_tol(dtype), rtol=_tol(dtype))


@pytest.mark.parametrize("case", CASES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("split_by", ["chooser", "one_per_tile"])
def test_split_scheme_matches_plain_and_ref(case, dtype, split_by):
    b, s, h, kv, hd, window = case
    q, k, v, lens = _inputs(case, dtype, 21)
    if split_by == "chooser":
        splits = da.choose_splits(b, kv, s, h // kv, SMS)
    else:                             # more parts than live tiles
        splits = -(-s // da.tile_keys(h // kv, hd, k.element_size()))
    assert splits > 1
    got = emulate_split_decode(q, k, v, lens, window, splits)
    _assert_close(got, da.decode_attention_plain(q, k, v, lens,
                                                 window=window), dtype)
    ref = decode_attention_ref(jnp.asarray(q.float().numpy()),
                               jnp.asarray(k.float().numpy()),
                               jnp.asarray(v.float().numpy()),
                               jnp.asarray(lens.numpy()), window=window)
    _assert_close(got, torch.from_numpy(np.array(ref)), dtype)


@pytest.mark.parametrize("name,case,lens,splits", [
    ("len0_len1", (3, 300, 8, 2, 64, 0), [0, 1, 300], 5),
    ("window_mid_tile", (3, 777, 8, 2, 64, 100), [777, 150, 101], 7),
    ("more_splits_than_tiles", (2, 300, 4, 1, 32, 0), [300, 65], 40),
    ("parts_with_window_mid_tile", (2, 3000, 8, 2, 64, 1000), [2999, 1500],
     9),
    ("two_head_sets", (2, 500, 16, 1, 128, 50), [500, 37], 9),
    ("hymba_window_edge", (2, 1500, 25, 5, 64, 1024), [1, 1100], 12),
    ("gemma3_hd256_window", (2, 1100, 4, 1, 256, 512), [1100, 513], 16),
], ids=lambda x: x if isinstance(x, str) else "")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_scheme_edge_cases(name, case, lens, splits, dtype):
    window = case[5]
    q, k, v, lengths = _inputs(case, dtype, 22, lens)
    got = emulate_split_decode(q, k, v, lengths, window, splits)
    want = da.decode_attention_plain(q, k, v, lengths, window=window)
    _assert_close(got, want, dtype)
    for bi, n in enumerate(lens):
        if n == 0:                    # no kept key: zeros, as the kernel
            assert torch.equal(got[bi], torch.zeros_like(got[bi]))
    kept = [i for i, n in enumerate(lens) if n > 0]
    ref = decode_attention_ref(jnp.asarray(q[kept].float().numpy()),
                               jnp.asarray(k[kept].float().numpy()),
                               jnp.asarray(v[kept].float().numpy()),
                               jnp.asarray(lengths[kept].numpy()),
                               window=window)
    _assert_close(got[kept], torch.from_numpy(np.array(ref)), dtype)


@settings(max_examples=400, deadline=None)
@given(length=st.integers(-3, 5000), window=st.integers(0, 3000),
       s=st.integers(1, 5000), splits=st.integers(1, 300),
       tile=st.sampled_from([32, 64]))
def test_parts_cover_the_live_keys_exactly_once(length, window, s, splits,
                                                tile):
    start, end, parts = split_parts(length, window, s, splits, tile)
    assert 0 <= start <= end <= s
    assert 1 <= len(parts) <= splits
    covered = np.zeros(s + tile, np.int64)
    for tb, n in parts:
        assert n >= 0
        if n:
            # every tile of a part holds a live key
            assert tb * tile < end and (tb + n) * tile > start
            covered[max(tb * tile, start):min((tb + n) * tile, end)] += 1
    assert (covered[start:end] == 1).all()
    assert covered[:start].sum() == 0 and covered[end:].sum() == 0


def test_split_chooser_reads_shapes_and_never_lengths():
    params = list(inspect.signature(da.choose_splits).parameters)
    assert params == ["batch", "kv_heads", "seq_len", "group", "sm_count"]
    # B * KV fills the card: one split (a decode_32k layer; 320 pairs)
    assert da.choose_splits(128, 8, 32768, 4, SMS) == 1
    assert da.choose_splits(40, 8, 300, 4, SMS) == 1
    # the engines' shapes, one wave of 264 blocks: llama 8 x 8 pairs,
    # hymba 8 x 5
    assert da.choose_splits(8, 8, 1024, 4, SMS) == 4
    assert da.choose_splits(8, 5, 1024, 5, SMS) == 6
    # capped by the cache's tiles: 64 keys, 32 above 8 heads per kv head
    assert da.choose_splits(1, 1, 100, 4, SMS) == 2
    assert da.choose_splits(1, 1, 100, 16, SMS) == 4
    assert da.choose_splits(1, 1, 1, 4, SMS) == 1


@settings(max_examples=300, deadline=None)
@given(b=st.integers(1, 512), kv=st.integers(1, 64), s=st.integers(1, 40000),
       group=st.integers(1, 16), sms=st.integers(1, 200))
def test_split_chooser_bounds(b, kv, s, group, sms):
    splits = da.choose_splits(b, kv, s, group, sms)
    tiles = -(-s // da.tile_keys(group))
    target = da.BLOCKS_PER_SM * sms
    assert 1 <= splits <= max(1, tiles)
    if b * kv >= target:
        assert splits == 1
    else:                             # one wave: as many as fit, or one
        assert b * kv * splits <= target          # part per tile
        assert b * kv * (splits + 1) > target or splits == tiles
