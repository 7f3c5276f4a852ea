"""The attention kernels' plain versions against the JAX package.

Kernel B3 (decode attention) and B2 (flash attention) run on the CPU as
their plain PyTorch versions, the versions ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold the CUDA kernels to.  Here they are
held to the JAX package's oracles on the same numpy inputs:
``decode_attention_ref`` and ``attention_ref`` over the cases of
``tests/test_kernels.py``, with its tolerances (2e-5 in float32; 3e-2
and 2e-2 in bfloat16), and the model's ``attention_decode`` with
``lengths = pos + 1``.  The Pallas kernels themselves do not build on
this JAX (ROADMAP C1), so their ``ref.py`` oracles stand in.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels.decode_attention.ref import decode_attention_ref
from repro.kernels.flash_attention.ref import attention_ref
from repro.models.attention import attention_decode as jax_attention_decode
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.attention import attention_decode

# One intra-op thread: the suite's workers share the cores, and torch's
# OpenMP threads, oversubscribed, spin-wait ~100x longer than the ops.
torch.set_num_threads(1)

FLASH_CASES = [
    # (b, sq, skv, h, kv, hd, causal, window) of tests/test_kernels.py
    (2, 256, 256, 4, 2, 64, True, 0),
    (1, 128, 128, 4, 4, 32, True, 0),
    (2, 128, 256, 4, 1, 64, False, 0),
    (1, 256, 256, 8, 2, 64, True, 64),
    (1, 512, 512, 2, 2, 128, True, 0),
    (2, 192, 192, 4, 2, 64, True, 48),
    # gemma3-1b's head dim of 256, windowed and global
    (2, 300, 300, 4, 1, 256, True, 128),
    (1, 128, 256, 4, 2, 256, False, 0),
]

DECODE_CASES = [
    # (b, s, h, kv, hd, window) of tests/test_kernels.py
    (4, 512, 8, 2, 64, 0),
    (2, 1024, 4, 4, 32, 0),
    (3, 512, 8, 4, 64, 200),
    (1, 256, 2, 1, 128, 0),
    # gemma3-1b (4/1 heads of 256, window 512) and qwen2-1.5b (12/2 of 128)
    (8, 1024, 4, 1, 256, 512),
    (4, 512, 12, 2, 128, 0),
]

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(rng, shape, name):
    """The same values as a JAX array and a torch tensor of one type."""
    jdt, tdt = DTYPES[name]
    x = jnp.asarray(rng.normal(0, 1, shape), jdt)
    return x, torch.from_numpy(np.array(x, np.float32)).to(tdt)


@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_decode_matches_ref(case, dtype):
    b, s, h, kv, hd, window = case
    rng = np.random.default_rng(11)
    jq, q = _pair(rng, (b, h, hd), dtype)
    jk, k = _pair(rng, (b, s, kv, hd), dtype)
    jv, v = _pair(rng, (b, s, kv, hd), dtype)
    lo = window + 1 if window else 1
    lens = rng.integers(lo, s, (b,)).astype(np.int32)
    before = da.LAUNCHES
    out = da.decode_attention(q, k, v, torch.from_numpy(lens), window=window)
    assert da.LAUNCHES == before
    assert out.dtype == q.dtype and out.shape == q.shape
    ref = decode_attention_ref(jq.astype(jnp.float32), jk.astype(jnp.float32),
                               jv.astype(jnp.float32), jnp.asarray(lens),
                               window=window)
    tol = 3e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("window", [0, 200])
def test_model_decode_equals_jax_attention_decode(window):
    """``lengths = pos + 1`` turns the kernel's ``[0, len)`` and window
    ``k >= len - window`` into JAX's ``[0, pos]`` and ``k > pos - window``.
    Without a window, a position at or past S keeps every key, as JAX's
    mask does; with one, positions past S are left out (see
    ``attention_decode``)."""
    b, s, h, kv, hd = 5, 384, 8, 2, 64
    rng = np.random.default_rng(5)
    q = rng.normal(0, 1, (b, 1, h, hd)).astype(np.float32)
    k = rng.normal(0, 1, (b, s, kv, hd)).astype(np.float32)
    v = rng.normal(0, 1, (b, s, kv, hd)).astype(np.float32)
    last = s + 40 if window == 0 else s - 2
    pos = np.array([0, 7, 250, s - 1, last], np.int32)
    cfg = jax_config("llama3.2-1b-smoke")
    ref = jax_attention_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(pos), cfg, window=window)
    out = attention_decode(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(pos),
                           cfg, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)


def test_plain_decode_never_reads_past_length():
    """NaN past each length (and before the window) changes nothing."""
    b, s, h, kv, hd = 3, 300, 4, 2, 32
    g = torch.Generator().manual_seed(0)
    q = torch.randn((b, h, hd), generator=g)
    k = torch.randn((b, s, kv, hd), generator=g)
    v = torch.randn((b, s, kv, hd), generator=g)
    lens = torch.tensor([100, 17, s], dtype=torch.int32)
    for window in (0, 40):
        out1 = da.decode_attention(q, k, v, lens, window=window)
        pos = torch.arange(s)[None, :]
        dead = pos >= lens[:, None]
        if window:
            dead |= pos < lens[:, None] - window
        kp = k.masked_fill(dead[..., None, None], float("nan"))
        vp = v.masked_fill(dead[..., None, None], float("nan"))
        out2 = da.decode_attention(q, kp, vp, lens, window=window)
        assert bool(torch.isfinite(out2).all())
        assert torch.equal(out1, out2)


def test_plain_decode_with_no_kept_key_gives_zeros():
    q = torch.ones((2, 2, 16))
    k = torch.ones((2, 8, 1, 16))
    out = da.decode_attention(q, k, k, torch.tensor([0, 3], dtype=torch.int32))
    assert torch.equal(out[0], torch.zeros(2, 16))
    assert torch.allclose(out[1], torch.ones(2, 16))


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_flash_matches_ref(case, dtype):
    b, sq, skv, h, kv, hd, causal, window = case
    rng = np.random.default_rng(12)
    jq, q = _pair(rng, (b, sq, h, hd), dtype)
    jk, k = _pair(rng, (b, skv, kv, hd), dtype)
    jv, v = _pair(rng, (b, skv, kv, hd), dtype)
    before = fa.LAUNCHES
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.LAUNCHES == before
    assert out.dtype == q.dtype and out.shape == q.shape
    ref = attention_ref(jq.astype(jnp.float32), jk.astype(jnp.float32),
                        jv.astype(jnp.float32), causal=causal, window=window)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref),
                               atol=tol, rtol=tol)


class _OnCuda:
    """Stands in for a CUDA tensor: dispatch reads only ``.device``."""

    device = torch.device("cuda", 0)


@pytest.mark.parametrize("mod,call", [
    (da, lambda m, x: m.decode_attention(x, None, None, None)),
    (fa, lambda m, x: m.flash_attention(x, None, None)),
], ids=["decode", "flash"])
def test_cuda_tensors_launch_the_kernel_and_never_the_plain_version(
        monkeypatch, mod, call):
    plain = "decode_attention_plain" if mod is da else "flash_attention_plain"

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(mod, plain, refuse)
    monkeypatch.setattr(mod, "_launch", lambda *a, **k: "kernel")
    assert call(mod, _OnCuda()) == "kernel"
    with pytest.raises(ValueError, match="cpu or cuda"):
        call(mod, torch.empty((1, 1, 1, 1), device="meta"))


@pytest.mark.parametrize("bad", ["hd", "group", "lengths", "mixed_cache",
                                 "grid"])
def test_decode_wrapper_rejects_what_the_kernel_cannot_take(bad):
    q = torch.zeros((2, 4, 64))
    k = torch.zeros((2, 16, 2, 64))
    v = torch.zeros((2, 16, 2, 64))
    lens = torch.ones(2, dtype=torch.int32)
    if bad == "grid":                 # B past the grid's z (65535)
        b = da.MAX_GRID + 1
        q = q[:1].expand(b, 4, 64)
        k = v = k[:1].expand(b, 16, 2, 64)
        lens = torch.ones(b, dtype=torch.int32)
        with pytest.raises(ValueError, match="grid"):
            da._check(q, k, v, lens)
        return
    if bad == "hd":
        q, k, v = q[..., :48], k[..., :48].contiguous(), v[..., :48]
    elif bad == "group":
        q = torch.zeros((2, 34, 64))
        k = v = torch.zeros((2, 16, 2, 64))
    elif bad == "lengths":
        lens = lens.long()
    else:
        v = v.bfloat16()
    with pytest.raises(ValueError):
        da._check(q, k, v, lens)


def test_flash_wrapper_rejects_mixed_types_and_head_dims():
    q = torch.zeros((1, 8, 2, 64))
    with pytest.raises(ValueError):
        fa._check(q, q.bfloat16(), q)
    with pytest.raises(ValueError):
        fa._check(q[..., :24], q[..., :24], q[..., :24])
    wide = q[:, :, :1].expand(fa.MAX_GRID + 1, 8, 1, 64)  # past the grid
    with pytest.raises(ValueError, match="grid"):
        fa._check(wide, wide, wide)
    fa._check(wide[:fa.MAX_GRID], wide[:fa.MAX_GRID], wide[:fa.MAX_GRID])
