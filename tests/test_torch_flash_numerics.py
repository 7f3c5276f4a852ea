"""The flash kernel's arithmetic, emulated on the CPU, against the plain
version and the JAX package's oracle.

``csrc/flash_attention.cu`` runs on the tensor cores and has no CPU mode.
Its numeric scheme does, and this file emulates it in plain torch: the
kernel's q tiles (64 rows in bf16, 128 in f32) and kv tiles (64 keys, 32
for f32 at hd 128) over its tile range, an online softmax in float32,
and the two products as the card forms them:

* bf16 inputs: products of bf16 values summed in float32, and P rounded
  to bf16 before P.V (the row sum keeps the unrounded P);
* f32 inputs: 3xTF32, each operand split into hi = tf32(x) and lo =
  tf32(x - hi), hi.lo + lo.hi + hi.hi summed in float32, tf32 being
  float32 rounded to 10 mantissa bits, to nearest with ties away from
  zero (``cvt.rna.tf32.f32``); each tile's P.V is summed from zero and
  then added to the accumulator.

The emulation is held to ``flash_attention_plain`` and to
``attention_ref`` (``src/repro/kernels/flash_attention/ref.py``) with
the tolerances of ``tests/test_kernels.py``: 2e-2 in bf16, 2e-5 in f32.
Single-pass TF32 misses 2e-5, which is why the f32 path pays for three
products.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels import flash_attention as fa

# One intra-op thread: the suite's workers share the cores, and torch's
# OpenMP threads, oversubscribed, spin-wait ~100x longer than the ops.
torch.set_num_threads(1)

NEG_INF = -1e30

CASES = [
    # (b, sq, skv, h, kv, hd, causal, window): tests/test_kernels.py's
    # FLASH_CASES, chip_smoke.py's ragged case at 32/8 heads, hymba's
    # 25/5 heads with its window of 1024
    (2, 256, 256, 4, 2, 64, True, 0),
    (1, 128, 128, 4, 4, 32, True, 0),
    (2, 128, 256, 4, 1, 64, False, 0),
    (1, 256, 256, 8, 2, 64, True, 64),
    (1, 512, 512, 2, 2, 128, True, 0),
    (2, 192, 192, 4, 2, 64, True, 48),
    (2, 300, 300, 32, 8, 64, True, 0),
    (1, 1100, 1100, 25, 5, 64, True, 1024),
    # gemma3-1b's 4/1 heads of 256, its window of 512 and global
    (1, 600, 600, 4, 1, 256, True, 512),
    (1, 77, 300, 4, 2, 256, False, 0),
]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to tf32: the 13 low mantissa bits to nearest,
    ties away from zero (sign and magnitude: add half, truncate)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def product(a: torch.Tensor, b: torch.Tensor, scheme: str) -> torch.Tensor:
    """a @ b in float32 from the operands as the tensor cores take them."""
    if scheme == "bf16":
        return a @ b              # bf16 values, exact in f32, f32 sums
    ah, bh = tf32(a), tf32(b)
    if scheme == "tf32":
        return ah @ bh
    al, bl = tf32(a - ah), tf32(b - bh)
    return ah @ bl + al @ bh + ah @ bh


def tiles(scheme, hd):
    """(q rows, kv keys) of the kernel's tiles for a scheme and head dim."""
    if scheme == "bf16":
        return 64, 32 if hd == 256 else 64
    if hd == 256:
        return 64, 16
    return 128, 32 if hd == 128 else 64


def emulate(q, k, v, *, causal, window, scheme):
    """The kernel's tiles and online softmax; q/k/v in their own type."""
    b, sq, h, hd = q.shape
    bq, bk = tiles(scheme, hd)
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    # (B, H, S, hd) in float32, kv heads repeated for their query heads
    qf = q.float().permute(0, 2, 1, 3)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    scale = 1.0 / hd ** 0.5
    out = torch.zeros((b, h, sq, hd))
    for q0 in range(0, sq, bq):
        rows = torch.arange(q0, q0 + bq)
        qt = torch.zeros((b, h, bq, hd))
        qt[:, :, :min(bq, sq - q0)] = qf[:, :, q0:q0 + bq]
        q_last = min(q0 + bq, sq) - 1
        k_end = min(skv, q_last + 1) if causal else skv
        k_first = max(q0 - window + 1, 0) if window else 0
        m = torch.full((b, h, bq, 1), NEG_INF)
        l = torch.zeros((b, h, bq, 1))
        acc = torch.zeros((b, h, bq, hd))
        for k0 in range(k_first // bk * bk, k_end, bk):
            n = min(bk, skv - k0)
            kt = torch.zeros((b, h, bk, hd))
            vt = torch.zeros((b, h, bk, hd))
            kt[:, :, :n] = kf[:, :, k0:k0 + n]
            vt[:, :, :n] = vf[:, :, k0:k0 + n]
            s = product(qt, kt.transpose(-1, -2), scheme) * scale
            keys = torch.arange(k0, k0 + bk)
            keep = (keys[None] < skv).expand(bq, bk)
            if causal:
                keep = keep & (keys[None] <= rows[:, None])
            if window:
                keep = keep & (keys[None] > rows[:, None] - window)
            s = torch.where(keep, s, torch.tensor(NEG_INF))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            if scheme == "bf16":
                p = p.bfloat16().float()
            acc = acc * corr + product(p, vt, scheme)
            m = m_new
        o = acc / l.clamp_min(1e-30)
        out[:, :, q0:q0 + bq] = o[:, :, :min(bq, sq - q0)]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def inputs(case, dtype, seed=14):
    """q, k, v of one case from numpy, as torch tensors and JAX arrays."""
    b, sq, skv, h, kv, hd, _, _ = case
    rng = np.random.default_rng(seed)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    out = []
    for shape in ((b, sq, h, hd), (b, skv, kv, hd), (b, skv, kv, hd)):
        x = jnp.asarray(rng.normal(0, 1, shape), jdt)
        out.append((torch.from_numpy(np.array(x, np.float32)).to(dtype), x))
    return out


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                      # tf32's spacing at 1
    x = torch.tensor([one + ulp / 2, one + ulp / 2 - 2 ** -23,
                      -(one + ulp / 2), one + 3 * ulp / 2, 3.0e-3])
    got = tf32(x)
    want = torch.tensor([one + ulp, one, -(one + ulp), one + 2 * ulp])
    assert torch.equal(got[:4], want)
    assert (got.view(torch.int32) & 0x1fff == 0).all()
    assert float((got[4] - x[4]).abs()) <= 3.0e-3 * 2 ** -11


@pytest.mark.parametrize("case", CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_kernel_scheme_matches_plain_and_ref(case, dtype):
    _, _, _, _, _, _, causal, window = case
    (q, jq), (k, jk), (v, jv) = inputs(case, dtype)
    scheme = "bf16" if dtype == torch.bfloat16 else "3xtf32"
    got = emulate(q, k, v, causal=causal, window=window, scheme=scheme)
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    plain = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), plain.float(), atol=tol,
                               rtol=tol)
    ref = attention_ref(jq.astype(jnp.float32), jk.astype(jnp.float32),
                        jv.astype(jnp.float32), causal=causal, window=window)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref),
                               atol=tol, rtol=tol)


def test_single_pass_tf32_misses_the_f32_tolerance():
    worst = 0.0
    for case in CASES[:3]:
        _, _, _, _, _, _, causal, window = case
        (q, _), (k, _), (v, _) = inputs(case, torch.float32)
        plain = fa.flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
        one = emulate(q, k, v, causal=causal, window=window, scheme="tf32")
        three = emulate(q, k, v, causal=causal, window=window,
                        scheme="3xtf32")
        worst = max(worst, float((one - plain).abs().max()))
        assert float((three - plain).abs().max()) < 2e-5
    assert worst > 2e-5, f"single-pass TF32 held 2e-5 ({worst:.2e})"
