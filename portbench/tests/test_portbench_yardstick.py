"""The FLOP and byte counts of ``mfu.*`` and ``b3_roofline``, against
shapes worked by hand."""

from types import SimpleNamespace

import pytest

from portbench import yardstick as Y

DENSE = dict(family="dense", n_layers=2, d_model=8, n_heads=2, n_kv_heads=1,
             head_dim=4, d_ff=16, vocab_size=10)
MOE = dict(DENSE, family="moe", n_experts=6, experts_per_token=2,
           d_ff_expert=3, n_shared_experts=1)
HYBRID = dict(DENSE, family="hybrid", ssm_expand=2, ssm_state=2, ssm_conv=4,
              sliding_window=4, global_every=2)


def test_decode_attention_work_by_hand():
    # keys: min(3, 8, window 4) = 3 and min(10 -> 8, 4) = 4
    flops, n_bytes = Y.decode_attention_work([3, 10], s=8, heads=2,
                                             kv_heads=1, hd=4, window=4)
    assert flops == 4 * 7 * 2 * 4
    assert n_bytes == 7 * 1 * 4 * 2 * 2 + 2 * 2 * 2 * 4 * 4 + 2 * 4
    flops, n_bytes = Y.decode_attention_work([3, 10], s=8, heads=2,
                                             kv_heads=1, hd=4, window=0)
    assert flops == 4 * 11 * 2 * 4


def test_bound_takes_the_larger_term():
    assert Y.bound_s(67e12, 0.0) == pytest.approx(1.0)
    assert Y.bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert Y.bound_s(67e12, 6.7e12) == pytest.approx(2.0)


def test_dense_token_flops_by_hand():
    attn_proj = 2 * 8 * (2 + 2) * 4 + 2 * 2 * 4 * 8          # 256 + 128
    mlp = 6 * 8 * 16
    per_layer = attn_proj + mlp
    head = 2 * 8 * 10
    ctx = 5                                   # 4 * H * hd * keys a layer
    assert Y.decode_token_flops(DENSE, ctx) == 2 * per_layer + head \
        + 2 * 4 * 2 * 4 * ctx


def test_moe_counts_only_the_routed_choices():
    attn_proj = 2 * 8 * (2 + 2) * 4 + 2 * 2 * 4 * 8
    routed = 2 * 8 * 6 + 2 * 6 * 8 * 3                # router, k = 2 experts
    shared = 6 * 8 * 3 + 2 * 8                        # shared expert, gate
    per_layer = attn_proj + routed + shared
    assert Y.decode_token_flops(MOE, 1) == 2 * per_layer + 2 * 8 * 10 \
        + 2 * 4 * 2 * 4


def test_hybrid_windows_cut_attention():
    # layers: window 4, then global (period 2)
    base = Y.decode_token_flops(HYBRID, 1) - 2 * 4 * 2 * 4
    at10 = Y.decode_token_flops(HYBRID, 10)
    assert at10 - base == 4 * 2 * 4 * (4 + 10)
    inner = 16
    mamba = (4 * 8 * inner + 2 * inner * 5 + 2 * inner * 8 + 2 * 4 * inner
             + 4 * inner * 2)
    dense = Y.decode_token_flops(dict(HYBRID, family="dense"), 1)
    assert Y.decode_token_flops(HYBRID, 1) - dense == 2 * mamba


def test_train_step_is_three_forwards_with_causal_attention():
    seq, batch = 6, 3
    fwd = seq * (Y.decode_token_flops(DENSE, 1) - 2 * 4 * 2 * 4)
    attn = sum(2 * 4 * 2 * 4 * (p + 1) for p in range(seq))
    assert Y.train_step_flops(DENSE, batch, seq) == 3 * batch * (fwd + attn)


def test_serve_window_flops_sums_the_fed_tokens():
    run = SimpleNamespace(arch=HYBRID, fed=3, ctx={4: 9, 0: 12})
    dense = Y.decode_token_flops(HYBRID, 0)
    assert Y.serve_window_flops(run) == 3 * dense + 4 * 2 * 4 * (9 + 12)
