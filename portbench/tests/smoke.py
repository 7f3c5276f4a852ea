"""Configurations and mixes cut to a size the CPU tests run in seconds,
the families' structure kept (GQA, windowed and global layers, padded
experts, a shared expert)."""

from __future__ import annotations

import copy

from portbench.port import load_config
from portbench.traffic import load_mix

SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             d_ff=96, vocab_size=300, vocab_pad_to=64)


def config(name: str, **over) -> dict:
    cfg = copy.deepcopy(load_config(name))
    arch = cfg["arch"]
    small = dict(SMALL)
    if arch["family"] == "hybrid":
        small.update(sliding_window=8, global_every=2, ssm_state=4)
    if arch["family"] == "moe":
        small.update(n_experts=20, experts_padded_to=32, experts_per_token=2,
                     n_shared_experts=2, d_ff_expert=32, n_kv_heads=4)
        if "serve" in cfg:          # dropless at the smoke slots
            small.update(capacity_factor=32.0)
    small.update(over)
    arch.update(small)
    cfg["name"] = name + "-smoke"
    if "serve" not in cfg:     # the corpus is drawn over this vocabulary
        cfg["port_arch"] += "-smoke"
        arch["vocab_size"] = 503
    if "serve" in cfg:
        cfg["serve"].update(max_batch=4, max_len=64, block_tokens=16)
    return cfg


def mix(name: str) -> dict:
    m = copy.deepcopy(load_mix(name))
    if m["kind"] == "serve":
        m["prompt"].update(median=8, min=2, max=24)
        m["output"].update(median=6, min=2, max=16)
        m.update(pool=16, max_total=40, warmup_steps=2, profile_steps=2,
                 check_requests=3)
    else:
        m.update(batch=2, seq_len=32, check_steps=3, profile_steps=1)
        m["corpus"].update(tokens_per_shard=4096)
    return m
