"""The port's managed stores against the JAX package's, on the CPU.

Ports every test of ``tests/test_stores.py`` (ShardCache, eviction
policies, KVBlockPool, the StoreRegistry waterfall); its one property
test runs here over seeded random workloads in place of ``hypothesis``.
Twins hold each copy to the JAX original: a ShardCache under each
eviction policy, with and without admission, and a registry waterfall
take one random sequence of put/get/drop/set_capacity and must evict the
same keys in the same order with the same stats.
"""

import numpy as np
import pytest

import repro.core as J
import repro_torch.core as T
from repro_torch.core import (KVBlockPool, LFUPolicy, LRUPolicy, ShardCache,
                              StoreRegistry, make_policy)
from repro_torch.core.eviction import AdaptivePolicy, FIFOPolicy
import torch

# One intra-op thread: the suite's workers share the cores, and torch's
# OpenMP threads, oversubscribed, spin-wait ~100x longer than the ops.
torch.set_num_threads(1)


class Blob:
    def __init__(self, nbytes):
        self.nbytes = nbytes


def test_cache_basic_hit_miss():
    c = ShardCache(capacity=100)
    assert c.get(1) is None
    assert c.put(1, Blob(40))
    assert c.get(1) is not None
    assert c.stats.hits == 1 and c.stats.misses == 1


def test_cache_eviction_at_capacity():
    c = ShardCache(capacity=100, policy="lru")
    c.put(1, Blob(40))
    c.put(2, Blob(40))
    c.put(3, Blob(40))                 # evicts 1 (LRU)
    assert 1 not in c and 2 in c and 3 in c
    assert c.used() <= c.capacity()


def test_set_capacity_evicts_immediately():
    c = ShardCache(capacity=120, policy="lru")
    for i in range(3):
        c.put(i, Blob(40))
    report = c.set_capacity(50)
    assert c.used() <= 50
    assert len(report.evicted_keys) == 2
    assert report.evicted_bytes == 80


def test_lfu_keeps_frequent():
    c = ShardCache(capacity=80, policy="lfu")
    c.put(1, Blob(40))
    c.put(2, Blob(40))
    for _ in range(5):
        c.get(1)
    c.put(3, Blob(40))                 # victim must be 2 (freq 1)
    assert 1 in c and 2 not in c


def test_lfu_mru_tiebreak_scan_resistance():
    p = LFUPolicy(tie="mru")
    for k in range(4):
        p.on_insert(k)
    assert p.victim() == 3             # newest among freq-1
    p_classic = LFUPolicy(tie="lru")
    for k in range(4):
        p_classic.on_insert(k)
    assert p_classic.victim() == 0


def test_admission_stabilizes_cyclic_scan():
    c = ShardCache(capacity=25, policy="lfu", admission=True,
                   sizeof=lambda v: 1.0)
    for _ in range(4):
        for k in range(64):
            if c.get(k) is None:
                c.put(k, object())
    assert c.stats.hit_ratio > 0.25


def test_oversized_object_rejected():
    c = ShardCache(capacity=10)
    assert not c.put(1, Blob(50))
    assert c.stats.rejected == 1


@pytest.mark.parametrize("seed", range(10))
def test_capacity_invariant_under_any_workload(seed):
    """used() <= capacity() after every operation, any access pattern
    (tests/test_stores.py's property, on seeded random workloads)."""
    rng = np.random.default_rng(seed)
    c = ShardCache(capacity=100, policy="lfu")
    for _ in range(int(rng.integers(1, 200))):
        key, size = int(rng.integers(0, 21)), int(rng.integers(1, 31))
        if c.get(key) is None:
            c.put(key, Blob(size))
        assert c.used() <= c.capacity()
        assert c.used() == sum(c._sizes.values())


def test_pool_alloc_free():
    p = KVBlockPool("kv", num_blocks=8, block_bytes=100)
    blocks = [p.alloc_block("a") for _ in range(3)]
    assert all(b is not None for b in blocks)
    assert p.num_free_blocks() == 5
    assert p.block_table("a") == blocks
    assert p.free_seq("a") == 3
    assert p.num_free_blocks() == 8


def test_pool_budget_rejects():
    p = KVBlockPool("kv", num_blocks=4, block_bytes=100)
    for _ in range(4):
        assert p.alloc_block("a") is not None
    assert p.alloc_block("b") is None
    assert p.stats.rejected == 1


def test_pool_shrink_preempts_largest_first():
    p = KVBlockPool("kv", num_blocks=8, block_bytes=100)
    for _ in range(5):
        p.alloc_block("big")
    for _ in range(2):
        p.alloc_block("small")
    report = p.set_capacity(300)       # 3 usable blocks
    assert "big" in report.evicted_keys
    assert p.drain_preempted() == ["big"]
    assert p.block_table("small")      # survivor intact


def test_pool_capacity_roundtrip():
    p = KVBlockPool("kv", num_blocks=8, block_bytes=100)
    p.set_capacity(200)
    assert p.num_free_blocks() == 2
    p.set_capacity(1e9)                # clamped to total
    assert p.num_free_blocks() == 8


def test_registry_waterfall():
    hi = ShardCache("hi", capacity=0, priority=10)
    lo = ShardCache("lo", capacity=0, priority=1)
    reg = StoreRegistry()
    reg.register(lo, max_bytes=100)
    reg.register(hi, max_bytes=50)
    reg.apply_capacity(120)
    assert hi.capacity() == 50         # high priority filled first
    assert lo.capacity() == 70
    reg.apply_capacity(30)
    assert hi.capacity() == 30 and lo.capacity() == 0


def test_make_policy_names():
    assert isinstance(make_policy("lfu"), LFUPolicy)
    assert isinstance(make_policy("lru"), LRUPolicy)
    assert isinstance(make_policy("fifo"), FIFOPolicy)
    assert isinstance(make_policy("adaptive"), AdaptivePolicy)
    with pytest.raises(ValueError, match="unknown eviction policy"):
        make_policy("mfu")


# -- twins: the same workload through both packages -------------------------

POLICIES = ["lfu", "lru", "fifo", "adaptive", "lfu-mru"]


def _policy(mod, name):
    if name == "lfu-mru":
        return mod.LFUPolicy(tie="mru")
    return name


def _cache_op(c, rng):
    op, key = int(rng.integers(0, 10)), int(rng.integers(0, 40))
    size = float(rng.integers(1, 60))
    if op < 4:
        hit = c.get(key, loader=(lambda s=size: Blob(s))
                    if op == 0 else None)
        return ("get", key, hit is not None)
    if op < 7:
        return ("put", key, c.put(key, Blob(size)))
    if op < 8:
        c.drop(key)
        return ("drop", key)
    r = c.set_capacity(float(rng.integers(0, 600)))
    return ("cap", r.applied_capacity, tuple(r.evicted_keys),
            r.evicted_bytes)


def _cache_trace(mod, policy, admission, seed):
    """Drive one cache; returns what every operation returned and did.

    A put that admission rejects for a key already resident leaves the
    key in the cache but not in its policy, so a later hit on it raises
    ``KeyError`` in both packages (ROADMAP C10): the trace records the
    error and goes on."""
    rng = np.random.default_rng(seed)
    c = mod.ShardCache("c", capacity=400.0, policy=_policy(mod, policy),
                       admission=admission)
    out = []
    for _ in range(600):
        try:
            out.append(_cache_op(c, rng))
        except KeyError as exc:
            out.append(("KeyError", exc.args))
        out.append((c.used(), c.capacity(), sorted(c.keys())))
    st = c.stats
    out.append((st.hits, st.misses, st.insertions, st.evictions,
                st.rejected, st.bytes_evicted, st.bytes_read_remote))
    if policy == "adaptive":
        out.append(c._policy.active_name)
    return out


@pytest.mark.parametrize("admission", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
def test_cache_copy_matches_the_jax_cache(policy, admission):
    for seed in (0, 1):
        assert _cache_trace(J, policy, admission, seed) == \
            _cache_trace(T, policy, admission, seed)


def test_adaptive_policy_switches_as_jax_does():
    """A random mix of inserts, hits and evictions flips the adaptive
    policy between LFU and LRU; the copy flips at the same steps."""
    def trace(mod, seed):
        rng = np.random.default_rng(seed)
        p = mod.AdaptivePolicy(ghost_size=16, switch_margin=2)
        names, live = [], set()
        for _ in range(400):
            k = int(rng.integers(0, 24))
            if k in live:
                if rng.random() < 0.7:
                    p.on_access(k)
            else:
                p.on_insert(k)
                live.add(k)
                if len(live) > 8:
                    victim = p.victim()
                    p.remove(victim)
                    live.discard(victim)
            names.append(p.active_name)
        return names

    for seed in range(3):
        port = trace(T, seed)
        assert len(set(port)) == 2 and port == trace(J, seed)


def test_registry_copy_matches_the_jax_registry():
    rng = np.random.default_rng(5)

    def build(mod):
        caches = [mod.ShardCache(f"c{i}", capacity=0.0, priority=p,
                                 sizeof=lambda v: v.nbytes)
                  for i, p in enumerate((1, 10, 5))]
        reg = mod.StoreRegistry()
        for c, cap in zip(caches, (300.0, 100.0, 200.0)):
            reg.register(c, max_bytes=cap)
        return caches, reg

    (jc, jr), (tc, tr) = build(J), build(T)
    for _ in range(200):
        key, size = int(rng.integers(0, 30)), float(rng.integers(1, 50))
        i = int(rng.integers(0, 3))
        assert jc[i].put(key, Blob(size)) == tc[i].put(key, Blob(size))
        if rng.random() < 0.2:
            u = float(rng.integers(0, 700))
            a, b = jr.apply_capacity(u), tr.apply_capacity(u)
            assert [(r.store, r.applied_capacity, r.evicted_keys)
                    for r in a] == [(r.store, r.applied_capacity,
                                     r.evicted_keys) for r in b]
        assert jr.total_used() == tr.total_used()
        assert jr.total_capacity() == tr.total_capacity()
