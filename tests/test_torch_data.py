"""The port's data pipeline against the JAX package's.

``DataPipeline.batch(step)`` over the same corpus gives JAX's batch byte
for byte for every step 0..20 (that ``write_corpus`` writes JAX's bytes
is a port rule, ``tests/test_torch_port_rules.py``); the JAX data tests
(determinism, shifted labels, the cache's effect on store reads) hold
for the port; ``to_device`` stages a batch as int32 tensors on the
device asked for.
"""

import numpy as np
import pytest
import torch

from repro.data import DataPipeline as JaxPipeline
from repro.data import PipelineConfig as JaxConfig
from repro.data import ShardStore as JaxStore
from repro.data import write_corpus as jax_write_corpus
from repro_torch.data import (DataPipeline, PipelineConfig, ShardStore,
                              write_corpus)

# One intra-op thread: the suite's workers share the cores, and torch's
# OpenMP threads, oversubscribed, spin-wait ~100x longer than the ops.
torch.set_num_threads(1)

CORPUS = dict(n_shards=6, tokens_per_shard=2048, vocab_size=101, seed=3)


@pytest.fixture()
def corpora(tmp_path):
    """The same corpus written by each package."""
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    man = write_corpus(port, **CORPUS)
    jman = jax_write_corpus(ref, **CORPUS)
    assert man.__dict__ == jman.__dict__
    return port, ref


@pytest.fixture()
def store(corpora):
    return ShardStore(corpora[0])


@pytest.mark.parametrize("cfg", [
    dict(batch_size=4, seq_len=32, seed=9),
    dict(batch_size=3, seq_len=2040, seed=0),
], ids=["short", "whole-shard"])
def test_batches_equal_jax_byte_for_byte(corpora, cfg):
    port = DataPipeline(ShardStore(corpora[0]),
                        PipelineConfig(**cfg, prefetch_depth=0,
                                       dynims=False))
    ref = JaxPipeline(JaxStore(corpora[1]),
                      JaxConfig(**cfg, prefetch_depth=0, dynims=False))
    for step in range(21):
        a, b = port.batch(step), ref.batch(step)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            assert a[k].tobytes() == b[k].tobytes(), (step, k)
    assert port.store.reads == ref.store.reads
    assert port.hit_ratio == ref.hit_ratio
    port.close(), ref.close()


def test_batches_deterministic_by_step(store):
    cfg = PipelineConfig(batch_size=4, seq_len=32, seed=9,
                         prefetch_depth=0, dynims=False)
    b1 = DataPipeline(store, cfg).batch(17)
    b2 = DataPipeline(store, cfg).batch(17)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    # restart safety: computing step 17 after 0..16 == computing it cold
    p3 = DataPipeline(store, cfg)
    for s in range(17):
        p3.batch(s)
    np.testing.assert_array_equal(b1["tokens"], p3.batch(17)["tokens"])


def test_labels_are_shifted_tokens(store):
    p = DataPipeline(store, PipelineConfig(batch_size=2, seq_len=16,
                                           prefetch_depth=0, dynims=False))
    sid, off = p._plan(0)[0]
    b = p.batch(0)
    shard = store.read(int(sid))
    np.testing.assert_array_equal(b["tokens"][0], shard[off:off + 16])
    np.testing.assert_array_equal(b["labels"][0], shard[off + 1:off + 17])


def test_cache_reduces_store_reads_and_shrink_forces_rereads(store):
    cfg = PipelineConfig(batch_size=8, seq_len=32, cache_bytes=1 << 20,
                         prefetch_depth=0, dynims=False)
    p = DataPipeline(store, cfg)
    for s in range(20):
        p.batch(s)
    assert store.reads <= 6                  # every shard read at most once
    assert p.hit_ratio > 0.5
    reads = store.reads
    p.cache.set_capacity(0)                  # burst: drop everything
    p.cache.set_capacity(1 << 20)
    for s in range(20, 25):
        p.batch(s)
    assert store.reads > reads               # had to refetch


def test_prefetcher_warms_the_cache_and_stops(store):
    p = DataPipeline(store, PipelineConfig(batch_size=8, seq_len=32,
                                           cache_bytes=1 << 20,
                                           prefetch_depth=2, dynims=False))
    ref = DataPipeline(store, PipelineConfig(batch_size=8, seq_len=32,
                                             cache_bytes=1 << 20,
                                             prefetch_depth=0, dynims=False))
    for s in range(5):
        np.testing.assert_array_equal(p.batch(s)["tokens"],
                                      ref.batch(s)["tokens"])
    p.close()
    assert p._prefetcher is None


def test_to_device_stages_int32_tensors_on_the_cpu(store):
    p = DataPipeline(store, PipelineConfig(batch_size=2, seq_len=8,
                                           prefetch_depth=0, dynims=False))
    batch = p.batch(3)
    staged = p.to_device(batch, "cpu")
    for k, v in batch.items():
        assert staged[k].dtype == torch.int32
        assert staged[k].device.type == "cpu"
        np.testing.assert_array_equal(staged[k].numpy(), v)
