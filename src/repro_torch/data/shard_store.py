"""On-disk tokenized shard store (the OrangeFS role in the paper).

A copy of ``repro/data/shard_store.py`` (numpy only; the port keeps its
own copy and a test holds it to the original byte for byte).  A corpus
is a directory of fixed-size token shards (``shard-%05d.npy``) plus
``manifest.json``.  Reads are whole-shard (the unit the DynIMS-managed
cache evicts -- matching Alluxio's block granularity).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Manifest:
    n_shards: int
    tokens_per_shard: int
    vocab_size: int
    dtype: str = "int32"

    @property
    def total_tokens(self) -> int:
        return self.n_shards * self.tokens_per_shard


def write_corpus(path: str, *, n_shards: int, tokens_per_shard: int,
                 vocab_size: int, seed: int = 0,
                 zipf_exponent: float = 1.2) -> Manifest:
    """Generate a synthetic tokenized corpus (deterministic).

    Tokens are drawn from a Zipfian unigram distribution (real corpora
    are Zipf-distributed; exponent ~1 for natural language).  A uniform
    corpus (``zipf_exponent=0``) carries no learnable signal at all, so
    a smoke-scale trainer run can't demonstrate a decreasing loss on it.
    Each shard is written to a temporary name and renamed into place.
    """
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, vocab_size + 1) ** zipf_exponent
    probs /= probs.sum()
    for i in range(n_shards):
        tokens = rng.choice(vocab_size, size=tokens_per_shard,
                            p=probs).astype(np.int32)
        tmp = os.path.join(path, f".tmp-shard-{i:05d}.npy")
        np.save(tmp, tokens)
        os.replace(tmp, os.path.join(path, f"shard-{i:05d}.npy"))
    man = Manifest(n_shards=n_shards, tokens_per_shard=tokens_per_shard,
                   vocab_size=vocab_size)
    with open(os.path.join(path, "manifest.json"), "w") as fh:
        json.dump(man.__dict__, fh)
    return man


class ShardStore:
    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, "manifest.json")) as fh:
            self.manifest = Manifest(**json.load(fh))
        self.reads = 0
        self.bytes_read = 0

    def read(self, shard_id: int) -> np.ndarray:
        if not 0 <= shard_id < self.manifest.n_shards:
            raise IndexError(shard_id)
        arr = np.load(os.path.join(self.path, f"shard-{shard_id:05d}.npy"))
        self.reads += 1
        self.bytes_read += arr.nbytes
        return arr
