"""The traffic generator: one general reader of the mixes' data files.

A serving mix (``kind: serve``) is a closed loop (``loop: closed``), one
client per slot: each client sends its next request when its last one
completes, and decoding is greedy.  The sizes of a mix are fixed by its
file: a pool of ``pool`` (prompt, output) lengths at stratified
quantiles of their lognormal laws (``dist: lognormal``), the outputs'
quantiles paired with the prompts' by a permutation drawn from
``size_seed``, an output cut where prompt and output would pass
``max_total``.  The order in which the clients send them is drawn from
``size_seed`` too, so every run serves the same sizes in the same order
and does the same work; a run's seed draws the token ids (and the
weights).

The first request of each client stands for one already under way: it
is cut by a stratified share of its length, so the slots start out of
step and the loop is near its steady state from the first step.  Those
first requests are marked; their latencies are not the mix's.

A training mix (``kind: train``) is read as it is by the training
runner (batch, sequence length, optimizer, corpus).

A value the generator does not implement (another loop, law or
decoding) is refused when the mix is loaded, not run as this one.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from statistics import NormalDist
from typing import Iterator, List, Tuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


IMPLEMENTED = {"loop": ("closed",), "decoding": ("greedy",)}


def load_mix(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", name + ".json")) as fh:
        mix = json.load(fh)
    check_mix(mix)
    return mix


def check_mix(mix: dict) -> None:
    """Raise where a serving mix asks for what the generator does not do."""
    if mix["kind"] != "serve":
        return
    for key, ok in IMPLEMENTED.items():
        if mix[key] not in ok:
            raise ValueError(f"mix {mix['name']}: {key} {mix[key]!r} is not "
                             f"implemented (only {ok})")
    for law in ("prompt", "output"):
        if mix[law]["dist"] != "lognormal":
            raise ValueError(f"mix {mix['name']}: {law} law "
                             f"{mix[law]['dist']!r} is not implemented")


def seed_key(seed: int) -> int:
    """Any whole number as a non-negative generator key."""
    return int(seed) % (1 << 64)


def lognormal_quantiles(law: dict, u: np.ndarray) -> np.ndarray:
    """Lengths at quantiles ``u`` of a clipped lognormal law."""
    z = np.array([NormalDist().inv_cdf(float(x)) for x in u])
    lengths = np.rint(law["median"] * np.exp(law["sigma"] * z))
    return np.clip(lengths, law["min"], law["max"]).astype(np.int64)


def pool_sizes(mix: dict) -> List[Tuple[int, int]]:
    """The mix's (prompt, output) lengths, the same for every run seed."""
    n = int(mix["pool"])
    u = (np.arange(n) + 0.5) / n
    prompts = lognormal_quantiles(mix["prompt"], u)
    pair = np.random.default_rng(mix["size_seed"]).permutation(n)
    outputs = lognormal_quantiles(mix["output"], u[pair])
    outputs = np.maximum(np.minimum(outputs, mix["max_total"] - prompts), 1)
    return list(zip(prompts.tolist(), outputs.tolist()))


@dataclass
class Draw:
    prompt: np.ndarray          # int32 token ids
    max_new: int
    first_wave: bool


def stream(mix: dict, vocab: int, seed: int, clients: int) -> Iterator[Draw]:
    """The requests of a run in the order clients send them."""
    sizes = pool_sizes(mix)
    n = len(sizes)
    rng = np.random.default_rng([seed_key(seed), 1])
    shares = (np.random.default_rng([mix["size_seed"], 1]).permutation(
        clients) + 0.5) / clients
    k, cycle = 0, 0
    while True:
        order = np.random.default_rng([mix["size_seed"], 2, cycle]
                                      ).permutation(n)
        for j in order:
            p, o = sizes[int(j)]
            tokens = rng.integers(0, vocab, p, dtype=np.int64)
            if k < clients:                     # a request under way
                skip = int(shares[k] * (p + o))
                keep_p = max(p - skip, 1)
                o = max(o - max(skip - p + 1, 0), 1)
                tokens = tokens[p - keep_p:]
            yield Draw(tokens.astype(np.int32), int(o), k < clients)
            k += 1
        cycle += 1
