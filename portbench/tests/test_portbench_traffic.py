"""The traffic generator: deterministic per seed, the same sizes in the
same order for every seed, the stated laws and the source's means."""

import itertools
from statistics import NormalDist

import numpy as np
import pytest

from portbench import traffic


def _take(mix, seed, n, clients=8):
    return list(itertools.islice(traffic.stream(mix, 1000, seed, clients), n))


def test_stream_is_deterministic_per_seed():
    mix = traffic.load_mix("chat")
    a, b = _take(mix, 2 ** 31 + 9, 300), _take(mix, 2 ** 31 + 9, 300)
    assert all(np.array_equal(x.prompt, y.prompt) and x.max_new == y.max_new
               for x, y in zip(a, b))
    c = _take(mix, 2 ** 31 + 10, 300)
    assert any(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, c))


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 3, -5])
def test_every_seed_serves_the_same_sizes(seed):
    mix = traffic.load_mix("chat")
    n = mix["pool"]
    draws = _take(mix, seed, 2 * n)[n:]          # the second cycle, whole
    got = sorted(zip((len(d.prompt) for d in draws),
                     (d.max_new for d in draws)))
    assert got == sorted(traffic.pool_sizes(mix))


def test_pool_follows_the_stated_laws():
    mix = traffic.load_mix("chat")
    sizes = np.array(traffic.pool_sizes(mix))
    assert (sizes.sum(1) <= mix["max_total"]).all()
    for col, law in ((0, mix["prompt"]), (1, mix["output"])):
        x = sizes[:, col]
        assert x.min() >= law["min"] and x.max() <= law["max"]
        assert abs(np.median(x) - law["median"]) <= 0.03 * law["median"]
        # the log-lengths' lower quartile (below the clips and the cut at
        # max_total, which take the longest) is the law's sigma
        z = np.log(x / law["median"])
        q = NormalDist().inv_cdf(0.25) * law["sigma"]
        assert abs(np.percentile(z, 25) - q) < 0.05
    # prompts and outputs are paired by a permutation, not sorted alike
    assert abs(np.corrcoef(sizes[:, 0], sizes[:, 1])[0, 1]) < 0.3


def test_pool_means_are_the_sources():
    """ShareGPT's means as vLLM served it (arXiv:2309.06180, Fig. 11):
    161.31 prompt and 337.99 output tokens."""
    sizes = np.array(traffic.pool_sizes(traffic.load_mix("chat")))
    assert abs(sizes[:, 0].mean() - 161.31) < 0.01 * 161.31
    assert abs(sizes[:, 1].mean() - 337.99) < 0.01 * 337.99


def test_every_seed_serves_the_same_order():
    mix = traffic.load_mix("chat")
    a, b = _take(mix, 11, 300), _take(mix, 2 ** 33 + 5, 300)
    assert [(len(x.prompt), x.max_new) for x in a] == [
        (len(y.prompt), y.max_new) for y in b]


@pytest.mark.parametrize("change", [{"loop": "open"}, {"decoding": "top_p"},
                                    {"prompt": {"dist": "exponential"}}])
def test_mixes_the_generator_does_not_implement_are_refused(change):
    mix = traffic.load_mix("chat")
    for k, v in change.items():
        mix[k] = dict(mix[k], **v) if isinstance(v, dict) else v
    with pytest.raises(ValueError):
        traffic.check_mix(mix)


def test_first_requests_stand_for_requests_under_way():
    mix = traffic.load_mix("chat")
    draws = _take(mix, 3, 40, clients=16)
    assert [d.first_wave for d in draws] == [True] * 16 + [False] * 24
    sizes = dict.fromkeys(traffic.pool_sizes(mix))
    later = [(len(d.prompt), d.max_new) for d in draws[16:]]
    assert all(s in sizes for s in later)
    assert all(len(d.prompt) >= 1 and d.max_new >= 1 for d in draws[:16])


def test_token_ids_are_uniform_over_the_vocabulary():
    mix = traffic.load_mix("chat")
    ids = np.concatenate([d.prompt for d in _take(mix, 5, 200)])
    assert ids.min() >= 0 and ids.max() < 1000
    counts = np.bincount(ids // 100, minlength=10)
    assert counts.min() > 0.8 * counts.mean()
