"""On the card: the control (the plain reference computed in TF32, the
precision below the configurations' float32, in the program's place)
reads ``correct`` false against each cell's limits, and the program at
the same size reads it true.  The serving cells at their own widths and
depth with fewer slots and positions, the training cell with fewer
layers, so a test run holds them; PERF.md has the readings at the
cells' own size."""

import copy
import time

import pytest

from portbench import check, serve, train
from portbench.port import load_config
from portbench.traffic import load_mix


def _serve_cfg(name):
    cfg = copy.deepcopy(load_config(name))
    cfg["serve"].update(max_batch=16, max_len=256)
    return cfg


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hymba-1.5b", "qwen2-moe-a2.7b"])
def test_serving_control_reads_incorrect(card, name):
    cfg, mix = _serve_cfg(name), copy.deepcopy(load_mix("chat"))
    mix["prompt"].update(median=40, max=160)
    mix["output"].update(median=60, max=200)
    mix.update(max_total=250, warmup_steps=8, check_requests=6)
    cell = f"{name}.chat"
    limits = check.load_limits(cell)
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        _, checks = serve.run(cfg, mix, seed, 6.0, False, card,
                              time.perf_counter(), cell, control=True)
        assert all(v <= limits[k] for k, (v, _) in checks.items()
                   if k in limits), checks
        assert any(checks["control_tf32_" + k][0] > limits[k]
                   for k in limits if "control_tf32_" + k in checks), checks


@pytest.mark.cuda
def test_training_control_reads_incorrect(card):
    cfg = copy.deepcopy(load_config("qwen2-moe-a2.7b-3l"))
    cfg["arch"]["n_layers"] = 1
    mix = copy.deepcopy(load_mix("train-4k"))
    mix.update(seq_len=1024, check_steps=3)
    mix["corpus"].update(tokens_per_shard=16384)
    cell = "qwen2-moe-a2.7b.train-4k"
    limits = check.load_limits(cell)
    for seed in (2 ** 31 + 201, 2 ** 31 + 202, 2 ** 31 + 203):
        _, checks = train.run(cfg, mix, seed, 0.0, False, card,
                              time.perf_counter(), cell, control=True)
        sound = {k: v for k, (v, _) in checks.items() if k in limits}
        assert all(v <= limits[k] for k, v in sound.items()), sound
        for tag in ("control", "half"):
            assert any(checks[f"{tag}_{k}"][0] > limits[k]
                       for k in ("loss_gap", "grad_gap", "update_gap")), tag
