"""The plain references against the program's CPU path at smoke sizes.

The test imports both; the references import nothing of the program.
"""

import numpy as np
import pytest
import torch

from portbench import port, weights as W
from portbench.reference import model as R
from portbench.reference.train import rate
from portbench.tests import smoke

CPU = torch.device("cpu")


def _decode(model, tokens, max_len, cache_dtype):
    from repro_torch.models import decode as D

    state = D.init_state(model, tokens.shape[0], max_len, cache_dtype)
    with torch.no_grad():
        return torch.stack([D.decode_step(model, state, tokens[:, t:t + 1])
                            [:, 0] for t in range(tokens.shape[1])], 1)


@pytest.mark.parametrize("name", ["hymba-1.5b", "qwen2-moe-a2.7b"])
def test_serving_reference_matches_the_program_decode(name):
    cfg = smoke.config(name)
    arch = cfg["arch"]
    model = port.build_model(cfg, 2 ** 31 + 17, CPU)
    tokens = torch.randint(0, arch["vocab_size"], (3, 20),
                           generator=torch.Generator().manual_seed(1))
    got = _decode(model, tokens, 32, "bfloat16")
    with torch.no_grad():
        ref = R.serve_logits(arch, W.block_drawer(arch, 2 ** 31 + 17, CPU),
                             tokens, [range(20)] * 3, torch.bfloat16)
        full = R.serve_logits(arch, W.block_drawer(arch, 2 ** 31 + 17, CPU),
                              tokens, [range(20)] * 3, None)
    ref, full = torch.stack(ref), torch.stack(full)
    assert (got - ref).abs().max() < 1e-4
    # the cache's type shows: float32 K/V are another model
    assert (got - full).abs().max() > 1e-3
    # the hybrid's 20 positions pass its window of 8
    with torch.no_grad():
        fwd = model(tokens)
    assert (fwd - full).abs().max() < 1e-4


def test_training_reference_matches_the_program_loss_and_gradient():
    from repro_torch.train.step import model_params

    cfg = smoke.config("qwen2-moe-a2.7b-3l", capacity_factor=1.0)
    arch = cfg["arch"]
    seed = 23
    model = port.build_model(cfg, seed, CPU, remat="full")
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, arch["vocab_size"], (2, 64), generator=gen)
    labels = torch.randint(0, arch["vocab_size"], (2, 64), generator=gen)
    params = model_params(model)
    for p in model.parameters():
        p.requires_grad_(True)
    loss, _ = model.loss({"tokens": tokens, "labels": labels})
    grads = torch.autograd.grad(loss, list(model.parameters()))
    ref_w = {}
    for _, leaves in W.draw(arch, seed, CPU):
        ref_w.update({n: t.clone().requires_grad_(True)
                      for n, t in leaves.items()})
    ref = R.train_loss(arch, ref_w, tokens, labels, 1e-4)
    ref_g = torch.autograd.grad(ref, list(ref_w.values()))
    assert float(loss.detach()) == pytest.approx(float(ref.detach()), rel=1e-6)
    got = dict(zip(params, grads))
    for n, g in zip(ref_w, ref_g):
        assert torch.allclose(got[n], g, rtol=1e-4, atol=1e-7), n


def test_capacity_drops_pairs_as_grouped_capacity_says():
    arch = dict(smoke.config("qwen2-moe-a2.7b-3l")["arch"])
    arch.update(capacity_factor=0.05)            # cap = max(int(..), 4) = 4
    w = W.draw_block(arch, 5, 1, CPU)
    x = torch.randn(1, 64, arch["d_model"])
    kept, _ = R.experts(w, "layers.0.moe.", x, arch, capacity=True)
    every, _ = R.experts(w, "layers.0.moe.", x, arch, capacity=False)
    assert not torch.allclose(kept, every)
    arch.update(capacity_factor=1000.0)
    kept, _ = R.experts(w, "layers.0.moe.", x, arch, capacity=True)
    assert torch.allclose(kept, every)


def test_rate_is_the_programs_schedule():
    from repro_torch.optim.schedules import linear_warmup_cosine

    opt = dict(peak_lr=3e-4, warmup_steps=10, total_steps=100,
               final_frac=0.1)
    for step in (0, 3, 9, 10, 50, 99, 150):
        want = float(linear_warmup_cosine(step, peak_lr=3e-4,
                                          warmup_steps=10, total_steps=100))
        assert rate(opt, step) == pytest.approx(want, rel=1e-6)


def test_weights_are_the_same_draw_twice_and_differ_by_seed():
    arch = smoke.config("hymba-1.5b")["arch"]
    a = W.draw_block(arch, 9, 1, CPU)
    b = W.draw_block(arch, 9, 1, CPU)
    c = W.draw_block(arch, 10, 1, CPU)
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not any(torch.equal(a[n], c[n]) for n in a)
    norm = a["layers.0.norm"]
    assert abs(float(norm.mean()) - 1.0) < 0.1
    assert np.isclose(float(a["layers.0.mlp.wi"].std()),
                      arch["d_model"] ** -0.5, rtol=0.1)


PLANE = {"r0": 0.92, "lam": 0.8, "lam_grant": 0.3, "u_min": 0.0,
         "u_max": 14.6e9}


def _decide(u, util, total=80e9, lam_grant=0.3):
    v = util * total
    return min(u - lam_grant * v * (util - 0.92) / 0.92, PLANE["u_max"])


def test_plane_law_judges_the_decisions_before_the_clip():
    from portbench.reference.plane import law_gap, replay_gap

    # a growing pool (the law inside its bounds), then a clipped one
    grow = [(9.7e9, _decide(9.7e9, 0.83), 0.83),
            (11.7e9, _decide(11.7e9, 0.83), 0.83)]
    clipped = [(14.6e9, _decide(14.6e9, 0.23), 0.23)]
    assert replay_gap(grow + clipped, PLANE, 80e9) < 1e-12
    assert law_gap(grow + clipped, PLANE, 80e9) < 1e-12
    # a wrong grant gain: the clip hides it, the law does not
    wrong = [(u, _decide(u, x, lam_grant=0.35), x) for u, _, x in grow]
    assert law_gap(wrong, PLANE, 80e9) > 1e-3
    assert replay_gap([(14.6e9, _decide(14.6e9, 0.23, lam_grant=0.35),
                        0.23)], PLANE, 80e9) < 1e-12
    # no decision inside the bounds: nothing to judge the law by
    assert law_gap(clipped, PLANE, 80e9) == float("inf")
