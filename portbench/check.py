"""The comparisons that decide ``correct``, and their limits.

Serving: once the window has closed and the program's state is freed,
a sample of the requests the window completed, drawn from the seed and
holding the longest of them, goes through the plain reference once,
each prompt with its served tokens.  ``logit_rms`` compares the logits
the program's own ``decode_step`` calls produced at the served
positions (a sample of each row: the values at vocabulary ids drawn
from the seed, and the row's largest) with the reference's, against the
spread of the reference's logits at each position.
``logit_gap`` is the widest gap by which a served token's logit lies
below the reference's best at that position (greedy decoding serves the
best).  ``plane_gap`` replays the plane's recorded capacity decisions
through Eq. 1 in NumPy, and ``plane_law_gap`` those the law decides
before its clip (none where every decision is clipped, which fails).

Training: see :func:`train_numbers`.

Each cell's limits are in ``limits/<cell>.json``; a number with no limit
there fails, and ``plane_law_gap`` is compared where a limit names it.
"""

from __future__ import annotations

import json
import os
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import weights as W
from .reference import model as R
from .reference.plane import law_gap, replay_gap
from .traffic import seed_key

HERE = os.path.dirname(os.path.abspath(__file__))
Checks = Dict[str, Tuple[float, Optional[float]]]


def load_limits(cell: str) -> dict:
    path = os.path.join(HERE, "limits", cell + ".json")
    if not os.path.exists(path):
        return {}
    with open(path) as fh:
        return json.load(fh)


def judged(numbers: Dict[str, float], limits: dict) -> Checks:
    return {k: (v, limits.get(k)) for k, v in numbers.items()}


def passed(checks: Checks) -> bool:
    return all(lim is not None and np.isfinite(v) and v <= lim
               for v, lim in checks.values())


@contextmanager
def precision(tf32: bool):
    """Float32 products with TF32 on or off, restored after."""
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def sample(done: list, seed: int, k: int) -> list:
    """``k`` requests of ``done`` drawn from the seed, the longest first."""
    if not done:
        return []
    size = [len(r.req.prompt) + r.n_out for r in done]
    longest = int(np.argmax(size))
    rest = [i for i in range(len(done)) if i != longest]
    rng = np.random.default_rng([seed_key(seed), 3])
    pick = rng.choice(len(rest), min(k - 1, len(rest)), replace=False)
    return [done[longest]] + [done[rest[int(i)]] for i in sorted(pick)]


LOGIT_IDS = 32


def logit_ids(arch: dict, seed: int, device) -> torch.Tensor:
    """The vocabulary ids whose logits the check compares, from the seed."""
    rng = np.random.default_rng([seed_key(seed), 4])
    ids = rng.choice(int(arch["vocab_size"]), LOGIT_IDS, replace=False)
    return torch.as_tensor(np.sort(ids), dtype=torch.long, device=device)


def served_batch(reqs: list, device) -> tuple:
    """Each request's prompt and served tokens but the last, right-padded
    into one (B, S) batch, the rows whose logits chose the served tokens,
    and the served tokens."""
    seqs, rows, served = [], [], []
    for r in reqs:
        out = list(r.req.output)
        seqs.append(list(r.req.prompt) + out[:-1])
        start = len(r.req.prompt) - 1
        rows.append(range(start, start + len(out)))
        served.append(torch.tensor(out, device=device))
    s = max(len(q) for q in seqs)
    tokens = torch.zeros((len(seqs), s), dtype=torch.long, device=device)
    for i, q in enumerate(seqs):
        tokens[i, :len(q)] = torch.tensor(q, device=device)
    return tokens, rows, served


def reference_logits(cfg: dict, seed: int, reqs: list, device,
                     tf32: bool = False, cache_dtype: Optional[str] = None,
                     force=None, routes=None):
    """The reference's logits at the served positions of ``reqs``, the
    served tokens, and its routing record (``gap``: the largest by which
    a forced choice lies below the reference's k-th best; ``own``: its
    own choices, (L, B, S, k)).  ``force`` is the choices to follow, or
    ``routes`` (a :class:`~portbench.serve.StepLog`) gives the
    program's.  ``tf32`` and ``cache_dtype`` (the configuration's
    cache type by default) set the precision."""
    arch = cfg["arch"]
    tokens, rows, served = served_batch(reqs, device)
    if routes is not None:
        force = routes.routes(reqs, tokens.shape[1], arch["n_layers"],
                              arch["experts_per_token"])
    route = {"gap": 0.0, "own": [],
             "force": None if force is None else force.to(device)}
    kv = getattr(torch, cache_dtype or cfg["cache_dtype"])
    with torch.no_grad(), precision(tf32):
        logits = R.serve_logits(arch, W.block_drawer(arch, seed, device),
                                tokens, rows, kv, route)
    if route["own"]:
        route["own"] = torch.stack(route["own"])
    return logits, served, route


# The lower precisions a control computes in, in the program's place:
# TF32 products for the float32 weights with TF32 off (the control the
# limits are set against), and float8 (e4m3) for the bfloat16 cache.
CONTROLS = {"tf32": dict(tf32=True), "fp8": dict(cache_dtype="float8_e4m3fn")}


def logit_sample(ref: List[torch.Tensor], ids: torch.Tensor) -> tuple:
    """Each request's reference values at ``ids`` and its largest, as
    (n, len(ids) + 1), and the spread (standard deviation over the
    vocabulary) of its logits at each position."""
    vals, scale = [], []
    for l in ref:
        vals.append(torch.cat([l.index_select(-1, ids),
                               l.amax(-1, keepdim=True)], -1).float().cpu())
        scale.append(l.float().std(-1).cpu())
    return vals, scale


def logit_rms(got: List[torch.Tensor], ref: List[torch.Tensor],
              scale: List[torch.Tensor]) -> float:
    """The root mean square of the gaps between ``got`` and ``ref`` over
    that of the spreads of their positions' logits; infinite where a
    value was never produced (NaN)."""
    d = torch.cat([(g - r).reshape(-1) for g, r in zip(got, ref)])
    s = torch.cat([sc[:, None].expand_as(r).reshape(-1)
                   for sc, r in zip(scale, ref)])
    if not len(d) or not torch.isfinite(d).all():
        return float("inf")
    return float(d.pow(2).mean().sqrt() / s.pow(2).mean().sqrt())


def widest_gap(ref: List[torch.Tensor], chosen: List[torch.Tensor]) -> float:
    """The widest gap by which a chosen token's reference logit lies
    below the reference's best at its position."""
    if not ref:
        return float("inf")
    return float(max((l.max(-1).values - l.gather(-1, c[:, None])[:, 0]
                      ).max() for l, c in zip(ref, chosen)))


def altered(served: List[torch.Tensor], vocab: int) -> List[torch.Tensor]:
    """The served tokens with every other one moved to the next id, as
    the token fault of ``tests/test_portbench_contract.py`` alters them."""
    out = []
    for t in served:
        t = t.clone()
        t[::2] = (t[::2] + 1) % vocab
        out.append(t)
    return out


def serve(cfg: dict, mix: dict, seed: int, run, actions, total_memory,
          device, cell: str, control: bool = False, log=None) -> Checks:
    """The serving checks.  ``log`` (a :class:`~portbench.serve.StepLog`)
    holds the logits the program's ``decode_step`` calls produced and,
    for a moe model, its routing, which the reference follows and
    ``route_gap`` judges.  ``control`` adds the readings of each control
    of :data:`CONTROLS` (``control_<name>_*``): the reference in that
    precision in the program's place, its logits, its best token and
    its routing at each position judged the same way, and the gap of
    the served tokens altered as the token fault alters them
    (``fault_token_logit_gap``)."""
    limits = load_limits(cell)
    moe = cfg["arch"]["family"] == "moe"
    done = [r for r in run.recs if run.in_window(r.t_done) and r.n_out]
    reqs = sample(done, seed, mix["check_requests"])
    numbers = {}
    if reqs and log is not None:
        ids = log.ids.to(device)
        ref, served, route = reference_logits(cfg, seed, reqs, device,
                                              routes=log if moe else None)
        want, scale = logit_sample(ref, ids)
        got = log.values(reqs, max(len(r.req.prompt) + r.n_out
                                   for r in reqs))
        got = [got[b, list(rows)] for b, rows in
               enumerate(served_batch(reqs, "cpu")[1])]
        numbers["logit_rms"] = logit_rms(got, want, scale)
        numbers["logit_gap"] = widest_gap(ref, served)
        if control:
            numbers["fault_token_logit_gap"] = widest_gap(
                ref, altered(served, int(cfg["arch"]["vocab_size"])))
        if moe:
            numbers["route_gap"] = route["gap"]
        for name, kw in (CONTROLS.items() if control else ()):
            low, _, own = reference_logits(cfg, seed, reqs, device, **kw)
            judge, judge_scale = ref, scale
            if moe:
                judge, _, route = reference_logits(cfg, seed, reqs, device,
                                                   force=own["own"])
                numbers[f"control_{name}_route_gap"] = route["gap"]
                judge_scale = logit_sample(judge, ids)[1]
            numbers[f"control_{name}_logit_rms"] = logit_rms(
                logit_sample(low, ids)[0], logit_sample(judge, ids)[0],
                judge_scale)
            numbers[f"control_{name}_logit_gap"] = widest_gap(
                judge, [l.argmax(-1) for l in low])
    else:
        numbers.update(logit_rms=float("inf"), logit_gap=float("inf"))
    if total_memory is None:          # the CPU's monitor assumes a total
        total_memory = 16 * 2 ** 30
    decisions = [(a.u_prev, a.u_next, a.utilization) for a in actions]
    numbers["plane_gap"] = replay_gap(decisions, cfg["plane"], total_memory)
    if "plane_law_gap" in limits:
        numbers["plane_law_gap"] = law_gap(decisions, cfg["plane"],
                                           total_memory)
    return judged(numbers, limits)


def report(checks: Checks) -> dict:
    """The checks as the result line's last key carries them."""
    return {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}


def rows_ok(rows: list) -> int:
    """Rows at fault among the check steps' batches: a label that is not
    the next token, or a row that repeats another."""
    bad, seen = 0, set()
    for b in rows:
        tok, lab = np.asarray(b["tokens"]), np.asarray(b["labels"])
        bad += int(np.sum(np.any(lab[:, :-1] != tok[:, 1:], axis=1)))
        for r in tok:
            key = r.tobytes()
            bad += key in seen
            seen.add(key)
    return bad


def norm_gap(program: Dict[str, float], ref: Dict[str, float],
             keep=None) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, against the larger of that leaf's reference norm and
    the median leaf's."""
    names = [n for n in ref if keep is None or n in keep]
    med = float(np.median([ref[n] for n in names]))
    return max(abs(program[n] - ref[n]) / max(ref[n], med) for n in names)


def train_numbers(program: dict, reference: dict) -> Dict[str, float]:
    """``loss_gap``: the worst step's |loss - reference| over the
    reference; ``grad_gap``: :func:`norm_gap` of the first clipped
    gradients; ``update_gap``: of the change after the check steps, over
    the leaves whose reference gradient is at least a thousandth of the
    median leaf's (the others move by round-off alone)."""
    ref_first = reference["first"]
    med = float(np.median(list(ref_first.values())))
    moving = {n for n, g in ref_first.items() if g >= 1e-3 * med}
    loss_gap = max(abs(a - b) / abs(b) for a, b in
                   zip(program["loss"], reference["loss"]))
    return {"loss_gap": loss_gap,
            "grad_gap": norm_gap(program["first"], ref_first),
            "update_gap": norm_gap(program["change"], reference["change"],
                                   moving)}


def train_reference(cfg: dict, mix: dict, seed: int, rows: list, device,
                    tf32: bool = False, half: bool = False,
                    routes: Optional[list] = None) -> dict:
    """The reference's losses, first gradients and changes over the check
    steps' rows (``half``: the first half of each batch alone), following
    ``routes`` (each step's choices and kept pairs) when given; its
    ``gap`` (:func:`~portbench.reference.model.experts`) and ``own``
    routes (each step's choices) come with them."""
    from .reference.train import steps

    arch = cfg["arch"]
    params = {}
    for i in range(len(R.layout(arch))):
        params.update(W.draw_block(arch, seed, i, device))
    batches = []
    for b in rows:
        tok = torch.as_tensor(np.asarray(b["tokens"]), device=device)
        lab = torch.as_tensor(np.asarray(b["labels"]), device=device)
        if half:
            tok, lab = tok[:len(tok) // 2], lab[:len(lab) // 2]
        batches.append((tok, lab))
    record = [dict(r or {}, gap=0.0, own=[]) for r in
              (routes or [None] * len(batches))]
    with precision(tf32):
        losses, first = steps(arch, mix["optimizer"], mix["z_loss"], params,
                              batches, record)
    change = {}
    for i in range(len(R.layout(arch))):
        for n, p0 in W.draw_block(arch, seed, i, device).items():
            change[n] = float(torch.linalg.vector_norm(params[n] - p0))
    return {"loss": losses, "first": first, "change": change,
            "gap": max(r["gap"] for r in record),
            "own": [{"force": r["own"] or None} for r in record]}


def train(cfg: dict, mix: dict, seed: int, rows: list, program: dict,
          device, cell: str, control: bool = False,
          routes: Optional[list] = None) -> Checks:
    """The training checks; the reference follows the program's routing
    (``routes``) and ``route_gap`` judges it (a moe model).  ``control``
    adds the readings of the reference in TF32 (``control_*``: its own
    routing, followed by the float32 reference it is judged by) and over
    half of each batch (``half_*``), each in the program's place."""
    moe = cfg["arch"]["family"] == "moe"
    reference = train_reference(cfg, mix, seed, rows, device,
                                routes=routes if moe else None)
    numbers = train_numbers(program, reference)
    if moe:
        numbers["route_gap"] = reference["gap"]
    numbers["bad_rows"] = float(rows_ok(rows))
    if control:
        low = train_reference(cfg, mix, seed, rows, device, tf32=True)
        judge = reference
        if moe:
            judge = train_reference(cfg, mix, seed, rows, device,
                                    routes=low["own"])
            numbers["control_route_gap"] = judge["gap"]
        numbers.update({f"control_{k}": v
                        for k, v in train_numbers(low, judge).items()})
        half = train_reference(cfg, mix, seed, rows, device, half=True)
        numbers.update({f"half_{k}": v
                        for k, v in train_numbers(half, reference).items()})
    return judged(numbers, load_limits(cell))
