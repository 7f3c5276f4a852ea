"""The training runner: the port's trainer step beside the plane's cache.

The trainer is wired by ``repro_torch.launch.train.build`` (the Zipf
corpus written into the run's temporary directory, the pipeline's
shard cache under a live ``MemoryPlane`` with ``host_cache_params``,
the train step, the trainer), handed the model with the benchmark's
seeded weights.  The window drives the body of ``Trainer.fit``'s loop
itself: the pipeline's batch for the step, staged to the device, the
trainer's step function, one plane tick.  ``fit`` is not called: it
writes a checkpoint at its last step, and this cell has none.

Set-up runs the first ``check_steps`` steps through that same body on
the pipeline's rows and keeps what the check needs: each step's rows
and loss, each leaf's first clipped gradient as the optimizer got it
(from its first moment after one step), and each leaf's change after
the last of them (against the weights drawn again).  The window then
carries on with the same objects.
"""

from __future__ import annotations

import argparse
import gc
import shutil
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from . import check, trace as T, weights as W
from .port import build_model
from .reference.model import layout
from .spans import Spans
from .traffic import seed_key


@dataclass
class TrainRun:
    kind: str = "train"
    arch: dict = field(default_factory=dict)
    on_card: bool = False
    setup_s: float = 0.0
    window_s: float = 0.0
    steps: int = 0
    tokens: int = 0
    losses: List[float] = field(default_factory=list)
    peak_window_bytes: int = 0
    peak_bytes: int = 0
    spans: Optional[Spans] = None
    trace: Optional[T.Trace] = None
    profiled_steps: int = 0
    batch: int = 0
    seq_len: int = 0
    longest_step_s: float = 0.0     # the longest gap between two step issues
    alloc_retries: int = 0          # the allocator's retries in the window


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_trainer(cfg: dict, mix: dict, seed: int, device: torch.device,
                  workdir: str):
    from repro_torch.launch.train import build

    opt = mix["optimizer"]
    args = argparse.Namespace(
        arch=cfg["port_arch"], steps=opt["total_steps"],
        batch_size=mix["batch"], seq_len=mix["seq_len"],
        microbatches=mix["microbatches"], lr=opt["peak_lr"], compress=False,
        checkpoint_dir=workdir + "/ckpt", checkpoint_every=10 ** 9,
        data_dir=workdir + "/corpus", resume=False, seed=seed_key(seed),
        device=str(device))
    model = build_model(cfg, seed, device, remat=mix["remat"])
    trainer = build(args, model=model, log_every=10 ** 9)
    man = trainer.pipeline.store.manifest
    corpus = mix["corpus"]
    if (man.vocab_size, man.n_shards, man.tokens_per_shard) != (
            cfg["arch"]["vocab_size"], corpus["n_shards"],
            corpus["tokens_per_shard"]):
        raise RuntimeError(f"the corpus is not the mix's: {man}")
    sc = trainer.step_cfg
    stated = (opt["peak_lr"], opt["warmup_steps"], opt["total_steps"],
              opt["weight_decay"], opt["b1"], opt["b2"], opt["clip_norm"])
    if (sc.peak_lr, sc.warmup_steps, sc.total_steps, sc.weight_decay, sc.b1,
            sc.b2, sc.clip_norm) != stated or sc.microbatches != mix[
            "microbatches"]:
        raise RuntimeError(f"the trainer's step is not the mix's: {sc}")
    return trainer


def _retries(device: torch.device) -> int:
    if device.type != "cuda":
        return 0
    return int(torch.cuda.memory_stats(device).get("num_alloc_retries", 0))


class Loop:
    """The body of ``Trainer.fit``'s loop over the trainer's objects."""

    def __init__(self, trainer, device: torch.device):
        from repro_torch.train.step import init_train_state, model_params

        self.trainer, self.device = trainer, device
        self.params = model_params(trainer.model)
        self.state = init_train_state(self.params, trainer.step_cfg)
        self.step_fn = trainer._step_fn
        self.n = 0

    def step(self, spans: Optional[Spans] = None, keep: Optional[list] = None):
        pipe = self.trainer.pipeline
        spans = spans or Spans()
        with spans.span("pb.data"):
            host = pipe.batch(self.n)
            batch = pipe.to_device(host, self.device)
        if keep is not None:
            keep.append(host)
        with spans.span("pb.step"):
            self.params, self.state, metrics = self.step_fn(
                self.params, self.state, batch)
        with spans.span("pb.plane_tick"):
            self.trainer.plane.tick()
        self.n += 1
        return metrics


class _routing:
    """The program's routing over the check steps: its ``ROUTE_HOOK``
    sees every ``moe_apply``, the forward's layers first and then their
    recomputation in the backward; :meth:`step` returns the forward's,
    each layer's experts and kept pairs, for the reference to follow."""

    def __init__(self, layers: int):
        self.layers, self.calls = layers, []

    def __enter__(self):
        import repro_torch.models.moe as M

        self.M = M
        M.ROUTE_HOOK = lambda experts, keep: self.calls.append(
            (experts, keep))
        return self

    def __exit__(self, *exc):
        self.M.ROUTE_HOOK = None
        return False

    def step(self) -> dict:
        calls, self.calls = self.calls[:self.layers], []
        return {"force": [e for e, _ in calls] or None,
                "keep": [k for _, k in calls] or None}


def _first_grad_norms(state, b1: float) -> Dict[str, torch.Tensor]:
    """Each leaf's clipped gradient of the first step, read from the
    first moment after it: mu = (1 - b1) g."""
    return {n: torch.linalg.vector_norm(mu) / (1 - b1)
            for n, mu in state.adam.mu.items()}


def _change_norms(arch: dict, seed: int, params: dict,
                  device: torch.device) -> Dict[str, torch.Tensor]:
    """Each leaf's change from the drawn weights, a block at a time."""
    out = {}
    for i in range(len(layout(arch))):
        for n, p0 in W.draw_block(arch, seed, i, device).items():
            out[n] = torch.linalg.vector_norm(params[n] - p0)
    return out


def run(cfg: dict, mix: dict, seed: int, seconds: float, traced: bool,
        device: torch.device, t_start: float, cell: str,
        fault=None, control: bool = False, wraps=()) -> tuple:
    """One run of a training cell: (TrainRun, checks).  ``wraps``: the
    calls a traced run times (:meth:`Spans.install`); ``fault``, for
    the tests, is called with the loop before the first step."""
    out = TrainRun(arch=cfg["arch"], on_card=device.type == "cuda",
                   batch=mix["batch"], seq_len=mix["seq_len"])
    arch, opt = cfg["arch"], mix["optimizer"]
    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        trainer = build_trainer(cfg, mix, seed, device, workdir)
        loop = Loop(trainer, device)
        if fault is not None:
            fault(loop)
        rows, losses, routes = [], [], []
        with _routing(arch["n_layers"]) as record:
            for k in range(mix["check_steps"]):
                losses.append(loop.step(keep=rows)["loss"])
                routes.append(record.step())
                if k == 0:
                    first = _first_grad_norms(loop.state, opt["b1"])
        change = _change_norms(arch, seed, loop.params, device)
        program = {"loss": torch.stack(losses).tolist(),
                   "first": {n: float(v) for n, v in first.items()},
                   "change": {n: float(v) for n, v in change.items()}}
        del first, change
        _sync(device)
        if device.type == "cuda":
            out.peak_bytes = torch.cuda.max_memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        spans = None
        if traced:
            spans = out.spans = Spans()
            spans.install(wraps, {"plane": loop.trainer.plane},
                          out.on_card)
            spans.on = True
        window_losses = []
        gc.collect()
        gc.freeze()    # set-up's objects are not scanned in the window
        t0 = time.perf_counter()
        out.setup_s = t0 - t_start
        retries = _retries(device)
        last = t0
        while last - t0 < seconds:
            window_losses.append(loop.step(spans)["loss"])
            out.steps += 1
            now = time.perf_counter()
            out.longest_step_s = max(out.longest_step_s, now - last)
            last = now
        _sync(device)
        out.alloc_retries = _retries(device) - retries
        out.window_s = time.perf_counter() - t0
        out.tokens = out.steps * mix["batch"] * mix["seq_len"]
        out.losses = [float(x) for x in window_losses]
        if traced:
            spans.on = False
            spans.profiling = True
            with T.profiler(device) as prof:
                for _ in range(mix["profile_steps"]):
                    loop.step(spans)
                _sync(device)
            spans.profiling = False
            out.profiled_steps = mix["profile_steps"]
            out.trace = T.read(prof)
            spans.restore()
        if device.type == "cuda":
            out.peak_window_bytes = torch.cuda.max_memory_allocated(device)
            out.peak_bytes = max(out.peak_bytes, out.peak_window_bytes)
        trainer.pipeline.close()
        del loop, trainer
        gc.unfreeze()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        checks = check.train(cfg, mix, seed, rows, program, device, cell,
                             control, routes)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return out, checks


def attempted_failed(run: TrainRun) -> tuple:
    """Steps in the window, and those whose loss is not finite."""
    return run.steps, int(np.sum(~np.isfinite(np.asarray(run.losses))))
