"""Fault-tolerant trainer: step loop + DynIMS + checkpoint/restart.

A copy of ``repro/train/trainer.py``.  One object wires the stack:

* data: :class:`~repro_torch.data.pipeline.DataPipeline`, whose host
  shard cache is DynIMS-managed, its batches staged to the device
  through a pinned buffer,
* control: one :class:`~repro_torch.core.plane.MemoryPlane` ticked from
  the step loop every ``dynims_interval_steps`` (the step-synchronous
  tick keeps tests deterministic),
* checkpointing: :class:`~repro_torch.checkpoint.CheckpointManager`,
  restart via ``resume()`` -- the pipeline is sampled by step number, so
  restore is exact,
* runtime: heartbeats + straggler detection with the DynIMS squeeze
  escalation (runtime/straggler.py).

The loop syncs with the host only on log steps, where it reads the
metrics (JAX's ``float(np.asarray(v))``), and when it checkpoints.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..checkpoint import CheckpointManager
from ..core.plane import MemoryPlane
from ..data.pipeline import DataPipeline
from ..device import DeviceLike, resolve_device
from ..models.transformer import Model
from ..runtime.fault import HeartbeatMonitor
from ..runtime.straggler import StragglerDetector
from .step import (Params, TrainState, TrainStepConfig, bind_params,
                   build_train_step, init_train_state, model_params)


@dataclass
class TrainerConfig:
    steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: str = "/tmp/repro-ckpt"
    async_checkpoint: bool = False
    log_every: int = 10
    dynims_interval_steps: int = 1      # control ticks per step


class Trainer:
    """``device=None`` means the card, and raises without one; the model
    must lie on the trainer's device."""

    def __init__(self, model: Model, pipeline: DataPipeline,
                 step_cfg: TrainStepConfig, cfg: TrainerConfig,
                 plane: Optional[MemoryPlane] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"the model lies on {model.device}, the "
                             f"trainer runs on {self.device}")
        self.model = model
        self.pipeline = pipeline
        self.cfg = cfg
        self.step_cfg = step_cfg
        self.plane = plane
        self.ckpt = CheckpointManager(cfg.checkpoint_dir,
                                      async_save=cfg.async_checkpoint)
        self.heartbeats = HeartbeatMonitor()
        self.stragglers = StragglerDetector(
            squeeze_cb=self._squeeze_worker)
        self._step_fn = build_train_step(model, step_cfg)
        self.metrics_log: List[Dict[str, float]] = []
        # host clock (monotonic) after each log row's read of the metrics
        self.logged_at: List[float] = []
        self._squeezed: Dict[str, float] = {}

    # ---- DynIMS coupling ---------------------------------------------------
    def _squeeze_worker(self, worker: str, factor: float) -> None:
        """Straggler mitigation step 1: shrink that worker's cache."""
        self._squeezed[worker] = factor
        if self.plane is not None:
            self.plane.squeeze(worker, factor)

    # ---- main loop ------------------------------------------------------------
    def fit(self, params: Optional[Params] = None,
            state: Optional[TrainState] = None, start_step: int = 0):
        """Train from ``start_step`` to ``cfg.steps``; ``params`` defaults
        to the model's own.  Returns (params, state); the model holds the
        final parameters."""
        params = model_params(self.model) if params is None else params
        state = state or init_train_state(params, self.step_cfg)
        worker = "worker-0"
        self.heartbeats.register(worker)
        for step in range(start_step, self.cfg.steps):
            t0 = time.monotonic()
            batch = self.pipeline.to_device(self.pipeline.batch(step),
                                            self.device)
            params, state, metrics = self._step_fn(params, state, batch)
            if self.plane is not None and (
                    step % self.cfg.dynims_interval_steps == 0):
                self.plane.tick()
            dt = time.monotonic() - t0
            self.heartbeats.heartbeat(worker)
            self.stragglers.record(worker, dt)
            if step % self.cfg.log_every == 0 or step == self.cfg.steps - 1:
                row = {k: float(metrics[k]) for k in sorted(metrics)}
                self.logged_at.append(time.monotonic())
                row.update(step=step, wall_s=dt,
                           cache_hit=self.pipeline.hit_ratio)
                self.metrics_log.append(row)
            if (step + 1) % self.cfg.checkpoint_every == 0 \
                    or step == self.cfg.steps - 1:
                self.ckpt.save({"params": params, "opt": state.adam,
                                "step": step + 1}, step + 1)
        self.ckpt.wait()
        return params, state

    # ---- restart --------------------------------------------------------------
    def resume(self, params: Optional[Params] = None,
               state: Optional[TrainState] = None):
        """Restore the newest complete checkpoint and continue."""
        params = model_params(self.model) if params is None else params
        state = state or init_train_state(params, self.step_cfg)
        tree_like = {"params": params, "opt": state.adam, "step": 0}
        restored, step = self.ckpt.restore_latest(tree_like,
                                                  device=self.device)
        if restored is None:
            return self.fit(params, state, start_step=0)
        params = restored["params"]
        bind_params(self.model, params)
        state = TrainState(adam=restored["opt"],
                           compression=state.compression)
        return self.fit(params, state, start_step=int(restored["step"]))
