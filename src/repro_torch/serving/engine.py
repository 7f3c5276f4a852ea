"""Continuous-batching serving engine over a DynIMS-managed KV pool.

The port of ``repro/serving/engine.py``.  The paper's architecture in
the serving path: device memory is the contended resource; the
*compute tenant* is the model's weights and activations, the *storage
tenant* the KV cache.  The :class:`~repro_torch.core.store.KVBlockPool`
bookkeeps block grants; a :class:`~repro_torch.core.plane.MemoryPlane`
(device monitor -> controller) resizes the pool each interval, and a
shrink preempts whole sequences, which the engine requeues with their
progress kept (tokens generated so far become part of the prompt on
re-admission).  The engine declares its pool to the plane at
construction and ticks it once per step, idle steps too; all
bus/controller wiring stays inside the plane.

Mechanics, as in JAX:

* fixed ``max_batch`` slots; one ``decode_step`` serves every mix of
  sequence progress (per-slot positions),
* admission: a request needs pool blocks for prompt + headroom; denied
  admission leaves it queued,
* each generated token may claim a new block (every ``block_tokens``);
  failure to claim -> self-preemption back to the queue,
* prompt ingestion streams through the same decode step.

Decoding is greedy.  The step runs eagerly (no ``torch.compile``).  The
plane ticks after the argmax has come back to the host, as in JAX.  The
cross-attention families' state holds their cross caches, which no
request fills: they stay zero, and the audio family's ``enc_len`` 0,
as in JAX's engine; a block's bytes count the self layers' K/V alone
(``_block_bytes``).  The ssm family holds no K/V, yet its pool is sized
by the same formula, as JAX's is: a notional pool that admission and
preemption still gate (ROADMAP C26); admission restores the slot's
recurrent state to its start (every m at -1e30).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.monitor import DeviceMemoryMonitor, MemoryMonitor
from ..core.plane import MemoryPlane, StoreSpec
from ..core.store import KVBlockPool
from ..device import DeviceLike, resolve_device
from ..models import decode as D
from ..models.transformer import Model


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                   # (len,) int32
    max_new_tokens: int
    output: List[int] = field(default_factory=list)
    preemptions: int = 0

    @property
    def done(self) -> bool:
        return len(self.output) >= self.max_new_tokens

    @property
    def tokens_so_far(self) -> np.ndarray:
        return np.concatenate([self.prompt,
                               np.asarray(self.output, np.int32)])


@dataclass
class ServingConfig:
    max_batch: int = 4
    max_len: int = 256
    block_tokens: int = 16
    cache_dtype: str = "bfloat16"


@dataclass
class _Slot:
    request: Optional[Request] = None
    ingested: int = 0                    # prompt tokens fed so far

    @property
    def free(self) -> bool:
        return self.request is None


class ServingEngine:
    """Serve ``model`` on ``device`` (the card unless asked otherwise).

    The model must already lie on that device.  With a ``plane`` the
    pool is attached to it as node ``node``, observed by ``monitor``
    (default: a :class:`DeviceMemoryMonitor` of the engine's device,
    with the pool's bytes as the storage tenant's).
    """

    def __init__(self, model: Model, cfg: ServingConfig,
                 pool: Optional[KVBlockPool] = None,
                 device: DeviceLike = None,
                 plane: Optional[MemoryPlane] = None,
                 node: str = "serve0",
                 monitor: Optional[MemoryMonitor] = None):
        dev = resolve_device(device)
        on = model.device
        if dev.type != on.type or (dev.index is not None
                                   and dev.index != on.index):
            raise ValueError(f"the model lies on {on}, the engine was asked "
                             f"to serve on {dev}")
        self.model = model
        self.cfg = cfg
        self.device = on
        n_blocks = cfg.max_batch * (cfg.max_len // cfg.block_tokens)
        self.pool = pool or KVBlockPool("kv-pool", n_blocks,
                                        self._block_bytes())
        self.plane = plane
        self.node = node
        if plane is not None:
            monitor = monitor or DeviceMemoryMonitor(
                on, node=node, storage_used_fn=self.pool.used)
            plane.attach(
                node, monitor,
                stores=(StoreSpec(self.pool, self.pool.total_blocks
                                  * self.pool.block_bytes),))
        self.queue: List[Request] = []
        self.finished: Dict[int, Request] = {}
        self.slots = [_Slot() for _ in range(cfg.max_batch)]
        self._rid = itertools.count()
        self.state = D.init_state(model, cfg.max_batch, cfg.max_len,
                                  cache_dtype=cfg.cache_dtype)
        self.steps = 0
        self.decode_steps = 0              # steps that ran the model
        self._finite = torch.ones((), dtype=torch.bool, device=on)

    def _block_bytes(self) -> float:
        cfg = self.model.cfg
        per_tok = 2 * cfg.n_kv_heads * cfg.head_dim * 2   # k+v bf16
        return float(self.cfg.block_tokens * per_tok * cfg.n_layers)

    # ---- client API ----------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int) -> int:
        rid = next(self._rid)
        self.queue.append(Request(rid, np.asarray(prompt, np.int32),
                                  max_new_tokens))
        return rid

    def run_until_drained(self, max_steps: int = 100_000
                          ) -> Dict[int, Request]:
        while self.queue or any(not s.free for s in self.slots):
            self.step()
            if self.steps >= max_steps:
                raise RuntimeError("serving engine did not drain")
        return self.finished

    # ---- engine step ------------------------------------------------------------
    def step(self) -> None:
        self.steps += 1
        self._handle_preemptions()
        self._admit()
        if not all(s.free for s in self.slots):
            tokens, feeding = self._next_tokens()
            logits = D.decode_step(self.model, self.state,
                                   torch.from_numpy(tokens).to(self.device))
            self.decode_steps += 1
            self._finite &= torch.isfinite(logits).all()
            self._consume(logits, feeding)
        # Idle steps tick too: a fully preempted engine depends on the
        # controller re-granting pool capacity to admit again.
        if self.plane is not None:
            self.plane.tick()

    # ---- internals -----------------------------------------------------------------
    def _handle_preemptions(self) -> None:
        for seq_id in self.pool.drain_preempted():
            slot = self.slots[seq_id]
            if slot.request is not None:
                slot.request.preemptions += 1
                self._release_slot(seq_id, requeue=True)

    def _admit(self) -> None:
        for i, slot in enumerate(self.slots):
            if not slot.free or not self.queue:
                continue
            req = self.queue[0]
            need = (len(req.tokens_so_far) // self.cfg.block_tokens) + 1
            if self.pool.num_free_blocks() < need:
                break                      # honor queue order (no starvation)
            for _ in range(need):
                if self.pool.alloc_block(i) is None:
                    raise RuntimeError("pool refused a block it reported "
                                       "free")
            self.queue.pop(0)
            slot.request = req
            slot.ingested = 0
            # Position and recurrent state back to their start
            # (``_reset_slot_state``); the cache is masked by position.
            self.state.reset_slot(i)

    def _next_tokens(self):
        """Pick the token each active slot feeds this step."""
        tokens = np.zeros((self.cfg.max_batch, 1), np.int64)
        feeding = {}
        for i, slot in enumerate(self.slots):
            if slot.free:
                continue
            seq = slot.request.tokens_so_far
            if slot.ingested < len(seq):
                tokens[i, 0] = seq[slot.ingested]
                feeding[i] = "prompt"
            else:
                feeding[i] = "generate"
                tokens[i, 0] = seq[-1]
        return tokens, feeding

    def _consume(self, logits: torch.Tensor, feeding) -> None:
        next_tok = logits[:, 0].argmax(dim=-1).cpu().numpy()
        for i, mode in feeding.items():
            slot = self.slots[i]
            req = slot.request
            self.pool.touch(i)
            slot.ingested += 1
            if mode == "prompt" and slot.ingested < len(req.tokens_so_far):
                continue
            # the argmax after the last prompt token is the first
            # generated token
            req.output.append(int(next_tok[i]))
            if slot.ingested % self.cfg.block_tokens == 0:
                if self.pool.alloc_block(i) is None:
                    req.preemptions += 1
                    self._release_slot(i, requeue=True)
                    continue
            if req.done or slot.ingested >= self.cfg.max_len - 1:
                self._release_slot(i, requeue=False)

    def _release_slot(self, i: int, requeue: bool) -> None:
        req = self.slots[i].request
        self.slots[i] = _Slot()
        self.pool.free_seq(i)
        if requeue and req is not None:
            self.queue.insert(0, req)
        elif req is not None:
            self.finished[req.rid] = req

    # ---- metrics ----------------------------------------------------------------
    def stats(self) -> dict:
        """Counters; ``logits_finite`` reads the device (one sync)."""
        return {
            "steps": self.steps,
            "decode_steps": self.decode_steps,
            "finished": len(self.finished),
            "queued": len(self.queue),
            "active": sum(not s.free for s in self.slots),
            "pool_free_blocks": self.pool.num_free_blocks(),
            "pool_capacity_bytes": self.pool.capacity(),
            "preemptions": sum(r.preemptions
                               for r in self.finished.values())
            + sum(r.preemptions for r in self.queue),
            "logits_finite": bool(self._finite),
        }
