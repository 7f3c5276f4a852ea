"""Input pipeline: deterministic sampling over a DynIMS-managed cache.

A copy of ``repro/data/pipeline.py``.  The paper's architecture
transplanted to a training job's input path: the shard store is the
backing tier (OrangeFS), the in-host-RAM
:class:`~repro_torch.core.store.ShardCache` is the Alluxio worker, and a
:class:`~repro_torch.core.plane.MemoryPlane` resizes it every interval
so the *training process* (the priority tenant: parameters, optimizer
moments, staging buffers) never hits memory pressure while the cache
soaks up the remaining host RAM.  The pipeline only declares its
store/monitor to the plane (``plane.attach``); it never touches bus or
controller internals.

Sampling is a deterministic function of (seed, step), numpy's
``default_rng((seed, step))`` as in JAX, so a batch is the same bytes in
both packages and a restart resumes exactly (no state files).  A
background prefetcher warms the cache ``prefetch_depth`` steps ahead.
Batches are numpy int32; :meth:`DataPipeline.to_device` moves one to
the device through a pinned host buffer.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..core.monitor import HostMemoryMonitor
from ..core.plane import MemoryPlane, StoreSpec
from ..core.store import ShardCache, StoreRegistry
from ..device import DeviceLike, resolve_device
from .shard_store import ShardStore


@dataclass(frozen=True)
class PipelineConfig:
    batch_size: int
    seq_len: int
    seed: int = 0
    cache_bytes: float = 256 * 2**20
    eviction: str = "lfu"
    prefetch_depth: int = 2
    dynims: bool = True          # attach the cache to a control plane


class DataPipeline:
    def __init__(self, store: ShardStore, cfg: PipelineConfig,
                 plane: Optional[MemoryPlane] = None,
                 node: str = "localhost"):
        self.store = store
        self.cfg = cfg
        self.cache = ShardCache("dataset-cache", capacity=cfg.cache_bytes,
                                policy=cfg.eviction, priority=0)
        self.plane = plane
        if plane is not None and cfg.dynims:
            self._registry = plane.attach(
                node,
                HostMemoryMonitor(node, storage_used_fn=self.cache.used),
                stores=(StoreSpec(self.cache, cfg.cache_bytes),),
                u0=cfg.cache_bytes)
        else:
            self._registry = StoreRegistry()
            self._registry.register(self.cache, max_bytes=cfg.cache_bytes)
        self._prefetch_q: "queue.Queue[int]" = queue.Queue(maxsize=64)
        self._stop = threading.Event()
        self._prefetcher: Optional[threading.Thread] = None
        # to_device's pinned buffers, and the copy each last fed
        self._pinned: Dict[str, torch.Tensor] = {}
        self._copied: Dict[str, torch.cuda.Event] = {}

    # ---- deterministic addressing -----------------------------------------
    def _plan(self, step: int) -> np.ndarray:
        """(batch, 2) array of (shard_id, offset) for one step."""
        man = self.store.manifest
        rng = np.random.default_rng((self.cfg.seed, step))
        per_shard = man.tokens_per_shard - self.cfg.seq_len - 1
        shards = rng.integers(0, man.n_shards, self.cfg.batch_size)
        offsets = rng.integers(0, max(per_shard, 1), self.cfg.batch_size)
        return np.stack([shards, offsets], axis=1)

    def _shard(self, shard_id: int) -> np.ndarray:
        return self.cache.get(int(shard_id),
                              loader=lambda: self.store.read(int(shard_id)))

    def batch(self, step: int) -> dict:
        """Deterministic batch for ``step`` (restart-safe)."""
        if self._prefetcher is None and self.cfg.prefetch_depth:
            self._start_prefetcher(step)
        plan = self._plan(step)
        for future_step in range(step + 1, step + 1 + self.cfg.prefetch_depth):
            for sid in np.unique(self._plan(future_step)[:, 0]):
                try:
                    self._prefetch_q.put_nowait(int(sid))
                except queue.Full:
                    break
        rows = []
        for sid, off in plan:
            shard = self._shard(sid)
            rows.append(shard[off: off + self.cfg.seq_len + 1])
        arr = np.stack(rows)
        return {"tokens": arr[:, :-1].astype(np.int32),
                "labels": arr[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1

    # ---- staging to the device -------------------------------------------
    def to_device(self, batch: dict,
                  device: DeviceLike = None) -> Dict[str, torch.Tensor]:
        """A batch's arrays as tensors on ``device`` (the card by default).

        On a card each array is copied into a pinned host buffer kept per
        key and sent with ``non_blocking=True``; a buffer is refilled only
        once its previous copy has finished.  On the CPU the tensors
        share the arrays' memory.
        """
        dev = resolve_device(device)
        if dev.type != "cuda":
            return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                    for k, v in batch.items()}
        out = {}
        for k, v in batch.items():
            buf = self._pinned.get(k)
            if buf is None or tuple(buf.shape) != v.shape \
                    or buf.numpy().dtype != v.dtype:
                buf = torch.from_numpy(np.empty_like(v)).pin_memory()
                self._pinned[k] = buf
            elif k in self._copied:
                self._copied[k].synchronize()
            buf.numpy()[...] = v
            out[k] = buf.to(dev, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
            self._copied[k] = event
        return out

    # ---- background prefetch -------------------------------------------------
    def _start_prefetcher(self, step0: int) -> None:
        def run():
            while not self._stop.is_set():
                try:
                    sid = self._prefetch_q.get(timeout=0.2)
                except queue.Empty:
                    continue
                if sid not in self.cache:
                    self._shard(sid)
        self._prefetcher = threading.Thread(target=run, daemon=True)
        self._prefetcher.start()

    def close(self) -> None:
        self._stop.set()
        if self._prefetcher is not None:
            self._prefetcher.join(timeout=2.0)
            self._prefetcher = None

    @property
    def hit_ratio(self) -> float:
        return self.cache.stats.hit_ratio
