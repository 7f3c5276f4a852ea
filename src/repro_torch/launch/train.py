"""Training entry point.

    python -m repro_torch.launch.train --arch llama3.2-1b --steps 50
    python -m repro_torch.launch.train --arch hymba-1.5b --steps 50
    python -m repro_torch.launch.train --arch xlstm-125m --steps 50
    python -m repro_torch.launch.train --arch dbrx-132b-smoke --device cpu
    python -m repro_torch.launch.train --arch llama3.2-1b-smoke --device cpu

Every architecture the port builds trains: llama3.2-1b, gemma3-1b and
qwen2-1.5b (dense), hymba-1.5b (hybrid), qwen2-moe-a2.7b (moe; its
60.6 GB of float32 weights leave no room for AdamW on one 80 GB card
at full depth), xlstm-125m (ssm: its sLSTM runs token by token, so a
step at a long sequence issues many small operations) and their
``-smoke`` reductions, with dbrx-132b's and mistral-large-123b's.  A moe model's rows log its load-balance loss,
``aux``, beside ``ce`` (``loss`` is their sum); a microbatched step
logs the summed loss as ``ce`` and a zero ``aux``, as JAX's step does.
The pipeline's batches hold tokens alone, as JAX's do: the vlm and
audio families (llama-3.2-vision-11b, whisper-large-v3), whose loss
needs images or frames, train through a caller that adds them to the
batches (``chip_smoke.py`` phase 21d).

The port of ``repro/launch/train.py``, with its flags and ``--device``.
Wires: config -> Model (weights from ``--seed``) -> DataPipeline (a
synthetic Zipf corpus in the temp directory, its host shard cache under
a live :class:`~repro_torch.core.plane.MemoryPlane` with
``host_cache_params(64 GiB)``) -> train step -> Trainer (checkpoint and
restart, heartbeats, stragglers).  Prints ``arch=... params=...`` and
one row of metrics per log step.  Without ``--device`` it runs on the
card and raises when there is none.  ``--compress`` runs the int8
error-feedback compression on the gradients: the numerical core alone.
The pod-axis all-reduce it would feed runs in no program of the port;
the dry-run (``repro_torch.launch.dryrun``) counts it, as JAX's
compiled multi-pod program holds it.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence

from ..configs import get_config
from ..configs.dynims import host_cache_params
from ..core.control import GiB
from ..core.plane import MemoryPlane, PlaneSpec
from ..data import DataPipeline, PipelineConfig, ShardStore, write_corpus
from ..device import resolve_device
from ..models import Model
from ..train import Trainer, TrainerConfig, TrainStepConfig


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", default="llama3.2-1b-smoke")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--data-dir", default="")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def build(args: argparse.Namespace, *, model: Optional[Model] = None,
          **trainer_fields) -> Trainer:
    """The CLI's wiring from parsed flags: the model (drawn from
    ``--seed``, unless ``model`` is given), the corpus, the plane, the
    pipeline and the trainer; ``trainer_fields`` override
    :class:`TrainerConfig` fields.  The trainer holds the pipeline
    (``.pipeline``, to be closed) and the plane (``.plane``)."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if model is None:
        model = Model(cfg, seed=args.seed, device=device)

    data_dir = args.data_dir or os.path.join(
        tempfile.gettempdir(), f"repro-torch-corpus-{cfg.name}")
    if not os.path.exists(os.path.join(data_dir, "manifest.json")):
        write_corpus(data_dir, n_shards=32,
                     tokens_per_shard=max(args.seq_len * 16, 4096),
                     vocab_size=cfg.vocab_size, seed=args.seed)

    plane = MemoryPlane(PlaneSpec(params=host_cache_params(64 * GiB),
                                  device=device))
    pipe = DataPipeline(
        ShardStore(data_dir),
        PipelineConfig(batch_size=args.batch_size, seq_len=args.seq_len,
                       seed=args.seed, cache_bytes=64 * 2**20),
        plane=plane)

    ckpt_dir = args.checkpoint_dir or os.path.join(
        tempfile.gettempdir(), f"repro-torch-ckpt-{cfg.name}")
    fields = dict(steps=args.steps, checkpoint_dir=ckpt_dir,
                  checkpoint_every=args.checkpoint_every)
    fields.update(trainer_fields)
    return Trainer(
        model, pipe,
        TrainStepConfig(microbatches=args.microbatches, peak_lr=args.lr,
                        warmup_steps=max(args.steps // 10, 1),
                        total_steps=args.steps, compress=args.compress),
        TrainerConfig(**fields), plane=plane, device=device)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    trainer = build(args)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    print(f"arch={trainer.model.cfg.name} params={n_params:,}")
    if args.resume:
        trainer.resume()
    else:
        trainer.fit()
    for row in trainer.metrics_log:
        print({k: round(v, 4) if isinstance(v, float) else v
               for k, v in row.items()})
    trainer.pipeline.close()


if __name__ == "__main__":
    main()
