"""Data substrate of the port: shard store, DynIMS-managed cache, pipeline.

Copies of ``repro/data``.
"""

from .pipeline import DataPipeline, PipelineConfig
from .shard_store import ShardStore, write_corpus

__all__ = ["DataPipeline", "PipelineConfig", "ShardStore", "write_corpus"]
