"""Continuous-batching serving over a DynIMS-managed KV pool."""

from .engine import Request, ServingConfig, ServingEngine

__all__ = ["Request", "ServingConfig", "ServingEngine"]
