"""Serving: the continuous-batching generation engine."""

from .engine import EngineStats, GenerationEngine, RequestHandle

__all__ = ["EngineStats", "GenerationEngine", "RequestHandle"]
