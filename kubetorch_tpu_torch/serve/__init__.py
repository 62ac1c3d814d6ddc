"""Serving: the continuous-batching generation engine, weight quantization
for it, its int8 KV cache, speculative decoding (one request, and the
engine with a draft model), the session binder that keeps a session's
prompt resident as a cached prefix, the live weight rollout that swaps
published weights into a running engine, and the compile cache a replica
boots through (``aot_cache``); and the OpenAI-compatible
surface over an engine (``openai_api``, loaded on first use: its HTTP
shell needs aiohttp, which engine users never do)."""

from ..models.quant import (dequantize_params, llama_init_quantized,
                            quantize_params, quantize_params_int4,
                            quantized_bytes)
from .engine import EngineStats, GenerationEngine, RequestHandle
from .kv_quant import (QuantKVCache, dequantize_rows, init_quant_cache,
                       quantize_rows)
from .rollout import CanaryRollout, HostEngine, WeightRollout
from .sessions import EngineSessionBinder, SessionStats, session_key
from .spec_engine import SpeculativeEngine
from .speculative import SpecStats, speculative_generate

__all__ = ["EngineStats", "GenerationEngine", "RequestHandle",
           "CanaryRollout", "HostEngine", "WeightRollout",
           "EngineSessionBinder", "SessionStats", "session_key",
           "SpeculativeEngine", "SpecStats", "speculative_generate",
           "quantize_params", "quantize_params_int4", "llama_init_quantized",
           "dequantize_params", "quantized_bytes",
           "QuantKVCache", "init_quant_cache", "quantize_rows",
           "dequantize_rows", "OpenAIApp", "build_openai_app"]


def __getattr__(name):
    if name in ("OpenAIApp", "build_openai_app"):
        from .openai_api import OpenAIApp, build_app
        return {"OpenAIApp": OpenAIApp, "build_openai_app": build_app}[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
