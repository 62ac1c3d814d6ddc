"""Serving: the continuous-batching generation engine, weight quantization
for it and its int8 KV cache."""

from ..models.quant import (dequantize_params, llama_init_quantized,
                            quantize_params, quantize_params_int4,
                            quantized_bytes)
from .engine import EngineStats, GenerationEngine, RequestHandle
from .kv_quant import (QuantKVCache, dequantize_rows, init_quant_cache,
                       quantize_rows)

__all__ = ["EngineStats", "GenerationEngine", "RequestHandle",
           "quantize_params", "quantize_params_int4", "llama_init_quantized",
           "dequantize_params", "quantized_bytes",
           "QuantKVCache", "init_quant_cache", "quantize_rows",
           "dequantize_rows"]
