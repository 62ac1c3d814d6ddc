"""Model families of the port: Llama, Mixtral-style MoE and LoRA adapters,
under the JAX package's names (``kubetorch_tpu/models``)."""

from .llama import LlamaConfig, llama_forward, llama_init, llama_loss
from .lora import LoraConfig, lora_init, lora_loss, merge_lora
from .moe import MoeConfig, moe_forward, moe_init, moe_loss

__all__ = ["LlamaConfig", "llama_init", "llama_forward", "llama_loss",
           "LoraConfig", "lora_init", "lora_loss", "merge_lora",
           "MoeConfig", "moe_init", "moe_forward", "moe_loss"]
