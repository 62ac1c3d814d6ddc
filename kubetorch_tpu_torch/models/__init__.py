"""Model families of the port: Llama, Mixtral-style MoE, LoRA adapters,
ViT, the MNIST-scale MLP and ResNet, under the JAX package's names
(``kubetorch_tpu/models``), and the Hugging Face checkpoint import/export
(``convert_hf``)."""

from .llama import LlamaConfig, llama_forward, llama_init, llama_loss
from .lora import LoraConfig, lora_init, lora_loss, merge_lora
from .mlp import MlpConfig, mlp_init, mlp_loss, mnist_train
from .moe import MoeConfig, moe_forward, moe_init, moe_loss
from .resnet import (BottleneckBlock, ResNet, ResNet18, ResNet50, ResNetBlock,
                     resnet_forward, resnet_init, resnet_loss)
from .vit import VitConfig, vit_forward, vit_init, vit_loss


def load_hf(path: str, device=None, **config_overrides):
    """HF checkpoint dir → ``(params, cfg)`` on ``device`` (see
    ``convert_hf.load_hf``)."""
    from .convert_hf import load_hf as _load
    return _load(path, device=device, **config_overrides)


def save_hf(params, cfg, path: str) -> None:
    """Our tree → a HF ``save_pretrained`` dir (the reverse trip)."""
    from .convert_hf import save_hf as _save
    return _save(params, cfg, path)


__all__ = ["LlamaConfig", "llama_init", "llama_forward", "llama_loss",
           "LoraConfig", "lora_init", "lora_loss", "merge_lora",
           "MoeConfig", "moe_init", "moe_forward", "moe_loss",
           "VitConfig", "vit_init", "vit_forward", "vit_loss",
           "MlpConfig", "mlp_init", "mlp_loss", "mnist_train",
           "ResNet", "ResNet18", "ResNet50", "ResNetBlock", "BottleneckBlock",
           "resnet_init", "resnet_forward", "resnet_loss", "load_hf",
           "save_hf"]
