"""PyTorch/CUDA port of kubetorch_tpu's hot path, for NVIDIA Hopper (H100).

The JAX package ``kubetorch_tpu`` is the reference; this package mirrors its
layout (``models/``, ``ops/``, ``serve/``, ``train/``) so each module's
counterpart is found at the same path. It imports nothing from
``kubetorch_tpu`` and never imports ``jax``: what it needs from there it
keeps its own copy of.

Entry points (``llama_init``, ``generate``, ``GenerationEngine``,
``make_train_step``) run on ``cuda`` unless the caller passes
``device="cpu"``; with no card and no explicit CPU request they raise.
Every kernel the JAX package wrote in Pallas for this path is a
hand-written CUDA kernel here (``csrc/``), built with ``nvcc`` at first
use; each keeps a plain PyTorch version beside it, which runs only for CPU
tensors.
"""
