"""PyTorch/CUDA port of llmss_tpu for one NVIDIA H100.

The JAX package ``llmss_tpu`` is the reference this package is held
against; nothing here imports it (or JAX). Subpackages mirror the
reference's layout (``ops/``, ``models/``, ``engine/``, ``weights/``,
``serve/``, ``cli/``) so each module's counterpart is easy to find.

Entry points (``DecodeEngine``, ``init_params``, ``load_model``, the
``Worker`` and the CLI) run on the GPU unless the caller passes
``device="cpu"``; with no GPU present they raise instead of quietly
continuing on the CPU (``device.resolve_device``).
"""

from llmss_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
