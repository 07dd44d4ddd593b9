"""Device selection for the port's entry points.

The default device is ``cuda``. There is no fallback: asking for the GPU on
a machine without one raises, so no code path quietly runs on the CPU.
Tests pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; raises ``RuntimeError`` when the requested
    device is CUDA and no GPU is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "llmss_tpu_torch runs on a CUDA GPU by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
