"""Model registry keyed by HF ``config.model_type``
(counterpart: llmss_tpu/models/registry.py).

This port loads the llama family; the reference's other families (gptj,
gpt_bigcode, gpt2, mistral, qwen2, gpt_neox, phi3, gemma) are queued in
ROADMAP.md.
"""

from __future__ import annotations

from pathlib import Path

from llmss_tpu_torch.device import resolve_device
from llmss_tpu_torch.models import llama
from llmss_tpu_torch.models.common import DecoderConfig
from llmss_tpu_torch.models.decoder import Params
from llmss_tpu_torch.weights.loader import CheckpointShards, read_config, weight_files

MODEL_REGISTRY = {"llama": llama}


def config_from_hf(hf: dict, dtype: str = "bfloat16") -> DecoderConfig:
    mt = hf.get("model_type")
    if mt not in MODEL_REGISTRY:
        raise KeyError(
            f"model_type {mt!r} is not ported yet; have {sorted(MODEL_REGISTRY)}"
        )
    return MODEL_REGISTRY[mt].config_from_hf(hf, dtype=dtype)


def load_model(
    model_path: str | Path, device=None, dtype: str = "bfloat16",
) -> tuple[DecoderConfig, Params]:
    """Config and parameters of a local checkpoint directory, on ``device``
    (default: the GPU; raises without one)."""
    dev = resolve_device(device)
    cfg = config_from_hf(read_config(model_path), dtype=dtype)
    with CheckpointShards(
        weight_files(model_path), dtype=cfg.torch_dtype, device=dev
    ) as ckpt:
        params = MODEL_REGISTRY[cfg.model_type].load_params(ckpt, cfg)
    return cfg, params
