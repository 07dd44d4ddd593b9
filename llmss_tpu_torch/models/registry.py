"""Model registry keyed by HF ``config.model_type``
(counterpart: llmss_tpu/models/registry.py).

The reference's nine families: GPT-J, GPT-BigCode (StarCoder), GPT-2,
Llama, Mistral, Qwen2, GPT-NeoX (Pythia), Phi-3 and Gemma. ``config.json``
is read as a dict (no ``transformers``), and keys a config leaves out take
the HF config class's defaults.
"""

from __future__ import annotations

from pathlib import Path

from llmss_tpu_torch.device import resolve_device
from llmss_tpu_torch.models import (
    gemma, gpt2, gpt_bigcode, gpt_neox, gptj, llama, mistral, phi3, qwen2,
)
from llmss_tpu_torch.models.common import DecoderConfig
from llmss_tpu_torch.models.decoder import Params
from llmss_tpu_torch.weights.loader import CheckpointShards, read_config, weight_files

MODEL_REGISTRY = {
    "gptj": gptj,
    "gpt_bigcode": gpt_bigcode,
    "gpt2": gpt2,
    "llama": llama,
    "mistral": mistral,
    "qwen2": qwen2,
    "gpt_neox": gpt_neox,
    "phi3": phi3,
    "gemma": gemma,
}


def config_from_hf(hf: dict, dtype: str = "bfloat16") -> DecoderConfig:
    mt = hf.get("model_type")
    if mt not in MODEL_REGISTRY:
        raise KeyError(
            f"model_type {mt!r} not supported; have {sorted(MODEL_REGISTRY)}"
        )
    return MODEL_REGISTRY[mt].config_from_hf(hf, dtype=dtype)


def load_model(
    model_path: str | Path, device=None, dtype: str = "bfloat16", *,
    mesh=None,
) -> tuple[DecoderConfig, Params]:
    """Config and parameters of a local checkpoint directory, on ``device``
    (default: the GPU, or the mesh's device; raises without one). On a
    ``mesh`` (parallel/mesh.py; a ``Mesh.local`` view is enough) the rank
    reads only its own slices: ``shard_params`` of the whole load."""
    from llmss_tpu_torch.parallel.sharding import check_tp, param_specs

    dev = resolve_device(mesh.device if device is None and mesh is not None
                         else device)
    cfg = config_from_hf(read_config(model_path), dtype=dtype)
    with CheckpointShards(
        weight_files(model_path), dtype=cfg.torch_dtype, device=dev
    ) as ckpt:
        if mesh is not None:
            tp = mesh.shape["tp"]
            check_tp(cfg, tp)
            ckpt.set_shard(param_specs(cfg, tp), tp, mesh.coord("tp"))
        params = MODEL_REGISTRY[cfg.model_type].load_params(ckpt, cfg)
    return cfg, params
