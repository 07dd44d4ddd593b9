"""Qwen2 / Qwen2.5: the Llama block with q/k/v biases and no o or MLP
bias (counterpart: llmss_tpu/models/qwen2.py).

Loading is Llama's, whose bias detection finds the q/k/v biases. The
decoder applies one window to every layer, so of HF's per-layer sliding
window only the uniform cases load: every layer full
(``max_window_layers >= num_hidden_layers``, the shipped configs) or every
layer windowed (``max_window_layers == 0``); a mix raises.
"""

from __future__ import annotations

import dataclasses

from llmss_tpu_torch.models import llama
from llmss_tpu_torch.models.common import DecoderConfig


def config_from_hf(hf: dict, dtype: str = "bfloat16") -> DecoderConfig:
    cfg = llama.config_from_hf(hf, dtype=dtype)
    window = None
    if hf.get("use_sliding_window", False):
        n = hf["num_hidden_layers"]
        full_layers = hf.get("max_window_layers", 28)
        if full_layers == 0:
            window = hf.get("sliding_window")
        elif full_layers < n:
            raise NotImplementedError(
                "Qwen2 per-layer sliding-window mix "
                f"(max_window_layers={full_layers} of {n}) is not supported "
                "- the decoder applies one window uniformly")
    return dataclasses.replace(
        cfg, model_type="qwen2", attn_bias=True, attn_out_bias=False,
        sliding_window=window,
    )


load_params = llama.load_params
