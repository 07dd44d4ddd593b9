"""Gemma (v1): the Llama layout with (1 + w) RMSNorm and scaled
embeddings (counterpart: llmss_tpu/models/gemma.py).

Loading is Llama's (the head is always tied). From the config:
``norm_scale_offset = 1`` (RMSNorm scaled by 1 + weight), hidden states
times sqrt(hidden_size) after the embedding, ``head_dim`` as given
(Gemma-7B: 16 heads of 256 over a hidden size of 3072), and the tanh GELU
unless ``hidden_activation`` names another: HF's GemmaMLP ignores
``hidden_act``, which old configs set to "gelu" while meaning the tanh
form.
"""

from __future__ import annotations

import dataclasses

from llmss_tpu_torch.models import llama
from llmss_tpu_torch.models.common import DecoderConfig


def config_from_hf(hf: dict, dtype: str = "bfloat16") -> DecoderConfig:
    return dataclasses.replace(
        llama.config_from_hf(hf, dtype=dtype),
        model_type="gemma",
        activation=hf.get("hidden_activation") or "gelu_pytorch_tanh",
        norm_scale_offset=1.0,
        embed_multiplier=float(hf["hidden_size"]) ** 0.5,
        tie_word_embeddings=True,
    )


load_params = llama.load_params
