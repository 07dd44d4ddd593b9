"""Mistral: the Llama block with sliding-window attention
(counterpart: llmss_tpu/models/mistral.py).

The checkpoint's layout is Llama's, so loading is Llama's; the difference
is ``sliding_window``, which every attention path (plain versions and
kernels) masks. Default window: MistralConfig's 4096.
"""

from __future__ import annotations

import dataclasses

from llmss_tpu_torch.models import llama
from llmss_tpu_torch.models.common import DecoderConfig


def config_from_hf(hf: dict, dtype: str = "bfloat16") -> DecoderConfig:
    return dataclasses.replace(
        llama.config_from_hf(hf, dtype=dtype),
        model_type="mistral",
        sliding_window=hf.get("sliding_window", 4096),
    )


load_params = llama.load_params
