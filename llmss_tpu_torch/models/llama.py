"""Llama family: GQA, rotary (half style), RMSNorm, SwiGLU
(counterpart: llmss_tpu/models/llama.py:21-113)."""

from __future__ import annotations

import torch

from llmss_tpu_torch.models.common import DecoderConfig
from llmss_tpu_torch.models.decoder import Params
from llmss_tpu_torch.ops.layers import LinearParams, NormParams
from llmss_tpu_torch.weights.loader import CheckpointShards


def config_from_hf(hf: dict, dtype: str = "bfloat16") -> DecoderConfig:
    """``DecoderConfig`` from a Llama ``config.json`` dict."""
    n_heads = hf["num_attention_heads"]
    head_dim = hf.get("head_dim") or hf["hidden_size"] // n_heads
    return DecoderConfig(
        model_type="llama",
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        n_layers=hf["num_hidden_layers"],
        n_heads=n_heads,
        n_kv_heads=hf.get("num_key_value_heads") or n_heads,
        head_dim=head_dim,
        intermediate_size=hf["intermediate_size"],
        max_position_embeddings=hf["max_position_embeddings"],
        activation=hf.get("hidden_act", "silu"),
        norm="rmsnorm",
        norm_eps=hf.get("rms_norm_eps", 1e-6),
        parallel_residual=False,
        mlp="swiglu",
        positions="rotary",
        rope_style="half",
        rotary_dim=head_dim,
        rope_theta=hf.get("rope_theta", 10000.0),
        attn_bias=bool(hf.get("attention_bias", False)),
        mlp_bias=False,
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
        dtype=dtype,
    )


def _stack(ckpt: CheckpointShards, names, transpose: bool) -> torch.Tensor:
    return torch.stack([
        ckpt.get(n).T.contiguous() if transpose else ckpt.get(n) for n in names
    ])


def load_params(ckpt: CheckpointShards, cfg: DecoderConfig) -> Params:
    """Stacked parameters in the decoder's layout. The torch ``nn.Linear``
    disk layout is ``[out, in]``: q/k keep it, the rest are transposed to
    ``[in, out]``. Biases are loaded where the checkpoint has them."""
    L, pre = cfg.n_layers, "model.layers"

    def lin(attr, key):
        names = [f"{pre}.{i}.{attr}" for i in range(L)]
        w = _stack(ckpt, [f"{n}.weight" for n in names],
                   transpose=key not in ("q", "k"))
        b = None
        if all(f"{n}.bias" in ckpt for n in names):
            b = _stack(ckpt, [f"{n}.bias" for n in names], transpose=False)
        return LinearParams(w, b)

    def norm(attr):
        return NormParams(
            _stack(ckpt, [f"{pre}.{i}.{attr}.weight" for i in range(L)], False),
            None,
        )

    blocks: Params = {
        "ln1": norm("input_layernorm"),
        "ln2": norm("post_attention_layernorm"),
        "q": lin("self_attn.q_proj", "q"),
        "k": lin("self_attn.k_proj", "k"),
        "v": lin("self_attn.v_proj", "v"),
        "o": lin("self_attn.o_proj", "o"),
        "gate": lin("mlp.gate_proj", "gate"),
        "up": lin("mlp.up_proj", "up"),
        "down": lin("mlp.down_proj", "down"),
    }
    params: Params = {
        "wte": ckpt.get("model.embed_tokens.weight"),
        "blocks": blocks,
        "ln_f": NormParams(ckpt.get("model.norm.weight"), None),
    }
    if not cfg.tie_word_embeddings:
        params["head"] = LinearParams(ckpt.get("lm_head.weight").T.contiguous(), None)
    return params
