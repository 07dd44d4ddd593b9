"""Llama family: GQA, rotary (half style), RMSNorm, SwiGLU
(counterpart: llmss_tpu/models/llama.py:21-113)."""

from __future__ import annotations

from llmss_tpu_torch.models._loading import (
    lm_head, norm, stacked_linear, stacked_norm, table,
)
from llmss_tpu_torch.models.common import DecoderConfig
from llmss_tpu_torch.models.decoder import Params
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


def load_params(ckpt: CheckpointShards, cfg: DecoderConfig,
                overrides=None) -> Params:
    """Stacked parameters in the decoder's layout (q/k ``[L, out, in]``,
    the rest ``[L, in, out]``). Biases are loaded where every layer has
    them (Qwen2's q/k/v). ``overrides`` maps a block key ("q", "gate", ...)
    to a ``(ckpt, cfg) -> LinearParams`` loader: how a family with this
    structure but fused checkpoint tensors (Phi-3) reuses this loader."""
    L, pre = cfg.n_layers, "model.layers"

    def entry(attr, key):
        if overrides and key in overrides:
            return overrides[key](ckpt, cfg)
        return stacked_linear(ckpt, lambda i: f"{pre}.{i}.{attr}", L,
                              transpose=key not in ("q", "k"), key=key)

    def norm_of(attr):
        return stacked_norm(ckpt, lambda i: f"{pre}.{i}.{attr}", L, bias=False)

    blocks: Params = {
        "ln1": norm_of("input_layernorm"),
        "ln2": norm_of("post_attention_layernorm"),
        "q": entry("self_attn.q_proj", "q"),
        "k": entry("self_attn.k_proj", "k"),
        "v": entry("self_attn.v_proj", "v"),
        "o": entry("self_attn.o_proj", "o"),
        "gate": entry("mlp.gate_proj", "gate"),
        "up": entry("mlp.up_proj", "up"),
        "down": entry("mlp.down_proj", "down"),
    }
    params: Params = {
        "wte": table(ckpt, "model.embed_tokens.weight", "wte"),
        "blocks": blocks,
        "ln_f": norm(ckpt, "model.norm", bias=False),
    }
    if not cfg.tie_word_embeddings:
        params["head"] = lm_head(ckpt, "lm_head.weight")
    return params
