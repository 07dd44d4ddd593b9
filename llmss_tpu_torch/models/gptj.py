"""GPT-J: partial interleaved rotary, parallel residual, MHA, untied head
with a bias (counterpart: llmss_tpu/models/gptj.py:25-86).

Checkpoint: ``transformer.h.{i}.attn.{q,k,v,out}_proj`` without biases,
``mlp.fc_in`` / ``fc_out`` with biases, one ``ln_1`` per block feeding
both the attention and the MLP (``h + attn + mlp``), ``lm_head`` with a
bias. Defaults are GPTJConfig's (EleutherAI/gpt-j-6b).
"""

from __future__ import annotations

from llmss_tpu_torch.models._loading import (
    lm_head, norm, stacked_linear, stacked_norm,
)
from llmss_tpu_torch.models.common import DecoderConfig
from llmss_tpu_torch.models.decoder import Params
from llmss_tpu_torch.weights.loader import CheckpointShards

DEFAULTS = dict(vocab_size=50400, n_positions=2048, n_embd=4096, n_layer=28,
                n_head=16, n_inner=None, rotary_dim=64,
                activation_function="gelu_new", layer_norm_epsilon=1e-5)


def config_from_hf(hf: dict, dtype: str = "bfloat16") -> DecoderConfig:
    hf = {**DEFAULTS, **hf}
    head_dim = hf["n_embd"] // hf["n_head"]
    return DecoderConfig(
        model_type="gptj",
        vocab_size=hf["vocab_size"],
        hidden_size=hf["n_embd"],
        n_layers=hf["n_layer"],
        n_heads=hf["n_head"],
        n_kv_heads=hf["n_head"],
        head_dim=head_dim,
        intermediate_size=hf["n_inner"] or 4 * hf["n_embd"],
        max_position_embeddings=hf["n_positions"],
        activation=hf["activation_function"],
        norm="layernorm",
        norm_eps=hf["layer_norm_epsilon"],
        parallel_residual=True,
        mlp="mlp",
        positions="rotary",
        rope_style="interleaved",
        rotary_dim=hf["rotary_dim"] or head_dim,
        attn_bias=False,
        mlp_bias=True,
        head_bias=True,
        tie_word_embeddings=False,
        dtype=dtype,
    )


def load_params(ckpt: CheckpointShards, cfg: DecoderConfig) -> Params:
    L, h = cfg.n_layers, "transformer.h"

    def lin(attr, key, *, bias):
        # q/k keep the [out, in] disk layout; the rest go to [in, out].
        return stacked_linear(ckpt, lambda i: f"{h}.{i}.{attr}", L,
                              transpose=key not in ("q", "k"), bias=bias)

    blocks: Params = {
        "ln1": stacked_norm(ckpt, lambda i: f"{h}.{i}.ln_1", L),
        "q": lin("attn.q_proj", "q", bias=False),
        "k": lin("attn.k_proj", "k", bias=False),
        "v": lin("attn.v_proj", "v", bias=False),
        "o": lin("attn.out_proj", "o", bias=False),
        "fc_in": lin("mlp.fc_in", "fc_in", bias=True),
        "fc_out": lin("mlp.fc_out", "fc_out", bias=True),
    }
    return {
        "wte": ckpt.get("transformer.wte.weight"),
        "blocks": blocks,
        "ln_f": norm(ckpt, "transformer.ln_f"),
        "head": lm_head(ckpt, "lm_head.weight", bias=True),
    }
