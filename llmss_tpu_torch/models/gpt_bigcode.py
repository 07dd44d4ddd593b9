"""GPT-BigCode / StarCoder: multi-query attention, learned positions,
tied head (counterpart: llmss_tpu/models/gpt_bigcode.py:29-96).

The fused ``attn.c_attn`` is a torch Linear ``[E + 2 kv, E]``: Q is its
first E output rows, K the next kv, V the last kv (the reference splits at
``gpt_bigcode_modeling.py:126-127``). One KV head when ``multi_query``.
Defaults are GPTBigCodeConfig's.
"""

from __future__ import annotations

from llmss_tpu_torch.models._loading import (
    norm, stacked_linear, stacked_norm, table,
)
from llmss_tpu_torch.models.common import DecoderConfig
from llmss_tpu_torch.models.decoder import Params
from llmss_tpu_torch.weights.loader import CheckpointShards

DEFAULTS = dict(vocab_size=50257, n_positions=1024, n_embd=768, n_layer=12,
                n_head=12, n_inner=None,
                activation_function="gelu_pytorch_tanh",
                layer_norm_epsilon=1e-5, multi_query=True)


def config_from_hf(hf: dict, dtype: str = "bfloat16") -> DecoderConfig:
    hf = {**DEFAULTS, **hf}
    return DecoderConfig(
        model_type="gpt_bigcode",
        vocab_size=hf["vocab_size"],
        hidden_size=hf["n_embd"],
        n_layers=hf["n_layer"],
        n_heads=hf["n_head"],
        n_kv_heads=1 if hf["multi_query"] else hf["n_head"],
        head_dim=hf["n_embd"] // hf["n_head"],
        intermediate_size=hf["n_inner"] or 4 * hf["n_embd"],
        max_position_embeddings=hf["n_positions"],
        activation=hf["activation_function"],
        norm="layernorm",
        norm_eps=hf["layer_norm_epsilon"],
        parallel_residual=False,
        mlp="mlp",
        positions="learned",
        attn_bias=True,
        mlp_bias=True,
        tie_word_embeddings=True,
        dtype=dtype,
    )


def load_params(ckpt: CheckpointShards, cfg: DecoderConfig) -> Params:
    L, E, kv, h = cfg.n_layers, cfg.hidden_size, cfg.kv_size, "transformer.h"

    def split_attn(key, lo, hi):
        # q/k keep [out, in]: their range is on the disk's axis 0; v is
        # transposed to [in, out], its range on axis 1 of that view.
        t = key not in ("q", "k")
        return stacked_linear(ckpt, lambda i: f"{h}.{i}.attn.c_attn", L,
                              transpose=t, sub=(1 if t else 0, lo, hi),
                              key=key)

    def lin(attr, key):
        return stacked_linear(ckpt, lambda i: f"{h}.{i}.{attr}", L, key=key)

    blocks: Params = {
        "ln1": stacked_norm(ckpt, lambda i: f"{h}.{i}.ln_1", L),
        "ln2": stacked_norm(ckpt, lambda i: f"{h}.{i}.ln_2", L),
        "q": split_attn("q", 0, E),
        "k": split_attn("k", E, E + kv),
        "v": split_attn("v", E + kv, E + 2 * kv),
        "o": lin("attn.c_proj", "o"),
        "fc_in": lin("mlp.c_fc", "fc_in"),
        "fc_out": lin("mlp.c_proj", "fc_out"),
    }
    return {
        "wte": table(ckpt, "transformer.wte.weight", "wte"),
        "wpe": table(ckpt, "transformer.wpe.weight", "wpe"),
        "blocks": blocks,
        "ln_f": norm(ckpt, "transformer.ln_f"),
    }
