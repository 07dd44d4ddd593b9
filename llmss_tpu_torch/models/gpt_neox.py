"""GPT-NeoX / Pythia: head-interleaved fused QKV, partial rotary in the
half style, parallel residual with two norms
(counterpart: llmss_tpu/models/gpt_neox.py).

``attention.query_key_value`` packs its weight as ``[H, 3, D, E]`` (per
head Q, K, V), so a sub-range cannot address one part: each layer's tensor
is read whole and split (``llmss_tpu/models/gpt_neox.py:65-109``). With
``use_parallel_residual`` a block is ``h + attn(ln1(h)) + mlp(ln2(h))``.
Defaults are GPTNeoXConfig's.
"""

from __future__ import annotations

from llmss_tpu_torch.models._loading import (
    lm_head, norm, stacked_linear, stacked_norm,
)
from llmss_tpu_torch.models.common import DecoderConfig
from llmss_tpu_torch.models.decoder import Params
from llmss_tpu_torch.ops.layers import LinearParams
from llmss_tpu_torch.weights.loader import CheckpointShards

DEFAULTS = dict(vocab_size=50432, max_position_embeddings=2048,
                hidden_size=6144, num_hidden_layers=44,
                num_attention_heads=64, intermediate_size=24576,
                hidden_act="gelu", rotary_pct=0.25, rotary_emb_base=10000,
                layer_norm_eps=1e-5, use_parallel_residual=True,
                attention_bias=True, tie_word_embeddings=False)


def config_from_hf(hf: dict, dtype: str = "bfloat16") -> DecoderConfig:
    hf = {**DEFAULTS, **hf}
    head_dim = hf["hidden_size"] // hf["num_attention_heads"]
    parallel = bool(hf["use_parallel_residual"])
    return DecoderConfig(
        model_type="gpt_neox",
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        n_layers=hf["num_hidden_layers"],
        n_heads=hf["num_attention_heads"],
        n_kv_heads=hf["num_attention_heads"],
        head_dim=head_dim,
        intermediate_size=hf["intermediate_size"],
        max_position_embeddings=hf["max_position_embeddings"],
        activation=hf["hidden_act"],
        norm="layernorm",
        norm_eps=hf["layer_norm_eps"],
        parallel_residual=parallel,
        parallel_residual_ln2=parallel,
        mlp="mlp",
        positions="rotary",
        rope_style="half",
        rotary_dim=int(head_dim * hf["rotary_pct"]),
        rope_theta=float(hf["rotary_emb_base"]),
        attn_bias=bool(hf["attention_bias"]),
        mlp_bias=True,
        tie_word_embeddings=bool(hf["tie_word_embeddings"]),
        dtype=dtype,
    )


def _fused_qkv(ckpt: CheckpointShards, cfg: DecoderConfig) -> Params:
    """q, k, v of every layer from the head-interleaved fused tensors:
    q/k ``[L, H*D, E]``, v ``[L, E, H*D]``, biases ``[L, H*D]`` (present
    as ``cfg.attn_bias`` says)."""
    L, H, D, E = cfg.n_layers, cfg.n_heads, cfg.head_dim, cfg.hidden_size
    out: Params = {}
    for i in range(L):
        pre = f"gpt_neox.layers.{i}.attention.query_key_value"
        w = ckpt.get(f"{pre}.weight").reshape(H, 3, D, E)
        b = ckpt.get(f"{pre}.bias").reshape(H, 3, D) if cfg.attn_bias else None
        for part, key in enumerate("qkv"):
            wp = w[:, part].reshape(H * D, E)
            if key == "v":
                wp = wp.T
            if i == 0:
                out[key] = LinearParams(
                    w.new_empty((L, *wp.shape)),
                    None if b is None else b.new_empty((L, H * D)))
            out[key].w[i].copy_(wp)
            if b is not None:
                out[key].b[i].copy_(b[:, part].reshape(H * D))
    return out


def load_params(ckpt: CheckpointShards, cfg: DecoderConfig) -> Params:
    L, pre = cfg.n_layers, "gpt_neox.layers"

    def lin(attr):
        return stacked_linear(ckpt, lambda i: f"{pre}.{i}.{attr}", L)

    blocks: Params = {
        "ln1": stacked_norm(ckpt, lambda i: f"{pre}.{i}.input_layernorm", L),
        "ln2": stacked_norm(
            ckpt, lambda i: f"{pre}.{i}.post_attention_layernorm", L),
        **_fused_qkv(ckpt, cfg),
        "o": lin("attention.dense"),
        "fc_in": lin("mlp.dense_h_to_4h"),
        "fc_out": lin("mlp.dense_4h_to_h"),
    }
    params: Params = {
        "wte": ckpt.get("gpt_neox.embed_in.weight"),
        "blocks": blocks,
        "ln_f": norm(ckpt, "gpt_neox.final_layer_norm"),
    }
    if not cfg.tie_word_embeddings:
        params["head"] = lm_head(ckpt, "embed_out.weight")
    return params
