"""GPT-2: MHA, learned positions, Conv1D checkpoints, tied head
(counterpart: llmss_tpu/models/gpt2.py).

HF ``Conv1D`` weights are already ``[in, out]``: the fused ``c_attn`` is
``[E, 3E]`` with Q|K|V along the output axis, so v, o and the MLP load as
stored and q/k (kept ``[out, in]``) read the transposed view with the
range on its axis 0 (``llmss_tpu/models/gpt2.py:36-49``). Tensor names may
or may not carry the ``transformer.`` prefix. Defaults are GPT2Config's.
"""

from __future__ import annotations

from llmss_tpu_torch.models._loading import norm, stacked_linear, stacked_norm
from llmss_tpu_torch.models.common import DecoderConfig
from llmss_tpu_torch.models.decoder import Params
from llmss_tpu_torch.weights.loader import CheckpointShards

DEFAULTS = dict(vocab_size=50257, n_positions=1024, n_embd=768, n_layer=12,
                n_head=12, n_inner=None, activation_function="gelu_new",
                layer_norm_epsilon=1e-5)


def config_from_hf(hf: dict, dtype: str = "bfloat16") -> DecoderConfig:
    hf = {**DEFAULTS, **hf}
    return DecoderConfig(
        model_type="gpt2",
        vocab_size=hf["vocab_size"],
        hidden_size=hf["n_embd"],
        n_layers=hf["n_layer"],
        n_heads=hf["n_head"],
        n_kv_heads=hf["n_head"],
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
    L, E = cfg.n_layers, cfg.hidden_size

    pre = "" if "wte.weight" in ckpt else "transformer."

    def name(i, attr):
        return f"{pre}h.{i}.{attr}"

    def split_attn(key, lo, hi):
        t = key in ("q", "k")
        return stacked_linear(ckpt, lambda i: name(i, "attn.c_attn"), L,
                              transpose=t, sub=(0 if t else 1, lo, hi))

    def lin(attr):
        return stacked_linear(ckpt, lambda i: name(i, attr), L,
                              transpose=False)

    blocks: Params = {
        "ln1": stacked_norm(ckpt, lambda i: name(i, "ln_1"), L),
        "ln2": stacked_norm(ckpt, lambda i: name(i, "ln_2"), L),
        "q": split_attn("q", 0, E),
        "k": split_attn("k", E, 2 * E),
        "v": split_attn("v", 2 * E, 3 * E),
        "o": lin("attn.c_proj"),
        "fc_in": lin("mlp.c_fc"),
        "fc_out": lin("mlp.c_proj"),
    }
    return {
        "wte": ckpt.get(f"{pre}wte.weight"),
        "wpe": ckpt.get(f"{pre}wpe.weight"),
        "blocks": blocks,
        "ln_f": norm(ckpt, f"{pre}ln_f"),
    }
