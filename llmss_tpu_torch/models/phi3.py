"""Phi-3 / Phi-3.5: the Llama block with fused ``qkv_proj`` and
``gate_up_proj``, partial rotary and LongRoPE
(counterpart: llmss_tpu/models/phi3.py).

The fused tensors are contiguous blocks (Q|K|V, gate|up on the output
axis), so each part is a sub-range read; the rest is the Llama loader
through its ``overrides``. LongRoPE (``rope_scaling.type`` "longrope", or
"su" as first published) becomes static per-frequency divisors and an
attention factor; ``DecodeEngine`` picks the short or the long factors
once from its ``max_seq_len`` (see ``_longrope``). Defaults are
Phi3Config's.
"""

from __future__ import annotations

import dataclasses
import math

from llmss_tpu_torch.models import llama
from llmss_tpu_torch.models._loading import stacked_linear
from llmss_tpu_torch.models.common import DecoderConfig
from llmss_tpu_torch.models.decoder import Params
from llmss_tpu_torch.weights.loader import CheckpointShards


def config_from_hf(hf: dict, dtype: str = "bfloat16") -> DecoderConfig:
    cfg = llama.config_from_hf(hf, dtype=dtype)
    rotary_dim = int(cfg.head_dim * hf.get("partial_rotary_factor", 1.0))
    return dataclasses.replace(
        cfg,
        model_type="phi3",
        rotary_dim=rotary_dim,
        sliding_window=hf.get("sliding_window"),
        **_longrope(hf, rotary_dim),
    )


def _longrope(hf: dict, rotary_dim: int) -> dict:
    """LongRoPE scaling as static per-frequency divisors and the
    attention factor (HF ``_compute_longrope_parameters``).

    HF picks ``short_factor`` or ``long_factor`` per forward from that
    call's length, so a generation crossing
    ``original_max_position_embeddings`` changes the rotary basis under
    keys cached with the other one. As in the reference, the basis is
    picked once per engine from its ``max_seq_len`` (long past the
    original context, else short), which keeps the cache consistent and
    equals HF on every forward within the engine's regime. The default
    here follows the checkpoint's own context, for direct ``forward``
    callers."""
    scaling = hf.get("rope_scaling")
    if not scaling:
        return {}
    kind = scaling.get("type") or scaling.get("rope_type")
    if kind not in ("longrope", "su"):
        raise NotImplementedError(
            f"Phi-3 rope_scaling type {kind!r} is not implemented "
            "(supported: plain rotary and 'longrope'/'su')")
    original = (hf.get("original_max_position_embeddings")
                or scaling.get("original_max_position_embeddings"))
    if not original:
        raise ValueError(
            "longrope scaling requires original_max_position_embeddings")

    def factors(key):
        if key not in scaling:
            raise ValueError(f"longrope rope_scaling is missing {key!r} "
                             f"(has {sorted(scaling)})")
        fs = tuple(float(x) for x in scaling[key])
        if len(fs) != rotary_dim // 2:
            raise ValueError(f"longrope {key} length {len(fs)} != "
                             f"rotary_dim/2 ({rotary_dim // 2})")
        return fs

    short, long = factors("short_factor"), factors("long_factor")
    attn_factor = scaling.get("attention_factor")
    if attn_factor is None:
        ratio = hf["max_position_embeddings"] / original
        attn_factor = (1.0 if ratio <= 1.0 else
                       math.sqrt(1 + math.log(ratio) / math.log(original)))
    return dict(
        rope_freq_factors=(long if hf["max_position_embeddings"] > original
                           else short),
        rope_attn_factor=float(attn_factor),
        rope_freq_factors_short=short,
        rope_freq_factors_long=long,
        rope_original_max_positions=int(original),
    )


def _fused(attr: str, key: str, lo: int, hi: int):
    """A loader of one part of a contiguous fused tensor: q/k keep the
    disk's ``[out, in]`` (range on its axis 0), v / gate / up are
    transposed to ``[in, out]`` (range on axis 1 of that view)."""
    def load(ckpt: CheckpointShards, cfg: DecoderConfig):
        t = key not in ("q", "k")
        return stacked_linear(
            ckpt, lambda i: f"model.layers.{i}.{attr}", cfg.n_layers,
            transpose=t, sub=(1 if t else 0, lo, hi))

    return load


def load_params(ckpt: CheckpointShards, cfg: DecoderConfig) -> Params:
    Q, KV, Im = cfg.q_size, cfg.kv_size, cfg.intermediate_size
    return llama.load_params(ckpt, cfg, overrides={
        "q": _fused("self_attn.qkv_proj", "q", 0, Q),
        "k": _fused("self_attn.qkv_proj", "k", Q, Q + KV),
        "v": _fused("self_attn.qkv_proj", "v", Q + KV, Q + 2 * KV),
        "gate": _fused("mlp.gate_up_proj", "gate", 0, Im),
        "up": _fused("mlp.gate_up_proj", "up", Im, 2 * Im),
    })
