"""Unified decoder: one forward for every supported family
(counterpart: llmss_tpu/models/decoder.py).

Parameters are a plain dict with the reference's structure and layouts:
``wte``, optional ``wpe``, ``blocks`` (each entry stacked on a leading
layer axis), ``ln_f`` and, unless tied, ``head``; q/k weights are stored
``[L, out, in]``, every other linear ``[L, in, out]``. Blocks run as a
Python loop over layers (the reference's ``lax.scan``).

``forward`` has the reference's two dense-cache modes:

- **prefill** (S > 1): each layer writes its KV into the ring in place,
  then attention (kernel K1 on the GPU) reads the updated cache
  (decoder.py:307-313, :745-790);
- **decode** (S == 1, deferred write, :598-744): attention (kernel K2 on
  the GPU) reads layer ``l`` of the stale stacked cache with the pending
  slot excluded and the fresh KV merged in; the fresh KV of every layer is
  scattered into the cache once, after the layer loop. ``t_bucket`` bounds
  the read to ring slots ``[0, t_bucket)`` (:535-544).

Not in this port yet: sequence/tensor parallelism, the paged and ragged
layouts, the speculative multi-token window and the int8 cache.
"""

from __future__ import annotations

from typing import Any

import torch

from llmss_tpu_torch.device import resolve_device
from llmss_tpu_torch.engine.cache import (
    KVCache, write_layer, write_positions, write_stacked,
)
from llmss_tpu_torch.models.common import DecoderConfig, act_fn
from llmss_tpu_torch.ops.attention import decode_attention, prefill_attention
from llmss_tpu_torch.ops.layers import (
    LinearParams, NormParams, dense, dense_t, embedding, layer_norm, lm_head,
    rms_norm,
)
from llmss_tpu_torch.ops.rope import apply_rope, sin_cos_tables

Params = dict[str, Any]


def param_shapes(cfg: DecoderConfig) -> Params:
    """Shape pytree of the full parameter set (tuples, with None for
    absent biases) — the reference's ``param_shapes``."""
    L, E, V = cfg.n_layers, cfg.hidden_size, cfg.vocab_size
    Q, KV, I = cfg.q_size, cfg.kv_size, cfg.intermediate_size
    norm_bias = cfg.norm == "layernorm"

    def norm_shape(stacked):
        lead = (L,) if stacked else ()
        return NormParams((*lead, E), (*lead, E) if norm_bias else None)

    blocks: Params = {
        "ln1": norm_shape(True),
        "q": LinearParams((L, Q, E), (L, Q) if cfg.attn_bias else None),
        "k": LinearParams((L, KV, E), (L, KV) if cfg.attn_bias else None),
        "v": LinearParams((L, E, KV), (L, KV) if cfg.attn_bias else None),
        "o": LinearParams((L, Q, E), (L, E) if cfg.o_bias else None),
    }
    if cfg.has_ln2:
        blocks["ln2"] = norm_shape(True)
    if cfg.mlp == "swiglu":
        blocks["gate"] = LinearParams((L, E, I), None)
        blocks["up"] = LinearParams((L, E, I), None)
        blocks["down"] = LinearParams((L, I, E), None)
    else:
        blocks["fc_in"] = LinearParams((L, E, I), (L, I) if cfg.mlp_bias else None)
        blocks["fc_out"] = LinearParams((L, I, E), (L, E) if cfg.mlp_bias else None)
    shapes: Params = {"wte": (V, E), "blocks": blocks, "ln_f": norm_shape(False)}
    if cfg.positions == "learned":
        shapes["wpe"] = (cfg.max_position_embeddings, E)
    if not cfg.tie_word_embeddings:
        shapes["head"] = LinearParams((E, V), (V,) if cfg.head_bias else None)
    return shapes


def init_params(cfg: DecoderConfig, *, seed: int = 0, device=None) -> Params:
    """Random init (benchmarks and smoke runs without checkpoints): every
    tensor is N(0, 1) * 0.02 in the config's dtype, drawn on ``device`` from
    one ``torch.Generator`` seeded by ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = cfg.torch_dtype

    def make(shape):
        if shape is None:
            return None
        return torch.randn(shape, generator=gen, dtype=dt, device=dev) * 0.02

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (LinearParams, NormParams)):
            return type(node)(*(make(s) for s in node))
        return make(node)

    return walk(param_shapes(cfg))


def unstack_layers(params: Params) -> list[Params]:
    """Per-layer views of the stacked block parameters."""
    blocks = params["blocks"]
    L = next(iter(blocks.values()))[0].shape[0]

    def at(p, layer):
        return type(p)(*(None if x is None else x[layer] for x in p))

    return [{k: at(p, layer) for k, p in blocks.items()} for layer in range(L)]


def _norm(cfg: DecoderConfig, x, p: NormParams):
    if cfg.norm == "rmsnorm":
        return rms_norm(x, p, cfg.norm_eps, cfg.norm_scale_offset)
    return layer_norm(x, p, cfg.norm_eps)


def _mlp(cfg: DecoderConfig, bp: Params, x):
    act = act_fn(cfg.activation)
    if cfg.mlp == "swiglu":
        return dense(act(dense(x, bp["gate"])) * dense(x, bp["up"]), bp["down"])
    return dense(act(dense(x, bp["fc_in"])), bp["fc_out"])


def _block(cfg: DecoderConfig, bp: Params, h, positions, sin_cos, attend):
    """One decoder block; ``attend(q, k, v) -> [B, S, Hq, D]`` runs the
    attention with whatever cache handling the caller's mode needs."""
    B, S, _ = h.shape
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    res = h
    x = _norm(cfg, h, bp["ln1"])
    q = dense_t(x, bp["q"]).reshape(B, S, Hq, D)
    k = dense_t(x, bp["k"]).reshape(B, S, Hkv, D)
    v = dense(x, bp["v"]).reshape(B, S, Hkv, D)
    if cfg.positions == "rotary":
        kw = dict(rotary_dim=cfg.rotary_dim, theta=cfg.rope_theta,
                  style=cfg.rope_style, sin_cos=sin_cos)
        q = apply_rope(q, positions, **kw)
        k = apply_rope(k, positions, **kw)
    attn = dense(attend(q, k, v).reshape(B, S, Hq * D), bp["o"])
    if cfg.parallel_residual:
        mlp_in = _norm(cfg, res, bp["ln2"]) if cfg.has_ln2 else x
        h = res + attn + _mlp(cfg, bp, mlp_in)
    else:
        h = res + attn
        h = h + _mlp(cfg, bp, _norm(cfg, h, bp["ln2"]))
    return h, k, v


def _embed_in(cfg: DecoderConfig, params: Params, input_ids, positions):
    dtype = cfg.torch_dtype
    h = embedding(input_ids, params["wte"].to(dtype))
    if cfg.embed_multiplier is not None:
        h = h * torch.tensor(cfg.embed_multiplier, dtype=dtype, device=h.device)
    if cfg.positions == "learned":
        h = h + embedding(positions, params["wpe"].to(dtype))
    return h


def _head_out(cfg: DecoderConfig, params: Params, h, gather_idx):
    """Final norm, per-row hidden-state pick, vocab head; fp32 logits."""
    h = _norm(cfg, h, params["ln_f"])
    if gather_idx is not None:
        B = h.shape[0]
        h = h[torch.arange(B, device=h.device), gather_idx.long()][:, None, :]
    if cfg.tie_word_embeddings:
        return (h @ params["wte"].to(h.dtype).T).float()
    return lm_head(h, params["head"])


def forward(
    cfg: DecoderConfig,
    params: Params,
    input_ids: torch.Tensor,  # [B, S]
    positions: torch.Tensor,  # [B, S] absolute positions
    cache: KVCache,  # updated in place
    slots: torch.Tensor,  # [B, S] ring slots; out-of-range slots are dropped
    *,
    gather_idx: torch.Tensor | None = None,  # [B] per-row index into S
    kv_write_positions: torch.Tensor | None = None,  # [B, S]; -1 = padding
    t_bucket: int | None = None,  # decode reads only slots [0, t_bucket)
    layers: list[Params] | None = None,  # unstack_layers(params), if cached
) -> tuple[torch.Tensor, KVCache]:
    """Run the decoder; returns (fp32 logits, the same cache object, now
    holding this call's KV and positions).

    ``t_bucket`` caller contract (as in the reference): every live slot of
    every row, and every slot written this call, is < ``t_bucket``."""
    if layers is None:
        layers = unstack_layers(params)
    S = input_ids.shape[1]
    h = _embed_in(cfg, params, input_ids, positions)
    if kv_write_positions is None:
        kv_write_positions = positions
    sin_cos = None
    if cfg.positions == "rotary":
        sin_cos = sin_cos_tables(
            positions, cfg.rotary_dim or cfg.head_dim, cfg.rope_theta,
            cfg.rope_freq_factors, cfg.rope_attn_factor,
        )
    scale, window = cfg.attn_scale, cfg.sliding_window

    if S == 1:
        t_len = (
            t_bucket if t_bucket is not None and t_bucket < cache.max_len
            else cache.max_len
        )
        fresh_k, fresh_v = [], []
        for layer, bp in enumerate(layers):
            def attend(q, k, v, layer=layer):
                return decode_attention(
                    q, cache.k, cache.v, k, v, positions, cache.positions,
                    slots, layer, t_len=t_len, scale=scale, window=window,
                )

            h, k, v = _block(cfg, bp, h, positions, sin_cos, attend)
            fresh_k.append(k)
            fresh_v.append(v)
        write_stacked(cache, torch.stack(fresh_k), torch.stack(fresh_v), slots)
        write_positions(cache.positions, kv_write_positions, slots)
    else:
        write_positions(cache.positions, kv_write_positions, slots)
        for layer, bp in enumerate(layers):
            def attend(q, k, v, layer=layer):
                k_l, v_l = write_layer(
                    cache.k[layer], cache.v[layer], k, v, slots
                )
                return prefill_attention(
                    q, k_l, v_l, positions, cache.positions,
                    scale=scale, window=window,
                )

            h, _, _ = _block(cfg, bp, h, positions, sin_cos, attend)
    return _head_out(cfg, params, h, gather_idx), cache
