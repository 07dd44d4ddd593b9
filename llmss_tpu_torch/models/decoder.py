"""Unified decoder: one forward for every supported family
(counterpart: llmss_tpu/models/decoder.py).

Parameters are a plain dict with the reference's structure and layouts:
``wte``, optional ``wpe``, ``blocks`` (each entry stacked on a leading
layer axis), ``ln_f`` and, unless tied, ``head``; q/k weights are stored
``[L, out, in]``, every other linear ``[L, in, out]``. Blocks run as a
Python loop over layers (the reference's ``lax.scan``).

``forward`` has the reference's three dense-cache modes:

- **prefill** (S > 1): each layer writes its KV into the ring in place,
  then attention (kernel K1 on the GPU) reads the updated cache
  (decoder.py:307-313, :745-790);
- **decode** (S == 1, deferred write, :598-744): attention (kernel K2 on
  the GPU) reads layer ``l`` of the stale stacked cache with the pending
  slot excluded and the fresh KV merged in; the fresh KV of every layer is
  scattered into the cache once, after the layer loop. ``t_bucket`` bounds
  the read to ring slots ``[0, t_bucket)`` (:535-544);
- **decode window** (1 < S <= 8, no sliding window, a cache of the compute
  dtype: the speculative verify, :581-593): the same deferred write, with
  attention (kernel K2w on the GPU) over the stale cache before the
  window's first position, its S pending slots excluded, plus the
  window's own fresh KV under the triangle ``j <= i``. Other S > 1 calls
  (int8 caches, sliding-window models) take the prefill mode, as in the
  reference. The caller's slots must then be the ring range from
  ``slots[:, 0]`` (``positions % T``).

Over the paged block pool (``PagedKVCache``, decoder.py:871-1081) the
caller contract is the same, with logical slots indirected through each
row's block table:

- ``forward_paged`` decode (S == 1): kernel K3 reads every layer of the
  stale pool in place, the fresh KV lands in one all-layer pool write
  after the layer loop; prefill (S > 1): each layer's fresh KV is written
  into the pool, the row's logical view is gathered and K1 attends it;
- ``forward_ragged`` (decoder.py:1159-1305): a CB-token chunk per row,
  ``q_lens`` live (1 for decode rows), through kernel K4 with the same
  deferred write; logits come from each row's last live column.

Pool, positions and tables are updated in place, where the reference
donates them.

Over an int8 cache (``cache.quantized``, decoder.py:597-778, :1029-1060,
:1222-1292) decode and ragged steps hand the raw int8 cache and its scales
to K2 / K3 / K4, which fold the scales in, and the step's one deferred
write quantizes the fresh KV. A prefill (S > 1) dequantizes the layer (or
the row's gathered view) to the compute dtype, writes the fresh KV into
that copy, runs K1 over it, and quantizes only the fresh tokens into the
int8 storage: untouched slots are never round-tripped, and the fresh
tokens are attended at full precision.

Not in this port yet: sequence/tensor parallelism.
"""

from __future__ import annotations

import functools
from typing import Any

import torch

from llmss_tpu_torch.device import resolve_device
from llmss_tpu_torch.engine.cache import (
    KVCache, PagedKVCache, dequantize_kv, gather_block_view,
    paged_write_layer, paged_write_stacked, write_layer, write_positions,
    write_slots, write_stacked,
)
from llmss_tpu_torch.models.common import DecoderConfig, act_fn
from llmss_tpu_torch.ops.attention import (
    decode_attention, decode_window_attention, paged_decode_attention,
    prefill_attention, ragged_attention,
)
from llmss_tpu_torch.ops.decode_attention import WINDOW_MAX
from llmss_tpu_torch.ops.layers import (
    LinearParams, NormParams, dense, dense_t, embedding, layer_norm, lm_head,
    rms_norm,
)
from llmss_tpu_torch.ops.rope import apply_rope, inv_freq_table, sin_cos_tables

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
        # A CPU scalar: no host-to-device copy, which a captured decode
        # step could not contain.
        h = h * torch.tensor(cfg.embed_multiplier, dtype=dtype)
    if cfg.positions == "learned":
        h = h + _learned_positions(positions, params["wpe"].to(dtype))
    return h


def _learned_positions(positions, wpe):
    """``wpe[positions]`` with the reference's bounds, never an
    out-of-range read (on the GPU, a device-side fault). A multi-token
    call embeds by a one-hot product there (decoder.py:467-476): a
    position outside the table (a dead column of a ragged chunk, padding
    at -1) adds a zero row. A one-token step gathers with ``jnp.take``: a
    position past the table (a done row still counting) gives NaN, and -1
    wraps to the last row."""
    n = wpe.shape[0]
    rows = embedding(positions.clamp(max=n - 1), wpe)
    if positions.shape[1] > 1:
        inside = (positions >= 0) & (positions < n)
        return torch.where(inside[..., None], rows, 0.0)
    return torch.where((positions < n)[..., None], rows, float("nan"))


def _head_out(cfg: DecoderConfig, params: Params, h, gather_idx):
    """Final norm, per-row hidden-state pick, vocab head; fp32 logits."""
    h = _norm(cfg, h, params["ln_f"])
    if gather_idx is not None:
        B = h.shape[0]
        h = h[torch.arange(B, device=h.device), gather_idx.long()][:, None, :]
    if cfg.tie_word_embeddings:
        return (h @ params["wte"].to(h.dtype).T).float()
    return lm_head(h, params["head"])


@functools.lru_cache(maxsize=None)
def rope_inv_freq(cfg: DecoderConfig, device: torch.device) -> torch.Tensor:
    """The config's rotary frequencies on ``device`` (LongRoPE's factors
    folded in), built once per (config, device): a forward only reads
    them, so a captured decode step holds no host-to-device copy.
    ``DecodeEngine`` builds its config's before any capture."""
    return inv_freq_table(cfg.rotary_dim or cfg.head_dim, cfg.rope_theta,
                          cfg.rope_freq_factors, device)


def _rope_tables(cfg: DecoderConfig, positions):
    if cfg.positions != "rotary":
        return None
    return sin_cos_tables(
        positions, cfg.rotary_dim or cfg.head_dim, cfg.rope_theta,
        attn_factor=cfg.rope_attn_factor,
        inv_freq=rope_inv_freq(cfg, positions.device),
    )


def forward(
    cfg: DecoderConfig,
    params: Params,
    input_ids: torch.Tensor,  # [B, S]
    positions: torch.Tensor,  # [B, S] absolute positions
    cache: KVCache | PagedKVCache,  # updated in place
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
    if isinstance(cache, PagedKVCache):
        return forward_paged(
            cfg, params, input_ids, positions, cache, slots,
            gather_idx=gather_idx, kv_write_positions=kv_write_positions,
            t_bucket=t_bucket, layers=layers,
        )
    if layers is None:
        layers = unstack_layers(params)
    S = input_ids.shape[1]
    h = _embed_in(cfg, params, input_ids, positions)
    if kv_write_positions is None:
        kv_write_positions = positions
    sin_cos = _rope_tables(cfg, positions)
    scale, window = cfg.attn_scale, cfg.sliding_window

    # A small decode window (the speculative verify: gamma + 1 tokens a
    # row) takes the deferred write too, through K2w, unless the model has
    # a sliding window or the cache is int8 (decoder.py:581-588).
    window_defer = (1 < S <= WINDOW_MAX and window is None
                    and not cache.quantized)
    if S == 1 or window_defer:
        t_len = (
            t_bucket if t_bucket is not None and t_bucket < cache.max_len
            else cache.max_len
        )
        fresh_k, fresh_v = [], []
        for layer, bp in enumerate(layers):
            def attend(q, k, v, layer=layer):
                if S > 1:
                    return decode_window_attention(
                        q, cache.k, cache.v, k, v, positions[:, :1],
                        cache.positions, slots, layer, t_len=t_len,
                        scale=scale,
                    )
                return decode_attention(
                    q, cache.k, cache.v, k, v, positions, cache.positions,
                    slots, layer, t_len=t_len, scale=scale, window=window,
                    k_scale=cache.k_scale, v_scale=cache.v_scale,
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
                if cache.quantized:
                    # A compute-dtype copy of the layer holding the fresh
                    # KV is attended; then only the fresh tokens are
                    # quantized into the storage.
                    k_l, v_l = write_layer(
                        dequantize_kv(cache.k[layer], cache.k_scale[layer],
                                      q.dtype),
                        dequantize_kv(cache.v[layer], cache.v_scale[layer],
                                      q.dtype), k, v, slots)
                    out = prefill_attention(
                        q, k_l, v_l, positions, cache.positions,
                        scale=scale, window=window,
                    )
                    write_layer(cache.k[layer], cache.v[layer], k, v, slots,
                                cache.k_scale[layer], cache.v_scale[layer])
                    return out
                k_l, v_l = write_layer(
                    cache.k[layer], cache.v[layer], k, v, slots
                )
                return prefill_attention(
                    q, k_l, v_l, positions, cache.positions,
                    scale=scale, window=window,
                )

            h, _, _ = _block(cfg, bp, h, positions, sin_cos, attend)
    return _head_out(cfg, params, h, gather_idx), cache


def _occupied_blocks(cache: PagedKVCache) -> torch.Tensor:
    """[B] int32 occupied table columns per row, ``ceil(#(positions >= 0)
    / bs)``, computed on the device: the kernels read it from device
    memory, so no host sync."""
    bs = cache.block_size
    occ = (cache.positions >= 0).sum(1, dtype=torch.int32)
    nblk = torch.div(occ + bs - 1, bs, rounding_mode="floor")
    return torch.clamp(nblk, 0, cache.max_blocks).to(torch.int32)


def _table_cols(cache: PagedKVCache, t_bucket: int | None) -> int | None:
    """Table columns a bucketed read walks: ``ceil(t_bucket / bs)``."""
    if t_bucket is None or t_bucket >= cache.max_len:
        return None
    return min(-(-t_bucket // cache.block_size), cache.max_blocks)


def _pool_write(cache: PagedKVCache, fresh_k: list, fresh_v: list,
                slots) -> None:
    """The step's one all-layer pool write of every layer's fresh KV
    (quantized, with its scales, into an int8 pool)."""
    bs = cache.block_size
    paged_write_stacked(cache.k, torch.stack(fresh_k), cache.block_tables,
                        slots, bs, cache.k_scale)
    paged_write_stacked(cache.v, torch.stack(fresh_v), cache.block_tables,
                        slots, bs, cache.v_scale)


def forward_paged(
    cfg: DecoderConfig,
    params: Params,
    input_ids: torch.Tensor,  # [B, S]
    positions: torch.Tensor,  # [B, S]
    cache: PagedKVCache,  # pool and positions updated in place
    slots: torch.Tensor,  # [B, S] LOGICAL slots; >= max_len writes nowhere
    *,
    gather_idx: torch.Tensor | None = None,
    kv_write_positions: torch.Tensor | None = None,
    t_bucket: int | None = None,
    layers: list[Params] | None = None,
) -> tuple[torch.Tensor, PagedKVCache]:
    """``forward`` over the paged block pool (counterpart:
    ``_forward_paged``, decoder.py:871). ``t_bucket`` rounds up to whole
    table columns (same caller contract as dense)."""
    if layers is None:
        layers = unstack_layers(params)
    B, S = input_ids.shape
    bs = cache.block_size
    h = _embed_in(cfg, params, input_ids, positions)
    if kv_write_positions is None:
        kv_write_positions = positions
    sin_cos = _rope_tables(cfg, positions)
    scale, window = cfg.attn_scale, cfg.sliding_window

    if S == 1:
        n_cols = _table_cols(cache, t_bucket)
        nblk = _occupied_blocks(cache)
        fresh_k, fresh_v = [], []
        for layer, bp in enumerate(layers):
            def attend(q, k, v, layer=layer):
                return paged_decode_attention(
                    q, cache.k, cache.v, k, v, positions, cache.positions,
                    cache.block_tables, nblk, slots, layer, n_cols=n_cols,
                    scale=scale, window=window, k_scale=cache.k_scale,
                    v_scale=cache.v_scale,
                )

            h, k, v = _block(cfg, bp, h, positions, sin_cos, attend)
            fresh_k.append(k)
            fresh_v.append(v)
        _pool_write(cache, fresh_k, fresh_v, slots)
        write_positions(cache.positions, kv_write_positions, slots)
    else:
        # Write-then-attend: this layer's fresh KV goes into the pool first
        # (writes through unmapped entries land in the drop block), then
        # the row's logical view, which now holds it, is gathered for K1.
        # Over int8 the view is gathered and dequantized, the fresh KV
        # written into it and attended at full precision, and only then
        # quantized into the pool (as the reference does).
        write_slots(cache.positions, slots, kv_write_positions)
        bt = cache.block_tables
        for layer, bp in enumerate(layers):
            def attend(q, k, v, layer=layer):
                if cache.quantized:
                    def view(pool, sc):
                        return dequantize_kv(
                            gather_block_view(pool[layer], bt),
                            gather_block_view(sc[layer], bt), q.dtype)

                    k_l, v_l = write_layer(view(cache.k, cache.k_scale),
                                           view(cache.v, cache.v_scale), k, v,
                                           slots)
                    out = prefill_attention(
                        q, k_l, v_l, positions, cache.positions,
                        scale=scale, window=window,
                    )
                    paged_write_layer(cache.k, layer, k, bt, slots, bs,
                                      cache.k_scale)
                    paged_write_layer(cache.v, layer, v, bt, slots, bs,
                                      cache.v_scale)
                    return out
                paged_write_layer(cache.k, layer, k, bt, slots, bs)
                paged_write_layer(cache.v, layer, v, bt, slots, bs)
                k_l = gather_block_view(cache.k[layer], bt)
                v_l = gather_block_view(cache.v[layer], bt)
                return prefill_attention(
                    q, k_l, v_l, positions, cache.positions,
                    scale=scale, window=window,
                )

            h, _, _ = _block(cfg, bp, h, positions, sin_cos, attend)
    return _head_out(cfg, params, h, gather_idx), cache


def forward_ragged(
    cfg: DecoderConfig,
    params: Params,
    input_ids: torch.Tensor,  # [B, CB] ragged chunks, q_lens live per row
    positions: torch.Tensor,  # [B, CB] row's first query at positions[:, 0]
    cache: PagedKVCache,  # pool and positions updated in place
    slots: torch.Tensor,  # [B, CB] LOGICAL slots; max_len marks dead columns
    q_lens: torch.Tensor,  # [B] int32: 1 for decode rows, up to CB mid-prefill
    *,
    kv_write_positions: torch.Tensor | None = None,  # [B, CB]; -1 = no write
    layers: list[Params] | None = None,
) -> tuple[torch.Tensor, PagedKVCache]:
    """Mixed prefill+decode forward over the pool (counterpart:
    decoder.py:1159): kernel K4 attends each row's chunk against the stale
    pool plus the chunk's own fresh KV, and the chunk's KV lands in one
    all-layer pool write after the layer loop. Returns the logits at each
    row's last live column (``q_lens - 1``): a prompt's final chunk gives
    its first token, a decode row its next one."""
    if layers is None:
        layers = unstack_layers(params)
    h = _embed_in(cfg, params, input_ids, positions)
    if kv_write_positions is None:
        kv_write_positions = positions
    sin_cos = _rope_tables(cfg, positions)
    scale, window = cfg.attn_scale, cfg.sliding_window
    nblk = _occupied_blocks(cache)
    q_pos0, slot0 = positions[:, 0], slots[:, 0]
    fresh_k, fresh_v = [], []
    for layer, bp in enumerate(layers):
        def attend(q, k, v, layer=layer):
            return ragged_attention(
                q, cache.k, cache.v, k, v, q_pos0, q_lens, cache.positions,
                cache.block_tables, nblk, slot0, layer, scale=scale,
                window=window, k_scale=cache.k_scale, v_scale=cache.v_scale,
            )

        h, k, v = _block(cfg, bp, h, positions, sin_cos, attend)
        fresh_k.append(k)
        fresh_v.append(v)
    _pool_write(cache, fresh_k, fresh_v, slots)
    write_slots(cache.positions, slots, kv_write_positions)
    return _head_out(cfg, params, h, q_lens - 1), cache
