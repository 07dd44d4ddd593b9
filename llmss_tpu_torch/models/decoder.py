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
donates them. On a mesh both take ``mesh=`` as ``forward`` does (tp: the
rank's heads, the row-parallel sums and the vocab-parallel embedding and
head; the pool holds the rank's KV heads, ``paged_cache_specs``), and K3
/ K4 run at the rank's local heads; the reference refuses the pool under
sp > 1 (engine.py:152-159), and so does the port.

Over an int8 cache (``cache.quantized``, decoder.py:597-778, :1029-1060,
:1222-1292) decode and ragged steps hand the raw int8 cache and its scales
to K2 / K3 / K4, which fold the scales in, and the step's one deferred
write quantizes the fresh KV. A prefill (S > 1) dequantizes the layer (or
the row's gathered view) to the compute dtype, writes the fresh KV into
that copy, runs K1 over it, and quantizes only the fresh tokens into the
int8 storage: untouched slots are never round-tripped, and the fresh
tokens are attended at full precision.

On a mesh (``mesh=``, parallel/mesh.py; decoder.py:60-67, :82-140,
:410-506, :575-611) a rank runs the dense forward over its shard, SPMD:

- **tp**: the column-parallel projections (q, k, v, gate, up, fc_in)
  give the rank's heads and MLP columns, the row-parallel ones (o, down,
  fc_out) a partial sum that a tp ``psum`` completes before the
  replicated bias is added once; KV heads shard as ``tp_head_plan``
  says (MQA's one KV head replicates). The embedding (and learned
  positions) is vocab-parallel: each rank gathers the rows it holds,
  zeros elsewhere, and a ``psum`` sums them exactly. The head gives the
  rank's vocabulary slice in fp32 and an ``all_gather`` over tp the full
  logits, the padding of an uneven vocabulary trimmed;
- **sp** (a cache whose ring is split into chunks, ``seq_sharded``):
  a prefill whose length sp divides runs on the rank's slice of the
  tokens; ``ring_attention`` passes each rank's fresh KV block once
  around the ring, each rank attends it with its own queries and writes
  the slots it holds as it passes (the ring held nothing else: the
  caller clears it first). Another prefill stays replicated and merges
  the chunks' states
  (``lse_merge_attention``). Decode stays replicated and attends the
  stale chunk with the pending slot excluded at its global index, the
  states merged and the fresh KV folded in (``sp_decode_attention``,
  K2's state-out form on the GPU), and the step's write lands on the
  rank that holds the slot. Slots stay global; no read is bucketed;
- **dp**: the engine hands each rank its rows; the forward sees only
  those.
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
from llmss_tpu_torch.ops.ring_attention import (
    lse_merge_attention, ring_attention, sp_decode_attention,
)
from llmss_tpu_torch.parallel.mesh import AXIS_SP, AXIS_TP
from llmss_tpu_torch.parallel.sharding import all_gather, psum
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


def init_params(cfg: DecoderConfig, *, seed: int = 0, device=None,
                mesh=None) -> Params:
    """Random init (benchmarks and smoke runs without checkpoints): every
    tensor is N(0, 1) * 0.02 in the config's dtype, drawn on ``device`` from
    one ``torch.Generator`` seeded by ``seed``. With a ``mesh``, the tp
    rank's slices of those tensors (``shard_params`` of the whole draw),
    each cut as it is drawn, so a rank never holds all of them."""
    from llmss_tpu_torch.parallel.sharding import (
        PADDED, check_tp, param_specs, shard_tensor,
    )

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = cfg.torch_dtype
    tp, rank, specs = 1, 0, None
    if mesh is not None:
        tp, rank = mesh.shape[AXIS_TP], mesh.coord(AXIS_TP)
        check_tp(cfg, tp)
        specs = param_specs(cfg, tp)

    def make(shape, axis, pad):
        if shape is None:
            return None
        t = torch.randn(shape, generator=gen, dtype=dt, device=dev) * 0.02
        if axis is None or tp == 1:
            return t
        return shard_tensor(t, axis, tp, rank, pad=pad)

    def walk(node, spec, pad=False):
        if isinstance(node, dict):
            return {k: walk(node[k], None if spec is None else spec[k],
                            k in PADDED) for k in sorted(node)}
        if isinstance(node, (LinearParams, NormParams)):
            spec = spec or (None,) * len(node)
            return type(node)(*(make(s, a, pad) for s, a in zip(node, spec)))
        return make(node, spec, pad)

    return walk(param_shapes(cfg), specs)


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


def _row(x, p: LinearParams, reduce):
    """A row-parallel linear: ``dense`` without a mesh; under tp the
    local product, its sum over the tp ranks (``reduce``), then the
    replicated bias, added once."""
    if reduce is None:
        return dense(x, p)
    y = reduce(x @ p.w.to(x.dtype))
    return y if p.b is None else y + p.b.to(y.dtype)


def _mlp(cfg: DecoderConfig, bp: Params, x, reduce=None):
    act = act_fn(cfg.activation)
    if cfg.mlp == "swiglu":
        return _row(act(dense(x, bp["gate"])) * dense(x, bp["up"]),
                    bp["down"], reduce)
    return _row(act(dense(x, bp["fc_in"])), bp["fc_out"], reduce)


def _block(cfg: DecoderConfig, bp: Params, h, positions, sin_cos, attend,
           reduce=None):
    """One decoder block; ``attend(q, k, v) -> [B, S, Hq, D]`` runs the
    attention with whatever cache handling the caller's mode needs. Under
    tp the projections hold the rank's heads (``bp``'s shapes say how
    many) and ``reduce`` sums the row-parallel products over the ranks."""
    B, S, _ = h.shape
    D = cfg.head_dim
    res = h
    x = _norm(cfg, h, bp["ln1"])
    q = dense_t(x, bp["q"]).reshape(B, S, -1, D)
    k = dense_t(x, bp["k"]).reshape(B, S, -1, D)
    v = dense(x, bp["v"]).reshape(B, S, -1, D)
    if cfg.positions == "rotary":
        kw = dict(rotary_dim=cfg.rotary_dim, theta=cfg.rope_theta,
                  style=cfg.rope_style, sin_cos=sin_cos)
        q = apply_rope(q, positions, **kw)
        k = apply_rope(k, positions, **kw)
    attn = _row(attend(q, k, v).reshape(B, S, -1), bp["o"], reduce)
    if cfg.parallel_residual:
        mlp_in = _norm(cfg, res, bp["ln2"]) if cfg.has_ln2 else x
        h = res + attn + _mlp(cfg, bp, mlp_in, reduce)
    else:
        h = res + attn
        h = h + _mlp(cfg, bp, _norm(cfg, h, bp["ln2"]), reduce)
    return h, k, v


def _lookup(ids, table, mesh):
    """``table[ids]``. Over a vocab-parallel table (tp > 1: ``table`` is
    this rank's rows ``[r * n, (r + 1) * n)``) each rank gathers the rows
    it holds, zeros elsewhere, and a ``psum`` adds them (exactly: one term
    is not zero)."""
    if mesh is None or mesh.size(AXIS_TP) == 1:
        return embedding(ids, table)
    n = table.shape[0]
    local = ids - mesh.coord(AXIS_TP) * n
    inside = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)].masked_fill(~inside[..., None], 0)
    return psum(rows, mesh, AXIS_TP)


def _embed_in(cfg: DecoderConfig, params: Params, input_ids, positions,
              mesh=None):
    dtype = cfg.torch_dtype
    h = _lookup(input_ids, params["wte"].to(dtype), mesh)
    if cfg.embed_multiplier is not None:
        # A CPU scalar: no host-to-device copy, which a captured decode
        # step could not contain.
        h = h * torch.tensor(cfg.embed_multiplier, dtype=dtype)
    if cfg.positions == "learned":
        h = h + _learned_positions(positions, params["wpe"].to(dtype),
                                   cfg.max_position_embeddings, mesh)
    return h


def _learned_positions(positions, wpe, n: int | None = None, mesh=None):
    """``wpe[positions]`` with the reference's bounds, never an
    out-of-range read (on the GPU, a device-side fault). A multi-token
    call embeds by a one-hot product there (decoder.py:467-476): a
    position outside the table (a dead column of a ragged chunk, padding
    at -1) adds a zero row. A one-token step gathers with ``jnp.take``: a
    position past the table (a done row still counting) gives NaN, and -1
    wraps to the last row. ``n`` is the table's length (``wpe``'s unless
    it is a tp rank's slice)."""
    n = wpe.shape[0] if n is None else n
    idx = positions.clamp(max=n - 1)
    if positions.shape[1] > 1:
        inside = (positions >= 0) & (positions < n)
        return torch.where(inside[..., None], _lookup(idx, wpe, mesh), 0.0)
    idx = torch.where(idx < 0, idx + n, idx)
    return torch.where((positions < n)[..., None], _lookup(idx, wpe, mesh),
                       float("nan"))


def _head_out(cfg: DecoderConfig, params: Params, h, gather_idx, mesh=None,
              ring: bool = False, q_off: int = 0):
    """Final norm, per-row hidden-state pick, vocab head; fp32 logits. On
    a mesh, after a ring prefill (the rank holds tokens ``[q_off, q_off +
    S_l)``), each row's pick comes from the rank that holds it (an exact
    ``psum`` over sp); the head gives the rank's vocabulary slice, and an
    ``all_gather`` over tp the full logits, an uneven vocabulary's padding
    trimmed."""
    h = _norm(cfg, h, params["ln_f"])
    if gather_idx is not None:
        B, S_l = h.shape[:2]
        rows = torch.arange(B, device=h.device)
        idx = gather_idx.long()
        if ring:
            idx = idx - q_off
            inside = (idx >= 0) & (idx < S_l)
            h = h[rows, idx.clamp(0, S_l - 1)][:, None, :]
            h = psum(torch.where(inside[:, None, None], h, 0.0), mesh,
                     AXIS_SP)
        else:
            h = h[rows, idx][:, None, :]
    elif ring:
        h = all_gather(h, mesh, AXIS_SP, 1)
    if cfg.tie_word_embeddings:
        logits = (h @ params["wte"].to(h.dtype).T).float()
    else:
        logits = lm_head(h, params["head"])
    if mesh is None:
        return logits
    return all_gather(logits, mesh, AXIS_TP, -1)[..., :cfg.vocab_size]


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
    mesh=None,  # parallel.mesh.Mesh: this rank's view; params its shard
    seq_sharded: bool = False,  # the cache holds this rank's sp chunk
) -> tuple[torch.Tensor, KVCache]:
    """Run the decoder; returns (fp32 logits, the same cache object, now
    holding this call's KV and positions).

    ``t_bucket`` caller contract (as in the reference): every live slot of
    every row, and every slot written this call, is < ``t_bucket``. A
    ring prefill (``seq_sharded``, S > 1 and sp divides S) attends this
    call's tokens only: the ring must hold no other live slot (the engine
    clears it before every prefill and refuses shared prefixes on a
    mesh)."""
    if isinstance(cache, PagedKVCache):
        return forward_paged(
            cfg, params, input_ids, positions, cache, slots,
            gather_idx=gather_idx, kv_write_positions=kv_write_positions,
            t_bucket=t_bucket, layers=layers, mesh=mesh,
        )
    if seq_sharded and cache.quantized:
        raise NotImplementedError("an int8 cache under sp > 1")
    if layers is None:
        layers = unstack_layers(params)
    S = input_ids.shape[1]
    if kv_write_positions is None:
        kv_write_positions = positions
    scale, window = cfg.attn_scale, cfg.sliding_window
    sp = mesh.size(AXIS_SP) if seq_sharded else 1
    reduce = _tp_reduce(mesh)
    # Under sp the cache holds global ring slots [off, off + C): local
    # slots out of [0, C) are another rank's, and every write site drops
    # them.
    local_slots = slots
    if sp > 1:
        local_slots = slots - mesh.coord(AXIS_SP) * cache.max_len

    # A ring prefill runs on this rank's slice of the tokens.
    ring = sp > 1 and S > 1 and S % sp == 0
    S_l, q_off, ids, pos = S, 0, input_ids, positions
    if ring:
        S_l = S // sp
        q_off = mesh.coord(AXIS_SP) * S_l
        ids = input_ids[:, q_off:q_off + S_l]
        pos = positions[:, q_off:q_off + S_l]
    h = _embed_in(cfg, params, ids, pos, mesh)
    sin_cos = _rope_tables(cfg, pos)

    # A small decode window (the speculative verify: gamma + 1 tokens a
    # row) takes the deferred write too, through K2w, unless the model has
    # a sliding window, the cache is int8 or the ring is split over sp
    # (decoder.py:581-588).
    window_defer = (1 < S <= WINDOW_MAX and window is None
                    and not cache.quantized and sp == 1)
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
                if sp > 1:
                    return sp_decode_attention(
                        q, cache.k, cache.v, k, v, positions,
                        cache.positions, slots, layer, mesh=mesh,
                        scale=scale, window=window)
                return decode_attention(
                    q, cache.k, cache.v, k, v, positions, cache.positions,
                    slots, layer, t_len=t_len, scale=scale, window=window,
                    k_scale=cache.k_scale, v_scale=cache.v_scale,
                )

            h, k, v = _block(cfg, bp, h, positions, sin_cos, attend, reduce)
            fresh_k.append(k)
            fresh_v.append(v)
        write_stacked(cache, torch.stack(fresh_k), torch.stack(fresh_v),
                      local_slots)
        write_positions(cache.positions, kv_write_positions, local_slots)
    else:
        write_positions(cache.positions, kv_write_positions, local_slots)
        for layer, bp in enumerate(layers):
            def attend(q, k, v, layer=layer):
                if cache.quantized:  # never sp-sharded (refused above)
                    return _int8_prefill_attend(cache, layer, q, k, v, pos,
                                                slots, scale, window)
                if ring:
                    # Each rank's fresh block passes once around the ring;
                    # as it passes, each rank writes the slots it holds.
                    def keep(src, k_b, v_b, layer=layer):
                        write_layer(cache.k[layer], cache.v[layer], k_b, v_b,
                                    local_slots[:, src * S_l:(src + 1) * S_l])

                    return ring_attention(
                        q, k, v, pos, kv_write_positions[:, q_off:q_off + S_l],
                        mesh=mesh, scale=scale, window=window, on_block=keep)
                k_l, v_l = write_layer(cache.k[layer], cache.v[layer], k, v,
                                       local_slots)
                if sp > 1:
                    return lse_merge_attention(
                        q, k_l, v_l, pos, cache.positions, mesh=mesh,
                        scale=scale, window=window)
                return prefill_attention(q, k_l, v_l, pos, cache.positions,
                                         scale=scale, window=window)

            h, _, _ = _block(cfg, bp, h, pos, sin_cos, attend, reduce)
    return _head_out(cfg, params, h, gather_idx, mesh, ring, q_off), cache


def _tp_reduce(mesh):
    """The row-parallel products' sum over tp (``_block``'s ``reduce``),
    or None without tp."""
    if mesh is None or mesh.size(AXIS_TP) == 1:
        return None

    def reduce(x):
        return psum(x, mesh, AXIS_TP)

    return reduce


def _int8_prefill_attend(cache: KVCache, layer: int, q, k, v, positions,
                         slots, scale, window):
    """Prefill attention over an int8 layer: a compute-dtype copy of the
    layer holding the fresh KV is attended, then only the fresh tokens are
    quantized into the storage."""
    k_l, v_l = write_layer(
        dequantize_kv(cache.k[layer], cache.k_scale[layer], q.dtype),
        dequantize_kv(cache.v[layer], cache.v_scale[layer], q.dtype),
        k, v, slots)
    out = prefill_attention(q, k_l, v_l, positions, cache.positions,
                            scale=scale, window=window)
    write_layer(cache.k[layer], cache.v[layer], k, v, slots,
                cache.k_scale[layer], cache.v_scale[layer])
    return out


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
    mesh=None,  # parallel.mesh.Mesh (no sp): this rank's view
) -> tuple[torch.Tensor, PagedKVCache]:
    """``forward`` over the paged block pool (counterpart:
    ``_forward_paged``, decoder.py:871). ``t_bucket`` rounds up to whole
    table columns (same caller contract as dense)."""
    if layers is None:
        layers = unstack_layers(params)
    B, S = input_ids.shape
    bs = cache.block_size
    reduce = _tp_reduce(mesh)
    h = _embed_in(cfg, params, input_ids, positions, mesh)
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

            h, k, v = _block(cfg, bp, h, positions, sin_cos, attend, reduce)
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

            h, _, _ = _block(cfg, bp, h, positions, sin_cos, attend, reduce)
    return _head_out(cfg, params, h, gather_idx, mesh), cache


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
    mesh=None,  # parallel.mesh.Mesh (no sp): this rank's view
) -> tuple[torch.Tensor, PagedKVCache]:
    """Mixed prefill+decode forward over the pool (counterpart:
    decoder.py:1159): kernel K4 attends each row's chunk against the stale
    pool plus the chunk's own fresh KV, and the chunk's KV lands in one
    all-layer pool write after the layer loop. Returns the logits at each
    row's last live column (``q_lens - 1``): a prompt's final chunk gives
    its first token, a decode row its next one."""
    if layers is None:
        layers = unstack_layers(params)
    reduce = _tp_reduce(mesh)
    h = _embed_in(cfg, params, input_ids, positions, mesh)
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

        h, k, v = _block(cfg, bp, h, positions, sin_cos, attend, reduce)
        fresh_k.append(k)
        fresh_v.append(v)
    _pool_write(cache, fresh_k, fresh_v, slots)
    write_slots(cache.positions, slots, kv_write_positions)
    return _head_out(cfg, params, h, q_lens - 1, mesh), cache
