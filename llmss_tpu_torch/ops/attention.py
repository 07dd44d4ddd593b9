"""Attention: the plain PyTorch versions and the kernel dispatch
(counterpart: llmss_tpu/ops/attention.py).

The plain functions compute everything in fp32, like the reference's XLA
oracles (``attention`` :116, ``fresh_kv_window_attention`` :186 with its
mask ``window_mask_penalty`` :166, ``fresh_kv_decode_attention`` :242). Head
layout is ``[batch, seq, heads, head_dim]``; GQA/MQA map query head ``h``
to KV head ``h // G``. Masked lanes take the finite fp32 minimum, never
-inf, so a fully masked row degrades to a uniform average instead of NaN.

Over an int8 cache the plain versions take its fp32 scales (``k_scale``,
``v_scale``, per slot and KV head) and fold them in as the reference's
oracles do (:296-319, :533-535): each cache score is multiplied by its
slot's K scale, and each cache probability by its slot's V scale before
the fp32 P.V. The fresh tokens' K / V are never quantized here.

``prefill_attention``, ``decode_attention``, ``decode_window_attention``,
``paged_decode_attention`` and ``ragged_attention`` are the dispatch (the
non-sharded part of the reference's ``dispatch_attention`` :543-639 and of
the paged kernel hooks in models/decoder.py; its sp routing, ring
prefill when the sp axis divides the length and the LSE merge otherwise,
is in models/decoder.py over ops/ring_attention.py, and ``tp_head_plan``
/ ``sp_plan`` are the reference's rules): CUDA tensors go to the
hand-written kernels (ops/flash_attention.py, ops/decode_attention.py,
ops/paged_attention.py),
CPU tensors to the plain versions. A CUDA tensor never reaches a plain
version, and any other device raises.
"""

from __future__ import annotations

import torch

NEG_INF = float(torch.finfo(torch.float32).min)


def make_causal_mask(
    q_positions: torch.Tensor,  # [B, S]
    kv_positions: torch.Tensor,  # [B, T]
    kv_valid: torch.Tensor,  # [B, T] bool
    window: int | None = None,
) -> torch.Tensor:
    """Boolean [B, S, T]: query may attend valid slots at <= its position
    (and inside the sliding window, when set)."""
    kvp = kv_positions[:, None, :]
    qp = q_positions[:, :, None]
    mask = (kvp <= qp) & kv_valid[:, None, :]
    if window is not None:
        mask &= kvp > qp - window
    return mask


def attention(
    q: torch.Tensor,  # [B, S, Hq, D]
    k: torch.Tensor,  # [B, T, Hkv, D]
    v: torch.Tensor,
    mask: torch.Tensor,  # [B, S, T] bool
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Masked softmax attention in fp32; returns q's dtype."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    qf = q.float().reshape(B, S, Hkv, G, D) * scale
    logits = torch.einsum("bskgd,btkd->bkgst", qf, k.float())
    logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(B, S, Hq, D).to(q.dtype)


def decode_mask_penalty(
    q_pos: torch.Tensor,  # [B, 1]
    kv_pos_old: torch.Tensor,  # [B, T] pre-write slot positions
    slots: torch.Tensor,  # [B, 1] slot the current token will take
    window: int | None = None,
) -> torch.Tensor:
    """Additive fp32 [B, T] mask: 0 for visible slots, fp32-min for masked
    ones (causal, empty, the pending slot, outside the window)."""
    T = kv_pos_old.shape[1]
    slot_idx = torch.arange(T, dtype=torch.int32, device=kv_pos_old.device)
    mask = (kv_pos_old <= q_pos) & (kv_pos_old >= 0) & (slot_idx[None, :] != slots)
    if window is not None:
        mask &= kv_pos_old > q_pos - window
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    return torch.where(mask, zero, torch.full_like(zero, NEG_INF))


def fresh_kv_decode_attention(
    q: torch.Tensor,  # [B, 1, Hq, D]
    k_cache: torch.Tensor,  # [B, T, Hkv, D] stale (current token not written)
    v_cache: torch.Tensor,
    k_new: torch.Tensor,  # [B, 1, Hkv, D]
    v_new: torch.Tensor,
    q_pos: torch.Tensor,  # [B, 1]
    kv_pos_old: torch.Tensor,  # [B, T]
    slots: torch.Tensor,  # [B, 1]
    *,
    scale: float | None = None,
    window: int | None = None,
    k_scale: torch.Tensor | None = None,  # [B, T, Hkv] fp32 iff int8 cache
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Single-token attention over a stale cache plus the fresh token's own
    KV, merged in one exact fp32 softmax. The pending slot is masked out
    (on a ring wrap it holds the token being overwritten); the fresh token
    always attends itself, so an empty cache gives exactly ``v_new``."""
    B, S, Hq, D = q.shape
    if S != 1:
        raise ValueError(f"fresh_kv_decode_attention requires S == 1, got {S}")
    Hkv = k_cache.shape[2]
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    qf = q.float().reshape(B, S, Hkv, G, D) * scale
    s_c = _fold(torch.einsum("bskgd,btkd->bkgst", qf, k_cache.float()),
                k_scale)
    penalty = decode_mask_penalty(q_pos, kv_pos_old, slots, window)
    s_c = s_c + penalty[:, None, None, None, :]
    s_s = torch.einsum("bskgd,bskd->bkgs", qf, k_new.float())[..., None]
    m = torch.maximum(s_c.amax(-1, keepdim=True), s_s)
    p_c = torch.exp(s_c - m)
    p_s = torch.exp(s_s - m)
    denom = p_c.sum(-1, keepdim=True) + p_s
    out_c = torch.einsum("bkgst,btkd->bkgsd", _fold(p_c, v_scale),
                         v_cache.float())
    out = (
        out_c + p_s * v_new.float().permute(0, 2, 1, 3)[:, :, None]
    ) / denom
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D).to(q.dtype)


def window_mask_penalty(
    q_pos0: torch.Tensor,  # [B, 1] position of the window's first query
    kv_pos_old: torch.Tensor,  # [B, T] pre-write slot positions
    slots: torch.Tensor,  # [B, S] slots the window's tokens will take
) -> torch.Tensor:
    """Additive fp32 [B, T] cache mask of ``fresh_kv_window_attention``: a
    live slot before the window (``0 <= pos < q_pos0``) is visible to every
    window query, and the S pending slots (on a ring wrap they hold tokens
    the window overwrites) are masked, so one penalty serves the window."""
    T = kv_pos_old.shape[1]
    slot_idx = torch.arange(T, dtype=torch.int32, device=kv_pos_old.device)
    pending = (slot_idx[None, :, None] == slots[:, None, :]).any(-1)
    mask = (kv_pos_old < q_pos0) & (kv_pos_old >= 0) & ~pending
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    return torch.where(mask, zero, torch.full_like(zero, NEG_INF))


def fresh_kv_window_attention(
    q: torch.Tensor,  # [B, S, Hq, D] a small decode window (S <= 8)
    k_cache: torch.Tensor,  # [B, T, Hkv, D] stale (window not written)
    v_cache: torch.Tensor,
    k_new: torch.Tensor,  # [B, S, Hkv, D] the window's own KV
    v_new: torch.Tensor,
    penalty: torch.Tensor,  # [B, T] fp32, ``window_mask_penalty``
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Deferred-write attention of a multi-token decode window (the
    speculative verify): one exact fp32 softmax over the stale cache, masked
    by ``penalty``, plus the window's fresh KV under the triangle ``j <=
    i`` (window query ``i`` sees window key ``j``). Full causal only."""
    B, S, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    qf = q.float().reshape(B, S, Hkv, G, D) * scale
    s_c = torch.einsum("bskgd,btkd->bkgst", qf, k_cache.float())
    s_c = s_c + penalty[:, None, None, None, :]
    s_w = torch.einsum("bskgd,btkd->bkgst", qf, k_new.float())
    tri = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s_w = s_w.masked_fill(~tri, NEG_INF)
    m = torch.maximum(s_c.amax(-1, keepdim=True), s_w.amax(-1, keepdim=True))
    p_c = torch.exp(s_c - m)
    p_w = torch.exp(s_w - m)
    denom = p_c.sum(-1, keepdim=True) + p_w.sum(-1, keepdim=True)
    out = (
        torch.einsum("bkgst,btkd->bkgsd", p_c, v_cache.float())
        + torch.einsum("bkgst,btkd->bkgsd", p_w, v_new.float())
    ) / denom
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D).to(q.dtype)


def _fold(x: torch.Tensor, scale: torch.Tensor | None) -> torch.Tensor:
    """``x`` [B, Hkv, G, S, T] times ``scale`` [B, T, Hkv] per (row, slot,
    KV head); ``x`` itself without a scale."""
    if scale is None:
        return x
    return x * scale.permute(0, 2, 1)[:, :, None, None, :]


def ragged_cache_visibility(
    q_len: torch.Tensor,  # [B] live query rows per chunk (1..CB)
    kv_pos_old: torch.Tensor,  # [B, T] pre-write slot positions
    slot0: torch.Tensor,  # [B] or [B, 1] logical slot of the first query
    ring_len: int,  # logical ring capacity (cache.max_len)
) -> torch.Tensor:
    """Query-invariant [B, T] bool: the slot holds a live token and is not
    among the chunk's ``q_len`` pending slots, the ring range from
    ``slot0`` that the chunk's deferred write overwrites."""
    B, T = kv_pos_old.shape
    slot0 = slot0.reshape(B, 1)
    d = torch.arange(T, dtype=torch.int32, device=kv_pos_old.device)[None] - slot0
    d = torch.where(d < 0, d + ring_len, d)
    pending = d < q_len.reshape(B, 1)
    return (kv_pos_old >= 0) & ~pending


def ragged_fresh_kv_attention(
    q: torch.Tensor,  # [B, S, Hq, D] S = chunk budget, ragged per q_len
    k_cache: torch.Tensor,  # [B, T, Hkv, D] stale (chunk not written)
    v_cache: torch.Tensor,
    k_new: torch.Tensor,  # [B, S, Hkv, D] the chunk's own fresh KV
    v_new: torch.Tensor,
    q_pos: torch.Tensor,  # [B] or [B, 1] first query's absolute position
    q_len: torch.Tensor,  # [B] live query rows (1..S)
    kv_pos_old: torch.Tensor,  # [B, T]
    slot0: torch.Tensor,  # [B] or [B, 1]
    ring_len: int,
    *,
    scale: float | None = None,
    window: int | None = None,
    k_scale: torch.Tensor | None = None,  # [B, T, Hkv] fp32 iff int8 cache
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """One exact fp32 softmax over the stale cache plus each row's fresh
    ``q_len``-token chunk: query ``i`` sees cache positions ``<= q_pos + i``
    outside the pending range, and fresh key ``j`` when ``j <= i`` and ``j <
    q_len``. Key 0 is visible to every query row, padding included, so no
    denominator is 0."""
    B, S, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    dev = q.device
    rel = torch.arange(S, dtype=torch.int32, device=dev)
    qpos = q_pos.reshape(B, 1) + rel[None, :]  # [B, S]
    vis = ragged_cache_visibility(q_len, kv_pos_old, slot0, ring_len)
    kvp = kv_pos_old[:, None, :]
    mask = vis[:, None, :] & (kvp <= qpos[:, :, None])  # [B, S, T]
    if window is not None:
        mask &= kvp > qpos[:, :, None] - window
    qf = q.float().reshape(B, S, Hkv, G, D) * scale
    s_c = _fold(torch.einsum("bskgd,btkd->bkgst", qf, k_cache.float()),
                k_scale)
    s_c = s_c.masked_fill(~mask[:, None, None], NEG_INF)
    s_w = torch.einsum("bskgd,btkd->bkgst", qf, k_new.float())
    tri = (rel[None, :, None] >= rel[None, None, :]) & (
        rel[None, None, :] < q_len.reshape(B, 1, 1)
    )  # [B, S(query), S(key)]
    if window is not None:
        tri &= (rel[None, :, None] - rel[None, None, :]) < window
    s_w = s_w.masked_fill(~tri[:, None, None], NEG_INF)
    m = torch.maximum(s_c.amax(-1, keepdim=True), s_w.amax(-1, keepdim=True))
    p_c = torch.exp(s_c - m)
    p_w = torch.exp(s_w - m)
    denom = p_c.sum(-1, keepdim=True) + p_w.sum(-1, keepdim=True)
    out = (
        torch.einsum("bkgst,btkd->bkgsd", _fold(p_c, v_scale),
                     v_cache.float())
        + torch.einsum("bkgst,btkd->bkgsd", p_w, v_new.float())
    ) / denom
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D).to(q.dtype)


def tp_head_plan(Hq: int, Hkv: int, tp: int) -> tuple[bool, bool, str | None]:
    """The tp rule for attention heads (attention.py:64-79): ``(kv_shard,
    heads_ok, kv_axis)``. KV heads shard when ``tp`` divides them;
    replicated KV is right only for MQA (``Hkv == 1``), where every query
    head's group is the one KV head on every rank."""
    kv_shard = Hkv % tp == 0
    heads_ok = Hq % tp == 0 and (kv_shard or Hkv == 1)
    return kv_shard, heads_ok, "tp" if kv_shard else None


def sp_plan(mesh, B: int, T: int, Hq: int, Hkv: int) -> tuple[bool, str | None]:
    """Whether (batch, cache length, heads) ride the mesh's sp axis
    (attention.py:82-92): ``(ok, kv_axis)``."""
    dp, sp, tp = mesh.shape["dp"], mesh.shape["sp"], mesh.shape["tp"]
    _, heads_ok, kv_ax = tp_head_plan(Hq, Hkv, tp)
    ok = sp > 1 and T % sp == 0 and B % dp == 0 and heads_ok
    return ok, kv_ax


def _route(*tensors: torch.Tensor | None) -> str:
    """"cuda" or "cpu" for a set of tensors (None entries skipped) on one
    device; raises for a mix of devices or any other device type."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cuda"}:
        return "cuda"
    if kinds == {"cpu"}:
        return "cpu"
    raise RuntimeError(
        f"attention inputs must all be CUDA tensors (kernel) or all CPU "
        f"tensors (plain version); got devices {sorted(kinds)}"
    )


def prefill_attention(
    q: torch.Tensor,  # [B, S, Hq, D]
    k: torch.Tensor,  # [B, T, Hkv, D]
    v: torch.Tensor,
    q_positions: torch.Tensor,  # [B, S]
    kv_positions: torch.Tensor,  # [B, T], -1 = empty slot
    *,
    scale: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Causal attention with the mask given as positions: kernel K1 for
    CUDA tensors, ``flash_attention_ref`` for CPU tensors."""
    from llmss_tpu_torch.ops import flash_attention as fa

    if _route(q, k, v, q_positions, kv_positions) == "cuda":
        return fa.flash_attention(
            q, k, v, q_positions, kv_positions, scale=scale, window=window
        )
    return fa.flash_attention_ref(
        q, k, v, q_positions, kv_positions, scale=scale, window=window
    )


def decode_attention(
    q: torch.Tensor,  # [B, 1, Hq, D]
    k_cache: torch.Tensor,  # [L, B, T, Hkv, D] stale stacked cache
    v_cache: torch.Tensor,
    k_new: torch.Tensor,  # [B, 1, Hkv, D]
    v_new: torch.Tensor,
    q_pos: torch.Tensor,  # [B, 1]
    kv_pos: torch.Tensor,  # [B, T] pre-write slot positions
    slots: torch.Tensor,  # [B, 1]
    layer: int,
    *,
    t_len: int | None = None,
    scale: float | None = None,
    window: int | None = None,
    k_scale: torch.Tensor | None = None,  # [L, B, T, Hkv] iff int8 cache
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Single-token decode attention over layer ``layer`` of the stacked
    cache, reading slots ``[0, t_len)``: kernel K2 for CUDA tensors,
    ``decode_attention_ref`` for CPU tensors."""
    from llmss_tpu_torch.ops import decode_attention as da

    args = (q, k_cache, v_cache, k_new, v_new, q_pos, kv_pos, slots, layer)
    fn = (da.decode_attention if _route(*args[:-1], k_scale, v_scale) == "cuda"
          else da.decode_attention_ref)
    return fn(*args, t_len=t_len, scale=scale, window=window,
              k_scale=k_scale, v_scale=v_scale)


def decode_window_attention(
    q: torch.Tensor,  # [B, S, Hq, D], 1 < S <= 8
    k_cache: torch.Tensor,  # [L, B, T, Hkv, D] stale stacked cache
    v_cache: torch.Tensor,
    k_new: torch.Tensor,  # [B, S, Hkv, D]
    v_new: torch.Tensor,
    q_pos0: torch.Tensor,  # [B, 1] position of the first window query
    kv_pos: torch.Tensor,  # [B, T] pre-write slot positions
    slots: torch.Tensor,  # [B, S] the window's slots, a ring range
    layer: int,
    *,
    t_len: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Deferred-write window attention over layer ``layer`` of the stacked
    cache, reading slots ``[0, t_len)``: kernel K2w for CUDA tensors,
    ``decode_window_attention_ref`` for CPU tensors."""
    from llmss_tpu_torch.ops import decode_attention as da

    args = (q, k_cache, v_cache, k_new, v_new, q_pos0, kv_pos, slots, layer)
    fn = (da.decode_window_attention if _route(*args[:-1]) == "cuda"
          else da.decode_window_attention_ref)
    return fn(*args, t_len=t_len, scale=scale)


def paged_decode_attention(
    q: torch.Tensor,  # [B, 1, Hq, D]
    k_pool: torch.Tensor,  # [L, N + 1, bs, Hkv, D] stale pool
    v_pool: torch.Tensor,
    k_new: torch.Tensor,  # [B, 1, Hkv, D]
    v_new: torch.Tensor,
    q_pos: torch.Tensor,  # [B, 1]
    kv_pos: torch.Tensor,  # [B, MB*bs] pre-write logical slot positions
    block_tables: torch.Tensor,  # [B, MB]
    n_blocks: torch.Tensor,  # [B] occupied table columns per row
    slots: torch.Tensor,  # [B, 1] logical slot the token will take
    layer: int,
    *,
    n_cols: int | None = None,
    scale: float | None = None,
    window: int | None = None,
    k_scale: torch.Tensor | None = None,  # [L, N + 1, bs, Hkv] iff int8 pool
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Single-token decode attention over layer ``layer`` of the block
    pool, reading table columns ``[0, n_cols)``: kernel K3 for CUDA
    tensors, ``paged_decode_attention_ref`` for CPU tensors."""
    from llmss_tpu_torch.ops import paged_attention as pa

    args = (q, k_pool, v_pool, k_new, v_new, q_pos, kv_pos, block_tables,
            n_blocks, slots)
    fn = (pa.paged_decode_attention
          if _route(*args, k_scale, v_scale) == "cuda"
          else pa.paged_decode_attention_ref)
    return fn(*args, layer, n_cols=n_cols, scale=scale, window=window,
              k_scale=k_scale, v_scale=v_scale)


def ragged_attention(
    q: torch.Tensor,  # [B, CB, Hq, D]
    k_pool: torch.Tensor,  # [L, N + 1, bs, Hkv, D] stale pool
    v_pool: torch.Tensor,
    k_new: torch.Tensor,  # [B, CB, Hkv, D]
    v_new: torch.Tensor,
    q_pos: torch.Tensor,  # [B] first query's position
    q_len: torch.Tensor,  # [B] live query rows
    kv_pos: torch.Tensor,  # [B, MB*bs]
    block_tables: torch.Tensor,  # [B, MB]
    n_blocks: torch.Tensor,  # [B]
    slot0: torch.Tensor,  # [B] logical slot of the first query
    layer: int,
    *,
    n_cols: int | None = None,
    scale: float | None = None,
    window: int | None = None,
    k_scale: torch.Tensor | None = None,  # [L, N + 1, bs, Hkv] iff int8 pool
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Ragged mixed prefill+decode attention over layer ``layer`` of the
    block pool: kernel K4 for CUDA tensors, ``ragged_paged_attention_ref``
    for CPU tensors."""
    from llmss_tpu_torch.ops import paged_attention as pa

    args = (q, k_pool, v_pool, k_new, v_new, q_pos, q_len, kv_pos,
            block_tables, n_blocks, slot0)
    fn = (pa.ragged_paged_attention
          if _route(*args, k_scale, v_scale) == "cuda"
          else pa.ragged_paged_attention_ref)
    return fn(*args, layer, n_cols=n_cols, scale=scale, window=window,
              k_scale=k_scale, v_scale=v_scale)
