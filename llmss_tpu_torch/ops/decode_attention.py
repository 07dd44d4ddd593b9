"""Kernel K2: single-token decode attention over the stacked cache
(csrc/decode_attention.cu).

Replaces ``llmss_tpu/ops/pallas_decode.py::decode_attention``, with the
XLA path's bucketed read added: ``t_len`` bounds the read to ring slots
``[0, t_len)``, cut into ``S`` splits along the slots (flash-decoding,
``ops/split_plan.py``) that ``kernel_plan`` picks from the shapes and the
card's SM count. Two templates read each KV head once per (row, split)
for a group of its query heads: the lane template (``"lanes"``) at up to
8 heads a block, and, for bf16 queries with more than 8 query heads per
KV head (StarCoder's 48), the tensor-core tile (``"mma"``, 64 heads a
block, ``decode_mma``), whose splits are whole 64-slot tiles and whose
states always go through the merge (the fresh V stays fp32).
``decode_attention`` launches the CUDA kernel (and, at ``S > 1`` or on
the tile, its merge) and counts each call in
``decode_attention.launches``; it takes CUDA tensors only.
``decode_attention_ref`` is the plain PyTorch version (fp32 throughout:
``fresh_kv_decode_attention`` on the layer's first ``t_len`` slots), used
for CPU tensors and as the kernel's check on the card. The kernel rounds P
to the value dtype before P.V, as the Pallas kernel does.

Over an int8 cache (``k_scale`` / ``v_scale`` ``[L, B, T, Hkv]`` fp32,
q and fresh KV in fp32 or bf16) the kernel is the int8 instantiation of
the same templates (``kernel_plan`` names them ``"lanes_int8"`` and,
above 8 heads per KV head under bf16 queries, ``"mma_int8"``, the tile
over int8 tiles with P x v_scale as two bf16 terms): it computes
what the reference's XLA oracle ``fresh_kv_decode_attention(k_scale=,
v_scale=)`` (llmss_tpu/ops/attention.py:242) computes, since the Pallas K2
takes no scales: each cache score times its slot's K scale, and P times
the V scale (in fp32 on the lanes), the fresh token unscaled.
"""

from __future__ import annotations

import torch

from llmss_tpu_torch.ops import _build
from llmss_tpu_torch.ops import split_plan as sp
from llmss_tpu_torch.ops.attention import fresh_kv_decode_attention

HEAD_DIMS = _build.HEAD_DIMS


def decode_attention_ref(
    q, k_cache, v_cache, k_new, v_new, q_pos, kv_pos, slots, layer: int,
    *, t_len: int | None = None, scale: float | None = None,
    window: int | None = None, k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    t = k_cache.shape[2] if t_len is None else t_len

    def sl(x):
        return None if x is None else x[layer, :, :t]

    return fresh_kv_decode_attention(
        q, sl(k_cache), sl(v_cache), k_new, v_new, q_pos, kv_pos[:, :t],
        slots, scale=scale, window=window, k_scale=sl(k_scale),
        v_scale=sl(v_scale),
    )


def _heads_per_block(G: int) -> int:
    """GB, the lane template's query heads per block: the least power of
    two at or above ``min(G, 8)``, so each KV head's heads take
    ``ceil(G / GB)`` groups (G = 7: one group of 8, one row dead)."""
    gb = 1
    while gb < min(G, 8):
        gb *= 2
    return gb


def kernel_plan(dtype: torch.dtype, B: int, Hq: int, Hkv: int, D: int,
                t_len: int, *, sms: int = sp.H100_SMS,
                max_splits: int = sp.MAX_SPLITS,
                kv_dtype: torch.dtype | None = None,
                g_tile: int = sp.G_TILE) -> sp.Plan:
    """How a K2 call launches on a card of ``sms`` SMs. bf16 queries with
    more than ``g_tile`` query heads per KV head take the tensor-core tile
    (``sp.decode_tile``: ``"mma"``, or ``"mma_int8"`` over an int8 cache),
    64 heads a block, split into whole 64-slot tiles and always merged.
    Every other call takes the lane template with ``GB`` query heads per
    block (``_heads_per_block``), ``"lanes"`` over a cache of the query's
    dtype or ``"lanes_int8"`` over an int8 cache (``kv_dtype``). Returns
    the instantiation, the shared memory one block needs (bytes), and the
    split of slots ``[0, t_len)`` (into at most ``max_splits``), which the
    cache's dtype does not change."""
    kv_dtype = dtype if kv_dtype is None else kv_dtype
    G = Hq // Hkv
    tile = sp.decode_tile(dtype, kv_dtype, G, g_tile)
    if tile is not None:
        return sp.decode_tile_plan(tile, B, Hkv, G, D, t_len, sms=sms,
                                   max_splits=max_splits)
    GB = _heads_per_block(G)
    S, split = sp.split_plan(B, Hkv * -(-G // GB), t_len,
                             step=sp.lane_step(D), sms=sms,
                             max_splits=max_splits)
    smem = (sp.lane_region_bytes(kv_dtype.itemsize, GB, D)
            + 4 * (2 * 8 * GB + GB) + sp.stage_smem_bytes(1))
    return sp.Plan(sp.lane_impl(kv_dtype), smem, S, split)


def decode_attention(
    q: torch.Tensor,  # [B, 1, Hq, D]
    k_cache: torch.Tensor,  # [L, B, T, Hkv, D]
    v_cache: torch.Tensor,
    k_new: torch.Tensor,  # [B, 1, Hkv, D]
    v_new: torch.Tensor,
    q_pos: torch.Tensor,  # [B, 1]
    kv_pos: torch.Tensor,  # [B, T]
    slots: torch.Tensor,  # [B, 1]
    layer: int,
    *,
    t_len: int | None = None,
    scale: float | None = None,
    window: int | None = None,
    k_scale: torch.Tensor | None = None,  # [L, B, T, Hkv] fp32 iff int8
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch K2 on the current stream; returns [B, 1, Hq, D] in q's dtype."""
    out = _launch(q, k_cache, v_cache, k_new, v_new, q_pos, kv_pos, slots,
                  layer, t_len=t_len, scale=scale, window=window,
                  k_scale=k_scale, v_scale=v_scale)
    decode_attention.launches += 1
    return out


def _launch(q, k_cache, v_cache, k_new, v_new, q_pos, kv_pos, slots, layer,
            *, t_len=None, scale=None, window=None, k_scale=None,
            v_scale=None, max_splits=sp.MAX_SPLITS, g_tile=sp.G_TILE):
    """Check the envelope and launch K2 split into at most ``max_splits``
    (1: the unsplit kernel, which chip_smoke.py times beside the plan's),
    on the tile above ``g_tile`` query heads per KV head (chip_smoke.py
    forces either template to time them side by side)."""
    tensors = (q, k_cache, v_cache, k_new, v_new, q_pos, kv_pos, slots)
    if not all(t.is_cuda for t in tensors):
        raise RuntimeError("decode_attention (K2) takes CUDA tensors only")
    B, S, Hq, D = q.shape
    L, Bc, T, Hkv, Dc = k_cache.shape
    if S != 1:
        raise ValueError(f"decode_attention is single-token, got S={S}")
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention supports head_dim {HEAD_DIMS}, got {D}")
    if (Bc, Dc) != (B, D) or Hq % Hkv or v_cache.shape != k_cache.shape:
        raise ValueError(f"bad shapes q={tuple(q.shape)} "
                         f"cache={tuple(k_cache.shape)}")
    if k_new.shape != (B, 1, Hkv, D) or v_new.shape != k_new.shape:
        raise ValueError("k_new / v_new must be [B, 1, Hkv, D]")
    if not (q.dtype == k_new.dtype == v_new.dtype
            and k_cache.dtype == v_cache.dtype):
        raise ValueError("q and fresh KV must share a dtype, and K and V "
                         "caches theirs")
    sc = _build.scale_args("decode_attention (K2)", q, k_cache, k_scale,
                           v_scale)
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("decode_attention reads the cache in place: it "
                         "must be contiguous")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range [0, {L})")
    t_len = T if t_len is None else int(t_len)
    if not 0 < t_len <= T:
        raise ValueError(f"t_len must be in (0, {T}], got {t_len}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    qc = q.contiguous()
    kn, vn = k_new.contiguous(), v_new.contiguous()
    qp = q_pos.to(torch.int32).reshape(B).contiguous()
    sl = slots.to(torch.int32).reshape(B).contiguous()
    kvp = kv_pos.to(torch.int32).contiguous()
    if kvp.shape != (B, T):
        raise ValueError("kv_pos must be [B, T]")
    for t in (qc, k_cache, v_cache, kn, vn):
        if t.data_ptr() % 16:
            raise ValueError("decode_attention needs 16-byte aligned tensors")
    plan = kernel_plan(q.dtype, B, Hq, Hkv, D, t_len,
                       sms=_build.sm_count(q.device), max_splits=max_splits,
                       kv_dtype=k_cache.dtype, g_tile=g_tile)
    if plan.smem > _build.SMEM_LIMIT:
        raise _build.KernelError(f"decode_attention (K2) needs {plan.smem} "
                                 "bytes of shared memory")
    out = torch.empty_like(qc)
    ws = (torch.empty(sp.workspace_numel(B, Hq, plan.splits, D),
                      dtype=torch.float32, device=q.device)
          if sp.merges(plan) else None)
    lib = _build.load("decode_attention")
    code = lib.llmss_decode_attention(
        qc.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), kn.data_ptr(),
        vn.data_ptr(), out.data_ptr(), qp.data_ptr(), kvp.data_ptr(),
        sl.data_ptr(), ws.data_ptr() if ws is not None else None, int(layer),
        B, T, t_len, Hq, Hkv, D, _heads_per_block(Hq // Hkv), plan.splits,
        plan.split_slots, _build.dtype_code(q), float(scale), window or 0,
        _build.stream_ptr(q.device), sc[0], sc[1],
        _build.dtype_code(k_cache), _build.IMPL_CODES[plan.impl],
    )
    _build.check(code, "decode_attention")
    return out


decode_attention.launches = 0
