"""Kernel K2: single-token decode attention over the stacked cache
(csrc/decode_attention.cu), and K2w: the decode window's attention
(csrc/window_attention.cu).

Replaces ``llmss_tpu/ops/pallas_decode.py::decode_attention``, with the
XLA path's bucketed read added: ``t_len`` bounds the read to ring slots
``[0, t_len)``, cut into ``S`` splits along the slots (flash-decoding,
``ops/split_plan.py``) that ``kernel_plan`` picks from the shapes and the
card's SM count. Three templates read each KV head once per (row, split)
for a group of its query heads (``split_plan.decode_tile``): the lane
template (``"lanes"``) at up to 8 heads a block, below ``G_TILE`` query
heads per KV head, for fp32 / fp16 queries and over an int8 cache up to
8; the group tile (``"group"``, ``decode_group``, csrc/group_tile.cuh:
K2w's window tile at one query a row) for bf16 queries over a bf16 cache
from ``G_TILE`` to ``GROUP_MAX_G`` heads per KV head, 16 heads a row
block on the tensor cores; and the 64-row tile (``"mma"``,
``decode_mma``) above. The tiles' split states always go through the
merge, and every template keeps the fresh V in fp32.
``decode_attention`` launches the CUDA kernel (and, where its plan says,
its merge) and counts each call in ``decode_attention.launches``; it
takes CUDA tensors only. ``decode_attention_ref`` is the plain PyTorch
version (fp32 throughout: ``fresh_kv_decode_attention`` on the layer's
first ``t_len`` slots), used for CPU tensors and as the kernel's check on
the card. The kernel rounds P to the value dtype before P.V, as the
Pallas kernel does.

Over an int8 cache (``k_scale`` / ``v_scale`` ``[L, B, T, Hkv]`` fp32,
q and fresh KV in fp32 or bf16) the kernel is the int8 instantiation of
the same templates (``kernel_plan`` names them ``"lanes_int8"`` and,
above 8 heads per KV head under bf16 queries, ``"mma_int8"``, the tile
over int8 tiles with P x v_scale as two bf16 terms): it computes
what the reference's XLA oracle ``fresh_kv_decode_attention(k_scale=,
v_scale=)`` (llmss_tpu/ops/attention.py:242) computes, since the Pallas K2
takes no scales: each cache score times its slot's K scale, and P times
the V scale (in fp32 on the lanes), the fresh token unscaled.

K2w (``decode_window_attention``) is the speculative verify's attention:
S <= 8 window queries a row over layer ``l`` of the stale stacked cache,
read in place up to ``t_len``, plus the window's own fresh KV under the
triangle ``j <= i``. It replaces no Pallas kernel: the reference runs the
XLA oracle ``fresh_kv_window_attention`` (llmss_tpu/ops/attention.py:186),
which ``decode_window_attention_ref`` computes in fp32. ``window_plan``
lays the window out over its ``G * S`` query rows per KV head: bf16 takes
the window tile (``"mma"``: 16 rows a warp, slot-parallel warps, the
splits one thread block cluster that folds them and the fresh keys in the
kernel), fp32 and fp16 the lanes, whose merge kernel folds the splits and
then the fresh keys; the fresh V in fp32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from llmss_tpu_torch.ops import _build
from llmss_tpu_torch.ops import split_plan as sp
from llmss_tpu_torch.ops.attention import (
    fresh_kv_decode_attention, fresh_kv_window_attention, window_mask_penalty,
)

HEAD_DIMS = _build.HEAD_DIMS
# K2w's longest window (csrc/window_attention.cu ``kMaxWin``): the decoder
# takes the deferred-write window path at 1 < S <= 8, as the reference does.
WINDOW_MAX = 8
# bf16 windows take the window tile, fp32 and fp16 the lanes: at gamma
# 1, MHA (2 rows a KV head, the fewest a window has) the tile took 0.0317
# ms on the H100 against the lanes' 0.0384-0.0390 (PERF.md, kernel_ab.py
# against the parent), so bf16 has no lane instantiation.
#
# The window tile (csrc/window_attention.cu window_mma, csrc/
# group_tile.cuh): split_plan's group tile over the window's G * S rows
# (16 a row warp, at most 4 row warps a block, 4 slot-parallel warps at
# one row warp, else 2). Its splits are whole 64-slot tiles, at most
# WINDOW_MAX_CLUSTER (the portable cluster size), folded in one thread
# block cluster up to WINDOW_CLUSTER_SPLITS splits and by window_merge
# above, the faster of the two on either side on the H100 (PERF.md,
# kernel_ab.py --k2w-forms). The plan splits only as far as the grid
# stays within one round of resident blocks: a block's fixed chain
# (positions, first tile, fold, cluster barriers) cost more than a
# shorter walk saved once a split grid took more rounds (Llama-2-7B's
# verify shape, batch 16: unsplit 0.0369 ms, 2 splits 0.0542, 3 splits
# 0.0757; PERF.md). A read of at most WINDOW_SHORT_TILES tiles is split
# only when the unsplit grid leaves half the SMs idle, as split_plan's
# SHORT_READ (PERF.md).
WINDOW_TILE_ROWS = sp.GROUP_TILE_ROWS
WINDOW_MAX_CLUSTER = sp.GROUP_MAX_CLUSTER
WINDOW_CLUSTER_SPLITS = 4
WINDOW_SHORT_TILES = sp.GROUP_SHORT_TILES
# The C entry's instantiation codes: the lanes then window_merge, the
# window tile (a split read folded in its cluster), and the same tile with
# its states folded by window_merge (the two-launch form).
WINDOW_IMPL_CODES = {"lanes": 0, "mma": 1, "mma_two_launch": 2}


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


def decode_window_attention_ref(
    q, k_cache, v_cache, k_new, v_new, q_pos0, kv_pos, slots, layer: int,
    *, t_len: int | None = None, scale: float | None = None,
) -> torch.Tensor:
    """K2w's plain version: ``fresh_kv_window_attention`` over the layer's
    first ``t_len`` slots, masked by ``window_mask_penalty``."""
    t = k_cache.shape[2] if t_len is None else t_len
    penalty = window_mask_penalty(q_pos0[:, :1], kv_pos[:, :t], slots)
    return fresh_kv_window_attention(
        q, k_cache[layer, :, :t], v_cache[layer, :, :t], k_new, v_new,
        penalty, scale=scale,
    )


def _rows(plan: sp.Plan, G: int) -> int:
    """Query rows of a block of ``plan`` at ``G`` query heads per KV head
    (the C entry's ``GB``): the group tile's, or the lanes' ``GB``."""
    if plan.impl == "group":
        return sp.group_rows(G)
    return _heads_per_block(G)


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
                force: str | None = None) -> sp.Plan:
    """How a K2 call launches on a card of ``sms`` SMs: bf16 queries take
    the tile ``sp.decode_tile`` names (``"group"`` over a bf16 cache from
    ``G_TILE`` query heads per KV head; ``"mma"`` / ``"mma_int8"`` above
    their thresholds), planned by ``sp.decode_tile_plan``. Every other
    call takes the lane template with ``GB`` query heads per block
    (``_heads_per_block``), ``"lanes"`` over a cache of the query's dtype
    or ``"lanes_int8"`` over an int8 cache (``kv_dtype``). ``force`` (one
    of ``sp.TEMPLATES``) puts a bf16 call on that template. Returns the
    instantiation, the shared memory one block needs (bytes), and the
    split of slots ``[0, t_len)`` (into at most ``max_splits``), which the
    cache's dtype does not change."""
    kv_dtype = dtype if kv_dtype is None else kv_dtype
    G = Hq // Hkv
    tile = sp.decode_tile(dtype, kv_dtype, G, force)
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
            v_scale=None, max_splits=sp.MAX_SPLITS, force=None):
    """Check the envelope and launch K2 split into at most ``max_splits``
    (1: the unsplit kernel, which chip_smoke.py times beside the plan's);
    ``force`` puts it on one template (chip_smoke.py and kernel_ab.py time
    them side by side)."""
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
                       kv_dtype=k_cache.dtype, force=force)
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
        B, T, t_len, Hq, Hkv, D, _rows(plan, Hq // Hkv),
        plan.splits, plan.split_slots, _build.dtype_code(q), float(scale),
        window or 0, _build.stream_ptr(q.device), sc[0], sc[1],
        _build.dtype_code(k_cache), _build.IMPL_CODES[plan.impl],
    )
    _build.check(code, "decode_attention")
    return out


decode_attention.launches = 0


class WindowPlan(NamedTuple):
    """How a K2w call launches: the instantiation (``"mma"``, the window
    tile; ``"lanes"``), the shared memory one block needs (bytes), the
    splits along the slots and the slots each covers, the window rows a
    block takes (``rows``) and the warps that split its slots (the lane
    template's 8, or the tile's slot-parallel warps per row warp), and the
    blocks of one thread block cluster (the splits, folded in the kernel;
    0 when window_merge folds them)."""

    impl: str
    smem: int
    splits: int
    split_slots: int
    rows: int
    slot_warps: int
    cluster: int


def window_tile_split(blocks: int, t_len: int, smem: int, sms: int,
                      max_splits: int, splits: int | None = None
                      ) -> tuple[int, int]:
    """(splits, split_slots) of the window tile over ``blocks`` blocks
    before the split: ``sp.group_split`` at most ``WINDOW_MAX_CLUSTER``
    splits, one cluster. ``splits``: that many instead (at most 8 and the
    read's tiles), for chip_smoke.py's forced launches."""
    return sp.group_split(blocks, t_len, smem, sms, max_splits, splits)


def window_plan(dtype: torch.dtype, B: int, Hq: int, Hkv: int, D: int,
                t_len: int, S: int, *, sms: int = sp.H100_SMS,
                max_splits: int = sp.MAX_SPLITS,
                cluster: bool | None = None, splits: int | None = None
                ) -> WindowPlan:
    """How a K2w call launches. bf16 takes the window tile (``"mma"``)
    over its G * S window rows per KV head: ``sp.group_warps``
    rows a block, ``ceil(G * S / rows)`` blocks per KV head, the read split
    by ``window_tile_split``; an unsplit read is folded in its block, a
    split one in its cluster up to ``WINDOW_CLUSTER_SPLITS`` splits, by
    window_merge above (``cluster``: True or False forces either). fp32
    and fp16 take the lane template (``"lanes"``) with
    ``_heads_per_block(G * S)`` rows a block, always followed by its
    merge, which folds the splits and then the window's fresh keys, so
    ``splits`` may be 1."""
    Gv = Hq // Hkv * S
    if dtype == torch.bfloat16:
        rw, sw = sp.group_warps(Gv)
        rows = WINDOW_TILE_ROWS * rw
        smem = _build.window_tile_smem_bytes(D, rw)
        n, split = window_tile_split(B * Hkv * -(-Gv // rows), t_len,
                                     smem, sms, max_splits, splits)
        if cluster is None:
            cluster = n <= WINDOW_CLUSTER_SPLITS
        return WindowPlan("mma", smem, n, split, rows, sw,
                          n if cluster else 0)
    GB = _heads_per_block(Gv)
    splits, split = sp.split_plan(B, Hkv * -(-Gv // GB), t_len,
                                  step=sp.lane_step(D), sms=sms,
                                  max_splits=max_splits)
    smem = (sp.lane_region_bytes(dtype.itemsize, GB, D) + 4 * 2 * 8 * GB
            + sp.stage_smem_bytes(1))
    return WindowPlan("lanes", smem, splits, split, GB, sp.NWARP, 0)


def decode_window_attention(
    q: torch.Tensor,  # [B, S, Hq, D], 1 < S <= WINDOW_MAX
    k_cache: torch.Tensor,  # [L, B, T, Hkv, D] stale: the window not written
    v_cache: torch.Tensor,
    k_new: torch.Tensor,  # [B, S, Hkv, D]
    v_new: torch.Tensor,
    q_pos0: torch.Tensor,  # [B, 1] position of each row's first query
    kv_pos: torch.Tensor,  # [B, T]
    slots: torch.Tensor,  # [B, S] the ring range from slots[:, 0]
    layer: int,
    *,
    t_len: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Launch K2w on the current stream; returns [B, S, Hq, D] in q's
    dtype. The kernel reads ``slots[:, 0]`` only: the window's slots must
    be the ring range ``(slots[:, 0] + i) % T``, as the decoder's are."""
    out = _launch_window(q, k_cache, v_cache, k_new, v_new, q_pos0, kv_pos,
                         slots, layer, t_len=t_len, scale=scale)
    decode_window_attention.launches += 1
    return out


def _launch_window(q, k_cache, v_cache, k_new, v_new, q_pos0, kv_pos, slots,
                   layer, *, t_len=None, scale=None,
                   max_splits=sp.MAX_SPLITS, cluster=None, splits=None):
    """Check K2w's envelope and launch it (``max_splits`` as in K2's
    ``_launch``; ``cluster`` the tile's fold and ``splits`` its split
    count, for chip_smoke.py's forced launches)."""
    tensors = (q, k_cache, v_cache, k_new, v_new, q_pos0, kv_pos, slots)
    if not all(t.is_cuda for t in tensors):
        raise RuntimeError("decode_window_attention (K2w) takes CUDA "
                           "tensors only")
    B, S, Hq, D = q.shape
    L, Bc, T, Hkv, Dc = k_cache.shape
    if not 1 < S <= WINDOW_MAX:
        raise ValueError(f"decode_window_attention takes windows of 2 to "
                         f"{WINDOW_MAX} tokens, got S={S}")
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_window_attention supports head_dim "
                         f"{HEAD_DIMS}, got {D}")
    if (Bc, Dc) != (B, D) or Hq % Hkv or v_cache.shape != k_cache.shape:
        raise ValueError(f"bad shapes q={tuple(q.shape)} "
                         f"cache={tuple(k_cache.shape)}")
    if k_new.shape != (B, S, Hkv, D) or v_new.shape != k_new.shape:
        raise ValueError("k_new / v_new must be [B, S, Hkv, D]")
    if not (q.dtype == k_new.dtype == v_new.dtype == k_cache.dtype
            == v_cache.dtype):
        raise _build.KernelError(
            "decode_window_attention (K2w) takes q, the fresh KV and the "
            f"cache in one dtype (no int8 cache), got q {q.dtype}, cache "
            f"{k_cache.dtype}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("decode_window_attention reads the cache in "
                         "place: it must be contiguous")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range [0, {L})")
    t_len = T if t_len is None else int(t_len)
    if not 0 < t_len <= T:
        raise ValueError(f"t_len must be in (0, {T}], got {t_len}")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    qc = q.contiguous()
    kn, vn = k_new.contiguous(), v_new.contiguous()
    qp = q_pos0[:, 0].to(torch.int32).contiguous()
    s0 = slots[:, 0].to(torch.int32).contiguous()
    kvp = kv_pos.to(torch.int32).contiguous()
    if kvp.shape != (B, T):
        raise ValueError("kv_pos must be [B, T]")
    for t in (qc, k_cache, v_cache, kn, vn):
        if t.data_ptr() % 16:
            raise ValueError("decode_window_attention needs 16-byte "
                             "aligned tensors")
    plan = window_plan(q.dtype, B, Hq, Hkv, D, t_len, S,
                       sms=_build.sm_count(q.device), max_splits=max_splits,
                       cluster=cluster, splits=splits)
    if plan.smem > _build.SMEM_LIMIT:
        raise _build.KernelError(f"decode_window_attention (K2w) needs "
                                 f"{plan.smem} bytes of shared memory")
    impl = ("mma_two_launch" if plan.impl == "mma" and not plan.cluster
            else plan.impl)
    out = torch.empty_like(qc)
    ws = (None if impl == "mma" else
          torch.empty(sp.workspace_numel(B, Hq * S, plan.splits, D),
                      dtype=torch.float32, device=q.device))
    lib = _build.load("window_attention")
    code = lib.llmss_window_attention(
        qc.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), kn.data_ptr(),
        vn.data_ptr(), out.data_ptr(), qp.data_ptr(), kvp.data_ptr(),
        s0.data_ptr(), None if ws is None else ws.data_ptr(), int(layer), B,
        T, t_len, Hq, Hkv, D, S, plan.rows, plan.splits, plan.split_slots,
        _build.dtype_code(q), WINDOW_IMPL_CODES[impl], float(scale),
        _build.stream_ptr(q.device),
    )
    _build.check(code, "decode_window_attention")
    return out


decode_window_attention.launches = 0


def decode_attention_state_ref(q, k_cache, v_cache, q_pos, kv_pos, slots,
                               layer: int, *, scale: float | None = None,
                               window: int | None = None):
    """The plain version of K2's state-out form: the reference's
    ``_online_block`` over layer ``layer`` of the chunk with the slot
    ``slots`` (an index into the chunk, or out of range) excluded; no
    fresh token. Returns fp32 (m, l, acc), m / l ``[B, Hkv, G, 1]``."""
    from llmss_tpu_torch.ops import ring_attention as ring

    C = k_cache.shape[2]
    idx = torch.arange(C, dtype=torch.int32, device=q.device)
    return ring._online_block(
        *ring._init_state(q, k_cache.shape[3]), q, k_cache[layer],
        v_cache[layer], q_pos, kv_pos,
        1.0 / (q.shape[-1] ** 0.5) if scale is None else scale, window,
        exclude=idx[None, :] == slots.to(torch.int32))


def decode_attention_state(
    q: torch.Tensor,  # [B, 1, Hq, D]
    k_cache: torch.Tensor,  # [L, B, C, Hkv, D] a rank's chunk, stale
    v_cache: torch.Tensor,
    q_pos: torch.Tensor,  # [B, 1]
    kv_pos: torch.Tensor,  # [B, C]
    slots: torch.Tensor,  # [B, 1] the pending slot's index in the chunk
    layer: int,
    *,
    scale: float | None = None,
    window: int | None = None,
):
    """Launch K2's state-out form over the whole chunk (bf16 or fp32, a
    cache of q's dtype): one fp32 (m, l, acc) per (row, query head) in
    ``decode_attention_state_ref``'s layout, folded over the splits in the
    launch by split_merge's state form, whichever template wrote the
    splits; no fresh token, and no torch operation after the launch. A head that sees nothing keeps m = min,
    l = 0. Counted in ``decode_attention.launches`` and
    ``decode_attention_state.launches``."""
    tensors = (q, k_cache, v_cache, q_pos, kv_pos, slots)
    if not all(t.is_cuda for t in tensors):
        raise RuntimeError("decode_attention_state (K2) takes CUDA tensors "
                           "only")
    B, S, Hq, D = q.shape
    L, Bc, T, Hkv, Dc = k_cache.shape
    if S != 1 or D not in HEAD_DIMS or (Bc, Dc) != (B, D) or Hq % Hkv \
            or v_cache.shape != k_cache.shape:
        raise ValueError(f"bad shapes q={tuple(q.shape)} "
                         f"cache={tuple(k_cache.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise _build.KernelError(
            "decode_attention_state (K2) takes bf16 or fp32 queries over a "
            f"cache of their dtype, got {q.dtype} over {k_cache.dtype}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("decode_attention_state reads the cache in place: "
                         "it must be contiguous")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range [0, {L})")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    qc = q.contiguous()
    qp = q_pos.to(torch.int32).reshape(B).contiguous()
    sl = slots.to(torch.int32).reshape(B).contiguous()
    kvp = kv_pos.to(torch.int32).contiguous()
    if kvp.shape != (B, T):
        raise ValueError("kv_pos must be [B, C]")
    for t in (qc, k_cache, v_cache):
        if t.data_ptr() % 16:
            raise ValueError("decode_attention_state needs 16-byte aligned "
                             "tensors")
    plan = kernel_plan(q.dtype, B, Hq, Hkv, D, T,
                       sms=_build.sm_count(q.device))
    if plan.smem > _build.SMEM_LIMIT:
        raise _build.KernelError(f"decode_attention_state (K2) needs "
                                 f"{plan.smem} bytes of shared memory")
    n = B * Hq
    # acc [B, Hq, D], then m [B, Hq], then l [B, Hq]
    st = torch.empty(n * (D + 2), dtype=torch.float32, device=q.device)
    # The lanes leave every split's state in the workspace, even unsplit.
    ws = (torch.empty(sp.workspace_numel(B, Hq, plan.splits, D),
                      dtype=torch.float32, device=q.device)
          if plan.impl == "lanes" or sp.merges(plan) else None)
    lib = _build.load("decode_attention")
    code = lib.llmss_decode_attention_state(
        qc.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), qp.data_ptr(),
        kvp.data_ptr(), sl.data_ptr(), None if ws is None else ws.data_ptr(),
        st.data_ptr(), int(layer), B, T, T, Hq, Hkv, D,
        _rows(plan, Hq // Hkv), plan.splits,
        plan.split_slots, _build.dtype_code(q), float(scale), window or 0,
        _build.stream_ptr(q.device), _build.IMPL_CODES[plan.impl],
    )
    _build.check(code, "decode_attention_state")
    decode_attention.launches += 1
    decode_attention_state.launches += 1
    G = Hq // Hkv
    return (st[n * D: n * (D + 1)].view(B, Hkv, G, 1),
            st[n * (D + 1):].view(B, Hkv, G, 1),
            st[: n * D].view(B, Hkv, G, 1, D))


decode_attention_state.launches = 0
