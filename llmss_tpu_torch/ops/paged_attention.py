"""Kernels K3 and K4: attention over the paged block pool
(csrc/paged_attention.cu, one template).

- ``paged_decode_attention`` (K3) replaces
  ``llmss_tpu/ops/pallas_paged_decode.py::paged_decode_attention``:
  single-token decode over layer ``layer`` of the stale pool, merged with
  the fresh token's KV.
- ``ragged_paged_attention`` (K4) replaces
  ``llmss_tpu/ops/pallas_ragged.py::ragged_paged_attention``, its int8
  branch (``quant``) included: a ``CB``-token query chunk per row,
  ``q_len`` of them live.

Four instantiations, chosen by ``kernel_plan`` from the dtypes, ``CB``
and G (query heads per KV head) alone: ``"mma"`` (the tensor-core tile,
csrc/attn_tile.cuh) for a bf16 pool at ``CB > 1``; ``"mma_int8"`` (the
same tile over an int8 pool, csrc/attn_tile_i8.cuh) for bf16 queries at
``CB > 1``; at ``CB == 1`` with bf16 queries and G above
``split_plan.G_TILE`` (8), the same two tiles in decode form (64 query
heads a block, split along the KV axis, always merged, so the fresh V
stays fp32); ``"lanes"`` (the lane template) for fp32 and for ``CB == 1``
otherwise; and ``"lanes_int8"``, the lane template over an int8 pool, for
fp32 queries at every ``CB`` and bf16 queries at ``CB == 1`` and G <= 8.
An int8 pool has ``k_scale`` / ``v_scale`` ``[L, N + 1, bs, Hkv]`` fp32,
and q and fresh KV in fp32 or bf16. The int8
instantiations fold the scales as the Pallas int8 branch does
(pallas_ragged.py:144-145, :163-168): each cache score times its slot's K
scale and P times the V scale before P.V; the fresh keys are never
quantized. The lanes run P.V in fp32; ``"mma_int8"`` widens the int8 tiles
to bf16 (exact) and feeds P x v_scale to the tensor cores as two bf16
terms, hi + lo, which carry it to 2^-16 relative (one bf16 rounding: 2^-8),
the fresh keys' P included. At ``CB == 1`` (K3 over an int8 pool) the lanes
compute what the reference's oracle ``paged_decode_attention(
k_scale_layer=)`` computes; the Pallas K3 takes no scales.
At ``CB == 1`` both templates split the bucketed read ``n_cols * bs``
into ``S`` splits along the KV axis (flash-decoding, ``ops/split_plan.py``,
from the shapes and the card's SM count) and a merge kernel folds them.
K3 is the ``CB == 1`` launch, so an all-decode K4 call at ``CB == 1``
takes the same plan and gives bit-identical outputs. A call the chosen
instantiation cannot take raises ``KernelError``; no other instantiation
is tried. The mma instantiation at ``CB > 1`` applies the fresh keys' P
rounded to bf16, like the cache's; at ``CB == 1`` the merge, and the lane
template, apply fresh V in fp32. K4
writes zeros for
query rows past ``q_len`` that share no kernel tile with a live row (chunk
padding nothing reads); the plain version computes every row, as the
reference's oracle does, so the two agree on live rows. Both wrappers take
CUDA tensors only, launch on the current stream and count their launches
(``paged_decode_attention.launches``, ``ragged_paged_attention.launches``).
The kernels read ``n_blocks`` (occupied table columns per row) from device
memory and walk at most ``n_cols`` columns (the bucketed read).

The ``*_ref`` functions are the plain PyTorch versions (the reference's XLA
oracles, ``ops/attention.py:352`` and ``:503``): gather the row-indirected
logical view of the first ``n_cols`` columns and run the fp32 fresh-KV
softmax over it. They read every gathered slot the positions allow, so they
agree with the kernels when each row's occupied slots are its first
``n_blocks * bs`` logical slots, which the serving path maintains (no row
wraps its ring). The kernels round P to the value dtype before the cache's
P.V, as the Pallas kernels do.
"""

from __future__ import annotations

import torch

from llmss_tpu_torch.engine.cache import gather_block_view
from llmss_tpu_torch.ops import _build
from llmss_tpu_torch.ops import split_plan as sp
from llmss_tpu_torch.ops.attention import (
    fresh_kv_decode_attention, ragged_fresh_kv_attention,
)

HEAD_DIMS = _build.HEAD_DIMS
DTYPES = (torch.bfloat16, torch.float32)


def _views(layer, block_tables, nc, *pools):
    """The logical views of the first ``nc`` table columns of layer
    ``layer`` of each pool (None stays None)."""
    return [None if p is None else gather_block_view(p[layer], block_tables, nc)
            for p in pools]


def paged_decode_attention_ref(
    q, k_pool, v_pool, k_new, v_new, q_pos, kv_pos, block_tables, n_blocks,
    slots, layer: int, *, n_cols: int | None = None,
    scale: float | None = None, window: int | None = None,
    k_scale: torch.Tensor | None = None, v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    del n_blocks  # the oracle reads every gathered slot the mask allows
    nc = block_tables.shape[1] if n_cols is None else n_cols
    T = nc * k_pool.shape[2]
    kv, vv, ks, vs = _views(layer, block_tables, nc, k_pool, v_pool, k_scale,
                            v_scale)
    return fresh_kv_decode_attention(
        q, kv, vv, k_new, v_new, q_pos, kv_pos[:, :T], slots, scale=scale,
        window=window, k_scale=ks, v_scale=vs,
    )


def ragged_paged_attention_ref(
    q, k_pool, v_pool, k_new, v_new, q_pos, q_len, kv_pos, block_tables,
    n_blocks, slot0, layer: int, *, n_cols: int | None = None,
    scale: float | None = None, window: int | None = None,
    k_scale: torch.Tensor | None = None, v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    del n_blocks
    MB = block_tables.shape[1]
    nc = MB if n_cols is None else n_cols
    T = nc * k_pool.shape[2]
    kv, vv, ks, vs = _views(layer, block_tables, nc, k_pool, v_pool, k_scale,
                            v_scale)
    return ragged_fresh_kv_attention(
        q, kv, vv, k_new, v_new, q_pos, q_len, kv_pos[:, :T], slot0,
        MB * k_pool.shape[2], scale=scale, window=window, k_scale=ks,
        v_scale=vs,
    )


def _rows_per_block(n: int) -> int:
    r = 1
    while r < min(n, 8):
        r *= 2
    return r


def kernel_plan(dtype: torch.dtype, CB: int, G: int, D: int, *, B: int = 1,
                Hkv: int = 1, n_slots: int = 0, bs: int = 16,
                sms: int = sp.H100_SMS, max_splits: int = sp.MAX_SPLITS,
                kv_dtype: torch.dtype | None = None,
                g_tile: int = sp.G_TILE) -> sp.Plan:
    """How a K3 / K4 launch over ``B`` rows, ``Hkv`` KV heads and a read of
    ``n_slots`` slots (``n_cols * bs``) goes on a card of ``sms`` SMs:
    at ``CB > 1`` the tensor-core tile (never split), ``"mma"`` over a
    bf16 pool (``kv_dtype``, default ``dtype``) and ``"mma_int8"`` over an
    int8 pool under bf16 queries; at ``CB == 1`` with bf16 queries and
    more than ``g_tile`` query heads per KV head the same tile in decode
    form (``sp.decode_tile``), 64 heads a block, split into whole 64-slot
    tiles and always merged; else the lane template (R <= 8 of the
    ``CB * G`` flat query rows per block): ``"lanes_int8"`` over an int8
    pool, ``"lanes"`` otherwise; split along the KV axis (into at most
    ``max_splits``) only at ``CB == 1``; and the shared memory one block
    needs, in bytes. K3 and an all-decode K4 take one plan."""
    kv_dtype = dtype if kv_dtype is None else kv_dtype
    if kv_dtype == torch.bfloat16 and CB > 1:
        return sp.Plan("mma", _build.tile_smem_bytes(D), 1, 0)
    if kv_dtype == torch.int8 and dtype == torch.bfloat16 and CB > 1:
        return sp.Plan("mma_int8", _build.tile_i8_smem_bytes(D), 1, 0)
    tile = sp.decode_tile(dtype, kv_dtype, G, g_tile) if CB == 1 else None
    if tile is not None:
        return sp.decode_tile_plan(tile, B, Hkv, G, D, n_slots, bs, sms=sms,
                                   max_splits=max_splits)
    R = _rows_per_block(CB * G)
    tiles = -(-CB * G // R)
    S, split = sp.split_plan(B, Hkv * tiles, n_slots, bs,
                             step=sp.lane_step(D), sms=sms,
                             max_splits=max_splits if CB == 1 else 1)
    smem = (sp.lane_region_bytes(kv_dtype.itemsize, R, D)
            + 4 * (3 * 8 * R + 2 * R + R * CB) + sp.stage_smem_bytes(bs))
    return sp.Plan(sp.lane_impl(kv_dtype), smem, S, split)


def _launch(name, q, k_pool, v_pool, k_new, v_new, q_pos, q_len, kv_pos,
            block_tables, n_blocks, slot0, layer, n_cols, scale, window,
            k_scale=None, v_scale=None, max_splits=sp.MAX_SPLITS,
            g_tile=sp.G_TILE):
    """Check the envelope and launch the template; q_len None means K3.
    ``max_splits`` 1 launches the unsplit kernel (which chip_smoke.py times
    beside the plan's); ``g_tile`` moves the decode tile's threshold
    (chip_smoke.py forces either template to time them side by side)."""
    tensors = [q, k_pool, v_pool, k_new, v_new, q_pos, kv_pos, block_tables,
               n_blocks, slot0] + ([q_len] if q_len is not None else [])
    if not all(t.is_cuda for t in tensors):
        raise RuntimeError(f"{name} takes CUDA tensors only")
    B, CB, Hq, D = q.shape
    L, Np, bs, Hkv, Dp = k_pool.shape
    MB = block_tables.shape[1]
    if q.dtype not in DTYPES or not (
        q.dtype == k_new.dtype == v_new.dtype and k_pool.dtype == v_pool.dtype
    ):
        raise _build.KernelError(
            f"{name} takes bf16 or fp32 q and fresh KV of one dtype over a "
            f"pool of that dtype or int8; got {q.dtype}, {k_pool.dtype}, "
            f"{k_new.dtype}")
    sc = _build.scale_args(name, q, k_pool, k_scale, v_scale)
    if D not in HEAD_DIMS or Dp != D or bs % 8 or Hq % Hkv:
        raise _build.KernelError(
            f"{name} envelope: head_dim in {HEAD_DIMS}, block_size % 8 == 0, "
            f"Hq % Hkv == 0; got D={D}, bs={bs}, Hq={Hq}, Hkv={Hkv}")
    if v_pool.shape != k_pool.shape or k_new.shape != (B, CB, Hkv, D) \
            or v_new.shape != k_new.shape:
        raise _build.KernelError(f"{name}: bad pool / fresh KV shapes")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise _build.KernelError(f"{name} reads the pool in place: it must be "
                                 "contiguous")
    if not 0 <= layer < L:
        raise _build.KernelError(f"layer {layer} out of range [0, {L})")
    n_cols = MB if n_cols is None else int(n_cols)
    if not 0 < n_cols <= MB:
        raise _build.KernelError(f"n_cols must be in (0, {MB}], got {n_cols}")
    if window is not None and window <= 0:
        raise _build.KernelError(f"window must be positive, got {window}")
    plan = kernel_plan(q.dtype, CB, Hq // Hkv, D, B=B, Hkv=Hkv,
                       n_slots=n_cols * bs, bs=bs,
                       sms=_build.sm_count(q.device), max_splits=max_splits,
                       kv_dtype=k_pool.dtype, g_tile=g_tile)
    if plan.smem > _build.SMEM_LIMIT:
        raise _build.KernelError(
            f"{name}: the {plan.impl} instantiation at chunk {CB} needs "
            f"{plan.smem} bytes of shared memory")
    if scale is None:
        scale = 1.0 / (D ** 0.5)

    def i32(t, shape):
        return t.to(torch.int32).reshape(shape).contiguous()

    qc, kn, vn = q.contiguous(), k_new.contiguous(), v_new.contiguous()
    qp, sl = i32(q_pos, (B,)), i32(slot0, (B,))
    nb = i32(n_blocks, (B,))
    ql = i32(q_len, (B,)) if q_len is not None else None
    kvp = i32(kv_pos, (B, -1))
    bt = i32(block_tables, (B, MB))
    if kvp.shape[1] != MB * bs:
        raise _build.KernelError(f"kv_pos must be [B, {MB * bs}]")
    for t in (qc, k_pool, v_pool, kn, vn):
        if t.data_ptr() % 16:
            raise _build.KernelError(f"{name} needs 16-byte aligned tensors")
    out = torch.empty_like(qc)
    ws = (torch.empty(sp.workspace_numel(B, Hq, plan.splits, D),
                      dtype=torch.float32, device=q.device)
          if sp.merges(plan) else None)
    lib = _build.load("paged_attention")
    code = lib.llmss_paged_attention(
        qc.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), kn.data_ptr(),
        vn.data_ptr(), out.data_ptr(), qp.data_ptr(),
        ql.data_ptr() if ql is not None else None, kvp.data_ptr(),
        bt.data_ptr(), nb.data_ptr(), sl.data_ptr(),
        ws.data_ptr() if ws is not None else None, int(layer), B, CB, Np,
        bs, MB, n_cols, Hq, Hkv, D, _rows_per_block(CB * (Hq // Hkv)),
        plan.splits, plan.split_slots, _build.dtype_code(q),
        _build.IMPL_CODES[plan.impl], float(scale), window or 0,
        _build.stream_ptr(q.device), sc[0], sc[1],
        _build.dtype_code(k_pool),
    )
    _build.check(code, name)
    return out


def paged_decode_attention(
    q: torch.Tensor,  # [B, 1, Hq, D]
    k_pool: torch.Tensor,  # [L, N + 1, bs, Hkv, D]
    v_pool: torch.Tensor,
    k_new: torch.Tensor,  # [B, 1, Hkv, D]
    v_new: torch.Tensor,
    q_pos: torch.Tensor,  # [B, 1]
    kv_pos: torch.Tensor,  # [B, MB*bs]
    block_tables: torch.Tensor,  # [B, MB]
    n_blocks: torch.Tensor,  # [B]
    slots: torch.Tensor,  # [B, 1]
    layer: int,
    *,
    n_cols: int | None = None,
    scale: float | None = None,
    window: int | None = None,
    k_scale: torch.Tensor | None = None,  # [L, N + 1, bs, Hkv] iff int8
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch K3 (the template at CB = 1); returns [B, 1, Hq, D]."""
    if q.shape[1] != 1:
        raise _build.KernelError(f"paged_decode_attention is single-token, "
                                 f"got S={q.shape[1]}")
    out = _launch("paged_decode_attention (K3)", q, k_pool, v_pool, k_new,
                  v_new, q_pos, None, kv_pos, block_tables, n_blocks, slots,
                  layer, n_cols, scale, window, k_scale, v_scale)
    paged_decode_attention.launches += 1
    return out


def ragged_paged_attention(
    q: torch.Tensor,  # [B, CB, Hq, D]
    k_pool: torch.Tensor,  # [L, N + 1, bs, Hkv, D]
    v_pool: torch.Tensor,
    k_new: torch.Tensor,  # [B, CB, Hkv, D]
    v_new: torch.Tensor,
    q_pos: torch.Tensor,  # [B]
    q_len: torch.Tensor,  # [B]
    kv_pos: torch.Tensor,  # [B, MB*bs]
    block_tables: torch.Tensor,  # [B, MB]
    n_blocks: torch.Tensor,  # [B]
    slot0: torch.Tensor,  # [B]
    layer: int,
    *,
    n_cols: int | None = None,
    scale: float | None = None,
    window: int | None = None,
    k_scale: torch.Tensor | None = None,  # [L, N + 1, bs, Hkv] iff int8
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch K4; returns [B, CB, Hq, D] (rows past q_len are finite
    padding: zeros, or the reference's values where they share a tile with
    live rows)."""
    out = _launch("ragged_paged_attention (K4)", q, k_pool, v_pool, k_new,
                  v_new, q_pos, q_len, kv_pos, block_tables, n_blocks, slot0,
                  layer, n_cols, scale, window, k_scale, v_scale)
    ragged_paged_attention.launches += 1
    return out


paged_decode_attention.launches = 0
ragged_paged_attention.launches = 0
