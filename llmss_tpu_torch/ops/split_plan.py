"""The split over the KV axis (flash-decoding) of the decode kernels K2 and
K3 (csrc/decode_attention.cu, csrc/paged_attention.cu at CB = 1), and
which of their three templates a decode call takes.

Every template reads each KV head's slots once per (row, KV head, split)
for a group of its G query heads. The lane template (``"lanes"``,
``"lanes_int8"``) holds each head's fp32 state in registers and takes at
most 8 query rows a block. The group tile (``"group"``, csrc/
group_tile.cuh, K2w's window tile at one query a row) puts the group on
the tensor cores with rows per block following G (16 a row warp, at most
64), Q in registers, a three-stage ring, its splits folded with the
fresh key by the merge (a cluster fold, which K2w takes, lost to the
merge on K2 and K3 on the H100). The 64-row tile (``"mma"``, ``"mma_int8"``, csrc/attn_tile.cuh) holds 64
flat rows and always goes through the merge; an int8 cache keeps it
above 8 heads per KV head, where its int8 tiles are widened to bf16.
Both tiles' splits are whole 64-slot tiles (``TILE_STEP``), and their
merges keep the fresh V in fp32.

An unsplit decode grid has one block per (row, KV head, tile of query
rows) and each block walks its row's whole read. At small batch or at GQA
that leaves most of the H100's 132 SMs idle, and a batch's longest row
sets the kernel's time. The split gives each of those blocks ``S``
siblings along the KV axis: split ``s`` reads slots
``[s * split_slots, (s + 1) * split_slots)`` and leaves an fp32 partial
softmax state (m, l, acc); a merge kernel, launched by the same C entry
point, folds the splits in split order, then the fresh key, and writes
the output (csrc/split_merge.cuh).

``split_plan`` (and K2w's ``group_split``) pick ``S`` from shapes the host
already knows: K3's bucketed read ``n_cols * bs`` and K2's ``t_len``,
never ``n_blocks``, which lives on the device, and the card's SM count,
which the wrappers read once per device. So planning needs no host sync,
and one bucket always launches one grid.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from llmss_tpu_torch.ops import _build

# A split covers at most SPLIT_SLOTS slots (128 led 256 and 512, summed
# over nine decode cases timed on the H100, PERF.md), and the plan shrinks
# the split until the grid has two blocks per SM or the split is one unit.
SPLIT_SLOTS = 128
MAX_SPLITS = 16
# A read of at most SHORT_READ slots is split only when its unsplit grid
# leaves at least half the SMs idle: on a grid that nearly fills the card
# the merge costs more than the shorter walk saves (K2 at the engine's
# 192-slot bucket, 128 blocks: split 0.0069 ms, unsplit 0.0064, PERF.md).
SHORT_READ = 2 * SPLIT_SLOTS
H100_SMS = 132  # SMs of an H100 SXM: the count a plan made off the card uses
# Slots whose positions (and, for K3, table entries) a block stages in
# shared memory at a time: csrc/split_merge.cuh ``kStage``.
STAGE_SLOTS = 512
NWARP = 8  # warps of a lane-template block
STEPS = 2  # steps of SPW slots per warp in one ring stage (``kSteps``)
# The int8 ring (``LaneRing<int8_t>``): its stages, and the slots of a
# window whose scales each warp stages beside them.
INT8_STAGES = 6
INT8_SCALE_SLOTS = STAGE_SLOTS // NWARP
# bf16 decode queries over a bf16 cache with at least G_TILE query heads
# per KV head take the group tile, up to GROUP_MAX_G heads (above it the
# 64-row tile); fewer take the lanes. chip_smoke.py times the three
# templates, forced, at G = 1, 2, 3, 4, 7, 8, 16 and 48 for K2 and K3
# (its g_tile_lanes_vs_tile line; kernel_ab.py --templates; PERF.md). On
# the H100 the group tile beat the lanes on both from G = 2 (K2 0.0063
# against 0.0069 ms, K3 0.0187 against 0.0199), not at G = 1 (0.0082
# against 0.0060, 0.0343 against 0.0262), and beat the 64-row tile at
# G = 16 (K2 0.0055 against 0.0064, K3 0.0070 against 0.0083) but not on
# K2 at G = 48 (0.0068 against 0.0064; K3 0.0092 against 0.0094):
# StarCoder keeps the 64-row tile. Over an int8 cache the 64-row tile's
# int8 form takes G > INT8_G_TILE and the int8 lanes the rest, as the int8
# cache was measured and held. The tiles' splits are whole tiles of
# TILE_STEP slots, the 64-row tile's blocks hold TILE_ROWS query heads.
G_TILE = 2
GROUP_MAX_G = 16
INT8_G_TILE = 8
TILE_STEP = 64
TILE_ROWS = 64
TILE_IMPLS = ("mma", "mma_int8")
# The templates a decode call can be forced onto (chip_smoke.py times each
# at the G_TILE cases).
TEMPLATES = ("lanes", "mma", "group")
# The group tile (csrc/group_tile.cuh): 16 rows a row warp (one mma A
# fragment), at most GROUP_ROW_WARPS row warps a block (more rows take
# more blocks), each with 4 slot-parallel warps at one row warp, else 2.
# K2's and K3's plan splits the read as ``split_plan`` does, into whole
# 64-slot tiles of at most SPLIT_SLOTS, shrunk while the grid has fewer
# than GROUP_PER_SM blocks per SM, and folds the splits by the merge: on
# the H100 the merge beat the cluster fold at 4 and 8 splits on every K2
# and K3 case timed, and was within 1% of it at 2 (Qwen2-7B's K2 over the
# whole ring at 8 splits: 0.0069 against 0.0089 ms; K3 at the serve shape
# 0.0098 against 0.0106), and 8
# splits of 128 slots beat the 16 of 64 that two blocks per SM would take
# (K3 at Llama-2-7B's GQA shape: 0.0124 against 0.0156; kernel_ab.py
# --templates, PERF.md). K2w's plan (``group_split``) keeps its splits
# within one cluster of at most GROUP_MAX_CLUSTER (the portable size) and
# one round of resident blocks, and splits a read of at most
# GROUP_SHORT_TILES tiles only when the unsplit grid leaves half the SMs
# idle, as SHORT_READ.
GROUP_TILE_ROWS = 16
GROUP_ROW_WARPS = 4
GROUP_PER_SM = 1
GROUP_MAX_CLUSTER = 8
GROUP_SHORT_TILES = 8


# K4 at CB > 1 (the chunk tile, csrc/chunk_tile.cuh) splits a row's read
# into whole 64-slot tiles and table columns, at least CHUNK_SPLIT_SLOTS
# slots a split and at most CHUNK_MAX_SPLITS splits, and only as far as its
# (row, KV head) pairs, each walked by S blocks, cover the card's SMs once:
# a split block pays ~5 us of set-up and a merge, which a grid of many
# rows and heads does not win back (on the H100, kernel_ab.py --templates,
# PERF.md: k4_serve_mixed, 256 pairs, 0.0554 ms unsplit against 0.0629 at
# 4 splits; k4_ring_wrap, 96 pairs, 0.0536 at 2 against 0.0905 unsplit;
# StarCoder's 8 pairs 0.0410 at 4 against 0.0635). The workspace holds
# [B, CB, Hq, S, D + 2] fp32: at 4 splits and the serve shape (8 rows at
# CB 128, 32 heads of 128) 68 MB, 3% of that phase's 2.1 GB pool.
CHUNK_SPLIT_SLOTS = 256
CHUNK_MAX_SPLITS = 4


class Plan(NamedTuple):
    """How a K2 / K3 / K4 call launches: the instantiation, the shared
    memory one block of it needs (bytes), the number of splits along the
    KV axis and the slots each split covers."""

    impl: str
    smem: int
    splits: int
    split_slots: int


def lane_step(D: int) -> int:
    """Slots one ring stage of the lane template covers (``Cfg::SLOTS``):
    8 warps, 32 / (D / 8) slots per warp and step, ``STEPS`` steps."""
    return NWARP * (32 // (D // 8)) * STEPS


def stage_smem_bytes(bs: int) -> int:
    """Shared memory of the staged positions, and for a paged read
    (``bs > 1``) the staged table entries of those slots."""
    cols = STAGE_SLOTS // bs + 2 if bs > 1 else 0
    return 4 * (STAGE_SLOTS + cols)


def lane_region_bytes(elem_size: int, rows: int, D: int) -> int:
    """Shared memory of the lane template's K/V rings (``LaneRing``), which
    the per-warp fp32 accumulators ``[8][rows][D]`` reuse after the KV
    loop. A lane holds 8 elements of a slot's K row and 8 of its V row in
    each of a stage's ``STEPS`` steps: per warp 4 stages of 16-bit rows (16
    bytes a lane) or 2 of fp32 rows (32 bytes); over an int8 cache
    ``INT8_STAGES`` stages of 8 bytes a lane, and the fp32 K and V scales
    of the warp's ``INT8_SCALE_SLOTS`` slots of a window (one copy per
    slot)."""
    if elem_size == 1:
        ring = NWARP * (INT8_STAGES * STEPS * 2 * 32 * 8 + 2 * INT8_SCALE_SLOTS * 4)
    else:
        stages, lane_bytes = {4: (2, 32), 2: (4, 16)}[elem_size]
        ring = NWARP * stages * STEPS * 2 * 32 * lane_bytes
    return max(ring, 4 * NWARP * rows * D)


def decode_tile(dtype, kv_dtype, G: int, force: str | None = None
                ) -> str | None:
    """The tile a decode call (K2, K3, K4 at CB = 1) takes, None for the
    lane template. bf16 queries only: over a bf16 cache ``"group"`` at
    ``G_TILE <= G <= GROUP_MAX_G`` and ``"mma"`` above; over an int8 cache
    ``"mma_int8"`` above ``INT8_G_TILE``. ``force`` (one of ``TEMPLATES``)
    puts a bf16 call on that template whatever G (chip_smoke.py times
    them side by side); an int8 cache has no group tile."""
    if dtype != torch.bfloat16 or kv_dtype not in (torch.bfloat16, torch.int8):
        return None
    if force is not None:
        if force not in TEMPLATES or (kv_dtype == torch.int8 and force == "group"):
            raise _build.KernelError(f"no {force} template over a {kv_dtype} cache")
        if force == "lanes":
            return None
        return force + ("_int8" if kv_dtype == torch.int8 else "")
    if kv_dtype == torch.int8:
        return "mma_int8" if G > INT8_G_TILE else None
    if G < G_TILE:
        return None
    return "group" if G <= GROUP_MAX_G else "mma"


def decode_tile_plan(impl: str, B: int, Hkv: int, G: int, D: int,
                     n_slots: int, bs: int = 1, *, sms: int,
                     max_splits: int = MAX_SPLITS) -> Plan:
    """The plan of a decode tile (``impl`` from ``decode_tile``) for K2
    (``bs`` 1) and K3 / K4 at CB = 1. The 64-row tile: ``ceil(G /
    TILE_ROWS)`` blocks per KV head, the read split by ``split_plan`` into
    whole ``TILE_STEP``-slot tiles, the shared memory of the tile
    (``_build.tile_smem_bytes``) or of its int8 form. The group tile:
    ``group_rows(G)`` rows a block, the read split by ``split_plan`` at
    ``GROUP_PER_SM`` blocks per SM and folded by the merge."""
    if impl == "group":
        rw, _ = group_warps(G)
        S, split = split_plan(B, Hkv * -(-G // group_rows(G)), n_slots, bs,
                              step=TILE_STEP, sms=sms, max_splits=max_splits,
                              per_sm=GROUP_PER_SM)
        return Plan(impl, _build.window_tile_smem_bytes(D, rw), S, split)
    S, split = split_plan(B, Hkv * -(-G // TILE_ROWS), n_slots, bs,
                          step=TILE_STEP, sms=sms, max_splits=max_splits)
    smem = (_build.tile_smem_bytes(D) if impl == "mma"
            else _build.tile_i8_smem_bytes(D))
    return Plan(impl, smem, S, split)


def group_warps(rows: int) -> tuple[int, int]:
    """(row warps, slot-parallel warps per row warp) of a group tile block
    for ``rows`` query rows per KV head: one row warp for each 16 rows, at
    most ``GROUP_ROW_WARPS`` (more rows take more blocks); 4 slot warps at
    one row warp, else 2."""
    rw = min(GROUP_ROW_WARPS, -(-rows // GROUP_TILE_ROWS))
    return rw, 4 if rw == 1 else 2


def group_rows(G: int) -> int:
    """Query rows of a group tile block for ``G`` query heads per KV head
    (the C entries' ``GB`` / ``R`` argument): 16 a row warp."""
    return GROUP_TILE_ROWS * group_warps(G)[0]


def group_split(blocks: int, n_slots: int, smem: int, sms: int,
                max_splits: int, splits: int | None = None
                ) -> tuple[int, int]:
    """(splits, split_slots) of K2w's window tile over ``blocks`` blocks
    before the split: as many splits of whole ``TILE_STEP``-slot tiles as
    keep the grid within the blocks the card holds at once (its ``sms``
    SMs times what one SM's shared memory holds of ``smem``-byte blocks),
    at most ``GROUP_MAX_CLUSTER``, ``max_splits`` and the read's tiles; 1
    when the unsplit grid already fills the card, or when the read has at
    most ``GROUP_SHORT_TILES`` tiles and the grid at least ``sms / 2``
    blocks. A wider read widens each split. ``splits``: that many instead
    (at most ``GROUP_MAX_CLUSTER`` and the read's tiles), for forced
    launches."""
    per_sm = max(1, _build.SM_SHARED_BYTES
                 // (smem + _build.BLOCK_RESERVED_BYTES))
    tiles = max(1, -(-n_slots // TILE_STEP))
    if splits is None:
        short = tiles <= GROUP_SHORT_TILES and 2 * blocks >= sms
        splits = 1 if short else per_sm * sms // blocks
    S = max(1, min(GROUP_MAX_CLUSTER, max_splits, tiles, splits))
    split = -(-tiles // S) * TILE_STEP
    return -(-n_slots // split), split


def merges(plan: Plan, CB: int = 1) -> bool:
    """Whether a launch of ``plan`` at chunk ``CB`` is followed by a merge
    kernel (and needs its workspace): at CB > 1 a split one (chunk_merge);
    at decode a split lane launch and every launch of the tiles
    (split_merge)."""
    if CB > 1:
        return plan.splits > 1
    return (plan.splits > 1 or plan.impl == "group"
            or (plan.impl in TILE_IMPLS and plan.split_slots > 0))


def chunk_plan(n_slots: int, bs: int, *, B: int = 1, Hkv: int = 1,
               sms: int = H100_SMS, max_splits: int = MAX_SPLITS,
               splits: int | None = None) -> tuple[int, int]:
    """(S, split_slots) of K4 at CB > 1 (the chunk tile) for ``B`` rows,
    ``Hkv`` KV heads and a bucketed read of ``n_slots`` slots per row at
    block size ``bs`` on a card of ``sms`` SMs: ceil(sms / (B * Hkv))
    splits, at most ``CHUNK_MAX_SPLITS``, ``max_splits`` (``max_splits=1``:
    one) and one per ``CHUNK_SPLIT_SLOTS`` slots of the read, each split a
    whole number of ``TILE_STEP``-slot tiles and table columns, the splits
    covering the read. ``splits``: aim at that many instead (at most
    ``MAX_SPLITS`` and the read's units), for forced launches. Host values
    only: a bucket always launches one grid, whatever the rows hold."""
    unit = TILE_STEP * bs // math.gcd(TILE_STEP, bs)
    if splits is None:
        splits = min(max_splits, CHUNK_MAX_SPLITS,
                     -(-n_slots // CHUNK_SPLIT_SLOTS), -(-sms // (B * Hkv)))
    want = max(1, min(splits, MAX_SPLITS, -(-n_slots // unit)))
    split = max(unit, -(-(-(-n_slots // want)) // unit) * unit)
    return max(1, -(-n_slots // split)), split


def lane_impl(kv_dtype) -> str:
    """The lane template's instantiation for a cache of ``kv_dtype``:
    ``"lanes_int8"`` (scales folded in) over int8, else ``"lanes"``."""
    return "lanes_int8" if kv_dtype.itemsize == 1 else "lanes"


@functools.lru_cache(maxsize=4096)
def split_plan(B: int, blocks_per_row: int, n_slots: int, bs: int = 1, *,
               step: int, sms: int, max_splits: int = MAX_SPLITS,
               per_sm: int = 2) -> tuple[int, int]:
    """(S, split_slots) for a read of ``n_slots`` slots per row, on a grid
    of ``B * blocks_per_row`` blocks before the split, on a card of ``sms``
    SMs.

    ``split_slots`` is a multiple of ``step`` (the lane loop's slots per
    ring stage, the tiles' 64) and of ``bs`` (K3's block size; 1 for K2)
    and covers at most ``SPLIT_SLOTS`` slots, unless one such unit is
    larger. It shrinks, one unit at a time, while the grid has fewer than
    ``per_sm`` blocks per SM (the lanes and the 64-row tile two, the
    group tile one); ``S`` is at most ``max_splits`` (``max_splits=1``: never
    split). ``S == 1`` when the read fits one split, and for a read of at
    most ``SHORT_READ`` slots whose unsplit grid has at least ``sms / 2``
    blocks."""
    unit = step * bs // math.gcd(step, bs)
    grid = B * blocks_per_row

    def splits(x):
        return max(1, -(-n_slots // x))

    if max_splits == 1 or (n_slots <= SHORT_READ and 2 * grid >= sms):
        return 1, max(unit, -(-n_slots // unit) * unit)
    split = max(unit, SPLIT_SLOTS // unit * unit)
    while (split > unit and grid * splits(split) < per_sm * sms
           and splits(split - unit) <= max_splits):
        split -= unit
    if splits(split) > max_splits:
        split = -(-n_slots // (max_splits * unit)) * unit
    S = splits(split)
    if S == 1:  # one split covers the whole read
        split = max(unit, -(-n_slots // unit) * unit)
    return S, split


def workspace_numel(B: int, Hq: int, S: int, D: int, CB: int = 1) -> int:
    """fp32 elements of the split kernels' partial states: acc
    ``[B, CB, Hq, S, D]``, then m and l ``[B, CB, Hq, S]`` (``CB`` 1 at
    decode)."""
    return B * CB * Hq * S * (D + 2)
