"""The split over the KV axis (flash-decoding) of the decode kernels K2 and
K3 (csrc/decode_attention.cu, csrc/paged_attention.cu at CB = 1), and
which of their two templates a decode call takes.

Both templates read each KV head's slots once per (row, KV head, split)
for a group of its G query heads. The lane template (``"lanes"``,
``"lanes_int8"``) holds each head's fp32 state in registers and takes at
most 8 query rows a block; at G <= ``G_TILE`` that group is the whole KV
head's. Above it, bf16 queries take the tensor-core tile (``"mma"``,
``"mma_int8"``, csrc/attn_tile.cuh), whose 64 flat rows hold up to 64
query heads of one KV head, so StarCoder's 48 heads read their one KV
head once where 6 lane blocks read it 6 times. The tile's split is a
whole number of its 64-slot tiles (``TILE_STEP``), and its states always
go through the merge, which keeps the fresh V in fp32.

An unsplit decode grid has one block per (row, KV head, tile of query
rows) and each block walks its row's whole read. At small batch or at GQA
that leaves most of the H100's 132 SMs idle, and a batch's longest row
sets the kernel's time. The split gives each of those blocks ``S``
siblings along the KV axis: split ``s`` reads slots
``[s * split_slots, (s + 1) * split_slots)`` and writes an fp32 partial
softmax state (m, l, acc); a merge kernel, launched by the same C entry
point, folds the live splits in split order, then the fresh key, and
writes the output (csrc/split_merge.cuh).

``split_plan`` picks ``S`` from shapes the host already knows: K3's
bucketed read ``n_cols * bs`` and K2's ``t_len``, never ``n_blocks``,
which lives on the device, and the card's SM count, which the wrappers
read once per device. So planning needs no host sync, and one bucket
always launches one grid.
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
# Above G_TILE query heads per KV head, bf16 decode queries take the
# tensor-core tile; its splits are whole tiles of TILE_STEP slots and its
# blocks hold TILE_ROWS query heads. chip_smoke.py times both templates at
# G = 1, 4, 8, 16 and 48: on the H100 the lanes win at G = 1 and the tile
# from G = 4 (PERF.md), but G <= 8 stays on the lanes, whose outputs GQA
# models were held to.
G_TILE = 8
TILE_STEP = 64
TILE_ROWS = 64
TILE_IMPLS = ("mma", "mma_int8")


class Plan(NamedTuple):
    """How a K2 / K3 / K4 call launches: the instantiation, the shared
    memory one block of it needs (bytes), the number of splits along the
    KV axis and the slots each split covers (0 for the tensor-core
    instantiation, which does not split)."""

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


def decode_tile(dtype, kv_dtype, G: int, g_tile: int = G_TILE) -> str | None:
    """The tile instantiation a decode call (K2, K3, K4 at CB = 1) takes:
    ``"mma"`` over a bf16 cache and ``"mma_int8"`` over an int8 cache, for
    bf16 queries with more than ``g_tile`` query heads per KV head; None
    (the lane template) otherwise."""
    if dtype != torch.bfloat16 or G <= g_tile:
        return None
    return {torch.bfloat16: "mma", torch.int8: "mma_int8"}.get(kv_dtype)


def decode_tile_plan(impl: str, B: int, Hkv: int, G: int, D: int,
                     n_slots: int, bs: int = 1, *, sms: int,
                     max_splits: int = MAX_SPLITS) -> Plan:
    """The decode tile's plan (``impl`` from ``decode_tile``) for K2
    (``bs`` 1) and K3 / K4 at CB = 1: ``ceil(G / TILE_ROWS)`` blocks per KV
    head, the read split into whole ``TILE_STEP``-slot tiles, and the
    shared memory of the tile (``_build.tile_smem_bytes``) or of its int8
    form."""
    S, split = split_plan(B, Hkv * -(-G // TILE_ROWS), n_slots, bs,
                          step=TILE_STEP, sms=sms, max_splits=max_splits)
    smem = (_build.tile_smem_bytes(D) if impl == "mma"
            else _build.tile_i8_smem_bytes(D))
    return Plan(impl, smem, S, split)


def merges(plan: Plan) -> bool:
    """Whether a decode launch of ``plan`` is followed by the merge kernel:
    a split lane launch, and every decode launch of the tile."""
    return plan.splits > 1 or (plan.impl in TILE_IMPLS and plan.split_slots > 0)


def lane_impl(kv_dtype) -> str:
    """The lane template's instantiation for a cache of ``kv_dtype``:
    ``"lanes_int8"`` (scales folded in) over int8, else ``"lanes"``."""
    return "lanes_int8" if kv_dtype.itemsize == 1 else "lanes"


@functools.lru_cache(maxsize=4096)
def split_plan(B: int, blocks_per_row: int, n_slots: int, bs: int = 1, *,
               step: int, sms: int, max_splits: int = MAX_SPLITS
               ) -> tuple[int, int]:
    """(S, split_slots) for a read of ``n_slots`` slots per row, on a grid
    of ``B * blocks_per_row`` blocks before the split, on a card of ``sms``
    SMs.

    ``split_slots`` is a multiple of ``step`` (the lane loop's slots per
    ring stage) and of ``bs`` (K3's block size; 1 for K2) and covers at
    most ``SPLIT_SLOTS`` slots, unless one such unit is larger. It
    shrinks, one unit at a time, while the grid has fewer than two blocks
    per SM; ``S`` is at most ``max_splits`` (``max_splits=1``: never
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
    while (split > unit and grid * splits(split) < 2 * sms
           and splits(split - unit) <= max_splits):
        split -= unit
    if splits(split) > max_splits:
        split = -(-n_slots // (max_splits * unit)) * unit
    S = splits(split)
    if S == 1:  # one split covers the whole read
        split = max(unit, -(-n_slots // unit) * unit)
    return S, split


def workspace_numel(B: int, Hq: int, S: int, D: int) -> int:
    """fp32 elements of the split kernels' partial states: acc
    ``[B, Hq, S, D]``, then m and l ``[B, Hq, S]``."""
    return B * Hq * S * (D + 2)
