"""KV caches (counterpart: llmss_tpu/engine/cache.py): the dense ring
(:32-173) and the paged block pool with its host ``BlockAllocator``
(:176-557).

A fixed ``[L, B, T, Hkv, D]`` buffer per K and V; each token's KV goes to
slot ``position % T`` and a per-slot ``positions`` array (-1 = empty) both
validates slots and orders them for the causal mask, so ring order and
position order may differ.

Unlike the reference, whose functional updates are made cheap by buffer
donation, the port updates the cache **in place**: ``write_positions``,
``write_layer`` and ``write_stacked`` mutate the tensors they are given.
The reference's scatters silently drop out-of-range slots (done rows write
to slot ``T``); torch indexing would raise on such an index and wrap a
negative one, so the writes here drop those entries explicitly and never
write new data to a clamped slot. With one token per row (decode) a dropped
entry rewrites the slot-0 value it read, which keeps the step free of host
syncs; with several tokens per row the dropped entries are filtered out.

The paged layout keeps KV in one pool of fixed-size blocks shared by every
row, ``[L, N + 1, bs, Hkv, D]``, addressed through per-row ``block_tables
[B, MB]``; logical slot ``s`` of a row lives at ``(block_tables[row, s //
bs], s % bs)``, and ``positions`` stays per LOGICAL slot, so every piece of
dense slot arithmetic carries over. The pool holds one block more than the
``N`` the allocator hands out: block ``N`` is the drop target. A write
through a sentinel table entry (``>= N``) or to an out-of-range logical
slot is routed there with ``torch.where`` instead of being filtered out,
so no paged write waits on the device, and nothing ever reads block ``N``.

The int8 cache (``dtype=torch.int8``, the reference's ``kv_dtype="int8"``)
stores K and V quantized per (token, head) over the head dim, with fp32
scales beside them (``k_scale`` / ``v_scale``: ``[L, B, T, Hkv]`` dense,
``[L, N + 1, bs, Hkv]`` paged, drop block included). Every write quantizes
only the fresh tokens and scatters values and scales through the same
slots, so untouched slots are never round-tripped.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import torch


class KVCache(NamedTuple):
    k: torch.Tensor  # [L, B, T, Hkv, D]
    v: torch.Tensor  # [L, B, T, Hkv, D]
    positions: torch.Tensor  # [B, T] int32, -1 = empty slot
    # Dequant scales, set iff k / v are int8: value = int8 * scale.
    k_scale: torch.Tensor | None = None  # [L, B, T, Hkv] fp32
    v_scale: torch.Tensor | None = None

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization per (..., head) over the last dim, in
    fp32 (the reference's ``quantize_kv``, bit for bit): scale
    ``max(amax, 1e-8) / 127``, values rounded half to even and clipped to
    +-127. Returns (int8 values, fp32 scales of ``x.shape[:-1]``). All
    device ops: nothing is read back to the host."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """``q * scale`` in ``dtype``, the scale rounded to ``dtype`` first, as
    the reference does."""
    return q.to(dtype) * scale[..., None].to(dtype)


def _zeros_and_scales(shape, dtype, device):
    """K and V buffers of ``shape``, and their fp32 scales (``shape[:-1]``)
    when ``dtype`` is int8, else None."""
    kv = [torch.zeros(shape, dtype=dtype, device=device) for _ in range(2)]
    sc = ([torch.zeros(shape[:-1], dtype=torch.float32, device=device)
           for _ in range(2)] if dtype == torch.int8 else [None, None])
    return kv, sc


def init_cache(
    *, n_layers: int, batch: int, max_len: int, n_kv_heads: int,
    head_dim: int, dtype: torch.dtype, device: torch.device,
) -> KVCache:
    """Zeroed ring; ``dtype=torch.int8`` adds zeroed scales."""
    (k, v), (ks, vs) = _zeros_and_scales(
        (n_layers, batch, max_len, n_kv_heads, head_dim), dtype, device)
    return KVCache(
        k=k, v=v,
        positions=torch.full((batch, max_len), -1, dtype=torch.int32,
                             device=device),
        k_scale=ks, v_scale=vs,
    )


def _scatter(buf: torch.Tensor, slots: torch.Tensor, new: torch.Tensor,
             lead: int) -> None:
    """``buf[..., b, slots[b, s]] = new[..., b, s]`` over the ``lead``
    leading dims, dropping entries whose slot is outside ``[0, T)``."""
    B, S = slots.shape
    T = buf.shape[lead + 1]
    keep = (slots >= 0) & (slots < T)
    rows = torch.arange(B, device=slots.device)[:, None].expand(B, S)
    new = new.to(buf.dtype)
    pre = (slice(None),) * lead
    if S == 1:
        # One write per row: a dropped row rewrites what slot 0 holds.
        idx = torch.where(keep, slots, 0).long()
        shape = keep.shape + (1,) * (new.dim() - lead - 2)
        cur = buf[pre + (rows, idx)]
        buf[pre + (rows, idx)] = torch.where(keep.view(shape), new, cur)
    else:
        buf[pre + (rows[keep], slots[keep].long())] = new[pre + (keep,)]


def write_positions(
    cache_positions: torch.Tensor,  # [B, T], updated in place
    q_positions: torch.Tensor,  # [B, S]
    slots: torch.Tensor,  # [B, S]
) -> torch.Tensor:
    """Record the positions of newly written tokens. Returns
    ``cache_positions``."""
    _scatter(cache_positions, slots, q_positions, 0)
    return cache_positions


def _scatter_kv(buf, scale, slots, new, lead: int) -> None:
    """``_scatter`` of ``new`` into ``buf``; with a ``scale`` buffer (int8
    storage) ``new`` is quantized first and its scales scattered through
    the same slots."""
    if scale is None:
        _scatter(buf, slots, new, lead)
        return
    q, s = quantize_kv(new)
    _scatter(buf, slots, q, lead)
    _scatter(scale, slots, s, lead)


def write_layer(
    k_cache: torch.Tensor,  # [B, T, Hkv, D] one layer, updated in place
    v_cache: torch.Tensor,
    k_new: torch.Tensor,  # [B, S, Hkv, D]
    v_new: torch.Tensor,
    slots: torch.Tensor,  # [B, S]
    k_scale: torch.Tensor | None = None,  # [B, T, Hkv] iff int8 storage
    v_scale: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter new KV into ring slots (quantized, with its scales, into
    int8 storage)."""
    _scatter_kv(k_cache, k_scale, slots, k_new, 0)
    _scatter_kv(v_cache, v_scale, slots, v_new, 0)
    return k_cache, v_cache


def write_stacked(
    cache: KVCache,
    k_new: torch.Tensor,  # [L, B, S, Hkv, D] fresh KV of every layer
    v_new: torch.Tensor,
    slots: torch.Tensor,  # [B, S]
) -> None:
    """The decode step's single post-layer-loop scatter of every layer's
    fresh KV (quantized here, once, on an int8 cache)."""
    _scatter_kv(cache.k, cache.k_scale, slots, k_new, 1)
    _scatter_kv(cache.v, cache.v_scale, slots, v_new, 1)


# -- paged layout --------------------------------------------------------------


def table_sentinel(num_blocks: int) -> int:
    """Block-table entries >= ``num_blocks`` mean "unmapped": POSITIVE out
    of range, so writes through them are dropped and gathers clamp them to
    a real block whose values the position mask (-1 = empty) rejects."""
    return num_blocks


class PagedKVCache(NamedTuple):
    k: torch.Tensor  # [L, N + 1, bs, Hkv, D] block pool; block N = drop target
    v: torch.Tensor
    block_tables: torch.Tensor  # [B, MB] int32; >= N = unmapped sentinel
    positions: torch.Tensor  # [B, MB * bs] int32 per LOGICAL slot, -1 = empty
    # Dequant scales, set iff k / v are int8 (drop block included).
    k_scale: torch.Tensor | None = None  # [L, N + 1, bs, Hkv] fp32
    v_scale: torch.Tensor | None = None

    @property
    def max_len(self) -> int:
        """Logical capacity per row (slot arithmetic), not the pool size."""
        return self.positions.shape[1]

    @property
    def block_size(self) -> int:
        return self.k.shape[2]

    @property
    def num_blocks(self) -> int:
        """Blocks the allocator hands out (the drop block not counted)."""
        return self.k.shape[1] - 1

    @property
    def max_blocks(self) -> int:
        return self.block_tables.shape[1]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_paged_cache(
    *, n_layers: int, batch: int, max_len: int, n_kv_heads: int,
    head_dim: int, dtype: torch.dtype, device: torch.device,
    block_size: int = 16, num_blocks: int | None = None,
    identity_tables: bool = True,
) -> PagedKVCache:
    """Zeroed paged cache (with zeroed scales for ``dtype=torch.int8``).
    ``identity_tables=True`` maps row ``b`` to blocks ``[b*MB, (b+1)*MB)``
    (the engine's own generate paths, no allocator); the scheduler passes
    False and drives the all-sentinel tables from its
    ``BlockAllocator``."""
    if max_len % block_size:
        raise ValueError(
            f"max_len {max_len} must be a multiple of block_size {block_size}"
        )
    mb = max_len // block_size
    n = num_blocks if num_blocks is not None else batch * mb
    if identity_tables and n < batch * mb:
        raise ValueError(f"identity tables need {batch * mb} blocks, pool has {n}")
    (k, v), (ks, vs) = _zeros_and_scales(
        (n_layers, n + 1, block_size, n_kv_heads, head_dim), dtype, device)
    if identity_tables:
        tables = torch.arange(batch * mb, dtype=torch.int32,
                              device=device).reshape(batch, mb)
    else:
        tables = torch.full((batch, mb), table_sentinel(n), dtype=torch.int32,
                            device=device)
    return PagedKVCache(
        k=k, v=v, block_tables=tables,
        positions=torch.full((batch, max_len), -1, dtype=torch.int32,
                             device=device),
        k_scale=ks, v_scale=vs,
    )


_I32_MAX = torch.iinfo(torch.int32).max


def logical_to_physical(
    block_tables: torch.Tensor,  # [B, MB]
    slots: torch.Tensor,  # [B, S] logical slot per new token
    block_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(block [B, S], offset [B, S])`` through the row's table. Unmapped
    entries pass the sentinel through, and out-of-range logical slots (>=
    MB*bs: done rows, dead chunk columns) map to int32 max, as in the
    reference: both are dropped by the writes."""
    MB = block_tables.shape[1]
    slots = slots.to(torch.int32)
    idx = torch.clamp(torch.div(slots, block_size, rounding_mode="floor"),
                      max=MB - 1).long()
    blk = torch.gather(block_tables.to(torch.int32), 1, idx)
    blk = torch.where(slots < MB * block_size, blk, _I32_MAX)
    return blk, slots % block_size


def gather_block_view(
    pool_layer: torch.Tensor,  # [N + 1, bs, ...] one layer of the pool
    block_tables: torch.Tensor,  # [B, MB]
    n_blocks: int | None = None,  # read only the first n_blocks table columns
) -> torch.Tensor:
    """A row-indirected logical copy ``[B, n_blocks*bs, ...]`` of one pool
    layer. Sentinel entries clamp to the last real block ``N - 1``, as in
    the reference; their values are masked by positions."""
    bt = block_tables if n_blocks is None else block_tables[:, :n_blocks]
    bt = torch.clamp(bt, max=pool_layer.shape[0] - 2).long()
    view = pool_layer[bt]  # [B, nb, bs, ...]
    return view.reshape((view.shape[0], view.shape[1] * view.shape[2])
                        + tuple(view.shape[3:]))


def _pool_index(pool: torch.Tensor, block_tables, slots, block_size):
    """Flat ``block * bs + offset`` per written token [B*S], with every
    dropped entry routed to the drop block ``N`` (the pool's last)."""
    N = pool.shape[1] - 1
    blk, off = logical_to_physical(block_tables, slots, block_size)
    blk = torch.where(blk < N, blk, N)
    return (blk.long() * block_size + off.long()).reshape(-1)


def _pool_put(pool: torch.Tensor, idx: torch.Tensor, new: torch.Tensor,
              block_size: int) -> None:
    """``pool`` viewed as [L, (N + 1) * bs, ...], its entries ``idx`` set
    to ``new`` [L, B, S, ...]."""
    L = pool.shape[0]
    flat = pool.view((L, pool.shape[1] * block_size) + tuple(pool.shape[3:]))
    flat[:, idx] = new.reshape((L, idx.shape[0]) + tuple(new.shape[3:])).to(
        pool.dtype)


def paged_write_stacked(
    pool: torch.Tensor,  # [L, N + 1, bs, ...] updated in place
    new: torch.Tensor,  # [L, B, S, ...] fresh values of every layer
    block_tables: torch.Tensor,  # [B, MB]
    slots: torch.Tensor,  # [B, S] logical slots
    block_size: int,
    scale: torch.Tensor | None = None,  # [L, N + 1, bs, Hkv] iff int8 pool
) -> None:
    """One all-layer scatter into the pool (the reference's ``pool.at[:,
    blk, off].set(new, mode="drop")``), in place and without a host sync:
    writes through unmapped entries or to out-of-range slots land in the
    drop block. With a ``scale`` pool, ``new`` is quantized and its scales
    land in the same (block, offset) entries."""
    idx = _pool_index(pool, block_tables, slots, block_size)
    if scale is not None:
        new, s = quantize_kv(new)
        _pool_put(scale, idx, s, block_size)
    _pool_put(pool, idx, new, block_size)


def paged_write_layer(
    pool: torch.Tensor, layer: int, new: torch.Tensor, block_tables,
    slots, block_size: int, scale: torch.Tensor | None = None,
) -> None:
    """``paged_write_stacked`` for one layer: ``new`` is [B, S, ...]."""
    paged_write_stacked(
        pool[layer:layer + 1], new[None], block_tables, slots, block_size,
        None if scale is None else scale[layer:layer + 1])


def write_slots(
    buf: torch.Tensor,  # [B, T] updated in place
    slots: torch.Tensor,  # [B, S]
    values: torch.Tensor,  # [B, S]
) -> None:
    """``buf[b, slots[b, s]] = values[b, s]``, dropping slots outside
    ``[0, T)``, without a host sync: a one-hot match of every written slot
    against the row's T slots (live slots of one row are distinct)."""
    T = buf.shape[1]
    match = slots[:, :, None] == torch.arange(T, device=buf.device)[None, None]
    hit = match.any(1)
    val = (match * values[:, :, None].to(buf.dtype)).sum(1)
    buf.copy_(torch.where(hit, val.to(buf.dtype), buf))


class BlockAllocator:
    """Host-side free list and refcounts for the global block pool.

    Runs on the scheduler's thread but is read by metrics threads, so its
    state is lock-guarded. LIFO free list: the most recently freed block is
    handed out first."""

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks
        self._lock = threading.Lock()
        self._free_list = list(range(num_blocks - 1, -1, -1))  # guarded_by: self._lock
        self._refs: dict[int, int] = {}  # guarded_by: self._lock

    @property
    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free_list)

    @property
    def blocks_in_use(self) -> int:
        with self._lock:
            return self.num_blocks - len(self._free_list)

    def alloc(self, n: int) -> list[int] | None:
        """Take ``n`` blocks at refcount 1, or None (never a partial
        grant) when the pool cannot cover them."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        with self._lock:
            if n > len(self._free_list):
                return None
            out = [self._free_list.pop() for _ in range(n)]
            for b in out:
                self._refs[b] = 1
            return out

    def incref(self, blocks: list[int]) -> None:
        with self._lock:
            for b in blocks:
                self._refs[b] += 1

    def free(self, blocks: list[int]) -> int:
        """Drop one reference per block; blocks reaching zero return to the
        free list. Returns how many were released."""
        released = 0
        with self._lock:
            for b in blocks:
                r = self._refs[b] - 1
                if r:
                    self._refs[b] = r
                else:
                    del self._refs[b]
                    self._free_list.append(b)
                    released += 1
        return released

    def refcount(self, block: int) -> int:
        with self._lock:
            return self._refs.get(block, 0)

    def largest_free_run(self) -> int:
        """Longest run of consecutive free block ids (== free_blocks when
        the pool is unfragmented)."""
        with self._lock:
            ids = sorted(self._free_list)
        best = cur = 1 if ids else 0
        for a, b in zip(ids, ids[1:]):
            cur = cur + 1 if b == a + 1 else 1
            best = max(best, cur)
        return best
