"""KV caches (counterpart: llmss_tpu/engine/cache.py): the dense ring
(:32-173) and the paged block pool with its host ``BlockAllocator``
(:176-557), ``seed_blocks``, which writes a shared prefix's full
blocks into the pool once, and the KV handoff's ``export_blocks`` /
``export_dense_row`` (a row's blocks copied to the host) and
``import_blocks`` (host blocks written into the pool).

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
entry rewrites the slot-0 value it read; with several (prefill, the
speculative verify window) it repeats its row's first kept write, or
rewrites slot 0 in a row with none. Either way no write waits on the device,
so a step that writes several tokens a row can be captured in a graph.

The paged layout keeps KV in one pool of fixed-size blocks shared by every
row, ``[L, N + 1, bs, Hkv, D]``, addressed through per-row ``block_tables
[B, MB]``; logical slot ``s`` of a row lives at ``(block_tables[row, s //
bs], s % bs)``, and ``positions`` stays per LOGICAL slot, so every piece of
dense slot arithmetic carries over. The pool holds one block more than the
``N`` the allocator hands out: block ``N`` is the drop target. A write
through a sentinel table entry (``>= N``) or to an out-of-range logical
slot is routed there with ``torch.where`` instead of being filtered out,
so no paged write waits on the device, and nothing ever reads block ``N``.

On a mesh each rank holds its part of the dense ring (``mesh_layout``:
rows over dp, ring chunks over sp, KV heads over tp), with global slots
``[c * T_local, (c + 1) * T_local)`` on sp rank ``c``.

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


class MeshLayout(NamedTuple):
    """How a dense cache lies on a mesh (the reference's
    ``cache_specs_for``, cache.py:95-130): its rows split over dp only when
    dp divides the batch, its ring over sp only when sp divides the
    length, its KV heads over tp when tp divides them (else, MQA,
    replicated); every other axis replicates it. ``batch``, ``max_len``
    and ``n_kv_heads`` are this rank's."""

    batch: int
    max_len: int
    n_kv_heads: int
    batch_dp: bool
    seq_sp: bool


def mesh_layout(mesh, *, batch: int, max_len: int,
                n_kv_heads: int) -> MeshLayout:
    dp, sp, tp = mesh.shape["dp"], mesh.shape["sp"], mesh.shape["tp"]
    batch_dp = batch % dp == 0
    seq_sp = sp > 1 and max_len % sp == 0
    return MeshLayout(
        batch // dp if batch_dp else batch,
        max_len // sp if seq_sp else max_len,
        n_kv_heads // tp if n_kv_heads % tp == 0 else n_kv_heads,
        batch_dp, seq_sp)


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
    shape = keep.shape + (1,) * (new.dim() - lead - 2)
    if S == 1:
        # One write per row: a dropped row rewrites what slot 0 holds.
        idx = torch.where(keep, slots, 0).long()
        cur = buf[pre + (rows, idx)]
        buf[pre + (rows, idx)] = torch.where(keep.view(shape), new, cur)
        return
    # A dropped entry repeats its row's first kept entry (slot and value),
    # or, in a row with none, rewrites what slot 0 holds: every slot a
    # write targets twice gets one value, and no boolean indexing (a host
    # sync, which a captured step could not hold) is needed.
    any_kept = keep.any(1, keepdim=True).expand(B, S)
    first = keep.to(torch.int32).argmax(1, keepdim=True).expand(B, S)
    src = torch.where(keep, torch.arange(S, device=slots.device), first)
    idx = torch.where(any_kept, slots.gather(1, src), 0).long()
    vals = torch.where(any_kept.view(shape), new[pre + (rows, src)],
                       buf[pre + (rows, idx)])
    buf[pre + (rows, idx)] = vals


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


def seed_blocks(cache: PagedKVCache, prefix, block_ids: torch.Tensor) -> None:
    """Materialize a prefix's full blocks in the pool, in place (the
    reference's ``_seed_blocks_impl``, scheduler.py:370): the first
    ``nf * bs`` tokens of ``prefix``'s segment (k, v and, int8, their
    scales, as stored), block by block, at ``block_ids`` [nf]. Rows
    reference these blocks through their tables and never write them."""
    bs = cache.block_size
    nf = block_ids.shape[0]
    idx = block_ids.long()
    for pool, seg in ((cache.k, prefix.k), (cache.v, prefix.v),
                      (cache.k_scale, prefix.k_scale),
                      (cache.v_scale, prefix.v_scale)):
        if pool is not None:
            seg = seg[:, : nf * bs]
            pool[:, idx] = seg.reshape(
                (seg.shape[0], nf, bs) + tuple(seg.shape[2:])).to(pool.dtype)


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


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host, complete when this returns: on CUDA through
    pinned memory, waiting on an event behind the copy (only the copy's
    own stream position, never a later launch); a CPU tensor as is."""
    if not t.is_cuda:
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return host


def export_blocks(cache: PagedKVCache, block_ids, n_tokens: int) -> dict:
    """Host copy of one row's first ``len(block_ids)`` logical blocks, the
    payload a prefill replica hands to a decode replica (the reference's
    ``export_blocks``, cache.py:379). A pure read of the pool: tables,
    positions and refcounts are untouched, so copy-on-write prefix blocks
    export while other rows keep them. Slots at logical position >=
    ``n_tokens`` are zeroed (a previous tenant's or a later decode step's
    bytes would make the payload nondeterministic). The gather runs on the
    stream after every write enqueued before it, and the copy is complete
    when this returns, so the blocks may go back to the pool at once.

    Returns ``{"k", "v", "k_scale", "v_scale"}``: host tensors ``[L, nb,
    bs, Hkv, D]`` (scales ``[L, nb, bs, Hkv]``, None on a bf16 / fp32
    pool)."""
    ids = [int(b) for b in block_ids]
    nb, bs = len(ids), cache.block_size
    if not 0 < n_tokens <= nb * bs:
        raise ValueError(
            f"n_tokens {n_tokens} outside (0, {nb} blocks * {bs}]")
    idx = torch.tensor(ids, dtype=torch.long).to(cache.k.device)
    live = n_tokens - (nb - 1) * bs  # live slots of the last block

    def grab(pool):
        if pool is None:
            return None
        seg = pool.index_select(1, idx)
        seg[:, nb - 1, live:] = 0
        return _host_copy(seg)

    return {"k": grab(cache.k), "v": grab(cache.v),
            "k_scale": grab(cache.k_scale), "v_scale": grab(cache.v_scale)}


def export_dense_row(cache: KVCache, row: int, n_tokens: int,
                     block_size: int) -> dict:
    """``export_blocks`` for one row of the dense ring (cache.py:420): its
    first ``n_tokens`` slots in the same ``[L, nb, bs, ...]`` layout, the
    tail zero-padded, so dense and paged KV share one blob format. The
    row must not have wrapped past ``n_tokens``."""
    if not 0 < n_tokens <= cache.max_len:
        raise ValueError(f"n_tokens {n_tokens} outside (0, {cache.max_len}]")
    nb = -(-n_tokens // block_size)

    def grab(buf):
        if buf is None:
            return None
        seg = buf[:, row, :n_tokens]
        out = seg.new_zeros((seg.shape[0], nb * block_size)
                            + tuple(seg.shape[2:]))
        out[:, :n_tokens] = seg
        return _host_copy(out.reshape((seg.shape[0], nb, block_size)
                                      + tuple(seg.shape[2:])))

    return {"k": grab(cache.k), "v": grab(cache.v),
            "k_scale": grab(cache.k_scale), "v_scale": grab(cache.v_scale)}


def import_blocks(cache: PagedKVCache, k, v, k_scale, v_scale,
                  block_ids) -> None:
    """Write exported blocks into the pool at ``block_ids`` [nb], in place
    (the reference's ``import_blocks``, cache.py:452); sentinel ids (>=
    N) land in the drop block. Host payloads are staged through pinned
    memory and copied without blocking; the caching host allocator keeps
    the staging buffer until its copy has run."""
    dev = cache.k.device
    N = cache.num_blocks
    idx = torch.clamp(torch.as_tensor(block_ids, dtype=torch.long),
                      max=N).to(dev)
    for pool, seg in ((cache.k, k), (cache.v, v),
                      (cache.k_scale, k_scale), (cache.v_scale, v_scale)):
        if pool is None or seg is None:
            continue
        seg = torch.as_tensor(seg)
        if dev.type == "cuda" and not seg.is_cuda:
            seg = seg.pin_memory().to(dev, non_blocking=True)
        pool.index_copy_(1, idx, seg.to(device=dev, dtype=pool.dtype))


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
        # Idle shared-prefix block sets reclaimed (the batcher's count).
        self.evictions = 0  # guarded_by: self._lock

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

    def record_evictions(self, n: int) -> None:
        with self._lock:
            self.evictions += n
