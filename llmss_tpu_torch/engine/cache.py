"""Preallocated ring-buffer KV cache (counterpart: llmss_tpu/engine/cache.py:32-173).

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
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class KVCache(NamedTuple):
    k: torch.Tensor  # [L, B, T, Hkv, D]
    v: torch.Tensor  # [L, B, T, Hkv, D]
    positions: torch.Tensor  # [B, T] int32, -1 = empty slot

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


def init_cache(
    *, n_layers: int, batch: int, max_len: int, n_kv_heads: int,
    head_dim: int, dtype: torch.dtype, device: torch.device,
) -> KVCache:
    shape = (n_layers, batch, max_len, n_kv_heads, head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        positions=torch.full((batch, max_len), -1, dtype=torch.int32,
                             device=device),
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


def write_layer(
    k_cache: torch.Tensor,  # [B, T, Hkv, D] one layer, updated in place
    v_cache: torch.Tensor,
    k_new: torch.Tensor,  # [B, S, Hkv, D]
    v_new: torch.Tensor,
    slots: torch.Tensor,  # [B, S]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter new KV into ring slots."""
    _scatter(k_cache, slots, k_new, 0)
    _scatter(v_cache, slots, v_new, 0)
    return k_cache, v_cache


def write_stacked(
    cache: KVCache,
    k_new: torch.Tensor,  # [L, B, S, Hkv, D] fresh KV of every layer
    v_new: torch.Tensor,
    slots: torch.Tensor,  # [B, S]
) -> None:
    """The decode step's single post-layer-loop scatter of every layer's
    fresh KV."""
    _scatter(cache.k, slots, k_new, 1)
    _scatter(cache.v, slots, v_new, 1)
