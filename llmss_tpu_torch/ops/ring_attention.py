"""Sequence parallelism over the ``sp`` axis (counterpart:
llmss_tpu/ops/ring_attention.py).

The KV cache's ring is split into ``sp`` chunks of consecutive slots, one
per rank. Three functions, each with the reference's fp32 online-softmax
numerics and finite-min masking:

- ``ring_attention`` (prefill): queries sequence-sharded too. Each rank
  attends its local KV block, then passes the block (and its positions)
  one hop around the ring (``ppermute``), ``sp`` times. The reference
  rotates the cache's chunks; the decoder hands it each rank's fresh
  tokens instead (its ring holds nothing else), and ``on_block`` writes
  each passing block into the slots the rank holds;
- ``lse_merge_attention`` (replicated queries, e.g. a prefill whose
  length ``sp`` does not divide): each rank attends its chunk, and the
  partial states merge with a log-sum-exp-weighted sum (``pmax`` then
  ``psum``);
- ``lse_merge_fresh_kv_attention`` / ``sp_decode_attention`` (the
  deferred-write decode): the same over the stale chunk with the pending
  slot excluded at its global index, then the fresh token's own key and
  value folded in once, on every rank alike.

The plain version is the reference's ``_online_block`` / ``_finish`` /
``_init_state`` in torch: the CPU path and the oracle. On CUDA the local
attention runs through the kernels' state-out forms: K1 for a chunk
(``flash_attention_state``: each query row's fp32 m, l and unnormalised
accumulator) and K2 for the decode chunk (``decode_attention_state``,
read in place from the stacked cache); the states are merged here by
``merge_states``. A chunk a row cannot see carries weight 0 once any
chunk is visible, and a row that sees nothing anywhere gets the uniform
average (the ``l == 0`` guard of ``_finish``). State layout: m / l
``[B, Hkv, G, S]``, acc ``[B, Hkv, G, S, D]``, fp32.
"""

from __future__ import annotations

import torch

from llmss_tpu_torch.parallel.mesh import AXIS_SP, Mesh
from llmss_tpu_torch.parallel.sharding import pmax, ppermute, psum

NEG_INF = float(torch.finfo(torch.float32).min)

State = tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _init_state(q: torch.Tensor, Hkv: int) -> State:
    B, S, Hq, D = q.shape
    shape = (B, Hkv, Hq // Hkv, S)
    return (torch.full(shape, NEG_INF, dtype=torch.float32, device=q.device),
            torch.zeros(shape, dtype=torch.float32, device=q.device),
            torch.zeros((*shape, D), dtype=torch.float32, device=q.device))


def _online_block(m, l, acc, q, k, v, q_pos, kv_pos, scale, window=None,
                  exclude=None) -> State:
    """One online-softmax step of grouped-query attention over the KV chunk
    ``k`` / ``v`` [B, C, Hkv, D] (positions ``kv_pos`` [B, C], -1 empty);
    ``exclude`` [B, C] masks slots regardless of position."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qf = q.float().reshape(B, S, Hkv, G, D) * scale
    s = torch.einsum("bskgd,btkd->bkgst", qf, k.float())
    mask = (kv_pos[:, None, :] <= q_pos[:, :, None]) & (
        kv_pos[:, None, :] >= 0)  # [B, S, C]
    if window is not None:
        mask &= kv_pos[:, None, :] > q_pos[:, :, None] - window
    if exclude is not None:
        mask &= ~exclude[:, None, :]
    s = torch.where(mask[:, None, None], s, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    # Masked lanes hold the finite minimum: exp underflows to 0 against any
    # real max; a row with no visible KV anywhere becomes the uniform
    # average.
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = alpha * l + p.sum(-1)
    acc_new = acc * alpha[..., None] + torch.einsum(
        "bkgst,btkd->bkgsd", p, v.float())
    return m_new, l_new, acc_new


def _finish(m, l, acc, q) -> torch.Tensor:
    B, S, Hq, D = q.shape
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = acc / l_safe[..., None]  # [B, Hkv, G, S, D]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D).to(q.dtype)


def merge_states(a: State, b: State) -> State:
    """The state of two disjoint sets of slots from theirs (the same
    log-sum-exp weighting as ``_online_block``)."""
    m = torch.maximum(a[0], b[0])
    wa, wb = torch.exp(a[0] - m), torch.exp(b[0] - m)
    return (m, a[1] * wa + b[1] * wb,
            a[2] * wa[..., None] + b[2] * wb[..., None])


def _scale(q, scale):
    return 1.0 / (q.shape[-1] ** 0.5) if scale is None else scale


def chunk_state(q, k, v, q_pos, kv_pos, *, scale=None, window=None
                ) -> State:
    """The softmax state of ``q`` over one KV chunk: K1's state-out form
    for CUDA tensors, ``_online_block`` from the initial state for CPU
    tensors."""
    if q.is_cuda:
        from llmss_tpu_torch.ops import flash_attention as fa

        return fa.flash_attention_state(q, k, v, q_pos, kv_pos, scale=scale,
                                        window=window)
    m, l, acc = _init_state(q, k.shape[2])
    return _online_block(m, l, acc, q, k, v, q_pos, kv_pos, _scale(q, scale),
                         window)


def ring_attention(
    q: torch.Tensor,  # [B, S_local, Hq, D] sequence-sharded queries
    k: torch.Tensor,  # [B, C, Hkv, D] this rank's KV block
    v: torch.Tensor,
    q_pos: torch.Tensor,  # [B, S_local]
    kv_pos: torch.Tensor,  # [B, C]; -1 = empty slot
    *,
    mesh: Mesh,
    axis: str = AXIS_SP,
    scale: float | None = None,
    window: int | None = None,
    on_block=None,  # on_block(src, k, v): each block once, as it passes
) -> torch.Tensor:
    """Sequence-parallel prefill attention; returns the local
    [B, S_local, Hq, D]. ``on_block`` sees every rank's block once, with
    the coordinate of the rank it started from."""
    sp = mesh.size(axis)
    r = mesh.coord(axis)
    scale = _scale(q, scale)
    state = _init_state(q, k.shape[2])
    for step in range(sp):
        if on_block is not None:
            on_block((r - step) % sp, k, v)
        if q.is_cuda:
            state = merge_states(state, chunk_state(
                q, k, v, q_pos, kv_pos, scale=scale, window=window))
        else:
            state = _online_block(*state, q, k, v, q_pos, kv_pos, scale,
                                  window)
        if step < sp - 1:
            # The block moves one hop; its positions travel with it.
            k = ppermute(k, mesh, axis)
            v = ppermute(v, mesh, axis)
            kv_pos = ppermute(kv_pos, mesh, axis)
    return _finish(*state, q)


def _merge_ranks(state: State, mesh: Mesh, axis: str) -> State:
    """The ranks' states of ``axis`` merged: one ``pmax``, two ``psum``."""
    m, l, acc = state
    m_g = pmax(m.clone(), mesh, axis)
    w = torch.exp(m - m_g)  # an all-masked chunk: exp(min - real) == 0
    return (m_g, psum(l * w, mesh, axis),
            psum(acc * w[..., None], mesh, axis))


def lse_merge_attention(
    q: torch.Tensor,  # [B, S, Hq, D] replicated over sp
    k: torch.Tensor,  # [B, C, Hkv, D] local KV chunk
    v: torch.Tensor,
    q_pos: torch.Tensor,  # [B, S] replicated
    kv_pos: torch.Tensor,  # [B, C]
    *,
    mesh: Mesh,
    axis: str = AXIS_SP,
    scale: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Split-KV attention over the ``sp`` axis: the local partial softmax
    and one log-sum-exp-weighted merge; returns the replicated output."""
    state = chunk_state(q, k, v, q_pos, kv_pos, scale=scale, window=window)
    return _finish(*_merge_ranks(state, mesh, axis), q)


def _fold_fresh(state: State, q, k_new, v_new, scale) -> State:
    """The fresh token's own key and value folded into a merged state (the
    token always attends itself, so an empty cache gives ``v_new``)."""
    m_g, l_g, acc_g = state
    B, S, Hq, D = q.shape
    Hkv = k_new.shape[2]
    qf = q.float().reshape(B, S, Hkv, Hq // Hkv, D) * scale
    s_new = torch.einsum("bskgd,bskd->bkgs", qf, k_new.float())
    m_f = torch.maximum(m_g, s_new)
    alpha = torch.exp(m_g - m_f)
    p_new = torch.exp(s_new - m_f)
    return (m_f, l_g * alpha + p_new,
            acc_g * alpha[..., None] + p_new[..., None]
            * v_new.float().permute(0, 2, 1, 3)[:, :, None])


def sp_decode_attention(
    q: torch.Tensor,  # [B, 1, Hq, D] replicated over sp
    k_cache: torch.Tensor,  # [L, B, C, Hkv, D] this rank's stale chunk
    v_cache: torch.Tensor,
    k_new: torch.Tensor,  # [B, 1, Hkv, D] replicated
    v_new: torch.Tensor,
    q_pos: torch.Tensor,  # [B, 1]
    kv_pos: torch.Tensor,  # [B, C] the chunk's positions, pre-write
    slots: torch.Tensor,  # [B, 1] GLOBAL ring slot the token will take
    layer: int,
    *,
    mesh: Mesh,
    axis: str = AXIS_SP,
    scale: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Deferred-write decode attention over layer ``layer`` of the
    sequence-sharded stale cache: K2's state-out form over the chunk (CUDA)
    or ``_online_block`` (CPU), the pending slot excluded where this rank
    holds it, the ranks' states merged, then the fresh KV folded in."""
    C = k_cache.shape[2]
    start = mesh.coord(axis) * C
    local = slots - start  # out of [0, C) where another rank holds it
    scale = _scale(q, scale)
    if q.is_cuda:
        from llmss_tpu_torch.ops import decode_attention as da

        state = da.decode_attention_state(
            q, k_cache, v_cache, q_pos, kv_pos, local, layer, scale=scale,
            window=window)
    else:
        idx = torch.arange(C, dtype=local.dtype, device=q.device)
        state = _online_block(
            *_init_state(q, k_cache.shape[3]), q, k_cache[layer],
            v_cache[layer], q_pos, kv_pos, scale, window,
            exclude=idx[None, :] == local)
    state = _merge_ranks(state, mesh, axis)
    return _finish(*_fold_fresh(state, q, k_new, v_new, scale), q)


def lse_merge_fresh_kv_attention(
    q: torch.Tensor,  # [B, 1, Hq, D] replicated over sp
    k: torch.Tensor,  # [B, C, Hkv, D] local stale chunk
    v: torch.Tensor,
    q_pos: torch.Tensor,  # [B, 1]
    kv_pos: torch.Tensor,  # [B, C]
    k_new: torch.Tensor,  # [B, 1, Hkv, D]
    v_new: torch.Tensor,
    slots: torch.Tensor,  # [B, 1] global ring slot
    *,
    mesh: Mesh,
    axis: str = AXIS_SP,
    scale: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """The reference's signature of ``sp_decode_attention``: one layer's
    chunk ``[B, C, Hkv, D]`` instead of the stacked cache."""
    return sp_decode_attention(
        q, k[None], v[None], k_new, v_new, q_pos, kv_pos, slots, 0,
        mesh=mesh, axis=axis, scale=scale, window=window)
