"""Token sampling: temperature -> top-k -> top-p -> categorical
(counterpart: llmss_tpu/ops/sampling.py:43-202).

Randomness is per row and stateless, as in the reference: each draw uses
``fold_in(key(seed_row), counter_row)`` with the counter being the absolute
position of the token being sampled. The key derivation and the Gumbel
noise are a plain-torch port of JAX's partitionable threefry2x32 path
(``jax.random.key`` -> ``fold_in`` -> ``bits`` -> ``uniform`` ->
``gumbel``), so a request's ``(seed, position)`` draws the same token on
either backend: the serving protocol's seed promise holds across the port.
The 32-bit arithmetic runs in int64 masked to 32 bits.

The reference branches on device values with ``lax.cond``; here the
caller may pass the two batch-level branch flags (``any_sampled``,
``needs_filter``) from host-side request parameters so that a decode step
never waits on the device to pick a branch. The bucket-or-full-sort choice
depends on the logits and is made on the device with ``torch.where``.
"""

from __future__ import annotations

import torch

TOPK_BUCKET = 64
_M32 = 0xFFFFFFFF
_F32_MIN = float(torch.finfo(torch.float32).min)
_F32_TINY = float(torch.finfo(torch.float32).tiny)
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k1, k2, x0, x1):
    """Threefry-2x32 (20 rounds) on int64 tensors holding uint32 values;
    the same rounds as ``jax._src.prng._threefry2x32_lowering``."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def row_keys(seeds: torch.Tensor, counters: torch.Tensor):
    """Per-row threefry keys ``fold_in(key(seed), counter)`` as a pair of
    [B] int64 tensors. ``key(s)`` of an int32 seed is ``(0, s mod 2**32)``;
    ``fold_in(k, c)`` is ``threefry(k, (0, c))``."""
    s = seeds.to(torch.int64) & _M32
    c = counters.to(torch.int64) & _M32
    return threefry2x32(torch.zeros_like(s), s, torch.zeros_like(c), c)


def random_bits(keys, n: int) -> torch.Tensor:
    """[B, n] 32-bit random words per row: ``jax.random.bits(key, (n,))``
    under the partitionable threefry (counter ``i`` hashed as (0, i),
    result ``bits1 ^ bits2``)."""
    k1, k2 = keys
    dev = k1.device
    lo = torch.arange(n, dtype=torch.int64, device=dev)[None, :]
    b1, b2 = threefry2x32(k1[:, None], k2[:, None], torch.zeros_like(lo), lo)
    return b1 ^ b2


def gumbel(keys, n: int) -> torch.Tensor:
    """[B, n] fp32 Gumbel noise, ``jax.random.gumbel(key, (n,))`` in its
    default low-range mode: uniform on [tiny, 1) from the top 23 bits, then
    ``-log(-log(u))``."""
    u = (random_bits(keys, n) >> 9).to(torch.float32) * (2.0 ** -23)
    u = torch.clamp_min(u + _F32_TINY, _F32_TINY)
    return -torch.log(-torch.log(u))


def nonfinite_rows(logits: torch.Tensor) -> torch.Tensor:
    """[B] bool: True where a row's logits hold NaN or inf."""
    return ~torch.isfinite(logits).all(-1)


def fold_step_outcome(logits, tok, done, poisoned, eos):
    """Fold one decode step's EOS / non-finite outcome into the decode
    carry: done or newly poisoned rows emit their EOS fill, poisoned rows
    are forced done, and a row sampling its EOS finishes. Returns the
    updated ``(tok, done, poisoned)``."""
    bad = nonfinite_rows(logits) & ~done
    poisoned = poisoned | bad
    tok = torch.where(done | bad, eos, tok)
    done = done | bad | (tok == eos)
    return tok, done, poisoned


def _sorted_desc(vals: torch.Tensor, idx: torch.Tensor):
    """Order candidates by value descending, ties by lower token id first
    (JAX's top_k / stable argsort order)."""
    by_id = torch.argsort(idx, dim=-1, stable=True)
    vals, idx = vals.gather(-1, by_id), idx.gather(-1, by_id)
    order = torch.argsort(-vals, dim=-1, stable=True)
    return vals.gather(-1, order), idx.gather(-1, order)


def sample(
    logits: torch.Tensor,  # [B, V] fp32
    *,
    seeds: torch.Tensor,  # [B] int32
    counters: torch.Tensor,  # [B] int32 position of the token being sampled
    temperature: torch.Tensor,  # [B] f32
    top_k: torch.Tensor,  # [B] int32; <= 0 disables
    top_p: torch.Tensor,  # [B] f32; 1.0 disables
    greedy: torch.Tensor,  # [B] bool
    any_sampled: bool | None = None,
    needs_filter: bool | None = None,
) -> torch.Tensor:
    """Next token ids [B] int32. ``any_sampled`` / ``needs_filter`` are the
    batch-level branch flags (any non-greedy row; any non-greedy row with
    top-k or top-p active); pass them from host-side parameters, or leave
    them None to read them from the tensors (one device sync)."""
    B, V = logits.shape
    greedy_tok = logits.argmax(-1).to(torch.int32)
    if any_sampled is None:
        any_sampled = bool((~greedy).any())
    if not any_sampled:
        return greedy_tok
    if needs_filter is None:
        needs_filter = bool(((~greedy) & ((top_k > 0) | (top_p < 1.0))).any())

    scaled = logits / torch.clamp_min(temperature, 1e-6)[:, None]
    noise = gumbel(row_keys(seeds, counters), V)

    def draw(filtered):
        return (noise + filtered).argmax(-1).to(torch.int32)

    if not needs_filter:
        sampled = draw(scaled)
    else:
        k_eff = torch.where(top_k <= 0, V, top_k).to(torch.int64)[:, None]
        p_eff = torch.where(
            top_p >= 1.0, torch.full_like(top_p, 2.0), top_p
        )[:, None]
        lse = torch.logsumexp(scaled, -1, keepdim=True)
        rows = torch.arange(B, device=logits.device)[:, None]

        def keep_prefix(svals, order):
            Kb = svals.shape[1]
            probs = torch.exp(svals - lse)
            cum_before = torch.cumsum(probs, -1) - probs
            rank = torch.arange(Kb, device=logits.device)[None, :]
            keep_sorted = (rank < k_eff) & (cum_before < p_eff)
            keep_sorted[:, 0] = True
            keep = torch.zeros((B, V), dtype=torch.bool, device=logits.device)
            keep[rows.expand_as(order), order] = keep_sorted
            return keep

        def masked(keep):
            return torch.where(keep, scaled, torch.full_like(scaled, _F32_MIN))

        Kb = min(TOPK_BUCKET, V)
        bvals, border = _sorted_desc(*torch.topk(scaled, Kb, dim=-1))
        unfiltered = (top_k <= 0) & (top_p >= 1.0)
        bucket_tok = draw(masked(keep_prefix(bvals, border) | unfiltered[:, None]))
        order = torch.argsort(-scaled, dim=-1, stable=True)
        svals = scaled.gather(-1, order)
        full_tok = draw(masked(keep_prefix(svals, order)))
        bucket_mass = torch.exp(bvals - lse).sum(-1, keepdim=True)
        row_ok = (
            greedy[:, None] | unfiltered[:, None] | (k_eff <= Kb)
            | (bucket_mass >= p_eff)
        )
        sampled = torch.where(row_ok.all(), bucket_tok, full_tok)
    return torch.where(greedy, greedy_tok, sampled)
