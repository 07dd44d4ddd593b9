"""Prompt-lookup speculative decoding: draft-free speculation for greedy
decode, on the device (counterpart: llmss_tpu/engine/speculative.py).

Each speculative step drafts ``gamma`` tokens by n-gram lookup in the
row's own history (prompt and emitted tokens), then verifies the draft in
ONE forward of S = gamma + 1 tokens a row against the cache (the decoder's
deferred-write window, kernel K2w on the GPU). The model's greedy choice
at each draft position confirms the next draft token or replaces it: a
step emits 1 to gamma + 1 tokens, each the argmax of the model's logits
given the true prefix.

On the GPU a group of ``m`` steps is ``m`` replays of one captured step
graph (engine/graphs.py ``SpecBuffers``): the draft, the verify forward,
acceptance, EOS, the invalidation of rejected draft slots and the history
append all run on the device over static buffers, each replay writes its
choices and emits into the group's packed result, and the host reads the
group in ONE transfer (the reference's ``spec_group_impl`` scan and its
packed fetch, speculative.py:206-251, :425-432).

Exactness: under the verify forward's own numerics. On the CPU the window
(``fresh_kv_window_attention``) and the single-token step
(``fresh_kv_decode_attention``) are plain fp32 versions, and the tokens
equal ``generate``'s; on the GPU K2w and K2 round differently in bf16, so
a near-tie may resolve differently and two valid greedy decodes diverge.

- ``gamma`` and the group length are fixed per graph; drafts are data. A
  row with no n-gram match drafts repeats of its last token.
- Rows advance by different amounts; each row's ``hist_len`` drives its
  ring positions.
- The verify forward writes all S tokens' KV; the slots of rejected draft
  tokens get position -1 in the same step, so no later step attends them,
  and a done row's whole window is invalidated.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from llmss_tpu_torch.models.decoder import forward

# The defaults of ``generate_speculative`` (the reference's), which
# ``DecodeEngine.prewarm(speculative=)`` warms.
NGRAM = 3
CHUNK_STEPS = 8


def lookup_draft(hist: list[int], gamma: int, ngram: int = 3) -> list[int]:
    """Host version of the device draft rule (speculative.py:64): match the
    trailing n-gram (longest n first, then shorter, then repeat the last
    token) against the row's own past; propose the ``gamma`` tokens that
    followed the most recent match, padded with the continuation's last."""
    h = np.asarray(hist, np.int32)
    L = len(h)
    for n in range(min(ngram, L - 1), 0, -1):
        tail = h[L - n:]
        windows = np.lib.stride_tricks.sliding_window_view(h[:-1], n)
        hits = np.flatnonzero((windows == tail).all(axis=1))
        for s in hits[::-1]:
            cont = h[s + n: s + n + gamma]
            if len(cont) > 0:
                out = cont.tolist()
                while len(out) < gamma:
                    out.append(out[-1])
                return out
    return [int(h[-1])] * gamma


def device_draft(hist: torch.Tensor, hist_len: torch.Tensor, gamma: int,
                 ngram: int = 3) -> torch.Tensor:
    """``lookup_draft`` for every row at once on the device (the
    reference's ``_device_draft``, :87, over the batch): ``hist`` [B, H]
    int32 (entries past each row's ``hist_len`` are ignored), ``hist_len``
    [B]. Fixed shapes, no host sync: it runs inside a captured step.
    Returns [B, gamma] int32."""
    B, H = hist.shape
    dev = hist.device
    iota = torch.arange(H, dtype=torch.int32, device=dev)
    ar_g = torch.arange(gamma, dtype=torch.int32, device=dev)
    L = hist_len.to(torch.int32)[:, None]  # [B, 1]

    def at(idx):
        return hist.gather(1, idx.clamp(0, H - 1).long())

    draft = at(L - 1).expand(B, gamma)
    found_any = torch.zeros(B, 1, dtype=torch.bool, device=dev)
    for n in range(ngram, 0, -1):
        ar_n = torch.arange(n, dtype=torch.int32, device=dev)
        # The window starting at s covers hist[s:s+n]: a candidate iff it
        # ends before the trailing occurrence (s + n <= L - 1) and the
        # history holds an n-gram tail (L - n >= 1).
        tail = hist.gather(1, ((L - n).clamp(0, H - n) + ar_n).long())
        win = hist[:, (iota[:, None] + ar_n[None, :]).clamp(max=H - 1).long()]
        valid = (iota[None, :] + n <= L - 1) & (L - n >= 1)
        hit = valid & (win == tail[:, None, :]).all(-1)
        s_best = torch.where(hit, iota[None, :], -1).amax(1, keepdim=True)
        found = s_best >= 0
        cont_idx = s_best + n + ar_g[None, :]  # [B, gamma]
        # Past the live history, the continuation's last in-range element
        # (the host rule's ``out.append(out[-1])``).
        pad = at(torch.minimum(cont_idx[:, -1:] + 1, L) - 1)
        cont = torch.where(cont_idx < L, at(cont_idx), pad)
        draft = torch.where(found & ~found_any, cont, draft)
        found_any = found_any | found
    return draft


def spec_step(cfg, params, hist, hist_len, cache, done, eos, *, gamma: int,
              ngram: int = 3, t_bucket: int | None = None, layers=None):
    """One speculative step (speculative.py:128-203): device draft, verify
    forward, acceptance by cumulative product, EOS truncation, invalidation
    of rejected and frozen slots, history append. ``hist`` [B, H],
    ``hist_len`` [B], ``done`` [B] and the cache are updated in place;
    returns (choice [B, gamma + 1], n_emit [B]): the host emits
    ``choice[r, :n_emit[r]]``. Done rows emit nothing and keep no KV; the
    host stops before a live row lacks ring room for a full window."""
    B, H = hist.shape
    S = gamma + 1
    dev = hist.device
    col = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    frozen = done.clone()
    cur = hist_len - 1  # each row's current token's position and index
    cur_tok = hist.gather(1, cur.clamp(0, H - 1).long()[:, None])
    draft = torch.cat([cur_tok, device_draft(hist, hist_len, gamma, ngram)], 1)
    positions = cur[:, None] + col
    slots = positions % cache.max_len
    logits, _ = forward(cfg, params, draft, positions, cache, slots,
                        t_bucket=t_bucket, layers=layers)
    choice = logits.argmax(-1).to(torch.int32)  # [B, S]
    match = draft[:, 1:] == choice[:, :-1]
    n_acc = match.to(torch.int32).cumprod(1).sum(1, dtype=torch.int32)
    n_emit = n_acc + 1  # accepted draft tokens + the bonus / replacement
    # EOS inside the emitted span truncates it (the EOS is not emitted)
    # and finishes the row.
    eos_hit = (choice == eos[:, None]) & (col < n_emit[:, None])
    any_eos = eos_hit.any(1)
    first_eos = eos_hit.to(torch.int32).argmax(1).to(torch.int32)
    n_emit = torch.where(any_eos, first_eos, n_emit)
    n_emit = torch.where(frozen, 0, n_emit)
    # Rejected draft slots, and a frozen row's whole window, get -1.
    keep = (col <= n_acc[:, None]) & ~frozen[:, None]
    cache.positions.scatter_(1, slots.long(),
                             torch.where(keep, positions, -1))
    # Append the emitted tokens (clamped entries rewrite what they read).
    app = (hist_len[:, None] + col).clamp(0, H - 1).long()
    hist.scatter_(1, app, torch.where(col < n_emit[:, None], choice,
                                      hist.gather(1, app)))
    hist_len.add_(n_emit)
    done.logical_or_(any_eos & ~frozen)
    return choice, n_emit


def _spec_stats(n_forwards: int, n_emitted: int, B: int, gamma: int,
                chunk_steps: int) -> dict:
    return {
        "verify_forwards": n_forwards,
        "tokens_via_speculation": n_emitted,
        "mean_tokens_per_forward_per_row": round(
            n_emitted / n_forwards / B, 3) if n_forwards else 0.0,
        "gamma": gamma,
        "chunk_steps": chunk_steps,
    }


@torch.inference_mode()
def generate_speculative(engine, prompts: list[list[int]], gen, *,
                         gamma: int = 4, ngram: int = NGRAM,
                         chunk_steps: int = CHUNK_STEPS) -> list[list[int]]:
    """Greedy generation with grouped prompt-lookup speculation
    (speculative.py:254-503): the same tokens as ``generate`` under the
    verify forward's numerics, in about ``1/mean_accepted`` of the
    forwards. Groups of up to ``chunk_steps`` steps run while every live
    row has ring room for the group's windows (shrinking near the ring);
    the rest finishes on the plain chunked decode. A batch with no room
    for even one window is served by ``generate``. Records
    ``engine.metrics.spec_stats`` (overwritten by every call)."""
    gen.validate()
    if not gen.is_greedy:
        raise ValueError(
            "speculative decoding verifies greedy argmax choices; "
            "sampled requests must use generate()")
    if gamma < 1 or chunk_steps < 1:
        raise ValueError(f"gamma ({gamma}) and chunk_steps ({chunk_steps}) "
                         "must be >= 1")
    from llmss_tpu_torch.engine.engine import to_device

    B = len(prompts)
    S = gamma + 1
    H = engine.max_seq_len
    if max(len(p) for p in prompts) + S + 1 > H:
        # No ring room for one window (or the prompt fills the ring): plain
        # greedy serves the same contract; the stats say so.
        engine.metrics.spec_stats = _spec_stats(0, 0, B, gamma, chunk_steps)
        return engine.generate(prompts, gen)

    dev = engine.device
    ids, lens = engine._pad_prompts(prompts)
    cache = engine._generate_cache(B)
    sa = engine._sample_args(gen, B)
    tok, _ = engine.timed_prefill(
        torch.as_tensor(ids, device=dev), cache,
        torch.as_tensor(lens, device=dev), sa, batch=B)
    tok_np = tok.cpu().numpy()

    eos_val = gen.eos_token_id if gen.eos_token_id is not None else -1
    out: list[list[int]] = [[] for _ in range(B)]
    done_np = np.zeros(B, bool)

    def emit(r: int, t: int) -> bool:
        """Append token t to row r (the host enforces max_new); True iff
        it was appended."""
        if done_np[r]:
            return False
        out[r].append(t)
        if len(out[r]) >= gen.max_new_tokens:
            done_np[r] = True
        return True

    hist_np = np.zeros((B, H), np.int32)
    for r, p in enumerate(prompts):
        hist_np[r, : len(p)] = p
    first_live = tok_np != eos_val
    for r in range(B):
        if first_live[r]:
            emit(r, int(tok_np[r]))
        else:
            done_np[r] = True
        if not done_np[r]:
            hist_np[r, lens[r]] = tok_np[r]
    hl_host = lens + first_live.astype(np.int32)
    bufs = engine._graphs.for_cache(cache).spec_buffers(S, chunk_steps, H)
    bufs.hist.copy_(to_device(hist_np, dev))
    bufs.hist_len.copy_(to_device(hl_host.astype(np.int32), dev))
    bufs.done.copy_(to_device(done_np, dev))
    bufs.eos.fill_(eos_val)

    n_forwards = n_emitted = 0
    m_metrics = engine.metrics
    while not done_np.all():
        live_hi = int(hl_host[~done_np].max())
        # The group shrinks near the ring (every live row needs room for m
        # full windows); below half a group the per-group fetch outweighs
        # the speculation, and the chunked plain tail takes over.
        m = min(chunk_steps, (H - live_hi) // S)
        if m < max(1, chunk_steps // 2):
            break
        t0 = time.perf_counter()
        # Zeroed before the step is fetched: a new bucket's capture runs
        # the step once for real first, which records at this index.
        bufs.step.zero_()
        step = engine._spec_step(cache, bufs, gamma, ngram,
                                 engine.decode_bucket(live_hi + m * S))
        for _ in range(m):
            step()
        m_metrics.add_graph(replays=m)
        n_forwards += m
        m_metrics.host_dispatch.record(time.perf_counter() - t0)
        m_metrics.add_group()
        with m_metrics.host_fetch.time():
            flat = np.array(bufs.packed.cpu())  # ONE fetch per group
        m_metrics.add_host_sync()
        t_cb = time.perf_counter()
        ch_np, ne_np, hl_host, dev_done = bufs.unpack(flat, m)
        for s in range(m):
            for r in range(B):
                for c in range(int(ne_np[s, r])):
                    if emit(r, int(ch_np[s, r, c])):
                        n_emitted += 1
                    if done_np[r]:
                        break
        # Device EOS completions never show in the emitted tokens: adopt
        # them; push the host's (max_new) completions into the device.
        done_np |= dev_done
        if (done_np & ~dev_done).any():
            bufs.done.copy_(to_device(done_np, dev))
        m_metrics.host_callback.record(time.perf_counter() - t_cb)

    if not done_np.all():
        # The ring-constrained tail: plain chunked decode steps (replays of
        # the fold step graph) from each row's current token, past the ring
        # end with generate's sliding-ring semantics; max_new bounds a row.
        h_np = bufs.hist.cpu().numpy()
        cur_np = (hl_host - 1).astype(np.int32)
        tok_cur = to_device(
            h_np[np.arange(B), np.minimum(cur_np, H - 1)].astype(np.int32), dev)
        cur = to_device(cur_np, dev)
        eos_dev = torch.full((B,), eos_val, dtype=torch.int32, device=dev)
        pos_hi, k = int(hl_host.max()), 16
        while not done_np.all():
            packed, tok_cur, cur, _ = engine._decode_group(
                tok_cur, cache, cur, sa, to_device(done_np, dev), eos_dev,
                n_steps=k, t_bucket=engine.decode_bucket(pos_hi + k))
            pos_hi += k
            t_np = packed[: B * k].view(B, k).cpu().numpy()  # one fetch
            for c in range(k):
                for r in range(B):
                    if not done_np[r]:
                        t = int(t_np[r, c])
                        if t == eos_val:
                            done_np[r] = True
                        else:
                            emit(r, t)

    m_metrics.add_tokens(sum(len(o) for o in out))
    m_metrics.spec_stats = _spec_stats(n_forwards, n_emitted, B, gamma,
                                       chunk_steps)
    return out
