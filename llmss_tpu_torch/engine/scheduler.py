"""Continuous batching, pipelined (counterpart:
llmss_tpu/engine/scheduler.py:160-1997).

Iteration-level scheduling over a persistent cache whose **rows** are the
scheduling unit: new requests are prefilled and merged into free rows
between decode groups, every group advances all active rows with per-row
sampling parameters, and finished rows free for the next waiting request.

**The decode state lives on the device and the host observes it one group
late.** ``tokens`` / ``cur_pos`` are device tensors that the grouped decode
feeds itself; group N+1 is enqueued before group N's packed results are
read. Each group's result is copied into pinned host memory without
blocking at dispatch, with a CUDA event recorded behind it, and the host
waits on that event only when it processes the group, while group N+1
runs. Admissions fold their first tokens into the device state
(``DecodeEngine._admit_merge``), so the device never waits on the host.
Everything runs on one CUDA stream, so work executes in the order it was
enqueued and in-place cache updates land between the groups that read
them, as the reference's donated buffers do. The decode groups replay the
engine's step graphs (engine/graphs.py), which hold the addresses of the
cache, so the batcher's device state never moves: block tables are
uploaded and admissions merged into the same tensors (``copy_``), and
``prewarm`` captures every step graph before serving.

Two layouts:

- ``kv_layout="dense"``: each row owns a ring of the ``[L, rows, T]``
  cache; admissions prefill into a scratch cache and are copied in.
- ``kv_layout="paged"``: rows map logical slots to a shared block pool; a
  row is admitted when free blocks cover ``prompt + max_new_tokens``
  (``_paged_reserve``) and returns its blocks when it finishes. The
  admission prefill runs over a scratch view that shares the pool, so
  absorbing it is a positions merge and a table upload, never a KV copy.
  With ``chunked_prefill=CB`` prompts stream through the ragged mixed
  prefill+decode dispatch (``DecodeEngine._ragged_group``), ``CB`` tokens
  per step, beside the decode rows.

Interleaved admission gives a request exactly the tokens it gets alone
(row isolation is positional: masks come from per-row positions), and the
one-group lag changes when the host learns tokens, never which tokens the
device computes.

The ragged group runs eagerly. Not in this port yet: shared-prefix
copy-on-write, preemption, parking and tiered KV, the prefill-only / adopt
halves of disaggregated serving, and device telemetry.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable

import numpy as np
import torch

from llmss_tpu_torch.engine.cache import BlockAllocator, table_sentinel
from llmss_tpu_torch.engine.engine import (
    DecodeEngine, GenerationParams, _bucket, _sync, to_device, variant_params,
)
from llmss_tpu_torch.engine.graphs import SAMPLING_VARIANTS

POISONED = "non-finite logits: row poisoned (NaN/inf in model output)"
IDLE_POLL_S = 0.005  # run_forever's sleep while nothing is queued or running


@dataclasses.dataclass
class _Row:
    req_id: str
    gen: GenerationParams
    out: list[int]
    # done_cb(tokens) on completion, done_cb(tokens, True) when cancelled,
    # done_cb(tokens, error=...) when the row failed.
    done_cb: Callable[..., None]
    stream_cb: Callable[[list[int]], None] | None = None
    emitted: int = 0
    # Active on the device, first token not yet seen by the host.
    awaiting_first: bool = True
    t_submit: float = 0.0


class _HostFetch:
    """A device tensor's copy to the host: started without blocking when
    constructed, waited on in ``numpy()``."""

    def __init__(self, t: torch.Tensor):
        if t.is_cuda:
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = t, None

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


@dataclasses.dataclass
class _InFlightAdmission:
    """A dispatched admission whose first tokens the host has not read."""

    entries: list  # [(row, _Row)]
    tok: _HostFetch  # [P] first sampled token per admission row


@dataclasses.dataclass
class _InFlightGroup:
    """A dispatched group whose packed results the host has not read:
    ``n_chunks*rows*k`` tokens then ``n_chunks*rows`` poison flags."""

    packed: _HostFetch
    n_chunks: int
    k: int  # steps per chunk
    # An admission's device work ran between the previous group and this
    # one: its fetch-to-fetch interval is not a clean decode sample.
    has_admission: bool = False
    # Ragged groups: {row: step} for rows whose prompt completed in this
    # group; that step's token is the request's first.
    prefill_firsts: dict | None = None


class ContinuousBatcher:
    def __init__(
        self, engine: DecodeEngine, *, rows: int = 8, chunk_steps: int = 1,
        group_chunks: int = 1, chunked_prefill: int | None = None,
    ):
        # chunk_steps fused steps per chunk; group_chunks chunks per group
        # while at least 3/4 of the rows are busy, else one chunk of half
        # the steps so TTFT stays short at low load. Token streams are
        # identical for every setting.
        if chunk_steps < 1:
            raise ValueError(f"chunk_steps must be >= 1, got {chunk_steps}")
        if group_chunks < 1:
            raise ValueError(f"group_chunks must be >= 1, got {group_chunks}")
        if chunked_prefill is not None:
            if chunked_prefill < 1:
                raise ValueError(
                    f"chunked_prefill must be >= 1, got {chunked_prefill}"
                )
            if engine.kv_layout != "paged":
                raise ValueError("chunked_prefill requires kv_layout='paged'")
        self.engine = engine
        self.rows = rows
        self.chunk_steps = chunk_steps
        self.chunk_steps_low = max(1, chunk_steps // 2)
        self.group_chunks = group_chunks
        self.chunked_prefill = chunked_prefill
        self._chunked = chunked_prefill is not None
        # row -> prompt tokens still to feed (chunked prefill).
        self._inflight_prefill: dict[int, list[int]] = {}
        self._paged = engine.kv_layout == "paged"
        if self._paged:
            mb = engine.max_seq_len // engine.block_size
            n_blocks = engine.kv_blocks or rows * mb
            self.cache = engine.new_paged_cache(
                rows, num_blocks=n_blocks, identity=False
            )
            self.allocator = BlockAllocator(n_blocks)
            self._sentinel = table_sentinel(n_blocks)
            self._host_tables = np.full((rows, mb), self._sentinel, np.int32)
            self._row_owned: dict[int, list[int]] = {}
            # row -> reserve time: block-seconds charged at release.
            self._row_reserve_t: dict[int, float] = {}
            engine.metrics.set_kv_blocks(total=n_blocks, in_use=0)
        else:
            self.cache = engine.new_cache(rows)
        self.pending: deque = deque()  # guarded_by: self._lock
        self.active: dict[int, _Row] = {}
        self._free = list(range(rows))  # guarded_by: self._lock
        # Host upper bound on each active row's position: picks the decode
        # group's cache-read bucket.
        self._row_pos: dict[int, int] = {}
        dev = engine.device
        self._tokens_dev = torch.zeros(rows, dtype=torch.int32, device=dev)
        self._cur_pos_dev = torch.zeros(rows, dtype=torch.int32, device=dev)
        self._cancelled: set[str] = set()  # guarded_by: self._lock
        self._inflight: _InFlightGroup | None = None
        self._pending_adm: _InFlightAdmission | None = None
        self._last_fetch_t: float | None = None
        self._lock = threading.Lock()

    def _dev(self, arr) -> torch.Tensor:
        return to_device(arr, self.engine.device)

    def _set_state(self, tokens, cur_pos) -> None:
        """Copy new decode state into the persistent device tensors."""
        self._tokens_dev.copy_(tokens)
        self._cur_pos_dev.copy_(cur_pos)

    def _pad_row_idx(self, P: int, rows: list[int]) -> np.ndarray:
        """[P] row indices for an admission merge: real rows first, padding
        a POSITIVE out-of-range sentinel (``rows``), which is dropped; a
        negative one would wrap onto a live row."""
        idx = np.full(P, self.rows, np.int32)
        idx[: len(rows)] = rows
        return idx

    # -- paged-KV plumbing --------------------------------------------------

    def _paged_reserve(self, taken: list, rows: list[int]):
        """Block-pool admission control: reserve ``ceil((prompt + max_new)
        / bs)`` blocks per candidate. Candidates that do not fit go back to
        the FRONT of the queue in order, with their row slots; a request
        bigger than the whole pool is answered with an error. Returns the
        (items, rows) that fit."""
        bs = self.engine.block_size
        ok_items, ok_rows, failed = [], [], []
        for item, row in zip(taken, rows):
            ids, gen = item[1], item[2]
            need = -(-(len(ids) + gen.max_new_tokens) // bs)
            if need > self.allocator.num_blocks:
                with self._lock:
                    self._free.append(row)
                self.engine.metrics.add_error(1)
                item[3]([], error=(
                    f"request needs {need} KV blocks but the pool has "
                    f"{self.allocator.num_blocks}"
                ))
                continue
            owned = self.allocator.alloc(need)
            if owned is None:
                failed.append((item, row))
                continue
            self._row_owned[row] = owned
            self._row_reserve_t[row] = time.monotonic()
            self._host_tables[row, :] = self._sentinel
            self._host_tables[row, :need] = owned
            ok_items.append(item)
            ok_rows.append(row)
        if failed:
            with self._lock:
                for item, row in reversed(failed):
                    self.pending.appendleft(item)
                    self._free.append(row)
        self.engine.metrics.set_kv_blocks(in_use=self.allocator.blocks_in_use)
        return ok_items, ok_rows

    def _paged_release_row(self, row: int) -> None:
        """Return a finished row's blocks now. Its device table stays stale
        until the next table upload; that is safe because done rows' writes
        are dropped on the device and nobody reads a freed row."""
        if not self._paged:
            return
        owned = self._row_owned.pop(row, [])
        self.allocator.free(owned)
        self._host_tables[row, :] = self._sentinel
        t0 = self._row_reserve_t.pop(row, None)
        if t0 is not None and owned:
            self.engine.metrics.add_kv_block_seconds(
                (time.monotonic() - t0) * len(owned)
            )
        self.engine.metrics.set_kv_blocks(in_use=self.allocator.blocks_in_use)

    def _paged_scratch_view(self, tables: np.ndarray):
        """An admission 'scratch cache' that SHARES the pool (and an int8
        pool's scales): the admitted rows' tables and fresh positions; the
        prefill writes the pool in place."""
        eng = self.engine
        return self.cache._replace(
            block_tables=self._dev(tables),
            positions=torch.full((tables.shape[0], eng.max_seq_len), -1,
                                 dtype=torch.int32, device=eng.device),
        )

    def _paged_absorb(self, view, rows: list[int]) -> None:
        """Fold a prefilled scratch view into the cache: the rows'
        positions, then the host tables (which also cuts freed rows' stale
        mappings), uploaded in place."""
        idx = self._dev(np.asarray(rows, np.int64))
        self.cache.positions.index_copy_(0, idx, view.positions[: len(rows)])
        self.cache.block_tables.copy_(self._dev(self._host_tables))

    def _insert(self, small, rows: list[int]) -> None:
        """Dense layout: copy the scratch cache's first rows into the
        persistent cache at ``rows`` (host indices: padding rows are simply
        not copied)."""
        n = len(rows)
        idx = self._dev(np.asarray(rows, np.int64))
        for name in ("k", "v", "k_scale", "v_scale"):
            dst = getattr(self.cache, name)
            if dst is not None:  # int8 scales
                dst.index_copy_(1, idx, getattr(small, name)[:, :n])
        self.cache.positions.index_copy_(0, idx, small.positions[:n])

    @torch.inference_mode()
    def prewarm(self, seq_buckets: list[int] | None = None) -> int:
        """Warm every program the batcher runs, before it serves
        (scheduler.py:604, without the prefix variant): unless prompts are
        chunked, the admission prefill for each (admission batch P, seq
        bucket S), ``seq_buckets`` narrowing the prompt envelope; then
        every decode step graph the groups can pick over the batcher's
        cache, each cache-read bucket x sampling variant (the busy and the
        low-load group replay the same step graphs). The ragged group runs
        eagerly and is not warmed. Resets positions, tokens and cur_pos,
        drains the device, and returns the number of programs warmed."""
        eng = self.engine
        dev = eng.device
        if seq_buckets is None:
            seq_buckets = eng.seq_buckets()
        Ps, p = [], 1
        while p < self.rows:
            Ps.append(p)
            p *= 2
        Ps.append(p)  # n == rows when rows is not a power of two
        n = 0
        for P in [] if self._chunked else Ps:
            sa = eng._sample_args(GenerationParams(), P)
            lens = torch.ones(P, dtype=torch.int32, device=dev)
            for S in seq_buckets:
                if self._paged:
                    # All-sentinel tables: the writes land in the drop block.
                    mb = eng.max_seq_len // eng.block_size
                    scratch = self._paged_scratch_view(
                        np.full((P, mb), self._sentinel, np.int32))
                else:
                    scratch = eng.new_cache(P)
                eng._prefill(torch.zeros((P, S), dtype=torch.int32,
                                         device=dev), scratch, lens, sa)
                n += 1
        # Every row done: the steps write no KV.
        done = torch.ones(self.rows, dtype=torch.bool, device=dev)
        eos = torch.full((self.rows,), -1, dtype=torch.int32, device=dev)
        for variant in SAMPLING_VARIANTS:
            sa = eng._sample_args(variant_params(*variant), self.rows)
            for tb in eng.prewarm_bucket_set():
                eng._decode_group(self._tokens_dev, self.cache,
                                  self._cur_pos_dev, sa, done, eos,
                                  n_steps=1, t_bucket=tb)
                n += 1
        self.cache.positions.fill_(-1)
        self._tokens_dev.zero_()
        self._cur_pos_dev.zero_()
        _sync(dev)
        return n

    # -- submission ---------------------------------------------------------

    def submit(
        self,
        token_ids: list[int],
        gen: GenerationParams,
        done_cb: Callable[..., None],
        req_id: str = "",
        stream_cb: Callable[[list[int]], None] | None = None,
    ) -> None:
        """Queue a request. ``done_cb`` fires exactly once; ``stream_cb``
        receives each group's new tokens."""
        gen.validate()
        # A near-capacity row would wrap its ring mid-group.
        self.engine.check_capacity(len(token_ids), gen.max_new_tokens)
        with self._lock:
            self.pending.append(
                (req_id, list(token_ids), gen, done_cb, stream_cb,
                 time.perf_counter())
            )

    # -- scheduling ---------------------------------------------------------

    def _admit_dispatch(self) -> _InFlightAdmission | None:
        """Dispatch admission for every pending request that has a free row
        (and, paged, its blocks): ONE batched prefill, ONE insert or
        positions merge and ONE device-state merge, with no blocking fetch.
        The rows are active at once; the host reads their first tokens
        later (``_resolve_admission``). Called after the step's group is
        enqueued, so the admission lands between that group and the next.
        The batch pads to a power of two."""
        with self._lock:
            if not self.pending or not self._free:
                return None
            taken = [self.pending.popleft()
                     for _ in range(min(len(self._free), len(self.pending)))]
            rows = [self._free.pop() for _ in taken]
        if self._paged:
            taken, rows = self._paged_reserve(taken, rows)
            if not taken:
                return None
        n = len(taken)
        P = 1
        while P < n:
            P *= 2
        if self._chunked:
            self._admit_chunked(taken, rows, P)
            return None
        eng = self.engine
        S = _bucket(max(len(item[1]) for item in taken), eng.max_seq_len)
        padded = np.zeros((P, S), np.int32)
        lens = np.ones(P, np.int32)  # dummy rows prefill one pad token
        for i, item in enumerate(taken):
            padded[i, : len(item[1])] = item[1]
            lens[i] = len(item[1])
        gens = [item[2] for item in taken] + [GenerationParams()] * (P - n)
        sample_args = eng._sample_args(gens, P)
        ids_d, lens_d = self._dev(padded), self._dev(lens)
        if self._paged:
            mb = eng.max_seq_len // eng.block_size
            tables = np.full((P, mb), self._sentinel, np.int32)
            tables[:n] = self._host_tables[rows]
            scratch = self._paged_scratch_view(tables)
            tok, _ = eng._prefill(ids_d, scratch, lens_d, sample_args)
            self._paged_absorb(scratch, rows)
        else:
            scratch = eng.new_cache(P)
            tok, _ = eng._prefill(ids_d, scratch, lens_d, sample_args)
            self._insert(scratch, rows)
        self._set_state(*eng._admit_merge(
            self._tokens_dev, self._cur_pos_dev, tok, lens_d,
            self._dev(self._pad_row_idx(P, rows)),
        ))
        entries = []
        for row, (req_id, ids, gen, cb, scb, t_submit) in zip(rows, taken):
            r = _Row(req_id=req_id, gen=gen, out=[], done_cb=cb,
                     stream_cb=scb, t_submit=t_submit)
            self.active[row] = r
            self._row_pos[row] = len(ids)
            entries.append((row, r))
        return _InFlightAdmission(entries=entries, tok=_HostFetch(tok))

    def _admit_chunked(self, taken: list, rows: list[int], P: int) -> None:
        """Chunked-prefill admission: no prefill program. The rows' blocks
        are reserved and their tables staged; admission is a positions
        reset, a table upload and a device-state merge pointing ``cur_pos``
        at 0. The prompts stream through the next ragged groups."""
        eng = self.engine
        n = len(taken)
        idx = self._dev(np.asarray(rows, np.int64))
        self.cache.positions.index_fill_(0, idx, -1)
        self.cache.block_tables.copy_(self._dev(self._host_tables))
        zeros = torch.zeros(P, dtype=torch.int32, device=eng.device)
        self._set_state(*eng._admit_merge(
            self._tokens_dev, self._cur_pos_dev, zeros, zeros,
            self._dev(self._pad_row_idx(P, rows)),
        ))
        for row, (req_id, ids, gen, cb, scb, t_submit) in zip(rows, taken[:n]):
            self.active[row] = _Row(req_id=req_id, gen=gen, out=[],
                                    done_cb=cb, stream_cb=scb,
                                    t_submit=t_submit)
            self._row_pos[row] = 0
            self._inflight_prefill[row] = list(ids)

    def _resolve_admission(self, adm: _InFlightAdmission | None) -> int:
        """Host bookkeeping for a dispatched admission: read its first
        tokens (by now overlapped with at least one group)."""
        if adm is None:
            return 0
        firsts = adm.tok.numpy()
        n = 0
        for i, (row, r) in enumerate(adm.entries):
            if self.active.get(row) is not r:
                continue  # cancelled (and maybe re-admitted) meanwhile
            self._resolve_first(row, r, int(firsts[i]))
            n += 1
        return n

    def _resolve_first(self, row: int, r: _Row, first: int) -> None:
        """A request's FIRST token: from the admission prefill, or from the
        ragged step that completed its prompt."""
        # TTFT spans submit to here: queueing, the prefill (or the chunked
        # prompt) and the group the admission overlapped.
        self.engine.metrics.ttft.record(time.perf_counter() - r.t_submit)
        self.engine.metrics.add_request(1)
        r.awaiting_first = False
        eos = r.gen.eos_token_id if r.gen.eos_token_id is not None else -1
        if first == eos:
            self._finish(row, r)
            return
        r.out.append(first)
        self.engine.metrics.add_tokens(1)
        if len(r.out) >= r.gen.max_new_tokens:
            self._finish(row, r)
        else:
            self._flush_stream(r)

    def _finish(self, row: int, r: _Row, cancelled: bool = False,
                error: str | None = None) -> None:
        self.active.pop(row, None)
        self._row_pos.pop(row, None)
        self._inflight_prefill.pop(row, None)
        self._paged_release_row(row)
        with self._lock:
            self._free.append(row)
        self._flush_stream(r)
        self.engine.metrics.add_finish(
            "error" if error is not None
            else "cancelled" if cancelled else "served"
        )
        if error is not None:
            r.done_cb(r.out, error=error)
        elif cancelled:
            r.done_cb(r.out, True)
        else:
            r.done_cb(r.out)

    @staticmethod
    def _flush_stream(r: _Row) -> None:
        if r.stream_cb is not None and len(r.out) > r.emitted:
            r.stream_cb(r.out[r.emitted:])
            r.emitted = len(r.out)

    def cancel(self, req_id: str) -> None:
        """Mark a request cancelled (thread-safe); the next ``step()``
        frees its row or drops it from the queue, and its ``done_cb``
        fires with the tokens produced so far."""
        with self._lock:
            self._cancelled.add(req_id)

    def _process_cancellations(self) -> int:
        with self._lock:
            if not self._cancelled:
                return 0
            ids, self._cancelled = self._cancelled, set()
            dropped = [p for p in self.pending if p[0] in ids]
            self.pending = deque(p for p in self.pending if p[0] not in ids)
        for item in dropped:
            item[3]([], True)
        n = len(dropped)
        for row, r in list(self.active.items()):
            if r.req_id in ids:
                self._finish(row, r, cancelled=True)
                n += 1
        if n:
            self.engine.metrics.add_cancelled(n)
        return n

    def live_ids(self) -> list[str]:
        """Every request id this batcher holds, pending or active."""
        with self._lock:
            ids = [item[0] for item in self.pending]
        return ids + [r.req_id for r in self.active.values()]

    def load_snapshot(self) -> dict:
        """Host-side occupancy and pool headroom; never touches a device
        tensor."""
        with self._lock:
            pending, free_slots = len(self.pending), len(self._free)
        return {
            "rows": self.rows,
            "inflight_rows": self.rows - free_slots,
            "pending": pending,
            "free_slots": free_slots,
            "free_kv_blocks": self.allocator.free_blocks if self._paged else None,
            "kv_blocks_total": (self.allocator.num_blocks if self._paged
                                else None),
        }

    def drain_all(self) -> list[str]:
        """Remove every pending and active request, without callbacks, and
        return their ids (worker teardown answers them)."""
        with self._lock:
            ids = [item[0] for item in self.pending]
            self.pending.clear()
        self._inflight = None
        self._pending_adm = None
        self._last_fetch_t = None
        self._row_pos.clear()
        self._inflight_prefill.clear()
        for row in list(self.active):
            ids.append(self.active.pop(row).req_id)
            self._paged_release_row(row)
            with self._lock:
                self._free.append(row)
        return ids

    def drop_pending(self) -> list[str]:
        """Remove every never-admitted request without callbacks and return
        its id (it goes back to the broker for another worker)."""
        with self._lock:
            ids = [item[0] for item in self.pending]
            self.pending.clear()
        return ids

    def _chunk_args(self):
        """Host view (one group late) of which rows are done, their EOS ids
        and sampling parameters."""
        done = np.ones(self.rows, bool)
        eos = np.full(self.rows, -1, np.int32)
        gens = []
        for i in range(self.rows):
            r = self.active.get(i)
            gens.append(r.gen if r else GenerationParams())
            if r is not None:
                done[i] = False
                if r.gen.eos_token_id is not None:
                    eos[i] = r.gen.eos_token_id
        return done, eos, self.engine._sample_args(gens, self.rows)

    def _process_group(self, group: _InFlightGroup) -> int:
        """Read a group's packed results (the ONE blocking fetch, overlapped
        with the next group) and account them chunk by chunk, so a row that
        finishes or poisons in chunk c never reads chunk c+1's fills."""
        R, k, nc = self.rows, group.k, group.n_chunks
        metrics = self.engine.metrics
        with metrics.host_fetch.time():
            flat = group.packed.numpy()
        metrics.add_host_sync()
        toks = flat[: nc * R * k].reshape(nc, R, k)
        poisoned = flat[nc * R * k:].reshape(nc, R).astype(bool)
        now = time.perf_counter()
        if self._last_fetch_t is not None and not group.has_admission:
            metrics.decode_step.record((now - self._last_fetch_t) / (nc * k))
        self._last_fetch_t = now
        n = 0
        t_cb = time.perf_counter()
        firsts = group.prefill_firsts or {}
        for c in range(nc):
            for i in list(self.active):
                r = self.active[i]
                if r.awaiting_first:
                    first_c = firsts.get(i)
                    if first_c is None or c < first_c:
                        continue  # mid-prompt, or admitted after dispatch
                    if poisoned[c, i]:
                        metrics.add_poisoned(1)
                        self._finish(i, r, error=POISONED)
                        continue
                    self._resolve_first(i, r, int(toks[c, i, 0]))
                    continue
                if poisoned[c, i]:
                    # The device EOS-filled the row from the bad step on.
                    metrics.add_poisoned(1)
                    self._finish(i, r, error=POISONED)
                    continue
                eos = r.gen.eos_token_id if r.gen.eos_token_id is not None else -1
                finished = False
                for col in range(k):
                    t = int(toks[c, i, col])
                    if t == eos:
                        finished = True
                        break
                    r.out.append(t)
                    n += 1
                    if len(r.out) >= r.gen.max_new_tokens:
                        finished = True
                        break
                if finished:
                    self._finish(i, r)
                else:
                    self._flush_stream(r)
        metrics.add_tokens(n)
        metrics.host_callback.record(time.perf_counter() - t_cb)
        return n

    def _plan_ragged(self, n_steps: int):
        """Host schedule of one ragged group: every active row advances one
        token per step, except rows with a prompt in flight, which feed
        ``chunked_prefill``-token slices with sampling suppressed until the
        slice that completes the prompt. Returns the step arrays and
        {row: step} first-token marks."""
        CB, R = self.chunked_prefill, self.rows
        ids = np.zeros((n_steps, R, CB), np.int32)
        qlens = np.ones((n_steps, R), np.int32)
        feed = np.zeros((n_steps, R), bool)
        emit = np.ones((n_steps, R), bool)
        firsts: dict[int, int] = {}
        fed = 0
        for s in range(n_steps):
            for row in list(self._inflight_prefill):
                rem = self._inflight_prefill[row]
                q = min(CB, len(rem))
                ids[s, row, :q] = rem[:q]
                del rem[:q]
                qlens[s, row] = q
                feed[s, row] = True
                emit[s, row] = not rem
                fed += q
                if not rem:
                    firsts[row] = s
                    del self._inflight_prefill[row]
        pre = int(feed.sum())
        self.engine.metrics.add_mixed_steps(
            steps=n_steps, decode_rows=n_steps * len(self.active) - pre,
            prefill_rows=pre, prefill_tokens=fed, budget_tokens=pre * CB,
        )
        return ids, qlens, feed, emit, firsts

    @torch.inference_mode()
    def step(self) -> int:
        """One iteration of the pipelined loop:

        1. enqueue group N+1 from the device-resident state;
        2. read and process group N's results, overlapped with group N+1:
           rows finish and free here;
        3. resolve the admission enqueued last step;
        4. enqueue admissions for the rows just freed; they land between
           group N+1 and N+2.

        Returns the number of tokens the host accounted."""
        self._process_cancellations()

        if not self.active:
            # Nothing running: drain the pipeline, then admit directly.
            if self._inflight is not None:
                group, self._inflight = self._inflight, None
                self._last_fetch_t = None
                n = self._process_group(group)
                n += self._resolve_admission(self._pending_adm)
                self._pending_adm = None
                return n
            if self._pending_adm is not None:
                adm, self._pending_adm = self._pending_adm, None
                return self._resolve_admission(adm)
            adm = self._admit_dispatch()
            if adm is None:
                return 0
            self._last_fetch_t = None
            return self._resolve_admission(adm)

        eng = self.engine
        done, eos, sa = self._chunk_args()
        done_d, eos_d = self._dev(done), self._dev(eos)
        busy = len(self.active) >= (3 * self.rows) // 4
        t0 = time.perf_counter()
        if self._chunked and self._inflight_prefill:
            # Mixed batch: prompts in flight stream through the ragged
            # dispatch while decode rows advance one token per step.
            nc, k = (self.group_chunks * self.chunk_steps if busy
                     else self.chunk_steps_low), 1
            ids, qlens, feed, emit, firsts = self._plan_ragged(nc)
            packed, last_tok, cur_pos, _ = eng._ragged_group(
                self._tokens_dev, self.cache, self._cur_pos_dev, sa, done_d,
                eos_d, self._dev(ids), self._dev(qlens), self._dev(feed),
                self._dev(emit),
            )
            adv = qlens.sum(axis=0)
            for row in self._row_pos:
                self._row_pos[row] += int(adv[row])
            group = _InFlightGroup(packed=_HostFetch(packed), n_chunks=nc,
                                   k=k, has_admission=True,
                                   prefill_firsts=firsts)
        else:
            nc, k = ((self.group_chunks, self.chunk_steps) if busy
                     else (1, self.chunk_steps_low))
            t_bucket = eng.decode_bucket(
                max(self._row_pos.values(), default=0) + nc * k
            )
            packed, last_tok, cur_pos, _ = eng._decode_group(
                self._tokens_dev, self.cache, self._cur_pos_dev, sa, done_d,
                eos_d, n_chunks=nc, n_steps=k, t_bucket=t_bucket,
            )
            for row in self._row_pos:
                self._row_pos[row] += nc * k
            group = _InFlightGroup(packed=_HostFetch(packed), n_chunks=nc,
                                   k=k,
                                   has_admission=self._pending_adm is not None)
        self._set_state(last_tok, cur_pos)
        eng.metrics.host_dispatch.record(time.perf_counter() - t0)
        eng.metrics.add_group()

        prev, self._inflight = self._inflight, group
        n = self._process_group(prev) if prev is not None else 0
        n += self._resolve_admission(self._pending_adm)
        self._pending_adm = self._admit_dispatch()
        return n

    @property
    def idle(self) -> bool:
        with self._lock:
            return (
                not self.active and not self.pending
                and self._inflight is None and self._pending_adm is None
            )

    def run_until_idle(self) -> None:
        while not self.idle:
            self.step()

    def run_forever(self, stop: threading.Event) -> None:
        while not stop.is_set():
            if self.idle:
                time.sleep(IDLE_POLL_S)
                continue
            self.step()
