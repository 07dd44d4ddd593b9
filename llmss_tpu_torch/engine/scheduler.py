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

Shared prefixes (``submit(prefix=)``, a ``Prefix`` from
``DecodeEngine.build_prefix``): one admission takes the oldest request's
whole same-prefix group. Dense rows are seeded from the prefix and only
the suffixes prefill. Paged, the prefix's full blocks are written into the
pool once (``_ensure_paged_prefix``) and shared copy-on-write: each row's
table points at them, their refcounts rise per row and fall at release,
and the registry's own reference keeps an idle prefix until the pool needs
its blocks (``_paged_evict_idle_prefixes``). The partial tail lands in the
row's first owned block (split admission seeds it through tables whose
shared columns are the sentinel; chunked admission re-feeds it), so no row
ever writes a shared block.

Preemption (``preempt_cb``, ``submit(priority=, replayed=)``): when the
head pending request strictly outranks a running row and admission is
blocked on rows or blocks, one row per step is evicted between resolve and
admit (``select_preemption_victim``): its blocks are released as at finish
and its emitted tokens go to ``preempt_cb``. A resumed request replays
them as prompt (``replayed``): sampling is stateless per (seed, position),
so it continues the evicted stream.

Disaggregated serving: a ``prefill_only`` batcher exports each admitted
row's blocks at its first token (``export_cb``, ``export_blocks``) and
frees the row; ``adopt`` installs such blocks into a free row of a
decoding batcher, which decodes on from them without a prefill. A freed
row's device table and state stay stale until the next upload; that is
safe because the device runs the stream in order, so every later owner's
writes land after the stale ones, and the host reads an in-flight group's
tokens only for rows admitted before it was dispatched (an adopted row
skips the group in flight at its adoption).

Tiered KV (serve/kvstore.py, through two hooks): ``demote_cb(prefix)``
receives each idle prefix evicted from the pool, whose blocks are free
already (the ``Prefix`` owns its tensors); ``park_cb(req_id, tokens,
blocks)`` receives a finished session turn's exported full blocks, for
requests registered by ``request_park``. Without the hooks an eviction is
a drop and a finish exports nothing.

Telemetry (scheduler.py:132, :621-627, :1655-1680, :1855-1978): each
group carries its class and its cost (``DecodeEngine.devtel_cost`` at
the reference's shape keys, a cost-table hit after ``prewarm``), and
``_process_group`` folds every group's fetch-to-fetch interval, admission
and ragged groups included, into MFU/MBU (``decode_step`` still records
clean decode groups only). At each group boundary ``_devtel_sample``
records the counter tracks: rows by phase, the pending queue, KV blocks
and the largest free run, the MFU/MBU gauges and the caching allocator's
bytes. The flight recorder gets the reference's events: ``sched_submit``,
``admit`` (submit to first token), ``adopt``, ``evict``, ``finish`` and
the throttled ``group_dispatch`` / ``group_fetch``.

The ragged group runs eagerly.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable

import numpy as np
import torch

from llmss_tpu_torch.engine.cache import (
    BlockAllocator, export_blocks, export_dense_row, import_blocks,
    seed_blocks, table_sentinel,
)
from llmss_tpu_torch.engine.engine import (
    DecodeEngine, GenerationParams, _bucket, _sync, to_device, variant_params,
)
from llmss_tpu_torch.engine.graphs import SAMPLING_VARIANTS
from llmss_tpu_torch.utils import devtel, trace

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
    # SLO-class rank (0 = interactive): a pending request of strictly lower
    # rank may evict this row.
    priority: int = 1
    # Tokens replayed from a preempted run: preloaded into ``out``, and the
    # finish threshold moves by as many.
    replayed: int = 0


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


def select_preemption_victim(candidates, head_priority: int):
    """The row to evict for a blocked head request, or None
    (scheduler.py:135). ``candidates`` are ``(key, priority, emitted)`` of
    the evictable rows; only rows strictly outranked by the head qualify,
    the lowest class first, then the fewest emitted tokens (the cheapest
    replay); exact ties keep the first candidate."""
    victim = None
    for key, priority, emitted in candidates:
        if priority <= head_priority:
            continue
        if victim is None or (priority, -emitted) > (victim[1], -victim[2]):
            victim = (key, priority, emitted)
    return None if victim is None else victim[0]


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
    # Rows adopted after this group was dispatched: its values for them
    # belong to the row's previous occupant.
    stale_rows: set = dataclasses.field(default_factory=set)
    # Devtel: the group's class and cost, attached at dispatch, so the fold
    # needs no key.
    kind: str = "decode_group"
    cost: object = None  # devtel.KernelCost | None


class ContinuousBatcher:
    def __init__(
        self, engine: DecodeEngine, *, rows: int = 8, chunk_steps: int = 1,
        group_chunks: int = 1, chunked_prefill: int | None = None,
        prefill_only: bool = False,
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
        # Prefill-only (the prefill role): rows export their blocks at the
        # first token and free; the block table is the transfer unit.
        if prefill_only and engine.kv_layout != "paged":
            raise ValueError("prefill_only requires kv_layout='paged'")
        self.prefill_only = prefill_only
        self.engine = engine
        self.rows = rows
        self.chunk_steps = chunk_steps
        self.chunk_steps_low = max(1, chunk_steps // 2)
        self.group_chunks = group_chunks
        self.chunked_prefill = chunked_prefill
        self._chunked = chunked_prefill is not None
        # row -> prompt tokens still to feed / whole prompt length (chunked
        # prefill).
        self._inflight_prefill: dict[int, list[int]] = {}
        self._prefill_plen: dict[int, int] = {}
        # export_cb(req_id, first_token, n_tokens, blocks): a prefill-only
        # row's exported blocks (``export_blocks``' dict).
        self.export_cb: Callable[..., None] | None = None
        # preempt_cb(req_id, tokens): a row evicted for a higher-class
        # request, with the tokens it emitted; None disables preemption.
        self.preempt_cb: Callable[[str, list[int]], None] | None = None
        # Tiered KV (scheduler.py:257-270): demote_cb(prefix) for each idle
        # prefix evicted from the pool; park_cb(req_id, tokens, blocks) for
        # a finished row whose request registered park interest.
        self.demote_cb: Callable[..., None] | None = None
        self.park_cb: Callable[..., None] | None = None
        # req_id -> (token_ids, replayed): park interest, registered by the
        # serving layer (adopted rows carry no prompt ids here).
        self._park_ids: dict[str, tuple] = {}  # guarded_by: self._lock
        # Parks dropped because their export failed (the reference
        # swallows them); read by the chip smoke run, which wants 0.
        self.park_failures = 0
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
            self._row_shared: dict[int, list[int]] = {}
            # id(prefix) -> (prefix, full-block ids): the registry holds one
            # reference per block, so an idle prefix stays until evicted,
            # and the prefix object itself, so its id is not reused.
            self._paged_prefixes: dict[int, tuple] = {}
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
        self._devtel_last_t = float("-inf")
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

    def _paged_evict_idle_prefixes(self, keep: int | None = None) -> int:
        """Free every registered prefix block set that no row references
        (each block at the registry's own refcount of 1), except ``keep``:
        the admission's backstop when the pool runs dry. Each evicted
        ``Prefix`` goes to ``demote_cb`` when there is one (demoted), else
        it is dropped (scheduler.py:436). Returns the sets evicted."""
        freed = demoted = 0
        for key, (pfx, blocks) in list(self._paged_prefixes.items()):
            if key == keep or not blocks:
                continue
            if all(self.allocator.refcount(b) == 1 for b in blocks):
                self.allocator.free(blocks)
                del self._paged_prefixes[key]
                freed += 1
                if self.demote_cb is not None:
                    # The blocks are free already: the store reads the
                    # Prefix's own tensors.
                    try:
                        self.demote_cb(pfx)
                        demoted += 1
                    except Exception:  # noqa: BLE001 — a failed demote is a drop
                        pass
        if freed:
            self.allocator.record_evictions(freed)
            self.engine.metrics.add_kv_evictions(demoted, demoted=True)
            self.engine.metrics.add_kv_evictions(freed - demoted)
        return freed

    def _ensure_paged_prefix(self, prefix) -> list[int] | None:
        """The block ids of ``prefix``'s full blocks in the pool (possibly
        []), written there and registered on its first use; None when the
        pool cannot hold them even after evicting idle prefixes."""
        key = id(prefix)
        hit = self._paged_prefixes.get(key)
        if hit is not None:
            return hit[1]
        nf = prefix.length // self.engine.block_size
        if nf == 0:
            self._paged_prefixes[key] = (prefix, [])
            return []
        blocks = self.allocator.alloc(nf)
        if blocks is None and self._paged_evict_idle_prefixes(keep=key):
            blocks = self.allocator.alloc(nf)
        if blocks is None:
            return None
        seed_blocks(self.cache, prefix,
                    self._dev(np.asarray(blocks, np.int64)))
        self._paged_prefixes[key] = (prefix, blocks)
        return blocks

    def _requeue(self, items_rows) -> None:
        """Put (item, row) pairs back: the items at the FRONT of the queue,
        in order, and their rows on the free list."""
        with self._lock:
            for item, row in reversed(items_rows):
                self.pending.appendleft(item)
                self._free.append(row)

    def _paged_reserve(self, taken: list, rows: list[int], head_prefix):
        """Block-pool admission control: reserve ``ceil((prompt + max_new)
        / bs)`` blocks per candidate, less the prefix's shared full blocks,
        which are increfed instead (the partial tail lands in the row's
        first owned block). An idle prefix is evicted when the pool runs
        dry. Candidates that do not fit go back to the FRONT of the queue
        in order, with their row slots; a request bigger than the whole
        pool is answered with an error. Returns the (items, rows) that
        fit."""
        bs = self.engine.block_size
        shared: list[int] = []
        if head_prefix is not None:
            got = self._ensure_paged_prefix(head_prefix)
            if got is None:
                self._requeue(list(zip(taken, rows)))
                return [], []
            shared = got
        ns = len(shared)
        keep = id(head_prefix) if head_prefix is not None else None
        ok_items, ok_rows, failed = [], [], []
        for item, row in zip(taken, rows):
            ids, gen = item[1], item[2]
            need = -(-(len(ids) + gen.max_new_tokens) // bs) - ns
            if need + ns > self.allocator.num_blocks:
                with self._lock:
                    self._free.append(row)
                self.engine.metrics.add_error(1)
                item[3]([], error=(
                    f"request needs {need + ns} KV blocks but the pool has "
                    f"{self.allocator.num_blocks}"
                ))
                continue
            owned = self.allocator.alloc(need)
            if owned is None and self._paged_evict_idle_prefixes(keep=keep):
                owned = self.allocator.alloc(need)
            if owned is None:
                failed.append((item, row))
                continue
            if shared:
                self.allocator.incref(shared)
            self._row_owned[row] = owned
            self._row_shared[row] = list(shared)
            self._row_reserve_t[row] = time.monotonic()
            self._host_tables[row, :] = self._sentinel
            self._host_tables[row, :ns] = shared
            self._host_tables[row, ns:ns + len(owned)] = owned
            ok_items.append(item)
            ok_rows.append(row)
        if failed:
            self._requeue(failed)
        self.engine.metrics.set_kv_blocks(in_use=self.allocator.blocks_in_use)
        return ok_items, ok_rows

    def _paged_release_row(self, row: int) -> float:
        """Return a finished row's blocks now: owned blocks are freed, the
        shared prefix blocks decrefed. Its device table stays stale until
        the next table upload; that is safe because done rows' writes are
        dropped on the device and nobody reads a freed row. Returns the
        row's block-seconds (blocks held x the time held)."""
        if not self._paged:
            return 0.0
        owned = self._row_owned.pop(row, [])
        shared = self._row_shared.pop(row, [])
        self.allocator.free(owned)
        self.allocator.free(shared)
        self._host_tables[row, :] = self._sentinel
        held = 0.0
        t0 = self._row_reserve_t.pop(row, None)
        if t0 is not None and owned + shared:
            held = (time.monotonic() - t0) * (len(owned) + len(shared))
            self.engine.metrics.add_kv_block_seconds(held)
        self.engine.metrics.set_kv_blocks(in_use=self.allocator.blocks_in_use)
        return held

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
    def prewarm(self, seq_buckets: list[int] | None = None,
                prefix_prefill: bool = False) -> int:
        """Warm every program the batcher runs, before it serves
        (scheduler.py:604): unless prompts are
        chunked, the admission prefill for each (admission batch P, seq
        bucket S), ``seq_buckets`` narrowing the prompt envelope; then
        every decode step graph the groups can pick over the batcher's
        cache, each cache-read bucket x sampling variant (the busy and the
        low-load group replay the same step graphs). The ragged group runs
        eagerly and is not warmed. Resets positions, tokens and cur_pos,
        drains the device, and returns the number of programs warmed.
        ``prefix_prefill`` is the reference's flag for the prefix-offset
        admission prefills; those run eagerly here, and the step graphs do
        not depend on a prefix, so it warms nothing more. With devtel on it
        prices every group signature the live path can pick (both (chunks,
        steps) combinations at every bucket, and the ragged step counts)
        and marks the steady state at the end."""
        with devtel.observer().warming():
            n = self._prewarm(seq_buckets)
        if devtel.enabled():
            devtel.observer().mark_steady()
        return n

    def _prewarm(self, seq_buckets: list[int] | None) -> int:
        eng = self.engine
        dev = eng.device
        if devtel.enabled():
            for nc, k in sorted({(self.group_chunks, self.chunk_steps),
                                 (1, self.chunk_steps_low)}):
                for tb in eng.prewarm_bucket_set():
                    eng.devtel_cost("decode_group", (self.rows, nc, k, tb),
                                    batch=self.rows, steps=nc * k, kv_len=tb)
            if self._chunked:
                CB = self.chunked_prefill
                for nc in sorted({self.group_chunks * self.chunk_steps,
                                  self.chunk_steps_low}):
                    eng.devtel_cost(
                        "ragged_group", (self.rows, nc, CB), batch=self.rows,
                        steps=nc, kv_len=None,
                        prefill_tokens=nc * self.rows * CB)
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
        prefix=None,
        priority: int = 1,
        replayed: int = 0,
    ) -> None:
        """Queue a request. ``done_cb`` fires exactly once; ``stream_cb``
        receives each group's new tokens. ``prefix`` (a ``Prefix`` that
        ``token_ids`` extends by at least one token): the row is seeded
        from it and only the suffix is prefilled, with the same tokens.
        ``priority`` is the SLO-class rank (0 = interactive). ``replayed``
        resumes a preempted request: the last ``replayed`` entries of
        ``token_ids`` are tokens it already emitted, preloaded into its
        output (not streamed again), and ``gen.max_new_tokens`` counts the
        remaining tokens only."""
        gen.validate()
        if replayed and not 0 < replayed < len(token_ids):
            raise ValueError(
                f"replayed={replayed} must be in [0, len(token_ids))")
        if prefix is not None:
            P = prefix.length
            if len(token_ids) <= P or tuple(token_ids[:P]) != prefix.tokens:
                raise ValueError(
                    "token_ids does not extend the prefix (needs its "
                    f"{P} tokens plus at least one more)"
                )
            if P + _bucket(len(token_ids) - P,
                           self.engine.max_seq_len) > self.engine.max_seq_len:
                # Its own bucket-padded suffix would wrap onto the seeded
                # slots: admitted from scratch (scheduler.py:863).
                prefix = None
        # A near-capacity row would wrap its ring mid-group.
        self.engine.check_capacity(len(token_ids), gen.max_new_tokens)
        with self._lock:
            self.pending.append(
                (req_id, list(token_ids), gen, done_cb, stream_cb,
                 time.perf_counter(), prefix, priority, replayed)
            )
            depth = len(self.pending)
        if req_id:
            trace.record(req_id, "sched_submit", queued=depth)

    # -- scheduling ---------------------------------------------------------

    def _admit_dispatch(self) -> _InFlightAdmission | None:
        """Dispatch admission for pending requests that have a free row
        (and, paged, their blocks): ONE batched prefill, ONE insert or
        positions merge and ONE device-state merge, with no blocking fetch.
        The rows are active at once; the host reads their first tokens
        later (``_resolve_admission``). Called after the step's group is
        enqueued, so the admission lands between that group and the next.
        The batch pads to a power of two.

        One admission shares one prefix (or none): it takes the oldest
        request's whole same-prefix group from anywhere in the queue; the
        other requests keep their order for the next admission."""
        with self._lock:
            if not self.pending or not self._free:
                return None
            head_prefix = self.pending[0][6]
            free_n = len(self._free)
            taken, rest = [], deque()
            while self.pending:
                item = self.pending.popleft()
                if len(taken) < free_n and item[6] is head_prefix:
                    taken.append(item)
                else:
                    rest.append(item)
            self.pending = rest
            rows = [self._free.pop() for _ in taken]
        eng = self.engine
        if head_prefix is not None and head_prefix.length + _bucket(
                max(len(item[1]) for item in taken) - head_prefix.length,
                eng.max_seq_len) > eng.max_seq_len:
            # The batch's bucket-padded suffix would wrap onto the seeded
            # slots: the batch is prefilled from scratch (scheduler.py:931),
            # decided before the reserve so that the blocks match.
            head_prefix = None
        if self._paged:
            taken, rows = self._paged_reserve(taken, rows, head_prefix)
            if not taken:
                return None
        n = len(taken)
        P = 1
        while P < n:
            P *= 2
        if self._chunked:
            self._admit_chunked(taken, rows, P, head_prefix)
            return None
        plen = head_prefix.length if head_prefix is not None else 0
        suffixes = [item[1][plen:] for item in taken]
        S = _bucket(max(len(x) for x in suffixes), eng.max_seq_len)
        padded = np.zeros((P, S), np.int32)
        lens = np.ones(P, np.int32)  # dummy rows prefill one pad token
        for i, x in enumerate(suffixes):
            padded[i, : len(x)] = x
            lens[i] = len(x)
        gens = [item[2] for item in taken] + [GenerationParams()] * (P - n)
        sample_args = eng._sample_args(gens, P)
        ids_d, lens_d = self._dev(padded), self._dev(lens)
        start = (None if head_prefix is None else
                 torch.full((P,), plen, dtype=torch.int32, device=eng.device))
        if self._paged:
            mb = eng.max_seq_len // eng.block_size
            tables = np.full((P, mb), self._sentinel, np.int32)
            tables[:n] = self._host_tables[rows]
            scratch = self._paged_scratch_view(tables)
            if head_prefix is not None:
                # Seed through tables whose shared columns are the
                # sentinel: those writes drop, and only the partial tail
                # lands, in each row's first owned block (the copy of
                # copy-on-write).
                ns = len(self._row_shared[rows[0]])
                seed_tables = tables.copy()
                seed_tables[:, :ns] = self._sentinel
                eng.seed_cache(
                    scratch._replace(block_tables=self._dev(seed_tables)),
                    head_prefix)
            tok, _ = eng._prefill(ids_d, scratch, lens_d, sample_args, start)
            self._paged_absorb(scratch, rows)
        else:
            scratch = eng.new_cache(P)
            if head_prefix is not None:
                eng.seed_cache(scratch, head_prefix)
            tok, _ = eng._prefill(ids_d, scratch, lens_d, sample_args, start)
            self._insert(scratch, rows)
        self._set_state(*eng._admit_merge(
            self._tokens_dev, self._cur_pos_dev, tok, self._dev(lens + plen),
            self._dev(self._pad_row_idx(P, rows)),
        ))
        entries = []
        for row, item in zip(rows, taken):
            r = self._new_row(item)
            self.active[row] = r
            self._row_pos[row] = len(item[1])
            entries.append((row, r))
        return _InFlightAdmission(entries=entries, tok=_HostFetch(tok))

    def _admit_chunked(self, taken: list, rows: list[int], P: int,
                       head_prefix) -> None:
        """Chunked-prefill admission: no prefill program. The rows' blocks
        are reserved and their tables staged; admission is a positions
        reset, a table upload and a device-state merge pointing ``cur_pos``
        at the feed start. The prompts stream through the next ragged
        groups. Prefix rows start after the shared full blocks (``ns *
        bs``, whose positions are set here) and re-feed the partial tail,
        which lands in the row's first owned block."""
        eng = self.engine
        ns = len(self._row_shared[rows[0]]) if head_prefix is not None else 0
        start = ns * eng.block_size
        idx = self._dev(np.asarray(rows, np.int64))
        self.cache.positions.index_fill_(0, idx, -1)
        if start:
            self.cache.positions[idx, :start] = torch.arange(
                start, dtype=torch.int32, device=eng.device)
        self.cache.block_tables.copy_(self._dev(self._host_tables))
        starts = np.full(P, start, np.int32)
        self._set_state(*eng._admit_merge(
            self._tokens_dev, self._cur_pos_dev,
            torch.zeros(P, dtype=torch.int32, device=eng.device),
            self._dev(starts), self._dev(self._pad_row_idx(P, rows)),
        ))
        for row, item in zip(rows, taken):
            self.active[row] = self._new_row(item)
            self._row_pos[row] = start
            self._inflight_prefill[row] = list(item[1][start:])
            self._prefill_plen[row] = len(item[1])

    @staticmethod
    def _new_row(item) -> _Row:
        """The row of an admitted queue item; a resumed request's replayed
        tokens (the prompt's tail) preload its output, counted as
        emitted."""
        req_id, ids, gen, cb, scb, t_submit, _pfx, pri, rpl = item
        return _Row(req_id=req_id, gen=gen,
                    out=list(ids[len(ids) - rpl:]) if rpl else [],
                    done_cb=cb, stream_cb=scb, t_submit=t_submit,
                    priority=pri, replayed=rpl, emitted=rpl)

    def _maybe_preempt(self) -> int:
        """Evict the lowest-class running row when the head pending request
        strictly outranks it and admission is blocked on rows or blocks
        (scheduler.py:1128): at most one per step, so the freed capacity
        feeds this step's admission. Only settled rows with a ``req_id``,
        outside the in-flight prefill, are candidates. As ``_finish``
        without the terminal callback: the stream is flushed, the blocks
        released (owned freed, shared decrefed), and the emitted tokens
        go to ``preempt_cb``. The row's tokens in the group in flight are
        never read; the resume regenerates them."""
        cb = self.preempt_cb
        if cb is None or self.prefill_only:
            return 0
        with self._lock:
            if not self.pending:
                return 0
            head = self.pending[0]
            blocked = not self._free
        if not blocked and self._paged:
            need = -(-(len(head[1]) + head[2].max_new_tokens)
                     // self.engine.block_size)
            blocked = need > self.allocator.free_blocks
        if not blocked:
            return 0
        row = select_preemption_victim(
            [(i, r.priority, len(r.out)) for i, r in self.active.items()
             if r.req_id and not r.awaiting_first
             and i not in self._inflight_prefill],
            head[7])
        if row is None:
            return 0
        r = self.active.pop(row)
        self._flush_stream(r)
        self._row_pos.pop(row, None)
        self._prefill_plen.pop(row, None)
        self._paged_release_row(row)
        with self._lock:
            self._free.append(row)
        self.engine.metrics.add_preempted(1)
        trace.record(r.req_id, "evict", tokens=len(r.out),
                     priority=r.priority, for_priority=head[7])
        cb(r.req_id, list(r.out))
        return 1

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
        # prompt) and the group the admission overlapped. A resumed row
        # records neither: its client saw its first token before the
        # preemption.
        now = time.perf_counter()
        if not r.replayed:
            self.engine.metrics.ttft.record(now - r.t_submit)
            self.engine.metrics.add_request(1)
        if r.req_id:
            # "admit": submit to first token (queue, prefill, the group the
            # admission overlapped); the role worker's "prefill" span is
            # another phase.
            trace.record(r.req_id, "admit", dur_s=now - r.t_submit)
        r.awaiting_first = False
        eos = r.gen.eos_token_id if r.gen.eos_token_id is not None else -1
        if first == eos:
            self._finish(row, r)
            return
        if self.prefill_only and r.gen.max_new_tokens > 1:
            # The decode replica owns the request from here; a one-token
            # request is answered here.
            self._export_row(row, r, first,
                             n_tokens=self._prefill_plen.get(row))
            return
        r.out.append(first)
        self.engine.metrics.add_tokens(1)
        if len(r.out) >= r.gen.max_new_tokens + r.replayed:
            self._finish(row, r)
        else:
            self._flush_stream(r)

    def _export_row(self, row: int, r: _Row, first: int,
                    n_tokens: int | None = None) -> None:
        """Prefill-only epilogue (scheduler.py:1250): copy the row's prompt
        blocks to the host (complete on return), free the row, then hand
        the payload to ``export_cb``; freeing first means a failing
        callback cannot leak the row. ``n_tokens`` is the prompt length,
        given on the chunked path, where ``_row_pos`` has moved past it."""
        if n_tokens is None:
            n_tokens = self._row_pos[row]
        nb = -(-n_tokens // self.engine.block_size)
        blocks = export_blocks(self.cache, self._host_tables[row, :nb],
                               n_tokens)
        self.active.pop(row, None)
        self._row_pos.pop(row, None)
        self._inflight_prefill.pop(row, None)
        self._prefill_plen.pop(row, None)
        self._paged_release_row(row)
        with self._lock:
            self._free.append(row)
        self.engine.metrics.add_tokens(1)
        if self.export_cb is not None:
            self.export_cb(r.req_id, first, n_tokens, blocks)

    @torch.inference_mode()
    def adopt(self, req_id: str, first_token: int, n_tokens: int,
              blocks: dict, gen: GenerationParams,
              done_cb: Callable[..., None],
              stream_cb: Callable[[list[int]], None] | None = None) -> bool:
        """The decode half of the KV handoff (scheduler.py:1280): install a
        prompt's exported blocks into a free row and decode from slot
        ``n_tokens`` on with ``first_token``, without a prefill. Everything
        is validated before a row is taken; returns False, with nothing
        changed, when no row or not enough blocks are free.

        The blocks go into owned blocks in place, the whole host table is
        uploaded and the row's positions and decode state merged into the
        same tensors (``copy_``), so the step graphs' addresses hold. The
        payload bytes are the exported ones, the positions the mask a local
        prefill writes, and sampling is stateless per (seed, position), so
        the row continues the stream a local admission would give."""
        if not self._paged:
            raise ValueError("adopt requires kv_layout='paged'")
        if self.prefill_only:
            raise ValueError("a prefill-only batcher cannot adopt")
        gen.validate()
        eng = self.engine
        eng.check_capacity(n_tokens, gen.max_new_tokens)
        bs = eng.block_size
        nb = -(-n_tokens // bs)
        k_seg = blocks["k"]
        if k_seg is None or k_seg.shape[1] != nb:
            raise ValueError(
                f"payload has {None if k_seg is None else k_seg.shape[1]} "
                f"blocks, a prompt of {n_tokens} tokens needs {nb}")
        if k_seg.shape[2] != bs:
            raise ValueError(
                f"payload block_size {k_seg.shape[2]} != engine {bs}")
        if (blocks.get("k_scale") is not None) != self.cache.quantized:
            raise ValueError(
                "payload quantization does not match the engine's pool")
        if tuple(k_seg.shape[3:]) != tuple(self.cache.k.shape[3:]) or (
                k_seg.shape[0] != self.cache.k.shape[0]):
            raise ValueError(
                f"payload blocks {tuple(k_seg.shape)} do not fit the pool "
                f"{tuple(self.cache.k.shape)}")
        with self._lock:
            if not self._free:
                return False
            row = self._free.pop()
        need = -(-(n_tokens + gen.max_new_tokens) // bs)
        owned = self.allocator.alloc(need)
        if owned is None and self._paged_evict_idle_prefixes():
            owned = self.allocator.alloc(need)
        if owned is None:
            with self._lock:
                self._free.append(row)
            return False
        self._row_owned[row] = owned
        self._row_shared[row] = []
        self._row_reserve_t[row] = time.monotonic()
        self._host_tables[row, :] = self._sentinel
        self._host_tables[row, :need] = owned
        eng.metrics.set_kv_blocks(in_use=self.allocator.blocks_in_use)
        import_blocks(self.cache, blocks["k"], blocks["v"],
                      blocks.get("k_scale"), blocks.get("v_scale"),
                      owned[:nb])
        pos = np.full(eng.max_seq_len, -1, np.int32)
        pos[:n_tokens] = np.arange(n_tokens, dtype=np.int32)
        self.cache.positions[row].copy_(self._dev(pos))
        self.cache.block_tables.copy_(self._dev(self._host_tables))
        self._set_state(*eng._admit_merge(
            self._tokens_dev, self._cur_pos_dev,
            self._dev(np.asarray([first_token], np.int32)),
            self._dev(np.asarray([n_tokens], np.int32)),
            self._dev(np.asarray([row], np.int32)),
        ))
        if self._inflight is not None:
            self._inflight.stale_rows.add(row)
        r = _Row(req_id=req_id, gen=gen, out=[first_token], done_cb=done_cb,
                 stream_cb=stream_cb, awaiting_first=False,
                 t_submit=time.perf_counter())
        self.active[row] = r
        self._row_pos[row] = n_tokens
        eng.metrics.add_request(1)
        eng.metrics.add_tokens(1)
        if req_id:
            trace.record(req_id, "adopt", n_tokens=n_tokens, row=row)
        if len(r.out) >= gen.max_new_tokens:
            self._finish(row, r)
        else:
            self._flush_stream(r)
        return True

    def request_park(self, req_id: str, token_ids, replayed: int = 0) -> None:
        """Register park interest (scheduler.py:1410): when the request's
        row finishes served, ``park_cb`` receives its token sequence (the
        ids and the outputs past ``replayed``) and the row's exported full
        blocks. Thread-safe; without ``park_cb`` nothing parks."""
        with self._lock:
            self._park_ids[req_id] = (list(token_ids), int(replayed))

    def forget_park(self, req_id: str) -> None:
        """Withdraw park interest: the request never reached a row."""
        with self._lock:
            self._park_ids.pop(req_id, None)

    def _maybe_park(self, row: int, r: _Row, parked: tuple) -> None:
        """Export a finished row's KV for its session (scheduler.py:1426).
        The group in flight still advances the row past its last sampled
        token and may rewrite slots from T-1 on, so only the first
        ``(T-1)//bs`` full blocks are parked, and nothing when that group
        could wrap the ring onto slot 0. Best-effort, as in the
        reference: a failure is a drop (counted in ``park_failures``),
        never an error on the finished request."""
        ids, replayed = parked
        seq = list(ids) + [int(t) for t in r.out[replayed:]]
        T = len(seq)
        eng = self.engine
        bs = eng.block_size
        if T - 1 + self.group_chunks * self.chunk_steps > eng.max_seq_len:
            return
        nf = (T - 1) // bs
        if nf == 0:
            return
        try:
            if self._paged:
                blk = [int(b) for b in self._host_tables[row, :nf]]
                if any(b >= self._sentinel for b in blk):
                    return  # the row is shorter than its sequence claims
                blocks = export_blocks(self.cache, blk, nf * bs)
            else:
                blocks = export_dense_row(self.cache, row, nf * bs, bs)
            self.park_cb(r.req_id, seq[: nf * bs], blocks)
        except Exception:  # noqa: BLE001 — parking never fails a request
            self.park_failures += 1

    def _finish(self, row: int, r: _Row, cancelled: bool = False,
                error: str | None = None) -> None:
        self.active.pop(row, None)
        self._row_pos.pop(row, None)
        self._inflight_prefill.pop(row, None)
        self._prefill_plen.pop(row, None)
        with self._lock:
            parked = self._park_ids.pop(r.req_id, None)
        if (parked is not None and self.park_cb is not None
                and error is None and not cancelled):
            # Before the release: the blocks must still be this row's.
            self._maybe_park(row, r, parked)
        kv_block_s = self._paged_release_row(row)
        with self._lock:
            self._free.append(row)
        self._flush_stream(r)
        disposition = ("error" if error is not None
                       else "cancelled" if cancelled else "served")
        self.engine.metrics.add_finish(disposition)
        if r.req_id:
            trace.record(r.req_id, "finish", tokens=len(r.out),
                         disposition=disposition,
                         **({"kv_block_s": round(kv_block_s, 6)}
                            if kv_block_s else {}))
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
        """Host-side occupancy, pool headroom and the content hashes of the
        prefixes registered in the pool (the reference's prefix-affinity
        routing key); never touches a device tensor."""
        from llmss_tpu_torch.serve.protocol import prefix_hash

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
            "prefix_hashes": ([prefix_hash(pfx.tokens) for pfx, _blocks
                               in list(self._paged_prefixes.values())]
                              if self._paged else []),
        }

    def drain_all(self) -> list[str]:
        """Remove every pending and active request, without callbacks, and
        return their ids (worker teardown answers them)."""
        with self._lock:
            ids = [item[0] for item in self.pending]
            self.pending.clear()
            self._park_ids.clear()
        self._inflight = None
        self._pending_adm = None
        self._last_fetch_t = None
        self._row_pos.clear()
        self._inflight_prefill.clear()
        self._prefill_plen.clear()
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
        for r in self.active.values():
            if r.req_id and not r.awaiting_first:
                # Throttled and sheddable (``group_``).
                trace.record(r.req_id, "group_fetch", throttle_s=0.05,
                             chunks=nc, k=k)
        toks = flat[: nc * R * k].reshape(nc, R, k)
        poisoned = flat[nc * R * k:].reshape(nc, R).astype(bool)
        now = time.perf_counter()
        if self._last_fetch_t is not None and not group.has_admission:
            metrics.decode_step.record((now - self._last_fetch_t) / (nc * k))
        if self._last_fetch_t is not None and group.cost is not None:
            # Every group folds, admission and ragged groups too: the
            # interval holds whatever ran on the device between two fetches.
            devtel.fold(group.kind, now - self._last_fetch_t, group.cost)
        self._last_fetch_t = now
        n = 0
        t_cb = time.perf_counter()
        firsts = group.prefill_firsts or {}
        for c in range(nc):
            for i in list(self.active):
                r = self.active[i]
                if i in group.stale_rows:
                    continue
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
                    if len(r.out) >= r.gen.max_new_tokens + r.replayed:
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
        dt = devtel.enabled()
        done, eos, sa = self._chunk_args()
        done_d, eos_d = self._dev(done), self._dev(eos)
        busy = len(self.active) >= (3 * self.rows) // 4
        # A capture during this group is charged to its first request.
        eng.devtel_req_id = next(
            (r.req_id for r in self.active.values() if r.req_id), None)
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
            CB = self.chunked_prefill
            group = _InFlightGroup(
                packed=_HostFetch(packed), n_chunks=nc, k=k,
                has_admission=True, prefill_firsts=firsts,
                kind="ragged_group",
                # Priced as the reference prices it: every chunk slot of
                # every row computed, at max_seq_len.
                cost=eng.devtel_cost(
                    "ragged_group", (self.rows, nc, CB), batch=self.rows,
                    steps=nc, kv_len=None, prefill_tokens=nc * self.rows * CB,
                ) if dt else None)
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
            group = _InFlightGroup(
                packed=_HostFetch(packed), n_chunks=nc, k=k,
                has_admission=self._pending_adm is not None,
                cost=eng.devtel_cost(
                    "decode_group", (self.rows, nc, k, t_bucket),
                    batch=self.rows, steps=nc * k, kv_len=t_bucket,
                ) if dt else None)
        self._set_state(last_tok, cur_pos)
        eng.metrics.host_dispatch.record(time.perf_counter() - t0)
        eng.metrics.add_group()
        eng.devtel_req_id = None
        for r in self.active.values():
            if r.req_id and not r.awaiting_first:
                trace.record(r.req_id, "group_dispatch", throttle_s=0.05,
                             chunks=nc, k=k)

        prev, self._inflight = self._inflight, group
        n = self._process_group(prev) if prev is not None else 0
        n += self._resolve_admission(self._pending_adm)
        # Between resolve and admit: an evicted row's slot and blocks feed
        # this step's admission.
        self._maybe_preempt()
        self._pending_adm = self._admit_dispatch()
        if dt:
            self._devtel_sample()
        return n

    def _devtel_sample(self) -> None:
        """The counter tracks at a group boundary, at most every 0.05 s:
        host counters and host tables only, never a device sync (the
        memory figures are the caching allocator's host counters)."""
        now = time.monotonic()
        if now - self._devtel_last_t < 0.05:
            return
        self._devtel_last_t = now
        with self._lock:
            pending = len(self.pending)
            free_slots = len(self._free)
        prefill_rows = len(self._inflight_prefill)
        tracks = {
            "rows": {"decode": len(self.active) - prefill_rows,
                     "prefill": prefill_rows, "free": free_slots},
            "queue_depth": {"pending": pending},
        }
        if self._paged:
            alloc = self.allocator
            free = alloc.free_blocks
            tracks["kv_blocks"] = {"in_use": alloc.num_blocks - free,
                                   "free": free}
            tracks["kv_fragmentation"] = {
                "largest_free_run": alloc.largest_free_run(), "free": free}
        util = devtel.last_util()
        if util:
            tracks["mfu"] = {k: g["mfu"] for k, g in util.items()}
            tracks["mbu"] = {k: g["mbu"] for k, g in util.items()}
        mem = devtel.device_memory_stats(self.engine.device)
        if mem is not None:
            tracks["device_memory"] = mem
        devtel.record_counters(tracks, t=now)

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
