"""Serving on a mesh: rank 0 leads, every rank steps (counterpart: the
reference's one controller driving its whole mesh,
llmss_tpu/serve/consumer.py:1166-1179).

The reference's consumer is one process over every device of its mesh,
so its batcher's host decisions exist once. The port runs one process per
rank, each with its own ``ContinuousBatcher`` (or batch ``Worker``) over
its shard of the model and the pool, and only rank 0, the leader, holds
the broker. A batcher decides on the host which request takes which row
and blocks, how admissions batch, how the chunked prompts are planned,
what is preempted and when a row finishes; every one of those decisions
is a function of the events it was given and of the tokens its groups
returned, and the tokens are the same on every rank (the logits are
all-gathered over tp, and every dp replica runs every row). So ranks
that apply the same events before the same steps hold the same host
state and issue the same collectives.

``ServeControl`` carries the events. Before every step of the leader's
batcher it broadcasts what arrived since the last one: submissions
(request id, tokens, ``GenerationParams``, prefix tokens, priority,
replayed count) and cancels, whether preemption is on, and the digest of
its host state after the previous step (``ContinuousBatcher.host_digest``).
Each follower checks the digest against its own, raising ``Diverged``
before any collective of the step when they differ, applies the events to
its batcher with delivery callbacks that only record (``outputs``), and
steps. Prefixes are built when a submission is applied, on every rank
(``DecodeEngine.build_prefix`` is a prefill over the mesh), from an LRU
keyed by their tokens, of the worker's ``max_prefixes``. ``prewarm`` and
a new batcher (``attach``: the leader's batcher settings) are events too. For the batch ``Worker`` the
leader broadcasts each batch (prompts, params, chunking) before
``generate`` and each chunk's cancellations inside it, and the digest is
that of the batch's tokens.

Control travels on a gloo group of its own, never on an NCCL stream or
inside a captured graph. A follower whose leader has died gets an error
from that group (a closed connection, or the group's timeout while it
waits) and raises, so its process exits non-zero.
"""

from __future__ import annotations

import collections
import datetime
import hashlib
import threading
import time

import torch.distributed as dist

LEADER = 0  # the global rank that holds the broker
TIMEOUT_S = 1800.0  # how long a follower waits for the leader's next event


class Diverged(RuntimeError):
    """A follower's host state differs from the leader's."""


def _noop_preempt(req_id: str, tokens: list[int]) -> None:
    """A follower's preemption hook: the leader refunds the request."""


class ServeControl:
    """The control plane of one rank (module docstring). Make one on every
    rank, in the same order as the other process groups (it makes one).
    On the leader, ``attach`` a batcher, or give it to a ``Worker``; on a
    follower, ``follow``."""

    def __init__(self, engine, *, timeout_s: float = TIMEOUT_S,
                 keep_outputs: bool = False):
        self.engine = engine
        self.leader = dist.get_rank() == LEADER
        self.group = dist.new_group(
            backend="gloo", timeout=datetime.timedelta(seconds=timeout_s))
        self.batcher = None
        self._lock = threading.Lock()
        # The leader's events since the last step: ("submit", submit's
        # tuple) and ("cancel", req_id).
        self._events: list = []  # guarded_by: self._lock
        # The prefixes built, by their tokens (an LRU of ``max_prefixes``,
        # set by ``attach``).
        self._prefixes: collections.OrderedDict = collections.OrderedDict()
        self.max_prefixes = 0
        # The digest of this rank's host state after its last step (or
        # batch), the steps taken and the digests checked against the
        # leader's (followers), and a sha256 chained over every digest.
        self.digest = ""
        self.steps = self.checked = 0
        self.chain = ""
        # Seconds this rank's steps spent in the control: the events
        # applied and the digest, and on the leader the broadcast (which
        # waits for the followers to take it).
        self.host_s = 0.0
        # req_id -> {"tokens", "cancelled", "error"} of a follower's rows
        # (keep_outputs: a test or a smoke run compares them).
        self.outputs: dict | None = {} if keep_outputs else None

    # -- transport ------------------------------------------------------------

    def _send(self, msg) -> None:
        dist.broadcast_object_list([msg], src=LEADER, group=self.group)

    def _recv(self):
        box = [None]
        dist.broadcast_object_list(box, src=LEADER, group=self.group)
        return box[0]

    def lead(self, op: str, **fields) -> None:
        """Leader: send ``op`` with ``fields`` and this rank's digest."""
        self._send({"op": op, "digest": self.digest, **fields})

    def _check(self, digest: str) -> None:
        if digest != self.digest:
            raise Diverged(
                f"rank {dist.get_rank()} host state {self.digest[:12]} after "
                f"step {self.steps}, the leader's {digest[:12]}")
        self.checked += 1

    def _stepped(self, digest: str) -> None:
        self.digest = digest
        self.steps += 1
        self.chain = hashlib.sha256((self.chain + digest).encode()).hexdigest()

    # -- the leader's batcher -------------------------------------------------

    def attach(self, batcher, max_prefixes: int) -> None:
        """Leader: drive ``batcher`` on the mesh (the followers build one
        with its settings), building at most ``max_prefixes`` prefixes
        (the worker's LRU) on every rank."""
        self.batcher = batcher
        batcher.control = self
        self.max_prefixes = max_prefixes
        self.lead("batcher", max_prefixes=max_prefixes, kw=dict(
            rows=batcher.rows, chunk_steps=batcher.chunk_steps,
            group_chunks=batcher.group_chunks,
            chunked_prefill=batcher.chunked_prefill))

    def intake(self, item: tuple) -> None:
        """A validated submission (``ContinuousBatcher.submit``'s tuple, its
        prefix as token ids or None), applied at the next step."""
        with self._lock:
            self._events.append(("submit", item))

    def intake_cancel(self, req_id: str) -> None:
        with self._lock:
            self._events.append(("cancel", req_id))

    def queued_ids(self) -> list[str]:
        with self._lock:
            return [ev[0] for kind, ev in self._events if kind == "submit"]

    def has_events(self) -> bool:
        with self._lock:
            return bool(self._events)

    def before_step(self, batcher) -> None:
        """Leader: broadcast the events since the last step, then apply
        them here (with the callers' callbacks)."""
        t0 = time.perf_counter()
        with self._lock:
            events, self._events = self._events, []
        # The wire form of a submission: no callbacks, no submit time.
        wire = [(kind, (ev[0], ev[1], ev[2], ev[6], ev[7], ev[8])
                 if kind == "submit" else ev) for kind, ev in events]
        self.lead("step", events=wire,
                  preempt=batcher.preempt_cb is not None)
        self._apply(batcher, wire, [ev for kind, ev in events
                                    if kind == "submit"])
        self.host_s += time.perf_counter() - t0

    def after_step(self, batcher) -> None:
        t0 = time.perf_counter()
        self._stepped(batcher.host_digest())
        self.host_s += time.perf_counter() - t0

    def evict_idle_prefixes(self) -> int:
        """Leader: free every idle registered prefix on every rank (a
        pass's end, to see the pool drain to zero); returns the count."""
        self.lead("evict")
        n = self.batcher._paged_evict_idle_prefixes()
        self._stepped(self.batcher.host_digest())
        return n

    def mark(self, tag: str = "") -> None:
        """Leader: a point every follower's ``follow(on_mark=)`` sees, with
        the digests checked there (a pass's start or end)."""
        self.lead("mark", tag=tag)

    def stop(self) -> None:
        """Leader: end every follower's ``follow``."""
        self.lead("stop")

    def _prefix(self, tokens: tuple):
        """The ``Prefix`` of ``tokens``, built (a prefill on every rank) on
        a miss; the LRU keeps the last ``max_prefixes``."""
        pfx = self._prefixes.pop(tokens, None)
        if pfx is None:
            pfx = self.engine.build_prefix(list(tokens))
        self._prefixes[tokens] = pfx
        while len(self._prefixes) > self.max_prefixes:
            self._prefixes.popitem(last=False)
        return pfx

    def _apply(self, batcher, wire: list, items: list | None = None) -> None:
        """Apply a step's events in order: submissions queued (their
        prefixes built), cancels marked. ``items``: the leader's own
        submissions in order, with their callbacks and submit times."""
        mine = iter(items or ())
        for kind, ev in wire:
            if kind == "cancel":
                batcher.mark_cancelled(ev)
                continue
            rid, ids, gen, ptoks, priority, replayed = ev
            if items is not None:
                _, _, _, done_cb, stream_cb, t_submit, *_ = next(mine)
            else:
                done_cb, stream_cb, t_submit = (self._deliver(rid), None,
                                                time.perf_counter())
            pfx = None if ptoks is None else self._prefix(tuple(ptoks))
            batcher.enqueue((rid, ids, gen, done_cb, stream_cb, t_submit, pfx,
                             priority, replayed))

    def _deliver(self, rid: str):
        """A follower's delivery callback: it records, when asked to."""

        def done(tokens, cancelled=False, error=None):
            if self.outputs is not None:
                self.outputs[rid] = {"tokens": list(tokens),
                                     "cancelled": cancelled, "error": error}

        return done

    # -- the leader's batch worker --------------------------------------------

    def lead_prewarm(self, batch: int, chunk_steps) -> None:
        """Leader: the batch worker's ``engine.prewarm``, on every rank."""
        self.lead("engine_prewarm", batch=batch, chunk_steps=chunk_steps)

    def lead_generate(self, prompts, gens, chunk_steps: int,
                      live_rows: int | None, cancel_poll=None):
        """Leader: broadcast a batch, then return ``cancel_poll`` wrapped so
        each chunk's cancellations reach the followers too."""
        self.lead("generate", prompts=prompts, gens=gens,
                  chunk_steps=chunk_steps, live_rows=live_rows)

        def poll():
            rows = list(cancel_poll()) if cancel_poll is not None else []
            self._send(rows)
            return rows

        return poll

    def generated(self, outs: list) -> None:
        """Leader and followers: a batch's tokens, digested."""
        self._stepped(hashlib.sha256(repr(outs).encode()).hexdigest())

    def tick(self) -> None:
        """Leader: nothing to run (keeps the followers' wait short)."""
        self.lead("tick")

    # -- followers ------------------------------------------------------------

    def follow(self, on_mark=None) -> int:
        """Follower: run what the leader sends until it stops; returns the
        steps taken. ``on_mark(control, tag)`` runs at each ``mark``."""
        from llmss_tpu_torch.engine.scheduler import ContinuousBatcher

        if self.leader:
            raise RuntimeError("the leader does not follow")
        while True:
            msg = self._recv()
            t0 = time.perf_counter()
            op = msg["op"]
            self._check(msg["digest"])
            if op == "batcher":
                self.batcher = ContinuousBatcher(self.engine, **msg["kw"])
                self.max_prefixes = msg["max_prefixes"]
            elif op == "prewarm":
                self.batcher.prewarm(*msg["args"])
            elif op == "step":
                bat = self.batcher
                bat.preempt_cb = _noop_preempt if msg["preempt"] else None
                self._apply(bat, msg["events"])
                t1 = time.perf_counter()
                bat.step()
                t2 = time.perf_counter()
                self._stepped(bat.host_digest())
                self.host_s += t1 - t0 + time.perf_counter() - t2
            elif op == "evict":
                self.batcher._paged_evict_idle_prefixes()
                self._stepped(self.batcher.host_digest())
            elif op == "engine_prewarm":
                self.engine.prewarm(msg["batch"],
                                    chunk_steps=msg["chunk_steps"])
            elif op == "generate":
                outs = self.engine.generate(
                    msg["prompts"], msg["gens"], cancel_poll=self._recv,
                    chunk_steps=msg["chunk_steps"],
                    live_rows=msg["live_rows"])
                self.generated(outs)
            elif op == "mark":
                if on_mark is not None:
                    on_mark(self, msg["tag"])
            elif op == "stop":
                return self.steps
            elif op != "tick":
                raise ValueError(f"unknown control op {op!r}")
