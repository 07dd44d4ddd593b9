"""Brokers: the request queue and id-correlated responses, delivered at
least once (counterpart: llmss_tpu/serve/broker.py).

The delivery contract is the reference's:

- ``pop_request`` is a lease with a visibility timeout (``lease_s``). The
  worker that holds it answers (``push_response`` acks the lease) or
  renews it (``touch_requests``) while it decodes.
- A lease that expires un-acked is reaped lazily, at the top of every
  ``pop_request``: redelivered at the head of its class queue with
  ``delivery_attempts`` incremented; dead-lettered (``read_dlq``) with a
  terminal error once the attempts reach ``max_delivery_attempts``; shed
  with "deadline exceeded" when its ``deadline_ts`` has passed.
- ``release_requests`` hands back leased requests a draining worker never
  started, refunding the attempt; ``preempt_requests`` requeues the
  caller's preempted request objects (with their resume point) the same
  way, counted as ``preempted``.
- Requests queue per SLO class and drain in class-priority order.
  Cancellation flags and stream tombstones are TTL'd membership state;
  responses nobody collects age out after ``response_ttl_s``.

``InProcBroker`` keeps it all in one process. ``RedisBroker`` keeps it in
Redis with the reference's key layout and JSON, so a reference producer
and a port worker (or the other way round) can share one Redis during a
migration: requests on ``pqueue`` (standard) and ``pqueue:cls:{class}``,
leases at ``pqueue:lease:{worker}:{id}``, responses at ``squeue:{id}``,
flags at ``cancelled:{id}``, streams at ``stream:{id}``, the DLQ at
``pqueue:dlq``, counters at ``pqueue:stats:{name}``, metrics at
``llmss:metrics``.

The KV handoff channel (disaggregated prefill/decode, serve/handoff.py):
``push_handoff`` queues a ``HandoffRecord`` and then settles the request's
lease (the record is the prefill worker's ack), counting ``handoffs`` and
``handoff_bytes``; ``pop_handoff`` leases it to a decode worker, which
renews it (``touch_handoffs``) and answers (``push_response`` acks it). A
handoff lease that expires, or a record the decode worker cannot adopt
(``fail_handoff``), sends the request back to its class queue for a fresh
prefill (``reprefills``), or dead-letters it at the attempt budget, or
sheds it past its deadline. Redis keeps the records on ``pqueue:h`` and
their leases at ``pqueue:hlease:{worker}:{id}``.

The fleet (serve/fleet.py): workers register a ``worker_id`` with their
capabilities and publish load snapshots into a TTL'd registry
(``register_worker`` / ``publish_worker_load`` / ``read_workers``, entries
gone ``worker_ttl_s`` after their last refresh); a router pushes a request
onto one worker's routed queue (``push_request_to``), which that worker
pops before the shared queue (``pop_request(worker_id=)``), class by
class, and each lease records its worker (``lease_holders``).
``failover_worker`` evacuates a dead worker: its routed requests come back
without spending a delivery attempt, and its leases are force-expired
through the normal disposition (deadline-shed and dead-letter answered,
the rest returned), counted as ``failover_rerouted``. Handoff records route
the same way (``push_handoff_to``, ``handoff_depths``, ``handoff_holders``,
``failover_handoffs``: routed records come back with their payloads, leased
ones prefill again). Redis keeps entries at ``{pqueue}:worker:{id}`` (the
embedded ``_expires_at``, on the server's clock, is the truth; the key's
TTL only collects garbage), routed queues at ``{pqueue}:w:{id}`` and
``{pqueue}:w:{id}:cls:{class}``, routed records at ``{pqueue}:h:{id}``. A
worker id must not hold ``:``.

Every hop records flight-recorder events (utils/trace.py) at the
reference's sites: ``enqueue``, ``lease``, ``lease_renew``, ``redeliver``,
``deadline``, ``dead_letter``, ``release``, ``preempt``, ``handoff_push``,
``handoff_lease``, ``handoff_renew``, ``reprefill``, ``failover`` and
``respond``.

At ``respond`` the broker derives the request's ``RequestCost`` from this
process's recorder and feeds the windowed series
(``metrics.observe_request_cost``): once per request, in the process that
settles it (broker.py:84-95).

The controller epoch (serve/controller.py): ``acquire_controller_epoch``
bumps a fleet-wide counter and records its holder, and a controller acts
only while ``controller_epoch`` still equals its own. In-process it is an
attribute; Redis keeps it at ``{pqueue}:ctrl:epoch`` (``INCR``) with the
holder at ``{pqueue}:ctrl:holder``.
"""

from __future__ import annotations

import abc
import collections
import dataclasses
import json
import queue
import random
import threading
import time
import uuid

from llmss_tpu_torch.serve.handoff import HandoffRecord
from llmss_tpu_torch.serve.protocol import (
    SLO_CLASS_STANDARD, SLO_CLASSES, GenerateRequest, GenerateResponse,
    prefix_hash,
)
from llmss_tpu_torch.utils import metrics as metrics_mod
from llmss_tpu_torch.utils import trace

# The reference's delivery counters, in its order (delivery_stats).
_COUNTERS = ("redelivered", "dead_lettered", "deadline_expired",
             "failover_rerouted", "handoffs", "handoff_bytes", "reprefills",
             "preempted")


def _req_class(req: GenerateRequest) -> str:
    """The request's queue class; an unknown value degrades to standard."""
    return req.slo_class if req.slo_class in SLO_CLASSES else SLO_CLASS_STANDARD


def _enqueue_attrs(req: GenerateRequest) -> dict:
    """The ``enqueue`` event's attributes (broker.py:55): lengths, the
    prefix's hash, class and session; never prompt text."""
    a: dict = {}
    if req.token_ids is not None:
        a["plen"] = len(req.token_ids)
    a["max_new"] = req.max_new_tokens
    if req.prefix_token_ids:
        a["prefix"] = prefix_hash(req.prefix_token_ids)
    a["slo_class"] = req.slo_class
    if req.session_id:
        a["session"] = req.session_id
        if req.turn is not None:
            a["turn"] = int(req.turn)
    return a


def _record_enqueue(req: GenerateRequest, queue_name: str) -> None:
    trace.ensure_context(req)
    trace.record(req.id, "enqueue", trace_id=req.trace_id, queue=queue_name,
                 **_enqueue_attrs(req))


def _observe_cost(resp: GenerateResponse) -> None:
    """The request's cost from this process's recorder into the windowed
    series; a no-op with tracing off."""
    if not trace.enabled():
        return
    cost = trace.local_cost(resp.id, error=resp.error)
    if cost is not None:
        metrics_mod.observe_request_cost(cost)


class Broker(abc.ABC):
    # An un-acked, un-touched lease older than this is abandoned and its
    # request redelivered; workers touch their leases once per group.
    lease_s = 60.0
    # Deliveries a request gets before it is dead-lettered.
    max_delivery_attempts = 3
    # A registry entry not refreshed for this long is dropped from
    # read_workers: a vanished worker ages out of the fleet view.
    worker_ttl_s = 60.0
    CANCEL_TTL_S = 600.0
    # Optional () -> dict merged into every publish_metrics (the
    # supervisor's health block), so a worker-side publish never erases it.
    metrics_extra = None

    @abc.abstractmethod
    def push_request(self, req: GenerateRequest) -> None: ...

    @abc.abstractmethod
    def pop_request(self, timeout: float = 0.0,
                    worker_id: str | None = None) -> GenerateRequest | None:
        """Lease the next request, waiting up to ``timeout`` seconds: the
        routed queue of ``worker_id`` first (class by class), then the
        shared queue; the lease records ``worker_id``."""

    @abc.abstractmethod
    def push_response(self, resp: GenerateResponse) -> None: ...

    @abc.abstractmethod
    def wait_response(
        self, request_id: str, timeout: float = 60.0
    ) -> GenerateResponse | None: ...

    @abc.abstractmethod
    def touch_requests(self, request_ids) -> None:
        """Renew the visibility timeout of the leases this worker holds."""

    @abc.abstractmethod
    def reap_expired(self) -> int:
        """Redeliver, dead-letter or deadline-shed expired leases; returns
        the number reaped (``pop_request`` runs it first)."""

    @abc.abstractmethod
    def release_requests(self, request_ids) -> int:
        """Requeue leased, never-started requests at the head of their
        class queue with the delivery attempt refunded; unknown ids are
        ignored. Returns the number requeued."""

    @abc.abstractmethod
    def preempt_requests(self, reqs) -> int:
        """Requeue preempted requests, the caller's objects (they carry the
        worker's ``resume_tokens`` / ``preemptions``), at the head of their
        class queue with the delivery attempt refunded, counting
        ``preempted``; an id whose lease is gone is ignored. Returns the
        number requeued."""

    # -- the fleet: registry and routed queues ---------------------------------------

    @abc.abstractmethod
    def register_worker(self, info: dict) -> None:
        """Announce a worker: ``info`` carries ``worker_id`` and its
        capabilities. Registering again merges and refreshes the TTL."""

    @abc.abstractmethod
    def publish_worker_load(self, worker_id: str, snapshot: dict) -> None:
        """Merge a load snapshot into the worker's entry and refresh its
        TTL; an unknown id is registered by it."""

    @abc.abstractmethod
    def deregister_worker(self, worker_id: str) -> None: ...

    @abc.abstractmethod
    def read_workers(self) -> dict:
        """``{worker_id: info}``, expired entries purged."""

    @abc.abstractmethod
    def push_request_to(self, worker_id: str, req: GenerateRequest) -> None:
        """Queue a request on one worker's routed queue."""

    # -- the controller epoch ------------------------------------------------

    def acquire_controller_epoch(self, controller_id: str = "") -> int:
        """Take controller leadership: bump and return the fleet epoch; a
        controller holding an older one is fenced from acting."""
        epoch = getattr(self, "_ctrl_epoch", 0) + 1
        self._ctrl_epoch = epoch
        self._ctrl_holder = controller_id
        return epoch

    def controller_epoch(self) -> int:
        """The current epoch (0: no controller ever)."""
        return getattr(self, "_ctrl_epoch", 0)

    def controller_holder(self) -> str:
        """The id of the latest epoch's holder ('' if none)."""
        return getattr(self, "_ctrl_holder", "")

    @abc.abstractmethod
    def routed_depths(self) -> dict:
        """``{worker_id: depth}`` of the non-empty routed queues."""

    @abc.abstractmethod
    def lease_holders(self) -> dict:
        """``{worker_id: leases}`` of the leases attributed to a worker."""

    @abc.abstractmethod
    def failover_worker(self, worker_id: str) -> list[GenerateRequest]:
        """Evacuate a dead worker: its routed requests (no delivery attempt
        spent) and its force-expired leases that the disposition requeues
        (deadline-shed and dead-lettered ones are answered here). Returns
        the requests for the caller to route to survivors."""

    # -- the handoff channel -----------------------------------------------------------

    @abc.abstractmethod
    def push_handoff(self, record: HandoffRecord) -> None:
        """Queue a record, then settle its request's lease."""

    @abc.abstractmethod
    def push_handoff_to(self, worker_id: str, record: HandoffRecord) -> None:
        """Queue a record for one decode worker, then settle its request's
        lease."""

    @abc.abstractmethod
    def pop_handoff(self, timeout: float = 0.0,
                    worker_id: str | None = None) -> HandoffRecord | None:
        """Lease the next record, ``worker_id``'s routed records first,
        waiting up to ``timeout`` seconds on the shared queue."""

    @abc.abstractmethod
    def touch_handoffs(self, request_ids) -> None:
        """Renew the handoff leases this worker holds."""

    @abc.abstractmethod
    def ack_handoff(self, request_id: str) -> None:
        """Settle a handoff lease without answering."""

    def fail_handoff(self, record: HandoffRecord,
                     error: str | None = None) -> None:
        """A record the decode worker cannot adopt: settle its lease and
        dispose of its request now (``_dispose_handoff``)."""
        self.ack_handoff(record.req.id)
        self._dispose_handoff(record)

    @abc.abstractmethod
    def handoff_depth(self) -> int:
        """Records waiting, shared and routed."""

    @abc.abstractmethod
    def handoff_depths(self) -> dict:
        """``{worker_id: depth}`` of the non-empty routed handoff queues."""

    @abc.abstractmethod
    def handoff_holders(self) -> dict:
        """``{worker_id: leases}`` of the handoff leases held by a worker."""

    @abc.abstractmethod
    def failover_handoffs(self, worker_id: str) -> list[HandoffRecord]:
        """Evacuate a dead decode worker's handoffs: its routed records are
        returned with their payloads for the caller to route again, its
        leased ones disposed of (their adopted KV died with it: prefill
        again, or dead-letter, or shed)."""

    # -- depths, the DLQ, cancellation, streams, metrics --------------------------------

    @abc.abstractmethod
    def queue_depth(self) -> int:
        """Requests waiting (not leased), shared and routed: the
        producer's admission signal."""

    @abc.abstractmethod
    def queue_depths_by_class(self) -> dict: ...

    @abc.abstractmethod
    def dlq_depth(self) -> int: ...

    @abc.abstractmethod
    def read_dlq(self, limit: int = 100) -> list[dict]:
        """The newest dead-lettered requests first, as plain dicts."""

    @abc.abstractmethod
    def delivery_stats(self) -> dict:
        """Queue, lease and DLQ depths and the delivery counters."""

    @abc.abstractmethod
    def cancel_request(self, request_id: str) -> None: ...

    @abc.abstractmethod
    def check_cancelled(self, request_ids) -> set[str]:
        """The subset of ``request_ids`` whose cancellation flag is set."""

    @abc.abstractmethod
    def push_stream(self, request_id: str, token_ids: list[int]) -> None: ...

    @abc.abstractmethod
    def pop_stream(
        self, request_id: str, timeout: float = 0.0
    ) -> list[int] | None:
        """The request's next token increment, or None on timeout."""

    @abc.abstractmethod
    def drop_stream(self, request_id: str) -> None: ...

    @abc.abstractmethod
    def publish_metrics(self, metrics: dict) -> None: ...

    @abc.abstractmethod
    def read_metrics(self) -> dict: ...

    def _merged(self, metrics: dict) -> dict:
        if self.metrics_extra is not None:
            try:
                return {**metrics, **self.metrics_extra()}
            except Exception:  # noqa: BLE001 — the health hook must not break IO
                return metrics
        return metrics

    # -- lease expiry ----------------------------------------------------------

    def _disposition(self, req: GenerateRequest) -> str:
        """``"expired"`` past the request's deadline, ``"dead-letter"`` at
        the attempt budget, else ``"requeue"``."""
        if req.deadline_ts is not None and time.time() > req.deadline_ts:
            return "expired"
        if req.delivery_attempts >= self.max_delivery_attempts:
            return "dead-letter"
        return "requeue"

    def _answer_terminal(self, req: GenerateRequest, disp: str) -> None:
        """Shed (``"expired"``) or dead-letter a request, and answer it."""
        if disp == "expired":
            self._count("deadline_expired")
            trace.record(req.id, "deadline", attempt=req.delivery_attempts)
            self.push_response(GenerateResponse(
                id=req.id, error="deadline exceeded before completion"))
            return
        self._count("dead_lettered")
        self._to_dlq(req)
        trace.record(req.id, "dead_letter", attempt=req.delivery_attempts)
        self.push_response(GenerateResponse(
            id=req.id, error=(f"dead-lettered after {req.delivery_attempts} "
                              "delivery attempts")))

    def _settle_expired(self, req: GenerateRequest,
                        reprefill: bool = False) -> None:
        """Disposition of a lease that expired un-acked: shed past its
        deadline, dead-letter at the attempt budget, else redeliver (a
        handoff's request: prefill again, its trace attempt bumped)."""
        disp = self._disposition(req)
        if disp != "requeue":
            self._answer_terminal(req, disp)
        elif reprefill:
            self._count("reprefills")
            req.trace_attempt += 1
            trace.record(req.id, "reprefill", trace_id=req.trace_id,
                         attempt=req.trace_attempt)
            self._requeue(req)
        else:
            self._count("redelivered")
            trace.record(req.id, "redeliver", attempt=req.delivery_attempts)
            self._requeue(req)

    def _dispose_handoff(self, record: HandoffRecord) -> None:
        """A handoff whose decode never completed: its exported KV is gone,
        so the request prefills again, or dead-letters, or is shed."""
        self._settle_expired(record.req, reprefill=True)

    def _failed_over(self, worker_id: str, routed: list,
                     held: list[GenerateRequest]) -> list[GenerateRequest]:
        """``failover_worker``'s disposition: the routed requests and the
        force-expired leases the disposition requeues come back, counted
        as ``failover_rerouted``; the rest are answered here."""
        out = list(routed)
        for req in held:
            disp = self._disposition(req)
            if disp == "requeue":
                out.append(req)
            else:
                self._answer_terminal(req, disp)
        if out:
            self._count("failover_rerouted", len(out))
        for req in out:
            trace.record(req.id, "failover", worker=worker_id)
        return out

    def _failed_over_handoffs(self, worker_id: str, routed: list,
                              held: list) -> list:
        """``failover_handoffs``' disposition (see there)."""
        for rec in held:
            self._dispose_handoff(rec)
        if routed:
            self._count("failover_rerouted", len(routed))
        for rec in routed:
            trace.record(rec.req.id, "failover", worker=worker_id,
                         kind="handoff")
        return list(routed)

    def _record_respond(self, resp: GenerateResponse) -> None:
        trace.record(resp.id, "respond", ok=resp.error is None,
                     **({"error": resp.error} if resp.error else {}),
                     **({"n_tokens": len(resp.token_ids)}
                        if resp.token_ids else {}))
        _observe_cost(resp)

    @abc.abstractmethod
    def _count(self, name: str, n: int = 1) -> None: ...

    @abc.abstractmethod
    def _to_dlq(self, req: GenerateRequest) -> None: ...

    @abc.abstractmethod
    def _requeue(self, req: GenerateRequest) -> None:
        """Put a request back at the head of its class queue."""


def _queue_drain(q: queue.Queue) -> list:
    out = []
    while True:
        try:
            out.append(q.get_nowait())
        except queue.Empty:
            return out


class InProcBroker(Broker):
    """Queues and maps in one process, for tests and one-process serving."""

    def __init__(
        self,
        *,
        lease_s: float | None = None,
        max_delivery_attempts: int | None = None,
        response_ttl_s: float | None = None,
        worker_ttl_s: float | None = None,
    ):
        if lease_s is not None:
            self.lease_s = lease_s
        if max_delivery_attempts is not None:
            self.max_delivery_attempts = max_delivery_attempts
        if worker_ttl_s is not None:
            self.worker_ttl_s = worker_ttl_s
        self.response_ttl_s = (
            self.CANCEL_TTL_S if response_ttl_s is None else response_ttl_s
        )
        self._queues = {c: collections.deque() for c in SLO_CLASSES}  # guarded_by: self._req_cond
        self._req_cond = threading.Condition()
        self._responses: dict[str, GenerateResponse] = {}  # guarded_by: self._cond
        self._response_expiry: dict[str, float] = {}  # guarded_by: self._cond
        self._cond = threading.Condition()
        self._metrics: dict = {}
        self._cancels: dict[str, float] = {}  # guarded_by: self._cancel_lock
        self._cancel_lock = threading.Lock()
        self._streams: dict[str, queue.Queue] = {}  # guarded_by: self._stream_lock
        # Dropped streams' tombstones: id -> expiry.
        self._dead_streams: dict[str, float] = {}  # guarded_by: self._stream_lock
        self._stream_lock = threading.Lock()
        # id -> (monotonic expiry, request, worker id or None): the worker
        # lets failover_worker evacuate exactly one worker's leases.
        self._leases: dict[str, tuple[float, GenerateRequest, str | None]] = {}  # guarded_by: self._lease_lock
        self._dlq: list[GenerateRequest] = []  # guarded_by: self._lease_lock
        self._counts = dict.fromkeys(_COUNTERS, 0)  # guarded_by: self._lease_lock
        # The handoff channel: the shared records, and their leases as
        # id -> (monotonic expiry, record, worker id or None).
        self._handoffs: queue.Queue = queue.Queue()
        self._handoff_leases: dict[str, tuple[float, HandoffRecord, str | None]] = {}  # guarded_by: self._lease_lock
        self._lease_lock = threading.Lock()
        # The fleet: routed queues by worker and class, routed records by
        # worker, and the registry with its monotonic expiries.
        self._routed: dict[str, dict[str, collections.deque]] = {}  # guarded_by: self._route_lock
        self._handoff_routed: dict[str, queue.Queue] = {}  # guarded_by: self._route_lock
        self._route_lock = threading.Lock()
        self._workers: dict[str, dict] = {}  # guarded_by: self._worker_lock
        self._worker_expiry: dict[str, float] = {}  # guarded_by: self._worker_lock
        self._worker_lock = threading.Lock()

    # -- requests ----------------------------------------------------------------

    def _enqueue(self, req: GenerateRequest, *, head: bool = False) -> None:
        with self._req_cond:
            q = self._queues[_req_class(req)]
            (q.appendleft if head else q.append)(req)
            self._req_cond.notify_all()

    def _requeue(self, req: GenerateRequest) -> None:
        self._enqueue(req, head=True)

    def _count(self, name: str, n: int = 1) -> None:
        with self._lease_lock:
            self._counts[name] += n

    def _to_dlq(self, req: GenerateRequest) -> None:
        with self._lease_lock:
            self._dlq.append(req)

    def push_request(self, req: GenerateRequest) -> None:
        _record_enqueue(req, "shared")
        self._enqueue(req)

    def _pop_routed(self, worker_id: str) -> GenerateRequest | None:
        with self._route_lock:
            by_cls = self._routed.get(worker_id)
            if by_cls:
                for cls in SLO_CLASSES:
                    q = by_cls.get(cls)
                    if q:
                        return q.popleft()
        return None

    def pop_request(self, timeout: float = 0.0,
                    worker_id: str | None = None) -> GenerateRequest | None:
        self.reap_expired()
        req = self._pop_routed(worker_id) if worker_id is not None else None
        if req is None:
            deadline = time.monotonic() + timeout
            with self._req_cond:
                while not any(self._queues.values()):
                    remaining = deadline - time.monotonic()
                    if not timeout or remaining <= 0:
                        return None
                    self._req_cond.wait(remaining)
                req = next(q for q in self._queues.values() if q).popleft()
        req.delivery_attempts += 1
        with self._lease_lock:
            self._leases[req.id] = (time.monotonic() + self.lease_s, req,
                                    worker_id)
        trace.record(req.id, "lease", trace_id=req.trace_id, worker=worker_id,
                     attempt=req.delivery_attempts)
        return req

    def touch_requests(self, request_ids) -> None:
        now = time.monotonic()
        with self._lease_lock:
            for rid in request_ids:
                held = self._leases.get(rid)
                if held is not None:
                    self._leases[rid] = (now + self.lease_s, *held[1:])
                    trace.record(rid, "lease_renew", throttle_s=1.0)

    def reap_expired(self) -> int:
        now = time.monotonic()
        with self._lease_lock:
            dead = [held[1] for held in self._leases.values() if held[0] <= now]
            for req in dead:
                del self._leases[req.id]
            hdead = [held[1] for held in self._handoff_leases.values()
                     if held[0] <= now]
            for rec in hdead:
                del self._handoff_leases[rec.req.id]
        for req in dead:
            self._settle_expired(req)
        for rec in hdead:
            self._dispose_handoff(rec)
        return len(dead) + len(hdead)

    def release_requests(self, request_ids) -> int:
        n = 0
        for rid in request_ids:
            with self._lease_lock:
                held = self._leases.pop(rid, None)
            if held is None:
                continue
            req = held[1]
            req.delivery_attempts = max(0, req.delivery_attempts - 1)
            trace.record(rid, "release")
            self._enqueue(req, head=True)
            n += 1
        return n

    def preempt_requests(self, reqs) -> int:
        n = 0
        for req in reqs:
            with self._lease_lock:
                held = self._leases.pop(req.id, None)
            if held is None:
                continue  # reaped meanwhile: the reaper's requeue stands
            req.delivery_attempts = max(0, req.delivery_attempts - 1)
            self._count("preempted")
            trace.record(req.id, "preempt", trace_id=req.trace_id,
                         slo_class=req.slo_class, preemptions=req.preemptions,
                         n_resume=len(req.resume_tokens or ()))
            self._enqueue(req, head=True)
            n += 1
        return n

    # -- the fleet -------------------------------------------------------------------

    def register_worker(self, info: dict) -> None:
        self.publish_worker_load(info["worker_id"], info)

    def publish_worker_load(self, worker_id: str, snapshot: dict) -> None:
        with self._worker_lock:
            entry = self._workers.setdefault(worker_id,
                                             {"worker_id": worker_id})
            entry.update(snapshot)
            self._worker_expiry[worker_id] = (time.monotonic()
                                              + self.worker_ttl_s)

    def deregister_worker(self, worker_id: str) -> None:
        with self._worker_lock:
            self._workers.pop(worker_id, None)
            self._worker_expiry.pop(worker_id, None)

    def read_workers(self) -> dict:
        now = time.monotonic()
        with self._worker_lock:
            for wid in [w for w, t in self._worker_expiry.items() if t <= now]:
                del self._worker_expiry[wid]
                self._workers.pop(wid, None)
            return {wid: dict(info) for wid, info in self._workers.items()}

    def acquire_controller_epoch(self, controller_id: str = "") -> int:
        with self._worker_lock:
            return super().acquire_controller_epoch(controller_id)

    def push_request_to(self, worker_id: str, req: GenerateRequest) -> None:
        _record_enqueue(req, worker_id)
        with self._route_lock:
            by_cls = self._routed.setdefault(worker_id, {})
            by_cls.setdefault(_req_class(req), collections.deque()).append(req)

    def routed_depths(self) -> dict:
        with self._route_lock:
            out = {wid: sum(len(q) for q in by_cls.values())
                   for wid, by_cls in self._routed.items()}
        return {wid: d for wid, d in out.items() if d > 0}

    @staticmethod
    def _holders(leases: dict) -> dict:
        out: dict[str, int] = {}
        for held in leases.values():
            if held[2] is not None:
                out[held[2]] = out.get(held[2], 0) + 1
        return out

    def lease_holders(self) -> dict:
        with self._lease_lock:
            return self._holders(self._leases)

    def _take_leases(self, leases: dict, worker_id: str) -> list:
        """Remove and return what ``worker_id`` holds in ``leases``."""
        with self._lease_lock:
            rids = [rid for rid, held in leases.items()
                    if held[2] == worker_id]
            return [leases.pop(rid)[1] for rid in rids]

    def failover_worker(self, worker_id: str) -> list[GenerateRequest]:
        with self._route_lock:
            by_cls = self._routed.pop(worker_id, None) or {}
        routed = [req for cls in SLO_CLASSES for req in by_cls.get(cls, ())]
        return self._failed_over(worker_id, routed,
                                 self._take_leases(self._leases, worker_id))

    # -- the handoff channel ---------------------------------------------------------

    def _handoff_settled(self, record: HandoffRecord) -> None:
        # The record is queued first, then the request's lease settled: a
        # failure in between duplicates work, never loses the request.
        with self._lease_lock:
            self._leases.pop(record.req.id, None)
            self._counts["handoffs"] += 1
            self._counts["handoff_bytes"] += len(record.payload)

    def push_handoff(self, record: HandoffRecord) -> None:
        trace.record(record.req.id, "handoff_push",
                     trace_id=record.req.trace_id, bytes=len(record.payload),
                     target="shared")
        self._handoffs.put(record)
        self._handoff_settled(record)

    def push_handoff_to(self, worker_id: str, record: HandoffRecord) -> None:
        trace.record(record.req.id, "handoff_push",
                     trace_id=record.req.trace_id, bytes=len(record.payload),
                     target=worker_id)
        with self._route_lock:
            q = self._handoff_routed.setdefault(worker_id, queue.Queue())
        q.put(record)
        self._handoff_settled(record)

    def pop_handoff(self, timeout: float = 0.0,
                    worker_id: str | None = None) -> HandoffRecord | None:
        self.reap_expired()
        rec = None
        if worker_id is not None:
            with self._route_lock:
                q = self._handoff_routed.get(worker_id)
            if q is not None:
                try:
                    rec = q.get_nowait()
                except queue.Empty:
                    rec = None
        if rec is None:
            try:
                rec = (self._handoffs.get(timeout=timeout) if timeout
                       else self._handoffs.get_nowait())
            except queue.Empty:
                return None
        with self._lease_lock:
            self._handoff_leases[rec.req.id] = (
                time.monotonic() + self.lease_s, rec, worker_id)
        trace.record(rec.req.id, "handoff_lease", trace_id=rec.req.trace_id,
                     worker=worker_id)
        return rec

    def touch_handoffs(self, request_ids) -> None:
        now = time.monotonic()
        with self._lease_lock:
            for rid in request_ids:
                held = self._handoff_leases.get(rid)
                if held is not None:
                    self._handoff_leases[rid] = (now + self.lease_s, *held[1:])
                    trace.record(rid, "handoff_renew", throttle_s=1.0)

    def ack_handoff(self, request_id: str) -> None:
        with self._lease_lock:
            self._handoff_leases.pop(request_id, None)

    def handoff_depth(self) -> int:
        return self._handoffs.qsize() + sum(self.handoff_depths().values())

    def handoff_depths(self) -> dict:
        with self._route_lock:
            return {wid: q.qsize() for wid, q in self._handoff_routed.items()
                    if q.qsize() > 0}

    def handoff_holders(self) -> dict:
        with self._lease_lock:
            return self._holders(self._handoff_leases)

    def failover_handoffs(self, worker_id: str) -> list[HandoffRecord]:
        with self._route_lock:
            q = self._handoff_routed.pop(worker_id, None)
        routed = _queue_drain(q) if q is not None else []
        return self._failed_over_handoffs(
            worker_id, routed,
            self._take_leases(self._handoff_leases, worker_id))

    # -- depths and the DLQ ----------------------------------------------------------

    def queue_depth(self) -> int:
        return sum(self.queue_depths_by_class().values())

    def queue_depths_by_class(self) -> dict:
        with self._req_cond:
            out = {c: len(self._queues[c]) for c in SLO_CLASSES}
        with self._route_lock:
            for by_cls in self._routed.values():
                for cls, q in by_cls.items():
                    out[cls] = out.get(cls, 0) + len(q)
        return out

    def dlq_depth(self) -> int:
        with self._lease_lock:
            return len(self._dlq)

    def read_dlq(self, limit: int = 100) -> list[dict]:
        with self._lease_lock:
            recent = self._dlq[-limit:][::-1]
        return [dataclasses.asdict(r) for r in recent]

    def delivery_stats(self) -> dict:
        depth = self.queue_depth()
        h_depth = self.handoff_depth()
        with self._lease_lock:
            return {
                "queue_depth": depth,
                "inflight": len(self._leases),
                "dlq_depth": len(self._dlq),
                "handoff_depth": h_depth,
                "handoff_inflight": len(self._handoff_leases),
                **self._counts,
            }

    # -- responses -----------------------------------------------------------------

    def push_response(self, resp: GenerateResponse) -> None:
        """Terminal response: acks the request or handoff lease and wakes
        the waiter."""
        self._record_respond(resp)
        with self._lease_lock:
            self._leases.pop(resp.id, None)
            self._handoff_leases.pop(resp.id, None)
        now = time.monotonic()
        with self._cond:
            for rid in [r for r, t in self._response_expiry.items() if t <= now]:
                del self._response_expiry[rid]
                self._responses.pop(rid, None)
            self._responses[resp.id] = resp
            self._response_expiry[resp.id] = now + self.response_ttl_s
            self._cond.notify_all()

    def wait_response(
        self, request_id: str, timeout: float = 60.0
    ) -> GenerateResponse | None:
        deadline = time.monotonic() + timeout
        with self._cond:
            while request_id not in self._responses:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._cond.wait(remaining)
            self._response_expiry.pop(request_id, None)
            return self._responses.pop(request_id)

    # -- streams and cancellation ------------------------------------------------------

    def push_stream(self, request_id: str, token_ids: list[int]) -> None:
        with self._stream_lock:
            if request_id in self._dead_streams:
                return  # a worker flush after the producer dropped it
            q = self._streams.setdefault(request_id, queue.Queue())
        q.put(list(token_ids))

    def pop_stream(
        self, request_id: str, timeout: float = 0.0
    ) -> list[int] | None:
        with self._stream_lock:
            if request_id in self._dead_streams:
                return None  # a dropped stream stays dropped
            q = self._streams.setdefault(request_id, queue.Queue())
        try:
            return q.get(timeout=timeout) if timeout else q.get_nowait()
        except queue.Empty:
            return None

    def drop_stream(self, request_id: str) -> None:
        now = time.monotonic()
        with self._stream_lock:
            self._streams.pop(request_id, None)
            self._dead_streams[request_id] = now + self.CANCEL_TTL_S
            for rid in [r for r, t in self._dead_streams.items() if t <= now]:
                del self._dead_streams[rid]

    def cancel_request(self, request_id: str) -> None:
        with self._cancel_lock:
            self._cancels[request_id] = time.monotonic() + self.CANCEL_TTL_S

    def check_cancelled(self, request_ids) -> set[str]:
        now = time.monotonic()
        with self._cancel_lock:
            for rid in [r for r, t in self._cancels.items() if t <= now]:
                del self._cancels[rid]
            return {r for r in request_ids if r in self._cancels}

    # -- metrics ---------------------------------------------------------------------

    def publish_metrics(self, metrics: dict) -> None:
        self._metrics = self._merged(metrics)

    def read_metrics(self) -> dict:
        return self._metrics


class _RetryingClient:
    """Retry proxy around a Redis-compatible client: a command that fails
    with a builtin ``ConnectionError`` or ``TimeoutError`` (the ``redis``
    package's exceptions subclass them) is retried with capped exponential
    backoff and full jitter, then re-raised once ``attempts`` are spent.
    Replay is safe under at-least-once delivery. ``retries`` counts the
    backed-off attempts (``broker_retries`` in ``delivery_stats``)."""

    def __init__(self, client, *, attempts: int = 5, base_s: float = 0.05,
                 cap_s: float = 2.0, seed: int = 0):
        self._client = client
        self._attempts = max(1, int(attempts))
        self._base_s = base_s
        self._cap_s = cap_s
        self._rng = random.Random(seed)
        self.retries = 0

    def __getattr__(self, name):
        attr = getattr(self._client, name)
        if not callable(attr):
            return attr

        def call(*args, **kwargs):
            for attempt in range(self._attempts):
                try:
                    return attr(*args, **kwargs)
                except (ConnectionError, TimeoutError):
                    if attempt == self._attempts - 1:
                        raise
                    self.retries += 1
                    delay = min(self._cap_s, self._base_s * (2 ** attempt))
                    time.sleep(delay * (0.5 + self._rng.random() / 2))

        return call


def _key(k) -> str:
    return k.decode() if isinstance(k, bytes) else str(k)


class RedisBroker(Broker):
    """The broker over Redis (>= 6.0, for fractional blocking timeouts),
    with the reference's keys and JSON (module docstring).

    A lease is the key ``{pqueue}:lease:{worker_id}:{request_id}`` holding
    ``{"expires_at", "req"}``, stamped against the Redis server's clock
    (``TIME``) so every process judges expiry alike; a reaper claims an
    expired lease by being the caller whose DELETE returns 1. The key's
    TTL is only a GC backstop. A consumer's fleet id is its lease identity:
    ``pop_request(worker_id=)`` adopts it, so acks, routed queues and
    failover name one worker.

    ``client`` injects a Redis-compatible object; without one the
    ``redis`` package is imported here, and only here.
    """

    def __init__(self, host: str = "localhost", port: int = 6379,
                 request_queue: str = "pqueue",
                 response_prefix: str = "squeue",
                 cancel_prefix: str = "cancelled", *, client=None,
                 worker_id: str | None = None, lease_s: float | None = None,
                 max_delivery_attempts: int | None = None,
                 worker_ttl_s: float | None = None,
                 retry_attempts: int = 5, retry_base_s: float = 0.05,
                 retry_cap_s: float = 2.0):
        if client is None:
            import redis  # optional dependency, needed only without a client

            client = redis.Redis(host=host, port=port)
        self._r = _RetryingClient(client, attempts=retry_attempts,
                                  base_s=retry_base_s, cap_s=retry_cap_s)
        self._rq = request_queue
        self._prefix = response_prefix
        self._cancel_prefix = cancel_prefix
        if lease_s is not None:
            self.lease_s = lease_s
        if max_delivery_attempts is not None:
            self.max_delivery_attempts = max_delivery_attempts
        if worker_ttl_s is not None:
            self.worker_ttl_s = worker_ttl_s
        # The lease identity (a ':'-free key segment).
        self._worker_id = worker_id or uuid.uuid4().hex[:8]
        self._lease_prefix = f"{request_queue}:lease"
        self._dlq_key = f"{request_queue}:dlq"
        self._stats_prefix = f"{request_queue}:stats"
        # The registry at {pqueue}:worker:{id} and the routed queues at
        # {pqueue}:w:{id}: the glob "{pqueue}:w:*" cannot match the former.
        self._worker_prefix = f"{request_queue}:worker"
        self._routed_prefix = f"{request_queue}:w"
        # The handoff channel: shared records at {pqueue}:h, routed ones at
        # {pqueue}:h:{id}, leases at {pqueue}:hlease:{id}:{request id}.
        self._handoff_key = f"{request_queue}:h"
        self._hlease_prefix = f"{request_queue}:hlease"
        # Standard class on the bare list; the others on {pqueue}:cls:{c}.
        self._cls_prefix = f"{request_queue}:cls"

    def _class_key(self, cls: str) -> str:
        if cls == SLO_CLASS_STANDARD:
            return self._rq
        return f"{self._cls_prefix}:{cls}"

    def _routed_class_key(self, worker_id: str, cls: str) -> str:
        base = f"{self._routed_prefix}:{worker_id}"
        return base if cls == SLO_CLASS_STANDARD else f"{base}:cls:{cls}"

    def _lease_key(self, request_id: str) -> str:
        return f"{self._lease_prefix}:{self._worker_id}:{request_id}"

    def _hlease_key(self, request_id: str) -> str:
        return f"{self._hlease_prefix}:{self._worker_id}:{request_id}"

    def _lease_ttl(self) -> int:
        return max(3600, int(self.lease_s * 20))

    def _now(self) -> float:
        """The Redis server's clock; local monotonic for a client without
        ``time()``, which is right within one process."""
        server_time = getattr(self._r, "time", None)
        if server_time is None:
            return time.monotonic()
        sec, usec = server_time()
        return float(sec) + float(usec) / 1e6

    def _requeue(self, req: GenerateRequest) -> None:
        # RPUSH: the pop side RPOPs, so requeued (oldest) work goes first.
        self._r.rpush(self._class_key(_req_class(req)), req.to_json())

    def _count(self, name: str, n: int = 1) -> None:
        self._r.incr(f"{self._stats_prefix}:{name}", n)

    def _to_dlq(self, req: GenerateRequest) -> None:
        self._r.lpush(self._dlq_key, req.to_json())

    def _scan(self, match: str) -> list[str]:
        return [_key(k) for k in self._r.scan_iter(match=match)]

    def _write_lease(self, key: str, field: str, payload: str) -> None:
        self._r.set(key, json.dumps({"expires_at": self._now() + self.lease_s,
                                     field: payload}), ex=self._lease_ttl())

    def _renew(self, key: str) -> bool:
        raw = self._r.get(key)
        if raw is None:
            return False
        entry = json.loads(raw)
        entry["expires_at"] = self._now() + self.lease_s
        self._r.set(key, json.dumps(entry), ex=self._lease_ttl())
        return True

    def _claim(self, key: str):
        """The lease entry under ``key`` once this caller's DELETE claimed
        it, else None (gone, or another reaper's)."""
        raw = self._r.get(key)
        if raw is None or not self._r.delete(key):
            return None
        return json.loads(raw)

    def _adopt(self, worker_id: str | None) -> None:
        if worker_id is not None and worker_id != self._worker_id:
            self._worker_id = worker_id

    # -- requests -----------------------------------------------------------------

    def push_request(self, req: GenerateRequest) -> None:
        _record_enqueue(req, "shared")
        self._r.lpush(self._class_key(_req_class(req)), req.to_json())

    def _rpop_by_class(self, worker_id: str | None):
        """One pass in class order: this worker's routed queues, then the
        shared ones."""
        keys = [self._class_key(c) for c in SLO_CLASSES]
        if worker_id is not None:
            keys = [self._routed_class_key(worker_id, c)
                    for c in SLO_CLASSES] + keys
        for key in keys:
            payload = self._r.rpop(key)
            if payload:
                return payload
        return None

    def pop_request(self, timeout: float = 0.0,
                    worker_id: str | None = None) -> GenerateRequest | None:
        self.reap_expired()
        self._adopt(worker_id)
        payload = self._rpop_by_class(worker_id)
        if not payload and timeout:
            # One BRPOP cannot watch several lists in priority order: poll
            # them in order every 10 ms until the deadline.
            deadline = time.monotonic() + timeout
            while not payload:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                time.sleep(min(0.01, remaining))
                payload = self._rpop_by_class(worker_id)
        if not payload:
            return None
        req = GenerateRequest.from_json(payload)
        req.delivery_attempts += 1
        self._write_lease(self._lease_key(req.id), "req", req.to_json())
        trace.record(req.id, "lease", trace_id=req.trace_id,
                     worker=self._worker_id, attempt=req.delivery_attempts)
        return req

    def touch_requests(self, request_ids) -> None:
        for rid in request_ids:
            if self._renew(self._lease_key(rid)):
                trace.record(rid, "lease_renew", throttle_s=1.0)

    def reap_expired(self) -> int:
        now = self._now()
        n = 0
        for prefix, settle in (
                (self._lease_prefix, lambda e: self._settle_expired(
                    GenerateRequest.from_json(e["req"]))),
                (self._hlease_prefix, lambda e: self._dispose_handoff(
                    HandoffRecord.from_json(e["rec"])))):
            for key in self._scan(f"{prefix}:*"):
                raw = self._r.get(key)
                if raw is None:
                    continue
                entry = json.loads(raw)
                if entry["expires_at"] > now:
                    continue
                if not self._r.delete(key):
                    continue  # another reaper claimed it
                settle(entry)
                n += 1
        return n

    def release_requests(self, request_ids) -> int:
        n = 0
        for rid in request_ids:
            entry = self._claim(self._lease_key(rid))
            if entry is None:
                continue  # unknown, or a reaper claimed it: it requeues
            req = GenerateRequest.from_json(entry["req"])
            req.delivery_attempts = max(0, req.delivery_attempts - 1)
            trace.record(rid, "release")
            self._requeue(req)
            n += 1
        return n

    def preempt_requests(self, reqs) -> int:
        n = 0
        for req in reqs:
            if not self._r.delete(self._lease_key(req.id)):
                continue  # reaped meanwhile: the reaper's requeue stands
            req.delivery_attempts = max(0, req.delivery_attempts - 1)
            self._count("preempted")
            trace.record(req.id, "preempt", trace_id=req.trace_id,
                         slo_class=req.slo_class, preemptions=req.preemptions,
                         n_resume=len(req.resume_tokens or ()))
            self._requeue(req)
            n += 1
        return n

    # -- the fleet -------------------------------------------------------------------

    def _merge_worker(self, worker_id: str, patch: dict) -> None:
        key = f"{self._worker_prefix}:{worker_id}"
        raw = self._r.get(key)
        entry = json.loads(raw) if raw else {}
        entry.update(patch)
        entry["worker_id"] = worker_id
        # Judged on the server's clock, as leases are; the key's TTL only
        # collects garbage.
        entry["_expires_at"] = self._now() + self.worker_ttl_s
        self._r.set(key, json.dumps(entry),
                    ex=max(60, int(self.worker_ttl_s * 20)))

    def register_worker(self, info: dict) -> None:
        self._merge_worker(info["worker_id"], info)

    def publish_worker_load(self, worker_id: str, snapshot: dict) -> None:
        self._merge_worker(worker_id, snapshot)

    def deregister_worker(self, worker_id: str) -> None:
        self._r.delete(f"{self._worker_prefix}:{worker_id}")

    def read_workers(self) -> dict:
        now = self._now()
        out: dict[str, dict] = {}
        for key in self._scan(f"{self._worker_prefix}:*"):
            raw = self._r.get(key)
            if raw is None:
                continue
            entry = json.loads(raw)
            if float(entry.get("_expires_at", 0.0)) <= now:
                self._r.delete(key)
                continue
            entry.pop("_expires_at", None)
            out[entry["worker_id"]] = entry
        return out

    def acquire_controller_epoch(self, controller_id: str = "") -> int:
        epoch = int(self._r.incr(f"{self._rq}:ctrl:epoch"))
        self._r.set(f"{self._rq}:ctrl:holder", controller_id)
        return epoch

    def controller_epoch(self) -> int:
        raw = self._r.get(f"{self._rq}:ctrl:epoch")
        return int(raw) if raw else 0

    def controller_holder(self) -> str:
        raw = self._r.get(f"{self._rq}:ctrl:holder")
        if raw is None:
            return ""
        return raw.decode() if isinstance(raw, bytes) else str(raw)

    def push_request_to(self, worker_id: str, req: GenerateRequest) -> None:
        _record_enqueue(req, worker_id)
        self._r.lpush(self._routed_class_key(worker_id, _req_class(req)),
                      req.to_json())

    def _routed_scan(self):
        """(worker id, class, depth) of every non-empty routed queue."""
        skip = len(self._routed_prefix) + 1
        for k in self._scan(f"{self._routed_prefix}:*"):
            depth = int(self._r.llen(k))
            if depth:
                wid, _, cls = k[skip:].partition(":cls:")
                yield wid, cls or SLO_CLASS_STANDARD, depth

    def routed_depths(self) -> dict:
        out: dict[str, int] = {}
        for wid, _cls, depth in self._routed_scan():
            out[wid] = out.get(wid, 0) + depth
        return out

    def _holders(self, prefix: str) -> dict:
        out: dict[str, int] = {}
        skip = len(prefix) + 1
        for k in self._scan(f"{prefix}:*"):
            wid = k[skip:].rsplit(":", 1)[0]
            out[wid] = out.get(wid, 0) + 1
        return out

    def lease_holders(self) -> dict:
        return self._holders(self._lease_prefix)

    def _drain_list(self, key: str) -> list:
        out = []
        while (payload := self._r.rpop(key)):
            out.append(payload)
        return out

    def _claim_all(self, prefix: str, worker_id: str) -> list[dict]:
        """Every lease entry of ``worker_id`` under ``prefix`` this caller
        claimed (claim by DELETE: a concurrent reaper's stay its own)."""
        entries = (self._claim(k) for k in self._scan(f"{prefix}:{worker_id}:*"))
        return [e for e in entries if e is not None]

    def failover_worker(self, worker_id: str) -> list[GenerateRequest]:
        routed = [GenerateRequest.from_json(p) for cls in SLO_CLASSES
                  for p in self._drain_list(
                      self._routed_class_key(worker_id, cls))]
        held = [GenerateRequest.from_json(e["req"])
                for e in self._claim_all(self._lease_prefix, worker_id)]
        return self._failed_over(worker_id, routed, held)

    # -- the handoff channel ---------------------------------------------------------

    def _handoff_settled(self, record: HandoffRecord) -> None:
        self._r.delete(self._lease_key(record.req.id))
        self._count("handoffs")
        self._count("handoff_bytes", len(record.payload))

    def push_handoff(self, record: HandoffRecord) -> None:
        self.push_handoff_to(None, record)

    def push_handoff_to(self, worker_id: str | None,
                        record: HandoffRecord) -> None:
        trace.record(record.req.id, "handoff_push",
                     trace_id=record.req.trace_id, bytes=len(record.payload),
                     target=worker_id or "shared")
        key = (self._handoff_key if worker_id is None
               else f"{self._handoff_key}:{worker_id}")
        self._r.lpush(key, record.to_json())
        self._handoff_settled(record)

    def pop_handoff(self, timeout: float = 0.0,
                    worker_id: str | None = None) -> HandoffRecord | None:
        self.reap_expired()
        self._adopt(worker_id)
        payload = None
        if worker_id is not None:
            payload = self._r.rpop(f"{self._handoff_key}:{worker_id}")
        if not payload:
            if timeout:
                item = self._r.brpop(self._handoff_key, timeout=timeout)
                payload = item[1] if item else None
            else:
                payload = self._r.rpop(self._handoff_key)
        if not payload:
            return None
        rec = HandoffRecord.from_json(payload)
        self._write_lease(self._hlease_key(rec.req.id), "rec", rec.to_json())
        trace.record(rec.req.id, "handoff_lease", trace_id=rec.req.trace_id,
                     worker=self._worker_id)
        return rec

    def touch_handoffs(self, request_ids) -> None:
        for rid in request_ids:
            if self._renew(self._hlease_key(rid)):
                trace.record(rid, "handoff_renew", throttle_s=1.0)

    def ack_handoff(self, request_id: str) -> None:
        self._r.delete(self._hlease_key(request_id))

    def handoff_depth(self) -> int:
        return int(self._r.llen(self._handoff_key)) + sum(
            self.handoff_depths().values())

    def handoff_depths(self) -> dict:
        skip = len(self._handoff_key) + 1
        out = {}
        for k in self._scan(f"{self._handoff_key}:*"):
            depth = int(self._r.llen(k))
            if depth:
                out[k[skip:]] = depth
        return out

    def handoff_holders(self) -> dict:
        return self._holders(self._hlease_prefix)

    def failover_handoffs(self, worker_id: str) -> list[HandoffRecord]:
        routed = [HandoffRecord.from_json(p) for p in self._drain_list(
            f"{self._handoff_key}:{worker_id}")]
        held = [HandoffRecord.from_json(e["rec"])
                for e in self._claim_all(self._hlease_prefix, worker_id)]
        return self._failed_over_handoffs(worker_id, routed, held)

    # -- depths and the DLQ ----------------------------------------------------------

    def queue_depths_by_class(self) -> dict:
        out = {c: int(self._r.llen(self._class_key(c))) for c in SLO_CLASSES}
        for _wid, cls, depth in self._routed_scan():
            out[cls] = out.get(cls, 0) + depth
        return out

    def queue_depth(self) -> int:
        return sum(self.queue_depths_by_class().values())

    def dlq_depth(self) -> int:
        return int(self._r.llen(self._dlq_key))

    def read_dlq(self, limit: int = 100) -> list[dict]:
        return [json.loads(raw)
                for raw in self._r.lrange(self._dlq_key, 0, limit - 1)]

    def delivery_stats(self) -> dict:
        vals = self._r.mget([f"{self._stats_prefix}:{k}" for k in _COUNTERS])
        return {
            "queue_depth": self.queue_depth(),
            "inflight": len(self._scan(f"{self._lease_prefix}:*")),
            "dlq_depth": self.dlq_depth(),
            "handoff_depth": self.handoff_depth(),
            "handoff_inflight": len(self._scan(f"{self._hlease_prefix}:*")),
            "broker_retries": self._r.retries,
            **{k: int(v or 0) for k, v in zip(_COUNTERS, vals)},
        }

    # -- responses -----------------------------------------------------------------

    def push_response(self, resp: GenerateResponse) -> None:
        """Terminal response == ack: the request or handoff lease is
        deleted, then the answer goes to ``squeue:{id}`` for ten
        minutes."""
        self._record_respond(resp)
        self._r.delete(self._lease_key(resp.id))
        self._r.delete(self._hlease_key(resp.id))
        key = f"{self._prefix}:{resp.id}"
        self._r.lpush(key, resp.to_json())
        self._r.expire(key, 600)

    def wait_response(
        self, request_id: str, timeout: float = 60.0
    ) -> GenerateResponse | None:
        item = self._r.brpop(f"{self._prefix}:{request_id}", timeout=timeout)
        return GenerateResponse.from_json(item[1]) if item else None

    # -- streams and cancellation ------------------------------------------------------

    def push_stream(self, request_id: str, token_ids: list[int]) -> None:
        key = f"stream:{request_id}"
        self._r.lpush(key, json.dumps(token_ids))
        self._r.expire(key, 600)

    def pop_stream(
        self, request_id: str, timeout: float = 0.0
    ) -> list[int] | None:
        key = f"stream:{request_id}"
        if timeout:
            item = self._r.brpop(key, timeout=timeout)
            payload = item[1] if item else None
        else:
            payload = self._r.rpop(key)
        return json.loads(payload) if payload else None

    def drop_stream(self, request_id: str) -> None:
        self._r.delete(f"stream:{request_id}")

    def cancel_request(self, request_id: str) -> None:
        # A TTL'd flag every worker can see; it survives a cancel that
        # races ahead of its own request.
        self._r.set(f"{self._cancel_prefix}:{request_id}", 1,
                    ex=int(self.CANCEL_TTL_S))

    def check_cancelled(self, request_ids) -> set[str]:
        ids = list(request_ids)
        if not ids:
            return set()
        vals = self._r.mget([f"{self._cancel_prefix}:{r}" for r in ids])
        return {r for r, v in zip(ids, vals) if v is not None}

    # -- metrics ---------------------------------------------------------------------

    def publish_metrics(self, metrics: dict) -> None:
        self._r.set("llmss:metrics", json.dumps(self._merged(metrics)), ex=120)

    def read_metrics(self) -> dict:
        raw = self._r.get("llmss:metrics")
        return json.loads(raw) if raw else {}
