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
  started, refunding the attempt.
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

Left for later slices: the KV handoff channel (roles), the worker
registry, routed queues and failover (fleet), the controller epoch, and
the tracing and cost hooks.
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

from llmss_tpu_torch.serve.protocol import (
    SLO_CLASS_STANDARD, SLO_CLASSES, GenerateRequest, GenerateResponse,
)

# The reference's delivery counters, in its order (delivery_stats).
_COUNTERS = ("redelivered", "dead_lettered", "deadline_expired",
             "failover_rerouted", "handoffs", "handoff_bytes", "reprefills",
             "preempted")


def _req_class(req: GenerateRequest) -> str:
    """The request's queue class; an unknown value degrades to standard."""
    return req.slo_class if req.slo_class in SLO_CLASSES else SLO_CLASS_STANDARD


def _ensure_trace_id(req: GenerateRequest) -> None:
    """The trace id is the request id at first enqueue (it rides the wire)."""
    if req.trace_id is None:
        req.trace_id = req.id


class Broker(abc.ABC):
    # An un-acked, un-touched lease older than this is abandoned and its
    # request redelivered; workers touch their leases once per group.
    lease_s = 60.0
    # Deliveries a request gets before it is dead-lettered.
    max_delivery_attempts = 3
    CANCEL_TTL_S = 600.0
    # Optional () -> dict merged into every publish_metrics (the
    # supervisor's health block), so a worker-side publish never erases it.
    metrics_extra = None

    @abc.abstractmethod
    def push_request(self, req: GenerateRequest) -> None: ...

    @abc.abstractmethod
    def pop_request(self, timeout: float = 0.0) -> GenerateRequest | None: ...

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
    def queue_depth(self) -> int:
        """Requests waiting (not leased): the producer's admission signal."""

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

    def _settle_expired(self, req: GenerateRequest) -> None:
        """Disposition of a lease that expired un-acked: shed past its
        deadline, dead-letter at the attempt budget, else redeliver."""
        if req.deadline_ts is not None and time.time() > req.deadline_ts:
            self._count("deadline_expired")
            self.push_response(GenerateResponse(
                id=req.id, error="deadline exceeded before completion"))
        elif req.delivery_attempts >= self.max_delivery_attempts:
            self._count("dead_lettered")
            self._to_dlq(req)
            self.push_response(GenerateResponse(
                id=req.id, error=(f"dead-lettered after "
                                  f"{req.delivery_attempts} delivery "
                                  "attempts")))
        else:
            self._count("redelivered")
            self._requeue(req)

    @abc.abstractmethod
    def _count(self, name: str) -> None: ...

    @abc.abstractmethod
    def _to_dlq(self, req: GenerateRequest) -> None: ...

    @abc.abstractmethod
    def _requeue(self, req: GenerateRequest) -> None:
        """Put a request back at the head of its class queue."""


class InProcBroker(Broker):
    """Queues and maps in one process, for tests and one-process serving."""

    def __init__(
        self,
        *,
        lease_s: float | None = None,
        max_delivery_attempts: int | None = None,
        response_ttl_s: float | None = None,
    ):
        if lease_s is not None:
            self.lease_s = lease_s
        if max_delivery_attempts is not None:
            self.max_delivery_attempts = max_delivery_attempts
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
        # id -> (monotonic expiry, request)
        self._leases: dict[str, tuple[float, GenerateRequest]] = {}  # guarded_by: self._lease_lock
        self._dlq: list[GenerateRequest] = []  # guarded_by: self._lease_lock
        self._counts = dict.fromkeys(_COUNTERS, 0)  # guarded_by: self._lease_lock
        self._lease_lock = threading.Lock()

    # -- requests ----------------------------------------------------------------

    def _enqueue(self, req: GenerateRequest, *, head: bool = False) -> None:
        with self._req_cond:
            q = self._queues[_req_class(req)]
            (q.appendleft if head else q.append)(req)
            self._req_cond.notify_all()

    def _requeue(self, req: GenerateRequest) -> None:
        self._enqueue(req, head=True)

    def _count(self, name: str) -> None:
        with self._lease_lock:
            self._counts[name] += 1

    def _to_dlq(self, req: GenerateRequest) -> None:
        with self._lease_lock:
            self._dlq.append(req)

    def push_request(self, req: GenerateRequest) -> None:
        _ensure_trace_id(req)
        self._enqueue(req)

    def pop_request(self, timeout: float = 0.0) -> GenerateRequest | None:
        """Lease the next request (highest class first), waiting up to
        ``timeout`` seconds; None if none arrived."""
        self.reap_expired()
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
            self._leases[req.id] = (time.monotonic() + self.lease_s, req)
        return req

    def touch_requests(self, request_ids) -> None:
        now = time.monotonic()
        with self._lease_lock:
            for rid in request_ids:
                held = self._leases.get(rid)
                if held is not None:
                    self._leases[rid] = (now + self.lease_s, held[1])

    def reap_expired(self) -> int:
        now = time.monotonic()
        with self._lease_lock:
            dead = [req for t, req in self._leases.values() if t <= now]
            for req in dead:
                del self._leases[req.id]
        for req in dead:
            self._settle_expired(req)
        return len(dead)

    def release_requests(self, request_ids) -> int:
        n = 0
        for rid in request_ids:
            with self._lease_lock:
                held = self._leases.pop(rid, None)
            if held is None:
                continue
            req = held[1]
            req.delivery_attempts = max(0, req.delivery_attempts - 1)
            self._enqueue(req, head=True)
            n += 1
        return n

    def queue_depth(self) -> int:
        with self._req_cond:
            return sum(len(q) for q in self._queues.values())

    def queue_depths_by_class(self) -> dict:
        with self._req_cond:
            return {c: len(self._queues[c]) for c in SLO_CLASSES}

    def dlq_depth(self) -> int:
        with self._lease_lock:
            return len(self._dlq)

    def read_dlq(self, limit: int = 100) -> list[dict]:
        with self._lease_lock:
            recent = self._dlq[-limit:][::-1]
        return [dataclasses.asdict(r) for r in recent]

    def delivery_stats(self) -> dict:
        depth = self.queue_depth()
        with self._lease_lock:
            return {
                "queue_depth": depth,
                "inflight": len(self._leases),
                "dlq_depth": len(self._dlq),
                # No handoff channel in the port: nothing waits there.
                "handoff_depth": 0,
                "handoff_inflight": 0,
                **self._counts,
            }

    # -- responses -----------------------------------------------------------------

    def push_response(self, resp: GenerateResponse) -> None:
        """Terminal response: acks the lease and wakes the waiter."""
        with self._lease_lock:
            self._leases.pop(resp.id, None)
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
    TTL is only a GC backstop.

    ``client`` injects a Redis-compatible object; without one the
    ``redis`` package is imported here, and only here.
    """

    def __init__(self, host: str = "localhost", port: int = 6379,
                 request_queue: str = "pqueue",
                 response_prefix: str = "squeue",
                 cancel_prefix: str = "cancelled", *, client=None,
                 worker_id: str | None = None, lease_s: float | None = None,
                 max_delivery_attempts: int | None = None,
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
        # The lease identity (a ':'-free key segment).
        self._worker_id = worker_id or uuid.uuid4().hex[:8]
        self._lease_prefix = f"{request_queue}:lease"
        self._dlq_key = f"{request_queue}:dlq"
        self._stats_prefix = f"{request_queue}:stats"
        # Keys of the reference's fleet and handoff channel, read by
        # queue_depth and delivery_stats so that a mixed deployment
        # counts their backlog.
        self._routed_prefix = f"{request_queue}:w"
        self._handoff_key = f"{request_queue}:h"
        self._hlease_prefix = f"{request_queue}:hlease"
        # Standard class on the bare list; the others on {pqueue}:cls:{c}.
        self._cls_prefix = f"{request_queue}:cls"

    def _class_key(self, cls: str) -> str:
        if cls == SLO_CLASS_STANDARD:
            return self._rq
        return f"{self._cls_prefix}:{cls}"

    def _lease_key(self, request_id: str) -> str:
        return f"{self._lease_prefix}:{self._worker_id}:{request_id}"

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

    def _count(self, name: str) -> None:
        self._r.incr(f"{self._stats_prefix}:{name}")

    def _to_dlq(self, req: GenerateRequest) -> None:
        self._r.lpush(self._dlq_key, req.to_json())

    def _scan(self, match: str) -> list[str]:
        return [_key(k) for k in self._r.scan_iter(match=match)]

    # -- requests -----------------------------------------------------------------

    def push_request(self, req: GenerateRequest) -> None:
        _ensure_trace_id(req)
        self._r.lpush(self._class_key(_req_class(req)), req.to_json())

    def _rpop_by_class(self):
        for cls in SLO_CLASSES:
            payload = self._r.rpop(self._class_key(cls))
            if payload:
                return payload
        return None

    def pop_request(self, timeout: float = 0.0) -> GenerateRequest | None:
        self.reap_expired()
        payload = self._rpop_by_class()
        if not payload and timeout:
            # One BRPOP cannot watch three lists in priority order: poll
            # them in order every 10 ms until the deadline.
            deadline = time.monotonic() + timeout
            while not payload:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                time.sleep(min(0.01, remaining))
                payload = self._rpop_by_class()
        if not payload:
            return None
        req = GenerateRequest.from_json(payload)
        req.delivery_attempts += 1
        self._r.set(self._lease_key(req.id), json.dumps({
            "expires_at": self._now() + self.lease_s, "req": req.to_json(),
        }), ex=self._lease_ttl())
        return req

    def touch_requests(self, request_ids) -> None:
        for rid in request_ids:
            key = self._lease_key(rid)
            raw = self._r.get(key)
            if raw is None:
                continue
            entry = json.loads(raw)
            entry["expires_at"] = self._now() + self.lease_s
            self._r.set(key, json.dumps(entry), ex=self._lease_ttl())

    def reap_expired(self) -> int:
        now = self._now()
        n = 0
        for key in self._scan(f"{self._lease_prefix}:*"):
            raw = self._r.get(key)
            if raw is None:
                continue
            entry = json.loads(raw)
            if entry["expires_at"] > now:
                continue
            if not self._r.delete(key):
                continue  # another reaper claimed it
            self._settle_expired(GenerateRequest.from_json(entry["req"]))
            n += 1
        return n

    def release_requests(self, request_ids) -> int:
        n = 0
        for rid in request_ids:
            key = self._lease_key(rid)
            raw = self._r.get(key)
            if raw is None or not self._r.delete(key):
                continue  # unknown, or a reaper claimed it: it requeues
            req = GenerateRequest.from_json(json.loads(raw)["req"])
            req.delivery_attempts = max(0, req.delivery_attempts - 1)
            self._requeue(req)
            n += 1
        return n

    def _routed_depths_by_class(self) -> dict:
        """Backlog on the reference's routed queues ``{pqueue}:w:{worker}``
        (standard) and ``...:cls:{c}``, by class."""
        out: dict[str, int] = {}
        for k in self._scan(f"{self._routed_prefix}:*"):
            depth = int(self._r.llen(k))
            if depth:
                tail = k[len(self._routed_prefix) + 1:]
                cls = (tail.split(":cls:", 1)[1] if ":cls:" in tail
                       else SLO_CLASS_STANDARD)
                out[cls] = out.get(cls, 0) + depth
        return out

    def queue_depths_by_class(self) -> dict:
        out = {c: int(self._r.llen(self._class_key(c))) for c in SLO_CLASSES}
        for cls, depth in self._routed_depths_by_class().items():
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
        handoff_depth = int(self._r.llen(self._handoff_key)) + sum(
            int(self._r.llen(k)) for k in self._scan(f"{self._handoff_key}:*"))
        return {
            "queue_depth": self.queue_depth(),
            "inflight": len(self._scan(f"{self._lease_prefix}:*")),
            "dlq_depth": self.dlq_depth(),
            "handoff_depth": handoff_depth,
            "handoff_inflight": len(self._scan(f"{self._hlease_prefix}:*")),
            "broker_retries": self._r.retries,
            **{k: int(v or 0) for k, v in zip(_COUNTERS, vals)},
        }

    # -- responses -----------------------------------------------------------------

    def push_response(self, resp: GenerateResponse) -> None:
        """Terminal response == ack: the lease is deleted, then the answer
        goes to ``squeue:{id}`` for ten minutes."""
        self._r.delete(self._lease_key(resp.id))
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
