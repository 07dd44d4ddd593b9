"""In-process broker: the subset of llmss_tpu/serve/broker.py (InProcBroker,
:409) that the batch and continuous workers use.

Requests queue FIFO per SLO class and drain in class-priority order;
responses are correlated by request id; stream increments and cancellation
flags are per-request channels; the last published metrics snapshot is
readable. A popped request is held until its response is pushed, so a
draining worker can hand back requests it never started
(``release_requests``). Redis, lease expiry with redelivery and the fleet
registry wait for later work.
"""

from __future__ import annotations

import collections
import queue
import threading
import time

from llmss_tpu_torch.serve.protocol import (
    SLO_CLASSES, GenerateRequest, GenerateResponse,
)


class InProcBroker:
    CANCEL_TTL_S = 600.0

    def __init__(self, *, response_ttl_s: float | None = None):
        self.response_ttl_s = (
            self.CANCEL_TTL_S if response_ttl_s is None else response_ttl_s
        )
        self._queues = {c: collections.deque() for c in SLO_CLASSES}  # guarded_by: self._req_cond
        self._req_cond = threading.Condition()
        self._responses: dict[str, tuple[float, GenerateResponse]] = {}  # guarded_by: self._cond
        self._cond = threading.Condition()
        self._cancels: dict[str, float] = {}  # guarded_by: self._lock
        self._streams: dict[str, queue.Queue] = {}  # guarded_by: self._lock
        self._lock = threading.Lock()
        self._metrics: dict = {}
        # Popped requests awaiting their response (release_requests).
        self._held: dict[str, GenerateRequest] = {}  # guarded_by: self._req_cond

    # -- requests -----------------------------------------------------------

    def push_request(self, req: GenerateRequest) -> None:
        with self._req_cond:
            self._queues[req.slo_class].append(req)
            self._req_cond.notify()

    def pop_request(self, timeout: float = 0.0) -> GenerateRequest | None:
        """The next request (highest class first), waiting up to
        ``timeout`` seconds; None if none arrived."""
        deadline = time.monotonic() + timeout
        with self._req_cond:
            while True:
                for c in SLO_CLASSES:
                    if self._queues[c]:
                        req = self._queues[c].popleft()
                        break
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                    self._req_cond.wait(remaining)
                    continue
                break
            self._held[req.id] = req
        req.delivery_attempts += 1
        return req

    def touch_requests(self, request_ids) -> None:
        """Lease renewal: a no-op, since in-process requests are never
        redelivered."""

    def release_requests(self, request_ids) -> int:
        """Return popped-but-never-started requests to the head of their
        class queue, refunding the delivery attempt (a draining worker
        hands them to another worker). Unknown ids are ignored. Returns the
        number requeued."""
        n = 0
        with self._req_cond:
            for rid in reversed(list(request_ids)):
                req = self._held.pop(rid, None)
                if req is None:
                    continue
                req.delivery_attempts = max(0, req.delivery_attempts - 1)
                self._queues[req.slo_class].appendleft(req)
                n += 1
            self._req_cond.notify_all()
        return n

    # -- responses ------------------------------------------------------------

    def push_response(self, resp: GenerateResponse) -> None:
        """Terminal response: wakes the waiter."""
        now = time.monotonic()
        with self._req_cond:
            self._held.pop(resp.id, None)
        with self._cond:
            for rid in [r for r, (t, _) in self._responses.items() if t <= now]:
                del self._responses[rid]
            self._responses[resp.id] = (now + self.response_ttl_s, resp)
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
            return self._responses.pop(request_id)[1]

    # -- streams and cancellation ----------------------------------------------

    def push_stream(self, request_id: str, token_ids: list[int]) -> None:
        with self._lock:
            q = self._streams.setdefault(request_id, queue.Queue())
        q.put(list(token_ids))

    def pop_stream(self, request_id: str, timeout: float = 0.0) -> list[int] | None:
        with self._lock:
            q = self._streams.setdefault(request_id, queue.Queue())
        try:
            return q.get(timeout=timeout) if timeout else q.get_nowait()
        except queue.Empty:
            return None

    def cancel_request(self, request_id: str) -> None:
        with self._lock:
            self._cancels[request_id] = time.monotonic() + self.CANCEL_TTL_S

    def check_cancelled(self, request_ids) -> set[str]:
        now = time.monotonic()
        with self._lock:
            for rid in [r for r, t in self._cancels.items() if t <= now]:
                del self._cancels[rid]
            return {r for r in request_ids if r in self._cancels}

    # -- metrics ------------------------------------------------------------------

    def publish_metrics(self, metrics: dict) -> None:
        self._metrics = metrics

    def read_metrics(self) -> dict:
        return self._metrics
