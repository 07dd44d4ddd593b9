"""Producer: the HTTP front end (counterpart: llmss_tpu/serve/producer.py).

``ProducerServer`` serves, on the standard library's threading HTTP
server:

- ``POST /generate``: a ``GenerateRequest`` as JSON. Admission sheds with
  503 while the supervised worker drains or is dead, and with 429 and an
  honest ``Retry-After`` once the broker's backlog reaches
  ``max_queue_depth``; an admitted request gets ``deadline_ts`` (now +
  ``timeout_s``) unless it carries one, and waits for its own response by
  id: 200 with the response JSON, 500 with the worker's error, or 504
  after ``timeout_s``, which also cancels the request. ``"stream": true``
  answers with server-sent events: one ``data:`` event per token increment,
  then ``event: done`` with the response.
- ``POST /cancel`` ``{"id": ...}``: sets the request's cancellation flag.
- ``GET /health``: ``evaluate_worker_health`` over the supervisor block
  of the metrics channel: 503 when the worker drains, is dead, is not
  alive, or its progress-based heartbeat is older than 3 x ``heartbeat_s``.
- ``GET /metrics``: the workers' published metrics with the broker's
  ``delivery`` block and queue depths by class, as JSON or, with
  ``?format=prometheus``, as Prometheus text.
- ``GET /dlq``: the dead-letter queue's depth and newest entries.

Left for later slices: routing over a fleet, the brownout ladder (with
the SLO plane; with no traffic the reference's ladder admits everything,
as here), the trace, SLO, device-telemetry and profiling endpoints, and
the optional FastAPI app.
"""

from __future__ import annotations

import collections
import json
import math
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

from llmss_tpu_torch.serve.broker import Broker
from llmss_tpu_torch.serve.protocol import (
    SLO_CLASS_BATCH, STATE_DEAD, STATE_DRAINING, GenerateRequest,
)
from llmss_tpu_torch.utils.metrics import render_prometheus

_PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# The share of max_queue_depth each class may fill before it is shed:
# batch saturates at half, so a batch burst leaves room for the others.
CLASS_DEPTH_FRACTION = {SLO_CLASS_BATCH: 0.5}


class QueueDrainEstimator:
    """Windowed queue service rate behind the 429's ``Retry-After``: one
    ``(t, admitted_total, depth)`` sample per admission; the rate is what
    left the queue over the window, and the advice is depth / rate,
    clamped to [min_s, max_s] (min_s with fewer than two samples, max_s
    when nothing drains)."""

    def __init__(self, *, window_s: float = 10.0, min_s: int = 1,
                 max_s: int = 30):
        self.window_s = window_s
        self.min_s = min_s
        self.max_s = max_s
        self._lock = threading.Lock()
        self._admitted = 0  # guarded_by: self._lock
        self._samples: collections.deque = collections.deque()  # guarded_by: self._lock

    def note_admitted(self, depth: int, now: float | None = None) -> None:
        """Record one admission with the queue depth seen after it."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._admitted += 1
            self._samples.append((now, self._admitted, depth))
            cutoff = now - self.window_s
            while len(self._samples) > 2 and self._samples[0][0] < cutoff:
                self._samples.popleft()

    def retry_after_s(self, depth: int, now: float | None = None) -> int:
        with self._lock:
            if len(self._samples) < 2:
                return self.min_s
            t0, adm0, d0 = self._samples[0]
            t1, adm1, d1 = self._samples[-1]
        dt = t1 - t0
        if dt <= 0:
            return self.min_s
        rate = ((adm1 - adm0) - (d1 - d0)) / dt
        if rate <= 0:
            return self.max_s
        return max(self.min_s, min(self.max_s, math.ceil(depth / rate)))


def admission_verdict(
    req: GenerateRequest, broker: Broker, max_queue_depth: int,
    drain: QueueDrainEstimator | None = None,
) -> tuple[int, dict, dict] | None:
    """None admits; else ``(429, body, headers)`` for a class whose share
    of ``max_queue_depth`` (0: no limit) is full."""
    if max_queue_depth:
        frac = CLASS_DEPTH_FRACTION.get(req.slo_class, 1.0)
        limit = max(1, int(max_queue_depth * frac))
        depth = broker.queue_depth()
        if depth >= limit:
            retry = drain.retry_after_s(depth) if drain is not None else 1
            return 429, {
                "error": "queue full", "id": req.id, "queue_depth": depth,
                "slo_class": req.slo_class,
            }, {"Retry-After": str(retry)}
    return None


def evaluate_worker_health(
    sup, saw_supervisor: bool, stale_factor: float = 3.0,
) -> tuple[int, dict, bool]:
    """The /health policy over a published supervisor block; returns
    ``(status, body, saw_supervisor')``. 503, in this order: the block was
    seen before and is gone (``no-heartbeat-data``); ``draining`` or
    ``dead``; not alive (``unhealthy``: crash backoff, watchdog stall); no
    progress for ``stale_factor`` x ``heartbeat_s``
    (``stale-heartbeat``). No block ever seen: 200, unsupervised."""
    if not isinstance(sup, dict) or "heartbeat_ts" not in sup:
        if saw_supervisor:
            return 503, {
                "status": "no-heartbeat-data",
                "detail": "supervisor block seen before but gone "
                          "(metrics expired — worker presumed hung)",
            }, saw_supervisor
        return 200, {"status": "ok", "worker": "unsupervised"}, saw_supervisor
    # heartbeat_ts is a wall-clock stamp from another process.
    age = time.time() - float(sup["heartbeat_ts"])
    stale_after = float(sup.get("heartbeat_s", 5.0)) * stale_factor
    state = sup.get("state")
    body = {
        "heartbeat_age_s": round(age, 3),
        "stale_after_s": stale_after,
        "state": state,
        "restarts": sup.get("restarts"),
        "watchdog_stalls": sup.get("watchdog_stalls"),
        "last_error": sup.get("last_error"),
    }
    if state in (STATE_DRAINING, STATE_DEAD):
        return 503, {"status": state, **body}, True
    if not sup.get("alive", True):
        return 503, {"status": "unhealthy", **body}, True
    if age > stale_after:
        return 503, {"status": "stale-heartbeat", **body}, True
    return 200, {"status": "ok", **body}, True


class ProducerServer:
    # A worker is unhealthy after this many missed heartbeat intervals.
    HEARTBEAT_STALE_FACTOR = 3.0
    # How long one read of the worker's state is trusted for admission.
    STATE_MEMO_S = 0.5
    # A stalled SSE reader must not pin its handler thread.
    STREAM_WRITE_TIMEOUT_S = 30.0

    def __init__(self, broker: Broker, host: str = "0.0.0.0",
                 port: int = 8000, timeout_s: float = 300.0,
                 max_queue_depth: int = 1024):
        self.broker = broker
        self.drain_estimator = QueueDrainEstimator()
        self.timeout_s = timeout_s
        self.max_queue_depth = max_queue_depth
        self._saw_supervisor = False
        self._state_memo: str | None = None
        self._state_memo_until = 0.0
        self._server = ThreadingHTTPServer((host, port), self._handler())
        self._thread: threading.Thread | None = None

    def _handler(self):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, body: bytes, ctype: str,
                      headers: dict | None = None) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _reply(self, code: int, payload: dict,
                       headers: dict | None = None) -> None:
                self._send(code, json.dumps(payload).encode(),
                           "application/json", headers)

            def _read_json(self):
                n = int(self.headers.get("Content-Length", 0))
                return self.rfile.read(n)

            def do_GET(self):
                parts = urlsplit(self.path)
                path, q = parts.path, parse_qs(parts.query)
                if path == "/health":
                    self._reply(*outer.health())
                elif path == "/metrics":
                    payload = outer.metrics_payload()
                    if q.get("format", [""])[0] == "prometheus":
                        self._send(200, render_prometheus(payload).encode(),
                                   _PROM_CONTENT_TYPE)
                    else:
                        self._reply(200, payload)
                elif path == "/dlq":
                    self._reply(200, {"depth": outer.broker.dlq_depth(),
                                      "requests": outer.broker.read_dlq()})
                else:
                    self._reply(404, {"error": "not found"})

            def _admit(self, req: GenerateRequest) -> bool:
                """Lifecycle and backlog admission, and the deadline stamp;
                False once the 503 or 429 is sent."""
                state = outer.worker_unavailable()
                if state is not None:
                    self._reply(503, {"error": f"worker {state}", "id": req.id},
                                {"Retry-After": "1"})
                    return False
                verdict = admission_verdict(req, outer.broker,
                                            outer.max_queue_depth,
                                            drain=outer.drain_estimator)
                if verdict is not None:
                    self._reply(*verdict)
                    return False
                if req.deadline_ts is None:
                    req.deadline_ts = time.time() + outer.timeout_s
                return True

            def _stream_response(self, req: GenerateRequest) -> None:
                """Server-sent events: a ``data:`` event per increment, then
                ``event: done`` with the response; the body ends when the
                connection closes (HTTP/1.0)."""
                outer.submit(req)
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                self.connection.settimeout(outer.STREAM_WRITE_TIMEOUT_S)

                def write_data(inc):
                    self.wfile.write(b"data: " + json.dumps(
                        {"token_ids": inc}).encode() + b"\n\n")

                deadline = time.monotonic() + outer.timeout_s
                try:
                    while time.monotonic() < deadline:
                        inc = outer.broker.pop_stream(req.id, timeout=0.1)
                        if inc is not None:
                            write_data(inc)
                            self.wfile.flush()
                            continue
                        resp = outer.broker.wait_response(req.id, timeout=0.05)
                        if resp is not None:
                            # Increments that raced the response.
                            while (inc := outer.broker.pop_stream(req.id)) \
                                    is not None:
                                write_data(inc)
                            self.wfile.write(b"event: done\ndata: "
                                             + resp.to_json().encode()
                                             + b"\n\n")
                            self.wfile.flush()
                            return
                    outer.broker.cancel_request(req.id)
                    self.wfile.write(
                        b'event: error\ndata: {"error": "timed out"}\n\n')
                except (BrokenPipeError, ConnectionResetError, TimeoutError,
                        socket.timeout):
                    # The client went away or stopped reading.
                    outer.broker.cancel_request(req.id)
                finally:
                    outer.broker.drop_stream(req.id)

            def do_POST(self):
                if self.path == "/cancel":
                    try:
                        rid = json.loads(self._read_json())["id"]
                    except Exception as e:  # noqa: BLE001 — client error
                        self._reply(400, {"error": str(e)})
                        return
                    outer.broker.cancel_request(rid)
                    self._reply(200, {"cancelled": rid})
                    return
                if self.path != "/generate":
                    self._reply(404, {"error": "not found"})
                    return
                try:
                    req = GenerateRequest.from_json(self._read_json())
                    req.validate()
                except Exception as e:  # noqa: BLE001 — client error
                    self._reply(400, {"error": str(e)})
                    return
                if not self._admit(req):
                    return
                if req.stream:
                    self._stream_response(req)
                    return
                outer.submit(req)
                resp = outer.broker.wait_response(req.id, outer.timeout_s)
                if resp is None:
                    # Nobody collects it now: stop the worker spending
                    # decode steps on it.
                    outer.broker.cancel_request(req.id)
                    self._reply(504, {"error": "timed out", "id": req.id})
                elif resp.error:
                    self._reply(500, {"error": resp.error, "id": req.id})
                else:
                    self._reply(200, json.loads(resp.to_json()))

        return Handler

    def submit(self, req: GenerateRequest) -> None:
        self.broker.push_request(req)
        self.drain_estimator.note_admitted(self.broker.queue_depth())

    def health(self) -> tuple[int, dict]:
        sup = self.broker.read_metrics().get("supervisor")
        code, body, self._saw_supervisor = evaluate_worker_health(
            sup, self._saw_supervisor, self.HEARTBEAT_STALE_FACTOR)
        return code, body

    def metrics_payload(self) -> dict:
        """The GET /metrics payload (JSON, and the Prometheus rendering's
        input)."""
        return {
            **self.broker.read_metrics(),
            "delivery": self.broker.delivery_stats(),
            "queue_depths_by_class": self.broker.queue_depths_by_class(),
        }

    def worker_unavailable(self) -> str | None:
        """``draining`` or ``dead`` when the published supervisor state says
        no new work may be admitted, else None; memoized for
        ``STATE_MEMO_S``."""
        now = time.monotonic()
        if now < self._state_memo_until:
            return self._state_memo
        sup = self.broker.read_metrics().get("supervisor")
        state = sup.get("state") if isinstance(sup, dict) else None
        self._state_memo = (state if state in (STATE_DRAINING, STATE_DEAD)
                            else None)
        self._state_memo_until = now + self.STATE_MEMO_S
        return self._state_memo

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="llmss-producer", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def serve_forever(self) -> None:
        self._server.serve_forever()


def main(argv=None):
    """``llmss-torch-producer``: the HTTP front end over the Redis broker."""
    import argparse

    parser = argparse.ArgumentParser("llmss-torch-producer")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--redis_host", default="localhost")
    parser.add_argument("--redis_port", type=int, default=6379)
    parser.add_argument("--timeout_s", type=float, default=300.0,
                        help="end-to-end request deadline (stamped into "
                             "deadline_ts at admission)")
    parser.add_argument("--max_queue_depth", type=int, default=1024,
                        help="shed with 429 once the broker backlog reaches "
                             "this depth (0 disables)")
    args = parser.parse_args(argv)

    from llmss_tpu_torch.serve.broker import RedisBroker

    broker = RedisBroker(args.redis_host, args.redis_port)
    server = ProducerServer(broker, args.host, args.port,
                            timeout_s=args.timeout_s,
                            max_queue_depth=args.max_queue_depth)
    print(f"producer listening on {args.host}:{server.port}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
