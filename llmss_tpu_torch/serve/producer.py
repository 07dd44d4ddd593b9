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
- ``GET /health``: with workers in the broker's registry, the fleet's
  health (``evaluate_fleet_health``: 200 while at least one replica is
  routable); without, ``evaluate_worker_health`` over the supervisor block
  of the metrics channel: 503 when the worker drains, is dead, is not
  alive, or its progress-based heartbeat is older than 3 x ``heartbeat_s``.
  Admission sheds on the same verdict.
- ``GET /metrics``: the workers' published metrics with the broker's
  ``delivery`` block, queue depths by class and, once a fleet exists, the
  ``fleet`` block (per-worker load, routed and handoff depths, the
  router's counters), as JSON or, with ``?format=prometheus``, as
  Prometheus text.
- ``GET /fleet``: each registered worker's entry, health and queues, and
  the router's counters (serve/fleet.py ``fleet_status``).
- ``GET /dlq``: the dead-letter queue's depth and newest entries.
- ``GET /slo``: each objective's attainment and burn rate over the 5 m
  and 1 h windows of the fleet's windowed series
  (``metrics.evaluate_slos``), with devtel's steady-state recompile flag.
- ``GET /compiles``: the fleet's compile events (the port's graph
  captures) and the steady-state recompile total.
- ``GET /fleet/timeseries``: every series' points per source on a
  wall-aligned time base.
- ``GET /trace/{id}``: the request's stitched timeline and phase
  breakdown; ``?format=chrome`` gives Chrome trace events with devtel's
  counter tracks. ``GET /trace/slowest?n=&phase=`` and ``GET
  /trace/export_workload``.
- ``POST /profile`` ``{"duration_s", "log_dir"}``: a ``torch.profiler``
  capture in a background thread, written as a Chrome trace (202; 409
  while one is in flight). It never overlaps a graph capture.

``/metrics`` carries the brownout ladder's state and, with devtel on, the
MFU/MBU gauges; its Prometheus text adds the windowed series' cumulative
counter and histogram families and ``llmss_mfu`` / ``llmss_mbu`` by
kernel class. Admission runs the brownout ladder (serve/fleet.py) first:
by default it reads ``interactive_burn`` of this server's own ``/slo``.
``ProducerServer(router=)`` places each admitted request through the
router's policy (serve/fleet.py) instead of the shared queue;
``controller=`` (serve/controller.py) shows its state on ``/fleet``.

Left for later: the optional FastAPI app.
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
    SLO_CLASS_BATCH, STATE_DEAD, STATE_DRAINING, STATE_READY, GenerateRequest,
)
from llmss_tpu_torch.utils import devtel
from llmss_tpu_torch.utils import metrics as metrics_mod
from llmss_tpu_torch.utils import trace
from llmss_tpu_torch.utils.metrics import profile_trace, render_prometheus

_PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# One profiler session per process: one in-flight POST /profile. Its slot
# expires at its deadline (duration + grace), so a capture thread that
# died cannot wedge profiling; the next POST takes the slot over.
_PROFILE_LOCK = threading.Lock()
_PROFILE_ACTIVE = 0  # generation of the in-flight profile, 0 when idle; guarded_by: _PROFILE_LOCK
_PROFILE_GEN = 0  # guarded_by: _PROFILE_LOCK
_PROFILE_DEADLINE = 0.0  # monotonic expiry of the active slot; guarded_by: _PROFILE_LOCK
_PROFILE_GRACE_S = 5.0

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
    brownout=None, drain: QueueDrainEstimator | None = None,
) -> tuple[int, dict, dict] | None:
    """None admits (a brownout rung may have capped a batch request's
    ``max_new_tokens`` in place); else ``(429, body, headers)``: the
    brownout ladder first, with its dwell-derived Retry-After, then a
    class whose share of ``max_queue_depth`` (0: no limit) is full."""
    if brownout is not None:
        ok, retry_after = brownout.admit(req)
        if not ok:
            return 429, {
                "error": f"brownout: shedding {req.slo_class}",
                "id": req.id,
                "brownout_state": brownout.state()["state"],
            }, {"Retry-After": str(retry_after)}
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


def collect_trace_exports(broker: Broker) -> list[dict]:
    """Every flight-recorder export this producer sees: its own recorder's
    and those riding the workers' registry heartbeats (``trace.stitch``
    drops the events that arrive both ways)."""
    exports: list[dict] = []
    if trace.enabled():
        exports.append(trace.recorder().export())
    for _wid, info in sorted(broker.read_workers().items()):
        blob = info.get("trace")
        if isinstance(blob, dict):
            exports.append(blob)
    return exports


def collect_series_exports(broker: Broker) -> tuple[list[dict], dict]:
    """Every windowed-series export this producer sees, each tagged with
    its ``source`` (``producer`` or the worker id), and each source's role
    for ``/fleet/timeseries``. Readers keep one blob per process
    (``metrics.dedup_series_exports``)."""
    exports: list[dict] = []
    sources: dict[str, dict] = {}
    if trace.enabled():
        local = dict(metrics_mod.series().export())
        local["source"] = "producer"
        exports.append(local)
        sources["producer"] = {"role": "producer"}
    for wid, info in sorted(broker.read_workers().items()):
        blob = info.get("series")
        if isinstance(blob, dict):
            tagged = dict(blob)
            tagged["source"] = wid
            exports.append(tagged)
            sources[wid] = {"role": info.get("role", "unified")}
    return exports, sources


def collect_devtel_exports(broker: Broker) -> list[dict]:
    """Every devtel export this producer sees, its own and the heartbeats',
    one per process."""
    exports: list[dict] = []
    if devtel.enabled():
        exports.append(devtel.export())
    for _wid, info in sorted(broker.read_workers().items()):
        blob = info.get("devtel")
        if isinstance(blob, dict):
            exports.append(blob)
    return devtel.dedup_exports(exports)


def trace_timeline_response(broker: Broker, req_id: str,
                            fmt: str = "") -> tuple[int, dict]:
    """``GET /trace/{id}``: the stitched timeline (404 when no process
    recorded the id); ``fmt == "chrome"``: Chrome trace events with the
    fleet's devtel counter tracks beside the request's spans."""
    exports = collect_trace_exports(broker)
    if fmt == "chrome":
        if not trace.stitch(exports, req_id=req_id):
            return 404, {"error": f"no trace for {req_id}"}
        return 200, trace.to_chrome_trace(
            exports, req_id=req_id, counters=collect_devtel_exports(broker))
    tl = trace.timeline(exports, req_id)
    if tl is None:
        return 404, {"error": f"no trace for {req_id}"}
    return 200, tl


def start_profile(log_dir: str | None = None,
                  duration_s: float = 3.0) -> tuple[int, dict]:
    """``POST /profile``: a ``torch.profiler`` capture of ``duration_s``
    seconds (0.1-60) in a background thread while serving goes on, written
    into ``log_dir`` (a new temporary directory by default) as
    ``trace.json``. 409 while one is in flight; a slot past its deadline
    is taken over. The window holds ``devtel.CAPTURE_LOCK``: it never
    overlaps a graph capture."""
    global _PROFILE_ACTIVE, _PROFILE_GEN, _PROFILE_DEADLINE
    import tempfile

    try:
        duration_s = min(max(float(duration_s), 0.1), 60.0)
    except (TypeError, ValueError):
        return 400, {"error": "duration_s must be a number"}
    with _PROFILE_LOCK:
        now = time.monotonic()
        if _PROFILE_ACTIVE and now < _PROFILE_DEADLINE:
            return 409, {
                "error": "profile already in progress",
                "retry_after_s": round(_PROFILE_DEADLINE - now, 3),
            }
        stolen = bool(_PROFILE_ACTIVE)
        _PROFILE_GEN += 1
        gen = _PROFILE_ACTIVE = _PROFILE_GEN
        _PROFILE_DEADLINE = now + duration_s + _PROFILE_GRACE_S
    if log_dir is None:
        log_dir = tempfile.mkdtemp(prefix="llmss-profile-")

    def run():
        global _PROFILE_ACTIVE
        try:
            with devtel.CAPTURE_LOCK, profile_trace(log_dir):
                time.sleep(duration_s)
        except Exception:  # noqa: BLE001 — a background capture is best-effort
            pass
        finally:
            with _PROFILE_LOCK:
                # Only the current generation frees the slot.
                if _PROFILE_ACTIVE == gen:
                    _PROFILE_ACTIVE = 0

    threading.Thread(target=run, name="llmss-profile", daemon=True).start()
    return 202, {
        "profiling": True, "log_dir": log_dir, "duration_s": duration_s,
        **({"stole_wedged_slot": True} if stolen else {}),
    }


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


def evaluate_fleet_health(workers: dict,
                          stale_factor: float = 3.0) -> tuple[int, dict]:
    """/health over the registry (producer.py:343): 200 while at least one
    replica is routable (``evaluate_worker_health`` 200 and ``ready``), so
    one draining or dead replica does not fail the front end; each
    worker's verdict rides along."""
    per = {}
    ready = 0
    for wid, info in sorted(workers.items()):
        code, body, _ = evaluate_worker_health(info, True, stale_factor)
        routable = code == 200 and info.get("state", STATE_READY) == STATE_READY
        ready += int(routable)
        per[wid] = {"routable": routable, **body}
    if ready:
        return 200, {"status": "ok", "ready": ready, "workers": per}
    return 503, {"status": "no-ready-workers", "ready": 0, "workers": per}


class ProducerServer:
    # A worker is unhealthy after this many missed heartbeat intervals.
    HEARTBEAT_STALE_FACTOR = 3.0
    # How long one read of the worker's state is trusted for admission.
    STATE_MEMO_S = 0.5
    # A stalled SSE reader must not pin its handler thread.
    STREAM_WRITE_TIMEOUT_S = 30.0

    def __init__(self, broker: Broker, host: str = "0.0.0.0",
                 port: int = 8000, timeout_s: float = 300.0,
                 max_queue_depth: int = 1024, router=None,
                 slo_objectives=None, brownout=None, controller=None):
        self.broker = broker
        # A serve.fleet.Router places each request by policy; None: the
        # shared queue.
        self.router = router
        # A serve.controller.FleetController, shown on /fleet; whoever
        # owns the control loop ticks it.
        self.controller = controller
        # /slo's objectives; None: metrics.DEFAULT_SLO_OBJECTIVES.
        self.slo_objectives = slo_objectives
        # The brownout ladder; by default fed by this server's own /slo
        # (with no traffic the burn reads 0.0: rung 0, admit all).
        if brownout is None:
            from llmss_tpu_torch.serve.fleet import (
                BrownoutController, interactive_burn,
            )

            brownout = BrownoutController(
                lambda: interactive_burn(self.slo()))
        self.brownout = brownout
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
                    if q.get("format", [""])[0] == "prometheus":
                        self._send(200, outer.prometheus().encode(),
                                   _PROM_CONTENT_TYPE)
                    else:
                        self._reply(200, outer.metrics_payload())
                elif path == "/fleet/timeseries":
                    self._reply(200, outer.timeseries())
                elif path == "/fleet":
                    self._reply(200, outer.fleet())
                elif path == "/slo":
                    self._reply(200, outer.slo())
                elif path == "/compiles":
                    self._reply(200, outer.compiles())
                elif path == "/dlq":
                    self._reply(200, {"depth": outer.broker.dlq_depth(),
                                      "requests": outer.broker.read_dlq()})
                elif path == "/trace/slowest":
                    try:
                        n = int(q.get("n", ["10"])[0])
                    except ValueError:
                        self._reply(400, {"error": "n must be an integer"})
                        return
                    phase = q.get("phase", [None])[0] or None
                    self._reply(200,
                                {"slowest": outer.trace_slowest(n, phase)})
                elif path == "/trace/export_workload":
                    self._reply(200, outer.workload())
                elif path.startswith("/trace/"):
                    self._reply(*trace_timeline_response(
                        outer.broker, path[len("/trace/"):],
                        q.get("format", [""])[0]))
                else:
                    self._reply(404, {"error": "not found"})

            def _admit(self, req: GenerateRequest) -> bool:
                """Lifecycle, brownout and backlog admission, and the
                deadline stamp; False once the 503 or 429 is sent. Each
                verdict is a flight-recorder event (``reject`` /
                ``accept``)."""
                trace.ensure_context(req)
                state = outer.worker_unavailable()
                if state is not None:
                    trace.record(req.id, "reject", trace_id=req.trace_id,
                                 reason=f"worker {state}")
                    self._reply(503, {"error": f"worker {state}", "id": req.id},
                                {"Retry-After": "1"})
                    return False
                outer.brownout.tick()
                verdict = admission_verdict(req, outer.broker,
                                            outer.max_queue_depth,
                                            outer.brownout,
                                            drain=outer.drain_estimator)
                if verdict is not None:
                    trace.record(req.id, "reject", trace_id=req.trace_id,
                                 reason=verdict[1].get("error", "shed"),
                                 slo_class=req.slo_class)
                    self._reply(*verdict)
                    return False
                if req.deadline_ts is None:
                    req.deadline_ts = time.time() + outer.timeout_s
                trace.record(req.id, "accept", trace_id=req.trace_id,
                             timeout_s=outer.timeout_s, stream=req.stream)
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
                if self.path == "/profile":
                    try:
                        raw = self._read_json()
                        body = json.loads(raw) if raw else {}
                    except Exception as e:  # noqa: BLE001 — client error
                        self._reply(400, {"error": str(e)})
                        return
                    self._reply(*start_profile(body.get("log_dir"),
                                               body.get("duration_s", 3.0)))
                    return
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
        """Place an admitted request: by the router's policy, else on the
        shared queue."""
        if self.router is not None:
            self.router.submit(req)
        else:
            self.broker.push_request(req)
        self.drain_estimator.note_admitted(self.broker.queue_depth())

    def health(self) -> tuple[int, dict]:
        """The fleet's health when workers are registered, else the
        supervisor block's."""
        workers = self.broker.read_workers()
        if workers:
            return evaluate_fleet_health(workers, self.HEARTBEAT_STALE_FACTOR)
        sup = self.broker.read_metrics().get("supervisor")
        code, body, self._saw_supervisor = evaluate_worker_health(
            sup, self._saw_supervisor, self.HEARTBEAT_STALE_FACTOR)
        return code, body

    def fleet(self) -> dict:
        """GET /fleet: ``fleet_status`` with the router's counters, the
        brownout ladder's position and the controller's state."""
        from llmss_tpu_torch.serve.fleet import fleet_status

        out = fleet_status(self.broker, self.router,
                           self.HEARTBEAT_STALE_FACTOR)
        out["brownout"] = self.brownout.state()
        if self.controller is not None:
            out["controller"] = self.controller.state()
        return out

    def metrics_payload(self) -> dict:
        """The GET /metrics payload (JSON, and the Prometheus rendering's
        input): with devtel on somewhere in the fleet, a ``devtel`` block
        (the MFU/MBU gauges and the recompile flag)."""
        payload = {
            **self.broker.read_metrics(),
            "delivery": self.broker.delivery_stats(),
            "queue_depths_by_class": self.broker.queue_depths_by_class(),
            "brownout": self.brownout.state(),
        }
        fleet = self.fleet_metrics()
        if fleet is not None:
            payload["fleet"] = fleet
        dt = collect_devtel_exports(self.broker)
        if dt:
            payload["devtel"] = {**devtel.merged_gauges(dt),
                                 "compiles": devtel.recompile_flag(dt)}
        return payload

    def prometheus(self) -> str:
        """``GET /metrics?format=prometheus``: the payload's gauges, the
        windowed series' cumulative families and the MFU/MBU gauges."""
        exports, _src = collect_series_exports(self.broker)
        return render_prometheus(
            self.metrics_payload(),
            series=metrics_mod.cumulative_summary(exports),
            util=devtel.merged_gauges(collect_devtel_exports(self.broker)))

    def slo(self) -> dict:
        """GET /slo: attainment and burn rates per objective over the
        fleet's windowed series, and, with devtel on, the ``compile``
        block flagging steady-state recompiles."""
        exports, _src = collect_series_exports(self.broker)
        out = metrics_mod.evaluate_slos(exports, self.slo_objectives)
        dt = collect_devtel_exports(self.broker)
        if dt:
            out["compile"] = devtel.recompile_flag(dt)
        return out

    def compiles(self) -> dict:
        """GET /compiles: the fleet's compile events, wall-aligned."""
        return devtel.compiles_payload(collect_devtel_exports(self.broker))

    def timeseries(self) -> dict:
        """GET /fleet/timeseries: each series' windowed points per source."""
        exports, sources = collect_series_exports(self.broker)
        return metrics_mod.timeseries_payload(exports, sources)

    def trace_slowest(self, n: int = 10,
                      phase: str | None = None) -> list[dict]:
        """GET /trace/slowest: the n slowest requests the fleet retains,
        each with its dominant phase (``phase`` reranks by that phase)."""
        return trace.slowest(collect_trace_exports(self.broker), n=n,
                             phase=phase)

    def workload(self) -> dict:
        """GET /trace/export_workload: the retained timelines as an arrival
        process."""
        return trace.export_workload(collect_trace_exports(self.broker))

    def fleet_metrics(self) -> dict | None:
        """The /metrics ``fleet`` block (producer.py:794): each worker's
        load, the routed and handoff depths, the router's counters and the
        summed ``kv_tiers``; None without a registry or a router, so a
        fleet-less payload is unchanged."""
        from llmss_tpu_torch.serve.fleet import aggregate_kv_tiers

        workers = self.broker.read_workers()
        if not workers and self.router is None:
            return None
        keys = ("role", "state", "inflight_rows", "queue_depth",
                "free_kv_blocks", "free_slots", "kv_blocks_total")
        out: dict = {
            "workers": {wid: {k: info.get(k) for k in keys}
                        for wid, info in sorted(workers.items())},
            "routed_depths": self.broker.routed_depths(),
            "handoff_depth": self.broker.handoff_depth(),
            "handoff_depths": self.broker.handoff_depths(),
        }
        if self.router is not None:
            out["router"] = self.router.stats()
        tiers = aggregate_kv_tiers(info.get("kv_tiers")
                                   for info in workers.values())
        if tiers:
            out["kv_tiers"] = tiers
        return out

    def worker_unavailable(self) -> str | None:
        """A reason to shed new work, else None; memoized for
        ``STATE_MEMO_S``. With a registry: no routable replica; without:
        the supervisor block's ``draining`` or ``dead``."""
        now = time.monotonic()
        if now < self._state_memo_until:
            return self._state_memo
        workers = self.broker.read_workers()
        if workers:
            code, _body = evaluate_fleet_health(workers,
                                                self.HEARTBEAT_STALE_FACTOR)
            self._state_memo = (None if code == 200
                                else "unavailable (no ready replica)")
        else:
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
    parser.add_argument("--policy", default=None,
                        choices=[None, "round_robin", "least_loaded",
                                 "prefix_affinity"],
                        help="fleet routing policy: place requests on the "
                             "registered workers' routed queues (workers run "
                             "with --worker_id); omit for the shared queue")
    parser.add_argument("--slo_config", default=None,
                        help="a JSON list of SLO objectives for GET /slo "
                             "(the schema of metrics.DEFAULT_SLO_OBJECTIVES); "
                             "omit for the defaults")
    args = parser.parse_args(argv)
    slo_objectives = None
    if args.slo_config:
        with open(args.slo_config) as f:
            slo_objectives = json.load(f)

    from llmss_tpu_torch.serve.broker import RedisBroker

    broker = RedisBroker(args.redis_host, args.redis_port)
    router = None
    if args.policy:
        from llmss_tpu_torch.serve.fleet import Router

        router = Router(broker, args.policy)
    server = ProducerServer(broker, args.host, args.port,
                            timeout_s=args.timeout_s,
                            max_queue_depth=args.max_queue_depth,
                            router=router, slo_objectives=slo_objectives)
    print(f"producer listening on {args.host}:{server.port}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
