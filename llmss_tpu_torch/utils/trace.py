"""Request tracing, the recording half: spans and the per-process flight
recorder (counterpart: llmss_tpu/utils/trace.py:1-268).

Every hop a request crosses (the router, a broker lease, a prefill
replica, the KV handoff, a decode replica) records events into a bounded
per-process ``FlightRecorder``; a worker's registry heartbeat carries the
recorder's ``export`` so a front end can stitch the fleet's timeline.

Timestamps and span durations are ``time.monotonic()``; ``export`` takes
the process's one wall-clock read (``wall_anchor``) beside a monotonic
anchor, so exports of several processes align despite clock skew.

Tracing is on by default at event granularity; ``LLMSS_TRACE=0`` in the
environment or ``set_enabled(False)`` turns it off, and the disabled path
is one attribute check per call site.

Stitching, per-request cost, the workload export and the Chrome trace
(reference :270-691) belong to the telemetry slice.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict

# Per-group and per-renewal events the recorder may shed when a request's
# ring is full; lifecycle events (enqueue, lease, respond, ...) are never
# shed in their favour.
_SHEDDABLE_PREFIXES = ("group_",)
_SHEDDABLE_NAMES = frozenset({"lease_renew", "handoff_renew"})


def _sheddable(name: str) -> bool:
    return name in _SHEDDABLE_NAMES or name.startswith(_SHEDDABLE_PREFIXES)


class Span:
    """A monotonic-duration span over one phase of one request. ``end()``
    is idempotent and inert on the disabled path (``rec=None``); as a
    context manager an exception inside the block is recorded as an
    ``error`` attribute."""

    __slots__ = ("_rec", "req_id", "name", "_t0", "_attrs", "_ended")

    def __init__(self, rec, req_id, name, attrs):
        self._rec = rec
        self.req_id = req_id
        self.name = name
        self._attrs = attrs
        self._t0 = time.monotonic()
        self._ended = False

    def end(self, **attrs) -> None:
        if self._ended:
            return
        self._ended = True
        if self._rec is None:
            return
        if attrs:
            self._attrs.update(attrs)
        self._rec.record(self.req_id, self.name,
                         dur_s=time.monotonic() - self._t0, **self._attrs)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self._attrs.setdefault("error", exc_type.__name__)
        self.end()
        return False


class FlightRecorder:
    """A bounded ring of per-request event histories for one process: the
    ``max_requests`` most recently active requests, each with up to
    ``max_events`` events. A full request sheds group and renewal events
    first and counts what it dropped."""

    def __init__(self, max_requests: int = 256, max_events: int = 512,
                 proc: str | None = None):
        self.max_requests = max_requests
        self.max_events = max_events
        self.proc = proc or f"proc-{os.getpid()}"
        self._lock = threading.Lock()
        # req_id -> {"trace_id", "events": [dict], "dropped", "last": {name: t}}
        self._reqs: OrderedDict[str, dict] = OrderedDict()  # guarded_by: self._lock

    def record(self, req_id: str, name: str, *, trace_id: str | None = None,
               dur_s: float | None = None, proc: str | None = None,
               throttle_s: float | None = None, **attrs) -> None:
        """Append one event; ``throttle_s`` drops it when the request
        recorded an event of this name less than that long ago."""
        t = time.monotonic()
        with self._lock:
            e = self._reqs.get(req_id)
            if e is None:
                while len(self._reqs) >= self.max_requests:
                    self._reqs.popitem(last=False)
                e = {"trace_id": None, "events": [], "dropped": 0, "last": {}}
                self._reqs[req_id] = e
            else:
                self._reqs.move_to_end(req_id)
            if trace_id is not None:
                e["trace_id"] = trace_id
            if throttle_s is not None:
                prev = e["last"].get(name)
                if prev is not None and t - prev < throttle_s:
                    return
            e["last"][name] = t
            ev = {"req_id": req_id, "name": name, "t": t}
            if dur_s is not None:
                ev["dur"] = dur_s
            if proc is not None:
                ev["proc"] = proc
            if attrs:
                ev["attrs"] = attrs
            events = e["events"]
            if len(events) >= self.max_events:
                if _sheddable(name):
                    e["dropped"] += 1
                    return
                for i, old in enumerate(events):
                    if _sheddable(old["name"]):
                        del events[i]
                        e["dropped"] += 1
                        break
                else:
                    e["dropped"] += 1
                    return
            events.append(ev)

    def start_span(self, req_id: str, name: str, **attrs) -> Span:
        return Span(self, req_id, name, attrs)

    def events_for(self, req_id: str) -> list[dict]:
        with self._lock:
            e = self._reqs.get(req_id)
            return [dict(ev) for ev in e["events"]] if e else []

    def req_ids(self) -> list[str]:
        with self._lock:
            return list(self._reqs)

    def clear(self) -> None:
        with self._lock:
            self._reqs.clear()

    def export(self, req_ids=None, max_events: int | None = None) -> dict:
        """This process's retained timelines, newest request first, as a
        JSON-safe blob; ``max_events`` bounds the total event count (the
        most recent kept) so registry heartbeats stay small."""
        with self._lock:
            reqs = {}
            budget = max_events
            for rid in reversed(self._reqs):
                if req_ids is not None and rid not in req_ids:
                    continue
                e = self._reqs[rid]
                evs = [dict(ev) for ev in e["events"]]
                if budget is not None:
                    if budget <= 0:
                        break
                    evs = evs[-budget:]
                    budget -= len(evs)
                reqs[rid] = {"trace_id": e["trace_id"],
                             "dropped": e["dropped"], "events": evs}
        return {
            "proc": self.proc,
            "mono_anchor": time.monotonic(),
            # The process's one wall-clock read, taken at export so the
            # recorded timestamps stay monotonic.
            "wall_anchor": time.time(),
            "requests": reqs,
        }


# -- the module-level recorder (one per process) -------------------------------

_ENABLED = os.environ.get("LLMSS_TRACE", "1").lower() not in ("0", "false",
                                                              "off")
_RECORDER = FlightRecorder()


def recorder() -> FlightRecorder:
    return _RECORDER


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> None:
    global _ENABLED
    _ENABLED = bool(on)


def record(req_id: str | None, name: str, **kw) -> None:
    """Record one event for ``req_id``; a no-op when tracing is off."""
    if not _ENABLED or req_id is None:
        return
    _RECORDER.record(req_id, name, **kw)


def span(req_id: str | None, name: str, **attrs) -> Span:
    """A context-managed monotonic span; inert when tracing is off."""
    if not _ENABLED or req_id is None:
        return Span(None, req_id, name, attrs)
    return _RECORDER.start_span(req_id, name, **attrs)


def ensure_context(req) -> None:
    """Stamp a ``trace_id`` on a request that has none: the request id at
    first admission. It survives re-prefill (only ``trace_attempt`` bumps),
    so one timeline covers every delivery attempt."""
    if getattr(req, "trace_id", None) is None:
        req.trace_id = req.id
