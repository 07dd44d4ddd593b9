"""Request tracing: spans, the per-process flight recorder, and the
stitched fleet timeline with per-request costs (counterpart:
llmss_tpu/utils/trace.py).

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

The reading half (reference :270-691): ``stitch`` merges process
exports into one wall-aligned timeline (``timeline`` is ``GET
/trace/{id}``, ``slowest`` ``GET /trace/slowest``); ``request_cost``
derives a settled request's ``RequestCost`` from its events, and
``local_cost`` does it from this process's recorder when a broker records
``respond``; ``export_workload`` turns timelines into an arrival process;
``to_chrome_trace`` writes them as Chrome trace events, with devtel's
counter samples as ``C`` events.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict

# Event names a stitched timeline must end with exactly once: the broker's
# response is the delivery contract's terminal acknowledgement.
TERMINAL_EVENTS = frozenset({"respond"})

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

    def _events_view(self, req_id: str) -> list[dict]:
        """A shallow snapshot of one request's events (the list copied,
        the event dicts shared: they are never changed once appended), for
        the cost derivation at respond time; callers must not modify
        them."""
        with self._lock:
            e = self._reqs.get(req_id)
            return list(e["events"]) if e else []

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


# -- stitching --------------------------------------------------------------


def normalize(export: dict) -> list[dict]:
    """Flatten one process export to events with fleet-comparable
    ``ts_wall`` timestamps (wall = wall_anchor + (t - mono_anchor))."""
    base = export["wall_anchor"] - export["mono_anchor"]
    out = []
    for rid, blob in export.get("requests", {}).items():
        for ev in blob["events"]:
            e = dict(ev)
            e.setdefault("proc", export.get("proc", "?"))
            e["ts_wall"] = base + e["t"]
            e["trace_id"] = blob.get("trace_id")
            out.append(e)
    return out


def stitch(exports, req_id: str | None = None) -> list[dict]:
    """Merge process exports into one wall-aligned timeline, deduplicating
    events that reach the producer via more than one path (local recorder
    AND a registry heartbeat from a worker in the same process)."""
    seen = set()
    evs = []
    for ex in exports:
        for e in normalize(ex):
            if req_id is not None and e["req_id"] != req_id:
                continue
            key = (e["req_id"], e["name"], e["proc"], round(e["t"] * 1e6))
            if key in seen:
                continue
            seen.add(key)
            evs.append(e)
    evs.sort(key=lambda e: e["ts_wall"])
    return evs


def phase_breakdown(events) -> dict[str, float]:
    """Seconds attributed per phase: span durations summed by name, plus a
    synthesized ``queue_wait`` (first enqueue → first lease gap)."""
    tot: dict[str, float] = {}
    for e in events:
        d = e.get("dur")
        if d:
            tot[e["name"]] = tot.get(e["name"], 0.0) + d
    enq = next((e for e in events if e["name"] == "enqueue"), None)
    lease = next((e for e in events if e["name"] == "lease"), None)
    if enq and lease and lease["ts_wall"] > enq["ts_wall"]:
        tot["queue_wait"] = lease["ts_wall"] - enq["ts_wall"]
    return tot


def dominant_phase(events) -> str | None:
    tot = phase_breakdown(events)
    if not tot:
        return None
    return max(tot.items(), key=lambda kv: kv[1])[0]


def timeline(exports, req_id: str) -> dict | None:
    """The ``GET /trace/{req_id}`` body: stitched events + attribution."""
    evs = stitch(exports, req_id)
    if not evs:
        return None
    phases = phase_breakdown(evs)
    return {
        "req_id": req_id,
        "trace_id": next(
            (e["trace_id"] for e in evs if e.get("trace_id")), None,
        ),
        "total_s": round(evs[-1]["ts_wall"] - evs[0]["ts_wall"], 6),
        "dominant_phase": dominant_phase(evs),
        "phases": {k: round(v, 6) for k, v in sorted(phases.items())},
        "events": evs,
    }


def slowest(exports, n: int = 10, phase: str | None = None) -> list[dict]:
    """Tail-latency attribution: the ``n`` slowest retained requests by
    first-to-last event span, each with its dominant phase.

    ``phase`` reranks by time attributed to that phase alone (e.g.
    ``phase="kv_export"`` answers "which requests were slowest in
    handoff"), dropping requests that never entered it.
    """
    by_req: dict[str, list[dict]] = {}
    for e in stitch(exports):
        by_req.setdefault(e["req_id"], []).append(e)
    rows = []
    for rid, evs in by_req.items():
        phases = phase_breakdown(evs)
        rows.append({
            "req_id": rid,
            "trace_id": next(
                (e["trace_id"] for e in evs if e.get("trace_id")), None,
            ),
            "total_s": round(evs[-1]["ts_wall"] - evs[0]["ts_wall"], 6),
            "dominant_phase": dominant_phase(evs),
            "phases": {k: round(v, 6) for k, v in sorted(phases.items())},
            "n_events": len(evs),
        })
    if phase is not None:
        rows = [r for r in rows if r["phases"].get(phase)]
        for r in rows:
            r["rank_phase"] = phase
            r["phase_s"] = r["phases"][phase]
        rows.sort(key=lambda r: r["phase_s"], reverse=True)
    else:
        rows.sort(key=lambda r: r["total_s"], reverse=True)
    return rows[:max(0, int(n))]


# -- per-request cost attribution -------------------------------------------


def _ts(e: dict) -> float:
    # Stitched events carry fleet-aligned ``ts_wall``; raw local events
    # only ``t`` (monotonic). Either is internally consistent for deltas.
    return e.get("ts_wall", e["t"])


def _span_sum(evs, name: str) -> float:
    return sum(e.get("dur") or 0.0 for e in evs if e["name"] == name)


def _round6(v):
    return round(v, 6) if v is not None else None


def request_cost(events, assume_sorted: bool = False) -> dict | None:
    """Derive the compact ``RequestCost`` record from one request's events
    (stitched fleet-wide or raw from one recorder).

    Returns None unless the events contain a terminal ``respond`` — cost
    records exist only for settled requests, which is what makes the
    attribution exactly-once: a chaos-killed replica's partial timeline
    yields nothing; the surviving path that answers the request yields
    the one record, with every delivery attempt's prefill/handoff time
    already merged into the same req_id timeline.
    """
    # Single pass over time-sorted events (a hot-path constraint: brokers
    # derive this at every respond, so no per-phase rescans). One recorder's
    # events are appended in monotonic order (``assume_sorted``); only
    # stitched multi-process timelines pay for the sort.
    evs = list(events)
    if not assume_sorted:
        evs.sort(key=_ts)
    term_t = None
    t_attrs: dict = {}
    enq_t = lease_t = first_tok_t = None
    prefill = decode = wire = kv_span = kv_block_s = 0.0
    pending_push: list[float] = []  # handoff_push awaiting its next lease
    handoff_bytes = 0
    fin_tokens = 0
    attempts = 0
    reprefills = 0
    preemptions = 0
    slo_class = None
    trace_id = None
    for e in evs:
        name = e["name"]
        t = e.get("ts_wall", e["t"])
        a = e.get("attrs")
        if trace_id is None and e.get("trace_id"):
            trace_id = e["trace_id"]
        if a and "attempt" in a and a["attempt"] > attempts:
            attempts = a["attempt"]
        if name == "enqueue":
            if enq_t is None:
                enq_t = t
            if slo_class is None and a:
                slo_class = a.get("slo_class")
        elif name == "lease":
            if lease_t is None:
                lease_t = t
        elif name in ("admit", "adopt"):
            if first_tok_t is None:
                first_tok_t = t
        elif name == "prefill":
            prefill += e.get("dur") or 0.0
        elif name == "decode":
            decode += e.get("dur") or 0.0
        elif name == "handoff_push":
            pending_push.append(t)
            if a:
                handoff_bytes += a.get("bytes", 0)
        elif name == "handoff_lease":
            # Wire time: each push pairs with the FIRST lease at/after it
            # (sorted order ⇒ every pending push precedes this lease).
            for pt in pending_push:
                wire += t - pt
            pending_push.clear()
        elif name in ("kv_export", "kv_adopt"):
            kv_span += e.get("dur") or 0.0
        elif name == "finish":
            if a:
                fin_tokens += a.get("tokens", 0)
                kv_block_s += a.get("kv_block_s", 0.0)
        elif name == "reprefill":
            reprefills += 1
        elif name == "preempt":
            # Broker-side refund events only — the scheduler's paired
            # "evict" is deliberately not counted (one preemption, two
            # vantage points).
            preemptions += 1
        elif name in TERMINAL_EVENTS:
            term_t = t
            t_attrs = a or {}
    if term_t is None:
        return None

    queue_wait = None
    if enq_t is not None and lease_t is not None and lease_t >= enq_t:
        queue_wait = lease_t - enq_t
    # TTFT: arrival -> the scheduler's first-token resolution (``admit``
    # carries dur_s = submit->first-token; ``adopt`` marks a handoff row's
    # first decode-side token).
    ttft = None
    if enq_t is not None and first_tok_t is not None and (
        first_tok_t >= enq_t
    ):
        ttft = first_tok_t - enq_t
    tokens = t_attrs.get("n_tokens")
    if tokens is None:
        tokens = fin_tokens or None
    err = t_attrs.get("error")
    _r = _round6
    return {
        "req_id": evs[0]["req_id"],
        "trace_id": trace_id,
        "ok": bool(t_attrs.get("ok", err is None)),
        "error": err,
        "total_s": _r(term_t - _ts(evs[0])),
        "queue_wait_s": _r(queue_wait),
        "ttft_s": _r(ttft),
        "prefill_s": _r(prefill) or None,
        "handoff_s": _r(wire + kv_span) or None,
        "handoff_bytes": handoff_bytes or None,
        "decode_s": _r(decode) or None,
        "tokens": tokens,
        "kv_block_s": _r(kv_block_s) or None,
        "attempts": attempts or 1,
        "reprefills": reprefills,
        "preemptions": preemptions,
        "slo_class": slo_class,
        "n_events": len(evs),
    }


def derive_costs(exports) -> list[dict]:
    """One RequestCost per settled request across the stitched exports
    (requests without a terminal event are still in flight — or died with
    their replica — and are skipped)."""
    by_req: dict[str, list[dict]] = {}
    for e in stitch(exports):
        by_req.setdefault(e["req_id"], []).append(e)
    out = []
    for evs in by_req.values():
        cost = request_cost(evs)
        if cost is not None:
            out.append(cost)
    return out


def local_cost(req_id: str, error: str | None = None) -> dict | None:
    """RequestCost from THIS process's recorder (the terminal-time hook:
    brokers call it right after recording ``respond``). ``error``
    overrides the ok/error fields for responses settled exceptionally."""
    evs = _RECORDER._events_view(req_id)
    if not evs:
        return None
    cost = request_cost(evs, assume_sorted=True)
    if cost is None:
        return None
    if error is not None:
        cost["ok"] = False
        cost["error"] = error
    return cost


# -- trace-to-workload export -----------------------------------------------

WORKLOAD_FORMAT = "llmss-workload/1"


def export_workload(exports) -> dict:
    """Convert stitched timelines into a replayable arrival process — the
    input the deterministic fleet simulator consumes (capture -> replay).

    Each retained request becomes one row keyed by its FIRST ``enqueue``
    (re-routes and re-prefills are delivery mechanics, not arrivals);
    ``arrival_s`` offsets are relative to the earliest arrival so replay
    is start-time independent. ``slo_class`` carries each arrival's
    scheduling class so a replay reproduces the priority mix.
    """
    by_req: dict[str, list[dict]] = {}
    for e in stitch(exports):
        by_req.setdefault(e["req_id"], []).append(e)
    rows = []
    for rid, evs in by_req.items():
        enq = next((e for e in evs if e["name"] == "enqueue"), None)
        if enq is None:
            continue
        a = enq.get("attrs") or {}
        row = {
            "req_id": rid,
            "_arrival_ts": _ts(enq),
            "prompt_len": a.get("plen"),
            "max_new_tokens": a.get("max_new"),
            "prefix_hash": a.get("prefix"),
            "slo_class": a.get("slo_class"),
        }
        # Optional keys (absent in captures that predate session ids /
        # turn ordinals) so legacy workload files stay byte-for-byte
        # reproducible.
        if a.get("session"):
            row["session_id"] = a["session"]
            if a.get("turn") is not None:
                row["turn"] = int(a["turn"])
        rows.append(row)
    rows.sort(key=lambda r: r["_arrival_ts"])
    t0 = rows[0]["_arrival_ts"] if rows else 0.0
    for r in rows:
        r["arrival_s"] = round(r.pop("_arrival_ts") - t0, 6)
    # Per-session think time: the gap between consecutive turns of one
    # session (arrival-to-arrival). Stamped per row so a replay — or a
    # workload synthesized from capture statistics — can reproduce
    # multi-turn cadence, not just marginal arrival rates.
    last_arrival: dict[str, float] = {}
    for r in rows:
        sid = r.get("session_id")
        if sid is None:
            continue
        if sid in last_arrival:
            r["think_s"] = round(r["arrival_s"] - last_arrival[sid], 6)
        last_arrival[sid] = r["arrival_s"]
    return {
        "format": WORKLOAD_FORMAT,
        "n_requests": len(rows),
        "span_s": rows[-1]["arrival_s"] if rows else 0.0,
        "requests": rows,
    }


def to_chrome_trace(
    exports, req_id: str | None = None, counters=None,
) -> dict:
    """Chrome trace-event JSON (loadable at ui.perfetto.dev): one pid per
    process label, one tid per request, ``X`` complete events for spans and
    ``i`` instants for point events, timestamps in microseconds.

    ``counters`` is an optional list of devtel export blobs (each carrying
    its own ``mono_anchor``/``wall_anchor`` pair plus ``counters`` samples
    of ``{"t": mono, "tracks": {name: {series: value}}}``); each track
    becomes a ``C`` counter row under its process, wall-aligned exactly
    like span events, so KV occupancy / queue depth / memory ride the
    same timeline as the requests that waited on them.
    """
    evs = stitch(exports, req_id)
    out: list[dict] = []
    pids: dict[str, int] = {}
    tids: dict[tuple, int] = {}
    # Wall-align counter samples up front so t0 covers them too: a trace
    # that opens with a counter sample must not produce negative ts.
    csamples: list[tuple[str, float, dict]] = []  # (proc, ts_wall, tracks)
    for ex in counters or ():
        base = ex.get("wall_anchor", 0.0) - ex.get("mono_anchor", 0.0)
        proc = ex.get("proc", "?")
        for s in ex.get("counters", ()):
            csamples.append((proc, base + s.get("t", 0.0), s.get("tracks") or {}))
    t0 = evs[0]["ts_wall"] if evs else 0.0
    if csamples:
        ct0 = min(ts for _, ts, _ in csamples)
        t0 = min(t0, ct0) if evs else ct0
    for e in evs:
        pid = pids.setdefault(e["proc"], len(pids) + 1)
        tids.setdefault((e["proc"], e["req_id"]), len(tids) + 1)
    for proc, _ts_w, _tracks in csamples:
        pids.setdefault(proc, len(pids) + 1)
    for proc, pid in pids.items():
        out.append({
            "ph": "M", "pid": pid, "tid": 0, "name": "process_name",
            "args": {"name": proc},
        })
    for (proc, rid), tid in tids.items():
        out.append({
            "ph": "M", "pid": pids[proc], "tid": tid, "name": "thread_name",
            "args": {"name": rid},
        })
    for e in evs:
        pid = pids[e["proc"]]
        tid = tids[(e["proc"], e["req_id"])]
        args = dict(e.get("attrs") or {})
        if e.get("trace_id"):
            args["trace_id"] = e["trace_id"]
        ts = (e["ts_wall"] - t0) * 1e6
        if e.get("dur") is not None:
            out.append({
                "ph": "X", "pid": pid, "tid": tid, "name": e["name"],
                "cat": "span", "ts": ts - e["dur"] * 1e6,
                "dur": e["dur"] * 1e6, "args": args,
            })
        else:
            out.append({
                "ph": "i", "pid": pid, "tid": tid, "name": e["name"],
                "cat": "event", "ts": ts, "s": "t", "args": args,
            })
    for proc, ts_wall, tracks in csamples:
        pid = pids[proc]
        for track, values in tracks.items():
            out.append({
                "ph": "C", "pid": pid, "tid": 0, "name": track,
                "cat": "counter", "ts": (ts_wall - t0) * 1e6,
                "args": dict(values),
            })
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def chrome_trace_json(
    exports, req_id: str | None = None, counters=None,
) -> str:
    return json.dumps(to_chrome_trace(exports, req_id, counters=counters))
