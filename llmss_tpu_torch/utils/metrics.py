"""The windowed series, the SLO plane and the Prometheus rendering of the
``GET /metrics`` payload (counterpart: llmss_tpu/utils/metrics.py:313-1056).

The engine's counters live in ``engine/metrics.py``. Here:

- ``WindowedCounter`` / ``WindowedHistogram``: rings of fixed-width
  buckets on the monotonic clock, O(1) per observation, and the
  per-process ``SeriesRegistry`` (``series()``) whose ``export`` carries
  one ``mono_anchor`` / ``wall_anchor`` pair;
- the fleet aggregation over such exports (``merged_window``,
  ``cumulative_summary``, ``timeseries_payload``) and ``evaluate_slos``:
  attainment and burn rate per objective and window;
- ``observe_request_cost``: the one ingestion point, fed once per request
  with its ``RequestCost`` (utils/trace.py ``request_cost``) when the
  broker records the terminal ``respond``;
- ``render_prometheus`` and ``profile_trace``, a ``torch.profiler``
  capture written as a Chrome trace.
"""

from __future__ import annotations

import bisect
import contextlib
import os
import threading
import time

# -- windowed time-series (fleet SLO plane) ---------------------------------
#
# LatencyStat reservoirs are since-boot cumulatives: they cannot answer
# "what was TTFT p95 over the LAST five minutes", which is the question an
# SLO burn rate (and the future autoscaler) asks. The windowed layer below
# is a ring of fixed-width time buckets on the MONOTONIC clock — O(1) per
# observation, bounded memory, mergeable across workers via the same
# mono/wall anchor discipline the flight recorder uses (utils/trace.py):
# slot timestamps stay monotonic in-process; exactly one wall-clock read
# per export aligns them fleet-wide.

DEFAULT_WINDOW_BUCKETS = 60
DEFAULT_WINDOW_BUCKET_S = 10.0
# Histogram upper bounds in seconds ("le" edges); the +inf bucket is the
# implicit last slot of every counts array.
DEFAULT_BOUNDS_S = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


class WindowedCounter:
    """Monotone counter with a rolling ring of per-bucket increments.

    ``add`` is O(1): the slot for epoch ``t // bucket_s`` is reset lazily
    when the ring wraps onto it. ``total`` is the since-boot cumulative
    (Prometheus counter semantics); ``window_sum`` reads the trailing
    window from the ring.
    """

    kind = "counter"
    __slots__ = ("name", "n_buckets", "bucket_s", "_lock", "_epochs",
                 "_vals", "total")

    def __init__(
        self,
        name: str,
        n_buckets: int = DEFAULT_WINDOW_BUCKETS,
        bucket_s: float = DEFAULT_WINDOW_BUCKET_S,
    ):
        self.name = name
        self.n_buckets = n_buckets
        self.bucket_s = bucket_s
        self._lock = threading.Lock()
        self._epochs = [-1] * n_buckets  # guarded_by: self._lock
        self._vals = [0.0] * n_buckets  # guarded_by: self._lock
        self.total = 0.0  # guarded_by: self._lock

    def add(self, v: float = 1.0, t: float | None = None) -> None:
        if t is None:
            t = time.monotonic()
        epoch = int(t // self.bucket_s)
        self._add_at(epoch % self.n_buckets, epoch, v)

    def _add_at(self, i: int, epoch: int, v: float) -> None:
        """Slot-precomputed add — the cost-ingestion fast path computes
        (i, epoch) once and shares it across every sink."""
        with self._lock:
            if self._epochs[i] != epoch:
                self._epochs[i] = epoch
                self._vals[i] = 0.0
            self._vals[i] += v
            self.total += v

    def window_sum(self, window_s: float, now: float | None = None) -> float:
        if now is None:
            now = time.monotonic()
        out = 0.0
        with self._lock:
            for epoch, v in zip(self._epochs, self._vals):
                if epoch >= 0 and _slot_live(epoch, self.bucket_s, now,
                                             window_s):
                    out += v
        return out

    def export(self) -> dict:
        with self._lock:
            slots = [
                [e, v] for e, v in zip(self._epochs, self._vals) if e >= 0
            ]
        slots.sort()
        return {
            "kind": self.kind, "bucket_s": self.bucket_s,
            "total": self.total, "slots": slots,
        }


class WindowedHistogram:
    """Fixed-bound latency histogram with a rolling ring of buckets.

    Each ring slot holds a full (count, sum, per-bound counts) triple so a
    trailing window is the exact sum of its live slots — attainment and
    burn rates come out of windowed bucket counts, never since-boot
    cumulatives. Cumulative totals are kept alongside for the Prometheus
    ``_bucket``/``_sum``/``_count`` exposition.
    """

    kind = "histogram"
    __slots__ = ("name", "bounds", "n_buckets", "bucket_s", "_lock",
                 "_epochs", "_counts", "_sums", "_ns", "total_count",
                 "total_sum", "total_counts")

    def __init__(
        self,
        name: str,
        bounds=DEFAULT_BOUNDS_S,
        n_buckets: int = DEFAULT_WINDOW_BUCKETS,
        bucket_s: float = DEFAULT_WINDOW_BUCKET_S,
    ):
        self.name = name
        self.bounds = tuple(sorted(bounds))
        self.n_buckets = n_buckets
        self.bucket_s = bucket_s
        B = len(self.bounds) + 1  # +inf tail bucket
        self._lock = threading.Lock()
        self._epochs = [-1] * n_buckets  # guarded_by: self._lock
        self._counts = [[0] * B for _ in range(n_buckets)]  # guarded_by: self._lock
        self._sums = [0.0] * n_buckets  # guarded_by: self._lock
        self._ns = [0] * n_buckets  # guarded_by: self._lock
        self.total_count = 0  # guarded_by: self._lock
        self.total_sum = 0.0  # guarded_by: self._lock
        self.total_counts = [0] * B  # guarded_by: self._lock

    def _bound_index(self, v: float) -> int:
        # first bound >= v (``le`` semantics); past the end = +inf bucket
        return bisect.bisect_left(self.bounds, v)

    def observe(self, v: float, t: float | None = None) -> None:
        if t is None:
            t = time.monotonic()
        epoch = int(t // self.bucket_s)
        self._observe_at(epoch % self.n_buckets, epoch, v)

    def _observe_at(self, i: int, epoch: int, v: float) -> None:
        """Slot-precomputed observe (see WindowedCounter._add_at)."""
        bi = bisect.bisect_left(self.bounds, v)
        with self._lock:
            if self._epochs[i] != epoch:
                self._epochs[i] = epoch
                self._counts[i] = [0] * (len(self.bounds) + 1)
                self._sums[i] = 0.0
                self._ns[i] = 0
            self._counts[i][bi] += 1
            self._sums[i] += v
            self._ns[i] += 1
            self.total_counts[bi] += 1
            self.total_sum += v
            self.total_count += 1

    def window_counts(
        self, window_s: float, now: float | None = None,
    ) -> dict:
        """Trailing-window aggregate: {count, sum, counts[per-bound]}."""
        if now is None:
            now = time.monotonic()
        counts = [0] * (len(self.bounds) + 1)
        total, n = 0.0, 0
        with self._lock:
            for i, epoch in enumerate(self._epochs):
                if epoch >= 0 and _slot_live(epoch, self.bucket_s, now,
                                             window_s):
                    n += self._ns[i]
                    total += self._sums[i]
                    for j, c in enumerate(self._counts[i]):
                        counts[j] += c
        return {"count": n, "sum": total, "counts": counts,
                "bounds": list(self.bounds)}

    def export(self) -> dict:
        with self._lock:
            slots = [
                [e, self._ns[i], self._sums[i], list(self._counts[i])]
                for i, e in enumerate(self._epochs) if e >= 0
            ]
            tot = {
                "count": self.total_count, "sum": self.total_sum,
                "counts": list(self.total_counts),
            }
        slots.sort()
        return {
            "kind": self.kind, "bucket_s": self.bucket_s,
            "bounds": list(self.bounds), "total": tot, "slots": slots,
        }


def _slot_live(
    epoch: int, bucket_s: float, now: float, window_s: float,
) -> bool:
    """A ring slot belongs to the trailing window if its interval's END is
    within ``window_s`` of ``now`` (the currently-filling slot counts)."""
    return now - (epoch + 1) * bucket_s < window_s


class SeriesRegistry:
    """Get-or-create registry of windowed series for one process.

    ``export`` snapshots every series as a JSON-safe blob carrying this
    process's ``mono_anchor``/``wall_anchor`` pair (the trace.py anchor
    discipline: exactly ONE wall read, taken at export) so the producer
    can wall-align slots fleet-wide. ``cache_s`` short-circuits repeat
    exports so the registry-heartbeat path stays cheap.
    """

    def __init__(self, proc: str | None = None):
        self.proc = proc or f"proc-{os.getpid()}"
        self._lock = threading.Lock()
        self._series: dict[str, object] = {}  # guarded_by: self._lock
        self._cache: dict | None = None  # guarded_by: self._lock
        self._cache_t = float("-inf")  # guarded_by: self._lock
        # resolved cost-ingestion sinks (observe_request_cost); rebuilt
        # lazily — a stale read just re-resolves, so no lock needed
        self._cost_sinks: tuple | None = None
        # bumped on clear(); external sink caches (devtel's MFU/MBU
        # histograms) compare against this so a cleared registry never
        # keeps receiving folds into orphaned series objects
        self._gen = 0  # guarded_by: self._lock

    def counter(self, name: str) -> WindowedCounter:
        with self._lock:
            s = self._series.get(name)
            if s is None:
                s = self._series[name] = WindowedCounter(name)
            return s

    def histogram(
        self, name: str, bounds=DEFAULT_BOUNDS_S,
    ) -> WindowedHistogram:
        with self._lock:
            s = self._series.get(name)
            if s is None:
                s = self._series[name] = WindowedHistogram(name, bounds)
            return s

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._series)

    def generation(self) -> int:
        """Monotone clear() counter for invalidating cached sink refs."""
        with self._lock:
            return self._gen

    def clear(self) -> None:
        with self._lock:
            self._series.clear()
            self._cache = None
            self._cache_t = float("-inf")
            self._gen += 1
        self._cost_sinks = None

    def export(self, cache_s: float = 0.0) -> dict:
        now = time.monotonic()
        with self._lock:
            if self._cache is not None and now - self._cache_t < cache_s:
                return self._cache
            items = list(self._series.items())
        blob = {
            "proc": self.proc,
            "mono_anchor": time.monotonic(),
            # The ONE wall-clock read per export (anchor discipline shared
            # with FlightRecorder.export).
            "wall_anchor": time.time(),
            "series": {name: s.export() for name, s in items},
        }
        with self._lock:
            self._cache, self._cache_t = blob, now
        return blob


_SERIES = SeriesRegistry()


def series() -> SeriesRegistry:
    """The module-level per-process series registry."""
    return _SERIES


# -- fleet aggregation ------------------------------------------------------


def dedup_series_exports(exports) -> list[dict]:
    """Keep one export per source process: in-process fleets share one
    registry, so the same blob can arrive via several worker heartbeats."""
    seen: set = set()
    out = []
    for ex in exports:
        if not isinstance(ex, dict) or "series" not in ex:
            continue
        p = ex.get("proc")
        if p in seen:
            continue
        seen.add(p)
        out.append(ex)
    return out


def merged_window(exports, name: str, window_s: float) -> dict | None:
    """Fleet-aggregate one named series over each export's trailing
    ``window_s`` (windows are evaluated against each export's OWN
    mono_anchor — heartbeat-cadence staleness, never cross-host clock
    skew). Returns None if no export carries the series."""
    kind = None
    bounds: list | None = None
    counts: list | None = None
    value, total, count = 0.0, 0.0, 0
    for ex in exports:
        blob = (ex.get("series") or {}).get(name)
        if not blob:
            continue
        anchor = float(ex.get("mono_anchor", 0.0))
        bucket_s = float(blob.get("bucket_s", DEFAULT_WINDOW_BUCKET_S))
        if blob["kind"] == "counter":
            kind = "counter"
            for epoch, v in blob["slots"]:
                if _slot_live(epoch, bucket_s, anchor, window_s):
                    value += v
        else:
            kind = "histogram"
            b = list(blob["bounds"])
            if bounds is None:
                bounds = b
                counts = [0] * (len(b) + 1)
            for epoch, n, s, cl in blob["slots"]:
                if not _slot_live(epoch, bucket_s, anchor, window_s):
                    continue
                count += n
                total += s
                if b == bounds:
                    for j, c in enumerate(cl):
                        counts[j] += c
    if kind == "counter":
        return {"kind": "counter", "value": value}
    if kind == "histogram":
        return {
            "kind": "histogram", "count": count, "sum": total,
            "bounds": bounds, "counts": counts,
        }
    return None


def cumulative_summary(exports) -> dict:
    """Since-boot totals per series, summed across deduped exports — the
    source for the Prometheus ``_bucket``/``_sum``/``_count`` families."""
    out: dict[str, dict] = {}
    for ex in dedup_series_exports(exports):
        for name, blob in (ex.get("series") or {}).items():
            if blob["kind"] == "counter":
                agg = out.setdefault(name, {"kind": "counter", "total": 0.0})
                agg["total"] += blob["total"]
            else:
                b = list(blob["bounds"])
                agg = out.setdefault(name, {
                    "kind": "histogram", "bounds": b, "count": 0,
                    "sum": 0.0, "counts": [0] * (len(b) + 1),
                })
                tot = blob["total"]
                agg["count"] += tot["count"]
                agg["sum"] += tot["sum"]
                if agg["bounds"] == b:
                    for j, c in enumerate(tot["counts"]):
                        agg["counts"][j] += c
    return out


def hist_quantile(bounds, counts, q: float) -> float | None:
    """Upper-bound estimate of quantile ``q`` from bucket counts (the
    bound of the bucket where the cumulative count crosses q·N; None for
    the +inf tail or an empty histogram)."""
    n = sum(counts)
    if not n:
        return None
    target = q * n
    acc = 0
    for i, c in enumerate(counts):
        acc += c
        if acc >= target:
            return bounds[i] if i < len(bounds) else None
    return None


def timeseries_payload(exports, sources: dict | None = None) -> dict:
    """``GET /fleet/timeseries`` body: per-series, per-source points on a
    wall-aligned time base (each point's ``t`` is the slot's wall-clock
    start, derived from the export's anchors — no per-point wall reads)."""
    out: dict[str, dict] = {}
    for ex in dedup_series_exports(exports):
        src = ex.get("source") or ex.get("proc", "?")
        meta = (sources or {}).get(src) or {}
        base = float(ex.get("wall_anchor", 0.0)) - float(
            ex.get("mono_anchor", 0.0)
        )
        for name, blob in (ex.get("series") or {}).items():
            row = out.setdefault(name, {
                "kind": blob["kind"],
                "bucket_s": blob.get("bucket_s", DEFAULT_WINDOW_BUCKET_S),
                **({"bounds": blob["bounds"]}
                   if blob["kind"] == "histogram" else {}),
                "sources": {},
            })
            pts = []
            bucket_s = float(blob.get("bucket_s", DEFAULT_WINDOW_BUCKET_S))
            for slot in blob["slots"]:
                t = round(base + slot[0] * bucket_s, 3)
                if blob["kind"] == "counter":
                    pts.append({"t": t, "v": round(slot[1], 6)})
                else:
                    pts.append({
                        "t": t, "count": slot[1], "sum": round(slot[2], 6),
                    })
            row["sources"][src] = {**meta, "points": pts}
    return {"series": out}


# -- SLO objectives and burn rates ------------------------------------------

# Multi-window burn-rate pairs (Google SRE workbook convention, trimmed to
# the ring's retention): a fast 5 m window catches cliff regressions, the
# 1 h window catches slow burns.
SLO_WINDOWS = (("5m", 300.0), ("1h", 3600.0))

# SLO classes, mirroring serve.protocol.SLO_CLASSES (utils must not import
# serve). A closed enum: per-class series names are bounded by construction.
SLO_CLASS_SERIES = ("interactive", "standard", "batch")

DEFAULT_SLO_OBJECTIVES = (
    {
        "name": "ttft_p95_500ms", "kind": "latency", "series": "ttft_s",
        "threshold_ms": 500.0, "target": 0.95,
    },
    {
        "name": "e2e_p95_5s", "kind": "latency", "series": "e2e_s",
        "threshold_ms": 5000.0, "target": 0.95,
    },
    {
        "name": "terminal_error_rate", "kind": "error_rate",
        "total_series": "requests_total", "bad_series": "requests_error",
        "target": 0.999,
    },
    # Per-class TTFT objectives over the class-suffixed series fed by
    # observe_request_cost. The interactive one is the brownout
    # controller's steering signal (fleet.interactive_burn finds it by
    # its ``_interactive`` suffix); the looser standard/batch targets
    # make class-by-class degradation visible on /slo.
    {
        "name": "ttft_p95_500ms_interactive", "kind": "latency",
        "series": "ttft_s_interactive", "threshold_ms": 500.0,
        "target": 0.95,
    },
    {
        "name": "ttft_p95_2s_standard", "kind": "latency",
        "series": "ttft_s_standard", "threshold_ms": 2000.0, "target": 0.95,
    },
    {
        "name": "ttft_p95_15s_batch", "kind": "latency",
        "series": "ttft_s_batch", "threshold_ms": 15000.0, "target": 0.95,
    },
)


def _latency_attainment(agg: dict, threshold_s: float) -> float:
    """Fraction of windowed observations at or under the threshold. The
    bucket straddling the threshold counts as BAD (conservative): declare
    objective thresholds on histogram bounds to avoid the pessimism."""
    good = sum(
        c for b, c in zip(agg["bounds"], agg["counts"]) if b <= threshold_s
    )
    return good / agg["count"]


def evaluate_slos(
    exports, objectives=None, windows=SLO_WINDOWS,
) -> dict:
    """Per-objective attainment + burn rates over each window, computed
    from windowed fleet-aggregated series (never since-boot cumulatives).

    Burn rate is error-budget spend speed: ``(1 - attainment) /
    (1 - target)`` — 1.0 burns the budget exactly at the SLO boundary,
    >1 is an alert, 0 is a clean window.
    """
    exports = dedup_series_exports(exports)
    if objectives is None:
        objectives = DEFAULT_SLO_OBJECTIVES
    rows = []
    for obj in objectives:
        target = float(obj["target"])
        budget = max(1e-12, 1.0 - target)
        row = {
            "name": obj["name"], "kind": obj["kind"], "target": target,
            **({"threshold_ms": obj["threshold_ms"]}
               if "threshold_ms" in obj else {}),
            "windows": {},
        }
        attained: list[bool] = []
        for wname, wsec in windows:
            cell: dict = {"window_s": wsec, "count": 0,
                          "attainment": None, "burn_rate": None}
            if obj["kind"] == "latency":
                agg = merged_window(exports, obj["series"], wsec)
                if agg and agg.get("count"):
                    att = _latency_attainment(
                        agg, float(obj["threshold_ms"]) / 1e3,
                    )
                    p95 = hist_quantile(agg["bounds"], agg["counts"], 0.95)
                    cell.update({
                        "count": agg["count"],
                        "attainment": round(att, 6),
                        "burn_rate": round((1.0 - att) / budget, 4),
                        "p95_ms": (
                            round(p95 * 1e3, 3) if p95 is not None else None
                        ),
                    })
                    attained.append(att >= target)
            else:  # error_rate
                tot = merged_window(exports, obj["total_series"], wsec)
                bad = merged_window(exports, obj["bad_series"], wsec)
                n = tot["value"] if tot else 0.0
                b = bad["value"] if bad else 0.0
                if n:
                    att = 1.0 - b / n
                    cell.update({
                        "count": int(n),
                        "bad": int(b),
                        "attainment": round(att, 6),
                        "burn_rate": round((b / n) / budget, 4),
                    })
                    attained.append(att >= target)
            row["windows"][wname] = cell
        row["met"] = all(attained) if attained else None
        rows.append(row)
    return {
        "windows": {name: sec for name, sec in windows},
        "objectives": rows,
    }


# -- cost-record ingestion --------------------------------------------------

# RequestCost field -> windowed histogram series (seconds).
_COST_HISTOGRAMS = (
    ("total_s", "e2e_s"),
    ("ttft_s", "ttft_s"),
    ("queue_wait_s", "queue_wait_s"),
    ("prefill_s", "prefill_s"),
    ("decode_s", "decode_s"),
    ("handoff_s", "handoff_s"),
)
# RequestCost field -> windowed counter series.
_COST_COUNTERS = (
    ("tokens", "tokens_out"),
    ("handoff_bytes", "handoff_bytes"),
    ("kv_block_s", "kv_block_seconds"),
    ("reprefills", "reprefills"),
    ("preemptions", "preemptions_total"),
)
# RequestCost field -> per-class histogram series stem: a record tagged
# slo_class=interactive also feeds ttft_s_interactive / e2e_s_interactive,
# which the per-class SLO objectives read.
_COST_CLASS_HISTOGRAMS = (
    ("ttft_s", "ttft_s"),
    ("total_s", "e2e_s"),
)


def observe_request_cost(cost: dict, registry: SeriesRegistry | None = None):
    """Feed one terminal RequestCost record (utils/trace.request_cost)
    into the windowed series — the single ingestion point for the SLO
    plane, called exactly once per request at respond time."""
    reg = registry if registry is not None else series()
    sinks = reg._cost_sinks
    if sinks is None:
        sinks = reg._cost_sinks = (
            reg.counter("requests_total"),
            reg.counter("requests_error"),
            tuple((f, reg.histogram(n)) for f, n in _COST_HISTOGRAMS),
            tuple((f, reg.counter(n)) for f, n in _COST_COUNTERS),
            {
                cls: tuple(
                    (f, reg.histogram(f"{n}_{cls}"))
                    for f, n in _COST_CLASS_HISTOGRAMS
                )
                for cls in SLO_CLASS_SERIES
            },
        )
    total, errors, hists, counters, class_hists = sinks
    # One clock read and one slot computation shared by every sink —
    # registry-created series all use the default ring geometry.
    now = time.monotonic()
    epoch = int(now // DEFAULT_WINDOW_BUCKET_S)
    i = epoch % DEFAULT_WINDOW_BUCKETS
    total._add_at(i, epoch, 1.0)
    if not cost.get("ok", True):
        errors._add_at(i, epoch, 1.0)
    get = cost.get
    for field, h in hists:
        v = get(field)
        if v is not None and v >= 0:
            h._observe_at(i, epoch, v)
    for field, c in counters:
        v = get(field)
        if v:
            c._add_at(i, epoch, v)
    for field, h in class_hists.get(get("slo_class"), ()):
        v = get(field)
        if v is not None and v >= 0:
            h._observe_at(i, epoch, v)


# Shape signature of a latency summary (``LatencyStat.to_dict``): rendered
# as a quantile family instead of five flat gauges.
_LATENCY_KEYS = frozenset({"count", "mean_ms", "p50_ms", "p95_ms", "p99_ms"})


def _prom_name(parts) -> str:
    raw = "_".join(str(p) for p in parts if p != "")
    return "".join(c if (c.isalnum() or c == "_") else "_" for c in raw)


def _prom_label_value(v) -> str:
    """Escape a label value per the Prometheus text format: backslash,
    double quote and newline."""
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def render_prometheus(
    payload: dict, prefix: str = "llmss", series: dict | None = None,
    util: dict | None = None,
) -> str:
    """The ``GET /metrics`` JSON payload in Prometheus text exposition
    format, the reference's text for the same payload.

    Numeric scalars become gauges named by their key path (booleans and
    other leaves are skipped); latency summaries become a ``_ms`` family
    labelled by quantile plus ``_count`` / ``_mean_ms``; list items with a
    ``worker_id`` and the fleet block's per-worker snapshots get a
    ``worker`` label. ``series`` (cumulative windowed summaries: counters
    and histograms with ``bounds`` / ``counts`` / ``sum`` / ``count``)
    adds real counter and histogram families; ``util`` (``{"mfu": {kernel:
    v}, "mbu": ...}``) adds roofline gauges labelled by kernel.
    """
    samples: dict[str, list[tuple[dict | None, object]]] = {}

    def emit(name: str, value, labels: dict | None) -> None:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            return
        samples.setdefault(name, []).append((labels, value))

    def walk(obj, parts, labels) -> None:
        if isinstance(obj, dict):
            if _LATENCY_KEYS.issuperset(obj) and "count" in obj:
                base = _prom_name([prefix, *parts])
                emit(base + "_count", obj.get("count"), labels)
                emit(base + "_mean_ms", obj.get("mean_ms"), labels)
                for q in ("p50", "p95", "p99"):
                    emit(
                        base + "_ms", obj.get(f"{q}_ms"),
                        {**(labels or {}), "quantile": q},
                    )
                return
            for k, v in obj.items():
                walk(v, [*parts, k], labels)
        elif isinstance(obj, list):
            for item in obj:
                if isinstance(item, dict) and "worker_id" in item:
                    rest = {k: v for k, v in item.items() if k != "worker_id"}
                    walk(rest, parts,
                         {**(labels or {}), "worker": item["worker_id"]})
        else:
            emit(_prom_name([prefix, *parts]), obj, labels)

    walk({k: v for k, v in payload.items() if k != "fleet"}, [], None)
    fleet = payload.get("fleet")
    if isinstance(fleet, dict):
        walk({k: v for k, v in fleet.items() if k != "workers"}, ["fleet"],
             None)
        workers = fleet.get("workers")
        if isinstance(workers, dict):
            for wid, snap in workers.items():
                if isinstance(snap, dict):
                    walk(snap, ["fleet", "worker"], {"worker": wid})

    for fam in ("mfu", "mbu"):
        for kernel, v in sorted(((util or {}).get(fam) or {}).items()):
            emit(f"{prefix}_{fam}", v, {"kernel": kernel})

    lines: list[str] = []
    for name in samples:
        lines.append(f"# TYPE {name} gauge")
        for labels, value in samples[name]:
            lab = ""
            if labels:
                body = ",".join(
                    f'{k}="{_prom_label_value(v)}"'
                    for k, v in sorted(labels.items())
                )
                lab = "{" + body + "}"
            lines.append(f"{name}{lab} {value}")
    for sname in sorted(series or {}):
        blob = series[sname]
        base = _prom_name([prefix, sname])
        if blob["kind"] == "counter":
            lines.append(f"# TYPE {base} counter")
            lines.append(f"{base} {blob['total']}")
            continue
        lines.append(f"# TYPE {base} histogram")
        acc = 0
        for bound, c in zip(blob["bounds"], blob["counts"]):
            acc += c
            lines.append(f'{base}_bucket{{le="{bound}"}} {acc}')
        lines.append(f'{base}_bucket{{le="+Inf"}} {blob["count"]}')
        lines.append(f"{base}_sum {round(blob['sum'], 6)}")
        lines.append(f"{base}_count {blob['count']}")
    lines.append("")
    return "\n".join(lines)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the enclosed block (host and,
    with a card, CUDA activity) and write it into ``log_dir`` as a Chrome
    trace (``trace.json``, loadable at ui.perfetto.dev). ``torch.profiler``
    is imported here, when a capture is asked for."""
    from torch.profiler import ProfilerActivity, profile

    import torch

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
