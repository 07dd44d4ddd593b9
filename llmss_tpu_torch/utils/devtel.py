"""Device telemetry: roofline accounting, graph captures as compile
events, and counter tracks for the Chrome timeline (counterpart:
llmss_tpu/utils/devtel.py).

**Roofline accounting.** Each step signature's FLOPs and HBM bytes come
from the analytical model (``EngineCostModel``: every parameter byte per
step plus each row's KV at the bucket's context) and are cached in a
``CostTable`` keyed by the reference's shape tuples, for example
``("decode_group", rows, n_chunks, k, t_bucket)``. The port has no
lowering, so every cost's ``source`` is ``"analytical"``. At each group
the batcher folds the measured fetch-to-fetch interval into achieved
MFU/MBU (``fold``): windowed histograms ``mfu_<class>`` /
``mbu_<class>`` and last-value gauges, against ``device_peaks``.

**Compile events.** The port's steady-state recompile is a CUDA graph
capture after prewarm (engine/graphs.py). The engine records each capture
with ``CompileObserver.record_compile``: its name is the ``signature_str``
of the step's class and shape key, with the capture's wall time and the
request in flight. Prewarms run inside ``observer().warming()`` and end
with ``mark_steady``; a capture outside a prewarm after that is a
steady-state recompile, counted and flagged on ``/slo``. On the CPU a
capture records its key and the same events appear. There is no
``jax.monitoring``: ``install_monitoring_hook`` returns False.

**Counter tracks.** ``record_counters`` buffers point-in-time samples (KV
blocks, fragmentation, rows by phase, queue depths, MFU/MBU, the caching
allocator's bytes) on the monotonic clock; ``export`` carries them with
one ``mono_anchor`` / ``wall_anchor`` pair, and ``trace.to_chrome_trace``
writes them as ``C`` events.

The plane is on whenever tracing is (``LLMSS_TRACE``), unless
``LLMSS_DEVTEL=0``. The peaks are one NVIDIA H100 SXM5 80GB HBM3's
(NVIDIA's datasheet: 989 TFLOP/s dense bf16, 3,350 GB/s); any other
device, the CPU included, takes that row; ``DEVTEL_PEAK_TFLOPS`` /
``DEVTEL_HBM_GBPS`` (or ``BENCH_HBM_GBPS``) override them.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque

from llmss_tpu_torch.utils import metrics as metrics_mod
from llmss_tpu_torch.utils import trace
from llmss_tpu_torch.utils.signatures import METERED_CLASSES, signature_str

# The closed class enum every MFU/MBU series name is drawn from.
KERNEL_CLASSES = METERED_CLASSES

# Utilization histogram bounds (MFU/MBU are fractions in [0, 1]).
UTIL_BOUNDS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0,
)

# Device-name substring -> (peak dense TFLOP/s bf16, HBM GB/s), matched
# case-insensitively against torch.cuda.get_device_name(0).
DEVICE_PEAKS = {
    "h100": (989.0, 3350.0),
}
_DEFAULT_PEAKS = DEVICE_PEAKS["h100"]

# How many compile events / counter samples one process keeps.
MAX_COMPILE_EVENTS = 512
MAX_COUNTER_SAMPLES = 2048

_DEVTEL_ON = os.environ.get("LLMSS_DEVTEL", "1").lower() not in (
    "0", "false", "off",
)


def enabled() -> bool:
    """On iff tracing is and ``LLMSS_DEVTEL`` has not turned it off."""
    return _DEVTEL_ON and trace.enabled()


def set_enabled(on: bool) -> None:
    global _DEVTEL_ON
    _DEVTEL_ON = bool(on)


_PEAKS: tuple[float, float] | None = None


def device_peaks() -> tuple[float, float]:
    """(peak FLOP/s, peak HBM bytes/s) of device 0, resolved once: the
    environment's overrides, else the row of ``DEVICE_PEAKS`` whose key
    the card's name holds, else the H100 row."""
    global _PEAKS
    if _PEAKS is not None:
        return _PEAKS
    tf, gb = _DEFAULT_PEAKS
    try:
        import torch

        if torch.cuda.is_available():
            name = torch.cuda.get_device_name(0).lower()
            for sub, peaks in DEVICE_PEAKS.items():
                if sub in name:
                    tf, gb = peaks
                    break
    except Exception:  # noqa: BLE001 — no device yet: keep the default row
        pass
    tf = float(os.environ.get("DEVTEL_PEAK_TFLOPS", tf))
    gb = float(os.environ.get(
        "DEVTEL_HBM_GBPS", os.environ.get("BENCH_HBM_GBPS", gb),
    ))
    _PEAKS = (tf * 1e12, gb * 1e9)
    return _PEAKS


def _reset_peaks() -> None:  # test hook
    global _PEAKS
    _PEAKS = None


# -- the roofline cost table ----------------------------------------------------


class KernelCost:
    """FLOPs and HBM bytes of one step signature."""

    __slots__ = ("flops", "hbm_bytes", "source")

    def __init__(self, flops: float, hbm_bytes: float, source: str):
        self.flops = float(flops)
        self.hbm_bytes = float(hbm_bytes)
        self.source = source

    def to_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "source": self.source,
        }


class CostTable:
    """Costs by signature. ``derive`` returns the cached entry, else
    prices ``fallback`` (flops, bytes) as an ``"analytical"`` entry; the
    fold path's lookup is one dict read."""

    def __init__(self):
        self._lock = threading.Lock()
        self._costs: dict[tuple, KernelCost] = {}  # guarded_by: self._lock

    def get(self, key: tuple) -> KernelCost | None:
        # Entries are written once under the lock and never changed; a
        # dict read is safe against a concurrent insert.
        return self._costs.get(key)

    def put(self, key: tuple, cost: KernelCost) -> KernelCost:
        with self._lock:
            self._costs[key] = cost
        return cost

    def derive(self, key: tuple,
               fallback: tuple[float, float] | None = None
               ) -> KernelCost | None:
        hit = self.get(key)
        if hit is not None:
            return hit
        if fallback is not None:
            return self.put(key, KernelCost(*fallback, "analytical"))
        return None

    def export(self) -> dict:
        with self._lock:
            return {signature_str(key): c.to_dict()
                    for key, c in self._costs.items()}

    def clear(self) -> None:
        with self._lock:
            self._costs.clear()


_COSTS = CostTable()


def costs() -> CostTable:
    """The module-level per-process cost table."""
    return _COSTS


class EngineCostModel:
    """FLOPs and bytes from the config's shapes, the reference's first-order
    roofline: a step streams every parameter byte and each row's KV over
    the bucket's whole context (``kv_len``, else ``max_seq_len``), and
    costs ``2 * params`` FLOPs per token plus ``4 * n_layers * n_heads *
    head_dim`` per token per context position. It prices the roofline, not
    what the kernels read: K3 reads each row's live positions only."""

    __slots__ = ("param_count", "param_bytes", "_attn_flops_ctx",
                 "_kv_bytes_row_ctx", "max_seq_len")

    def __init__(self, cfg, param_count: int, param_bytes: int,
                 kv_itemsize: int = 2, max_seq_len: int | None = None):
        self.param_count = int(param_count)
        self.param_bytes = int(param_bytes)
        # q k^T and p v: 2 contractions x 2 FLOPs per MAC, per layer, head,
        # head_dim lane, context position and token.
        self._attn_flops_ctx = 4.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim
        # k + v read per context position per row per step.
        self._kv_bytes_row_ctx = (
            2.0 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * kv_itemsize)
        self.max_seq_len = max_seq_len or cfg.max_position_embeddings

    def step_cost(self, batch: int, steps: int, kv_len: int | None,
                  prefill_tokens: int = 0) -> tuple[float, float]:
        """(flops, bytes) of ``steps`` decode steps at ``batch`` rows over a
        ``kv_len`` context, plus ``prefill_tokens`` streamed through the
        same dispatch."""
        ctx = kv_len if kv_len else self.max_seq_len
        tokens = batch * steps + prefill_tokens
        flops = (2.0 * self.param_count * tokens
                 + self._attn_flops_ctx * ctx * tokens)
        nbytes = (float(self.param_bytes) * steps
                  + self._kv_bytes_row_ctx * ctx * batch * steps)
        return flops, nbytes

    @property
    def kv_bytes_per_token(self) -> float:
        """The KV bytes one context position costs one row."""
        return self._kv_bytes_row_ctx


def roofline_seconds(flops: float, hbm_bytes: float,
                     peak_flops: float, peak_hbm_bps: float) -> float:
    """The roofline time: the larger of compute time and memory time."""
    compute = flops / peak_flops if peak_flops > 0 else 0.0
    memory = hbm_bytes / peak_hbm_bps if peak_hbm_bps > 0 else 0.0
    return max(compute, memory)


def param_stats(params) -> tuple[int, int]:
    """(element count, bytes) over the port's parameter tree (dicts,
    ``LinearParams`` / ``NormParams`` tuples, tensors, None): shapes and
    dtypes only, no device sync."""
    count = nbytes = 0
    stack = [params]
    while stack:
        node = stack.pop()
        if node is None:
            continue
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (tuple, list)):
            stack.extend(node)
        else:
            n = int(node.numel())
            count += n
            nbytes += n * int(node.element_size())
    return count, nbytes


# -- MFU/MBU folding --------------------------------------------------------------

# class -> (mfu hist, mbu hist, registry generation), rebuilt when the
# registry is cleared so folds never land in orphaned series.
_UTIL_SINKS: dict[str, tuple] = {}
_LAST_UTIL: dict[str, dict] = {}  # guarded_by: _UTIL_LOCK
# class -> [n, dur_sum, flops_sum, bytes_sum, source, last_flush_t]
_FOLD_ACC: dict[str, list] = {}  # guarded_by: _UTIL_LOCK
_UTIL_LOCK = threading.Lock()

FOLD_FLUSH_S = 0.05  # how often an accumulator drains into the histograms


def fold(kind: str, dur_s: float, cost: KernelCost | None) -> None:
    """Fold one measured interval of a ``kind`` group into achieved
    MFU/MBU: adds into a per-class accumulator, drained every
    ``FOLD_FLUSH_S`` into the histograms as one duration-weighted sample
    (readers drain first). No-op when the plane is off or the cost is
    unknown."""
    if cost is None or dur_s <= 0.0 or not enabled():
        return
    now = time.monotonic()
    with _UTIL_LOCK:
        acc = _FOLD_ACC.get(kind)
        if acc is None:
            acc = _FOLD_ACC[kind] = [0, 0.0, 0.0, 0.0, cost.source, now]
        acc[0] += 1
        acc[1] += dur_s
        acc[2] += cost.flops
        acc[3] += cost.hbm_bytes
        acc[4] = cost.source
        if now - acc[5] < FOLD_FLUSH_S:
            return
    _flush_kind(kind, now)


def _flush_kind(kind: str, now: float) -> None:
    """Drain one class's accumulator into the histograms and gauges."""
    with _UTIL_LOCK:
        acc = _FOLD_ACC.get(kind)
        if acc is None or acc[0] == 0:
            return
        n, dur, fl, by, src = acc[0], acc[1], acc[2], acc[3], acc[4]
        acc[0] = 0
        acc[1] = acc[2] = acc[3] = 0.0
        acc[5] = now
    peak_f, peak_b = device_peaks()
    # Above 1 the model over-prices the step (or the peaks are wrong): the
    # gauges are clamped to [0, 1].
    mfu = min(fl / (peak_f * dur), 1.0)
    mbu = min(by / (peak_b * dur), 1.0)
    reg = metrics_mod.series()
    sinks = _UTIL_SINKS.get(kind)
    if sinks is None or sinks[2] != reg.generation():
        sinks = _UTIL_SINKS[kind] = (
            reg.histogram(f"mfu_{kind}", UTIL_BOUNDS),
            reg.histogram(f"mbu_{kind}", UTIL_BOUNDS),
            reg.generation(),
        )
    epoch = int(now // metrics_mod.DEFAULT_WINDOW_BUCKET_S)
    i = epoch % metrics_mod.DEFAULT_WINDOW_BUCKETS
    sinks[0]._observe_at(i, epoch, mfu)
    sinks[1]._observe_at(i, epoch, mbu)
    with _UTIL_LOCK:
        _LAST_UTIL[kind] = {
            "mfu": mfu, "mbu": mbu,
            "dur_s": round(dur / n, 6), "source": src, "t": now,
        }


def flush_folds() -> None:
    """Drain every class's accumulator."""
    now = time.monotonic()
    with _UTIL_LOCK:
        kinds = [k for k, a in _FOLD_ACC.items() if a[0]]
    for kind in kinds:
        _flush_kind(kind, now)


def last_util() -> dict:
    """Last-value MFU/MBU gauges per class (a JSON-safe copy)."""
    flush_folds()
    with _UTIL_LOCK:
        return {k: dict(v) for k, v in _LAST_UTIL.items()}


def merged_gauges(exports) -> dict:
    """``{"mfu": {class: v}, "mbu": {class: v}}`` across devtel exports:
    per class the most recent sample (judged against each blob's own
    monotonic anchor) wins."""
    best: dict[str, tuple[float, dict]] = {}
    for ex in exports:
        for kind, g in (ex.get("util") or {}).items():
            age = ex.get("mono_anchor", 0.0) - g.get("t", 0.0)
            prev = best.get(kind)
            if prev is None or age < prev[0]:
                best[kind] = (age, g)
    out: dict = {"mfu": {}, "mbu": {}}
    for kind, (_age, g) in best.items():
        out["mfu"][kind] = g.get("mfu")
        out["mbu"][kind] = g.get("mbu")
    return out


def phase_utilization(exports=None) -> dict:
    """The controller's per-phase signal: prefill is FLOP-bound (the
    hottest MFU gauge), decode bandwidth-bound (the hottest MBU gauge).
    From this process's gauges, or a list of devtel exports; a missing
    gauge reads 0.0."""
    if exports is not None:
        g = merged_gauges(exports)
        mfu = [v for v in g["mfu"].values() if v is not None]
        mbu = [v for v in g["mbu"].values() if v is not None]
    else:
        lu = last_util()
        mfu = [g["mfu"] for g in lu.values() if g.get("mfu") is not None]
        mbu = [g["mbu"] for g in lu.values() if g.get("mbu") is not None]
    return {
        "prefill": max(mfu) if mfu else 0.0,
        "decode": max(mbu) if mbu else 0.0,
    }


# -- compile events: graph captures -----------------------------------------------


class CompileObserver:
    """The process's record of graph captures. ``record_compile`` is called
    by the engine at each capture; ``warming()`` brackets a prewarm, whose
    captures never count as steady-state, and ``mark_steady`` at a
    prewarm's end splits the stream: a later capture outside a prewarm is
    a steady-state recompile."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=MAX_COMPILE_EVENTS)  # guarded_by: self._lock
        self.steady = False  # guarded_by: self._lock
        self.steady_recompiles = 0  # guarded_by: self._lock
        self._warming = 0  # guarded_by: self._lock

    @contextlib.contextmanager
    def warming(self):
        """Captures inside the block are prewarm work, never steady-state
        recompiles (a restarted worker's prewarm included)."""
        with self._lock:
            self._warming += 1
        try:
            yield
        finally:
            with self._lock:
                self._warming -= 1

    def mark_steady(self) -> None:
        """A prewarm is done: from here on a capture outside a prewarm is a
        steady-state recompile."""
        with self._lock:
            self.steady = True

    def record_compile(self, name: str, *, dur_s: float | None = None,
                       req_id: str | None = None, **extra) -> None:
        """One capture: ``name`` its signature string, ``dur_s`` its wall
        time, ``req_id`` the request in flight."""
        if not enabled():
            return
        self._record(name=name, dur_s=dur_s, source="graph_capture",
                     req_id=req_id, **extra)

    def _record(self, *, name, dur_s, source, req_id, **extra) -> None:
        t = time.monotonic()
        with self._lock:
            steady = self.steady and not self._warming
            if steady:
                self.steady_recompiles += 1
            ev = {
                "t": t, "name": name, "source": source,
                "steady_state": steady,
                **({"dur_s": round(dur_s, 6)} if dur_s is not None else {}),
                **({"req_id": req_id} if req_id else {}),
                **extra,
            }
            self._events.append(ev)
        # The event rides the flight recorder too: in the request's own
        # timeline when one was in flight, else under a process-wide id.
        trace.record(req_id or "__compiles__", "compile", dur_s=dur_s,
                     executable=name, source=source, steady_state=steady)

    def events(self) -> list[dict]:
        with self._lock:
            return [dict(e) for e in self._events]

    def export(self) -> dict:
        with self._lock:
            return {
                "steady": self.steady,
                "steady_recompiles": self.steady_recompiles,
                "events": [dict(e) for e in self._events],
            }

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self.steady = False
            self.steady_recompiles = 0
            self._warming = 0


_OBSERVER = CompileObserver()

# Held by a graph capture on the card and by a POST /profile window, so
# the two never overlap (the profiler's tracing inside a capture could
# spoil it).
CAPTURE_LOCK = threading.Lock()


def observer() -> CompileObserver:
    return _OBSERVER


def install_monitoring_hook() -> bool:
    """The reference's ``jax.monitoring`` listener has no counterpart: the
    engine records its captures itself. Always False."""
    return False


# -- counter tracks -----------------------------------------------------------------

_COUNTER_LOCK = threading.Lock()
_COUNTER_SAMPLES: deque = deque(maxlen=MAX_COUNTER_SAMPLES)  # guarded_by: _COUNTER_LOCK


def record_counters(tracks: dict, t: float | None = None) -> None:
    """Buffer one sample: ``tracks`` maps a track name to {series: value};
    each track becomes one Chrome ``C`` row. Callers throttle."""
    if not enabled():
        return
    with _COUNTER_LOCK:
        _COUNTER_SAMPLES.append({
            "t": t if t is not None else time.monotonic(),
            "tracks": tracks,
        })


def _counter_samples() -> list[dict]:
    with _COUNTER_LOCK:
        return [dict(s) for s in _COUNTER_SAMPLES]


_BYTES_LIMIT: dict = {}


def device_memory_stats(device=None) -> dict | None:
    """The caching allocator's host counters for ``device`` (default: the
    current CUDA device): ``bytes_in_use`` (what ``memory_allocated``
    returns), ``peak_bytes_in_use`` (``max_memory_allocated``) and
    ``bytes_limit`` (the card's total memory, read once). Both counters
    come from one ``memory_stats_as_nested_dict`` call: the two public
    getters each build and flatten the whole ``memory_stats()`` dict. None
    for a CPU device or before CUDA is initialised; never a device
    sync."""
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    idx = torch.device(device).index if device is not None else None
    if idx is None:
        idx = torch.cuda.current_device()
    limit = _BYTES_LIMIT.get(idx)
    if limit is None:
        limit = _BYTES_LIMIT[idx] = int(
            torch.cuda.get_device_properties(idx).total_memory)
    alloc = torch.cuda.memory_stats_as_nested_dict(idx).get(
        "allocated_bytes", {}).get("all", {})
    return {
        "bytes_in_use": int(alloc.get("current", 0)),
        "peak_bytes_in_use": int(alloc.get("peak", 0)),
        "bytes_limit": limit,
    }


def largest_run(sorted_ids: list[int]) -> int:
    """The longest run of consecutive ids in an ascending list: the pool's
    fragmentation signal (equal to the length when unfragmented)."""
    best = cur = 1 if sorted_ids else 0
    for a, b in zip(sorted_ids, sorted_ids[1:]):
        cur = cur + 1 if b == a + 1 else 1
        if cur > best:
            best = cur
    return best


# -- export -------------------------------------------------------------------------


def export() -> dict:
    """This process's devtel blob: counter samples, compile events, the
    last-value gauges and the cost table, anchored like a flight-recorder
    export."""
    return {
        "proc": trace.recorder().proc,
        "mono_anchor": time.monotonic(),
        # The one wall-clock read per export.
        "wall_anchor": time.time(),
        "counters": _counter_samples(),
        "compiles": _OBSERVER.export(),
        "util": last_util(),
        "costs": _COSTS.export(),
    }


def dedup_exports(exports) -> list[dict]:
    """One blob per process (an in-process fleet shows the same blob
    through the local path and several heartbeats)."""
    seen: set[str] = set()
    out = []
    for ex in exports:
        proc = ex.get("proc")
        if proc in seen:
            continue
        seen.add(proc)
        out.append(ex)
    return out


def compiles_payload(exports) -> dict:
    """``GET /compiles``: the fleet's compile events, wall-aligned, newest
    last, and the steady-state recompile total."""
    events = []
    steady_recompiles = 0
    for ex in dedup_exports(exports):
        base = ex.get("wall_anchor", 0.0) - ex.get("mono_anchor", 0.0)
        blob = ex.get("compiles") or {}
        steady_recompiles += int(blob.get("steady_recompiles", 0))
        for e in blob.get("events", ()):
            ev = dict(e)
            ev["ts_wall"] = base + ev.pop("t", 0.0)
            ev["proc"] = ex.get("proc", "?")
            events.append(ev)
    events.sort(key=lambda e: e["ts_wall"])
    return {
        "n_compiles": len(events),
        "steady_recompiles": steady_recompiles,
        "compiles": events,
    }


def recompile_flag(exports) -> dict:
    """The ``/slo`` block: whether any process captured after declaring
    steady state."""
    n = 0
    for ex in dedup_exports(exports):
        n += int((ex.get("compiles") or {}).get("steady_recompiles", 0))
    return {"steady_state_recompiles": n, "flagged": n > 0}


def reset() -> None:
    """Test hook: clear every module-level accumulator."""
    global _PEAKS
    _OBSERVER.reset()
    _COSTS.clear()
    with _COUNTER_LOCK:
        _COUNTER_SAMPLES.clear()
    with _UTIL_LOCK:
        _LAST_UTIL.clear()
        _FOLD_ACC.clear()
    _UTIL_SINKS.clear()
    _PEAKS = None
