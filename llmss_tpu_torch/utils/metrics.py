"""Prometheus text rendering of the ``GET /metrics`` payload (counterpart:
llmss_tpu/utils/metrics.py:925-1045, ``render_prometheus`` and its
helpers). The engine's counters live in ``engine/metrics.py``; the
windowed series, SLO evaluation and profiler capture of the reference's
module are left for the observability slice.
"""

from __future__ import annotations

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
