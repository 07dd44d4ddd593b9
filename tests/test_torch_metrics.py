"""The torch port's windowed series (``utils/metrics.py``) against the JAX
package's, on the CPU: the same observations, made from a seed with
numpy, through both packages' counters, histograms and registries give
the same exports, windows and cumulative totals; the fleet aggregation
(``merged_window``, ``cumulative_summary``, ``hist_quantile``,
``timeseries_payload``) and ``render_prometheus`` with series and
roofline gauges give the same results on the same exports; the module
reads the wall clock only for an export's anchor; ``profile_trace``
writes a Chrome trace."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest

import llmss_tpu.utils.metrics as rmetrics
import llmss_tpu_torch.utils.metrics as tmetrics

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = (rmetrics, tmetrics)


def _adds(seed: int, n: int = 60):
    """(value, t) pairs over ~40 s of a 1-s-bucket ring of 8."""
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.uniform(0.0, 40.0, n))
    return [(float(v), float(t)) for v, t in zip(rng.uniform(0, 3, n), ts)]


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_counter_ring_equals_reference(seed):
    out = []
    for m in PACKAGES:
        c = m.WindowedCounter("c", n_buckets=8, bucket_s=1.0)
        for v, t in _adds(seed):
            c.add(v, t=t)
        out.append((c.export(), c.total,
                    [c.window_sum(w, now=n) for w in (1.0, 3.0, 8.0)
                     for n in (38.0, 40.5, 45.0)]))
    assert out[0] == out[1]


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_histogram_ring_equals_reference(seed):
    out = []
    for m in PACKAGES:
        h = m.WindowedHistogram("h", bounds=(0.1, 0.5, 1.0, 2.5),
                                n_buckets=8, bucket_s=1.0)
        for v, t in _adds(seed):
            h.observe(v, t=t)
        out.append((h.export(), h.total_counts, h.total_count,
                    [h.window_counts(w, now=n) for w in (1.0, 4.0)
                     for n in (39.5, 41.0)]))
    assert out[0] == out[1]


def test_ring_rotation_resets_window_not_total():
    for m in PACKAGES:
        c = m.WindowedCounter("c", n_buckets=4, bucket_s=1.0)
        c.add(1.0, t=0.5)
        c.add(2.0, t=1.5)
        assert c.window_sum(4.0, now=2.0) == 3.0
        c.add(5.0, t=4.5)  # epoch 4 lands on epoch 0's slot
        assert c.total == 8.0
        assert c.window_sum(10.0, now=5.0) == 7.0
        assert c.export()["slots"] == [[1, 2.0], [4, 5.0]]
        h = m.WindowedHistogram("h", bounds=(0.1, 1.0), n_buckets=4,
                                bucket_s=1.0)
        h.observe(0.1, t=0.5)  # on a bound: that bucket (le)
        h.observe(1.0, t=0.5)
        h.observe(5.0, t=4.5)  # wraps onto slot 0
        assert h.total_counts == [1, 1, 1]
        assert h.window_counts(1.0, now=5.0)["counts"] == [0, 0, 1]


def test_registry_export_is_anchored_cached_and_shaped_like_the_reference():
    blobs = []
    for m in PACKAGES:
        reg = m.SeriesRegistry(proc="p")
        reg.counter("c").add(2.0, t=100.0)
        reg.histogram("h").observe(0.3, t=100.0)
        ex = reg.export(cache_s=60.0)
        assert reg.export(cache_s=60.0) is ex
        assert reg.export(cache_s=0.0) is not ex
        assert ex["proc"] == "p" and ex["mono_anchor"] > 0
        assert ex["wall_anchor"] > 1e9
        gen = reg.generation()
        reg.clear()
        assert reg.generation() == gen + 1 and reg.names() == []
        blobs.append(ex["series"])
    assert blobs[0] == blobs[1]


def _exports(seed: int, procs: int = 3):
    """Seeded synthetic series exports of several processes, each with its
    own monotonic anchor, a counter and two histograms on the default
    bounds."""
    rng = np.random.default_rng(seed)
    bounds = list(rmetrics.DEFAULT_BOUNDS_S)
    out = []
    for p in range(procs):
        anchor = float(rng.uniform(500.0, 5000.0))
        last = int(anchor // 10.0)
        series = {}
        slots = sorted({int(e) for e in last - rng.integers(0, 400, 6)})
        series["requests_total"] = {
            "kind": "counter", "bucket_s": 10.0,
            "total": float(rng.integers(50, 100)),
            "slots": [[e, float(rng.integers(0, 9))] for e in slots]}
        for name in ("ttft_s", "ttft_s_interactive"):
            hs = []
            for e in slots:
                counts = [int(x) for x in rng.integers(0, 4, len(bounds) + 1)]
                hs.append([e, sum(counts), float(rng.uniform(0, 9)), counts])
            tot = [int(x) for x in rng.integers(0, 30, len(bounds) + 1)]
            series[name] = {
                "kind": "histogram", "bucket_s": 10.0, "bounds": bounds,
                "total": {"count": sum(tot), "sum": 12.5, "counts": tot},
                "slots": hs}
        series["requests_error"] = {
            "kind": "counter", "bucket_s": 10.0, "total": 3.0,
            "slots": [[slots[-1], 1.0]]}
        out.append({"proc": f"p{p % 2}" if p < 2 else "p2",
                    "source": f"w{p}", "mono_anchor": anchor,
                    "wall_anchor": 1.7e9 + p, "series": series})
    return out


@pytest.mark.parametrize("seed", (3, 4))
def test_fleet_aggregation_equals_reference(seed):
    ex = _exports(seed)
    ref = (rmetrics.dedup_series_exports(ex),
           [rmetrics.merged_window(ex, n, w)
            for n in ("requests_total", "ttft_s", "nope")
            for w in (60.0, 300.0, 3600.0)],
           rmetrics.cumulative_summary(ex),
           rmetrics.timeseries_payload(ex, {"w0": {"role": "unified"}}))
    port = (tmetrics.dedup_series_exports(ex),
            [tmetrics.merged_window(ex, n, w)
             for n in ("requests_total", "ttft_s", "nope")
             for w in (60.0, 300.0, 3600.0)],
            tmetrics.cumulative_summary(ex),
            tmetrics.timeseries_payload(ex, {"w0": {"role": "unified"}}))
    assert port == ref
    rng = np.random.default_rng(seed)
    for _ in range(20):
        counts = [int(x) for x in rng.integers(0, 5, 14)]
        q = float(rng.uniform(0, 1))
        assert tmetrics.hist_quantile(rmetrics.DEFAULT_BOUNDS_S, counts, q) \
            == rmetrics.hist_quantile(rmetrics.DEFAULT_BOUNDS_S, counts, q)


@pytest.mark.parametrize("seed", (5, 6))
def test_render_prometheus_with_series_equals_reference(seed):
    ex = _exports(seed)
    rng = np.random.default_rng(seed)
    payload = {
        "requests_served": int(rng.integers(0, 100)),
        "ttft": {"count": 3, "mean_ms": 1.5, "p50_ms": 1.0, "p95_ms": 2.0,
                 "p99_ms": 2.5},
        "queue_depths_by_class": {"interactive": 1, "batch": 0},
        "brownout": {"brownout_state": 1, "state": "cap-batch"},
        "fleet": {"workers": {'w"0': {"inflight_rows": 2}},
                  "routed_depths": {"w0": 1}},
    }
    util = {"mfu": {"decode_group": float(rng.uniform(0, 1)),
                    "ragged_group": float(rng.uniform(0, 1))},
            "mbu": {"decode_group": float(rng.uniform(0, 1))}}
    for series in (None, rmetrics.cumulative_summary(ex)):
        assert tmetrics.render_prometheus(payload, series=series, util=util) \
            == rmetrics.render_prometheus(payload, series=series, util=util)
    text = tmetrics.render_prometheus(
        payload, series=tmetrics.cumulative_summary(ex), util=util)
    assert "# TYPE llmss_ttft_s histogram" in text
    assert 'llmss_ttft_s_bucket{le="+Inf"}' in text
    assert "# TYPE llmss_requests_total counter" in text
    assert 'llmss_mfu{kernel="decode_group"}' in text


def _wall_reads(path: Path) -> list[str]:
    """The functions of ``path`` that call ``time.time()``."""
    tree = ast.parse(path.read_text())
    out = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "time"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "time"):
                out.append(fn.name)
    return out


@pytest.mark.parametrize("name", ("metrics", "trace", "devtel"))
def test_plane_reads_the_wall_clock_only_for_an_anchor(name):
    """The series, the recorder and devtel live on the monotonic clock:
    their one wall-clock read is the anchor taken at export."""
    assert _wall_reads(ROOT / "llmss_tpu_torch" / "utils" / f"{name}.py") \
        == ["export"]


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    import torch

    with tmetrics.profile_trace(str(tmp_path / "p")):
        torch.ones(4, 4) @ torch.ones(4, 4)
    blob = json.loads((tmp_path / "p" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in blob["traceEvents"])
