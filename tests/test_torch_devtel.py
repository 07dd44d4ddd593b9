"""The torch port's device telemetry (``utils/devtel.py``) against the JAX
package's, on the CPU: the analytical cost model and ``param_stats`` on
the same config and converted weights, the fold's MFU/MBU under the same
injected peaks and intervals, the gauges, the compile events (the port's
graph captures, flagged once steady), the counter tracks and their
Chrome export, ``/compiles``, the profile slot, and a tiny fp32
``ContinuousWorker`` pass whose windowed series equal the JAX worker's on
the same schedule, with no steady-state recompile."""

import json
import time
import urllib.request

import jax
import numpy as np
import pytest

import llmss_tpu.serve.broker as rbroker
import llmss_tpu.serve.consumer as rconsumer
import llmss_tpu.serve.protocol as rproto
import llmss_tpu.utils.devtel as rdevtel
import llmss_tpu.utils.metrics as rmetrics
import llmss_tpu.utils.signatures as rsig
import llmss_tpu.utils.trace as rtrace
import llmss_tpu_torch.serve.protocol as tproto
import llmss_tpu_torch.utils.devtel as tdevtel
import llmss_tpu_torch.utils.metrics as tmetrics
import llmss_tpu_torch.utils.signatures as tsig
import llmss_tpu_torch.utils.trace as ttrace
from llmss_tpu.engine import DecodeEngine as JEngine
from llmss_tpu.models import decoder as jdec
from llmss_tpu.models.common import DecoderConfig as JCfg
from llmss_tpu.parallel import MeshPlan, make_mesh
from llmss_tpu_torch.convert import params_from_jax
from llmss_tpu_torch.engine.engine import DecodeEngine as TEngine
from llmss_tpu_torch.engine.engine import GenerationParams
from llmss_tpu_torch.engine.scheduler import ContinuousBatcher
from llmss_tpu_torch.models.common import DecoderConfig as TCfg
from llmss_tpu_torch.serve.broker import InProcBroker
from llmss_tpu_torch.serve.consumer import ContinuousWorker
from llmss_tpu_torch.serve.producer import ProducerServer

CFG = dict(model_type="llama", vocab_size=128, hidden_size=64, n_layers=2,
           n_heads=4, n_kv_heads=2, head_dim=16, intermediate_size=96,
           max_position_embeddings=96, activation="silu", norm="rmsnorm",
           mlp="swiglu", positions="rotary", rope_style="half",
           attn_bias=False, mlp_bias=False, dtype="float32")
PAGED = dict(max_seq_len=96, kv_layout="paged", block_size=16, kv_blocks=40)
PEAKS = {"DEVTEL_PEAK_TFLOPS": "123.5", "DEVTEL_HBM_GBPS": "987.25"}


@pytest.fixture(autouse=True)
def clean_plane():
    for tr, dt, m in ((rtrace, rdevtel, rmetrics), (ttrace, tdevtel,
                                                      tmetrics)):
        tr.set_enabled(True)
        tr.recorder().clear()
        dt.set_enabled(True)
        dt.reset()
        m.series().clear()
    yield
    for tr, dt, m in ((rtrace, rdevtel, rmetrics), (ttrace, tdevtel,
                                                      tmetrics)):
        tr.set_enabled(True)
        tr.recorder().clear()
        dt.set_enabled(True)
        dt.reset()
        m.series().clear()


@pytest.fixture
def peaks(monkeypatch):
    """The same injected peaks in both packages."""
    for k, v in PEAKS.items():
        monkeypatch.setenv(k, v)
    rdevtel._reset_peaks()
    tdevtel._reset_peaks()
    yield
    rdevtel._reset_peaks()
    tdevtel._reset_peaks()


@pytest.fixture(scope="module")
def model():
    mesh = make_mesh(MeshPlan(dp=1, tp=1), devices=jax.devices()[:1])
    jp = jdec.init_params(JCfg(**CFG), mesh, jax.random.key(0))
    return mesh, jp, params_from_jax(jax.device_get(jp))


def test_signatures_equal_the_reference():
    assert tsig.KERNEL_CLASSES == rsig.KERNEL_CLASSES
    assert tsig.METERED_CLASSES == rsig.METERED_CLASSES
    assert tdevtel.KERNEL_CLASSES == rdevtel.KERNEL_CLASSES
    assert tdevtel.UTIL_BOUNDS == rdevtel.UTIL_BOUNDS
    for sig in (("decode_group", 8, 2, 8, None), ("ragged_group", 8, 16, 128),
                ("prefill", 4, 128)):
        assert tsig.signature_str(tsig.signature(*sig)) == \
            rsig.signature_str(rsig.signature(*sig))
    for m in (tsig, rsig):
        with pytest.raises(ValueError, match="unknown kernel class"):
            m.signature("nope", 1)


@pytest.mark.parametrize("seed", (0, 1, 2, 3))
def test_cost_model_equals_the_reference(seed):
    """``EngineCostModel`` FLOPs and bytes are exactly equal on the same
    seeded config, counts and shapes."""
    rng = np.random.default_rng(seed)
    heads = int(rng.choice([4, 8, 32]))
    cfg = dict(CFG, n_layers=int(rng.integers(1, 48)), n_heads=heads,
               n_kv_heads=int(heads // rng.choice([1, 2, 4])),
               head_dim=int(rng.choice([64, 128, 256])),
               max_position_embeddings=int(rng.choice([2048, 4096])))
    count, nbytes = int(rng.integers(1e6, 1e10)), int(rng.integers(1e6, 3e10))
    kv = int(rng.choice([1, 2, 4]))
    msl = int(rng.choice([512, 1024]))
    r = rdevtel.EngineCostModel(JCfg(**cfg), count, nbytes, kv_itemsize=kv,
                                max_seq_len=msl)
    t = tdevtel.EngineCostModel(TCfg(**cfg), count, nbytes, kv_itemsize=kv,
                                max_seq_len=msl)
    assert t.kv_bytes_per_token == r.kv_bytes_per_token
    for _ in range(10):
        args = (int(rng.integers(1, 64)), int(rng.integers(1, 32)),
                int(rng.choice([0, 32, 64, 832])) or None,
                int(rng.integers(0, 4096)))
        assert t.step_cost(*args) == r.step_cost(*args)
    assert tdevtel.roofline_seconds(3e12, 4e9, 1e15, 3e12) == \
        rdevtel.roofline_seconds(3e12, 4e9, 1e15, 3e12)


def test_param_stats_and_engine_model_equal_the_reference(model):
    mesh, jp, tp = model
    assert tdevtel.param_stats(tp) == rdevtel.param_stats(jp)
    jeng = JEngine(JCfg(**CFG), jp, mesh, **PAGED)
    teng = TEngine(TCfg(**CFG), tp, device="cpu", **PAGED)
    jm, tm = jeng.devtel_cost_model(), teng.devtel_cost_model()
    assert (tm.param_count, tm.param_bytes, tm.kv_bytes_per_token,
            tm.max_seq_len) == (jm.param_count, jm.param_bytes,
                                jm.kv_bytes_per_token, jm.max_seq_len)
    key = ("decode_group", (4, 2, 4, 32))
    c = teng.devtel_cost(key[0], key[1], batch=4, steps=8, kv_len=32)
    assert c.source == "analytical"
    assert (c.flops, c.hbm_bytes) == jm.step_cost(4, 8, 32)
    # A hit returns the table's entry, whatever is asked of it.
    assert teng.devtel_cost(key[0], key[1], batch=1, steps=1, kv_len=1) is c
    assert tdevtel.costs().export() == {
        "decode_group/4/2/4/32": c.to_dict()}


def test_cost_table_derive_and_export():
    table = tdevtel.CostTable()
    assert table.derive(("prefill", 1, 16)) is None
    c = table.derive(("prefill", 1, 16), fallback=(2.0e9, 3.0e8))
    assert c.to_dict() == {"flops": 2.0e9, "hbm_bytes": 3.0e8,
                           "source": "analytical"}
    assert table.derive(("prefill", 1, 16), fallback=(1.0, 1.0)) is c
    assert table.export() == {"prefill/1/16": c.to_dict()}
    table.clear()
    assert table.export() == {}


@pytest.mark.parametrize("seed", (0, 1))
def test_fold_equals_the_reference(seed, peaks, monkeypatch):
    """The same folds under the same injected peaks: the gauges match to a
    relative 1e-12, the histograms count the same samples, and a reading
    above the peak clamps to 1."""
    for m in (rdevtel, tdevtel):
        monkeypatch.setattr(m, "FOLD_FLUSH_S", 1e9)  # drains on read only
    rng = np.random.default_rng(seed)
    folds = [(str(rng.choice(["decode_group", "ragged_group", "prefill"])),
              float(rng.uniform(1e-3, 0.2)),
              float(rng.uniform(1e9, 1e14)), float(rng.uniform(1e8, 1e11)))
             for _ in range(30)]
    got = []
    for dt, m in ((rdevtel, rmetrics), (tdevtel, tmetrics)):
        assert dt.device_peaks() == (123.5e12, 987.25e9)
        for kind, dur, fl, by in folds:
            dt.fold(kind, dur, dt.KernelCost(fl, by, "analytical"))
        dt.fold("decode", 0.0, dt.KernelCost(1.0, 1.0, "analytical"))
        dt.fold("decode", 0.1, None)
        util = dt.last_util()
        series = m.series().export()["series"]
        got.append((util, {n: b["total"]["count"] for n, b in series.items()}))
    (ru, rs), (tu, ts) = got
    assert ts == rs and set(tu) == set(ru) == {"decode_group", "ragged_group",
                                               "prefill"}
    for kind in ru:
        for f in ("mfu", "mbu"):
            assert tu[kind][f] == pytest.approx(ru[kind][f], rel=1e-12)
        assert tu[kind]["dur_s"] == ru[kind]["dur_s"]
        assert 0.0 < tu[kind]["mfu"] <= 1.0 and 0.0 < tu[kind]["mbu"] <= 1.0
    tdevtel.fold("decode", 1e-9, tdevtel.KernelCost(1e20, 1e20, "analytical"))
    assert tdevtel.last_util()["decode"]["mfu"] == 1.0


@pytest.mark.parametrize("seed", (2, 3))
def test_gauges_and_payloads_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    exports = []
    for p in range(4):
        anchor = float(rng.uniform(100, 900))
        util = {k: {"mfu": float(rng.uniform(0, 1)),
                    "mbu": float(rng.uniform(0, 1)),
                    "t": anchor - float(rng.uniform(0, 50))}
                for k in ("decode_group", "ragged_group")
                if rng.random() < 0.8}
        events = [{"t": anchor - float(rng.uniform(0, 90)), "name": f"e{i}",
                   "source": "graph_capture",
                   "steady_state": bool(rng.random() < 0.3)}
                  for i in range(int(rng.integers(0, 4)))]
        exports.append({"proc": f"p{p % 3}", "mono_anchor": anchor,
                        "wall_anchor": 1.7e9 + p, "util": util,
                        "compiles": {"steady": True, "events": events,
                                     "steady_recompiles": sum(
                                         e["steady_state"] for e in events)}})
    for fn in ("merged_gauges", "phase_utilization", "compiles_payload",
               "recompile_flag", "dedup_exports"):
        assert getattr(tdevtel, fn)(exports) == getattr(rdevtel, fn)(exports)
    for ids in ([], [4], [1, 2, 3, 7, 8], [0, 2, 4], list(range(9))):
        assert tdevtel.largest_run(ids) == rdevtel.largest_run(ids)


def _engine(tp, **kw):
    return TEngine(TCfg(**CFG), tp, device="cpu", **{**PAGED, **kw})


def test_graph_captures_are_compile_events(model):
    """Each capture is an event named by its signature string; prewarm's
    are not steady-state, a capture after it outside a prewarm is, is
    flagged on /slo, and equals the engine's captures after prewarm; a
    second prewarm (a restarted worker's) counts none."""
    _, _, tp = model
    eng = _engine(tp, kv_layout="dense", kv_blocks=None)
    eng.prewarm(2, chunk_steps=4)
    obs = tdevtel.observer()
    ev = obs.events()
    keys = eng._graphs.keys()
    assert len(ev) == len(keys) and obs.steady and not obs.steady_recompiles
    names = {e["name"] for e in ev}
    buckets = eng.prewarm_bucket_set()
    assert names == {f"{k}/2/{tb}/{a}/{f}" for k in ("decode", "decode_group")
                     for tb in buckets for a, f in ((False, False),
                                                    (True, False),
                                                    (True, True))}
    assert all(e["source"] == "graph_capture" and not e["steady_state"]
               and e["dur_s"] >= 0 for e in ev)
    assert eng.devtel_cost("decode_group", (2, 1, 4, None), batch=0, steps=0,
                           kv_len=0) is not None  # priced at prewarm
    eng.metrics.graph_captures = 0
    eng.devtel_req_id = "r-late"
    eng.generate([[1, 2, 3]], GenerationParams(max_new_tokens=3),
                 chunk_steps=2)  # one row: a new cache, new captures
    late = [e for e in obs.events() if e["steady_state"]]
    assert late and obs.steady_recompiles == len(late) == \
        eng.metrics.graph_captures
    assert {e["req_id"] for e in late} == {"r-late"}
    assert "compile" in {e["name"] for e in
                         ttrace.recorder().events_for("r-late")}
    assert all(e["name"].split("/")[1] == "1" for e in late)
    srv = ProducerServer(InProcBroker(), host="127.0.0.1", port=0)
    try:
        flag = srv.slo()["compile"]
        assert flag == {"steady_state_recompiles": len(late), "flagged": True}
        assert srv.metrics_payload()["devtel"]["compiles"] == flag
    finally:
        srv._server.server_close()
    eng.prewarm(1, chunk_steps=4)
    assert obs.steady_recompiles == len(late)


def test_batcher_pass_counter_tracks_and_compiles_endpoint(model):
    """A paged chunked batcher: prewarm prices every group signature the
    live path picks (the fold site hits the table), the pass folds decode
    and ragged groups, and the counter tracks pass the Chrome schema;
    ``/compiles`` lists the captures, none steady."""
    _, _, tp = model
    eng = _engine(tp)
    bat = ContinuousBatcher(eng, rows=4, chunk_steps=4, group_chunks=2,
                            chunked_prefill=8)
    bat.prewarm()
    priced = set(tdevtel.costs().export())
    assert {"ragged_group/4/8/8", "ragged_group/4/2/8"} <= priced
    assert "decode_group/4/1/2/None" in priced
    got = {}
    gen = GenerationParams(max_new_tokens=10)
    for i in range(6):
        bat.submit(list(range(1, 6 + 3 * i)), gen,
                   lambda t, i=i: got.__setitem__(i, t), req_id=f"b{i}")
    bat.run_until_idle()
    assert len(got) == 6 and set(tdevtel.costs().export()) == priced
    util = tdevtel.last_util()
    assert set(util) <= {"decode_group", "ragged_group"} and util
    doc = ttrace.to_chrome_trace([ttrace.recorder().export()],
                                 counters=[tdevtel.export()])
    evs = json.loads(json.dumps(doc))["traceEvents"]
    cs = [e for e in evs if e["ph"] == "C"]
    assert {"rows", "queue_depth", "kv_blocks",
            "kv_fragmentation"} <= {e["name"] for e in cs}
    assert "device_memory" not in {e["name"] for e in cs}
    assert all(e["ts"] >= 0 and e["cat"] == "counter" and e["args"]
               and all(isinstance(v, (int, float)) for v in e["args"].values())
               for e in cs)
    kv = [e["args"] for e in cs if e["name"] == "kv_blocks"]
    assert all(a["in_use"] + a["free"] == 40 for a in kv)
    names = {e["name"] for e in ttrace.recorder().events_for("b0")}
    assert {"sched_submit", "admit", "finish"} <= names
    srv = ProducerServer(InProcBroker(), host="127.0.0.1", port=0)
    srv.start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/compiles", timeout=30) as r:
            comp = json.loads(r.read())
    finally:
        srv.stop()
    assert comp["n_compiles"] == len(eng._graphs.keys())
    assert comp["steady_recompiles"] == 0
    assert all(not e["steady_state"] and "ts_wall" in e
               for e in comp["compiles"])


def test_trace_off_silences_devtel(model):
    _, _, tp = model
    eng = _engine(tp)
    bat = ContinuousBatcher(eng, rows=2, chunk_steps=2)
    ttrace.set_enabled(False)
    assert not tdevtel.enabled()
    bat.prewarm()
    got = {}
    bat.submit([3, 4, 5], GenerationParams(max_new_tokens=6),
               lambda t: got.setdefault(0, t), req_id="off")
    bat.run_until_idle()
    ex = tdevtel.export()
    assert got and ex["counters"] == [] and ex["util"] == {}
    assert ex["compiles"]["events"] == [] and ex["costs"] == {}
    assert tdevtel.device_memory_stats("cpu") is None
    assert tdevtel.install_monitoring_hook() is False


def test_profile_slot_steals_wedged_holder_and_auto_releases(tmp_path):
    from llmss_tpu_torch.serve import producer as producer_mod

    with producer_mod._PROFILE_LOCK:
        saved = (producer_mod._PROFILE_ACTIVE, producer_mod._PROFILE_GEN,
                 producer_mod._PROFILE_DEADLINE)
    try:
        with producer_mod._PROFILE_LOCK:
            producer_mod._PROFILE_GEN += 1
            producer_mod._PROFILE_ACTIVE = producer_mod._PROFILE_GEN
            producer_mod._PROFILE_DEADLINE = time.monotonic() + 30.0
        code, body = producer_mod.start_profile(str(tmp_path / "a"), 0.2)
        assert code == 409 and body["retry_after_s"] > 0
        assert producer_mod.start_profile(None, "x")[0] == 400
        with producer_mod._PROFILE_LOCK:
            producer_mod._PROFILE_DEADLINE = time.monotonic() - 1.0
        code, body = producer_mod.start_profile(str(tmp_path / "b"), 0.2)
        assert code == 202 and body["stole_wedged_slot"] is True
        end = time.monotonic() + 30.0
        while producer_mod._PROFILE_ACTIVE:
            assert time.monotonic() < end, "the profile never released"
            time.sleep(0.05)
        assert (tmp_path / "b" / "trace.json").exists()
    finally:
        with producer_mod._PROFILE_LOCK:
            (producer_mod._PROFILE_ACTIVE, producer_mod._PROFILE_GEN,
             producer_mod._PROFILE_DEADLINE) = saved


def _schedule(proto):
    """The same schedule for both packages' workers: 6 greedy requests of
    the three classes, 5-20 token prompts from seed 7."""
    rng = np.random.default_rng(7)
    cls = ("interactive", "standard", "batch")
    return [proto.GenerateRequest(
        id=f"d{i}", token_ids=[int(t) for t in rng.integers(
            1, CFG["vocab_size"], int(rng.integers(5, 21)))],
        max_new_tokens=8, is_greedy=True, slo_class=cls[i % 3])
        for i in range(6)]


def _run(worker, broker, reqs):
    for r in reqs:
        broker.push_request(r)
    got = {}
    while len(got) < len(reqs):
        worker.run_once()
        for r in reqs:
            if r.id not in got:
                a = broker.wait_response(r.id, timeout=0.0)
                if a is not None:
                    got[r.id] = a.token_ids
    return got


@pytest.mark.parametrize("chunked", (None, 8), ids=("split", "chunked"))
def test_worker_pass_series_and_compiles_equal_the_jax_worker(model, chunked):
    """A prewarmed tiny fp32 ContinuousWorker of each package serves the
    same schedule: the same tokens, windowed request / token totals and
    cost histogram counts, MFU/MBU only for the metered group classes,
    and no steady-state recompile of the port's."""
    mesh, jp, tp = model
    out = []
    for eng, pkg in ((JEngine(JCfg(**CFG), jp, mesh, **PAGED),
                      (rbroker, rconsumer, rproto, rmetrics, rdevtel)),
                     (_engine(tp), None)):
        if pkg is None:
            b = InProcBroker()
            w = ContinuousWorker(eng, b, rows=4, chunk_steps=4,
                                 poll_timeout_s=0.0, chunked_prefill=chunked)
            proto, metrics, devtel = tproto, tmetrics, tdevtel
        else:
            broker, consumer, proto, metrics, devtel = pkg
            b = broker.InProcBroker()
            w = consumer.ContinuousWorker(eng, b, rows=4, chunk_steps=4,
                                          poll_timeout_s=0.0,
                                          chunked_prefill=chunked)
        w.prewarm()
        got = _run(w, b, _schedule(proto))
        series = metrics.series().export()["series"]
        out.append({
            "tokens": got,
            "counters": {n: s["total"] for n, s in series.items()
                         if s["kind"] == "counter"
                         and n != "kv_block_seconds"},
            "histograms": {n: s["total"]["count"] for n, s in series.items()
                           if s["kind"] == "histogram"
                           and not n.startswith(("mfu_", "mbu_"))},
            "metered": sorted(n for n in series
                              if n.startswith(("mfu_", "mbu_"))),
            "steady_recompiles": devtel.export()["compiles"][
                "steady_recompiles"],
            "classes": sorted(devtel.last_util()),
        })
    assert out[0]["tokens"] == out[1]["tokens"]
    for k in ("counters", "histograms"):
        assert out[1][k] == out[0][k], k
    assert out[1]["counters"]["requests_total"] == 6.0
    # The port's steady-state recompile is a graph capture, and a pass
    # after prewarm captures none; the JAX worker's count is its XLA
    # compiles of helper programs after prewarm, which the port has none
    # of (it runs them eagerly).
    assert out[1]["steady_recompiles"] == 0
    assert set(out[1]["classes"]) <= {"decode_group", "ragged_group"}
    assert set(out[0]["classes"]) <= {"decode_group", "ragged_group"}
