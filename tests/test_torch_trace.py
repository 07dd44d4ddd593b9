"""The torch port's flight recorder (``utils/trace.py``) against the JAX
package's, on the CPU: the same event sequences through both recorders
give the same ``events_for``, ``req_ids`` and ``export`` apart from
timestamps, shedding, throttling and eviction included; spans, the
module-level switch and ``ensure_context`` behave alike; the port's
brokers and Router record the reference's events, with the reference's
attributes, at the reference's sites. The reading half on the same
exports (anchors fixed, events made from a seed): ``stitch``,
``timeline``, ``slowest``, ``request_cost`` / ``derive_costs``,
``export_workload`` and the Chrome export with counter tracks equal the
reference's; ``local_cost`` reads this process's recorder; the producer
serves ``/trace/{id}`` (JSON and Chrome), ``/trace/slowest`` and a 404,
and ``POST /profile`` one capture at a time."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import llmss_tpu.serve.broker as rbroker
import llmss_tpu.serve.fleet as rfleet
import llmss_tpu.serve.handoff as rhandoff
import llmss_tpu.serve.protocol as rproto
import llmss_tpu.utils.trace as rtrace
import llmss_tpu_torch.serve.broker as tbroker
import llmss_tpu_torch.serve.fleet as tfleet
import llmss_tpu_torch.serve.handoff as thandoff
import llmss_tpu_torch.serve.protocol as tproto
import llmss_tpu_torch.utils.trace as ttrace
from llmss_tpu.serve.chaos import FakeRedis

ROOT = Path(__file__).resolve().parent.parent


def _strip(ev: dict) -> dict:
    """An event without its timestamps."""
    return {k: v for k, v in ev.items() if k not in ("t", "dur")}


def _export(rec, **kw) -> dict:
    out = rec.export(**kw)
    assert out["wall_anchor"] > 0 and out["mono_anchor"] > 0
    return {"proc": out["proc"], "requests": {
        rid: {**r, "events": [_strip(e) for e in r["events"]]}
        for rid, r in out["requests"].items()}}


def _script(mod, max_requests=4, max_events=6):
    """One sequence of record calls: lifecycle and sheddable events past
    a request's ring, throttled renewals, more requests than the ring
    keeps, durations, attributes and a per-event process name."""
    rec = mod.FlightRecorder(max_requests=max_requests,
                             max_events=max_events, proc="p")
    rec.record("a", "enqueue", trace_id="a", queue="shared", plen=3)
    rec.record("a", "lease", worker="w0", attempt=1)
    for i in range(5):
        rec.record("a", "group_step", i=i)
    rec.record("a", "lease_renew", throttle_s=60.0)
    rec.record("a", "lease_renew", throttle_s=60.0)  # throttled
    rec.record("a", "respond", ok=True, n_tokens=4)
    rec.record("a", "failover", worker="w0")  # sheds a group event
    for i in range(4):
        rec.record("a", "handoff_renew")  # sheddable: dropped when full
    for rid in ("b", "c", "d", "e"):
        rec.record(rid, "enqueue", trace_id=rid, dur_s=0.5, proc="other")
    rec.record("b", "lease")  # b becomes the most recent
    rec.record("f", "enqueue")  # evicts the least recent: c
    with rec.start_span("b", "prefill", worker="w1") as sp:
        sp.end(n_tokens=3)
        sp.end(n_tokens=9)  # idempotent
    with pytest.raises(KeyError):
        with rec.start_span("d", "decode"):
            raise KeyError("boom")
    return rec


def test_recorder_equals_reference():
    want, got = _script(rtrace), _script(ttrace)
    # a and c evicted; the spans made b, then d, the most recent.
    assert got.req_ids() == want.req_ids() == ["e", "f", "b", "d"]
    for rid in ("a", "b", "c", "d", "e", "f", "zz"):
        assert [_strip(e) for e in got.events_for(rid)] == \
            [_strip(e) for e in want.events_for(rid)]
    assert _export(got) == _export(want)
    assert _export(got, max_events=3) == _export(want, max_events=3)
    assert _export(got, req_ids={"b", "zz"}) == _export(want, req_ids={"b"})
    ev = got.events_for("b")
    assert ev[-1]["name"] == "prefill" and ev[-1]["attrs"] == {
        "worker": "w1", "n_tokens": 3} and ev[-1]["dur"] >= 0
    assert got.events_for("d")[-1]["attrs"] == {"error": "KeyError"}
    got.clear()
    assert got.req_ids() == []


def test_shedding_keeps_lifecycle_events():
    """A full request sheds group and renewal events first, never a
    lifecycle event in their favour, and counts what it dropped."""
    for mod in (rtrace, ttrace):
        rec = mod.FlightRecorder(max_events=3)
        rec.record("a", "enqueue")
        rec.record("a", "group_x")
        rec.record("a", "lease")
        rec.record("a", "respond")  # sheds group_x
        rec.record("a", "lease_renew")  # sheddable and full: dropped
        rec.record("a", "failover")  # nothing sheddable left: dropped
        names = [e["name"] for e in rec.events_for("a")]
        assert names == ["enqueue", "lease", "respond"], mod
        assert rec.export()["requests"]["a"]["dropped"] == 3


def test_module_switch_spans_and_context(monkeypatch):
    monkeypatch.setattr(ttrace, "_RECORDER", ttrace.FlightRecorder())
    assert ttrace.recorder() is ttrace._RECORDER
    was = ttrace.enabled()
    try:
        ttrace.set_enabled(True)
        ttrace.record("r", "enqueue", queue="q")
        ttrace.record(None, "enqueue")  # no request: nothing
        with ttrace.span("r", "decode", worker="w"):
            pass
        assert [e["name"] for e in ttrace.recorder().events_for("r")] == [
            "enqueue", "decode"]
        ttrace.set_enabled(False)
        ttrace.record("r", "respond")
        sp = ttrace.span("r", "late")
        sp.end()
        assert len(ttrace.recorder().events_for("r")) == 2
    finally:
        ttrace.set_enabled(was)
    req = tproto.GenerateRequest(id="x", token_ids=[1])
    ttrace.ensure_context(req)
    assert req.trace_id == "x"
    req.trace_id = "kept"
    ttrace.ensure_context(req)
    assert req.trace_id == "kept"


def test_llmss_trace_env_turns_tracing_off():
    code = ("import llmss_tpu_torch.utils.trace as t\n"
            "t.record('r', 'enqueue')\n"
            "print(t.enabled(), t.recorder().req_ids())")
    for env, want in (("off", "False []"), ("1", "True ['r']")):
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             timeout=60, capture_output=True, text=True,
                             env={**os.environ, "LLMSS_TRACE": env})
        assert out.stdout.strip() == want, out.stderr


# -- the recording sites -------------------------------------------------------------


def _broker_ops(bmod, fmod, hmod, pmod, kind):
    """One sequence of broker and Router operations; returns each
    request's events without timestamps."""
    kw = dict(lease_s=60.0, max_delivery_attempts=2)
    if kind == "inproc":
        b = bmod.InProcBroker(**kw)
    else:
        b = bmod.RedisBroker(client=FakeRedis(), worker_id="w0", **kw)
    R = pmod.GenerateRequest
    b.push_request(R(id="s", token_ids=[1, 2], max_new_tokens=3,
                     prefix_token_ids=[1], session_id="sess", turn=2))
    got = b.pop_request(worker_id="w0")
    b.touch_requests([got.id])
    b.push_response(pmod.GenerateResponse(id="s", token_ids=[4, 5]))
    b.push_request(R(id="rel", token_ids=[3]))
    b.release_requests([b.pop_request(worker_id="w0").id])
    p = b.pop_request(worker_id="w0")
    p.resume_tokens = [7]
    b.preempt_requests([p])
    b.push_request_to("w0", R(id="fo", token_ids=[4], slo_class="batch"))
    b.push_request_to("w0", R(id="dl", token_ids=[5]))
    # The routed queue drains class by class: standard, then batch.
    assert [b.pop_request(worker_id="w0").id for _ in range(2)] == [
        "dl", "fo"]
    b.push_request(R(id="late", token_ids=[6], deadline_ts=time.time() - 1))
    assert b.pop_request(worker_id="w0").id == "rel"
    assert b.pop_request(worker_id="w0").id == "late"
    # w0's leases: dl, fo and rel come back, late is shed.
    assert [r.id for r in b.failover_worker("w0")] == ["dl", "fo", "rel"]
    h = R(id="h", token_ids=[8, 9], max_new_tokens=2)
    b.push_request(h)
    leased = b.pop_request(worker_id="w0")
    rec = hmod.HandoffRecord(req=leased, first_token=1, n_tokens=2,
                             payload=b"x" * 5)
    b.push_handoff_to("d0", rec)
    back = b.pop_handoff(worker_id="d0")
    b.touch_handoffs([back.req.id])
    b.fail_handoff(back, error="corrupt")
    b.register_worker({"worker_id": "w1", "state": "ready",
                       "heartbeat_ts": time.time(), "heartbeat_s": 5.0})
    router = fmod.Router(b, "least_loaded")
    router.submit(R(id="routed", token_ids=[3, 3]))
    router.submit(R(id="routed2", token_ids=[3, 4], trace_id="t2"))
    ids = ("s", "rel", "fo", "dl", "late", "h", "routed", "routed2")
    return {rid: [_strip(e) for e in _recorder_of(bmod).events_for(rid)]
            for rid in ids}


def _recorder_of(bmod):
    return (rtrace if bmod is rbroker else ttrace).recorder()


@pytest.mark.parametrize("kind", ("inproc", "redis"))
def test_brokers_and_router_record_the_reference_events(kind, monkeypatch):
    monkeypatch.setattr(rtrace, "_RECORDER", rtrace.FlightRecorder())
    monkeypatch.setattr(ttrace, "_RECORDER", ttrace.FlightRecorder())
    monkeypatch.setattr(rtrace, "_ENABLED", True)
    monkeypatch.setattr(ttrace, "_ENABLED", True)
    want = _broker_ops(rbroker, rfleet, rhandoff, rproto, kind)
    got = _broker_ops(tbroker, tfleet, thandoff, tproto, kind)
    assert got == want
    names = {e["name"] for evs in got.values() for e in evs}
    assert {"enqueue", "lease", "lease_renew", "respond", "release",
            "preempt", "deadline", "failover", "handoff_push",
            "handoff_lease", "handoff_renew", "reprefill",
            "route"} <= names


def test_worker_heartbeat_carries_the_recorder(monkeypatch):
    """A fleet member's registry entry carries the recorder's snapshot;
    the supervisor's metrics block does not."""
    from llmss_tpu_torch.serve.chaos import ScriptedEngine
    from llmss_tpu_torch.serve.consumer import Worker
    from llmss_tpu_torch.serve.supervisor import Supervisor

    monkeypatch.setattr(ttrace, "_RECORDER", ttrace.FlightRecorder())
    monkeypatch.setattr(ttrace, "_ENABLED", True)
    b = tbroker.InProcBroker()
    w = Worker(ScriptedEngine(), b, batch_size=1, poll_timeout_s=0.0,
               worker_id="w0", snapshot_interval_s=0.0)
    b.push_request_to("w0", tproto.GenerateRequest(id="q", token_ids=[1],
                                                   max_new_tokens=2))
    w.run_once()
    w.run_once()  # publishes the heartbeat after the answer
    blob = b.read_workers()["w0"]["trace"]
    assert [e["name"] for e in blob["requests"]["q"]["events"]] == [
        "enqueue", "lease", "lease_renew", "decode", "respond"]
    sup = Supervisor(lambda: w, b)
    sup._worker = w
    assert "trace" not in sup._extra()["worker"]
    monkeypatch.setattr(ttrace, "_ENABLED", False)
    assert "trace" not in w.load_snapshot()


# -- the reading half: stitching, costs, the workload and Chrome exports -------------

_NAMES = ("enqueue", "lease", "lease_renew", "sched_submit", "admit",
          "prefill", "decode", "handoff_push", "handoff_lease", "kv_export",
          "kv_adopt", "adopt", "finish", "reprefill", "preempt", "evict",
          "group_fetch", "respond")


def _seeded_exports(seed: int, procs: int = 3, reqs: int = 6) -> list:
    """Process exports with fixed anchors and seeded events: each request
    enqueued in process 0, its later events spread over the processes,
    most of them answered."""
    rng = np.random.default_rng(seed)
    anchors = [(float(rng.uniform(100, 1000)), 1.7e9 + float(rng.uniform(
        0, 5))) for _ in range(procs)]
    out = [{"proc": f"p{i}", "mono_anchor": a, "wall_anchor": w,
            "requests": {}} for i, (a, w) in enumerate(anchors)]
    for r in range(reqs):
        rid = f"r{r}"
        t_wall = 1.7e9 + float(rng.uniform(0, 3))
        names = ["enqueue", "lease"] + [
            str(n) for n in rng.choice(_NAMES[2:-1], int(rng.integers(2, 9)))]
        if rng.random() < 0.8:
            names.append("respond")
        for k, name in enumerate(names):
            p = 0 if k == 0 else int(rng.integers(0, procs))
            mono, wall = anchors[p]
            t_wall += float(rng.uniform(0.001, 0.3))
            ev = {"req_id": rid, "name": name, "t": mono - (wall - t_wall)}
            if name in ("prefill", "decode", "admit", "kv_export",
                        "kv_adopt"):
                ev["dur"] = float(rng.uniform(0.0, 0.2))
            attrs = {}
            if name == "enqueue":
                attrs = {"plen": int(rng.integers(1, 99)), "max_new": 8,
                         "slo_class": str(rng.choice(
                             ["interactive", "standard", "batch"]))}
                if rng.random() < 0.5:
                    attrs.update(session="s1", turn=r)
            elif name == "lease":
                attrs = {"attempt": int(rng.integers(1, 3))}
            elif name == "handoff_push":
                attrs = {"bytes": int(rng.integers(1, 4096))}
            elif name == "finish":
                attrs = {"tokens": 8, "kv_block_s": 0.25}
            elif name == "respond":
                attrs = ({"ok": True, "n_tokens": 8} if rng.random() < 0.8
                         else {"ok": False, "error": "boom"})
            if attrs:
                ev["attrs"] = attrs
            reqd = out[p]["requests"].setdefault(
                rid, {"trace_id": rid if p == 0 else None, "dropped": 0,
                      "events": []})
            reqd["events"].append(ev)
    return out


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_reading_half_equals_reference(seed):
    ex = _seeded_exports(seed)
    dup = ex + [ex[0]]  # one process through two paths
    counters = [{"proc": "p0", "mono_anchor": ex[0]["mono_anchor"],
                 "wall_anchor": ex[0]["wall_anchor"],
                 "counters": [{"t": ex[0]["mono_anchor"] - 5.0 + i,
                               "tracks": {"kv_blocks": {"in_use": i,
                                                        "free": 9 - i},
                                          "rows": {"decode": i % 3}}}
                              for i in range(4)]}]
    for fn, args in (("normalize", (ex[1],)), ("stitch", (dup,)),
                     ("stitch", (dup, "r2")), ("timeline", (dup, "r3")),
                     ("timeline", (dup, "nope")), ("slowest", (dup, 4)),
                     ("slowest", (dup, 9, "decode")),
                     ("derive_costs", (dup,)), ("export_workload", (dup,))):
        assert getattr(ttrace, fn)(*args) == getattr(rtrace, fn)(*args), fn
    for rid in (None, "r1"):
        assert ttrace.to_chrome_trace(dup, rid, counters=counters) == \
            rtrace.to_chrome_trace(dup, rid, counters=counters)
        assert ttrace.chrome_trace_json(dup, rid, counters=counters) == \
            rtrace.chrome_trace_json(dup, rid, counters=counters)
    evs = ttrace.stitch(ex)
    for rid in {e["req_id"] for e in evs}:
        mine = [e for e in evs if e["req_id"] == rid]
        assert ttrace.request_cost(mine) == rtrace.request_cost(mine)
        assert ttrace.phase_breakdown(mine) == rtrace.phase_breakdown(mine)
        assert ttrace.dominant_phase(mine) == rtrace.dominant_phase(mine)


def test_chrome_export_is_valid_and_aligned():
    ex = _seeded_exports(3)
    counters = [{"proc": "pc", "mono_anchor": 50.0, "wall_anchor": 1.6e9,
                 "counters": [{"t": 49.0, "tracks": {"mfu": {"x": 0.5}}}]}]
    doc = json.loads(ttrace.chrome_trace_json(ex, counters=counters))
    evs = doc["traceEvents"]
    assert doc["displayTimeUnit"] == "ms"
    assert {e["ph"] for e in evs} <= {"M", "X", "i", "C"}
    assert all(e["ts"] >= 0 for e in evs if "ts" in e)
    cs = [e for e in evs if e["ph"] == "C"]
    assert cs and cs[0]["name"] == "mfu" and cs[0]["ts"] == 0.0
    assert all(e["s"] == "t" for e in evs if e["ph"] == "i")


def test_local_cost_reads_this_process_recorder(monkeypatch):
    monkeypatch.setattr(ttrace, "_RECORDER", ttrace.FlightRecorder())
    monkeypatch.setattr(ttrace, "_ENABLED", True)
    assert ttrace.local_cost("q") is None
    ttrace.record("q", "enqueue", trace_id="q", slo_class="interactive")
    ttrace.record("q", "lease", attempt=1)
    ttrace.record("q", "admit", dur_s=0.01)
    ttrace.record("q", "finish", tokens=3, kv_block_s=0.5)
    assert ttrace.local_cost("q") is None  # not answered yet
    ttrace.record("q", "respond", ok=True, n_tokens=3)
    c = ttrace.local_cost("q")
    assert (c["req_id"], c["ok"], c["tokens"], c["slo_class"], c["kv_block_s"],
            c["attempts"]) == ("q", True, 3, "interactive", 0.5, 1)
    assert c["ttft_s"] >= 0 and c["queue_wait_s"] >= 0
    bad = ttrace.local_cost("q", error="lost")
    assert bad["ok"] is False and bad["error"] == "lost"


def _get(port: int, path: str):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_producer_trace_endpoints(monkeypatch):
    import llmss_tpu_torch.utils.devtel as tdevtel
    from llmss_tpu_torch.serve.producer import ProducerServer

    monkeypatch.setattr(ttrace, "_RECORDER", ttrace.FlightRecorder())
    monkeypatch.setattr(ttrace, "_ENABLED", True)
    tdevtel.reset()
    tdevtel.record_counters({"kv_blocks": {"in_use": 3, "free": 5}})
    srv = ProducerServer(tbroker.InProcBroker(), host="127.0.0.1", port=0,
                         timeout_s=5.0)
    srv.start()
    try:
        ttrace.record("rq1", "enqueue", trace_id="rq1", queue="shared")
        with ttrace.span("rq1", "prefill", trace_id="rq1", worker="w0"):
            time.sleep(0.01)
        ttrace.record("rq1", "respond", ok=True)
        status, raw = _get(srv.port, "/trace/rq1")
        tl = json.loads(raw)
        assert status == 200 and tl["req_id"] == tl["trace_id"] == "rq1"
        assert [e["name"] for e in tl["events"]] == ["enqueue", "prefill",
                                                     "respond"]
        assert tl["dominant_phase"] == "prefill"
        status, raw = _get(srv.port, "/trace/rq1?format=chrome")
        ch = json.loads(raw)
        assert status == 200
        assert any(e["ph"] == "X" and e["name"] == "prefill"
                   for e in ch["traceEvents"])
        assert any(e["ph"] == "C" and e["name"] == "kv_blocks"
                   for e in ch["traceEvents"])
        sl = json.loads(_get(srv.port, "/trace/slowest?n=5")[1])["slowest"]
        assert [r["req_id"] for r in sl] == ["rq1"]
        assert _get(srv.port, "/trace/nope")[0] == 404
        assert _get(srv.port, "/trace/nope?format=chrome")[0] == 404
    finally:
        srv.stop()
        tdevtel.reset()


def test_profile_endpoint_serializes_captures(tmp_path):
    import urllib.request

    from llmss_tpu_torch.serve import producer as producer_mod
    from llmss_tpu_torch.serve.producer import ProducerServer

    srv = ProducerServer(tbroker.InProcBroker(), host="127.0.0.1", port=0)
    srv.start()

    def post(body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/profile",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    import urllib.error

    try:
        code, body = post({"log_dir": str(tmp_path / "prof"),
                           "duration_s": 0.3})
        assert code == 202 and body["profiling"] is True
        assert body["duration_s"] == 0.3
        assert post({"duration_s": 0.1})[0] == 409
        end = time.monotonic() + 30.0
        while producer_mod._PROFILE_ACTIVE:
            assert time.monotonic() < end, "the profile never finished"
            time.sleep(0.05)
        assert (tmp_path / "prof" / "trace.json").exists()
    finally:
        srv.stop()
