"""The torch port's flight recorder (``utils/trace.py``) against the JAX
package's, on the CPU: the same event sequences through both recorders
give the same ``events_for``, ``req_ids`` and ``export`` apart from
timestamps, shedding, throttling and eviction included; spans, the
module-level switch and ``ensure_context`` behave alike; and the port's
brokers and Router record the reference's events, with the reference's
attributes, at the reference's sites."""

import os
import subprocess
import sys
import time
from pathlib import Path

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
