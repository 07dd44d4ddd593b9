"""The torch port's SLO plane against the JAX package's, on the CPU:
``evaluate_slos`` on the same exports (pinned by hand and made from a
seed), ``observe_request_cost`` on the same cost records, the
respond-time cost attribution of both brokers (exactly once under a
chaos kill, errors as errors), ``timeseries_payload`` and the workload
export of the same traffic, the brownout ladder in admission, and the
producer's ``/slo``, ``/fleet/timeseries``, ``/trace/slowest`` and
``/trace/export_workload``."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import llmss_tpu.serve.broker as rbroker
import llmss_tpu.serve.chaos as rchaos
import llmss_tpu.serve.fleet as rfleet
import llmss_tpu.serve.handoff as rhandoff
import llmss_tpu.serve.producer as rproducer
import llmss_tpu.serve.protocol as rproto
import llmss_tpu.utils.metrics as rmetrics
import llmss_tpu.utils.trace as rtrace
import llmss_tpu_torch.serve.broker as tbroker
import llmss_tpu_torch.serve.chaos as tchaos
import llmss_tpu_torch.serve.fleet as tfleet
import llmss_tpu_torch.serve.handoff as thandoff
import llmss_tpu_torch.serve.producer as tproducer
import llmss_tpu_torch.serve.protocol as tproto
import llmss_tpu_torch.utils.metrics as tmetrics
import llmss_tpu_torch.utils.trace as ttrace

BROKER_KINDS = ("inproc", "fakeredis")
REF = dict(broker=rbroker, chaos=rchaos, fleet=rfleet, handoff=rhandoff,
           producer=rproducer, proto=rproto, metrics=rmetrics, trace=rtrace)
PORT = dict(broker=tbroker, chaos=tchaos, fleet=tfleet, handoff=thandoff,
            producer=tproducer, proto=tproto, metrics=tmetrics, trace=ttrace)


@pytest.fixture(autouse=True)
def clean_plane():
    """Both packages' recorders and series start empty, tracing on."""
    for pkg in (REF, PORT):
        pkg["trace"].set_enabled(True)
        pkg["trace"].recorder().clear()
        pkg["metrics"].series().clear()
    yield
    for pkg in (REF, PORT):
        pkg["trace"].set_enabled(True)
        pkg["trace"].recorder().clear()
        pkg["metrics"].series().clear()


def make_brokers(pkg, kind, **kw):
    """(the producer's broker, make_worker_broker(worker_id))."""
    if kind == "inproc":
        b = pkg["broker"].InProcBroker(**kw)
        return b, (lambda wid: b)
    server = pkg["chaos"].FakeRedis()

    def mk(wid):
        return pkg["broker"].RedisBroker(client=server, worker_id=wid, **kw)

    return mk("producer"), mk


def _get(port: int, path: str):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _post(port: int, path: str, body: dict):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


# -- evaluate_slos ---------------------------------------------------------------


def _counts(reg) -> dict:
    """A registry's counter totals and histogram counts (no sums: they are
    times)."""
    out = {}
    for n, b in reg.export()["series"].items():
        out[n] = (b["total"] if b["kind"] == "counter"
                  else (b["total"]["count"], b["total"]["counts"]))
    return out


def _pinned_exports():
    """10 TTFTs (5 at <= 0.5 s, 5 at <= 1.0 s), 10 requests, 1 error, all
    live: attainment 0.5 (burn 10, p95 1 s) and 0.9 (burn 100)."""
    bounds = list(rmetrics.DEFAULT_BOUNDS_S)
    counts = [0] * (len(bounds) + 1)
    counts[bounds.index(0.5)] = 5
    counts[bounds.index(1.0)] = 5
    return [{"proc": "pA", "mono_anchor": 1000.0, "wall_anchor": 5000.0,
             "series": {
                 "ttft_s": {"kind": "histogram", "bucket_s": 10.0,
                            "bounds": bounds,
                            "total": {"count": 10, "sum": 6.0,
                                      "counts": counts},
                            "slots": [[99, 10, 6.0, counts]]},
                 "requests_total": {"kind": "counter", "bucket_s": 10.0,
                                    "total": 10.0, "slots": [[99, 10.0]]},
                 "requests_error": {"kind": "counter", "bucket_s": 10.0,
                                    "total": 1.0, "slots": [[99, 1.0]]}}}]


def test_burn_rates_equal_the_reference_and_the_hand_computed():
    out = tmetrics.evaluate_slos(_pinned_exports())
    assert out == rmetrics.evaluate_slos(_pinned_exports())
    assert out["windows"] == {"5m": 300.0, "1h": 3600.0}
    rows = {r["name"]: r for r in out["objectives"]}
    cell = rows["ttft_p95_500ms"]["windows"]["5m"]
    assert (cell["count"], cell["attainment"], cell["burn_rate"],
            cell["p95_ms"]) == (10, 0.5, 10.0, 1000.0)
    err = rows["terminal_error_rate"]["windows"]["5m"]
    assert (err["bad"], err["attainment"], err["burn_rate"]) == (1, 0.9, 100.0)
    assert rows["e2e_p95_5s"]["met"] is None
    clean = _pinned_exports()
    clean[0]["series"]["requests_error"]["slots"] = []
    rows = {r["name"]: r for r in tmetrics.evaluate_slos(clean)["objectives"]}
    assert rows["terminal_error_rate"]["met"] is True
    assert rows["terminal_error_rate"]["windows"]["5m"]["burn_rate"] == 0.0


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_evaluate_slos_equals_reference_on_seeded_exports(seed):
    rng = np.random.default_rng(seed)
    bounds = list(rmetrics.DEFAULT_BOUNDS_S)
    exports = []
    for p in range(3):
        anchor = float(rng.uniform(400.0, 9000.0))
        last = int(anchor // 10.0)
        series = {}
        for name in ("ttft_s", "e2e_s", "ttft_s_interactive",
                     "ttft_s_standard", "ttft_s_batch"):
            slots = []
            for e in sorted({int(x) for x in last - rng.integers(0, 400, 5)}):
                c = [int(x) for x in rng.integers(0, 5, len(bounds) + 1)]
                slots.append([e, sum(c), 1.0, c])
            series[name] = {"kind": "histogram", "bucket_s": 10.0,
                            "bounds": bounds, "slots": slots,
                            "total": {"count": 0, "sum": 0.0,
                                      "counts": [0] * (len(bounds) + 1)}}
        for name, hi in (("requests_total", 20), ("requests_error", 2)):
            series[name] = {"kind": "counter", "bucket_s": 10.0, "total": 0.0,
                            "slots": [[last - int(d), float(rng.integers(
                                0, hi))] for d in sorted(set(
                                    rng.integers(0, 300, 4).tolist()))]}
        exports.append({"proc": f"p{p}", "mono_anchor": anchor,
                        "wall_anchor": 1.7e9, "series": series})
    objectives = list(rmetrics.DEFAULT_SLO_OBJECTIVES) + [{
        "name": "ttft_p95_100ms_interactive", "kind": "latency",
        "series": "ttft_s_interactive", "threshold_ms": 100.0,
        "target": 0.9}]
    for objs in (None, objectives):
        got = tmetrics.evaluate_slos(exports, objs)
        assert got == rmetrics.evaluate_slos(exports, objs)
        assert tfleet.interactive_burn(got) == rfleet.interactive_burn(got)


@pytest.mark.parametrize("seed", (3, 4))
def test_observe_request_cost_equals_reference(seed):
    rng = np.random.default_rng(seed)
    classes = ("interactive", "standard", "batch", None, "weird")
    costs = []
    for i in range(40):
        c = {"req_id": f"r{i}", "ok": bool(rng.random() > 0.2),
             "slo_class": classes[int(rng.integers(0, len(classes)))]}
        for f in ("total_s", "ttft_s", "queue_wait_s", "prefill_s",
                  "decode_s", "handoff_s", "kv_block_s"):
            c[f] = None if rng.random() < 0.2 else float(rng.uniform(0, 20))
        for f in ("tokens", "handoff_bytes", "reprefills", "preemptions"):
            c[f] = int(rng.integers(0, 50)) if rng.random() < 0.8 else None
        costs.append(c)
    totals = []
    for m in (rmetrics, tmetrics):
        reg = m.SeriesRegistry(proc="t")
        for c in costs:
            m.observe_request_cost(c, registry=reg)
        ex = reg.export()["series"]
        totals.append({n: b["total"] for n, b in ex.items()})
    assert totals[0] == totals[1]


# -- the brokers' respond-time attribution ------------------------------------------------


class _KillOnAdopt(tchaos.ScriptedEngine):
    """The first ``kills`` adoptions die mid-adopt, the lease open."""

    def __init__(self, kills: int):
        super().__init__()
        self._kills_left = kills
        self._klock = threading.Lock()

    def adopt_generate(self, *a, **kw):
        with self._klock:
            if self._kills_left > 0:
                self._kills_left -= 1
                raise tchaos.HardKill("decode replica died mid-adopt")
        return super().adopt_generate(*a, **kw)


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_chaos_kill_attributes_cost_exactly_once(kind):
    """Two decode replicas die mid-handoff; every request settles with
    exactly one cost record, the killed attempts' reprefills folded into
    the surviving one."""
    b, mk = make_brokers(PORT, kind, lease_s=0.25, max_delivery_attempts=6)
    eng = _KillOnAdopt(2)
    pre = tchaos.ChaosWorkerHost(
        lambda: thandoff.PrefillWorker(tchaos.ScriptedEngine(), mk("p0"),
                                       worker_id="p0", poll_timeout_s=0.02),
        respawn_delay_s=0.02)
    dec = tchaos.ChaosWorkerHost(
        lambda: thandoff.DecodeWorker(eng, mk("d0"), worker_id="d0",
                                      poll_timeout_s=0.02),
        respawn_delay_s=0.02)
    reqs = [tproto.GenerateRequest(id=f"c{i}", token_ids=[i + 2, 9],
                                   max_new_tokens=4,
                                   deadline_ts=time.time() + 30.0)
            for i in range(4)]
    pre.start()
    dec.start()
    try:
        for r in reqs:
            b.push_request(r)
        for r in reqs:
            resp = b.wait_response(r.id, timeout=20.0)
            assert resp is not None and resp.error is None, r.id
    finally:
        pre.stop()
        dec.stop()
    assert pre.error is None and dec.error is None and dec.kills == 2
    reg = tmetrics.series()
    assert reg.counter("requests_total").total == len(reqs)
    assert reg.counter("requests_error").total == 0.0
    assert reg.histogram("e2e_s").total_count == len(reqs)
    assert reg.counter("reprefills").total == 2.0
    costs = ttrace.derive_costs([ttrace.recorder().export()])
    assert sorted(c["req_id"] for c in costs) == sorted(r.id for r in reqs)
    assert sum(c["reprefills"] for c in costs) == 2
    assert all(c["attempts"] >= 2 for c in costs if c["reprefills"])
    assert reg.counter("tokens_out").total == sum(c["tokens"] for c in costs)


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_error_response_attributed_as_error_as_in_the_reference(kind):
    got = []
    for pkg in (REF, PORT):
        b, _ = make_brokers(pkg, kind, lease_s=2.0)
        pkg["trace"].record("bad", "enqueue", trace_id="bad",
                            slo_class="interactive")
        b.push_response(pkg["proto"].GenerateResponse(id="bad", token_ids=[],
                                                      error="boom"))
        got.append(_counts(pkg["metrics"].series()))
    assert got[0] == got[1]
    assert got[1]["requests_error"] == 1.0


def _serve(pkg, reqs, kind="inproc"):
    """``reqs`` through a prefill and a decode role worker of ``pkg``."""
    b, mk = make_brokers(pkg, kind, lease_s=5.0)
    pre = pkg["handoff"].PrefillWorker(pkg["chaos"].ScriptedEngine(),
                                       mk("p0"), worker_id="p0")
    dec = pkg["handoff"].DecodeWorker(pkg["chaos"].ScriptedEngine(),
                                      mk("d0"), worker_id="d0")
    for r in reqs:
        b.push_request(r)
    got: dict = {}
    end = time.monotonic() + 20
    while len(got) < len(reqs) and time.monotonic() < end:
        pre.run_once()
        dec.run_once()
        for r in reqs:
            if r.id not in got:
                a = b.wait_response(r.id, timeout=0.01)
                if a is not None:
                    got[r.id] = a
    assert len(got) == len(reqs)
    return b


def _traffic(proto):
    shared = [7] * 8
    return [proto.GenerateRequest(id="w0", token_ids=[1, 2, 3],
                                  max_new_tokens=4, prefix_token_ids=shared,
                                  slo_class="interactive"),
            proto.GenerateRequest(id="w1", token_ids=[4, 5], max_new_tokens=3,
                                  prefix_token_ids=shared,
                                  session_id="s", turn=1),
            proto.GenerateRequest(id="w2", token_ids=[6, 7, 8, 9],
                                  max_new_tokens=2, slo_class="batch")]


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_workload_export_and_costs_equal_the_reference(kind):
    """The same traffic through both packages' role workers: the workload
    rows and the per-request costs agree in every field but the times."""
    out = []
    for pkg in (REF, PORT):
        _serve(pkg, _traffic(pkg["proto"]), kind)
        ex = [pkg["trace"].recorder().export()]
        wl = pkg["trace"].export_workload(ex)
        costs = {c["req_id"]: c for c in pkg["trace"].derive_costs(ex)}
        out.append((
            [{k: v for k, v in r.items() if k not in ("arrival_s",
                                                       "think_s")}
             for r in sorted(wl["requests"], key=lambda r: r["req_id"])],
            {rid: {k: v for k, v in c.items() if not k.endswith("_s")
                   and k not in ("n_events",)} for rid, c in costs.items()},
            {n: c[0] if isinstance(c, tuple) else c
             for n, c in _counts(pkg["metrics"].series()).items()},
            wl["format"], wl["n_requests"]))
    assert out[0] == out[1]


# -- the producer ------------------------------------------------------------------


def test_producer_slo_plane_endpoints():
    reqs = [tproto.GenerateRequest(id=f"e{i}", token_ids=[i + 1, 4],
                                   max_new_tokens=3) for i in range(3)]
    b = _serve(PORT, reqs)
    srv = tproducer.ProducerServer(b, host="127.0.0.1", port=0, timeout_s=5.0)
    srv.start()
    try:
        slo = json.loads(_get(srv.port, "/slo")[2])
        ref = rmetrics.evaluate_slos([])
        assert set(slo) >= set(ref) and slo["windows"] == ref["windows"]
        assert [r["name"] for r in slo["objectives"]] == \
            [r["name"] for r in ref["objectives"]]
        rows = {r["name"]: r for r in slo["objectives"]}
        err = rows["terminal_error_rate"]["windows"]["5m"]
        assert (err["count"], err["bad"], err["burn_rate"]) == (3, 0, 0.0)
        assert rows["e2e_p95_5s"]["windows"]["5m"]["count"] == 3
        ts = json.loads(_get(srv.port, "/fleet/timeseries")[2])["series"]
        pts = ts["requests_total"]["sources"]["producer"]["points"]
        assert sum(p["v"] for p in pts) == 3.0
        assert ts["e2e_s"]["bounds"] == list(rmetrics.DEFAULT_BOUNDS_S)
        sl = json.loads(_get(srv.port, "/trace/slowest?n=5&phase=decode")[2])
        assert {r["req_id"] for r in sl["slowest"]} == {r.id for r in reqs}
        assert all(r["rank_phase"] == "decode" for r in sl["slowest"])
        assert json.loads(_get(srv.port, "/trace/slowest?phase=never")[2]) \
            == {"slowest": []}
        assert _get(srv.port, "/trace/slowest?n=x")[0] == 400
        wl = json.loads(_get(srv.port, "/trace/export_workload")[2])
        assert wl["format"] == rtrace.WORKLOAD_FORMAT and wl["n_requests"] == 3
        status, headers, prom = _get(srv.port, "/metrics?format=prometheus")
        text = prom.decode()
        assert status == 200 and headers["Content-Type"].startswith(
            "text/plain")
        assert 'llmss_e2e_s_bucket{le="+Inf"} 3' in text
        assert "llmss_e2e_s_count 3" in text
        assert "# TYPE llmss_requests_total counter" in text
        payload = json.loads(_get(srv.port, "/metrics")[2])
        assert "e2e_s" not in payload
        assert payload["brownout"]["state"] == "normal"
    finally:
        srv.stop()


def test_plane_disabled_records_nothing():
    ttrace.set_enabled(False)
    reqs = [tproto.GenerateRequest(id="off", token_ids=[3, 4],
                                   max_new_tokens=3)]
    b = _serve(PORT, reqs)
    assert ttrace.recorder().req_ids() == []
    assert tmetrics.series().names() == []
    srv = tproducer.ProducerServer(b, host="127.0.0.1", port=0, timeout_s=5.0)
    srv.start()
    try:
        rows = json.loads(_get(srv.port, "/slo")[2])["objectives"]
        assert all(c["attainment"] is None
                   for r in rows for c in r["windows"].values())
        assert "compile" not in json.loads(_get(srv.port, "/slo")[2])
        assert json.loads(_get(srv.port, "/trace/export_workload")[2])[
            "n_requests"] == 0
    finally:
        srv.stop()


# -- the brownout ladder in admission ------------------------------------------------------


@pytest.mark.parametrize("rung", (0, 1, 2, 3))
def test_admission_verdict_with_brownout_equals_reference(rung):
    """At each rung, every class through both packages' admission: the
    same verdicts, bodies, Retry-After and capped ``max_new_tokens``."""
    got = []
    for pkg in (REF, PORT):
        ladder = pkg["fleet"].BrownoutController(lambda: 0.0, dwell_s=7.0)
        ladder._rung = rung
        ladder._next_check = float("inf")
        b = pkg["broker"].InProcBroker()
        for i in range(3):
            b.push_request(pkg["proto"].GenerateRequest(
                id=f"q{i}", token_ids=[1], max_new_tokens=1))
        row = []
        for cls in ("interactive", "standard", "batch"):
            req = pkg["proto"].GenerateRequest(id=f"r-{cls}", token_ids=[1],
                                               max_new_tokens=500,
                                               slo_class=cls)
            for depth in (0, 3):
                v = pkg["producer"].admission_verdict(req, b, depth,
                                                      brownout=ladder)
                row.append((v, req.max_new_tokens))
        got.append(row)
    assert got[0] == got[1]


def test_default_ladder_sheds_batch_on_interactive_burn():
    """With no ladder given, the producer's reads its own /slo: slow
    interactive TTFTs in the window climb it, and a batch POST gets a 429
    with the ladder's Retry-After while an interactive one is admitted."""
    b = tbroker.InProcBroker()
    srv = tproducer.ProducerServer(b, host="127.0.0.1", port=0, timeout_s=2.0)
    reg = tmetrics.series()
    for _ in range(20):
        tmetrics.observe_request_cost({"ok": True, "total_s": 9.0,
                                       "ttft_s": 9.0,
                                       "slo_class": "interactive"})
    srv.brownout.check_s = 0.0
    for t in range(3):
        srv.brownout.tick(now=1000.0 + t)
    assert srv.brownout.state()["state"] == "shed-standard"
    assert reg.histogram("ttft_s_interactive").total_count == 20
    srv.start()
    try:
        code, headers, body = _post(srv.port, "/generate", {
            "id": "shed", "token_ids": [1], "max_new_tokens": 2,
            "slo_class": "batch"})
        assert code == 429 and body["error"] == "brownout: shedding batch"
        assert headers["Retry-After"] == str(srv.brownout.retry_after_s)
        assert body["brownout_state"] == "shed-standard"
        fleet = json.loads(_get(srv.port, "/fleet")[2])
        assert fleet["brownout"]["brownout_state"] == 3
        assert "controller" not in fleet
        ev = [e["name"] for e in ttrace.recorder().events_for("shed")]
        assert ev == ["reject"]
    finally:
        srv.stop()


def test_fleet_block_shapes_equal_the_reference():
    """``/fleet``'s brownout block and a controller's state block carry the
    reference's keys."""
    blocks = []
    for pkg in (REF, PORT):
        b = pkg["broker"].InProcBroker()
        ctrl_mod = __import__(
            pkg["broker"].__name__.rsplit(".", 1)[0] + ".controller",
            fromlist=["FleetController"])
        ctrl = ctrl_mod.FleetController(
            b, spawn=lambda r: "x", retire=lambda w: None,
            read_telemetry=lambda: None)
        ctrl.start()
        srv = pkg["producer"].ProducerServer(b, host="127.0.0.1", port=0,
                                             controller=ctrl)
        srv.start()
        try:
            f = srv.fleet()
            blocks.append((sorted(f), sorted(f["brownout"]),
                           f["controller"]))
        finally:
            srv.stop()
    assert blocks[0] == blocks[1]
