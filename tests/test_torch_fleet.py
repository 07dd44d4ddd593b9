"""The torch port's fleet against the JAX package's: the brokers' worker
registry, routed queues, lease holders and failover, the Router's three
policies, ``fleet_status``, the producer's fleet surface, and the workers'
fleet identity, on the CPU.

- The reference's ``tests/test_fleet.py`` cases run against the port's
  modules, in-process and over ``FakeRedis``, and so do the routed-queue
  cases of ``tests/test_handoff.py``. Where a reference case waits for a
  heartbeat to go stale, a registry entry to age out or a deadline to
  pass, the port's case moves a clock it controls instead (an old
  ``heartbeat_ts``, a deadline already past, ``Clock``): the decisions do
  not depend on how fast the machine runs.
- Same schedule, same decisions: one schedule of registrations, load
  snapshots, submits, leases and deaths through the reference's Router on
  its broker and through the port's on its own gives the same picks,
  ``stats()``, failover re-routes and delivery counters, for all three
  policies.
- One wire: on one FakeRedis a port worker's registry entry and routed
  queue are read and served through the reference's Router and broker,
  and the other way round.
- Tokens: a two-worker port fleet of tiny fp32 ``ContinuousWorker``s gives
  the JAX package's ``ContinuousWorker``'s greedy tokens under every
  policy and with a worker killed after its first group; it builds each
  of four shared prefixes once under ``prefix_affinity`` and twice under
  the other policies (the chip run's ``serve_fleet`` order).
"""

import http.client
import json
import threading
import time
from types import SimpleNamespace

import jax
import pytest
import torch

import llmss_tpu.serve.broker as rbroker
import llmss_tpu.serve.chaos as rchaos
import llmss_tpu.serve.consumer as rconsumer
import llmss_tpu.serve.fleet as rfleet
import llmss_tpu.serve.protocol as rproto
import llmss_tpu_torch.serve.broker as tbroker
import llmss_tpu_torch.serve.chaos as tchaos
import llmss_tpu_torch.serve.consumer as tconsumer
import llmss_tpu_torch.serve.fleet as tfleet
import llmss_tpu_torch.serve.protocol as tproto
from llmss_tpu.engine import DecodeEngine as JEngine
from llmss_tpu.models import decoder as jdec
from llmss_tpu.models.common import DecoderConfig as JCfg
from llmss_tpu.parallel import MeshPlan, make_mesh
from llmss_tpu.sim.invariants import audit_exactly_once, collect_responses
from llmss_tpu_torch.convert import params_from_jax
from llmss_tpu_torch.engine.engine import DecodeEngine as TEngine
from llmss_tpu_torch.models.common import DecoderConfig as TCfg
from llmss_tpu_torch.serve.broker import InProcBroker, RedisBroker
from llmss_tpu_torch.serve.chaos import FakeRedis, ScriptedEngine
from llmss_tpu_torch.serve.consumer import ContinuousWorker, Worker
from llmss_tpu_torch.serve.fleet import (
    FleetHarness, Router, fleet_status, routable_workers,
)
from llmss_tpu_torch.serve.handoff import HandoffRecord
from llmss_tpu_torch.serve.producer import (
    ProducerServer, evaluate_fleet_health,
)
from llmss_tpu_torch.serve.protocol import (
    STATE_DEAD, STATE_READY, GenerateRequest, prefix_hash,
)

BROKER_KINDS = ("inproc", "fakeredis")
# A heartbeat stamped at the epoch: stale under any stale factor.
STALE = {"heartbeat_ts": 0.0}


class Clock:
    """Monotonic time the test can move forward: the real clock plus
    ``advance``'d seconds."""

    def __init__(self):
        self.offset = 0.0

    def monotonic(self) -> float:
        return time.monotonic() + self.offset

    def advance(self, s: float) -> None:
        self.offset += s


class ClockedRedis(FakeRedis):
    """A FakeRedis whose server clock (``TIME``) is the test's Clock."""

    def __init__(self, clock: Clock):
        super().__init__()
        self.clock = clock

    def time(self):
        now = self.clock.monotonic()
        sec = int(now)
        return (sec, int((now - sec) * 1e6))


@pytest.fixture
def clock(monkeypatch):
    """A Clock the port's in-process broker reads for its registry and
    leases (only its module's view of ``time`` is replaced)."""
    c = Clock()
    monkeypatch.setattr(tbroker, "time", SimpleNamespace(
        monotonic=c.monotonic, time=time.time, sleep=time.sleep))
    return c


def make_brokers(kind, clock=None, **kw):
    """(the producer's broker, make_worker_broker(worker_id)): in-process,
    one object; over Redis, one client per participant on one server."""
    if kind == "inproc":
        b = InProcBroker(**kw)
        return b, (lambda wid: b)
    server = FakeRedis() if clock is None else ClockedRedis(clock)

    def mk(wid):
        return RedisBroker(client=server, worker_id=wid, **kw)

    return mk("producer"), mk


def snap(**over):
    """A fresh ready worker's load snapshot."""
    s = {"state": STATE_READY, "alive": True, "rows": 4, "inflight_rows": 0,
         "queue_depth": 0, "free_slots": 4, "free_kv_blocks": None,
         "kv_blocks_total": None, "prefix_hashes": [], "heartbeat_s": 5.0,
         "heartbeat_ts": time.time()}
    s.update(over)
    return s


def req(i=0, proto=tproto, **kw):
    kw.setdefault("deadline_ts", time.time() + 60.0)
    toks = list(kw.get("prefix_token_ids") or []) + [i + 1]
    r = proto.GenerateRequest(token_ids=toks, max_new_tokens=4, **kw)
    r.validate()
    return r


def fleet_of(b, *wids, **snap_over):
    for wid in wids:
        b.register_worker({"worker_id": wid, "model": "gpt2"})
        b.publish_worker_load(wid, snap(**snap_over.get(wid, {})))


def hrec(i=0, **kw):
    r = req(i, **kw)
    return HandoffRecord(req=r, first_token=1, n_tokens=len(r.token_ids),
                         payload=b"kv" * 8)


# -- the registry --------------------------------------------------------------------


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_registry_register_publish_read(kind):
    b, _ = make_brokers(kind)
    b.register_worker({"worker_id": "w0", "model": "gpt2", "kv_blocks": 64})
    b.publish_worker_load("w0", snap(inflight_rows=2))
    workers = b.read_workers()
    assert set(workers) == {"w0"}
    info = workers["w0"]
    assert info["model"] == "gpt2" and info["kv_blocks"] == 64
    assert info["inflight_rows"] == 2 and info["state"] == STATE_READY
    assert "_expires_at" not in info
    b.deregister_worker("w0")
    assert b.read_workers() == {}


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_registry_expiry_and_reregistration(kind, clock):
    b, _ = make_brokers(kind, clock, worker_ttl_s=10.0)
    b.register_worker({"worker_id": "w0", "model": "gpt2"})
    assert "w0" in b.read_workers()
    clock.advance(15.0)
    assert b.read_workers() == {}  # aged out without a refresh
    b.register_worker({"worker_id": "w0", "model": "gpt2"})
    assert "w0" in b.read_workers()
    clock.advance(6.0)
    b.publish_worker_load("w0", snap())  # a publish refreshes the TTL
    clock.advance(6.0)  # past the registration's stamp, within the refresh
    assert "w0" in b.read_workers()


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_routed_pop_priority_and_depths(kind):
    b, _ = make_brokers(kind)
    b.push_request(req(0, id="shared"))
    b.push_request_to("w0", req(1, id="routed"))
    assert b.routed_depths() == {"w0": 1}
    assert b.queue_depth() == 2  # routed backlog counts for admission
    assert b.pop_request(worker_id="w0").id == "routed"
    assert b.lease_holders() == {"w0": 1}
    assert b.pop_request(worker_id="w0").id == "shared"
    assert b.routed_depths() == {}


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_routed_class_order_and_anonymous_pops(kind):
    """A worker's routed queue drains class by class; an anonymous pop
    never sees routed work, and its lease has no holder."""
    b, _ = make_brokers(kind)
    b.push_request_to("w0", req(0, id="std"))
    b.push_request_to("w0", req(1, id="bat", slo_class="batch"))
    b.push_request_to("w0", req(2, id="int", slo_class="interactive"))
    assert b.queue_depths_by_class() == {"interactive": 1, "standard": 1,
                                         "batch": 1}
    assert b.pop_request() is None
    assert [b.pop_request(worker_id="w0").id for _ in range(3)] == [
        "int", "std", "bat"]
    b.push_request(req(3, id="anon"))
    assert b.pop_request().id == "anon"
    # In-process an anonymous lease has no holder; a Redis client keeps
    # the fleet id it adopted at its first routed pop.
    assert b.lease_holders() == ({"w0": 3} if kind == "inproc"
                                 else {"w0": 4})


# -- the routing policies --------------------------------------------------------------


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_round_robin_rotation(kind):
    b, _ = make_brokers(kind)
    fleet_of(b, "w0", "w1", "w2")
    r = Router(b, "round_robin")
    assert [r.submit(req(i)) for i in range(6)] == ["w0", "w1", "w2"] * 2
    assert b.routed_depths() == {"w0": 2, "w1": 2, "w2": 2}
    stats = r.stats()
    assert stats["routed_total"] == 6 and stats["shared_fallback"] == 0
    assert stats["routed_by_worker"] == {"w0": 2, "w1": 2, "w2": 2}


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_least_loaded_prefers_idle_then_kv_headroom(kind):
    b, _ = make_brokers(kind)
    fleet_of(b, "w0", "w1", "w2",
             w0={"inflight_rows": 3, "free_slots": 1},
             w1={"free_kv_blocks": 8, "kv_blocks_total": 16},
             w2={"free_kv_blocks": 2, "kv_blocks_total": 16})
    r = Router(b, "least_loaded")
    assert r.submit(req(0)) == "w1"  # idle, most headroom
    assert r.submit(req(1)) == "w2"  # w1's live routed depth counts
    assert r.submit(req(2)) == "w1"  # tied backlog: headroom
    assert "w0" not in r.stats()["routed_by_worker"]


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_least_loaded_skips_unroutable_states(kind):
    b, _ = make_brokers(kind)
    fleet_of(b, "w0", "w1", "w2", w0={"state": STATE_DEAD},
             w1={"state": "draining"},
             w2={"inflight_rows": 4, "free_slots": 0})
    r = Router(b, "least_loaded")
    assert r.submit(req(0)) == "w2"
    assert set(routable_workers(b)) == {"w2"}


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_prefix_affinity_snapshot_sticky_and_fallback(kind):
    b, _ = make_brokers(kind)
    pfx = [7, 7, 7, 7]
    fleet_of(b, "w0", "w1", w0={"free_kv_blocks": 64},
             w1={"prefix_hashes": [prefix_hash(pfx)]})
    r = Router(b, "prefix_affinity")
    # The resident prefix beats headroom, and stays sticky as w1 fills.
    assert [r.submit(req(i, prefix_token_ids=pfx)) for i in range(3)] == [
        "w1"] * 3
    new_pfx = [9, 9]
    assert r.submit(req(3, prefix_token_ids=new_pfx)) == "w0"
    assert r.submit(req(4, prefix_token_ids=new_pfx)) == "w0"
    before = r.stats()
    r.submit(req(5))  # no prefix: plain least-loaded, no accounting
    stats = r.stats()
    assert (stats["affinity_hits"], stats["affinity_misses"]) == (
        before["affinity_hits"], before["affinity_misses"]) == (4, 1)
    assert stats["affinity_hit_rate"] == pytest.approx(0.8)


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_shared_fallback_when_no_replicas(kind):
    b, _ = make_brokers(kind)
    r = Router(b, "least_loaded")
    fallback = req(0)
    assert r.submit(fallback) is None
    assert r.stats()["shared_fallback"] == 1
    assert b.routed_depths() == {}
    got = b.pop_request(worker_id="late-joiner")
    assert got is not None and got.id == fallback.id


def test_router_rejects_unknown_policy():
    with pytest.raises(ValueError, match="unknown policy"):
        Router(InProcBroker(), "fastest")


# -- failover ------------------------------------------------------------------------


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_failover_moves_routed_and_leased_to_survivor(kind):
    b, mk = make_brokers(kind)
    fleet_of(b, "w0", "w1")
    r = Router(b, "round_robin", failover_check_s=0.01)
    wb = mk("w0")
    r1, r2, r3 = req(0), req(1), req(2)
    assert r.submit(r1) == "w0"
    assert r.submit(r2) == "w1"
    b.push_request_to("w0", r3)
    leased = wb.pop_request(worker_id="w0")
    assert leased.id == r1.id and leased.delivery_attempts == 1
    b.publish_worker_load("w0", snap(**STALE))  # w0's heartbeat stops
    assert set(routable_workers(b)) == {"w1"}
    assert r.check_failover(force=True) == 2  # r3 routed, r1 leased
    assert b.routed_depths() == {"w1": 3}
    assert b.lease_holders() == {}
    got = {g.id: g.delivery_attempts
           for g in (b.pop_request(worker_id="w1") for _ in range(3))}
    # The routed r3 spent no delivery attempt; the leased r1 one.
    assert got == {r1.id: 2, r2.id: 1, r3.id: 1}
    assert r.stats()["failover_reroutes"] == 2
    assert b.delivery_stats()["failover_rerouted"] == 2


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_failover_orphan_routed_queue(kind, clock):
    """A routed queue whose worker aged out of the registry is evacuated."""
    b, _ = make_brokers(kind, clock, worker_ttl_s=10.0)
    b.register_worker({"worker_id": "ghost", "model": "gpt2"})
    fleet_of(b, "live")
    orphan = req(0)
    b.push_request_to("ghost", orphan)
    clock.advance(15.0)
    assert "ghost" not in b.read_workers()
    b.publish_worker_load("live", snap())
    r = Router(b, "least_loaded")
    assert r.check_failover(force=True) == 1
    assert b.routed_depths() == {"live": 1}
    assert b.pop_request(worker_id="live").id == orphan.id


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_failover_leaves_unregistered_leases_to_the_reaper(kind):
    """A lease whose holder never registered is not force-expired: the
    worker may be alive (a worker without a fleet identity)."""
    b, mk = make_brokers(kind)
    fleet_of(b, "live")
    b.push_request_to("legacy", req(0, id="held"))
    assert mk("legacy").pop_request(worker_id="legacy").id == "held"
    r = Router(b, "least_loaded")
    assert r.check_failover(force=True) == 0
    assert b.lease_holders() == {"legacy": 1}
    assert b.delivery_stats()["inflight"] == 1


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_failover_applies_terminal_dispositions(kind):
    """Force-expired leases take the normal disposition: at the attempt
    budget dead-lettered, past the deadline shed; neither is re-routed."""
    b, mk = make_brokers(kind, max_delivery_attempts=1)
    fleet_of(b, "w0")
    wb = mk("w0")
    doomed = req(0)
    late = req(1, deadline_ts=time.time() - 1.0)
    b.push_request_to("w0", doomed)
    b.push_request_to("w0", late)
    assert wb.pop_request(worker_id="w0") is not None
    assert wb.pop_request(worker_id="w0") is not None
    b.publish_worker_load("w0", snap(**STALE))
    r = Router(b, "least_loaded")
    assert r.check_failover(force=True) == 0
    assert b.dlq_depth() == 1
    dead = b.wait_response(doomed.id, timeout=1.0)
    assert dead is not None and "dead-lettered after 1" in dead.error
    shed = b.wait_response(late.id, timeout=1.0)
    assert shed is not None and "deadline" in shed.error
    assert r.stats()["failover_reroutes"] == 0
    st = b.delivery_stats()
    assert (st["dead_lettered"], st["deadline_expired"],
            st["failover_rerouted"], st["inflight"]) == (1, 1, 0, 0)


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_failover_leaves_healthy_and_draining_workers_alone(kind):
    b, _ = make_brokers(kind)
    fleet_of(b, "w0", "w1", w1={"state": "draining"})
    b.push_request_to("w0", req(0))
    b.push_request_to("w1", req(1))
    r = Router(b, "least_loaded")
    assert r.check_failover(force=True) == 0
    assert b.routed_depths() == {"w0": 1, "w1": 1}


def test_failover_check_is_time_gated(monkeypatch):
    c = Clock()
    monkeypatch.setattr(tfleet, "time", SimpleNamespace(
        monotonic=c.monotonic, time=time.time))
    b = InProcBroker()
    fleet_of(b, "w0", "w1")
    b.push_request_to("w0", req(0))
    r = Router(b, "least_loaded", failover_check_s=5.0)
    assert r.check_failover() == 0  # the first sweep: nothing to move
    b.publish_worker_load("w0", snap(**STALE))
    c.advance(1.0)
    assert r.check_failover() == 0  # inside the interval
    c.advance(5.0)
    assert r.check_failover() == 1


# -- the status surfaces ----------------------------------------------------------------


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_fleet_status_and_aggregate_health(kind):
    b, _ = make_brokers(kind)
    fleet_of(b, "w0", "w1", "w2", w1={"state": STATE_DEAD},
             w2={"heartbeat_ts": time.time() - 600.0})
    b.push_request_to("w0", req(0))
    st = fleet_status(b, Router(b, "least_loaded"))
    assert set(st["workers"]) == {"w0", "w1", "w2"} and st["ready"] == 1
    assert st["workers"]["w0"]["routable"] is True
    assert st["workers"]["w0"]["routed_queue_depth"] == 1
    assert st["workers"]["w1"]["routable"] is False
    assert st["workers"]["w1"]["health"] == STATE_DEAD
    assert st["workers"]["w2"]["health"] == "stale-heartbeat"
    assert st["router"]["policy"] == "least_loaded"
    code, body = evaluate_fleet_health(b.read_workers())
    assert code == 200 and body["ready"] == 1
    b.publish_worker_load("w0", snap(heartbeat_ts=time.time() - 600.0))
    code, body = evaluate_fleet_health(b.read_workers())
    assert code == 503 and body["status"] == "no-ready-workers"


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_producer_fleet_endpoints():
    b = InProcBroker()
    fleet_of(b, "w0", "w1", w1={"state": STATE_DEAD})
    router = Router(b, "least_loaded")
    srv = ProducerServer(b, host="127.0.0.1", port=0, router=router)
    srv.start()
    try:
        status, raw = _get(srv.port, "/health")
        body = json.loads(raw)
        assert status == 200 and body["ready"] == 1
        assert body["workers"]["w1"]["routable"] is False
        status, raw = _get(srv.port, "/fleet")
        body = json.loads(raw)
        assert status == 200 and body["ready"] == 1
        assert set(body["workers"]) == {"w0", "w1"}
        assert body["router"]["policy"] == "least_loaded"
        status, raw = _get(srv.port, "/metrics")
        fl = json.loads(raw)["fleet"]
        assert set(fl["workers"]) == {"w0", "w1"}
        assert fl["workers"]["w0"]["state"] == STATE_READY
        assert fl["router"]["routed_total"] == 0
        status, raw = _get(srv.port, "/metrics?format=prometheus")
        lines = raw.decode().splitlines()
        assert 'llmss_fleet_worker_inflight_rows{worker="w0"} 0' in lines
        b.publish_worker_load("w0", snap(state=STATE_DEAD))
        status, raw = _get(srv.port, "/health")
        assert status == 503
        assert json.loads(raw)["status"] == "no-ready-workers"
    finally:
        srv.stop()


def test_producer_routes_admitted_requests_and_sheds_without_replicas():
    """POST /generate goes through the router onto a replica's queue; with
    every registered replica dead, admission sheds with 503."""
    b = InProcBroker()
    fleet_of(b, "w0")
    router = Router(b, "round_robin")
    srv = ProducerServer(b, host="127.0.0.1", port=0, router=router,
                         timeout_s=0.2)
    srv.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
        conn.request("POST", "/generate", body=json.dumps(
            {"id": "q", "token_ids": [1, 2], "max_new_tokens": 2}))
        assert conn.getresponse().status == 504  # nobody serves w0
        conn.close()
        assert router.stats()["routed_by_worker"] == {"w0": 1}
        assert b.routed_depths() == {"w0": 1}
        b.publish_worker_load("w0", snap(state=STATE_DEAD))
        srv._state_memo_until = 0.0
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
        conn.request("POST", "/generate", body=json.dumps(
            {"id": "q2", "token_ids": [1, 2], "max_new_tokens": 2}))
        resp = conn.getresponse()
        assert resp.status == 503
        assert "no ready replica" in json.loads(resp.read())["error"]
        conn.close()
    finally:
        srv.stop()


def test_producer_metrics_unchanged_without_fleet():
    b = InProcBroker()
    srv = ProducerServer(b, host="127.0.0.1", port=0)
    srv.start()
    try:
        status, raw = _get(srv.port, "/metrics")
        assert "fleet" not in json.loads(raw)
        status, raw = _get(srv.port, "/health")
        assert status == 200 and json.loads(raw).get("worker") == "unsupervised"
    finally:
        srv.stop()


# -- the workers' fleet identity -------------------------------------------------------


def test_worker_registers_and_serves_routed_requests():
    b = InProcBroker()
    w = Worker(ScriptedEngine(), b, batch_size=2, poll_timeout_s=0.01, worker_id="w0", snapshot_interval_s=0.0)
    info = b.read_workers()["w0"]
    assert info["model"] == "ScriptedEngine"
    assert info["state"] == STATE_READY and "heartbeat_ts" in info
    first_ts = info["heartbeat_ts"]
    r = req(0)
    b.push_request_to("w0", r)
    w.run_once()
    got = b.wait_response(r.id, timeout=5.0)
    assert got is not None and not got.error
    assert got.token_ids == ScriptedEngine.expected_tokens(
        list(r.token_ids), r.max_new_tokens)
    assert b.read_workers()["w0"]["heartbeat_ts"] >= first_ts


def test_anonymous_worker_stays_out_of_registry():
    b = InProcBroker()
    w = Worker(ScriptedEngine(), b, batch_size=2, poll_timeout_s=0.01)
    assert b.read_workers() == {}
    r = req(0)
    b.push_request(r)
    w.run_once()
    assert b.wait_response(r.id, timeout=5.0) is not None
    assert b.read_workers() == {}


def test_capabilities_and_snapshot_keys_equal_the_reference():
    """The registration payload and the batch worker's heartbeat carry the
    reference's keys, the windowed series and the devtel blob included
    (whose contents the telemetry tests hold)."""
    assert tconsumer.worker_capabilities("w0", ScriptedEngine()) == \
        rconsumer.worker_capabilities("w0", rchaos.ScriptedEngine())
    tw = Worker(ScriptedEngine(), InProcBroker(), batch_size=2,
                worker_id="w0")
    rw = rconsumer.Worker(rchaos.ScriptedEngine(), rbroker.InProcBroker(),
                          batch_size=2, worker_id="w0")
    want = set(rw.load_snapshot())
    assert set(tw.load_snapshot()) == want
    blobs = ("heartbeat_ts", "trace", "series", "devtel")
    assert {k: v for k, v in tw.load_snapshot().items()
            if k not in blobs} == {
        k: v for k, v in rw.load_snapshot().items() if k not in blobs}


CFG = dict(model_type="llama", vocab_size=128, hidden_size=64, n_layers=2,
           n_heads=4, n_kv_heads=2, head_dim=16, intermediate_size=96,
           max_position_embeddings=96, activation="silu", norm="rmsnorm",
           mlp="swiglu", positions="rotary", rope_style="half",
           attn_bias=False, mlp_bias=False, dtype="float32")
PAGED = dict(max_seq_len=96, kv_layout="paged", block_size=16, kv_blocks=40)


@pytest.fixture(scope="module")
def model():
    mesh = make_mesh(MeshPlan(dp=1, tp=1), devices=jax.devices()[:1])
    jp = jdec.init_params(JCfg(**CFG), mesh, jax.random.key(0))
    return mesh, jp, params_from_jax(jax.device_get(jp))


def test_scheduler_load_snapshot_is_host_only(model):
    """The continuous worker's heartbeat reads host state only: with rows
    active and a prefix registered, no tensor is read back."""
    _, _, tp = model
    eng = TEngine(TCfg(**CFG), tp, device="cpu", **PAGED)
    b = InProcBroker()
    w = ContinuousWorker(eng, b, rows=2, chunk_steps=2, poll_timeout_s=0.0,
                         worker_id="w0")
    pfx = list(range(1, 19))
    for i in range(3):
        b.push_request(GenerateRequest(token_ids=pfx + [30 + i],
                                       max_new_tokens=8,
                                       prefix_token_ids=list(pfx)))
    w.run_once()

    def refuse(*a, **k):
        raise AssertionError("load_snapshot read a tensor")

    patches = ("item", "tolist", "cpu", "numpy", "__array__", "__bool__")
    saved = {n: getattr(torch.Tensor, n) for n in patches}
    try:
        for n in patches:
            setattr(torch.Tensor, n, refuse)
        s = w.load_snapshot()
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)
    assert (s["rows"], s["inflight_rows"], s["pending"], s["free_slots"]) == (
        2, 2, 1, 0)
    assert s["kv_blocks_total"] == 40 and s["free_kv_blocks"] < 40
    assert s["prefix_hashes"] == [prefix_hash(pfx)]
    assert s["heartbeat_s"] == 1.0 and "trace" in s


# -- the role split over the fleet -------------------------------------------------------


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_router_excludes_decode_replicas_from_raw_requests(kind):
    b, _ = make_brokers(kind)
    fleet_of(b, "w0", "d0", w0={"inflight_rows": 3, "free_slots": 1},
             d0={"role": "decode"})
    r = Router(b, "least_loaded")
    assert r.submit(req(0)) == "w0"
    assert r.submit(req(1)) == "w0"
    assert "d0" not in r.stats()["routed_by_worker"]
    b2, _ = make_brokers(kind)
    fleet_of(b2, "d0", d0={"role": "decode"})
    r2 = Router(b2, "least_loaded")
    assert r2.submit(req(2)) is None
    assert r2.stats()["shared_fallback"] == 1
    assert b2.routed_depths() == {}


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_fleet_status_shows_roles_and_handoff_depths(kind):
    b, mk = make_brokers(kind)
    fleet_of(b, "p0", "d0", p0={"role": "prefill"}, d0={"role": "decode"})
    routed, shared = hrec(0), hrec(1)
    b.push_handoff_to("d0", routed)
    b.push_handoff(shared)
    st = fleet_status(b, Router(b, "least_loaded"))
    assert st["workers"]["p0"]["role"] == "prefill"
    assert st["workers"]["d0"]["role"] == "decode"
    assert st["workers"]["d0"]["routed_handoff_depth"] == 1
    assert st["workers"]["d0"]["handoff_leases_held"] == 0
    assert st["handoff_depth"] == 2
    got = mk("d0").pop_handoff(timeout=0.5, worker_id="d0")
    assert got is not None and got.req.id == routed.req.id
    st = fleet_status(b, None)
    assert st["workers"]["d0"]["routed_handoff_depth"] == 0
    assert st["workers"]["d0"]["handoff_leases_held"] == 1
    assert st["handoff_depth"] == 1


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_failover_reroutes_handoffs_to_surviving_decode(kind):
    b, mk = make_brokers(kind)
    fleet_of(b, "p0", "d0", "d1", p0={"role": "prefill"},
             d0={"role": "decode"}, d1={"role": "decode"})
    b.push_handoff_to("d0", hrec(0, id="adopted"))
    got = mk("d0").pop_handoff(timeout=0.5, worker_id="d0")
    assert got is not None and got.req.id == "adopted"
    b.push_handoff_to("d0", hrec(1, id="routed"))
    b.publish_worker_load("d0", snap(role="decode", **STALE))
    r = Router(b, "least_loaded", failover_check_s=0.01)
    assert r.check_failover(force=True) == 1  # the intact routed record
    assert b.handoff_depths() == {"d1": 1}
    moved = mk("d1").pop_handoff(timeout=0.5, worker_id="d1")
    assert moved is not None and moved.req.id == "routed"
    back = b.pop_request(timeout=0.5)  # the adopted one prefills again
    assert back is not None and back.id == "adopted"
    assert b.delivery_stats()["reprefills"] == 1
    assert r.stats()["handoff_reroutes"] == 1


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_routed_handoff_targets_one_decode_worker(kind):
    b, mk = make_brokers(kind)
    b.push_handoff_to("d1", hrec(0, id="h0"))
    assert b.handoff_depths() == {"d1": 1} and b.handoff_depth() == 1
    assert mk("d0").pop_handoff(timeout=0.01, worker_id="d0") is None
    got = mk("d1").pop_handoff(timeout=0.5, worker_id="d1")
    assert got is not None and got.req.id == "h0"
    assert b.handoff_depths() == {}


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_failover_handoffs_splits_routed_from_leased(kind):
    b, mk = make_brokers(kind)
    b.push_handoff(hrec(0, id="h0"))
    got = mk("d0").pop_handoff(timeout=0.5, worker_id="d0")
    assert got is not None and got.req.id == "h0"
    b.push_handoff_to("d0", hrec(1, id="h1"))
    b.push_handoff_to("d0", hrec(2, id="h2"))
    assert b.handoff_depths() == {"d0": 2}
    assert b.handoff_holders() == {"d0": 1}
    moved = b.failover_handoffs("d0")
    assert sorted(m.req.id for m in moved) == ["h1", "h2"]
    back = b.pop_request(timeout=0.5)
    assert back is not None and back.id == "h0"  # prefilled again
    assert b.delivery_stats()["reprefills"] == 1
    assert b.handoff_depths() == {} and b.handoff_holders() == {}


def test_producer_surfaces_roles_and_handoff_metrics():
    b = InProcBroker()
    fleet_of(b, "p0", "d0", p0={"role": "prefill"}, d0={"role": "decode"})
    b.push_handoff_to("d0", hrec(0))
    srv = ProducerServer(b, host="127.0.0.1", port=0,
                         router=Router(b, "least_loaded"))
    srv.start()
    try:
        status, raw = _get(srv.port, "/fleet")
        body = json.loads(raw)
        assert status == 200
        assert body["workers"]["p0"]["role"] == "prefill"
        assert body["workers"]["d0"]["routed_handoff_depth"] == 1
        assert body["handoff_depth"] == 1
        status, raw = _get(srv.port, "/metrics")
        body = json.loads(raw)
        fl = body["fleet"]
        assert fl["workers"]["d0"]["role"] == "decode"
        assert fl["handoff_depth"] == 1 and fl["handoff_depths"] == {"d0": 1}
        assert body["delivery"]["handoffs"] == 1
    finally:
        srv.stop()


# -- the fleet under a hard kill ---------------------------------------------------------


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_fleet_chaos_kill_mid_decode(kind):
    """Three replicas on their own threads; one is hard-killed mid-decode
    while it holds routed and leased work and never comes back. Every
    request is answered exactly once with its payload."""
    producer, mk = make_brokers(kind, lease_s=0.25, max_delivery_attempts=6)
    wids = ["w0", "w1", "w2"]
    switches = {wid: threading.Event() for wid in wids}

    def make_worker(wid):
        return Worker(ScriptedEngine(kill_switch=switches[wid],
                                     chunk_delay_s=0.002),
                      mk(wid), batch_size=2, poll_timeout_s=0.02, worker_id=wid, snapshot_interval_s=0.04)

    router = Router(producer, "least_loaded", stale_factor=10.0,
                    failover_check_s=0.05)
    reqs = [req(i) for i in range(18)]
    stop_pump = threading.Event()

    def pump():
        while not stop_pump.is_set():
            router.check_failover(force=True)
            time.sleep(0.05)

    harness = FleetHarness(make_worker, wids, respawn=False)
    switches["w0"].set()
    pump_t = threading.Thread(target=pump, daemon=True)
    with harness:
        deadline = time.monotonic() + 10.0
        while len(router.routable_workers()) < 3:
            assert time.monotonic() < deadline, "fleet never became ready"
            time.sleep(0.01)
        for r in reqs[:12]:
            router.submit(r)
        deadline = time.monotonic() + 10.0
        while harness.hosts["w0"].kills < 1:
            assert time.monotonic() < deadline, "kill switch never fired"
            time.sleep(0.01)
        stranded = reqs[12:15]
        for r in stranded:
            producer.push_request_to("w0", r)
        for r in reqs[15:]:
            router.submit(r)
        pump_t.start()
        try:
            results = collect_responses(producer, reqs, timeout_s=60.0)
        finally:
            stop_pump.set()
            pump_t.join(timeout=5)
    assert not [h.error for h in harness.hosts.values() if h.error]
    assert harness.hosts["w0"].kills == 1 and harness.hosts["w0"].spawns == 1
    assert audit_exactly_once(reqs, results) == len(reqs)
    assert router.stats()["failover_reroutes"] >= len(stranded)
    assert producer.delivery_stats()["failover_rerouted"] >= len(stranded)
    assert "w0" not in router.routable_workers()


# -- the supervisor's registry view ------------------------------------------------------


def test_supervised_worker_entry_reads_draining_then_dead():
    """A supervised fleet member's entry carries the supervisor's state; a
    drain of the last routable replica is refused (``drain_blocked``)
    until forced, and the entry ends ``dead``."""
    from llmss_tpu_torch.serve.supervisor import Supervisor

    b = InProcBroker()
    sup = Supervisor(lambda: Worker(ScriptedEngine(), b, batch_size=2,
                                    poll_timeout_s=0.01,
                                    worker_id="w0"),
                     b, heartbeat_s=0.05, drain_timeout_s=5.0)
    stop = threading.Event()
    t = threading.Thread(target=sup.run, args=(stop,), daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 10
        while "w0" not in routable_workers(b) or sup._worker is None:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert sup.drain() is False
        assert "last routable" in b.read_workers()["w0"]["drain_blocked"]
        assert b.read_workers()["w0"]["state"] == STATE_READY
        fleet_of(b, "w1")  # another routable replica: the guard lifts
        assert sup.drain() is True
        t.join(timeout=10)
        assert not t.is_alive()
    finally:
        stop.set()
        t.join(timeout=10)
    info = b.read_workers()["w0"]
    assert info["state"] == STATE_DEAD and info["alive"] is False
    assert Router(b, "least_loaded").routable_workers().keys() == {"w1"}


# -- same schedule, same decisions ------------------------------------------------------


def _schedule(bmod, fmod, pmod, policy):
    """One schedule of registrations, snapshots, submits, leases and deaths
    through one package's broker and Router; returns every observable
    decision."""
    b = bmod.InProcBroker(max_delivery_attempts=2)
    now = time.time()

    def publish(wid, **over):
        s = {"state": "ready", "alive": True, "rows": 4, "inflight_rows": 0,
             "queue_depth": 0, "free_slots": 4, "free_kv_blocks": 32,
             "kv_blocks_total": 32, "prefix_hashes": [], "heartbeat_s": 5.0,
             "heartbeat_ts": now}
        s.update(over)
        b.publish_worker_load(wid, s)

    for wid in ("w0", "w1", "w2"):
        b.register_worker({"worker_id": wid, "model": "llama"})
        publish(wid)
    b.register_worker({"worker_id": "d0", "model": "llama", "role": "decode"})
    publish("d0", role="decode")
    publish("w2", free_kv_blocks=20,
            prefix_hashes=[pmod.prefix_hash([5, 5, 5])])
    r = fmod.Router(b, policy, failover_check_s=1000.0)
    prefixes = ([1, 2, 3], [4, 4], [5, 5, 5], None)
    classes = ("standard", "interactive", "batch")

    def mkreq(i):
        p = prefixes[i % 4]
        toks = list(p or []) + [20 + i]
        return pmod.GenerateRequest(
            id=f"r{i}", token_ids=toks, max_new_tokens=4,
            prefix_token_ids=list(p) if p else None,
            slo_class=classes[i % 3], deadline_ts=now + 600)

    out = {"picks": [r.submit(mkreq(i)) for i in range(10)]}
    publish("w1", inflight_rows=3, queue_depth=2, free_kv_blocks=4)
    # w0 leases two of its routed requests.
    out["leased"] = [b.pop_request(worker_id="w0").id for _ in range(2)]
    out["picks"] += [r.submit(mkreq(i)) for i in range(10, 16)]
    out["depths_before"] = b.routed_depths()
    publish("w2", state="dead")
    out["failover_dead"] = r.check_failover(force=True)
    publish("w0", heartbeat_ts=0.0)
    out["failover_stale"] = r.check_failover(force=True)
    out["picks"] += [r.submit(mkreq(i)) for i in range(16, 20)]
    out["depths_after"] = b.routed_depths()
    out["holders"] = b.lease_holders()
    out["stats"] = r.stats()
    d = b.delivery_stats()
    out["delivery"] = {k: d[k] for k in ("queue_depth", "inflight",
                                         "failover_rerouted", "redelivered")}
    out["order_w1"] = []
    while (q := b.pop_request(worker_id="w1")) is not None:
        out["order_w1"].append((q.id, q.delivery_attempts))
    return out


@pytest.mark.parametrize("policy", Router.POLICIES)
def test_same_schedule_same_decisions(policy):
    want = _schedule(rbroker, rfleet, rproto, policy)
    got = _schedule(tbroker, tfleet, tproto, policy)
    assert got == want
    assert got["failover_dead"] + got["failover_stale"] > 0
    assert "d0" not in got["stats"]["routed_by_worker"]


# -- one wire ------------------------------------------------------------------------


@pytest.mark.parametrize("direction", ("port_worker", "reference_worker"))
def test_fleet_shares_one_redis_between_packages(direction):
    """One package's worker registers and is served through the other's
    Router and broker on one FakeRedis: the registry entry is read, the
    routed queue popped, the answer read back; a stale worker's routed
    and leased requests are failed over by the other package onto a
    survivor."""
    server = rchaos.FakeRedis()
    if direction == "port_worker":
        wb, wchaos, wcons = tbroker, tchaos, tconsumer
        fb, ff, fp = rbroker, rfleet, rproto
    else:
        wb, wchaos, wcons = rbroker, rchaos, rconsumer
        fb, ff, fp = tbroker, tfleet, tproto

    def worker(wid):
        return wcons.Worker(wchaos.ScriptedEngine(),
                            wb.RedisBroker(client=server, worker_id=wid),
                            batch_size=2, poll_timeout_s=0.0,
                            worker_id=wid, snapshot_interval_s=5.0)

    a, c = worker("a"), worker("c")
    front = fb.RedisBroker(client=server, worker_id="front")
    router = ff.Router(front, "round_robin")
    assert set(ff.routable_workers(front)) == {"a", "c"}
    assert front.read_workers()["a"]["model"] == "ScriptedEngine"
    reqs = [fp.GenerateRequest(id=f"q{i}", token_ids=[i + 1, 7],
                               max_new_tokens=3,
                               slo_class=("standard", "interactive")[i % 2])
            for i in range(4)]
    assert [router.submit(q) for q in reqs] == ["a", "c", "a", "c"]
    keys = {k.decode() for k in server.scan_iter("pqueue:w:*")}
    assert keys == {"pqueue:w:a", "pqueue:w:c:cls:interactive"}
    a.run_once()
    c.run_once()
    for q in reqs:
        got = front.wait_response(q.id, timeout=5.0)
        assert got.error is None and got.token_ids == \
            tchaos.ScriptedEngine.expected_tokens(list(q.token_ids), 3)
    # a leases one request and dies holding it, with one more routed.
    held, queued = (fp.GenerateRequest(id=f"f{i}", token_ids=[9, i],
                                       max_new_tokens=3) for i in range(2))
    front.push_request_to("a", held)
    assert a.broker.pop_request(worker_id="a").id == "f0"
    front.push_request_to("a", queued)
    assert front.lease_holders() == {"a": 1}
    a.broker.publish_worker_load("a", {"heartbeat_ts": 0.0})
    assert router.check_failover(force=True) == 2
    assert front.routed_depths() == {"c": 2}
    c.run_once()
    for q in (held, queued):
        assert front.wait_response(q.id, timeout=5.0).token_ids == \
            tchaos.ScriptedEngine.expected_tokens(list(q.token_ids), 3)
    st = front.delivery_stats()
    assert (st["failover_rerouted"], st["inflight"], st["queue_depth"]) == (
        2, 0, 0)


# -- tokens: a port fleet against the JAX worker -------------------------------------------

SYSTEM = 20  # shared prompt tokens (one full block of 16)
NEW = 6


def _fleet_traffic(proto):
    """The serve_fleet order at tiny size: four system prompts, p0 p0 p1 p1
    p2 p2 p3 p3 twice, each with its own 2-6 token suffix, greedy."""
    systems = [[(7 * s + 3 * j) % 120 + 1 for j in range(SYSTEM)]
               for s in range(4)]
    order = [0, 0, 1, 1, 2, 2, 3, 3] * 2
    return [proto.GenerateRequest(
        id=f"f{i}", token_ids=systems[s] + [(11 * i + j) % 120 + 1
                                            for j in range(2 + i % 5)],
        max_new_tokens=NEW, prefix_token_ids=list(systems[s]))
        for i, s in enumerate(order)]


ADMISSION = {"split": None, "chunked": 8}


@pytest.fixture
def one_thread():
    """Tiny CPU matmuls run fastest on one thread; under a parallel test
    run, more threads mostly contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_answers(model):
    """The JAX package's ContinuousWorker's tokens for the traffic, split
    and chunked."""
    mesh, jp, _ = model
    out = {}
    for name, cp in ADMISSION.items():
        eng = JEngine(JCfg(**CFG), jp, mesh, **PAGED)
        b = rbroker.InProcBroker()
        w = rconsumer.ContinuousWorker(eng, b, rows=4, chunk_steps=4,
                                       poll_timeout_s=0.0, chunked_prefill=cp)
        reqs = _fleet_traffic(rproto)
        for r in reqs:
            b.push_request(r)
        got = {}
        while len(got) < len(reqs):
            w.run_once()
            for r in reqs:
                a = b.wait_response(r.id, timeout=0.0) if r.id not in got \
                    else None
                if a is not None:
                    got[r.id] = a.token_ids
        out[name] = got
    return out


def _port_fleet(tp, policy, chunked, kill):
    """Two port ContinuousWorkers, each on its own engine over ``tp``,
    under a Router: the traffic submitted at once; with ``kill``, w0 is
    driven for one group and then never again, its heartbeat stale."""
    b = InProcBroker()
    workers, builds = {}, {}
    for wid in ("w0", "w1"):
        eng = TEngine(TCfg(**CFG), tp, device="cpu", **PAGED)
        builds[wid] = []
        build = eng.build_prefix
        eng.build_prefix = (lambda ids, build=build, n=builds[wid]:
                            n.append(len(ids)) or build(ids))
        workers[wid] = ContinuousWorker(
            eng, b, rows=4, chunk_steps=4, poll_timeout_s=0.0,
            chunked_prefill=ADMISSION[chunked], worker_id=wid)
    router = Router(b, policy, stale_factor=1e9)
    reqs = _fleet_traffic(tproto)
    picks = [router.submit(r) for r in reqs]
    live = dict(workers)
    if kill:
        workers["w0"].run_once()
        del live["w0"]
        b.publish_worker_load("w0", {"heartbeat_ts": 0.0})
        router.check_failover(force=True)
    got = {}
    for _ in range(500):
        for w in live.values():
            w.run_once()
        for r in reqs:
            if r.id not in got:
                a = b.wait_response(r.id, timeout=0.0)
                if a is not None:
                    assert a.error is None, a.error
                    got[r.id] = a.token_ids
        if len(got) == len(reqs):
            break
    assert len(got) == len(reqs)
    assert all(b.wait_response(r.id, timeout=0.0) is None for r in reqs)
    st = b.delivery_stats()
    assert (st["inflight"], st["queue_depth"], st["dead_lettered"]) == (
        0, 0, 0)
    for w in live.values():
        assert w.batcher.allocator.blocks_in_use == sum(
            len(blk) for _, blk in w.batcher._paged_prefixes.values())
    return got, picks, {w: len(n) for w, n in builds.items()}, router.stats()


@pytest.mark.parametrize("policy", Router.POLICIES)
def test_port_fleet_tokens_equal_jax_worker(model, jax_answers, policy,
                                            one_thread):
    _, _, tp = model
    got, picks, builds, stats = _port_fleet(tp, policy, "split", kill=False)
    assert got == jax_answers["split"]
    if policy == "prefix_affinity":  # p0 and p2 on w0, p1 and p3 on w1
        assert picks == ["w0", "w0", "w1", "w1"] * 4
    else:
        assert picks == ["w0", "w1"] * 8
    assert sum(builds.values()) == (4 if policy == "prefix_affinity" else 8)
    assert stats["routed_by_worker"] == {"w0": 8, "w1": 8}
    if policy == "prefix_affinity":
        assert (stats["affinity_hits"], stats["affinity_misses"]) == (12, 4)


@pytest.mark.parametrize("policy", ("prefix_affinity", "round_robin"))
def test_port_fleet_chunked_and_killed_tokens_equal_jax_worker(
        model, jax_answers, policy, one_thread):
    """Chunked admission, and w0 dying after its first group: w1 serves
    w0's leased and routed requests with the same tokens."""
    _, _, tp = model
    got, _, builds, stats = _port_fleet(tp, policy, "chunked", kill=True)
    assert got == jax_answers["chunked"]
    assert stats["failover_reroutes"] == 8
    # w1 builds the prefixes w0 owned as well.
    assert builds["w1"] == 4 and builds["w0"] == (2 if policy ==
                                                   "prefix_affinity" else 4)


# -- the brownout ladder and its input (pure; wired in a later slice) ----------------------


def _ladder(fmod, burns, escalate=None, **kw):
    """Drive a ladder through ``burns`` (one tick a second, explicit
    clock); returns the rungs and the final state without its clock."""
    burn = [0.0]
    ctrl = fmod.BrownoutController(lambda: burn[0], check_s=0.0,
                                   escalate_ok=escalate, **kw)
    rungs = []
    for t, b in enumerate(burns, start=1):
        burn[0] = b
        rungs.append(ctrl.tick(now=float(t)))
    st = ctrl.state()
    for tr in st["recent_transitions"]:
        tr.pop("at_s")
    return rungs, st


@pytest.mark.parametrize("escalate", (None, "every_other"))
def test_brownout_ladder_equals_reference(escalate):
    """Climbs one rung per hot check, clamps, holds between the
    thresholds, descends after the dwell, and (with ``escalate_ok``)
    suppresses climbs the scaler can still absorb: rung for rung as the
    reference's."""
    burns = [9, 9, 9, 9, 1.5, 1.5, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 3, 0.2]

    def gate():
        n = [0]

        def ok():
            n[0] += 1
            return n[0] % 2 == 0
        return ok if escalate else None

    kw = dict(high=2.0, low=1.0, dwell_s=2.0)
    want = _ladder(rfleet, burns, gate(), **kw)
    got = _ladder(tfleet, burns, gate(), **kw)
    assert got == want
    assert max(got[0]) == (2 if escalate else 3) and got[0][-1] < 2
    assert (got[1]["suppressed_escalations"] > 0) == bool(escalate)


def test_brownout_admit_and_interactive_burn_equal_reference():
    """Each rung's admission verdicts (batch capped, then shed, then
    standard shed; interactive always admitted) and ``interactive_burn``
    on SLO payloads equal the reference's."""
    def admits(fmod, pmod, rung):
        ctrl = fmod.BrownoutController(lambda: 99.0, check_s=1e9,
                                       batch_max_new_cap=64, retry_after_s=3)
        for i in range(rung):
            ctrl.tick(now=(i + 1) * 4e9)
        out = []
        for cls in ("interactive", "standard", "batch"):
            r = pmod.GenerateRequest(token_ids=[1], max_new_tokens=500,
                                     slo_class=cls)
            out.append((ctrl.admit(r), r.max_new_tokens))
        return out

    for rung in range(4):
        assert admits(tfleet, tproto, rung) == admits(rfleet, rproto, rung)
    payloads = [
        {"objectives": [
            {"name": "e2e_p95_5s", "windows": {
                "5m": {"burn_rate": 50.0, "count": 9}}},
            {"name": "ttft_p95_500ms", "windows": {
                "5m": {"burn_rate": 1.0, "count": 9}}},
            {"name": "ttft_p95_500ms_interactive", "windows": {
                "5m": {"burn_rate": 4.0, "count": 3},
                "1h": {"burn_rate": 2.0, "count": 3}}}]},
        {"objectives": [{"name": "ttft_p95_500ms_interactive", "windows": {
            "5m": {"burn_rate": None, "count": 0}}}]},
        {"objectives": [{"name": "ttft_p95_500ms", "windows": {
            "5m": {"burn_rate": 1.5, "count": 2}}}]},
        {}]
    got = [tfleet.interactive_burn(p) for p in payloads]
    assert got == [rfleet.interactive_burn(p) for p in payloads] == [
        4.0, 0.0, 1.5, 0.0]
    with pytest.raises(ValueError, match="high > low"):
        tfleet.BrownoutController(lambda: 0.0, high=1.0, low=1.0)
