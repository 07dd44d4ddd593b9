"""The torch port's chaos harness (``serve/chaos.py``) and model-free role
loops (``serve/handoff.py``'s ``PrefillWorker`` / ``DecodeWorker``) against
the JAX package's, on the CPU.

The reference's ``tests/test_chaos.py`` cases and the role-loop cases of
``tests/test_handoff.py`` run against the port's modules: workers are
hard-killed mid-batch (``HardKill`` escapes every containment layer, as a
SIGKILL would), responses are dropped, a poison request resets whichever
worker takes it, and a prefill replica dies between its export and its
push. Their assertion is the delivery contract, which does not depend on
timing: every request gets exactly one terminal answer, with the
scripted payload when it succeeds. ``ScriptedEngine``, ``ChaosBroker``'s
seeded schedule and ``FakeRedis`` are held to the reference's
operation by operation.
"""

import http.client
import json
import threading
import time

import pytest

import llmss_tpu.serve.chaos as rchaos
import llmss_tpu_torch.serve.chaos as tchaos
from llmss_tpu.engine import GenerationParams as JGen
from llmss_tpu.sim.invariants import audit_exactly_once, collect_responses
from llmss_tpu_torch.engine.engine import GenerationParams
from llmss_tpu_torch.serve.broker import InProcBroker, RedisBroker
from llmss_tpu_torch.serve.chaos import (
    NAN_TOKEN, POISON_TOKEN, ChaosBroker, ChaosWorkerHost, FakeRedis,
    HardKill, ScriptedEngine,
)
from llmss_tpu_torch.serve.consumer import Worker
from llmss_tpu_torch.serve.handoff import DecodeWorker, PrefillWorker
from llmss_tpu_torch.serve.producer import ProducerServer
from llmss_tpu_torch.serve.protocol import GenerateRequest

BROKER_KINDS = ("inproc", "fakeredis")


def make_brokers(kind, **kw):
    """(the producer's broker, make_worker_broker(worker_id))."""
    if kind == "inproc":
        b = InProcBroker(**kw)
        return b, (lambda wid: b)
    server = FakeRedis()

    def mk(wid):
        return RedisBroker(client=server, worker_id=wid, **kw)

    return mk("producer"), mk


def _run_fleet(make_worker_broker, producer_broker, n_requests=24,
               n_workers=2, seed=0):
    """A kill-heavy run: every request is still answered exactly once."""
    reqs = [GenerateRequest(token_ids=[i + 1], max_new_tokens=4,
                            deadline_ts=time.time() + 60.0)
            for i in range(n_requests)]
    hosts = []
    for i in range(n_workers):
        chaos = ChaosBroker(make_worker_broker(i), seed=seed + i,
                            kill_after_pop_prob=0.15, drop_response_prob=0.1)

        def factory(chaos=chaos):
            return Worker(ScriptedEngine(), chaos, batch_size=2,
                          poll_timeout_s=0.02)

        hosts.append(ChaosWorkerHost(factory, respawn_delay_s=0.01))
    for r in reqs:
        producer_broker.push_request(r)
    for h in hosts:
        h.start()
    try:
        results = collect_responses(producer_broker, reqs, timeout_s=60.0)
    finally:
        for h in hosts:
            h.stop()
    assert not [h.error for h in hosts if h.error]
    # Dead-letters after repeated kills are terminal answers too, but
    # chaos at these rates must not wipe out the run.
    assert audit_exactly_once(reqs, results) >= n_requests // 2
    assert sum(h.kills for h in hosts) > 0, "the chaos schedule never fired"
    return hosts


def test_chaos_inproc_every_request_answered_once():
    b = InProcBroker(lease_s=0.15, max_delivery_attempts=6)
    _run_fleet(lambda i: b, b)


def test_chaos_fakeredis_every_request_answered_once():
    server = FakeRedis()

    def mk(i):
        return RedisBroker(client=server, worker_id=f"w{i}", lease_s=0.15,
                           max_delivery_attempts=6)

    _run_fleet(mk, RedisBroker(client=server, worker_id="producer",
                               lease_s=0.15, max_delivery_attempts=6))


def test_poison_request_lands_in_dlq_fleet_stays_healthy():
    """A request that crashes whichever worker takes it is dead-lettered
    after ``max_delivery_attempts`` kills; the other requests are served
    and /health stays 200."""
    b = InProcBroker(lease_s=0.1, max_delivery_attempts=3)

    def factory():
        return Worker(ScriptedEngine(kill_on_poison=True), b, batch_size=1,
                      poll_timeout_s=0.02)

    host = ChaosWorkerHost(factory, respawn_delay_s=0.01)
    poison = GenerateRequest(id="poison", token_ids=[POISON_TOKEN],
                             max_new_tokens=4, deadline_ts=time.time() + 60.0)
    normals = [GenerateRequest(id=f"n{i}", token_ids=[i + 1],
                               max_new_tokens=4,
                               deadline_ts=time.time() + 60.0)
               for i in range(4)]
    for r in [poison] + normals:
        b.push_request(r)
    srv = ProducerServer(b, host="127.0.0.1", port=0)
    srv.start()
    host.start()
    try:
        results = collect_responses(b, [poison] + normals, timeout_s=30.0)
    finally:
        host.stop()
    try:
        assert host.error is None
        assert host.kills == 3 and host.spawns >= 4
        presp = results["poison"]
        assert presp not in (None, "DUPLICATE")
        assert "dead-lettered after 3" in presp.error
        assert b.dlq_depth() == 1 and b.read_dlq()[0]["id"] == "poison"
        for r in normals:
            got = results[r.id]
            assert got not in (None, "DUPLICATE") and not got.error
            assert got.token_ids == ScriptedEngine.expected_tokens(
                list(r.token_ids), r.max_new_tokens)
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
        conn.request("GET", "/health")
        assert conn.getresponse().status == 200
        conn.request("GET", "/dlq")
        resp = conn.getresponse()
        assert resp.status == 200 and json.loads(resp.read())["depth"] == 1
        conn.close()
    finally:
        srv.stop()


def test_hardkill_escapes_worker_containment():
    """The batch worker's ``except Exception`` does not catch a HardKill:
    no answer, and the lease stays out."""
    b = InProcBroker(lease_s=5.0)
    w = Worker(ScriptedEngine(kill_on_poison=True), b, batch_size=1,
               poll_timeout_s=0.02)
    b.push_request(GenerateRequest(id="poison", token_ids=[POISON_TOKEN],
                                   max_new_tokens=2))
    with pytest.raises(HardKill):
        w.run_once()
    assert b.wait_response("poison", timeout=0.05) is None
    assert b.delivery_stats()["inflight"] == 1


def test_poisoned_row_answers_alone():
    """A NaN-poisoned row is answered with the poison error while its
    batch-mates keep their payloads (the batch worker's row isolation)."""
    b = InProcBroker()
    w = Worker(ScriptedEngine(nan_at=1), b, batch_size=3, poll_timeout_s=0.0)
    reqs = [GenerateRequest(id=f"r{i}", token_ids=t, max_new_tokens=3)
            for i, t in enumerate(([5], [NAN_TOKEN, 6], [7]))]
    for r in reqs:
        b.push_request(r)
    w.run_once()
    got = [b.wait_response(r.id, timeout=1.0) for r in reqs]
    assert "non-finite" in got[1].error
    assert [g.token_ids for g in (got[0], got[2])] == [[6, 7, 8], [8, 9, 10]]


# -- the harness's pieces against the reference's ----------------------------------------


def test_scripted_engine_equals_reference():
    """Same calls, same answers: generate's outputs, increments, cancel
    polls and poisoned rows, and the role protocol's payloads."""
    def drive(mod, G):
        eng = mod.ScriptedEngine(nan_at=2)
        calls = []
        prompts = [[1, 2], [NAN_TOKEN, 3], [9], [0]]
        gens = [G(max_new_tokens=n) for n in (5, 3, 9, 1)]
        outs = []
        for _ in range(2):
            outs.append(eng.generate(
                prompts, gens, cancel_poll=lambda: calls.append("poll"),
                on_increment=lambda row, inc: calls.append((row, inc)),
                on_poisoned=lambda row: calls.append(("poisoned", row)),
                chunk_steps=4, live_rows=3))
        first, payload = eng.prefill_export([4, 5, 6], 5)
        toks = eng.adopt_generate(payload, 5, first, 3,
                                  on_increment=lambda: calls.append("inc"))
        with pytest.raises(ValueError):
            eng.adopt_generate(payload, 5, first + 1, 3)
        return (outs, calls, first, payload, toks, eng.generate_calls,
                eng.metrics.to_dict()["requests_served"])

    assert drive(tchaos, GenerationParams) == drive(rchaos, JGen)


def test_chaos_broker_schedule_equals_reference():
    """One seed, one fault schedule: the same pops are dropped, the same
    responses lost and the same leases end in a kill."""
    def drive(cmod, bmod, pmod):
        b = bmod.InProcBroker(lease_s=60.0)
        cb = cmod.ChaosBroker(b, seed=7, kill_after_pop_prob=0.3,
                              drop_response_prob=0.3, pop_fail_prob=0.2)
        trail = []
        for i in range(30):
            b.push_request(pmod.GenerateRequest(id=f"r{i}", token_ids=[i]))
        for _ in range(30):
            try:
                r = cb.pop_request()
            except cmod.HardKill:
                trail.append("kill")
                continue
            if r is None:
                trail.append("none")
                continue
            cb.push_response(pmod.GenerateResponse(id=r.id, token_ids=[1]))
            trail.append(r.id)
        return trail, cb.faults, b.delivery_stats()["inflight"]

    import llmss_tpu.serve.broker as rbroker
    import llmss_tpu.serve.protocol as rproto
    import llmss_tpu_torch.serve.broker as tbroker
    import llmss_tpu_torch.serve.protocol as tproto

    want = drive(rchaos, rbroker, rproto)
    assert drive(tchaos, tbroker, tproto) == want
    assert want[1]["kills"] and want[1]["dropped_responses"]


def test_chaos_broker_partition_raises_connection_error():
    cb = ChaosBroker(InProcBroker())
    cb.partition_for(60.0)
    with pytest.raises(ConnectionError):
        cb.pop_request()
    assert cb.faults["partition_errors"] == 1
    assert cb.queue_depth() == 0  # everything else goes to the broker


def test_fake_redis_equals_reference():
    """The port's FakeRedis and the reference's leave the same data after
    the same commands, and answer them alike."""
    def drive(mod):
        r = mod.FakeRedis()
        out = [r.set("a", 1), r.get("a"), r.incr("n", 5), r.incr("n"),
               r.lpush("l", "x", "y"), r.rpush("l", "z"), r.llen("l"),
               r.lrange("l", 0, -1), r.rpop("l"), r.brpop("l", timeout=0.01),
               r.mget(["a", "nope", "n"]), r.expire("a", 600),
               r.expire("nope", 1), r.delete("a", "nope"),
               sorted(r.scan_iter("*")), r.brpop("empty", timeout=0.01)]
        r.set("ttl", "v", ex=0)
        out.append(r.get("ttl"))
        return out, {k: v for k, v in r._data.items()}

    assert drive(tchaos) == drive(rchaos)


# -- the role loops ------------------------------------------------------------------------


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_role_workers_end_to_end(kind):
    b, mk = make_brokers(kind, lease_s=2.0)
    pre = PrefillWorker(ScriptedEngine(), mk("p0"), worker_id="p0")
    dec = DecodeWorker(ScriptedEngine(), mk("d0"), worker_id="d0")
    reqs = [GenerateRequest(id=f"r{i}", token_ids=[10 + i, 20 + i],
                            max_new_tokens=5) for i in range(4)]
    reqs.append(GenerateRequest(id="s", token_ids=[7], max_new_tokens=1))
    for r in reqs:
        b.push_request(r)
    got = {}
    deadline = time.monotonic() + 20
    while len(got) < len(reqs) and time.monotonic() < deadline:
        pre.run_once()
        dec.run_once()
        for r in reqs:
            if r.id not in got:
                resp = b.wait_response(r.id, timeout=0.01)
                if resp is not None:
                    got[r.id] = resp
    assert len(got) == len(reqs)
    for r in reqs:
        assert got[r.id].error is None, (r.id, got[r.id].error)
        assert got[r.id].token_ids == ScriptedEngine.expected_tokens(
            list(r.token_ids), r.max_new_tokens)
    ws = b.read_workers()
    assert ws["p0"]["role"] == "prefill" and ws["d0"]["role"] == "decode"
    st = b.delivery_stats()
    # The one-token request was answered by the prefill replica; every
    # record went to the registered decode replica's routed queue.
    assert st["handoffs"] == 4 and st["reprefills"] == 0
    assert b.handoff_depths() == {}


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_prefill_loop_routes_to_the_least_loaded_decode_replica(kind):
    """With two decode replicas registered, the prefill loop spreads its
    records by routed backlog; with none, it uses the shared queue."""
    b, mk = make_brokers(kind, lease_s=60.0)
    pre = PrefillWorker(ScriptedEngine(), mk("p0"), worker_id="p0")
    for wid in ("d0", "d1"):
        b.register_worker({"worker_id": wid, "role": "decode",
                           "state": "ready", "heartbeat_ts": time.time(),
                           "inflight_rows": 0, "free_slots": 1})
    for i in range(4):
        b.push_request(GenerateRequest(id=f"r{i}", token_ids=[i + 1, 2],
                                       max_new_tokens=4))
        pre.run_once()
    assert b.handoff_depths() == {"d0": 2, "d1": 2}
    for wid in ("d0", "d1"):
        b.deregister_worker(wid)
    b.push_request(GenerateRequest(id="r9", token_ids=[3], max_new_tokens=4))
    pre.run_once()
    assert b.handoff_depth() == 5 and b.handoff_depths() == {"d0": 2,
                                                             "d1": 2}


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_chaos_kill_prefill_mid_handoff_exactly_one_terminal(kind):
    """The prefill replica dies after exporting and before pushing the
    record: the request's lease is still open, so it is prefilled again on
    the respawned replica; nothing is lost or answered twice."""
    b, mk = make_brokers(kind, lease_s=0.25, max_delivery_attempts=6)
    kills_left = [2]
    klock = threading.Lock()

    def on_exported(rec):
        with klock:
            if kills_left[0] > 0:
                kills_left[0] -= 1
                raise HardKill(f"killed after exporting {rec.req.id}")

    pre = ChaosWorkerHost(lambda: PrefillWorker(
        ScriptedEngine(), mk("p0"), worker_id="p0", on_exported=on_exported,
        poll_timeout_s=0.02), respawn_delay_s=0.02)
    dec = ChaosWorkerHost(lambda: DecodeWorker(
        ScriptedEngine(), mk("d0"), worker_id="d0", poll_timeout_s=0.02),
        respawn_delay_s=0.02)
    reqs = [GenerateRequest(id=f"r{i}", token_ids=[i % 50 + 1, i % 7 + 1],
                            max_new_tokens=4, deadline_ts=time.time() + 30.0)
            for i in range(10)]
    pre.start()
    dec.start()
    try:
        for r in reqs:
            b.push_request(r)
        results = collect_responses(b, reqs, timeout_s=20.0)
        assert audit_exactly_once(reqs, results) == len(reqs)
    finally:
        pre.stop()
        dec.stop()
    assert pre.error is None and dec.error is None
    assert pre.kills == 2 and pre.spawns >= 3
    assert b.delivery_stats()["redelivered"] >= 2


def test_decode_loop_fails_a_corrupt_record_back():
    """A record the decode loop cannot adopt goes back through
    ``fail_handoff``: its request prefills again, the replica lives."""
    b = InProcBroker(lease_s=60.0)
    dec = DecodeWorker(ScriptedEngine(), b, worker_id="d0",
                       poll_timeout_s=0.0)
    from llmss_tpu_torch.serve.handoff import HandoffRecord

    req = GenerateRequest(id="c", token_ids=[1, 2], max_new_tokens=3)
    b.push_handoff_to("d0", HandoffRecord(req=req, first_token=3, n_tokens=2,
                                          payload=b"not json"))
    assert dec.run_once() == 1
    assert b.delivery_stats()["reprefills"] == 1
    assert b.pop_request().id == "c"
