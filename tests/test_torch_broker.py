"""The torch port's brokers against the JAX package's.

Each delivery case (the cases of ``tests/test_broker_delivery.py``) runs
the same scripted operations on the reference's broker and on the port's,
in-process and over Redis (``FakeRedis``, the reference's in-memory
stand-in), and the two must observe the same results. The wire cases put
both ``RedisBroker``s on one FakeRedis: what one writes the other reads,
and the same operations leave the same keys and values behind. Leases are
short (tens of milliseconds) and time moves by explicit short waits."""

import dataclasses
import time

import pytest

import llmss_tpu.serve.broker as rbroker
import llmss_tpu.serve.protocol as rproto
import llmss_tpu_torch.serve.broker as tbroker
import llmss_tpu_torch.serve.protocol as tproto
from llmss_tpu.serve.chaos import FakeRedis

KINDS = ("inproc", "redis")


class Side:
    """One package's broker and wire types, in-process or over a fresh
    FakeRedis."""

    def __init__(self, bmod, pmod, kind):
        self.bmod, self.kind = bmod, kind
        self.Req, self.Resp = pmod.GenerateRequest, pmod.GenerateResponse
        self.redis = None

    def broker(self, **kw):
        if self.kind == "inproc":
            return self.bmod.InProcBroker(**kw)
        kw.pop("response_ttl_s", None)
        self.redis = FakeRedis()
        return self.bmod.RedisBroker(client=self.redis, worker_id="w0", **kw)


def _sides(kind):
    return Side(rbroker, rproto, kind), Side(tbroker, tproto, kind)


def _same(case, kind):
    ref, port = _sides(kind)
    want = case(ref)
    got = case(port)
    assert got == want
    return got


# -- the delivery cases --------------------------------------------------------------


def ack_prevents_redelivery(s):
    b = s.broker(lease_s=0.05)
    b.push_request(s.Req(id="r1", token_ids=[1]))
    req = b.pop_request()
    out = [req.id, req.delivery_attempts]
    b.push_response(s.Resp(id="r1", token_ids=[2]))  # the ack
    time.sleep(0.1)  # the lease would have expired unacked
    return out + [b.reap_expired(), b.pop_request(),
                  b.wait_response("r1", timeout=1).token_ids]


def expired_lease_is_redelivered(s):
    b = s.broker(lease_s=0.05)
    b.push_request(s.Req(id="r1", token_ids=[1]))
    first = b.pop_request().delivery_attempts
    time.sleep(0.1)  # the worker died holding the lease
    again = b.pop_request()
    return [first, again.id, again.delivery_attempts,
            b.delivery_stats()["redelivered"]]


def touch_keeps_lease_alive(s):
    b = s.broker(lease_s=0.08)
    b.push_request(s.Req(id="r1", token_ids=[1]))
    b.pop_request()
    for _ in range(4):
        time.sleep(0.04)
        b.touch_requests(["r1"])
    return [b.reap_expired(), b.pop_request()]


def dead_letter_after_max_attempts(s):
    b = s.broker(lease_s=0.03, max_delivery_attempts=2)
    b.push_request(s.Req(id="poison", token_ids=[1]))
    out = [b.pop_request().delivery_attempts]
    time.sleep(0.06)
    out.append(b.pop_request().delivery_attempts)
    time.sleep(0.06)
    out += [b.pop_request(), b.dlq_depth(), b.read_dlq(),
            b.wait_response("poison", timeout=1).error]
    stats = b.delivery_stats()
    return out + [stats["dead_lettered"], stats["dlq_depth"]]


def deadline_shed_at_redelivery(s):
    b = s.broker(lease_s=0.03)
    b.push_request(s.Req(id="late", token_ids=[1],
                         deadline_ts=time.time() + 0.05))
    b.pop_request()
    time.sleep(0.1)  # the lease and the deadline both passed
    return [b.pop_request(), b.wait_response("late", timeout=1).error,
            b.delivery_stats()["deadline_expired"]]


def delivery_stats_shape(s):
    b = s.broker()
    b.push_request(s.Req(id="a", token_ids=[1]))
    b.push_request(s.Req(id="b", token_ids=[1], slo_class="interactive"))
    b.push_request(s.Req(id="c", token_ids=[1], slo_class="batch"))
    out = [b.queue_depth(), b.queue_depths_by_class()]
    out.append(b.pop_request().id)  # interactive first
    return out + [b.delivery_stats()]


def response_ttl(s):
    if s.kind == "inproc":
        b = s.broker(response_ttl_s=0.01)
        b.push_response(s.Resp(id="orphan", token_ids=[1]))
        time.sleep(0.03)
        b.push_response(s.Resp(id="fresh", token_ids=[2]))  # reaps
        orphan = b.wait_response("orphan", timeout=0.01)
        ttl = None
    else:
        b = s.broker()
        b.push_response(s.Resp(id="orphan", token_ids=[1]))
        orphan = None
        # The response key's TTL on the server.
        ttl = round(s.redis._expiry["squeue:orphan"] - time.monotonic())
        b.push_response(s.Resp(id="fresh", token_ids=[2]))
    return [orphan, ttl, b.wait_response("fresh", timeout=1).token_ids]


def dropped_stream_stays_dropped(s):
    b = s.broker()
    b.push_stream("s1", [1, 2])
    out = [b.pop_stream("s1")]
    b.drop_stream("s1")
    out.append(b.pop_stream("s1"))
    b.push_stream("s1", [3])  # a late worker flush
    return out + [b.pop_stream("s1"), b.pop_stream("s1", timeout=0.01)]


def release_requests(s):
    b = s.broker()
    for rid in ("a", "b", "c"):
        b.push_request(s.Req(id=rid, token_ids=[1]))
    first, second = b.pop_request(), b.pop_request()
    n = b.release_requests([first.id, second.id, "unknown"])
    order = [b.pop_request() for _ in range(3)]
    return [first.id, second.id, n,
            [(r.id, r.delivery_attempts) for r in order],
            b.delivery_stats()["inflight"]]


CASES = (ack_prevents_redelivery, expired_lease_is_redelivered,
         touch_keeps_lease_alive, dead_letter_after_max_attempts,
         deadline_shed_at_redelivery, delivery_stats_shape, response_ttl,
         dropped_stream_stays_dropped, release_requests)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_delivery_case_matches_reference(case, kind):
    got = _same(case, kind)
    # The contract itself, beside the reference's agreement.
    if case is ack_prevents_redelivery:
        assert got == ["r1", 1, 0, None, [2]]
    elif case is expired_lease_is_redelivered:
        assert got == [1, "r1", 2, 1]
    elif case is touch_keeps_lease_alive:
        assert got == [0, None]
    elif case is dead_letter_after_max_attempts:
        assert got[:4] == [1, 2, None, 1]
        assert got[4][0]["id"] == "poison"
        assert got[4][0]["delivery_attempts"] == 2
        assert "dead-lettered after 2" in got[5] and got[6:] == [1, 1]
    elif case is deadline_shed_at_redelivery:
        assert got[0] is None and "deadline exceeded" in got[1]
        assert got[2] == 1
    elif case is delivery_stats_shape:
        assert got[0] == 3 and got[2] == "b"
        stats = got[3]
        assert (stats["queue_depth"], stats["inflight"], stats["dlq_depth"],
                stats["redelivered"]) == (2, 1, 0, 0)
    elif case is response_ttl:
        assert got[0] is None and got[2] == [2]
        assert got[1] == (None if kind == "inproc" else 600)
    elif case is dropped_stream_stays_dropped:
        # A dropped in-process stream stays dropped; Redis has no tombstone,
        # in the reference as here, so a late flush is readable again.
        late = None if kind == "inproc" else [3]
        assert got == [[1, 2], None, late, None]
    elif case is release_requests:
        assert got[:3] == ["a", "b", 2]
        assert got[3] == [("b", 1), ("a", 1), ("c", 1)]  # refunded
        assert got[4] == 3  # all three leased again


# -- the wire: both RedisBrokers on one FakeRedis ----------------------------------------


def _pair(**kw):
    server = FakeRedis()
    ref = rbroker.RedisBroker(client=server, worker_id="ref", **kw)
    port = tbroker.RedisBroker(client=server, worker_id="port", **kw)
    return server, ref, port


def test_reference_requests_are_popped_by_the_port():
    _, ref, port = _pair()
    reqs = [rproto.GenerateRequest(id="s", token_ids=[1, 2], max_new_tokens=5,
                                   is_greedy=False, temperature=0.7, top_k=3,
                                   seed=9, stream=True,
                                   deadline_ts=time.time() + 60),
            rproto.GenerateRequest(id="i", prompt="hi",
                                   slo_class="interactive", session_id="x",
                                   turn=2)]
    for r in reqs:
        ref.push_request(r)
    got = [port.pop_request(), port.pop_request(timeout=0.05)]
    assert port.pop_request() is None
    assert [g.id for g in got] == ["i", "s"]  # class priority
    for g in got:
        want = next(r for r in reqs if r.id == g.id)
        assert dataclasses.asdict(g) == {
            **dataclasses.asdict(want),
            "delivery_attempts": want.delivery_attempts + 1,
        }
    # The port holds the leases under its own worker id.
    assert port.delivery_stats()["inflight"] == 2
    assert ref.delivery_stats()["inflight"] == 2
    # And the reverse: a port request popped by the reference.
    port.push_request(tproto.GenerateRequest(id="p", token_ids=[3]))
    r = ref.pop_request()
    assert (r.id, r.token_ids, r.trace_id, r.delivery_attempts) == (
        "p", [3], "p", 1)


def test_responses_cross_both_ways():
    _, ref, port = _pair()
    port.push_response(tproto.GenerateResponse(id="a", token_ids=[4, 5]))
    ref.push_response(rproto.GenerateResponse(id="b", error="cancelled",
                                              token_ids=[6]))
    a = ref.wait_response("a", timeout=1)
    b = port.wait_response("b", timeout=1)
    assert dataclasses.asdict(a) == dataclasses.asdict(
        tproto.GenerateResponse(id="a", token_ids=[4, 5]))
    assert (b.id, b.error, b.token_ids) == ("b", "cancelled", [6])
    assert port.wait_response("a", timeout=0.01) is None  # consumed once


def test_cancels_streams_and_metrics_cross_both_ways():
    _, ref, port = _pair()
    ref.cancel_request("x")
    port.cancel_request("y")
    assert port.check_cancelled(["x", "y", "z"]) == {"x", "y"}
    assert ref.check_cancelled(["x", "y", "z"]) == {"x", "y"}
    port.push_stream("s", [1, 2])
    port.push_stream("s", [3])
    ref.push_stream("t", [7])
    assert [ref.pop_stream("s"), ref.pop_stream("s", timeout=0.01)] == [
        [1, 2], [3]]
    assert port.pop_stream("t", timeout=0.01) == [7]
    ref.drop_stream("s")
    assert port.pop_stream("s") is None
    port.publish_metrics({"requests_served": 3, "ttft": {"count": 1}})
    assert ref.read_metrics() == {"requests_served": 3, "ttft": {"count": 1}}


def test_dead_letters_and_expired_leases_cross_both_ways():
    """A lease either package took and abandoned is reaped by the other
    (the lazy reaper runs on every pop, whoever pops), and each package
    reads what the other dead-lettered."""
    _, ref, port = _pair(lease_s=0.03, max_delivery_attempts=2)
    ref.push_request(rproto.GenerateRequest(id="r", token_ids=[1]))
    assert ref.pop_request().delivery_attempts == 1  # the reference dies
    time.sleep(0.06)
    again = port.pop_request()  # the port's reaper redelivers it
    assert (again.id, again.delivery_attempts) == ("r", 2)
    time.sleep(0.06)
    assert ref.pop_request() is None  # the reference's reaper dead-letters
    assert port.dlq_depth() == 1
    assert port.read_dlq()[0]["id"] == "r"
    assert "dead-lettered after 2" in port.wait_response("r", 1).error
    port.push_request(tproto.GenerateRequest(id="q", token_ids=[2]))
    for _ in range(2):
        assert ref.pop_request().id == "q"
        time.sleep(0.06)
    assert port.pop_request() is None  # the port's reaper dead-letters
    assert [d["id"] for d in ref.read_dlq()] == ["q", "r"]
    for b in (ref, port):
        stats = b.delivery_stats()
        assert (stats["redelivered"], stats["dead_lettered"],
                stats["dlq_depth"]) == (2, 2, 2)


class ClockedRedis(FakeRedis):
    """A FakeRedis whose server clock (``TIME``) the test sets, so lease
    stamps are the same in two runs."""

    now = 1000.0

    def time(self):
        sec = int(self.now)
        return (sec, int(round((self.now - sec) * 1e6)))


def _script(bmod, pmod):
    """One sequence of broker operations; returns the server's keys with
    their values and TTLs (rounded seconds)."""
    server = ClockedRedis()
    b = bmod.RedisBroker(client=server, worker_id="w0", lease_s=5.0,
                         max_delivery_attempts=2)
    R = pmod.GenerateRequest
    for i, cls in enumerate(("standard", "interactive", "batch", "standard")):
        b.push_request(R(id=f"r{i}", token_ids=[i, i + 1], slo_class=cls,
                         max_new_tokens=4 + i))
    a, c = b.pop_request(), b.pop_request()
    b.touch_requests([a.id, "nobody"])
    b.release_requests([c.id])
    b.cancel_request("r3")
    b.push_stream("r1", [9, 8])
    b.push_response(pmod.GenerateResponse(id=a.id, token_ids=[1, 2, 3]))
    d = b.pop_request()
    server.now += 10.0  # d's lease expires: redelivered
    e = b.pop_request()
    server.now += 10.0  # expired at the attempt budget: dead-lettered
    b.pop_request()
    b.publish_metrics({"requests_served": 1})
    now = time.monotonic()
    return ([d.id, e.id, e.delivery_attempts],
            {k: v for k, v in server._data.items()},
            {k: round(t - now) for k, t in server._expiry.items()})


def test_same_operations_leave_the_same_keys_and_values():
    ref = _script(rbroker, rproto)
    port = _script(tbroker, tproto)
    assert port == ref
    keys = set(port[1])
    assert {"pqueue:cls:batch", "pqueue:dlq", "squeue:r1", "cancelled:r3",
            "stream:r1", "llmss:metrics", "pqueue:lease:w0:r3",
            "pqueue:stats:redelivered", "pqueue:stats:dead_lettered"} <= keys
