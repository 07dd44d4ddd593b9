"""Preemption in the torch port, on the CPU, against the JAX package: the
broker's refund (``preempt_requests``), the batcher's eviction and replayed
resume (``preempt_cb``, ``submit(priority=, replayed=)``), and
``ContinuousWorker`` serving preempted requests and the request fields a
reference worker serves without a KV store (``session_id``,
``resume_tokens``, ``preemptions``).

The reference's ``tests/test_priority.py`` is mirrored case by case (its
brownout, producer and cost cases belong to later slices), over the dense
and paged layouts, split and chunked admission, fp32 and int8 caches.
What is compared with the JAX package:

- brokers: the same scripted operations observe the same results,
  in-process and over Redis (``FakeRedis``);
- batchers: the same victims, the same preemption counts, and after every
  step the same ``blocks_in_use`` and block refcounts; the same tokens,
  greedy and seeded-sampled, which on an fp32 cache are also the tokens of
  the request never preempted;
- workers: the same answers for the same schedule.

Tiny fp32 llama, parameters from the JAX ``init_params`` through
``convert.params_from_jax``."""

import dataclasses
import time

import jax
import pytest

import llmss_tpu.serve.broker as rbroker
import llmss_tpu.serve.protocol as rproto
import llmss_tpu_torch.serve.broker as tbroker
import llmss_tpu_torch.serve.protocol as tproto
from llmss_tpu.engine import DecodeEngine as JEngine
from llmss_tpu.engine import GenerationParams as JGen
from llmss_tpu.engine.scheduler import ContinuousBatcher as JBatcher
from llmss_tpu.engine.scheduler import select_preemption_victim as jselect
from llmss_tpu.models import decoder as jdec
from llmss_tpu.models.common import DecoderConfig as JCfg
from llmss_tpu.parallel import MeshPlan, make_mesh
from llmss_tpu.serve.chaos import FakeRedis
from llmss_tpu.serve.consumer import ContinuousWorker as JWorker
from llmss_tpu_torch.convert import params_from_jax
from llmss_tpu_torch.engine.engine import DecodeEngine as TEngine
from llmss_tpu_torch.engine.engine import GenerationParams as TGen
from llmss_tpu_torch.engine.scheduler import ContinuousBatcher as TBatcher
from llmss_tpu_torch.engine.scheduler import select_preemption_victim
from llmss_tpu_torch.models.common import DecoderConfig as TCfg
from llmss_tpu_torch.serve.consumer import ContinuousWorker as TWorker

CFG = dict(model_type="llama", vocab_size=128, hidden_size=64, n_layers=2,
           n_heads=4, n_kv_heads=2, head_dim=16, intermediate_size=96,
           max_position_embeddings=64, activation="silu", norm="rmsnorm",
           mlp="swiglu", positions="rotary", rope_style="half",
           attn_bias=False, mlp_bias=False, dtype="float32")
KV = {"fp32": None, "int8": "int8"}
# Batcher modes: (engine keywords, batcher keywords).
MODES = {"dense": ({}, {}),
         "paged": (dict(kv_layout="paged", block_size=8), {}),
         "chunked": (dict(kv_layout="paged", block_size=8),
                     dict(chunked_prefill=4))}
PFX = list(range(1, 21))  # one full block of 16 and a tail of 4
GENS = {"greedy": dict(is_greedy=True),
        "sampled": dict(is_greedy=False, temperature=0.9, top_k=8, seed=4)}


@pytest.fixture(scope="module")
def model():
    mesh = make_mesh(MeshPlan(dp=1, tp=1), devices=jax.devices()[:1])
    jp = jdec.init_params(JCfg(**CFG), mesh, jax.random.key(0))
    return mesh, jp, params_from_jax(jax.device_get(jp))


@pytest.fixture(scope="module")
def engines(model):
    """(JAX engine, port engine) per configuration, built once."""
    mesh, jp, tp = model
    made = {}

    def get(kv="fp32", **kw):
        key = (kv, tuple(sorted(kw.items())))
        if key not in made:
            ekw = {"max_seq_len": 64, "kv_dtype": KV[kv], **kw}
            made[key] = (JEngine(JCfg(**CFG), jp, mesh, **ekw),
                         TEngine(TCfg(**CFG), tp, device="cpu", **ekw))
        return made[key]

    return get


def _state(bat) -> tuple:
    """What must match the JAX batcher after every step: blocks in use and
    every block's refcount (paged), the rows in use and the preemptions."""
    out = (len(bat.active), bat.engine.metrics.preempted)
    if getattr(bat, "allocator", None) is not None:
        a = bat.allocator
        out += (a.blocks_in_use,
                tuple(a.refcount(b) for b in range(a.num_blocks)))
    return out


def _cycle(bat, G, *, p_low, p_hi, n_low, n_hi, sampling, prefix=None,
           settle=3):
    """One evict-and-resume cycle, as the reference's ``_preempt_cycle``:
    a batch-class request decodes, an interactive one arrives and evicts
    it, and it resumes with its emitted tokens replayed. Returns (tokens,
    evicted tokens, the state after every step)."""
    got, evicted, trace = {}, {}, []
    bat.preempt_cb = lambda rid, toks: evicted.__setitem__(rid, list(toks))

    def cb(key):
        return lambda toks, *a, **k: got.__setitem__(key, list(toks))

    gen_low = G(max_new_tokens=n_low, **sampling)
    bat.submit(p_low, gen_low, cb("low"), req_id="low", priority=2,
               prefix=prefix)
    for _ in range(settle):
        bat.step()
        trace.append(_state(bat))
    bat.submit(p_hi, G(max_new_tokens=n_hi, **sampling), cb("hi"),
               req_id="hi", priority=0)
    bat.step()
    trace.append(_state(bat))
    assert "low" in evicted, "the interactive arrival did not preempt"
    toks = evicted["low"]
    assert 0 < len(toks) < n_low
    bat.submit(p_low + toks,
               dataclasses.replace(gen_low, max_new_tokens=n_low - len(toks)),
               cb("low"), req_id="low", priority=2, replayed=len(toks),
               prefix=prefix)
    while not bat.idle:
        bat.step()
        trace.append(_state(bat))
    return got, toks, trace


# -- protocol and the victim policy ----------------------------------------------


def test_request_validates_slo_class_and_resume():
    tproto.GenerateRequest(token_ids=[1], slo_class="batch").validate()
    for bad in (dict(slo_class="vip"),
                dict(max_new_tokens=2, resume_tokens=[5, 6])):
        with pytest.raises(ValueError):
            tproto.GenerateRequest(token_ids=[1], **bad).validate()
        with pytest.raises(ValueError):
            rproto.GenerateRequest(token_ids=[1], **bad).validate()


def test_victim_policy_matches_reference():
    """The same victim as the reference's function on random candidate
    lists: strictly outranked rows only, lowest class, fewest tokens,
    first on ties."""
    import random

    rng = random.Random(0)
    for _ in range(500):
        cands = [(i, rng.randrange(3), rng.randrange(5))
                 for i in range(rng.randrange(6))]
        head = rng.randrange(3)
        assert select_preemption_victim(cands, head) == jselect(cands, head)
    assert select_preemption_victim([(0, 2, 3), (1, 2, 1), (2, 2, 1)], 0) == 1
    assert select_preemption_victim([(0, 1, 0)], 1) is None


# -- brokers: the refund ------------------------------------------------------------


def _broker(pkg, kind, **kw):
    if kind == "inproc":
        return pkg.InProcBroker(**kw)
    return pkg.RedisBroker(client=FakeRedis(), worker_id="w0", **kw)


def class_queues_drain_in_priority_order(pkg, proto, kind):
    b = _broker(pkg, kind)
    for rid, cls in (("b1", "batch"), ("s1", "standard"),
                     ("i1", "interactive")):
        b.push_request(proto.GenerateRequest(id=rid, token_ids=[1],
                                             slo_class=cls))
    return (b.queue_depths_by_class(), b.queue_depth(),
            [b.pop_request().id for _ in range(3)])


def preempt_refunds_attempt_and_never_dlqs(pkg, proto, kind):
    b = _broker(pkg, kind, lease_s=30.0, max_delivery_attempts=2)
    b.push_request(proto.GenerateRequest(id="r1", token_ids=[1],
                                         max_new_tokens=8))
    seen = []
    for i in range(5):
        req = b.pop_request()
        seen.append((req.id, req.delivery_attempts))
        req.resume_tokens = list(range(i + 1))
        req.preemptions += 1
        seen.append(b.preempt_requests([req]))
    req = b.pop_request()
    b.push_response(proto.GenerateResponse(id="r1", token_ids=[2]))
    return (seen, b.dlq_depth(), b.delivery_stats()["preempted"],
            req.preemptions, req.resume_tokens, req.delivery_attempts,
            b.wait_response("r1", timeout=1).token_ids,
            b.wait_response("r1", timeout=0.05))


def preempted_request_requeues_at_class_head(pkg, proto, kind):
    b = _broker(pkg, kind)
    b.push_request(proto.GenerateRequest(id="s1", token_ids=[1]))
    b.push_request(proto.GenerateRequest(id="s2", token_ids=[1]))
    first = b.pop_request().id
    b.preempt_requests([proto.GenerateRequest(id="s1", token_ids=[1])])
    return first, b.pop_request().id, b.pop_request().id


def preempt_unleased_request_is_noop(pkg, proto, kind):
    b = _broker(pkg, kind)
    n = b.preempt_requests([proto.GenerateRequest(id="ghost", token_ids=[1])])
    return n, b.queue_depth(), b.delivery_stats().get("preempted", 0)


def preempt_after_lease_expiry_loses_to_the_reaper(pkg, proto, kind):
    """A preemption whose lease was reaped first requeues nothing: the
    reaper's redelivery stands, and the request is queued once."""
    b = _broker(pkg, kind, lease_s=0.03)
    b.push_request(proto.GenerateRequest(id="r", token_ids=[1]))
    req = b.pop_request()
    time.sleep(0.06)
    b.reap_expired()
    n = b.preempt_requests([req])
    again = b.pop_request()
    return (n, again.id, again.delivery_attempts, b.pop_request(),
            b.delivery_stats()["redelivered"])


BROKER_CASES = (class_queues_drain_in_priority_order,
                preempt_refunds_attempt_and_never_dlqs,
                preempted_request_requeues_at_class_head,
                preempt_unleased_request_is_noop,
                preempt_after_lease_expiry_loses_to_the_reaper)


@pytest.mark.parametrize("kind", ("inproc", "redis"))
@pytest.mark.parametrize("case", BROKER_CASES, ids=lambda c: c.__name__)
def test_broker_refund_matches_reference(case, kind):
    assert case(tbroker, tproto, kind) == case(rbroker, rproto, kind)


def test_preempted_request_crosses_redis_both_ways():
    """On one FakeRedis: the reference preempts a request the port then
    leases with its resume point and refunded attempt, and back."""
    server = FakeRedis()
    ref = rbroker.RedisBroker(client=server, worker_id="ref")
    port = tbroker.RedisBroker(client=server, worker_id="port")
    ref.push_request(rproto.GenerateRequest(id="a", token_ids=[1],
                                            max_new_tokens=9,
                                            slo_class="batch"))
    a = ref.pop_request()
    a.resume_tokens, a.preemptions = [5, 6], 1
    assert ref.preempt_requests([a]) == 1
    got = port.pop_request()
    assert (got.id, got.resume_tokens, got.preemptions, got.slo_class,
            got.delivery_attempts) == ("a", [5, 6], 1, "batch", 1)
    got.resume_tokens, got.preemptions = [5, 6, 7], 2
    assert port.preempt_requests([got]) == 1
    back = ref.pop_request()
    assert (back.id, back.resume_tokens, back.preemptions,
            back.delivery_attempts) == ("a", [5, 6, 7], 2, 1)
    assert port.delivery_stats()["preempted"] == 2
    assert ref.delivery_stats()["preempted"] == 2
    assert ref.dlq_depth() == 0


# -- the batcher: eviction and replayed resume --------------------------------------


@pytest.mark.parametrize("sampling", sorted(GENS))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_preempt_resume_stream_identical(engines, mode, sampling):
    """A preempted request resumed with its tokens replayed ends with the
    stream of the request never preempted (fp32), and the interactive one
    with its solo tokens; victims, counts, rows and blocks after every step
    equal the JAX batcher's, and so do the tokens."""
    ekw, bkw = MODES[mode]
    jeng, teng = engines(**ekw)
    kw = dict(p_low=[1, 2, 3], p_hi=[9, 8, 7], n_low=12, n_hi=4,
              sampling=GENS[sampling])
    want, want_ev, want_trace = _cycle(JBatcher(jeng, rows=1, **bkw), JGen,
                                       **kw)
    before = teng.metrics.preempted
    got, got_ev, got_trace = _cycle(TBatcher(teng, rows=1, **bkw), TGen,
                                    **kw)
    assert teng.metrics.preempted == before + 1
    assert got == want and got_ev == want_ev
    assert [s[0] for s in got_trace] == [s[0] for s in want_trace]
    assert [s[2:] for s in got_trace] == [s[2:] for s in want_trace]
    g = TGen(max_new_tokens=12, **GENS[sampling])
    assert got["low"] == teng.generate([[1, 2, 3]], g)[0]
    assert got["hi"] == teng.generate(
        [[9, 8, 7]], dataclasses.replace(g, max_new_tokens=4))[0]


@pytest.mark.parametrize("mode", ("dense", "paged"))
def test_preempt_without_cb_is_disabled(engines, mode):
    """``preempt_cb=None``: an interactive arrival behind a busy batcher
    waits its turn; nothing is evicted."""
    ekw, bkw = MODES[mode]
    _jeng, teng = engines(**ekw)
    before = teng.metrics.preempted
    b = TBatcher(teng, rows=1, **bkw)
    got = {}
    gen = TGen(max_new_tokens=6)
    b.submit([1, 2], gen, lambda t, *a, **k: got.__setitem__("low", t),
             req_id="low", priority=2)
    for _ in range(3):
        b.step()
    b.submit([3, 4], gen, lambda t, *a, **k: got.__setitem__("hi", t),
             req_id="hi", priority=0)
    b.run_until_idle()
    assert teng.metrics.preempted == before
    assert len(got["low"]) == 6 and len(got["hi"]) == 6


@pytest.mark.parametrize("kv", sorted(KV))
@pytest.mark.parametrize("chunked", (False, True), ids=("split", "chunked"))
def test_preempt_paged_cow_refcounts_balance(engines, chunked, kv):
    """Block pressure, not row pressure, evicts a row that shares a
    copy-on-write prefix block: its owned blocks are freed and the shared
    one decrefed, the resume increfs it again, and once idle only the
    prefix registry's block is held. Blocks and refcounts after every step
    and the tokens equal the JAX batcher's; on fp32 the tokens are also
    the solo ones."""
    ekw = dict(kv_layout="paged", block_size=16, kv_blocks=4)
    jeng, teng = engines(kv, **ekw)
    bkw = dict(chunked_prefill=8) if chunked else {}
    # hi: 3 + 45 tokens need 3 blocks, and 2 are free.
    kw = dict(p_low=PFX + [30], p_hi=[40, 41, 42], n_low=10, n_hi=45,
              sampling=GENS["greedy"])
    want, want_ev, want_trace = _cycle(
        JBatcher(jeng, rows=2, **bkw), JGen, prefix=jeng.build_prefix(PFX),
        **kw)
    bat = TBatcher(teng, rows=2, **bkw)
    pm = teng.metrics.preempted
    got, got_ev, got_trace = _cycle(bat, TGen,
                                    prefix=teng.build_prefix(PFX), **kw)
    assert got == want and got_ev == want_ev
    assert [s[2:] for s in got_trace] == [s[2:] for s in want_trace]
    assert [s[0] for s in got_trace] == [s[0] for s in want_trace]
    assert teng.metrics.preempted == pm + 1
    assert bat.allocator.blocks_in_use == 1
    assert teng.metrics.to_dict()["kv_blocks_in_use"] == 1
    assert teng.metrics.to_dict()["preempted_rows"] == teng.metrics.preempted
    if kv == "fp32":
        dense = engines()[1]
        assert got["low"] == dense.generate([PFX + [30]],
                                            TGen(max_new_tokens=10))[0]
        assert got["hi"] == dense.generate([[40, 41, 42]],
                                           TGen(max_new_tokens=45))[0]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_no_graph_capture_after_prewarm_with_preemption(engines, mode):
    """A prewarmed batcher runs the whole evict-and-resume cycle without a
    new step graph: eviction is host bookkeeping, and the resume admits as
    any request does."""
    ekw, bkw = MODES[mode]
    _jeng, teng = engines(**ekw)
    bat = TBatcher(teng, rows=1, **bkw)
    bat.prewarm()
    captures = teng.metrics.graph_captures
    got, _, _ = _cycle(bat, TGen, p_low=[1, 2, 3], p_hi=[9, 8, 7], n_low=12,
                       n_hi=4, sampling=GENS["greedy"])
    assert len(got) == 2
    assert teng.metrics.graph_captures == captures


# -- the worker ---------------------------------------------------------------------


def _drive(worker, broker, pushes, ids, max_iters=400):
    """Run ``worker`` until every id is answered; ``pushes`` maps an
    iteration to the requests pushed before it. Returns {id: (tokens,
    error)}."""
    got = {}
    for it in range(max_iters):
        for r in pushes.get(it, ()):
            broker.push_request(r)
        worker.run_once()
        for rid in ids:
            if rid not in got:
                resp = broker.wait_response(rid, timeout=0.001)
                if resp is not None:
                    got[rid] = (resp.token_ids, resp.error)
        if len(got) == len(ids) and it >= max(pushes):
            return got
    raise AssertionError(f"unanswered after {max_iters} iterations: {got}")


def _workers(engines, mode, kind, **wkw):
    """(JAX worker, its broker, port worker, its broker) for one mode."""
    ekw, bkw = MODES[mode]
    jeng, teng = engines(**ekw)
    jb, tb = _broker(rbroker, kind), _broker(tbroker, kind)
    jw = JWorker(jeng, jb, rows=wkw.get("rows", 1), chunk_steps=2,
                 poll_timeout_s=0.0, **bkw)
    tw = TWorker(teng, tb, rows=wkw.get("rows", 1), chunk_steps=2, **bkw)
    return jw, jb, tw, tb


@pytest.mark.parametrize("kind", ("inproc", "redis"))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_worker_preempt_roundtrip(engines, mode, kind):
    """Through the broker: a batch-class request decoding is preempted by
    an interactive arrival, refunded with its resume point, leased again
    and finished with the stream it gets unpreempted; the same schedule on
    the JAX worker gives the same answers and counts. Nothing is
    dead-lettered and every request is answered once."""
    jw, jb, tw, tb = _workers(engines, mode, kind)

    def reqs(proto):
        return {0: [proto.GenerateRequest(
                    id="low", token_ids=[2, 4, 6], max_new_tokens=20,
                    slo_class="batch")],
                3: [proto.GenerateRequest(
                    id="hi", token_ids=[5, 3, 1], max_new_tokens=4,
                    slo_class="interactive")]}

    want = _drive(jw, jb, reqs(rproto), ["low", "hi"])
    got = _drive(tw, tb, reqs(tproto), ["low", "hi"])
    assert got == want
    teng = tw.engine
    assert got["low"][0] == teng.generate([[2, 4, 6]],
                                          TGen(max_new_tokens=20))[0]
    assert got["hi"][0] == teng.generate([[5, 3, 1]],
                                         TGen(max_new_tokens=4))[0]
    for b in (jb, tb):
        st = b.delivery_stats()
        assert st["preempted"] == 1 and st["dlq_depth"] == 0
        assert st["inflight"] == 0 and st["queue_depth"] == 0
    for rid in ("low", "hi"):
        assert tb.wait_response(rid, timeout=0.001) is None  # answered once
    assert not tw._reqs


# -- the repair: request fields a reference worker serves ------------------------------


@pytest.mark.parametrize("field", ("session_id", "resume_tokens"))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_worker_serves_session_and_resume_fields(engines, mode, field):
    """A request carrying ``session_id``, or ``resume_tokens`` and
    ``preemptions`` (a request a reference worker preempted), is served
    with the tokens the reference's worker gives it without a KV store;
    a resumed request's answer is the unpreempted stream (fp32)."""
    jw, jb, tw, tb = _workers(engines, mode, "inproc", rows=2)
    teng = tw.engine
    full = teng.generate([[3, 1, 4, 1, 5]], TGen(max_new_tokens=10))[0]

    def reqs(proto):
        kw = (dict(session_id="chat-7", turn=2) if field == "session_id"
              else dict(resume_tokens=full[:4], preemptions=1))
        return {0: [proto.GenerateRequest(id="r", token_ids=[3, 1, 4, 1, 5],
                                          max_new_tokens=10, **kw),
                    proto.GenerateRequest(id="s", token_ids=[2, 7],
                                          max_new_tokens=5, **kw)
                    if field == "session_id" else
                    proto.GenerateRequest(id="s", token_ids=[2, 7],
                                          max_new_tokens=5)]}

    want = _drive(jw, jb, reqs(rproto), ["r", "s"])
    got = _drive(tw, tb, reqs(tproto), ["r", "s"])
    assert got == want
    assert got["r"] == (full, None)
