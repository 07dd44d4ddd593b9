"""The torch port's HTTP front end on the CPU, against the JAX package.

A tiny fp32 llama (``init_params`` of the JAX package, converted by
``convert.params_from_jax``) serves through the port's whole front end:
``ProducerServer`` on port 0 over an ``InProcBroker``, and a supervised
``ContinuousWorker`` over the paged pool, with split admission and with
chunked prefill. Concurrent greedy and seeded-sampled requests, some over
server-sent events, must get exactly the JAX ``DecodeEngine.generate``
tokens for the same prompt and parameters, in the reference's response
JSON. Then cancellation, the error statuses, ``/health`` against the
reference's policy and ``/metrics`` against its Prometheus text. Every
request has a timeout; every server and thread stops in a ``finally``."""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import pytest

import llmss_tpu.serve.producer as rproducer
import llmss_tpu.utils.metrics as rmetrics
from llmss_tpu.engine import DecodeEngine as JEngine
from llmss_tpu.engine import GenerationParams as JGen
from llmss_tpu.models import decoder as jdec
from llmss_tpu.models.common import DecoderConfig as JCfg
from llmss_tpu.parallel import MeshPlan, make_mesh
from llmss_tpu.serve.protocol import GenerateResponse as RResponse
from llmss_tpu_torch.convert import params_from_jax
from llmss_tpu_torch.engine.engine import DecodeEngine as TEngine
from llmss_tpu_torch.models.common import DecoderConfig as TCfg
from llmss_tpu_torch.serve import producer as tproducer
from llmss_tpu_torch.serve.broker import InProcBroker
from llmss_tpu_torch.serve.consumer import ContinuousWorker
from llmss_tpu_torch.serve.protocol import GenerateRequest
from llmss_tpu_torch.serve.supervisor import Supervisor
from llmss_tpu_torch.utils import metrics as tmetrics

CFG = dict(model_type="llama", vocab_size=128, hidden_size=64, n_layers=2,
           n_heads=4, n_kv_heads=2, head_dim=16, intermediate_size=96,
           max_position_embeddings=64, activation="silu", norm="rmsnorm",
           mlp="swiglu", positions="rotary", rope_style="half",
           attn_bias=False, mlp_bias=False, dtype="float32")
# (prompt, sampling) per request; the SSE ones are marked.
REQUESTS = [
    (list(range(2, 22)), dict(max_new_tokens=8), True),
    ([5, 9, 23], dict(max_new_tokens=6), False),
    ([7, 7, 7, 7, 7, 7, 7], dict(max_new_tokens=5, is_greedy=False, seed=3,
                                 temperature=0.9, top_k=20), True),
    ([40, 41, 42, 43, 44], dict(max_new_tokens=7), False),
    ([3, 14, 15, 9, 26, 5, 35, 8, 9], dict(max_new_tokens=6, is_greedy=False,
                                           seed=11, temperature=1.2,
                                           top_p=0.8), False),
    ([1, 2], dict(max_new_tokens=9), False),
]
MODES = {"split": None, "chunked": 4}
RESPONSE_KEYS = set(RResponse(id="x").__dict__)


@pytest.fixture(scope="module")
def model():
    mesh = make_mesh(MeshPlan(dp=1, tp=1), devices=jax.devices()[:1])
    jp = jdec.init_params(JCfg(**CFG), mesh, jax.random.key(0))
    return mesh, jp, params_from_jax(jax.device_get(jp))


@pytest.fixture(scope="module")
def jax_tokens(model):
    """Each request's tokens from the JAX engine's ``generate``, alone."""
    mesh, jp, _ = model
    eng = JEngine(JCfg(**CFG), jp, mesh, max_seq_len=64)
    return [eng.generate([p], JGen(**g))[0] for p, g, _ in REQUESTS]


class CancelGate:
    """Wraps a worker: after the ``run_once`` in which request ``rid``
    first has tokens, the loop waits (10 s at most) until the request's
    cancel flag is set, so the cancel lands at a fixed step."""

    def __init__(self, worker):
        self.worker, self.rid, self.seen = worker, None, threading.Event()

    def __getattr__(self, name):
        return getattr(self.worker, name)

    def run_once(self):
        n = self.worker.run_once()
        if self.rid is not None and not self.seen.is_set() and any(
                r.req_id == self.rid and r.out
                for r in self.worker.batcher.active.values()):
            self.seen.set()
            end = time.monotonic() + 10.0
            while (time.monotonic() < end
                   and not self.worker.broker.check_cancelled([self.rid])):
                time.sleep(0.002)
        return n


@pytest.fixture(scope="module", params=sorted(MODES))
def served(request, model):
    """A supervised ContinuousWorker behind a ProducerServer, per mode."""
    eng = TEngine(TCfg(**CFG), model[2], device="cpu", max_seq_len=64,
                  kv_layout="paged", block_size=8)
    broker = InProcBroker()
    gate = CancelGate(ContinuousWorker(
        eng, broker, rows=3, chunk_steps=2, group_chunks=2,
        chunked_prefill=MODES[request.param]))
    gate.prewarm()
    sup = Supervisor(lambda: gate, broker, heartbeat_s=0.2, backoff_s=0.01)
    srv = tproducer.ProducerServer(broker, host="127.0.0.1", port=0,
                                   timeout_s=30.0)
    stop = threading.Event()
    t = threading.Thread(target=sup.run, args=(stop,), daemon=True)
    srv.start()
    t.start()
    try:
        yield dict(mode=request.param, port=srv.port, broker=broker, sup=sup,
                   gate=gate, thread=t, engine=eng)
    finally:
        stop.set()
        t.join(timeout=10)
        srv.stop()


def _post(port, path, body, timeout=30.0):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _get(port, path, timeout=10.0):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _sse(port, payload, on_first=None, timeout=30.0):
    """POST a ``stream`` request; returns (increments, the done event's
    response). ``on_first`` runs at the first increment."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps({**payload, "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    incs, done, event = [], None, None
    with urllib.request.urlopen(req, timeout=timeout) as r:
        assert r.headers["Content-Type"] == "text/event-stream"
        for raw in r:
            line = raw.decode().rstrip("\n")
            if line.startswith("event: "):
                event = line[len("event: "):]
            elif line.startswith("data: "):
                data = json.loads(line[len("data: "):])
                if event is None:
                    incs.append(data["token_ids"])
                    if len(incs) == 1 and on_first is not None:
                        on_first()
                else:
                    assert event == "done", data
                    done = data
            elif not line:
                event = None
    return incs, done


def test_http_answers_equal_jax_generate(served, jax_tokens):
    """The requests, all at once: every answer is the JAX engine's tokens;
    each SSE stream concatenates to its answer; the JSON has the
    reference's keys; /health is 200 while the worker serves."""
    port = served["port"]
    results = [None] * len(REQUESTS)

    def one(i):
        p, g, stream = REQUESTS[i]
        body = {"token_ids": p, **g}
        if stream:
            incs, done = _sse(port, body)
            results[i] = ("sse", incs, done)
        else:
            results[i] = _post(port, "/generate", body)

    threads = [threading.Thread(target=one, args=(i,), daemon=True)
               for i in range(len(REQUESTS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for i, res in enumerate(results):
        if REQUESTS[i][2]:
            _, incs, done = res
            assert set(done) == RESPONSE_KEYS and done["error"] is None
            assert [t for inc in incs for t in inc] == done["token_ids"]
            answer = done
        else:
            status, headers, answer = res
            assert status == 200 and headers["Content-Type"] == "application/json"
            assert set(answer) == RESPONSE_KEYS and answer["error"] is None
        assert answer["token_ids"] == jax_tokens[i], (served["mode"], i)
    status, _, body = _get(port, "/health")
    assert status == 200 and json.loads(body)["state"] == "ready"


def test_cancel_yields_partial_tokens(served):
    port, gate = served["port"], served["gate"]
    rid = f"cancel-{served['mode']}"
    gate.seen.clear()
    gate.rid = rid

    def cancel():
        assert _post(port, "/cancel", {"id": rid})[0] == 200

    incs, done = _sse(port, {"id": rid, "token_ids": [1, 2, 3],
                             "max_new_tokens": 50}, on_first=cancel)
    gate.rid = None
    assert done["error"] == "cancelled"
    assert 0 < len(done["token_ids"]) < 50
    assert [t for inc in incs for t in inc] == done["token_ids"]
    assert served["engine"].metrics.to_dict()["kv_blocks_in_use"] == 0


def test_metrics_json_and_prometheus(served):
    port, eng = served["port"], served["engine"]
    want = eng.metrics.to_dict()["requests_served"]
    assert want > 0
    deadline = time.monotonic() + 10
    while True:  # the worker publishes every 16 iterations and heartbeat
        status, _, body = _get(port, "/metrics")
        payload = json.loads(body)
        if payload.get("requests_served") == want or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert status == 200 and payload["requests_served"] == want
    assert payload["delivery"]["dlq_depth"] == 0
    assert payload["supervisor"]["state"] == "ready"
    assert payload["worker"]["rows"] == 3
    status, headers, text = _get(port, "/metrics?format=prometheus")
    assert status == 200 and headers["Content-Type"].startswith("text/plain")
    lines = text.decode().splitlines()
    assert f"llmss_requests_served {want}" in lines
    assert "llmss_delivery_dlq_depth 0" in lines
    status, _, body = _get(port, "/dlq")
    assert status == 200 and json.loads(body) == {"depth": 0, "requests": []}


def test_prefix_hint_over_http(served, model):
    """A request carrying ``prefix_token_ids`` over HTTP gets the JAX
    engine's tokens for its full prompt; /metrics carries the three
    eviction counters under the reference's names, in JSON and in the
    Prometheus text; the worker's ``prefix_hashes`` equal the reference
    worker's after the same request."""
    from llmss_tpu.serve.broker import InProcBroker as JBroker
    from llmss_tpu.serve.consumer import ContinuousWorker as JWorker
    from llmss_tpu.serve.protocol import GenerateRequest as JRequest

    mesh, jp, _ = model
    prompt, head = list(range(2, 22)), list(range(2, 12))
    body = {"token_ids": prompt, "max_new_tokens": 6,
            "prefix_token_ids": head}
    jeng = JEngine(JCfg(**CFG), jp, mesh, max_seq_len=64, kv_layout="paged",
                   block_size=8)
    status, _, answer = _post(served["port"], "/generate", body)
    assert status == 200 and answer["error"] is None
    assert answer["token_ids"] == jeng.generate(
        [prompt], JGen(max_new_tokens=6))[0]
    jbroker = JBroker()
    jworker = JWorker(jeng, jbroker, rows=3, chunk_steps=2, group_chunks=2,
                      chunked_prefill=MODES[served["mode"]],
                      poll_timeout_s=0.01)
    req = JRequest(token_ids=prompt, max_new_tokens=6, prefix_token_ids=head)
    jbroker.push_request(req)
    end = time.monotonic() + 60
    while jbroker.wait_response(req.id, timeout=0.001) is None:
        assert time.monotonic() < end
        jworker.run_once()
    hashes = served["gate"].worker.load_snapshot()["prefix_hashes"]
    assert hashes == jworker.load_snapshot()["prefix_hashes"]
    assert len(hashes) == 1
    names = ("kv_block_evictions", "kv_evictions_demoted",
             "kv_evictions_dropped")
    status, _, payload = _get(served["port"], "/metrics")
    payload = json.loads(payload)
    assert status == 200 and all(payload[k] == 0 for k in names)
    lines = _get(served["port"], "/metrics?format=prometheus")[2].decode()
    for k in names:
        assert f"llmss_{k} 0" in lines.splitlines()


def test_drain_flips_health_to_503(served):
    """Runs last for its server: drained, the worker is dead to /health
    and /generate sheds with 503."""
    port, sup = served["port"], served["sup"]
    sup.drain(timeout_s=10)
    served["thread"].join(timeout=20)
    assert not served["thread"].is_alive()
    status, _, body = _get(port, "/health")
    assert status == 503 and json.loads(body)["status"] == "dead"
    time.sleep(tproducer.ProducerServer.STATE_MEMO_S)
    status, headers, body = _post(port, "/generate", {"token_ids": [1]})
    assert status == 503 and body["error"] == "worker dead"
    assert headers["Retry-After"] == "1"


# -- statuses without a worker --------------------------------------------------------


@pytest.fixture
def bare():
    """A ProducerServer with no worker: 0.3 s timeout, a queue of 2."""
    broker = InProcBroker()
    srv = tproducer.ProducerServer(broker, host="127.0.0.1", port=0,
                                   timeout_s=0.3, max_queue_depth=2)
    srv.start()
    try:
        yield srv, broker
    finally:
        srv.stop()


def test_client_errors_and_unknown_routes(bare):
    srv, broker = bare
    assert _post(srv.port, "/generate", b"{not json")[0] == 400
    status, _, body = _post(srv.port, "/generate", {"token_ids": [1],
                                                    "max_new_tokens": 0})
    assert status == 400 and "max_new_tokens" in body["error"]
    assert _post(srv.port, "/cancel", {"no": "id"})[0] == 400
    assert _post(srv.port, "/nowhere", {})[0] == 404
    assert _get(srv.port, "/nowhere")[0] == 404
    assert broker.queue_depth() == 0


def test_timeout_is_504_and_cancels(bare):
    srv, broker = bare
    status, _, body = _post(srv.port, "/generate", {"id": "slow",
                                                    "token_ids": [1]})
    assert status == 504 and body == {"error": "timed out", "id": "slow"}
    assert broker.check_cancelled(["slow"]) == {"slow"}
    req = broker.pop_request()
    assert req.id == "slow" and req.deadline_ts is not None


def test_full_queue_is_429_with_retry_after(bare):
    srv, broker = bare
    for i in range(2):
        broker.push_request(GenerateRequest(id=f"old{i}", token_ids=[1]))
    status, headers, body = _post(srv.port, "/generate", {"token_ids": [2]})
    assert status == 429 and body["error"] == "queue full"
    assert body["queue_depth"] == 2 and headers["Retry-After"] == "1"
    # Batch traffic is shed at half the depth.
    broker.pop_request()
    status, _, body = _post(srv.port, "/generate", {"token_ids": [2],
                                                    "slo_class": "batch"})
    assert status == 429 and body["slo_class"] == "batch"
    assert broker.queue_depth() == 1  # nothing shed was queued


def test_retry_after_follows_the_drain_rate():
    for mod in (rproducer, tproducer):
        est = mod.QueueDrainEstimator()
        est.note_admitted(10, now=0.0)
        est.note_admitted(6, now=1.0)  # 5 served in 1 s
        assert est.retry_after_s(20) == 4
        est.note_admitted(20, now=2.0)  # growing: nothing drains
        assert est.retry_after_s(20) == est.max_s


# -- /health and Prometheus against the reference -------------------------------------


def _blocks():
    now = time.time()
    base = dict(alive=True, state="ready", restarts=1, watchdog_stalls=0,
                last_error=None, heartbeat_s=0.5)
    return {
        "ready": {**base, "heartbeat_ts": now},
        "draining": {**base, "state": "draining", "heartbeat_ts": now},
        "dead": {**base, "state": "dead", "alive": False, "heartbeat_ts": now},
        "unhealthy": {**base, "alive": False, "heartbeat_ts": now,
                      "last_error": "RuntimeError: boom"},
        "stale": {**base, "heartbeat_ts": now - 10.0},
        "gone": None,
    }


def _without_age(body):
    return {k: v for k, v in body.items() if k != "heartbeat_age_s"}


@pytest.mark.parametrize("name", list(_blocks()))
def test_health_follows_the_reference_policy(name, bare):
    srv, broker = bare
    block = _blocks()[name]
    for saw in (False, True):
        r = rproducer.evaluate_worker_health(block, saw)
        t = tproducer.evaluate_worker_health(block, saw)
        assert (t[0], _without_age(t[1]), t[2]) == (
            r[0], _without_age(r[1]), r[2])
    # The server sees a live block first ("gone" is judged against it).
    broker.publish_metrics({"supervisor": _blocks()["ready"]})
    assert _get(srv.port, "/health")[0] == 200
    broker.publish_metrics({} if block is None else {"supervisor": block})
    status, _, body = _get(srv.port, "/health")
    want = rproducer.evaluate_worker_health(block, True)
    assert status == want[0] == (200 if name == "ready" else 503)
    assert _without_age(json.loads(body)) == _without_age(want[1])


PAYLOADS = {
    "served": {
        "requests_served": 16, "tokens_generated": 720, "errors": 0,
        "ttft": {"count": 15, "mean_ms": 12.5, "p50_ms": 10.0,
                 "p95_ms": 30.25, "p99_ms": None},
        "host_overhead": {"host_syncs": 9, "dispatch": {"count": 0}},
        "supervisor": {"alive": True, "state": "ready", "restarts": 2,
                       "heartbeat_ts": 1.5, "last_error": None},
        "delivery": {"queue_depth": 0, "broker_retries": 0},
        "queue_depths_by_class": {"interactive": 0, "standard": 3},
    },
    "fleet": {
        "flag": False, "name": "x", "nested": {"a": {"b": 2.5}},
        "workers": [{"worker_id": 'w"1\\\n', "load": 3}, {"nope": 1}],
        "fleet": {"routed_depths": {"w1": 2},
                  "workers": {"w1": {"inflight_rows": 4, "state": "ready"}}},
    },
}
SERIES = {"ttft_s": {"kind": "histogram", "bounds": [0.1, 1.0],
                     "counts": [3, 4], "sum": 2.3456789, "count": 9},
          "requests": {"kind": "counter", "total": 12}}


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_prometheus_text_equals_the_reference(name):
    p = PAYLOADS[name]
    assert tmetrics.render_prometheus(p) == rmetrics.render_prometheus(p)
    util = {"mfu": {"decode": 0.25, "prefill": 0.5}, "mbu": {"decode": 0.75}}
    assert tmetrics.render_prometheus(p, series=SERIES, util=util) == \
        rmetrics.render_prometheus(p, series=SERIES, util=util)
