"""The torch port's supervisor and worker lifecycle, and ``consumer.main``,
on the CPU (the cases of ``tests/test_supervisor.py`` and the host-only
ones of ``tests/test_lifecycle.py``).

Crashes rebuild the worker; the restart budget is a sliding window; the
backoff doubles, then resets after a stable run; a factory failure is a
crash; the health block survives the worker's own publishes; a hung loop
reads 503 at the producer within 3 x ``heartbeat_s`` and the watchdog
restarts it with every request answered once; a drain under load finishes
the rows in flight; ``consumer.main`` serves one request over a Redis
client and drains on SIGTERM. Every wait has a timeout and every thread
and server is stopped in a ``finally``."""

import json
import os
import signal
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import pytest
import torch
from safetensors.torch import save_file

from llmss_tpu.serve.chaos import FakeRedis
from llmss_tpu_torch.engine.engine import DecodeEngine, GenerationParams
from llmss_tpu_torch.models.common import DecoderConfig
from llmss_tpu_torch.models.decoder import init_params
from llmss_tpu_torch.models.registry import load_model
from llmss_tpu_torch.serve.broker import InProcBroker, RedisBroker
from llmss_tpu_torch.serve.consumer import ContinuousWorker
from llmss_tpu_torch.serve.consumer import main as consumer_main
from llmss_tpu_torch.serve.producer import ProducerServer
from llmss_tpu_torch.serve.protocol import (
    STATE_DEAD, STATE_READY, GenerateRequest,
)
from llmss_tpu_torch.serve.supervisor import Supervisor

CFG = DecoderConfig(
    model_type="llama", vocab_size=128, hidden_size=32, n_layers=1,
    n_heads=4, n_kv_heads=2, head_dim=8, intermediate_size=64,
    max_position_embeddings=64, activation="silu", norm="rmsnorm",
    mlp="swiglu", positions="rotary", rope_style="half", attn_bias=False,
    mlp_bias=False, dtype="float32",
)


class FlakyWorker:
    """Crashes on the iterations in ``crash_at`` (a global call count)."""

    calls = 0

    def __init__(self, crash_at, record):
        self.crash_at = crash_at
        self.record = record
        self.record.append("built")

    def run_once(self):
        FlakyWorker.calls += 1
        if FlakyWorker.calls in self.crash_at:
            raise RuntimeError(f"boom@{FlakyWorker.calls}")
        self.record.append(FlakyWorker.calls)


@pytest.fixture(autouse=True)
def _reset_calls():
    FlakyWorker.calls = 0


def _run_until(sup, stop_after_calls, record):
    stop = threading.Event()
    orig = FlakyWorker.run_once

    def wrapped(self):
        if FlakyWorker.calls >= stop_after_calls:
            stop.set()
            return
        orig(self)

    FlakyWorker.run_once = wrapped
    try:
        sup.run(stop)
    finally:
        FlakyWorker.run_once = orig


def test_restarts_after_crash():
    broker = InProcBroker()
    record = []
    sup = Supervisor(lambda: FlakyWorker({3, 7}, record), broker,
                     backoff_s=0.01, heartbeat_s=0.0)
    _run_until(sup, 12, record)
    assert sup.restarts == 2
    assert record.count("built") == 3
    assert "boom@7" in sup._last_error
    m = broker.read_metrics()["supervisor"]
    assert m["restarts"] == 2 and m["alive"] is True
    assert m["state"] == STATE_READY


def test_restart_budget_exhausted():
    broker = InProcBroker()
    sup = Supervisor(lambda: FlakyWorker(set(range(1, 100)), []), broker,
                     backoff_s=0.0, max_restarts=3, heartbeat_s=0.0)
    with pytest.raises(RuntimeError, match="restart budget"):
        sup.run()
    assert sup.restarts == 4
    m = broker.read_metrics()["supervisor"]
    assert m["alive"] is False and m["state"] == STATE_DEAD


def test_restart_budget_is_sliding_window():
    """``max_restarts`` bounds crashes since the last stable run, not the
    lifetime total."""

    def run_schedule(stable_after_s):
        calls = {"n": 0}
        stop = threading.Event()

        class W:
            def run_once(self):
                calls["n"] += 1
                if calls["n"] >= 9:
                    stop.set()
                    return
                if calls["n"] % 2 == 0:
                    raise RuntimeError(f"crash@{calls['n']}")

        sup = Supervisor(W, InProcBroker(), backoff_s=0.0, max_restarts=2,
                         stable_after_s=stable_after_s, heartbeat_s=0.0)
        sup.run(stop)
        return sup

    assert run_schedule(stable_after_s=0.0).restarts <= 1
    with pytest.raises(RuntimeError, match="restart budget"):
        run_schedule(stable_after_s=3600.0)


def test_factory_failure_is_contained():
    def bad_factory():
        raise OSError("cannot rebuild")

    broker = InProcBroker()
    sup = Supervisor(bad_factory, broker, backoff_s=0.0, max_restarts=2,
                     heartbeat_s=0.0)
    with pytest.raises(RuntimeError, match="restart budget"):
        sup.run()
    assert sup.restarts == 3
    assert "OSError: cannot rebuild" in broker.read_metrics()[
        "supervisor"]["last_error"]


def _paid_backoffs(stable_after_s):
    """The restart delay the supervisor was about to pay at each crash of
    a {crash@2, crash@6} schedule."""
    broker = InProcBroker()
    record, paid = [], []
    sup = None

    class Recording(FlakyWorker):
        def run_once(self):
            if FlakyWorker.calls + 1 in self.crash_at:
                paid.append(sup.backoff_current)
            super().run_once()

    sup = Supervisor(lambda: Recording({2, 6}, record), broker,
                     backoff_s=0.01, stable_after_s=stable_after_s,
                     heartbeat_s=0.0)
    _run_until(sup, 6, record)
    assert record.count("built") == 3
    return paid, broker


@pytest.mark.parametrize("stable_after_s,want", [
    (3600.0, [0.01, 0.02]),  # no stable run: the second crash pays double
    (0.0, [0.01, 0.01]),  # a stable run earns the backoff back
])
def test_backoff_grows_then_resets_after_stable_run(stable_after_s, want):
    paid, broker = _paid_backoffs(stable_after_s)
    assert paid == [pytest.approx(w) for w in want]
    assert "backoff_current_s" in broker.read_metrics()["supervisor"]


def test_status_survives_worker_publish():
    broker = InProcBroker()
    sup = Supervisor(lambda: None, broker, heartbeat_s=0.0)
    broker.publish_metrics({"tokens_generated": 5})  # a worker's publish
    m = broker.read_metrics()
    assert m["tokens_generated"] == 5
    assert m["supervisor"]["restarts"] == sup.restarts == 0


def test_clean_stop_leaves_the_last_heartbeat():
    broker = InProcBroker()
    sup = Supervisor(lambda: FlakyWorker(set(), []), broker, backoff_s=0.01,
                     heartbeat_s=0.0)
    _run_until(sup, 5, [])
    assert sup.restarts == 0 and sup.state == STATE_DEAD
    assert broker.read_metrics()["supervisor"]["alive"] is True


# -- a real worker on the CPU ----------------------------------------------------------


PROMPTS = [[1, 2, 3], [5, 9, 23, 4], [7, 7, 7, 7, 7], [40, 41], [3, 14, 15],
           [9, 26], [5, 35, 8, 9]]


@pytest.fixture(scope="module")
def engine():
    return DecodeEngine(CFG, init_params(CFG, seed=0, device="cpu"),
                        device="cpu", max_seq_len=64, kv_layout="paged",
                        block_size=8)


@pytest.fixture(scope="module")
def solo(engine):
    """Each prompt's 8 greedy tokens, generated alone."""
    return {tuple(p): engine.generate([p], GenerationParams(max_new_tokens=8))[0]
            for p in PROMPTS}


def _requests(prompts):
    return [GenerateRequest(token_ids=p, max_new_tokens=8,
                            deadline_ts=time.time() + 60) for p in prompts]


def _collect(broker, reqs, results, deadline):
    """Poll for the answers of ``reqs`` not in ``results`` until
    ``deadline`` (monotonic)."""
    while time.monotonic() < deadline and len(results) < len(reqs):
        for r in reqs:
            if r.id not in results:
                resp = broker.wait_response(r.id, timeout=0.02)
                if resp is not None:
                    results[r.id] = resp


def test_abort_inflight_errors_admitted_requests(engine):
    broker = InProcBroker()
    worker = ContinuousWorker(engine, broker, rows=2)
    broker.push_request(GenerateRequest(id="long", token_ids=[1, 2, 3],
                                        max_new_tokens=25))
    worker.run_once()  # admitted, far from finished
    assert worker.abort_inflight("boom") == 1
    resp = broker.wait_response("long", timeout=5)
    assert resp is not None and "worker restarted: boom" in resp.error
    assert worker.batcher.allocator.blocks_in_use == 0


def test_load_snapshot_and_progress_stamp(engine):
    broker = InProcBroker()
    worker = ContinuousWorker(engine, broker, rows=2)
    assert worker.last_progress_ts == 0.0  # nothing served yet
    for p in PROMPTS[:3]:
        broker.push_request(GenerateRequest(token_ids=p, max_new_tokens=8))
    worker.run_once()
    snap = worker.load_snapshot()
    assert worker.last_progress_ts > 0
    assert (snap["state"], snap["rows"], snap["inflight_rows"],
            snap["queue_depth"], snap["free_slots"]) == (STATE_READY, 2, 2, 1, 0)
    assert snap["kv_blocks_total"] == 16
    worker.begin_drain()
    assert worker.load_snapshot()["state"] == "draining"


def _broker_pair(kind):
    """(the producer's broker, the worker's broker) on one substrate."""
    if kind == "inproc":
        b = InProcBroker(lease_s=5.0)
        return b, b
    server = FakeRedis()
    return tuple(RedisBroker(client=server, worker_id=w, lease_s=5.0)
                 for w in ("producer", "worker"))


@pytest.mark.parametrize("kind", ["inproc", "redis"])
def test_drain_under_load_completes_inflight(engine, solo, kind):
    prod, wb = _broker_pair(kind)
    sup = Supervisor(lambda: ContinuousWorker(engine, wb, rows=2,
                                              chunk_steps=2),
                     wb, backoff_s=0.01, heartbeat_s=0.05)
    reqs = _requests(PROMPTS)
    for r in reqs:
        prod.push_request(r)
    stop = threading.Event()
    t = threading.Thread(target=sup.run, args=(stop,), daemon=True)
    t.start()
    results = {}
    try:
        _collect(prod, reqs[:2], results, time.monotonic() + 30)
        assert results, "nothing was served before the drain"
        sup.drain(timeout_s=20.0)
        t.join(timeout=30.0)
        assert not t.is_alive(), "the drain did not complete"
        _collect(prod, reqs, results, time.monotonic() + 5)
    finally:
        stop.set()
        t.join(timeout=10.0)
    # The worker had leased every request: the drain finishes all of them,
    # each once, with its solo tokens.
    assert len(results) == len(reqs)
    for r in reqs:
        got = results[r.id]
        assert got.error is None and got.token_ids == solo[tuple(r.token_ids)]
        assert prod.wait_response(r.id, timeout=0.01) is None
    stats = prod.delivery_stats()
    assert (stats["redelivered"], stats["inflight"], stats["queue_depth"]) == (
        0, 0, 0)
    assert sup.state == STATE_DEAD
    m = prod.read_metrics()
    assert m["supervisor"]["state"] == STATE_DEAD
    assert m["supervisor"]["alive"] is False
    assert m["worker"]["state"] == "draining"


class HangOnce:
    """A ContinuousWorker whose ``at``-th ``run_once`` stalls in Python
    (where the watchdog's exception can land) for 10 s at most."""

    def __init__(self, worker, at, entered):
        self.worker, self.at, self.entered, self.calls = worker, at, entered, 0

    def __getattr__(self, name):
        return getattr(self.worker, name)

    def run_once(self):
        self.calls += 1
        if self.calls != self.at:
            return self.worker.run_once()
        self.entered.set()
        end = time.monotonic() + 10.0
        while time.monotonic() < end:
            time.sleep(0.005)
        raise AssertionError("the watchdog never fired")


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=5) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_hang_flips_health_and_watchdog_restarts(engine, solo):
    """A loop that hangs after serving reads 503 at the producer within
    3 x heartbeat_s; the watchdog escalates it as a crash; the rebuilt
    worker serves what arrived meanwhile; every request is answered once."""
    broker = InProcBroker()
    entered = threading.Event()
    built = []

    def factory():
        w = ContinuousWorker(engine, broker, rows=2, chunk_steps=2)
        built.append(w)
        return HangOnce(w, 3, entered) if len(built) == 1 else w

    heartbeat_s = 0.1
    sup = Supervisor(factory, broker, backoff_s=0.01, heartbeat_s=heartbeat_s,
                     step_timeout_s=0.6)
    srv = ProducerServer(broker, host="127.0.0.1", port=0)
    early, late = _requests(PROMPTS[:4]), _requests(PROMPTS[4:])
    for r in early:
        broker.push_request(r)
    stop = threading.Event()
    t = threading.Thread(target=sup.run, args=(stop,), daemon=True)
    srv.start()
    t.start()
    results = {}
    try:
        assert entered.wait(timeout=30), "the worker never reached the hang"
        t0 = time.monotonic()
        for r in late:
            broker.push_request(r)
        code, body = 200, {}
        while time.monotonic() - t0 < 5.0 and code == 200:
            code, body = _get(srv.port, "/health")
            time.sleep(0.01)
        flipped_after = time.monotonic() - t0
        assert code == 503, "health never flipped on the hung loop"
        assert body["status"] == "stale-heartbeat"
        assert flipped_after < 3 * heartbeat_s + 0.3
        _collect(broker, early + late, results, time.monotonic() + 30)
    finally:
        stop.set()
        t.join(timeout=10.0)
        srv.stop()
    assert not t.is_alive()
    assert sup.watchdog_stalls == 1 and len(built) == 2
    assert "WatchdogTimeout" in (sup._last_error or "")
    assert len(results) == len(early) + len(late)
    for r in early + late:
        got = results[r.id]
        assert broker.wait_response(r.id, timeout=0.01) is None  # once
        if got.error is not None:  # held by the hung worker
            assert r in early and "worker restarted: WatchdogTimeout" in got.error
        else:
            assert got.token_ids == solo[tuple(r.token_ids)]
    # What arrived during the hang was served by the rebuilt worker.
    assert all(results[r.id].error is None for r in late)


# -- consumer.main ---------------------------------------------------------------------


def _write_checkpoint(path):
    """A 1-layer llama checkpoint in HF names: config.json and
    model.safetensors."""
    E, V, I, L = CFG.hidden_size, CFG.vocab_size, CFG.intermediate_size, 1
    KV = CFG.n_kv_heads * CFG.head_dim
    g = torch.Generator().manual_seed(0)

    def w(*s):
        return torch.randn(s, generator=g) * 0.05

    t = {"model.embed_tokens.weight": w(V, E), "model.norm.weight": 1 + w(E),
         "lm_head.weight": w(V, E)}
    for i in range(L):
        p = f"model.layers.{i}"
        t.update({
            f"{p}.input_layernorm.weight": 1 + w(E),
            f"{p}.post_attention_layernorm.weight": 1 + w(E),
            f"{p}.self_attn.q_proj.weight": w(E, E),
            f"{p}.self_attn.k_proj.weight": w(KV, E),
            f"{p}.self_attn.v_proj.weight": w(KV, E),
            f"{p}.self_attn.o_proj.weight": w(E, E),
            f"{p}.mlp.gate_proj.weight": w(I, E),
            f"{p}.mlp.up_proj.weight": w(I, E),
            f"{p}.mlp.down_proj.weight": w(E, I),
        })
    save_file(t, str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps({
        "model_type": "llama", "vocab_size": V, "hidden_size": E,
        "num_hidden_layers": L, "num_attention_heads": CFG.n_heads,
        "num_key_value_heads": CFG.n_kv_heads, "intermediate_size": I,
        "max_position_embeddings": 64, "hidden_act": "silu",
        "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
        "tie_word_embeddings": False,
    }))


def test_consumer_main_serves_then_drains_on_sigterm(tmp_path, monkeypatch):
    """``main --device cpu --continuous --supervise`` over a Redis client
    (the ``redis`` module replaced by one that hands out a FakeRedis):
    one request answered with the checkpoint's tokens, a text prompt
    refused for want of a tokenizer, then a SIGTERM sent to this process
    drains the worker and ``main`` returns."""
    _write_checkpoint(tmp_path)
    server = FakeRedis()
    monkeypatch.setitem(sys.modules, "redis", types.SimpleNamespace(
        Redis=lambda host, port: server))
    client = RedisBroker(client=server, worker_id="client")
    req = GenerateRequest(token_ids=[1, 2, 3, 4, 5], max_new_tokens=6)
    text = GenerateRequest(prompt="hello", max_new_tokens=2)
    client.push_request(req)
    client.push_request(text)
    got = {}

    def drive():
        try:
            got["req"] = client.wait_response(req.id, timeout=60)
            got["text"] = client.wait_response(text.id, timeout=10)
            got["health"] = client.read_metrics().get("supervisor", {})
        finally:
            os.kill(os.getpid(), signal.SIGTERM)

    # Whatever the timing, a SIGTERM outside main lands here, not in the
    # default handler.
    previous = signal.signal(signal.SIGTERM, lambda *a: None)
    th = threading.Thread(target=drive, daemon=True)
    try:
        th.start()
        consumer_main([
            "--pretrained_model_path", str(tmp_path), "--device", "cpu",
            "--dtype", "float32", "--continuous", "--supervise",
            "--kv_layout", "paged", "--chunked_prefill", "4",
            "--max_seq_len", "32", "--batch_size", "2", "--chunk_steps", "2",
            "--drain_timeout_s", "10",
        ])
        th.join(timeout=15)
    finally:
        signal.signal(signal.SIGTERM, previous)
    assert not th.is_alive()
    cfg, params = load_model(tmp_path, device="cpu", dtype="float32")
    eng = DecodeEngine(cfg, params, device="cpu", max_seq_len=32)
    assert got["req"].error is None
    assert got["req"].token_ids == eng.generate(
        [req.token_ids], GenerationParams(max_new_tokens=6))[0]
    assert "no tokenizer" in got["text"].error
    assert got["health"]["state"] == STATE_READY
    assert client.read_metrics()["supervisor"]["state"] == STATE_DEAD
