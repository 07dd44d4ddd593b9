"""The torch port's fleet controller (``serve/controller.py``) against the
JAX package's, on the CPU. The reference's non-simulator cases run on
the port's modules, each on both brokers (in-process and a RedisBroker
over ``chaos.FakeRedis``), ticking ``FleetController.tick(now=...)`` on a
virtual timeline against a real registry: scale-up on sustained burn,
scale-down to the floor, hysteresis, stale telemetry holds, cooldown,
the last-routable and ceiling guards, registry staleness, epoch fencing
(also across the two packages on one Redis), crash-restart
reconciliation, the escalation contract with the brownout ladder, P:D
reshaping, the producer's honest Retry-After, the supervisor's drain
guard, and a retired worker's leases refunded. One schedule of telemetry
and registry changes through both packages' controllers gives the same
actions and counters."""

import threading
import time

import numpy as np
import pytest

import llmss_tpu.serve.broker as rbroker
import llmss_tpu.serve.controller as rcontroller
import llmss_tpu_torch.serve.controller as tcontroller
from llmss_tpu_torch.serve.broker import InProcBroker, RedisBroker
from llmss_tpu_torch.serve.chaos import FakeRedis, ScriptedEngine
from llmss_tpu_torch.serve.consumer import Worker
from llmss_tpu_torch.serve.controller import FleetController
from llmss_tpu_torch.serve.producer import (
    QueueDrainEstimator, admission_verdict,
)
from llmss_tpu_torch.serve.protocol import STATE_DEAD, GenerateRequest
from llmss_tpu_torch.serve.supervisor import Supervisor

BROKER_KINDS = ("inproc", "fakeredis")


def make_brokers(kind, *, lease_s=5.0, max_attempts=6, n_workers=1):
    """(producer_broker, [worker_broker, ...]) on one substrate."""
    if kind == "inproc":
        b = InProcBroker(lease_s=lease_s, max_delivery_attempts=max_attempts)
        return b, [b] * n_workers
    server = FakeRedis()

    def mk(wid):
        return RedisBroker(client=server, worker_id=wid, lease_s=lease_s,
                           max_delivery_attempts=max_attempts)

    return mk("producer"), [mk(f"worker{i}") for i in range(n_workers)]


def broker_of(kind):
    return make_brokers(kind)[0]


class Tel:
    """Telemetry the tests steer tick by tick."""

    def __init__(self):
        self.now = 0.0
        self.burn = 1.0
        self.depth = 0
        self.util: dict = {}
        self.down = False
        self.ts_lag = 0.0

    def read(self):
        if self.down:
            return None
        return {"ts": self.now - self.ts_lag, "burn": self.burn,
                "queue_depth": self.depth, "handoff_depth": 0,
                "util": dict(self.util)}


def put_worker(broker, wid, *, role="unified", state="ready", hb_age=0.0,
               alive=True, hb_s=1.0):
    broker.publish_worker_load(wid, {
        "role": role, "state": state, "alive": alive,
        "heartbeat_ts": time.time() - hb_age, "heartbeat_s": hb_s})


def make_ctrl(broker, tel, *, spawned=None, retired=None, module=tcontroller,
              **kw):
    """A controller with recording actuators; spawns register starting."""
    spawned = spawned if spawned is not None else []
    retired = retired if retired is not None else []

    def spawn(role):
        wid = f"new-{len(spawned)}"
        spawned.append((role, wid))
        put_worker(broker, wid, role=role, state="starting")
        return wid

    def retire(wid):
        retired.append(wid)
        put_worker(broker, wid, state="draining")

    kw.setdefault("check_s", 0.5)
    kw.setdefault("cooldown_s", 1.0)
    kw.setdefault("dwell_s", 1.0)
    kw.setdefault("cold_start_s", 1.0)
    kw.setdefault("burn_headroom_s", 10.0)
    kw.setdefault("floor", 1)
    kw.setdefault("ceiling", 4)
    ctrl = module.FleetController(broker, spawn=spawn, retire=retire,
                                  read_telemetry=tel.read, **kw)
    return ctrl, spawned, retired


def drive(ctrl, tel, t0, t1, step=0.5):
    """Tick over [t0, t1]; returns the actions taken."""
    actions = []
    t = t0
    while t <= t1 + 1e-9:
        tel.now = t
        a = ctrl.tick(now=t)
        if a is not None:
            actions.append(dict(a, t=t))
        t += step
    return actions


# -- scaling, hysteresis, holds ------------------------------------------------


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_scale_up_on_sustained_burn(kind):
    broker = broker_of(kind)
    put_worker(broker, "w0")
    tel = Tel()
    ctrl, spawned, _ = make_ctrl(broker, tel)
    ctrl.start()
    tel.burn = 2.5
    acts = drive(ctrl, tel, 0.0, 1.0)
    assert [(a["kind"], a["role"]) for a in acts] == [("spawn", "unified")]
    assert spawned == [("unified", "new-0")]
    assert acts[0]["t"] >= ctrl.dwell_s


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_scale_down_retires_to_floor_and_stops(kind):
    broker = broker_of(kind)
    for wid in ("w0", "w1", "w2"):
        put_worker(broker, wid)
    tel = Tel()
    ctrl, _, retired = make_ctrl(broker, tel)
    ctrl.start()
    tel.burn = 0.1
    drive(ctrl, tel, 0.0, 12.0)
    assert retired == ["w2", "w1"]  # newest first
    assert ctrl.counters["retires"] == 2
    obs = ctrl.observe()
    assert obs["unified"]["ready"] == 1
    assert ctrl._guard({"kind": "retire", "role": "unified"}, obs) == "floor"
    assert ctrl.counters["blocked_floor"] == 1


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_flapping_pressure_never_moves_the_fleet(kind):
    broker = broker_of(kind)
    put_worker(broker, "w0")
    tel = Tel()
    ctrl, spawned, retired = make_ctrl(broker, tel)
    ctrl.start()
    t = 0.0
    while t <= 10.0:
        tel.now = t
        tel.burn = 2.5 if int(t * 2) % 2 == 0 else 1.0
        ctrl.tick(now=t)
        t += 0.5
    assert spawned == [] and retired == [] and ctrl.counters["ticks"] > 0


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_stale_telemetry_holds_and_resets_dwell(kind):
    broker = broker_of(kind)
    put_worker(broker, "w0")
    tel = Tel()
    ctrl, spawned, _ = make_ctrl(broker, tel)
    ctrl.start()
    tel.burn = 2.5
    drive(ctrl, tel, 0.0, 0.5)
    tel.down = True
    drive(ctrl, tel, 1.0, 1.5)
    assert ctrl.counters["held_stale"] == 2 and spawned == []
    tel.down = False
    acts = drive(ctrl, tel, 2.0, 3.5)
    assert spawned != [] and acts[0]["t"] >= 2.0 + ctrl.dwell_s


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_stale_ts_field_is_a_hold_too(kind):
    broker = broker_of(kind)
    put_worker(broker, "w0")
    tel = Tel()
    ctrl, spawned, _ = make_ctrl(broker, tel, telemetry_max_age_s=2.0)
    ctrl.start()
    tel.burn = 2.5
    tel.ts_lag = 10.0
    drive(ctrl, tel, 0.0, 3.0)
    assert spawned == [] and ctrl.counters["held_stale"] == 7


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_cooldown_allows_one_actuation_per_window(kind):
    broker = broker_of(kind)
    put_worker(broker, "w0")
    tel = Tel()
    ctrl, spawned, _ = make_ctrl(broker, tel, cooldown_s=6.0)
    ctrl.start()
    tel.burn = 3.0
    acts = drive(ctrl, tel, 0.0, 11.0)
    assert len(acts) == 2 and acts[1]["t"] - acts[0]["t"] >= 6.0
    assert ctrl.counters["held_cooldown"] > 0
    assert [r for r, _ in spawned] == ["unified", "unified"]


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_never_drains_last_routable_even_with_zero_floor(kind):
    broker = broker_of(kind)
    put_worker(broker, "w0")
    tel = Tel()
    ctrl, _, retired = make_ctrl(broker, tel, floor=0)
    ctrl.start()
    tel.burn = 0.0
    drive(ctrl, tel, 0.0, 6.0)
    assert retired == []
    obs = ctrl.observe()
    assert ctrl._guard({"kind": "retire", "role": "unified"}, obs) == \
        "last-routable"
    assert ctrl.counters["blocked_last_routable"] == 1


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_ceiling_blocks_spawn(kind):
    broker = broker_of(kind)
    for wid in ("w0", "w1"):
        put_worker(broker, wid)
    tel = Tel()
    ctrl, spawned, _ = make_ctrl(broker, tel, ceiling=2)
    ctrl.start()
    tel.burn = 3.0
    drive(ctrl, tel, 0.0, 6.0)
    assert spawned == [] and ctrl.counters["blocked_ceiling"] > 0


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_observe_skips_dead_and_stale_rows(kind):
    broker = broker_of(kind)
    put_worker(broker, "fresh")
    put_worker(broker, "killed", hb_age=60.0)
    put_worker(broker, "tombstone", alive=False)
    put_worker(broker, "starting", state="starting")
    ctrl, _, _ = make_ctrl(broker, Tel())
    obs = ctrl.observe()
    assert obs["unified"]["ready"] == 1
    assert obs["unified"]["ready_ids"] == ["fresh"]
    assert obs["unified"]["starting"] == 1
    assert ctrl._live(obs, "unified") == 2


# -- epoch fencing, crash and restart ------------------------------------------------


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_stale_epoch_controller_is_fully_fenced(kind):
    broker = broker_of(kind)
    put_worker(broker, "w0")
    tel = Tel()
    old, old_spawned, old_retired = make_ctrl(broker, tel,
                                              controller_id="old")
    assert old.start() == 1
    new, new_spawned, _ = make_ctrl(broker, tel, controller_id="new")
    assert new.start() == 2
    assert broker.controller_holder() == "new"
    assert broker.controller_epoch() == 2
    tel.burn = 3.0
    drive(old, tel, 0.0, 5.0)
    assert old_spawned == [] and old_retired == []
    assert old.counters["fenced"] > 0
    acts = drive(new, tel, 5.5, 7.0)
    assert new_spawned != [] and acts


def test_epoch_is_one_fence_across_the_packages():
    """On one Redis the port's and the reference's brokers share
    ``{pqueue}:ctrl:epoch`` and its holder: a controller of either
    package fences the other's."""
    server = FakeRedis()
    port = RedisBroker(client=server, worker_id="p")
    ref = rbroker.RedisBroker(client=server, worker_id="r")
    assert port.controller_epoch() == ref.controller_epoch() == 0
    assert port.controller_holder() == ref.controller_holder() == ""
    assert port.acquire_controller_epoch("port-ctrl") == 1
    assert ref.controller_epoch() == 1
    assert ref.controller_holder() == "port-ctrl"
    assert ref.acquire_controller_epoch("ref-ctrl") == 2
    assert port.controller_epoch() == 2
    assert port.controller_holder() == "ref-ctrl"
    assert server.get("pqueue:ctrl:epoch") == b"2"


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_crash_restart_never_duplicates_inflight_spawns(kind):
    broker = broker_of(kind)
    put_worker(broker, "w0")
    tel = Tel()
    first, spawned, _ = make_ctrl(broker, tel, ceiling=2)
    first.start()
    tel.burn = 3.0
    drive(first, tel, 0.0, 1.0)
    assert len(spawned) == 1
    second, spawned2, _ = make_ctrl(broker, tel, ceiling=2)
    second.start()
    drive(second, tel, 2.0, 8.0)
    assert spawned2 == [] and second.counters["blocked_ceiling"] > 0
    assert second.observe()["unified"]["starting"] == 1


# -- the escalation contract ----------------------------------------------------------


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_escalation_suppressed_while_scaling_can_respond(kind):
    broker = broker_of(kind)
    put_worker(broker, "w0")
    tel = Tel()
    ctrl, _, _ = make_ctrl(broker, tel, cold_start_s=2.0,
                           burn_headroom_s=10.0)
    ctrl.start()
    tel.now = 1.0
    assert ctrl.escalation_allowed(now=1.0) is False
    assert ctrl.counters["escalations_suppressed"] == 1


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_escalation_allowed_when_cold_start_exceeds_headroom(kind):
    broker = broker_of(kind)
    put_worker(broker, "w0")
    tel = Tel()
    ctrl, _, _ = make_ctrl(broker, tel, cold_start_s=30.0,
                           burn_headroom_s=10.0)
    ctrl.start()
    tel.now = 1.0
    assert ctrl.escalation_allowed(now=1.0) is True
    assert ctrl.counters["escalations_allowed"] == 1


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_escalation_allowed_at_ceiling_and_when_blind(kind):
    broker = broker_of(kind)
    put_worker(broker, "w0")
    put_worker(broker, "w1", state="starting")
    tel = Tel()
    ctrl, _, _ = make_ctrl(broker, tel, ceiling=2, cold_start_s=2.0,
                           burn_headroom_s=10.0)
    ctrl.start()
    tel.now = 1.0
    assert ctrl.escalation_allowed(now=1.0) is True
    tel.down = True
    assert ctrl.escalation_allowed(now=2.0) is True
    assert ctrl.counters["escalations_allowed"] == 2


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_reshape_spawns_before_retiring_donor(kind):
    broker = broker_of(kind)
    for wid in ("p0", "p1"):
        put_worker(broker, wid, role="prefill")
    for wid in ("d0", "d1"):
        put_worker(broker, wid, role="decode")
    tel = Tel()
    ctrl, spawned, retired = make_ctrl(
        broker, tel, roles=("prefill", "decode"),
        floor={"prefill": 1, "decode": 1})
    ctrl.start()
    tel.util = {"prefill": 0.95, "decode": 0.1}
    acts = drive(ctrl, tel, 0.0, 2.0)
    assert [(a["kind"], a["role"]) for a in acts] == \
        [("reshape-spawn", "prefill")]
    assert ctrl.state()["reshape_debt"] == "decode" and retired == []
    put_worker(broker, spawned[0][1], role="prefill")
    tel.util = {}
    acts = drive(ctrl, tel, 2.5, 5.0)
    assert [(a["kind"], a["role"]) for a in acts] == \
        [("reshape-retire", "decode")]
    assert retired == ["d1"]
    assert ctrl.counters["reshape_spawns"] == ctrl.counters[
        "reshape_retires"] == 1


# -- one schedule through both packages ---------------------------------------------


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_same_schedule_same_decisions_as_the_reference(seed):
    """Seeded burn, backlog and utilization, registry kills and stale
    telemetry through both packages' controllers over their own
    in-process brokers: the same actions at the same ticks, the same
    counters and the same state."""
    rng = np.random.default_rng(seed)
    schedule = []
    for _ in range(60):
        schedule.append({
            "burn": float(rng.choice([0.1, 1.0, 2.5, 3.0])),
            "depth": int(rng.choice([0, 0, 2, 20])),
            "util": {"unified": float(rng.uniform(0, 1))},
            "down": bool(rng.random() < 0.1),
            "kill": bool(rng.random() < 0.05)})
    results = []
    for bmod, cmod in ((rbroker, rcontroller), (None, tcontroller)):
        broker = (bmod.InProcBroker() if bmod is not None else InProcBroker())
        put_worker(broker, "w0")
        put_worker(broker, "w1")
        tel = Tel()
        ctrl, spawned, retired = make_ctrl(broker, tel, module=cmod,
                                           ceiling=5)
        ctrl.start()
        acts = []
        for i, ev in enumerate(schedule):
            t = 0.5 * i
            tel.now, tel.burn, tel.depth = t, ev["burn"], ev["depth"]
            tel.util, tel.down = ev["util"], ev["down"]
            if ev["kill"] and spawned:
                put_worker(broker, spawned[-1][1], alive=False)
            a = ctrl.tick(now=t)
            if a is not None:
                acts.append((t, a))
            for _role, wid in spawned:
                info = broker.read_workers().get(wid)
                if info and info.get("state") == "starting" and (
                        info.get("alive") is not False):
                    put_worker(broker, wid)  # cold start done
        state = ctrl.state()
        results.append((acts, spawned, retired, ctrl.counters,
                        {k: v for k, v in state.items()}))
    assert results[1] == results[0]


# -- the producer's honest Retry-After ----------------------------------------------


def test_retry_after_tracks_queue_drain_rate():
    est = QueueDrainEstimator(window_s=30.0, min_s=1, max_s=30)
    assert est.retry_after_s(50, now=0.0) == 1
    for i in range(21):
        est.note_admitted(depth=10, now=float(i) / 2.0)
    assert est.retry_after_s(10, now=10.0) == 5
    assert est.retry_after_s(30, now=10.0) == 15
    assert est.retry_after_s(2, now=10.0) == 1
    est2 = QueueDrainEstimator(window_s=30.0, max_s=30)
    est2.note_admitted(depth=0, now=0.0)
    est2.note_admitted(depth=50, now=5.0)
    assert est2.retry_after_s(50, now=5.0) == 30


def test_admission_verdict_derives_retry_after_from_estimator():
    broker = InProcBroker()
    for i in range(8):
        broker.push_request(GenerateRequest(id=f"q{i}", token_ids=[1],
                                            max_new_tokens=1))
    est = QueueDrainEstimator()
    for i in range(11):
        est.note_admitted(depth=8, now=float(i))
    req = GenerateRequest(id="shed-me", token_ids=[1], max_new_tokens=1)
    status, body, headers = admission_verdict(req, broker,
                                              max_queue_depth=4, drain=est)
    assert status == 429 and body["queue_depth"] == 8
    assert headers["Retry-After"] == str(est.retry_after_s(8))
    assert int(headers["Retry-After"]) >= 8
    _, _, h = admission_verdict(req, broker, max_queue_depth=4)
    assert h["Retry-After"] == "1"


# -- the supervisor's drain guard and a retired worker's refunds ---------------------


class _HeldRegistry:
    """A worker broker whose registry writes the test can hold: while the
    test holds ``lock`` no other thread's publish lands (the supervisor's
    heartbeat waits), so the entry it reads is the one its own calls left.
    (The Redis form merges a registry entry by read, update and write, so
    a heartbeat racing the drain guard's publish could drop its field.)
    Everything else is the broker's own."""

    def __init__(self, broker):
        object.__setattr__(self, "_broker", broker)
        object.__setattr__(self, "lock", threading.RLock())

    def __getattr__(self, name):
        return getattr(self._broker, name)

    def __setattr__(self, name, value):
        setattr(self._broker, name, value)

    def publish_worker_load(self, worker_id, snapshot):
        with self.lock:
            self._broker.publish_worker_load(worker_id, snapshot)


def _supervised(engine, wb, worker_id, heartbeat_s=0.05):
    def factory():
        return Worker(engine, wb, batch_size=2, poll_timeout_s=0.02,
                      worker_id=worker_id,
                      snapshot_interval_s=max(1.0, heartbeat_s))

    sup = Supervisor(factory, wb, backoff_s=0.01, heartbeat_s=heartbeat_s)
    stop = threading.Event()
    t = threading.Thread(target=sup.run, args=(stop,), daemon=True)
    t.start()
    return sup, t


def _wait_routable(prod, wid, timeout_s=10.0):
    from llmss_tpu_torch.serve.fleet import routable_workers

    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if wid in routable_workers(prod):
            return
        time.sleep(0.02)
    raise AssertionError(f"{wid} never became routable")


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_drain_guard_blocks_last_routable_until_forced(kind):
    prod, (wb,) = make_brokers(kind)
    wb = _HeldRegistry(wb)
    # Heartbeats of 30 s: the entry stays routable however slowly a loaded
    # machine runs the test (at 0.05 s it read stale after 0.15 s).
    sup, t = _supervised(ScriptedEngine(), wb, "guard-zz", heartbeat_s=30.0)
    try:
        _wait_routable(prod, "guard-zz")
        with wb.lock:  # no heartbeat between the refusal and the read
            assert sup.drain(timeout_s=5.0) is False and not sup.draining
            assert "last routable" in prod.read_workers()["guard-zz"][
                "drain_blocked"]
        assert sup.drain(timeout_s=5.0, force=True) is True
        t.join(timeout=20.0)
        assert not t.is_alive()
        assert prod.read_workers()["guard-zz"]["state"] == STATE_DEAD
    finally:
        sup.drain(force=True)


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_drain_guard_allows_with_routable_peer(kind):
    prod, (wb1, wb2) = make_brokers(kind, n_workers=2)
    sup, t = _supervised(ScriptedEngine(), wb1, "guard-zz")
    try:
        _wait_routable(prod, "guard-zz")
        Worker(ScriptedEngine(), wb2, batch_size=2, poll_timeout_s=0.02,
               worker_id="guard-aa")
        _wait_routable(prod, "guard-aa")
        assert sup.drain(timeout_s=5.0) is True
        t.join(timeout=20.0)
        assert not t.is_alive()
    finally:
        sup.drain(force=True)


@pytest.mark.parametrize("kind", BROKER_KINDS)
def test_controller_retire_drains_and_refunds_leases(kind):
    """A worker the controller retires while it holds leased work gives
    the unstarted work back as refunds: no redelivery, no attempt spent
    (``max_attempts=1`` would dead-letter any), no failover sweep; the
    survivor serves it."""
    from llmss_tpu_torch.engine.engine import DecodeEngine
    from llmss_tpu_torch.models.common import DecoderConfig
    from llmss_tpu_torch.models.decoder import init_params
    from llmss_tpu_torch.serve.consumer import ContinuousWorker
    from llmss_tpu_torch.serve.fleet import Router

    cfg = DecoderConfig(
        model_type="llama", vocab_size=128, hidden_size=32, n_layers=1,
        n_heads=4, n_kv_heads=4, head_dim=8, intermediate_size=64,
        max_position_embeddings=64, activation="silu", norm="rmsnorm",
        mlp="swiglu", positions="rotary", rope_style="half", rotary_dim=8,
        attn_bias=False, mlp_bias=False, dtype="float32")
    eng = DecodeEngine(cfg, init_params(cfg, seed=0, device="cpu"),
                       device="cpu", max_seq_len=32)
    prod, (wb1, wb2) = make_brokers(kind, max_attempts=1, n_workers=2)
    # Heartbeats of 30 s: the registry stays fresh however slowly a loaded
    # machine runs the test (the controller judges staleness on the wall
    # clock).
    w_old = ContinuousWorker(eng, wb1, rows=2, poll_timeout_s=0.0,
                             chunk_steps=2, worker_id="ret-zz",
                             snapshot_interval_s=30.0)
    w_new = ContinuousWorker(eng, wb2, rows=2, poll_timeout_s=0.0,
                             chunk_steps=2, worker_id="ret-aa",
                             snapshot_interval_s=30.0)
    reqs = [GenerateRequest(id=f"ret{i}", token_ids=[1 + i, 2],
                            max_new_tokens=3, is_greedy=True)
            for i in range(6)]
    for r in reqs:
        prod.push_request(r)
    w_old.run_once()
    assert prod.queue_depth() == 0
    calls = []

    def retire(wid):
        calls.append(wid)
        w_old.begin_drain()
        assert w_old.release_pending() == 4

    w_old._publish_load()
    w_new._publish_load()
    tel = Tel()
    tel.burn = 0.1
    ctrl = FleetController(prod, spawn=lambda role: "never", retire=retire,
                           read_telemetry=tel.read, floor=1, ceiling=4,
                           check_s=0.5, cooldown_s=1.0, dwell_s=1.0)
    ctrl.start()
    drive(ctrl, tel, 0.0, 2.0)
    assert calls == ["ret-zz"]
    router = Router(prod, policy="least_loaded")
    assert router.check_failover(force=True) == 0
    assert router.stats()["failover_reroutes"] == 0
    deadline = time.time() + 120.0
    while not w_old.batcher.idle and time.time() < deadline:
        w_old.run_once()
    assert w_old.drained
    got = {}
    while len(got) < len(reqs) and time.time() < deadline:
        w_new.run_once()
        for r in reqs:
            if r.id not in got:
                resp = prod.wait_response(r.id, timeout=0.001)
                if resp is not None:
                    got[r.id] = resp
    assert set(got) == {r.id for r in reqs}
    assert all(resp.error is None for resp in got.values())
    stats = prod.delivery_stats()
    assert stats.get("redelivered", 0) == 0 and stats.get("inflight", 0) == 0
    assert prod.read_dlq(limit=100) == []


def test_producer_telemetry_equals_the_reference():
    """``producer_telemetry`` over a live producer of each package, on the
    same backlog, series and folds: the interactive burn of its /slo, the
    broker's backlog (the routed queues counted twice, as the reference
    counts them: ``queue_depth`` already holds them) and devtel's phase
    utilization; None (hold) when a read fails."""
    import llmss_tpu.serve.producer as rproducer
    import llmss_tpu.serve.protocol as rproto
    import llmss_tpu.utils.devtel as rdevtel
    import llmss_tpu.utils.metrics as rmetrics
    from llmss_tpu_torch.serve.producer import ProducerServer
    from llmss_tpu_torch.utils import devtel
    from llmss_tpu_torch.utils import metrics as metrics_mod

    out = []
    for bmod, pmod, proto, dt, m, cmod in (
            (rbroker, rproducer, rproto, rdevtel, rmetrics, rcontroller),
            (None, None, None, devtel, metrics_mod, tcontroller)):
        dt.reset()
        m.series().clear()
        broker = bmod.InProcBroker() if bmod else InProcBroker()
        req = proto.GenerateRequest if proto else GenerateRequest
        for i in range(3):
            broker.push_request(req(id=f"b{i}", token_ids=[1],
                                    max_new_tokens=1))
        broker.push_request_to("w9", req(id="r0", token_ids=[1],
                                         max_new_tokens=1))
        for v in (9.0, 9.0, 0.2, 9.0):
            m.observe_request_cost({"ok": True, "ttft_s": v,
                                    "slo_class": "interactive"})
        dt.fold("decode_group", 0.1, dt.KernelCost(1e12, 1e11, "analytical"))
        srv = (pmod.ProducerServer if pmod else ProducerServer)(
            broker, host="127.0.0.1", port=0)
        try:
            read = cmod.producer_telemetry(srv)
            tel = read()
            srv.broker = None
            assert read() is None
        finally:
            srv._server.server_close()
            dt.reset()
            m.series().clear()
        tel.pop("ts")
        out.append(tel)
    assert out[1]["queue_depth"] == 5 and out[1]["burn"] == 15.0
    assert out[1]["util"]["decode"] > 0
    assert out[1].keys() == out[0].keys()
    assert {k: v for k, v in out[1].items() if k != "util"} == \
        {k: v for k, v in out[0].items() if k != "util"}
