"""The fleet: the registry's view, routing policies, failover and the
brownout ladder (counterpart: llmss_tpu/serve/fleet.py).

Over the broker's registry and routed queues (serve/broker.py):

- **Registry**: workers register a ``worker_id`` with their capabilities
  and publish load snapshots (lifecycle state, in-flight rows, free KV
  blocks, queue depth, resident prefix hashes, and the ``heartbeat_ts`` /
  ``heartbeat_s`` stamps the supervisor's block carries), so one policy,
  ``producer.evaluate_worker_health``, judges both.
- **Router**: places each request on one replica's routed queue:

  - ``round_robin``: a rotation over the routable replicas;
  - ``least_loaded``: the fewest in-flight rows plus pending plus routed
    backlog (the broker's live ``routed_depths``: snapshots lag, and a
    burst routed on them would pile onto one replica), then the most free
    KV blocks, then the lowest id;
  - ``prefix_affinity``: a request with ``prefix_token_ids`` goes to the
    replica that owns that prefix (the sticky owner map, then the
    snapshots' ``prefix_hashes``, then least-loaded, which becomes the
    owner): a shared system prompt is prefilled once per owning replica.

  Decode-role replicas take no raw requests. With no routable replica a
  request goes to the shared queue: a fleet scaled to zero serves as a
  single worker does.
- **Failover**: a registered worker judged dead, stale or unhealthy that
  holds work, or a routed queue whose worker left the registry, is
  evacuated through ``broker.failover_worker`` (routed requests move
  whole; leases are force-expired through the normal disposition) and its
  routed handoff records go to a surviving decode replica. A lease whose
  holder never registered is left to the lease reaper: force-expiring it
  could serve its request twice.
- ``interactive_burn`` and ``BrownoutController``: the degradation ladder
  over the interactive TTFT burn rate; the producer's admission runs it
  over its own ``/slo`` (serve/producer.py).
- ``FleetHarness``: N workers on one broker under ``ChaosWorkerHost``
  threads (serve/chaos.py), the CPU substrate of the fleet's chaos tests.
"""

from __future__ import annotations

import functools
import threading
import time

from llmss_tpu_torch.serve.broker import Broker
from llmss_tpu_torch.serve.chaos import ChaosWorkerHost
from llmss_tpu_torch.serve.handoff import pick_decode_worker
from llmss_tpu_torch.serve.protocol import (
    SLO_CLASS_BATCH, SLO_CLASS_INTERACTIVE, SLO_CLASS_STANDARD, STATE_DEAD,
    STATE_READY, GenerateRequest, prefix_hash,
)
from llmss_tpu_torch.utils import trace


def _worker_health(info: dict, stale_factor: float = 3.0) -> tuple[int, dict]:
    """(status, body) of one registry entry under the producer's /health
    policy (imported here, when called: the producer imports this module
    for GET /fleet)."""
    from llmss_tpu_torch.serve.producer import evaluate_worker_health

    code, body, _ = evaluate_worker_health(info, True, stale_factor)
    return code, body


def _routable(info: dict, code: int) -> bool:
    return code == 200 and info.get("state", STATE_READY) == STATE_READY


def routable_workers(broker: Broker, stale_factor: float = 3.0) -> dict:
    """The registry entries that may take work now: healthy and ``ready``
    (a ``starting`` worker heartbeats while it prewarms)."""
    out = {}
    for wid, info in broker.read_workers().items():
        if _routable(info, _worker_health(info, stale_factor)[0]):
            out[wid] = info
    return out


def fleet_status(broker: Broker, router: "Router | None" = None,
                 stale_factor: float = 3.0) -> dict:
    """Each worker's entry with its health, routability and queue and lease
    counts, and the fleet's summary (the producer's GET /fleet)."""
    depths = broker.routed_depths()
    holders = broker.lease_holders()
    hdepths = broker.handoff_depths()
    hholders = broker.handoff_holders()
    workers = {}
    ready = 0
    for wid, info in sorted(broker.read_workers().items()):
        code, body = _worker_health(info, stale_factor)
        routable = _routable(info, code)
        ready += int(routable)
        workers[wid] = {
            # The recorder's snapshot and the windowed series ride the
            # heartbeat for other endpoints; they stay off this view.
            **{k: v for k, v in info.items() if k not in ("trace", "series")},
            "role": info.get("role", "unified"),
            "health": body.get("status"),
            "routable": routable,
            "routed_queue_depth": depths.get(wid, 0),
            "leases_held": holders.get(wid, 0),
            "routed_handoff_depth": hdepths.get(wid, 0),
            "handoff_leases_held": hholders.get(wid, 0),
        }
    out = {"workers": workers, "ready": ready,
           "queue_depth": broker.queue_depth(),
           "handoff_depth": broker.handoff_depth()}
    tiers = aggregate_kv_tiers(info.get("kv_tiers") for info in workers.values())
    if tiers:
        # Per-worker counters summed: the blob store's are per-worker views
        # of one store, so the sums count traffic, not distinct blobs.
        out["kv_tiers"] = tiers
    if router is not None:
        out["router"] = router.stats()
    return out


def aggregate_kv_tiers(blobs) -> dict:
    """The workers' ``kv_tiers`` blocks summed into one: numeric leaves
    add, nested dicts recurse, a worker without a store adds nothing."""
    out: dict = {}

    def fold(dst: dict, src: dict) -> None:
        for k, v in src.items():
            if isinstance(v, dict):
                fold(dst.setdefault(k, {}), v)
            elif isinstance(v, (int, float)) and not isinstance(v, bool):
                dst[k] = dst.get(k, 0) + v

    for blob in blobs:
        if isinstance(blob, dict):
            fold(out, blob)
    return out


def interactive_burn(slo_payload: dict) -> float:
    """The brownout ladder's input from an SLO evaluation payload: the
    worst burn rate over the windows of the interactive class's TTFT
    objective, else of the first TTFT objective; 0.0 without data (an
    empty fleet reads healthy)."""
    rows = {r["name"]: r for r in (slo_payload.get("objectives") or ())}
    best_key = None
    for name in rows:
        if "ttft" not in name:
            continue
        if name.endswith(f"_{SLO_CLASS_INTERACTIVE}"):
            best_key = name
            break
        if best_key is None:
            best_key = name
    if best_key is None:
        return 0.0
    worst = 0.0
    for w in (rows[best_key].get("windows") or {}).values():
        burn = w.get("burn_rate")
        if burn is not None and w.get("count", 0) > 0:
            worst = max(worst, burn)
    return worst


class BrownoutController:
    """The burn-rate degradation ladder (fleet.py:186). It walks four rungs
    over the interactive TTFT burn rate, shedding the least valuable work
    first and never interactive traffic:

      0 ``normal``        everything admitted
      1 ``cap-batch``     batch requests' ``max_new_tokens`` capped
      2 ``shed-batch``    batch refused (429 with Retry-After)
      3 ``shed-standard`` standard refused too; interactive admitted

    It climbs when burn > ``high`` and descends only after burn < ``low``
    has held for ``dwell_s``; it re-evaluates at most every ``check_s``.
    ``escalate_ok`` (when set) must allow each climb; descending is never
    gated."""

    LADDER = ("normal", "cap-batch", "shed-batch", "shed-standard")

    def __init__(self, read_burn, *, high: float = 2.0, low: float = 1.0,
                 dwell_s: float = 5.0, check_s: float = 1.0,
                 batch_max_new_cap: int = 64,
                 retry_after_s: int | None = None, escalate_ok=None):
        if high <= low:
            raise ValueError(f"need high > low, got {high} <= {low}")
        self.read_burn = read_burn
        self.high = high
        self.low = low
        self.dwell_s = dwell_s
        self.check_s = check_s
        self.batch_max_new_cap = batch_max_new_cap
        # The ladder cannot descend sooner than dwell_s after the burn
        # cools, so a client told to retry earlier gets another 429.
        self.retry_after_s = (max(1, int(round(dwell_s)))
                              if retry_after_s is None else retry_after_s)
        self.escalate_ok = escalate_ok
        self._lock = threading.Lock()
        self._suppressed_escalations = 0  # guarded_by: self._lock
        self._rung = 0  # guarded_by: self._lock
        self._last_burn = 0.0  # guarded_by: self._lock
        self._next_check = 0.0  # guarded_by: self._lock
        # When burn last sat at or above ``low``: the descent's dwell clock.
        self._last_hot = 0.0  # guarded_by: self._lock
        self._since = time.monotonic()  # guarded_by: self._lock
        self._transitions = 0  # guarded_by: self._lock
        self._history: list[dict] = []  # guarded_by: self._lock

    def tick(self, now: float | None = None) -> int:
        """Re-evaluate once the check interval has passed; returns the
        rung. Cheap enough for every admission."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if now < self._next_check:
                return self._rung
            self._next_check = now + self.check_s
        burn = float(self.read_burn())
        with self._lock:
            self._last_burn = burn
            if burn >= self.low:
                self._last_hot = now
            rung = self._rung
            if burn > self.high and rung < len(self.LADDER) - 1:
                if self.escalate_ok is None or self.escalate_ok():
                    rung += 1
                else:
                    self._suppressed_escalations += 1
            elif (burn < self.low and rung > 0
                  and now - self._last_hot >= self.dwell_s):
                rung -= 1
            if rung != self._rung:
                self._transitions += 1
                self._history.append({
                    "from": self.LADDER[self._rung], "to": self.LADDER[rung],
                    "burn": round(burn, 3),
                    "at_s": round(now - self._since, 3)})
                del self._history[:-16]
                self._rung = rung
            return self._rung

    def admit(self, req: GenerateRequest) -> tuple[bool, int | None]:
        """``(True, None)`` admits (a batch request's ``max_new_tokens``
        capped in place at rung 1), ``(False, retry_after_s)`` sheds;
        interactive is admitted at every rung."""
        rung = self.tick()
        if rung == 0 or req.slo_class == SLO_CLASS_INTERACTIVE:
            return True, None
        if req.slo_class == SLO_CLASS_BATCH:
            if rung >= 2:
                return False, self.retry_after_s
            req.max_new_tokens = min(req.max_new_tokens,
                                     self.batch_max_new_cap)
            return True, None
        if req.slo_class == SLO_CLASS_STANDARD and rung >= 3:
            return False, self.retry_after_s
        return True, None

    def state(self) -> dict:
        """The operator's view: the rung as a number (a Prometheus gauge)
        and its name."""
        with self._lock:
            return {
                "brownout_state": self._rung,
                "state": self.LADDER[self._rung],
                "burn_rate": round(self._last_burn, 4),
                "high": self.high,
                "low": self.low,
                "dwell_s": self.dwell_s,
                "transitions_total": self._transitions,
                "suppressed_escalations": self._suppressed_escalations,
                "recent_transitions": list(self._history),
            }


class Router:
    """Request placement by policy over the broker's registry. Thread-safe:
    the producer's handler threads submit concurrently and /metrics reads
    ``stats``, so the routing state lives under one lock."""

    POLICIES = ("round_robin", "least_loaded", "prefix_affinity")

    def __init__(self, broker: Broker, policy: str = "least_loaded", *,
                 stale_factor: float = 3.0, failover_check_s: float = 1.0):
        if policy not in self.POLICIES:
            raise ValueError(
                f"unknown policy {policy!r}; choose from {self.POLICIES}")
        self.broker = broker
        self.policy = policy
        self.stale_factor = stale_factor
        # Every submit runs check_failover; the registry scan runs at most
        # once per interval.
        self.failover_check_s = failover_check_s
        self._lock = threading.Lock()
        self._rr_next = 0  # guarded_by: self._lock
        # prefix hash -> the worker that owns (built) that prefix
        self._prefix_owner: dict[str, str] = {}  # guarded_by: self._lock
        self._next_failover = 0.0  # guarded_by: self._lock
        self._counts = {  # guarded_by: self._lock
            "routed_total": 0, "shared_fallback": 0, "failover_reroutes": 0,
            "handoff_reroutes": 0, "affinity_hits": 0, "affinity_misses": 0,
        }
        self._routed_by_worker: dict[str, int] = {}  # guarded_by: self._lock
        self._by_class = {SLO_CLASS_INTERACTIVE: 0, SLO_CLASS_STANDARD: 0,  # guarded_by: self._lock
                          SLO_CLASS_BATCH: 0}

    # -- policies ------------------------------------------------------------

    def _least_loaded(self, infos: dict, depths: dict) -> str:
        def load(wid: str):
            info = infos[wid]
            backlog = ((info.get("inflight_rows") or 0)
                       + (info.get("queue_depth") or 0)  # pending in the worker
                       + depths.get(wid, 0))  # routed, not yet popped
            headroom = (info.get("free_kv_blocks")
                        if info.get("free_kv_blocks") is not None
                        else info.get("free_slots"))
            return (backlog, -(headroom or 0), wid)

        return min(infos, key=load)

    def _round_robin(self, infos: dict) -> str:
        order = sorted(infos)
        with self._lock:
            wid = order[self._rr_next % len(order)]
            self._rr_next += 1
        return wid

    def _prefix_affinity(self, req: GenerateRequest, infos: dict,
                         depths: dict) -> str:
        if not req.prefix_token_ids:
            return self._least_loaded(infos, depths)
        h = prefix_hash(req.prefix_token_ids)
        with self._lock:
            owner = self._prefix_owner.get(h)
        if owner not in infos:
            # No owner, or it left: a replica whose snapshot holds the
            # prefix resident.
            owner = next((wid for wid, info in sorted(infos.items())
                          if h in (info.get("prefix_hashes") or ())), None)
        with self._lock:
            self._counts["affinity_hits" if owner is not None
                         else "affinity_misses"] += 1
        if owner is None:
            owner = self._least_loaded(infos, depths)
        with self._lock:
            self._prefix_owner[h] = owner
        return owner

    def _pick(self, req: GenerateRequest, infos: dict) -> str:
        depths = self.broker.routed_depths()
        if self.policy == "round_robin":
            return self._round_robin(infos)
        if self.policy == "prefix_affinity":
            return self._prefix_affinity(req, infos, depths)
        return self._least_loaded(infos, depths)

    # -- submission ----------------------------------------------------------

    def routable_workers(self) -> dict:
        return routable_workers(self.broker, self.stale_factor)

    def _request_targets(self) -> dict:
        """The routable workers that take raw requests: all but the
        decode-role replicas, on whose routed queue a request would sit
        unleased until failover."""
        return {wid: info for wid, info in self.routable_workers().items()
                if info.get("role", "unified") != "decode"}

    def submit(self, req: GenerateRequest) -> str | None:
        """Route a request to one replica's queue and return its id; None
        when no replica is routable (the shared queue takes it)."""
        self.check_failover()
        trace.ensure_context(req)
        with self._lock:
            if req.slo_class in self._by_class:
                self._by_class[req.slo_class] += 1
        infos = self._request_targets()
        if not infos:
            with self._lock:
                self._counts["shared_fallback"] += 1
            trace.record(req.id, "route", trace_id=req.trace_id,
                         policy=self.policy, worker="shared")
            self.broker.push_request(req)
            return None
        wid = self._pick(req, infos)
        trace.record(req.id, "route", trace_id=req.trace_id,
                     policy=self.policy, worker=wid)
        self.broker.push_request_to(wid, req)
        with self._lock:
            self._counts["routed_total"] += 1
            self._routed_by_worker[wid] = self._routed_by_worker.get(wid, 0) + 1
        return wid

    # -- failover ------------------------------------------------------------

    def _failover_targets(self) -> list[str]:
        """The workers whose work must move: registered ones judged dead,
        stale or unhealthy that hold routed, leased or handoff work, and
        routed queues whose worker is not registered. A draining worker is
        not one (it finishes its leases and then publishes ``dead``); an
        unregistered worker's leases are left to the reaper."""
        depths = self.broker.routed_depths()
        holders = self.broker.lease_holders()
        hdepths = self.broker.handoff_depths()
        hholders = self.broker.handoff_holders()
        workers = self.broker.read_workers()
        targets = []
        for wid, info in workers.items():
            if not (depths.get(wid) or holders.get(wid) or hdepths.get(wid)
                    or hholders.get(wid)):
                continue
            code, body = _worker_health(info, self.stale_factor)
            if code != 200 and body.get("status") in (
                    STATE_DEAD, "stale-heartbeat", "unhealthy",
                    "no-heartbeat-data"):
                targets.append(wid)
        targets.extend(wid for wid in depths if wid not in workers)
        targets.extend(wid for wid in hdepths
                       if wid not in workers and wid not in targets)
        return targets

    def check_failover(self, force: bool = False) -> int:
        """The time-gated failover sweep; returns the requests and records
        re-routed."""
        now = time.monotonic()
        with self._lock:
            if not force and now < self._next_failover:
                return 0
            self._next_failover = now + self.failover_check_s
        rerouted = handoffs = 0
        for wid in self._failover_targets():
            for req in self.broker.failover_worker(wid):
                infos = self._request_targets()
                if infos:
                    self.broker.push_request_to(self._pick(req, infos), req)
                else:
                    self.broker.push_request(req)
                rerouted += 1
            # Routed records come back with their payloads: another decode
            # replica adopts them without a new prefill. Leased ones were
            # disposed of by the broker (their adopted KV died).
            for rec in self.broker.failover_handoffs(wid):
                target = pick_decode_worker(self.routable_workers(),
                                            self.broker.handoff_depths())
                if target is None:
                    self.broker.push_handoff(rec)
                else:
                    self.broker.push_handoff_to(target, rec)
                handoffs += 1
        if rerouted or handoffs:
            with self._lock:
                self._counts["failover_reroutes"] += rerouted
                self._counts["handoff_reroutes"] += handoffs
        return rerouted + handoffs

    # -- observability -------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            hits = self._counts["affinity_hits"]
            total = hits + self._counts["affinity_misses"]
            return {
                "policy": self.policy,
                **self._counts,
                "affinity_hit_rate": (hits / total) if total else None,
                "routed_by_worker": dict(self._routed_by_worker),
                "submitted_by_class": dict(self._by_class),
            }


class FleetHarness:
    """N workers over one broker in one process, each under a
    ``ChaosWorkerHost`` so a ``HardKill`` is a machine's death: the worker
    is abandoned, its heartbeats stop, and only failover and redelivery
    rescue its requests. ``make_worker(worker_id)`` builds one registered
    replica; ``respawn=False`` makes every kill final."""

    def __init__(self, make_worker, worker_ids, *, respawn: bool = False,
                 respawn_delay_s: float = 0.05):
        self.hosts: dict[str, ChaosWorkerHost] = {
            wid: ChaosWorkerHost(functools.partial(make_worker, wid),
                                 respawn_delay_s=respawn_delay_s,
                                 respawn=respawn)
            for wid in worker_ids
        }

    def start(self) -> None:
        for host in self.hosts.values():
            host.start()

    def stop(self) -> None:
        for host in self.hosts.values():
            host.stop()

    def __enter__(self) -> "FleetHarness":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
