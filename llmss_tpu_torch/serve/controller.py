"""The reconciling fleet controller (counterpart:
llmss_tpu/serve/controller.py): the autoscaler that adds capacity before
the brownout ladder sheds it.

``FleetController`` reads the telemetry the stack measures (the
interactive TTFT burn rate from ``/slo``, the backlog from the broker,
per-phase utilization from devtel's MFU/MBU gauges) and acts through two
injected actuators: ``spawn(role)`` starts a replica that registers as
``starting`` and turns ``ready``; ``retire(worker_id)`` begins its drain
(``begin_drain`` and ``release_pending``, or the supervisor's ``drain``).

- **Reconciliation.** It owns no durable state: each tick re-derives the
  fleet from the broker's registry, counting replicas that are still
  starting as capacity, so a restarted controller never spawns twice.
- **Epoch fencing.** ``start`` takes a fleet-wide epoch from the broker
  (``acquire_controller_epoch``); before every action it re-reads it, and
  a controller that lost leadership acts on nothing.
- **Do no harm.** Never drain the last routable replica of a role, never
  go below the floor or above the ceiling, at most one action per
  cooldown, and hold on stale or partial telemetry.
- **Hysteresis.** Pressure must last ``dwell_s`` before an action, and the
  up and down thresholds are apart.
- **Scale before shed.** ``escalation_allowed`` is the brownout ladder's
  ``escalate_ok``: it may shed only when scaling cannot answer in time
  (a cold start longer than the burn window's headroom), at the ceiling,
  or when the controller is blind.

``producer_telemetry(server)`` builds the ``read_telemetry`` callable
over a live ``ProducerServer``. Ticks take ``now=`` (the monotonic
clock by default), so tests drive a virtual timeline.
"""

from __future__ import annotations

import logging
import time
from typing import Callable

from llmss_tpu_torch.serve.protocol import (
    STATE_DRAINING,
    STATE_READY,
    STATE_STARTING,
)

logger = logging.getLogger(__name__)

ROLE_UNIFIED = "unified"
ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"

# Actions surfaced in state()/history
ACT_SPAWN = "spawn"
ACT_RETIRE = "retire"
ACT_RESHAPE_SPAWN = "reshape-spawn"
ACT_RESHAPE_RETIRE = "reshape-retire"


def _as_role_map(value, roles, default: int) -> dict[str, int]:
    """Accept ``{"role": n}`` or a bare int applied to every role."""
    if value is None:
        return {r: default for r in roles}
    if isinstance(value, dict):
        return {r: int(value.get(r, default)) for r in roles}
    return {r: int(value) for r in roles}


class FleetController:
    """Reconciling autoscaler over a broker-registered fleet.

    The controller never touches replicas directly: it acts through two
    injected actuators.

    ``spawn(role) -> worker_id``
        Start a replica of ``role``; it must register as ``starting``
        immediately and flip to ``ready`` once its cold-start elapses.
    ``retire(worker_id) -> None``
        Begin the drain lifecycle on one replica (stop leasing, release
        pending refunded, finish in-flight, publish ``dead``).

    ``read_telemetry() -> dict | None`` returns the signal snapshot::

        {"ts": <monotonic stamp>, "burn": <interactive burn rate>,
         "queue_depth": <shared+routed backlog>,
         "handoff_depth": <prefill->decode backlog>,
         "util": {"unified": u, "prefill": u, "decode": u}}

    ``None``, a missing field, or a stale ``ts`` means the telemetry
    plane is down or partitioned — the controller holds position.
    """

    def __init__(
        self,
        broker,
        *,
        spawn: Callable[[str], str],
        retire: Callable[[str], None],
        read_telemetry: Callable[[], dict | None],
        roles=(ROLE_UNIFIED,),
        floor=1,
        ceiling=8,
        check_s: float = 1.0,
        cooldown_s: float = 5.0,
        dwell_s: float = 3.0,
        cold_start_s: float = 2.0,
        burn_headroom_s: float = 10.0,
        scale_up_burn: float = 1.5,
        scale_down_burn: float = 0.5,
        backlog_high: float = 8.0,
        backlog_low: float = 1.0,
        util_high: float = 0.85,
        util_low: float = 0.35,
        telemetry_max_age_s: float = 5.0,
        stale_factor: float = 3.0,
        reshape: bool = True,
        controller_id: str = "ctrl",
    ) -> None:
        self.broker = broker
        self.spawn = spawn
        self.retire = retire
        self.read_telemetry = read_telemetry
        self.roles = tuple(roles)
        self.floor = _as_role_map(floor, self.roles, 1)
        self.ceiling = _as_role_map(ceiling, self.roles, 8)
        self.check_s = check_s
        self.cooldown_s = cooldown_s
        self.dwell_s = dwell_s
        self.cold_start_s = cold_start_s
        self.burn_headroom_s = burn_headroom_s
        self.scale_up_burn = scale_up_burn
        self.scale_down_burn = scale_down_burn
        self.backlog_high = backlog_high
        self.backlog_low = backlog_low
        self.util_high = util_high
        self.util_low = util_low
        self.telemetry_max_age_s = telemetry_max_age_s
        self.stale_factor = stale_factor
        self.reshape = reshape and (
            ROLE_PREFILL in self.roles and ROLE_DECODE in self.roles
        )
        self.controller_id = controller_id
        self.epoch = 0
        # No wall-clock reads here: every stamp is seeded lazily from the
        # ``now`` the first tick passes in, so the controller is exactly
        # reproducible under a virtual clock (the tests' ``now=``).
        self._next_check: float | None = None
        self._last_action_t: float | None = None
        self._up_since: float | None = None
        self._down_since: float | None = None
        self._reshape_since: float | None = None
        self._reshape_dir: str | None = None  # role that needs more capacity
        self._reshape_debt: str | None = None  # role owing one retirement
        # worker_id -> estimated ready stamp, for escalation ETA math.
        self._pending_spawns: dict[str, float] = {}
        # Replicas this epoch already told to drain — excluded from
        # capacity and from retire candidates until the registry shows
        # them draining/gone.
        self._retired: set[str] = set()
        self._last_observed: dict[str, dict[str, int]] = {}
        self._last_action: dict | None = None
        self.counters: dict[str, int] = {
            "ticks": 0,
            "spawns": 0,
            "retires": 0,
            "reshape_spawns": 0,
            "reshape_retires": 0,
            "fenced": 0,
            "held_stale": 0,
            "held_cooldown": 0,
            "blocked_floor": 0,
            "blocked_last_routable": 0,
            "blocked_ceiling": 0,
            "escalations_allowed": 0,
            "escalations_suppressed": 0,
        }

    # -- leadership ----------------------------------------------------------

    def start(self) -> int:
        """Take (or re-take after a crash) fleet leadership.

        Bumps the broker's controller epoch; the previous holder, if any,
        is fenced from that point on. Desired state is NOT persisted
        anywhere — the next tick reconciles from the registry, which is
        what makes crash+restart resume with zero duplicate spawns.
        """
        self.epoch = self.broker.acquire_controller_epoch(self.controller_id)
        return self.epoch

    # -- observation ---------------------------------------------------------

    def observe(self) -> dict[str, dict[str, int]]:
        """Bucket the live registry per role: starting / ready / draining
        counts plus the ready worker ids (retire candidates).

        Staleness matters as much as state: a hard-killed replica's last
        snapshot says ``ready`` forever, so counting unexpired rows at
        face value would both overstate capacity (blocking scale-up at a
        phantom ceiling) and understate the need to replace the dead.
        The same ``stale_factor × heartbeat_s`` policy as the router's
        health view applies."""
        out: dict[str, dict] = {
            r: {"starting": 0, "ready": 0, "draining": 0, "ready_ids": []}
            for r in self.roles
        }
        # Heartbeats are stamped by other processes: the wall clock.
        now_wall = time.time()
        for wid, info in sorted(self.broker.read_workers().items()):
            role = info.get("role", ROLE_UNIFIED)
            if role not in out:
                continue
            if info.get("alive") is False:
                continue
            hb = info.get("heartbeat_ts")
            if hb is not None:
                period = float(info.get("heartbeat_s") or 10.0)
                if now_wall - float(hb) > self.stale_factor * period:
                    continue  # dead or partitioned — not capacity
            state = info.get("state")
            if state == STATE_STARTING:
                out[role]["starting"] += 1
            elif state == STATE_READY:
                if wid in self._retired:
                    # We already told it to drain; the registry just has
                    # not caught up. Count it as draining, not capacity.
                    out[role]["draining"] += 1
                else:
                    out[role]["ready"] += 1
                    out[role]["ready_ids"].append(wid)
            elif state == STATE_DRAINING:
                out[role]["draining"] += 1
            # dead / unknown states contribute no capacity
        return out

    def _live(self, obs: dict, role: str) -> int:
        """Capacity the reconciler counts against desired: ready plus
        still-cold-starting (spawned-but-not-ready must count, or a
        restarted controller would spawn duplicates)."""
        return obs[role]["ready"] + obs[role]["starting"]

    # -- telemetry gates -----------------------------------------------------

    def _telemetry_ok(self, tel, now: float) -> bool:
        if not isinstance(tel, dict):
            return False
        if "burn" not in tel or "queue_depth" not in tel:
            return False  # partial — hold position
        ts = tel.get("ts")
        if ts is None or (now - float(ts)) > self.telemetry_max_age_s:
            return False
        return True

    # -- escalation contract with brownout -----------------------------------

    def escalation_allowed(self, now: float | None = None) -> bool:
        """May the brownout ladder escalate (shed harder)?

        Scale-before-shed: shedding is allowed only when scaling
        demonstrably cannot respond in time —

        * telemetry is stale/partial (the controller is blind; fail open
          and let brownout protect the SLO), or
        * the fleet is at its ceiling (counting cold-starting spawns as
          capacity) — there is no capacity left to add, so shedding is
          the only lever, or
        * the fleet's structural response time — one cold start — is
          longer than ``burn_headroom_s``: the burn window would be
          violated before any reinforcement can arrive, no matter when
          it was ordered.

        Deliberately NOT a min-pending-ETA rule: with a long cold start
        the earliest in-flight spawn always eventually comes within the
        headroom window, which would suppress shedding precisely while
        the fleet drowns waiting for it.
        """
        if now is None:
            now = time.monotonic()
        allowed = self._escalation_allowed(now)
        key = "escalations_allowed" if allowed else "escalations_suppressed"
        self.counters[key] += 1
        return allowed

    def _escalation_allowed(self, now: float) -> bool:
        tel = self.read_telemetry()
        if not self._telemetry_ok(tel, now):
            return True  # blind controller must not pin brownout down
        self._prune_pending(now)
        obs = self.observe()
        at_ceiling = all(
            self._live(obs, r) >= self.ceiling[r] for r in self.roles
        )
        if at_ceiling:
            return True  # cannot add capacity: shedding is the only lever
        return self.cold_start_s > self.burn_headroom_s

    def _prune_pending(self, now: float) -> None:
        workers = self.broker.read_workers()
        for wid in list(self._pending_spawns):
            info = workers.get(wid)
            ready_at = self._pending_spawns[wid]
            if info is not None and info.get("state") == STATE_READY:
                del self._pending_spawns[wid]
            elif now > ready_at + 10 * max(self.cold_start_s, 1.0):
                del self._pending_spawns[wid]  # spawn presumed lost

    # -- the reconcile tick --------------------------------------------------

    def tick(self, now: float | None = None) -> dict | None:
        """One reconcile pass. Returns the action taken (or None).

        At most ONE actuation per tick, and at most one per cooldown
        window — an autoscaler that can only move the fleet slowly is an
        autoscaler whose mistakes are recoverable.
        """
        if now is None:
            now = time.monotonic()
        if self._next_check is not None and now < self._next_check:
            return None
        self._next_check = now + self.check_s
        self.counters["ticks"] += 1

        tel = self.read_telemetry()
        if not self._telemetry_ok(tel, now):
            # Hold position: stale or partial telemetry. Also reset the
            # dwell timers — pressure must re-prove itself on fresh data.
            self.counters["held_stale"] += 1
            self._up_since = self._down_since = self._reshape_since = None
            return None

        self._prune_pending(now)
        obs = self.observe()
        self._last_observed = {
            r: {k: v for k, v in obs[r].items() if k != "ready_ids"}
            for r in self.roles
        }

        burn = float(tel["burn"])
        backlog = float(tel["queue_depth"]) + float(
            tel.get("handoff_depth", 0.0)
        )
        live_total = max(1, sum(self._live(obs, r) for r in self.roles))
        backlog_per = backlog / live_total
        util = tel.get("util") or {}
        util_max = max(
            (float(v) for v in util.values()), default=0.0
        )

        # Hysteresis: separated thresholds + dwell timers. A signal that
        # appears and vanishes within dwell_s never moves the fleet.
        up_hot = burn >= self.scale_up_burn or backlog_per >= self.backlog_high
        down_cold = (
            burn <= self.scale_down_burn
            and backlog_per <= self.backlog_low
            and util_max <= self.util_low
        )
        # Explicit None checks: a dwell that began at t=0.0 is falsy but
        # very much set (a virtual clock may start there).
        if up_hot:
            self._up_since = now if self._up_since is None else self._up_since
        else:
            self._up_since = None
        if down_cold:
            self._down_since = (
                now if self._down_since is None else self._down_since
            )
        else:
            self._down_since = None

        reshape_dir = self._reshape_wanted(util)
        if reshape_dir is not None and reshape_dir == self._reshape_dir:
            pass  # dwell continues
        elif reshape_dir is not None:
            self._reshape_dir, self._reshape_since = reshape_dir, now
        else:
            self._reshape_dir = self._reshape_since = None

        action = self._plan(obs, util, now)
        if action is None:
            return None
        return self._actuate(action, now)

    def _reshape_wanted(self, util: dict) -> str | None:
        """Phase-utilization asymmetry: the role that is saturated while
        its counterpart idles is the role that needs more capacity."""
        if not self.reshape:
            return None
        p = float(util.get(ROLE_PREFILL, 0.0))
        d = float(util.get(ROLE_DECODE, 0.0))
        if p >= self.util_high and d <= self.util_low:
            return ROLE_PREFILL
        if d >= self.util_high and p <= self.util_low:
            return ROLE_DECODE
        return None

    def _plan(self, obs, util, now: float) -> dict | None:
        """Pick at most one action, in priority order: pay reshape debt,
        scale up, reshape (scale-before-shed: spawn first, retire the
        donor on a later tick), scale down."""
        dwelled = lambda since: since is not None and now - since >= self.dwell_s  # noqa: E731

        # A reshape spawned capacity earlier and still owes the donor
        # retirement; settle it once the spawned replica is ready and no
        # scale-up pressure intervened.
        if self._reshape_debt is not None and self._up_since is None:
            donor = self._reshape_debt
            if not any(
                self._pending_spawns_for(obs, r) for r in self.roles
            ):
                return {"kind": ACT_RESHAPE_RETIRE, "role": donor}

        if dwelled(self._up_since):
            role = self._scale_role(obs, util)
            return {"kind": ACT_SPAWN, "role": role}

        if dwelled(self._reshape_since) and self._reshape_debt is None:
            gain = self._reshape_dir
            donor = ROLE_DECODE if gain == ROLE_PREFILL else ROLE_PREFILL
            # Only reshape if the donor can actually give one up later.
            if obs[donor]["ready"] - 1 >= max(1, self.floor[donor]):
                return {"kind": ACT_RESHAPE_SPAWN, "role": gain,
                        "donor": donor}
            return None

        if dwelled(self._down_since):
            role = self._retire_role(obs, util)
            if role is not None:
                return {"kind": ACT_RETIRE, "role": role}
        return None

    def _pending_spawns_for(self, obs, role: str) -> int:
        return obs[role]["starting"]

    def _scale_role(self, obs, util) -> str:
        """Where new capacity helps most: a disagg fleet grows the
        phase whose utilization is higher (MBU-bound decode vs MFU-bound
        prefill); otherwise unified."""
        if ROLE_UNIFIED in self.roles:
            return ROLE_UNIFIED
        p = float(util.get(ROLE_PREFILL, 0.0))
        d = float(util.get(ROLE_DECODE, 0.0))
        return ROLE_DECODE if d >= p else ROLE_PREFILL

    def _retire_role(self, obs, util) -> str | None:
        """Retire from the role with the most slack above its floor."""
        best, best_slack = None, 0
        for r in self.roles:
            slack = obs[r]["ready"] - max(1, self.floor[r])
            if slack > best_slack:
                best, best_slack = r, slack
        return best

    # -- actuation (guards + fencing) ----------------------------------------

    def _guard(self, action: dict, obs) -> str | None:
        """Do-no-harm gate. Returns a refusal reason or None (safe)."""
        now_kind, role = action["kind"], action["role"]
        if now_kind in (ACT_SPAWN, ACT_RESHAPE_SPAWN):
            if self._live(obs, role) >= self.ceiling[role]:
                self.counters["blocked_ceiling"] += 1
                return "ceiling"
            return None
        # retirement paths
        ready = obs[role]["ready"]
        if ready - 1 < self.floor[role]:
            self.counters["blocked_floor"] += 1
            return "floor"
        if ready <= 1:
            # Never drain the last routable replica of any role, no
            # matter what the floor says.
            self.counters["blocked_last_routable"] += 1
            return "last-routable"
        if not obs[role]["ready_ids"]:
            return "no-candidate"
        return None

    def _actuate(self, action: dict, now: float) -> dict | None:
        if (
            self._last_action_t is not None
            and now - self._last_action_t < self.cooldown_s
        ):
            self.counters["held_cooldown"] += 1
            return None
        obs = self.observe()
        reason = self._guard(action, obs)
        if reason is not None:
            return None
        # Fence: re-read the epoch immediately before acting. A stale
        # holder (another controller restarted and took leadership) must
        # treat the action as a no-op.
        if self.broker.controller_epoch() != self.epoch:
            self.counters["fenced"] += 1
            logger.warning(
                "controller %s epoch %d fenced (current %d): dropping %s",
                self.controller_id, self.epoch,
                self.broker.controller_epoch(), action["kind"],
            )
            return None

        kind, role = action["kind"], action["role"]
        if kind in (ACT_SPAWN, ACT_RESHAPE_SPAWN):
            wid = self.spawn(role)
            self._pending_spawns[wid] = now + self.cold_start_s
            self.counters[
                "spawns" if kind == ACT_SPAWN else "reshape_spawns"
            ] += 1
            if kind == ACT_RESHAPE_SPAWN:
                self._reshape_debt = action["donor"]
            action = dict(action, worker_id=wid)
        else:
            wid = obs[role]["ready_ids"][-1]  # newest first: LIFO retire
            self.retire(wid)
            self._retired.add(wid)
            self.counters[
                "retires" if kind == ACT_RETIRE else "reshape_retires"
            ] += 1
            if kind == ACT_RESHAPE_RETIRE:
                self._reshape_debt = None
            action = dict(action, worker_id=wid)
        self._last_action_t = now
        self._up_since = self._down_since = self._reshape_since = None
        self._last_action = dict(action, t=round(now, 6))
        return action

    # -- introspection -------------------------------------------------------

    def state(self) -> dict:
        """Deterministic snapshot for /fleet (no registry
        reads here — observed counts are from the last tick)."""
        return {
            "controller_id": self.controller_id,
            "epoch": self.epoch,
            "roles": list(self.roles),
            "floor": dict(self.floor),
            "ceiling": dict(self.ceiling),
            "observed": self._last_observed,
            "pending_spawns": len(self._pending_spawns),
            "reshape_debt": self._reshape_debt,
            "last_action": self._last_action,
            "counters": dict(self.counters),
        }


def producer_telemetry(server) -> Callable[[], dict | None]:
    """Build a ``read_telemetry`` callable over a live ProducerServer:
    burn from the SLO plane's interactive windows, backlog from the
    broker, phase utilization from devtel's MFU/MBU gauges (prefill is
    MFU-bound, decode MBU-bound). Returns None on any telemetry error so
    the controller holds position instead of acting on garbage."""
    from llmss_tpu_torch.serve.fleet import interactive_burn

    def read() -> dict | None:
        try:
            broker = server.broker
            depth = broker.queue_depth()
            depth += sum(broker.routed_depths().values())
            handoff = getattr(broker, "handoff_depth", lambda: 0)()
            handoff += sum(
                getattr(broker, "handoff_depths", dict)().values()
            )
            util: dict[str, float] = {}
            try:
                from llmss_tpu_torch.utils.devtel import phase_utilization

                util = phase_utilization()
            except Exception:  # devtel plane optional
                util = {}
            return {
                "ts": time.monotonic(),
                "burn": interactive_burn(server.slo()),
                "queue_depth": depth,
                "handoff_depth": handoff,
                "util": util,
            }
        except Exception:
            return None

    return read
