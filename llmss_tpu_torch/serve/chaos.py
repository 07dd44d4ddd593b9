"""Fault injection for the serving stack's delivery layer (counterpart:
llmss_tpu/serve/chaos.py).

The lease and ack contract of serve/broker.py exists to survive a worker's
hard death (OOM kill, SIGKILL, a device reset), where no cleanup runs. This
module exercises it under seeded schedules:

- ``HardKill`` / ``ChaosWorkerHost``: a worker's machine dying. ``HardKill``
  is a ``BaseException``, so it passes every ``except Exception`` layer (the
  workers' per-batch containment, the supervisor's crash handling) as a
  SIGKILL would: the worker answers and aborts nothing.
- ``ChaosBroker``: a proxy around a broker that drops responses, fails
  pops, delays acks, partitions, and kills right after a lease is taken.
- ``FakeRedis``: an in-memory stand-in for ``redis.Redis`` with exactly the
  primitives ``RedisBroker`` uses, so the Redis path runs with no server.
- ``ScriptedEngine``: a deterministic engine without a device, made to
  the calls the port's batch ``Worker`` and the role loops
  (serve/handoff.py) make: token ``k`` of the answer to prompt ``p`` is
  ``(p[-1] + k + 1) % 50257``, so a test predicts every payload; a prompt
  holding ``POISON_TOKEN`` resets the "device" and one holding
  ``NAN_TOKEN`` poisons its row.

On a GPU the fleet is driven in turns from one thread (two threads
capturing or replaying CUDA graphs on one device can spoil a capture), so
this thread-hosted harness runs with ``ScriptedEngine`` on the CPU.
"""

from __future__ import annotations

import fnmatch
import json
import logging
import random
import threading
import time
from typing import Callable

from llmss_tpu_torch.engine.metrics import EngineMetrics

logger = logging.getLogger("llmss_tpu_torch.serve")

# A prompt holding this token id "resets the device" when the scripted
# engine runs with kill_on_poison=True.
POISON_TOKEN = 666_000
# A prompt holding this token id has its row's logits "poisoned" (NaN/inf)
# when the scripted engine runs with nan_at set.
NAN_TOKEN = 666_001


class HardKill(BaseException):
    """A worker's machine dying (OOM killer, SIGKILL, device reset): a
    ``BaseException``, so no containment layer answers or aborts anything
    and the worker's leases are left to expire."""


class ChaosWorkerHost:
    """One simulated worker machine: builds a worker from the factory and
    loops ``run_once`` on its own thread. An escaping ``HardKill`` abandons
    the worker (its leases are recovered by redelivery or failover only)
    and a new one is built after ``respawn_delay_s``; with
    ``respawn=False`` the first kill is final. A builtin
    ``ConnectionError`` is a reconnect: the worker is rebuilt after a
    pause. Any other exception is a harness bug, recorded and re-raised."""

    def __init__(self, worker_factory: Callable[[], object], *,
                 respawn_delay_s: float = 0.05, respawn: bool = True):
        self.worker_factory = worker_factory
        self.respawn_delay_s = respawn_delay_s
        self.respawn = respawn
        self.kills = 0
        self.spawns = 0
        self.reconnects = 0
        self.error: str | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                worker = self.worker_factory()
                self.spawns += 1
                while not self._stop.is_set():
                    worker.run_once()
            except HardKill as e:
                self.kills += 1
                logger.debug("chaos host: worker hard-killed (%s)", e)
                if not self.respawn:
                    return
                if self._stop.wait(self.respawn_delay_s):
                    return
            except ConnectionError as e:
                self.reconnects += 1
                logger.debug("chaos host: broker unreachable (%s)", e)
                if self._stop.wait(self.respawn_delay_s):
                    return
            except Exception as e:  # noqa: BLE001 — surface harness bugs
                self.error = f"{type(e).__name__}: {e}"
                logger.exception("chaos host: unexpected worker error")
                raise

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)


class ChaosBroker:
    """A seeded fault-injecting proxy around a broker. Each fault is a
    Bernoulli draw from one ``random.Random(seed)``:

    - ``kill_after_pop_prob``: ``HardKill`` right after a lease is taken;
    - ``drop_response_prob``: a ``push_response`` silently lost (the lease
      stays un-acked, so only redelivery answers);
    - ``pop_fail_prob``: a ``pop_request`` that returns None;
    - ``ack_delay_s``: a sleep before every delivered response;
    - ``op_latency_s`` (with ``op_latency_prob``): a sleep before a pop or
      a response;
    - ``partition_for(duration_s)``: until the window ends, pops and
      responses raise ``ConnectionError``.

    Everything else goes to the wrapped broker. Not for use under a
    ``Supervisor`` (its ``metrics_extra`` would land on the proxy)."""

    def __init__(self, inner, *, seed: int = 0,
                 kill_after_pop_prob: float = 0.0,
                 drop_response_prob: float = 0.0,
                 pop_fail_prob: float = 0.0,
                 ack_delay_s: float = 0.0,
                 op_latency_s: float = 0.0,
                 op_latency_prob: float = 1.0):
        self.inner = inner
        self.kill_after_pop_prob = kill_after_pop_prob
        self.drop_response_prob = drop_response_prob
        self.pop_fail_prob = pop_fail_prob
        self.ack_delay_s = ack_delay_s
        self.op_latency_s = op_latency_s
        self.op_latency_prob = op_latency_prob
        self._partition_until = 0.0
        self._rng = random.Random(seed)
        self.faults = {"kills": 0, "dropped_responses": 0, "dropped_pops": 0,
                       "partition_errors": 0, "latency_injections": 0}

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def partition_for(self, duration_s: float) -> None:
        """Open a partition window of ``duration_s`` from now."""
        self._partition_until = time.monotonic() + duration_s

    def _gate(self) -> None:
        if time.monotonic() < self._partition_until:
            self.faults["partition_errors"] += 1
            raise ConnectionError("chaos: broker partitioned")
        if self.op_latency_s and self._rng.random() < self.op_latency_prob:
            self.faults["latency_injections"] += 1
            time.sleep(self.op_latency_s)

    def pop_request(self, timeout: float = 0.0, worker_id: str | None = None):
        self._gate()
        if self.pop_fail_prob and self._rng.random() < self.pop_fail_prob:
            self.faults["dropped_pops"] += 1
            return None
        req = self.inner.pop_request(timeout, worker_id=worker_id)
        if (req is not None and self.kill_after_pop_prob
                and self._rng.random() < self.kill_after_pop_prob):
            self.faults["kills"] += 1
            raise HardKill(f"chaos: killed holding lease on {req.id}")
        return req

    def push_response(self, resp) -> None:
        self._gate()
        if self.ack_delay_s:
            time.sleep(self.ack_delay_s)
        if (self.drop_response_prob
                and self._rng.random() < self.drop_response_prob):
            self.faults["dropped_responses"] += 1
            return
        self.inner.push_response(resp)


class ScriptedEngine:
    """A deterministic engine without a device, for fault injection in the
    delivery layer: what the port's batch ``Worker`` calls (``metrics``,
    ``check_capacity``, ``prewarm``, ``generate``) and what the role loops
    call (``prefill_export``, ``adopt_generate``). Token ``k`` of the answer
    to prompt ``p`` is ``(p[-1] + k + 1) % 50257``.

    - ``kill_on_poison``: a batch holding ``POISON_TOKEN`` raises
      ``HardKill`` in ``generate``.
    - ``hang_at=N``: the N-th ``generate`` call stalls for ``hang_s`` in
      small sleeps (a wedged device step a watchdog can interrupt).
    - ``nan_at=N``: from the N-th call on, a row whose prompt holds
      ``NAN_TOKEN`` is poisoned: ``on_poisoned(row)`` fires and the row
      gets no tokens, while its batch-mates keep theirs.
    - ``kill_switch``: an event checked at every decode chunk; once set,
      the next chunk raises ``HardKill`` (a worker killed mid-decode while
      it holds leases).
    """

    def __init__(self, *, kill_on_poison: bool = False,
                 chunk_delay_s: float = 0.0,
                 hang_at: int | None = None, hang_s: float = 30.0,
                 nan_at: int | None = None,
                 kill_switch: threading.Event | None = None):
        self.kill_on_poison = kill_on_poison
        self.chunk_delay_s = chunk_delay_s
        self.hang_at = hang_at
        self.hang_s = hang_s
        self.nan_at = nan_at
        self.kill_switch = kill_switch
        self.metrics = EngineMetrics()
        self.generate_calls = 0
        self.max_seq_len = 4096

    def prewarm(self, *args, **kwargs) -> int:
        return 0

    def check_capacity(self, prompt_len: int, max_new_tokens: int) -> None:
        if prompt_len + max_new_tokens > self.max_seq_len:
            raise ValueError("prompt + max_new_tokens exceeds max_seq_len")

    @staticmethod
    def expected_tokens(prompt: list[int], max_new_tokens: int) -> list[int]:
        return [(prompt[-1] + k + 1) % 50257 for k in range(max_new_tokens)]

    def _tripped(self, where: str) -> None:
        if self.kill_switch is not None and self.kill_switch.is_set():
            raise HardKill(f"chaos: kill switch tripped {where}")

    def generate(self, prompts, gens, cancel_poll=None, on_increment=None,
                 on_poisoned=None, chunk_steps: int = 8,
                 live_rows: int | None = None):
        self.generate_calls += 1
        n_live = len(prompts) if live_rows is None else live_rows
        if self.kill_on_poison and any(POISON_TOKEN in p
                                       for p in prompts[:n_live]):
            raise HardKill("poison request: simulated device reset")
        if self.hang_at is not None and self.generate_calls == self.hang_at:
            deadline = time.monotonic() + self.hang_s
            while time.monotonic() < deadline:
                time.sleep(0.005)
        poisoned = set()
        if self.nan_at is not None and self.generate_calls >= self.nan_at:
            poisoned = {row for row in range(n_live)
                        if NAN_TOKEN in prompts[row]}
        outs = [[] if row in poisoned
                else self.expected_tokens(p, g.max_new_tokens)
                for row, (p, g) in enumerate(zip(prompts, gens))]
        if on_poisoned is not None:
            for row in sorted(poisoned):
                on_poisoned(row)
        steps = max(g.max_new_tokens for g in gens) if gens else 0
        for start in range(0, steps, max(chunk_steps, 1)):
            self._tripped("mid-decode")
            if self.chunk_delay_s:
                time.sleep(self.chunk_delay_s)
            if cancel_poll is not None:
                cancel_poll()
            if on_increment is not None:
                for row in range(n_live):
                    inc = outs[row][start:start + chunk_steps]
                    if inc:
                        on_increment(row, inc)
        self.metrics.add_request(n_live)
        self.metrics.add_tokens(sum(len(t) for t in outs[:n_live]))
        return [list(t) for t in outs]

    # -- the role loops' protocol: the "KV payload" is the prompt as JSON,
    # enough for adopt_generate to compute the answer again.

    def prefill_export(self, token_ids: list[int],
                       max_new_tokens: int) -> tuple[int, bytes]:
        """The prefill half: (first token, payload), with ``generate``'s
        poison and kill switch."""
        self.generate_calls += 1
        if self.kill_on_poison and POISON_TOKEN in token_ids:
            raise HardKill("poison request: simulated device reset")
        self._tripped("during prefill")
        first = self.expected_tokens(token_ids, 1)[0]
        payload = json.dumps({"prompt": list(token_ids)}).encode()
        self.metrics.add_request(1)
        self.metrics.add_tokens(1)
        return first, payload

    def adopt_generate(self, payload: bytes, max_new_tokens: int,
                       first_token: int, n_tokens: int,
                       on_increment=None) -> list[int]:
        """The decode half: the answer from the payload, chunk by chunk (the
        kill switch checked at each); a payload or first token that does
        not match raises ``ValueError`` (the corrupt-record path)."""
        self.generate_calls += 1
        try:
            prompt = json.loads(payload)["prompt"]
        except Exception as e:  # noqa: BLE001 — a corrupt scripted payload
            raise ValueError(f"bad scripted payload: {e}") from None
        if len(prompt) != n_tokens:
            raise ValueError(
                f"payload has {len(prompt)} tokens, record says {n_tokens}")
        toks = self.expected_tokens(prompt, max_new_tokens)
        if toks and toks[0] != first_token:
            raise ValueError(f"first token mismatch: prefill said "
                             f"{first_token}, decode computed {toks[0]}")
        for _ in range(0, max_new_tokens, 8):
            self._tripped("mid-decode")
            if self.chunk_delay_s:
                time.sleep(self.chunk_delay_s)
            if on_increment is not None:
                on_increment()
        self.metrics.add_request(1)
        self.metrics.add_tokens(len(toks))
        return toks


class FakeRedis:
    """An in-memory ``redis.Redis`` stand-in with exactly the primitives
    ``RedisBroker`` uses (get/set/mget/delete/expire/incr, lpush/rpush/
    rpop/brpop/llen/lrange, scan_iter, time), returning bytes like a client
    with ``decode_responses=False``, with lazy TTL expiry; thread-safe.

    ``fault_hook``, when set, is called with the command's name before any
    state is touched: raising ``ConnectionError`` from it injects a
    transient fault (``RedisBroker``'s retries)."""

    def __init__(self):
        self._data: dict[str, object] = {}
        self._expiry: dict[str, float] = {}
        self._cond = threading.Condition()
        self.fault_hook: Callable[[str], None] | None = None

    def _fault(self, op: str) -> None:
        hook = self.fault_hook
        if hook is not None:
            hook(op)

    @staticmethod
    def _k(key) -> str:
        return key.decode() if isinstance(key, bytes) else str(key)

    @staticmethod
    def _b(value) -> bytes:
        return value if isinstance(value, bytes) else str(value).encode()

    def _live(self, key: str):
        """The value under ``key``, purged once its TTL passed; the caller
        holds the lock."""
        exp = self._expiry.get(key)
        if exp is not None and exp <= time.monotonic():
            self._data.pop(key, None)
            self._expiry.pop(key, None)
        return self._data.get(key)

    # -- strings ------------------------------------------------------------

    def set(self, key, value, ex=None):
        self._fault("set")
        key = self._k(key)
        with self._cond:
            self._data[key] = self._b(value)
            if ex is not None:
                self._expiry[key] = time.monotonic() + ex
            else:
                self._expiry.pop(key, None)
            self._cond.notify_all()
        return True

    def get(self, key):
        self._fault("get")
        with self._cond:
            v = self._live(self._k(key))
        return v if isinstance(v, bytes) else None

    def mget(self, keys):
        self._fault("mget")
        with self._cond:
            vals = [self._live(self._k(k)) for k in keys]
        return [v if isinstance(v, bytes) else None for v in vals]

    def delete(self, *keys):
        self._fault("delete")
        n = 0
        with self._cond:
            for key in keys:
                key = self._k(key)
                if self._live(key) is not None:
                    del self._data[key]
                    self._expiry.pop(key, None)
                    n += 1
        return n

    def expire(self, key, seconds):
        self._fault("expire")
        key = self._k(key)
        with self._cond:
            if self._live(key) is None:
                return False
            self._expiry[key] = time.monotonic() + seconds
        return True

    def incr(self, key, amount=1):
        self._fault("incr")
        key = self._k(key)
        with self._cond:
            v = self._live(key)
            n = (int(v) if v is not None else 0) + int(amount)
            self._data[key] = str(n).encode()
        return n

    # -- lists --------------------------------------------------------------

    def _list(self, key: str) -> list:
        lst = self._live(key)
        if lst is None:
            lst = []
            self._data[key] = lst
        return lst

    def _drop_if_empty(self, key: str) -> None:
        if not self._data.get(key):
            self._data.pop(key, None)
            self._expiry.pop(key, None)

    def lpush(self, key, *values):
        self._fault("lpush")
        key = self._k(key)
        with self._cond:
            lst = self._list(key)
            for v in values:
                lst.insert(0, self._b(v))
            self._cond.notify_all()
            return len(lst)

    def rpush(self, key, *values):
        self._fault("rpush")
        key = self._k(key)
        with self._cond:
            lst = self._list(key)
            lst.extend(self._b(v) for v in values)
            self._cond.notify_all()
            return len(lst)

    def rpop(self, key):
        self._fault("rpop")
        key = self._k(key)
        with self._cond:
            lst = self._live(key)
            if not lst:
                return None
            v = lst.pop()
            self._drop_if_empty(key)
            return v

    def brpop(self, key, timeout=0):
        self._fault("brpop")
        key = self._k(key)
        # timeout 0 blocks for ever, as Redis does; the wait polls in small
        # quanta so a lazy TTL purge elsewhere cannot wedge a waiter.
        deadline = time.monotonic() + (timeout if timeout else 3650 * 86400)
        with self._cond:
            while True:
                lst = self._live(key)
                if lst:
                    v = lst.pop()
                    self._drop_if_empty(key)
                    return (key.encode(), v)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._cond.wait(min(remaining, 0.05))

    def llen(self, key):
        self._fault("llen")
        with self._cond:
            lst = self._live(self._k(key))
            return len(lst) if isinstance(lst, list) else 0

    def lrange(self, key, start, stop):
        self._fault("lrange")
        with self._cond:
            lst = self._live(self._k(key))
            if not isinstance(lst, list):
                return []
            end = None if stop == -1 else stop + 1
            return list(lst[start:end])

    # -- server -------------------------------------------------------------

    def time(self):
        """Redis TIME, ``(seconds, microseconds)``: from
        ``time.monotonic()``, shared by everyone on this instance."""
        self._fault("time")
        now = time.monotonic()
        sec = int(now)
        return (sec, int((now - sec) * 1e6))

    # -- keyspace -----------------------------------------------------------

    def scan_iter(self, match="*"):
        self._fault("scan_iter")
        with self._cond:
            keys = [k for k in self._data if fnmatch.fnmatch(k, match)]
        for key in keys:
            with self._cond:
                if self._live(key) is not None:
                    yield key.encode()
