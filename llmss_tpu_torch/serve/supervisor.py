"""Serving-loop supervision: lifecycle, crash containment, restart,
liveness (counterpart: llmss_tpu/serve/supervisor.py).

The supervisor owns the worker's loop (it calls ``worker.run_once()``) and:

- publishes the lifecycle state (``starting -> ready -> draining ->
  dead``) and a heartbeat through the broker's metrics channel, merged
  into every publish (``broker.metrics_extra``), with the worker's load
  snapshot beside it (``worker``: the fleet registry that carries it in
  the reference is left for a later slice);
- drains on ``drain()`` (SIGTERM in ``consumer.main``): the worker stops
  leasing, its active rows finish and ack, and the loop exits; past the
  deadline never-started requests go back to the broker and active rows
  are aborted with an error;
- runs a watchdog thread that raises ``WatchdogTimeout`` into a loop that
  has made no progress for ``step_timeout_s``. The clock starts at the
  worker's first progress stamp (``last_progress_ts``, stamped after each
  served group), never during the factory's build and prewarm. The
  exception lands when the loop thread next runs Python bytecode, so a
  replay stuck in the CUDA runtime is not interrupted; what the watchdog
  promises then is that ``/health`` reads 503 (the heartbeat is progress
  based and goes stale after 3 x ``heartbeat_s``);
- contains crashes: an exception escaping an iteration (or the factory)
  aborts the worker's in-flight requests, drops every reference to the
  worker (so its KV pool and step graphs are freed before the next one is
  built), and rebuilds it after a capped exponential backoff, reset after
  a stable run;
- bounds restarts by ``max_restarts`` over a sliding window: the count
  resets after each stable run, so it bounds crash density.

Left out: the reference's last-routable-replica drain guard (its
``drain_blocked`` advisory), which needs the fleet registry.
"""

from __future__ import annotations

import ctypes
import gc
import logging
import sys
import threading
import time
from typing import Callable

from llmss_tpu_torch.serve.protocol import (
    STATE_DEAD, STATE_DRAINING, STATE_READY, STATE_STARTING,
)

logger = logging.getLogger("llmss_tpu_torch.serve")


class WatchdogTimeout(BaseException):
    """Raised asynchronously into a worker loop that made no progress for
    ``step_timeout_s``. A ``BaseException`` so that the workers' per-batch
    ``except Exception`` containment does not swallow it."""


class Supervisor:
    def __init__(
        self,
        worker_factory: Callable[[], object],
        broker,
        *,
        max_restarts: int | None = None,
        backoff_s: float = 1.0,
        backoff_cap_s: float = 60.0,
        stable_after_s: float = 120.0,
        heartbeat_s: float = 5.0,
        drain_timeout_s: float = 30.0,
        step_timeout_s: float | None = None,
    ):
        self.worker_factory = worker_factory
        self.broker = broker
        self.max_restarts = max_restarts
        self.backoff_s = backoff_s
        self.backoff_cap_s = backoff_cap_s
        self.stable_after_s = stable_after_s
        self.heartbeat_s = heartbeat_s
        self.drain_timeout_s = drain_timeout_s
        # None: no watchdog thread.
        self.step_timeout_s = step_timeout_s
        self.restarts = 0
        # Written by the loop thread and the watchdog thread.
        self._state_lock = threading.Lock()
        self.alive = False  # guarded_by: self._state_lock
        self.state = STATE_STARTING
        self.watchdog_stalls = 0  # guarded_by: self._state_lock
        self._last_error: str | None = None  # guarded_by: self._state_lock
        self._stall_fired = False  # guarded_by: self._state_lock
        # The delay the next restart pays: doubles per crash, back to
        # backoff_s after a stable run.
        self.backoff_current = backoff_s
        self._start = time.monotonic()
        self._drain = threading.Event()
        self._drain_deadline: float | None = None  # monotonic
        # The supervisor's progress stamp (between iterations); the
        # worker's own is ``last_progress_ts``. Monotonic.
        self._progress_ts = time.monotonic()
        self._worker = None
        self._loop_ident: int | None = None
        self._watchdog_stop = threading.Event()
        self._watchdog_thread: threading.Thread | None = None
        broker.metrics_extra = self._extra

    # -- status ------------------------------------------------------------------

    def _progress_mono(self) -> float:
        w = self._worker
        worker_ts = getattr(w, "last_progress_ts", 0.0) if w is not None else 0.0
        return max(self._progress_ts, worker_ts or 0.0)

    def _status(self) -> dict:
        # heartbeat_ts is read in another process (the producer), so it is
        # published on the wall clock; progress is kept monotonic.
        age = time.monotonic() - self._progress_mono()
        return {
            "alive": self.alive,
            "state": self.state,
            "restarts": self.restarts,
            "watchdog_stalls": self.watchdog_stalls,
            "step_timeout_s": self.step_timeout_s,
            "last_error": self._last_error,
            "uptime_s": round(time.monotonic() - self._start, 1),
            "heartbeat_ts": round(time.time() - age, 3),
            "heartbeat_s": self.heartbeat_s,
            "backoff_current_s": self.backoff_current,
        }

    def _extra(self) -> dict:
        """Merged into every publish: the health block, and the worker's
        host-side load snapshot when it has one."""
        out = {"supervisor": self._status()}
        snap = getattr(self._worker, "load_snapshot", None)
        if snap is not None:
            out["worker"] = snap()
        return out

    def _publish(self, worker) -> None:
        engine = getattr(worker, "engine", None)
        metrics = engine.metrics.to_dict() if engine is not None else {}
        try:
            self.broker.publish_metrics(metrics)
        except Exception:  # noqa: BLE001 — broker down is not worker down
            logger.warning("metrics publish failed", exc_info=True)

    def _abort_inflight(self, worker, reason: str) -> None:
        """Error out every request the worker holds: a client always gets
        an answer, even across a restart."""
        abort = getattr(worker, "abort_inflight", None)
        if abort is None:
            return
        try:
            n = abort(reason)
            if n:
                logger.warning("aborted %d in-flight requests", n)
        except Exception:  # noqa: BLE001 — teardown must not mask the crash
            logger.warning("in-flight abort failed", exc_info=True)

    # -- drain ---------------------------------------------------------------------

    def drain(self, timeout_s: float | None = None) -> None:
        """Begin a graceful shutdown (thread-safe; the SIGTERM handler
        calls it). Past the deadline (``timeout_s``, default
        ``drain_timeout_s``) pending requests are released and active rows
        aborted; a later call moves the deadline."""
        self._drain_deadline = time.monotonic() + (
            self.drain_timeout_s if timeout_s is None else timeout_s
        )
        self._drain.set()

    @property
    def draining(self) -> bool:
        return self._drain.is_set()

    def _finish_drain(self, worker, clean: bool) -> None:
        if clean:
            logger.info("drain complete: worker exited cleanly")
            return
        logger.warning("drain deadline exceeded; releasing pending work and "
                       "aborting active rows")
        release = getattr(worker, "release_pending", None)
        if release is not None:
            try:
                n = release()
                if n:
                    logger.warning("released %d never-started requests", n)
            except Exception:  # noqa: BLE001
                logger.warning("pending release failed", exc_info=True)
        self._abort_inflight(worker, "worker draining: drain deadline exceeded")

    # -- watchdog --------------------------------------------------------------------

    def _start_watchdog(self) -> None:
        if self.step_timeout_s is None or self._watchdog_thread is not None:
            return
        self._watchdog_stop = threading.Event()
        t = threading.Thread(target=self._watchdog_loop,
                             name="llmss-watchdog", daemon=True)
        self._watchdog_thread = t
        t.start()

    def _stop_watchdog(self) -> None:
        t = self._watchdog_thread
        if t is None:
            return
        self._watchdog_stop.set()
        t.join(timeout=5.0)
        self._watchdog_thread = None

    def _armed(self) -> bool:
        """A ready worker that has stamped progress at least once (workers
        without a stamp are watched from the moment they are ready)."""
        w = self._worker
        return self.alive and getattr(w, "last_progress_ts", 1.0) > 0

    def _watchdog_loop(self) -> None:
        stop = self._watchdog_stop
        poll = max(min(self.step_timeout_s / 4.0, 1.0), 0.01)
        while not stop.wait(poll):
            if self._stall_fired or not self._armed():
                continue
            ident = self._loop_ident
            stalled_for = time.monotonic() - self._progress_mono()
            if stalled_for <= self.step_timeout_s or ident is None:
                continue
            with self._state_lock:
                self._stall_fired = True
                self.watchdog_stalls += 1
                self.alive = False
                self._last_error = (
                    f"watchdog: no progress for {stalled_for:.2f}s "
                    f"(step_timeout_s={self.step_timeout_s})"
                )
            logger.error("%s; escalating as a crash", self._last_error)
            # The loop thread is the one blocked: publish for it.
            self._publish(self._worker)
            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_ulong(ident), ctypes.py_object(WatchdogTimeout))

    # -- loop ---------------------------------------------------------------------

    def run(self, stop: threading.Event | None = None) -> None:
        """The supervised loop; returns when ``stop`` is set or a drain
        completes, raises when the restart budget is exhausted."""
        self.backoff_current = self.backoff_s
        self._loop_ident = threading.get_ident()
        self._start_watchdog()
        try:
            while stop is None or not stop.is_set():
                worker = None
                started = time.monotonic()
                last_beat = 0.0
                try:
                    # A factory failure is a crash too (backoff and budget).
                    self.state = STATE_STARTING
                    self._progress_ts = time.monotonic()
                    if self.restarts:
                        # Whatever cycles still hold the crashed worker (and
                        # its KV pool and graphs) go before the next is built.
                        gc.collect()
                    worker = self._worker = self.worker_factory()
                    self._progress_ts = time.monotonic()
                    with self._state_lock:
                        self._stall_fired = False
                        self.alive = True
                    self.state = STATE_READY
                    self._publish(worker)
                    drain_signaled = False
                    while stop is None or not stop.is_set():
                        if self._drain.is_set() and not drain_signaled:
                            drain_signaled = True
                            self.state = STATE_DRAINING
                            begin = getattr(worker, "begin_drain", None)
                            if begin is not None:
                                begin()
                            self._publish(worker)
                            last_beat = time.monotonic()
                        worker.run_once()
                        now = self._progress_ts = time.monotonic()
                        if now - last_beat >= self.heartbeat_s:
                            self._publish(worker)
                            last_beat = now
                        if now - started > self.stable_after_s:
                            self.backoff_current = self.backoff_s
                            self.restarts = 0
                        if drain_signaled:
                            if getattr(worker, "drained", True):
                                self._finish_drain(worker, clean=True)
                                return
                            dl = self._drain_deadline
                            if dl is not None and now >= dl:
                                self._finish_drain(worker, clean=False)
                                return
                    return  # stop was set
                except (WatchdogTimeout, Exception) as e:  # noqa: BLE001
                    with self._state_lock:
                        self.alive = False
                        self._last_error = f"{type(e).__name__}: {e}"
                    self.restarts += 1
                    logger.error("worker crashed (%s), restart %d in %.1fs",
                                 self._last_error, self.restarts,
                                 self.backoff_current)
                    if worker is not None:
                        self._abort_inflight(worker, self._last_error)
                    self._publish(worker)
                    # Drop the crashed worker before building the next one:
                    # its KV pool and step graphs are freed with it.
                    worker = self._worker = None
                    if self._drain.is_set():
                        logger.warning("crash during drain; not restarting")
                        return
                    if (self.max_restarts is not None
                            and self.restarts > self.max_restarts):
                        raise RuntimeError(
                            f"worker exceeded restart budget "
                            f"({self.max_restarts}); last error: "
                            f"{self._last_error}") from e
                    if stop is not None:
                        if stop.wait(self.backoff_current):
                            return
                    else:
                        time.sleep(self.backoff_current)
                    self.backoff_current = min(self.backoff_current * 2,
                                               self.backoff_cap_s)
        finally:
            # The state machine ends in dead however the loop leaves. A
            # lifecycle exit (drain, budget, an exception) publishes it; an
            # external stop leaves the last live heartbeat in the channel.
            self._stop_watchdog()
            lifecycle_exit = self._drain.is_set() or sys.exc_info()[0] is not None
            with self._state_lock:
                self.alive = False
            self.state = STATE_DEAD
            if lifecycle_exit:
                self._publish(self._worker)
