"""Engine metrics: the subset of llmss_tpu/utils/metrics.py the dense
generate path and the batch worker record (latency timers with a bounded
reservoir, request / token / error counters, and ``to_dict``)."""

from __future__ import annotations

import contextlib
import random
import threading
import time


class LatencyStat:
    """Bounded-reservoir latency recorder with percentile readout."""

    def __init__(self, name: str, max_samples: int = 4096):
        self.name = name
        self.max_samples = max_samples
        self._samples: list[float] = []  # guarded_by: self._lock
        self._count = 0  # guarded_by: self._lock
        self._total = 0.0  # guarded_by: self._lock
        self.last_s: float | None = None  # guarded_by: self._lock
        self._rng = random.Random(name)  # guarded_by: self._lock
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        with self._lock:
            self._count += 1
            self._total += seconds
            self.last_s = seconds
            if len(self._samples) >= self.max_samples:
                # Algorithm-R reservoir: every sample equally likely kept.
                j = self._rng.randrange(self._count)
                if j < self.max_samples:
                    self._samples[j] = seconds
            else:
                self._samples.append(seconds)

    @contextlib.contextmanager
    def time(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(time.perf_counter() - t0)

    @staticmethod
    def _pick(s: list[float], q: float) -> float | None:
        if not s:
            return None
        return s[min(int(q / 100.0 * len(s)), len(s) - 1)]

    def to_dict(self) -> dict:
        with self._lock:
            n = self._count
            mean = self._total / n if n else None
            s = sorted(self._samples)
        return {
            "count": n,
            "mean_ms": _ms(mean),
            "p50_ms": _ms(self._pick(s, 50)),
            "p95_ms": _ms(self._pick(s, 95)),
            "p99_ms": _ms(self._pick(s, 99)),
        }


def _ms(v: float | None) -> float | None:
    return round(v * 1e3, 3) if v is not None else None


class EngineMetrics:
    """Aggregated counters for one engine / worker."""

    def __init__(self):
        self.ttft = LatencyStat("ttft")
        self.prefill = LatencyStat("prefill")
        self.decode_step = LatencyStat("decode_step")
        self._lock = threading.Lock()
        self.tokens_generated = 0  # guarded_by: self._lock
        self.requests_served = 0  # guarded_by: self._lock
        self.errors = 0  # guarded_by: self._lock
        self.cancelled = 0  # guarded_by: self._lock
        self.deadline_expired = 0  # guarded_by: self._lock
        self.poisoned = 0  # guarded_by: self._lock
        self._start = time.monotonic()

    def _add(self, field: str, n: int) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def add_tokens(self, n: int) -> None:
        self._add("tokens_generated", n)

    def add_request(self, n: int = 1) -> None:
        self._add("requests_served", n)

    def add_error(self, n: int = 1) -> None:
        self._add("errors", n)

    def add_cancelled(self, n: int = 1) -> None:
        self._add("cancelled", n)

    def add_expired(self, n: int = 1) -> None:
        """Requests shed before prefill: their deadline had passed."""
        self._add("deadline_expired", n)

    def add_poisoned(self, n: int = 1) -> None:
        """Rows errored out because their logits went non-finite."""
        self._add("poisoned", n)

    def to_dict(self) -> dict:
        uptime = time.monotonic() - self._start
        with self._lock:
            toks, reqs, errs, canc, exp, pois = (
                self.tokens_generated, self.requests_served, self.errors,
                self.cancelled, self.deadline_expired, self.poisoned,
            )
        return {
            "uptime_s": round(uptime, 1),
            "requests_served": reqs,
            "tokens_generated": toks,
            "errors": errs,
            "cancelled": canc,
            "deadline_expired": exp,
            "poisoned_rows": pois,
            "tokens_per_sec_lifetime": round(toks / uptime, 2) if uptime else 0,
            "ttft": self.ttft.to_dict(),
            "prefill": self.prefill.to_dict(),
            "decode_step": self.decode_step.to_dict(),
        }
