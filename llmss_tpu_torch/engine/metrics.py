"""Engine metrics: the subset of llmss_tpu/utils/metrics.py that the
generate path, the batch worker, the continuous batcher and its worker
record (latency timers with a bounded reservoir, request / token / error
/ preemption counters, the block-pool gauges and shared-prefix evictions, the batcher's
per-group host overhead and mixed-batch composition, and ``to_dict``),
under the reference's names, plus the decode step graphs' captures and
replays (engine/graphs.py)."""

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

    def quantile_ms(self, q: float) -> float | None:
        """The q-th percentile of the kept samples, in milliseconds."""
        with self._lock:
            s = sorted(self._samples)
        return _ms(self._pick(s, q))

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
        # The last speculative call's acceptance stats (set by engine/
        # speculative.py; None until one runs).
        self.spec_stats: dict | None = None
        self.ttft = LatencyStat("ttft")
        self.prefill = LatencyStat("prefill")
        self.decode_step = LatencyStat("decode_step")
        # Per-group host overhead of the continuous batcher: dispatch
        # (enqueue a group), fetch (the blocking packed device->host read),
        # callback (token accounting, stream flushes, row frees).
        self.host_dispatch = LatencyStat("host_dispatch")
        self.host_fetch = LatencyStat("host_fetch")
        self.host_callback = LatencyStat("host_callback")
        self._lock = threading.Lock()
        self.host_syncs = 0  # guarded_by: self._lock
        self.groups_dispatched = 0  # guarded_by: self._lock
        self.graph_captures = 0  # guarded_by: self._lock
        self.graph_replays = 0  # guarded_by: self._lock
        self.kv_blocks_total = 0  # guarded_by: self._lock
        self.kv_blocks_in_use = 0  # guarded_by: self._lock
        self.kv_block_seconds = 0.0  # guarded_by: self._lock
        # Idle shared-prefix block sets reclaimed to admit new work, split
        # by what became of them: demoted down a tier (serve/kvstore.py)
        # or dropped. The total is their sum.
        self.kv_block_evictions = 0  # guarded_by: self._lock
        self.kv_evictions_demoted = 0  # guarded_by: self._lock
        self.kv_evictions_dropped = 0  # guarded_by: self._lock
        self.finish_classes: dict[str, int] = {}  # guarded_by: self._lock
        self.mixed_steps = 0  # guarded_by: self._lock
        self.mixed_decode_rows = 0  # guarded_by: self._lock
        self.mixed_prefill_rows = 0  # guarded_by: self._lock
        self.prefill_tokens_chunked = 0  # guarded_by: self._lock
        self.chunk_budget_tokens = 0  # guarded_by: self._lock
        self.tokens_generated = 0  # guarded_by: self._lock
        self.requests_served = 0  # guarded_by: self._lock
        self.errors = 0  # guarded_by: self._lock
        self.cancelled = 0  # guarded_by: self._lock
        self.deadline_expired = 0  # guarded_by: self._lock
        self.poisoned = 0  # guarded_by: self._lock
        self.preempted = 0  # guarded_by: self._lock
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

    def add_preempted(self, n: int = 1) -> None:
        """Rows evicted mid-decode to admit a higher-class request."""
        self._add("preempted", n)

    def set_kv_blocks(self, total: int | None = None,
                      in_use: int | None = None) -> None:
        """Block-pool gauges from the batcher's BlockAllocator."""
        with self._lock:
            if total is not None:
                self.kv_blocks_total = total
            if in_use is not None:
                self.kv_blocks_in_use = in_use

    def add_kv_evictions(self, n: int = 1, demoted: bool = False) -> None:
        """``n`` idle shared-prefix block sets reclaimed, ``demoted`` down a
        tier or else dropped."""
        with self._lock:
            self.kv_block_evictions += n
            if demoted:
                self.kv_evictions_demoted += n
            else:
                self.kv_evictions_dropped += n

    def add_kv_block_seconds(self, s: float) -> None:
        """A row released blocks it held for ``blocks x held`` seconds."""
        with self._lock:
            self.kv_block_seconds += s

    def add_finish(self, disposition: str, n: int = 1) -> None:
        """A row reached a terminal disposition (served/cancelled/error)."""
        with self._lock:
            self.finish_classes[disposition] = (
                self.finish_classes.get(disposition, 0) + n
            )

    def add_mixed_steps(self, steps: int, decode_rows: int, prefill_rows: int,
                        prefill_tokens: int, budget_tokens: int) -> None:
        """One ragged group was planned: ``steps`` steps whose row-steps
        split into decode rows and chunk-fed prompt rows; ``prefill_tokens``
        prompt tokens streamed against ``budget_tokens`` of capacity."""
        with self._lock:
            self.mixed_steps += steps
            self.mixed_decode_rows += decode_rows
            self.mixed_prefill_rows += prefill_rows
            self.prefill_tokens_chunked += prefill_tokens
            self.chunk_budget_tokens += budget_tokens

    def add_host_sync(self, n: int = 1) -> None:
        """A blocking device->host fetch."""
        self._add("host_syncs", n)

    def add_group(self, n: int = 1) -> None:
        """A grouped decode or ragged program was dispatched."""
        self._add("groups_dispatched", n)

    def add_graph(self, captures: int = 0, replays: int = 0) -> None:
        """Decode step graphs captured (after a prewarm: the steady-state
        recompiles) and replayed."""
        with self._lock:
            self.graph_captures += captures
            self.graph_replays += replays

    def to_dict(self) -> dict:
        uptime = time.monotonic() - self._start
        with self._lock:
            toks, reqs, errs, canc, exp, pois, preempt = (
                self.tokens_generated, self.requests_served, self.errors,
                self.cancelled, self.deadline_expired, self.poisoned,
                self.preempted,
            )
            kv_total, kv_used, kv_bs = (
                self.kv_blocks_total, self.kv_blocks_in_use,
                self.kv_block_seconds,
            )
            kv_evic, kv_dem, kv_drop = (
                self.kv_block_evictions, self.kv_evictions_demoted,
                self.kv_evictions_dropped,
            )
            fin = dict(self.finish_classes)
            syncs, groups = self.host_syncs, self.groups_dispatched
            captures, replays = self.graph_captures, self.graph_replays
            m_steps, m_dec, m_pre, m_tok, m_budget = (
                self.mixed_steps, self.mixed_decode_rows,
                self.mixed_prefill_rows, self.prefill_tokens_chunked,
                self.chunk_budget_tokens,
            )
        return {
            "uptime_s": round(uptime, 1),
            "requests_served": reqs,
            "tokens_generated": toks,
            "errors": errs,
            "cancelled": canc,
            "deadline_expired": exp,
            "poisoned_rows": pois,
            "preempted_rows": preempt,
            "tokens_per_sec_lifetime": round(toks / uptime, 2) if uptime else 0,
            "ttft": self.ttft.to_dict(),
            "prefill": self.prefill.to_dict(),
            "decode_step": self.decode_step.to_dict(),
            "kv_blocks_total": kv_total,
            "kv_blocks_in_use": kv_used,
            "kv_block_evictions": kv_evic,
            "kv_evictions_demoted": kv_dem,
            "kv_evictions_dropped": kv_drop,
            "kv_block_seconds": round(kv_bs, 6),
            **({"finish_classes": fin} if fin else {}),
            "graph_captures": captures,
            "graph_replays": replays,
            "host_overhead": {
                "host_syncs": syncs,
                "groups_dispatched": groups,
                "dispatch": self.host_dispatch.to_dict(),
                "fetch": self.host_fetch.to_dict(),
                "callback": self.host_callback.to_dict(),
            },
            "mixed_batch": {
                "steps": m_steps,
                "decode_rows": m_dec,
                "prefill_rows": m_pre,
                "prefill_tokens_chunked": m_tok,
                "chunk_budget_tokens": m_budget,
                "chunk_budget_utilization": (
                    round(m_tok / m_budget, 4) if m_budget else None
                ),
            },
            **(
                {"speculative": self.spec_stats}
                if self.spec_stats is not None else {}
            ),
        }
