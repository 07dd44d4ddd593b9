"""Serving workers and the consumer entry point (counterpart:
llmss_tpu/serve/consumer.py): the batch ``Worker``, the continuous
``ContinuousWorker`` and ``main``.

``Worker.run_once`` takes up to ``batch_size`` requests from the broker,
sheds cancelled and expired ones, validates each (bad requests and
requests that would overflow the ring get an error response of their own),
pads the batch to its envelope with inert rows, runs ``engine.generate``
with grouped decode, streams increments for ``stream`` requests, and
answers every row: tokens, ``cancelled`` with the partial tokens, or a
per-row poison error while batch-mates keep their tokens.

``ContinuousWorker`` feeds the broker's requests into a
``ContinuousBatcher`` and answers each one exactly once from the batcher's
callbacks. A request's ``prefix_token_ids`` hint is served: the worker
keeps the last ``max_prefixes`` prefixes it built
(``DecodeEngine.build_prefix``, an LRU keyed by their tokens) and submits
the request with its prefix, which gives the tokens of the request without
the hint. The batch ``Worker`` ignores the prefix hint, as the
reference's does.

The tiered KV store (``ContinuousWorker(kvstore=)``, serve/kvstore.py):
prefixes the batcher's pool or the worker's LRU evicts are demoted to host
RAM and the blob store instead of dropped; a prefix the LRU lacks is first
promoted from the store, and built only when no tier has it; a finished
turn of a request carrying ``session_id`` parks its full blocks, and the
session's next turn seeds from them when they prefix its prompt, so only
the new tokens prefill. The prefill role never parks (its rows end at
export); the decode role parks the rows it adopted. A parked turn is
encoded (CRC and join) on the serving thread before its answer, as in the
reference, so the blob is stored before the client sees the turn end.
Without a store ``session_id`` rides along unparked, as in a reference
worker without one.

Roles (``ContinuousWorker(role=)``):

- ``"unified"`` admits and decodes, and preempts: a running row outranked
  by a blocked head request is evicted, its emitted tokens stamped on the
  request as ``resume_tokens`` and the request refunded to the broker
  (``preempt_requests``); whichever worker leases it next replays those
  tokens as prompt and decodes only the rest, with the same tokens.
- ``"prefill"`` admits only: each request's blocks are exported at its
  first token, encoded (serve/handoff.py) and pushed on the broker's
  handoff channel, which settles the request's lease; a one-token request
  is answered here.
- ``"decode"`` leases handoff records instead of requests and adopts their
  blocks (``ContinuousBatcher.adopt``). A record that finds no free row
  waits in a local backlog whose leases are renewed every ``run_once``; a
  record that cannot be adopted (corrupt payload, another pool layout) is
  failed back to the broker, which prefills its request again.

Both workers stamp ``last_progress_ts`` (the supervisor's watchdog and
heartbeat read it) and renew the leases they hold every group.

The fleet (serve/fleet.py): a worker given a ``worker_id`` registers in the
broker's registry with its capabilities (``worker_capabilities``) and
publishes its ``load_snapshot`` every ``snapshot_interval_s`` (host-side
occupancy, pool headroom, resident prefix hashes, the store's
``kv_tiers``, ``heartbeat_ts`` / ``heartbeat_s`` for
``producer.evaluate_worker_health`` and the flight recorder's snapshot);
it pops its routed queue before the shared one, and a prefill-role worker
routes each record to the decode replica ``pick_decode_worker`` chooses
(the shared handoff queue when none is registered), while a decode-role
worker pops its routed records first. The heartbeat also carries the
windowed series (``series().export``) and the devtel blob, and each
publish records the broker's queue depths by class as a counter track
(consumer.py:171-176, :557-576).

``main`` (``llmss-torch-consumer``) serves a checkpoint from a Redis
broker on one GPU, optionally under the ``Supervisor``, or on a mesh
(``--tp`` / ``--dp`` / ``--sp``, one process a rank under ``torchrun``,
consumer.py:1166-1179): every rank loads its slices and steps the same
batcher (or runs the same batches), and rank 0 alone holds the broker,
registers and heartbeats in the fleet, publishes and answers
(parallel/serving.py: a worker given a ``control`` leads, the other
ranks ``follow``). There is no tokenizer, so requests carry
``token_ids``.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque

from llmss_tpu_torch.engine.engine import DecodeEngine, GenerationParams
from llmss_tpu_torch.engine.scheduler import ContinuousBatcher
from llmss_tpu_torch.serve.broker import Broker
from llmss_tpu_torch.serve.handoff import (
    HandoffRecord, decode_blocks, encode_blocks, pick_decode_worker,
)
from llmss_tpu_torch.serve.kvstore import (
    HostKVStore, RedisBlobStore, TieredKVStore, prefix_from_blocks,
)
from llmss_tpu_torch.serve.protocol import (
    SLO_CLASS_RANK, STATE_DRAINING, STATE_READY, GenerateRequest,
    GenerateResponse, prefix_hash,
)
from llmss_tpu_torch.utils import devtel
from llmss_tpu_torch.utils import metrics as metrics_mod
from llmss_tpu_torch.utils import trace

# How long an idle worker blocks on the queue before it looks again.
POLL_TIMEOUT_S = 0.2
# The prefixes a continuous worker keeps built (an LRU by their tokens; on
# a mesh, the control's on every rank).
MAX_PREFIXES = 4

logger = logging.getLogger("llmss_tpu_torch.serve")


def worker_capabilities(worker_id: str, engine, role: str = "unified") -> dict:
    """The registration payload (consumer.py:47): identity, role and what
    the replica serves; an engine stand-in without these attributes gives
    its class name and Nones."""
    cfg = getattr(engine, "cfg", None)
    return {
        "worker_id": worker_id,
        "role": role,
        "model": getattr(cfg, "model_type", None) or type(engine).__name__,
        "kv_layout": getattr(engine, "kv_layout", None),
        "kv_blocks": getattr(engine, "kv_blocks", None),
        "max_seq_len": getattr(engine, "max_seq_len", None),
    }


class _FleetMember:
    """Registration, load heartbeats and routed pops, shared by both
    workers (consumer.py:132-198, :514-598). Without a ``worker_id`` a
    worker stays out of the registry and pops the shared queue only."""

    worker_id: str | None = None
    snapshot_interval_s = 1.0
    _last_snapshot_t = 0.0

    def _heartbeat(self) -> dict:
        """The stamps ``evaluate_worker_health`` judges (``heartbeat_ts`` on
        the wall clock: another process reads its age), the flight
        recorder's snapshot, the windowed series (cached for a second) and
        the devtel blob."""
        return {
            "heartbeat_s": self.snapshot_interval_s,
            "heartbeat_ts": time.time(),
            **({"trace": trace.recorder().export(max_events=256),
                "series": metrics_mod.series().export(cache_s=1.0)}
               if trace.enabled() else {}),
            **({"devtel": devtel.export()} if devtel.enabled() else {}),
        }

    def register(self) -> None:
        """(Re-)announce this worker; safe to call again after its entry
        aged out of the registry."""
        self.broker.register_worker(
            worker_capabilities(self.worker_id, self.engine, self.role))
        self._publish_load()

    def _publish_load(self) -> None:
        if self.worker_id is not None:
            self._last_snapshot_t = time.monotonic()
            self.broker.publish_worker_load(self.worker_id,
                                            self.load_snapshot())

    def _maybe_publish_load(self) -> None:
        if (self.worker_id is not None
                and time.monotonic() - self._last_snapshot_t
                >= self.snapshot_interval_s):
            self._publish_load()

    def _pop(self, timeout: float = 0.0) -> GenerateRequest | None:
        return self.broker.pop_request(timeout=timeout,
                                       worker_id=self.worker_id)


def encode_request(tokenizer, req: GenerateRequest) -> list[int]:
    if req.token_ids is not None:
        return list(req.token_ids)
    if tokenizer is None:
        raise ValueError("no tokenizer configured; send token_ids")
    return tokenizer(req.prompt)["input_ids"]


def gen_params_from(tokenizer, req: GenerateRequest) -> GenerationParams:
    eos = tokenizer.eos_token_id if tokenizer is not None else None
    return GenerationParams(
        max_new_tokens=req.max_new_tokens,
        is_greedy=req.is_greedy,
        temperature=req.temperature,
        top_k=req.top_k,
        top_p=req.top_p,
        eos_token_id=eos,
        seed=req.seed,
    )


class Worker(_FleetMember):
    role = "unified"  # a batch worker prefills and decodes

    def __init__(
        self,
        engine: DecodeEngine,
        broker: Broker,
        tokenizer=None,
        batch_size: int = 8,
        chunk_steps: int = 8,
        poll_timeout_s: float = POLL_TIMEOUT_S,
        worker_id: str | None = None,
        snapshot_interval_s: float = 1.0,
        control=None,
    ):
        self.engine = engine
        self.broker = broker
        self.tokenizer = tokenizer
        # A mesh's leader (parallel/serving.py): each batch, each chunk's
        # cancellations and the prewarm go to every rank.
        self.control = control
        self.batch_size = batch_size
        # Decode steps per host round-trip (engine.generate chunking).
        self.chunk_steps = chunk_steps
        # How long run_once blocks for a first request.
        self.poll_timeout_s = poll_timeout_s
        self.worker_id = worker_id
        self.snapshot_interval_s = snapshot_interval_s
        self._inflight_rows = 0
        # Once draining, run_once leases nothing; the batch worker holds
        # requests only inside run_once, so it is drained at once.
        self.draining = False
        # Monotonic stamp of the last progress (batch boundaries and every
        # decode chunk, so a long batch keeps the heartbeat fresh); 0.0
        # until the first batch.
        self.last_progress_ts = 0.0
        if worker_id is not None:
            self.register()

    def load_snapshot(self) -> dict:
        """The registry heartbeat (consumer.py:139): host counters only."""
        return {
            "role": self.role,
            "state": STATE_DRAINING if self.draining else STATE_READY,
            "alive": True,
            "rows": self.batch_size,
            "inflight_rows": self._inflight_rows,
            "free_slots": self.batch_size - self._inflight_rows,
            "queue_depth": 0,  # nothing is held between batches
            "free_kv_blocks": None,
            "kv_blocks_total": None,
            "prefix_hashes": [],
            **self._heartbeat(),
        }

    def begin_drain(self) -> None:
        self.draining = True

    @property
    def drained(self) -> bool:
        return self.draining

    def _gather(self) -> list[GenerateRequest]:
        """Block briefly for one request, then drain up to batch_size."""
        first = self._pop(timeout=self.poll_timeout_s)
        if first is None:
            return []
        batch = [first]
        while len(batch) < self.batch_size:
            nxt = self._pop()
            if nxt is None:
                break
            batch.append(nxt)
        return batch

    def run_once(self) -> int:
        """Serve one batch; returns the number of requests taken."""
        self._maybe_publish_load()
        if self.draining:
            return 0
        batch = self._gather()
        self.last_progress_ts = time.monotonic()
        if not batch:
            if self.control is not None:
                self.control.tick()
            return 0
        metrics = self.engine.metrics
        cancelled = self.broker.check_cancelled([r.id for r in batch])
        prompts, gens, ok = [], [], []
        for req in batch:
            if req.id in cancelled:
                metrics.add_cancelled()
                self.broker.push_response(GenerateResponse(id=req.id, error="cancelled"))
                continue
            if req.deadline_ts is not None and time.time() > req.deadline_ts:
                metrics.add_expired()
                self.broker.push_response(
                    GenerateResponse(id=req.id, error="deadline exceeded")
                )
                continue
            try:
                req.validate()
                ids = encode_request(self.tokenizer, req)
                gp = gen_params_from(self.tokenizer, req)
                if req.resume_tokens:
                    ids = ids + list(req.resume_tokens)
                    gp.max_new_tokens = req.max_new_tokens - len(req.resume_tokens)
                self.engine.check_capacity(len(ids), gp.max_new_tokens)
                prompts.append(ids)
                gens.append(gp)
                ok.append(req)
            except ValueError as e:  # per-request error surface
                self.broker.push_response(GenerateResponse(id=req.id, error=str(e)))
        if not ok:
            return len(batch)

        # Pad every batch to batch_size with inert rows so the engine always
        # sees one batch shape.
        n_live = len(prompts)
        if n_live < self.batch_size:
            pad = self.batch_size - n_live
            prompts = prompts + [[0]] * pad
            gens = gens + [GenerationParams(max_new_tokens=1, is_greedy=True)] * pad

        mid_cancelled: set[str] = set()

        def cancel_poll():
            self.last_progress_ts = time.monotonic()
            self.broker.publish_metrics(metrics.to_dict())
            self._maybe_publish_load()
            self.broker.touch_requests([r.id for r in ok])
            hits = self.broker.check_cancelled(
                [r.id for r in ok if r.id not in mid_cancelled]
            )
            if hits:
                metrics.add_cancelled(len(hits))
                mid_cancelled.update(hits)
            return [i for i, r in enumerate(ok) if r.id in hits]

        def on_increment(row, new_toks):
            if row < n_live and ok[row].stream:
                self.broker.push_stream(ok[row].id, new_toks)

        poisoned_rows: set[int] = set()
        self._inflight_rows = n_live
        t_batch = time.monotonic()
        if self.control is not None:
            cancel_poll = self.control.lead_generate(
                prompts, gens, self.chunk_steps, n_live, cancel_poll)
        try:
            outs = self.engine.generate(
                prompts, gens, cancel_poll=cancel_poll,
                on_increment=on_increment, on_poisoned=poisoned_rows.add,
                chunk_steps=self.chunk_steps, live_rows=n_live,
            )
            if self.control is not None:
                self.control.generated(outs)
            outs = outs[:n_live]
        except Exception as e:  # noqa: BLE001 — batch failure containment
            if self.control is not None:
                raise  # the other ranks are inside this batch's collectives
            logger.exception("batch failed")
            metrics.add_error(len(ok))
            for req in ok:
                self.broker.push_response(
                    GenerateResponse(id=req.id, error=f"engine error: {e}")
                )
            self.broker.publish_metrics(metrics.to_dict())
            return len(batch)
        finally:
            self.last_progress_ts = time.monotonic()
            self._inflight_rows = 0

        dur_batch = time.monotonic() - t_batch
        for req in ok:
            trace.record(req.id, "decode", trace_id=req.trace_id,
                         dur_s=dur_batch, worker=self.worker_id, batch=n_live)
        for row, (req, toks) in enumerate(zip(ok, outs)):
            if req.resume_tokens:
                toks = list(req.resume_tokens) + toks
            if row in poisoned_rows:
                metrics.add_poisoned()
                self.broker.push_response(GenerateResponse(
                    id=req.id, token_ids=toks,
                    error="non-finite logits: row poisoned (NaN/inf in model output)",
                ))
                continue
            if req.id in mid_cancelled:
                self.broker.push_response(
                    GenerateResponse(id=req.id, error="cancelled", token_ids=toks)
                )
                continue
            text = self.tokenizer.decode(toks) if self.tokenizer is not None else None
            self.broker.push_response(GenerateResponse(
                id=req.id, prompt=req.prompt, continuation=text, token_ids=toks,
            ))
        self.broker.publish_metrics(metrics.to_dict())
        return len(batch)

    def run_forever(self, stop: threading.Event | None = None) -> None:
        while stop is None or not stop.is_set():
            self.run_once()

    def prewarm(self) -> int:
        """Warm the worker's whole envelope before it serves
        (consumer.py:208): every prompt bucket at the padded batch size and
        every decode step graph of its chunked decode (on a mesh, every
        rank)."""
        if self.control is not None:
            self.control.lead_prewarm(self.batch_size, self.chunk_steps)
        return self.engine.prewarm(self.batch_size,
                                   chunk_steps=self.chunk_steps)


ROLES = ("unified", "prefill", "decode")


class ContinuousWorker(_FleetMember):
    """Serving loop over the continuous batcher: requests join the running
    batch at group granularity (module docstring: the roles and the
    fleet)."""

    def __init__(
        self,
        engine: DecodeEngine,
        broker: Broker,
        tokenizer=None,
        rows: int = 8,
        chunk_steps: int = 8,
        group_chunks: int = 1,
        chunked_prefill: int | None = None,
        role: str = "unified",
        poll_timeout_s: float = POLL_TIMEOUT_S,
        kvstore=None,
        worker_id: str | None = None,
        snapshot_interval_s: float = 1.0,
        control=None,
    ):
        if role not in ROLES:
            raise ValueError(f"unknown worker role: {role!r}")
        if control is not None:
            for what, on in (("a prefill or decode role", role != "unified"),
                             ("a tiered KV store", kvstore is not None)):
                if on:
                    raise NotImplementedError(
                        f"{what} on a mesh is the next mesh slice (ROADMAP, "
                        "Queue 1 item 8)")
        self.engine = engine
        self.broker = broker
        self.tokenizer = tokenizer
        self.role = role
        # How long an idle run_once blocks for a request or a record.
        self.poll_timeout_s = poll_timeout_s
        self.batcher = ContinuousBatcher(
            engine, rows=rows, chunk_steps=chunk_steps,
            group_chunks=group_chunks, chunked_prefill=chunked_prefill,
            prefill_only=role == "prefill",
        )
        # Every request inside the batcher, by id: preemption stamps the
        # resume point on the original request object, and a handoff
        # record carries it.
        self._reqs: dict[str, GenerateRequest] = {}
        if role == "prefill":
            self.batcher.export_cb = self._on_export
        elif role == "unified":
            # Only a worker that both admits from the request queue and
            # decodes preempts.
            self.batcher.preempt_cb = self._on_preempt
        # The tiered KV store (serve/kvstore.py), or None: evictions drop
        # and sessions prefill their whole history.
        self.kvstore = kvstore
        if kvstore is not None:
            self.batcher.demote_cb = self._on_demote
            self.batcher.park_cb = self._on_park
        # req_id -> session_id of the requests whose finish parks: set
        # before submit / adopt, taken by the park hook or the done_cb.
        self._park_sessions: dict[str, str] = {}
        # Decode role: leased records that found no free row yet.
        self._adopt_backlog: deque = deque()
        self._publish_counter = 0
        self.draining = False
        # Monotonic stamp after every served group; 0.0 until the first,
        # so the watchdog's clock never runs during build and prewarm.
        self.last_progress_ts = 0.0
        # Prefixes built for requests' prefix_token_ids, keyed by their
        # tokens, least recently used first.
        self._prefixes: dict[tuple, object] = {}
        self.max_prefixes = MAX_PREFIXES
        # The fleet identity: None keeps the worker out of the registry.
        self.worker_id = worker_id
        self.snapshot_interval_s = snapshot_interval_s
        # A mesh's leader (parallel/serving.py): the batcher's events go to
        # every rank, and prefixes are built there, by their tokens.
        self.control = control
        if control is not None:
            control.attach(self.batcher, self.max_prefixes)
        if worker_id is not None:
            self.register()

    def load_snapshot(self) -> dict:
        """The batcher's host-side occupancy and pool headroom with the
        lifecycle state and the hashes of the prefixes held by either
        layer, the batcher's pool and this worker's LRU, the store's
        ``kv_tiers``, the heartbeat stamps, the recorder's snapshot, the
        windowed series and the devtel blob (consumer.py:522), and records
        the queue depths by class as a counter track; touches no device
        tensor."""
        snap = self.batcher.load_snapshot()
        hashes = set(snap.get("prefix_hashes") or [])
        hashes.update(prefix_hash(k) for k in self._prefixes)
        snap.update({
            "role": self.role,
            "state": STATE_DRAINING if self.draining else STATE_READY,
            "alive": True,
            # Backlogged records are load this worker holds the leases of.
            "queue_depth": snap.get("pending", 0) + len(self._adopt_backlog),
            "prefix_hashes": sorted(hashes),
            **({"kv_tiers": self.kvstore.stats()}
               if self.kvstore is not None else {}),
            **self._heartbeat(),
        })
        if devtel.enabled():
            # The broker's queue depths by class as a counter track, at
            # heartbeat cadence: which class's queue a waiting request sat
            # in.
            try:
                by_class = {str(k): int(v) for k, v in
                            self.broker.queue_depths_by_class().items()}
            except Exception:  # noqa: BLE001 — telemetry never gates serving
                by_class = {}
            if by_class:
                devtel.record_counters({"queue_by_class": by_class})
        return snap

    def prewarm(self, seq_buckets: list[int] | None = None,
                prefix_prefill: bool = False) -> int:
        """Warm the batcher's whole envelope before it serves
        (consumer.py:601); ``seq_buckets`` narrows the prompt-length
        envelope when it is known, and ``prefix_prefill`` is the
        reference's flag for the prefix variants (``batcher.prewarm``)."""
        return self.batcher.prewarm(seq_buckets, prefix_prefill)

    def _get_prefix(self, prefix_ids: list[int]):
        """The prefix for these tokens, kept in the LRU (consumer.py:879):
        on a miss promoted from the store when one has it, else built (one
        prefill); what the LRU lets go of is demoted to the store."""
        key = tuple(prefix_ids)
        pfx = self._prefixes.pop(key, None)
        if pfx is None and self.kvstore is not None:
            with trace.span("-", "kv_promote", worker=self.worker_id,
                            n_tokens=len(prefix_ids)):
                pfx = self.kvstore.fetch_prefix(
                    prefix_ids, max_seq_len=self.engine.max_seq_len,
                    device=self.engine.device)
        if pfx is None:
            pfx = self.engine.build_prefix(list(prefix_ids))
        self._prefixes[key] = pfx  # most recently used last
        while len(self._prefixes) > self.max_prefixes:
            self._on_demote(self._prefixes.pop(next(iter(self._prefixes))))
        return pfx

    # -- the tiered KV store ---------------------------------------------------

    def _on_demote(self, prefix) -> None:
        """The pool's and the LRU's eviction hook: queue the prefix on the
        store (consumer.py:906)."""
        if self.kvstore is not None:
            self.kvstore.demote_prefix(prefix, self.engine.block_size)

    def _on_park(self, req_id: str, tokens, blocks) -> None:
        """The batcher's finish hook: park a session turn's exported blocks
        under its session (consumer.py:912), encoded here before the
        turn's answer."""
        sid = self._park_sessions.pop(req_id, None)
        if sid is None or self.kvstore is None:
            return
        with trace.span(req_id, "kv_park", worker=self.worker_id,
                        n_tokens=len(tokens)):
            self.kvstore.park_session(sid, tokens, blocks,
                                      self.engine.block_size)

    def _resume_session(self, session_id: str, ids: list[int]):
        """A ``Prefix`` from the session's parked KV when its tokens
        properly prefix ``ids`` (the blob is then taken), else None
        (consumer.py:926)."""
        parked = self.kvstore.resume_session(session_id, token_ids=ids)
        if parked is None:
            return None
        tokens, blocks = parked
        with trace.span("-", "kv_resume", worker=self.worker_id,
                        n_tokens=len(tokens)):
            pfx = prefix_from_blocks(tokens, blocks,
                                     max_seq_len=self.engine.max_seq_len,
                                     device=self.engine.device)
        self.kvstore.note_reprefill_avoided(len(tokens))
        return pfx

    def _drain_broker(self) -> int:
        """Move every queued request into the batcher (blocking briefly
        for the first one when idle); answer the ones that cannot run."""
        n = 0
        while True:
            req = self._pop(
                timeout=self.poll_timeout_s if self.batcher.idle and n == 0
                else 0.0
            )
            if req is None:
                return n
            if req.deadline_ts is not None and time.time() > req.deadline_ts:
                self.engine.metrics.add_expired()
                self.broker.push_response(
                    GenerateResponse(id=req.id, error="deadline exceeded")
                )
                continue
            try:
                req.validate()
                ids = encode_request(self.tokenizer, req)
                gen = gen_params_from(self.tokenizer, req)
                resume = list(req.resume_tokens or ())
                if resume:
                    # A preempted request: prompt and emitted tokens
                    # prefill as one prompt, and only the rest decodes.
                    ids = ids + resume
                    gen.max_new_tokens = req.max_new_tokens - len(resume)
                prefix = None
                if req.prefix_token_ids and self.control is not None:
                    prefix = tuple(req.prefix_token_ids)  # built on every rank
                elif req.prefix_token_ids:
                    prefix = self._get_prefix(req.prefix_token_ids)
                if (prefix is None and req.session_id
                        and self.kvstore is not None):
                    # A parked earlier turn seeds the row when its tokens
                    # prefix this prompt: only the new tokens prefill.
                    prefix = self._resume_session(req.session_id, ids)
                # Registered before submit: a short request can finish
                # inside the next step.
                self._reqs[req.id] = req
                if (req.session_id and self.kvstore is not None
                        and self.role != "prefill"):
                    # A prefill-role row ends at its export: the decode
                    # side parks the finished turn.
                    self._park_sessions[req.id] = req.session_id
                    self.batcher.request_park(req.id, ids,
                                              replayed=len(resume))
                self.batcher.submit(
                    ids, gen, self._done_cb(req), req_id=req.id,
                    stream_cb=self._stream_cb(req), prefix=prefix,
                    priority=SLO_CLASS_RANK.get(req.slo_class, 1),
                    replayed=len(resume))
            except ValueError as e:  # per-request error surface
                self._reqs.pop(req.id, None)
                self._park_sessions.pop(req.id, None)
                self.batcher.forget_park(req.id)
                self.broker.push_response(
                    GenerateResponse(id=req.id, error=str(e))
                )
                continue
            n += 1

    def _stream_cb(self, req: GenerateRequest):
        if not req.stream:
            return None

        def cb(new_toks):
            self.broker.push_stream(req.id, new_toks)

        return cb

    def _done_cb(self, req: GenerateRequest):
        """Turns the batcher's (tokens, cancelled, error) outcome into
        exactly one broker response."""

        def cb(toks, cancelled=False, error=None):
            self._reqs.pop(req.id, None)
            # A served row's park hook took it already.
            self._park_sessions.pop(req.id, None)
            if error is not None:
                self.engine.metrics.add_error()
                self.broker.push_response(
                    GenerateResponse(id=req.id, error=error, token_ids=toks)
                )
            elif cancelled:
                self.broker.push_response(GenerateResponse(
                    id=req.id, error="cancelled", token_ids=toks,
                ))
            else:
                text = (self.tokenizer.decode(toks)
                        if self.tokenizer is not None else None)
                self.broker.push_response(GenerateResponse(
                    id=req.id, prompt=req.prompt, continuation=text,
                    token_ids=toks,
                ))

        return cb

    # -- preemption ----------------------------------------------------------

    def _on_preempt(self, rid: str, toks: list[int]) -> None:
        """The batcher evicted ``rid``: stamp its emitted tokens on the
        original request as its resume point and refund it to the broker
        (consumer.py:749)."""
        req = self._reqs.pop(rid, None)
        if req is None:
            return  # answered meanwhile
        req.resume_tokens = list(toks) if toks else None
        req.preemptions += 1
        self.broker.preempt_requests([req])

    # -- the KV handoff --------------------------------------------------------

    def _on_export(self, rid: str, first: int, n_tokens: int,
                   blocks: dict) -> None:
        """Prefill role: encode a row's exported blocks and push the record
        to the decode replica ``pick_decode_worker`` chooses, or on the
        shared handoff queue when none is registered (consumer.py:764).
        The push queues the record before it settles the request's lease:
        a failure in between prefills again, never loses the request."""
        req = self._reqs.pop(rid, None)
        if req is None:
            self.broker.push_response(
                GenerateResponse(id=rid, error="exported request lost"))
            return
        with trace.span(rid, "kv_export", trace_id=req.trace_id,
                        worker=self.worker_id, n_tokens=n_tokens):
            payload = encode_blocks(blocks, req_id=rid, n_tokens=n_tokens,
                                    block_size=self.engine.block_size,
                                    trace_id=req.trace_id)
        rec = HandoffRecord(req=req, first_token=first, n_tokens=n_tokens,
                            payload=payload)
        target = pick_decode_worker(self.broker.read_workers(),
                                    self.broker.handoff_depths())
        if target is None:
            self.broker.push_handoff(rec)
        else:
            self.broker.push_handoff_to(target, rec)

    def _try_adopt(self, rec: HandoffRecord) -> bool:
        """Decode role: install one record into a free row. False only when
        no row or blocks are free (the record is untouched: the caller
        keeps it and renews its lease); a deadline, a corrupt payload or a
        payload the pool cannot take consume the record (consumer.py:792)."""
        req = rec.req
        if req.deadline_ts is not None and time.time() > req.deadline_ts:
            self.engine.metrics.add_expired()
            self.broker.push_response(
                GenerateResponse(id=req.id, error="deadline exceeded"))
            return True
        try:
            gen = gen_params_from(self.tokenizer, req)
            with trace.span(req.id, "kv_adopt", trace_id=req.trace_id,
                            worker=self.worker_id, bytes=len(rec.payload)):
                d = decode_blocks(rec.payload)
        except Exception as e:  # noqa: BLE001 — a bad record is disposed of
            self.broker.fail_handoff(rec, error=str(e))
            return True
        park = req.session_id and self.kvstore is not None
        if park:
            # The batcher holds no prompt ids for an adopted row: park
            # interest is registered here, withdrawn if no row takes it.
            self._park_sessions[req.id] = req.session_id
            self.batcher.request_park(req.id, list(req.token_ids or []))
        try:
            ok = self.batcher.adopt(
                req.id, rec.first_token, rec.n_tokens,
                {k: d[k] for k in ("k", "v", "k_scale", "v_scale")}, gen,
                self._done_cb(req), stream_cb=self._stream_cb(req))
        except Exception as e:  # noqa: BLE001 — a bad record is disposed of
            ok = None
            self.broker.fail_handoff(rec, error=str(e))
        if park and not ok:
            self._park_sessions.pop(req.id, None)
            self.batcher.forget_park(req.id)
        return ok is not False

    def _drain_handoffs(self, backlog_only: bool = False) -> int:
        """Decode-role intake (consumer.py:843): the backlog first, in
        order, then new records while rows are free. A record that finds no
        room goes to the backlog and stops the intake; it is never pushed
        back (that would open a loss window)."""
        n = 0
        while self._adopt_backlog and self._try_adopt(self._adopt_backlog[0]):
            self._adopt_backlog.popleft()
            n += 1
        if backlog_only:
            return n
        while not self._adopt_backlog:
            rec = self.broker.pop_handoff(
                timeout=self.poll_timeout_s if self.batcher.idle and n == 0
                else 0.0, worker_id=self.worker_id)
            if rec is None:
                break
            if self._try_adopt(rec):
                n += 1
            else:
                self._adopt_backlog.append(rec)
                break
        return n

    def begin_drain(self) -> None:
        """Stop taking new requests; ``run_once`` keeps stepping until the
        active rows finish."""
        self.draining = True

    @property
    def drained(self) -> bool:
        return (self.draining and self.batcher.idle
                and not self._adopt_backlog)

    def release_pending(self) -> int:
        """Drain deadline, first half: requests taken but never admitted go
        back to the broker for another worker."""
        ids = self.batcher.drop_pending()
        for rid in ids:
            self._reqs.pop(rid, None)
        if ids:
            self.broker.release_requests(ids)
        return len(ids)

    def abort_inflight(self, reason: str) -> int:
        """Drain deadline, second half: error out every admitted request;
        backlogged handoff records go back to the broker to be prefilled
        again elsewhere."""
        while self._adopt_backlog:
            self.broker.fail_handoff(self._adopt_backlog.popleft(),
                                     error=f"worker restarted: {reason}")
        ids = self.batcher.drain_all()
        for rid in ids:
            self._reqs.pop(rid, None)
            self.broker.push_response(
                GenerateResponse(id=rid, error=f"worker restarted: {reason}")
            )
        return len(ids)

    def run_once(self) -> int:
        """Renew leases and apply cancellations for the ids this batcher
        holds, take new requests (the decode role: handoff records), run
        one batcher step, and publish the metrics every 16 iterations (or
        when requests arrived)."""
        live = self.batcher.live_ids()
        self.broker.touch_requests(live)
        if self.role == "decode":
            # Adopted rows and backlogged records are held under handoff
            # leases (their request leases were settled at push_handoff).
            self.broker.touch_handoffs(
                live + [r.req.id for r in self._adopt_backlog])
        for rid in self.broker.check_cancelled(live):
            self.batcher.cancel(rid)
        self._maybe_publish_load()
        if self.role == "decode":
            # Draining still adopts the backlog: its leases are held here.
            n = self._drain_handoffs(backlog_only=self.draining)
        else:
            n = 0 if self.draining else self._drain_broker()
        self.batcher.step()
        self.last_progress_ts = time.monotonic()
        self._publish_counter += 1
        if n or self._publish_counter % 16 == 0:
            self.broker.publish_metrics(self.engine.metrics.to_dict())
        return n

    def run_forever(self, stop: threading.Event | None = None) -> None:
        while stop is None or not stop.is_set():
            self.run_once()


def refuse_on_mesh(args) -> None:
    """What a mesh of more than one rank does not serve yet: raises
    ``NotImplementedError`` naming ROADMAP Queue 1 item 8. (Paged under
    sp > 1 is the engine's ``ValueError``, as in the reference.)"""
    for what, on in (
            (f"--role {args.role}", args.role != "unified"),
            ("--kv_tier_host_mb", args.kv_tier_host_mb is not None),
            ("--supervise", args.supervise),
            ("a dense continuous batcher under sp > 1",
             args.continuous and args.kv_layout == "dense"
             and (args.sp or 1) > 1)):
        if on:
            raise NotImplementedError(
                f"{what} on a mesh is the next mesh slice (ROADMAP, Queue 1 "
                "item 8)")


def _on_mesh(args) -> bool:
    """Whether this process is one rank of a mesh: a mesh flag, an explicit
    rendezvous or torchrun's environment."""
    import os

    return (any((getattr(args, a) or 1) > 1 for a in ("tp", "dp", "sp"))
            or args.coordinator is not None or "RANK" in os.environ)


def _parser():
    import argparse

    parser = argparse.ArgumentParser("llmss-torch-consumer")
    parser.add_argument("--pretrained_model_path", required=True)
    parser.add_argument("--batch_size", type=int, default=8,
                        help="batch worker: requests per batch; continuous: "
                             "rows")
    parser.add_argument("--continuous", action="store_true",
                        help="continuous batching (requests join the running "
                             "batch each group) instead of batch-at-a-time")
    parser.add_argument("--max_seq_len", type=int, default=None)
    parser.add_argument("--chunk_steps", type=int, default=8,
                        help="decode steps per host round-trip")
    parser.add_argument("--group_chunks", type=int, default=1,
                        help="continuous only: chunks per dispatched group "
                             "while busy")
    parser.add_argument("--dtype", type=str, default="bfloat16")
    parser.add_argument("--kv_dtype", type=str, default=None,
                        choices=[None, "int8"],
                        help="int8 = quantized KV cache")
    parser.add_argument("--kv_layout", choices=["dense", "paged"],
                        default="dense")
    parser.add_argument("--chunked_prefill", type=int, default=None,
                        help="continuous only: admit prompts through the "
                             "ragged mixed batch, this many tokens per step; "
                             "requires --kv_layout paged")
    parser.add_argument("--redis_host", default="localhost")
    parser.add_argument("--redis_port", type=int, default=6379)
    parser.add_argument("--lease_s", type=float, default=60.0,
                        help="lease visibility timeout: an un-acked lease "
                             "older than this is redelivered")
    parser.add_argument("--max_delivery_attempts", type=int, default=3,
                        help="deliveries before a request is dead-lettered")
    parser.add_argument("--supervise", action="store_true",
                        help="run under the crash-restart supervisor")
    parser.add_argument("--max_restarts", type=int, default=None)
    parser.add_argument("--step_timeout_s", type=float, default=None,
                        help="supervised: escalate a loop with no progress "
                             "for this long as a crash (default: off)")
    parser.add_argument("--drain_timeout_s", type=float, default=30.0,
                        help="SIGTERM drain deadline: past it, pending "
                             "requests are released and active rows abort")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--role", choices=ROLES, default="unified",
                        help="continuous only: prefill = admit and hand the "
                             "KV off; decode = adopt handed-off KV; both "
                             "require --kv_layout paged")
    parser.add_argument("--kv_tier_host_mb", type=float, default=None,
                        help="continuous only: a tiered KV store with this "
                             "much host RAM (T1) over the broker's Redis (T2): "
                             "evicted prefixes demote, session turns park")
    parser.add_argument("--worker_id", default=None,
                        help="fleet identity (no ':'): register in the "
                             "broker's worker registry, publish load "
                             "snapshots, and serve this worker's routed "
                             "queue before the shared one")
    parser.add_argument("--snapshot_interval_s", type=float, default=1.0,
                        help="load-snapshot cadence with --worker_id "
                             "(routers judge a worker stale after 3x this)")
    # The mesh (one process a rank; rank 0 holds the broker).
    parser.add_argument("--tp", type=int, default=None,
                        help="tensor-parallel ranks (default: the ranks dp "
                             "and sp leave)")
    parser.add_argument("--dp", type=int, default=1)
    parser.add_argument("--sp", type=int, default=1)
    parser.add_argument("--coordinator", default=None,
                        help="the world's rendezvous (host:port or "
                             "file:///path) when not launched by torchrun")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--backend", default=None, choices=[None, "nccl",
                                                            "gloo"],
                        help="the process group's (default: nccl on CUDA, "
                             "gloo on the CPU)")
    return parser


def main(argv=None, broker: Broker | None = None):
    """``llmss-torch-consumer``: serve a checkpoint from the Redis broker
    (consumer.py:1036) on one GPU or on a mesh. The worker factory
    prewarms, so a supervised restart comes up with its graphs captured.
    SIGTERM drains; a second SIGTERM ends the drain at once (pending
    requests released, active rows aborted). On a mesh, rank 0 serves
    and stops the other ranks when it ends; they follow it. ``broker`` (a
    ``Broker``, rank 0's) replaces the Redis one. A rank that fails
    ends its process with the error; the others then fail at their next
    collective or control message."""
    parser = _parser()
    args = parser.parse_args(argv)
    for flag, on in (("chunked_prefill", args.chunked_prefill is not None),
                     ("role", args.role != "unified")):
        if on and not args.continuous:
            parser.error(f"--{flag} requires --continuous")
        if on and args.kv_layout != "paged":
            parser.error(f"--{flag} requires --kv_layout paged")
    if args.kv_tier_host_mb is not None and not args.continuous:
        parser.error("--kv_tier_host_mb requires --continuous")
    if args.worker_id is not None and ":" in args.worker_id:
        parser.error("--worker_id must not contain ':'")

    from llmss_tpu_torch.models.registry import load_model

    mesh = control = None
    if _on_mesh(args):
        from llmss_tpu_torch.parallel import (
            MeshPlan, initialize_runtime, make_mesh,
        )

        initialize_runtime(args.coordinator, args.num_processes,
                           args.process_id, backend=args.backend,
                           device=args.device)
        mesh = make_mesh(MeshPlan(dp=args.dp, sp=args.sp, tp=args.tp),
                         device=args.device, backend=args.backend)
        if mesh.world > 1:
            refuse_on_mesh(args)
    cfg, params = load_model(
        args.pretrained_model_path,
        device=None if mesh is not None else args.device, dtype=args.dtype,
        mesh=mesh)
    engine = DecodeEngine(
        cfg, params, device=None if mesh is not None else args.device,
        kv_dtype=args.kv_dtype, kv_layout=args.kv_layout, mesh=mesh,
        max_seq_len=args.max_seq_len or cfg.max_position_embeddings,
    )
    if mesh is not None and mesh.world > 1:
        from llmss_tpu_torch.parallel.serving import ServeControl

        control = ServeControl(engine)
        if not control.leader:
            control.follow()
            _leave(mesh)
            return
    if broker is None:
        from llmss_tpu_torch.serve.broker import RedisBroker

        broker = RedisBroker(
            args.redis_host, args.redis_port, lease_s=args.lease_s,
            max_delivery_attempts=args.max_delivery_attempts,
            # The fleet id is the lease identity: routed queues, leases and
            # failover name one worker.
            worker_id=args.worker_id)
    _serve(args, engine, broker, control)
    if control is not None:
        control.stop()
    if mesh is not None:
        _leave(mesh)


def _leave(mesh) -> None:
    """Tear this rank's process group down once every rank is done (a
    group left to the interpreter's exit can abort the process)."""
    import torch.distributed as dist

    if mesh.world > 1:
        dist.barrier()
    dist.destroy_process_group()


def _serve(args, engine, broker, control) -> None:
    """Rank 0's (or the one GPU's) serving loop, until drained."""
    import signal

    kvstore = None
    if args.kv_tier_host_mb is not None:
        # The broker's client carries T2; the ":kv:" key segment keeps the
        # blobs clear of the broker's keys (consumer.py:1189).
        kvstore = TieredKVStore(
            host=HostKVStore(cap_bytes=int(args.kv_tier_host_mb * 1024 * 1024)),
            blob=RedisBlobStore(broker._r, namespace="pqueue"))

    def make_worker():
        if args.continuous:
            w = ContinuousWorker(
                engine, broker, rows=args.batch_size,
                chunk_steps=args.chunk_steps, group_chunks=args.group_chunks,
                chunked_prefill=args.chunked_prefill, role=args.role,
                kvstore=kvstore, worker_id=args.worker_id,
                snapshot_interval_s=args.snapshot_interval_s, control=control,
            )
        else:
            w = Worker(engine, broker, batch_size=args.batch_size,
                       chunk_steps=args.chunk_steps, worker_id=args.worker_id,
                       snapshot_interval_s=args.snapshot_interval_s,
                       control=control)
        t0 = time.monotonic()
        n = w.prewarm()
        logger.info("prewarmed %d programs in %.1fs", n, time.monotonic() - t0)
        return w

    print("consumer serving"
          + (" (continuous batching)" if args.continuous else "")
          + (f" (KV tiers: {args.kv_tier_host_mb:g} MiB host + Redis)"
             if kvstore is not None else "")
          + (f" (role {args.role})" if args.role != "unified" else "")
          + (f" ({engine.mesh!r})" if control is not None else "")
          + (" (supervised)" if args.supervise else ""), flush=True)
    if args.supervise:
        from llmss_tpu_torch.serve.supervisor import Supervisor

        sup = Supervisor(make_worker, broker, max_restarts=args.max_restarts,
                         step_timeout_s=args.step_timeout_s,
                         drain_timeout_s=args.drain_timeout_s)

        sigterms = [0]

        def on_sigterm(signum, frame):
            # The first SIGTERM drains, unless this is the last routable
            # replica of its role; the next one forces the teardown.
            if sup.draining:
                logger.warning("SIGTERM again: ending the drain now")
                sup.drain(timeout_s=0.0, force=True)
            elif sup.drain(force=sigterms[0] > 0):
                logger.info("SIGTERM: draining (deadline %.0fs)",
                            args.drain_timeout_s)
            else:
                logger.warning("SIGTERM: drain blocked (last routable "
                               "replica); send SIGTERM again to force it")
            sigterms[0] += 1

        previous = signal.signal(signal.SIGTERM, on_sigterm)
        try:
            sup.run()
        finally:
            signal.signal(signal.SIGTERM, previous)
    else:
        w = make_worker()

        def on_sigterm(signum, frame):
            logger.info("SIGTERM: draining (unsupervised)")
            w.begin_drain()

        previous = signal.signal(signal.SIGTERM, on_sigterm)
        try:
            while not w.drained:
                w.run_once()
        finally:
            signal.signal(signal.SIGTERM, previous)


if __name__ == "__main__":
    main()
