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

``ContinuousWorker`` (the reference's unified role) feeds the broker's
requests into a ``ContinuousBatcher`` and answers each one exactly once
from the batcher's callbacks. Request fields that later slices serve
(``prefix_token_ids``, ``session_id``, and the ``resume_tokens`` /
``preemptions`` of a preempted request) get an error response: such a
request is never served without them.

Both workers stamp ``last_progress_ts`` (the supervisor's watchdog and
heartbeat read it) and renew the leases they hold every group;
``ContinuousWorker.load_snapshot`` gives its host-side occupancy. The prefill / decode roles, the KV store, the
fleet registry, tracing and device telemetry wait for later slices.

``main`` (``llmss-torch-consumer``) serves a checkpoint from a Redis
broker on one GPU, optionally under the ``Supervisor``; there is no
tokenizer, so requests carry ``token_ids``.
"""

from __future__ import annotations

import logging
import threading
import time

from llmss_tpu_torch.engine.engine import DecodeEngine, GenerationParams
from llmss_tpu_torch.engine.scheduler import ContinuousBatcher
from llmss_tpu_torch.serve.broker import Broker
from llmss_tpu_torch.serve.protocol import (
    STATE_DRAINING, STATE_READY, GenerateRequest, GenerateResponse,
)

# How long an idle worker blocks on the queue before it looks again.
POLL_TIMEOUT_S = 0.2

logger = logging.getLogger("llmss_tpu_torch.serve")


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


class Worker:
    def __init__(
        self,
        engine: DecodeEngine,
        broker: Broker,
        tokenizer=None,
        batch_size: int = 8,
        chunk_steps: int = 8,
    ):
        self.engine = engine
        self.broker = broker
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        # Decode steps per host round-trip (engine.generate chunking).
        self.chunk_steps = chunk_steps
        # Once draining, run_once leases nothing; the batch worker holds
        # requests only inside run_once, so it is drained at once.
        self.draining = False
        # Monotonic stamp of the last progress (batch boundaries and every
        # decode chunk, so a long batch keeps the heartbeat fresh); 0.0
        # until the first batch.
        self.last_progress_ts = 0.0

    def begin_drain(self) -> None:
        self.draining = True

    @property
    def drained(self) -> bool:
        return self.draining

    def _gather(self) -> list[GenerateRequest]:
        """Block briefly for one request, then drain up to batch_size."""
        first = self.broker.pop_request(timeout=POLL_TIMEOUT_S)
        if first is None:
            return []
        batch = [first]
        while len(batch) < self.batch_size:
            nxt = self.broker.pop_request()
            if nxt is None:
                break
            batch.append(nxt)
        return batch

    def run_once(self) -> int:
        """Serve one batch; returns the number of requests taken."""
        if self.draining:
            return 0
        batch = self._gather()
        self.last_progress_ts = time.monotonic()
        if not batch:
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
        try:
            outs = self.engine.generate(
                prompts, gens, cancel_poll=cancel_poll,
                on_increment=on_increment, on_poisoned=poisoned_rows.add,
                chunk_steps=self.chunk_steps, live_rows=n_live,
            )[:n_live]
        except Exception as e:  # noqa: BLE001 — batch failure containment
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
        every decode step graph of its chunked decode."""
        return self.engine.prewarm(self.batch_size,
                                   chunk_steps=self.chunk_steps)


def _unserved_field(req: GenerateRequest) -> str | None:
    """The first request field the continuous worker cannot honour yet."""
    for name in ("prefix_token_ids", "session_id", "resume_tokens"):
        if getattr(req, name):
            return name
    if req.preemptions:
        return "preemptions"
    return None


class ContinuousWorker:
    """Serving loop over the continuous batcher: requests join the running
    batch at group granularity."""

    def __init__(
        self,
        engine: DecodeEngine,
        broker: Broker,
        tokenizer=None,
        rows: int = 8,
        chunk_steps: int = 8,
        group_chunks: int = 1,
        chunked_prefill: int | None = None,
    ):
        self.engine = engine
        self.broker = broker
        self.tokenizer = tokenizer
        self.batcher = ContinuousBatcher(
            engine, rows=rows, chunk_steps=chunk_steps,
            group_chunks=group_chunks, chunked_prefill=chunked_prefill,
        )
        self._publish_counter = 0
        self.draining = False
        # Monotonic stamp after every served group; 0.0 until the first,
        # so the watchdog's clock never runs during build and prewarm.
        self.last_progress_ts = 0.0

    def load_snapshot(self) -> dict:
        """The batcher's host-side occupancy and pool headroom with the
        lifecycle state (consumer.py:522, without the prefix hashes, KV
        tiers, trace and telemetry blobs); touches no device tensor."""
        snap = self.batcher.load_snapshot()
        snap.update({
            "role": "unified",
            "state": STATE_DRAINING if self.draining else STATE_READY,
            "alive": True,
            "queue_depth": snap.get("pending", 0),
        })
        return snap

    def prewarm(self, seq_buckets: list[int] | None = None) -> int:
        """Warm the batcher's whole envelope before it serves
        (consumer.py:601, without the prefix variant); ``seq_buckets``
        narrows the prompt-length envelope when it is known."""
        return self.batcher.prewarm(seq_buckets)

    def _drain_broker(self) -> int:
        """Move every queued request into the batcher (blocking briefly
        for the first one when idle); answer the ones that cannot run."""
        n = 0
        while True:
            req = self.broker.pop_request(
                timeout=POLL_TIMEOUT_S if self.batcher.idle and n == 0 else 0.0
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
                field = _unserved_field(req)
                if field is not None:
                    raise ValueError(
                        f"{field} is not served by this worker yet"
                    )
                ids = encode_request(self.tokenizer, req)
                gen = gen_params_from(self.tokenizer, req)
                stream_cb = None
                if req.stream:
                    def stream_cb(new_toks, req=req):
                        self.broker.push_stream(req.id, new_toks)

                self.batcher.submit(ids, gen, self._done_cb(req),
                                    req_id=req.id, stream_cb=stream_cb)
            except ValueError as e:  # per-request error surface
                self.broker.push_response(
                    GenerateResponse(id=req.id, error=str(e))
                )
                continue
            n += 1

    def _done_cb(self, req: GenerateRequest):
        """Turns the batcher's (tokens, cancelled, error) outcome into
        exactly one broker response."""

        def cb(toks, cancelled=False, error=None):
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

    def begin_drain(self) -> None:
        """Stop taking new requests; ``run_once`` keeps stepping until the
        active rows finish."""
        self.draining = True

    @property
    def drained(self) -> bool:
        return self.draining and self.batcher.idle

    def release_pending(self) -> int:
        """Drain deadline, first half: requests taken but never admitted go
        back to the broker for another worker."""
        ids = self.batcher.drop_pending()
        if ids:
            self.broker.release_requests(ids)
        return len(ids)

    def abort_inflight(self, reason: str) -> int:
        """Drain deadline, second half: error out every admitted request."""
        ids = self.batcher.drain_all()
        for rid in ids:
            self.broker.push_response(
                GenerateResponse(id=rid, error=f"worker restarted: {reason}")
            )
        return len(ids)

    def run_once(self) -> int:
        """Renew leases and apply cancellations for the ids this batcher
        holds, take new requests, run one batcher step, and publish the
        metrics every 16 iterations (or when requests arrived)."""
        live = self.batcher.live_ids()
        self.broker.touch_requests(live)
        for rid in self.broker.check_cancelled(live):
            self.batcher.cancel(rid)
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


# Flags of the reference's consumer that belong to later slices: the one
# value each may keep here, and what the port lacks for the others.
_ONE_GPU = "the port serves one model on one GPU"
_LATER_FLAGS = {
    "role": ("unified", "disaggregated prefill/decode roles need the KV "
                        "handoff channel"),
    "worker_id": (None, "a fleet identity needs the worker registry and "
                        "routed queues"),
    "kv_tier_host_mb": (None, "the tiered KV store is not ported"),
    "tp": (1, _ONE_GPU),
    "dp": (1, _ONE_GPU),
    "sp": (1, _ONE_GPU),
}


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
    # Accepted so that the refusal names what is missing.
    parser.add_argument("--role", default=None)
    parser.add_argument("--worker_id", default=None)
    parser.add_argument("--kv_tier_host_mb", type=float, default=None)
    parser.add_argument("--tp", type=int, default=None)
    parser.add_argument("--dp", type=int, default=None)
    parser.add_argument("--sp", type=int, default=None)
    return parser


def main(argv=None):
    """``llmss-torch-consumer``: serve a checkpoint from the Redis broker
    (consumer.py:1036, for one GPU). The worker factory prewarms, so a
    supervised restart comes up with its graphs captured. SIGTERM drains;
    a second SIGTERM ends the drain at once (pending requests released,
    active rows aborted)."""
    import signal

    parser = _parser()
    args = parser.parse_args(argv)
    for flag, (keep, why) in _LATER_FLAGS.items():
        if getattr(args, flag) not in (None, keep):
            parser.error(f"--{flag} is not served by the torch port yet: {why}")
    if args.chunked_prefill is not None:
        if not args.continuous:
            parser.error("--chunked_prefill requires --continuous")
        if args.kv_layout != "paged":
            parser.error("--chunked_prefill requires --kv_layout paged")

    from llmss_tpu_torch.models.registry import load_model
    from llmss_tpu_torch.serve.broker import RedisBroker

    cfg, params = load_model(args.pretrained_model_path, device=args.device,
                             dtype=args.dtype)
    engine = DecodeEngine(
        cfg, params, device=args.device, kv_dtype=args.kv_dtype,
        kv_layout=args.kv_layout,
        max_seq_len=args.max_seq_len or cfg.max_position_embeddings,
    )
    broker = RedisBroker(args.redis_host, args.redis_port,
                         lease_s=args.lease_s,
                         max_delivery_attempts=args.max_delivery_attempts)

    def make_worker():
        if args.continuous:
            w = ContinuousWorker(
                engine, broker, rows=args.batch_size,
                chunk_steps=args.chunk_steps, group_chunks=args.group_chunks,
                chunked_prefill=args.chunked_prefill,
            )
        else:
            w = Worker(engine, broker, batch_size=args.batch_size,
                       chunk_steps=args.chunk_steps)
        t0 = time.monotonic()
        n = w.prewarm()
        logger.info("prewarmed %d programs in %.1fs", n, time.monotonic() - t0)
        return w

    print("consumer serving"
          + (" (continuous batching)" if args.continuous else "")
          + (" (supervised)" if args.supervise else ""), flush=True)
    if args.supervise:
        from llmss_tpu_torch.serve.supervisor import Supervisor

        sup = Supervisor(make_worker, broker, max_restarts=args.max_restarts,
                         step_timeout_s=args.step_timeout_s,
                         drain_timeout_s=args.drain_timeout_s)

        def on_sigterm(signum, frame):
            if sup.draining:
                logger.warning("SIGTERM again: ending the drain now")
                sup.drain(timeout_s=0.0)
            else:
                logger.info("SIGTERM: draining (deadline %.0fs)",
                            args.drain_timeout_s)
                sup.drain()

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
