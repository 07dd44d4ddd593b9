"""Serving workers (counterpart: llmss_tpu/serve/consumer.py:82-1033):
the batch ``Worker`` and the continuous ``ContinuousWorker``.

``Worker.run_once`` takes up to ``batch_size`` requests from the broker,
sheds cancelled and expired ones, validates each (bad requests and
requests that would overflow the ring get an error response of their own),
pads the batch to its envelope with inert rows, runs ``engine.generate``
with grouped decode, streams increments for ``stream`` requests, and
answers every row: tokens, ``cancelled`` with the partial tokens, or a
per-row poison error while batch-mates keep their tokens. The fleet
registry, tracing and device-telemetry hooks of the reference wait for
later work.

``ContinuousWorker`` (the reference's unified role) feeds the broker's
requests into a ``ContinuousBatcher`` and answers each one exactly once
from the batcher's callbacks. Request fields that later slices serve
(``prefix_token_ids``, ``session_id``, and the ``resume_tokens`` /
``preemptions`` of a preempted request) get an error response: such a
request is never served without them. The prefill / decode roles, the KV
store, the fleet registry and ``main`` wait for later work.
"""

from __future__ import annotations

import logging
import threading
import time

from llmss_tpu_torch.engine.engine import DecodeEngine, GenerationParams
from llmss_tpu_torch.engine.scheduler import ContinuousBatcher
from llmss_tpu_torch.serve.broker import InProcBroker
from llmss_tpu_torch.serve.protocol import GenerateRequest, GenerateResponse

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
        broker: InProcBroker,
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
        batch = self._gather()
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
        broker: InProcBroker,
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
        self._publish_counter += 1
        if n or self._publish_counter % 16 == 0:
            self.broker.publish_metrics(self.engine.metrics.to_dict())
        return n

    def run_forever(self, stop: threading.Event | None = None) -> None:
        while stop is None or not stop.is_set():
            self.run_once()
