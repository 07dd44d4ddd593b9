"""Wire schema for the producer / broker / consumer stack (counterpart:
llmss_tpu/serve/protocol.py).

The port's own copy of the request / response dataclasses, field for
field and in the same order, with the reference's validation and JSON:
``to_json`` gives the reference's bytes for the same object, so a
reference producer and a port worker can share one Redis. Also the
worker lifecycle states the supervisor publishes and ``prefix_hash``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import uuid

# Worker lifecycle states, published in the supervisor block of every
# metrics publish and read by the producer's /health and admission:
# starting (factory build and prewarm) -> ready (leasing and serving) ->
# draining (no new leases; the active rows finish) -> dead (the
# supervisor loop has exited and will never serve again).
STATE_STARTING = "starting"
STATE_READY = "ready"
STATE_DRAINING = "draining"
STATE_DEAD = "dead"
WORKER_STATES = (STATE_STARTING, STATE_READY, STATE_DRAINING, STATE_DEAD)

# SLO classes in strict priority order; a closed set, since brokers key
# queues on it and metrics label by it.
SLO_CLASS_INTERACTIVE = "interactive"
SLO_CLASS_STANDARD = "standard"
SLO_CLASS_BATCH = "batch"
SLO_CLASSES = (SLO_CLASS_INTERACTIVE, SLO_CLASS_STANDARD, SLO_CLASS_BATCH)
SLO_CLASS_RANK = {c: i for i, c in enumerate(SLO_CLASSES)}


def prefix_hash(token_ids) -> str:
    """Content address of a prompt prefix (SHA-1 over the token ids as
    little-endian int32, first 16 hex digits): every process computes the
    same key from the same tokens."""
    h = hashlib.sha1()
    for t in token_ids:
        h.update(int(t).to_bytes(4, "little", signed=True))
    return h.hexdigest()[:16]


class _Json:
    """``to_json`` / ``from_json`` of the reference: every field, in
    declaration order; unknown keys from a newer peer are ignored."""

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str | bytes):
        d = json.loads(s)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass
class GenerateRequest(_Json):
    prompt: str | None = None
    token_ids: list[int] | None = None
    max_new_tokens: int = 20
    is_greedy: bool = True
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0
    seed: int = 0
    # Deliver tokens incrementally over the broker's stream channel; the
    # final GenerateResponse still closes the request.
    stream: bool = False
    # Prefix-reuse hint: a proper prefix of token_ids.
    prefix_token_ids: list[int] | None = None
    # Broker bookkeeping: incremented on every lease; a lease that expires
    # at the broker's max_delivery_attempts dead-letters the request.
    delivery_attempts: int = 0
    # End-to-end deadline, epoch seconds (the producer stamps it from its
    # timeout): expired requests are shed before prefill and at
    # redelivery.
    deadline_ts: float | None = None
    # Trace context: the request id at first enqueue.
    trace_id: str | None = None
    trace_attempt: int = 0
    slo_class: str = SLO_CLASS_STANDARD
    preemptions: int = 0
    # Tokens already emitted before a preemption: replayed as prompt, and
    # only the remainder decodes.
    resume_tokens: list[int] | None = None
    session_id: str | None = None
    turn: int | None = None
    id: str = dataclasses.field(default_factory=lambda: uuid.uuid4().hex)

    def validate(self) -> None:
        if self.prompt is None and self.token_ids is None:
            raise ValueError("one of prompt / token_ids is required")
        if not self.is_greedy:
            if self.temperature <= 0:
                raise ValueError("temperature must be > 0")
            if not (0.0 < self.top_p <= 1.0):
                raise ValueError("top_p must be in (0, 1]")
            if self.top_k < 0:
                raise ValueError("top_k must be >= 0")
        if self.max_new_tokens <= 0:
            raise ValueError("max_new_tokens must be > 0")
        if self.slo_class not in SLO_CLASSES:
            raise ValueError(
                f"slo_class must be one of {SLO_CLASSES}, got {self.slo_class!r}"
            )
        if self.resume_tokens is not None and (
            len(self.resume_tokens) >= self.max_new_tokens
        ):
            raise ValueError(
                "resume_tokens must be shorter than max_new_tokens "
                "(a fully-decoded request would have been answered, "
                "not preempted)"
            )
        if self.prefix_token_ids is not None:
            if self.token_ids is None:
                raise ValueError("prefix_token_ids requires token_ids")
            P = len(self.prefix_token_ids)
            if not 0 < P < len(self.token_ids) or (
                self.token_ids[:P] != list(self.prefix_token_ids)
            ):
                raise ValueError(
                    "prefix_token_ids must be a proper prefix of token_ids"
                )


@dataclasses.dataclass
class GenerateResponse(_Json):
    id: str
    prompt: str | None = None
    continuation: str | None = None
    token_ids: list[int] | None = None
    error: str | None = None
