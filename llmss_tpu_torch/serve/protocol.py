"""Wire schema for the batch worker (counterpart: llmss_tpu/serve/protocol.py:63-192).

The port's own copy of the request / response dataclasses, field for
field, with the reference's validation.
"""

from __future__ import annotations

import dataclasses
import uuid

SLO_CLASS_INTERACTIVE = "interactive"
SLO_CLASS_STANDARD = "standard"
SLO_CLASS_BATCH = "batch"
SLO_CLASSES = (SLO_CLASS_INTERACTIVE, SLO_CLASS_STANDARD, SLO_CLASS_BATCH)


@dataclasses.dataclass
class GenerateRequest:
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
    # Prefix-reuse hint; the batch worker ignores it.
    prefix_token_ids: list[int] | None = None
    # Broker bookkeeping: incremented on every lease.
    delivery_attempts: int = 0
    # End-to-end deadline, epoch seconds: expired requests are shed
    # before prefill.
    deadline_ts: float | None = None
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
            raise ValueError("resume_tokens must be shorter than max_new_tokens")
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
class GenerateResponse:
    id: str
    prompt: str | None = None
    continuation: str | None = None
    token_ids: list[int] | None = None
    error: str | None = None
