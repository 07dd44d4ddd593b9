"""The KV handoff between the prefill and decode roles (counterpart:
llmss_tpu/serve/handoff.py:1-241): the wire format of a row's exported
blocks, the record that carries a prefilled request between the roles, and
the choice of a decode worker.

Wire format (``encode_blocks`` / ``decode_blocks``), byte for byte the
reference's: the magic ``LKVH``, a little-endian u32 header length, a JSON
header (version 1, request id, trace id, prompt length, block size,
whether quantized, each buffer's shape and dtype name, and a CRC-32 of the
buffer bytes, with the reference's keys in its order) and the raw
little-endian buffers ``k``, ``v``, ``k_scale``, ``v_scale`` (absent ones
skipped). ``decode_blocks`` raises ``ValueError`` on a bad magic, an
unknown version, a truncation, trailing bytes or a CRC mismatch, so a
corrupt payload is disposed of (``fail_handoff``) instead of reaching a
decode worker's pool.

The reference reaches bf16 through ``ml_dtypes``; here a bf16 tensor goes
on the wire as its raw bytes under the dtype name ``"bfloat16"`` and comes
back as a ``torch.bfloat16`` tensor over the payload's bytes. Payloads are
host torch tensors, or numpy arrays of the other dtypes.

``pick_decode_worker`` chooses the registered decode replica a prefill
worker routes a record to (``push_handoff_to``); with none registered the
record goes to the shared handoff queue, which any decode worker drains.
``PrefillWorker`` and ``DecodeWorker`` are the reference's model-free role
loops over an engine's ``prefill_export`` / ``adopt_generate`` protocol
(serve/chaos.py's ``ScriptedEngine`` has it), registered in the fleet, as
the chaos harness drives them; the served roles are
``ContinuousWorker(role=...)`` (serve/consumer.py).
"""

from __future__ import annotations

import base64
import dataclasses
import json
import struct
import time
import uuid
import warnings
import zlib

import numpy as np
import torch

from llmss_tpu_torch.serve.protocol import (
    STATE_READY, GenerateRequest, GenerateResponse,
)
from llmss_tpu_torch.utils import metrics as metrics_mod
from llmss_tpu_torch.utils import trace

# Wire magic and version: decoders refuse any other version.
_MAGIC = b"LKVH"
_VERSION = 1
# Buffer order in the payload body (None entries are skipped).
_ARRAYS = ("k", "v", "k_scale", "v_scale")
# Wire dtype names and the torch dtypes they decode to.
_DTYPES = {"bfloat16": torch.bfloat16, "int8": torch.int8,
           "float32": torch.float32, "float16": torch.float16,
           "float64": torch.float64}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _raw(a) -> tuple[list[int], str, memoryview]:
    """(shape, wire dtype name, the C-order bytes without a copy where the
    buffer is contiguous) of a host tensor or numpy array."""
    if torch.is_tensor(a):
        if a.is_cuda:
            raise ValueError("encode_blocks takes host buffers")
        if a.dtype not in _NAMES:
            raise ValueError(f"unknown payload dtype {a.dtype}")
        t = a.contiguous()
        return (list(t.shape), _NAMES[t.dtype],
                memoryview(t.view(torch.uint8).numpy()).cast("B"))
    a = np.ascontiguousarray(a)
    if a.dtype.name not in _DTYPES:
        raise ValueError(f"unknown payload dtype {a.dtype.name!r}")
    return list(a.shape), a.dtype.name, memoryview(a.view(np.uint8)).cast("B")


def encode_blocks(blocks: dict, *, req_id: str, n_tokens: int,
                  block_size: int, trace_id: str | None = None,
                  tokens: list[int] | None = None) -> bytes:
    """An ``export_blocks`` dict in the wire format (handoff.py:90). The
    CRC is chained over the buffers and the payload joined once.
    ``tokens`` puts the segment's token ids in the header, last, as the
    KV store's blobs carry them (serve/kvstore.py); without it the key is
    absent, as in a handoff payload."""
    bufs: list[memoryview] = []
    shapes: dict[str, list[int] | None] = {}
    dtypes: dict[str, str | None] = {}
    crc = 0
    for name in _ARRAYS:
        a = blocks.get(name)
        if a is None:
            shapes[name] = dtypes[name] = None
            continue
        shapes[name], dtypes[name], buf = _raw(a)
        crc = zlib.crc32(buf, crc)
        bufs.append(buf)
    header = json.dumps({
        "version": _VERSION,
        "req_id": req_id,
        "trace_id": trace_id,
        "n_tokens": int(n_tokens),
        "block_size": int(block_size),
        "quantized": blocks.get("k_scale") is not None,
        "shapes": shapes,
        "dtypes": dtypes,
        "crc32": crc & 0xFFFFFFFF,
        **({"tokens": [int(t) for t in tokens]} if tokens is not None
           else {}),
    }).encode("utf-8")
    return b"".join([_MAGIC, struct.pack("<I", len(header)), header, *bufs])


def decode_blocks(data: bytes) -> dict:
    """A payload back into host tensors over its bytes, and its metadata
    (handoff.py:130): ``{"k", "v", "k_scale", "v_scale", "req_id",
    "trace_id", "n_tokens", "block_size", "quantized", "tokens"}``. The
    tensors share the payload's memory and are read-only in use."""
    if len(data) < len(_MAGIC) + 4 or data[: len(_MAGIC)] != _MAGIC:
        raise ValueError("bad handoff payload: missing magic")
    (hlen,) = struct.unpack_from("<I", data, len(_MAGIC))
    body_at = len(_MAGIC) + 4 + hlen
    if len(data) < body_at:
        raise ValueError("bad handoff payload: truncated header")
    try:
        header = json.loads(data[len(_MAGIC) + 4: body_at])
    except json.JSONDecodeError as e:
        raise ValueError(f"bad handoff payload: header not JSON ({e})")
    if header.get("version") != _VERSION:
        raise ValueError(
            f"bad handoff payload: version {header.get('version')!r}")
    raw = memoryview(data)[body_at:]
    if zlib.crc32(raw) & 0xFFFFFFFF != header["crc32"]:
        raise ValueError("bad handoff payload: CRC mismatch")
    out = {
        "req_id": header["req_id"],
        "trace_id": header.get("trace_id"),
        "n_tokens": header["n_tokens"],
        "block_size": header["block_size"],
        "quantized": header["quantized"],
        "tokens": header.get("tokens"),
    }
    off = 0
    for name in _ARRAYS:
        shape = header["shapes"].get(name)
        if shape is None:
            out[name] = None
            continue
        dname = header["dtypes"][name]
        if dname not in _DTYPES:
            raise ValueError(f"unknown payload dtype {dname!r}")
        dt = _DTYPES[dname]
        count = int(np.prod(shape))
        nbytes = count * dt.itemsize
        if off + nbytes > len(raw):
            raise ValueError("bad handoff payload: truncated buffers")
        with warnings.catch_warnings():
            # The payload is immutable bytes; the tensor is only read.
            warnings.simplefilter("ignore", UserWarning)
            t = (torch.frombuffer(raw, dtype=dt, count=count, offset=off)
                 if count else torch.empty(0, dtype=dt))
        out[name] = t.reshape(shape)
        off += nbytes
    if off != len(raw):
        raise ValueError("bad handoff payload: trailing bytes")
    return out


@dataclasses.dataclass
class HandoffRecord:
    """One prefilled request between the roles (handoff.py:187): the
    original request (its delivery budget rides along), the first token the
    prefill sampled, the prompt length and the encoded KV payload. Its
    JSON is the reference's."""

    req: GenerateRequest
    first_token: int
    n_tokens: int
    payload: bytes

    def to_json(self) -> str:
        return json.dumps({
            "req": self.req.to_json(),
            "first_token": self.first_token,
            "n_tokens": self.n_tokens,
            "payload_b64": base64.b64encode(self.payload).decode("ascii"),
        })

    @classmethod
    def from_json(cls, raw) -> "HandoffRecord":
        d = json.loads(raw)
        return cls(req=GenerateRequest.from_json(d["req"]),
                   first_token=int(d["first_token"]),
                   n_tokens=int(d["n_tokens"]),
                   payload=base64.b64decode(d["payload_b64"]))


def pick_decode_worker(workers: dict,
                       handoff_depths: dict | None = None) -> str | None:
    """The ready decode-role worker with the least backlog (in-flight rows
    plus routed handoff depth), then the most free rows, then the lowest
    id (handoff.py:217); None when there is none (the caller uses the
    shared handoff queue). ``workers`` is a registry view: ``{id:
    snapshot}``."""
    depths = handoff_depths or {}
    best, best_key = None, None
    for wid, info in workers.items():
        if info.get("role") != "decode":
            continue
        if info.get("state", STATE_READY) != STATE_READY:
            continue
        backlog = int(info.get("inflight_rows") or 0) + int(depths.get(wid, 0))
        key = (backlog, -int(info.get("free_slots") or 0), wid)
        if best_key is None or key < best_key:
            best, best_key = wid, key
    return best


class _RoleWorkerBase:
    """The role loops' registration and heartbeat (handoff.py:246)."""

    role = "unified"

    def __init__(self, engine, broker, *, worker_id: str | None = None,
                 poll_timeout_s: float = 0.02,
                 snapshot_interval_s: float = 1.0):
        self.engine = engine
        self.broker = broker
        self.worker_id = worker_id or uuid.uuid4().hex[:8]
        self.poll_timeout_s = poll_timeout_s
        self.snapshot_interval_s = snapshot_interval_s
        self._last_snapshot = 0.0  # monotonic
        self._trace_blob: dict | None = None
        self._last_trace_pub = 0.0  # monotonic
        self._inflight = 0
        broker.register_worker({
            "worker_id": self.worker_id,
            "role": self.role,
            "model": getattr(engine, "model_name", "scripted"),
            "max_seq_len": getattr(engine, "max_seq_len", None),
        })
        self._publish(force=True)

    def _publish(self, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now - self._last_snapshot < self.snapshot_interval_s:
            return
        self._last_snapshot = now
        self.broker.publish_worker_load(self.worker_id, {
            "worker_id": self.worker_id,
            "role": self.role,
            "state": STATE_READY,
            "inflight_rows": self._inflight,
            "free_slots": 1 - self._inflight,
            "queue_depth": 0,
            # Wall clock: readers in other processes judge its age.
            "heartbeat_ts": time.time(),
            "heartbeat_interval_s": self.snapshot_interval_s,
            # The recorder's snapshot, exported at heartbeat cadence and
            # re-attached by the forced per-request publishes.
            **({"trace": self._trace_export(now)} if trace.enabled() else {}),
            # The windowed series at the same cadence (the registry's
            # export cache bounds the forced publishes' cost).
            **({"series": metrics_mod.series().export(
                cache_s=self.snapshot_interval_s)}
               if trace.enabled() else {}),
        })

    def _trace_export(self, now: float) -> dict:
        if (self._trace_blob is None
                or now - self._last_trace_pub >= self.snapshot_interval_s):
            self._last_trace_pub = now
            self._trace_blob = trace.recorder().export(max_events=256)
        return self._trace_blob


class PrefillWorker(_RoleWorkerBase):
    """The model-free prefill loop (handoff.py:312) over the engine
    protocol ``prefill_export(token_ids, max_new_tokens) -> (first token,
    payload)``: pops a request, exports, and pushes the record to the
    least-loaded registered decode replica (or the shared handoff queue);
    a request of at most one new token is answered here.

    ``on_exported(record)`` runs after the export and before the push: a
    ``HardKill`` raised there leaves the request's lease open, so the
    request is prefilled again elsewhere, never lost."""

    role = "prefill"

    def __init__(self, engine, broker, *, on_exported=None, **kw):
        self.on_exported = on_exported
        super().__init__(engine, broker, **kw)

    def run_once(self) -> int:
        self._publish()
        req = self.broker.pop_request(timeout=self.poll_timeout_s,
                                      worker_id=self.worker_id)
        if req is None:
            return 0
        self._inflight = 1
        self._publish(force=True)
        try:
            try:
                with trace.span(req.id, "prefill", trace_id=req.trace_id,
                                worker=self.worker_id,
                                n_tokens=len(req.token_ids or [])):
                    first, payload = self.engine.prefill_export(
                        list(req.token_ids or []), req.max_new_tokens)
            except Exception as e:  # noqa: BLE001 — the worker must answer
                self.broker.push_response(GenerateResponse(
                    id=req.id, error=f"prefill failed: {e}"))
                return 1
            if req.max_new_tokens <= 1:
                self.broker.push_response(GenerateResponse(
                    id=req.id, token_ids=[first] if req.max_new_tokens else []))
                return 1
            rec = HandoffRecord(req=req, first_token=first,
                                n_tokens=len(req.token_ids or []),
                                payload=payload)
            if self.on_exported is not None:
                self.on_exported(rec)  # the chaos hook: may HardKill
            target = pick_decode_worker(self.broker.read_workers(),
                                        self.broker.handoff_depths())
            if target is not None:
                self.broker.push_handoff_to(target, rec)
            else:
                self.broker.push_handoff(rec)
            return 1
        finally:
            self._inflight = 0
            self._publish(force=True)


class DecodeWorker(_RoleWorkerBase):
    """The model-free decode loop (handoff.py:384) over the engine protocol
    ``adopt_generate(payload, max_new_tokens, first_token, n_tokens,
    on_increment=) -> tokens``: leases a record (its own routed ones
    first), renews the lease at every increment, and answers; a record it
    cannot adopt goes back through ``fail_handoff``."""

    role = "decode"

    def run_once(self) -> int:
        self._publish()
        rec = self.broker.pop_handoff(timeout=self.poll_timeout_s,
                                      worker_id=self.worker_id)
        if rec is None:
            return 0
        self._inflight = 1
        self._publish(force=True)
        rid = rec.req.id
        try:
            try:
                with trace.span(rid, "decode", trace_id=rec.req.trace_id,
                                worker=self.worker_id,
                                max_new_tokens=rec.req.max_new_tokens):
                    toks = self.engine.adopt_generate(
                        rec.payload, rec.req.max_new_tokens, rec.first_token,
                        rec.n_tokens,
                        on_increment=lambda: self.broker.touch_handoffs([rid]))
            except Exception as e:  # noqa: BLE001 — dispose, do not die
                self.broker.fail_handoff(rec, error=str(e))
                return 1
            self.broker.push_response(GenerateResponse(id=rid,
                                                       token_ids=list(toks)))
            return 1
        finally:
            self._inflight = 0
            self._publish(force=True)
