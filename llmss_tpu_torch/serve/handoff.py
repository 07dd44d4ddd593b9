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

The port has no worker registry yet: ``pick_decode_worker`` is the
reference's pure function, and the consumer pushes every record to the
shared handoff queue, which any decode worker drains (what the reference
does when no decode worker is registered). The reference's model-free role
loops (``PrefillWorker`` / ``DecodeWorker``, driven by its chaos harness)
wait for the fleet slice.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import struct
import warnings
import zlib

import numpy as np
import torch

from llmss_tpu_torch.serve.protocol import STATE_READY, GenerateRequest

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
