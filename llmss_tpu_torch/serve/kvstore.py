"""The tiered KV store (counterpart: llmss_tpu/serve/kvstore.py): where KV
goes when the device lets go of it, and where the device refills from.

- **T0, the device**: the batcher's block pool and the worker's prefix
  LRU; not owned here.
- **T1, host RAM** (:class:`HostKVStore`): blobs in an LRU capped by
  bytes. Demotions land here first; what overflows spills to T2, or is
  dropped (counted) when there is no T2.
- **T2, the fleet's blob store** (:class:`InProcBlobStore`,
  :class:`RedisBlobStore`): keyed by the prefix hash or the session id,
  so every worker finds what any worker stored. Redis keys are
  ``{namespace}:kv:{key}``, the reference's, so one Redis carries the
  reference's blobs and the port's side by side and either package reads
  the other's.

A blob is the handoff's ``LKVH`` payload (serve/handoff.py) with the
segment's token ids in its header: the reference's bytes for the same
KV. bf16 travels as its raw bytes and int8 with its scales, so a demoted
and promoted prefix seeds the bits its prefill wrote.

The lifecycle (the batcher's ``demote_cb`` / ``park_cb`` and the
worker's store branches call it):

- **demote**: ``demote_prefix`` queues an evicted ``Prefix`` (which owns
  its tensors: its pool blocks are free at once); the store's thread
  copies it to the host and encodes it. On the card an event recorded at
  ``demote_prefix`` orders that copy after everything the serving thread
  enqueued before it, and the copy runs on the store's own stream into
  pinned memory, so it never queues among the serving kernels.
- **promote**: ``fetch_prefix`` looks a prefix up by its hash (T1, then
  T2, which warms T1 again), checks the CRC and the tokens and rebuilds
  a ``Prefix`` of ``build_prefix``'s shape on the device, on the calling
  thread: the request needs it now. A corrupt blob is deleted.
- **park / resume**: a finished session turn's exported blocks are
  encoded and stored under ``sess:{session_id}``; the next turn seeds
  from them and prefills only what is new. ``park_session`` encodes on
  the calling thread, as the reference's does, so the blob is in the
  store before the turn's answer is pushed.

``flush`` waits until every queued demotion has landed; the counters
count what landed.
"""

from __future__ import annotations

import logging
import queue
import threading
from collections import OrderedDict

import torch

from llmss_tpu_torch.device import resolve_device
from llmss_tpu_torch.engine.engine import Prefix, _bucket
from llmss_tpu_torch.serve.handoff import decode_blocks, encode_blocks
from llmss_tpu_torch.serve.protocol import prefix_hash

__all__ = [
    "HostKVStore", "InProcBlobStore", "RedisBlobStore", "TieredKVStore",
    "blocks_from_prefix", "decode_prefix", "encode_prefix", "prefix_from_blocks",
    "prefix_key", "session_key",
]

_ARRAYS = ("k", "v", "k_scale", "v_scale")

logger = logging.getLogger("llmss_tpu_torch.serve")


def prefix_key(token_ids) -> str:
    """The store key of a prefix blob: any worker that hashes the same
    tokens finds the same blob."""
    return "prefix:" + prefix_hash(list(token_ids))


def session_key(session_id: str) -> str:
    return "sess:" + str(session_id)


# -- Prefix <-> blocks ------------------------------------------------------------


def blocks_from_prefix(prefix: Prefix, block_size: int, *,
                       ready=None, stream=None) -> tuple[dict, int]:
    """A ``Prefix`` in ``export_blocks``' layout, ``[L, nb, bs, ...]`` host
    tensors, and its length (kvstore.py:89). The bucket padding is dropped
    first and the tail zero-filled to whole blocks, so the same tokens give
    the same bytes whatever the builder's cache held there.

    On the card the copy runs on ``stream`` (the current one when None)
    after ``ready``, an event recorded where the prefix's tensors were
    last written, into pinned memory; it is complete on return."""
    n = prefix.length
    nb = -(-n // block_size)
    cuda = prefix.k.is_cuda
    if cuda:
        stream = stream or torch.cuda.current_stream(prefix.k.device)
        if ready is not None:
            stream.wait_event(ready)

    def fold(a):
        if a is None:
            return None
        out = a.new_zeros((a.shape[0], nb * block_size) + tuple(a.shape[2:]))
        out[:, :n] = a[:, :n]
        out = out.reshape((a.shape[0], nb, block_size) + tuple(a.shape[2:]))
        if not cuda:
            return out
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        return host

    if cuda:
        with torch.cuda.stream(stream):
            blocks = {name: fold(getattr(prefix, name)) for name in _ARRAYS}
            done = torch.cuda.Event()
            done.record(stream)
        done.synchronize()
    else:
        blocks = {name: fold(getattr(prefix, name)) for name in _ARRAYS}
    return blocks, n


def prefix_from_blocks(tokens, blocks: dict, *, max_seq_len: int,
                       device=None) -> Prefix:
    """A ``Prefix`` on ``device`` (the GPU when None) from a blob's blocks
    (kvstore.py:121), padded to ``_bucket(n, max_seq_len)`` slots as
    ``build_prefix`` pads it, with the blocks' dtype; pad slots are zero
    and carry no positions. On the card the blocks are staged in pinned
    memory and copied without blocking, on the current stream."""
    dev = resolve_device(device)
    tokens = tuple(int(t) for t in tokens)
    n = len(tokens)
    pb = _bucket(n, max_seq_len)

    def unfold(a):
        if a is None:
            return None
        a = torch.as_tensor(a)
        rest = tuple(a.shape[3:])
        flat = a.reshape((a.shape[0], a.shape[1] * a.shape[2]) + rest)
        if dev.type == "cuda":
            flat = flat.pin_memory().to(dev, non_blocking=True)
        out = torch.zeros((a.shape[0], pb) + rest, dtype=a.dtype, device=dev)
        out[:, :n] = flat[:, :n]
        return out

    return Prefix(tokens=tokens, **{name: unfold(blocks.get(name))
                                    for name in _ARRAYS})


def encode_prefix(prefix: Prefix, block_size: int, *, ready=None,
                  stream=None) -> bytes:
    """A ``Prefix`` as a self-describing blob: its token ids ride in the
    header (kvstore.py:161)."""
    blocks, n = blocks_from_prefix(prefix, block_size, ready=ready,
                                   stream=stream)
    return encode_blocks(blocks, req_id=prefix_key(prefix.tokens), n_tokens=n,
                         block_size=block_size, tokens=list(prefix.tokens))


def decode_prefix(payload: bytes, *, max_seq_len: int, device=None) -> Prefix:
    """A blob back into a ``Prefix`` on ``device``. Raises ``ValueError``
    on a corrupt payload or one without token ids (not a prefix blob)."""
    d = decode_blocks(payload)
    if d.get("tokens") is None:
        raise ValueError("not a prefix blob: no token ids in header")
    if len(d["tokens"]) != d["n_tokens"]:
        raise ValueError("corrupt prefix blob: token count mismatch")
    return prefix_from_blocks(d["tokens"], d, max_seq_len=max_seq_len,
                              device=device)


# -- T1: host RAM -------------------------------------------------------------------


class HostKVStore:
    """Blobs in host RAM, an LRU capped by bytes (tier T1, kvstore.py:185).
    The least recently used blob past the cap spills through ``spill_cb``
    (a T2 put) when there is one, else it is dropped; both are counted."""

    def __init__(self, cap_bytes: int = 1 << 30, spill_cb=None):
        self.cap_bytes = int(cap_bytes)
        self.spill_cb = spill_cb
        self._lock = threading.Lock()
        self._map: OrderedDict[str, bytes] = OrderedDict()  # guarded_by: self._lock
        self._bytes = 0  # guarded_by: self._lock
        self.hits = 0  # guarded_by: self._lock
        self.misses = 0  # guarded_by: self._lock
        self.spilled = 0  # guarded_by: self._lock
        self.dropped = 0  # guarded_by: self._lock

    def put(self, key: str, payload: bytes) -> None:
        """Insert or refresh ``key``, then evict least recently used blobs
        past the cap; a blob larger than the whole cap goes straight
        through."""
        overflow: list[tuple[str, bytes]] = []
        with self._lock:
            old = self._map.pop(key, None)
            if old is not None:
                self._bytes -= len(old)
            if len(payload) > self.cap_bytes:
                overflow.append((key, payload))
            else:
                self._map[key] = payload
                self._bytes += len(payload)
                while self._bytes > self.cap_bytes:
                    k, v = self._map.popitem(last=False)
                    self._bytes -= len(v)
                    overflow.append((k, v))
        # Outside the lock: a T2 put (a Redis round trip) never blocks the
        # map's readers.
        for k, v in overflow:
            if self.spill_cb is not None:
                self.spill_cb(k, v)
                with self._lock:
                    self.spilled += 1
            else:
                with self._lock:
                    self.dropped += 1

    def get(self, key: str) -> bytes | None:
        with self._lock:
            payload = self._map.pop(key, None)
            if payload is None:
                self.misses += 1
                return None
            self._map[key] = payload  # most recently used last
            self.hits += 1
            return payload

    def pop(self, key: str) -> bytes | None:
        with self._lock:
            payload = self._map.pop(key, None)
            if payload is not None:
                self._bytes -= len(payload)
            return payload

    def keys(self) -> list[str]:
        with self._lock:
            return list(self._map)

    def stats(self) -> dict:
        with self._lock:
            return {"bytes": self._bytes, "cap_bytes": self.cap_bytes,
                    "entries": len(self._map), "hits": self.hits,
                    "misses": self.misses, "spilled": self.spilled,
                    "dropped": self.dropped}


# -- T2: the fleet's blob store -----------------------------------------------------


class InProcBlobStore:
    """T2 in this process (one-process fleets, tests), with
    :class:`RedisBlobStore`'s contract."""

    def __init__(self):
        self._lock = threading.Lock()
        self._map: dict[str, bytes] = {}  # guarded_by: self._lock
        self.puts = 0  # guarded_by: self._lock
        self.hits = 0  # guarded_by: self._lock
        self.misses = 0  # guarded_by: self._lock

    def put(self, key: str, payload: bytes) -> None:
        with self._lock:
            self._map[key] = bytes(payload)
            self.puts += 1

    def get(self, key: str) -> bytes | None:
        with self._lock:
            payload = self._map.get(key)
            if payload is None:
                self.misses += 1
            else:
                self.hits += 1
            return payload

    def delete(self, key: str) -> None:
        with self._lock:
            self._map.pop(key, None)

    def keys(self) -> list[str]:
        with self._lock:
            return list(self._map)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._map), "puts": self.puts,
                    "hits": self.hits, "misses": self.misses}


class RedisBlobStore:
    """T2 on Redis: raw bytes under ``{namespace}:kv:{key}``, a segment of
    its own beside the broker's keys. ``client`` is any Redis-compatible
    object (the broker's client, ``redis.Redis``, a fake); this module
    never imports ``redis``."""

    def __init__(self, client, namespace: str = "llmss"):
        self.r = client
        self.ns = namespace
        self._lock = threading.Lock()
        self.puts = 0  # guarded_by: self._lock
        self.hits = 0  # guarded_by: self._lock
        self.misses = 0  # guarded_by: self._lock

    def _key(self, key: str) -> str:
        return f"{self.ns}:kv:{key}"

    def put(self, key: str, payload: bytes) -> None:
        self.r.set(self._key(key), bytes(payload))
        with self._lock:
            self.puts += 1

    def get(self, key: str) -> bytes | None:
        payload = self.r.get(self._key(key))
        with self._lock:
            if payload is None:
                self.misses += 1
            else:
                self.hits += 1
        return payload

    def delete(self, key: str) -> None:
        self.r.delete(self._key(key))

    def keys(self) -> list[str]:
        strip = len(f"{self.ns}:kv:")
        out = []
        for k in self.r.scan_iter(match=f"{self.ns}:kv:*"):
            if isinstance(k, bytes):
                k = k.decode()
            out.append(k[strip:])
        return out

    def stats(self) -> dict:
        with self._lock:
            counts = {"puts": self.puts, "hits": self.hits,
                      "misses": self.misses}
        return {"entries": len(self.keys()), **counts}


# -- the tiers together ------------------------------------------------------------


class TieredKVStore:
    """T1 over T2 with the demote / promote / park / resume lifecycle
    (kvstore.py:369; module docstring). ``fault_hook(stage, key)``, when
    set, is called before a T2 fetch (the reference's chaos surface)."""

    def __init__(self, host: HostKVStore | None = None, blob=None):
        self.blob = blob
        self.host = host or HostKVStore(
            spill_cb=blob.put if blob is not None else None)
        if host is not None and blob is not None and host.spill_cb is None:
            host.spill_cb = blob.put
        self.fault_hook = None
        self._lock = threading.Lock()
        self.prefix_demotes = 0  # guarded_by: self._lock
        self.prefix_promotes = 0  # guarded_by: self._lock
        self.prefix_demote_errors = 0  # guarded_by: self._lock
        self.sessions_parked = 0  # guarded_by: self._lock
        self.sessions_resumed = 0  # guarded_by: self._lock
        self.reprefill_tokens_avoided = 0  # guarded_by: self._lock
        self._stream = None  # the store thread's CUDA stream, made there
        self._q: queue.Queue = queue.Queue()
        self._worker = threading.Thread(target=self._loop,
                                        name="kvstore-demote", daemon=True)
        self._worker.start()

    # -- the blob plane -----------------------------------------------------------

    def put_blob(self, key: str, payload: bytes) -> None:
        """T1 insert (its overflow spills to T2)."""
        self.host.put(key, payload)

    def get_blob(self, key: str) -> bytes | None:
        """T1, then T2; a T2 hit warms T1 again."""
        payload = self.host.get(key)
        if payload is not None or self.blob is None:
            return payload
        if self.fault_hook is not None:
            self.fault_hook("t2_get", key)
        payload = self.blob.get(key)
        if payload is not None:
            self.host.put(key, payload)
        return payload

    def delete_blob(self, key: str) -> None:
        self.host.pop(key)
        if self.blob is not None:
            self.blob.delete(key)

    # -- the store's thread --------------------------------------------------------

    def _loop(self) -> None:
        while True:
            job = self._q.get()
            try:
                job()
            except Exception:  # noqa: BLE001 — the thread outlives a job
                logger.exception("kv store job failed")
            finally:
                self._q.task_done()

    def _side_stream(self, device):
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return self._stream

    def flush(self) -> None:
        """Block until every queued demotion has landed."""
        self._q.join()

    # -- prefixes -------------------------------------------------------------------

    def demote_prefix(self, prefix: Prefix, block_size: int) -> None:
        """Queue an evicted ``Prefix`` for the store's thread to copy down
        and encode into T1 / T2; returns at once."""
        ready = None
        if prefix.k.is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(prefix.k.device))
        bs = int(block_size)

        def demote():
            try:
                with torch.inference_mode():
                    stream = (self._side_stream(prefix.k.device)
                              if ready is not None else None)
                    payload = encode_prefix(prefix, bs, ready=ready,
                                            stream=stream)
                self.put_blob(prefix_key(prefix.tokens), payload)
                with self._lock:
                    self.prefix_demotes += 1
            except Exception:  # noqa: BLE001 — a failed demote is a drop, counted
                with self._lock:
                    self.prefix_demote_errors += 1

        self._q.put(demote)

    def fetch_prefix(self, token_ids, *, max_seq_len: int,
                     device=None) -> Prefix | None:
        """Promote: the stored prefix of these tokens rebuilt on ``device``,
        or None when no tier has it. A corrupt blob, or one of other tokens,
        is deleted and the caller prefills."""
        key = prefix_key(token_ids)
        payload = self.get_blob(key)
        if payload is None:
            return None
        try:
            pfx = decode_prefix(payload, max_seq_len=max_seq_len,
                                device=device)
            if pfx.tokens != tuple(int(t) for t in token_ids):
                raise ValueError("prefix blob token mismatch")
        except ValueError:
            self.delete_blob(key)
            return None
        with self._lock:
            self.prefix_promotes += 1
        return pfx

    # -- sessions -------------------------------------------------------------------

    def park_session(self, session_id: str, tokens, blocks: dict,
                     block_size: int) -> None:
        """Encode a finished turn's exported blocks (host tensors) and store
        them under the session key, on the calling thread (kvstore.py:483)."""
        key = session_key(session_id)
        toks = [int(t) for t in tokens]
        payload = encode_blocks(blocks, req_id=key, n_tokens=len(toks),
                                block_size=int(block_size), tokens=toks)
        self.put_blob(key, payload)
        with self._lock:
            self.sessions_parked += 1

    def resume_session(self, session_id: str, token_ids=None):
        """Take the parked KV of ``session_id``: ``(tokens, blocks)`` or
        None. With ``token_ids`` (the new turn's prompt) the blob is taken
        only when its tokens are a proper prefix of them; another history
        leaves it in place. A taken blob leaves every tier: the resumed row
        moves on from it at once, so a second resume must prefill."""
        key = session_key(session_id)
        payload = self.get_blob(key)
        if payload is None:
            return None
        try:
            d = decode_blocks(payload)
        except ValueError:
            self.delete_blob(key)
            return None
        if d.get("tokens") is None:
            self.delete_blob(key)
            return None
        tokens = [int(t) for t in d["tokens"]]
        if token_ids is not None:
            ids = [int(t) for t in token_ids]
            if len(tokens) >= len(ids) or ids[: len(tokens)] != tokens:
                return None
        self.delete_blob(key)
        with self._lock:
            self.sessions_resumed += 1
        return tokens, {name: d[name] for name in _ARRAYS}

    def note_reprefill_avoided(self, n_tokens: int) -> None:
        with self._lock:
            self.reprefill_tokens_avoided += int(n_tokens)

    # -- observability --------------------------------------------------------------

    def stats(self) -> dict:
        """Each tier's residency and the lifecycle counters, numeric leaves
        only (the reference's keys): they render straight into Prometheus
        families and sum across a fleet."""
        with self._lock:
            life = {"prefix_demotes": self.prefix_demotes,
                    "prefix_promotes": self.prefix_promotes,
                    "prefix_demote_errors": self.prefix_demote_errors,
                    "sessions_parked": self.sessions_parked,
                    "sessions_resumed": self.sessions_resumed,
                    "reprefill_tokens_avoided": self.reprefill_tokens_avoided}
        out = {"t1": self.host.stats(), **life}
        if self.blob is not None:
            out["t2"] = self.blob.stats()
        return out
