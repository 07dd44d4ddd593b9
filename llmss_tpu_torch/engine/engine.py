"""DecodeEngine: prefill, decode steps and the generation loop
(counterpart: llmss_tpu/engine/engine.py).

The reference jits its programs and donates the cache; the port updates
the cache in place (engine/cache.py) and runs each decode step on the GPU
as a replay of a CUDA graph captured over persistent buffers
(engine/graphs.py), which ``prewarm`` captures up front; prefill and the
ragged group run eagerly. ``generate`` decodes into one persistent cache,
reset in full at every call, so its graphs stay valid (a call with another
row count replaces it, and its graphs go with it).
The grouped decode keeps the reference's contract:
``chunk_steps`` steps run back to back on the device with EOS and NaN
poison folded into device-side state (done rows stop writing KV: their
slot is set past the ring and the write is dropped), and the host reads
the chunk's tokens and poison flags in ONE packed transfer.

``kv_layout="paged"`` keeps the KV in a block pool addressed through
per-row block tables (engine/cache.py); ``generate`` then runs over
identity tables, and the continuous batcher (engine/scheduler.py) drives
the tables from its allocator. The batcher's device programs live here:
``_admit_merge`` (fold admitted rows into the device-resident decode
state), the grouped decode ``_decode_group`` (``n_chunks`` chunks of
``n_steps`` steps, one packed result) and the ragged mixed
prefill+decode group ``_ragged_group`` (chunked prefill).

``generate_fused`` runs a whole generation as a prefill, ``max_new - 1``
replays and one fetch.

``kv_dtype="int8"`` stores the cache quantized with per-(token, head)
scales (engine/cache.py): half the KV bytes, so twice the rows or the
context on a card. Every path above runs on it unchanged; the kernels fold
the scales in (models/decoder.py).

Shared-prefix reuse: ``build_prefix`` prefills a shared prompt prefix
once and keeps its KV as a ``Prefix``; ``generate(prefix=)`` seeds every
row's first slots from it (``seed_cache``) and prefills only each prompt's
suffix at positions ``P...`` with draw counters ``P + len``, so the tokens
are those of a prefill from scratch. The continuous batcher shares the
prefix's full blocks across rows (engine/scheduler.py).

Device telemetry (utils/devtel.py, engine.py:725-760): ``devtel_cost``
prices a step signature from the analytical model into the process's cost
table (prewarm derives every signature the live path can pick, so the fold
site's lookup is a hit), the grouped ``generate`` folds each chunk's
dispatch-to-fetch interval into ``decode_group`` MFU/MBU, and every graph
capture is recorded as a compile event named by its signature; prewarm
runs inside ``observer().warming()`` and ends with ``mark_steady``.

On a mesh (``mesh=``, parallel/mesh.py; engine.py:144-159, :668-712) each
rank runs this engine SPMD over its parameter shard
(``parallel.sharding.shard_params`` or ``load_model(mesh=)``) and its part
of the cache: of the dense ring (``engine/cache.mesh_layout``), or of the
paged pool (its KV heads over tp, the pool whole on every dp replica:
``parallel.sharding.paged_cache_specs``). dp ranks take their rows of a
``generate`` batch when dp divides it and the tokens are all-gathered
over dp, so every rank returns the whole batch; the continuous batcher
(engine/scheduler.py) runs every row on every dp replica. Under a
sequence-sharded ring nothing is bucketed, and the paged layout is
refused (the reference's ``ValueError``). Sampling needs no new state: each row draws
from its own seed and position, so a dp rank's rows draw what they would
in the whole batch, and the tp / sp ranks of a row, holding the same
logits, draw the same tokens. Under NCCL the step graphs are captured
as without a mesh (a collective over two or more ranks inside a capture
is unverified until a run on two or more cards); under gloo (which
cannot be captured) every step runs eagerly and ``prewarm`` captures
nothing. On a mesh of more than one rank
``generate_speculative``, and shared prefixes and the int8 cache under
sp > 1, raise ``NotImplementedError`` (ROADMAP's next mesh slice).

``generate_speculative`` (engine/speculative.py) is greedy generation
with prompt-lookup speculation: each step verifies a drafted window of
``gamma + 1`` tokens a row in one forward (K2w on the GPU), a group of
steps is that many replays of one captured step graph, and the host reads
the group in one transfer.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from llmss_tpu_torch.device import resolve_device
from llmss_tpu_torch.engine import speculative as spec
from llmss_tpu_torch.engine.cache import (
    KVCache, PagedKVCache, init_cache, init_paged_cache, mesh_layout,
    paged_write_stacked,
)
from llmss_tpu_torch.engine.graphs import (
    SAMPLING_VARIANTS, DecodeGraphs, SpecBuffers, StepBuffers,
)
from llmss_tpu_torch.engine.metrics import EngineMetrics
from llmss_tpu_torch.models.common import DecoderConfig
from llmss_tpu_torch.models.decoder import (
    Params, forward, forward_ragged, rope_inv_freq, unstack_layers,
)
from llmss_tpu_torch.ops._build import check_head_dim
from llmss_tpu_torch.ops.sampling import fold_step_outcome, sample
from llmss_tpu_torch.parallel.mesh import AXIS_DP, AXIS_SP
from llmss_tpu_torch.parallel.sharding import all_gather, check_tp
from llmss_tpu_torch.utils import devtel
from llmss_tpu_torch.utils.signatures import signature, signature_str


class Prefix(NamedTuple):
    """The retained KV of a shared prompt prefix (a system prompt, earlier
    turns of a session), built once by ``DecodeEngine.build_prefix``
    (engine.py:49). Requests that start with ``tokens`` seed their rows
    from it and prefill only their suffix. ``k`` / ``v`` keep the prefill
    bucket's padded length ``Pb``; an int8 engine keeps them quantized,
    with their scales, so every reuse seeds the same bits."""

    tokens: tuple[int, ...]  # the prefix token ids (host, for matching)
    k: torch.Tensor  # [L, Pb, Hkv, D] on the engine's device (int8 if int8)
    v: torch.Tensor
    k_scale: torch.Tensor | None  # [L, Pb, Hkv] fp32 iff int8
    v_scale: torch.Tensor | None

    @property
    def length(self) -> int:
        return len(self.tokens)


@dataclasses.dataclass
class GenerationParams:
    """Per-call generation controls."""

    max_new_tokens: int = 20
    is_greedy: bool = True
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    eos_token_id: int | None = None
    seed: int = 0

    def validate(self) -> None:
        if not self.is_greedy:
            if not self.temperature > 0.0:
                raise ValueError("temperature must be > 0")
            if not self.top_k >= 0:
                raise ValueError("top_k must be >= 0")
            if not 0.0 < self.top_p <= 1.0:
                raise ValueError("top_p must be in (0, 1]")
        if not self.max_new_tokens > 0:
            raise ValueError("max_new_tokens must be > 0")


def _bucket(n: int, cap: int) -> int:
    b = 16
    while b < n:
        b *= 2
    return min(b, cap)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def to_device(arr, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without waiting on the device: on CUDA
    it is staged in pinned memory and copied asynchronously (a plain copy
    from pageable memory would synchronise the stream)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class DecodeEngine:
    """Drives one model on one device (or, with ``mesh``, one rank of a
    mesh) with a fixed (batch, max_seq) envelope.

    ``device=None`` means the GPU (the mesh's device on a mesh); without
    one this raises (pass ``device="cpu"`` for the plain PyTorch path)."""

    def __init__(
        self,
        cfg: DecoderConfig,
        params: Params,
        *,
        device=None,
        batch_size: int = 1,
        max_seq_len: int | None = None,
        kv_layout: str = "dense",
        block_size: int = 16,
        kv_blocks: int | None = None,
        kv_dtype: str | None = None,
        mesh=None,
    ):
        self.mesh = mesh
        if mesh is not None and device is None:
            device = mesh.device
        self.device = resolve_device(device)
        check_head_dim(cfg.head_dim, self.device)
        self.batch_size = batch_size
        self.max_seq_len = max_seq_len or cfg.max_position_embeddings
        # kv_layout="paged": KV in a global block pool addressed through
        # per-row block tables, with the dense logical-slot contract.
        # ``kv_blocks`` sizes the batcher's pool (None: the dense
        # equivalent rows * max_seq_len / block_size).
        if kv_layout not in ("dense", "paged"):
            raise ValueError(
                f"kv_layout must be 'dense' or 'paged', got {kv_layout!r}"
            )
        if kv_layout == "paged" and self.max_seq_len % block_size:
            raise ValueError(
                f"kv_layout='paged' needs max_seq_len ({self.max_seq_len}) "
                f"divisible by block_size ({block_size})"
            )
        self.kv_layout = kv_layout
        self.block_size = block_size
        self.kv_blocks = kv_blocks
        # kv_dtype="int8": the cache stored quantized, None: the compute
        # dtype (llmss_tpu/engine/engine.py:176-183).
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"kv_dtype must be None or 'int8', got {kv_dtype!r}")
        self._cache_dtype = (torch.int8 if kv_dtype == "int8"
                             else cfg.torch_dtype)
        # A ring split over sp: its reads are never bucketed (engine.py:
        # 668-712), and slots stay global.
        self._seq_sharded = False
        if mesh is not None:
            check_tp(cfg, mesh.shape["tp"])
            self._seq_sharded = mesh_layout(
                mesh, batch=1, max_len=self.max_seq_len,
                n_kv_heads=cfg.n_kv_heads).seq_sp
            if kv_layout == "paged" and mesh.shape[AXIS_SP] > 1:
                raise ValueError(
                    "kv_layout='paged' does not support sp > 1 meshes "
                    "(the sequence axis is block-indirected per row)")
            if self._seq_sharded and kv_dtype == "int8":
                self._next_mesh_slice("an int8 cache under sp > 1")
        if (
            cfg.rope_original_max_positions is not None
            and cfg.rope_freq_factors_short is not None
        ):
            # LongRoPE: the rotary basis follows the context this engine
            # serves, as in the reference engine.
            chosen = (
                cfg.rope_freq_factors_long
                if self.max_seq_len > cfg.rope_original_max_positions
                else cfg.rope_freq_factors_short
            )
            cfg = dataclasses.replace(cfg, rope_freq_factors=chosen)
        self.cfg = cfg
        if cfg.positions == "rotary":
            # Built now, outside any graph capture (the tensors' device:
            # "cuda" resolves to "cuda:0").
            rope_inv_freq(cfg, torch.empty(0, device=self.device).device)
        self.params = params
        self._layers = unstack_layers(params)
        self.metrics = EngineMetrics()
        self._ladder = [] if self._seq_sharded else self.bucket_ladder()
        # Gloo's collectives cannot be captured: every step runs eagerly.
        self._graphs = DecodeGraphs(
            self.device, cfg.vocab_size,
            eager=mesh is not None and not mesh.capturable)
        # generate's persistent cache (the step graphs hold its addresses);
        # a call with another row count replaces it.
        self._cache: KVCache | PagedKVCache | None = None
        self._devtel_model: devtel.EngineCostModel | None = None
        # The request a capture is charged to (set by the batcher before it
        # dispatches a group).
        self.devtel_req_id: str | None = None

    def _next_mesh_slice(self, what: str):
        raise NotImplementedError(
            f"{what} on a mesh of {self.mesh.world} ranks is the next mesh "
            "slice (ROADMAP, Queue 1 item 8)")

    def _mesh_check(self, what: str, axis: str | None = None) -> None:
        """Refuse a path the mesh does not run yet: on a mesh of more than
        one rank, or (``axis``) one whose ``axis`` has more than one."""
        if self.mesh is None:
            return
        if (self.mesh.world if axis is None else self.mesh.shape[axis]) > 1:
            self._next_mesh_slice(what)

    def _ring_len(self, cache) -> int:
        """The global ring length of ``cache`` (a chunk of it on an sp
        rank): what slots are taken modulo."""
        return self.max_seq_len if self._seq_sharded else cache.max_len

    def _fwd(self, ids, positions, cache, slots, **kw):
        """``forward`` over this engine's layers, on its mesh."""
        return forward(self.cfg, self.params, ids, positions, cache, slots,
                       layers=self._layers, mesh=self.mesh,
                       seq_sharded=self._seq_sharded, **kw)

    def _dp_rows(self, batch: int) -> tuple[int, int] | None:
        """This dp rank's rows ``[lo, hi)`` of a ``batch``, or None when
        every rank runs the whole batch (no dp, or dp does not divide
        it)."""
        if self.mesh is None or self.mesh.shape[AXIS_DP] == 1:
            return None
        lay = mesh_layout(self.mesh, batch=batch, max_len=self.max_seq_len,
                          n_kv_heads=self.cfg.n_kv_heads)
        if not lay.batch_dp:
            return None
        lo = self.mesh.coord(AXIS_DP) * lay.batch
        return lo, lo + lay.batch

    def _local_batch(self, batch: int) -> int:
        """The rows this rank runs of a ``batch``."""
        rows = self._dp_rows(batch)
        return batch if rows is None else rows[1] - rows[0]

    def _gather_rows(self, out: list[list[int]]) -> list[list[int]]:
        """Every dp rank's rows of token lists, in row order (ragged rows
        padded for the gather, then trimmed)."""
        dev = self.mesh.device
        lens = torch.tensor([len(o) for o in out], dtype=torch.int64,
                            device=dev)
        all_lens = all_gather(lens, self.mesh, AXIS_DP, 0).cpu().tolist()
        width = max(all_lens, default=0)
        pad = torch.full((len(out), max(width, 1)), -1, dtype=torch.int64)
        for i, o in enumerate(out):
            pad[i, :len(o)] = torch.tensor(o, dtype=torch.int64)
        toks = all_gather(pad.to(dev), self.mesh, AXIS_DP, 0).cpu()
        return [toks[i, :n].tolist() for i, n in enumerate(all_lens)]

    # -- envelope -------------------------------------------------------------

    def seq_buckets(self) -> list[int]:
        """Every prompt bucket ``_pad_prompts`` can produce."""
        out, b = [], 16
        while b < self.max_seq_len:
            out.append(b)
            b *= 2
        out.append(self.max_seq_len)
        return out

    def bucket_ladder(self) -> list[int]:
        """Cache-read buckets for decode: multiples of
        ``max(32, max_seq_len/16)`` below max_seq_len."""
        g = max(32, -(-self.max_seq_len // (16 * 32)) * 32)
        return list(range(g, self.max_seq_len, g))

    def decode_bucket(self, pos_bound: int) -> int | None:
        """The cache-read bucket for a decode call whose rows' positions
        are all < ``pos_bound``; None (full ring) when no ladder entry
        covers it or a row may have wrapped."""
        if not self._ladder or pos_bound > self.max_seq_len:
            return None
        for b in self._ladder:
            if b >= pos_bound:
                return b
        return None

    def prewarm_bucket_set(self) -> "list[int | None]":
        """Every ``t_bucket`` the live decode path can pick: the full ring
        and the ladder."""
        return [None] + self._ladder

    def check_capacity(self, n_prompt_tokens: int, max_new_tokens: int):
        """Reject a request that would wrap the ring mid-generation."""
        if n_prompt_tokens + max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"prompt ({n_prompt_tokens} tokens) + max_new_tokens "
                f"({max_new_tokens}) exceeds the engine's max_seq_len "
                f"({self.max_seq_len})"
            )

    def new_cache(self, batch: int | None = None) -> KVCache | PagedKVCache:
        """A fresh cache for ``batch`` rows (on a mesh: this rank's ring
        chunk and KV heads of them)."""
        if self.kv_layout == "paged":
            return self.new_paged_cache(batch)
        max_len, n_kv_heads = self.max_seq_len, self.cfg.n_kv_heads
        if self.mesh is not None:
            lay = mesh_layout(self.mesh, batch=batch or self.batch_size,
                              max_len=max_len, n_kv_heads=n_kv_heads)
            max_len, n_kv_heads = lay.max_len, lay.n_kv_heads
        return init_cache(
            n_layers=self.cfg.n_layers, batch=batch or self.batch_size,
            max_len=max_len, n_kv_heads=n_kv_heads,
            head_dim=self.cfg.head_dim, dtype=self._cache_dtype,
            device=self.device,
        )

    def new_paged_cache(
        self, batch: int | None = None, *, num_blocks: int | None = None,
        identity: bool = True,
    ) -> PagedKVCache:
        """Fresh paged cache. ``identity=True`` (the engine's generate)
        maps row b to blocks [b*MB, (b+1)*MB) of a full pool;
        ``identity=False`` (the batcher) starts every table at the sentinel
        over a pool of ``num_blocks`` (default: ``kv_blocks``, else the
        dense equivalent). On a mesh the pool holds this rank's KV heads
        and every block."""
        if num_blocks is None and not identity:
            num_blocks = self.kv_blocks
        return init_paged_cache(
            n_layers=self.cfg.n_layers, batch=batch or self.batch_size,
            max_len=self.max_seq_len, n_kv_heads=self.cfg.n_kv_heads,
            head_dim=self.cfg.head_dim, dtype=self._cache_dtype,
            device=self.device, block_size=self.block_size,
            num_blocks=num_blocks, identity_tables=identity, mesh=self.mesh,
        )

    def _generate_cache(self, batch: int) -> KVCache | PagedKVCache:
        """``generate``'s persistent cache for ``batch`` rows, reset in
        full: positions to -1 and K/V (and int8 scales) to zero (a masked
        slot left holding a poisoned row's NaN would turn into 0 * NaN in a
        later P.V). A new
        row count frees the old cache, and with it its step graphs and
        buffers, before allocating the new one."""
        cache = self._cache
        if cache is None or cache.positions.shape[0] != batch:
            self._cache = cache = None
            # Normal tensors, which code in and out of inference mode can
            # reset.
            with torch.inference_mode(False):
                cache = self._cache = self.new_cache(batch)
        else:
            for t in (cache.k, cache.v, cache.k_scale, cache.v_scale):
                if t is not None:
                    t.zero_()
            cache.positions.fill_(-1)
        return cache

    def _sample_args(self, gens: "GenerationParams | list[GenerationParams]",
                     batch: int) -> dict:
        """Per-row sampling tensors on the device plus the two batch-level
        branch flags, known here on the host (ops/sampling.sample)."""
        if isinstance(gens, GenerationParams):
            gens = [gens] * batch

        def dev(values, dtype):
            return to_device(np.asarray(values, dtype), self.device)

        return dict(
            seeds=dev([g.seed for g in gens], np.int32),
            temperature=dev([g.temperature for g in gens], np.float32),
            top_k=dev([g.top_k for g in gens], np.int32),
            top_p=dev([g.top_p for g in gens], np.float32),
            greedy=dev([g.is_greedy for g in gens], np.bool_),
            any_sampled=any(not g.is_greedy for g in gens),
            needs_filter=any(
                not g.is_greedy and (g.top_k > 0 or g.top_p < 1.0)
                for g in gens
            ),
        )

    def _pad_prompts(
        self, prompts: list[list[int]], pad_id: int = 0
    ) -> tuple[np.ndarray, np.ndarray]:
        lens = np.array([len(p) for p in prompts], np.int32)
        if lens.max() > self.max_seq_len:
            raise ValueError(
                f"prompt length {lens.max()} exceeds max_seq_len "
                f"{self.max_seq_len}"
            )
        S = _bucket(int(lens.max()), self.max_seq_len)
        ids = np.full((len(prompts), S), pad_id, np.int32)
        for i, p in enumerate(prompts):
            ids[i, : len(p)] = p
        return ids, lens

    # -- device steps -----------------------------------------------------------

    @torch.inference_mode()
    def _prefill(self, ids, cache, prompt_lens, sample_args, start=None):
        """Prefill right-padded prompts; pad columns are recorded with
        position -1 so no later step attends them. ``start`` ([B] int32)
        offsets the positions: a prefix-reused request prefills only its
        suffix, at ``[start, start + len)``, over rows whose first
        ``start`` slots were seeded (``seed_cache``); ``prompt_lens`` is
        then the suffix length. Returns (first token [B], its logits
        [B, V])."""
        B, S = ids.shape
        rel = torch.arange(S, dtype=torch.int32, device=ids.device)[None, :]
        off = (torch.zeros(B, dtype=torch.int32, device=ids.device)
               if start is None else start)
        positions = off[:, None] + rel
        valid = rel < prompt_lens[:, None]
        slots = positions % self._ring_len(cache)
        kv_pos = torch.where(valid, positions, -1)
        logits, _ = self._fwd(ids, positions, cache, slots,
                              gather_idx=prompt_lens - 1,
                              kv_write_positions=kv_pos)
        # The sampled token sits at absolute position start + prompt_len:
        # that position is the row's draw counter, so a seeded request
        # draws the tokens it would draw prefilled from scratch.
        tok = sample(logits[:, 0], counters=off + prompt_lens, **sample_args)
        return tok, logits[:, 0]

    def _step_body(self, kind: str, bufs: StepBuffers, cache, sample_args,
                   t_bucket):
        """One decode step over ``bufs`` and ``cache``, updating both in
        place: ``"plain"`` (the reference's ``_decode``: sample the next
        token, keep the logits) or ``"fold"`` (a step of the grouped
        decode: done rows write no KV, EOS and poison fold into the carry,
        and the position advances)."""
        sa = bufs.sample_args(sample_args["any_sampled"],
                              sample_args["needs_filter"])
        T = self._ring_len(cache)

        def step():
            positions = bufs.cur_pos[:, None]
            slots = positions % T
            if kind == "fold":
                # Done rows stop writing KV: their slot goes past the ring
                # and every write site drops it (under the paged layout a
                # freed row's stale table may point at reassigned blocks).
                slots = torch.where(bufs.done[:, None], T, slots)
            logits, _ = self._fwd(bufs.tokens[:, None], positions, cache,
                                  slots, t_bucket=t_bucket)
            logits = logits[:, 0]
            tok = sample(logits, counters=bufs.cur_pos + 1, **sa)
            if kind == "plain":
                bufs.tokens.copy_(tok)
                bufs.logits.copy_(logits)
                return
            tok, done, poisoned = fold_step_outcome(
                logits, tok, bufs.done, bufs.poisoned, bufs.eos
            )
            bufs.tokens.copy_(tok)
            bufs.done.copy_(done)
            bufs.poisoned.copy_(poisoned)
            bufs.cur_pos.add_(1)

        return step

    @staticmethod
    def _step_key(kind: str, sample_args, t_bucket) -> tuple:
        """A step graph's key within its cache's graphs."""
        return (kind, t_bucket, sample_args["any_sampled"],
                sample_args["needs_filter"])

    def _step(self, kind: str, cache, sample_args, t_bucket, load):
        """``(bufs, step)``: the cache's step buffers, filled by ``load``,
        and the step's graph replay over them (captured now if new, which
        the metrics count; the CPU runs the body)."""
        g = self._graphs.for_cache(cache)
        load(g.bufs)
        key = self._step_key(kind, sample_args, t_bucket)
        t0 = time.perf_counter()
        step, captured = g.step(
            key, self._step_body(kind, g.bufs, cache, sample_args, t_bucket))
        if captured:
            self.metrics.add_graph(captures=1)
            self._record_capture(
                "decode" if kind == "plain" else "decode_group",
                (g.bufs.tokens.shape[0], *key[1:]), time.perf_counter() - t0)
        return g.bufs, step

    def _spec_step(self, cache, bufs: SpecBuffers, gamma: int, ngram: int,
                   t_bucket):
        """The replay of one speculative step over ``bufs`` and ``cache``
        (engine/speculative.py ``spec_step``, its outcome recorded in
        ``bufs.packed``), captured now if new under ``("spec", gamma,
        ngram, group, t_bucket)``, which the metrics count; on the CPU the
        step body."""

        def body():
            choice, n_emit = spec.spec_step(
                self.cfg, self.params, bufs.hist, bufs.hist_len, cache,
                bufs.done, bufs.eos, gamma=gamma, ngram=ngram,
                t_bucket=t_bucket, layers=self._layers)
            bufs.record(choice, n_emit)

        t0 = time.perf_counter()
        step, captured = self._graphs.for_cache(cache).step(
            ("spec", gamma, ngram, bufs.group, t_bucket), body,
            carry=bufs.carry())
        if captured:
            self.metrics.add_graph(captures=1)
            self._record_capture(
                "spec_group",
                (bufs.done.shape[0], gamma, ngram, bufs.group, t_bucket),
                time.perf_counter() - t0)
        return step

    def _record_capture(self, kind: str, key: tuple, dur_s: float) -> None:
        """A graph capture as a compile event: ``kind/rows/...`` and its
        wall time, charged to the request in flight."""
        devtel.observer().record_compile(
            signature_str(signature(kind, *key)), dur_s=dur_s,
            req_id=self.devtel_req_id)

    @torch.inference_mode()
    def _decode(self, tokens, cache, cur_pos, sample_args, *, t_bucket=None):
        """One decode step; returns (token [B], logits [B, V]), both the
        step buffers (valid until the next step over this cache)."""
        bufs, step = self._step(
            "plain", cache, sample_args, t_bucket,
            lambda b: b.load(tokens, cur_pos, sample_args))
        step()
        self.metrics.add_graph(replays=1)
        return bufs.tokens, bufs.logits

    @torch.inference_mode()
    def _decode_group(self, tokens, cache, cur_pos, sample_args, done, eos,
                      *, n_steps: int, n_chunks: int = 1, t_bucket=None):
        """``n_chunks`` chunks of ``n_steps`` fused decode steps with EOS /
        poison carried on the device (the reference's grouped program,
        engine.py:496), each step a replay of one step graph. Returns
        ``(packed, last_tok, cur_pos, done)`` where ``packed`` is
        ``[n_chunks*B*n_steps tokens | n_chunks*B poison flags]`` int32,
        chunk-major, the poison flags cumulative and snapshotted after each
        chunk: read by the host in one transfer. The other three are the
        step buffers (valid until the next step over this cache)."""
        bufs, step = self._step(
            "fold", cache, sample_args, t_bucket,
            lambda b: b.load(tokens, cur_pos, sample_args, done, eos))
        out = self._run_group(bufs, step, n_chunks, n_steps)
        self.metrics.add_graph(replays=n_chunks * n_steps)
        return out

    @torch.inference_mode()
    def _run_group(self, bufs: StepBuffers, step, n_chunks: int,
                   n_steps: int):
        """Run ``step`` ``n_chunks * n_steps`` times, gathering each step's
        tokens and each chunk's poison flags into ``packed`` (allocated
        outside the graphs' pool, so no replay overwrites it before the
        host has read it)."""
        B = bufs.tokens.shape[0]
        packed = torch.empty(n_chunks * B * (n_steps + 1), dtype=torch.int32,
                             device=bufs.tokens.device)
        toks = packed[: n_chunks * B * n_steps].view(n_chunks, B, n_steps)
        pois = packed[n_chunks * B * n_steps:].view(n_chunks, B)
        for c in range(n_chunks):
            for s in range(n_steps):
                step()
                toks[c, :, s].copy_(bufs.tokens)
            pois[c].copy_(bufs.poisoned)
        return packed, bufs.tokens, bufs.cur_pos, bufs.done

    @staticmethod
    def _admit_merge(tokens, cur_pos, adm_tok, adm_lens, rows):
        """Fold an admission batch into the device-resident decode state:
        ``tokens[rows] = adm_tok`` and ``cur_pos[rows] = adm_lens``.
        ``rows`` [P] is padded with a positive out-of-range sentinel, whose
        entries are dropped (never wrapped). A one-hot match instead of a
        scatter, so nothing waits on the device. Returns new tensors."""
        R = tokens.shape[0]
        match = rows[None, :] == torch.arange(R, device=rows.device)[:, None]
        hit = match.any(1)

        def put(old, new):
            val = (match * new[None, :].to(old.dtype)).sum(1).to(old.dtype)
            return torch.where(hit, val, old)

        return put(tokens, adm_tok), put(cur_pos, adm_lens)

    @torch.inference_mode()
    def _ragged_step(self, tokens, cache, cur_pos, sample_args, done,
                     poisoned, eos, ids, q_lens, feed, emit):
        """One ragged mixed prefill+decode step (engine.py:549): every row
        carries a CB-token chunk, ``q_lens`` live. Decode rows (q_len 1,
        ``feed`` False) take the carried token as input and reduce exactly
        to a decode step; prompt rows feed their slice and emit nothing
        until the step that completes the prompt (``emit``), whose sample,
        at counter ``cur_pos + q_len`` (the prompt length), is the first
        token."""
        CB = ids.shape[1]
        ids = ids.clone()
        ids[:, 0] = torch.where(feed, ids[:, 0], tokens)
        rel = torch.arange(CB, dtype=torch.int32, device=ids.device)
        positions = cur_pos[:, None] + rel[None, :]
        live = (rel[None, :] < q_lens[:, None]) & ~done[:, None]
        # Dead columns (chunk padding, done rows) write nowhere.
        slots = torch.where(live, positions % cache.max_len, cache.max_len)
        kv_pos = torch.where(live, positions, -1)
        logits, _ = forward_ragged(
            self.cfg, self.params, ids, positions, cache, slots, q_lens,
            kv_write_positions=kv_pos, layers=self._layers, mesh=self.mesh,
        )
        tok = sample(logits[:, 0], counters=cur_pos + q_lens, **sample_args)
        tok, done2, poisoned = fold_step_outcome(
            logits[:, 0], tok, done, poisoned, eos
        )
        # Mid-prompt rows keep their carried token and done state; poison
        # is cumulative regardless.
        tok = torch.where(emit, tok, tokens)
        done = torch.where(emit, done2, done)
        return tok, cur_pos + q_lens, done, poisoned

    @torch.inference_mode()
    def _ragged_group(self, tokens, cache, cur_pos, sample_args, done, eos,
                      ids_seq, qlens_seq, feed_seq, emit_seq):
        """``nc`` ragged steps (engine.py:598): ``ids_seq`` [nc, B, CB],
        the others [nc, B], planned by the host. Returns ``(packed,
        last_tok, cur_pos, done)`` with ``packed`` = ``[nc*B tokens | nc*B
        cumulative poison flags]``, the decode group's layout at
        ``n_steps == 1``."""
        poisoned = torch.zeros_like(done)
        toks, pois = [], []
        for s in range(ids_seq.shape[0]):
            tokens, cur_pos, done, poisoned = self._ragged_step(
                tokens, cache, cur_pos, sample_args, done, poisoned, eos,
                ids_seq[s], qlens_seq[s], feed_seq[s], emit_seq[s],
            )
            toks.append(tokens)
            pois.append(poisoned.to(torch.int32))
        packed = torch.cat(toks + pois)
        return packed, tokens, cur_pos, done

    def devtel_cost_model(self) -> devtel.EngineCostModel:
        """The analytical roofline model of this engine (built once)."""
        if self._devtel_model is None:
            count, nbytes = devtel.param_stats(self.params)
            self._devtel_model = devtel.EngineCostModel(
                self.cfg, count, nbytes,
                kv_itemsize=torch.empty((), dtype=self._cache_dtype)
                .element_size(),
                max_seq_len=self.max_seq_len)
        return self._devtel_model

    def devtel_cost(self, kind: str, key: tuple, *, batch: int, steps: int,
                    kv_len: int | None, prefill_tokens: int = 0
                    ) -> devtel.KernelCost | None:
        """The cost of one step signature ``(kind, *key)`` from the process
        cost table: a hit on the fold path, else priced by the analytical
        model. ``key`` must be the same at prewarm and at the fold site."""
        full_key = signature(kind, *key)
        hit = devtel.costs().get(full_key)
        if hit is not None:
            return hit
        return devtel.costs().derive(
            full_key, self.devtel_cost_model().step_cost(
                batch, steps, kv_len, prefill_tokens))

    def timed_prefill(self, ids, cache, lens, sample_args, *, batch: int,
                      start=None):
        """Run the prefill, recording prefill latency, TTFT and requests."""
        t0 = time.perf_counter()
        with self.metrics.prefill.time():
            out = self._prefill(ids, cache, lens, sample_args, start)
            _sync(self.device)
        self.metrics.ttft.record(time.perf_counter() - t0)
        self.metrics.add_request(batch)
        return out

    # -- shared prefixes --------------------------------------------------------

    @torch.inference_mode()
    def seed_cache(self, cache, prefix: Prefix) -> None:
        """Write ``prefix``'s bucket-padded segment into logical slots
        ``[0, Pb)`` of every row of ``cache``, in place (engine.py:261):
        slots below the prefix length record their positions, pad slots
        stay at -1, so no step attends them. A paged cache is written
        through the tables it carries, and a sentinel entry drops the write:
        the batcher seeds through tables whose shared columns are the
        sentinel, so only the partial tail lands, in each row's first owned
        block. Rows that serve other work overwrite the seed with their own
        prefill."""
        Pb = prefix.k.shape[1]
        B = cache.positions.shape[0]
        dev = cache.positions.device
        rel = torch.arange(Pb, dtype=torch.int32, device=dev)
        cache.positions[:, :Pb] = torch.where(rel < prefix.length, rel, -1)
        segs = ((cache.k, prefix.k), (cache.v, prefix.v),
                (cache.k_scale, prefix.k_scale),
                (cache.v_scale, prefix.v_scale))
        if isinstance(cache, PagedKVCache):
            slots = rel[None, :].expand(B, Pb)
            for pool, seg in segs:
                if pool is not None:
                    # The stored bits, scales included: nothing re-quantized.
                    rows = seg[:, None].expand((seg.shape[0], B)
                                               + tuple(seg.shape[1:]))
                    paged_write_stacked(pool, rows, cache.block_tables, slots,
                                        cache.block_size)
            return
        for buf, seg in segs:
            if buf is not None:
                buf[:, :, :Pb] = seg[:, None]

    def build_prefix(self, token_ids: list[int]) -> Prefix:
        """Prefill ``token_ids`` once and keep the KV for later requests
        that start with them (engine.py:319). The segment keeps the prefill
        bucket's padded length ``Pb`` (pad slots carry no positions); an
        int8 engine keeps it quantized. On a paged engine the row's identity
        table maps slot ``s`` to block ``s // bs``: its first
        ``ceil(Pb / bs)`` blocks unfold into the dense segment. On a mesh
        every rank calls it (a prefill), and the segment holds the rank's
        KV heads."""
        self._mesh_check("a shared prefix", AXIS_SP)
        P = len(token_ids)
        if not 0 < P < self.max_seq_len:
            raise ValueError(
                f"prefix length {P} must be in (0, {self.max_seq_len})"
            )
        cache = self.new_cache(1)
        ids, lens = self._pad_prompts([list(token_ids)])
        Pb = ids.shape[1]
        self._prefill(torch.as_tensor(ids, device=self.device), cache,
                      torch.as_tensor(lens, device=self.device),
                      self._sample_args(GenerationParams(), 1))

        def seg(buf):
            if buf is None:
                return None
            if isinstance(cache, PagedKVCache):
                nb = -(-Pb // cache.block_size)
                v = buf[:, :nb]
                return v.reshape((v.shape[0], nb * cache.block_size)
                                 + tuple(v.shape[3:]))[:, :Pb].clone()
            return buf[:, 0, :Pb].clone()

        return Prefix(tokens=tuple(int(t) for t in token_ids),
                      k=seg(cache.k), v=seg(cache.v),
                      k_scale=seg(cache.k_scale), v_scale=seg(cache.v_scale))

    @staticmethod
    def split_prefix(
        prompts: list[list[int]], prefix: Prefix
    ) -> tuple[np.ndarray, list[list[int]]]:
        """Check that every prompt extends ``prefix`` by at least one token
        (the suffix prefill gives the first logits) and return (full
        lengths, suffixes)."""
        P = prefix.length
        suffixes = []
        for p in prompts:
            if len(p) <= P or tuple(p[:P]) != prefix.tokens:
                raise ValueError(
                    "prompt does not extend the prefix (needs the prefix's "
                    f"{P} tokens plus at least one more)"
                )
            suffixes.append(list(p[P:]))
        return np.asarray([len(p) for p in prompts], np.int32), suffixes

    # -- host API ---------------------------------------------------------------

    def generate(self, prompts: list[list[int]],
                 gen: GenerationParams | list[GenerationParams], *,
                 on_token=None, on_increment=None, on_poisoned=None,
                 cancel_poll=None, chunk_steps: int = 1,
                 live_rows: int | None = None,
                 prefix: Prefix | None = None) -> list[list[int]]:
        """Streaming host-loop generation (``_generate``). On a mesh whose
        dp axis splits the batch, this rank runs its rows (the callbacks
        see their batch row numbers; ``on_token`` this rank's tokens) and
        the tokens are all-gathered over dp: every rank returns the whole
        batch."""
        if prefix is not None:
            self._mesh_check("a shared prefix", AXIS_SP)
        rows = self._dp_rows(len(prompts))
        if rows is None:
            return self._generate(
                prompts, gen, on_token=on_token, on_increment=on_increment,
                on_poisoned=on_poisoned, cancel_poll=cancel_poll,
                chunk_steps=chunk_steps, live_rows=live_rows, prefix=prefix)
        lo, hi = rows
        gens = gen if isinstance(gen, list) else [gen] * len(prompts)

        def shifted(cb):
            return None if cb is None else (lambda i, *a: cb(i + lo, *a))

        def local_cancel():
            return [i - lo for i in cancel_poll() if lo <= i < hi]

        out = self._generate(
            prompts[lo:hi], gens[lo:hi], on_token=on_token,
            on_increment=shifted(on_increment),
            on_poisoned=shifted(on_poisoned),
            cancel_poll=None if cancel_poll is None else local_cancel,
            chunk_steps=chunk_steps,
            live_rows=None if live_rows is None else
            max(0, min(live_rows, hi) - lo), prefix=prefix)
        return self._gather_rows(out)

    def _generate(
        self,
        prompts: list[list[int]],
        gen: GenerationParams | list[GenerationParams],
        *,
        on_token=None,
        on_increment=None,
        on_poisoned=None,
        cancel_poll=None,
        chunk_steps: int = 1,
        live_rows: int | None = None,
        prefix: Prefix | None = None,
    ) -> list[list[int]]:
        """Streaming host-loop generation.

        ``prefix`` (``build_prefix``): every prompt must extend it; the
        rows are seeded from it and only the suffixes are prefilled, with
        the tokens of a prefill from scratch (int8: the seeded bits are the
        same on every reuse, the tokens may differ from scratch). A batch
        whose bucket-padded suffix would reach past the ring is prefilled
        from scratch instead, as the reference does (engine.py:1087).

        ``gen`` may hold one entry per prompt (mixed greedy / sampled rows,
        lengths and EOS ids). ``on_token(step, tokens)`` sees each step's
        raw batch tokens; ``on_increment(row, new_tokens)`` only tokens
        accepted into a row's output, once per host round-trip;
        ``on_poisoned(row)`` fires when a row's logits went non-finite
        (``chunk_steps > 1``); ``cancel_poll() -> iterable[int]`` names rows
        to stop. ``chunk_steps > 1`` runs that many fused steps per host
        round-trip (identical tokens, coarser callbacks). ``live_rows``
        counts the leading real rows when the caller padded the batch.
        """
        if chunk_steps < 1:
            raise ValueError(f"chunk_steps must be >= 1, got {chunk_steps}")
        B = len(prompts)
        gens = gen if isinstance(gen, list) else [gen] * B
        if len(gens) != B:
            raise ValueError(f"{len(gens)} GenerationParams for {B} prompts")
        for g in gens:
            g.validate()
        dev = self.device
        cache = self._generate_cache(B)
        sample_args = self._sample_args(gens, B)
        if prefix is not None:
            full_lens, suffixes = self.split_prefix(prompts, prefix)
            if int(full_lens.max()) > self.max_seq_len:
                raise ValueError(
                    f"prompt length {int(full_lens.max())} exceeds "
                    f"max_seq_len {self.max_seq_len}"
                )
            ids, suf_lens = self._pad_prompts(suffixes)
            if prefix.length + ids.shape[1] > self.max_seq_len:
                # The padded columns' slots would wrap onto the seeded ones.
                prefix = None
        if prefix is not None:
            self.seed_cache(cache, prefix)
            tok, _ = self.timed_prefill(
                torch.as_tensor(ids, device=dev), cache,
                torch.as_tensor(suf_lens, device=dev), sample_args,
                batch=live_rows or B,
                start=torch.full((B,), prefix.length, dtype=torch.int32,
                                 device=dev),
            )
            lens = full_lens
        else:
            ids, lens = self._pad_prompts(prompts)
            tok, _ = self.timed_prefill(
                torch.as_tensor(ids, device=dev), cache,
                torch.as_tensor(lens, device=dev), sample_args,
                batch=live_rows or B,
            )
        eos = np.asarray(
            [g.eos_token_id if g.eos_token_id is not None else -1
             for g in gens]
        )
        max_new = np.asarray([g.max_new_tokens for g in gens])
        out = [[] for _ in range(B)]
        done = np.zeros(B, bool)
        cur_pos = torch.as_tensor(lens, device=dev)
        pos_hi = int(lens.max())
        total_steps = int(max_new.max())
        eos_dev = torch.as_tensor(eos, dtype=torch.int32, device=dev)
        step = 0
        inc_buf: list[list[int]] = [[] for _ in range(B)]

        def flush_increments() -> None:
            if on_increment is None:
                return
            for i in range(B):
                if inc_buf[i]:
                    on_increment(i, inc_buf[i])
                    inc_buf[i] = []

        def process(tok_np) -> bool:
            """Account one step's tokens; True when all rows are done."""
            nonlocal step
            newly_done = (tok_np == eos) | (step >= max_new)
            for i in range(B):
                if not done[i] and not newly_done[i]:
                    out[i].append(int(tok_np[i]))
                    if on_increment is not None:
                        inc_buf[i].append(int(tok_np[i]))
                    if len(out[i]) == max_new[i]:
                        done[i] = True
            done[:] = done | newly_done
            if on_token is not None:
                on_token(step, tok_np)
            step += 1
            return bool(done.all())

        process(tok.cpu().numpy())
        flush_increments()
        while not done.all() and step < total_steps:
            if cancel_poll is not None:
                for i in cancel_poll():
                    done[i] = True
                if done.all():
                    break
            k = chunk_steps
            if k == 1:
                with self.metrics.decode_step.time():
                    tok, _ = self._decode(
                        tok, cache, cur_pos, sample_args,
                        t_bucket=self.decode_bucket(pos_hi + 1),
                    )
                    tok_np = tok.cpu().numpy()  # the per-step fetch
                cur_pos = cur_pos + 1
                pos_hi += 1
                process(tok_np)
                flush_increments()
            else:
                # Always a full chunk: overshoot columns are discarded by
                # process() once every row has reached its max_new.
                t0 = time.perf_counter()
                packed, tok, cur_pos, _ = self._decode_group(
                    tok, cache, cur_pos, sample_args,
                    to_device(done, dev), eos_dev,
                    n_steps=k, t_bucket=self.decode_bucket(pos_hi + k),
                )
                tb = self.decode_bucket(pos_hi + k)
                pos_hi += k
                flat = packed.cpu().numpy()  # ONE fetch per chunk
                t1 = time.perf_counter()
                self.metrics.decode_step.record((t1 - t0) / k)
                if devtel.enabled():
                    # Dispatch to fetch covers the whole chunk: the fold
                    # prices the k-step signature.
                    devtel.fold("decode_group", t1 - t0, self.devtel_cost(
                        "decode_group", (B, 1, k, tb), batch=B, steps=k,
                        kv_len=tb))
                chunk_np = flat[: B * k].reshape(B, k)
                poisoned_np = flat[B * k:].astype(bool)
                for col in range(k):
                    if process(chunk_np[:, col]):
                        break
                # Poisoned rows were forced done on the device; surface the
                # flag so the caller errors the row.
                for i in range(B):
                    if poisoned_np[i] and not done[i]:
                        done[i] = True
                if on_poisoned is not None:
                    for i in np.flatnonzero(poisoned_np):
                        on_poisoned(int(i))
                flush_increments()
        self.metrics.add_tokens(sum(len(o) for o in out[: live_rows or B]))
        return out

    def generate_speculative(
        self, prompts: list[list[int]], gen: GenerationParams, *,
        gamma: int = 4, ngram: int = spec.NGRAM,
        chunk_steps: int = spec.CHUNK_STEPS,
    ) -> list[list[int]]:
        """Greedy generation with prompt-lookup speculative decoding
        (engine.py:1255): ``generate``'s tokens under the verify forward's
        numerics, 1 to gamma + 1 of them per forward, ``chunk_steps``
        forwards per host round-trip (engine/speculative.py). Sampled
        requests are refused."""
        self._mesh_check("generate_speculative")
        return spec.generate_speculative(
            self, prompts, gen, gamma=gamma, ngram=ngram,
            chunk_steps=chunk_steps)

    @torch.inference_mode()
    def generate_fused(
        self, prompts: list[list[int]], gen: GenerationParams
    ) -> list[list[int]]:
        """The whole generation on the device (engine.py:1268): the
        prefill, ``max_new_tokens - 1`` step replays with no host read
        between them, then ONE fetch, each row trimmed at its first EOS. On
        a mesh whose dp axis splits the batch, this rank's rows, then the
        tokens all-gathered over dp."""
        rows = self._dp_rows(len(prompts))
        if rows is not None:
            return self._gather_rows(
                self._generate_fused(prompts[rows[0]:rows[1]], gen))
        return self._generate_fused(prompts, gen)

    def _generate_fused(self, prompts: list[list[int]],
                        gen: GenerationParams) -> list[list[int]]:
        gen.validate()
        B = len(prompts)
        dev = self.device
        ids, lens = self._pad_prompts(prompts)
        cache = self._generate_cache(B)
        sample_args = self._sample_args(gen, B)
        lens_d = torch.as_tensor(lens, device=dev)
        tok, _ = self.timed_prefill(
            torch.as_tensor(ids, device=dev), cache, lens_d, sample_args,
            batch=B,
        )
        eos = gen.eos_token_id if gen.eos_token_id is not None else -1
        eos_dev = torch.full((B,), eos, dtype=torch.int32, device=dev)
        n_steps = gen.max_new_tokens - 1
        rows = tok[:, None]
        if n_steps:
            packed, _, _, _ = self._decode_group(
                tok, cache, lens_d, sample_args, tok == eos_dev, eos_dev,
                n_steps=n_steps,
                t_bucket=self.decode_bucket(int(lens.max()) + n_steps),
            )
            rows = torch.cat([rows, packed[: B * n_steps].view(B, n_steps)], 1)
        out = []
        for row in rows.cpu().numpy():  # the one fetch
            stop = np.flatnonzero(row == eos)
            out.append(row[: stop[0]].tolist() if stop.size else row.tolist())
        self.metrics.add_tokens(sum(len(o) for o in out))
        return out

    @torch.inference_mode()
    def prewarm(
        self, batch: int, *, chunk_steps: tuple[int, ...] | int = (),
        buckets: bool = True, prefix_prefill: bool = False,
        speculative: tuple[int, ...] | int = (),
    ) -> int:
        """Warm everything ``generate`` / ``generate_fused`` can run at
        ``batch`` rows (engine.py:762): a prefill for each seq bucket, then
        every decode step graph the live path can pick over the persistent
        cache, the single step and, when a ``chunk_steps`` entry is above
        1, the grouped step, each at every cache-read bucket (``buckets``)
        and every sampling variant. Drains the device, leaves the cache
        reset, and returns the number of programs warmed: seq buckets +
        step kinds x buckets x sampling variants (captured now or
        before). ``prefix_prefill`` is the reference's flag for the
        prefix-offset prefill programs; the port's prefill runs eagerly and
        the decode step graphs do not depend on a prefix, so it warms
        nothing more. ``speculative`` (gammas) adds what
        ``generate_speculative(gamma=)`` runs with its default ``ngram``
        and ``chunk_steps``: its step graph at every bucket, and the
        greedy grouped step of its plain tail. With devtel on it also
        prices every signature it warms, and marks the steady state at the
        end: a capture after it, outside a prewarm, is a steady-state
        recompile."""
        if isinstance(chunk_steps, int):
            chunk_steps = (chunk_steps,)
        if isinstance(speculative, int):
            speculative = (speculative,)
        if speculative:
            self._mesh_check("generate_speculative")
        batch = self._local_batch(batch)
        with devtel.observer().warming():
            n = self._prewarm(batch, chunk_steps, buckets, speculative)
        if devtel.enabled():
            devtel.observer().mark_steady()
        return n

    def _prewarm(self, batch: int, chunk_steps: tuple[int, ...],
                 buckets: bool, speculative: tuple[int, ...]) -> int:
        dt = devtel.enabled()
        dev = self.device
        cache = self._generate_cache(batch)
        n = 0
        for S in self.seq_buckets():
            sa = self._sample_args(GenerationParams(), batch)
            if dt:
                self.devtel_cost("prefill", (batch, S), batch=batch, steps=1,
                                 kv_len=S, prefill_tokens=batch * (S - 1))
            tok, _ = self._prefill(
                torch.zeros((batch, S), dtype=torch.int32, device=dev), cache,
                torch.ones(batch, dtype=torch.int32, device=dev), sa,
            )
            n += 1
        kinds = ["plain"] + (["fold"] if any(k > 1 for k in chunk_steps)
                             or speculative else [])
        cur = torch.ones(batch, dtype=torch.int32, device=dev)
        done = torch.zeros(batch, dtype=torch.bool, device=dev)
        eos = torch.full((batch,), -1, dtype=torch.int32, device=dev)
        if dt:
            for tb in self.prewarm_bucket_set() if buckets else [None]:
                self.devtel_cost("decode", (batch, tb), batch=batch, steps=1,
                                 kv_len=tb)
                for k in chunk_steps:
                    if k > 1:
                        self.devtel_cost("decode_group", (batch, 1, k, tb),
                                         batch=batch, steps=k, kv_len=tb)
        for variant in SAMPLING_VARIANTS:
            sa = self._sample_args(variant_params(*variant), batch)
            for tb in self.prewarm_bucket_set() if buckets else [None]:
                for kind in kinds:
                    if kind == "plain":
                        self._decode(tok, cache, cur, sa, t_bucket=tb)
                    else:
                        self._decode_group(tok, cache, cur, sa, done, eos,
                                           n_steps=1, t_bucket=tb)
                    n += 1
        g = self._graphs.for_cache(cache)
        for gamma in speculative:
            bufs = g.spec_buffers(gamma + 1, spec.CHUNK_STEPS,
                                  self.max_seq_len)
            bufs.hist_len.fill_(1)
            bufs.done.zero_()
            for tb in self.prewarm_bucket_set() if buckets else [None]:
                bufs.step.zero_()
                self._spec_step(cache, bufs, gamma, spec.NGRAM, tb)
                n += 1
        self._generate_cache(batch)
        _sync(dev)
        return n


def variant_params(any_sampled: bool, needs_filter: bool) -> GenerationParams:
    """Generation settings whose batch takes the given sampling branch
    flags (``DecodeEngine._sample_args``)."""
    if not any_sampled:
        return GenerationParams()
    return GenerationParams(is_greedy=False, top_k=40 if needs_filter else 0)
