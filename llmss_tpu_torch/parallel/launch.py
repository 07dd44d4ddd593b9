"""A world of ranks in one host, and the engine job each rank runs.

``spawn(fn, world, *args, init_method=...)`` (or ``World``, to run
several at once) starts ``world`` processes
(the ``spawn`` start method, so a parent that holds a CUDA context may
start them), joins each to the process group at ``init_method`` (a
``file://`` path needs no port, so parallel test workers never race for
one), runs ``fn(*args)`` on every rank and returns the ranks' results in
rank order. A rank that raises fails the whole world: the others are
stopped and the rank's traceback is raised here.

``engine_job(job)`` is what the tests and ``chip_smoke.py`` run on each
rank: a ``DecodeEngine`` on the job's mesh over the rank's shard of the
job's parameters (given, or drawn on the rank's device from a seed, every
rank the same, then sliced), its generations, and the prefill's logits.
``serve_job(job)`` serves on such a mesh (parallel/serving.py): rank 0
leads a ``ContinuousBatcher`` through a schedule of submissions and
cancels, or a ``ContinuousWorker`` over a broker in its own process, and
the other ranks follow; every rank returns what its rows delivered, its
pool's blocks, its digests and its kernel launches.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from llmss_tpu_torch.parallel.mesh import MeshPlan, initialize_runtime


def _child(fn, rank, world, init_method, backend, device, q, args):
    torch.set_num_threads(1)
    try:
        initialize_runtime(init_method, world, rank, backend=backend,
                           device=device)
        q.put((rank, True, fn(*args)))
    except Exception:  # noqa: BLE001 -- the parent raises it
        q.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class World:
    """``world`` new processes running ``fn(*args)``, joined at
    ``init_method``; ``results()`` waits for them. Several worlds may run
    at once, each at its own rendezvous."""

    def __init__(self, fn, world: int, *args, init_method: str,
                 backend: str = "gloo", device="cpu",
                 timeout: float = 600.0):
        ctx = mp.get_context("spawn")
        self.world, self.timeout = world, timeout
        self._q = ctx.Queue()
        self._procs = [ctx.Process(target=_child, daemon=True, args=(
            fn, rank, world, init_method, backend, str(device), self._q,
            args)) for rank in range(world)]
        for p in self._procs:
            p.start()
        self._deadline = time.monotonic() + timeout

    def results(self) -> list:
        """The ranks' results in rank order; raises (and stops every rank)
        when one fails, dies or the time runs out."""
        results: dict[int, object] = {}
        try:
            while len(results) < self.world:
                left = self._deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"world of {self.world} did not finish in "
                        f"{self.timeout} s (ranks done: {sorted(results)})")
                try:
                    rank, ok, val = self._q.get(timeout=min(left, 5.0))
                except queue.Empty:
                    dead = [i for i, p in enumerate(self._procs)
                            if p.exitcode not in (None, 0)
                            and i not in results]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{self._procs[dead[0]].exitcode}") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{val}")
                results[rank] = val
            for p in self._procs:
                p.join(timeout=max(1.0, self._deadline - time.monotonic()))
        finally:
            for p in self._procs:
                if p.is_alive():
                    p.terminate()
                    p.join(5)
        return [results[r] for r in range(self.world)]


def spawn(fn, world: int, *args, init_method: str, backend: str = "gloo",
          device="cpu", timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` on ``world`` new processes joined at
    ``init_method``; the ranks' results in rank order."""
    return World(fn, world, *args, init_method=init_method, backend=backend,
                 device=device, timeout=timeout).results()


def file_init(path) -> str:
    """A ``file://`` rendezvous at ``path`` (removed first: a file left
    by an earlier world would confuse the next)."""
    path = os.path.abspath(path)
    if os.path.exists(path):
        os.remove(path)
    return "file://" + path


@dataclasses.dataclass
class EngineJob:
    """One rank's work: ``plan`` (dp, sp, tp); ``params`` the full
    parameters (CPU tensors), or ``seed`` to draw them on the device;
    ``runs``: ``("generate", gens, chunk_steps)`` or ``("fused", gen)``
    tuples over ``prompts``."""

    cfg: object
    plan: tuple[int, int, int]
    prompts: list
    runs: list
    params: dict | None = None
    seed: int = 0
    device: str = "cpu"
    backend: str = "gloo"
    max_seq_len: int = 64
    kv_dtype: str | None = None
    prewarm: tuple = ()  # chunk_steps to prewarm, () for none
    logits: bool = True  # return the prefill's first-token logits


def engine_job(job: EngineJob) -> dict:
    """Build the rank's mesh, shard and engine, run ``job.runs``; return
    the tokens, seconds, decode ms per step and TTFT of each run, the
    first run's first-token logits (this rank's rows ``rows``), the graph
    captures (all, and after the prewarm), and the rank's kernel launches,
    host staging and collectives issued over the runs."""
    from llmss_tpu_torch.engine.engine import DecodeEngine
    from llmss_tpu_torch.engine.metrics import EngineMetrics
    from llmss_tpu_torch.models.decoder import init_params
    from llmss_tpu_torch.ops import decode_attention as da
    from llmss_tpu_torch.ops import flash_attention as fa
    from llmss_tpu_torch.parallel.mesh import make_mesh
    from llmss_tpu_torch.parallel.sharding import (
        COLLECTIVES, HOST_STAGING, shard_params,
    )

    mesh = make_mesh(MeshPlan(*job.plan), device=job.device,
                     backend=job.backend)
    dev = mesh.device
    if job.params is not None:
        params = shard_params(_to(job.params, dev), job.cfg, mesh)
    else:  # the seed's draw, each tensor cut to the rank's slice
        params = init_params(job.cfg, seed=job.seed, device=dev, mesh=mesh)
    if dev.type == "cuda":
        torch.cuda.empty_cache()  # the other ranks on the card need it
    eng = DecodeEngine(job.cfg, params, mesh=mesh,
                       max_seq_len=job.max_seq_len, kv_dtype=job.kv_dtype)
    B = len(job.prompts)
    warmed = eng.prewarm(B, chunk_steps=job.prewarm) if job.prewarm else 0
    first_logits = []
    prefill = eng._prefill

    def kept_prefill(*a, **kw):  # the first run's prefill keeps its logits
        tok, logits = prefill(*a, **kw)
        if not first_logits:
            first_logits.append(logits.float().cpu().numpy())
        return tok, logits

    if job.logits:
        eng._prefill = kept_prefill
    warm_captures, after = eng.metrics.graph_captures, 0
    counters = (fa.flash_attention, fa.flash_attention_state,
                da.decode_attention, da.decode_attention_state)
    for fn in counters:
        fn.launches = 0
    HOST_STAGING.update(calls=0, bytes=0)
    COLLECTIVES.update(dict.fromkeys(COLLECTIVES, 0))
    out: dict = {"coords": dict(mesh.coords), "backend": mesh.backend,
                 "warmed": warmed, "runs": [], "seconds": [],
                 "decode_ms": [], "ttft_ms": []}
    for run in job.runs:
        eng.metrics = EngineMetrics()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if run[0] == "generate":
            toks = eng.generate(job.prompts, run[1], chunk_steps=run[2])
        else:
            toks = eng.generate_fused(job.prompts, run[1])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out["seconds"].append(time.perf_counter() - t0)
        out["runs"].append(toks)
        out["decode_ms"].append(eng.metrics.decode_step.to_dict()["mean_ms"])
        out["ttft_ms"].append(eng.metrics.ttft.last_s * 1e3)
        after += eng.metrics.graph_captures
    out["launches"] = {fn.__name__: fn.launches for fn in counters}
    out["host_staging"] = dict(HOST_STAGING)
    out["collectives"] = dict(COLLECTIVES)
    out["captures_after_prewarm"] = after
    out["graph_captures"] = warm_captures + after
    out["weight_bytes"] = sum(
        t.numel() * t.element_size() for t in _leaves(params))
    if job.logits:
        out["rows"] = eng._dp_rows(B) or (0, B)
        out["logits"] = first_logits[0]
    return out


def engine_jobs(jobs: list[EngineJob]) -> list[dict]:
    """``engine_job`` of each job in turn (one world, several meshes)."""
    return [engine_job(job) for job in jobs]


def _to(p, dev):
    if p is None:
        return None
    if isinstance(p, dict):
        return {k: _to(v, dev) for k, v in p.items()}
    if isinstance(p, tuple):
        return type(p)(*(_to(x, dev) for x in p))
    return p.to(dev)


def _leaves(p):
    if p is None:
        return []
    if isinstance(p, dict):
        return [t for v in p.values() for t in _leaves(v)]
    if isinstance(p, tuple):
        return [t for x in p for t in _leaves(x)]
    return [p]


def gather_logits(results: list[dict], batch: int) -> np.ndarray:
    """The whole batch's first-token logits from a world's results (each
    dp rank's rows)."""
    out = None
    for r in results:
        lo, hi = r["rows"]
        if out is None:
            out = np.zeros((batch,) + r["logits"].shape[1:], np.float32)
        out[lo:hi] = r["logits"]
    return out


@dataclasses.dataclass
class ServeJob:
    """One rank's serving on a mesh: ``plan`` (dp, sp, tp); ``params`` the
    full parameters (CPU tensors), or ``seed`` to draw them on the device;
    the engine's settings (``kv_layout`` "paged" or "dense"); ``passes``,
    each a dict of ``batcher`` (the batcher's keyword arguments: rows,
    chunk_steps, group_chunks, chunked_prefill), optionally ``kv_dtype``
    (each KV dtype an engine over the same shard), and either
    ``schedule`` (``run_schedule``'s, through a ``ContinuousBatcher``) or
    ``requests`` (``GenerateRequest``s that a ``ContinuousWorker`` on rank
    0 serves from an ``InProcBroker`` in its process: ``serve_requests``)."""

    cfg: object
    plan: tuple[int, int, int]
    passes: list
    params: dict | None = None
    seed: int = 0
    device: str = "cpu"
    backend: str = "gloo"
    max_seq_len: int = 64
    kv_layout: str = "paged"
    block_size: int = 16
    kv_blocks: int | None = None


def count_steps(eng) -> dict:
    """Wrap ``eng``'s grouped programs to count the decode steps and the
    ragged steps they run; returns the live counts."""
    n = {"decode": 0, "ragged": 0}
    decode_group, ragged_group = eng._decode_group, eng._ragged_group

    def counted_decode(*a, n_steps, n_chunks=1, **kw):
        n["decode"] += n_steps * n_chunks
        return decode_group(*a, n_steps=n_steps, n_chunks=n_chunks, **kw)

    def counted_ragged(*a):
        n["ragged"] += a[6].shape[0]  # ids_seq [nc, B, CB]
        return ragged_group(*a)

    eng._decode_group, eng._ragged_group = counted_decode, counted_ragged
    return n


def run_schedule(bat, schedule, answers: dict) -> None:
    """``schedule`` through the batcher ``bat``: before each step, that
    step's actions, ``("submit", req_id, ids, gen, prefix_tokens or
    None)`` or ``("cancel", req_id)``; then until idle. Fills
    ``answers[req_id]`` with the tokens, whether cancelled and the error.
    A mesh's leader takes a prefix by its tokens (every rank builds it);
    in one process each prefix is built here once."""
    prefixes: dict = {}

    def done(rid):
        def cb(tokens, cancelled=False, error=None):
            answers[rid] = {"tokens": list(tokens), "cancelled": cancelled,
                            "error": error}
        return cb

    for actions in schedule:
        for a in actions:
            if a[0] == "cancel":
                bat.cancel(a[1])
                continue
            _, rid, ids, gen, ptoks = a
            pfx = None if ptoks is None else tuple(ptoks)
            if pfx is not None and bat.control is None:
                if pfx not in prefixes:
                    prefixes[pfx] = bat.engine.build_prefix(list(pfx))
                pfx = prefixes[pfx]
            bat.submit(ids, gen, done(rid), req_id=rid, prefix=pfx)
        bat.step()
    bat.run_until_idle()


def serve_requests(worker, requests: list, answers: dict) -> None:
    """``requests`` through ``worker``, a ``ContinuousWorker`` over an
    ``InProcBroker``: pushed, then ``run_once`` until each is answered and
    the batcher is idle. Fills ``answers`` as ``run_schedule`` does, and
    raises if a request was answered twice."""
    broker = worker.broker
    for r in requests:
        broker.push_request(r)
    while len(answers) < len(requests) or not worker.batcher.idle:
        worker.run_once()
        for r in requests:
            if r.id not in answers:
                a = broker.wait_response(r.id, timeout=0.0)
                if a is not None:
                    answers[r.id] = {"tokens": list(a.token_ids or []),
                                     "cancelled": a.error == "cancelled",
                                     "error": a.error}
    if any(broker.wait_response(r.id, timeout=0.0) is not None
           for r in requests):
        raise AssertionError("a request was answered twice")


def serve_job(job: ServeJob) -> dict:
    """Build the rank's mesh, shard and engine and its ``ServeControl``;
    lead ``job.passes`` on rank 0 and follow them elsewhere. Returns the
    rank's coordinates, weight bytes and, per pass, ``outputs`` (req_id ->
    tokens / cancelled / error: rank 0's answers, the followers' recorded
    rows), paged: ``blocks_idle`` (in use once idle: the registered
    prefixes') and ``blocks_drained`` (after the idle prefixes are
    evicted), ``steps`` / ``checked`` / ``chain`` (the control's digests),
    ``control_ms_per_step`` (the control's host time: broadcast, events
    applied, digest), the K1 / K3 / K4 launches with the decode and
    ragged steps, ``pool_bytes`` (the KV cache's), ``wall_s``,
    ``decode_ms_per_step``, ``ttft_p50_ms``, ``ttft_min_max_ms`` and the
    graph captures."""
    from llmss_tpu_torch.engine.engine import DecodeEngine
    from llmss_tpu_torch.engine.metrics import EngineMetrics
    from llmss_tpu_torch.engine.scheduler import ContinuousBatcher
    from llmss_tpu_torch.models.decoder import init_params
    from llmss_tpu_torch.ops import flash_attention as fa
    from llmss_tpu_torch.ops import paged_attention as pa
    from llmss_tpu_torch.parallel.mesh import make_mesh
    from llmss_tpu_torch.parallel.serving import ServeControl
    from llmss_tpu_torch.parallel.sharding import shard_params
    from llmss_tpu_torch.serve.broker import InProcBroker
    from llmss_tpu_torch.serve.consumer import MAX_PREFIXES, ContinuousWorker

    mesh = make_mesh(MeshPlan(*job.plan), device=job.device,
                     backend=job.backend)
    dev = mesh.device
    paged = job.kv_layout == "paged"
    if job.params is not None:
        params = shard_params(_to(job.params, dev), job.cfg, mesh)
    else:
        params = init_params(job.cfg, seed=job.seed, device=dev, mesh=mesh)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    engines: dict = {}
    steps: dict = {}

    def engine(kv_dtype):
        """The pass's engine (each KV dtype one, over the same shard)."""
        if kv_dtype not in engines:
            engines[kv_dtype] = DecodeEngine(
                job.cfg, params, mesh=mesh, max_seq_len=job.max_seq_len,
                kv_layout=job.kv_layout, block_size=job.block_size,
                kv_blocks=job.kv_blocks, kv_dtype=kv_dtype)
            steps[kv_dtype] = count_steps(engines[kv_dtype])
        return engines[kv_dtype]

    def pass_kv(i):
        return job.passes[i].get("kv_dtype")

    control = ServeControl(engine(pass_kv(0)), keep_outputs=True)
    counters = (fa.flash_attention, pa.paged_decode_attention,
                pa.ragged_paged_attention)
    out: dict = {"coords": dict(mesh.coords), "passes": [],
                 "weight_bytes": sum(t.numel() * t.element_size()
                                     for t in _leaves(params))}
    cur: dict = {}

    def on_mark(ctl, tag: str) -> None:
        """The pass boundaries, on every rank: "pass i" (its engine), then
        "start" (the pass's batcher built), "idle" and "drained"."""
        if tag.startswith("pass"):
            ctl.engine = engine(pass_kv(int(tag.split()[1])))
            return
        bat, eng = ctl.batcher, ctl.engine
        n = steps[pass_kv(len(out["passes"]))]
        if tag == "start":
            for fn in counters:
                fn.launches = 0
            n.update(decode=0, ragged=0)
            eng.metrics = EngineMetrics()
            cur.clear()
            cur.update(t0=time.perf_counter(), steps0=ctl.steps,
                       host0=ctl.host_s)
            _sync(dev)
        elif tag == "idle":
            _sync(dev)
            m = eng.metrics
            cur.update(
                wall_s=time.perf_counter() - cur.pop("t0"),
                blocks_idle=bat.allocator.blocks_in_use if paged else None,
                control_ms_per_step=(ctl.host_s - cur.pop("host0")) * 1e3
                / max(ctl.steps - cur["steps0"], 1),
                launches={"k1": fa.flash_attention.launches,
                          "k3": pa.paged_decode_attention.launches,
                          "k4": pa.ragged_paged_attention.launches},
                decode_steps=n["decode"], ragged_steps=n["ragged"],
                decode_ms_per_step=m.decode_step.to_dict()["mean_ms"],
                ttft_p50_ms=m.ttft.quantile_ms(50),
                ttft_min_max_ms=(m.ttft.quantile_ms(0),
                                 m.ttft.quantile_ms(100)),
                graph_captures=m.graph_captures,
                pool_bytes=sum(t.numel() * t.element_size() for t in (
                    bat.cache.k, bat.cache.v, bat.cache.k_scale,
                    bat.cache.v_scale) if t is not None))
        else:  # "drained"
            cur.update(blocks_drained=(bat.allocator.blocks_in_use if paged
                                       else None),
                       steps=ctl.steps - cur.pop("steps0"),
                       checked=ctl.checked, chain=ctl.chain)
            if ctl.outputs is not None:
                cur["outputs"] = dict(ctl.outputs)
                ctl.outputs.clear()
            out["passes"].append(dict(cur))

    if not control.leader:
        control.follow(on_mark=on_mark)
        return out
    for i, p in enumerate(job.passes):
        answers: dict = {}
        control.mark(f"pass {i}")
        on_mark(control, f"pass {i}")
        if "requests" in p:
            worker = ContinuousWorker(control.engine, InProcBroker(),
                                      poll_timeout_s=0.0, control=control,
                                      **p["batcher"])
        else:
            bat = ContinuousBatcher(control.engine, **p["batcher"])
            control.attach(bat, MAX_PREFIXES)
        control.mark("start")
        on_mark(control, "start")
        if "requests" in p:
            serve_requests(worker, p["requests"], answers)
        else:
            run_schedule(bat, p["schedule"], answers)
        for tag in ("idle", "drained"):
            if tag == "drained" and paged:
                control.evict_idle_prefixes()
            control.mark(tag)
            on_mark(control, tag)
        out["passes"][-1]["outputs"] = answers
        worker = bat = None
    control.stop()
    return out


def run_jobs(jobs: list) -> list[dict]:
    """Each job in turn (one world, several meshes): ``serve_job`` of a
    ``ServeJob``, ``engine_job`` of an ``EngineJob``."""
    return [serve_job(j) if isinstance(j, ServeJob) else engine_job(j)
            for j in jobs]


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
