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
