"""Captured one-step decode graphs: the port's form of ``jax.jit`` with
donated carries (counterpart: llmss_tpu/engine/engine.py:191-226) and of
the steady-state compile guard (llmss_tpu/analysis/compile_guard.py).

The reference compiles each decode program once and donates its carries,
so a decode step costs the host one dispatch. Run eagerly, one step of the
port costs the host one Python launch per operation. Here each decode step
is captured once as a CUDA graph over persistent buffers and replayed:

- **Static buffers** (``StepBuffers``), one set per cache: the step's
  inputs (tokens, cur_pos, done, eos and the five sampling tensors) and its
  carry. The host fills them with ``copy_`` before a run of steps, outside
  the graph; the graph reads the carry (tokens, cur_pos, done, poisoned)
  and writes it back in place, as donation does, so ``n`` replays are ``n``
  steps. The cache is read and written in place at fixed addresses.
- **Key**: the cache's layout and the identity and shape of its tensors
  (which fix the rows), the step's kind, ``t_bucket`` and the two
  sampling branch flags. Everything else the step does is fixed by them.
- **Capture**: one eager run of the body on a side stream (it builds and
  loads the kernels' libraries and cuBLAS's handles, which must not happen
  during capture), then ``torch.cuda.CUDAGraph`` into one memory pool that
  every live graph of the engine shares (a new one once they have all been
  freed). The warm-up really runs the step, so
  the carry is restored after it; its one KV write goes to the slot the
  step itself writes next, which every decode read excludes as pending.
  A capture that fails raises: nothing carries on eagerly on the card.
- **Launch counters**: the kernel wrappers count at call time, which a
  replay does not repeat. At capture the graph's kernel nodes are read
  back by symbol (libcuda); each wrapper's count of them must equal the
  calls its Python side counted (taken back: a capture launches nothing),
  and every replay adds the counts read from the graph.
- **Lifetime**: a cache's buffers and graphs live while its tensors do;
  the first of them to be freed releases the lot.
- **On the CPU** a capture only records its key, and a replay runs the
  same body over the same static buffers.

A capture after a prewarm (``EngineMetrics.graph_captures``) is the
port's steady-state recompile.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Callable

import torch

# The (any_sampled, needs_filter) pairs a batch can take: all greedy;
# sampled without top-k / top-p; sampled with either.
SAMPLING_VARIANTS = ((False, False), (True, False), (True, True))

# The symbols of the kernels each wrapper launches once per call (a split
# lane call, and every decode call on the tile, adds a ``split_merge``,
# which is not counted). K3 and K4 share the paged kernels; a step graph
# holds K3 only. A symbol names every instantiation of its template:
# ``paged_mma`` is the tensor-core tile over a bf16 pool and over an int8
# one, K4's chunks and the decode form K3 takes above G_TILE query heads
# per KV head; ``decode_mma`` K2's tile over either cache; ``paged_fwd`` /
# ``decode_fwd`` the lane templates over either cache.
KERNEL_SYMBOLS = {
    "flash_attention": ("flash_fwd", "flash_mma"),
    "decode_attention": ("decode_fwd", "decode_mma"),
    "paged_decode_attention": ("paged_fwd", "paged_mma"),
    "ragged_paged_attention": ("paged_fwd", "paged_mma"),
}


def launch_counters() -> tuple:
    """The kernel wrappers whose ``launches`` a graph must keep counting."""
    from llmss_tpu_torch.ops import decode_attention as da
    from llmss_tpu_torch.ops import flash_attention as fa
    from llmss_tpu_torch.ops import paged_attention as pa

    return (fa.flash_attention, da.decode_attention,
            pa.paged_decode_attention, pa.ragged_paged_attention)


def counted_capture(capture: Callable[[], None]) -> list[tuple]:
    """Run ``capture`` and return the ``(wrapper, count)`` launches its
    Python side counted; the counters are set back, since a capture
    launches nothing."""
    before = [(fn, fn.launches) for fn in launch_counters()]
    capture()
    deltas = [(fn, fn.launches - n) for fn, n in before]
    for fn, n in before:
        fn.launches = n
    return [(fn, d) for fn, d in deltas if d]


def node_launches(names: list[str], counted: list[tuple]) -> list[tuple]:
    """``(wrapper, n)``: ``n`` the kernel nodes of a graph (``names``, their
    symbols) that are the wrapper's kernel. Raises unless it equals the
    calls counted at capture."""
    out = []
    for fn, calls in counted:
        syms = KERNEL_SYMBOLS[fn.__name__]
        n = sum(1 for name in names if any(s in name for s in syms))
        if n != calls:
            raise RuntimeError(
                f"captured step graph holds {n} {fn.__name__} kernels, "
                f"its capture called the wrapper {calls} times")
        out.append((fn, n))
    return out


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 (cuda.h)."""

    _fields_ = [("func", ctypes.c_void_p)] + [
        (f, ctypes.c_uint) for f in (
            "gridDimX", "gridDimY", "gridDimZ", "blockDimX", "blockDimY",
            "blockDimZ", "sharedMemBytes")
    ] + [("kernelParams", ctypes.c_void_p), ("extra", ctypes.c_void_p),
         ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def kernel_node_names(graph: torch.cuda.CUDAGraph) -> list[str]:
    """The symbol of every kernel node of a captured graph (built with
    ``keep_graph=True``), read with libcuda."""
    cu = ctypes.CDLL("libcuda.so.1")

    def check(rc, what):
        if rc:
            raise RuntimeError(f"{what} failed: CUresult {rc}")

    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    names = []
    for node in nodes:
        node = ctypes.c_void_p(node)
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)),
              "cuGraphNodeGetType")
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        p = _KernelNodeParams()
        check(cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(p)),
              "cuGraphKernelNodeGetParams")
        # A node whose symbol cannot be read counts as no wrapper's kernel
        # (``node_launches`` then finds the wrapper's kernels missing).
        name = ctypes.c_char_p()
        if p.func:
            rc = cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(p.func))
        else:
            rc = cu.cuKernelGetName(ctypes.byref(name),
                                    ctypes.c_void_p(p.kern))
        names.append(name.value.decode() if rc == 0 and name.value else "")
    return names


class CapturedStep:
    """One captured step: ``__call__`` replays ``graph`` and counts the
    kernel launches read from it."""

    def __init__(self, graph, launches: list[tuple]):
        self.graph = graph
        self._launches = launches

    def __call__(self) -> None:
        self.graph.replay()
        for fn, n in self._launches:
            fn.launches += n


class StepBuffers:
    """The static inputs and in-place carry of one cache's decode steps,
    plus the last step's logits (the single-step ``_decode`` returns
    them)."""

    CARRY = ("tokens", "cur_pos", "done", "poisoned")

    def __init__(self, rows: int, vocab: int, device: torch.device):
        # Normal tensors, so both inference-mode and plain code can update
        # them in place.
        with torch.inference_mode(False):
            def vec(dtype):
                return torch.zeros(rows, dtype=dtype, device=device)

            self.tokens = vec(torch.int32)
            self.cur_pos = vec(torch.int32)
            self.done = vec(torch.bool)
            self.poisoned = vec(torch.bool)
            self.eos = vec(torch.int32)
            self.seeds = vec(torch.int32)
            self.temperature = vec(torch.float32)
            self.top_k = vec(torch.int32)
            self.top_p = vec(torch.float32)
            self.greedy = vec(torch.bool)
            self.logits = torch.zeros(rows, vocab, dtype=torch.float32,
                                      device=device)

    def load(self, tokens, cur_pos, sample_args: dict, done=None,
             eos=None) -> None:
        """Copy a run's inputs in (device to device, no host sync); the
        poison flags start clear. Without ``done`` / ``eos`` every row is
        live and has no EOS."""
        self.tokens.copy_(tokens)
        self.cur_pos.copy_(cur_pos)
        for name in ("seeds", "temperature", "top_k", "top_p", "greedy"):
            getattr(self, name).copy_(sample_args[name])
        if done is None:
            self.done.zero_()
        else:
            self.done.copy_(done)
        if eos is None:
            self.eos.fill_(-1)
        else:
            self.eos.copy_(eos)
        self.poisoned.zero_()

    def sample_args(self, any_sampled: bool, needs_filter: bool) -> dict:
        return dict(seeds=self.seeds, temperature=self.temperature,
                    top_k=self.top_k, top_p=self.top_p, greedy=self.greedy,
                    any_sampled=any_sampled, needs_filter=needs_filter)

    def carry(self) -> list[torch.Tensor]:
        return [getattr(self, n) for n in self.CARRY]


def cache_tensors(cache) -> list[torch.Tensor]:
    """Every tensor of a cache: its fields, but for the int8 scales a cache
    of the compute dtype leaves None."""
    return [t for t in cache if t is not None]


def cache_key(cache) -> tuple:
    """The layout and the identity and shape of every tensor of a cache
    (scales included): a graph reads and writes exactly these
    addresses."""
    return (type(cache).__name__,) + tuple(
        (t.data_ptr(), tuple(t.shape)) for t in cache_tensors(cache))


class CacheGraphs:
    """One cache's step buffers and its captured steps, by step key."""

    def __init__(self, graphs: "DecodeGraphs", key: tuple, bufs: StepBuffers):
        self._graphs = graphs
        self.key = key
        self.bufs = bufs
        self.steps: dict[tuple, CapturedStep | None] = {}

    def step(self, key: tuple, body: Callable[[], None]
             ) -> tuple[Callable[[], None], bool]:
        """``(replay, captured)``: the replay of ``body`` (one step over
        ``bufs`` and the cache, its inputs already loaded) under ``key``,
        and whether this call captured it. On the CPU the replay is
        ``body`` itself."""
        captured = key not in self.steps
        if captured:
            self.steps[key] = self._graphs._capture(body, self.bufs)
        return self.steps[key] or body, captured


class DecodeGraphs:
    """The engine's step graphs and static buffers, one entry per cache."""

    def __init__(self, device: torch.device, vocab: int):
        self.device = device
        self.vocab = vocab
        self._entries: dict[tuple, CacheGraphs] = {}
        self._pool = None
        self._side: torch.cuda.Stream | None = None

    def __len__(self) -> int:
        """The caches whose buffers and graphs are held."""
        return len(self._entries)

    def for_cache(self, cache) -> CacheGraphs:
        key = cache_key(cache)
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = CacheGraphs(
                self, key, StepBuffers(cache.positions.shape[0], self.vocab,
                                       self.device))
            # Freed with the cache: the first of its tensors to go drops
            # the buffers and graphs (whose pool memory later captures
            # reuse).
            for t in cache_tensors(cache):
                weakref.finalize(t, self._entries.pop, key, None)
        return entry

    def _graphs_alive(self) -> bool:
        """Whether any captured graph (hence the pool it holds) is alive."""
        return any(s is not None for e in self._entries.values()
                   for s in e.steps.values())

    def keys(self) -> set[tuple]:
        """Every captured step, as (cache key + step key)."""
        return {e.key + k for e in self._entries.values() for k in e.steps}

    def _capture(self, body, bufs: StepBuffers) -> CapturedStep | None:
        if self.device.type != "cuda":
            return None
        dev = self.device
        main = torch.cuda.current_stream(dev)
        if self._side is None:
            self._side = torch.cuda.Stream(dev)
        if not self._graphs_alive():
            # The caching allocator retires a pool once its last graph is
            # freed (a worker's caches dropped at a restart): a capture
            # after that must open a new one.
            self._pool = torch.cuda.graph_pool_handle()
        saved = [t.clone() for t in bufs.carry()]
        self._side.wait_stream(main)
        with torch.cuda.stream(self._side):
            body()
        main.wait_stream(self._side)
        for t, s in zip(bufs.carry(), saved):
            t.copy_(s)
        # Kept, so that its kernel nodes can be read back.
        graph = torch.cuda.CUDAGraph(keep_graph=True)

        def capture():
            with torch.cuda.graph(graph, pool=self._pool):
                body()

        counted = counted_capture(capture)
        graph.instantiate()
        return CapturedStep(graph,
                            node_launches(kernel_node_names(graph), counted))
