"""Build and load the port's CUDA kernels (``llmss_tpu_torch/csrc/*.cu``).

Each source compiles on first use, with ``nvcc`` for ``sm_90a``, into its
own shared library with a plain C interface under
``llmss_tpu_torch/csrc/build/`` (git-ignored), and is loaded with
``ctypes``. Sources are compiled in parallel, one ``nvcc`` process each.
Nothing is built when a module is imported, and there is no fallback: a
failed build raises.

Calling convention shared with the sources: every C entry point takes
pointers and the CUDA stream as ``c_void_p`` and integers as ``c_int``,
launches on the given stream without synchronising or allocating, and
returns ``cudaGetLastError()``; ``check`` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("flash_attention", "decode_attention", "paged_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.int8: 3}
# instantiation codes of the entry points' ``impl`` argument (the lane
# template's int8 instantiation is chosen by the cache's dtype code)
IMPL_CODES = {"lanes": 0, "lanes_int8": 0, "fma": 0, "mma": 1, "mma_int8": 2}
# q / fresh KV dtypes an int8 cache's kernels take
INT8_QUERY_DTYPES = (torch.float32, torch.bfloat16)
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on the H100
# The head dims every kernel (K1-K4) is instantiated for.
HEAD_DIMS = (64, 128, 256)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A kernel failed to build or to launch."""


def check_head_dim(head_dim: int, device) -> None:
    """Refuse, on a CUDA device, a model whose head dim no kernel is
    instantiated for: there every attention call goes to a kernel, and
    nothing falls back to a plain version. The CPU runs the plain versions
    at any head dim."""
    if torch.device(device).type == "cuda" and head_dim not in HEAD_DIMS:
        raise KernelError(
            f"head_dim {head_dim} has no kernel instantiation: the CUDA "
            f"kernels take head_dim {HEAD_DIMS} (device='cpu' runs the "
            "plain versions)")


def tile_smem_bytes(D: int) -> int:
    """Shared memory of one block of the tensor-core tile (csrc/
    attn_tile.cuh ``Smem<D>``): Q and double-buffered K and V tiles of 64
    rows of D + 8 16-bit elements, and two stages of 64 int32 positions."""
    return 2 * 5 * 64 * (D + 8) + 2 * 64 * 4


def tile_i8_smem_bytes(D: int) -> int:
    """Shared memory of one block of the int8-pool tensor-core tile (csrc/
    attn_tile_i8.cuh ``SmemI8<D>``): Q and one widened K and V tile of 64
    rows of D + 8 bf16 elements; two stages of int8 K and V tiles of 64
    rows of D + 16 bytes (a fresh bf16 K and V tile reuses their bytes);
    two stages of 64 K and 64 V fp32 scales and of 64 int32 positions.
    At D = 128: 90,624 bytes, two blocks per SM."""
    return 2 * 3 * 64 * (D + 8) + 4 * 64 * (D + 16) + 4 * 2 * 2 * 64 + 2 * 64 * 4


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    deps = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return any(d.stat().st_mtime > lib.stat().st_mtime for d in deps)


def build(names=SOURCES, *, verbose: bool = False) -> dict[str, str]:
    """Compile the named sources that are missing or out of date, all
    ``nvcc`` processes started together. Returns each compiled source's
    compiler output (``-Xptxas=-v`` register / shared-memory report when
    ``verbose``). Raises ``KernelError`` if any build fails."""
    todo = [n for n in names if verbose or _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = BUILD_DIR / f"lib{n}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, *(("-Xptxas=-v",) if verbose else ()),
               "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    out, failed = {}, []
    for n, (tmp, p) in procs.items():
        text, _ = p.communicate()
        out[n] = text
        if p.returncode != 0:
            failed.append(f"{n}.cu (exit {p.returncode}):\n{text}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(n))
    if failed:
        raise KernelError("nvcc failed for " + "\n".join(failed))
    return out


def build_all(*, verbose: bool = False) -> tuple[float, dict[str, str]]:
    """Build every kernel source; returns (seconds, compiler output)."""
    t0 = time.perf_counter()
    with _lock:
        out = build(SOURCES, verbose=verbose)
    return time.perf_counter() - t0, out


def _declare(lib: ctypes.CDLL, name: str) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "flash_attention":
        fn = lib.llmss_flash_attention
        # q k v out qpos kvpos strides | B S T Hq Hkv D dtype impl | scale
        # window stream
        fn.argtypes = [P] * 7 + [I] * 8 + [F, I, P]
    elif name == "decode_attention":
        fn = lib.llmss_decode_attention
        # q kc vc kn vn out qpos kvpos slots ws | layer B T t_len Hq Hkv D GB
        # S split dtype | scale window stream | k_scale v_scale kv_dtype impl
        fn.argtypes = [P] * 10 + [I] * 11 + [F, I, P] + [P, P, I, I]
    elif name == "paged_attention":
        fn = lib.llmss_paged_attention
        # q kp vp kn vn out qpos qlen kvpos tables nblk slot0 ws | layer B CB
        # Np bs MB n_cols Hq Hkv D R S split dtype impl | scale window stream
        # | k_scale v_scale kv_dtype
        fn.argtypes = [P] * 13 + [I] * 15 + [F, I, P] + [P, P, I]
    fn.restype = ctypes.c_int


def load(name: str) -> ctypes.CDLL:
    """The loaded library for one source, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(_lib_path(name)))
            _declare(lib, name)
            _libs[name] = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        raise KernelError(f"{what} launch failed: CUDA error {code}")


def dtype_code(t) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise KernelError(f"unsupported dtype {t.dtype}") from None


def scale_args(name: str, q, kv, k_scale, v_scale) -> tuple:
    """The int8 scale operands' pointers ``(k_scale, v_scale)``, checked:
    fp32, contiguous, CUDA, ``kv.shape[:-1]``, present iff the cache ``kv``
    is int8, whose q must be fp32 or bf16; ``(None, None)`` for a cache of
    q's dtype. Raises ``KernelError`` for anything else."""
    if kv.dtype != torch.int8:
        if kv.dtype != q.dtype or k_scale is not None or v_scale is not None:
            raise KernelError(f"{name}: a {kv.dtype} cache under {q.dtype} "
                              "queries, or scales without an int8 cache")
        return None, None
    if q.dtype not in INT8_QUERY_DTYPES:
        raise KernelError(f"{name}: an int8 cache takes fp32 or bf16 "
                          f"queries, got {q.dtype}")
    want = tuple(kv.shape[:-1])
    for t in (k_scale, v_scale):
        if t is None or t.dtype != torch.float32 or not t.is_cuda or \
                tuple(t.shape) != want or not t.is_contiguous():
            raise KernelError(f"{name}: an int8 cache needs contiguous fp32 "
                              f"CUDA k_scale and v_scale of shape {want}")
    return k_scale.data_ptr(), v_scale.data_ptr()


def stream_ptr(device) -> int:
    """The handle of PyTorch's current CUDA stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """SMs of the CUDA ``device``: the decode kernels' split plan fills them."""
    return torch.cuda.get_device_properties(device).multi_processor_count
