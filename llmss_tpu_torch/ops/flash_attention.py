"""Kernel K1: prefill flash attention (csrc/flash_attention.cu).

Replaces ``llmss_tpu/ops/pallas_attention.py::flash_attention``.
``flash_attention`` launches the CUDA kernel and counts each launch in
``flash_attention.launches``; it takes CUDA tensors only.
``flash_attention_ref`` is the plain PyTorch version of the same function
(fp32 throughout), used for CPU tensors and as the kernel's check on the
card. Numerics: the kernel rounds P to the value dtype before P.V (as the
Pallas kernel does) where the plain version stays in fp32, so the two agree
to within the value dtype's rounding.

Two instantiations, chosen by ``kernel_plan`` from the dtype alone:
``"wgmma"`` (the Hopper tile: ``wgmma_rows`` flat query rows a block,
K / V by TMA in tiles of ``wgmma_slots(D)`` slots, a producer warp that
classifies each tile as skipped, full or masked; csrc/hopper.cuh) for
bf16 and f16,
``"fma"`` (fp32 FMAs, ``fma_rows`` query rows a block) for fp32. Both
read 16-byte rows: every stride of q, k and v must be a multiple of 16
bytes and every base 16-byte aligned (TMA's preconditions for the
wgmma tile's tensor maps). A call the chosen instantiation cannot take
raises ``KernelError`` and no other instantiation is tried.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from llmss_tpu_torch.ops import _build
from llmss_tpu_torch.ops.attention import attention, make_causal_mask
from llmss_tpu_torch.ops.split_plan import H100_SMS

HEAD_DIMS = _build.HEAD_DIMS
MMA_DTYPES = (torch.bfloat16, torch.float16)
# Flat query rows (f = s * G + g) a block of the wgmma tile, most first:
# one or two consumer warpgroups of 64 (csrc/flash_attention.cu
# ``wg::Plan<D, NC>::ROWS``).
WGMMA_ROWS = (128, 64)
# Query rows a block of the fp32 kernel, most first (at most 32 at D 256).
FMA_ROWS = (64, 32, 16)
# The element strides each instantiation's 16-byte rows need: 16 bytes of
# a 16-bit (wgmma) or fp32 (fma) tensor.
STRIDE_ELEMS = {"wgmma": 8, "fma": 4}


class Plan(NamedTuple):
    impl: str  # "wgmma" or "fma"
    smem: int  # bytes of shared memory a block
    rows: int  # query rows a block (flat rows for the wgmma tile)


def wgmma_slots(D: int) -> int:
    """KV slots a tile of the wgmma tile: 128 at D 64 / 128, 64 at D 256,
    so that a consumer's O (64 x D fp32) and S fit its registers."""
    return 128 if D <= 128 else 64


def wgmma_stages(D: int) -> int:
    """Stages of the wgmma tile's K / V ring: 3 at D 64, else 2."""
    return 3 if D == 64 else 2


def wgmma_smem_bytes(D: int, rows: int = 128) -> int:
    """Shared memory of one block of the wgmma tile (``wg::Plan<D, NC>``):
    Q (``rows`` rows of D 16-bit elements), per stage a K and a V tile
    (``wgmma_slots(D)`` rows of D), its slot positions, its tile index and
    class and its full and empty barriers, and 1024 bytes of slack to
    align the base for the 128-byte swizzle."""
    bk = wgmma_slots(D)
    return 1024 + rows * D * 2 + wgmma_stages(D) * (
        2 * bk * D * 2 + 4 * bk + 8 + 16)


def wgmma_rows(B: int, S: int, G: int, Hkv: int, sms: int = H100_SMS) -> int:
    """Flat query rows a block of the wgmma tile: 128, or 64 where a grid
    of 128-row blocks (B * Hkv * ceil(S * G / 128)) would leave at least
    half the SMs idle, or where S * G <= 64 (a 128-row block would be half
    empty, in as many blocks). From shapes the host knows; the threshold
    from the ``k1_forms`` measurement (PERF.md)."""
    blocks = B * Hkv * -(-S * G // WGMMA_ROWS[0])
    small = S * G <= WGMMA_ROWS[1] or 2 * blocks <= sms
    return WGMMA_ROWS[1] if small else WGMMA_ROWS[0]


def fma_slots(D: int) -> int:
    """KV slots a tile of the fp32 kernel: 32 at D 256 (two blocks an
    SM), else 64."""
    return 32 if D > 128 else 64


def fma_smem_bytes(D: int, rows: int) -> int:
    """Shared memory of one block of the fp32 kernel (``FmaSmem``): Q
    and a K and a V tile in rows of D + 4 floats, the rows x (slots + 4)
    probability tile, the rows' and slots' positions."""
    bk, ld = fma_slots(D), D + 4
    return 4 * ((rows + 2 * bk) * ld + rows * (bk + 4) + rows + bk)


def fma_rows(B: int, S: int, Hq: int, D: int, sms: int = H100_SMS) -> int:
    """Query rows a block of the fp32 kernel: the most of ``FMA_ROWS``
    (at most 32 at D 256) whose grid of B * Hq * ceil(S / rows) blocks
    still gives every SM one, else the fewest. From shapes the host
    knows, as split_plan plans the decode kernels."""
    fits = [r for r in FMA_ROWS if D <= 128 or r <= 32]
    for rows in fits:
        if B * Hq * -(-S // rows) >= sms:
            return rows
    return fits[-1]


def kernel_plan(dtype: torch.dtype, D: int, *, B: int = 1, S: int = 1,
                Hq: int = 1, Hkv: int | None = None, sms: int = H100_SMS,
                rows: int | None = None) -> Plan:
    """The instantiation a K1 launch takes, the shared memory one of its
    blocks needs, in bytes, and its query rows a block: ``"wgmma"`` for
    bf16 / f16 (rows from ``wgmma_rows``), ``"fma"`` for fp32 (from
    ``fma_rows``). ``rows`` forces the rows a block (a measurement)."""
    Hkv = Hq if Hkv is None else Hkv
    if dtype in MMA_DTYPES:
        rows = rows or wgmma_rows(B, S, Hq // Hkv, Hkv, sms)
        if rows not in WGMMA_ROWS:
            raise _build.KernelError(f"the wgmma tile takes {WGMMA_ROWS} "
                                     f"rows a block, got {rows}")
        return Plan("wgmma", wgmma_smem_bytes(D, rows), rows)
    if dtype == torch.float32:
        rows = rows or fma_rows(B, S, Hq, D, sms)
        if rows not in FMA_ROWS or (D > 128 and rows > 32):
            raise _build.KernelError(f"the fma kernel takes {FMA_ROWS} rows "
                                     f"a block (at most 32 at D 256), got "
                                     f"{rows}")
        return Plan("fma", fma_smem_bytes(D, rows), rows)
    raise _build.KernelError(f"flash_attention (K1) takes bf16, f16 or fp32, "
                             f"got {dtype}")


def wgmma_blocks(B: int, S: int, G: int, Hkv: int,
                 rows: int = 128) -> list[tuple[int, int, int]]:
    """The wgmma tile's blocks in launch order, as (query tile, KV head,
    batch row): its grid is (Hkv, B, query tiles of ``rows`` flat rows),
    x fastest, and block z takes query tile n - 1 - z, so the tiles with
    the longest causal walks (the last flat rows) start in the first
    wave."""
    n = -(-S * G // rows)
    return [(n - 1 - z, hk, b) for z in range(n) for b in range(B)
            for hk in range(Hkv)]


def tile_classes(q_positions, kv_positions, G: int, D: int, *,
                 window: int | None = None, rows: int = 128):
    """The wgmma tile producer's classes, for each (batch row, query tile
    of ``rows`` flat rows, KV tile of ``wgmma_slots(D)`` slots): 0 skipped
    (no row of the block sees a slot: never copied), 1 masked, 2 full (every
    slot 0 <= p <= the block's earliest query and, with a window, p > its
    latest query - window: every row sees every slot, no per-element
    mask). Query tiles in flat-row order (the kernel launches the last
    first). int64 [B, n_query_tiles, n_kv_tiles], on the positions'
    device."""
    qp = q_positions.long().repeat_interleave(G, dim=1)  # [B, S * G] flat
    kvp = kv_positions.long()
    B, F = qp.shape
    T = kvp.shape[1]
    bk = wgmma_slots(D)
    nq, nk = -(-F // rows), -(-T // bk)
    big = 2 ** 62
    lo = torch.nn.functional.pad(qp, (0, nq * rows - F), value=big)
    hi = torch.nn.functional.pad(qp, (0, nq * rows - F), value=-big)
    lo = lo.view(B, nq, rows).amin(-1)[:, :, None, None]
    hi = hi.view(B, nq, rows).amax(-1)[:, :, None, None]
    p = torch.nn.functional.pad(kvp, (0, nk * bk - T), value=-1)
    p = p.view(B, 1, nk, bk)
    w = window if window else 0
    live = (p >= 0) & (p <= hi) & ((p > lo - w) if w else True)
    full = (p >= 0) & (p <= lo) & ((p > hi - w) if w else True)
    return torch.where(full.all(-1), 2, live.any(-1).long())


def flash_attention_ref(
    q: torch.Tensor,  # [B, S, Hq, D]
    k: torch.Tensor,  # [B, T, Hkv, D]
    v: torch.Tensor,
    q_positions: torch.Tensor,  # [B, S]
    kv_positions: torch.Tensor,  # [B, T], -1 = empty slot
    *,
    scale: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    mask = make_causal_mask(q_positions, kv_positions, kv_positions >= 0, window)
    return attention(q, k, v, mask, scale=scale)


def _strides(t: torch.Tensor) -> tuple[int, int, int]:
    if t.stride(-1) != 1:
        raise ValueError("flash_attention needs a contiguous feature dim")
    return t.stride(0), t.stride(1), t.stride(2)


def launch_strides(q, k, v, out, impl: str) -> tuple[int, ...]:
    """The 12 element strides (batch, seq, head) of q, k, v and out that
    the kernel reads, after the checks its 16-byte rows need (the wgmma
    tile's TMA maps among them): every stride a multiple of 16 bytes
    (``STRIDE_ELEMS[impl]`` elements) and q, k and v 16-byte aligned."""
    st = (*_strides(q), *_strides(k), *_strides(v), *_strides(out))
    if max(st) >= 2 ** 31:
        raise ValueError("tensor too large for 32-bit strides")
    n = STRIDE_ELEMS[impl]
    if any(x % n for x in st):
        raise _build.KernelError(
            f"flash_attention (K1) {impl} instantiation needs strides that "
            f"are multiples of {n} elements (16-byte rows), got {st}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise _build.KernelError("flash_attention needs 16-byte aligned "
                                 "tensors")
    return st


def _checked(q, k, v, q_positions, kv_positions, scale, window, what,
             rows=None):
    """The launch's operands after K1's envelope checks: int32 positions,
    the plan, the scale."""
    tensors = (q, k, v, q_positions, kv_positions)
    if not all(t.is_cuda for t in tensors):
        raise RuntimeError(f"{what} (K1) takes CUDA tensors only")
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention supports head_dim {HEAD_DIMS}, got {D}")
    if Hq % Hkv or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"bad shapes q={tuple(q.shape)} k={tuple(k.shape)} "
                         f"v={tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must share a dtype")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    qp = q_positions.to(torch.int32).contiguous()
    kvp = kv_positions.to(torch.int32).contiguous()
    if qp.shape != (B, S) or kvp.shape != (B, T):
        raise ValueError("positions must be [B, S] and [B, T]")
    plan = kernel_plan(q.dtype, D, B=B, S=S, Hq=Hq, Hkv=Hkv,
                       sms=_build.sm_count(q.device), rows=rows)
    if plan.smem > _build.SMEM_LIMIT:
        raise _build.KernelError(f"flash_attention (K1): the {plan.impl} "
                                 f"instantiation needs {plan.smem} bytes of "
                                 "shared memory")
    return qp, kvp, plan, float(scale)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    *,
    scale: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Launch K1 on the current stream; returns [B, S, Hq, D] in q's dtype."""
    return _launch(q, k, v, q_positions, kv_positions, scale, window)


def _launch(q, k, v, q_positions, kv_positions, scale=None, window=None,
            rows=None):
    """``flash_attention``, with its rows a block forced by ``rows`` (the
    ``k1_forms`` measurement); counted in ``flash_attention.launches``."""
    qp, kvp, plan, scale = _checked(q, k, v, q_positions, kv_positions,
                                    scale, window, "flash_attention", rows)
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    st = launch_strides(q, k, v, out, plan.impl)
    strides = (ctypes.c_int * 12)(*st)
    lib = _build.load("flash_attention")
    code = lib.llmss_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        qp.data_ptr(), kvp.data_ptr(), ctypes.addressof(strides),
        B, S, T, Hq, Hkv, D, _build.dtype_code(q),
        _build.IMPL_CODES[plan.impl], plan.rows, scale, window or 0,
        _build.stream_ptr(q.device),
    )
    _build.check(code, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_state_ref(q, k, v, q_positions, kv_positions, *,
                              scale: float | None = None,
                              window: int | None = None):
    """The plain version of K1's state-out form: the reference's
    ``_online_block`` from the initial state over the chunk ``k`` / ``v``;
    returns fp32 (m, l, acc), m / l ``[B, Hkv, G, S]``, acc with D more."""
    from llmss_tpu_torch.ops import ring_attention as ring

    m, l, acc = ring._init_state(q, k.shape[2])
    return ring._online_block(
        m, l, acc, q, k, v, q_positions, kv_positions,
        1.0 / (q.shape[-1] ** 0.5) if scale is None else scale, window)


def flash_attention_state(
    q: torch.Tensor,  # [B, S, Hq, D]
    k: torch.Tensor,  # [B, C, Hkv, D] one KV chunk
    v: torch.Tensor,
    q_positions: torch.Tensor,  # [B, S]
    kv_positions: torch.Tensor,  # [B, C], -1 = empty slot
    *,
    scale: float | None = None,
    window: int | None = None,
):
    """Launch K1's state-out form (bf16 on the wgmma tile, fp32 on the
    FMA kernel): each query row's fp32 softmax state over the chunk instead of
    its output, for ``ops/ring_attention``'s merges. Returns (m, l, acc)
    in ``flash_attention_state_ref``'s layout (views of one workspace).
    Counted in ``flash_attention.launches`` (the step graphs count K1's
    kernels by symbol) and in ``flash_attention_state.launches``."""
    return _launch_state(q, k, v, q_positions, kv_positions, scale, window)


def _launch_state(q, k, v, q_positions, kv_positions, scale=None,
                  window=None, rows=None):
    """``flash_attention_state``, with its rows a block forced by ``rows``
    (a measurement)."""
    if q.dtype == torch.float16:
        raise _build.KernelError("flash_attention_state (K1) takes bf16 or "
                                 "fp32")
    qp, kvp, plan, scale = _checked(q, k, v, q_positions, kv_positions,
                                    scale, window, "flash_attention_state",
                                    rows)
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    n = B * S * Hq
    ws = torch.empty(n * (D + 2), dtype=torch.float32, device=q.device)
    # The output's strides are unused: the workspace has its own layout.
    st = launch_strides(q, k, v, q, plan.impl)
    strides = (ctypes.c_int * 12)(*st)
    lib = _build.load("flash_attention")
    code = lib.llmss_flash_attention_state(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ws.data_ptr(),
        qp.data_ptr(), kvp.data_ptr(), ctypes.addressof(strides),
        B, S, T, Hq, Hkv, D, _build.dtype_code(q),
        _build.IMPL_CODES[plan.impl], plan.rows, scale, window or 0,
        _build.stream_ptr(q.device),
    )
    _build.check(code, "flash_attention_state")
    flash_attention.launches += 1
    flash_attention_state.launches += 1
    # [B, Hkv, S, G] -> [B, Hkv, G, S]
    acc = ws[: n * D].view(B, Hkv, S, G, D).transpose(2, 3)
    m = ws[n * D: n * (D + 1)].view(B, Hkv, S, G).transpose(2, 3)
    l = ws[n * (D + 1):].view(B, Hkv, S, G).transpose(2, 3)
    return m, l, acc


flash_attention_state.launches = 0
