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
``"mma"`` (the tensor-core tile, csrc/attn_tile.cuh) for bf16 and f16,
``"fma"`` (fp32 FMAs) for fp32. The mma instantiation copies 16-byte rows
with cp.async, so every stride of q, k and v must be a multiple of 8
elements; a call it cannot take raises ``KernelError`` and no other
instantiation is tried.
"""

from __future__ import annotations

import ctypes

import torch

from llmss_tpu_torch.ops import _build
from llmss_tpu_torch.ops.attention import attention, make_causal_mask

HEAD_DIMS = _build.HEAD_DIMS
MMA_DTYPES = (torch.bfloat16, torch.float16)


def kernel_plan(dtype: torch.dtype, D: int) -> tuple[str, int]:
    """The instantiation a K1 launch takes and the shared memory one of its
    blocks needs, in bytes: ``"mma"`` for bf16 / f16, ``"fma"`` for fp32
    (64 query rows and two 64-slot tiles of D + 1 floats, the 64 x 68
    probability tile, 128 positions)."""
    if dtype in MMA_DTYPES:
        return "mma", _build.tile_smem_bytes(D)
    if dtype == torch.float32:
        return "fma", 4 * (192 * (D + 1) + 64 * 68 + 128)
    raise _build.KernelError(f"flash_attention (K1) takes bf16, f16 or fp32, "
                             f"got {dtype}")


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
    the kernel reads; the mma instantiation's 16-byte copies need each to
    be a multiple of 8 elements."""
    st = (*_strides(q), *_strides(k), *_strides(v), *_strides(out))
    if max(st) >= 2 ** 31:
        raise ValueError("tensor too large for 32-bit strides")
    if impl == "mma" and any(x % 8 for x in st):
        raise _build.KernelError(
            f"flash_attention (K1) mma instantiation needs strides that are "
            f"multiples of 8 elements (16-byte rows), got {st}")
    return st


def _checked(q, k, v, q_positions, kv_positions, scale, window, what):
    """The launch's operands after K1's envelope checks: int32 positions,
    the instantiation, the scale."""
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
    impl, smem = kernel_plan(q.dtype, D)
    if smem > _build.SMEM_LIMIT:
        raise _build.KernelError(f"flash_attention (K1): the {impl} "
                                 f"instantiation needs {smem} bytes of shared "
                                 "memory")
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise _build.KernelError("flash_attention needs 16-byte aligned "
                                     "tensors")
    return qp, kvp, impl, float(scale)


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
    qp, kvp, impl, scale = _checked(q, k, v, q_positions, kv_positions,
                                    scale, window, "flash_attention")
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    st = launch_strides(q, k, v, out, impl)
    strides = (ctypes.c_int * 12)(*st)
    lib = _build.load("flash_attention")
    code = lib.llmss_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        qp.data_ptr(), kvp.data_ptr(), ctypes.addressof(strides),
        B, S, T, Hq, Hkv, D, _build.dtype_code(q), _build.IMPL_CODES[impl],
        scale, window or 0, _build.stream_ptr(q.device),
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
    """Launch K1's state-out form (bf16 on the tile, fp32 on the FMA
    kernel): each query row's fp32 softmax state over the chunk instead of
    its output, for ``ops/ring_attention``'s merges. Returns (m, l, acc)
    in ``flash_attention_state_ref``'s layout (views of one workspace).
    Counted in ``flash_attention.launches`` (the step graphs count K1's
    kernels by symbol) and in ``flash_attention_state.launches``."""
    if q.dtype == torch.float16:
        raise _build.KernelError("flash_attention_state (K1) takes bf16 or "
                                 "fp32")
    qp, kvp, impl, scale = _checked(q, k, v, q_positions, kv_positions,
                                    scale, window, "flash_attention_state")
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    n = B * S * Hq
    ws = torch.empty(n * (D + 2), dtype=torch.float32, device=q.device)
    # The output's strides are unused: the workspace has its own layout.
    st = launch_strides(q, k, v, q, impl)
    strides = (ctypes.c_int * 12)(*st)
    lib = _build.load("flash_attention")
    code = lib.llmss_flash_attention_state(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ws.data_ptr(),
        qp.data_ptr(), kvp.data_ptr(), ctypes.addressof(strides),
        B, S, T, Hq, Hkv, D, _build.dtype_code(q), _build.IMPL_CODES[impl],
        scale, window or 0, _build.stream_ptr(q.device),
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
