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
    tensors = (q, k, v, q_positions, kv_positions)
    if not all(t.is_cuda for t in tensors):
        raise RuntimeError("flash_attention (K1) takes CUDA tensors only")
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
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    st = launch_strides(q, k, v, out, impl)
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise _build.KernelError("flash_attention needs 16-byte aligned "
                                     "tensors")
    strides = (ctypes.c_int * 12)(*st)
    lib = _build.load("flash_attention")
    code = lib.llmss_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        qp.data_ptr(), kvp.data_ptr(), ctypes.addressof(strides),
        B, S, T, Hq, Hkv, D, _build.dtype_code(q), _build.IMPL_CODES[impl],
        float(scale), window or 0, _build.stream_ptr(q.device),
    )
    _build.check(code, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
