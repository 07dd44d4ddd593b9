"""Dense layers and norms (counterpart: llmss_tpu/ops/layers.py:53-128).

Weight layout as in the reference: ``[in, out]`` for ``dense``; the q/k
projections are stored ``[out, in]`` and go through ``dense_t``. A linear
is a ``(w, b)`` pair with ``b`` possibly ``None``; a norm is
``(scale, bias)``. Norms compute in fp32 and cast back, as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LinearParams(NamedTuple):
    w: torch.Tensor  # [in, out] (q/k: [out, in])
    b: torch.Tensor | None


class NormParams(NamedTuple):
    scale: torch.Tensor
    bias: torch.Tensor | None


def dense(x: torch.Tensor, p: LinearParams) -> torch.Tensor:
    """y = x @ W (+ b)."""
    y = x @ p.w.to(x.dtype)
    if p.b is not None:
        y = y + p.b.to(y.dtype)
    return y


def dense_t(x: torch.Tensor, p: LinearParams) -> torch.Tensor:
    """y = x @ Wᵀ (+ b) for weights stored ``[out, in]``."""
    y = x @ p.w.to(x.dtype).transpose(-1, -2)
    if p.b is not None:
        y = y + p.b.to(y.dtype)
    return y


def embedding(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Row gather ``table[ids]``."""
    return table[ids]


def lm_head(x: torch.Tensor, p: LinearParams) -> torch.Tensor:
    """Full-vocab logits in fp32."""
    logits = (x @ p.w.to(x.dtype)).float()
    if p.b is not None:
        logits = logits + p.b.float()
    return logits


def layer_norm(x: torch.Tensor, p: NormParams, eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p.scale.float()
    if p.bias is not None:
        y = y + p.bias.float()
    return y.to(x.dtype)


def rms_norm(
    x: torch.Tensor, p: NormParams, eps: float, scale_offset: float = 0.0
) -> torch.Tensor:
    """RMSNorm; ``scale_offset`` is Gemma's (1 + weight) form."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    y = y * (p.scale.float() + scale_offset)
    return y.to(x.dtype)
