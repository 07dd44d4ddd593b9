"""Rotary position embeddings (counterpart: llmss_tpu/ops/rope.py:26-100).

``"interleaved"`` (GPT-J) rotates feature pairs (0,1), (2,3), …;
``"half"`` (NeoX / Llama) rotates feature i with feature i + dim/2. Partial
rotary (``rotary_dim`` < head_dim) leaves the tail features untouched.
"""

from __future__ import annotations

import torch


def inv_freq_table(dim: int, theta: float, freq_factors=None,
                   device="cpu") -> torch.Tensor:
    """The ``dim/2`` fp32 rotary frequencies on ``device``, divided by
    LongRoPE's per-frequency ``freq_factors`` when given. Uploading the
    factors is a host-to-device copy, which a captured CUDA graph cannot
    hold: callers that run under capture build this once beforehand
    (models/decoder.py ``rope_inv_freq``)."""
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                  / dim)
    )
    if freq_factors is not None:
        inv_freq = inv_freq / torch.tensor(
            freq_factors, dtype=torch.float32).to(device)
    return inv_freq


def sin_cos_tables(
    positions: torch.Tensor, dim: int, theta: float,
    freq_factors=None, attn_factor: float = 1.0, *,
    inv_freq: torch.Tensor | None = None,
):
    """sin/cos ``[B, S, dim/2]`` in fp32 for integer positions.
    ``freq_factors`` are LongRoPE's per-frequency divisors and
    ``attn_factor`` its scalar sin/cos multiplier; ``inv_freq`` is
    ``inv_freq_table(dim, theta, freq_factors, positions.device)`` built
    beforehand (then ``freq_factors`` is not read)."""
    if inv_freq is None:
        inv_freq = inv_freq_table(dim, theta, freq_factors, positions.device)
    angles = positions[..., None].float() * inv_freq
    sin, cos = torch.sin(angles), torch.cos(angles)
    if attn_factor != 1.0:
        sin = sin * attn_factor
        cos = cos * attn_factor
    return sin, cos


def apply_rope(
    x: torch.Tensor,  # [B, S, H, D]
    positions: torch.Tensor,  # [B, S]
    *,
    rotary_dim: int | None = None,
    theta: float = 10000.0,
    style: str = "interleaved",
    sin_cos=None,
    freq_factors=None,
    attn_factor: float = 1.0,
) -> torch.Tensor:
    """Rotate the first ``rotary_dim`` features of each head by position."""
    D = x.shape[-1]
    rotary_dim = rotary_dim or D
    rot, rest = x[..., :rotary_dim], x[..., rotary_dim:]
    sin, cos = sin_cos if sin_cos is not None else sin_cos_tables(
        positions, rotary_dim, theta, freq_factors, attn_factor
    )
    sin = sin[:, :, None, :]
    cos = cos[:, :, None, :]
    rotf = rot.float()
    if style == "interleaved":
        x1, x2 = rotf[..., ::2], rotf[..., 1::2]
        r1 = x1 * cos - x2 * sin
        r2 = x2 * cos + x1 * sin
        rotated = torch.stack([r1, r2], dim=-1).reshape(rotf.shape)
    elif style == "half":
        half = rotary_dim // 2
        x1, x2 = rotf[..., :half], rotf[..., half:]
        r1 = x1 * cos - x2 * sin
        r2 = x2 * cos + x1 * sin
        rotated = torch.cat([r1, r2], dim=-1)
    else:
        raise ValueError(f"unknown rope style {style!r}")
    rotated = rotated.to(x.dtype)
    if rest.shape[-1] == 0:
        return rotated
    return torch.cat([rotated, rest], dim=-1)
