"""Unified decoder configuration (counterpart: llmss_tpu/models/common.py:31-142).

``DecoderConfig`` is a field-for-field copy of the reference's dataclass
(same names, same defaults); ``dtype`` stays a string and the
``torch_dtype`` property maps it to a ``torch.dtype``. ``act_fn`` is the
reference's activation table rewritten in torch.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
}


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    model_type: str
    vocab_size: int
    hidden_size: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    intermediate_size: int
    max_position_embeddings: int

    activation: str = "gelu_new"
    norm: str = "layernorm"  # "layernorm" | "rmsnorm"
    norm_eps: float = 1e-5
    norm_scale_offset: float = 0.0
    embed_multiplier: float | None = None
    parallel_residual: bool = False  # GPT-J block form
    parallel_residual_ln2: bool = False  # GPT-NeoX form of the parallel block
    mlp: str = "mlp"  # "mlp" | "swiglu"

    positions: str = "learned"  # "learned" | "rotary" | "none"
    rope_style: str = "interleaved"  # "interleaved" | "half"
    rotary_dim: int | None = None
    rope_theta: float = 10000.0
    rope_freq_factors: tuple[float, ...] | None = None
    rope_attn_factor: float = 1.0
    rope_freq_factors_short: tuple[float, ...] | None = None
    rope_freq_factors_long: tuple[float, ...] | None = None
    rope_original_max_positions: int | None = None

    sliding_window: int | None = None

    attn_bias: bool = True
    attn_out_bias: bool | None = None
    mlp_bias: bool = True
    head_bias: bool = False
    tie_word_embeddings: bool = False
    attn_scale: float | None = None

    dtype: str = "bfloat16"

    @property
    def torch_dtype(self) -> torch.dtype:
        try:
            return _DTYPES[self.dtype]
        except KeyError:
            raise ValueError(f"unsupported dtype {self.dtype!r}") from None

    @property
    def has_ln2(self) -> bool:
        """Sequential blocks always carry a second norm; parallel-residual
        blocks only in the NeoX form."""
        return not self.parallel_residual or self.parallel_residual_ln2

    @property
    def o_bias(self) -> bool:
        return (
            self.attn_bias if self.attn_out_bias is None
            else self.attn_out_bias
        )

    @property
    def q_size(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.n_kv_heads * self.head_dim


_ACTS = {
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_fast": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "swish": F.silu,
    "relu": F.relu,
    "tanh": torch.tanh,
}


def act_fn(name: str):
    """Activation by HF ``ACT2FN`` key."""
    if name not in _ACTS:
        raise KeyError(f"unsupported activation {name!r}")
    return _ACTS[name]
