"""Stacked per-layer checkpoint loading shared by the families
(counterpart: llmss_tpu/models/_loading.py:20-66).

Per-layer tensors load as ``[n_layers, ...]`` stacks in the decoder's
layout. A torch ``nn.Linear`` stores ``[out, in]``: q/k keep that layout,
every other linear is transposed to ``[in, out]`` (``transpose=True``);
HF ``Conv1D`` tensors are already ``[in, out]``. ``sub=(axis, lo, hi)``
takes a part of a fused tensor (GPT-2 / BigCode ``c_attn``, Phi-3
``qkv_proj``) from the (transposed) weight's view; a bias takes the same
range on its only axis. ``key`` names the decoder parameter a loader
fills (``"q"``, ``"fc_in"``, ...): on a mesh the checkpoint then reads
only the rank's slice of it (``CheckpointShards.part``), of the fused
sub-range when there is one.
"""

from __future__ import annotations

from typing import Callable

from llmss_tpu_torch.ops.layers import LinearParams, NormParams
from llmss_tpu_torch.weights.loader import CheckpointShards


def stacked_linear(
    ckpt: CheckpointShards,
    name_fn: Callable[[int], str],
    n_layers: int,
    *,
    transpose: bool = True,
    sub: tuple[int, int, int] | None = None,
    bias: bool = True,
    key: str | None = None,
) -> LinearParams:
    """``{name_fn(i)}.weight`` (and ``.bias``, when ``bias`` and every
    layer has one) of all layers, stacked; on a mesh this rank's slice of
    the block parameter ``key``."""
    def part(field):
        return (None if key is None
                else ckpt.part("blocks", key, field, stacked=True))

    w = ckpt.get_stacked([f"{name_fn(i)}.weight" for i in range(n_layers)],
                         transpose=transpose, sub=sub, part=part("w"))
    b = None
    if bias:
        bnames = [f"{name_fn(i)}.bias" for i in range(n_layers)]
        if all(n in ckpt for n in bnames):
            bsub = (0, sub[1], sub[2]) if sub is not None else None
            b = ckpt.get_stacked(bnames, sub=bsub, part=part("b"))
    return LinearParams(w, b)


def stacked_norm(
    ckpt: CheckpointShards,
    name_fn: Callable[[int], str],
    n_layers: int,
    *,
    bias: bool = True,
) -> NormParams:
    """``{name_fn(i)}.weight`` (and ``.bias`` where every layer has one)."""
    scale = ckpt.get_stacked([f"{name_fn(i)}.weight" for i in range(n_layers)])
    b = None
    if bias:
        bnames = [f"{name_fn(i)}.bias" for i in range(n_layers)]
        if all(n in ckpt for n in bnames):
            b = ckpt.get_stacked(bnames)
    return NormParams(scale, b)


def norm(ckpt: CheckpointShards, prefix: str, *, bias: bool = True) -> NormParams:
    """A single norm ``{prefix}.weight`` (and ``.bias`` if present)."""
    b = None
    if bias and f"{prefix}.bias" in ckpt:
        b = ckpt.get(f"{prefix}.bias")
    return NormParams(ckpt.get(f"{prefix}.weight"), b)


def lm_head(ckpt: CheckpointShards, name: str, *, bias: bool = False) -> LinearParams:
    """An untied head: ``name`` ``[V, E]`` transposed to ``[E, V]``, with
    the sibling ``.bias`` when ``bias`` and the checkpoint has it (on a
    mesh, this rank's vocabulary slice)."""
    b = None
    bname = name.rsplit(".", 1)[0] + ".bias"
    if bias and bname in ckpt:
        b = ckpt.get(bname, part=ckpt.part("head", "b"))
    return LinearParams(ckpt.get(name, transpose=True,
                                 part=ckpt.part("head", "w")), b)


def table(ckpt: CheckpointShards, name: str, key: str):
    """An embedding table (``wte``, ``wpe``): on a mesh, this rank's rows."""
    return ckpt.get(name, part=ckpt.part(key))
