"""Pure-Python safetensors reader (counterpart: llmss_tpu/weights/loader.py).

A safetensors file is an 8-byte little-endian header length, a JSON header
mapping each tensor name to its dtype, shape and byte range, then the raw
bytes. ``SafetensorsFile`` maps the file and builds tensors with
``torch.frombuffer``; it needs neither the ``safetensors`` package nor
``transformers`` nor ``ml_dtypes``. Local directories only: nothing is
downloaded.

``CheckpointShards.get`` takes the mapped tensor, optionally its 2D
transpose and a sub-range of one axis (a part of a fused tensor), and
copies only that into a new tensor on the target device. Host memory holds
at most one tensor's bytes beyond the mapping at a time; ``get_stacked``
fills a preallocated ``[L, ...]`` tensor layer by layer.

On a mesh each rank reads only its own slices, as the reference's loader
does (``read_slice`` / ``get_concat_array``, loader.py:209-320):
``set_shard`` gives the checkpoint the rank's tp coordinate and the
parameter specs (parallel/sharding.py), ``part`` names a parameter's
slice, and ``get`` / ``get_stacked(part=)`` narrow the mapped view to it
after any fused sub-range, so a fused tensor is sliced per sub-range. A
slice past an uneven end (a vocabulary tp does not divide) is padded with
zeros to ``ceil(n / tp)`` rows, as ``shard_params`` pads.
"""

from __future__ import annotations

import json
import mmap
import struct
from pathlib import Path

import torch

from llmss_tpu_torch.parallel.sharding import shard_range

_DTYPES = {
    "BF16": torch.bfloat16,
    "F16": torch.float16,
    "F32": torch.float32,
    "F64": torch.float64,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}


class SafetensorsFile:
    """Read-only view of one ``.safetensors`` file."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        with open(self.path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
            # Copy-on-write mapping: writable for torch.frombuffer, and the
            # file itself is never modified.
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        header.pop("__metadata__", None)
        self._entries = header
        self._data_start = 8 + n

    def keys(self):
        return self._entries.keys()

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def view(self, name: str) -> torch.Tensor:
        """The tensor as stored, aliasing the mapping (copy before use)."""
        e = self._entries[name]
        if e["dtype"] not in _DTYPES:
            raise ValueError(f"{name}: unsupported dtype {e['dtype']}")
        dt = _DTYPES[e["dtype"]]
        start, end = e["data_offsets"]
        shape = tuple(e["shape"])
        count = end - start
        if count == 0:
            return torch.empty(shape, dtype=dt)
        t = torch.frombuffer(
            self._mm, dtype=torch.uint8, count=count,
            offset=self._data_start + start,
        )
        return t.view(dt).reshape(shape)

    def get(self, name: str) -> torch.Tensor:
        """The tensor as stored (a CPU copy, detached from the mapping)."""
        return self.view(name).clone()

    def close(self) -> None:
        self._mm.close()


class CheckpointShards:
    """Every tensor of a set of safetensors files, by name."""

    def __init__(self, files, *, dtype: torch.dtype | None = None, device="cpu"):
        self.dtype = dtype
        self.device = torch.device(device)
        self._files = [SafetensorsFile(f) for f in files]
        self._routing: dict[str, SafetensorsFile] = {}
        for f in self._files:
            for k in f.keys():
                if k in self._routing:
                    raise RuntimeError(
                        f"key {k} found in both {f.path} and "
                        f"{self._routing[k].path}"
                    )
                self._routing[k] = f
        self._specs = None
        self._tp, self._rank = 1, 0

    def __contains__(self, name: str) -> bool:
        return name in self._routing

    def set_shard(self, specs, tp: int, rank: int) -> None:
        """Read tp rank ``rank``'s slices (of ``tp``) of the parameters
        whose ``specs`` (``sharding.param_specs``) name a dimension."""
        self._specs, self._tp, self._rank = specs, tp, rank

    def part(self, *path, stacked: bool = False):
        """The slice ``(axis, count, index)`` that this rank reads of the
        parameter at ``path`` (e.g. ``"blocks", "q", "w"``), on the axis of
        one layer's tensor when ``stacked``; None to read it whole."""
        if self._specs is None or self._tp == 1:
            return None
        spec = self._specs
        for key in path:
            spec = spec[key] if isinstance(spec, dict) else getattr(spec, key)
        if spec is None:
            return None
        return (spec - 1 if stacked else spec, self._tp, self._rank)

    def _logical(self, name: str, transpose: bool, sub, part=None
                 ) -> tuple[torch.Tensor, tuple | None]:
        """The mapped tensor ``name`` (no copy), transposed if asked (2D
        only), narrowed to ``sub = (axis, lo, hi)`` of that view, then to
        ``part``; with the padded shape when the part runs past the end
        (else None)."""
        if name not in self._routing:
            raise KeyError(f"tensor {name!r} not in checkpoint")
        t = self._routing[name].view(name)
        if transpose:
            if t.dim() != 2:
                raise ValueError(f"{name}: transpose load needs a 2D tensor")
            t = t.T
        if sub is not None:
            axis, lo, hi = sub
            t = t.narrow(axis, lo, hi - lo)
        padded = None
        if part is not None:
            axis, count, index = part
            lo, hi, local = shard_range(t.shape[axis], count, index, pad=True)
            if hi - lo < local:
                padded = list(t.shape)
                padded[axis] = local
                padded = tuple(padded)
            t = t.narrow(axis, lo, hi - lo)
        return t, padded

    def _fill(self, out: torch.Tensor, t: torch.Tensor) -> None:
        """Copy ``t`` into the leading rows of ``out`` (zeros after)."""
        if out.shape == t.shape:
            out.copy_(t)
            return
        out.zero_()
        out[tuple(slice(0, n) for n in t.shape)].copy_(t)

    def _target_dtype(self, t: torch.Tensor) -> torch.dtype:
        # Floating tensors are cast to the target dtype, integer tensors
        # are left as stored.
        return self.dtype if (self.dtype is not None
                              and t.is_floating_point()) else t.dtype

    def get(self, name: str, *, transpose: bool = False,
            sub: tuple[int, int, int] | None = None,
            part: tuple[int, int, int] | None = None) -> torch.Tensor:
        """Tensor ``name`` (its 2D transpose with ``transpose``, of that
        the range ``lo:hi`` of ``axis`` with ``sub=(axis, lo, hi)``, and of
        that this rank's ``part``), contiguous on the target device."""
        t, padded = self._logical(name, transpose, sub, part)
        out = torch.empty(padded or t.shape, dtype=self._target_dtype(t),
                          device=self.device)
        self._fill(out, t)
        return out

    def get_stacked(self, names, *, transpose: bool = False,
                    sub: tuple[int, int, int] | None = None,
                    part: tuple[int, int, int] | None = None
                    ) -> torch.Tensor:
        """``get`` of every name, stacked on a new leading axis: the
        per-layer tensors of one parameter as ``[len(names), ...]``."""
        first, padded = self._logical(names[0], transpose, sub, part)
        out = torch.empty((len(names), *(padded or first.shape)),
                          dtype=self._target_dtype(first), device=self.device)
        for i, n in enumerate(names):
            t, _ = self._logical(n, transpose, sub, part)
            if t.shape != first.shape:
                raise ValueError(f"{n}: shape {tuple(t.shape)}, the first "
                                 f"layer's is {tuple(first.shape)}")
            self._fill(out[i], t)
        return out

    def close(self) -> None:
        for f in self._files:
            f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def weight_files(path: str | Path, extension: str = ".safetensors") -> list[Path]:
    """The checkpoint files of a local model directory."""
    p = Path(path)
    if not p.is_dir():
        raise FileNotFoundError(f"{path} is not a local model directory")
    files = sorted(p.glob(f"*{extension}"))
    if not files:
        raise FileNotFoundError(f"no {extension} files in {path}")
    return files


def read_config(path: str | Path) -> dict:
    """The model directory's ``config.json`` as a dict."""
    with open(Path(path) / "config.json") as f:
        return json.load(f)
