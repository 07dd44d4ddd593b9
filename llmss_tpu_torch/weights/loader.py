"""Pure-Python safetensors reader (counterpart: llmss_tpu/weights/loader.py).

A safetensors file is an 8-byte little-endian header length, a JSON header
mapping each tensor name to its dtype, shape and byte range, then the raw
bytes. ``SafetensorsFile`` maps the file and builds tensors with
``torch.frombuffer``; it needs neither the ``safetensors`` package nor
``transformers`` nor ``ml_dtypes``. Local directories only: nothing is
downloaded.
"""

from __future__ import annotations

import json
import mmap
import struct
from pathlib import Path

import torch

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

    def get(self, name: str) -> torch.Tensor:
        """The tensor as stored (a CPU copy, detached from the mapping)."""
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
        return t.view(dt).reshape(shape).clone()

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

    def __contains__(self, name: str) -> bool:
        return name in self._routing

    def get(self, name: str) -> torch.Tensor:
        """Tensor on the target device; floating tensors are cast to the
        target dtype, integer tensors are left as stored."""
        if name not in self._routing:
            raise KeyError(f"tensor {name!r} not in checkpoint")
        t = self._routing[name].get(name)
        dt = self.dtype if (self.dtype is not None and t.is_floating_point()) else t.dtype
        return t.to(device=self.device, dtype=dt)

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
