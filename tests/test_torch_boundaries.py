"""Boundaries of the torch port: it imports nothing of JAX or of the JAX
package, nor ``transformers``, ``safetensors`` or ``fastapi`` (the GPU
machine has none of them), and loads ``redis`` only when a RedisBroker is
built without a client; its entry points default to the GPU and raise
without one, a CUDA request never falls back to the plain CPU versions,
and a model whose head dim no kernel takes is refused on the GPU at
construction."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from llmss_tpu_torch import resolve_device
from llmss_tpu_torch.engine.engine import DecodeEngine, GenerationParams
from llmss_tpu_torch.models.common import DecoderConfig
from llmss_tpu_torch.models.decoder import init_params
from llmss_tpu_torch.ops import _build
from llmss_tpu_torch.ops import attention as tatt
from llmss_tpu_torch.ops.decode_attention import decode_attention
from llmss_tpu_torch.ops.flash_attention import flash_attention
from llmss_tpu_torch.ops.paged_attention import (
    paged_decode_attention, ragged_paged_attention,
)

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "llmss_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "kernel_ab.py"]
CFG = DecoderConfig(
    model_type="llama", vocab_size=32, hidden_size=32, n_layers=1, n_heads=2,
    n_kv_heads=2, head_dim=16, intermediate_size=32,
    max_position_embeddings=32, norm="rmsnorm", mlp="swiglu",
    positions="rotary", rope_style="half", attn_bias=False, mlp_bias=False,
    dtype="float32",
)


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "llmss_tpu", "flax",
                                   "transformers", "safetensors", "fastapi"}
    assert not bad, f"{path} imports {bad}"


def test_port_modules_leave_redis_unloaded():
    """Every module of the port, imported in a fresh interpreter, leaves
    ``redis`` out of ``sys.modules``: only ``RedisBroker.__init__`` imports
    it, and only when it is given no client."""
    mods = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  for p in (ROOT / "llmss_tpu_torch").rglob("*.py"))
    mods = [m.removesuffix(".__init__") for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print(len(sys.modules), 'redis' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, timeout=120,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "False", out.stdout
    assert {"llmss_tpu_torch.serve.producer",
            "llmss_tpu_torch.serve.supervisor"} <= set(mods)


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_gpu_and_raise_without_one(no_gpu):
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(CFG, seed=0)
    params = init_params(CFG, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeEngine(CFG, params)
    assert resolve_device("cpu").type == "cpu"


def test_batcher_and_worker_default_to_gpu(no_gpu):
    """The continuous batcher and worker are built on an engine, whose
    default device is the GPU: without one they cannot be built."""
    from llmss_tpu_torch.engine.scheduler import ContinuousBatcher
    from llmss_tpu_torch.serve.broker import InProcBroker
    from llmss_tpu_torch.serve.consumer import ContinuousWorker

    params = init_params(CFG, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatcher(DecodeEngine(CFG, params, kv_layout="paged"), rows=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousWorker(DecodeEngine(CFG, params), InProcBroker(), rows=2)


def test_cli_defaults_to_gpu(no_gpu, tmp_path):
    from llmss_tpu_torch.cli.generate import main

    (tmp_path / "config.json").write_text('{"model_type": "llama"}')
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--pretrained_model_path", str(tmp_path), "--token_ids", "1,2"])


def test_consumer_main_defaults_to_gpu(no_gpu, tmp_path):
    from llmss_tpu_torch.serve.consumer import main

    (tmp_path / "config.json").write_text('{"model_type": "llama"}')
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--pretrained_model_path", str(tmp_path), "--continuous"])


def test_kernel_wrappers_take_cuda_tensors_only():
    q = torch.zeros(1, 16, 2, 64)
    kv = torch.zeros(1, 16, 2, 64)
    pos = torch.zeros(1, 16, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        flash_attention(q, kv, kv, pos, pos)
    cache = torch.zeros(1, 1, 16, 2, 64)
    q1 = torch.zeros(1, 1, 2, 64)
    p1 = torch.zeros(1, 1, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        decode_attention(q1, cache, cache, q1, q1, p1, pos, p1, 0)
    pool = torch.zeros(1, 3, 8, 2, 64)
    kvp = torch.zeros(1, 16, dtype=torch.int32)
    bt = torch.zeros(1, 2, dtype=torch.int32)
    row = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        paged_decode_attention(q1, pool, pool, q1, q1, p1, kvp, bt, row, p1, 0)
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        ragged_paged_attention(q1, pool, pool, q1, q1, row, row, kvp, bt, row,
                               row, 0)


def test_dispatch_refuses_other_devices():
    """A request on a device that is neither CUDA nor the CPU (here: meta
    tensors) raises instead of reaching a plain version."""
    q = torch.zeros(1, 16, 2, 64, device="meta")
    pos = torch.zeros(1, 16, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="must all be CUDA"):
        tatt.prefill_attention(q, q, q, pos, pos)
    cpu_pos = torch.zeros(1, 16, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="must all be CUDA"):
        tatt.prefill_attention(q, q, q, pos, cpu_pos)
    # The paged dispatchers: one tensor elsewhere than the rest raises.
    q1 = torch.zeros(1, 1, 2, 64)
    pool = torch.zeros(1, 3, 8, 2, 64, device="meta")
    kvp = torch.zeros(1, 16, dtype=torch.int32)
    bt = torch.zeros(1, 2, dtype=torch.int32)
    row = torch.zeros(1, dtype=torch.int32)
    p1 = torch.zeros(1, 1, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="must all be CUDA"):
        tatt.paged_decode_attention(q1, pool, pool, q1, q1, p1, kvp, bt, row,
                                    p1, 0)
    with pytest.raises(RuntimeError, match="must all be CUDA"):
        tatt.ragged_attention(q1, pool, pool, q1, q1, row, row, kvp, bt, row,
                              row, 0)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(_build.KernelError, match="nvcc"):
        _build.build(("flash_attention",))


def test_head_dim_envelope_names_the_head_dim():
    """Phi-3-mini's head_dim 96 has no kernel: on CUDA the check names it
    and the supported set; the kernels' head dims pass; the CPU takes any."""
    with pytest.raises(_build.KernelError, match=r"head_dim 96 .*\(64, 128, 256\)"):
        _build.check_head_dim(96, "cuda")
    for d in _build.HEAD_DIMS:
        _build.check_head_dim(d, torch.device("cuda", 0))
    _build.check_head_dim(96, "cpu")


def test_engine_refuses_unsupported_head_dim_on_cuda(monkeypatch):
    """An engine (and so a batcher or worker built on it) for head_dim 80
    raises KernelError at construction on CUDA, before any tensor moves;
    the same config runs its plain path on the CPU."""
    cfg = dataclasses.replace(CFG, n_heads=2, n_kv_heads=2, head_dim=80,
                              rotary_dim=80)
    params = init_params(cfg, seed=0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(_build.KernelError, match="head_dim 80"):
        DecodeEngine(cfg, params, device="cuda")
    monkeypatch.undo()
    eng = DecodeEngine(cfg, params, device="cpu", max_seq_len=32)
    out = eng.generate([[1, 2, 3], [4, 5]], GenerationParams(max_new_tokens=5),
                       chunk_steps=2)
    assert [len(o) for o in out] == [5, 5]
