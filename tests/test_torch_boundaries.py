"""Boundaries of the torch port: it imports nothing of JAX or of the JAX
package, nor ``ml_dtypes``, ``transformers``, ``safetensors`` or
``fastapi`` (the GPU machine has none of them), and loads ``redis`` only when a RedisBroker is
built without a client; its entry points default to the GPU and raise
without one, a CUDA request never falls back to the plain CPU versions,
a model whose head dim no kernel takes is refused on the GPU at
construction, and the telemetry plane reaches ``torch.profiler`` only when
a profile is asked for."""

import ast
import dataclasses
import json
import subprocess
import sys
import time
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
                                   "ml_dtypes", "transformers", "safetensors",
                                   "fastapi"}
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
            "llmss_tpu_torch.serve.supervisor",
            "llmss_tpu_torch.serve.kvstore"} <= set(mods)


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


def test_speculative_module_is_held_to_the_boundaries():
    """``engine/speculative.py`` is one of the files the import check
    covers, and it imports neither JAX nor the JAX package."""
    path = ROOT / "llmss_tpu_torch" / "engine" / "speculative.py"
    assert path in PORT_FILES
    assert not _imported_roots(path) & {"jax", "jaxlib", "llmss_tpu"}


def test_window_kernel_takes_cuda_tensors_only():
    """K2w's wrapper refuses CPU tensors, and its dispatcher refuses a
    device that is neither CUDA nor the CPU."""
    from llmss_tpu_torch.ops.decode_attention import decode_window_attention

    q = torch.zeros(1, 4, 2, 64)
    cache = torch.zeros(1, 1, 16, 2, 64)
    p0 = torch.zeros(1, 1, dtype=torch.int32)
    kvp = torch.zeros(1, 16, dtype=torch.int32)
    slots = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        decode_window_attention(q, cache, cache, q, q, p0, kvp, slots, 0)
    meta = torch.zeros(1, 1, 16, 2, 64, device="meta")
    with pytest.raises(RuntimeError, match="must all be CUDA"):
        tatt.decode_window_attention(q, meta, meta, q, q, p0, kvp, slots, 0)


def test_fleet_modules_leave_redis_and_fastapi_unloaded():
    """``serve/fleet.py``, ``serve/chaos.py`` and ``utils/trace.py``,
    imported in a fresh interpreter, load neither ``redis`` nor
    ``fastapi``."""
    code = ("import sys\n"
            "import llmss_tpu_torch.serve.fleet, llmss_tpu_torch.serve.chaos\n"
            "import llmss_tpu_torch.utils.trace\n"
            "print('redis' in sys.modules, 'fastapi' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, timeout=120,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False"], out.stdout


def test_consumer_main_worker_id_defaults_to_gpu(no_gpu, tmp_path):
    """``--worker_id`` is served: the fleet member is built on the GPU and
    raises without one; a ':' in the id is refused first."""
    from llmss_tpu_torch.serve.consumer import main

    (tmp_path / "config.json").write_text('{"model_type": "llama"}')
    argv = ["--pretrained_model_path", str(tmp_path), "--continuous",
            "--worker_id"]
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv + ["w0"])
    with pytest.raises(SystemExit):
        main(argv + ["w:0"])


def test_fleet_phases_hold_their_own_audit():
    """chip_smoke.py's fleet phases, and the helpers they call, name
    nothing of the JAX package: their exactly-once audit is their own
    (``_fleet_pass``), not ``llmss_tpu/sim/invariants.py``'s."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    fleet = [name for name in funcs if "fleet" in name]
    assert {"phase_reference_fleet", "phase_serve_fleet", "_fleet_pass",
            "_fleet_rehearsal"} <= set(fleet)
    for name in fleet:
        src = ast.unparse(funcs[name])
        names = {n.id for n in ast.walk(funcs[name]) if isinstance(n, ast.Name)}
        mods = {(n.module or "") for n in ast.walk(funcs[name])
                if isinstance(n, ast.ImportFrom)}
        assert not {m for m in mods if m.split(".")[0] != "llmss_tpu_torch"}, name
        assert "invariants" not in src and "audit_exactly_once" not in names
    assert "answered twice" in ast.unparse(funcs["_fleet_pass"])


def test_telemetry_modules_hold_the_boundaries():
    """``utils/devtel.py``, ``utils/signatures.py``, ``serve/controller.py``
    and the producer, imported in a fresh interpreter with a producer
    serving every endpoint, load neither ``jax``, the JAX package,
    ``redis`` nor ``fastapi``."""
    code = (
        "import json, sys, urllib.request\n"
        "import llmss_tpu_torch.utils.devtel, llmss_tpu_torch.utils.signatures\n"
        "import llmss_tpu_torch.serve.controller as c\n"
        "from llmss_tpu_torch.serve.broker import InProcBroker\n"
        "from llmss_tpu_torch.serve.producer import ProducerServer\n"
        "srv = ProducerServer(InProcBroker(), host='127.0.0.1', port=0)\n"
        "srv.controller = c.FleetController(srv.broker, spawn=str,\n"
        "    retire=str, read_telemetry=c.producer_telemetry(srv))\n"
        "srv.start()\n"
        "codes = []\n"
        "for p in ('/slo', '/compiles', '/fleet', '/fleet/timeseries',\n"
        "          '/metrics', '/metrics?format=prometheus', '/dlq',\n"
        "          '/trace/slowest', '/trace/export_workload', '/health'):\n"
        "    with urllib.request.urlopen(f'http://127.0.0.1:{srv.port}{p}') as r:\n"
        "        codes.append(r.status)\n"
        "srv.controller.tick(now=0.0)\n"
        "srv.stop()\n"
        "bad = [m for m in ('jax', 'jaxlib', 'llmss_tpu', 'redis', 'fastapi')\n"
        "       if m in sys.modules]\n"
        "print(json.dumps({'codes': codes, 'bad': bad}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, timeout=120,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"codes": [200] * 10, "bad": []}


def test_profiler_is_reached_only_when_a_profile_is_asked_for(monkeypatch,
                                                              tmp_path):
    """No port module imports ``torch.profiler`` at its top level
    (``profile_trace`` does, when called), and a producer serving every
    GET endpoint never starts a profiler; ``POST /profile`` does."""
    for rel in ("utils/metrics.py", "utils/devtel.py", "utils/trace.py",
                "serve/producer.py", "serve/controller.py"):
        tree = ast.parse((ROOT / "llmss_tpu_torch" / rel).read_text())
        for node in tree.body:
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            assert not [n for n in names if "profiler" in n], rel
    import urllib.request

    import torch.profiler

    from llmss_tpu_torch.serve import producer as producer_mod
    from llmss_tpu_torch.serve.broker import InProcBroker
    from llmss_tpu_torch.serve.producer import ProducerServer

    started = []

    class Probe:
        def __init__(self, *a, **kw):
            started.append(kw)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def export_chrome_trace(self, path):
            Path(path).write_text("{}")

    monkeypatch.setattr(torch.profiler, "profile", Probe)
    srv = ProducerServer(InProcBroker(), host="127.0.0.1", port=0)
    srv.start()
    try:
        for p in ("/slo", "/compiles", "/fleet", "/metrics",
                  "/metrics?format=prometheus", "/trace/slowest"):
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{p}").read()
        assert started == []
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/profile",
            data=json.dumps({"duration_s": 0.1,
                             "log_dir": str(tmp_path)}).encode())
        with urllib.request.urlopen(req) as r:
            assert r.status == 202
        end = time.monotonic() + 30
        while producer_mod._PROFILE_ACTIVE and time.monotonic() < end:
            time.sleep(0.02)
        assert len(started) == 1 and (tmp_path / "trace.json").exists()
    finally:
        srv.stop()


def test_parallel_modules_are_covered():
    """The mesh (parallel/) and the ring module are among the files whose
    imports the first test checks: no JAX, nothing of the JAX package."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"llmss_tpu_torch/parallel/mesh.py",
            "llmss_tpu_torch/parallel/sharding.py",
            "llmss_tpu_torch/parallel/launch.py",
            "llmss_tpu_torch/parallel/smoke.py",
            "llmss_tpu_torch/ops/ring_attention.py"} <= names


def test_mesh_defaults_to_gpu_and_raises_without_one(no_gpu):
    """``make_mesh``, ``initialize_runtime`` and the smoke run default to
    the GPU (NCCL) and raise without one; the CPU (gloo) only when
    asked."""
    from llmss_tpu_torch.parallel import initialize_runtime, make_mesh
    from llmss_tpu_torch.parallel.mesh import default_backend, rank_device
    from llmss_tpu_torch.parallel.smoke import main as smoke_main

    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        initialize_runtime()
    with pytest.raises(RuntimeError, match="CUDA"):
        smoke_main(["--process-id", "0", "--num-processes", "1",
                    "--coordinator", "file:///nonexistent/rdv"])
    assert default_backend(torch.device("cuda")) == "nccl"
    assert default_backend(rank_device("cpu")) == "gloo"


def test_collectives_stage_through_the_host_only_under_gloo_on_cuda():
    """Host staging is gloo over CUDA tensors, and nothing else: never
    under NCCL, never on the CPU; and only NCCL meshes capture graphs."""
    from llmss_tpu_torch.parallel import Mesh

    def mesh(backend, device):
        return Mesh((1, 1, 2), (0, 0, 0), device, backend=backend)

    assert mesh("gloo", "cuda").host_staged
    assert not mesh("nccl", "cuda").host_staged
    assert not mesh("gloo", "cpu").host_staged
    assert mesh("nccl", "cuda").capturable
    assert not mesh("gloo", "cuda").capturable


def test_state_out_wrappers_take_cuda_tensors_only():
    """K1's and K2's state-out forms launch or raise: a CPU tensor never
    reaches their plain versions through them."""
    from llmss_tpu_torch.ops.decode_attention import decode_attention_state
    from llmss_tpu_torch.ops.flash_attention import flash_attention_state

    q = torch.zeros(1, 16, 2, 64)
    pos = torch.zeros(1, 16, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        flash_attention_state(q, q, q, pos, pos)
    cache = torch.zeros(1, 1, 16, 2, 64)
    q1 = torch.zeros(1, 1, 2, 64)
    p1 = torch.zeros(1, 1, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        decode_attention_state(q1, cache, cache, p1, pos, p1, 0)
