"""Multi-process runs of the port (counterpart: tests/test_multiprocess.py):
real ``torch.distributed`` rendezvous between OS processes on the CPU
(gloo, a ``file://`` rendezvous in the test's directory, so parallel test
workers never race for a port).

- Two ``python -m llmss_tpu_torch.parallel.smoke`` processes build a tp
  mesh over both and run one prefill and three decode steps: both print
  ``mpsmoke ok`` with equal tokens, and those are the tokens of the same
  model on one process.
- The CLI under two processes (``--tp 2``, each rank reading its slices
  of a tiny llama checkpoint written here in the HF names) prints the
  single-process CLI's tokens, from rank 0 alone.
"""

import json
import os
import re
import struct
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
TOKEN_IDS = ["5,9,23,40,7,1", "17,4"]


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("RANK", "WORLD_SIZE", "LOCAL_RANK",
                                "MASTER_"))}
    env["PYTHONPATH"] = str(REPO)
    return env


def _run_pair(argv_of, timeout=300):
    """Start two processes (``argv_of(rank)``) and return their outputs."""
    procs = [subprocess.Popen([sys.executable, *argv_of(r)], cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env=_env()) for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {r} failed:\n{out}"
    return outs


def _write_llama(d: Path) -> None:
    """A tiny llama checkpoint in the HF names and layouts (safetensors
    written by hand, ``config.json``), whose vocabulary of 97 two ranks
    split unevenly."""
    V, E, I, L, H, Hkv, D = 97, 64, 96, 2, 4, 2, 16
    g = torch.Generator().manual_seed(0)
    shapes = {"model.embed_tokens.weight": (V, E),
              "model.norm.weight": (E,), "lm_head.weight": (V, E)}
    for i in range(L):
        pre = f"model.layers.{i}"
        shapes.update({
            f"{pre}.self_attn.q_proj.weight": (H * D, E),
            f"{pre}.self_attn.k_proj.weight": (Hkv * D, E),
            f"{pre}.self_attn.v_proj.weight": (Hkv * D, E),
            f"{pre}.self_attn.o_proj.weight": (E, H * D),
            f"{pre}.mlp.gate_proj.weight": (I, E),
            f"{pre}.mlp.up_proj.weight": (I, E),
            f"{pre}.mlp.down_proj.weight": (E, I),
            f"{pre}.input_layernorm.weight": (E,),
            f"{pre}.post_attention_layernorm.weight": (E,)})
    header, blobs, off = {}, [], 0
    for name, shape in shapes.items():
        t = torch.randn(shape, generator=g) * (0.3 if len(shape) > 1 else 0.1)
        if len(shape) == 1:
            t = t + 1.0
        b = t.numpy().astype("<f4").tobytes()
        header[name] = {"dtype": "F32", "shape": list(shape),
                        "data_offsets": [off, off + len(b)]}
        blobs.append(b)
        off += len(b)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    (d / "model.safetensors").write_bytes(
        struct.pack("<Q", len(head)) + head + b"".join(blobs))
    (d / "config.json").write_text(json.dumps(dict(
        model_type="llama", vocab_size=V, hidden_size=E,
        intermediate_size=I, num_hidden_layers=L, num_attention_heads=H,
        num_key_value_heads=Hkv, max_position_embeddings=64,
        rms_norm_eps=1e-5, tie_word_embeddings=False)))


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    _write_llama(d)
    return d


def _cli(ckpt, *extra):
    return ["-m", "llmss_tpu_torch.cli.generate", "--pretrained_model_path",
            str(ckpt), "--device", "cpu", "--dtype", "float32",
            "--token_ids", *TOKEN_IDS, "--max_new_tokens", "6",
            "--is_greedy", *extra]


def _continuations(out: str) -> list[str]:
    return re.findall(r"continuation ids: (\[[^\]]*\])", out)


def test_two_process_smoke_emits_equal_tokens(tmp_path):
    rdv = f"file://{tmp_path / 'rdv'}"
    outs = _run_pair(lambda r: [
        "-m", "llmss_tpu_torch.parallel.smoke", "--process-id", str(r),
        "--num-processes", "2", "--coordinator", rdv, "--device", "cpu"])
    for r, out in enumerate(outs):
        assert f"mpsmoke ok pid={r} processes=2 devices=2" in out, out
    toks = [re.search(r"toks=(\[[^\]]*\])", o).group(1) for o in outs]
    assert toks[0] == toks[1], toks

    # The same model on one process (a mesh of one rank) draws them too.
    one = subprocess.run(
        [sys.executable, "-m", "llmss_tpu_torch.parallel.smoke",
         "--process-id", "0", "--num-processes", "1", "--coordinator",
         f"file://{tmp_path / 'one'}", "--device", "cpu"], cwd=REPO,
        env=_env(), capture_output=True, text=True, timeout=300)
    assert one.returncode == 0, one.stderr
    assert f"toks={toks[0]}" in one.stdout, one.stdout


def test_cli_on_two_processes_gives_the_single_process_tokens(checkpoint,
                                                              tmp_path):
    single = subprocess.run([sys.executable, *_cli(checkpoint)], cwd=REPO,
                            env=_env(), capture_output=True, text=True,
                            timeout=300)
    assert single.returncode == 0, single.stderr
    want = _continuations(single.stdout)
    assert len(want) == 2
    rdv = f"file://{tmp_path / 'rdv'}"
    outs = _run_pair(lambda r: _cli(
        checkpoint, "--tp", "2", "--coordinator", rdv, "--num_processes",
        "2", "--process_id", str(r)))
    assert _continuations(outs[0]) == want
    assert "tp=2" in outs[0]
    assert _continuations(outs[1]) == []  # rank 0 alone prints
