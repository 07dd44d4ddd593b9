"""Multi-process smoke run: one prefill and a few decode steps over a tp
mesh that spans processes (counterpart: tools/multiprocess_smoke.py).

Every process runs this same program; they rendezvous at
``--coordinator`` (``host:port`` or ``file:///path``), build a mesh whose
tp axis is the whole world, draw the same random weights from a seed and
keep their slices, and run SPMD: every row-parallel ``psum`` and the head's
``all_gather`` is a real collective between the processes.

    python -m llmss_tpu_torch.parallel.smoke --process-id 0 \\
        --num-processes 2 --coordinator localhost:9911 &
    python -m llmss_tpu_torch.parallel.smoke --process-id 1 \\
        --num-processes 2 --coordinator localhost:9911

Each prints ``mpsmoke ok pid=N processes=2 devices=2 toks=[...]``; the
token lists must be equal (tests/test_torch_multiprocess.py asserts it).
``--device`` defaults to the GPU (its backend NCCL, which needs a card
per rank); ``--device cpu`` runs gloo.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("llmss-torch-mpsmoke")
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, choices=[None, "nccl", "gloo"])
    args = ap.parse_args(argv)

    import torch

    from llmss_tpu_torch.engine.engine import DecodeEngine, GenerationParams
    from llmss_tpu_torch.models.common import DecoderConfig
    from llmss_tpu_torch.models.decoder import init_params
    from llmss_tpu_torch.parallel import MeshPlan, initialize_runtime, make_mesh
    from llmss_tpu_torch.parallel.sharding import shard_params

    initialize_runtime(args.coordinator, args.num_processes, args.process_id,
                       backend=args.backend, device=args.device)
    mesh = make_mesh(MeshPlan(tp=args.num_processes), device=args.device,
                     backend=args.backend)
    cfg = DecoderConfig(
        model_type="llama", vocab_size=64, hidden_size=256, n_layers=2,
        n_heads=4, n_kv_heads=4, head_dim=64, intermediate_size=512,
        max_position_embeddings=64, activation="silu", norm="rmsnorm",
        norm_eps=1e-5, mlp="swiglu", positions="rotary", rope_style="half",
        rotary_dim=64, attn_bias=False, mlp_bias=False,
        tie_word_embeddings=False, dtype="float32",
    )
    params = shard_params(init_params(cfg, seed=0, device=mesh.device), cfg,
                          mesh)
    engine = DecodeEngine(cfg, params, mesh=mesh, max_seq_len=32)
    dev = mesh.device
    ids = torch.tensor([[1, 2, 3, 4, 5, 6, 7, 8] + [0] * 8],
                       dtype=torch.int32, device=dev)
    lens = torch.tensor([8], dtype=torch.int32, device=dev)
    sa = engine._sample_args(GenerationParams(is_greedy=True), 1)
    cache = engine.new_cache(1)
    tok, _ = engine._prefill(ids, cache, lens, sa)
    toks = [int(tok[0])]
    cur = torch.tensor([8], dtype=torch.int32, device=dev)
    for _ in range(3):
        tok, _ = engine._decode(tok, cache, cur, sa)
        toks.append(int(tok[0]))
        cur = cur + 1
    print(f"mpsmoke ok pid={args.process_id} processes={mesh.world} "
          f"devices={mesh.world} toks={toks}", flush=True)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
