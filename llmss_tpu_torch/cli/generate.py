"""CLI generation entry point (counterpart: llmss_tpu/cli/generate.py:29-169).

Same flags as the reference, plus ``--device`` (default ``cuda``); any
family of ``models/registry.MODEL_REGISTRY`` loads.
``--kv_dtype int8`` stores the KV cache quantized (engine/cache.py).
``--speculative GAMMA`` (greedy only) runs prompt-lookup speculative
decoding with GAMMA drafted tokens per verify forward
(engine/speculative.py) and adds a ``speculation: ... tok/verify`` figure.
The port refuses ``--prompts`` (text needs a tokenizer, which the port
does not have: it takes ``--token_ids``).

On a mesh (``--tp`` / ``--dp`` / ``--sp``, parallel/mesh.py) every rank
runs this program: launched by ``torchrun`` (its environment names the
world), or with ``--coordinator`` (``host:port`` or ``file:///path``),
``--num_processes`` and ``--process_id``. Each rank loads only its slices
of the checkpoint; rank 0 prints the answer. ``--backend`` defaults to
``nccl`` on CUDA and ``gloo`` on the CPU.

    python -m llmss_tpu_torch.cli.generate --pretrained_model_path DIR \\
        --token_ids 1,2,3,4 --max_new_tokens 8 --is_greedy
    torchrun --nproc_per_node 2 -m llmss_tpu_torch.cli.generate --tp 2 \\
        --pretrained_model_path DIR --token_ids 1,2,3,4 --is_greedy
"""

from __future__ import annotations

import argparse
import os
import time


def get_args(argv=None):
    parser = argparse.ArgumentParser("llmss-torch-generate")
    parser.add_argument("--pretrained_model_path", type=str, required=True)
    parser.add_argument("--prompts", type=str, nargs="+", default=None)
    parser.add_argument(
        "--token_ids", type=str, nargs="+", default=None,
        help="comma-separated token id lists; bypasses the tokenizer",
    )
    parser.add_argument("--max_new_tokens", type=int, default=20)
    parser.add_argument("--is_greedy", action="store_true")
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--top_p", type=float, default=1.0)
    parser.add_argument("--top_k", type=int, default=0)
    parser.add_argument(
        "--use_cache", type=lambda s: s.lower() != "false", default=True
    )
    parser.add_argument("--tp", type=int, default=None)
    parser.add_argument("--dp", type=int, default=1)
    parser.add_argument("--sp", type=int, default=1)
    parser.add_argument("--dtype", type=str, default="bfloat16")
    parser.add_argument(
        "--kv_dtype", type=str, default=None, choices=[None, "int8"],
        help="int8 = quantized KV cache (half the KV bytes; "
             "per-token-per-head scales)",
    )
    parser.add_argument("--max_seq_len", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--speculative", type=int, default=0, metavar="GAMMA",
        help="prompt-lookup speculative decoding with GAMMA drafted "
             "tokens per step (greedy only; 0 = off)",
    )
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument(
        "--coordinator", type=str, default=None,
        help="the world's rendezvous (host:port or file:///path) when not "
             "launched by torchrun",
    )
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument(
        "--backend", type=str, default=None, choices=[None, "nccl", "gloo"],
        help="the process group's (default: nccl on CUDA, gloo on the CPU)",
    )
    return parser.parse_args(argv)


def _on_mesh(args) -> bool:
    """Whether this run is one rank of a mesh: a mesh flag, an explicit
    rendezvous or torchrun's environment."""
    return (args.sp != 1 or args.dp != 1 or args.tp not in (None, 1)
            or args.coordinator is not None or "RANK" in os.environ)


def _refuse_unported(args) -> None:
    if args.prompts:
        raise SystemExit("--prompts needs a tokenizer, which the torch port "
                         "does not have yet; pass --token_ids")
    if not args.token_ids:
        raise SystemExit("--token_ids is required")


def _validate(args) -> None:
    # Checked before the model load so a bad flag fails in milliseconds.
    if not args.temperature > 0.0:
        raise SystemExit("--temperature must be > 0")
    if args.top_k < 0:
        raise SystemExit("--top_k must be >= 0")
    if not 0.0 < args.top_p <= 1.0:
        raise SystemExit("--top_p must be in (0, 1]")
    if args.speculative < 0:
        raise SystemExit("--speculative must be >= 0")
    if args.speculative > 0 and not args.is_greedy:
        raise SystemExit("--speculative requires --is_greedy")


def main(argv=None):
    args = get_args(argv)
    _refuse_unported(args)
    _validate(args)
    start = time.monotonic()

    from llmss_tpu_torch.engine.engine import DecodeEngine, GenerationParams
    from llmss_tpu_torch.models.registry import load_model

    mesh = None
    if _on_mesh(args):
        from llmss_tpu_torch.parallel import (
            MeshPlan, initialize_runtime, make_mesh,
        )

        initialize_runtime(args.coordinator, args.num_processes,
                           args.process_id, backend=args.backend,
                           device=args.device)
        try:
            mesh = make_mesh(MeshPlan(dp=args.dp, sp=args.sp, tp=args.tp),
                             device=args.device, backend=args.backend)
        except ValueError as e:
            raise SystemExit(f"--tp/--dp/--sp: {e}") from None
    cfg, params = load_model(
        args.pretrained_model_path,
        device=None if mesh is not None else args.device, dtype=args.dtype,
        mesh=mesh,
    )
    prompts = [[int(t) for t in s.split(",")] for s in args.token_ids]

    engine = DecodeEngine(
        cfg, params, device=None if mesh is not None else args.device,
        kv_dtype=args.kv_dtype, mesh=mesh,
        max_seq_len=args.max_seq_len
        or min(cfg.max_position_embeddings,
               max(len(p) for p in prompts) + args.max_new_tokens),
    )
    gen = GenerationParams(
        max_new_tokens=args.max_new_tokens, is_greedy=args.is_greedy,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        seed=args.seed,
    )
    t0 = time.monotonic()
    first_token_at = []
    if args.speculative > 0:
        out = engine.generate_speculative(prompts, gen,
                                          gamma=args.speculative)
    else:
        out = engine.generate(
            prompts, gen,
            on_token=lambda step, toks: first_token_at.append(
                time.monotonic()) if step == 0 else None,
        )
    t1 = time.monotonic()

    if mesh is not None:
        import torch.distributed as dist

        # Every rank tears its process group down, once all have finished:
        # a group left to the interpreter's exit can abort the process.
        rank = dist.get_rank()
        dist.barrier()
        dist.destroy_process_group()
        if rank != 0:
            return out  # rank 0 prints the answer
    n_generated = sum(len(o) for o in out)
    for i, (p, o) in enumerate(zip(prompts, out)):
        print(f"[{i}] prompt ids: {p}")
        print(f"[{i}] continuation ids: {o}")
    elapsed = time.monotonic() - start
    ttft = (
        f"ttft: {(first_token_at[0] - t0) * 1000:.1f}ms | "
        if first_token_at else ""
    )
    spec = ""
    if args.speculative > 0 and engine.metrics.spec_stats:
        rate = engine.metrics.spec_stats["mean_tokens_per_forward_per_row"]
        spec = f"speculation: {rate} tok/verify | "
    print(
        f"elapsed: {elapsed:.2f}s | generation: {t1 - t0:.2f}s | " + ttft
        + spec + f"throughput: {n_generated / max(t1 - t0, 1e-9):.1f} tok/s "
        f"on {engine.device}" + (f" ({mesh!r})" if mesh is not None else "")
    )
    return out


if __name__ == "__main__":
    main()
