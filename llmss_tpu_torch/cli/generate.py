"""CLI generation entry point (counterpart: llmss_tpu/cli/generate.py:29-169).

Same flags as the reference, plus ``--device`` (default ``cuda``); any
family of ``models/registry.MODEL_REGISTRY`` loads.
``--kv_dtype int8`` stores the KV cache quantized (engine/cache.py). The
port refuses, with a message, what it does not run yet: ``--speculative``,
the ``--sp``/``--tp``/``--dp`` mesh flags, and ``--prompts`` (text needs a
tokenizer, which the port does not have: it takes ``--token_ids``).

    python -m llmss_tpu_torch.cli.generate --pretrained_model_path DIR \\
        --token_ids 1,2,3,4 --max_new_tokens 8 --is_greedy
"""

from __future__ import annotations

import argparse
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
    parser.add_argument("--speculative", type=int, default=0, metavar="GAMMA")
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def _refuse_unported(args) -> None:
    if args.speculative:
        raise SystemExit("--speculative is not supported by the torch port yet")
    if args.sp != 1 or args.dp != 1 or args.tp not in (None, 1):
        raise SystemExit(
            "--sp/--tp/--dp: the torch port runs one model on one device"
        )
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


def main(argv=None):
    args = get_args(argv)
    _refuse_unported(args)
    _validate(args)
    start = time.monotonic()

    from llmss_tpu_torch.engine.engine import DecodeEngine, GenerationParams
    from llmss_tpu_torch.models.registry import load_model

    cfg, params = load_model(
        args.pretrained_model_path, device=args.device, dtype=args.dtype
    )
    prompts = [[int(t) for t in s.split(",")] for s in args.token_ids]

    engine = DecodeEngine(
        cfg, params, device=args.device, kv_dtype=args.kv_dtype,
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
    out = engine.generate(
        prompts, gen,
        on_token=lambda step, toks: first_token_at.append(time.monotonic())
        if step == 0 else None,
    )
    t1 = time.monotonic()

    n_generated = sum(len(o) for o in out)
    for i, (p, o) in enumerate(zip(prompts, out)):
        print(f"[{i}] prompt ids: {p}")
        print(f"[{i}] continuation ids: {o}")
    elapsed = time.monotonic() - start
    ttft = (
        f"ttft: {(first_token_at[0] - t0) * 1000:.1f}ms | "
        if first_token_at else ""
    )
    print(
        f"elapsed: {elapsed:.2f}s | generation: {t1 - t0:.2f}s | " + ttft
        + f"throughput: {n_generated / max(t1 - t0, 1e-9):.1f} tok/s "
        f"on {engine.device}"
    )
    return out


if __name__ == "__main__":
    main()
