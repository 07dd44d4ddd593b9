"""GPU smoke run of the PyTorch/CUDA port (llmss_tpu_torch) on one card.

    python3 chip_smoke.py [--order NAME]

(``--order``: one of ``ORDERS``, the phase orders of runs that once lost
profiler records; default: the order below.)

Phases, each printing one JSON line; any failure raises and the script
exits non-zero without printing a result:

1. device  -- needs CUDA; prints the card's name and power limit;
2. build   -- compiles every kernel of the path (one nvcc per source, in
              parallel) from the sources in this checkout, lists the
              registers and spills of the tensor-core, decode and int8
              lane instantiations, and fails if the int8 lane
              instantiations' SASS holds a conversion instruction other
              than an integer division's (cuobjdump);
3. kernels -- K1 (prefill flash attention), K2 (stacked-cache decode), K3
              (paged decode) and K4 (ragged paged attention) against their
              plain PyTorch versions on the card, at the Llama-2-7B path
              shapes plus GQA / padding / ring-wrap / window / empty-row /
              long-row / tile-edge / block-size / head-dim / dtype cases
              and the gptj_6b / starcoder phases' shapes,
              with kernel, plain, bound and library
              (scaled_dot_product_attention, timed as a yardstick only)
              times, the instantiation each case took ("wgmma": K1's
              Hopper tile, with its tile classes "tiles"; "mma": the
              tensor-core tile; "group": the group tile K2 / K3 take at
              2-16 query heads per KV head; "fma" / "lanes": the fp32
              and CB = 1 kernels) and, for K2 / K3, its split along the
              KV axis (flash-decoding: "splits", "split_slots") beside
              the same call launched unsplit ("unsplit_ms", checked too)
              and, at G 1, 2, 3, 4, 7, 8, 16 and 48, on each of the three
              decode templates ("g_tile_lanes_vs_tile"); K2, K3
              and K4 also over int8 caches with their scales
              ("lanes_int8"; K4 with bf16 queries at CB > 1 "mma_int8",
              the tensor-core tile over int8 tiles; library: dequantize
              + SDPA), with K2 / K3 int8 over K2 / K3 at the main path's
              decode shapes ("int8_lanes_vs_bf16", a measurement); and
              K2w (the speculative verify window's attention) at the
              speculative phase's shape (batch 16, window 5, the 384-slot
              bucket) plus a window wrapping the ring's end, invalidated
              slots, an empty row, windows of 2 and 8, GQA G 4 and 7 and
              StarCoder's G 48, D 64 and 256 (bf16: the window tile, with
              its rows per block, slot warps and cluster) and fp32 (the
              lanes) (library: SDPA over the layer's slice and the fresh
              KV), each with its bound share; at the verify shape the tile
              also at 1-3 forced splits folded in its cluster and by a
              second launch ("cluster_ms", "two_launch_ms"); timed as a
              phase of its own; then the mesh's kernels (check_mesh_kernels):
              K1 and K2 at the local heads of tp 2 and 4 at the engine
              phase's shapes, and their state-out forms (each query row's
              fp32 softmax state over one KV chunk) at the sp = 2 chunk
              shapes, against the plain versions' states (K2's folded
              in its launch: nothing but split_merge after the kernel),
              and K3 / K4 at the 16 KV heads a tp 2 rank's pool holds
              (bf16 and int8) at serve_parallel's shapes;
4. reference -- a tiny fp32 llama generates the same greedy tokens through
              the kernels on the card, decoding by CUDA-graph replays, as
              through the plain path on the CPU;
   reference_paged -- the same through the continuous batcher over the
              paged pool, with split admission and with chunked prefill;
   reference_int8 -- the same, dense and paged, over int8 caches;
   reference_prefix -- shared-prefix reuse on the same model:
              ``generate(prefix=)``, and the batcher with copy-on-write
              prefix blocks (split, chunked; fp32 and int8): card tokens
              equal the CPU's, and on fp32 the tokens without the prefix;
   reference_priority -- preemption on the same kind of model: a
              two-row batcher, dense (K1 + K2), paged split (K1 + K3) and
              chunked (K4 + K3): the card's tokens and victims equal the
              CPU's, and the evicted request, resumed by replaying its
              tokens, gets its tokens without preemption;
   reference_roles -- a prefill-role and a decode-role ContinuousWorker
              (split and chunked, fp32 and int8 pools): the card's
              answers equal the CPU's and a unified worker's;
   reference_fleet -- two paged ContinuousWorkers w0 and w1 on their own
              engines under a port Router (serve/fleet.py), split then
              chunked: the serve_fleet traffic at tiny size under
              prefix_affinity, least_loaded and round_robin, then with w1
              stopped after its first group and failed over: the card's
              tokens, the Router's picks and stats and each worker's
              prefix builds equal the CPU's in every pass;
   reference_telemetry -- the telemetry plane: a split and a chunked
              paged ContinuousWorker serve 8 requests of the three SLO
              classes; the card's tokens, windowed request / token totals,
              cost histogram counts, compile events (the graph captures),
              steady-state recompiles (0) and each request's timeline
              phases equal the CPU's;
   reference_speculative -- prompt-lookup speculative decoding on the
              tiny fp32 llama (K2w verify windows, K2 on the plain tail),
              the same over an int8 cache and a tiny Mistral with a sliding
              window (both verify through K1), gamma 1 and 4: card tokens
              equal the CPU's speculative tokens and the card's generate
              tokens, spec_stats equal the CPU's; then an engine with
              nothing prewarmed whose rows cross into a new bucket between
              groups (a capture mid-call), held the same way;
   reference_parallel -- worlds of ranks sharing the card over gloo with
              CUDA tensors (host-staged): tp 2, sp 2, dp 2, tp 4 and
              dp 2 x sp 2 x tp 2, each over tiny fp32 llama, gpt_bigcode
              and gpt2 models (GQA, MQA with learned positions, an uneven
              tied vocabulary): every rank's card tokens equal the port's
              single-process CPU tokens, no graph captured under gloo;
              then the GQA and MQA families' paged batcher on tp 2
              and dp 2 x tp 2 (rank 0 leads, parallel/serving.py), split
              and chunked
              passes with admissions mid-stream, a cancel and a shared
              prefix: every rank's tokens equal the CPU batcher's, the
              ranks' host digests equal at every step, every pool
              drained;
   reference_families -- the same for a tiny fp32 model of every family
              of the registry (GPT-J, GPT-BigCode, GPT-2, Llama, Mistral,
              Qwen2, GPT-NeoX, Phi-3 with LongRoPE on both sides of its
              original context, Gemma), dense and paged with chunked
              prefill, after prewarm, with no capture after it;
5. engine  -- Llama-2-7B width (hidden 4096, 32 layers, 32 heads, head_dim
              128, intermediate 11008, vocab 32000), random weights from a
              seed, bf16, max_seq_len 1024, batch 4: ``prewarm`` captures
              every decode step graph, then grouped decode (chunk_steps=8,
              one sampled row) twice with identical tokens, greedy
              chunk_steps=1, and ``generate_fused`` (greedy and sampled)
              with generate's tokens, then ``generate(prefix=)`` of a
              512-token prefix (K1 at q0 512) beside the same prompts from
              scratch (equal-token share, first-token logits within 5%),
              all with no new graph capture; the launch counters must rise
              by n_layers per prefill (K1) and per decode step replayed
              (K2);
   profile -- one prefill, and one 8-step decode chunk by graph replays
              beside the same steps run eagerly from the same state (same
              tokens): wall, host enqueue, device kernel time, idle share,
              top kernels;
6. serve   -- the port's batch Worker, prewarmed, over its in-process
              broker answers 4 requests (2 greedy, 1 top-k/top-p sampled, 1
              streamed) with no new graph capture;
   serve_continuous -- the serving main path: two ContinuousWorkers at
              Llama-2-7B width (split admission; chunked prefill), each
              prewarmed, answer 16 requests three times (split, chunked,
              chunked again: same tokens) with no new graph capture;
   serve_http -- the same requests over HTTP: ProducerServer on
              127.0.0.1:0, a supervised chunked ContinuousWorker built by
              a factory whose first worker crashes (one restart, within
              one pool of the memory before it), two SSE requests and one
              cancelled by POST /cancel; answers equal to the in-process
              chunked pass's, /metrics (JSON and Prometheus), /dlq, and
              /health 200 while serving, 503 after the drain; the front
              end's cost against the in-process pass;
   profile -- one paged decode group (graph replays beside the eager
              steps, same tokens) and one ragged group (eager);
   serve_prefix -- 16 requests on one 600-token system prompt through
              prewarmed ContinuousWorkers: without the hint, with
              ``prefix_token_ids`` (split; chunked twice, same tokens),
              then an eviction; per pass wall, tokens/s, TTFT, K1 / K4
              prompt tokens, peak blocks and rows, launches; 37 blocks
              held once idle, 0 after the eviction;
   serve_priority -- preemption at Llama-2-7B width, 8 of its 32
              layers: 8 batch-class
              requests, then 4 interactive ones, through a prewarmed
              8-row worker, split and chunked, with and without
              preemption: the victims equal a CPU rehearsal of the same
              schedule, the broker's refunds, interactive TTFT, batch
              completion, no capture, every block back;
   serve_roles -- the serve_continuous requests through a prefill-role
              and a decode-role worker on one card (each prewarmed, no
              capture): handoffs and their bytes, per-request export /
              encode / decode / import ms, wall, tokens/s and TTFT beside
              the unified passes, and the longest request alone equal to
              a unified worker's tokens with its adopted blocks read back
              equal to the exported bytes;
   serve_fleet -- the fleet at Llama-2-7B width: ContinuousWorkers w0 and
              w1, each on its own engine over the same weights with a
              320-block pool, prewarmed, heartbeating every 50 ms under a
              Router, driven in turns from this thread: 16 requests on four
              600-token system prompts (p0 p0 p1 p1 p2 p2 p3 p3, twice)
              under each policy, split and chunked, then prefix_affinity
              with w0 stopped after its first group (its heartbeat goes
              stale and the Router fails its leased and routed work over
              to w1): every request answered once, routing, prefix builds
              and failover re-routes equal to a CPU rehearsal, K1 / K3 /
              K4 launches against the prefills and steps, no capture,
              every block back; per pass wall, tokens/s, TTFT, K1 / K4
              prompt tokens, builds and peak blocks per worker,
              routed_by_worker, affinity_hit_rate, the card and its power
              limit; the killed pass also kill-to-last-answer seconds and
              the re-routed requests' share of tokens equal to the unkilled
              pass's;
   serve_telemetry -- the telemetry plane at Llama-2-7B width: the 16
              serve_continuous requests POSTed to ProducerServer, split
              then chunked, each pass followed by /slo (16 in the window,
              the ttft_s count = the answers), /compiles (0 steady-state
              recompiles = the captures after prewarm), /metrics in
              Prometheus text (mfu_* / mbu_*, printed clamped beside the
              passes' unclamped means and the predictions) and a Chrome
              trace with its counter tracks; POST /profile over a chunked
              pass (its kernels name K3 and K4); the chunked pass with the
              plane on and off in turns (walls, host us per group of the
              fold and of the counter sampling); then the FleetController
              over producer_telemetry: an interactive burst under a TTFT
              objective below the split pass's p50 scales w0 alone to w0
              + w1 (built and prewarmed by ``spawn``, run by a
              Supervisor) and, once idle, back (w1 drained through its
              Supervisor), every request answered once;
   int8    -- the engine's generate (prewarmed, no capture after) and one
              chunked serving pass (a 496-block int8 pool) on int8 caches
              at Llama-2-7B width: cache bytes against bf16's (<= 0.52x),
              the share of tokens equal to the bf16 runs', and a decode
              chunk profiled (only int8 decode_fwd instantiations);
   head_groups -- Qwen2-7B (G = 7), SantaCoder (G = 16) and StarCoder
              over an int8 cache (G = 48) at full width, 2 layers: prewarm,
              generate, and the dense and paged decode steps profiled
              (graph and eager) with the decode template each takes, its
              kernel ms a step and the decode kernels' share;
   gptj_6b, starcoder -- the published configs of EleutherAI/gpt-j-6b
              (D 256, untied biased head) and bigcode/starcoder (48 query
              heads on one KV head, learned positions) at full width and
              an eighth of their depth (4 and 5 layers), random bf16
              weights from a seed: prewarm, generate
              twice (identical tokens, launch counts, no capture), prefill
              and decode chunk profiled against the weight-read bound, a
              split and a chunked ContinuousWorker pass, a paged decode
              group and a ragged group profiled, and each kernel's case
              at the model's shapes beside its launches; starcoder also
              one short generate_speculative call (K2w on the tile);
7. cli     -- writes a 2-layer llama checkpoint at 1b2 width
              (safetensors + config.json) and runs the port's CLI on it;
              then 2-layer GPT-J-6B and StarCoder checkpoints in HF names
              and layouts (StarCoder's c_attn fused), each through the CLI
              and load_model, the loaded tensors held to the written
              ones; and the llama checkpoint with --speculative 4 (64 new
              tokens on a 71-slot ring: a capture mid-call), its tokens'
              agreement with the plain run reported;
   speculative -- the engine phase's weights (its seed) at batch 16,
              128-token prompts, 256 new tokens, ring 1024:
              ``prewarm(speculative=(1, 4))``, then plain greedy generate
              and generate_speculative at gamma 1 and 4 with no capture
              after the prewarm: tokens/s, tokens per verify forward,
              agreement with generate, K2w launches, one verify step's
              kernel time against one decode step's. After the cli, so
              every profiled phase before it runs in the parent's order.
8. reference_tiers -- the tiered KV store on the tiny fp32 llama: two
              sessions of three turns parked and resumed, prefixes
              demoted and promoted through an LRU of one (and a 3-block
              pool), dense, paged split and chunked, fp32 and int8, and
              T1 capped at 0: card tokens and store counts equal the
              CPU's, fp32 tokens equal the card's without a store;
   serve_tiers -- the store at Llama-2-7B width, 8 layers (its seed,
              serve_continuous's pool, a fresh engine): prefix waves on four
              600-token system prompts without a store, with T1 at 1 GiB
              and at 0, and a second worker promoting what the first
              demoted; four sessions of three turns without a store, with
              T1 at 1 GiB, and chunked; per pass wall, TTFT, prompt tokens,
              peak blocks and device memory, store stats and per-event
              ms, the counts equal a CPU rehearsal, no capture; then
              promotion against build_prefix by prefix length. After the
              profiled phases, so the store's threads and pinned buffers
              share the process with none of them.
9. parallel -- the mesh at Llama-2-7B width: the engine phase's weights,
              prompts and 64 new tokens as tp = 2 and sp = 2 worlds of two
              processes on the card (gloo), each rank holding its slice:
              tokens against the single-process engine's, first-token
              logits within 5%, decode ms per step, per-rank weight bytes,
              K1 / K2 launches per prefill and step; then a mesh of one
              rank over NCCL in this process, which issues no collective
              (an axis of one rank drops them) and whose prewarm captures
              the step graphs: the engine phase's tokens, no capture after
              the prewarm;
   serve_parallel -- serving on the mesh at Llama-2-7B width, 32
              layers: first the passes in one process and the chunked
              batcher on an NCCL mesh of one (prewarm captures, tokens
              equal one process's, no capture after); then, alone on the
              card, a tp 2 gloo world, a ContinuousWorker on rank 0 over
              an InProcBroker in rank 0's process and rank 1 following;
              serve_continuous's first 8 requests, 32 new tokens, 4 rows;
              split and chunked (128) passes, and the first 4 in an int8
              chunked pass: every request answered once, equal digests,
              pools drained, K3 / K4 n_layers a step on each rank; tokens
              against the one-process passes, decode ms a step, TTFT p50,
              the control's host ms a step, bytes a rank.

Then one JSON line with every kernel's numbers, the nvidia-smi line, and
last the result line {"ok": true, "device": {...}}.

Kernel and library times are device times of one call from CUDA-graph
replays (``device_ms``); plain versions' times are summed kernel
durations from torch.profiler (``profiled_ms``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import faulthandler
import gc
import json
import math
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch

# The port itself; a copy of this script without the package fails here.
import llmss_tpu_torch  # noqa: F401
from llmss_tpu_torch.parallel.launch import (
    count_steps, run_schedule, serve_requests,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
# A kernel's output element may differ from its fp32 plain version's by
# REL_TOL[dtype] times that row's softmax-weighted mean |v| (the plain
# version run on |v|). In bf16 the kernels round P to bf16 before P.V,
# an error of at most 2^-8 * sum(p |v|), and round the output, at most
# 2^-8 * |out| <= 2^-8 * sum(p |v|): together 2^-7. The same reasoning
# with fp16's 2^-11 rounding gives 2^-10. In fp32 only the summation order
# differs (about 1e-6 relative on the card).
REL_TOL = {torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10,
           torch.float32: 2.0**-16}

# serve_priority, serve_fleet, serve_tiers and speculative run the first
# quarter of these layers (their checks do not depend on depth), so that
# the run with the mesh phases fits its time limit on slower hosts
# (PERF.md).
CUT_LAYERS = 8
LLAMA2_7B = dict(
    model_type="llama", vocab_size=32000, hidden_size=4096, n_layers=32,
    n_heads=32, n_kv_heads=32, head_dim=128, intermediate_size=11008,
    max_position_embeddings=4096, activation="silu", norm="rmsnorm",
    norm_eps=1e-5, mlp="swiglu", positions="rotary", rope_style="half",
    rotary_dim=128, attn_bias=False, mlp_bias=False,
    tie_word_embeddings=False, dtype="bfloat16",
)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def _kernel_rows(prof):
    """(device us, name, calls) of every CUDA kernel in a profile: the CPU
    ops that launched them carry the same device time again and are left
    out."""
    from torch.autograd import DeviceType

    return sorted(
        ((e.self_device_time_total, e.key, e.count)
         for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        reverse=True,
    )


def device_ms(fn, iters: int = 20, warmup: int = 3, reps: int = 5) -> float:
    """Device time of one call: ``iters`` calls captured in one CUDA graph,
    each replay timed with CUDA events; the median of ``reps`` replays,
    over ``iters``. Host launch gaps are excluded, so a ~10 us kernel is
    not timed at the rate Python can launch it; the device's gaps between
    one call's kernels (a split kernel and its merge) are included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return sorted(times)[reps // 2]


def profiled_ms(fn, iters: int = 5, warmup: int = 2) -> float:
    """Mean summed duration of the kernels one call launches, from
    torch.profiler: for the plain versions, whose many small kernels are
    not all capturable in a graph."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # A profile that recorded no kernel is a lost trace: profile again.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(r[0] for r in _kernel_rows(prof))
        if total > 0:
            return total / 1e3 / iters
    # Still nothing: CUDA events around the calls (launch gaps included,
    # so an upper bound on the device time).
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    """The least time for the work: bytes over the memory rate or
    operations over the peak rate for the dtype, whichever is larger."""
    peak = FP32_FLOPS if dtype == torch.float32 else BF16_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 1 -------------------------------------------------------------------


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    # fp32 comparisons on the card must not silently run in TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    return smi


# -- phase 2 -------------------------------------------------------------------


def ptxas_entries(text: str) -> list[tuple[str, int, int]]:
    """(kernel, spill store bytes, registers) of every instantiation in
    ``nvcc -Xptxas=-v`` output: ptxas reports the entry's name, then its
    spills, then its registers."""
    name = (r"(?:(?:flash|paged|decode|window)_(?:w?gmma|mma|fwd)"
            r"|(?:decode|paged)_group"
            r"|(?:split|window)_merge)")
    return [(k, int(sp), int(r)) for k, sp, r in re.findall(
        rf"entry function '\w*?({name}\w*?)EEEv\w*' for[^\n]*\n[^\n]*\n"
        r"\s*\d+ bytes stack frame, (\d+) bytes spill stores[^\n]*\n[^\n]*"
        r"Used (\d+) registers", text)]


# The lane template's instantiations over an int8 cache (KV = signed char,
# mangled "a"), fp32 or bf16 queries.
INT8_LANE = re.compile(r"_fwdI(?:f|13__nv_bfloat16)aLi")


def int8_lane_conversions() -> tuple[dict, dict] | None:
    """Integer-to-float conversions (I2F, I2FP) in the int8 lane-template
    instantiations' SASS (``cuobjdump -sass`` of the built libraries):
    (per instantiation, those that are not part of an integer division,
    whose reciprocal is an I2F.U32.RP; every form's count over all of
    them). The int8 rows are widened with byte permutes and fp32 adds, so
    the first must be all 0. None when the toolkit has no cuobjdump."""
    from llmss_tpu_torch.ops import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    found, forms = {}, {}
    for name in ("decode_attention", "paged_attention"):
        sass = subprocess.run(
            [str(tool), "-sass", str(_build.BUILD_DIR / f"lib{name}.so")],
            capture_output=True, text=True, check=True, timeout=300).stdout
        parts = re.split(r"Function : (\S+)", sass)
        for fn, body in zip(parts[1::2], parts[2::2]):
            if INT8_LANE.search(fn):
                ops = re.findall(r"\bI2FP?(?:\.\w+)*", body)
                for op in ops:
                    forms[op] = forms.get(op, 0) + 1
                found[fn] = sum(not op.endswith(".RP") for op in ops)
    if not found:
        raise AssertionError("no int8 lane-template instantiation in the SASS")
    return found, forms


def mma_registers(text: str) -> list[dict]:
    """The tensor-core instantiations' (K1's wgmma tile, the 64-row and
    the group tiles') registers and spills."""
    return [{"kernel": k, "registers": r, "spill_store_bytes": sp}
            for k, sp, r in ptxas_entries(text)
            if "_mma" in k or "_group" in k or "_wgmma" in k]


# K1's wgmma tile at these head dims may not spill: its O (64 x D fp32 a
# consumer warpgroup) and S fit the consumers' registers.
WGMMA_NO_SPILL = re.compile(r"flash_wgmmaI\w+?Li(?:64|128)E")


def phase_build() -> None:
    from llmss_tpu_torch.ops import _build

    secs, out = _build.build_all(verbose=True)
    text = "\n".join(out.values())
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", text)]
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores", text)]
    # Listed: the tensor-core instantiations, the bf16-query D 128 and
    # D 256 (GPT-J) lane-template ones and merge ones that the decode paths
    # run, and every int8 lane-template one.
    entries = ptxas_entries(text)
    conv, forms = int8_lane_conversions() or (None, None)
    if conv and any(conv.values()):
        raise AssertionError(f"int8 lane instantiations convert: {conv}")
    spilled = [k for k, sp, _ in entries if sp and WGMMA_NO_SPILL.search(k)]
    if spilled:
        raise AssertionError(f"K1's wgmma tile spills at D <= 128: {spilled}")
    emit({"phase": "build", "seconds": round(secs, 3),
          "sources": sorted(out), "max_registers": max(regs, default=None),
          "kernels_with_spills": sum(1 for n in spills if n > 0),
          "mma_instantiations": mma_registers(text),
          "decode_instantiations": [
              {"kernel": k, "registers": r, "spill_store_bytes": sp}
              for k, sp, r in entries if "_mma" not in k and "_group" not in k
              and (re.search(r"nv_bfloat16(?:S\d_|a)?Li(?:128|256)", k)
                   or INT8_LANE.search(k))],
          "int8_lane_conversions": None if conv is None else sum(conv.values()),
          "int8_lane_i2f_forms": forms,
          "spilling": [{"kernel": k, "spill_store_bytes": sp}
                       for k, sp, _ in entries if sp > 0]})


# -- phase 3 -------------------------------------------------------------------


def _ring_positions(B, T, hist):
    """kv positions [B, T] of rows whose histories are positions
    0..hist[b]-1 written at slot p % T (wrapping rows keep the latest)."""
    kvp = np.full((B, T), -1, np.int32)
    for b, n in enumerate(hist):
        for p in range(n):
            kvp[b, p % T] = p
    return kvp


def _k1_case(name, B, S, T, Hq, Hkv, *, lens=None, q0=0, window=None, seed=0,
             D=128, dt=torch.bfloat16):
    """Prefill attention after the layer's KV was written: queries at
    positions q0 .. q0+S-1, keys everything written so far (ring order,
    -1 for empty slots and right-padded prompt columns)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    q = torch.randn(B, S, Hq, D, generator=g, device=dev, dtype=dt)
    k = torch.randn(B, T, Hkv, D, generator=g, device=dev, dtype=dt)
    v = torch.randn(B, T, Hkv, D, generator=g, device=dev, dtype=dt)
    lens = lens or [S] * B
    qp = np.broadcast_to(np.arange(q0, q0 + S, dtype=np.int32), (B, S)).copy()
    kvp = _ring_positions(B, T, [q0 + S] * B)
    for b, n in enumerate(lens):  # right padding: written with position -1
        for p in range(q0 + n, q0 + S):
            kvp[b, p % T] = -1
    return dict(name=name, q=q, k=k, v=v, qp=torch.tensor(qp, device=dev),
                kvp=torch.tensor(kvp, device=dev), window=window)


def _quantized(case, *names):
    """The case with its caches ``names`` (K first, then V) quantized to
    int8 (the engine's int8 cache: ``engine.cache.quantize_kv``), their
    fp32 scales as ``ks`` / ``vs``; a case without ``kv="int8"`` gets
    ``ks`` / ``vs`` None."""
    case.update(ks=None, vs=None, row=case["kernel"])
    if case.pop("kv", None) == "int8":
        from llmss_tpu_torch.engine.cache import quantize_kv

        (case[names[0]], case["ks"]), (case[names[1]], case["vs"]) = (
            quantize_kv(case[n]) for n in names)
        case["row"] += "_int8"
    return case


def _k2_case(name, B, T, Hq, Hkv, hist, t_len, *, window=None, seed=0, L=2,
             D=128, dt=torch.bfloat16, kv=None):
    """Single-token decode of layer L-1 for rows whose histories are
    positions 0..hist[b]-1. The pending slot (hist[b] % T, about to be
    overwritten) gets a key 4x the group's first query head and values of
    8: a kernel that failed to exclude it would put nearly all of that
    head's weight there and miss by ~8. On a wrapped row that slot still
    holds a visible old position, so only the slot exclusion drops it.
    ``kv="int8"``: the cache quantized, with its scales."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    kc = torch.randn(L, B, T, Hkv, D, generator=g, device=dev, dtype=dt)
    vc = torch.randn(L, B, T, Hkv, D, generator=g, device=dev, dtype=dt)
    q = torch.randn(B, 1, Hq, D, generator=g, device=dev, dtype=dt)
    kn = torch.randn(B, 1, Hkv, D, generator=g, device=dev, dtype=dt)
    vn = torch.randn(B, 1, Hkv, D, generator=g, device=dev, dtype=dt)
    kvp = _ring_positions(B, T, hist)
    qpos = np.asarray(hist, np.int32)[:, None]
    slots = qpos % T
    G = Hq // Hkv
    for b in range(B):
        kc[L - 1, b, slots[b, 0]] = 4 * q[b, 0, ::G]
        vc[L - 1, b, slots[b, 0]] = 8
    return _quantized(dict(
        name=name, kernel="K2", kv=kv, q=q, kc=kc, vc=vc, kn=kn, vn=vn,
        qpos=torch.tensor(qpos, device=dev), kvp=torch.tensor(kvp, device=dev),
        slots=torch.tensor(slots, device=dev), layer=L - 1, t_len=t_len,
        window=window), "kc", "vc")


def _k2w_case(name, B, T, Hq, Hkv, hist, t_len, S, *, seed=0, L=2, D=128,
              dt=torch.bfloat16, holes=()):
    """A decode window of S tokens a row at positions hist[b] ..
    hist[b] + S - 1 over layer L-1, for rows whose histories are positions
    0..hist[b]-1 (``holes``: (row, slot) pairs invalidated to -1). Every
    pending slot gets a key 4x the group's first query head of window query
    0 and values of 8: a kernel that failed to exclude them would put
    nearly all of that head's weight there and miss by ~8. On a wrapped
    row they still hold visible old positions, so only the pending-range
    exclusion drops them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    kc = torch.randn(L, B, T, Hkv, D, generator=g, device=dev, dtype=dt)
    vc = torch.randn(L, B, T, Hkv, D, generator=g, device=dev, dtype=dt)
    q = torch.randn(B, S, Hq, D, generator=g, device=dev, dtype=dt)
    kn = torch.randn(B, S, Hkv, D, generator=g, device=dev, dtype=dt)
    vn = torch.randn(B, S, Hkv, D, generator=g, device=dev, dtype=dt)
    kvp = _ring_positions(B, T, hist)
    for b, t in holes:
        kvp[b, t] = -1
    q0 = np.asarray(hist, np.int32)[:, None]
    slots = (q0 + np.arange(S, dtype=np.int32)) % T
    G = Hq // Hkv
    for b in range(B):
        for i in range(S):
            kc[L - 1, b, slots[b, i]] = 4 * q[b, 0, ::G]
            vc[L - 1, b, slots[b, i]] = 8
    return dict(name=name, kernel="K2w", q=q, kc=kc, vc=vc, kn=kn, vn=vn,
                q0=torch.tensor(q0, device=dev),
                kvp=torch.tensor(kvp, device=dev),
                slots=torch.tensor(slots, device=dev), layer=L - 1,
                t_len=t_len)


# The speculative phase at Llama-2-7B width: 16 prompts of 128 tokens, 256
# new tokens each, on a 1024-slot ring; its verify windows read the
# 384-slot bucket (every position stays below 128 + 256).
SPEC_BATCH, SPEC_PROMPT, SPEC_NEW, SPEC_BUCKET = 16, 128, 256, 384
SPEC_HIST = [200 + 7 * b for b in range(SPEC_BATCH)]  # rows mid-generation


# K2w's cases: (name, B, T, Hq, Hkv, hist, t_len, S, options); the first
# is the speculative phase's verify window at gamma 4 in its 384-slot
# bucket. tests/test_torch_window_plan.py plans every one on the CPU.
K2W_SHAPES = (
    ("k2w_engine_verify", SPEC_BATCH, 1024, 32, 32, SPEC_HIST, SPEC_BUCKET, 5,
     dict(seed=20)),
    ("k2w_engine_verify_b4", 4, 1024, 32, 32, SPEC_HIST[:4], SPEC_BUCKET, 5,
     dict(seed=21)),
    # The whole ring: a window wrapping the ring's end (1022..1026), a
    # wrapped ring, an empty row, a row at the last position.
    ("k2w_7b_full_wrap", 4, 1024, 32, 32, [1022, 1500, 0, 2043], 1024, 5,
     dict(seed=22)),
    # Invalidated (-1) slots inside the visible range (rejected drafts).
    ("k2w_7b_holes", 4, 1024, 32, 32, [300, 200, 0, 150], 384, 5,
     dict(seed=23, holes=((0, 7), (0, 250), (1, 0), (3, 149)))),
    ("k2w_s2", SPEC_BATCH, 1024, 32, 32, SPEC_HIST, SPEC_BUCKET, 2,
     dict(seed=24)),
    ("k2w_s8", SPEC_BATCH, 1024, 32, 32, SPEC_HIST, SPEC_BUCKET, 8,
     dict(seed=25)),
    # GQA: G 4 (20 window rows: two row warps), Qwen2-7B's G 7 (35 rows:
    # three), StarCoder's G 48 (240 rows: four blocks of 64).
    ("k2w_gqa4", 4, 1024, 32, 8, [1022, 1300, 5, 0], 1024, 5, dict(seed=26)),
    ("k2w_qwen2", 4, 1024, 28, 4, [300, 250, 0, 377], 384, 5, dict(seed=27)),
    ("k2w_starcoder", 4, 1024, 48, 1, [200, 150, 0, 250], 256, 5,
     dict(seed=28)),
    ("k2w_d64", 4, 256, 8, 8, [100, 250, 0, 30], 256, 4, dict(seed=29, D=64)),
    ("k2w_gptj_d256", 4, 1024, 16, 16, [200, 150, 0, 250], 256, 5,
     dict(seed=30, D=256)),
    # fp32: 10 window rows (two lane groups of 8), and the tiny fp32
    # reference model's shape (D 64, GQA 2).
    ("k2w_fp32", 3, 256, 8, 4, [100, 250, 0], 256, 5,
     dict(seed=31, dt=torch.float32)),
    ("k2w_fp32_d64", 3, 64, 4, 2, [20, 50, 0], 64, 5,
     dict(seed=32, D=64, dt=torch.float32)),
)


def k2w_cases() -> list[dict]:
    """K2w's cases on the card, from ``K2W_SHAPES``."""
    return [_k2w_case(name, B, T, Hq, Hkv, hist, t_len, S, **kw)
            for name, B, T, Hq, Hkv, hist, t_len, S, kw in K2W_SHAPES]


def check_window_kernel(out: dict) -> None:
    """K2w against its plain (fp32) version, within REL_TOL, at every
    case, timed beside its plain version, SDPA and its bound (each case
    also in the ``mma_below_library`` line); the first case's numbers go
    into the final kernels line."""
    from llmss_tpu_torch.ops import _build
    from llmss_tpu_torch.ops import attention as att
    from llmss_tpu_torch.ops import decode_attention as da

    worst = 0.0
    for c in k2w_cases():
        args = (c["q"], c["kc"], c["vc"], c["kn"], c["vn"], c["q0"], c["kvp"],
                c["slots"], c["layer"])
        kw = dict(t_len=c["t_len"])
        got = da.decode_window_attention(*args, **kw).float()
        q32, kc32, vc32, kn32, vn32 = (
            a.float() for a in (c["q"], c["kc"], c["vc"], c["kn"], c["vn"]))
        pos = (c["q0"], c["kvp"], c["slots"], c["layer"])
        ref = da.decode_window_attention_ref(q32, kc32, vc32, kn32, vn32,
                                             *pos, **kw)
        ref_abs = da.decode_window_attention_ref(q32, kc32, vc32.abs(), kn32,
                                                 vn32.abs(), *pos, **kw)
        dt = c["q"].dtype

        def check(g, what=""):
            return _agree("K2w", c["name"] + what, g.float(), ref, ref_abs, dt)

        err, ratio = check(got)
        worst = max(worst, err)
        # Bound: the visible cache slots' K/V, q, the fresh K/V, the
        # positions and the output, each once; the visible query-key
        # pairs' operations.
        B, S, Hq, D = c["q"].shape
        Hkv = c["kc"].shape[3]
        t = c["t_len"]
        pen = att.window_mask_penalty(c["q0"], c["kvp"][:, :t], c["slots"])
        visible = int((pen == 0).sum().item())
        es = c["q"].element_size()
        nbytes = (2 * visible * Hkv * D * es + 2 * c["q"].numel() * es
                  + 2 * c["kn"].numel() * es + B * t * 4 + 2 * B * 4)
        pairs = visible * S + B * S * (S + 1) // 2
        b_ms, b_by = bound(nbytes, 4.0 * pairs * Hq * D, dt)
        # Library yardstick: SDPA over the layer's [B, t] slice and the
        # fresh KV, under the same mask.
        keys = torch.cat([c["kc"][c["layer"], :, :t], c["kn"]], 1)
        vals = torch.cat([c["vc"][c["layer"], :, :t], c["vn"]], 1)
        tri = torch.ones(S, S, dtype=torch.bool, device="cuda").tril()
        mask = torch.cat([(pen == 0)[:, None, None, :].expand(B, 1, S, t),
                          tri[None, None].expand(B, 1, S, S)], -1)
        plan = da.window_plan(dt, B, Hq, Hkv, D, t, S,
                              sms=_build.sm_count(c["q"].device))
        t0 = time.perf_counter()
        ms = device_ms(lambda: da.decode_window_attention(*args, **kw),
                       iters=50)
        row = {"phase": "kernel", "kernel": "K2w", "case": c["name"],
               "window": S, "impl": plan.impl, "rows_per_block": plan.rows,
               "slot_warps": plan.slot_warps, "cluster": plan.cluster,
               "splits": plan.splits, "split_slots": plan.split_slots,
               "max_abs_err": err, "rel_tol": REL_TOL[dt],
               "err_over_tol": ratio, "ms": ms,
               "plain_ms": profiled_ms(
                   lambda: da.decode_window_attention_ref(*args, **kw)),
               "library_ms": device_ms(
                   lambda: _sdpa(c["q"], keys, vals, mask), iters=50),
               "library": "scaled_dot_product_attention over the slice and "
                          "the fresh KV",
               "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms}
        _unsplit(row, lambda: da._launch_window(*args, max_splits=1, **kw),
                 lambda g: check(g, " unsplit"))
        _main_path_impl("K2w", row,
                        "mma" if dt == torch.bfloat16 else "lanes")
        if c["name"] == "k2w_engine_verify":
            # The window tile at 1-3 splits, each folded in its cluster and
            # by window_merge, a second launch (the two-launch form).
            for n in (1, 2, 3):
                for key, clu in (("cluster_ms", True), ("two_launch_ms", False)):
                    def forced(n=n, clu=clu):
                        return da._launch_window(*args, cluster=clu, splits=n,
                                                 **kw)

                    check(forced(), f" {key} {n}")
                    row.setdefault(key, {})[n] = device_ms(forced, iters=50)
        row["seconds"] = time.perf_counter() - t0
        out.setdefault("K2w", row)
        out["cases"][c["name"]] = row
        out.setdefault("vs_library", {})[c["name"]] = (row["ms"],
                                                       row["library_ms"])
        emit(row)
    out["K2w"]["max_abs_err"] = worst


def _dequant(x, scale, dtype):
    """``x`` as the library yardstick reads it: a compute-dtype cache as
    it is, an int8 one dequantized (``engine.cache.dequantize_kv``)."""
    from llmss_tpu_torch.engine.cache import dequantize_kv

    return x if scale is None else dequantize_kv(x, scale, dtype)


def _sdpa(q, k, v, mask):
    """One scaled_dot_product_attention call on [B, H, S, D] views."""
    import torch.nn.functional as F

    gqa = q.shape[2] != k.shape[2]
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, enable_gqa=gqa,
    )


def _agree(kernel, case, got, ref, ref_abs, dtype) -> tuple[float, float]:
    """(max |got - ref|, its worst ratio to the element's tolerance,
    REL_TOL[dtype] * ref_abs); raises if any element is past it."""
    err = (got - ref).abs()
    ratio = (err / (REL_TOL[dtype] * ref_abs + 1e-6)).max().item()
    if not ratio <= 1.0:
        raise AssertionError(
            f"{kernel} {case}: max_abs_err {err.max().item()} is "
            f"{ratio:.3g}x its tolerance")
    return err.max().item(), ratio


def _main_path_impl(kernel, row, want="mma") -> None:
    """The main path's shape must take the tensor-core instantiation."""
    if row["impl"] != want:
        raise AssertionError(f"{kernel} {row['case']}: instantiation "
                             f"{row['impl']}, want {want}")


def _decode_impl(q, Hkv: int, int8: bool) -> str:
    """The template a decode call (K2, K3) must take: the one
    ``split_plan.decode_tile`` names for its dtypes and G (the group tile
    for bf16 queries over a bf16 cache from G_TILE query heads per KV
    head, the 64-row tile's int8 form above 8 over an int8 cache), else the
    lanes."""
    from llmss_tpu_torch.ops import split_plan as sp

    kv = torch.int8 if int8 else q.dtype
    tile = sp.decode_tile(q.dtype, kv, q.shape[2] // Hkv)
    return tile or ("lanes_int8" if int8 else "lanes")


# Where the run times the three decode templates, forced, on the same
# call: the K2 and K3 cases at G = 1, 2, 3, 4, 7, 8, 16 and 48 (G 2 and 3
# synthetic, at Llama-2-7B's 128-wide heads and the engine / serve shapes:
# no family of the repo has them), so that the run itself shows where
# G_TILE belongs.
G_TILE_CASES = {1: ("k2_engine_decode", "k3_serve_decode"),
                2: ("k2_g2_engine_decode", "k3_g2_serve_decode"),
                3: ("k2_g3_engine_decode", "k3_g3_serve_decode"),
                4: ("k2_gqa", "k3_gqa"),
                7: ("k2_qwen2_full_wrap", "k3_qwen2_serve_decode"),
                8: ("k2_g8_engine_decode", "k3_g8_serve_decode"),
                16: ("k2_santacoder_window", "k3_santacoder_window"),
                48: ("k2_starcoder_engine_decode", "k3_starcoder_serve_decode")}
# The time each forced template goes under: the lanes, the 64-row tile,
# the group tile.
FORCE = {"lanes_ms": "lanes", "tile_ms": "mma", "group_ms": "group"}


def _forced_templates(row, fn, check) -> None:
    """``fn(force)`` forced onto each decode template of ``FORCE``: each
    output held within REL_TOL by ``check``, each timed into ``row``."""
    for key, force in FORCE.items():
        check(fn(force))
        row[key] = device_ms(lambda: fn(force), iters=50)


# At a main-path decode shape the plan may be no slower than the unsplit
# kernel beyond the spread of graph replays within one run.
SPLIT_MARGIN = 1.05


def _main_path_split(kernel, row, split: bool) -> None:
    """The plan at a main-path decode shape: split along the KV axis or
    not, as wanted, and no slower than the unsplit kernel."""
    if (row["splits"] > 1) != split:
        raise AssertionError(f"{kernel} {row['case']}: {row['splits']} "
                             f"split(s), want {'>1' if split else '1'}")
    if row["ms"] > SPLIT_MARGIN * row["unsplit_ms"]:
        raise AssertionError(f"{kernel} {row['case']}: {row['ms']} ms split, "
                             f"{row['unsplit_ms']} unsplit")


def _unsplit(row, fn, check) -> None:
    """Time ``fn``, the same K2 / K3 call launched unsplit (max_splits=1),
    into ``row["unsplit_ms"]`` after ``check`` held its output within
    REL_TOL; a call the plan does not split is its own unsplit time."""
    if row["splits"] == 1:
        row["unsplit_ms"] = row["ms"]
        return
    check(fn())
    row["unsplit_ms"] = device_ms(fn, iters=50)


ENGINE_LENS = [128, 100, 77, 128]  # the engine phase's prompts
SERVE_CTX = [700, 45, 300, 812, 128, 33, 560, 400]  # its serve decode rows
# The engine phase's shared prefix (a 512-slot segment) and its prompts'
# suffixes: the suffix prefill runs K1 at q0 512, bucket 128, ring 1024.
ENGINE_PREFIX = 512
PREFIX_SUFFIXES = [16, 100, 57, 83]
# The serve_prefix phase: a 600-token system prompt (37 full blocks of 16
# and an 8-token tail) and 16 suffixes of 16-96 tokens from seed 12; K3's
# rows 32 steps into decode (the 768-slot bucket: 48 columns), K4's step
# with three rows feeding prefix tail + suffix from slot 592 beside five
# decode rows, every table's first 37 columns the same blocks.
SYSTEM_LEN, SHARED_BLOCKS = 600, 37
PREFIX_K3_CTX = [698, 721, 721, 674, 710, 682, 724, 695]
PREFIX_K4_CTX = [592, 592, 592, 674, 710, 682, 724, 695]
PREFIX_K4_QLEN = [74, 97, 97, 1, 1, 1, 1, 1]


def k1_cases() -> list[dict]:
    """K1's cases; the first is the engine phase's prefill (prompts of
    128/100/77/128 tokens padded to 128)."""
    return [
        _k1_case("k1_engine_prefill", 4, 128, 1024, 32, 32, lens=ENGINE_LENS),
        _k1_case("k1_7b_padded", 4, 512, 1024, 32, 32,
                 lens=[512, 400, 301, 512]),
        _k1_case("k1_gqa", 4, 512, 1024, 32, 8, lens=[512, 256, 511, 77],
                 seed=1),
        _k1_case("k1_wrap_window", 2, 256, 512, 32, 8, q0=512, window=300,
                 seed=2),
        _k1_case("k1_fp16", 2, 200, 512, 32, 8, lens=[200, 133], seed=3,
                 dt=torch.float16),
        # A long prompt against itself: bound by operations, not bytes.
        _k1_case("k1_7b_long", 1, 2048, 2048, 32, 32, seed=6),
        # The same at GQA (32 query heads on 8 KV heads: 4 flat rows a
        # position), and four long prompts of 2048 / 1500 / 900 / 300
        # right-padded to 2048 (padded slots at -1).
        _k1_case("k1_7b_long_gqa", 1, 2048, 2048, 32, 8, seed=10),
        _k1_case("k1_long_padded", 4, 2048, 2048, 32, 32,
                 lens=[2048, 1500, 900, 300], seed=11),
        # GPT-J's head_dim: the largest instantiations (mma; fp32 fma).
        _k1_case("k1_d256", 2, 100, 160, 8, 8, lens=[100, 61], seed=4,
                 D=256),
        _k1_case("k1_d256_fp32", 2, 100, 160, 8, 8, lens=[100, 61], seed=4,
                 D=256, dt=torch.float32),
        _k1_case("k1_d64_gqa", 2, 100, 160, 8, 2, lens=[100, 61], seed=4,
                 D=64),
        # The gptj_6b and starcoder phases' engine prefill: 16 MHA heads of
        # 256 (the tile's largest instantiation); 48 query heads on one KV
        # head.
        _k1_case("k1_gptj_prefill", 4, 128, 1024, 16, 16, lens=ENGINE_LENS,
                 seed=7, D=256),
        _k1_case("k1_starcoder_prefill", 4, 128, 1024, 48, 1,
                 lens=ENGINE_LENS, seed=8),
        # The engine phase's suffix prefill over the seeded ring: queries
        # at 512..639 (pads at -1) over 512 seeded slots.
        _k1_case("k1_engine_prefix_suffix", 4, 128, 1024, 32, 32,
                 lens=PREFIX_SUFFIXES, q0=ENGINE_PREFIX, seed=9),
    ]


def k2_cases(int8: bool = True) -> list[dict]:
    """K2's cases; the first is the engine phase's decode in its 192-slot
    bucket, the first int8 one (unless ``int8`` is False) the int8 phase's."""
    cases = [
        # The engine phase's batch 40 steps into decode, in its bucket.
        _k2_case("k2_engine_decode", 4, 1024, 32, 32,
                 [n + 40 for n in ENGINE_LENS], 192, seed=5),
        # t_len < T: a live row, a half-full row, an empty row, a row at
        # the bucket's edge.
        _k2_case("k2_7b_tlen", 4, 1024, 32, 32, [600, 300, 0, 639], 640),
        # t_len = T: wrapped rows (the pending slot holds the token being
        # overwritten and must be excluded).
        _k2_case("k2_7b_full_wrap", 4, 1024, 32, 32, [1000, 1500, 0, 2047],
                 1024, seed=1),
        _k2_case("k2_gqa", 4, 1024, 32, 8, [1023, 1300, 5, 0], 1024, seed=2),
        _k2_case("k2_window", 2, 1024, 32, 8, [900, 1800], 1024,
                 window=256, seed=3),
        _k2_case("k2_d256_fp32", 3, 256, 8, 4, [300, 1000, 0], 256, seed=4,
                 D=256, dt=torch.float32),
        # One row over the whole (wrapped) ring: the unsplit grid had 8
        # (GQA) or 32 (MHA) blocks for 132 SMs.
        _k2_case("k2_b1_gqa_full", 1, 1024, 32, 8, [1024], 1024, seed=6),
        _k2_case("k2_b1_mha_full", 1, 1024, 32, 32, [1536], 1024, seed=7),
        # The gptj_6b and starcoder phases' decode in the 192-slot bucket:
        # D 256 (32 lanes a slot); G 48 (6 blocks of 8 heads per KV head).
        _k2_case("k2_gptj_engine_decode", 4, 1024, 16, 16,
                 [n + 40 for n in ENGINE_LENS], 192, seed=8, D=256),
        _k2_case("k2_starcoder_engine_decode", 4, 1024, 48, 1,
                 [n + 40 for n in ENGINE_LENS], 192, seed=9),
        # Qwen/Qwen2-7B config.json's 28 query heads on 4 KV heads (G = 7:
        # one lane group of 8 per KV head, one row dead), and G = 8, the
        # largest lane group, in the engine's bucket.
        _k2_case("k2_qwen2_engine_decode", 4, 1024, 28, 4,
                 [n + 40 for n in ENGINE_LENS], 192, seed=10),
        _k2_case("k2_g8_engine_decode", 4, 1024, 32, 4,
                 [n + 40 for n in ENGINE_LENS], 192, seed=11),
        # G = 2 and 3, which no family of the repo has, at Llama-2-7B's
        # 128-wide heads in the engine's bucket: where G_TILE is measured.
        _k2_case("k2_g2_engine_decode", 4, 1024, 32, 16,
                 [n + 40 for n in ENGINE_LENS], 192, seed=15),
        _k2_case("k2_g3_engine_decode", 4, 1024, 24, 8,
                 [n + 40 for n in ENGINE_LENS], 192, seed=16),
        # Qwen2-7B over the whole (wrapped) ring: a long read, where one
        # group per KV head saves 6 of 7 reads.
        _k2_case("k2_qwen2_full_wrap", 4, 1024, 28, 4, [1000, 1500, 0, 2047],
                 1024, seed=14),
        # bigcode/gpt_bigcode-santacoder's 16 heads of 128 on one KV head
        # (the tile, a quarter full) under a window, with a wrapped and an
        # empty row; G = 48 over the whole ring with wrapped and empty rows.
        _k2_case("k2_santacoder_window", 4, 1024, 16, 1, [900, 1800, 0, 300],
                 1024, window=256, seed=12),
        _k2_case("k2_starcoder_wrap_empty", 4, 1024, 48, 1,
                 [1000, 1500, 0, 2047], 1024, seed=13),
    ]
    return cases + ([
        # The int8 cache: the int8 engine phase's decode in its bucket
        # first, then GQA with wrapped and empty rows, and the tiny fp32
        # reference model's instantiation (fp32 queries, head_dim 64).
        _k2_case("k2_int8_engine_decode", 4, 1024, 32, 32,
                 [n + 40 for n in ENGINE_LENS], 192, seed=5, kv="int8"),
        _k2_case("k2_int8_gqa_wrap", 4, 1024, 32, 8, [1023, 1300, 5, 0], 1024,
                 seed=2, kv="int8"),
        _k2_case("k2_int8_fp32_d64", 3, 256, 8, 4, [300, 1000, 0], 256,
                 seed=4, D=64, dt=torch.float32, kv="int8"),
        # StarCoder's decode over an int8 cache: the tile over int8 tiles.
        _k2_case("k2_int8_starcoder_engine_decode", 4, 1024, 48, 1,
                 [n + 40 for n in ENGINE_LENS], 192, seed=9, kv="int8"),
    ] if int8 else [])


def check_kernels() -> dict:
    """K1 / K2 against their plain (fp32) versions, within REL_TOL. The
    first case of each list is the shape the engine phase gives the kernel
    (prompts of 128/100/77/128 tokens padded to 128, decode in the 192-slot
    bucket); its numbers go into the final kernels line."""
    out = {}
    worst = 0.0
    for c in k1_cases():
        row, err = _k1_row(c)
        worst = max(worst, err)
        out.setdefault("K1", row)
        out.setdefault("cases", {})[c["name"]] = row
        if c["name"] in ("k1_engine_prefill", "k1_7b_padded",
                         "k1_gptj_prefill", "k1_starcoder_prefill",
                         "k1_engine_prefix_suffix"):
            _main_path_impl("K1", row, "wgmma")
        if c["name"] in ("k1_engine_prefill", "k1_7b_padded", "k1_7b_long",
                         "k1_7b_long_gqa", "k1_long_padded",
                         "k1_gptj_prefill", "k1_starcoder_prefill",
                         "k1_engine_prefix_suffix"):
            out.setdefault("vs_library", {})[c["name"]] = (
                row["ms"], row["library_ms"])
        emit(row)
    out["K1"]["max_abs_err"] = worst
    # A measurement: the wgmma tile at 128 and 64 rows a block, forced, at
    # every bf16 / f16 K1 case, beside the plan's rows and its 128-row
    # grid's blocks (fa.wgmma_rows takes 64 at <= half the SMs).
    emit({"phase": "kernel", "check": "k1_forms", "cases": {
        name: {k: v for k, v in row.items()
               if k == "rows" or k.startswith(("rows_", "blocks_"))}
        for name, row in out["cases"].items() if row.get("impl") == "wgmma"}})

    worst_of = {}
    for c in k2_cases():
        row, err = _k2_row(c)
        out.setdefault(c["row"], row)
        out["cases"][c["name"]] = row
        worst_of[c["row"]] = max(worst_of.get(c["row"], 0.0), err)
        emit(row)
    for name in ("K2", "K2_int8"):
        out[name]["max_abs_err"] = worst_of[name]
    for name in ("k2_starcoder_engine_decode", "k2_int8_starcoder_engine_decode"):
        row = out["cases"][name]
        out["vs_library"][name] = (row["ms"], row["library_ms"])
    _main_path_impl("K2_int8", out["K2_int8"], "lanes_int8")
    # The engine's 192-slot bucket nearly fills the card unsplit (128
    # blocks): the plan keeps it whole.
    _main_path_split("K2", out["K2"], split=False)
    return out


def _k1_plan(c):
    """The K1 plan the case's call takes on this card."""
    from llmss_tpu_torch.ops import _build
    from llmss_tpu_torch.ops import flash_attention as fa

    B, S, Hq, D = c["q"].shape
    return fa.kernel_plan(c["q"].dtype, D, B=B, S=S, Hq=Hq,
                          Hkv=c["k"].shape[2],
                          sms=_build.sm_count(c["q"].device))


def _k1_tiles(c, rows: int) -> dict | None:
    """The wgmma tile's (query tile, KV tile) pairs of the case's grid at
    ``rows`` flat rows a block by class (the producer's, from its Python
    mirror ``tile_classes``), over every KV head; None for an fp32 case
    (the fma kernel)."""
    from llmss_tpu_torch.ops import flash_attention as fa

    if c["q"].dtype == torch.float32:
        return None
    Hq, D = c["q"].shape[2:]
    Hkv = c["k"].shape[2]
    cls = fa.tile_classes(c["qp"], c["kvp"], Hq // Hkv, D, window=c["window"],
                          rows=rows)
    return {name: Hkv * int((cls == i).sum().item())
            for i, name in enumerate(("skipped", "masked", "full"))}


def _k1_row(c) -> tuple[dict, float]:
    """One K1 case against its plain version: its kernel line and error."""
    from llmss_tpu_torch.ops import attention as att
    from llmss_tpu_torch.ops import flash_attention as fa

    args = (c["q"], c["k"], c["v"], c["qp"], c["kvp"])
    kw = dict(window=c["window"])
    got = fa.flash_attention(*args, **kw).float()
    q32, k32, v32 = c["q"].float(), c["k"].float(), c["v"].float()
    ref = fa.flash_attention_ref(q32, k32, v32, c["qp"], c["kvp"], **kw)
    ref_abs = fa.flash_attention_ref(q32, k32, v32.abs(), c["qp"],
                                     c["kvp"], **kw)
    err, ratio = _agree("K1", c["name"], got, ref, ref_abs, c["q"].dtype)
    # Bound: each input read once, the output written once, counting
    # only the live KV slots and the visible query-key pairs.
    B, S, Hq, D = c["q"].shape
    Hkv = c["k"].shape[2]
    mask = att.make_causal_mask(c["qp"], c["kvp"], c["kvp"] >= 0,
                                c["window"])
    pairs = int(mask.sum().item())
    live_slots = int((c["kvp"] >= 0).sum().item())
    es = c["q"].element_size()
    nbytes = (2 * c["q"].numel() * es + 2 * live_slots * Hkv * D * es
              + c["qp"].numel() * 4 + c["kvp"].numel() * 4)
    b_ms, b_by = bound(nbytes, 4.0 * pairs * Hq * D, c["q"].dtype)
    plan = _k1_plan(c)
    row = {"phase": "kernel", "kernel": "K1", "case": c["name"],
           "impl": plan.impl, "rows": plan.rows,
           "tiles": _k1_tiles(c, plan.rows),
           "max_abs_err": err, "rel_tol": REL_TOL[c["q"].dtype],
           "err_over_tol": ratio,
           "ms": device_ms(lambda: fa.flash_attention(*args, **kw)),
           "plain_ms": profiled_ms(
               lambda: fa.flash_attention_ref(*args, **kw), iters=5),
           "library_ms": device_ms(
               lambda: _sdpa(c["q"], c["k"], c["v"], mask[:, None])),
           "bound_ms": b_ms, "bound_by": b_by}
    if plan.impl == "wgmma":
        # The wgmma tile at each of its row forms, forced and checked: the
        # data fa.wgmma_rows was set from (the k1_forms line).
        row["blocks_at_128"] = B * Hkv * -(-S * (Hq // Hkv) // 128)
        for r in fa.WGMMA_ROWS:
            fn = (lambda r=r: fa._launch(*args, window=c["window"], rows=r))
            _agree("K1", f"{c['name']} at {r} rows", fn().float(), ref,
                   ref_abs, c["q"].dtype)
            row[f"rows_{r}_ms"] = device_ms(fn)
    return row, err


def _k2_row(c) -> tuple[dict, float]:
    """One K2 case against its plain version: its kernel line (beside the
    same call unsplit, and at the G-tile cases both templates) and error."""
    from llmss_tpu_torch.ops import _build
    from llmss_tpu_torch.ops import attention as att
    from llmss_tpu_torch.ops import decode_attention as da

    args = (c["q"], c["kc"], c["vc"], c["kn"], c["vn"], c["qpos"],
            c["kvp"], c["slots"], c["layer"])
    kw = dict(t_len=c["t_len"], window=c["window"], k_scale=c["ks"],
              v_scale=c["vs"])
    got = da.decode_attention(*args, **kw).float()
    # fp32 plain version (an int8 cache stays int8: it converts exactly)
    q32, kc32, vc32, kn32, vn32 = (
        a.float() if a.is_floating_point() else a
        for a in (c["q"], c["kc"], c["vc"], c["kn"], c["vn"]))
    pos = (c["qpos"], c["kvp"], c["slots"], c["layer"])
    ref = da.decode_attention_ref(q32, kc32, vc32, kn32, vn32, *pos, **kw)
    ref_abs = da.decode_attention_ref(q32, kc32, vc32.abs(), kn32,
                                      vn32.abs(), *pos, **kw)
    err, ratio = _agree("K2", c["name"], got, ref, ref_abs, c["q"].dtype)
    # An empty row attends only its own fresh token: exactly v_new.
    G = c["q"].shape[2] // c["kn"].shape[2]
    for b in range(c["q"].shape[0]):
        if int(c["qpos"][b, 0]) == 0 and not torch.equal(
                got[b, 0], vn32[b, 0].repeat_interleave(G, 0)):
            raise AssertionError(f"K2 {c['name']}: empty row {b} != v_new")
    # Bound: only the visible cache slots' K/V (and int8 scales) are
    # needed, plus q, the fresh K/V, the positions and the output.
    B, _, Hq, D = c["q"].shape
    Hkv = c["kc"].shape[3]
    t = c["t_len"]
    pen = att.decode_mask_penalty(c["qpos"], c["kvp"][:, :t],
                                  c["slots"], c["window"])
    visible = int((pen == 0).sum().item())
    es = c["q"].element_size()
    slot_bytes = D * c["kc"].element_size() + (4 if c["ks"] is not None else 0)
    nbytes = (2 * visible * Hkv * slot_bytes + 2 * c["q"].numel() * es
              + 2 * c["kn"].numel() * es + B * t * 4 + 2 * B * 4)
    b_ms, b_by = bound(nbytes, 4.0 * (visible + B) * Hq * D, c["q"].dtype)

    def layer_t(x):
        return None if x is None else x[c["layer"], :, :t]

    mask = (pen == 0)[:, None, None, :]
    plan = da.kernel_plan(c["q"].dtype, B, Hq, Hkv, D, t,
                          sms=_build.sm_count(c["q"].device),
                          kv_dtype=c["kc"].dtype)
    row = {"phase": "kernel", "kernel": "K2", "case": c["name"],
           "kv": str(c["kc"].dtype).removeprefix("torch."),
           "impl": plan.impl, "splits": plan.splits,
           "split_slots": plan.split_slots,
           "max_abs_err": err, "rel_tol": REL_TOL[c["q"].dtype],
           "err_over_tol": ratio,
           "ms": device_ms(lambda: da.decode_attention(*args, **kw), iters=50),
           "plain_ms": profiled_ms(lambda: da.decode_attention_ref(*args, **kw)),
           # int8: the layer's slice dequantized, then SDPA.
           "library_ms": device_ms(lambda: _sdpa(
               c["q"], _dequant(layer_t(c["kc"]), layer_t(c["ks"]),
                                c["q"].dtype),
               _dequant(layer_t(c["vc"]), layer_t(c["vs"]), c["q"].dtype),
               mask), iters=50),
           "bound_ms": b_ms, "bound_by": b_by}
    if c["ks"] is not None:
        row["library"] = "dequantize_kv + scaled_dot_product_attention"
    _unsplit(row, lambda: da._launch(*args, max_splits=1, **kw),
             lambda g: _agree("K2", c["name"] + " unsplit", g.float(), ref,
                              ref_abs, c["q"].dtype))
    _main_path_impl("K2", row, _decode_impl(c["q"], Hkv, c["ks"] is not None))
    if c["name"] in {k2 for k2, _ in G_TILE_CASES.values()}:
        _forced_templates(
            row, lambda force: da._launch(*args, force=force, **kw),
            lambda g: _agree("K2", c["name"] + " forced", g.float(), ref,
                             ref_abs, c["q"].dtype))
    return row, err


def _paged_case(name, B, Hq, Hkv, ctx, qlens, CB, *, n_cols=None, window=None,
                seed=0, L=2, D=128, bs=16, MB=64, dt=torch.bfloat16, kv=None,
                shared=0):
    """Attention over layer L-1 of a block pool for rows whose histories
    are positions 0..ctx[b]-1 (ring order), each with a CB-token chunk of
    which qlens[b] are live, starting at position ctx[b]. Each row's blocks
    are scattered over the pool; table columns past them are sentinels.
    ``shared``: the first ``shared`` columns of every row hold the same
    blocks (a shared prefix's), which no pending slot may fall in.
    Every pending slot that still holds a visible old position (the chunk
    overwrites it on a ring wrap) gets a key 4x the group's first query
    head at that query and values of 8: a kernel that kept it would miss
    by ~8. ``kv="int8"``: the pool quantized, with its scales."""
    rng = np.random.default_rng(seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev, ring = "cuda", MB * bs
    own = [(MB if c + q > ring else max(1, -(-(c + q) // bs))) - shared
           for c, q in zip(ctx, qlens)]
    N = shared + sum(own) + 3
    perm = rng.permutation(N)
    bt = np.full((B, MB), N, np.int32)
    bt[:, :shared] = perm[:shared]
    k = shared
    for b, n in enumerate(own):
        bt[b, shared:shared + n] = perm[k:k + n]
        bt[b, shared + n:] = N + b  # sentinels (>= N)
        k += n
    kvp = _ring_positions(B, ring, ctx)
    kp = torch.randn(L, N + 1, bs, Hkv, D, generator=g, device=dev, dtype=dt)
    vp = torch.randn(L, N + 1, bs, Hkv, D, generator=g, device=dev, dtype=dt)
    q = torch.randn(B, CB, Hq, D, generator=g, device=dev, dtype=dt)
    kn = torch.randn(B, CB, Hkv, D, generator=g, device=dev, dtype=dt)
    vn = torch.randn(B, CB, Hkv, D, generator=g, device=dev, dtype=dt)
    G = Hq // Hkv
    planted = 0
    for b in range(B):
        for i in range(qlens[b]):
            t = (ctx[b] + i) % ring
            if t < shared * bs:
                raise ValueError(f"{name}: a pending slot in a shared block")
            if kvp[b, t] >= 0:
                blk = bt[b, t // bs]
                kp[L - 1, blk, t % bs] = 4 * q[b, i, ::G]
                vp[L - 1, blk, t % bs] = 8
                planted += 1
    nblk = np.minimum(MB, -(-(kvp >= 0).sum(1) // bs)).astype(np.int32)
    T = lambda x: torch.tensor(x, device=dev)  # noqa: E731
    return _quantized(dict(
        name=name, kernel="K3" if CB == 1 else "K4", kv=kv, q=q, kp=kp,
        vp=vp, kn=kn, vn=vn, qpos=T(np.asarray(ctx, np.int32)),
        qlen=T(np.asarray(qlens, np.int32)), kvp=T(kvp), bt=T(bt),
        nblk=T(nblk), slot0=T(np.asarray(ctx, np.int32) % ring),
        layer=L - 1, n_cols=n_cols, window=window, planted=planted,
        shared=shared), "kp", "vp")


def k3_cases(int8: bool = True) -> list[dict]:
    """K3's cases; the first is the serve_continuous phase's decode, the
    first int8 one (unless ``int8`` is False) the int8 phase's."""
    cases = [
        # The serve phase's decode: 8 rows at its 832-slot bucket (52 cols).
        _paged_case("k3_serve_decode", 8, 32, 32, SERVE_CTX, [1] * 8, 1,
                    n_cols=52),
        _paged_case("k3_gqa", 8, 32, 8, SERVE_CTX[::-1], [1] * 8, 1, seed=1),
        _paged_case("k3_window", 4, 32, 8, [900, 300, 1000, 20], [1] * 4, 1,
                    window=256, seed=2),
        # Wrapped rows (the pending slot holds a visible old position), an
        # empty row (nblk = 0: exactly v_new), sentinel columns.
        _paged_case("k3_wrap_empty_sentinel", 4, 32, 32, [1500, 0, 2047, 77],
                    [1] * 4, 1, seed=3),
        _paged_case("k3_fp32", 3, 8, 4, [300, 0, 1000], [1] * 3, 1, seed=4,
                    dt=torch.float32),
        # One long row, where the unsplit kernel's tail was longest: 32
        # (MHA) or 8 (GQA) blocks walked 125 table columns each.
        _paged_case("k3_long_mha", 1, 32, 32, [2000], [1], 1, MB=128,
                    seed=15),
        _paged_case("k3_long_gqa", 1, 32, 8, [2000], [1], 1, MB=128,
                    seed=16),
        # Rows whose occupied slots end inside their first split beside a
        # long row and an empty one (nblk = 0: only the merge writes it,
        # and it must give exactly v_new).
        _paged_case("k3_first_split_only", 4, 32, 8, [1000, 60, 0, 30],
                    [1] * 4, 1, seed=17),
        # The serve decode of the gptj_6b and starcoder phases.
        _paged_case("k3_gptj_serve_decode", 8, 16, 16, SERVE_CTX, [1] * 8, 1,
                    n_cols=52, D=256, seed=18),
        _paged_case("k3_starcoder_serve_decode", 8, 48, 1, SERVE_CTX,
                    [1] * 8, 1, n_cols=52, seed=19),
        # Qwen2-7B's G = 7 (K3 takes the 7 rows in one R = 8 lane tile) and
        # G = 8 at the serve decode shape.
        _paged_case("k3_qwen2_serve_decode", 8, 28, 4, SERVE_CTX, [1] * 8, 1,
                    n_cols=52, seed=20),
        _paged_case("k3_g8_serve_decode", 8, 32, 4, SERVE_CTX, [1] * 8, 1,
                    n_cols=52, seed=21),
        # G = 2 and 3 (no family has them) at the serve decode shape.
        _paged_case("k3_g2_serve_decode", 8, 32, 16, SERVE_CTX, [1] * 8, 1,
                    n_cols=52, seed=26),
        _paged_case("k3_g3_serve_decode", 8, 24, 8, SERVE_CTX, [1] * 8, 1,
                    n_cols=52, seed=27),
        # SantaCoder's G = 16 under a window; G = 48 with wrapped rows, an
        # empty row and sentinel columns, and with rows whose occupied
        # slots end in their first split beside a long row and an empty one.
        _paged_case("k3_santacoder_window", 4, 16, 1, [900, 300, 1000, 20],
                    [1] * 4, 1, window=256, seed=22),
        _paged_case("k3_starcoder_wrap_empty_sentinel", 4, 48, 1,
                    [1500, 0, 2047, 77], [1] * 4, 1, seed=23),
        _paged_case("k3_starcoder_first_split_only", 4, 48, 1,
                    [1000, 60, 0, 30], [1] * 4, 1, seed=24),
        # The serve_prefix phase's decode: 8 rows whose tables share the
        # system prompt's 37 blocks.
        _paged_case("k3_serve_prefix_shared", 8, 32, 32, PREFIX_K3_CTX,
                    [1] * 8, 1, n_cols=48, shared=SHARED_BLOCKS, seed=25),
    ]
    return cases + ([
        # The int8 pool: the int8 serve phase's decode first, then wrapped
        # and empty rows with sentinel columns under GQA, and fp32 queries
        # at head_dim 64 (the tiny reference model's instantiation).
        _paged_case("k3_int8_serve_decode", 8, 32, 32, SERVE_CTX, [1] * 8, 1,
                    n_cols=52, kv="int8"),
        _paged_case("k3_int8_gqa_wrap_empty", 4, 32, 8, [1500, 0, 2047, 77],
                    [1] * 4, 1, seed=3, kv="int8"),
        _paged_case("k3_int8_fp32_d64", 3, 8, 4, [300, 0, 1000], [1] * 3, 1,
                    seed=4, D=64, dt=torch.float32, kv="int8"),
        # StarCoder's serve decode over an int8 pool: the tile over int8
        # tiles.
        _paged_case("k3_int8_starcoder_serve_decode", 8, 48, 1, SERVE_CTX,
                    [1] * 8, 1, n_cols=52, seed=19, kv="int8"),
    ] if int8 else [])


def k4_cases(int8: bool = True) -> list[dict]:
    """K4's cases; the first is the serve_continuous phase's chunked
    step, the first int8 one (unless ``int8`` is False) the int8 phase's."""
    cases = [
        # The serve phase's chunked pass at chunked_prefill=128: prompt rows
        # at their first, second and last (37-token) chunks beside decode
        # rows.
        _paged_case("k4_serve_mixed", 8, 32, 32,
                    [0, 128, 256, 400, 700, 33, 812, 512],
                    [128, 128, 37, 1, 1, 1, 1, 1], 128, seed=5),
        _paged_case("k4_gqa_window", 4, 32, 8, [300, 0, 900, 64],
                    [128, 37, 1, 128], 128, window=256, seed=6),
        # Row 0's 100-token chunk from slot 1000 wraps onto slots 0..75,
        # which still hold visible positions: all pending.
        _paged_case("k4_ring_wrap", 3, 32, 32, [1000, 2000, 5],
                    [100, 1, 60], 128, seed=7),
        _paged_case("k4_fp32", 3, 8, 4, [30, 0, 100], [16, 5, 1], 16,
                    seed=8, dt=torch.float32),
        # Tile edges of the tensor-core instantiation: q_len not a multiple
        # of 16 (37, 100, 13) beside a decode row; GQA (G = 4) at CB 64,
        # whose 64-row tiles hold 16 queries x 4 heads; block sizes that
        # do not divide the 64-slot tile; head dims 64 and 256.
        _paged_case("k4_qlen_odd", 4, 32, 32, [0, 300, 77, 500],
                    [37, 100, 1, 13], 128, seed=9),
        _paged_case("k4_gqa_cb64", 4, 32, 8, [100, 0, 640, 33],
                    [64, 50, 1, 17], 64, seed=10),
        _paged_case("k4_bs8", 3, 32, 32, [200, 0, 90], [128, 60, 1], 128,
                    bs=8, MB=128, seed=11),
        _paged_case("k4_bs24", 3, 32, 32, [200, 0, 90], [128, 60, 1], 128,
                    bs=24, MB=43, seed=12),
        _paged_case("k4_d64", 3, 16, 4, [200, 0, 90], [128, 60, 1], 128,
                    D=64, seed=13),
        _paged_case("k4_d256", 3, 16, 8, [200, 0, 90], [128, 60, 1], 128,
                    D=256, seed=14),
        # The chunked step of the gptj_6b and starcoder phases: D 256, and
        # 48 x 128 = 6144 flat query rows per row (96 tiles).
        _paged_case("k4_gptj_serve_mixed", 8, 16, 16,
                    [0, 128, 256, 400, 700, 33, 812, 512],
                    [128, 128, 37, 1, 1, 1, 1, 1], 128, D=256, seed=20),
        _paged_case("k4_starcoder_serve_mixed", 8, 48, 1,
                    [0, 128, 256, 400, 700, 33, 812, 512],
                    [128, 128, 37, 1, 1, 1, 1, 1], 128, seed=21),
        # The serve_prefix phase's chunked step: three rows feed the
        # prefix's tail and their suffix from slot 592 over the 37 shared
        # blocks, beside five decode rows over the same blocks.
        _paged_case("k4_serve_prefix_shared", 8, 32, 32, PREFIX_K4_CTX,
                    PREFIX_K4_QLEN, 128, shared=SHARED_BLOCKS, seed=26),
    ] + _k4_split_cases()
    return cases + ([
        # The int8 pool (bf16 queries: the tensor-core tile over int8
        # tiles): the int8 serve phase's chunked step first, then a ring
        # wrap under a window and GQA, the tile edges of the bf16 cases
        # above (q_len 37 / 100 / 13, GQA at CB 64, block size 24, head
        # dims 64 and 256), and fp32 queries at head_dim 64 and CB 16 (the
        # lane template).
        _paged_case("k4_int8_serve_mixed", 8, 32, 32,
                    [0, 128, 256, 400, 700, 33, 812, 512],
                    [128, 128, 37, 1, 1, 1, 1, 1], 128, seed=5, kv="int8"),
        _paged_case("k4_int8_gqa_wrap_window", 3, 32, 8, [1000, 2000, 5],
                    [100, 1, 60], 128, window=256, seed=7, kv="int8"),
        _paged_case("k4_int8_qlen_odd", 4, 32, 32, [0, 300, 77, 500],
                    [37, 100, 1, 13], 128, seed=9, kv="int8"),
        _paged_case("k4_int8_gqa_cb64", 4, 32, 8, [100, 0, 640, 33],
                    [64, 50, 1, 17], 64, seed=10, kv="int8"),
        _paged_case("k4_int8_bs24", 3, 32, 32, [200, 0, 90], [128, 60, 1],
                    128, bs=24, MB=43, seed=12, kv="int8"),
        _paged_case("k4_int8_d64", 3, 16, 4, [200, 0, 90], [128, 60, 1], 128,
                    D=64, seed=13, kv="int8"),
        _paged_case("k4_int8_d256", 3, 16, 8, [200, 0, 90], [128, 60, 1], 128,
                    D=256, seed=14, kv="int8"),
        _paged_case("k4_int8_fp32_d64", 3, 8, 4, [30, 0, 100], [16, 5, 1], 16,
                    seed=8, D=64, dt=torch.float32, kv="int8"),
        # k4_ring_wrap over an int8 pool, then the split edges over int8.
        _paged_case("k4_int8_ring_wrap", 3, 32, 32, [1000, 2000, 5],
                    [100, 1, 60], 128, seed=7, kv="int8"),
    ] + _k4_split_cases("int8") if int8 else [])


def _k4_split_cases(kv=None) -> list[dict]:
    """K4 at the edges of the chunk tile's split along the KV axis
    (ops/split_plan.py chunk_plan: 256-slot splits, at most 4): a long
    decode row beside prefill rows at CB 128; rows whose occupied slots end
    inside their first split beside a long one and an empty one; block
    size 24, whose split boundaries (384 or 576 slots) are whole columns
    but not a multiple of 64 of them, crossed by a row; a window that
    crosses a split boundary. ``kv="int8"``: over an int8 pool."""
    tag = "k4_int8_" if kv else "k4_"
    return [
        _paged_case(tag + "long_decode_beside_prefill", 4, 32, 8,
                    [1900, 0, 300, 128], [1, 128, 128, 64], 128, MB=128,
                    seed=30, kv=kv),
        _paged_case(tag + "first_split_only", 4, 32, 32, [1000, 60, 0, 200],
                    [1, 100, 37, 1], 128, seed=31, kv=kv),
        _paged_case(tag + "bs24_split_edge", 3, 32, 32, [800, 390, 0],
                    [1, 128, 50], 128, bs=24, MB=86, seed=32, kv=kv),
        _paged_case(tag + "window_across_split", 3, 32, 8, [900, 500, 40],
                    [1, 128, 128], 128, window=300, seed=33, kv=kv),
    ]


def _paged_visibility(c):
    """[B, CB, T] bool cache visibility of every live query row (the
    plain version's mask) over the first n_cols table columns, and the
    [B, CB, CB] visibility of the fresh keys."""
    from llmss_tpu_torch.ops import attention as att

    B, CB = c["q"].shape[:2]
    bs, MB = c["kp"].shape[2], c["bt"].shape[1]
    Tv = (c["n_cols"] or MB) * bs
    kvp = c["kvp"][:, :Tv]
    rel = torch.arange(CB, device="cuda", dtype=torch.int32)
    live = rel[None, :] < c["qlen"][:, None]
    qpos = c["qpos"][:, None] + rel[None, :]
    vis = att.ragged_cache_visibility(c["qlen"], kvp, c["slot0"], MB * bs)
    mask = vis[:, None, :] & (kvp[:, None, :] <= qpos[:, :, None])
    fresh = (rel[None, :, None] >= rel[None, None, :]) & (
        rel[None, None, :] < c["qlen"][:, None, None])
    if c["window"] is not None:
        mask &= kvp[:, None, :] > qpos[:, :, None] - c["window"]
        fresh &= (rel[None, :, None] - rel[None, None, :]) < c["window"]
    return mask & live[:, :, None], fresh & live[:, :, None]


def _paged_row(kernel, c, fn, ref_fn, lib_fn, unsplit_fn=None, forced_fn=None):
    """Run one K3 / K4 case: agreement within REL_TOL, then kernel, plain,
    library and bound times, for K3 (``unsplit_fn``) the unsplit kernel's,
    and (``forced_fn(c, force)``) the three decode templates'. Returns (row,
    kernel output)."""
    from llmss_tpu_torch.ops import _build
    from llmss_tpu_torch.ops import paged_attention as pa

    dt = c["q"].dtype
    got = fn(c).float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{kernel} {c['name']}: non-finite output")
    f32 = {k: (v.float() if torch.is_tensor(v) and v.is_floating_point() else v)
           for k, v in c.items()}
    ref = ref_fn(f32)
    ref_abs = ref_fn({**f32, "vp": f32["vp"].abs(), "vn": f32["vn"].abs()})
    # Live query rows only: chunk padding (rows past q_len) is never read.
    CB = c["q"].shape[1]
    live = torch.arange(CB, device="cuda")[None, :] < c["qlen"][:, None]
    err, ratio = _agree(kernel, c["name"], got[live], ref[live], ref_abs[live],
                        dt)
    mask, fresh = _paged_visibility(c)
    B, CB, Hq, D = c["q"].shape
    Hkv = c["kp"].shape[3]
    es = c["q"].element_size()
    # K3 runs the CB = 1 launch whatever the case's chunk.
    bs, MB = c["kp"].shape[2], c["bt"].shape[1]
    plan = pa.kernel_plan(dt, CB if kernel == "K4" else 1, Hq // Hkv, D, B=B,
                          Hkv=Hkv, n_slots=(c["n_cols"] or MB) * bs, bs=bs,
                          sms=_build.sm_count(c["q"].device),
                          kv_dtype=c["kp"].dtype)
    live_q = int(c["qlen"].sum().item())
    # Visible pool slots, each counted once however many rows' tables
    # share its block.
    Tv = mask.shape[2]
    t = torch.arange(Tv, device=mask.device)
    phys = c["bt"][:, t // bs].long() * bs + (t % bs)[None, :]
    slots = int(torch.unique(phys[mask.any(1)]).numel())
    pairs = int(mask.sum().item()) + int(fresh.sum().item())
    # A visible slot's K and V rows (and, int8, their fp32 scales).
    slot_bytes = D * c["kp"].element_size() + (4 if c["ks"] is not None else 0)
    nbytes = (2 * slots * Hkv * slot_bytes + 2 * live_q * Hq * D * es
              + 2 * live_q * Hkv * D * es + mask.shape[2] * B * 4
              + c["bt"].numel() * 4)
    b_ms, b_by = bound(nbytes, 4.0 * pairs * Hq * D, dt)
    # Splits at or past a row's occupied slots return at once.
    live_splits = [-(-int(n) * bs // plan.split_slots) if plan.split_slots
                   else 1 for n in c["nblk"].tolist()]
    if kernel == "K4":  # the 64-slot tiles the chunk tile copies
        extra = {"tile_copies": _k4_tile_copies(c, mask, plan)}
    else:
        extra = {}
    row = {"phase": "kernel", "kernel": kernel, "case": c["name"],
           "kv": str(c["kp"].dtype).removeprefix("torch."), **extra,
           **({"shared_cols": c["shared"]} if c["shared"] else {}),
           "impl": plan.impl, "splits": plan.splits,
           "split_slots": plan.split_slots, "live_splits": live_splits,
           "max_abs_err": err, "rel_tol": REL_TOL[dt],
           "err_over_tol": ratio, "planted_pending_keys": c["planted"],
           "ms": device_ms(lambda: fn(c), iters=50),
           "plain_ms": profiled_ms(lambda: ref_fn(c), iters=5),
           "library_ms": device_ms(lambda: lib_fn(c, mask), iters=20),
           "bound_ms": b_ms, "bound_by": b_by}
    if c["ks"] is not None:
        row["library"] = ("gather_block_view + dequantize_kv + "
                          "scaled_dot_product_attention")
    if unsplit_fn is not None:
        _unsplit(row, lambda: unsplit_fn(c),
                 lambda g: _agree(kernel, c["name"] + " unsplit", g.float()[live],
                                  ref[live], ref_abs[live], dt))
    if forced_fn is not None:
        _forced_templates(row, lambda force: forced_fn(c, force),
                        lambda g: _agree(kernel, c["name"] + " forced",
                                         g.float()[live], ref[live],
                                         ref_abs[live], dt))
    emit(row)
    return row, got


def _k4_tile_copies(c, mask, plan) -> int | None:
    """The 64-slot K/V tiles K4's chunk tile copies at case ``c``: per (row,
    KV head, 64 flat query rows with a live query), each cache tile of which
    some live query of those rows sees a slot, and the fresh tiles up to
    its last live query (the cache tiles a split's ahead copies add when
    none of their slots is visible are not counted). None off the tile."""
    from llmss_tpu_torch.ops import split_plan as sp

    if plan.impl not in sp.TILE_IMPLS:
        return None
    B, CB, Hq, _ = c["q"].shape
    Hkv = c["kp"].shape[3]
    G, T = Hq // Hkv, mask.shape[2]
    nt = -(-T // 64)
    padded = torch.zeros(B, CB, nt * 64, dtype=torch.bool, device=mask.device)
    padded[..., :T] = mask
    copies = 0
    for f0 in range(0, CB * G, 64):
        i0, i1 = f0 // G, min(CB - 1, (f0 + 63) // G)
        seen = padded[:, i0:i1 + 1].any(1).view(B, nt, 64).any(2).sum(1)
        for b in range(B):
            ql = int(c["qlen"][b])
            if i0 < ql:
                copies += int(seen[b]) + -(-min(ql, i1 + 1) // 64)
    return copies * Hkv


def _gather_sdpa(c, mask):
    """The yardstick: gather the rows' logical views (dequantized, over an
    int8 pool), then one scaled_dot_product_attention over them (fresh
    keys left out)."""
    from llmss_tpu_torch.engine.cache import gather_block_view

    L = c["layer"]

    def view(pool, scale):
        v = gather_block_view(pool[L], c["bt"], c["n_cols"])
        if scale is None:
            return v
        return _dequant(v, gather_block_view(scale[L], c["bt"], c["n_cols"]),
                        c["q"].dtype)

    return _sdpa(c["q"], view(c["kp"], c["ks"]), view(c["vp"], c["vs"]),
                 mask[:, None])


def check_paged_kernels(out: dict) -> None:
    """K3 and K4 against their plain (fp32) versions within REL_TOL, and K3
    == K4 at CB = 1 bit for bit. The first case of each list is the shape
    the serve_continuous phase gives the kernel; its numbers go into the
    kernels line."""
    from llmss_tpu_torch.ops import paged_attention as pa

    def kw(c):
        return dict(n_cols=c["n_cols"], window=c["window"], k_scale=c["ks"],
                    v_scale=c["vs"])

    def k3(c):
        return pa.paged_decode_attention(
            c["q"], c["kp"], c["vp"], c["kn"], c["vn"], c["qpos"][:, None],
            c["kvp"], c["bt"], c["nblk"], c["slot0"][:, None], c["layer"],
            **kw(c))

    def k3_ref(c):
        return pa.paged_decode_attention_ref(
            c["q"], c["kp"], c["vp"], c["kn"], c["vn"], c["qpos"][:, None],
            c["kvp"], c["bt"], c["nblk"], c["slot0"][:, None], c["layer"],
            **kw(c))

    def k3_unsplit(c, **kw):
        return pa._launch(
            "paged_decode_attention (K3)", c["q"], c["kp"], c["vp"], c["kn"],
            c["vn"], c["qpos"][:, None], None, c["kvp"], c["bt"], c["nblk"],
            c["slot0"][:, None], c["layer"], c["n_cols"], None, c["window"],
            c["ks"], c["vs"], **(kw or {"max_splits": 1}))

    def k3_forced(c, force):
        return k3_unsplit(c, force=force)

    def k4(c):
        return pa.ragged_paged_attention(
            c["q"], c["kp"], c["vp"], c["kn"], c["vn"], c["qpos"], c["qlen"],
            c["kvp"], c["bt"], c["nblk"], c["slot0"], c["layer"], **kw(c))

    def k4_ref(c):
        return pa.ragged_paged_attention_ref(
            c["q"], c["kp"], c["vp"], c["kn"], c["vn"], c["qpos"], c["qlen"],
            c["kvp"], c["bt"], c["nblk"], c["slot0"], c["layer"], **kw(c))

    k3_list = k3_cases()
    worst = {}
    for c in k3_list:
        forced = c["name"] in {k3 for _, k3 in G_TILE_CASES.values()}
        row, got = _paged_row("K3", c, k3, k3_ref, _gather_sdpa, k3_unsplit,
                              k3_forced if forced else None)
        _main_path_impl("K3", row, _decode_impl(c["q"], c["kn"].shape[2],
                                                c["ks"] is not None))
        if c["name"] in ("k3_first_split_only",
                         "k3_starcoder_first_split_only") and (
                row["splits"] < 2 or sorted(row["live_splits"])[:3] != [0, 1, 1]):
            raise AssertionError(f"K3 {c['name']}: live splits "
                                 f"{row['live_splits']} of {row['splits']}")
        worst[c["row"]] = max(worst.get(c["row"], 0.0), row["max_abs_err"])
        out.setdefault(c["row"], row)
        out["cases"][c["name"]] = row
        G = c["q"].shape[2] // c["kn"].shape[2]
        for b in range(c["q"].shape[0]):
            if int(c["nblk"][b]) == 0 and not torch.equal(
                    got[b, 0], c["vn"][b, 0].float().repeat_interleave(G, 0)):
                raise AssertionError(f"K3 {c['name']}: empty row {b} != v_new")
        # K3 is the template at CB = 1: an all-decode K4 call is bitwise it.
        k4_cb1 = k4({**c, "qlen": torch.ones_like(c["qlen"])})
        if not torch.equal(k4_cb1.float(), got):
            raise AssertionError(f"K4 at CB=1 != K3 on {c['name']}")
    _main_path_split("K3", out["K3"], split=True)
    emit({"phase": "kernel", "check": "k3_equals_k4_at_cb1",
          "cases": len(k3_list), "bit_identical": True})

    def k4_unsplit(c):  # the chunk tile on one split
        return pa._launch(
            "ragged_paged_attention (K4)", c["q"], c["kp"], c["vp"], c["kn"],
            c["vn"], c["qpos"], c["qlen"], c["kvp"], c["bt"], c["nblk"],
            c["slot0"], c["layer"], c["n_cols"], None, c["window"], c["ks"],
            c["vs"], max_splits=1)

    for c in k4_cases():
        tile = c["q"].dtype == torch.bfloat16
        row, _ = _paged_row("K4", c, k4, k4_ref, _gather_sdpa,
                            k4_unsplit if tile else None)
        # bf16 queries over an int8 pool at CB > 1: the int8 tensor-core
        # tile; fp32 queries stay on the lanes.
        if c["ks"] is not None:
            _main_path_impl("K4", row, "mma_int8" if c["q"].dtype
                            == torch.bfloat16 else "lanes_int8")
        if c["name"] in ("k4_gptj_serve_mixed", "k4_starcoder_serve_mixed",
                         "k4_serve_prefix_shared"):
            _main_path_impl("K4", row)
        worst[c["row"]] = max(worst.get(c["row"], 0.0), row["max_abs_err"])
        out.setdefault(c["row"], row)
        out["cases"][c["name"]] = row
    _main_path_impl("K4", out["K4"])
    for name, err in worst.items():
        out[name]["max_abs_err"] = err
    # The pool at the KV heads one tp 2 rank holds (serve_parallel).
    for c in tp_paged_cases():
        kernel = c["kernel"]
        k3_case = kernel == "K3"
        row, _ = _paged_row(kernel, c, k3 if k3_case else k4,
                            k3_ref if k3_case else k4_ref, _gather_sdpa,
                            k3_unsplit if k3_case else k4_unsplit)
        if k3_case:
            _main_path_impl("K3", row, _decode_impl(c["q"], c["kn"].shape[2],
                                                    c["ks"] is not None))
        else:
            _main_path_impl("K4", row, "mma" if c["ks"] is None
                            else "mma_int8")
        out[c["row"].replace(kernel, kernel + "_tp")] = row
        out["cases"][c["name"]] = row
    for name in ("K4", "K4_int8"):
        out["vs_library"][out[name]["case"]] = (out[name]["ms"],
                                                out[name]["library_ms"])
    for name in ("k3_starcoder_serve_decode", "k3_int8_starcoder_serve_decode",
                 "k4_ring_wrap", "k4_int8_ring_wrap", "k4_gqa_cb64",
                 "k4_int8_gqa_cb64", "k4_tp2_serve_mixed",
                 "k3_serve_prefix_shared", "k4_serve_prefix_shared"):
        row = out["cases"][name]
        out["vs_library"][name] = (row["ms"], row["library_ms"])
    # A measurement, not a pass condition: kernel times vary by card.
    emit({"phase": "kernel", "check": "mma_below_library",
          "cases": {k: {"ms": a, "library_ms": b}
                    for k, (a, b) in out["vs_library"].items()},
          "all_below": all(a < b for a, b in out["vs_library"].values())})
    # A measurement: the three decode templates at each G of G_TILE_CASES,
    # forced, beside the plan's choice (G_TILE, GROUP_MAX_G).
    from llmss_tpu_torch.ops import split_plan as sp

    emit({"phase": "kernel", "check": "g_tile_lanes_vs_tile", "G_TILE": sp.G_TILE,
          "GROUP_MAX_G": sp.GROUP_MAX_G,
          "cases": {f"{k}_G{G}": {
              "case": name, "impl": out["cases"][name]["impl"],
              **{key: out["cases"][name][key] for key in FORCE},
              "fastest": min(FORCE, key=lambda key: out["cases"][name][key]),
              "group_faster_than_lanes": out["cases"][name]["group_ms"]
              < out["cases"][name]["lanes_ms"]}
              for G, names in G_TILE_CASES.items()
              for k, name in zip(("K2", "K3"), names)}})
    # A measurement too: the int8 lanes' time over the compute-dtype
    # lanes' at the main path's decode shapes, from this run.
    emit({"phase": "kernel", "check": "int8_lanes_vs_bf16", **{
        f"{k}_int8_over_{k}": {
            "cases": [out[f"{k}_int8"]["case"], out[k]["case"]],
            "ms": [out[f"{k}_int8"]["ms"], out[k]["ms"]],
            "ratio": out[f"{k}_int8"]["ms"] / out[k]["ms"]}
        for k in ("K2", "K3", "K4")}})
    # And K4's split: each case's plan beside the chunk tile on one split,
    # with the tiles it copies (k4_serve_prefix_shared against
    # k4_serve_mixed: the copies explain the ratio, or not).
    emit({"phase": "kernel", "check": "k4_split_vs_unsplit", "cases": {
        name: {k: row.get(k) for k in ("splits", "split_slots", "ms",
                                       "unsplit_ms", "tile_copies")}
        for name, row in out["cases"].items()
        if row["kernel"] == "K4" and "unsplit_ms" in row}})




# -- the mesh ------------------------------------------------------------------

SERVE_PAR_CTX = [700, 45, 300, 812]  # serve_parallel's 4 decode rows


def tp_paged_cases() -> list[dict]:
    """K3 and K4 at the 16 of Llama-2-7B's 32 KV heads a tp 2 rank's pool
    holds, bf16 and over int8: serve_parallel's 4 rows decoding in the
    832-slot bucket, and its chunked step (prompt rows at a first and a
    last 37-token chunk beside two decode rows)."""
    return [_paged_case(f"k3_tp2{s}_serve_decode", 4, 16, 16, SERVE_PAR_CTX,
                        [1] * 4, 1, n_cols=52, seed=50, kv=kv)
            for s, kv in (("", None), ("_int8", "int8"))] + [
        _paged_case(f"k4_tp2{s}_serve_mixed", 4, 16, 16, [0, 128, 700, 33],
                    [128, 37, 1, 1], 128, seed=51, kv=kv)
        for s, kv in (("", None), ("_int8", "int8"))]


# The engine phase's prefill and decode at the heads one rank holds under
# tp 2 and 4 (Llama-2-7B: 32 heads).
def tp_local_cases() -> tuple[list[dict], list[dict]]:
    k1 = [_k1_case(f"k1_tp{tp}_engine_prefill", 4, 128, 1024, 32 // tp,
                   32 // tp, lens=ENGINE_LENS, seed=20 + tp) for tp in (2, 4)]
    k2 = [_k2_case(f"k2_tp{tp}_engine_decode", 4, 1024, 32 // tp, 32 // tp,
                   [n + 40 for n in ENGINE_LENS], 192, seed=30 + tp)
          for tp in (2, 4)]
    return k1, k2


def _state_agree(kernel, name, got, ref, ref_abs, dtype) -> float:
    """A state-out kernel's (m, l, acc) against its plain version's: each
    row that sees a slot has its normalised output acc / l within
    REL_TOL (of the plain version over |v|) and its log-sum-exp within
    1e-3; a row that sees none keeps m at the fp32 minimum."""
    vis = ref[0] > -1e30
    if not torch.equal(got[0] > -1e30, vis):
        raise AssertionError(f"{kernel} {name}: rows seeing a slot differ")

    def norm(st):
        m, l, acc = st
        return acc / torch.where(l == 0, 1.0, l)[..., None]

    err, _ = _agree(kernel, name, norm(got)[vis], norm(ref)[vis],
                    norm(ref_abs)[vis], dtype)
    lse = (got[0] + torch.log(got[1]) - ref[0] - torch.log(ref[1]))[vis]
    if lse.numel() and not lse.abs().max().item() <= 1e-3:
        raise AssertionError(f"{kernel} {name}: log-sum-exp off by "
                             f"{lse.abs().max().item()}")
    return err


def _kernels_after(fn, syms, tries: int = 2) -> list[str]:
    """The names of the CUDA kernels one call of ``fn`` runs after its
    first kernel whose name holds one of ``syms``, in the order they ran
    (torch.profiler). The profiler has lost kernel records before: a call
    is profiled again, up to ``tries`` times, and the check fails if every
    profile lost that kernel's record."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in sorted(
            (e for e in prof.events() if e.device_type == DeviceType.CUDA),
            key=lambda e: e.time_range.start)]
        first = [i for i, n in enumerate(names) if any(x in n for x in syms)]
        if first:
            return names[first[0] + 1:]
    raise AssertionError(f"{tries} profiles lost the record of {syms}")


def k1_state_case() -> dict:
    """K1's state-out case: the sp = 2 second rank's 64 queries of a
    128-token prefill over its own 64-token ring block, right-padded."""
    return _k1_case("k1_state_sp2_prefill", 4, 64, 64, 32, 32,
                    lens=[n - 64 for n in ENGINE_LENS], q0=64, seed=41)


def check_mesh_kernels(kernels: dict) -> None:
    """The sharded forward's kernels: K1 and K2 at the local heads of tp 2
    and 4, and their state-out forms at the sp = 2 shapes (K1: the second
    rank's 64 queries of a 128-token prefill over its own 64-token ring
    block, causal and right-padded; K2: batch 4 over the 512-slot chunk
    that holds the prompt, 40 steps into decode), each held to its plain
    version, with kernel, plain, bound and library (SDPA: the output
    alone, no softmax state) times."""
    from llmss_tpu_torch.ops import attention as att
    from llmss_tpu_torch.ops import decode_attention as da
    from llmss_tpu_torch.ops import flash_attention as fa

    k1s, k2s = tp_local_cases()
    for name, cases, fn in (("K1_tp", k1s, _k1_row), ("K2_tp", k2s, _k2_row)):
        worst = 0.0
        for c in cases:
            row, err = fn(c)
            worst = max(worst, err)
            kernels.setdefault(name, row)
            kernels["cases"][c["name"]] = row
            emit(row)
        kernels[name]["max_abs_err"] = worst

    c = k1_state_case()
    args = (c["q"], c["k"], c["v"], c["qp"], c["kvp"])
    q32, k32, v32 = (x.float() for x in args[:3])
    got = fa.flash_attention_state(*args)
    ref = fa.flash_attention_state_ref(q32, k32, v32, c["qp"], c["kvp"])
    ref_abs = fa.flash_attention_state_ref(q32, k32, v32.abs(), c["qp"],
                                           c["kvp"])
    err = _state_agree("K1_state", c["name"], got, ref, ref_abs,
                       c["q"].dtype)
    forms = {}
    for r in fa.WGMMA_ROWS:  # each form of the wgmma tile, forced
        fn = (lambda r=r: fa._launch_state(*args, rows=r))
        _state_agree("K1_state", f"{c['name']} at {r} rows", fn(), ref,
                     ref_abs, c["q"].dtype)
        forms[f"rows_{r}_ms"] = device_ms(fn)
    B, S, Hq, D = c["q"].shape
    mask = att.make_causal_mask(c["qp"], c["kvp"], c["kvp"] >= 0)
    live = int((c["kvp"] >= 0).sum().item())
    nbytes = (c["q"].numel() * 2 + 2 * live * Hq * D * 2
              + B * S * Hq * (D + 2) * 4 + (c["qp"].numel()
                                            + c["kvp"].numel()) * 4)
    b_ms, b_by = bound(nbytes, 4.0 * int(mask.sum().item()) * Hq * D,
                       c["q"].dtype)
    plan = _k1_plan(c)
    row = {"phase": "kernel", "kernel": "K1_state", "case": c["name"],
           "impl": plan.impl, "rows": plan.rows,
           "tiles": _k1_tiles(c, plan.rows),
           "max_abs_err": err,
           "rel_tol": REL_TOL[c["q"].dtype],
           "ms": device_ms(lambda: fa.flash_attention_state(*args)),
           "plain_ms": profiled_ms(lambda: fa.flash_attention_state_ref(
               *args)),
           "library_ms": device_ms(lambda: _sdpa(c["q"], c["k"], c["v"],
                                                 mask[:, None])),
           "library": "scaled_dot_product_attention (output, no state)",
           "bound_ms": b_ms, "bound_by": b_by, **forms}
    kernels["K1_state"] = row
    kernels["cases"][c["name"]] = row
    emit(row)

    c = _k2_case("k2_state_sp2_decode", 4, 512, 32, 32,
                 [n + 40 for n in ENGINE_LENS], 512, seed=42)
    args = (c["q"], c["kc"], c["vc"], c["qpos"], c["kvp"], c["slots"],
            c["layer"])
    q32, kc32, vc32 = (x.float() for x in args[:3])
    got = da.decode_attention_state(*args)
    ref = da.decode_attention_state_ref(q32, kc32, vc32, *args[3:])
    ref_abs = da.decode_attention_state_ref(q32, kc32, vc32.abs(), *args[3:])
    err = _state_agree("K2_state", c["name"], got, ref, ref_abs,
                       c["q"].dtype)
    B, _, Hq, D = c["q"].shape
    pen = att.decode_mask_penalty(c["qpos"], c["kvp"], c["slots"])
    visible = int((pen == 0).sum().item())
    nbytes = (2 * visible * Hq * D * 2 + c["q"].numel() * 2
              + B * Hq * (D + 2) * 4 + c["kvp"].numel() * 4 + 2 * B * 4)
    b_ms, b_by = bound(nbytes, 4.0 * visible * Hq * D, c["q"].dtype)
    layer = c["layer"]
    plan = da.kernel_plan(c["q"].dtype, B, Hq, Hq, D, 512)
    # The splits are folded in the launch: after the decode kernel, at
    # most its merge runs, and no torch operation.
    after = _kernels_after(lambda: da.decode_attention_state(*args),
                           ("decode_fwd", "decode_mma", "decode_group"))
    if any("split_merge" not in n for n in after):
        raise AssertionError(f"K2_state: {after} ran after the decode kernel")
    row = {"phase": "kernel", "kernel": "K2_state", "case": c["name"],
           "impl": plan.impl, "splits": plan.splits,
           "kernels_after_launch": after, "max_abs_err": err,
           "rel_tol": REL_TOL[c["q"].dtype],
           "ms": device_ms(lambda: da.decode_attention_state(*args),
                           iters=50),
           "plain_ms": profiled_ms(lambda: da.decode_attention_state_ref(
               *args)),
           "library_ms": device_ms(lambda: _sdpa(
               c["q"], c["kc"][layer], c["vc"][layer],
               (pen == 0)[:, None, None, :]), iters=50),
           "library": "scaled_dot_product_attention (output, no state)",
           "bound_ms": b_ms, "bound_by": b_by}
    kernels["K2_state"] = row
    kernels["cases"][c["name"]] = row
    emit(row)


# The reference_parallel phase's tiny fp32 families (head_dim 64, which
# the kernels take): GQA with 4 KV heads; MQA with learned positions; a
# tied head over a vocabulary (and position table) tp 4 does not divide.
PAR_FAMILIES = {
    "llama": dict(model_type="llama", vocab_size=128, hidden_size=256,
                  n_layers=2, n_heads=8, n_kv_heads=4, head_dim=64,
                  intermediate_size=256, max_position_embeddings=128,
                  activation="silu", norm="rmsnorm", mlp="swiglu",
                  positions="rotary", rope_style="half", rotary_dim=64,
                  attn_bias=False, mlp_bias=False,
                  tie_word_embeddings=False, dtype="float32"),
    "gpt_bigcode": dict(model_type="gpt_bigcode", vocab_size=128,
                        hidden_size=256, n_layers=2, n_heads=8, n_kv_heads=1,
                        head_dim=64, intermediate_size=256,
                        max_position_embeddings=64, activation="gelu",
                        norm="layernorm", mlp="gelu", positions="learned",
                        attn_bias=True, mlp_bias=True,
                        tie_word_embeddings=True, dtype="float32"),
    "gpt2": dict(model_type="gpt2", vocab_size=129, hidden_size=256,
                 n_layers=2, n_heads=4, n_kv_heads=4, head_dim=64,
                 intermediate_size=256, max_position_embeddings=66,
                 activation="gelu_new", norm="layernorm", mlp="gelu",
                 positions="learned", attn_bias=True, mlp_bias=True,
                 tie_word_embeddings=True, dtype="float32"),
}
PAR_PLANS = {2: [(1, 1, 2), (1, 2, 1), (2, 1, 1)], 4: [(1, 1, 4)],
             8: [(2, 2, 2)]}
PAR_PROMPTS = [list(range(1, 30)), [7, 8, 9], [5] * 17, [3, 1, 4, 1, 5]]


def _par_gens():
    from llmss_tpu_torch.engine.engine import GenerationParams

    return [GenerationParams(max_new_tokens=6),
            GenerationParams(max_new_tokens=6, is_greedy=False, seed=3,
                             top_k=20),
            GenerationParams(max_new_tokens=5),
            GenerationParams(max_new_tokens=6, is_greedy=False, seed=9,
                             top_p=0.9)]


PAR_PREFIX = list(range(40, 60))  # one full block of 16
# The paged batcher's passes on the tiny families' worlds: by world size,
# the plan; the passes' batcher settings.
PAR_SERVE_PLANS = {2: (1, 1, 2), 4: (2, 1, 2)}
PAR_SERVE_FAMILIES = ("llama", "gpt_bigcode")  # GQA and MQA
PAR_SERVE_PASSES = {"split": dict(rows=3, chunk_steps=2, group_chunks=2),
                    "chunked": dict(rows=3, chunk_steps=2, group_chunks=2,
                                    chunked_prefill=16)}


def _par_schedule():
    """The paged batcher's schedule on the tiny families (the CPU tests'
    shape): admissions mid-stream, greedy and sampled rows, a cancel and
    a shared prefix (``ServeJob.passes``' ``schedule``)."""
    from llmss_tpu_torch.engine.engine import GenerationParams

    g = GenerationParams(max_new_tokens=8)
    s = GenerationParams(max_new_tokens=7, is_greedy=False, seed=3, top_k=20)
    return [
        [("submit", "a", list(range(2, 22)), g, None),
         ("submit", "b", [5, 9, 23], s, None)],
        [],
        [("submit", "c", PAR_PREFIX + [50, 51], g, PAR_PREFIX),
         ("submit", "d", [7] * 7, g, None)],
        [("cancel", "b")],
        [("submit", "e", PAR_PREFIX + [60], s, PAR_PREFIX),
         ("submit", "f", [1, 2, 3, 4, 5], g, None)],
    ]


def _schedule_pass(eng, batcher: dict, schedule) -> dict:
    """One process's ContinuousBatcher through ``schedule``
    (``parallel.launch.run_schedule``): req_id -> (tokens, cancelled)."""
    from llmss_tpu_torch.engine.scheduler import ContinuousBatcher

    answers: dict = {}
    run_schedule(ContinuousBatcher(eng, **batcher), schedule, answers)
    return {rid: (a["tokens"], bool(a["cancelled"]))
            for rid, a in answers.items()}


def _check_serve_world(what: str, ranks: list, want: dict) -> dict:
    """A serving world's pass on every rank: the tokens (and the cancel)
    equal ``want``, one digest chain that every follower checked step by
    step, the pool drained to 0 once the idle prefix is evicted, no
    capture under gloo. Returns the rank 0 pass."""
    for p in ranks:
        got = {rid: (o["tokens"], o["cancelled"])
               for rid, o in p["outputs"].items()}
        if got != want:
            raise AssertionError(f"{what}: a rank's tokens differ")
    if len({(p["chain"], p["steps"]) for p in ranks}) != 1 or any(
            p["checked"] < p["steps"] for p in ranks[1:]):
        raise AssertionError(f"{what}: the ranks' digests differ")
    if any(p["blocks_drained"] or p["graph_captures"] for p in ranks):
        raise AssertionError(f"{what}: blocks left or graphs captured")
    return ranks[0]


def phase_reference_parallel() -> None:
    """Worlds of ranks sharing the one card, over gloo with CUDA tensors
    (NCCL refuses two ranks on one device): the test plans tp 2, sp 2,
    dp 2 (two ranks), tp 4 (four) and dp 2 x sp 2 x tp 2 (eight), each
    running the three tiny fp32 families, prewarmed, greedy and sampled
    rows at chunk_steps 4. Every rank's card tokens equal the port's
    single-process CPU tokens, no graph is captured under gloo (the steps
    run eagerly), and every collective went through the host (counted).
    Then, in the tp 2 and the tp 4 worlds, the llama and gpt_bigcode
    families' paged batcher on tp 2 and dp 2 x tp 2 (``serve_job``: rank 0 leads), split and
    chunked (16) passes of ``_par_schedule``: every rank's tokens equal
    the port's single-process CPU batcher's, the ranks' digests are equal
    at every step, and each pool drains to 0."""
    from llmss_tpu_torch.engine.engine import DecodeEngine
    from llmss_tpu_torch.models.common import DecoderConfig
    from llmss_tpu_torch.models.decoder import init_params
    from llmss_tpu_torch.parallel.launch import (
        EngineJob, ServeJob, World, file_init, run_jobs,
    )

    gens = _par_gens()
    ported, want, want_serve = {}, {}, {}
    for i, (fam, kw) in enumerate(PAR_FAMILIES.items()):
        cfg = DecoderConfig(**kw)
        params = _scaled(init_params(cfg, seed=i, device="cpu"), 10.0)
        ported[fam] = (cfg, params)
        want[fam] = DecodeEngine(cfg, params, device="cpu",
                                 max_seq_len=64).generate(PAR_PROMPTS, gens)
        if fam not in PAR_SERVE_FAMILIES:
            continue
        paged = DecodeEngine(cfg, params, device="cpu", max_seq_len=64,
                             kv_layout="paged", block_size=16)
        for mode, bkw in PAR_SERVE_PASSES.items():
            want_serve[fam, mode] = _schedule_pass(paged, bkw,
                                                   _par_schedule())
    tmp = tempfile.mkdtemp(prefix="llmss-rdv")  # the worlds' rendezvous
    t0 = time.perf_counter()

    def serve_jobs(size):
        if size not in PAR_SERVE_PLANS:
            return []
        return [ServeJob(
            cfg=cfg, plan=PAR_SERVE_PLANS[size], params=params,
            device="cuda", backend="gloo", max_seq_len=64, block_size=16,
            passes=[dict(batcher=bkw, schedule=_par_schedule())
                    for bkw in PAR_SERVE_PASSES.values()])
            for cfg, params in (ported[f] for f in PAR_SERVE_FAMILIES)]

    started = {size: World(
        run_jobs, size,
        [EngineJob(cfg=cfg, plan=plan, prompts=PAR_PROMPTS, params=params,
                   device="cuda", backend="gloo", max_seq_len=64,
                   prewarm=(4,) if size == 2 else (), logits=False,
                   runs=[("generate", gens, 4)])
         for plan in plans for cfg, params in ported.values()]
        + serve_jobs(size),
        init_method=file_init(os.path.join(tmp, f"w{size}")),
        backend="gloo", device="cuda", timeout=600)
        for size, plans in PAR_PLANS.items()}
    rows, serve_rows = [], []
    for size, plans in PAR_PLANS.items():
        res = started[size].results()
        n_engine = len(plans) * len(PAR_FAMILIES)
        for j, fam in enumerate(PAR_SERVE_FAMILIES):
            if size not in PAR_SERVE_PLANS:
                break
            for k, mode in enumerate(PAR_SERVE_PASSES):
                plan = PAR_SERVE_PLANS[size]
                p0 = _check_serve_world(
                    f"reference_parallel serving {plan} {fam} {mode}",
                    [r[n_engine + j]["passes"][k] for r in res],
                    want_serve[fam, mode])
                serve_rows.append({
                    "plan": dict(zip(("dp", "sp", "tp"), plan)),
                    "family": fam, "admission": mode, "ranks": size,
                    "tokens_equal_cpu": True, "digests_equal": True,
                    "steps": p0["steps"], "blocks_idle": p0["blocks_idle"],
                    "blocks_drained": 0, "launches_rank0": p0["launches"]})
        i = 0
        for plan in plans:
            for fam in PAR_FAMILIES:
                ranks = [r[i] for r in res]
                i += 1
                for r in ranks:
                    if r["runs"][0] != want[fam]:
                        raise AssertionError(
                            f"reference_parallel {plan} {fam}: rank "
                            f"{r['coords']} tokens differ from the CPU's")
                    if r["graph_captures"] or (size == 2 and not r["warmed"]):
                        raise AssertionError(
                            f"reference_parallel {plan} {fam}: "
                            f"{r['graph_captures']} captures under gloo")
                    if not r["host_staging"]["calls"] and size > 1:
                        raise AssertionError("gloo on CUDA staged nothing")
                rows.append({"plan": dict(zip(("dp", "sp", "tp"), plan)),
                             "family": fam, "ranks": len(ranks),
                             "tokens_equal_cpu": True,
                             "graph_captures": 0,
                             "host_staging_calls": ranks[0]["host_staging"][
                                 "calls"],
                             "launches_rank0": ranks[0]["launches"]})
    shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "reference_parallel", "backend": "gloo (CUDA tensors, "
          "host-staged)", "worlds": sorted(PAR_PLANS), "cases": rows,
          "serving": serve_rows, "worlds_s": time.perf_counter() - t0})


NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
              5: "empty", 6: "wait_event", 7: "event_record"}


def _node_types(graph) -> dict:
    """How many nodes of each type a captured graph holds (libcuda)."""
    cu = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(raw, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    out: dict = {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)):
            raise RuntimeError("cuGraphNodeGetType failed")
        name = NODE_TYPES.get(kind.value, str(kind.value))
        out[name] = out.get(name, 0) + 1
    return out


def _first_layers(params, n: int):
    """``params`` with only the first ``n`` layers of every block
    parameter (views)."""
    def cut(p):
        return type(p)(*(None if x is None else x[:n] for x in p))

    return {**params, "blocks": {k: cut(p) for k, p in
                                 params["blocks"].items()}}


def _scaled(p, f):
    if p is None:
        return None
    if isinstance(p, dict):
        return {k: _scaled(v, f) for k, v in p.items()}
    if isinstance(p, tuple):
        return type(p)(*(_scaled(x, f) for x in p))
    return p * f


PAR_NEW = 64  # new tokens per row in the parallel phase


def phase_parallel(bf16: dict, kernels: dict, smi: str) -> None:
    """The mesh at Llama-2-7B width: the engine phase's weights (its seed;
    each rank's shard a slice of them), batch 4, its prompts, 64 new
    tokens, ring 1024, chunk_steps 8, one sampled row. tp = 2 and sp = 2,
    each as two processes sharing the card over gloo (eager: no capture;
    the two worlds at once, each rank drawing only its slices):
    the share of tokens equal to the single-process engine's, first-token
    logits within 5% of its largest (asserted), decode ms per step,
    per-rank weight bytes and the K1 / K2 launches per prefill and per
    step on each rank (asserted: n_layers; sp: K1's state-out n_layers x
    sp per prefill, one a ring hop, K2's n_layers per step). Then a mesh
    of one rank over NCCL in this process: it issues no collective (an
    axis of one rank drops them, as XLA does), prewarm captures its step
    graphs, its tokens equal the engine phase's, and nothing is captured
    after the prewarm. An NCCL collective inside a captured graph needs
    two cards: not shown here."""
    from llmss_tpu_torch.engine.engine import DecodeEngine, GenerationParams
    from llmss_tpu_torch.models.common import DecoderConfig
    from llmss_tpu_torch.models.decoder import init_params
    from llmss_tpu_torch.parallel import MeshPlan, make_mesh
    from llmss_tpu_torch.parallel.sharding import COLLECTIVES
    from llmss_tpu_torch.parallel.launch import (
        EngineJob, World, engine_job, file_init,
    )

    cfg = DecoderConfig(**LLAMA2_7B)
    L, B = cfg.n_layers, 4
    prompts = bf16["prompts"]
    sampled = GenerationParams(max_new_tokens=PAR_NEW, is_greedy=False,
                               temperature=0.8, top_k=40, top_p=0.9,
                               seed=1234)
    gens = [GenerationParams(max_new_tokens=PAR_NEW)] * 3 + [sampled]
    want = bf16["tokens"]  # the engine phase's generate at chunk_steps 8
    want_logits = bf16["first_logits"]
    tmp = tempfile.mkdtemp(prefix="llmss-rdv")  # the worlds' rendezvous
    steps8 = math.ceil((PAR_NEW - 1) / 8) * 8
    # Both worlds at once, sharing the card (and the host's cores).
    t0 = time.perf_counter()
    plans = (((1, 1, 2), "tp2"), ((1, 2, 1), "sp2"))
    started = [World(engine_job, 2, EngineJob(
        cfg=cfg, plan=plan, prompts=prompts, seed=0, device="cuda",
        backend="gloo", max_seq_len=1024, runs=[("generate", gens, 8)]),
        init_method=file_init(os.path.join(tmp, name)), backend="gloo",
        device="cuda", timeout=900) for plan, name in plans]
    for (plan, name), world in zip(plans, started):
        res = world.results()
        toks = [r["runs"][0] for r in res]
        if toks[0] != toks[1]:
            raise AssertionError(f"parallel {name}: the ranks' tokens differ")
        flat = [t for row in toks[0] for t in row]
        ref = [t for row in want for t in row]
        share = sum(a == b for a, b in zip(flat, ref)) / max(1, len(ref))
        lg = res[0]["logits"]
        rel = float(np.abs(lg - want_logits.numpy()).max()
                    / np.abs(want_logits.numpy()).max())
        if not rel <= PREFIX_LOGITS_REL:
            raise AssertionError(f"parallel {name}: first-token logits off "
                                 f"by {rel:.3g} of the largest")
        sp = plan[1]
        for r in res:
            n = r["launches"]
            k1_want = L * sp  # one prefill; sp ring hops a layer
            k2_want = L * steps8
            if n["flash_attention"] != k1_want or \
                    n["decode_attention"] != k2_want or \
                    (sp > 1) != bool(n["flash_attention_state"]) or \
                    (sp > 1 and n["decode_attention_state"] != k2_want):
                raise AssertionError(f"parallel {name}: launches {n}, want "
                                     f"K1 {k1_want}, K2 {k2_want}")
            if r["graph_captures"]:
                raise AssertionError(f"parallel {name}: graph captures under "
                                     "gloo")
        if name == "tp2":
            kernels["K1_tp"]["launches"] = res[0]["launches"][
                "flash_attention"]
            kernels["K2_tp"]["launches"] = res[0]["launches"][
                "decode_attention"]
        else:
            kernels["K1_state"]["launches"] = res[0]["launches"][
                "flash_attention_state"]
            kernels["K2_state"]["launches"] = res[0]["launches"][
                "decode_attention_state"]
        emit({"phase": "parallel", "plan": name, "card": smi,
              "backend": "gloo (CUDA tensors, host-staged)", "ranks": 2,
              "tokens_equal_single_process_share": share,
              "first_logits_max_rel": rel,
              "decode_ms_per_step_chunk8": res[0]["decode_ms"][0],
              "ttft_ms": res[0]["ttft_ms"][0],
              "weight_bytes_per_rank": [r["weight_bytes"] for r in res],
              "launches_per_rank": [r["launches"] for r in res],
              "k1_per_prefill": res[0]["launches"]["flash_attention"],
              "k2_per_step": res[0]["launches"]["decode_attention"]
              // steps8,
              "host_staging_per_rank": [r["host_staging"] for r in res],
              "graph_captures": 0,
              "seconds_both_worlds": time.perf_counter() - t0})
    shutil.rmtree(tmp, ignore_errors=True)

    # A mesh of one rank over NCCL, in this process.
    t0 = time.perf_counter()
    mesh = make_mesh(MeshPlan(tp=1))
    eng = DecodeEngine(cfg, init_params(cfg, seed=0), mesh=mesh,
                       batch_size=B, max_seq_len=1024)
    before = dict(COLLECTIVES)
    warmed = eng.prewarm(B, chunk_steps=8)
    captured = eng.metrics.graph_captures
    issued = {k: v - before[k] for k, v in COLLECTIVES.items()}
    kinds = [_node_types(step.graph) for e in eng._graphs._entries.values()
             for key, step in e.steps.items() if step is not None
             and key[0] == "plain"]
    if not captured or any(issued.values()):
        raise AssertionError(f"NCCL mesh of one: {captured} captures, "
                             f"collectives {issued}")
    t1 = time.perf_counter()
    got = eng.generate(prompts, gens, chunk_steps=8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    after = eng.metrics.graph_captures - captured
    if got != want or after:
        raise AssertionError(f"NCCL mesh of one: tokens equal "
                             f"{got == want}, {after} captures after prewarm")
    emit({"phase": "parallel", "plan": "nccl_world1", "card": smi,
          "backend": mesh.backend, "prewarm": warmed,
          "graph_captures_prewarm": captured,
          "collectives_issued_in_prewarm": issued,
          "decode_step_graph_nodes": kinds[0],
          "tokens_equal_mesh_none": True, "graph_captures_after_prewarm": 0,
          "decode_ms_per_step_chunk8":
              eng.metrics.decode_step.to_dict()["mean_ms"],
          "tokens_per_s": B * PAR_NEW / wall,
          "seconds": time.perf_counter() - t0})
    del eng
    torch.distributed.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()

SERVE_PAR_NEW = 32  # new tokens per serve_parallel request
SERVE_PAR_REQUESTS = 8  # the first of serve_continuous's requests
SERVE_PAR_BATCHER = dict(rows=4, chunk_steps=8, group_chunks=2)
SERVE_PAR_ENGINE = dict(max_seq_len=1024, block_size=16, kv_blocks=256)
# serve_parallel's passes: (name, KV dtype, chunked_prefill, requests);
# the int8 pass serves one wave of rows.
SERVE_PAR_PASSES = (("split", None, None, SERVE_PAR_REQUESTS),
                    ("chunked", None, 128, SERVE_PAR_REQUESTS),
                    ("int8_chunked", "int8", 128, 4))


def _serve_par_pass(eng, requests, chunked, *, prewarm=False):
    """One pass of ``requests`` through a ContinuousWorker on ``eng`` in
    this process (4 rows, over an InProcBroker): (tokens by request, the
    graphs the prewarm captured, the captures after it)."""
    from llmss_tpu_torch.serve.broker import InProcBroker
    from llmss_tpu_torch.serve.consumer import ContinuousWorker

    w = ContinuousWorker(eng, InProcBroker(), poll_timeout_s=0.0,
                         chunked_prefill=chunked, **SERVE_PAR_BATCHER)
    warm = 0
    if prewarm:
        w.prewarm()
        warm = eng.metrics.graph_captures
    reqs, answers = requests(), {}
    serve_requests(w, reqs, answers)
    if any(a["error"] for a in answers.values()) or (
            w.batcher.allocator.blocks_in_use):
        raise AssertionError("serve_parallel: a single-process pass failed")
    return ([answers[r.id]["tokens"] for r in reqs], warm,
            eng.metrics.graph_captures - warm)


def phase_serve_parallel(kernels: dict, smi: str) -> None:
    """Serving on a mesh at Llama-2-7B width and all 32 layers (random bf16
    weights from seed 0; each rank draws only its slices): a tp 2 gloo
    world alone on the card, a ContinuousWorker on rank 0 over an
    InProcBroker in rank 0's process, rank 1 following
    (parallel/serving.py), 4 rows, max_seq_len 1024, a 256-block pool of
    16, chunk_steps 8, group_chunks 2; serve_continuous's first 8
    requests (prompts of 53-619 tokens) with 32 new tokens each, in a
    split pass and a chunked (128) pass, and the first 4 in a chunked
    pass over an int8 pool.
    Asserted per pass: every request answered once, rank 1's rows equal
    rank 0's answers, the ranks' digest chains equal (rank 1 checked rank
    0's digest before every step), each pool drained to 0 blocks, K3
    launches = n_layers per decode step and K4 = n_layers per ragged step
    on each rank (wrapper counters; the steps run eagerly under gloo).
    Measured: the share of tokens equal to the same pass in one process
    (bf16: sums in another order), decode ms a step, TTFT p50 and the
    control's host ms a step (rank 0: broadcast, events, digest; rank
    1: events, digest), weight and pool bytes a rank, the pass's wall.
    Before the world starts (so that its timings are its own), this
    process runs the same passes with no mesh, then the chunked pass's
    batcher on an NCCL mesh of one: prewarm captures, its tokens equal
    the one-process pass's exactly, and nothing is captured after the
    prewarm."""
    from llmss_tpu_torch.engine.engine import DecodeEngine
    from llmss_tpu_torch.models.common import DecoderConfig
    from llmss_tpu_torch.models.decoder import init_params
    from llmss_tpu_torch.parallel import MeshPlan, make_mesh
    from llmss_tpu_torch.parallel.launch import (
        ServeJob, World, file_init, run_jobs,
    )

    t_phase = time.perf_counter()
    cfg = DecoderConfig(**LLAMA2_7B)
    L = cfg.n_layers
    lens, maker = _serve_requests(cfg, new=SERVE_PAR_NEW)

    def requests(n=SERVE_PAR_REQUESTS):
        return lambda: maker()[:n]

    ekw = dict(kv_layout="paged", **SERVE_PAR_ENGINE)
    # First, alone on the card: the same passes in this process (no
    # mesh), then the chunked one on an NCCL mesh of one.
    params = init_params(cfg, seed=0)
    single = {}
    for name, kv, chunked, n in SERVE_PAR_PASSES:
        eng = DecodeEngine(cfg, params, kv_dtype=kv, **ekw)
        single[name] = _serve_par_pass(eng, requests(n), chunked)[0]
        del eng
    t1 = time.perf_counter()
    mesh = make_mesh(MeshPlan(tp=1))
    eng = DecodeEngine(cfg, params, mesh=mesh, **ekw)
    toks, warm, after = _serve_par_pass(eng, requests(), 128, prewarm=True)
    if toks != single["chunked"] or after or not warm:
        raise AssertionError(
            f"serve_parallel NCCL mesh of one: tokens equal "
            f"{toks == single['chunked']}, {warm} captures in the prewarm, "
            f"{after} after it")
    emit({"phase": "serve_parallel", "pass": "nccl_world1_chunked",
          "card": smi, "backend": mesh.backend,
          "tokens_equal_single_process": True,
          "graph_captures_prewarm": warm, "graph_captures_after_prewarm": 0,
          "decode_ms_per_step": eng.metrics.decode_step.to_dict()["mean_ms"],
          "seconds": time.perf_counter() - t1})
    del eng, params
    torch.distributed.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    # Then the tp 2 world, alone on the card.
    passes = [dict(batcher=dict(SERVE_PAR_BATCHER, chunked_prefill=chunked),
                   kv_dtype=kv, requests=maker()[:n])
              for _, kv, chunked, n in SERVE_PAR_PASSES]
    tmp = tempfile.mkdtemp(prefix="llmss-rdv")
    t0 = time.perf_counter()
    res = World(run_jobs, 2, [ServeJob(
        cfg=cfg, plan=(1, 1, 2), seed=0, device="cuda", backend="gloo",
        passes=passes, **SERVE_PAR_ENGINE)],
        init_method=file_init(os.path.join(tmp, "serve")), backend="gloo",
        device="cuda", timeout=900).results()
    world_s = time.perf_counter() - t0
    shutil.rmtree(tmp, ignore_errors=True)
    launches = {}
    for k, (name, kv, chunked, _) in enumerate(SERVE_PAR_PASSES):
        ranks = [r[0]["passes"][k] for r in res]
        ids = [r.id for r in passes[k]["requests"]]
        p0 = ranks[0]
        toks = [p0["outputs"][i]["tokens"] for i in ids]
        if any(p0["outputs"][i]["error"] or len(t) != SERVE_PAR_NEW
               for i, t in zip(ids, toks)):
            raise AssertionError(f"serve_parallel {name}: a bad answer")
        if any({i: o["tokens"] for i, o in p["outputs"].items()}
               != {i: o["tokens"] for i, o in p0["outputs"].items()}
               for p in ranks[1:]):
            raise AssertionError(f"serve_parallel {name}: rank 1's rows "
                                 "differ from rank 0's answers")
        if len({(p["chain"], p["steps"]) for p in ranks}) != 1 or any(
                p["checked"] < p["steps"] for p in ranks[1:]):
            raise AssertionError(f"serve_parallel {name}: digests differ")
        for p in ranks:
            n = p["launches"]
            if (p["blocks_drained"] or n["k3"] != L * p["decode_steps"]
                    or n["k4"] != L * p["ragged_steps"]
                    or (chunked is not None) != bool(n["k4"])):
                raise AssertionError(
                    f"serve_parallel {name}: blocks {p['blocks_drained']}, "
                    f"launches {n} for {p['decode_steps']} decode and "
                    f"{p['ragged_steps']} ragged steps")
        launches[name] = p0["launches"]
        flat = [t for row in toks for t in row]
        ref = [t for row in single[name] for t in row]
        emit({"phase": "serve_parallel", "pass": name, "card": smi,
              "plan": "tp2", "backend": "gloo (CUDA tensors, host-staged)",
              "ranks": 2, "requests": len(ids), "new_tokens": SERVE_PAR_NEW,
              "prompt_lens": lens[:len(ids)],
              "answered_once": True, "digests_equal": True,
              "steps": p0["steps"], "blocks_drained_per_rank": 0,
              "tokens_equal_single_process_share":
                  sum(a == b for a, b in zip(flat, ref)) / len(ref),
              "agreement": _agreement(toks, single[name]),
              "wall_s": p0["wall_s"],
              "decode_ms_per_step": p0["decode_ms_per_step"],
              "ttft_p50_ms": p0["ttft_p50_ms"],
              "ttft_min_max_ms": p0["ttft_min_max_ms"],
              "control_ms_per_step": [p["control_ms_per_step"]
                                      for p in ranks],
              "decode_steps": p0["decode_steps"],
              "ragged_steps": p0["ragged_steps"],
              "launches_per_rank": [p["launches"] for p in ranks],
              "k3_per_decode_step": L, "k4_per_ragged_step": L,
              "weight_bytes_per_rank": [r[0]["weight_bytes"] for r in res],
              "pool_bytes_per_rank": [p["pool_bytes"] for p in ranks]})
    kernels["K3_tp"]["launches"] = (launches["split"]["k3"]
                                    + launches["chunked"]["k3"])
    kernels["K4_tp"]["launches"] = launches["chunked"]["k4"]
    kernels["K3_tp_int8"]["launches"] = launches["int8_chunked"]["k3"]
    kernels["K4_tp_int8"]["launches"] = launches["int8_chunked"]["k4"]
    emit({"phase": "serve_parallel", "world_s": world_s,
          "seconds": time.perf_counter() - t_phase})

# -- phase 4 -------------------------------------------------------------------


def _to(p, dev):
    """A parameter tree moved to ``dev``."""
    if isinstance(p, dict):
        return {k: _to(v, dev) for k, v in p.items()}
    if isinstance(p, tuple):
        return type(p)(*(_to(x, dev) for x in p))
    return None if p is None else p.to(dev)


def phase_reference() -> None:
    """Tokens through the kernels on the card == tokens through the plain
    path on the CPU, for a tiny fp32 llama (TF32 is off)."""
    from llmss_tpu_torch.engine.engine import DecodeEngine, GenerationParams
    from llmss_tpu_torch.models.decoder import init_params

    cfg = _tiny_llama()
    cpu_params = init_params(cfg, seed=3, device="cpu")
    prompts = [[int(t) for t in np.random.default_rng(s).integers(1, 512, n)]
               for s, n in ((0, 20), (1, 7), (2, 33))]
    gen = GenerationParams(max_new_tokens=16)
    want = DecodeEngine(cfg, cpu_params, device="cpu", max_seq_len=64).generate(
        prompts, gen, chunk_steps=4)
    eng = DecodeEngine(cfg, _to(cpu_params, "cuda"), max_seq_len=64)
    got = eng.generate(prompts, gen, chunk_steps=4)
    m = eng.metrics
    emit({"phase": "reference", "identical": got == want, "tokens": got,
          "graph_captures": m.graph_captures, "graph_replays": m.graph_replays})
    if got != want:
        raise AssertionError(f"GPU tokens {got} != CPU plain-path tokens {want}")
    if not m.graph_replays:
        raise AssertionError("the decode steps were not graph replays")


def _tiny_llama():
    """The reference phases' model: a tiny fp32 llama (D 64, GQA 2)."""
    from llmss_tpu_torch.models.common import DecoderConfig

    return DecoderConfig(**{
        **LLAMA2_7B, "vocab_size": 512, "hidden_size": 256, "n_layers": 2,
        "n_heads": 4, "n_kv_heads": 2, "head_dim": 64, "rotary_dim": 64,
        "intermediate_size": 512, "dtype": "float32",
    })


def phase_reference_int8() -> None:
    """The int8 cache on the tiny fp32 llama: greedy tokens through the
    int8 kernels on the card (K1 over the dequantized layer, K2 with the
    scales folded in), decoding by graph replays, equal the plain path's on
    the CPU; then the paged batcher over an int8 pool, split and chunked
    (``phase_reference_paged``)."""
    from llmss_tpu_torch.engine.engine import DecodeEngine, GenerationParams
    from llmss_tpu_torch.models.decoder import init_params
    from llmss_tpu_torch.ops import decode_attention as da

    cfg = _tiny_llama()
    cpu_params = init_params(cfg, seed=3, device="cpu")
    prompts = [[int(t) for t in np.random.default_rng(s).integers(1, 512, n)]
               for s, n in ((0, 20), (1, 7), (2, 33))]
    gen = GenerationParams(max_new_tokens=16)
    want = DecodeEngine(cfg, cpu_params, device="cpu", max_seq_len=64,
                        kv_dtype="int8").generate(prompts, gen, chunk_steps=4)
    eng = DecodeEngine(cfg, _to(cpu_params, "cuda"), max_seq_len=64,
                       kv_dtype="int8")
    da.decode_attention.launches = 0
    got = eng.generate(prompts, gen, chunk_steps=4)
    m = eng.metrics
    emit({"phase": "reference_int8", "layout": "dense", "identical": got == want,
          "k2_launches": da.decode_attention.launches, "tokens": got,
          "graph_captures": m.graph_captures, "graph_replays": m.graph_replays})
    if got != want:
        raise AssertionError(f"int8 GPU tokens {got} != CPU plain-path {want}")
    if not m.graph_replays or not da.decode_attention.launches:
        raise AssertionError("the int8 decode steps did not replay K2")
    phase_reference_paged(kv_dtype="int8")


def phase_reference_paged(kv_dtype=None) -> None:
    """The continuous batcher over the paged pool, on a tiny fp32 llama:
    6 greedy requests of mixed lengths through split admission (K1 + K3)
    and through chunked prefill (K4 + K3) give, on the card, exactly the
    tokens the same batcher gives through the plain path on the CPU
    (``kv_dtype="int8"``: over an int8 pool)."""
    from llmss_tpu_torch.engine.engine import DecodeEngine, GenerationParams
    from llmss_tpu_torch.engine.scheduler import ContinuousBatcher
    from llmss_tpu_torch.models.decoder import init_params
    from llmss_tpu_torch.ops import paged_attention as pa

    cfg = _tiny_llama()
    cpu_params = init_params(cfg, seed=5, device="cpu")
    gpu_params = _to(cpu_params, "cuda")
    rng = np.random.default_rng(4)
    lens = (5, 20, 33, 7, 48, 12)
    prompts = [[int(t) for t in rng.integers(1, 512, n)] for n in lens]
    news = (16, 9, 12, 20, 6, 14)

    def serve(params, device, chunked):
        eng = DecodeEngine(cfg, params, device=device, max_seq_len=128,
                           kv_layout="paged", block_size=16, kv_dtype=kv_dtype)
        bat = ContinuousBatcher(eng, rows=4, chunk_steps=4, group_chunks=2,
                                chunked_prefill=16 if chunked else None)
        out = {}
        for i, (p, n) in enumerate(zip(prompts, news)):
            bat.submit(p, GenerationParams(max_new_tokens=n),
                       lambda t, *a, i=i, **k: out.__setitem__(i, t))
        bat.run_until_idle()
        if bat.allocator.blocks_in_use:
            raise AssertionError("blocks still in use after the run")
        return [out[i] for i in range(len(prompts))], eng.metrics

    for chunked in (False, True):
        want, _ = serve(cpu_params, "cpu", chunked)
        pa.paged_decode_attention.launches = 0
        pa.ragged_paged_attention.launches = 0
        got, m = serve(gpu_params, None, chunked)
        k3, k4 = (pa.paged_decode_attention.launches,
                  pa.ragged_paged_attention.launches)
        emit({"phase": "reference_paged", "kv": kv_dtype or "float32",
              "admission": "chunked_prefill=16" if chunked else "split",
              "identical": got == want, "k3_launches": k3,
              "k4_launches": k4, "graph_captures": m.graph_captures,
              "graph_replays": m.graph_replays, "tokens": got})
        if got != want:
            raise AssertionError(
                f"paged batcher on the card {got} != CPU plain path {want}")
        if k3 == 0 or (chunked and k4 == 0):
            raise AssertionError("the paged kernels were not launched")


def phase_reference_prefix() -> None:
    """Shared-prefix reuse on the tiny fp32 llama: ``generate(prefix=)``
    over the dense ring, and the continuous batcher over the paged pool
    (split admission: K1 over rows whose first two table entries are the
    prefix's shared blocks, then K3; chunked: K4 feeding from slot 32,
    then K3), also over an int8 pool. Tokens through the kernels on the
    card equal the plain path's on the CPU; on fp32 they also equal the
    tokens without the prefix; once idle the pool holds only the prefix's
    full blocks."""
    from llmss_tpu_torch.engine.engine import DecodeEngine, GenerationParams
    from llmss_tpu_torch.engine.scheduler import ContinuousBatcher
    from llmss_tpu_torch.models.decoder import init_params
    from llmss_tpu_torch.ops import decode_attention as da
    from llmss_tpu_torch.ops import flash_attention as fa
    from llmss_tpu_torch.ops import paged_attention as pa

    cfg = _tiny_llama()
    cpu_params = init_params(cfg, seed=6, device="cpu")
    gpu_params = _to(cpu_params, "cuda")
    rng = np.random.default_rng(6)
    head = [int(t) for t in rng.integers(1, 512, 40)]  # 2 blocks + 8
    prompts = [head + [int(t) for t in rng.integers(1, 512, n)]
               for n in (5, 30, 1, 17, 9, 24)]
    news = (16, 9, 12, 20, 6, 14)

    def dense(params, device, use_prefix):
        eng = DecodeEngine(cfg, params, device=device, max_seq_len=128)
        pfx = eng.build_prefix(head) if use_prefix else None
        return eng.generate(prompts[:3], GenerationParams(max_new_tokens=16),
                            chunk_steps=4, prefix=pfx)

    def batcher(params, device, use_prefix, chunked, kv_dtype):
        eng = DecodeEngine(cfg, params, device=device, max_seq_len=128,
                           kv_layout="paged", block_size=16, kv_dtype=kv_dtype)
        bat = ContinuousBatcher(eng, rows=4, chunk_steps=4, group_chunks=2,
                                chunked_prefill=16 if chunked else None)
        pfx = eng.build_prefix(head) if use_prefix else None
        out = {}
        for i, (p, n) in enumerate(zip(prompts, news)):
            bat.submit(p, GenerationParams(max_new_tokens=n),
                       lambda t, *a, i=i, **k: out.__setitem__(i, t),
                       prefix=pfx)
        bat.run_until_idle()
        held = 2 if use_prefix else 0
        if bat.allocator.blocks_in_use != held:
            raise AssertionError(f"{bat.allocator.blocks_in_use} blocks in "
                                 f"use once idle, want {held}")
        return [out[i] for i in range(len(prompts))]

    runs = [("dense", "float32", dense, ())]
    for kv in (None, "int8"):
        for chunked in (False, True):
            runs.append(("paged_chunked_prefill=16" if chunked
                         else "paged_split", kv or "float32", batcher,
                         (chunked, kv)))
    for layout, kv, fn, extra in runs:
        want = fn(cpu_params, "cpu", True, *extra)
        for f in (fa.flash_attention, da.decode_attention,
                  pa.paged_decode_attention, pa.ragged_paged_attention):
            f.launches = 0
        got = fn(gpu_params, None, True, *extra)
        counts = dict(k1=fa.flash_attention.launches,
                      k2=da.decode_attention.launches,
                      k3=pa.paged_decode_attention.launches,
                      k4=pa.ragged_paged_attention.launches)
        row = {"phase": "reference_prefix", "layout": layout, "kv": kv,
               "identical": got == want, "launches": counts}
        if kv == "float32":
            scratch = fn(gpu_params, None, False, *extra)
            row["equal_to_scratch"] = got == scratch
        emit({**row, "tokens": got})
        if got != want:
            raise AssertionError(f"prefix {layout} {kv}: card {got} != CPU "
                                 f"plain path {want}")
        if not row.get("equal_to_scratch", True):
            raise AssertionError(f"prefix {layout}: tokens != scratch tokens")
        used = ("k1", "k2") if layout == "dense" else (
            ("k4", "k3") if "chunked" in layout else ("k1", "k3"))
        if not all(counts[k] for k in used):
            raise AssertionError(f"prefix {layout} {kv}: launches {counts}")


def _family_configs() -> dict:
    """The reference_families phase's tiny fp32 models: one per family of
    the registry, each with that family's feature set (GPT-J's parallel
    block, interleaved partial rotary and biased head; BigCode's MQA and
    learned positions; GPT-2's MHA; Mistral's window; Qwen2's q/k/v
    biases; NeoX's two-norm parallel block and partial half rotary;
    Phi-3's LongRoPE; Gemma's (1 + w) norm, embedding multiplier and head
    dim apart from hidden / heads), at head_dim 64."""
    from llmss_tpu_torch.models.common import DecoderConfig

    base = dict(vocab_size=512, hidden_size=256, n_layers=2, n_heads=4,
                head_dim=64, intermediate_size=512,
                max_position_embeddings=256, dtype="float32")
    llama = dict(activation="silu", norm="rmsnorm", mlp="swiglu",
                 positions="rotary", rope_style="half", attn_bias=False,
                 mlp_bias=False, n_kv_heads=2)
    gpt = dict(norm="layernorm", mlp="mlp", activation="gelu_new")
    short = tuple(1.0 + 0.05 * i for i in range(32))
    long = tuple(1.0 + 0.9 * i for i in range(32))
    fams = {
        "gptj": dict(model_type="gptj", n_kv_heads=4, **gpt,
                     positions="rotary", rope_style="interleaved",
                     rotary_dim=16, parallel_residual=True, attn_bias=False,
                     head_bias=True),
        "gpt_bigcode": dict(model_type="gpt_bigcode", n_kv_heads=1,
                            **{**gpt, "activation": "gelu_pytorch_tanh"},
                            positions="learned", tie_word_embeddings=True),
        "gpt2": dict(model_type="gpt2", n_kv_heads=4, **gpt,
                     positions="learned", tie_word_embeddings=True),
        "llama": dict(model_type="llama", **llama),
        "mistral": dict(model_type="mistral", **llama, sliding_window=24),
        "qwen2": dict(model_type="qwen2", **{**llama, "attn_bias": True},
                      attn_out_bias=False),
        "gpt_neox": dict(model_type="gpt_neox", n_kv_heads=4,
                         **{**gpt, "activation": "gelu"}, positions="rotary",
                         rope_style="half", rotary_dim=16,
                         parallel_residual=True, parallel_residual_ln2=True),
        # LongRoPE with an original context of 64: the engines of 48 and
        # 128 slots run the short and the long factors.
        "phi3": dict(model_type="phi3", **llama, rope_freq_factors=long,
                     rope_freq_factors_short=short,
                     rope_freq_factors_long=long,
                     rope_original_max_positions=64,
                     rope_attn_factor=math.sqrt(1 + math.log(4) / math.log(64))),
        "gemma": dict(model_type="gemma",
                      **{**llama, "n_kv_heads": 1,
                         "activation": "gelu_pytorch_tanh"},
                      hidden_size=128, norm_scale_offset=1.0,
                      embed_multiplier=128 ** 0.5, tie_word_embeddings=True),
    }
    return {k: DecoderConfig(**{**base, **v}) for k, v in fams.items()}


def phase_reference_families() -> None:
    """Every family of the registry, as a tiny fp32 model whose block
    weights are scaled up (so greedy tokens vary): greedy tokens through
    the kernels on the card, after ``prewarm``, with every decode step a
    graph replay and no capture after it, equal the plain path's on the
    CPU, over the dense ring and through the continuous batcher with
    chunked prefill over the paged pool. Phi-3 runs on both sides of its
    LongRoPE original context (engines of 48 and 128 slots: short and long
    factors), which a per-call upload of the factors would fail to
    capture."""
    from llmss_tpu_torch.engine.engine import DecodeEngine, GenerationParams
    from llmss_tpu_torch.engine.scheduler import ContinuousBatcher
    from llmss_tpu_torch.models.decoder import init_params
    from llmss_tpu_torch.ops import decode_attention as da
    from llmss_tpu_torch.ops import flash_attention as fa
    from llmss_tpu_torch.ops import paged_attention as pa

    runs = [(name, cfg, None) for name, cfg in _family_configs().items()]
    phi3 = runs.pop(7)
    runs[7:7] = [(phi3[0], phi3[1], 48), (phi3[0], phi3[1], 128)]
    news = (16, 9, 12, 20, 6, 14)

    def serve(eng, prompts, chunked_prewarm):
        bat = ContinuousBatcher(eng, rows=4, chunk_steps=4, group_chunks=2,
                                chunked_prefill=16)
        warmed = bat.prewarm() if chunked_prewarm else 0
        keys = eng._graphs.keys()
        out = {}
        for i, (p, n) in enumerate(zip(prompts, news)):
            bat.submit(p, GenerationParams(max_new_tokens=n),
                       lambda t, *a, i=i, **k: out.__setitem__(i, t))
        bat.run_until_idle()
        if bat.allocator.blocks_in_use:
            raise AssertionError("blocks still in use after the run")
        return [out[i] for i in range(len(prompts))], warmed, keys

    for i, (name, cfg, msl) in enumerate(runs):
        cpu_params = init_params(cfg, seed=20 + i, device="cpu")
        for k, lin in cpu_params["blocks"].items():
            for t in lin:
                if t is not None:
                    t.mul_(10.0)
        gpu_params = _to(cpu_params, "cuda")
        rng = np.random.default_rng(i)
        dense_len = msl or 64
        prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)]
                   for n in (20, 7, min(33, dense_len - 17))]
        gen = GenerationParams(max_new_tokens=16)
        row = {"phase": "reference_families", "family": name,
               "max_seq_len": dense_len}
        want = DecodeEngine(cfg, cpu_params, device="cpu",
                            max_seq_len=dense_len).generate(
            prompts, gen, chunk_steps=4)
        eng = DecodeEngine(cfg, gpu_params, max_seq_len=dense_len)
        if cfg.rope_freq_factors_short is not None:
            picked = ("long" if eng.cfg.rope_freq_factors
                      == cfg.rope_freq_factors_long else "short")
            if picked != ("long" if dense_len > 64 else "short"):
                raise AssertionError(f"{name}: {picked} LongRoPE factors at "
                                     f"max_seq_len {dense_len}")
            row["longrope_factors"] = picked
        warmed = eng.prewarm(len(prompts), chunk_steps=4)
        keys = eng._graphs.keys()
        fa.flash_attention.launches = da.decode_attention.launches = 0
        got = eng.generate(prompts, gen, chunk_steps=4)
        captured = len(eng._graphs.keys() - keys)
        row["dense"] = {"identical": got == want, "prewarm": warmed,
                        "graph_captures_after_prewarm": captured,
                        "graph_replays": eng.metrics.graph_replays,
                        "k1_launches": fa.flash_attention.launches,
                        "k2_launches": da.decode_attention.launches,
                        "tokens": got[0]}
        if got != want or captured or not eng.metrics.graph_replays or not (
                fa.flash_attention.launches and da.decode_attention.launches):
            emit(row)
            raise AssertionError(f"{name} dense: GPU {got} != CPU {want}, or "
                                 "captured after prewarm, or no replays")
        del eng
        paged_len = msl or 128
        plens = [min(n, paged_len - 21) for n in (5, 20, 33, 7, 48, 12)]
        prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)]
                   for n in plens]
        kw = dict(max_seq_len=paged_len, kv_layout="paged", block_size=16)
        want, _, _ = serve(DecodeEngine(cfg, cpu_params, device="cpu", **kw),
                           prompts, False)
        eng = DecodeEngine(cfg, gpu_params, **kw)
        pa.paged_decode_attention.launches = 0
        pa.ragged_paged_attention.launches = 0
        got, warmed, keys = serve(eng, prompts, True)
        captured = len(eng._graphs.keys() - keys)
        row["paged_chunked"] = {
            "identical": got == want, "prewarm": warmed,
            "graph_captures_after_prewarm": captured,
            "graph_replays": eng.metrics.graph_replays,
            "k3_launches": pa.paged_decode_attention.launches,
            "k4_launches": pa.ragged_paged_attention.launches,
            "tokens": got[0]}
        emit(row)
        if got != want or captured or not eng.metrics.graph_replays or not (
                pa.paged_decode_attention.launches
                and pa.ragged_paged_attention.launches):
            raise AssertionError(f"{name} paged: GPU {got} != CPU {want}, or "
                                 "captured after prewarm, or no replays")
        del eng, gpu_params
    gc.collect()
    torch.cuda.empty_cache()


# -- phase 5 -------------------------------------------------------------------


def _check_logits(eng, prompts) -> torch.Tensor:
    """Logits of the main path (a prefill, then one decode step) are
    finite and of the expected shape; returns the prefill's."""
    from llmss_tpu_torch.engine.engine import GenerationParams

    B = len(prompts)
    cache = eng.new_cache(B)
    ids, lens = eng._pad_prompts(prompts)
    sa = eng._sample_args(GenerationParams(), B)
    lens_d = torch.as_tensor(lens, device="cuda")
    tok, logits = eng._prefill(torch.as_tensor(ids, device="cuda"), cache,
                               lens_d, sa)
    _, logits2 = eng._decode(tok, cache, lens_d, sa)
    for lg in (logits, logits2):
        if tuple(lg.shape) != (B, eng.cfg.vocab_size) or not torch.isfinite(
                lg).all():
            raise AssertionError("non-finite or misshapen logits")
    return logits.float().cpu()


def phase_engine(kernels: dict):
    from llmss_tpu_torch.engine.engine import DecodeEngine, GenerationParams
    from llmss_tpu_torch.engine.metrics import EngineMetrics
    from llmss_tpu_torch.models.common import DecoderConfig
    from llmss_tpu_torch.models.decoder import init_params
    from llmss_tpu_torch.ops import decode_attention as da
    from llmss_tpu_torch.ops import flash_attention as fa

    cfg = DecoderConfig(**LLAMA2_7B)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    B, new = 4, 64
    eng = DecodeEngine(cfg, params, batch_size=B, max_seq_len=1024)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)]
               for n in (128, 100, 77, 128)]
    L = cfg.n_layers

    first_logits = _check_logits(eng, prompts)

    # Every decode step graph generate / generate_fused can pick at 4 rows.
    t = time.perf_counter()
    warmed = eng.prewarm(B, chunk_steps=8)
    prewarm_s = time.perf_counter() - t
    keys = eng._graphs.keys()
    mem = _graph_memory(eng, [eng._cache])
    emit({"phase": "engine", "prewarm": warmed, "prewarm_s": prewarm_s,
          "graph_captures": eng.metrics.graph_captures, **mem})
    sampled = GenerationParams(max_new_tokens=new, is_greedy=False,
                               temperature=0.8, top_k=40, top_p=0.9,
                               seed=1234)

    def gens():
        return [GenerationParams(max_new_tokens=new)] * 3 + [sampled]

    def counted(call, steps):
        """Run ``call``; check K1 ran n_layers times and K2 n_layers per
        decode step (replays count the launches their graph holds)."""
        fa.flash_attention.launches = 0
        da.decode_attention.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        k1, k2 = fa.flash_attention.launches, da.decode_attention.launches
        if k1 != L or k2 != L * steps:
            raise AssertionError(
                f"launch counts K1={k1} (want {L}), K2={k2} (want {L * steps})")
        for row in out:
            if len(row) != new or not all(0 <= x < cfg.vocab_size for x in row):
                raise AssertionError("tokens outside the vocab or wrong length")
        return out, wall, k1, k2

    def run(gen, chunk):
        steps = (math.ceil((new - 1) / chunk) * chunk) if chunk > 1 else new - 1
        return counted(lambda: eng.generate(prompts, gen, chunk_steps=chunk),
                       steps)

    eng.metrics = EngineMetrics()
    a, _, k1_main, k2_main = run(gens(), 8)
    ttft_first_ms = eng.metrics.ttft.last_s * 1e3
    eng.metrics = EngineMetrics()  # steady-state numbers from the repeat
    b, wall_b, _, _ = run(gens(), 8)
    if a != b:
        raise AssertionError("same seed, different tokens")
    ttft_ms = eng.metrics.ttft.last_s * 1e3
    step_ms = eng.metrics.decode_step.to_dict()["mean_ms"]
    c, wall_c, _, _ = run(GenerationParams(max_new_tokens=new), 1)
    if c[:3] != a[:3]:
        raise AssertionError("greedy rows differ between chunk_steps 8 and 1")
    # generate_fused: greedy gives the greedy rows; every row sampled with
    # the sampled row's settings gives that row its tokens (rows are
    # isolated, and a draw depends on the seed and the position only).
    fused, wall_f, _, _ = counted(
        lambda: eng.generate_fused(prompts, GenerationParams(max_new_tokens=new)),
        new - 1)
    fused_s, _, _, _ = counted(lambda: eng.generate_fused(prompts, sampled),
                               new - 1)
    if fused != c or fused_s[3] != a[3]:
        raise AssertionError("generate_fused tokens differ from generate's")
    prefix_row = _engine_prefix(eng, rng, counted, new)
    captured = len(eng._graphs.keys() - keys)
    if captured:
        raise AssertionError(f"{captured} graph captures after prewarm")
    kernels["K1"]["launches"] = k1_main
    kernels["K2"]["launches"] = k2_main
    emit({"phase": "engine", "model": "llama-2-7b dims, random init (seed 0)",
          "dtype": "bfloat16", "batch": B, "prompt_lens": [len(p) for p in prompts],
          "new_tokens": new, "init_s": round(init_s, 3),
          "ttft_ms_first_call": ttft_first_ms, "ttft_ms": ttft_ms,
          "decode_ms_per_step_chunk8": step_ms,
          "weight_read_bound_ms_per_step": (
              _weight_read_bytes(cfg, params) / HBM_BYTES_PER_S * 1e3),
          "tokens_per_s_chunk8_one_sampled_row": B * new / wall_b,
          "tokens_per_s_chunk1_greedy": B * new / wall_c,
          "tokens_per_s_fused_greedy": B * new / wall_f,
          "k1_launches_per_prefill": k1_main,
          "k2_launches_chunk8": k2_main, "deterministic": True,
          "fused_equals_generate": True,
          "graph_captures_after_prewarm": captured,
          "graph_replays": eng.metrics.graph_replays,
          "sampled_row_head": a[3][:8]})
    emit({**prefix_row, "graph_captures_after_prewarm": captured})
    return eng, {"tokens": a, "cache_bytes": mem["cache_bytes"],
                 "prompts": prompts, "first_logits": first_logits}


# A bf16 prefix's first-token logits may differ from a prefill from
# scratch by this share of the largest |logit|: the prefix was computed at
# batch 1 and the scratch prefill at batch 4, whose matmuls round
# differently, and the repo holds int8-cache logits to the same 5% of
# bf16's (tests/test_int8_cache.py).
PREFIX_LOGITS_REL = 0.05


def _engine_prefix(eng, rng, counted, new: int) -> dict:
    """Shared-prefix reuse on the dense ring at the engine's width: a
    512-token prefix built once (K1 at batch 1), then 4 prompts of prefix
    + 16-100 tokens through ``generate(prefix=)`` (K1 over the seeded
    ring at q0 512, bucket 128; K2 per step) beside the same prompts from
    scratch. bf16 is not bit-exact across matmul shapes, so this reports
    the share of equal tokens and holds the first token's logits within
    PREFIX_LOGITS_REL of scratch's. Returns the row to emit."""
    from llmss_tpu_torch.engine.engine import GenerationParams
    from llmss_tpu_torch.ops import flash_attention as fa

    V, L = eng.cfg.vocab_size, eng.cfg.n_layers
    head = [int(t) for t in rng.integers(1, V, ENGINE_PREFIX)]
    prompts = [head + [int(t) for t in rng.integers(1, V, n)]
               for n in PREFIX_SUFFIXES]
    fa.flash_attention.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    pfx = eng.build_prefix(head)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    if fa.flash_attention.launches != L or pfx.k.shape[1] != ENGINE_PREFIX:
        raise AssertionError("build_prefix: one prefill of the 512 bucket")
    gen = GenerationParams(max_new_tokens=new)
    steps = math.ceil((new - 1) / 8) * 8
    scratch, wall_s, _, _ = counted(
        lambda: eng.generate(prompts, gen, chunk_steps=8), steps)
    ttft_s = eng.metrics.ttft.last_s
    reused, wall_r, k1, k2 = counted(
        lambda: eng.generate(prompts, gen, chunk_steps=8, prefix=pfx), steps)
    ttft_r = eng.metrics.ttft.last_s
    # The first token's logits both ways, over generate's cache.
    B = len(prompts)
    sa = eng._sample_args(gen, B)
    ids, lens = eng._pad_prompts(prompts)
    _, lg = eng._prefill(torch.as_tensor(ids, device="cuda"),
                         eng._generate_cache(B),
                         torch.as_tensor(lens, device="cuda"), sa)
    lg = lg.float().clone()
    cache = eng._generate_cache(B)
    eng.seed_cache(cache, pfx)
    ids, lens = eng._pad_prompts([p[ENGINE_PREFIX:] for p in prompts])
    _, lg_p = eng._prefill(
        torch.as_tensor(ids, device="cuda"), cache,
        torch.as_tensor(lens, device="cuda"), sa,
        torch.full((B,), ENGINE_PREFIX, dtype=torch.int32, device="cuda"))
    rel = ((lg_p.float() - lg).abs().max() / lg.abs().max()).item()
    if not math.isfinite(rel) or rel > PREFIX_LOGITS_REL:
        raise AssertionError(f"prefix first-token logits off by {rel} of max")
    equal = sum(x == y for r, q in zip(reused, scratch) for x, y in zip(r, q))
    return {"phase": "engine", "path": "generate(prefix=)",
            "prefix_tokens": ENGINE_PREFIX, "suffix_lens": PREFIX_SUFFIXES,
            "new_tokens": new, "build_prefix_s": build_s,
            "ttft_ms_scratch": ttft_s * 1e3, "ttft_ms_prefix": ttft_r * 1e3,
            "wall_s_scratch": wall_s, "wall_s_prefix": wall_r,
            "k1_launches": k1, "k2_launches": k2,
            "tokens_equal_to_scratch_share": equal / (B * new),
            "first_token_logits_max_rel_diff": rel,
            "first_tokens_equal": [r[0] == q[0]
                                   for r, q in zip(reused, scratch)]}


def _graph_memory(eng, caches) -> dict:
    """What the engine's step graphs hold on the card: how many caches
    they are kept for, the bytes of ``caches`` (those caches), and the
    bytes the caching allocator reserves for the graphs' shared pool."""
    pool = eng._graphs._pool
    segs = torch.cuda.memory_snapshot()
    if pool is None or any("segment_pool_id" not in s for s in segs):
        raise RuntimeError("no graph pool, or no pool ids in the snapshot")
    return {"graph_caches": len(eng._graphs),
            "cache_bytes": sum(t.numel() * t.element_size()
                               for c in caches for t in c if t is not None),
            "graph_pool_bytes": sum(
                s["total_size"] for s in segs
                if tuple(s["segment_pool_id"]) == tuple(pool))}


def _int8_kernel(name: str, sym: str) -> bool:
    """Whether the kernel ``name`` is an int8-cache instantiation of
    ``sym`` (``decode_fwd`` / ``paged_fwd`` / ``paged_mma``): a ``signed
    char`` template argument, demangled, or ``a`` for it, mangled (after
    the query type in the lane templates, first in ``paged_mma``)."""
    return sym in name and ("signed char" in name or re.search(
        sym + r"I(?:f|13__nv_bfloat16)?aLi", name) is not None)


def _calls(rows, c: str, ms: bool = False):
    """Calls (``ms``: device ms) of the profiled kernels whose name holds
    ``c``; ``"int8:"`` before it counts only the int8-cache
    instantiations."""
    if c.startswith("int8:"):
        hit = [r for r in rows if _int8_kernel(r[1], c[5:])]
    else:
        hit = [r for r in rows if c in r[1]]
    return sum(us / 1e3 if ms else n for us, _, n in hit)


def _wrapper_launches(fn):
    """(``fn()``, {wrapper name: launches}) of one call, from the kernel
    wrappers' own counters (``graphs.launch_counters``): an eager call
    counts where it launches, a graph replay adds the launches read from
    its kernel nodes at capture. No profiler record enters a count."""
    from llmss_tpu_torch.engine import graphs

    before = [(w, w.launches) for w in graphs.launch_counters()]
    out = fn()
    return out, {w.__name__: w.launches - n for w, n in before
                 if w.launches != n}


def _profile_row(what, fn, path=None, count=()) -> tuple[dict, object]:
    """Where the time of ``fn`` goes: after a warm call, wall time without
    the profiler (and the host's enqueue time, to the return of ``fn``)
    and the kernel launches counted by the wrappers (``launches``), then
    summed kernel time, the top kernels and the device ms of the kernels
    whose names hold a ``count`` symbol, from a profiled call; the idle
    share is 1 - kernel time / wall time. The profiler's own calls of
    those kernels (``profiler_calls``) are reported beside, unchecked: it
    has lost records (ROADMAP Queue 3). Returns (row, the timed call's
    result)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out, launches = _wrapper_launches(fn)
    enqueue_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = _kernel_rows(prof)
    kernel_ms = sum(r[0] for r in rows) / 1e3
    row = {"phase": "profile", "what": what, **({"path": path} if path else {}),
           "wall_ms": wall_ms, "host_enqueue_ms": enqueue_ms,
           "device_kernel_ms": kernel_ms,
           "device_idle_share": max(0.0, 1 - kernel_ms / wall_ms),
           "kernels": sum(r[2] for r in rows), "launches": launches,
           "profiler_calls": {c: _calls(rows, c) for c in count},
           "kernel_ms_of": {c: _calls(rows, c, ms=True) for c in count},
           "top": [{"kernel": k[:80], "ms": us / 1e3, "calls": n}
                   for us, k, n in rows[:8]]}
    emit(row)
    return row, out


def _node_counts(names: list[str], symbols) -> dict:
    """How many of a graph's kernel nodes (``names``) hold each symbol
    (``"int8:"`` before it: only its int8-cache instantiations)."""
    return {c: sum(1 for n in names if (_int8_kernel(n, c[5:])
                                        if c.startswith("int8:") else c in n))
            for c in symbols}


def _graph_vs_eager(eng, what, tok, cache, cur, sa, done, eos, *, n_chunks,
                    n_steps, t_bucket) -> None:
    """One decode group by graph replays (the engine's path) beside the
    same steps run eagerly over the same buffers, each call from the same
    state (the cache's positions put back: the KV a call wrote is then
    masked again); both must give the same packed tokens, and both must
    launch the decode kernel n_layers times a step: counted by its
    wrapper (a replay adds its graph's kernel nodes). The step graph's
    kernel nodes must hold n_layers decode kernels (int8 instantiations
    over an int8 cache) and as many merges when the plan splits, each
    merge a programmatic dependent launch."""
    from llmss_tpu_torch.engine import graphs
    from llmss_tpu_torch.engine.cache import PagedKVCache
    from llmss_tpu_torch.ops import decode_attention as da
    from llmss_tpu_torch.ops import paged_attention as pa
    from llmss_tpu_torch.ops import split_plan as sp

    pos0 = cache.positions.clone()
    plan = _decode_plan(eng, cache, t_bucket)
    paged = isinstance(cache, PagedKVCache)
    kernel = ("paged" if paged else "decode") + (
        "_mma" if plan.impl in sp.TILE_IMPLS
        else "_group" if plan.impl == "group" else "_fwd")
    wrapper = (pa.paged_decode_attention if paged
               else da.decode_attention).__name__

    def graph():
        cache.positions.copy_(pos0)
        return eng._decode_group(tok, cache, cur, sa, done, eos,
                                 n_chunks=n_chunks, n_steps=n_steps,
                                 t_bucket=t_bucket)[0]

    def eager():
        cache.positions.copy_(pos0)
        g = eng._graphs.for_cache(cache)
        g.bufs.load(tok, cur, sa, done, eos)
        body = eng._step_body("fold", g.bufs, cache, sa, t_bucket)
        return eng._run_group(g.bufs, body, n_chunks, n_steps)[0]

    # Over an int8 cache every decode kernel must be its int8 instantiation.
    count = (kernel, "split_merge") + ((f"int8:{kernel}",) if cache.quantized
                                       else ())
    L, steps = eng.cfg.n_layers, n_chunks * n_steps
    merges = L if sp.merges(plan) else 0
    want_launches = {wrapper: L * steps}
    want_nodes = {kernel: L, "split_merge": merges}
    if cache.quantized:
        want_nodes[f"int8:{kernel}"] = L

    g_row, g_out = _profile_row(what, graph, "graph", count)
    e_row, e_out = _profile_row(what, eager, "eager", count)
    same = torch.equal(g_out, e_out)
    step = eng._graphs.for_cache(cache).steps[
        eng._step_key("fold", sa, t_bucket)]
    nodes = _node_counts(graphs.kernel_node_names(step.graph), count)
    edges = _programmatic_edges(step.graph)
    emit({"phase": "profile", "what": what, "check": "graph_equals_eager",
          "identical": same,
          "wall_ratio_eager_over_graph": e_row["wall_ms"] / g_row["wall_ms"],
          "kernel_ms_ratio_graph_over_eager": (
              g_row["device_kernel_ms"] / e_row["device_kernel_ms"]),
          "launches_graph": g_row["launches"],
          "launches_eager": e_row["launches"],
          "launches_want": want_launches,
          "step_graph_nodes": nodes, "step_graph_nodes_want": want_nodes,
          "profiler_calls_graph": g_row["profiler_calls"],
          "profiler_calls_eager": e_row["profiler_calls"],
          "step_graph_edges": edges[1], "programmatic_edges": edges[0],
          "split_merges_per_step": merges, "decode_impl": plan.impl,
          "kernel_ms_per_step_graph": g_row["device_kernel_ms"] / steps,
          # the decode attention kernels' (with their merges) share of the
          # graph path's kernel time
          "decode_attention_ms_graph": (g_row["kernel_ms_of"][kernel]
                                        + g_row["kernel_ms_of"]["split_merge"]),
          "decode_attention_share_graph": (
              (g_row["kernel_ms_of"][kernel] + g_row["kernel_ms_of"]["split_merge"])
              / g_row["device_kernel_ms"])})
    if not same:
        raise AssertionError(f"{what}: graph and eager packed tokens differ")
    for path, row in (("graph", g_row), ("eager", e_row)):
        if row["launches"] != want_launches:
            raise AssertionError(f"{what}: the {path} path launched "
                                 f"{row['launches']}, want {want_launches}")
    if nodes != want_nodes:
        raise AssertionError(f"{what}: the step graph's kernel nodes hold "
                             f"{nodes}, want {want_nodes}")
    if edges[0] != merges:
        raise AssertionError(f"{what}: {edges[0]} programmatic edges in the "
                             f"step graph, {merges} split merges")
    cache.positions.copy_(pos0)


def _decode_plan(eng, cache, t_bucket):
    """The K2 / K3 plan of one decode step of ``eng`` over ``cache``."""
    from llmss_tpu_torch.engine.cache import PagedKVCache
    from llmss_tpu_torch.ops import _build
    from llmss_tpu_torch.ops import decode_attention as da
    from llmss_tpu_torch.ops import paged_attention as pa

    cfg, B = eng.cfg, cache.positions.shape[0]
    sms = _build.sm_count(cache.k.device)
    T = cache.max_len if t_bucket is None else min(t_bucket, cache.max_len)
    if isinstance(cache, PagedKVCache):
        bs = cache.block_size
        return pa.kernel_plan(cfg.torch_dtype, 1, cfg.n_heads // cfg.n_kv_heads,
                              cfg.head_dim, B=B, Hkv=cfg.n_kv_heads,
                              n_slots=-(-T // bs) * bs, bs=bs, sms=sms,
                              kv_dtype=cache.k.dtype)
    return da.kernel_plan(cfg.torch_dtype, B, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, T, sms=sms, kv_dtype=cache.k.dtype)


def _programmatic_edges(graph) -> tuple[int, int]:
    """(programmatic edges, all edges) of a captured CUDA graph (kept, as
    the engine's step graphs are), read with libcuda's
    ``cuGraphGetEdges_v2``: a split decode kernel's merge, launched with
    programmatic stream serialization, must keep that edge inside a
    graph."""
    get = ctypes.CDLL("libcuda.so.1").cuGraphGetEdges_v2
    get.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_size_t)]
    n = ctypes.c_size_t(0)
    raw = graph.raw_cuda_graph()
    if get(raw, None, None, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetEdges_v2 failed")
    frm, to = (ctypes.c_void_p * n.value)(), (ctypes.c_void_p * n.value)()
    data = (ctypes.c_uint8 * (8 * n.value))()  # CUgraphEdgeData, 8 bytes
    if get(raw, frm, to, data, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetEdges_v2 failed")
    # Byte 0: the edge's from_port, byte 2: its type; 1 in either marks a
    # programmatic dependency.
    prog = sum(1 for i in range(n.value) if 1 in (data[8 * i], data[8 * i + 2]))
    return prog, n.value


def phase_profile(eng, tag: str = "") -> None:
    """Where the time goes: one prefill and one 8-step decode chunk of the
    engine phase's batch (prompts of 128/100/77/128 tokens), the chunk by
    graph replays and eagerly; rows named ``tag`` first."""
    from llmss_tpu_torch.engine.engine import GenerationParams

    B = 4
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, eng.cfg.vocab_size, n)]
               for n in ENGINE_LENS]
    ids, lens = eng._pad_prompts(prompts)
    sa = eng._sample_args(GenerationParams(), B)
    ids_d = torch.as_tensor(ids, device="cuda")
    lens_d = torch.as_tensor(lens, device="cuda")
    done = torch.zeros(B, dtype=torch.bool, device="cuda")
    eos = torch.full((B,), -1, dtype=torch.int32, device="cuda")
    cache = eng.new_cache(B)

    def prefill():
        cache.positions.fill_(-1)
        tok, _ = eng._prefill(ids_d, cache, lens_d, sa)
        return tok

    _profile_row(tag + "prefill", prefill)
    tok = prefill()
    _graph_vs_eager(eng, tag + "decode_chunk8", tok, cache, lens_d, sa, done, eos,
                    n_chunks=1, n_steps=8,
                    t_bucket=eng.decode_bucket(int(lens.max()) + 8))


# -- phase 6 -------------------------------------------------------------------


def phase_serve(eng) -> None:
    from llmss_tpu_torch.ops import decode_attention as da
    from llmss_tpu_torch.ops import flash_attention as fa
    from llmss_tpu_torch.serve.broker import InProcBroker
    from llmss_tpu_torch.serve.consumer import Worker
    from llmss_tpu_torch.serve.protocol import GenerateRequest

    L = eng.cfg.n_layers
    broker = InProcBroker()
    worker = Worker(eng, broker, batch_size=4, chunk_steps=8)
    t = time.perf_counter()
    warmed = worker.prewarm()
    prewarm_s = time.perf_counter() - t
    keys = eng._graphs.keys()
    rng = np.random.default_rng(7)

    def ids(n):
        return [int(t) for t in rng.integers(1, 32000, n)]

    reqs = [
        GenerateRequest(token_ids=ids(40), max_new_tokens=16),
        GenerateRequest(token_ids=ids(90), max_new_tokens=24),
        GenerateRequest(token_ids=ids(64), max_new_tokens=20, is_greedy=False,
                        temperature=0.7, top_k=50, top_p=0.95, seed=9),
        GenerateRequest(token_ids=ids(17), max_new_tokens=12, stream=True),
    ]
    for r in reqs:
        broker.push_request(r)
    fa.flash_attention.launches = 0
    da.decode_attention.launches = 0
    t = time.perf_counter()
    taken = worker.run_once()
    wall = time.perf_counter() - t
    answers = [broker.wait_response(r.id, timeout=60) for r in reqs]
    for r, a in zip(reqs, answers):
        if a is None or a.error or len(a.token_ids or []) != r.max_new_tokens:
            raise AssertionError(f"request {r.id}: bad answer {a}")
    streamed = []
    while (inc := broker.pop_stream(reqs[3].id)) is not None:
        streamed += inc
    if streamed != answers[3].token_ids:
        raise AssertionError("stream increments != final answer")
    # 8-step chunks until the longest request (24 tokens) is done.
    k1, k2 = fa.flash_attention.launches, da.decode_attention.launches
    if k1 != L or k2 != L * 24:
        raise AssertionError(f"launch counts K1={k1}, K2={k2}")
    captured = len(eng._graphs.keys() - keys)
    if captured:
        raise AssertionError(f"{captured} graph captures after prewarm")
    emit({"phase": "serve", "taken": taken, "answered": len(answers),
          "wall_s": wall, "prewarm": warmed, "prewarm_s": prewarm_s,
          "graph_captures_after_prewarm": captured,
          "k1_launches": k1, "k2_launches": k2, "stream_increments_ok": True})


# -- phase 6b ------------------------------------------------------------------


SERVE_NEW = 48  # new tokens per serve_continuous request
SERVE_CANCEL = 3  # admitted in the first wave, cancelled once it decodes


def _serve_requests(cfg, new: int = SERVE_NEW):
    """The serve_continuous phase's 16 requests (prompts of 32-768 tokens
    from seed 11, token ids within the config's vocab, ``new`` new tokens
    each: 12 greedy of which 2 streamed, 3 top-k/top-p sampled, 1
    cancelled mid-decode), made anew per pass; returns (prompt lengths,
    the maker)."""
    from llmss_tpu_torch.serve.protocol import GenerateRequest

    rng = np.random.default_rng(11)
    lens = [int(n) for n in rng.integers(32, 769, 16)]
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)]
               for n in lens]

    def requests():
        out = []
        for i, p in enumerate(prompts):
            kw = {}
            if 12 <= i < 15:
                kw = dict(is_greedy=False, temperature=0.8, top_k=40,
                          top_p=0.9, seed=100 + i)
            out.append(GenerateRequest(token_ids=p, max_new_tokens=new,
                                       stream=i in (0, 1), **kw))
        return out

    return lens, requests


def _serve_pass(eng, worker, requests, steps, extra: dict):
    """One serving pass of ``requests()`` through a prewarmed
    ContinuousWorker: every answer checked (the cancelled one cancelled,
    the stream equal to its answer), the launch counts against the steps
    run (K2 never; K3 n_layers per decode step, K4 per ragged step), every
    block returned and no graph captured. Emits and returns (row, tokens,
    launch counts)."""
    from llmss_tpu_torch.engine.metrics import EngineMetrics
    from llmss_tpu_torch.ops import decode_attention as da
    from llmss_tpu_torch.ops import flash_attention as fa
    from llmss_tpu_torch.ops import paged_attention as pa

    cfg = eng.cfg
    L = cfg.n_layers
    eng.metrics = EngineMetrics()
    broker = worker.broker
    reqs = requests()
    new = reqs[0].max_new_tokens
    for r in reqs:
        broker.push_request(r)
    fa.flash_attention.launches = da.decode_attention.launches = 0
    pa.paged_decode_attention.launches = 0
    pa.ragged_paged_attention.launches = 0
    steps.update(decode=0, ragged=0)
    answers, cancel_sent = {}, False
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while len(answers) < len(reqs):
        worker.run_once()
        if not cancel_sent and any(
                r.req_id == reqs[SERVE_CANCEL].id and r.out
                for r in worker.batcher.active.values()):
            broker.cancel_request(reqs[SERVE_CANCEL].id)
            cancel_sent = True
        for r in reqs:
            if r.id not in answers:
                a = broker.wait_response(r.id, timeout=0.0)
                if a is not None:
                    answers[r.id] = a
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(k1=fa.flash_attention.launches,
                  k2=da.decode_attention.launches,
                  k3=pa.paged_decode_attention.launches,
                  k4=pa.ragged_paged_attention.launches)
    toks = [answers[r.id].token_ids or [] for r in reqs]
    for i, (r, a) in enumerate(zip(reqs, (answers[r.id] for r in reqs))):
        if i == SERVE_CANCEL:
            if a.error != "cancelled" or not 0 < len(toks[i]) < new:
                raise AssertionError(f"cancelled request answered {a}")
        elif a.error or len(toks[i]) != new or not all(
                0 <= t < cfg.vocab_size for t in toks[i]):
            raise AssertionError(f"request {i}: bad answer {a}")
    streamed = []
    while (inc := broker.pop_stream(reqs[0].id)) is not None:
        streamed += inc
    if streamed != toks[0]:
        raise AssertionError("stream increments != final answer")
    if counts["k2"] or counts["k3"] != L * steps["decode"] or (
            counts["k4"] != L * steps["ragged"]):
        raise AssertionError(f"launch counts {counts} for steps {steps}")
    chunked = worker.batcher.chunked_prefill is not None
    if chunked and not counts["k4"]:
        raise AssertionError("chunked pass launched no K4")
    if worker.batcher.allocator.blocks_in_use:
        raise AssertionError("blocks in use after the pass")
    if eng.metrics.graph_captures:
        raise AssertionError("a serving pass captured a graph")
    m = eng.metrics
    served = sum(len(t) for i, t in enumerate(toks) if i != SERVE_CANCEL)
    row = {"phase": "serve_continuous",
           "admission": (f"chunked_prefill={worker.batcher.chunked_prefill}"
                         if chunked else "split"),
           "requests": len(reqs), "new_tokens": new,
           "wall_s": wall, "tokens_per_s": served / wall,
           "ttft_p50_ms": m.ttft.quantile_ms(50),
           "ttft_p90_ms": m.ttft.quantile_ms(90),
           "decode_ms_per_step": m.decode_step.to_dict()["mean_ms"],
           "decode_steps": steps["decode"], "ragged_steps": steps["ragged"],
           "launches": counts,
           "host_overhead": m.to_dict()["host_overhead"],
           "mixed_batch": m.to_dict()["mixed_batch"],
           **extra, "graph_captures_after_prewarm": 0,
           "graph_replays": m.graph_replays,
           "blocks_in_use_after": 0}
    return row, toks, counts


def phase_serve_continuous(params, kernels: dict):
    """The slice's main path: ContinuousWorker over InProcBroker at
    Llama-2-7B width (bf16, random weights from seed 0), 8 rows,
    max_seq_len 1024, block_size 16, a 256-block pool (2 GiB, half the
    dense equivalent), chunk_steps 8, group_chunks 2. 16 requests
    (``_serve_requests``), served with split admission (K1 + K3), then
    with chunked_prefill=128 (K4 + K3), then the chunked pass again, which
    must repeat its tokens. Returns the engine, the chunked pass's tokens
    and the repeat's row."""
    from llmss_tpu_torch.engine.engine import DecodeEngine
    from llmss_tpu_torch.models.common import DecoderConfig
    from llmss_tpu_torch.serve.broker import InProcBroker
    from llmss_tpu_torch.serve.consumer import ContinuousWorker

    cfg = DecoderConfig(**LLAMA2_7B)
    eng = DecodeEngine(cfg, params, max_seq_len=1024, kv_layout="paged",
                       block_size=16, kv_blocks=256)
    steps = count_steps(eng)
    lens, requests = _serve_requests(cfg)

    # One worker per admission mode, each prewarmed before any pass: the
    # passes capture no graph.
    workers, warm = {}, {}
    for chunked in (False, True):
        broker = InProcBroker()
        w = workers[chunked] = ContinuousWorker(
            eng, broker, rows=8, chunk_steps=8, group_chunks=2,
            chunked_prefill=128 if chunked else None)
        t = time.perf_counter()
        n = w.prewarm()
        warm[chunked] = {"prewarm": n, "prewarm_s": time.perf_counter() - t}
    keys = eng._graphs.keys()
    emit({"phase": "serve_continuous", "prewarmed_workers": 2,
          **_graph_memory(eng, [w.batcher.cache for w in workers.values()])})

    def run(chunked):
        row, toks, counts = _serve_pass(eng, workers[chunked], requests,
                                        steps, {"prompt_lens": lens,
                                                **warm[chunked]})
        emit(row)
        return toks, counts, row

    split, c_split, split_row = run(False)
    chunk, c_chunk, chunk_row = run(True)
    again, _, again_row = run(True)
    same = all(a == b for i, (a, b) in enumerate(zip(chunk, again))
               if i != SERVE_CANCEL)
    emit({"phase": "serve_continuous", "check": "chunked_pass_repeats",
          "identical": same})
    if not same:
        raise AssertionError("a repeat of the chunked pass gave other tokens")
    if eng._graphs.keys() != keys:
        raise AssertionError("a serving pass captured a graph")
    kernels["K3"]["launches"] = c_split["k3"] + c_chunk["k3"]
    kernels["K4"]["launches"] = c_chunk["k4"]
    del workers, w
    gc.collect()
    if len(eng._graphs):
        raise AssertionError("the workers' step graphs outlived their caches")
    return eng, chunk, again_row, {"split": (split_row, split),
                                   "chunked": (chunk_row, chunk)}


# -- phase 6b, over HTTP -------------------------------------------------------


class _HttpPhaseWorker:
    """The serve_http phase's ContinuousWorker, wrapped on the loop thread.

    ``crash``: the first ``run_once`` records ``memory_allocated`` and
    raises (the forced restart). Otherwise ``run_once`` waits for ``gate``
    (every request queued, in order) before it serves, and after the
    iteration in which request ``cancel_id`` first has tokens it waits for
    that request's cancel flag (sent by ``POST /cancel``): the pass then
    runs the in-process pass's schedule step for step, which its tokens
    depend on (the decode bucket, hence K3's split, follows the rows)."""

    def __init__(self, worker, log, *, crash=False, gate=None, cancel_id=None,
                 seen=None):
        self.worker, self.log, self.crash = worker, log, crash
        self.gate, self.cancel_id, self.seen = gate, cancel_id, seen

    def __getattr__(self, name):
        return getattr(self.worker, name)

    def run_once(self):
        if self.crash:
            torch.cuda.synchronize()
            self.log["mem_before_restart"] = torch.cuda.memory_allocated()
            self.log["crash_t"] = time.perf_counter()
            raise RuntimeError("forced restart")
        if not self.gate.wait(timeout=300):
            raise RuntimeError("the serve_http requests were never queued")
        n = self.worker.run_once()
        if not self.seen.is_set() and any(
                r.req_id == self.cancel_id and r.out
                for r in self.worker.batcher.active.values()):
            self.seen.set()
            end = time.monotonic() + 60
            while not self.worker.broker.check_cancelled([self.cancel_id]):
                if time.monotonic() > end:
                    raise RuntimeError("POST /cancel never arrived")
                time.sleep(0.0005)
        return n


def _http(port: int, path: str, body: dict | None = None, timeout=120.0):
    """One request to the producer: (status, headers, body bytes)."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _http_client(port: int, req, out: dict) -> None:
    """POST one request of the serve_http pass and record its answer and
    client-side times (``first``: the first SSE increment)."""
    body = dataclasses.asdict(req)
    if not req.stream:
        status, _, raw = _http(port, "/generate", body)
        out.update(status=status, answer=json.loads(raw),
                   t_done=time.perf_counter())
        return
    r = urllib.request.urlopen(urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}), timeout=120)
    incs, event = [], None
    with r:
        for raw in r:
            line = raw.decode().rstrip("\n")
            if line.startswith("event: "):
                event = line[len("event: "):]
            elif line.startswith("data: "):
                data = json.loads(line[len("data: "):])
                if event is None:
                    out.setdefault("first", time.perf_counter())
                    incs.extend(data["token_ids"])
                elif event == "done":
                    out["answer"] = data
                else:
                    raise AssertionError(f"SSE {event}: {data}")
            elif not line:
                event = None
    out.update(status=r.status, streamed=incs, t_done=time.perf_counter())


def _q(values, q):
    """The q-th percentile (EngineMetrics' rule) of ``values``, in ms."""
    s = sorted(values)
    return s[min(int(q / 100.0 * len(s)), len(s) - 1)] * 1e3 if s else None


def phase_serve_http(eng, want: list, inproc: dict, smi: str) -> None:
    """The serving front end on the main path: ``ProducerServer`` on
    127.0.0.1:0 over an ``InProcBroker``, and a ``ContinuousWorker``
    (``chunked_prefill=128``, the serve_continuous configuration on its
    engine) built and prewarmed by a factory under a ``Supervisor``. The
    factory's first worker raises at once (one forced restart: the second
    must come up within one pool of the memory before it). The 16
    requests of ``_serve_requests`` are POSTed concurrently over urllib,
    queued in order; 0 and 1 over server-sent events; request 3 cancelled
    by ``POST /cancel`` once its first tokens exist. Every other answer
    must equal the in-process chunked pass's tokens (``want``), each
    stream its answer; ``/metrics`` counts 16 requests (JSON and
    Prometheus), ``/dlq`` is empty, ``/health`` is 200 while serving and
    503 after ``Supervisor.drain``; no graph is captured after the
    prewarm; K3 and K4 launch. Prints the pass's wall, tokens/s and
    client-side TTFT beside the in-process pass's (``inproc``), and the
    prewarm and restart seconds, beside the card (``smi``)."""
    from llmss_tpu_torch.engine.metrics import EngineMetrics
    from llmss_tpu_torch.ops import decode_attention as da
    from llmss_tpu_torch.ops import flash_attention as fa
    from llmss_tpu_torch.ops import paged_attention as pa
    from llmss_tpu_torch.serve.broker import InProcBroker
    from llmss_tpu_torch.serve.consumer import ContinuousWorker
    from llmss_tpu_torch.serve.producer import ProducerServer
    from llmss_tpu_torch.serve.supervisor import Supervisor

    cfg = eng.cfg
    L = cfg.n_layers
    steps = count_steps(eng)
    _, requests = _serve_requests(cfg)
    reqs = requests()
    new = reqs[0].max_new_tokens
    broker = InProcBroker()
    gate, seen = threading.Event(), threading.Event()
    log: dict = {"prewarm_s": []}

    def factory():
        w = ContinuousWorker(eng, broker, rows=8, chunk_steps=8,
                             group_chunks=2, chunked_prefill=128)
        t = time.perf_counter()
        log["prewarm"] = w.prewarm()
        torch.cuda.synchronize()
        log["prewarm_s"].append(time.perf_counter() - t)
        if len(log["prewarm_s"]) == 1:
            log["pool_bytes"] = sum(t.numel() * t.element_size()
                                    for t in w.batcher.cache if t is not None)
            return _HttpPhaseWorker(w, log, crash=True)
        log["mem_after_prewarm"] = torch.cuda.memory_allocated()
        log["restart_s"] = time.perf_counter() - log["crash_t"]
        log["graphs"] = len(eng._graphs)
        log["keys"] = eng._graphs.keys()
        return _HttpPhaseWorker(w, log, gate=gate, cancel_id=reqs[SERVE_CANCEL].id,
                                seen=seen)

    # One restart is forced; a second crash ends the phase.
    sup = Supervisor(factory, broker, max_restarts=1, backoff_s=0.05,
                     heartbeat_s=1.0, step_timeout_s=120.0,
                     drain_timeout_s=120.0)
    srv = ProducerServer(broker, host="127.0.0.1", port=0, timeout_s=300.0)
    stop = threading.Event()
    loop = threading.Thread(target=sup.run, args=(stop,), daemon=True)
    srv.start()
    loop.start()
    clients: list[threading.Thread] = []
    outs = [{} for _ in reqs]
    try:
        end = time.monotonic() + 300
        while not ("keys" in log and sup.state == "ready"):
            if time.monotonic() > end or not loop.is_alive():
                raise AssertionError(f"the restarted worker never came up: "
                                     f"{sup._last_error}")
            time.sleep(0.05)
        if sup.restarts != 1 or "forced restart" not in sup._last_error:
            raise AssertionError(f"restarts {sup.restarts}: {sup._last_error}")
        grew = log["mem_after_prewarm"] - log["mem_before_restart"]
        if log["graphs"] != 1 or abs(grew) >= log["pool_bytes"]:
            raise AssertionError(f"restart: {log['graphs']} caches hold graphs,"
                                 f" memory moved {grew} B (pool "
                                 f"{log['pool_bytes']} B)")
        status, _, body = _http(srv.port, "/health")
        if status != 200:
            raise AssertionError(f"/health {status} before serving: {body}")
        # Concurrent clients, queued in order (the in-process pass's order).
        for i, r in enumerate(reqs):
            th = threading.Thread(target=_http_client,
                                  args=(srv.port, r, outs[i]), daemon=True)
            clients.append(th)
            th.start()
            end = time.monotonic() + 60
            while broker.queue_depth() < i + 1:
                if time.monotonic() > end:
                    raise AssertionError(f"request {i} was never queued")
                time.sleep(0.001)
        eng.metrics = EngineMetrics()
        fa.flash_attention.launches = da.decode_attention.launches = 0
        pa.paged_decode_attention.launches = 0
        pa.ragged_paged_attention.launches = 0
        steps.update(decode=0, ragged=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gate.set()
        if not seen.wait(timeout=300):
            raise AssertionError("the cancelled request never decoded")
        status, _, _ = _http(srv.port, "/cancel", {"id": reqs[SERVE_CANCEL].id})
        health, _, _ = _http(srv.port, "/health")
        for th in clients:
            th.join(timeout=300)
        if any(th.is_alive() for th in clients) or health != 200 or status != 200:
            raise AssertionError(f"clients hung, or /health {health}, "
                                 f"/cancel {status} while serving")
        torch.cuda.synchronize()
        wall = max(o["t_done"] for o in outs) - t0
        counts = dict(k1=fa.flash_attention.launches,
                      k2=da.decode_attention.launches,
                      k3=pa.paged_decode_attention.launches,
                      k4=pa.ragged_paged_attention.launches)
        for i, o in enumerate(outs):
            a = o["answer"]
            if i == SERVE_CANCEL:
                if o["status"] != 500 or a["error"] != "cancelled":
                    raise AssertionError(f"cancelled request answered {o}")
            elif o["status"] != 200 or a["error"] or a["token_ids"] != want[i]:
                raise AssertionError(
                    f"request {i}: HTTP {o['status']} {a} != the in-process "
                    f"pass's {want[i]}")
            if "streamed" in o and o["streamed"] != a["token_ids"]:
                raise AssertionError(f"request {i}: stream != answer")
        if counts["k1"] or counts["k2"] or not counts["k3"] or (
                not counts["k4"]) or counts["k3"] != L * steps["decode"] or (
                counts["k4"] != L * steps["ragged"]):
            raise AssertionError(f"launch counts {counts} for steps {steps}")
        if eng.metrics.graph_captures or eng._graphs.keys() != log["keys"]:
            raise AssertionError("the HTTP pass captured a graph")
        # The worker publishes every 16 iterations, the supervisor every
        # heartbeat: wait for the count.
        end = time.monotonic() + 30
        while True:
            _, _, raw = _http(srv.port, "/metrics")
            payload = json.loads(raw)
            if payload.get("requests_served") == len(reqs):
                break
            if time.monotonic() > end:
                raise AssertionError(f"/metrics: {payload.get('requests_served')}"
                                     f" requests served, not {len(reqs)}")
            time.sleep(0.1)
        _, _, prom = _http(srv.port, "/metrics?format=prometheus")
        _, _, dlq = _http(srv.port, "/dlq")
        if f"llmss_requests_served {len(reqs)}" not in prom.decode().splitlines():
            raise AssertionError("Prometheus text does not count the requests")
        if json.loads(dlq)["depth"] or payload["delivery"]["dlq_depth"]:
            raise AssertionError(f"/dlq: {dlq}")
        sup.drain()
        loop.join(timeout=180)
        after, _, body = _http(srv.port, "/health")
        if loop.is_alive() or after != 503 or json.loads(body)["status"] != "dead":
            raise AssertionError(f"/health {after} after the drain: {body}")
    finally:
        gate.set()
        stop.set()
        loop.join(timeout=60)
        srv.stop()
    m = eng.metrics
    served = sum(len(o["answer"]["token_ids"] or []) for i, o in enumerate(outs)
                 if i != SERVE_CANCEL)
    # Client-side times count from the pass's start (every request was
    # queued before it, as in the in-process pass).
    ttft = [o["first"] - t0 for o in outs if "first" in o]
    latency = [o["t_done"] - t0 for i, o in enumerate(outs)
               if i != SERVE_CANCEL]
    http = {"wall_s": wall, "tokens_per_s": served / wall,
            "client_ttft_p50_ms": _q(ttft, 50), "client_ttft_p90_ms": _q(ttft, 90),
            "client_ttft_n": len(ttft),
            "client_latency_p50_ms": _q(latency, 50),
            "client_latency_p90_ms": _q(latency, 90),
            "ttft_p50_ms": m.ttft.quantile_ms(50),
            "ttft_p90_ms": m.ttft.quantile_ms(90)}
    local = {k: inproc[k] for k in ("wall_s", "tokens_per_s", "ttft_p50_ms",
                                    "ttft_p90_ms")}
    emit({"phase": "serve_http", "nvidia_smi": smi,
          "admission": "chunked_prefill=128",
          "requests": len(reqs), "new_tokens": new, "sse": [0, 1],
          "cancelled": SERVE_CANCEL, "answers_equal_inproc": len(reqs) - 1,
          "streams_equal_answers": True, "requests_served_metric": len(reqs),
          "dlq_depth": 0, "health_serving": 200, "health_after_drain": 503,
          "graph_captures_after_prewarm": 0, "launches": counts,
          "decode_steps": steps["decode"], "ragged_steps": steps["ragged"],
          "http": http, "inproc": local,
          "front_end_cost": {k: http[k] - local[k] for k in local},
          "prewarm": log["prewarm"], "prewarm_s": log["prewarm_s"],
          "restart_s": log["restart_s"], "restarts": 1,
          "memory_moved_on_restart": grew, "pool_bytes": log["pool_bytes"]})
    del sup, srv, broker
    gc.collect()
    if len(eng._graphs):
        raise AssertionError("the serve_http workers' graphs outlived them")


# -- phase 6b, shared prefixes ----------------------------------------------------


PREFIX_NEW = 64  # new tokens per serve_prefix request


def _prefix_requests(cfg):
    """The serve_prefix phase's 16 requests: one 600-token system prompt
    and each its own 16-96-token suffix (seed 12), ``PREFIX_NEW`` new
    tokens, 12 greedy and 4 top-k/top-p sampled; ``requests(hint)`` makes
    them anew, with ``prefix_token_ids`` when ``hint``. Returns (the
    system prompt, the suffix lengths, the prompts, the maker)."""
    from llmss_tpu_torch.serve.protocol import GenerateRequest

    rng = np.random.default_rng(12)
    system = [int(t) for t in rng.integers(1, cfg.vocab_size, SYSTEM_LEN)]
    suf = [int(n) for n in rng.integers(16, 97, 16)]
    prompts = [system + [int(t) for t in rng.integers(1, cfg.vocab_size, n)]
               for n in suf]

    def requests(hint: bool, n: int = 16):
        return [GenerateRequest(
            token_ids=p, max_new_tokens=PREFIX_NEW,
            prefix_token_ids=list(system) if hint else None,
            **(dict(is_greedy=False, temperature=0.8, top_k=40, top_p=0.9,
                    seed=200 + i) if i >= 12 else {}))
            for i, p in enumerate(prompts[:n])]

    return system, suf, prompts, requests


def _prefix_pass(eng, worker, reqs, steps, prefills, name, blocks_after):
    """One pass of ``reqs`` through a prewarmed ContinuousWorker: every
    answer checked, the launch counts against the steps and prefills run
    (K1 n_layers per prefill, K2 never, K3 per decode step, K4 per ragged
    step), no graph captured, ``blocks_after`` blocks in use once idle.
    Returns (row, tokens): wall, tokens/s, TTFT p50 / p90, the prompt
    tokens K1 and K4 computed, peak blocks in use and live rows."""
    from llmss_tpu_torch.engine.metrics import EngineMetrics
    from llmss_tpu_torch.ops import decode_attention as da
    from llmss_tpu_torch.ops import flash_attention as fa
    from llmss_tpu_torch.ops import paged_attention as pa

    L = eng.cfg.n_layers
    bat = worker.batcher
    split = bat.chunked_prefill is None
    builds = sum(1 for key in {tuple(r.prefix_token_ids) for r in reqs
                               if r.prefix_token_ids}
                 if key not in worker._prefixes)
    eng.metrics = EngineMetrics()
    for r in reqs:
        worker.broker.push_request(r)
    for f in (fa.flash_attention, da.decode_attention,
              pa.paged_decode_attention, pa.ragged_paged_attention):
        f.launches = 0
    steps.update(decode=0, ragged=0)
    prefills.clear()
    answers, peak_blocks, peak_rows = {}, 0, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while len(answers) < len(reqs):
        worker.run_once()
        peak_blocks = max(peak_blocks, bat.allocator.blocks_in_use)
        peak_rows = max(peak_rows, len(bat.active))
        for r in reqs:
            if r.id not in answers:
                a = worker.broker.wait_response(r.id, timeout=0.0)
                if a is not None:
                    answers[r.id] = a
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(k1=fa.flash_attention.launches,
                  k2=da.decode_attention.launches,
                  k3=pa.paged_decode_attention.launches,
                  k4=pa.ragged_paged_attention.launches)
    toks = [answers[r.id].token_ids or [] for r in reqs]
    for i, r in enumerate(reqs):
        a = answers[r.id]
        if a.error or len(toks[i]) != PREFIX_NEW or not all(
                0 <= t < eng.cfg.vocab_size for t in toks[i]):
            raise AssertionError(f"{name} request {i}: bad answer {a}")
    if counts["k2"] or counts["k1"] != L * len(prefills) or (
            counts["k3"] != L * steps["decode"]) or (
            counts["k4"] != L * steps["ragged"]):
        raise AssertionError(f"{name}: launches {counts} for steps {steps} "
                             f"and {len(prefills)} prefills")
    if eng.metrics.graph_captures:
        raise AssertionError(f"{name}: a pass captured a graph")
    if bat.allocator.blocks_in_use != blocks_after:
        raise AssertionError(f"{name}: {bat.allocator.blocks_in_use} blocks "
                             f"in use once idle, want {blocks_after}")
    # K1's live prompt tokens: each prefill's lengths, less the one pad
    # token of every dummy admission row (the rows past the requests and
    # the prefix builds).
    rows = sum(int(lens.numel()) for _, lens in prefills)
    real = (len(reqs) if split else 0) + builds
    m = eng.metrics.to_dict()
    row = {"phase": "serve_prefix", "pass": name,
           "admission": "split" if split else
           f"chunked_prefill={bat.chunked_prefill}",
           "requests": len(reqs), "new_tokens": PREFIX_NEW, "wall_s": wall,
           "tokens_per_s": sum(map(len, toks)) / wall,
           "ttft_p50_ms": eng.metrics.ttft.quantile_ms(50),
           "ttft_p90_ms": eng.metrics.ttft.quantile_ms(90),
           "prefix_builds": builds,
           "k1_prompt_tokens": sum(int(lens.sum()) for _, lens in prefills)
           - (rows - real),
           "k1_padded_tokens": sum(math.prod(shape) for shape, _ in prefills),
           "k4_prompt_tokens": m["mixed_batch"]["prefill_tokens_chunked"],
           "peak_blocks_in_use": peak_blocks, "peak_live_rows": peak_rows,
           "blocks_in_use_after": blocks_after,
           "decode_steps": steps["decode"], "ragged_steps": steps["ragged"],
           "launches": counts, "kv_block_evictions": m["kv_block_evictions"],
           "kv_evictions_dropped": m["kv_evictions_dropped"],
           "decode_ms_per_step": m["decode_step"]["mean_ms"],
           "graph_captures_after_prewarm": 0}
    return row, toks


def phase_serve_prefix(eng) -> None:
    """Shared-prefix serving at Llama-2-7B width over serve_continuous's
    engine (bf16, max_seq_len 1024, block_size 16, a 256-block pool),
    ContinuousWorkers of 8 rows, chunk_steps 8, group_chunks 2, each
    prewarmed: the 16 ``_prefix_requests`` without the hint (split), then
    with ``prefix_token_ids`` (split: K1 over suffixes at q0 600 with the
    37 shared blocks in every table, K3), then with the hint and
    chunked_prefill=128 (K4 from slot 592, K3) twice (same tokens), then 8
    hint-less requests that need more blocks than are free: the idle
    prefix is evicted once. Reports each pass and the share of tokens
    equal to the hint-less pass's (bf16 is not bit-exact across matmul
    shapes: a measurement)."""
    from llmss_tpu_torch.serve.broker import InProcBroker
    from llmss_tpu_torch.serve.consumer import ContinuousWorker

    steps = count_steps(eng)
    prefills = []
    prefill = eng._prefill

    def counted_prefill(ids, cache, lens, sa, start=None):
        prefills.append((tuple(ids.shape), lens))
        return prefill(ids, cache, lens, sa, start)

    eng._prefill = counted_prefill
    system, suf, prompts, requests = _prefix_requests(eng.cfg)
    workers, warm = {}, {}
    for chunked in (False, True):
        w = workers[chunked] = ContinuousWorker(
            eng, InProcBroker(), rows=8, chunk_steps=8, group_chunks=2,
            chunked_prefill=128 if chunked else None)
        t = time.perf_counter()
        warm[chunked] = {"prewarm": w.prewarm(prefix_prefill=True),
                         "prewarm_s": time.perf_counter() - t}
    keys = eng._graphs.keys()
    emit({"phase": "serve_prefix", "prewarmed_workers": 2,
          "system_prompt_tokens": SYSTEM_LEN, "suffix_lens": suf,
          "shared_full_blocks": SYSTEM_LEN // 16,
          "prewarm": {("chunked" if k else "split"): v
                      for k, v in warm.items()}})

    def run(chunked, hint, name, blocks_after, reqs=None):
        return _prefix_pass(eng, workers[chunked], reqs or requests(hint),
                            steps, prefills, name, blocks_after)

    plain, plain_t = run(False, False, "no_hint_split", 0)
    emit(plain)
    hinted, hint_t = run(False, True, "hint_split", SHARED_BLOCKS)
    chunk, chunk_t = run(True, True, "hint_chunked", SHARED_BLOCKS)
    again, again_t = run(True, True, "hint_chunked_repeat", SHARED_BLOCKS)
    n_tok = sum(map(len, plain_t))
    for row, toks in ((hinted, hint_t), (chunk, chunk_t), (again, again_t)):
        row["tokens_equal_to_no_hint_share"] = sum(
            x == y for a, b in zip(toks, plain_t) for x, y in zip(a, b)) / n_tok
        emit(row)
    if again_t != chunk_t:
        raise AssertionError("a repeat of the chunked prefix pass gave "
                             "other tokens")
    bat = workers[True].batcher
    free = bat.allocator.free_blocks
    need = sum(-(-(len(p) + PREFIX_NEW) // 16) for p in prompts[:8])
    evict, _ = run(True, False, "evict_no_hint_chunked", 0,
                   requests(False, 8))
    evict.update(free_blocks_before=free, blocks_needed=need,
                 allocator_evictions=bat.allocator.evictions)
    emit(evict)
    if need <= free or (evict["kv_block_evictions"],
                        evict["kv_evictions_dropped"],
                        bat.allocator.evictions) != (1, 1, 1):
        raise AssertionError(f"eviction: {evict}")
    if eng._graphs.keys() != keys:
        raise AssertionError("a prefix pass captured a graph")
    emit({"phase": "serve_prefix", "check": "chunked_prefix_pass_repeats",
          "identical": True, "prefix_hashes": workers[True].load_snapshot()[
              "prefix_hashes"]})
    del eng._prefill, workers, w, bat
    gc.collect()


# -- preemption and the prefill / decode roles -----------------------------------


def _launch_counter():
    """Set the four kernels' launch counts to 0; returns a reader of them."""
    from llmss_tpu_torch.ops import decode_attention as da
    from llmss_tpu_torch.ops import flash_attention as fa
    from llmss_tpu_torch.ops import paged_attention as pa

    fns = (fa.flash_attention, da.decode_attention,
           pa.paged_decode_attention, pa.ragged_paged_attention)
    for f in fns:
        f.launches = 0
    return lambda: dict(zip(("k1", "k2", "k3", "k4"),
                            (f.launches for f in fns)))


def _priority_schedule(bat, G, prompts, news, hi, hi_new, preempt=True):
    """The reference_priority schedule on one batcher: batch-class
    requests decode, an interactive one arrives after 3 steps, and every
    evicted request is submitted again with its tokens replayed, as a
    worker does. Returns ({key: tokens}, [evicted keys])."""
    out, evicted = {}, []

    def cb(key):
        return lambda t, *a, **k: out.__setitem__(key, list(t))

    if preempt:
        bat.preempt_cb = lambda rid, toks: evicted.append((rid, list(toks)))
    for i, (p, n) in enumerate(zip(prompts, news)):
        bat.submit(p, G(max_new_tokens=n), cb(i), req_id=str(i), priority=2)
    for _ in range(3):
        bat.step()
    bat.submit(hi, G(max_new_tokens=hi_new), cb("hi"), req_id="hi",
               priority=0)
    resumed = 0
    while not bat.idle or resumed < len(evicted):
        for rid, toks in evicted[resumed:]:
            i = int(rid)
            bat.submit(prompts[i] + toks,
                       G(max_new_tokens=news[i] - len(toks)), cb(i),
                       req_id=rid, priority=2, replayed=len(toks))
        resumed = len(evicted)
        bat.step()
    return out, [rid for rid, _ in evicted]


def phase_reference_priority() -> None:
    """Preemption on the tiny fp32 llama: two batch-class requests fill a
    two-row batcher, an interactive one evicts the one with fewer tokens,
    which resumes with its tokens replayed; dense (K1 + K2), paged split
    (K1 + K3) and chunked (K4 + K3). The card's tokens and victims equal
    the CPU's, and the resumed request's tokens equal its tokens in the
    same schedule without preemption."""
    from llmss_tpu_torch.engine.engine import DecodeEngine, GenerationParams
    from llmss_tpu_torch.engine.scheduler import ContinuousBatcher
    from llmss_tpu_torch.models.decoder import init_params

    cfg = _tiny_llama()
    cpu_params = init_params(cfg, seed=7, device="cpu")
    gpu_params = _to(cpu_params, "cuda")
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(1, 512, n)] for n in (20, 7)]
    hi = [int(t) for t in rng.integers(1, 512, 9)]
    news = [24, 20]

    def run(params, device, layout, chunked, preempt=True):
        eng = DecodeEngine(cfg, params, device=device, max_seq_len=128,
                           **({} if layout == "dense" else
                              dict(kv_layout="paged", block_size=16)))
        bat = ContinuousBatcher(eng, rows=2, chunk_steps=4, group_chunks=2,
                                chunked_prefill=16 if chunked else None)
        out, victims = _priority_schedule(bat, GenerationParams, prompts,
                                          news, hi, 8, preempt)
        if layout == "paged" and bat.allocator.blocks_in_use:
            raise AssertionError("blocks in use after the schedule")
        return out, victims, eng.metrics.preempted

    for layout, chunked in (("dense", False), ("paged", False),
                            ("paged", True)):
        want, want_v, _ = run(cpu_params, "cpu", layout, chunked)
        count = _launch_counter()
        got, victims, n = run(gpu_params, None, layout, chunked)
        counts = count()
        plain, none_v, _ = run(gpu_params, None, layout, chunked, False)
        resumed_equal = all(got[int(v)] == plain[int(v)] for v in victims)
        emit({"phase": "reference_priority", "layout": layout,
              "admission": "chunked_prefill=16" if chunked else "split",
              "identical": got == want, "victims": victims,
              "cpu_victims": want_v, "preemptions": n,
              "resumed_equal_unpreempted": resumed_equal,
              "launches": counts, "tokens": got})
        if got != want or victims != want_v or not victims or none_v:
            raise AssertionError(f"priority {layout}: card {got} {victims} "
                                 f"!= CPU {want} {want_v}")
        if not resumed_equal:
            raise AssertionError(f"priority {layout}: resumed tokens != "
                                 "unpreempted tokens")
        used = ("k1", "k2") if layout == "dense" else (
            ("k4", "k3") if chunked else ("k1", "k3"))
        if not all(counts[k] for k in used):
            raise AssertionError(f"priority {layout}: launches {counts}")


def _drive_roles(broker, pre, dec, reqs, on_step=None):
    """Run a prefill and a decode worker alternately from this thread until
    every request is answered; each runs only when it has work, so no poll
    waits. Returns {id: response}."""
    answers, idle = {}, 0
    while len(answers) < len(reqs):
        busy = False
        if broker.queue_depth() or not pre.batcher.idle:
            pre.run_once()
            busy = True
        if (broker.handoff_depth() or not dec.batcher.idle
                or dec._adopt_backlog):
            dec.run_once()
            busy = True
        if on_step is not None:
            on_step()
        for r in reqs:
            if r.id not in answers:
                a = broker.wait_response(r.id, timeout=0.0)
                if a is not None:
                    answers[r.id] = a
        idle = 0 if busy else idle + 1
        if idle > 100:
            raise AssertionError(f"roles stalled with {len(answers)} of "
                                 f"{len(reqs)} answered")
    for r in reqs:
        if broker.wait_response(r.id, timeout=0.0) is not None:
            raise AssertionError(f"{r.id} answered twice")
    return answers


def phase_reference_roles() -> None:
    """The prefill and decode roles on the tiny fp32 llama, over fp32 and
    int8 pools, split (K1, then K3 over adopted blocks) and chunked (K4):
    a prefill-role and a decode-role ContinuousWorker on one InProcBroker
    answer 6 requests (one sampled, one of a single token, answered by the
    prefill worker). The card's answers equal the CPU's, and a unified
    worker's on the card."""
    from llmss_tpu_torch.engine.engine import DecodeEngine
    from llmss_tpu_torch.models.decoder import init_params
    from llmss_tpu_torch.serve.broker import InProcBroker
    from llmss_tpu_torch.serve.consumer import ContinuousWorker
    from llmss_tpu_torch.serve.protocol import GenerateRequest

    cfg = _tiny_llama()
    cpu_params = init_params(cfg, seed=8, device="cpu")
    gpu_params = _to(cpu_params, "cuda")
    rng = np.random.default_rng(8)
    prompts = [[int(t) for t in rng.integers(1, 512, n)]
               for n in (5, 20, 33, 7, 48, 12)]
    news = (16, 9, 12, 20, 6, 1)

    def reqs():
        return [GenerateRequest(id=f"r{i}", token_ids=p, max_new_tokens=n,
                                **(dict(is_greedy=False, temperature=0.8,
                                        top_k=20, seed=3) if i == 1 else {}))
                for i, (p, n) in enumerate(zip(prompts, news))]

    def serve(params, device, kv, chunked, roles):
        eng = DecodeEngine(cfg, params, device=device, max_seq_len=128,
                           kv_layout="paged", block_size=16, kv_dtype=kv)
        broker = InProcBroker()
        kw = dict(rows=2, chunk_steps=4, group_chunks=2,
                  chunked_prefill=16 if chunked else None)
        rs = reqs()
        for r in rs:
            broker.push_request(r)
        if roles:
            pre = ContinuousWorker(eng, broker, role="prefill", **kw)
            dec = ContinuousWorker(eng, broker, role="decode", **kw)
            answers = _drive_roles(broker, pre, dec, rs)
            if broker.delivery_stats()["handoffs"] != 5:
                raise AssertionError("not every request was handed off")
        else:
            w = ContinuousWorker(eng, broker, **kw)
            answers = {}
            while len(answers) < len(rs):
                w.run_once()
                for r in rs:
                    a = broker.wait_response(r.id, timeout=0.0)
                    if a is not None:
                        answers[r.id] = a
        if any(a.error for a in answers.values()):
            raise AssertionError(f"roles: an error answer {answers}")
        return [answers[r.id].token_ids for r in rs]

    for kv in (None, "int8"):
        for chunked in (False, True):
            want = serve(cpu_params, "cpu", kv, chunked, True)
            count = _launch_counter()
            got = serve(gpu_params, None, kv, chunked, True)
            counts = count()
            unified = serve(gpu_params, None, kv, chunked, False)
            emit({"phase": "reference_roles", "kv": kv or "float32",
                  "admission": "chunked_prefill=16" if chunked else "split",
                  "identical": got == want, "equal_to_unified": got == unified,
                  "launches": counts, "tokens": got})
            if got != want or got != unified:
                raise AssertionError(f"roles {kv} chunked={chunked}: card "
                                     f"{got}, CPU {want}, unified {unified}")
            if not counts["k3"] or not counts["k4" if chunked else "k1"]:
                raise AssertionError(f"roles: launches {counts}")


PRIORITY_NEW, INTERACTIVE_NEW = 64, 32  # serve_priority's new tokens


def _priority_requests(cfg):
    """serve_priority's traffic, made anew per pass: 8 batch-class
    requests on ``_serve_requests``' first 8 prompts, ``PRIORITY_NEW`` new
    tokens, and 4 interactive ones of 64-200 tokens (seed 13),
    ``INTERACTIVE_NEW`` new tokens, streamed (their first increment is
    their TTFT)."""
    from llmss_tpu_torch.serve.protocol import GenerateRequest

    base = [r.token_ids for r in _serve_requests(cfg)[1]()[:8]]
    rng = np.random.default_rng(13)
    inter = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)]
             for n in rng.integers(64, 201, 4)]

    def requests():
        return ([GenerateRequest(id=f"b{i}", token_ids=p,
                                 max_new_tokens=PRIORITY_NEW,
                                 slo_class="batch")
                 for i, p in enumerate(base)],
                [GenerateRequest(id=f"i{i}", token_ids=p,
                                 max_new_tokens=INTERACTIVE_NEW,
                                 slo_class="interactive", stream=True)
                 for i, p in enumerate(inter)])

    return [len(p) for p in inter], requests


def _priority_pass(worker, requests, preempt: bool, card: bool = True):
    """One serve_priority pass through ``worker`` on a fresh InProcBroker:
    the batch requests first, the interactive ones after the worker's
    second ``run_once``; on the ``card`` the worker is prewarmed and
    captures nothing. Returns (row, {id: tokens}, [(victim, replayed
    tokens)])."""
    from llmss_tpu_torch.engine.metrics import EngineMetrics
    from llmss_tpu_torch.serve.broker import InProcBroker

    bat, eng = worker.batcher, worker.engine
    cb, bat.preempt_cb = bat.preempt_cb, (bat.preempt_cb if preempt
                                          else None)
    broker = worker.broker = InProcBroker()
    victims = []
    refund = broker.preempt_requests

    def spy(reqs):
        victims.extend((r.id, len(r.resume_tokens or ())) for r in reqs)
        return refund(reqs)

    broker.preempt_requests = spy
    eng.metrics = EngineMetrics()
    batch, inter = requests()
    for r in batch:
        broker.push_request(r)
    answers, first, t_push, it = {}, {}, {}, 0
    sync = torch.cuda.synchronize if card else (lambda: None)
    sync()
    t0 = time.perf_counter()
    while len(answers) < len(batch) + len(inter):
        if it == 2:
            for r in inter:
                broker.push_request(r)
                t_push[r.id] = time.perf_counter()
        worker.run_once()
        it += 1
        now = time.perf_counter()
        for r in inter:
            if (r.id in t_push and r.id not in first
                    and broker.pop_stream(r.id) is not None):
                first[r.id] = now - t_push[r.id]
        for r in batch + inter:
            if r.id not in answers:
                a = broker.wait_response(r.id, timeout=0.0)
                if a is not None:
                    answers[r.id] = (a, now - t0)
    sync()
    bat.preempt_cb = cb
    toks = {rid: a.token_ids or [] for rid, (a, _) in answers.items()}
    for rid, (a, _) in answers.items():
        want = PRIORITY_NEW if rid[0] == "b" else INTERACTIVE_NEW
        if a.error or len(toks[rid]) != want:
            raise AssertionError(f"serve_priority {rid}: bad answer {a}")
        if broker.wait_response(rid, timeout=0.0) is not None:
            raise AssertionError(f"serve_priority {rid}: answered twice")
    st = broker.delivery_stats()
    if st["preempted"] != len(victims) or st["dlq_depth"] or (
            preempt is False and victims):
        raise AssertionError(f"serve_priority: stats {st}, victims {victims}")
    if bat.allocator.blocks_in_use:
        raise AssertionError("serve_priority: blocks in use after the pass")
    if card and eng.metrics.graph_captures:
        raise AssertionError("serve_priority: a pass captured a graph")
    wall = max(t for _, t in answers.values())
    ttft = sorted(first.values())
    return ({"phase": "serve_priority",
             "admission": (f"chunked_prefill={bat.chunked_prefill}"
                           if bat.chunked_prefill else "split"),
             "preemption": preempt, "preemptions": len(victims),
             "victims": [v for v, _ in victims],
             "replayed_prompt_tokens": sum(n for _, n in victims),
             "preempted_rows": eng.metrics.preempted,
             "interactive_ttft_ms": [first[r.id] * 1e3 for r in inter],
             "interactive_ttft_p50_ms": _q(ttft, 50),
             "interactive_ttft_p90_ms": _q(ttft, 90),
             "batch_completion_s": max(t for rid, (_, t) in answers.items()
                                       if rid[0] == "b"),
             "wall_s": wall,
             "tokens_per_s": sum(map(len, toks.values())) / wall,
             "graph_captures_after_prewarm": 0, "blocks_in_use_after": 0},
            toks, victims)


def _priority_rehearsal(chunked: bool):
    """serve_priority's preempting pass on the CPU, on a one-layer model
    of the same vocabulary at max_seq_len 1024 with the same pool, rows
    and groups: the schedule (who is evicted, after how many tokens)
    depends on those and on the traffic only."""
    from llmss_tpu_torch.engine.engine import DecodeEngine
    from llmss_tpu_torch.models.common import DecoderConfig
    from llmss_tpu_torch.models.decoder import init_params
    from llmss_tpu_torch.serve.broker import InProcBroker
    from llmss_tpu_torch.serve.consumer import ContinuousWorker

    cfg = DecoderConfig(**{**LLAMA2_7B, "hidden_size": 64, "n_layers": 1,
                           "n_heads": 2, "n_kv_heads": 2, "head_dim": 32,
                           "rotary_dim": 32, "intermediate_size": 128,
                           "dtype": "float32"})
    eng = DecodeEngine(cfg, init_params(cfg, seed=0, device="cpu"),
                       device="cpu", max_seq_len=1024, kv_layout="paged",
                       block_size=16, kv_blocks=256)
    w = ContinuousWorker(eng, InProcBroker(), rows=8, chunk_steps=8,
                         group_chunks=2,
                         chunked_prefill=128 if chunked else None)
    return _priority_pass(w, _priority_requests(cfg)[1], True, False)[2]


def phase_serve_priority(params) -> None:
    """Preemption at Llama-2-7B width and ``CUT_LAYERS`` deep (bf16,
    random weights from seed 0, their first 8 layers): a ContinuousWorker
    of 8 rows over a 256-block pool, chunk_steps 8,
    group_chunks 2, prewarmed, split and chunked (128). 8 batch-class
    requests (64 new tokens) fill the rows; after the worker's second
    ``run_once`` 4 interactive ones arrive (64-200 tokens, 32 new), each
    evicting a batch row, which the broker refunds and the worker resumes
    by replaying its tokens. Each pass once with preemption and once with
    ``preempt_cb = None``: preemptions and the victims (equal to a CPU
    rehearsal of the same schedule), replayed prompt tokens, interactive
    TTFT, batch completion, tokens/s, and the share of each victim's
    tokens equal to its tokens without preemption (bf16: a
    measurement)."""
    from llmss_tpu_torch.engine.engine import DecodeEngine
    from llmss_tpu_torch.models.common import DecoderConfig
    from llmss_tpu_torch.serve.broker import InProcBroker
    from llmss_tpu_torch.serve.consumer import ContinuousWorker

    cfg = DecoderConfig(**dict(LLAMA2_7B, n_layers=CUT_LAYERS))
    eng = DecodeEngine(cfg, _first_layers(params, CUT_LAYERS),
                       max_seq_len=1024, kv_layout="paged", block_size=16,
                       kv_blocks=256)
    inter_lens, requests = _priority_requests(cfg)
    workers, warm = {}, {}
    for chunked in (False, True):
        w = workers[chunked] = ContinuousWorker(
            eng, InProcBroker(), rows=8, chunk_steps=8, group_chunks=2,
            chunked_prefill=128 if chunked else None)
        t = time.perf_counter()
        warm[chunked] = {"prewarm": w.prewarm(),
                         "prewarm_s": time.perf_counter() - t}
    keys = eng._graphs.keys()
    emit({"phase": "serve_priority", "interactive_prompt_lens": inter_lens,
          "batch_prompt_lens": [len(r.token_ids) for r in requests()[0]],
          "prewarm": {("chunked" if k else "split"): v
                      for k, v in warm.items()}})
    for chunked in (False, True):
        t = time.perf_counter()
        rehearsal = _priority_rehearsal(chunked)
        rehearsal_s = time.perf_counter() - t
        count = _launch_counter()
        row, toks, victims = _priority_pass(workers[chunked], requests, True)
        row["launches"] = count()
        plain_row, plain, _ = _priority_pass(workers[chunked], requests,
                                             False)
        row.update(rehearsal_victims=[v for v, _ in rehearsal],
                   rehearsal_s=rehearsal_s,
                   victim_tokens_equal_share={
                       v: sum(a == b for a, b in zip(toks[v], plain[v]))
                       / len(plain[v]) for v, _ in victims})
        emit(row)
        emit(plain_row)
        if victims != rehearsal or not victims:
            raise AssertionError(f"serve_priority: victims {victims} != the "
                                 f"rehearsal's {rehearsal}")
    if eng._graphs.keys() != keys:
        raise AssertionError("serve_priority captured a graph")
    del workers, w
    gc.collect()


def _timed_handoff(on):
    """Wrap the handoff's four steps where the serving path calls them
    (``scheduler.export_blocks`` / ``import_blocks``,
    ``consumer.encode_blocks`` / ``decode_blocks``) to record each call's
    ms in ``on``: {step: [(request id, ms, bytes)]}. Export and import
    are timed between device syncs (the copy alone; export waits on its
    copy anyway). Returns the undo."""
    from llmss_tpu_torch.engine import scheduler as sched
    from llmss_tpu_torch.serve import consumer

    orig = (sched.export_blocks, sched.import_blocks,
            consumer.encode_blocks, consumer.decode_blocks)
    cur = {"export": None, "decode": None}

    def nbytes(blocks):
        return sum(t.numel() * t.element_size()
                   for t in (blocks[k] for k in ("k", "v", "k_scale",
                                                 "v_scale"))
                   if t is not None)

    def export(cache, ids, n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig[0](cache, ids, n)
        cur["export"] = ((time.perf_counter() - t) * 1e3, nbytes(out))
        return out

    def encode(blocks, *, req_id, **kw):
        t = time.perf_counter()
        out = orig[2](blocks, req_id=req_id, **kw)
        ms = (time.perf_counter() - t) * 1e3
        on["export"].append((req_id, *cur["export"]))
        on["encode"].append((req_id, ms, len(out)))
        return out

    def decode(data):
        t = time.perf_counter()
        out = orig[3](data)
        ms = (time.perf_counter() - t) * 1e3
        cur["decode"] = out["req_id"]
        on["decode"].append((out["req_id"], ms, len(data)))
        return out

    def import_(cache, k, v, ks, vs, ids):
        torch.cuda.synchronize()
        t = time.perf_counter()
        orig[1](cache, k, v, ks, vs, ids)
        torch.cuda.synchronize()
        on["import"].append((cur["decode"], (time.perf_counter() - t) * 1e3,
                             sum(x.numel() * x.element_size()
                                 for x in (k, v, ks, vs) if x is not None)))

    (sched.export_blocks, sched.import_blocks, consumer.encode_blocks,
     consumer.decode_blocks) = export, import_, encode, decode

    def undo():
        (sched.export_blocks, sched.import_blocks, consumer.encode_blocks,
         consumer.decode_blocks) = orig

    return undo


def _roles_pass(pre, dec, reqs, steps, prefills, cancel=None, readback=None):
    """One pass of ``reqs`` through a prefill and a decode worker on a
    fresh InProcBroker, driven alternately: every answer checked (the
    ``cancel`` index cancelled once it decodes on the decode side), the
    handoffs and their bytes, the launches against the steps and
    prefills both engines ran, no capture, every block back. ``readback``
    (a request id): its adopted blocks are read back from the decode pool
    and held to the exported bytes. Returns (row, tokens, handoff
    timings)."""
    from llmss_tpu_torch.engine.metrics import EngineMetrics
    from llmss_tpu_torch.serve.broker import InProcBroker

    L = pre.engine.cfg.n_layers
    broker = InProcBroker()
    pre.broker = dec.broker = broker
    for w in (pre, dec):
        w.engine.metrics = EngineMetrics()
    for s in steps:
        s.update(decode=0, ragged=0)
    prefills.clear()
    sizes, adopted, timing = [], {}, {k: [] for k in ("export", "encode",
                                                       "decode", "import")}
    push = broker.push_handoff
    broker.push_handoff = lambda rec: (sizes.append(len(rec.payload)),
                                       push(rec))[1]
    adopt = dec.batcher.adopt
    checked = []

    def timed_adopt(rid, first, n, blocks, *a, **kw):
        ok = adopt(rid, first, n, blocks, *a, **kw)
        if ok:
            adopted[rid] = time.perf_counter()
            if rid == readback:
                row = next(i for i, r in dec.batcher.active.items()
                           if r.req_id == rid)
                own = dec.batcher._row_owned[row][: blocks["k"].shape[1]]
                for name in ("k", "v"):
                    back = getattr(dec.batcher.cache, name)[:, own].cpu()
                    checked.append(back.view(torch.int16).equal(
                        blocks[name].view(torch.int16)))
        return ok

    dec.batcher.adopt = timed_adopt
    undo = _timed_handoff(timing)
    count = _launch_counter()
    cancel_sent = cancel is None

    def on_step():
        nonlocal cancel_sent
        if not cancel_sent and any(r.req_id == reqs[cancel].id and r.out
                                   for r in dec.batcher.active.values()):
            broker.cancel_request(reqs[cancel].id)
            cancel_sent = True

    for r in reqs:
        broker.push_request(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        answers = _drive_roles(broker, pre, dec, reqs, on_step)
    finally:
        undo()
        del dec.batcher.adopt
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = count()
    toks = [answers[r.id].token_ids or [] for r in reqs]
    for i, (r, t) in enumerate(zip(reqs, toks)):
        a = answers[r.id]
        if i == cancel:
            if a.error != "cancelled" or not 0 < len(t) < r.max_new_tokens:
                raise AssertionError(f"cancelled request answered {a}")
        elif a.error or len(t) != r.max_new_tokens:
            raise AssertionError(f"roles request {i}: bad answer {a}")
    st = broker.delivery_stats()
    handed = sum(r.max_new_tokens > 1 for r in reqs)
    if (st["handoffs"], st["handoff_bytes"]) != (handed, sum(sizes)) or (
            st["reprefills"] or st["dlq_depth"] or st["handoff_inflight"]):
        raise AssertionError(f"roles: stats {st}, {handed} to hand off")
    if readback is not None and checked != [True, True]:
        raise AssertionError("adopted blocks != the exported bytes")
    ps, ds = steps
    if counts["k2"] or counts["k1"] != L * len(prefills) or (
            counts["k3"] != L * (ps["decode"] + ds["decode"])) or (
            counts["k4"] != L * (ps["ragged"] + ds["ragged"])):
        raise AssertionError(f"roles: launches {counts}, steps {steps}, "
                             f"{len(prefills)} prefills")
    for w in (pre, dec):
        if w.engine.metrics.graph_captures:
            raise AssertionError(f"roles: the {w.role} worker captured")
        if w.batcher.allocator.blocks_in_use:
            raise AssertionError(f"roles: the {w.role} worker holds blocks")
    ttft = sorted(adopted[r.id] - t0 for r in reqs if r.id in adopted)
    sums = {k: sum(x[1] for x in v) for k, v in timing.items()}
    row = {"phase": "serve_roles",
           "admission": (f"chunked_prefill={pre.batcher.chunked_prefill}"
                         if pre.batcher.chunked_prefill else "split"),
           "requests": len(reqs), "wall_s": wall,
           "tokens_per_s": sum(len(t) for i, t in enumerate(toks)
                               if i != cancel) / wall,
           "ttft_p50_ms": _q(ttft, 50), "ttft_p90_ms": _q(ttft, 90),
           "handoffs": st["handoffs"], "handoff_bytes": st["handoff_bytes"],
           "export_ms": sums["export"], "encode_ms": sums["encode"],
           "decode_ms": sums["decode"], "import_ms": sums["import"],
           "export_bytes": sum(x[2] for x in timing["export"]),
           "launches": counts,
           "k3_decode_worker": L * ds["decode"],
           "decode_steps": {"prefill_worker": ps["decode"],
                            "decode_worker": ds["decode"]},
           "ragged_steps": ps["ragged"], "prefills": len(prefills),
           "graph_captures_after_prewarm": 0, "blocks_in_use_after": 0}
    return row, toks, timing


def phase_serve_roles(params, unified: dict) -> None:
    """The prefill and decode roles at Llama-2-7B width (bf16, random
    weights from seed 0): a prefill-role ContinuousWorker and a
    decode-role one on one card, each on its own DecodeEngine over the
    same weight tensors and its own 256-block pool, 8 rows, chunk_steps 8,
    group_chunks 2, prewarmed, over one InProcBroker and driven
    alternately from this thread: ``_serve_requests``' 16 requests, split
    then chunked (128). Per request and in sum: payload bytes, export
    (device to host), encode (CRC included), decode and import (host to
    device) ms; the pass's wall, tokens/s and TTFT (push to adoption)
    beside ``unified`` (serve_continuous's passes in this run: rows and
    tokens), and the share of tokens equal to theirs. Then the longest
    request alone through the roles and through a unified worker (the
    same shapes): equal tokens, and its adopted blocks read back equal to
    the exported bytes."""
    from llmss_tpu_torch.engine.engine import DecodeEngine
    from llmss_tpu_torch.models.common import DecoderConfig
    from llmss_tpu_torch.serve.broker import InProcBroker
    from llmss_tpu_torch.serve.consumer import ContinuousWorker

    cfg = DecoderConfig(**LLAMA2_7B)

    def engine(blocks=256):
        return DecodeEngine(cfg, params, max_seq_len=1024, kv_layout="paged",
                            block_size=16, kv_blocks=blocks)

    peng, deng = engine(), engine()
    steps = (count_steps(peng), count_steps(deng))
    prefills = []
    prefill = peng._prefill

    def counted_prefill(ids, cache, lens, sa, start=None):
        prefills.append(tuple(ids.shape))
        return prefill(ids, cache, lens, sa, start)

    peng._prefill = counted_prefill
    kw = dict(rows=8, chunk_steps=8, group_chunks=2)
    pres, warm = {}, {}
    for chunked in (False, True):
        w = pres[chunked] = ContinuousWorker(
            peng, InProcBroker(), role="prefill",
            chunked_prefill=128 if chunked else None, **kw)
        t = time.perf_counter()
        warm["prefill_chunked" if chunked else "prefill_split"] = (
            w.prewarm(), time.perf_counter() - t)
    dec = ContinuousWorker(deng, InProcBroker(), role="decode", **kw)
    t = time.perf_counter()
    warm["decode"] = (dec.prewarm(seq_buckets=[]), time.perf_counter() - t)
    keys = (peng._graphs.keys(), deng._graphs.keys())
    lens, requests = _serve_requests(cfg)
    emit({"phase": "serve_roles", "prewarm": warm, "prompt_lens": lens})
    for chunked in (False, True):
        name = "chunked" if chunked else "split"
        row, toks, timing = _roles_pass(pres[chunked], dec, requests(),
                                        steps, prefills, cancel=SERVE_CANCEL)
        u_row, u_toks = unified[name]
        n = sum(len(t) for i, t in enumerate(u_toks) if i != SERVE_CANCEL)
        row.update(
            unified_wall_s=u_row["wall_s"],
            unified_tokens_per_s=u_row["tokens_per_s"],
            unified_ttft_p50_ms=u_row["ttft_p50_ms"],
            unified_ttft_p90_ms=u_row["ttft_p90_ms"],
            tokens_equal_to_unified_share=sum(
                x == y for i, (a, b) in enumerate(zip(toks, u_toks))
                if i != SERVE_CANCEL for x, y in zip(a, b)) / n,
            per_request=[{
                "id": rid[:8], "bytes": nbytes, "export_ms": ms,
                "encode_ms": sum(x[1] for x in timing["encode"]
                                 if x[0] == rid),
                "decode_ms": sum(x[1] for x in timing["decode"]
                                 if x[0] == rid),
                "import_ms": sum(x[1] for x in timing["import"]
                                 if x[0] == rid)}
                for rid, ms, nbytes in timing["export"]])
        emit(row)
    # The longest request alone: the roles against a unified worker.
    longest = max(range(len(lens)), key=lambda i: lens[i])

    solo = dataclasses.replace(requests()[longest], stream=False)
    row, toks, _ = _roles_pass(pres[False], dec, [solo], steps, prefills,
                               readback=solo.id)
    ueng = engine(blocks=64)
    uw = ContinuousWorker(ueng, InProcBroker(), **kw)
    reqs = [dataclasses.replace(solo, delivery_attempts=0)]
    uw.broker.push_request(reqs[0])
    ans = None
    while ans is None:
        uw.run_once()
        ans = uw.broker.wait_response(reqs[0].id, timeout=0.0)
    row.update(solo_prompt_len=lens[longest],
               equal_to_unified_worker=toks[0] == ans.token_ids,
               adopted_blocks_equal_exported=True)
    emit(row)
    if toks[0] != ans.token_ids:
        raise AssertionError("a request alone through the roles != the "
                             "unified worker's tokens")
    if (peng._graphs.keys(), deng._graphs.keys()) != keys:
        raise AssertionError("serve_roles captured a graph")
    del pres, dec, uw, w
    gc.collect()


# -- the fleet ----------------------------------------------------------------


# The serve_fleet order: four system prompts, two requests each in turn,
# twice over.
FLEET_ORDER = (0, 0, 1, 1, 2, 2, 3, 3) * 2
FLEET_POLICIES = ("prefix_affinity", "least_loaded", "round_robin")
# Workers heartbeat every 50 ms; the Router judges one stale after 40 of
# them (2 s): longer than any group the survivors run between heartbeats,
# so only a worker no longer driven goes stale.
FLEET_SNAPSHOT_S, FLEET_STALE = 0.05, 40.0
FLEET_BLOCKS = 320  # serve_fleet's pool per worker: 4 x 37 prefix + 8 rows


def _fleet_traffic(cfg, system_len: int, suffix: tuple, new: int, seed: int):
    """Four ``system_len``-token system prompts and 16 requests on them in
    ``FLEET_ORDER`` (suffixes of ``suffix`` = (lo, hi) tokens, ``new`` new
    tokens, the last four top-k/top-p sampled with seeds), every one with
    ``prefix_token_ids``; returns (suffix lengths, the maker)."""
    from llmss_tpu_torch.serve.protocol import GenerateRequest

    rng = np.random.default_rng(seed)
    V = cfg.vocab_size
    systems = [[int(t) for t in rng.integers(1, V, system_len)]
               for _ in range(4)]
    sufs = [[int(t) for t in rng.integers(1, V, int(n))]
            for n in rng.integers(suffix[0], suffix[1] + 1, len(FLEET_ORDER))]

    def requests():
        return [GenerateRequest(
            id=f"f{i:02d}", token_ids=systems[s] + sufs[i],
            max_new_tokens=new, prefix_token_ids=list(systems[s]),
            **(dict(is_greedy=False, temperature=0.8, top_k=40, top_p=0.9,
                    seed=300 + i) if i >= 12 else {}))
            for i, s in enumerate(FLEET_ORDER)]

    return [len(s) for s in sufs], requests


def _fleet_plan(victim: str) -> list:
    """The passes, in order: (name, policy, chunked, the worker killed or
    None): each policy split and chunked, then a killed chunked pass under
    prefix_affinity."""
    return ([(f"{p}_{'chunked' if c else 'split'}", p, c, None)
             for p in FLEET_POLICIES for c in (False, True)]
            + [(f"prefix_affinity_chunked_{victim}_killed", "prefix_affinity",
                True, victim)])


def _fleet_pass(workers: dict, reqs: list, policy: str,
                kill: str | None = None) -> dict:
    """One pass of ``reqs`` through ``workers`` ({id: ContinuousWorker})
    under a Router of ``policy`` on a fresh InProcBroker, the workers
    driven in turns from this thread (two threads capturing or replaying
    graphs on one card could spoil a capture). Each worker starts with no
    prefix held and registers. Without ``kill`` the 16 requests are
    submitted at once. With it, the first 8; the worker ``kill`` runs one
    group and is never driven again (its heartbeat stops while it holds
    leased rows); the last 8 follow, its prefixes' ones routed to it; the
    Router's time-gated failover moves its work once its heartbeat is
    stale (the live workers beat before each judgement). The exactly-once audit is the few lines below: one answer per
    request, of all its tokens, no second answer, the broker's books
    balanced. Returns the pass's record."""
    from llmss_tpu_torch.serve.broker import InProcBroker
    from llmss_tpu_torch.serve.fleet import Router

    card = torch.device(
        next(iter(workers.values())).engine.device).type == "cuda"
    sync = torch.cuda.synchronize if card else (lambda: None)
    broker = InProcBroker()
    builds = {}
    for wid, w in workers.items():
        w._prefixes.clear()
        w.batcher._paged_evict_idle_prefixes()
        if w.batcher.allocator.blocks_in_use or not w.batcher.idle:
            raise AssertionError(f"fleet: {wid} is not idle and empty")
        n = builds[wid] = []
        build = w.engine.build_prefix
        w.engine.build_prefix = (lambda ids, n=n, build=build:
                                 n.append(len(ids)) or build(ids))
        w.broker, w.worker_id = broker, wid
        w.snapshot_interval_s, w.poll_timeout_s = FLEET_SNAPSHOT_S, 0.0
        w.register()
    router = Router(broker, policy, stale_factor=FLEET_STALE,
                    failover_check_s=0.1)
    peak = dict.fromkeys(workers, 0)
    live = dict(workers)
    answers, t_kill = {}, None

    def beat():
        # Turns stretch a live worker's heartbeat by the others' turns;
        # on a machine of its own it would beat meanwhile, so it beats
        # here before the Router judges (only a worker no longer driven
        # goes stale).
        for w in live.values():
            w._maybe_publish_load()

    sync()
    t0 = time.perf_counter()
    try:
        picks = [router.submit(r) for r in (reqs[:8] if kill else reqs)]
        if kill:
            workers[kill].run_once()
            peak[kill] = workers[kill].batcher.allocator.blocks_in_use
            del live[kill]
            t_kill = time.perf_counter()
            beat()
            if kill not in router.routable_workers():
                raise AssertionError(f"fleet: {kill} went stale before the "
                                     "second wave")
            picks += [router.submit(r) for r in reqs[8:]]
        last = time.perf_counter()
        while len(answers) < len(reqs):
            for wid, w in live.items():
                w.run_once()
                peak[wid] = max(peak[wid], w.batcher.allocator.blocks_in_use)
            if kill:
                beat()
                router.check_failover()
            n_before = len(answers)
            for r in reqs:
                if r.id not in answers:
                    a = broker.wait_response(r.id, timeout=0.0)
                    if a is not None:
                        answers[r.id] = a
            if len(answers) > n_before:
                last = time.perf_counter()
            elif time.perf_counter() - last > 120.0:
                raise AssertionError(f"fleet stalled at {len(answers)} of "
                                     f"{len(reqs)} answers")
            elif all(w.batcher.idle for w in live.values()):
                time.sleep(0.002)  # waiting for the dead worker to go stale
        for w in live.values():
            for _ in range(100):  # the group in flight at the last answer
                if w.batcher.idle:
                    break
                w.run_once()
        sync()
        t_end = time.perf_counter()
    finally:
        for w in workers.values():
            del w.engine.build_prefix
    for r in reqs:
        a = answers[r.id]
        if a.error or len(a.token_ids or []) != r.max_new_tokens:
            raise AssertionError(f"fleet {policy}: {r.id} answered {a}")
        if broker.wait_response(r.id, timeout=0.0) is not None:
            raise AssertionError(f"fleet {policy}: {r.id} answered twice")
    stats = router.stats()
    st = broker.delivery_stats()
    if (st["queue_depth"], st["inflight"], st["dlq_depth"],
            st["redelivered"], st["deadline_expired"]) != (0, 0, 0, 0, 0) or (
            st["failover_rerouted"] != stats["failover_reroutes"]):
        raise AssertionError(f"fleet {policy}: delivery {st}, {stats}")
    for wid, w in live.items():
        held = sum(len(b) for _, b in w.batcher._paged_prefixes.values())
        if not w.batcher.idle or w.batcher.allocator.blocks_in_use != held:
            raise AssertionError(f"fleet {policy}: {wid} holds "
                                 f"{w.batcher.allocator.blocks_in_use} "
                                 f"blocks once idle, its prefixes {held}")
    return {"picks": picks, "stats": stats,
            "builds": {wid: len(n) for wid, n in builds.items()},
            "tokens": {r.id: answers[r.id].token_ids for r in reqs},
            "rerouted": [r.id for r, p in zip(reqs, picks) if p == kill],
            "wall_s": t_end - t0,
            "kill_to_last_answer_s": t_end - t_kill if kill else None,
            "peak_blocks": peak, "delivery": st}


def _fleet_decisions(res: dict) -> dict:
    """What a pass's routing decided: held to the CPU's."""
    return {k: res[k] for k in ("picks", "stats", "builds", "rerouted")}


def _fleet_workers(engines: dict, chunked: int | None, **kw) -> dict:
    from llmss_tpu_torch.serve.consumer import ContinuousWorker
    from llmss_tpu_torch.serve.broker import InProcBroker

    return {wid: ContinuousWorker(eng, InProcBroker(), chunked_prefill=chunked,
                                  poll_timeout_s=0.0, **kw)
            for wid, eng in engines.items()}


def phase_reference_fleet() -> None:
    """The fleet on the tiny fp32 llama: two paged ContinuousWorkers w0 and
    w1 (each on its own engine over the same weights, 4 rows, chunk_steps
    4, group_chunks 2) under a Router, split then chunked (16): the
    serve_fleet traffic at tiny size (four 40-token system prompts, 4-12
    token suffixes, 12 new tokens) under prefix_affinity, least_loaded and
    round_robin, then with w1 killed after its first group. On the card
    and on the CPU: the card's tokens equal the CPU's for every request in
    every pass, and so do the Router's picks and stats and each worker's
    prefix builds."""
    from llmss_tpu_torch.engine.engine import DecodeEngine
    from llmss_tpu_torch.models.decoder import init_params

    cfg = _tiny_llama()
    cpu_params = init_params(cfg, seed=9, device="cpu")
    params = {"cpu": cpu_params, "cuda": _to(cpu_params, "cuda")}
    _, requests = _fleet_traffic(cfg, 40, (4, 12), 12, seed=9)
    out = {}
    for dev in ("cpu", "cuda"):
        engines = {wid: DecodeEngine(cfg, params[dev], device=dev,
                                     max_seq_len=128, kv_layout="paged",
                                     block_size=16, kv_blocks=48)
                   for wid in ("w0", "w1")}
        workers = {c: _fleet_workers(engines, 16 if c else None, rows=4,
                                     chunk_steps=4, group_chunks=2)
                   for c in (False, True)}
        for name, policy, chunked, kill in _fleet_plan("w1"):
            count = _launch_counter()
            res = _fleet_pass(workers[chunked], requests(), policy, kill)
            res["launches"] = count()
            out[dev, name] = res
    for name, policy, chunked, kill in _fleet_plan("w1"):
        got, want = out["cuda", name], out["cpu", name]
        same = (got["tokens"] == want["tokens"]
                and _fleet_decisions(got) == _fleet_decisions(want))
        emit({"phase": "reference_fleet", "pass": name,
              "identical": same, "launches": got["launches"],
              "picks": got["picks"], "builds": got["builds"],
              "failover_reroutes": got["stats"]["failover_reroutes"],
              "affinity_hit_rate": got["stats"]["affinity_hit_rate"]})
        if not same:
            raise AssertionError(f"reference_fleet {name}: card {got}, "
                                 f"CPU {want}")
        c = got["launches"]
        if not c["k3"] or not c["k4" if chunked else "k1"] or c["k2"]:
            raise AssertionError(f"reference_fleet {name}: launches {c}")


def _fleet_rehearsal() -> dict:
    """serve_fleet's passes on the CPU, on a one-layer model of the same
    vocabulary at max_seq_len 1024 with the same pools, rows and groups,
    every request greedy: the routing depends on those and on the
    traffic's lengths only. Returns {pass: decisions}."""
    from llmss_tpu_torch.engine.engine import DecodeEngine
    from llmss_tpu_torch.models.common import DecoderConfig
    from llmss_tpu_torch.models.decoder import init_params

    cfg = DecoderConfig(**{**LLAMA2_7B, "hidden_size": 64, "n_layers": 1,
                           "n_heads": 2, "n_kv_heads": 2, "head_dim": 32,
                           "rotary_dim": 32, "intermediate_size": 128,
                           "dtype": "float32"})
    p = init_params(cfg, seed=0, device="cpu")
    engines = {wid: DecodeEngine(cfg, p, device="cpu", max_seq_len=1024,
                                 kv_layout="paged", block_size=16,
                                 kv_blocks=FLEET_BLOCKS)
               for wid in ("w0", "w1")}
    workers = {c: _fleet_workers(engines, 128 if c else None, rows=8,
                                 chunk_steps=8, group_chunks=2)
               for c in (False, True)}
    _, requests = _fleet_traffic(cfg, SYSTEM_LEN, (16, 96), PREFIX_NEW, 12)

    def greedy():
        # Sampling moves no decision (with no EOS every request runs its
        # 64 tokens), and the CPU's top-p sort over 32000 logits would
        # take most of the rehearsal.
        return [dataclasses.replace(r, is_greedy=True) for r in requests()]

    return {name: _fleet_decisions(_fleet_pass(workers[chunked], greedy(),
                                               policy, kill))
            for name, policy, chunked, kill in _fleet_plan("w0")}


def phase_serve_fleet(params, smi: str) -> None:
    """The fleet at Llama-2-7B width (bf16, random weights from seed 0):
    ContinuousWorkers w0 and w1, each on its own DecodeEngine over the
    same weight tensors with a pool of FLEET_BLOCKS blocks of 16 (four
    600-token prefixes and 8 rows), 8 rows, chunk_steps 8, group_chunks 2,
    split and chunked (128), each prewarmed, heartbeating every 50 ms
    under a Router over one InProcBroker per pass, driven in turns from
    this thread. 16 requests on four 600-token system prompts (seed 12),
    four each, 16-96-token suffixes, 64 new tokens, 12 greedy and 4
    sampled, all with ``prefix_token_ids``, in the order p0 p0 p1 p1 p2
    p2 p3 p3 twice: each policy split and chunked, then prefix_affinity
    chunked with w0 stopped after its first group. Each pass: every
    request answered once, routing, builds and failover re-routes equal to
    the CPU rehearsal, the launches against the steps and prefills run
    (K1 n_layers per prefill, builds included; K3 per decode step; K4 per
    ragged step), no capture, every block back; wall, tokens/s, TTFT (from
    admission), K1 / K4 prompt tokens, builds and peak blocks per worker,
    routed_by_worker, affinity_hit_rate; the killed pass also the time
    from the kill to the last answer and the share of the re-routed
    requests' tokens equal to the unkilled pass's."""
    from llmss_tpu_torch.engine.engine import DecodeEngine
    from llmss_tpu_torch.engine.metrics import EngineMetrics, LatencyStat
    from llmss_tpu_torch.models.common import DecoderConfig

    cfg = DecoderConfig(**dict(LLAMA2_7B, n_layers=CUT_LAYERS))
    params = _first_layers(params, CUT_LAYERS)
    L = cfg.n_layers
    engines = {wid: DecodeEngine(cfg, params, max_seq_len=1024,
                                 kv_layout="paged", block_size=16,
                                 kv_blocks=FLEET_BLOCKS)
               for wid in ("w0", "w1")}
    steps = {wid: count_steps(eng) for wid, eng in engines.items()}
    prefills = []
    for eng in engines.values():
        def counted(ids, cache, lens, sa, start=None, prefill=eng._prefill):
            prefills.append(lens)
            return prefill(ids, cache, lens, sa, start)

        eng._prefill = counted
    workers = {c: _fleet_workers(engines, 128 if c else None, rows=8,
                                 chunk_steps=8, group_chunks=2)
               for c in (False, True)}
    warm = {}
    for c, ws in workers.items():
        for wid, w in ws.items():
            t = time.perf_counter()
            warm[f"{wid}_{'chunked' if c else 'split'}"] = {
                "prewarm": w.prewarm(prefix_prefill=True),
                "prewarm_s": time.perf_counter() - t}
    keys = {wid: eng._graphs.keys() for wid, eng in engines.items()}
    sufs, requests = _fleet_traffic(cfg, SYSTEM_LEN, (16, 96), PREFIX_NEW, 12)
    t = time.perf_counter()
    rehearsal = _fleet_rehearsal()
    pool = workers[False]["w0"].batcher.cache
    emit({"phase": "serve_fleet", "card": smi, "pool_blocks": FLEET_BLOCKS,
          "pool_gb_per_worker": sum(t.numel() * t.element_size()
                                    for t in (pool.k, pool.v)) / 1e9,
          "suffix_lens": sufs, "prewarm": warm,
          "rehearsal_s": time.perf_counter() - t})
    done = {}
    for name, policy, chunked, kill in _fleet_plan("w0"):
        for eng in engines.values():
            eng.metrics = EngineMetrics()
        for s in steps.values():
            s.update(decode=0, ragged=0)
        prefills.clear()
        count = _launch_counter()
        res = done[name] = _fleet_pass(workers[chunked], requests(), policy,
                                       kill)
        counts = count()
        dec = sum(s["decode"] for s in steps.values())
        rag = sum(s["ragged"] for s in steps.values())
        if counts["k2"] or counts["k1"] != L * len(prefills) or (
                counts["k3"] != L * dec) or counts["k4"] != L * rag:
            raise AssertionError(f"serve_fleet {name}: launches {counts}, "
                                 f"{dec} decode / {rag} ragged steps, "
                                 f"{len(prefills)} prefills")
        if any(eng.metrics.graph_captures for eng in engines.values()):
            raise AssertionError(f"serve_fleet {name}: a pass captured")
        if _fleet_decisions(res) != rehearsal[name]:
            raise AssertionError(f"serve_fleet {name}: routing "
                                 f"{_fleet_decisions(res)} != the CPU "
                                 f"rehearsal's {rehearsal[name]}")
        ttft = LatencyStat("ttft")
        ttft._samples = sorted(x for eng in engines.values()
                               for x in eng.metrics.ttft._samples)
        ms = [eng.metrics.to_dict() for eng in engines.values()]
        st = res["stats"]
        row = {"phase": "serve_fleet", "pass": name, "policy": policy,
               "admission": "chunked_prefill=128" if chunked else "split",
               "card": smi, "requests": len(res["tokens"]),
               "new_tokens": PREFIX_NEW, "wall_s": res["wall_s"],
               "tokens_per_s": sum(map(len, res["tokens"].values()))
               / res["wall_s"],
               "ttft_p50_ms": ttft.quantile_ms(50),
               "ttft_p90_ms": ttft.quantile_ms(90),
               "k1_prompt_tokens": sum(int(x) for lens in prefills
                                       for x in lens.tolist() if x > 1),
               "k4_prompt_tokens": sum(m["mixed_batch"][
                   "prefill_tokens_chunked"] for m in ms),
               "prefix_builds": res["builds"],
               "routed_by_worker": st["routed_by_worker"],
               "affinity_hit_rate": st["affinity_hit_rate"],
               "affinity_hits": st["affinity_hits"],
               "affinity_misses": st["affinity_misses"],
               "failover_reroutes": st["failover_reroutes"],
               "failover_rerouted": res["delivery"]["failover_rerouted"],
               "peak_blocks": res["peak_blocks"], "prefills": len(prefills),
               "decode_steps": dec, "ragged_steps": rag, "launches": counts,
               "graph_captures_after_prewarm": 0,
               "routing_equals_rehearsal": True}
        if kill:
            base = done["prefix_affinity_chunked"]["tokens"]
            moved = res["rerouted"]
            n = sum(len(base[i]) for i in moved)
            row.update(killed=kill, rerouted_requests=len(moved),
                       kill_to_last_answer_s=res["kill_to_last_answer_s"],
                       rerouted_tokens_equal_to_unkilled_share=sum(
                           a == b for i in moved
                           for a, b in zip(res["tokens"][i], base[i])) / n)
        emit(row)
    if {wid: eng._graphs.keys() for wid, eng in engines.items()} != keys:
        raise AssertionError("serve_fleet captured a graph")
    del workers, engines, pool
    gc.collect()


# -- the tiered KV store ----------------------------------------------------------


TIER_COUNTS = ("prefix_demotes", "prefix_promotes", "prefix_demote_errors",
               "sessions_parked", "sessions_resumed",
               "reprefill_tokens_avoided")


def _tiers_attach(worker, store) -> None:
    """Give ``worker`` the tiered store ``store`` (None: none) with a cold
    prefix LRU and pool registry, as a freshly built worker has."""
    bat = worker.batcher
    worker._prefixes.clear()
    bat.demote_cb = None
    if bat._paged:
        bat._paged_evict_idle_prefixes()
    worker.kvstore = store
    bat.demote_cb = worker._on_demote if store is not None else None
    bat.park_cb = worker._on_park if store is not None else None


def _tiers_counts(worker, builds: int) -> dict:
    """The lifecycle counts a pass must repeat: the store's counters, the
    pool's evictions by fate, the prefixes built, the parks dropped."""
    m = worker.engine.metrics.to_dict()
    store = worker.kvstore
    st = store.stats() if store is not None else {}
    return {**{k: st.get(k, 0) for k in TIER_COUNTS},
            "kv_evictions_demoted": m["kv_evictions_demoted"],
            "kv_evictions_dropped": m["kv_evictions_dropped"],
            "prefix_builds": builds,
            "park_failures": worker.batcher.park_failures}


def _tiers_waves(worker, waves, peak: dict) -> dict:
    """Prefix waves through ``worker``: a wave's requests are pushed
    together once the previous wave is answered and the store's queued
    demotions have landed (so a promotion never races its demotion).
    Returns {id: answer}; ``peak["blocks"]`` is the most blocks in use
    after a ``run_once``."""
    answers = {}
    for wave in waves:
        if worker.kvstore is not None:
            worker.kvstore.flush()
        for r in wave:
            worker.broker.push_request(r)
        while not all(r.id in answers for r in wave):
            worker.run_once()
            _peak_blocks(worker, peak)
            for r in wave:
                if r.id not in answers:
                    a = worker.broker.wait_response(r.id, timeout=0.0)
                    if a is not None:
                        answers[r.id] = a
    if worker.kvstore is not None:
        worker.kvstore.flush()
    return answers


def _peak_blocks(worker, peak: dict) -> None:
    if worker.batcher._paged:
        peak["blocks"] = max(peak.get("blocks", 0),
                             worker.batcher.allocator.blocks_in_use)


def _tiers_sessions(worker, first: dict, adds: dict, new: int,
                    peak: dict) -> dict:
    """Sessions through ``worker`` in rounds: every session's turn k is
    pushed together, and turn k+1 (turn k's prompt, its answer and
    ``adds[sid][k]``) once the whole round is answered, so the schedule
    is the same on every run. Returns {id: answer} (``peak`` as
    ``_tiers_waves``')."""
    from llmss_tpu_torch.serve.protocol import GenerateRequest

    prompts = {sid: list(p) for sid, p in first.items()}
    answers = {}
    for k in range(1 + max(len(a) for a in adds.values())):
        ids = [sid for sid in prompts if k <= len(adds[sid])]
        for sid in ids:
            worker.broker.push_request(GenerateRequest(
                id=f"{sid}-{k}", token_ids=prompts[sid], max_new_tokens=new,
                session_id=sid, turn=k))
        while not all(f"{sid}-{k}" in answers for sid in ids):
            worker.run_once()
            _peak_blocks(worker, peak)
            for sid in ids:
                rid = f"{sid}-{k}"
                if rid not in answers:
                    a = worker.broker.wait_response(rid, timeout=0.0)
                    if a is not None:
                        answers[rid] = a
        for sid in ids:
            a = answers[f"{sid}-{k}"]
            if k < len(adds[sid]) and not a.error:
                prompts[sid] = prompts[sid] + list(a.token_ids) + adds[sid][k]
    return answers


def _tiers_timers(worker, on: dict):
    """Time the store's steps where the serving path calls them, in ms per
    call into ``on`` ({event: [ms]}), by host clock with no sync added:
    ``demote_encode`` (the store's thread: the copy down on its stream,
    CRC and join), ``promote`` (a hit of ``fetch_prefix`` on the serving
    thread: get, CRC, unfold, the staged H2D enqueued; a miss is
    ``promote_miss``) and its ``promote_crc``, ``park_export`` (the export
    on the serving thread, which waits for the group in flight),
    ``park_hook`` (the worker's park hook on the serving thread: encode
    and store), its ``park_encode`` (CRC and join), ``resume`` (a hit:
    ``resume_session``, unfold, H2D enqueued; a miss is ``resume_miss``)
    and its ``resume_crc``, and ``build_prefix`` (its prefill enqueued,
    the segment cloned). Returns the undo."""
    import llmss_tpu_torch.engine.scheduler as sch
    import llmss_tpu_torch.serve.kvstore as kvs

    saved = []

    def patch(obj, name, event):
        fn = getattr(obj, name)
        own = name in vars(obj)

        def timed(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            ev = event(a, k, out) if callable(event) else event
            if ev:
                on.setdefault(ev, []).append((time.perf_counter() - t) * 1e3)
            return out

        saved.append((obj, name, fn, own))
        setattr(obj, name, timed)

    patch(kvs, "encode_prefix", "demote_encode")
    patch(kvs, "encode_blocks", lambda a, k, out: (
        "park_encode" if k["req_id"].startswith("sess:") else None))
    patch(kvs, "decode_blocks", lambda a, k, out: (
        "resume_crc" if out["req_id"].startswith("sess:") else "promote_crc"))
    patch(sch, "export_blocks", "park_export")
    patch(sch, "export_dense_row", "park_export")
    if worker.kvstore is not None:
        patch(worker.kvstore, "fetch_prefix", lambda a, k, out: (
            "promote" if out is not None else "promote_miss"))
    patch(worker, "_resume_session", lambda a, k, out: (
        "resume" if out is not None else "resume_miss"))
    if worker.batcher.park_cb is not None:
        patch(worker.batcher, "park_cb", "park_hook")
    patch(worker.engine, "build_prefix", "build_prefix")

    def undo():
        for obj, name, fn, own in reversed(saved):
            if own or isinstance(obj, types.ModuleType):
                setattr(obj, name, fn)
            else:
                delattr(obj, name)

    return undo


def _ms_summary(on: dict) -> dict:
    return {ev: {"n": len(v), "sum": sum(v), "median": float(np.median(v)),
                 "max": max(v)} for ev, v in sorted(on.items())}


def _tiers_reference_schedule(worker, G):
    """reference_tiers' schedule on one worker: two sessions of three
    turns (the second seeded-sampled), then five prefix requests over two
    prefixes through an LRU of one (flushed in between). Returns the
    tokens."""
    first = {"a": [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8],
             "b": [2, 7, 1, 8, 2, 8, 1, 8, 2, 8]}
    adds = {"a": [[50, 51], [60, 61, 62]], "b": [[70], [80, 81]]}
    got = _tiers_sessions(worker, first, adds, 6, {})
    pa = [7, 3, 19, 42, 5, 11, 30, 2, 9, 17, 28, 33, 21, 6, 13, 40, 8, 25]
    pb = [4, 44, 12, 90, 61, 2, 77, 15, 3, 8, 100, 23, 54, 9, 31, 70, 1, 66,
          5, 48]
    worker.max_prefixes = 1
    waves = [[G(id=f"p{i}", token_ids=p + [90 + i], max_new_tokens=6,
                prefix_token_ids=list(p))]
             for i, p in enumerate((pa, pb, pa, pb, pa))]
    got.update(_tiers_waves(worker, waves, {}))
    if any(a.error for a in got.values()):
        raise AssertionError(f"reference_tiers: an error answer {got}")
    return {rid: a.token_ids for rid, a in sorted(got.items())}


def phase_reference_tiers() -> None:
    """The tiered KV store on the tiny fp32 llama: a ContinuousWorker with
    a ``TieredKVStore`` (T1 over an InProcBlobStore) serves two sessions
    of three turns (turns 2 and 3 resume from parked KV) and five prefix
    requests through an LRU of one prefix (demote, promote; paged over a
    3-block pool, so the pool demotes too), dense (K1 + K2), paged split
    (K1 + K3) and chunked (K4 + K3), fp32 and int8, and paged with T1
    capped at 0 (every blob through T2). The card's tokens and store
    counts equal the CPU's; on fp32 the tokens also equal the card's
    without a store."""
    from llmss_tpu_torch.engine.engine import DecodeEngine
    from llmss_tpu_torch.models.decoder import init_params
    from llmss_tpu_torch.serve.broker import InProcBroker
    from llmss_tpu_torch.serve.consumer import ContinuousWorker
    from llmss_tpu_torch.serve.kvstore import (
        HostKVStore, InProcBlobStore, TieredKVStore,
    )
    from llmss_tpu_torch.serve.protocol import GenerateRequest

    cfg = _tiny_llama()
    cpu_params = init_params(cfg, seed=9, device="cpu")
    gpu_params = _to(cpu_params, "cuda")

    def run(params, device, mode, kv, store, cap=1 << 30):
        paged = mode != "dense"
        eng = DecodeEngine(cfg, params, device=device, max_seq_len=64,
                           kv_dtype=kv, **(dict(kv_layout="paged",
                                                block_size=16, kv_blocks=3)
                                           if paged else {}))
        st = (TieredKVStore(host=HostKVStore(cap_bytes=cap),
                            blob=InProcBlobStore()) if store else None)
        w = ContinuousWorker(eng, InProcBroker(), rows=2, chunk_steps=2,
                             poll_timeout_s=0.0, kvstore=st,
                             chunked_prefill=8 if mode == "chunked" else None)
        toks = _tiers_reference_schedule(w, GenerateRequest)
        counts = _tiers_counts(w, 0)
        if st is not None:
            t = st.stats()
            counts.update(t1={k: v for k, v in t["t1"].items()
                              if k != "bytes"}, t2=t["t2"])
        return toks, counts

    for mode, kv, cap in (("dense", None, None), ("dense", "int8", None),
                          ("paged", None, None), ("paged", "int8", None),
                          ("chunked", None, None), ("chunked", "int8", None),
                          ("paged", None, 0)):
        cap = 1 << 30 if cap is None else cap
        t0 = time.perf_counter()
        want, want_c = run(cpu_params, "cpu", mode, kv, True, cap)
        cpu_s = time.perf_counter() - t0
        count = _launch_counter()
        got, got_c = run(gpu_params, None, mode, kv, True, cap)
        counts = count()
        row = {"phase": "reference_tiers", "mode": mode,
               "kv": kv or "float32", "t1_cap_bytes": cap,
               "identical": got == want, "counts_equal": got_c == want_c,
               "counts": got_c, "launches": counts}
        if kv is None:
            plain, _ = run(gpu_params, None, mode, kv, False)
            row["equal_to_no_store"] = got == plain
        row["seconds"] = time.perf_counter() - t0
        row["cpu_seconds"] = cpu_s
        emit({**row, "tokens": got})
        if got != want or got_c != want_c:
            raise AssertionError(f"tiers {mode} {kv}: card {got} {got_c} != "
                                 f"CPU {want} {want_c}")
        if not row.get("equal_to_no_store", True):
            raise AssertionError(f"tiers {mode}: tokens != no-store tokens")
        if got_c["prefix_demote_errors"] or got_c["park_failures"] or not (
                got_c["sessions_resumed"] and got_c["prefix_promotes"]):
            raise AssertionError(f"tiers {mode} {kv}: counts {got_c}")
        used = ("k1", "k2") if mode == "dense" else (
            ("k4", "k3") if mode == "chunked" else ("k1", "k3"))
        if not all(counts[k] for k in used):
            raise AssertionError(f"tiers {mode} {kv}: launches {counts}")


TIERS_NEW = 32  # new tokens per serve_tiers request


def _tiers_traffic(cfg):
    """serve_tiers' traffic (seed 14): four 600-token system prompts, and
    per wave two requests on one of them with 16-48-token suffixes, the
    waves on prompts 0 1 2 3 0 1 2 3; four sessions whose turns add
    100-300 tokens. Returns (make_waves(order), first turns, adds)."""
    from llmss_tpu_torch.serve.protocol import GenerateRequest

    rng = np.random.default_rng(14)
    V = cfg.vocab_size

    def toks(n):
        return [int(t) for t in rng.integers(1, V, n)]

    systems = [toks(SYSTEM_LEN) for _ in range(4)]
    sufs = [[toks(int(n)) for n in rng.integers(16, 49, 2)] for _ in range(8)]

    def waves(order=(0, 1, 2, 3, 0, 1, 2, 3)):
        return [[GenerateRequest(id=f"w{j}r{i}", token_ids=systems[s] + suf,
                                 max_new_tokens=TIERS_NEW,
                                 prefix_token_ids=list(systems[s]))
                 for i, suf in enumerate(sufs[j])]
                for j, s in enumerate(order)]

    first = {f"s{i}": toks(int(rng.integers(100, 301))) for i in range(4)}
    adds = {sid: [toks(int(n)) for n in rng.integers(100, 301, 2)]
            for sid in first}
    return waves, first, adds


def _tiers_plan():
    """serve_tiers' passes, in order: (name, part, worker, T1 cap or None
    for no store, the earlier pass whose blob store it shares or None)."""
    return [("prefix_no_store", "prefix", "split", None, None),
            ("prefix_t1_1GiB", "prefix", "split", 1 << 30, None),
            ("prefix_t1_0", "prefix", "split", 0, None),
            ("prefix_second_worker", "prefix", "chunked", 1 << 30,
             "prefix_t1_0"),
            ("sessions_no_store", "sessions", "split", None, None),
            ("sessions_t1_1GiB", "sessions", "split", 1 << 30, None),
            ("sessions_t1_1GiB_chunked", "sessions", "chunked", 1 << 30,
             None)]


def _tiers_passes(workers, traffic):
    """Yield each pass of ``_tiers_plan`` as (name, part, worker, T1 cap,
    blob store, second), the blob store fresh or shared as planned."""
    from llmss_tpu_torch.serve.kvstore import InProcBlobStore

    blobs = {}
    for name, part, wname, cap, shared in _tiers_plan():
        blob = blobs[shared] if shared else InProcBlobStore()
        if name == "prefix_t1_0":
            blobs[name] = blob
        yield name, part, workers[wname], cap, blob, shared is not None


def _tiers_pass(w, part, cap, blob, traffic, second: bool, peak: dict,
                on: dict | None = None):
    """One serve_tiers pass on worker ``w``: attached to a store of T1 cap
    ``cap`` over ``blob`` (no store when ``cap`` is None), its metrics
    reset, the pass's traffic driven (a ``second`` worker's prefix pass:
    the first round of waves only). Returns (answers, counts)."""
    from llmss_tpu_torch.engine.metrics import EngineMetrics
    from llmss_tpu_torch.serve.kvstore import HostKVStore, TieredKVStore

    store = None
    if cap is not None:
        store = TieredKVStore(host=HostKVStore(cap_bytes=cap), blob=blob)
    _tiers_attach(w, store)
    w.batcher.park_failures = 0
    w.engine.metrics = EngineMetrics()
    builds = []
    build = w.engine.build_prefix
    w.engine.build_prefix = lambda ids: builds.append(len(ids)) or build(ids)
    undo = _tiers_timers(w, on) if on is not None else (lambda: None)
    waves, first, adds = traffic
    try:
        if part == "prefix":
            answers = _tiers_waves(w, waves((0, 1, 2, 3) if second else (
                0, 1, 2, 3, 0, 1, 2, 3)), peak)
        else:
            answers = _tiers_sessions(w, first, adds, TIERS_NEW, peak)
    finally:
        undo()
        del w.engine.build_prefix
    return answers, _tiers_counts(w, len(builds))


def _tiers_workers(eng):
    """A split and a chunked (128) ContinuousWorker on ``eng``: 8 rows,
    chunk_steps 8, group_chunks 2, a prefix LRU of two, no idle poll."""
    from llmss_tpu_torch.serve.broker import InProcBroker
    from llmss_tpu_torch.serve.consumer import ContinuousWorker

    out = {}
    for wname, cp in (("split", None), ("chunked", 128)):
        w = out[wname] = ContinuousWorker(
            eng, InProcBroker(), rows=8, chunk_steps=8, group_chunks=2,
            chunked_prefill=cp, poll_timeout_s=0.0)
        w.max_prefixes = 2
    return out


def _tiers_rehearsal():
    """serve_tiers' passes on the CPU, on a one-layer model of the same
    vocabulary at max_seq_len 1024 with the same pool, rows, groups and
    LRU: the counts depend on those and on the traffic's lengths only.
    Returns {pass: counts}."""
    from llmss_tpu_torch.engine.engine import DecodeEngine
    from llmss_tpu_torch.models.common import DecoderConfig
    from llmss_tpu_torch.models.decoder import init_params

    cfg = DecoderConfig(**{**LLAMA2_7B, "hidden_size": 64, "n_layers": 1,
                           "n_heads": 2, "n_kv_heads": 2, "head_dim": 32,
                           "rotary_dim": 32, "intermediate_size": 128,
                           "dtype": "float32"})
    eng = DecodeEngine(cfg, init_params(cfg, seed=0, device="cpu"),
                       device="cpu", max_seq_len=1024, kv_layout="paged",
                       block_size=16, kv_blocks=256)
    workers = _tiers_workers(eng)
    traffic = _tiers_traffic(cfg)
    return {name: _tiers_pass(w, part, cap, blob, traffic, second, {})[1]
            for name, part, w, cap, blob, second in _tiers_passes(workers,
                                                                  traffic)}


def _promote_vs_build(eng) -> dict:
    """Promotion against rebuilding at Llama-2-7B width on an idle card:
    per prefix length (random tokens, seed 15), ``build_prefix`` (the
    prefill and the segment's clone), the demotion's encode on the store's
    thread, and ``fetch_prefix`` from T1 (get, CRC, unfold, H2D), each
    between device syncs, best of 3, with the CRC alone beside it; the
    promoted prefix must equal the built one bit for bit. The break-even
    length is where promotion stops being faster: interpolated linearly
    between the last measured length at which it is faster and the next
    (None when it is faster or slower at every length)."""
    from llmss_tpu_torch.serve.handoff import decode_blocks
    from llmss_tpu_torch.serve.kvstore import (
        HostKVStore, TieredKVStore, prefix_key,
    )

    rng = np.random.default_rng(15)
    rows = []
    for n in (64, 128, 256, 512, 600, 900):
        toks = [int(t) for t in rng.integers(1, eng.cfg.vocab_size, n)]
        store = TieredKVStore(host=HostKVStore(cap_bytes=4 << 30))
        t = {"build": [], "demote": [], "promote": [], "crc": []}
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pfx = eng.build_prefix(toks)
            torch.cuda.synchronize()
            t["build"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            store.demote_prefix(pfx, eng.block_size)
            store.flush()
            t["demote"].append(time.perf_counter() - t0)
            payload = store.host.get(prefix_key(toks))
            t0 = time.perf_counter()
            decode_blocks(payload)
            t["crc"].append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = store.fetch_prefix(toks, max_seq_len=eng.max_seq_len,
                                     device=eng.device)
            torch.cuda.synchronize()
            t["promote"].append(time.perf_counter() - t0)
        if store.stats()["prefix_demote_errors"] or got is None or any(
                not torch.equal(getattr(got, a)[:, :n], getattr(pfx, a)[:, :n])
                or getattr(got, a).shape != getattr(pfx, a).shape
                for a in ("k", "v")):
            raise AssertionError(f"promote_vs_build {n}: the promoted prefix "
                                 "differs from the built one")
        rows.append({"tokens": n, "blob_bytes": len(payload),
                     **{f"{k}_ms": min(v) * 1e3 for k, v in t.items()}})
        del pfx, got, store
    even = None
    for a, b in zip(rows, rows[1:]):
        da = a["build_ms"] - a["promote_ms"]
        db = b["build_ms"] - b["promote_ms"]
        if da > 0 >= db:
            even = a["tokens"] + (b["tokens"] - a["tokens"]) * da / (da - db)
    return {"rows": rows, "break_even_tokens": even}


def phase_serve_tiers() -> None:
    """The tiered KV store at Llama-2-7B width and ``CUT_LAYERS`` deep
    on an engine of serve_continuous's seed (0) and settings (bf16, max_seq_len
    1024, 256 blocks of 16), ContinuousWorkers of 8
    rows, chunk_steps 8, group_chunks 2, a prefix LRU of two, prewarmed.
    (a) Prefix tiers: waves of two requests on four 600-token system
    prompts (32 new tokens), prompts 0-3 then 0-3 again, so the LRU and
    the pool demote each prompt and the second round promotes it: with no
    store, T1 at 1 GiB over an InProcBlobStore, T1 capped at 0 (every
    promotion from T2), then the chunked worker as a second worker over
    the cap-0 pass's blob store, promoting each prompt without building.
    (b) Sessions: four sessions of three turns (100-300 new prompt tokens
    a turn, 32 out), turns 2 and 3 resumed from parked KV: no store, T1 at
    1 GiB split, and chunked. Per pass: wall, tokens/s, TTFT, prompt
    tokens K1 / K4 computed, peak blocks and device memory, the store's
    stats, per-event ms (``_tiers_timers``), launches, the share of tokens
    equal to the no-store pass's; the counts equal a CPU rehearsal, no
    demote error, no park dropped, no capture after prewarm. Then
    promotion against rebuilding by prefix length."""
    from llmss_tpu_torch.engine.engine import DecodeEngine
    from llmss_tpu_torch.models.common import DecoderConfig
    from llmss_tpu_torch.models.decoder import init_params

    t_phase = t = time.perf_counter()
    rehearsal = _tiers_rehearsal()
    rehearsal_s = time.perf_counter() - t
    cfg = DecoderConfig(**dict(LLAMA2_7B, n_layers=CUT_LAYERS))
    eng = DecodeEngine(cfg, init_params(cfg, seed=0), max_seq_len=1024,
                       kv_layout="paged", block_size=16, kv_blocks=256)
    prefills = []
    prefill = eng._prefill

    def counted_prefill(ids, cache, lens, sa, start=None):
        prefills.append(lens)
        return prefill(ids, cache, lens, sa, start)

    eng._prefill = counted_prefill
    workers = _tiers_workers(eng)
    warm = {}
    for wname, w in workers.items():
        t = time.perf_counter()
        warm[wname] = {"prewarm": w.prewarm(prefix_prefill=True),
                       "prewarm_s": time.perf_counter() - t}
    keys = eng._graphs.keys()
    traffic = _tiers_traffic(eng.cfg)
    emit({"phase": "serve_tiers", "prewarm": warm,
          "rehearsal_s": rehearsal_s, "system_prompt_tokens": SYSTEM_LEN,
          "session_turn_lens": {sid: [len(traffic[1][sid])]
                                + [len(a) for a in traffic[2][sid]]
                                for sid in traffic[1]}})
    plain = {}
    for name, part, w, cap, blob, second in _tiers_passes(workers, traffic):
        on, peak = {}, {}
        bat = w.batcher
        prefills.clear()
        count = _launch_counter()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        answers, counts = _tiers_pass(w, part, cap, blob, traffic, second,
                                      peak, on)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = count()
        toks = {rid: a.token_ids or [] for rid, a in answers.items()}
        for rid, a in answers.items():
            if a.error or len(toks[rid]) != TIERS_NEW:
                raise AssertionError(f"serve_tiers {name} {rid}: bad answer "
                                     f"{a}")
        m = eng.metrics.to_dict()
        if part not in plain:
            plain[part] = toks
        ref = plain[part]
        same = [x == y for rid in toks if rid in ref
                for x, y in zip(toks[rid], ref[rid])]
        row = {"phase": "serve_tiers", "pass": name, "part": part,
               "admission": ("split" if bat.chunked_prefill is None
                             else f"chunked_prefill={bat.chunked_prefill}"),
               "t1_cap_bytes": cap, "requests": len(answers),
               "new_tokens": TIERS_NEW, "wall_s": wall,
               "tokens_per_s": sum(map(len, toks.values())) / wall,
               "ttft_p50_ms": eng.metrics.ttft.quantile_ms(50),
               "ttft_p90_ms": eng.metrics.ttft.quantile_ms(90),
               "k1_prompt_tokens": sum(int(x) for lens in prefills
                                       for x in lens.tolist() if x > 1),
               "k4_prompt_tokens": m["mixed_batch"]["prefill_tokens_chunked"],
               "peak_blocks_in_use": peak.get("blocks"),
               "peak_device_bytes": torch.cuda.max_memory_allocated(),
               "launches": launches,
               "counts": counts, "rehearsal_counts": rehearsal[name],
               "kv_tiers": w.kvstore.stats() if w.kvstore else None,
               "events_ms": _ms_summary(on),
               "tokens_equal_to_no_store_share": (sum(same) / len(same)
                                                  if same else None),
               "graph_captures_after_prewarm": eng.metrics.graph_captures}
        emit(row)
        if counts != rehearsal[name]:
            raise AssertionError(f"serve_tiers {name}: counts {counts} != "
                                 f"the rehearsal's {rehearsal[name]}")
        if counts["prefix_demote_errors"] or counts["park_failures"]:
            raise AssertionError(f"serve_tiers {name}: {counts}")
        if eng.metrics.graph_captures or eng._graphs.keys() != keys:
            raise AssertionError(f"serve_tiers {name}: a pass captured a "
                                 "graph")
        used = ("k4", "k3") if bat.chunked_prefill else ("k1", "k3")
        if not all(launches[k] for k in used):
            raise AssertionError(f"serve_tiers {name}: launches {launches}")
    for w in workers.values():
        _tiers_attach(w, None)
    del eng._prefill, workers, w, bat
    gc.collect()
    t = time.perf_counter()
    row = _promote_vs_build(eng)
    emit({"phase": "serve_tiers", "check": "promote_vs_build", **row,
          "seconds": time.perf_counter() - t,
          "phase_seconds": time.perf_counter() - t_phase})
    del eng
    gc.collect()
    torch.cuda.empty_cache()


def _agreement(got: list, want: list) -> dict:
    """How far two greedy decodes of the same prompts agree: per row the
    tokens before the first difference; their mean and least, and the
    share of rows equal throughout."""
    spans = []
    for g, w in zip(got, want):
        n = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                 min(len(g), len(w)))
        spans.append(n)
    return {"agree_mean": sum(spans) / len(spans), "agree_min": min(spans),
            "rows_equal_share": sum(g == w for g, w in zip(got, want))
            / len(got)}


def phase_reference_speculative() -> None:
    """Prompt-lookup speculative decoding on the tiny fp32 models (ring
    64, gamma 1 and 4, one call of four rows: repetitive, random, a short
    one, one near the ring's end that finishes on the plain tail; EOS a
    token the repetitive row emits mid-generation): the card's tokens
    equal the CPU's plain speculative tokens and the card's ``generate``
    tokens, and ``spec_stats`` equal the CPU's. The llama verifies through
    K2w; the same llama over an int8 cache and a tiny Mistral with a
    sliding window take the general path (K1), as in the reference."""
    from llmss_tpu_torch.engine.engine import DecodeEngine, GenerationParams
    from llmss_tpu_torch.models.decoder import init_params
    from llmss_tpu_torch.ops import decode_attention as da
    from llmss_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(4)
    prompts = [[7, 3, 9, 11] * 5, [int(t) for t in rng.integers(1, 512, 20)],
               [5], [int(t) for t in rng.integers(1, 512, 40)]]
    for name, cfg, kv in (("llama", _tiny_llama(), None),
                          ("llama", _tiny_llama(), "int8"),
                          ("mistral", _family_configs()["mistral"], None)):
        cpu_params = init_params(cfg, seed=3, device="cpu")
        cpu = DecodeEngine(cfg, cpu_params, device="cpu", max_seq_len=64,
                           kv_dtype=kv)
        # EOS: a token the first row emits mid-generation, not before.
        row0 = cpu.generate(prompts, GenerationParams(max_new_tokens=20))[0]
        eos = next((t for i, t in enumerate(row0) if i >= 6
                    and t not in row0[:i]), row0[-1])
        gen = GenerationParams(max_new_tokens=20, eos_token_id=eos)
        eng = DecodeEngine(cfg, _to(cpu_params, "cuda"), max_seq_len=64,
                           kv_dtype=kv)
        eng.prewarm(len(prompts), speculative=(1, 4))
        keys = eng._graphs.keys()
        for gamma in (1, 4):
            want = cpu.generate_speculative(prompts, gen, gamma=gamma)
            want_stats = cpu.metrics.spec_stats
            fa.flash_attention.launches = 0
            da.decode_window_attention.launches = 0
            got = eng.generate_speculative(prompts, gen, gamma=gamma)
            stats = eng.metrics.spec_stats
            k1 = fa.flash_attention.launches
            k2w = da.decode_window_attention.launches
            plain = eng.generate(prompts, gen)
            L = cfg.n_layers
            general = kv is not None or cfg.sliding_window is not None
            emit({"phase": "reference_speculative", "model": name,
                  "kv": kv or "float32", "gamma": gamma,
                  "equals_cpu": got == want, "equals_generate": got == plain,
                  "stats_equal_cpu": stats == want_stats, "spec_stats": stats,
                  "k2w_launches": k2w, "k1_launches": k1, "tokens": got})
            if got != want or got != plain or stats != want_stats:
                raise AssertionError(
                    f"reference_speculative {name} {kv} gamma {gamma}: card "
                    f"{got} / {stats}, CPU {want} / {want_stats}, card "
                    f"generate {plain}")
            verifies = stats["verify_forwards"]
            if not verifies or k2w != (0 if general else L * verifies) or \
                    k1 != L * (1 + (verifies if general else 0)):
                raise AssertionError(
                    f"reference_speculative {name} {kv}: {verifies} verify "
                    f"forwards, K2w {k2w}, K1 {k1} launches")
            if eng._graphs.keys() != keys:
                raise AssertionError(f"reference_speculative {name} {kv}: "
                                     "a capture after prewarm")
    # Nothing prewarmed: the rows cross from the 32-slot bucket to the
    # whole ring after a full group, so a step graph is captured between
    # groups, its warm-up run recording at step 0 of the next group.
    cfg = _tiny_llama()
    cpu_params = init_params(cfg, seed=3, device="cpu")
    cpu = DecodeEngine(cfg, cpu_params, device="cpu", max_seq_len=64)
    eng = DecodeEngine(cfg, _to(cpu_params, "cuda"), max_seq_len=64)
    mid, gen = [[7, 3, 9] * 3, [5, 2]], GenerationParams(max_new_tokens=40)
    got = eng.generate_speculative(mid, gen, gamma=1)
    buckets = [str(k[-1]) for k in eng._graphs.keys() if k[-5] == "spec"]
    want = cpu.generate_speculative(mid, gen, gamma=1)
    plain = eng.generate(mid, gen)
    emit({"phase": "reference_speculative", "model": "llama",
          "prewarmed": False, "spec_buckets_captured": sorted(buckets),
          "equals_cpu": got == want, "equals_generate": got == plain,
          "spec_stats": eng.metrics.spec_stats})
    if len(buckets) < 2 or got != want or got != plain:
        raise AssertionError(f"reference_speculative, captures between "
                             f"groups {buckets}: card {got}, CPU {want}, "
                             f"card generate {plain}")


def phase_speculative(kernels: dict) -> None:
    """Speculative decoding at Llama-2-7B width (the engine phase's random
    bf16 weights, made again from its seed): 16 prompts of 128 tokens, 256
    new tokens each, ring
    1024, chunk_steps 8. ``prewarm(speculative=(1, 4))`` captures every
    graph the calls run (0 captures after it, asserted); then plain greedy
    ``generate`` and ``generate_speculative`` at gamma 1 and 4: tokens/s,
    mean tokens per verify forward per row, the agreement span with
    ``generate``, K2w launches (n_layers per verify forward), and one
    verify step's kernel time against one decode step's, each a graph
    replay in the 384-slot bucket, with K2w's launches per group read from
    the step graph's kernel nodes."""
    from llmss_tpu_torch.engine.engine import DecodeEngine, GenerationParams
    from llmss_tpu_torch.models.common import DecoderConfig
    from llmss_tpu_torch.models.decoder import init_params
    from llmss_tpu_torch.ops import decode_attention as da
    from llmss_tpu_torch.ops import flash_attention as fa

    cfg = DecoderConfig(**dict(LLAMA2_7B, n_layers=CUT_LAYERS))
    L, B, chunk = cfg.n_layers, SPEC_BATCH, 8
    eng = DecodeEngine(cfg, init_params(cfg, seed=0), max_seq_len=1024)
    rng = np.random.default_rng(21)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, SPEC_PROMPT)]
               for _ in range(B)]
    t = time.perf_counter()
    warmed = eng.prewarm(B, chunk_steps=chunk, speculative=(1, 4))
    prewarm_s = time.perf_counter() - t
    keys = eng._graphs.keys()
    mem = _graph_memory(eng, [eng._cache])
    gen = GenerationParams(max_new_tokens=SPEC_NEW)

    def timed_call(call):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    plain, wall_plain = timed_call(
        lambda: eng.generate(prompts, gen, chunk_steps=chunk))
    rows = []
    for gamma in (1, 4):
        fa.flash_attention.launches = 0
        da.decode_attention.launches = 0
        da.decode_window_attention.launches = 0
        spec, wall = timed_call(lambda: eng.generate_speculative(
            prompts, gen, gamma=gamma, chunk_steps=chunk))
        st = eng.metrics.spec_stats
        k2w = da.decode_window_attention.launches
        if k2w != L * st["verify_forwards"] or not k2w:
            raise AssertionError(f"speculative gamma {gamma}: K2w {k2w} "
                                 f"launches, {st['verify_forwards']} verifies")
        for row in spec:
            if len(row) != SPEC_NEW or not all(0 <= x < cfg.vocab_size
                                               for x in row):
                raise AssertionError("speculative tokens outside the vocab "
                                     "or of the wrong length")
        if gamma == 4:
            kernels["K2w"]["launches"] = k2w
        rows.append({"phase": "speculative", "gamma": gamma,
                     "tokens_per_s": B * SPEC_NEW / wall, "wall_s": wall,
                     "spec_stats": st, "k2w_launches": k2w,
                     "k1_launches": fa.flash_attention.launches,
                     "k2_launches_tail": da.decode_attention.launches,
                     **_agreement(spec, plain)})
    captured = len(eng._graphs.keys() - keys)
    if captured:
        raise AssertionError(f"speculative: {captured} captures after prewarm")

    # One verify step (gamma 4) and one decode step, each a replay of its
    # prewarmed graph in the 384-slot bucket, from live rows at 300.
    g = eng._graphs.for_cache(eng._cache)
    bufs = g.spec_buffers(5, chunk, eng.max_seq_len)
    step = eng._spec_step(eng._cache, bufs, 4, 3, SPEC_BUCKET)
    node_k2w = dict(g.steps[("spec", 4, 3, chunk, SPEC_BUCKET)]._launches)[
        da.decode_window_attention]

    def verify():
        bufs.hist_len.fill_(300)
        bufs.done.zero_()
        bufs.step.zero_()
        step()

    sa = eng._sample_args(gen, B)
    tok = torch.ones(B, dtype=torch.int32, device="cuda")
    cur = torch.full((B,), 300, dtype=torch.int32, device="cuda")
    done = torch.zeros(B, dtype=torch.bool, device="cuda")
    eos = torch.full((B,), -1, dtype=torch.int32, device="cuda")
    count = ("window_mma", "window_fwd", "decode_fwd")
    v_row, _ = _profile_row("speculative_verify_step", verify,
                            path="graph", count=count)
    d_row, _ = _profile_row(
        "speculative_decode_step",
        lambda: eng._decode_group(tok, eng._cache, cur, sa, done, eos,
                                  n_steps=1, t_bucket=SPEC_BUCKET),
        path="graph", count=count)
    if len(eng._graphs.keys() - keys):
        raise AssertionError("speculative: the profiled steps captured")
    for row, want in ((v_row, {"decode_window_attention": L}),
                      (d_row, {"decode_attention": L})):
        if row["launches"] != want:
            raise AssertionError(f"speculative {row['what']}: launched "
                                 f"{row['launches']}, want {want}")
    emit({"phase": "speculative", "model": "llama-2-7b dims, random init "
          "(seed 0)", "batch": B, "prompt_len": SPEC_PROMPT,
          "new_tokens": SPEC_NEW, "chunk_steps": chunk, "prewarm": warmed,
          "prewarm_s": prewarm_s, **mem,
          "graph_captures_after_prewarm": captured,
          "plain_tokens_per_s": B * SPEC_NEW / wall_plain,
          "plain_wall_s": wall_plain,
          "verify_step_kernel_ms": v_row["device_kernel_ms"],
          "decode_step_kernel_ms": d_row["device_kernel_ms"],
          "verify_over_decode": v_row["device_kernel_ms"]
          / d_row["device_kernel_ms"],
          "k2w_launches_per_step_graph": node_k2w,
          "k2w_launches_per_group": node_k2w * chunk,
          "runs": rows})
    for row in rows:
        emit(row)


def phase_profile_paged(eng, tag: str = "") -> None:
    """Where the time goes on the serving path: one paged decode group
    (2 chunks x 8 steps) by graph replays and eagerly, and one ragged group
    (4 steps, two rows feeding 128-token chunks beside six decode rows,
    eager) over 8 rows of the serve engine. The ragged group must launch
    K4 n_layers times a step and nothing else its wrappers count, on the
    tensor-core tile: ``paged_mma`` over bf16, over an int8 pool (rows
    named ``tag`` first) its int8 instantiation (``"mma_int8"``)."""
    from llmss_tpu_torch.engine.engine import GenerationParams
    from llmss_tpu_torch.ops import paged_attention as pa

    B = 8
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, 32000, n)]
               for n in (300, 45, 700, 128, 33, 560, 400, 200)]
    ids, lens = eng._pad_prompts(prompts)
    sa = eng._sample_args(GenerationParams(), B)
    cache = eng.new_cache(B)  # identity tables over a full pool
    dev = "cuda"
    cur = torch.as_tensor(lens, device=dev)
    tok, _ = eng._prefill(torch.as_tensor(ids, device=dev), cache, cur, sa)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    eos = torch.full((B,), -1, dtype=torch.int32, device=dev)
    _graph_vs_eager(eng, tag + "paged_decode_group_2x8", tok, cache, cur, sa,
                    done, eos, n_chunks=2, n_steps=8,
                    t_bucket=eng.decode_bucket(int(lens.max()) + 16))
    nc, CB = 4, 128
    qlens = np.ones((nc, B), np.int32)
    qlens[:, :2] = CB
    feed = np.zeros((nc, B), bool)
    feed[:, :2] = True
    emit_ = ~feed
    xs = [torch.as_tensor(a, device=dev) for a in (
        rng.integers(1, 32000, (nc, B, CB)).astype(np.int32), qlens, feed,
        emit_)]
    count = ("paged_fwd", "paged_mma", "int8:paged_mma")
    row, _ = _profile_row(
        tag + "ragged_group_4_steps",
        lambda: eng._ragged_group(tok, cache, cur, sa, done, eos, *xs),
        count=count)
    cfg = eng.cfg
    impl = pa.kernel_plan(cfg.torch_dtype, CB, cfg.n_heads // cfg.n_kv_heads,
                          cfg.head_dim, kv_dtype=cache.k.dtype).impl
    want = {"ragged_paged_attention": cfg.n_layers * nc}
    want_impl = "mma_int8" if cache.quantized else "mma"
    if row["launches"] != want or impl != want_impl:
        raise AssertionError(f"{tag}ragged group: {row['launches']} on "
                             f"{impl}, want {want} on {want_impl}")


# -- phase 6c ------------------------------------------------------------------


def phase_int8(params, kernels: dict, bf16: dict) -> None:
    """The int8 KV cache at Llama-2-7B width (the same random bf16 weights):
    dense ``generate`` at batch 4 (prompts 128/100/77/128, 64 new tokens,
    ring 1024, chunk_steps 8, one sampled row) after ``prewarm``, one
    8-step decode chunk profiled by graph and eagerly (int8 ``decode_fwd``
    only), then one chunked serving pass (chunked_prefill=128) of the
    serve_continuous requests over a 496-block int8 pool, about the bytes
    of that phase's 256-block bf16 pool. Launch counts: K1 and K2 in the
    generate, K3 and K4 in the pass, all over the int8 instantiations; the
    dense cache's bytes against the bf16 engine's, and the share of tokens
    equal to the bf16 runs' (``bf16``: the engine phase's chunk-8 tokens and
    cache bytes, the serve phase's chunked tokens)."""
    from llmss_tpu_torch.engine.engine import DecodeEngine, GenerationParams
    from llmss_tpu_torch.engine.metrics import EngineMetrics
    from llmss_tpu_torch.models.common import DecoderConfig
    from llmss_tpu_torch.ops import decode_attention as da
    from llmss_tpu_torch.ops import flash_attention as fa
    from llmss_tpu_torch.serve.broker import InProcBroker
    from llmss_tpu_torch.serve.consumer import ContinuousWorker

    cfg = DecoderConfig(**LLAMA2_7B)
    L, B, new = cfg.n_layers, 4, 64
    eng = DecodeEngine(cfg, params, batch_size=B, max_seq_len=1024,
                       kv_dtype="int8")
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)]
               for n in ENGINE_LENS]
    t = time.perf_counter()
    warmed = eng.prewarm(B, chunk_steps=8)
    prewarm_s = time.perf_counter() - t
    keys = eng._graphs.keys()
    mem = _graph_memory(eng, [eng._cache])
    ratio = mem["cache_bytes"] / bf16["cache_bytes"]
    sampled = GenerationParams(max_new_tokens=new, is_greedy=False,
                               temperature=0.8, top_k=40, top_p=0.9,
                               seed=1234)
    gens = [GenerationParams(max_new_tokens=new)] * 3 + [sampled]
    eng.metrics = EngineMetrics()
    fa.flash_attention.launches = da.decode_attention.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    toks = eng.generate(prompts, gens, chunk_steps=8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    k1, k2 = fa.flash_attention.launches, da.decode_attention.launches
    steps = math.ceil((new - 1) / 8) * 8
    if k1 != L or k2 != L * steps:
        raise AssertionError(f"int8 launch counts K1={k1}, K2={k2}")
    for row in toks:
        if len(row) != new or not all(0 <= x < cfg.vocab_size for x in row):
            raise AssertionError("int8 tokens outside the vocab or wrong length")
    equal = sum(x == y for a, b in zip(toks, bf16["tokens"])
                for x, y in zip(a, b)) / (B * new)
    m = eng.metrics
    captured = len(eng._graphs.keys() - keys)
    # The prefill profiled (eager: a dequantized copy of each layer, K1,
    # then the quantizing writes), then one decode chunk, graph and eager,
    # from the same state over a cache of its own (whose graphs this
    # captures): its step graph's decode nodes must all be int8
    # decode_fwd instantiations.
    ids, lens = eng._pad_prompts(prompts)
    sa = eng._sample_args(GenerationParams(), B)
    ids_d = torch.as_tensor(ids, device="cuda")
    lens_d = torch.as_tensor(lens, device="cuda")
    cache = eng.new_cache(B)

    def prefill():
        cache.positions.fill_(-1)
        return eng._prefill(ids_d, cache, lens_d, sa)[0]

    _profile_row("int8_prefill", prefill)
    tok = prefill()
    _graph_vs_eager(eng, "int8_decode_chunk8", tok, cache, lens_d, sa,
                    torch.zeros(B, dtype=torch.bool, device="cuda"),
                    torch.full((B,), -1, dtype=torch.int32, device="cuda"),
                    n_chunks=1, n_steps=8,
                    t_bucket=eng.decode_bucket(int(lens.max()) + 8))
    del cache
    emit({"phase": "int8", "path": "generate", "kv_dtype": "int8",
          "batch": B, "prompt_lens": ENGINE_LENS, "new_tokens": new,
          "prewarm": warmed, "prewarm_s": prewarm_s, **mem,
          "cache_bytes_bf16": bf16["cache_bytes"],
          "cache_bytes_over_bf16": ratio, "ttft_ms": m.ttft.last_s * 1e3,
          "decode_ms_per_step_chunk8": m.decode_step.to_dict()["mean_ms"],
          "tokens_per_s_chunk8_one_sampled_row": B * new / wall,
          "k1_launches": k1, "k2_launches": k2,
          "graph_captures_after_prewarm": captured,
          "graph_replays": m.graph_replays,
          "tokens_equal_to_bf16_share": equal})
    if captured:
        raise AssertionError(f"{captured} int8 graph captures after prewarm")
    if not ratio <= 0.52:
        raise AssertionError(f"int8 cache is {ratio:.4f} of the bf16 cache")
    kernels["K2_int8"]["launches"] = k2
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    peng = DecodeEngine(cfg, params, max_seq_len=1024, kv_layout="paged",
                        block_size=16, kv_blocks=496, kv_dtype="int8")
    steps = count_steps(peng)
    _, requests = _serve_requests(cfg)
    worker = ContinuousWorker(peng, InProcBroker(), rows=8, chunk_steps=8,
                              group_chunks=2, chunked_prefill=128)
    t = time.perf_counter()
    warm = {"prewarm": worker.prewarm(), "prewarm_s": time.perf_counter() - t}
    keys = peng._graphs.keys()
    pool = _graph_memory(peng, [worker.batcher.cache])
    row, stoks, counts = _serve_pass(peng, worker, requests, steps, warm)
    served = [i for i in range(len(stoks)) if i != SERVE_CANCEL]
    equal = (sum(x == y for i in served
                 for x, y in zip(stoks[i], bf16["serve_tokens"][i]))
             / sum(len(stoks[i]) for i in served))
    row.update(phase="int8", path="serve_continuous", kv_dtype="int8",
               kv_blocks=496, pool_bytes=pool["cache_bytes"],
               tokens_equal_to_bf16_share=equal)
    emit(row)
    if peng._graphs.keys() != keys:
        raise AssertionError("the int8 serving pass captured a graph")
    kernels["K3_int8"]["launches"] = counts["k3"]
    kernels["K4_int8"]["launches"] = counts["k4"]
    del worker
    gc.collect()
    phase_profile_paged(peng, "int8_")


# -- phase 6d ------------------------------------------------------------------


# The published configs of the two families the reference system served
# (SURVEY: custom_modeling/__init__.py), as their config.json give them
# (keys that do not shape the model left out).
GPTJ_6B_HF = {  # EleutherAI/gpt-j-6b config.json
    "model_type": "gptj", "n_embd": 4096, "n_layer": 28, "n_head": 16,
    "rotary_dim": 64, "n_inner": None, "n_positions": 2048,
    "vocab_size": 50400, "activation_function": "gelu_new",
    "layer_norm_epsilon": 1e-05, "tie_word_embeddings": False,
}
STARCODER_HF = {  # bigcode/starcoder config.json
    "model_type": "gpt_bigcode", "n_embd": 6144, "n_layer": 40,
    "n_head": 48, "multi_query": True, "n_inner": 24576,
    "n_positions": 8192, "vocab_size": 49152,
    "activation_function": "gelu_pytorch_tanh", "layer_norm_epsilon": 1e-05,
}
MODEL_NEW = 32  # new tokens per request in the model phases' serving passes
# The model phases' depth: an eighth of the published configs' 28 and 40
# layers (rounded up), so that the run with the mesh phases fits its time
# limit (PERF.md).
MODEL_DEPTH = {"gptj_6b": 4, "starcoder": 5}
POOL_BYTES = 256 * 16 * 524288  # the serve_continuous phase's bf16 pool


def _weight_read_bytes(cfg, params) -> int:
    """Bytes of the weights one decode step reads: every parameter but the
    embedding tables, whose rows are gathered (a tied head reads the whole
    token table, so it counts)."""
    total = sum(t.numel() * t.element_size() for t in _leaves(params))
    skip = [params["wpe"]] if "wpe" in params else []
    if not cfg.tie_word_embeddings:
        skip.append(params["wte"])
    return total - sum(t.numel() * t.element_size() for t in skip)


def _leaves(p):
    if isinstance(p, dict):
        for v in p.values():
            yield from _leaves(v)
    elif isinstance(p, tuple):
        for v in p:
            yield from _leaves(v)
    elif p is not None:
        yield p


def phase_model(name: str, hf: dict, kernels: dict, seed: int) -> None:
    """A published configuration at full width (``MODEL_DEPTH`` deep) through the
    port's entry points, with random bf16 weights from ``seed`` made on the
    card: ``prewarm`` then ``generate`` at batch 4 (prompts 128/100/77/128,
    64 new tokens, ring 1024, chunk_steps 8, one sampled row) twice with
    identical tokens, K1 n_layers per prefill and K2 n_layers per replayed
    step, no capture after prewarm; the prefill and one 8-step decode
    chunk profiled (graph and eager) against the weight-read bound; then
    two prewarmed ContinuousWorkers (split admission; chunked_prefill=128)
    over a pool of the serve_continuous phase's bytes, 8 rows, block_size
    16, serving the serve_continuous requests with ``MODEL_NEW`` new
    tokens; then a paged decode group and a ragged group profiled. Ends
    with the model's kernel line: each kernel's case at this model's
    shapes beside its launches here."""
    from llmss_tpu_torch.engine.engine import DecodeEngine, GenerationParams
    from llmss_tpu_torch.engine.metrics import EngineMetrics
    from llmss_tpu_torch.models.decoder import init_params
    from llmss_tpu_torch.models.registry import config_from_hf
    from llmss_tpu_torch.ops import decode_attention as da
    from llmss_tpu_torch.ops import flash_attention as fa
    from llmss_tpu_torch.serve.broker import InProcBroker
    from llmss_tpu_torch.serve.consumer import ContinuousWorker

    cfg = config_from_hf(hf)
    L, B, new = cfg.n_layers, 4, 64
    torch.cuda.synchronize()
    t = time.perf_counter()
    params = init_params(cfg, seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_params = sum(x.numel() for x in _leaves(params))
    weight_bytes = _weight_read_bytes(cfg, params)
    step_bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    emit({"phase": name, "config": {k: v for k, v in
                                    dataclasses.asdict(cfg).items()
                                    if v is not None},
          "params": n_params, "param_bytes": 2 * n_params,
          "weight_read_bytes_per_step": weight_bytes,
          "weight_read_bound_ms_per_step": step_bound_ms,
          "init_s": init_s, "memory_allocated": torch.cuda.memory_allocated()})

    eng = DecodeEngine(cfg, params, batch_size=B, max_seq_len=1024)
    rng = np.random.default_rng(seed)
    prompts = [[int(x) for x in rng.integers(1, cfg.vocab_size, n)]
               for n in ENGINE_LENS]
    _check_logits(eng, prompts)
    t = time.perf_counter()
    warmed = eng.prewarm(B, chunk_steps=8)
    prewarm_s = time.perf_counter() - t
    keys = eng._graphs.keys()
    sampled = GenerationParams(max_new_tokens=new, is_greedy=False,
                               temperature=0.8, top_k=40, top_p=0.9,
                               seed=1234)
    gens = [GenerationParams(max_new_tokens=new)] * 3 + [sampled]
    steps = math.ceil((new - 1) / 8) * 8
    runs = []
    for _ in range(2):
        eng.metrics = EngineMetrics()
        fa.flash_attention.launches = da.decode_attention.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        toks = eng.generate(prompts, gens, chunk_steps=8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        k1, k2 = fa.flash_attention.launches, da.decode_attention.launches
        if k1 != L or k2 != L * steps:
            raise AssertionError(f"{name}: launch counts K1={k1} (want {L}), "
                                 f"K2={k2} (want {L * steps})")
        for row in toks:
            if len(row) != new or not all(0 <= x < cfg.vocab_size for x in row):
                raise AssertionError(f"{name}: tokens outside the vocab or "
                                     "of the wrong length")
        runs.append((toks, wall, k1, k2, eng.metrics))
    (a, _, k1, k2, _), (b, wall, _, _, m) = runs
    captured = len(eng._graphs.keys() - keys)
    emit({"phase": name, "path": "generate", "batch": B,
          "prompt_lens": ENGINE_LENS, "new_tokens": new, "prewarm": warmed,
          "prewarm_s": prewarm_s, **_graph_memory(eng, [eng._cache]),
          "ttft_ms": m.ttft.last_s * 1e3,
          "decode_ms_per_step_chunk8": m.decode_step.to_dict()["mean_ms"],
          "weight_read_bound_ms_per_step": step_bound_ms,
          "tokens_per_s_chunk8_one_sampled_row": B * new / wall,
          "k1_launches_per_prefill": k1, "k2_launches": k2,
          "deterministic": a == b, "graph_captures_after_prewarm": captured,
          "graph_replays": m.graph_replays, "sampled_row_head": a[3][:8]})
    if a != b:
        raise AssertionError(f"{name}: same seed, different tokens")
    if captured:
        raise AssertionError(f"{name}: {captured} graph captures after prewarm")
    phase_profile(eng, name + "_")
    if name == "starcoder":
        _model_speculative(eng, prompts, a, name)
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    kv_token = 2 * L * cfg.n_kv_heads * cfg.head_dim * 2
    blocks = POOL_BYTES // (16 * kv_token)
    peng = DecodeEngine(cfg, params, max_seq_len=1024, kv_layout="paged",
                        block_size=16, kv_blocks=blocks)
    steps = count_steps(peng)
    lens, requests = _serve_requests(cfg, new=MODEL_NEW)
    counts = {}
    for chunked in (False, True):
        w = ContinuousWorker(peng, InProcBroker(), rows=8, chunk_steps=8,
                             group_chunks=2,
                             chunked_prefill=128 if chunked else None)
        t = time.perf_counter()
        warm = {"prewarm": w.prewarm(), "prewarm_s": time.perf_counter() - t,
                "kv_blocks": blocks, "kv_bytes_per_token": kv_token,
                "pool_bytes": _graph_memory(peng, [w.batcher.cache])[
                    "cache_bytes"]}
        keys = peng._graphs.keys()
        row, _, counts[chunked] = _serve_pass(peng, w, requests, steps,
                                              {"prompt_lens": lens, **warm})
        row["phase"] = name
        emit(row)
        if peng._graphs.keys() != keys:
            raise AssertionError(f"{name}: a serving pass captured a graph")
        del w
        gc.collect()
    phase_profile_paged(peng, name + "_")
    del peng, params
    gc.collect()
    torch.cuda.empty_cache()

    launches = {"K1": k1, "K2": k2,
                "K3": counts[False]["k3"] + counts[True]["k3"],
                "K4": counts[True]["k4"]}
    short = name.split("_")[0]
    cases = {"K1": f"k1_{short}_prefill", "K2": f"k2_{short}_engine_decode",
             "K3": f"k3_{short}_serve_decode", "K4": f"k4_{short}_serve_mixed"}
    emit({"phase": name, "kernels": [
        {"kernel": k, "case": c, "launches": launches[k],
         **{f: kernels["cases"][c].get(f) for f in (
             "impl", "splits", "split_slots", "max_abs_err", "err_over_tol",
             "ms", "unsplit_ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")}}
        for k, c in cases.items()]})


def _model_speculative(eng, prompts, want, name) -> None:
    """One short speculative call at the model's full width and depth
    (gamma 4, chunk_steps 4, 16 new tokens), so that K2w runs on the live
    path at the model's shapes (StarCoder: 48 x 5 window rows on its one
    KV head, the tile); its tokens' agreement with ``generate``'s greedy
    rows ``want``."""
    from llmss_tpu_torch.engine.engine import GenerationParams
    from llmss_tpu_torch.ops import _build
    from llmss_tpu_torch.ops import decode_attention as da

    cfg, new, gamma = eng.cfg, 16, 4
    keys = eng._graphs.keys()
    da.decode_window_attention.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    spec = eng.generate_speculative(prompts, GenerationParams(
        max_new_tokens=new), gamma=gamma, chunk_steps=4)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    st = eng.metrics.spec_stats
    k2w = da.decode_window_attention.launches
    # Not prewarmed: each step graph captured here ran the step once, for
    # real, in its warm-up.
    captured = sum(k[-5] == "spec" for k in eng._graphs.keys() - keys)
    if not k2w or k2w != cfg.n_layers * (st["verify_forwards"] + captured):
        raise AssertionError(f"{name}: K2w {k2w} launches for "
                             f"{st['verify_forwards']} verify forwards and "
                             f"{captured} captures")
    plan = da.window_plan(cfg.torch_dtype, len(prompts), cfg.n_heads,
                          cfg.n_kv_heads, cfg.head_dim,
                          eng.decode_bucket(max(map(len, prompts)) + new)
                          or eng.max_seq_len, gamma + 1,
                          sms=_build.sm_count(torch.device("cuda")))
    emit({"phase": name, "path": "generate_speculative", "gamma": gamma,
          "new_tokens": new, "wall_s": wall, "spec_stats": st,
          "k2w_launches": k2w, "spec_graphs_captured": captured,
          "k2w_impl": plan.impl, "k2w_rows_per_block": plan.rows,
          **_agreement([r for r in spec[:3]], [r[:new] for r in want[:3]])})


QWEN2_7B_HF = {  # Qwen/Qwen2-7B config.json
    "model_type": "qwen2", "vocab_size": 152064, "hidden_size": 3584,
    "intermediate_size": 18944, "num_hidden_layers": 28,
    "num_attention_heads": 28, "num_key_value_heads": 4,
    "max_position_embeddings": 131072, "rope_theta": 1000000.0,
    "rms_norm_eps": 1e-06, "hidden_act": "silu",
    "tie_word_embeddings": False, "use_sliding_window": False,
    "sliding_window": 131072, "max_window_layers": 28,
}
SANTACODER_HF = {  # bigcode/gpt_bigcode-santacoder config.json
    "model_type": "gpt_bigcode", "n_embd": 2048, "n_layer": 24, "n_head": 16,
    "multi_query": True, "n_inner": 8192, "n_positions": 2048,
    "vocab_size": 49280, "activation_function": "gelu_pytorch_tanh",
    "layer_norm_epsilon": 1e-05,
}
HEAD_GROUP_LAYERS = 2  # the head_groups phase's depth (full width)


def phase_head_groups() -> None:
    """The decode templates on the main path at the head groups no full
    model phase runs, each model at its published width cut to
    ``HEAD_GROUP_LAYERS`` layers, random bf16 weights from a seed:
    Qwen2-7B (G = 7) and SantaCoder (G = 16), whose K2 and K3 take the
    group tile (``decode_group`` / ``paged_group``, counted from their
    step graphs' nodes), and StarCoder over an int8 cache (G = 48: the
    64-row tile over int8 tiles). Each: prewarm, ``generate`` at batch 4
    (K2 n_layers per replayed step, no capture after prewarm), the decode
    chunk profiled (graph and eager, the template's kernel and its merges
    counted, the kernel ms per step and the decode kernels' share), then a
    paged engine's decode group profiled the same way (K3) and its ragged
    group."""
    from llmss_tpu_torch.engine.engine import DecodeEngine, GenerationParams
    from llmss_tpu_torch.engine.metrics import EngineMetrics
    from llmss_tpu_torch.models.decoder import init_params
    from llmss_tpu_torch.models.registry import config_from_hf
    from llmss_tpu_torch.ops import decode_attention as da

    for name, hf, kv, seed in (("qwen2_7b", QWEN2_7B_HF, None, 3),
                               ("santacoder", SANTACODER_HF, None, 4),
                               ("starcoder_int8", STARCODER_HF, "int8", 2)):
        depth = "n_layer" if "n_layer" in hf else "num_hidden_layers"
        cfg = config_from_hf({**hf, depth: HEAD_GROUP_LAYERS})
        params = init_params(cfg, seed=seed)
        L, B, new = cfg.n_layers, 4, 24
        eng = DecodeEngine(cfg, params, batch_size=B, max_seq_len=1024,
                           kv_dtype=kv)
        rng = np.random.default_rng(seed)
        prompts = [[int(x) for x in rng.integers(1, cfg.vocab_size, n)]
                   for n in ENGINE_LENS]
        warmed = eng.prewarm(B, chunk_steps=8)
        keys = eng._graphs.keys()
        eng.metrics = EngineMetrics()
        da.decode_attention.launches = 0
        toks = eng.generate(prompts, GenerationParams(max_new_tokens=new),
                            chunk_steps=8)
        k2 = da.decode_attention.launches
        steps = math.ceil((new - 1) / 8) * 8
        captured = len(eng._graphs.keys() - keys)
        plan = _decode_plan(eng, eng._cache, eng.decode_bucket(1024))
        emit({"phase": "head_groups", "model": name, "layers": L,
              "kv_dtype": kv or cfg.dtype, "G": cfg.n_heads // cfg.n_kv_heads,
              "path": "generate", "prewarm": warmed, "k2_launches": k2,
              "k2_impl": plan.impl, "graph_captures_after_prewarm": captured,
              "tokens_in_vocab": all(len(r) == new and all(
                  0 <= x < cfg.vocab_size for x in r) for r in toks)})
        if k2 != L * steps or captured:
            raise AssertionError(f"{name}: K2 launches {k2} (want "
                                 f"{L * steps}), {captured} captures")
        phase_profile(eng, f"{name}_")
        del eng
        peng = DecodeEngine(cfg, params, max_seq_len=1024, kv_layout="paged",
                            block_size=16, kv_blocks=512, kv_dtype=kv)
        phase_profile_paged(peng, f"{name}_")
        del peng, params
        gc.collect()
        torch.cuda.empty_cache()


# -- phase 7 -------------------------------------------------------------------


def write_safetensors(path: str, tensors: dict[str, torch.Tensor]) -> None:
    """Minimal safetensors writer: 8-byte header length, JSON header, raw
    little-endian bytes (bf16 / f16 / f32)."""
    codes = {torch.bfloat16: "BF16", torch.float16: "F16", torch.float32: "F32"}
    header, blobs, off = {}, [], 0
    for name, t in tensors.items():
        t = t.detach().contiguous().cpu()
        raw = t.view(torch.uint8).numpy().tobytes() if t.dtype != torch.float32 \
            else t.numpy().tobytes()
        header[name] = {"dtype": codes[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    hb = json.dumps(header).encode()
    hb += b" " * (-len(hb) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hb)))
        f.write(hb)
        for raw in blobs:
            f.write(raw)


def _run_cli(config: dict, tensors: dict, token_ids: list[str], new: int):
    """Write ``tensors`` (HF names and layouts) and ``config`` as a
    checkpoint directory, run the port's CLI on it (greedy), and load it
    again through ``load_model``; returns (the CLI's tokens, the loaded
    config and parameters)."""
    from llmss_tpu_torch.cli.generate import main as cli_main
    from llmss_tpu_torch.models.registry import load_model

    with tempfile.TemporaryDirectory() as d:
        write_safetensors(os.path.join(d, "model.safetensors"), tensors)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(config, f)
        out = cli_main(["--pretrained_model_path", d, "--token_ids",
                        *token_ids, "--max_new_tokens", str(new),
                        "--is_greedy"])
        cfg, params = load_model(d)
    if [len(o) for o in out] != [new] * len(token_ids) or not all(
            0 <= t < cfg.vocab_size for o in out for t in o):
        raise AssertionError(f"CLI returned {out}")
    return out, cfg, params


def _cli_family(name: str, hf: dict) -> dict:
    """A 2-layer checkpoint at the published widths of ``hf`` (GPT-J-6B or
    StarCoder) in HF tensor names and layouts (StarCoder's ``c_attn``
    fused), through the CLI and ``load_model``; the loaded parameters must
    equal the written tensors in the decoder's layout (q/k ``[out, in]``,
    the rest ``[in, out]``, the fused ``c_attn`` split at E and E + kv)."""
    hf = {**hf, "n_layer": 2}
    E, V = hf["n_embd"], hf["vocab_size"]
    I = hf["n_inner"] or 4 * E
    g = torch.Generator(device="cuda").manual_seed(6)

    def w(*shape):
        return torch.randn(shape, generator=g, device="cuda",
                           dtype=torch.bfloat16) * 0.02

    def ln():
        return {"weight": 1 + w(E), "bias": w(E)}

    t, h = {"transformer.wte.weight": w(V, E)}, "transformer.h"
    for k, x in ln().items():
        t[f"transformer.ln_f.{k}"] = x
    gptj = hf["model_type"] == "gptj"
    kv = E if gptj else E // hf["n_head"]
    for i in range(2):
        p = f"{h}.{i}"
        for k, x in ln().items():
            t[f"{p}.ln_1.{k}"] = x
        if gptj:
            t.update({f"{p}.attn.{n}_proj.weight": w(E, E)
                      for n in ("q", "k", "v", "out")})
            t.update({f"{p}.mlp.fc_in.weight": w(I, E),
                      f"{p}.mlp.fc_in.bias": w(I),
                      f"{p}.mlp.fc_out.weight": w(E, I),
                      f"{p}.mlp.fc_out.bias": w(E)})
        else:
            for k, x in ln().items():
                t[f"{p}.ln_2.{k}"] = x
            t.update({f"{p}.attn.c_attn.weight": w(E + 2 * kv, E),
                      f"{p}.attn.c_attn.bias": w(E + 2 * kv),
                      f"{p}.attn.c_proj.weight": w(E, E),
                      f"{p}.attn.c_proj.bias": w(E),
                      f"{p}.mlp.c_fc.weight": w(I, E),
                      f"{p}.mlp.c_fc.bias": w(I),
                      f"{p}.mlp.c_proj.weight": w(E, I),
                      f"{p}.mlp.c_proj.bias": w(E)})
    if gptj:
        t.update({"lm_head.weight": w(V, E), "lm_head.bias": w(V)})
    else:
        t["transformer.wpe.weight"] = w(hf["n_positions"], E)
    out, cfg, params = _run_cli(hf, t, ["1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17",
                                        "5,9,23"], 8)
    bl = params["blocks"]
    if gptj:
        want = {"q": t[f"{h}.1.attn.q_proj.weight"],
                "k": t[f"{h}.1.attn.k_proj.weight"],
                "v": t[f"{h}.1.attn.v_proj.weight"].T,
                "head": t["lm_head.weight"].T, "head_b": t["lm_head.bias"]}
        got = {"q": bl["q"].w[1], "k": bl["k"].w[1], "v": bl["v"].w[1],
               "head": params["head"].w, "head_b": params["head"].b}
    else:
        ca, cb = t[f"{h}.1.attn.c_attn.weight"], t[f"{h}.1.attn.c_attn.bias"]
        want = {"q": ca[:E], "k": ca[E:E + kv], "v": ca[E + kv:].T,
                "q_b": cb[:E], "k_b": cb[E:E + kv], "v_b": cb[E + kv:],
                "wpe": t["transformer.wpe.weight"]}
        got = {"q": bl["q"].w[1], "k": bl["k"].w[1], "v": bl["v"].w[1],
               "q_b": bl["q"].b[1], "k_b": bl["k"].b[1], "v_b": bl["v"].b[1],
               "wpe": params["wpe"]}
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    if bad or cfg.n_kv_heads != (hf["n_head"] if gptj else 1):
        raise AssertionError(f"{name} checkpoint loaded wrong: {bad}")
    return {"rows": len(out), "tokens": out, "loaded_equal": sorted(want),
            "n_kv_heads": cfg.n_kv_heads, "hidden": E, "intermediate": I}


def phase_cli() -> None:
    from llmss_tpu_torch.cli.generate import main as cli_main

    E, L, H, I, V = 2048, 2, 16, 5504, 32000
    g = torch.Generator(device="cuda").manual_seed(5)

    def w(*shape):
        return torch.randn(shape, generator=g, device="cuda",
                           dtype=torch.bfloat16) * 0.02

    tensors = {"model.embed_tokens.weight": w(V, E),
               "model.norm.weight": torch.ones(E, dtype=torch.bfloat16),
               "lm_head.weight": w(V, E)}
    for i in range(L):
        p = f"model.layers.{i}"
        tensors.update({
            f"{p}.input_layernorm.weight": torch.ones(E, dtype=torch.bfloat16),
            f"{p}.post_attention_layernorm.weight": torch.ones(E, dtype=torch.bfloat16),
            f"{p}.self_attn.q_proj.weight": w(E, E),
            f"{p}.self_attn.k_proj.weight": w(E, E),
            f"{p}.self_attn.v_proj.weight": w(E, E),
            f"{p}.self_attn.o_proj.weight": w(E, E),
            f"{p}.mlp.gate_proj.weight": w(I, E),
            f"{p}.mlp.up_proj.weight": w(I, E),
            f"{p}.mlp.down_proj.weight": w(E, I),
        })
    config = {"model_type": "llama", "vocab_size": V, "hidden_size": E,
              "num_hidden_layers": L, "num_attention_heads": H,
              "num_key_value_heads": H, "intermediate_size": I,
              "max_position_embeddings": 4096, "hidden_act": "silu",
              "rms_norm_eps": 1e-5, "tie_word_embeddings": False}
    with tempfile.TemporaryDirectory() as d:
        write_safetensors(os.path.join(d, "model.safetensors"), tensors)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(config, f)
        del tensors
        out = cli_main(["--pretrained_model_path", d,
                        "--token_ids", "1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17",
                        "5,9,23", "--max_new_tokens", "8", "--is_greedy"])
        # --speculative on a ring of prompt + max_new slots (71: the
        # ladder's 32 and 64 and the whole ring): whatever the acceptance,
        # a later group crosses into a new bucket and captures mid-call.
        ids = ["--token_ids", "1,2,3,1,2,3,1", "--max_new_tokens", "64",
               "--is_greedy"]
        plain = cli_main(["--pretrained_model_path", d, *ids])
        spec = cli_main(["--pretrained_model_path", d, *ids,
                         "--speculative", "4"])
    if [len(o) for o in out] != [8, 8] or not all(
            0 <= t < V for o in out for t in o):
        raise AssertionError(f"CLI returned {out}")
    emit({"phase": "cli", "rows": len(out), "tokens": out})
    if [len(o) for o in spec] != [64] or not all(0 <= t < V for t in spec[0]):
        raise AssertionError(f"CLI --speculative 4 returned {spec}")
    agree = next((i for i, (a, b) in enumerate(zip(spec[0], plain[0]))
                  if a != b), 64)
    emit({"phase": "cli", "speculative": 4, "new_tokens": 64,
          "agree_with_plain": agree, "tokens": spec})
    for name, hf in (("gptj_6b", GPTJ_6B_HF), ("starcoder", STARCODER_HF)):
        emit({"phase": "cli", "model": f"{name}, 2 layers",
              **_cli_family(name, hf)})
        gc.collect()
        torch.cuda.empty_cache()


PHASE_SECONDS: dict[str, float] = {}


# -- phase 6f, the telemetry plane and the autoscaler ---------------------------------


TEL_NEW = 12  # new tokens per reference_telemetry request
TEL_SLO_MS = 10.0  # the autoscaler pass's interactive TTFT objective
TEL_WINDOW_S = 10.0  # ... and its burn window (one series bucket)
# Sizing for the serve_telemetry gauges: the predictions in PERF.md section 6.
TEL_PREDICTED = {"mbu_decode_group": (0.45, 0.65),
                 "mfu_decode_group": (0.008, 0.016),
                 "mfu_ragged_group": (0.3, 0.4)}


def _telemetry_reset() -> None:
    """Empty this process's windowed series, flight recorder and devtel
    accumulators (the compile observer's steady flag included)."""
    from llmss_tpu_torch.utils import devtel, trace
    from llmss_tpu_torch.utils import metrics as metrics_mod

    devtel.reset()
    metrics_mod.series().clear()
    trace.recorder().clear()


def _drive(worker, reqs) -> dict:
    """Push ``reqs`` onto the worker's broker and run it until each is
    answered; returns {id: response}."""
    for r in reqs:
        worker.broker.push_request(r)
    got: dict = {}
    while len(got) < len(reqs):
        worker.run_once()
        for r in reqs:
            if r.id not in got:
                a = worker.broker.wait_response(r.id, timeout=0.0)
                if a is not None:
                    got[r.id] = a
    return got


def _telemetry_readout(ids) -> dict:
    """What reference_telemetry holds card against CPU: the windowed
    series' request and token totals and every cost histogram's count,
    the compile events' names, the steady-state recompiles, and each
    request's phase names in its stitched timeline."""
    from llmss_tpu_torch.utils import devtel, trace
    from llmss_tpu_torch.utils import metrics as metrics_mod

    series = metrics_mod.series().export()["series"]
    exports = [trace.recorder().export()]
    comp = devtel.observer().export()
    return {
        "requests_total": series["requests_total"]["total"],
        "tokens_out": series["tokens_out"]["total"],
        "cost_histograms": {n: b["total"]["count"] for n, b in series.items()
                            if b["kind"] == "histogram"
                            and not n.startswith(("mfu_", "mbu_"))},
        "compiles": sorted(e["name"] for e in comp["events"]),
        "steady_recompiles": comp["steady_recompiles"],
        "phases": {rid: sorted(trace.timeline(exports, rid)["phases"])
                   for rid in ids},
    }


def phase_reference_telemetry() -> None:
    """The telemetry plane on the tiny fp32 llama: one paged engine, a
    split and a chunked (16) ContinuousWorker, both prewarmed, serve the
    same 8 requests (3-40 token prompts from seed 13, TEL_NEW new tokens,
    the three SLO classes in turn), on the card and on the CPU, each run
    from an emptied plane. The card's tokens, windowed request and token
    totals, cost histogram counts, compile event names (the graph
    captures), steady-state recompiles (0) and each request's timeline
    phases equal the CPU's; K1, K3 and K4 launch on the card."""
    from llmss_tpu_torch.engine.engine import DecodeEngine
    from llmss_tpu_torch.models.decoder import init_params
    from llmss_tpu_torch.serve.broker import InProcBroker
    from llmss_tpu_torch.serve.consumer import ContinuousWorker
    from llmss_tpu_torch.serve.protocol import SLO_CLASSES, GenerateRequest

    cfg = _tiny_llama()
    cpu_params = init_params(cfg, seed=13, device="cpu")
    params = {"cpu": cpu_params, "cuda": _to(cpu_params, "cuda")}
    rng = np.random.default_rng(13)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, int(n))]
               for n in rng.integers(3, 41, 8)]
    classes = sorted(SLO_CLASSES)

    def requests(mode):
        return [GenerateRequest(id=f"tel-{mode}-{i}", token_ids=p,
                                max_new_tokens=TEL_NEW, is_greedy=True,
                                slo_class=classes[i % len(classes)])
                for i, p in enumerate(prompts)]

    out = {}
    for dev in ("cpu", "cuda"):
        _telemetry_reset()
        eng = DecodeEngine(cfg, params[dev], device=dev, max_seq_len=128,
                           kv_layout="paged", block_size=16, kv_blocks=48)
        workers = {mode: ContinuousWorker(
            eng, InProcBroker(), rows=4, chunk_steps=4, group_chunks=2,
            chunked_prefill=cp, poll_timeout_s=0.0)
            for mode, cp in (("split", None), ("chunked", 16))}
        for w in workers.values():
            w.prewarm()
        count = _launch_counter()
        tokens, ids = {}, []
        for mode, w in workers.items():
            reqs = requests(mode)
            got = _drive(w, reqs)
            tokens[mode] = [got[r.id].token_ids for r in reqs]
            ids += [r.id for r in reqs]
        out[dev] = {"tokens": tokens, "launches": count(),
                    **_telemetry_readout(ids)}
        del workers, eng
        gc.collect()
    got, want = out["cuda"], out["cpu"]
    keys = ("tokens", "requests_total", "tokens_out", "cost_histograms",
            "compiles", "steady_recompiles", "phases")
    diff = [k for k in keys if got[k] != want[k]]
    c = got["launches"]
    emit({"phase": "reference_telemetry", "identical": not diff,
          "requests_total": got["requests_total"],
          "tokens_out": got["tokens_out"],
          "ttft_s_count": got["cost_histograms"].get("ttft_s"),
          "compile_events": len(got["compiles"]),
          "steady_recompiles": got["steady_recompiles"],
          "phases": sorted({p for v in got["phases"].values() for p in v}),
          "launches": c})
    if diff:
        raise AssertionError(f"reference_telemetry: card != CPU in {diff}: "
                             f"{[(got[k], want[k]) for k in diff]}")
    if got["steady_recompiles"] or got["requests_total"] != 16 or (
            got["cost_histograms"].get("ttft_s") != 16):
        raise AssertionError(f"reference_telemetry: {got}")
    if not (c["k1"] and c["k3"] and c["k4"]) or c["k2"]:
        raise AssertionError(f"reference_telemetry: launches {c}")


class _FoldMeter:
    """Wraps ``devtel.fold`` and ``ContinuousBatcher._devtel_sample`` while
    installed: each class's summed FLOPs, bytes and fold interval (the
    unclamped MFU / MBU of a pass) and the host seconds of both calls."""

    def __init__(self):
        from llmss_tpu_torch.engine.scheduler import ContinuousBatcher
        from llmss_tpu_torch.utils import devtel

        self.devtel, self.cls = devtel, ContinuousBatcher
        self.fold, self.sample = devtel.fold, ContinuousBatcher._devtel_sample
        self.reset()

    def reset(self):
        self.acc: dict = {}
        self.fold_s, self.folds, self.sample_s, self.samples = 0.0, 0, 0.0, 0

    def __enter__(self):
        fold, sample = self.fold, self.sample

        def timed_fold(kind, dur_s, cost):
            t = time.perf_counter()
            fold(kind, dur_s, cost)
            self.fold_s += time.perf_counter() - t
            self.folds += 1
            if cost is not None and dur_s > 0:
                a = self.acc.setdefault(kind, [0.0, 0.0, 0.0])
                a[0] += cost.flops
                a[1] += cost.hbm_bytes
                a[2] += dur_s

        def timed_sample(bat):
            t = time.perf_counter()
            sample(bat)
            self.sample_s += time.perf_counter() - t
            self.samples += 1

        self.devtel.fold, self.cls._devtel_sample = timed_fold, timed_sample
        return self

    def __exit__(self, *exc):
        self.devtel.fold, self.cls._devtel_sample = self.fold, self.sample

    def raw(self) -> dict:
        """Unclamped MFU / MBU per class over everything folded."""
        pf, pb = self.devtel.device_peaks()
        out = {}
        for kind, (fl, by, dur) in self.acc.items():
            out[f"mfu_{kind}"] = fl / (pf * dur)
            out[f"mbu_{kind}"] = by / (pb * dur)
        return out

    def host_us(self) -> dict:
        return {"fold_us_per_group": 1e6 * self.fold_s / max(self.folds, 1),
                "folds": self.folds,
                "devtel_sample_us_per_group":
                    1e6 * self.sample_s / max(self.samples, 1),
                "devtel_samples": self.samples}


def _cost_gap(worker) -> dict:
    """Wraps the worker's engine's ``devtel_cost`` and counts, beside what
    each group's signature prices, what its rows hold: a decode group's KV
    slots at the bucket for every row of the batcher against the slots
    its live rows reach (each row's position at the group's end, less the
    steps still to come); a ragged group's prefill tokens (every row, CB
    each) against the prompt tokens the pass fed. Returns the counts,
    filled while the pass runs."""
    eng, bat = worker.engine, worker.batcher
    inner = eng.devtel_cost
    out = {"decode_kv_slots_priced": 0, "decode_kv_slots_live": 0,
           "ragged_prefill_tokens_priced": 0,
           "prefill_tokens_fed_start": eng.metrics.prefill_tokens_chunked}

    def cost(kind, key, *, batch, steps, kv_len, prefill_tokens=0):
        if kind == "decode_group":
            out["decode_kv_slots_priced"] += (
                batch * steps * (kv_len or eng.max_seq_len))
            out["decode_kv_slots_live"] += sum(
                steps * pos - steps * (steps - 1) // 2
                for pos in bat._row_pos.values())
        elif kind == "ragged_group":
            out["ragged_prefill_tokens_priced"] += prefill_tokens
        return inner(kind, key, batch=batch, steps=steps, kv_len=kv_len,
                     prefill_tokens=prefill_tokens)

    eng.devtel_cost = cost
    return out


def _gap_readout(worker, gap: dict) -> dict:
    """``_cost_gap``'s counts once the pass is over (the wrapper goes)."""
    del worker.engine.devtel_cost
    fed = (worker.engine.metrics.prefill_tokens_chunked
           - gap.pop("prefill_tokens_fed_start"))
    gap["ragged_prefill_tokens_fed"] = fed
    if gap["decode_kv_slots_live"]:
        gap["decode_kv_priced_over_live"] = (
            gap["decode_kv_slots_priced"] / gap["decode_kv_slots_live"])
    if fed:
        gap["ragged_prefill_priced_over_fed"] = (
            gap["ragged_prefill_tokens_priced"] / fed)
    return gap


def _sample_parts(worker, dev, n: int = 200) -> dict:
    """Host microseconds per call of ``_devtel_sample``'s parts, and of the
    two public allocator getters it does not call."""
    from llmss_tpu_torch.utils import devtel

    alloc = worker.batcher.allocator
    parts = {"device_memory_stats": lambda: devtel.device_memory_stats(dev),
             "largest_free_run": alloc.largest_free_run,
             "last_util": devtel.last_util}
    if torch.device(dev or "cuda").type == "cuda":
        parts["memory_allocated"] = torch.cuda.memory_allocated
        parts["max_memory_allocated"] = torch.cuda.max_memory_allocated
    out = {}
    for name, fn in parts.items():
        t = time.perf_counter()
        for _ in range(n):
            fn()
        out[name] = 1e6 * (time.perf_counter() - t) / n
    return out


def _prom_gauges(text: str) -> dict:
    """``llmss_mfu{kernel="k"} v`` lines of a Prometheus text as
    {"mfu_k": v}."""
    out = {}
    for line in text.splitlines():
        m = re.match(r'llmss_(mfu|mbu)\{kernel="(\w+)"\} (\S+)$', line)
        if m:
            out[f"{m.group(1)}_{m.group(2)}"] = float(m.group(3))
    return out


def _serve_loop(worker, stop: threading.Event) -> threading.Thread:
    """The one thread that drives ``worker`` (and touches the card) until
    ``stop``."""
    def loop():
        while not stop.is_set():
            worker.run_once()
            if worker.batcher.idle:
                time.sleep(0.001)

    th = threading.Thread(target=loop, name="serve-loop", daemon=True)
    th.start()
    return th


def _http_pass(srv, worker, reqs, sync) -> dict:
    """POST ``reqs`` concurrently to ``srv`` while one thread drives
    ``worker``; every answer must be 200 with all its tokens. Returns the
    pass's wall and answers."""
    outs = [{} for _ in reqs]
    stop = threading.Event()
    sync()
    t0 = time.perf_counter()
    loop = _serve_loop(worker, stop)
    clients = [threading.Thread(target=_http_client, args=(srv.port, r, o),
                                daemon=True) for r, o in zip(reqs, outs)]
    try:
        for th in clients:
            th.start()
        for th in clients:
            th.join(timeout=300)
        end = time.monotonic() + 60
        while not worker.batcher.idle and time.monotonic() < end:
            time.sleep(0.01)
    finally:
        stop.set()
        loop.join(timeout=60)
    sync()
    wall = max(o.get("t_done", 0.0) for o in outs) - t0
    for i, (r, o) in enumerate(zip(reqs, outs)):
        a = o.get("answer") or {}
        if o.get("status") != 200 or a.get("error") or len(
                a.get("token_ids") or []) != r.max_new_tokens:
            raise AssertionError(f"serve_telemetry request {i}: {o}")
    return {"wall_s": wall, "answers": [o["answer"] for o in outs]}


def _tel_endpoints(srv, rid: str, n: int, captures: int, card: bool
                   ) -> dict:
    """Read /slo, /compiles, /metrics (JSON and Prometheus) and the Chrome
    trace of ``rid`` after a pass of ``n`` requests, and check them:
    ``n`` requests in the 1-minute window of the windowed series and in
    /slo's 5-minute window, the ``ttft_s`` count equal to the answers, no
    steady-state recompile (and as many as ``captures``, the engine's
    captures after prewarm), MFU / MBU gauges in the Prometheus text, and
    a Chrome trace holding the request's events and the counter tracks
    (kv_blocks, rows, device memory in use > 0 on the card)."""
    from llmss_tpu_torch.serve.producer import collect_series_exports
    from llmss_tpu_torch.utils import metrics as metrics_mod

    st, _, raw = _http(srv.port, "/slo")
    slo = json.loads(raw)
    obj = {o["name"]: o for o in slo["objectives"]}
    ttft = obj["ttft_p95_500ms"]["windows"]["5m"]
    exports, _ = collect_series_exports(srv.broker)
    minute = metrics_mod.merged_window(exports, "requests_total", 60.0)
    _, _, raw = _http(srv.port, "/compiles")
    comp = json.loads(raw)
    _, _, prom = _http(srv.port, "/metrics?format=prometheus")
    gauges = _prom_gauges(prom.decode())
    _, _, raw = _http(srv.port, f"/trace/{rid}?format=chrome")
    chrome = json.loads(raw)
    evs = chrome["traceEvents"]
    tracks = {e["name"] for e in evs if e["ph"] == "C"}
    mem = [e["args"].get("bytes_in_use", 0) for e in evs
           if e["ph"] == "C" and e["name"] == "device_memory"]
    spans = {e["name"] for e in evs if e["ph"] in ("X", "i")}
    out = {"slo_5m_count": ttft["count"], "minute_requests": minute["value"],
           "ttft_attainment": ttft["attainment"], "ttft_p95_ms": ttft["p95_ms"],
           "ttft_burn": ttft["burn_rate"],
           "compile_block": slo.get("compile"),
           "compiles": comp["n_compiles"],
           "steady_recompiles": comp["steady_recompiles"],
           "gauges": gauges, "chrome_events": len(evs),
           "chrome_tracks": sorted(tracks), "chrome_spans": sorted(spans),
           "device_memory_in_use": max(mem, default=0)}
    if (st != 200 or ttft["count"] != n or minute["value"] != n
            or comp["steady_recompiles"] != captures or captures
            or not {"kv_blocks", "rows"} <= tracks
            or not {"enqueue", "admit", "respond"} <= spans
            or "mfu_decode_group" not in gauges
            or (card and not out["device_memory_in_use"])):
        raise AssertionError(f"serve_telemetry endpoints: {out}")
    return out


PROFILE_WATCHDOG_S = 180  # POST /profile's step: stacks dumped, run ended


def _tel_profile(srv, worker, requests, sync, log_dir: Path) -> dict:
    """POST /profile over a chunked pass run in this process: the capture
    writes a Chrome trace whose kernel names hold K3's (``paged_fwd``, the
    decode steps' graph replays) and K4's (``paged_mma``, the eager ragged
    steps). Launches are never counted from it."""
    import shutil

    from llmss_tpu_torch.serve import producer

    shutil.rmtree(log_dir, ignore_errors=True)
    # This step once hung, with every Llama-width phase at 16 layers
    # (ROADMAP Queue 3): if it outlasts 180 s, every thread's stack goes
    # to stderr, so a hang says where it waits, and the run ends there,
    # non-zero, instead of waiting for the call's time limit.
    faulthandler.dump_traceback_later(PROFILE_WATCHDOG_S, exit=True)
    status, _, raw = _http(srv.port, "/profile",
                           {"duration_s": 1.5, "log_dir": str(log_dir)})
    busy, _, _ = _http(srv.port, "/profile", {"duration_s": 1.0})
    if status != 202 or busy != 409:
        raise AssertionError(f"/profile {status} {raw}, then {busy}")
    _drive(worker, requests())
    sync()
    path = log_dir / "trace.json"
    end = time.monotonic() + 120
    while producer._PROFILE_ACTIVE and time.monotonic() < end:
        time.sleep(0.1)
    names = set()
    if path.exists():
        for e in json.loads(path.read_text()).get("traceEvents", []):
            if e.get("cat") == "kernel":
                names.add(e.get("name", ""))
    faulthandler.cancel_dump_traceback_later()
    found = {sym: any(sym in n for n in names)
             for sym in ("paged_fwd", "paged_mma")}
    out = {"profile_kernels": len(names), "symbols": found,
           "trace_bytes": path.stat().st_size if path.exists() else 0}
    shutil.rmtree(log_dir, ignore_errors=True)
    return out


def _autoscale_pass(srv_cls, broker, w0, make_worker, split_p50_ms,
                    cold_start_s, sync, smi) -> dict:
    """The FleetController over ``producer_telemetry``: w0 alone behind a
    round-robin Router and a producer whose interactive TTFT objective
    (TEL_SLO_MS, below the split pass's p50) is read over a TEL_WINDOW_S
    burn window. One thread drives w0 and ticks the controller; ``spawn``
    builds and prewarms w1 there (``make_worker``) and starts its
    Supervisor; ``retire`` drains it through the Supervisor. Interactive
    requests arrive every 0.4 s until w1 has answered and served for 4 s
    (at most 90 s), then nothing: the fleet must go 1 -> 2 -> 1, never
    retire w0, and answer every request once."""
    from llmss_tpu_torch.serve.controller import (
        FleetController, producer_telemetry,
    )
    from llmss_tpu_torch.serve.fleet import (
        BrownoutController, Router, interactive_burn,
    )
    from llmss_tpu_torch.serve.protocol import SLO_CLASS_INTERACTIVE
    from llmss_tpu_torch.serve.supervisor import Supervisor
    from llmss_tpu_torch.utils import metrics as metrics_mod

    from llmss_tpu_torch.utils import devtel

    if not split_p50_ms > TEL_SLO_MS:
        raise AssertionError(f"split TTFT p50 {split_p50_ms} ms is not above "
                             f"the objective's {TEL_SLO_MS} ms")
    # The controller steers on this pass's traffic: the series and the
    # last-value MFU / MBU gauges of the earlier passes go (a gauge holds
    # its last value once its traffic stops); the fleet stays steady.
    metrics_mod.series().clear()
    devtel.reset()
    devtel.observer().mark_steady()
    objective = [{"name": f"ttft_p95_{TEL_SLO_MS:g}ms_interactive",
                  "kind": "latency", "series": "ttft_s_interactive",
                  "threshold_ms": TEL_SLO_MS, "target": 0.95}]
    router = Router(broker, "round_robin", stale_factor=3.0)
    state: dict = {"spawned": [], "retired": [], "sups": {}, "threads": {}}

    def spawn(role):
        t = time.perf_counter()
        w1 = make_worker()  # built and prewarmed here: no capture overlaps
        w1.worker_id = "w1"
        w1.register()
        sup = Supervisor(lambda: w1, broker, heartbeat_s=1.0,
                         drain_timeout_s=60.0)
        th = threading.Thread(target=sup.run, name="w1-supervisor",
                              daemon=True)
        th.start()
        state["sups"]["w1"], state["threads"]["w1"] = sup, th
        state["w1"], state["spawn_s"] = w1, time.perf_counter() - t
        state["t_ready"] = time.perf_counter()
        state["spawned"].append(("w1", state["t_ready"]))
        w0._publish_load()
        return "w1"

    def retire(wid):
        if not state["sups"][wid].drain(timeout_s=60.0):
            raise AssertionError(f"the supervisor refused to drain {wid}")
        state["retired"].append((wid, time.perf_counter()))

    srv = srv_cls(broker, host="127.0.0.1", port=0, timeout_s=300.0,
                  router=router, slo_objectives=objective)
    ctrl = FleetController(
        broker, spawn=spawn, retire=retire,
        read_telemetry=producer_telemetry(srv), floor=1, ceiling=2,
        check_s=0.25, cooldown_s=2.0, dwell_s=1.0,
        cold_start_s=cold_start_s, burn_headroom_s=60.0,
        # The gauges are last values, held after the traffic: scale-down
        # waits on the burn and the backlog.
        util_low=0.9)
    srv.controller = ctrl
    srv.brownout = BrownoutController(lambda: interactive_burn(srv.slo()),
                                      escalate_ok=ctrl.escalation_allowed)
    ctrl.start()
    srv.start()
    stop, stop_traffic = threading.Event(), threading.Event()
    errors: list = []

    def fleet_loop():
        try:
            while not stop.is_set():
                w0.run_once()
                ctrl.tick()
                if w0.batcher.idle:
                    time.sleep(0.002)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    rng = np.random.default_rng(17)
    outs: list = []
    clients: list = []

    def traffic():
        from llmss_tpu_torch.serve.protocol import GenerateRequest

        while not stop_traffic.is_set():
            n = int(rng.integers(32, 257))
            r = GenerateRequest(
                token_ids=[int(t) for t in rng.integers(
                    1, w0.engine.cfg.vocab_size, n)],
                max_new_tokens=16, slo_class=SLO_CLASS_INTERACTIVE)
            o: dict = {"t_post": time.perf_counter()}
            outs.append((r, o))
            th = threading.Thread(target=_http_client, args=(srv.port, r, o),
                                  daemon=True)
            clients.append(th)
            th.start()
            stop_traffic.wait(0.4)

    w0._publish_load()
    w0_before = w0.engine.metrics.finish_classes.get("served", 0)
    sync()
    t0 = time.perf_counter()
    loop = threading.Thread(target=fleet_loop, name="fleet-loop", daemon=True)
    feed = threading.Thread(target=traffic, name="traffic", daemon=True)
    loop.start()
    feed.start()
    t_first = None
    try:
        end = time.perf_counter() + 90
        while time.perf_counter() < end and not errors:
            w1 = state.get("w1")
            if w1 is not None and t_first is None and (
                    w1.engine.metrics.finish_classes.get("served")):
                t_first = time.perf_counter()
            if t_first is not None and (
                    time.perf_counter() - state["t_ready"] > 4.0):
                break
            time.sleep(0.05)
        stop_traffic.set()
        feed.join(timeout=30)
        for th in clients:
            th.join(timeout=300)
        t_idle = time.perf_counter()
        end = time.perf_counter() + 120
        while not state["retired"] and time.perf_counter() < end and (
                not errors):
            time.sleep(0.1)
        th1 = state["threads"].get("w1")
        if th1 is not None:
            th1.join(timeout=120)
    finally:
        stop_traffic.set()
        stop.set()
        loop.join(timeout=60)
        srv.stop()
        for sup in state["sups"].values():
            sup.drain(force=True)
    sync()
    if errors:
        raise AssertionError(f"autoscale: the fleet loop failed: {errors[0]!r}")
    bad = [(i, o) for i, (r, o) in enumerate(outs)
           if o.get("status") != 200 or (o.get("answer") or {}).get("error")
           or len((o.get("answer") or {}).get("token_ids") or [])
           != r.max_new_tokens]
    stats = broker.delivery_stats()
    w1 = state.get("w1")
    out = {
        "requests": len(outs), "bad_answers": len(bad),
        "spawns": ctrl.counters["spawns"], "retires": ctrl.counters["retires"],
        "retired": [w for w, _ in state["retired"]],
        "blocked_last_routable": ctrl.counters["blocked_last_routable"],
        "blocked_ceiling": ctrl.counters["blocked_ceiling"],
        "held_cooldown": ctrl.counters["held_cooldown"],
        "escalations_suppressed": ctrl.counters["escalations_suppressed"],
        "escalations_allowed": ctrl.counters["escalations_allowed"],
        "brownout": srv.brownout.state()["state"],
        "w1_answers": (w1.engine.metrics.finish_classes.get("served", 0)
                       if w1 is not None else 0),
        "w0_answers": (w0.engine.metrics.finish_classes.get("served", 0)
                       - w0_before),
        "spawn_s": state.get("spawn_s"),
        "burst_to_spawn_s": (state["spawned"][0][1] - t0
                             if state["spawned"] else None),
        "burst_to_w1_first_answer_s": (t_first - t0) if t_first else None,
        "idle_to_retire_s": (state["retired"][0][1] - t_idle
                             if state["retired"] else None),
        "redelivered": stats.get("redelivered", 0),
        "dlq": broker.dlq_depth(), "objective_ms": TEL_SLO_MS,
        "burn_window_s": TEL_WINDOW_S, "split_ttft_p50_ms": split_p50_ms,
        "nvidia_smi": smi,
    }
    if (bad or out["spawns"] != 1 or out["retired"] != ["w1"]
            or not out["w1_answers"] or out["redelivered"] or out["dlq"]
            or "w0" not in [w for w, i in broker.read_workers().items()
                            if i.get("state") == "ready"]
            or state["sups"]["w1"].state != "dead"):
        raise AssertionError(f"autoscale: {out}, bad {bad[:3]}")
    return out


def phase_serve_telemetry(params, smi: str, cfg=None, dev=None) -> None:
    """The telemetry plane at Llama-2-7B width (serve_continuous's weights
    and pool; ``cfg`` / ``dev`` narrow it for a CPU rehearsal): one engine
    with a split and a chunked (128) ContinuousWorker, prewarmed from an
    emptied plane, behind ``ProducerServer``. The 16 serve_continuous
    requests (all greedy here, none cancelled) are POSTed, split then
    chunked; after each pass ``_tel_endpoints`` reads /slo, /compiles,
    /metrics and a Chrome trace. Then POST /profile over a chunked pass
    (``_tel_profile``); the chunked pass with the plane on and off in
    turns (on, off, on, off: walls, and the fold's and ``_devtel_sample``'s
    host microseconds per group); and the autoscaler pass. Prints the
    MFU / MBU gauges (clamped, from /metrics) beside the passes' unclamped
    means and the predictions, beside the card (``smi``)."""
    from llmss_tpu_torch.engine.engine import DecodeEngine
    from llmss_tpu_torch.engine.metrics import EngineMetrics
    from llmss_tpu_torch.models.common import DecoderConfig
    from llmss_tpu_torch.serve.broker import InProcBroker
    from llmss_tpu_torch.serve.consumer import ContinuousWorker
    from llmss_tpu_torch.serve.producer import ProducerServer
    from llmss_tpu_torch.utils import devtel, trace
    from llmss_tpu_torch.utils import metrics as metrics_mod

    cfg = cfg or DecoderConfig(**LLAMA2_7B)
    card = dev is None or torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if card else (lambda: None)
    L = cfg.n_layers

    def make_engine():
        return DecodeEngine(cfg, params, device=dev, max_seq_len=1024,
                            kv_layout="paged", block_size=16, kv_blocks=256)

    def make_worker(eng, broker, chunked, **kw):
        w = ContinuousWorker(eng, broker, rows=8, chunk_steps=8,
                             group_chunks=2,
                             chunked_prefill=128 if chunked else None, **kw)
        w.prewarm()
        return w

    _telemetry_reset()
    trace.set_enabled(True)
    eng = make_engine()
    steps = count_steps(eng)
    broker = InProcBroker()
    t = time.perf_counter()
    workers = {c: make_worker(eng, broker, c, poll_timeout_s=0.0)
               for c in (False, True)}
    prewarm_s = time.perf_counter() - t
    sync()
    eng.metrics = EngineMetrics()
    _, requests = _serve_requests(cfg)

    def greedy():
        reqs = requests()
        for r in reqs:
            r.is_greedy, r.stream = True, False
        return reqs

    srv = ProducerServer(broker, host="127.0.0.1", port=0, timeout_s=300.0)
    srv.start()
    rows, raw = {}, {}
    meter = _FoldMeter()
    try:
        for chunked in (False, True):
            mode = "chunked" if chunked else "split"
            metrics_mod.series().clear()
            count = _launch_counter()
            steps.update(decode=0, ragged=0)
            eng.metrics = EngineMetrics()
            meter.reset()
            reqs = greedy()
            gap = _cost_gap(workers[chunked])
            with meter:
                p = _http_pass(srv, workers[chunked], reqs, sync)
            gap = _gap_readout(workers[chunked], gap)
            c = count()
            if card and (c["k3"] != L * steps["decode"]
                         or c["k4"] != L * steps["ragged"]
                         or not c["k3"] or (chunked and not c["k4"])):
                raise AssertionError(f"serve_telemetry {mode}: launches {c} "
                                     f"for steps {steps}")
            ends = _tel_endpoints(srv, reqs[0].id, len(reqs),
                                  eng.metrics.graph_captures, card)
            raw[mode] = meter.raw()
            rows[mode] = {"wall_s": p["wall_s"],
                          "ttft_p50_ms": eng.metrics.ttft.quantile_ms(50),
                          "launches": c, "decode_steps": steps["decode"],
                          "ragged_steps": steps["ragged"], **ends,
                          **meter.host_us(), "cost_gap": gap}
            emit({"phase": "serve_telemetry", "pass": mode, **rows[mode]})
        profile = _tel_profile(srv, workers[True], greedy, sync,
                               Path(".scratch") / "telemetry_profile")
        emit({"phase": "serve_telemetry", "pass": "profile", **profile})
        if card and not all(profile["symbols"].values()):
            raise AssertionError(f"the profile misses K3 / K4: {profile}")
    finally:
        srv.stop()
    gauges = rows["chunked"]["gauges"]
    gauges.update({k: v for k, v in rows["split"]["gauges"].items()
                   if k.endswith("decode_group")})
    emit({"phase": "serve_telemetry", "check": "utilization",
          "gauges_clamped": gauges, "pass_mean_unclamped": raw,
          "predicted": TEL_PREDICTED,
          "within_prediction": {
              k: lo / 3 <= raw["chunked" if "ragged" in k else "split"].get(
                  k, 0.0) <= 1.0 for k, (lo, _hi) in TEL_PREDICTED.items()},
          "nvidia_smi": smi})
    # The plane's cost: the chunked pass in this process, on and off.
    walls: dict = {"on": [], "off": []}
    host: list = []
    try:
        for on in (True, False, True, False):
            trace.set_enabled(on)
            meter.reset()
            sync()
            t = time.perf_counter()
            with meter:
                _drive(workers[True], greedy())
            sync()
            walls["on" if on else "off"].append(time.perf_counter() - t)
            if on:
                host.append(meter.host_us())
    finally:
        trace.set_enabled(True)
    overhead = {"phase": "serve_telemetry", "pass": "plane_on_off",
                "walls_s": walls, "host": host,
                "sample_parts_us": _sample_parts(workers[True], dev),
                "nvidia_smi": smi}
    emit(overhead)
    if eng.metrics.graph_captures:
        raise AssertionError("serve_telemetry captured a graph after prewarm")
    # The autoscaler: w0 is the split worker, registered now.
    w0 = workers[False]
    del workers[True]
    gc.collect()
    w0.worker_id, w0.snapshot_interval_s = "w0", 10.0
    w0.register()
    auto = _autoscale_pass(
        _telemetry_producer(), broker, w0,
        lambda: make_worker(make_engine(), broker, False, poll_timeout_s=0.0,
                            snapshot_interval_s=1.0),
        rows["split"]["ttft_p50_ms"], prewarm_s / 2, sync, smi)
    emit({"phase": "serve_telemetry", "pass": "autoscale", **auto,
          "prewarm_s": prewarm_s})
    del w0, workers, eng
    gc.collect()


def _telemetry_producer():
    """ProducerServer whose /slo reads its objectives over TEL_WINDOW_S
    (the autoscaler pass must see the burn cool within its time budget)."""
    from llmss_tpu_torch.serve.producer import (
        ProducerServer, collect_devtel_exports, collect_series_exports,
    )
    from llmss_tpu_torch.utils import devtel
    from llmss_tpu_torch.utils import metrics as metrics_mod

    class TelemetryProducer(ProducerServer):
        def slo(self) -> dict:
            exports, _src = collect_series_exports(self.broker)
            out = metrics_mod.evaluate_slos(
                exports, self.slo_objectives,
                windows=((f"{TEL_WINDOW_S:g}s", TEL_WINDOW_S),))
            dt = collect_devtel_exports(self.broker)
            if dt:
                out["compile"] = devtel.recompile_flag(dt)
            return out

    return TelemetryProducer


def timed(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its host seconds added to ``PHASE_SECONDS``
    under its name (and a leading string argument, the model's)."""
    name = fn.__name__.removeprefix("phase_")
    if args and isinstance(args[0], str):
        name = f"{name}:{args[0]}"
    t = time.perf_counter()
    try:
        return fn(*args, **kwargs)
    finally:
        PHASE_SECONDS[name] = time.perf_counter() - t


# Phase orders under which whole runs once lost profiler records, when
# launches were still counted from them (ROADMAP Queue 3): the tiered
# store's phases before head_groups (PR 14's log call 6), the speculative
# phase before serve_continuous (PR 15's log call 6).
ORDERS = ("default", "tiers_before_head_groups",
          "speculative_before_serve_continuous")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--order", choices=ORDERS, default="default",
                    help="run the phases in one of the orders that once lost "
                         "profiler records")
    order = ap.parse_args(argv).order
    t_main = time.perf_counter()
    smi = timed(phase_device)
    timed(phase_build)
    kernels = timed(check_kernels)
    timed(check_window_kernel, kernels)
    timed(check_paged_kernels, kernels)
    timed(check_mesh_kernels, kernels)
    timed(phase_reference)
    timed(phase_reference_paged)
    timed(phase_reference_int8)
    timed(phase_reference_prefix)
    timed(phase_reference_priority)
    timed(phase_reference_roles)
    timed(phase_reference_fleet)
    timed(phase_reference_telemetry)
    timed(phase_reference_families)
    timed(phase_reference_speculative)
    timed(phase_reference_parallel)
    eng, bf16 = timed(phase_engine, kernels)
    timed(phase_profile, eng)
    timed(phase_serve, eng)
    params = eng.params
    del eng
    torch.cuda.empty_cache()
    if order == "speculative_before_serve_continuous":
        timed(phase_speculative, kernels)
    peng, bf16["serve_tokens"], inproc, unified = timed(
        phase_serve_continuous, params, kernels)
    timed(phase_serve_http, peng, bf16["serve_tokens"], inproc, smi)
    timed(phase_profile_paged, peng)
    timed(phase_serve_prefix, peng)
    del peng
    gc.collect()
    torch.cuda.empty_cache()
    timed(phase_serve_priority, params)
    timed(phase_serve_roles, params, unified)
    gc.collect()
    torch.cuda.empty_cache()
    timed(phase_serve_fleet, params, smi)
    gc.collect()
    torch.cuda.empty_cache()
    timed(phase_serve_telemetry, params, smi)
    gc.collect()
    torch.cuda.empty_cache()
    timed(phase_int8, params, kernels, bf16)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    timed(phase_model, "gptj_6b", dict(GPTJ_6B_HF, n_layer=MODEL_DEPTH[
        "gptj_6b"]), kernels, seed=1)
    timed(phase_model, "starcoder", dict(STARCODER_HF, n_layer=MODEL_DEPTH[
        "starcoder"]), kernels, seed=2)
    tiers_first = order == "tiers_before_head_groups"
    if tiers_first:
        timed(phase_reference_tiers)
        timed(phase_serve_tiers)
    timed(phase_head_groups)
    timed(phase_cli)
    if order != "speculative_before_serve_continuous":
        timed(phase_speculative, kernels)
    gc.collect()
    torch.cuda.empty_cache()
    # The tiered store last: its threads, pinned staging and blobs share
    # the process with no later phase.
    if not tiers_first:
        timed(phase_reference_tiers)
        timed(phase_serve_tiers)
    gc.collect()
    torch.cuda.empty_cache()
    # The mesh last: its worlds need the card's memory, and its mesh of one
    # rank is this process's only process group.
    timed(phase_parallel, bf16, kernels, smi)
    # Serving on the mesh: this process's passes and an NCCL mesh of one,
    # then a tp 2 world alone on the card. (Beside the parallel phase's
    # worlds, the ranks' weight draws outgrew the card's memory.)
    gc.collect()
    torch.cuda.empty_cache()
    timed(phase_serve_parallel, kernels, smi)
    emit({"phase": "seconds", "order": order, "by_phase": PHASE_SECONDS,
          "main_s": time.perf_counter() - t_main})
    rows = []
    for name, fn, src, replaces in (
        ("K1", "flash_attention", "llmss_tpu_torch/csrc/flash_attention.cu",
         "llmss_tpu/ops/pallas_attention.py:136"),
        ("K2", "decode_attention", "llmss_tpu_torch/csrc/decode_attention.cu",
         "llmss_tpu/ops/pallas_decode.py:181"),
        ("K3", "paged_decode_attention",
         "llmss_tpu_torch/csrc/paged_attention.cu",
         "llmss_tpu/ops/pallas_paged_decode.py:160"),
        ("K4", "ragged_paged_attention",
         "llmss_tpu_torch/csrc/paged_attention.cu",
         "llmss_tpu/ops/pallas_ragged.py:220"),
        # The int8 cache: K2 and K3 compute the reference's XLA oracles
        # with scales (the Pallas K2 / K3 take none); K4 the Pallas int8
        # branch.
        ("K2_int8", "decode_attention (int8 cache)",
         "llmss_tpu_torch/csrc/decode_attention.cu",
         "llmss_tpu/ops/attention.py:242"),
        ("K3_int8", "paged_decode_attention (int8 pool)",
         "llmss_tpu_torch/csrc/paged_attention.cu",
         "llmss_tpu/ops/attention.py:352"),
        ("K4_int8", "ragged_paged_attention (int8 pool)",
         "llmss_tpu_torch/csrc/paged_attention.cu",
         "llmss_tpu/ops/pallas_ragged.py:144"),
        # The speculative verify window: no Pallas kernel, the reference's
        # XLA oracle.
        ("K2w", "decode_window_attention",
         "llmss_tpu_torch/csrc/window_attention.cu",
         "llmss_tpu/ops/attention.py:186"),
        # The mesh: K1 and K2 at the local heads of tp 2 (the same
        # instantiations, launched by the tp = 2 ranks), and their
        # state-out forms (the sp = 2 ranks' ring prefill and LSE-merge
        # decode; new instantiations behind a compile-time flag).
        ("K1_tp", "flash_attention (tp-local heads)",
         "llmss_tpu_torch/csrc/flash_attention.cu",
         "llmss_tpu/ops/pallas_attention.py:136"),
        ("K2_tp", "decode_attention (tp-local heads)",
         "llmss_tpu_torch/csrc/decode_attention.cu",
         "llmss_tpu/ops/pallas_decode.py:181"),
        ("K1_state", "flash_attention_state",
         "llmss_tpu_torch/csrc/flash_attention.cu",
         "llmss_tpu/ops/pallas_attention.py:136"),
        ("K2_state", "decode_attention_state",
         "llmss_tpu_torch/csrc/decode_attention.cu",
         "llmss_tpu/ops/pallas_decode.py:181"),
        # Serving on the mesh: K3 and K4 at the KV heads of a tp 2 rank's
        # pool, bf16 and int8 (the same instantiations, at half the heads).
        ("K3_tp", "paged_decode_attention (tp-local heads)",
         "llmss_tpu_torch/csrc/paged_attention.cu",
         "llmss_tpu/ops/pallas_paged_decode.py:160"),
        ("K4_tp", "ragged_paged_attention (tp-local heads)",
         "llmss_tpu_torch/csrc/paged_attention.cu",
         "llmss_tpu/ops/pallas_ragged.py:220"),
        ("K3_tp_int8", "paged_decode_attention (int8 pool, tp-local heads)",
         "llmss_tpu_torch/csrc/paged_attention.cu",
         "llmss_tpu/ops/attention.py:352"),
        ("K4_tp_int8", "ragged_paged_attention (int8 pool, tp-local heads)",
         "llmss_tpu_torch/csrc/paged_attention.cu",
         "llmss_tpu/ops/pallas_ragged.py:144"),
    ):
        k = kernels[name]
        rows.append({
            "name": fn, "route": "cuda", "source": src, "replaces": replaces,
            "launches": k["launches"], "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
        })
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
