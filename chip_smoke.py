"""GPU smoke run of the PyTorch/CUDA port (llmss_tpu_torch) on one card.

    python3 chip_smoke.py

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
              times, the instantiation each case took ("mma": the
              tensor-core tile; "fma" / "lanes": the fp32 and CB = 1
              kernels) and, for K2 / K3, its split along the KV axis
              (flash-decoding: "splits", "split_slots") beside the same
              call launched unsplit ("unsplit_ms", checked too); K2, K3
              and K4 also over int8 caches with their scales
              ("lanes_int8"; K4 with bf16 queries at CB > 1 "mma_int8",
              the tensor-core tile over int8 tiles; library: dequantize
              + SDPA), with K2 / K3 int8 over K2 / K3 at the main path's
              decode shapes ("int8_lanes_vs_bf16", a measurement);
4. reference -- a tiny fp32 llama generates the same greedy tokens through
              the kernels on the card, decoding by CUDA-graph replays, as
              through the plain path on the CPU;
   reference_paged -- the same through the continuous batcher over the
              paged pool, with split admission and with chunked prefill;
   reference_int8 -- the same, dense and paged, over int8 caches;
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
              with generate's tokens, all with no new graph capture; the
              launch counters must rise by n_layers per prefill (K1) and
              per decode step replayed (K2);
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
   int8    -- the engine's generate (prewarmed, no capture after) and one
              chunked serving pass (a 496-block int8 pool) on int8 caches
              at Llama-2-7B width: cache bytes against bf16's (<= 0.52x),
              the share of tokens equal to the bf16 runs', and a decode
              chunk profiled (only int8 decode_fwd instantiations);
   head_groups -- Qwen2-7B (G = 7), SantaCoder (G = 16) and StarCoder
              over an int8 cache (G = 48) at full width, 2 layers: prewarm,
              generate, and the dense and paged decode steps profiled
              (graph and eager) with the decode template each takes;
   gptj_6b, starcoder -- the published configs of EleutherAI/gpt-j-6b
              (D 256, untied biased head) and bigcode/starcoder (48 query
              heads on one KV head, learned positions) at full width and
              depth, random bf16 weights from a seed: prewarm, generate
              twice (identical tokens, launch counts, no capture), prefill
              and decode chunk profiled against the weight-read bound, a
              split and a chunked ContinuousWorker pass, a paged decode
              group and a ragged group profiled, and each kernel's case
              at the model's shapes beside its launches;
7. cli     -- writes a 2-layer llama checkpoint at 1b2 width
              (safetensors + config.json) and runs the port's CLI on it;
              then 2-layer GPT-J-6B and StarCoder checkpoints in HF names
              and layouts (StarCoder's c_attn fused), each through the CLI
              and load_model, the loaded tensors held to the written
              ones.

Then one JSON line with every kernel's numbers, the nvidia-smi line, and
last the result line {"ok": true, "device": {...}}.

Kernel and library times are device times of one call from CUDA-graph
replays (``device_ms``); plain versions' times are summed kernel
durations from torch.profiler (``profiled_ms``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import gc
import json
import math
import os
import re
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch

# The port itself; a copy of this script without the package fails here.
import llmss_tpu_torch  # noqa: F401

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
    name = r"(?:(?:flash|paged|decode)_(?:mma|fwd)|split_merge)"
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
    """The tensor-core instantiations' registers and spills."""
    return [{"kernel": k, "registers": r, "spill_store_bytes": sp}
            for k, sp, r in ptxas_entries(text) if "_mma" in k]


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
    emit({"phase": "build", "seconds": round(secs, 3),
          "sources": sorted(out), "max_registers": max(regs, default=None),
          "kernels_with_spills": sum(1 for n in spills if n > 0),
          "mma_instantiations": mma_registers(text),
          "decode_instantiations": [
              {"kernel": k, "registers": r, "spill_store_bytes": sp}
              for k, sp, r in entries if "_mma" not in k
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
    """The template a decode call (K2, K3) must take: the tensor-core tile
    for bf16 queries with more than G_TILE query heads per KV head, the
    lanes for fewer and for fp32 queries."""
    from llmss_tpu_torch.ops import split_plan as sp

    tile = q.dtype == torch.bfloat16 and q.shape[2] // Hkv > sp.G_TILE
    return ("mma" if tile else "lanes") + ("_int8" if int8 else "")


# Where the run times both decode templates, forced, on the same call: the
# K2 and K3 cases at G = 1, 4, 7 and 8 (the plan's lanes), 16 and 48 (its
# tile), so that the run itself shows where G_TILE belongs.
G_TILE_CASES = {1: ("k2_engine_decode", "k3_serve_decode"),
                4: ("k2_gqa", "k3_gqa"),
                7: ("k2_qwen2_full_wrap", "k3_qwen2_serve_decode"),
                8: ("k2_g8_engine_decode", "k3_g8_serve_decode"),
                16: ("k2_santacoder_window", "k3_santacoder_window"),
                48: ("k2_starcoder_engine_decode", "k3_starcoder_serve_decode")}
FORCE = {"lanes_ms": 1 << 30, "tile_ms": 0}  # g_tile forcing each template


def _both_templates(row, fn, check) -> None:
    """``fn(g_tile)`` forced onto the lanes and onto the tile: each output
    held within REL_TOL by ``check``, each timed into ``row``."""
    for key, g_tile in FORCE.items():
        check(fn(g_tile))
        row[key] = device_ms(lambda: fn(g_tile), iters=50)


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
    from llmss_tpu_torch.ops import _build
    from llmss_tpu_torch.ops import attention as att
    from llmss_tpu_torch.ops import decode_attention as da
    from llmss_tpu_torch.ops import flash_attention as fa

    out = {}
    worst = 0.0
    for c in k1_cases():
        args = (c["q"], c["k"], c["v"], c["qp"], c["kvp"])
        kw = dict(window=c["window"])
        got = fa.flash_attention(*args, **kw).float()
        q32, k32, v32 = c["q"].float(), c["k"].float(), c["v"].float()
        ref = fa.flash_attention_ref(q32, k32, v32, c["qp"], c["kvp"], **kw)
        ref_abs = fa.flash_attention_ref(q32, k32, v32.abs(), c["qp"],
                                         c["kvp"], **kw)
        err, ratio = _agree("K1", c["name"], got, ref, ref_abs, c["q"].dtype)
        worst = max(worst, err)
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
        row = {"phase": "kernel", "kernel": "K1", "case": c["name"],
               "impl": fa.kernel_plan(c["q"].dtype, D)[0],
               "max_abs_err": err, "rel_tol": REL_TOL[c["q"].dtype],
               "err_over_tol": ratio,
               "ms": device_ms(lambda: fa.flash_attention(*args, **kw)),
               "plain_ms": profiled_ms(
                   lambda: fa.flash_attention_ref(*args, **kw), iters=5),
               "library_ms": device_ms(
                   lambda: _sdpa(c["q"], c["k"], c["v"], mask[:, None])),
               "bound_ms": b_ms, "bound_by": b_by}
        out.setdefault("K1", row)
        out.setdefault("cases", {})[c["name"]] = row
        if c["name"] in ("k1_engine_prefill", "k1_7b_padded",
                         "k1_gptj_prefill", "k1_starcoder_prefill"):
            _main_path_impl("K1", row)
        if c["name"] in ("k1_engine_prefill", "k1_7b_padded", "k1_7b_long",
                         "k1_gptj_prefill", "k1_starcoder_prefill"):
            out.setdefault("vs_library", {})[c["name"]] = (
                row["ms"], row["library_ms"])
        emit(row)
    out["K1"]["max_abs_err"] = worst

    worst_of = {}
    for c in k2_cases():
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
            _both_templates(
                row, lambda g_tile: da._launch(*args, g_tile=g_tile, **kw),
                lambda g: _agree("K2", c["name"] + " forced", g.float(), ref,
                                 ref_abs, c["q"].dtype))
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


def _paged_case(name, B, Hq, Hkv, ctx, qlens, CB, *, n_cols=None, window=None,
                seed=0, L=2, D=128, bs=16, MB=64, dt=torch.bfloat16, kv=None):
    """Attention over layer L-1 of a block pool for rows whose histories
    are positions 0..ctx[b]-1 (ring order), each with a CB-token chunk of
    which qlens[b] are live, starting at position ctx[b]. Each row's blocks
    are scattered over the pool; table columns past them are sentinels.
    Every pending slot that still holds a visible old position (the chunk
    overwrites it on a ring wrap) gets a key 4x the group's first query
    head at that query and values of 8: a kernel that kept it would miss
    by ~8. ``kv="int8"``: the pool quantized, with its scales."""
    rng = np.random.default_rng(seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev, ring = "cuda", MB * bs
    need = [MB if c + q > ring else max(1, -(-(c + q) // bs))
            for c, q in zip(ctx, qlens)]
    N = sum(need) + 3
    perm = rng.permutation(N)
    bt = np.full((B, MB), N, np.int32)
    k = 0
    for b, n in enumerate(need):
        bt[b, :n] = perm[k:k + n]
        bt[b, n:] = N + b  # sentinels (>= N)
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
        layer=L - 1, n_cols=n_cols, window=window, planted=planted), "kp", "vp")


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
        # SantaCoder's G = 16 under a window; G = 48 with wrapped rows, an
        # empty row and sentinel columns, and with rows whose occupied
        # slots end in their first split beside a long row and an empty one.
        _paged_case("k3_santacoder_window", 4, 16, 1, [900, 300, 1000, 20],
                    [1] * 4, 1, window=256, seed=22),
        _paged_case("k3_starcoder_wrap_empty_sentinel", 4, 48, 1,
                    [1500, 0, 2047, 77], [1] * 4, 1, seed=23),
        _paged_case("k3_starcoder_first_split_only", 4, 48, 1,
                    [1000, 60, 0, 30], [1] * 4, 1, seed=24),
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
    ]
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
    ] if int8 else [])


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
    and (``forced_fn(c, g_tile)``) both decode templates'. Returns (row,
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
    slots = int(mask.any(1).sum().item())
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
    row = {"phase": "kernel", "kernel": kernel, "case": c["name"],
           "kv": str(c["kp"].dtype).removeprefix("torch."),
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
        _both_templates(row, lambda g_tile: forced_fn(c, g_tile),
                        lambda g: _agree(kernel, c["name"] + " forced",
                                         g.float()[live], ref[live],
                                         ref_abs[live], dt))
    emit(row)
    return row, got


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

    def k3_forced(c, g_tile):
        return k3_unsplit(c, g_tile=g_tile)

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

    for c in k4_cases():
        row, _ = _paged_row("K4", c, k4, k4_ref, _gather_sdpa)
        # bf16 queries over an int8 pool at CB > 1: the int8 tensor-core
        # tile; fp32 queries stay on the lanes.
        if c["ks"] is not None:
            _main_path_impl("K4", row, "mma_int8" if c["q"].dtype
                            == torch.bfloat16 else "lanes_int8")
        if c["name"] in ("k4_gptj_serve_mixed", "k4_starcoder_serve_mixed"):
            _main_path_impl("K4", row)
        worst[c["row"]] = max(worst.get(c["row"], 0.0), row["max_abs_err"])
        out.setdefault(c["row"], row)
        out["cases"][c["name"]] = row
    _main_path_impl("K4", out["K4"])
    for name, err in worst.items():
        out[name]["max_abs_err"] = err
    for name in ("K4", "K4_int8"):
        out["vs_library"][out[name]["case"]] = (out[name]["ms"],
                                                out[name]["library_ms"])
    for name in ("k3_starcoder_serve_decode", "k3_int8_starcoder_serve_decode",
                 "k4_ring_wrap"):
        row = out["cases"][name]
        out["vs_library"][name] = (row["ms"], row["library_ms"])
    # A measurement, not a pass condition: kernel times vary by card.
    emit({"phase": "kernel", "check": "mma_below_library",
          "cases": {k: {"ms": a, "library_ms": b}
                    for k, (a, b) in out["vs_library"].items()},
          "all_below": all(a < b for a, b in out["vs_library"].values())})
    # A measurement: both decode templates at each G of G_TILE_CASES,
    # forced, beside the plan's choice (G_TILE).
    from llmss_tpu_torch.ops import split_plan as sp

    emit({"phase": "kernel", "check": "g_tile_lanes_vs_tile", "G_TILE": sp.G_TILE,
          "cases": {f"{k}_G{G}": {
              "case": name, "impl": out["cases"][name]["impl"],
              **{key: out["cases"][name][key] for key in FORCE},
              "tile_faster": out["cases"][name]["tile_ms"]
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
        for k in ("K2", "K3")}})


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


def _check_logits(eng, prompts) -> None:
    """Logits of the main path (a prefill, then one decode step) are
    finite and of the expected shape."""
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

    _check_logits(eng, prompts)

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
    return eng, {"tokens": a, "cache_bytes": mem["cache_bytes"]}


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


def _profile_row(what, fn, path=None, count=()) -> tuple[dict, object]:
    """Where the time of ``fn`` goes: after a warm call, wall time without
    the profiler (and the host's enqueue time, to the return of ``fn``),
    then summed kernel time, the top kernels and the calls of the kernels
    whose names hold a ``count`` symbol, from a profiled call; the idle
    share is 1 - kernel time / wall time. Returns (row, the timed call's
    result)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
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
           "kernels": sum(r[2] for r in rows),
           "kernel_calls": {c: _calls(rows, c) for c in count},
           "kernel_ms_of": {c: _calls(rows, c, ms=True) for c in count},
           "top": [{"kernel": k[:80], "ms": us / 1e3, "calls": n}
                   for us, k, n in rows[:8]]}
    emit(row)
    return row, out


def _graph_vs_eager(eng, what, tok, cache, cur, sa, done, eos, *, n_chunks,
                    n_steps, t_bucket) -> None:
    """One decode group by graph replays (the engine's path) beside the
    same steps run eagerly over the same buffers, each call from the same
    state (the cache's positions put back: the KV a call wrote is then
    masked again); both must give the same packed tokens, and the profiler
    must see both launch the decode kernel n_layers times a step, and its
    merge as often when the plan splits. The engine's captured step graph
    must keep each merge a programmatic dependent launch."""
    from llmss_tpu_torch.engine.cache import PagedKVCache
    from llmss_tpu_torch.ops import split_plan as sp

    pos0 = cache.positions.clone()
    plan = _decode_plan(eng, cache, t_bucket)
    kernel = ("paged" if isinstance(cache, PagedKVCache) else "decode") + (
        "_mma" if plan.impl in sp.TILE_IMPLS else "_fwd")

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
    want_calls = {kernel: L * steps, "split_merge": merges * steps}
    if cache.quantized:
        want_calls[f"int8:{kernel}"] = L * steps
    retries = {}

    def profile(path, fn):
        # The profiler can lose a kernel record out of ~30,000 (an eager
        # group once counted 511 of its 512 identical launches): a count
        # that misses is profiled again, twice at most. A path that really
        # launches otherwise misses every time and fails below.
        for attempt in range(3):
            row, out = _profile_row(what, fn, path, count)
            if row["kernel_calls"] == want_calls:
                break
        retries[path] = attempt
        return row, out

    g_row, g_out = profile("graph", graph)
    e_row, e_out = profile("eager", eager)
    same = torch.equal(g_out, e_out)
    step = eng._graphs.for_cache(cache).steps[
        eng._step_key("fold", sa, t_bucket)]
    edges = _programmatic_edges(step.graph)
    emit({"phase": "profile", "what": what, "check": "graph_equals_eager",
          "identical": same,
          "wall_ratio_eager_over_graph": e_row["wall_ms"] / g_row["wall_ms"],
          "kernel_ms_ratio_graph_over_eager": (
              g_row["device_kernel_ms"] / e_row["device_kernel_ms"]),
          "kernel_calls_graph": g_row["kernel_calls"],
          "kernel_calls_eager": e_row["kernel_calls"],
          "kernel_calls_want": want_calls,
          "step_graph_edges": edges[1], "programmatic_edges": edges[0],
          "split_merges_per_step": merges, "decode_impl": plan.impl,
          "profile_retries": retries,
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
        if row["kernel_calls"] != want_calls:
            raise AssertionError(f"{what}: the {path} path's profile shows "
                                 f"{row['kernel_calls']}, want {want_calls}")
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


def _count_steps(eng):
    """Wrap the engine's grouped programs to count the decode steps and
    ragged steps they run; returns the counter dict."""
    n = {"decode": 0, "ragged": 0}
    decode_group, ragged_group = eng._decode_group, eng._ragged_group

    def counted_decode(*a, n_steps, n_chunks=1, **kw):
        n["decode"] += n_steps * n_chunks
        return decode_group(*a, n_steps=n_steps, n_chunks=n_chunks, **kw)

    def counted_ragged(*a):
        n["ragged"] += a[6].shape[0]  # ids_seq [nc, B, CB]
        return ragged_group(*a)

    eng._decode_group, eng._ragged_group = counted_decode, counted_ragged
    return n


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
    steps = _count_steps(eng)
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

    split, c_split, _ = run(False)
    chunk, c_chunk, _ = run(True)
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
    return eng, chunk, again_row


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
    steps = _count_steps(eng)
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


def phase_profile_paged(eng, tag: str = "") -> None:
    """Where the time goes on the serving path: one paged decode group
    (2 chunks x 8 steps) by graph replays and eagerly, and one ragged group
    (4 steps, two rows feeding 128-token chunks beside six decode rows,
    eager) over 8 rows of the serve engine. Over an int8 pool (rows named
    ``tag`` first) every ``paged_fwd`` the profiler sees must be an int8
    instantiation, and the ragged group must run K4 only as the int8
    tensor-core tile (``paged_mma`` over int8): n_layers per step, and no
    ``paged_fwd``."""
    from llmss_tpu_torch.engine.engine import GenerationParams

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
    count = ("paged_fwd", "paged_mma", "int8:paged_mma") if cache.quantized \
        else ()
    row, _ = _profile_row(
        tag + "ragged_group_4_steps",
        lambda: eng._ragged_group(tok, cache, cur, sa, done, eos, *xs),
        count=count)
    want = eng.cfg.n_layers * nc
    if count and row["kernel_calls"] != {"paged_fwd": 0, "paged_mma": want,
                                         "int8:paged_mma": want}:
        raise AssertionError(f"{tag}ragged group: {row['kernel_calls']}, "
                             f"want {want} int8 paged_mma and no other")


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
    # captures): the profiler must see only the int8 decode_fwd.
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
    steps = _count_steps(peng)
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
    """A published configuration at full width and depth through the
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
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    kv_token = 2 * L * cfg.n_kv_heads * cfg.head_dim * 2
    blocks = POOL_BYTES // (16 * kv_token)
    peng = DecodeEngine(cfg, params, max_seq_len=1024, kv_layout="paged",
                        block_size=16, kv_blocks=blocks)
    steps = _count_steps(peng)
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
    Qwen2-7B (G = 7: K2 on the lanes with one group of 8 per KV head, K3
    on one R = 8 lane tile), SantaCoder (G = 16: the tile) and StarCoder
    over an int8 cache (G = 48: the tile over int8 tiles). Each: prewarm,
    ``generate`` at batch 4 (K2 n_layers per replayed step, no capture
    after prewarm), the decode chunk profiled (graph and eager, the
    template's kernel and its merges counted), then a paged engine's
    decode group profiled the same way (K3) and its ragged group."""
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
    if [len(o) for o in out] != [8, 8] or not all(
            0 <= t < V for o in out for t in o):
        raise AssertionError(f"CLI returned {out}")
    emit({"phase": "cli", "rows": len(out), "tokens": out})
    for name, hf in (("gptj_6b", GPTJ_6B_HF), ("starcoder", STARCODER_HF)):
        emit({"phase": "cli", "model": f"{name}, 2 layers",
              **_cli_family(name, hf)})
        gc.collect()
        torch.cuda.empty_cache()


def main() -> int:
    smi = phase_device()
    phase_build()
    kernels = check_kernels()
    check_paged_kernels(kernels)
    phase_reference()
    phase_reference_paged()
    phase_reference_int8()
    phase_reference_families()
    eng, bf16 = phase_engine(kernels)
    phase_profile(eng)
    phase_serve(eng)
    params = eng.params
    del eng
    torch.cuda.empty_cache()
    peng, bf16["serve_tokens"], inproc = phase_serve_continuous(params,
                                                                kernels)
    phase_serve_http(peng, bf16["serve_tokens"], inproc, smi)
    phase_profile_paged(peng)
    del peng
    gc.collect()
    torch.cuda.empty_cache()
    phase_int8(params, kernels, bf16)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    phase_model("gptj_6b", GPTJ_6B_HF, kernels, seed=1)
    phase_model("starcoder", STARCODER_HF, kernels, seed=2)
    phase_head_groups()
    phase_cli()
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
