"""Device times of the port's kernels in one checkout, at the kernel
cases of this checkout's chip_smoke.py, timed as chip_smoke.py times them
(``device_ms``: calls captured in a CUDA graph, replays timed by CUDA
events).

    python3 kernel_ab.py [--tree DIR] [--label NAME] [--kernels K1,K2,K3,K4]
                         [--registers] [--k2w-forms] [--templates]
                         [--k1-forms]

(default: those four, the int8-cache cases K2_int8,K3_int8,K4_int8 and
K2w, the speculative verify window's cases; ``--registers``: build with
``-Xptxas=-v`` and print the registers and spills of the tensor-core and
lane-template instantiations first; ``--k2w-forms``: time instead each
bf16 K2w case at 1, 2, 4 and 8 forced splits, folded in its cluster and
by window_merge, the data K2w's split plan was set from; ``--templates``:
time instead K2 and K3 at chip_smoke.G_TILE_CASES on each of the three
decode templates, forced (the lanes, the 64-row tile, the group tile),
and the group tile at 1, 2, 4, 8 and 16 forced splits folded by the merge:
the data G_TILE and the group tile's plan were set from; and K4's bf16-
query cases on the chunk tile at 1, 2, 4 and 8 forced splits, the data
its split plan was set from; the cases of the kernels ``--kernels`` names;
a tree with the chunk tile only; ``--k1-forms``: time instead each bf16 /
f16 K1 case on the wgmma tile at 128 and 64 rows a block, forced, the
data ``flash_attention.wgmma_rows`` was set from)

The cases include K2 and K3 at StarCoder's G = 48 (bf16 and int8), Qwen2-
7B's G = 7, SantaCoder's G = 16 and G = 8, so a tree's decode templates
are timed at every head-group shape beside the Llama-2-7B and GPT-J ones.

``--tree`` is a checkout of the repo whose ``llmss_tpu_torch`` is built
and timed (default: this one). The cases and the timer always come from
this checkout, so two trees timed by it differ only in their package. To
compare two trees, run them in turns on one card (A, B, B, A). Prints the
device line (with the card's name and power limit), one JSON line per
case, and last a JSON line with every case's ms and the sha256 of its
output's bytes (equal digests: the two trees' kernels agree bit for bit on
that case); exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent


def _scales(c):
    """An int8 case's scale arguments; none for a case over a cache of the
    query's dtype, so a tree without the int8 cache times those too."""
    return {} if c["ks"] is None else dict(k_scale=c["ks"], v_scale=c["vs"])


def digest(out) -> str:
    """sha256 of a kernel output's bytes (of a state-out form's m, l and
    acc, in that order)."""
    if isinstance(out, tuple):
        out = torch.cat([t.reshape(-1) for t in out])
    raw = out.contiguous().view(-1).view(torch.uint8).cpu().numpy()
    return hashlib.sha256(raw.tobytes()).hexdigest()


def _cases(cs, da, fa, pa, kernels):
    """(kernel, case, one call, graph iterations) for every case of the
    named kernels (``K2_int8``, ``K3_int8``, ``K4_int8``: the int8-cache
    cases, made only when named); the cases of the others are not
    timed."""
    if "K1" in kernels:
        for c in cs.k1_cases():
            yield "K1", c["name"], (
                lambda c=c: fa.flash_attention(c["q"], c["k"], c["v"], c["qp"],
                                               c["kvp"], window=c["window"])), 20
        c = cs.k1_state_case()
        yield "K1_state", c["name"], (
            lambda c=c: fa.flash_attention_state(c["q"], c["k"], c["v"],
                                                 c["qp"], c["kvp"])), 20
    wanted = {"K2", "K2_int8"} & set(kernels)
    for c in cs.k2_cases("K2_int8" in kernels) if wanted else ():
        if c["row"] in kernels:
            yield c["row"], c["name"], (
                lambda c=c: da.decode_attention(
                    c["q"], c["kc"], c["vc"], c["kn"], c["vn"], c["qpos"],
                    c["kvp"], c["slots"], c["layer"], t_len=c["t_len"],
                    window=c["window"], **_scales(c))), 50
    wanted = {"K3", "K3_int8"} & set(kernels)
    for c in cs.k3_cases("K3_int8" in kernels) if wanted else ():
        if c["row"] in kernels:
            yield c["row"], c["name"], (
                lambda c=c: pa.paged_decode_attention(
                    c["q"], c["kp"], c["vp"], c["kn"], c["vn"],
                    c["qpos"][:, None], c["kvp"], c["bt"], c["nblk"],
                    c["slot0"][:, None], c["layer"], n_cols=c["n_cols"],
                    window=c["window"], **_scales(c))), 50
    wanted = {"K4", "K4_int8"} & set(kernels)
    for c in cs.k4_cases("K4_int8" in kernels) if wanted else ():
        if c["row"] in kernels:
            yield c["row"], c["name"], (
                lambda c=c: pa.ragged_paged_attention(
                    c["q"], c["kp"], c["vp"], c["kn"], c["vn"], c["qpos"],
                    c["qlen"], c["kvp"], c["bt"], c["nblk"], c["slot0"],
                    c["layer"], n_cols=c["n_cols"], window=c["window"],
                    **_scales(c))), 50
    if "K2w" in kernels:
        for c in cs.k2w_cases():
            yield "K2w", c["name"], (
                lambda c=c: da.decode_window_attention(
                    c["q"], c["kc"], c["vc"], c["kn"], c["vn"], c["q0"],
                    c["kvp"], c["slots"], c["layer"], t_len=c["t_len"])), 50


# Splits a K4 call at CB > 1 is forced onto by --templates (1: the chunk
# tile unsplit).
K4_SPLITS = (1, 2, 4, 8)


def _templates(cs, da, pa, tag, kernels) -> None:
    """One line per G_TILE case of K2 and K3 (``K2`` / ``K3`` in
    ``kernels``): the three decode templates, forced, and the group tile at
    most N splits (``max_splits_N``); one per K4 case on the chunk tile
    (``K4`` / ``K4_int8``): the chunk tile at each of ``K4_SPLITS`` forced
    splits (``splits_N_ms``), the data chunk_plan was set from."""
    from llmss_tpu_torch.ops import _build
    from llmss_tpu_torch.ops import split_plan as sp

    for c in cs.k4_cases("K4_int8" in kernels):
        if c["row"] not in kernels or c["q"].dtype != torch.bfloat16:
            continue
        row = {}
        for n in K4_SPLITS:
            fn = (lambda n=n: pa._launch(
                "ragged_paged_attention (K4)", c["q"], c["kp"], c["vp"],
                c["kn"], c["vn"], c["qpos"], c["qlen"], c["kvp"], c["bt"],
                c["nblk"], c["slot0"], c["layer"], c["n_cols"], None,
                c["window"], c["ks"], c["vs"], chunk_splits=n))
            row[f"splits_{n}_ms"] = cs.device_ms(fn, iters=50)
        cs.emit({"phase": "templates", **tag, "case": c["name"],
                 "plan_splits": pa.kernel_plan(
                     torch.bfloat16, c["q"].shape[1],
                     c["q"].shape[2] // c["kn"].shape[2], c["q"].shape[3],
                     B=c["q"].shape[0], Hkv=c["kn"].shape[2],
                     n_slots=(c["n_cols"] or c["bt"].shape[1]) * c["kp"].shape[2],
                     bs=c["kp"].shape[2], sms=_build.sm_count(c["q"].device),
                     kv_dtype=c["kp"].dtype).splits,
                 **row})
    names = {n for pair in cs.G_TILE_CASES.values() for n in pair}
    calls = []
    for c in cs.k2_cases(False) if "K2" in kernels else ():
        if c["name"] in names:
            calls.append((c, lambda c=c, **kw: da._launch(
                c["q"], c["kc"], c["vc"], c["kn"], c["vn"], c["qpos"],
                c["kvp"], c["slots"], c["layer"], t_len=c["t_len"],
                window=c["window"], **kw)))
    for c in cs.k3_cases(False) if "K3" in kernels else ():
        if c["name"] in names:
            calls.append((c, lambda c=c, **kw: pa._launch(
                "paged_decode_attention (K3)", c["q"], c["kp"], c["vp"],
                c["kn"], c["vn"], c["qpos"][:, None], None, c["kvp"], c["bt"],
                c["nblk"], c["slot0"][:, None], c["layer"], c["n_cols"], None,
                c["window"], **kw)))
    for c, fn in calls:
        row = {f"{f}_ms": cs.device_ms(lambda f=f: fn(force=f), iters=50)
               for f in sp.TEMPLATES}
        for n in (1, 2, 4, 8, 16):
            row[f"max_splits_{n}"] = cs.device_ms(
                lambda n=n: fn(force="group", max_splits=n), iters=50)
        cs.emit({"phase": "templates", **tag, "case": c["name"],
                 "G": c["q"].shape[2] // c["kn"].shape[2], **row})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT),
                    help="checkout whose llmss_tpu_torch is timed")
    ap.add_argument("--label", default="this", help="name in every line")
    ap.add_argument("--kernels",
                    default="K1,K2,K3,K4,K2_int8,K3_int8,K4_int8,K2w",
                    help="the kernels whose cases are timed (K2_int8, "
                         "K3_int8, K4_int8: the int8-cache cases, and K2w, "
                         "which an older tree cannot run)")
    ap.add_argument("--registers", action="store_true",
                    help="build verbose and print the tensor-core and lane "
                         "kernels' registers")
    ap.add_argument("--k2w-forms", action="store_true",
                    help="time the bf16 K2w cases at forced split counts and "
                         "folds")
    ap.add_argument("--k1-forms", action="store_true",
                    help="time the bf16 / f16 K1 cases at 128 and 64 rows a "
                         "block, forced")
    ap.add_argument("--templates", action="store_true",
                    help="time K2 / K3 at the G_TILE cases on each decode "
                         "template and the group tile at capped split "
                         "counts")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)  # imports llmss_tpu_torch from ``tree``

    import llmss_tpu_torch
    from llmss_tpu_torch.ops import _build
    from llmss_tpu_torch.ops import decode_attention as da
    from llmss_tpu_torch.ops import flash_attention as fa
    from llmss_tpu_torch.ops import paged_attention as pa

    if Path(llmss_tpu_torch.__file__).resolve().parent.parent != tree:
        raise RuntimeError(f"llmss_tpu_torch came from {llmss_tpu_torch.__file__}")
    cs.phase_device()
    secs, out = _build.build_all(verbose=args.registers)
    tag = {"label": args.label, "tree": str(tree)}
    cs.emit({"phase": "build", **tag, "seconds": round(secs, 3),
             **({"instantiations": [
                 {"kernel": k, "registers": r, "spill_store_bytes": sp}
                 for k, sp, r in cs.ptxas_entries("\n".join(out.values()))
                 if "split_merge" not in k]} if args.registers else {})})
    if args.k2w_forms:
        for c in cs.k2w_cases():
            if c["q"].dtype != torch.bfloat16:
                continue
            args_ = (c["q"], c["kc"], c["vc"], c["kn"], c["vn"], c["q0"],
                     c["kvp"], c["slots"], c["layer"])
            row = {"plan": da.window_plan(
                torch.bfloat16, c["q"].shape[0], c["q"].shape[2],
                c["kc"].shape[3], c["q"].shape[3], c["t_len"],
                c["q"].shape[1], sms=_build.sm_count(c["q"].device))._asdict()}
            for n in (1, 2, 4, 8):
                for fold, clu in (("cluster", True), ("two_launch", False)):
                    row[f"{fold}_{n}"] = cs.device_ms(
                        lambda: da._launch_window(
                            *args_, t_len=c["t_len"], splits=n, cluster=clu),
                        iters=50)
            cs.emit({"phase": "k2w_forms", **tag, "case": c["name"], **row})
        return 0
    if args.k1_forms:
        for c in cs.k1_cases():
            if c["q"].dtype == torch.float32:
                continue
            B, S, Hq, D = c["q"].shape
            Hkv = c["k"].shape[2]
            row = {"plan_rows": fa.wgmma_rows(B, S, Hq // Hkv, Hkv,
                                              _build.sm_count(c["q"].device)),
                   "blocks_at_128": B * Hkv * -(-S * (Hq // Hkv) // 128)}
            for r in fa.WGMMA_ROWS:
                fn = (lambda r=r: fa._launch(c["q"], c["k"], c["v"], c["qp"],
                                             c["kvp"], window=c["window"],
                                             rows=r))
                row[f"rows_{r}_ms"] = cs.device_ms(fn)
                row[f"rows_{r}_digest"] = digest(fn())
            cs.emit({"phase": "k1_forms", **tag, "case": c["name"], **row})
        return 0
    if args.templates:
        _templates(cs, da, pa, tag, args.kernels.split(","))
        return 0
    times, digests = {}, {}
    for kernel, case, fn, iters in _cases(cs, da, fa, pa,
                                               args.kernels.split(",")):
        digests[case] = digest(fn())
        ms = cs.device_ms(fn, iters=iters)
        times[case] = ms
        cs.emit({"phase": "kernel", **tag, "kernel": kernel, "case": case,
                 "ms": ms, "digest": digests[case]})
    print(json.dumps({"ab": {**tag, "ms": times, "digest": digests}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
