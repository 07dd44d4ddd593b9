"""Device times of the port's four kernels in one checkout, at the kernel
cases of this checkout's chip_smoke.py, timed as chip_smoke.py times them
(``device_ms``: calls captured in a CUDA graph, replays timed by CUDA
events).

    python3 kernel_ab.py [--tree DIR] [--label NAME] [--kernels K1,K2,K3,K4]
                         [--registers]

(default: those four and the int8-cache cases K2_int8,K3_int8,K4_int8;
``--registers``: build with ``-Xptxas=-v`` and print the registers and
spills of the tensor-core and lane-template instantiations first)

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
    """sha256 of a kernel output's bytes."""
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT),
                    help="checkout whose llmss_tpu_torch is timed")
    ap.add_argument("--label", default="this", help="name in every line")
    ap.add_argument("--kernels", default="K1,K2,K3,K4,K2_int8,K3_int8,K4_int8",
                    help="the kernels whose cases are timed (K2_int8, "
                         "K3_int8, K4_int8: the int8-cache cases, which an "
                         "older tree cannot run)")
    ap.add_argument("--registers", action="store_true",
                    help="build verbose and print the tensor-core and lane "
                         "kernels' registers")
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
