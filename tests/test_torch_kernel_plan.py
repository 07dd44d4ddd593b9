"""The kernels' host-side plan on the CPU: which instantiation each call
takes, the shared memory it needs, what the wrappers refuse, that every
CUDA source is built and declared with its C signature, and torch
emulations of the tensor-core instantiations' rounding held to the card's
tolerance and, over an int8 pool, to the plain version and the Pallas int8
branch.

The tensor-core instantiation (csrc/attn_tile.cuh) runs a per-64-slot-tile
online softmax and rounds every P to bf16 before P.V, the chunk's fresh
keys included (they are trailing tiles of the same loop; the Pallas
kernel applies fresh V in fp32). ``chip_smoke.REL_TOL`` bounds a kernel
element's error by REL_TOL[dtype] times its row's softmax-weighted mean
|v|, a derivation that assumes every P is rounded. The emulation below
shows that bound holding at the main path's K4 and K1 GQA shapes (cut to
2 KV heads), on bf16 inputs from a seed, against the fp32 plain versions.

Over an int8 pool (csrc/attn_tile_i8.cuh, ``"mma_int8"``) the tiles are
widened to bf16 (exact), each score is scaled by its slot's K scale, and
P' = P x v_scale enters P.V as two bf16 terms, hi = bf16(P') and lo =
bf16(P' - hi), which carry it to 2^-16 relative. Its emulation is held to
the plain version with scales and to the Pallas int8 branch (interpret
mode) within 2^-12 of the row's weighted |v| before the output rounding;
one bf16 rounding of P' (the bf16 tile's arithmetic) misses that bound.
"""

import ctypes
import os
import re
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from llmss_tpu.ops import pallas_ragged
from llmss_tpu_torch.engine import graphs
from llmss_tpu_torch.engine.cache import gather_block_view, quantize_kv
from llmss_tpu_torch.ops import _build
from llmss_tpu_torch.ops import attention as tatt
from llmss_tpu_torch.ops import decode_attention as da
from llmss_tpu_torch.ops import flash_attention as fa
from llmss_tpu_torch.ops import paged_attention as pa
from llmss_tpu_torch.ops import split_plan as sp

NEG = float(torch.finfo(torch.float32).min)


# -- instantiation choice -----------------------------------------------------


@pytest.mark.parametrize("dtype, want", [
    (torch.bfloat16, "wgmma"), (torch.float16, "wgmma"), (torch.float32, "fma"),
])
@pytest.mark.parametrize("D", fa.HEAD_DIMS)
def test_k1_plan_follows_the_dtype(dtype, want, D):
    assert fa.kernel_plan(dtype, D)[0] == want


def test_k1_plan_refuses_other_dtypes():
    with pytest.raises(_build.KernelError, match="bf16, f16 or fp32"):
        fa.kernel_plan(torch.int8, 128)


@pytest.mark.parametrize("dtype, CB, want", [
    (torch.float32, 1, "lanes"),  # K3
    (torch.float32, 128, "lanes"),  # fp32 on the tensor cores would be TF32
    (torch.bfloat16, 1, "lanes"),  # K3, and K4 all-decode: bit-identical
    (torch.bfloat16, 2, "mma"),
    (torch.bfloat16, 128, "mma"),
])
@pytest.mark.parametrize("G", [1, 4])
def test_k3_k4_plan_follows_dtype_and_chunk(dtype, CB, want, G):
    if (dtype, CB) == (torch.bfloat16, 1) and G >= sp.G_TILE:
        want = "group"  # bf16 decode at a GQA head group: the group tile
    assert pa.kernel_plan(dtype, CB, G, 128)[0] == want


def _want_decode(dtype, kv_dtype, G, CB=1):
    """The instantiation a K2 / K3 / K4 call takes: at CB > 1 the 64-row
    tile (int8 form over an int8 pool) for bf16 queries; at decode, bf16
    queries over a bf16 cache take the group tile from G_TILE query heads
    per KV head (the 64-row tile above GROUP_MAX_G), over an int8 cache the
    64-row tile's int8 form above 8; fp32 queries and the rest the lanes."""
    i8 = "_int8" if kv_dtype == torch.int8 else ""
    if dtype != torch.bfloat16:
        return "lanes" + i8
    if CB > 1:
        return "mma" + i8
    if i8:
        return "mma_int8" if G > sp.INT8_G_TILE else "lanes_int8"
    if G < sp.G_TILE:
        return "lanes"
    return "group" if G <= sp.GROUP_MAX_G else "mma"


@pytest.mark.parametrize("CB", [1, 128])
@pytest.mark.parametrize("kv", ["query's", "int8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("G", [1, 4, 7, 8, 16, 48])
def test_decode_plan_follows_the_head_group(G, dtype, kv, CB):
    """K3 / K4 and, at CB == 1, K2: bf16 queries take the chunk tile at
    CB > 1 (its shared memory ``chunk_smem_bytes``, the read split by
    ``chunk_plan`` and merged when split); at decode the group tile over a bf16 cache
    from G_TILE to GROUP_MAX_G query heads per KV head (``group_rows(G)``
    heads a block, split into whole 64-slot tiles at one block per SM,
    merged), the 64-row tile above, and over an int8 cache the 64-row
    tile's int8 form above 8 (64 heads a block, split into whole tiles,
    always merged); fp32 queries and fewer heads take the lanes. Every
    plan's shared memory fits."""
    kv_dtype = torch.int8 if kv == "int8" else dtype
    Hkv = max(1, 8 // G)
    plan = pa.kernel_plan(dtype, CB, G, 128, B=8, Hkv=Hkv, n_slots=832, bs=16,
                          kv_dtype=kv_dtype)
    want = _want_decode(dtype, kv_dtype, G, CB)
    assert plan.impl == want
    assert plan.smem <= _build.SMEM_LIMIT
    group = want == "group"
    tile = want in sp.TILE_IMPLS
    if tile and CB > 1:
        assert plan.smem == _build.chunk_smem_bytes(128, kv == "int8")
    elif tile:
        assert plan.smem == (_build.tile_i8_smem_bytes(128) if kv == "int8"
                             else _build.tile_smem_bytes(128))
    if group:
        rw = sp.group_warps(G)[0]
        assert plan.smem == _build.window_tile_smem_bytes(128, rw)
    if CB > 1:
        if tile:
            assert plan[2:] == sp.chunk_plan(832, 16, B=8, Hkv=Hkv)
            assert plan.splits > 1 and sp.merges(plan, CB)
        else:
            assert plan.splits == 1 and not sp.merges(plan, CB)
        return
    if group:
        assert plan[2:] == sp.split_plan(
            8, Hkv * -(-G // sp.group_rows(G)), 832, 16, step=sp.TILE_STEP,
            sms=sp.H100_SMS, per_sm=sp.GROUP_PER_SM)
        assert sp.merges(plan)
    else:
        blocks = Hkv * (-(-G // 64) if tile else -(-G // pa._rows_per_block(G)))
        step = sp.TILE_STEP if tile else sp.lane_step(128)
        assert plan[2:] == sp.split_plan(8, blocks, 832, 16, step=step,
                                         sms=sp.H100_SMS)
        assert sp.merges(plan) == (tile or plan.splits > 1)
    k2 = da.kernel_plan(dtype, 4, Hkv * G, Hkv, 128, 192, kv_dtype=kv_dtype)
    assert k2.impl == plan.impl and k2.smem <= _build.SMEM_LIMIT
    if group:
        assert k2[2:] == sp.split_plan(
            4, Hkv * -(-G // sp.group_rows(G)), 192, step=sp.TILE_STEP,
            sms=sp.H100_SMS, per_sm=sp.GROUP_PER_SM)
    else:
        blocks = Hkv * (1 if tile else -(-G // da._heads_per_block(G)))
        assert k2[2:] == sp.split_plan(4, blocks, 192, step=step,
                                       sms=sp.H100_SMS)


def test_g_tile_forces_either_template():
    """``force`` puts a bf16 decode on any of the three templates whatever
    G (chip_smoke.py times the three at G = 1, 2, 3, 4, 7, 8, 16 and 48);
    unforced, the group tile takes G_TILE <= G <= GROUP_MAX_G, G_TILE set
    from those times on the H100 (PERF.md). fp32 queries stay on the
    lanes, and an int8 cache has no group tile."""
    assert (sp.G_TILE, sp.GROUP_MAX_G, sp.INT8_G_TILE) == (2, 16, 8)
    kw = dict(B=8, Hkv=1, n_slots=832, bs=16)
    for G in (1, 2, 3, 4, 7, 8, 16, 48):
        for force in sp.TEMPLATES:
            assert pa.kernel_plan(torch.bfloat16, 1, G, 128, force=force,
                                  **kw).impl == force
            assert da.kernel_plan(torch.bfloat16, 4, G, 1, 128, 192,
                                  force=force).impl == force
        unforced = pa.kernel_plan(torch.bfloat16, 1, G, 128, **kw).impl
        assert unforced == ("lanes" if G < 2 else "group" if G <= 16 else "mma")
        assert pa.kernel_plan(torch.bfloat16, 1, G, 128, force="mma",
                              kv_dtype=torch.int8, **kw).impl == "mma_int8"
        with pytest.raises(_build.KernelError):
            pa.kernel_plan(torch.bfloat16, 1, G, 128, force="group",
                           kv_dtype=torch.int8, **kw)
    assert pa.kernel_plan(torch.float32, 1, 48, 128, force="mma").impl == "lanes"


@pytest.mark.parametrize("kv", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("G", [1, 2, 3, 4, 5, 6, 7, 8, 16, 48])
def test_decode_tile_by_head_group(G, kv):
    """``decode_tile`` at G 1-8, 16 and 48: over a bf16 cache the group
    tile from G_TILE, over an int8 cache the 64-row tile's int8 form above
    INT8_G_TILE (8), as before the group tile; fp32 queries never a tile."""
    got = sp.decode_tile(torch.bfloat16, kv, G)
    want = _want_decode(torch.bfloat16, kv, G)
    assert (got or ("lanes_int8" if kv == torch.int8 else "lanes")) == want
    assert sp.decode_tile(torch.float32, kv, G) is None


def test_group_tile_plan():
    """The group tile's plan: ``group_rows(G)`` query rows a block (16 a
    row warp, at most 64), the read split as ``split_plan`` splits it at
    GROUP_PER_SM block per SM into whole 64-slot tiles (and table columns)
    and at most ``max_splits``, always folded by the merge; the shared
    memory of ``wt::Smem<D, RW>``."""
    assert [sp.group_rows(G) for G in (1, 7, 16, 17, 33, 48, 64, 96)] == [
        16, 16, 16, 32, 48, 48, 64, 64]
    assert [sp.group_warps(G)[1] for G in (7, 17, 48)] == [4, 2, 2]
    for G, D in ((2, 128), (7, 128), (16, 64), (48, 128), (8, 256)):
        for n_slots in (64, 192, 832, 3000):
            p = da.kernel_plan(torch.bfloat16, 4, 4 * G, 4, D, n_slots,
                               force="group")
            assert p.impl == "group" and p.split_slots % sp.TILE_STEP == 0
            assert 1 <= p.splits <= sp.MAX_SPLITS and sp.merges(p)
            assert p.splits * p.split_slots >= n_slots
            assert (p.splits - 1) * p.split_slots < n_slots  # no empty split
            rw = sp.group_warps(G)[0]
            assert p.smem == _build.window_tile_smem_bytes(D, rw) <= _build.SMEM_LIMIT
    # The main path's shapes (PERF.md): Qwen2-7B's K2 over the whole ring
    # (16 blocks) and in the engine's bucket, K3 at the serve shape (32
    # blocks, 832 slots) and at Llama-2-7B's GQA (64 blocks, 1024 slots).
    assert da.kernel_plan(torch.bfloat16, 4, 28, 4, 128, 1024)[2:] == (16, 64)
    assert da.kernel_plan(torch.bfloat16, 4, 28, 4, 128, 192)[2:] == (3, 64)
    assert pa.kernel_plan(torch.bfloat16, 1, 7, 128, B=8, Hkv=4, n_slots=832,
                          bs=16)[2:] == (7, 128)
    assert pa.kernel_plan(torch.bfloat16, 1, 4, 128, B=8, Hkv=8, n_slots=1024,
                          bs=16)[2:] == (8, 128)
    capped = da.kernel_plan(torch.bfloat16, 4, 28, 4, 128, 1024,
                            max_splits=4)
    assert capped[::2] == ("group", 4) and sp.merges(capped)
    unsplit = da.kernel_plan(torch.bfloat16, 4, 28, 4, 128, 1024,
                             max_splits=1)
    assert unsplit[2:] == (1, 1024) and sp.merges(unsplit)
    # K3 splits whole table columns too: a multiple of the block size.
    p = pa.kernel_plan(torch.bfloat16, 1, 7, 128, B=2, Hkv=4, n_slots=1024,
                       bs=128)
    assert p.impl == "group" and p.split_slots % 128 == 0


def test_group_impl_codes_match_the_sources():
    """The wrappers pass the group tile's rows a block as the entry point's
    GB / R and impl code 3, its splits stored in the workspace and folded
    by split_merge, as csrc/decode_attention.cu and paged_attention.cu
    dispatch them; K3 and an all-decode K4 reach the same kernel; K2's
    state-out form takes it too."""
    assert _build.IMPL_CODES["group"] == 3
    dec = (_build.CSRC / "decode_attention.cu").read_text()
    pag = (_build.CSRC / "paged_attention.cu").read_text()
    for src in (dec, pag):
        assert "wt::run<D, RW, wt::kWorkspace>(s, gsmem);" in src
        assert "kCluster" not in src
        for rows, rw in ((16, 1), (32, 2), (48, 3), (64, 4)):
            assert f"case {rows}: return launch_group<D, {rw}>" in src
    assert "impl == 3 && tile16 && CB == 1)" in pag
    assert "s.ql = a.qlen ? a.qlen[b] : 1;" in pag
    assert "} else if (impl == 3) {" in dec
    assert "err = dispatch_group(D, GB, a, stf, s);" in dec
    assert da._rows(sp.Plan("group", 0, 1, 64), 7) == 16
    assert da._rows(sp.Plan("lanes", 0, 1, 64), 7) == 8


def test_state_entry_matches_the_c_signature():
    """K2's state-out entry point takes the state buffer beside the
    workspace, and its ctypes declaration follows."""
    src = (_build.CSRC / "decode_attention.cu").read_text()
    sig = re.search(r'extern "C" int llmss_decode_attention_state\((.*?)\)',
                    src, re.S).group(1)
    kinds = [param.split()[0] for param in sig.split(",")]
    sym, args = _build._STATE_ENTRIES["decode_attention"]
    assert sym == "llmss_decode_attention_state"
    assert args == [_CTYPES[k] for k in kinds]
    assert kinds[6:8] == ["void*", "void*"]  # ws, st


def test_group_symbols_are_counted():
    """K2's and K3's group tile have their own symbols, counted for their
    wrappers from a step graph's nodes: a ``window_mma`` node is K2w's,
    never K2's."""
    dec = "_ZN5llmss12_GLOBAL__N_112decode_groupILi128ELi1ELi1EEEvNS0_4ArgsE"
    pag = "_ZN5llmss12_GLOBAL__N_111paged_groupILi128ELi1ELi1EEEvNS0_4ArgsE"
    win = "_ZN5llmss12_GLOBAL__N_110window_mmaILi128ELi1ELb1EEEvNS0_7WinArgsE"
    assert "decode_group" in graphs.KERNEL_SYMBOLS["decode_attention"]
    for fn in (pa.paged_decode_attention, pa.ragged_paged_attention):
        assert "paged_group" in graphs.KERNEL_SYMBOLS[fn.__name__]
        assert graphs.node_launches([pag], [(fn, 1)]) == [(fn, 1)]
    assert graphs.node_launches([dec], [(da.decode_attention, 1)]) == [
        (da.decode_attention, 1)]
    with pytest.raises(RuntimeError):
        graphs.node_launches([win], [(da.decode_attention, 1)])
    assert chip_smoke._node_counts([dec, pag, win], ("decode_group",)) == {
        "decode_group": 1}


def test_profile_step_arms_an_exiting_watchdog():
    """chip_smoke.py's POST /profile step (serve_telemetry) arms a
    faulthandler watchdog that dumps every thread's stack and ends the run
    non-zero if the step outlasts PROFILE_WATCHDOG_S, and disarms it after
    the step."""
    import inspect

    src = inspect.getsource(chip_smoke._tel_profile)
    assert "faulthandler.dump_traceback_later(PROFILE_WATCHDOG_S, exit=True)" in src
    assert "faulthandler.cancel_dump_traceback_later()" in src
    assert src.index("dump_traceback_later(") < src.index('"/profile"')
    assert chip_smoke.PROFILE_WATCHDOG_S == 180


# -- shared memory ------------------------------------------------------------


def test_group_tile_smem_matches_the_header():
    """The group tile's plans take ``window_tile_smem_bytes``, which
    mirrors group_tile.cuh's ``wt::Smem<D, RW>`` (the struct K2w, K2 and
    K3 launch with): 109,704 bytes at D = 128 and one row warp, two blocks
    per SM."""
    src = (_build.CSRC / "group_tile.cuh").read_text()
    for line in (
            "static constexpr size_t ring = kStages<D> * 2 * KV * sizeof(__nv_bfloat16);",
            "static constexpr size_t bytes = region + q + vn + sizeof(int) * (kPosWin + 2) +",
            "sizeof(float) * (2 * SW * R + 2 * R + R * kMaxWin);"):
        assert line in src, line
    for name in ("decode_attention.cu", "paged_attention.cu"):
        assert "cfg.dynamicSmemBytes = SM::bytes;" in (
            _build.CSRC / name).read_text()
    assert _build.window_tile_smem_bytes(128, 1) == 109704
    assert 2 * (109704 + _build.BLOCK_RESERVED_BYTES) <= _build.SM_SHARED_BYTES
    for G, rw in ((7, 1), (24, 2), (48, 3), (64, 4)):
        plan = pa.kernel_plan(torch.bfloat16, 1, G, 256, B=4, Hkv=2,
                              n_slots=512, bs=16, force="group")
        assert plan.smem == _build.window_tile_smem_bytes(256, rw)


def test_tile_smem_matches_the_header():
    """tile_smem_bytes mirrors attn_tile.cuh's Smem<D>: Q plus two stages
    of K and V, rows of D + 8 16-bit elements, and two stages of 64 int32
    positions."""
    src = (_build.CSRC / "attn_tile.cuh").read_text()
    assert "LD = D + 8" in src and "kRows = 64" in src and "kSlots = 64" in src
    assert "2 * (size_t(Q) + 4 * size_t(KV)) + 2 * kSlots * sizeof(int)" in src
    assert _build.tile_smem_bytes(128) == 2 * (64 * 136 + 4 * 64 * 136) + 512


def test_tile_i8_smem_matches_the_header():
    """tile_i8_smem_bytes mirrors attn_tile_i8.cuh's SmemI8<D>: Q and one
    widened K and V tile (rows of D + 8 bf16 elements), two stages of int8
    K and V tiles (rows of D + 16 bytes), two stages of 64 K and 64 V fp32
    scales and of 64 int32 positions: 90,624 bytes at D = 128, two blocks
    per SM."""
    src = (_build.CSRC / "attn_tile_i8.cuh").read_text()
    assert "LD = D + 8;" in src and "LD8 = D + 16;" in src
    assert ("2 * (size_t(Q) + 2 * size_t(KV)) + 4 * size_t(KV8) +\n"
            "                                  4 * 2 * 2 * kSlots + 2 * kSlots"
            " * sizeof(int)") in src
    assert _build.tile_i8_smem_bytes(128) == (
        2 * (64 * 136 + 2 * 64 * 136) + 4 * 64 * 144 + 4 * 2 * 2 * 64
        + 2 * 64 * 4) == 90624
    assert 2 * (_build.tile_i8_smem_bytes(128) + 1024) <= 228 * 1024
    for D in pa.HEAD_DIMS:
        assert _build.tile_i8_smem_bytes(D) <= _build.SMEM_LIMIT


@pytest.mark.parametrize("D", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_k1_smem_fits(D, dtype):
    assert fa.kernel_plan(dtype, D)[1] <= _build.SMEM_LIMIT


@pytest.mark.parametrize("D", pa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", pa.DTYPES)
@pytest.mark.parametrize("CB, G", [(1, 1), (1, 8), (16, 4), (128, 1), (128, 4)])
def test_k3_k4_smem_fits(D, dtype, CB, G):
    assert pa.kernel_plan(dtype, CB, G, D)[1] <= _build.SMEM_LIMIT


# -- refusals -----------------------------------------------------------------


def _k1_views(width):
    """q / k / v [1, 16, 2, 64] as views into rows of `width` elements."""
    base = torch.zeros(1, 16, 2, width)
    return base[..., :64]


def test_k1_mma_refuses_rows_not_16_byte_aligned():
    """A stride that is not a multiple of 8 elements cannot feed the wgmma
    tile's 16-byte rows (its TMA maps and Q loads): the wgmma
    instantiation raises, the plan does not switch to the fma kernel, and
    fp32 (fma, 4-element rows) takes the same strides."""
    q = _k1_views(68)  # head stride 68, seq stride 136
    out = torch.empty(1, 16, 2, 64)
    assert fa.kernel_plan(torch.bfloat16, 64)[0] == "wgmma"
    with pytest.raises(_build.KernelError, match="multiples of 8"):
        fa.launch_strides(q, q, q, out, "wgmma")
    assert fa.launch_strides(q, q, q, out, "fma")[:3] == (2176, 136, 68)
    ok = _k1_views(72)
    assert fa.launch_strides(ok, ok, ok, out, "wgmma")[:3] == (2304, 144, 72)


# -- sources ------------------------------------------------------------------


_CTYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}


@pytest.mark.parametrize("name", _build.SOURCES)
def test_declared_argtypes_match_the_c_signature(name):
    """The ctypes declaration of each entry point has the C signature's
    parameters, in order and kind (every pointer a c_void_p)."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    sig = re.search(rf'extern "C" int llmss_{name}\((.*?)\)', src, re.S).group(1)
    kinds = [param.split()[0] for param in sig.split(",")]  # "void*", "int"
    fn = SimpleNamespace()
    _build._declare(SimpleNamespace(**{f"llmss_{name}": fn}), name)
    assert fn.argtypes == [_CTYPES[k] for k in kinds]
    assert fn.restype is ctypes.c_int


# K4's tensor-core tile over a bf16 and an int8 pool, and the lane
# template over a bf16 and an int8 pool, as libcuda (mangled) and the
# profiler (demangled) name them.
_K4_SYMBOLS = [
    ("_ZN5llmss12_GLOBAL__N_19paged_mmaIaLi128ELb0EEEvNS0_6ArgsI8E",
     "paged_mma", True),
    ("void llmss::(anonymous namespace)::paged_mma<signed char, 128, false>"
     "(llmss::(anonymous namespace)::ArgsI8)", "paged_mma", True),
    ("_ZN5llmss12_GLOBAL__N_19paged_mmaI13__nv_bfloat16Li128ELb0EEEvNS0_4ArgsE",
     "paged_mma", False),
    ("void llmss::(anonymous namespace)::paged_mma<__nv_bfloat16, 128, false>"
     "(llmss::(anonymous namespace)::Args)", "paged_mma", False),
    ("_ZN5llmss12_GLOBAL__N_19paged_fwdI13__nv_bfloat16aLi128ELi8EEEvNS0_"
     "6ArgsI8E", "paged_fwd", True),
    ("_ZN5llmss12_GLOBAL__N_19paged_fwdI13__nv_bfloat16S2_Li128ELi8EEEvNS0_"
     "4ArgsE", "paged_fwd", False),
]


@pytest.mark.parametrize("name, sym, int8", _K4_SYMBOLS)
def test_k4_kernel_symbols_are_recognised(name, sym, int8):
    """A graph's K4 node counts for ragged_paged_attention whichever
    instantiation it is, and chip_smoke tells the int8-pool ones apart."""
    fn = pa.ragged_paged_attention
    assert graphs.node_launches([name], [(fn, 1)]) == [(fn, 1)]
    assert chip_smoke._int8_kernel(name, sym) is int8


def test_chip_smoke_counts_launches_from_counters_and_nodes():
    """chip_smoke.py counts launches from the wrappers' counters (a replay
    adds its graph's kernel nodes) and from a step graph's kernel node
    names, never from profiler records, which have lost launches."""
    def step():
        da.decode_attention.launches += 3
        pa.ragged_paged_attention.launches += 2
        return "out"

    before = da.decode_attention.launches, pa.ragged_paged_attention.launches
    try:
        assert chip_smoke._wrapper_launches(step) == (
            "out", {"decode_attention": 3, "ragged_paged_attention": 2})
        assert chip_smoke._wrapper_launches(lambda: None) == (None, {})
    finally:
        da.decode_attention.launches, pa.ragged_paged_attention.launches = before
    names = [n for n, _, _ in _K4_SYMBOLS[::2]] + [
        "_ZN5llmss12_GLOBAL__N_111split_mergeI13__nv_bfloat16Li128EEEvNS0_"
        "9MergeArgsE"]
    assert chip_smoke._node_counts(
        names, ("paged_mma", "paged_fwd", "split_merge", "int8:paged_mma",
                "int8:paged_fwd")) == {
        "paged_mma": 2, "paged_fwd": 1, "split_merge": 1,
        "int8:paged_mma": 1, "int8:paged_fwd": 1}


def test_ptxas_report_lists_both_k4_tiles():
    """chip_smoke / kernel_ab read each tensor-core instantiation's
    registers and spills from ``-Xptxas=-v`` output."""
    text = "".join(
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {name}\n"
        f"    0 bytes stack frame, {sp} bytes spill stores, 0 bytes spill "
        f"loads\nptxas info    : Used {r} registers, 16 bytes smem\n"
        for (name, _, _), r, sp in zip(_K4_SYMBOLS[::2], (168, 154, 40),
                                       (0, 8, 0)))
    assert chip_smoke.mma_registers(text) == [
        {"kernel": "paged_mmaIaLi128ELb0", "registers": 168,
         "spill_store_bytes": 0},
        {"kernel": "paged_mmaI13__nv_bfloat16Li128ELb0", "registers": 154,
         "spill_store_bytes": 8}]


def test_every_source_is_built():
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == sorted(_build.SOURCES)


def test_a_newer_header_makes_a_library_stale(monkeypatch, tmp_path):
    """A change to a shared header (attn_tile.cuh, common.cuh) rebuilds
    every source."""
    csrc = tmp_path / "csrc"
    (csrc / "build").mkdir(parents=True)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", csrc / "build")
    (csrc / "k.cu").write_text("")
    lib = csrc / "build" / "libk.so"
    lib.write_text("")
    (csrc / "attn_tile.cuh").write_text("")
    os.utime(csrc / "k.cu", (1000, 1000))
    os.utime(csrc / "attn_tile.cuh", (1000, 1000))
    os.utime(lib, (2000, 2000))
    assert not _build._stale("k")
    os.utime(csrc / "attn_tile.cuh", (3000, 3000))
    assert _build._stale("k")


# -- the tensor-core instantiation's rounding ---------------------------------


def tile_attention(q, k, v, mask, *, zero_masked, round_p, tile=64):
    """The mma instantiation's arithmetic in torch: per tile of `tile`
    keys, fp32 scores of bf16 values, an online softmax, P rounded to bf16
    before P.V (when `round_p`), the output rounded to bf16 (when
    `round_p`). q [B, S, Hq, D], k / v [B, T, Hkv, D], mask [B, S, T]."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = q.reshape(B, S, Hkv, G, D) / D ** 0.5
    m = torch.full((B, Hkv, G, S), NEG)
    l = torch.zeros(B, Hkv, G, S)
    o = torch.zeros(B, Hkv, G, S, D)
    for t0 in range(0, T, tile):
        vis = mask[:, None, None, :, t0:t0 + tile]
        s = torch.einsum("bskgd,btkd->bkgst", qf, k[:, t0:t0 + tile])
        s = s.masked_fill(~vis, NEG)
        mx = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - mx)
        p = torch.exp(s - mx[..., None])
        if zero_masked:
            p = p.masked_fill(~vis, 0.0)
        l = l * alpha + p.sum(-1)
        if round_p:
            p = p.to(torch.bfloat16).float()
        o = o * alpha[..., None] + torch.einsum("bkgst,btkd->bkgsd", p,
                                                v[:, t0:t0 + tile])
        m = mx
    out = (o / torch.where(l == 0, 1.0, l)[..., None])
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D)
    return out.to(torch.bfloat16).float() if round_p else out


def _bf16(rng, *shape):
    """Normal values rounded to bf16, held in fp32."""
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return x.to(torch.bfloat16).float()


def _k4_serve_mixed():
    """chip_smoke's k4_serve_mixed at 2 heads: 8 rows, CB 128, prompt rows
    at their first, second and 37-token chunks beside 5 decode rows, each
    row's blocks scattered over the pool."""
    rng = np.random.default_rng(5)
    B, H, D, CB, bs, MB = 8, 2, 128, 128, 16, 64
    ctx = [0, 128, 256, 400, 700, 33, 812, 512]
    qlen = [128, 128, 37, 1, 1, 1, 1, 1]
    ring = MB * bs
    need = [max(1, -(-(c + n) // bs)) for c, n in zip(ctx, qlen)]
    N = sum(need) + 3
    perm = rng.permutation(N)
    bt = np.full((B, MB), N, np.int32)
    kvp = np.full((B, ring), -1, np.int32)
    k0 = 0
    for b, n in enumerate(need):
        bt[b, :n] = perm[k0:k0 + n]
        k0 += n
        kvp[b, :ctx[b]] = np.arange(ctx[b])
    T = torch.from_numpy
    nblk = -(-(kvp >= 0).sum(1) // bs)
    return dict(q=_bf16(rng, B, CB, H, D), kp=_bf16(rng, 1, N + 1, bs, H, D),
                vp=_bf16(rng, 1, N + 1, bs, H, D), kn=_bf16(rng, B, CB, H, D),
                vn=_bf16(rng, B, CB, H, D), qpos=T(np.asarray(ctx, np.int32)),
                qlen=T(np.asarray(qlen, np.int32)), kvp=T(kvp), bt=T(bt),
                nblk=T(nblk.astype(np.int32)),
                slot0=T(np.asarray(ctx, np.int32) % ring), ring=ring)


def _k4_emulated(c, round_p):
    """The chunk's view for tile_attention: the row's gathered logical
    slots (64-slot tiles, empty and pending ones masked), then its fresh
    keys as trailing tiles."""
    from llmss_tpu_torch.engine.cache import gather_block_view

    B, CB = c["q"].shape[:2]
    rel = torch.arange(CB, dtype=torch.int32)
    qpos = c["qpos"][:, None] + rel[None, :]
    vis = tatt.ragged_cache_visibility(c["qlen"], c["kvp"], c["slot0"], c["ring"])
    cache = vis[:, None, :] & (c["kvp"][:, None, :] <= qpos[:, :, None])
    fresh = (rel[None, :, None] >= rel[None, None, :]) & (
        rel[None, None, :] < c["qlen"][:, None, None])
    k = torch.cat([gather_block_view(c["kp"][0], c["bt"]), c["kn"]], 1)
    v = torch.cat([gather_block_view(c["vp"][0], c["bt"]), c["vn"]], 1)
    return tile_attention(c["q"], k, v, torch.cat([cache, fresh], 2),
                          zero_masked=True, round_p=round_p)


def _k4_plain(c, vp, vn):
    return pa.ragged_paged_attention_ref(
        c["q"], c["kp"], vp, c["kn"], vn, c["qpos"], c["qlen"], c["kvp"],
        c["bt"], c["nblk"], c["slot0"], 0)


def _k1_gqa():
    """chip_smoke's k1_gqa at 2 KV heads (G = 4 kept): prompts of
    512/256/511/77 right-padded to 512 in a ring of 1024."""
    rng = np.random.default_rng(1)
    B, S, T, Hq, Hkv, D = 4, 512, 1024, 8, 2, 128
    lens = [512, 256, 511, 77]
    kvp = np.full((B, T), -1, np.int32)
    for b, n in enumerate(lens):
        kvp[b, :n] = np.arange(n)
    qp = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return dict(q=_bf16(rng, B, S, Hq, D), k=_bf16(rng, B, T, Hkv, D),
                v=_bf16(rng, B, T, Hkv, D), qp=torch.from_numpy(qp),
                kvp=torch.from_numpy(kvp))


def _ratio(got, ref, ref_abs):
    tol = chip_smoke.REL_TOL[torch.bfloat16] * ref_abs + 1e-6
    return ((got - ref).abs() / tol).max().item()


@pytest.mark.parametrize("case", ["k4_serve_mixed", "k1_gqa"])
def test_emulation_without_rounding_is_the_plain_version(case):
    """The emulation's tile loop computes the plain versions' function."""
    if case == "k4_serve_mixed":
        c = _k4_serve_mixed()
        got, want = _k4_emulated(c, False), _k4_plain(c, c["vp"], c["vn"])
        live = torch.arange(c["q"].shape[1])[None, :] < c["qlen"][:, None]
        got, want = got[live], want[live]
    else:
        c = _k1_gqa()
        mask = tatt.make_causal_mask(c["qp"], c["kvp"], c["kvp"] >= 0)
        got = tile_attention(c["q"], c["k"], c["v"], mask, zero_masked=False,
                             round_p=False)
        want = fa.flash_attention_ref(c["q"], c["k"], c["v"], c["qp"], c["kvp"])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["k4_serve_mixed", "k1_gqa"])
def test_rounding_every_p_stays_within_rel_tol(case):
    """P rounded to bf16 in every tile (K4: fresh tiles too) and the output
    rounded to bf16 stay within REL_TOL[bf16] x the weighted |v| of the
    fp32 plain version, with room to spare."""
    assert chip_smoke.REL_TOL[torch.bfloat16] == 2.0 ** -7
    if case == "k4_serve_mixed":
        c = _k4_serve_mixed()
        got = _k4_emulated(c, True)
        ref = _k4_plain(c, c["vp"], c["vn"])
        ref_abs = _k4_plain(c, c["vp"].abs(), c["vn"].abs())
        live = torch.arange(c["q"].shape[1])[None, :] < c["qlen"][:, None]
        got, ref, ref_abs = got[live], ref[live], ref_abs[live]
    else:
        c = _k1_gqa()
        mask = tatt.make_causal_mask(c["qp"], c["kvp"], c["kvp"] >= 0)
        got = tile_attention(c["q"], c["k"], c["v"], mask, zero_masked=False,
                             round_p=True)
        ref = fa.flash_attention_ref(c["q"], c["k"], c["v"], c["qp"], c["kvp"])
        ref_abs = fa.flash_attention_ref(c["q"], c["k"], c["v"].abs(), c["qp"],
                                         c["kvp"])
    assert torch.isfinite(got).all()
    assert _ratio(got, ref, ref_abs) <= 1.0


# -- the int8-pool tensor-core instantiation's arithmetic ---------------------

# Its emulation against the plain version and the Pallas int8 branch, both
# fp32 with P x v_scale unrounded: at most 2^-12 of the row's weighted |v|
# before the output rounding (the two-term split errs by at most 2^-16
# relative in each P'; the rest is fp32 summation order).
INT8_EMU_TOL = 2.0 ** -12


def tile_attention_int8(q, k, v, ks, vs, mask, *, pv, tile=64):
    """The mma_int8 instantiation's arithmetic in torch, per tile of `tile`
    keys: fp32 scores of bf16 queries and int8-valued keys (widened to bf16
    exactly), each column times its slot's K scale, an online softmax with
    masked probabilities exactly 0, P' = p x v_scale entering P.V as
    `pv`: "split" hi = bf16(P') plus lo = bf16(P' - hi), the kernel's;
    "single" bf16(P') alone; "none" P' unrounded. The row sum uses the
    unrounded p. Returns the fp32 output before its rounding to bf16. q
    [B, S, Hq, D]; k / v [B, T, Hkv, D] and ks / vs [B, T, Hkv] (fresh keys:
    scale 1); mask [B, S, T]."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = q.reshape(B, S, Hkv, G, D) / D ** 0.5
    m = torch.full((B, Hkv, G, S), NEG)
    l = torch.zeros(B, Hkv, G, S)
    o = torch.zeros(B, Hkv, G, S, D)
    for t0 in range(0, T, tile):
        cols = slice(t0, t0 + tile)
        vis = mask[:, None, None, :, cols]
        s = torch.einsum("bskgd,btkd->bkgst", qf, k[:, cols])
        s = s * ks[:, cols].permute(0, 2, 1)[:, :, None, None, :]
        s = s.masked_fill(~vis, NEG)
        mx = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - mx)
        p = torch.exp(s - mx[..., None]).masked_fill(~vis, 0.0)
        l = l * alpha + p.sum(-1)
        pv_ = p * vs[:, cols].permute(0, 2, 1)[:, :, None, None, :]
        if pv == "split":
            hi = pv_.to(torch.bfloat16).float()
            pv_ = hi + (pv_ - hi).to(torch.bfloat16).float()
        elif pv == "single":
            pv_ = pv_.to(torch.bfloat16).float()
        o = o * alpha[..., None] + torch.einsum("bkgst,btkd->bkgsd", pv_,
                                                v[:, cols])
        m = mx
    out = o / torch.where(l == 0, 1.0, l)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D)


def _k4_int8_emulated(c, pv):
    """tile_attention_int8 over a K4 case with an int8 pool (``k8``,
    ``v8``, ``ks``, ``vs``, layer ``layer``): the rows' gathered logical
    slots, padded with hidden slots to whole 64-slot tiles, then the fresh
    keys as trailing tiles, as the kernel walks them."""
    B, CB = c["q"].shape[:2]
    rel = torch.arange(CB, dtype=torch.int32)
    qpos = c["qpos"][:, None] + rel[None, :]
    vis = tatt.ragged_cache_visibility(c["qlen"], c["kvp"], c["slot0"], c["ring"])
    cache = vis[:, None, :] & (c["kvp"][:, None, :] <= qpos[:, :, None])
    fresh = (rel[None, :, None] >= rel[None, None, :]) & (
        rel[None, None, :] < c["qlen"][:, None, None])
    pad = -c["ring"] % 64

    def view(pool, fresh):
        v = gather_block_view(pool[c["layer"]], c["bt"]).float()
        return torch.cat([v, torch.zeros((B, pad) + v.shape[2:]), fresh], 1)

    ones = torch.ones(c["kn"].shape[:3])  # the fresh keys' scales
    k, v = view(c["k8"], c["kn"]), view(c["v8"], c["vn"])
    ks, vs = view(c["ks"], ones), view(c["vs"], ones)
    mask = torch.cat([cache, torch.zeros(B, CB, pad, dtype=torch.bool), fresh], 2)
    return tile_attention_int8(c["q"], k, v, ks, vs, mask, pv=pv)


def _k4_int8_plain(c, v8, vn):
    return pa.ragged_paged_attention_ref(
        c["q"], c["k8"], v8, c["kn"], vn, c["qpos"], c["qlen"], c["kvp"],
        c["bt"], c["nblk"], c["slot0"], c["layer"], k_scale=c["ks"],
        v_scale=c["vs"])


def _k4_int8_serve_mixed():
    """_k4_serve_mixed with its pools quantized (the engine's
    ``quantize_kv``), as chip_smoke's k4_int8_serve_mixed at 2 heads."""
    c = _k4_serve_mixed()
    (c["k8"], c["ks"]), (c["v8"], c["vs"]) = quantize_kv(c["kp"]), quantize_kv(c["vp"])
    c["layer"] = 0
    return c


def _int8_ratio(got, ref, ref_abs, live):
    """Worst |got - ref| over its INT8_EMU_TOL bound on the live rows."""
    tol = INT8_EMU_TOL * ref_abs + 1e-6
    return ((got - ref).abs() / tol)[live].max().item()


def test_int8_emulation_matches_the_plain_version():
    """At k4_serve_mixed's int8 form the split P' stays within
    INT8_EMU_TOL x the weighted |v| of the fp32 plain version with scales;
    rounded to bf16, within the card's REL_TOL[bf16]. Unrounded, the
    emulation's tile loop is the plain version's function (1e-5)."""
    c = _k4_int8_serve_mixed()
    live = torch.arange(c["q"].shape[1])[None, :] < c["qlen"][:, None]
    ref = _k4_int8_plain(c, c["v8"], c["vn"])
    ref_abs = _k4_int8_plain(c, c["v8"].abs(), c["vn"].abs())
    torch.testing.assert_close(_k4_int8_emulated(c, "none")[live], ref[live],
                               rtol=1e-5, atol=1e-5)
    got = _k4_int8_emulated(c, "split")
    assert torch.isfinite(got).all()
    assert _int8_ratio(got, ref, ref_abs, live) <= 1.0
    assert _ratio(got.to(torch.bfloat16).float()[live], ref[live],
                  ref_abs[live]) <= 1.0


def test_int8_emulation_matches_the_pallas_int8_branch():
    """test_torch_int8.py's Pallas int8 case (L 2, 16 blocks of 8, Hkv 2,
    Hq 4, D 128, chunks of 4: a partial tail block, an empty row whose
    whole prompt is in its chunk, a decode row crossing a block boundary),
    from the same seed, with q and the fresh K/V rounded to bf16 (the
    values the kernel takes) on both sides. The Pallas kernel runs in
    interpret mode; live rows agree within INT8_EMU_TOL x the weighted
    |v| (plain version on |v|)."""
    Lp, Np, bs, Hkv, Hq, D, B, MBp, CB = 2, 16, 8, 2, 4, 128, 3, 4, 4
    ring = MBp * bs
    ctx, qlen = np.array([13, 0, 27]), np.array([3, 4, 1], np.int32)
    bt = np.asarray([[1, 5, 9, 13], [2, 6, 10, 14], [3, 7, 11, 15]], np.int32)
    rng = np.random.default_rng(1)
    k8 = rng.integers(-127, 127, size=(Lp, Np, bs, Hkv, D)).astype(np.int8)
    v8 = rng.integers(-127, 127, size=(Lp, Np, bs, Hkv, D)).astype(np.int8)
    ks = rng.uniform(0.01, 0.03, size=(Lp, Np, bs, Hkv)).astype(np.float32)
    vs = rng.uniform(0.01, 0.03, size=(Lp, Np, bs, Hkv)).astype(np.float32)
    nblk = np.asarray([max(-(-int(c + q) // bs), 1) for c, q in zip(ctx, qlen)],
                      np.int32)
    kvp = np.full((B, ring), -1, np.int32)
    for b in range(B):
        kvp[b, :ctx[b]] = np.arange(ctx[b])

    def bf16(*shape):
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        return x.to(torch.bfloat16).float().numpy()

    q, kn, vn = bf16(B, CB, Hq, D), bf16(B, CB, Hkv, D), bf16(B, CB, Hkv, D)
    q_pos = ctx.astype(np.int32)
    slot0 = (ctx % ring).astype(np.int32)
    want = np.asarray(pallas_ragged.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(kn),
        jnp.asarray(vn), jnp.asarray(q_pos), jnp.asarray(qlen),
        jnp.asarray(kvp), jnp.asarray(bt), jnp.asarray(nblk),
        jnp.asarray(slot0), jnp.int32(1), k_scale_pool=jnp.asarray(ks),
        v_scale_pool=jnp.asarray(vs), interpret=True))
    T = torch.from_numpy

    def drop_block(x, fill):  # the port's pool has block N for dropped writes
        pad = np.full((Lp, 1) + x.shape[2:], fill, x.dtype)
        return T(np.concatenate([x, pad], 1))

    c = dict(q=T(q), kn=T(kn), vn=T(vn), k8=drop_block(k8, 127),
             v8=drop_block(v8, 127), ks=drop_block(ks, 1e4),
             vs=drop_block(vs, 1e4), qpos=T(q_pos), qlen=T(qlen), kvp=T(kvp),
             bt=T(bt), nblk=T(nblk), slot0=T(slot0), ring=ring, layer=1)
    live = torch.arange(CB)[None, :] < c["qlen"][:, None]
    got = _k4_int8_emulated(c, "split")
    ref_abs = _k4_int8_plain(c, c["v8"].abs(), c["vn"].abs())
    assert _int8_ratio(got, T(want), ref_abs, live) <= 1.0


def test_int8_single_rounding_errs_more_than_the_split():
    """The reason for the two-term P': at k4_serve_mixed's int8 form one
    bf16 rounding of P' x V (the bf16 tile's arithmetic) misses the
    INT8_EMU_TOL bound that the split meets, and errs by at least 64 times
    more against the fp32 plain version."""
    c = _k4_int8_serve_mixed()
    live = torch.arange(c["q"].shape[1])[None, :] < c["qlen"][:, None]
    ref = _k4_int8_plain(c, c["v8"], c["vn"])
    ref_abs = _k4_int8_plain(c, c["v8"].abs(), c["vn"].abs())
    split = _k4_int8_emulated(c, "split")
    single = _k4_int8_emulated(c, "single")
    assert _int8_ratio(split, ref, ref_abs, live) <= 1.0
    assert _int8_ratio(single, ref, ref_abs, live) > 1.0
    err = [(x - ref)[live].abs().max().item() for x in (split, single)]
    assert err[1] >= 64 * err[0]
