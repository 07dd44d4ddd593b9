"""The kernels' host-side plan on the CPU: which instantiation each call
takes, the shared memory it needs, what the wrappers refuse, that every
CUDA source is built and declared with its C signature, and a torch
emulation of the tensor-core instantiation's rounding held to the card's
tolerance.

The tensor-core instantiation (csrc/attn_tile.cuh) runs a per-64-slot-tile
online softmax and rounds every P to bf16 before P.V, the chunk's fresh
keys included (they are trailing tiles of the same loop; the Pallas
kernel applies fresh V in fp32). ``chip_smoke.REL_TOL`` bounds a kernel
element's error by REL_TOL[dtype] times its row's softmax-weighted mean
|v|, a derivation that assumes every P is rounded. The emulation below
shows that bound holding at the main path's K4 and K1 GQA shapes (cut to
2 KV heads), on bf16 inputs from a seed, against the fp32 plain versions.
"""

import ctypes
import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from llmss_tpu_torch.ops import _build
from llmss_tpu_torch.ops import attention as tatt
from llmss_tpu_torch.ops import flash_attention as fa
from llmss_tpu_torch.ops import paged_attention as pa

NEG = float(torch.finfo(torch.float32).min)


# -- instantiation choice -----------------------------------------------------


@pytest.mark.parametrize("dtype, want", [
    (torch.bfloat16, "mma"), (torch.float16, "mma"), (torch.float32, "fma"),
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
    assert pa.kernel_plan(dtype, CB, G, 128)[0] == want


# -- shared memory ------------------------------------------------------------


def test_tile_smem_matches_the_header():
    """tile_smem_bytes mirrors attn_tile.cuh's Smem<D>: Q plus two stages
    of K and V, rows of D + 8 16-bit elements, and two stages of 64 int32
    positions."""
    src = (_build.CSRC / "attn_tile.cuh").read_text()
    assert "LD = D + 8" in src and "kRows = 64" in src and "kSlots = 64" in src
    assert "2 * (size_t(Q) + 4 * size_t(KV)) + 2 * kSlots * sizeof(int)" in src
    assert _build.tile_smem_bytes(128) == 2 * (64 * 136 + 4 * 64 * 136) + 512


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
    """A stride that is not a multiple of 8 elements cannot feed cp.async's
    16-byte copies: the mma instantiation raises, the plan does not switch
    to the fma kernel, and fp32 (fma) takes the same strides."""
    q = _k1_views(68)  # head stride 68, seq stride 136
    out = torch.empty(1, 16, 2, 64)
    assert fa.kernel_plan(torch.bfloat16, 64)[0] == "mma"
    with pytest.raises(_build.KernelError, match="multiples of 8"):
        fa.launch_strides(q, q, q, out, "mma")
    assert fa.launch_strides(q, q, q, out, "fma")[:3] == (2176, 136, 68)
    ok = _k1_views(72)
    assert fa.launch_strides(ok, ok, ok, out, "mma")[:3] == (2304, 144, 72)


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
