"""K1's wgmma tile (csrc/flash_attention.cu ``flash_wgmma``) on the CPU:
its producer's tile classes against the causal mask, its arithmetic
emulated in torch against the JAX package's Pallas kernel (interpret
mode), its launch order, its shared memory, the fp32 kernel's rows per
block, and the checks its TMA maps need.

Tolerances: the emulation without rounding against the Pallas kernel in
fp32, 2e-5 (blockwise online softmax in another tile order, as
tests/test_torch_ops.py); with P rounded to bf16, within
chip_smoke.REL_TOL[bf16] of the weighted |v| (chip_smoke's K1 check).
Only rows that see a slot are compared: a row that sees none ends as the
uniform average of its block's live tiles, which depends on the tile
width (the kernel's header says so), and no prefill row is such a row.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from llmss_tpu.ops.pallas_attention import flash_attention as pallas_flash
from llmss_tpu_torch.engine import graphs
from llmss_tpu_torch.ops import _build
from llmss_tpu_torch.ops import attention as tatt
from llmss_tpu_torch.ops import flash_attention as fa

NEG = float(torch.finfo(torch.float32).min)
LOG2E = 1.4426950408889634
SOURCE = (Path(fa.__file__).resolve().parent.parent / "csrc"
          / "flash_attention.cu").read_text()


def _ring(B, T, hist):
    """Ring positions [B, T]: row b holds positions 0..hist[b]-1 at slot
    p % T (a wrapped row keeps the latest), -1 elsewhere."""
    kvp = np.full((B, T), -1, np.int32)
    for b, n in enumerate(hist):
        for p in range(n):
            kvp[b, p % T] = p
    return kvp


def _positions(name):
    """(q positions [B, S], kv positions [B, T], window) of one layout."""
    if name == "prefill_padded":  # prompts 200 / 77 right-padded to 256
        S, T, q0, lens, window = 256, 512, 0, [200, 77], None
    elif name == "ring_wrap":  # the second chunk after the ring wrapped
        S, T, q0, lens, window = 128, 512, 700, [128, 128], None
    elif name == "window":
        S, T, q0, lens, window = 256, 512, 512, [256, 190], 300
    else:  # "prefix_suffix": suffixes at q0 512 over a 512-slot prefix
        S, T, q0, lens, window = 128, 1024, 512, [16, 100], None
    B = len(lens)
    qp = np.broadcast_to(np.arange(q0, q0 + S, dtype=np.int32), (B, S)).copy()
    kvp = _ring(B, T, [q0 + S] * B)
    for b, n in enumerate(lens):  # right padding: written with position -1
        for p in range(q0 + n, q0 + S):
            kvp[b, p % T] = -1
    return torch.from_numpy(qp), torch.from_numpy(kvp), window


LAYOUTS = ["prefill_padded", "ring_wrap", "window", "prefix_suffix"]


# -- the producer's tile classes ----------------------------------------------


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("G", [1, 4, 48])
@pytest.mark.parametrize("D, R", [(128, 128), (256, 64)])
def test_tile_classes_cover_the_mask(layout, G, D, R):
    """Every visible (row, slot) pair lies in a full or masked tile, a
    skipped tile holds none, and every pair of a full tile is visible to
    every row of its block (R flat rows a block)."""
    qp, kvp, window = _positions(layout)
    cls = fa.tile_classes(qp, kvp, G, D, window=window, rows=R)
    mask = tatt.make_causal_mask(qp, kvp, kvp >= 0, window)
    flat = mask.repeat_interleave(G, dim=1)  # [B, S * G, T]: row f = s*G+g
    bk = fa.wgmma_slots(D)
    B, F, T = flat.shape
    assert cls.shape == (B, -(-F // R), -(-T // bk))
    for b in range(B):
        for x in range(cls.shape[1]):
            for t in range(cls.shape[2]):
                pairs = flat[b, x * R:(x + 1) * R, t * bk:(t + 1) * bk]
                c = int(cls[b, x, t])
                if c == 0:
                    assert not pairs.any(), (b, x, t)
                elif c == 2:
                    assert pairs.shape[1] == bk and pairs.all(), (b, x, t)
    assert (cls == 2).any() and (cls == 1).any()


def test_long_prompt_is_mostly_full_tiles():
    """At S = T = 2048 one head has 16 x 16 (query, KV) tile pairs of 128:
    the 16 on the diagonal are masked, the 120 below it full, the 120
    above it skipped."""
    pos = torch.arange(2048)[None]
    cls = fa.tile_classes(pos, pos, 1, 128)
    assert [int((cls == i).sum()) for i in range(3)] == [120, 16, 120]
    assert all(int(cls[0, x, x]) == 1 for x in range(16))


# -- the tile's arithmetic ----------------------------------------------------


def wgmma_emulated(q, k, v, qp, kvp, *, window=None, round_p=True, R=128):
    """The wgmma tile's arithmetic in torch: per block of R flat rows
    (f = s * G + g) and per KV tile of ``wgmma_slots(D)`` slots, skipped
    tiles never read, full tiles without a mask, masked tiles with the
    finite fp32 minimum; scores in log2 units, an online softmax with
    exp2; the row sum of the unrounded P; P rounded to bf16 before P.V
    and the output rounded to bf16 (when ``round_p``). fp32 [B, S, Hq, D]."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    bk = fa.wgmma_slots(D)
    cls = fa.tile_classes(qp, kvp, G, D, window=window, rows=R)
    nk = cls.shape[2]
    pad = nk * bk - T
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    pp = torch.nn.functional.pad(kvp.long(), (0, pad), value=-1)
    qf = q.reshape(B, S, Hkv, G, D).permute(0, 2, 1, 3, 4).reshape(
        B, Hkv, S * G, D)
    pos = qp.long().repeat_interleave(G, dim=1)
    sc = D ** -0.5 * LOG2E
    out = torch.zeros(B, Hkv, S * G, D)
    for b in range(B):
        for x in range(cls.shape[1]):
            rows = slice(x * R, (x + 1) * R)
            qr, qpr = qf[b, :, rows], pos[b, rows][:, None]
            m = torch.full(qr.shape[:2], NEG)
            l = torch.zeros(qr.shape[:2])
            o = torch.zeros(qr.shape)
            for t in range(nk):
                c = int(cls[b, x, t])
                if c == 0:
                    continue
                cols = slice(t * bk, (t + 1) * bk)
                s = torch.einsum("krd,tkd->krt", qr, kp[b, cols]) * sc
                if c == 1:
                    p_ = pp[b, cols][None, :]
                    vis = (p_ >= 0) & (p_ <= qpr)
                    if window:
                        vis &= p_ > qpr - window
                    s = s.masked_fill(~vis[None], NEG)
                mx = torch.maximum(m, s.amax(-1))
                alpha = torch.exp2(m - mx)
                p = torch.exp2(s - mx[..., None])
                l = l * alpha + p.sum(-1)
                if round_p:
                    p = p.to(torch.bfloat16).float()
                o = o * alpha[..., None] + torch.einsum("krt,tkd->krd", p,
                                                        vp[b, cols])
                m = mx
            out[b, :, rows] = o / torch.where(l == 0, 1.0, l)[..., None]
    out = out.reshape(B, Hkv, S, G, D).permute(0, 2, 1, 3, 4).reshape(
        B, S, Hq, D)
    return out.to(torch.bfloat16).float() if round_p else out


def _emulation_case(layout, Hq, Hkv, D, seed):
    """A small case of ``layout`` (S cut to 64 queries, T to 256 slots, a
    ring that wraps) with bf16-valued fp32 inputs from a seed."""
    rng = np.random.default_rng(seed)
    B, S, T = 2, 64, 256
    q0, lens, window = {
        "prefill_padded": (0, [64, 23], None),
        "ring_wrap": (220, [64, 64], None),
        "window": (200, [64, 41], 90),
        "prefix_suffix": (128, [16, 57], None),
    }[layout]
    qp = np.broadcast_to(np.arange(q0, q0 + S, dtype=np.int32), (B, S)).copy()
    kvp = _ring(B, T, [q0 + S] * B)
    for b, n in enumerate(lens):
        for p in range(q0 + n, q0 + S):
            kvp[b, p % T] = -1

    def bf16(*shape):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return x.to(torch.bfloat16).float()

    return (bf16(B, S, Hq, D), bf16(B, T, Hkv, D), bf16(B, T, Hkv, D),
            torch.from_numpy(qp), torch.from_numpy(kvp), window)


def _pallas(q, k, v, qp, kvp, window):
    return torch.from_numpy(np.array(pallas_flash(
        *(jnp.asarray(x.numpy()) for x in (q, k, v, qp, kvp)),
        window=window, interpret=True)))


EMULATION_CASES = [("prefill_padded", 4, 4, 64, 128), ("ring_wrap", 8, 2, 64, 64),
                   ("window", 8, 4, 128, 128), ("prefix_suffix", 4, 1, 256, 64)]


@pytest.mark.parametrize("layout, Hq, Hkv, D, R", EMULATION_CASES)
def test_emulation_matches_pallas(layout, Hq, Hkv, D, R):
    """Without rounding, the tile's blockwise walk (skipped tiles unread,
    full tiles unmasked) computes the Pallas kernel's function."""
    q, k, v, qp, kvp, window = _emulation_case(layout, Hq, Hkv, D, seed=3)
    seen = tatt.make_causal_mask(qp, kvp, kvp >= 0, window).any(-1)
    got = wgmma_emulated(q, k, v, qp, kvp, window=window, round_p=False, R=R)
    want = _pallas(q, k, v, qp, kvp, window)
    torch.testing.assert_close(got[seen], want[seen], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("layout, Hq, Hkv, D, R", EMULATION_CASES)
def test_rounded_emulation_within_rel_tol_of_pallas(layout, Hq, Hkv, D, R):
    """P rounded to bf16 before P.V and the output rounded to bf16 stay
    within REL_TOL[bf16] of the weighted |v| of the Pallas kernel's fp32
    result: the tolerance chip_smoke holds the kernel to."""
    q, k, v, qp, kvp, window = _emulation_case(layout, Hq, Hkv, D, seed=4)
    seen = tatt.make_causal_mask(qp, kvp, kvp >= 0, window).any(-1)
    got = wgmma_emulated(q, k, v, qp, kvp, window=window, R=R)[seen]
    ref = _pallas(q, k, v, qp, kvp, window)[seen]
    ref_abs = _pallas(q, k, v.abs(), qp, kvp, window)[seen]
    tol = chip_smoke.REL_TOL[torch.bfloat16] * ref_abs + 1e-6
    assert torch.isfinite(got).all()
    assert ((got - ref).abs() / tol).max().item() <= 1.0


# -- launch order, shared memory, rows per block ------------------------------


@pytest.mark.parametrize("B, S, G, Hkv, R", [
    (1, 2048, 1, 32, 128), (4, 128, 1, 32, 128), (2, 100, 4, 2, 64),
    (4, 128, 48, 1, 128), (4, 128, 1, 16, 64)])
def test_heaviest_query_tiles_launch_first(B, S, G, Hkv, R):
    """Every (query tile, KV head, batch row) is one block, and query
    tiles launch last-first (a tile's causal walk grows with its index)."""
    order = fa.wgmma_blocks(B, S, G, Hkv, R)
    n = -(-S * G // R)
    assert sorted(order) == sorted((x, hk, b) for x in range(n)
                                   for hk in range(Hkv) for b in range(B))
    tiles = [x for x, _, _ in order]
    assert tiles == sorted(tiles, reverse=True) and tiles[0] == n - 1


@pytest.mark.parametrize("D", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("rows", fa.WGMMA_ROWS)
def test_wgmma_smem_fits(D, dtype, rows):
    plan = fa.kernel_plan(dtype, D, rows=rows)
    assert plan.impl == "wgmma" and plan.rows == rows
    assert plan.smem == fa.wgmma_smem_bytes(D, rows) <= _build.SMEM_LIMIT


@pytest.mark.parametrize("B, S, Hq, Hkv, D, want", [
    (1, 2048, 32, 32, 128, 128),  # k1_7b_long: 512 blocks of 128 rows
    (4, 128, 32, 32, 128, 128),   # the engine's prefill: 128 blocks
    (2, 200, 32, 8, 128, 128),    # k1_fp16: 112 blocks leave 20 SMs idle
    (4, 128, 16, 16, 256, 64),    # GPT-J's prefill: 64 blocks, half idle
    (2, 100, 8, 2, 64, 64),       # k1_d64_gqa: 16 blocks
    (4, 128, 48, 1, 128, 128),    # StarCoder's 48 heads: 192 blocks
    (4, 64, 32, 32, 128, 64),     # the sp 2 chunk: 128 blocks, half empty
])
def test_wgmma_rows_fill_the_card(B, S, Hq, Hkv, D, want):
    """128 flat rows a block unless that grid leaves half the SMs idle or
    its blocks are half empty."""
    plan = fa.kernel_plan(torch.bfloat16, D, B=B, S=S, Hq=Hq, Hkv=Hkv,
                          sms=132)
    assert plan.rows == want == fa.wgmma_rows(B, S, Hq // Hkv, Hkv, 132)
    with pytest.raises(_build.KernelError, match="rows a block"):
        fa.kernel_plan(torch.bfloat16, D, rows=32)


def test_mirrors_follow_the_source():
    """The Python mirrors' constants are the kernel's."""
    for text in ("static constexpr int ROWS = 64 * NC;",
                 "if (rows == 128) return dispatch_d<T, 2, kState>(a, B, D, s);",
                 "if (rows == 64) return dispatch_d<T, 1, kState>(a, B, D, s);",
                 "static constexpr int BK = D <= 128 ? 128 : 64;",
                 "static constexpr int STAGES = D == 64 ? 3 : 2;",
                 "constexpr int fma_slots(int D) { return D > 128 ? 32 : 64; }",
                 "static constexpr size_t bytes = 1024 + BAR_OFF + STAGES * 16;"):
        assert text in SOURCE, text
    assert fa.WGMMA_ROWS == (128, 64)
    assert [fa.wgmma_slots(D) for D in fa.HEAD_DIMS] == [128, 128, 64]
    assert [fa.wgmma_stages(D) for D in fa.HEAD_DIMS] == [3, 2, 2]
    assert [fa.fma_slots(D) for D in fa.HEAD_DIMS] == [64, 64, 32]


@pytest.mark.parametrize("D", fa.HEAD_DIMS)
@pytest.mark.parametrize("rows", fa.FMA_ROWS)
def test_fma_smem_fits(D, rows):
    smem = fa.fma_smem_bytes(D, rows)
    assert smem <= _build.SMEM_LIMIT
    if D == 256 and rows <= 32:  # two blocks an SM
        assert 2 * (smem + _build.BLOCK_RESERVED_BYTES) <= _build.SM_SHARED_BYTES


@pytest.mark.parametrize("B, S, Hq, D, want", [
    (2, 100, 8, 256, 16),   # k1_d256_fp32: 112 blocks of 16 rows
    (4, 128, 32, 128, 64),  # 256 blocks of 64 rows fill 132 SMs
    (1, 128, 32, 64, 16),   # 64-row blocks: 64; 32-row: 128 < 132; 16: 256
    (2, 200, 8, 64, 16),
    (4, 512, 32, 256, 32),  # at most 32 at D 256
    (1, 16, 1, 128, 16),    # nothing fills the card: the fewest rows
])
def test_fma_rows_fill_the_card(B, S, Hq, D, want):
    rows = fa.fma_rows(B, S, Hq, D, sms=132)
    assert rows == want
    plan = fa.kernel_plan(torch.float32, D, B=B, S=S, Hq=Hq, sms=132)
    assert plan == ("fma", fa.fma_smem_bytes(D, rows), rows)


# -- the TMA maps' preconditions ----------------------------------------------


def _views(width, offset=0, dtype=torch.bfloat16):
    """[1, 16, 2, 64] views into rows of ``width`` elements from element
    ``offset`` of a fresh buffer."""
    base = torch.zeros(1 * 16 * 2 * width + 64, dtype=dtype)
    return base[offset:offset + 16 * 2 * width].view(1, 16, 2, width)[..., :64]


@pytest.mark.parametrize("impl, dtype", [("wgmma", torch.bfloat16),
                                         ("fma", torch.float32)])
def test_tma_preconditions_raise(impl, dtype):
    """Strides that are not multiples of 16 bytes, or a base that is not
    16-byte aligned, raise KernelError; aligned views pass."""
    ok = _views(72, 0, dtype)
    out = torch.empty(1, 16, 2, 64, dtype=dtype)
    assert fa.launch_strides(ok, ok, ok, out, impl)[:3] == (2304, 144, 72)
    narrow = _views(68 if impl == "wgmma" else 66, 0, dtype)
    with pytest.raises(_build.KernelError, match="multiples of"):
        fa.launch_strides(ok, narrow, ok, out, impl)
    shifted = _views(72, 1, dtype)
    assert shifted.data_ptr() % 16
    with pytest.raises(_build.KernelError, match="16-byte aligned"):
        fa.launch_strides(ok, ok, shifted, out, impl)


# -- symbols ------------------------------------------------------------------


def test_every_k1_kernel_is_counted_under_graph_replay():
    """Every __global__ of csrc/flash_attention.cu is one of K1's symbols,
    so a captured step graph counts each of its launches."""
    kernels = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+"
                         r"(\w+)\(", SOURCE)
    assert sorted(kernels) == sorted(graphs.KERNEL_SYMBOLS["flash_attention"])
