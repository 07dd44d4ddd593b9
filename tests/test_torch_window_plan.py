"""K2w's launch plan (``ops/decode_attention.window_plan``) at every kernel
case of chip_smoke.py, and the window tile's shared memory against
csrc/group_tile.cuh, whose tile csrc/window_attention.cu runs. The kernel itself runs on the card only
(chip_smoke.py holds it to its plain version there)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from llmss_tpu_torch.engine import graphs
from llmss_tpu_torch.ops import _build
from llmss_tpu_torch.ops import decode_attention as da
from llmss_tpu_torch.ops import split_plan as sp

SHAPES = {s[0]: s for s in chip_smoke.K2W_SHAPES}
REL_TOL_BF16 = chip_smoke.REL_TOL[torch.bfloat16]
SM_SHARED_BYTES = 228 * 1024  # an H100 SM's shared memory
BLOCK_RESERVED = 1024  # what the card reserves of it per block


def _plan(name, **kw):
    _, B, _, Hq, Hkv, _, t_len, S, opts = SHAPES[name]
    dt = opts.get("dt", torch.bfloat16)
    return da.window_plan(dt, B, Hq, Hkv, opts.get("D", 128), t_len, S,
                          **kw), (B, Hq, Hkv, t_len, S, dt)


# Window rows per block and slot-parallel warps of the bf16 windows: one
# row warp per 16 of G * S rows (at most 4), with 4 slot warps at one row
# warp, else 2.
WANT_ROWS = {
    "k2w_engine_verify": (16, 4), "k2w_engine_verify_b4": (16, 4),
    "k2w_s2": (16, 4),
    "k2w_7b_full_wrap": (16, 4), "k2w_7b_holes": (16, 4),
    "k2w_s8": (16, 4), "k2w_gqa4": (32, 2), "k2w_qwen2": (48, 2),
    "k2w_starcoder": (64, 2), "k2w_d64": (16, 4), "k2w_gptj_d256": (16, 4),
}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_window_plan_at_every_case(name):
    """The template, rows per block and slot warps each case takes; the
    tile's splits (one cluster) at most 8 and covering the read in whole
    64-slot tiles; the lanes' at most MAX_SPLITS; shared memory within a
    block's limit."""
    plan, (B, Hq, Hkv, t_len, S, dt) = _plan(name)
    assert plan.splits * plan.split_slots >= t_len
    assert plan.smem <= _build.SMEM_LIMIT
    if name in WANT_ROWS:
        assert plan.impl == "mma"
        assert (plan.rows, plan.slot_warps) == WANT_ROWS[name]
        assert 1 <= plan.splits <= da.WINDOW_MAX_CLUSTER == 8
        # up to 4 splits folded in their cluster, more by window_merge
        assert plan.cluster == (plan.splits if plan.splits <= 4 else 0)
        assert plan.split_slots % sp.TILE_STEP == 0
        assert (plan.splits - 1) * plan.split_slots < t_len  # no empty split
        rw = plan.rows // da.WINDOW_TILE_ROWS
        assert plan.smem == _build.window_tile_smem_bytes(
            SHAPES[name][8].get("D", 128), rw)
    else:  # fp32
        assert plan.impl == "lanes" and plan.cluster == 0
        assert plan.rows == da._heads_per_block(Hq // Hkv * S)
        assert plan.slot_warps == sp.NWARP
        assert plan.splits <= sp.MAX_SPLITS


def test_verify_shape_fits_two_blocks_an_sm():
    """Llama-2-7B's verify window (batch 16, gamma 4, MHA, the 384-slot
    bucket): 16 rows a block, two blocks' shared memory on one SM, and
    unsplit, since its 512 blocks already take two rounds of the 264 the
    card holds; at batch 4 (128 blocks, half the SMs or more) unsplit for
    its 6 tiles, 2 splits over the whole 1024-slot ring."""
    plan, _ = _plan("k2w_engine_verify")
    assert (plan.impl, plan.rows, plan.splits, plan.split_slots,
            plan.cluster) == ("mma", 16, 1, 384, 1)
    assert SM_SHARED_BYTES // (plan.smem + BLOCK_RESERVED) == 2
    assert (_build.SM_SHARED_BYTES, _build.BLOCK_RESERVED_BYTES) == (
        SM_SHARED_BYTES, BLOCK_RESERVED)
    plan, _ = _plan("k2w_engine_verify_b4")
    assert (plan.splits, plan.split_slots, plan.cluster) == (1, 384, 1)
    plan, _ = _plan("k2w_7b_full_wrap")
    assert (plan.splits, plan.split_slots, plan.cluster) == (2, 512, 2)


@pytest.mark.parametrize("name", sorted(WANT_ROWS))
def test_window_split_keeps_one_round(name):
    """The tile splits only while the split grid fits the blocks the card
    holds at once (132 SMs), and no further than 8 or the read's tiles; a
    read of at most 8 tiles over 66 blocks or more stays whole."""
    plan, (B, Hq, Hkv, t_len, S, _) = _plan(name)
    blocks = B * Hkv * -(-(Hq // Hkv * S) // plan.rows)
    cap = sp.H100_SMS * (SM_SHARED_BYTES // (plan.smem + BLOCK_RESERVED))
    tiles = -(-t_len // 64)
    short = tiles <= da.WINDOW_SHORT_TILES == 8 and 2 * blocks >= sp.H100_SMS
    assert plan.splits == 1 or (plan.splits * blocks <= cap and not short)
    if plan.splits < min(8, tiles) and not short:  # one more takes a round
        assert (plan.splits + 1) * blocks > cap


def test_long_read_widens_the_split_not_the_cluster():
    """A read of the whole 4096-slot ring over few blocks keeps 8 splits,
    each wider."""
    plan = da.window_plan(torch.bfloat16, 1, 32, 8, 128, 4096, 5)
    assert (plan.splits, plan.split_slots) == (8, 512)
    plan = da.window_plan(torch.bfloat16, 1, 32, 8, 128, 4096, 5,
                          max_splits=1)
    assert (plan.splits, plan.cluster) == (1, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("S", [2, 5, 8])
def test_fp32_and_fp16_windows_stay_on_the_lanes(dtype, S):
    for Hq, Hkv in ((32, 32), (28, 4), (48, 1)):
        plan = da.window_plan(dtype, 4, Hq, Hkv, 128, 384, S)
        assert plan.impl == "lanes" and plan.cluster == 0


def test_forced_splits_and_two_launch_form():
    """chip_smoke.py times the tile at the verify shape in its two-launch
    form (``cluster=False``) and at forced split counts (``splits``)."""
    bf16 = torch.bfloat16
    two = da.window_plan(bf16, 16, 32, 32, 128, 384, 5, cluster=False)
    one = da.window_plan(bf16, 16, 32, 32, 128, 384, 5)
    assert two.cluster == 0 and two._replace(cluster=one.cluster) == one
    forced = da.window_plan(bf16, 16, 32, 32, 128, 384, 5, splits=3)
    assert (forced.splits, forced.split_slots, forced.cluster) == (3, 128, 3)
    forced = da.window_plan(bf16, 16, 32, 32, 128, 384, 5, splits=6)
    assert (forced.splits, forced.cluster) == (6, 0)
    forced = da.window_plan(bf16, 16, 32, 32, 128, 384, 5, splits=6,
                            cluster=True)
    assert (forced.splits, forced.cluster) == (6, 6)
    assert da.window_plan(bf16, 16, 32, 32, 128, 384, 5, splits=20).splits == 6
    assert da.WINDOW_IMPL_CODES == {"lanes": 0, "mma": 1, "mma_two_launch": 2}


@pytest.mark.parametrize("D", _build.HEAD_DIMS)
@pytest.mark.parametrize("row_warps", [1, 2, 3, 4])
def test_window_tile_smem_fits(D, row_warps):
    assert _build.window_tile_smem_bytes(D, row_warps) <= _build.SMEM_LIMIT


def test_window_tile_smem_matches_the_source():
    """window_tile_smem_bytes mirrors ``wt::Smem<D, RW>``: a ring of 3
    stages (2 at D 256) of K and V tiles of 64 rows of D + 8 bf16
    elements, reused by the slot warps' fp32 state [SW][R][D + 8]; Q
    [R][D + 8] bf16 at D 256; the fresh V [8][D] bf16; 512 positions and
    two tile masks; m and l [SW][R] and [R]; the fresh scores [R][8]. The
    struct is the group tile's (csrc/group_tile.cuh), which window_mma
    runs."""
    src = (_build.CSRC / "group_tile.cuh").read_text()
    assert "wt::run<D, RW, kCluster ? wt::kCluster : wt::kWorkspace>" in (
        _build.CSRC / "window_attention.cu").read_text()
    for line in (
            "constexpr int kSlots = 64;",
            "constexpr int kPosWin = 512;",
            "template <int D> constexpr int kStages = D > 128 ? 2 : 3;",
            "template <int RW> constexpr int kSlotWarps = RW == 1 ? 4 : 2;",
            "static constexpr int R = 16 * RW;",
            "static constexpr int LD = D + 8;",
            "static constexpr bool kQSmem = D > 128;",
            "ring = kStages<D> * 2 * KV * sizeof(__nv_bfloat16);",
            "state = size_t(SW) * R * LD * sizeof(float);",
            "q = kQSmem ? size_t(R) * LD * sizeof(__nv_bfloat16) : 0;",
            "vn = size_t(kMaxWin) * D * sizeof(__nv_bfloat16);",
            "bytes = region + q + vn + sizeof(int) * (kPosWin + 2) +",
            "sizeof(float) * (2 * SW * R + 2 * R + R * kMaxWin);",
            "constexpr int kMaxWin = 8;"):
        assert line in src, line
    assert _build.window_tile_smem_bytes(128, 1) == (
        3 * 2 * 64 * 136 * 2 + 8 * 128 * 2 + 4 * 514
        + 4 * (2 * 4 * 16 + 2 * 16 + 16 * 8)) == 109704
    assert _build.window_tile_smem_bytes(256, 4) == (
        2 * 2 * 64 * 264 * 2 + 64 * 264 * 2 + 8 * 256 * 2 + 4 * 514
        + 4 * (2 * 2 * 64 + 2 * 64 + 64 * 8))


def test_kernel_symbols_name_the_window_tile():
    """A step graph's K2w nodes are read by symbol: the window tile's
    instantiations (mangled, as libcuda names them) count as
    decode_window_attention, its lanes too, and window_merge does not."""
    fn = da.decode_window_attention
    src = (_build.CSRC / "window_attention.cu").read_text()
    assert "window_mma(WinArgs a)" in src and "window_fwd(WinArgs a)" in src
    assert graphs.KERNEL_SYMBOLS["decode_window_attention"] == (
        "window_fwd", "window_mma")
    tile = "_ZN5llmss12_GLOBAL__N_110window_mmaILi128ELi1ELb1EEEvNS0_7WinArgsE"
    lanes = ("_ZN5llmss12_GLOBAL__N_110window_fwdI13__nv_bfloat16Li128ELi2E"
             "Lb0EEEvNS0_7WinArgsE")
    merge = ("_ZN5llmss12_GLOBAL__N_112window_mergeI13__nv_bfloat16Li128EEEv"
             "NS0_12WinMergeArgsE")
    assert graphs.node_launches([tile], [(fn, 1)]) == [(fn, 1)]
    assert graphs.node_launches([lanes, merge], [(fn, 1)]) == [(fn, 1)]
    with pytest.raises(RuntimeError):
        graphs.node_launches([merge], [(fn, 1)])


# -- the window tile's arithmetic ---------------------------------------------


def window_tile_emulation(q, kc, vc, kn, vn, q0, kvp, slot0, *, splits,
                          split, slot_warps):
    """window_mma's arithmetic in torch on fp32 copies of bf16 values: per
    split of ``split`` slots, per 64-slot tile holding a visible slot, each
    of the ``slot_warps`` warps runs its own online softmax over its 64 /
    ``slot_warps`` slots of the tile (scores in log2 units, exp2, P rounded
    to bf16 before P.V, the row sum of the unrounded P); the slot warps'
    states are folded in warp order, then the splits' in split order, then
    the fresh keys j <= i in fp32. ``kc`` / ``vc`` are one layer [B, T,
    Hkv, D]."""
    B, S, Hq, D = q.shape
    T, Hkv = kc.shape[1], kc.shape[2]
    G, nj = Hq // Hkv, 64 // slot_warps
    c = D ** -0.5 * 1.4426950408889634
    neg = torch.finfo(torch.float32).min
    out = torch.empty(B, S, Hq, D)
    for b in range(B):
        t = torch.arange(T)
        vis = (kvp[b] >= 0) & (kvp[b] < q0[b]) & ((t - slot0[b]) % T >= S)
        for h in range(Hq):
            hk = h // G
            for i in range(S):
                qv = q[b, i, h]
                states = []
                for s in range(splits):
                    lo, hi = s * split, min(T, (s + 1) * split)
                    warps = [[neg, 0.0, torch.zeros(D)]
                             for _ in range(slot_warps)]
                    for t0 in range(lo, hi, 64):
                        if not vis[t0:min(hi, t0 + 64)].any():
                            continue  # a tile no row sees is never copied
                        for w, st in enumerate(warps):
                            a0, a1 = t0 + w * nj, min(hi, t0 + (w + 1) * nj)
                            if a0 >= a1 or not vis[a0:a1].any():
                                continue
                            idx = torch.arange(a0, a1)
                            v_ = vis[idx]
                            sc = torch.where(v_, kc[b, idx, hk] @ qv * c,
                                             torch.tensor(neg))
                            mx = max(st[0], sc.max().item())
                            alpha = 2.0 ** (st[0] - mx)
                            p = torch.where(v_, torch.exp2(sc - mx), 0.0)
                            st[1] = st[1] * alpha + p.sum().item()
                            pr = p.to(torch.bfloat16).float()
                            st[2] = st[2] * alpha + pr @ vc[b, idx, hk]
                            st[0] = mx
                    M = max(st[0] for st in warps)
                    f = [2.0 ** (st[0] - M) for st in warps]
                    states.append((M, sum(st[1] * x for st, x in zip(warps, f)),
                                   sum(st[2] * x for st, x in zip(warps, f))))
                sn = kn[b, : i + 1, hk] @ qv * c
                M = max([m for m, _, _ in states] + [sn.max().item()])
                den, o = 0.0, torch.zeros(D)
                for m, l_, acc in states:
                    x = 0.0 if m == neg else 2.0 ** (m - M)
                    den, o = den + l_ * x, o + acc * x
                pn = torch.exp2(sn - M)
                out[b, i, h] = (o + pn @ vn[b, : i + 1, hk]) / (den + pn.sum())
    return out


@pytest.mark.parametrize("Hq, Hkv, S, cur, splits", [
    (4, 4, 5, [150, 3, 0], 1),      # MHA: an empty row, a short one
    (4, 2, 4, [180, 260, 40], 2),   # GQA, a wrapped row, two splits
    (6, 1, 8, [200, 90, 7], 3),     # MQA, a window over the ring's end
])
def test_window_tile_arithmetic_matches_jax(Hq, Hkv, S, cur, splits):
    """The tile's split, slot-warp and cluster folds, with P rounded to
    bf16, stay within chip_smoke.py's bf16 tolerance (REL_TOL, times the
    row's softmax-weighted mean |v|) of the reference's XLA oracle
    ``fresh_kv_window_attention``, at every slot-warp count."""
    import jax.numpy as jnp

    from llmss_tpu.ops.attention import fresh_kv_window_attention as jwindow
    from llmss_tpu.ops.attention import window_mask_penalty as jpenalty

    T, D = 200, 16
    rng = np.random.default_rng(sum(cur))
    bf = lambda *s: torch.tensor(rng.standard_normal(s), dtype=torch.float32  # noqa: E731
                                 ).to(torch.bfloat16).float()
    B = len(cur)
    q, kn, vn = bf(B, S, Hq, D), bf(B, S, Hkv, D), bf(B, S, Hkv, D)
    kc, vc = bf(B, T, Hkv, D), bf(B, T, Hkv, D)
    kvp = np.full((B, T), -1, np.int32)
    for b, n in enumerate(cur):
        for p in range(n):
            kvp[b, p % T] = p
    q0 = np.asarray(cur, np.int32)
    slots = (q0[:, None] + np.arange(S, dtype=np.int32)) % T
    pen = jpenalty(jnp.asarray(q0[:, None]), jnp.asarray(kvp),
                   jnp.asarray(slots))

    def oracle(v, v_new):
        return torch.tensor(np.asarray(jwindow(
            jnp.asarray(q.numpy()), jnp.asarray(kc.numpy()),
            jnp.asarray(v.numpy()), jnp.asarray(kn.numpy()),
            jnp.asarray(v_new.numpy()), pen)))

    want, want_abs = oracle(vc, vn), oracle(vc.abs(), vn.abs())
    split = -(-(-(-T // 64)) // splits) * 64
    for sw in (1, 2, 4):
        got = window_tile_emulation(
            q, kc, vc, kn, vn, torch.tensor(q0), torch.tensor(kvp),
            torch.tensor(slots[:, 0]), splits=splits, split=split,
            slot_warps=sw)
        ratio = ((got - want).abs() / (REL_TOL_BF16 * want_abs + 1e-6)).max()
        assert ratio <= 1.0, (sw, ratio)
