"""The split over the KV axis (flash-decoding) of the decode kernels K2
and K3, on the CPU: the host's split plan, and a torch emulation of the
split kernels' arithmetic and of their merge (csrc/split_merge.cuh).

The emulation cuts a row's read into the plan's splits, keeps for each
split an fp32 state (running max m, sum l, accumulator acc) with P taken
relative to the split's own max and, when asked, rounded to bf16 before
P.V, as the kernels round it; then folds the live splits in split order
in fp32, the fresh key last. Without rounding it computes the JAX
package's XLA oracles (``llmss_tpu.ops.attention.paged_decode_attention``
and ``fresh_kv_decode_attention``) to 1e-5: both sides are fp32 and only
the order of accumulation differs. With bf16 rounding it stays within
``chip_smoke.REL_TOL`` (2^-7 x the row's softmax-weighted mean |v|) of the
plain version at the main path's K3 and K2 shapes, cut to 2 KV heads.
Inputs come from numpy with a seed.
"""

import importlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from llmss_tpu_torch.ops import _build
from llmss_tpu_torch.ops import decode_attention as da
from llmss_tpu_torch.ops import paged_attention as pa
from llmss_tpu_torch.ops import split_plan as sp

# llmss_tpu.ops rebinds its ``attention`` attribute to the function.
jatt = importlib.import_module("llmss_tpu.ops.attention")
NEG = float(torch.finfo(torch.float32).min)
TOL = dict(rtol=1e-5, atol=1e-5)
BF16 = torch.bfloat16
SERVE_CTX = [700, 45, 300, 812, 128, 33, 560, 400]


# -- the plan -----------------------------------------------------------------


H100 = dict(sms=sp.H100_SMS)


def _fits_one_split():
    # 512 blocks already fill the card: a 120-slot read is one split.
    S, split = sp.split_plan(16, 32, 120, 16, step=32, **H100)
    assert S == 1 and split == 128


def _main_path_shapes_split():
    # K3's 832-slot serve read splits. K2's 192-slot engine bucket on 128
    # blocks is a short read on a grid that nearly fills the card: whole.
    k3 = pa.kernel_plan(BF16, 1, 1, 128, B=8, Hkv=32, n_slots=52 * 16, bs=16)
    k2 = da.kernel_plan(BF16, 4, 32, 32, 128, 192)
    assert k3.splits > 1 and k3.splits * k3.split_slots >= 832
    assert (k2.splits, k2.split_slots) == (1, 192)
    # Past two splits' worth, or on a grid that leaves most SMs idle, K2
    # splits too: the engine's 640-slot bucket, one row at 192 slots.
    assert da.kernel_plan(BF16, 4, 32, 32, 128, 640).splits > 1
    assert da.kernel_plan(BF16, 1, 32, 32, 128, 192).splits > 1


def _short_read_threshold():
    # A read of at most SHORT_READ slots stays whole on a grid of at least
    # sms / 2 blocks, and splits below it; one slot more always splits.
    n = sp.SHORT_READ
    assert sp.split_plan(1, 66, n, step=32, **H100)[0] == 1
    assert sp.split_plan(1, 65, n, step=32, **H100)[0] > 1
    assert sp.split_plan(1, 66, n + 1, step=32, **H100)[0] > 1


def _target_follows_the_sm_count():
    # The split shrinks until the grid has two blocks per SM of the card
    # (or S reaches its cap): more SMs, shorter splits.
    got = []
    for sms in (66, 132, 264):
        S, split = sp.split_plan(4, 8, 1024, 16, step=32, sms=sms)
        assert 4 * 8 * S >= 2 * sms or S == sp.MAX_SPLITS
        got.append(split)
    assert got == [128, 96, 64]


def _multiples_of_block_and_step():
    for bs in (8, 16, 24, 32):
        for step in (16, 32, 64):
            for n in (1, 100, 832, 5000):
                for B, bpr in ((1, 8), (8, 32)):
                    S, split = sp.split_plan(B, bpr, n, bs, step=step, **H100)
                    assert split % bs == 0 and split % step == 0
                    assert S * split >= n and (S == 1 or (S - 1) * split < n)


def _at_most_sixteen():
    S, split = sp.split_plan(1, 1, 100_000, 16, step=32, **H100)
    assert S == sp.MAX_SPLITS == 16 and 16 * split >= 100_000
    assert sp.split_plan(1, 1, 5000, 16, step=32, max_splits=1, **H100)[0] == 1


def _only_decode_chunks_split():
    # The lane template splits only at CB == 1; mma never does.
    assert pa.kernel_plan(torch.float32, 16, 2, 128, B=1, Hkv=1,
                          n_slots=4096).splits == 1
    assert pa.kernel_plan(BF16, 128, 1, 128, B=1, Hkv=1,
                          n_slots=4096)[2:] == (1, 0)


PLAN_CASES = {
    "fits_one_split": _fits_one_split,
    "main_path_shapes_split": _main_path_shapes_split,
    "short_read_threshold": _short_read_threshold,
    "target_follows_the_sm_count": _target_follows_the_sm_count,
    "multiples_of_block_and_step": _multiples_of_block_and_step,
    "at_most_sixteen": _at_most_sixteen,
    "only_decode_chunks_split": _only_decode_chunks_split,
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_split_plan(case):
    PLAN_CASES[case]()


def test_kernel_plan_reports_the_split():
    """kernel_plan names the instantiation, its shared memory and the
    split; K3 and an all-decode K4 at CB = 1 take one plan (the
    precondition of their bit identity)."""
    k3 = pa.kernel_plan(BF16, 1, 1, 128, B=8, Hkv=32, n_slots=832, bs=16)
    assert k3 == sp.Plan("lanes", k3.smem, sp.split_plan(
        8, 32, 832, 16, step=sp.lane_step(128), **H100)[0], k3.split_slots)
    assert (k3.impl, k3.splits, k3.split_slots) == ("lanes", 7, 128)
    assert k3.smem <= _build.SMEM_LIMIT
    # max_splits=1 is the unsplit launch chip_smoke.py times beside it.
    assert pa.kernel_plan(BF16, 1, 1, 128, B=8, Hkv=32, n_slots=832, bs=16,
                          max_splits=1)[1:] == (k3.smem, 1, 832)
    k2 = da.kernel_plan(BF16, 4, 32, 32, 128, 192)
    assert (k2.impl, k2.splits, k2.split_slots) == ("lanes", 1, 192)
    assert k2.smem <= _build.SMEM_LIMIT
    k2_full = da.kernel_plan(BF16, 4, 32, 32, 128, 1024)
    assert (k2_full.splits, k2_full.split_slots) == (8, 128)
    assert da.kernel_plan(BF16, 4, 32, 32, 128, 1024,
                          max_splits=1)[2:] == (1, 1024)
    assert pa.kernel_plan(BF16, 128, 1, 128)[0] == "mma"


def test_python_mirrors_the_sources():
    """The plan's constants are the kernels' (csrc/split_merge.cuh), and a
    stage's slots are the lane template's Cfg::SLOTS."""
    src = (_build.CSRC / "split_merge.cuh").read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(const["kStage"]) == sp.STAGE_SLOTS
    assert int(const["kSteps"]) == sp.STEPS
    assert int(const["kMaxSplits"]) == sp.MAX_SPLITS
    assert "STAGES = sizeof(T) == 4 ? 2 : 4" in src
    for name in ("decode_attention.cu", "paged_attention.cu"):
        assert "SLOTS = STEP * kSteps" in (_build.CSRC / name).read_text()
    assert sp.lane_step(128) == 32 and sp.lane_step(64) == 64
    assert sp.lane_region_bytes(2, 1, 128) == 65536
    assert sp.lane_region_bytes(4, 8, 256) == 65536


# -- the emulation ------------------------------------------------------------


def split_states(q, k, v, vis, split, live, round_p):
    """Each live split's fp32 state, per row: [(m, l, acc)] with m, l
    [Hkv, G] and acc [Hkv, G, D]. q [B, Hq, D]; k, v [B, T, Hkv, D], a
    row's slots in order; vis [B, T]; live [B] live splits."""
    B, T, Hkv, D = k.shape
    G = q.shape[1] // Hkv
    s = torch.einsum("bkgd,btkd->bkgt", q.reshape(B, Hkv, G, D), k) / D ** 0.5
    s = s.masked_fill(~vis[:, None, None, :], NEG)
    out = []
    for b in range(B):
        parts = []
        for i in range(int(live[b])):
            cut = slice(i * split, min((i + 1) * split, T))
            m = s[b, :, :, cut].amax(-1)  # NEG where nothing is visible
            p = torch.exp(s[b, :, :, cut] - m[..., None])
            p = p.masked_fill(~vis[b, cut], 0.0)
            pr = p.to(BF16).float() if round_p else p
            parts.append((m, p.sum(-1), torch.einsum("kgt,tkd->kgd", pr, v[b, cut])))
        out.append(parts)
    return out


def merge(q, k_new, v_new, states, round_out):
    """split_merge: per row, the live splits folded in split order under
    their common max, then the fresh key; [B, Hq, D]."""
    B, Hq, D = q.shape
    Hkv = k_new.shape[1]
    G = Hq // Hkv
    sn = torch.einsum("bkgd,bkd->bkg", q.reshape(B, Hkv, G, D), k_new) / D ** 0.5
    out = torch.empty(B, Hkv, G, D)
    for b, parts in enumerate(states):
        M = sn[b]
        for m, _, _ in parts:
            M = torch.maximum(M, m)
        den = torch.zeros(Hkv, G)
        acc = torch.zeros(Hkv, G, D)
        for m, l, a in parts:
            sc = torch.where(m == NEG, 0.0, torch.exp(m - M))
            den = den + l * sc
            acc = acc + a * sc[..., None]
        pn = torch.exp(sn[b] - M)
        out[b] = (acc + pn[..., None] * v_new[b][:, None, :]) / (den + pn)[..., None]
    out = out.reshape(B, Hq, D)
    return out.to(BF16).float() if round_out else out


def _normal(rng, *shape, bf16=False):
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return x.to(BF16).float() if bf16 else x


def paged_case(rng, Hq, Hkv, ctx, *, D, bs, MB, n_cols=None, window=None,
               bf16=False):
    """Rows whose histories are positions 0..ctx[b]-1 over a block pool
    (one layer, blocks scattered, sentinel columns past them, one spare
    block as in the port), each decoding one token at position ctx[b]."""
    B, ring = len(ctx), MB * bs
    need = [min(MB, -(-(c + 1) // bs)) for c in ctx]
    N = sum(need) + 2
    perm = rng.permutation(N)
    bt = np.full((B, MB), N, np.int32)
    kvp = np.full((B, ring), -1, np.int32)
    k0 = 0
    for b, (c, n) in enumerate(zip(ctx, need)):
        bt[b, :n] = perm[k0:k0 + n]
        bt[b, n:] = N + b
        k0 += n
        for p in range(c):
            kvp[b, p % ring] = p
    nblk = np.minimum(MB, -(-(kvp >= 0).sum(1) // bs)).astype(np.int32)
    return dict(
        q=_normal(rng, B, 1, Hq, D, bf16=bf16),
        kp=_normal(rng, 1, N + 1, bs, Hkv, D, bf16=bf16),
        vp=_normal(rng, 1, N + 1, bs, Hkv, D, bf16=bf16),
        kn=_normal(rng, B, 1, Hkv, D, bf16=bf16),
        vn=_normal(rng, B, 1, Hkv, D, bf16=bf16),
        qpos=torch.tensor(ctx, dtype=torch.int32)[:, None],
        kvp=torch.from_numpy(kvp), bt=torch.from_numpy(bt),
        nblk=torch.from_numpy(nblk),
        slots=torch.tensor(ctx, dtype=torch.int32)[:, None] % ring,
        N=N, bs=bs, n_cols=n_cols or MB, window=window)


def paged_emulated(c, split, round_p):
    """K3's split kernels over the pool and their merge: split s reads
    table columns [s * split / bs, (s + 1) * split / bs); splits at or
    past the row's occupied slots are not live."""
    bs, T = c["bs"], c["n_cols"] * c["bs"]
    ts = torch.arange(T)
    blk = torch.clamp(c["bt"], max=c["N"] - 1).long()[:, ts // bs]
    k, v = c["kp"][0][blk, ts % bs], c["vp"][0][blk, ts % bs]
    p = c["kvp"][:, :T]
    occupied = torch.clamp(c["nblk"], max=c["n_cols"]) * bs
    vis = ((p >= 0) & (p <= c["qpos"]) & (ts[None, :] != c["slots"])
           & (ts[None, :] < occupied[:, None]))
    if c["window"] is not None:
        vis &= p > c["qpos"] - c["window"]
    live = -(-occupied // split)
    q = c["q"][:, 0]
    states = split_states(q, k, v, vis, split, live, round_p)
    return merge(q, c["kn"][:, 0], c["vn"][:, 0], states, round_p)[:, None]


def paged_plain(c, vp, vn):
    return pa.paged_decode_attention_ref(
        c["q"], c["kp"], vp, c["kn"], vn, c["qpos"], c["kvp"], c["bt"],
        c["nblk"], c["slots"], 0, n_cols=c["n_cols"], window=c["window"])


def dense_case(rng, Hq, Hkv, hist, T, *, D, t_len, window=None, bf16=False):
    """K2's stacked cache (one layer) for rows whose histories are
    positions 0..hist[b]-1 written at slot p % T."""
    B = len(hist)
    kvp = np.full((B, T), -1, np.int32)
    for b, n in enumerate(hist):
        for p in range(n):
            kvp[b, p % T] = p
    return dict(
        q=_normal(rng, B, 1, Hq, D, bf16=bf16),
        kc=_normal(rng, 1, B, T, Hkv, D, bf16=bf16),
        vc=_normal(rng, 1, B, T, Hkv, D, bf16=bf16),
        kn=_normal(rng, B, 1, Hkv, D, bf16=bf16),
        vn=_normal(rng, B, 1, Hkv, D, bf16=bf16),
        qpos=torch.tensor(hist, dtype=torch.int32)[:, None],
        kvp=torch.from_numpy(kvp),
        slots=torch.tensor(hist, dtype=torch.int32)[:, None] % T,
        t_len=t_len, window=window)


def dense_emulated(c, split, round_p):
    """K2's split kernels over slots [0, t_len) and their merge: every
    split is live."""
    t = c["t_len"]
    p = c["kvp"][:, :t]
    vis = (p >= 0) & (p <= c["qpos"]) & (torch.arange(t)[None, :] != c["slots"])
    if c["window"] is not None:
        vis &= p > c["qpos"] - c["window"]
    live = torch.full((p.shape[0],), -(-t // split))
    q = c["q"][:, 0]
    states = split_states(q, c["kc"][0, :, :t], c["vc"][0, :, :t], vis, split,
                          live, round_p)
    return merge(q, c["kn"][:, 0], c["vn"][:, 0], states, round_p)[:, None]


def dense_plain(c, vc, vn):
    return da.decode_attention_ref(
        c["q"], c["kc"], vc, c["kn"], vn, c["qpos"], c["kvp"], c["slots"], 0,
        t_len=c["t_len"], window=c["window"])


SMALL = {
    # name: (kind, Hq, Hkv, rows, window, split); D 32, block size 16
    "paged_mha": ("paged", 4, 4, [70, 0, 33, 129], None, 48),
    "paged_gqa_window": ("paged", 4, 2, [150, 17, 64, 90], 40, 32),
    "paged_ring_wrap": ("paged", 4, 2, [170, 5, 161], None, 64),
    "dense_mha": ("dense", 4, 4, [50, 0, 95], None, 32),
    "dense_gqa_window_wrap": ("dense", 4, 1, [130, 60, 7], 30, 48),
}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_emulation_without_rounding_is_the_xla_oracle(name):
    """fp32 split and merge == the JAX package's oracle on the same
    inputs, at several splits per row (dead, partial and empty ones)."""
    kind, Hq, Hkv, rows, window, split = SMALL[name]
    rng = np.random.default_rng(sorted(SMALL).index(name))
    if kind == "paged":
        c = paged_case(rng, Hq, Hkv, rows, D=32, bs=16, MB=10, window=window)
        got = paged_emulated(c, split, round_p=False)
        T = c["n_cols"] * c["bs"]
        want = jatt.paged_decode_attention(
            *(jnp.asarray(x.numpy()) for x in (
                c["q"], c["kp"][0, :c["N"]], c["vp"][0, :c["N"]], c["kn"],
                c["vn"], c["qpos"], c["kvp"][:, :T], c["bt"], c["slots"])),
            window=window)
    else:
        c = dense_case(rng, Hq, Hkv, rows, 96, D=32, t_len=96, window=window)
        got = dense_emulated(c, split, round_p=False)
        want = jatt.fresh_kv_decode_attention(
            *(jnp.asarray(x.numpy()) for x in (
                c["q"], c["kc"][0], c["vc"][0], c["kn"], c["vn"], c["qpos"],
                c["kvp"], c["slots"])),
            window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _ratio(got, ref, ref_abs):
    tol = chip_smoke.REL_TOL[BF16] * ref_abs + 1e-6
    return ((got - ref).abs() / tol).max().item()


@pytest.mark.parametrize("case", ["k3_serve_decode", "k3_gqa", "k2_engine_decode",
                                  "k2_full_ring"])
def test_rounding_p_per_split_stays_within_rel_tol(case):
    """P rounded to bf16 relative to each split's max, the splits merged in
    fp32 and the output rounded to bf16 stay within REL_TOL[bf16] x the
    weighted |v| of the fp32 plain version, at the main path's shapes (2
    KV heads) under the split the plan picks at full width: one split at
    K2's engine bucket, several at its full ring and at K3's shapes."""
    rng = np.random.default_rng(7)
    if case.startswith("k2"):
        hist, t_len = (([n + 40 for n in (128, 100, 77, 128)], 192)
                       if case == "k2_engine_decode" else
                       ([1000, 1500, 3, 2047], 1024))
        plan = da.kernel_plan(BF16, 4, 32, 32, 128, t_len)
        c = dense_case(rng, 2, 2, hist, 1024, D=128, t_len=t_len, bf16=True)
        got = dense_emulated(c, plan.split_slots, round_p=True)
        ref = dense_plain(c, c["vc"], c["vn"])
        ref_abs = dense_plain(c, c["vc"].abs(), c["vn"].abs())
    else:
        gqa = case == "k3_gqa"
        Hkv, G = (8, 4) if gqa else (32, 1)
        n_cols = 64 if gqa else 52
        plan = pa.kernel_plan(BF16, 1, G, 128, B=8, Hkv=Hkv,
                              n_slots=n_cols * 16, bs=16)
        c = paged_case(rng, 2 * G, 2, SERVE_CTX[::-1] if gqa else SERVE_CTX,
                       D=128, bs=16, MB=64, n_cols=n_cols, bf16=True)
        got = paged_emulated(c, plan.split_slots, round_p=True)
        ref = paged_plain(c, c["vp"], c["vn"])
        ref_abs = paged_plain(c, c["vp"].abs(), c["vn"].abs())
    assert (plan.splits > 1) == (case != "k2_engine_decode")
    assert torch.isfinite(got).all()
    assert _ratio(got, ref, ref_abs) <= 1.0


def test_a_split_with_nothing_visible_contributes_nothing():
    """A live split whose slots all fall outside the window keeps m at the
    fp32 minimum, l = 0 and acc = 0, and the merge gives exactly what it
    gives without that split: no NaN."""
    rng = np.random.default_rng(11)
    c = paged_case(rng, 4, 2, [150, 90], D=32, bs=16, MB=10, window=40)
    q = c["q"][:, 0]
    split = 32
    T = c["n_cols"] * 16
    ts = torch.arange(T)
    blk = torch.clamp(c["bt"], max=c["N"] - 1).long()[:, ts // 16]
    k, v = c["kp"][0][blk, ts % 16], c["vp"][0][blk, ts % 16]
    p = c["kvp"][:, :T]
    vis = (p >= 0) & (p <= c["qpos"]) & (p > c["qpos"] - 40) & (
        ts[None, :] != c["slots"])
    live = torch.tensor([5, 3])
    states = split_states(q, k, v, vis, split, live, round_p=False)
    m0, l0, a0 = states[0][0]  # slots 0..31 of the row at position 150
    assert (m0 == NEG).all() and (l0 == 0).all() and (a0 == 0).all()
    full = merge(q, c["kn"][:, 0], c["vn"][:, 0], states, round_out=False)
    cut = merge(q, c["kn"][:, 0], c["vn"][:, 0],
                [states[0][1:], states[1]], round_out=False)
    assert torch.isfinite(full).all()
    assert torch.equal(full, cut)


def test_an_empty_row_gives_exactly_v_new():
    """A row with no occupied block has no live split: the merge folds
    only the fresh key, exactly v_new, as the plain version does."""
    rng = np.random.default_rng(12)
    c = paged_case(rng, 4, 2, [0, 40, 0], D=32, bs=16, MB=10, bf16=True)
    assert c["nblk"].tolist() == [0, 3, 0]
    got = paged_emulated(c, 32, round_p=True)
    plain = paged_plain(c, c["vp"], c["vn"])
    for b in (0, 2):
        want = c["vn"][b, 0].repeat_interleave(2, 0)
        assert torch.equal(got[b, 0], want)
        assert torch.equal(plain[b, 0], want)
