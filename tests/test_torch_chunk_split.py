"""K4 at CB > 1 on the chunk tile (csrc/chunk_tile.cuh): its split along
the KV axis and its plan, on the CPU.

The kernel cuts a row's read into the plan's splits (ops/split_plan.py
``chunk_plan``); each live split runs an online softmax over its 64-slot
tiles (P rounded to bf16 before P.V; over an int8 pool each score times
its K scale and P x v_scale carried as hi + lo bf16 terms; a tile of at
most 16 live flat rows as four states over quarters of every tile, folded
in order), the row's
last live split also folds the chunk's fresh keys as trailing tiles, and
the splits' fp32 states (acc, m, l) are folded in split order
(chunk_merge), or a row's only live split writes the output itself.
Padding query rows (i >= q_len) are written as zeros. ``chunk_emulated``
does that order of work in torch; the tests hold it, unrounded, to the
plain version, and rounded to the plain version within the card's
REL_TOL (int8: 2^-12 of the row's weighted |v| before the output's
rounding) and to the JAX oracle ``llmss_tpu.ops.attention.
ragged_paged_attention``, on inputs made from a numpy seed: a ring wrap
whose pending slots cross a split boundary, a window across a split,
sentinel columns, an empty row, q_len 0, 1 and odd, block sizes 8, 16 and
24, head dims 64, 128 and 256, int8 scales.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from llmss_tpu.ops.attention import ragged_paged_attention as jax_ragged
from llmss_tpu_torch.engine.cache import gather_block_view, quantize_kv
from llmss_tpu_torch.ops import _build
from llmss_tpu_torch.ops import attention as tatt
from llmss_tpu_torch.ops import paged_attention as pa
from llmss_tpu_torch.ops import split_plan as sp

NEG = float(torch.finfo(torch.float32).min)
# The int8 form before its output rounding against fp32 with P x v_scale
# unrounded (test_torch_kernel_plan.py INT8_EMU_TOL).
INT8_EMU_TOL = 2.0 ** -12


def _bf16(rng, *shape):
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return x.to(torch.bfloat16).float()


def _case(seed, *, B, Hq, Hkv, D, bs, MB, ctx, qlens, CB, window=None,
          n_cols=None, int8=False, splits=None):
    """Rows whose histories are positions 0..ctx[b]-1 written at logical
    slot p % ring (a row past the ring keeps the latest), each with a
    CB-token chunk of which qlens[b] are live from position ctx[b]; each
    row's blocks scattered over the pool, sentinel columns (>= N) past
    them; a pending slot that still holds a visible position gets a key
    4x its query's and values 8 (kept, it would miss by ~8).
    ``splits``: the chunk tile aims at that many splits."""
    rng = np.random.default_rng(seed)
    ring = MB * bs
    own = [MB if c + q > ring else max(1, -(-(c + q) // bs))
           for c, q in zip(ctx, qlens)]
    N = sum(own) + 2
    perm = rng.permutation(N)
    bt = np.full((B, MB), N, np.int32)
    k0 = 0
    for b, n in enumerate(own):
        bt[b, :n] = perm[k0:k0 + n]
        bt[b, n:] = N + b
        k0 += n
    kvp = np.full((B, ring), -1, np.int32)
    for b, n in enumerate(ctx):
        for p in range(n):
            kvp[b, p % ring] = p
    kp, vp = _bf16(rng, 1, N + 1, bs, Hkv, D), _bf16(rng, 1, N + 1, bs, Hkv, D)
    q = _bf16(rng, B, CB, Hq, D)
    G = Hq // Hkv
    for b in range(B):
        for i in range(qlens[b]):
            t = (ctx[b] + i) % ring
            if kvp[b, t] >= 0:
                kp[0, bt[b, t // bs], t % bs] = 4 * q[b, i, ::G]
                vp[0, bt[b, t // bs], t % bs] = 8.0
    nblk = np.minimum(MB, -(-(kvp >= 0).sum(1) // bs)).astype(np.int32)
    T = torch.from_numpy
    c = dict(q=q, kn=_bf16(rng, B, CB, Hkv, D), vn=_bf16(rng, B, CB, Hkv, D),
             kp=kp, vp=vp, ks=None, vs=None,
             qpos=T(np.asarray(ctx, np.int32)),
             qlen=T(np.asarray(qlens, np.int32)), kvp=T(kvp), bt=T(bt),
             nblk=T(nblk), slot0=T(np.asarray(ctx, np.int32) % ring),
             ring=ring, window=window, n_cols=n_cols or MB, bs=bs)
    if int8:
        (c["kp"], c["ks"]), (c["vp"], c["vs"]) = quantize_kv(kp), quantize_kv(vp)
    c["plan"] = pa.kernel_plan(torch.bfloat16, CB, G, D, B=B, Hkv=Hkv,
                               n_slots=c["n_cols"] * bs, bs=bs,
                               kv_dtype=torch.int8 if int8 else torch.bfloat16,
                               chunk_splits=splits)
    return c


CASES = {
    # Row 0 wrapped its 256-slot ring: its 24 pending slots from slot 44
    # cross the 64-slot split boundary; a decode row; q_len odd (17) on an
    # empty row.
    "ring_wrap_pending_across_split": dict(
        seed=1, B=3, Hq=4, Hkv=2, D=64, bs=8, MB=32, ctx=[300, 100, 0],
        qlens=[24, 1, 17], CB=32, splits=4),
    # A 70-slot window whose visible slots cross split boundaries, GQA 4.
    "window_across_split": dict(
        seed=2, B=2, Hq=4, Hkv=1, D=128, bs=16, MB=16, ctx=[200, 90],
        qlens=[1, 20], CB=32, window=70, splits=4),
    # A bucketed read of 12 of 16 columns (sentinels past each row's
    # blocks), an empty row, a row with q_len 0 (all padding).
    "sentinels_empty_row_qlen0": dict(
        seed=3, B=4, Hq=2, Hkv=2, D=128, bs=16, MB=16, ctx=[150, 0, 60, 40],
        qlens=[5, 9, 0, 1], CB=16, n_cols=12, splits=3),
    # Block size 24: the plan's split is 192 slots (8 columns, not a
    # multiple of 64 of them), crossed by row 1; q_len 37, 1 and 13.
    "qlen_odd_bs24": dict(
        seed=4, B=3, Hq=4, Hkv=2, D=128, bs=24, MB=12, ctx=[100, 250, 7],
        qlens=[37, 1, 13], CB=48),
    "d256": dict(seed=5, B=2, Hq=2, Hkv=1, D=256, bs=16, MB=16,
                 ctx=[180, 33], qlens=[16, 1], CB=16, splits=4),
    "int8_ring_wrap_pending_across_split": dict(
        seed=6, B=3, Hq=4, Hkv=2, D=64, bs=8, MB=32, ctx=[300, 100, 0],
        qlens=[24, 1, 17], CB=32, splits=4, int8=True),
    "int8_window_across_split": dict(
        seed=7, B=2, Hq=4, Hkv=1, D=128, bs=16, MB=16, ctx=[200, 90],
        qlens=[1, 20], CB=32, window=70, splits=4, int8=True),
    "int8_qlen_odd_bs24": dict(
        seed=8, B=3, Hq=4, Hkv=2, D=128, bs=24, MB=12, ctx=[100, 250, 7],
        qlens=[37, 1, 13], CB=48, int8=True),
}


def _masks(c):
    """Cache visibility [B, CB, T] of every live query row and the fresh
    keys' [B, CB, CB] (rows past q_len see nothing: they are padding)."""
    B, CB = c["q"].shape[:2]
    T = c["n_cols"] * c["bs"]
    kvp = c["kvp"][:, :T]
    rel = torch.arange(CB, dtype=torch.int32)
    live = rel[None, :] < c["qlen"][:, None]
    qpos = c["qpos"][:, None] + rel[None, :]
    vis = tatt.ragged_cache_visibility(c["qlen"], kvp, c["slot0"], c["ring"])
    cache = vis[:, None, :] & (kvp[:, None, :] <= qpos[:, :, None])
    fresh = (rel[None, :, None] >= rel[None, None, :]) & (
        rel[None, None, :] < c["qlen"][:, None, None])
    if c["window"] is not None:
        cache &= kvp[:, None, :] > qpos[:, :, None] - c["window"]
        fresh &= (rel[None, :, None] - rel[None, None, :]) < c["window"]
    return cache & live[:, :, None], fresh & live[:, :, None]


def _fold(states):
    """(m, l, acc) states folded in order under their common max (a state
    that saw nothing adds 0)."""
    M = torch.stack([st[0] for st in states]).amax(0)
    den = torch.zeros_like(M)
    o = torch.zeros_like(states[0][2])
    for m, l, acc in states:
        sc = torch.where(m == NEG, 0.0, torch.exp(m - M))
        den = den + l * sc
        o = o + acc * sc[..., None]
    return M, den, o


def _online(tiles, qf, pv, quarters=False):
    """One split's fp32 state over its tiles (k, v, ks, vs, mask [CB, 64]):
    (m, l, acc) per (KV head, group head, query), P entering P.V as `pv`
    ("none" unrounded, "bf16" rounded, "split" int8's hi + lo of P x
    v_scale). ``quarters``: as a narrow tile's four warps, each over its
    16 slots of every tile, folded in warp order."""
    if quarters:
        return _fold([_online([tuple(x[16 * w:16 * w + 16] for x in t[:4])
                               + (t[4][:, 16 * w:16 * w + 16],) for t in tiles],
                              qf, pv) for w in range(4)])
    Hkv, G, CB, _ = qf.shape
    m = torch.full((Hkv, G, CB), NEG)
    l = torch.zeros(Hkv, G, CB)
    acc = torch.zeros(Hkv, G, CB, qf.shape[-1])
    for k, v, ks, vs, mask in tiles:
        if k.shape[0] == 0:
            continue
        s = torch.einsum("kgsd,tkd->kgst", qf, k) * ks.T[:, None, None, :]
        s = s.masked_fill(~mask, NEG)
        mx = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - mx)
        p = torch.exp(s - mx[..., None]).masked_fill(~mask, 0.0)
        l = l * alpha + p.sum(-1)
        pv_ = p * vs.T[:, None, None, :]
        if pv == "bf16":
            pv_ = pv_.to(torch.bfloat16).float()
        elif pv == "split":
            hi = pv_.to(torch.bfloat16).float()
            pv_ = hi + (pv_ - hi).to(torch.bfloat16).float()
        acc = acc * alpha[..., None] + torch.einsum("kgst,tkd->kgsd", pv_, v)
        m = mx
    return m, l, acc


def chunk_emulated(c, pv="none"):
    """The chunk tile's order of work in torch (fp32 output, before its
    rounding to bf16): per row, splits [s * split, (s + 1) * split) of its
    occupied slots min(n_blocks, n_cols) * bs in 64-slot tiles, the fresh
    keys as trailing tiles of the last live split (split 0 of a row with
    no occupied slot), the splits' states folded in split order, padding
    rows zeros."""
    B, CB, Hq, D = c["q"].shape
    Hkv, bs = c["kn"].shape[2], c["bs"]
    G = Hq // Hkv
    S, split = c["plan"].splits, c["plan"].split_slots
    cache_mask, fresh_mask = _masks(c)
    kview = gather_block_view(c["kp"][0], c["bt"], c["n_cols"]).float()
    vview = gather_block_view(c["vp"][0], c["bt"], c["n_cols"]).float()
    ones = torch.ones(c["kp"].shape[1:4])
    ksv = gather_block_view((c["ks"] if c["ks"] is not None else ones[None])[0],
                            c["bt"], c["n_cols"])
    vsv = gather_block_view((c["vs"] if c["vs"] is not None else ones[None])[0],
                            c["bt"], c["n_cols"])
    out = torch.zeros(B, CB, Hq, D)
    # A narrow tile: at most 16 live flat rows f = i * G + g in its 64 (D
    # <= 128 only).
    f = (torch.arange(CB)[None, :] * G + torch.arange(G)[:, None])  # [G, CB]
    narrow = (c["qlen"][:, None, None] * G - f // 64 * 64 <= 16) & (D <= 128)
    narrow = narrow[:, None].expand(B, Hkv, G, CB)
    for b in range(B):
        qf = c["q"][b].reshape(CB, Hkv, G, D).permute(1, 2, 0, 3) / math.sqrt(D)
        t_end = min(max(int(c["nblk"][b]), 0), c["n_cols"]) * bs
        live = -(-t_end // split) if t_end else 1
        assert live <= S
        states = []
        for s in range(live):
            lo, hi = s * split, min((s + 1) * split, t_end)
            tiles = []
            for t0 in range(lo, hi, 64):
                t1 = min(t0 + 64, hi)
                tiles.append((kview[b, t0:t1], vview[b, t0:t1], ksv[b, t0:t1],
                              vsv[b, t0:t1], cache_mask[b, :, t0:t1]))
            if s == live - 1:  # the fresh keys ride the last live split
                for j0 in range(0, CB, 64):
                    j1 = min(j0 + 64, CB)
                    one = torch.ones(j1 - j0, Hkv)
                    tiles.append((c["kn"][b, j0:j1], c["vn"][b, j0:j1], one,
                                  one, fresh_mask[b, :, j0:j1]))
            wide, quarter = _online(tiles, qf, pv), _online(tiles, qf, pv, True)
            states.append(tuple(torch.where(narrow[b].reshape(x.shape[:3] + (1,) * (x.dim() - 3)),
                                            y, x) for x, y in zip(wide, quarter)))
        # One live split: its block's output; else chunk_merge's fold of
        # the splits in split order.
        _, den, o = _fold(states)
        o = o / torch.where(den == 0, 1.0, den)[..., None]
        rows = torch.arange(CB) < int(c["qlen"][b])
        out[b] = o.permute(2, 0, 1, 3).reshape(CB, Hq, D) * rows[:, None, None]
    return out


def _plain(c, vp, vn):
    return pa.ragged_paged_attention_ref(
        c["q"], c["kp"], vp, c["kn"], vn, c["qpos"], c["qlen"], c["kvp"],
        c["bt"], c["nblk"], c["slot0"], 0, n_cols=c["n_cols"],
        window=c["window"], k_scale=c["ks"], v_scale=c["vs"])


def _live(c):
    return torch.arange(c["q"].shape[1])[None, :] < c["qlen"][:, None]


def _rounded(c):
    """The emulation as the card computes it: P rounded (int8: the two-term
    split), the output rounded to bf16."""
    pv = "split" if c["ks"] is not None else "bf16"
    return chunk_emulated(c, pv).to(torch.bfloat16).float()


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    c = _case(**CASES[request.param])
    c["name"] = request.param
    return c


def test_cases_split_the_read(case):
    """Every case runs the split: more than one split, and a row with two
    or more live splits beside rows with one."""
    plan, bs = case["plan"], case["bs"]
    assert plan.splits > 1 and plan.impl in sp.TILE_IMPLS
    t_end = np.minimum(case["nblk"].numpy(), case["n_cols"]) * bs
    live = [max(1, -(-int(t) // plan.split_slots)) for t in t_end]
    assert max(live) >= 2


def test_unrounded_split_is_the_plain_version(case):
    """Cut into splits and folded in split order, unrounded, the chunk
    tile's order of work computes the plain version's function on every
    live query row (1e-5), and zeros on padding rows."""
    got = chunk_emulated(case, "none")
    want = _plain(case, case["vp"], case["vn"])
    live = _live(case)
    torch.testing.assert_close(got[live], want[live], rtol=1e-5, atol=1e-5)
    assert not got[~live].any()


def test_rounded_split_within_tolerance_of_plain(case):
    """With the card's roundings the split stays within REL_TOL[bf16] x
    the row's weighted |v| of the fp32 plain version; over an int8 pool
    the two-term P' within INT8_EMU_TOL before the output rounding."""
    live = _live(case)
    ref = _plain(case, case["vp"], case["vn"])
    ref_abs = _plain(case, case["vp"].abs(), case["vn"].abs())
    got = _rounded(case)
    assert torch.isfinite(got).all()
    tol = chip_smoke.REL_TOL[torch.bfloat16] * ref_abs + 1e-6
    assert ((got - ref).abs() / tol)[live].max().item() <= 1.0
    if case["ks"] is not None:
        pre = chunk_emulated(case, "split")
        tol8 = INT8_EMU_TOL * ref_abs + 1e-6
        assert ((pre - ref).abs() / tol8)[live].max().item() <= 1.0


def test_split_matches_the_jax_oracle(case):
    """The rounded emulation against the reference's oracle
    ``ragged_paged_attention`` (fp32, over the pool without the port's
    drop block, the same bucketed read): within REL_TOL[bf16] x the
    row's weighted |v| on every live query row."""
    c = case
    N = c["kp"].shape[1] - 1
    kw = {}
    if c["ks"] is not None:
        kw = dict(k_scale_layer=jnp.asarray(c["ks"][0, :N].numpy()),
                  v_scale_layer=jnp.asarray(c["vs"][0, :N].numpy()))
    want = np.asarray(jax_ragged(
        jnp.asarray(c["q"].numpy()), jnp.asarray(c["kp"][0, :N].numpy()),
        jnp.asarray(c["vp"][0, :N].numpy()), jnp.asarray(c["kn"].numpy()),
        jnp.asarray(c["vn"].numpy()), jnp.asarray(c["qpos"].numpy()),
        jnp.asarray(c["qlen"].numpy()),
        jnp.asarray(c["kvp"][:, :c["n_cols"] * c["bs"]].numpy()),
        jnp.asarray(c["bt"].numpy()), jnp.asarray(c["slot0"].numpy()),
        c["ring"], window=c["window"], n_blocks=c["n_cols"], **kw))
    live = _live(c)
    ref_abs = _plain(c, c["vp"].abs(), c["vn"].abs())
    tol = chip_smoke.REL_TOL[torch.bfloat16] * ref_abs + 1e-6
    err = (_rounded(c) - torch.from_numpy(want.copy())).abs() / tol
    assert err[live].max().item() <= 1.0


# -- the plan -------------------------------------------------------------------


@pytest.mark.parametrize("n_slots, bs", [(1024, 16), (832, 16), (2064, 24),
                                         (1032, 24), (1024, 8), (4096, 16),
                                         (128, 16), (64, 8), (8192, 32)])
def test_chunk_splits_cover_the_read(n_slots, bs):
    """The plan's splits are whole 64-slot tiles and table columns, at
    most CHUNK_MAX_SPLITS of about CHUNK_SPLIT_SLOTS slots, cover the
    bucketed read n_cols * bs, and none lies wholly past it."""
    S, split = sp.chunk_plan(n_slots, bs)  # one row, one KV head
    assert split % sp.TILE_STEP == 0 and split % bs == 0
    assert S * split >= n_slots > (S - 1) * split
    assert 1 <= S <= sp.CHUNK_MAX_SPLITS
    if n_slots > sp.CHUNK_SPLIT_SLOTS:
        assert S > 1
    assert sp.chunk_plan(n_slots, bs, B=8, Hkv=32)[0] == 1  # 256 pairs
    assert sp.chunk_plan(n_slots, bs, max_splits=1) == (
        1, -(-n_slots // math.lcm(64, bs)) * math.lcm(64, bs))


@pytest.mark.parametrize("kv", [torch.bfloat16, torch.int8])
def test_chunk_plan_takes_host_values_only(kv):
    """At CB > 1 the split depends on host values alone: the bucketed
    read, the block size, the rows and KV heads against the SM count
    (ceil(sms / (B * Hkv)) splits, capped); G, D and CB do not move it,
    and the wrapper's plan reads no device value (n_blocks, q_len), so a
    bucket always launches one grid. The serve shape (8 rows, 32 KV heads)
    stays whole; StarCoder's one KV head splits 4 ways."""
    for B, Hkv, G, D, CB, sms, S in ((8, 32, 1, 128, 128, 132, 1),
                                     (1, 8, 4, 64, 2, 66, 4),
                                     (8, 1, 48, 128, 128, 132, 4),
                                     (3, 32, 1, 256, 16, 132, 2),
                                     (16, 4, 7, 128, 64, 114, 2)):
        plan = pa.kernel_plan(torch.bfloat16, CB, G, D, B=B, Hkv=Hkv,
                              n_slots=832, bs=16, sms=sms, kv_dtype=kv)
        assert plan.impl == ("mma_int8" if kv == torch.int8 else "mma")
        int8 = kv == torch.int8
        if int8 and D > 128:  # the 64-row tile over int8 tiles, unsplit
            assert plan == ("mma_int8", _build.tile_i8_smem_bytes(D), 1, 0)
            continue
        assert plan.splits == S
        assert (plan.splits, plan.split_slots) == sp.chunk_plan(
            832, 16, B=B, Hkv=Hkv, sms=sms)
        for G2, D2, CB2 in ((G, D, CB), (2, 64, 64), (16, 256 if not int8 else 128, 8)):
            assert pa.kernel_plan(torch.bfloat16, CB2, G2, D2, B=B, Hkv=Hkv,
                                  n_slots=832, bs=16, sms=sms,
                                  kv_dtype=kv)[2:] == plan[2:]
        assert plan.smem == _build.chunk_smem_bytes(D, kv == torch.int8)
        assert sp.merges(plan, CB) == (S > 1)
    forced = pa.kernel_plan(torch.bfloat16, 128, 1, 128, n_slots=1024, bs=16,
                            chunk_splits=8)
    assert (forced.splits, forced.split_slots) == (8, 128)


def test_chunk_workspace_layout():
    """The workspace holds acc [B, CB, Hq, S, D], then m and l [B, CB, Hq,
    S] (chunk_tile.cuh: state row ((b * CB + i) * Hq + h) * S + s, m at
    n_part * D, l after it); at the serve shape (8 rows at CB 128, 32
    heads of 128, 4 splits) 68 MB, 3% of the serve phase's pool."""
    src = (_build.CSRC / "chunk_tile.cuh").read_text()
    for line in ("const long long st = row * s.S + s.split;",
                 "s.ws[s.n_part * D + st] = M;",
                 "s.ws[s.n_part * D + s.n_part + st] = L;",
                 "const long long n_part = (long long)a.B * a.CB * a.Hq * a.S;"):
        assert line in src, line
    assert "s.n_part = (long long)a.B * a.CB * a.Hq * a.S;" in (
        _build.CSRC / "paged_attention.cu").read_text()
    assert sp.workspace_numel(2, 4, 3, 64, CB=5) == 2 * 5 * 4 * 3 * 66
    assert sp.workspace_numel(2, 4, 3, 64) == 2 * 4 * 3 * 66  # decode
    ws = 4 * sp.workspace_numel(8, 32, sp.CHUNK_MAX_SPLITS, 128, CB=128)
    assert ws == 68157440 and ws <= 0.05 * chip_smoke.POOL_BYTES


def test_chunk_smem_matches_the_header():
    """chunk_smem_bytes mirrors chunk_tile.cuh's Smem<KV, D>: 106,768 bytes
    at D 128 over either pool (two blocks an SM), and every instantiation
    under the H100's limit."""
    src = (_build.CSRC / "chunk_tile.cuh").read_text()
    for line in ("static constexpr int ST = kI8 ? (D <= 64 ? 3 : 2) : (D > 128 ? 2 : 3);",
                 "static constexpr int NB = kI8 ? 2 : 0;",
                 "static constexpr size_t bytes = ring + bufs + q + scales + "
                 "4 * (kPosWin + kMaxCols + 2);",
                 "constexpr int kPosWin = 512;",
                 "constexpr int kMaxCols = kPosWin / 8 + 2;"):
        assert line in src, line
    for int8 in (False, True):
        assert _build.chunk_smem_bytes(128, int8) == 106768
        assert 2 * (106768 + _build.BLOCK_RESERVED_BYTES) <= _build.SM_SHARED_BYTES
        for D in pa.HEAD_DIMS:
            if not (int8 and D > 128):
                assert _build.chunk_smem_bytes(D, int8) <= _build.SMEM_LIMIT
    assert _build.chunk_smem_bytes(256) == 171280
    assert _build.chunk_smem_bytes(64, True) == 66320
    with pytest.raises(_build.KernelError):  # int8 at D 256: the 64-row tile
        _build.chunk_smem_bytes(256, True)
