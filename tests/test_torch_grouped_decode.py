"""K2 and K3 at every query-head group G on the CPU: the lane template's
partial head groups, the decode kernels' symbols and sources, and torch
emulations of the two tensor-core tiles' decode splits.

From ``split_plan.G_TILE`` query heads per KV head, bf16 decode queries
over a bf16 cache take the group tile (csrc/group_tile.cuh): one block
per (row, KV head, 16 to 64 query heads, split), a split a whole number
of 64-slot tiles, each tile's slots shared by slot-parallel warps that
each run their own online softmax (scores in log2 units, P rounded to
bf16 before P.V), the warps' states folded in warp order, the splits' in
split order by the merge, then the fresh key in fp32, the output rounded
to bf16. Its emulation is held within
``chip_smoke.REL_TOL`` of the JAX package's XLA oracles at G = 2, 3, 7
and 8, dense and paged; unrounded, to 1e-5; the plain versions are held
to the oracles there too.

The 64-row tile (csrc/attn_tile.cuh, csrc/attn_tile_i8.cuh; over an int8
cache above 8 heads per KV head, and forced) is one block per (row, KV
head, 64 query heads, split). Its emulation follows it: per 64-slot tile an online softmax with
P rounded to bf16 before P.V (over an int8 cache: each score times its K
scale, and P x v_scale as two bf16 terms, hi + lo), one fp32 state (m, l,
acc) per query head and live split, the splits merged in split order and
the fresh key last in fp32 (csrc/split_merge.cuh), the output rounded to
bf16. At G = 48 (StarCoder) and G = 7 it is held within
``chip_smoke.REL_TOL`` of the JAX package's XLA oracles
``fresh_kv_decode_attention`` and ``paged_decode_attention``, int8
included; unrounded, to 1e-5. The plain versions are held to the same
oracles to 1e-5. Inputs are made with numpy from a seed.
"""

import importlib
import inspect
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from llmss_tpu_torch.engine import graphs
from llmss_tpu_torch.engine.cache import quantize_kv
from llmss_tpu_torch.ops import _build
from llmss_tpu_torch.ops import decode_attention as da
from llmss_tpu_torch.ops import paged_attention as pa
from llmss_tpu_torch.ops import split_plan as sp

# llmss_tpu.ops rebinds its ``attention`` attribute to the function.
jatt = importlib.import_module("llmss_tpu.ops.attention")
NEG = float(torch.finfo(torch.float32).min)
TOL = dict(rtol=1e-5, atol=1e-5)
BF16 = torch.bfloat16


# -- the lanes' head groups ---------------------------------------------------


@pytest.mark.parametrize("G, GB", [(1, 1), (2, 2), (3, 4), (4, 4), (5, 8),
                                   (6, 8), (7, 8), (8, 8), (12, 8), (16, 8),
                                   (48, 8)])
def test_heads_per_block_is_the_least_power_of_two(G, GB):
    """GB covers min(G, 8) heads; a G that 8 divides keeps the group it had
    (the largest power of two up to 8 dividing G), so those
    instantiations and their outputs do not change."""
    assert da._heads_per_block(G) == GB
    if G % 8 == 0 or G in (1, 2, 4):
        assert GB == max(g for g in (1, 2, 4, 8) if G % g == 0)


def test_qwen2_reads_each_kv_head_once():
    """Qwen2-7B's 28 query heads on 4 KV heads (G = 7) take one group tile
    block of 16 rows per KV head and split (the lanes: one group of 8): the
    plan's grid has B * Hkv blocks per split, where one head per block had
    7 per KV head."""
    plan = da.kernel_plan(BF16, 4, 28, 4, 128, 192)
    assert plan.impl == "group" and sp.group_rows(7) == 16
    assert plan[2:] == sp.split_plan(4, 4, 192, step=sp.TILE_STEP,
                                     sms=sp.H100_SMS, per_sm=sp.GROUP_PER_SM)
    k3 = pa.kernel_plan(BF16, 1, 7, 128, B=8, Hkv=4, n_slots=832, bs=16)
    assert k3.impl == "group"
    lanes = da.kernel_plan(BF16, 4, 28, 4, 128, 192, force="lanes")
    assert da._heads_per_block(7) == 8 and pa._rows_per_block(7) == 8
    assert lanes[2:] == sp.split_plan(4, 4, 192, step=sp.lane_step(128),
                                      sms=sp.H100_SMS)


def test_decode_fwd_covers_partial_groups():
    """decode_fwd's grid and head index cover ceil(G / GB) groups per KV
    head, and rows past the last head neither load nor store. The partial
    form is a compile-time flag (GB 4 and 8 only), so a G that GB divides
    runs the code it ran before partial groups existed."""
    src = (_build.CSRC / "decode_attention.cu").read_text()
    assert ("template <typename T, typename KV, int D, int GB, bool kPart = false, "
            "bool kState = false>") in src
    assert "const int ng = kPart ? (G + GB - 1) / GB : G / GB;" in src
    assert "const int gn = kPart ? min(GB, G - g0) : GB;" in src
    assert "if (g < gn) qv[g].load(" in src
    assert "return g < gn ? h0 + g : -1;" in src
    assert "dim3 grid(a.B, a.Hkv * ((a.Hq / a.Hkv + GB - 1) / GB), a.S);" in src
    assert re.search(r"if \(\(a\.Hq / a\.Hkv\) % GB\) \{.*\n\s+if constexpr \(GB >= 4\) \{"
                     r"\n\s+kern = decode_fwd<T, KV, D, GB, true, kState>;", src)


# -- symbols and sources ------------------------------------------------------

# The decode tiles as libcuda (mangled) and the profiler (demangled) name
# them: (name, wrapper, template symbol, int8 cache).
DECODE_TILE_SYMBOLS = [
    ("_ZN5llmss12_GLOBAL__N_110decode_mmaI13__nv_bfloat16Li128EEEvNS0_4ArgsE",
     da.decode_attention, "decode_mma", False),
    ("_ZN5llmss12_GLOBAL__N_110decode_mmaIaLi128EEEvNS0_6ArgsI8E",
     da.decode_attention, "decode_mma", True),
    ("void llmss::(anonymous namespace)::decode_mma<signed char, 128>"
     "(llmss::(anonymous namespace)::ArgsI8)", da.decode_attention,
     "decode_mma", True),
    ("_ZN5llmss12_GLOBAL__N_19paged_mmaI13__nv_bfloat16Li128ELb1EEEvNS0_4ArgsE",
     pa.paged_decode_attention, "paged_mma", False),
    ("_ZN5llmss12_GLOBAL__N_19paged_mmaIaLi128ELb1EEEvNS0_6ArgsI8E",
     pa.paged_decode_attention, "paged_mma", True),
    ("void llmss::(anonymous namespace)::paged_mma<__nv_bfloat16, 128, true>"
     "(llmss::(anonymous namespace)::Args)", pa.paged_decode_attention,
     "paged_mma", False),
]


@pytest.mark.parametrize("name, fn, sym, int8", DECODE_TILE_SYMBOLS)
def test_decode_tile_symbols_are_counted(name, fn, sym, int8):
    """A step graph's decode tile node counts for its wrapper (so the
    graph's node count matches the launches), and chip_smoke tells the
    int8-cache instantiations apart."""
    assert sym in graphs.KERNEL_SYMBOLS[fn.__name__]
    assert graphs.node_launches([name], [(fn, 1)]) == [(fn, 1)]
    assert chip_smoke._int8_kernel(name, sym) is int8


def test_ptxas_report_lists_the_decode_tiles():
    """chip_smoke / kernel_ab read the decode tiles' registers and spills
    from ``-Xptxas=-v`` output."""
    names = [n for n, *_ in DECODE_TILE_SYMBOLS if n.startswith("_Z")]
    text = "".join(
        f"ptxas info    : Compiling entry function '{n}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {n}\n"
        f"    0 bytes stack frame, {i} bytes spill stores, 0 bytes spill "
        f"loads\nptxas info    : Used {100 + i} registers, 16 bytes smem\n"
        for i, n in enumerate(names))
    assert [r["kernel"] for r in chip_smoke.mma_registers(text)] == [
        "decode_mmaI13__nv_bfloat16Li128", "decode_mmaIaLi128",
        "paged_mmaI13__nv_bfloat16Li128ELb1", "paged_mmaIaLi128ELb1"]


def test_k3_and_k4_share_the_decode_tile():
    """K3 (q_len null) and an all-decode K4 reach the same tile at CB == 1:
    the entry point's decode branches take no q_len condition, the kernel
    reads q_len only when it is given, and the merge is launched whatever
    S; the plan is one function of the shapes."""
    src = (_build.CSRC / "paged_attention.cu").read_text()
    assert "impl == 1 && tile16 && CB == 1)" in src
    assert "impl == 2 && tile8 && CB == 1)" in src
    assert "s.ql = a.qlen ? a.qlen[b] : 1;" in src
    decode = src[src.index("cudaError_t launch_decode_mma("):]
    decode = decode[:decode.index("\n}\n")]
    assert "return launch_merge<__nv_bfloat16>(D, m, stream);" in decode
    assert "a.S == 1" not in decode
    launch = inspect.getsource(pa._launch)
    assert ("plan = kernel_plan(q.dtype, CB, Hq // Hkv, D, B=B, Hkv=Hkv,\n"
            "                       n_slots=n_cols * bs, bs=bs,") in launch
    for fn in (pa.paged_decode_attention, pa.ragged_paged_attention):
        assert "out = _launch(" in inspect.getsource(fn)


def test_k2_tile_dispatch():
    """K2's entry point takes the instantiation code: 1 / 2 the tile over a
    bf16 / int8 cache for bf16 queries, 0 the lanes; its merge follows
    every tile launch."""
    src = (_build.CSRC / "decode_attention.cu").read_text()
    assert re.search(r"impl == 1\) \{\n\s+if \(dtype == kBF16 && kv_dtype == kBF16\)"
                     r" err = dispatch_mma<__nv_bfloat16>", src)
    assert re.search(r"impl == 2\) \{\n\s+if \(dtype == kBF16 && kv_dtype == kI8\)"
                     r" err = dispatch_mma<int8_t>", src)
    assert "__launch_bounds__(tile::kThreads) decode_mma(ArgsOf<KV> a)" in src
    assert "return launch_merge<__nv_bfloat16>(D, m, stream);" in src


# -- the emulation ------------------------------------------------------------


def tile_split_states(q, k, v, vis, split, live, *, ks=None, vs=None,
                      round_p=True, tile=64):
    """The tile's split kernel per row: for each live split, its slots in
    64-slot tiles under an online softmax; [(m, l, acc)] with m, l
    [Hkv, G] and acc [Hkv, G, D]. q [B, Hq, D]; k, v [B, T, Hkv, D] (int8
    values as floats, with ks / vs [B, T, Hkv]); vis [B, T]; live [B]. P is
    rounded to bf16 (int8: P x v_scale as hi + lo) when ``round_p``."""
    B, T, Hkv, D = k.shape
    G = q.shape[1] // Hkv
    qg = q.reshape(B, Hkv, G, D) / D ** 0.5
    out = []
    for b in range(B):
        parts = []
        for s in range(int(live[b])):
            m = torch.full((Hkv, G), NEG)
            l = torch.zeros(Hkv, G)
            acc = torch.zeros(Hkv, G, D)
            end = min((s + 1) * split, T)
            for t0 in range(s * split, end, tile):
                cut = slice(t0, min(t0 + tile, end))
                seen = vis[b, cut]
                x = torch.einsum("kgd,tkd->kgt", qg[b], k[b, cut])
                if ks is not None:
                    x = x * ks[b, cut].T[:, None, :]
                x = x.masked_fill(~seen, NEG)
                mx = torch.maximum(m, x.amax(-1))
                alpha = torch.exp(m - mx)
                p = torch.exp(x - mx[..., None]).masked_fill(~seen, 0.0)
                l = l * alpha + p.sum(-1)
                pv = p if vs is None else p * vs[b, cut].T[:, None, :]
                if round_p:
                    hi = pv.to(BF16).float()
                    pv = hi if vs is None else hi + (pv - hi).to(BF16).float()
                acc = acc * alpha[..., None] + torch.einsum("kgt,tkd->kgd", pv,
                                                            v[b, cut])
                m = mx
            parts.append((m, l, acc))
        out.append(parts)
    return out


def merge_states(q, k_new, v_new, states):
    """split_merge: per row, the live splits folded in split order under
    their common max, then the fresh key, in fp32; [B, 1, Hq, D]."""
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
    return out.reshape(B, 1, Hq, D)


def _bf16(rng, *shape):
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return x.to(BF16).float()


def _quant(x):
    """int8 values (as fp32, exact) and fp32 scales: the engine's
    ``quantize_kv``, the reference's bit for bit."""
    x8, s = quantize_kv(x)
    return x8.float(), s


# (Hq, Hkv, rows' histories): G = 48, StarCoder's one KV head, and G = 7 on
# two KV heads; a long row, an empty row, a row that wrapped the ring of
# 256 slots, and a short one.
SHAPES = {48: (48, 1, [200, 0, 300, 70]), 7: (14, 2, [200, 0, 300, 70]),
          2: (4, 2, [200, 0, 300, 70]), 3: (6, 2, [200, 0, 300, 70]),
          8: (16, 2, [200, 0, 300, 70])}
D, RING, BS, MB = 64, 256, 16, 16


def _case(layout, G, kv, seed, force="mma"):
    """Inputs of one decode call at ``SHAPES[G]``: ``layout`` "dense" (K2's
    ring [B, RING] of layer 0) or "paged" (K3's pool of MB blocks of BS per
    row, scattered, with sentinel columns past a row's blocks); ``kv``
    "bf16" or "int8". Returns a dict with the logical view (k, v, and
    scales) the emulation reads, its visibility and live splits under the
    tile's plan, and everything the oracles and plain versions take."""
    Hq, Hkv, hist = SHAPES[G]
    rng = np.random.default_rng(seed)
    B = len(hist)
    kvp = np.full((B, RING), -1, np.int32)
    for b, n in enumerate(hist):
        for p in range(n):
            kvp[b, p % RING] = p
    qpos = np.asarray(hist, np.int32)[:, None]
    slots = qpos % RING
    c = dict(layout=layout, q=_bf16(rng, B, 1, Hq, D), kn=_bf16(rng, B, 1, Hkv, D),
             vn=_bf16(rng, B, 1, Hkv, D), qpos=torch.from_numpy(qpos),
             kvp=torch.from_numpy(kvp), slots=torch.from_numpy(slots),
             ks=None, vs=None)
    T = torch.arange(RING)
    if layout == "dense":
        c["kc"], c["vc"] = _bf16(rng, 1, B, RING, Hkv, D), _bf16(rng, 1, B, RING, Hkv, D)
        if kv == "int8":
            (c["kc"], c["ks"]), (c["vc"], c["vs"]) = _quant(c["kc"]), _quant(c["vc"])
        k, v = c["kc"][0], c["vc"][0]
        ks, vs = (None, None) if c["ks"] is None else (c["ks"][0], c["vs"][0])
        occupied = torch.full((B,), RING)
        plan = da.kernel_plan(BF16, B, Hq, Hkv, D, RING, force=force,
                              kv_dtype=torch.int8 if kv == "int8" else BF16)
    else:
        need = [min(MB, -(-(n + 1) // BS)) for n in hist]
        N = sum(need) + 2
        perm = rng.permutation(N)
        bt = np.full((B, MB), N, np.int32)
        k0 = 0
        for b, n in enumerate(need):
            bt[b, :n] = perm[k0:k0 + n]
            bt[b, n:] = N + b
            k0 += n
        c.update(N=N, bt=torch.from_numpy(bt),
                 nblk=torch.from_numpy(np.minimum(
                     MB, -(-(kvp >= 0).sum(1) // BS)).astype(np.int32)),
                 kp=_bf16(rng, 1, N + 1, BS, Hkv, D),
                 vp=_bf16(rng, 1, N + 1, BS, Hkv, D))
        if kv == "int8":
            (c["kp"], c["ks"]), (c["vp"], c["vs"]) = _quant(c["kp"]), _quant(c["vp"])
        blk = torch.clamp(c["bt"], max=N - 1).long()[:, T // BS]
        k, v = c["kp"][0][blk, T % BS], c["vp"][0][blk, T % BS]
        ks, vs = ((None, None) if c["ks"] is None
                  else (c["ks"][0][blk, T % BS], c["vs"][0][blk, T % BS]))
        occupied = c["nblk"] * BS
        plan = pa.kernel_plan(BF16, 1, G, D, B=B, Hkv=Hkv, n_slots=RING, bs=BS,
                              force=force,
                              kv_dtype=torch.int8 if kv == "int8" else BF16)
    assert plan.impl == (force + "_int8" if kv == "int8" else force)
    assert plan.splits > 1 and plan.split_slots % sp.TILE_STEP == 0
    p = c["kvp"]
    vis = ((p >= 0) & (p <= c["qpos"]) & (T[None, :] != c["slots"])
           & (T[None, :] < occupied[:, None]))
    # Dense: every split is live (the merge reads S); paged: splits before
    # the row's occupied slots.
    live = (torch.full((B,), plan.splits) if layout == "dense"
            else -(-occupied // plan.split_slots))
    c.update(k=k, v=v, ks_view=ks, vs_view=vs, vis=vis, live=live,
             split=plan.split_slots, G=G)
    return c


def emulated(c, round_p=True):
    q = c["q"][:, 0]
    states = tile_split_states(q, c["k"], c["v"], c["vis"], c["split"],
                               c["live"], ks=c["ks_view"], vs=c["vs_view"],
                               round_p=round_p)
    out = merge_states(q, c["kn"][:, 0], c["vn"][:, 0], states)
    return out.to(BF16).float() if round_p else out


def oracle(c, v_abs=False):
    """The JAX package's XLA oracle on the case (on |v| and |v_new| when
    ``v_abs``): the bound's weights."""
    f = (lambda x: x.abs()) if v_abs else (lambda x: x)
    j = lambda x: jnp.asarray(x.numpy())  # noqa: E731
    if c["layout"] == "dense":
        sc = {} if c["ks"] is None else dict(k_scale=j(c["ks"][0]),
                                              v_scale=j(c["vs"][0]))
        want = jatt.fresh_kv_decode_attention(
            j(c["q"]), j(c["kc"][0]), j(f(c["vc"][0])), j(c["kn"]),
            j(f(c["vn"])), j(c["qpos"]), j(c["kvp"]), j(c["slots"]), **sc)
    else:
        N = c["N"]
        sc = {} if c["ks"] is None else dict(k_scale_layer=j(c["ks"][0, :N]),
                                              v_scale_layer=j(c["vs"][0, :N]))
        want = jatt.paged_decode_attention(
            j(c["q"]), j(c["kp"][0, :N]), j(f(c["vp"][0, :N])), j(c["kn"]),
            j(f(c["vn"])), j(c["qpos"]), j(c["kvp"]), j(c["bt"]),
            j(c["slots"]), **sc)
    return torch.from_numpy(np.asarray(want))


def plain(c):
    sc = dict(k_scale=c["ks"], v_scale=c["vs"])
    if c["layout"] == "dense":
        return da.decode_attention_ref(c["q"], c["kc"], c["vc"], c["kn"],
                                       c["vn"], c["qpos"], c["kvp"],
                                       c["slots"], 0, **sc)
    return pa.paged_decode_attention_ref(c["q"], c["kp"], c["vp"], c["kn"],
                                         c["vn"], c["qpos"], c["kvp"], c["bt"],
                                         c["nblk"], c["slots"], 0, **sc)


GRID = [(layout, G, kv) for layout in ("dense", "paged") for G in (48, 7)
        for kv in ("bf16", "int8")]


def _seed(layout, G, kv):
    return GRID.index((layout, G, kv))


@pytest.mark.parametrize("layout, G, kv", GRID)
def test_tile_emulation_unrounded_is_the_oracle(layout, G, kv):
    """Without rounding, the split tiles and their merge compute the XLA
    oracle's function (fp32 both: only the order of sums differs)."""
    c = _case(layout, G, kv, _seed(layout, G, kv))
    torch.testing.assert_close(emulated(c, round_p=False), oracle(c), **TOL)


@pytest.mark.parametrize("layout, G, kv", GRID)
def test_tile_emulation_stays_within_rel_tol(layout, G, kv):
    """P rounded to bf16 in each 64-slot tile (int8: P x v_scale as two
    bf16 terms), fp32 states per split merged in split order with the
    fresh key in fp32, the output rounded to bf16: within REL_TOL[bf16] x
    the weighted |v| of the oracle, the card's tolerance. An empty row is
    exactly v_new."""
    c = _case(layout, G, kv, _seed(layout, G, kv))
    got, ref, ref_abs = emulated(c), oracle(c), oracle(c, v_abs=True)
    assert torch.isfinite(got).all()
    tol = chip_smoke.REL_TOL[BF16] * ref_abs + 1e-6
    assert ((got - ref).abs() / tol).max().item() <= 1.0
    G_ = c["G"]
    for b in range(got.shape[0]):
        if int(c["qpos"][b, 0]) == 0:
            assert torch.equal(got[b, 0], c["vn"][b, 0].repeat_interleave(G_, 0))


@pytest.mark.parametrize("layout, G, kv", GRID)
def test_plain_versions_are_the_oracle(layout, G, kv):
    """decode_attention_ref and paged_decode_attention_ref, the CPU path
    and the card's check, compute the XLA oracles at G = 48 and G = 7."""
    c = _case(layout, G, kv, _seed(layout, G, kv))
    torch.testing.assert_close(plain(c), oracle(c), **TOL)


def test_split_is_whole_tiles_at_the_serve_shapes():
    """At StarCoder's decode shapes the tile's split covers the read in
    whole 64-slot tiles and the grid fills the card better than unsplit:
    K3 at the serve bucket (8 rows, 832 slots) and K2 at the engine's
    192-slot bucket (4 rows: 4 blocks unsplit)."""
    k3 = pa.kernel_plan(BF16, 1, 48, 128, B=8, Hkv=1, n_slots=832, bs=16)
    k2 = da.kernel_plan(BF16, 4, 48, 1, 128, 192)
    for plan, n, blocks in ((k3, 832, 8), (k2, 192, 4)):
        assert plan.impl == "mma" and plan.split_slots % 64 == 0
        assert plan.splits * plan.split_slots >= n
        assert (plan.splits - 1) * plan.split_slots < n
        assert blocks * plan.splits > blocks and sp.merges(plan)
    assert math.ceil(48 / sp.TILE_ROWS) == 1


# -- the group tile's emulation -----------------------------------------------


def group_tile_states(q, k, v, vis, splits, split, slot_warps, round_p=True):
    """The group tile's blocks per row: for each split of ``split`` slots,
    each 64-slot tile holding a visible slot, each of ``slot_warps`` warps
    runs its own online softmax over its 64 / ``slot_warps`` slots of the
    tile (scores in log2 units, exp2, P rounded to bf16 before P.V, the row
    sum of the unrounded P), and the warps' states are folded in warp
    order; [(M, L, ACC)] per split, M / L [Hkv, G] (M in log2 units), ACC
    [Hkv, G, D]. q [B, Hq, D]; k, v [B, T, Hkv, D]; vis [B, T]. P.V in
    fp32 without ``round_p``."""
    B, T, Hkv, D = k.shape
    G, nj = q.shape[1] // Hkv, 64 // slot_warps
    qg = q.reshape(B, Hkv, G, D) * (D ** -0.5 * 1.4426950408889634)
    out = []
    for b in range(B):
        parts = []
        for s in range(splits):
            lo, hi = s * split, min(T, (s + 1) * split)
            warps = [[torch.full((Hkv, G), NEG), torch.zeros(Hkv, G),
                      torch.zeros(Hkv, G, D)] for _ in range(slot_warps)]
            for t0 in range(lo, hi, 64):
                if not vis[b, t0:min(hi, t0 + 64)].any():
                    continue  # a tile no row sees is never copied
                for w, st in enumerate(warps):
                    cut = slice(t0 + w * nj, min(hi, t0 + (w + 1) * nj))
                    seen = vis[b, cut]
                    if not seen.any():
                        continue
                    x = torch.einsum("kgd,tkd->kgt", qg[b], k[b, cut])
                    x = x.masked_fill(~seen, NEG)
                    mx = torch.maximum(st[0], x.amax(-1))
                    alpha = torch.exp2(st[0] - mx)
                    p = torch.exp2(x - mx[..., None]).masked_fill(~seen, 0.0)
                    st[1] = st[1] * alpha + p.sum(-1)
                    pr = p.to(BF16).float() if round_p else p
                    st[2] = st[2] * alpha[..., None] + torch.einsum(
                        "kgt,tkd->kgd", pr, v[b, cut])
                    st[0] = mx
            M = torch.stack([st[0] for st in warps]).amax(0)
            f = [torch.exp2(st[0] - M) for st in warps]
            parts.append((M, sum(st[1] * x for st, x in zip(warps, f)),
                          sum(st[2] * x[..., None] for st, x in zip(warps, f))))
        out.append(parts)
    return out


def group_fold(q, k_new, v_new, states):
    """The fold of the splits per row (split_merge's): the splits in split order under their common max with
    the fresh key's score (log2 units), then the fresh key in fp32; [B, 1,
    Hq, D]."""
    B, Hq, D = q.shape
    Hkv = k_new.shape[1]
    G = Hq // Hkv
    sn = torch.einsum("bkgd,bkd->bkg", q.reshape(B, Hkv, G, D), k_new) * (
        D ** -0.5 * 1.4426950408889634)
    out = torch.empty(B, Hkv, G, D)
    for b, parts in enumerate(states):
        M = sn[b]
        for m, _, _ in parts:
            M = torch.maximum(M, m)
        den, acc = torch.zeros(Hkv, G), torch.zeros(Hkv, G, D)
        for m, l, a in parts:
            sc = torch.where(m == NEG, 0.0, torch.exp2(m - M))
            den, acc = den + l * sc, acc + a * sc[..., None]
        pn = torch.exp2(sn[b] - M)
        out[b] = (acc + pn[..., None] * v_new[b][:, None, :]) / (den + pn)[..., None]
    return out.reshape(B, 1, Hq, D)


GROUP_GRID = [(layout, G) for layout in ("dense", "paged") for G in (2, 3, 7, 8)]


def _group_case(layout, G):
    """One decode call at ``SHAPES[G]`` on the group tile's plan (paged:
    splits past a row's occupied slots see nothing and add nothing)."""
    c = _case(layout, G, "bf16", 100 + GROUP_GRID.index((layout, G)),
              force="group")
    c["splits"] = -(-RING // c["split"])
    return c


def group_emulated(c, round_p=True):
    q = c["q"][:, 0]
    states = group_tile_states(q, c["k"], c["v"], c["vis"], c["splits"],
                               c["split"], sp.group_warps(c["G"])[1], round_p)
    out = group_fold(q, c["kn"][:, 0], c["vn"][:, 0], states)
    return out.to(BF16).float() if round_p else out


@pytest.mark.parametrize("layout, G", GROUP_GRID)
def test_group_tile_emulation_unrounded_is_the_oracle(layout, G):
    """Without rounding, the group tile's slot-warp streams, split states
    and split_merge's fold of the splits and the fresh key in fp32 compute
    the XLA oracle's function."""
    c = _group_case(layout, G)
    torch.testing.assert_close(group_emulated(c, round_p=False), oracle(c),
                               **TOL)


@pytest.mark.parametrize("layout, G", GROUP_GRID)
def test_group_tile_emulation_stays_within_rel_tol(layout, G):
    """P rounded to bf16 per slot-warp stream, the output rounded to bf16:
    within REL_TOL[bf16] x the weighted |v| of the XLA oracle at G = 2, 3,
    7 and 8, the card's tolerance; an empty row is exactly v_new."""
    c = _group_case(layout, G)
    got, ref, ref_abs = group_emulated(c), oracle(c), oracle(c, v_abs=True)
    assert torch.isfinite(got).all()
    tol = chip_smoke.REL_TOL[BF16] * ref_abs + 1e-6
    assert ((got - ref).abs() / tol).max().item() <= 1.0
    for b in range(got.shape[0]):
        if int(c["qpos"][b, 0]) == 0:
            assert torch.equal(got[b, 0], c["vn"][b, 0].repeat_interleave(G, 0))


@pytest.mark.parametrize("layout, G", GROUP_GRID)
def test_plain_versions_are_the_oracle_at_small_groups(layout, G):
    """The plain versions, the CPU path and the card's check, compute the
    XLA oracles at the group tile's small head groups too."""
    c = _group_case(layout, G)
    torch.testing.assert_close(plain(c), oracle(c), **TOL)
