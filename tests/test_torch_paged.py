"""The torch port's paged KV layout against the JAX package's, on the CPU in
fp32: the pool functions and the block allocator, the plain versions of
kernels K3 / K4 against the reference's XLA oracles
(``ops.attention.paged_decode_attention`` / ``ragged_paged_attention``),
the paged and ragged forwards, and ``generate`` over the paged layout.

The plain versions are held to the XLA oracles, not to the Pallas kernels
run in interpret mode (the reference's own CB == 1 bit-identity test fails
on this tree's jax). Tolerances: 1e-5 on attention outputs and 1e-4 on
logits; both sides compute in fp32, and only the order of accumulation
differs. Inputs come from numpy with a seed.

The port's pool holds one block more than the reference's (block N, the
target of dropped writes), so pools compare on blocks [0, N)."""

import importlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmss_tpu.engine import DecodeEngine as JEngine
from llmss_tpu.engine import GenerationParams as JGen
from llmss_tpu.engine import cache as jc
from llmss_tpu.models import decoder as jdec
from llmss_tpu.models.common import DecoderConfig as JCfg
from llmss_tpu.parallel import MeshPlan, make_mesh
from llmss_tpu_torch.convert import params_from_jax
from llmss_tpu_torch.engine import cache as tc
from llmss_tpu_torch.engine.engine import DecodeEngine as TEngine
from llmss_tpu_torch.engine.engine import GenerationParams as TGen
from llmss_tpu_torch.models import decoder as tdec
from llmss_tpu_torch.models.common import DecoderConfig as TCfg
from llmss_tpu_torch.ops import paged_attention as pa

CFG = dict(model_type="llama", vocab_size=128, hidden_size=64, n_layers=2,
           n_heads=4, n_kv_heads=2, head_dim=16, intermediate_size=96,
           max_position_embeddings=64, activation="silu", norm="rmsnorm",
           mlp="swiglu", positions="rotary", rope_style="half",
           attn_bias=False, mlp_bias=False, dtype="float32")
TOL = dict(rtol=1e-5, atol=1e-5)
# The package re-exports a function named ``attention`` over the module.
jatt = importlib.import_module("llmss_tpu.ops.attention")


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(MeshPlan(dp=1, tp=1), devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def model(mesh):
    jp = jdec.init_params(JCfg(**CFG), mesh, jax.random.key(0))
    return jp, params_from_jax(jax.device_get(jp))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _pools(rng, L, N, bs, Hkv, D):
    """The reference's [L, N, ...] pool and the port's copy of it with a
    drop block of garbage appended (a read of it would show)."""
    k = rng.normal(size=(L, N, bs, Hkv, D)).astype(np.float32)
    junk = np.full((L, 1, bs, Hkv, D), 1e4, np.float32)
    return k, torch.from_numpy(np.concatenate([k, junk], axis=1))


# -- pool functions and allocator ----------------------------------------------


def test_pool_functions_match_jax():
    """logical_to_physical, gather_block_view (full and bucketed) and
    paged_write_stacked on tables with sentinel entries, with writes through
    sentinels and to out-of-range slots dropped, as in the reference."""
    rng = np.random.default_rng(0)
    L, N, bs, MB, Hkv, D = 2, 6, 4, 3, 2, 8
    bt = np.array([[4, 1, N], [0, N + 3, 2]], np.int32)
    slots = np.array([[0, 5, 9, 12], [3, 4, 7, 10]], np.int32)  # 12: OOB
    pool_np, pool = _pools(rng, L, N, bs, Hkv, D)
    jblk, joff = jc.logical_to_physical(jnp.asarray(bt), jnp.asarray(slots), bs)
    blk, off = tc.logical_to_physical(_t(bt), _t(slots), bs)
    np.testing.assert_array_equal(blk.numpy(), np.asarray(jblk))
    np.testing.assert_array_equal(off.numpy(), np.asarray(joff))
    for nb in (None, 2):
        want = jc.gather_block_view(jnp.asarray(pool_np[1]), jnp.asarray(bt), nb)
        got = tc.gather_block_view(pool[1], _t(bt), nb)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    new = rng.normal(size=(L, 2, 4, Hkv, D)).astype(np.float32)
    want = jc.paged_write_stacked(jnp.asarray(pool_np), jnp.asarray(new),
                                  jnp.asarray(bt), jnp.asarray(slots), bs)
    tc.paged_write_stacked(pool, _t(new), _t(bt), _t(slots), bs)
    np.testing.assert_array_equal(pool[:, :N].numpy(), np.asarray(want))
    # Positions: slots outside [0, T) drop, negative ones never wrap.
    pos = torch.full((2, MB * bs), -1, dtype=torch.int32)
    tc.write_slots(pos, torch.tensor([[1, 12, -1], [11, 0, 2]]),
                   torch.tensor([[7, 8, 9], [5, 6, 4]], dtype=torch.int32))
    assert pos[0].tolist() == [-1, 7] + [-1] * 10
    assert pos[1].tolist() == [6, -1, 4] + [-1] * 8 + [5]


def test_block_allocator_matches_jax():
    """The same scripted alloc / incref / free sequence gives the same
    block ids, refcounts and free counts on both allocators."""
    ja, ta = jc.BlockAllocator(8), tc.BlockAllocator(8)
    script = [("alloc", 3), ("alloc", 2), ("incref", 0), ("free", 1),
              ("alloc", 4), ("free", 0), ("alloc", 2), ("free", 0),
              ("alloc", 9), ("alloc", 0)]
    held = []
    for op, arg in script:
        if op == "alloc":
            a, b = ja.alloc(arg), ta.alloc(arg)
            assert a == b
            if a is not None:
                held.append(a)
        elif op == "incref":
            ja.incref(held[arg])
            ta.incref(held[arg])
        else:
            assert ja.free(held[arg]) == ta.free(held[arg])
        assert (ja.free_blocks, ja.blocks_in_use) == (ta.free_blocks, ta.blocks_in_use)
        assert [ja.refcount(i) for i in range(8)] == [ta.refcount(i) for i in range(8)]
        assert ja.largest_free_run() == ta.largest_free_run()
    with pytest.raises(ValueError):
        ta.alloc(-1)


# -- plain K3 / K4 against the XLA oracles ------------------------------------

L, N, BS, MB = 2, 20, 8, 4
RING = MB * BS


def _history(B, hist):
    """kv positions [B, RING] for rows whose histories are positions
    0..hist[b]-1 at slot p % RING (wrapped rows keep the latest)."""
    kvp = np.full((B, RING), -1, np.int32)
    for b, n in enumerate(hist):
        for p in range(n):
            kvp[b, p % RING] = p
    return kvp


def _tables(B, hist, rng):
    """Distinct random blocks for each row's occupied columns, a sentinel
    (or larger) entry after them."""
    ids = rng.permutation(N)
    bt = np.full((B, MB), N, np.int32)
    k = 0
    for b, n in enumerate(hist):
        cols = MB if n >= RING else -(-(n + 1) // BS)
        bt[b, :cols] = ids[k:k + cols]
        k += cols
        if cols < MB:
            bt[b, cols:] = N + b
    return bt


K3_CASES = {
    # name: (Hq, Hkv, histories, window, n_cols)
    "mha": (4, 4, [13, 5, 27], None, None),
    "gqa": (4, 2, [13, 0, 31], None, None),
    "mqa": (4, 1, [7, 20, 1], None, 3),
    "window": (4, 2, [30, 12, 25], 6, None),
    "ring_wrap": (4, 2, [45, 40, 33], None, None),
    "empty_row": (2, 2, [0, 9, 0], None, 2),
}


@pytest.mark.parametrize("name", sorted(K3_CASES))
def test_plain_k3_matches_xla_oracle(name):
    Hq, Hkv, hist, window, n_cols = K3_CASES[name]
    rng = np.random.default_rng(sorted(K3_CASES).index(name))
    B, D = len(hist), 16
    kp_np, kp = _pools(rng, L, N, BS, Hkv, D)
    vp_np, vp = _pools(rng, L, N, BS, Hkv, D)
    q = rng.normal(size=(B, 1, Hq, D)).astype(np.float32)
    kn = rng.normal(size=(B, 1, Hkv, D)).astype(np.float32)
    vn = rng.normal(size=(B, 1, Hkv, D)).astype(np.float32)
    kvp = _history(B, hist)
    bt = _tables(B, hist, rng)
    qpos = np.asarray(hist, np.int32)[:, None]
    slots = qpos % RING
    nblk = np.asarray([min(MB, -(-int((kvp[b] >= 0).sum()) // BS))
                       for b in range(B)], np.int32)
    T = (n_cols or MB) * BS
    for layer in range(L):
        want = jatt.paged_decode_attention(
            jnp.asarray(q), jnp.asarray(kp_np[layer]), jnp.asarray(vp_np[layer]),
            jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(qpos),
            jnp.asarray(kvp[:, :T]), jnp.asarray(bt), jnp.asarray(slots),
            window=window, n_blocks=n_cols,
        )
        got = pa.paged_decode_attention_ref(
            _t(q), kp, vp, _t(kn), _t(vn), _t(qpos), _t(kvp), _t(bt),
            _t(nblk), _t(slots), layer, n_cols=n_cols, window=window,
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for b in range(B):
            if hist[b] == 0:  # an empty row attends only its fresh token
                G = Hq // Hkv
                assert torch.equal(got[b, 0], _t(vn)[b, 0].repeat_interleave(G, 0))


K4_CASES = {
    # name: (Hq, Hkv, contexts, q_lens, CB, window); rows past q_len are
    # padding query rows.
    "mha": (4, 4, [13, 0, 27], [3, 4, 1], 4, None),
    "gqa": (4, 2, [13, 0, 27], [3, 4, 1], 4, None),
    "mqa": (4, 1, [5, 16, 2], [4, 1, 2], 4, None),
    "window": (4, 2, [20, 9, 30], [4, 2, 1], 4, 5),
    # Row 0's chunk starts at slot 30 and wraps onto slots 0..2.
    "ring_wrap": (4, 2, [62, 40, 3], [5, 1, 5], 6, None),
    "padding_rows": (2, 2, [8, 1, 0], [1, 2, 1], 8, None),
}


def _k4_inputs(name):
    Hq, Hkv, ctx, qlen, CB, window = K4_CASES[name]
    rng = np.random.default_rng(10 + sorted(K4_CASES).index(name))
    B, D = len(ctx), 16
    kp_np, kp = _pools(rng, L, N, BS, Hkv, D)
    vp_np, vp = _pools(rng, L, N, BS, Hkv, D)
    q = rng.normal(size=(B, CB, Hq, D)).astype(np.float32)
    kn = rng.normal(size=(B, CB, Hkv, D)).astype(np.float32)
    vn = rng.normal(size=(B, CB, Hkv, D)).astype(np.float32)
    kvp = _history(B, ctx)
    bt = _tables(B, [max(c, c + q - 1) for c, q in zip(ctx, qlen)], rng)
    q_pos = np.asarray(ctx, np.int32)
    slot0 = q_pos % RING
    nblk = np.asarray([min(MB, -(-int((kvp[b] >= 0).sum()) // BS))
                       for b in range(B)], np.int32)
    return (q, kp_np, kp, vp_np, vp, kn, vn, q_pos, np.asarray(qlen, np.int32),
            kvp, bt, nblk, slot0, window)


@pytest.mark.parametrize("name", sorted(K4_CASES))
def test_plain_k4_matches_xla_oracle(name):
    (q, kp_np, kp, vp_np, vp, kn, vn, q_pos, qlen, kvp, bt, nblk, slot0,
     window) = _k4_inputs(name)
    for layer in range(L):
        want = jatt.ragged_paged_attention(
            jnp.asarray(q), jnp.asarray(kp_np[layer]), jnp.asarray(vp_np[layer]),
            jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(q_pos),
            jnp.asarray(qlen), jnp.asarray(kvp), jnp.asarray(bt),
            jnp.asarray(slot0), RING, window=window,
        )
        got = pa.ragged_paged_attention_ref(
            _t(q), kp, vp, _t(kn), _t(vn), _t(q_pos), _t(qlen), _t(kvp),
            _t(bt), _t(nblk), _t(slot0), layer, window=window,
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert torch.isfinite(got).all()  # padding rows stay finite


def test_plain_k4_at_cb1_equals_plain_k3():
    """An all-decode batch (CB = 1, q_len = 1) through the ragged plain
    version equals the decode plain version."""
    rng = np.random.default_rng(7)
    hist, Hq, Hkv, D = [13, 0, 33], 4, 2, 16
    B = len(hist)
    _, kp = _pools(rng, L, N, BS, Hkv, D)
    _, vp = _pools(rng, L, N, BS, Hkv, D)
    q, kn, vn = (_t(rng.normal(size=(B, 1, h, D)).astype(np.float32))
                 for h in (Hq, Hkv, Hkv))
    kvp, bt = _t(_history(B, hist)), _t(_tables(B, hist, rng))
    qpos = torch.tensor(hist, dtype=torch.int32)
    nblk = torch.tensor([2, 0, 4], dtype=torch.int32)
    slots = qpos % RING
    d = pa.paged_decode_attention_ref(q, kp, vp, kn, vn, qpos[:, None], kvp,
                                      bt, nblk, slots[:, None], 1)
    r = pa.ragged_paged_attention_ref(q, kp, vp, kn, vn, qpos,
                                      torch.ones(B, dtype=torch.int32), kvp,
                                      bt, nblk, slots, 1)
    torch.testing.assert_close(r, d, rtol=1e-6, atol=1e-6)


# -- forwards -----------------------------------------------------------------


def _caches(jcfg, mesh, B, T, bs, tables):
    """A JAX and a port paged cache of the same (non-identity) tables."""
    n = int(tables[tables < 1000].max()) + 2
    kw = dict(n_layers=jcfg.n_layers, batch=B, max_len=T,
              n_kv_heads=jcfg.n_kv_heads, head_dim=jcfg.head_dim,
              block_size=bs, num_blocks=n, identity_tables=False)
    jcache = jc.init_paged_cache(mesh, dtype=jnp.float32, **kw)._replace(
        block_tables=jnp.asarray(tables))
    tcache = tc.init_paged_cache(dtype=torch.float32, device="cpu", **kw)
    tcache = tcache._replace(block_tables=_t(tables))
    return jcache, tcache, n


def _same_cache(tcache, jcache, n):
    np.testing.assert_array_equal(tcache.positions.numpy(),
                                  np.asarray(jcache.positions))
    for a, b in ((tcache.k, jcache.k), (tcache.v, jcache.v)):
        np.testing.assert_allclose(a[:, :n].numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)


def test_forward_paged_matches_jax(model, mesh):
    """Prefill of right-padded prompts, then decode steps with a bucketed
    read and a done row, over scattered tables with sentinel columns."""
    jp, tp = model
    jcfg, tcfg = JCfg(**CFG), TCfg(**CFG)
    B, T, bs = 2, 48, 8
    tables = np.array([[9, 2, 7, 40, 40, 40], [0, 5, 11, 3, 41, 41]], np.int32)
    jcache, tcache, n = _caches(jcfg, mesh, B, T, bs, tables)
    jfwd = jax.jit(partial(jdec.forward, jcfg),
                   static_argnames=("last_only", "t_bucket"))
    rng = np.random.default_rng(0)
    S = 16
    ids = rng.integers(0, 128, (B, S)).astype(np.int32)
    lens = np.array([16, 11], np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    kvp = np.where(pos < lens[:, None], pos, -1).astype(np.int32)
    jl, jcache = jfwd(jp, jnp.asarray(ids), jnp.asarray(pos), jcache,
                      jnp.asarray(pos % T), gather_idx=jnp.asarray(lens - 1),
                      kv_write_positions=jnp.asarray(kvp))
    tl, _ = tdec.forward(tcfg, tp, _t(ids), _t(pos), tcache, _t(pos % T),
                         gather_idx=_t(lens - 1), kv_write_positions=_t(kvp))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    _same_cache(tcache, jcache, n)
    cur = lens.copy()
    tok = np.asarray(jl)[:, 0].argmax(-1).astype(np.int32)
    for step in range(12):
        p = cur[:, None]
        sl = np.where(np.array([[False], [step >= 8]]), T, p % T).astype(np.int32)
        tb = 32 if step < 8 else None
        jl, jcache = jfwd(jp, jnp.asarray(tok[:, None]), jnp.asarray(p), jcache,
                          jnp.asarray(sl), last_only=True, t_bucket=tb)
        tl, _ = tdec.forward(tcfg, tp, _t(tok[:, None]), _t(p), tcache, _t(sl),
                             t_bucket=tb)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4, err_msg=f"decode step {step}")
        tok = np.asarray(jl)[:, 0].argmax(-1).astype(np.int32)
        cur += 1
    _same_cache(tcache, jcache, n)


def test_forward_ragged_matches_jax(model, mesh):
    """Mixed chunks: row 0 streams a 10-token prompt in CB = 4 slices while
    row 1 prefills 3 tokens and then decodes; a dead column writes
    nowhere."""
    jp, tp = model
    jcfg, tcfg = JCfg(**CFG), TCfg(**CFG)
    B, T, bs, CB = 2, 48, 8, 4
    tables = np.array([[3, 8, 40, 40, 40, 40], [6, 1, 41, 41, 41, 41]], np.int32)
    jcache, tcache, n = _caches(jcfg, mesh, B, T, bs, tables)
    jfwd = jax.jit(partial(jdec.forward_ragged, jcfg))
    rng = np.random.default_rng(1)
    cur = np.zeros(B, np.int32)
    for qlens in ([4, 3], [4, 1], [2, 1], [1, 1], [1, 1]):
        ql = np.asarray(qlens, np.int32)
        ids = rng.integers(0, 128, (B, CB)).astype(np.int32)
        rel = np.arange(CB, dtype=np.int32)
        pos = cur[:, None] + rel[None, :]
        live = rel[None, :] < ql[:, None]
        slots = np.where(live, pos % T, T).astype(np.int32)
        kvp = np.where(live, pos, -1).astype(np.int32)
        jl, jcache = jfwd(jp, jnp.asarray(ids), jnp.asarray(pos), jcache,
                          jnp.asarray(slots), jnp.asarray(ql),
                          kv_write_positions=jnp.asarray(kvp))
        tl, _ = tdec.forward_ragged(tcfg, tp, _t(ids), _t(pos), tcache,
                                    _t(slots), _t(ql), kv_write_positions=_t(kvp))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4, err_msg=f"q_lens {qlens}")
        cur += ql
    _same_cache(tcache, jcache, n)


PROMPTS = [[5, 9, 23, 40], list(range(3, 20)), [1, 2, 3]]


def _gens(G):
    return [G(max_new_tokens=12),
            G(max_new_tokens=10, is_greedy=False, temperature=0.8, top_k=10,
              top_p=0.9, seed=42),
            G(max_new_tokens=9, is_greedy=False, temperature=1.3, seed=7)]


@pytest.mark.parametrize("chunk_steps", [1, 4])
def test_paged_generate_matches_dense_and_jax(model, mesh, chunk_steps):
    jp, tp = model
    paged = TEngine(TCfg(**CFG), tp, device="cpu", max_seq_len=64,
                    kv_layout="paged", block_size=8)
    dense = TEngine(TCfg(**CFG), tp, device="cpu", max_seq_len=64)
    got = paged.generate(PROMPTS, _gens(TGen), chunk_steps=chunk_steps)
    assert got == dense.generate(PROMPTS, _gens(TGen), chunk_steps=chunk_steps)
    if chunk_steps == 1:
        jeng = JEngine(JCfg(**CFG), jp, mesh, max_seq_len=64,
                       kv_layout="paged", block_size=8)
        assert got == jeng.generate(PROMPTS, _gens(JGen))


def test_engine_layout_validation(model):
    _, tp = model
    with pytest.raises(ValueError, match="kv_layout"):
        TEngine(TCfg(**CFG), tp, device="cpu", max_seq_len=64, kv_layout="wat")
    with pytest.raises(ValueError, match="divisible"):
        TEngine(TCfg(**CFG), tp, device="cpu", max_seq_len=60,
                kv_layout="paged", block_size=16)
