"""The torch port's int8 KV cache against the JAX package's, on the CPU.

- ``quantize_kv`` / ``dequantize_kv``: bit for bit, in fp32 and bf16;
- the plain versions with scales (``fresh_kv_decode_attention``, paged
  decode, ragged attention) against the reference's XLA oracles with
  ``k_scale=`` / ``k_scale_layer=`` (llmss_tpu/ops/attention.py:242, :352,
  :503): fp32 on both sides, only the order of accumulation differs, so
  1e-5;
- the plain K4 over an int8 pool against the Pallas K4's int8 branch in
  interpret mode, at ``tests/test_ragged.py``'s int8 case: 2e-5, the
  tolerance that test holds the Pallas kernel to against its oracle;
- ``forward`` / ``forward_paged`` / ``forward_ragged`` on int8 caches: logits
  within 1e-3 of the largest |logit|; int8 storage equal but for at most
  0.1% of entries, by at most 1 (the fresh K/V differ by fp32 rounding,
  which can move a value across a rounding boundary); scales to rtol 1e-5;
- the engine, the batcher, the workers and the CLI on ``kv_dtype="int8"``:
  the same greedy tokens as the JAX engine and across every path, and logits
  within 5% of the compute-dtype cache's (``tests/test_int8_cache.py``).

The port's pool holds one block more than the reference's (block N, the
target of dropped writes), so pools compare on blocks [0, N). Inputs come
from numpy with a seed.
"""

import importlib
from functools import partial

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.torch import save_file

from llmss_tpu.engine import DecodeEngine as JEngine
from llmss_tpu.engine import GenerationParams as JGen
from llmss_tpu.engine import cache as jc
from llmss_tpu.models import decoder as jdec
from llmss_tpu.models.common import DecoderConfig as JCfg
from llmss_tpu.models.registry import load_model as jax_load_model
from llmss_tpu.ops import pallas_ragged
from llmss_tpu.parallel import MeshPlan, make_mesh
from llmss_tpu_torch.cli.generate import main as cli_main
from llmss_tpu_torch.convert import params_from_jax
from llmss_tpu_torch.engine import cache as tc
from llmss_tpu_torch.engine import graphs
from llmss_tpu_torch.engine.engine import DecodeEngine as TEngine
from llmss_tpu_torch.engine.engine import GenerationParams as TGen
from llmss_tpu_torch.engine.scheduler import ContinuousBatcher
from llmss_tpu_torch.models import decoder as tdec
from llmss_tpu_torch.models.common import DecoderConfig as TCfg
from llmss_tpu_torch.ops import attention as tatt
from llmss_tpu_torch.ops import paged_attention as pa
from llmss_tpu_torch.serve.broker import InProcBroker
from llmss_tpu_torch.serve.consumer import ContinuousWorker, Worker
from llmss_tpu_torch.serve.protocol import GenerateRequest

CFG = dict(model_type="llama", vocab_size=128, hidden_size=64, n_layers=2,
           n_heads=4, n_kv_heads=2, head_dim=16, intermediate_size=96,
           max_position_embeddings=64, activation="silu", norm="rmsnorm",
           mlp="swiglu", positions="rotary", rope_style="half",
           attn_bias=False, mlp_bias=False, dtype="float32")
TOL = dict(rtol=1e-5, atol=1e-5)
jatt = importlib.import_module("llmss_tpu.ops.attention")


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(MeshPlan(dp=1, tp=1), devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def model(mesh):
    jp = jdec.init_params(JCfg(**CFG), mesh, jax.random.key(0))
    return jp, params_from_jax(jax.device_get(jp))


def _t(x):
    x = np.asarray(x)
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


# -- (a) quantize / dequantize --------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_matches_jax_bit_for_bit(dtype):
    """The same input gives the same int8 values and fp32 scales, and the
    dequantized values match bit for bit in the input's dtype (the scale
    rounded to it first)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 4, 32)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero head vector
    x[1, 2, 1, :4] = [127.5, -0.5, 1.5, 2.5]  # ties at the rounding points
    jx = jnp.asarray(x, dtype)
    jq, js = jc.quantize_kv(jx)
    tq, ts = tc.quantize_kv(_t(jx))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jd = jc.dequantize_kv(jq, js, jx.dtype)
    td = tc.dequantize_kv(tq, ts, _t(jx).dtype)
    np.testing.assert_array_equal(_np(td).view(np.uint8),
                                  np.asarray(jd).view(np.uint8))


def test_quantize_round_trip_and_zero_rows():
    """As ``tests/test_int8_cache.py`` has it: half a step of error, a
    lossless dequantize -> quantize, and all-zero rows exactly zero."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, 5, 4, 32)).astype(np.float32))
    q, s = tc.quantize_kv(x)
    assert s.shape == x.shape[:-1]
    err = (tc.dequantize_kv(q, s, torch.float32) - x).abs()
    assert (err <= s[..., None] / 2 + 1e-7).all()
    q2, s2 = tc.quantize_kv(tc.dequantize_kv(q, s, torch.float32))
    assert torch.equal(q, q2)
    torch.testing.assert_close(s2, s, rtol=1e-6, atol=0)
    q0, s0 = tc.quantize_kv(torch.zeros(2, 4, 8))
    assert (q0 == 0).all() and (tc.dequantize_kv(q0, s0, torch.float32) == 0).all()


# -- (b) plain versions with scales against the XLA oracles --------------------

L, N, BS, MB = 2, 20, 8, 4
RING = MB * BS


def _int8(rng, shape):
    """Random int8 values and fp32 scales of ``shape[:-1]``."""
    return (rng.integers(-127, 128, size=shape).astype(np.int8),
            rng.uniform(0.01, 0.03, size=shape[:-1]).astype(np.float32))


def _history(B, T, hist):
    kvp = np.full((B, T), -1, np.int32)
    for b, n in enumerate(hist):
        for p in range(n):
            kvp[b, p % T] = p
    return kvp


def _tables(B, hist, rng):
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


def _pool(rng, Hkv, D):
    """An int8 pool and its scales, the reference's [L, N, ...] and the
    port's with a drop block of garbage appended (a read of it would
    show)."""
    k8, ks = _int8(rng, (L, N, BS, Hkv, D))
    junk8 = np.full((L, 1, BS, Hkv, D), 127, np.int8)
    junks = np.full((L, 1, BS, Hkv), 1e4, np.float32)
    return (k8, ks, _t(np.concatenate([k8, junk8], 1)),
            _t(np.concatenate([ks, junks], 1)))


# (Hq, Hkv, histories) with GQA, a wrapped ring row and an empty row.
DECODE_CASES = {"gqa_wrap_empty": (4, 2, [45, 9, 0]), "mha": (2, 2, [7, 31, 1]),
                "mqa": (4, 1, [0, 33, 12])}


@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_plain_dense_decode_with_scales_matches_oracle(name):
    """``fresh_kv_decode_attention(k_scale=, v_scale=)`` and the dispatch's
    K2 plain version over a stacked int8 cache, against the reference's
    oracle, at the full ring and a bucketed read."""
    Hq, Hkv, hist = DECODE_CASES[name]
    rng = np.random.default_rng(sorted(DECODE_CASES).index(name))
    B, T, D = len(hist), 32, 16
    k8, ks = _int8(rng, (L, B, T, Hkv, D))
    v8, vs = _int8(rng, (L, B, T, Hkv, D))
    q, kn, vn = (rng.normal(size=(B, 1, h, D)).astype(np.float32)
                 for h in (Hq, Hkv, Hkv))
    layer = 1
    # The full ring, then a bucketed read of slots [0, 16) for the same
    # rows with their histories cut below 16 (the caller's contract).
    for h, t_len in ((hist, None), ([min(n, 12) for n in hist], 16)):
        t = t_len or T
        kvp = _history(B, T, h)
        qpos = np.asarray(h, np.int32)[:, None]
        slots = qpos % T
        want = jatt.fresh_kv_decode_attention(
            jnp.asarray(q), jnp.asarray(k8[layer, :, :t]),
            jnp.asarray(v8[layer, :, :t]), jnp.asarray(kn), jnp.asarray(vn),
            jnp.asarray(qpos), jnp.asarray(kvp[:, :t]), jnp.asarray(slots),
            k_scale=jnp.asarray(ks[layer, :, :t]),
            v_scale=jnp.asarray(vs[layer, :, :t]))
        if t_len is None:
            got = tatt.fresh_kv_decode_attention(
                _t(q), _t(k8[layer]), _t(v8[layer]), _t(kn), _t(vn),
                _t(qpos), _t(kvp), _t(slots), k_scale=_t(ks[layer]),
                v_scale=_t(vs[layer]))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        got = tatt.decode_attention(
            _t(q), _t(k8), _t(v8), _t(kn), _t(vn), _t(qpos), _t(kvp),
            _t(slots), layer, t_len=t_len, k_scale=_t(ks), v_scale=_t(vs))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for b in range(B):
            if h[b] == 0:  # an empty row attends only its fresh token
                assert torch.equal(got[b, 0],
                                   _t(vn)[b, 0].repeat_interleave(Hq // Hkv, 0))


@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_plain_paged_decode_with_scales_matches_oracle(name):
    """The dispatch's K3 plain version over an int8 pool (scattered tables,
    sentinel columns) against ``paged_decode_attention(k_scale_layer=)``."""
    Hq, Hkv, hist = DECODE_CASES[name]
    rng = np.random.default_rng(10 + sorted(DECODE_CASES).index(name))
    B, D = len(hist), 16
    k8, ks, kp, ksp = _pool(rng, Hkv, D)
    v8, vs, vp, vsp = _pool(rng, Hkv, D)
    q, kn, vn = (rng.normal(size=(B, 1, h, D)).astype(np.float32)
                 for h in (Hq, Hkv, Hkv))
    kvp = _history(B, RING, hist)
    bt = _tables(B, hist, rng)
    qpos = np.asarray(hist, np.int32)[:, None]
    slots = qpos % RING
    nblk = torch.zeros(B, dtype=torch.int32)  # the plain version reads no n_blocks
    for layer, n_cols in ((0, None), (1, 3)):
        T = (n_cols or MB) * BS
        want = jatt.paged_decode_attention(
            jnp.asarray(q), jnp.asarray(k8[layer]), jnp.asarray(v8[layer]),
            jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(qpos),
            jnp.asarray(kvp[:, :T]), jnp.asarray(bt), jnp.asarray(slots),
            k_scale_layer=jnp.asarray(ks[layer]),
            v_scale_layer=jnp.asarray(vs[layer]), n_blocks=n_cols)
        got = tatt.paged_decode_attention(
            _t(q), kp, vp, _t(kn), _t(vn), _t(qpos), _t(kvp), _t(bt), nblk,
            _t(slots), layer, n_cols=n_cols, k_scale=ksp, v_scale=vsp)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# (Hq, Hkv, contexts, q_lens, CB); row 0 of "ring_wrap" wraps onto slot 0.
RAGGED_CASES = {"gqa": (4, 2, [13, 0, 27], [3, 4, 1], 4),
                "ring_wrap": (4, 2, [30, 9, 0], [5, 1, 6], 6),
                "mqa_decode_rows": (4, 1, [5, 16, 0], [1, 1, 1], 4)}


@pytest.mark.parametrize("name", sorted(RAGGED_CASES))
def test_plain_ragged_with_scales_matches_oracle(name):
    """The dispatch's K4 plain version over an int8 pool against
    ``ragged_paged_attention(k_scale_layer=)``; the chunk's fresh keys are
    not quantized on either side."""
    Hq, Hkv, ctx, qlen, CB = RAGGED_CASES[name]
    rng = np.random.default_rng(20 + sorted(RAGGED_CASES).index(name))
    B, D = len(ctx), 16
    k8, ks, kp, ksp = _pool(rng, Hkv, D)
    v8, vs, vp, vsp = _pool(rng, Hkv, D)
    q = rng.normal(size=(B, CB, Hq, D)).astype(np.float32)
    kn, vn = (rng.normal(size=(B, CB, Hkv, D)).astype(np.float32)
              for _ in range(2))
    kvp = _history(B, RING, ctx)
    bt = _tables(B, [c + n - 1 for c, n in zip(ctx, qlen)], rng)
    q_pos = np.asarray(ctx, np.int32)
    ql = np.asarray(qlen, np.int32)
    slot0 = q_pos % RING
    nblk = torch.zeros(B, dtype=torch.int32)
    for layer in range(L):
        want = jatt.ragged_paged_attention(
            jnp.asarray(q), jnp.asarray(k8[layer]), jnp.asarray(v8[layer]),
            jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(q_pos),
            jnp.asarray(ql), jnp.asarray(kvp), jnp.asarray(bt),
            jnp.asarray(slot0), RING, k_scale_layer=jnp.asarray(ks[layer]),
            v_scale_layer=jnp.asarray(vs[layer]))
        got = tatt.ragged_attention(
            _t(q), kp, vp, _t(kn), _t(vn), _t(q_pos), _t(ql), _t(kvp), _t(bt),
            nblk, _t(slot0), layer, k_scale=ksp, v_scale=vsp)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plain_k3_int8_equals_k4_int8_at_cb1():
    """An all-decode batch over an int8 pool: the ragged plain version at
    CB = 1 equals the decode plain version, as the kernels do bit for
    bit."""
    rng = np.random.default_rng(3)
    hist, Hq, Hkv, D = [13, 0, 33], 4, 2, 16
    B = len(hist)
    _, _, kp, ksp = _pool(rng, Hkv, D)
    _, _, vp, vsp = _pool(rng, Hkv, D)
    q, kn, vn = (_t(rng.normal(size=(B, 1, h, D)).astype(np.float32))
                 for h in (Hq, Hkv, Hkv))
    kvp, bt = _t(_history(B, RING, hist)), _t(_tables(B, hist, rng))
    qpos = torch.tensor(hist, dtype=torch.int32)
    nblk = torch.zeros(B, dtype=torch.int32)
    slots = qpos % RING
    d = pa.paged_decode_attention_ref(q, kp, vp, kn, vn, qpos[:, None], kvp,
                                      bt, nblk, slots[:, None], 1,
                                      k_scale=ksp, v_scale=vsp)
    r = pa.ragged_paged_attention_ref(q, kp, vp, kn, vn, qpos,
                                      torch.ones(B, dtype=torch.int32), kvp,
                                      bt, nblk, slots, 1, k_scale=ksp,
                                      v_scale=vsp)
    torch.testing.assert_close(r, d, rtol=1e-6, atol=1e-6)


# -- (c) the plain K4 int8 against the Pallas int8 branch ----------------------


def test_plain_k4_int8_matches_pallas_int8_branch():
    """``tests/test_ragged.py``'s int8 case (L 2, 16 blocks of 8, Hkv 2, Hq
    4, D 128, chunks of 4): a partial tail block, an empty row whose whole
    prompt is in its chunk, a decode row crossing a block boundary. The
    Pallas kernel runs in interpret mode; live query rows agree to 2e-5."""
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
    q = rng.normal(size=(B, CB, Hq, D)).astype(np.float32)
    kn = rng.normal(size=(B, CB, Hkv, D)).astype(np.float32)
    vn = rng.normal(size=(B, CB, Hkv, D)).astype(np.float32)
    q_pos = ctx.astype(np.int32)
    slot0 = (ctx % ring).astype(np.int32)
    want = pallas_ragged.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(kn),
        jnp.asarray(vn), jnp.asarray(q_pos), jnp.asarray(qlen),
        jnp.asarray(kvp), jnp.asarray(bt), jnp.asarray(nblk),
        jnp.asarray(slot0), jnp.int32(1), k_scale_pool=jnp.asarray(ks),
        v_scale_pool=jnp.asarray(vs), interpret=True)

    def drop_block(x, fill):
        pad = np.full((Lp, 1) + x.shape[2:], fill, x.dtype)
        return _t(np.concatenate([x, pad], 1))

    got = pa.ragged_paged_attention_ref(
        _t(q), drop_block(k8, 127), drop_block(v8, 127), _t(kn), _t(vn),
        _t(q_pos), _t(qlen), _t(kvp), _t(bt), _t(nblk), _t(slot0), 1,
        k_scale=drop_block(ks, 1e4), v_scale=drop_block(vs, 1e4))
    for b in range(B):
        np.testing.assert_allclose(got[b, :qlen[b]].numpy(),
                                   np.asarray(want)[b, :qlen[b]],
                                   rtol=2e-5, atol=2e-5)


# -- (d) forwards on int8 caches --------------------------------------------------


def _close_logits(got, want, what):
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-3 * np.abs(want).max(), (what, err)


def _same_int8_cache(tcache, jcache, n_blocks=None):
    """Positions equal; int8 storage equal but for <= 0.1% of entries, by
    <= 1; scales to rtol 1e-5 (paged: blocks [0, N))."""
    np.testing.assert_array_equal(tcache.positions.numpy(),
                                  np.asarray(jcache.positions))
    cut = slice(None) if n_blocks is None else slice(0, n_blocks)
    for a, b in ((tcache.k, jcache.k), (tcache.v, jcache.v)):
        assert a.dtype == torch.int8
        d = np.abs(a[:, cut].numpy().astype(np.int32)
                   - np.asarray(b).astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())
    for a, b in ((tcache.k_scale, jcache.k_scale),
                 (tcache.v_scale, jcache.v_scale)):
        np.testing.assert_allclose(a[:, cut].numpy(), np.asarray(b),
                                   rtol=1e-5, atol=0)


def _prefill_inputs(rng, B, S, lens, T):
    ids = rng.integers(0, 128, (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    kvp = np.where(pos < np.asarray(lens)[:, None], pos, -1).astype(np.int32)
    return ids, pos, (pos % T).astype(np.int32), kvp


def test_forward_int8_dense_matches_jax(model, mesh):
    """Dense ring: a right-padded prefill, then decode steps (a bucketed
    read, the full ring, a ring wrap)."""
    jp, tp = model
    jcfg, tcfg = JCfg(**CFG), TCfg(**CFG)
    B, T, S = 2, 32, 16
    kw = dict(n_layers=jcfg.n_layers, batch=B, max_len=T,
              n_kv_heads=jcfg.n_kv_heads, head_dim=jcfg.head_dim)
    jcache = jc.init_cache(mesh, dtype=jnp.int8, **kw)
    tcache = tc.init_cache(dtype=torch.int8, device="cpu", **kw)
    jfwd = jax.jit(partial(jdec.forward, jcfg),
                   static_argnames=("last_only", "t_bucket"))
    rng = np.random.default_rng(0)
    lens = np.array([16, 11], np.int32)
    ids, pos, slots, kvp = _prefill_inputs(rng, B, S, lens, T)
    jl, jcache = jfwd(jp, jnp.asarray(ids), jnp.asarray(pos), jcache,
                      jnp.asarray(slots), gather_idx=jnp.asarray(lens - 1),
                      kv_write_positions=jnp.asarray(kvp))
    tl, _ = tdec.forward(tcfg, tp, _t(ids), _t(pos), tcache, _t(slots),
                         gather_idx=_t(lens - 1), kv_write_positions=_t(kvp))
    _close_logits(tl, jl, "prefill")
    _same_int8_cache(tcache, jcache)
    cur = lens.copy()
    tok = np.asarray(jl)[:, 0].argmax(-1).astype(np.int32)
    for step in range(20):  # row 0 wraps the 32-slot ring at step 16
        p = cur[:, None]
        tb = 32 if step < 4 else None
        jl, jcache = jfwd(jp, jnp.asarray(tok[:, None]), jnp.asarray(p),
                          jcache, jnp.asarray(p % T), last_only=True,
                          t_bucket=tb)
        tl, _ = tdec.forward(tcfg, tp, _t(tok[:, None]), _t(p), tcache,
                             _t(p % T), t_bucket=tb)
        _close_logits(tl, jl, f"decode step {step}")
        tok = np.asarray(jl)[:, 0].argmax(-1).astype(np.int32)
        cur += 1
    _same_int8_cache(tcache, jcache)


def _paged_caches(jcfg, mesh, B, T, bs, tables):
    n = int(tables[tables < 1000].max()) + 2
    kw = dict(n_layers=jcfg.n_layers, batch=B, max_len=T,
              n_kv_heads=jcfg.n_kv_heads, head_dim=jcfg.head_dim,
              block_size=bs, num_blocks=n, identity_tables=False)
    jcache = jc.init_paged_cache(mesh, dtype=jnp.int8, **kw)._replace(
        block_tables=jnp.asarray(tables))
    tcache = tc.init_paged_cache(dtype=torch.int8, device="cpu", **kw)
    return jcache, tcache._replace(block_tables=_t(tables)), n


def test_forward_paged_int8_matches_jax(model, mesh):
    """Paged pool over scattered tables with sentinel columns: prefill, then
    decode steps with a bucketed read and a done row."""
    jp, tp = model
    jcfg, tcfg = JCfg(**CFG), TCfg(**CFG)
    B, T, bs, S = 2, 48, 8, 16
    tables = np.array([[9, 2, 7, 40, 40, 40], [0, 5, 11, 3, 41, 41]], np.int32)
    jcache, tcache, n = _paged_caches(jcfg, mesh, B, T, bs, tables)
    assert tcache.k_scale.shape == (2, n + 1, bs, 2)
    jfwd = jax.jit(partial(jdec.forward, jcfg),
                   static_argnames=("last_only", "t_bucket"))
    rng = np.random.default_rng(1)
    lens = np.array([16, 11], np.int32)
    ids, pos, slots, kvp = _prefill_inputs(rng, B, S, lens, T)
    jl, jcache = jfwd(jp, jnp.asarray(ids), jnp.asarray(pos), jcache,
                      jnp.asarray(slots), gather_idx=jnp.asarray(lens - 1),
                      kv_write_positions=jnp.asarray(kvp))
    tl, _ = tdec.forward(tcfg, tp, _t(ids), _t(pos), tcache, _t(slots),
                         gather_idx=_t(lens - 1), kv_write_positions=_t(kvp))
    _close_logits(tl, jl, "prefill")
    _same_int8_cache(tcache, jcache, n)
    cur = lens.copy()
    tok = np.asarray(jl)[:, 0].argmax(-1).astype(np.int32)
    for step in range(12):
        p = cur[:, None]
        sl = np.where(np.array([[False], [step >= 8]]), T, p % T).astype(np.int32)
        tb = 32 if step < 8 else None
        jl, jcache = jfwd(jp, jnp.asarray(tok[:, None]), jnp.asarray(p),
                          jcache, jnp.asarray(sl), last_only=True, t_bucket=tb)
        tl, _ = tdec.forward(tcfg, tp, _t(tok[:, None]), _t(p), tcache, _t(sl),
                             t_bucket=tb)
        _close_logits(tl, jl, f"decode step {step}")
        tok = np.asarray(jl)[:, 0].argmax(-1).astype(np.int32)
        cur += 1
    _same_int8_cache(tcache, jcache, n)


def test_forward_ragged_int8_matches_jax(model, mesh):
    """Mixed chunks over an int8 pool: row 0 streams a 10-token prompt in
    CB = 4 slices while row 1 prefills 3 tokens and then decodes."""
    jp, tp = model
    jcfg, tcfg = JCfg(**CFG), TCfg(**CFG)
    B, T, bs, CB = 2, 48, 8, 4
    tables = np.array([[3, 8, 40, 40, 40, 40], [6, 1, 41, 41, 41, 41]], np.int32)
    jcache, tcache, n = _paged_caches(jcfg, mesh, B, T, bs, tables)
    jfwd = jax.jit(partial(jdec.forward_ragged, jcfg))
    rng = np.random.default_rng(2)
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
        _close_logits(tl, jl, f"q_lens {qlens}")
        cur += ql
    _same_int8_cache(tcache, jcache, n)


# -- (e)-(i) engine, batcher, workers, CLI -------------------------------------

PROMPTS = [[5, 9, 23, 40], list(range(3, 20)), [1, 2, 3]]


def _engine(tp, **kw):
    return TEngine(TCfg(**CFG), tp, device="cpu", max_seq_len=64,
                   kv_dtype="int8", **kw)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_generate_int8_matches_jax(model, mesh, layout):
    """Greedy tokens of the port's int8 ``generate`` are the JAX int8
    engine's, on both layouts."""
    jp, tp = model
    kw = dict(kv_layout="paged", block_size=8) if layout == "paged" else {}
    got = _engine(tp, **kw).generate(PROMPTS, TGen(max_new_tokens=12))
    jeng = JEngine(JCfg(**CFG), jp, mesh, max_seq_len=64, kv_dtype="int8",
                   **kw)
    assert got == jeng.generate(PROMPTS, JGen(max_new_tokens=12))


def test_int8_paths_agree(model):
    """``generate`` = ``generate_fused`` = chunked, dense int8 = paged int8,
    and the batcher over the int8 pool (split and chunked admission) gives
    each request its solo ``generate`` tokens, its blocks all returned."""
    _, tp = model
    gen = TGen(max_new_tokens=9)
    dense = _engine(tp)
    want = dense.generate(PROMPTS, gen)
    assert dense._cache.k.dtype == torch.int8 and dense._cache.quantized
    assert dense.generate_fused(PROMPTS, gen) == want
    assert dense.generate(PROMPTS, gen, chunk_steps=4) == want
    paged = _engine(tp, kv_layout="paged", block_size=8)
    assert paged.generate(PROMPTS, gen) == want
    assert paged._cache.k.dtype == torch.int8
    solo = [dense.generate([p], gen)[0] for p in PROMPTS]
    for eng, chunked in ((dense, None), (_engine(tp, kv_layout="paged",
                                                 block_size=8, kv_blocks=12), None),
                         (_engine(tp, kv_layout="paged", block_size=8,
                                  kv_blocks=12), 4)):
        bat = ContinuousBatcher(eng, rows=2, chunk_steps=2,
                                chunked_prefill=chunked)
        assert bat.cache.quantized
        out = {}
        for i, p in enumerate(PROMPTS):
            bat.submit(p, gen, lambda t, *a, i=i, **k: out.__setitem__(i, t))
        bat.run_until_idle()
        assert [out[i] for i in range(len(PROMPTS))] == solo
        if eng.kv_layout == "paged":
            assert bat.allocator.blocks_in_use == 0


@pytest.mark.parametrize("chunked", [None, 4])
def test_int8_continuous_worker_after_prewarm(model, chunked):
    """A prewarmed ``ContinuousWorker`` on an int8 paged engine serves a
    streamed and a plain request with their solo ``generate`` tokens, and
    captures nothing after its prewarm (``test_int8_serving_end_to_end``)."""
    _, tp = model
    eng = _engine(tp, kv_layout="paged", block_size=8, kv_blocks=16)
    broker = InProcBroker()
    worker = ContinuousWorker(eng, broker, rows=2, chunk_steps=2,
                              chunked_prefill=chunked)
    assert worker.prewarm() > 0
    keys = eng._graphs.keys()
    broker.push_request(GenerateRequest(id="a", token_ids=[5, 9, 23],
                                        max_new_tokens=6))
    broker.push_request(GenerateRequest(id="b", token_ids=[3, 14],
                                        max_new_tokens=6, stream=True))
    got, streamed = {}, []
    for _ in range(200):
        if len(got) == 2:
            break
        worker.run_once()
        while (inc := broker.pop_stream("b")) is not None:
            streamed += inc
        for rid in ("a", "b"):
            if rid not in got:
                r = broker.wait_response(rid, timeout=0.0)
                if r is not None:
                    got[rid] = r
    assert set(got) == {"a", "b"} and got["a"].error is None
    assert streamed == got["b"].token_ids
    assert eng._graphs.keys() == keys
    solo = _engine(tp).generate([[5, 9, 23], [3, 14]], TGen(max_new_tokens=6))
    assert [got["a"].token_ids, got["b"].token_ids] == solo


def test_int8_batch_worker_after_prewarm(model):
    """The batch ``Worker`` on a dense int8 engine, prewarmed, answers two
    requests with their solo ``generate`` tokens and captures nothing after
    its prewarm."""
    _, tp = model
    eng = _engine(tp)
    broker = InProcBroker()
    worker = Worker(eng, broker, batch_size=2, chunk_steps=2)
    assert worker.prewarm() > 0
    keys = eng._graphs.keys()
    reqs = [GenerateRequest(token_ids=p, max_new_tokens=5) for p in PROMPTS[:2]]
    for r in reqs:
        broker.push_request(r)
    assert worker.run_once() == 2
    got = [broker.wait_response(r.id, timeout=5).token_ids for r in reqs]
    assert eng._graphs.keys() == keys
    gen = TGen(max_new_tokens=5)
    assert got == [_engine(tp).generate([p], gen)[0] for p in PROMPTS[:2]]


def test_cli_int8_matches_jax_int8_engine(tmp_path, mesh):
    """``--kv_dtype int8`` reaches the port's int8 engine on a local
    random-init checkpoint: the CLI's greedy tokens are the JAX int8
    engine's on the same checkpoint."""
    import json

    g = torch.Generator().manual_seed(0)
    E, I, V, Lc, H, Hkv = 64, 96, 128, 2, 4, 2
    KV = E // H * Hkv

    def w(*s):
        return torch.randn(s, generator=g) * 0.05

    t = {"model.embed_tokens.weight": w(V, E), "model.norm.weight": 1 + w(E),
         "lm_head.weight": w(V, E)}
    for i in range(Lc):
        p = f"model.layers.{i}"
        t.update({
            f"{p}.input_layernorm.weight": 1 + w(E),
            f"{p}.post_attention_layernorm.weight": 1 + w(E),
            f"{p}.self_attn.q_proj.weight": w(E, E),
            f"{p}.self_attn.k_proj.weight": w(KV, E),
            f"{p}.self_attn.v_proj.weight": w(KV, E),
            f"{p}.self_attn.o_proj.weight": w(E, E),
            f"{p}.mlp.gate_proj.weight": w(I, E),
            f"{p}.mlp.up_proj.weight": w(I, E),
            f"{p}.mlp.down_proj.weight": w(E, I),
        })
    save_file(t, str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps({
        "model_type": "llama", "architectures": ["LlamaForCausalLM"],
        "vocab_size": V, "hidden_size": E, "num_hidden_layers": Lc,
        "num_attention_heads": H, "num_key_value_heads": Hkv,
        "intermediate_size": I, "max_position_embeddings": 64,
        "hidden_act": "silu", "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
        "tie_word_embeddings": False, "torch_dtype": "float32"}))
    out = cli_main(["--pretrained_model_path", str(tmp_path), "--device",
                    "cpu", "--dtype", "float32", "--token_ids", "1,2,3,4,5",
                    "9,8", "--max_new_tokens", "6", "--is_greedy",
                    "--kv_dtype", "int8"])
    jcfg, jparams = jax_load_model(tmp_path, mesh, dtype="float32")
    jeng = JEngine(jcfg, jparams, mesh, max_seq_len=11, kv_dtype="int8")
    assert out == jeng.generate([[1, 2, 3, 4, 5], [9, 8]],
                                JGen(max_new_tokens=6))


def test_int8_logits_close_to_compute_dtype_cache(model):
    """Decoding on the int8 cache tracks the fp32 cache within 5% of the
    largest |logit| (``tests/test_int8_cache.py``)."""
    _, tp = model
    logits = {}
    for kv in (None, "int8"):
        eng = TEngine(TCfg(**CFG), tp, device="cpu", max_seq_len=64,
                      kv_dtype=kv)
        ids, lens = eng._pad_prompts(PROMPTS[:2])
        sa = eng._sample_args(TGen(), 2)
        cache = eng.new_cache(2)
        tok, lg = eng._prefill(torch.as_tensor(ids), cache,
                               torch.as_tensor(lens), sa)
        cur = torch.as_tensor(lens)
        for _ in range(4):
            tok, lg = eng._decode(tok, cache, cur, sa)
            tok, lg = tok.clone(), lg.clone()
            cur = cur + 1
        logits[kv] = lg.numpy()
    scale = np.abs(logits[None]).max()
    assert np.abs(logits["int8"] - logits[None]).max() < 0.05 * scale


def test_int8_cache_keys_and_frees_its_graphs_and_bf16_skips_none(model):
    """An int8 cache's graph key holds its scales' addresses and its graphs
    go with its tensors; a cache of the compute dtype (None scales) keys on
    k, v and positions alone."""
    _, tp = model
    for kv, n_tensors in ((None, 3), ("int8", 5)):
        eng = TEngine(TCfg(**CFG), tp, device="cpu", max_seq_len=64,
                      kv_dtype=kv)
        cache = eng.new_cache(2)
        assert len(graphs.cache_tensors(cache)) == n_tensors
        key = graphs.cache_key(cache)
        assert len(key) == 1 + n_tensors
        if kv:
            assert (cache.k_scale.data_ptr(),
                    tuple(cache.k_scale.shape)) in key
        eng._graphs.for_cache(cache)
        assert len(eng._graphs) == 1
        del cache
        assert len(eng._graphs) == 0


def test_engine_kv_dtype_validation_and_reset(model):
    """Only None and "int8"; the persistent cache's reset zeroes the
    scales."""
    _, tp = model
    with pytest.raises(ValueError, match="kv_dtype"):
        TEngine(TCfg(**CFG), tp, device="cpu", kv_dtype="fp8")
    eng = _engine(tp)
    eng.generate(PROMPTS[:1], TGen(max_new_tokens=3))
    assert eng._cache.k_scale.abs().sum() > 0
    cache = eng._generate_cache(1)
    for t in (cache.k, cache.v, cache.k_scale, cache.v_scale):
        assert not t.any()
    assert (cache.positions == -1).all()


# -- the kernels' plans and envelope (CPU-checkable) -----------------------------


@pytest.mark.parametrize("CB", [1, 16, 128])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("D", pa.HEAD_DIMS)
def test_int8_plan_takes_the_lane_template(CB, G, D):
    """Which int8 launches take the lane template. bf16 queries over an
    int8 pool at CB > 1 take ``mma_int8`` (the chunk tile over int8 tiles,
    P x v_scale as two bf16 terms), split as a bf16 pool's chunk is, with
    the shared memory of ``chunk::Smem<int8_t, D>`` under the limit. CB == 1 (K3, all-decode K4) and fp32
    queries at every CB take ``lanes_int8``, with the split of a pool of
    the query's dtype and the int8 ring's shared memory; K2 the same over
    an int8 ring."""
    from llmss_tpu_torch.ops import _build
    from llmss_tpu_torch.ops import decode_attention as da
    from llmss_tpu_torch.ops import split_plan as sp

    kw = dict(B=8, Hkv=4, n_slots=832, bs=16)
    p8 = pa.kernel_plan(torch.bfloat16, CB, G, D, kv_dtype=torch.int8, **kw)
    f8 = pa.kernel_plan(torch.float32, CB, G, D, kv_dtype=torch.int8, **kw)
    p32 = pa.kernel_plan(torch.float32, CB, G, D, **kw)
    ring = (sp.lane_region_bytes(1, pa._rows_per_block(CB * G), D)
            - sp.lane_region_bytes(4, pa._rows_per_block(CB * G), D))
    lanes = [f8] if CB > 1 else [p8, f8]
    for p in lanes:
        assert p.impl == "lanes_int8"
        assert (p.splits, p.split_slots) == (p32.splits, p32.split_slots)
        assert p.smem - p32.smem == ring
    if CB > 1:
        p16 = pa.kernel_plan(torch.bfloat16, CB, G, D, **kw)
        if D > 128:  # the 64-row tile over int8 tiles, unsplit
            assert p8 == ("mma_int8", _build.tile_i8_smem_bytes(D), 1, 0)
        else:
            assert p8 == ("mma_int8", _build.chunk_smem_bytes(D, True),
                          p16.splits, p16.split_slots)
        assert p8.smem <= _build.SMEM_LIMIT
    d8 = da.kernel_plan(torch.bfloat16, 4, 4 * G, 4, D, 192, kv_dtype=torch.int8)
    # The 16-bit lanes (a bf16 cache takes the group tile from G_TILE).
    d16 = da.kernel_plan(torch.bfloat16, 4, 4 * G, 4, D, 192, force="lanes")
    assert d8.impl == "lanes_int8" and d16.impl == "lanes"
    assert (d8.splits, d8.split_slots) == (d16.splits, d16.split_slots)


def test_int8_scale_operands_are_checked():
    """``_build.scale_args``: an int8 cache needs fp32 CUDA scales of its
    leading shape and fp32 / bf16 queries; a cache of the query's dtype
    takes no scales. Everything else raises KernelError before a launch."""
    from llmss_tpu_torch.ops import _build

    q = torch.zeros(2, 1, 4, 16, dtype=torch.bfloat16)
    k8 = torch.zeros(2, 2, 8, 2, 16, dtype=torch.int8)
    s = torch.zeros(2, 2, 8, 2)
    assert _build.scale_args("K", q, q.new_zeros(2, 2, 8, 2, 16), None,
                             None) == (None, None)
    for args in ((q, k8, None, None),  # int8 without scales
                 (q, k8, s, s),  # scales on the CPU
                 (q.half(), k8, s, s),  # fp16 queries over int8
                 (q, q.new_zeros(2, 2, 8, 2, 16), s, s)):  # scales, no int8
        with pytest.raises(_build.KernelError):
            _build.scale_args("K", *args)
