"""The torch port's ops against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and fed to both packages. The Pallas
kernels run in interpret mode, as the JAX package's own tests run them.
Tolerances: fp32 everywhere; the plain versions compute in fp32 like the
XLA oracles, so they agree to accumulation-order rounding (1e-5); the
Pallas kernels add their blockwise online softmax (2e-5, as in
tests/test_pallas_decode.py)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmss_tpu.ops import layers as jl
from llmss_tpu.ops import rope as jrope
from llmss_tpu.ops.pallas_attention import flash_attention as pallas_flash
from llmss_tpu.ops.pallas_decode import decode_attention as pallas_decode
from llmss_tpu_torch.ops import attention as tatt
from llmss_tpu_torch.ops import layers as tl
from llmss_tpu_torch.ops import rope as trope
from llmss_tpu_torch.ops.decode_attention import decode_attention_ref
from llmss_tpu_torch.ops.flash_attention import flash_attention_ref

# llmss_tpu.ops rebinds its ``attention`` attribute to the function.
jatt = importlib.import_module("llmss_tpu.ops.attention")
TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("bias", [True, False])
def test_dense_layers_match(bias):
    rng = np.random.default_rng(0)
    x, w, wt = _rand(rng, 2, 3, 8), _rand(rng, 8, 6), _rand(rng, 6, 8)
    b = _rand(rng, 6) if bias else None
    T = lambda a: None if a is None else torch.tensor(a)  # noqa: E731
    J = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    np.testing.assert_allclose(
        _np(tl.dense(T(x), tl.LinearParams(T(w), T(b)))),
        _np(jl.dense(J(x), jl.LinearParams(J(w), J(b)))), **TOL)
    np.testing.assert_allclose(
        _np(tl.dense_t(T(x), tl.LinearParams(T(wt), T(b)))),
        _np(jl.dense_t(J(x), jl.LinearParams(J(wt), J(b)))), **TOL)
    np.testing.assert_allclose(
        _np(tl.lm_head(T(x), tl.LinearParams(T(w), T(b)))),
        _np(jl.lm_head(J(x), jl.LinearParams(J(w), J(b)))), **TOL)


def test_norms_and_embedding_match():
    rng = np.random.default_rng(1)
    x, s, b = _rand(rng, 2, 5, 16), _rand(rng, 16), _rand(rng, 16)
    np.testing.assert_allclose(
        _np(tl.layer_norm(torch.tensor(x), tl.NormParams(torch.tensor(s), torch.tensor(b)), 1e-5)),
        _np(jl.layer_norm(jnp.asarray(x), jl.NormParams(jnp.asarray(s), jnp.asarray(b)), 1e-5)),
        **TOL)
    for off in (0.0, 1.0):
        np.testing.assert_allclose(
            _np(tl.rms_norm(torch.tensor(x), tl.NormParams(torch.tensor(s), None), 1e-6, off)),
            _np(jl.rms_norm(jnp.asarray(x), jl.NormParams(jnp.asarray(s), None), 1e-6, off)),
            **TOL)
    table = _rand(rng, 10, 4)
    ids = rng.integers(0, 10, (2, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        _np(tl.embedding(torch.tensor(ids).long(), torch.tensor(table))),
        _np(jl.embedding(jnp.asarray(ids), jnp.asarray(table))))


@pytest.mark.parametrize("style,rotary_dim,factors,attn_factor", [
    ("half", None, None, 1.0),
    ("half", 8, None, 1.0),  # partial rotary
    ("interleaved", None, None, 1.0),
    ("interleaved", 6, None, 1.0),  # GPT-J-style partial rotary
    ("half", 8, (1.0, 2.0, 4.0, 8.0), 1.2),  # LongRoPE factors
])
def test_rope_matches(style, rotary_dim, factors, attn_factor):
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, 5, 3, 16)
    pos = rng.integers(0, 500, (2, 5)).astype(np.int32)
    want = jrope.apply_rope(
        jnp.asarray(x), jnp.asarray(pos), rotary_dim=rotary_dim, style=style,
        freq_factors=factors, attn_factor=attn_factor)
    got = trope.apply_rope(
        torch.tensor(x), torch.tensor(pos), rotary_dim=rotary_dim,
        style=style, freq_factors=factors, attn_factor=attn_factor)
    # sin/cos of angles up to ~500 rad: fp32 range reduction differs by ulps.
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


def _ring(B, T, hist):
    kvp = np.full((B, T), -1, np.int32)
    for b, n in enumerate(hist):
        for p in range(n):
            kvp[b, p % T] = p
    return kvp


@pytest.mark.parametrize("Hq,Hkv,window", [(4, 4, None), (4, 2, 6), (4, 1, None)])
def test_plain_attention_matches_xla(Hq, Hkv, window):
    rng = np.random.default_rng(3)
    B, S, T, D = 2, 8, 24, 16
    q, k, v = _rand(rng, B, S, Hq, D), _rand(rng, B, T, Hkv, D), _rand(rng, B, T, Hkv, D)
    kvp = _ring(B, T, [30, 12])
    qp = np.stack([np.arange(22, 30), np.arange(4, 12)]).astype(np.int32)
    jm = jatt.make_causal_mask(jnp.asarray(qp), jnp.asarray(kvp), jnp.asarray(kvp >= 0), window)
    tm = tatt.make_causal_mask(torch.tensor(qp), torch.tensor(kvp), torch.tensor(kvp >= 0), window)
    np.testing.assert_array_equal(_np(tm), _np(jm))
    want = jatt.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm)
    got = tatt.attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), tm)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("Hq,Hkv,hist,window", [
    (4, 4, [10, 0], None),  # live row + empty row (out == v_new)
    (4, 2, [40, 33], None),  # ring wrap: pending slot holds a live token
    (4, 1, [20, 31], 5),  # MQA + sliding window
])
def test_fresh_kv_decode_matches_xla(Hq, Hkv, hist, window):
    rng = np.random.default_rng(4)
    B, T, D = 2, 32, 16
    q = _rand(rng, B, 1, Hq, D)
    kc, vc = _rand(rng, B, T, Hkv, D), _rand(rng, B, T, Hkv, D)
    kn, vn = _rand(rng, B, 1, Hkv, D), _rand(rng, B, 1, Hkv, D)
    kvp = _ring(B, T, hist)
    qpos = np.asarray(hist, np.int32)[:, None]
    slots = qpos % T
    args = (q, kc, vc, kn, vn, qpos, kvp, slots)
    want = jatt.fresh_kv_decode_attention(*map(jnp.asarray, args), window=window)
    got = tatt.fresh_kv_decode_attention(*map(torch.tensor, args), window=window)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    if hist[1] == 0:
        np.testing.assert_allclose(
            _np(got)[1, 0], np.repeat(vn[1, 0], Hq // Hkv, axis=0), **TOL)


@pytest.mark.parametrize("name,B,S,T,Hq,Hkv,window", [
    ("padded_mha", 2, 16, 32, 4, 4, None),
    ("wrapped_gqa", 2, 16, 32, 4, 2, None),
    ("window_mqa", 2, 16, 32, 4, 1, 9),
])
def test_flash_ref_matches_pallas_interpret(name, B, S, T, Hq, Hkv, window):
    rng = np.random.default_rng(5)
    D = 32
    q, k, v = _rand(rng, B, S, Hq, D), _rand(rng, B, T, Hkv, D), _rand(rng, B, T, Hkv, D)
    if name == "padded_mha":
        # Prefill from 0: row 1's prompt is 11 long, its padding is -1.
        qp = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
        kvp = _ring(B, T, [S, S])
        kvp[1, 11:S] = -1
    else:
        # Second chunk of a long prompt after the ring wrapped.
        qp = np.broadcast_to(np.arange(40, 40 + S, dtype=np.int32), (B, S)).copy()
        kvp = _ring(B, T, [40 + S, 40 + S])
    want = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(qp), jnp.asarray(kvp), window=window,
                        interpret=True)
    got = flash_attention_ref(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                              torch.tensor(qp), torch.tensor(kvp), window=window)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


def _decode_inputs(rng, B, T, Hq, Hkv, D, hist, L=3):
    q = _rand(rng, B, 1, Hq, D)
    kc, vc = _rand(rng, L, B, T, Hkv, D), _rand(rng, L, B, T, Hkv, D)
    kn, vn = _rand(rng, B, 1, Hkv, D), _rand(rng, B, 1, Hkv, D)
    kvp = _ring(B, T, hist)
    qpos = np.asarray(hist, np.int32)[:, None]
    return q, kc, vc, kn, vn, qpos, kvp, qpos % T


@pytest.mark.parametrize("layer,hist,Hkv", [
    (0, [20, 0], 4),  # empty cache row
    (1, [40, 17], 2),  # ring wrap, GQA
    (2, [31, 5], 1),  # MQA
])
def test_decode_ref_matches_pallas_interpret(layer, hist, Hkv):
    rng = np.random.default_rng(6)
    args = _decode_inputs(rng, 2, 32, 4, Hkv, 128, hist)
    want = pallas_decode(*map(jnp.asarray, args), jnp.int32(layer), interpret=True)
    got = decode_attention_ref(*map(torch.tensor, args), layer)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


def test_decode_ref_t_len_matches_xla_bucket():
    """t_len reads ring slots [0, t_len): the XLA decode path's bucketed
    read of the same layer (no row has wrapped, all live slots < t_len)."""
    rng = np.random.default_rng(7)
    T, t_len, layer = 64, 32, 1
    q, kc, vc, kn, vn, qpos, kvp, slots = _decode_inputs(rng, 2, T, 4, 2, 16, [20, 31])
    want = jatt.fresh_kv_decode_attention(
        *map(jnp.asarray, (q, kc[layer, :, :t_len], vc[layer, :, :t_len], kn,
                           vn, qpos, kvp[:, :t_len], slots)))
    got = decode_attention_ref(
        *map(torch.tensor, (q, kc, vc, kn, vn, qpos, kvp, slots)), layer,
        t_len=t_len)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    full = decode_attention_ref(
        *map(torch.tensor, (q, kc, vc, kn, vn, qpos, kvp, slots)), layer)
    np.testing.assert_allclose(_np(full), _np(got), **TOL)


def test_dispatch_takes_plain_versions_for_cpu_tensors():
    rng = np.random.default_rng(8)
    args = [torch.tensor(a) for a in _decode_inputs(rng, 2, 32, 4, 2, 64, [9, 3])]
    np.testing.assert_array_equal(
        _np(tatt.decode_attention(*args, 1, t_len=16)),
        _np(decode_attention_ref(*args, 1, t_len=16)))
    B, S, T = 2, 16, 32
    q = torch.tensor(_rand(rng, B, S, 4, 64))
    k, v = torch.tensor(_rand(rng, B, T, 2, 64)), torch.tensor(_rand(rng, B, T, 2, 64))
    qp = torch.arange(S, dtype=torch.int32).expand(B, S)
    kvp = torch.tensor(_ring(B, T, [S, S]))
    np.testing.assert_array_equal(
        _np(tatt.prefill_attention(q, k, v, qp, kvp, window=4)),
        _np(flash_attention_ref(q, k, v, qp, kvp, window=4)))
