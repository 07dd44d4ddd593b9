"""Sequence parallelism: the port's ring functions (ops/ring_attention.py,
their plain versions, on a world of four gloo ranks) against the JAX
package's under ``shard_map`` on the conftest's virtual devices, on the
same seeded numpy inputs: ring prefill (right-padded rows, a ring that
has wrapped, a row that sees nothing anywhere, a sliding window), the
LSE-merge attention (decode and an odd-length replicated prefill) and
the fresh-KV LSE merge of the deferred-write decode (a wrapped row whose
pending slot must be excluded, a window). fp32 throughout, held to
1e-5 relative and 1e-6 absolute: only the order of the fp32 sums
differs. Single-process checks: the state merge of the kernels' path
equals the online recursion, and the state-out kernels' plain versions
equal the JAX ``_online_block``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from llmss_tpu.ops import ring_attention as jring
from llmss_tpu.parallel import MeshPlan as JPlan
from llmss_tpu.parallel import make_mesh as jmake_mesh
from llmss_tpu.parallel.mesh import AXIS_DP, AXIS_SP, AXIS_TP
from llmss_tpu.parallel.mesh import shard_map as jshard_map
from llmss_tpu_torch.ops import decode_attention as tda
from llmss_tpu_torch.ops import flash_attention as tfa
from llmss_tpu_torch.ops import ring_attention as tring
from llmss_tpu_torch.parallel.launch import file_init, spawn

import torch_mesh_jobs

RTOL, ATOL = 1e-5, 1e-6
B, Hq, Hkv, D, T = 2, 8, 4, 16, 32


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _cases():
    """name -> (port case for the ranks, JAX reference function)."""
    rng = np.random.default_rng(0)
    qs_ring = P(AXIS_DP, AXIS_SP, AXIS_TP, None)
    ks = P(AXIS_DP, AXIS_SP, AXIS_TP, None)
    qs_rep = P(AXIS_DP, None, AXIS_TP, None)
    cases = {}

    def ring_case(name, q_pos, kv_pos, window=None):
        q, k, v = (_rand(rng, B, T, Hq, D), _rand(rng, B, T, Hkv, D),
                   _rand(rng, B, T, Hkv, D))
        kw = {} if window is None else {"window": window}
        port = {"fn": "ring_attention", "seq": {"q", "k", "v", "qp", "kvp"},
                "args": [("q", q), ("k", k), ("v", v), ("qp", q_pos),
                         ("kvp", kv_pos)], "kw": kw}

        def ref(mesh):
            return jshard_map(
                lambda q, k, v, qp, kvp: jring.ring_attention(
                    q, k, v, qp, kvp, axis_name=AXIS_SP, **kw),
                mesh=mesh, in_specs=(qs_ring, ks, ks, P(AXIS_DP, AXIS_SP),
                                     P(AXIS_DP, AXIS_SP)),
                out_specs=qs_ring, check_vma=False,
            )(q, k, v, q_pos, kv_pos)
        cases[name] = (port, ref)

    # Right-padded prefill: row 0 has 20 tokens, row 1 all 32.
    kv_pos = np.full((B, T), -1, np.int32)
    kv_pos[0, :20] = np.arange(20)
    kv_pos[1] = np.arange(T)
    q_pos = np.broadcast_to(np.arange(T), (B, T)).astype(np.int32)
    ring_case("ring_padded", q_pos, kv_pos)
    ring_case("ring_window", q_pos, kv_pos, window=7)
    # A ring that has wrapped: positions 40..71 at slot pos % 32, queried
    # in position order; row 1's cache is empty, so its queries see
    # nothing anywhere (the uniform average).
    wrapped = np.full((B, T), -1, np.int32)
    for p in range(40, 72):
        wrapped[0, p % T] = p
    ring_case("ring_wrapped_empty_row",
              np.broadcast_to(np.arange(40, 72), (B, T)).astype(np.int32),
              wrapped)

    def lse_case(name, S, q_pos, kv_pos):
        q, k, v = (_rand(rng, B, S, Hq, D), _rand(rng, B, T, Hkv, D),
                   _rand(rng, B, T, Hkv, D))
        port = {"fn": "lse_merge_attention", "seq": {"k", "v", "kvp"},
                "args": [("q", q), ("k", k), ("v", v), ("qp", q_pos),
                         ("kvp", kv_pos)]}

        def ref(mesh):
            return jshard_map(
                lambda q, k, v, qp, kvp: jring.lse_merge_attention(
                    q, k, v, qp, kvp, axis_name=AXIS_SP),
                mesh=mesh, in_specs=(qs_rep, ks, ks, P(AXIS_DP, None),
                                     P(AXIS_DP, AXIS_SP)),
                out_specs=qs_rep, check_vma=False,
            )(q, k, v, q_pos, kv_pos)
        cases[name] = (port, ref)

    mid = np.full((B, T), -1, np.int32)
    mid[0, :17] = np.arange(17)
    mid[1, :29] = np.arange(29)
    lse_case("lse_decode", 1, np.asarray([[16], [28]], np.int32), mid)
    lse_case("lse_odd_prefill", 3,
             np.asarray([[14, 15, 16], [26, 27, 28]], np.int32), mid)

    def fresh_case(name, window=None):
        q = _rand(rng, B, 1, Hq, D)
        k, v = _rand(rng, B, T, Hkv, D), _rand(rng, B, T, Hkv, D)
        kn, vn = _rand(rng, B, 1, Hkv, D), _rand(rng, B, 1, Hkv, D)
        # Row 0 mid-fill; row 1 wrapped past T: slot 45 % 32 = 13 is
        # overwritten by the token and must be excluded from the stale read.
        kvp = np.full((B, T), -1, np.int32)
        kvp[0, :21] = np.arange(21)
        for p in range(45):
            kvp[1, p % T] = p
        qp = np.asarray([[21], [45]], np.int32)
        sl = np.asarray([[21], [45 % T]], np.int32)
        kw = {} if window is None else {"window": window}
        port = {"fn": "lse_merge_fresh_kv_attention",
                "seq": {"k", "v", "kvp"}, "kw": kw,
                "args": [("q", q), ("k", k), ("v", v), ("qp", qp),
                         ("kvp", kvp), ("kn", kn), ("vn", vn), ("sl", sl)]}

        def ref(mesh):
            kns = P(AXIS_DP, None, AXIS_TP, None)
            ps = P(AXIS_DP, None)
            return jshard_map(
                lambda q, k, v, qp, kvp, kn, vn, sl: (
                    jring.lse_merge_fresh_kv_attention(
                        q, k, v, qp, kvp, kn, vn, sl, axis_name=AXIS_SP,
                        **kw)),
                mesh=mesh, in_specs=(qs_rep, ks, ks, ps, P(AXIS_DP, AXIS_SP),
                                     kns, kns, ps),
                out_specs=qs_rep, check_vma=False,
            )(q, k, v, qp, kvp, kn, vn, sl)
        cases[name] = (port, ref)

    fresh_case("fresh_kv_wrapped")
    fresh_case("fresh_kv_window", window=9)
    return cases


CASES = _cases()


@pytest.fixture(scope="module")
def port_out(tmp_path_factory):
    """Every case on a world of four sp ranks (spawned once), each rank's
    output concatenated (ring prefill: its query chunk)."""
    names = list(CASES)
    init = file_init(tmp_path_factory.mktemp("ring") / "rdv")
    res = spawn(torch_mesh_jobs.ring_cases, 4, [CASES[n][0] for n in names],
                init_method=init)
    out = {}
    for i, n in enumerate(names):
        parts = [r[i] for r in res]
        if CASES[n][0]["fn"] == "ring_attention":
            out[n] = np.concatenate(parts, 1)
        else:
            for p in parts[1:]:  # replicated: every rank the same
                np.testing.assert_array_equal(p, parts[0])
            out[n] = parts[0]
    return out


@pytest.fixture(scope="module")
def jax_mesh(devices):
    return jmake_mesh(JPlan(dp=1, sp=4, tp=2))


@pytest.mark.parametrize("name", list(CASES))
def test_ring_function_matches_jax(name, port_out, jax_mesh):
    want = np.asarray(jax.jit(lambda: CASES[name][1](jax_mesh))())
    np.testing.assert_allclose(port_out[name], want, rtol=RTOL, atol=ATOL)


def test_empty_row_is_the_uniform_average(port_out):
    """A row that sees no slot anywhere averages every slot's value (the
    ``l == 0`` guard is never reached: finite-min masking weighs all)."""
    v = dict(CASES["ring_wrapped_empty_row"][0]["args"])["v"]
    avg = v[1].reshape(T, Hkv, 1, D).mean(0)  # [Hkv, 1, D]
    want = np.broadcast_to(avg, (Hkv, Hq // Hkv, D)).reshape(Hq, D)
    got = port_out["ring_wrapped_empty_row"][1]
    np.testing.assert_allclose(got, np.broadcast_to(want, got.shape),
                               rtol=RTOL, atol=ATOL)


def test_state_merge_equals_online_recursion():
    """The kernels' path (each chunk's state, then ``merge_states``) gives
    the plain recursion's output over the same chunks, masked chunks and
    an empty row included."""
    args = dict(CASES["ring_wrapped_empty_row"][0]["args"])
    q, k, v = (torch.from_numpy(args[n]) for n in ("q", "k", "v"))
    qp, kvp = torch.from_numpy(args["qp"]), torch.from_numpy(args["kvp"])
    scale = 1.0 / D ** 0.5
    online = merged = tring._init_state(q, Hkv)
    for c in range(4):
        sl = slice(8 * c, 8 * (c + 1))
        online = tring._online_block(*online, q, k[:, sl], v[:, sl], qp,
                                     kvp[:, sl], scale)
        merged = tring.merge_states(merged, tring.chunk_state(
            q, k[:, sl], v[:, sl], qp, kvp[:, sl]))
    torch.testing.assert_close(tring._finish(*merged, q),
                               tring._finish(*online, q),
                               rtol=RTOL, atol=ATOL)


def test_state_out_plain_versions_equal_jax_online_block():
    """K1's and K2's state-out plain versions are the reference's
    ``_online_block`` from its initial state (K2's: the pending slot
    excluded, no fresh token)."""
    args = dict(CASES["fresh_kv_wrapped"][0]["args"])
    q, k, v, qp, kvp, sl = (args[n] for n in ("q", "k", "v", "qp", "kvp",
                                              "sl"))
    scale = 1.0 / D ** 0.5
    jm, jl, jacc = jring._online_block(
        *jring._init_state(jnp.asarray(q), Hkv), jnp.asarray(q),
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(qp), jnp.asarray(kvp),
        scale, exclude=jnp.asarray(np.arange(T)[None] == sl))
    tm, tl, tacc = tda.decode_attention_state_ref(
        *(torch.from_numpy(x) for x in (q, k[None], v[None], qp, kvp, sl)), 0)
    for a, b in ((tm, jm), (tl, jl), (tacc, jacc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    args = dict(CASES["ring_padded"][0]["args"])
    q, k, v, qp, kvp = (args[n] for n in ("q", "k", "v", "qp", "kvp"))
    jm, jl, jacc = jring._online_block(
        *jring._init_state(jnp.asarray(q), Hkv), *(jnp.asarray(x) for x in (
            q, k, v, qp, kvp)), scale)
    tm, tl, tacc = tfa.flash_attention_state_ref(
        *(torch.from_numpy(np.ascontiguousarray(x))
          for x in (q, k, v, qp, kvp)))
    for a, b in ((tm, jm), (tl, jl), (tacc, jacc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=1e-5)


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention"])
def test_state_entry_argtypes_match_the_c_signature(name):
    """The ctypes declaration of K1's and K2's state-out entry points has
    their C signatures' parameters, in order and kind."""
    import ctypes
    import re
    from types import SimpleNamespace

    from llmss_tpu_torch.ops import _build

    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
             "float": ctypes.c_float}
    src = (_build.CSRC / f"{name}.cu").read_text()
    sig = re.search(rf'extern "C" int llmss_{name}_state\((.*?)\)', src,
                    re.S).group(1)
    fn = SimpleNamespace()
    lib = SimpleNamespace(**{f"llmss_{name}": SimpleNamespace(),
                             f"llmss_{name}_state": fn})
    _build._declare(lib, name)
    assert fn.argtypes == [kinds[p.split()[0]] for p in sig.split(",")]
    assert fn.restype is ctypes.c_int
