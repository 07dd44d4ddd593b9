"""The KV handoff between the prefill and decode roles in the torch port,
on the CPU, against the JAX package: the wire format (``encode_blocks`` /
``decode_blocks``, ``HandoffRecord``, ``pick_decode_worker``), the cache's
``export_blocks`` / ``export_dense_row`` / ``import_blocks``, the
batcher's ``prefill_only`` export and ``adopt``, the brokers' handoff
channel, and ``ContinuousWorker(role="prefill" | "decode")``.

The reference's ``tests/test_handoff.py`` is mirrored case by case (its
routed-queue, failover and chaos-harness cases belong to the fleet slice).
What is compared with the JAX package:

- payloads: byte for byte, CRC included, for fp32, bf16 and int8 with
  scales; each package decodes the other's;
- exports and imports: the same arrays for the same pool contents;
- brokers: the same scripted operations observe the same results, and a
  record crosses between a reference and a port ``RedisBroker`` on one
  ``FakeRedis`` in both directions;
- tokens: a prefill worker and a decode worker give the unified worker's
  tokens, and the JAX package's; blocks in use and refcounts after every
  step of a prefill-only batcher equal the JAX one's.

The reference's decode role reads the group in flight at an adoption for
the adopted row, and so gives an adopted row its previous occupant's
tokens when rows turn over; the port skips that group for the row
(``test_adopt_into_a_row_freed_under_a_group_in_flight``), and the cases
held to the JAX fleet keep to loads where no row turns over.

Tiny fp32 llama, parameters from the JAX ``init_params`` through
``convert.params_from_jax``."""

import dataclasses
import time

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import llmss_tpu.serve.broker as rbroker
import llmss_tpu.serve.handoff as rhandoff
import llmss_tpu.serve.protocol as rproto
import llmss_tpu_torch.serve.broker as tbroker
import llmss_tpu_torch.serve.handoff as thandoff
import llmss_tpu_torch.serve.protocol as tproto
from llmss_tpu.engine import DecodeEngine as JEngine
from llmss_tpu.engine import GenerationParams as JGen
from llmss_tpu.engine import cache as jcache
from llmss_tpu.engine.scheduler import ContinuousBatcher as JBatcher
from llmss_tpu.models import decoder as jdec
from llmss_tpu.models.common import DecoderConfig as JCfg
from llmss_tpu.parallel import MeshPlan, make_mesh
from llmss_tpu.serve.chaos import FakeRedis
from llmss_tpu.serve.consumer import ContinuousWorker as JWorker
from llmss_tpu_torch.convert import params_from_jax
from llmss_tpu_torch.engine import cache as tcache
from llmss_tpu_torch.engine.engine import DecodeEngine as TEngine
from llmss_tpu_torch.engine.engine import GenerationParams as TGen
from llmss_tpu_torch.engine.scheduler import ContinuousBatcher as TBatcher
from llmss_tpu_torch.models.common import DecoderConfig as TCfg
from llmss_tpu_torch.serve import consumer as tconsumer
from llmss_tpu_torch.serve.consumer import ContinuousWorker as TWorker

CFG = dict(model_type="llama", vocab_size=128, hidden_size=64, n_layers=2,
           n_heads=4, n_kv_heads=2, head_dim=16, intermediate_size=96,
           max_position_embeddings=64, activation="silu", norm="rmsnorm",
           mlp="swiglu", positions="rotary", rope_style="half",
           attn_bias=False, mlp_bias=False, dtype="float32")
KV = {"fp32": None, "int8": "int8"}
PAGED = dict(kv_layout="paged", block_size=16)
ADMISSION = {"split": {}, "chunked": dict(chunked_prefill=8)}
# The reference test's requests: greedy, seeded-sampled with a partial
# tail block (18 > 16), and a one-token request the prefill role answers.
PROMPTS = [[1, 2, 3, 4, 5], list(range(1, 19)), [7, 8, 9]]
GENS = [dict(max_new_tokens=8, is_greedy=True),
        dict(max_new_tokens=6, is_greedy=False, temperature=0.8, top_k=20,
             seed=3),
        dict(max_new_tokens=1, is_greedy=True)]
ARRAYS = ("k", "v", "k_scale", "v_scale")


@pytest.fixture(scope="module")
def model():
    mesh = make_mesh(MeshPlan(dp=1, tp=1), devices=jax.devices()[:1])
    jp = jdec.init_params(JCfg(**CFG), mesh, jax.random.key(0))
    return mesh, jp, params_from_jax(jax.device_get(jp))


@pytest.fixture(scope="module")
def engines(model):
    """(JAX engine, port engine) per configuration, built once."""
    mesh, jp, tp = model
    made = {}

    def get(kv="fp32", **kw):
        key = (kv, tuple(sorted(kw.items())))
        if key not in made:
            ekw = {"max_seq_len": 64, "kv_dtype": KV[kv], **kw}
            made[key] = (JEngine(JCfg(**CFG), jp, mesh, **ekw),
                         TEngine(TCfg(**CFG), tp, device="cpu", **ekw))
        return made[key]

    return get


def _np(x):
    """Host numpy view of a torch tensor (bf16 as ml_dtypes' bfloat16) or
    a JAX / numpy array."""
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            return x.contiguous().view(torch.int16).numpy().view(
                ml_dtypes.bfloat16)
        return x.numpy()
    return np.asarray(jax.device_get(x))


# -- the wire format ----------------------------------------------------------------


def _blocks(dtype, nb=3, seed=0):
    """A synthetic export: (numpy arrays in the reference's dtypes, the
    same as torch tensors), ``[2, nb, 16, 2, 8]`` and scales."""
    rng = np.random.default_rng(seed)
    shape = (2, nb, 16, 2, 8)
    if dtype == "int8":
        arrs = {"k": rng.integers(-128, 128, shape, dtype=np.int8),
                "v": rng.integers(-128, 128, shape, dtype=np.int8),
                "k_scale": rng.standard_normal(shape[:-1], np.float32),
                "v_scale": rng.standard_normal(shape[:-1], np.float32)}
    else:
        f = rng.standard_normal
        arrs = {"k": f(shape, np.float32), "v": f(shape, np.float32),
                "k_scale": None, "v_scale": None}
    tens = {k: None if a is None else torch.from_numpy(a.copy())
            for k, a in arrs.items()}
    if dtype == "bfloat16":
        tens = {k: None if t is None else t.to(torch.bfloat16)
                for k, t in tens.items()}
        arrs = {k: None if t is None else _np(t) for k, t in tens.items()}
    return arrs, tens


DTYPES = ("float32", "bfloat16", "int8")


@pytest.mark.parametrize("dtype", DTYPES)
def test_wire_roundtrip_bit_exact(dtype):
    _, blocks = _blocks(dtype)
    payload = thandoff.encode_blocks(blocks, req_id="r1", n_tokens=40,
                                     block_size=16)
    out = thandoff.decode_blocks(payload)
    assert (out["req_id"], out["n_tokens"], out["block_size"],
            out["quantized"]) == ("r1", 40, 16, dtype == "int8")
    for name in ARRAYS:
        a, b = blocks[name], out[name]
        if a is None:
            assert b is None
            continue
        assert b.dtype == a.dtype and b.shape == a.shape
        assert _np(b).tobytes() == _np(a).tobytes()


@pytest.mark.parametrize("nb,n_tokens", [(3, 40), (2, 18), (1, 16)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_payload_bytes_equal_reference(dtype, nb, n_tokens):
    """The port's payload for torch tensors is the reference's payload
    for the same arrays, byte for byte (header, CRC and buffers), and
    each package decodes the other's to the same bytes."""
    arrs, tens = _blocks(dtype, nb=nb)
    kw = dict(req_id="req-9", n_tokens=n_tokens, block_size=16,
              trace_id="t-9")
    want = rhandoff.encode_blocks(arrs, **kw)
    got = thandoff.encode_blocks(tens, **kw)
    assert got == want
    assert thandoff.encode_blocks(arrs, **kw) == want  # numpy input too
    mine, theirs = thandoff.decode_blocks(want), rhandoff.decode_blocks(got)
    for name in ARRAYS:
        if arrs[name] is None:
            assert mine[name] is None and theirs[name] is None
            continue
        assert _np(mine[name]).tobytes() == arrs[name].tobytes()
        assert theirs[name].tobytes() == arrs[name].tobytes()
        assert str(theirs[name].dtype) == str(arrs[name].dtype)
    for key in ("req_id", "trace_id", "n_tokens", "block_size", "quantized",
                "tokens"):
        assert mine[key] == theirs[key]


def _corrupt(payload):
    return {
        "bad magic": b"XKVH" + payload[4:],
        "unknown version": payload.replace(b'"version": 1', b'"version": 9',
                                           1),
        "truncated header": payload[:6],
        "truncated buffers": payload[:-3],
        "flipped buffer byte": payload[:-1] + bytes([payload[-1] ^ 0x01]),
        "trailing bytes": payload + b"\x00",
    }


@pytest.mark.parametrize("case", sorted(_corrupt(b"LKVH")))
def test_wire_rejects_corruption(case):
    payload = thandoff.encode_blocks(_blocks("float32")[1], req_id="r",
                                     n_tokens=48, block_size=16)
    with pytest.raises(ValueError):
        thandoff.decode_blocks(_corrupt(payload)[case])
    with pytest.raises(ValueError):
        rhandoff.decode_blocks(_corrupt(payload)[case])
    thandoff.decode_blocks(payload)  # the pristine payload still decodes


def test_handoff_record_json_equals_reference():
    kw = dict(first_token=7, n_tokens=3, payload=b"\x00kv\xff")
    rec = thandoff.HandoffRecord(
        req=tproto.GenerateRequest(id="h0", token_ids=[1, 2, 3],
                                   max_new_tokens=4, slo_class="batch"), **kw)
    ref = rhandoff.HandoffRecord(
        req=rproto.GenerateRequest(id="h0", token_ids=[1, 2, 3],
                                   max_new_tokens=4, slo_class="batch"), **kw)
    assert rec.to_json() == ref.to_json()
    back = thandoff.HandoffRecord.from_json(ref.to_json())
    assert back == rec


def test_pick_decode_worker_matches_reference():
    ws = {
        "p0": {"role": "prefill", "state": "ready", "free_slots": 4},
        "d0": {"role": "decode", "state": "ready", "inflight_rows": 2,
               "free_slots": 2},
        "d1": {"role": "decode", "state": "ready", "inflight_rows": 0,
               "free_slots": 4},
        "d2": {"role": "decode", "state": "draining", "inflight_rows": 0,
               "free_slots": 8},
    }
    for workers, depths in ((ws, None), (ws, {"d1": 5}),
                            ({"p0": ws["p0"], "d2": ws["d2"]}, None)):
        assert (thandoff.pick_decode_worker(workers, depths)
                == rhandoff.pick_decode_worker(workers, depths))
    assert thandoff.pick_decode_worker(ws) == "d1"
    assert thandoff.pick_decode_worker(ws, {"d1": 5}) == "d0"


# -- export and import over the cache ---------------------------------------------------


def _pools(kv, N=6, bs=16, seed=1):
    """The same random pool contents as a JAX and a port PagedKVCache (the
    port's with its drop block)."""
    rng = np.random.default_rng(seed)
    shape = (2, N, bs, 2, 8)
    if kv == "int8":
        k = rng.integers(-127, 128, shape, dtype=np.int8)
        v = rng.integers(-127, 128, shape, dtype=np.int8)
        ks, vs = (rng.random(shape[:-1], np.float32) for _ in range(2))
    else:
        k, v = (rng.standard_normal(shape, np.float32) for _ in range(2))
        ks = vs = None
    tables = np.full((1, 4), N, np.int32)
    pos = np.full((1, 4 * bs), -1, np.int32)
    jc = jcache.PagedKVCache(*(None if a is None else jax.numpy.asarray(a)
                               for a in (k, v, tables, pos, ks, vs)))

    def t(a):
        if a is None:
            return None
        pad = np.zeros((a.shape[0], 1) + a.shape[2:], a.dtype)
        return torch.from_numpy(np.concatenate([a, pad], 1))

    tc = tcache.PagedKVCache(k=t(k), v=t(v),
                             block_tables=torch.from_numpy(tables),
                             positions=torch.from_numpy(pos),
                             k_scale=t(ks), v_scale=t(vs))
    return jc, tc


@pytest.mark.parametrize("kv", sorted(KV))
@pytest.mark.parametrize("ids,n_tokens", [([4, 1, 3], 40), ([2], 16),
                                          ([5, 0], 17)])
def test_export_blocks_matches_reference(kv, ids, n_tokens):
    jc, tc = _pools(kv)
    want = jcache.export_blocks(jc, ids, n_tokens)
    got = tcache.export_blocks(tc, np.asarray(ids, np.int32), n_tokens)
    for name in ARRAYS:
        if want[name] is None:
            assert got[name] is None
            continue
        np.testing.assert_array_equal(_np(got[name]), want[name])
    with pytest.raises(ValueError):
        tcache.export_blocks(tc, ids, len(ids) * 16 + 1)


@pytest.mark.parametrize("kv", sorted(KV))
@pytest.mark.parametrize("n_tokens", (1, 16, 29))
def test_export_dense_row_matches_reference(kv, n_tokens):
    rng = np.random.default_rng(2)
    shape = (2, 3, 32, 2, 8)
    if kv == "int8":
        k, v = (rng.integers(-127, 128, shape, dtype=np.int8)
                for _ in range(2))
        ks, vs = (rng.random(shape[:-1], np.float32) for _ in range(2))
    else:
        k, v = (rng.standard_normal(shape, np.float32) for _ in range(2))
        ks = vs = None
    pos = np.full((3, 32), -1, np.int32)
    jc = jcache.KVCache(k=k, v=v, positions=pos, k_scale=ks, v_scale=vs)
    tc = tcache.KVCache(*(None if a is None else torch.from_numpy(a)
                          for a in (k, v, pos, ks, vs)))
    want = jcache.export_dense_row(jc, 1, n_tokens, 16)
    got = tcache.export_dense_row(tc, 1, n_tokens, 16)
    for name in ARRAYS:
        if want[name] is None:
            assert got[name] is None
            continue
        np.testing.assert_array_equal(_np(got[name]), want[name])


@pytest.mark.parametrize("kv", sorted(KV))
def test_import_blocks_matches_reference(kv):
    """The same pool after importing blocks at ids with sentinel padding:
    the sentinel entries land in the drop block, never in a real one."""
    jc, tc = _pools(kv)
    src, _ = _pools(kv, N=4, seed=7)
    seg = jcache.export_blocks(src, [0, 1, 2, 3], 64)
    ids = np.asarray([3, 0, 6, 6], np.int32)  # two sentinel entries
    want = jcache.import_blocks(jc, seg["k"], seg["v"], seg["k_scale"],
                                seg["v_scale"], ids)
    tcache.import_blocks(tc, seg["k"], seg["v"], seg["k_scale"],
                         seg["v_scale"], ids)
    for name in ARRAYS:
        w = getattr(want, name)
        if w is None:
            continue
        np.testing.assert_array_equal(_np(getattr(tc, name))[:, :6], _np(w))


# -- the batcher: export and adopt -------------------------------------------------------


def _unified(eng, G, bkw, rows=2):
    bat = (TBatcher if G is TGen else JBatcher)(eng, rows=rows, **bkw)
    out = {}
    for i, (p, g) in enumerate(zip(PROMPTS, GENS)):
        bat.submit(p, G(**g), lambda t, *a, i=i, **k: out.__setitem__(i, t),
                   req_id=str(i))
    bat.run_until_idle()
    return out


def _state(bat) -> tuple:
    a = bat.allocator
    return (len(bat.active), a.blocks_in_use,
            tuple(a.refcount(b) for b in range(a.num_blocks)))


def _prefill(eng, G, bkw, prompts=PROMPTS, gens=GENS, prefix=None):
    """A prefill-only batcher over ``prompts``: (exports {rid: (first,
    n_tokens, blocks)}, local answers, the state after every step)."""
    B = TBatcher if G is TGen else JBatcher
    pre = B(eng, rows=2, prefill_only=True, **bkw)
    exports, local, trace = {}, {}, []
    pre.export_cb = lambda rid, first, n, blocks: exports.__setitem__(
        rid, (first, n, blocks))
    for i, (p, g) in enumerate(zip(prompts, gens)):
        pre.submit(p, G(**g),
                   lambda t, *a, i=i, **k: local.__setitem__(i, t),
                   req_id=str(i), prefix=prefix)
    while not pre.idle:
        pre.step()
        trace.append(_state(pre))
    assert pre.allocator.blocks_in_use == (
        0 if prefix is None else len(prefix.tokens) // eng.block_size)
    return exports, local, trace


def _adopt_all(eng, exports, gens=GENS, rows=2):
    """Every export through the wire and ``adopt`` on a decode batcher;
    returns {index: tokens}."""
    dec = TBatcher(eng, rows=rows)
    out = {}
    for rid, (first, n, blocks) in exports.items():
        payload = thandoff.encode_blocks(blocks, req_id=rid, n_tokens=n,
                                         block_size=eng.block_size)
        d = thandoff.decode_blocks(payload)
        assert dec.adopt(rid, first, n, {k: d[k] for k in ARRAYS},
                         TGen(**gens[int(rid)]),
                         lambda t, *a, rid=rid, **k: out.__setitem__(
                             int(rid), t))
    dec.run_until_idle()
    assert dec.allocator.blocks_in_use == 0
    return out


@pytest.mark.parametrize("adm", sorted(ADMISSION))
@pytest.mark.parametrize("kv", sorted(KV))
def test_export_adopt_bit_identical(engines, kv, adm):
    """prefill-only export -> wire -> adopt gives the unified batcher's
    tokens (and the JAX unified batcher's); the one-token request is
    answered by the prefill batcher; blocks and refcounts after every
    prefill step equal the JAX prefill-only batcher's, and so do the
    exported blocks' first tokens and lengths."""
    jeng, teng = engines(kv, **PAGED)
    bkw = ADMISSION[adm]
    want = _unified(jeng, JGen, bkw)
    assert _unified(teng, TGen, bkw) == want
    jexp, jlocal, jtrace = _prefill(jeng, JGen, bkw)
    exports, local, trace = _prefill(teng, TGen, bkw)
    assert trace == jtrace and local == jlocal == {2: want[2]}
    assert {r: (f, n) for r, (f, n, _) in exports.items()} == {
        r: (f, n) for r, (f, n, _) in jexp.items()}
    for rid, (_, _, blocks) in exports.items():
        for name in ARRAYS:
            if blocks[name] is None:
                assert jexp[rid][2][name] is None
                continue
            if name in ("k", "v") and kv == "int8":
                diff = np.abs(_np(blocks[name]).astype(np.int32)
                              - np.asarray(jexp[rid][2][name], np.int32))
                assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
            else:
                np.testing.assert_allclose(_np(blocks[name]),
                                           jexp[rid][2][name], rtol=1e-5,
                                           atol=1e-5)
    got = _adopt_all(teng, exports)
    assert {**got, **local} == want


def test_export_adopt_bit_identical_bf16(model):
    """A bf16 pool: export -> wire -> adopt gives the unified batcher's
    tokens bit for bit, and the adopted blocks read back from the pool
    equal the exported bytes."""
    _mesh, _jp, tp = model
    eng = TEngine(TCfg(**{**CFG, "dtype": "bfloat16"}),
                  {k: v for k, v in tp.items()}, device="cpu",
                  max_seq_len=64, **PAGED)
    want = _unified(eng, TGen, {})
    exports, local, _ = _prefill(eng, TGen, {})
    assert exports["0"][2]["k"].dtype == torch.bfloat16
    dec = TBatcher(eng, rows=2)
    first, n, blocks = exports["1"]
    d = thandoff.decode_blocks(thandoff.encode_blocks(
        blocks, req_id="1", n_tokens=n, block_size=16))
    assert dec.adopt("1", first, n, {k: d[k] for k in ARRAYS},
                     TGen(**GENS[1]), lambda *a, **k: None)
    owned = dec._row_owned[next(iter(dec.active))][: -(-n // 16)]
    for name in ("k", "v"):
        back = getattr(dec.cache, name)[:, owned]
        assert back.view(torch.int16).equal(blocks[name].view(torch.int16))
    got = _adopt_all(eng, exports)
    assert {**got, **local} == want


@pytest.mark.parametrize("adm", sorted(ADMISSION))
def test_cow_refcounts_preserved_on_export(engines, adm):
    """Rows whose prompts ride a copy-on-write prefix block export as a
    pure read: the registry keeps its shared block, the rows' own
    references go, and the adopted rows give the dense engine's tokens.
    Blocks and refcounts after every step equal the JAX batcher's."""
    jeng, teng = engines(**PAGED)
    pfx = list(range(1, 21))
    prompts = [pfx + [30 + i] for i in range(2)]
    gens = [dict(max_new_tokens=5)] * 2
    bkw = ADMISSION[adm]
    _, _, jtrace = _prefill(jeng, JGen, bkw, prompts, gens,
                            jeng.build_prefix(pfx))
    exports, _, trace = _prefill(teng, TGen, bkw, prompts, gens,
                                 teng.build_prefix(pfx))
    assert trace == jtrace
    assert [n for _, n, _ in exports.values()] == [21, 21]
    dense = engines()[1]
    got = _adopt_all(teng, exports, gens)
    for i, p in enumerate(prompts):
        assert got[i] == dense.generate([p], TGen(max_new_tokens=5))[0]


@pytest.mark.parametrize("adm", sorted(ADMISSION))
def test_export_then_admit_into_the_freed_blocks(engines, adm):
    """A prefill-only batcher of one row exports a row while its group may
    still be in flight and admits the next request into the blocks just
    freed: every export still gives the unified tokens, and the exports
    equal the JAX batcher's."""
    jeng, teng = engines(**PAGED)
    prompts = [[5, 6, 7, 8], list(range(30, 52)), [9, 10], [11] * 17]
    gens = [dict(max_new_tokens=6 + i) for i in range(4)]
    bkw = ADMISSION[adm]
    jexp = _one_row_prefill(jeng, JGen, bkw, prompts, gens)
    exports = _one_row_prefill(teng, TGen, bkw, prompts, gens)
    assert {r: (f, n) for r, (f, n, _) in exports.items()} == {
        r: (f, n) for r, (f, n, _) in jexp.items()}
    got = _adopt_all(teng, exports, gens, rows=4)
    for i, p in enumerate(prompts):
        assert got[i] == teng.generate([p], TGen(**gens[i]))[0]


def _one_row_prefill(eng, G, bkw, prompts, gens):
    B = TBatcher if G is TGen else JBatcher
    pre = B(eng, rows=1, prefill_only=True, **bkw)
    exports = {}
    pre.export_cb = lambda rid, first, n, blocks: exports.__setitem__(
        rid, (first, n, blocks))
    for i, (p, g) in enumerate(zip(prompts, gens)):
        pre.submit(p, G(**g), lambda *a, **k: None, req_id=str(i))
    pre.run_until_idle()
    assert len(exports) == len(prompts)
    return exports


def test_adopt_into_a_row_freed_under_a_group_in_flight(engines):
    """Rows turn over on the decode side: a record adopted into a row that
    finished while the next group was already in flight decodes from its
    own state, not from that group's values for the row (the previous
    occupant's). Every request gets its unified tokens."""
    _jeng, teng = engines(**PAGED)
    prompts = [[3, 4, 5], [6, 7], [8, 9, 10, 11], [12] * 5]
    gens = [dict(max_new_tokens=n) for n in (20, 3, 9, 4)]
    exports = _one_row_prefill(teng, TGen, {}, prompts, gens)
    dec = TBatcher(teng, rows=2, chunk_steps=2)
    out, order, turned = {}, sorted(exports, key=int), 0
    while order or not dec.idle:
        while order:
            rid = order[0]
            first, n, blocks = exports[rid]
            in_flight = dec._inflight is not None
            if not dec.adopt(rid, first, n, blocks, TGen(**gens[int(rid)]),
                             lambda t, *a, rid=rid, **k: out.__setitem__(
                                 int(rid), t)):
                break
            turned += in_flight and int(rid) >= 2
            order.pop(0)
        dec.step()
    assert turned, "no adoption happened under a group in flight"
    for i, p in enumerate(prompts):
        assert out[i] == teng.generate([p], TGen(**gens[i]))[0], i


def test_adopt_validates_before_taking_a_row(engines):
    """A payload that does not fit raises before a row or a block is
    taken; a pool without room returns False with nothing changed."""
    _jeng, teng = engines(**PAGED)
    exports, _, _ = _prefill(teng, TGen, {})
    first, n, blocks = exports["1"]  # 18 tokens: 2 blocks
    dec = TBatcher(teng, rows=1)
    gen = TGen(max_new_tokens=4)
    bad = [dict(blocks, k=blocks["k"][:, :1]),
           dict(blocks, k=blocks["k"].reshape(2, 4, 8, 2, 16)),
           dict(blocks, k_scale=torch.ones(2, 2, 16, 2)),
           dict(blocks, k=blocks["k"][..., :8])]
    for b in bad:
        with pytest.raises(ValueError):
            dec.adopt("x", first, n, b, gen, lambda *a, **k: None)
    assert dec.allocator.blocks_in_use == 0 and len(dec._free) == 1
    assert dec.adopt("1", first, n, blocks, gen, lambda *a, **k: None)
    assert not dec.adopt("2", first, n, blocks, gen, lambda *a, **k: None)
    assert len(dec.active) == 1
    with pytest.raises(ValueError):
        TBatcher(engines()[1], rows=1, prefill_only=True)
    with pytest.raises(ValueError):
        TBatcher(teng, rows=1, prefill_only=True).adopt(
            "1", first, n, blocks, gen, lambda *a, **k: None)


# -- brokers: the handoff channel ---------------------------------------------------------


def _side(kind, pkg, proto, handoff, **kw):
    """(broker, a request maker, a record maker) of one package."""
    b = (pkg.InProcBroker(**kw) if kind == "inproc"
         else pkg.RedisBroker(client=FakeRedis(), worker_id="w0", **kw))

    def req(i=0, **rkw):
        rkw.setdefault("deadline_ts", time.time() + 60.0)
        rkw.setdefault("max_new_tokens", 4)
        return proto.GenerateRequest(id=f"h{i}", token_ids=[1, 2, i + 3],
                                     **rkw)

    def rec(r, payload=b"kv-payload"):
        return handoff.HandoffRecord(req=r, first_token=7,
                                     n_tokens=len(r.token_ids),
                                     payload=payload)

    return b, req, rec, proto


def settles_request_lease_then_acks_on_response(s):
    b, req, rec, proto = s(lease_s=0.1, max_delivery_attempts=3)
    b.push_request(req(0))
    leased = b.pop_request(timeout=1.0)
    b.push_handoff(rec(leased, payload=b"x" * 32))
    time.sleep(0.15)
    b.reap_expired()
    out = [b.pop_request(timeout=0.01), b.delivery_stats(),
           b.handoff_depth()]
    got = b.pop_handoff(timeout=1.0)
    out += [(got.req.id, got.payload, got.first_token, got.n_tokens,
             got.req.delivery_attempts),
            b.delivery_stats()["handoff_inflight"]]
    b.push_response(proto.GenerateResponse(id="h0", token_ids=[7, 8]))
    out.append(b.delivery_stats()["handoff_inflight"])
    time.sleep(0.15)
    b.reap_expired()
    out += [b.wait_response("h0", timeout=1.0).token_ids,
            b.wait_response("h0", timeout=0.05), b.delivery_stats()]
    return out


def lease_expiry_reprefills(s):
    b, req, rec, _ = s(lease_s=0.08, max_delivery_attempts=5)
    b.push_handoff(rec(req(0)))
    assert b.pop_handoff(timeout=0.5) is not None
    time.sleep(0.15)
    b.reap_expired()
    back = b.pop_request(timeout=0.5)
    return back.id, back.trace_attempt, back.delivery_attempts, \
        b.delivery_stats()


def touch_handoffs_keeps_lease_alive(s):
    b, req, rec, proto = s(lease_s=0.12)
    b.push_handoff(rec(req(0)))
    assert b.pop_handoff(timeout=0.5) is not None
    for _ in range(4):
        time.sleep(0.06)
        b.touch_handoffs(["h0"])
        b.reap_expired()
    inflight = b.delivery_stats()["handoff_inflight"]
    b.push_response(proto.GenerateResponse(id="h0", token_ids=[7]))
    return inflight, b.delivery_stats()


def fail_handoff_reprefills_then_dead_letters(s):
    b, req, rec, _ = s(lease_s=5.0, max_delivery_attempts=2)
    b.push_request(req(0))
    seen = []
    for _ in (1, 2):
        r = b.pop_request(timeout=1.0)
        seen.append(r.delivery_attempts)
        b.push_handoff(rec(r))
        b.fail_handoff(b.pop_handoff(timeout=1.0), error="corrupt payload")
    resp = b.wait_response("h0", timeout=1.0)
    return (seen, b.delivery_stats(), b.dlq_depth(), resp.error,
            b.wait_response("h0", timeout=0.05), b.pop_request(timeout=0.01))


def deadline_sheds_terminally(s):
    b, req, rec, _ = s(lease_s=0.05, max_delivery_attempts=5)
    b.push_handoff(rec(req(0, deadline_ts=time.time() + 0.1)))
    assert b.pop_handoff(timeout=0.5) is not None
    time.sleep(0.2)
    b.reap_expired()
    resp = b.wait_response("h0", timeout=1.0)
    return resp.error, b.pop_request(timeout=0.01), b.delivery_stats()


def pop_handoff_waits_and_orders(s):
    b, req, rec, _ = s()
    out = [b.pop_handoff(), b.pop_handoff(timeout=0.02)]
    for i in range(3):
        b.push_handoff(rec(req(i)))
    out.append([b.pop_handoff(timeout=0.5).req.id for _ in range(3)])
    return out + [b.handoff_depth(), b.delivery_stats()]


HANDOFF_CASES = (settles_request_lease_then_acks_on_response,
                 lease_expiry_reprefills, touch_handoffs_keeps_lease_alive,
                 fail_handoff_reprefills_then_dead_letters,
                 deadline_sheds_terminally, pop_handoff_waits_and_orders)


def _scrub(x):
    """Drop what differs by construction: the Redis retry counter the
    reference lacks."""
    if isinstance(x, dict):
        return {k: _scrub(v) for k, v in x.items() if k != "broker_retries"}
    if isinstance(x, (list, tuple)):
        return type(x)(_scrub(v) for v in x)
    return x


@pytest.mark.parametrize("kind", ("inproc", "redis"))
@pytest.mark.parametrize("case", HANDOFF_CASES, ids=lambda c: c.__name__)
def test_handoff_channel_matches_reference(case, kind):
    def side(pkg, proto, handoff):
        return lambda **kw: _side(kind, pkg, proto, handoff, **kw)

    want = case(side(rbroker, rproto, rhandoff))
    got = case(side(tbroker, tproto, thandoff))
    assert _scrub(got) == _scrub(want)


def test_handoff_records_cross_redis_both_ways():
    """On one FakeRedis: the reference's record is leased and answered by
    the port, the port's by the reference, and a lease either abandons is
    reaped by the other into a re-prefill."""
    server = FakeRedis()
    ref = rbroker.RedisBroker(client=server, worker_id="ref", lease_s=0.05)
    port = tbroker.RedisBroker(client=server, worker_id="port", lease_s=0.05)
    arrs, tens = _blocks("bfloat16", nb=2)
    for b, proto, handoff, blocks, rid in (
            (ref, rproto, rhandoff, arrs, "a"),
            (port, tproto, thandoff, tens, "b")):
        b.push_request(proto.GenerateRequest(id=rid, token_ids=[1, 2],
                                             max_new_tokens=4))
        r = b.pop_request()
        b.push_handoff(handoff.HandoffRecord(
            req=r, first_token=5, n_tokens=20,
            payload=handoff.encode_blocks(blocks, req_id=rid, n_tokens=20,
                                          block_size=16)))
    got_a = port.pop_handoff()
    got_b = ref.pop_handoff()
    assert (got_a.req.id, got_b.req.id) == ("a", "b")
    assert got_a.payload.replace(b'"a"', b'"b"', 1) == got_b.payload
    assert _np(thandoff.decode_blocks(got_a.payload)["k"]).tobytes() == (
        arrs["k"].tobytes())
    port.push_response(tproto.GenerateResponse(id="a", token_ids=[5, 6]))
    assert ref.wait_response("a", timeout=1).token_ids == [5, 6]
    st = ref.delivery_stats()
    assert st["handoffs"] == 2 and st["handoff_inflight"] == 1
    time.sleep(0.08)  # the reference abandons "b": the port reaps it
    back = port.pop_request()
    assert (back.id, back.trace_attempt) == ("b", 1)
    assert port.delivery_stats()["reprefills"] == 1
    assert ref.wait_response("a", timeout=0.01) is None


# -- the workers ------------------------------------------------------------------------


def _reqs(proto, n=3):
    """The reference fleet test's requests (n=3), or more of the kind."""
    base = [dict(id="a", token_ids=[1, 2, 3, 4, 5], max_new_tokens=8),
            dict(id="b", token_ids=list(range(1, 19)), max_new_tokens=6,
                 temperature=0.8, top_k=20, seed=3, is_greedy=False),
            dict(id="c", token_ids=[7, 8, 9], max_new_tokens=1)]
    base += [dict(id=f"x{i}", token_ids=[(5 * i + j) % 120 + 1
                                         for j in range(3 + 7 * i)],
                  max_new_tokens=4 + 3 * i) for i in range(n - 3)]
    return [proto.GenerateRequest(**kw) for kw in base]


def _collect(broker, workers, reqs, max_iters=2000):
    got = {}
    for _ in range(max_iters):
        for w in workers:
            w.run_once()
        for r in reqs:
            if r.id not in got:
                resp = broker.wait_response(r.id, timeout=0.001)
                if resp is not None:
                    got[r.id] = resp
        if len(got) == len(reqs):
            for r in reqs:  # exactly one answer each
                assert broker.wait_response(r.id, timeout=0.001) is None
            return {rid: (x.token_ids, x.error) for rid, x in got.items()}
    raise AssertionError(f"unanswered: {sorted(got)}")


def _brokers(pkg, kind, **kw):
    if kind == "inproc":
        b = pkg.InProcBroker(**kw)
        return b, lambda wid: b
    server = FakeRedis()
    return (pkg.RedisBroker(client=server, worker_id="producer", **kw),
            lambda wid: pkg.RedisBroker(client=server, worker_id=wid, **kw))


def _roles(W, eng, mk, **kw):
    kw.setdefault("poll_timeout_s", 0.0)
    return [W(eng, mk("p0"), rows=2, role="prefill", **kw),
            W(eng, mk("d0"), rows=2, role="decode", **kw)]


@pytest.fixture(scope="module")
def jax_fleet(engines):
    """The JAX package's answers to ``_reqs``: (unified worker, a prefill
    and a decode worker), on its in-process broker."""
    jeng, _ = engines(**PAGED)
    out = []
    for workers in (lambda mk: [JWorker(jeng, mk("u0"), rows=2,
                                        poll_timeout_s=0.0)],
                    lambda mk: _roles(JWorker, jeng, mk)):
        b, mk = _brokers(rbroker, "inproc")
        reqs = _reqs(rproto)
        for r in reqs:
            b.push_request(r)
        out.append(_collect(b, workers(mk), reqs))
    return out


@pytest.mark.parametrize("kind", ("inproc", "redis"))
def test_two_replica_fleet_bit_identical_to_unified(engines, jax_fleet,
                                                    kind):
    """One prefill and one decode worker answer as the unified worker
    does, and as the JAX package's unified worker and two-replica fleet
    do; the one-token request is answered by the prefill worker."""
    _jeng, teng = engines(**PAGED)
    b, mk = _brokers(tbroker, kind)
    reqs = _reqs(tproto)
    for r in reqs:
        b.push_request(r)
    uni = _collect(b, [TWorker(teng, mk("u0"), rows=2, poll_timeout_s=0.0)],
                   reqs)
    b, mk = _brokers(tbroker, kind)
    reqs = _reqs(tproto)
    for r in reqs:
        b.push_request(r)
    workers = _roles(TWorker, teng, mk)
    fleet = _collect(b, workers, reqs)
    assert fleet == uni == jax_fleet[0] == jax_fleet[1]
    st = b.delivery_stats()
    assert (st["handoffs"], st["reprefills"], st["handoff_inflight"],
            st["handoff_depth"], st["inflight"]) == (2, 0, 0, 0, 0)
    assert [w.load_snapshot()["role"] for w in workers] == ["prefill",
                                                            "decode"]


@pytest.mark.parametrize("kv", sorted(KV))
@pytest.mark.parametrize("adm", sorted(ADMISSION))
def test_roles_under_load_equal_unified(engines, adm, kv):
    """Six requests over two rows on each side, split and chunked, fp32
    and int8: rows turn over on both roles, and every answer equals the
    unified worker's; handoffs count every request of more than one
    token and their bytes sum the payloads."""
    _jeng, teng = engines(kv, **PAGED)
    bkw = ADMISSION[adm]
    b, mk = _brokers(tbroker, "inproc")
    reqs = _reqs(tproto, 6)
    for r in reqs:
        b.push_request(r)
    want = _collect(b, [TWorker(teng, mk("u"), rows=2, poll_timeout_s=0.0,
                                **bkw)], reqs)
    b, mk = _brokers(tbroker, "inproc")
    sizes = []
    push = b.push_handoff
    b.push_handoff = lambda rec: (sizes.append(len(rec.payload)), push(rec))
    reqs = _reqs(tproto, 6)
    for r in reqs:
        b.push_request(r)
    assert _collect(b, _roles(TWorker, teng, mk, **bkw), reqs) == want
    st = b.delivery_stats()
    assert st["handoffs"] == sum(r.max_new_tokens > 1 for r in reqs)
    assert st["handoff_bytes"] == sum(sizes)


@pytest.mark.parametrize("direction", ("jax_to_port", "port_to_jax"))
def test_records_cross_roles_between_packages(engines, direction):
    """On one FakeRedis, a prefill worker of one package and a decode
    worker of the other: the answers are the JAX unified worker's."""
    jeng, teng = engines(**PAGED)
    server = FakeRedis()
    pb = (rbroker if direction == "jax_to_port" else tbroker).RedisBroker(
        client=server, worker_id="p0")
    db = (tbroker if direction == "jax_to_port" else rbroker).RedisBroker(
        client=server, worker_id="d0")
    if direction == "jax_to_port":
        pre = JWorker(jeng, pb, rows=2, role="prefill", poll_timeout_s=0.0)
        dec = TWorker(teng, db, rows=2, role="decode", poll_timeout_s=0.0)
    else:
        pre = TWorker(teng, pb, rows=2, role="prefill", poll_timeout_s=0.0)
        dec = JWorker(jeng, db, rows=2, role="decode", poll_timeout_s=0.0)
    reqs = _reqs(rproto)
    b, mk = _brokers(rbroker, "inproc")
    for r in reqs:
        b.push_request(r)
    want = _collect(b, [JWorker(jeng, mk("u"), rows=2, poll_timeout_s=0.0)],
                    reqs)
    reqs = _reqs(rproto)
    for r in reqs:
        pb.push_request(r)
    assert _collect(pb, [pre, dec], reqs) == want
    assert pb.delivery_stats()["handoffs"] == 2


def test_exactly_one_answer_under_corrupt_payload_expiry_and_deadline(
        engines):
    """A corrupt payload is failed back and prefilled again; a decode
    worker that dies after adopting lets its lease expire and the request
    is prefilled again for another decode worker; a record whose deadline
    passed is shed. Every request is answered once, with the unified
    tokens where it is served."""
    jeng, teng = engines(**PAGED)
    b, mk = _brokers(tbroker, "inproc", lease_s=2.0)
    reqs = _reqs(tproto)[:2]
    b2, mk2 = _brokers(tbroker, "inproc")
    for r in _reqs(tproto)[:2]:
        b2.push_request(r)
    want = _collect(b2, [TWorker(teng, mk2("u"), rows=2, poll_timeout_s=0.0)],
                    _reqs(tproto)[:2])

    pre, dead, dec = (TWorker(teng, b, rows=2, role=r, poll_timeout_s=0.0)
                      for r in ("prefill", "decode", "decode"))
    push = b.push_handoff
    corrupted = []

    def corrupt_first(rec):
        if not corrupted:
            corrupted.append(rec.req.id)
            rec = dataclasses.replace(rec, payload=rec.payload[:-1] + b"?")
        push(rec)

    b.push_handoff = corrupt_first
    for r in reqs:
        b.push_request(r)
    pre.run_once()  # both exported; the first record is corrupt
    dead.run_once()  # fails the corrupt one, adopts the other, then dies
    assert b.delivery_stats()["reprefills"] == 1
    assert len(dead.batcher.active) == 1
    time.sleep(2.1)  # the dead worker's handoff lease expires
    got = _collect(b, [pre, dec], reqs)
    assert got == want
    st = b.delivery_stats()
    assert st["reprefills"] == 2 and st["dlq_depth"] == 0
    assert st["handoffs"] == 4

    late = tproto.GenerateRequest(id="late", token_ids=[1, 2, 3],
                                  max_new_tokens=5,
                                  deadline_ts=time.time() + 0.05)
    b.push_request(late)
    pre.run_once()
    time.sleep(0.1)
    assert _collect(b, [dec], [late]) == {"late": (None,
                                                   "deadline exceeded")}


def test_decode_backlog_drain_and_abort(engines):
    """A record that finds no free row waits in the decode worker's
    backlog (its lease renewed, counted in the snapshot's queue depth);
    draining still adopts it; ``abort_inflight`` fails a backlog back to
    the broker, which prefills it again."""
    _jeng, teng = engines(**PAGED)
    b = tbroker.InProcBroker(lease_s=30.0)
    pre = TWorker(teng, b, rows=2, role="prefill")
    dec = TWorker(teng, b, rows=1, role="decode")
    reqs = _reqs(tproto)[:2]
    for r in reqs:
        b.push_request(r)
    pre.run_once()
    dec.run_once()
    assert len(dec._adopt_backlog) == 1
    snap = dec.load_snapshot()
    assert snap["role"] == "decode" and snap["queue_depth"] == 1
    dec.begin_drain()
    assert not dec.drained
    dec.abort_inflight("test")
    st = b.delivery_stats()
    assert st["reprefills"] == 1 and st["handoff_inflight"] == 0
    assert b.wait_response(reqs[0].id, timeout=0.01).error.startswith(
        "worker restarted")
    assert b.pop_request().id == reqs[1].id


def test_role_and_flag_validation():
    parser = tconsumer._parser()
    assert parser.parse_args(["--pretrained_model_path", "x", "--role",
                              "decode"]).role == "decode"
    for argv in (["--role", "prefill"],
                 ["--role", "decode", "--continuous"],
                 ["--role", "bogus", "--continuous", "--kv_layout", "paged"]):
        with pytest.raises(SystemExit):
            tconsumer.main(["--pretrained_model_path", "x", *argv])
    with pytest.raises(ValueError):
        TWorker(None, tbroker.InProcBroker(), role="router")
