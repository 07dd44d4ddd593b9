"""The tiered KV store in the torch port (``serve/kvstore.py``, the
batcher's ``demote_cb`` / ``park_cb``, the worker's store branches and
``consumer.main --kv_tier_host_mb``) on the CPU, against the JAX package.

The reference's ``tests/test_kvstore.py`` is mirrored case by case on the
port's classes: the T1 LRU (order, oversize spill, counted drops), T2's
fall-through that warms T1 again, the blob-store contract over
``InProcBlobStore`` and ``RedisBlobStore`` on ``FakeRedis``, bit-exact
prefix blobs, corrupt blobs deleted, a mismatched turn leaving its blob.
What is compared with the JAX package:

- blobs: a prefix the JAX engine built, converted to torch, encodes to
  the reference's bytes at fp32 and int8, and each package decodes the
  other's blob bit-exact; a reference and a port ``RedisBlobStore`` on one
  ``FakeRedis`` read each other's prefix and session blobs;
- sessions: park / resume through ``ContinuousWorker`` (dense, paged
  split, paged chunked; fp32 and int8) gives the reference worker's
  tokens and ``stats()``, and the port's tokens without a store;
- prefixes: demotion counters and block refcounts after a promoted
  install equal the JAX batcher's; a worker whose LRU and pool demote and
  promote gives the reference worker's tokens and stats; a second worker
  on the same blob store (either package) promotes what the first
  demoted, with the first's tokens.

Stats are compared without T1's byte count: a blob's header holds its
CRC in decimal, so fp32 KV that differs in its last bits between the
packages can give a header a digit longer.

Tiny fp32 llama, parameters from the JAX ``init_params`` through
``convert.params_from_jax``; stores are flushed before their stats are
read (demotions land on the store's thread)."""

import json
import os
import signal
import sys
import threading
import types

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.torch import save_file

import llmss_tpu.serve.kvstore as rk
import llmss_tpu.serve.protocol as rproto
import llmss_tpu_torch.serve.kvstore as tk
import llmss_tpu_torch.serve.protocol as tproto
from llmss_tpu.engine import DecodeEngine as JEngine
from llmss_tpu.engine import GenerationParams as JGen
from llmss_tpu.engine.engine import Prefix as JPrefix
from llmss_tpu.engine.engine import _bucket as j_bucket
from llmss_tpu.engine.scheduler import ContinuousBatcher as JBatcher
from llmss_tpu.models import decoder as jdec
from llmss_tpu.models.common import DecoderConfig as JCfg
from llmss_tpu.parallel import MeshPlan, make_mesh
from llmss_tpu.serve.broker import InProcBroker as JBroker
from llmss_tpu.serve.chaos import FakeRedis
from llmss_tpu.serve.consumer import ContinuousWorker as JWorker
from llmss_tpu_torch.convert import params_from_jax
from llmss_tpu_torch.engine.engine import DecodeEngine as TEngine
from llmss_tpu_torch.engine.engine import GenerationParams as TGen
from llmss_tpu_torch.engine.engine import Prefix as TPrefix
from llmss_tpu_torch.engine.engine import _bucket
from llmss_tpu_torch.engine.scheduler import ContinuousBatcher as TBatcher
from llmss_tpu_torch.models.common import DecoderConfig as TCfg
from llmss_tpu_torch.serve.broker import InProcBroker as TBroker
from llmss_tpu_torch.serve.broker import RedisBroker
from llmss_tpu_torch.serve.consumer import ContinuousWorker as TWorker
from llmss_tpu_torch.serve.consumer import main as consumer_main
from llmss_tpu_torch.serve.handoff import decode_blocks

CFG = dict(model_type="llama", vocab_size=128, hidden_size=64, n_layers=2,
           n_heads=4, n_kv_heads=2, head_dim=16, intermediate_size=96,
           max_position_embeddings=64, activation="silu", norm="rmsnorm",
           mlp="swiglu", positions="rotary", rope_style="half",
           attn_bias=False, mlp_bias=False, dtype="float32")
KV = {"fp32": None, "int8": "int8"}
PAGED = dict(kv_layout="paged", block_size=16)
# Worker modes: (engine keywords, worker keywords).
MODES = {"dense": ({}, {}), "paged": (PAGED, {}),
         "chunked": (PAGED, dict(chunked_prefill=8))}
ARRAYS = ("k", "v", "k_scale", "v_scale")
# Two prefixes of one full block and a tail (bs 16).
PFX_A = [7, 3, 19, 42, 5, 11, 30, 2, 9, 17, 28, 33, 21, 6, 13, 40, 8, 25]
PFX_B = [4, 44, 12, 90, 61, 2, 77, 15, 3, 8, 100, 23, 54, 9, 31, 70, 1, 66,
         5, 48]


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
    """Host numpy of a torch tensor (bf16 as ml_dtypes' bfloat16) or a
    JAX / numpy array."""
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            return x.contiguous().view(torch.int16).numpy().view(
                ml_dtypes.bfloat16)
        return x.numpy()
    return np.asarray(jax.device_get(x))


def _torch(a):
    """A numpy array (bf16 from ml_dtypes) as a torch tensor."""
    if a is None:
        return None
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _prefix_pair(dtype, n, max_seq_len=64, seed=0):
    """The same synthetic prefix for both packages: a reference ``Prefix``
    of numpy arrays ``[2, Pb, 2, 8]`` (scales ``[2, Pb, 2]``) padded to
    ``_bucket(n)`` as ``build_prefix`` pads, with nonzero pad slots, and
    the port's ``Prefix`` of the same values as torch tensors."""
    pb = j_bucket(n, max_seq_len)
    rng = np.random.default_rng(seed)
    shape = (2, pb, 2, 8)
    if dtype == "int8":
        arrs = {"k": rng.integers(-128, 128, shape, dtype=np.int8),
                "v": rng.integers(-128, 128, shape, dtype=np.int8),
                "k_scale": rng.standard_normal(shape[:-1], np.float32),
                "v_scale": rng.standard_normal(shape[:-1], np.float32)}
    else:
        f = rng.standard_normal
        arrs = {"k": f(shape, np.float32), "v": f(shape, np.float32),
                "k_scale": None, "v_scale": None}
        if dtype == "bfloat16":
            arrs = {k: None if a is None else a.astype(ml_dtypes.bfloat16)
                    for k, a in arrs.items()}
    toks = tuple(range(1, n + 1))
    return (JPrefix(tokens=toks, **arrs),
            TPrefix(tokens=toks, **{k: _torch(a) for k, a in arrs.items()}))


def _assert_prefix_equal(got, want, n):
    """Live slots bit-exact, the bucket shape and dtype of ``want``, pad
    slots zero."""
    assert tuple(got.tokens) == tuple(want.tokens)
    for name in ARRAYS:
        x, y = getattr(want, name), getattr(got, name)
        if x is None:
            assert y is None
            continue
        x, y = _np(x), _np(y)
        assert y.dtype == x.dtype and y.shape == x.shape
        assert y[:, :n].tobytes() == x[:, :n].tobytes()
        assert not y[:, n:].astype(np.float32).any()


def _counts(stats):
    """``stats()`` without T1's byte count (module docstring)."""
    return {**stats, "t1": {k: v for k, v in stats["t1"].items()
                            if k != "bytes"}}


# -- T1: the LRU ----------------------------------------------------------------------


def test_host_lru_spills_in_lru_order():
    spilled = []
    h = tk.HostKVStore(cap_bytes=300, spill_cb=lambda k, v: spilled.append(k))
    for key in ("a", "b", "c"):
        h.put(key, key.encode() * 100)
    assert spilled == []
    assert h.get("a") is not None  # "a" becomes the most recent
    h.put("d", b"d" * 100)  # "b" spills first
    h.put("e", b"e" * 100)  # then "c", never the touched "a"
    assert spilled == ["b", "c"]
    assert sorted(h.keys()) == ["a", "d", "e"]
    st = h.stats()
    assert st["bytes"] == 300 and st["entries"] == 3
    assert st["spilled"] == 2 and st["dropped"] == 0


def test_host_lru_oversized_payload_spills_straight_through():
    spilled = []
    h = tk.HostKVStore(cap_bytes=100, spill_cb=lambda k, v: spilled.append(k))
    h.put("big", b"x" * 101)
    assert spilled == ["big"] and h.keys() == []
    assert h.get("big") is None


def test_host_lru_drops_are_counted_without_spill_cb():
    h = tk.HostKVStore(cap_bytes=100)
    h.put("a", b"x" * 80)
    h.put("b", b"y" * 80)
    assert h.keys() == ["b"]
    assert h.stats()["dropped"] == 1 and h.stats()["spilled"] == 0


def test_tiered_get_falls_through_and_rewarms_t1():
    blob = tk.InProcBlobStore()
    store = tk.TieredKVStore(host=tk.HostKVStore(cap_bytes=8), blob=blob)
    store.put_blob("a", b"A" * 8)
    store.put_blob("b", b"B" * 8)  # the cap fits one: "a" spills to T2
    assert store.host.keys() == ["b"] and blob.keys() == ["a"]
    assert store.get_blob("a") == b"A" * 8  # a T2 hit...
    assert store.host.keys() == ["a"]  # ...warms T1 ("b" spills)
    assert sorted(blob.keys()) == ["a", "b"]


# -- T2: the blob-store contract ------------------------------------------------------


def _blob_store(kind, pkg=tk, client=None):
    if kind == "inproc":
        return pkg.InProcBlobStore()
    return pkg.RedisBlobStore(client or FakeRedis(), namespace="t")


@pytest.mark.parametrize("kind", ("inproc", "fakeredis"))
def test_blob_store_contract(kind):
    """The same operations give the same results and stats on the port's
    store and the reference's."""
    seen = []
    for pkg in (rk, tk):
        b = _blob_store(kind, pkg)
        got = [b.get("k")]
        b.put("k", b"\x00\x01\xff")
        got.append(b.get("k"))
        b.put("k", b"v2")
        got.append(b.get("k"))
        b.put("sess:1", b"s")
        got.append(sorted(b.keys()))
        b.delete("k")
        got += [b.get("k"), b.keys()]
        b.delete("k")  # a missing key: a no-op
        got.append(b.stats())
        seen.append(got)
    assert seen[1] == seen[0]
    assert seen[1][:4] == [None, b"\x00\x01\xff", b"v2", ["k", "sess:1"]]
    assert seen[1][-1] == {"entries": 1, "puts": 3, "hits": 2, "misses": 2}


def test_redis_blob_store_namespaced_off_broker_keys():
    client = FakeRedis()
    b = tk.RedisBlobStore(client, namespace="t")
    b.put("prefix:abc", b"blob")
    client.set("t:queue:req", b"1")
    assert b.keys() == ["prefix:abc"]
    assert client.get("t:kv:prefix:abc") == b"blob"


# -- prefix blobs ---------------------------------------------------------------------


DTYPES = ("float32", "bfloat16", "int8")


# 32: two full blocks; 18: one and a 2-slot tail the encoder zero-fills.
@pytest.mark.parametrize("n", (32, 18))
@pytest.mark.parametrize("dtype", DTYPES)
def test_prefix_blob_equals_reference_and_roundtrips(dtype, n):
    """The port's blob of a prefix is the reference's, byte for byte; it
    decodes to the prefix (live slots bit-exact, ``build_prefix``'s
    bucket shape, zero pad); the reference decodes the port's blob and the
    port the reference's; the same tokens and tensors give the same blob."""
    jp, tp = _prefix_pair(dtype, n)
    payload = tk.encode_prefix(tp, block_size=16)
    assert payload == rk.encode_prefix(jp, block_size=16)
    rt = tk.decode_prefix(payload, max_seq_len=64, device="cpu")
    _assert_prefix_equal(rt, jp, n)
    assert rt.k.shape[1] == _bucket(n, 64)
    _assert_prefix_equal(rk.decode_prefix(payload, max_seq_len=64), jp, n)
    assert tk.encode_prefix(_prefix_pair(dtype, n)[1], block_size=16) == payload


@pytest.mark.parametrize("kv", sorted(KV))
def test_built_prefix_blob_bytes_equal_reference(engines, kv):
    """A prefix the JAX engine built (fp32; int8 with scales), converted
    to torch, encodes to the reference's bytes, and each package decodes
    the other's blob bit-exact; the port's own ``build_prefix`` has the
    same blob layout."""
    jeng, teng = engines(kv, **PAGED)
    jp = jeng.build_prefix(PFX_B)
    tp = TPrefix(tokens=jp.tokens, **{
        name: None if getattr(jp, name) is None
        else _torch(_np(getattr(jp, name))) for name in ARRAYS})
    payload = tk.encode_prefix(tp, 16)
    assert payload == rk.encode_prefix(jp, 16)
    _assert_prefix_equal(tk.decode_prefix(payload, max_seq_len=64,
                                          device="cpu"), jp, len(PFX_B))
    _assert_prefix_equal(rk.decode_prefix(payload, max_seq_len=64), jp,
                         len(PFX_B))
    own = decode_blocks(tk.encode_prefix(teng.build_prefix(PFX_B), 16))
    ref = decode_blocks(payload)
    for name in ARRAYS:
        assert (None if own[name] is None else own[name].shape) == (
            None if ref[name] is None else ref[name].shape)
    assert (own["tokens"], own["n_tokens"]) == (ref["tokens"], ref["n_tokens"])


@pytest.mark.parametrize("kind", ("inproc", "fakeredis"))
def test_demote_promote_through_both_tiers_bit_exact(kind):
    blob = _blob_store(kind)
    # T1 cap 0: the demotion spills straight to T2, so the promotion is a
    # blob-store fetch.
    store = tk.TieredKVStore(host=tk.HostKVStore(cap_bytes=0), blob=blob)
    jp, tp = _prefix_pair("bfloat16", 18)
    store.demote_prefix(tp, block_size=16)
    store.flush()
    assert store.host.keys() == []
    assert blob.keys() == [tk.prefix_key(tp.tokens)]
    got = store.fetch_prefix(list(tp.tokens), max_seq_len=64, device="cpu")
    _assert_prefix_equal(got, jp, 18)
    st = store.stats()
    assert st["prefix_demotes"] == 1 and st["prefix_promotes"] == 1
    assert st["prefix_demote_errors"] == 0


def test_failed_demote_is_counted():
    """A prefix the store cannot encode is a counted drop, never a raise
    on the caller's thread."""
    store = tk.TieredKVStore(blob=tk.InProcBlobStore())
    _, tp = _prefix_pair("float32", 18)
    store.demote_prefix(tp._replace(k=tp.k[:, :4]), block_size=16)
    store.flush()
    st = store.stats()
    assert st["prefix_demote_errors"] == 1 and st["prefix_demotes"] == 0
    assert store.host.keys() == []


def test_failed_park_raises_and_stores_nothing():
    """A park whose encode fails raises on the calling thread (the
    batcher's ``_maybe_park`` counts it as a drop, as in the reference) and
    leaves no blob and no count behind."""
    store = tk.TieredKVStore(blob=tk.InProcBlobStore())
    with pytest.raises(Exception):
        store.park_session("s", [1, 2], {"k": object()}, 16)
    assert store.stats()["sessions_parked"] == 0
    assert store.host.keys() == [] and store.blob.keys() == []


@pytest.mark.parametrize("corrupt", ("crc", "tokens"))
def test_corrupt_blob_deleted_never_adopted(corrupt):
    store = tk.TieredKVStore(host=tk.HostKVStore(cap_bytes=0),
                             blob=tk.InProcBlobStore())
    _, tp = _prefix_pair("float32", 18)
    store.demote_prefix(tp, block_size=16)
    store.flush()
    key = tk.prefix_key(tp.tokens)
    payload = store.blob.get(key)
    if corrupt == "crc":
        payload = payload[:-1] + bytes([payload[-1] ^ 1])
    else:  # a blob of other tokens under this key
        payload = tk.encode_prefix(tp._replace(tokens=tuple(range(2, 20))), 16)
    store.blob.put(key, payload)
    assert store.fetch_prefix(list(tp.tokens), max_seq_len=64,
                              device="cpu") is None
    assert store.blob.keys() == []
    assert store.stats()["prefix_promotes"] == 0


def test_session_resume_takes_only_on_proper_prefix():
    """A mismatched turn leaves the blob parked; a matching one takes it
    from every tier; a second resume finds nothing. The reference store
    answers the same calls the same way."""
    seen = []
    for pkg, pair in ((rk, 0), (tk, 1)):
        store = pkg.TieredKVStore(blob=pkg.InProcBlobStore())
        pfx = _prefix_pair("float32", 16)[pair]
        blocks, n = pkg.blocks_from_prefix(pfx, 16)
        store.park_session("s1", list(pfx.tokens), blocks, 16)
        got = [store.resume_session("s1", token_ids=[9] * 20),
               store.resume_session("s1", token_ids=list(pfx.tokens))]
        good = list(pfx.tokens) + [77, 78]
        hit = store.resume_session("s1", token_ids=good)
        got += [hit[0], store.resume_session("s1", token_ids=good)]
        store.flush()
        got.append(store.stats())
        seen.append(got)
    assert seen[1] == seen[0]
    assert seen[1][:2] == [None, None] and seen[1][3] is None
    assert seen[1][-1]["sessions_resumed"] == 1
    assert seen[1][-1]["sessions_parked"] == 1


@pytest.mark.parametrize("direction", ("port_to_reference",
                                       "reference_to_port"))
def test_redis_blob_stores_share_blobs_across_packages(direction):
    """A reference and a port store on one FakeRedis (T1 cap 0: straight
    to Redis) under the same keys: what one demotes the other promotes,
    what one parks the other resumes, bit-exact."""
    client = FakeRedis()

    def store(pkg):
        return pkg.TieredKVStore(host=pkg.HostKVStore(cap_bytes=0),
                                 blob=pkg.RedisBlobStore(client, "pqueue"))

    src, dst = (tk, rk) if direction == "port_to_reference" else (rk, tk)
    jp, tp = _prefix_pair("int8", 18)
    put_pfx, want = (tp, jp) if src is tk else (jp, jp)
    s = store(src)
    s.demote_prefix(put_pfx, 16)
    blocks, _ = src.blocks_from_prefix(put_pfx, 16)
    s.park_session("chat", list(put_pfx.tokens), blocks, 16)
    s.flush()
    assert sorted(k.decode() for k in client.scan_iter(
        match="pqueue:kv:*")) == sorted(
        [f"pqueue:kv:{tk.prefix_key(jp.tokens)}", "pqueue:kv:sess:chat"])
    d = store(dst)
    kw = dict(device="cpu") if dst is tk else {}
    _assert_prefix_equal(d.fetch_prefix(list(jp.tokens), max_seq_len=64,
                                        **kw), want, 18)
    toks, got = d.resume_session("chat", list(jp.tokens) + [1, 2])
    assert toks == list(jp.tokens)
    for name in ARRAYS:
        assert _np(got[name]).tobytes() == _np(blocks[name]).tobytes()
    assert client.get("pqueue:kv:sess:chat") is None  # taken


# -- the batcher ------------------------------------------------------------------------


def _refcounts(bat):
    return {b: bat.allocator.refcount(b) for b in range(bat.allocator.num_blocks)
            if bat.allocator.refcount(b)}


@pytest.mark.parametrize("kv", sorted(KV))
@pytest.mark.parametrize("mode", ("paged", "chunked"))
def test_promoted_install_refcounts_and_demotion_counters(engines, mode, kv):
    """A prefix demoted and promoted installs into the copy-on-write pool
    as a built one does: the JAX batcher's tokens (the built prefix's
    too), its refcounts once idle, and its eviction counters when the
    idle prefix is demoted, then when one is dropped without a hook."""
    ekw, bkw = MODES[mode]
    jeng, teng = engines(kv, **ekw)
    seen = []
    for eng, G, B, pkg, kw in ((jeng, JGen, JBatcher, rk, {}),
                               (teng, TGen, TBatcher, tk,
                                dict(device="cpu"))):
        store = pkg.TieredKVStore(blob=pkg.InProcBlobStore())
        m0 = eng.metrics.to_dict()
        built = eng.build_prefix(PFX_B)
        store.demote_prefix(built, 16)
        store.flush()
        promoted = store.fetch_prefix(PFX_B, max_seq_len=64, **kw)
        out = {}
        bat = B(eng, rows=2, chunk_steps=2, **bkw)
        for i, pfx in enumerate((promoted, promoted, built)):
            bat.submit(PFX_B + [30 + i], G(max_new_tokens=5),
                       lambda t, *a, i=i, **k: out.__setitem__(i, list(t)),
                       req_id=str(i), prefix=pfx)
        bat.run_until_idle()
        idle = (bat.allocator.blocks_in_use, _refcounts(bat))
        bat.demote_cb = lambda p, store=store: store.demote_prefix(p, 16)
        evicted = bat._paged_evict_idle_prefixes()
        store.flush()
        bat.submit(PFX_B + [40], G(max_new_tokens=3),
                   lambda t, *a, **k: out.__setitem__(3, list(t)),
                   req_id="3", prefix=built)
        bat.run_until_idle()
        bat.demote_cb = None
        evicted += bat._paged_evict_idle_prefixes()
        m = eng.metrics.to_dict()
        seen.append((out, idle, evicted, bat.allocator.blocks_in_use,
                     m["kv_evictions_demoted"] - m0["kv_evictions_demoted"],
                     m["kv_evictions_dropped"] - m0["kv_evictions_dropped"],
                     store.stats()["prefix_demotes"]))
    assert seen[1] == seen[0]
    out, idle, evicted = seen[1][:3]
    assert out[0] == teng.generate([PFX_B + [30]], TGen(max_new_tokens=5))[0]
    assert idle[0] == 2 and sorted(idle[1].values()) == [1, 1]
    assert evicted == 3
    assert seen[1][3:] == (0, 2, 1, 3)


def _park_run(B, G, eng, prompts, news, *, cancel=None, error=None,
              gc=1, cs=2, drain=False):
    """Requests with park interest through one batcher; ``cancel`` is
    cancelled after its first step, ``error`` finished with an error.
    Returns ({key: tokens}, [(req_id, tokens, nb)], park ids left)."""
    bat = B(eng, rows=len(prompts), chunk_steps=cs, group_chunks=gc)
    parked, out = [], {}
    bat.park_cb = lambda rid, toks, blocks: parked.append(
        (rid, list(toks), int(_np(blocks["k"]).shape[1])))
    for i, (p, n) in enumerate(zip(prompts, news)):
        bat.request_park(str(i), p)
        bat.submit(p, G(max_new_tokens=n),
                   lambda t, *a, i=i, **k: out.__setitem__(i, list(t)),
                   req_id=str(i))
    bat.step()
    bat.step()
    if cancel is not None:
        bat.cancel(str(cancel))
    if error is not None:
        row = next(i for i, r in bat.active.items() if r.req_id == str(error))
        bat._finish(row, bat.active[row], error="boom")
    if drain:
        bat.drain_all()
    bat.run_until_idle()
    return out, parked, dict(bat._park_ids)


@pytest.mark.parametrize("layout", ("dense", "paged"))
def test_cancelled_and_errored_rows_do_not_park(engines, layout):
    """Of three rows with park interest only the served one parks; its
    first (T-1)//bs full blocks and their tokens; no interest is left.
    The JAX batcher does the same."""
    jeng, teng = engines(**({} if layout == "dense" else PAGED))
    prompts = [list(range(3, 23)), [5, 9, 23, 4], list(range(40, 58))]
    runs = [_park_run(B, G, eng, prompts, (12, 30, 30), cancel=1, error=2)
            for B, G, eng in ((JBatcher, JGen, jeng),
                              (TBatcher, TGen, teng))]
    assert runs[1] == runs[0]
    out, parked, left = runs[1]
    assert [p[0] for p in parked] == ["0"] and left == {}
    seq = prompts[0] + out[0]
    assert parked[0][1] == seq[:16] and parked[0][2] == 1


@pytest.mark.parametrize("layout", ("dense", "paged"))
def test_park_skipped_near_the_ring_end(engines, layout):
    """A row whose group in flight could wrap the ring past slot 0 (T - 1
    + group_chunks * chunk_steps > max_seq_len) does not park; one just
    inside does; as in the JAX batcher."""
    jeng, teng = engines(**({} if layout == "dense" else PAGED))
    prompts = [list(range(1, 41)), list(range(1, 36))]
    news = (20, 20)  # T = 60 (59 + 8 > 64: skipped), T = 55 (54 + 8: parks)
    runs = [_park_run(B, G, eng, prompts, news, gc=2, cs=4)
            for B, G, eng in ((JBatcher, JGen, jeng),
                              (TBatcher, TGen, teng))]
    assert runs[1] == runs[0]
    parked = runs[1][1]
    assert [(p[0], p[2]) for p in parked] == [("1", 3)]


def test_drain_all_clears_park_interest(engines):
    jeng, teng = engines(**PAGED)
    runs = [_park_run(B, G, eng, [list(range(3, 23))], (12,), drain=True)
            for B, G, eng in ((JBatcher, JGen, jeng),
                              (TBatcher, TGen, teng))]
    assert runs[1] == runs[0] == ({}, [], {})


# -- the worker -------------------------------------------------------------------------


SESSION_PROMPTS = {"a": [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8],
                   "b": [2, 7, 1, 8, 2, 8, 1, 8, 2, 8]}
TURN_NEW = (8, 6, 5)
TURN_ADD = {"a": ([50, 51], [60, 61, 62]), "b": ([70], [80, 81])}


def _sessions(worker, broker, proto, n_turns=3, sids=("a", "b")):
    """Turns of each session through ``worker``, in rounds: every
    session's turn k is pushed together, and turn k+1 (turn k's prompt,
    its answer and a few new tokens) once the whole round is answered, so
    the schedule does not depend on when a held answer is released.
    Session "b" is seeded-sampled. Returns {(sid, k): tokens}."""
    def req(sid, k, ids):
        return proto.GenerateRequest(
            id=f"{sid}{k}", token_ids=ids, max_new_tokens=TURN_NEW[k],
            session_id=sid, turn=k,
            **(dict(is_greedy=False, temperature=0.8, top_k=20, seed=3)
               if sid == "b" else {}))

    prompts = {sid: list(SESSION_PROMPTS[sid]) for sid in sids}
    got = {}
    for k in range(n_turns):
        for sid in sids:
            broker.push_request(req(sid, k, prompts[sid]))
        for _ in range(2000):
            worker.run_once()
            for sid in sids:
                if (sid, k) not in got:
                    a = broker.wait_response(f"{sid}{k}", timeout=0.0)
                    if a is not None:
                        assert a.error is None, a.error
                        got[(sid, k)] = list(a.token_ids)
            if all((sid, k) in got for sid in sids):
                break
        else:
            raise AssertionError(f"sessions unanswered: {sorted(got)}")
        if k + 1 < n_turns:
            for sid in sids:
                prompts[sid] += got[(sid, k)] + TURN_ADD[sid][k]
    return got


def _worker(W, eng, broker, store, **kw):
    return W(eng, broker, rows=2, chunk_steps=2, group_chunks=1,
             poll_timeout_s=0.0, kvstore=store, **kw)


@pytest.mark.parametrize("kv", sorted(KV))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_session_park_resume_equals_reference(engines, mode, kv):
    """Two sessions of three turns each: turns 2 and 3 resume from the
    parked KV. The port's tokens equal the reference worker's and its own
    without a store; its stats equal the reference store's; the session
    blob ends parked once per session."""
    ekw, wkw = MODES[mode]
    jeng, teng = engines(kv, **ekw)
    js = rk.TieredKVStore(blob=rk.InProcBlobStore())
    ts = tk.TieredKVStore(blob=tk.InProcBlobStore())
    jb, tb = JBroker(), TBroker()
    jw = _worker(JWorker, jeng, jb, js, **wkw)
    want = _sessions(jw, jb, rproto)
    tw = _worker(TWorker, teng, tb, ts, **wkw)
    got = _sessions(tw, tb, tproto)
    nb = TBroker()
    plain = _sessions(_worker(TWorker, teng, nb, None, **wkw), nb, tproto)
    js.flush()
    ts.flush()
    assert got == want
    assert got == plain
    assert _counts(ts.stats()) == _counts(js.stats())
    st = ts.stats()
    assert (st["sessions_parked"], st["sessions_resumed"]) == (6, 4)
    assert st["reprefill_tokens_avoided"] > 0
    assert sorted(ts.host.keys()) == ["sess:a", "sess:b"]
    assert tw.load_snapshot()["kv_tiers"] == st
    assert not tw._park_sessions and not tw.batcher._park_ids
    assert tw.batcher.park_failures == 0
    if ekw:
        # A resumed turn's prefix stays registered in the pool, idle, as in
        # the reference, until the pool needs its blocks.
        bat = tw.batcher
        assert bat.allocator.blocks_in_use == sum(
            len(b) for _, b in bat._paged_prefixes.values())
        assert bat.allocator.blocks_in_use == jw.batcher.allocator.blocks_in_use


def test_answer_pushed_after_its_park(engines):
    """A parked turn is encoded on the serving thread before its answer,
    as in the reference: when the answer reaches the broker the blob is
    already in the store."""
    _, teng = engines(**PAGED)
    store = tk.TieredKVStore(host=tk.HostKVStore(cap_bytes=0),
                             blob=tk.InProcBlobStore())
    b = TBroker()
    w = _worker(TWorker, teng, b, store)
    seen = []
    push = b.push_response

    def recording(resp):
        seen.append((resp.id, store.blob.keys()))
        push(resp)

    b.push_response = recording
    b.push_request(tproto.GenerateRequest(
        id="t", token_ids=list(range(3, 23)), max_new_tokens=6,
        session_id="s"))
    for _ in range(200):
        w.run_once()
        if w.batcher.idle:
            break
    assert seen == [("t", ["sess:s"])]
    a = b.wait_response("t", timeout=10)
    assert a is not None and a.error is None
    assert store.stats()["sessions_parked"] == 1
    w.begin_drain()
    assert w.drained


def test_session_resume_survives_t1_cap_zero(engines):
    """T1 capped at 0: every park goes to the blob store and every resume
    comes back from it; the same tokens and stats as the reference's."""
    jeng, teng = engines(**PAGED)
    seen = []
    for W, eng, B, proto, pkg in ((JWorker, jeng, JBroker, rproto, rk),
                                  (TWorker, teng, TBroker, tproto, tk)):
        blob = pkg.InProcBlobStore()
        store = pkg.TieredKVStore(host=pkg.HostKVStore(cap_bytes=0),
                                  blob=blob)
        b = B()
        got = _sessions(_worker(W, eng, b, store), b, proto)
        store.flush()
        seen.append((got, _counts(store.stats())))
    assert seen[1] == seen[0]
    st = seen[1][1]
    # Each T2 hit warms T1, which spills it again at cap 0: 6 parks and
    # 4 re-warms.
    assert st["sessions_resumed"] == 4 and st["t2"]["puts"] == 10
    assert st["t1"]["entries"] == 0 and st["t2"]["hits"] == 4


def _prefix_schedule(worker, broker, store, proto, flush=True):
    """Requests on PFX_A / PFX_B one at a time through a worker whose LRU
    keeps one prefix (and, paged, a 3-block pool): every switch demotes
    the other prefix from the LRU, pool evictions demote idle ones, and
    every return promotes. The store is flushed between requests (a
    demotion lands on the store's thread). Returns the tokens."""
    worker.max_prefixes = 1
    plan = [(PFX_A, [90, 91], None), (PFX_B, [92], None),
            (PFX_A, [93, 94, 95], None),
            (PFX_B, [96], dict(is_greedy=False, temperature=0.9, top_k=8,
                               seed=4)),
            (PFX_A, [97], None)]
    got = []
    for i, (pfx, suf, samp) in enumerate(plan):
        req = proto.GenerateRequest(id=f"p{i}", token_ids=pfx + suf,
                                    max_new_tokens=6,
                                    prefix_token_ids=list(pfx),
                                    **(samp or {}))
        broker.push_request(req)
        for _ in range(500):
            worker.run_once()
            a = broker.wait_response(req.id, timeout=0.0)
            if a is not None:
                break
        assert a is not None and a.error is None, a
        got.append(list(a.token_ids))
        if store is not None and flush:
            store.flush()
    return got


@pytest.mark.parametrize("kv", sorted(KV))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_worker_demote_promote_equals_reference(engines, mode, kv):
    """The LRU's and the pool's evictions demote, the LRU's misses
    promote: the reference worker's tokens, stats and eviction counters,
    and the port's tokens without a store (where every miss builds)."""
    ekw, wkw = MODES[mode]
    if ekw:
        ekw = {**ekw, "kv_blocks": 3}
    jeng, teng = engines(kv, **ekw)
    seen = []
    for W, eng, B, proto, pkg in ((JWorker, jeng, JBroker, rproto, rk),
                                  (TWorker, teng, TBroker, tproto, tk)):
        store = pkg.TieredKVStore(blob=pkg.InProcBlobStore())
        b = B()
        w = _worker(W, eng, b, store, **wkw)
        m0 = eng.metrics.to_dict()
        got = _prefix_schedule(w, b, store, proto)
        m = eng.metrics.to_dict()
        seen.append((got, _counts(store.stats()),
                     m["kv_evictions_demoted"] - m0["kv_evictions_demoted"],
                     m["kv_evictions_dropped"] - m0["kv_evictions_dropped"]))
    assert seen[1] == seen[0]
    b = TBroker()
    plain = _prefix_schedule(_worker(TWorker, teng, b, None, **wkw), b, None,
                             tproto)
    assert seen[1][0] == plain
    st = seen[1][1]
    assert st["prefix_promotes"] == 3 and st["prefix_demote_errors"] == 0
    assert st["prefix_demotes"] >= 4
    assert seen[1][3] == 0 and (seen[1][2] > 0) == bool(ekw)


@pytest.mark.parametrize("direction", ("port_to_port", "port_to_reference",
                                       "reference_to_port"))
def test_second_worker_promotes_what_the_first_demoted(engines, direction):
    """Two workers, each with its own store over one blob store (T1 cap 0,
    so demotions reach it): the first serves PFX_A then PFX_B (its LRU of
    one demotes PFX_A), the second serves PFX_A's request by promotion,
    without building, with the first's tokens."""
    jeng, teng = engines(**PAGED)
    client = FakeRedis()
    side = {"port": (TWorker, teng, TBroker, tproto, tk),
            "reference": (JWorker, jeng, JBroker, rproto, rk)}
    first, second = (side[x] for x in direction.split("_to_"))

    def worker(W, eng, B, proto, pkg):
        store = pkg.TieredKVStore(host=pkg.HostKVStore(cap_bytes=0),
                                  blob=pkg.RedisBlobStore(client, "pqueue"))
        b = B()
        w = _worker(W, eng, b, store)
        w.max_prefixes = 1
        return w, b, store, proto

    def ask(w, b, proto, rid, ids, pfx):
        b.push_request(proto.GenerateRequest(
            id=rid, token_ids=ids, max_new_tokens=6, prefix_token_ids=pfx))
        for _ in range(500):
            w.run_once()
            a = b.wait_response(rid, timeout=0.0)
            if a is not None:
                assert a.error is None
                return list(a.token_ids)

    w1, b1, s1, p1 = worker(*first)
    want = ask(w1, b1, p1, "x", PFX_A + [90], list(PFX_A))
    ask(w1, b1, p1, "y", PFX_B + [91], list(PFX_B))
    s1.flush()
    w2, b2, s2, p2 = worker(*second)
    eng2 = w2.engine
    built = []
    build = eng2.build_prefix
    eng2.build_prefix = lambda ids: built.append(ids) or build(ids)
    try:
        got = ask(w2, b2, p2, "z", PFX_A + [90], list(PFX_A))
    finally:
        del eng2.build_prefix
    assert got == want and built == []
    assert s2.stats()["prefix_promotes"] == 1


def _roles(eng, broker, store, role):
    return TWorker(eng, broker, rows=2, chunk_steps=2, poll_timeout_s=0.0,
                   role=role, kvstore=store)


def test_decode_role_parks_prefill_role_never(engines):
    """A prefill-role and a decode-role worker, each with a store over one
    blob store (T1 cap 0): the decode worker parks each turn of a session
    from its adopted rows, the prefill worker never parks but resumes the
    next turn from the blob; the answers equal a unified worker's without
    a store."""
    _, teng = engines(**PAGED)
    blob = tk.InProcBlobStore()
    stores = {r: tk.TieredKVStore(host=tk.HostKVStore(cap_bytes=0), blob=blob)
              for r in ("prefill", "decode")}
    broker = TBroker()
    pre = _roles(teng, broker, stores["prefill"], "prefill")
    dec = _roles(teng, broker, stores["decode"], "decode")

    class Both:
        def run_once(self):
            pre.run_once()
            dec.run_once()
            stores["decode"].flush()

    got = _sessions(Both(), broker, tproto, sids=("a",))
    nb = TBroker()
    want = _sessions(_worker(TWorker, teng, nb, None), nb, tproto, sids=("a",))
    assert got == want
    sp, sd = (stores[r].stats() for r in ("prefill", "decode"))
    assert sp["sessions_parked"] == 0 and sd["sessions_parked"] == 3
    assert sp["sessions_resumed"] == 2 and sd["sessions_resumed"] == 0
    assert broker.delivery_stats()["handoffs"] == 3
    assert not pre.batcher._park_ids and not dec.batcher._park_ids


def test_submit_error_withdraws_park_interest(engines):
    """A session request the batcher refuses (it would overflow the ring)
    is answered with the error and leaves no park interest behind."""
    _, teng = engines(**PAGED)
    broker = TBroker()
    w = _worker(TWorker, teng, broker, tk.TieredKVStore())
    broker.push_request(tproto.GenerateRequest(
        id="big", token_ids=list(range(1, 60)), max_new_tokens=20,
        session_id="s"))
    w.run_once()
    a = broker.wait_response("big", timeout=0.0)
    assert a is not None and a.error
    assert not w._park_sessions and not w.batcher._park_ids


# -- consumer.main --------------------------------------------------------------------


def _write_checkpoint(path):
    """A 1-layer llama checkpoint in HF names."""
    E, V, I = 32, 64, 64
    g = torch.Generator().manual_seed(0)

    def w(*s):
        return torch.randn(s, generator=g) * 0.05

    p = "model.layers.0"
    save_file({
        "model.embed_tokens.weight": w(V, E), "model.norm.weight": 1 + w(E),
        "lm_head.weight": w(V, E),
        f"{p}.input_layernorm.weight": 1 + w(E),
        f"{p}.post_attention_layernorm.weight": 1 + w(E),
        f"{p}.self_attn.q_proj.weight": w(E, E),
        f"{p}.self_attn.k_proj.weight": w(E, E),
        f"{p}.self_attn.v_proj.weight": w(E, E),
        f"{p}.self_attn.o_proj.weight": w(E, E),
        f"{p}.mlp.gate_proj.weight": w(I, E),
        f"{p}.mlp.up_proj.weight": w(I, E),
        f"{p}.mlp.down_proj.weight": w(E, I),
    }, str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps({
        "model_type": "llama", "vocab_size": V, "hidden_size": E,
        "num_hidden_layers": 1, "num_attention_heads": 2,
        "num_key_value_heads": 2, "intermediate_size": I,
        "max_position_embeddings": 64, "hidden_act": "silu",
        "rms_norm_eps": 1e-5, "tie_word_embeddings": False,
    }))


def test_consumer_main_kv_tier_host_mb(tmp_path, monkeypatch):
    """``main --continuous --kv_tier_host_mb 0`` over a Redis client (the
    ``redis`` module replaced by one that hands out a FakeRedis) builds a
    tiered store on the broker's client: two turns of a session are
    answered with the tokens of a worker without a store, the second
    resumed from the blob under the reference's key
    ``pqueue:kv:sess:{id}``, and the published worker snapshot carries
    ``kv_tiers``; a SIGTERM drains the worker."""
    _write_checkpoint(tmp_path)
    server = FakeRedis()
    monkeypatch.setitem(sys.modules, "redis", types.SimpleNamespace(
        Redis=lambda host, port: server))
    client = RedisBroker(client=server, worker_id="client")
    got = {}
    turn1 = list(range(3, 23))

    def drive():
        try:
            client.push_request(tproto.GenerateRequest(
                id="t1", token_ids=turn1, max_new_tokens=6,
                session_id="chat"))
            got["t1"] = client.wait_response("t1", timeout=60)
            got["parked"] = server.get("pqueue:kv:sess:chat") is not None
            got["p2"] = turn1 + list(got["t1"].token_ids) + [7, 8]
            client.push_request(tproto.GenerateRequest(
                id="t2", token_ids=got["p2"], max_new_tokens=6,
                session_id="chat"))
            got["t2"] = client.wait_response("t2", timeout=60)
            for _ in range(100):
                snap = client.read_metrics().get("worker", {})
                if snap.get("kv_tiers", {}).get("sessions_resumed"):
                    break
                threading.Event().wait(0.05)
            got["snap"] = snap
        finally:
            os.kill(os.getpid(), signal.SIGTERM)

    previous = signal.signal(signal.SIGTERM, lambda *a: None)
    th = threading.Thread(target=drive, daemon=True)
    try:
        th.start()
        consumer_main([
            "--pretrained_model_path", str(tmp_path), "--device", "cpu",
            "--dtype", "float32", "--continuous", "--supervise",
            "--kv_layout", "paged", "--max_seq_len", "64",
            "--batch_size", "2", "--chunk_steps", "2",
            "--kv_tier_host_mb", "0", "--drain_timeout_s", "10",
        ])
        th.join(timeout=15)
    finally:
        signal.signal(signal.SIGTERM, previous)
    assert not th.is_alive()
    assert got["t1"].error is None and got["t2"].error is None
    assert got["parked"]
    from llmss_tpu_torch.models.registry import load_model

    cfg, params = load_model(tmp_path, device="cpu", dtype="float32")
    eng = TEngine(cfg, params, device="cpu", max_seq_len=64)
    gen = TGen(max_new_tokens=6)
    assert got["t1"].token_ids == eng.generate([turn1], gen)[0]
    assert got["t2"].token_ids == eng.generate([got["p2"]], gen)[0]
    tiers = got["snap"]["kv_tiers"]
    assert tiers["sessions_resumed"] == 1
    assert tiers["reprefill_tokens_avoided"] == 16
    assert tiers["t1"]["cap_bytes"] == 0 and tiers["t2"]["puts"] >= 1


def test_kv_tier_flag_requires_continuous(capsys):
    with pytest.raises(SystemExit):
        consumer_main(["--pretrained_model_path", "x",
                       "--kv_tier_host_mb", "64"])
    assert "requires --continuous" in capsys.readouterr().err
