"""Shared-prefix reuse in the torch port, on the CPU, against the JAX
package: ``DecodeEngine.build_prefix`` / ``generate(prefix=)``, the
continuous batcher's ``submit(prefix=)`` with copy-on-write prefix blocks
over the paged pool, and ``ContinuousWorker`` serving ``prefix_token_ids``.

The reference's own tests are mirrored case by case
(``tests/test_prefix.py``; ``tests/test_paged.py``'s COW, eviction and
bucket-shape tests; ``tests/test_ragged.py``'s chunked-vs-split under a
shared prefix), over the dense and paged layouts, split and chunked
admission, fp32 and int8 caches. What is compared:

- greedy and seeded-sampled tokens: equal to the JAX package's, and, on an
  fp32 cache, to a prefill from scratch;
- ``Prefix.k`` / ``v``: within 1e-5 of the JAX package's, at the same
  bucket-padded length; int8 storage equal but for at most 0.1% of entries,
  by at most 1 (fp32 rounding of the fresh K/V may cross a rounding
  boundary), scales to rtol 1e-5;
- ``blocks_in_use`` and every block's refcount after every batcher step,
  and the eviction counters: equal to the JAX batcher's;
- int8 prefix bits: the same on every reuse.

Tiny fp32 llama, parameters from the JAX ``init_params`` through
``convert.params_from_jax``. The port's pool holds one block more than the
reference's (block N, where dropped writes land)."""

import time

import jax
import numpy as np
import pytest
import torch

from llmss_tpu.engine import DecodeEngine as JEngine
from llmss_tpu.engine import GenerationParams as JGen
from llmss_tpu.engine.scheduler import ContinuousBatcher as JBatcher
from llmss_tpu.models import decoder as jdec
from llmss_tpu.models.common import DecoderConfig as JCfg
from llmss_tpu.parallel import MeshPlan, make_mesh
from llmss_tpu.serve.broker import InProcBroker as JBroker
from llmss_tpu.serve.consumer import ContinuousWorker as JWorker
from llmss_tpu.serve.protocol import GenerateRequest as JRequest
from llmss_tpu_torch.convert import params_from_jax
from llmss_tpu_torch.engine import cache as tc
from llmss_tpu_torch.engine.engine import DecodeEngine as TEngine
from llmss_tpu_torch.engine.engine import GenerationParams as TGen
from llmss_tpu_torch.engine.engine import _bucket
from llmss_tpu_torch.engine.scheduler import ContinuousBatcher as TBatcher
from llmss_tpu_torch.models.common import DecoderConfig as TCfg
from llmss_tpu_torch.serve.broker import InProcBroker
from llmss_tpu_torch.serve.consumer import ContinuousWorker
from llmss_tpu_torch.serve.protocol import GenerateRequest

CFG = dict(model_type="llama", vocab_size=128, hidden_size=64, n_layers=2,
           n_heads=4, n_kv_heads=2, head_dim=16, intermediate_size=96,
           max_position_embeddings=64, activation="silu", norm="rmsnorm",
           mlp="swiglu", positions="rotary", rope_style="half",
           attn_bias=False, mlp_bias=False, dtype="float32")
PREFIX = [7, 3, 19, 42, 5, 11, 30, 2, 9, 17, 28, 33, 21, 6, 13, 40, 8, 25]
LAYOUTS = {"dense": {}, "paged": dict(kv_layout="paged", block_size=8)}
# Batcher modes: (engine layout, batcher keywords).
MODES = {"dense": ("dense", {}), "paged": ("paged", {}),
         "chunked": ("paged", dict(chunked_prefill=4))}
KV = {"fp32": None, "int8": "int8"}


@pytest.fixture(scope="module")
def model():
    mesh = make_mesh(MeshPlan(dp=1, tp=1), devices=jax.devices()[:1])
    jp = jdec.init_params(JCfg(**CFG), mesh, jax.random.key(0))
    return mesh, jp, params_from_jax(jax.device_get(jp))


@pytest.fixture(scope="module")
def engines(model):
    """(JAX engine, port engine) per (layout, kv), built once: each JAX
    engine compiles its programs on first use."""
    mesh, jp, tp = model
    made = {}

    def get(layout, kv="fp32", **kw):
        key = (layout, kv, tuple(sorted(kw.items())))
        if key not in made:
            ekw = {"max_seq_len": 64, "kv_dtype": KV[kv], **LAYOUTS[layout],
                   **kw}
            made[key] = (JEngine(JCfg(**CFG), jp, mesh, **ekw),
                         TEngine(TCfg(**CFG), tp, device="cpu", **ekw))
        return made[key]

    return get


def _gens(G, n=12):
    return [G(max_new_tokens=n),
            G(max_new_tokens=n, is_greedy=False, temperature=0.9, top_k=8,
              seed=4)]


def _np(x):
    return np.asarray(x.cpu() if torch.is_tensor(x) else jax.device_get(x))


def _assert_int8_close(got, want):
    """int8 storage: equal but for at most 0.1% of entries, by at most 1."""
    diff = np.abs(_np(got).astype(np.int32) - _np(want).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def _submit_all(bat, items, out):
    """Submit ``(key, prompt, gen, prefix)`` items; tokens land in ``out``."""
    for key, p, g, pfx in items:
        bat.submit(p, g, lambda t, *a, key=key, **k: out.__setitem__(key, t),
                   req_id=str(key), prefix=pfx)


# -- the engine ----------------------------------------------------------------


@pytest.mark.parametrize("kv", sorted(KV))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_engine_prefix_identical_tokens_and_skipped_prefill(engines, layout,
                                                            kv):
    """``generate(prefix=)`` gives JAX's tokens, greedy and seeded-sampled;
    on fp32 also the tokens of a prefill from scratch. The prefill saw only
    the suffixes, padded to the suffix bucket (4 -> 16), not the full
    prompts' (22 -> 32)."""
    jeng, teng = engines(layout, kv)
    jp, tp = jeng.build_prefix(PREFIX), teng.build_prefix(PREFIX)
    prompts = [PREFIX + [50, 51], PREFIX + [60], PREFIX + [1, 2, 3, 4]]
    for jg, tg in zip(_gens(JGen), _gens(TGen)):
        want = jeng.generate(prompts, jg, chunk_steps=4, prefix=jp)
        calls = []
        orig = teng._prefill

        def spy(ids, cache, lens, sa, start=None):
            calls.append((tuple(ids.shape), None if start is None
                          else start.tolist()))
            return orig(ids, cache, lens, sa, start)

        teng._prefill = spy
        try:
            got = teng.generate(prompts, tg, chunk_steps=4, prefix=tp)
        finally:
            del teng._prefill
        assert got == want
        assert calls == [((3, 16), [18] * 3)]
        if kv == "fp32":
            assert got == teng.generate(prompts, tg, chunk_steps=4)


@pytest.mark.parametrize("kv", sorted(KV))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_build_prefix_matches_jax(engines, layout, kv):
    """The retained segment equals JAX's over its whole bucket-padded
    length (fp32: within 1e-5; int8: storage as the module says, scales
    rtol 1e-5), with the prefix tokens."""
    jeng, teng = engines(layout, kv)
    jp, tp = jeng.build_prefix(PREFIX), teng.build_prefix(PREFIX)
    assert tp.tokens == tuple(PREFIX) and tp.length == len(PREFIX)
    assert tuple(tp.k.shape) == tuple(jp.k.shape) == (2, 32, 2, 16)
    P = tp.k.shape[1]  # the pad slots too: both wrote the padded columns
    for a, b in ((tp.k, jp.k), (tp.v, jp.v)):
        if kv == "int8":
            assert a.dtype == torch.int8
            _assert_int8_close(a[:, :P], b[:, :P])
        else:
            np.testing.assert_allclose(_np(a)[:, :P], _np(b)[:, :P],
                                       rtol=1e-5, atol=1e-5)
    if kv == "int8":
        for a, b in ((tp.k_scale, jp.k_scale), (tp.v_scale, jp.v_scale)):
            np.testing.assert_allclose(_np(a)[:, :P], _np(b)[:, :P],
                                       rtol=1e-5)
    else:
        assert tp.k_scale is None and tp.v_scale is None


@pytest.mark.parametrize("plen", [5, 7, 20])
def test_build_prefix_keeps_bucket_shape(engines, plen):
    """The segment keeps the prefill bucket's padded length, as the
    reference's does (one seed shape per bucket)."""
    jeng, teng = engines("dense")
    tp = teng.build_prefix(list(range(1, plen + 1)))
    assert tp.length == plen
    assert tp.k.shape[1] == _bucket(plen, 64) == \
        jeng.build_prefix(list(range(1, plen + 1))).k.shape[1]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_engine_prefix_validation(engines, layout):
    _, eng = engines(layout)
    pfx = eng.build_prefix(PREFIX)
    gen = TGen(max_new_tokens=4)
    with pytest.raises(ValueError, match="extend the prefix"):
        eng.generate([[1, 2, 3]], gen, prefix=pfx)  # wrong tokens
    with pytest.raises(ValueError, match="extend the prefix"):
        eng.generate([list(PREFIX)], gen, prefix=pfx)  # no suffix
    with pytest.raises(ValueError, match="prefix length"):
        eng.build_prefix([])
    with pytest.raises(ValueError, match="prefix length"):
        eng.build_prefix([1] * 64)
    long_pfx = eng.build_prefix(list(range(1, 61)))
    with pytest.raises(ValueError, match="exceeds"):
        eng.generate([list(range(1, 61)) + [9] * 10], gen, prefix=long_pfx)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_engine_prefix_near_ring_falls_back_to_scratch(engines, layout):
    """A request that fits but whose bucket-padded suffix would wrap onto
    the seeded slots is prefilled from scratch (the full prompt, bucket
    64): JAX's tokens, which are the scratch tokens."""
    jeng, teng = engines(layout)
    long_prefix = list(range(1, 53))
    prompts = [long_prefix + [60, 61, 62, 63]]
    gen = (JGen(max_new_tokens=6), TGen(max_new_tokens=6))
    want = jeng.generate(prompts, gen[0], chunk_steps=2,
                         prefix=jeng.build_prefix(long_prefix))
    calls = []
    orig = teng._prefill

    def spy(ids, cache, lens, sa, start=None):
        calls.append((tuple(ids.shape), start))
        return orig(ids, cache, lens, sa, start)

    pfx = teng.build_prefix(long_prefix)
    teng._prefill = spy
    try:
        got = teng.generate(prompts, gen[1], chunk_steps=2, prefix=pfx)
    finally:
        del teng._prefill
    assert got == want == teng.generate(prompts, gen[1], chunk_steps=2)
    assert calls == [((1, 64), None)]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_prefix_int8_storage_stable(engines, layout):
    """An int8 engine keeps the prefix quantized; every reuse seeds the
    same bits into the rows (read back from the cache), and gives the same
    tokens."""
    _, eng = engines(layout, "int8")
    pfx = eng.build_prefix(PREFIX)
    assert pfx.k.dtype == torch.int8 and pfx.k_scale is not None
    bits = [t.clone() for t in (pfx.k, pfx.v, pfx.k_scale, pfx.v_scale)]
    prompts = [PREFIX + [50, 51], PREFIX + [60]]
    runs = []
    for _ in range(2):
        runs.append(eng.generate(prompts, TGen(max_new_tokens=8), prefix=pfx))
        cache, P = eng._cache, len(PREFIX)
        for row in range(2):
            for buf, want in zip((cache.k, cache.v, cache.k_scale,
                                  cache.v_scale), bits):
                if layout == "paged":
                    seg = torch.stack([tc.gather_block_view(
                        layer, cache.block_tables[row:row + 1])[0, :P]
                        for layer in buf])
                else:
                    seg = buf[:, row, :P]
                assert torch.equal(seg, want[:, :P])
    assert runs[0] == runs[1]
    for t, b in zip((pfx.k, pfx.v, pfx.k_scale, pfx.v_scale), bits):
        assert torch.equal(t, b)


# -- the batcher -----------------------------------------------------------------


@pytest.mark.parametrize("kv", sorted(KV))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_scheduler_prefix_matches_jax(engines, mode, kv):
    """Prefix requests mixed with plain ones in one queue, greedy and
    seeded-sampled, through three rows: JAX's tokens; on fp32 also each
    request's solo tokens; the pool back to the prefix's full blocks."""
    layout, bkw = MODES[mode]
    jeng, teng = engines(layout, kv)
    outs = []
    for eng, G, B in ((jeng, JGen, JBatcher), (teng, TGen, TBatcher)):
        pfx = eng.build_prefix(PREFIX)
        g, s = _gens(G, 10)
        items = [(0, PREFIX + [50, 51], g, pfx), (1, [5, 9, 23], g, None),
                 (2, PREFIX + [60], s, pfx), (3, PREFIX + [1, 2, 3, 4], g, pfx),
                 (4, [40, 41, 42], s, None)]
        bat = B(eng, rows=3, chunk_steps=2, group_chunks=2, **bkw)
        out = {}
        _submit_all(bat, items, out)
        bat.run_until_idle()
        outs.append(out)
        if layout == "paged":
            assert bat.allocator.blocks_in_use == len(PREFIX) // 8
    assert outs[1] == outs[0]
    if kv == "fp32":
        g, s = _gens(TGen, 10)
        solo = [teng.generate([p], x)[0] for p, x in (
            (PREFIX + [50, 51], g), ([5, 9, 23], g), (PREFIX + [60], s),
            (PREFIX + [1, 2, 3, 4], g), ([40, 41, 42], s))]
        assert [outs[1][i] for i in range(5)] == solo


def test_scheduler_prefix_submit_validation(engines):
    _, eng = engines("dense")
    pfx = eng.build_prefix(PREFIX)
    b = TBatcher(eng, rows=2)
    with pytest.raises(ValueError, match="extend the prefix"):
        b.submit([1, 2], TGen(max_new_tokens=2), lambda t: None, prefix=pfx)
    with pytest.raises(ValueError, match="extend the prefix"):
        b.submit(list(PREFIX), TGen(max_new_tokens=2), lambda t: None,
                 prefix=pfx)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_scheduler_prefix_near_ring_admits_without_prefix(engines, mode):
    """A submit whose bucket-padded suffix would wrap is admitted without
    the prefix; a safe prefix request beside it keeps its seeded admission.
    Both get JAX's tokens, which are their solo tokens."""
    layout, bkw = MODES[mode]
    jeng, teng = engines(layout)
    long_prefix = list(range(1, 53))
    outs = []
    for eng, G, B in ((jeng, JGen, JBatcher), (teng, TGen, TBatcher)):
        gen = G(max_new_tokens=6)
        bat = B(eng, rows=2, chunk_steps=2, **bkw)
        out = {}
        _submit_all(bat, [
            ("wrap", long_prefix + [60, 61, 62, 63], gen,
             eng.build_prefix(long_prefix)),
            ("safe", PREFIX + [50, 51], gen, eng.build_prefix(PREFIX))], out)
        bat.run_until_idle()
        outs.append(out)
    assert outs[1] == outs[0]
    solo = teng.generate([long_prefix + [60, 61, 62, 63], PREFIX + [50, 51]],
                         TGen(max_new_tokens=6))
    assert [outs[1]["wrap"], outs[1]["safe"]] == solo


def _refcounts(bat):
    return [bat.allocator.refcount(b) for b in range(bat.allocator.num_blocks)]


@pytest.mark.parametrize("chunked", [False, True], ids=["split", "chunked"])
def test_shared_prefix_cow_no_per_row_copies(engines, chunked):
    """Rows sharing a prefix hold ONE copy of its full block, refcounted,
    and each its own tail block (copy-on-write). After every step the
    block count and every block's refcount equal the JAX batcher's; the
    tokens equal the dense engine's; once idle only the registry's block
    remains."""
    pfx_tokens = list(range(1, 21))  # 20 tokens: 1 full block + a tail
    full = [pfx_tokens + [30 + i] for i in range(3)]
    bkw = dict(rows=4, chunked_prefill=4 if chunked else None)
    (jeng, teng), (_, dense) = (engines("paged", block_size=16),
                                engines("dense"))
    expected = [dense.generate([p], TGen(max_new_tokens=5))[0] for p in full]
    bats, outs = [], []
    for eng, G, B in ((jeng, JGen, JBatcher), (teng, TGen, TBatcher)):
        pfx = eng.build_prefix(pfx_tokens)
        bat = B(eng, **bkw)
        out = {}
        _submit_all(bat, [(i, p, G(max_new_tokens=5), pfx)
                          for i, p in enumerate(full)], out)
        bats.append(bat)
        outs.append(out)
    steps = 0
    while not (bats[0].idle and bats[1].idle):
        for b in bats:
            b.step()
        steps += 1
        assert bats[1].allocator.blocks_in_use == bats[0].allocator.blocks_in_use
        assert _refcounts(bats[1]) == _refcounts(bats[0])
        if steps == 1:
            # ceil((21 + 5) / 16) = 2 blocks a row, 1 of them shared:
            # 1 + 3 * 1, where copies per row would hold 6.
            assert bats[1].allocator.blocks_in_use == 1 + 3 * 1
            shared = bats[1]._row_shared[next(iter(bats[1]._row_shared))]
            assert [bats[1].allocator.refcount(b) for b in shared] == [4]
    assert [outs[1][i] for i in range(3)] == expected == \
        [outs[0][i] for i in range(3)]
    assert bats[1].allocator.blocks_in_use == 1
    assert teng.metrics.to_dict()["kv_blocks_in_use"] == 1


@pytest.mark.parametrize("chunked", [False, True], ids=["split", "chunked"])
def test_prefix_eviction_under_pressure(engines, chunked):
    """An idle registered prefix is evicted when a request cannot
    otherwise fit the pool: the same eviction counts and block counts as
    the JAX batcher's, under the reference's metric names."""
    jeng, teng = engines("paged", block_size=16, kv_blocks=4)
    got = []
    for eng, G, B in ((jeng, JGen, JBatcher), (teng, TGen, TBatcher)):
        eng.metrics = type(eng.metrics)()
        pfx = eng.build_prefix(list(range(1, 18)))  # 1 full block
        bat = B(eng, rows=2, chunked_prefill=4 if chunked else None)
        r = {}
        bat.submit(list(range(1, 18)) + [40], G(max_new_tokens=4),
                   lambda t, *a, **k: r.__setitem__("a", t), prefix=pfx)
        bat.run_until_idle()
        held = bat.allocator.blocks_in_use
        # 4-block pool, 1 held by the idle prefix: this needs all 4.
        bat.submit([9] * 40, G(max_new_tokens=24),
                   lambda t, *a, **k: r.__setitem__("b", t))
        bat.run_until_idle()
        m = eng.metrics.to_dict()
        got.append((held, r, bat.allocator.evictions,
                    bat.allocator.blocks_in_use, m["kv_block_evictions"],
                    m["kv_evictions_demoted"], m["kv_evictions_dropped"]))
    assert got[1] == got[0]
    assert got[1][0] == 1 and len(got[1][1]["b"]) == 24
    assert got[1][2:] == (1, 0, 1, 0, 1)


@pytest.mark.parametrize("kv", sorted(KV))
def test_scheduler_shared_prefix_chunked_matches_split(engines, kv):
    """A full shared block plus a 5-token tail: chunked admission re-feeds
    only the unshared span, and its tokens equal split admission's and
    JAX's chunked batcher's."""
    shared = list(range(3, 3 + 13))
    suffixes = [[20, 21, 22], [30], [40, 41, 42, 43, 44, 45]]
    jeng, teng = engines("paged", kv)

    def run(eng, G, B, chunked):
        pfx = eng.build_prefix(shared)
        b = B(eng, rows=4, chunk_steps=2, group_chunks=2,
              chunked_prefill=4 if chunked else None)
        out = {}
        _submit_all(b, [(i, shared + s, G(max_new_tokens=6), pfx)
                        for i, s in enumerate(suffixes)], out)
        b.run_until_idle()
        return out

    chunked = run(teng, TGen, TBatcher, True)
    assert chunked == run(teng, TGen, TBatcher, False)
    assert chunked == run(jeng, JGen, JBatcher, True)


# -- copy-on-write rests on dropped writes ---------------------------------------


@pytest.mark.parametrize("kv", sorted(KV))
def test_paged_write_drops_sentinel_writes(kv):
    """``paged_write_stacked`` through a table whose entries are partly the
    sentinel: mapped slots take the new values, every other block of
    ``[0, N)`` keeps its bytes (the writes through sentinels land in the
    drop block N), on values and int8 scales alike."""
    rng = np.random.default_rng(0)
    L, N, bs, H, D = 2, 6, 4, 2, 8
    pool = torch.tensor(rng.standard_normal((L, N + 1, bs, H, D)),
                        dtype=torch.float32)
    scale = None
    if kv == "int8":
        pool, scale = tc.quantize_kv(pool)
    before = (pool.clone(), None if scale is None else scale.clone())
    S = tc.table_sentinel(N)
    tables = torch.tensor([[3, S, 1], [S, 5, S]], dtype=torch.int32)
    slots = torch.arange(3 * bs, dtype=torch.int32)[None].expand(2, -1)
    new = torch.tensor(rng.standard_normal((L, 2, 3 * bs, H, D)),
                       dtype=torch.float32)
    tc.paged_write_stacked(pool, new, tables, slots, bs, scale)
    written = {3, 1, 5}
    for blk in range(N):
        if blk not in written:
            assert torch.equal(pool[:, blk], before[0][:, blk])
            if scale is not None:
                assert torch.equal(scale[:, blk], before[1][:, blk])
    want = new if scale is None else tc.quantize_kv(new)[0]
    for row, col, blk in ((0, 0, 3), (0, 2, 1), (1, 1, 5)):
        assert torch.equal(pool[:, blk], want[:, row, col * bs:(col + 1) * bs])


@pytest.mark.parametrize("chunked", [False, True], ids=["split", "chunked"])
def test_shared_blocks_unchanged_after_serving(engines, chunked):
    """The shared prefix blocks hold the prefix's bytes after a whole
    serving pass over them (seed, suffix prefills or ragged feeds, and
    decode steps by rows that share them)."""
    _, eng = engines("paged")
    pfx = eng.build_prefix(PREFIX)
    bat = TBatcher(eng, rows=3, chunk_steps=2, group_chunks=2,
                   chunked_prefill=4 if chunked else None)
    out = {}
    g, s = _gens(TGen, 10)
    _submit_all(bat, [(i, PREFIX + [50 + i] * (i + 1), (g, s)[i % 2], pfx)
                      for i in range(5)], out)
    bat.step()
    (_, blocks), = bat._paged_prefixes.values()
    assert len(blocks) == 2 and len(out) == 0
    nf = len(blocks) * 8
    want = (pfx.k[:, :nf].reshape(2, 2, 8, 2, 16),
            pfx.v[:, :nf].reshape(2, 2, 8, 2, 16))
    bat.run_until_idle()
    assert len(out) == 5
    for pool, w in zip((bat.cache.k, bat.cache.v), want):
        assert torch.equal(pool[:, blocks], w)


# -- the worker ------------------------------------------------------------------


def _serve(worker, broker, req, timeout=60.0):
    broker.push_request(req)
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        worker.run_once()
        r = broker.wait_response(req.id, timeout=0.001)
        if r is not None:
            return r
    raise TimeoutError(req.id)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_serving_prefix_token_ids_end_to_end(engines, mode):
    """Requests carrying ``prefix_token_ids`` through ContinuousWorker:
    the tokens of the same request without the hint, and JAX's worker's;
    the segment is built once and reused; a malformed hint is a
    per-request error; the prefix hashes equal the JAX worker's."""
    layout, bkw = MODES[mode]
    jeng, teng = engines(layout)
    answers, hashes = [], []
    for eng, W, Br, R in ((jeng, JWorker, JBroker, JRequest),
                          (teng, ContinuousWorker, InProcBroker,
                           GenerateRequest)):
        broker = Br()
        kw = dict(poll_timeout_s=0.01) if W is JWorker else {}
        worker = W(eng, broker, rows=2, chunk_steps=2, **bkw, **kw)
        got = [_serve(worker, broker, R(
            id=f"{mode}-{i}", token_ids=PREFIX + suf, max_new_tokens=8,
            prefix_token_ids=list(PREFIX) if hint else None,
            **({} if i < 2 else dict(is_greedy=False, seed=5,
                                     temperature=0.9))))
            for i, (suf, hint) in enumerate((([50, 51], False),
                                             ([50, 51], True),
                                             ([60, 61], True)))]
        assert all(r.error is None for r in got)
        assert got[1].token_ids == got[0].token_ids
        assert len(worker._prefixes) == 1
        bad = _serve(worker, broker, R(
            id=f"{mode}-bad", token_ids=[1, 2, 3], max_new_tokens=4,
            prefix_token_ids=[9, 9]))
        assert bad.error is not None and "prefix" in bad.error
        answers.append([r.token_ids for r in got])
        hashes.append(worker.load_snapshot()["prefix_hashes"])
        if layout == "paged":
            assert worker.batcher.allocator.blocks_in_use == len(PREFIX) // 8
    assert answers[1] == answers[0]
    assert hashes[1] == hashes[0] and len(hashes[1]) == 1


def test_worker_prefix_lru(engines):
    """The worker keeps its ``max_prefixes`` most recently used prefixes;
    a reused one moves to the end, the oldest goes first."""
    _, eng = engines("dense")
    broker = InProcBroker()
    worker = ContinuousWorker(eng, broker, rows=2, chunk_steps=2)
    worker.max_prefixes = 2
    heads = [[1 + i, 2, 3] for i in range(3)]
    for i in (0, 1, 0, 2):
        r = _serve(worker, broker, GenerateRequest(
            token_ids=heads[i] + [9], max_new_tokens=2,
            prefix_token_ids=heads[i]))
        assert r.error is None
    assert list(worker._prefixes) == [tuple(heads[0]), tuple(heads[2])]
