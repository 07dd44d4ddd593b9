"""The torch port's ``ContinuousBatcher`` and ``ContinuousWorker`` on the
CPU: the same submissions give the same tokens per request as the JAX
package's batcher, in the dense, paged (split admission) and paged
``chunked_prefill`` modes, and the reference's own scheduler invariants
(``tests/test_continuous.py``, ``test_paged.py``, ``test_ragged.py``) hold
on the port. Tiny fp32 llama, parameters from the JAX ``init_params``
through ``convert.params_from_jax``."""

import threading

import jax
import pytest

from llmss_tpu.engine import DecodeEngine as JEngine
from llmss_tpu.engine import GenerationParams as JGen
from llmss_tpu.engine.scheduler import ContinuousBatcher as JBatcher
from llmss_tpu.models import decoder as jdec
from llmss_tpu.models.common import DecoderConfig as JCfg
from llmss_tpu.parallel import MeshPlan, make_mesh
from llmss_tpu_torch.convert import params_from_jax
from llmss_tpu_torch.engine.engine import DecodeEngine as TEngine
from llmss_tpu_torch.engine.engine import GenerationParams as TGen
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
MODES = {
    "dense": (dict(), dict()),
    "paged": (dict(kv_layout="paged", block_size=8), dict()),
    "chunked": (dict(kv_layout="paged", block_size=8),
                dict(chunked_prefill=4)),
}
PROMPTS = [list(range(2, 22)), [5, 9, 23], [7, 7, 7, 7, 7, 7, 7],
           [40, 41, 42, 43, 44], [3, 14, 15, 9, 26, 5, 35, 8, 9]]


def _gens(G):
    return [G(max_new_tokens=8), G(max_new_tokens=6),
            G(max_new_tokens=5, is_greedy=False, seed=3, temperature=0.9,
              top_k=20),
            G(max_new_tokens=7), G(max_new_tokens=6, is_greedy=False, seed=11,
                                   temperature=1.2, top_p=0.8)]


@pytest.fixture(scope="module")
def model():
    mesh = make_mesh(MeshPlan(dp=1, tp=1), devices=jax.devices()[:1])
    jp = jdec.init_params(JCfg(**CFG), mesh, jax.random.key(0))
    return mesh, jp, params_from_jax(jax.device_get(jp))


def _engine(model, mode, **kw):
    return TEngine(TCfg(**CFG), model[2], device="cpu", max_seq_len=64,
                   **{**MODES[mode][0], **kw})


def _run(bat, prompts, gens, keys=None):
    out = {}
    for i, (p, g) in enumerate(zip(prompts, gens)):
        key = i if keys is None else keys[i]
        bat.submit(p, g, lambda t, *a, key=key, **k: out.__setitem__(key, t),
                   req_id=str(key))
    bat.run_until_idle()
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
def test_batcher_matches_jax(model, mode):
    """Five requests through three rows (queueing, mid-flight admission,
    greedy and seeded-sampled rows): token-identical to the JAX batcher."""
    mesh, jp, _ = model
    ekw, bkw = MODES[mode]
    kw = dict(rows=3, chunk_steps=2, group_chunks=2, **bkw)
    jeng = JEngine(JCfg(**CFG), jp, mesh, max_seq_len=64, **ekw)
    want = _run(JBatcher(jeng, **kw), PROMPTS, _gens(JGen))
    bat = TBatcher(_engine(model, mode), **kw)
    assert _run(bat, PROMPTS, _gens(TGen)) == want
    if mode != "dense":
        assert bat.allocator.blocks_in_use == 0


@pytest.mark.parametrize("mode", ["paged", "chunked"])
def test_interleaved_and_grouped_match_isolated(model, mode):
    """Row isolation and the group pipeline: every request gets the tokens
    ``generate`` gives it alone, for ungrouped and grouped dispatch."""
    eng = _engine(model, mode)
    want = [eng.generate([p], g)[0] for p, g in zip(PROMPTS, _gens(TGen))]
    for kw in (dict(chunk_steps=1), dict(chunk_steps=3, group_chunks=2)):
        got = _run(TBatcher(eng, rows=2, **MODES[mode][1], **kw), PROMPTS,
                   _gens(TGen))
        assert [got[i] for i in range(5)] == want, kw


def test_eos_and_poison_mid_group(model):
    """A row that samples its EOS mid-group stops there; a row whose logits
    go NaN errors alone; their batch-mates keep their solo tokens."""
    eng = _engine(model, "paged")
    full = eng.generate([PROMPTS[0]], TGen(max_new_tokens=8))[0]
    eos = full[3]
    out, errs = {}, {}

    def cb(key):
        def done(t, cancelled=False, error=None):
            out[key] = t
            errs[key] = error
        return done

    params = {**eng.params, "wte": eng.params["wte"].clone()}
    params["wte"][99] = float("nan")
    bad = _engine(model, "paged")
    bad.params, bad._layers = params, eng._layers
    bat = TBatcher(bad, rows=3, chunk_steps=4, group_chunks=2)
    bat.submit(PROMPTS[0], TGen(max_new_tokens=8, eos_token_id=eos), cb("eos"))
    bat.submit([4, 99], TGen(max_new_tokens=8), cb("nan"))
    bat.submit(PROMPTS[1], TGen(max_new_tokens=8), cb("ok"))
    bat.run_until_idle()
    assert out["eos"] == full[: full.index(eos)]
    assert "non-finite" in errs["nan"]
    assert out["ok"] == eng.generate([PROMPTS[1]], TGen(max_new_tokens=8))[0]
    assert bat.allocator.blocks_in_use == 0


def test_cancel_returns_blocks(model):
    eng = _engine(model, "paged")
    res = {}
    bat = TBatcher(eng, rows=2)
    bat.submit([1, 2, 3], TGen(max_new_tokens=40), lambda t, c=False:
               res.__setitem__("a", (t, c)), req_id="a")
    bat.submit([4, 5], TGen(max_new_tokens=6), lambda t, c=False:
               res.__setitem__("b", (t, c)), req_id="b")
    for _ in range(3):
        bat.step()
    held = bat.allocator.blocks_in_use
    bat.cancel("a")
    bat.step()
    toks, cancelled = res["a"]
    assert cancelled and 0 < len(toks) < 40
    assert bat.allocator.blocks_in_use < held
    bat.run_until_idle()
    assert res["b"] == (eng.generate([[4, 5]], TGen(max_new_tokens=6))[0], False)
    assert bat.allocator.blocks_in_use == 0
    assert eng.metrics.to_dict()["kv_blocks_in_use"] == 0


def test_pool_gated_admission_and_oversized_request(model):
    """Admission waits on free blocks, not rows; a request bigger than the
    whole pool is answered with an error instead of waiting forever."""
    eng = _engine(model, "paged", kv_blocks=4)
    want = [eng.generate([p], g)[0] for p, g in zip(PROMPTS[1:4], _gens(TGen)[1:4])]
    bat = TBatcher(eng, rows=3, chunk_steps=2)
    got = _run(bat, PROMPTS[1:4], _gens(TGen)[1:4])  # 2 blocks each
    assert [got[i] for i in range(3)] == want
    errs = {}
    bat.submit(list(range(1, 40)), TGen(max_new_tokens=8),
               lambda t, error=None: errs.__setitem__("big", error))
    bat.run_until_idle()
    assert "KV blocks" in errs["big"]
    assert bat.allocator.blocks_in_use == 0


def test_chunked_prefill_requires_paged(model):
    with pytest.raises(ValueError, match="paged"):
        TBatcher(_engine(model, "dense"), rows=2, chunked_prefill=4)
    with pytest.raises(ValueError):
        TBatcher(_engine(model, "paged"), rows=2, chunked_prefill=0)


def test_mixed_batch_metrics(model):
    bat = TBatcher(_engine(model, "chunked"), rows=4, chunk_steps=2,
                   group_chunks=2, chunked_prefill=4)
    _run(bat, PROMPTS[:1], _gens(TGen)[:1])
    mb = bat.engine.metrics.to_dict()["mixed_batch"]
    assert mb["prefill_tokens_chunked"] == len(PROMPTS[0])
    assert 0 < mb["chunk_budget_utilization"] <= 1
    ho = bat.engine.metrics.to_dict()["host_overhead"]
    assert ho["groups_dispatched"] > 0 and ho["host_syncs"] > 0


@pytest.mark.parametrize("chunked", [False, True])
def test_worker_roundtrip(model, chunked):
    """Greedy, streamed, cancelled and prefix-hinted requests through
    ``ContinuousWorker`` over ``InProcBroker``. The prefix hint is served
    (the reference's protocol: a hint never changes the tokens): the
    answer is ``generate``'s for the full prompt, and once idle the pool
    holds only the registered prefix's full blocks."""
    eng = _engine(model, "paged")
    broker = InProcBroker()
    worker = ContinuousWorker(eng, broker, rows=2, chunk_steps=2,
                              chunked_prefill=4 if chunked else None)
    greedy = GenerateRequest(token_ids=PROMPTS[4], max_new_tokens=6)
    stream = GenerateRequest(token_ids=PROMPTS[1], max_new_tokens=7, stream=True)
    cancel = GenerateRequest(token_ids=[1, 2, 3], max_new_tokens=40)
    prefix = GenerateRequest(token_ids=PROMPTS[0], max_new_tokens=5,
                             prefix_token_ids=PROMPTS[0][:10])
    for r in (greedy, stream, cancel, prefix):
        broker.push_request(r)
    stop = threading.Event()
    th = threading.Thread(target=worker.run_forever, args=(stop,))
    th.start()
    try:
        a = broker.wait_response(greedy.id, timeout=30)
        broker.cancel_request(cancel.id)
        c = broker.wait_response(cancel.id, timeout=30)
        s = broker.wait_response(stream.id, timeout=30)
        p = broker.wait_response(prefix.id, timeout=30)
    finally:
        stop.set()
        th.join(timeout=30)
    assert a.error is None and a.token_ids == eng.generate(
        [PROMPTS[4]], TGen(max_new_tokens=6))[0]
    assert s.token_ids == eng.generate([PROMPTS[1]], TGen(max_new_tokens=7))[0]
    streamed = []
    while (inc := broker.pop_stream(stream.id)) is not None:
        streamed += inc
    assert streamed == s.token_ids
    assert c.error == "cancelled" and len(c.token_ids) < 40
    assert p.error is None and p.token_ids == eng.generate(
        [PROMPTS[0]], TGen(max_new_tokens=5))[0]
    registered = sum(len(blocks) for _, blocks
                     in worker.batcher._paged_prefixes.values())
    assert registered == 10 // 8
    assert worker.batcher.allocator.blocks_in_use == registered


def test_worker_drain_releases_pending(model):
    broker = InProcBroker()
    worker = ContinuousWorker(_engine(model, "paged"), broker, rows=1)
    reqs = [GenerateRequest(token_ids=[1, 2], max_new_tokens=30)
            for _ in range(3)]
    for r in reqs:
        broker.push_request(r)
    worker.run_once()  # admits one request, queues two
    worker.begin_drain()
    assert worker.release_pending() == 2
    # Back at the head of the queue, the last released first (the
    # reference's order, in both of its brokers).
    assert broker.pop_request().id == reqs[2].id
    assert worker.abort_inflight("test") == 1
    assert "worker restarted" in broker.wait_response(reqs[0].id, 5).error
    assert worker.drained
